"""Output writers (the port's copy of regenie_tpu/io/output.py, trimmed
to the single-trait tests of the four trait types and the gene-based
p-value rows): Step-2 summary statistics in the split single-trait (with
--af-cc's case/control columns), merged (--no-split) and HTPv4 formats,
and Step 1's LOCO/PRS prediction rows.

Mirrors Step2_Models.cpp print_header_output* (:2306) and
print_sum_stats* (:2410-2646) with C++ default 6-significant-digit
formatting. Whole blocks render through the native formatter
(native/decoder.cpp); the per-row functions are the fallback when the
library is unavailable and render byte-identical rows. Prediction rows
render through the port's own io/csrc/loco_rows.cpp, with no fallback
(format_value_rows); format_value_rows_plain is its plain twin for the
tests.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np

from ..config import BT, CT, QT, T2E, Params
from ..prep import fmt
from ..utils.stats import convert_logp_raw
from .bed import SnpInfo
from .native import LOCO_SYMBOL, get_lib, loco_lib


def header_single(params: Params) -> str:
    cols = ["CHROM", "GENPOS", "ID", "ALLELE0", "ALLELE1", "A1FREQ"]
    if params.af_cc:
        cols += ["A1FREQ_CASES", "A1FREQ_CONTROLS"]
    if params.dosage_mode:
        cols += ["INFO"]
    cols += ["N"]
    if params.af_cc:
        cols += ["N_CASES", "N_CONTROLS"]
    cols += ["TEST", "BETA", "SE", "CHISQ", "LOG10P", "EXTRA"]
    return " ".join(cols) + "\n"


def header_all(params: Params) -> str:
    """Header of the merged --no-split file (print_header_output_all,
    Step2_Models.cpp:2306)."""
    cols = ["CHROM", "GENPOS", "ID", "ALLELE0", "ALLELE1", "A1FREQ"]
    if params.af_cc:
        cols += ["A1FREQ_CASES", "A1FREQ_CONTROLS"]
    if params.dosage_mode:
        cols += ["INFO"]
    cols += ["N"]
    if params.af_cc:
        cols += ["N_CASES", "N_CONTROLS"]
    cols += ["N_RR", "N_RA", "N_AA", "TEST"]
    for i in range(params.n_pheno):
        cols += [f"BETA.Y{i+1}", f"SE.Y{i+1}", f"CHISQ.Y{i+1}", f"LOG10P.Y{i+1}"]
    cols += ["EXTRA"]
    return " ".join(cols) + "\n"


def sumstat_line_all(params: Params, snp: SnpInfo, test: str, af1: float,
                     info1: Optional[float], ns1: int, n_rr: int, n_aa: int,
                     per_pheno: list) -> str:
    """One merged-format row, all traits (print_sum_stats_all,
    Step2_Models.cpp:2457-2500); per_pheno: [(beta, se, chisq, logp,
    test_pass)] per trait."""
    parts = [str(snp.chrom), str(snp.physpos), snp.ID, snp.allele1, snp.allele2]
    parts.append(fmt(af1) if af1 >= 0 else "NA")
    if params.dosage_mode:
        parts.append(fmt(info1) if info1 is not None and info1 >= 0 else "NA")
    parts.append(str(ns1))
    if n_rr >= 0:
        parts += [str(n_rr), str(ns1 - n_rr - n_aa), str(n_aa)]
    else:
        parts += ["NA", "NA", "NA"]
    parts.append(test)
    for beta, se, chisq, logp, test_pass in per_pheno:
        print_se = (se >= 0) and not np.isnan(se)
        print_pv = (chisq >= 0) and test_pass and not np.isnan(logp)
        parts += ([fmt(beta), fmt(se)] if print_se else ["NA", "NA"])
        parts += ([fmt(chisq), fmt(logp)] if print_pv else ["NA", "NA"])
    parts.append("NA")
    return " ".join(parts) + "\n"


def sumstat_line_single(
    params: Params,
    snp: SnpInfo,
    test: str,
    af: float,
    info: Optional[float],
    n: int,
    beta: float,
    se: float,
    chisq: float,
    logp: float,
    test_pass: bool = True,
    af_case: float = -1,
    af_control: float = -1,
    ns_case: int = -1,
    ns_control: int = -1,
) -> str:
    """One association row, single-pheno format (print_sum_stats_single,
    Step2_Models.cpp:2505-2544)."""
    parts = [str(snp.chrom), str(snp.physpos), snp.ID, snp.allele1, snp.allele2]
    parts.append(fmt(af) if af >= 0 else "NA")
    if params.af_cc:
        if af >= 0:
            parts += [fmt(af_case), fmt(af_control)]
        else:
            parts += ["NA", "NA"]
    if params.dosage_mode:
        parts.append(fmt(info) if info is not None and info >= 0 else "NA")
    parts.append(str(n))
    if params.af_cc:
        parts += [str(ns_case), str(ns_control)]
    parts.append(test)
    print_se = (se >= 0) and not np.isnan(se)
    print_pv = (chisq >= 0) and test_pass and not np.isnan(logp)
    if print_se:
        parts += [fmt(beta), fmt(se)]
    else:
        parts += ["NA", "NA"]
    if print_pv:
        parts += [fmt(chisq), fmt(logp)]
    else:
        parts += ["NA", "NA"]
    parts.append("NA" if test_pass else "TEST_FAIL")
    return " ".join(parts) + "\n"


def block_prefixes(bsnps) -> tuple:
    """Concatenated per-variant row prefixes "CHROM GENPOS ID A0 A1"
    for the native batch formatter (built once per block, reused by
    every trait column)."""
    buf = bytearray()
    off = np.empty(len(bsnps) + 1, np.int64)
    off[0] = 0
    for i, s in enumerate(bsnps):
        buf += f"{s.chrom} {s.physpos} {s.ID} {s.allele1} {s.allele2}".encode()
        off[i + 1] = len(buf)
    return np.frombuffer(bytes(buf), np.uint8), off


def _f64(x):
    return np.ascontiguousarray(x, np.float64)


def native_formatter(name: str):
    """The native lib if it exports `name`, else None — callers probe
    this once before building per-block operands."""
    lib = get_lib()
    if lib is None or not hasattr(lib, name):
        return None
    return lib


def format_block_single(params, prefix_buf, prefix_off, test, skip, af,
                        info, n, beta, se, chisq, logp, test_fail,
                        af_case=None, af_control=None, ns_case=None,
                        ns_control=None) -> Optional[str]:
    """Native batch renderer for the split single-pheno format: one call
    formats a whole [B] block x trait column (format_sumstat_single in
    native/decoder.cpp), byte-identical to sumstat_line_single. Returns
    None when the native lib is unavailable."""
    lib = native_formatter("format_sumstat_single")
    if lib is None or len(test) > 40:
        return None
    B = len(prefix_off) - 1
    af = _f64(af)
    beta, se = _f64(beta), _f64(se)
    chisq, logp = _f64(chisq), _f64(logp)
    n = np.ascontiguousarray(n, np.int32)
    skip = np.ascontiguousarray(skip, np.uint8)
    test_fail = np.ascontiguousarray(test_fail, np.uint8)
    has_info = bool(params.dosage_mode)
    if has_info:
        # reference prints INFO=1 when the format carries no INFO
        info = _f64(info if info is not None else np.ones(B))
    af_cc = bool(params.af_cc)
    if af_cc:
        neg1 = np.full(B, -1.0)
        af_case = _f64(af_case if af_case is not None else neg1)
        af_control = _f64(af_control if af_control is not None else neg1)
        ns_case = np.ascontiguousarray(
            ns_case if ns_case is not None else neg1, np.int32)
        ns_control = np.ascontiguousarray(
            ns_control if ns_control is not None else neg1, np.int32)

    def ptr(a):
        return a.ctypes.data if af_cc else None
    budget = int(lib.sumstat_field_budget())
    out = np.empty(int(prefix_off[-1]) + B * budget, np.uint8)
    row_len = np.empty(B, np.int64)
    pb = np.ascontiguousarray(prefix_buf, np.uint8)
    po = np.ascontiguousarray(prefix_off, np.int64)
    total = lib.format_sumstat_single(
        pb.ctypes.data, po.ctypes.data, B, skip.ctypes.data, test.encode(),
        None, None, int(af_cc), int(has_info), af.ctypes.data, ptr(af_case),
        ptr(af_control), info.ctypes.data if has_info else None,
        n.ctypes.data, ptr(ns_case), ptr(ns_control),
        beta.ctypes.data, se.ctypes.data, chisq.ctypes.data, logp.ctypes.data,
        test_fail.ctypes.data, out.ctypes.data, row_len.ctypes.data,
    )
    return out[:total].tobytes().decode("utf-8")


def htp_prefixes(bsnps) -> tuple:
    """Concatenated per-variant HTP row prefixes "Name\\tChr\\tPos\\tRef\\tAlt"."""
    buf = bytearray()
    off = np.empty(len(bsnps) + 1, np.int64)
    off[0] = 0
    for i, s in enumerate(bsnps):
        buf += f"{s.ID}\t{s.chrom}\t{s.physpos}\t{s.allele1}\t{s.allele2}".encode()
        off[i + 1] = len(buf)
    return np.frombuffer(bytes(buf), np.uint8), off


def format_block_htp(params, prefix_buf, prefix_off, pheno_name, model, skip,
                     beta, se, chisq, logp, af, info, mac, genocounts, neff,
                     test_fail) -> Optional[str]:
    """Native batch renderer for the HTPv4 format (format_sumstat_htp in
    native/decoder.cpp), byte-identical to sumstat_line_htp. Returns
    None when the native lib is unavailable."""
    lib = native_formatter("format_sumstat_htp")
    if lib is None:
        return None
    B = len(prefix_off) - 1
    mid = f"\t{pheno_name}\t{params.cohort_name}\t{model}"
    beta, se = _f64(beta), _f64(se)
    chisq, logp, af = _f64(chisq), _f64(logp), _f64(af)
    mac = _f64(mac if mac is not None else np.full(B, -1.0))
    skip = np.ascontiguousarray(skip, np.uint8)
    test_fail = np.ascontiguousarray(test_fail, np.uint8)
    gc = (np.ascontiguousarray(genocounts, np.int64)
          if genocounts is not None else None)
    has_info = bool(params.dosage_mode) and info is not None
    info = _f64(info) if has_info else None
    budget = int(lib.htp_field_budget()) + len(mid.encode())
    out = np.empty(int(prefix_off[-1]) + B * budget, np.uint8)
    row_len = np.empty(B, np.int64)
    pb = np.ascontiguousarray(prefix_buf, np.uint8)
    po = np.ascontiguousarray(prefix_off, np.int64)
    total = lib.format_sumstat_htp(
        pb.ctypes.data, po.ctypes.data, B, skip.ctypes.data, mid.encode(),
        {BT: 1, CT: 2, T2E: 3}.get(params.trait_mode, 0), int(bool(params.firth)),
        int(bool(params.uncapped_pvals)),
        int(has_info), float(params.zcrit),
        beta.ctypes.data, se.ctypes.data, chisq.ctypes.data, logp.ctypes.data,
        af.ctypes.data, info.ctypes.data if has_info else None, mac.ctypes.data,
        gc.ctypes.data if gc is not None else None,
        int(neff) if neff is not None else -1,
        test_fail.ctypes.data, out.ctypes.data, row_len.ctypes.data,
    )
    return out[:total].tobytes().decode("utf-8")


def format_value_rows(vals, mask, labels) -> bytes:
    """Labeled %g value rows with per-sample NA masking ("label v_1 ..
    v_N \\n": the .loco/.prs prediction format, write_predictions
    Data.cpp:1795) through io/csrc/loco_rows.cpp, the rows split over one
    thread per CPU (ctypes releases the GIL during each call). vals:
    [R, N] float64; mask: [N] bool; labels: [R] ints. Raises RuntimeError
    when the renderer cannot be built or loaded: at biobank scale a run
    renders 460M values (50 traits x 23 rows x 400,000 samples), too many
    for Python."""
    lib = loco_lib()
    fn = getattr(lib, LOCO_SYMBOL)
    vals = np.ascontiguousarray(vals, np.float64)
    R, N = vals.shape
    mask = np.ascontiguousarray(mask, np.uint8)
    labels = np.ascontiguousarray(labels, np.int32)
    if mask.shape != (N,) or labels.shape != (R,):
        raise ValueError(f"mask {mask.shape} / labels {labels.shape} do not "
                         f"fit values {vals.shape}")
    budget = int(lib.loco_rows_budget(1, N))
    out = np.empty(R * budget, np.uint8)
    row_len = np.empty(R, np.int64)

    def run(lo, hi):
        n = fn(vals[lo:].ctypes.data, hi - lo, N, mask.ctypes.data,
               labels[lo:].ctypes.data, out[lo * budget:].ctypes.data,
               row_len[lo:].ctypes.data)
        return out[lo * budget : lo * budget + n].tobytes()

    bounds = np.linspace(0, R, min(os.cpu_count() or 1, R) + 1).astype(int)
    with ThreadPoolExecutor(max(len(bounds) - 1, 1)) as pool:
        return b"".join(pool.map(run, bounds[:-1], bounds[1:]))


def format_value_rows_plain(vals, mask, labels) -> bytes:
    """format_value_rows rendered in Python, byte for byte (the oracle of
    the native renderer in the tests)."""
    rows = []
    for label, v in zip(labels, np.asarray(vals, np.float64)):
        row = [str(int(label))] + [fmt(x) if m else "NA" for x, m in zip(v, mask)]
        rows.append(" ".join(row) + " \n")
    return "".join(rows).encode("ascii")


def header_htp() -> str:
    """HTPv4 header (print_header_output_htp, Step2_Models.cpp:2400)."""
    cols = [
        "Name", "Chr", "Pos", "Ref", "Alt", "Trait", "Cohort", "Model",
        "Effect", "LCI_Effect", "UCI_Effect", "Pval", "AAF",
        "Num_Cases", "Cases_Ref", "Cases_Het", "Cases_Alt",
        "Num_Controls", "Controls_Ref", "Controls_Het", "Controls_Alt", "Info",
    ]
    return "\t".join(cols) + "\n"


def sumstat_line_htp(
    params: Params,
    snp: SnpInfo,
    pheno_name: str,
    model: str,
    beta: float,
    se: float,
    chisq: float,
    logp: float,
    af: float,
    info: Optional[float],
    mac: float,
    genocounts,  # [6] ints (cases RR/RA/AA, controls RR/RA/AA) or None
    test_pass: bool = True,
    neff=None,
) -> str:
    """One HTPv4 row (print_sum_stats_htp, Step2_Models.cpp:2548-2646).
    A binary trait's Effect is an odds ratio: exp(beta) with Firth, else
    the allelic OR of the genotype counts; a count trait's is exp(beta),
    its counts those of all samples (no controls), and like a binary
    trait it prints REGENIE_BETA and REGENIE_SE. A time-to-event trait's
    Effect is the hazard ratio exp(beta), its cases and controls those
    with and without an event."""
    zcrit = params.zcrit
    print_beta = test_pass and se >= 0 and not np.isnan(se)
    print_pv = test_pass and chisq >= 0 and not np.isnan(logp)
    outp = "NA"
    if print_pv:
        cap = 308.0  # -log10(dbl_min)-ish cap
        if not params.uncapped_pvals and logp > cap:
            outp = convert_logp_raw(cap)
        elif logp > 0:
            outp = convert_logp_raw(logp)
        else:
            outp = "0.9999999"

    parts = [snp.ID, str(snp.chrom), str(snp.physpos), snp.allele1, snp.allele2,
             pheno_name, params.cohort_name, model]
    is_bt = params.trait_mode == BT
    is_qt = params.trait_mode == QT
    if print_pv and not print_beta:
        parts += ["NA", "NA", "NA", outp]
    elif not print_pv and not print_beta:
        parts += ["NA", "NA", "NA", "NA"]
    elif not is_bt or (params.firth and test_pass):
        if is_qt:
            parts += [fmt(beta), fmt(beta - zcrit * se), fmt(beta + zcrit * se)]
        else:
            parts += [fmt(np.exp(beta)), fmt(np.exp(beta - zcrit * se)),
                      fmt(np.exp(beta + zcrit * se))]
        parts.append(outp if print_pv else "NA")
    else:  # BT SPA/logistic: the allelic OR of the genotype counts
        if print_pv and genocounts is not None:
            g = genocounts
            eff = (2 * g[3] + g[4] + 0.5) * (2 * g[2] + g[1] + 0.5) / (
                (2 * g[5] + g[4] + 0.5) * (2 * g[0] + g[1] + 0.5)
            )
            outse = abs(np.log(eff)) / np.sqrt(max(chisq, 1e-300))
            parts += [fmt(eff), fmt(eff * np.exp(-zcrit * outse)),
                      fmt(eff * np.exp(zcrit * outse)), outp]
        else:
            parts += ["NA", "NA", "NA", "NA"]

    parts.append(fmt(af) if af >= 0 else "NA")

    if mac > 0 and genocounts is not None:
        g = genocounts
        parts += [str(g[0] + g[1] + g[2]), str(g[0]), str(g[1]), str(g[2])]
        if params.trait_mode in (BT, T2E):
            parts += [str(g[3] + g[4] + g[5]), str(g[3]), str(g[4]), str(g[5])]
        else:
            parts += ["NA", "NA", "NA", "NA"]
    else:
        parts += [str(int(neff)) if neff is not None else "NA", "NA", "NA", "NA",
                  "NA", "NA", "NA", "NA"]

    infoCol = []
    if print_beta:
        if not is_qt and test_pass:
            infoCol.append(f"REGENIE_BETA={fmt(beta)}")
            infoCol.append(f"REGENIE_SE={fmt(se)}")
        elif not is_qt:
            infoCol.append("REGENIE_BETA=NA")
            infoCol.append("REGENIE_SE=NA")
        else:
            infoCol.append(f"REGENIE_SE={fmt(se)}")
    if params.dosage_mode and info is not None and info >= 0:
        infoCol.append(f"INFO={fmt(info)}")
    if mac >= 0:
        infoCol.append(f"MAC={fmt(mac)}")
    infoCol.append(f"LOG10P={fmt(logp)}" if print_pv else "LOG10P=NA")
    parts.append(";".join(infoCol))
    return "\t".join(parts) + "\n"


def htp_pvalue_line(
    params: Params,
    snp,
    pheno_name: str,
    model: str,
    logp: float,
    df: int,
    n_cases: int,
    n_controls=None,
    strongest: str = "",
) -> str:
    """HTP row for p-value-only tests: the gene-based VC, joint and
    GENE_P rows (print_sum_stats_htp_gene, Joint_Tests.cpp:1025-1067)."""
    test_pass = logp >= 0 and not np.isnan(logp)
    outp = convert_logp_raw(min(logp, 308.0)) if test_pass else "NA"
    parts = [snp.ID, str(snp.chrom), str(snp.physpos),
             getattr(snp, "allele1", "NA"), getattr(snp, "allele2", "NA"),
             pheno_name, params.cohort_name, model,
             "NA", "NA", "NA", outp,
             "NA", str(int(n_cases)), "NA", "NA", "NA",
             (str(int(n_controls)) if params.trait_mode == BT and n_controls
              is not None else "NA"),
             "NA", "NA", "NA"]
    info = [f"DF={df}" if test_pass else "DF=0"]
    if strongest:
        info.append(f"STRONGEST_MASK={strongest}")
    info.append(f"LOG10P={fmt(logp)}" if test_pass else "LOG10P=NA")
    info.append("NO_BETA")
    parts.append(";".join(info))
    return "\t".join(parts) + "\n"
