"""Step 2 on quantitative, binary, count and time-to-event traits from
PLINK BED, PGEN or BGEN files (the port of the single-device paths of
regenie_tpu/run_step2.py), on two routes.

Replaces the reference's Data::test_snps_fast (Data.cpp:2230),
compute_res (:2386) and the .regenie writers. Per chromosome the LOCO
residuals (with --force-ltco, less the extra chromosome's share) enter
the scorer. The fused route (the default) scores each block of packed
genotype bytes (three products) or of BGEN probability byte planes (six
products) with a small epilogue on the device (ops/fused_score.py), with
AF/MAC/INFO/genotype counts read from the same product columns; on chrX
outside the PARs the male tail of the operand gives the hemizygous MAC
and class counts. The dense route takes what the fused one cannot, as
the JAX package's dense path does (--nocov-approx, BGEN with --htp,
--no-split or DOM/REC, PGEN dosage tracks, chrX non-PAR blocks with
--skip-dosage-comp or DOM/REC, BGEN records the plane extractor rejects,
or every block with REGENIE_TPU_FUSED=0): the block's hardcalls or
float64 dosages on the device, their statistics (ops/geno_ops.py) and
float64 products (models/step2.py), all plain torch ops.

Binary traits (--bt) refit the null logistic model (and with --firth
--approx the null Firth model) per chromosome on the host
(models/step2_bt.py). The fused route's operand is [cat | gsm^2 | maskf |
case | ind] (the per-trait weighted covariate basis and residual, the
weights squared, the masks, the case indicators), so the same products
give every trait's score num/denum, the per-variant statistics, the
--af-cc case/control counts and HTP's case/control genotype counts; the
rows past the correction threshold are decoded again on the card from
the block's resident bytes and corrected by SPA, approximate Firth or
exact Firth (models/corrections_device.py on the card, the host twins on
the CPU). Count traits (--ct) refit the null Poisson model per chromosome
(models/step2_ct.py) and take the same operand and score test with the
weights W = mu and no correction; their HTP genotype counts are of all
samples. Time-to-event traits (--t2e) refit the Cox null (and with
--firth --approx the null Cox Firth) per chromosome on the host
(models/step2_t2e.py); on the fused route, BED and PGEN hardcalls only
and not with --coxscore-exact, the operand is per trait [WX1 | R | v]
with [case | maskf | ind] after it (case = the trait's events), so the
same products give each trait's score T and denum and the event-split
HTP counts, and the Firth rows are decoded again from the block and
corrected on the host.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import threading
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .config import BT, CT, QT, T2E, Params
from .io.bgen import extract_planes_block, planes_readable
from .io.files import iter_lines, open_read, open_write, string_split
from .io.geno import make_blocks
from .io.native import PlanesRejected, pgen_lib, planes_lib, require_zstd
from .io.output import (block_prefixes, format_block_htp,
                        format_block_single, header_all, header_htp,
                        header_single, htp_prefixes, native_formatter,
                        sumstat_line_all, sumstat_line_htp,
                        sumstat_line_single)
from .models import step2 as m2
from .models import step2_bt, step2_ct, step2_t2e
from .ops import fused_score as fsc
from .ops.geno_ops import (MISSING, decode_bed_packed, finalize_block_step2,
                           pack_hardcalls, snp_stats_block,
                           snp_stats_block_packed)
from .parallel import mesh as pm
from .parallel.dist import allgather_py, is_output_host, process_count, process_index
from .prep import fmt, prepare, write_debug_inputs
from .cli import unported
from .utils.device import resolve_device
from .utils.stats import chisq_neglog10, ttest_neglog10, usage_info_line

FUSED_ENV = "REGENIE_TPU_FUSED"  # "0" sends every block down the dense route


def read_pred_list(path: str) -> Dict[str, str]:
    """_pred.list: 'phenoname locopath' per line (check_blup, Pheno.cpp:1204)."""
    out = {}
    for toks in iter_lines(path):
        if len(toks) != 2:
            raise ValueError("wrongly formatted blup list file")
        if toks[0] in out:
            raise ValueError(f"phenotype '{toks[0]}' appears twice in blup list")
        out[toks[0]] = toks[1]
    return out


def _loco_columns(line, id_to_ind):
    """A .loco header line -> (its token count, the columns naming samples
    of id_to_ind, their sample indices), in header order. Raises unless
    the header starts with FID_IID."""
    header = string_split(line)
    if header[0] != "FID_IID":
        raise ValueError("header of blup file must start with FID_IID")
    idx = np.fromiter((id_to_ind.get(k, -1) for k in header[1:]), np.int64,
                      len(header) - 1)
    cols = np.flatnonzero(idx >= 0)
    return len(header), cols + 1, idx[cols]


def read_loco_chr(
    path: str, chrom: int, id_to_ind: Dict[str, int], n_samples: int,
    mask: np.ndarray, use_prs: bool = False,
) -> np.ndarray:
    """Read one chromosome row from a .loco file (blup_read_chr,
    Step2_Models.cpp:51-150). Returns [N] blup vector (0 where masked).

    With use_prs (--use-prs), the file is a whole-genome .prs written by
    --print-prs: a single row labeled 0 used for every chromosome
    (blup_read, Pheno.cpp:1297-1312; blup_read_chr skips per-chromosome
    reads, Step2_Models.cpp:60)."""
    blup = np.zeros(n_samples)
    with open_read(path) as fh:
        n_tok, cols, idx = _loco_columns(fh.readline(), id_to_ind)
        if not use_prs:
            for _ in range(chrom - 1):
                fh.readline()
        toks = string_split(fh.readline())
        if len(toks) != n_tok:
            raise ValueError("blup file row length mismatch")
        expect = 0 if use_prs else chrom
        if int(toks[0]) != expect:
            raise ValueError(f"blup file row starts with {toks[0]} instead of {expect}")
    keep = mask[idx]
    cols, idx = cols[keep], idx[keep]
    vals = np.asarray(toks, dtype=object)[cols]
    na = vals == "NA"
    if na.any():
        key = next(k for k, i in id_to_ind.items() if i == idx[np.argmax(na)])
        raise ValueError(f"individual {key} has missing predictions for chr {chrom}")
    blup[idx] = np.fromiter(map(float, vals), np.float64, len(vals))
    return blup


def read_ltco_prs(path, ltco_chr, id_to_ind, n_samples, mask, n_chrom):
    """Per-chromosome contribution of ltco_chr recovered from a .loco
    file (blup_read w_ltco branch, Pheno.cpp:1341-1381):
    sum_c loco_c / (nchr-1) - loco_ltco = perchr_ltco."""
    full = np.zeros(n_samples)
    ltco = np.zeros(n_samples)
    nchr = 0
    with open_read(path) as fh:
        header = string_split(fh.readline())
        for line in fh:
            toks = string_split(line)
            if not toks:
                continue
            is_ltco = int(toks[0]) == ltco_chr
            for col in range(1, len(header)):
                key = header[col]
                if key not in id_to_ind:
                    continue
                idx = id_to_ind[key]
                if not mask[idx] or toks[col] == "NA":
                    continue
                ds = float(toks[col])
                full[idx] += ds
                if is_ltco:
                    ltco[idx] = -ds
            nchr += 1
    if nchr != n_chrom:
        raise ValueError("incorrectly formatted LOCO file for LTCO")
    return ltco + full / (nchr - 1)


def mask_samples_missing_loco(params, pd, blup_files, id_to_ind):
    """Mask samples absent (or NA) in each trait's .loco file
    (blup_read, Pheno.cpp:1241-1330)."""
    for ph, name in enumerate(pd.pheno_names):
        if name not in blup_files:
            continue
        path = blup_files[name]
        with open_read(path) as fh:
            _, cols, idx = _loco_columns(fh.readline(), id_to_ind)
            vals = string_split(fh.readline())
        if params.use_prs and vals[0] != "0":
            # --use-prs expects whole-genome .prs files (blup_read,
            # Pheno.cpp:1297)
            raise ValueError(f"second line must start with 0 (={vals[0]})")
        present = np.zeros(params.n_samples, dtype=bool)
        present[idx[np.asarray(vals, dtype=object)[cols] != "NA"]] = True
        pd.masked_indivs[:, ph] &= present
        if pd.masked_indivs[:, ph].sum() < 1:
            pd.pheno_pass[ph] = False


@dataclass
class BlockResult:
    """Per-variant test outputs for a block, all phenos."""

    bhat: np.ndarray
    se: np.ndarray
    chisq: np.ndarray
    logp: np.ndarray
    test_fail: np.ndarray
    ignored: np.ndarray
    ignored_trait: np.ndarray
    af_t: np.ndarray
    ns_t: np.ndarray
    scale_fac: np.ndarray
    mac_t: np.ndarray  # [B, P]
    af1: np.ndarray
    ns1: np.ndarray
    info_t: Optional[np.ndarray] = None  # [B, P] INFO (BGEN)
    genocounts: Optional[np.ndarray] = None  # [B, 6, P] (htp mode)
    n_rr: Optional[np.ndarray] = None  # [B] hardcall class counts (merged
    n_aa: Optional[np.ndarray] = None  # output's N_RR / N_AA; not BGEN)
    af_case: Optional[np.ndarray] = None  # [B, P] (--af-cc)
    af_control: Optional[np.ndarray] = None
    ns_case: Optional[np.ndarray] = None
    ns_control: Optional[np.ndarray] = None

    def slice_rows(self, lo: int, hi: int) -> "BlockResult":
        """Row window [lo:hi) of every per-variant field (the gene-based
        loop scores many sets' masks as one block and splits it back)."""
        kw = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            kw[f.name] = v[lo:hi] if isinstance(v, np.ndarray) else v
        return BlockResult(**kw)

    @staticmethod
    def concat_rows(parts: List["BlockResult"]) -> "BlockResult":
        """The row-wise concatenation of results of equal layout."""
        kw = {}
        for f in dataclasses.fields(parts[0]):
            v = getattr(parts[0], f.name)
            kw[f.name] = (np.concatenate([getattr(r, f.name) for r in parts])
                          if isinstance(v, np.ndarray) else v)
        return BlockResult(**kw)


def _fetch_packed(vals: dict, fdt=None) -> dict:
    """Fetch a dict of [B]/[B, X] device tensors in ONE device->host copy:
    concatenate on the device in `fdt` (by default the products' float
    dtype, that of vals["s1"]), copy, split and cast back (exact: every
    value is in that dtype already or an integer count far below its
    mantissa limit)."""
    names = list(vals)
    fdt = fdt or vals["s1"].dtype
    parts = [(v[:, None] if v.dim() == 1 else v).to(fdt) for v in vals.values()]
    packed = torch.cat(parts, dim=1).cpu().numpy()
    out, o = {}, 0
    for k, p, v in zip(names, parts, vals.values()):
        sl = packed[:, o : o + p.shape[1]]
        o += p.shape[1]
        a = sl[:, 0] if v.dim() == 1 else sl
        out[k] = a.astype(bool) if v.dtype == torch.bool else np.ascontiguousarray(a)
    return out


class LocalRows(NamedTuple):
    """A fused block's rows that this process reads on a multi-process QT
    run (Step2Engine.local_rows): the rows themselves, as read_block_raw
    reads a block, and the block's row count."""

    rows: np.ndarray
    n: int


class FusedRowSource:
    """A fused block's genotype source for the corrections: the block's
    num/denum (host) and S1 products (device) from the fused products,
    and the correction rows decoded again on the card from the block's
    resident bytes or BGEN planes (the analog of the reference's per-SNP
    G_res rebuild, Step2_Models.cpp:520-540). step2_bt.score_block reads
    all of it; the Cox route reads only rows_device (S1_all None)."""

    def __init__(self, eng, raw, flip, num, denum, S1_all):
        self.eng = eng
        # the uploaded block: [B, nbp] bytes or [B, 2, Np] planes, or on a
        # mesh its row shards (gathered on the first shard's device when a
        # correction row is first read)
        self._raw = raw
        self.flip = flip  # [B] bool tensor on the device
        self._num, self._denum, self._S1 = num, denum, S1_all
        self.n_snps = int(num.shape[0])

    @property
    def raw(self):
        sh = self._raw
        if isinstance(sh, pm.Sharded):
            self._raw = (pm.gather(sh.parts, 0, sh.n) if sh.whole is None
                         else self.eng._pad_bytes(sh.whole.to(self.eng.device)))
        return self._raw

    def allpass(self, fc):
        return self._num, self._denum, self._S1

    def rows_device(self, idx):
        """[S, N] float64 finalized genotypes of rows idx (a device index
        tensor): flipped, mean-imputed, zero outside the analysis, and
        DOM/REC-coded for hardcalls."""
        eng = self.eng
        gd, params = eng.gd, eng.params
        ind = torch.as_tensor(eng.pd.ind_in_analysis, device=self.raw.device)
        keep = (None if gd._pgen is not None or gd._keep_all_samples
                else torch.as_tensor(np.asarray(gd.sample_keep_idx),
                                     device=self.raw.device))
        if gd._bgen is not None:
            # dosages from the probability byte planes, in float32 as the
            # JAX package's fused BGEN source takes them
            # (regenie_tpu/run_step2.py:189-196), then finalized in float64
            Nf = gd._bgen.n_samples_file
            pl = self.raw[idx]
            k0 = pl[:, 0, :Nf].to(torch.float32)
            k1 = pl[:, 1, :Nf].to(torch.float32)
            miss = (k0 + k1) > 255.0
            ds = (2.0 * torch.where(miss, 0.0, k0)
                  + torch.where(miss, 0.0, k1)) / 255.0
            if params.ref_first:
                ds = 2.0 - ds
            ds = torch.where(miss, float(MISSING), ds)
            if keep is not None:
                ds = ds[:, keep]
            return finalize_block_step2(ds, ind, self.flip[idx])
        is_bed = gd._bed is not None
        nsrc = gd._bed.n_samples if is_bed else params.n_samples
        Graw = decode_bed_packed(self.raw[idx][:, : eng._fused_nb], nsrc)
        if is_bed and params.ref_first:
            Graw = torch.where(Graw == MISSING, Graw, 2 - Graw).to(torch.int8)
        if is_bed and keep is not None:
            Graw = Graw[:, keep]
        G = finalize_block_step2(Graw, ind, self.flip[idx])
        if params.test_type == 1:
            G = torch.where(G == 2.0, 1.0, G)
        elif params.test_type == 2:
            G = torch.where(G >= 1.0, G - 1.0, G)
        return G


class Step2Engine:
    """Association-test state and per-block scoring (QT, BT or CT; BED, PGEN
    or BGEN), on the fused route (test_raw_block_fused) or the dense one
    (test_raw_block), chosen per block by fused_block.

    device: where the operand lives and the products run (resolved by
    utils.device.resolve_device). On CUDA the operand is the int8 limbs,
    or with REGENIE_TPU_I8=0 float32, each through its kernel.
    kernel=False keeps a float64 operand and the plain products on any
    device — the on-card reference the kernel path is checked against.

    mesh: the single-process mesh (parallel/mesh.py maybe_mesh, on QT, BT,
    CT and T2E runs outside --strict, as in the JAX package,
    regenie_tpu/run_step2.py:313-322). The fused blocks' rows and the
    dense route's score products are then sharded over it; everything
    else runs on its first shard's device, which becomes `device`."""

    def __init__(self, params: Params, gd, pd, blup_files, log, device=None,
                 kernel: bool = True):
        self.params = params
        self.gd = gd
        self.pd = pd
        self.blup_files = blup_files
        self.log = log
        self.device = resolve_device(device)
        self.mesh = pm.run_mesh(params, self.device)
        # the per-shard copies of the dense route's operands
        self.replicas = None
        if self.mesh is not None:
            self.device = self.mesh[0]
            self.replicas = pm.Replicas(self.mesh)
            log(f" * multi-device mesh: {self.mesh.describe()} (variant-axis "
                "sharding)")
        # REGENIE_TPU_MESH_2D: the fused scorer's hardcall routes tile the
        # global shards as variant rows x sample windows (Mesh2D;
        # regenie_tpu/run_step2.py:324-355); BGEN and the dense route keep
        # the 1-D mesh (_fused_mesh), and so does a multi-process run whose
        # processes' cells do not each form a rectangle of the grid
        self.mesh2d = None
        if self.mesh is not None and os.environ.get(pm.MESH_2D_ENV):
            m2 = pm.Mesh2D(self.mesh)
            if m2.rects is not None:
                self.mesh2d = m2
                slabs = (f", {process_count()} processes x rectangular slabs"
                         if self.mesh.spans_processes else "")
                log(f" * 2-D mesh for the fused scorer: {m2.describe()} "
                    f"(variant x sample tiling{slabs})")
        self.kernel = kernel
        on_gpu = self.device.type == "cuda"
        self.split = fsc.split_mode(on_gpu) if kernel else False
        self.op_dtype = fsc.operand_dtype(self.split, on_gpu, kernel)
        self.id_to_ind = {s.key: i for i, s in enumerate(gd.samples)}
        self.maskf = pd.masked_indivs.astype(np.float64)
        self.strict = bool(params.strict_mode)
        self.scale_denom = float(params.n_analyzed - params.ncov)
        self.cur_chrom = None
        self.res = None
        self.p_sd_yres = None
        self.scf_sv = None
        self.n_ignored = 0
        self.is_bt = params.trait_mode == BT
        # binary and count traits: the GLM score test on the null state
        self.is_glm = params.trait_mode in (BT, CT)
        # time-to-event traits: the Cox score test on the null state
        self.is_t2e = params.trait_mode == T2E
        self.null_state = None
        # --use-null-firth: trait name -> .firth file (read_pred_list)
        self.null_firth_files = None
        self.n_corrected = 0
        self.n_failed = 0
        # chrX non-PAR blocks scored on the fused route with the male tail
        self.n_male_tail = 0
        # seconds of the BT null fits and of the corrections
        self.bt_times = {"null_s": 0.0, "corr_s": 0.0}
        self._fused_chrom = None
        self._fused_static = None
        self._ltco_prs = {}
        self._dense = None
        # interaction tests (models/interaction.py): E and, for QT, the HLM
        # design; their blocks take the dense route
        self.interaction = None
        self.hlm_null_s = 0.0  # seconds of the HLM null fits
        self.last_G_imputed = None
        self.last_G_int = None
        self.last_flipped = None
        if params.interaction_var:
            from .models.interaction import prep_interaction

            self.interaction = prep_interaction(params, pd, gd, log)
        self.fused = self.fused_ok()
        self.planes_rejected = False  # latched by the first rejected block

    def refresh_masks(self):
        """Re-derive cached per-trait mask arrays after pd.masked_indivs
        changed (mask_samples_missing_loco runs post-construction)."""
        self.maskf = self.pd.masked_indivs.astype(np.float64)
        self._fused_chrom = None
        self._fused_static = None
        self._dense = None

    def prep_chrom(self, chrom: int):
        """LOCO residuals of every trait for `chrom` (compute_res,
        Data.cpp:2386-2425)."""
        if chrom == self.cur_chrom:
            return
        self.cur_chrom = chrom
        params, pd, N, P = self.params, self.pd, self.params.n_samples, self.params.n_pheno
        blups = np.zeros((N, P))
        if self.blup_files is not None:
            for ph, name in enumerate(pd.pheno_names):
                if not pd.pheno_pass[ph] or name not in self.blup_files:
                    continue
                blups[:, ph] = read_loco_chr(
                    self.blup_files[name], chrom, self.id_to_ind, N,
                    pd.masked_indivs[:, ph], use_prs=params.use_prs,
                )
                # LTCO: also remove the extra chromosome's contribution
                # (blup_read_chr, Step2_Models.cpp:121)
                if params.ltco_chr > 0 and chrom != params.ltco_chr:
                    if ph not in self._ltco_prs:
                        self._ltco_prs[ph] = read_ltco_prs(
                            self.blup_files[name], params.ltco_chr,
                            self.id_to_ind, N, pd.masked_indivs[:, ph],
                            params.n_chrom,
                        )
                    blups[:, ph] -= self._ltco_prs[ph]
        if self.is_glm or self.is_t2e:
            t0 = time.time()
            if self.is_bt:
                self.null_state = step2_bt.prep_chromosome(
                    params, pd, blups, self.log, self.null_firth_files, chrom)
            elif self.is_t2e:
                self.null_state = step2_t2e.prep_chromosome(params, pd, blups, self.log)
            else:
                self.null_state = step2_ct.prep_chromosome(params, pd, blups, self.log)
            dt = time.time() - t0
            self.bt_times["null_s"] += dt
            if params.verbose:
                self.log(f" * null fits chr{chrom}: {dt:.3f}s (on the host)")
            self.res = self.null_state.res
            return
        if params.blup_cov:
            # --prs-cov: project the PRS out by a per-trait LM fit instead
            # of the unit-slope offset (get_lm_resid, Pheno.cpp:1854)
            denom = (blups**2).sum(axis=0)
            beta_lm = np.where(
                denom > 0, (blups * pd.phenotypes).sum(axis=0) / np.where(denom > 0, denom, 1.0), 0.0
            )
            res = (pd.phenotypes - blups * beta_lm[None, :]) * pd.masked_indivs
        else:
            res = (pd.phenotypes - blups) * pd.masked_indivs
        # two-stage RINT of residuals (Sofer et al. 2020;
        # residualize_res, Data.cpp:2408-2425)
        if params.rerint or params.rerint_cov:
            from .io.pheno import rint_values

            for ph in range(P):
                if pd.pheno_pass[ph]:
                    m = pd.masked_indivs[:, ph]
                    res[:, ph] = rint_values(res[:, ph], m) * m
            if params.rerint_cov:
                beta = res.T @ pd.new_cov
                res = (res - pd.new_cov @ beta.T) * pd.masked_indivs
        self.p_sd_yres = np.linalg.norm(res, axis=0) / np.sqrt(
            pd.Neff - params.ncov_analyzed
        )
        self.res = res / self.p_sd_yres[None, :]
        self.scf_sv = pd.scale_Y * self.p_sd_yres
        if self.interaction is not None and self.interaction.hlm is not None:
            from .models.interaction import hlm_fit_null

            t0 = time.time()
            hlm_fit_null(params, pd, self.interaction, blups, self.log, self.device)
            dt = time.time() - t0
            self.hlm_null_s += dt
            if params.verbose:
                self.log(f" * HLM null fits chr{chrom}: {dt:.3f}s (L-BFGS-B on the "
                         f"host, objective on {self.device})")

    def non_par_flags(self, bsnps) -> np.ndarray:
        """[B] bool: variant on chrX outside PAR1/PAR2 (in_non_par,
        Geno.cpp:2802)."""
        p = self.params
        return np.array([
            (s.chrom == p.n_chrom)
            and (p.par1_max_bound < s.physpos < p.par2_min_bound)
            for s in bsnps
        ])

    def pheno_counts(self, ph):
        """(n_cases_or_total, n_controls_or_None) for HTP gene rows."""
        if self.is_bt:
            cases = int(((self.pd.phenotypes_raw[:, ph] == 1)
                         & self.pd.masked_indivs[:, ph]).sum())
            return cases, int(self.pd.Neff[ph]) - cases
        return int(self.pd.Neff[ph]), None

    def model_type(self) -> str:
        """HTP Model string (Data.cpp:2093-2102)."""
        p = self.params
        test = {0: "ADD", 1: "DOM", 2: "REC"}[p.test_type]
        wgr = "" if p.skip_blups else "-WGR"
        if p.trait_mode == CT:
            return test + wgr + "-POISSON"
        if self.is_t2e:
            return test + wgr + ("-COX-FIRTH" if p.firth else "-COX")
        if not self.is_bt:
            return test + wgr + "-LR"
        return test + wgr + ("-FIRTH" if p.firth else "-SPA" if p.use_spa
                             else "-LOG")

    def _qt_post(self, stats, denum, scale_fac, flipped):
        """Shared QT tail: effect sizes + --mse-full + --t-test + logp
        (compute_score_qt tail, Step2_Models.cpp:434-460)."""
        params, pd = self.params, self.pd
        bhat, se, chisq = m2.finalize_qt(stats, denum, scale_fac, self.scf_sv, flipped)
        if params.mse_full:
            # full-model MSE: Var(y|g) shrinks by the SNP's own fit
            nk = params.n_analyzed - params.ncov_analyzed
            adj = (nk - np.asarray(stats) ** 2) / (nk - 1.0)
            adj = np.maximum(adj, 1e-12)
            stats = np.asarray(stats) / np.sqrt(adj)
            chisq = chisq / adj
            se = se * np.sqrt(adj)
        if params.t_test:
            # --t-test: p from the t distribution with Neff-K-1 df
            # (get_logp_ttest, Regenie.cpp:1827)
            df_t = pd.Neff - params.ncov_analyzed - 1
            logp = ttest_neglog10(np.asarray(stats), df_t[None, :])
        else:
            logp = chisq_neglog10(chisq)
        return bhat, se, chisq, logp

    def fused_ok(self) -> bool:
        """Whether the fused scorer can run this analysis (the QT and BT
        conditions of the JAX package's fused_ok, regenie_tpu/run_step2.py
        :777-827, without its backend test, so the default is the fused
        route on either device): BED or PGEN hardcalls, or BGEN planes
        (the ADD test, split output, no --htp: HTP and merged output want
        hardcall-threshold counts, nonlinear in dosages; and a file the
        plane extractor reads); for QT no --nocov-approx and no --mcc;
        time-to-event traits on hardcall sources only and not with
        --coxscore-exact (its per-variant variance needs the dense Gres,
        Step2_Models.cpp:672). Interaction tests and REGENIE_TPU_FUSED=0
        send every block down the dense route."""
        if os.environ.get(FUSED_ENV) == "0" or self.interaction is not None:
            return False
        params, gd = self.params, self.gd
        hardcall_src = gd._bed is not None or (
            gd._pgen is not None and not params.dosage_mode)
        bgen_src = (gd._bgen is not None and params.test_type == 0
                    and not params.htp_out and params.split_by_pheno
                    and planes_readable(gd._bgen))
        if not (hardcall_src or bgen_src):
            return False
        if self.is_t2e:
            return hardcall_src and not params.coxscore_exact
        return self.is_glm or (params.trait_mode == QT and not params.skip_cov_res
                              and not params.mcc_test)

    def fused_block(self, bsnps) -> bool:
        """Whether a block goes down the fused route (the JAX package's
        per-block routing, run_step2.py:2300-2372): a fused run, no block
        of the file rejected by the plane extractor so far, and not a chrX
        non-PAR block outside _fused_chrx_ok."""
        return (self.fused and not self.planes_rejected
                and not (self.gd.sex is not None and not self._fused_chrx_ok()
                         and self.non_par_flags(bsnps).any()))

    def _fused_chrx_ok(self) -> bool:
        """Whether chrX non-PAR blocks ride the fused path, with the male
        tail columns in the operand (the QT and BT branches of the JAX
        package's _fused_chrx_ok, regenie_tpu/run_step2.py:859-885):
        default dosage compensation (males diploid-coded, scoring
        unchanged), the ADD test and no --af-cc (case/control counts of
        chrX stay on the dense route); for QT on BGEN no --htp (BT BGEN
        HTP never takes the fused route); time-to-event traits off BGEN
        (their fused route is hardcall-only)."""
        p = self.params
        common = (self.gd.sex is not None and bool(p.test_mode)
                  and not p.skip_dosage_comp and not p.af_cc
                  and p.test_type == 0)
        if self.is_t2e:
            return common and self.gd._bgen is None
        return common and (self.is_glm or self.gd._bgen is None or not p.htp_out)

    @staticmethod
    def _hemizygous_adjust(npb, S1h, SQh, SMh, usum_h, mcol, mm_sl,
                          total1, ns1, mac1, total_t, ns_t, mac_t,
                          with_classes):
        """chrX male-tail stat algebra on the raw product columns (the
        JAX package's _hemizygous_adjust): MAC with 0.5*g for males and
        min(mac, 2*ns - nmales - mac) (compute_mac non-auto branch,
        Geno.cpp:3095) on the non-PAR rows `npb`; with_classes adds the
        hemizygous class counts n1m = 2*S1m - SQm (males with g=1 move
        het -> hom-alt; g=0 males stay hom-ref). Returns (mac1, mac_t,
        n1m or None, n1m_t or None)."""
        male_tot1 = S1h[:, mcol]
        nmales1 = usum_h[mcol] - SMh[:, mcol]
        macx = total1 - 0.5 * male_tot1
        mac1 = np.where(
            npb, np.minimum(macx, 2.0 * ns1 - nmales1 - macx), mac1)
        male_tot_t = S1h[:, mm_sl]
        nmales_t = usum_h[None, mm_sl] - SMh[:, mm_sl]
        macx_t = total_t - 0.5 * male_tot_t
        mac_t = np.where(
            npb[:, None],
            np.minimum(macx_t, 2.0 * ns_t - nmales_t - macx_t), mac_t)
        n1m = n1m_t = None
        if with_classes:
            n1m = np.where(npb, 2.0 * male_tot1 - SQh[:, mcol], 0.0)
            n1m_t = np.where(
                npb[:, None], 2.0 * male_tot_t - SQh[:, mm_sl], 0.0)
        return mac1, mac_t, n1m, n1m_t

    @property
    def _fused_mesh(self):
        """The mesh of the fused route: the 2-D grid on the hardcall
        routes under REGENIE_TPU_MESH_2D, else the 1-D mesh (or None)."""
        if self.mesh2d is not None and self.gd._bgen is None:
            return self.mesh2d
        return self.mesh

    @property
    def per_host_rows(self) -> bool:
        """Whether each process reads only its own rows of a fused block:
        a QT run on a 1-D mesh that spans processes (BT, CT and Cox read
        whole blocks, which their corrections need;
        regenie_tpu/run_step2.py:887-912)."""
        return (self.mesh is not None and self.mesh.spans_processes
                and self.params.trait_mode == QT and self._fused_mesh is self.mesh)

    @property
    def per_host_rect(self) -> bool:
        """Whether each process reads only its rectangle's variant rows of
        a fused block and uploads only its byte columns: a QT run on a 2-D
        grid that spans processes (regenie_tpu/run_step2.py:914-940)."""
        return (self.mesh2d is not None and self.mesh2d.spans_processes
                and self.params.trait_mode == QT and self._fused_mesh is self.mesh2d)

    def rect_rows(self, B: int) -> Tuple[int, int]:
        """The rows [lo, hi) of a block of B rows in this process's
        rectangle of the 2-D grid (the rows padded to a multiple of nv)."""
        m2 = self.mesh2d
        rpg = -(-B // m2.nv)
        (r0, nr), _ = m2.rect
        lo = min(r0 * rpg, B)
        return lo, min((r0 + nr) * rpg, B)

    def local_rows(self, B: int) -> Tuple[int, int]:
        """The rows [lo, hi) of a block of B rows that this process's
        shards hold (the rows padded to the global shard count; hi < lo
        never, hi == lo where it holds only pad rows)."""
        m = self.mesh
        per = -(-B // m.size)
        lo = min(m.first * per, B)
        return lo, min(lo + per * len(m), B)

    def read_block_raw(self, bsnps):
        """A block's genotype source for the fused route, unpadded
        (sample-tile padding happens on the device in _fused_upload).
        BED: [B, nb] packed 2-bit bytes on the FILE sample axis, the mmap
        view itself when the variants are consecutive in the file (no
        host copy). PGEN: [B, nb] BED-coded packed bytes on the KEPT
        sample axis, from the port's native block decoder. BGEN: [B, 2,
        N_file] probability byte planes from the native extractor, which
        raises PlanesRejected for records it cannot read. Each native
        reader raises on a record it cannot read. With per_host_rows (or
        per_host_rect) a LocalRows of this process's rows alone."""
        if self.per_host_rows or self.per_host_rect:
            lo, hi = (self.local_rows if self.per_host_rows
                      else self.rect_rows)(len(bsnps))
            if hi > lo:
                rows = self._read_raw(bsnps[lo:hi])
            else:
                nf = self._fused_nfile()
                rows = np.zeros((0, 2, nf) if self.gd._bgen is not None
                                else (0, (nf + 3) // 4), np.uint8)
            return LocalRows(rows, len(bsnps))
        return self._read_raw(bsnps)

    def _read_raw(self, bsnps) -> np.ndarray:
        if self.gd._bgen is not None:
            return extract_planes_block(self.gd._bgen,
                                        [s.offset for s in bsnps])
        if self.gd._pgen is not None:
            return self.gd.read_block_bytes(bsnps)
        offsets = np.array([s.offset for s in bsnps])
        start, stop = int(offsets[0]), int(offsets[-1]) + 1
        raw = self.gd._bed.read_block_bytes(start, stop - start)
        if len(offsets) != stop - start:
            raw = raw[offsets - start]
        return np.ascontiguousarray(raw)

    def _fused_nfile(self) -> int:
        """Sample count on the byte source's axis: the FILE axis for BED
        bytes and BGEN planes, the kept axis for PGEN bytes."""
        if self.gd._bgen is not None:
            return self.gd._bgen.n_samples_file
        if self.gd._bed is not None:
            return self.gd._bed.n_samples
        return self.params.n_samples

    def _scatter_file(self, x):
        """Map a kept-sample-axis array onto the byte source's sample
        axis (zeros at dropped samples); PGEN bytes are already on the
        kept axis (identity)."""
        gd = self.gd
        if gd._pgen is not None or gd._keep_all_samples:
            return x
        idx = np.asarray(gd.sample_keep_idx)
        out = np.zeros((self._fused_nfile(),) + x.shape[1:], dtype=np.float64)
        out[idx] = x
        return out

    def _ensure_fused_consts(self):
        """(Re)build the fused-scorer constants; the residual columns
        change per chromosome, so keyed on cur_chrom. The chromosome-
        independent columns (cov/CM/mask/ind, the chrX male tail whenever
        _fused_chrx_ok holds, as in the JAX package, and for BGEN with a
        kernel, on the int8 or the float32 operand, the narrow [maskf |
        ind] SQ operand Wq) are packed once; residual columns start at
        zero and are patched on the device."""
        if self._fused_chrom == self.cur_chrom:
            return
        if self.is_glm:
            self._ensure_fused_bt()
            return
        if self.is_t2e:
            self._ensure_fused_t2e()
            return
        pd, params = self.pd, self.params
        is_bgen = self.gd._bgen is not None
        nb = (self._fused_nfile() + 3) // 4
        tile = self._nbp_tile()
        res_f = self._scatter_file(self.res)
        if self._fused_static is None:
            cov_f = self._scatter_file(pd.new_cov)
            mask_f = self._scatter_file(self.maskf)
            ind_f = self._scatter_file(
                pd.ind_in_analysis.astype(np.float64)).astype(bool)
            male_f = None
            if self._fused_chrx_ok():
                male_f = self._scatter_file(
                    (self.gd.sex == 1).astype(np.float64))
            base = fsc.build_consts(
                cov_f, np.zeros_like(res_f), mask_f, ind_f, self.scale_denom,
                nb=nb, device=self.device, split=self.split,
                pack="sample" if is_bgen else "plane", op_dtype=self.op_dtype,
                male=male_f, nbp_tile=tile,
            )
            covz_f = cov_f * ind_f.astype(np.float64)[:, None]
            Cp = -(-base.layout_C() // 128) * 128
            Wq = None
            if is_bgen and (self.split == "i8"
                            or self.op_dtype == torch.float32):
                indz = ind_f.astype(np.float64)[:, None]
                Wq, _ = fsc.sample_pack(
                    np.concatenate([mask_f * indz, indz], axis=1), self.split,
                    self.device, self.op_dtype)
            self._fused_static = (
                base, covz_f,
                base.usum.cpu().numpy().astype(np.float64), Cp, Wq,
            )
        base, covz_f, usum_static, Cp, Wq = self._fused_static
        K, P = base.K, base.P
        if is_bgen:
            res_pl = np.zeros((fsc.op_nbp(base.Wp), P))
            res_pl[: res_f.shape[0]] = res_f
        else:
            res_pl = fsc.plane_order_rows(res_f, nb, tile)
        # float32 for the int8 operand (quantized on the device) and for
        # the float32 operand, as the JAX package rounds them on a TPU
        res_pl = torch.from_numpy(res_pl).to(
            self.device, torch.float32 if self.split == "i8" else self.op_dtype)
        Wp = fsc.patch_res_columns(base.Wp, res_pl, K, P, Cp)
        u = usum_static.copy()
        u[K : K + P] = res_f.sum(axis=0)
        self._usum_h = u
        self._fused_consts = fsc.FusedConsts(
            Wp=Wp, usum=torch.from_numpy(u).to(self.device),
            covt_res=torch.from_numpy(covz_f.T @ res_f).to(self.device),
            Mmat=base.Mmat, n_ind=base.n_ind, K=K, P=P,
            scale_denom=base.scale_denom, split=base.split, inc=base.inc,
            has_male=base.has_male, Wq=Wq,
        )
        # --ref-first swaps alleles of the raw BED bytes and BGEN planes
        # in product space; PGEN names REF and ALT itself (no swap)
        if is_bgen:
            self._fused_fn = fsc.make_qt_bgen_fn(
                self._fused_consts, self.kernel, bool(params.ref_first),
                mesh=self.mesh, strict=self.strict)
        else:
            self._fused_fn = fsc.make_qt_block_fn(
                self._fused_consts, self.kernel, params.test_type,
                bool(params.ref_first) and self.gd._bed is not None,
                mesh=self._fused_mesh, strict=self.strict,
            )
        self._fused_op_nbp = fsc.op_nbp(Wp)
        self._fused_chrom = self.cur_chrom

    def _ensure_fused_bt(self):
        """The BT fused operand of the chromosome (the BT branch of the JAX
        package's _ensure_fused_consts, regenie_tpu/run_step2.py:1232-1305):
        Wext = [Wcat (Pn*(Kmax+1)) | gsm^2 (Pn) | maskf (P) | case (P) |
        ind (1)], with the chrX male tail [male | maskf*male (P) |
        case*male (P)] whenever _fused_chrx_ok holds; the null refit
        changes every column, so the whole operand is packed again a
        chromosome. On BGEN with a kernel the squared-dosage products run
        against Wq, the narrow operand of the columns from gsm^2 on."""
        pd, params, gd = self.pd, self.params, self.gd
        is_bgen = gd._bgen is not None
        st = self.null_state
        P = params.n_pheno
        fc = step2_bt.fused_consts(pd, st)
        Pn = len(fc.cols)
        Kp1 = fc.Kmax + 1 if Pn else 1
        ncat = Pn * Kp1
        ind = pd.ind_in_analysis
        indf = ind.astype(np.float64)
        case = self._case_ctrl()[0].astype(np.float64)
        cols = ([fc.Wcat, fc.gsm2] if Pn else []) + [self.maskf, case,
                                                    indf[:, None]]
        Wext_f = self._scatter_file(np.concatenate(cols, axis=1))
        has_male = self._fused_chrx_ok()
        if has_male:
            # hemizygous MAC / class counts from the male product columns,
            # and the hemizygous HTP case counts from case*male
            malez = self._scatter_file((gd.sex == 1).astype(np.float64) * indf)
            maskf_f = Wext_f[:, ncat + Pn : ncat + Pn + P]
            case_f = Wext_f[:, ncat + Pn + P : ncat + Pn + 2 * P]
            Wext_f = np.concatenate(
                [Wext_f, malez[:, None], maskf_f * malez[:, None],
                 case_f * malez[:, None]], axis=1)
        nb = (self._fused_nfile() + 3) // 4
        if is_bgen:
            Wp, usum = fsc.sample_pack(Wext_f, self.split, self.device,
                                       self.op_dtype)
        else:
            Wp, usum = fsc.plane_pack(Wext_f, nb, self.split, self.device,
                                      self.op_dtype, self._nbp_tile())
        icol = ncat + Pn + 2 * P
        C_used = icol + 1 + ((2 * P + 1) if has_male else 0)
        self._fused_bt = SimpleNamespace(
            fc=fc, Wp=Wp, usum=usum, ncat=ncat, Pn=Pn, Kp1=Kp1, icol=icol,
            sl_mask=slice(ncat + Pn, ncat + Pn + P),
            sl_case=slice(ncat + Pn + P, ncat + Pn + 2 * P),
            C_used=C_used, n_ind=float(indf.sum()), has_male=has_male,
            case_n=case.sum(axis=0))
        # --ref-first swaps the raw BED bytes' and BGEN planes' alleles in
        # product space; PGEN names REF and ALT itself
        if is_bgen:
            Wq = None
            if self.kernel and (self.split == "i8"
                                or self.op_dtype == torch.float32):
                Wq, _ = fsc.sample_pack(Wext_f[:, ncat:], self.split,
                                        self.device, self.op_dtype)
            self._fused_fn = fsc.make_bt_bgen_fn(
                Wp, usum, fc.xwt if Pn else np.zeros((0, 0)), C_used, icol,
                float(indf.sum()), ncat, Pn, Kp1, self.kernel,
                bool(params.ref_first), Wq=Wq, mesh=self.mesh)
        else:
            self._fused_fn = fsc.make_bt_block_fn(
                Wp, usum, fc.xwt if Pn else np.zeros((0, 0)), C_used, icol,
                float(indf.sum()), ncat, Pn, Kp1, self.kernel,
                params.test_type, bool(params.ref_first) and gd._bed is not None,
                mesh=self._fused_mesh)
        self._fused_nb = nb
        self._fused_op_nbp = fsc.op_nbp(Wp)
        self._fused_chrom = self.cur_chrom

    def _ensure_fused_t2e(self):
        """The Cox fused operand of the chromosome (the T2E branch of the
        JAX package's _ensure_fused_consts, regenie_tpu/run_step2.py
        :1156-1227): Wext = [per passing trait WX1*ind | R*ind | v (2q + 1
        columns, q = K + 1) | case (P) | maskf (P) | ind (1)], with the chrX
        male tail [male | maskf*male (P) | case*male (P)] whenever
        _fused_chrx_ok holds. R's rows are zeroed off the analysis so that
        A' = G R matches the dense route's ind-zeroed G; R'R keeps every
        kept row, because the dense ||Gres||^2 includes (A R')^2 where G is
        zero. The null refit changes every column, so the operand is packed
        again a chromosome."""
        pd, params, gd = self.pd, self.params, self.gd
        st = self.null_state
        P = params.n_pheno
        passing = step2_t2e.passing_traits(pd, st)
        q = pd.new_cov.shape[1] + 1
        indf = pd.ind_in_analysis.astype(np.float64)
        cols = []
        for ph in passing:
            mle = st.mle[ph]
            cols += [mle.WX1 * indf[:, None], mle.X1_X1WX1inv * indf[:, None],
                     (mle.residual * pd.masked_indivs[:, ph])[:, None]]
        # HTP's cases are the events
        case = self._case_ctrl()[0].astype(np.float64)
        Wext_f = self._scatter_file(np.concatenate(
            cols + [case, self.maskf, indf[:, None]], axis=1))
        nt = len(passing) * (2 * q + 1)
        has_male = self._fused_chrx_ok()
        if has_male:
            malez = self._scatter_file((gd.sex == 1).astype(np.float64) * indf)
            maskf_f = Wext_f[:, nt + P : nt + 2 * P]
            case_f = Wext_f[:, nt : nt + P]
            Wext_f = np.concatenate(
                [Wext_f, malez[:, None], maskf_f * malez[:, None],
                 case_f * malez[:, None]], axis=1)
        nb = (self._fused_nfile() + 3) // 4
        Wp, usum = fsc.plane_pack(Wext_f, nb, self.split, self.device, self.op_dtype,
                                  self._nbp_tile())
        icol = nt + 2 * P
        C_used = icol + 1 + ((2 * P + 1) if has_male else 0)
        Rtv = np.zeros((len(passing), q))
        RtR = np.zeros((len(passing), q, q))
        for j, ph in enumerate(passing):
            R = st.mle[ph].X1_X1WX1inv
            Rtv[j] = R.T @ (st.mle[ph].residual * pd.masked_indivs[:, ph])
            RtR[j] = R.T @ R
        rv = np.array([st.mle[ph].res_var for ph in passing])
        self._fused_t2e = SimpleNamespace(
            Wp=Wp, usum=usum, icol=icol, C_used=C_used, has_male=has_male,
            sl_case=slice(nt, nt + P), sl_mask=slice(nt + P, nt + 2 * P),
            case_n=case.sum(axis=0), n_ind=float(indf.sum()))
        self._fused_fn = fsc.make_t2e_block_fn(
            Wp, usum, Rtv, RtR, rv, C_used, icol, float(indf.sum()), len(passing),
            q, self.kernel, params.test_type,
            bool(params.ref_first) and gd._bed is not None, mesh=self._fused_mesh)
        self._fused_nb = nb
        self._fused_op_nbp = fsc.op_nbp(Wp)
        self._fused_chrom = self.cur_chrom

    def _nbp_tile(self):
        """The byte padding of a plane-packed operand: on the 2-D grid ns x
        the kernel tile, so that each sample column's byte window is
        tile-aligned (regenie_tpu/run_step2.py:1067-1073); else the
        default."""
        m = self._fused_mesh
        return fsc._TC * m.ns if isinstance(m, pm.Mesh2D) else None

    def _fused_variant_stats(self, op, S1h, SQh, SMh, bsnps, with_classes=True):
        """Per-variant statistics of a GLM or Cox fused block from the raw
        product columns of its operand `op` (icol, sl_mask, has_male,
        usum, n_ind): allele counts, frequencies and MAC of all analysed
        samples and per trait, the hardcall class counts, the chrX
        hemizygous adjustment of the non-PAR rows (with_classes: also the
        class moves of all, of each trait and of each trait's cases, from
        the case*male columns), and the MAC and --minHOMs filters."""
        params, pd = self.params, self.pd
        B, P = len(bsnps), params.n_pheno
        icol, msl = op.icol, op.sl_mask
        v = SimpleNamespace()
        v.total1 = total1 = S1h[:, icol]
        v.ns1 = ns1 = op.n_ind - SMh[:, icol]
        with np.errstate(divide="ignore", invalid="ignore"):
            v.af1 = total1 / (2.0 * ns1)
        mac1 = np.minimum(total1, 2.0 * ns1 - total1)
        v.total_t = total_t = S1h[:, msl]
        v.ns_t = ns_t = pd.Neff[None, :] - SMh[:, msl]
        with np.errstate(divide="ignore", invalid="ignore"):
            v.af_t = total_t / (2.0 * ns_t)
        mac_t = np.minimum(total_t, 2.0 * ns_t - total_t)
        v.n_aa1 = (SQh[:, icol] - total1) / 2.0
        v.n_rr1 = ns1 - total1 + v.n_aa1
        v.n1m_t = v.n1m_case = None
        if op.has_male:
            non_par = self.non_par_flags(bsnps)
            if non_par.any():
                self.n_male_tail += 1
                mac1, mac_t, n1m, v.n1m_t = self._hemizygous_adjust(
                    non_par, S1h, SQh, SMh, op.usum, icol + 1,
                    slice(icol + 2, icol + 2 + P), total1, ns1, mac1,
                    total_t, ns_t, mac_t, with_classes=with_classes)
                if n1m is not None:
                    v.n_aa1 = v.n_aa1 + n1m
                    # case-side hemizygous class moves (case*male columns)
                    cm_sl = slice(icol + 2 + P, icol + 2 + 2 * P)
                    v.n1m_case = np.where(non_par[:, None],
                                          2.0 * S1h[:, cm_sl] - SQh[:, cm_sl], 0.0)
        v.mac_t = mac_t
        ignored, v.ignored_trait = self._mac_filters(params, bsnps, mac1, mac_t, B)
        if params.test_type == 2 and params.min_homs > 0:
            ignored = ignored | self._rec_min_homs(S1h, SQh, SMh, icol, total1, ns1)
        self.n_ignored += int(ignored.sum())
        v.ignored = ignored
        return v

    @staticmethod
    def _fused_genocounts(op, S1h, SQh, SMh, v, by_case):
        """[B, 6, P] HTP genotype counts from the raw product columns:
        by_case, rows 0-2 of the cases (op.sl_case) and rows 3-5 of the
        rest of the trait's samples; else rows 0-2 of all samples
        (compute_genocounts, Geno.cpp:2898). Class counts per column set:
        H = (SQ - S1)/2, E = 2*S1 - SQ; chrX non-PAR males with g >= 1
        count as hom (update_genocounts hemizygous branch, Geno.cpp:2922)."""
        msl, csl = op.sl_mask, op.sl_case
        a_t = (SQh[:, msl] - v.total_t) / 2.0
        het_t = v.total_t - 2.0 * a_t
        if v.n1m_t is not None:
            a_t, het_t = a_t + v.n1m_t, het_t - v.n1m_t
        rr_t = v.ns_t - het_t - a_t
        if by_case:
            tot_case = S1h[:, csl]
            ns_case = op.case_n[None, :] - SMh[:, csl]
            a_case = (SQh[:, csl] - tot_case) / 2.0
            het_case = tot_case - 2.0 * a_case
            if v.n1m_case is not None:
                a_case, het_case = a_case + v.n1m_case, het_case - v.n1m_case
            rr_case = ns_case - het_case - a_case
            gc = np.stack([rr_case, het_case, a_case, rr_t - rr_case,
                           het_t - het_case, a_t - a_case], axis=1)
        else:
            zero = np.zeros_like(rr_t)
            gc = np.stack([rr_t, het_t, a_t, zero, zero, zero], axis=1)
        return np.round(gc).astype(np.int64)

    def _fused_block_t2e(self, raw, bsnps) -> Tuple[BlockResult, np.ndarray]:
        """Fused Cox pipeline (the JAX package's _fused_block_t2e,
        regenie_tpu/run_step2.py:1753-1880): the products against the Cox
        operand give each trait's T and denum on the device, every
        per-variant statistic (the hemizygous classes of chrX included)
        and the flips; HTP's genotype counts split by event; the Firth
        rows are decoded again from the resident block (FusedRowSource)."""
        params, pd = self.params, self.pd
        ft = self._fused_t2e
        raw_t = self._fused_upload(raw)
        S1, SQ, SM, flip_t, Tnum, denum = self._fused_fn(raw_t)
        f = _fetch_packed(dict(s1=S1, sq=SQ, sm=SM, fl=flip_t, num=Tnum, den=denum))
        S1h, SQh, SMh = f["s1"], f["sq"], f["sm"]
        flipped = f["fl"]
        v = self._fused_variant_stats(ft, S1h, SQh, SMh, bsnps)
        source = FusedRowSource(self, raw_t, flip_t, f["num"], f["den"], None)

        def rows_host(idx):
            return source.rows_device(
                torch.as_tensor(idx, device=self.device)).cpu().numpy()

        bhat, se, chisq, logp, test_fail, ncorr, nfail = step2_t2e.score_block_fused(
            params, pd, self.null_state, f["num"], f["den"], flipped, rows_host,
            v.ignored, v.ignored_trait, self.bt_times)
        self.n_corrected += ncorr
        self.n_failed += nfail
        result = BlockResult(
            bhat=bhat, se=se, chisq=chisq, logp=logp, test_fail=test_fail,
            ignored=v.ignored, ignored_trait=v.ignored_trait, af_t=v.af_t,
            ns_t=v.ns_t, scale_fac=None, mac_t=v.mac_t, af1=v.af1,
            ns1=np.round(v.ns1).astype(np.int64))
        result.n_rr = np.round(v.n_rr1).astype(np.int64)
        result.n_aa = np.round(v.n_aa1).astype(np.int64)
        if params.htp_out:
            # cases = events (compute_genocounts trait_mode==3 branch)
            result.genocounts = self._fused_genocounts(ft, S1h, SQh, SMh, v, True)
        return result, flipped

    def _fused_block_bt(self, raw, bsnps) -> Tuple[BlockResult, np.ndarray]:
        """Fused BT pipeline (the JAX package's _fused_block_bt,
        regenie_tpu/run_step2.py:1579-1752): the products against the BT
        operand give the all-trait score num/denum, every per-variant
        statistic (--af-cc and the HTP case/control genotype counts
        included) and the flips, decided on the device; the rows past the
        correction threshold are decoded again from the resident block
        (FusedRowSource)."""
        params, pd = self.params, self.pd
        fb = self._fused_bt
        is_bgen = self.gd._bgen is not None
        raw_t = self._fused_upload(raw)
        outs = self._fused_fn(raw_t)
        if is_bgen:
            S1, SQ, SM, IL, flip_t, num, denum, S1_all = outs
        else:
            S1, SQ, SM, flip_t, num, denum, S1_all = outs
            IL = None
        # one device -> host copy of every host-side output (S1_all stays
        # on the card for the correction rows)
        fd = dict(s1=S1, sq=SQ, sm=SM, fl=flip_t, num=num, den=denum)
        if IL is not None:
            fd["il"] = IL
        f = _fetch_packed(fd)
        S1h, SQh, SMh = f["s1"], f["sq"], f["sm"]
        flipped = f["fl"]
        # hardcall class counts are nonlinear in dosages
        v = self._fused_variant_stats(fb, S1h, SQh, SMh, bsnps,
                                      with_classes=not is_bgen)
        source = FusedRowSource(self, raw_t, flip_t, f["num"], f["den"], S1_all)
        ignored_trait = v.ignored_trait
        info_t = None
        if is_bgen:
            info_t = self._fused_info_t(f["il"], SQh, fb.sl_mask, v.ns_t, v.af_t)
            if params.set_min_info:
                ignored_trait = ignored_trait | (info_t < params.min_info)

        bhat, se, chisq, logp, test_fail, ncorr, nfail = step2_bt.score_block(
            params, pd, self.null_state, source, flipped, v.ignored, ignored_trait,
            self.bt_times)
        self.n_corrected += ncorr
        self.n_failed += nfail
        result = BlockResult(
            bhat=bhat, se=se, chisq=chisq, logp=logp, test_fail=test_fail,
            ignored=v.ignored, ignored_trait=ignored_trait, af_t=v.af_t,
            ns_t=v.ns_t, scale_fac=None, mac_t=v.mac_t, af1=v.af1,
            ns1=np.round(v.ns1).astype(np.int64), info_t=info_t)
        if not is_bgen:
            result.n_rr = np.round(v.n_rr1).astype(np.int64)
            result.n_aa = np.round(v.n_aa1).astype(np.int64)
        if params.af_cc and self.is_bt:
            # case-side raw products (before the flip, as update_af_cc
            # reads G_raw)
            tot_case = S1h[:, fb.sl_case]
            ns_case = fb.case_n[None, :] - SMh[:, fb.sl_case]
            with np.errstate(divide="ignore", invalid="ignore"):
                result.af_case = tot_case / (2.0 * ns_case)
                result.af_control = (v.total_t - tot_case) / (2.0 * (v.ns_t - ns_case))
            result.ns_case = np.round(ns_case).astype(np.int64)
            result.ns_control = np.round(v.ns_t - ns_case).astype(np.int64)
        if params.htp_out:
            # CT: all-sample counts (compute_genocounts else-branch)
            result.genocounts = self._fused_genocounts(fb, S1h, SQh, SMh, v,
                                                       self.is_bt)
        return result, flipped

    @staticmethod
    def _mac_filters(params, bsnps, mac1, mac_t, B):
        """Shared MAC gating (compute_mac, Geno.cpp:3100-3107)."""
        mac_gate = np.array([s.mac_fail_if_checked for s in bsnps])
        mac_thr = np.array([
            params.forced_mac if s.forced_mac_filter and params.forced_mac > 0
            else params.min_mac
            for s in bsnps
        ])
        mac_ignored = (mac1 < mac_thr) & mac_gate
        ignored_trait = (mac_t < mac_thr[:, None]) & mac_gate[:, None]
        return mac_ignored, ignored_trait

    def _rec_min_homs(self, S1h, SQh, SMh, icol, total1, ns1):
        """--minHOMs recessive hom-carrier filter from the raw product
        columns (parseSnpfromBed, Geno.cpp:2518): positive entries of the
        REC-coded finalized G sum to hom_count + v*nmiss."""
        with np.errstate(divide="ignore", invalid="ignore"):
            m_b = np.where(ns1 > 0, total1 / np.maximum(ns1, 1.0), 0.0)
        v = np.where(m_b >= 1.0, m_b - 1.0, m_b)
        H1 = (SQh[:, icol] - total1) / 2.0
        return (H1 + v * SMh[:, icol]) < self.params.min_homs

    def _fused_upload(self, raw):
        """Block -> device tensor, its last (byte or sample) axis zero-
        padded to the operand's contraction length; on a mesh a
        parallel.mesh.Sharded, the rows zero-padded to the shard count
        and each shard uploaded to its own device (the JAX package's
        _fused_upload, regenie_tpu/run_step2.py:1421-1455, 1-D). Idempotent,
        so the prefetch thread can upload block k+1 while the device scores
        block k."""
        if isinstance(raw, (torch.Tensor, pm.Sharded)):
            return raw
        mesh = self._fused_mesh
        if isinstance(mesh, pm.Mesh2D):
            if isinstance(raw, LocalRows):
                with warnings.catch_warnings():
                    # mmap views are read-only; nothing writes through them
                    warnings.simplefilter("ignore", UserWarning)
                    rows = torch.from_numpy(np.ascontiguousarray(raw.rows))
                return pm.Sharded(fsc.block_cells(mesh, rows, self._fused_op_nbp,
                                                  raw.n, self.rect_rows(raw.n)[0]),
                                  raw.n)
        elif isinstance(raw, LocalRows):
            # this process's rows: its shards' parts of the padded block
            per = -(-raw.n // mesh.size)
            slab = torch.zeros((len(mesh), per) + raw.rows.shape[1:], dtype=torch.uint8)
            slab.view(-1, *raw.rows.shape[1:])[: raw.rows.shape[0]] = \
                torch.from_numpy(np.ascontiguousarray(raw.rows))
            return pm.Sharded([self._pad_bytes(p.to(d)) for p, d in zip(slab, mesh)],
                              raw.n)
        with warnings.catch_warnings():
            # mmap views are read-only; nothing writes through them
            warnings.simplefilter("ignore", UserWarning)
            raw_t = torch.from_numpy(raw)
        if mesh is None:
            return self._pad_bytes(raw_t.to(self.device))
        if isinstance(mesh, pm.Mesh2D):
            # the whole block stays on the host for the correction rows
            return pm.Sharded(fsc.block_cells(mesh, raw_t, self._fused_op_nbp),
                              raw_t.shape[0], raw_t)
        sh = pm.shard_rows(mesh, raw_t)
        # a process of a multi-process run keeps the whole block for the
        # correction rows (FusedRowSource), which a gather would not give
        return pm.Sharded([self._pad_bytes(p) for p in sh.parts], sh.n,
                          raw_t if mesh.spans_processes else None)

    def _pad_bytes(self, raw_t):
        """raw_t with its last axis zero-padded to the operand's length."""
        nbp = self._fused_op_nbp
        if raw_t.shape[-1] < nbp:
            out = torch.zeros(raw_t.shape[:-1] + (nbp,), dtype=torch.uint8,
                              device=raw_t.device)
            out[..., : raw_t.shape[-1]] = raw_t
            raw_t = out
        return raw_t

    def _fused_info_t(self, ILh, SQh, msl, ns_t, af_t):
        """Per-trait MACH INFO from the product columns: the per-sample
        info numerator 4*ph + p1 - ds^2 sums to IL - SQ over each trait
        mask (compute_aaf_info, Geno.cpp:3110-3142)."""
        info_num_t = ILh[:, msl] - SQh[:, msl]
        with np.errstate(divide="ignore", invalid="ignore"):
            info_t = 1.0 - info_num_t / (2.0 * ns_t * af_t * (1.0 - af_t))
        return np.where((af_t == 0) | (af_t == 1), 1.0, info_t)

    def test_raw_block_fused(self, raw, bsnps) -> Tuple[BlockResult, np.ndarray]:
        """Fused pipeline for a block of packed BED or PGEN bytes (three
        products) or BGEN planes (six products): the products replace
        decode/impute/residualize/score AND the per-variant stat pass —
        AF/MAC/INFO/genotype counts all come from the same product
        columns, the male tail's for the hemizygous MAC and class counts
        of chrX non-PAR rows."""
        params, pd = self.params, self.pd
        self._ensure_fused_consts()
        if self.is_glm:
            return self._fused_block_bt(raw, bsnps)
        if self.is_t2e:
            return self._fused_block_t2e(raw, bsnps)
        consts = self._fused_consts
        B, P = len(bsnps), consts.P
        is_bgen = self.gd._bgen is not None
        outs = self._fused_fn(self._fused_upload(raw))
        stats, denum, scale_fac, low_var, S1, SQ, SM = outs[:7]
        fd = dict(s1=S1, sq=SQ, sm=SM, st=stats, d=denum, g=scale_fac,
                  l=low_var)
        if is_bgen:
            fd["il"] = outs[7]
        f = _fetch_packed(fd)
        S1h, SQh, SMh = f["s1"], f["sq"], f["sm"]
        stats, denum, scale_fac, low_var = f["st"], f["d"], f["g"], f["l"]
        flipped = np.zeros(B, dtype=bool)  # QT never flips (with_flip=False)

        # per-variant stats from the raw (pre-imputation) products
        C_used = consts.layout_C()
        male_off = (P + 1) if consts.has_male else 0
        icol = C_used - 1 - male_off
        msl = slice(icol - P, icol)
        total1 = S1h[:, icol]
        ns1 = consts.n_ind - SMh[:, icol]
        with np.errstate(divide="ignore", invalid="ignore"):
            af1 = total1 / (2.0 * ns1)
        mac1 = np.minimum(total1, 2.0 * ns1 - total1)
        total_t = S1h[:, msl]
        ns_t = pd.Neff[None, :] - SMh[:, msl]
        with np.errstate(divide="ignore", invalid="ignore"):
            af_t = total_t / (2.0 * ns_t)
        mac_t = np.minimum(total_t, 2.0 * ns_t - total_t)
        n_aa1 = (SQh[:, icol] - total1) / 2.0
        n_rr1 = ns1 - total1 + n_aa1
        n1m_t = None
        if consts.has_male:
            non_par = self.non_par_flags(bsnps)
            if non_par.any():
                self.n_male_tail += 1
                # hemizygous MAC (+ class counts for hardcalls; BGEN's
                # narrow Wq carries no male SQ and emits no class rows)
                mac1, mac_t, n1m, n1m_t = self._hemizygous_adjust(
                    non_par, S1h, SQh, SMh,
                    self._usum_h,
                    C_used - 1 - P, slice(C_used - P, C_used),
                    total1, ns1, mac1, total_t, ns_t, mac_t,
                    with_classes=not is_bgen)
                if n1m is not None:
                    n_aa1 = n_aa1 + n1m

        mac_ignored, ignored_trait = self._mac_filters(params, bsnps, mac1, mac_t, B)
        if params.test_type == 2 and params.min_homs > 0:
            mac_ignored = mac_ignored | self._rec_min_homs(
                S1h, SQh, SMh, icol, total1, ns1
            )
        # low_var excluded from the tally (it counts MAC/minHOMs only)
        self.n_ignored += int(mac_ignored.sum())
        ignored = mac_ignored | low_var
        info_t = None
        if is_bgen:
            info_t = self._fused_info_t(f["il"], SQh, msl, ns_t, af_t)
            if params.set_min_info:
                ignored_trait = ignored_trait | (info_t < params.min_info)

        bhat, se, chisq, logp = self._qt_post(stats, denum, scale_fac, flipped)
        result = BlockResult(
            bhat=bhat, se=se, chisq=chisq, logp=logp,
            test_fail=np.zeros((B, P), dtype=bool),
            ignored=ignored, ignored_trait=ignored_trait,
            af_t=af_t, ns_t=ns_t, scale_fac=scale_fac, mac_t=mac_t,
            af1=af1, ns1=np.round(ns1).astype(np.int64), info_t=info_t,
        )
        if not is_bgen:
            # hardcall class counts (nonlinear for dosages)
            result.n_rr = np.round(n_rr1).astype(np.int64)
            result.n_aa = np.round(n_aa1).astype(np.int64)
        if params.htp_out:
            a_t = (SQh[:, msl] - total_t) / 2.0
            het_t = total_t - 2.0 * a_t
            if n1m_t is not None:
                a_t = a_t + n1m_t
                het_t = het_t - n1m_t
            rr_t = ns_t - het_t - a_t
            gc = np.zeros((B, 6, P))
            gc[:, 0, :] = rr_t
            gc[:, 1, :] = het_t
            gc[:, 2, :] = a_t
            result.genocounts = np.round(gc).astype(np.int64)
        return result, flipped


    # ---- the dense route (the JAX package's test_raw_block pipeline) ----

    def _ensure_dense_consts(self):
        """The dense route's device operands: per run the analysis and
        trait masks, the covariate basis and the sexes, and for the
        one-pass scorer Mmat and W = [cov | res | CM]; per chromosome the
        residuals (patched into W's res columns) and cov' res."""
        pd, params = self.pd, self.params
        dev = self.device

        def put(a):
            return torch.as_tensor(np.asarray(a, np.float64), device=dev)

        d = self._dense
        if d is None:
            d = self._dense = SimpleNamespace(
                ind=torch.as_tensor(pd.ind_in_analysis, device=dev),
                mask=torch.as_tensor(pd.masked_indivs, device=dev),
                maskf=put(self.maskf), cov=put(pd.new_cov),
                sex=(None if self.gd.sex is None
                     else torch.as_tensor(self.gd.sex, device=dev)),
                W=None, Mmat=None, chrom=None)
            d.indf = d.ind.to(torch.float64)
            d.maskf1 = torch.cat([d.maskf, torch.ones_like(d.maskf[:, :1])], 1)
        if d.chrom != self.cur_chrom:
            d.res = put(self.res)
            d.covt_res = put(pd.new_cov.T @ self.res)
            if (params.trait_mode == QT and self.mesh is None
                    and not (params.skip_cov_res or self.strict)):
                K, P = d.cov.shape[1], d.res.shape[1]
                if d.W is None:
                    CM, d.Mmat, _ = m2.onepass_constants(d.cov, d.maskf, d.res)
                    d.W = m2.onepass_weights(d.cov, d.res, CM)
                    del CM
                else:
                    d.W[:, K : K + P] = d.res
            d.chrom = self.cur_chrom
        return d

    def read_block_dense(self, bsnps):
        """A block's host read for the dense route: (G, info_num), G the
        kept samples' [B, N] float64 dosages of a dosage source (BGEN, or
        a PGEN with dosage tracks) or else the block's packed hardcall
        bytes; info_num BGEN's per-sample INFO numerators, or None."""
        if self.gd.dosage_source:
            return self.gd.read_dosages(bsnps)
        return self.gd.read_block_bytes(bsnps), None

    def upload_dense(self, host, bsnps):
        """read_block_dense's result on the device: (G, info_num), G the
        [B, N] float64 dosages or int8 hardcalls (decoded on the card)."""
        G, info = host
        G = self.gd.read_block_device(bsnps, self.device, G)
        if info is not None:
            info = torch.from_numpy(info).to(self.device)
        return G, info

    def block_stats(self, G_raw, bsnps=None) -> dict:
        """Per-variant stats of a raw block (hardcalls or dosages; the
        JAX package's block_stats) as host arrays. G_raw: a [B, N] tensor
        on the engine's device, or a host numpy block, which ships as
        packed 2-bit bytes when it holds only hardcalls {0, 1, 2, -3}
        (4x less host->device traffic than int8)."""
        d = self._ensure_dense_consts()
        kw = {}
        if bsnps is not None and self.gd.sex is not None and self.params.test_mode:
            non_par = self.non_par_flags(bsnps)
            if non_par.any():
                kw = dict(non_par=torch.as_tensor(non_par, device=self.device),
                          sex=d.sex, skip_comp=bool(self.params.skip_dosage_comp))
        if isinstance(G_raw, np.ndarray):
            with np.errstate(invalid="ignore"):
                hardcalls = bool(np.isin(G_raw, (0, 1, 2, MISSING)).all())
            if hardcalls and G_raw.size:
                raw = torch.from_numpy(pack_hardcalls(G_raw)).to(self.device)
                return _fetch_packed(snp_stats_block_packed(
                    raw, G_raw.shape[1], d.ind, d.mask, **kw), torch.float64)
            G_raw = torch.from_numpy(np.asarray(G_raw, np.float64)).to(self.device)
        return _fetch_packed(snp_stats_block(G_raw, d.ind, d.mask, **kw),
                             torch.float64)

    def _case_ctrl(self):
        """[N, P] boolean (case, control) masks of the HTP counts and
        --af-cc, within each trait's mask: the 1 and 0 values, or for
        time-to-event traits each time column's events and censored
        samples (step2_t2e.event_sides)."""
        pd = self.pd
        if self.is_t2e:
            return step2_t2e.event_sides(self.params, pd)
        return ((pd.phenotypes_raw == 1) & pd.masked_indivs,
                (pd.phenotypes_raw == 0) & pd.masked_indivs)

    def compute_genocounts(self, G_raw, bsnps=None) -> np.ndarray:
        """[B, 6, P] genotype counts of a raw block on the device
        (compute_genocounts, Geno.cpp:2898): rows 0-2 the RR/RA/AA counts
        per trait of all samples (QT) or of the cases (BT), rows 3-5 zero
        (QT) or the controls' (BT). Non-PAR chrX males are hemizygous:
        g >= 1 counts as hom (update_genocounts, Geno.cpp:2922), unless
        --skip-dosage-comp halved them."""
        params, d = self.params, self._ensure_dense_consts()
        G = G_raw.to(torch.float64)
        valid = (G != MISSING) & d.ind[None, :]
        lo, hi = 0.5, 1.5
        if bsnps is not None and self.gd.sex is not None and not params.skip_dosage_comp:
            non_par = torch.as_tensor(self.non_par_flags(bsnps), device=self.device)
            hemi = non_par[:, None] & (d.sex == 1)[None, :]
            lo = torch.where(hemi, 1.0, 0.5)
            hi = torch.where(hemi, 1.0, 1.5)
        hc = ((G < lo) & valid, (G >= lo) & (G < hi) & valid, (G >= hi) & valid)
        out = np.zeros((G.shape[0], 6, params.n_pheno))
        if self.is_bt or self.is_t2e:
            sides = [torch.as_tensor(c.astype(np.float64), device=self.device)
                     for c in self._case_ctrl()]
        else:
            sides = [d.maskf]
        for side, m in enumerate(sides):
            for k, h in enumerate(hc):
                out[:, 3 * side + k, :] = (h.to(torch.float64) @ m).cpu().numpy()
        return out.astype(np.int64)

    def test_prepared_block(self, G, af_t, ns_t, mac_t, ignored, ignored_trait,
                            flipped, info_t=None, is_mask: bool = False
                            ) -> BlockResult:
        """Score a finalized [B, N] float64 block on the device (the JAX
        package's test_prepared_block): for QT, --nocov-approx scores G
        unadjusted with scale 1; otherwise on a mesh the variant-sharded
        residualize-and-score (parallel.mesh.sharded_score_qt), else the
        one-pass scorer, or in strict mode the residualize-then-score
        pair; with --mcc the skewed traits' rows then take the DKAT
        p-values (models/mcc.py, on the host). BT/CT/T2E: the all-trait
        score test with its corrections (step2_bt / step2_t2e
        .score_block). With
        interaction tests (QT) the residualized block stays on the device
        as last_G_int.

        is_mask: a block of gene-based burden masks. Its residualized
        block (QT; the block itself for the other traits) comes back to
        the host as last_G_res only when a joint test or GENE_P reads it,
        and last_scale_fac holds QT's scale factors."""
        params, d = self.params, self._ensure_dense_consts()
        B = G.shape[0]
        self.n_ignored += int(ignored.sum())
        need_host = is_mask and bool(params.joint_tests
                                     or params.apply_gene_pval_strategy)
        self.last_G_res = None
        self.last_scale_fac = None
        self.last_G_int = None
        if self.is_glm or self.is_t2e:
            if self.is_t2e:
                out = step2_t2e.score_block(params, self.pd, self.null_state, G,
                                            flipped, ignored, ignored_trait,
                                            self.bt_times, replicas=self.replicas)
            else:
                src = (step2_bt.DenseGSource(G) if self.mesh is None
                       else step2_bt.MeshGSource(G, self.replicas))
                out = step2_bt.score_block(
                    params, self.pd, self.null_state, src,
                    flipped, ignored, ignored_trait, self.bt_times)
            bhat, se, chisq, logp, test_fail, ncorr, nfail = out
            self.n_corrected += ncorr
            self.n_failed += nfail
            if need_host:
                self.last_G_res = G.cpu().numpy()
            return BlockResult(
                bhat=bhat, se=se, chisq=chisq, logp=logp, test_fail=test_fail,
                ignored=ignored, ignored_trait=ignored_trait, af_t=af_t,
                ns_t=ns_t, scale_fac=None, mac_t=mac_t, af1=None, ns1=None,
                info_t=info_t)
        if params.skip_cov_res:
            # --nocov-approx: G unadjusted, scale_fac = 1 (residualize_geno
            # skipped, Data.cpp:2513)
            G_res = G
            stats, denum = m2.score_qt_block(G, d.res, d.maskf, self.scale_denom,
                                             self.strict)
            fd = dict(s=stats, d=denum)
            if need_host:
                fd["G"] = G
            f = _fetch_packed(fd, torch.float64)
            scale_fac, low_var = np.ones(B), np.zeros(B, dtype=bool)
        else:
            G_res = None
            if self.mesh is not None:
                # variant-sharded residualize-and-score
                stats, denum, scale_fac = pm.sharded_score_qt(
                    self.mesh, G, *self.replicas("qt", d.res, d.maskf, d.cov),
                    self.scale_denom)
                low_var = scale_fac < 1e-8
            elif not self.strict:
                stats, denum, scale_fac, low_var = m2.score_qt_block_onepass(
                    G, d.cov, d.res, d.maskf, None, d.Mmat, d.covt_res,
                    self.scale_denom, W=d.W, maskf1=d.maskf1)
            else:
                G_res, scale_fac, low_var = m2.residualize_scale_block(
                    G, d.cov, self.scale_denom)
                stats, denum = m2.score_qt_block(G_res, d.res, d.maskf,
                                                 self.scale_denom, self.strict)
            fd = dict(s=stats, d=denum, g=scale_fac, l=low_var)
            if need_host or self.interaction is not None or params.mcc_test:
                if G_res is None:
                    G_res = m2.residualize_scale_block(G, d.cov, self.scale_denom)[0]
                if need_host:
                    # the host consumers' G_res rides the same copy
                    fd["G"] = G_res
                self.last_G_int = G_res
            f = _fetch_packed(fd, torch.float64)
            scale_fac, low_var = f["g"], f["l"]
        self.last_G_res = f.get("G")
        self.last_scale_fac = scale_fac
        bhat, se, chisq, logp = self._qt_post(f["s"], f["d"], scale_fac, flipped)
        test_fail = np.zeros((B, params.n_pheno), dtype=bool)
        if params.mcc_test:
            # MCC (DKAT) p-values for the skewed traits' rows on the host:
            # the rows of G_res it needs come back from the device
            # (test_prepared_block's MCC branch, regenie_tpu/run_step2.py
            # :700-706)
            from .models.mcc import apply_mcc_qt

            bhat, se, chisq = np.array(bhat), np.array(se), np.array(chisq)
            test_fail = apply_mcc_qt(params, self.pd, G_res, self.res, logp,
                                     se, chisq)
        return BlockResult(
            bhat=bhat, se=se, chisq=chisq, logp=logp, test_fail=test_fail,
            ignored=ignored | low_var, ignored_trait=ignored_trait,
            af_t=af_t, ns_t=ns_t, scale_fac=scale_fac, mac_t=mac_t,
            af1=None, ns1=None, info_t=info_t,
        )

    def test_raw_block(self, blk, bsnps) -> Tuple[BlockResult, np.ndarray]:
        """The dense route for a block (the JAX package's test_raw_block):
        blk = (G_raw, info_num) from upload_dense. --skip-dosage-comp
        halving, stats, the MAC filters, BGEN INFO or PGEN-dosage MACH r2,
        imputation, DOM/REC coding with --minHOMs, scoring, class counts
        and HTP genotype counts. Returns (result, flipped)."""
        params, pd = self.params, self.pd
        d = self._ensure_dense_consts()
        G_raw, info_num = blk
        B = len(bsnps)
        # --skip-dosage-comp: non-PAR chrX males (diploid-coded) become
        # 0/1 before any statistics (parseSnpfromBed, Geno.cpp:2459)
        if params.skip_dosage_comp and self.gd.sex is not None:
            non_par = self.non_par_flags(bsnps)
            if non_par.any():
                Gf = G_raw.to(torch.float64)
                hemi = (torch.as_tensor(non_par, device=self.device)[:, None]
                        & (d.sex == 1)[None, :] & (Gf != MISSING))
                G_raw = torch.where(hemi, Gf / 2.0, Gf)
        sb = self.block_stats(G_raw, bsnps)
        ignored, ignored_trait = self._mac_filters(
            params, bsnps, sb["mac1"], sb["mac"], B)

        info_t = None
        af = sb["af"]
        if info_num is not None:
            info_num_t = ((info_num * d.indf[None, :]) @ d.maskf).cpu().numpy()
            with np.errstate(divide="ignore", invalid="ignore"):
                info_t = 1.0 - info_num_t / (2 * sb["ns_t"] * af * (1 - af))
            info_t = np.where((af == 0) | (af == 1), 1.0, info_t)
        elif params.dosage_mode and params.file_type == "pgen":
            # PGEN dosages: MACH r2 info = (E[g^2]-E[g]^2)/(2p(1-p))
            # (compute_aaf_info, Geno.cpp:3137-3142)
            Gd = G_raw.to(torch.float64)
            g2 = torch.where(Gd == MISSING, 0.0, Gd**2) * d.indf[None, :]
            info_num_t = (g2 @ d.maskf).cpu().numpy()
            with np.errstate(divide="ignore", invalid="ignore"):
                info_t = (info_num_t / sb["ns_t"] - 4 * af**2) / (2 * af * (1 - af))
            info_t = np.where((af == 0) | (af == 1), 1.0, info_t)
        if info_t is not None and params.set_min_info:
            ignored_trait = ignored_trait | (info_t < params.min_info)

        # non-QT additive tests flip to the minor allele (with_flip,
        # Data.cpp:2108); QT never flips
        if params.trait_mode != QT and params.test_type == 0:
            flipped = sb["total"] / sb["ns"] > 1.0
        else:
            flipped = np.zeros(B, dtype=bool)
        G = finalize_block_step2(
            G_raw, d.ind, torch.as_tensor(flipped, device=self.device))
        if params.test_type == 1:
            G = torch.where(G == 2.0, 1.0, G)
        elif params.test_type == 2:
            G = torch.where(G >= 1.0, G - 1.0, G)
            if params.min_homs > 0:
                # --minHOMs: recessive filter on the hom-ALT carrier count
                # (parseSnpfromBed, Geno.cpp:2518)
                sum_pos = torch.where(G > 0, G, 0.0).sum(dim=1).cpu().numpy()
                ignored = ignored | (sum_pos < params.min_homs)
        if self.interaction is not None:
            # the imputed (for BT flipped) block stays on the device for
            # the interaction tests
            self.last_G_imputed, self.last_flipped = G, flipped
        result = self.test_prepared_block(
            G, af, sb["ns_t"], sb["mac"], ignored, ignored_trait, flipped, info_t)
        result.af1 = sb["af1"]
        result.ns1 = sb["ns"].astype(np.int64)
        if params.af_cc and self.is_bt:
            # case/control AF and counts (update_af_cc Geno.cpp:3069,
            # compute_aaf_info :3119-3126), on G_raw before the flip
            Gf = G_raw.to(torch.float64)
            valid = ((Gf != MISSING) & d.ind[None, :]).to(torch.float64)
            Gv = torch.where(Gf == MISSING, 0.0, Gf) * d.indf[None, :]
            casef = torch.as_tensor(
                ((pd.phenotypes_raw == 1) & pd.masked_indivs).astype(np.float64),
                device=self.device)
            tot_case = (Gv @ casef).cpu().numpy()
            ns_case = (valid @ casef).cpu().numpy()
            tot_t = (Gv @ d.maskf).cpu().numpy()
            ns_t = sb["ns_t"]
            with np.errstate(divide="ignore", invalid="ignore"):
                result.af_case = tot_case / (2 * ns_case)
                result.af_control = (tot_t - tot_case) / (2 * (ns_t - ns_case))
            result.ns_case = ns_case.astype(np.int64)
            result.ns_control = (ns_t - ns_case).astype(np.int64)
        result.n_rr = sb["n_rr"].astype(np.int64)
        result.n_aa = sb["n_aa"].astype(np.int64)
        if params.htp_out:
            result.genocounts = self.compute_genocounts(G_raw, bsnps)
        return result, flipped


def setup_writers(params: Params, pheno_names: List[str], pheno_pass=None,
                  pre_header: str = ""):
    """The output files, gzipped with --gz: one per trait (split .regenie
    by default, or HTPv4), or with --no-split one merged <out>.regenie,
    shared by every trait, and its <out>.regenie.Ydict of trait names.
    `pre_header` (the gene-based ##MASKS= line) precedes each header.
    Returns (writers per trait, paths)."""
    gz = ".gz" if params.gz_out else ""
    if not params.split_by_pheno and not params.htp_out:
        path = f"{params.out_prefix}.regenie{gz}"
        fh = open_write(path, gz=params.gz_out)
        fh.write(pre_header)
        fh.write(header_all(params))
        # Ydict maps trait numbers to names (print_summary,
        # Step2_Models.cpp:2655)
        with open_write(params.out_prefix + ".regenie.Ydict") as yd:
            for ip, name in enumerate(pheno_names):
                yd.write(f"Y{ip+1} {name}\n")
        return [fh] * len(pheno_names), [path]
    writers, out_paths = [], []
    hdr = header_htp() if params.htp_out else header_single(params)
    for ip, name in enumerate(pheno_names):
        if pheno_pass is not None and not pheno_pass[ip]:
            writers.append(None)
            continue
        path = f"{params.out_prefix}_{name}.regenie{gz}"
        fh = open_write(path, gz=params.gz_out)
        fh.write(pre_header)
        fh.write(hdr)
        writers.append(fh)
        out_paths.append(path)
    return writers, out_paths


def _htp_trait(params, name):
    """The HTP Trait column of a trait: with --htp-with-event a time
    column shows its event column's name."""
    if params.htp_use_eventname and params.t2e_map:
        return params.t2e_map.get(name, name)
    return name


def write_block_rows(params, pd, writers, bsnps, r: BlockResult, test_name="ADD",
                     model_type=None):
    B = len(bsnps)
    if params.htp_out:
        # hot path: whole-column native rendering, one call per trait
        if native_formatter("format_sumstat_htp") is not None:
            prefix = htp_prefixes(bsnps)
            for ph in range(params.n_pheno):
                if not pd.pheno_pass[ph] or writers[ph] is None:
                    continue
                writers[ph].write(format_block_htp(
                    params, prefix[0], prefix[1], _htp_trait(params, pd.pheno_names[ph]),
                    model_type or test_name,
                    skip=r.ignored | r.ignored_trait[:, ph],
                    beta=r.bhat[:, ph], se=r.se[:, ph], chisq=r.chisq[:, ph],
                    logp=r.logp[:, ph], af=r.af_t[:, ph],
                    info=(r.info_t[:, ph] if r.info_t is not None
                          else np.ones(B)) if params.dosage_mode else None,
                    mac=r.mac_t[:, ph], genocounts=r.genocounts[:, :, ph],
                    neff=pd.Neff[ph], test_fail=r.test_fail[:, ph],
                ))
            return
        for b in range(B):
            if r.ignored[b]:
                continue
            for ph in range(params.n_pheno):
                if not pd.pheno_pass[ph] or r.ignored_trait[b, ph] or writers[ph] is None:
                    continue
                writers[ph].write(sumstat_line_htp(
                    params, bsnps[b], _htp_trait(params, pd.pheno_names[ph]),
                    model_type or test_name,
                    r.bhat[b, ph], r.se[b, ph], r.chisq[b, ph], r.logp[b, ph],
                    r.af_t[b, ph],
                    (r.info_t[b, ph] if r.info_t is not None else 1.0)
                    if params.dosage_mode else None,
                    r.mac_t[b, ph], r.genocounts[b, :, ph],
                    test_pass=not r.test_fail[b, ph], neff=pd.Neff[ph],
                ))
        return
    if not params.split_by_pheno:
        _write_block_all(params, pd, writers[0], bsnps, r, test_name)
        return
    # hot path: whole-column native rendering (OpenMP snprintf), one call
    # per trait; byte-identical to the per-row loop below
    if (native_formatter("format_sumstat_single") is not None
            and len(test_name) <= 40):
        prefix = block_prefixes(bsnps)
        for ph in range(params.n_pheno):
            if not pd.pheno_pass[ph] or writers[ph] is None:
                continue
            writers[ph].write(format_block_single(
                params, prefix[0], prefix[1], test_name,
                skip=r.ignored | r.ignored_trait[:, ph],
                af=r.af_t[:, ph],
                info=r.info_t[:, ph] if r.info_t is not None else None,
                n=r.ns_t[:, ph],
                beta=r.bhat[:, ph], se=r.se[:, ph], chisq=r.chisq[:, ph],
                logp=r.logp[:, ph], test_fail=r.test_fail[:, ph],
                af_case=_col(r.af_case, ph), af_control=_col(r.af_control, ph),
                ns_case=_col(r.ns_case, ph), ns_control=_col(r.ns_control, ph),
            ))
        return
    for b in range(B):
        if r.ignored[b]:
            continue
        for ph in range(params.n_pheno):
            if not pd.pheno_pass[ph] or r.ignored_trait[b, ph] or writers[ph] is None:
                continue
            cc = {} if r.af_case is None else dict(
                af_case=r.af_case[b, ph], af_control=r.af_control[b, ph],
                ns_case=int(r.ns_case[b, ph]), ns_control=int(r.ns_control[b, ph]))
            writers[ph].write(sumstat_line_single(
                params, bsnps[b], test_name, r.af_t[b, ph],
                r.info_t[b, ph] if r.info_t is not None else 1.0,
                int(r.ns_t[b, ph]), r.bhat[b, ph], r.se[b, ph],
                r.chisq[b, ph], r.logp[b, ph],
                test_pass=not r.test_fail[b, ph], **cc,
            ))


def _col(x, ph):
    """Column ph of an optional [B, P] array."""
    return None if x is None else x[:, ph]


def _write_block_all(params, pd, fh, bsnps, r: BlockResult, test_name):
    """A block's rows of the merged --no-split file, rendered in Python:
    one row a variant with every trait's four fields; a trait that fails
    its filters or its pass prints NA there (print_sum_stats_all,
    Step2_Models.cpp:2457)."""
    B, P = len(bsnps), params.n_pheno
    bad = r.ignored_trait[:, :P].astype(bool) | ~np.asarray(
        pd.pheno_pass, bool)[None, :]
    for b in range(B):
        if r.ignored[b]:
            continue
        per_pheno = [
            (-1.0, -1.0, -1.0, -1.0, False) if bad[b, ph] else (
                r.bhat[b, ph], r.se[b, ph], r.chisq[b, ph], r.logp[b, ph],
                not r.test_fail[b, ph])
            for ph in range(P)]
        # INFO prints 1 on dosage sources, as in the JAX package (whose
        # merged rows carry no per-variant INFO)
        fh.write(sumstat_line_all(
            params, bsnps[b], test_name, r.af1[b],
            1.0 if params.dosage_mode else None, int(r.ns1[b]),
            int(r.n_rr[b]), int(r.n_aa[b]), per_pheno))


def write_sample_ids(params, gd, pd, log=print):
    """--write-samples: each analyzed trait's sample list,
    <out>_<trait>.regenie.ids (write_ids, Pheno.cpp:1539)."""
    log(" * user specified to write sample IDs for each trait")
    for ph, name in enumerate(pd.pheno_names):
        if not pd.pheno_pass[ph]:
            continue
        with open_write(f"{params.out_prefix}_{name}.regenie.ids") as fh:
            if params.print_pheno_name:
                # 1st line = pheno name (write_ids, Pheno.cpp:1557)
                fh.write(f"{name}\tNA\n")
            fh.write("\n".join(f"{s.FID}\t{s.IID}"
                               for i, s in enumerate(gd.samples)
                               if pd.masked_indivs[i, ph]))


def open_engine(params: Params, log=print, device=None):
    """The run-up of run_step2 before its block loop: the mode check, the
    --pred list, data preparation, the engine and the LOCO sample masks.
    Returns (engine, blocks); `device` as in utils.device.resolve_device."""
    why = unported(params)
    if why is not None:
        raise NotImplementedError(f"{why}: not yet ported to regenie_tpu_torch")
    device = resolve_device(device)
    params.test_mode = True

    blup_files = None
    blup_names = None
    if not params.skip_blups:
        blup_files = read_pred_list(params.pred_list)
        blup_names = list(blup_files.keys())

    rd = prepare(params, blup_pheno_names=blup_names, log=log)
    gd, pd = rd.geno, rd.pheno

    eng = Step2Engine(params, gd, pd, blup_files, log, device)
    if blup_files is not None:
        mask_samples_missing_loco(params, pd, blup_files, eng.id_to_ind)
        pd.Neff = pd.masked_indivs.sum(axis=0).astype(np.float64)
        eng.refresh_masks()

    # the native readers: fail before any work when one cannot run
    if gd._bgen is not None:
        planes_lib()  # the plane extractor and the dosage decoder
        if gd._bgen.compression == 2:
            require_zstd()
    if gd._pgen is not None:
        pgen_lib()
    return eng, make_blocks(gd, params.block_size)


def _open_null_firth_out(params, eng, pd, log):
    """Step 2's --write-null-firth (Data.cpp:2200-2215): <out>_<i>.firth
    per passing trait and <out>_firth.list, the files open in
    params._null_firth_out for the null fits to stream each chromosome's
    coefficients into (step2_bt.prep_chromosome); with --compute-all
    every chromosome 1..n_chrom is fitted now (get_firth_est_allChr,
    Data.cpp:2209)."""
    fh_map = {}
    with open_write(params.out_prefix + "_firth.list") as fl:
        for ph, name in enumerate(pd.pheno_names):
            if not pd.pheno_pass[ph]:
                continue
            fpath = params.out_prefix + f"_{ph+1}.firth"
            fh_map[ph] = open_write(fpath)
            fl.write(f"{name} {fpath if params.use_rel_path else os.path.abspath(fpath)}\n")
    params._null_firth_out = fh_map
    if params.compute_all_chr:
        for c in range(1, params.n_chrom + 1):
            try:
                eng.prep_chrom(c)
            except Exception as e:  # noqa: BLE001 — the JAX package logs and goes on
                log(f"WARNING: null fit failed for chr {c}: {e}")
        eng.cur_chrom = None  # the block loop fits its chromosomes again


def run_step2(params: Params, log=print, device=None) -> Step2Engine:
    """Step 2 (QT, BT, CT or T2E) on a BED, PGEN or BGEN file: one output
    file per trait, or one merged file (--no-split); with --compute-corr
    the LD matrix (run_ldcomp), with --set-list the gene-based tests
    (run_genebased), with --mt the multi-trait tests (run_multitrait),
    with --multiphen MultiPhen (run_multiphen). `device` as in
    utils.device.resolve_device (CUDA unless the CPU is asked for).
    Returns the engine, its output files closed and its genotype source
    open (the caller may score blocks again and closes it)."""
    eng, blocks = open_engine(params, log, device)
    device, pd = eng.device, eng.pd
    if params.debug:
        # dump the model inputs (write_inputs, Data.cpp:2294/911)
        write_debug_inputs(params, pd)
    if params.write_samples:
        write_sample_ids(params, eng.gd, pd, log)
    if params.use_null_firth:
        eng.null_firth_files = read_pred_list(params.use_null_firth)
    if params.write_null_firth and eng.is_bt and params.firth_approx:
        _open_null_firth_out(params, eng, pd, log)
    # the whole-run modes, in the JAX package's order
    # (regenie_tpu/run_step2.py:2251-2263)
    if params.get_cor_mat:
        return run_ldcomp(params, eng, log)
    if params.set_list:
        from .run_genebased import run_genebased

        return run_genebased(params, eng, log)
    if params.trait_set:
        return run_multitrait(params, eng, blocks, log)
    if params.multiphen:
        return run_multiphen(params, eng, blocks, log)
    params.total_n_block = len(blocks)
    log(f" * block size: [{params.block_size}]")
    log(usage_info_line(params))
    log(f" * # blocks: [{params.total_n_block}]")
    log(f" * # tested variants: [{params.n_variants}]")
    src = ("BGEN" if eng.gd._bgen is not None else
           "PGEN" if eng.gd._pgen is not None else "BED")
    how = ("int8 kernel" if eng.split == "i8" else
           "float32 operand kernel" if eng.op_dtype == torch.float32 else
           "float64 plain products")
    dense_line = (f" * dense scorer on {device} ({src} "
                  f"{'dosages' if eng.gd.dosage_source else 'hardcalls'}, "
                  "float64 products)")
    if eng.fused:
        log(f" * fused packed-bytes scorer on {device} ({src}, {how})")
        if eng.per_host_rows:
            log(f" * per-host decode: each of {process_count()} processes reads "
                "only its own variant byte ranges")
        elif eng.per_host_rect:
            (_, nr), (_, nc) = eng.mesh2d.rect
            log(" * per-host 2-D slab decode: each process reads only its own "
                f"{nr}x{nc} grid rectangle of variant rows x byte columns")
    else:
        log(dense_line)
    # on a multi-process run every process scores every block and only the
    # output host renders and writes the rows
    out_host = is_output_host()
    multi = process_count() > 1

    test_name = {0: "ADD", 1: "DOM", 2: "REC"}[params.test_type]
    # interaction runs in the conditional mode mark the marginal rows
    condtl = "-CONDTL" if params.gwas_condtl else ""
    writers, out_paths = setup_writers(params, pd.pheno_names, pd.pheno_pass)
    if eng.interaction is not None:
        from .models.interaction import apply_interaction_block

        log(f" * interaction tests with [{eng.interaction.evar_name}] on {device} "
            "(float64; rows in Python)")

    # --starting-block / --nb window (Data.cpp:2275)
    todo = []
    for block_idx, (chrom, bsnps) in enumerate(blocks, start=1):
        if block_idx < params.starting_block:
            continue
        if params.nb is not None and block_idx >= params.starting_block + params.nb:
            break
        todo.append((chrom, bsnps))

    # one-block lookahead: the read (and, once the operand exists, the
    # device upload) of block k+1 overlaps the scoring and output of
    # block k (the reference's multithreaded readChunk, Data.cpp:2944).
    # Each block goes down the fused route or the dense one
    # (Step2Engine.fused_block); the first block the plane extractor
    # rejects latches the dense route for the rest of the file, as the
    # JAX package does (run_step2.py:977-984).
    upload_ready = threading.Event()
    read_s, up_s = [], []  # host seconds of each block's read and upload
    notes = []  # route changes seen by the reader thread, logged in order

    def _fetch(bsnps):
        """(route, block on the way to the device, host read seconds,
        dense upload seconds or None)."""
        t = time.time()
        if eng.fused_block(bsnps):
            try:
                raw = eng.read_block_raw(bsnps)
            except PlanesRejected as e:
                eng.planes_rejected = True
                notes.append(f" * {e}; this block and the rest of the file "
                             "go down the dense route")
            else:
                t_read = time.time() - t
                if upload_ready.is_set():
                    raw = eng._fused_upload(raw)
                return "fused", raw, t_read, None
        host = eng.read_block_dense(bsnps)
        t1 = time.time()
        blk = eng.upload_dense(host, bsnps)
        return "dense", blk, t1 - t, time.time() - t1

    t0 = time.time()
    n_dense = 0
    pool = ThreadPoolExecutor(max_workers=1)
    # ordered async output: a single writer thread renders + writes block
    # k's rows while the device scores block k+1; bounded queue
    wpool = ThreadPoolExecutor(max_workers=1)
    wpending: list = []
    try:
        fut = pool.submit(_fetch, todo[0][1]) if todo else None
        tblk = time.time()
        for i, (chrom, bsnps) in enumerate(todo):
            kind, data, t_read, t_up = fut.result()
            if multi:
                # the route is agreed before the next block is read: where
                # another process's reader rejected this block, every
                # process takes the dense route from here on, as a single
                # process does
                kinds = allgather_py(kind)
                if kind == "fused" and "dense" in kinds:
                    eng.planes_rejected = True
                    notes.append(" * another process's reader rejected this block; "
                                 "it and the rest of the file go down the dense route")
                    del data
                    kind, data, t_read, t_up = _fetch(bsnps)
            read_s.append(t_read)
            if t_up is not None:
                up_s.append(t_up)
            eng.prep_chrom(chrom)
            if kind == "fused":
                eng._ensure_fused_consts()
                upload_ready.set()
            elif n_dense == 0 and eng.fused:
                log(dense_line + " for the blocks the fused scorer cannot take")
            while notes:
                log(notes.pop(0))
            if i + 1 < len(todo):
                fut = pool.submit(_fetch, todo[i + 1][1])
            if params.verbose or params.debug:
                now = time.time()
                log(f"   -block {i + 1}/{len(todo)} chr{chrom} "
                    f"[{len(bsnps)} snps, {now - tblk:.2f}s, {kind}; host read "
                    f"{t_read:.3f}s"
                    + ("" if t_up is None else f", upload {t_up:.3f}s") + "]")
                tblk = now
            if kind == "fused":
                result, _ = eng.test_raw_block_fused(data, bsnps)
            else:
                n_dense += 1
                result, _ = eng.test_raw_block(data, bsnps)
                del data
            if eng.interaction is not None:
                # the interaction rows follow each block's marginal rows
                # in the same files: written here, in order
                if out_host:
                    write_block_rows(params, pd, writers, bsnps, result,
                                     test_name + condtl, eng.model_type() + condtl)
                apply_interaction_block(
                    params, eng, bsnps, eng.last_G_imputed,
                    eng.last_G_int, result, writers, test_name)
                continue
            if not out_host:
                continue
            while len(wpending) > 4:
                wpending.pop(0).result()
            wpending.append(wpool.submit(
                write_block_rows, params, pd, writers, bsnps, result,
                test_name, eng.model_type(),
            ))
        for w in wpending:
            w.result()
        wpending = []
    finally:
        # drain the writer even when scoring raised, so output files
        # close deterministically; a writer error surfaces unless a
        # scoring error is already propagating
        pool.shutdown(wait=True)
        werr = None
        for w in wpending:
            try:
                w.result()
            except Exception as e:  # noqa: BLE001 — re-raised below
                werr = werr or e
        wpool.shutdown(wait=True)
        for fh in {id(w): w for w in writers if w is not None}.values():
            fh.close()
        if werr is not None and sys.exc_info()[0] is None:
            raise werr
    dt = time.time() - t0
    log("\nAssociation results stored separately for each trait in files:")
    for p_ in out_paths:
        log(f"* [{p_}]")
    if (eng.is_bt or eng.is_t2e) and (params.firth or params.use_spa):
        log(f"Number of tests with {'Firth' if params.firth else 'SPA'} "
            f"correction : {eng.n_corrected}")
        log(f"Number of failed tests : ({eng.n_failed}/{eng.n_corrected})")
    log(f"Number of ignored tests due to low MAC : {eng.n_ignored * params.n_pheno}")
    for fh in getattr(params, "_null_firth_out", {}).values():
        fh.close()
    if eng.is_glm or eng.is_t2e:
        on_dev = eng.is_glm and step2_bt.cdev.enabled(device)
        log(f" * null model fits: {eng.bt_times['null_s']:.3f}s; corrections: "
            f"{eng.bt_times['corr_s']:.3f}s "
            + ("on the device" if on_dev else "on the host"))
    log(f" * block loop: {len(todo)} blocks, "
        f"{sum(len(b) for _, b in todo)} variants in {dt:.3f}s")
    ic = getattr(eng, "int_counts", None)
    if eng.interaction is not None and ic is not None:
        log(f" * interaction tests: robust {ic['robust']} SNPs in "
            f"{ic['robust_s']:.3f}s, HLM {ic['hlm']} SNPs in {ic['hlm_s']:.3f}s, "
            f"BT {ic['bt']} SNPs in {ic['bt_s']:.3f}s, mixed-block rows "
            f"{ic['rows_s']:.3f}s; HLM null fits {eng.hlm_null_s:.3f}s")
    log(f" * dense route: {n_dense} of {len(todo)} blocks")
    if any(c == params.n_chrom for c, _ in todo):
        log(" * chrX non-PAR blocks on the fused route (male tail): "
            f"{eng.n_male_tail}")
    for what, secs in (("host block reads", read_s), ("dense block uploads", up_s)):
        if secs:
            log(f" * {what}: {len(secs)} in {sum(secs):.3f}s (mean "
                f"{sum(secs) / len(secs):.3f}s, max {max(secs):.3f}s)")
    log(f" * done ({dt:.1f}s)")
    return eng


# ---- the whole-run modes: multi-trait tests, MultiPhen, LD matrix ----

def run_multitrait(params: Params, eng: Step2Engine, blocks, log=print) -> Step2Engine:
    """Multi-trait testing mode (--mt; the JAX package's run_multitrait):
    14 joint tests per variant (test_multitrait, Data.cpp:3289). QT only;
    one merged output file. Each block is imputed, residualized and
    scaled on the device, where the tests' [B, N] x [N, 3q] products run
    (models/multitrait.py); the tests' algebra and tails run on the host.
    On a multi-process run the block's rows go round-robin over the
    processes and the results are gathered and merged in row order
    (regenie_tpu/run_step2.py:2440-2490)."""
    from .models.multitrait import mt_header, mt_line, run_mt_block, setup_mt

    if params.trait_mode != QT:
        raise ValueError("multi-trait tests are only supported for QTs")
    gd, pd = eng.gd, eng.pd
    params.total_n_block = len(blocks)
    log(f"Association testing mode (multi-trait tests): {params.n_pheno} traits")
    log(f" * # blocks: [{params.total_n_block}]")
    path = f"{params.out_prefix}.regenie" + (".gz" if params.gz_out else "")
    fh = open_write(path, gz=params.gz_out)
    fh.write(mt_header(params.n_pheno))
    nproc = process_count()
    if nproc > 1:
        log(f" * multi-process multi-trait tests: {nproc} processes, rows round-robin")
    t0 = time.time()
    mt_state = None
    cur_chrom = None
    n_ignored = 0
    try:
        for chrom, bsnps in blocks:
            eng.prep_chrom(chrom)
            if chrom != cur_chrom:
                cur_chrom = chrom
                mt_state = setup_mt(eng.res, pd.masked_indivs)
            d = eng._ensure_dense_consts()
            G_raw = gd.read_block_device(bsnps, eng.device)
            sb = eng.block_stats(G_raw)
            total, ns = sb["total"], sb["ns"]
            ignored = np.minimum(total, 2 * ns - total) < params.min_mac
            G = finalize_block_step2(
                G_raw, d.ind, torch.zeros(len(bsnps), dtype=torch.bool,
                                          device=eng.device))
            G_res, _, low_var = m2.residualize_scale_block(G, d.cov, eng.scale_denom)
            del G
            ignored = ignored | low_var.cpu().numpy()
            if nproc > 1:
                r = _rows_round_robin(
                    len(bsnps), lambda sel: run_mt_block(mt_state, G_res[sel], params))
            else:
                r = run_mt_block(mt_state, G_res, params)
            n_ignored += int(ignored.sum())
            if is_output_host():
                fh.write("".join(
                    mt_line(bsnps[b], sb["mac"][b, 0], sb["af"][b, 0], mt_state.neff0,
                            r, b)
                    for b in range(len(bsnps)) if not ignored[b]))
    finally:
        fh.close()
    log(f"Results written to [{path}]")
    log(f"Number of ignored tests due to low MAC : {n_ignored}")
    log(f" * done ({time.time() - t0:.1f}s)")
    return eng


def _rows_round_robin(B: int, fn) -> dict:
    """fn(rows) -> {key: [len(rows), ...] array} on this process's rows of
    a block of B (row b to process b mod n), every process's results
    gathered and merged into [B, ...] arrays."""
    nproc = process_count()
    sel = np.flatnonzero(np.arange(B) % nproc == process_index())
    res = fn(torch.as_tensor(sel))
    parts = allgather_py((sel, {k: np.asarray(v) for k, v in res.items()}))
    out = {}
    for idx, res in parts:
        for k, v in res.items():
            if k not in out:
                out[k] = np.zeros((B,) + v.shape[1:], v.dtype)
            out[k][idx] = v
    return out


def run_multiphen(params: Params, eng: Step2Engine, blocks, log=print) -> Step2Engine:
    """MultiPhen testing mode (--multiphen; the JAX package's
    run_multiphen): reverse ordinal regression of the genotype on all
    traits (test_multiphen, Data.cpp:3505). QT only; one merged output
    file. The variant statistics come from the device; the fits run on
    the host (models/multiphen.py), batched over the block's score stage
    unless REGENIE_TPU_NO_BATCH_MPHEN is set. On a multi-process run the
    rows go round-robin over the processes and the rendered lines are
    gathered and written in row order
    (regenie_tpu/run_step2.py:2541-2575)."""
    from .models.multiphen import (multiphen_block, multiphen_header,
                                   multiphen_line, multiphen_snp)

    if params.trait_mode != QT:
        raise ValueError("MultiPhen test for QTs only")
    gd, pd = eng.gd, eng.pd
    params.total_n_block = len(blocks)
    log(f"Association testing mode (MultiPhen): {params.n_pheno} traits")
    log(f" * # blocks: [{params.total_n_block}]")
    path = f"{params.out_prefix}.regenie" + (".gz" if params.gz_out else "")
    fh = open_write(path, gz=params.gz_out)
    fh.write(multiphen_header())
    mask0 = pd.masked_indivs[:, 0]
    nproc, pid = process_count(), process_index()
    if nproc > 1:
        log(f" * multi-process MultiPhen: {nproc} processes, rows round-robin")
    t0 = time.time()
    n_ignored = 0
    try:
        for chrom, bsnps in blocks:
            eng.prep_chrom(chrom)
            G_raw = gd.read_block(bsnps)
            sb = eng.block_stats(G_raw, bsnps)
            ignored = sb["mac1"] < params.min_mac
            Gf = np.asarray(G_raw, dtype=np.float64)
            n_ignored += int(ignored.sum())
            local = [b for b in range(len(bsnps)) if not ignored[b] and b % nproc == pid]
            if os.environ.get("REGENIE_TPU_NO_BATCH_MPHEN"):
                results = {b: multiphen_snp(params, Gf[b], pd.new_cov, eng.res, mask0)
                           for b in local}
            else:
                results = multiphen_block(params, Gf, pd.new_cov, eng.res, mask0, local)
            lines = {b: multiphen_line(bsnps[b], sb["mac1"][b], sb["af1"][b],
                                       sb["ns"][b], r) for b, r in results.items()}
            if nproc > 1:
                for part in allgather_py(lines):
                    lines.update(part)
            fh.write("".join(lines[b] for b in sorted(lines)))
    finally:
        fh.close()
    log(f"Results written to [{path}]")
    log(f"Number of ignored tests due to low MAC : {n_ignored}")
    log(f" * done ({time.time() - t0:.1f}s)")
    return eng


LD_CHUNK = 256  # rows of G a step of the LD imputation and projection


class CardClock:
    """Milliseconds of consecutive stages of device work: CUDA events on
    the card (read after one synchronize), the host clock elsewhere."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.marks = [("start", self._now())]

    def _now(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def mark(self, name):
        self.marks.append((name, self._now()))

    def ms(self) -> dict:
        """{stage: ms} from each mark to the next."""
        if self.cuda:
            torch.cuda.synchronize()
        return {n: a.elapsed_time(b) if self.cuda else (b - a) * 1e3
                for (_, a), (n, b) in zip(self.marks, self.marks[1:])}


def _ld_impute(x, ind):
    """Rows of raw genotypes (missing = -3) mean-imputed over the analysed
    samples, the others zero, in float64 (ld_comp's imputation; the mean
    of a row with no observed genotype is 0). Integer codes give sums and
    counts exact in any order."""
    x = x.to(torch.float64)
    miss = x == MISSING
    valid = ~miss & ind[None, :]
    n = valid.sum(dim=1)
    s = torch.where(valid, x, 0.0).sum(dim=1)
    mu = torch.where(n > 0, s / n.clamp(min=1).to(torch.float64), 0.0)
    return torch.where(ind[None, :], torch.where(miss, mu[:, None], x), 0.0)


def ld_gram(src, rows, vecs, M, ind, cov, clock=None):
    """LD = G G' of the [M, N] block, mean-imputed and with the covariate
    basis projected out (G - (G C) C'), in float64 on src's device
    (ld_comp, Data.cpp:3807-4100). src: [Ms, N] raw genotypes of the
    variant rows (int8 hardcalls or float64 dosages, missing = -3); rows:
    [Ms] their rows in G; vecs: {row: [N] host vector} of the mask rows;
    the other rows are zero. ind: [N] bool analysed samples; cov: [N, K].
    clock (CardClock) gets the marks "impute", "project" and "gram"."""
    dev = src.device
    Ms, N = src.shape
    if Ms == M and not vecs and list(rows) == list(range(M)):
        G = torch.empty((M, N), dtype=torch.float64, device=dev)
        for lo in range(0, M, LD_CHUNK):
            G[lo : lo + LD_CHUNK] = _ld_impute(src[lo : lo + LD_CHUNK], ind)
    else:
        G = torch.zeros((M, N), dtype=torch.float64, device=dev)
        ridx = torch.as_tensor(np.asarray(rows, np.int64), device=dev)
        for lo in range(0, Ms, LD_CHUNK):
            G[ridx[lo : lo + LD_CHUNK]] = _ld_impute(src[lo : lo + LD_CHUNK], ind)
        for i, v in vecs.items():
            G[i] = _ld_impute(torch.as_tensor(np.asarray(v, np.float64),
                                              device=dev)[None], ind)[0]
    if clock is not None:
        clock.mark("impute")
    for lo in range(0, M, LD_CHUNK):
        g = G[lo : lo + LD_CHUNK]
        g -= (g @ cov) @ cov.T
    if clock is not None:
        clock.mark("project")
    LD = G @ G.T
    if clock is not None:
        clock.mark("gram")
    return LD


def ld_scale(params: Params, LD: np.ndarray) -> np.ndarray:
    """The host's part of ld_comp on the [M, M] product (Data.cpp:4104-
    4117): numerically-zero negative diagonal entries zero their rows and
    columns; then correlations, or with --skip-scaleG the covariance with
    its diagonal clamped. Returns a new array."""
    LD = np.array(LD, dtype=np.float64)
    dvec = np.diag(LD)
    bad = (dvec < 0) & (np.abs(dvec) < 1e-8)
    if bad.any():
        LD[bad, :] = 0.0
        LD[:, bad] = 0.0
    if not params.skip_scaleG:
        d = np.diag(LD)
        sds = np.sqrt(np.where(d <= 0, params.numtol, d))
        np.fill_diagonal(LD, sds**2)  # Data.cpp:4112-4113
        LD = LD / sds[:, None] / sds[None, :]
    else:
        np.fill_diagonal(LD, np.maximum(np.diag(LD), params.numtol))
    return LD


def ld_r2_codes(LD: np.ndarray) -> np.ndarray:
    """The binary file's uint16 r^2 of the upper triangle (print_ld,
    Data.cpp:4440)."""
    iu = np.triu_indices(LD.shape[0], k=1)
    return (LD[iu] ** 2 * ((1 << 16) - 1) + 0.5).astype(np.uint16)


def _ld_rows(params: Params, eng: Step2Engine, log):
    """The LD matrix's rows (check_ld_list, Geno.cpp:1442-1495; the JAX
    package's run_ldcomp): (names, the variants to read in file order,
    each one's rows, {row: mask vector}, names absent from the data, kept
    in as zero rows)."""
    gd = eng.gd
    index = {s.ID: i for i, s in enumerate(gd.snps)}
    names: List[str] = []
    var_rows: Dict[int, List[int]] = {}  # variant index -> its rows
    vecs: Dict[int, np.ndarray] = {}
    absent: List[str] = []

    def add(name, present=True):
        names.append(name)
        if present:
            var_rows.setdefault(index[name], []).append(len(names) - 1)
        else:
            absent.append(name)

    if params.ld_list_file:
        want_masks: Dict[str, List[str]] = {}
        order = []
        for toks in iter_lines(params.ld_list_file):
            if len(toks) < 2:
                raise ValueError("incorrectly formatted --ld-extract file")
            if toks[0] == "sv":
                order.append(("sv", toks[1]))
            elif toks[0] == "mask":
                if len(toks) < 3:
                    raise ValueError("mask rows need 3 entries in --ld-extract")
                order.append(("mask", toks[1]))
                want_masks.setdefault(toks[2], []).append(toks[1])
            else:
                raise ValueError(f"unrecognized --ld-extract entry '{toks[0]}'")
        mask_vecs: Dict[str, np.ndarray] = {}
        if want_masks:
            from .run_genebased import build_requested_masks

            mask_vecs = build_requested_masks(params, eng, want_masks, log)
        for kind, name in order:
            if kind == "sv":
                # a forced-in absent variant or mask is a zero row
                # (get_G_indices, Data.cpp:3850-3860)
                add(name, name in index)
            elif name in mask_vecs:
                names.append(name)
                vecs[len(names) - 1] = mask_vecs[name]
            else:
                add(name, False)
    elif params.cormat_force_vars and params.extract_files:
        # --forcein-vars + --extract: the extract file's order; listed
        # variants absent from the data stay in as zero rows
        # (check_in_map_from_files, Geno.cpp:1343-1380)
        seen = set()
        for toks in iter_lines(params.extract_files[0]):
            if toks and toks[0] not in seen:
                seen.add(toks[0])
                add(toks[0], toks[0] in index)
    else:
        for s in gd.snps:
            add(s.ID)
    order = sorted(var_rows)
    return (names, [gd.snps[i] for i in order], [var_rows[i] for i in order],
            vecs, absent)


def _ld_write(params: Params, names, absent, LD, log):
    """The .corr.snplist, .corr.forcedIn.snplist and .corr files: binary
    uint16 r^2 with an int32 [N, M] header (the default), --output-corr-
    text (with --skip-scaleG an "M N" header first) or the sparse text
    format of --sparse-thr (Data.cpp:1993-2000, :4123-4140, :4350). On
    a multi-process run every process computes the whole matrix, as in
    the JAX package, and only the output host writes."""
    if not is_output_host():
        return
    M = len(names)
    with open_write(params.out_prefix + ".corr.snplist") as fh:
        fh.write("".join(nm + "\n" for nm in names))
    if absent:
        log(" WARNING: there were variants/masks not found in the data; "
            "these were kept in the LD matrix.\n  + list is written to "
            f"[{params.out_prefix}.corr.forcedIn.snplist]")
        with open_write(params.out_prefix + ".corr.forcedIn.snplist") as fh:
            fh.write("".join(nm + "\n" for nm in absent))
    if params.ld_sparse_thr > 0:
        with open_write(params.out_prefix + ".corr") as fh:
            fh.write(f"{M} {params.n_samples}\n")
            sds = np.sqrt(np.diag(LD))
            fh.write(" ".join(fmt(s) for s in sds) + "\n")
            C = LD / sds[:, None] / sds[None, :]
            iu_i, iu_j = np.triu_indices(M, k=1)
            keep = np.abs(C[iu_i, iu_j]) >= params.ld_sparse_thr
            fh.write("".join(f"{i+1} {j+1} {fmt(C[i, j])}\n"
                             for i, j in zip(iu_i[keep], iu_j[keep])))
    elif params.cor_out_txt:
        with open_write(params.out_prefix + ".corr") as fh:
            if params.skip_scaleG:
                fh.write(f"{M} {params.n_samples}\n")
            fh.write("\n".join(" ".join(fmt(v) for v in row) for row in LD))
    else:
        with open(params.out_prefix + ".corr", "wb") as fh:
            fh.write(np.array([params.n_samples, M], dtype=np.int32).tobytes())
            fh.write(ld_r2_codes(LD).tobytes())
    log(f" * wrote [{params.out_prefix}.corr]")


def run_ldcomp(params: Params, eng: Step2Engine, log=print) -> Step2Engine:
    """LD-matrix mode (--compute-corr; the JAX package's run_ldcomp, one
    process): the scaled G'G of the listed variants and masks (ld_comp,
    Data.cpp:3807; print_ld :4350). The variants' genotypes go up as
    their packed bytes (or dosages) and are decoded, imputed and
    projected on the device, where LD = G G' runs in float64; the [M, M]
    product comes back for the host's diagonal repair, scaling and
    writers. eng.ld keeps the run's inputs and times: names, the raw
    block `src` on the device with its `rows`, `vecs`, the host `LD`,
    and host read, upload and write seconds, the device stages' ms."""
    gd, pd, dev = eng.gd, eng.pd, eng.device
    names, snps, rows, vecs, absent = _ld_rows(params, eng, log)
    M = len(names)
    log(f"** Computing LD matrix ** ({M} variants)")
    t0 = time.time()
    raw = gd.read_block_host_scattered(snps) if snps else None
    t1 = time.time()
    if snps:
        src = gd.read_block_device(snps, dev, raw)
    else:
        src = torch.zeros((0, params.n_samples), dtype=torch.int8, device=dev)
    del raw
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t2 = time.time()
    flat = [r for rr in rows for r in rr]
    if len(flat) > len(snps):  # a variant listed twice: a row per listing
        pick = torch.as_tensor(np.repeat(np.arange(len(rows)), [len(r) for r in rows]),
                               device=dev)
        src = src.index_select(0, pick)
    ind = torch.as_tensor(pd.ind_in_analysis, device=dev)
    cov = torch.as_tensor(np.asarray(pd.new_cov, np.float64), device=dev)
    clock = CardClock(dev)
    LD_d = ld_gram(src, flat, vecs, M, ind, cov, clock)
    ms = clock.ms()
    t3 = time.time()
    LD = ld_scale(params, LD_d.cpu().numpy())
    del LD_d
    _ld_write(params, names, absent, LD, log)
    t4 = time.time()
    eng.ld = SimpleNamespace(names=names, src=src, rows=flat, vecs=vecs, LD=LD,
                             read_s=t1 - t0, upload_s=t2 - t1, card_ms=ms,
                             write_s=t4 - t3)
    log(f" * LD matrix ({M} x {M}): host read {t1 - t0:.3f}s, upload "
        f"{t2 - t1:.3f}s; on {dev}: imputation {ms['impute']:.3f} ms, "
        f"projection {ms['project']:.3f} ms, G'G {ms['gram']:.3f} ms; host "
        f"scaling and write {t4 - t3:.3f}s")
    return eng
