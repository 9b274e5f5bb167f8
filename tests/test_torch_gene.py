"""Tests of the port's gene-based building blocks against the JAX
package's, on the same seeded inputs (the CLI runs are in
tests/test_torch_gene_cli.py, test_torch_gene_options.py and
test_torch_gene_traits.py):

- the readers (io/setfiles.py): sets with --extract-sets/--exclude-sets
  and their list forms, 3- and 4-column annotations with --weights-col,
  mask definitions, AAF files, annotation labels: equal;
- burden masks (models/masks.py) under max, sum and comphet, with
  custom AAFs, domains and singletons, and the LOVO masks: equal arrays;
- the chi-square-mixture tails (utils/quadforms.py) and ACAT
  (models/skat.get_acat, get_acat_rows): within 1e-12;
- the VC products (ops/vc_batch.bucket_products, torch float64 on the
  CPU against JAX x64): rel 1e-12, and byte for byte the same for a set
  whatever the number of sets in its call (1, 2 or 32);
- encode_bed_bytes, and the BGZF / remeta LD writers: the same bytes;
- the Firth and SPA dispatchers of the BT VC tests: within 1e-9;
- the reference's SKATO gate on a single-variant mask, decided by
  rounding (the open fault of ROADMAP.md §3), and the port's the same;
- with marker `cuda`, the VC products on the card against the CPU.

It also builds the shared synthetic gene-based inputs (gene_inputs) and
runs the two CLIs on them with their tails recorded (run_pair,
compare_outputs, chip_smoke.TailTap).
"""

import glob
import os

import numpy as np
import pytest

from chip_smoke import (TailTap, dataset_traits, gene_afs, in_sets, replay_matches,
                        t2e_flags, tail_verdict, write_bgen_dataset, write_bt_table,
                        write_ct_table, write_dataset, write_gene_files,
                        write_pgen_dataset, write_t2e_table)

N, P, K = 800, 2, 3
CHROMS = ((1, 120), (2, 120))
SET_SIZE = 12


def gene_inputs(base):
    """The synthetic gene-based inputs under `base`: a BED of N = 800
    samples and 240 variants on 2 chromosomes, 60% at MAF from 0.5/N to
    0.01 (chip_smoke.gene_afs), 2 traits (Y1 with 10% NA), 3 covariates,
    5 samples removed; 20 sets of 12 variants, each variant LoF,
    missense or synonymous, masks M1 = LoF, M2 = LoF,missense, M3 = all
    (chip_smoke.write_gene_files); binary, count and time-to-event tables
    of the same samples; the same draws as a PGEN of hardcalls, a PGEN
    with dosage tracks on half its variants (dir "pgend") and a BGEN
    (8-bit dosages), each with its own gene files; 4-column annotations
    with two domains a set (dir "dom") and with variant weights (dir "w").
    Returns the directories by name."""
    dirs = {k: os.path.join(base, k)
            for k in ("bed", "dom", "w", "pgen", "pgend", "bgen")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    M = sum(n for _, n in CHROMS)
    af = gene_afs(M, N, 12)
    kw = dict(seed=11, N=N, chroms=CHROMS, P=P, n_inc=1, n_cov=K,
              na_rate=0.1, n_remove=5, effect_sd=0.5, af=af)
    d = dirs["bed"]
    write_dataset(d, **kw)
    write_gene_files(d, CHROMS, SET_SIZE, 13)
    write_gene_files(dirs["dom"], CHROMS, SET_SIZE, 13, domains=True)
    # the annotations with a 4th column of variant weights (--weights-col 4)
    w = write_gene_files(dirs["w"], CHROMS, SET_SIZE, 13)
    with open(w["anno"]) as fh:
        lines = fh.read().splitlines()
    with open(w["anno"], "w") as fh:
        fh.write("".join(f"{ln} {0.05 + 0.1 * (i % 9):.2f}\n"
                         for i, ln in enumerate(lines)))
    Y, X = dataset_traits(11, N, CHROMS, P, K)
    write_bt_table(f"{d}/pheno_bt.txt", Y, 14, prev=(0.15, 0.3), n_inc=1, X=X)
    write_ct_table(f"{d}/pheno_ct.txt", Y, 15)
    write_t2e_table(f"{d}/pheno_t2e.txt", Y, 16, n_na=1, X=X)
    write_pgen_dataset(dirs["pgen"], **kw)
    write_gene_files(dirs["pgen"], CHROMS, SET_SIZE, 13)
    write_pgen_dataset(dirs["pgend"], **kw, dosage=0.5)
    write_gene_files(dirs["pgend"], CHROMS, SET_SIZE, 13)
    write_bgen_dataset(dirs["bgen"], **{**kw, "miss": 0.01})
    write_gene_files(dirs["bgen"], CHROMS, SET_SIZE, 13, bgen=True)
    return dirs


def src_args(dirs, fmt):
    """The genotype flags of the input fmt (bed, pgen, pgend or bgen)."""
    d = dirs[fmt]
    if fmt == "bgen":
        return ["--bgen", f"{d}/geno.bgen", "--sample", f"{d}/geno.sample"]
    return ["--pgen" if fmt.startswith("pgen") else "--bed", f"{d}/geno"]


TRAITS = {"qt": ("pheno.txt", []), "bt": ("pheno_bt.txt", ["--bt"]),
          "ct": ("pheno_ct.txt", ["--ct"]),
          "t2e": ("pheno_t2e.txt", t2e_flags(P))}


def run_pair(dirs, fmt, trait, flags, tag, monkeypatch, gene_dir=None,
             jax_bucket=None, port_env=()):
    """The JAX package's CLI and the port's, on the CPU, in this process,
    on the same gene-based inputs, each with a TailTap installed; returns
    (JAX prefix, port prefix, TapPair). jax_bucket:
    REGENIE_TPU_GENE_BUCKET of the JAX run; port_env: (name, value)
    settings of the port's run."""
    from regenie_tpu import cli as jcli
    from regenie_tpu_torch import cli
    from regenie_tpu_torch.utils.device import DEVICE_ENV

    d, g = dirs["bed"], gene_dir or dirs[fmt]
    pheno, tflags = TRAITS[trait]
    common = ["--step", "2", *src_args(dirs, fmt), "--phenoFile", f"{d}/{pheno}",
              "--covarFile", f"{d}/covar.txt", "--remove", f"{d}/remove.txt",
              "--ignore-pred", "--set-list", f"{g}/sets.txt",
              "--anno-file", f"{g}/anno.txt", "--mask-def", f"{g}/masks.txt",
              "--bsize", "64", *tflags, *flags]
    out = os.path.join(os.path.dirname(d), "out")
    os.makedirs(out, exist_ok=True)
    jx, pt = f"{out}/jx_{tag}", f"{out}/pt_{tag}"
    monkeypatch.setenv(DEVICE_ENV, "cpu")

    def run_jax(prefix, replay=None):
        monkeypatch.delenv("REGENIE_TPU_GENE_BUCKET", raising=False)
        if jax_bucket is not None:
            monkeypatch.setenv("REGENIE_TPU_GENE_BUCKET", str(jax_bucket))
        tap = jax_tap(replay)
        with tap:
            jcli.main(common + ["--out", prefix])
        monkeypatch.delenv("REGENIE_TPU_GENE_BUCKET", raising=False)
        return tap

    jtap = run_jax(jx)
    for k, v in port_env:
        monkeypatch.setenv(k, v)
    ptap = port_tap()
    with ptap:
        cli.main(common + ["--out", pt])
    for k, _ in port_env:
        monkeypatch.delenv(k)
    jr = f"{out}/jr_{tag}"
    return jx, pt, TapPair(jtap, ptap, lambda: run_jax(jr, ptap), jr)


def _jax_bt_products(params, eng, GW_full):
    """The BT VC products of the JAX package's _run_vc_bt, per trait, in
    float64 numpy from its own null state (bt_state)."""
    st, pd = eng.bt_state, eng.pd
    out = []
    for ph in range(params.n_pheno):
        if not pd.pheno_pass[ph]:
            continue
        GWp = GW_full * np.asarray(st.gamma_sqrt_mask)[:, ph][:, None]
        GtWX = np.asarray(st.X_gamma[ph]).T @ GWp
        out.append((GWp.T @ np.asarray(st.res)[:, ph], GWp.T @ GWp - GtWX.T @ GtWX))
    return out


def jax_tap(replay=None):
    """A TailTap on the JAX package's gene-based modules."""
    from regenie_tpu.models import firth, joint, skat, spa

    return TailTap(skat, joint, firth, spa, replay=replay,
                   bt_products=_jax_bt_products)


def port_tap(replay=None):
    """A TailTap on the port's gene-based modules."""
    from regenie_tpu_torch.models import firth, joint, skat, spa

    return TailTap(skat, joint, firth, spa, replay=replay)


class TapPair:
    """The tails of a JAX run (ref) and a port run (got) on the same
    inputs, and `replay`, which runs the JAX CLI again, to the prefix
    `replay_prefix`, with its tails fed the port's tail inputs, and
    returns that run's TailTap."""

    def __init__(self, ref, got, replay, replay_prefix):
        self.ref, self.got = ref, got
        self.replay, self.replay_prefix = replay, replay_prefix

    def verdict(self):
        from regenie_tpu.models import skat as jsk

        return tail_verdict(self.ref, self.got, jsk,
                            corr_rtol={"firth": 1e-9, "spa": 1e-9})


# the VC tests' rows and the gene-level rows combined from them
VC_TESTS = ("SKAT", "SKATO", "SKATO-ACAT", "ACATV", "ACATO", "ACATV-ACAT", "GENE_P")


def _is_vc(test):
    t = test.split("ADD-")[-1].replace("WGR-", "")
    return t.split("_")[0] in VC_TESTS or test.startswith("GENE_P")


def compare_outputs(jx, pt, min_rows=1, pair=None):
    """Every file the JAX run wrote (its log aside) against the port's
    file of the same name: .regenie files with the same rows in the same
    order, the fields up to TEST identical and every number within rel
    1e-9 (test_torch_step2._assert_rows_equiv); every other file (mask
    BED/BIM/FAM, snplists, set lists, reports, remeta LD files) byte for
    byte. Returns {suffix: rows} of the .regenie files.

    pair (a TapPair) holds the tails (chip_smoke.tail_verdict): the VC
    score products, calibrations and tails inputs of the two runs within
    1e-12 (calibrations rel 1e-9), and every tails call whose results
    differ witnessed by the JAX package's own tails under a perturbation
    of their inputs as large (ROADMAP.md §3). A VC row, or a gene-level
    row combined from them (_is_vc), may then differ from the JAX
    package's, or be on one side only, in a witnessed set only; and then
    the JAX CLI run again on the port's tail inputs (pair.replay) must
    give the port's tails results bit for bit and its .regenie files: the
    same rows in the same order within rel 1e-9."""
    from test_torch_step2 import _assert_rows_equiv

    files = sorted(f for f in glob.glob(jx + "*") if not f.endswith(".log"))
    assert files
    verdict = None if pair is None else pair.verdict()
    rows, off = {}, 0
    for f in files:
        sfx = f[len(jx):]
        g = pt + sfx
        assert os.path.exists(g), g
        if ".regenie" in sfx and not sfx.endswith(".Ydict"):
            rows[sfx] = open(g).read().splitlines()
            if pair is None:
                _assert_rows_equiv(f, g)
                continue
            a, b = _split_vc(f), _split_vc(g)
            assert a[0] == b[0], g  # the non-VC rows: the same, in order
            _assert_rows_equiv(a[2], b[2])
            common = [k for k in a[1] if k in b[1]]
            assert common == [k for k in b[1] if k in a[1]], g  # same order
            for k in list(a[1]) + [k for k in b[1] if k not in a[1]]:
                if k in a[1] and k in b[1] and _row_close(a[1][k], b[1][k]):
                    continue
                assert in_sets(k[0], verdict["sets"]), (g, k, verdict["gaps"])
                off += 1
        else:
            assert open(f, "rb").read() == open(g, "rb").read(), sfx
    assert sorted(glob.glob(pt + "*")) == sorted(
        pt + f[len(jx):] for f in glob.glob(jx + "*"))
    assert max(len(r) for r in rows.values()) > min_rows
    if off:
        replay = pair.replay()
        replay_matches(replay, pair.got)
        for sfx in rows:
            _assert_rows_equiv(pair.replay_prefix + sfx, pt + sfx)
    return rows


def _split_vc(path):
    """(row count, {(ID, TEST): row} of the VC rows, the path of a copy of
    the file without them)."""
    lines = open(path).read().splitlines()
    head = [i for i, r in enumerate(lines) if not r.startswith("#")][0]
    cols = lines[head].split()
    ti = cols.index("TEST" if "TEST" in cols else "Model")
    idi = cols.index("ID" if "ID" in cols else "Name")
    keep, vc = [], {}
    for i, r in enumerate(lines):
        t = r.split()
        if i > head and _is_vc(t[ti]):
            vc[(t[idi], t[ti])] = r
        else:
            keep.append(r)
    out = path + ".novc"
    with open(out, "w") as fh:
        fh.write("\n".join(keep) + "\n")
    return len(keep), vc, out


def _row_close(ra, rb, rtol=1e-9):
    ta = ra.replace(";", " ").replace("=", " ").split()
    tb = rb.replace(";", " ").replace("=", " ").split()
    if len(ta) != len(tb):
        return False
    for xa, xb in zip(ta, tb):
        if xa == xb:
            continue
        try:
            fa, fb = float(xa), float(xb)
        except ValueError:
            return False
        if abs(fa - fb) > rtol * max(1.0, abs(fa)):
            return False
    return True


def row_tests(rows):
    """{TEST: count} of the rows of one .regenie file (the Model column of
    an HTP file)."""
    head = [r for r in rows if not r.startswith("#")]
    col = head[0].split().index("TEST" if head[0].startswith("CHROM") else "Model")
    out = {}
    for r in head[1:]:
        t = r.split()[col]
        out[t] = out.get(t, 0) + 1
    return out


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    return gene_inputs(str(tmp_path_factory.mktemp("torch_gene")))


# ---------------------------------------------------------------------------
# readers and masks
# ---------------------------------------------------------------------------


def _params(pkg, **kw):
    if pkg == "jax":
        from regenie_tpu.config import Params
    else:
        from regenie_tpu_torch.config import Params
    p = Params()
    for k, v in kw.items():
        setattr(p, k, v)
    return p


def _snp_index(d):
    ids = [line.split()[1] for line in open(f"{d}/geno.bim")]
    chroms = np.array([int(line.split()[0]) for line in open(f"{d}/geno.bim")])
    return {v: i for i, v in enumerate(ids)}, chroms


@pytest.mark.parametrize("case", ["plain", "extract", "exclude", "lists",
                                  "chr_filter", "no_build"])
def test_readers_match_jax(dirs, case, tmp_path):
    """read_anno_labels, read_annotations (3- and 4-column, --weights-col),
    read_mask_defs (an unknown category warned and dropped), read_setlist
    under each set filter, read_aaf_file (plain, with singletons, PLINK
    --freq form): the same values from both packages."""
    from regenie_tpu.io import setfiles as js
    from regenie_tpu_torch.io import setfiles as ts

    d, dom = dirs["bed"], dirs["dom"]
    idx, chroms = _snp_index(d)
    kw = dict(build_mask=case != "no_build", n_chrom=23)
    if case == "extract":
        kw["extract_sets"] = f"{d}/set_ids.txt"
    elif case == "exclude":
        kw["exclude_sets"] = f"{d}/set_ids.txt"
    elif case == "lists":
        kw.update(extract_setlist=["G1", "G4", "G7", "G19"], exclude_setlist=["G4"])
    chr_filter = {2} if case == "chr_filter" else None
    masks = tmp_path / "masks.txt"
    masks.write_text(open(f"{d}/masks.txt").read() + "M4 LoF,nonsense\n")
    weights = tmp_path / "anno_w.txt"
    weights.write_text("".join(
        f"{line.rstrip()} {0.1 * (i % 7):.1f}\n"
        for i, line in enumerate(open(f"{d}/anno.txt"))))
    labels = tmp_path / "labels.txt"
    labels.write_text("0 NULL\n1 LoF\n2 missense\n3 synonymous\n")
    got = []
    for mod, pkg in ((js, "jax"), (ts, "port")):
        params = _params(pkg, **kw)
        logs = []
        out = {}
        for name, path, wcol in (("3", f"{d}/anno.txt", 0), ("4", f"{dom}/anno.txt", 0),
                                 ("w", str(weights), 4)):
            anno, cat_bit, wd, doms, rn = mod.read_annotations(path, dict(idx), None,
                                                               weight_col=wcol)
            out[name] = (anno, cat_bit, wd, doms, rn,
                         dict(mod.read_annotations.set_weights))
        anno, cat_bit = out["3"][0], out["3"][1]
        mdefs = mod.read_mask_defs(str(masks), cat_bit, logs.append)
        all_bits = 0
        for m in mdefs:
            all_bits |= m.bits
        sets = mod.read_setlist(params, f"{d}/sets.txt", idx, chroms, dict(anno),
                                all_bits, chr_filter, logs.append)
        aaf = [mod.read_aaf_file(f"{d}/aaf.txt", idx, len(idx), w) for w in (False,)]
        freq = tmp_path / "freq.txt"
        freq.write_text("#CHROM\tID\tREF\tALT\tALT_FREQS\n"
                        + "".join(f"1\tv{j}\tA\tC\t{0.001 * j:.4f}\n" for j in range(0, 50, 3)))
        aaf.append(mod.read_aaf_file(str(freq), idx, len(idx), False))
        sing = tmp_path / "sing.txt"
        sing.write_text("".join(f"v{j} 0.01 {j % 2}\n" for j in range(30)))
        aaf.append(mod.read_aaf_file(str(sing), idx, len(idx), True))
        got.append((out, [vars(m) for m in mdefs],
                    [(s.ID, s.chrom, s.physpos, s.snp_indices) for s in sets],
                    aaf, logs, mod.read_anno_labels(str(labels))))
    (jo, jm, jsets, jaaf, jlog, jlab), (po, pm, psets, paaf, plog, plab) = got
    assert jo == po and jm == pm and jsets == psets and jlog == plog
    assert jlab == plab
    assert len(psets) > 0 and any("unknown" in m for m in plog)
    for (a1, s1), (a2, s2) in zip(jaaf, paaf):
        np.testing.assert_array_equal(a1, a2)
        if s1 is None:
            assert s2 is None
        else:
            np.testing.assert_array_equal(s1, s2)
    assert po["4"][2] and not po["3"][2] and po["w"][5]


def _mask_inputs(seed, M=30, n=400):
    rng = np.random.default_rng(seed)
    af = np.exp(rng.uniform(np.log(1 / n), np.log(0.3), size=M))
    G = (rng.random((M, n)) < af[:, None]).astype(np.int8) + (
        rng.random((M, n)) < af[:, None]).astype(np.int8)
    G[rng.random((M, n)) < 0.03] = -3
    G[3] = 0  # monomorphic
    ind = rng.random(n) > 0.02
    masked = (rng.random((n, P)) > 0.1) & ind[:, None]
    Gf = G.astype(np.float64)
    ok = (G >= 0) & ind[None, :]
    total = np.where(ok, Gf, 0).sum(1)
    ns = ok.sum(1)
    mac1 = np.minimum(total, 2 * ns - total)
    af1 = total / (2.0 * ns)
    anno = np.array([1 << int(c) for c in rng.integers(1, 4, size=M)], np.uint64)
    region = rng.integers(1, 4, size=M).astype(np.uint64)
    return Gf, af1, mac1, mac1 < 0.5, anno, region, masked, ind


@pytest.mark.parametrize("rule", ["max", "sum", "comphet"])
@pytest.mark.parametrize("variant", ["plain", "custom", "domains", "spa_dom",
                                     "carrier"])
def test_build_masks_match_jax(rule, variant):
    """build_masks_for_set under each --build-mask rule, with --aaf-file
    frequencies and --set-singletons flags, with domain masks, with --spa
    and a dominant test (the flip and the coding), with
    --singleton-carrier: the same masks, arrays equal; build_lovo_masks
    on each bin: the same."""
    from regenie_tpu.io.setfiles import MaskDef as JMaskDef
    from regenie_tpu.io.setfiles import VariantSet as JSet
    from regenie_tpu.models import masks as jm
    from regenie_tpu_torch.io.setfiles import MaskDef as TMaskDef
    from regenie_tpu_torch.io.setfiles import VariantSet as TSet
    from regenie_tpu_torch.models import masks as tm

    G, af1, mac1, ign, anno, region, masked, ind = _mask_inputs(
        10 * ("max", "sum", "comphet").index(rule) + len(variant))
    M = G.shape[0]
    kw = dict(mask_rule=rule, vc_tests=["skat"], vc_maxAAF=0.05,
              aaf_bins=["0.01", "0.1"], min_mac_mask=0.5,
              singleton_carriers=variant == "carrier")
    if variant == "spa_dom":
        kw.update(use_spa=True, test_type=1)
    rng = np.random.default_rng(5)
    aaf_custom = np.where(rng.random(M) < 0.5, rng.uniform(0, 0.2, M), af1)
    sing = rng.random(M) < 0.2
    outs = []
    for pkg, MD, VS, mod in (("jax", JMaskDef, JSet, jm), ("port", TMaskDef, TSet, tm)):
        params = _params(pkg, **kw)
        vset = VS(ID="S1", chrom=1, physpos=100, snp_indices=list(range(M)))
        defs = [MD("M1", 2), MD("M2", 6), MD("M3", 14)]
        extra = {}
        if variant == "custom":
            extra = dict(aaf_custom=aaf_custom, singleton_custom=sing)
        elif variant in ("domains", "spa_dom"):
            defs = ([MD(m.name, m.bits, f"D{k + 1}.", 1 << k) for m in defs
                     for k in range(2)] + [MD(m.name, m.bits, "", 3) for m in defs])
            extra = dict(region_bits=region)
        aafs = mod.aaf_bin_values(params)
        built, _ = mod.build_masks_for_set(params, vset, G, af1, mac1, ign, anno,
                                           defs, aafs, masked, ind, **extra)
        lovo = [mod.build_lovo_masks(params, vset, G, af1, mac1, ign, anno,
                                     defs[1], b, [f"v{j}" for j in range(M)],
                                     masked, ind)
                for b in ("singleton", "0.01", "all")]
        outs.append((built, lovo))
    (jb, jl), (tb, tl) = outs
    assert len(tb) > 4

    def same(a, b):
        for f in ("chrom", "ID", "physpos", "allele1", "allele2"):
            assert getattr(a.snp, f) == getattr(b.snp, f), f
        for f in ("mask_name", "bin_name", "af1", "flipped", "vc_col", "in_vc_bin"):
            assert getattr(a, f) == getattr(b, f), f
        for f in ("G", "af_t", "ns_t", "mac_t", "ignored_trait", "raw_vec", "sel_idx"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))

    assert len(jb) == len(tb)
    for a, b in zip(jb, tb):
        same(a, b)
    for la, lb in zip(jl, tl):
        assert len(la) == len(lb)
        for a, b in zip(la, lb):
            same(a, b)
    assert sum(len(x) for x in tl) > 3


# ---------------------------------------------------------------------------
# tails, ACAT, products, writers
# ---------------------------------------------------------------------------


def test_quadforms_and_acat_match_jax():
    """Davies (scalar, batch, the shared-h grid), Kuonen (scalar, batch),
    Liu, the chained chisq_mix_pv / chisq_mix_logp(_batch), get_acat and
    get_acat_rows (every branch of the robust ladder): within 1e-12."""
    from regenie_tpu.models import skat as jsk
    from regenie_tpu.utils import quadforms as jq
    from regenie_tpu_torch.models import skat as tsk
    from regenie_tpu_torch.utils import quadforms as tq

    rng = np.random.default_rng(3)

    def close(a, b):
        np.testing.assert_allclose(np.asarray(b, np.float64), np.asarray(a, np.float64),
                                   rtol=1e-12, atol=1e-300)

    for m in (2, 5, 17):
        lam = np.sort(rng.gamma(0.5, 2.0, size=m))[::-1]
        qs = np.concatenate([rng.uniform(0.1, 3, 4) * lam.sum(),
                             [80 * lam.sum(), 300 * lam.sum()]])
        for q in qs:
            close(jq.davies_pv(q, lam), tq.davies_pv(q, lam))
            close(jq.kuonen_pv(q, lam), tq.kuonen_pv(q, lam))
            close(jq.liu_logp(q, lam), tq.liu_logp(q, lam))
            close(jq.chisq_mix_pv(q, lam), tq.chisq_mix_pv(q, lam))
            close(jq.chisq_mix_logp(q, lam), tq.chisq_mix_logp(q, lam))
        close(jq.davies_pv_batch(qs, lam), tq.davies_pv_batch(qs, lam))
        close(jq.kuonen_pv_batch(qs, lam), tq.kuonen_pv_batch(qs, lam))
        close(jq.chisq_mix_logp_batch(qs, lam), tq.chisq_mix_logp_batch(qs, lam))
        close(jq.chisq_mix_sf_grid(qs / lam.max(), np.sort(lam) / lam.max()),
              tq.chisq_mix_sf_grid(qs / lam.max(), np.sort(lam) / lam.max()))
        close(jq.liu_params(lam), tq.liu_params(lam))
    rows = np.array([[0.5, 2.0, 17.0], [20.0, 30.0, -1.0], [1e-3, 0.2, 0.7],
                     [-1.0, -1.0, -1.0], [3.0, -1.0, -1.0], [16.0, 0.01, 0.02]])
    w = np.array([0.5, 1.0, 2.0])
    for r in rows:
        close(jsk.get_acat(r), tsk.get_acat(r))
        close(jsk.get_acat(r, w), tsk.get_acat(r, w))
    close(jsk.get_acat_rows(rows, w), tsk.get_acat_rows(rows, w))


def _vc_sets(rng, S, n):
    """S sets' packed codes, ultra-rare columns and weights."""
    from regenie_tpu_torch.io.bed import encode_bed_bytes

    out = []
    for s in range(S):
        m = int(rng.integers(1, 20))
        G = rng.integers(0, 3, size=(m, n)).astype(np.int8)
        G[rng.random((m, n)) < 0.05] = -3
        u = int(rng.integers(0, 3))
        out.append((encode_bed_bytes(G), rng.random((n, u)) * (rng.random((n, u)) < 0.02),
                    rng.random(m) < 0.3, rng.uniform(0, 0.5, m), rng.uniform(0.1, 20, m)))
    return out


def test_bucket_products_match_jax_and_are_bucket_invariant():
    """ops/vc_batch.bucket_products in torch float64 on the CPU against
    the JAX package's (x64) on the same sets, over two sample chunks:
    rel 1e-12 of the product of the absolute values; a set's products are
    byte for byte the same whether its call holds 1, 2 or 32 sets."""
    from regenie_tpu.ops import vc_batch as jvb
    from regenie_tpu_torch.ops import vc_batch as tvb

    n = 9000  # two chunks of 8,192 samples
    rng = np.random.default_rng(7)
    X = np.linalg.qr(rng.normal(size=(n, K)))[0]
    ind = rng.random(n) > 0.03
    Y = rng.normal(size=(n, P)) * ind[:, None]
    sets = _vc_sets(rng, 32, n)
    # one equal-pad group: pad every set to the widest slot
    m_pad = tvb._pad_dim(max(s[0].shape[0] for s in sets))
    group = [s for s in sets if tvb._pad_dim(s[0].shape[0]) == m_pad]
    assert len(group) >= 2
    jc = jvb.VCDeviceCache(X, ind)
    jc.set_residuals(1, Y, X)
    tc = tvb.VCDeviceCache(X, ind, "cpu")
    tc.set_residuals(1, Y, X)
    cols = list(zip(*group))
    want = jvb.bucket_products(jc, *cols)
    got = tvb.bucket_products(tc, *cols)
    for (g1, x1, y1), (g2, x2, y2), st in zip(want, got, group):
        codes, ur, flip, imp, w = st
        from regenie_tpu_torch.io.bed import decode_bed_bytes

        Gd = decode_bed_bytes(codes, n).astype(np.float64)
        Gd = np.where((Gd == -3), imp[:, None], np.where(flip[:, None], 2 - Gd, Gd))
        GW = np.concatenate([(Gd * ind * w[:, None]).T, ur], axis=1)
        A = np.abs(GW)
        for a, b, scale in ((g1, g2, A.T @ A), (x1, x2, A.T @ np.abs(X)),
                            (y1, y2, A.T @ np.abs(Y))):
            assert a.shape == b.shape
            assert (np.abs(a - b) <= 1e-12 * scale + 1e-300).all()
        np.testing.assert_allclose(g2, GW.T @ GW, rtol=1e-9, atol=1e-9)
    # the same set in calls of 1, 2 and 32 sets: the same bytes
    for k in (1, 2, len(group)):
        part = tvb.bucket_products(tc, *[c[:k] for c in cols])
        for a, b in zip(part, got):
            for x, y in zip(a, b):
                assert x.tobytes() == y.tobytes()
    single = tvb.bucket_products(tc, *[c[-1:] for c in cols])
    for x, y in zip(single[0], got[-1]):
        assert x.tobytes() == y.tobytes()


def test_encode_bed_and_ld_writers_match_jax(tmp_path):
    """encode_bed_bytes (the inverse of decode_bed_bytes), the BGZF
    writer and the remeta LD matrix writer (sparse and dense records):
    the same bytes as the JAX package's."""
    from regenie_tpu.io import bed as jbed
    from regenie_tpu.io import remeta as jre
    from regenie_tpu_torch.io import bed as tbed
    from regenie_tpu_torch.io import remeta as tre

    rng = np.random.default_rng(1)
    G = rng.choice(np.array([0, 1, 2, -3], np.int8), size=(7, 37))
    enc = tbed.encode_bed_bytes(G)
    assert enc.tobytes() == jbed.encode_bed_bytes(G).tobytes()
    np.testing.assert_array_equal(tbed.decode_bed_bytes(enc, 37), G)
    A = rng.normal(size=(6, 6))
    Kmat = A @ A.T
    for mod, tag in ((jre, "j"), (tre, "t")):
        w = mod.RegenieLDMatrixWriter(str(tmp_path / tag), 800)
        for g in range(300):  # past one 64 KB BGZF block
            w.write_matrix_sparse(Kmat, f"G{g}", [f"v{j}" for j in range(6)], 0.1)
            w.write_matrix_dense(Kmat * (g + 1), f"H{g}", [f"v{j}" for j in range(6)])
        w.close()
    for sfx in (".rg.ld", ".rg.ld.idx.gz"):
        a = (tmp_path / f"j{sfx}").read_bytes()
        assert a == (tmp_path / f"t{sfx}").read_bytes() and len(a) > 1000


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_vc_products_on_card_match_cpu(cuda):
    """bucket_products on the card against the CPU (float64 torch both):
    within 1e-12 of the products taken on absolute values
    (chip_smoke.F64_SUM_BAR); and on the card a set's products are the
    same bytes whether its call holds 1, 2 or all its group's sets."""
    from regenie_tpu_torch.io.bed import decode_bed_bytes
    from regenie_tpu_torch.ops import vc_batch as tvb

    n = 20000  # three chunks of 8,192 samples
    rng = np.random.default_rng(9)
    X = np.linalg.qr(rng.normal(size=(n, K)))[0]
    ind = rng.random(n) > 0.03
    Y = rng.normal(size=(n, 5)) * ind[:, None]
    sets = _vc_sets(rng, 40, n)
    m_pad = tvb._pad_dim(max(s[0].shape[0] for s in sets))
    cols = list(zip(*[s for s in sets if tvb._pad_dim(s[0].shape[0]) == m_pad]))
    caches = {}
    for dev in ("cpu", cuda):
        c = tvb.VCDeviceCache(X, ind, dev)
        c.set_residuals(1, Y, X)
        caches[str(dev)] = c
    got = tvb.bucket_products(caches["cuda"], *cols)
    want = tvb.bucket_products(caches["cpu"], *cols)
    for (g, x, y), (g2, x2, y2), *st in zip(got, want, *cols):
        codes, ur, flip, imp, w = st
        Gd = decode_bed_bytes(codes, n).astype(np.float64)
        Gd = np.where(Gd == -3, imp[:, None], np.where(flip[:, None], 2 - Gd, Gd))
        A = np.abs(np.concatenate([(Gd * ind * w[:, None]).T, ur], axis=1))
        for a, b, bar in ((g, g2, A.T @ A), (x, x2, A.T @ np.abs(X)),
                          (y, y2, A.T @ np.abs(Y))):
            assert (np.abs(a - b) <= 1e-12 * bar + 1e-300).all()
    for k in (1, 2):
        for a, b in zip(tvb.bucket_products(caches["cuda"], *[c[:k] for c in cols]), got):
            assert all(x.tobytes() == y.tobytes() for x, y in zip(a, b))


def test_skato_gate_of_a_single_variant_mask_follows_rounding():
    """The open fault of ROADMAP.md §3 in the reference itself: for a mask
    of one variant, _skato_tests' variance vq is 0 in exact arithmetic and
    its sign, which decides whether the SKATO family's rows are written,
    is left to rounding. Of 200 seeded kernels K, some give other tests
    at K and at the next float up; the port's _skato_tests gives the JAX
    package's results bit for bit at each."""
    from regenie_tpu.models import skat as jsk
    from regenie_tpu_torch.models import skat as tsk

    params = _params("torch", vc_tests=["skato-acat"], n_pheno=2)
    Sm = np.array([[3.1], [-20.5]])
    flips = 0
    with np.errstate(invalid="ignore", divide="ignore"):
        for k0 in np.random.default_rng(0).uniform(100, 5000, 200):
            keys = []
            for k in (k0, np.nextafter(k0, np.inf)):
                got, want = {}, {}
                for mod, res in ((tsk, got), (jsk, want)):
                    mod._skato_tests(params, res, Sm, np.array([[k]]), tsk.DEFAULT_RHO,
                                     1, 2, False, False, True, False, None)
                assert got.keys() == want.keys()
                assert all(np.array_equal(got[t], want[t]) for t in got)
                keys.append(sorted(got))
            flips += keys[0] != keys[1]
    assert flips >= 5


@pytest.mark.parametrize("seed", [4, 5])
def test_firth_and_spa_auto_match_jax(seed, monkeypatch):
    """firth_snp_batch_auto (on the CPU the host twin) and spa_batch_auto,
    which the BT VC tests call, against the JAX package's on the same
    rows (two seeded draws, a monomorphic and a near-separated row among
    them): within 1e-9, the same convergence and failure flags."""
    from regenie_tpu.models import firth as jf
    from regenie_tpu.models import spa as js
    from regenie_tpu_torch.models import firth as tf
    from regenie_tpu_torch.models import spa as ts

    monkeypatch.setenv("REGENIE_TPU_DEVICE_CORR", "0")
    rng = np.random.default_rng(seed)
    n, S = 600, 9
    mask = rng.random(n) > 0.05
    offset = rng.normal(-1.5, 0.5, n)
    y = (rng.random(n) < 1 / (1 + np.exp(-offset))).astype(np.float64)
    G = rng.normal(size=(S, n)) * (rng.random((S, n)) < 0.1)
    G[0] = 0.0  # monomorphic
    G[1, :] = np.where(y > 0, 3.0, 0.0) * (rng.random(n) < 0.3)  # near separation
    kw = dict(maxstep=5, niter=250, tol=2.5e-4)
    want = jf.firth_snp_batch_auto(y, G, offset, mask, **kw)
    got = tf.firth_snp_batch_auto(y, G, offset, mask, device="cpu", **kw)
    np.testing.assert_array_equal(got[3], want[3])
    ok = want[3]
    assert ok.sum() >= 5
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_allclose(a[ok], b[ok], rtol=1e-9, atol=1e-12)
    phat = 1 / (1 + np.exp(-offset))
    gs = np.sqrt(phat * (1 - phat))
    Gres = G[2:] * gs[None, :]
    denum = (Gres**2 * mask).sum(axis=1)
    stats = (Gres * (y - phat) / gs * mask).sum(axis=1) / np.sqrt(denum)
    want = js.spa_batch_auto(stats, denum, Gres, phat, gs, mask, tol=5e-5,
                             niter_max=1000)
    got = ts.spa_batch_auto(stats, denum, Gres, phat, gs, mask, device="cpu",
                            tol=5e-5, niter_max=1000)
    np.testing.assert_array_equal(got[2], want[2])
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-12)
