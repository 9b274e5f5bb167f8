"""Tests of the port's chrX path in Step 2 QT (hemizygous males under the
default dosage compensation): the male tail of the fused operand and
the hemizygous stat algebra against the JAX package, the narrow BGEN
Wq offset behind the tail, and the CLI on chrX BED and BGEN against
`REGENIE_TPU_FUSED=1 python -m regenie_tpu` on the CPU (both in this
process), with positions across PAR1, non-PAR and PAR2, mixed sexes,
incomplete traits and --remove. With marker `cuda`, the same CLI runs
on the card against the CPU, and fused_i8 / bgen_i8 at an operand width
that the tail takes past a 128-column tile. On the GPU machine, which
has no JAX, run the card's tests with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_chrx.py
"""

import numpy as np
import pytest
import torch

from chip_smoke import (PAR1_MAX, PAR2_MIN, chrx_positions, write_bgen_dataset,
                        write_dataset)
from regenie_tpu_torch.ops import fused_score as tfs
from regenie_tpu_torch.ops import kernels


@pytest.fixture(scope="module")
def jfs():
    pytest.importorskip("jax")
    from regenie_tpu.ops import fused_score

    return fused_score


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _inputs(seed, N=517, P=3, K=4):
    """Per-sample inputs with excluded samples, incomplete traits and
    about half the samples male."""
    rng = np.random.default_rng(seed)
    ind = rng.random(N) > 0.1
    res = rng.normal(size=(N, P)) * ind[:, None]
    maskf = (rng.random(size=(N, P)) > 0.08) * ind[:, None].astype(np.float64)
    cov = np.linalg.qr(rng.normal(size=(N, K)) * ind[:, None])[0]
    male = (rng.random(N) < 0.5).astype(np.float64)
    return cov, res, maskf, ind, float(ind.sum() - K), male


# ---------------------------------------------------------------------------
# the operand's male tail and the stat algebra against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pack", ["plane", "sample"])
@pytest.mark.parametrize("split", [False, "i8"])
def test_build_consts_male_matches_jax(jfs, pack, split):
    """build_consts(male=...): the operand with the tail [male*ind |
    maskf*male] (values, or int8 limbs and scales), usum, covt_res,
    Mmat, inc, has_male and layout_C equal the JAX package's."""
    cov, res, maskf, ind, sden, male = _inputs(1)
    pc = tfs.build_consts(cov, res, maskf, ind, sden, split=split, pack=pack,
                          male=male)
    jc = jfs.build_consts(cov, res, maskf, ind, sden, dtype=np.float64,
                          split=split, pack=pack, male=male)
    assert pc.has_male and jc.has_male
    assert pc.inc == jc.inc and pc.layout_C() == jc.layout_C()
    assert pc.layout_C() == 4 + 3 + 4 * len(pc.inc) + 3 + 1 + 3 + 1
    if split == "i8":
        np.testing.assert_array_equal(_np(pc.Wp.limbs), np.asarray(jc.Wp.limbs))
        np.testing.assert_array_equal(_np(pc.Wp.scale), np.asarray(jc.Wp.scale))
    else:
        np.testing.assert_array_equal(_np(pc.Wp), np.asarray(jc.Wp))
    for name in ("usum", "covt_res", "Mmat"):
        np.testing.assert_array_equal(_np(getattr(pc, name)),
                                      np.asarray(getattr(jc, name)))
    # the tail's columns hold male*ind and maskf*male
    C0 = pc.layout_C() - 4
    W = _np(pc.Wp) if split is False else None
    if W is not None and pack == "sample":
        np.testing.assert_array_equal(W[:517, C0], male * ind)
        np.testing.assert_array_equal(W[:517, C0 + 1 : C0 + 4],
                                      maskf * ind[:, None] * male[:, None])
    carried = tfs.consts_from_numpy(
        **(dict(limbs=np.asarray(jc.Wp.limbs), scale=np.asarray(jc.Wp.scale))
           if split == "i8" else dict(Wp=np.asarray(jc.Wp))),
        usum=np.asarray(jc.usum), covt_res=np.asarray(jc.covt_res),
        Mmat=np.asarray(jc.Mmat), n_ind=jc.n_ind, K=jc.K, P=jc.P,
        scale_denom=jc.scale_denom, split=jc.split, inc=jc.inc,
        has_male=jc.has_male)
    assert carried.has_male and carried.layout_C() == jc.layout_C()


@pytest.mark.parametrize("with_classes", [True, False])
def test_hemizygous_adjust_matches_jax(with_classes):
    """_hemizygous_adjust: the hemizygous MAC of non-PAR rows (and the
    class counts) equal the JAX package's on the same product columns;
    PAR rows keep their diploid MAC."""
    pytest.importorskip("jax")
    from regenie_tpu.run_step2 import Step2Engine as JEngine

    from regenie_tpu_torch.run_step2 import Step2Engine

    rng = np.random.default_rng(4)
    B, C, P = 40, 30, 3
    S1, SQ, SM = (rng.integers(0, 300, (B, C)).astype(np.float64) for _ in range(3))
    usum = rng.integers(300, 600, C).astype(np.float64)
    npb = rng.random(B) < 0.6
    total1, ns1 = S1[:, 10], 500.0 - SM[:, 10]
    mac1 = np.minimum(total1, 2 * ns1 - total1)
    total_t, ns_t = S1[:, 7:10], 480.0 - SM[:, 7:10]
    mac_t = np.minimum(total_t, 2 * ns_t - total_t)
    args = (npb, S1, SQ, SM, usum, C - 1 - P, slice(C - P, C), total1, ns1,
            mac1, total_t, ns_t, mac_t, with_classes)
    got = Step2Engine._hemizygous_adjust(*args)
    want = JEngine._hemizygous_adjust(*args)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[0][~npb], mac1[~npb])
    assert not np.array_equal(got[0][npb], mac1[npb])


@pytest.mark.parametrize("operand", ["i8", "f32"])
def test_bgen_narrow_wq_starts_before_male_tail(operand):
    """With the male tail, make_qt_bgen_fn's narrow Wq covers [maskf |
    ind], P + 1 columns BEFORE the tail: the block function on the narrow
    Wq gives the same scores, and the same SQ over [maskf | ind], as on
    the full-width operand (no Wq: SQ against Wp), whose SQ columns are
    all computed.
    A Wq read at the tail's offset would score the incomplete traits'
    denominators against the male columns."""
    from test_torch_bgen import _mk_case

    c = _mk_case(5, P=4)
    N = c["ind"].shape[0]
    male = (np.arange(N) % 2).astype(np.float64)
    dt = torch.float32 if operand == "f32" else torch.float64
    split = "i8" if operand == "i8" else False
    pc = tfs.build_consts(c["cov"], c["res"], c["maskf"], c["ind"], c["sden"],
                          split=split, pack="sample", op_dtype=dt, male=male)
    assert pc.inc  # incomplete traits, whose denominators read SQ
    indz = c["ind"].astype(np.float64)[:, None]
    Wq, _ = tfs.sample_pack(np.concatenate([c["maskf"] * indz, indz], axis=1),
                            split, dtype=dt)
    planes = torch.from_numpy(c["planes"])
    narrow = tfs.make_qt_bgen_fn(pc._replace(Wq=Wq), True)(planes)
    full = tfs.make_qt_bgen_fn(pc._replace(Wq=None), True)(planes)
    C = pc.layout_C()
    qs = C - 2 * (c["P"] + 1)
    for g, w in zip(narrow[:4], full[:4]):
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(_np(narrow[5][:, qs : qs + c["P"] + 1]),
                               _np(full[5][:, qs : qs + c["P"] + 1]),
                               rtol=1e-12, atol=1e-9)


# ---------------------------------------------------------------------------
# the CLI on chrX against the JAX package
# ---------------------------------------------------------------------------

CHROMS = ((1, 100), ("X", 120))
POS = {"X": chrx_positions(120, 15, 15)}


def _write(d, src):
    kw = dict(seed=21, N=480, chroms=CHROMS, P=3, n_inc=1, n_cov=3,
              na_rate=0.1, n_remove=9, effect_sd=0.5, positions=POS)
    if src == "bed":
        return ["--bed", write_dataset(d, **kw)]
    return ["--bgen", write_bgen_dataset(d, **kw), "--sample", f"{d}/geno.sample"]


def _runs(d, argv, monkeypatch, scenario):
    """The JAX package's fused path and the port, both on the CPU in
    this process; returns the two output prefixes."""
    from regenie_tpu import cli as jcli

    from regenie_tpu_torch import cli
    from regenie_tpu_torch.utils.device import DEVICE_ENV

    monkeypatch.setenv("REGENIE_TPU_FUSED", "1")
    monkeypatch.setenv("REGENIE_TPU_PLATFORM", "cpu")
    monkeypatch.setenv(DEVICE_ENV, "cpu")
    jx, pt = f"{d}/jax_{scenario}", f"{d}/pt_{scenario}"
    jcli.main(argv + ["--out", jx])
    assert "fused packed-bytes scorer active" in open(f"{jx}.log").read()
    cli.main(argv + ["--out", pt])
    return jx, pt


@pytest.fixture(scope="module")
def chrx_dataset(tmp_path_factory):
    """A maker of the chrX datasets by source, each written once, with
    LOCO predictions from the JAX Step 1 (its .loco files carry row 23):
    src -> (directory, genotype arguments)."""
    pytest.importorskip("jax")
    from regenie_tpu import cli as jcli

    made = {}

    def get(src):
        if src not in made:
            d = str(tmp_path_factory.mktemp(f"torch_chrx_{src}"))
            geno = _write(d, src)
            mp = pytest.MonkeyPatch()
            mp.setenv("REGENIE_TPU_PLATFORM", "cpu")
            try:
                jcli.main(["--step", "1", *geno, "--phenoFile", f"{d}/pheno.txt",
                           "--covarFile", f"{d}/covar.txt", "--remove",
                           f"{d}/remove.txt", "--bsize", "50", "--out", f"{d}/fit"])
            finally:
                mp.undo()
            made[src] = (d, geno)
        return made[src]

    return get


SCENARIOS = {"plain": ["--ignore-pred"],
             "htp": ["--ignore-pred", "--htp", "X"],
             "minmac": ["--ignore-pred", "--minMAC", "30"],
             "pred": ["--pred", "{d}/fit_pred.list"],
             "ref_first": ["--ignore-pred", "--ref-first"]}


@pytest.mark.parametrize("src,scenario", [
    *(("bed", s) for s in sorted(SCENARIOS)),
    # --htp on BGEN runs on the JAX package's dense path, not ported
    *(("bgen", s) for s in sorted(SCENARIOS) if s != "htp")])
def test_cli_chrx_matches_jax(chrx_dataset, src, scenario, monkeypatch):
    """chrX BED and BGEN runs (PAR1, non-PAR and PAR2 positions, males
    and females, an incomplete trait, --remove) write what the JAX
    package's fused path writes on the CPU: same header, row count and
    NA pattern, every numeric field within rel 1e-9 (HTP's MAC and
    genotype counts included)."""
    from test_torch_step2 import _assert_rows_equiv

    d, geno = chrx_dataset(src)
    extra = [a.format(d=d) for a in SCENARIOS[scenario]]
    argv = ["--step", "2", *geno, "--phenoFile", f"{d}/pheno.txt",
            "--covarFile", f"{d}/covar.txt", "--remove", f"{d}/remove.txt",
            "--bsize", "64", *extra]
    jx, pt = _runs(d, argv, monkeypatch, scenario)
    for ph in ("Y1", "Y2", "Y3"):
        _assert_rows_equiv(f"{jx}_{ph}.regenie", f"{pt}_{ph}.regenie")
    sep, ic, ip = ("\t", 1, 2) if scenario == "htp" else (" ", 0, 1)
    rows = [r.split(sep) for r in open(f"{pt}_Y1.regenie").read().splitlines()[1:]]
    pos = [int(r[ip]) for r in rows if r[ic] == "23"]
    assert any(p <= PAR1_MAX for p in pos) and any(p >= PAR2_MIN for p in pos)
    assert sum(PAR1_MAX < p < PAR2_MIN for p in pos) > 50


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("src", ["bed", "bgen"])
def test_cli_chrx_on_card_matches_cpu(cuda, src, tmp_path, monkeypatch):
    """The chrX CLI on the card (fused_i8 / bgen_i8 with the male tail)
    against the CPU: the same rows, LOG10P within 1e-5 and every other
    number within 1e-6 beyond the half-unit of the six significant digits
    the files print (chip_smoke's cross-check bar; the int8 operand's
    quantization)."""
    from chip_smoke import _compare_files

    from regenie_tpu_torch import cli
    from regenie_tpu_torch.utils.device import DEVICE_ENV

    d = str(tmp_path)
    argv = ["--step", "2", *_write(d, src), "--phenoFile", f"{d}/pheno.txt",
            "--covarFile", f"{d}/covar.txt", "--remove", f"{d}/remove.txt",
            "--bsize", "64", "--ignore-pred"]
    kernel = kernels.fused_i8_products if src == "bed" else kernels.bgen_i8_products
    n0 = kernel.launches
    monkeypatch.delenv(DEVICE_ENV, raising=False)
    cli.main(argv + ["--out", f"{d}/card"])
    assert kernel.launches == n0 + 4  # 2 blocks on each chromosome
    monkeypatch.setenv(DEVICE_ENV, "cpu")
    cli.main(argv + ["--out", f"{d}/cpu"])
    for p in (1, 2, 3):
        assert _compare_files(f"{d}/card_Y{p}.regenie", f"{d}/cpu_Y{p}.regenie") <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("pack", ["plane", "sample"])
def test_kernels_with_male_tail_past_a_tile(cuda, pack):
    """K = 20, P = 50 of which 11 incomplete: 392 used columns with the
    male tail (341 without), so Cp = 512 and fused_i8 / bgen_i8 run a
    fourth column tile. The block function through the kernel against
    the plain products on the same int8 operand, on the card: the raw
    product columns equal (integer products folded in float64), and the
    scores within 1e-9."""
    rng = np.random.default_rng(12)
    N, K, P, B = 3000, 20, 50, 200
    ind = rng.random(N) > 0.05
    cov = np.linalg.qr(rng.normal(size=(N, K)) * ind[:, None])[0]
    res = rng.normal(size=(N, P)) * ind[:, None]
    maskf = np.ones((N, P)) * ind[:, None]
    maskf[:, :11] *= rng.random((N, 11)) > 0.05
    male = (np.arange(N) % 2).astype(np.float64)
    pc = tfs.build_consts(cov, res, maskf, ind, float(ind.sum() - K),
                          device=cuda, split="i8", pack=pack, male=male)
    assert pc.layout_C() == 392 and pc.Wp.scale.shape[0] == 512
    if pack == "plane":
        nb = (N + 3) // 4
        raw = torch.from_numpy(rng.integers(0, 256, (B, tfs.op_nbp(pc.Wp)),
                                            dtype=np.uint8)).to(cuda)
        raw[:, nb:] = 0
        kernel = kernels.fused_i8_products
        n0 = kernel.launches
        got = tfs.make_qt_block_fn(pc, True)(raw)
        want = tfs.make_qt_block_fn(pc, False)(raw)
    else:
        indz = ind.astype(np.float64)[:, None]
        Wq, _ = tfs.sample_pack(np.concatenate([maskf * indz, indz], axis=1),
                                "i8", cuda)
        pc = pc._replace(Wq=Wq)
        Np = tfs.op_nbp(pc.Wp)
        k0 = rng.integers(0, 200, (B, N))
        k1 = np.minimum(rng.integers(0, 200, (B, N)), 255 - k0)
        planes = np.zeros((B, 2, Np), np.uint8)
        planes[:, 0, :N], planes[:, 1, :N] = k0, k1
        planes = torch.from_numpy(planes).to(cuda)
        kernel = kernels.bgen_i8_products
        n0 = kernel.launches
        got = tfs.make_qt_bgen_fn(pc, True)(planes)
        want = tfs.make_qt_bgen_fn(pc, False)(planes)
    torch.cuda.synchronize()
    assert kernel.launches == n0 + 1
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_allclose(_np(g).astype(float), _np(w).astype(float),
                                   rtol=1e-9, atol=1e-9)
    for i in range(4, len(got)):
        if pack == "sample" and i == 5:
            continue  # SQ: the narrow Wq covers [maskf | ind] only
        np.testing.assert_allclose(_np(got[i]), _np(want[i]), rtol=1e-12, atol=1e-6)
