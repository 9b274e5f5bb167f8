"""Tests of the port's dense Step-2 QT route (the JAX package's dense path,
regenie_tpu/run_step2.py test_raw_block, in torch): the block functions
of ops/geno_ops.py and models/step2.py and the engine's block_stats and
compute_genocounts against the JAX package's on the same seeded inputs
(within 1e-9, the packing exact); the CLI against `python -m
regenie_tpu` in this process on the CPU, on every route the dense scorer
opens (BED, chrX, BGEN in every layout, bit depth, phase and compression,
PGEN dosage tracks; --htp, --no-split, DOM/REC with --minHOMs,
--skip-dosage-comp, --nocov-approx), each numeric field within rel 1e-9;
the port's dense output against its own fused output; and, with marker
`cuda`, the dense route on the card against the CPU. On the GPU machine,
which has no JAX, run the card's test with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_dense.py
"""

import os

import numpy as np
import pytest
import torch

from chip_smoke import (chrx_positions, write_bgen_dataset, write_dataset,
                        write_pgen_dataset, zstd_compressor)
from regenie_tpu_torch.models import step2 as tm2
from regenie_tpu_torch.ops import geno_ops as tgo

P = 3


@pytest.fixture(scope="module")
def jax_dense():
    """The JAX package's block functions (tests that take them skip where
    JAX is not installed)."""
    pytest.importorskip("jax")
    from regenie_tpu.models import step2 as jm2
    from regenie_tpu.ops import geno_ops as jgo

    return jgo, jm2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, tol=1e-9):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def _block(seed, B=37, N=211, dosages=False):
    """A raw block (int8 hardcalls, or float64 dosages, 5% missing = -3),
    the analysis mask, trait masks, sexes and non-PAR flags."""
    rng = np.random.default_rng(seed)
    if dosages:
        G = rng.uniform(0, 2, (B, N))
        G[:, ::7] = np.round(G[:, ::7])
    else:
        G = rng.integers(0, 3, (B, N)).astype(np.int8)
    G[rng.random((B, N)) < 0.05] = -3
    ind = rng.random(N) > 0.1
    mask = (rng.random((N, P)) > 0.1) & ind[:, None]
    sex = (rng.random(N) < 0.5).astype(np.int32)
    non_par = rng.random(B) < 0.5
    return G, ind, mask, sex, non_par


@pytest.mark.parametrize("dosages", [False, True])
@pytest.mark.parametrize("chrx", [None, "comp", "skip_comp"])
def test_snp_stats_block_matches_jax(jax_dense, dosages, chrx):
    """snp_stats_block on hardcalls and dosages, plain and with the chrX
    non-PAR male rules (default dosage compensation, or
    --skip-dosage-comp), against the JAX package's."""
    jgo, _ = jax_dense
    G, ind, mask, sex, non_par = _block(1, dosages=dosages)
    kw, jkw = {}, {}
    if chrx:
        skip = chrx == "skip_comp"
        kw = dict(non_par=_t(non_par), sex=_t(sex), skip_comp=skip)
        jkw = dict(non_par=non_par, sex=sex, skip_comp=skip)
    got = tgo.snp_stats_block(_t(G), _t(ind), _t(mask), **kw)
    want = jgo.snp_stats_block(G, ind, mask, **jkw)
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k])


def test_pack_hardcalls_and_packed_stats_match_jax(jax_dense):
    """pack_hardcalls equals the JAX package's bytes exactly (N not a
    multiple of 4), decode_bed_packed inverts it, and
    snp_stats_block_packed equals the JAX package's."""
    jgo, _ = jax_dense
    G, ind, mask, sex, non_par = _block(2, N=213)
    raw = tgo.pack_hardcalls(G)
    np.testing.assert_array_equal(raw, jgo.pack_hardcalls(G))
    np.testing.assert_array_equal(tgo.decode_bed_packed(_t(raw), 213).numpy(), G)
    got = tgo.snp_stats_block_packed(_t(raw), 213, _t(ind), _t(mask),
                                     non_par=_t(non_par), sex=_t(sex))
    want = jgo.snp_stats_block_packed(raw, 213, ind, mask, non_par=non_par,
                                      sex=sex)
    for k in want:
        _close(got[k], want[k])


@pytest.mark.parametrize("dosages", [False, True])
def test_finalize_block_step2_matches_jax(jax_dense, dosages):
    jgo, _ = jax_dense
    G, ind, _, _, flip = _block(3, dosages=dosages)
    _close(tgo.finalize_block_step2(_t(G), _t(ind), _t(flip)),
           jgo.finalize_block_step2(G, ind, flip))


def _scoring_case(seed, B=29, N=257, K=4):
    rng = np.random.default_rng(seed)
    ind = rng.random(N) > 0.1
    G = rng.uniform(0, 2, (B, N)) * ind
    G[3] = 0.0  # a monomorphic row: low_var
    cov = np.linalg.qr(rng.normal(size=(N, K)) * ind[:, None])[0]
    maskf = ((rng.random((N, P)) > 0.1) & ind[:, None]).astype(np.float64)
    res = rng.normal(size=(N, P)) * maskf
    return G, cov, maskf, res, float(ind.sum() - K)


def test_score_functions_match_jax(jax_dense):
    """residualize_scale_block, score_qt_block (strict and not),
    onepass_constants and score_qt_block_onepass against the JAX
    package's, within 1e-9."""
    _, jm2 = jax_dense
    G, cov, maskf, res, sden = _scoring_case(4)
    t = [_t(a) for a in (G, cov, maskf, res)]
    Gr, sf, low = tm2.residualize_scale_block(t[0], t[1], sden)
    jGr, jsf, jlow = jm2.residualize_scale_block(G, cov, sden)
    _close(Gr, jGr)
    _close(sf, jsf)
    np.testing.assert_array_equal(low.numpy(), np.asarray(jlow))
    assert low.numpy()[3]
    for strict in (False, True):
        got = tm2.score_qt_block(Gr, t[3], t[2], sden, strict)
        want = jm2.score_qt_block(np.asarray(jGr), res, maskf, sden, strict)
        for a, b in zip(got, want):
            _close(a, b)
    CM, Mmat, ctr = tm2.onepass_constants(t[1], t[2], t[3])
    jCM, jMmat, jctr = jm2.onepass_constants(cov, maskf, res)
    for a, b in ((CM, jCM), (Mmat, jMmat), (ctr, jctr)):
        _close(a, b)
    got = tm2.score_qt_block_onepass(t[0], t[1], t[3], t[2], CM, Mmat, ctr, sden)
    want = jm2.score_qt_block_onepass(G, cov, res, maskf, jCM, jMmat, jctr, sden)
    for a, b in zip(got, want):
        _close(a, b)
    # the engine's cached operands give the same
    W = tm2.onepass_weights(t[1], t[3], CM)
    again = tm2.score_qt_block_onepass(
        t[0], t[1], t[3], t[2], None, Mmat, ctr, sden, W=W,
        maskf1=torch.cat([t[2], torch.ones_like(t[2][:, :1])], 1))
    for a, b in zip(again, got):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the engine's block stats and genotype counts against the JAX engine's
# ---------------------------------------------------------------------------


def _engines(d, src_args, monkeypatch, extra=()):
    """The port's and the JAX package's Step-2 engines on the same run-up,
    on the CPU, and the first block."""
    from regenie_tpu import cli as jcli
    from regenie_tpu import run_step2 as jrs
    from regenie_tpu_torch import cli
    from regenie_tpu_torch.run_step2 import open_engine
    from regenie_tpu_torch.utils.device import DEVICE_ENV

    monkeypatch.setenv(DEVICE_ENV, "cpu")
    argv = ["--step", "2", *src_args, "--phenoFile", f"{d}/pheno.txt",
            "--covarFile", f"{d}/covar.txt", "--remove", f"{d}/remove.txt",
            "--ignore-pred", "--bsize", "64", *extra, "--out", f"{d}/eng"]
    params = cli.args_to_params(cli.build_parser().parse_args(argv))
    eng, blocks = open_engine(params, log=lambda *a: None)
    jp = jcli.args_to_params(jcli.build_parser().parse_args(argv))
    jp.test_mode = True
    from regenie_tpu.prep import prepare as jprepare

    jrd = jprepare(jp, log=lambda *a: None)
    jeng = jrs.Step2Engine(jp, jrd.geno, jrd.pheno, None, lambda *a: None)
    return eng, jeng, blocks


@pytest.mark.parametrize("src", ["chrx_bed", "bgen"])
def test_block_stats_and_genocounts_match_jax(datasets, src, monkeypatch):
    """Step2Engine.block_stats and compute_genocounts (hemizygous chrX
    males on the BED, dosages on the BGEN) against the JAX engine's on
    each block, with the raw block the JAX reader gives; block_stats also
    on a host numpy block (the packed upload)."""
    d, args = datasets[src]
    eng, jeng, blocks = _engines(d, args, monkeypatch, ["--htp", "T"])
    for chrom, bsnps in blocks:
        G = np.asarray(jeng.gd.read_block(bsnps))
        dev = eng.upload_dense(eng.read_block_dense(bsnps), bsnps)[0]
        np.testing.assert_array_equal(dev.numpy(), G)
        want = jeng.block_stats(G, bsnps)
        for got in (eng.block_stats(dev, bsnps), eng.block_stats(G, bsnps)):
            for k in want:
                _close(got[k], want[k])
        np.testing.assert_array_equal(eng.compute_genocounts(dev, bsnps),
                                      jeng.compute_genocounts(G, bsnps))
    eng.gd.close()


# ---------------------------------------------------------------------------
# the CLI against the JAX package's dense path
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """Small synthetic inputs (N = 500, P = 3, --remove), one directory
    each: BED, chrX BED (PAR1, non-PAR, PAR2), BGEN 8-bit zlib, 16-bit
    phased uncompressed, layout 1, 10-bit zstd (zlib where libzstd is
    absent), 3-bit phased, and a PGEN with dense dosage tracks."""
    base = str(tmp_path_factory.mktemp("torch_dense"))
    kw = dict(N=500, P=P, n_inc=1, n_cov=3, na_rate=0.1, n_remove=7,
              effect_sd=0.5)
    two = ((1, 100), (2, 60))
    chrx = dict(chroms=((1, 60), ("X", 100)),
                positions={"X": chrx_positions(100, 12, 12)})
    try:
        zstd = dict(compress=zstd_compressor(), compression=2)
    except OSError:
        zstd = {}
    out = {}

    def mk(name, fn, **kwargs):
        d = os.path.join(base, name)
        os.makedirs(d)
        path = fn(d, **kwargs)
        if fn is write_bgen_dataset:
            args = ["--bgen", path, "--sample", f"{d}/geno.sample"]
        else:
            args = ["--pgen" if fn is write_pgen_dataset else "--bed", path]
        out[name] = (d, args)

    mk("bed", write_dataset, seed=21, chroms=two, **kw)
    mk("chrx_bed", write_dataset, seed=22, **chrx, **kw)
    mk("bgen", write_bgen_dataset, seed=23, chroms=two, **kw)
    mk("bgen16_phased_raw", write_bgen_dataset, seed=24, chroms=two, bits=16,
       phased=True, compression=0, **kw)
    mk("bgen_layout1", write_bgen_dataset, seed=25, chroms=two, layout=1, **kw)
    mk("bgen10_zstd", write_bgen_dataset, seed=26, chroms=two, bits=10, **zstd,
       **kw)
    mk("bgen3_phased", write_bgen_dataset, seed=27, chroms=two, bits=3,
       phased=True, **kw)
    mk("pgen_dosage", write_pgen_dataset, seed=28, chroms=two, dosage=0.5, **kw)
    return out


# id: (dataset, flags, REGENIE_TPU_FUSED for the JAX run, for the port's)
SCENARIOS = {
    "bed_plain": ("bed", [], "0", "0"),
    "bed_htp": ("bed", ["--htp", "T"], "0", "0"),
    "bed_nocov": ("bed", ["--nocov-approx", "--phenoColList", "Y2"], "0", None),
    "bed_rec_minhoms_nosplit": ("bed", ["--test", "recessive", "--minHOMs", "1",
                                        "--no-split"], "0", "0"),
    "bed_dom_strict": ("bed", ["--test", "dominant", "--strict"], "0", "0"),
    "chrx_dense": ("chrx_bed", ["--htp", "T"], "0", "0"),
    "chrx_skip_comp": ("chrx_bed", ["--skip-dosage-comp", "--htp", "T"], "1", None),
    "chrx_rec": ("chrx_bed", ["--test", "recessive", "--minHOMs", "1",
                              "--no-split"], "1", None),
    "bgen_plain": ("bgen", [], "0", "0"),
    "bgen_htp": ("bgen", ["--htp", "T"], "1", None),
    "bgen_nosplit_dom": ("bgen", ["--no-split", "--test", "dominant"], "1", None),
    "bgen_ref_first_min_info": ("bgen", ["--ref-first", "--minINFO", "0.8"],
                                "0", "0"),
    "bgen16_phased_raw": ("bgen16_phased_raw", [], "1", None),
    "bgen_layout1": ("bgen_layout1", ["--test", "recessive"], "1", None),
    "bgen10_zstd": ("bgen10_zstd", [], "1", None),
    "bgen3_phased": ("bgen3_phased", ["--htp", "T"], "1", None),
    "pgen_dosage": ("pgen_dosage", ["--minINFO", "0.5"], "1", None),
    "pgen_dosage_nosplit": ("pgen_dosage", ["--no-split"], "1", None),
}


def _outputs(prefix, flags):
    if "--no-split" in flags and "--htp" not in flags:
        return [f"{prefix}.regenie"]
    names = ["Y2"] if "--phenoColList" in flags else [f"Y{p + 1}" for p in range(P)]
    return [f"{prefix}_{n}.regenie" for n in names]


def run_both(d, args, flags, jax_fused, port_fused, monkeypatch, tag):
    """The JAX package's CLI and the port's on the CPU, in this process,
    each with its REGENIE_TPU_FUSED (None: unset); returns (the port's
    log, [(JAX file, port file)])."""
    from regenie_tpu import cli as jcli
    from regenie_tpu_torch import cli
    from regenie_tpu_torch.utils.device import DEVICE_ENV

    common = ["--step", "2", *args, "--phenoFile", f"{d}/pheno.txt",
              "--covarFile", f"{d}/covar.txt", "--remove", f"{d}/remove.txt",
              "--ignore-pred", "--bsize", "64", *flags]
    monkeypatch.setenv(DEVICE_ENV, "cpu")
    jx, pt = f"{d}/jax_{tag}", f"{d}/pt_{tag}"
    for env, main, out in ((jax_fused, jcli.main, jx), (port_fused, cli.main, pt)):
        if env is None:
            monkeypatch.delenv("REGENIE_TPU_FUSED", raising=False)
        else:
            monkeypatch.setenv("REGENIE_TPU_FUSED", env)
        main(common + ["--out", out])
    monkeypatch.delenv("REGENIE_TPU_FUSED", raising=False)
    return (open(f"{pt}.log").read(),
            list(zip(_outputs(jx, flags), _outputs(pt, flags))))


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_cli_dense_matches_jax(datasets, scenario, monkeypatch):
    """The port's CLI on the CPU against the JAX package's dense path on
    the CPU (REGENIE_TPU_FUSED=0, or =1 where the JAX package routes the
    run or its chrX / rejected blocks to the dense path by itself): same
    header, row count and NA pattern, every numeric field within rel
    1e-9. Where the port's switch is unset, the route follows from the
    input and the flags alone; the log names it and counts its blocks."""
    from test_torch_step2 import _assert_rows_equiv

    name, flags, jf, pf = SCENARIOS[scenario]
    d, args = datasets[name]
    log, files = run_both(d, args, flags, jf, pf, monkeypatch, scenario)
    assert "dense scorer on cpu" in log
    n_dense = int(log.split(" * dense route: ")[1].split()[0])
    if name.startswith("chrx") and pf is None:
        assert 0 < n_dense < 3  # chrX non-PAR blocks only
    else:
        assert n_dense == 3
    for jfile, pfile in files:
        _assert_rows_equiv(jfile, pfile)
        rows = open(pfile).read().splitlines()
        assert len(rows) > 60
        if "--htp" not in flags and "bed" not in name and "chrx" not in name:
            assert "INFO" in rows[0].split()


@pytest.mark.parametrize("name", ["bed", "chrx_bed", "bgen"])
def test_dense_matches_own_fused(datasets, name, monkeypatch):
    """On the inputs both routes take, the port's dense output equals its
    own fused output within rel 1e-9 (the dense route is the fused
    path's independent check)."""
    from regenie_tpu_torch import cli
    from regenie_tpu_torch.utils.device import DEVICE_ENV
    from test_torch_step2 import _assert_rows_equiv

    d, args = datasets[name]
    monkeypatch.setenv(DEVICE_ENV, "cpu")
    common = ["--step", "2", *args, "--phenoFile", f"{d}/pheno.txt",
              "--covarFile", f"{d}/covar.txt", "--remove", f"{d}/remove.txt",
              "--ignore-pred", "--bsize", "64"]
    for env in ("0", "1"):
        monkeypatch.setenv("REGENIE_TPU_FUSED", env)
        cli.main(common + ["--out", f"{d}/own{env}"])
    assert " * dense route: 0 of 3 blocks" in open(f"{d}/own1.log").read()
    for p in range(P):
        _assert_rows_equiv(f"{d}/own1_Y{p + 1}.regenie",
                           f"{d}/own0_Y{p + 1}.regenie")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["chrx_bed", "bgen10_zstd", "pgen_dosage"])
def test_dense_on_card_matches_cpu(cuda, tmp_path, name, monkeypatch):
    """The dense route on the card against the CPU at small N: every
    field within the smoke's bars (chip_smoke._compare_files); no
    hand-written kernel launches."""
    from chip_smoke import _compare_files
    from regenie_tpu_torch import cli
    from regenie_tpu_torch.ops import kernels
    from regenie_tpu_torch.utils.device import DEVICE_ENV

    d = str(tmp_path)
    kw = dict(N=800, P=P, n_inc=1, n_cov=3, n_remove=7, effect_sd=0.5,
              chroms=((1, 100), (2, 60)))
    if name == "chrx_bed":
        kw["chroms"] = ((1, 60), ("X", 100))
        path = write_dataset(d, seed=31, positions={"X": chrx_positions(100, 12, 12)},
                             **kw)
        args = ["--bed", path, "--skip-dosage-comp"]
    elif name == "pgen_dosage":
        args = ["--pgen", write_pgen_dataset(d, seed=32, dosage=0.5, **kw)]
    else:
        args = ["--bgen", write_bgen_dataset(d, seed=33, bits=10, **kw),
                "--sample", f"{d}/geno.sample"]
    common = ["--step", "2", *args, "--phenoFile", f"{d}/pheno.txt",
              "--covarFile", f"{d}/covar.txt", "--remove", f"{d}/remove.txt",
              "--ignore-pred", "--bsize", "64", "--htp", "T"]
    monkeypatch.setenv("REGENIE_TPU_FUSED", "0")
    monkeypatch.delenv(DEVICE_ENV, raising=False)
    for w in kernels.WRAPPERS.values():
        w.launches = 0
    cli.main(common + ["--out", f"{d}/gpu"])
    assert all(w.launches == 0 for w in kernels.WRAPPERS.values())
    assert "dense scorer on cuda" in open(f"{d}/gpu.log").read()
    monkeypatch.setenv(DEVICE_ENV, "cpu")
    cli.main(common + ["--out", f"{d}/cpu"])
    for p in range(P):
        assert _compare_files(f"{d}/gpu_Y{p + 1}.regenie",
                              f"{d}/cpu_Y{p + 1}.regenie") <= 1.0
