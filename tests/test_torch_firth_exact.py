"""Slice tests of exact Firth (--bt --firth without --approx) and of the
null Firth checkpoints (--write-null-firth, --use-null-firth) in the port,
on the CPU, against the JAX package:

- the batched solver (models/corrections_device.exact_firth_batch_dev,
  the card's path, here in float64 torch on the CPU) and the port's host
  twin (models/step2_bt._exact_firth_snp) against the JAX package's
  _exact_firth_snp on the same rows: the same convergence flags, beta, SE
  and LRT within rel 1e-9 (the host twins equal);
- the CLI on a small synthetic BED and BGEN: exact Firth on the fused
  route byte for byte against REGENIE_TPU_FUSED=1 python -m regenie_tpu,
  on the dense route within rel 1e-9 against REGENIE_TPU_FUSED=0, with
  the batched solver asked for (REGENIE_TPU_DEVICE_CORR=1) within rel
  1e-9; the two-step workflow with Step 1 --write-null-firth and Step 2
  --pred --use-null-firth; Step 2 --firth --approx --write-null-firth
  (with and without --compute-all) and --use-null-firth, .regenie and
  .firth files byte for byte.

One test needs an NVIDIA GPU (marker `cuda`): the batched solver on the
card against the host twin. On the GPU machine, which has no JAX, run it
with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_firth_exact.py
"""

import os

import numpy as np
import pytest

from chip_smoke import write_bgen_dataset, write_bt_table, write_dataset

N = 900


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """BED and BGEN datasets with binary traits, and each package's Step 1
    --bt --write-null-firth on the BED."""
    root = str(tmp_path_factory.mktemp("torch_firth_exact"))
    out = {}
    for name, fn in (("bed", write_dataset), ("bgen", write_bgen_dataset)):
        d = os.path.join(root, name)
        os.makedirs(d)
        g = fn(d, seed=4, N=N, P=3, n_inc=1, n_cov=3, n_remove=5,
               chroms=((1, 150), (2, 90)))
        Y = np.genfromtxt(f"{d}/pheno.txt", skip_header=1, usecols=range(2, 5),
                          missing_values="NA")
        X = np.genfromtxt(f"{d}/covar.txt", skip_header=1, usecols=range(2, 5))
        write_bt_table(f"{d}/pheno_bt.txt", np.nan_to_num(Y), seed=1, n_inc=1, X=X)
        src = (["--bgen", g, "--sample", f"{d}/geno.sample"] if name == "bgen"
               else ["--bed", g])
        out[name] = (d, src)
    return out


def _base(d, src):
    return [*src, "--phenoFile", f"{d}/pheno_bt.txt", "--covarFile",
            f"{d}/covar.txt", "--remove", f"{d}/remove.txt", "--bt"]


def _jax(argv, monkeypatch, fused=True):
    from regenie_tpu import cli as jcli

    monkeypatch.setenv("REGENIE_TPU_PLATFORM", "cpu")
    monkeypatch.setenv("REGENIE_TPU_FUSED", "1" if fused else "0")
    jcli.main(argv)
    return open(argv[-1] + ".log").read()


def _port(argv, monkeypatch, fused=True, corr=None):
    from regenie_tpu_torch import cli
    from regenie_tpu_torch.utils.device import DEVICE_ENV

    monkeypatch.setenv(DEVICE_ENV, "cpu")
    if fused:
        monkeypatch.delenv("REGENIE_TPU_FUSED", raising=False)
    else:
        monkeypatch.setenv("REGENIE_TPU_FUSED", "0")
    if corr is None:
        monkeypatch.delenv("REGENIE_TPU_DEVICE_CORR", raising=False)
    else:
        monkeypatch.setenv("REGENIE_TPU_DEVICE_CORR", corr)
    cli.main(argv)
    return open(argv[-1] + ".log").read()


def _counts(log):
    return [ln for ln in log.splitlines()
            if "correction :" in ln or "failed tests" in ln]


def _assert_rows_close(f, g, rtol=1e-9):
    """Same header, row count and NA pattern; numeric fields within rtol."""
    la = open(f).read().splitlines()
    lb = open(g).read().splitlines()
    assert len(la) == len(lb) and la[0] == lb[0], (f, len(la), len(lb))
    for ra, rb in zip(la[1:], lb[1:]):
        ta = ra.replace(";", " ").replace("=", " ").split()
        tb = rb.replace(";", " ").replace("=", " ").split()
        assert len(ta) == len(tb), (ra, rb)
        for xa, xb in zip(ta, tb):
            if xa != xb:
                fa, fb = float(xa), float(xb)  # raises on an NA mismatch
                assert abs(fa - fb) <= rtol * max(1.0, abs(fa)), (ra, rb)


def _step1(data, monkeypatch):
    """Each package's Step 1 --bt --write-null-firth on the BED, once."""
    d, src = data["bed"]
    if not os.path.exists(f"{d}/pt_s1_firth.list"):
        argv = ["--step", "1", *_base(d, src), "--bsize", "100", "--write-null-firth"]
        _jax(argv + ["--out", f"{d}/jax_s1"], monkeypatch)
        _port(argv + ["--out", f"{d}/pt_s1"], monkeypatch)
    return d


# name: (dataset, flags (TAG: jax or pt), fused route, REGENIE_TPU_DEVICE_CORR)
SCENARIOS = {
    "exact_bed": ("bed", ["--firth", "--pThresh", "0.2"], True, None),
    "exact_bed_dense": ("bed", ["--firth", "--pThresh", "0.2"], False, None),
    "exact_bed_batched": ("bed", ["--firth", "--pThresh", "0.2"], True, "1"),
    "exact_bgen": ("bgen", ["--firth", "--pThresh", "0.1"], True, None),
    "exact_pred_use_null_firth": ("bed", ["--firth", "--pred", "S1_pred.list",
                                          "--use-null-firth", "S1_firth.list"],
                                  True, None),
    "approx_write_null_firth": ("bed", ["--firth", "--approx", "--write-null-firth"],
                                True, None),
    "approx_write_null_firth_all": ("bed", ["--firth", "--approx",
                                            "--write-null-firth", "--compute-all"],
                                    True, None),
    "approx_use_null_firth": ("bed", ["--firth", "--approx", "--pred", "S1_pred.list",
                                      "--use-null-firth", "S1_firth.list"], True, None),
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_cli_matches_jax(data, scenario, monkeypatch):
    """The port's Step 2 with exact Firth or the null Firth checkpoints on
    the CPU against the JAX package's: the fused route's .regenie files
    and every .firth file byte for byte, the dense route and the batched
    solver within rel 1e-9; the same corrected and failed counts."""
    name, flags, fused, corr = SCENARIOS[scenario]
    d, src = data[name]
    if "S1_pred.list" in flags:
        _step1(data, monkeypatch)
    jx, pt = f"{d}/jax_{scenario}", f"{d}/pt_{scenario}"

    def argv(tag):
        fl = [f"{d}/{tag}_s1_{a[3:]}" if a.startswith("S1_") else a for a in flags]
        if "--pred" not in fl:
            fl += ["--ignore-pred"]
        return ["--step", "2", *_base(d, src), "--bsize", "64", *fl]

    jlog = _jax(argv("jax") + ["--out", jx], monkeypatch, fused)
    plog = _port(argv("pt") + ["--out", pt], monkeypatch, fused, corr)
    assert _counts(jlog) == _counts(plog)
    assert int(_counts(plog)[0].split(":")[1]) > 0
    assert ("on the device" if corr == "1" else "on the host") in plog
    for p in (1, 2, 3):
        f, g = f"{pt}_Y{p}.regenie", f"{jx}_Y{p}.regenie"
        if fused and corr is None:
            assert open(f, "rb").read() == open(g, "rb").read(), f
        else:
            _assert_rows_close(g, f)
    if "--write-null-firth" in flags:
        rows = [ln.split() for ln in open(f"{pt}_firth.list").read().splitlines()]
        assert [r[0] for r in rows] == ["Y1", "Y2", "Y3"]
        for p in (1, 2, 3):
            a = open(f"{pt}_{p}.firth", "rb").read()
            assert a == open(f"{jx}_{p}.firth", "rb").read()
            chroms = [ln.split()[0] for ln in a.decode().splitlines()]
            assert chroms == ([str(c) for c in range(1, 24)]
                              if "--compute-all" in flags else ["1", "2"])


def _rows_and_state(data, monkeypatch):
    """The port's BT engine on the BED at its first block after the null
    fits, the block's corrected rows' genotypes and the JAX package's
    matching state objects."""
    import torch

    from regenie_tpu_torch import cli
    from regenie_tpu_torch.run_step2 import open_engine

    monkeypatch.setenv("REGENIE_TPU_PLATFORM", "cpu")
    d, src = data["bed"]
    argv = ["--step", "2", *_base(d, src), "--bsize", "128", "--firth",
            "--ignore-pred", "--out", f"{d}/rows"]
    eng, blocks = open_engine(cli.args_to_params(cli.build_parser().parse_args(argv)),
                              log=lambda *a: None, device="cpu")
    chrom, bsnps = blocks[0]
    eng.prep_chrom(chrom)
    G = eng.read_block_dense(bsnps)
    blk = eng.upload_dense(G, bsnps)
    from regenie_tpu_torch.ops.geno_ops import finalize_block_step2

    Graw = blk if isinstance(blk, torch.Tensor) else blk[0]
    ind = torch.as_tensor(eng.pd.ind_in_analysis)
    Gf = finalize_block_step2(Graw, ind, torch.zeros(Graw.shape[0], dtype=torch.bool))
    return eng, Gf


@pytest.mark.parametrize("ph", [0, 2])
def test_batched_and_host_match_jax(data, ph, monkeypatch):
    """exact_firth_batch_dev (torch float64 on the CPU) and the port's
    _exact_firth_snp against the JAX package's _exact_firth_snp on 48 rows
    of the first block: the same flags; the host twins equal, the batched
    solver within rel 1e-9."""
    from types import SimpleNamespace

    from regenie_tpu.models import step2_bt as jbt
    from regenie_tpu_torch.models import step2_bt

    eng, Gf = _rows_and_state(data, monkeypatch)
    params, pd, st = eng.params, eng.pd, eng.null_state
    G = Gf[:48]
    ok_b, beta_b, se_b, lrt_b = step2_bt.exact_firth_dev(params, pd, st, ph, G)
    Gh = G.numpy()
    y = pd.phenotypes_raw[:, ph]
    mask = pd.masked_indivs[:, ph]
    offset = st.blups[:, ph] * mask
    jst = SimpleNamespace(bhat_start=st.bhat_start)
    n_ok = 0
    for i in range(len(Gh)):
        want = jbt._exact_firth_snp(params, pd, y, Gh[i], offset, mask, jst, ph)
        host = step2_bt._exact_firth_snp(params, pd, y, Gh[i], offset, mask, st, ph)
        assert want == host
        assert bool(ok_b[i]) == bool(want[0])
        if want[0]:
            n_ok += 1
            np.testing.assert_allclose([beta_b[i], se_b[i], lrt_b[i]], want[1:],
                                       rtol=1e-9, atol=1e-12)
    assert n_ok >= 40
    eng.gd.close()


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA)")


@pytest.mark.cuda
def test_batched_on_card_matches_host(cuda, tmp_path):
    """exact_firth_batch_dev on the card against the host twin
    _exact_firth_snp on synthetic rows: the same flags, LRT within rel
    1e-8, beta and SE within rel 1e-6."""
    import torch

    from regenie_tpu_torch.config import Params
    from regenie_tpu_torch.models import corrections_device as cdev
    from regenie_tpu_torch.models import step2_bt
    from regenie_tpu_torch.models.glm import fit_logistic_irls

    rng = np.random.default_rng(3)
    n, K, S = 3000, 5, 24
    X = np.column_stack([np.ones(n), rng.standard_normal((n, K - 1))])
    mask = rng.random(n) > 0.03
    y = np.where(rng.random(n) < 1 / (1 + np.exp(2.0 - 0.3 * X[:, 1])), 1.0, 0.0)
    G = rng.binomial(2, rng.uniform(0.005, 0.4, S)[:, None], (S, n)).astype(float)
    offset = np.zeros(n)
    b0, ok = fit_logistic_irls(y, X, offset, mask)
    assert ok
    params = Params()
    pd = type("PD", (), {"new_cov": X})()
    st = type("ST", (), {"bhat_start": b0[:, None]})()
    want = [step2_bt._exact_firth_snp(params, pd, y, G[i], offset, mask, st, 0)
            for i in range(S)]
    dev = torch.device("cuda")

    def put(a):
        return torch.as_tensor(a, dtype=torch.float64, device=dev)

    ok_b, beta, se, lrt = cdev.exact_firth_batch_dev(
        put(y), put(X), put(G), put(offset), put(mask.astype(float)), put(b0),
        tol_null=10 * params.numtol)
    assert [w[0] for w in want] == list(ok_b)
    for i, w in enumerate(want):
        if w[0]:
            np.testing.assert_allclose(lrt[i], w[3], rtol=1e-8)
            np.testing.assert_allclose([beta[i], se[i]], w[1:3], rtol=1e-6)
