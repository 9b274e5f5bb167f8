"""Slice tests of the port's Step 1 on time-to-event traits
(python -m regenie_tpu_torch --step 1 --t2e) and the two-step Cox
workflow, on the CPU against the JAX package (both in this process,
float64):

- the Cox null offsets (models/glm.fit_null_offsets) bit for bit;
- one coordinate sweep of the torch Cox ridge (step1_bt.cox_sweep, a
  triangular solve on the F x F system) against CoxRidge.fit's
  coordinate-by-coordinate loop, within rel 1e-12;
- the torch Cox level 1 (step1_bt.level1_nonqt on a time-to-event
  trait) against the JAX package's _level1_t2e on the same synthetic
  level-0 predictions, by default and with --t2e-l1-pi6: the same
  penalty chosen, predictions within rel 1e-9;
- the CLI on synthetic BED, PGEN and BGEN files with write_t2e_table's
  endpoints (tied times, NA times, --remove): K-fold, --t2e-l1-pi6 and
  --t2e-event-l0, .loco files byte for byte against python -m
  regenie_tpu --step 1; --loocv raising IndexError in both packages; and
  Step 2 --pred on each package's own Step 1 (fused, --firth --approx)
  byte for byte.

One test needs an NVIDIA GPU (marker `cuda`): the Cox level 1 on the
card against the CPU. On the GPU machine, which has no JAX, run it with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_step1_t2e.py
"""

import os
from types import SimpleNamespace

import numpy as np
import pytest

from chip_smoke import (t2e_flags, write_bgen_dataset, write_dataset,
                        write_pgen_dataset, write_t2e_table)

N = 900
NT = 2


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_step1_t2e"))
    out = {}
    for name, fn in (("bed", write_dataset), ("pgen", write_pgen_dataset),
                     ("bgen", write_bgen_dataset)):
        d = os.path.join(root, name)
        os.makedirs(d)
        g = fn(d, seed=7, N=N, chroms=((1, 200), (2, 100)), P=3, n_inc=1,
               n_cov=3, n_remove=5, effect_sd=0.5)
        Y = np.genfromtxt(f"{d}/pheno.txt", skip_header=1, missing_values="NA")[:, 2:]
        X = np.genfromtxt(f"{d}/covar.txt", skip_header=1)[:, 2:]
        write_t2e_table(f"{d}/pheno_t2e.txt", np.nan_to_num(Y[:, :NT]), seed=3,
                        n_na=1, X=X)
        src = (["--bgen", g, "--sample", f"{d}/geno.sample"] if name == "bgen"
               else ["--pgen" if name == "pgen" else "--bed", g])
        out[name] = (d, [*src, "--phenoFile", f"{d}/pheno_t2e.txt", "--covarFile",
                         f"{d}/covar.txt", "--remove", f"{d}/remove.txt",
                         *t2e_flags(NT)])
    return out


def _jax(argv, monkeypatch):
    from regenie_tpu import cli as jcli

    monkeypatch.setenv("REGENIE_TPU_PLATFORM", "cpu")
    monkeypatch.setenv("REGENIE_TPU_FUSED", "1")
    jcli.main(argv)


def _port(argv, monkeypatch, device="cpu"):
    from regenie_tpu_torch import cli
    from regenie_tpu_torch.utils.device import DEVICE_ENV

    monkeypatch.setenv(DEVICE_ENV, device)
    monkeypatch.delenv("REGENIE_TPU_FUSED", raising=False)
    cli.main(argv)
    return open(argv[-1] + ".log").read()


def _min_lines(path):
    return [ln for ln in open(path).read().splitlines() if "<- min value" in ln]


# name: (dataset, Step-1 flags, Step 2 with --pred)
CLI = {
    "bed_kfold_two_step": ("bed", [], True),
    "bed_pi6": ("bed", ["--t2e-l1-pi6"], False),
    "bed_event_l0": ("bed", ["--t2e-event-l0"], False),
    "pgen_kfold": ("pgen", [], False),
    "bgen_kfold": ("bgen", [], False),
}


@pytest.mark.parametrize("scenario", sorted(CLI))
def test_cli_matches_jax(data, scenario, monkeypatch):
    """Step 1 --t2e through both CLIs: .loco files of the time columns
    only, byte for byte, and the same penalty chosen per trait; with
    two_step, Step 2 --t2e --firth --approx with --pred on each package's
    own _pred.list, byte for byte."""
    name, flags, two_step = CLI[scenario]
    d, base = data[name]
    jx, pt = f"{d}/jax_{scenario}", f"{d}/pt_{scenario}"
    s1 = ["--step", "1", *base, "--bsize", "100", *flags]
    _jax(s1 + ["--out", jx], monkeypatch)
    log = _port(s1 + ["--out", pt], monkeypatch)
    assert " * level 0 on cpu (float64)" in log
    assert _min_lines(f"{pt}.log") == _min_lines(f"{jx}.log")
    for i in range(1, NT + 1):
        assert (open(f"{pt}_{i}.loco", "rb").read()
                == open(f"{jx}_{i}.loco", "rb").read()), i
    assert not os.path.exists(f"{pt}_{NT + 1}.loco")
    names = [ln.split()[0] for ln in open(f"{pt}_pred.list")]
    assert names == [f"T{i}" for i in range(1, NT + 1)]
    if not two_step:
        return
    s2 = ["--step", "2", *base, "--bsize", "64", "--firth", "--approx",
          "--pThresh", "0.5"]
    _jax(s2 + ["--pred", f"{jx}_pred.list", "--out", jx + "_s2"], monkeypatch)
    _port(s2 + ["--pred", f"{pt}_pred.list", "--out", pt + "_s2"], monkeypatch)
    for i in range(1, NT + 1):
        f, g = f"{pt}_s2_T{i}.regenie", f"{jx}_s2_T{i}.regenie"
        assert open(f, "rb").read() == open(g, "rb").read(), f


def test_loocv_raises_as_jax(data, monkeypatch):
    """--loocv --t2e: the JAX package's Cox level 1 is K-fold only and
    fails with IndexError at level 1; the port raises the same."""
    d, base = data["bed"]
    s1 = ["--step", "1", *base, "--bsize", "100", "--loocv"]
    with pytest.raises(IndexError):
        _jax(s1 + ["--out", f"{d}/jax_loocv"], monkeypatch)
    with pytest.raises(IndexError):
        _port(s1 + ["--out", f"{d}/pt_loocv"], monkeypatch)


def test_null_offsets_match_jax(data, monkeypatch):
    """fit_null_offsets on the Cox traits: the offsets of the time columns
    (zero on the event columns) and the passing flags, bit for bit."""
    from regenie_tpu import cli as jcli
    from regenie_tpu.models import glm as jglm
    from regenie_tpu.prep import prepare as jprepare
    from regenie_tpu_torch import cli
    from regenie_tpu_torch.models import glm
    from regenie_tpu_torch.prep import prepare

    monkeypatch.setenv("REGENIE_TPU_PLATFORM", "cpu")
    d, base = data["bed"]
    argv = ["--step", "1", *base, "--out", f"{d}/offs"]
    out = []
    for c, prep, g in ((jcli, jprepare, jglm), (cli, prepare, glm)):
        params = c.args_to_params(c.build_parser().parse_args(argv))
        params.test_mode = False
        pd = prep(params, log=lambda *a: None).pheno
        out.append((g.fit_null_offsets(params, pd), pd.pheno_pass.copy(),
                    pd.new_cov))
    np.testing.assert_array_equal(out[0][2], out[1][2])
    np.testing.assert_array_equal(out[0][1], out[1][1])
    np.testing.assert_array_equal(out[0][0], out[1][0])
    assert list(out[1][1]) == [True, True, False, False]
    assert (out[1][0][:, 0] != 0).any() and not out[1][0][:, NT:].any()


def _cox_inputs(seed, n=600, F=12, K=5):
    """Synthetic level-0 predictions of one endpoint by fold ([K, nmax, F],
    pad rows 0), the pd namespace the level 1 reads (time and event
    columns, tied times, 3% masked), the fold sizes and null offsets."""
    from regenie_tpu_torch.models import step1 as m1

    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, F)) * 0.5
    eta = X[:, :4] @ np.array([0.4, -0.3, 0.2, 0.1])
    t = rng.exponential(1.0, n) / np.exp(eta)
    c = rng.uniform(0, 2.5, n)
    time, ev = np.round(np.minimum(t, c), 2), (t <= c).astype(float)
    mask = rng.random(n) > 0.03
    fold_sizes = m1.compute_fold_sizes(np.ones(n, bool), K)
    Wf, _ = m1.pad_folds(X, fold_sizes)
    pd = SimpleNamespace(pheno_names=["T1", "E1"],
                         phenotypes_raw=np.column_stack([time, ev]),
                         masked_indivs=np.column_stack([mask, mask]))
    offsets = np.zeros((n, 2))
    offsets[:, 0] = np.where(mask, rng.normal(scale=0.1, size=n), 0.0)
    return Wf, pd, fold_sizes, offsets


def _params(pi6=False):
    from regenie_tpu_torch.config import T2E, Params

    return Params(trait_mode=T2E, t2e_map={"T1": "E1"}, t2e_l1_pi6=pi6)


def test_cox_sweep_matches_coordinate_loop():
    """step1_bt.cox_sweep (one triangular solve) against CoxRidge.fit's
    sweep, one coordinate at a time in numpy, from a nonzero start: the
    same coefficients within rel 1e-12."""
    import torch

    from regenie_tpu_torch.models import step1_bt
    from regenie_tpu_torch.models.survival import CoxRidge, SurvivalData

    Wf, pd, fold_sizes, offsets = _cox_inputs(3)
    X = np.concatenate([Wf[k, : fold_sizes[k]] for k in range(len(fold_sizes))])
    mask = pd.masked_indivs[:, 0]
    offset = offsets[:, 0]
    sd = SurvivalData()
    sd.setup(pd.phenotypes_raw[:, 0], pd.phenotypes_raw[:, 1], mask,
             norm_weights=True)
    lam = 0.3
    beta = np.random.default_rng(1).normal(size=X.shape[1]) * 0.1
    cr = CoxRidge(sd, X, offset, mask, lam, beta_init=beta)
    eta = cr.eta
    grad, hess = cr._grad(eta, sd.to_order(eta))
    with np.errstate(divide="ignore", invalid="ignore"):
        z = np.where(mask, eta - offset, 0.0) - np.where(hess != 0, grad / hess, 0.0)
    b = beta.copy()
    for k in range(X.shape[1]):  # the JAX package's inner loop
        r = hess * (z - eta + offset)
        eta = eta - np.where(mask, X[:, k] * b[k], 0.0)
        xk2h = (X[:, k] ** 2 * hess).sum()
        b[k] = (r @ X[:, k] + b[k] * xk2h) / (xk2h - lam)
        eta = eta + np.where(mask, X[:, k] * b[k], 0.0)
    got = step1_bt.cox_sweep(torch.from_numpy(X), torch.from_numpy(grad),
                             torch.from_numpy(hess), torch.from_numpy(beta), lam)
    np.testing.assert_allclose(got.numpy(), b, rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("pi6", [False, True])
def test_level1_matches_jax(pi6):
    """The torch Cox level 1 against the JAX package's _level1_t2e on the
    same level-0 predictions: the same penalty chosen (the logs' "<- min
    value" lines equal), predictions within rel 1e-9."""
    import torch

    from regenie_tpu.models import step1_bt as jstep1_bt
    from regenie_tpu_torch.models import step1_bt

    Wf, pd, fold_sizes, offsets = _cox_inputs(11)
    F = Wf.shape[2]
    chr_order, spans = [1, 2], {1: (0, 7), 2: (7, F - 7)}
    taus = F * (1 - np.array([0.01, 0.25, 0.5, 0.75, 0.99])) / np.array(
        [0.01, 0.25, 0.5, 0.75, 0.99])
    jlog, plog = [], []
    W4 = np.stack([Wf, Wf], axis=-1)  # the JAX layout [K, nmax, F, P]
    want, ok = jstep1_bt._level1_t2e(_params(pi6), pd, W4, offsets, taus, 0,
                                     chr_order, spans, fold_sizes, jlog.append)
    assert ok
    got, ok = step1_bt.level1_nonqt(_params(pi6), pd, torch.from_numpy(Wf),
                                    offsets, taus, 0, chr_order, spans,
                                    fold_sizes, plog.append)
    assert ok
    assert [ln for ln in plog if "min" in ln] == [ln for ln in jlog if "min" in ln]
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9 * np.abs(want).max())


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA)")


@pytest.mark.cuda
def test_level1_on_card_matches_cpu(cuda):
    """The Cox level 1 on the card against the CPU in float64: the same
    penalty chosen, predictions within 1e-9 of their largest magnitude."""
    import torch

    from regenie_tpu_torch.models import step1_bt

    Wf, pd, fold_sizes, offsets = _cox_inputs(11, n=3000, F=40)
    F = Wf.shape[2]
    chr_order, spans = [1, 2], {1: (0, 20), 2: (20, F - 20)}
    out = []
    for dev in ("cuda", "cpu"):
        logs = []
        pred, ok = step1_bt.level1_nonqt(_params(), pd, torch.from_numpy(Wf).to(dev),
                                         offsets, None, 0, chr_order, spans,
                                         fold_sizes, logs.append)
        assert ok
        out.append((pred, [ln for ln in logs if "min" in ln]))
    assert out[0][1] == out[1][1]
    assert np.abs(out[0][0] - out[1][0]).max() <= 1e-9 * np.abs(out[1][0]).max()
