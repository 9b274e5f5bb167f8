"""Slice tests of the port's Step 1 on binary and count traits
(python -m regenie_tpu_torch --step 1 --bt / --ct) on the CPU, against the
JAX package (both in this process, float64):

- the null offsets (models/glm.py) and the level-1 penalized logistic and
  Poisson ridge (models/step1_bt.py), K-fold and LOOCV, on the same
  synthetic level-0 predictions: predictions within rel 1e-9 and the same
  ridge parameter chosen;
- the CLI on synthetic PLINK BED files: .loco files (and with
  --write-null-firth the .firth files; with --gz decompressed) byte for
  byte against python -m regenie_tpu --step 1, or each value within one
  unit of its sixth significant digit; the same ridge parameter chosen
  for every trait (the logs' "<- min value" lines). K-fold on binary
  traits needs 5,000 analysed samples (below that both packages switch
  to LOOCV), so that dataset has N = 5,200 and few variants.

One test needs an NVIDIA GPU (marker `cuda`): the level-1 fit on the card
against the CPU. On the GPU machine, which has no JAX, run it with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_step1_bt.py
"""

import gzip
import os
from types import SimpleNamespace

import numpy as np
import pytest

from chip_smoke import write_bt_table, write_ct_table, write_dataset


def _tables(d):
    Y = np.genfromtxt(f"{d}/pheno.txt", skip_header=1, usecols=range(2, 5),
                      missing_values="NA")
    X = np.genfromtxt(f"{d}/covar.txt", skip_header=1, usecols=range(2, 5))
    write_bt_table(f"{d}/pheno_bt.txt", np.nan_to_num(Y), seed=1, n_inc=1, X=X)
    write_ct_table(f"{d}/pheno_ct.txt", Y, seed=3)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """(directory, BED prefix) of a small dataset (LOOCV on binary traits)
    and of one of 5,200 samples (K-fold)."""
    root = str(tmp_path_factory.mktemp("torch_step1_bt"))
    out = {}
    for name, N, chroms in (("small", 800, ((1, 200), (2, 100))),
                            ("kfold", 5200, ((1, 100), (2, 60)))):
        d = os.path.join(root, name)
        os.makedirs(d)
        prefix = write_dataset(d, seed=7, N=N, chroms=chroms, P=3, n_inc=1,
                               n_cov=3, n_remove=5, effect_sd=1.0)
        _tables(d)
        out[name] = (d, prefix)
    return out


def _argv(d, prefix, mode, extra):
    table = "pheno_ct.txt" if mode == "--ct" else "pheno_bt.txt"
    return ["--step", "1", "--bed", prefix, "--phenoFile", f"{d}/{table}",
            "--covarFile", f"{d}/covar.txt", "--remove", f"{d}/remove.txt",
            "--bsize", "100", mode, *extra]


def _port(argv, monkeypatch, device="cpu"):
    from regenie_tpu_torch import cli
    from regenie_tpu_torch.utils.device import DEVICE_ENV

    monkeypatch.setenv(DEVICE_ENV, device)
    cli.main(argv)
    return open(argv[-1] + ".log").read()


def _jax(argv, monkeypatch):
    from regenie_tpu import cli as jcli

    monkeypatch.setenv("REGENIE_TPU_PLATFORM", "cpu")
    jcli.main(argv)
    return open(argv[-1] + ".log").read()


def _read(path):
    return gzip.open(path).read() if path.endswith(".gz") else open(path, "rb").read()


def _sig6_close(a: bytes, b: bytes):
    """Same lines and tokens; every differing value within one unit of
    its sixth significant digit. Returns the count of differing values."""
    la, lb = a.decode().splitlines(), b.decode().splitlines()
    assert len(la) == len(lb)
    n = 0
    for ra, rb in zip(la, lb):
        ta, tb = ra.split(), rb.split()
        assert len(ta) == len(tb) and ta[0] == tb[0]
        for xa, xb in zip(ta, tb):
            if xa != xb:
                fa, fb = float(xa), float(xb)  # raises on an NA mismatch
                m = max(abs(fa), abs(fb))
                assert abs(fa - fb) <= 10.0 ** (np.floor(np.log10(m)) - 5) * (1 + 1e-9)
                n += 1
    return n


def _min_lines(log):
    return [ln for ln in log.splitlines() if "<- min value" in ln]


# name: (dataset, trait flag, extra flags)
SCENARIOS = {
    "bt_loocv_forced": ("small", "--bt", []),
    "bt_kfold": ("kfold", "--bt", []),
    "bt_loocv_l1full": ("small", "--bt", ["--loocv", "--l1-full"]),
    "bt_adam": ("small", "--bt", ["--use-adam"]),
    "bt_adam_mini": ("small", "--bt", ["--use-adam", "--adam-mini"]),
    "bt_null_firth_gz": ("small", "--bt", ["--write-null-firth", "--gz"]),
    "ct_kfold": ("small", "--ct", []),
    "ct_loocv": ("small", "--ct", ["--loocv"]),
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_cli_matches_jax(data, scenario, monkeypatch):
    """The port's Step 1 --bt / --ct on the CPU writes the JAX package's
    .loco (and .firth) files and picks the same ridge parameter for each
    trait."""
    name, mode, extra = SCENARIOS[scenario]
    d, prefix = data[name]
    argv = _argv(d, prefix, mode, extra)
    jx, pt = f"{d}/jax_{scenario}", f"{d}/pt_{scenario}"
    jlog = _jax(argv + ["--out", jx], monkeypatch)
    plog = _port(argv + ["--out", pt], monkeypatch)
    assert _min_lines(jlog) == _min_lines(plog) and len(_min_lines(plog)) == 3
    gz = ".gz" if "--gz" in extra else ""
    files = [f"{pt}_{i}.loco{gz}" for i in (1, 2, 3)]
    if "--write-null-firth" in extra:
        files += [f"{pt}_{i}.firth{gz}" for i in (1, 2, 3)]
        rows = [ln.split() for ln in open(f"{pt}_firth.list").read().splitlines()]
        assert [r[0] for r in rows] == ["Y1", "Y2", "Y3"]
        assert [os.path.basename(r[1]) for r in rows] == [os.path.basename(f)
                                                           for f in files[3:]]
    ndiff = sum(_sig6_close(_read(f), _read(f.replace(pt, jx))) for f in files)
    print(f"{scenario}: {ndiff} values differ in the sixth significant digit")
    if name == "small" and mode == "--bt" and "--loocv" not in extra:
        assert "using LOOCV instead of K-fold CV" in plog
    if name == "kfold":
        assert "# CV folds: [5]" in plog


def _synthetic(N, F, seed, poisson):
    """Level-0-like predictions W [N, F], offsets, outcomes and masks of
    one trait, and (jax pd, port pd) namespaces holding them."""
    rng = np.random.default_rng(seed)
    W = rng.standard_normal((N, F)) * 0.3
    off = rng.standard_normal(N) * 0.3
    eta = off + W @ (rng.standard_normal(F) * 0.2)
    y = (rng.poisson(np.exp(eta)) if poisson
         else (rng.random(N) < 1 / (1 + np.exp(-eta)))).astype(np.float64)
    mask = rng.random(N) > 0.05
    y = np.where(mask, y, -999.0)
    pd = SimpleNamespace(phenotypes_raw=y[:, None], masked_indivs=mask[:, None],
                         Neff=np.array([float(mask.sum())]))
    return W, np.where(mask, off, 0.0)[:, None], pd


@pytest.mark.parametrize("case", ["bt_kfold", "bt_loocv", "bt_loocv_adam",
                                  "ct_kfold", "ct_loocv"])
def test_level1_matches_jax(case, monkeypatch):
    """models/step1_bt.level1_nonqt on the CPU against the JAX package's on
    the same level-0 predictions: the same ridge parameter (the logs' min
    line) and predictions within rel 1e-9."""
    import torch

    from regenie_tpu import config as jconfig
    from regenie_tpu.models import step1_bt as jbt
    from regenie_tpu.utils.dtypes import enable_x64_if_cpu
    from regenie_tpu_torch import config
    from regenie_tpu_torch.models import step1 as m1
    from regenie_tpu_torch.models import step1_bt

    monkeypatch.setenv("REGENIE_TPU_PLATFORM", "cpu")
    enable_x64_if_cpu()
    poisson = case.startswith("ct")
    kfold = case.endswith("kfold")
    N, F = (1500 if kfold else 700), 12
    W, off, pd = _synthetic(N, F, seed=11 if poisson else 12, poisson=poisson)
    kw = dict(trait_mode=jconfig.CT if poisson else jconfig.BT,
              use_adam=case.endswith("adam"), cv_folds=4)
    jp, pp = jconfig.Params(**kw), config.Params(**kw)
    taus = F * (1 - config.ridge_h2_grid(5)) / config.ridge_h2_grid(5) * 3 / np.pi**2
    chr_order, spans = [1, 2], {1: (0, 8), 2: (8, 4)}
    logs = {"jax": [], "pt": []}
    if kfold:
        fold_sizes = m1.compute_fold_sizes(np.ones(N, bool), 4)
        Wf, _ = m1.pad_folds(W, fold_sizes)
        want, ok_j = jbt.level1_nonqt(jp, pd, Wf[..., None], off, taus, 0, chr_order,
                                      spans, fold_sizes, logs["jax"].append)
        Wt = torch.as_tensor(Wf)
    else:
        fold_sizes = None
        want, ok_j = jbt.level1_nonqt(jp, pd, W[..., None], off, taus, 0, chr_order,
                                      spans, None, logs["jax"].append)
        Wt = torch.as_tensor(W)
    trace = []
    got, ok_p = step1_bt.level1_nonqt(pp, pd, Wt, off, taus, 0, chr_order, spans,
                                      fold_sizes, logs["pt"].append, trace=trace)
    assert ok_j and ok_p
    assert [ln for ln in logs["jax"] if "min value" in ln] == \
        [ln for ln in logs["pt"] if "min value" in ln]
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)
    assert len(trace) == (4 * 5 if kfold else 5)


@pytest.mark.parametrize("mode", ["bt", "ct"])
def test_null_offsets_match_jax(data, mode, monkeypatch):
    """glm.fit_null_offsets on the CPU against the JAX package's, on the
    run-up of a Step-1 run: within rel 1e-9, the same passing traits."""
    from regenie_tpu import cli as jcli
    from regenie_tpu.models import glm as jglm
    from regenie_tpu.prep import prepare as jprepare
    from regenie_tpu_torch import cli
    from regenie_tpu_torch.models import glm
    from regenie_tpu_torch.prep import prepare

    monkeypatch.setenv("REGENIE_TPU_PLATFORM", "cpu")
    d, prefix = data["small"]
    argv = _argv(d, prefix, f"--{mode}", []) + ["--out", f"{d}/off"]
    pp = cli.args_to_params(cli.build_parser().parse_args(argv))
    jp = jcli.args_to_params(jcli.build_parser().parse_args(argv))
    rd = prepare(pp, log=lambda *a: None)
    jrd = jprepare(jp, log=lambda *a: None)
    got = glm.fit_null_offsets(pp, rd.pheno)
    want = jglm.fit_null_offsets(jp, jrd.pheno)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)
    np.testing.assert_array_equal(rd.pheno.pheno_pass, jrd.pheno.pheno_pass)
    np.testing.assert_array_equal(rd.pheno.phenotypes, jrd.pheno.phenotypes)
    rd.geno.close()


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["bt_kfold", "bt_loocv", "ct_kfold"])
def test_level1_on_card_matches_cpu(cuda, case):
    """The level-1 fit on the card (float64 cuBLAS/cuSOLVER) against the
    same function on the CPU: the same ridge parameter, predictions within
    rel 1e-9."""
    import torch

    from regenie_tpu_torch import config
    from regenie_tpu_torch.models import step1 as m1
    from regenie_tpu_torch.models import step1_bt

    poisson = case.startswith("ct")
    kfold = case.endswith("kfold")
    N, F = (6000 if kfold else 2000), 40
    W, off, pd = _synthetic(N, F, seed=5, poisson=poisson)
    pp = config.Params(trait_mode=config.CT if poisson else config.BT, cv_folds=5)
    taus = F * (1 - config.ridge_h2_grid(5)) / config.ridge_h2_grid(5) * 3 / np.pi**2
    chr_order, spans = [1, 2], {1: (0, 25), 2: (25, 15)}
    fold_sizes = m1.compute_fold_sizes(np.ones(N, bool), 5) if kfold else None
    Wx = m1.pad_folds(W, fold_sizes)[0] if kfold else W
    out = {}
    for dev in ("cuda", "cpu"):
        logs = []
        pred, ok = step1_bt.level1_nonqt(pp, pd, torch.as_tensor(Wx, device=dev), off,
                                         taus, 0, chr_order, spans, fold_sizes,
                                         logs.append)
        assert ok
        out[dev] = (pred, [ln for ln in logs if "min value" in ln])
    assert out["cuda"][1] == out["cpu"][1]
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-9, atol=1e-12)
