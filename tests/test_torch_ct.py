"""Slice tests of count traits (--ct) in the port's Step 2, on the CPU,
against the JAX package's python -m regenie_tpu:

- the CLI on small synthetic PLINK BED, PGEN and BGEN files with Poisson
  counts: the fused route (the BT operand and block functions with the
  weights W = mu, fused_i8 / bgen_i8 on the card) byte for byte against
  REGENIE_TPU_FUSED=1, the dense route within rel 1e-9 against
  REGENIE_TPU_FUSED=0; --htp (all-sample genotype counts, exp(beta)
  effects); the two-step workflow with each package's own Step 1 --ct;
- the null Poisson state of a chromosome (models/step2_ct.py) against the
  JAX package's within rel 1e-9.

One test needs an NVIDIA GPU (marker `cuda`): the CT CLI on the card
(fused_i8 or bgen_i8 once per block, no other kernel) against the CPU. On
the GPU machine, which has no JAX, run it with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_ct.py
"""

import os

import numpy as np
import pytest

from chip_smoke import (write_bgen_dataset, write_ct_table, write_dataset,
                        write_pgen_dataset)

N = 900
WRITERS = {"bed": write_dataset, "bgen": write_bgen_dataset,
           "pgen": write_pgen_dataset}


def _ct_table(d):
    """d/pheno_ct.txt: Poisson counts of d/pheno.txt's traits (NA kept)."""
    Y = np.genfromtxt(f"{d}/pheno.txt", skip_header=1, missing_values="NA")[:, 2:]
    write_ct_table(f"{d}/pheno_ct.txt", Y, seed=3)


def _src(name, d, g):
    if name == "bgen":
        return ["--bgen", g, "--sample", f"{d}/geno.sample"]
    return ["--pgen" if name == "pgen" else "--bed", g]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_ct"))
    out = {}
    for name, fn in WRITERS.items():
        d = os.path.join(root, name)
        os.makedirs(d)
        g = fn(d, seed=4, N=N, P=3, n_inc=1, n_cov=3, n_remove=5,
               chroms=((1, 150), (2, 90)))
        _ct_table(d)
        out[name] = (d, _src(name, d, g))
    return out


def _base(d, src):
    return [*src, "--phenoFile", f"{d}/pheno_ct.txt", "--covarFile",
            f"{d}/covar.txt", "--remove", f"{d}/remove.txt", "--ct"]


def _jax(argv, monkeypatch, fused=True):
    from regenie_tpu import cli as jcli

    monkeypatch.setenv("REGENIE_TPU_PLATFORM", "cpu")
    monkeypatch.setenv("REGENIE_TPU_FUSED", "1" if fused else "0")
    jcli.main(argv)


def _port(argv, monkeypatch, fused=True, device="cpu"):
    from regenie_tpu_torch import cli
    from regenie_tpu_torch.utils.device import DEVICE_ENV

    monkeypatch.setenv(DEVICE_ENV, device)
    if fused:
        monkeypatch.delenv("REGENIE_TPU_FUSED", raising=False)
    else:
        monkeypatch.setenv("REGENIE_TPU_FUSED", "0")
    cli.main(argv)
    return open(argv[-1] + ".log").read()


def _assert_rows_close(f, g, rtol=1e-9):
    """Same header, row count and NA pattern; numeric fields within rtol."""
    la = open(f).read().splitlines()
    lb = open(g).read().splitlines()
    assert len(la) == len(lb) > 1 and la[0] == lb[0], (f, len(la), len(lb))
    for ra, rb in zip(la[1:], lb[1:]):
        ta = ra.replace(";", " ").replace("=", " ").split()
        tb = rb.replace(";", " ").replace("=", " ").split()
        assert len(ta) == len(tb), (ra, rb)
        for xa, xb in zip(ta, tb):
            if xa != xb:
                fa, fb = float(xa), float(xb)  # raises on an NA mismatch
                assert abs(fa - fb) <= rtol * max(1.0, abs(fa)), (ra, rb)


# name: (dataset, flags, fused route)
SCENARIOS = {
    "bed": ("bed", [], True),
    "bed_htp": ("bed", ["--htp", "T"], True),
    "bed_dense_htp": ("bed", ["--htp", "T"], False),
    "pgen": ("pgen", [], True),
    "bgen": ("bgen", [], True),
    "bgen_dense_htp": ("bgen", ["--htp", "T"], False),
    "bed_two_step": ("bed", ["S1"], True),
    "bgen_two_step": ("bgen", ["S1"], True),
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_cli_matches_jax(data, scenario, monkeypatch):
    """The port's Step 2 --ct on the CPU against the JAX package's: the
    fused route byte for byte, the dense route within rel 1e-9; the
    -POISSON model in HTP rows; with S1 each package's own Step 1 --ct
    first (its .loco files byte for byte) and Step 2 with --pred on it."""
    name, flags, fused = SCENARIOS[scenario]
    d, src = data[name]
    jx, pt = f"{d}/jax_{scenario}", f"{d}/pt_{scenario}"
    extra = {"jax": ["--ignore-pred"], "pt": ["--ignore-pred"]}
    if "S1" in flags:
        flags = []
        s1 = ["--step", "1", *_base(d, src), "--bsize", "100"]
        _jax(s1 + ["--out", jx + "_s1"], monkeypatch)
        _port(s1 + ["--out", pt + "_s1"], monkeypatch)
        for i in (1, 2, 3):
            assert (open(f"{pt}_s1_{i}.loco", "rb").read()
                    == open(f"{jx}_s1_{i}.loco", "rb").read())
        extra = {t: ["--pred", f"{o}_s1_pred.list"] for t, o in (("jax", jx), ("pt", pt))}
    argv = ["--step", "2", *_base(d, src), "--bsize", "64", *flags]
    _jax(argv + extra["jax"] + ["--out", jx], monkeypatch, fused)
    log = _port(argv + extra["pt"] + ["--out", pt], monkeypatch, fused)
    assert ("fused packed-bytes scorer on cpu" if fused
            else "dense scorer on cpu") in log
    for p in (1, 2, 3):
        f, g = f"{pt}_Y{p}.regenie", f"{jx}_Y{p}.regenie"
        if fused:
            assert open(f, "rb").read() == open(g, "rb").read(), f
        else:
            _assert_rows_close(g, f)
    if "--htp" in flags:
        rows = open(f"{pt}_Y1.regenie").read().splitlines()
        assert "ADD-WGR-POISSON" in rows[1] or "ADD-POISSON" in rows[1]
        assert "REGENIE_BETA=" in "".join(rows[1:])


def test_null_state_matches_jax(data, monkeypatch):
    """step2_ct.prep_chromosome against the JAX package's on the BED's
    first chromosome: residuals, weights and bases within rel 1e-9."""
    from regenie_tpu import cli as jcli
    from regenie_tpu.prep import prepare as jprepare
    from regenie_tpu.run_step2 import Step2Engine as JEngine
    from regenie_tpu_torch import cli
    from regenie_tpu_torch.run_step2 import open_engine

    monkeypatch.setenv("REGENIE_TPU_PLATFORM", "cpu")
    d, src = data["bed"]
    argv = ["--step", "2", *_base(d, src), "--ignore-pred", "--out", f"{d}/eng"]
    eng, blocks = open_engine(cli.args_to_params(cli.build_parser().parse_args(argv)),
                              log=lambda *a: None, device="cpu")
    jp = jcli.args_to_params(jcli.build_parser().parse_args(argv))
    jp.test_mode = True
    rd = jprepare(jp, log=lambda *a: None)
    jeng = JEngine(jp, rd.geno, rd.pheno, None, lambda *a: None)
    eng.prep_chrom(1)
    jeng.prep_chrom(1)
    st, js = eng.null_state, jeng.bt_state
    assert not st.allow_correction
    for f in ("res", "Y_hat", "gamma_sqrt", "gamma_sqrt_mask"):
        np.testing.assert_allclose(getattr(st, f), getattr(js, f), rtol=1e-9,
                                   atol=1e-12, err_msg=f)
    for a, b in zip(st.X_gamma, js.X_gamma):
        np.testing.assert_allclose(np.abs(a), np.abs(b), rtol=1e-9, atol=1e-12)
    assert eng.model_type() == "ADD-POISSON"
    eng.gd.close()


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA)")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["bed", "bgen"])
def test_cli_on_card_matches_cpu(cuda, tmp_path, name, monkeypatch):
    """The CT CLI on the card: the int8 kernel of its input (fused_i8 or
    bgen_i8) once per block and no other kernel, every field within the
    repository's cross-backend bars of the CPU run's."""
    from chip_smoke import _compare_files
    from regenie_tpu_torch.ops import kernels

    d = str(tmp_path)
    g = WRITERS[name](d, seed=4, N=N, P=3, n_inc=1, n_cov=3, n_remove=5,
                      chroms=((1, 150), (2, 90)))
    _ct_table(d)
    argv = ["--step", "2", *_base(d, _src(name, d, g)), "--bsize", "64",
            "--ignore-pred"]
    for w in kernels.WRAPPERS.values():
        w.launches = 0
    _port(argv + ["--out", f"{d}/gpu"], monkeypatch, device="cuda")
    want = "bgen_i8" if name == "bgen" else "fused_i8"
    counts = {k: w.launches for k, w in kernels.WRAPPERS.items()}
    # 5 blocks of at most 64: 150 variants on chromosome 1, 90 on 2
    assert counts[want] == 5 and sum(counts.values()) == 5, counts
    _port(argv + ["--out", f"{d}/cpu"], monkeypatch)
    for p in (1, 2, 3):
        _compare_files(f"{d}/gpu_Y{p}.regenie", f"{d}/cpu_Y{p}.regenie")
