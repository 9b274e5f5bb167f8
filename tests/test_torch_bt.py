"""Slice tests of Step 2 on binary traits in the PyTorch port
(regenie_tpu_torch, --bt): the CLI on the CPU against the JAX package's
`python -m regenie_tpu` on small synthetic PLINK BED, PGEN (hardcalls and
dosages) and BGEN files and on chrX, for the logistic score test (-LOG),
--spa, --firth --approx, --af-cc and --htp, with --ignore-pred and with
--pred from the JAX package's own Step 1 --bt; and the block functions
and the null-model state against the JAX package's.

- the fused route (the default) against REGENIE_TPU_FUSED=1: byte for
  byte (float64 on both sides);
- the dense route against REGENIE_TPU_FUSED=0: within rel 1e-9 a field.

The binary traits are the writers' quantitative traits thresholded at
their upper quantiles, with the carriers of a few rare variants made
cases, so that the corrections converge on some rows and fail on others.

One test needs an NVIDIA GPU (marker `cuda`): the BT CLI on the card
against the CPU. On the GPU machine, which has no JAX, run it with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_bt.py
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from chip_smoke import (chrx_positions, write_bgen_dataset, write_bt_table,
                        write_dataset, write_pgen_dataset)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 900


def _run(module, args, env_extra, cwd):
    env = dict(os.environ)
    env.update(env_extra)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-m", module] + args, cwd=cwd,
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    return r.stdout


def _bed_codes(prefix, n_var):
    """[n_var, N] genotypes {0, 1, 2, -1 missing} of a writer's BED."""
    raw = np.fromfile(prefix + ".bed", np.uint8)[3:].reshape(n_var, -1)
    codes = np.stack([(raw >> (2 * k)) & 3 for k in range(4)], -1)
    codes = codes.reshape(n_var, -1)[:, :N]
    return np.array([2, -1, 1, 0])[codes]


def _bt_table(d, Y, cases=None):
    write_bt_table(f"{d}/pheno_bt.txt", np.nan_to_num(Y), seed=1, n_inc=1,
                   cases=cases)


def _read_y(d):
    return np.genfromtxt(f"{d}/pheno.txt", skip_header=1, usecols=range(2, 5),
                         missing_values="NA")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Small datasets with binary traits: BED (two chromosomes, rare-variant
    carriers spiked into the cases), BGEN, PGEN hardcalls, PGEN with
    dosage tracks, chrX BED and BGEN; and the JAX package's Step 1 --bt
    on the BED."""
    root = str(tmp_path_factory.mktemp("torch_bt"))
    kw = dict(seed=4, N=N, P=3, n_inc=1, n_cov=3, n_remove=5)
    two = dict(chroms=((1, 150), (2, 90)))
    chrx = dict(chroms=((1, 100), ("X", 120)),
                positions={"X": chrx_positions(120, 20, 20)})
    out = {}
    for name, fn, extra in (("bed", write_dataset, two),
                            ("bgen", write_bgen_dataset, two),
                            ("pgen", write_pgen_dataset, two),
                            ("pgen_dosage", write_pgen_dataset, {**two, "dosage": 0.5}),
                            ("chrx_bed", write_dataset, chrx),
                            ("chrx_bgen", write_bgen_dataset, chrx)):
        d = os.path.join(root, name)
        os.makedirs(d)
        g = fn(d, **kw, **extra)
        cases = None
        if name == "bed":
            # carriers of rare variants made cases: Firth and SPA then
            # converge on some corrected rows and fail on others
            G = _bed_codes(g, 240)
            mac = (G == 1).sum(1) + 2 * (G == 2).sum(1)
            rare = np.flatnonzero((mac > 0) & (mac < 25))[:6]
            cases = np.zeros((N, 3), bool)
            for j, v in enumerate(rare):
                car = np.flatnonzero(G[v] > 0)
                cases[car[: (len(car) + 1) // 2], j % 3] = True
        _bt_table(d, _read_y(d), cases)
        if name.endswith("bgen"):
            src = ["--bgen", g, "--sample", f"{d}/geno.sample"]
        elif name.startswith("pgen"):
            src = ["--pgen", g]
        else:
            src = ["--bed", g]
        out[name] = (d, src)
    d, src = out["bed"]
    _run("regenie_tpu", ["--step", "1", *src, "--phenoFile", f"{d}/pheno_bt.txt",
                         "--covarFile", f"{d}/covar.txt", "--remove",
                         f"{d}/remove.txt", "--bt", "--bsize", "100",
                         "--out", f"{d}/fit"], {"REGENIE_TPU_PLATFORM": "cpu"}, d)
    return out


# name: (dataset, flags, fused route); the pred flag is filled in per test
SCENARIOS = {
    "bed_log": ("bed", [], True),
    "bed_spa_htp": ("bed", ["--spa", "--htp", "T"], True),
    "bed_firth_afcc": ("bed", ["--firth", "--approx", "--pThresh", "0.01",
                               "--af-cc"], True),
    "bed_firth_pred": ("bed", ["--firth", "--approx", "PRED"], True),
    "bed_spa_reffirst_rec_nosplit": ("bed", ["--spa", "--ref-first", "--test",
                                             "recessive", "--no-split"], True),
    "bed_spa_pred_dense": ("bed", ["--spa", "PRED"], False),
    "bed_firth_afcc_htp_dense": ("bed", ["--firth", "--approx", "--af-cc",
                                         "--htp", "T"], False),
    "bgen_firth_afcc": ("bgen", ["--firth", "--approx", "--af-cc"], True),
    "bgen_spa_htp": ("bgen", ["--spa", "--htp", "T"], False),
    "pgen_spa": ("pgen", ["--spa"], True),
    "pgen_dosage_firth": ("pgen_dosage", ["--firth", "--approx"], False),
    "chrx_bed_spa_htp": ("chrx_bed", ["--spa", "--htp", "T"], True),
    "chrx_bgen_firth_afcc": ("chrx_bgen", ["--firth", "--approx", "--af-cc"],
                             True),
}


def _outputs(out, flags):
    if "--no-split" in flags:
        return [f"{out}.regenie"]
    return [f"{out}_Y{p}.regenie" for p in (1, 2, 3)]


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


def _common(d, src, flags):
    flags = [f"--pred={d}/fit_pred.list" if a == "PRED" else a for a in flags]
    if not any(a.startswith("--pred") for a in flags):
        flags = flags + ["--ignore-pred"]
    return ["--step", "2", *src, "--phenoFile", f"{d}/pheno_bt.txt",
            "--covarFile", f"{d}/covar.txt", "--remove", f"{d}/remove.txt",
            "--bsize", "64", "--bt", *flags]


def _jax(argv, monkeypatch, fused):
    from regenie_tpu import cli as jcli

    monkeypatch.setenv("REGENIE_TPU_PLATFORM", "cpu")
    monkeypatch.setenv("REGENIE_TPU_FUSED", "1" if fused else "0")
    jcli.main(argv)
    return open(argv[-1] + ".log").read()


def _port(argv, monkeypatch, fused, device="cpu"):
    from regenie_tpu_torch import cli
    from regenie_tpu_torch.utils.device import DEVICE_ENV

    monkeypatch.setenv(DEVICE_ENV, device)
    if fused:
        monkeypatch.delenv("REGENIE_TPU_FUSED", raising=False)
    else:
        monkeypatch.setenv("REGENIE_TPU_FUSED", "0")
    cli.main(argv)
    return open(argv[-1] + ".log").read()


def _counts(log):
    return [ln for ln in log.splitlines()
            if "correction :" in ln or "failed tests" in ln]


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_cli_matches_jax(data, scenario, monkeypatch):
    """The port's BT CLI on the CPU against the JAX package's: the fused
    route byte for byte against REGENIE_TPU_FUSED=1, the dense route
    within rel 1e-9 against REGENIE_TPU_FUSED=0; the same corrected and
    failed counts in the logs."""
    name, flags, fused = SCENARIOS[scenario]
    d, src = data[name]
    argv = _common(d, src, flags)
    jx, pt = f"{d}/jax_{scenario}", f"{d}/pt_{scenario}"
    jlog = _jax(argv + ["--out", jx], monkeypatch, fused)
    plog = _port(argv + ["--out", pt], monkeypatch, fused)
    assert ("fused packed-bytes scorer on cpu" if fused
            else "dense scorer on cpu") in plog
    assert _counts(jlog) == _counts(plog)
    if "--firth" in flags or "--spa" in flags:
        assert int(_counts(plog)[0].split(":")[1]) > 0
    for f in _outputs(pt, flags):
        g = f.replace(pt, jx)
        if fused:
            assert open(f, "rb").read() == open(g, "rb").read(), f
        else:
            _assert_rows_close(g, f)
    if "--af-cc" in flags and "--htp" not in flags:
        assert "A1FREQ_CASES" in open(_outputs(pt, flags)[0]).readline()


def test_corrections_fail_and_converge(data, monkeypatch):
    """On the spiked BED, SPA fails on some corrected rows and converges
    on others, and both packages print TEST_FAIL on the same rows."""
    d, src = data["bed"]
    argv = _common(d, src, ["--spa", "--pThresh", "0.2"])
    line = _counts(_port(argv + ["--out", f"{d}/pt_fail"], monkeypatch, True))[1]
    failed, corrected = (int(x) for x in line.split("(")[1].rstrip(")").split("/"))
    assert 0 < failed < corrected
    _jax(argv + ["--out", f"{d}/jax_fail"], monkeypatch, True)
    texts = [open(f"{d}/pt_fail_Y{p}.regenie").read() for p in (1, 2, 3)]
    assert sum(t.count("TEST_FAIL") for t in texts) == failed
    for p, t in zip((1, 2, 3), texts):
        assert t == open(f"{d}/jax_fail_Y{p}.regenie").read()


def _engines(data, name, flags):
    """(port engine, JAX engine) at the first block, on the CPU."""
    from regenie_tpu import cli as jcli
    from regenie_tpu.prep import prepare as jprepare
    from regenie_tpu.run_step2 import Step2Engine as JEngine
    from regenie_tpu_torch import cli
    from regenie_tpu_torch.run_step2 import open_engine

    d, src = data[name]
    argv = _common(d, src, flags) + ["--out", f"{d}/eng"]
    eng, blocks = open_engine(cli.args_to_params(cli.build_parser().parse_args(argv)),
                              log=lambda *a: None, device="cpu")
    jp = jcli.args_to_params(jcli.build_parser().parse_args(argv))
    jp.test_mode = True
    rd = jprepare(jp, log=lambda *a: None)
    jeng = JEngine(jp, rd.geno, rd.pheno, None, lambda *a: None)
    return eng, blocks, jeng


def test_null_state_and_block_fn_match_jax(data, monkeypatch):
    """prep_chromosome's state (residuals, weights, the covariate bases,
    the null Firth offsets) and the fused BT block function's outputs
    against the JAX package's on the first block, within 1e-9."""
    monkeypatch.setenv("REGENIE_TPU_PLATFORM", "cpu")
    monkeypatch.setenv("REGENIE_TPU_FUSED", "1")
    from regenie_tpu.utils.dtypes import enable_x64_if_cpu

    enable_x64_if_cpu()
    eng, blocks, jeng = _engines(data, "bed", ["--firth", "--approx"])
    chrom, bsnps = blocks[0]
    eng.prep_chrom(chrom)
    jeng.prep_chrom(chrom)
    st, js = eng.null_state, jeng.bt_state
    for f in ("res", "Y_hat", "gamma_sqrt", "gamma_sqrt_mask", "firth_offset",
              "bhat_start", "eta_null"):
        np.testing.assert_allclose(getattr(st, f), getattr(js, f), rtol=1e-9,
                                   atol=1e-12, err_msg=f)
    for a, b in zip(st.X_gamma, js.X_gamma):
        np.testing.assert_allclose(np.abs(a), np.abs(b), rtol=1e-9, atol=1e-12)
    eng._ensure_fused_consts()
    jeng._ensure_fused_consts()
    raw = eng.read_block_raw(bsnps)
    got = eng._fused_fn(eng._fused_upload(raw))
    from regenie_tpu.ops import fused_score as jfs

    want = jeng._fused_fn(jfs.pad_raw(raw, jfs.op_nbp(jeng._fused_bt.Wp)))
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy().astype(np.float64),
                                   np.asarray(w, np.float64), rtol=1e-9, atol=1e-9)
    eng.gd.close()


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA)")


@pytest.mark.cuda
@pytest.mark.parametrize("scenario", ["bed_firth_afcc", "bgen_firth_afcc",
                                      "bed_spa_htp", "chrx_bed_spa_htp"])
def test_cli_on_card_matches_cpu(cuda, tmp_path, scenario):
    """The BT CLI on the card (int8 operand, corrections on the card)
    against the CPU: LOG10P within 1e-5, BETA within 1e-6, every other
    field within rel 1e-9 or one printed digit."""
    from chip_smoke import _compare_files

    name, flags, _ = SCENARIOS[scenario]
    d = str(tmp_path)
    kw = dict(seed=4, N=N, P=3, n_inc=1, n_cov=3, n_remove=5)
    if name.startswith("chrx"):
        g = write_dataset(d, **kw, chroms=((1, 100), ("X", 120)),
                          positions={"X": chrx_positions(120, 20, 20)})
        src = ["--bed", g]
    elif name == "bgen":
        g = write_bgen_dataset(d, **kw, chroms=((1, 150), (2, 90)))
        src = ["--bgen", g, "--sample", f"{d}/geno.sample"]
    else:
        g = write_dataset(d, **kw, chroms=((1, 150), (2, 90)))
        src = ["--bed", g]
    _bt_table(d, _read_y(d))
    argv = _common(d, src, flags)
    _run("regenie_tpu_torch", argv + ["--out", f"{d}/gpu"], {}, d)
    _run("regenie_tpu_torch", argv + ["--out", f"{d}/cpu"],
         {"REGENIE_TPU_TORCH_DEVICE": "cpu"}, d)
    for f in _outputs(f"{d}/gpu", flags):
        _compare_files(f, f.replace(f"{d}/gpu", f"{d}/cpu"))
