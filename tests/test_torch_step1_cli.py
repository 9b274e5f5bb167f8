"""Slice tests of the port's Step-1 QT CLI (python -m regenie_tpu_torch
--step 1) on a synthetic PLINK BED, on the CPU, against the JAX package's
python -m regenie_tpu --step 1 (both in this process, float64):

- the .loco files: same header, row count and NA pattern, every value
  equal or within one unit of its sixth significant digit (the two
  packages' eigh and matmul round differently in the last bits);
- the split-l0 protocol across the packages, and the port's split run
  against its own monolithic run;
- the two-step workflow: the port's Step 2 on the port's _pred.list
  against the JAX package's fused Step 2 on JAX's.

One test needs an NVIDIA GPU (marker `cuda`): the same runs on the card
against the CPU. On the GPU machine, which has no JAX, run it with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_step1_cli.py
"""

import math
import os

import numpy as np
import pytest

from chip_smoke import write_dataset

LOG10P_TOL, BETA_TOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_step1"))
    prefix = write_dataset(d, seed=7, N=600, chroms=((1, 200), (2, 100)),
                           P=3, n_inc=1, n_cov=3, na_rate=0.1,
                           n_remove=5, effect_sd=1.0)
    with open(f"{d}/keep.txt", "w") as fh:
        fh.write("".join(f"F{i} I{i}\n" for i in range(600) if i % 9))
    with open(f"{d}/exclude.txt", "w") as fh:
        fh.write("".join(f"v{j}\n" for j in range(3, 300, 13)))
    return d, prefix


def _common(d, prefix):
    return ["--step", "1", "--bed", prefix, "--phenoFile", f"{d}/pheno.txt",
            "--covarFile", f"{d}/covar.txt", "--remove", f"{d}/remove.txt",
            "--bsize", "100"]


def _port(argv, monkeypatch, device="cpu"):
    from regenie_tpu_torch import cli
    from regenie_tpu_torch.utils.device import DEVICE_ENV

    monkeypatch.setenv(DEVICE_ENV, device)
    cli.main(argv)


def _jax(argv, monkeypatch, fused=False):
    from regenie_tpu import cli as jcli

    monkeypatch.setenv("REGENIE_TPU_PLATFORM", "cpu")
    if fused:
        monkeypatch.setenv("REGENIE_TPU_FUSED", "1")
    jcli.main(argv)


def _sig6_unit(x: float) -> float:
    """One unit of the sixth significant digit of x."""
    return 10.0 ** (math.floor(math.log10(abs(x))) - 5) if x else 0.0


def assert_loco_equiv(f, g):
    """Same header, row count and NA pattern; every value equal or within
    one unit of its sixth significant digit. Returns whether the files
    are byte-identical."""
    la = open(f).read().splitlines()
    lb = open(g).read().splitlines()
    assert la[0] == lb[0]
    assert len(la) == len(lb), (f, len(la), len(lb))
    for ra, rb in zip(la[1:], lb[1:]):
        ta, tb = ra.split(), rb.split()
        assert len(ta) == len(tb) and ta[0] == tb[0]
        for xa, xb in zip(ta[1:], tb[1:]):
            if xa == xb:
                continue
            fa, fb = float(xa), float(xb)  # raises on an NA mismatch
            unit = max(_sig6_unit(fa), _sig6_unit(fb))
            assert abs(fa - fb) <= unit * (1 + 1e-9), (xa, xb)
    return open(f, "rb").read() == open(g, "rb").read()


def _loco_files(out, n=3):
    return [f"{out}_{i}.loco" for i in range(1, n + 1)]


def _check_pred_list(out, names):
    rows = [ln.split() for ln in open(f"{out}_pred.list").read().splitlines()]
    assert [r[0] for r in rows] == names
    for r in rows:
        assert os.path.isfile(r[1])


SCENARIOS = {
    "kfold": [],
    "loocv": ["--loocv"],
    "options": ["--cv", "4", "--l0", "3", "--setl1", "0.1,0.5,0.9",
                "--print-prs", "--lowmem", "--keep-l0", "--force-step1"],
    "filters": ["--keep", "keep.txt", "--exclude", "exclude.txt",
                "--phenoColList", "Y1,Y3", "--ref-first", "--loocv"],
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_cli_matches_jax(dataset, scenario, monkeypatch):
    """The port's Step 1 on the CPU writes the JAX package's .loco files
    (and with --print-prs its .prs files) within one unit of the sixth
    significant digit; --lowmem --keep-l0 keeps the same level-0 spill."""
    d, prefix = dataset
    extra = [f"{d}/{a}" if a.endswith(".txt") else a for a in SCENARIOS[scenario]]
    jx, pt = f"{d}/jax_{scenario}", f"{d}/pt_{scenario}"
    if "--lowmem" in extra:
        extra = extra + ["--lowmem-prefix", "LM"]
    _jax(_common(d, prefix) + [a.replace("LM", jx + "_lm") for a in extra]
         + ["--out", jx], monkeypatch)
    _port(_common(d, prefix) + [a.replace("LM", pt + "_lm") for a in extra]
          + ["--out", pt], monkeypatch)
    n = 2 if scenario == "filters" else 3
    files = _loco_files(pt, n)
    if "--print-prs" in extra:
        files += [f"{pt}_{i}.prs" for i in range(1, n + 1)]
    identical = [assert_loco_equiv(f.replace(pt, jx), f) for f in files]
    with open(files[0]) as fh:
        assert fh.readline().startswith("FID_IID ")
        rows = fh.read().splitlines()
    assert len(rows) == 23 and [r.split()[0] for r in rows] == [str(c) for c in range(1, 24)]
    _check_pred_list(pt, ["Y1", "Y3"] if scenario == "filters" else ["Y1", "Y2", "Y3"])
    if "--lowmem" in extra:
        # JAX spills [K, nmax, F, P]; the port block-major [nb, K, nmax, J, P]
        a, b = (np.fromfile(f"{o}_lm_l0_preds.bin") for o in (jx, pt))
        K, J, P = 4, 3, 3
        b = b.reshape(3, K, -1, J, P).transpose(1, 2, 0, 3, 4).reshape(K, -1, 3 * J, P)
        np.testing.assert_allclose(b.reshape(-1), a, rtol=0, atol=1e-9)
    print(f"{scenario}: byte-identical files = {sum(identical)} of {len(identical)}")


@pytest.mark.parametrize("flag", ["--no-split", "--write-samples"])
def test_step2_only_flags_run(dataset, flag, monkeypatch):
    """--no-split and --write-samples concern Step 2 only: Step 1 runs
    with either and writes the JAX package's .loco files byte for byte."""
    d, prefix = dataset
    jx, pt = f"{d}/jax_flag{flag}", f"{d}/pt_flag{flag}"
    _jax(_common(d, prefix) + [flag, "--out", jx], monkeypatch)
    _port(_common(d, prefix) + [flag, "--out", pt], monkeypatch)
    for f in _loco_files(pt):
        assert open(f, "rb").read() == open(f.replace(pt, jx), "rb").read(), f
    _check_pred_list(pt, ["Y1", "Y2", "Y3"])


@pytest.mark.parametrize("mode", ["kfold", "loocv"])
def test_split_l0_protocol(dataset, mode, monkeypatch, tmp_path):
    """--split-l0 / --run-l0 / --run-l1: the master file and .snplist files
    are byte-identical to the JAX package's, the port's job files within
    1e-9 of JAX's, the port's --run-l1 on JAX's job files gives JAX's
    .loco files (the state carried across the packages), and the port's
    split run is byte-identical to its own monolithic run."""
    d, prefix = dataset
    common = _common(d, prefix) + (["--loocv"] if mode == "loocv" else [])
    runs = {}
    for who, run in (("jax", _jax), ("pt", _port)):
        w = tmp_path / who
        w.mkdir()
        monkeypatch.chdir(w)  # the master file names its jobs by relative prefix
        run(common + ["--split-l0", "s,2", "--out", "m"], monkeypatch)
        for j in (1, 2):
            run(common + ["--run-l0", f"s.master,{j}", "--out", f"j{j}"], monkeypatch)
        run(common + ["--run-l1", "s.master", "--out", "l1"], monkeypatch)
        runs[who] = w
    jw, pw = runs["jax"], runs["pt"]
    for name in ("s.master", "s_job1.snplist", "s_job2.snplist"):
        assert (pw / name).read_bytes() == (jw / name).read_bytes(), name
    assert (pw / "s.master").read_text().splitlines()[1:] == ["s_job1 2 200",
                                                              "s_job2 1 100"]
    for j in (1, 2):
        for ph in (1, 2, 3):
            a = np.fromfile(jw / f"s_job{j}_l0_Y{ph}")
            b = np.fromfile(pw / f"s_job{j}_l0_Y{ph}")
            assert a.shape == b.shape and a.size > 0
            assert np.max(np.abs(a - b)) <= 1e-9
    # the port's level 1 on JAX's level-0 job files
    monkeypatch.chdir(jw)
    _port(common + ["--run-l1", "s.master", "--out", str(pw / "x")], monkeypatch)
    # the port's monolithic run
    _port(common + ["--out", str(pw / "mono")], monkeypatch)
    for f in _loco_files(str(jw / "l1")):
        assert_loco_equiv(f, f.replace(str(jw / "l1"), str(pw / "x")))
        assert_loco_equiv(f, f.replace(str(jw / "l1"), str(pw / "l1")))
    for f in _loco_files(str(pw / "mono")):
        assert open(f, "rb").read() == open(f.replace("mono", "l1"), "rb").read()


def test_loocv_group_out_of_memory_falls_back(dataset, monkeypatch):
    """A batched LOOCV group that runs out of device memory is solved one
    block at a time, says so in the log, and writes the same .loco files;
    no other exception is caught."""
    import torch

    from regenie_tpu_torch.models import step1 as tm1

    d, prefix = dataset
    common = _common(d, prefix) + ["--loocv"]
    _port(common + ["--out", f"{d}/oom_ref"], monkeypatch)
    grouped = tm1.level0_loocv_blocks

    def out_of_memory(G3, *args):
        if G3.shape[0] > 1:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (test)")
        return grouped(G3, *args)

    monkeypatch.setattr(tm1, "level0_loocv_blocks", out_of_memory)
    _port(common + ["--out", f"{d}/oom"], monkeypatch)
    assert "ran out of device memory" in open(f"{d}/oom.log").read()
    for f in _loco_files(f"{d}/oom"):
        assert open(f, "rb").read() == open(f.replace("oom", "oom_ref"), "rb").read()

    def broken(G3, *args):
        raise RuntimeError("not a memory fault")

    monkeypatch.setattr(tm1, "level0_loocv_blocks", broken)
    with pytest.raises(RuntimeError, match="not a memory fault"):
        _port(common + ["--out", f"{d}/broken"], monkeypatch)


@pytest.mark.parametrize("mode", ["kfold", "loocv"])
def test_two_step_matches_jax(dataset, mode, monkeypatch):
    """The two-step QT workflow: the port's Step 2 with --pred on the
    port's own _pred.list against the JAX package's fused Step 2 on JAX's:
    same rows and NA pattern, max |dLOG10P| <= 1e-5, max |dBETA| <= 1e-6."""
    d, prefix = dataset
    s1 = _common(d, prefix) + (["--loocv"] if mode == "loocv" else [])
    jx, pt = f"{d}/ts_jax_{mode}", f"{d}/ts_pt_{mode}"
    _jax(s1 + ["--out", jx + "_s1"], monkeypatch)
    _port(s1 + ["--out", pt + "_s1"], monkeypatch)
    s2 = ["--step", "2", "--bed", prefix, "--phenoFile", f"{d}/pheno.txt",
          "--covarFile", f"{d}/covar.txt", "--remove", f"{d}/remove.txt",
          "--bsize", "128"]
    _jax(s2 + ["--pred", jx + "_s1_pred.list", "--out", jx], monkeypatch, fused=True)
    _port(s2 + ["--pred", pt + "_s1_pred.list", "--out", pt], monkeypatch)
    worst = compare_regenie([f"{jx}_Y{p}.regenie" for p in (1, 2, 3)],
                            [f"{pt}_Y{p}.regenie" for p in (1, 2, 3)])
    print(f"{mode}: max |dLOG10P| {worst['LOG10P']:.3e}, max |dBETA| {worst['BETA']:.3e}")


def compare_regenie(files_a, files_b):
    """Same header, row count and NA pattern; LOG10P within 1e-5 and
    BETA within 1e-6 absolute, every other field equal or within rel
    1e-5. Returns the largest LOG10P and BETA gaps."""
    worst = {"LOG10P": 0.0, "BETA": 0.0}
    for fa, fb in zip(files_a, files_b):
        la = open(fa).read().splitlines()
        lb = open(fb).read().splitlines()
        assert la[0] == lb[0] and len(la) == len(lb) > 1, (fa, fb)
        names = la[0].split()
        for ra, rb in zip(la[1:], lb[1:]):
            for name, xa, xb in zip(names, ra.split(), rb.split()):
                if xa == xb:
                    continue
                a, b = float(xa), float(xb)
                gap = abs(a - b)
                if name in worst:
                    worst[name] = max(worst[name], gap)
                    assert gap <= (LOG10P_TOL if name == "LOG10P" else BETA_TOL), (name, ra, rb)
                else:
                    assert gap <= 1e-5 * max(abs(a), abs(b)), (name, ra, rb)
    return worst


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["kfold", "loocv"])
def test_cli_on_card_matches_cpu(cuda, dataset, mode, monkeypatch):
    """The port's Step 1 on the card (float64, cuBLAS and cuSOLVER) against
    the same run on the CPU, under the rule of test_cli_matches_jax, and
    no hand-written kernel launches on the way."""
    from regenie_tpu_torch.ops import kernels

    d, prefix = dataset
    common = _common(d, prefix) + (["--loocv"] if mode == "loocv" else [])
    for w in kernels.WRAPPERS.values():
        w.launches = 0
    _port(common + ["--out", f"{d}/card_{mode}"], monkeypatch, device="cuda")
    assert all(w.launches == 0 for w in kernels.WRAPPERS.values())
    _port(common + ["--out", f"{d}/cpu_{mode}"], monkeypatch)
    assert "level 0 on cuda" in open(f"{d}/card_{mode}.log").read()
    for f in _loco_files(f"{d}/cpu_{mode}"):
        assert_loco_equiv(f, f.replace("cpu_", "card_"))
