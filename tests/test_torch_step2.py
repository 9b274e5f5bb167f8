"""Slice tests of the PyTorch port (regenie_tpu_torch): the Step-2 QT CLI
on a synthetic PLINK BED against the JAX package's fused path on the CPU,
the no-jax import guarantee, and the device policy."""

import glob
import os
import subprocess
import sys

import pytest

from chip_smoke import write_bgen_dataset, write_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(module, args, env_extra, cwd):
    env = dict(os.environ)
    env.update(env_extra)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-m", module] + args, cwd=cwd,
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    return r.stdout


def _assert_rows_equiv(f, g, rtol=1e-9):
    """Same header, row count and NA pattern; every numeric field equal
    within rtol (the rule of tests/test_fused_score.py:585). Returns
    whether the files are byte-identical."""
    la = open(f).read().splitlines()
    lb = open(g).read().splitlines()
    assert len(la) == len(lb), (f, len(la), len(lb))
    assert la[0] == lb[0]
    for ra, rb in zip(la[1:], lb[1:]):
        ta, tb = ra.replace(";", " ").replace("=", " ").split(), \
            rb.replace(";", " ").replace("=", " ").split()
        assert len(ta) == len(tb), (ra, rb)
        for xa, xb in zip(ta, tb):
            if xa == xb:
                continue
            fa, fb = float(xa), float(xb)  # raises on an NA mismatch
            assert abs(fa - fb) <= rtol * max(1.0, abs(fa)), (ra, rb)
    return open(f, "rb").read() == open(g, "rb").read()


def _tiny_dataset(tmp_path):
    return write_dataset(str(tmp_path), seed=0, N=40, chroms=((1, 8),), P=3,
                         n_inc=1, n_cov=3)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_step2"))
    prefix = write_dataset(d, seed=7, N=600, chroms=((1, 200), (2, 100)),
                           P=3, n_inc=1, n_cov=3, na_rate=0.1,
                           n_remove=5, effect_sd=1.0)
    # LOCO predictions from the JAX Step 1 on the same data
    _run("regenie_tpu", [
        "--step", "1", "--bed", prefix, "--phenoFile", f"{d}/pheno.txt",
        "--covarFile", f"{d}/covar.txt", "--remove", f"{d}/remove.txt",
        "--bsize", "100", "--out", f"{d}/fit"],
        {"REGENIE_TPU_PLATFORM": "cpu"}, d)
    return d, prefix


@pytest.mark.parametrize("scenario", ["plain", "htp", "minmac", "pred",
                                      "ref_first_dom", "rec_strict"])
def test_cli_matches_jax_fused(dataset, scenario):
    """The port's CLI on the CPU writes the same rows as the JAX package's
    fused path on the CPU: same header, row count and NA pattern, numeric
    fields within rel 1e-9 (float64 on both sides; the products differ
    only in matmul summation order)."""
    d, prefix = dataset
    common = ["--step", "2", "--bed", prefix, "--phenoFile", f"{d}/pheno.txt",
              "--covarFile", f"{d}/covar.txt", "--remove", f"{d}/remove.txt",
              "--bsize", "170"]
    extra = {"plain": ["--ignore-pred"],
             "htp": ["--ignore-pred", "--htp", "X"],
             "minmac": ["--ignore-pred", "--minMAC", "20"],
             "pred": ["--pred", f"{d}/fit_pred.list"],
             "ref_first_dom": ["--ignore-pred", "--ref-first", "--test",
                               "dominant"],
             "rec_strict": ["--ignore-pred", "--test", "recessive",
                            "--strict"]}[scenario]
    jx, pt = f"{d}/jax_{scenario}", f"{d}/pt_{scenario}"
    out = _run("regenie_tpu", common + extra + ["--out", jx],
               {"REGENIE_TPU_PLATFORM": "cpu", "REGENIE_TPU_FUSED": "1"}, d)
    assert "fused packed-bytes scorer active" in out
    out = _run("regenie_tpu_torch", common + extra + ["--out", pt],
               {"REGENIE_TPU_TORCH_DEVICE": "cpu"}, d)
    assert "fused packed-bytes scorer on cpu" in out
    identical = []
    for ph in ("Y1", "Y2", "Y3"):
        f, g = f"{jx}_{ph}.regenie", f"{pt}_{ph}.regenie"
        identical.append(_assert_rows_equiv(f, g))
    n_rows = len(open(f"{pt}_Y1.regenie").read().splitlines()) - 1
    assert 200 < n_rows <= 300
    if scenario == "minmac":
        assert n_rows < 300  # the rare variants fall under --minMAC 20
    print(f"{scenario}: byte-identical per trait = {identical}")


def test_port_imports_no_jax():
    """The port and its run_step1 / run_step2 / models / ops modules import
    with jax made unimportable, and pull in no regenie_tpu module."""
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import regenie_tpu_torch, regenie_tpu_torch.run_step2, "
        "regenie_tpu_torch.run_step1, regenie_tpu_torch.models.step1, "
        "regenie_tpu_torch.ops.geno_ops, "
        "regenie_tpu_torch.cli, regenie_tpu_torch.ops.fused_score, "
        "regenie_tpu_torch.ops.kernels, regenie_tpu_torch.ops.pallas_ops, "
        "regenie_tpu_torch.io.bgen, regenie_tpu_torch.io.pgen, "
        "regenie_tpu_torch.io.native, regenie_tpu_torch.io.geno, "
        "regenie_tpu_torch.models.step2, regenie_tpu_torch.prep, "
        "regenie_tpu_torch.models.step2_bt, regenie_tpu_torch.models.glm, "
        "regenie_tpu_torch.models.firth, regenie_tpu_torch.models.spa, "
        "regenie_tpu_torch.models.corrections_device, "
        "regenie_tpu_torch.models.step1_bt, regenie_tpu_torch.models.step2_ct, "
        "regenie_tpu_torch.models.step2_t2e, regenie_tpu_torch.models.survival, "
        "regenie_tpu_torch.scripts.profile_fused, "
        "regenie_tpu_torch.scripts.profile_bgen, "
        "regenie_tpu_torch.run_genebased, regenie_tpu_torch.io.setfiles, "
        "regenie_tpu_torch.io.bgzf, regenie_tpu_torch.io.remeta, "
        "regenie_tpu_torch.models.masks, regenie_tpu_torch.models.skat, "
        "regenie_tpu_torch.models.joint, regenie_tpu_torch.ops.vc_batch, "
        "regenie_tpu_torch.utils.quadforms, regenie_tpu_torch.models.interaction, "
        "regenie_tpu_torch.models.mcc, regenie_tpu_torch.models.multitrait, "
        "regenie_tpu_torch.models.multiphen, regenie_tpu_torch.parallel, "
        "regenie_tpu_torch.parallel.mesh, regenie_tpu_torch.parallel.dist\n"
        "from regenie_tpu_torch.io import native\n"
        "lib = native.planes_lib()\n"
        "assert hasattr(lib, native.DOSAGES_SYMBOL)\n"
        "native.loco_lib()\n"
        "lib = native.pgen_lib()\n"
        "assert hasattr(lib, native.PGEN_DOSAGES_SYMBOL)\n"
        "bad = sorted(m for m in sys.modules if m == 'regenie_tpu' "
        "or m.startswith('regenie_tpu.'))\n"
        "assert not bad, bad\n"
        "assert sys.modules['jax'] is None\n"
        "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


def test_port_sources_import_no_jax():
    """No import statement anywhere in the port or chip_smoke.py, lazy
    ones inside functions included, names jax or regenie_tpu."""
    import ast
    import glob

    files = glob.glob(os.path.join(REPO, "regenie_tpu_torch", "**", "*.py"),
                      recursive=True) + [os.path.join(REPO, "chip_smoke.py")]
    assert len(files) > 15
    for path in files:
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "regenie_tpu"), (path, name)


def test_entry_point_raises_without_cuda(tmp_path, monkeypatch):
    """With no CUDA device and no CPU request, the entry point raises
    before doing any work; asking for the CPU runs."""
    import torch

    from regenie_tpu_torch.utils.device import DEVICE_ENV, resolve_device

    monkeypatch.delenv(DEVICE_ENV, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"
    monkeypatch.setenv(DEVICE_ENV, "cpu")
    assert resolve_device().type == "cpu"
    prefix = _tiny_dataset(tmp_path)
    monkeypatch.delenv(DEVICE_ENV)
    from regenie_tpu_torch import cli

    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--step", "2", "--bed", prefix, "--phenoFile",
                  f"{tmp_path}/pheno.txt", "--ignore-pred",
                  "--out", f"{tmp_path}/o"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--step", "1", "--bed", prefix, "--phenoFile",
                  f"{tmp_path}/pheno.txt", "--bsize", "4",
                  "--out", f"{tmp_path}/s1"])
    assert not os.path.exists(f"{tmp_path}/s1_pred.list")


@pytest.mark.parametrize("flags", [["--step", "1"], ["bgen", "--bt"]])
def test_formerly_refused_2d_mesh_runs(tmp_path, monkeypatch, flags):
    """REGENIE_TPU_MESH_2D on a mesh of two CPU shards, which the port
    refused until the 2-D mesh was ported, runs where the JAX package runs
    and keeps the 1-D mesh where the JAX package keeps it: Step 1 on a 1 x
    2 grid (one variant row: the 1-D sample-sharded level 0) and Step 2 on
    a BGEN (the 1-D variant mesh) write the 1-D mesh run's files byte for
    byte. Flags after "bgen" run on a BGEN input; flags without --step run
    Step 2. tests/test_torch_mesh2d_cli.py holds both against the JAX
    package's runs."""
    from test_torch_mesh_cli import _tables

    from regenie_tpu_torch import cli

    if flags[0] == "bgen":
        flags = flags[1:]
        bgen = write_bgen_dataset(str(tmp_path), seed=0, N=40, chroms=((1, 8),), P=3,
                                  n_inc=1, n_cov=3)
        src = ["--bgen", bgen, "--sample", f"{tmp_path}/geno.sample"]
    else:
        src = ["--bed", _tiny_dataset(tmp_path)]
    # the binary traits' table: the QT table's traits thresholded
    _tables(str(tmp_path))
    table = "pheno_bt.txt" if "--bt" in flags else "pheno.txt"
    argv = src + ["--phenoFile", f"{tmp_path}/{table}", "--covarFile",
                  f"{tmp_path}/covar.txt", "--bsize", "4"] + flags
    step2 = "--step" not in flags
    if step2:
        argv = ["--step", "2", "--ignore-pred"] + argv
    outs, logs = {}, {}
    for tag, m2d in (("m1", False), ("m2", True)):
        _mesh_env(monkeypatch, 2, m2d)
        cli.main(argv + ["--out", f"{tmp_path}/{tag}"])
        logs[tag] = open(f"{tmp_path}/{tag}.log").read()
        outs[tag] = {f[len(f"{tmp_path}/{tag}"):]: open(f, "rb").read() for f in
                     glob.glob(f"{tmp_path}/{tag}_*.regenie")
                     + glob.glob(f"{tmp_path}/{tag}_*.loco")}
    assert "multi-device mesh: 2 shards" in logs["m2"]
    # Step 2 builds the grid and keeps the 1-D mesh on the BGEN route; Step
    # 1 builds none on a grid of one variant row
    assert ("2-D mesh for the fused scorer: 1 x 2" in logs["m2"]) == step2
    assert "2-D mesh:" not in logs["m2"]
    assert outs["m1"] and outs["m2"] == outs["m1"]


@pytest.mark.parametrize("step", ["1", "2"])
@pytest.mark.parametrize("flags", [
    ["--mt", "--strict", "--no-split"], ["--multiphen", "--strict"],
    ["--compute-corr"], ["--mcc"], ["--af-cc"], ["--af-cc", "--bt"],
    ["--af-cc", "--ct"],
    ["--af-cc", "--t2e", "--phenoColList", "T1", "--eventColList", "E1"],
])
def test_ported_modes_are_not_refused(monkeypatch, step, flags):
    """cli.unported names none of the modes ported since: multi-trait
    tests, MultiPhen, LD mode, MCC and --af-cc on every trait type, in
    either step under REGENIE_TPU_MESH too (the single-process mesh; on
    one device the single-device run, as in the JAX package), and with a
    multi-process variable set."""
    from regenie_tpu_torch import cli

    for var in ("REGENIE_TPU_COORDINATOR", "REGENIE_TPU_DIST",
                "REGENIE_TPU_MESH", "REGENIE_TPU_MESH_2D"):
        monkeypatch.delenv(var, raising=False)
    argv = ["--step", step, "--bed", "g", "--phenoFile", "p.txt",
            "--ignore-pred", "--out", "o"] + flags
    params = cli.args_to_params(cli.build_parser().parse_args(argv))
    assert cli.unported(params) is None
    monkeypatch.setenv("REGENIE_TPU_MESH", "1")
    params = cli.args_to_params(cli.build_parser().parse_args(argv))
    assert cli.unported(params) is None
    # nor a multi-process launch (its processes join their group in
    # cli.main, before this check)
    monkeypatch.setenv("REGENIE_TPU_COORDINATOR", "localhost:23456")
    monkeypatch.setenv("REGENIE_TPU_DIST", "1")
    assert cli.unported(params) is None


@pytest.mark.parametrize("step", ["1", "2"])
def test_unported_names_other_step2_inputs(monkeypatch, step):
    """A Step-2 input other than BED, BGEN or PGEN is refused by name (the
    CLI's flags reach only those three, so the input type is forced
    here); Step 1 takes no such gate."""
    from regenie_tpu_torch import cli
    from regenie_tpu_torch.config import Params

    for var in ("REGENIE_TPU_COORDINATOR", "REGENIE_TPU_DIST",
                "REGENIE_TPU_MESH_2D"):
        monkeypatch.delenv(var, raising=False)
    argv = ["--step", step, "--bed", "g", "--phenoFile", "p.txt",
            "--ignore-pred", "--out", "o"]
    params = cli.args_to_params(cli.build_parser().parse_args(argv))
    monkeypatch.setattr(Params, "file_type", property(lambda self: "vcf"))
    assert cli.unported(params) == (None if step == "1" else "VCF input")


def _mesh_env(monkeypatch, shards, mesh_2d=False):
    from regenie_tpu_torch.utils.device import DEVICE_ENV

    monkeypatch.setenv(DEVICE_ENV, "cpu")
    for var in ("REGENIE_TPU_MESH", "REGENIE_TPU_TORCH_MESH_DEVICES",
                "REGENIE_TPU_MESH_2D"):
        monkeypatch.delenv(var, raising=False)
    if shards:
        monkeypatch.setenv("REGENIE_TPU_MESH", "1")
        monkeypatch.setenv("REGENIE_TPU_TORCH_MESH_DEVICES",
                           ",".join(["cpu"] * shards))
    if mesh_2d:
        monkeypatch.setenv("REGENIE_TPU_MESH_2D", "2x1")


@pytest.mark.parametrize("loocv", [False, True])
def test_step1_mesh_matches_unsharded(tmp_path, monkeypatch, loocv):
    """Step 1 under REGENIE_TPU_MESH runs on the CPU mesh (3 shards: N = 40
    divides by none) and writes the unsharded run's .loco files; on one
    device (REGENIE_TPU_MESH set, no shards listed) it is the unsharded
    run, as in the JAX package."""
    from regenie_tpu_torch import cli

    prefix = _tiny_dataset(tmp_path)
    argv = ["--step", "1", "--bed", prefix, "--phenoFile", f"{tmp_path}/pheno.txt",
            "--covarFile", f"{tmp_path}/covar.txt", "--bsize", "4"]
    if loocv:
        argv.append("--loocv")
    outs = {}
    for tag, shards in (("u", 0), ("m", 3), ("one", 1)):
        _mesh_env(monkeypatch, shards)
        if tag == "one":
            monkeypatch.delenv("REGENIE_TPU_TORCH_MESH_DEVICES")
        cli.main(argv + ["--out", f"{tmp_path}/{tag}"])
        log = open(f"{tmp_path}/{tag}.log").read()
        assert ("multi-device mesh: 3 shards" in log) == (tag == "m")
        outs[tag] = [open(f"{tmp_path}/{tag}_{i}.loco").read() for i in (1, 2, 3)]
    assert outs["m"] == outs["u"] == outs["one"]


@pytest.mark.parametrize("step", ["1", "2"])
def test_mesh_2d_ignored_on_one_shard(tmp_path, monkeypatch, step):
    """REGENIE_TPU_MESH_2D on a run without a mesh of several shards (one
    shard listed, or none) is ignored, as the JAX package ignores it on
    one device: the run writes the files of a run without it."""
    from regenie_tpu_torch import cli

    prefix = _tiny_dataset(tmp_path)
    argv = ["--step", step, "--bed", prefix, "--phenoFile", f"{tmp_path}/pheno.txt",
            "--bsize", "4"] + (["--ignore-pred"] if step == "2" else [])
    ext = ".loco" if step == "1" else ".regenie"
    outs = []
    for tag, shards, m2d in (("plain", 0, False), ("one", 1, True),
                             ("none", 0, True)):
        _mesh_env(monkeypatch, shards, m2d)
        cli.main(argv + ["--out", f"{tmp_path}/{tag}"])
        outs.append(sorted(open(f).read() for f in
                           glob.glob(f"{tmp_path}/{tag}_*{ext}")))
    assert outs[0] and outs[0] == outs[1] == outs[2]


def _loco_file(path, ids, rows, tab=False):
    sep = "\t" if tab else " "
    with open(path, "w") as fh:
        fh.write("FID_IID" + sep + sep.join(ids) + " \n")
        for c, vals in enumerate(rows, start=1):
            fh.write(f"{c}" + sep + sep.join(vals) + " \n")


@pytest.mark.parametrize("line", [
    "FID_IID a_b\tc_d  e_f\n", "  1 0.5\t-2e-7 NA \r\n", "", "\n",
    "1 0.5\x0b7 NA\n", "x\fy z\x1c w\x85v\xa0u\n", "a\rb c\n", "é ü\tö\n",
])
def test_string_split_matches_jax(line):
    """The port's string_split (str.split() on plain ASCII lines) gives the
    JAX package's tokens on every line, odd whitespace included."""
    from regenie_tpu.io import files as jf
    from regenie_tpu_torch.io import files as pf

    assert pf.string_split(line) == jf.string_split(line)


@pytest.mark.parametrize("tab", [False, True])
def test_read_loco_chr_matches_jax(tmp_path, tab):
    """read_loco_chr (one numpy parse a row) against the JAX package's
    row loop: the
    same values bit for bit on every chromosome, with a header sample the
    genotypes lack and NA at masked samples; NA at an analysed sample
    raises the same error; mask_samples_missing_loco masks the same
    samples."""
    import numpy as np

    from regenie_tpu import run_step2 as jr
    from regenie_tpu_torch import run_step2 as pr

    rng = np.random.default_rng(0)
    n = 50
    ids = [f"F{i}_I{i}" for i in range(n)]
    id_to_ind = {k: i for i, k in enumerate(ids[:-1])}  # the last: no genotypes
    mask = rng.random(n - 1) > 0.2
    rows = [[repr(float(v)) if rng.random() > 0.01 else "1e-7"
             for v in rng.normal(size=n)] for _ in range(23)]
    for r in rows:
        for i in np.flatnonzero(~mask)[:3]:
            r[i] = "NA"
    path = str(tmp_path / "x.loco")
    _loco_file(path, ids, rows, tab)
    for chrom in (1, 7, 23):
        want = jr.read_loco_chr(path, chrom, id_to_ind, n - 1, mask)
        got = pr.read_loco_chr(path, chrom, id_to_ind, n - 1, mask)
        assert got.tobytes() == want.tobytes(), chrom
    bad = mask.copy()
    bad[np.flatnonzero(~mask)[0]] = True
    msgs = []
    for mod in (jr, pr):
        with pytest.raises(ValueError) as e:
            mod.read_loco_chr(path, 2, id_to_ind, n - 1, bad)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "missing predictions for chr 2" in msgs[0]

    from types import SimpleNamespace

    outs = []
    for mod in (jr, pr):
        pd = SimpleNamespace(pheno_names=["Y1"], masked_indivs=np.ones((n - 1, 1), bool),
                             pheno_pass=np.ones(1, bool))
        params = SimpleNamespace(use_prs=False, n_samples=n - 1)
        mod.mask_samples_missing_loco(params, pd, {"Y1": path}, id_to_ind)
        outs.append(pd.masked_indivs[:, 0].copy())
    assert (outs[0] == outs[1]).all() and (~outs[0]).sum() == 3
