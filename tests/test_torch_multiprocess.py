"""Multi-process runs of the port (parallel/dist.py) on the CPU over gloo:
the same `python -m regenie_tpu_torch` invocation as 2 processes x 4 CPU
shards (REGENIE_TPU_MESH=1, REGENIE_TPU_TORCH_MESH_DEVICES=cpu x 4,
REGENIE_TPU_COORDINATOR=127.0.0.1:<free port>, REGENIE_TPU_NUM_PROCESSES=2,
REGENIE_TPU_PROCESS_ID=i), on the synthetic files of
tests/test_torch_mesh_cli.py (N = 601, blocks of 16 variants with a short
last block), held to the port's single-process run on a mesh of 8 CPU
shards in this process: the output host's files byte for byte (Step 1's
per-host sample window, whose sums run on the file sample axis, within
rel 1e-9 where not), the directory holding exactly the single run's
files, and process 1 printing no line. This file holds the Step-2
scenarios (per-host variant rows on BED and BGEN, BT --firth --approx,
Cox, LD mode on chrX, a torchrun-style REGENIE_TPU_DIST=1 launch);
tests/test_torch_multiprocess_modes.py the Step-1 and process-sharded
ones, with this file's runner.
"""

import glob
import os
import socket
import subprocess
import sys

import pytest

from chip_smoke import (chrx_positions, t2e_flags, write_bgen_dataset,
                        write_dataset, write_gene_files)
from test_torch_mesh_cli import N, _same_or_close, make_data

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPROC, LOCAL = 2, 4
CHROMS = ((1, 19), (2, 19))


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_multiprocess"))
    out = make_data(root, (("bed", write_dataset, N, CHROMS),
                           ("bgen", write_bgen_dataset, N, CHROMS)))
    d = os.path.join(root, "chrx")
    os.makedirs(d)
    g = write_dataset(d, seed=9, N=N, chroms=(("X", 19),), P=3, n_inc=1,
                      n_cov=3, n_remove=5, positions={"X": chrx_positions(19, 3)})
    out["chrx"] = (d, ["--bed", g])
    write_gene_files(out["bed"][0], CHROMS, 4, seed=5)
    return out


def _env(extra):
    env = dict(os.environ)
    for var in ("REGENIE_TPU_COORDINATOR", "REGENIE_TPU_DIST", "REGENIE_TPU_MESH_2D"):
        env.pop(var, None)
    env.update({"REGENIE_TPU_TORCH_DEVICE": "cpu", "REGENIE_TPU_MESH": "1",
                "REGENIE_TPU_DIST_TIMEOUT": "120",
                "PYTHONPATH": REPO + os.pathsep + env.get("PYTHONPATH", "")})
    env.update(extra)
    return env


def launch(argv, env_extra=(), torchrun=False, local=LOCAL, timeout=300):
    """Start the invocation as NPROC processes of `local` CPU shards each
    (a list: each process's own count; torchrun=True: through
    REGENIE_TPU_DIST=1 and the MASTER_ADDR / MASTER_PORT / RANK /
    WORLD_SIZE a torchrun launch sets). Returns a function that waits for
    them (killing both at the timeout) and returns each process's
    (return code, stdout, stderr)."""
    port = free_port()
    procs = []
    shards = local if isinstance(local, list) else [local] * NPROC
    for pid in range(NPROC):
        if torchrun:
            dist_env = {"REGENIE_TPU_DIST": "1", "MASTER_ADDR": "127.0.0.1",
                        "MASTER_PORT": str(port), "RANK": str(pid),
                        "WORLD_SIZE": str(NPROC)}
        else:
            dist_env = {"REGENIE_TPU_COORDINATOR": f"127.0.0.1:{port}",
                        "REGENIE_TPU_NUM_PROCESSES": str(NPROC),
                        "REGENIE_TPU_PROCESS_ID": str(pid)}
        env = _env({**dist_env, **dict(env_extra),
                    "REGENIE_TPU_TORCH_MESH_DEVICES": ",".join(["cpu"] * shards[pid])})
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "regenie_tpu_torch"] + argv, cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))

    def wait():
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=timeout))
        finally:
            for p in procs:
                p.kill()
        return [(p.returncode,) + o for p, o in zip(procs, outs)]

    return wait


def run_single(argv, env_extra, monkeypatch):
    """The invocation in this process on a mesh of NPROC * LOCAL CPU shards."""
    from regenie_tpu_torch import cli

    for k, v in env_extra:
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("REGENIE_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("REGENIE_TPU_MESH", "1")
    monkeypatch.setenv("REGENIE_TPU_TORCH_MESH_DEVICES", ",".join(["cpu"] * (NPROC * LOCAL)))
    try:
        cli.main(argv)
    finally:
        monkeypatch.undo()


def _files(prefix):
    return {f[len(prefix):]: f for f in glob.glob(prefix + "*")}


def run_scenario(data, sid, spec, tmp_path):
    """Both runs of a scenario ((dataset, phenotype table, flags, env,
    torchrun)); returns (single files, multi files, process outputs)."""
    ds, table, flags, env, torchrun = spec
    d, src = data[ds]
    base = src + ["--phenoFile", f"{d}/{table}", "--covarFile", f"{d}/covar.txt",
                  "--remove", f"{d}/remove.txt"] + [f.format(d=d) for f in flags]
    one, mp = str(tmp_path / f"{sid}_one"), str(tmp_path / f"{sid}_mp")
    wait = launch(base + ["--out", mp], env, torchrun)
    mpatch = pytest.MonkeyPatch()
    try:
        run_single(base + ["--out", one], env, mpatch)
    finally:
        procs = wait()
    for rc, out, err in procs:
        assert rc == 0, out + err
    return _files(one), _files(mp), procs, (one, mp)


def check_scenario(data, sid, spec, tmp_path, exact=True):
    """The rules of the module docstring on one scenario; returns process
    0's stdout."""
    one, mp, procs, (p1, p2) = run_scenario(data, sid, spec, tmp_path)
    assert set(one) == set(mp), (sorted(one), sorted(mp))
    outputs = [k for k in one if not k.endswith(".log")]
    assert outputs
    for k in outputs:
        a, b = open(one[k], "rb").read(), open(mp[k], "rb").read()
        if k.endswith("_pred.list"):
            # names the run's own .loco files
            assert a.replace(p1.encode(), p2.encode()) == b, k
        elif exact or not k.endswith(".loco"):
            assert a == b, k
        else:
            _same_or_close(one[k], mp[k], False)
    log0 = procs[0][1]
    assert f"distributed: process 0 of {NPROC}" in log0
    assert procs[1][1] == "", procs[1][1]  # process 1 printed no line
    return log0


S2 = ["--step", "2", "--ignore-pred", "--bsize", "16"]
# id: (dataset, phenotype table, flags, env, torchrun)
SCENARIOS = {
    "step2_bed": ("bed", "pheno.txt", S2, (), False),
    "step2_bgen": ("bgen", "pheno.txt", S2, (), False),
    "bt_firth": ("bed", "pheno_bt.txt", S2 + ["--bt", "--firth", "--approx"], (), False),
    "cox": ("bed", "pheno_t2e.txt", S2 + ["--firth", "--approx"] + t2e_flags(2), (),
            False),
    "chrx_corr": ("chrx", "pheno.txt", S2 + ["--compute-corr"], (), False),
    "torchrun": ("bed", "pheno.txt", S2, (), True),
}


@pytest.mark.parametrize("sid", list(SCENARIOS))
def test_multiprocess_step2_matches_single(data, sid, tmp_path):
    log0 = check_scenario(data, sid, SCENARIOS[sid], tmp_path)
    if sid in ("step2_bed", "step2_bgen", "torchrun"):
        # the QT fused route: each process read only its own rows
        assert f"multi-device mesh: {NPROC * LOCAL} shards on {NPROC} processes" in log0
        assert "per-host decode: each of 2 processes reads only its own variant" in log0


def test_shard_count_mismatch_raises_before_any_work(data, tmp_path):
    """Processes that hold different shard counts raise, each of them,
    before any output: no fallback to separate runs."""
    d, src = data["bed"]
    out = str(tmp_path / "mismatch")
    procs = launch(src + ["--phenoFile", f"{d}/pheno.txt", "--step", "2",
                          "--ignore-pred", "--out", out], local=[4, 3])()
    for rc, _, err in procs:
        assert rc != 0 and "same number of mesh shards" in err, err[-2000:]
    assert _files(out) == {}
