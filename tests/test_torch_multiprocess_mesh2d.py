"""Multi-process runs of the port under REGENIE_TPU_MESH_2D=1 (parallel/dist.py
over gloo, tests/test_torch_multiprocess.py's launch) on
tests/test_torch_mesh_cli.py's synthetic files: 2 processes x 1 CPU shard (a
1 x 2 grid: each process reads every variant row of a QT block and uploads
only its own byte columns) and 2 processes x 2 shards (a 2 x 2 grid: each
process reads only its own variant rows), QT and BT --firth --approx on
the fused route (BT reads whole blocks, as in the JAX package), and Step 1
--loocv on the 2 x 2 grid (the 2-D level 0; the per-host sample window
stays off). Each run's files equal the one-process run on the same grid
(tests/test_torch_mesh2d_cli.py's runner, in this process) byte for byte,
process 1 printing no line. Two of them, the shapes of
tests/test_multihost.py's 2-D runs (QT on 1 x 2, BT on 2 x 2), are also
held to the JAX package's two-process 2-D files (its CLI as 2 processes of
1 or 2 virtual CPU devices), byte for byte where those equal the JAX
package's unsharded files, else every number within rel 1e-9.
"""

import glob

import pytest

from test_torch_mesh2d_cli import run_cli
from test_torch_mesh_cli import _run, _same_or_close
from test_torch_multiprocess import data, launch  # noqa: F401
from test_torch_multiprocess_jax import _jax_launch

M2D = (("REGENIE_TPU_MESH_2D", "1"), ("REGENIE_TPU_FUSED", "1"))
S2 = ["--step", "2", "--ignore-pred", "--bsize", "16"]
BT = ["--bt", "--firth", "--approx"]
# id: (phenotype table, flags, shards a process, grid, held to the JAX package)
SCENARIOS = {
    "qt_1x2": ("pheno.txt", S2, 1, "1 x 2", True),
    "bt_1x2": ("pheno_bt.txt", S2 + BT, 1, "1 x 2", False),
    "qt_2x2": ("pheno.txt", S2, 2, "2 x 2", False),
    "bt_2x2": ("pheno_bt.txt", S2 + BT, 2, "2 x 2", True),
    "step1_loocv_2x2": ("pheno.txt", ["--step", "1", "--bsize", "16", "--loocv"], 2,
                        "2 x 2", False),
}


def _files(prefix):
    return {f[len(prefix):]: f for f in glob.glob(prefix + "*")}


@pytest.mark.parametrize("sid", list(SCENARIOS))
def test_multiprocess_mesh2d_matches_single(data, sid, tmp_path, monkeypatch):  # noqa: F811
    table, flags, local, grid, vs_jax = SCENARIOS[sid]
    d, src = data["bed"]
    base = src + ["--phenoFile", f"{d}/{table}", "--covarFile", f"{d}/covar.txt",
                  "--remove", f"{d}/remove.txt"] + flags
    one, mp = str(tmp_path / "one"), str(tmp_path / "mp")
    wait = launch(base + ["--out", mp], M2D, local=local)
    try:
        _, log1 = run_cli("torch", base + ["--out", one], M2D, 2 * local, True, monkeypatch)
        if vs_jax:
            jm, ju = str(tmp_path / "jax_mp"), str(tmp_path / "jax_one")
            monkeypatch.setenv("REGENIE_TPU_MESH_2D", "1")
            jlog = _jax_launch(base + ["--out", jm], local=local)
            monkeypatch.delenv("REGENIE_TPU_MESH_2D")
            mpatch = pytest.MonkeyPatch()
            try:
                _run("jax", base + ["--out", ju], M2D[1:], False, mpatch)
            finally:
                mpatch.undo()
    finally:
        procs = wait()
    for rc, out, err in procs:
        assert rc == 0, out + err
    log0 = procs[0][1]
    assert "distributed: process 0 of 2" in log0
    assert procs[1][1] == "", procs[1][1]  # process 1 printed no line
    if sid.startswith("step1"):
        line = f"2-D mesh: {grid} (variant-block x sample tiling)"
        assert "per-host decode" not in log0
    else:
        line = f"2-D mesh for the fused scorer: {grid}"
        assert "2 processes x rectangular slabs" in log0
        # QT reads per-host slabs; BT reads whole blocks
        assert ("per-host 2-D slab decode" in log0) == sid.startswith("qt")
    assert line in log1 and line in log0
    a, b = _files(one), _files(mp)
    assert set(a) == set(b), (sorted(a), sorted(b))
    outputs = [k for k in a if not k.endswith(".log")]
    assert outputs
    for k in outputs:
        x, y = open(a[k], "rb").read(), open(b[k], "rb").read()
        if k.endswith("_pred.list"):
            x = x.replace(one.encode(), mp.encode())
        assert x == y, k
    if vs_jax:
        assert "distributed: process 0 of 2" in jlog and line in jlog
        for k in outputs:
            if k.endswith((".regenie", ".loco")):
                exact = open(jm + k, "rb").read() == open(ju + k, "rb").read()
                _same_or_close(b[k], jm + k, exact)
