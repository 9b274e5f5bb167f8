"""The port's multi-process runtime (parallel/dist.py) and the global
mesh's collectives (parallel/mesh.py), with two processes spawned over
gloo on the CPU: allgather_py in process order, the tensor gather in
global shard order, psum in global shard order bit for bit equal to one
process's sum over the same shards, the gather to the output host alone,
a mesh of one local shard a process, the 2-D mesh refused on a global
mesh of two shards, null sinks from every writer off the output host, a
launch whose processes hold different shard counts raising in every
process, and a process that cannot join its group raising.

Run as a script, this file is one process of such a launch:
`python tests/test_torch_dist.py <scenario> <rank> <port> <directory>`
writes <directory>/<rank>.json.
"""

import json
import os
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the per-shard values of the psum check: their sum depends on its order
VALUES = [1e16, 1.0, -1e16, 1.0]


def _collectives(rank, d):
    import numpy as np
    import torch

    from regenie_tpu_torch import cli
    from regenie_tpu_torch.io.bgzf import BgzfWriter
    from regenie_tpu_torch.io.files import GzipWriter, open_write
    from regenie_tpu_torch.parallel import dist
    from regenie_tpu_torch.parallel import mesh as pm
    from regenie_tpu_torch.run_step1 import _open_bytes

    out = {"gathered": dist.allgather_py(f"p{rank}")}
    mesh = pm.global_mesh(pm.make_mesh(["cpu", "cpu"]))
    out["mesh"] = [mesh.size, mesh.first, len(mesh)]
    x = torch.arange(30, dtype=torch.float64).reshape(10, 3)
    out["rows"] = pm.gather(pm.shard(mesh, x, 0), 0, 10, mesh).tolist()
    out["cols"] = pm.gather(pm.shard(mesh, x.T.numpy(), 1), 1, mesh=mesh)[:, :10].tolist()
    dst = pm.gather(pm.shard(mesh, x, 0), 0, 10, mesh, dst=0)
    out["dst"] = None if dst is None else dst.tolist()
    parts = [torch.tensor([v]) for v in mesh.local(VALUES)]
    out["psum"] = pm.psum(parts, mesh).item()
    rng = np.random.default_rng(0)
    G, Y = torch.from_numpy(rng.normal(size=(5, 37))), torch.from_numpy(rng.normal(size=(37, 2)))
    GGt, GtY = pm.sharded_gram(mesh, G, Y)
    one = pm.make_mesh(["cpu"] * 4)
    GGt1, GtY1 = pm.sharded_gram(one, G, Y)
    out["gram_bits"] = bool(torch.equal(GGt, GGt1) and torch.equal(GtY, GtY1))
    # one local shard a process: still a mesh, of the global count
    os.environ.update({"REGENIE_TPU_MESH": "1", "REGENIE_TPU_TORCH_MESH_DEVICES": "cpu"})
    m1 = pm.maybe_mesh("cpu")
    out["one_local"] = None if m1 is None else [m1.size, len(m1)]
    os.environ["REGENIE_TPU_MESH_2D"] = "1"
    params = cli.args_to_params(cli.build_parser().parse_args(
        ["--step", "2", "--bed", "g", "--phenoFile", "p", "--ignore-pred", "--out", "o"]))
    out["unported_2d"] = cli.unported(params)
    m2 = pm.Mesh2D(m1)
    out["grid_2d"] = [m2.nv, m2.ns, [(r, c) for r, c, _ in m2.cells], m2.rects]
    # every writer writes on the output host alone
    with open_write(f"{d}/text{rank}.txt") as fh:
        fh.write("x\n")
    with open_write(f"{d}/gz{rank}.txt", gz=True) as fh:
        fh.write("x\n")
    w = GzipWriter(f"{d}/gzw{rank}.gz")
    w.write("x\n")
    w.close()
    b = BgzfWriter(f"{d}/bgzf{rank}.gz")
    b.write(b"x" * 70000)
    out["bgzf_tell"] = b.tell()
    b.close()
    with _open_bytes(f"{d}/bytes{rank}.bin") as fh:
        fh.write(b"x")
    return out


def _worker(scenario, rank, port, d):
    """One process of a two-process launch; its results to <d>/<rank>.json."""
    sys.path.insert(0, REPO)
    os.environ.update({"REGENIE_TPU_COORDINATOR": f"127.0.0.1:{port}",
                       "REGENIE_TPU_NUM_PROCESSES": "2",
                       "REGENIE_TPU_PROCESS_ID": str(rank),
                       "REGENIE_TPU_DIST_TIMEOUT": "60" if scenario != "alone" else "3"})
    from regenie_tpu_torch.parallel import dist
    from regenie_tpu_torch.parallel import mesh as pm

    out = {}
    try:
        out["multi"] = dist.maybe_init_distributed(log=lambda m: None)
        if scenario == "collectives":
            out.update(_collectives(rank, d))
        elif scenario == "mismatch":
            pm.global_mesh(pm.make_mesh(["cpu"] * (2 if rank == 0 else 1)))
    except Exception as e:  # noqa: BLE001 — recorded for the test
        out["error"] = f"{type(e).__name__}: {e}"
    finally:
        dist.shutdown()
    with open(f"{d}/{rank}.json", "w") as fh:
        json.dump(out, fh)


def _launch(scenario, d, ranks=(0, 1)):
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    env = dict(os.environ, PYTHONPATH=REPO)
    for var in ("REGENIE_TPU_MESH", "REGENIE_TPU_TORCH_MESH_DEVICES", "REGENIE_TPU_MESH_2D"):
        env.pop(var, None)
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), scenario,
                               str(r), str(port), str(d)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in ranks]
    try:
        logs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    return [json.load(open(f"{d}/{r}.json")) for r in ranks]


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_dist")
    return d, _launch("collectives", d)


def test_allgather_py_in_process_order(launched):
    _, res = launched
    for r in res:
        assert "error" not in r, r.get("error")
        assert r["multi"] is True
        assert r["gathered"] == ["p0", "p1"]


def test_gather_in_global_shard_order(launched):
    _, res = launched
    want = [[float(3 * i + j) for j in range(3)] for i in range(10)]
    for rank, r in enumerate(res):
        assert r["mesh"] == [4, 2 * rank, 2]
        assert r["rows"] == want
        assert r["cols"] == [list(c) for c in zip(*want)]
    assert res[0]["dst"] == want and res[1]["dst"] is None


def test_psum_in_global_shard_order(launched):
    """The sum over processes is taken in global shard order, bit for bit
    one process's sum of the same four partials (no all_reduce)."""
    import torch

    from regenie_tpu_torch.parallel import mesh as pm

    one = pm.psum([torch.tensor([v]) for v in VALUES]).item()
    assert one == ((VALUES[0] + VALUES[1]) + VALUES[2]) + VALUES[3]
    _, res = launched
    for r in res:
        assert r["psum"] == one
        assert r["gram_bits"] is True


def test_one_local_shard_is_a_global_mesh(launched):
    """A process with one local shard has a mesh of the global count,
    which cli.unported no longer refuses under REGENIE_TPU_MESH_2D: its
    2-D grid is the JAX package's 1 x 2 of the two processes' shards, each
    process holding the cell of its own column, every rectangle the same
    on both processes."""
    _, res = launched
    for rank, r in enumerate(res):
        assert r["one_local"] == [2, 1]
        assert r["unported_2d"] is None
        assert r["grid_2d"] == [1, 2, [[0, rank]],
                                [[[0, 1], [0, 1]], [[0, 1], [1, 1]]]]


def test_writers_write_on_the_output_host_alone(launched):
    d, res = launched
    names = sorted(os.listdir(d))
    assert [n for n in names if "1" in n and not n.endswith(".json")] == []
    assert {"text0.txt", "gz0.txt.gz", "gzw0.gz", "bgzf0.gz", "bytes0.bin"} <= set(names)
    # the null BGZF writer keeps the offsets the real one reports
    assert res[0]["bgzf_tell"] == res[1]["bgzf_tell"] > 0


def test_shard_count_mismatch_raises(tmp_path):
    res = _launch("mismatch", tmp_path)
    for r in res:
        assert "same number of mesh shards" in r.get("error", ""), r


def test_process_that_cannot_join_raises(tmp_path):
    """A process whose peer never comes fails at its timeout, no fallback
    to a single-process run."""
    (r,) = _launch("alone", tmp_path, ranks=(0,))
    assert "error" in r and "multi" not in r, r


if __name__ == "__main__":
    _worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
