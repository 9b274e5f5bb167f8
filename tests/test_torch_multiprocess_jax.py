"""The port's multi-process runs against the JAX package's: the same
invocation as 2 processes of each package (the port on 4 CPU shards each
over gloo, tests/test_torch_multiprocess.py's launch; the JAX package on 4
virtual CPU devices each, as tests/test_multihost.py runs it, with
REGENIE_TPU_MESH=1), on tests/test_torch_mesh_cli.py's synthetic files:
Step-2 QT on the fused route (per-host variant rows), Step 1 --loocv on a
BED (the per-host sample window) and a gene-based --set-list run (sets
round-robin). The rule is tests/test_torch_mesh_cli.py's: the port's
output-host files byte for byte against the JAX package's where the JAX
package's 2-process files equal its own single-process mesh run's (8
virtual devices, in this process), else every number within rel 1e-9.
"""

import glob
import os
import subprocess
import sys

import pytest

from test_torch_mesh_cli import _run, _same_or_close
from test_torch_multiprocess import REPO, data, free_port, launch  # noqa: F401

GENE = ["--set-list", "{d}/sets.txt", "--anno-file", "{d}/anno.txt", "--mask-def",
        "{d}/masks.txt", "--vc-tests", "acatv", "--joint", "acat"]
# id: (flags, the JAX package's log line of its multi-process split)
SCENARIOS = {
    "qt_fused": (["--step", "2", "--ignore-pred", "--bsize", "19"], "per-host decode"),
    "step1_loocv": (["--step", "1", "--bsize", "19", "--loocv"], "per-host decode"),
    "gene": (["--step", "2", "--ignore-pred", "--bsize", "19"] + GENE,
             "sets sharded round-robin"),
}
ENV = (("REGENIE_TPU_FUSED", "1"),)


def _jax_launch(argv, nproc=2, local=4, timeout=600):
    """The JAX package's CLI as nproc processes of `local` virtual CPU
    devices; returns process 0's output."""
    port = free_port()
    procs = []
    for pid in range(nproc):
        env = dict(os.environ)
        env.update({
            "REGENIE_TPU_PLATFORM": "cpu", "JAX_PLATFORMS": "cpu",
            "XLA_FLAGS": f"--xla_force_host_platform_device_count={local}",
            "REGENIE_TPU_MESH": "1", "REGENIE_TPU_FUSED": "1",
            "REGENIE_TPU_COORDINATOR": f"127.0.0.1:{port}",
            "REGENIE_TPU_NUM_PROCESSES": str(nproc),
            "REGENIE_TPU_PROCESS_ID": str(pid)})
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "regenie_tpu"] + argv, cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            p.kill()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o
    return outs[0]


def _outputs(prefix):
    return {f[len(prefix):]: f for f in glob.glob(prefix + "_*.regenie")
            + glob.glob(prefix + "_*.loco")}


@pytest.mark.parametrize("sid", list(SCENARIOS))
def test_multiprocess_matches_jax_multiprocess(data, sid, tmp_path):  # noqa: F811
    flags, jax_line = SCENARIOS[sid]
    d, src = data["bed"]
    base = src + ["--phenoFile", f"{d}/pheno.txt", "--covarFile", f"{d}/covar.txt",
                  "--remove", f"{d}/remove.txt"] + [f.format(d=d) for f in flags]
    tm, jm, js = (str(tmp_path / n) for n in ("torch_mp", "jax_mp", "jax_mesh"))
    wait = launch(base + ["--out", tm], ENV)
    try:
        jlog = _jax_launch(base + ["--out", jm])
        mp = pytest.MonkeyPatch()
        try:
            _run("jax", base + ["--out", js], ENV, True, mp)
        finally:
            mp.undo()
    finally:
        procs = wait()
    for rc, out, err in procs:
        assert rc == 0, out + err
    assert "distributed: process 0 of 2" in jlog and jax_line in jlog
    assert "distributed: process 0 of 2" in procs[0][1]
    t, j, jmesh = _outputs(tm), _outputs(jm), _outputs(js)
    assert t and set(t) == set(j) == set(jmesh)
    for name in sorted(t):
        exact = open(j[name], "rb").read() == open(jmesh[name], "rb").read()
        print(sid, name, "byte for byte" if exact else "within rel 1e-9")
        _same_or_close(t[name], j[name], exact)
