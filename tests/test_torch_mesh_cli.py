"""The port's Step-2 CLI on a mesh of 8 CPU shards (REGENIE_TPU_MESH=1,
REGENIE_TPU_TORCH_MESH_DEVICES=cpu x 8) against `python -m regenie_tpu`
under REGENIE_TPU_MESH=1 on conftest's 8 virtual devices, both in this
process, on small synthetic files built like tests/test_fused_score.py's
_mk_case (N = 601 samples, missing calls, NA traits, removed samples;
blocks of 16 variants whose last block on each chromosome holds 3, fewer
than the shards): QT on the fused route on BED and on BGEN, the dense
route (REGENIE_TPU_FUSED=0), BT with --firth --approx (fused and dense),
CT, and Cox (fused and dense). Step 1 is in
tests/test_torch_mesh_step1_cli.py, with this file's runner.

Each scenario runs four times: each package unsharded and on its mesh
(the runs of a scenario are kept for the module). The rule for the
port's mesh files, against the JAX package's mesh files and against the
port's own unsharded files: byte for byte where the JAX package's mesh
run is byte-identical to its unsharded run, else every number within rel
1e-9.
"""

import glob
import os

import numpy as np
import pytest

from chip_smoke import (t2e_flags, write_bgen_dataset, write_bt_table,
                        write_ct_table, write_dataset, write_t2e_table)

N = 601
CHROMS = ((1, 19), (2, 19))  # 16 + 3 variants each
SHARDS = 8


def _tables(d, n_t2e=2):
    Y = np.genfromtxt(f"{d}/pheno.txt", skip_header=1, missing_values="NA")[:, 2:]
    X = np.genfromtxt(f"{d}/covar.txt", skip_header=1)[:, 2:]
    write_bt_table(f"{d}/pheno_bt.txt", np.nan_to_num(Y), seed=1, n_inc=1, X=X)
    write_ct_table(f"{d}/pheno_ct.txt", Y, seed=3)
    write_t2e_table(f"{d}/pheno_t2e.txt", np.nan_to_num(Y[:, :n_t2e]), seed=3,
                    n_na=1, X=X)


def make_data(root, sets):
    """{name: (directory, genotype arguments)} of the datasets `sets`
    ((name, writer, N, chroms)), each with its BT, CT and T2E tables."""
    kw = dict(seed=9, P=3, n_inc=1, n_cov=3, n_remove=5, effect_sd=0.5)
    out = {}
    for name, fn, n, chroms in sets:
        d = os.path.join(root, name)
        os.makedirs(d)
        g = fn(d, N=n, chroms=chroms, **kw)
        _tables(d)
        src = (["--bgen", g, "--sample", f"{d}/geno.sample"]
               if fn is write_bgen_dataset else ["--bed", g])
        out[name] = (d, src)
    return out


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return make_data(str(tmp_path_factory.mktemp("torch_mesh_cli")),
                     (("bed", write_dataset, N, CHROMS),
                      ("bgen", write_bgen_dataset, N, CHROMS)))


# id: (dataset, phenotype table, flags, env on both sides)
S2 = ["--step", "2", "--ignore-pred", "--bsize", "16"]
FUSED = (("REGENIE_TPU_FUSED", "1"),)
DENSE = (("REGENIE_TPU_FUSED", "0"),)
BT = ["--bt", "--firth", "--approx"]
SCENARIOS = {
    "qt_bed": ("bed", "pheno.txt", S2, FUSED),
    "qt_bgen": ("bgen", "pheno.txt", S2, FUSED),
    "qt_dense": ("bed", "pheno.txt", S2, DENSE),
    "bt_firth": ("bed", "pheno_bt.txt", S2 + BT, FUSED),
    "bt_firth_dense": ("bgen", "pheno_bt.txt", S2 + BT, DENSE),
    "ct": ("bed", "pheno_ct.txt", S2 + ["--ct"], FUSED),
    "cox": ("bed", "pheno_t2e.txt", S2 + ["--firth", "--approx"] + t2e_flags(2),
            FUSED),
    "cox_dense": ("bed", "pheno_t2e.txt", S2 + t2e_flags(2), DENSE),
}


def _outputs(prefix):
    """{file name past the prefix: path} of a run's .regenie / .loco files."""
    return {f[len(prefix):]: f for f in
            glob.glob(prefix + "_*.regenie") + glob.glob(prefix + "_*.loco")}


def _run(pkg, argv, env, mesh, monkeypatch):
    for var in ("REGENIE_TPU_MESH", "REGENIE_TPU_TORCH_MESH_DEVICES"):
        monkeypatch.delenv(var, raising=False)
    for k, v in env:
        monkeypatch.setenv(k, v)
    if mesh:
        monkeypatch.setenv("REGENIE_TPU_MESH", "1")
        monkeypatch.setenv("REGENIE_TPU_TORCH_MESH_DEVICES",
                           ",".join(["cpu"] * SHARDS))
    if pkg == "jax":
        from regenie_tpu import cli

        monkeypatch.setenv("REGENIE_TPU_PLATFORM", "cpu")
    else:
        from regenie_tpu_torch import cli
        from regenie_tpu_torch.utils.device import DEVICE_ENV

        monkeypatch.setenv(DEVICE_ENV, "cpu")
    cli.main(argv)
    log = open(argv[-1] + ".log").read()
    for k, _ in env:
        monkeypatch.delenv(k)
    for var in ("REGENIE_TPU_MESH", "REGENIE_TPU_TORCH_MESH_DEVICES"):
        monkeypatch.delenv(var, raising=False)
    return _outputs(argv[-1]), log


def make_runs(data, scenarios):
    """scenario -> {(package, mesh): (output files, log)}, run on demand
    and kept."""
    cache = {}

    def get(sid):
        if sid not in cache:
            ds, table, flags, env = scenarios[sid]
            d, src = data[ds]
            base = src + ["--phenoFile", f"{d}/{table}", "--covarFile",
                          f"{d}/covar.txt", "--remove", f"{d}/remove.txt"] + flags
            mp = pytest.MonkeyPatch()
            try:
                cache[sid] = {
                    (pkg, mesh): _run(pkg, base + ["--out", f"{d}/{sid}_{pkg}_{int(mesh)}"],
                                      env, mesh, mp)
                    for pkg in ("jax", "torch") for mesh in (False, True)}
            finally:
                mp.undo()
        return cache[sid]

    return get


@pytest.fixture(scope="module")
def runs(data):
    return make_runs(data, SCENARIOS)


def _same_or_close(fa, fb, exact):
    """Two output files: identical bytes (exact), else the same tokens
    with every differing number within rel 1e-9."""
    a, b = open(fa).read(), open(fb).read()
    if exact:
        assert a == b, (fa, fb)
        return
    la, lb = a.splitlines(), b.splitlines()
    assert len(la) == len(lb) > 1, (fa, fb)
    for ra, rb in zip(la, lb):
        ta, tb = ra.split(), rb.split()
        assert len(ta) == len(tb), (ra, rb)
        for xa, xb in zip(ta, tb):
            if xa != xb:
                fa_, fb_ = float(xa), float(xb)  # raises on NA vs a number
                assert abs(fa_ - fb_) <= 1e-9 * max(1.0, abs(fa_)), (fa, ra, rb)


def check_scenario(r):
    """The rule above on one scenario's four runs."""
    (jm, jlog), (ju, _) = r["jax", True], r["jax", False]
    (tmf, tlog), (tu, _) = r["torch", True], r["torch", False]
    assert "multi-chip mesh" in jlog
    assert f"multi-device mesh: {SHARDS} shards" in tlog
    assert jm and set(jm) == set(ju) == set(tmf) == set(tu)
    for name in sorted(jm):
        exact = open(jm[name], "rb").read() == open(ju[name], "rb").read()
        _same_or_close(tmf[name], jm[name], exact)
        _same_or_close(tmf[name], tu[name], exact)


@pytest.mark.parametrize("sid", list(SCENARIOS))
def test_mesh_cli_matches_jax_mesh(runs, sid):
    check_scenario(runs(sid))
