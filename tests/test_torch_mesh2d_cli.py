"""The port's Step-2 CLI on the 2-D mesh (REGENIE_TPU_MESH_2D=1 with
REGENIE_TPU_MESH=1 and REGENIE_TPU_TORCH_MESH_DEVICES=cpu x 8 or x 4) against
`python -m regenie_tpu` under the same variables on conftest's 8 virtual
devices, both in this process, on tests/test_torch_mesh_cli.py's synthetic
files (N = 601, blocks of 16 variants whose last block on each chromosome
holds 3, fewer than the grid's cells): QT on the fused route on BED and on
PGEN hardcalls, BT with --firth --approx, CT and Cox on the fused route,
each on a 2 x 4 and a 2 x 2 grid; and QT on BGEN and on the dense route,
which keep the 1-D variant mesh under the variable, as the JAX package's
do.

The rule is tests/test_torch_mesh_cli.py's: the port's 2-D files against
the JAX package's 2-D files, the port's 1-D mesh files and its unsharded
files, byte for byte where the JAX package's 2-D run is
byte-identical to its unsharded run, else every number within rel 1e-9.
A route that keeps the 1-D mesh writes the port's 1-D mesh files byte for
byte.
"""

import os

import pytest

from chip_smoke import t2e_flags, write_bgen_dataset, write_dataset, write_pgen_dataset
from test_torch_mesh_cli import CHROMS, N, _outputs, _same_or_close, _tables, make_data

MESH_VARS = ("REGENIE_TPU_MESH", "REGENIE_TPU_TORCH_MESH_DEVICES", "REGENIE_TPU_MESH_2D")
# run id: (package, shards (0: unsharded), 2-D)
RUNS = {
    "jax_one": ("jax", 0, False),
    "jax_2d": ("jax", 8, True),
    "one": ("torch", 0, False),
    "1d": ("torch", 8, False),
    "2d8": ("torch", 8, True),
    "2d4": ("torch", 4, True),
}
GRID = {"2d8": "2 x 4", "2d4": "2 x 2"}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_mesh2d_cli"))
    out = make_data(root, (("bed", write_dataset, N, CHROMS),
                           ("bgen", write_bgen_dataset, N, CHROMS)))
    d = os.path.join(root, "pgen")
    os.makedirs(d)
    g = write_pgen_dataset(d, seed=9, N=N, chroms=CHROMS, P=3, n_inc=1, n_cov=3,
                           n_remove=5, effect_sd=0.5)
    _tables(d)
    out["pgen"] = (d, ["--pgen", g])
    return out


S2 = ["--step", "2", "--ignore-pred", "--bsize", "16"]
FUSED = (("REGENIE_TPU_FUSED", "1"),)
DENSE = (("REGENIE_TPU_FUSED", "0"),)
ALL = tuple(RUNS)
ONE_D = ("jax_one", "jax_2d", "one", "1d", "2d8")
# id: (dataset, phenotype table, flags, env on every run, runs, tiled 2-D)
SCENARIOS = {
    "qt_bed": ("bed", "pheno.txt", S2, FUSED, ALL, True),
    "qt_pgen": ("pgen", "pheno.txt", S2, FUSED, ALL, True),
    "bt_firth": ("bed", "pheno_bt.txt", S2 + ["--bt", "--firth", "--approx"], FUSED,
                 ALL, True),
    "ct": ("bed", "pheno_ct.txt", S2 + ["--ct"], FUSED, ALL, True),
    "cox": ("bed", "pheno_t2e.txt", S2 + ["--firth", "--approx"] + t2e_flags(2),
            FUSED, ALL, True),
    "qt_bgen": ("bgen", "pheno.txt", S2, FUSED, ONE_D, False),
    "qt_dense": ("bed", "pheno.txt", S2, DENSE, ONE_D, False),
}


def run_cli(pkg, argv, env, shards, two_d, monkeypatch):
    """One CLI run in this process with `env` and the mesh variables of
    (shards, two_d) set, every one of them unset after; returns (the
    run's .regenie and .loco files, its log)."""
    for var in MESH_VARS:
        monkeypatch.delenv(var, raising=False)
    for k, v in env:
        monkeypatch.setenv(k, v)
    if shards:
        monkeypatch.setenv("REGENIE_TPU_MESH", "1")
        if pkg == "torch":
            monkeypatch.setenv("REGENIE_TPU_TORCH_MESH_DEVICES", ",".join(["cpu"] * shards))
    if two_d:
        monkeypatch.setenv("REGENIE_TPU_MESH_2D", "1")
    if pkg == "jax":
        from regenie_tpu import cli

        monkeypatch.setenv("REGENIE_TPU_PLATFORM", "cpu")
    else:
        from regenie_tpu_torch import cli
        from regenie_tpu_torch.utils.device import DEVICE_ENV

        monkeypatch.setenv(DEVICE_ENV, "cpu")
    try:
        cli.main(argv)
    finally:
        for var in MESH_VARS + tuple(k for k, _ in env):
            monkeypatch.delenv(var, raising=False)
    return _outputs(argv[-1]), open(argv[-1] + ".log").read()


def make_runs(data, scenarios, runs=RUNS):
    """scenario -> {run id: (output files, log)}, run on demand and kept."""
    cache = {}

    def get(sid):
        if sid not in cache:
            ds, table, flags, env, which = scenarios[sid][:5]
            d, src = data[ds]
            base = src + ["--phenoFile", f"{d}/{table}", "--covarFile",
                          f"{d}/covar.txt", "--remove", f"{d}/remove.txt"] + flags
            mp = pytest.MonkeyPatch()
            try:
                cache[sid] = {rid: run_cli(*runs[rid][:1], base + ["--out", f"{d}/{sid}_{rid}"],
                                           env, *runs[rid][1:], mp)
                              for rid in which}
            finally:
                mp.undo()
        return cache[sid]

    return get


@pytest.fixture(scope="module")
def runs(data):
    return make_runs(data, SCENARIOS)


def check_rule(r, port_runs, refs=("jax_2d", "one", "1d")):
    """The module's rule: each of port_runs' files against each of refs'."""
    jm, ju = r["jax_2d"][0], r["jax_one"][0]
    assert jm and set(jm) == set(ju)
    for rid in tuple(port_runs) + tuple(refs):
        assert set(r[rid][0]) == set(jm), rid
    for name in sorted(jm):
        exact = open(jm[name], "rb").read() == open(ju[name], "rb").read()
        for rid in port_runs:
            for ref in refs:
                _same_or_close(r[rid][0][name], r[ref][0][name], exact)


@pytest.mark.parametrize("sid", list(SCENARIOS))
def test_mesh2d_cli_matches_jax(runs, sid):
    r = runs(sid)
    tiled = SCENARIOS[sid][5]
    assert "2-D mesh for the fused scorer: 2 x 4" in r["jax_2d"][1]
    assert "multi-device mesh: 8 shards" in r["1d"][1]
    ports = [rid for rid in GRID if rid in r]
    for rid in ports:
        # the port logs the grid whenever it builds one, as the JAX package
        assert f"2-D mesh for the fused scorer: {GRID[rid]}" in r[rid][1]
    check_rule(r, ports)
    if not tiled:
        # BGEN and the dense route keep the 1-D mesh: its files, byte for byte
        for name, f in r["2d8"][0].items():
            assert open(f, "rb").read() == open(r["1d"][0][name], "rb").read(), name
