"""The port's Step-1 CLI under REGENIE_TPU_MESH_2D=1 against `python -m
regenie_tpu` on conftest's 8 virtual devices, with
tests/test_torch_mesh2d_cli.py's runner and rule (byte for byte where the
JAX package's 2-D run is byte-identical to its unsharded run, else every
number within rel 1e-9), the .loco files: LOOCV on QT and on BT tiles level
0 2-D on 4 shards (a 2 x 2 grid: two blocks solved at once, each on its
row's two sample shards) and on 8 (2 x 4); LOOCV on 2 shards (a 1 x 2
grid) and K-fold keep the 1-D sample-sharded level 0, and write the port's
1-D mesh files of the same shard count byte for byte. Every mesh run also
runs level 1 over the shards (QT LOOCV and K-fold, BT LOOCV, and CT here;
tests/test_torch_mesh_step1_cli.py holds BT K-fold).
"""

import pytest

from chip_smoke import write_dataset
from test_torch_mesh2d_cli import check_rule, make_runs
from test_torch_mesh_cli import N, make_data

S1 = ["--step", "1", "--bsize", "40"]
RUNS = {
    "jax_one": ("jax", 0, False),
    "jax_2d": ("jax", 8, True),
    "one": ("torch", 0, False),
    "1d": ("torch", 8, False),
    "2d8": ("torch", 8, True),
    "2d4": ("torch", 4, True),
    "2d2": ("torch", 2, True),
    "1d4": ("torch", 4, False),
    "1d2": ("torch", 2, False),
}
# run id: the 2-D grid of its level 0, or the 1-D mesh whose files it writes
GRID = {"2d8": "2 x 4", "2d4": "2 x 2"}
SAME_AS = {"2d2": "1d2"}
BASE = ("jax_one", "jax_2d", "one", "1d")
# id: (dataset, phenotype table, flags, env, runs, 2-D level 0 expected)
SCENARIOS = {
    "qt_loocv": ("small", "pheno.txt", S1 + ["--loocv"], (),
                 BASE + ("2d8", "2d4", "2d2", "1d2"), True),
    "bt_loocv": ("small", "pheno_bt.txt", S1 + ["--bt"], (), BASE + ("2d4",), True),
    "qt_kfold": ("small", "pheno.txt", S1, (), BASE + ("2d4", "1d4"), False),
    "ct_kfold": ("small", "pheno_ct.txt", S1 + ["--ct"], (), BASE + ("2d4", "1d4"),
                 False),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    data = make_data(str(tmp_path_factory.mktemp("torch_mesh2d_step1_cli")),
                     (("small", write_dataset, N, ((1, 67), (2, 35))),))
    return make_runs(data, SCENARIOS, RUNS)


@pytest.mark.parametrize("sid", list(SCENARIOS))
def test_mesh2d_step1_cli_matches_jax(runs, sid):
    r = runs(sid)
    tiled = SCENARIOS[sid][5]
    assert ("2-D mesh: 2 x 4 (variant-block x sample tiling)" in r["jax_2d"][1]) == tiled
    ports = [rid for rid in r if rid.startswith("2d")]
    for rid in ports:
        assert ("2-D mesh:" in r[rid][1]) == (tiled and rid in GRID), rid
        if tiled and rid in GRID:
            assert f"2-D mesh: {GRID[rid]} (variant-block x sample tiling)" in r[rid][1]
    check_rule(r, ports)
    # the 1-D level 0 under the variable: the 1-D mesh's files, byte for byte
    same = {rid: ref for rid, ref in SAME_AS.items() if rid in r}
    if not tiled:
        same["2d4"] = "1d4"
    for rid, ref in same.items():
        for name, f in r[rid][0].items():
            assert open(f, "rb").read() == open(r[ref][0][name], "rb").read(), (rid, name)
