"""The port's Step-1 CLI on a mesh of 8 CPU shards against `python -m
regenie_tpu` under REGENIE_TPU_MESH=1 on conftest's 8 virtual devices,
with tests/test_torch_mesh_cli.py's runner and rule (byte for byte where
the JAX package's mesh run is byte-identical to its unsharded run, else
every number within rel 1e-9; the port's mesh run against the JAX
package's and against its own unsharded run): LOOCV and K-fold on QT and
on BT, the .loco files. The sample axis (N = 601, and N = 5,000 for
K-fold BT, where the JAX package stops forcing LOOCV) divides by no
shard count; blocks of 40 and 20 variants keep the JAX package's mesh
runs, which compile their level 0 a block, short.
"""

import pytest

from chip_smoke import write_dataset
from test_torch_mesh_cli import N, check_scenario, make_data, make_runs

S1 = ["--step", "1"]
# id: (dataset, phenotype table, flags, env on both sides)
SCENARIOS = {
    "qt_kfold": ("small", "pheno.txt", S1 + ["--bsize", "40"], ()),
    "qt_loocv": ("small", "pheno.txt", S1 + ["--bsize", "40", "--loocv"], ()),
    "bt_loocv": ("small", "pheno_bt.txt", S1 + ["--bsize", "40", "--bt"], ()),
    "bt_kfold": ("big", "pheno_bt.txt", S1 + ["--bsize", "20", "--bt"], ()),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    data = make_data(str(tmp_path_factory.mktemp("torch_mesh_step1_cli")),
                     (("small", write_dataset, N, ((1, 67), (2, 35))),
                      ("big", write_dataset, 5000, ((1, 40),))))
    return make_runs(data, SCENARIOS)


@pytest.mark.parametrize("sid", list(SCENARIOS))
def test_mesh_step1_cli_matches_jax_mesh(runs, sid):
    check_scenario(runs(sid))
