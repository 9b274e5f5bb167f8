"""--af-cc off binary traits in the port against the JAX package, both on
the CPU in this process: the case/control columns appear in the header of
every trait type, and quantitative, count and time-to-event traits write
the reference's defaults there (-1), on the fused route (REGENIE_TPU_FUSED=1
for the JAX package) and the dense one (REGENIE_TPU_FUSED=0 on both
sides), split and merged (--no-split) output, on a synthetic BED and
BGEN (N = 500). Every file byte for byte, or each number within rel 1e-9.
"""

import os

import numpy as np
import pytest

from chip_smoke import (t2e_flags, write_bgen_dataset, write_ct_table, write_dataset,
                        write_t2e_table)
from test_torch_interaction import run_jax, run_port
from test_torch_mcc_mt import files_close

N = 500
CHROMS = ((1, 120), (2, 60))
NT = 2


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_afcc"))
    out = {}
    for name, fn in (("bed", write_dataset), ("bgen", write_bgen_dataset)):
        d = os.path.join(root, name)
        os.makedirs(d)
        g = fn(d, seed=51, N=N, chroms=CHROMS, P=3, n_inc=1, n_cov=3, n_remove=5)
        Y, X = (np.genfromtxt(f"{d}/{t}.txt", skip_header=1, usecols=range(2, 2 + k),
                              missing_values="NA") for t, k in (("pheno", 3), ("covar", 3)))
        write_ct_table(f"{d}/pheno_ct.txt", Y, seed=4)
        write_t2e_table(f"{d}/pheno_t2e.txt", np.nan_to_num(Y[:, :NT]), seed=5, n_na=1,
                        X=X)
        src = (["--bed", g] if name == "bed"
               else ["--bgen", g, "--sample", f"{d}/geno.sample"])
        out[name] = (d, src)
    return out


T2E = [*t2e_flags(NT)]
SCENARIOS = {
    # name: (dataset, table, flags, route, outputs)
    "qt_fused": ("bed", "pheno.txt", [], "1", "Y"),
    "qt_dense": ("bed", "pheno.txt", [], "0", "Y"),
    "qt_no_split": ("bed", "pheno.txt", ["--no-split"], "1", None),
    "qt_bgen_fused": ("bgen", "pheno.txt", [], "1", "Y"),
    "ct_fused": ("bed", "pheno_ct.txt", ["--ct"], "1", "Y"),
    "ct_dense": ("bed", "pheno_ct.txt", ["--ct"], "0", "Y"),
    "t2e_fused": ("bed", "pheno_t2e.txt", T2E, "1", "T"),
    "t2e_dense_bgen": ("bgen", "pheno_t2e.txt", T2E, "0", "T"),
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_cli_matches_jax(data, scenario, monkeypatch):
    """The port's --af-cc run against the JAX package's on the same route:
    the same files; the case/control columns hold -1 on these traits."""
    ds, table, flags, route, prefix = SCENARIOS[scenario]
    d, src = data[ds]
    argv = ["--step", "2", *src, "--phenoFile", f"{d}/{table}",
            "--covarFile", f"{d}/covar.txt", "--remove", f"{d}/remove.txt",
            "--ignore-pred", "--bsize", "64", "--af-cc", *flags]
    jx, pt = f"{d}/jax_{scenario}", f"{d}/pt_{scenario}"
    env = (("REGENIE_TPU_FUSED", route),)
    run_jax(argv + ["--out", jx], monkeypatch, env)
    log = run_port(argv + ["--out", pt], monkeypatch, env if route == "0" else ())
    if route == "0":
        assert "dense scorer on cpu" in log
    else:
        assert "fused packed-bytes scorer on cpu" in log and "dense route: 0 of" in log
    n = NT if prefix == "T" else 3
    outs = ([".regenie", ".regenie.Ydict"] if prefix is None
            else [f"_{prefix}{p + 1}.regenie" for p in range(n)])
    same = [files_close(jx + o, pt + o) for o in outs]
    lines = open(pt + outs[0]).read().splitlines()
    assert "A1FREQ_CASES" in lines[0] and len(lines) > 100
    if prefix is not None:
        k = lines[0].split().index("A1FREQ_CASES")
        assert {ln.split()[k] for ln in lines[1:]} <= {"-1", "NA"}
    print(f"{scenario}: {len(lines) - 1} rows, byte-identical per file = {same}")
