"""Multi-process runs of the port with tests/test_torch_multiprocess.py's
runner and rules: Step 1 on BED (K-fold), on BGEN and with --loocv (the
per-host sample window: each process unpacks only its own sample bytes,
and the sums run on the file sample axis, so its .loco files are held
within rel 1e-9, not byte for byte), and the process-sharded loops:
--mt --strict --no-split and --multiphen --strict (rows round-robin), a
gene-based --set-list run (sets round-robin) and a GxE interaction run
(contiguous SNP chunks, robust and HLM rows).
"""

import pytest

from test_torch_multiprocess import check_scenario, data  # noqa: F401

S1 = ["--step", "1", "--bsize", "16"]
S2 = ["--step", "2", "--ignore-pred", "--bsize", "16"]
GENE = ["--set-list", "{d}/sets.txt", "--anno-file", "{d}/anno.txt", "--mask-def",
        "{d}/masks.txt", "--vc-tests", "skato,acatv", "--joint", "acat"]
# id: (dataset, phenotype table, flags, env, torchrun)
SCENARIOS = {
    "step1_bed": ("bed", "pheno.txt", S1, (), False),
    "step1_bgen": ("bgen", "pheno.txt", S1, (), False),
    "step1_loocv": ("bed", "pheno.txt", S1 + ["--loocv"], (), False),
    "mt": ("bed", "pheno.txt", S2 + ["--mt", "--strict", "--no-split"], (), False),
    "multiphen": ("bed", "pheno.txt", S2 + ["--multiphen", "--strict"], (), False),
    "gene": ("bed", "pheno.txt", S2 + GENE, (), False),
    "gxe": ("bed", "pheno.txt", S2 + ["--interaction", "C1", "--rare-mac", "20"], (),
            False),
}
LOGGED = {
    "step1_loocv": "per-host decode: each of 2 processes unpacks only its own sample",
    "mt": "multi-process multi-trait tests: 2 processes",
    "multiphen": "multi-process MultiPhen: 2 processes",
    "gene": "multi-process gene-based tests: 2 processes",
}


@pytest.mark.parametrize("sid", list(SCENARIOS))
def test_multiprocess_modes_match_single(data, sid, tmp_path):  # noqa: F811
    log0 = check_scenario(data, sid, SCENARIOS[sid], tmp_path,
                          exact=sid != "step1_loocv")
    if sid in LOGGED:
        assert LOGGED[sid] in log0
    if sid.startswith("step1"):
        assert "sample-axis sharding for level 0" in log0
