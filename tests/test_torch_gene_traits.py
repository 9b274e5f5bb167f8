"""The port's gene-based Step 2 on binary, count and time-to-event traits
against `python -m regenie_tpu`, both on the CPU in this process, on the
synthetic inputs of tests/test_torch_gene.py: binary traits with
--firth --approx, --spa (and its mask flips) and plain, with the VC tests
(calibrated by Firth or SPA) and joint tests, --htp, --write-mask, on
BED, PGEN (hardcalls and dosages) and BGEN; count and time-to-event
traits with burden masks and
joint tests (their VC tests are skipped with the JAX package's warning).
The bar is tests/test_torch_gene_cli.py's.
"""

import pytest

from test_torch_gene import compare_outputs, gene_inputs, row_tests, run_pair


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    return gene_inputs(str(tmp_path_factory.mktemp("torch_gene_traits")))


# id: (format, trait, flags, the tests expected in the rows)
SCENARIOS = {
    "bt_firth_bed": ("bed", "bt", ["--firth", "--approx", "--vc-tests",
                                   "skat,skato,skato-acat,acatv,acato", "--joint",
                                   "acat,minp"],
                     {"ADD", "ADD-SKAT", "ADD-SKATO", "ADD-ACATV", "ADD-BURDEN-ACAT"}),
    "bt_spa_write_mask": ("bed", "bt", ["--spa", "--vc-tests", "skato,acatv",
                                        "--write-mask", "--joint", "acat"],
                          {"ADD", "ADD-SKATO", "ADD-ACATV"}),
    "bt_firth_htp": ("bed", "bt", ["--firth", "--approx", "--htp", "C1",
                                   "--vc-tests", "skato-acat,acatv", "--joint", "acat"],
                     set()),
    "bt_plain_genep": ("bed", "bt", ["--rgc-gene-p", "--vc-maxAAF", "0.05"],
                       {"ADD", "GENE_P", "ADD-ACATV"}),
    "bt_firth_pgen": ("pgen", "bt", ["--firth", "--approx", "--vc-tests", "skato,acatv"],
                      {"ADD", "ADD-SKATO"}),
    "bt_spa_bgen": ("bgen", "bt", ["--spa", "--vc-tests", "skat,acatv", "--joint",
                                   "acat"], {"ADD", "ADD-SKAT"}),
    "bt_firth_pgen_dosages": ("pgend", "bt", ["--firth", "--approx", "--vc-tests",
                                              "skato,acatv"], {"ADD", "ADD-SKATO"}),
    "ct_pgen_dosages": ("pgend", "ct", ["--joint", "minp"], {"ADD", "ADD-BURDEN-MINP"}),
    "ct_burden": ("bed", "ct", ["--joint", "acat,minp", "--vc-tests", "skat"],
                  {"ADD", "ADD-BURDEN-ACAT"}),
    "ct_bgen_htp": ("bgen", "ct", ["--htp", "C1"], set()),
    "t2e_burden": ("bed", "t2e", ["--firth", "--approx", "--joint", "acat"],
                   {"ADD", "ADD-BURDEN-ACAT"}),
    "t2e_pgen": ("pgen", "t2e", ["--vc-tests", "acatv"], {"ADD"}),
}


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_cli_gene_traits_match_jax(dirs, scenario, monkeypatch):
    fmt, trait, flags, want = SCENARIOS[scenario]
    jx, pt, pair = run_pair(dirs, fmt, trait, flags, scenario, monkeypatch)
    rows = compare_outputs(jx, pt, min_rows=3, pair=pair)
    seen = set()
    for r in rows.values():
        seen |= set(row_tests(r))
    assert want <= seen, (want - seen)
    if trait in ("ct", "t2e") and "--vc-tests" in flags:
        log = open(pt + ".log").read()
        assert "VC tests only implemented for QT/BT traits" in log
