"""The port's gene-based Step 2 on quantitative traits against `python -m
regenie_tpu`, both on the CPU in this process, on the synthetic inputs of
tests/test_torch_gene.py (BED, PGEN hardcalls and dosages, BGEN): every VC
test and joint test, GENE_P, HTP output, the mask writers, LOVO, LODO
with domains, --aaf-file, --extract-sets, --skip-test, the --build-mask
rules and the remeta LD files. Each .regenie file has the JAX package's
rows in its order, the fields up to TEST identical and every number
within rel 1e-9; every other file is the same bytes; but the VC rows of a
set whose SKAT/SKATO tails the reference itself decides by rounding
(test_torch_gene.compare_outputs, ROADMAP.md §3) are held through their
inputs, a witness and a replay instead. Bucket sizes 1, 2 and 32 write
the same bytes.

The JAX package's joint tests that read the masks' residualized block
(F-test, GATES, SBAT and GENE_P's SBAT) index it per set only when each
chromosome run holds one set, so its runs with those tests use
REGENIE_TPU_GENE_BUCKET=1 (ROADMAP.md §3); the port gives every set its
own rows at any bucket size.
"""

import os

import pytest

from test_torch_gene import compare_outputs, gene_inputs, row_tests, run_pair

ALL_VC = "skat,skato,skato-acat,acatv,acato,acato-full"


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    return gene_inputs(str(tmp_path_factory.mktemp("torch_gene_cli")))


# id: (format, flags, JAX bucket, the tests expected in the rows)
SCENARIOS = {
    "bed_vc_joint": ("bed", ["--aaf-bins", "0.01,0.05", "--vc-tests", ALL_VC,
                             "--joint", "minp,acat,ftest"], 1,
                     {"ADD", "ADD-SKAT", "ADD-SKATO", "ADD-SKATO-ACAT", "ADD-ACATV",
                      "ADD-ACATO", "ADD-BURDEN-MINP", "ADD-BURDEN-ACAT",
                      "ADD-BURDEN-F"}),
    "bed_gates_sbat_incomplete": ("bed", ["--joint", "gates,sbat,acat",
                                          "--phenoColList", "Y1", "--sbat-napprox", "20"],
                                  1, {"ADD", "ADD-BURDEN-GATES", "ADD-BURDEN-SBAT",
                                      "ADD-BURDEN-ACAT"}),
    "bed_genep": ("bed", ["--rgc-gene-p", "--skip-sbat", "--vc-maxAAF", "0.05"], None,
                  {"ADD", "ADD-ACATV", "ADD-SKATO-ACAT", "GENE_P",
                   "ADD-BURDEN-ACAT"}),
    "bed_genep_sbat_y1": ("bed", ["--rgc-gene-p", "--phenoColList", "Y1"], 1,
                          {"ADD", "GENE_P", "ADD-BURDEN-SBAT"}),
    "bed_htp": ("bed", ["--htp", "C1", "--vc-tests", "skato,acatv", "--joint", "acat",
                        "--aaf-bins", "0.005,0.02"], None,
                {"ADD-LR", "ADD-SKATO", "ADD-ACATV", "ADD-BURDEN-ACAT"}),
    "bed_sum_rule_masks": ("bed", ["--build-mask", "sum", "--write-mask",
                                   "--write-mask-snplist", "--check-burden-files",
                                   "--vc-tests", "skat"], None, {"ADD", "ADD-SKAT"}),
    "bed_comphet_setlist": ("bed", ["--build-mask", "comphet", "--write-mask",
                                    "--write-setlist", "@SETLIST", "--joint", "minp"],
                            None, {"ADD", "ADD-BURDEN-MINP"}),
    "bed_aaf_file_extract": ("bed", ["--aaf-file", "@AAF", "--extract-sets", "@SETIDS",
                                     "--vc-tests", "acatv", "--singleton-carrier"],
                             None, {"ADD", "ADD-ACATV"}),
    "bed_lovo": ("bed", ["--mask-lovo", "G3,M3,0.01"], None, {"ADD"}),
    "bed_remeta": ("bed", ["--vc-tests", "skat", "--remeta-save-ld", "--vc-MACthr", "0"],
                   None, {"ADD", "ADD-SKAT"}),
    "bed_remeta_sparse": ("bed", ["--vc-tests", "skat", "--remeta-save-ld",
                                  "--remeta-ld-spr", "0.05", "--vc-MACthr", "0",
                                  "--exclude-sets", "@SETIDS"], None, {"ADD", "ADD-SKAT"}),
    "bed_skip_test": ("bed", ["--skip-test", "--write-mask"], None, set()),
    "bed_joint_only": ("bed", ["--joint", "acat,minp", "--joint-only"], None,
                       {"ADD-BURDEN-ACAT", "ADD-BURDEN-MINP"}),
    "pgen_vc": ("pgen", ["--vc-tests", ALL_VC, "--joint", "acat,minp"], None,
                {"ADD", "ADD-SKATO", "ADD-ACATO"}),
    "bgen_vc_joint": ("bgen", ["--vc-tests", ALL_VC, "--joint", "acat,ftest"], 1,
                      {"ADD", "ADD-SKATO", "ADD-BURDEN-F"}),
    "pgen_dosages_vc": ("pgend", ["--vc-tests", "skat,skato,acatv", "--joint", "acat",
                                  "--htp", "C1"], None,
                        {"ADD-LR", "ADD-SKATO", "ADD-ACATV", "ADD-BURDEN-ACAT"}),
}


def _resolve(flags, d):
    paths = {"@SETLIST": f"{d}/setlist_spec.txt", "@AAF": f"{d}/aaf.txt",
             "@SETIDS": f"{d}/set_ids.txt"}
    return [paths.get(f, f) for f in flags]


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_cli_gene_qt_matches_jax(dirs, scenario, monkeypatch):
    fmt, flags, jbucket, want = SCENARIOS[scenario]
    d = dirs[fmt]
    with open(f"{d}/setlist_spec.txt", "w") as fh:
        fh.write("LOF M1\nALL M3.0.01,M2.singleton\n")
    jx, pt, pair = run_pair(dirs, fmt, "qt", _resolve(flags, d), scenario, monkeypatch,
                      jax_bucket=jbucket)
    rows = compare_outputs(jx, pt, min_rows={"bed_skip_test": 0, "bed_lovo": 5}.get(
        scenario, 20), pair=pair)
    seen = set()
    for r in rows.values():
        seen |= set(row_tests(r))
    assert want <= seen, (want - seen)
    if scenario == "bed_joint_only":
        assert "ADD" not in seen
    if scenario == "bed_skip_test":
        assert all(len(r) == 2 for r in rows.values())  # ##MASKS + header
        assert os.path.getsize(pt + "_masks.bed") > 3
    if scenario == "bed_lovo":
        ids = [r.split()[2] for rs in rows.values() for r in rs[2:]]
        assert any("_v" in i for i in ids) and all(i.startswith("G3.") for i in ids)
    if "--write-mask" in flags:
        assert os.path.getsize(pt + "_masks.bim") > 0
