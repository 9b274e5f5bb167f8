"""More of the port's gene-based Step 2 on quantitative traits against
`python -m regenie_tpu` (the bar and the inputs of
tests/test_torch_gene_cli.py): 4-column annotations with domains and
--mask-lodo, variant weights (--weights-col, --multiply-weights); the
port's own files byte for byte the same at every bucket size and group
cap; GATES and SBAT on a complete trait (ROADMAP.md §3);
and cli.unported without gene-based tests.
"""

import numpy as np
import pytest

from test_torch_gene import compare_outputs, gene_inputs, row_tests, run_pair


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    return gene_inputs(str(tmp_path_factory.mktemp("torch_gene_options")))


def test_cli_gene_lodo_domains_matches_jax(dirs, monkeypatch):
    """4-column annotations: the per-domain masks of a plain run, then
    --mask-lodo on one set, mask and bin (the leave-one-domain-out masks)."""
    for tag, flags in (("dom", ["--vc-tests", "skato,acatv", "--joint", "acat"]),
                       ("lodo", ["--mask-lodo", "G5,M3,0.01"])):
        jx, pt, pair = run_pair(dirs, "bed", "qt", flags, tag, monkeypatch,
                          gene_dir=dirs["dom"])
        rows = compare_outputs(jx, pt, min_rows=2, pair=pair)
        ids = {r.split()[2] for rs in rows.values() for r in rs[2:]}
        if tag == "dom":
            assert any(".D1.M" in i for i in ids) and any(".D2.M" in i for i in ids)
        else:
            assert "G5.M3.0.01" in ids and any(".LODO_D" in i for i in ids)
            assert all(i.startswith("G5.") for i in ids)


def test_cli_gene_weights_match_jax(dirs, monkeypatch):
    """Variant weights from the annotation file (--weights-col 4), alone
    and multiplied by the Beta weights (--multiply-weights)."""
    for tag, flags in (("w", []), ("wmul", ["--multiply-weights"])):
        jx, pt, pair = run_pair(dirs, "bed", "qt", ["--weights-col", "4", "--vc-tests",
                                                   "skat,skato,acatv", *flags],
                               tag, monkeypatch, gene_dir=dirs["w"])
        rows = compare_outputs(jx, pt, min_rows=20, pair=pair)
        assert {"ADD", "ADD-SKAT", "ADD-ACATV"} <= set(row_tests(rows["_Y1.regenie"]))


def test_cli_gene_bucket_sizes_write_the_same_bytes(dirs, monkeypatch):
    """REGENIE_TPU_GENE_BUCKET = 1, 2 and 32 (the default) and a group cap
    of one set (REGENIE_TPU_GENE_GROUP_MB): the port's files are byte for
    byte the same, joint tests on the masks' block included."""
    from regenie_tpu_torch import cli
    from regenie_tpu_torch.utils.device import DEVICE_ENV

    d = dirs["bed"]
    monkeypatch.setenv(DEVICE_ENV, "cpu")
    common = ["--step", "2", "--bed", f"{d}/geno", "--phenoFile", f"{d}/pheno.txt",
              "--covarFile", f"{d}/covar.txt", "--remove", f"{d}/remove.txt",
              "--ignore-pred", "--set-list", f"{d}/sets.txt", "--anno-file",
              f"{d}/anno.txt", "--mask-def", f"{d}/masks.txt", "--vc-tests",
              "skato,acatv", "--joint", "acat,ftest,gates"]
    out = {}
    for b, env in (("1", {}), ("2", {}), ("32", {}),
                   ("g", {"REGENIE_TPU_GENE_GROUP_MB": "0.001"})):
        monkeypatch.setenv("REGENIE_TPU_GENE_BUCKET", b if b.isdigit() else "32")
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        cli.main(common + ["--out", f"{d}/bucket{b}"])
        for k in env:
            monkeypatch.delenv(k)
        out[b] = [open(f"{d}/bucket{b}_Y{p}.regenie", "rb").read() for p in (1, 2)]
    assert out["1"] == out["2"] == out["32"] == out["g"]
    assert out["1"][0].count(b"\n") > 200


def test_complete_trait_gates_sbat_follow_the_pivot_order(dirs, monkeypatch):
    """On a trait with no missing values every residualized mask column
    has the same norm (sqrt(N - K) after scaling), so the pivoted QR of
    the joint tests' input picks its columns by rounding, and GATES
    (which columns a rank-deficient set keeps) and SBAT (whose sampled
    Genz subsets follow the column order) then depend on it (ROADMAP.md
    §3). The port's GATES and SBAT values are the JAX package's own
    functions on the columns the port picked: recomputing them with
    regenie_tpu's joint._gates and joint._sbat on the port's inputs gives
    the same values."""
    from regenie_tpu.models import joint as jj
    from regenie_tpu_torch import cli
    from regenie_tpu_torch.models import joint as tj
    from regenie_tpu_torch.utils.device import DEVICE_ENV

    d = dirs["bed"]
    seen = {"_sbat": [], "_gates": []}

    def recorder(name):
        orig = getattr(tj, name)

        def record(*a, **kw):
            out = orig(*a, **kw)
            seen[name].append((tuple(np.copy(x) if isinstance(x, np.ndarray) else x
                                     for x in a), kw, out))
            return out

        return record

    for name in seen:
        monkeypatch.setattr(tj, name, recorder(name))
    monkeypatch.setenv(DEVICE_ENV, "cpu")
    cli.main(["--step", "2", "--bed", f"{d}/geno", "--phenoFile", f"{d}/pheno.txt",
              "--covarFile", f"{d}/covar.txt", "--remove", f"{d}/remove.txt",
              "--ignore-pred", "--set-list", f"{d}/sets.txt", "--anno-file",
              f"{d}/anno.txt", "--mask-def", f"{d}/masks.txt", "--joint",
              "gates,sbat", "--phenoColList", "Y2", "--out", f"{d}/complete_y2"])
    assert len(seen["_sbat"]) > 5 and len(seen["_gates"]) > 5
    for name, calls in seen.items():
        for args, kw, out in calls:
            Gt = args[0]
            norms = np.linalg.norm(Gt, axis=0)
            np.testing.assert_allclose(norms, norms[0], rtol=1e-12)
            again = getattr(jj, name)(*args, **kw)
            if name == "_sbat":
                assert again[:2] == out[:2]
            else:
                assert again == out


@pytest.mark.parametrize("extra", [
    [], ["--interaction", "C1", "--mcc"], ["--mt", "--strict", "--no-split"],
    ["--multiphen", "--strict"],
    ["--mcc"],
    ["--compute-corr"], ["--af-cc"], ["--ct", "--af-cc"],
])
def test_unported_leaves_gene_based_tests(extra, monkeypatch):
    """cli.unported names no gene-based test: --set-list is ported, alone
    and beside the modes ported since (multi-trait, MultiPhen, MCC, beside
    interaction tests too, LD mode, --af-cc off binary traits); in a
    multi-process launch the run is refused for that, not for the sets
    (the other refusals are held by
    test_torch_step2.py::test_unported_mode_raises)."""
    from regenie_tpu_torch import cli

    for var in ("REGENIE_TPU_COORDINATOR", "REGENIE_TPU_DIST"):
        monkeypatch.delenv(var, raising=False)
    argv = ["--step", "2", "--bed", "g", "--phenoFile", "p", "--ignore-pred",
            "--set-list", "s", "--anno-file", "a", "--mask-def", "m",
            "--out", "o"] + extra
    params = cli.args_to_params(cli.build_parser().parse_args(argv))
    assert cli.unported(params) is None
    monkeypatch.setenv("REGENIE_TPU_DIST", "1")
    why = cli.unported(params)
    assert why is not None and "multi-process" in why and "gene-based" not in why
