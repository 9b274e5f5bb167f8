"""Tests of the port's Step-2 output options against `REGENIE_TPU_FUSED=1
python -m regenie_tpu` on the CPU (both in this process), on a chrX BED
and a PGEN with --remove: merged output (--no-split: <out>.regenie and
its .Ydict, whose N_RR / N_AA carry the hemizygous class counts on chrX),
gzipped output (--gz: split, merged and --htp, compared decompressed),
--write-samples (with --print-pheno), --print-cov-betas (with a
categorical covariate) and --debug's model inputs; and the parallel
gzip writer itself."""

import gzip
import os

import numpy as np
import pytest

from chip_smoke import chrx_positions, write_dataset, write_pgen_dataset
from regenie_tpu_torch.io.files import GzipWriter, open_write

CHROMS = ((1, 90), ("X", 110))
POS = {"X": chrx_positions(110, 10, 10)}


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    pytest.importorskip("jax")
    out = {}
    for src, writer in (("bed", write_dataset), ("pgen", write_pgen_dataset)):
        d = str(tmp_path_factory.mktemp(f"torch_output_{src}"))
        prefix = writer(d, seed=31, N=420, chroms=CHROMS, P=3, n_inc=1,
                        n_cov=3, na_rate=0.1, n_remove=8, effect_sd=0.5,
                        positions=POS)
        # a categorical covariate beside the three numeric ones
        rows = open(f"{d}/covar.txt").read().splitlines()
        with open(f"{d}/covar.txt", "w") as fh:
            fh.write(rows[0] + " S\n")
            fh.write("".join(f"{r} {'abc'[i % 3]}\n" for i, r in enumerate(rows[1:])))
        out[src] = (d, [f"--{src}", prefix])
    return out


def _run_both(d, argv, tag, monkeypatch):
    from regenie_tpu import cli as jcli

    from regenie_tpu_torch import cli
    from regenie_tpu_torch.utils.device import DEVICE_ENV

    monkeypatch.setenv("REGENIE_TPU_FUSED", "1")
    monkeypatch.setenv("REGENIE_TPU_PLATFORM", "cpu")
    monkeypatch.setenv(DEVICE_ENV, "cpu")
    jx, pt = f"{d}/jax_{tag}", f"{d}/pt_{tag}"
    jcli.main(argv + ["--out", jx])
    cli.main(argv + ["--out", pt])
    return jx, pt


def _text(path):
    if path.endswith(".gz"):
        with gzip.open(path, "rt") as fh:
            return fh.read()
    return open(path).read()


def _same_rows(a, b, tmp):
    """The two files' (decompressed) rows under _assert_rows_equiv's
    rule; returns whether the texts are identical."""
    from test_torch_step2 import _assert_rows_equiv

    ta, tb = _text(a), _text(b)
    fa, fb = os.path.join(tmp, "a.txt"), os.path.join(tmp, "b.txt")
    open(fa, "w").write(ta)
    open(fb, "w").write(tb)
    _assert_rows_equiv(fa, fb)
    return ta == tb


SCENARIOS = {
    "nosplit": (["--no-split"], [".regenie", ".regenie.Ydict"]),
    "nosplit_gz": (["--no-split", "--gz"], [".regenie.gz", ".regenie.Ydict"]),
    "split_gz": (["--gz"], [f"_Y{p}.regenie.gz" for p in (1, 2, 3)]),
    "htp_gz": (["--gz", "--htp", "C"], [f"_Y{p}.regenie.gz" for p in (1, 2, 3)]),
}


@pytest.mark.parametrize("src", ["bed", "pgen"])
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_output_files_match_jax(datasets, src, scenario, monkeypatch, tmp_path):
    """Merged and gzipped outputs: the merged file's rows (N_RR, N_RA,
    N_AA and every trait's four fields, chrX hemizygous counts included)
    and its .Ydict equal the JAX package's, the gzipped files decompress
    to its text; both within _assert_rows_equiv's rule, the .Ydict byte
    for byte. A .gz file is valid gzip, and is the only file written."""
    d, geno = datasets[src]
    flags, suffixes = SCENARIOS[scenario]
    argv = ["--step", "2", *geno, "--phenoFile", f"{d}/pheno.txt",
            "--covarFile", f"{d}/covar.txt", "--catCovarList", "S",
            "--remove", f"{d}/remove.txt", "--bsize", "64", "--ignore-pred",
            *flags]
    jx, pt = _run_both(d, argv, f"{scenario}", monkeypatch)
    for sfx in suffixes:
        assert os.path.exists(pt + sfx), pt + sfx
        if sfx.endswith(".gz"):
            assert not os.path.exists(pt + sfx[:-3])
            assert open(pt + sfx, "rb").read(2) == b"\x1f\x8b"
        if sfx.endswith("Ydict"):
            assert open(jx + sfx, "rb").read() == open(pt + sfx, "rb").read()
            assert open(pt + sfx).read() == "Y1 Y1\nY2 Y2\nY3 Y3\n"
        else:
            _same_rows(jx + sfx, pt + sfx, str(tmp_path))
    if scenario.startswith("nosplit"):
        rows = _text(pt + suffixes[0]).splitlines()
        assert rows[0].split()[6:11] == ["N", "N_RR", "N_RA", "N_AA", "TEST"]
        assert 190 < len(rows) <= 201 and sum(r.startswith("23 ") for r in rows) > 100


@pytest.mark.parametrize("src", ["bed", "pgen"])
def test_side_files_match_jax(datasets, src, monkeypatch):
    """--write-samples (with --print-pheno) writes each trait's
    <out>_<trait>.regenie.ids, --print-cov-betas <out>_cov_betas.txt (a
    categorical covariate's levels named as in the JAX package) and
    --debug the model inputs <out>_y.txt and <out>_x.txt: each byte for
    byte the JAX package's; the association files too."""
    d, geno = datasets[src]
    argv = ["--step", "2", *geno, "--phenoFile", f"{d}/pheno.txt",
            "--covarFile", f"{d}/covar.txt", "--catCovarList", "S",
            "--remove", f"{d}/remove.txt", "--bsize", "64", "--ignore-pred",
            "--write-samples", "--print-pheno", "--print-cov-betas", "--debug"]
    jx, pt = _run_both(d, argv, "side", monkeypatch)
    sfx = ([f"_Y{p}.regenie.ids" for p in (1, 2, 3)]
           + ["_cov_betas.txt", "_y.txt", "_x.txt"]
           + [f"_Y{p}.regenie" for p in (1, 2, 3)])
    for s in sfx:
        assert open(jx + s, "rb").read() == open(pt + s, "rb").read(), s
    ids = open(f"{pt}_Y1.regenie.ids").read().splitlines()
    assert ids[0] == "Y1\tNA" and 300 < len(ids) < 420
    betas = open(f"{pt}_cov_betas.txt").read().splitlines()
    assert [r.split("\t")[0] for r in betas[1::3]] == [
        "Intercept", "C1", "C2", "C3", "S=b", "S=c"]


def test_gzip_writer_members(tmp_path, monkeypatch):
    """GzipWriter: text written in pieces of any size and flushed as
    several members, compressed in parallel threads, decompresses to the
    same text through gzip.open; the same text gives the same bytes; an
    empty writer leaves an empty, valid file."""
    monkeypatch.setattr(GzipWriter, "FLUSH_AT", 5000)
    monkeypatch.setattr(GzipWriter, "PIECE", 1500)
    rng = np.random.default_rng(0)
    text = "".join(f"{i} {x:g}\n" for i, x in enumerate(rng.normal(size=3000)))
    cuts = np.sort(rng.integers(0, len(text), 200))
    blobs = []
    for k in range(2):
        path = str(tmp_path / f"t{k}.txt")
        with open_write(path, gz=True) as fh:
            for a, b in zip(np.r_[0, cuts], np.r_[cuts, len(text)]):
                fh.write(text[a:b])
        assert fh.closed and not os.path.exists(path)
        blobs.append(open(path + ".gz", "rb").read())
        assert blobs[-1].count(b"\x1f\x8b\x08") > 10  # many members
        with gzip.open(path + ".gz", "rt") as g:
            assert g.read() == text
    assert blobs[0] == blobs[1]
    with open_write(str(tmp_path / "e.gz")):
        pass
    with gzip.open(str(tmp_path / "e.gz"), "rt") as g:
        assert g.read() == ""


@pytest.mark.parametrize("src", ["bed", "pgen"])
@pytest.mark.parametrize("flags", [["--htp", "C"], []])
def test_python_rows_match_jax(datasets, src, flags, monkeypatch, tmp_path):
    """Where the root native library is absent (the card's machine), rows
    render in Python (merged rows always do): HTP and split files
    rendered that way, and gzipped, decompress to what the JAX package
    writes."""
    from regenie_tpu_torch import run_step2

    monkeypatch.setattr(run_step2, "native_formatter", lambda name: None)
    d, geno = datasets[src]
    argv = ["--step", "2", *geno, "--phenoFile", f"{d}/pheno.txt",
            "--covarFile", f"{d}/covar.txt", "--catCovarList", "S",
            "--remove", f"{d}/remove.txt", "--bsize", "64", "--ignore-pred",
            "--gz", *flags]
    jx, pt = _run_both(d, argv, "py" + "".join(flags), monkeypatch)
    for o in (f"_Y{p}.regenie.gz" for p in (1, 2, 3)):
        assert _same_rows(jx + o, pt + o, str(tmp_path))
