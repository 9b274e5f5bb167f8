"""LD-matrix mode (--compute-corr) in the port against the JAX package,
both on the CPU in this process, on synthetic BED and BGEN files (N =
500):

- the imputation bit for bit against the JAX package's per-row loop
  (run_ldcomp) on int8 codes with missing values and an unanalysed
  sample set, and ld_gram against G G' of that loop's block after the
  projection (rel 1e-12);
- run_genebased.build_requested_masks against the JAX package's;
- the CLI against `python -m regenie_tpu`: the binary uint16 r^2 (the
  default), --output-corr-text, --skip-scaleG, --skip-scaleG with
  --sparse-thr, --ld-extract with variant rows, mask rows and names the
  data lacks, --forcein-vars with --extract, and BGEN dosages. Every file
  byte for byte, or each number within rel 1e-9; a binary r^2 code may
  differ by 1 only where the port's own r^2 * 65535 + 0.5 lies within
  1e-6 of an integer.
"""

import os

import numpy as np
import pytest
import torch

from chip_smoke import write_bgen_dataset, write_dataset, write_gene_files
from test_torch_interaction import run_jax, run_port

N = 500
CHROMS = ((1, 90), (2, 50))


def _jax_impute(G, ind):
    """The JAX package's LD imputation (regenie_tpu/run_step2.py
    run_ldcomp), row by row in numpy."""
    G = np.array(G, dtype=np.float64)
    for k in range(G.shape[0]):
        m = (G[k] != -3) & ind
        mu = G[k][m].mean() if m.any() else 0.0
        G[k] = np.where((G[k] == -3) | ~ind, np.where(~ind, 0.0, mu), G[k])
        G[k] = np.where(~ind, 0.0, np.where(G[k] == -3, mu, G[k]))
    return G


def test_impute_and_gram_match_jax():
    """_ld_impute bit for bit on int8 codes (a row with every analysed
    sample missing included); ld_gram with a variant listed twice, mask
    rows and zero rows against the numpy block within rel 1e-12."""
    from regenie_tpu_torch.run_step2 import _ld_impute, ld_gram

    rng = np.random.default_rng(0)
    M, n, K = 9, 300, 4
    codes = rng.choice([0, 1, 2, -3], size=(M, n), p=[0.5, 0.3, 0.15, 0.05]).astype(np.int8)
    ind = rng.random(n) > 0.1
    codes[4, ind] = -3
    got = _ld_impute(torch.from_numpy(codes), torch.from_numpy(ind)).numpy()
    assert got.tobytes() == _jax_impute(codes, ind).tobytes()

    cov = np.linalg.qr(np.column_stack([np.ones(n), rng.normal(size=(n, K - 1))]))[0]
    cov *= ind[:, None]
    mvec = np.where(rng.random(n) < 0.05, -3.0, rng.random(n) * 2)
    rows = [0, 1, 3, 5, 6, 7]  # codes rows 0..5 at these rows; 6 = row 1 again
    src = np.concatenate([codes[:5], codes[:1]])
    vecs = {2: mvec}
    Gfull = np.zeros((8, n))
    for r, s in zip(rows, src):
        Gfull[r] = s
    Gfull[2] = mvec
    G = _jax_impute(Gfull, ind)
    G = G - (G @ cov) @ cov.T
    want = G @ G.T
    got = ld_gram(torch.from_numpy(src), rows, vecs, 8, torch.from_numpy(ind),
                  torch.from_numpy(cov)).numpy()
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    assert (got[4] == 0).all() and (got[:, 4] == 0).all()  # the zero row


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_ld")
    d = str(root / "bed")
    b = str(root / "bgen")
    for x in (d, b):
        os.makedirs(x)
    g = write_dataset(d, seed=41, N=N, chroms=CHROMS, P=2, n_inc=1, n_cov=3,
                      n_remove=5)
    write_gene_files(d, CHROMS, 10, 42)
    bg = write_bgen_dataset(b, seed=43, N=N, chroms=CHROMS, P=2, n_inc=1, n_cov=3,
                            n_remove=5)
    with open(f"{d}/ldlist.txt", "w") as fh:
        fh.write("sv v3\nmask G0.M3.0.5 G0\nsv vNOPE\nmask G1.M2.0.5 G1\n"
                 "mask G1.M9.0.5 G1\nsv v10\nsv v3\nmask G11.M3.singleton G11\n"
                 "sv v120\nmask G2.M1.0.5 G2\n")
    with open(f"{d}/extract.txt", "w") as fh:
        fh.write("v5\nv1\nvABSENT\nv77\nv1\nv130\n")
    with open(f"{d}/first60.txt", "w") as fh:
        fh.write("".join(f"v{i}\n" for i in range(0, 120, 2)))
    return d, g, b, bg


def test_build_requested_masks_matches_jax(data, monkeypatch):
    """The --ld-extract masks, built from the gene-based inputs, against
    the JAX package's: the same mask IDs and vectors bit for bit."""
    from regenie_tpu import cli as jcli
    from regenie_tpu.prep import prepare as jprep
    from regenie_tpu.run_genebased import build_requested_masks as jbuild
    from regenie_tpu.run_step2 import Step2Engine as JE
    from regenie_tpu_torch import cli as pcli
    from regenie_tpu_torch.prep import prepare as pprep
    from regenie_tpu_torch.run_genebased import build_requested_masks as pbuild
    from regenie_tpu_torch.run_step2 import Step2Engine as PE

    monkeypatch.setenv("REGENIE_TPU_PLATFORM", "cpu")
    d, g, _, _ = data
    argv = ["--step", "2", "--bed", g, "--phenoFile", f"{d}/pheno.txt",
            "--covarFile", f"{d}/covar.txt", "--ignore-pred", "--compute-corr",
            "--set-list", f"{d}/sets.txt", "--anno-file", f"{d}/anno.txt",
            "--mask-def", f"{d}/masks.txt", "--aaf-bins", "0.05,0.5", "--out", f"{d}/m"]
    want = {"G0": ["G0.M3.0.5", "G0.M1.0.05", "G0.M2.singleton"],
            "G3": ["G3.M1.0.5", "G3.M3.0.05"], "G9": ["G9.M2.0.5"]}
    out = []
    for cli, prep, E, build in ((jcli, jprep, JE, jbuild), (pcli, pprep, PE, pbuild)):
        params = cli.args_to_params(cli.build_parser().parse_args(argv))
        params.test_mode = True
        rd = prep(params, log=lambda *a: None)
        kw = {"device": "cpu"} if E is PE else {}
        eng = E(params, rd.geno, rd.pheno, None, lambda *a: None, **kw)
        out.append(build(params, eng, want, lambda *a: None))
    assert sorted(out[0]) == sorted(out[1]) and len(out[0]) >= 4
    for k in out[0]:
        assert np.asarray(out[0][k]).tobytes() == np.asarray(out[1][k], np.float64).tobytes(), k


def _port_ld(argv):
    """The port's run through run_step2 on the CPU: its engine's eng.ld."""
    from regenie_tpu_torch import cli
    from regenie_tpu_torch.run_step2 import run_step2

    params = cli.args_to_params(cli.build_parser().parse_args(argv))
    eng = run_step2(params, log=lambda *a: None, device="cpu")
    eng.gd.close()
    return eng.ld


def _corr_close(f, g, out, argv):
    """The JAX package's and the port's .corr files: bytes equal; text
    numbers within rel 1e-9; a binary code off by one only at a rounding
    tie of the port's own r^2 (module docstring). Returns the number of
    such codes."""
    a, b = open(f, "rb").read(), open(g, "rb").read()
    if a == b:
        return 0
    if "--output-corr-text" in argv or "--skip-scaleG" in argv:
        la, lb = a.decode().splitlines(), b.decode().splitlines()
        assert len(la) == len(lb)
        for ra, rb in zip(la, lb):
            ta, tb = ra.split(), rb.split()
            assert len(ta) == len(tb), (ra, rb)
            for xa, xb in zip(ta, tb):
                if xa != xb:
                    fa, fb = float(xa), float(xb)
                    assert abs(fa - fb) <= 1e-9 * max(1.0, abs(fa)), (ra, rb)
        return 0
    assert a[:8] == b[:8] and len(a) == len(b)
    ca = np.frombuffer(a[8:], np.uint16).astype(np.int64)
    cb = np.frombuffer(b[8:], np.uint16).astype(np.int64)
    LD = _port_ld(argv[:-2] + ["--out", out + "_again"]).LD
    v = LD[np.triu_indices(LD.shape[0], k=1)] ** 2 * 65535 + 0.5
    off = ca != cb
    assert (np.abs(ca - cb) <= 1).all()
    assert (np.abs(v[off] - np.round(v[off])) <= 1e-6).all()
    return int(off.sum())


SCENARIOS = {
    "binary": [],
    "text": ["--output-corr-text"],
    "skip_scaleG": ["--skip-scaleG"],
    "sparse": ["--skip-scaleG", "--sparse-thr", "0.2"],
    "ld_extract": ["--ld-extract", "{d}/ldlist.txt", "--set-list", "{d}/sets.txt",
                   "--anno-file", "{d}/anno.txt", "--mask-def", "{d}/masks.txt",
                   "--aaf-bins", "0.5"],
    "ld_extract_text": ["--ld-extract", "{d}/ldlist.txt", "--set-list",
                        "{d}/sets.txt", "--anno-file", "{d}/anno.txt", "--mask-def",
                        "{d}/masks.txt", "--aaf-bins", "0.5", "--output-corr-text"],
    "forcein": ["--extract", "{d}/extract.txt", "--forcein-vars",
                "--output-corr-text"],
    "bgen": ["--extract", "{d}/first60.txt"],
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_cli_matches_jax(data, scenario, monkeypatch):
    """The port's --compute-corr CLI against the JAX package's on the same
    files: the .corr, .corr.snplist and .corr.forcedIn.snplist files."""
    d, g, b, bg = data
    if scenario == "bgen":
        src = ["--bgen", bg, "--sample", f"{b}/geno.sample"]
        tables = b
    else:
        src, tables = ["--bed", g], d
    flags = [f.format(d=d) for f in SCENARIOS[scenario]]
    argv = ["--step", "2", *src, "--phenoFile", f"{tables}/pheno.txt",
            "--covarFile", f"{tables}/covar.txt", "--remove", f"{tables}/remove.txt",
            "--ignore-pred", "--compute-corr", *flags]
    jx, pt = f"{d}/jax_{scenario}", f"{d}/pt_{scenario}"
    run_jax(argv + ["--out", jx], monkeypatch)
    log = run_port(argv + ["--out", pt], monkeypatch)
    assert "LD matrix (" in log
    for ext in (".corr.snplist", ".corr.forcedIn.snplist"):
        assert os.path.exists(jx + ext) == os.path.exists(pt + ext), ext
        if os.path.exists(jx + ext):
            assert open(jx + ext).read() == open(pt + ext).read()
    ties = _corr_close(jx + ".corr", pt + ".corr", pt, argv + ["--out", pt])
    M = len(open(pt + ".corr.snplist").read().splitlines())
    assert M >= 5
    if scenario.startswith("ld_extract") or scenario == "forcein":
        forced = open(pt + ".corr.forcedIn.snplist").read().split()
        assert forced and "vNOPE" in forced + ["vNOPE"] * (scenario == "forcein")
        if scenario.startswith("ld_extract"):
            # masks that the sets build are rows of their own
            names = open(pt + ".corr.snplist").read().split()
            assert [m for m in names if ".M" in m and m not in forced]
    print(f"{scenario}: {M} rows, binary codes at a rounding tie: {ties}")
