"""Tests of the analysis options the port's dense slice brings with it,
each against the JAX package on the CPU (both in this process):
conditional analysis (--condition-list on the main BED or BGEN,
--condition-file bed|bgen|pgen with --condition-file-sample), the
transposed phenotype file (--tpheno-file), --force-ltco on a two-step
run, and Step 1 on BGEN (level 0 on float64 dosages)."""

import os

import pytest

from chip_smoke import (_compare_loco, write_bgen_dataset, write_dataset,
                        write_pgen_dataset)

P = 3


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A BED and a BGEN of the same 500 samples (the main files), and a
    BED, a BGEN and a PGEN of them as external conditioning files."""
    base = str(tmp_path_factory.mktemp("torch_condition"))
    kw = dict(N=500, P=P, n_inc=1, n_cov=3, na_rate=0.1, n_remove=6,
              effect_sd=0.6, chroms=((1, 120), (2, 80)))
    out = {}
    for name, fn, seed in (("bed", write_dataset, 41), ("bgen", write_bgen_dataset, 42),
                           ("ext_bed", write_dataset, 43),
                           ("ext_bgen", write_bgen_dataset, 44),
                           ("ext_pgen", write_pgen_dataset, 45)):
        d = os.path.join(base, name)
        os.makedirs(d)
        out[name] = fn(d, seed=seed, **kw)
    with open(os.path.join(base, "cond.txt"), "w") as fh:
        fh.write("v5\nv17\nv130\nnot_a_variant\n")
    return base, out


def _run(argv, monkeypatch, fused_jax=True):
    """The JAX package's CLI (REGENIE_TPU_FUSED=1: its fused path on the
    CPU, the port's default) and the port's, on the same argv with the
    --out prefix given last; returns the two prefixes."""
    from regenie_tpu import cli as jcli
    from regenie_tpu_torch import cli
    from regenie_tpu_torch.utils.device import DEVICE_ENV

    out = argv[-1]
    monkeypatch.setenv(DEVICE_ENV, "cpu")
    if fused_jax:
        monkeypatch.setenv("REGENIE_TPU_FUSED", "1")
    jcli.main(argv[:-1] + [out + "_jax"])
    monkeypatch.delenv("REGENIE_TPU_FUSED", raising=False)
    cli.main(argv[:-1] + [out + "_pt"])
    return out + "_jax", out + "_pt"


def _main_args(base, out, src):
    if src == "bgen":
        geno = ["--bgen", out["bgen"], "--sample", f"{base}/bgen/geno.sample"]
    else:
        geno = ["--bed", out["bed"]]
    d = f"{base}/{src}"
    return geno + ["--phenoFile", f"{d}/pheno.txt", "--covarFile",
                   f"{d}/covar.txt", "--remove", f"{d}/remove.txt"]


COND_IDS = ("v5", "v17", "v130")  # the variants of cond.txt found in the files


def _equiv(jx, pt, names=("Y1", "Y2", "Y3"), cond=()):
    """The JAX package's files against the port's, every numeric field
    within rel 1e-9 (test_torch_step2._assert_rows_equiv). On the rows of
    the conditioning variants of the main file themselves (`cond`) the
    variant lies in the covariate span, so its residual and every score
    field are rounding noise in both packages: there only the fields up
    to TEST are held to the bar."""
    for n in names:
        la = open(f"{jx}_{n}.regenie").read().splitlines()
        lb = open(f"{pt}_{n}.regenie").read().splitlines()
        assert la[0] == lb[0] and len(la) == len(lb) > 1
        upto = la[0].split().index("TEST")
        for ra, rb in zip(la[1:], lb[1:]):
            ta, tb = ra.split(), rb.split()
            assert len(ta) == len(tb) and ta[2] == tb[2]
            for xa, xb in list(zip(ta, tb))[: upto if ta[2] in cond else None]:
                if xa != xb:
                    a, b = float(xa), float(xb)  # raises on an NA mismatch
                    assert abs(a - b) <= 1e-9 * max(1.0, abs(a)), (ra, rb)


@pytest.mark.parametrize("src", ["bed", "bgen"])
def test_condition_list_matches_jax(data, src, monkeypatch):
    """--condition-list on the main file: the listed variants (read from
    it, mean-imputed) join the covariates; the rows equal the JAX
    package's within rel 1e-9, and differ from the unconditioned run."""
    base, out = data
    common = ["--step", "2", *_main_args(base, out, src), "--ignore-pred",
              "--bsize", "64"]
    jx, pt = _run(common + ["--condition-list", f"{base}/cond.txt",
                            "--out", f"{base}/cl_{src}"], monkeypatch)
    _equiv(jx, pt, cond=COND_IDS)
    assert "n_used = 3" in open(f"{pt}.log").read()
    _, plain = _run(common + ["--out", f"{base}/nocl_{src}"], monkeypatch)
    assert open(f"{plain}_Y1.regenie").read() != open(f"{pt}_Y1.regenie").read()


@pytest.mark.parametrize("fmt", ["bed", "bgen", "pgen"])
def test_condition_file_matches_jax(data, fmt, monkeypatch):
    """--condition-file FORMAT,FILE (with --condition-list naming the
    variants, and --condition-file-sample for BGEN): the external file's
    variants, mapped onto the main samples, join the covariates."""
    base, out = data
    ext = out[f"ext_{fmt}"]
    extra = ["--condition-file", f"{fmt},{ext}", "--condition-list",
             f"{base}/cond.txt"]
    if fmt == "bgen":
        extra += ["--condition-file-sample", f"{base}/ext_bgen/geno.sample"]
    jx, pt = _run(["--step", "2", *_main_args(base, out, "bed"), "--ignore-pred",
                   "--bsize", "64", *extra, "--out", f"{base}/cf_{fmt}"],
                  monkeypatch)
    _equiv(jx, pt)


def test_tpheno_file_matches_jax(data, monkeypatch):
    """--tpheno-file (one row per trait, a column per FID_IID sample) with
    --condition-list, in one run: the rows equal the JAX package's, and
    equal the port's own run on the untransposed file."""
    base, out = data
    d = f"{base}/bed"
    rows = [ln.split() for ln in open(f"{d}/pheno.txt").read().splitlines()]
    with open(f"{base}/tpheno.txt", "w") as fh:
        fh.write("ID " + " ".join(f"{r[0]}_{r[1]}" for r in rows[1:]) + "\n")
        for j, name in enumerate(rows[0][2:]):
            fh.write(name + " " + " ".join(r[2 + j] for r in rows[1:]) + "\n")
    geno = ["--bed", out["bed"], "--covarFile", f"{d}/covar.txt", "--remove",
            f"{d}/remove.txt", "--ignore-pred", "--bsize", "64",
            "--condition-list", f"{base}/cond.txt"]
    jx, pt = _run(["--step", "2", *geno, "--tpheno-file", f"{base}/tpheno.txt",
                   "--out", f"{base}/tp"], monkeypatch)
    _equiv(jx, pt, cond=COND_IDS)
    _, plain = _run(["--step", "2", *geno, "--phenoFile", f"{d}/pheno.txt",
                     "--out", f"{base}/tp_plain"], monkeypatch)
    for n in ("Y1", "Y2", "Y3"):
        assert open(f"{plain}_{n}.regenie").read() == open(f"{pt}_{n}.regenie").read()


def _step1(base, out, src, tag, monkeypatch):
    args = ["--step", "1", *_main_args(base, out, src), "--bsize", "50",
            "--out", f"{base}/{tag}"]
    return _run(args, monkeypatch, fused_jax=False)


def test_step1_on_bgen_matches_jax(data, monkeypatch):
    """Step 1 on BGEN dosages (K-fold): every .loco value within one unit
    of its sixth significant digit of the JAX package's Step 1."""
    base, out = data
    jx, pt = _step1(base, out, "bgen", "s1_bgen", monkeypatch)
    assert "level 0 on cpu" in open(f"{pt}.log").read()
    for p in range(P):
        _compare_loco(f"{pt}_{p + 1}.loco", f"{jx}_{p + 1}.loco")


@pytest.mark.parametrize("src", ["bed", "bgen"])
def test_force_ltco_matches_jax(data, src, monkeypatch):
    """--force-ltco on a two-step run: Step 2 with --pred on the JAX
    package's Step-1 files (the .loco has a row for every chromosome, as
    read_ltco_prs demands) removes chromosome 2's share from chromosome
    1's predictions, as the JAX package does; the rows differ from the
    run without it."""
    base, out = data
    jx1, _ = _step1(base, out, src, f"ltco_s1_{src}", monkeypatch)
    common = ["--step", "2", *_main_args(base, out, src), "--pred",
              f"{jx1}_pred.list", "--bsize", "64"]
    jx, pt = _run(common + ["--force-ltco", "2", "--out", f"{base}/ltco_{src}"],
                  monkeypatch)
    _equiv(jx, pt)
    _, plain = _run(common + ["--out", f"{base}/noltco_{src}"], monkeypatch)
    a = open(f"{plain}_Y1.regenie").read().splitlines()
    b = open(f"{pt}_Y1.regenie").read().splitlines()
    chr1 = [i for i, r in enumerate(a) if r.startswith("1 ")]
    assert any(a[i] != b[i] for i in chr1)
