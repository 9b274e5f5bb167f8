"""Interaction tests (GxE, GxG, GxPRS) on quantitative traits in the
port's Step 2 against `python -m regenie_tpu`, both on the CPU in this
process, on small synthetic PLINK BED, BGEN and PGEN files (N = 900, 3
traits, --rare-mac 20 so that both routes run: the HC3/HC4 robust
sandwich for common SNPs, the HLM for rare ones):

- the routes: HC3, HC4 (--force-hc4), --no-robust, --force-robust, the
  HLM with and without --hlm-novquad, and the batched routes against the
  per-SNP ones (REGENIE_TPU_NO_BATCH_INT=1 on both sides);
- E: a continuous and a categorical covariate, --no-condtl,
  --force-condtl; GxG from the BED and from --interaction-file for BED,
  BGEN and PGEN; GxPRS from a Step-1 _pred.list; --print-vcov (the .vcov
  files too);
- every .regenie row within rel 1e-9 of the JAX package's, in its order;
- the HLM null fit's objective on the CPU twin against the JAX package's,
  and its stopping point under a 1e-15 perturbation of its inputs;
- the batched pieces (robust_batch, hlm_batch) against the per-SNP numpy.

One test needs an NVIDIA GPU (marker `cuda`): the robust and HLM chunks
on the card against their CPU twins. On the GPU machine, which has no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_interaction.py
"""

import glob
import os

import numpy as np
import pytest

from chip_smoke import write_bgen_dataset, write_dataset, write_pgen_dataset

N = 900
CHROMS = ((1, 120), (2, 80))
GXG_SNP = "v7"


def add_cat_covariate(d, seed=11):
    """d/covar_cat.txt: d/covar.txt with a 3-level column E3 (a, b, c)."""
    rng = np.random.default_rng(seed)
    lines = open(f"{d}/covar.txt").read().splitlines()
    lv = rng.choice(["a", "b", "c"], size=len(lines) - 1, p=[0.5, 0.3, 0.2])
    with open(f"{d}/covar_cat.txt", "w") as fh:
        fh.write(lines[0] + " E3\n")
        fh.write("".join(f"{ln} {v}\n" for ln, v in zip(lines[1:], lv)))


def make_data(root):
    """One directory a format (bed, bgen, pgen), the same samples,
    variants and tables (seed 5)."""
    out = {}
    for name, fn in (("bed", write_dataset), ("bgen", write_bgen_dataset),
                     ("pgen", write_pgen_dataset)):
        d = os.path.join(root, name)
        os.makedirs(d)
        g = fn(d, seed=5, N=N, P=3, n_inc=1, n_cov=3, n_remove=5, chroms=CHROMS)
        add_cat_covariate(d)
        out[name] = (d, g)
    return out


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return make_data(str(tmp_path_factory.mktemp("torch_interaction")))


def run_jax(argv, monkeypatch, env=()):
    from regenie_tpu import cli as jcli

    monkeypatch.setenv("REGENIE_TPU_PLATFORM", "cpu")
    for k, v in env:
        monkeypatch.setenv(k, v)
    jcli.main(argv)
    for k, _ in env:
        monkeypatch.delenv(k)


def run_port(argv, monkeypatch, env=()):
    from regenie_tpu_torch import cli
    from regenie_tpu_torch.utils.device import DEVICE_ENV

    monkeypatch.setenv(DEVICE_ENV, "cpu")
    for k, v in env:
        monkeypatch.setenv(k, v)
    cli.main(argv)
    for k, _ in env:
        monkeypatch.delenv(k)
    return open(argv[-1] + ".log").read()


def rows_close(f, g, rtol=1e-9, skip=None):
    """Two .regenie files: the same header, rows in the same order, the
    fields up to TEST identical and every number within rel rtol. skip:
    a set of (ID, TEST prefix-free) keys whose rows may differ or be
    absent on either side (their refits witnessed as rounding-decided).
    Returns the number of rows compared."""
    la = open(f).read().splitlines()
    lb = open(g).read().splitlines()
    assert la[0] == lb[0], (f, la[0], lb[0])
    if skip:
        la = [la[0]] + [r for r in la[1:] if r.split()[2] not in skip]
        lb = [lb[0]] + [r for r in lb[1:] if r.split()[2] not in skip]
    assert len(la) == len(lb) > 1, (f, len(la), len(lb))
    k = la[0].split().index("TEST") + 1
    for ra, rb in zip(la[1:], lb[1:]):
        ta, tb = ra.split(), rb.split()
        assert len(ta) == len(tb) and ta[:k] == tb[:k], (ra, rb)
        for xa, xb in zip(ta[k:], tb[k:]):
            if xa != xb:
                fa, fb = float(xa), float(xb)  # raises on an NA mismatch
                assert abs(fa - fb) <= rtol * max(1.0, abs(fa)), (ra, rb)
    return len(la) - 1


def interaction_tests(path):
    """The TEST strings of a file's interaction rows, as a set."""
    lines = open(path).read().splitlines()
    k = lines[0].split().index("TEST")
    return {ln.split()[k] for ln in lines[1:] if "-INT_" in ln.split()[k]}


def _src(name, d, g):
    if name == "bgen":
        return ["--bgen", g, "--sample", f"{d}/geno.sample"]
    return ["--pgen" if name == "pgen" else "--bed", g]


# id: (dataset, flags, env on both sides, the interaction tests expected)
ROB = {"ADD-INT_SNP", "ADD-INT_SNPxC1", "ADD-INT_2DF"}
SCENARIOS = {
    "hc3": ("bed", ["--interaction", "C1"], (), ROB),
    "hc4": ("bed", ["--interaction", "C1", "--force-hc4"], (), ROB),
    "no_robust": ("bed", ["--interaction", "C1", "--no-robust"], (), ROB),
    "force_robust": ("bed", ["--interaction", "C1", "--force-robust"], (), ROB),
    "hlm_novquad": ("bed", ["--interaction", "C1", "--hlm-novquad"], (), ROB),
    "per_snp": ("bed", ["--interaction", "C1", "--force-hc4"],
                (("REGENIE_TPU_NO_BATCH_INT", "1"),), ROB),
    "per_snp_hlm_novquad": ("bed", ["--interaction", "C1", "--hlm-novquad"],
                            (("REGENIE_TPU_NO_BATCH_INT", "1"),), ROB),
    "cat_e": ("bed", ["--interaction", "E3", "--catCovarList", "E3", "--covarFile",
                      "@CAT"], (),
              {"ADD-INT_SNP", "ADD-INT_SNPxE3=b", "ADD-INT_SNPxE3=c",
               "ADD-INT_SNPxE3", "ADD-INT_3DF"}),
    "cat_e_no_condtl": ("bed", ["--interaction", "E3", "--catCovarList", "E3",
                                "--covarFile", "@CAT", "--no-condtl"], (),
                        {"ADD-INT_E3=b", "ADD-INT_E3=c", "ADD-INT_SNP",
                         "ADD-INT_SNPxE3=b", "ADD-INT_SNPxE3=c", "ADD-INT_SNPxE3",
                         "ADD-INT_3DF"}),
    "no_condtl": ("bed", ["--interaction", "C1", "--no-condtl"], (),
                  {"ADD-INT_C1", "ADD-INT_SNP", "ADD-INT_SNPxC1", "ADD-INT_2DF"}),
    "gxg_bed": ("bed", ["--interaction-snp", GXG_SNP], (),
                {f"ADD-INT_{GXG_SNP}", "ADD-INT_SNP", f"ADD-INT_SNPx{GXG_SNP}",
                 "ADD-INT_2DF"}),
    # (with v7 both packages' HLM null fits fail alike: lstsq's SVD does
    # not converge)
    "gxg_force_condtl": ("bed", ["--interaction-snp", "v3", "--force-condtl"], (),
                         {"ADD-INT_SNP", "ADD-INT_SNPxv3", "ADD-INT_2DF"}),
    "gxg_file_bed": ("bed", ["--interaction-snp", GXG_SNP, "--interaction-file",
                             "bed,@BED"], (), None),
    "gxg_file_bgen": ("bed", ["--interaction-snp", GXG_SNP, "--interaction-file",
                              "bgen,@BGEN", "--interaction-file-sample", "@SAMPLE"],
                      (), None),
    "gxg_file_pgen": ("bed", ["--interaction-snp", GXG_SNP, "--interaction-file",
                              "pgen,@PGEN"], (), None),
    "bgen_hc3": ("bgen", ["--interaction", "C1", "--rare-mac", "200"], (), ROB),
    "pgen_hc3": ("pgen", ["--interaction", "C1"], (), ROB),
    "print_vcov": ("bed", ["--interaction", "C1", "--print-vcov"], (), ROB),
}


def _subst(flags, data):
    bed_d, bed_g = data["bed"]
    sub = {"@CAT": f"{bed_d}/covar_cat.txt", "@BED": data["bed"][1],
           "@BGEN": data["bgen"][1], "@SAMPLE": f"{data['bgen'][0]}/geno.sample",
           "@PGEN": data["pgen"][1]}
    out = []
    for f in flags:
        for k, v in sub.items():
            f = f.replace(k, v)
        out.append(f)
    return out


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_qt_interaction_matches_jax(data, scenario, monkeypatch):
    """The port's QT interaction rows on the CPU against the JAX
    package's on the same route: every row within rel 1e-9 in order;
    both the robust and the HLM route ran (the log's counts) where the HLM
    is on; with --print-vcov every .vcov file within rel 1e-9."""
    name, flags, env, want = SCENARIOS[scenario]
    d, g = data[name]
    flags = _subst(flags, data)
    cov = [] if "--covarFile" in flags else ["--covarFile", f"{d}/covar.txt"]
    argv = ["--step", "2", *_src(name, d, g), "--phenoFile", f"{d}/pheno.txt", *cov,
            "--remove", f"{d}/remove.txt", "--ignore-pred", "--bsize", "64",
            "--rare-mac", "20", *flags]
    jx, pt = f"{d}/jx_{scenario}", f"{d}/pt_{scenario}"
    run_jax(argv + ["--out", jx], monkeypatch, env)
    log = run_port(argv + ["--out", pt], monkeypatch, env)
    assert "dense scorer on cpu" in log
    n = 0
    for p in (1, 2, 3):
        n += rows_close(f"{pt}_Y{p}.regenie", f"{jx}_Y{p}.regenie")
    assert n > 3 * 100
    if want is not None:
        assert interaction_tests(f"{pt}_Y2.regenie") == want
    line = next(ln for ln in log.splitlines() if ln.startswith(" * interaction tests:"))
    # --force-hc4 implies --force-robust (args_to_params)
    hlm_on = not ({"--no-robust", "--force-robust", "--force-hc4"} & set(flags))
    if not env:
        # the batched routes' SNP counts; the HLM takes the rare ones
        robust = int(line.split("robust ")[1].split()[0])
        hlm = int(line.split("HLM ")[1].split()[0])
        assert robust > 100 and ((hlm > 0) if hlm_on else (hlm == 0)), line
    if "--print-vcov" in flags:
        got = sorted(glob.glob(f"{pt}_*.vcov"))
        assert len(got) > 3 * 100
        for fp in got:
            fj = fp.replace(pt, jx)
            a, b = np.loadtxt(fp), np.loadtxt(fj)
            assert a.shape == b.shape and np.allclose(a, b, rtol=1e-9, atol=0), fp


def test_gxprs_matches_jax(data, monkeypatch):
    """GxPRS: --interaction-prs with a Step-1 _pred.list (the port's Step 1
    on the BED, its .loco files the JAX package's byte for byte), one
    trait, against the JAX package's rows within rel 1e-9."""
    d, g = data["bed"]
    base = ["--bed", g, "--phenoFile", f"{d}/pheno.txt", "--covarFile",
            f"{d}/covar.txt", "--remove", f"{d}/remove.txt", "--phenoColList", "Y2"]
    s1 = f"{d}/prs_s1"
    run_port(["--step", "1", *base, "--bsize", "100", "--out", s1], monkeypatch)
    run_jax(["--step", "1", *base, "--bsize", "100", "--out", s1 + "_jax"], monkeypatch)
    assert open(f"{s1}_1.loco", "rb").read() == open(f"{s1}_jax_1.loco", "rb").read()
    argv = ["--step", "2", *base, "--bsize", "64", "--rare-mac", "20",
            "--interaction-prs", "--pred", f"{s1}_pred.list"]
    run_jax(argv + ["--out", f"{d}/jx_prs"], monkeypatch)
    run_port(argv + ["--out", f"{d}/pt_prs"], monkeypatch)
    assert rows_close(f"{d}/pt_prs_Y2.regenie", f"{d}/jx_prs_Y2.regenie") > 100
    assert interaction_tests(f"{d}/pt_prs_Y2.regenie") == {
        "ADD-INT_PRS", "ADD-INT_SNP", "ADD-INT_SNPxPRS", "ADD-INT_2DF"}


def _engines(d, g, flags=()):
    """The JAX package's and the port's Step-2 engines (QT --interaction
    C1, chromosome 1 prepared) on the same files, on the CPU."""
    from regenie_tpu import cli as jcli
    from regenie_tpu.run_step2 import Step2Engine as JEngine
    from regenie_tpu.prep import prepare as jprepare
    from regenie_tpu_torch import cli
    from regenie_tpu_torch.run_step2 import open_engine

    argv = ["--step", "2", "--bed", g, "--phenoFile", f"{d}/pheno.txt", "--covarFile",
            f"{d}/covar.txt", "--remove", f"{d}/remove.txt", "--ignore-pred",
            "--bsize", "64", "--rare-mac", "20", "--interaction", "C1", *flags,
            "--out", f"{d}/eng"]
    jp = jcli.args_to_params(jcli.build_parser().parse_args(argv))
    jp.test_mode = True
    rd = jprepare(jp, log=lambda *a: None)
    jeng = JEngine(jp, rd.geno, rd.pheno, None, lambda *a: None)
    jeng.prep_chrom(1)
    pp = cli.args_to_params(cli.build_parser().parse_args(argv))
    peng, blocks = open_engine(pp, lambda *a: None, "cpu")
    peng.prep_chrom(1)
    return jeng, peng, blocks


def test_hlm_null_and_batches(data):
    """The HLM null on the port's CPU twin equals the JAX package's fit
    bit for bit (objective, Dinv_sqrt, Px, yres); a 1e-15 relative
    perturbation of the phenotypes moves the L-BFGS stopping point by far
    more than 1e-15 (the reason the card is held to the CPU through the
    objective, not the coefficients); robust_batch and hlm_batch on a
    block equal the per-SNP numpy quantities within 1e-12."""
    import torch

    from regenie_tpu_torch.models import interaction as pint

    d, g = data["bed"]
    jeng, peng, blocks = _engines(d, g)
    jh, ph = jeng.interaction.hlm, peng.interaction.hlm
    assert np.array_equal(jh.Dinv_sqrt, ph.Dinv_sqrt)
    assert np.array_equal(jh.yres, ph.yres)
    for p in range(3):
        assert np.array_equal(jh.Px[p], ph.Px[p])
        assert ph.fits[p][1]  # converged
    # the stopping point under a 1e-15 perturbation of y
    pd = peng.pd
    rng = np.random.default_rng(3)
    saved = pd.phenotypes.copy()
    moved = []
    st = peng.interaction
    for _ in range(3):
        pd.phenotypes = saved * (1 + 1e-15 * rng.standard_normal(saved.shape))
        h2 = pint._hlm_prep(peng.params, pd, st)
        st2 = pint.InteractionState(hlm=h2)
        pint.hlm_fit_null(peng.params, pd, st2, np.zeros_like(saved), print)
        moved.append(max(abs(h2.fits[p][0] - ph.fits[p][0]) / abs(ph.fits[p][0])
                         for p in range(3)))
        moved.append(float(np.abs(h2.Dinv_sqrt - ph.Dinv_sqrt).max()))
    pd.phenotypes = saved
    print("HLM null under 1e-15 perturbations: objective rel, |dDinv_sqrt|", moved)
    assert max(moved[1::2]) > 1e-13  # the stopping point moved
    assert max(moved[0::2]) < 1e-12  # the objective did not

    # a block's robust and HLM batches against the numpy per-SNP sums
    chrom, bsnps = blocks[0]
    blk = peng.read_block_dense(bsnps)
    result, _ = peng.test_raw_block(peng.upload_dense(blk, bsnps), bsnps)
    G, Gr = peng.last_G_imputed, peng.last_G_int
    c = pint.RobustConsts(peng)
    outs = pint.robust_batch(G[:8], Gr[:8], c.E, c.E_res, c.cov, c.res, c.maskf,
                             float(peng.params.n_analyzed - pd.new_cov.shape[1]), True)
    E, cov, res = st.E, pd.new_cov, peng.res
    for s in range(8):
        g, gr = G[s].numpy(), Gr[s].numpy()
        iM, scf = pint.residualize_matrix(E * g[:, None], cov, peng.params.n_analyzed)
        M = np.column_stack([st.E_res, gr, iM])
        Z = np.linalg.inv(M.T @ M)
        tau = Z @ (M.T @ res)
        assert np.allclose(outs[0][s].numpy(), scf, rtol=1e-12)
        assert np.allclose(outs[3][s].numpy(), tau, rtol=1e-10, atol=1e-13)
        hv = ((M @ Z) * M).sum(1)
        e = ((res - M @ tau) * pd.masked_indivs) ** 2
        V3 = np.stack([Z @ (M.T * (e[:, p] / (1 - hv) ** 2)) @ M @ Z for p in range(3)])
        assert np.allclose(outs[4][s].numpy(), V3, rtol=1e-9, atol=1e-15)
    M = torch.cat([torch.as_tensor(ph.Vlin)[None] * G[:8, :, None]], 2)
    Dmin, Vm, bh = pint.hlm_batch(M, torch.as_tensor(ph.Dinv_sqrt[:, 1]),
                                  torch.as_tensor(ph.Px[1]), torch.as_tensor(ph.yres[:, 1]))
    for s in range(8):
        Mm = M[s].numpy() * ph.Dinv_sqrt[:, 1][:, None]
        Xr = Mm - ph.Px[1] @ (ph.Px[1].T @ Mm)
        V = np.linalg.inv(Xr.T @ Xr)
        assert np.allclose(Vm[s].numpy(), V, rtol=1e-9)
        assert np.allclose(bh[s].numpy(), V @ (Xr.T @ ph.yres[:, 1]), rtol=1e-9, atol=1e-14)
    peng.gd.close()


@pytest.mark.cuda
def test_card_chunks_match_cpu(data):
    """On the card: hlm_fit_null's objective on the card against the CPU
    twin (both converged, objectives within rel 1e-9), and a robust chunk
    (HC3 and HC4) and an HLM chunk on the card against the same functions
    on the CPU (rel 1e-9)."""
    import torch

    from regenie_tpu_torch import cli
    from regenie_tpu_torch.models import interaction as pint
    from regenie_tpu_torch.run_step2 import open_engine

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    d, g = data["bed"]
    argv = ["--step", "2", "--bed", g, "--phenoFile", f"{d}/pheno.txt", "--covarFile",
            f"{d}/covar.txt", "--ignore-pred", "--rare-mac", "20", "--interaction", "C1",
            "--out", f"{d}/card"]
    engs = {}
    for dev in ("cuda", "cpu"):
        p = cli.args_to_params(cli.build_parser().parse_args(argv))
        engs[dev], blocks = open_engine(p, lambda *a: None, dev)
        engs[dev].prep_chrom(1)
    gpu, cpu = engs["cuda"], engs["cpu"]
    for a, b in zip(gpu.interaction.hlm.fits, cpu.interaction.hlm.fits):
        assert a[1] and b[1] and abs(a[0] - b[0]) <= 1e-9 * abs(b[0])
    G = np.asarray(cpu.upload_dense(cpu.read_block_dense(blocks[0][1]), blocks[0][1])[0],
                   np.float64)
    G = np.where(G == -3, 0.0, G)[:16]
    for eng in (gpu, cpu):
        c = pint.RobustConsts(eng)
        gt = torch.as_tensor(G, device=eng.device)
        eng._outs = [o.cpu().numpy() for o in pint.robust_batch(
            gt, gt, c.E, c.E_res, c.cov, c.res, c.maskf, 800.0, True)]
        h = cpu.interaction.hlm
        M = torch.as_tensor(h.Vlin, device=eng.device)[None] * gt[:, :, None]
        eng._hlm = [o.cpu().numpy() for o in pint.hlm_batch(
            M, torch.as_tensor(h.Dinv_sqrt[:, 0], device=eng.device),
            torch.as_tensor(h.Px[0], device=eng.device),
            torch.as_tensor(h.yres[:, 0], device=eng.device))]
    for a, b in zip(gpu._outs + gpu._hlm, cpu._outs + cpu._hlm):
        assert np.allclose(a, b, rtol=1e-9, atol=1e-12 * np.abs(b).max())
