"""MultiPhen (--multiphen) in the port against the JAX package, both on
the CPU in this process:

- the proportional-odds model's negll, gradient and Hessian
  (multiphen._pom_funcs: closed form in the port, jax.grad / jax.hessian
  in the JAX package) and the per-category scalars of the batched score
  stage (_cat_scalars_batch), clipped probabilities included;
- the fits and tests (_fit_pom, _fit_pom_offset, _pom_score_test,
  multiphen_snp in every --multiphen-test mode, multiphen_block) on
  full-rank designs: every number within rel 1e-9, the iteration counts
  equal;
- the CLI against `python -m regenie_tpu` on a synthetic BED (N = 600, 3
  traits): the default mode (batched, and per-SNP with
  REGENIE_TPU_NO_BATCH_MPHEN=1), nocov_lrt and cov_score.

The reference's covariate fits on three genotype categories run on a
rank-deficient design: the centered orthonormal covariate basis spans
the intercept, which the cut-points already carry (its smallest singular
value is ~1e-16 of the largest). Whether the Newton solve there meets an
exactly singular Hessian, and so fails, or a pivot of ~1e-17, and so
goes on, is decided by rounding, in the JAX package as in the port
(ROADMAP.md §3). A CLI row that leaves rel 1e-9 must be witnessed: a
three-category row (MULTINOM 1 on both sides) whose covariate design has
a singular value below 1e-12 of the largest, and which the JAX package's
own multiphen_snp writes as the port does (LOG10P within rel 1e-9, the
same MULTINOM, IT, UP and FIRTH) when its covariate basis is perturbed by
1e-15 relative (128 seeded draws). In the default mode at most 5% of rows
may differ; in cov_score every three-category row takes that design.
"""

import numpy as np
import pytest

from chip_smoke import write_dataset
from test_torch_interaction import run_jax, run_port

N = 600
CHROMS = ((1, 140), (2, 60))
WITNESS_DRAWS = 128


class _P:
    multiphen_thr = 0.001
    multiphen_tol = 2.5e-4
    multiphen_firth_mult = 1.0
    multiphen_maxstep = 200.0
    multiphen_maxit = 150
    multiphen_approx_offset = -1
    multiphen_test = "nocov_score_offset"


def _mods():
    from regenie_tpu.models import multiphen as J
    from regenie_tpu_torch.models import multiphen as T

    return J, T


def _close(a, b, rtol=1e-9, what=""):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(1.0, float(np.abs(a).max()) if a.size else 1.0)
    assert a.shape == b.shape, what
    assert np.abs(a - b).max(initial=0.0) <= rtol * scale, (what, a, b)


@pytest.mark.parametrize("K,C,spread", [(3, 3, 1.0), (3, 0, 1.0), (2, 4, 1.0),
                                        (3, 3, 30.0), (2, 2, 40.0)])
def test_pom_derivatives_match_jax(K, C, spread):
    """negll, gradient and Hessian of the POM against the JAX package's
    autodiff, rel 1e-9 of each array's largest entry; spread 30-40 drives
    category probabilities under the 1e-12 clip (zero slope there)."""
    J, T = _mods()
    rng = np.random.default_rng(K * 10 + C)
    n = 400
    X = rng.normal(size=(n, C))
    Yoh = np.eye(K)[rng.integers(0, K, n)]
    m = (rng.random(n) > 0.1).astype(np.float64)
    for _ in range(3):
        theta = np.sort(rng.normal(size=K - 1) * spread)
        par = np.r_[theta, rng.normal(size=C) * spread / 3]
        fa, ga, Ha = J._pom_funcs(par, X, Yoh * m[:, None], m, K, True)
        fb, gb, Hb = T._pom_funcs(par, X, Yoh * m[:, None], m, K, True)
        _close(fa, fb, what="negll")
        _close(ga, gb, what="grad")
        if spread < 10:
            _close(Ha, Hb, what="hess")
        else:
            # saturated samples: the JAX Hessian is itself asymmetric by
            # more than 1e-9 of its entries (cancellation); hold the
            # port's to the JAX package's own asymmetry
            asym = np.abs(Ha - Ha.T).max()
            assert np.abs(Ha - Hb).max() <= max(1e-9 * np.abs(Ha).max(), 4 * asym)


def test_cat_scalars_match_jax():
    """The batched score stage's per-category derivative scalars, on
    ordinary and saturated cut-points."""
    J, T = _mods()
    rng = np.random.default_rng(3)
    th = np.sort(rng.normal(size=(20, 2)) * 2, axis=1)
    th = np.concatenate([th, [[-40.0, 40.0], [-1e-3, 1e-3], [5.0, 38.0]]])
    for a, b in zip(J._cat_scalars_batch(th, 3), T._cat_scalars_batch(th, 3)):
        _close(a, b, rtol=1e-12)
    th2 = rng.normal(size=(7, 1)) * 3
    for a, b in zip(J._cat_scalars_batch(th2, 2), T._cat_scalars_batch(th2, 2)):
        _close(a, b, rtol=1e-12)


def _design(seed, n=700, p=3):
    """A full-rank covariate block (intercept + two normals), traits and
    genotypes with some missing, as the JAX package's own unit tests
    build them."""
    rng = np.random.default_rng(seed)
    Xcov = np.concatenate([np.ones((n, 1)), rng.normal(size=(n, 2))], axis=1)
    Y = rng.normal(size=(n, p))
    mask = rng.random(n) > 0.05
    return rng, Xcov, Y, mask


def test_fits_and_score_test_match_jax():
    """_fit_pom (with and without covariates, from a start), _fit_pom_offset
    and _pom_score_test on the same inputs: rel 1e-9, equal iterations and
    flags."""
    J, T = _mods()
    rng, Xcov, Y, mask = _design(1)
    g = rng.choice(3, size=len(mask), p=[0.5, 0.35, 0.15])
    Yoh = np.eye(3)[g] * mask[:, None]
    m = mask.astype(np.float64)
    X = (Xcov[:, 1:] - Xcov[mask, 1:].mean(axis=0)) * m[:, None]
    Ym = Y * m[:, None]
    for Xn in (X, np.zeros((len(m), 0)), np.concatenate([X, Ym], axis=1)):
        a, b = J._fit_pom(Xn, Yoh, m, 3), T._fit_pom(Xn, Yoh, m, 3)
        _close(a[0], b[0], what="par")
        _close(a[1], b[1], what="negll")
        assert a[2:] == b[2:]
        sa = J._pom_score_test(a[0], Xn, Ym, Yoh, m, 3)
        sb = T._pom_score_test(b[0], Xn, Ym, Yoh, m, 3)
        _close(sa, sb, what="score p")
    p0 = J._fit_pom(X, Yoh, m, 3)[0]
    off = X @ p0[2:]
    a = J._fit_pom_offset(Ym, p0[:2], off, Yoh, m, 3)
    b = T._fit_pom_offset(Ym, p0[:2], off, Yoh, m, 3)
    _close(a[0], b[0])
    _close(a[1], b[1])
    assert a[2:] == b[2:]


@pytest.mark.parametrize("mode,approx", [
    ("nocov_score_offset", -1), ("nocov_score", -1), ("cov_score", -1),
    ("nocov_lrt", -1), ("cov_lrt", -1), ("cov_lrt", 1), ("none", -1)])
def test_multiphen_snp_matches_jax(mode, approx):
    """multiphen_snp on two- and three-category variants with a signal
    (so the default escalates to the LRT) and on a monomorphic one:
    every result field equal, p within rel 1e-9."""
    J, T = _mods()
    rng, Xcov, Y, mask = _design(5)
    P = type("P", (_P,), dict(multiphen_test=mode, multiphen_approx_offset=approx))
    gs = [rng.choice(3, size=len(mask), p=[0.6, 0.3, 0.1]).astype(float),
          rng.choice(2, size=len(mask), p=[0.93, 0.07]).astype(float),
          rng.choice(3, size=len(mask), p=[0.7, 0.25, 0.05]).astype(float),
          np.zeros(len(mask))]
    Y[:, 0] += 0.35 * gs[0]
    Y[:, 1] += 0.5 * gs[1]
    gs[2][rng.random(len(mask)) < 0.03] = -3
    for g in gs:
        a = J.multiphen_snp(P, g, Xcov, Y, mask)
        b = T.multiphen_snp(P, g, Xcov, Y, mask)
        assert (a.is_multinom, a.niter, a.n_updates, a.used_firth) == (
            b.is_multinom, b.niter, b.n_updates, b.used_firth), (a, b)
        _close(a.pval, b.pval, what=str((a, b)))


def test_multiphen_block_matches_jax():
    """The batched block driver on a block of two- and three-category
    variants with missing genotypes, escalations included: every result
    equal to the JAX package's (p rel 1e-9)."""
    J, T = _mods()
    rng, Xcov, Y, mask = _design(9)
    B, n = 24, len(mask)
    G = np.stack([rng.choice(3, size=n, p=[p0, 0.9 - p0, 0.1]) for p0 in
                  np.linspace(0.3, 0.85, B)]).astype(np.float64)
    G[::3, :2] = 0
    G[rng.random(G.shape) < 0.02] = -3
    G[5] = np.where(G[5] == 2, 1, G[5])  # two categories
    Y[:, 0] += 0.3 * np.where(G[2] < 0, 0, G[2])  # an escalation
    P = type("P", (_P,), {})
    idx = [b for b in range(B) if b != 7]
    ra = J.multiphen_block(P, G, Xcov, Y, mask, idx)
    rb = T.multiphen_block(P, G, Xcov, Y, mask, idx)
    assert sorted(ra) == sorted(rb) == idx
    for b in idx:
        a, c = ra[b], rb[b]
        assert (a.is_multinom, a.niter, a.used_firth) == (
            c.is_multinom, c.niter, c.used_firth), (b, a, c)
        _close(a.pval, c.pval, what=str(b))


# ---- the CLI ----

@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_multiphen"))
    g = write_dataset(d, seed=23, N=N, chroms=CHROMS, P=3, n_inc=1, n_cov=3,
                      n_remove=5, effect_sd=1.0)
    return d, g


def _argv(d, g, flags, out):
    return ["--step", "2", "--bed", g, "--phenoFile", f"{d}/pheno.txt",
            "--covarFile", f"{d}/covar.txt", "--remove", f"{d}/remove.txt",
            "--ignore-pred", "--bsize", "64", "--multiphen", "--strict",
            *flags, "--out", out]


def _rows(path):
    lines = open(path).read().splitlines()
    return lines[0], [ln.split() for ln in lines[1:]]


def _row_equal(ta, tb):
    """MultiPhen rows equal: text and integer fields, LOG10P rel 1e-9."""
    if ta[:8] != tb[:8] or ta[9:] != tb[9:]:
        return False
    if ta[8] == tb[8]:
        return True
    if "NA" in (ta[8], tb[8]):
        return False
    fa, fb = float(ta[8]), float(tb[8])
    return abs(fa - fb) <= 1e-9 * max(1.0, abs(fa))


def _jax_inputs(argv):
    """The JAX package's inputs of multiphen_snp for a run's argv:
    (params, genotype source, covariate basis, {chrom: Yres}, mask)."""
    from regenie_tpu import cli as jcli
    from regenie_tpu.prep import prepare
    from regenie_tpu.run_step2 import Step2Engine

    params = jcli.args_to_params(jcli.build_parser().parse_args(argv))
    params.test_mode = True
    rd = prepare(params, log=lambda *a: None)
    eng = Step2Engine(params, rd.geno, rd.pheno, None, lambda *a: None)
    res = {}
    for c in sorted({s.chrom for s in rd.geno.snps}):
        eng.prep_chrom(c)
        res[c] = eng.res
    return params, rd.geno, rd.pheno.new_cov, res, rd.pheno.masked_indivs[:, 0]


def _witness(argv, rows):
    """Witness each differing row (ID, port fields): a three-category row
    on a rank-deficient covariate design that the JAX package's own
    multiphen_snp writes as the port does under a 1e-15 perturbation of
    the covariate basis. Raises otherwise."""
    from regenie_tpu.models.multiphen import multiphen_line, multiphen_snp

    params, gd, Xcov, res, mask0 = _jax_inputs(argv)
    by_id = {s.ID: s for s in gd.snps}
    rng = np.random.default_rng(0)
    for vid, tb in rows:
        assert tb[9] == "1", (vid, tb)  # three categories
        s = by_id[vid]
        g = np.asarray(gd.read_block([s]), np.float64)[0]
        m = mask0 & (g != -3)
        mf = m.astype(np.float64)
        mu = (Xcov * mf[:, None]).sum(axis=0) / mf.sum()
        sv = np.linalg.svd((Xcov - mu) * mf[:, None], compute_uv=False)
        assert sv[-1] <= 1e-12 * sv[0], (vid, sv)
        for _ in range(WITNESS_DRAWS):
            Xp = Xcov * (1 + 1e-15 * rng.standard_normal(Xcov.shape))
            r = multiphen_snp(params, g, Xp, res[s.chrom], mask0)
            got = multiphen_line(s, 0.0, 0.0, 0, r).split()
            if _row_equal(tb[:8] + got[8:], tb):
                break
        else:
            raise AssertionError(f"{vid}: no perturbation of the JAX package's "
                                 f"covariate basis writes the port's row {tb}")


@pytest.mark.parametrize("scenario,flags,env,cap", [
    ("default", [], (), 0.05),
    ("per_snp", [], (("REGENIE_TPU_NO_BATCH_MPHEN", "1"),), 0.05),
    ("nocov_lrt", ["--multiphen-test", "nocov_lrt"], (), 0.0),
    ("cov_score", ["--multiphen-test", "cov_score"], (), 1.0),
])
def test_cli_matches_jax(data, scenario, flags, env, cap, monkeypatch):
    """The port's --multiphen CLI against the JAX package's on the same
    files and route: the same rows in order, every row equal (LOG10P rel
    1e-9) or witnessed as decided by rounding (module docstring), at most
    `cap` of the rows."""
    d, g = data
    jx, pt = f"{d}/jax_{scenario}", f"{d}/pt_{scenario}"
    run_jax(_argv(d, g, flags, jx), monkeypatch, env)
    log = run_port(_argv(d, g, flags, pt), monkeypatch, env)
    assert "Association testing mode (MultiPhen)" in log
    ha, ra = _rows(f"{jx}.regenie")
    hb, rb = _rows(f"{pt}.regenie")
    assert ha == hb and len(ra) == len(rb) > 150
    assert [r[2] for r in ra] == [r[2] for r in rb]
    diff = [(tb[2], tb) for ta, tb in zip(ra, rb) if not _row_equal(ta, tb)]
    n_lrt = sum(r[9] == "1" for r in rb)
    print(f"{scenario}: {len(rb)} rows ({n_lrt} three-category), {len(diff)} "
          "witnessed as decided by rounding in the reference's design")
    assert len(diff) <= cap * len(rb), len(diff)
    if diff:
        _witness(_argv(d, g, flags, pt), diff)
