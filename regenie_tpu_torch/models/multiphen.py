"""MultiPhen test (--multiphen): reverse ordinal regression of genotype
on multiple traits.

Re-implements the reference's Ordinal.cpp machinery (MultiPhen::run
:169, run_test_add_offset :~400, FitOrdinal POM fitting, score test
test_score_*): the hardcall genotype (0/1/2) is regressed on the LOCO
phenotype residuals with a proportional-odds model (3 categories) or
logistic model (2 categories); the default test is a fast score test at
the no-covariate null, escalating to a likelihood-ratio test with the
full model when p < --multiphen-thr.

The port's copy of regenie_tpu/models/multiphen.py. The JAX package
differentiates the POM log-likelihood with jax.grad / jax.hessian on the
host's CPU; here the gradient and Hessian are in closed form, float64
numpy on the host (each sample's negll depends on the K - 1 cut-points
and its linear predictor eta only, so the derivatives in (theta, eta)
are per-sample K-vectors and K x K matrices, chained through eta = X
beta). Where a category probability is clipped at 1e-12 (or 1), the
derivatives follow jnp.clip's: zero beyond the bound, half at it.

Design differences from the reference (behavior-preserving): the POM
log-likelihood is solved by a damped Newton loop instead of 3k lines of
hand-written Fisher-scoring updates. The LRT refits the exact full model by default (the reference
default); --multiphen-approx-offset enables the reference's optional
offset-frozen approximation (covariate effects fixed at the null fit).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
from scipy.stats import chi2


# ---------------------------------------------------------------------------
# Proportional-odds model, closed-form derivatives
# ---------------------------------------------------------------------------

_PI_MIN = 1e-12


def _clip_slope(raw):
    """d clip(raw, 1e-12, 1) / d raw as jnp.clip's derivative gives it
    (maximum, then minimum; each halves the slope at a tie)."""
    lo = np.maximum(raw, _PI_MIN)
    return (np.where(raw > _PI_MIN, 1.0, np.where(raw == _PI_MIN, 0.5, 0.0))
            * np.where(lo < 1.0, 1.0, np.where(lo == 1.0, 0.5, 0.0)))


def _cat_derivs(z, W, order=2):
    """The cumulative-logit negll -sum_k W_k log pi_k of each row and its
    derivatives in u = (theta_0..theta_{K-2}, eta).

    z: [..., K-1] = theta - eta; W: [..., K] category weights. pi_k =
    clip(cum_k - cum_{k-1}, 1e-12, 1) with cum_k = sigmoid(z_k), cum_{-1}
    = 0, cum_{K-1} = 1. Returns (f [...], g [..., K], H [..., K, K]); H
    is None with order 1."""
    K = z.shape[-1] + 1
    cum = 1.0 / (1.0 + np.exp(-z))
    one = np.ones(z.shape[:-1] + (1,))
    raw = np.concatenate([cum, one], -1) - np.concatenate([0.0 * one, cum], -1)
    pi = np.clip(raw, _PI_MIN, 1.0)
    f = -(W * np.log(pi)).sum(-1)
    c = _clip_slope(raw)
    # d cum_j / du = F_j (e_j - e_eta); d2 cum_j / du du' = F_j (1 - 2
    # cum_j) (e_j - e_eta)(e_j - e_eta)'
    E = np.zeros((K - 1, K))
    E[np.arange(K - 1), np.arange(K - 1)] = 1.0
    E[:, K - 1] = -1.0
    F = cum * (1.0 - cum)
    dcum = F[..., None] * E
    pad = np.zeros_like(dcum[..., :1, :])
    draw = np.concatenate([dcum, pad], -2) - np.concatenate([pad, dcum], -2)
    a1 = W * c / pi
    g = -(a1[..., None] * draw).sum(-2)
    if order < 2:
        return f, g, None
    d2cum = (F * (1.0 - 2.0 * cum))[..., None, None] * (E[:, :, None] * E[:, None, :])
    pad2 = np.zeros_like(d2cum[..., :1, :, :])
    d2raw = np.concatenate([d2cum, pad2], -3) - np.concatenate([pad2, d2cum], -3)
    a2 = W * c**2 / pi**2
    H = -((a1[..., None, None] * d2raw).sum(-3)
          - np.einsum("...k,...ku,...kv->...uv", a2, draw, draw))
    return f, g, H


def _pom_funcs(par, Xf, Yoh, maskf, K, want_hess=False):
    """Negative log-likelihood of the cumulative-logit POM, its gradient
    (and Hessian) in par = [theta_0..theta_{K-2}, beta...], float64 on
    the host. Xf [N, C]; Yoh [N, K] one-hot; maskf [N]."""
    par = np.asarray(par, dtype=np.float64)
    Xf = np.asarray(Xf, dtype=np.float64)
    theta, beta = par[: K - 1], par[K - 1 :]
    eta = Xf @ beta
    z = theta[None, :] - eta[:, None]
    f, gu, Hu = _cat_derivs(z, Yoh * maskf[:, None], 2 if want_hess else 1)
    g = np.concatenate([gu[:, : K - 1].sum(axis=0), Xf.T @ gu[:, K - 1]])
    H = None
    if want_hess:
        C = Xf.shape[1]
        H = np.empty((K - 1 + C, K - 1 + C))
        H[: K - 1, : K - 1] = Hu[:, : K - 1, : K - 1].sum(axis=0)
        H_tb = Hu[:, : K - 1, K - 1].T @ Xf
        H[: K - 1, K - 1 :] = H_tb
        H[K - 1 :, : K - 1] = H_tb.T
        H[K - 1 :, K - 1 :] = Xf.T @ (Xf * Hu[:, K - 1, K - 1][:, None])
    return float(f.sum()), g, H


def _fit_pom(X, Yoh, maskf, K, theta0=None, maxit=150, tol=2.5e-4,
             max_step=200.0):
    """Damped-Newton POM fit. Returns (par, negll, niter, converged)."""
    N, C = X.shape
    par = np.zeros(K - 1 + C)
    if theta0 is None:
        # start intercepts at marginal cumulative logits
        cnt = (Yoh * maskf[:, None]).sum(axis=0)
        cf = np.cumsum(cnt)[:-1] / cnt.sum()
        par[: K - 1] = np.log(cf / (1 - cf))
    else:
        par[: K - 1] = theta0
    f, _g, _ = _pom_funcs(par, X, Yoh, maskf, K)
    it = 0
    for it in range(1, maxit + 1):
        _f, g, H = _pom_funcs(par, X, Yoh, maskf, K, want_hess=True)
        try:
            step = np.linalg.solve(H, g)
        except np.linalg.LinAlgError:
            return par, f, it, False
        mx = np.abs(step).max()
        if mx > max_step:
            step *= max_step / mx
        ok = False
        for _ in range(8):
            cand = par - step
            fc, _gc, _ = _pom_funcs(cand, X, Yoh, maskf, K)
            if np.isfinite(fc) and fc <= f + 1e-12:
                ok = True
                break
            step /= 2
        if not ok:
            return par, f, it, False
        done = np.abs(g).max() < tol
        par, f = cand, fc
        if done:
            return par, f, it, True
    return par, f, it, False


def _fit_pom_offset(Y_add, theta, off, Yoh, maskf, K, maxit=150,
                    tol=2.5e-4, max_step=200.0):
    """Offset-approximation full-model POM fit (--multiphen-approx-offset,
    Ordinal.cpp:773-812): intercepts and the covariate linear predictor
    are frozen at the null fit (passed as `theta` and `off`), only the
    phenotype coefficients are free. Implemented as a damped Newton on
    the free sub-block of _pom_funcs' gradient and Hessian, with the
    offset as a pinned-coefficient column.

    Returns (beta, negll, niter, converged)."""
    N, P = Y_add.shape
    Xf = np.concatenate([off[:, None], Y_add], axis=1)
    nfix = K - 1 + 1  # theta block + pinned offset coefficient

    def pack(beta):
        return np.concatenate([theta, [1.0], beta])

    beta = np.zeros(P)
    f, _g, _ = _pom_funcs(pack(beta), Xf, Yoh, maskf, K)
    it = 0
    for it in range(1, maxit + 1):
        _f, g, H = _pom_funcs(pack(beta), Xf, Yoh, maskf, K, want_hess=True)
        gf = g[nfix:]
        Hf = H[nfix:, nfix:]
        try:
            step = np.linalg.solve(Hf, gf)
        except np.linalg.LinAlgError:
            return beta, f, it, False
        mx = np.abs(step).max()
        if mx > max_step:
            step *= max_step / mx
        ok = False
        for _ in range(8):
            cand = beta - step
            fc, _gc, _ = _pom_funcs(pack(cand), Xf, Yoh, maskf, K)
            if np.isfinite(fc) and fc <= f + 1e-12:
                ok = True
                break
            step /= 2
        if not ok:
            return beta, f, it, False
        done = np.abs(gf).max() < tol
        beta, f = cand, fc
        if done:
            return beta, f, it, True
    return beta, f, it, False


def _pom_score_test(par_null, X_null, Y_add, Yoh, maskf, K):
    """Efficient score test for adding Y_add columns to a fitted POM:
    evaluate grad/hessian of the FULL model at (par_null, 0) and form
    U' V^-1 U with V the efficient information of the added block."""
    C0 = X_null.shape[1]
    P = Y_add.shape[1]
    Xf = np.concatenate([X_null, Y_add], axis=1) if C0 else Y_add
    par = np.concatenate([par_null, np.zeros(P)])
    _f, g, H = _pom_funcs(par, Xf, Yoh, maskf, K, want_hess=True)
    U = -g[-P:]  # score of the loglik (negll grad is -score); null part ~0
    I_aa = H[:-P, :-P]
    I_ab = H[:-P, -P:]
    I_bb = H[-P:, -P:]
    try:
        V = I_bb - I_ab.T @ np.linalg.solve(I_aa, I_ab)
        stat = float(U @ np.linalg.solve(V, U))
    except np.linalg.LinAlgError:
        return -1.0
    if stat < 0:
        return -1.0
    return float(chi2.sf(stat, P))


# ---------------------------------------------------------------------------
# Binomial path (2 genotype categories)
# ---------------------------------------------------------------------------

def _fit_logistic(X, y, maskf, firth_mult=0.0, maxit=150, tol=2.5e-4,
                  max_step=200.0, offset=None, X_pen=None):
    """Logistic fit with optional Firth penalty (FitOrdinal::fit_binom).
    `offset` freezes a linear-predictor component (the --multiphen-
    approx-offset full-model fit, Ordinal.cpp:726-771). `X_pen` computes
    the Firth determinant over a wider design than the free columns (the
    reference's null-fit convention for the Firth LRT: the penalty uses
    the full-model information at the null, inc_phen_null
    Ordinal.cpp:263, so the det terms cancel in the LRT).
    Returns (beta, penalized_loglik, niter, converged)."""
    N, C = X.shape
    beta = np.zeros(C)
    off = np.zeros(N) if offset is None else offset
    Xp = X if X_pen is None else X_pen

    def negll(b):
        eta = np.clip(off + X @ b, -30, 30)
        pi = 1 / (1 + np.exp(-eta))
        ll = (y * np.log(pi) + (1 - y) * np.log1p(-pi)) * maskf
        val = -ll.sum()
        if firth_mult > 0:
            w = pi * (1 - pi) * maskf
            Ii = Xp.T @ (Xp * w[:, None])
            s, ld = np.linalg.slogdet(Ii)
            val -= 0.5 * firth_mult * ld
        return val

    f = negll(beta)
    it = 0
    for it in range(1, maxit + 1):
        eta = np.clip(off + X @ beta, -30, 30)
        pi = 1 / (1 + np.exp(-eta))
        w = pi * (1 - pi) * maskf
        Ii = X.T @ (X * w[:, None])
        resid = (y - pi) * maskf
        if firth_mult > 0:
            # hat values of the penalty design drive the score correction
            Ip = Xp.T @ (Xp * w[:, None])
            try:
                solp = np.linalg.solve(Ip, Xp.T)
            except np.linalg.LinAlgError:
                return beta, -f, it, False
            h = (solp.T * (Xp * w[:, None])).sum(axis=1)
            resid = resid + firth_mult * h * (0.5 - pi) * maskf
        g = X.T @ resid
        try:
            step = np.linalg.solve(Ii, g)
        except np.linalg.LinAlgError:
            return beta, -f, it, False
        mx = np.abs(step).max()
        if mx > max_step:
            step *= max_step / mx
        ok = False
        for _ in range(8):
            cand = beta + step
            fc = negll(cand)
            if np.isfinite(fc) and fc <= f + 1e-12:
                ok = True
                break
            step /= 2
        if not ok:
            return beta, -f, it, np.abs(g).max() < tol
        done = np.abs(g).max() < tol
        beta, f = cand, fc
        if done:
            return beta, -f, it, True
    return beta, -f, it, False


def _binom_score_test(X_null, beta_null, Y_add, y, maskf):
    eta = np.clip(X_null @ beta_null, -30, 30)
    pi = 1 / (1 + np.exp(-eta))
    w = pi * (1 - pi) * maskf
    U = Y_add.T @ ((y - pi) * maskf)
    I_aa = X_null.T @ (X_null * w[:, None])
    I_ab = X_null.T @ (Y_add * w[:, None])
    I_bb = Y_add.T @ (Y_add * w[:, None])
    try:
        V = I_bb - I_ab.T @ np.linalg.solve(I_aa, I_ab)
        stat = float(U @ np.linalg.solve(V, U))
    except np.linalg.LinAlgError:
        return -1.0
    if stat < 0:
        return -1.0
    return float(chi2.sf(stat, Y_add.shape[1]))


# ---------------------------------------------------------------------------
# Per-SNP driver
# ---------------------------------------------------------------------------

@dataclass
class MPhenResult:
    pval: float = -1.0  # raw p; -1 = failed/NA
    is_multinom: bool = False
    niter: int = 0
    n_updates: int = 0
    used_firth: bool = False


def multiphen_snp(params, g_raw, Xcov, Yres, mask) -> MPhenResult:
    """MultiPhen for one variant (MultiPhen::run + run_test_add_offset).

    g_raw: [N] genotypes (missing=-3; dosages rounded to hardcalls);
    Xcov: [N, C] covariates (orthonormal basis incl. intercept);
    Yres: [N, P] LOCO phenotype residuals; mask: [N] bool."""
    r = MPhenResult()
    gi = np.round(np.asarray(g_raw, dtype=np.float64)).astype(np.int64)
    m = mask & (np.asarray(g_raw) != -3)
    maskf = m.astype(np.float64)
    cats = np.unique(gi[m])
    if len(cats) < 2:
        return r
    K = len(cats)
    r.is_multinom = K > 2
    code = np.searchsorted(cats, np.where(m, gi, cats[0]))
    Ym = Yres * maskf[:, None]
    ones = np.ones((len(gi), 1))

    tol = params.multiphen_tol
    maxit = params.multiphen_maxit
    mstep = params.multiphen_maxstep
    fm = params.multiphen_firth_mult

    # --multiphen-approx-offset gate (setup_approx_offset,
    # Ordinal.cpp:856-868): 0/-1 disabled, 1 always, >1 when the minor
    # genotype-category count exceeds the threshold
    mao = getattr(params, "multiphen_approx_offset", -1)
    ncat_minor = int(np.bincount(code[m]).min())
    use_off = (mao == 1) or (mao > 1 and ncat_minor > mao)

    # --multiphen-test strategy (MultiPhen::run dispatch,
    # Ordinal.cpp:184-206). Aliases map to the same computation here:
    # cov_score_it1 -> cov_score; nocov_score_addcov / offset ->
    # nocov_score_offset (the default score-then-LRT escalation).
    mode = getattr(params, "multiphen_test", None) or "nocov_score_offset"
    mode = {"cov_score_it1": "cov_score", "nocov_score_addcov":
            "nocov_score_offset", "offset": "nocov_score_offset"}.get(mode, mode)
    if mode == "none":
        return r
    if mode not in ("nocov_score", "cov_score", "nocov_lrt", "cov_lrt",
                    "nocov_score_offset"):
        raise ValueError(f"unknown --multiphen-test mode: {mode}")
    score_stage = mode in ("nocov_score", "cov_score", "nocov_score_offset")
    lrt_stage = mode in ("nocov_lrt", "cov_lrt", "nocov_score_offset")
    lrt_cov = mode != "nocov_lrt"

    if K == 2:
        y = code.astype(np.float64) * maskf
        Xn = Xcov * maskf[:, None]
        if score_stage:
            # score test at the no-covariate or covariate null
            Xnull = Xn if mode == "cov_score" else ones
            b0, _ll, it0, ok = _fit_logistic(Xnull, y, maskf, 0.0, maxit,
                                             tol, mstep)
            if not ok:
                return r
            r.niter += it0
            pv = _binom_score_test(Xnull, b0, Ym, y, maskf)
            r.pval = pv
            if not lrt_stage or pv < 0 or pv >= params.multiphen_thr:
                return r
        # LRT stage (+Firth)
        r.used_firth = fm > 0
        if not lrt_cov:
            Xn = ones
        if use_off:
            # offset approximation (Ordinal.cpp:726-771): covariate
            # effects frozen at the null fit; phenotypes weighted-
            # residualized against covariates; only P betas refit
            b_n, ll0, it1, ok0 = _fit_logistic(Xn, y, maskf, 0.0, maxit,
                                               tol, mstep)
            if not ok0:
                return r
            eta0 = np.clip(Xn @ b_n, -30, 30)
            pi0 = 1 / (1 + np.exp(-eta0))
            w0 = pi0 * (1 - pi0) * maskf
            A = Xn.T @ (Xn * w0[:, None])
            try:
                Yres0 = Ym - Xn @ np.linalg.solve(A, Xn.T @ (Ym * w0[:, None]))
            except np.linalg.LinAlgError:
                return r
            b_f, ll1, it2, ok1 = _fit_logistic(Yres0, y, maskf, fm, maxit,
                                               tol, mstep, offset=eta0)
            r.niter += it1 + it2
            if not ok1:
                return r
            if fm > 0:
                # Firth det term of the null on the residualized design
                # (Ordinal.cpp:747-751)
                _s, ld = np.linalg.slogdet(Yres0.T @ (Yres0 * w0[:, None]))
                ll0 = ll0 + 0.5 * fm * ld
            stat = 2 * (ll1 - ll0)
            r.pval = 1.0 if stat < 0 else float(chi2.sf(stat, Ym.shape[1]))
            return r
        Xf = np.concatenate([Xn, Ym], axis=1)
        # null penalized by the full-design information (inc_phen_null,
        # Ordinal.cpp:263) so the Firth det terms cancel in the LRT
        b_n, ll0, it1, ok0 = _fit_logistic(Xn, y, maskf, fm, maxit, tol,
                                           mstep, X_pen=Xf)
        b_f, ll1, it2, ok1 = _fit_logistic(Xf, y, maskf, fm, maxit, tol, mstep)
        r.niter += it1 + it2
        if not (ok0 and ok1):
            return r
        stat = 2 * (ll1 - ll0)
        r.pval = 1.0 if stat < 0 else float(chi2.sf(stat, Ym.shape[1]))
        return r

    # K == 3: proportional-odds model. The POM's cut-points span the
    # intercept, so constant covariate columns are dropped to keep the
    # fits identified (the reference fits "covariates X without
    # Intercept", Ordinal.cpp:535)
    Yoh = np.zeros((len(gi), K))
    Yoh[np.arange(len(gi)), code] = 1.0
    Yoh *= maskf[:, None]
    empty = np.zeros((len(gi), 0))
    mu = (Xcov * maskf[:, None]).sum(axis=0) / maskf.sum()
    sd = np.sqrt((((Xcov - mu) * maskf[:, None]) ** 2).sum(axis=0) / maskf.sum())
    Xn = (Xcov - mu)[:, sd > 1e-12] * maskf[:, None]
    par0, _f, it0, ok = _fit_pom(
        Xn if mode == "cov_score" else empty, Yoh, maskf, K,
        maxit=maxit, tol=tol, max_step=mstep)
    if not ok:
        return r
    r.niter += it0
    if score_stage:
        pv = _pom_score_test(par0, Xn if mode == "cov_score" else empty,
                             Ym, Yoh, maskf, K)
        r.pval = pv
        if not lrt_stage or pv < 0 or pv >= params.multiphen_thr:
            return r
    if not lrt_cov:
        Xn = empty
    p_n, f0, it1, ok0 = _fit_pom(Xn, Yoh, maskf, K, theta0=par0[: K - 1],
                                 maxit=maxit, tol=tol, max_step=mstep)
    if use_off:
        # offset approximation (multinomial path, Ordinal.cpp:773-812):
        # intercepts + covariate predictor frozen at the null fit
        if not ok0:
            return r
        theta = p_n[: K - 1]
        off = Xn @ p_n[K - 1 :]
        _b, f1, it2, ok1 = _fit_pom_offset(Ym, theta, off, Yoh, maskf, K,
                                           maxit=maxit, tol=tol,
                                           max_step=mstep)
        r.niter += it1 + it2
        if not ok1:
            return r
        stat = 2 * (f0 - f1)  # negll difference; nested, so >= 0
        r.pval = 1.0 if stat < 0 else float(chi2.sf(stat, Ym.shape[1]))
        return r
    Xf = np.concatenate([Xn, Ym], axis=1)
    p_f, f1, it2, ok1 = _fit_pom(Xf, Yoh, maskf, K, theta0=p_n[: K - 1],
                                 maxit=maxit, tol=tol, max_step=mstep)
    r.niter += it1 + it2
    if not (ok0 and ok1):
        return r
    stat = 2 * (f0 - f1)  # negll difference
    r.pval = 1.0 if stat < 0 else float(chi2.sf(stat, Ym.shape[1]))
    return r


# ---------------------------------------------------------------------------
# Batched block driver (the vectorized twin of multiphen_snp's score
# stage)
# ---------------------------------------------------------------------------
#
# In the default --multiphen-test modes (nocov_score / the
# nocov_score_offset escalation strategy), the SCORE stage's null model
# has NO covariates, so the null linear predictor is CONSTANT across
# samples. Every score-test quantity then factors into per-CATEGORY
# scalars (derivatives of the categorical negll wrt (theta, eta) at
# eta=0 — _cat_derivs on a K-vector problem, the formulation of
# _pom_funcs incl. the 1e-12 clip) times masked
# sums of Yres:
#
#   U      = sum_n m_n a_{c_n} Y_n          ([B,N] @ [N,P] matmul)
#   I_bb   = sum_n m_n b_{c_n} Y_n Y_n'     (einsum bn,np,nq->bpq)
#   I_tb   = sum_n m_n s_{k,c_n} Y_n        ([B(K-1),N] @ [N,P])
#   I_tt   = category counts x q_{kl,c}     (host)
#
# The intercept-only null fits are replicated as vectorized damped
# Newton on the aggregated counts (same update/line-search/convergence
# rules as _fit_logistic/_fit_pom, so the printed IT column matches up
# to floating-point reassociation of the per-sample sums — bounded
# drift documented in PARITY.md). SNPs whose score p falls below
# --multiphen-thr (LRT escalation), failures, and the non-default
# cov_*/lrt modes take the per-SNP multiphen_snp path unchanged.


def _cat_scalars_batch(thetas, K):
    """Per-category derivative scalars of the negll at eta=0, for a
    BATCH of null fits (thetas [B, K-1]).

    Returns (a [B, K], b [B, K], s [B, K-1, K], q [B, K-1, K-1, K])
    where for a sample of category c: d(negll)/d eta = a_c,
    d2/d eta2 = b_c, d2/(d theta_k d eta) = s_{k,c},
    d2/(d theta_k d theta_l) = q_{kl,c}."""
    thetas = np.asarray(thetas, np.float64)
    B = thetas.shape[0]
    z = np.broadcast_to(thetas[:, None, :], (B, K, K - 1))  # eta = 0
    _f, g, H = _cat_derivs(z, np.broadcast_to(np.eye(K), (B, K, K)))
    return (g[..., K - 1], H[..., K - 1, K - 1],
            np.swapaxes(H[..., : K - 1, K - 1], 1, 2),
            np.moveaxis(H[..., : K - 1, : K - 1], 1, 3))


def _fit_logistic0_batch(sy, nm, maxit, tol, max_step):
    """Vectorized intercept-only logistic fits (the nocov score-stage
    null of the K=2 path): same damped-Newton rules as _fit_logistic on
    X=ones, driven by the sufficient statistics (sy, nm).
    Returns (b0, niter, ok)."""
    B = sy.shape[0]
    beta = np.zeros(B)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        def negll(b):
            eta = np.clip(b, -30, 30)
            pi = 1 / (1 + np.exp(-eta))
            return -(sy * np.log(pi) + (nm - sy) * np.log1p(-pi))

        f = negll(beta)
        niter = np.zeros(B, np.int64)
        ok = np.zeros(B, bool)
        active = np.ones(B, bool)
        for _ in range(maxit):
            eta = np.clip(beta, -30, 30)
            pi = 1 / (1 + np.exp(-eta))
            w = pi * (1 - pi)
            Ii = w * nm
            g = sy - pi * nm
            step = np.where(Ii > 0, g / np.where(Ii > 0, Ii, 1.0), np.nan)
            step = np.clip(step, -max_step, max_step)
            niter[active] += 1
            lw_ok = np.zeros(B, bool)
            cand = beta.copy()
            fc = f.copy()
            st = step.copy()
            for _h in range(8):
                trial = beta + st
                ft = negll(trial)
                better = ~lw_ok & np.isfinite(ft) & (ft <= f + 1e-12)
                cand[better] = trial[better]
                fc[better] = ft[better]
                lw_ok |= better
                st = st / 2
            done = np.abs(g) < tol
            fail = active & ~lw_ok & ~done
            conv = active & done
            ok |= conv
            newly_inactive = fail | conv
            beta = np.where(active & lw_ok, cand, beta)
            f = np.where(active & lw_ok, fc, f)
            active = active & ~newly_inactive
            if not active.any():
                break
        # per-SNP path: line-search failure still returns ok when the
        # gradient test passed on entry — covered by `done` above
        return beta, niter, ok


def _fit_pom0_batch(cnt, maxit, tol, max_step):
    """Vectorized intercept-only POM fits (K=3 nocov null): damped
    Newton on theta [B, K-1] from category counts, same rules as
    _fit_pom (marginal-logit start, 8-halving line search).
    Returns (theta, negll, niter, ok)."""
    B, K = cnt.shape
    tot = cnt.sum(axis=1)
    cf = np.cumsum(cnt, axis=1)[:, :-1] / tot[:, None]
    theta = np.log(cf / (1 - cf))

    def negll_grad_hess(th, want=True):
        cum = 1 / (1 + np.exp(-(th)))  # [B, K-1]
        cum1 = np.concatenate([cum, np.ones((B, 1))], axis=1)
        cum0 = np.concatenate([np.zeros((B, 1)), cum], axis=1)
        pi = np.clip(cum1 - cum0, 1e-12, 1.0)
        f = -(cnt * np.log(pi)).sum(axis=1)
        if not want:
            return f, None, None
        # d negll / d theta_k = -cnt_k f_k/pi_k + cnt_{k+1} f_k/pi_{k+1}
        fk = cum * (1 - cum)  # logistic pdf at theta_k
        g = -cnt[:, :-1] * fk / pi[:, :-1] + cnt[:, 1:] * fk / pi[:, 1:]
        # hessian: diagonal + one off-diagonal band (K-1 <= 2 here)
        dfk = fk * (1 - 2 * cum)
        H = np.zeros((B, K - 1, K - 1))
        for k in range(K - 1):
            H[:, k, k] = (
                -cnt[:, k] * (dfk[:, k] * pi[:, k] - fk[:, k] ** 2)
                / pi[:, k] ** 2
                + cnt[:, k + 1] * (dfk[:, k] * pi[:, k + 1] + fk[:, k] ** 2)
                / pi[:, k + 1] ** 2
            )
            if k + 1 < K - 1:
                od = -cnt[:, k + 1] * fk[:, k] * fk[:, k + 1] / pi[:, k + 1] ** 2
                H[:, k, k + 1] = od
                H[:, k + 1, k] = od
        return f, g, H

    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        f, _, _ = negll_grad_hess(theta, want=False)
        niter = np.zeros(B, np.int64)
        ok = np.zeros(B, bool)
        active = np.ones(B, bool)
        for _ in range(maxit):
            _f, g, H = negll_grad_hess(theta)
            try:
                step = np.linalg.solve(H, g[..., None])[..., 0]
            except np.linalg.LinAlgError:
                step = np.full_like(g, np.nan)
            mx = np.abs(step).max(axis=1)
            scale = np.where(mx > max_step, max_step / np.maximum(mx, 1e-30), 1.0)
            step = step * scale[:, None]
            niter[active] += 1
            lw_ok = np.zeros(B, bool)
            cand = theta.copy()
            fc = f.copy()
            st = step.copy()
            for _h in range(8):
                trial = theta - st
                ft, _, _ = negll_grad_hess(trial, want=False)
                better = ~lw_ok & np.isfinite(ft) & (ft <= f + 1e-12)
                cand[better] = trial[better]
                fc[better] = ft[better]
                lw_ok |= better
                st = st / 2
            done = np.abs(g).max(axis=1) < tol
            conv = active & done
            fail = active & ~lw_ok & ~done
            ok |= conv
            theta = np.where((active & lw_ok)[:, None], cand, theta)
            f = np.where(active & lw_ok, fc, f)
            active = active & ~(conv | fail)
            if not active.any():
                break
        return theta, f, niter, ok


def multiphen_block(params, Gf, Xcov, Yres, mask, idx):
    """Batched MultiPhen over the SNP rows `idx` of a decoded block.

    Returns {b: MPhenResult}. The default nocov score stage runs as
    batched linear algebra over the whole block; LRT escalations
    (p < --multiphen-thr), failures and non-default modes fall back to
    multiphen_snp per SNP."""
    mode = getattr(params, "multiphen_test", None) or "nocov_score_offset"
    mode = {"cov_score_it1": "cov_score", "nocov_score_addcov":
            "nocov_score_offset", "offset": "nocov_score_offset"}.get(mode, mode)
    out = {}
    if mode not in ("nocov_score", "nocov_score_offset") or len(idx) == 0:
        for b in idx:
            out[b] = multiphen_snp(params, Gf[b], Xcov, Yres, mask)
        return out
    idx = np.asarray(idx, dtype=np.int64)

    tol = params.multiphen_tol
    maxit = params.multiphen_maxit
    mstep = params.multiphen_maxstep
    thr = params.multiphen_thr if mode == "nocov_score_offset" else -1.0

    Gi = np.round(Gf[idx]).astype(np.int64)  # [B, N]
    Mm = mask[None, :] & (Gf[idx] != -3)  # [B, N] bool
    maskf = Mm.astype(np.float64)

    # per-SNP category census (vectorized)
    has = np.zeros((len(idx), 3), bool)
    for v in range(3):
        has[:, v] = ((Gi == v) & Mm).any(axis=1)
    Kv = has.sum(axis=1)

    esc = []  # SNPs needing the per-SNP path

    # ---- K == 2 batch ----
    k2 = np.flatnonzero(Kv == 2)
    if k2.size:
        # code = searchsorted(cats, g): 1 iff g == upper category
        hi_cat = 2 - np.argmax(has[k2][:, ::-1], axis=1)
        y = ((Gi[k2] == hi_cat[:, None]) & Mm[k2]).astype(np.float64)
        mk = maskf[k2]
        sy = y.sum(axis=1)
        nm = mk.sum(axis=1)
        b0, it0, ok0 = _fit_logistic0_batch(sy, nm, maxit, tol, mstep)
        pi0 = 1 / (1 + np.exp(-np.clip(b0, -30, 30)))
        w0 = pi0 * (1 - pi0)
        R = (y - pi0[:, None] * mk)  # (y - pi)*maskf (y already masked)
        U = R @ Yres  # [B2, P]
        syY = mk @ Yres  # [B2, P]
        # I_bb = w0 * sum_n m Y Y'; correct from the full Gram by the
        # MISSING rows only (masks differ from mask0 just at missing g)
        Y0 = Yres * mask[:, None].astype(np.float64)
        G_full = Y0.T @ Y0
        M2 = np.empty((k2.size, Yres.shape[1], Yres.shape[1]))
        for j in range(k2.size):
            drop = mask & ~Mm[k2[j]]
            if drop.any():
                Yd = Yres[drop]
                M2[j] = G_full - Yd.T @ Yd
            else:
                M2[j] = G_full
        with np.errstate(divide="ignore", invalid="ignore"):
            V = w0[:, None, None] * M2 - (
                w0[:, None, None] / np.maximum(w0 * nm, 1e-300)[:, None, None]
                * w0[:, None, None] * syY[:, :, None] * syY[:, None, :]
            )
        for j, jj in enumerate(k2):
            b = idx[jj]
            r = MPhenResult()
            if not ok0[j]:
                out[b] = r
                continue
            r.niter = int(it0[j])
            try:
                stat = float(U[j] @ np.linalg.solve(V[j], U[j]))
            except np.linalg.LinAlgError:
                stat = -1.0
            pv = float(chi2.sf(stat, Yres.shape[1])) if stat >= 0 else -1.0
            r.pval = pv
            if thr > 0 and 0 <= pv < thr:
                esc.append(b)
            else:
                out[b] = r

    # ---- K == 3 batch ----
    k3 = np.flatnonzero(Kv == 3)
    if k3.size:
        code = Gi[k3]  # cats are exactly {0,1,2}
        mk = maskf[k3]
        cnt = np.stack(
            [((code == v) & Mm[k3]).sum(axis=1) for v in range(3)], axis=1
        ).astype(np.float64)
        theta, _f0, it0, ok0 = _fit_pom0_batch(cnt, maxit, tol, mstep)
        P = Yres.shape[1]
        a_all, b_all, s_all, q_all = _cat_scalars_batch(theta, 3)
        B3 = k3.size
        j_ar = np.arange(B3)[:, None]
        # per-sample scalar maps, batched: [B3, N]
        Am = mk * a_all[j_ar, code]
        Bm = mk * b_all[j_ar, code]
        S0 = mk * s_all[j_ar, 0, code]
        S1m = mk * s_all[j_ar, 1, code]
        U_all = -(Am @ Yres)  # negll grad -> score = -grad
        I_tb_all = np.stack([S0 @ Yres, S1m @ Yres], axis=1)  # [B3, 2, P]
        I_tt_all = np.einsum("bc,bklc->bkl", cnt, q_all)
        # batched I_bb via chunked threaded matmuls ([c,N,P] temps)
        I_bb_all = np.empty((B3, P, P))
        chunk = max(1, int(2e8 / (Yres.shape[0] * P * 8)))
        for c0 in range(0, B3, chunk):
            tmp = Bm[c0 : c0 + chunk, :, None] * Yres[None]
            I_bb_all[c0 : c0 + chunk] = np.matmul(Yres.T[None], tmp)
        for j, jj in enumerate(k3):
            b = idx[jj]
            r = MPhenResult()
            r.is_multinom = True
            if not ok0[j]:
                out[b] = r
                continue
            r.niter = int(it0[j])
            U = U_all[j]
            try:
                V = I_bb_all[j] - I_tb_all[j].T @ np.linalg.solve(
                    I_tt_all[j], I_tb_all[j])
                stat = float(U @ np.linalg.solve(V, U))
            except np.linalg.LinAlgError:
                stat = -1.0
            pv = float(chi2.sf(stat, P)) if stat >= 0 else -1.0
            r.pval = pv
            if thr > 0 and 0 <= pv < thr:
                esc.append(b)
            else:
                out[b] = r

    # degenerate (<2 categories) rows
    for jj in np.flatnonzero(Kv < 2):
        out[idx[jj]] = MPhenResult()

    # escalations / failures: full per-SNP run (score + LRT)
    for b in esc:
        out[b] = multiphen_snp(params, Gf[b], Xcov, Yres, mask)
    return out


def multiphen_header() -> str:
    """print_header_output_all_multiphen (Step2_Models.cpp:2319)."""
    return "CHROM GENPOS ID ALLELE0 ALLELE1 MAC A1FREQ N LOG10P MULTINOM IT UP FIRTH\n"


def multiphen_line(snp, mac1, af1, ns1, r: MPhenResult) -> str:
    """One output row (MultiPhen::print_sumstats, Ordinal.cpp)."""
    from ..prep import fmt

    parts = [str(snp.chrom), str(snp.physpos), snp.ID, snp.allele1, snp.allele2,
             fmt(mac1), fmt(af1), str(int(ns1))]
    if r.pval < 0:
        parts.append("NA")
    else:
        parts.append(fmt(-np.log10(max(r.pval, 5e-324))))
    parts.append("1" if r.is_multinom else "0")
    parts += [str(r.niter), str(r.n_updates), "1" if r.used_firth else "0"]
    return " ".join(parts) + "\n"
