"""Firth-penalized logistic regression for Step-2 binary-trait tests
(the port's copy of regenie_tpu/models/firth.py, trimmed to the
approximate Firth path), on the host in numpy float64.

- the multi-parameter null fit per chromosome (fit_firth_nr,
  Step2_Models.cpp:1267; fit_approx_firth_null :899), with the ADAM
  fallback (fit_firth_adam :1739);
- the single-parameter per-SNP LRT fit (fit_firth, Step2_Models.cpp:1649)
  vectorized over the batch of corrected SNPs: each Newton iteration is
  one [S, N] pass with per-row convergence masks. It is the host twin of
  models/corrections_device.firth_snp_batch_dev;
- the dispatch firth_snp_batch_auto that the gene-based BT VC tests
  call (the device solver on a card, the host twin on the CPU).

Penalized deviance: dev = -2 loglik - log|X'WX|; the modified score adds
the Firth term h*(0.5-pi).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .glm import get_logist_dev, get_pvec

_EPS10 = 10 * np.finfo(np.float64).eps


def fit_firth_multi(
    y: np.ndarray,
    X: np.ndarray,
    offset: np.ndarray,
    mask: np.ndarray,
    beta0: Optional[np.ndarray] = None,
    cols_incl: Optional[int] = None,
    maxstep: int = 25,
    niter: int = 1000,
    tol: float = 5e-5,
    niter_line_search: int = 5,
    comp_lrt: bool = False,
):
    """Multi-parameter Firth-penalized logistic fit (fit_firth_nr,
    Step2_Models.cpp:1267-1385): Newton on the modified score with only
    the first cols_incl coefficients free; the penalty determinant uses
    ALL columns of X.

    Returns (beta, se, dev, dev0, converged); dev0 is the penalized
    deviance at the starting beta (the exact-Firth null deviance when
    comp_lrt)."""
    maskf = mask.astype(np.float64)
    nc = X.shape[1]
    ci = nc if cols_incl is None else cols_incl
    beta = np.zeros(nc) if beta0 is None else beta0.copy()
    dev0 = None
    se = np.zeros(nc)

    niter_cur = 0
    while niter_cur < niter:
        niter_cur += 1
        eta = offset + X @ beta
        pi = get_pvec(eta)
        w = np.where(mask, pi * (1 - pi), 1.0)
        sw = np.sqrt(w) * maskf
        XW = X * sw[:, None]
        xtwx = XW.T @ XW
        sign, logdet = np.linalg.slogdet(xtwx)
        dev_old = get_logist_dev(y, pi, mask) - logdet
        if comp_lrt and dev0 is None:
            dev0 = dev_old
        try:
            sol = np.linalg.solve(xtwx, XW.T)
        except np.linalg.LinAlgError:
            return beta, se, dev_old, dev0, False
        hvec = (sol * XW.T).sum(axis=0)
        resid_mod = np.where(mask, y - pi + hvec * (0.5 - pi), 0.0)
        mod_score = X[:, :ci].T @ resid_mod
        try:
            step = np.linalg.solve(xtwx[:ci, :ci], mod_score)
        except np.linalg.LinAlgError:
            return beta, se, dev_old, dev0, False

        if np.abs(mod_score).max() < tol and niter_cur >= 2:
            se = np.sqrt(np.abs(np.diag(np.linalg.pinv(xtwx))))
            return beta, se, dev_old, dev0, True

        mx = np.abs(step).max() / maxstep
        if mx > 1:
            step = step / mx

        ok = False
        for ls in range(niter_line_search):
            if ls > 0:
                step = step / 2
            betanew = beta.copy()
            betanew[:ci] = beta[:ci] + step
            eta = offset + X @ betanew
            pi = get_pvec(eta)
            w = np.where(mask, pi * (1 - pi), 1.0)
            XWn = X * (np.sqrt(w) * maskf)[:, None]
            sign, logdet = np.linalg.slogdet(XWn.T @ XWn)
            dev_new = get_logist_dev(y, pi, mask) - logdet
            if dev_new < dev_old:
                ok = True
                break
        if not ok:
            # reference nudges the step by 1e-6 on line-search failure when
            # computing the LRT; otherwise fail
            if comp_lrt:
                betanew = beta.copy()
                betanew[:ci] = beta[:ci] + step + 1e-6
            else:
                return beta, se, dev_old, dev0, False
        beta = betanew
    return beta, se, dev_old, dev0, False


def fit_firth_null(
    y, X, offset, mask, beta0=None, maxstep=25, niter=1000, tol=5e-5,
    niter_line_search=5,
) -> Tuple[np.ndarray, bool]:
    """Covariates-only approx-Firth null (fit_approx_firth_null wrapper).
    Falls back to full-batch ADAM + Newton polish when Newton with
    step-halving fails (use_adam path, Step2_Models.cpp:1013)."""
    beta, _se, _dev, _dev0, ok = fit_firth_multi(
        y, X, offset, mask, beta0, None, maxstep, niter, tol, niter_line_search
    )
    if not ok:
        b_adam, _dev, ok_a = firth_adam(y, X, offset, mask, beta0, None,
                                        niter=200, tol=tol)
        beta2, _se, _dev, _d0, ok2 = fit_firth_multi(
            y, X, offset, mask, b_adam, None, maxstep, niter, tol,
            niter_line_search,
        )
        if ok2 or ok_a:
            return (beta2 if ok2 else b_adam), True
    return beta, ok


def firth_snp_batch(
    y: np.ndarray,
    G: np.ndarray,
    offset: np.ndarray,
    mask: np.ndarray,
    maxstep: int = 5,
    niter: int = 250,
    tol: float = 2.5e-4,
    niter_line_search: int = 5,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Single-parameter approx-Firth LRT, vectorized over S SNPs
    (fit_firth single-param NR, Step2_Models.cpp:1649-1737).

    y: [N] 0/1; G: [S, N] covariate-residualized genotypes on the X scale
    (Gres / Gamma_sqrt); offset: [N] covariate+LOCO offset from the null
    Firth fit; mask: [N] bool.

    Returns (beta [S], se [S], lrt [S], converged [S])."""
    S, N = G.shape
    maskf = mask.astype(np.float64)
    Gm = G * maskf[None, :]
    G2 = Gm**2

    # null deviance at beta=0 (same pi for all SNPs; SNP-specific logdet)
    pi0 = get_pvec(offset)
    w0 = np.where(mask, pi0 * (1 - pi0), 1.0)
    dev_base = get_logist_dev(y, pi0, mask)
    xtwx0 = G2 @ w0
    dev0 = dev_base - np.log(xtwx0)

    beta = np.zeros(S)
    dev_old = dev0.copy()
    active = xtwx0 > 0
    converged = np.zeros(S, dtype=bool)
    dev_cur = dev0.copy()

    ym = np.where(mask, y, 0.0)

    def eval_dev(b):
        """penalized deviance + quantities at beta vector b: returns
        (pi [S,N], w [S,N], xtwx [S], dev [S])."""
        eta = offset[None, :] + Gm * b[:, None]
        pi = get_pvec(eta)
        w = np.where(mask[None, :], pi * (1 - pi), 1.0)
        xtwx = (G2 * w).sum(axis=1)
        with np.errstate(divide="ignore", invalid="ignore"):
            nll = np.where(y[None, :] == 0, -np.log1p(-pi), -np.log(pi))
        dev = 2.0 * (nll * maskf[None, :]).sum(axis=1) - np.log(xtwx)
        return pi, w, xtwx, dev

    pi, w, xtwx, dev_old = eval_dev(beta)
    niter_cur = 0
    while niter_cur < niter and active.any():
        niter_cur += 1
        h = (G2 * w) / xtwx[:, None]
        mod_score = (Gm * (y[None, :] - pi + h * (0.5 - pi)) * mask[None, :]).sum(axis=1)

        done = (np.abs(mod_score) < tol) & (niter_cur >= 2) & active
        converged |= done
        active &= ~done
        if not active.any():
            break

        step = mod_score / xtwx
        mx = np.abs(step) / maxstep
        step = np.where(mx > 1, step / np.where(mx > 1, mx, 1.0), step)

        # step-halving on penalized deviance (active SNPs only)
        beta_try = beta.copy()
        improved = ~active  # inactive count as done
        for ls in range(niter_line_search):
            cand = np.where(active & ~improved, beta + step / (2**ls), beta_try)
            pi_c, w_c, xtwx_c, dev_c = eval_dev(cand)
            better = active & ~improved & (dev_c < dev_old)
            beta_try = np.where(better, cand, beta_try)
            # cache quantities for accepted
            pi = np.where(better[:, None], pi_c, pi)
            w = np.where(better[:, None], w_c, w_c * 0 + w)
            xtwx = np.where(better, xtwx_c, xtwx)
            dev_cur = np.where(better, dev_c, dev_cur)
            improved |= better
            if improved.all():
                break
        # reference behavior: if step-halving fails, nudge step by 1e-6
        fail_ls = active & ~improved
        if fail_ls.any():
            cand = np.where(fail_ls, beta + step / (2 ** (niter_line_search - 1)) + 1e-6, beta_try)
            pi_c, w_c, xtwx_c, dev_c = eval_dev(cand)
            beta_try = np.where(fail_ls, cand, beta_try)
            pi = np.where(fail_ls[:, None], pi_c, pi)
            w = np.where(fail_ls[:, None], w_c, w)
            xtwx = np.where(fail_ls, xtwx_c, xtwx)
            dev_cur = np.where(fail_ls, dev_c, dev_cur)

        beta = beta_try
        dev_old = np.where(active, dev_cur, dev_old)

    lrt = dev0 - dev_cur
    se = np.sqrt(1.0 / np.maximum(xtwx, 1e-300))
    converged &= lrt >= 0
    return beta, se, lrt, converged


def firth_snp_batch_auto(y, G, offset, mask, device="cpu", **kw):
    """The per-SNP Firth LRT where the port's corrections run: on the
    device (corrections_device.firth_snp_batch_dev) when
    corrections_device.enabled(device), else the host float64 twin, as
    the port's Step-2 Firth runs. G: [S, N] numpy or a tensor."""
    from . import corrections_device as cdev

    if cdev.enabled(device):
        return cdev.firth_snp_batch_dev(y, G, offset, mask, device=device, **kw)
    return firth_snp_batch(host_f64(y), host_f64(G), host_f64(offset),
                           host_f64(mask).astype(bool), **kw)


def host_f64(a) -> np.ndarray:
    """A float64 numpy copy of a tensor or an array."""
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float64)


def firth_adam(
    y, X, offset, mask, beta0=None, cols_incl=None, niter=25,
    alpha=0.001, beta1=0.9, beta2=0.999, eps=1e-7, tol=5e-5,
):
    """Full-batch ADAM on the Firth modified score (fit_firth_adam,
    Step2_Models.cpp:1739) — last-resort fallback when Newton with
    step-halving fails. Deterministic (no mini-batch sampling).

    Returns (beta, dev, converged)."""
    maskf = mask.astype(np.float64)
    nc = X.shape[1]
    ci = nc if cols_incl is None else cols_incl
    beta = np.zeros(nc) if beta0 is None else beta0.copy()
    mt = np.zeros(ci)
    vt = np.zeros(ci)
    ok = False
    for it in range(1, niter + 1):
        eta = offset + X @ beta
        pi = get_pvec(eta)
        w = np.where(mask, pi * (1 - pi), 0.0)
        XW = X * np.sqrt(w)[:, None]
        xtwx = XW.T @ XW
        try:
            sol = np.linalg.solve(xtwx, XW.T)
        except np.linalg.LinAlgError:
            break
        hvec = (sol * XW.T).sum(axis=0)
        grad = -(X[:, :ci].T @ (maskf * (y - pi + hvec * (0.5 - pi))))
        if np.abs(grad).max() < tol:
            ok = True
            break
        mt = beta1 * mt + (1 - beta1) * grad
        vt = beta2 * vt + (1 - beta2) * grad**2
        a_t = alpha * np.sqrt(1 - beta2**it) / (1 - beta1**it)
        beta[:ci] -= a_t * mt / (np.sqrt(vt) + eps)
    eta = offset + X @ beta
    pi = get_pvec(eta)
    w = np.where(mask, pi * (1 - pi), 1.0)
    XW = X * (np.sqrt(w) * maskf)[:, None]
    _s, logdet = np.linalg.slogdet(XW.T @ XW)
    dev = get_logist_dev(y, pi, mask) - logdet
    return beta, dev, ok
