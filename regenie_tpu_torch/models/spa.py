"""Saddle-point approximation (SPA) for binary-trait score tests (the
port's copy of regenie_tpu/models/spa.py), on the host in numpy float64:
the host twin of models/corrections_device.spa_batch_dev.

Re-implements run_SPA_test_snp / solve_K1_snp / compute_K*_snp /
get_SPA_pvalue_snp (Step2_Models.cpp:2072-2303) vectorized over the
batch of corrected SNPs: each Newton/bisection iteration is one [S, N]
pass with per-SNP root state (the reference solves one SNP at a time).

Notation: Gmod = Gres / Gamma_sqrt * mask, val_a = sum(Gmod * phat),
val_c = sqrt(denum); CGF of the score statistic T = sum_i Gmod_i (y_i -
phat_i) / val_c.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy.stats import norm as _norm

from ..utils.stats import neglog10_to_chisq

MAX_EXP_LIM = 708.0


def _K(t, Gmod, phat, maskf, val_a, val_c):
    """K(t): [S] for per-SNP t. t: [S]."""
    arg = t[:, None] / val_c[:, None] * Gmod
    val = (np.log1p(phat[None, :] * (np.exp(np.minimum(arg, MAX_EXP_LIM)) - 1.0)) * maskf).sum(axis=1)
    return val - t * val_a / val_c


def _K1(t, Gmod, phat, maskf, val_a, val_c):
    """K'(t): [S]."""
    arg = -t[:, None] / val_c[:, None] * Gmod
    denom = phat[None, :] + (1 - phat[None, :]) * np.exp(np.minimum(arg, MAX_EXP_LIM))
    val = ((Gmod * phat[None, :] / val_c[:, None]) / denom * maskf).sum(axis=1)
    return val - val_a / val_c


def _K2(t, Gmod, phat, gamma2, maskf, val_c):
    """K''(t): [S]; returns 0 where overflow occurs (reference behavior)."""
    arg = -t[:, None] / val_c[:, None] * Gmod
    over = ((arg > MAX_EXP_LIM) & (maskf > 0)).any(axis=1)
    arg = np.minimum(arg, MAX_EXP_LIM)
    # arg just below MAX_EXP_LIM still overflows when squared: an inf
    # denom yields a 0 contribution (e/denom -> 0), same limit as the
    # reference's overflow->0 branch — silence the benign warning.
    # When the NUMERATOR overflows too (huge Gmod^2*gamma2 scale) the
    # row is inf/inf = nan; sanitize it to the same 0 the over-branch
    # returns instead of feeding nan into the Newton step.
    with np.errstate(over="ignore", invalid="ignore"):
        e = np.exp(arg)
        denom = (phat[None, :] + (1 - phat[None, :]) * e) ** 2
        val = ((Gmod**2 * gamma2[None, :] / val_c[:, None] ** 2 * e)
               / denom * maskf).sum(axis=1)
    return np.where(over | ~np.isfinite(val), 0.0, val)


def _solve_K1(tval, lam, Gmod, phat, gamma2, maskf, val_a, val_c, tol, niter_max):
    """Vectorized Newton + bisection root of lam*K1(lam*t) = tval
    (solve_K1_snp, Step2_Models.cpp:2146-2200). tval: [S] (<= 0).
    Returns (root [S], ok [S])."""
    S = len(tval)
    min_x = np.where(tval >= 0, 0.0, np.finfo(np.float64).min)
    max_x = np.where(tval >= 0, np.finfo(np.float64).max, 0.0)
    t_old = np.zeros(S)
    f_old = lam * _K1(lam * t_old, Gmod, phat, maskf, val_a, val_c) - tval
    active = np.ones(S, dtype=bool)
    ok = np.zeros(S, dtype=bool)
    t_new = np.full(S, -1.0)

    for _ in range(niter_max):
        if not active.any():
            break
        hess = _K2(lam * t_old, Gmod, phat, gamma2, maskf, val_c)
        bad_hess = active & (hess == 0)
        active &= ~bad_hess
        with np.errstate(divide="ignore", invalid="ignore"):
            cand = t_old - f_old / np.where(hess == 0, 1.0, hess)
        cand = np.where(active, cand, t_old)
        f_new = lam * _K1(lam * cand, Gmod, phat, maskf, val_a, val_c) - tval

        done = active & (np.abs(f_new) < tol)
        t_new = np.where(active, cand, t_new)
        ok |= done
        active2 = active & ~done

        in_bounds = (cand != 0) & (cand > min_x) & (cand < max_x)
        # update bounds for in-bounds Newton steps
        upd_hi = active2 & in_bounds & (f_new > 0)
        upd_lo = active2 & in_bounds & (f_new <= 0)
        max_x = np.where(upd_hi, cand, max_x)
        min_x = np.where(upd_lo, cand, min_x)
        # bisection for out-of-bounds
        bis = active2 & ~in_bounds
        if bis.any():
            cand_b = (min_x + max_x) / 2
            f_b = lam * _K1(lam * cand_b, Gmod, phat, maskf, val_a, val_c) - tval
            cand = np.where(bis, cand_b, cand)
            f_new = np.where(bis, f_b, f_new)
            min_x = np.where(bis & (f_b <= 0), cand_b, min_x)
            max_x = np.where(bis & (f_b > 0), cand_b, max_x)

        t_old = np.where(active2, cand, t_old)
        f_old = np.where(active2, f_new, f_old)
        active = active2

    return t_new, ok


def _tail_pv(root, tval, lam, Gmod, phat, gamma2, maskf, val_a, val_c):
    """One-sided SPA tail probability at the root (get_SPA_pvalue_snp,
    Step2_Models.cpp:2274). Returns (pv [S], ok [S])."""
    kval = _K(lam * root, Gmod, phat, maskf, val_a, val_c)
    k2val = _K2(lam * root, Gmod, phat, gamma2, maskf, val_c)
    ok = k2val != 0
    with np.errstate(invalid="ignore", divide="ignore"):
        wval = np.sign(root) * np.sqrt(np.maximum(2 * (root * tval - kval), 0.0))
        vval = root * np.sqrt(k2val)
        rval = wval + np.log(np.abs(vval / np.where(wval == 0, 1.0, wval))) / np.where(
            wval == 0, 1.0, wval
        )
        pv = np.where(vval == 0, 0.5, _norm.cdf(rval))
    return pv, ok


def spa_batch_auto(stats, denum, Gres, phat, gamma_sqrt, mask, device="cpu",
                   **kw):
    """SPA where the port's corrections run: on the device
    (corrections_device.spa_batch_dev) when
    corrections_device.enabled(device), else the host float64 twin. The
    arrays may be numpy or tensors."""
    from . import corrections_device as cdev

    if cdev.enabled(device):
        return cdev.spa_batch_dev(stats, denum, Gres, phat, gamma_sqrt, mask,
                                  device=device, **kw)
    from .firth import host_f64

    stats, denum, Gres, phat, gamma_sqrt, mask = (
        host_f64(a) for a in (stats, denum, Gres, phat, gamma_sqrt, mask))
    return spa_batch(stats, denum, Gres, phat, gamma_sqrt, mask.astype(bool),
                     **kw)


def spa_batch(
    stats: np.ndarray,
    denum: np.ndarray,
    Gres: np.ndarray,
    phat: np.ndarray,
    gamma_sqrt: np.ndarray,
    mask: np.ndarray,
    tol: float = 5e-5,
    niter_max: int = 1000,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """SPA-corrected p-values for a batch of SNPs (dense path of
    run_SPA_test_snp, Step2_Models.cpp:2072-2142).

    stats: [S] score stats; denum: [S] = G'WG; Gres: [S, N] weighted
    covariate-residualized genotypes; phat: [N] null probabilities;
    gamma_sqrt: [N]; mask: [N] bool.
    Returns (chisq [S], neglog10p [S], test_fail [S])."""
    S, N = Gres.shape
    maskf = mask.astype(np.float64)
    val_c = np.sqrt(denum)
    Gmod = Gres / gamma_sqrt[None, :] * maskf[None, :]
    val_a = (Gmod * phat[None, :]).sum(axis=1)
    gamma2 = gamma_sqrt**2

    score_num = stats * val_c
    limK1_low = np.where(Gmod < 0, Gmod, 0).sum(axis=1) - val_a
    limK1_high = np.where(Gmod > 0, Gmod, 0).sum(axis=1) - val_a
    fail = (score_num < limK1_low) | (score_num > limK1_high)

    tval = -np.abs(stats)

    # tail 1 (lam=+1) and tail 2 (lam=-1)
    pvs = []
    for lam in (1, -1):
        root, ok = _solve_K1(
            tval, lam, Gmod, phat, gamma2, maskf, val_a, val_c, tol, niter_max
        )
        fail |= ~ok
        pv, ok2 = _tail_pv(root, tval, lam, Gmod, phat, gamma2, maskf, val_a, val_c)
        fail |= ~ok2
        pvs.append(pv)

    pv_tot = pvs[0] + pvs[1]
    fail |= pv_tot > 1
    pv_tot = np.clip(pv_tot, 5e-324, 1.0)
    logp = -np.log10(pv_tot)
    chisq = neglog10_to_chisq(logp)
    return chisq, logp, fail
