"""Null fits of binary, count and time-to-event traits (the port's copy
of regenie_tpu/models/glm.py), on the host in numpy float64, a trait at a
time, as in the JAX package.

Re-implements the reference's fit_null_logistic (Step1_Models.cpp:54),
fit_logistic (:156), fit_null_poisson (:225) and Step 1's branch of
fit_null_cox (:353, the Cox ridge at lambda = 0, models/survival.py). The
level-1 ridge of these traits is models/step1_bt.py.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..config import BT, CT, T2E, Params
from .survival import CoxRidge, SurvivalData


ETA_MIN, ETA_MAX = -30.0, 30.0
_EPS10 = 10 * np.finfo(np.float64).eps


def get_pvec(eta: np.ndarray, eps: float = _EPS10) -> np.ndarray:
    """eta -> pi with glm-style clamping (Step1_Models.cpp:1799-1806)."""
    pi = 1.0 - 1.0 / (np.exp(np.clip(eta, ETA_MIN, ETA_MAX)) + 1.0)
    pi = np.where(eta > ETA_MAX, 1.0 / (1.0 + eps), pi)
    pi = np.where(eta < ETA_MIN, eps / (1.0 + eps), pi)
    return pi


def get_logist_dev(y: np.ndarray, pi: np.ndarray, mask: np.ndarray) -> float:
    """-2 log-lik over masked samples (get_logist_dev, Step1_Models.cpp:1820)."""
    with np.errstate(divide="ignore"):
        nll = np.where(y == 0, -np.log(1.0 - pi), -np.log(pi))
    return 2.0 * nll[mask].sum()


def get_pvec_t(eta: torch.Tensor) -> torch.Tensor:
    """get_pvec on a tensor (the device solvers' twin)."""
    pi = 1.0 - 1.0 / (torch.exp(torch.clamp(eta, ETA_MIN, ETA_MAX)) + 1.0)
    pi = torch.where(eta > ETA_MAX, 1.0 / (1.0 + _EPS10), pi)
    return torch.where(eta < ETA_MIN, _EPS10 / (1.0 + _EPS10), pi)


def get_logist_dev_t(y: torch.Tensor, pi: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """get_logist_dev on tensors, over the last axis (one deviance a row of
    a [..., N] pi; mask [N] bool)."""
    nll = torch.where(y == 0, -torch.log(1.0 - pi), -torch.log(pi))
    return 2.0 * torch.where(mask, nll, 0.0).sum(dim=-1)


def fit_logistic_irls(
    y: np.ndarray,
    X: np.ndarray,
    offset: np.ndarray,
    mask: np.ndarray,
    niter_max: int = 30,
    tol: float = 1e-6,
    check_hs_dev: bool = True,
    beta0: Optional[np.ndarray] = None,
    niter_max_line_search: int = 5,
) -> Tuple[np.ndarray, bool]:
    """Null logistic IRLS, faithful to the reference fit_logistic
    (Step1_Models.cpp:156-224): Newton step from the working response,
    step-halving on deviance increase / invalid pi, score-based stopping
    with deviance fallback. Returns (beta, converged).

    Like the reference caller (fit_null_logistic, :88), callers should
    retry with check_hs_dev=False if the first attempt fails.
    """
    maskf = mask.astype(np.float64)
    beta = np.zeros(X.shape[1]) if beta0 is None else beta0.copy()
    eta = offset + X @ beta
    pi = get_pvec(eta)
    dev_old = get_logist_dev(y, pi, mask)
    dev_new = dev_old
    diff_dev = np.inf
    small_score_reached = False
    betanew = beta

    niter_cur = 0
    while niter_cur < niter_max:
        niter_cur += 1
        w = np.where(mask, pi * (1.0 - pi), 1.0)
        if (w == 0).any():
            return beta, False
        XtW = X.T * (maskf * w)
        z = np.where(mask, eta - offset + (y - pi) / w, 0.0)
        try:
            betanew = np.linalg.lstsq(XtW @ X, XtW @ z, rcond=None)[0]
        except np.linalg.LinAlgError:
            return beta, False

        ok = False
        for _ in range(niter_max_line_search):
            eta = offset + X @ betanew
            pi = get_pvec(eta)
            dev_new = get_logist_dev(y, pi, mask)
            valid = np.all((pi[mask] > 0) & (pi[mask] < 1))
            if valid and (not check_hs_dev or dev_new < dev_old):
                ok = True
                break
            betanew = (beta + betanew) / 2.0
        if not ok:
            return beta, False

        score = X.T @ np.where(mask, y - pi, 0.0)
        smax = np.abs(score).max()
        if smax < tol:
            return betanew, True
        if not small_score_reached and niter_cur < 20 and smax < 1:
            small_score_reached = True
        if small_score_reached and niter_cur > 20 and smax > 5:
            return beta, False

        diff_dev = abs(dev_new - dev_old) / (0.1 + abs(dev_new))
        beta = betanew
        dev_old = dev_new

    if diff_dev == 0 or diff_dev >= tol:
        return betanew, False
    return betanew, True


def fit_poisson_irls(
    y: np.ndarray,
    X: np.ndarray,
    offset: np.ndarray,
    mask: np.ndarray,
    niter_max: int = 30,
    tol: float = 1e-6,
) -> Tuple[np.ndarray, bool]:
    """Null Poisson IRLS (fit_null_poisson, Step1_Models.cpp:225)."""
    maskf = mask.astype(np.float64)
    ymean = y[mask].mean()
    beta = np.zeros(X.shape[1])
    beta[0] = np.log(ymean) * np.sqrt(mask.sum())  # X col0 is normalized intercept
    for _ in range(niter_max):
        eta = np.where(mask, X @ beta + offset, 0.0)
        mu = np.where(mask, np.exp(eta), 0.0)
        score = X.T @ (maskf * (y - mu))
        if np.abs(score).max() < tol:
            return beta, True
        XtW = X.T * (maskf * mu)
        try:
            beta = beta + np.linalg.solve(XtW @ X, score)
        except np.linalg.LinAlgError:
            return beta, False
    return beta, False


def fit_null_offsets(params: Params, pd) -> np.ndarray:
    """Step 1's null model of every passing trait against the covariates
    (fit_null_models, Step1_Models.cpp:54+): the offset matrix [N, P]
    (offset_nullreg in the reference's ests struct), zero outside each
    trait's mask. A trait whose fit fails stops passing. A time-to-event
    trait's offset is its Cox null's linear predictor, on its time column
    (the event columns are fitted with their time column)."""
    if params.trait_mode not in (BT, CT, T2E):
        raise NotImplementedError("null offsets of non-QT traits only")
    N, P = pd.phenotypes_raw.shape
    offsets = np.zeros((N, P))
    zero_off = np.zeros(N)
    for ph in range(P):
        if not pd.pheno_pass[ph]:
            continue
        y = pd.phenotypes_raw[:, ph]
        mask = pd.masked_indivs[:, ph]
        if params.trait_mode == T2E:
            # Cox null: cox_ridge at lambda=0 on covariates (fit_null_cox
            # step-1 branch, Step1_Models.cpp:353); offset = linear predictor
            if pd.pheno_names[ph] not in params.t2e_map:
                continue
            ei = pd.pheno_names.index(params.t2e_map[pd.pheno_names[ph]])
            sd = SurvivalData()
            sd.setup(y, pd.phenotypes_raw[:, ei], mask, norm_weights=True)
            cr = CoxRidge(sd, pd.new_cov, zero_off, mask, 0.0, params.niter_max,
                          params.niter_max_line_search, 2.5e-4)
            cr.fit()
            if not cr.converge:
                pd.pheno_pass[ph] = False
                continue
            offsets[:, ph] = cr.eta
            continue
        if params.trait_mode == BT:
            beta, ok = fit_logistic_irls(
                y, pd.new_cov, zero_off, mask, params.niter_max, params.numtol, True)
            if not ok:
                beta, ok = fit_logistic_irls(
                    y, pd.new_cov, zero_off, mask, params.niter_max, params.numtol,
                    False)
        else:
            beta, ok = fit_poisson_irls(y, pd.new_cov, zero_off, mask,
                                        params.niter_max, params.numtol)
        if not ok:
            pd.pheno_pass[ph] = False
            continue
        offsets[:, ph] = np.where(mask, pd.new_cov @ beta, 0.0)
    return offsets
