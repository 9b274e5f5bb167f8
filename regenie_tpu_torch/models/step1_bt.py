"""Step 1 level-1 ridge of binary, count and time-to-event traits (the
port's copy of regenie_tpu/models/step1_bt.py): penalized logistic and
Poisson fits of the level-0 predictions, K-fold or LOOCV, and the
penalized Cox fit, K-fold.

Re-implements ridge_logistic_level_1 (Step1_Models.cpp:966),
ridge_logistic_level_1_loocv with run_log_ridge_loocv (:1159-1377),
ridge_poisson_level_1 (:1429), ridge_poisson_level_1_loocv with
run_ct_ridge_loocv (:1585, :1680), the ADAM pass of
run_log_ridge_loocv_adam (:1377), make_predictions_binary_loocv
(Data.cpp:1484; --l1-full: make_predictions_binary_loocv_full, :1429)
and ridge_cox_level_1 (Step1_Models.cpp:2228) with cox_ridge's coordinate
descent (cox_ridge.cpp).

Everything stays on the level-0 predictions' device in float64: the
trait's design ([K, nmax, F] by fold, or [N, F]; on a mesh its sample
rows split over the shards, Design), the coefficients, the
weights and the F x F systems (cuBLAS products, cuSOLVER solves and
inverses on the card). The host sees only the scalars that decide a
branch (a deviance, a max |score|) and the CV sums. Each branch is taken
in the JAX package's order (the penalized deviance with step halving,
L1_RIDGE_TOL on max |score|, the ADAM retry after a failed Newton fit,
the argmin of -logLik/N), so the same ridge parameter is chosen on
either device. K-fold trains on the fold tensor itself, the held-out
fold weighted out, instead of a stacked copy of the training folds.

The Cox level 1 (_level1_t2e) keeps the trait's sample-major [N, F]
design on the device. The risk-set order of each fold's samples is the
host's (survival.SurvivalData: numpy's lexsort, events first within tied
times), uploaded as a permutation. A coordinate sweep of cox_ridge holds
the gradient and Hessian fixed, so it is Gauss-Seidel on a quadratic: one
pass over N forms H = X' diag(hess) X and X' grad on the card, and the
sweep's F sequential updates are one triangular solve of the F x F system
there, the same updates in exact arithmetic with no N-length pass per
coordinate. The host reads three scalars a sweep (the deviance, the
penalized objective and the largest score).
"""

from __future__ import annotations

import math
import time
from typing import List, Optional

import numpy as np
import torch

from ..config import BT, CT, T2E, Params, ridge_h2_grid
from ..parallel import mesh as pm
from ..prep import fmt
from .glm import get_logist_dev_t as logist_dev
from .glm import get_pvec_t as get_pvec
from .step1 import pad_folds
from .survival import SurvivalData, masked_order

L1_RIDGE_EPS = 1e-5
L1_RIDGE_TOL = 1e-4  # l1_ridge_tol (Regenie.hpp:289)


def _wgram(X, w):
    """X' diag(w) X of an [N, F] design."""
    return X.T @ (X * w[:, None])


class Design:
    """A trait's level-1 design, [N, F] by sample or [K, nmax, F] by fold
    (the sample axis nmax), its sample axis zero-padded to the shard count
    of `mesh` (parallel/mesh.py; by default a mesh of X's own device
    alone) and split over the shards (the JAX package's _place_design and
    _dev_ops, regenie_tpu/models/step1_bt.py:63-100). The fits reach the
    design only through these products. Each sum over samples (X'v, X'
    diag(w) X) is taken on every shard and summed in shard order on the
    first shard's device, and each row-wise result (X b, the leverages) is
    gathered there with the pad rows cut; the trait's vectors (y, the
    offsets, the weights) stay whole on that device. A zero pad row adds
    nothing to a sum. On a one-device mesh the one part is X itself and
    each product is X's own."""

    def __init__(self, X, mesh=None):
        self.folds = X.dim() == 3
        self.axis = 1 if self.folds else 0
        self.n, self.F = X.shape[self.axis], X.shape[-1]
        self.dtype, self.device = X.dtype, X.device
        self.mesh = pm.Mesh([X.device]) if mesh is None else mesh
        self.parts = pm.shard(self.mesh, X, self.axis)

    def _each(self, fn, *vecs):
        """fn(shard's rows, that shard's part of each row vector) a shard."""
        split = [pm.shard(self.mesh, v, self.axis) for v in vecs]
        return [fn(x, *(v[i] for v in split)) for i, x in enumerate(self.parts)]

    def _bcast(self, fn, *ops):
        """fn(shard's rows, that shard's copy of each operand) a shard."""
        reps = [pm.replicate(self.mesh, o) for o in ops]
        return [fn(x, *(r[i] for r in reps)) for i, x in enumerate(self.parts)]

    def _rows(self, outs):
        return pm.gather(outs, self.axis, self.n)

    def xb(self, b):
        """X b: [N], or by fold [K, nmax]."""
        return self._rows(self._bcast(lambda x, bs: x @ bs, b))

    def xtv(self, v):
        """X' v [F] of a row vector v ([N], or [K, nmax] over every fold)."""
        def one(x, vs):
            return x.reshape(-1, self.F).T @ vs.reshape(-1) if self.folds else x.T @ vs

        return pm.psum(self._each(one, v))

    def wgram(self, w, folds=None):
        """X' diag(w) X [F, F]; by fold, summed over `folds` in order."""
        def one(x, ws):
            if not self.folds:
                return _wgram(x, ws)
            A = torch.zeros(self.F, self.F, dtype=self.dtype, device=x.device)
            for k in folds:
                A += _wgram(x[k], ws[k])
            return A

        return pm.psum(self._each(one, w))

    def lev(self, Ainv):
        """diag(X Ainv X') [N]."""
        return self._rows(self._bcast(lambda x, A: ((x @ A) * x).sum(dim=1), Ainv))

    def xb_cols(self, sl, b):
        """X[..., sl] @ b: [N] for b [n_sl]; by fold [K, nmax, 1] for b
        [K, n_sl, 1]."""
        return self._rows(self._bcast(lambda x, bs: x[..., sl] @ bs, b))

    def lev_span(self, sl, Ainv):
        """x_n[sl]' Ainv[sl, :] x_n for each sample n: [N]."""
        return self._rows(self._bcast(
            lambda x, A: ((x[:, sl] @ A[sl, :]) * x).sum(dim=1), Ainv))

    def take(self, idx):
        """The rows idx (a device index tensor) of a sample-major design:
        [len(idx), F] on the first shard's device (each shard's hits
        selected on the device, with no wait on the host)."""
        per = self.parts[0].shape[0]
        out = None
        for i, x in enumerate(self.parts):
            rows = x[(idx - i * per).clamp(0, per - 1).to(x.device)].to(self.device)
            out = rows if out is None else torch.where(
                ((idx // per) == i)[:, None], rows, out)
        return out


def _ridge(tau, F, X):
    """The penalty's diagonal matrix: tau a float, or with --select-l0's
    per-column multiplier an [F] tensor."""
    if isinstance(tau, torch.Tensor):
        return torch.diag(tau)
    return torch.diag(torch.full((F,), float(tau), dtype=X.dtype, device=X.device))


def _penalty(mult, X):
    """tau -> the penalty of a ridge parameter: float(tau), or tau times
    --select-l0's per-column multiplier (mult [F], numpy) as a tensor on
    X's device (ridge_param_mult, Step1_Models.cpp:1031-1041, 1719-1745)."""
    if mult is None:
        return float
    m = torch.as_tensor(np.asarray(mult, np.float64), dtype=X.dtype, device=X.device)
    return lambda tau: float(tau) * m


def run_log_ridge(y, X, offset, mask, tau: float, beta0, niter_max: int = 100,
                  niter_line_search: int = 5, numtol: float = 1e-6):
    """Penalized logistic Newton fit with step halving on the penalized
    deviance (run_log_ridge_loocv, Step1_Models.cpp:1288-1377). y, offset
    [N], mask [N] bool, beta0 [F] on the design's device; X an [N, F]
    Design. Returns (beta, pi, w, converged)."""
    maskf = mask.to(X.dtype)
    F = X.F
    beta = beta0.clone()
    pi = get_pvec(offset + X.xb(beta))
    fn_start = float(logist_dev(y, pi, mask) + (tau * beta**2).sum())
    w = torch.where(mask, pi * (1 - pi), 1.0)
    score = X.xtv(torch.where(mask, y - pi, 0.0)) - tau * beta
    dev_conv = False
    fn_end = fn_start
    for _ in range(niter_max):
        A = _ridge(tau, F, X) + X.wgram(maskf * w)
        try:
            step = torch.linalg.solve(A, score)
        except RuntimeError:  # a singular system (torch.linalg.LinAlgError)
            return beta, pi, w, False
        for _ls in range(niter_line_search):
            betanew = beta + step
            pi = get_pvec(offset + X.xb(betanew))
            fn_end = float(logist_dev(y, pi, mask) + (tau * betanew**2).sum())
            w = torch.where(mask, pi * (1 - pi), 1.0)
            if fn_end < fn_start + numtol:
                break
            step = step / 2
        score = X.xtv(torch.where(mask, y - pi, 0.0)) - tau * betanew
        dev_conv = abs(fn_end - fn_start) / (0.01 + abs(fn_end)) < numtol
        if float(score.abs().max()) < L1_RIDGE_TOL:
            return betanew, pi, w, True
        beta = betanew
        fn_start = fn_end
    return beta, pi, w, dev_conv


def run_ct_ridge(y, X, offset, mask, tau: float, beta0, niter_max: int = 100):
    """Penalized Poisson IRLS (run_ct_ridge_loocv, Step1_Models.cpp:1680).
    X an [N, F] Design. Returns (beta, mu, w, converged) with w = mu."""
    maskf = mask.to(X.dtype)
    F = X.F
    beta = beta0.clone()
    mu = None
    for _ in range(niter_max):
        eta = offset + X.xb(beta)
        mu = torch.where(mask, torch.exp(torch.clamp(eta, -30.0, 30.0)), 0.0)
        if bool((mu[mask] == 0).any()):
            return beta, mu, mu, False
        z = torch.where(mask, (eta - offset) + (y - mu) / mu, 0.0)
        A = _ridge(tau, F, X) + X.wgram(maskf * mu)
        try:
            betanew = torch.linalg.solve(A, X.xtv(maskf * mu * z))
        except RuntimeError:
            return beta, mu, mu, False
        eta = offset + X.xb(betanew)
        mu = torch.where(mask, torch.exp(torch.clamp(eta, -30.0, 30.0)), 0.0)
        score = X.xtv(torch.where(mask, y - mu, 0.0)) - tau * betanew
        beta = betanew
        if float(score.abs().max()) < L1_RIDGE_TOL:
            return beta, mu, mu, True
    return beta, mu, mu, False


def adam_log_ridge(y, X, offset, mask, tau: float, beta0, niter: int = 500,
                   alpha: float = 0.01, b1: float = 0.9, b2: float = 0.999,
                   eps: float = 1e-7, tol: float = 1e-4, mini: bool = False,
                   batch_size: int = 128, seed: int = 0):
    """ADAM on the penalized logistic score, the pre-pass and fallback of
    the level-1 ridge (run_log_ridge_loocv_adam, Step1_Models.cpp:1377).
    Full batch by default; `mini` draws `batch_size` analysed rows a step
    from numpy's default_rng(seed) (the JAX package's stream, so both
    packages take the same rows; the reference's --adam-mini,
    adam_batch_size = 128, Regenie.hpp:243), the gradient scaled by the
    batch size and a step-size stopping rule. X an [N, F] Design."""
    beta = beta0.clone()
    mt = torch.zeros_like(beta)
    vt = torch.zeros_like(beta)
    if mini:
        rng = np.random.default_rng(seed)
        rows = np.flatnonzero(mask.cpu().numpy())
        for it in range(1, niter + 1):
            bidx = torch.as_tensor(rows[rng.integers(0, len(rows), size=batch_size)],
                                   device=X.device)
            Xb = X.take(bidx)
            eta = torch.clamp(offset[bidx] + Xb @ beta, -30.0, 30.0)
            pi = 1.0 / (1.0 + torch.exp(-eta))
            grad = (tau * beta - Xb.T @ (y[bidx] - pi)) / batch_size
            mt = b1 * mt + (1 - b1) * grad
            vt = b2 * vt + (1 - b2) * grad**2
            a_t = alpha * math.sqrt(1 - b2**it) / (1 - b1**it)
            step = a_t * mt / (torch.sqrt(vt) + eps)
            if float(step.abs().max()) < tol:
                break
            beta = beta - step
        return beta
    maskf = mask.to(X.dtype)
    for it in range(1, niter + 1):
        eta = torch.clamp(offset + X.xb(beta), -30.0, 30.0)
        pi = 1.0 / (1.0 + torch.exp(-eta))
        grad = -(X.xtv(maskf * (y - pi)) - tau * beta)
        if float(grad.abs().max()) < tol:
            break
        mt = b1 * mt + (1 - b1) * grad
        vt = b2 * vt + (1 - b2) * grad**2
        a_t = alpha * math.sqrt(1 - b2**it) / (1 - b1**it)
        beta = beta - a_t * mt / (torch.sqrt(vt) + eps)
    return beta


def ct_taus(F: int, rate: float, n_ridge_l1: int) -> np.ndarray:
    """Count traits' level-1 penalties K / log(1 + h / (rate (1 - h)))
    (Step1_Models.cpp:2103)."""
    h = ridge_h2_grid(n_ridge_l1)
    return F / np.log1p(h / (rate * (1 - h)))


def level1_nonqt(params: Params, pd, Wph: torch.Tensor, offsets: np.ndarray,
                 taus, ph: int, chr_order, spans, fold_sizes, log,
                 trace: Optional[List] = None, ridge_mult=None, mesh=None):
    """Level-1 ridge of one binary, count or time-to-event trait on the
    device of its level-0 predictions Wph ([K, nmax, F] by fold with
    fold_sizes, else [N, F] for LOOCV; a time-to-event trait's are those
    of its time column, or with --t2e-event-l0 of its event column).
    taus: the level-1 penalties (binary traits; count traits derive
    theirs from the trait's rate, time-to-event traits from the largest
    score or, with --t2e-l1-pi6, from taus). Returns (predictions [N,
    n_chr] numpy float64, converged). trace, if given, gains a dict per
    fitted ridge parameter (fold, tau index, iterations, seconds).
    ridge_mult: [F] --select-l0's per-column penalty multiplier (binary
    and count traits; the Cox level 1 ignores it, as the reference's).
    mesh: the binary and count traits' design rows split over its shards
    (Design); the Cox level 1 stays on Wph's device, as in the JAX
    package."""
    if params.trait_mode == CT:
        return _level1_ct(params, pd, Design(Wph, mesh), offsets, ph, chr_order,
                          spans, fold_sizes, log, trace, ridge_mult)
    if params.trait_mode == T2E:
        if ridge_mult is not None:
            # the reference's Cox level 1 ignores ridge_param_mult (only the
            # column subset from check_l0 applies; Step1_Models.cpp:2228+)
            log("   -note: --select-l0 penalty multipliers are not applied "
                "in the Cox level-1 fit (matches reference behavior)")
        return _level1_t2e(params, pd, Wph, offsets, taus, ph, chr_order, spans,
                           fold_sizes, log, trace)
    if params.trait_mode != BT:
        raise NotImplementedError("level 1 of non-QT traits only")
    X = Design(Wph, mesh)
    if fold_sizes is not None:
        return _level1_glm_kfold(params, pd, X, offsets,
                                 np.asarray(taus, dtype=np.float64), ph, chr_order,
                                 spans, fold_sizes, log, poisson=False, trace=trace,
                                 ridge_mult=ridge_mult)
    return _level1_bt_loocv(params, pd, X, offsets, np.asarray(taus, np.float64),
                            ph, chr_order, spans, log, trace, ridge_mult)


def _trait_vectors(pd, offsets, ph, dev):
    """(y, mask, offset) of a trait as device tensors."""
    def put(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float64), device=dev)

    return (put(pd.phenotypes_raw[:, ph]),
            torch.as_tensor(pd.masked_indivs[:, ph], device=dev),
            put(offsets[:, ph]))


def _loo_quants(X, y, mask, beta, pi, w, tau):
    """The leverage identity's pieces at a fit (ridge_logistic_level_1_loocv,
    Step1_Models.cpp:1238-1262): A^-1 = (X'WX + tau I)^-1, h = diag(X A^-1
    X'), s = (y - pi) / (1 - h w) and X beta."""
    A = _ridge(tau, X.F, X) + X.wgram(mask.to(X.dtype) * w)
    Ainv = torch.linalg.inv(A)
    h = X.lev(Ainv)
    s = (y - pi) / (1.0 - h * w)
    return Ainv, h, s, X.xb(beta)


def _loo_predictions(X, beta, Ainv, s, chr_order, spans):
    """LOCO-ready predictions [N, n_chr] from the LOO pieces
    (make_predictions_binary_loocv, Data.cpp:1484)."""
    out = torch.zeros(X.n, len(chr_order), dtype=X.dtype, device=X.device)
    for ci, c in enumerate(chr_order):
        st, nn = spans[c]
        sl = slice(st, st + nn)
        out[:, ci] = X.xb_cols(sl, beta[sl]) - X.lev_span(sl, Ainv) * s
    return out


def _masked_sums(p1, y, mask, nll):
    """The six CV sums of one ridge parameter over the masked samples, as
    host floats."""
    m = mask
    parts = torch.stack([
        torch.where(m, p1, 0.0).sum(), torch.where(m, y, 0.0).sum(),
        torch.where(m, p1**2, 0.0).sum(), torch.where(m, y**2, 0.0).sum(),
        torch.where(m, p1 * y, 0.0).sum(), torch.where(m, nll, 0.0).sum()])
    return parts.cpu().numpy()


def _level1_bt_loocv(params, pd, X, offsets, taus, ph, chr_order, spans, log,
                     trace, ridge_mult=None):
    """Binary trait, LOOCV (ridge_logistic_level_1_loocv): warm-started
    penalized fits over the tau grid, each scored by its closed-form
    leave-one-out predictions eta_loo = eta - h (y - pi) / (1 - h w)."""
    y, mask, offset = _trait_vectors(pd, offsets, ph, X.device)
    F = X.F
    neff = pd.Neff[ph]
    cumsum = np.zeros((6, len(taus)))
    beta = torch.zeros(F, dtype=X.dtype, device=X.device)
    fit = dict(niter_max=params.niter_max_ridge,
               niter_line_search=params.niter_max_line_search, numtol=params.numtol)
    pen = _penalty(ridge_mult, X)
    for j, tau in enumerate(taus):
        t0 = time.time()
        tau = pen(tau)
        b_start = beta
        if params.use_adam:
            # --use-adam: an ADAM pass before every Newton solve
            # (use_adam, Step1_Models.cpp:1304-1310)
            b_start = adam_log_ridge(y, X, offset, mask, tau, beta,
                                     mini=params.adam_mini, seed=params.seed)
        beta, pi, w, ok = run_log_ridge(y, X, offset, mask, tau, b_start, **fit)
        if not ok:
            # the ADAM fallback, then Newton again
            b_adam = adam_log_ridge(y, X, offset, mask, tau, beta)
            beta, pi, w, ok = run_log_ridge(y, X, offset, mask, tau, b_adam, **fit)
        if not ok:
            log("WARNING: ridge logistic regression did not converge! (Increase --niter)")
            return None, False
        _, h, s, eta_lin = _loo_quants(X, y, mask, beta, pi, w, tau)
        eta_loo = eta_lin - h * s + offset
        p1 = 1.0 - 1.0 / (torch.exp(torch.clamp(eta_loo, -30.0, 30.0)) + 1.0)
        p1 = torch.clamp(p1, L1_RIDGE_EPS, 1 - L1_RIDGE_EPS)
        nll = torch.where(y == 0, -torch.log(1 - p1), -torch.log(p1))
        cumsum[:, j] = _masked_sums(p1, y, mask, nll)
        if trace is not None:
            trace.append(dict(fold=None, tau=j, seconds=time.time() - t0))

    best = int(np.argmin(cumsum[5] / neff))
    _log_bt_tau_table(log, taus, cumsum, best, neff, F)

    # the final fit at the best tau, then the predictions per chromosome
    tau = pen(taus[best])
    beta, pi, w, ok = run_log_ridge(y, X, offset, mask, tau,
                                    torch.zeros_like(beta), **fit)
    if not ok:
        return None, False
    if params.l1_full_samples:
        # --l1-full: the full-sample fit itself, no LOO correction
        log("  * making predictions (using all samples)...")
        pred = torch.stack([X.xb_cols(slice(st, st + nn), beta[st : st + nn])
                            for st, nn in (spans[c] for c in chr_order)], dim=1)
        return pred.cpu().numpy(), True
    Ainv, _, s, _ = _loo_quants(X, y, mask, beta, pi, w, tau)
    return _loo_predictions(X, beta, Ainv, s, chr_order, spans).cpu().numpy(), True


def _level1_glm_kfold(params, pd, Wf, offsets, taus_vec, ph, chr_order, spans,
                      fold_sizes, log, poisson=False, trace=None, ridge_mult=None):
    """K-fold level-1 penalized GLM ridge (ridge_logistic_level_1,
    Step1_Models.cpp:966; ridge_poisson_level_1 :1429): for each
    held-out fold, warm-started IRLS over the tau grid on the other folds,
    the held-out predictions summed into the CV metrics; the folds' betas
    at the best tau make the LOCO predictions. Wf: [K, nmax, F] (pad rows
    zero), a Design."""
    K = params.cv_folds
    dev, dt = Wf.device, Wf.dtype
    F = Wf.F
    N = pd.phenotypes_raw.shape[0]
    bounds = np.concatenate([[0], np.cumsum(fold_sizes)]).astype(int)

    def folds(a):
        return torch.as_tensor(pad_folds(np.asarray(a, np.float64), fold_sizes)[0],
                               device=dev)

    yf = folds(pd.phenotypes_raw[:, ph])
    mf = folds(pd.masked_indivs[:, ph])  # 0 on pad rows
    of = folds(offsets[:, ph])
    neff = pd.Neff[ph]
    n_tau = len(taus_vec)

    def link(eta):
        eta = torch.clamp(eta, -30.0, 30.0)
        if poisson:
            mu = torch.exp(eta)
            return mu, mu
        pi = 1.0 / (1.0 + torch.exp(-eta))
        return pi, pi * (1.0 - pi)

    cumsum = np.zeros((6, n_tau))
    beta_hat = torch.zeros(K, F, n_tau, dtype=dt, device=dev)
    pen = _penalty(ridge_mult, Wf)
    for i in range(K):
        # the training weights: every fold but i (and no pad row)
        mt = mf.clone()
        mt[i] = 0.0
        others = [k for k in range(K) if k != i]
        beta = torch.zeros(F, dtype=dt, device=dev)
        eta = of + Wf.xb(beta)
        for j, tau in enumerate(taus_vec):
            t0 = time.time()
            tau = pen(tau)
            for it in range(1, params.niter_max_ridge + 1):
                mu, w = link(eta)
                z = torch.where(mt > 0, (eta - of) + (yf - mu) / torch.clamp(w, min=1e-12),
                                0.0)
                A = Wf.wgram(w * mt, others) + _ridge(tau, F, Wf)
                try:
                    beta_new = torch.linalg.solve(A, Wf.xtv((w * mt) * z))
                except RuntimeError:
                    log("WARNING: singular system in level-1 K-fold ridge")
                    return None, False
                eta = of + Wf.xb(beta_new)
                mu2, _ = link(eta)
                score = Wf.xtv(mt * (yf - mu2)) - tau * beta_new
                beta = beta_new
                if float(score.abs().max()) < L1_RIDGE_TOL:
                    break
            else:
                log("WARNING: penalized regression did not converge! (Increase --niter)")
                return None, False
            beta_hat[i, :, j] = beta
            if trace is not None:
                trace.append(dict(fold=i, tau=j, iterations=it,
                                  seconds=time.time() - t0))

            # the held-out fold's metrics
            p1, _ = link(eta[i])
            m = mf[i] > 0
            yi = yf[i]
            if poisson:
                nll = -(yi * torch.log(torch.clamp(p1, min=1e-300)) - p1)
            else:
                p1 = torch.clamp(p1, L1_RIDGE_EPS, 1 - L1_RIDGE_EPS)
                nll = torch.where(yi == 0, -torch.log(1 - p1), -torch.log(p1))
            cumsum[:, j] += _masked_sums(p1, yi, m, nll)

    best = int(np.argmin(cumsum[5] / neff))
    if poisson:
        for j in range(n_tau):
            line = f"  tau[{j}] : -logLik/N = {fmt(cumsum[5, j] / neff)}"
            if j == best:
                line += "<- min value"
            log(line)
    else:
        _log_bt_tau_table(log, taus_vec, cumsum, best, neff, F)

    predictions = np.zeros((N, len(chr_order)))
    for ci, c in enumerate(chr_order):
        st, nn = spans[c]
        pc = Wf.xb_cols(slice(st, st + nn), beta_hat[:, st : st + nn, best, None])
        pc = pc[..., 0].cpu().numpy()
        for k in range(K):
            predictions[bounds[k] : bounds[k + 1], ci] = pc[k, : int(fold_sizes[k])]
    return predictions, True


def _log_bt_tau_table(log, taus, cumsum, best, neff, n_feats):
    """CV metric table per ridge parameter (Data::output, Data.cpp:1043-1077)."""
    Sx, Sy, Sx2, Sy2, Sxy, nLL = cumsum
    for j in range(len(taus)):
        h_eff = n_feats / (n_feats + (np.pi**2 / 3) * taus[j])
        rsq_num = Sxy[j] - Sx[j] * Sy[j] / neff
        rsq = rsq_num**2 / ((Sx2[j] - Sx[j] ** 2 / neff) * (Sy2[j] - Sy[j] ** 2 / neff))
        line = (
            f"  {fmt(h_eff):>5} : Rsq = {fmt(rsq)}, MSE = "
            f"{fmt((Sx2[j] + Sy2[j] - 2 * Sxy[j]) / neff)}, -logLik/N = {fmt(nLL[j] / neff)}"
        )
        if j == best:
            line += "<- min value"
        log(line)


def _level1_ct(params, pd, X, offsets, ph, chr_order, spans, fold_sizes, log,
               trace, ridge_mult=None):
    """Count trait: the Poisson ridge, K-fold (ridge_poisson_level_1) or
    LOOCV (ridge_poisson_level_1_loocv, Step1_Models.cpp:1585)."""
    F = X.F
    mask_h = pd.masked_indivs[:, ph]
    rate = pd.phenotypes_raw[mask_h, ph].sum() / pd.Neff[ph]
    taus_ct = ct_taus(F, rate, params.n_ridge_l1)
    if fold_sizes is not None:
        return _level1_glm_kfold(params, pd, X, offsets, taus_ct, ph, chr_order,
                                 spans, fold_sizes, log, poisson=True, trace=trace,
                                 ridge_mult=ridge_mult)
    y, mask, offset = _trait_vectors(pd, offsets, ph, X.device)
    neff = pd.Neff[ph]
    cumsum = np.zeros((6, len(taus_ct)))
    beta = torch.zeros(F, dtype=X.dtype, device=X.device)
    pen = _penalty(ridge_mult, X)
    for j, tau in enumerate(taus_ct):
        t0 = time.time()
        beta, mu, w, ok = run_ct_ridge(y, X, offset, mask, pen(tau), beta,
                                       params.niter_max_ridge)
        if not ok:
            log("WARNING: ridge poisson regression did not converge! (Increase --niter)")
            return None, False
        _, h, s, eta_lin = _loo_quants(X, y, mask, beta, mu, w, pen(tau))
        p1 = torch.exp(torch.clamp(eta_lin - h * s + offset, -30.0, 30.0))
        nll = -(y * torch.log(torch.clamp(p1, min=1e-300)) - p1)
        cumsum[:, j] = _masked_sums(p1, y, mask, nll)
        if trace is not None:
            trace.append(dict(fold=None, tau=j, seconds=time.time() - t0))

    best = int(np.argmin(cumsum[5] / neff))
    for j in range(len(taus_ct)):
        zv = np.exp(F / taus_ct[j]) - 1
        h_eff = rate * zv / (1 + rate * zv)
        line = f"  {fmt(h_eff):>5} : -logLik/N = {fmt(cumsum[5, j] / neff)}"
        if j == best:
            line += "<- min value"
        log(line)

    tau = pen(taus_ct[best])
    beta, mu, w, ok = run_ct_ridge(y, X, offset, mask, tau, torch.zeros_like(beta),
                                   params.niter_max_ridge)
    if not ok:
        return None, False
    Ainv, _, s, _ = _loo_quants(X, y, mask, beta, mu, w, tau)
    return _loo_predictions(X, beta, Ainv, s, chr_order, spans).cpu().numpy(), True


class _CoxRisk:
    """A fold's risk-set structure (survival.SurvivalData, set up on the
    host) as device tensors: the permutation into time order and back,
    the ordered weights, event flags, tie weights and first-of-tie flags,
    the weights in sample order, and the saturated log-likelihood."""

    def __init__(self, time_, status, mask, dev, base=None):
        """base: np.lexsort((-status, time_)) over every sample, shared by
        the masks of one endpoint (survival.masked_order)."""
        sd = SurvivalData()
        sd.setup(time_, status, mask, norm_weights=True,
                 order=None if base is None else masked_order(base, mask))

        def put(a):
            return torch.as_tensor(np.ascontiguousarray(a), device=dev)

        inv = np.empty_like(sd.order)
        inv[sd.order] = np.arange(len(sd.order))
        self.order = put(sd.order)
        self.inv = put(inv)
        self.w, self.w_orig = put(sd.w), put(sd.w_orig)
        self.ev = put((sd.status_order == 1).astype(np.float64))
        self.keep = put(sd.keep_order)
        self.ww = put(sd.ww)
        self.first = put(sd.dd > 0)
        self.w_sum = float(sd.w_orig.sum())
        w_sub = sd.ww_k
        self.lsat = float(-(w_sub * np.log(np.maximum(w_sub, 1e-300))).sum())


def _rev_cumsum(x):
    return torch.flip(torch.cumsum(torch.flip(x, (0,)), 0), (0,))


def _cox_deviance(rk: _CoxRisk, eta):
    """CoxRidge._deviance of the linear predictor eta [N] (sample order),
    a 0-d tensor: 2 (saturated - partial log-likelihood), Breslow ties."""
    eta_o = eta[rk.order]
    rsk = _rev_cumsum(rk.w * torch.exp(eta_o))
    logs = torch.where(rk.keep & rk.first,
                       rk.ww * torch.log(torch.clamp(rsk, min=1e-300)), 0.0)
    return 2.0 * (rk.lsat - ((rk.w * eta_o * rk.ev).sum() - logs.sum()))


def _cox_grad(rk: _CoxRisk, eta):
    """CoxRidge._grad: the partial log-likelihood's gradient and diagonal
    Hessian per sample [N] (sample order) at eta."""
    mean_eta = (eta * rk.w_orig).sum() / rk.w_sum
    e = torch.exp(eta[rk.order] - mean_eta)
    rskden = _rev_cumsum(rk.w * e)
    pos = rk.first & (rskden > 0)
    rinv = torch.cumsum(torch.where(pos, rk.ww / rskden, 0.0), 0)
    rinv2 = torch.cumsum(torch.where(pos, rk.ww / rskden**2, 0.0), 0)
    we = rk.w * e
    grad = rk.w * (rk.ev - e * rinv)
    hess = we**2 * rinv2 - we * rinv
    return grad[rk.inv], hess[rk.inv]


def _weighted_gram(X, h, rows=65536):
    """X' diag(h) X of an [N, F] design, summed over row slices so that
    the scaled copy stays small."""
    F = X.shape[1]
    H = torch.zeros(F, F, dtype=X.dtype, device=X.device)
    for a in range(0, X.shape[0], rows):
        Xa = X[a : a + rows]
        H += Xa.T @ (Xa * h[a : a + rows, None])
    return H


def cox_sweep(X, grad, hess, beta, lam):
    """One cyclic coordinate-descent sweep of cox_ridge (survival.py's
    CoxRidge.fit inner loop) at the sweep's fixed gradient and Hessian:
    coordinate k moves beta_k to (r . x_k + beta_k x_k' H x_k) / (x_k' H x_k
    - lam), r the Hessian-weighted working residual at the coordinates
    already moved. With H = X' diag(hess) X and c = X' grad (over the
    samples of nonzero Hessian), the moves d solve the lower-triangular
    system (tril(H) - lam I) d = lam beta - c. Returns the new beta."""
    F = X.shape[1]
    if F == 0:
        return beta
    H = _weighted_gram(X, hess)
    c = X.T @ torch.where(hess != 0, grad, 0.0)
    A = torch.tril(H) - lam * torch.eye(F, dtype=X.dtype, device=X.device)
    d = torch.linalg.solve_triangular(A, (lam * beta - c)[:, None], upper=False)
    return beta + d[:, 0]


def cox_ridge_fit(rk: _CoxRisk, X, offset, maskf, lam, beta0, niter=100,
                  mxitnr=30, tol=1e-6):
    """CoxRidge.fit on the device: sweeps (cox_sweep) until the relative
    change of the penalized deviance or the largest penalized score falls
    under tol, halving a step that raises the deviance by more than tol.
    maskf [N] float64 (1 = in the fit). Returns (beta, converged,
    sweeps)."""
    beta = beta0.clone()
    F = X.shape[1]

    def lin(b):
        return maskf * (X @ b + offset)

    eta = lin(beta)
    last_d = float(_cox_deviance(rk, eta))
    last_o = last_d + lam * float((beta**2).sum()) / 2
    for t in range(1, niter + 1):
        beta_old = beta
        grad, hess = _cox_grad(rk, eta)
        beta = cox_sweep(X, grad, hess, beta, lam)
        eta = lin(beta)
        d = _cox_deviance(rk, eta)
        o = d + lam * (beta**2).sum() / 2
        score = ((_cox_grad(rk, eta)[0] @ X - lam * beta).abs().max() if F
                 else torch.zeros((), dtype=X.dtype, device=X.device))
        d, o, score_max = torch.stack([d, o, score]).tolist()
        if d - last_d > tol:
            ii = 0
            while d - last_d > tol:
                ii += 1
                if ii > mxitnr:
                    return beta, False, t
                beta = (beta + beta_old) / 2
                eta = lin(beta)
                d = float(_cox_deviance(rk, eta))
                o = d + lam * float((beta**2).sum()) / 2
            score_max = (float((_cox_grad(rk, eta)[0] @ X - lam * beta).abs().max())
                         if F else 0.0)
        conv = abs(o - last_o) / (0.1 + abs(o)) < tol or score_max < tol
        last_d, last_o = d, o
        if conv:
            return beta, True, t
    return beta, False, niter


def _level1_t2e(params, pd, Wl0, offsets, taus, ph, chr_order, spans,
                fold_sizes, log, trace):
    """Time-to-event trait, K-fold (ridge_cox_level_1,
    Step1_Models.cpp:2228): the penalty path from the largest score down
    by 1e-6 (getCoxLambdaMax, :446; --t2e-l1-pi6: taus x 6 / pi^2,
    :2106-2110), per held-out fold warm-started Cox ridge fits on the
    other folds along the path, each scored by its deviance on the
    held-out fold; the folds' betas at the path's least summed deviance
    make the predictions. Wl0: the level-0 predictions [K, nmax, F] of
    the time column (or with --t2e-event-l0 the event column)."""
    if fold_sizes is None:
        raise IndexError("--t2e runs its level 1 K-fold only (no --loocv)")
    dev, dt = Wl0.device, Wl0.dtype
    ename = params.t2e_map[pd.pheno_names[ph]]
    ei = pd.pheno_names.index(ename)
    time_ = pd.phenotypes_raw[:, ph]
    status = pd.phenotypes_raw[:, ei]
    mask = pd.masked_indivs[:, ph]
    K = params.cv_folds
    ntau = params.n_ridge_l1
    bounds = np.concatenate([[0], np.cumsum(fold_sizes)]).astype(int)
    X = torch.cat([Wl0[k, : int(fold_sizes[k])] for k in range(K)], dim=0)
    N, F = X.shape
    offset = torch.as_tensor(np.ascontiguousarray(offsets[:, ph], np.float64),
                             device=dev)
    maskf_h = mask.astype(np.float64)
    # the time order of every sample, from which each fold's risk sets
    # gather theirs
    base = np.lexsort((-status, time_))

    if params.t2e_l1_pi6:
        taus_t2e = np.asarray(taus, dtype=np.float64) * 6.0 / (np.pi**2)
    else:
        rk = _CoxRisk(time_, status, mask, dev, base)
        grad, _ = _cox_grad(rk, torch.as_tensor(maskf_h, device=dev) * offset)
        lambda_max = float((X.T @ grad).abs().max()) / 1e-3
        idx = np.arange(ntau, dtype=np.float64)
        taus_t2e = np.exp(idx / (ntau - 1) * np.log(1e-6) + np.log(lambda_max))

    fold_id = np.zeros(N, dtype=int)
    for k in range(K):
        fold_id[bounds[k] : bounds[k + 1]] = k
    devs = np.zeros(ntau)
    beta_folds = torch.zeros(K, ntau, F, dtype=dt, device=dev)
    not_conv = False
    for k in range(K):
        train = (fold_id != k) & mask
        test = (fold_id == k) & mask
        rk_tr = _CoxRisk(time_, status, train, dev, base)
        rk_te = _CoxRisk(time_, status, test, dev, base)
        m_tr = torch.as_tensor(train.astype(np.float64), device=dev)
        m_te = torch.as_tensor(test.astype(np.float64), device=dev)
        beta = torch.zeros(F, dtype=dt, device=dev)
        for j, tau in enumerate(taus_t2e):  # the path, warm-started
            t0 = time.time()
            beta, ok, sweeps = cox_ridge_fit(
                rk_tr, X, offset, m_tr, float(tau), beta, params.niter_max_ridge,
                params.niter_max_line_search, 1e-4)
            not_conv |= not ok
            beta_folds[k, j] = beta
            devs[j] += float(_cox_deviance(rk_te, m_te * (X @ beta + offset)))
            if trace is not None:
                trace.append(dict(fold=k, tau=j, iterations=sweeps,
                                  seconds=time.time() - t0))

    if not_conv:
        log("WARNING: Cox ridge did not fully converge across folds")
    best = int(np.argmin(devs))
    for j in range(ntau):
        line = f"  {fmt(taus_t2e[j]):>9} : Deviance = {fmt(devs[j])}"
        if j == best:
            line += "<- min value"
        log(line)

    predictions = np.zeros((N, len(chr_order)))
    for ci, c in enumerate(chr_order):
        st, nn = spans[c]
        for k in range(K):
            rows = slice(bounds[k], bounds[k + 1])
            predictions[rows, ci] = (X[rows, st : st + nn]
                                     @ beta_folds[k, best, st : st + nn]).cpu().numpy()
    return predictions, True
