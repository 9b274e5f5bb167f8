"""Firth and SPA correction solvers on the device, in torch (the port's
copy of regenie_tpu/models/corrections_device.py).

Device twins of the host float64 batched solvers in models/firth.py and
models/spa.py (the parity references, byte-exact against the reference's
per-SNP loops fit_firth Step2_Models.cpp:1649 and run_SPA_test_snp
:2072). They keep the [S, N] residualized genotype rows of the corrected
SNPs on the device and run the Newton / Newton-bisection iterations with
one active mask a row: each of the JAX package's `lax.while_loop`s is a
Python loop that stops when no row is active or at the iteration cap,
each `lax.cond` an `if` on any row needing the branch.

Numerical design, as in the JAX package (the port runs it in float64):
  * The penalized deviance is never formed absolutely: the solver tracks
    drel(b) = dev(b) - dev(0), whose per-sample terms
      2*[log1p(pi0_i * expm1(g_i b)) - y_i g_i b]
    are each O(|g_i b|), so rounding scales with the LRT itself. LRT =
    -drel(b_final).
  * Convergence tolerances get a noise floor 32*eps*sum|terms|.
  * The CGF terms of SPA are in the stable log form (logaddexp), and the
    host twin's overflow failure rule (MAX_EXP_LIM = 708 in _K2) is kept
    with the same threshold, so the fail flags match the host's.
  * SPA tail probabilities are taken in log space (log_ndtr).
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

CORR_ENV = "REGENIE_TPU_DEVICE_CORR"


def enabled(device) -> bool:
    """Whether the corrections run on the device: by default off the CPU
    (on CUDA); REGENIE_TPU_DEVICE_CORR=1 asks for these solvers on any
    device, 0 for the host twins."""
    env = os.environ.get(CORR_ENV)
    if env is not None:
        return env != "0"
    return torch.device(device).type != "cpu"


def _as_dev(x, device, dt):
    """A tensor on `device` in `dt` (no copy for one there already)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dt)
    return torch.as_tensor(np.asarray(x), dtype=dt, device=device)


# ---------------------------------------------------------------------
# Firth single-parameter LRT (device twin of firth.firth_snp_batch)
# ---------------------------------------------------------------------


def _drel_at(b, Gm, y, pi0, logpi0c, r1):
    """drel(b) = 2nll(b) - 2nll(0) per SNP, in delta space. Gm rows are
    mask-zeroed, so masked samples add exactly 0. Above d = 20 the terms
    switch to d + log(pi0) + log1p((1-pi0)e^-d/pi0), away from expm1's
    overflow."""
    d = Gm * b[:, None]
    big = d > 20.0
    t_small = torch.log1p(pi0[None, :] * torch.expm1(torch.clamp(d, max=21.0)))
    t_big = d + logpi0c[None, :] + torch.log1p(
        r1[None, :] * torch.exp(-torch.clamp(d, min=0.0)))
    t = torch.where(big, t_big, t_small)
    return 2.0 * (t - y[None, :] * d).sum(dim=1)


def _firth_kernel(Gm, y, offset, tol, maxstep, niter, nls):
    """Batched masked single-parameter Firth Newton with step-halving.
    Gm: [S, N] mask-zeroed genotype rows on the X scale; y: [N] 0/1
    (mask-zeroed); offset: [N]. Returns (beta, xtwx_final, lrt, conv)."""
    dt = Gm.dtype
    eps = torch.finfo(dt).eps
    eta0 = torch.clamp(offset, -30.0, 30.0)
    pi0 = torch.sigmoid(eta0)
    pi0c = torch.clamp(pi0, min=1e-38)
    logpi0c = torch.log(pi0c)
    r1 = (1.0 - pi0) / pi0c
    G2 = Gm * Gm
    xtwx0 = G2 @ (pi0 * (1.0 - pi0))
    log_xtwx0 = torch.log(torch.clamp(xtwx0, min=1e-30))
    S = Gm.shape[0]

    def w_at(b):
        pi = torch.sigmoid(torch.clamp(offset[None, :] + Gm * b[:, None],
                                       -30.0, 30.0))
        return pi * (1.0 - pi)

    def drel_pen(b):
        # penalized: drel less the change of log x'Wx from beta = 0
        return _drel_at(b, Gm, y, pi0, logpi0c, r1) - (
            torch.log(torch.clamp((G2 * w_at(b)).sum(dim=1), min=1e-30))
            - log_xtwx0)

    beta = torch.zeros(S, dtype=dt, device=Gm.device)
    drel = torch.zeros(S, dtype=dt, device=Gm.device)
    active = xtwx0 > 0
    conv = torch.zeros(S, dtype=torch.bool, device=Gm.device)
    it = 0
    while it < niter and bool(active.any()):
        it += 1
        pi = torch.sigmoid(torch.clamp(offset[None, :] + Gm * beta[:, None],
                                       -30.0, 30.0))
        w = pi * (1.0 - pi)
        xtwx = (G2 * w).sum(dim=1)
        h = G2 * w / torch.clamp(xtwx, min=1e-30)[:, None]
        sterm = Gm * (y[None, :] - pi) + Gm * h * (0.5 - pi)
        ms = sterm.sum(dim=1)
        tol_eff = torch.clamp(32.0 * eps * sterm.abs().sum(dim=1), min=tol)
        done = (ms.abs() < tol_eff) & (it >= 2) & active
        conv = conv | done
        active = active & ~done

        step = ms / torch.clamp(xtwx, min=1e-30)
        mx = step.abs() / maxstep
        step = torch.where(mx > 1.0, step / torch.where(mx > 1.0, mx, 1.0), step)

        beta_try, drel_try, improved = beta, drel, ~active
        for ls in range(nls):
            cand = torch.where(active & ~improved, beta + step / (2.0**ls),
                               beta_try)
            drel_c = drel_pen(cand)
            better = active & ~improved & (drel_c < drel)
            beta_try = torch.where(better, cand, beta_try)
            drel_try = torch.where(better, drel_c, drel_try)
            improved = improved | better

        fail_ls = active & ~improved
        if bool(fail_ls.any()):
            # the reference nudges the step by 1e-6 when halving fails
            cand = beta + step / (2.0 ** (nls - 1)) + 1e-6
            drel_c = drel_pen(cand)
            beta_try = torch.where(fail_ls, cand, beta_try)
            drel_try = torch.where(fail_ls, drel_c, drel_try)

        beta = torch.where(active, beta_try, beta)
        drel = torch.where(active, drel_try, drel)

    # xtwx at the FINAL beta (the numpy twin's line-search-cached value)
    xtwx_f = (G2 * w_at(beta)).sum(dim=1)
    lrt = -drel
    return beta, xtwx_f, lrt, conv & (lrt >= 0)


def firth_snp_batch_dev(y, Gv, offset, mask, maxstep=5, niter=250,
                        tol=2.5e-4, niter_line_search=5, device=None,
                        dtype=torch.float64):
    """Device twin of firth.firth_snp_batch, the same signature and
    return (beta [S], se [S], lrt [S], converged [S] as numpy arrays). Gv
    may be a tensor (kept on its device) or numpy (sent to `device`)."""
    if device is None:
        device = Gv.device if isinstance(Gv, torch.Tensor) else "cpu"
    maskf = _as_dev(mask, device, dtype)
    Gm = _as_dev(Gv, device, dtype) * maskf[None, :]
    beta, xtwx, lrt, conv = _firth_kernel(
        Gm, _as_dev(y, device, dtype) * maskf, _as_dev(offset, device, dtype),
        tol, float(maxstep), int(niter), int(niter_line_search))
    # one device -> host copy
    packed = torch.stack([beta, xtwx, lrt, conv.to(dtype)]).cpu().numpy()
    packed = packed.astype(np.float64)
    beta, xtwx, lrt = packed[0], packed[1], packed[2]
    se = np.sqrt(1.0 / np.maximum(xtwx, 1e-300))
    return beta, se, lrt, packed[3] != 0.0


# ---------------------------------------------------------------------
# SPA (device twin of spa.spa_batch)
# ---------------------------------------------------------------------

_OVER_LIM = 708.0  # the host twin's MAX_EXP_LIM


def _K_dev(t, Gmod, lphat, l1mphat, val_a, val_c):
    # log(1 - phat + phat e^arg) = logaddexp(log1p(-phat), log(phat)+arg)
    arg = t[:, None] / val_c[:, None] * Gmod
    val = torch.logaddexp(l1mphat[None, :], lphat[None, :] + arg).sum(dim=1)
    return val - t * val_a / val_c


def _K1_dev(t, Gmod, lphat, l1mphat, val_a, val_c):
    # term = Gmod/val_c * exp(log(phat) - log(phat + (1-phat) e^arg))
    arg = -t[:, None] / val_c[:, None] * Gmod
    L = torch.logaddexp(lphat[None, :], l1mphat[None, :] + arg)
    term = (Gmod / val_c[:, None]) * torch.exp(lphat[None, :] - L)
    return term.sum(dim=1) - val_a / val_c, term.abs().sum(dim=1)


def _K2_dev(t, Gmod, lphat, l1mphat, gamma2, val_c):
    # summand = Gmod^2 gamma^2 / c^2 * exp(arg - 2 log(phat + (1-phat)e^arg))
    arg = -t[:, None] / val_c[:, None] * Gmod
    over = ((arg > _OVER_LIM) & (Gmod != 0)).any(dim=1)
    L = torch.logaddexp(lphat[None, :], l1mphat[None, :] + arg)
    val = (Gmod**2 * gamma2[None, :] / val_c[:, None] ** 2
           * torch.exp(arg - 2.0 * L)).sum(dim=1)
    return torch.where(over, 0.0, val)


def _spa_kernel(Gmod, stats, denum, phat, gamma2, tol, niter_max):
    """Vectorized SPA correction. Gmod: [S, N] mask-zeroed Gres /
    gamma_sqrt rows; returns (neglog10p [S], fail [S])."""
    dt, dev = Gmod.dtype, Gmod.device
    eps = torch.finfo(dt).eps
    big = torch.finfo(dt).max
    val_c = torch.sqrt(denum)
    val_a = (Gmod * phat[None, :]).sum(dim=1)
    score_num = stats * val_c
    limK1_low = torch.where(Gmod < 0, Gmod, 0.0).sum(dim=1) - val_a
    limK1_high = torch.where(Gmod > 0, Gmod, 0.0).sum(dim=1) - val_a
    fail = (score_num < limK1_low) | (score_num > limK1_high)
    tval = -stats.abs()
    S = Gmod.shape[0]
    lphat = torch.log(phat)
    l1mphat = torch.log1p(-phat)

    def K1(t, lam):
        f, sa = _K1_dev(lam * t, Gmod, lphat, l1mphat, val_a, val_c)
        return lam * f - tval, sa

    def solve(lam):
        """Roots of lam*K1(lam*t) = tval (solve_K1_snp,
        Step2_Models.cpp:2146): Newton, bisection when a step leaves the
        bracket. Returns (root [S], ok [S])."""
        zero, huge = torch.zeros_like(tval), torch.full_like(tval, big)
        min_x = torch.where(tval >= 0, zero, -huge)
        max_x = torch.where(tval >= 0, huge, zero)
        t_old = torch.zeros(S, dtype=dt, device=dev)
        f_old, _ = K1(t_old, lam)
        active = torch.ones(S, dtype=torch.bool, device=dev)
        ok = torch.zeros(S, dtype=torch.bool, device=dev)
        t_new = torch.full((S,), -1.0, dtype=dt, device=dev)
        it = 0
        while bool(active.any()) and it < niter_max:
            it += 1
            hess = _K2_dev(lam * t_old, Gmod, lphat, l1mphat, gamma2, val_c)
            active = active & ~(hess == 0)
            cand = t_old - f_old / torch.where(hess == 0, 1.0, hess)
            cand = torch.where(active, cand, t_old)
            f_new, sa = K1(cand, lam)
            tol_eff = torch.clamp(32.0 * eps * sa, min=tol)
            done = active & (f_new.abs() < tol_eff)
            t_new = torch.where(active, cand, t_new)
            ok = ok | done
            active2 = active & ~done

            in_b = (cand != 0) & (cand > min_x) & (cand < max_x)
            max_x = torch.where(active2 & in_b & (f_new > 0), cand, max_x)
            min_x = torch.where(active2 & in_b & (f_new <= 0), cand, min_x)
            bis = active2 & ~in_b
            if bool(bis.any()):
                cand_b = (min_x + max_x) / 2
                f_b, _ = K1(cand_b, lam)
                cand = torch.where(bis, cand_b, cand)
                f_new = torch.where(bis, f_b, f_new)
                min_x = torch.where(bis & (f_b <= 0), cand_b, min_x)
                max_x = torch.where(bis & (f_b > 0), cand_b, max_x)

            t_old = torch.where(active2, cand, t_old)
            f_old = torch.where(active2, f_new, f_old)
            active = active2
        return t_new, ok

    def log_tail(root, lam):
        """log of the one-sided tail probability at the root (the
        log-space twin of get_SPA_pvalue_snp, Step2_Models.cpp:2274)."""
        kval = _K_dev(lam * root, Gmod, lphat, l1mphat, val_a, val_c)
        k2val = _K2_dev(lam * root, Gmod, lphat, l1mphat, gamma2, val_c)
        wval = torch.sign(root) * torch.sqrt(
            torch.clamp(2.0 * (root * tval - kval), min=0.0))
        vval = root * torch.sqrt(k2val)
        wsafe = torch.where(wval == 0, 1.0, wval)
        rval = wval + torch.log((vval / wsafe).abs()) / wsafe
        logpv = torch.where(vval == 0, math.log(0.5),
                            torch.special.log_ndtr(rval))
        return logpv, k2val != 0

    # lam = +1 and lam = -1 tails
    r1, ok1 = solve(1.0)
    r2, ok2 = solve(-1.0)
    lp1, okt1 = log_tail(r1, 1.0)
    lp2, okt2 = log_tail(r2, -1.0)
    log_pv = torch.logaddexp(lp1, lp2)
    fail = fail | ~ok1 | ~ok2 | ~okt1 | ~okt2 | (log_pv > 0)
    log_pv = torch.clamp(log_pv, max=0.0)
    neglog10p = torch.clamp(-log_pv / math.log(10.0), max=323.306)
    return neglog10p, fail


def spa_batch_dev(stats, denum, Gres, phat, gamma_sqrt, mask, tol=5e-5,
                  niter_max=1000, device=None, dtype=torch.float64):
    """Device twin of spa.spa_batch, the same signature and return
    (chisq [S], neglog10p [S], test_fail [S] as numpy). Gres may be a
    tensor (kept on its device); the chisq inversion of the [S] p-values
    runs on the host."""
    from ..utils.stats import neglog10_to_chisq

    if device is None:
        device = Gres.device if isinstance(Gres, torch.Tensor) else "cpu"
    maskf = _as_dev(mask, device, dtype)
    gs = _as_dev(gamma_sqrt, device, dtype)
    Gmod = _as_dev(Gres, device, dtype) / gs[None, :] * maskf[None, :]
    logp, fail = _spa_kernel(
        Gmod, _as_dev(stats, device, dtype), _as_dev(denum, device, dtype),
        _as_dev(phat, device, dtype) * maskf, gs * gs, tol, int(niter_max))
    packed = torch.stack([logp, fail.to(dtype)]).cpu().numpy().astype(np.float64)
    logp = packed[0]
    return neglog10_to_chisq(logp), logp, packed[1] != 0.0


# ---------------------------------------------------------------------
# exact Firth (device twin of step2_bt._exact_firth_snp)
# ---------------------------------------------------------------------


def _firth_multi_batch(y, X, XX, G, offset, mask, beta0, ci, maxstep, niter,
                       tol, nls, comp_lrt):
    """firth.fit_firth_multi on S rows at once, each with the design
    [X | g_s] (the K covariate columns shared, only the SNP column its
    own): Newton on the modified score of the first `ci` coefficients
    with step halving on the penalized deviance; the penalty's
    determinant over all K + 1 columns. Every row stops on its own
    iteration (an active mask), as the host fit would stop on it.
    X [N, K]; XX [N, K*K] the products x_n x_n' flattened; G [S, N];
    beta0 [S, K+1]. Returns (beta, se, dev, dev0, converged) [S]-first;
    dev0 is the penalized deviance at the start (the null deviance of
    the LRT when comp_lrt)."""
    from .glm import get_logist_dev_t, get_pvec_t

    S, N = G.shape
    K = X.shape[1]
    dt, dev = G.dtype, G.device
    maskf = mask.to(dt)

    def system(beta):
        """pi, w and X~'WX~ [S, K+1, K+1] at beta, and the penalized deviance."""
        eta = offset[None, :] + beta[:, :K] @ X.T + G * beta[:, K:]
        pi = get_pvec_t(eta)
        w = torch.where(mask[None, :], pi * (1 - pi), 1.0)
        wm = w * maskf[None, :]
        M = torch.empty(S, K + 1, K + 1, dtype=dt, device=dev)
        M[:, :K, :K] = (wm @ XX).view(S, K, K)
        xg = (wm * G) @ X
        M[:, :K, K] = xg
        M[:, K, :K] = xg
        M[:, K, K] = (wm * G * G).sum(dim=1)
        _, logdet = torch.linalg.slogdet(M)
        return pi, w, M, get_logist_dev_t(y, pi, mask) - logdet

    beta = beta0.clone()
    se = torch.zeros(S, K + 1, dtype=dt, device=dev)
    dev_cur = torch.zeros(S, dtype=dt, device=dev)
    dev0 = None
    active = torch.ones(S, dtype=torch.bool, device=dev)
    conv = torch.zeros(S, dtype=torch.bool, device=dev)
    it = 0
    while it < niter and bool(active.any()):
        it += 1
        pi, w, M, dev_old = system(beta)
        dev_cur = torch.where(active, dev_old, dev_cur)
        if comp_lrt and dev0 is None:
            dev0 = dev_old
        Minv, info = torch.linalg.inv_ex(M)
        # the hat diagonal h_n = w_n m_n x~_n' M^-1 x~_n, the covariate
        # block through the flattened products
        q = (Minv[:, :K, :K].reshape(S, K * K) @ XX.T
             + 2.0 * G * (Minv[:, :K, K] @ X.T) + G * G * Minv[:, K, K][:, None])
        h = w * maskf[None, :] * q
        resid = torch.where(mask[None, :], y[None, :] - pi + h * (0.5 - pi), 0.0)
        score = torch.cat([resid @ X, (G * resid).sum(dim=1, keepdim=True)], dim=1)[:, :ci]
        step, info2 = torch.linalg.solve_ex(M[:, :ci, :ci], score)
        bad = active & ((info != 0) | (info2 != 0))
        active = active & ~bad
        done = active & (score.abs().amax(dim=1) < tol) & (it >= 2)
        if bool(done.any()):
            se_d = torch.sqrt(torch.diagonal(torch.linalg.pinv(M, rtol=1e-15),
                                             dim1=1, dim2=2).abs())
            se = torch.where(done[:, None], se_d, se)
        conv = conv | done
        active = active & ~done
        if not bool(active.any()):
            break

        mx = step.abs().amax(dim=1) / maxstep
        step = torch.where((mx > 1)[:, None], step / torch.where(mx > 1, mx, 1.0)[:, None],
                           step)
        pending = active.clone()
        beta_new = beta.clone()
        for ls in range(nls):
            if ls > 0:
                step = torch.where(pending[:, None], step / 2, step)
            cand = beta.clone()
            cand[:, :ci] = beta[:, :ci] + step
            dev_new = system(cand)[3]
            better = pending & (dev_new < dev_old)
            beta_new = torch.where(better[:, None], cand, beta_new)
            pending = pending & ~better
            if not bool(pending.any()):
                break
        if bool(pending.any()):
            if comp_lrt:
                # the reference nudges the step by 1e-6 when halving fails
                nudged = beta.clone()
                nudged[:, :ci] = beta[:, :ci] + step + 1e-6
                beta_new = torch.where(pending[:, None], nudged, beta_new)
            else:
                active = active & ~pending
        beta = torch.where(active[:, None], beta_new, beta)
    if dev0 is None:
        dev0 = dev_cur
    return beta, se, dev_cur, dev0, conv


def exact_firth_batch_dev(y, X, G, offset, mask, bhat_start, maxstep_null=25,
                          niter_null=1000, tol_null=1e-5, maxstep=5, niter=250,
                          tol=2.5e-4, niter_line_search=5):
    """Exact Firth LRTs of S rows at once (the device twin of
    step2_bt._exact_firth_snp): the penalized null with the SNP's
    coefficient held at 0 from the null logistic fit bhat_start, then the
    full fit from it with the LRT against the null deviance. y, offset,
    mask [N]; X [N, K] the covariates; G [S, N] the rows' genotypes,
    all float64 tensors on one device (mask bool). Returns (converged,
    beta, se, lrt) as numpy [S], the SNP's coefficient and its SE."""
    S = G.shape[0]
    K = X.shape[1]
    maskb = mask.to(torch.bool)
    XX = (X[:, :, None] * X[:, None, :]).reshape(X.shape[0], K * K)
    b0 = torch.zeros(S, K + 1, dtype=G.dtype, device=G.device)
    b0[:, :K] = bhat_start[None, :]
    bn, _, _, _, ok1 = _firth_multi_batch(y, X, XX, G, offset, maskb, b0, K,
                                          float(maxstep_null), int(niter_null),
                                          tol_null, niter_line_search, False)
    bf, se, dev_full, dev0, ok2 = _firth_multi_batch(
        y, X, XX, G, offset, maskb, bn, K + 1, float(maxstep), int(niter), tol,
        niter_line_search, True)
    lrt = dev0 - dev_full
    ok = ok1 & ok2 & (lrt >= 0)
    packed = torch.stack([ok.to(G.dtype), bf[:, K], se[:, K], lrt]).cpu().numpy()
    ok = packed[0] != 0.0
    return (ok, np.where(ok, packed[1], 0.0), np.where(ok, packed[2], 0.0),
            np.where(ok, packed[3], 0.0))


def exact_firth_rows(total_rows: int, N: int, K: int, device) -> int:
    """Rows of one exact-Firth group: as many as a quarter of the card's
    free memory holds at ~24 [N] float64 temporaries a row (the fits'
    [S, N] tensors and the [N, S] hat products), at least 1; 64 on the
    CPU."""
    if torch.device(device).type != "cuda":
        return min(total_rows, 64)
    free, _ = torch.cuda.mem_get_info(torch.device(device))
    per_row = (24 + K) * N * 8
    return max(1, min(total_rows, int(free // 4 // per_row)))
