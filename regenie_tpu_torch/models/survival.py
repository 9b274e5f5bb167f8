"""Time-to-event (Cox proportional hazards) fits on the host, in numpy
float64 (the port's own copy of regenie_tpu/models/survival.py, line for
line, so that both packages' host fits agree bit for bit).

Re-implements the reference's survival stack:
- survival_data (survival_data.cpp): time ordering, Breslow tie
  handling, risk-set structure. The n x K sparse R matrix becomes a
  per-sample `group` index + segment cumsums.
- cox_mle (cox_score.cpp): null partial-likelihood IRLS + score-test
  preparation (X1_X1WX1inv, residuals, exact-variance pieces).
- cox_firth (cox_firth.cpp): Firth-penalized Cox, full multi-parameter
  Newton (fit) and fast single-parameter path (fit_1).
- cox_ridge (cox_ridge.cpp): penalized Cox via coordinate descent (Step
  2's null start; Step 1's null offsets). Step 1's level-1 ridge runs the
  same sweep in torch on the card (models/step1_bt.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def _cumsum_rev(x):
    return np.cumsum(x[::-1])[::-1]


@dataclass
class SurvivalData:
    """Ordered survival data (reference survival_data.cpp)."""

    n: int = 0
    neff: int = 0
    n_events: int = 0
    order: np.ndarray = None  # permutation: ordered[i] = orig[order[i]]
    status: np.ndarray = None  # original order, masked -> -999
    status_order: np.ndarray = None
    keep_order: np.ndarray = None  # bool, ordered
    w: np.ndarray = None  # ordered weights (0 for masked)
    w_orig: np.ndarray = None  # original order weights
    dd: np.ndarray = None  # ordered: 1 at first index of each unique event time
    ww: np.ndarray = None  # ordered: tie-count weight at first index
    ww_k: np.ndarray = None  # [K] weights per unique event time
    rskcount: np.ndarray = None  # ordered cumsum of dd
    group: np.ndarray = None  # [n] ordered: risk-group index k for each sample (-1 if before first)
    n_unique: int = 0
    time_first_index: np.ndarray = None

    def setup(self, time, status, mask, norm_weights=False, order=None):
        """order: the time order of this mask when the caller has it
        (masked_order), else sorted here."""
        n = len(time)
        self.n = n
        self.neff = int(mask.sum())
        self.status = np.where(mask, status, -999.0)
        t_eff = np.where(mask, time, -999.0)
        # sort by time asc, status desc within ties (events first)
        self.order = np.lexsort((-self.status, t_eff)) if order is None else order
        time_order = t_eff[self.order]
        self.status_order = self.status[self.order]
        self.keep_order = mask[self.order]

        w = np.ones(n)
        if norm_weights:
            w = w / self.neff
        self.w_orig = np.where(mask, w, 0.0)
        self.w = np.where(self.keep_order, w, 0.0)

        # unique event times in order
        ev = self.status_order == 1
        self.n_events = int(ev.sum())
        ev_idx = np.flatnonzero(ev)
        ev_times = time_order[ev_idx]
        # first index + tie counts per unique event time
        uniq, first_pos, inv, counts = np.unique(
            ev_times, return_index=True, return_inverse=True, return_counts=True)
        self.n_unique = len(uniq)
        self.time_first_index = ev_idx[first_pos]

        self.dd = np.zeros(n)
        self.ww = np.zeros(n)
        wser = 1.0 / self.neff if norm_weights else 1.0
        self.dd[ev_idx] = np.where(ev, 1.0, 0.0)[ev_idx]
        self.ww[ev_idx] = self.w[ev_idx]
        # tied event times: the whole tie group's weight (count * wser) on
        # its first index, 0 on the rest (one pass for every group, where
        # the JAX package loops over the unique times)
        tied = counts[inv] > 1
        self.dd[ev_idx[tied]] = 0.0
        self.ww[ev_idx[tied]] = 0.0
        multi = counts > 1
        i0 = self.time_first_index[multi]
        self.dd[i0] = 1.0
        self.ww[i0] = counts[multi] * wser
        self.rskcount = np.cumsum(self.dd)
        self.ww_k = self.ww[self.dd == 1]

        # risk group index: sample i (ordered) belongs to R column k iff
        # time_first_index[k] <= i < time_first_index[k+1]
        self.group = np.searchsorted(self.time_first_index, np.arange(n), side="right") - 1

    # ---- risk-set segment sums ----
    def seg_sum(self, v_ordered):
        """R^T v: [K] sums of v over each risk group segment."""
        valid = self.group >= 0
        return np.bincount(
            self.group[valid], weights=v_ordered[valid], minlength=self.n_unique
        )

    def to_order(self, v):
        return v[self.order]

    def from_order(self, v_ordered):
        out = np.empty_like(v_ordered)
        out[self.order] = v_ordered
        return out


def masked_order(base, mask):
    """SurvivalData's order for `mask` (masked samples first, by index;
    then the rest by time, events first within tied times, then index)
    from base = np.lexsort((-status, time)) over every sample: the order
    of a sample subset is its order in the whole sort, so each mask of
    one time column costs a gather instead of a sort. Times must be >=
    0 where mask holds (negative times are masked when read)."""
    return np.concatenate([np.flatnonzero(~mask), base[mask[base]]])


def _loglik(sd: SurvivalData, eta_order):
    """Partial log-likelihood (cox_mle::compute_loglike) + baseline hazard."""
    w_exp = sd.w * np.exp(eta_order)
    S0 = _cumsum_rev(sd.seg_sum(w_exp))
    log_terms = (sd.ww_k * np.log(S0)).sum()
    ll = (sd.w * eta_order * (sd.status_order == 1)).sum() - log_terms
    ww_rsk = np.cumsum(sd.ww_k / S0)
    lam0_ord = np.where(sd.rskcount == 0, 0.0, ww_rsk[np.maximum(sd.rskcount.astype(int) - 1, 0)])
    lam0 = sd.from_order(lam0_ord)
    return ll, lam0


class CoxMLE:
    """Null Cox PH fit + score-test prep (cox_score.cpp)."""

    def __init__(self, niter=100, mxitnr=30, tol=1e-6):
        self.niter, self.mxitnr, self.tol = niter, mxitnr, tol
        self.converge = False

    def fit(self, sd: SurvivalData, X, offset, mask, beta_init=None, eta_init=None):
        n, p = X.shape
        if beta_init is not None:
            beta = beta_init.copy()
            eta = eta_init.copy()
        else:
            beta = np.zeros(p)
            eta = np.where(mask, offset, 0.0)
        eta_order = np.where(sd.keep_order, sd.to_order(eta), 0.0)
        ll, lam0 = _loglik(sd, eta_order)
        loglike = [ll]
        self.converge = False
        for t in range(self.niter):
            beta_old = beta.copy()
            mu = sd.w_orig * lam0 * np.exp(eta)
            residual = sd.w_orig * self.status_raw(sd) - mu
            with np.errstate(divide="ignore", invalid="ignore"):
                Y = np.where(mask, eta - offset, 0.0) + np.where(mu != 0, residual / mu, 0.0)
            if p == 0:
                self.converge = True
                self.sqrtWX = np.zeros((n, 0))
                self.XtWX = np.zeros((0, 0))
                break
            smu = np.sqrt(np.maximum(mu, 0))
            sqrtWX = X * smu[:, None]
            XtWX = sqrtWX.T @ sqrtWX
            XtWY = sqrtWX.T @ (Y * smu)
            try:
                beta = np.linalg.lstsq(XtWX, XtWY, rcond=None)[0]
            except np.linalg.LinAlgError:
                return self
            eta = np.where(mask, X @ beta + offset, 0.0)
            eta_order = sd.to_order(eta)
            ll, lam0 = _loglik(sd, eta_order)
            ii = 0
            while (loglike[-1] - ll) > self.tol:
                ii += 1
                if ii > self.mxitnr:
                    return self
                beta = (beta_old + beta) / 2
                eta = np.where(mask, X @ beta + offset, 0.0)
                eta_order = sd.to_order(eta)
                ll, lam0 = _loglik(sd, eta_order)
            rel = np.abs(beta - beta_old) / (np.abs(beta) + np.abs(beta_old) + self.tol)
            conv = (ll - loglike[-1] < self.tol) or (ii <= 1 and rel.max() < self.tol)
            loglike.append(ll)
            if conv:
                mu = sd.w_orig * lam0 * np.exp(eta)
                residual = sd.w_orig * self.status_raw(sd) - mu
                smu = np.sqrt(np.maximum(mu, 0))
                self.sqrtWX = X * smu[:, None]
                self.XtWX = self.sqrtWX.T @ self.sqrtWX
                self.converge = True
                break
        self.beta, self.eta, self.eta_order = beta, eta, eta_order
        self.mu, self.residual, self.lam0 = mu, residual, lam0
        self.loglik = ll
        return self

    @staticmethod
    def status_raw(sd):
        return np.where(sd.status == -999.0, 0.0, sd.status)

    def test_prep(self, sd: SurvivalData, X, offset, mask):
        """cox_test_prep (cox_score.cpp:143)."""
        n, p = X.shape
        eta_mean = self.eta_order.sum() / len(self.eta_order)
        self.w_exp_eta = sd.w * np.exp(self.eta_order - eta_mean)
        rskden = _cumsum_rev(sd.seg_sum(self.w_exp_eta))
        self.Dhalf = np.sqrt(sd.ww_k) / rskden
        GX = sd.to_order(X) * self.w_exp_eta[:, None] if p else np.zeros((n, 0))
        self.UhalfX = np.empty((sd.n_unique, p))
        for r in range(p):
            self.UhalfX[:, r] = self.Dhalf * _cumsum_rev(sd.seg_sum(GX[:, r]))
        if p > 0:
            self.cov_inv = np.linalg.pinv(self.XtWX - self.UhalfX.T @ self.UhalfX)
        else:
            self.cov_inv = np.zeros((0, 0))
        X1 = np.column_stack([np.ones(n), X])
        self.WX1 = X1 * self.mu[:, None]
        self.X1_X1WX1inv = X1 @ np.linalg.pinv(X1.T @ self.WX1)
        res_mean = self.residual.mean()
        self.res_var = ((self.residual - res_mean) ** 2).sum() / (len(self.residual) - 1)


class CoxFirth:
    """Firth-penalized Cox (cox_firth.cpp); fit (multi-param) and fit_1."""

    def __init__(self, sd, X, offset, cols_incl, niter=100, mxitnr=30, tol=2.5e-4,
                 stephalf_tol=2.5e-4, beta_tol=1e-8, maxstep=25.0, use_firth=True,
                 beta_init=None):
        self.sd, self.X, self.offset = sd, X, offset
        self.p = X.shape[1] if X.ndim == 2 else 1
        self.cols_incl = cols_incl
        self.niter, self.mxitnr = niter, mxitnr
        self.tol, self.stephalf_tol, self.beta_tol = tol, stephalf_tol, beta_tol
        self.maxstep = maxstep
        self.use_firth = use_firth and self.p > 0
        self.converge = False
        self.beta = np.zeros(self.p)
        if beta_init is not None:
            self.beta[:cols_incl] = beta_init[:cols_incl]

    # ----- multi-parameter likelihood (cox_firth_likelihood) -----
    def _likelihood(self, eta_order):
        sd, X = self.sd, self.X
        p = self.p
        exp_eta = np.exp(eta_order)
        w_exp = sd.w * exp_eta
        S0 = _cumsum_rev(sd.seg_sum(w_exp))
        ll = (sd.w * eta_order * (sd.status_order == 1)).sum() - (sd.ww_k * np.log(S0)).sum()
        ww_rsk = np.cumsum(sd.ww_k / S0)
        lam0 = np.where(sd.rskcount == 0, 0.0, ww_rsk[np.maximum(sd.rskcount.astype(int) - 1, 0)])
        mu = lam0 * w_exp
        Xo = sd.to_order(X)
        S1 = np.empty((sd.n_unique, p))
        for r in range(p):
            S1[:, r] = _cumsum_rev(sd.seg_sum(Xo[:, r] * w_exp))
        GammaX = Xo * np.sqrt(w_exp)[:, None]
        # segment outer products, accumulated in reverse (S2_k = sum_{i>=first_k} ...)
        second = np.zeros((p, p))
        firth_der = [np.zeros((p, p)) for _ in range(p)] if self.use_firth else None
        S2 = np.zeros((p, p))
        valid = self.sd.group >= 0
        # per-group Gram contributions
        grams = np.zeros((sd.n_unique, p, p))
        gv = GammaX[valid]
        gidx = sd.group[valid]
        # accumulate per-group outer products
        Gsq = np.einsum("ni,nj->nij", gv, gv)
        np.add.at(grams, gidx, Gsq)
        for k in range(sd.n_unique - 1, -1, -1):
            S2 = S2 + grams[k]
            second += sd.ww_k[k] * (S2 / S0[k] - np.outer(S1[k], S1[k]) / S0[k] ** 2)
            if self.use_firth:
                for t in range(p):
                    firth_der[t] += sd.ww_k[k] * (
                        (-S2 * S1[k, t] - np.outer(S2[:, t], S1[k]) - np.outer(S2[t, :], S1[k]))
                        / S0[k] ** 2
                        + 2 * np.outer(S1[k], S1[k]) * S1[k, t] / S0[k] ** 3
                    )
        residual = sd.w * (sd.status_order - mu)
        ci = self.cols_incl
        if self.use_firth:
            sign, logdet = np.linalg.slogdet(second)
            ll += 0.5 * logdet
            XW = (Xo[:, :ci] * np.sqrt(np.maximum(mu, 0))[:, None]).T  # ci x n
            sec_ci = second[:ci, :ci]
            sol = np.linalg.solve(sec_ci, XW)
            adj = 0.5 * (sol * XW).sum(axis=0)
            fd = Xo[:, :ci].T @ np.where(sd.keep_order, residual + adj, 0.0)
            for t in range(ci):
                fd[t] += 0.5 * np.trace(np.linalg.solve(sec_ci, firth_der[t][:ci, :ci]))
        else:
            fd = Xo[:, :ci].T @ residual
        return ll, fd, second, residual, mu

    def fit(self):
        sd, X = self.sd, self.X
        eta = X @ self.beta + self.offset
        eta_order = np.where(sd.keep_order, sd.to_order(eta), 0.0)
        ll, fd, second, residual, mu = self._likelihood(eta_order)
        loglike = [ll]
        ci = self.cols_incl
        self.iter = 0
        if self.p == 0 or ci == 0:
            self.converge = True
            self.residual = sd.from_order(residual)
            self.loglike = loglike
            self.second_der = second
            self.eta = eta  # empty design: offset-only linear predictor
            return self
        betanew = self.beta.copy()
        while self.iter < self.niter:
            self.iter += 1
            try:
                steps = np.linalg.solve(second[:ci, :ci], fd)
            except np.linalg.LinAlgError:
                break
            steps = np.clip(steps, -self.maxstep, self.maxstep)
            betanew[:ci] = self.beta[:ci] + steps
            eta = X @ betanew + self.offset
            eta_order = np.where(sd.keep_order, sd.to_order(eta), 0.0)
            ll, fd, second, residual, mu = self._likelihood(eta_order)
            ii = 0
            while (loglike[-1] - ll) > self.stephalf_tol:
                ii += 1
                if ii > self.mxitnr:
                    steps = steps + 1e-6
                    betanew[:ci] = self.beta[:ci] + steps
                    eta = X @ betanew + self.offset
                    eta_order = np.where(sd.keep_order, sd.to_order(eta), 0.0)
                    ll, fd, second, residual, mu = self._likelihood(eta_order)
                    break
                betanew = (self.beta + betanew) / 2
                eta = X @ betanew + self.offset
                eta_order = np.where(sd.keep_order, sd.to_order(eta), 0.0)
                ll, fd, second, residual, mu = self._likelihood(eta_order)
            loglike.append(ll)
            if np.abs(fd).max() < self.tol or (ii <= 1 and np.abs(self.beta - betanew).max() < self.beta_tol):
                self.beta = betanew.copy()
                self.converge = True
                break
            self.beta = betanew.copy()
        self.residual = sd.from_order(residual)
        self.loglike = loglike
        self.second_der = second
        self.eta = eta
        return self

    # ----- single-parameter fast path (cox_firth_likelihood_1 / fit_1) -----
    def _likelihood_1(self, g_ord, eta_order):
        sd = self.sd
        exp_eta = np.exp(eta_order)
        w_exp = sd.w * exp_eta
        S0 = _cumsum_rev(sd.seg_sum(w_exp))
        ll = (sd.w * eta_order * (sd.status_order == 1)).sum() - (sd.ww_k * np.log(S0)).sum()
        ww_rsk = np.cumsum(sd.ww_k / S0)
        lam0 = np.where(sd.rskcount == 0, 0.0, ww_rsk[np.maximum(sd.rskcount.astype(int) - 1, 0)])
        mu = lam0 * w_exp
        S1 = _cumsum_rev(sd.seg_sum(g_ord * w_exp))
        S2 = _cumsum_rev(sd.seg_sum(g_ord**2 * w_exp))
        second = (sd.ww_k * (S2 / S0 - S1**2 / S0**2)).sum()
        residual = sd.w * (sd.status_order - mu)
        if self.use_firth:
            ll += 0.5 * np.log(abs(second))
            S3 = _cumsum_rev(sd.seg_sum(g_ord**3 * w_exp))
            first = (g_ord * residual).sum() + 0.5 * (
                sd.ww_k * (S3 / S0 - 3 * S2 * S1 / S0**2 + 2 * S1**3 / S0**3)
            ).sum() / second
        else:
            first = (g_ord * residual).sum()
        return ll, first, second, residual

    def fit_1(self, g):
        """Single-SNP Firth Cox with covariate+LOCO offset (fit_1)."""
        sd = self.sd
        g_ord = sd.to_order(g)
        beta = 0.0
        eta_order = np.where(sd.keep_order, sd.to_order(g * beta + self.offset), 0.0)
        ll, first, second, residual = self._likelihood_1(g_ord, eta_order)
        loglike = [ll]
        self.iter = 0
        betanew = beta
        while self.iter < self.niter:
            self.iter += 1
            steps = first / second
            steps = np.clip(steps, -self.maxstep, self.maxstep)
            betanew = beta + steps
            eta_order = np.where(sd.keep_order, sd.to_order(g * betanew + self.offset), 0.0)
            ll, first, second, residual = self._likelihood_1(g_ord, eta_order)
            ii = 0
            while (loglike[-1] - ll) > self.stephalf_tol:
                ii += 1
                if ii > self.mxitnr:
                    steps += 1e-6
                    betanew = beta + steps
                    eta_order = np.where(sd.keep_order, sd.to_order(g * betanew + self.offset), 0.0)
                    ll, first, second, residual = self._likelihood_1(g_ord, eta_order)
                    break
                betanew = (beta + betanew) / 2
                eta_order = np.where(sd.keep_order, sd.to_order(g * betanew + self.offset), 0.0)
                ll, first, second, residual = self._likelihood_1(g_ord, eta_order)
            loglike.append(ll)
            if abs(first) < self.tol or (ii <= 1 and abs(beta - betanew) < self.beta_tol):
                beta = betanew
                self.converge = True
                break
            beta = betanew
        self.beta1 = beta
        self.second_der_1 = second
        self.loglike = loglike
        return self


class CoxRidge:
    """Penalized Cox by cyclic coordinate descent (cox_ridge.cpp)."""

    def __init__(self, sd, X, offset, mask, lam, niter=100, mxitnr=30, tol=1e-6,
                 beta_init=None, null_deviance=None):
        self.sd, self.X, self.offset, self.mask = sd, X, offset, mask
        self.lam = lam
        self.niter, self.mxitnr, self.tol = niter, mxitnr, tol
        self.beta = beta_init.copy() if beta_init is not None else np.zeros(X.shape[1])
        self.converge = False
        self.eta = np.where(mask, X @ self.beta + offset, 0.0)
        self._null_dev = null_deviance

    def _loglik(self, eta_order):
        sd = self.sd
        rsk = _cumsum_rev_full(sd, sd.w * np.exp(eta_order))
        log_terms = (sd.ww * np.where(sd.keep_order, np.log(np.maximum(rsk, 1e-300)), 0.0) * (sd.dd == 1)).sum()
        return (sd.w * eta_order * (sd.status_order == 1)).sum() - log_terms

    def _deviance(self, eta_order):
        sd = self.sd
        # saturated loglik from tie structure
        w_sub = sd.ww_k  # already tie-count/neff with norm_weights
        lsat = -(w_sub * np.log(np.maximum(w_sub, 1e-300))).sum()
        return 2 * (lsat - self._loglik(eta_order))

    def _grad(self, eta, eta_order):
        sd = self.sd
        mean_eta = (eta * sd.w_orig).sum() / sd.w_orig.sum()
        exp_eta = np.exp(eta_order - mean_eta)
        rskden = _cumsum_rev_full(sd, sd.w * exp_eta)
        with np.errstate(divide="ignore", invalid="ignore"):
            ww_rsk = np.where(rskden > 0, sd.ww / rskden, 0.0)
            ww_rsk2 = np.where(rskden > 0, sd.ww / rskden**2, 0.0)
        rinv = np.cumsum(np.where(sd.dd > 0, ww_rsk, 0.0))
        rinv2 = np.cumsum(np.where(sd.dd > 0, ww_rsk2, 0.0))
        grad_o = sd.w * ((sd.status_order == 1) - exp_eta * rinv)
        hess_o = (sd.w * exp_eta) ** 2 * rinv2 - sd.w * exp_eta * rinv
        return sd.from_order(grad_o), sd.from_order(hess_o)

    def fit(self):
        sd, X, offset, mask = self.sd, self.X, self.offset, self.mask
        p = X.shape[1]
        eta = self.eta
        eta_order = sd.to_order(eta)
        dev = [self._deviance(eta_order)]
        obj = [dev[0] + self.lam * (self.beta**2).sum() / 2]
        for t in range(self.niter):
            beta_old = self.beta.copy()
            grad, hess = self._grad(eta, eta_order)
            with np.errstate(divide="ignore", invalid="ignore"):
                z = np.where(hess != 0, grad / hess, 0.0)
            z = np.where(mask, eta - offset, 0.0) - z
            for k in range(p):
                r = hess * (z - eta + offset)
                eta = eta - np.where(mask, X[:, k] * self.beta[k], 0.0)
                xk2h = (X[:, k] ** 2 * hess).sum()
                self.beta[k] = (r @ X[:, k] + self.beta[k] * xk2h) / (xk2h - self.lam)
                eta = eta + np.where(mask, X[:, k] * self.beta[k], 0.0)
            eta_order = sd.to_order(eta)
            d = self._deviance(eta_order)
            o = d + self.lam * (self.beta**2).sum() / 2
            if (d - dev[-1]) > self.tol:
                ii = 0
                while (d - dev[-1]) > self.tol:
                    ii += 1
                    if ii > self.mxitnr:
                        self.eta = eta
                        return self
                    self.beta = (self.beta + beta_old) / 2
                    eta = np.where(mask, X @ self.beta + offset, 0.0)
                    eta_order = sd.to_order(eta)
                    d = self._deviance(eta_order)
                    o = d + self.lam * (self.beta**2).sum() / 2
            grad, _ = self._grad(eta, eta_order)
            # empty design (T2E with no covariates): nothing to move
            score_max = (np.abs(grad @ X - self.lam * self.beta).max()
                         if X.shape[1] else 0.0)
            conv = abs(o - obj[-1]) / (0.1 + abs(o)) < self.tol or score_max < self.tol
            dev.append(d)
            obj.append(o)
            if conv:
                self.converge = True
                break
        self.eta = eta
        self.deviance = dev[-1]
        return self


def _cumsum_rev_full(sd, v_ordered):
    """Reverse cumsum over ALL ordered samples (cox_ridge uses per-sample
    risk denominators, not per-unique-time)."""
    return np.cumsum(v_ordered[::-1])[::-1]
