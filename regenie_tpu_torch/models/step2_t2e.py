"""Step 2 on time-to-event traits (the port's copy of
regenie_tpu/models/step2_t2e.py): the Cox null fits per chromosome on the
host in numpy float64 (models/survival.py), the score test of a dense
block in float64 torch on the block's device, and the approximate Firth
correction of the rows past the threshold on the host.

Reference: compute_res_cox (Data.cpp:2471), fit_null_cox
(Step1_Models.cpp:353), compute_score_cox (Step2_Models.cpp:632),
fit_null_firth_cox (:702), fit_firth_cox_snp_fast (:850).

Per trait, with A = G WX1 and R = X1 (X1' W X1)^-1 from the null fit,
    Gres  = G - A R'
    T     = Gres v,            v = residual * mask
    denum = res_var ||Gres||^2
(the fused route computes the same T and denum from its products,
ops/fused_score.make_t2e_block_fn, and hands them to score_block_fused).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np
import torch

from ..config import Params
from ..io.pheno import PhenoData
from ..utils.stats import chisq_neglog10
from .survival import CoxFirth, CoxMLE, CoxRidge, SurvivalData, _cumsum_rev


@dataclass
class T2EChromState:
    res: np.ndarray = None  # [N, P] martingale-ish residuals (cox_mle.residual)
    surv: Dict[int, SurvivalData] = field(default_factory=dict)
    mle: Dict[int, CoxMLE] = field(default_factory=dict)
    firth_offset: np.ndarray = None  # [N, P] cov+loco eta from null firth cox
    blups: np.ndarray = None
    allow_correction: bool = True
    time_cols: List[int] = field(default_factory=list)
    # per trait: (WX1, R, v) as float64 tensors on the dense route's device
    dev: Dict[int, tuple] = field(default_factory=dict)


def prep_chromosome(params: Params, pd: PhenoData, blups: np.ndarray, log) -> T2EChromState:
    """The Cox null of every time column with the chromosome's LOCO
    offset: the ridge start, the MLE (retried from a plain Cox fit), its
    score-test pieces and, with --firth --approx, the null Firth fit
    whose linear predictor offsets the per-variant Firth fits. A trait
    whose fit fails stops passing."""
    N, P = pd.phenotypes_raw.shape
    st = T2EChromState()
    st.blups = blups
    st.res = np.zeros((N, P))
    st.firth_offset = np.zeros((N, P))

    name_to_idx = {nm: i for i, nm in enumerate(pd.pheno_names)}
    for time_name, event_name in params.t2e_map.items():
        ti = name_to_idx[time_name]
        ei = name_to_idx[event_name]
        st.time_cols.append(ti)
        if not pd.pheno_pass[ti]:
            continue
        time_ = pd.phenotypes_raw[:, ti]
        status = pd.phenotypes_raw[:, ei]
        mask = pd.masked_indivs[:, ti]
        offset = blups[:, ti] * mask

        sd = SurvivalData()
        sd.setup(time_, status, mask, norm_weights=False)

        ridge0 = CoxRidge(sd, pd.new_cov, offset, mask, 0.0, params.niter_max,
                          params.niter_max_line_search, 2.5e-4)
        ridge0.fit()

        mle = CoxMLE(params.niter_max, params.niter_max_line_search, 2.5e-4)
        mle.fit(sd, pd.new_cov, offset, mask, ridge0.beta, ridge0.eta)
        if not mle.converge:
            fx = CoxFirth(sd, pd.new_cov, offset, pd.new_cov.shape[1],
                          params.niter_max, params.niter_max_line_search,
                          2.5e-4, 2.5e-4, 1e-8, params.maxstep_null, False)
            fx.fit()
            mle.fit(sd, pd.new_cov, offset, mask, fx.beta, fx.eta)
        if not mle.converge:
            log(f"WARNING: cox null regression did not converge for '{time_name}'")
            pd.pheno_pass[ti] = False
            continue
        mle.test_prep(sd, pd.new_cov, offset, mask)
        st.surv[ti] = sd
        st.mle[ti] = mle
        st.res[:, ti] = mle.residual

        if params.firth and params.firth_approx:
            fnull = CoxFirth(sd, pd.new_cov, offset, pd.new_cov.shape[1],
                             params.niter_max_firth_null, params.niter_max_line_search,
                             2.5e-4, 2.5e-4, 1e-8, params.maxstep_null,
                             not params.cox_nofirth, beta_init=mle.beta)
            fnull.fit()
            if not fnull.converge:
                log(f"WARNING: null Firth cox failed for '{time_name}'")
                pd.pheno_pass[ti] = False
                continue
            st.firth_offset[:, ti] = fnull.eta
    return st


def passing_traits(pd: PhenoData, st: T2EChromState):
    """T2E traits in operand order (the fused route's trait axis)."""
    return [ph for ph in st.time_cols if pd.pheno_pass[ph] and ph in st.mle]


def event_sides(params: Params, pd: PhenoData):
    """[N, P] boolean (case, control): a time column's cases are its
    events and its controls the censored samples, within the trait's mask
    (compute_genocounts trait_mode==3 branch, Geno.cpp:2079); every other
    column is all False."""
    case = np.zeros_like(pd.masked_indivs)
    ctrl = np.zeros_like(pd.masked_indivs)
    for tname, ename in params.t2e_map.items():
        ti, ei = pd.pheno_names.index(tname), pd.pheno_names.index(ename)
        ev = pd.phenotypes_raw[:, ei]
        case[:, ti] = (ev == 1) & pd.masked_indivs[:, ti]
        ctrl[:, ti] = (ev == 0) & pd.masked_indivs[:, ti]
    return case, ctrl


def _dev_consts(st: T2EChromState, pd: PhenoData, ph: int, device):
    """(WX1, R, v) of trait ph as float64 tensors on `device`, uploaded
    once a chromosome."""
    c = st.dev.get(ph)
    if c is None or c[0].device != device:
        mle = st.mle[ph]
        v = mle.residual * pd.masked_indivs[:, ph]
        c = st.dev[ph] = tuple(
            torch.as_tensor(np.ascontiguousarray(a, np.float64), device=device)
            for a in (mle.WX1, mle.X1_X1WX1inv, v))
    return c


def _score_tail(params, pd, st, ph, T, dn, flipped, ignored, ignored_trait,
                gres_rows, z_thr):
    """One trait's statistics from T and denum [B] (host), with the
    approximate Firth correction of the rows past z_thr on gres_rows(idx)
    (the rows' Gres, [len(idx), N] numpy). Returns (bhat, se, chisq,
    logp, fail, corrected, failed)."""
    low = dn < params.numtol
    ignored_trait[:, ph] |= low
    with np.errstate(divide="ignore", invalid="ignore"):
        stats = T / np.sqrt(np.where(low, 1.0, dn))
    se_ph = 1.0 / np.sqrt(np.where(low, 1.0, dn))
    bhat_ph = stats * se_ph
    chisq_ph = stats**2
    logp_ph = chisq_neglog10(chisq_ph)
    fail_ph = np.zeros(len(T), dtype=bool)
    n_corr = n_fail = 0
    if params.firth:
        corr = (~ignored) & (~ignored_trait[:, ph]) & (np.abs(stats) > z_thr)
        n_corr = int(corr.sum())
        idx = np.flatnonzero(corr)
        rows = gres_rows(idx) if len(idx) else None
        for r, b in enumerate(idx):
            ok, beta1, se1, lrt = _firth_snp(params, st, st.surv[ph], ph, rows[r])
            if not ok:
                fail_ph[b] = True
                n_fail += 1
                continue
            bhat_ph[b] = beta1
            chisq_ph[b] = lrt
            logp_ph[b] = float(chisq_neglog10(np.array([lrt]))[0])
            if params.firth_se and lrt > 0:
                se_ph[b] = abs(beta1) / np.sqrt(lrt)
            else:
                se_ph[b] = se1
    bhat_ph = np.where(flipped, -bhat_ph, bhat_ph)
    return bhat_ph, se_ph, chisq_ph, logp_ph, fail_ph, n_corr, n_fail


def _z_thr(params):
    from scipy.stats import chi2 as _chi2

    return np.sqrt(_chi2.isf(params.alpha_pvalue, df=1))


def _outputs(params, B):
    P = params.n_pheno
    return (np.zeros((B, P)), np.zeros((B, P)), np.full((B, P), -1.0),
            np.full((B, P), np.nan), np.zeros((B, P), dtype=bool))


def cox_products(G, WX1, R, v):
    """The Cox score products of a [B, N] float64 block (compute_score_cox,
    Step2_Models.cpp:632): (Gres, T, the row sums of Gres^2), Gres = G -
    (G WX1) R' and T = Gres v."""
    Gres = G - (G @ WX1) @ R.T
    return Gres, Gres @ v, (Gres**2).sum(dim=1)


def score_block(params: Params, pd: PhenoData, st: T2EChromState, G, flipped,
                ignored, ignored_trait, times=None, replicas=None):
    """Batched Cox score test + Firth correction of a dense block
    (compute_score_cox): G the [B, N] float64 finalized genotypes on the
    scoring device. Per trait the three products Gres, T and ||Gres||^2 run
    there in float64 (cox_products); --coxscore-exact takes each row's
    exact variance (_exact_denum) on the host from Gres, and the Firth
    rows' Gres come to the host. times (a dict), if given, gains the
    correction seconds under "corr_s". Returns (bhat, se, chisq, logp,
    test_fail, corrected, failed), the first five [B, P] numpy.

    With replicas (a parallel.mesh.Replicas; not with --coxscore-exact,
    whose per-row variance needs the whole Gres block), the products run
    variant-sharded over its mesh (parallel.mesh.sharded_score_t2e, as in
    regenie_tpu/models/step2_t2e.py:90-150) and the Firth rows' Gres are
    formed from their G rows."""
    B = G.shape[0]
    bhat, se, chisq, logp, test_fail = _outputs(params, B)
    n_corrected = n_failed = 0
    z_thr = _z_thr(params)
    if params.coxscore_exact:
        replicas = None
    for ph in passing_traits(pd, st):
        WX1, R, v = _dev_consts(st, pd, ph, G.device)
        if replicas is not None:
            from ..parallel import mesh as pm

            W_s, R_s, v_s = replicas(("t2e", ph), WX1, R, v)
            T, d = (x.cpu().numpy() for x in pm.sharded_score_t2e(
                replicas.mesh, G, W_s, [r.T for r in R_s], [x[:, None] for x in v_s]))
            dn = st.mle[ph].res_var * d

            def rows(idx, WX1=WX1, R=R, v=v):
                Gr = G[torch.as_tensor(idx, device=G.device)]
                return cox_products(Gr, WX1, R, v)[0].cpu().numpy()
        else:
            Gres, T, d = cox_products(G, WX1, R, v)
            T = T.cpu().numpy()
            dn = st.mle[ph].res_var * d.cpu().numpy()
            if params.coxscore_exact:
                Gh = Gres.cpu().numpy()
                mask = pd.masked_indivs[:, ph].astype(np.float64)
                for b in range(B):
                    dn[b] = _exact_denum(st.surv[ph], st.mle[ph], Gh[b], mask)

                def rows(idx, Gh=Gh):
                    return Gh[idx]
            else:
                def rows(idx, Gres=Gres):
                    return Gres[torch.as_tensor(idx, device=Gres.device)].cpu().numpy()
        t0 = time.time()
        out = _score_tail(params, pd, st, ph, T, dn, flipped, ignored,
                          ignored_trait, rows, z_thr)
        if times is not None:
            times["corr_s"] = times.get("corr_s", 0.0) + time.time() - t0
        bhat[:, ph], se[:, ph], chisq[:, ph], logp[:, ph], test_fail[:, ph] = out[:5]
        n_corrected += out[5]
        n_failed += out[6]
    return bhat, se, chisq, logp, test_fail, n_corrected, n_failed


def score_block_fused(params: Params, pd: PhenoData, st: T2EChromState,
                      Tnum, denum, flipped, gres_rows, ignored,
                      ignored_trait, times=None):
    """Host tail of the fused Cox route (compute_score_cox tail,
    Step2_Models.cpp:658-700): per-trait low-variance gating, score
    statistics from the card's T and denum, Firth corrections on the
    correction rows decoded again from the block.

    Tnum/denum: [B, Tt] numpy in passing_traits order; flipped: [B] bool;
    gres_rows(idx) -> finalized (imputed/flipped, ind-zeroed) G rows
    [len(idx), N] numpy on the kept sample axis, decoded once a block for
    every trait's rows."""
    B = Tnum.shape[0]
    bhat, se, chisq, logp, test_fail = _outputs(params, B)
    n_corrected = n_failed = 0
    z_thr = _z_thr(params)
    G_cache = {}  # decoded correction rows, shared across traits

    for ti, ph in enumerate(passing_traits(pd, st)):
        mle = st.mle[ph]

        def rows(idx, mle=mle):
            need = [i for i in idx if i not in G_cache]
            if need:
                for i, r in zip(need, gres_rows(np.asarray(need))):
                    G_cache[i] = r
            # a row at a time, as the JAX package forms each row's Gres
            return [G_cache[i] - (G_cache[i] @ mle.WX1) @ mle.X1_X1WX1inv.T
                    for i in idx]

        t0 = time.time()
        out = _score_tail(params, pd, st, ph, np.asarray(Tnum[:, ti], np.float64),
                          np.asarray(denum[:, ti], np.float64), flipped, ignored,
                          ignored_trait, rows, z_thr)
        if times is not None:
            times["corr_s"] = times.get("corr_s", 0.0) + time.time() - t0
        bhat[:, ph], se[:, ph], chisq[:, ph], logp[:, ph], test_fail[:, ph] = out[:5]
        n_corrected += out[5]
        n_failed += out[6]
    return bhat, se, chisq, logp, test_fail, n_corrected, n_failed


def _firth_snp(params, st, sd, ph, gres):
    """Approx-Firth Cox single-SNP LRT (fit_firth_cox_snp_fast)."""
    offset = st.firth_offset[:, ph]
    cf = CoxFirth(sd, gres[:, None], offset, 1, params.niter_max_firth,
                  params.niter_max_line_search, 2.5e-4, 2.5e-4, 1e-8,
                  params.maxstep, not params.cox_nofirth)
    cf.fit_1(gres)
    if not cf.converge:
        cf = CoxFirth(sd, gres[:, None], offset, 1, params.niter_max_firth * 5,
                      params.niter_max_line_search, 2.5e-4, 0.0, 1e-8,
                      params.maxstep / 5, not params.cox_nofirth)
        cf.fit_1(gres)
    if not cf.converge:
        return False, 0.0, 0.0, 0.0
    lrt = 2 * (cf.loglike[-1] - cf.loglike[0])
    if lrt < 0:
        return False, 0.0, 0.0, 0.0
    se1 = np.sqrt(1.0 / cf.second_der_1) if cf.second_der_1 > 0 else 0.0
    return True, cf.beta1, se1, lrt


def _exact_denum(sd, mle, gres, mask):
    """Exact score variance (--coxscore-exact, Step2_Models.cpp:672)."""
    sqrtWG = gres * np.sqrt(np.maximum(mle.mu, 0)) * mask
    g_ord = sd.to_order(gres)
    RGammaG = _cumsum_rev(sd.seg_sum(mle.w_exp_eta * g_ord))
    UhalfG = mle.Dhalf * RGammaG
    XtWG = mle.sqrtWX.T @ sqrtWG
    XtUG = mle.UhalfX.T @ UhalfG
    XtVG = XtWG - XtUG
    return (sqrtWG**2).sum() - (UhalfG**2).sum() - XtVG @ (mle.cov_inv @ XtVG)
