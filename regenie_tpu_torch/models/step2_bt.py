"""Step 2 on binary traits (the port's copy of regenie_tpu/models/step2_bt.py):
null refits per chromosome on the host, batched score tests and the
corrections of the rows past the threshold: SPA, approximate Firth or
exact Firth (two penalized fits a row with the covariates free), and the
null Firth checkpoints (--use-null-firth starts, the Step-2
--write-null-firth stream). Count traits share the score test
(models/step2_ct.py builds their null state, with no correction).

Reference: compute_res_bin (Data.cpp:2440), fit_null_logistic
(Step1_Models.cpp:54), fit_null_firth (Step2_Models.cpp:985),
compute_score_bt (Step2_Models.cpp:470), check_pval_snp (:1988).

The score products of ALL traits come from one matmul set (the
trait-vectorized form of the reference's v2.2 BT rework,
docs/performance.md:94-97): with A_p = G W_p XW_p and orthonormal XW_p,
per trait p
    num_p   = G W_p res_p - A_p (XW_p' res_p)
    denum_p = ||G W_p||^2 - ||A_p||^2 = G^2 gsm_p^2 - ||A_p||^2.
Concatenating W_p = [gsm_p XW_p | gsm_p res_p] over traits (Wcat), G is
consumed by two products a block (_allpass, or the fused kernels'
products of the same columns), and G_res is rebuilt only for the rows
the corrections take (_gres_rows). Everything on the device runs in
float64 torch on the block's device; the null fits and the host twins of
the corrections in numpy float64.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List

import numpy as np
import torch

from ..config import Params
from ..io.files import iter_lines
from ..io.pheno import PhenoData, get_basis
from ..prep import fmt
from ..utils.stats import chisq_neglog10
from . import corrections_device as cdev
from . import firth as firth_mod
from . import spa as spa_mod
from .glm import fit_logistic_irls, get_pvec


def _allpass(G, Wcat, xwt, gsm2, Pn, Kp1):
    """num, denum [B, Pn] and S1 [B, Pn, Kp1] of a [B, N] float64 block
    for every passing trait (the JAX package's jitted _allpass)."""
    S1 = (G @ Wcat).reshape(G.shape[0], Pn, Kp1)
    A = S1[..., :-1]  # [B, Pn, Kmax]
    num = S1[..., -1] - torch.einsum("bpk,pk->bp", A, xwt)
    denum = (G**2) @ gsm2 - (A**2).sum(-1)
    return num, denum, S1


def _gres_rows(G_rows, gsm, XW, A_rows):
    """G_res of the correction rows only: G gsm - A XW'."""
    return G_rows * gsm[None, :] - A_rows @ XW.T


class FusedConsts:
    """Per-chromosome constants of the all-trait scorer: the passing
    traits `cols`, Wcat [N, Pn*(Kmax+1)] and xwt [Pn, Kmax] (numpy
    float64), and their device copies for the dense route (dev)."""

    def __init__(self, pd, st):
        self.cols = passing(pd, st)
        self.j_of = {ph: j for j, ph in enumerate(self.cols)}
        self._dev = None
        if not self.cols:
            return
        N = st.res.shape[0]
        Kmax = max(st.X_gamma[ph].shape[1] for ph in self.cols)
        self.Kmax = Kmax
        Wcat = np.zeros((N, len(self.cols) * (Kmax + 1)))
        xwt = np.zeros((len(self.cols), Kmax))
        for j, ph in enumerate(self.cols):
            gsm = st.gamma_sqrt_mask[:, ph]
            XW = st.X_gamma[ph]
            K = XW.shape[1]
            c0 = j * (Kmax + 1)
            Wcat[:, c0 : c0 + K] = gsm[:, None] * XW
            Wcat[:, c0 + Kmax] = gsm * st.res[:, ph]
            xwt[j, :K] = XW.T @ st.res[:, ph]
        self.Wcat = Wcat
        self.xwt = xwt
        self.gsm2 = st.gamma_sqrt_mask[:, self.cols] ** 2

    def dev(self, device):
        """(Wcat, xwt, gsm2) as float64 tensors on `device`, uploaded once."""
        if self._dev is None or self._dev[0].device != torch.device(device):
            self._dev = tuple(torch.as_tensor(a, dtype=torch.float64, device=device)
                              for a in (self.Wcat, self.xwt, self.gsm2))
        return self._dev


def passing(pd, st) -> List[int]:
    """The traits a block scores: passing, with a null fit."""
    return [ph for ph in range(st.res.shape[1])
            if pd.pheno_pass[ph] and st.X_gamma[ph] is not None]


def fused_consts(pd, st) -> FusedConsts:
    """The chromosome's FusedConsts, rebuilt when the passing traits
    changed."""
    fc = st.fused
    if fc is None or fc.cols != passing(pd, st):
        fc = st.fused = FusedConsts(pd, st)
    return fc


@dataclass
class BTChromState:
    """Per-chromosome null-model state (the reference's `ests` and
    `f_ests`)."""

    res: np.ndarray = None  # [N, P] (Y - pi)/sqrt(w) masked
    Y_hat: np.ndarray = None  # [N, P]
    gamma_sqrt: np.ndarray = None  # [N, P]
    gamma_sqrt_mask: np.ndarray = None  # [N, P]
    X_gamma: List[np.ndarray] = field(default_factory=list)  # per trait [N, K] orthonormal
    firth_offset: np.ndarray = None  # [N, P] cov effects + LOCO (approx firth)
    blups: np.ndarray = None  # [N, P]
    bhat_start: np.ndarray = None  # [K, P] null logistic betas
    eta_null: np.ndarray = None  # [N, P] null eta (offset_nullreg)
    allow_correction: bool = True  # Firth/SPA for binary traits only
    fused: FusedConsts = None
    dev_cache: dict = field(default_factory=dict)  # (trait, device) -> tensors


def _load_null_firth_start(files_map, pheno_name, chrom, K):
    """A trait's starting values for chromosome `chrom` from a
    _firth.list checkpoint (get_beta_start_firth, Step2_Models.cpp:1893),
    or None."""
    path = files_map.get(pheno_name)
    if path is None:
        return None
    for toks in iter_lines(path):
        if int(toks[0]) == chrom:
            vals = np.array([float(x) for x in toks[1:]])
            if len(vals) >= K:
                return vals[:K]
    return None


def _null_fit(params: Params, pd: PhenoData, blups: np.ndarray, ph: int,
              firth_start=None):
    """One trait's null fits against the covariates: the logistic model
    with the LOCO offset (and its two retries), and with --firth --approx
    the null Firth model, started from `firth_start` (a --use-null-firth
    checkpoint) when given, else from the logistic fit. Returns a dict of
    the trait's null state, or the warning when a fit fails."""
    X = pd.new_cov
    N, K = X.shape
    y = pd.phenotypes_raw[:, ph]
    mask = pd.masked_indivs[:, ph]
    # --prs-cov: the LOCO PRS is X's last column and the offset is dropped
    # (fit_null_logistic, Step1_Models.cpp:73-76)
    offset = np.zeros(N) if params.blup_cov else blups[:, ph] * mask

    beta, ok = fit_logistic_irls(
        y, X, offset, mask, params.niter_max, params.numtol, True
    )
    if not ok:
        beta, ok = fit_logistic_irls(
            y, X, offset, mask, params.niter_max, params.numtol, False
        )
    if not ok:
        # retry from the starting values of the model without the LOCO
        # offset (fit_null_logistic, Step1_Models.cpp:88-105)
        b0, ok0 = fit_logistic_irls(
            y, X, np.zeros(N), mask, params.niter_max, params.numtol, True
        )
        if ok0:
            beta, ok = fit_logistic_irls(
                y, X, offset, mask, params.niter_max, params.numtol, True,
                beta0=b0,
            )
    if not ok:
        return f"WARNING: logistic regression did not converge for '{pd.pheno_names[ph]}'"

    fit = {"beta": beta}
    eta = offset + X @ beta
    fit["eta"] = eta
    pi = get_pvec(eta)
    gs = np.sqrt(np.where(mask, pi * (1 - pi), 1.0))
    fit["pi"], fit["gs"], fit["gsm"] = pi, gs, gs * mask
    fit["XW"], _ = get_basis(X * fit["gsm"][:, None], params)
    fit["res"] = np.where(mask, (y - pi) / gs, 0.0)

    if params.firth_approx:
        bnull, okf = firth_mod.fit_firth_null(
            y, X, offset, mask, beta.copy() if firth_start is None else firth_start,
            maxstep=params.maxstep_null, niter=params.niter_max_firth_null,
            tol=50 * params.numtol,
        )
        if not okf:
            # the reference retries from 0 with smaller steps
            # (fit_approx_firth_null)
            b2 = np.zeros(K)
            b2[0] = -offset[mask].mean()
            bnull, okf = firth_mod.fit_firth_null(
                y, X, offset, mask, b2,
                maxstep=params.maxstep_null // 5,
                niter=params.niter_max_firth_null * 5,
                tol=50 * params.numtol,
            )
        if not okf:
            return f"WARNING: null Firth failed for '{pd.pheno_names[ph]}'"
        fit["bnull"] = bnull
        fit["firth_offset"] = X @ bnull
        if not params.blup_cov:  # the PRS is inside X otherwise
            fit["firth_offset"] += blups[:, ph]
    return fit


def prep_chromosome(params: Params, pd: PhenoData, blups: np.ndarray,
                    log, null_firth_files=None, chrom=None) -> BTChromState:
    """Refit the null logistic model with the LOCO offset per trait, and
    with --firth --approx the null Firth model (compute_res_bin,
    Data.cpp:2440-2460), on the host in numpy float64, a trait at a time
    (fits run in concurrent threads were not reproducible on the card's
    host: its BLAS gave other bits from run to run). null_firth_files
    (--use-null-firth: trait name -> .firth file) gives the null Firth
    fits of chromosome `chrom` their starting values; with Step 2's
    --write-null-firth (params._null_firth_out: trait -> open file) each
    trait's null Firth coefficients of `chrom` are written once
    (Data.cpp:2200-2215)."""
    N, P = pd.phenotypes_raw.shape
    st = BTChromState()
    st.blups = blups
    st.res = np.zeros((N, P))
    st.Y_hat = np.zeros((N, P))
    st.gamma_sqrt = np.ones((N, P))
    st.gamma_sqrt_mask = np.zeros((N, P))
    st.X_gamma = [None] * P
    st.firth_offset = np.zeros((N, P))
    st.eta_null = np.zeros((N, P))
    K = pd.new_cov.shape[1]
    st.bhat_start = np.zeros((K, P))

    for ph in range(P):
        if not pd.pheno_pass[ph]:
            continue
        if params.blup_cov:
            # --prs-cov: the LOCO PRS fills the reserved covariate column
            pd.new_cov[:, -1] = blups[:, ph] * pd.masked_indivs[:, ph]
        start = None
        if params.firth_approx and null_firth_files is not None and chrom is not None:
            start = _load_null_firth_start(null_firth_files, pd.pheno_names[ph],
                                           chrom, K)
        fit = _null_fit(params, pd, blups, ph, start)
        if isinstance(fit, str):
            log(fit)
            pd.pheno_pass[ph] = False
            continue
        out = getattr(params, "_null_firth_out", None)
        if "bnull" in fit and out is not None and chrom is not None and ph in out:
            seen = params.__dict__.setdefault("_null_firth_written", set())
            if (ph, chrom) not in seen:
                seen.add((ph, chrom))
                out[ph].write(f"{chrom} " + " ".join(fmt(b) for b in fit["bnull"])
                              + "\n")
                out[ph].flush()
        st.bhat_start[:, ph] = fit["beta"]
        st.eta_null[:, ph] = fit["eta"]
        st.Y_hat[:, ph] = fit["pi"]
        st.gamma_sqrt[:, ph] = fit["gs"]
        st.gamma_sqrt_mask[:, ph] = fit["gsm"]
        st.X_gamma[ph] = fit["XW"]
        st.res[:, ph] = fit["res"]
        if "firth_offset" in fit:
            st.firth_offset[:, ph] = fit["firth_offset"]
    return st


class DenseGSource:
    """score_block's genotype access backed by a [B, N] float64 block on
    the device (the dense route's decode -> finalize path)."""

    def __init__(self, G):
        self.G = G

    @property
    def n_snps(self):
        return self.G.shape[0]

    def allpass(self, fc):
        Wcat, xwt, gsm2 = fc.dev(self.G.device)
        return _allpass(self.G, Wcat, xwt, gsm2, len(fc.cols), fc.Kmax + 1)

    def rows_device(self, idx):
        return self.G[idx]


class MeshGSource(DenseGSource):
    """DenseGSource whose all-trait score products run variant-sharded
    over a mesh (parallel.mesh.sharded_score_bt; the JAX package's
    MeshGSource, regenie_tpu/models/step2_bt.py:292-345): replicas (a
    parallel.mesh.Replicas) keeps the operands' per-shard copies, and the
    correction rows come from the whole block on the first shard's
    device."""

    def __init__(self, G, replicas):
        super().__init__(G)
        self.replicas = replicas

    def allpass(self, fc):
        from ..parallel import mesh as pm

        ops = self.replicas("bt", *fc.dev(self.G.device))
        return pm.sharded_score_bt(self.replicas.mesh, self.G, *ops,
                                   len(fc.cols), fc.Kmax + 1)


def dev_consts(st, pd, ph, device) -> dict:
    """A trait's [N] null-model vectors and its covariate basis as float64
    tensors on `device`, uploaded once a chromosome and reused by every
    block's corrections."""
    key = (ph, str(device))
    dc = st.dev_cache.get(key)
    if dc is None:
        def put(a):
            return torch.as_tensor(np.asarray(a, np.float64), device=device)

        dc = st.dev_cache[key] = {
            "y": put(pd.phenotypes_raw[:, ph]),
            "mask": put(pd.masked_indivs[:, ph]),
            "gamma_sqrt": put(st.gamma_sqrt[:, ph]),
            "gsm": put(st.gamma_sqrt_mask[:, ph]),
            "XW": put(st.X_gamma[ph]),
            "firth_offset": put(st.firth_offset[:, ph]),
            "Y_hat": put(st.Y_hat[:, ph]),
        }
    return dc


def score_block(params: Params, pd: PhenoData, st: BTChromState, src,
                flipped: np.ndarray, ignored: np.ndarray,
                ignored_trait: np.ndarray, times: dict = None):
    """Batched BT score test with Firth or SPA corrections for one block
    (compute_score_bt, Step2_Models.cpp:470, a trait at a time, batched
    over variants). src: a DenseGSource or the fused route's source
    (allpass / rows_device / n_snps). The rows corrected are those not
    ignored with |stat| > z_thr (check_pval_snp); with
    REGENIE_TPU_DEVICE_CORR (corrections_device.enabled) on the device,
    else by the host twins. ignored_trait gains the rows with a
    vanishing denominator. times, if given, gains "corr_s" (seconds in
    the corrections). Returns (bhat, se, chisq, logp, test_fail,
    n_corrected, n_failed), numpy [B, P] each and two ints."""
    B = src.n_snps
    P = params.n_pheno
    bhat = np.zeros((B, P))
    se = np.zeros((B, P))
    chisq = np.full((B, P), -1.0)
    logp = np.full((B, P), np.nan)
    test_fail = np.zeros((B, P), dtype=bool)
    n_corrected = 0
    n_failed = 0
    z_thr = np.sqrt(chisq_thr(params.alpha_pvalue))
    fc = fused_consts(pd, st)
    if not fc.cols:
        return bhat, se, chisq, logp, test_fail, n_corrected, n_failed
    num_all, denum_all, S1_all = src.allpass(fc)
    if isinstance(num_all, torch.Tensor):
        num_all = num_all.cpu().numpy()
        denum_all = denum_all.cpu().numpy()
    correct = (params.firth or params.use_spa) and st.allow_correction

    for ph in fc.cols:
        j = fc.j_of[ph]
        num = num_all[:, j]
        denum = denum_all[:, j]
        sqrt_denum = np.sqrt(np.maximum(denum, 0))
        low = sqrt_denum < params.numtol
        ignored_trait[:, ph] |= low
        with np.errstate(divide="ignore", invalid="ignore"):
            stats = num / np.where(low, 1.0, sqrt_denum)

        # default (uncorrected) sum stats
        se_ph = 1.0 / np.where(low, 1.0, sqrt_denum)
        bhat_ph = stats * se_ph
        chisq_ph = stats**2
        logp_ph = chisq_neglog10(chisq_ph)
        fail_ph = np.zeros(B, dtype=bool)

        # correction set: |stat| > z_thr (check_pval_snp)
        corr = (~ignored) & (~ignored_trait[:, ph]) & (np.abs(stats) > z_thr)
        if correct and corr.any():
            t0 = time.time()
            idx = np.flatnonzero(corr)
            n_corrected += len(idx)
            out = (bhat_ph, se_ph, chisq_ph, logp_ph, fail_ph)
            if params.firth and not params.firth_approx:
                n_failed += _exact_firth_rows(params, pd, st, ph, idx, src, out,
                                              S1_all.device)
            else:
                # the rows in groups of CORR_ROWS: each row's solve is its
                # own, so the groups only bound the [rows, N] temporaries
                for lo in range(0, len(idx), CORR_ROWS):
                    n_failed += _correct_rows(
                        params, pd, st, ph, j, idx[lo : lo + CORR_ROWS], src,
                        S1_all, stats, denum, sqrt_denum, out)
            if times is not None:
                times["corr_s"] = times.get("corr_s", 0.0) + time.time() - t0

        # the effect of a flipped (minor-allele) variant changes sign
        bhat[:, ph] = np.where(flipped, -bhat_ph, bhat_ph)
        se[:, ph] = se_ph
        chisq[:, ph] = chisq_ph
        logp[:, ph] = logp_ph
        test_fail[:, ph] = fail_ph

    return bhat, se, chisq, logp, test_fail, n_corrected, n_failed


# correction rows solved together (their [rows, N] float64 temporaries:
# ~0.4 GB a tensor at N = 400,000)
CORR_ROWS = 128


def _correct_rows(params, pd, st, ph, j, idx, src, S1_all, stats, denum,
                  sqrt_denum, out):
    """Firth (approximate) or SPA on trait ph's rows idx, written into
    out = (bhat, se, chisq, logp, fail) [B] of the trait: on the device
    (corrections_device) when enabled, else by the host twins, from G_res
    rebuilt for these rows only. Returns the number that failed."""
    bhat_ph, se_ph, chisq_ph, logp_ph, fail_ph = out
    mask = pd.masked_indivs[:, ph]
    dev = S1_all.device
    dc = dev_consts(st, pd, ph, dev)
    idx_t = torch.as_tensor(idx, device=dev)
    K = st.X_gamma[ph].shape[1]
    Gres_dev = _gres_rows(src.rows_device(idx_t), dc["gsm"], dc["XW"],
                          S1_all[idx_t, j, :K])
    use_dev = cdev.enabled(dev)
    Gres = None if use_dev else Gres_dev.cpu().numpy()
    if params.firth:
        if use_dev:
            beta_f, se_f, lrt, conv = cdev.firth_snp_batch_dev(
                dc["y"], Gres_dev / dc["gamma_sqrt"][None, :],
                dc["firth_offset"], dc["mask"], maxstep=params.maxstep,
                niter=params.niter_max_firth, tol=2.5e-4,
            )
        else:
            beta_f, se_f, lrt, conv = firth_mod.firth_snp_batch(
                pd.phenotypes_raw[:, ph], Gres / st.gamma_sqrt[:, ph][None, :],
                st.firth_offset[:, ph], mask, maxstep=params.maxstep,
                niter=params.niter_max_firth, tol=2.5e-4,
            )
        fail_ph[idx] = ~conv
        # on failure keep the score-based beta/se (get_sumstats(true))
        bhat_ph[idx] = np.where(conv, beta_f, bhat_ph[idx])
        se_sel = np.where(conv, se_f, se_ph[idx])
        chisq_ph[idx] = np.where(conv, lrt, chisq_ph[idx])
        lp = chisq_neglog10(np.where(conv, lrt, 0.0))
        logp_ph[idx] = np.where(conv, lp, logp_ph[idx])
        if params.firth_se:
            with np.errstate(divide="ignore", invalid="ignore"):
                se_sel = np.where(
                    conv & (lrt > 0),
                    np.abs(beta_f) / np.sqrt(np.maximum(lrt, 1e-300)), se_sel
                )
        se_ph[idx] = se_sel
        return int((~conv).sum())
    if use_dev:  # SPA
        chisq_s, logp_s, fail_s = cdev.spa_batch_dev(
            stats[idx], denum[idx], Gres_dev, dc["Y_hat"], dc["gamma_sqrt"],
            dc["mask"], tol=params.tol_spa, niter_max=params.niter_max_spa,
        )
    else:
        chisq_s, logp_s, fail_s = spa_mod.spa_batch(
            stats[idx], denum[idx], Gres, st.Y_hat[:, ph], st.gamma_sqrt[:, ph],
            mask, tol=params.tol_spa, niter_max=params.niter_max_spa,
        )
    fail_ph[idx] = fail_s
    chisq_ph[idx] = np.where(~fail_s, chisq_s, chisq_ph[idx])
    logp_ph[idx] = np.where(~fail_s, logp_s, logp_ph[idx])
    se_ph[idx] = 1.0 / sqrt_denum[idx]
    bhat_ph[idx] = np.where(
        ~fail_s,
        np.sign(stats[idx]) * np.sqrt(np.maximum(chisq_s, 0)) * se_ph[idx],
        bhat_ph[idx],
    )
    return int(fail_s.sum())


def _exact_firth_snp(params, pd, y, g, offset, mask, st, ph):
    """Exact Firth LRT of one SNP (fit_firth_logistic_snp,
    Step2_Models.cpp:1062), on the host: the penalized null with the
    SNP's coefficient held at 0, started from the null logistic fit, then
    the full fit started from the null's estimates. Returns (ok, beta,
    se, lrt) of the SNP's coefficient."""
    X1 = np.column_stack([pd.new_cov, g])
    K = pd.new_cov.shape[1]
    b0 = np.zeros(K + 1)
    b0[:K] = st.bhat_start[:, ph]
    bn, _se, _dev_null, _d0, ok = firth_mod.fit_firth_multi(
        y, X1, offset, mask, b0, K, params.maxstep_null,
        params.niter_max_firth_null, 10 * params.numtol,
    )
    if not ok:
        return False, 0.0, 0.0, 0.0
    bf, se, dev_full, dev0, ok = firth_mod.fit_firth_multi(
        y, X1, offset, mask, bn, None, params.maxstep,
        params.niter_max_firth, 2.5e-4, comp_lrt=True,
    )
    if not ok:
        return False, 0.0, 0.0, 0.0
    lrt = dev0 - dev_full
    if lrt < 0:
        return False, 0.0, 0.0, 0.0
    return True, bf[-1], se[-1], lrt


def exact_firth_dev(params, pd, st, ph, G_rows):
    """Exact Firth of trait ph on the rows G_rows [S, N] (finalized
    genotypes, a float64 tensor) on their device, in groups sized to the
    free memory (corrections_device.exact_firth_batch_dev). Returns
    (ok, beta, se, lrt), numpy [S]."""
    dev = G_rows.device
    dc = dev_consts(st, pd, ph, dev)
    X = dc.get("X")
    if X is None:
        X = dc["X"] = torch.as_tensor(pd.new_cov, dtype=torch.float64, device=dev)
        dc["offset"] = dc["mask"] * torch.as_tensor(st.blups[:, ph], device=dev)
        dc["bhat_start"] = torch.as_tensor(st.bhat_start[:, ph], device=dev)
    S, N = G_rows.shape
    rows = cdev.exact_firth_rows(S, N, X.shape[1], dev)
    parts = [cdev.exact_firth_batch_dev(
        dc["y"], X, G_rows[lo : lo + rows], dc["offset"], dc["mask"],
        dc["bhat_start"], maxstep_null=params.maxstep_null,
        niter_null=params.niter_max_firth_null, tol_null=10 * params.numtol,
        maxstep=params.maxstep, niter=params.niter_max_firth, tol=2.5e-4,
        niter_line_search=params.niter_max_line_search)
        for lo in range(0, S, rows)]
    return tuple(np.concatenate(x) for x in zip(*parts))


def _exact_firth_rows(params, pd, st, ph, idx, src, out, dev):
    """Exact Firth on trait ph's rows idx (the exact branch of the JAX
    package's score_block, regenie_tpu/models/step2_bt.py:424-445),
    written into out = (bhat, se, chisq, logp, fail) [B] of the trait: on
    the block's device `dev` (exact_firth_dev) when
    corrections_device.enabled, else row by row on the host
    (_exact_firth_snp). A row that fails keeps its score-test values.
    Returns the number that failed."""
    bhat_ph, se_ph, chisq_ph, logp_ph, fail_ph = out
    G = src.rows_device(torch.as_tensor(idx, device=dev))
    if cdev.enabled(dev):
        ok, beta, se, lrt = exact_firth_dev(params, pd, st, ph, G)
    else:
        Gh = G.cpu().numpy()
        y = pd.phenotypes_raw[:, ph]
        mask = pd.masked_indivs[:, ph]
        offset = st.blups[:, ph] * mask
        res = [_exact_firth_snp(params, pd, y, Gh[i], offset, mask, st, ph)
               for i in range(len(idx))]
        ok, beta, se, lrt = (np.array(x) for x in zip(*res))
        ok = ok.astype(bool)
    fail_ph[idx] = ~ok
    bhat_ph[idx] = np.where(ok, beta, bhat_ph[idx])
    chisq_ph[idx] = np.where(ok, lrt, chisq_ph[idx])
    logp_ph[idx] = np.where(ok, chisq_neglog10(np.where(ok, lrt, 0.0)), logp_ph[idx])
    if params.firth_se:
        with np.errstate(divide="ignore", invalid="ignore"):
            se = np.where(ok & (lrt > 0), np.abs(beta) / np.sqrt(np.where(lrt > 0, lrt, 1.0)),
                          se)
    se_ph[idx] = np.where(ok, se, se_ph[idx])
    return int((~ok).sum())


def chisq_thr(alpha: float) -> float:
    """The 1-df chi-square quantile above which a test is corrected."""
    from scipy.stats import chi2

    return float(chi2.isf(alpha, df=1))
