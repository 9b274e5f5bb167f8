"""MCC (moment-matching correlation / DKAT) test for skewed QTs (the
port's copy of regenie_tpu/models/mcc.py; numpy and scipy on the host).

Re-implements the reference's --mcc path (MCC.cpp:500-645 dkat,
compute_score_qt_mcc Step2_Models.cpp:238-344): the test statistic is
D = r^2, the squared Pearson correlation between the per-trait
mask-normalized genotype and phenotype residuals. Its first three
permutation-null moments follow the Zhan et al. (2017) DKAT
moment-matching formulas on power sums of the normalized vectors, and
a location-shifted gamma gives the right-tail p-value.

Everything is vectorized over the [B] SNP block per trait: the power
sums are row reductions of the [B, N] normalized genotype matrix and
D is one matvec — there is no per-SNP loop (reference loops SNPs
serially inside OpenMP threads).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from scipy.stats import chi2, gamma


def _normalize_y(yres: np.ndarray, mask: np.ndarray, neff: np.ndarray) -> np.ndarray:
    """Center (by sum/Neff) + unit-norm each trait column under its mask
    (MCC::setup_y, MCC.cpp:114-146)."""
    maskf = mask.astype(np.float64)
    ym = yres * maskf
    means = ym.sum(axis=0) / neff
    yc = (yres - means[None, :]) * maskf
    norms = np.linalg.norm(yc, axis=0)
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(norms > 0, yc / norms[None, :], 0.0)


def dkat_pvals(
    G: np.ndarray,
    yres: np.ndarray,
    mask: np.ndarray,
    neff: np.ndarray,
    ncov: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """DKAT p-values for a genotype block vs each trait.

    G: [B, N] covariate-residualized genotypes; yres: [N, P] residualized
    phenotypes; mask: [N, P] bool; neff: [P] analyzed counts; ncov =
    number of analyzed covariates (K in MCCResults, MCC.cpp:69).

    Returns (pval [B, P], skip [B, P])."""
    B = G.shape[0]
    P = yres.shape[1]
    ynorm = _normalize_y(yres, mask, neff)
    pval = np.full((B, P), np.nan)
    skip = np.zeros((B, P), dtype=bool)

    for i in range(P):
        ni = neff[i] - ncov  # df-adjusted n (MCCResults ctor, MCC.cpp:69)
        m = mask[:, i].astype(np.float64)

        # normalize genotypes under this trait's mask: center by sum/ni,
        # unit norm, re-mask (dkat, MCC.cpp:517-528)
        Gm = G * m[None, :]
        mu = Gm.sum(axis=1) / ni
        Xc = (G - mu[:, None]) * m[None, :]
        norms = np.linalg.norm(Xc, axis=1)
        bad = norms <= 0
        with np.errstate(divide="ignore", invalid="ignore"):
            X = np.where(bad[:, None], 0.0, Xc / np.where(bad, 1.0, norms)[:, None])

        # power sums of the normalized vectors
        y = ynorm[:, i]
        T = float((y**2).sum())
        S2 = float((y**4).sum())
        S3 = float((y**6).sum())
        U = float((y**3).sum()) ** 2
        X2 = X**2
        X3 = X2 * X
        Ts = X2.sum(axis=1)
        S2s = (X2**2).sum(axis=1)
        S3s = (X3**2).sum(axis=1)
        Us = X3.sum(axis=1) ** 2
        T_sq, Ts_sq = T * T, Ts**2
        T_cub, Ts_cub = T_sq * T, Ts_sq * Ts
        T2, T2s = T_sq, Ts_sq  # (sum y^2)^2 convention, MCC.cpp:183
        T3, T3s = T_cub, Ts_cub
        R = T * S2
        Rs = Ts * S2s
        Bv, Bs = U, Us

        # observed statistic: squared Pearson correlation
        D = (X @ y) ** 2

        # ---- permutation-null moments (Zhan et al. DKAT; MCC.cpp:544-614)
        n1, n2_, n3 = ni - 1.0, ni - 2.0, ni - 3.0
        p1, p4 = ni + 1.0, ni + 4.0
        nsq = ni * ni
        ncub = nsq * ni
        nquad = nsq * nsq

        m1 = Ts * T / ni

        v_t1 = 2.0 * (n1 * T2 - T_sq) * (n1 * T2s - Ts_sq) / (n1 * n1 * p1 * n2_)
        v_a = ni * p1 * S2 - n1 * (T_sq + 2 * T2)
        v_b = ni * p1 * S2s - n1 * (Ts_sq + 2 * T2s)
        m2 = v_t1 + v_a * v_b / (p1 * ni * n1 * n2_ * n3)

        t1 = nsq * p1 * (nsq + 15 * ni - 4) * S3 * S3s
        t2 = 4 * (nquad - 8 * ncub + 19 * nsq - 4 * ni - 16) * U * Us
        t3 = 24 * (nsq - ni - 4) * (U * Bs + Bv * Us)
        t4 = 6 * (nquad - 8 * ncub + 21 * nsq - 6 * ni - 24) * Bv * Bs
        t5 = 12 * (nquad - ncub - 8 * nsq + 36 * ni - 48) * R * Rs
        t6 = 12 * (ncub - 2 * nsq + 9 * ni - 12) * (T * S2 * Rs + R * Ts * S2s)
        t7 = 3 * (nquad - 4 * ncub - 2 * nsq + 9 * ni - 12) * T * Ts * S2 * S2s
        t8 = 24 * (
            (ncub - 3 * nsq - 2 * ni + 8) * (R * Us + U * Rs)
            + (ncub - 2 * nsq - 3 * ni + 12) * (R * Bs + Bv * Rs)
        )
        t9 = 12 * (nsq - ni + 4) * (T * S2 * Us + U * Ts * S2s)
        t10 = 6 * (2 * ncub - 7 * nsq - 3 * ni + 12) * (T * S2 * Bs + Bv * Ts * S2s)
        t11 = -2 * ni * n1 * (nsq - ni + 4) * (
            (2 * U + 3 * Bv) * S3s + (2 * Us + 3 * Bs) * S3
        )
        t12 = -3 * ni * n1 * n1 * p4 * (
            (T * S2 + 4 * R) * S3s + (Ts * S2s + 4 * Rs) * S3
        )
        t13 = 2 * ni * n1 * n2_ * (
            (T_cub + 6 * T * T2 + 8 * T3) * S3s
            + (Ts_cub + 6 * Ts * T2s + 8 * T3s) * S3
        )
        t14 = T_cub * (
            (ncub - 9 * nsq + 23 * ni - 14) * Ts_cub
            + 6 * (ni - 4) * Ts * T2s + 8 * T3s
        )
        t15 = 6 * T * T2 * (
            (ni - 4) * Ts_cub + (ncub - 9 * nsq + 24 * ni - 14) * Ts * T2s
            + 4 * n3 * T3s
        )
        t16 = 8 * T3 * (
            Ts_cub + 3 * n3 * Ts * T2s + (ncub - 9 * nsq + 26 * ni - 22) * T3s
        )
        t17 = -16 * (T_cub * Us + U * Ts_cub) - 6 * (T * T2 * Us + U * Ts * T2s) * (
            2 * nsq - 10 * ni + 16
        )
        t18 = -8 * (T3 * Us + U * T3s) * (3 * nsq - 15 * ni + 16) - (
            T_cub * Bs + Bv * Ts_cub
        ) * (6 * nsq - 30 * ni + 24)
        t19 = -6 * (T * T2 * Bs + Bv * Ts * T2s) * (4 * nsq - 20 * ni + 24) - 8 * (
            T3 * Bs + Bv * T3s
        ) * (3 * nsq - 15 * ni + 24)
        t20 = -n2_ * (
            24 * (T_cub * Rs + R * Ts_cub)
            + 6 * (T * T2 * Rs + R * Ts * T2s) * (2 * nsq - 10 * ni + 24)
            + 8 * (T3 * Rs + R * T3s) * (3 * nsq - 15 * ni + 24)
            + (3 * nsq - 15 * ni + 6) * (T_cub * Ts * S2s + T * S2 * Ts_cub)
            + 6 * (T * T2 * Ts * S2s + Ts * T2s * T * S2) * (nsq - 5 * ni + 6)
            + 48 * (T3 * Ts * S2s + T3s * T * S2)
        )
        mom3_raw = (
            t1 + t2 + t3 + t4 + t5 + t6 + t7 + t8 + t9 + t10 + t11 + t12 + t13
            + t14 + t15 + t16 + t17 + t18 + t19 + t20
        ) / (ni * n1 * n2_ * n3 * (n3 - 1) * (n3 - 2))
        with np.errstate(divide="ignore", invalid="ignore"):
            skw = (mom3_raw - 3 * m1 * m2 - m1**3) / m2**1.5

            # gamma(shape, scale) shifted by location (MCC.cpp:616-637)
            shape = 4.0 / skw**2
            scale = np.sqrt(m2) * skw / 2.0
            loc = m1 - 2.0 * np.sqrt(m2) / skw
            q = D - loc
            pv = np.where(
                q < 0, 0.99999,
                gamma.sf(np.maximum(q, 0.0), shape, scale=np.abs(scale)),
            )

        ok = (~bad) & np.isfinite(pv) & (scale > 0) & np.isfinite(shape)
        pval[:, i] = np.where(ok, pv, np.nan)
        skip[:, i] = ~ok
    return pval, skip


def apply_mcc_qt(params, pd, G_res, yres, logp, se, chisq) -> np.ndarray:
    """Overwrite score-test p-values with MCC p-values and rescale SEs
    (compute_score_qt_mcc, Step2_Models.cpp:274-312). chisq column keeps
    the score statistic (only pval_log and se_b change in the reference).

    Two regimes: mcc_thr == 1 -> MCC everywhere; mcc_thr < 1 -> score
    first, MCC only where -log10 p exceeds the threshold AND the trait
    is flagged skewed (pheno mcc_Y). G_res: the [B, N] block, a host array
    or a tensor on any device. Returns test_fail [B, P]."""
    B, P = logp.shape
    test_fail = np.zeros((B, P), dtype=bool)
    mcc_y = getattr(pd, "mcc_Y", np.ones(P, dtype=bool))

    if params.mcc_apply_thr:
        need = (logp > params.mcc_thr_nlog10) & mcc_y[None, :]
    else:
        need = np.ones((B, P), dtype=bool) & mcc_y[None, :]
    if not need.any():
        return test_fail

    # only run DKAT on rows that need it (threshold mode usually few)
    rows = np.flatnonzero(need.any(axis=1))
    pval = np.full((B, P), np.nan)
    skip = np.ones((B, P), dtype=bool)
    if isinstance(G_res, torch.Tensor):
        # a block on the device: only the rows DKAT reads come back
        G_rows = G_res[torch.as_tensor(rows, device=G_res.device)].cpu().numpy()
    else:
        G_rows = np.asarray(G_res, dtype=np.float64)[rows]
    pval[rows], skip[rows] = dkat_pvals(
        G_rows, yres, pd.masked_indivs, pd.Neff, params.ncov_analyzed,
    )
    upd = need & ~skip
    with np.errstate(divide="ignore", invalid="ignore"):
        chisq_adj = chi2.isf(np.clip(pval, 5e-324, 1.0), df=1)
        ratio = np.sqrt(np.where(chisq_adj > 0, chisq / chisq_adj, 1.0))
        logp_new = -np.log10(np.clip(pval, 5e-324, 1.0))
    logp[upd] = logp_new[upd]
    se[upd] *= ratio[upd]
    fail = need & skip
    logp[fail] = -1
    test_fail |= fail
    return test_fail
