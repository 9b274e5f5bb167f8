"""Step-2 QT score tests (the port's copy of regenie_tpu/models/step2.py),
in torch on the tensors' device: the dense route's block scorers and the
host-side tail shared with the fused scorer.

Re-implements Step2_Models.cpp score tests with the SNP axis as a tensor
dimension: compute_score_qt (Step2_Models.cpp:343) and residualize_geno
(Geno.cpp:3242) as whole-[B, N] products in float64.
"""

from __future__ import annotations

import numpy as np
import torch


def residualize_scale_block(G, cov, scale_denom):
    """Project the covariate basis out of each SNP row and scale
    (residualize_geno, Geno.cpp:3242-3262). G: [B, N]; cov: [N, K].
    Returns (G_res, scale_fac [B], low_var [B] bool)."""
    G = G - (G @ cov) @ cov.T
    scale_fac = torch.linalg.vector_norm(G, dim=1) / np.sqrt(scale_denom)
    low = scale_fac < 1e-8
    G = G / torch.where(low, 1.0, scale_fac)[:, None]
    return G, scale_fac, low


def score_qt_block(G_res, res, maskf, n_analyzed_m_ncov, strict: bool):
    """Linear score test of a block, all SNPs x traits at once
    (compute_score_qt, Step2_Models.cpp:343-460).

    G_res: [B, N] residualized and scaled genotypes; res: [N, P] scaled
    trait residuals; maskf: [N, P] float mask. Returns (stats [B, P],
    denum [B, P]), denum without the gsc^2 factor (stats =
    num_scaled / sqrt(denum))."""
    num = G_res @ res
    if strict:
        denum = torch.full_like(num, float(n_analyzed_m_ncov))
    else:
        denum = G_res**2 @ maskf  # per-trait masked sum of g^2
    return num / torch.sqrt(denum), denum


def onepass_weights(cov, res, CM):
    """W = [cov | res | CM], the one product operand of
    score_qt_block_onepass (per chromosome: res changes)."""
    return torch.cat([cov, res, CM], dim=1)


def score_qt_block_onepass(G, cov, res, maskf, CM, Mmat, covt_res,
                           scale_denom, W=None, maskf1=None):
    """Single-pass QT score test (the fused form of residualize_scale_block
    + score_qt_block): G is consumed by one product set and the covariate
    projection is applied algebraically. With A = G cov and orthonormal
    cov:
      ||G_res||^2       = ||G||^2 - ||A||^2
      (G_res' res)_p    = (G res)_p - A (cov' res)_p
      (G_res^2' m_p)    = (G^2' m_p) - 2 A.T_p + A M_p A'
    where T[b,k,p] = G (cov_k * m_p) and M_p = cov' diag(m_p) cov.

    G: [B, N] finalized genotypes; cov: [N, K] orthonormal; res: [N, P];
    maskf: [N, P]; CM: [N, K*P] = cov[:, k] * maskf[:, p] (k-major);
    Mmat: [P, K, K]; covt_res: [K, P]. W (onepass_weights) and maskf1
    ([maskf | 1]) may be passed in, cached by the caller. Returns (stats,
    denum, scale_fac, low_var), the two-step functions' contract (denum
    on the scaled-G convention)."""
    B, K, P = G.shape[0], cov.shape[1], res.shape[1]
    if W is None:
        W = onepass_weights(cov, res, CM)
    if maskf1 is None:
        maskf1 = torch.cat([maskf, torch.ones_like(maskf[:, :1])], dim=1)
    S1 = G @ W
    A = S1[:, :K]
    numY = S1[:, K : K + P]
    T = S1[:, K + P :].reshape(B, K, P)
    S2 = G**2 @ maskf1
    g2m, g2 = S2[:, :P], S2[:, P]
    scale2 = (g2 - (A**2).sum(dim=1)) / scale_denom
    scale_fac = torch.sqrt(torch.clamp(scale2, min=0.0))
    low = scale_fac < 1e-8
    num_raw = numY - A @ covt_res
    denum_raw = (g2m - 2.0 * torch.einsum("bk,bkp->bp", A, T)
                 + torch.einsum("bk,pkl,bl->bp", A, Mmat, A))
    denum_raw = torch.clamp(denum_raw, min=1e-30)
    stats = num_raw / torch.sqrt(denum_raw)
    denum = denum_raw / torch.where(low, 1.0, scale2)[:, None]
    return stats, denum, scale_fac, low


def onepass_constants(cov, maskf, res):
    """The constants of score_qt_block_onepass, on the tensors' device:
    CM [N, K*P] and Mmat [P, K, K] (per run), covt_res [K, P] (per
    chromosome)."""
    N, K = cov.shape
    P = maskf.shape[1]
    CM = (cov[:, :, None] * maskf[:, None, :]).reshape(N, K * P)
    # Mmat[p, k, l] = sum_n cov[n, k] maskf[n, p] cov[n, l] = (CM' cov)[kP + p, l]
    Mmat = (CM.T @ cov).reshape(K, P, K).permute(1, 0, 2).contiguous()
    return CM, Mmat, cov.T @ res


def finalize_qt(stats, denum, scale_fac, scf_sv, flipped=None):
    """Host-side: effect sizes/SE/chisq on the raw genotype scale
    (compute_score_qt tail, Step2_Models.cpp:440-460).

    stats, denum: [B,P]; scale_fac: [B] (gsc); scf_sv: [P].
    Returns (bhat, se, chisq) each [B,P].
    """
    stats = np.asarray(stats)
    denum = np.asarray(denum)
    gsc = np.asarray(scale_fac)[:, None]
    bhat = stats * scf_sv[None, :] / (np.sqrt(denum) * gsc)
    if flipped is not None:
        bhat = np.where(flipped[:, None], -bhat, bhat)
    se = np.abs(bhat / stats)
    chisq = stats**2
    return bhat, se, chisq
