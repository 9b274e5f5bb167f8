"""Step 1: stacked block ridge regression (the port's copy of the QT
functions of regenie_tpu/models/step1.py).

Re-implements the math of the reference's Step1_Models.cpp as batched
torch operations on the tensors' device (float64 on the card: DGEMM on
the FP64 tensor cores, batched `torch.linalg.eigh`):

- level-0 K-fold ridge (ridge_level_0, Step1_Models.cpp:458): per-block
  Gram matrices per fold, a BATCHED eigendecomposition over the K
  leave-fold-out Gram matrices, and a joint solve for all (lambda,
  pheno) at once. It is split into its stages (kfold_grams, kfold_eigh,
  kfold_beta, kfold_predict) so that each can be timed on its own.
- level-0 LOOCV (ridge_level_0_loocv, :615): one eigendecomposition per
  block and closed-form leave-one-out predictions, batched over a group
  of blocks.
- level-1 linear ridge, K-fold (:772) and LOOCV (:875), and the LOOCV
  whole-data refit (make_predictions_loocv, Data.cpp:1269).

Every loop of the reference over folds, ridge parameters and samples is
a tensor axis; folds are padded to a common size so one batched product
covers all folds. Nothing here holds state: plain functions of tensors.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

# ---------------------------------------------------------------------------
# fold layout
# ---------------------------------------------------------------------------


def compute_fold_sizes(ind_in_analysis: np.ndarray, cv_folds: int) -> np.ndarray:
    """Contiguous fold sizes in SAMPLE coordinates (reference set_folds,
    Data.cpp:401): walk samples in file order, close a fold every
    floor(n_analyzed/K) analyzed samples; the last fold takes the rest."""
    n_samples = len(ind_in_analysis)
    n_analyzed = int(ind_in_analysis.sum())
    target = n_analyzed // cv_folds
    if target < 1:
        raise ValueError(f"not enough samples for {cv_folds}-fold CV")
    sizes = np.ones(cv_folds, dtype=np.int64)
    n_non_miss = 0
    cum = 0
    cur = 0
    for i in range(n_samples):
        if ind_in_analysis[i]:
            n_non_miss += 1
        if n_non_miss == target:
            sizes[cur] = i - cum + 1
            cum += sizes[cur]
            n_non_miss = 0
            cur += 1
        elif cur == cv_folds - 1:
            sizes[cur] = n_samples - i
            break
    return sizes


def pad_folds(arr: np.ndarray, sizes: np.ndarray, axis: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Split `arr` along `axis` into contiguous folds, pad to max size.

    Returns (stacked [K, nmax, ...], valid [K, nmax] bool).
    """
    K = len(sizes)
    nmax = int(sizes.max())
    bounds = np.concatenate([[0], np.cumsum(sizes)])
    pieces = []
    valid = np.zeros((K, nmax), dtype=bool)
    for k in range(K):
        sl = [slice(None)] * arr.ndim
        sl[axis] = slice(bounds[k], bounds[k + 1])
        piece = arr[tuple(sl)]
        pad_width = [(0, 0)] * arr.ndim
        pad_width[axis] = (0, nmax - int(sizes[k]))
        pieces.append(np.pad(piece, pad_width))
        valid[k, : int(sizes[k])] = True
    return np.stack(pieces), valid


def fold_index(sizes: np.ndarray) -> np.ndarray:
    """[K, nmax] sample index of each fold slot: folds are contiguous
    sample ranges; pad slots point at sample 0 (the level-0 kernels zero
    them through `valid`)."""
    idx = np.zeros((len(sizes), int(sizes.max())), np.int64)
    pos = 0
    for k, szk in enumerate(sizes):
        idx[k, :szk] = pos + np.arange(szk)
        pos += int(szk)
    return idx


# ---------------------------------------------------------------------------
# genotype residualization
# ---------------------------------------------------------------------------


def residualize_geno_block(G: torch.Tensor, cov: torch.Tensor,
                           scale_denom: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Project the covariate basis out of each SNP row and scale to unit
    variance (reference residualize_genotypes, Data.cpp:190-222).

    G: [B, N] (already masked to in-analysis samples), cov: [N, K]
    orthonormal basis, scale_denom: n_analyzed - ncov.
    Returns (G_res [B, N], scale_G [B]).
    """
    G = torch.addmm(G, G @ cov, cov.T, alpha=-1.0)
    scale_G = torch.linalg.vector_norm(G, dim=1) / float(np.sqrt(scale_denom))
    return G / scale_G[:, None], scale_G


# ---------------------------------------------------------------------------
# level 0
# ---------------------------------------------------------------------------


def kfold_grams(G_folds, Y_folds, valid):
    """Per-fold Gram and cross products (Data.cpp:729-767). G_folds
    [K, B, nmax], Y_folds [K, nmax, P], valid [K, nmax] float. Returns
    (G_folds zeroed on pad slots, GGt_f [K, B, B], GtY_f [K, B, P])."""
    Gv = G_folds * valid[:, None, :]
    return Gv, Gv @ Gv.transpose(1, 2), Gv @ Y_folds


def kfold_eigh(GGt_f):
    """Eigendecomposition of the K leave-fold-out Gram matrices, batched:
    (d [K, B], V [K, B, B])."""
    return torch.linalg.eigh(GGt_f.sum(dim=0)[None] - GGt_f)


def kfold_beta(d, V, GtY_f, lambdas):
    """Ridge solutions of every fold for all lambdas: [K, J, B, P]."""
    ww2 = V.transpose(1, 2) @ (GtY_f.sum(dim=0)[None] - GtY_f)  # [K, B, P]
    inv = 1.0 / (d[:, None, :] + lambdas[None, :, None])  # [K, J, B]
    return V[:, None] @ (inv[..., None] * ww2[:, None])


def kfold_predict(beta, Gv, mask_folds, Neff):
    """Out-of-fold predictions on each held fold, masked per trait,
    centred and scaled over the whole sample (Step1_Models.cpp:539-560):
    W [K, nmax, J, P] (pad rows hold -mean*invsd, like the reference's
    dense test_mat after centring)."""
    K, J, B, P = beta.shape
    pred = Gv.transpose(1, 2) @ beta.permute(0, 2, 1, 3).reshape(K, B, J * P)
    pred = pred.view(K, -1, J, P) * mask_folds[:, :, None, :]
    p_sum = pred.sum(dim=(0, 1))  # [J, P]
    p_sum2 = (pred * pred).sum(dim=(0, 1))
    p_mean = p_sum / Neff[None, :]
    p_invsd = torch.sqrt((Neff[None, :] - 1.0) / (p_sum2 - Neff[None, :] * p_mean**2))
    return (pred - p_mean) * p_invsd


def level0_kfold_block(G_folds, Y_folds, mask_folds, valid, lambdas, Neff):
    """Level-0 K-fold ridge for one genotype block, all folds, ridge
    parameters and phenotypes batched (reference ridge_level_0,
    Step1_Models.cpp:458-560).

    G_folds: [K, B, nmax] genotypes split by fold (pad slots arbitrary)
    Y_folds: [K, nmax, P] residualized phenotypes by fold
    mask_folds: [K, nmax, P] per-trait masks by fold (float 0/1)
    valid: [K, nmax] padding mask (float 0/1)
    lambdas: [J] ridge penalties; Neff: [P] per-trait sample counts
    Returns W: [K, nmax, J, P] centred and scaled out-of-fold predictions.
    """
    Gv, GGt_f, GtY_f = kfold_grams(G_folds, Y_folds, valid)
    d, V = kfold_eigh(GGt_f)
    return kfold_predict(kfold_beta(d, V, GtY_f, lambdas), Gv, mask_folds, Neff)


def level0_loocv_blocks(G3, Y, mask, lambdas, Neff):
    """Level-0 LOOCV ridge (ridge_level_0_loocv, Step1_Models.cpp:615-723)
    over a stacked [n, B, N] group of blocks: ONE batched [n, B, B] eigh
    and batched products, vectorized over samples, ridge parameters and
    phenotypes. No block's W depends on another's.

    Y: [N, P]; mask: [N, P] float. Returns W: [n, N, J, P] centred and
    scaled within-block predictions.
    """
    n, B, N = G3.shape
    P, J = Y.shape[1], lambdas.shape[0]
    d, V = torch.linalg.eigh(G3 @ G3.transpose(1, 2))
    Vt = V.transpose(1, 2)
    Wmat = Vt @ (G3 @ Y)  # [n, B, P]
    DL_inv = 1.0 / (d[:, :, None] + lambdas[None, None, :])  # [n, B, J]
    VtG = Vt @ G3  # [n, B, N]
    # gvec[n,j] = sum_b VtG[b,n]^2 / (d_b + lambda_j)
    gvec = (VtG * VtG).transpose(1, 2) @ DL_inv  # [n, N, J]
    # z2t[n,j,p] = sum_b VtG[b,n] * DL_inv[b,j] * Wmat[b,p]
    z2t = VtG.transpose(1, 2) @ (DL_inv[..., None] * Wmat[:, :, None, :]).reshape(n, B, J * P)
    z2t = z2t.view(n, N, J, P)
    pred = (z2t - gvec[..., None] * Y[None, :, None, :]) / (1.0 - gvec)[..., None]

    # centre and scale within the block (mask first)
    m = mask[None, :, None, :]
    pred = pred * m
    p_mean = pred.sum(dim=1, keepdim=True) / Neff
    pred = (pred - p_mean) * m
    p_sd = torch.sqrt((pred * pred).sum(dim=1, keepdim=True) / (Neff - 1.0))
    return pred / p_sd


def level0_loocv_block(G, Y, mask, lambdas, Neff):
    """level0_loocv_blocks on one [B, N] block: W [N, J, P]."""
    return level0_loocv_blocks(G[None], Y, mask, lambdas, Neff)[0]


# ---------------------------------------------------------------------------
# level 1 (linear / QT)
# ---------------------------------------------------------------------------


def _ridge_inv(d, taus, ridge_mult):
    """1 / (d + tau * mult) for every tau: [..., T, F] (--select-l0's
    per-column multiplier is eigenvalue-aligned as in the reference,
    Step1_Models.cpp:833)."""
    pen = taus[:, None] if ridge_mult is None else taus[:, None] * ridge_mult[None, :]
    return 1.0 / (d.unsqueeze(-2) + pen)


def level1_linear_kfold(W_folds, Y_folds, valid, taus,
                        ridge_mult: Optional[torch.Tensor] = None):
    """Level-1 linear ridge with K-fold CV for ONE phenotype
    (ridge_level_1, Step1_Models.cpp:772-870).

    W_folds: [K, nmax, F] level-0 predictions by fold (F = blocks*J)
    Y_folds: [K, nmax] residualized phenotype by fold
    valid: [K, nmax] padding mask; taus: [T] ridge penalties
    ridge_mult: [F] per-column penalty multiplier
    Returns (beta [K, T, F] per-fold solutions, cumsum [5, T] CV metrics
    Sx, Sy, Sx2, Sy2, Sxy over held-out folds).
    """
    Wv = W_folds * valid[:, :, None]
    Yv = Y_folds * valid
    XtX_f = Wv.transpose(1, 2) @ Wv  # [K, F, F]
    XtY_f = (Wv.transpose(1, 2) @ Yv[:, :, None])[..., 0]  # [K, F]
    d, V = torch.linalg.eigh(XtX_f.sum(dim=0)[None] - XtX_f)
    VtX2 = (V.transpose(1, 2) @ (XtY_f.sum(dim=0)[None] - XtY_f)[:, :, None])[..., 0]
    inv = _ridge_inv(d, taus, ridge_mult)  # [K, T, F]
    beta = (inv * VtX2[:, None, :]) @ V.transpose(1, 2)  # [K, T, F]

    # held-out predictions and CV metrics
    p1 = Wv @ beta.transpose(1, 2)  # [K, nmax, T]
    Sx = p1.sum(dim=(0, 1))
    Sy = Yv.sum().expand_as(Sx)
    Sx2 = (p1 * p1).sum(dim=(0, 1))
    Sy2 = (Yv * Yv).sum().expand_as(Sx)
    Sxy = (p1 * Yv[:, :, None]).sum(dim=(0, 1))
    return beta, torch.stack([Sx, Sy, Sx2, Sy2, Sxy])


def level1_linear_loocv(W, Y, taus, neff_m_ncov: float,
                        ridge_mult: Optional[torch.Tensor] = None):
    """Level-1 linear ridge LOOCV for ONE phenotype
    (ridge_level_1_loocv, Step1_Models.cpp:875-962).

    W: [N, F]; Y: [N]; taus: [T]; neff_m_ncov: Neff - ncov (for Sy2);
    ridge_mult: [F] per-column penalty multiplier.
    Returns cumsum [5, T] metrics (Sy = 0 by centring; Sy2 = neff - ncov).
    """
    d, V = torch.linalg.eigh(W.T @ W)
    zvec = V.T @ (W.T @ Y)  # [F]
    tmp = W @ V  # [N, F]
    inv = _ridge_inv(d, taus, ridge_mult)  # [T, F]
    cal = (tmp * tmp) @ inv.T  # [N, T]
    pred = tmp @ (inv * zvec[None, :]).T  # [N, T]
    pred = (pred - cal * Y[:, None]) / (1.0 - cal)
    Sx = pred.sum(dim=0)
    Sx2 = (pred * pred).sum(dim=0)
    Sxy = (pred * Y[:, None]).sum(dim=0)
    return torch.stack([Sx, torch.zeros_like(Sx), Sx2,
                        torch.full_like(Sx, neff_m_ncov), Sxy])


def level1_linear_full_fit_loocv(W, Y, tau: float,
                                 ridge_mult: Optional[torch.Tensor] = None):
    """Whole-data ridge refit + per-sample LOO betas for LOCO predictions
    (make_predictions_loocv, Data.cpp:1269-1345; per-column penalty
    diagonal when --select-l0 is active, Data.cpp:1297).

    Returns (b0 [F, N] per-left-out-sample coefficient vectors, bvec [F]).
    """
    F = W.shape[1]
    pen = torch.full((F,), tau, dtype=W.dtype, device=W.device)
    if ridge_mult is not None:
        pen = pen * ridge_mult
    d, V = torch.linalg.eigh(W.T @ W + torch.diag(pen))
    tmpMat = (V / d[None, :]) @ V.T  # (X'X + tau I)^-1
    bvec = tmpMat @ (W.T @ Y)  # [F]
    yres = Y - W @ bvec  # [N]
    HX = tmpMat @ W.T  # [F, N]
    cal = (W.T * HX).sum(dim=0)  # [N]
    return bvec[:, None] - HX * (yres / (1.0 - cal))[None, :], bvec


def select_best_tau_qt(cumsum: np.ndarray, neff: float) -> int:
    """Pick ridge parameter minimizing CV MSE (Data.cpp:1023-1037)."""
    sse = cumsum[2] + cumsum[3] - 2 * cumsum[4]
    return int(np.argmin(sse / neff))


def cv_rsq(cumsum: np.ndarray, neff: float) -> np.ndarray:
    """CV R^2 per tau (Data.cpp:1058-1062)."""
    Sx, Sy, Sx2, Sy2, Sxy = cumsum[:5]
    num = Sxy - Sx * Sy / neff
    den = (Sx2 - Sx**2 / neff) * (Sy2 - Sy**2 / neff)
    return num**2 / den
