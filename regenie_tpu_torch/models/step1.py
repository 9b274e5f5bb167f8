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
  whole-data refit (make_predictions_loocv, Data.cpp:1269), with
  --select-l0's per-column penalties and --test-l0's top-SNP PGS;
- level 1 over a mesh's shards (the level-1 functions' `mesh`): the
  design's rows zero-padded to the shard count and split, its row sums
  (W'W, W'y, the CV sums) summed over the shards in shard order on the
  first shard's device, the row-wise results kept a shard each (without
  a mesh, one part on the design's own device: one body for both);
- --print's per-SNP level-0 betas (level0_loocv_block_betas), and on the
  host in numpy --select-l0's block selection (check_l0_selection) and
  --test-l0's top-SNP pre-screen (test_l0_block).

Every loop of the reference over folds, ridge parameters and samples is
a tensor axis; folds are padded to a common size so one batched product
covers all folds. Nothing here holds state: plain functions of tensors.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..parallel import mesh as pm

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


def level0_loocv_block_betas(G, Y, mask, lambdas, Neff):
    """level0_loocv_block and, for --print, the block's per-SNP level-0
    betas of the first trait (beta_snp_step1 capture,
    Step1_Models.cpp:644, standardized like W as at :713). Returns (W
    [N, J, P], beta_snp [B, J] on the scaled-genotype scale)."""
    d, V = torch.linalg.eigh(G @ G.T)
    Wmat = V.T @ (G @ Y)  # [B, P]
    DL_inv = 1.0 / (d[:, None] + lambdas[None, :])  # [B, J]
    beta_snp = V @ (DL_inv * Wmat[:, :1])  # [B, J]
    W = level0_loocv_block(G, Y, mask, lambdas, Neff)
    # the first trait's prediction sd within the block, as W's scaling
    VtG = V.T @ G
    gvec = (VtG * VtG).T @ DL_inv  # [N, J]
    z2t = VtG.T @ (DL_inv * Wmat[:, :1])  # [N, J]
    pred = (z2t - gvec * Y[:, :1]) / (1.0 - gvec)
    m = mask[:, :1]
    pred = pred * m
    pred = (pred - pred.sum(dim=0) / Neff[0]) * m
    p_sd = torch.sqrt((pred * pred).sum(dim=0) / (Neff[0] - 1.0))
    return W, beta_snp / p_sd[None, :]


# ---------------------------------------------------------------------------
# level 1 (linear / QT)
# ---------------------------------------------------------------------------


def _ridge_inv(d, taus, ridge_mult):
    """1 / (d + tau * mult) for every tau: [..., T, F] (--select-l0's
    per-column multiplier is eigenvalue-aligned as in the reference,
    Step1_Models.cpp:833)."""
    pen = taus[:, None] if ridge_mult is None else taus[:, None] * ridge_mult[None, :]
    return 1.0 / (d.unsqueeze(-2) + pen)


def _l1_mesh(mesh, x):
    """The mesh of a level-1 call: `mesh`, or a mesh of x's own device
    alone, whose one part is x itself (shard, replicate and psum pass it
    through unchanged)."""
    return pm.Mesh([x.device]) if mesh is None else mesh


def level1_linear_kfold(W_folds, Y_folds, valid, taus,
                        ridge_mult: Optional[torch.Tensor] = None, pgs_folds=None,
                        mesh=None):
    """Level-1 linear ridge with K-fold CV for ONE phenotype
    (ridge_level_1, Step1_Models.cpp:772-870).

    W_folds: [K, nmax, F] level-0 predictions by fold (F = blocks*J)
    Y_folds: [K, nmax] residualized phenotype by fold
    valid: [K, nmax] padding mask; taus: [T] ridge penalties
    ridge_mult: [F] per-column penalty multiplier (--select-l0)
    pgs_folds: [K, nmax] --test-l0's top-SNP PGS, removed from the response
    Returns (beta [K, T, F] per-fold solutions, cumsum [5, T] CV metrics
    Sx, Sy, Sx2, Sy2, Sxy over held-out folds[, cumsum_full [5, T] with
    the PGS added back, against the original response]).
    With `mesh` (parallel/mesh.py), the fold slots (nmax) of W_folds,
    Y_folds, valid and pgs_folds are split over the shards (zero-padded,
    valid 0: exact; or given as per-shard parts), and the results land
    on the first shard's device (the JAX package's place_rows_padded on
    axis 1, regenie_tpu/run_step1.py:689-705).
    """
    mesh = _l1_mesh(mesh, W_folds)
    Vs, Ys = pm._parts(mesh, valid, 1), pm._parts(mesh, Y_folds, 1)
    Wv = [w * v[:, :, None] for w, v in zip(pm._parts(mesh, W_folds, 1), Vs)]
    Yo = [y * v for y, v in zip(Ys, Vs)]
    Ps = None if pgs_folds is None else pm._parts(mesh, pgs_folds, 1)
    Yv = Yo if Ps is None else [(y - p) * v for y, p, v in zip(Ys, Ps, Vs)]
    XtX_f = pm.psum([w.transpose(1, 2) @ w for w in Wv], mesh)  # [K, F, F]
    XtY_f = pm.psum([(w.transpose(1, 2) @ y[:, :, None])[..., 0]
                     for w, y in zip(Wv, Yv)], mesh)  # [K, F]
    d, V = torch.linalg.eigh(XtX_f.sum(dim=0)[None] - XtX_f)
    VtX2 = (V.transpose(1, 2) @ (XtY_f.sum(dim=0)[None] - XtY_f)[:, :, None])[..., 0]
    inv = _ridge_inv(d, taus.to(d.device), ridge_mult)  # [K, T, F]
    beta = (inv * VtX2[:, None, :]) @ V.transpose(1, 2)  # [K, T, F]

    # held-out predictions and CV metrics, summed over the shards
    T = beta.shape[1]
    parts = []
    for i, (w, b) in enumerate(zip(Wv, pm.replicate(mesh, beta))):
        p1 = w @ b.transpose(1, 2)  # [K, n, T]
        y = Yv[i]
        cols = [p1.sum(dim=(0, 1)), y.sum().expand(T), (p1 * p1).sum(dim=(0, 1)),
                (y * y).sum().expand(T), (p1 * y[:, :, None]).sum(dim=(0, 1))]
        if Ps is not None:
            yo, pf = Yo[i], p1 + (Ps[i] * Vs[i])[:, :, None]
            cols += [pf.sum(dim=(0, 1)), yo.sum().expand(T), (pf * pf).sum(dim=(0, 1)),
                     (yo * yo).sum().expand(T), (pf * yo[:, :, None]).sum(dim=(0, 1))]
        parts.append(torch.stack(cols))
    S = pm.psum(parts, mesh)
    return (beta, S[:5]) if Ps is None else (beta, S[:5], S[5:10])


def _loo_pred(W, Yfit, V, inv, izvec):
    """The LOO predictions [n, T] of rows W [n, F] of a LOOCV level 1."""
    tmp = W @ V  # [n, F]
    cal = (tmp * tmp) @ inv.T  # [n, T]
    pred = tmp @ izvec.T  # [n, T]
    return (pred - cal * Yfit[:, None]) / (1.0 - cal)


def level1_linear_loocv(W, Y, taus, neff_m_ncov: float,
                        ridge_mult: Optional[torch.Tensor] = None, pgs=None,
                        mesh=None):
    """Level-1 linear ridge LOOCV for ONE phenotype
    (ridge_level_1_loocv, Step1_Models.cpp:875-962).

    W: [N, F]; Y: [N]; taus: [T]; neff_m_ncov: Neff - ncov (for Sy2);
    ridge_mult: [F] per-column penalty multiplier (--select-l0); pgs: [N]
    --test-l0's top-SNP PGS removed from the response (Step1_Models.cpp:914).
    Returns cumsum [5, T] metrics (Sy = 0 by centring; Sy2 = neff - ncov,
    or with pgs the sum of squares of Y - pgs, no longer standardized,
    :946), plus cumsum_full [5, T] against Y with the PGS added back when
    pgs is given. With `mesh`, the rows of W, Y and pgs are split over
    the shards (zero-padded, or given as per-shard parts; a zero row adds
    nothing) and the results land on the first shard's device
    (regenie_tpu/run_step1.py:641-673).
    """
    mesh = _l1_mesh(mesh, W)
    Ws, Ys = pm._parts(mesh, W, 0), pm._parts(mesh, Y, 0)
    Ps = None if pgs is None else pm._parts(mesh, pgs, 0)
    Yf = Ys if Ps is None else [y - p for y, p in zip(Ys, Ps)]
    d, V = torch.linalg.eigh(pm.psum([w.T @ w for w in Ws], mesh))
    zvec = V.T @ pm.psum([w.T @ y for w, y in zip(Ws, Yf)], mesh)  # [F]
    inv = _ridge_inv(d, taus.to(d.device), ridge_mult)  # [T, F]
    T = inv.shape[0]
    parts = []
    for i, (w, (V_s, inv_s, iz_s)) in enumerate(
            zip(Ws, pm.replicate(mesh, (V, inv, inv * zvec[None, :])))):
        yf = Yf[i]
        pred = _loo_pred(w, yf, V_s, inv_s, iz_s)
        cols = [pred.sum(dim=0), (pred * pred).sum(dim=0),
                (pred * yf[:, None]).sum(dim=0), (yf * yf).sum().expand(T)]
        if Ps is not None:
            y, pf = Ys[i], pred + Ps[i][:, None]
            cols += [pf.sum(dim=0), y.sum().expand(T), (pf * pf).sum(dim=0),
                     (y * y).sum().expand(T), (pf * y[:, None]).sum(dim=0)]
        parts.append(torch.stack(cols))
    S = pm.psum(parts, mesh)
    Sx = S[0]
    Sy2 = torch.full_like(Sx, neff_m_ncov) if Ps is None else S[3]
    cs = torch.stack([Sx, torch.zeros_like(Sx), S[1], Sy2, S[2]])
    return cs if Ps is None else (cs, S[4:9])


def level1_linear_full_fit_loocv(W, Y, tau: float,
                                 ridge_mult: Optional[torch.Tensor] = None,
                                 mesh=None):
    """Whole-data ridge refit + per-sample LOO betas for LOCO predictions
    (make_predictions_loocv, Data.cpp:1269-1345; per-column penalty
    diagonal when --select-l0 is active, Data.cpp:1297).

    Returns (b0, bvec [F]): b0 the per-left-out-sample coefficient
    vectors, a list of each shard's [F, n_shard] columns on its device
    (the pad samples' last; without `mesh` one [F, N] part). W's and Y's
    rows are split over `mesh` as in level1_linear_loocv, and bvec lands
    on the first shard's device.
    """
    mesh = _l1_mesh(mesh, W)
    Ws, Ys = pm._parts(mesh, W, 0), pm._parts(mesh, Y, 0)
    XtX = pm.psum([w.T @ w for w in Ws], mesh)
    F = XtX.shape[0]
    pen = torch.full((F,), tau, dtype=XtX.dtype, device=XtX.device)
    if ridge_mult is not None:
        pen = pen * ridge_mult
    d, V = torch.linalg.eigh(XtX + torch.diag(pen))
    tmpMat = (V / d[None, :]) @ V.T  # (X'X + tau I)^-1
    bvec = tmpMat @ pm.psum([w.T @ y for w, y in zip(Ws, Ys)], mesh)  # [F]
    b0 = []
    for w, y, (t, b) in zip(Ws, Ys, pm.replicate(mesh, (tmpMat, bvec))):
        yres = y - w @ b  # [n]
        HX = t @ w.T  # [F, n]
        cal = (w.T * HX).sum(dim=0)  # [n]
        b0.append(b[:, None] - HX * (yres / (1.0 - cal))[None, :])
    return b0, bvec


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


# ---------------------------------------------------------------------------
# level-0 selection and the top-SNP pre-screen (host, numpy)
# ---------------------------------------------------------------------------


def check_l0_selection(params, pv, log, silent=False):
    """--select-l0 / --rm-l0-pct level-0 block selection for one trait
    (check_l0, Step1_Models.cpp:1989-2065).

    pv: [NB] -log10 p per level-0 block (larger = stronger association).
    Returns (colkeep [NB*J] bool, ridge_mult [NB*J]): with --rm-l0-pct
    the least significant x% of blocks lose all their J predictors;
    otherwise strongly-associated blocks (Beta order-statistic outliers)
    keep only their min-shrinkage column, unpenalized (mult=0).
    """
    J = params.n_ridge_l0
    NB = len(pv)
    colkeep = np.ones(NB * J, dtype=bool)
    mult = np.ones(NB * J)
    qv = np.sort(np.asarray(pv, dtype=np.float64))
    if not silent:
        log("   -checking level 0 predictors for strength of associations "
            "with phenotype...")
    if params.rm_l0_pct != 0:
        n_rm = int(NB * (params.rm_l0_pct / 100.0))
        if n_rm >= NB:
            raise ValueError("invalid proportion specified for --rm-l0-pct")
        if not silent:
            log(f"   -removing the least {params.rm_l0_pct}% significant "
                "block level 0 predictors...")
        if n_rm >= 1:
            thr = qv[n_rm - 1]
            for i in range(NB):
                if pv[i] <= thr:
                    colkeep[i * J : (i + 1) * J] = False
        return colkeep, mult

    # adaptive: kth order statistic of U(0,1) p-values is Beta(k, NB-k)
    from scipy.stats import beta as _beta

    conf_alpha = 0.05 / NB
    thr = qv[NB - 1] + 1e-6
    for i in range(NB - 1):
        beta_q = -np.log10(_beta.ppf(conf_alpha / 2.0, i + 1, NB - i - 1))
        if (qv[NB - i - 1] < beta_q) or (i == NB - 2):
            if i > 0:
                thr = qv[NB - i]
            break
    ntop = int(np.ceil(0.05 * NB))
    q1, q2 = NB // 4, NB // 2
    q3 = q1 + q2
    if (pv >= thr).sum() >= ntop:
        iqr = qv[q3] - qv[q1]
        thr = max(thr, qv[q3] + 3 * iqr)
    if (pv >= thr).sum() >= ntop:
        thr = qv[NB - ntop]
    if not silent:
        log(f"   -{int((pv >= thr).sum())}/{NB} blocks selected "
            f"(Upper bound = {thr:.6g})...")
    for i in range(NB):
        if pv[i] >= thr:  # keep only the last (min shrinkage) ridge column
            colkeep[i * J : (i + 1) * J - 1] = False
            mult[(i + 1) * J - 1] = 0.0
    return colkeep, mult


def test_l0_block(params, Gn, Y, nspns_prev, log):
    """--test-l0 pre-screen (test_assoc_block + apply_iter_cond,
    Step1_Models.cpp:1868/2133): per phenotype, iteratively pick the top
    marginally-associated SNP of the block while p < --l0-pval-thr,
    conditioning subsequent tests on the picked set and dropping SNPs in
    high LD (r^2 > 0.9) with each pick. SNPs picked for EVERY phenotype
    are removed from the level-0 ridge. On the host in numpy (a block's
    [B, B] products and B small solves).

    Gn: [B, N] residualized+scaled genotypes (GtG diag = N - K);
    Y: [N, P] residualized+scaled phenotypes.
    Returns (picked [B, P] bool, n_picked [P], pgs [N, P]) where pgs is
    the block's top-SNP polygenic score per trait (block_top_pgs,
    Step1_Models.cpp:2143/2171), later added back to the LOCO
    predictions and removed from the level-1 response."""
    from scipy.stats import chi2 as _chi2

    B = Gn.shape[0]
    P = Y.shape[1]
    picked = np.zeros((B, P), dtype=bool)
    n_picked = np.zeros(P, dtype=int)
    pgs = np.zeros((Gn.shape[1], P))
    if params.l0_snp_pval_thr <= 0 or B == 1:
        return picked, n_picked, pgs
    thr = _chi2.isf(params.l0_snp_pval_thr, df=1)
    GGt = Gn @ Gn.T
    GtY = Gn @ Y  # [B, P]
    ggt = GGt[0, 0]  # = N - K by construction
    LD = (GGt / (params.n_analyzed - params.ncov_analyzed)) ** 2

    for ph in range(P):
        gty = GtY[:, ph]
        ss_y = float(Y[:, ph] @ Y[:, ph])
        bstart = gty / ggt
        bvec = bstart.copy()
        nprev = nspns_prev[ph]
        v_y = (ss_y - bvec * gty) / (ggt - nprev - 1)
        v_beta = np.full(B, 1.0 / ggt)
        cand = np.arange(B)
        top: list = []
        for _ in range(1, B):
            if (~picked[:, ph]).sum() == 1:
                break
            chisq_v = bvec**2 / v_beta / np.maximum(v_y, 1e-300)
            k = int(np.argmax(chisq_v))
            if chisq_v[k] < thr:
                break
            idx = cand[k]
            top.append(idx)
            picked[idx, ph] = True
            n_picked[ph] += 1
            pgs[:, ph] += Gn[idx] * bvec[k]  # conditional beta at pick time
            # drop high-LD partners of the pick
            picked[:, ph] |= LD[:, idx] > 0.9
            cand = np.flatnonzero(~picked[:, ph])
            A = GGt[np.ix_(top, top)]
            try:
                A_inv = np.linalg.inv(A)
            except np.linalg.LinAlgError:
                break
            X21 = GGt[np.ix_(cand, top)] @ A_inv
            ss_x1 = float(gty[top] @ A_inv @ gty[top])
            bvec = bstart[cand] - (X21 @ gty[top]) / ggt
            v_y = (ss_y - ss_x1 - bvec * gty[cand]) / (
                ggt - nprev - n_picked[ph] - 1
            )
            v_beta = (ggt - (X21 * GGt[np.ix_(cand, top)]).sum(axis=1)) / ggt**2
    return picked, n_picked, pgs
