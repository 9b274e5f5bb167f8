"""Multi-trait association tests (--mt): 14 tests per variant (the port's
copy of regenie_tpu/models/multitrait.py: the block's [B, N] x [N, q]
products in float64 torch on the block's device, the rest numpy and scipy
on the host, as in the JAX package).

Re-implements the reference's MTests machinery (MultiTrait_Tests.cpp:
assoc_manova :264, assoc_omnibus0 :420, assoc_cpc0 :545, assoc_rcpc0
:677, assoc_bayes :757, assoc_nnls0 :372; print_sumstats :943) with the
per-SNP OpenMP loop replaced by whole-block vectorized linear algebra:

- marginal z-scores for all traits x SNPs are two matmuls,
- the MANOVA Wilks log-det uses the matrix determinant lemma
  (det(YtY - G2 bb') = det(YtY)(1 - G2 b'YtY^-1 b)) so the per-SNP
  q x q factorization disappears,
- the Bayes Q1 "subtract a scalar from every entry" update is the
  rank-one det identity det(A - s 11') = det(A)(1 - s 1'A^-1 1).

Tests (index = output order): 0 MANOVA, 1 Omnibus0, 2 Bayes (log10 BF),
3 NNLS0, 4 SumZ, 5 NPMANOVA, 6 HOmnibus0, 7 CPC0, 8-10 RCPC0
{SUMCHI2,FISHER,ACAT}, 11-13 ACPC0 {SUMCHI2,FISHER,ACAT}.
"""

from __future__ import annotations

from dataclasses import dataclass
import numpy as np
import torch
from scipy.stats import chi2

from ..utils.quadforms import kuonen_pv, liu_logp
from ..utils.stats import chisq_neglog10, chisq_neglog10_df
from .joint import _chibar_weights_mc, _nnls_kkt
from .mcc import dkat_pvals
from .skat import get_acat_rows

N_MT_TESTS = 14


@dataclass
class MTState:
    mask0: np.ndarray  # [N] union of per-trait masks
    neff0: float
    Y0: np.ndarray  # [N, q] residuals under common mask
    YtY: np.ndarray
    YtY_inv: np.ndarray
    ld0: float
    Syy: np.ndarray
    Syy_inv: np.ndarray
    lambdas: np.ndarray  # eigenvalues of Syy (filtered)
    lambdas_norm: np.ndarray
    LL_M0: float
    PC_Y0: np.ndarray  # [N, q] PCs of Y0
    RPC_Y0: np.ndarray  # [N, q] rank-inverse-normalized PCs
    skew_pc: np.ndarray  # [q] |skewness| of PCs
    n_skewed_pc: int
    nnls_wts: np.ndarray  # [q+1] chi-bar weights from Syy
    # Bayes priors (MTests::setup, MultiTrait_Tests.cpp:97-101)
    prior_a0: float = 6.0
    prior_Q0: float = 4.0
    prior_Vbeta0: float = 0.02
    mcc_skew_abs: float = 1.0
    mcc_z2: float = 4.0


def _skew(y: np.ndarray, mask: np.ndarray) -> float:
    """skew_pheno (Pheno.cpp:2030-2045)."""
    v = y[mask]
    mu = v.mean()
    m2 = ((v - mu) ** 2).mean()
    return float(((v - mu) ** 3).mean() / m2**1.5) if m2 > 0 else 0.0


def setup_mt(res: np.ndarray, masked_indivs: np.ndarray) -> MTState:
    """Per-chromosome precompute (setup_masks + setup_yres,
    MultiTrait_Tests.cpp:121-188). res = normalized LOCO residuals."""
    from ..io.pheno import rint_values
    from .skat import get_lambdas

    mask0 = masked_indivs.any(axis=1)
    neff0 = float(mask0.sum())
    q = res.shape[1]
    Y0 = res * mask0[:, None].astype(np.float64)
    YtY = Y0.T @ Y0
    YtY_inv = np.linalg.inv(YtY)
    sign, ld0 = np.linalg.slogdet(YtY)
    Syy = YtY / (neff0 - 1.0)
    Syy_inv = np.linalg.inv(Syy)
    lambdas = get_lambdas(Syy)
    lambdas_norm = lambdas / lambdas.sum()
    # Bayes null-model marginal (MultiTrait_Tests.cpp:161-165)
    a0, Q0v, Vb0 = 6.0, 4.0, 0.02
    _s, ld = np.linalg.slogdet(Q0v * np.eye(q) + YtY)
    LL_M0 = 0.5 * q * np.log(Vb0) - 0.5 * (neff0 + a0 + q - 1.0) * ld
    # PCs of Y0 (eigvecs of Syy), their skewness, and RINT'd PCs
    _w, evec = np.linalg.eigh(Syy)
    PC = (Y0 @ evec) * mask0[:, None]
    skew_pc = np.array([abs(_skew(PC[:, j], mask0)) for j in range(q)])
    RPC = PC.copy()
    for j in range(q):
        RPC[:, j] = rint_values(RPC[:, j], mask0) * mask0
    wts = _chibar_weights_mc(Syy)
    return MTState(
        mask0=mask0, neff0=neff0, Y0=Y0, YtY=YtY, YtY_inv=YtY_inv, ld0=ld0,
        Syy=Syy, Syy_inv=Syy_inv, lambdas=lambdas, lambdas_norm=lambdas_norm,
        LL_M0=LL_M0, PC_Y0=PC, RPC_Y0=RPC, skew_pc=skew_pc,
        n_skewed_pc=int((skew_pc > 1.0).sum()), nnls_wts=wts,
    )


def _zscores(Y: np.ndarray, G: np.ndarray, G2: np.ndarray, neff0: float,
             GY: np.ndarray = None):
    """Marginal z-scores for all traits (assoc_omnibus0,
    MultiTrait_Tests.cpp:466-480). G: [B, N]; returns [B, q]."""
    if GY is None:
        GY = G @ Y  # [B, q]
    with np.errstate(divide="ignore", invalid="ignore"):
        bhat = GY / G2[:, None]
        Y2 = (Y**2).sum(axis=0)
        s2 = (Y2[None, :] - bhat**2 * G2[:, None]) / (neff0 - 1.0)
        Z = bhat * np.sqrt(G2[:, None] / s2)
    return Z, bhat


def _chibar_logp(stat: float, wts: np.ndarray) -> float:
    q = len(wts) - 1
    pv = sum(wts[k] * chi2.sf(stat, k) for k in range(1, q + 1) if wts[k] > 0)
    return float(-np.log10(max(pv, 5e-324)))


def _chibar_logp_batch(stats: np.ndarray, wts: np.ndarray) -> np.ndarray:
    """Vectorized _chibar_logp over a batch of statistics: one chi2.sf
    call on [B, q] instead of B*q scalar calls (elementwise-identical)."""
    q = len(wts) - 1
    ks = np.array([k for k in range(1, q + 1) if wts[k] > 0])
    if not len(ks):
        return np.full(len(stats), float(-np.log10(5e-324)))
    pv = (np.asarray(wts)[ks][None, :]
          * chi2.sf(np.asarray(stats)[:, None], ks[None, :])).sum(axis=1)
    return -np.log10(np.maximum(pv, 5e-324))


def _mix_logp(stat: float, lambdas: np.ndarray) -> float:
    """Kuonen SPA with Liu fallback on max-rescaled eigenvalues
    (assoc_manova NPMANOVA branch, MultiTrait_Tests.cpp:352-359)."""
    lam = np.sort(np.asarray(lambdas))
    newQ = stat / lam[-1]
    newL = lam / lam[-1]
    pv = kuonen_pv(newQ, newL)
    if pv <= 0:
        lp, _ = liu_logp(newQ, newL)
        return lp
    return float(-np.log10(max(pv, 5e-324)))


def _mix_logp_batch(stats: np.ndarray, lambdas: np.ndarray) -> np.ndarray:
    """Vectorized _mix_logp over a block's statistics (shared mixture):
    batched Kuonen saddlepoint, scalar Liu fallback only for failures."""
    from ..utils.quadforms import kuonen_pv_batch

    lam = np.sort(np.asarray(lambdas))
    newQ = np.asarray(stats) / lam[-1]
    newL = lam / lam[-1]
    pv = kuonen_pv_batch(newQ, newL)
    out = -np.log10(np.maximum(pv, 5e-324))
    for i in np.flatnonzero(pv <= 0):
        lp, _ = liu_logp(newQ[i], newL)
        out[i] = lp
    return out


def run_mt_block(st: MTState, G: np.ndarray, params) -> dict:
    """All 14 tests for a residualized+scaled block G [B, N] (a float64
    tensor on any device, or a host array).

    Returns dict with logp [B, 14], minp/minq [B], qnnls [B], and the
    four z-score matrices [B, q]."""
    B = G.shape[0]
    q = st.Y0.shape[1]
    N0 = st.neff0

    # the [B, N] x [N, q] products run where the block lies (the card
    # unless the CPU was asked for); only the rows the ACPC tests' DKAT
    # reads come back to the host
    G_t = torch.as_tensor(G)
    Ys = torch.as_tensor(np.concatenate([st.Y0, st.PC_Y0, st.RPC_Y0], axis=1),
                         device=G_t.device)
    G2 = (G_t**2).sum(dim=1).cpu().numpy()
    GY = (G_t @ Ys).cpu().numpy()
    GY0, GPC, GRPC = GY[:, :q], GY[:, q : 2 * q], GY[:, 2 * q :]

    logp = np.full((B, N_MT_TESTS), np.nan)

    # ---- z-scores on Y0, PCs, RINT-PCs
    Z, bhat = _zscores(st.Y0, G, G2, N0, GY0)
    Zpc, _ = _zscores(st.PC_Y0, G, G2, N0, GPC)
    Zrpc, _ = _zscores(st.RPC_Y0, G, G2, N0, GRPC)
    logp_uni = chisq_neglog10(Z**2)  # [B, q]

    # ---- 0: MANOVA (Wilks via determinant lemma)
    t = (bhat * (bhat @ st.YtY_inv)).sum(axis=1) * G2
    with np.errstate(invalid="ignore"):
        ld_diff = np.log1p(-np.clip(t, None, 1.0 - 1e-300))
    stat_manova = (q / 2.0 - N0 + 1.0) * ld_diff
    logp[:, 0] = chisq_neglog10_df(stat_manova, q)

    # ---- 5: NPMANOVA (pseudo-F against the Syy eigen mixture)
    ss_t = G2 * (bhat**2).sum(axis=1)
    ss_e = (np.trace(st.YtY) - ss_t) / (N0 - 1.0)
    stat_np = ss_t / ss_e
    logp[:, 5] = _mix_logp_batch(stat_np, st.lambdas_norm)

    # ---- 1: Omnibus0 z' Syy^-1 z
    stat_omni = (Z * (Z @ st.Syy_inv)).sum(axis=1)
    logp[:, 1] = chisq_neglog10_df(stat_omni, q)

    # ---- 4: SumZ  T = sum(z)^2 / sum(Syy) ~ chi2_1
    # (the reference prints the last trait's univariate p here by what
    # appears to be a bug, MultiTrait_Tests.cpp:522; we use the SumZ stat)
    stat_sumz = Z.sum(axis=1) ** 2 / st.Syy.sum()
    logp[:, 4] = chisq_neglog10(stat_sumz)

    # ---- 6: HOmnibus0 z'z against the Syy eigenvalue mixture
    stat_h = (Z**2).sum(axis=1)
    logp[:, 6] = _mix_logp_batch(stat_h, st.lambdas)

    # ---- 2: Bayes log10 BF (conjugate MV regression, rank-one det identity)
    Vb1 = 1.0 / (G2 + 1.0 / st.prior_Vbeta0)
    Mb1 = GY0 * Vb1[:, None]  # [B, q]
    Q1c = st.prior_Q0 * np.eye(q) + st.YtY
    _s, ldQ1c = np.linalg.slogdet(Q1c)
    sum_inv = np.linalg.inv(Q1c).sum()
    s_i = (Mb1**2).sum(axis=1) / Vb1
    with np.errstate(invalid="ignore"):
        ld1 = ldQ1c + np.log1p(-s_i * sum_inv)
    LL_M1 = 0.5 * q * np.log(Vb1) - 0.5 * (N0 + st.prior_a0 + q - 1.0) * ld1
    logp[:, 2] = (LL_M1 - st.LL_M0) / np.log(10.0)

    # ---- 3: NNLS0 on z with V = Syy (the q x q active-set solves stay
    # per-SNP — they are tiny; the chi-bar tail is batched)
    sp_all = np.zeros(B)
    sn_all = np.zeros(B)
    nnls_fail = np.zeros(B, bool)
    for i in range(B):
        try:
            Xty = st.Syy_inv @ Z[i]
            bp = _nnls_kkt(st.Syy_inv, Xty)
            bn = _nnls_kkt(st.Syy_inv, -Xty)
            sp_all[i] = bp @ st.Syy_inv @ bp
            sn_all[i] = bn @ st.Syy_inv @ bn
        except np.linalg.LinAlgError:
            nnls_fail[i] = True
    logp[:, 3] = np.maximum(_chibar_logp_batch(sp_all, st.nnls_wts),
                            _chibar_logp_batch(sn_all, st.nnls_wts))
    logp[nnls_fail, 3] = -9.0

    # ---- 7: CPC0 sum z_pc^2 ~ chi2_q
    stat_cpc = (Zpc**2).sum(axis=1)
    logp[:, 7] = chisq_neglog10_df(stat_cpc, q)

    # ---- 8-10: RCPC0 on RINT-PC z-scores
    logp_rpc_uni = chisq_neglog10(Zrpc**2)
    logp[:, 8] = chisq_neglog10_df((Zrpc**2).sum(axis=1), q)
    logp[:, 9] = _fisher_robust_batch(logp_rpc_uni)
    logp[:, 10] = get_acat_rows(logp_rpc_uni)

    # ---- 11-13: ACPC0 = CPC z-scores, MCC-adjusted where a PC is skewed
    # and its univariate signal is strong (MultiTrait_Tests.cpp:626-650)
    Zacpc = Zpc.copy()
    logp_pc_uni = chisq_neglog10(Zpc**2)
    acpc_fail = np.zeros(B, dtype=bool)
    if st.n_skewed_pc:
        z2 = Zpc**2
        adj_pc = st.skew_pc > st.mcc_skew_abs
        for i in range(B):
            if not (z2[i] > st.mcc_z2).any():
                continue
            for j in range(q):
                if adj_pc[j] and z2[i, j] > st.mcc_z2:
                    pv, skip = dkat_pvals(
                        G_t[i : i + 1].cpu().numpy(), st.PC_Y0[:, j : j + 1],
                        st.mask0[:, None], np.array([st.neff0]), 1,
                    )
                    if skip[0, 0]:
                        acpc_fail[i] = True
                        break
                    logp_pc_uni[i, j] = -np.log10(max(pv[0, 0], 5e-324))
                    z2_adj = chi2.isf(max(pv[0, 0], 5e-324), df=1)
                    Zacpc[i, j] *= np.sqrt(z2_adj / z2[i, j])
    logp[:, 11] = chisq_neglog10_df((Zacpc**2).sum(axis=1), q)
    logp[:, 12] = _fisher_robust_batch(logp_pc_uni)
    logp[:, 13] = get_acat_rows(logp_pc_uni)
    logp[acpc_fail, 11:14] = -9.0

    # ---- minP / minQ over univariate Y0 tests
    minp = logp_uni.max(axis=1)
    minq = np.maximum(0.0, minp - np.log10(q))
    qnnls = np.maximum(0.0, logp[:, 3] - np.log10(2.0))
    return {
        "logp": logp, "minp": minp, "minq": minq, "qnnls": qnnls,
        "z_uni": Z, "z_pc": Zpc, "z_rpc": Zrpc, "z_apc": Zacpc,
    }


def _fisher_robust(logp_vec: np.ndarray) -> float:
    """Fisher combination on -log10 p (get_fisher_robust,
    MultiTrait_Tests.cpp:41-50)."""
    stat = 2.0 * np.log(10.0) * logp_vec.sum()
    return float(chisq_neglog10_df(stat, 2 * len(logp_vec)))


def _fisher_robust_batch(logp_mat: np.ndarray) -> np.ndarray:
    """_fisher_robust over rows of [B, q] (one vectorized sf call)."""
    stats = 2.0 * np.log(10.0) * logp_mat.sum(axis=1)
    return chisq_neglog10_df(stats, 2 * logp_mat.shape[1])


def mt_header(n_pheno: int) -> str:
    """print_header_output_all_multitrait (Step2_Models.cpp:2329-2363)."""
    cols = "CHROM GENPOS ID ALLELE0 ALLELE1 MAC A1FREQ N"
    cols += " LOG10P.MINP0 LOG10Q.MINP0"
    cols += (
        " LOG10P.MANOVA LOG10P.OMNIBUS0 LOG10BF.BAYES LOG10P.NNLS0"
        " LOG10P.SUMZ0 LOG10P.NPMANOVA LOG10P.HOMNIBUS0 LOG10P.CPC0"
        " LOG10P.RCPC0SUMCHI2 LOG10P.RCPC0FISHER LOG10P.RCPC0ACAT"
        " LOG10P.ACPC0SUMCHI2 LOG10P.ACPC0FISHER LOG10P.ACPC0ACAT"
        " LOG10Q.NNLS0"
    )
    for tag in ("Z.Y0", "Z.PC0", "Z.RPC0", "Z.APC0"):
        for i in range(n_pheno):
            cols += f" {tag}{i+1}"
    return cols + "\n"


def mt_line(snp, mac: float, af: float, neff0: float, r: dict, i: int) -> str:
    """One output row (print_sumstats, MultiTrait_Tests.cpp:943-1016)."""
    from ..prep import fmt

    parts = [
        str(snp.chrom), str(snp.physpos), snp.ID, snp.allele1, snp.allele2,
        fmt(mac), fmt(af), fmt(neff0), fmt(r["minp"][i]), fmt(r["minq"][i]),
    ]
    parts += [fmt(r["logp"][i, t]) for t in range(N_MT_TESTS)]
    parts.append(fmt(r["qnnls"][i]))
    for key in ("z_uni", "z_pc", "z_rpc", "z_apc"):
        parts += [fmt(v) for v in r[key][i]]
    return " ".join(parts) + "\n"
