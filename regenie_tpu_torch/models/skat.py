"""SKAT family of variance-component gene-based tests on QT and BT (the
port's copy of regenie_tpu/models/skat.py).

Re-implements SKAT.cpp: update_vc_gmat (:70), prep_ultra_rare_mask
(:237), compute_vc_masks_qt (:290-643), SKATO moments/integration
(:1727-1935), with the [N x M] weighted-genotype algebra as dense
matmuls. Tests: SKAT, SKATO, SKATO-ACAT, ACATV, ACATO.

P-values of chi-square mixtures via utils.quadforms (Davies/Kuonen/Liu
chain); SKATO integration via scipy.integrate.quad (replacing quadpack
dqags, SKAT.hpp:86-110). These tails run on the host. The score products
run in float64 torch on the engine's device: the packed QT sets through
ops/vc_batch.py, the dense QT sets (dosages, ultra-rare-only sets) and
the BT sets (per trait, with Firth/SPA calibration by the port's
corrections) here.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
from scipy import integrate
from scipy.stats import beta as beta_dist
from scipy.stats import cauchy, chi2

from ..config import BT, QT, Params
from ..utils.quadforms import chisq_mix_logp, chisq_mix_sf_grid
from ..utils.stats import chisq_neglog10, neglog10_to_chisq

VALID_TESTS = ("skat", "skato", "skato-acat", "acatv", "acato", "acato-full")
DEFAULT_RHO = np.array([0.0, 0.01, 0.04, 0.09, 0.16, 0.25, 0.5, 1.0])
SKAT_LAMBDA_TOL = 1e-5  # reference skat_tol
_DBL_DMIN = 10.0 * np.finfo(np.float64).tiny


def check_tests(tests: List[str]):
    for t in tests:
        if t not in VALID_TESTS:
            raise ValueError(f"unknown VC test '{t}'")


def get_acat(logpvals: np.ndarray, weights: Optional[np.ndarray] = None) -> float:
    """Cauchy combination -log10 p, robust to tiny p-values
    (get_acat_robust, Joint_Tests.cpp:284). logpvals are -log10 p;
    entries < 0 (failed) are skipped. Returns -1 on failure."""
    lp = np.asarray(logpvals, dtype=np.float64)
    w = np.ones_like(lp) if weights is None else np.asarray(weights, dtype=np.float64)
    ok = (w != 0) & (lp >= 0)
    n_pv = int(ok.sum())
    if n_pv == 0:
        return -1.0
    if n_pv == 1:
        return float(np.where(ok, lp, 0).max())

    lpv_thr = 15.0
    A = ok & (lp >= lpv_thr)
    Bm = ok & (lp < lpv_thr)
    wsum = np.where(lp >= 0, w, 0).sum()
    l_TA, TB = 0.0, 0.0
    if A.any():
        z = lp[A] * np.log(10.0) + np.log(w[A] / wsum) - np.log(np.pi)
        zmax = z.max()
        l_TA = zmax + np.log(np.exp(z - zmax).sum())
    if Bm.any():
        pv = np.minimum(10.0 ** (-lp[Bm]), 0.999)
        TB = (w[Bm] / wsum * np.tan(np.pi * (0.5 - pv))).sum()

    def cauchy_sf_log(T):
        # log SF of standard cauchy at T (one-sided upper)
        if T >= 8886111:
            return -np.log(T) - np.log(np.pi)
        return np.log(cauchy.sf(T))

    if not A.any():
        lpval = cauchy_sf_log(TB)
    elif (not Bm.any()) or TB == 0:
        lpval = (-l_TA - np.log(np.pi)) if l_TA >= 16 else np.log(cauchy.sf(np.exp(l_TA)))
    else:
        if TB < 0:
            l_abs = np.log(abs(TB))
            if l_abs < l_TA:
                lsum = l_TA + np.log1p(-np.exp(l_abs - l_TA))
                lpval = (-lsum - np.log(np.pi)) if lsum >= 16 else np.log(cauchy.sf(np.exp(lsum)))
            else:
                lsum = l_abs + np.log1p(-np.exp(l_TA - l_abs))
                if lsum >= 16:
                    lpval = np.log1p(-np.exp(-lsum - np.log(np.pi)))
                else:
                    lpval = np.log(cauchy.sf(-np.exp(lsum)))
        else:
            l_TB = np.log(TB)
            hi, lo = max(l_TA, l_TB), min(l_TA, l_TB)
            lsum = hi + np.log1p(np.exp(lo - hi))
            lpval = (-lsum - np.log(np.pi)) if lsum >= 16 else np.log(cauchy.sf(np.exp(lsum)))
    return float(-lpval / np.log(10.0))


def get_acat_rows(logp: np.ndarray,
                  weights: Optional[np.ndarray] = None) -> np.ndarray:
    """Row-batched get_acat: one Cauchy combination per row of a [B, q]
    -log10-p matrix, bitwise-identical to calling get_acat per row
    (masked sums only insert exact +0.0 terms; every branch of the
    robust ladder, get_acat_robust Joint_Tests.cpp:284, is evaluated
    vectorized and selected per row). Batches the --mt per-SNP ACAT
    rows (MultiTrait_Tests.cpp:626-650 loop tails)."""
    lp = np.asarray(logp, dtype=np.float64)
    B, q = lp.shape
    w = (np.ones_like(lp) if weights is None
         else np.broadcast_to(np.asarray(weights, dtype=np.float64),
                              lp.shape))
    ok = (w != 0) & (lp >= 0)
    n_pv = ok.sum(axis=1)
    ln10, lnpi = np.log(10.0), np.log(np.pi)
    with np.errstate(all="ignore"):
        wsum = np.where(lp >= 0, w, 0.0).sum(axis=1)  # [B]
        A = ok & (lp >= 15.0)
        Bm = ok & (lp < 15.0)
        hasA = A.any(axis=1)
        hasB = Bm.any(axis=1)
        # l_TA: logsumexp over the A entries of each row
        z = lp * ln10 + np.log(w / wsum[:, None]) - lnpi
        zmask = np.where(A, z, -np.inf)
        zmax = zmask.max(axis=1)
        l_TA = zmax + np.log(
            np.where(A, np.exp(z - zmax[:, None]), 0.0).sum(axis=1))
        # TB: plain-space sum over the B entries
        pv = np.minimum(10.0 ** (-lp), 0.999)
        tb_term = w / wsum[:, None] * np.tan(np.pi * (0.5 - pv))
        TB = np.where(Bm, tb_term, 0.0).sum(axis=1)

        def _sf_log_pos(lsum):
            # log(cauchy.sf(exp(lsum))) with the >=16 shortcut
            return np.where(lsum >= 16.0, -lsum - lnpi,
                            np.log(cauchy.sf(np.exp(np.minimum(lsum, 700.0)))))

        # branch 1: no A entries -> cauchy_sf_log(TB)
        b1 = np.where(TB >= 8886111.0, -np.log(TB) - lnpi,
                      np.log(cauchy.sf(TB)))
        # branch 2: A only (or TB == 0)
        b2 = _sf_log_pos(l_TA)
        # branch 3: TB < 0 — cancellation ladder
        l_abs = np.log(np.abs(TB))
        lsum_lt = l_TA + np.log1p(-np.exp(l_abs - l_TA))
        b3_lt = _sf_log_pos(lsum_lt)
        lsum_ge = l_abs + np.log1p(-np.exp(l_TA - l_abs))
        b3_ge = np.where(
            lsum_ge >= 16.0,
            np.log1p(-np.exp(-lsum_ge - lnpi)),
            np.log(cauchy.sf(-np.exp(np.minimum(lsum_ge, 700.0)))))
        b3 = np.where(l_abs < l_TA, b3_lt, b3_ge)
        # branch 4: TB > 0 — stable log-add
        l_TB = np.log(TB)
        hi = np.maximum(l_TA, l_TB)
        lo = np.minimum(l_TA, l_TB)
        b4 = _sf_log_pos(hi + np.log1p(np.exp(lo - hi)))
        lpval = np.select(
            [~hasA, ~hasB | (TB == 0.0), TB < 0.0], [b1, b2, b3], b4)
        out = -lpval / ln10
    out = np.where(n_pv == 1, np.where(ok, lp, 0.0).max(axis=1), out)
    out = np.where(n_pv == 0, -1.0, out)
    return out


def get_lambdas(K: np.ndarray) -> np.ndarray:
    """Nonzero eigenvalues, R-SKAT filter (get_lambdas, SKAT.cpp:1425)."""
    if K.shape[0] == 1:
        return np.array([K[0, 0]])
    ev = np.linalg.eigvalsh(K)
    nng = (ev >= 0).sum()
    thr = np.where(ev >= 0, ev, 0).sum() / nng * SKAT_LAMBDA_TOL
    return ev[ev > thr]


def rskrs(K: np.ndarray, rho: float) -> np.ndarray:
    """R(rho)^1/2 K R(rho)^1/2 (get_RsKRs, SKAT.cpp:1397)."""
    m = K.shape[0]
    c1 = np.sqrt(1 - rho)
    c2 = np.sqrt(1 - rho + m * rho)
    b = K.sum(axis=1)
    gamma1 = b.sum()
    outer_sum = b[:, None] + b[None, :]
    return (1 - rho) * K + c1 * (c2 - c1) / m * outer_sum + ((c2 - c1) / m) ** 2 * gamma1


def fixed_skato_p(q: float, rho: float, lambdas: np.ndarray):
    """(logp, chival) for Q at fixed rho (compute_fixed_skato_p)."""
    if rho == 1 or len(lambdas) == 1:
        chival = q / lambdas[-1]
        logp = float(chisq_neglog10(np.array([chival]))[0])
        return logp, chival
    return chisq_mix_logp(q, lambdas)


class VCPrep:
    """Host-side per-set VC state between vc_prep and vc_finish.

    `codes` non-None marks the packed path: the main columns ship to the
    device as 2-bit BED codes and are decoded, imputed and weighted there
    by the batched products (vc_products_batched, ops/vc_batch.py)."""

    __slots__ = (
        "vset", "snps", "vc_masks", "n_main", "ur_cols", "cols_all",
        "col_of", "weights_full", "w_acat_full", "GW_full", "chrom",
        "codes", "flip", "imp", "wvec", "ur_dense",
        "WGtX", "Svals", "Kmat", "is_bt",
    )

    def __init__(self):
        for k in self.__slots__:
            setattr(self, k, None)


def vc_prep(params: Params, eng, vset, snps, G, sb, ignored, built, log):
    """Host half of the VC tests for one set: eligibility, Beta(a1,a2)
    weights, ultra-rare collapse (update_vc_gmat/prep_ultra_rare_mask,
    SKAT.cpp:70/:237). Returns a VCPrep or None.

    G: [M, N] raw genotypes (missing=-3); sb: block stats dict from the
    engine; built: BuiltMask list (provides the per-mask variant sets via
    sel_idx and vc bin flags).
    """
    if params.trait_mode not in (QT, BT):
        log("WARNING: VC tests only implemented for QT/BT traits; skipping")
        return None
    M, N = G.shape
    af1 = sb["af1"]
    mac1 = np.minimum(sb["total"], 2 * sb["ns"] - sb["total"])
    ind = eng.pd.ind_in_analysis

    # identify masks with a VC column (mask built at the vc_maxAAF bin)
    vc_masks = [bm for bm in built if bm.in_vc_bin]
    if not vc_masks:
        return None

    # packed fast path: QT + integer hardcalls -> the main columns ship
    # as 2-bit codes and are decoded/weighted on the device (BT keeps the
    # host matrix: its per-pheno gamma weighting consumes GW columns
    # directly)
    packed_ok = params.trait_mode == QT and np.issubdtype(G.dtype, np.integer)

    # variants eligible for VC: union over vc masks, minus ultra-rare
    ur = (mac1 <= params.skat_collapse_MAC) & ~ignored
    weights = np.zeros(M)
    weights_acat = np.zeros(M)
    maf = np.minimum(af1, 1 - af1)

    GW = None if packed_ok else np.zeros((N, M))
    used = np.zeros(M, dtype=bool)
    for bm in vc_masks:
        used[bm.sel_idx] = True
    used &= ~ignored

    # custom user weights, normalized to sum 1 over the set
    # (get_custom_weights, SKAT.cpp:174-190)
    user_w = None
    if params.vc_with_weights:
        sw = getattr(eng, "_set_weights", {})
        user_w = np.array([
            sw.get((gidx, vset.ID), 0.0) for gidx in vset.snp_indices
        ])
        tot_w = user_w.sum()
        if tot_w > 0:
            user_w = user_w / tot_w

    sel = np.flatnonzero(used & ~ur)
    if len(sel):
        w_beta = beta_dist.pdf(maf[sel], params.skat_a1, params.skat_a2)
        if user_w is None:
            w = w_beta
            weights_acat[sel] = w * w * maf[sel] * (1 - maf[sel])
        elif params.vc_multiply_weights:
            w = user_w[sel] * w_beta
            weights_acat[sel] = w * w * maf[sel] * (1 - maf[sel])
        else:
            w = user_w[sel]
            weights_acat[sel] = w
        weights[sel] = w
        if not packed_ok:
            # vectorized flip/impute/weight over the eligible variants
            # (the packed path performs the same elementwise chain on
            # the device, vc_batch._vc_chunks)
            Gs = G[sel].astype(np.float64)  # [m, N]
            miss = Gs == -3
            Gs = np.where((af1[sel] > 0.5)[:, None], 2.0 - Gs, Gs)
            Gs = np.where(miss, (2.0 * maf[sel])[:, None], Gs)
            Gs *= ind[None, :]
            GW[:, sel] = (Gs * w[:, None]).T

    # ultra-rare collapse per vc mask (prep_ultra_rare_mask, SKAT.cpp:237)
    ur_cols: Dict[int, int] = {}  # bm.vc_col -> column in GW_ur
    GW_ur = []
    w_ur, w_ur_acat = [], []
    for bm in vc_masks:
        sel_ur = [i for i in bm.sel_idx if ur[i]]
        if not sel_ur:
            continue
        cols = []
        nonmiss = np.zeros(N, dtype=bool)
        for i in sel_ur:
            g = G[i].astype(np.float64)
            if af1[i] > 0.5:
                g = np.where(g == -3, 0.0, 2 - g)
            else:
                g = np.where(g < 0, 0.0, g)
            cols.append(g)
            nonmiss |= G[i] >= 0
        gv = np.max(np.stack(cols), axis=0) * ind
        if not (gv > 0).any():
            continue
        nonmiss &= ind
        mean = gv.sum() / max(nonmiss.sum(), 1)
        maf_ur = min(mean / 2, 1 - mean / 2)
        w = beta_dist.pdf(maf_ur, params.skat_a1, params.skat_a2)
        gv = np.where(~ind | nonmiss, gv, mean)
        ur_cols[bm.vc_col] = len(GW_ur)
        GW_ur.append(gv * w)
        w_ur.append(w)
        w_ur_acat.append(w * w * maf_ur * (1 - maf_ur))

    # assemble per-set state for the (possibly bucketed) device products
    cols_all = np.flatnonzero(weights > 0)
    if len(cols_all) == 0 and not GW_ur:
        return None

    prep = VCPrep()
    prep.vset, prep.snps, prep.vc_masks = vset, snps, vc_masks
    prep.chrom = vset.chrom
    prep.cols_all = cols_all
    prep.col_of = {int(c): k for k, c in enumerate(cols_all)}
    prep.n_main = len(cols_all)
    prep.ur_cols = ur_cols
    prep.ur_dense = np.stack(GW_ur, axis=1) if GW_ur else np.zeros((N, 0))
    prep.weights_full = (
        np.concatenate([weights[cols_all], np.array(w_ur)])
        if GW_ur else weights[cols_all]
    )
    prep.w_acat_full = (
        np.concatenate([weights_acat[cols_all], np.array(w_ur_acat)])
        if GW_ur else weights_acat[cols_all]
    )
    prep.is_bt = params.trait_mode == BT

    if packed_ok and prep.n_main > 0:
        from ..io.bed import encode_bed_bytes

        prep.codes = encode_bed_bytes(G[cols_all])
        prep.flip = af1[cols_all] > 0.5
        prep.imp = 2.0 * maf[cols_all]
        prep.wvec = weights[cols_all]
    else:
        main = GW[:, cols_all] if GW is not None else np.zeros((N, 0))
        prep.GW_full = np.concatenate([main, prep.ur_dense], axis=1)
    return prep


def vc_products_batched(params: Params, eng, preps) -> None:
    """Fill WGtX/Svals/Kmat on each QT prep (compute_vc_mats_qt,
    SKAT.cpp:643), the products on the engine's device in float64.

    Packed preps (BED/PGEN hardcalls) group by (chrom, padded dims) into
    ops.vc_batch calls: 2-bit codes ship instead of the dense float64
    weighted matrix, and the decode/impute/weight chain runs on the
    device. Dense preps (dosage input, ultra-rare-only sets) take one
    set at a time; BT preps are left to _run_vc_bt, which consumes the
    host GW matrix per trait."""
    from ..ops import vc_batch

    X = eng.pd.new_cov
    dev = eng.device
    qt = [p for p in preps if p is not None and not p.is_bt]
    packed = [p for p in qt if p.codes is not None]
    dense = [p for p in qt if p.codes is None]

    if packed:
        cache = getattr(eng, "_vc_cache", None)
        if cache is None or cache.N != X.shape[0]:
            cache = vc_batch.VCDeviceCache(X, eng.pd.ind_in_analysis, dev)
            eng._vc_cache = cache
        groups: Dict[tuple, list] = {}
        for p in packed:
            u = p.ur_dense.shape[1]
            key = (p.chrom, vc_batch._pad_dim(p.n_main),
                   0 if u == 0 else vc_batch._pad_dim(u, 1))
            groups.setdefault(key, []).append(p)
        for (chrom, _mm_pad, _u_pad), ps in sorted(groups.items()):
            eng.prep_chrom(chrom)
            cache.set_residuals(chrom, eng.res, X)
            prods = vc_batch.bucket_products(
                cache,
                [p.codes for p in ps], [p.ur_dense for p in ps],
                [p.flip for p in ps], [p.imp for p in ps],
                [p.wvec for p in ps],
            )
            for p, (gtg, gtx, gty) in zip(ps, prods):
                p.WGtX = gtx  # [Mt, K]
                p.Svals = gty.T - cache.ytX @ gtx.T  # [P, Mt]
                p.Kmat = gtg - gtx @ gtx.T  # [Mt, Mt]

    if dense:
        X_d = torch.as_tensor(np.asarray(X, np.float64), device=dev)
        for p in dense:
            eng.prep_chrom(p.chrom)
            yres = eng.res  # [N, P] scaled residuals
            GW_d = torch.as_tensor(np.asarray(p.GW_full, np.float64), device=dev)
            Mt = GW_d.shape[1]
            # GW'X | GW'Yres | GW'GW in one packed device -> host copy
            blk = torch.cat([
                GW_d.T @ X_d,
                GW_d.T @ torch.as_tensor(np.asarray(yres, np.float64), device=dev),
                GW_d.T @ GW_d,
            ], dim=1).cpu().numpy()
            K = X.shape[1]
            p.WGtX = blk[:, :K]
            p.Svals = blk[:, K : blk.shape[1] - Mt].T - (yres.T @ X) @ p.WGtX.T
            p.Kmat = blk[:, blk.shape[1] - Mt :] - p.WGtX @ p.WGtX.T


def vc_compute_qt(params: Params, prep: VCPrep):
    """The host tails for one set's QT VC masks: ACAT-V single-variant
    p-values + per-mask SKAT/SKATO family (compute_vc_masks_qt,
    SKAT.cpp:500+). No engine or writer state is touched. Returns
    [(bm, results)] in mask order for the render stage."""
    P = params.n_pheno
    vc_masks = prep.vc_masks
    col_of, n_main = prep.col_of, prep.n_main
    ur_cols = prep.ur_cols
    w_acat_full = prep.w_acat_full
    Svals, Kmat = prep.Svals, prep.Kmat

    # single-variant p-values for ACAT-V
    with np.errstate(divide="ignore", invalid="ignore"):
        chisq_sv = Svals**2 / np.where(np.diag(Kmat) > 0, np.diag(Kmat), 1.0)[None, :]
    logp_sv = np.stack([chisq_neglog10(chisq_sv[ph]) for ph in range(P)])  # [P, Mt]

    rho_vec = params.skato_rho if params.skato_rho is not None else DEFAULT_RHO
    with_acatv = "acatv" in params.vc_tests or "acato" in params.vc_tests
    with_skat = "skat" in params.vc_tests
    with_skato = "skato" in params.vc_tests
    with_skato_acat = "skato-acat" in params.vc_tests
    with_acato = "acato" in params.vc_tests or "acato-full" in params.vc_tests
    with_omnibus = with_skato or with_skato_acat or with_acato or with_skat

    computed = []
    for bm in vc_masks:
        results: Dict[str, np.ndarray] = {}  # test -> [P, 2] (chisq, logp)
        m_idx = [col_of[int(i)] for i in bm.sel_idx if int(i) in col_of]
        if bm.vc_col in ur_cols:
            m_idx = m_idx + [n_main + ur_cols[bm.vc_col]]
        if not m_idx:
            continue
        m_idx = np.array(m_idx)
        Km = Kmat[np.ix_(m_idx, m_idx)]
        nnz = len(m_idx)

        if with_acatv and (w_acat_full[m_idx] > 0).any():
            ss = np.full((P, 2), -1.0)
            for ph in range(P):
                lp = get_acat(logp_sv[ph, m_idx], w_acat_full[m_idx])
                if lp >= 0:
                    ss[ph, 1] = lp
                    ss[ph, 0] = float(neglog10_to_chisq(np.array([lp]))[0])
            results["ACATV"] = ss

        if with_omnibus:
            _skato_tests(
                params, results, Svals[:, m_idx], Km, rho_vec, nnz, P,
                with_skat, with_skato, with_skato_acat, with_acato,
                results.get("ACATV"),
            )
        computed.append((bm, results))
    return computed


def vc_finish(params: Params, eng, vset, prep: VCPrep, writers, log) -> None:
    """Host tail of the VC tests for one set: remeta LD write, ACAT-V
    single-variant p-values, per-mask SKAT/SKATO family, row rendering
    (compute_vc_masks_qt SKAT.cpp:500+, print_vc_sumstats :1940)."""
    eng._last_vc_results = {}
    if prep.is_bt:
        return _run_vc_bt(
            params, eng, vset, prep.vc_masks, prep.GW_full, prep.col_of,
            prep.n_main, prep.ur_cols, prep.weights_full, prep.w_acat_full,
            writers, log,
        )
    snps = prep.snps
    cols_all, n_main = prep.cols_all, prep.n_main
    weights_full = prep.weights_full
    Kmat = prep.Kmat

    # remeta: write the unweighted kernel per gene (SKAT.cpp:338-362)
    if params.remeta_save_ld and getattr(eng, "remeta_writers", None) and n_main > 0:
        winv = 1.0 / weights_full[:n_main]
        K_unw = Kmat[:n_main, :n_main] * winv[:, None] * winv[None, :]
        ids = [snps[int(c)].ID for c in cols_all]
        for wr in eng.remeta_writers:
            if wr is None:
                continue
            if params.remeta_ld_spr > 0:
                wr.write_matrix_sparse(K_unw, vset.ID, ids, params.remeta_ld_spr)
            else:
                wr.write_matrix_dense(K_unw, vset.ID, ids)

    for bm, results in vc_compute_qt(params, prep):
        _write_vc_rows(params, eng, writers, bm, results)


def _skato_tests(params, results, Sm, Km, rho_vec, nnz, P, with_skat, with_skato,
                 with_skato_acat, with_acato, acatv_ss):
    """SKAT/SKATO family for one mask (compute_vc_masks_qt, SKAT.cpp:500+)."""
    Qs = (Sm**2).sum(axis=1)  # [P]
    Qb = (Sm.sum(axis=1)) ** 2  # [P]
    nrho = len(rho_vec)

    # SKATO moments
    b = Km.sum(axis=1)
    gamma1 = b.sum()
    gamma2 = (b**2).sum()
    gamma3 = b @ (Km @ b)
    if gamma1 <= 0:
        return
    skato_lambdas = get_lambdas(Km - np.outer(b, b / gamma1))
    if len(skato_lambdas) == 0:
        return
    mu = skato_lambdas.sum()
    v0 = 2 * (skato_lambdas**2).sum()
    ve = 4 * (gamma3 / gamma1 - gamma2**2 / gamma1**2)
    vq = v0 + ve
    if vq < 0:
        return
    sdQ = np.sqrt(vq)
    fdavies = np.sqrt(v0 / vq)
    tau = gamma1 * rho_vec + gamma2 / gamma1 * (1 - rho_vec)

    pvs = np.full((P, nrho), -1.0)
    chis = np.full((P, nrho), -1.0)
    cvals = np.zeros((nrho, 5))
    lambdas_by_rho = []
    for j, rho in enumerate(rho_vec):
        lam = get_lambdas(rskrs(Km, rho))
        lambdas_by_rho.append(lam)
        if len(lam) == 0:
            return
        cvals[j, 0] = lam.sum()
        cvals[j, 1] = (lam**2).sum()
        cvals[j, 2] = (lam**3).sum()
        cvals[j, 3] = (lam**4).sum()
        s1 = cvals[j, 2] / cvals[j, 1] / np.sqrt(cvals[j, 1])
        s2 = cvals[j, 3] / cvals[j, 1] ** 2
        if s1**2 <= s2:
            cvals[j, 4] = 1 / s2
        else:
            a = 1 / (s1 - np.sqrt(s1**2 - s2))
            dlt = (s1 * a - 1) * a * a
            cvals[j, 4] = a * a - 2 * dlt
        # per-rho sweep batched across phenotypes (the P q-values share
        # this rho's kernel spectrum): one davies_pv_batch/kuonen chain
        # instead of P scalar chains — bitwise-identical per element
        # (chisq_mix_logp_batch).  Reference: per-trait loop around
        # get_chisq_mix_pv, SKAT.cpp:560.
        qv = (1 - rho) * Qs + rho * Qb
        if P == 1:
            lp, cv = fixed_skato_p(float(qv[0]), rho, lam)
            pvs[0, j], chis[0, j] = lp, cv
        elif rho == 1 or len(lam) == 1:
            cvv = qv / lam[-1]
            pvs[:, j] = chisq_neglog10(cvv)
            chis[:, j] = cvv
        else:
            from ..utils.quadforms import chisq_mix_logp_batch

            pvs[:, j], chis[:, j] = chisq_mix_logp_batch(qv, lam)
        if rho == 0 and with_skat:
            ss = np.stack([chis[:, j], pvs[:, j]], axis=1)
            if (ss[:, 1] >= 0).any():
                results["SKAT"] = ss.copy()
        if nnz == 1:
            break

    if nnz == 1:
        ss = np.stack([chis[:, 0], pvs[:, 0]], axis=1)
        if (ss[:, 1] >= 0).any():
            for name, flag in (("ACATO", with_acato), ("SKATO-ACAT", with_skato_acat), ("SKATO", with_skato)):
                if flag:
                    results[name] = ss.copy()
        return

    pvs_skato_acat = np.full((P, 2), -1.0)
    pvs_acato = np.full((P, 2), -1.0)
    pvs_skato = np.full((P, 2), -1.0)

    # The mixture-SF grid for the SKATO integral depends only on the
    # mask's lambdas, so one grid (sized to the widest phenotype's
    # integration range) is shared across all P phenotypes — at biobank
    # trait counts the grid's Davies evaluations dominate the VC-test
    # host time (get_skato_pv is per-trait in the reference,
    # SKAT.cpp:560)
    grid_sf = None
    if with_skato:
        flip = 1 - rho_vec
        dlt_hi_max = 0.0
        qmins = {}
        for ph in range(P):
            if (pvs[ph] < 0).any():
                continue
            minp = max(_DBL_DMIN, 10.0 ** (-pvs[ph].max()))
            qmin = _skato_qmin(minp, nrho, cvals)
            qmins[ph] = (minp, qmin)
            with np.errstate(divide="ignore"):
                ratio0 = np.where(flip > 0, qmin / np.where(flip > 0, flip, 1.0), np.inf)
            dlt_hi = max((float(np.min(ratio0)) - mu) * fdavies + mu, mu * 4, 1.0)
            if not np.isfinite(dlt_hi):
                dlt_hi = mu * 100
            dlt_hi_max = max(dlt_hi_max, dlt_hi)
        if qmins:
            grid_sf = _skato_grid(dlt_hi_max, skato_lambdas)

    for ph in range(P):
        if (pvs[ph] < 0).any():
            continue
        if with_skato_acat:
            lp = get_acat(pvs[ph])
            pvs_skato_acat[ph] = [float(neglog10_to_chisq(np.array([lp]))[0]), lp]
        if with_acato:
            lp_list = [acatv_ss[ph, 1]] if acatv_ss is not None else [-1.0]
            lps = np.concatenate([np.array(lp_list), pvs[ph]])
            lp = get_acat(lps)
            pvs_acato[ph] = [float(neglog10_to_chisq(np.array([lp]))[0]), lp]
        if with_skato:
            minp, qmin = qmins[ph]
            lp, cv = _skato_integral(
                minp, qmin, nrho, tau, rho_vec, mu, fdavies, grid_sf
            )
            pvs_skato[ph] = [cv, lp]

    if with_skato_acat and (pvs_skato_acat[:, 1] >= 0).any():
        results["SKATO-ACAT"] = pvs_skato_acat
    if with_acato and (pvs_acato[:, 1] >= 0).any():
        results["ACATO"] = pvs_acato
    if with_skato and (pvs_skato[:, 1] >= 0).any():
        results["SKATO"] = pvs_skato


def _skato_qmin(minp, nrho, cvals):
    """Qmin per rho at pmin (get_skato_pv, SKAT.cpp:1841-1848)."""
    qmin = np.empty(nrho)
    for j in range(nrho):
        df = cvals[j, 4]
        qmin[j] = cvals[j, 0] + (chi2.isf(minp, df) - df) * np.sqrt(cvals[j, 1] / df)
    return qmin


def _skato_grid(dlt_hi, skato_lambdas):
    """Mixture-SF grid shared by every phenotype of a mask: the lambdas
    are fixed per mask, so the Davies evaluations (the host hot spot at
    scale) run once. Returns (gx, log_sf) or None."""
    lam = np.sort(np.asarray(skato_lambdas, dtype=np.float64))
    lmax = lam[-1]
    lam = lam / lmax
    grid = np.linspace(1e-8, dlt_hi, 80)
    # monotone-SF batched chain: hoisted Davies panels on the shared-h
    # prefix + direct saddlepoint for the deep tail (chisq_mix_sf_grid)
    sf_grid = chisq_mix_sf_grid(grid / lmax, lam)
    ok_grid = sf_grid > 0
    if ok_grid.sum() < 4:
        return None
    return grid[ok_grid], np.log(np.maximum(sf_grid[ok_grid], 5e-324))


_INV_SQRT_2PI = 1.0 / np.sqrt(2.0 * np.pi)


def _chi2_pdf_1df(x):
    """chi2(1) density exp(-x/2)/sqrt(2*pi*x) — scipy.stats.chi2.pdf
    carries ~100us of broadcasting overhead per call, which dominates
    the SKATO integrand (500+ evaluations per quad)."""
    return _INV_SQRT_2PI * np.exp(-0.5 * x) / np.sqrt(x)


def _skato_integral(minp, qmin, nrho, tau, rho_vec, muQ, fdavies, grid_sf):
    """SKAT-O omnibus p by 1-dim integration (get_skato_pv + SKATO_integral_fn,
    SKAT.cpp:1836-1935). Returns (logp, chival)."""
    flip = 1 - rho_vec
    with np.errstate(divide="ignore"):
        upper = np.min((qmin + flip * muQ * (1 - fdavies) / fdavies) / tau)
    if minp >= 1 - 1e-7:
        return 0.0, 0.0
    if grid_sf is None:
        return -1.0, -1.0
    gx, log_sf = grid_sf

    state = {"failed": False}

    # scipy.quad calls the integrand 500+ times with a scalar x; numpy
    # scalar temporaries cost ~20us/call, which made this the vctails
    # stage's second-largest host cost.  Pure-python floats + math.* are
    # ~10x cheaper; every formula below reproduces the numpy expression
    # bit-for-bit (np.interp's slope*(x-x0)+y0 form, nan propagation of
    # the 0/0 rho=1 edge via inf/nan floats).
    import math as _math
    from bisect import bisect_right as _bisect

    _nrho = len(rho_vec)
    _qmin = [float(v) for v in np.atleast_1d(qmin)]
    _tau = [float(v) for v in np.atleast_1d(tau)]
    _flip = [float(v) for v in np.atleast_1d(flip)]
    _gx = [float(v) for v in gx]
    _lsf = [float(v) for v in log_sf]
    _gx0, _gxn = _gx[0], _gx[-1]
    _sf_last = _math.exp(_lsf[-1])
    _muQ, _fd = float(muQ), float(fdavies)
    _hi = _muQ * 1e4
    _inf = float("inf")

    def mix_sf(dlt):
        if dlt != dlt:  # nan in == nan out (np.interp semantics)
            return dlt
        if dlt <= _gx0:
            return 1.0
        if dlt >= _gxn:
            return _sf_last
        j = _bisect(_gx, dlt) - 1
        slope = (_lsf[j + 1] - _lsf[j]) / (_gx[j + 1] - _gx[j])
        return _math.exp(slope * (dlt - _gx[j]) + _lsf[j])

    def integrand(x):
        if state["failed"] or x == 0:
            return 0.0
        val = _inf
        for k in range(_nrho):
            num = _qmin[k] - _tau[k] * x
            f = _flip[k]
            if f != 0.0:
                v = num / f
            elif num > 0.0:
                v = _inf
            elif num < 0.0:
                v = -_inf
            else:
                v = float("nan")
            if v != v:  # np.min: any nan -> nan
                val = v
                break
            if v < val:
                val = v
        if val > _hi:
            S = 0.0
        else:
            dlt = (val - _muQ) * _fd + _muQ
            if dlt <= 0:
                S = 1.0
            else:
                S = min(mix_sf(dlt), 1.0)
        # keep the original S * pdf(x) rounding order
        return S * (_INV_SQRT_2PI * _math.exp(-0.5 * x) / _math.sqrt(x))

    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        try:
            a, _err = integrate.quad(integrand, 0, upper, epsabs=1e-25,
                                     epsrel=np.finfo(np.float64).eps ** 0.25, limit=1000)
        except Exception:
            state["failed"] = True
            a = -1.0
    tstar = chi2.sf(upper, 1)
    p_bc = minp * nrho
    if not state["failed"] and np.isfinite(a):
        a += tstar
    else:
        a = -1.0
    if p_bc < a:
        a = p_bc
    elif a <= 0 and p_bc <= 1:
        a = p_bc
    if a <= 0:
        return -1.0, -1.0
    a = max(a, _DBL_DMIN)
    lp = -np.log10(a)
    return lp, float(neglog10_to_chisq(np.array([lp]))[0])


def _write_vc_rows(params, eng, writers, bm, results):
    """Emit one row per (test, pheno) (print_vc_sumstats, SKAT.cpp:1940).
    Results are also stashed on the engine for the GENE_P strategy."""
    from ..io.output import sumstat_line_single

    if not hasattr(eng, "_last_vc_results"):
        eng._last_vc_results = {}
    eng._last_vc_results[id(bm)] = results

    pd = eng.pd
    for test_name in sorted(results):
        ss = results[test_name]
        for ph in range(params.n_pheno):
            if not pd.pheno_pass[ph] or ss[ph, 1] < 0:
                continue
            if params.htp_out:
                from ..io.output import htp_pvalue_line

                wgr = "" if params.skip_blups else "-WGR"
                ncase, nctrl = eng.pheno_counts(ph)
                writers[ph].write(
                    htp_pvalue_line(
                        params, bm.snp, pd.pheno_names[ph],
                        f"ADD{wgr}-{test_name}", ss[ph, 1], 1, ncase, nctrl,
                    )
                )
                continue
            writers[ph].write(
                sumstat_line_single(
                    params, bm.snp, f"ADD-{test_name}",
                    -1.0, None, int(pd.Neff[ph]),
                    -1.0, -1.0, ss[ph, 0], ss[ph, 1], True,
                )
            )



def _bt_products(GW_d, dc, res_d):
    """One trait's BT VC products on the engine's device: the
    gamma-weighted genotypes GWp [N, Mt] and GtWX [K, Mt], which stay
    there for the corrections, and from one packed device -> host copy
    of GtWX | Svals | GtG the scores Svals [Mt] and the kernel Kmat
    [Mt, Mt] (compute_vc_masks_bt, SKAT.cpp:701)."""
    GWp = GW_d * dc["gsm"][:, None]
    GtWX_d = dc["XW"].T @ GWp
    K = GtWX_d.shape[0]
    blk = torch.cat([GtWX_d, (GWp.T @ res_d)[None, :], GWp.T @ GWp],
                    dim=0).cpu().numpy()
    GtWX = blk[:K]
    return GWp, GtWX_d, blk[K], blk[K + 1 :] - GtWX.T @ GtWX


def _run_vc_bt(params, eng, vset, vc_masks, GW_full, col_of, n_main, ur_cols,
               weights_full, w_acat_full, writers, log):
    """BT VC tests with Firth/SPA case-control calibration
    (compute_vc_masks_bt, SKAT.cpp:701; apply_correction_cc :1209). The
    null state is the engine's (step2_bt.BTChromState); each trait's
    weighted products and the corrected columns' residualized rows are
    formed on the engine's device, the corrections run there
    (corrections_device) when it is a card and by the host twins on the
    CPU, and the SKAT/SKATO tails on the host."""
    from scipy.stats import chi2 as _chi2

    from . import firth as firth_mod
    from . import spa as spa_mod
    from .step2_bt import dev_consts

    pd = eng.pd
    st = eng.null_state
    dev = eng.device
    P = params.n_pheno
    N, Mt = GW_full.shape
    apply_corr = params.firth or params.use_spa
    z_thr = np.sqrt(_chi2.isf(params.alpha_pvalue, df=1)) if apply_corr else np.inf
    rho_vec = params.skato_rho if params.skato_rho is not None else DEFAULT_RHO
    with_acatv = "acatv" in params.vc_tests or "acato" in params.vc_tests
    with_skat = "skat" in params.vc_tests
    with_skato = "skato" in params.vc_tests
    with_skato_acat = "skato-acat" in params.vc_tests
    with_acato = "acato" in params.vc_tests or "acato-full" in params.vc_tests
    GW_d = torch.as_tensor(np.asarray(GW_full, np.float64), device=dev)

    def firth_lrt(dc, Gv):
        _b, _se, lrt, conv = firth_mod.firth_snp_batch_auto(
            dc["y"], Gv, dc["firth_offset"], dc["mask"], device=dev,
            maxstep=params.maxstep, niter=params.niter_max_firth, tol=2.5e-4,
        )
        return lrt, conv

    def spa_chisq(dc, tstat, var, Gres):
        chisq, _lp, fail = spa_mod.spa_batch_auto(
            tstat, var, Gres, dc["Y_hat"], dc["gamma_sqrt"], dc["mask"],
            device=dev, tol=params.tol_spa, niter_max=params.niter_max_spa,
        )
        return chisq, fail

    results_by_mask = {id(bm): {} for bm in vc_masks}
    for ph in range(P):
        if not pd.pheno_pass[ph]:
            continue
        dc = dev_consts(st, pd, ph, dev)
        XW = dc["XW"]
        res_d = torch.as_tensor(np.asarray(st.res[:, ph], np.float64), device=dev)
        GWp, GtWX_d, Svals, Kmat = _bt_products(GW_d, dc, res_d)

        Rvec = np.ones(Mt)
        var_score = np.diag(Kmat).copy()
        if apply_corr:
            with np.errstate(divide="ignore", invalid="ignore"):
                tstat = Svals / np.sqrt(np.where(var_score > 0, var_score, 1.0))
            corr_idx = np.flatnonzero((np.abs(tstat) > z_thr) & (var_score > 0))
            if len(corr_idx):
                ci = torch.as_tensor(corr_idx, device=dev)
                Gres = (GWp[:, ci] - XW @ GtWX_d[:, ci]).T  # [S, N]
                if params.firth:
                    w_ci = torch.as_tensor(weights_full[corr_idx], device=dev)
                    Gv = Gres / dc["gamma_sqrt"][None, :] / w_ci[:, None]
                    lrt, conv = firth_lrt(dc, Gv)
                    chisq_c = np.where(conv, lrt, 0.0)
                else:
                    chisq_c, fail = spa_chisq(
                        dc, tstat[corr_idx], var_score[corr_idx], Gres)
                    chisq_c = np.where(~fail, chisq_c, 0.0)
                for k, i in enumerate(corr_idx):
                    if chisq_c[k] <= 0:
                        Rvec[i] = 0.0
                    else:
                        corrected_var = Svals[i] ** 2 / chisq_c[k]
                        Rvec[i] = np.sqrt(corrected_var / var_score[i])
            Kmat = Kmat * Rvec[:, None] * Rvec[None, :]
        masked_sites = Rvec > 0

        # single-variant logp for ACAT-V (corrected kernel diag)
        with np.errstate(divide="ignore", invalid="ignore"):
            chisq_sv = np.where(
                masked_sites, Svals**2 / np.where(np.diag(Kmat) > 0, np.diag(Kmat), 1.0), 1.0
            )
        logp_sv = chisq_neglog10(chisq_sv)

        for bm in vc_masks:
            res = results_by_mask[id(bm)]
            m_idx = [col_of[int(i)] for i in bm.sel_idx if int(i) in col_of]
            if bm.vc_col in ur_cols:
                m_idx.append(n_main + ur_cols[bm.vc_col])
            m_idx = np.array([i for i in m_idx if masked_sites[i]], dtype=int)
            if len(m_idx) == 0:
                continue
            Km = Kmat[np.ix_(m_idx, m_idx)]
            Sm = Svals[m_idx]
            nnz = len(m_idx)

            if with_acatv and (w_acat_full[m_idx] > 0).any():
                lp = get_acat(logp_sv[m_idx], w_acat_full[m_idx])
                if lp >= 0:
                    res.setdefault("ACATV", np.full((P, 2), -1.0))[ph] = [
                        float(neglog10_to_chisq(np.array([lp]))[0]), lp,
                    ]

            if not (with_skat or with_skato or with_skato_acat or with_acato):
                continue

            Qs = float((Sm**2).sum())
            Qb = float(Sm.sum() ** 2)

            # burden-based kernel inflation (correct_vcov_burden, SKAT.cpp:1151;
            # disabled by --skip-cf-burden, SKAT.cpp:827,1003)
            rfrac = 1.0
            if apply_corr and not params.skip_cf_burden and nnz > 1 and Qb > 0:
                var_qb = Km.sum()
                tb = np.sqrt(Qb / max(var_qb, 1e-300))
                if abs(tb) > z_thr:
                    mi = torch.as_tensor(m_idx, device=dev)
                    gres_b = (GWp[:, mi].sum(dim=1)
                              - XW @ GtWX_d[:, mi].sum(dim=1))[None, :]
                    if params.firth:
                        lrt, conv = firth_lrt(
                            dc, gres_b / dc["gamma_sqrt"][None, :])
                        cb = lrt[0] if conv[0] else 0.0
                    else:
                        cb_arr, fail = spa_chisq(
                            dc, np.array([tb]), np.array([var_qb]), gres_b)
                        cb = cb_arr[0] if not fail[0] else 0.0
                    if cb <= 0:
                        continue
                    rfrac = max(1.0, tb * tb / cb)

            res_ph = {}
            _skato_tests(
                params, res_ph, Sm[None, :], rfrac * Km, rho_vec, nnz, 1,
                with_skat, with_skato, with_skato_acat, with_acato,
                res.get("ACATV", np.full((P, 2), -1.0))[ph : ph + 1]
                if "ACATV" in res else None,
            )
            for name, ss in res_ph.items():
                res.setdefault(name, np.full((P, 2), -1.0))[ph] = ss[0]

    for bm in vc_masks:
        _write_vc_rows(params, eng, writers, bm, results_by_mask[id(bm)])
