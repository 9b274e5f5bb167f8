"""Joint tests over burden masks of a set: MINP / ACAT / F-test / GATES /
SBAT, and the GENE_P strategy (the port's copy of
regenie_tpu/models/joint.py; numpy and scipy on the host).

Reference: Joint_Tests.cpp apply_joint_test (:131), compute_minp (:246),
compute_acat (:257), compute_qr_G (:398), compute_ftest (:448),
compute_gates (:580), get_me (:668).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
from scipy.stats import beta as beta_dist
from scipy.stats import f as f_dist

from ..config import QT, Params
from ..prep import fmt
from .skat import get_acat
from ..utils.stats import neglog10_to_chisq

TEST_NAMES = {"minp": "MINP", "ftest": "F", "gates": "GATES", "acat": "ACAT"}
ACAT_A1, ACAT_A2 = 1.0, 25.0


def run_joint_tests(params: Params, eng, vset, built, writers, log):
    """Run requested joint tests for one set and write per-pheno rows."""
    pd = eng.pd
    P = params.n_pheno
    r = getattr(eng, "_last_mask_result", None)
    if r is None or not built:
        return
    B = len(built)

    # mask genotype matrix, residualized+scaled for QT (compute_qr_G input;
    # the engine stashes the residualized block after testing)
    G = eng.last_G_res.T  # [N, B]
    qr_tests = [t for t in params.joint_tests if t in ("ftest", "gates", "sbat")]

    for ph in range(P):
        if not pd.pheno_pass[ph]:
            continue
        good = (~r.ignored) & (~r.ignored_trait[:, ph]) & (~r.test_fail[:, ph])
        logpv = np.where(good, r.logp[:, ph], 0.0)
        nvars = int(good.sum())
        if nvars == 0:
            continue
        yres = eng.res[:, ph]
        mask = pd.masked_indivs[:, ph]
        rows = []

        if "minp" in params.joint_tests:
            lp = logpv[good].max()
            # Sidak-style: p = min pv (reference get_pv on min)
            pv_min = 10.0 ** (-lp)
            rows.append(("MINP", -np.log10(max(pv_min, 5e-324)), nvars))

        if "acat" in params.joint_tests:
            wts = np.zeros(B)
            for b in range(B):
                if not good[b]:
                    continue
                if params.mask_rule == "max":
                    maf = min(built[b].af_t[ph], 1 - built[b].af_t[ph])
                    w = beta_dist.pdf(maf, params.acat_a1, params.acat_a2)
                    wts[b] = maf * (1 - maf) * w * w
                else:
                    wts[b] = 1.0
            lp = get_acat(logpv, wts)
            if lp >= 0:
                rows.append(("ACAT", lp, nvars))

        if qr_tests:
            # keep linearly independent mask columns (compute_qr_G)
            Gm = G[:, good] * mask[:, None]
            keep_idx = np.flatnonzero(good)
            q, rr, piv = _qr_colperm(Gm, params.qr_tol)
            df_test = len(piv)
            Gt = Gm[:, piv]
            kept_logpv = logpv[keep_idx[piv]]

            if "ftest" in params.joint_tests and params.trait_mode == QT and df_test > 0:
                ns = int(mask.sum()) - params.ncov_analyzed
                df_ur = ns - df_test
                if df_ur > 0:
                    y_t = yres * mask
                    GtG = Gt.T @ Gt
                    try:
                        bhat = np.linalg.solve(GtG, Gt.T @ y_t)
                        yhat = Gt @ bhat
                        ss_m = (yhat**2).sum()
                        ss_r = ns - ss_m
                        zval = (ss_m / df_test) / (ss_r / df_ur)
                        if zval >= 0:
                            pv = f_dist.sf(zval, df_test, df_ur)
                            rows.append(
                                ("F", -np.log10(max(pv, 5e-324)), df_test, zval)
                            )
                    except np.linalg.LinAlgError:
                        pass

            if "gates" in params.joint_tests and df_test > 0:
                lp = _gates(Gt, kept_logpv, float(params.n_analyzed - params.ncov_analyzed))
                if lp >= 0:
                    rows.append(("GATES", lp, df_test))

            if "sbat" in params.joint_tests and params.trait_mode == QT and df_test > 0:
                ns = int(mask.sum()) - params.ncov_analyzed
                df_ur = ns - df_test
                if df_ur > 0:
                    out = _sbat(Gt, yres * mask, df_ur, rng_seed=params.seed,
                                napprox=params.sbat_napprox,
                                adaptive=params.sbat_adapt,
                                wts_in=_mtw_get(params, eng, "ALL", df_test))
                    if out is not None:
                        lp_pos, lp_neg, wts = out
                        _mtw_put(params, eng, "ALL", df_test, wts)
                        lp = get_acat(np.array([lp_pos, lp_neg]))
                        if lp >= 0:
                            rows.append(("SBAT", lp, df_test))
                            if params.sbat_verbose:
                                # --sbat-verbose: one-sided splits
                                # (nnls_verbose_out, Joint_Tests.cpp:188-197)
                                rows.append(("SBAT_POS", lp_pos, df_test))
                                rows.append(("SBAT_NEG", lp_neg, df_test))

        for row in rows:
            name, lp, df = row[0], row[1], row[2]
            zval = row[3] if len(row) > 3 else float(neglog10_to_chisq(np.array([lp]))[0])
            if params.htp_out:
                from ..io.output import htp_pvalue_line

                wgr = "" if params.skip_blups else "-WGR"
                ncase, nctrl = eng.pheno_counts(ph)
                writers[ph].write(
                    htp_pvalue_line(
                        params, vset, pd.pheno_names[ph],
                        f"ADD{wgr}-BURDEN-{name}", lp, df, ncase, nctrl,
                    )
                )
                continue
            writers[ph].write(
                _joint_line(params, vset, name, lp, zval, df, int(pd.Neff[ph]))
            )


def _qr_colperm(G, tol):
    """Column-pivoted QR rank selection (ColPivHouseholderQR semantics)."""
    from scipy.linalg import qr as scipy_qr

    if G.shape[1] == 0:
        return None, None, []
    Q, R, piv = scipy_qr(G, mode="economic", pivoting=True)
    diag = np.abs(np.diag(R))
    if diag[0] == 0:
        return Q, R, []
    rank = int((diag > diag[0] * tol).sum())
    return Q, R, list(piv[:rank])


def _gates(Gt, logpv, scale_denum):
    """GATES extended Simes (compute_gates, Joint_Tests.cpp:580)."""
    df = Gt.shape[1]
    if df == 0:
        return -1.0
    if df == 1:
        return float(logpv[0])
    pvals = 10.0 ** (-logpv)
    order = np.argsort(pvals, kind="stable")
    sorted_pv = pvals[order]
    tmpG = Gt[:, order]
    GtG = tmpG.T @ tmpG / scale_denum
    corP = (
        0.7723 * GtG**6 - 1.5659 * GtG**5 + 1.201 * GtG**4
        - 0.2355 * GtG**3 + 0.2184 * GtG**2 + 0.6086 * GtG
    )
    m_e = _me(corP)
    p_gates = 1.0
    for i in range(df):
        m_ei = _me(corP[: i + 1, : i + 1])
        p_i = m_e * sorted_pv[i] / m_ei
        p_gates = min(p_gates, p_i)
    if p_gates < 0:
        return -1.0
    return float(-np.log10(max(p_gates, 5e-324)))


def _me(ldmat):
    """Effective number of tests (get_me, Joint_Tests.cpp:668)."""
    n = ldmat.shape[1]
    if n == 1:
        return 1.0
    D = np.linalg.eigvalsh(ldmat)
    return n - np.where(D > 1, D - 1, 0).sum()


def _joint_line(params, vset, tname, logp, zval, df, n):
    """One joint-test row (print_sum_stats, Joint_Tests.cpp:880)."""
    parts = [str(vset.chrom), str(vset.physpos), vset.ID, "NA", "NA", "NA"]
    if params.dosage_mode:
        parts.append("NA")
    parts.append(str(n))
    parts.append(f"ADD-BURDEN-{tname}")
    parts += ["NA", "NA"]
    parts.append(fmt(zval) if zval >= 0 else "NA")
    parts.append(fmt(logp) if logp >= 0 else "NA")
    parts.append(f"DF={df}")
    return " ".join(parts) + "\n"



def _genep_classes(params, mask_names):
    """Mask groups for the GENE_P strategy (check_class_genep,
    Joint_Tests.cpp:1084). Returns (all_masks, all_sfx, {sfx: set})."""
    classes: Dict[str, set] = {}
    all_masks, all_sfx = True, ""

    def add_class(sfx, masks):
        nonlocal all_masks, all_sfx
        valid = {m for m in masks if m in mask_names}
        if not valid:
            return
        if valid == set(mask_names):
            all_masks, all_sfx = True, sfx
        else:
            classes[sfx] = valid

    if params.genep_mask_sets_file:
        all_masks = False
        from ..io.files import iter_lines

        for toks in iter_lines(params.genep_mask_sets_file):
            if len(toks) < 2:
                raise ValueError(f"invalid --rgc-gene-def line: {toks}")
            if toks[0] in classes:
                raise ValueError(f"GENE_P_'{toks[0]}' defined twice")
            add_class(toks[0], toks[1].split(","))
    else:
        for nm in ("M1", "pLoF", "LoF"):
            add_class(nm, [nm])
    return all_masks, all_sfx, classes


def run_gene_p(params: Params, eng, vset, built, writers, log):
    """GENE_P strategy (run_single_p_acat, Joint_Tests.cpp:684-860): per
    mask group, ACAT-combine BURDEN-ACAT, SBAT, ACATV-ACAT and
    SKATO-ACAT into one gene p-value; track the strongest mask."""
    pd = eng.pd
    r = getattr(eng, "_last_mask_result", None)
    if r is None or not built:
        return
    B = len(built)
    vc_res = getattr(eng, "_last_vc_results", {})
    mask_names = {bm.mask_name for bm in built}
    all_masks, all_sfx, classes = _genep_classes(params, mask_names)
    routes = []
    if all_masks:
        routes.append((all_sfx, mask_names))
    routes += sorted(classes.items())
    G = eng.last_G_res.T if params.trait_mode == QT else None  # [N, B]
    run_sbat = (
        "sbat" in params.joint_tests and params.trait_mode == QT
        and not params.skip_sbat
    )

    for ph in range(params.n_pheno):
        if not pd.pheno_pass[ph]:
            continue
        mask = pd.masked_indivs[:, ph]
        yres = eng.res[:, ph] if params.trait_mode == QT else None

        for sfx, members in routes:
            tag = "" if sfx == "" else "_" + sfx
            good = np.array([
                (bm.mask_name in members) and not r.ignored[b]
                and not r.ignored_trait[b, ph] and not r.test_fail[b, ph]
                for b, bm in enumerate(built)
            ])
            overall, rows = {}, []
            max_logp, max_mask = -1.0, ""
            acatv, skato = [], []
            for b, bm in enumerate(built):
                if bm.mask_name not in members:
                    continue
                if good[b] and r.logp[b, ph] > max_logp and r.logp[b, ph] > 0:
                    max_logp, max_mask = r.logp[b, ph], bm.mask_name
                res = vc_res.get(id(bm))
                if res is None:
                    continue
                for tname, dest in (("ACATV", acatv), ("SKATO-ACAT", skato)):
                    if tname in res and res[tname][ph, 1] >= 0:
                        pv = res[tname][ph, 1]
                        if pv > max_logp:
                            max_logp, max_mask = pv, bm.mask_name
                        dest.append(pv)

            n_good = int(good.sum())
            if n_good > 0:
                lp = get_acat(np.where(good, r.logp[:, ph], 0.0),
                              good.astype(np.float64))
                if lp >= 0:
                    overall["BURDEN-ACAT"] = lp
                    zv = float(neglog10_to_chisq(np.array([lp]))[0])
                    rows.append((f"ADD-BURDEN-ACAT{tag}", lp, zv, n_good, ""))

                if run_sbat:
                    keep = np.flatnonzero(good)
                    Gm = G[:, keep] * mask[:, None]
                    _q, _rr, piv = _qr_colperm(Gm, params.qr_tol)
                    df = len(piv)
                    ns = int(mask.sum()) - params.ncov_analyzed
                    if df > 0 and ns - df > 0:
                        out = _sbat(Gm[:, piv], yres * mask, ns - df,
                                    rng_seed=params.seed,
                                    napprox=params.sbat_napprox,
                                    adaptive=params.sbat_adapt,
                                    wts_in=_mtw_get(params, eng, sfx, df))
                        if out is not None:
                            lp_p, lp_n, wts = out
                            _mtw_put(params, eng, sfx, df, wts)
                            lp = get_acat(np.array([lp_p, lp_n]))
                            if lp >= 0:
                                overall["SBAT"] = lp
                                zv = float(neglog10_to_chisq(np.array([lp]))[0])
                                rows.append((f"ADD-BURDEN-SBAT{tag}", lp, zv, df, ""))
                                zv = float(neglog10_to_chisq(np.array([lp_p]))[0])
                                rows.append((f"ADD-BURDEN-SBAT_POS{tag}", lp_p, zv, df, ""))
                                zv = float(neglog10_to_chisq(np.array([lp_n]))[0])
                                rows.append((f"ADD-BURDEN-SBAT_NEG{tag}", lp_n, zv, df, ""))

            for name, vals in (("ACATV-ACAT", acatv), ("SKATO-ACAT", skato)):
                if vals:
                    lp = get_acat(np.array(vals))
                    if lp >= 0:
                        overall[name] = lp
                        zv = float(neglog10_to_chisq(np.array([lp]))[0])
                        rows.append((f"ADD-{name}{tag}", lp, zv, len(vals), ""))

            if overall:
                pv_all = np.array(list(overall.values()))
                lp = get_acat(pv_all)
                zv = float(neglog10_to_chisq(np.array([lp]))[0])
                rows.append((f"GENE_P{tag}", lp, zv, len(pv_all), max_mask))

            for tname, lp, zv, df, strongest in rows:
                if params.htp_out:
                    from ..io.output import htp_pvalue_line

                    ncase, nctrl = eng.pheno_counts(ph)
                    writers[ph].write(
                        htp_pvalue_line(
                            params, vset, pd.pheno_names[ph], tname, lp, df,
                            ncase, nctrl, strongest,
                        )
                    )
                    continue
                extra = f"DF={df}"
                if strongest:
                    extra += f";STRONGEST_MASK={strongest}"
                writers[ph].write(
                    _gene_line(params, vset, tname, lp, zv, int(pd.Neff[ph]), extra)
                )


def _gene_line(params, vset, tname, logp, zval, n, extra):
    """GENE_P-family row (print_sum_stats_gene, Joint_Tests.cpp:974)."""
    parts = [str(vset.chrom), str(vset.physpos), vset.ID, "NA", "NA", "NA"]
    if params.dosage_mode:
        parts.append("NA")
    parts.append(str(n))
    parts.append(tname)
    parts += ["NA", "NA"]
    parts.append(fmt(zval) if zval >= 0 else "NA")
    parts.append(fmt(logp) if logp >= 0 else "NA")
    parts.append(extra)
    return " ".join(parts) + "\n"


def _mtw_get(params, eng, input_class, p):
    """--sbat-mtw weight reuse: weights keyed by (mask class, #masks)
    persist across traits and sets (nnls_weights, Joint_Tests.cpp:538)."""
    if not params.sbat_mtw:
        return None
    return getattr(eng, "_sbat_wts_cache", {}).get((input_class, p))


def _mtw_put(params, eng, input_class, p, wts):
    if not params.sbat_mtw or wts is None:
        return
    if not hasattr(eng, "_sbat_wts_cache"):
        eng._sbat_wts_cache = {}
    eng._sbat_wts_cache.setdefault((input_class, p), wts)


def _nnls_kkt(XtX, Xty, tol=1e-10, maxit=1000):
    """Active-set NNLS on normal equations; returns bhat >= 0."""
    from scipy.optimize import nnls as scipy_nnls

    # use a Cholesky square root so scipy.nnls works on the summary form
    L = np.linalg.cholesky(XtX + 1e-12 * np.eye(XtX.shape[0]))
    # solve min ||L^T b - z||^2 with z = L^-1 Xty
    z = np.linalg.solve(L, Xty)
    b, _ = scipy_nnls(L.T, z)
    return b


def _chibar_weights_mc(V, n_sims=5000, seed=1):
    """Chi-bar-square weights by Monte Carlo: simulate z ~ N(0, V), count
    positive components of the NNLS projection. Used as the fallback when
    the Genz orthant decomposition fails, and as the test oracle for
    `_chibar_weights_genz`."""
    p = V.shape[0]
    rng = np.random.default_rng(seed)
    Vinv = np.linalg.pinv(V)
    L = np.linalg.cholesky(V + 1e-12 * np.eye(p))
    counts = np.zeros(p + 1)
    Z = rng.standard_normal((n_sims, p)) @ L.T
    for z in Z:
        b = _nnls_kkt(Vinv, Vinv @ z)
        counts[(b > 1e-12).sum()] += 1
    return counts / n_sims


def _orthant_prob(V, seed=1905):
    """P(Z > 0) for Z ~ N(0, V) (jburden_pnorm, NNLS.cpp:233). Genz
    randomized quadrature via scipy for p >= 3 (scipy's mvndst is the
    same Genz algorithm the reference links from mvtnorm); closed forms
    for p <= 2. Returns -1 on failure (mirrors the reference's error
    signal).

    The Genz lattice's random shifts are SEEDED (scipy's frozen-dist
    `seed=`) — an unseeded cdf drifts in the ~5th digit between calls,
    which made SBAT output (and its tests) flap run-to-run."""
    p = V.shape[0]
    if p == 1:
        return 0.5
    d = np.diag(V)
    if not np.all(d > 0) or not np.all(np.isfinite(V)):
        return -1.0
    sd = np.sqrt(d)
    R = V / np.outer(sd, sd)
    if p == 2:
        return 0.25 + np.arcsin(float(np.clip(R[0, 1], -1.0, 1.0))) / (2 * np.pi)
    from scipy.stats import multivariate_normal

    try:
        v = float(
            multivariate_normal(
                mean=np.zeros(p), cov=R, allow_singular=True, seed=seed
            ).cdf(np.zeros(p))
        )
    except Exception:
        return -1.0
    if not np.isfinite(v) or v < 0:
        return -1.0
    return v


def _chibar_weights_genz(V, napprox, rng):
    """Chi-bar-square weights by the Kudo subset decomposition with Genz
    MVN orthant probabilities (jburden_wts_adapt, NNLS.cpp:864).

    w[k] (the chi2_k mixture weight) sums pnorm(V11^-1)*pnorm(V22.1)
    over active sets alpha of size k; exact when C(n,k) <= napprox,
    otherwise a mean over napprox uniformly sampled sets scaled by
    C(n,k). Normalization follows the reference: approximated weights
    are scaled so the total mass is 1 (exact ones untouched), then the
    residual is absorbed into the largest weight. Returns None on
    failure."""
    from itertools import combinations
    from math import comb

    n = V.shape[0]
    wts = np.zeros(n + 1)
    exact = np.zeros(n + 1, dtype=bool)
    w_n = _orthant_prob(V)
    try:
        Vinv = np.linalg.inv(V)
    except np.linalg.LinAlgError:
        return None
    w_0 = _orthant_prob(Vinv)
    if w_n < 0 or w_0 < 0:
        return None
    wts[n], wts[0] = w_n, w_0
    exact[n] = exact[0] = True

    idx = np.arange(n)
    for i in range(1, n):
        n_sets = comb(n, i)
        approx = 0 < napprox < n_sets
        if approx:
            sets = [rng.choice(n, size=i, replace=False) for _ in range(napprox)]
        else:
            sets = [np.asarray(c, dtype=int) for c in combinations(range(n), i)]
        comp = np.empty(len(sets))
        for j, s2 in enumerate(sets):
            s1 = np.setdiff1d(idx, s2)
            V11 = V[np.ix_(s1, s1)]
            try:
                V11inv = np.linalg.inv(V11)
            except np.linalg.LinAlgError:
                return None
            V220 = (
                V[np.ix_(s2, s2)]
                - V[np.ix_(s2, s1)] @ V11inv @ V[np.ix_(s1, s2)]
            )
            w1 = _orthant_prob(V11inv)
            w2 = _orthant_prob(V220)
            if w1 < 0 or w2 < 0:
                return None
            comp[j] = w1 * w2
        wts[i] = comp.mean() * n_sets if approx else comp.sum()
        exact[i] = not approx

    if (~exact).any():
        sum_approx = wts[~exact].sum()
        if sum_approx > 0:
            wts[~exact] *= (1.0 - wts[exact].sum()) / sum_approx
    k = int(np.argmax(wts))
    wts[k] = 1.0 - (wts.sum() - wts[k])
    return wts


# p-value threshold below which the adaptive strategy upgrades from the
# cheap napprox=2 weights to the requested accuracy (adapt_thr,
# Joint_Tests.cpp:510)
_SBAT_ADAPT_THR = 1e-3
_SBAT_ADAPT_NAPPROX = 2  # adapt_napprox, Joint_Tests.cpp:503


def _sbat(Gt, y, df_ur, rng_seed=1, napprox=10, adaptive=False, wts_in=None):
    """SBAT / NNLS joint burden test (compute_nnls, Joint_Tests.cpp:495;
    NNLS.cpp fit_nnls_sign + jburden_pchisq_bar).

    `adaptive` runs the reference's --sbat-adapt strategy: weights from
    napprox=2 sampled sets first, recomputed at full `napprox` only when
    the min one-sided p-value crosses 1e-3 (Joint_Tests.cpp:520-534).
    `wts_in` reuses precomputed weights (--sbat-mtw).

    Returns (-log10 p_pos, -log10 p_neg, wts) or None on failure."""
    from scipy.stats import chi2 as _chi2

    n, p = Gt.shape
    XtX = Gt.T @ Gt
    Xty = Gt.T @ y
    try:
        bhat_ols = np.linalg.solve(XtX, Xty)
    except np.linalg.LinAlgError:
        return None
    rss = ((y - Gt @ bhat_ols) ** 2).sum()
    sigma2 = rss / df_ur
    V = sigma2 * np.linalg.pinv(XtX)

    rng = np.random.default_rng(rng_seed)
    if wts_in is not None and len(wts_in) == p + 1:
        wts = wts_in
    elif adaptive:
        # orthant probabilities are scale-invariant, so the cheap pass
        # uses XtX^-1 directly (Joint_Tests.cpp:524-528)
        wts = _chibar_weights_genz(np.linalg.pinv(XtX), _SBAT_ADAPT_NAPPROX, rng)
    else:
        wts = _chibar_weights_genz(V, napprox, rng)
    if wts is None:
        wts = _chibar_weights_mc(V, n_sims=max(napprox, 5000), seed=rng_seed)

    def one_sided(sign, w):
        b = _nnls_kkt(XtX, sign * Xty)
        stat = b @ (XtX @ b) / sigma2
        # P(chibar > stat) = sum_k w_k P(chi2_k > stat), chi2_0 has mass at 0
        pv = sum(w[k] * _chi2.sf(stat, k) for k in range(1, p + 1) if w[k] > 0)
        return max(pv, 5e-324)

    p_pos = one_sided(+1, wts)
    p_neg = one_sided(-1, wts)
    if adaptive and wts_in is None and min(p_pos, p_neg) < _SBAT_ADAPT_THR:
        w2 = _chibar_weights_genz(V, napprox, rng)
        if w2 is not None:
            wts = w2
            p_pos = one_sided(+1, wts)
            p_neg = one_sided(-1, wts)
    return -np.log10(p_pos), -np.log10(p_neg), wts
