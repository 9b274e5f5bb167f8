"""Host-side scalar statistics: p-value transforms (the port's copy of
regenie_tpu/utils/stats.py, trimmed to what the port calls).

Mirrors the reference's Regenie.cpp helpers (get_logp :1843, with the
asymptotic tail expansion for chisq p-values that underflow f64).
"""

from __future__ import annotations

import numpy as np
from scipy.stats import chi2, t as t_dist

_LOG10E = np.log10(np.e)


def chisq_neglog10(tstat):
    """-log10 p for a 1-df chi-square statistic (get_logp, Regenie.cpp:1843).

    Handles the f64-underflow tail with the asymptotic expansion
    log10 p ~ log10(2) - 0.5 log10(2 pi T) - 0.5 T log10(e).
    Vectorized; returns -1 where tstat < 0 (failed test).
    """
    tstat = np.asarray(tstat, dtype=np.float64)
    out = np.full(tstat.shape, -1.0)
    num_err = (tstat < 0) & (np.abs(tstat) < 1e-6)
    out[num_err] = 0.0
    ok = tstat >= 0
    with np.errstate(divide="ignore"):
        pv = chi2.sf(tstat[ok], df=1)
        logp = np.where(
            pv == 0,
            np.log10(2.0) - 0.5 * np.log10(2 * np.pi * np.maximum(tstat[ok], 1e-300))
            - 0.5 * tstat[ok] * _LOG10E,
            np.log10(np.maximum(pv, 5e-324)),
        )
    out[ok] = -logp
    return out


def chisq_neglog10_df(tstat, df):
    """-log10 p for a df-dof chi-square stat (get_logp, Regenie.cpp:1876);
    where the p-value underflows, from the log survival function."""
    tstat = np.asarray(tstat, dtype=np.float64)
    pv = chi2.sf(tstat, df=df)
    with np.errstate(divide="ignore"):
        logp = np.log10(pv)
    bad = ~np.isfinite(logp)
    if np.any(bad):
        logp[bad] = chi2.logsf(tstat[bad], df=df) / np.log(10.0)
    return -logp


def neglog10_to_chisq(logp):
    """-log10 p -> 1-df chisq stat (get_chisq_stat_pv, Regenie.cpp:1892)."""
    logp = np.asarray(logp, dtype=np.float64)
    pv = np.power(10.0, -logp)
    small = pv < 5e-324 * 1e10
    out = np.empty_like(logp)
    out[~small] = chi2.isf(np.maximum(pv[~small], 5e-324), df=1)
    # asymptotic inversion for extreme logp: T ~ 2 ln10 * logp - ln(2 pi T) ...
    if np.any(small):
        T = 2 * np.log(10.0) * logp[small]
        for _ in range(10):
            T = 2 * np.log(10.0) * logp[small] + 2 * np.log(2.0) - np.log(2 * np.pi * T)
        out[small] = T
    return out


def ttest_neglog10(tstat, df):
    """-log10 p for a t statistic (get_logp_ttest, Regenie.cpp:1827)."""
    pv = 2.0 * t_dist.sf(np.abs(tstat), df)
    with np.errstate(divide="ignore"):
        return -np.log10(pv)


def convert_logp_raw(logp) -> str:
    """-log10 p -> p-value string (convert_logp_raw, Regenie.cpp:1700):
    %f for p >= 1e-3, %g down to double-min, then manual
    mantissa/exponent split to go below double-min."""
    log_dbl_min = -np.log10(np.finfo(np.float64).tiny) - 1
    if logp <= 3:
        return "%f" % (10.0 ** (-logp))
    if logp <= log_dbl_min:
        return "%g" % (10.0 ** (-logp))
    thr = np.log(9.95) / np.log(10.0)
    base = int(np.ceil(logp))
    res = base - logp
    if res >= thr:
        res = 0.0
        base += 1
    return "%.1fe-%d" % (10.0**res, base)


def rss_line() -> str:
    """Current resident-set size (print_mem/get_mem, Regenie.cpp:1942:
    'memory usage=NMB' debug trail in block loops)."""
    try:
        with open("/proc/self/status") as fh:
            for line in fh:
                if line.startswith("VmRSS:"):
                    return f"memory usage={float(line.split()[1]) / 1024:.0f}MB"
    except OSError:
        pass
    return "memory usage=?"


def peak_rss_line() -> str:
    """Peak resident-set size (get_mem, Regenie.cpp:1942-1959; printed in
    debug mode at the end of a run)."""
    try:
        with open("/proc/self/status") as fh:
            for line in fh:
                if line.startswith("VmHWM:"):
                    return f" * peak memory usage : {float(line.split()[1]) / 1e6:.1f}GB"
    except OSError:
        pass
    return " * peak memory usage : unavailable"


def usage_info_line(params) -> str:
    """Approximate host-memory estimate (print_usage_info,
    Regenie.cpp:1510-1552): per-sample double vectors held in RAM
    (quantitative traits)."""
    P, B = params.n_pheno, params.block_size
    if not params.test_mode:
        t_eff = 1 if params.write_l0_pred else max(params.total_n_block, 1)
        p_eff = 1 if params.write_l0_pred else P
        b_eff = max(params.total_n_block, 1)
        total = 4 * P + params.n_chrom + params.ncov
        total += max(B + P * params.n_ridge_l0 * t_eff,
                     p_eff * params.n_ridge_l0 * b_eff)
    else:
        total = 3 * P + B + 2 * params.ncov + B
    ram = total * params.n_samples * 8.0
    unit = "GB" if ram > 1e9 else "MB"
    val = ram / (1e9 if unit == "GB" else 1e6)
    return f" * approximate memory usage : {val:.0f}{unit}"
