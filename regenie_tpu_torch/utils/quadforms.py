"""P-values for mixtures of chi-square_1 variables: Q ~ sum lambda_i X_i
(the port's copy of regenie_tpu/utils/quadforms.py; numpy, on the host).

Replacement for the reference's vendored native libs (SURVEY.md §2.2):
qf/qfc.cpp (Davies) -> vectorized Imhof CF inversion (phase-bounded
Gauss-Legendre panels + van Wijngaarden tail acceleration, davies_pv);
Kuonen saddlepoint (SKAT.cpp:1566-1688) and Liu moment-matching
(SKAT.cpp:1625) reimplemented directly. Host scalar code — per variant
set, never per sample (SURVEY.md §2.2 replacement strategy).

Fallback chain mirrors get_chisq_mix_logp (SKAT.cpp:1500): davies ->
kuonen (if p<=1e-5) -> strict davies -> liu.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy.stats import chi2, ncx2, norm

_DBL_DMIN = 10.0 * np.finfo(np.float64).tiny


_GL_X, _GL_W = np.polynomial.legendre.leggauss(12)
_GL_X01 = 0.5 * (_GL_X + 1.0)  # nodes on [0, 1]
_GL_W01 = 0.5 * _GL_W


def davies_pv(q: float, lambdas: np.ndarray, strict: bool = False,
              qeff: float = None) -> float:
    """P(Q > q) by numerical inversion of the characteristic function
    (Imhof 1961), replacing Davies' qf (vendored qf/qfc.cpp, used at
    SKAT.cpp:1541).

    The Imhof integrand sin(theta(u)) / (u rho(u)) oscillates with
    asymptotic half-period pi / (q/2), which defeats generic adaptive
    quadrature. Instead: fixed panels of width 2*pi / max(q, sum(lam))
    (each spans <= pi of phase since |theta'| <= max(q, sum lam)/2), a
    12-point Gauss-Legendre rule per panel — all panels evaluated in one
    vectorized sweep — and van Wijngaarden (iterated-averaging)
    acceleration of the eventually-alternating panel-sum tail.
    Returns -1 on failure."""
    lam = np.asarray(lambdas, dtype=np.float64)
    if len(lam) == 1:  # exact: scaled chi2_1
        return float(chi2.sf(q / lam[0], df=1))

    # qeff override: any qeff >= max(q, sum(lam)) is a valid (finer)
    # panel width — each panel still spans <= pi of phase since
    # |theta'| <= max(q, sum lam)/2 <= qeff/2.  The SKATO grid's
    # banded shared-h sweep uses this to share nodes across points.
    if qeff is None:
        qeff = max(q, float(lam.sum()), 1e-30)
    h = 2.0 * np.pi / qeff
    n_direct = 1024 if strict else 256
    n_accel = 64
    chunk = 64

    def eval_panels(k0, kc):
        # panel quadrature nodes [kc, 12]; returns (panel sums [kc],
        # envelope at the last node)
        pts = (np.arange(k0, k0 + kc, dtype=np.float64)[:, None]
               + _GL_X01[None, :]) * h
        lu = lam[:, None, None] * pts[None, :, :]
        theta = 0.5 * np.arctan(lu).sum(axis=0) - 0.5 * q * pts
        log_rho = 0.25 * np.log1p(lu * lu).sum(axis=0)
        f = np.sin(theta) * np.exp(-log_rho) / pts
        env = np.exp(-log_rho[-1, -1]) / pts[-1, -1]
        return (f * _GL_W01[None, :]).sum(axis=1) * h, env

    # direct panels in chunks; the integrand magnitude envelope
    # exp(-log_rho(u))/u is monotone decreasing, so once it drops below
    # 1e-15 the remaining panels AND the accelerated tail are bounded by
    # n_accel*h*env < 1e-12 and the sweep stops — large-rank kernels
    # (many lambdas) finish in the first chunk
    val = 0.0
    k0 = 0
    env = np.inf
    while k0 < n_direct:
        kc = min(chunk, n_direct - k0)
        panels_c, env = eval_panels(k0, kc)
        val += float(panels_c.sum())
        k0 += kc
        if env < 1e-15:
            break
    if env >= 1e-15:
        # iterated averaging of the alternating tail's partial sums
        panels_t, _env = eval_panels(k0, n_accel)
        ps = np.cumsum(panels_t)
        while len(ps) > 1:
            ps = 0.5 * (ps[:-1] + ps[1:])
        val += float(ps[0])

    pv = 0.5 + val / np.pi
    if not np.isfinite(pv) or pv <= 0 or pv > 1:
        return -1.0
    return pv


def davies_pv_batch(qs: np.ndarray, lam: np.ndarray) -> np.ndarray:
    """davies_pv for a batch of q sharing ONE spectrum, each q with its
    own panel width h = 2*pi/max(q, sum(lam)) (the scalar routine's
    qeff).  Bitwise-identical per element to davies_pv: same nodes, the
    same reduction axes in the same order (lambda axis first, then the
    12-node axis, then per-chunk panel sums added chunk-by-chunk), the
    same per-q early exit on the magnitude envelope, and the same
    van Wijngaarden tail acceleration (only for q that ran all direct
    panels, exactly like the scalar loop).  This removes the per-point
    scalar Davies sweep from the SKATO mixture-SF grid's above-sum(lam)
    suffix — the gene-based vctails host hot spot (reference analog:
    the per-set qf loop, SKAT.cpp:1541)."""
    lam = np.asarray(lam, dtype=np.float64)
    qs = np.asarray(qs, dtype=np.float64)
    nq = len(qs)
    if nq == 0:
        return np.empty(0)
    if len(lam) == 1:  # exact: scaled chi2_1
        return np.asarray(chi2.sf(qs / lam[0], df=1))
    L = len(lam)
    n_direct, n_accel, chunk = 256, 64, 64
    # memory-bound q-chunking (per-q independence makes this exact):
    # working set is [L, qc, chunk, 12] twice over
    qc_max = max(1, 8_000_000 // (L * chunk * 12))
    if nq > qc_max:
        return np.concatenate([
            davies_pv_batch(qs[i:i + qc_max], lam)
            for i in range(0, nq, qc_max)])

    qeff = np.maximum(np.maximum(qs, float(lam.sum())), 1e-30)
    h = 2.0 * np.pi / qeff  # [nq]

    def panels_for(k0, kc, qv, hv):
        pts = (np.arange(k0, k0 + kc, dtype=np.float64)[None, :, None]
               + _GL_X01[None, None, :]) * hv[:, None, None]  # [m,kc,12]
        lu = lam[:, None, None, None] * pts[None]
        theta = (0.5 * np.arctan(lu).sum(axis=0)
                 - 0.5 * qv[:, None, None] * pts)
        log_rho = 0.25 * np.log1p(lu * lu).sum(axis=0)
        f = np.sin(theta) * np.exp(-log_rho) / pts
        env = np.exp(-log_rho[:, -1, -1]) / pts[:, -1, -1]  # [m]
        return (f * _GL_W01[None, None, :]).sum(axis=2) * hv[:, None], env

    val = np.zeros(nq)
    env = np.full(nq, np.inf)
    alive = np.ones(nq, bool)
    k0 = 0
    while k0 < n_direct and alive.any():
        kc = min(chunk, n_direct - k0)
        # evaluate only the q still alive at chunk entry (per-q
        # independence: identical values to the full sweep); the scalar
        # loop adds the chunk in which the envelope drops, THEN breaks
        idx = np.flatnonzero(alive)
        panels_c, env_c = panels_for(k0, kc, qs[idx], h[idx])
        val[idx] += panels_c.sum(axis=1)
        env[idx] = env_c
        k0 += kc
        alive &= ~(env < 1e-15)
    if alive.any():
        # every surviving q ran all n_direct panels, so the accelerated
        # tail starts at the same k0 = n_direct for all of them
        idx = np.flatnonzero(alive)
        panels_t, _env = panels_for(n_direct, n_accel, qs[idx], h[idx])
        ps = np.cumsum(panels_t, axis=1)
        while ps.shape[1] > 1:
            ps = 0.5 * (ps[:, :-1] + ps[:, 1:])
        val[idx] += ps[:, 0]

    pv = 0.5 + val / np.pi
    bad = ~np.isfinite(pv) | (pv <= 0) | (pv > 1)
    return np.where(bad, -1.0, pv)


def _davies_shared_h(qs: np.ndarray, lam: np.ndarray,
                     qeff: float = None) -> np.ndarray:
    """davies_pv for a batch of q sharing ONE panel width
    h = 2*pi/qeff, qeff >= max(max(qs), sum(lam)) (default: sum(lam),
    valid when all q <= sum(lam)).  The q-independent arctan/log1p
    sweeps (the transcendental cost, L x panels x nodes) are computed
    once and shared; only sin(theta) is per-q.  Bitwise-identical to
    the scalar davies_pv(q, lam, qeff=qeff) per element: the hoisted
    arrays are the exact values the scalar computes, and every
    reduction keeps its axis length (numpy pairwise-summation order
    unchanged).  The envelope is q-independent, so all points share
    the scalar's early-exit chunk."""
    nq = len(qs)
    if qeff is None:
        qeff = max(float(lam.sum()), 1e-30)
    h = 2.0 * np.pi / qeff
    n_direct, n_accel, chunk = 256, 64, 64

    val = np.zeros(nq)
    k0 = 0
    env = np.inf

    def panels_for(k0, kc):
        pts = (np.arange(k0, k0 + kc, dtype=np.float64)[:, None]
               + _GL_X01[None, :]) * h  # [kc, 12] — shared by all q
        lu = lam[:, None, None] * pts[None, :, :]
        atsum = np.arctan(lu).sum(axis=0)  # [kc, 12]
        log_rho = 0.25 * np.log1p(lu * lu).sum(axis=0)
        theta = 0.5 * atsum[None] - 0.5 * qs[:, None, None] * pts[None]
        f = np.sin(theta) * np.exp(-log_rho)[None] / pts[None]
        env = np.exp(-log_rho[-1, -1]) / pts[-1, -1]
        return (f * _GL_W01[None, None, :]).sum(axis=2) * h, env  # [nq, kc]

    while k0 < n_direct:
        kc = min(chunk, n_direct - k0)
        panels_c, env = panels_for(k0, kc)
        val += panels_c.sum(axis=1)
        k0 += kc
        if env < 1e-15:
            break
    if env >= 1e-15:
        panels_t, _env = panels_for(k0, n_accel)
        ps = np.cumsum(panels_t, axis=1)
        while ps.shape[1] > 1:
            ps = 0.5 * (ps[:, :-1] + ps[:, 1:])
        val += ps[:, 0]

    pv = 0.5 + val / np.pi
    bad = ~np.isfinite(pv) | (pv <= 0) | (pv > 1)
    return np.where(bad, -1.0, pv)


def chisq_mix_sf_grid(qs: np.ndarray, lambdas: np.ndarray) -> np.ndarray:
    """chisq_mix_pv over an ASCENDING grid of q sharing one PRESORTED
    normalized spectrum (the SKATO mixture-SF grid, SKAT.cpp:1841-1935's
    repeated qf calls — the gene-based host hot spot at scale).

    Work cuts vs the per-point loop (r5 design):
      * Davies panel nodes are SHARED across points in geometric
        h-bands: the q <= sum(lam) prefix uses h = 2*pi/sum(lam) (the
        scalar width — bitwise-identical there), and the suffix is cut
        into bands of ratio 2 sharing h = 2*pi/band_qmax.  Any
        qeff >= max(q, sum lam) is a valid (finer) panel width — each
        panel still spans <= pi of phase — so band members get the
        scalar algorithm at a slightly finer width, and the
        q-independent arctan/log1p transcendentals (the dominant host
        cost of the gene-based vctails stage) are paid once per band
        instead of once per point.  Per element this equals
        davies_pv(q, lam, qeff=band_qeff) bit-for-bit.
      * Bands are evaluated LAZILY in ascending order: the SF is
        decreasing in q, so once Davies drops <= 1e-5 every later point
        takes the saddlepoint branch directly and its band is never
        evaluated.  (Within ~1 grid point of the 1e-5 crossover this
        can pick the saddlepoint where the scalar chain kept a Davies
        value just above threshold; both are accurate there and the
        choice is deterministic.)
      * the saddlepoint tail evaluates as ONE kuonen_pv_batch call
        (bitwise-identical per element) instead of per-point Newton.
    """
    qs = np.asarray(qs, dtype=np.float64)
    lam = np.asarray(lambdas, dtype=np.float64)
    out = np.empty(len(qs))
    if len(lam) == 1:
        return np.asarray(chi2.sf(qs / lam[0], df=1))
    lsum = float(lam.sum())
    n_pre = int(np.searchsorted(qs, lsum, side="right"))
    out[:n_pre] = _davies_shared_h(qs[:n_pre], lam)
    # suffix bands: [lsum*2^k, lsum*2^(k+1)) point index ranges
    n_suf = len(qs) - n_pre
    dav_suf = np.empty(n_suf)
    band_hi = []  # end index (suffix-relative) of each band
    b0 = n_pre
    while b0 < len(qs):
        edge = lsum * (2.0 ** (len(band_hi) + 1))
        b1 = int(np.searchsorted(qs, edge, side="right"))
        b1 = max(b1, b0 + 1)
        band_hi.append(b1 - n_pre)
        b0 = b1
    band_done = [0]  # bands evaluated so far

    def _dav(i):
        j = i - n_pre
        while j >= (band_hi[band_done[0] - 1] if band_done[0] else 0):
            lo = band_hi[band_done[0] - 1] if band_done[0] else 0
            hi = band_hi[band_done[0]]
            qband = qs[n_pre + lo:n_pre + hi]
            dav_suf[lo:hi] = _davies_shared_h(
                qband, lam, qeff=max(float(qband[-1]), lsum, 1e-30))
            band_done[0] += 1
        return float(dav_suf[j])

    tail = False
    kuo, koff = None, 0
    for i in range(len(qs)):
        pv = out[i] if i < n_pre else None
        point_fallback = False
        if not tail:
            if pv is None:
                pv = _dav(i)
            if 0 < pv <= 1e-5:
                tail = True  # true deep tail: SF monotone from here on
                kuo = kuonen_pv_batch(qs[i:], lam)
                koff = i
            elif pv <= 0:
                point_fallback = True  # Davies failure, not a tail signal
        if tail or point_fallback:
            q = float(qs[i])
            pv = kuo[i - koff] if tail else kuonen_pv(q, lam)
            if pv <= 0:
                pv = davies_pv(q, lam, strict=True)
                if pv <= 0:
                    logp, _ = liu_logp(q, lam)
                    pv = 10 ** (-logp) if logp >= 0 else -1.0
        out[i] = pv if np.isfinite(pv) else -1.0
    return out


def _K(t, lam):
    return -0.5 * np.log1p(-2.0 * t * lam).sum()


def _Kp(t, lam):
    return (lam / (1.0 - 2.0 * t * lam)).sum()


def _Kpp(t, lam):
    return ((2.0 * lam**2) / (1.0 - 2.0 * t * lam) ** 2).sum()


def kuonen_pv(q: float, lambdas: np.ndarray) -> float:
    """Saddlepoint p-value (get_kuonen_pv, SKAT.cpp:1566). Lambdas must
    be scaled so max == 1. Returns -1 on failure."""
    lam = np.asarray(lambdas, dtype=np.float64)
    # root bounds (get_tmin_lambda / get_tmax_lambda)
    if lam[0] < 0:
        tmin = 1.0 / (2.0 * lam[0])
    elif q > lam.sum():
        tmin = 0.0
    else:
        tmin = -0.5 * len(lam) / q
    tmax = 0.5 - 1e-8
    if tmax < tmin:
        return -1.0

    fmin = _Kp(tmin, lam) - q
    fmax = _Kp(tmax, lam) - q
    if not (fmin <= 0 and fmax >= 0):
        return -1.0

    # Newton + bisection (solve_kp, SKAT.cpp:1604)
    min_x, max_x = tmin, tmax
    t_old, f_old = tmin, fmin
    t_new = tmin
    ok = False
    for _ in range(1000):
        hess = _Kpp(t_old, lam)
        t_new = t_old - f_old / hess
        f_new = _Kp(t_new, lam) - q
        if abs(f_new) < 1e-8:
            ok = True
            break
        if min_x < t_new < max_x:
            if f_new > 0:
                max_x = t_new
            else:
                min_x = t_new
        else:
            t_new = 0.5 * (min_x + max_x)
            f_new = _Kp(t_new, lam) - q
            if f_new <= 0:
                min_x = t_new
            else:
                max_x = t_new
        t_old, f_old = t_new, f_new
    if not ok:
        return -1.0

    # tail approximation (get_spa_pv, SKAT.cpp:1667)
    tmp = 2.0 * (q * t_new - _K(t_new, lam))
    if tmp <= 0:
        return -1.0
    w = np.sign(t_new) * np.sqrt(tmp)
    tmp = _Kpp(t_new, lam)
    if tmp <= 0:
        return -1.0
    u = t_new * np.sqrt(tmp)
    if abs(u) < 1e-4:
        return -1.0
    r = w + np.log(u / w) / w
    pv = norm.sf(r)
    if pv <= 0 or pv > 1:
        return -1.0
    return float(pv)


def kuonen_pv_batch(qs: np.ndarray, lambdas: np.ndarray) -> np.ndarray:
    """Vectorized kuonen_pv over a batch of statistics sharing ONE
    lambda mixture (the --mt NPMANOVA/HOmnibus case). Elementwise math
    and the Newton+bisection control flow match the scalar routine, so
    per-element results are bitwise identical. Returns pv [B], -1 on
    failure."""
    lam = np.asarray(lambdas, dtype=np.float64)
    qs = np.asarray(qs, dtype=np.float64)
    B = qs.shape[0]
    lam2 = lam[None, :]

    def Kp(t):
        return (lam2 / (1.0 - 2.0 * t[:, None] * lam2)).sum(axis=1)

    def Kpp(t):
        return ((2.0 * lam2**2) / (1.0 - 2.0 * t[:, None] * lam2) ** 2).sum(axis=1)

    if lam[0] < 0:
        tmin = np.full(B, 1.0 / (2.0 * lam[0]))
    else:
        tmin = np.where(qs > lam.sum(), 0.0, -0.5 * len(lam) / qs)
    tmax = 0.5 - 1e-8
    out = np.full(B, -1.0)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        fmin = Kp(tmin) - qs
        fmax = Kp(np.full(B, tmax)) - qs
        alive = (tmax >= tmin) & (fmin <= 0) & (fmax >= 0)
        min_x, max_x = tmin.copy(), np.full(B, tmax)
        t_old, f_old = tmin.copy(), fmin.copy()
        t_new = tmin.copy()
        ok = np.zeros(B, bool)
        active = alive.copy()
        for _ in range(1000):
            if not active.any():
                break
            hess = Kpp(t_old)
            cand = t_old - f_old / hess
            f_cand = Kp(cand) - qs
            conv = active & (np.abs(f_cand) < 1e-8)
            ok |= conv
            t_new = np.where(active, cand, t_new)
            inb = (min_x < cand) & (cand < max_x)
            upd = active & ~conv
            max_x = np.where(upd & inb & (f_cand > 0), cand, max_x)
            min_x = np.where(upd & inb & (f_cand <= 0), cand, min_x)
            mid = 0.5 * (min_x + max_x)
            f_mid = Kp(mid) - qs
            oob = upd & ~inb
            t_new = np.where(oob, mid, t_new)
            f_new = np.where(oob, f_mid, f_cand)
            min_x = np.where(oob & (f_mid <= 0), mid, min_x)
            max_x = np.where(oob & (f_mid > 0), mid, max_x)
            t_old = np.where(upd, t_new, t_old)
            f_old = np.where(upd, f_new, f_old)
            active = upd
        good = ok
        Kt = -0.5 * np.log1p(-2.0 * t_new[:, None] * lam2).sum(axis=1)
        tmp = 2.0 * (qs * t_new - Kt)
        good = good & (tmp > 0)
        w = np.sign(t_new) * np.sqrt(np.where(tmp > 0, tmp, 1.0))
        kpp = Kpp(t_new)
        good = good & (kpp > 0)
        u = t_new * np.sqrt(np.where(kpp > 0, kpp, 1.0))
        good = good & (np.abs(u) >= 1e-4)
        r = w + np.log(np.where(good, u / w, 1.0)) / w
        pv = norm.sf(r)
        good = good & (pv > 0) & (pv <= 1)
        out[good] = pv[good]
    return out


def liu_params(lambdas: np.ndarray) -> np.ndarray:
    """[muQ, invsQ, muX, sX, df, ncp] (get_cvals, SKAT.cpp:1767)."""
    lam = np.asarray(lambdas, dtype=np.float64)
    c1, c2 = lam.sum(), (lam**2).sum()
    c3, c4 = (lam**3).sum(), (lam**4).sum()
    s1 = c3 / c2 / np.sqrt(c2)
    s2 = c4 / c2**2
    if s1**2 <= s2:
        df = 1.0 / s2
        a = np.sqrt(df)
        ncp = 0.0
    else:
        a = 1.0 / (s1 - np.sqrt(s1**2 - s2))
        ncp = (s1 * a - 1.0) * a * a
        df = a * a - 2.0 * ncp
    return np.array([c1, 1.0 / np.sqrt(2 * c2), df + ncp, np.sqrt(2) * a, df, ncp])


def liu_logp(q: float, lambdas: np.ndarray) -> Tuple[float, float]:
    """Modified-Liu -log10 p (get_liu_pv variant, SKAT.cpp:1625).
    Returns (logp, chival); logp=-1 on failure."""
    c = liu_params(lambdas)
    tstar = (q - c[0]) * c[1]
    val = tstar * c[3] + c[2]
    if val < 0 or not np.isfinite(c[4]) or c[4] <= 0:
        return -1.0, -1.0
    if c[5] == 0:
        with np.errstate(divide="ignore"):
            logpv = -chi2.logsf(val, df=c[4]) / np.log(10.0)
    else:
        pv = ncx2.sf(val, df=c[4], nc=c[5])
        logpv = -1.0 if (pv <= 0 or pv > 1) else -np.log10(pv)
    return float(logpv), float(val)


def chisq_mix_pv(q: float, lambdas: np.ndarray, presorted: bool = False) -> float:
    """Raw p-value chain (get_chisq_mix_pv, SKAT.cpp:1468).
    Used inside the SKATO integrand. Returns -1 on failure.
    presorted: lambdas already ascending with max normalized to 1
    (the SKATO SF grid re-evaluates the same spectrum 80x)."""
    if presorted:
        newQ, newL = q, np.asarray(lambdas, dtype=np.float64)
    else:
        lam = np.sort(np.asarray(lambdas, dtype=np.float64))
        newQ = q / lam[-1]
        newL = lam / lam[-1]
    pv = davies_pv(newQ, newL)
    if pv <= 1e-5:
        pv = kuonen_pv(newQ, newL)
        if pv <= 0:
            pv = davies_pv(newQ, newL, strict=True)
            if pv <= 0:
                logp, _ = liu_logp(newQ, newL)
                pv = 10 ** (-logp) if logp >= 0 else -1.0
    if not np.isfinite(pv):
        return -1.0
    return pv


def chisq_mix_logp(q: float, lambdas: np.ndarray) -> Tuple[float, float]:
    """-log10 p for the mixture + equivalent 1-df chisq (get_chisq_mix_logp,
    SKAT.cpp:1500). Returns (logp, chival); logp=-1 on failure."""
    from .stats import neglog10_to_chisq

    lam = np.sort(np.asarray(lambdas, dtype=np.float64))
    newQ = q / lam[-1]
    newL = lam / lam[-1]
    pv = davies_pv(newQ, newL)
    logp = None
    if pv <= 1e-5:
        pv = kuonen_pv(newQ, newL)
        if pv <= 0:
            pv = davies_pv(newQ, newL, strict=True)
            if pv <= 0:
                logp, chival = liu_logp(newQ, newL)
                if logp < 0:
                    return -1.0, -1.0
                chival = float(neglog10_to_chisq(np.array([logp]))[0])
                return logp, chival
    if pv <= 0 or pv > 1:
        return -1.0, -1.0
    pv = max(pv, _DBL_DMIN)
    logp = -np.log10(pv)
    chival = float(neglog10_to_chisq(np.array([logp]))[0])
    return float(logp), chival


def chisq_mix_logp_batch(qs: np.ndarray,
                         lambdas: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """chisq_mix_logp for a batch of statistics sharing ONE spectrum
    (the per-rho SKATO sweep across phenotypes, compute_vc_masks_qt
    SKAT.cpp:560: P q-values against the same rho-kernel eigenvalues).
    Per element bitwise-identical to the scalar chain: davies_pv_batch
    == davies_pv, kuonen_pv_batch == kuonen_pv, and the strict-davies /
    liu fallbacks run the scalar routines on the (rare) failing
    elements.  Returns (logp [B], chival [B]); -1 on failure."""
    from .stats import neglog10_to_chisq

    qs = np.asarray(qs, dtype=np.float64)
    lam = np.sort(np.asarray(lambdas, dtype=np.float64))
    newQ = qs / lam[-1]
    newL = lam / lam[-1]
    pv = davies_pv_batch(newQ, newL)
    logp = np.full(len(qs), -1.0)
    chival = np.full(len(qs), -1.0)
    need_kuo = pv <= 1e-5
    if need_kuo.any():
        kuo = kuonen_pv_batch(newQ[need_kuo], newL)
        kidx = np.flatnonzero(need_kuo)
        pv[kidx] = kuo
        for j, i in enumerate(kidx):
            if kuo[j] <= 0:
                p_str = davies_pv(float(newQ[i]), newL, strict=True)
                if p_str > 0:
                    pv[i] = p_str
                else:
                    lp, _cv = liu_logp(float(newQ[i]), newL)
                    if lp >= 0:
                        logp[i] = lp
                        chival[i] = float(
                            neglog10_to_chisq(np.array([lp]))[0])
                    pv[i] = -1.0  # handled via logp directly
    ok = (pv > 0) & (pv <= 1)
    if ok.any():
        pvo = np.maximum(pv[ok], _DBL_DMIN)
        lpo = -np.log10(pvo)
        logp[ok] = lpo
        chival[ok] = neglog10_to_chisq(lpo)
    return logp, chival
