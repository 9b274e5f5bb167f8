"""The port's Firth and SPA corrections (regenie_tpu_torch.models) against
the JAX package's, on the CPU:

- the torch device solvers (models/corrections_device.py) against the
  JAX package's corrections_device in float64 (x64): the same
  converged / failed flags, values within rtol 1e-9 (JAX's own bars for
  its device twins against the host are rtol 1e-6 for Firth and 1e-5 for
  SPA);
- the port's host twins (models/firth.py, models/spa.py) and null fits
  (models/glm.py) against the JAX package's: equal;
- the torch solvers against the port's own host twins, at the JAX
  package's device-against-host bars.

The problems are the JAX package's own test shapes (tests/
test_corrections_device.py): rows across the allele-frequency spectrum,
carriers of some rare variants spiked into the cases, so that both
solvers converge on some rows and fail on others.
"""

import numpy as np
import pytest
import torch

from regenie_tpu_torch.models import corrections_device as tcdev
from regenie_tpu_torch.models import firth as tfirth
from regenie_tpu_torch.models import glm as tglm
from regenie_tpu_torch.models import spa as tspa


@pytest.fixture(autouse=True)
def _x64(monkeypatch):
    monkeypatch.setenv("REGENIE_TPU_PLATFORM", "cpu")
    from regenie_tpu.utils.dtypes import enable_x64_if_cpu

    enable_x64_if_cpu()


def _firth_problem(seed=0, N=3000, S=15, prev=0.12):
    rng = np.random.default_rng(seed)
    X = np.column_stack([np.ones(N), rng.normal(size=(N, 3))])
    eta = X @ np.array([np.log(prev / (1 - prev)), 0.3, -0.2, 0.1])
    y = (rng.random(N) < tglm.get_pvec(eta)).astype(np.float64)
    mask = rng.random(N) > 0.03
    mafs = np.concatenate([np.full(S // 3, 0.001), np.full(S // 3, 0.01),
                           np.full(S - 2 * (S // 3), 0.2)])
    G = rng.binomial(2, mafs[:, None], size=(S, N)).astype(np.float64)
    for s in range(0, S, 3):
        carriers = np.flatnonzero(G[s] > 0)
        y[carriers[: len(carriers) // 2]] = 1.0
    G[S - 1] = 0.0  # a monomorphic row: inactive from the start
    Xq, _ = np.linalg.qr(X * mask[:, None])
    Gm = G * mask[None, :]
    Gres = Gm - (Gm @ Xq) @ Xq.T
    return y, Gres, np.where(mask, eta, 0.0), mask, X


def _spa_problem(seed=3, N=5000, S=14, prev=0.05):
    rng = np.random.default_rng(seed)
    X = np.column_stack([np.ones(N), rng.normal(size=(N, 2))])
    eta = X @ np.array([np.log(prev / (1 - prev)), 0.2, -0.1])
    y = (rng.random(N) < tglm.get_pvec(eta)).astype(np.float64)
    mask = rng.random(N) > 0.02
    phat = tglm.get_pvec(eta)
    gamma_sqrt = np.sqrt(np.where(mask, phat * (1 - phat), 1.0))
    mafs = np.concatenate([np.full(S // 2, 0.002), np.full(S - S // 2, 0.05)])
    G = rng.binomial(2, mafs[:, None], size=(S, N)).astype(np.float64)
    for s in range(0, S, 2):
        carriers = np.flatnonzero(G[s] > 0)
        y[carriers[: max(2, len(carriers) // 3)]] = 1.0
    # a single-carrier row whose observed score lies outside the CGF's
    # range: SPA fails on it
    G[1] = 0.0
    G[1, np.flatnonzero(mask)[0]] = 2.0
    GW = G * (gamma_sqrt * mask)[None, :]
    Xq, _ = np.linalg.qr(X * (gamma_sqrt * mask)[:, None])
    Gres = GW - (GW @ Xq) @ Xq.T
    res = np.where(mask, (y - phat) / gamma_sqrt, 0.0)
    denum = (Gres**2).sum(axis=1)
    stats = (Gres @ res) / np.sqrt(denum)
    stats[1] = 60.0
    return stats, denum, Gres, phat, gamma_sqrt, mask


@pytest.mark.parametrize("seed", [0, 1])
def test_firth_device_matches_jax_device(seed):
    from regenie_tpu.models import corrections_device as jcdev
    from regenie_tpu.models import firth as jfirth

    y, Gres, offset, mask, _ = _firth_problem(seed)
    kw = dict(maxstep=5, niter=250, tol=2.5e-4)
    tb, tse, tl, tc = tcdev.firth_snp_batch_dev(y, torch.from_numpy(Gres),
                                               offset, mask, **kw)
    jb, jse, jl, jc = jcdev.firth_snp_batch_dev(y, Gres, offset, mask, **kw)
    hb, hse, hl, hc = jfirth.firth_snp_batch(y, Gres, offset, mask, **kw)
    assert tc.any() and not tc.all()
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(tc, hc)
    for t, j, h in ((tb, jb, hb), (tse, jse, hse), (tl, jl, hl)):
        np.testing.assert_allclose(t[tc], j[tc], rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(t[tc], h[tc], rtol=1e-6, atol=1e-8)


def test_spa_device_matches_jax_device():
    from regenie_tpu.models import corrections_device as jcdev
    from regenie_tpu.models import spa as jspa

    args = _spa_problem()
    tch, tlp, tf = tcdev.spa_batch_dev(*args[:2], torch.from_numpy(args[2]), *args[3:])
    jch, jlp, jf = jcdev.spa_batch_dev(*args)
    hch, hlp, hf = jspa.spa_batch(*args)
    assert tf.any() and not tf.all()
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_array_equal(tf, hf)
    ok = ~tf
    np.testing.assert_allclose(tlp[ok], jlp[ok], rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(tch[ok], jch[ok], rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(tlp[ok], hlp[ok], rtol=1e-5, atol=1e-7)


def test_host_twins_match_jax():
    """The port's numpy twins are the JAX package's: equal outputs."""
    from regenie_tpu.models import firth as jfirth
    from regenie_tpu.models import glm as jglm
    from regenie_tpu.models import spa as jspa

    y, Gres, offset, mask, X = _firth_problem(2)
    kw = dict(maxstep=5, niter=250, tol=2.5e-4)
    for a, b in zip(tfirth.firth_snp_batch(y, Gres, offset, mask, **kw),
                    jfirth.firth_snp_batch(y, Gres, offset, mask, **kw)):
        np.testing.assert_array_equal(a, b)
    args = _spa_problem(4)
    for a, b in zip(tspa.spa_batch(*args), jspa.spa_batch(*args)):
        np.testing.assert_array_equal(a, b)
    for check_hs in (True, False):
        a = tglm.fit_logistic_irls(y, X, offset * 0.1, mask, 30, 1e-6, check_hs)
        b = jglm.fit_logistic_irls(y, X, offset * 0.1, mask, 30, 1e-6, check_hs)
        np.testing.assert_array_equal(a[0], b[0])
        assert a[1] == b[1]
    a = tfirth.fit_firth_null(y, X, offset * 0.1, mask, None, tol=5e-5)
    b = jfirth.fit_firth_null(y, X, offset * 0.1, mask, None, tol=5e-5)
    np.testing.assert_allclose(a[0], b[0], rtol=1e-9, atol=1e-12)
    assert a[1] == b[1]


def test_spa_k2_overflow_edge():
    """_K2 at an argument past exp's range: inf/inf becomes 0, the
    reference's overflow branch, in the host twin (and the torch solver
    flags such a row as the host does)."""
    Gmod = np.array([[1e200, 0.0, 1.0]])
    phat = np.array([0.5, 0.5, 0.5])
    v = tspa._K2(np.array([-700.0]), Gmod, phat, np.ones(3), np.ones(3),
                 np.array([1.0]))
    assert np.isfinite(v).all() and v[0] == 0.0
