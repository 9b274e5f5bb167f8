"""The port's single-process mesh (regenie_tpu_torch/parallel/mesh.py)
against the JAX package's (regenie_tpu/parallel/mesh.py) on the CPU: each
sharded_* function on 4 and on 8 CPU shards against the JAX function on
make_mesh(4) / make_mesh(8) of conftest's 8 virtual devices, the same
seeded numpy inputs in float64, within rel 1e-9, at sizes that do not
divide by the shard count (the JAX side gets its inputs zero-padded, the
port pads its own). Also: maybe_mesh's and run_mesh's rules, the
helpers (replicate shares one copy a device, Replicas copies once a
source, psum adds in shard order, shard / gather pad and cut), the dense
scorers against the single-device functions they wrap, and the five
fused block functions on a mesh against the same functions unsharded,
with a last block of 3 variants on 8 shards.

One test needs an NVIDIA GPU (marker `cuda`): fused_i8 and bgen_i8
launched once a shard on two shards of one card, their products put
back together exactly equal to the whole block's. On the GPU machine,
which has no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_mesh.py
"""

import numpy as np
import pytest
import torch

from regenie_tpu_torch.ops import fused_score as tfs
from regenie_tpu_torch.parallel import mesh as tm

N = 601  # samples: divides by neither 4 nor 8
B = 13  # variants: likewise
P, K, J = 3, 4, 5


@pytest.fixture(scope="module")
def jm():
    import jax  # noqa: F401 — conftest's 8 virtual devices

    from regenie_tpu.parallel import mesh as jm

    return jm


def _close(got, want, n=None):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    if n is not None:
        got, want = got[:n], want[:n]
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=1e-9,
                               atol=1e-9 * max(1.0, float(np.abs(want).max())))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float64))


def _cpu_mesh(n):
    return tm.make_mesh(["cpu"] * n)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    G = rng.normal(size=(B, N))
    Y = rng.normal(size=(N, P))
    maskf = (rng.random((N, P)) > 0.1).astype(np.float64)
    cov = np.linalg.qr(rng.normal(size=(N, K)))[0]
    return rng, G, Y * maskf, maskf, cov


def _pad(jm, x, m, axis):
    return jm.pad_to(np.asarray(x), m, axis)[0]


# ---------------------------------------------------------------------------
# the mesh and its helpers
# ---------------------------------------------------------------------------


def test_maybe_mesh_rules(monkeypatch):
    """None for one device; on the CPU a mesh only under REGENIE_TPU_MESH
    with the shards REGENIE_TPU_TORCH_MESH_DEVICES lists; a listed device
    of another type raises; one listed shard is no mesh."""
    cpu = torch.device("cpu")
    for var in (tm.MESH_ENV, tm.DEVICES_ENV):
        monkeypatch.delenv(var, raising=False)
    assert tm.maybe_mesh(cpu) is None
    monkeypatch.setenv(tm.MESH_ENV, "1")
    assert tm.maybe_mesh(cpu) is None
    monkeypatch.setenv(tm.DEVICES_ENV, "cpu, cpu,cpu")
    assert tm.maybe_mesh(cpu) == (cpu, cpu, cpu)
    monkeypatch.delenv(tm.MESH_ENV)
    assert tm.maybe_mesh(cpu) is None
    monkeypatch.setenv(tm.MESH_ENV, "1")
    monkeypatch.setenv(tm.DEVICES_ENV, "cpu")
    assert tm.maybe_mesh(cpu) is None
    monkeypatch.setenv(tm.DEVICES_ENV, "cpu,cuda:0")
    with pytest.raises(ValueError, match="cuda:0"):
        tm.maybe_mesh(cpu)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA"):
            tm.make_mesh(["cuda:0", "cuda:0"])


def test_helpers_pad_replicate_psum():
    """shard zero-pads to the shard count and gather cuts the pad; a
    replicated tensor is one object on a shared device; psum adds the
    partials left to right in shard order."""
    mesh = _cpu_mesh(4)
    x = torch.arange(30.0).view(10, 3)
    parts = tm.shard(mesh, x, 0)
    assert [p.shape[0] for p in parts] == [3, 3, 3, 3]
    assert torch.equal(parts[3][1:], torch.zeros(2, 3))
    assert torch.equal(tm.gather(parts, 0, 10), x)
    cols = tm.shard(mesh, x.numpy(), 1)
    assert [p.shape for p in cols] == [(10, 1)] * 4
    assert torch.equal(tm.gather(cols, 1)[:, :3], x)
    sh = tm.shard_rows(mesh, x)
    assert sh.n == 10 and len(sh.parts) == 4
    reps = tm.replicate(mesh, x)
    assert all(r is x for r in reps)
    op = tfs.I8Operand(torch.zeros(4, 8, dtype=torch.int8), torch.ones(2), None)
    r = tm.replicate(mesh, op)
    assert all(o is r[0] for o in r) and r[0].limbs is op.limbs
    big = torch.tensor([1e16], dtype=torch.float64)
    one = torch.tensor([1.0], dtype=torch.float64)
    assert tm.psum([big, one, -big, one]).item() == ((1e16 + 1.0) - 1e16) + 1.0
    assert tm.pad_to(np.ones((5, 2)), 4, 0)[0].shape == (8, 2)


@pytest.mark.parametrize("step,flags,takes", [
    (1, {}, True), (1, {"print_block_betas": True}, False),
    (1, {"test_l0": True}, False), (2, {}, True), (2, {"trait_mode": 3}, True),
    (2, {"strict_mode": True}, False), (2, {"trait_mode": 9}, False),
])
def test_run_mesh_rules(monkeypatch, step, flags, takes):
    """run_mesh, the one rule of cli.unported, open_step1 and Step2Engine:
    Step 1 takes the mesh unless --print or --test-l0; Step 2 on QT, BT,
    CT and T2E traits outside --strict."""
    from types import SimpleNamespace

    monkeypatch.setenv(tm.MESH_ENV, "1")
    monkeypatch.setenv(tm.DEVICES_ENV, "cpu,cpu")
    params = SimpleNamespace(step=step, print_block_betas=False, test_l0=False,
                             trait_mode=0, strict_mode=False)
    for k, v in flags.items():
        setattr(params, k, v)
    got = tm.run_mesh(params, torch.device("cpu"))
    assert got == ((torch.device("cpu"),) * 2 if takes else None)


def test_replicas_copy_once_a_source():
    """Replicas keeps one list of per-shard copies a key while the sources
    are the same objects, makes new ones when a source changes, and shards
    on one device share the source itself."""
    mesh = _cpu_mesh(3)
    reps = tm.Replicas(mesh)
    a, b = torch.ones(4), torch.zeros(2)
    first = reps("k", a, b)
    assert reps("k", a, b) is first
    assert all(x is a for x in first[0]) and all(x is b for x in first[1])
    c = torch.ones(4)
    again = reps("k", c, b)
    assert again is not first and all(x is c for x in again[0])
    assert reps("other", a)[0][0] is a


def test_dense_scorers_are_the_single_device_functions():
    """sharded_score_qt / bt / t2e on 8 CPU shards give the rows of the
    single-device functions they wrap (models/step2's
    residualize_scale_block + score_qt_block, step2_bt._allpass,
    step2_t2e.cox_products), pad rows cut."""
    from regenie_tpu_torch.models import step2 as m2
    from regenie_tpu_torch.models import step2_bt, step2_t2e

    rng, G, Y, maskf, cov = _inputs(9)
    mesh = _cpu_mesh(8)
    G_, Y_, m_, c_ = _t(G), _t(Y), _t(maskf), _t(cov)
    sden = float(N - K)
    Gr, sf, _ = m2.residualize_scale_block(G_, c_, sden)
    want = (*m2.score_qt_block(Gr, Y_, m_, sden, False), sf)
    for g, w in zip(tm.sharded_score_qt(mesh, G_, Y_, m_, c_, sden), want):
        _close(g, w.numpy())
    Pn, Kp1 = 2, K + 1
    W, x, g2 = (_t(a) for a in (rng.normal(size=(N, Pn * Kp1)),
                                rng.normal(size=(Pn, K)), rng.random((N, Pn))))
    for g, w in zip(tm.sharded_score_bt(mesh, G_, W, x, g2, Pn, Kp1),
                    step2_bt._allpass(G_, W, x, g2, Pn, Kp1)):
        _close(g, w.numpy())
    WX1, R, v = (_t(a) for a in (rng.normal(size=(N, K)), rng.normal(size=(N, K)) / N,
                                 rng.normal(size=N)))
    got = tm.sharded_score_t2e(mesh, G_, WX1, R.T, v[:, None])
    for g, w in zip(got, step2_t2e.cox_products(G_, WX1, R, v)[1:]):
        _close(g, w.numpy())


# ---------------------------------------------------------------------------
# the sharded functions against the JAX package's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nsh", [4, 8])
def test_sharded_gram_matches_jax(jm, nsh):
    _, G, Y, _, _ = _inputs(1)
    jmesh = jm.make_mesh(nsh)
    want = jm.sharded_gram(jmesh, _pad(jm, G, nsh, 1), _pad(jm, Y, nsh, 0))
    got = tm.sharded_gram(_cpu_mesh(nsh), _t(G), _t(Y))
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("nsh", [4, 8])
def test_sharded_score_qt_matches_jax(jm, nsh):
    _, G, Y, maskf, cov = _inputs(2)
    sden = float(N - K)
    want = jm.sharded_score_qt(jm.make_mesh(nsh), _pad(jm, G, nsh, 0), Y,
                               maskf, cov, sden)
    got = tm.sharded_score_qt(_cpu_mesh(nsh), _t(G), _t(Y), _t(maskf),
                              _t(cov), sden)
    for g, w in zip(got, want):
        _close(g, w, B)


@pytest.mark.parametrize("nsh", [4, 8])
def test_sharded_score_bt_matches_jax(jm, nsh):
    rng, G, _, _, _ = _inputs(3)
    Pn, Kp1 = 2, K + 1
    Wcat = rng.normal(size=(N, Pn * Kp1))
    xwt = rng.normal(size=(Pn, K))
    gsm2 = rng.random((N, Pn))
    want = jm.sharded_score_bt(jm.make_mesh(nsh), _pad(jm, G, nsh, 0), Wcat,
                               xwt, gsm2, Pn, Kp1)
    got = tm.sharded_score_bt(_cpu_mesh(nsh), _t(G), _t(Wcat), _t(xwt),
                              _t(gsm2), Pn, Kp1)
    for g, w in zip(got, want):
        _close(g, w, B)


@pytest.mark.parametrize("nsh", [4, 8])
def test_sharded_score_t2e_matches_jax(jm, nsh):
    rng, G, _, _, _ = _inputs(4)
    q = K + 1
    WX1 = rng.normal(size=(N, q))
    Xinv_t = rng.normal(size=(q, N)) / N
    rm = rng.normal(size=(N, 1))
    want = jm.sharded_score_t2e(jm.make_mesh(nsh), _pad(jm, G, nsh, 0), WX1,
                                Xinv_t, rm)
    got = tm.sharded_score_t2e(_cpu_mesh(nsh), _t(G), _t(WX1), _t(Xinv_t), _t(rm))
    for g, w in zip(got, want):
        _close(g, w, B)


def _level0_inputs(seed):
    rng, G, Y, maskf, _ = _inputs(seed)
    G = (G - G.mean(1, keepdims=True)) / G.std(1, keepdims=True)
    lambdas = N * B * np.array([0.1, 0.5, 1.0, 2.0, 10.0]) / B
    return rng, G, Y, maskf, lambdas, maskf.sum(0)


@pytest.mark.parametrize("nsh", [4, 8])
def test_sharded_level0_loocv_matches_jax(jm, nsh):
    _, G, Y, maskf, lam, neff = _level0_inputs(5)
    want = jm.sharded_level0_loocv(
        jm.make_mesh(nsh), _pad(jm, G, nsh, 1), _pad(jm, Y, nsh, 0),
        _pad(jm, maskf, nsh, 0), lam, neff)
    got = tm.sharded_level0_loocv(_cpu_mesh(nsh), _t(G), _t(Y), _t(maskf),
                                  _t(lam), _t(neff))
    assert got.shape[0] == -(-N // nsh) * nsh
    _close(got, want, N)


@pytest.mark.parametrize("nsh", [4, 8])
def test_sharded_level0_kfold_matches_jax(jm, nsh):
    from regenie_tpu_torch.models import step1 as m1

    _, G, Y, maskf, lam, neff = _level0_inputs(6)
    ind = np.ones(N, bool)
    sizes = m1.compute_fold_sizes(ind, 5)
    Y_f, valid = m1.pad_folds(Y, sizes)
    m_f, _ = m1.pad_folds(maskf, sizes)
    idx = m1.fold_index(sizes)
    G_f = np.transpose(G[:, idx], (1, 0, 2))  # [K, B, nmax]
    nmax = G_f.shape[2]
    want = jm.sharded_level0_kfold(
        jm.make_mesh(nsh), _pad(jm, G_f, nsh, 2), _pad(jm, Y_f, nsh, 1),
        _pad(jm, m_f, nsh, 1), _pad(jm, valid.astype(np.float64), nsh, 1),
        lam, neff)
    got = tm.sharded_level0_kfold(_cpu_mesh(nsh), _t(G_f), _t(Y_f), _t(m_f),
                                  _t(valid), _t(lam), _t(neff))
    _close(got[:, :nmax], np.asarray(want)[:, :nmax])
    # and the port's own unsharded level 0
    one = m1.level0_kfold_block(_t(G_f), _t(Y_f), _t(m_f), _t(valid), _t(lam),
                                _t(neff))
    _close(got[:, :nmax], one.numpy())


# ---------------------------------------------------------------------------
# the fused block functions on a mesh
# ---------------------------------------------------------------------------


def _block_case(seed, nrows):
    rng = np.random.default_rng(seed)
    nb = (N + 3) // 4
    raw = rng.integers(0, 256, size=(nrows, nb), dtype=np.uint8)
    k0 = rng.integers(0, 200, size=(nrows, N)).astype(np.uint8)
    k1 = np.minimum(rng.integers(0, 200, size=(nrows, N)),
                    255 - k0.astype(np.int64)).astype(np.uint8)
    Np = -(-N // 256) * 256
    planes = np.zeros((nrows, 2, Np), np.uint8)
    planes[:, 0, :N] = np.where(rng.random((nrows, N)) < 0.04, 255, k0)
    planes[:, 1, :N] = k1
    ind = rng.random(N) > 0.1
    maskf = (rng.random((N, P)) > 0.08).astype(np.float64)
    cov = np.linalg.qr(rng.normal(size=(N, K)) * ind[:, None])[0]
    res = rng.normal(size=(N, P)) * ind[:, None]
    return dict(raw=raw, nb=nb, planes=planes, ind=ind, maskf=maskf, cov=cov,
                res=res, sden=float(ind.sum() - K), rng=rng)


def _glm_operand(c, pack):
    """A BT-like operand [cat (Pn*Kp1) | gsm^2 (Pn) | maskf | case | ind]."""
    rng, ind = c["rng"], c["ind"].astype(np.float64)
    Pn, Kp1 = 2, K + 1
    Wext = np.concatenate([rng.normal(size=(N, Pn * Kp1)), rng.random((N, Pn)),
                           c["maskf"], (rng.random((N, P)) < 0.3) * 1.0,
                           ind[:, None]], axis=1) * ind[:, None]
    if pack == "plane":
        Wp, usum = tfs.plane_pack(Wext, c["nb"], False)
    else:
        Wp, usum = tfs.sample_pack(Wext, False)
    icol = Wext.shape[1] - 1
    return (Wp, usum, rng.normal(size=(Pn, K)), icol + 1, icol,
            float(ind.sum()), Pn * Kp1, Pn, Kp1)


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        _close(g.double(), w.double().numpy())


@pytest.mark.parametrize("nrows", [3, 48])
@pytest.mark.parametrize("kind", ["qt", "qt_bgen", "bt", "bt_bgen", "t2e"])
def test_block_fns_on_mesh_match_unsharded(kind, nrows):
    """Each make_*_fn with mesh= (8 CPU shards; the rows padded to the
    shard count, a shard a plain-products call) against the same function
    unsharded: the same outputs, pad rows cut."""
    c = _block_case(7, nrows)
    mesh = _cpu_mesh(8)
    if kind in ("qt", "qt_bgen"):
        pack = "sample" if kind == "qt_bgen" else "plane"
        consts = tfs.build_consts(c["cov"], c["res"], c["maskf"], c["ind"],
                                  c["sden"], nb=c["nb"], pack=pack)
        make = tfs.make_qt_bgen_fn if kind == "qt_bgen" else tfs.make_qt_block_fn
        fns = [make(consts, True, mesh=m) for m in (None, mesh)]
    elif kind in ("bt", "bt_bgen"):
        args = _glm_operand(c, "sample" if kind == "bt_bgen" else "plane")
        make = tfs.make_bt_bgen_fn if kind == "bt_bgen" else tfs.make_bt_block_fn
        fns = [make(*args, mesh=m) for m in (None, mesh)]
    else:
        Tt, q = 2, K + 1
        rng, ind = c["rng"], c["ind"].astype(np.float64)
        Wext = np.concatenate([rng.normal(size=(N, Tt * (2 * q + 1))),
                               (rng.random((N, P)) < 0.3) * 1.0, c["maskf"],
                               ind[:, None]], axis=1) * ind[:, None]
        Wp, usum = tfs.plane_pack(Wext, c["nb"], False)
        icol = Wext.shape[1] - 1
        args = (Wp, usum, rng.normal(size=(Tt, q)), rng.random((Tt, q, q)),
                rng.random(Tt), icol + 1, icol, float(ind.sum()), Tt, q)
        fns = [tfs.make_t2e_block_fn(*args, mesh=m) for m in (None, mesh)]
    if "bgen" in kind:
        x = torch.from_numpy(c["planes"])
    else:
        Wp = consts.Wp if kind == "qt" else args[0]
        x = torch.from_numpy(tfs.pad_raw(c["raw"], tfs.op_nbp(Wp)))
    want = fns[0](x)
    got = fns[1](x)
    assert got[0].shape[0] == nrows
    _same(got, want)
    # an upload's Sharded block gives the same rows
    _same(fns[1](tm.shard_rows(mesh, x)), want)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_per_shard_kernels_match_whole_block_on_cuda(cuda):
    """fused_i8 (make_qt_block_fn) and bgen_i8 (make_qt_bgen_fn) on a mesh
    of two shards of one card: each launches once a shard, the two
    shards share one operand, and the outputs equal the whole block's
    exactly."""
    from regenie_tpu_torch.ops import kernels

    c = _block_case(8, 37)
    mesh = tm.make_mesh([cuda, cuda])
    for pack, make, x, kern in (
            ("plane", tfs.make_qt_block_fn, c["raw"], kernels.fused_i8_products),
            ("sample", tfs.make_qt_bgen_fn, c["planes"], kernels.bgen_i8_products)):
        consts = tfs.build_consts(c["cov"], c["res"], c["maskf"], c["ind"],
                                  c["sden"], nb=c["nb"], device=cuda,
                                  split="i8", pack=pack)
        if pack == "plane":
            x = tfs.pad_raw(x, tfs.op_nbp(consts.Wp))
        x = torch.from_numpy(x).to(cuda)
        want = make(consts, True)(x)
        n0 = kern.launches
        got = make(consts, True, mesh=mesh)(x)
        torch.cuda.synchronize()
        assert kern.launches - n0 == 2
        for g, w in zip(got, want):
            assert torch.equal(g, w)
