"""The port's 2-D mesh (REGENIE_TPU_MESH_2D; regenie_tpu_torch/parallel/mesh.py
Mesh2D, ops/fused_score._mesh_cells) and level 1 over a mesh's shards
(models/step1.py, models/step1_bt.Design) against the JAX package on the
CPU: the grid's pure functions (mesh_2d_shape, arrange_devices_2d,
all_process_rects) on synthetic (process, index) layouts against the JAX
functions on fake devices; sharded_level0_blocks_2d, sharded_score_qt_2d
and the QT, BT and Cox 2-D block functions on 8 CPU shards (2 x 4)
against the JAX functions on make_mesh_2d(8) of conftest's 8 virtual
devices within rel 1e-9; the 2-D block functions against the port's own
unsharded ones, bit for bit on the int8 operand and within rel 1e-12 on
the float32 operand, on 8 and 4 shards; and the level-1 products over 4
and 8 shards against the JAX package's functions.

Two tests need an NVIDIA GPU (marker `cuda`): the 2-D block function on
a 2 x 2 grid of one card launching fused_i8 once a cell, and fused_f32
on its windows, against the whole block. On the GPU machine, which has
no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_mesh2d.py
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from regenie_tpu_torch.ops import fused_score as tfs
from regenie_tpu_torch.parallel import mesh as tm

N = 601  # samples: divides by no shard count
P, K, J = 3, 4, 5


@pytest.fixture(scope="module")
def jax_mods():
    import jax  # noqa: F401 — conftest's 8 virtual devices

    from regenie_tpu.ops import fused_score as jfs
    from regenie_tpu.parallel import mesh as jm

    return jm, jfs


def _grid(n):
    return tm.Mesh2D(tm.make_mesh(["cpu"] * n))


def _close(got, want, rtol=1e-9):
    got = got.double().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(1.0, float(np.abs(want).max())))


# ---------------------------------------------------------------------------
# the grid
# ---------------------------------------------------------------------------


def test_mesh_2d_shape_matches_jax(jax_mods):
    jm, _ = jax_mods
    for n in range(1, 17):
        assert tm.mesh_2d_shape(n) == jm.mesh_2d_shape(n), n


class _FakeDev:
    def __init__(self, process, index, local):
        self.process_index = process
        self.slice_index = None
        self.id = process * local + index


LAYOUTS = [(1, 8), (2, 4), (4, 2), (8, 1), (2, 2), (2, 1), (3, 2), (4, 4), (2, 3),
           (3, 1), (6, 1), (4, 1)]


@pytest.mark.parametrize("nproc,local", LAYOUTS)
def test_grid_and_rects_match_jax(jax_mods, nproc, local):
    """arrange_devices_2d and all_process_rects on nproc processes of
    `local` shards, handed over in scrambled order, against the JAX
    functions on fake devices of the same processes: the same cells, the
    same rectangles, None for a ragged layout (3 processes x 2 shards)."""
    jm, _ = jax_mods
    n = nproc * local
    nv, ns = tm.mesh_2d_shape(n)
    order = np.random.default_rng(n).permutation(n)
    shards = [tm.Shard(int(i) // local, int(i) % local) for i in order]
    devs = [_FakeDev(int(i) // local, int(i) % local, local) for i in order]
    grid = tm.arrange_devices_2d(shards, nv, ns)
    jgrid = jm.arrange_devices_2d(devs, nv, ns)
    assert [[(s.process, s.process * local + s.index) for s in row] for row in grid] \
        == [[(d.process_index, d.id) for d in row] for row in jgrid]
    rects = tm.all_process_rects(grid, nproc)
    jrects = jm.all_process_rects(SimpleNamespace(devices=jgrid), nproc)
    assert rects == jrects
    if (nproc, local) == (3, 2):
        assert rects is None


def test_mesh2d_cells_and_helpers():
    """A single-process grid holds every cell in row-major order;
    cell_parts pads and splits both axes; psum_rows adds a row's cells in
    column order; gather_rows and gather_cells put the pieces back."""
    m2 = _grid(8)
    assert (m2.nv, m2.ns) == (2, 4)
    assert [(r, c) for r, c, _ in m2.cells] == [(r, c) for r in range(2) for c in range(4)]
    assert m2.rects == [((0, 2), (0, 4))]
    x = torch.arange(5 * 10, dtype=torch.float64).view(5, 10)
    parts = tm.cell_parts(m2, x, 0, 1)
    assert [tuple(p.shape) for p in parts] == [(3, 3)] * 8
    cells = tm.gather_cells(m2, parts)
    back = cells.permute(0, 2, 1, 3).reshape(6, 12)
    assert torch.equal(back[:5, :10], x) and not back[5:].any() and not back[:, 10:].any()
    big = torch.tensor([1e16], dtype=torch.float64)
    one = torch.tensor([1.0], dtype=torch.float64)
    sums = tm.psum_rows(m2, [big, one, -big, one] * 2)
    assert sums[0].item() == sums[1].item() == ((1e16 + 1.0) - 1e16) + 1.0
    rows = tm.gather_rows(m2, {0: (x[:3],), 1: (x[3:],)}, 4)
    assert torch.equal(rows[0], x[:4])


# ---------------------------------------------------------------------------
# sharded functions against the JAX package
# ---------------------------------------------------------------------------


def _inputs(seed, B=13):
    rng = np.random.default_rng(seed)
    G = rng.normal(size=(B, N))
    maskf = (rng.random((N, P)) > 0.1).astype(np.float64)
    Y = rng.normal(size=(N, P)) * maskf
    cov = np.linalg.qr(rng.normal(size=(N, K)))[0]
    return rng, G, Y, maskf, cov


def test_sharded_level0_blocks_2d_matches_jax(jax_mods):
    """Three blocks (the last two zero-padded to 11 rows, as the Step-1
    caller pads a group) on 8 CPU shards against the JAX function on
    make_mesh_2d(8); the zero-padded fourth block of the grid's second row
    is computed and never read; and against the same blocks on 4 shards."""
    jm, _ = jax_mods
    import jax.numpy as jnp

    rng, _, Y, maskf, _ = _inputs(1)
    G3 = rng.normal(size=(3, 11, N))
    G3[1, 9:] = 0.0
    G3[2, 7:] = 0.0
    lam = np.array([5.0, 20.0, 80.0, 300.0, 900.0])
    neff = maskf.sum(axis=0)
    mesh = jm.make_mesh_2d(8)
    pad = lambda a, ax: jm.pad_to(a, 4, ax)[0]  # noqa: E731
    G4 = np.concatenate([pad(G3, 2), np.zeros((1, 11, pad(G3, 2).shape[2]))])
    want = np.asarray(jm.sharded_level0_blocks_2d(
        mesh, jm.shard_array_2d(mesh, jnp.asarray(G4), (jm.VAR_AXIS, None, jm.SMP_AXIS)),
        jm.shard_array_2d(mesh, jnp.asarray(pad(Y, 0)), (jm.SMP_AXIS, None)),
        jm.shard_array_2d(mesh, jnp.asarray(pad(maskf, 0)), (jm.SMP_AXIS, None)),
        jnp.asarray(lam), jnp.asarray(neff)))[:3, :N]
    for n in (8, 4):
        got = tm.sharded_level0_blocks_2d(_grid(n), torch.from_numpy(G3), Y, maskf,
                                          torch.from_numpy(lam), torch.from_numpy(neff))
        assert got.shape[0] == 3
        _close(got[:, :N], want)


def test_sharded_score_qt_2d_matches_jax(jax_mods):
    jm, _ = jax_mods
    import jax.numpy as jnp

    _, G, Y, maskf, cov = _inputs(2)
    mesh = jm.make_mesh_2d(8)
    pad = lambda a, ax, m: jm.pad_to(a, m, ax)[0]  # noqa: E731
    Gp = pad(pad(G, 0, 2), 1, 4)
    want = jm.sharded_score_qt_2d(
        mesh, jm.shard_array_2d(mesh, jnp.asarray(Gp), (jm.VAR_AXIS, jm.SMP_AXIS)),
        *(jm.shard_array_2d(mesh, jnp.asarray(pad(a, 0, 4)), (jm.SMP_AXIS, None))
          for a in (Y, maskf, cov)), float(N - K))
    for n in (8, 4):
        got = tm.sharded_score_qt_2d(_grid(n), G, Y, maskf, cov, float(N - K))
        for g, w in zip(got, want):
            _close(g, np.asarray(w)[: G.shape[0]])


# ---------------------------------------------------------------------------
# the 2-D block functions
# ---------------------------------------------------------------------------


def _block_case(seed, nrows):
    rng = np.random.default_rng(seed)
    nb = (N + 3) // 4
    ind = rng.random(N) > 0.1
    maskf = (rng.random((N, P)) > 0.08).astype(np.float64)
    return dict(raw=rng.integers(0, 256, size=(nrows, nb), dtype=np.uint8), nb=nb,
                ind=ind, maskf=maskf, rng=rng,
                cov=np.linalg.qr(rng.normal(size=(N, K)) * ind[:, None])[0],
                res=rng.normal(size=(N, P)) * ind[:, None], sden=float(ind.sum() - K))


def _glm_wext(c):
    rng, ind = c["rng"], c["ind"].astype(np.float64)
    Pn, Kp1 = 2, K + 1
    Wext = np.concatenate([rng.normal(size=(N, Pn * Kp1)), rng.random((N, Pn)),
                           c["maskf"], (rng.random((N, P)) < 0.3) * 1.0,
                           ind[:, None]], axis=1) * ind[:, None]
    icol = Wext.shape[1] - 1
    return Wext, (rng.normal(size=(Pn, K)), icol + 1, icol, float(ind.sum()),
                  Pn * Kp1, Pn, Kp1)


def _t2e_wext(c):
    rng, ind = c["rng"], c["ind"].astype(np.float64)
    Tt, q = 2, K + 1
    Wext = np.concatenate([rng.normal(size=(N, Tt * (2 * q + 1))),
                           (rng.random((N, P)) < 0.3) * 1.0, c["maskf"],
                           ind[:, None]], axis=1) * ind[:, None]
    icol = Wext.shape[1] - 1
    return Wext, (rng.normal(size=(Tt, q)), rng.random((Tt, q, q)), rng.random(Tt),
                  icol + 1, icol, float(ind.sum()), Tt, q)


def _port_fns(kind, c, split, op_dtype, ns, mesh):
    """(the block function, the operand's nbp) of the port."""
    tile = tfs._TC * ns
    if kind == "qt":
        consts = tfs.build_consts(c["cov"], c["res"], c["maskf"], c["ind"], c["sden"],
                                  nb=c["nb"], split=split, op_dtype=op_dtype,
                                  nbp_tile=tile)
        return tfs.make_qt_block_fn(consts, True, mesh=mesh), tfs.op_nbp(consts.Wp)
    Wext, rest = (_glm_wext if kind == "bt" else _t2e_wext)(c)
    Wp, usum = tfs.plane_pack(Wext, c["nb"], split, dtype=op_dtype, nbp_tile=tile)
    make = tfs.make_bt_block_fn if kind == "bt" else tfs.make_t2e_block_fn
    return make(Wp, usum, *rest, mesh=mesh), tfs.op_nbp(Wp)


@pytest.mark.parametrize("nrows", [3, 37])
@pytest.mark.parametrize("kind", ["qt", "bt", "t2e"])
def test_block_fns_2d_match_unsharded(kind, nrows):
    """Each block function on the 2-D grid (8 shards: 2 x 4; 4 shards: 2 x
    2; rows off the row count, 3 rows fewer than the 8 cells) against the
    same function unsharded: bit for bit on the int8 operand (the int32
    window sums are exact), within rel 1e-12 on the float32 operand, and
    within rel 1e-9 on the CPU's float64 operand; pad rows cut."""
    for n in (8, 4):
        m2 = _grid(n)
        for split, dt in (("i8", torch.float64), (False, torch.float32),
                          (False, torch.float64)):
            c = _block_case(11, nrows)
            one, nbp = _port_fns(kind, c, split, dt, m2.ns, None)
            c = _block_case(11, nrows)
            two, _ = _port_fns(kind, c, split, dt, m2.ns, m2)
            x = torch.from_numpy(tfs.pad_raw(c["raw"], nbp))
            want, got = one(x), two(x)
            assert got[0].shape[0] == nrows
            for g, w in zip(got, want):
                assert g.shape == w.shape and g.dtype == w.dtype
                if split == "i8":
                    assert torch.equal(g, w)
                elif g.dtype != torch.bool:
                    _close(g, w.numpy(), 1e-12 if dt == torch.float32 else 1e-9)
                else:
                    assert torch.equal(g, w)
            # the upload's cells give the same rows
            tiles = tfs.block_cells(m2, torch.from_numpy(c["raw"]), nbp)
            for g, w in zip(two(tm.Sharded(tiles, nrows)), got):
                assert torch.equal(g, w)


def _jax_fn(jm, jfs, kind, c, mesh):
    tile = tfs._TC * mesh.devices.shape[1]
    if kind == "qt":
        consts = jfs.build_consts(c["cov"], c["res"], c["maskf"], c["ind"], c["sden"],
                                  nb=c["nb"], dtype=np.float64, nbp_tile=tile)
        return jfs.make_qt_block_fn(consts, False, mesh=mesh), jfs.op_nbp(consts.Wp)
    Wext, rest = (_glm_wext if kind == "bt" else _t2e_wext)(c)
    Wp, usum = jfs.plane_pack(Wext, c["nb"], False, np.float64, nbp_tile=tile)
    make = jfs.make_bt_block_fn if kind == "bt" else jfs.make_t2e_block_fn
    args = (Wp, usum, *rest[:1]) if kind == "bt" else (Wp, usum, *rest[:3])
    tail = rest[1:] if kind == "bt" else rest[3:]
    return make(*args, *tail, False, mesh=mesh), jfs.op_nbp(Wp)


@pytest.mark.parametrize("kind", ["qt", "bt", "t2e"])
def test_block_fns_2d_match_jax(jax_mods, kind):
    """The port's 2-D block functions on 8 CPU shards against the JAX
    package's on make_mesh_2d(8) (the psum over "smp" between products
    and epilogue), the same numpy inputs, float64: within rel 1e-9."""
    jm, jfs = jax_mods
    import jax.numpy as jnp

    nrows = 10
    mesh = jm.make_mesh_2d(8)
    c = _block_case(13, nrows)
    jfn, nbp = _jax_fn(jm, jfs, kind, c, mesh)
    raw = jm.pad_to(tfs.pad_raw(c["raw"], nbp), 2, 0)[0]
    want = jfn(jm.shard_array_2d(mesh, jnp.asarray(raw), (jm.VAR_AXIS, jm.SMP_AXIS)))
    c = _block_case(13, nrows)
    fn, nbp_t = _port_fns(kind, c, False, torch.float64, 4, _grid(8))
    assert nbp_t == nbp
    got = fn(torch.from_numpy(tfs.pad_raw(c["raw"], nbp)))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)[:nrows]
        if g.dtype == torch.bool:
            assert np.array_equal(g.numpy(), w)
        else:
            _close(g, w)


# ---------------------------------------------------------------------------
# level 1 over the shards
# ---------------------------------------------------------------------------


def _level1_case(seed, F=12):
    rng = np.random.default_rng(seed)
    W = rng.normal(size=(N, F))
    Y = rng.normal(size=(N,))
    pgs = 0.1 * rng.normal(size=(N,))
    taus = np.array([1.0, 10.0, 100.0, 1000.0])
    mult = rng.uniform(0.5, 2.0, size=F)
    return W, Y, pgs, taus, mult


@pytest.mark.parametrize("shards", [4, 8])
@pytest.mark.parametrize("extra", ["none", "pgs", "mult"])
def test_level1_loocv_over_shards_matches_jax(jax_mods, shards, extra):
    """level1_linear_loocv and level1_linear_full_fit_loocv with `mesh`
    (the rows of W, Y and the PGS split over the shards) against the JAX
    package's functions, with --test-l0's PGS and --select-l0's
    multipliers: the CV sums, bvec and every sample's b0 within rel 1e-9."""
    import jax.numpy as jnp

    from regenie_tpu.models import step1 as jm1
    from regenie_tpu_torch.models import step1 as pm1

    W, Y, pgs, taus, mult = _level1_case(3)
    pg = pgs if extra == "pgs" else None
    ml = mult if extra == "mult" else None
    mesh = tm.make_mesh(["cpu"] * shards)
    t = torch.from_numpy
    got = pm1.level1_linear_loocv(t(W), t(Y), t(taus), 590.0,
                                  ridge_mult=None if ml is None else t(ml),
                                  pgs=None if pg is None else t(pg), mesh=mesh)
    want = jm1.level1_linear_loocv(jnp.asarray(W), jnp.asarray(Y), jnp.asarray(taus),
                                   590.0, pgs=None if pg is None else jnp.asarray(pg),
                                   ridge_mult=None if ml is None else jnp.asarray(ml))
    for g, w in zip(got if pg is not None else [got], want if pg is not None else [want]):
        _close(g, np.asarray(w))
    b0, bvec = pm1.level1_linear_full_fit_loocv(
        t(W), t(Y), 10.0, ridge_mult=None if ml is None else t(ml), mesh=mesh)
    assert isinstance(b0, list) and len(b0) == shards
    jb0, jbvec = jm1.level1_linear_full_fit_loocv(
        jnp.asarray(W), jnp.asarray(Y), 10.0,
        ridge_mult=None if ml is None else jnp.asarray(ml))
    _close(bvec, np.asarray(jbvec))
    _close(torch.cat(b0, dim=1)[:, :N], np.asarray(jb0))


@pytest.mark.parametrize("shards", [4, 8])
@pytest.mark.parametrize("pgs", [False, True])
def test_level1_kfold_over_shards_matches_jax(jax_mods, shards, pgs):
    """level1_linear_kfold with `mesh` (the fold slots split, pad slots
    valid 0) against the JAX package's function: beta and the CV sums
    within rel 1e-9."""
    import jax.numpy as jnp

    from regenie_tpu.models import step1 as jm1
    from regenie_tpu_torch.models import step1 as pm1

    W, Y, pg, taus, _ = _level1_case(4)
    sizes = np.array([121, 120, 120, 120, 120])
    Wf, valid = pm1.pad_folds(W, sizes)
    Yf = pm1.pad_folds(Y[:, None], sizes)[0][..., 0]
    Pf = pm1.pad_folds(pg[:, None], sizes)[0][..., 0] if pgs else None
    mesh = tm.make_mesh(["cpu"] * shards)
    t = torch.from_numpy
    got = pm1.level1_linear_kfold(t(Wf), t(Yf), t(valid.astype(np.float64)), t(taus),
                                  pgs_folds=None if Pf is None else t(Pf), mesh=mesh)
    want = jm1.level1_linear_kfold(jnp.asarray(Wf), jnp.asarray(Yf),
                                   jnp.asarray(valid.astype(np.float64)),
                                   jnp.asarray(taus),
                                   pgs_folds=None if Pf is None else jnp.asarray(Pf))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, np.asarray(w))


@pytest.mark.parametrize("mode", ["bt_loocv", "bt_kfold", "ct_loocv", "ct_kfold"])
def test_level1_nonqt_over_shards_matches_jax(jax_mods, mode, monkeypatch):
    """level1_nonqt with `mesh` (Design: the rows of the trait's design over
    8 CPU shards, the sums psummed in shard order, the row-wise results
    gathered) against the JAX package's level1_nonqt under REGENIE_TPU_MESH=1
    (place_rows_padded over its 8 virtual devices) and against the port's
    unsharded call: the same ridge parameter and the predictions within rel
    1e-9."""
    from test_torch_step1_bt import _synthetic

    from regenie_tpu import config as jconfig
    from regenie_tpu.models import step1_bt as jbt
    from regenie_tpu_torch import config
    from regenie_tpu_torch.models import step1 as pm1
    from regenie_tpu_torch.models import step1_bt

    poisson, kfold = mode.startswith("ct"), mode.endswith("kfold")
    n, F = (1203 if kfold else 601), 12
    W, off, pd = _synthetic(n, F, seed=21 if poisson else 22, poisson=poisson)
    kw = dict(trait_mode=jconfig.CT if poisson else jconfig.BT, cv_folds=4)
    jp, pp = jconfig.Params(**kw), config.Params(**kw)
    taus = F * (1 - config.ridge_h2_grid(5)) / config.ridge_h2_grid(5) * 3 / np.pi**2
    chr_order, spans = [1, 2], {1: (0, 8), 2: (8, 4)}
    sizes = pm1.compute_fold_sizes(np.ones(n, bool), 4) if kfold else None
    X = pm1.pad_folds(W, sizes)[0] if kfold else W
    logs = {k: [] for k in ("jax", "one", "mesh")}
    monkeypatch.setenv("REGENIE_TPU_PLATFORM", "cpu")
    monkeypatch.setenv("REGENIE_TPU_MESH", "1")
    want, okj = jbt.level1_nonqt(jp, pd, X[..., None], off, taus, 0, chr_order, spans,
                                 sizes, logs["jax"].append)
    monkeypatch.delenv("REGENIE_TPU_MESH")
    one, ok1 = step1_bt.level1_nonqt(pp, pd, torch.from_numpy(X), off, taus, 0,
                                     chr_order, spans, sizes, logs["one"].append)
    got, ok2 = step1_bt.level1_nonqt(pp, pd, torch.from_numpy(X), off, taus, 0,
                                     chr_order, spans, sizes, logs["mesh"].append,
                                     mesh=tm.make_mesh(["cpu"] * 8))
    assert okj and ok1 and ok2
    mins = {k: [ln for ln in v if "min value" in ln] for k, v in logs.items()}
    assert mins["mesh"] == mins["jax"] == mins["one"]
    _close(torch.from_numpy(got), want)
    _close(torch.from_numpy(got), one)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_2d_block_fn_launches_once_a_cell_on_cuda(cuda):
    """make_qt_block_fn on a 2 x 2 grid of four shards of one card:
    fused_i8 launches once a cell (4 a block) on [Cw4, 4 * nbp / 2]
    windows, and the outputs equal the unsharded function's bit for bit;
    with the float32 operand fused_f32 launches 4 times and the outputs
    agree within rel 1e-12."""
    from regenie_tpu_torch.ops import kernels

    m2 = tm.Mesh2D(tm.make_mesh([cuda] * 4))
    for split, dt, kern in (("i8", torch.float64, kernels.fused_i8_products),
                            (False, torch.float32, kernels.fused_f32_products)):
        c = _block_case(17, 37)
        consts = tfs.build_consts(c["cov"], c["res"], c["maskf"], c["ind"], c["sden"],
                                  nb=c["nb"], split=split, op_dtype=dt, device=cuda,
                                  nbp_tile=tfs._TC * 2)
        nbp = tfs.op_nbp(consts.Wp)
        x = torch.from_numpy(tfs.pad_raw(c["raw"], nbp)).to(cuda)
        want = tfs.make_qt_block_fn(consts, True)(x)
        fn = tfs.make_qt_block_fn(consts, True, mesh=m2)
        n0 = kern.launches
        got = fn(x)
        torch.cuda.synchronize()
        assert kern.launches == n0 + 4
        for g, w in zip(got, want):
            if split == "i8" or g.dtype == torch.bool:
                assert torch.equal(g, w)
            else:
                _close(g, w.cpu().numpy(), 1e-12)
