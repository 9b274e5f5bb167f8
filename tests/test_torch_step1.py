"""Module parity tests of the port's Step 1 (regenie_tpu_torch.models.step1,
ops.geno_ops, io.geno's block readers and the LOCO row renderer) against
the JAX package on the CPU, at small sizes: the same numpy inputs, made
from a seed, go through both, in float64 (JAX with x64). Arrays agree
within 1e-9; the decode, the imputation and the fold layout exactly.
The CLI runs are in tests/test_torch_step1_cli.py.
"""

import numpy as np
import pytest
import torch

from chip_smoke import write_dataset
from regenie_tpu_torch.models import step1 as tm1
from regenie_tpu_torch.ops import geno_ops as tgo

TOL = 1e-9


@pytest.fixture(scope="module")
def jm1():
    pytest.importorskip("jax")
    from regenie_tpu.models import step1

    return step1


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float64))


def _close(got, want, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.max(np.abs(got - want), initial=0.0))
    assert err <= tol * max(1.0, float(np.max(np.abs(want), initial=0.0))), err


# ---------------------------------------------------------------------------
# decode and block prep
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_samples", [1, 4, 17, 402])
def test_decode_bed_packed_matches_jax(n_samples):
    """Every byte value, and a sample count that leaves a partial last
    byte: the port's decode equals the JAX package's exactly."""
    import jax.numpy as jnp

    from regenie_tpu.ops.geno_ops import decode_bed_packed

    nb = (n_samples + 3) // 4
    rng = np.random.default_rng(n_samples)
    raw = rng.integers(0, 256, (300, nb), dtype=np.uint8)
    raw[:256, 0] = np.arange(256)
    got = tgo.decode_bed_packed(torch.from_numpy(raw), n_samples)
    want = np.asarray(decode_bed_packed(jnp.asarray(raw), n_samples))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [0, 1])
def test_prepare_block_step1_matches_jax(seed):
    """Masking and mean imputation (missing codes, samples out of the
    analysis) equal the JAX package's exactly."""
    import jax.numpy as jnp

    from regenie_tpu.ops.geno_ops import prepare_block_step1

    rng = np.random.default_rng(seed)
    G = rng.choice(np.array([0, 1, 2, -3], np.int8), size=(23, 301),
                   p=[0.4, 0.35, 0.15, 0.1])
    ind = rng.random(301) < 0.9
    got = tgo.prepare_block_step1(torch.from_numpy(G), torch.from_numpy(ind))
    want = np.asarray(prepare_block_step1(jnp.asarray(G), jnp.asarray(ind)))
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("ref_first", [False, True])
@pytest.mark.parametrize("subset", [False, True])
def test_read_block_matches_jax(tmp_path, ref_first, subset):
    """GenoData.read_block and read_block_device (the CPU's host decode)
    equal the JAX package's read_block on a block with a variant skipped
    inside its file span (--exclude) and, with `subset`, samples removed,
    under --ref-first or not."""
    from regenie_tpu.config import Params as JParams
    from regenie_tpu.io.geno import open_geno as jopen

    from regenie_tpu_torch.config import Params
    from regenie_tpu_torch.io.geno import open_geno

    d = str(tmp_path)
    prefix = write_dataset(d, seed=3, N=37, chroms=((1, 12),), P=1, n_inc=0,
                           n_cov=1, n_remove=5 if subset else 0)
    with open(f"{d}/ex.txt", "w") as fh:
        fh.write("v4\nv5\n")
    out = []
    for P_, opener in ((Params, open_geno), (JParams, jopen)):
        p = P_()
        p.bed_prefix, p.ref_first = prefix, ref_first
        p.exclude_files = [f"{d}/ex.txt"]
        if subset:
            p.remove_files = [f"{d}/remove.txt"]
        gd = opener(p)
        out.append((gd, gd.snps[2:9]))
    (gd, bsnps), (jgd, jbsnps) = out
    assert [s.offset for s in bsnps] == [2, 3, 6, 7, 8, 9, 10]
    want = np.asarray(jgd.read_block(jbsnps))
    np.testing.assert_array_equal(gd.read_block(bsnps), want)
    got = gd.read_block_device(bsnps, "cpu", gd.read_block_bytes(bsnps))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.shape == (7, 37 - (5 if subset else 0))


# ---------------------------------------------------------------------------
# fold layout and residualization
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["equal", "unequal", "missing"])
def test_fold_layout_matches_jax(jm1, case):
    """compute_fold_sizes and pad_folds equal the JAX package's exactly,
    and fold_index gathers the same padded layout (pad slots from
    sample 0)."""
    rng = np.random.default_rng(7)
    N = {"equal": 50, "unequal": 47, "missing": 61}[case]
    ind = np.ones(N, bool) if case != "missing" else rng.random(N) < 0.8
    sizes = tm1.compute_fold_sizes(ind, 5)
    np.testing.assert_array_equal(sizes, jm1.compute_fold_sizes(ind, 5))
    assert sizes.sum() == N
    if case == "unequal":
        assert len(set(sizes)) > 1
    Y = rng.normal(size=(N, 3))
    got, valid = tm1.pad_folds(Y, sizes)
    want, jvalid = jm1.pad_folds(Y, sizes)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(valid, jvalid)
    idx = tm1.fold_index(sizes)
    np.testing.assert_array_equal(np.where(valid[..., None], Y[idx], 0.0), want)
    assert (idx[~valid] == 0).all()


def test_residualize_geno_block_matches_jax(jm1):
    import jax.numpy as jnp

    rng = np.random.default_rng(8)
    G = rng.normal(size=(13, 90))
    cov, _ = np.linalg.qr(rng.normal(size=(90, 4)))
    got = tm1.residualize_geno_block(_t(G), _t(cov), 86.0)
    want = jm1.residualize_geno_block(jnp.asarray(G), jnp.asarray(cov), 86.0)
    for g, w in zip(got, want):
        _close(g, w)


# ---------------------------------------------------------------------------
# level 0
# ---------------------------------------------------------------------------


def _level0_inputs(seed, B, N, P, J):
    rng = np.random.default_rng(seed)
    G = rng.normal(size=(B, N))
    Y = rng.normal(size=(N, P))
    mask = np.ones((N, P))
    mask[rng.random(N) < 0.1, 0] = 0.0  # one incomplete trait
    Y *= mask
    lambdas = np.geomspace(0.5, 40.0, J)
    return G, Y, mask, lambdas, mask.sum(axis=0)


@pytest.mark.parametrize("sizes", [[10, 10, 10, 10, 10], [9, 9, 9, 9, 11],
                                   [7, 12, 8]])
def test_level0_kfold_block_matches_jax(jm1, sizes):
    """Equal and unequal folds, fed as the run feeds them: the port's
    device gather (fold_index, pad slots from sample 0) against the JAX
    package's zero-padded folds."""
    import jax.numpy as jnp

    sizes = np.array(sizes)
    G, Y, mask, lambdas, Neff = _level0_inputs(len(sizes), 8, int(sizes.sum()), 3, 4)
    Gf, valid = jm1.pad_folds(G, sizes, axis=1)
    Yf, _ = jm1.pad_folds(Y, sizes)
    mf, _ = jm1.pad_folds(mask, sizes)
    want = jm1.level0_kfold_block(*(jnp.asarray(a) for a in (
        Gf, Yf, mf, valid.astype(float), lambdas, Neff)))
    idx = torch.from_numpy(tm1.fold_index(sizes).reshape(-1))
    Gt = _t(G).index_select(1, idx).view(G.shape[0], len(sizes), -1).transpose(0, 1)
    got = tm1.level0_kfold_block(Gt, _t(Yf), _t(mf), _t(valid), _t(lambdas), _t(Neff))
    assert got.shape == (len(sizes), sizes.max(), 4, 3)
    _close(got, want)


@pytest.mark.parametrize("n_blocks", [1, 3])
def test_level0_loocv_matches_jax(jm1, n_blocks):
    """One block (level0_loocv_block) and a group of blocks
    (level0_loocv_blocks, one batched eigh) against the JAX functions;
    each slice of the group equals the block alone."""
    import jax.numpy as jnp

    blocks = [_level0_inputs(20 + i, 6, 40, 2, 3) for i in range(n_blocks)]
    _, Y, mask, lambdas, Neff = blocks[0]
    G3 = np.stack([b[0] for b in blocks])
    jY, jm, jl, jn = (jnp.asarray(a) for a in (Y, mask, lambdas, Neff))
    if n_blocks == 1:
        got = tm1.level0_loocv_block(_t(G3[0]), _t(Y), _t(mask), _t(lambdas), _t(Neff))
        want = jm1.level0_loocv_block(jnp.asarray(G3[0]), jY, jm, jl, jn)
    else:
        got = tm1.level0_loocv_blocks(_t(G3), _t(Y), _t(mask), _t(lambdas), _t(Neff))
        want = jm1.level0_loocv_blocks(jnp.asarray(G3), jY, jm, jl, jn)
        for i in range(n_blocks):
            _close(got[i], tm1.level0_loocv_block(_t(G3[i]), _t(Y), _t(mask),
                                                  _t(lambdas), _t(Neff)))
    _close(got, want)


# ---------------------------------------------------------------------------
# level 1
# ---------------------------------------------------------------------------


def _level1_inputs(seed, N, F, mult):
    rng = np.random.default_rng(seed)
    W = rng.normal(size=(N, F))
    Y = rng.normal(size=N)
    taus = np.array([1.0, 10.0, 100.0])
    ridge_mult = None
    if mult:
        ridge_mult = np.ones(F)
        ridge_mult[[2, 5]] = 0.0  # --select-l0's unpenalized columns
    return W, Y, taus, ridge_mult


@pytest.mark.parametrize("mult", [False, True])
@pytest.mark.parametrize("sizes", [[12] * 5, [11, 13, 12, 12, 9]])
def test_level1_linear_kfold_matches_jax(jm1, mult, sizes):
    import jax.numpy as jnp

    sizes = np.array(sizes)
    W, Y, taus, rm = _level1_inputs(30, int(sizes.sum()), 10, mult)
    Wf, valid = jm1.pad_folds(W, sizes)
    Yf, _ = jm1.pad_folds(Y, sizes)
    want = jm1.level1_linear_kfold(
        jnp.asarray(Wf), jnp.asarray(Yf), jnp.asarray(valid.astype(float)),
        jnp.asarray(taus), ridge_mult=None if rm is None else jnp.asarray(rm))
    got = tm1.level1_linear_kfold(_t(Wf), _t(Yf), _t(valid), _t(taus),
                                  ridge_mult=None if rm is None else _t(rm))
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("mult", [False, True])
def test_level1_linear_loocv_matches_jax(jm1, mult):
    import jax.numpy as jnp

    W, Y, taus, rm = _level1_inputs(31, 30, 6, mult)
    want = jm1.level1_linear_loocv(
        jnp.asarray(W), jnp.asarray(Y), jnp.asarray(taus), 27.0,
        ridge_mult=None if rm is None else jnp.asarray(rm))
    got = tm1.level1_linear_loocv(_t(W), _t(Y), _t(taus), 27.0,
                                  ridge_mult=None if rm is None else _t(rm))
    _close(got, want)


@pytest.mark.parametrize("mult", [False, True])
def test_level1_full_fit_loocv_matches_jax(jm1, mult):
    import jax.numpy as jnp

    W, Y, _, rm = _level1_inputs(32, 25, 6, mult)
    want = jm1.level1_linear_full_fit_loocv(
        jnp.asarray(W), jnp.asarray(Y), 3.0,
        ridge_mult=None if rm is None else jnp.asarray(rm))
    b0, bvec = tm1.level1_linear_full_fit_loocv(_t(W), _t(Y), 3.0,
                                                ridge_mult=None if rm is None else _t(rm))
    assert len(b0) == 1  # one part: the mesh of W's own device
    for g, w in zip((b0[0], bvec), want):
        _close(g, w)


def test_tau_selection_matches_jax(jm1):
    rng = np.random.default_rng(33)
    cs = np.abs(rng.normal(size=(5, 4))) + 1.0
    assert tm1.select_best_tau_qt(cs, 40.0) == jm1.select_best_tau_qt(cs, 40.0)
    np.testing.assert_array_equal(tm1.cv_rsq(cs, 40.0), jm1.cv_rsq(cs, 40.0))


def test_ridge_grid_matches_jax():
    from regenie_tpu.config import ridge_h2_grid as jgrid

    from regenie_tpu_torch.config import ridge_h2_grid

    for n in (2, 5, 7):
        np.testing.assert_array_equal(ridge_h2_grid(n), jgrid(n))
    with pytest.raises(ValueError):
        ridge_h2_grid(1)


# ---------------------------------------------------------------------------
# LOCO rows
# ---------------------------------------------------------------------------


def _loco_values(seed, R, N):
    rng = np.random.default_rng(seed)
    V = rng.normal(size=(R, N)) * 10.0 ** rng.integers(-12, 12, size=(R, N))
    V[0, :8] = [0.0, -0.0, 1e-5, -2.5e-7, 123456.5, 1234567.0, 1e300, -1e-300]
    V[-1, -3:] = [np.nan, np.inf, -np.inf]
    mask = rng.random(N) < 0.85
    mask[:3] = True
    return V, mask, np.arange(1, R + 1) * (1 + (seed % 3))


@pytest.mark.parametrize("shape", [(1, 1), (3, 50), (23, 611), (40, 7)])
def test_loco_rows_native_matches_python(shape):
    """io/csrc/loco_rows.cpp (rows split over threads) is byte-identical
    to the plain Python renderer, and to the root native library's
    format_loco_rows where that library loads, on values with exponents,
    negatives, zeros, NaN/inf and masked samples."""
    from regenie_tpu_torch.io import native
    from regenie_tpu_torch.io.output import (format_value_rows,
                                             format_value_rows_plain)

    R, N = shape
    V, mask, labels = _loco_values(R * N, R, max(N, 8))
    got = format_value_rows(V, mask, labels)
    assert got == format_value_rows_plain(V, mask, labels)
    assert got.count(b"\n") == R and got.endswith(b" \n")
    lib = native.get_lib()
    if lib is not None and hasattr(lib, "format_loco_rows"):
        from regenie_tpu.io.output import format_value_rows as root_rows

        assert got.decode("ascii") == root_rows(V, mask, labels)


def test_loco_rows_reject_bad_shapes():
    from regenie_tpu_torch.io.output import format_value_rows

    V, mask, labels = _loco_values(1, 2, 9)
    with pytest.raises(ValueError):
        format_value_rows(V, mask[:-1], labels)
    with pytest.raises(ValueError):
        format_value_rows(V, mask, labels[:1])
    assert format_value_rows(V[:0], mask, labels[:0]) == b""


def test_loco_renderer_build_failure_raises(monkeypatch, tmp_path):
    """A renderer that cannot be built raises RuntimeError: there is no
    Python fallback on the CLI's path."""
    from regenie_tpu_torch.io import native
    from regenie_tpu_torch.io.output import format_value_rows

    monkeypatch.setitem(native._state, "loco", None)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    V, mask, labels = _loco_values(2, 2, 9)
    with pytest.raises(RuntimeError, match="LOCO row renderer"):
        format_value_rows(V, mask, labels)
