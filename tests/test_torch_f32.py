"""Tests of the port's float32-operand path (REGENIE_TPU_I8=0 on the card):
the f32 operand and constants, the fused_f32 and bgen_f32 products and the
QT block functions, each against the JAX package on the CPU at small
sizes (the same numpy inputs, made from a seed, go through both); the
JAX package's residual-patch fault on its f32 operand; and, with marker
`cuda`, the two hand-written kernels against their plain versions. On
the GPU machine, which has no JAX, run the card's tests with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_f32.py
"""

import numpy as np
import pytest
import torch

from regenie_tpu_torch.ops import fused_score as tfs
from regenie_tpu_torch.ops import kernels


@pytest.fixture(scope="module")
def jfs():
    """The JAX package's fused_score (tests that take it skip where JAX is
    not installed)."""
    pytest.importorskip("jax")
    from regenie_tpu.ops import fused_score

    return fused_score


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _mk_case(seed, B=24, N=1025, P=3, K=4, n_complete=1, excl_rate=0.1):
    """Random packed bytes (all four codes), probability planes (4%
    missing, k0 + k1 <= 255 elsewhere, padded to the sample-packed
    operand's length) and per-sample inputs, as
    tests/test_torch_fused_score.py and tests/test_torch_bgen.py build
    them."""
    rng = np.random.default_rng(seed)
    nb = (N + 3) // 4
    raw = rng.integers(0, 256, size=(B, nb), dtype=np.uint8)
    k0 = rng.integers(0, 200, size=(B, N)).astype(np.uint8)
    k1 = np.minimum(rng.integers(0, 200, size=(B, N)),
                    255 - k0.astype(np.int64)).astype(np.uint8)
    miss = rng.random(size=(B, N)) < 0.04
    Np = -(-N // 256) * 256
    planes = np.zeros((B, 2, Np), np.uint8)
    planes[:, 0, :N] = np.where(miss, 255, k0)
    planes[:, 1, :N] = np.where(miss, 255, k1)
    ind = rng.random(N) > excl_rate
    indf = ind.astype(np.float64)
    res = rng.normal(size=(N, P)) * indf[:, None]
    maskf = (rng.random(size=(N, P)) > 0.08).astype(np.float64)
    maskf[:, :n_complete] = 1.0
    cov = np.linalg.qr(rng.normal(size=(N, K)) * ind[:, None])[0]
    return dict(raw=raw, nb=nb, planes=planes, ind=ind, cov=cov, res=res,
                maskf=maskf * indf[:, None], sden=float(ind.sum() - K))


def _args(c):
    return c["cov"], c["res"], c["maskf"], c["ind"], c["sden"]


def _tail(c):
    """The narrow SQ operand's columns [maskf | ind] (ind-masked)."""
    indf = c["ind"].astype(np.float64)[:, None]
    return np.concatenate([c["maskf"] * indf, indf], axis=1)


# ---------------------------------------------------------------------------
# operand and constants
# ---------------------------------------------------------------------------


def test_plane_pack_f32_matches_jax(jfs):
    """plane_pack with the float32 operand: the same f32 values and the
    same usum (summed from the float64 Wext) as the JAX package's."""
    rng = np.random.default_rng(1)
    N, C = 1025, 77
    Wext = rng.normal(size=(N, C))
    nb = (N + 3) // 4
    Wp, usum = tfs.plane_pack(Wext, nb, False, dtype=torch.float32)
    jWp, jusum = jfs.plane_pack(Wext, nb, False, dtype=np.float32)
    assert Wp.dtype == torch.float32 and np.asarray(jWp).dtype == np.float32
    np.testing.assert_array_equal(_np(Wp), np.asarray(jWp))
    np.testing.assert_array_equal(usum, np.asarray(jusum))


def test_sample_pack_f32_matches_jax(jfs):
    """sample_pack with the float32 operand, full and narrow (the
    [maskf | ind] tail the engine builds as Wq): the same f32 values and
    usum as the JAX package's."""
    c = _mk_case(2)
    Wext = np.concatenate([c["cov"], c["res"], _tail(c)], axis=1)
    for X in (Wext, _tail(c)):
        Wp, usum = tfs.sample_pack(X, False, dtype=torch.float32)
        jWp, jusum = jfs.sample_pack(X, False, dtype=np.float32)
        assert Wp.dtype == torch.float32 and Wp.shape == (1280, 128)
        np.testing.assert_array_equal(_np(Wp), np.asarray(jWp))
        np.testing.assert_array_equal(usum, np.asarray(jusum))


@pytest.mark.parametrize("pack", ["plane", "sample"])
def test_build_consts_f32_matches_jax(jfs, pack):
    """build_consts with op_dtype=float32: the operand equals the JAX
    package's dtype=np.float32 operand; the constants stay float64 and
    round to the JAX package's float32 constants exactly. consts_from_numpy
    carries the JAX package's f32 Wp and f32 narrow Wq across unchanged."""
    c = _mk_case(3)
    kw = dict(nb=c["nb"]) if pack == "plane" else dict(pack="sample")
    pc = tfs.build_consts(*_args(c), op_dtype=torch.float32, **kw)
    jc = jfs.build_consts(*_args(c), dtype=np.float32, **kw)
    jWq, _ = jfs.sample_pack(_tail(c), False, dtype=np.float32)
    carried = tfs.consts_from_numpy(
        Wp=np.asarray(jc.Wp), usum=np.asarray(jc.usum),
        covt_res=np.asarray(jc.covt_res), Mmat=np.asarray(jc.Mmat),
        n_ind=jc.n_ind, K=jc.K, P=jc.P, scale_denom=jc.scale_denom,
        split=jc.split, inc=jc.inc, wq=np.asarray(jWq))
    assert carried.Wq.dtype == torch.float32
    np.testing.assert_array_equal(_np(carried.Wq), np.asarray(jWq))
    for got in (pc, carried):
        assert got.Wp.dtype == torch.float32
        assert got.inc == jc.inc and got.layout_C() == jc.layout_C()
        np.testing.assert_array_equal(_np(got.Wp), np.asarray(jc.Wp))
    for name in ("usum", "covt_res", "Mmat"):
        assert getattr(pc, name).dtype == torch.float64
        np.testing.assert_array_equal(_np(getattr(pc, name).float()),
                                      np.asarray(getattr(jc, name)))


@pytest.mark.parametrize("layout", ["plane", "sample"])
def test_patch_res_columns_f32_reference_fault(jfs, layout):
    """The JAX package's residual patch on its float32 operand, called as
    regenie_tpu/run_step2.py:1125-1128 calls it on a TPU (split=True),
    writes only the bf16 high part of each residual: the residual
    columns are off by more than 1e-3, and the writes of the other two
    parts fall outside the operand without an error. The port's patch
    writes the float32 residuals exactly and leaves the other columns."""
    import jax.numpy as jnp

    rng = np.random.default_rng(4)
    K, P, Cp = 2, 3, 128
    lead = (4, 8) if layout == "plane" else (32,)
    base = rng.normal(size=lead + (Cp,)).astype(np.float32)
    res = rng.normal(size=lead + (P,)).astype(np.float32)
    want = jfs.patch_res_columns(jnp.asarray(base), res, K, P, Cp, True)
    gap = np.abs(np.asarray(want)[..., K : K + P] - res).max()
    print(f"{layout}: max |JAX patch - residual| = {gap:.3e}")
    assert gap > 1e-3
    got = tfs.patch_res_columns(torch.from_numpy(base), torch.from_numpy(res),
                                K, P, Cp)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got[..., K : K + P].numpy(), res)
    np.testing.assert_array_equal(np.delete(got.numpy(), np.s_[K : K + P], -1),
                                  np.delete(base, np.s_[K : K + P], -1))


# ---------------------------------------------------------------------------
# products
# ---------------------------------------------------------------------------


def _jc32(jfs, c, pack="plane"):
    kw = dict(nb=c["nb"]) if pack == "plane" else dict(pack="sample")
    return jfs.build_consts(*_args(c), dtype=np.float32, **kw)


def test_fused_f32_products_plain_matches_xla(jfs):
    """fused_products on CPU tensors with the float32 operand takes the
    plain version of fused_f32 (no launch): float64 products of the f32
    values, against the JAX package's fused_products_xla on the same
    values widened to float64, rtol 1e-12."""
    import jax.numpy as jnp

    c = _mk_case(5)
    Wp32 = np.array(_jc32(jfs, c).Wp)
    rawp = jfs.pad_raw(c["raw"])
    n0 = kernels.fused_f32_products.launches
    got = tfs.fused_products(torch.from_numpy(rawp), torch.from_numpy(Wp32))
    assert kernels.fused_f32_products.launches == n0
    want = jfs.fused_products_xla(jnp.asarray(rawp),
                                  jnp.asarray(Wp32.astype(np.float64)))
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12,
                                   atol=1e-12)


def test_fused_f32_products_match_pallas_interpret(jfs):
    """The same products against the JAX package's Pallas _fused_kernel in
    interpret mode, which sums in float32: the tolerance of
    tests/test_fused_score.py:165."""
    import jax.numpy as jnp

    c = _mk_case(6, B=16)
    jc = _jc32(jfs, c)
    rawp = jfs.pad_raw(c["raw"])
    want = jfs.fused_products(jnp.asarray(rawp), jc.Wp, interpret=True)
    got = tfs.fused_products(torch.from_numpy(rawp),
                             torch.from_numpy(np.asarray(jc.Wp)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-4)


def test_bgen_f32_products_plain_matches_xla(jfs):
    """bgen_fused_products on CPU tensors with the float32 operand (full
    width) takes the plain version of bgen_f32 (no launch): against the
    JAX package's bgen_fused_products_xla on the same values widened to
    float64, rtol 1e-12."""
    import jax.numpy as jnp

    c = _mk_case(7)
    Wp32 = np.array(_jc32(jfs, c, "sample").Wp)
    n0 = kernels.bgen_f32_products.launches
    got = tfs.bgen_fused_products(torch.from_numpy(c["planes"]),
                                  torch.from_numpy(Wp32))
    assert kernels.bgen_f32_products.launches == n0
    want = jfs.bgen_fused_products_xla(jnp.asarray(c["planes"]),
                                       jnp.asarray(Wp32.astype(np.float64)))
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12,
                                   atol=1e-12)


@pytest.mark.parametrize("narrow", [False, True])
def test_bgen_f32_products_match_pallas_interpret(jfs, narrow):
    """The same against the JAX package's Pallas _bgen_kernel_split with
    its f32 operand in interpret mode (float32 sums), with and without the
    narrow Wq / qs: the tolerance of tests/test_fused_score.py:561."""
    import jax.numpy as jnp

    c = _mk_case(8, B=8, N=300)
    jc = _jc32(jfs, c, "sample")
    C_used = jc.layout_C()
    pj = jnp.asarray(c["planes"])
    planes = torch.from_numpy(c["planes"])
    Wp = torch.from_numpy(np.asarray(jc.Wp))
    if narrow:
        qs = C_used - (jc.P + 1)
        jWq, _ = jfs.sample_pack(_tail(c), False, dtype=np.float32)
        want = jfs.bgen_fused_products(pj, jc.Wp, jWq, qs=qs, C_used=C_used,
                                       interpret=True, tb=8)
        got = tfs.bgen_fused_products(planes, Wp, torch.from_numpy(np.asarray(jWq)),
                                      qs=qs, C_used=C_used)
        assert not got[1][:, :qs].any() and not got[1][:, C_used:].any()
    else:
        want = jfs.bgen_fused_products(pj, jc.Wp, interpret=True, tb=8)
        got = tfs.bgen_fused_products(planes, Wp)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g[:, :C_used].numpy(), np.asarray(w)[:, :C_used],
                                   rtol=2e-5, atol=2e-3)


def test_f32_wrappers_reject_mixed_devices():
    """A wrapper given tensors on two devices raises; it does not move them
    or fall back."""
    raw = torch.zeros((2, 16), dtype=torch.uint8)
    with pytest.raises(ValueError, match="same CUDA device"):
        kernels.fused_f32_products(raw, torch.zeros((4, 16, 4), device="meta"))
    planes = torch.zeros((2, 2, 16), dtype=torch.uint8)
    w = torch.zeros((16, 4))
    with pytest.raises(ValueError, match="same CUDA device"):
        kernels.bgen_f32_products(planes, w, w.to("meta"))


# ---------------------------------------------------------------------------
# the QT block functions
# ---------------------------------------------------------------------------


def _port_consts_f32(jfs, c, pack, wq=False):
    """(port consts on the JAX package's float32 operand with float64
    constants, the JAX package's float64 consts on the same f32 values)."""
    import jax.numpy as jnp

    jc64 = jfs.build_consts(*_args(c), dtype=np.float64,
                            **(dict(nb=c["nb"]) if pack == "plane"
                               else dict(pack="sample")))
    Wp32 = np.asarray(_jc32(jfs, c, pack).Wp)
    pc = tfs.consts_from_numpy(
        Wp=Wp32, usum=np.asarray(jc64.usum), covt_res=np.asarray(jc64.covt_res),
        Mmat=np.asarray(jc64.Mmat), n_ind=jc64.n_ind, K=jc64.K, P=jc64.P,
        scale_denom=jc64.scale_denom, inc=jc64.inc,
        wq=np.asarray(jfs.sample_pack(_tail(c), False, dtype=np.float32)[0])
        if wq else None)
    return pc, jc64._replace(Wp=jnp.asarray(Wp32.astype(np.float64)))


@pytest.mark.parametrize("test_type,ref_first,strict", [
    (0, False, False), (1, True, False), (2, False, True)])
def test_make_qt_block_fn_f32_matches_jax(jfs, test_type, ref_first, strict):
    """The QT block function on the float32 operand with float64
    constants (products through fused_f32's plain version, epilogue in
    float64) against the JAX package's use_pallas=False function on the
    same f32 values in float64: rtol 1e-9, atol 1e-9."""
    import jax.numpy as jnp

    c = _mk_case(9, n_complete=3 if strict else 1)
    pc, jc = _port_consts_f32(jfs, c, "plane")
    rawp = jfs.pad_raw(c["raw"])
    want = jfs.make_qt_block_fn(jc, False, test_type, ref_first, strict=strict)(
        jnp.asarray(rawp))
    got = tfs.make_qt_block_fn(pc, True, test_type, ref_first,
                               strict=strict)(torch.from_numpy(rawp))
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("ref_first,strict", [(False, False), (True, False),
                                              (False, True)])
def test_make_qt_bgen_fn_f32_matches_jax(jfs, ref_first, strict):
    """The QT BGEN block function on the float32 operand with its narrow
    f32 Wq and float64 constants, against the JAX package's
    use_pallas=False function (full width) on the same f32 values in
    float64: rtol 1e-9, atol 1e-9; the squared-dosage slice is compared on
    the narrow operand's columns, the only ones it has."""
    import jax.numpy as jnp

    c = _mk_case(10, n_complete=3 if strict else 1)
    pc, jc = _port_consts_f32(jfs, c, "sample", wq=True)
    want = jfs.make_qt_bgen_fn(jc, False, ref_first, strict=strict)(
        jnp.asarray(c["planes"]))
    got = tfs.make_qt_bgen_fn(pc, True, ref_first, strict=strict)(
        torch.from_numpy(c["planes"]))
    assert len(got) == len(want) == 8
    qs = pc.layout_C() - (pc.P + 1)
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.numpy(), np.asarray(w)
        if i == 5:  # SQ
            g, w = g[:, qs:], w[:, qs:]
        np.testing.assert_allclose(g, w, rtol=1e-9, atol=1e-9)


# ---------------------------------------------------------------------------
# the kernels on the card
# ---------------------------------------------------------------------------


def _assert_within_bar(got, want, bar):
    """|kernel - plain| <= 1e-12 x the same product against |W|."""
    for g, w, b in zip(got, want, bar):
        assert torch.all((g - w).abs() <= 1e-12 * b)


@pytest.mark.cuda
def test_fused_f32_kernel_matches_plain_on_cuda(cuda):
    """fused_f32 against its plain version on the card, on ragged shapes
    (rows off the 128-row tile, bytes off the 32-byte stage and columns
    off the 48-column tile; Cp 128, 384 and 400; B = 1; contractions of
    one stage and of less than one) within 1e-12 of the product against
    |wp|; each call counts one launch."""
    rng = np.random.default_rng(11)
    for B, nbp, Cp in ((37, 272, 400), (130, 512, 384), (5, 16, 128),
                       (129, 48, 52), (1, 32, 44), (1, 16, 4),
                       (257, 96, 100)):
        raw = torch.from_numpy(rng.integers(0, 256, (B, nbp), dtype=np.uint8)).to(cuda)
        wp = torch.from_numpy(rng.normal(size=(4, nbp, Cp)).astype(np.float32)).to(cuda)
        n0 = kernels.fused_f32_products.launches
        got = kernels.fused_f32_products(raw, wp)
        assert kernels.fused_f32_products.launches == n0 + 1
        want = kernels.fused_f32_products_plain(raw, wp)
        bar = kernels.fused_f32_products_plain(raw, wp.abs())
        torch.cuda.synchronize()
        assert all(g.dtype == torch.float64 for g in got)
        _assert_within_bar(got, want, bar)


@pytest.mark.cuda
def test_fused_f32_byte_windows_on_cuda(cuda):
    """The 2-D mesh's launches of fused_f32: a [4, nbp, Cp] float32 operand
    padded to ns * _TC bytes, cut on axis 1 into ns contiguous [4, nbp /
    ns, Cp] windows (fused_score.operand_window); the kernel on each
    window of the block, one launch a window, summed, within 1e-12 of the
    whole block's products against |wp| (float64 sums in another order)."""
    rng = np.random.default_rng(23)
    for B, ns, N, C in ((37, 2, 1201, 130), (130, 4, 3001, 40)):
        nb = (N + 3) // 4
        wp, _ = tfs.plane_pack(rng.normal(size=(N, C)), nb, False, device=cuda,
                               dtype=torch.float32, nbp_tile=ns * tfs._TC)
        nbp = wp.shape[1]
        w = nbp // ns
        raw = torch.from_numpy(tfs.pad_raw(
            rng.integers(0, 256, (B, nb), dtype=np.uint8), nbp)).to(cuda)
        want = kernels.fused_f32_products(raw, wp)
        bar = kernels.fused_f32_products_plain(raw, wp.abs())
        n0 = kernels.fused_f32_products.launches
        parts = []
        for c in range(ns):
            win = tfs.operand_window(wp, c, ns)
            assert win.shape == (4, w, wp.shape[2]) and win.is_contiguous()
            parts.append(kernels.fused_f32_products(raw[:, c * w:(c + 1) * w].contiguous(),
                                                    win))
        assert kernels.fused_f32_products.launches == n0 + ns
        torch.cuda.synchronize()
        got = [sum(p[i] for p in parts[1:]) + parts[0][i] for i in range(3)]
        _assert_within_bar(got, want, bar)


@pytest.mark.cuda
def test_bgen_f32_kernel_matches_plain_on_cuda(cuda):
    """bgen_f32 against its plain version on the card, on ragged shapes
    (rows off the 64-row tile, samples off the 128-sample stage, columns
    off the 64-column tile; Cw 384 and 400, Cq 128 and 144; B = 1;
    contractions of one stage, of less than one and of just more than
    one; about half the byte pairs missing) within 1e-12 of the products
    against |wp| and |wq|; each call counts one launch."""
    rng = np.random.default_rng(12)
    for B, Np, Cw, Cq in ((37, 272, 400, 144), (130, 768, 384, 128),
                          (65, 80, 68, 20), (1, 128, 4, 132), (1, 16, 8, 4),
                          (66, 144, 36, 64)):
        planes = torch.from_numpy(rng.integers(0, 256, (B, 2, Np), dtype=np.uint8)).to(cuda)
        wp = torch.from_numpy(rng.normal(size=(Np, Cw)).astype(np.float32)).to(cuda)
        wq = torch.from_numpy(rng.normal(size=(Np, Cq)).astype(np.float32)).to(cuda)
        n0 = kernels.bgen_f32_products.launches
        got = kernels.bgen_f32_products(planes, wp, wq)
        assert kernels.bgen_f32_products.launches == n0 + 1
        want = kernels.bgen_f32_products_plain(planes, wp, wq)
        bar = kernels.bgen_f32_products_plain(planes, wp.abs(), wq.abs())
        torch.cuda.synchronize()
        _assert_within_bar(got, want, bar)


@pytest.mark.cuda
def test_f32_kernels_launch_info_on_cuda(cuda):
    """The launch of the float32-operand kernels at the main path's full
    width (B = 2048, Cp = 384; BGEN Cw = 384, Cq = 128) and of the bf16
    kernels at the split path's (Cw = 3 x 384, Cq = 3 x 128) as the CUDA
    runtime reports it: fused_f32 in 16 x 8 blocks of 128 x 48, bgen_f32
    in 32 x 8 blocks of 64 x 64, fused_bf16 in 16 x 18 and bgen_bf16 in
    16 x 24 blocks of 128 x 64 (two warpgroups), 256 threads and one block
    per SM each, and the registers of a thread within the 255 that one
    block per SM allows."""
    for name, shape, blocks in (("fused_f32", (2048, 384), 128),
                                ("bgen_f32", (2048, 384, 128), 256),
                                ("fused_bf16", (2048, 3 * 384), 288),
                                ("bgen_bf16", (2048, 3 * 384, 3 * 128), 384)):
        info = kernels.launch_info(name, *shape, device=cuda)
        assert info["blocks"] == blocks
        assert info["threads"] == 256 and info["blocks_per_sm"] == 1
        assert 0 < info["registers"] <= 255

