"""Module parity tests of the port's fused scorer
(regenie_tpu_torch.ops.fused_score and ops.kernels) against the JAX
package's regenie_tpu.ops.fused_score, on the CPU at small sizes: the same
numpy inputs, made from a seed, go through both.

One test needs an NVIDIA GPU (marker `cuda`): it holds the hand-written
kernel against its plain version and skips where there is no card. On
the GPU machine, which has no JAX, run it with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_fused_score.py
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


def _mk_case(seed, B=37, N=1025, P=3, K=4, n_complete=0, excl_rate=0.1):
    """Random packed bytes (all four codes) and per-sample inputs, as
    tests/test_fused_score.py:_mk_case builds them."""
    rng = np.random.default_rng(seed)
    nb = (N + 3) // 4
    raw = rng.integers(0, 256, size=(B, nb), dtype=np.uint8)
    ind = rng.random(N) > excl_rate
    flip = rng.random(B) < 0.5
    res = rng.normal(size=(N, P))
    maskf = (rng.random(size=(N, P)) > 0.08).astype(np.float64)
    maskf[:, :n_complete] = 1.0
    cov = np.linalg.qr(rng.normal(size=(N, K)) * ind[:, None])[0]
    indf = ind.astype(np.float64)
    return dict(raw=raw, nb=nb, ind=ind, flip=flip, cov=cov,
                res=res * indf[:, None], maskf=maskf * indf[:, None],
                sden=float(ind.sum() - K))


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _port_consts(jc):
    """The port's FusedConsts from the JAX package's, through numpy."""
    op = (dict(limbs=np.asarray(jc.Wp.limbs), scale=np.asarray(jc.Wp.scale))
          if jc.split == "i8" or hasattr(jc.Wp, "limbs")
          else dict(Wp=np.asarray(jc.Wp)))
    return tfs.consts_from_numpy(
        **op, usum=np.asarray(jc.usum), covt_res=np.asarray(jc.covt_res),
        Mmat=np.asarray(jc.Mmat), n_ind=jc.n_ind, K=jc.K, P=jc.P,
        scale_denom=jc.scale_denom, split=jc.split, inc=jc.inc,
        has_male=jc.has_male)


@pytest.mark.parametrize("case", ["random", "zero_column", "pow2_edge"])
def test_i8_quantize_matches_jax(jfs, case):
    """Host quantization: limbs, power-of-two scales and the quantized
    values are equal."""
    rng = np.random.default_rng(1)
    W = rng.normal(size=(4, 64, 16)) * np.exp2(rng.integers(-20, 20, 16))
    if case == "zero_column":
        W[..., 3] = 0.0
    if case == "pow2_edge":
        W[..., 5] = np.clip(W[..., 5], -127 * 2.0**-3, 127 * 2.0**-3)
        W[0, 0, 5] = 127 * 2.0**-3  # absmax / 127 is an exact power of two
    for a, b in zip(tfs._i8_quantize_np(W), jfs._i8_quantize_np(W)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("split", ["i8", False])
def test_plane_pack_matches_jax(jfs, split):
    """plane_pack and plane_order_rows: the same operand and usum."""
    rng = np.random.default_rng(2)
    N, C = 1025, 77
    Wext = rng.normal(size=(N, C))
    nb = (N + 3) // 4
    Wp, usum = tfs.plane_pack(Wext, nb, split)
    jWp, jusum = jfs.plane_pack(Wext, nb, split, dtype=np.float64)
    np.testing.assert_array_equal(usum, np.asarray(jusum))
    if split == "i8":
        np.testing.assert_array_equal(_np(Wp.limbs), np.asarray(jWp.limbs))
        np.testing.assert_array_equal(_np(Wp.scale), np.asarray(jWp.scale))
    else:
        np.testing.assert_array_equal(_np(Wp), np.asarray(jWp))
    np.testing.assert_array_equal(tfs.plane_order_rows(Wext, nb),
                                  jfs.plane_order_rows(Wext, nb))
    raw = rng.integers(0, 256, size=(5, nb), dtype=np.uint8)
    np.testing.assert_array_equal(tfs.pad_raw(raw), jfs.pad_raw(raw))


@pytest.mark.parametrize("split,n_complete", [
    ("i8", 0), ("i8", 2), (False, 0), (False, 3)])
def test_build_consts_matches_jax(jfs, split, n_complete):
    """build_consts: limbs/operand, scale, usum, inc, covt_res and Mmat are
    equal, and consts_from_numpy carries the JAX package's constants
    over unchanged."""
    c = _mk_case(3, n_complete=n_complete)
    args = (c["cov"], c["res"], c["maskf"], c["ind"], c["sden"])
    pc = tfs.build_consts(*args, nb=c["nb"], split=split)
    jc = jfs.build_consts(*args, nb=c["nb"], dtype=np.float64, split=split)
    assert tfs.split_mode(split == "i8") == split
    for got in (pc, _port_consts(jc)):
        assert got.inc == jc.inc and len(got.inc) == 3 - n_complete
        assert got.layout_C() == jc.layout_C()
        assert (got.n_ind, got.K, got.P, got.scale_denom) == (
            jc.n_ind, jc.K, jc.P, jc.scale_denom)
        if split == "i8":
            np.testing.assert_array_equal(_np(got.Wp.limbs), np.asarray(jc.Wp.limbs))
            np.testing.assert_array_equal(_np(got.Wp.scale), np.asarray(jc.Wp.scale))
        else:
            np.testing.assert_array_equal(_np(got.Wp), np.asarray(jc.Wp))
        for name in ("usum", "covt_res", "Mmat"):
            np.testing.assert_array_equal(_np(getattr(got, name)),
                                          np.asarray(getattr(jc, name)))


def _kmajor_np(limbs):
    """The K-major copy [4*Cp, 4*nbp] of plane-packed limbs [4, nbp, 4*Cp]."""
    return np.ascontiguousarray(limbs.reshape(-1, limbs.shape[-1]).T)


def _i8_oracle(rawp, limbs):
    """H, E, M as int64 numpy: the code-0/2/1 indicators of rawp, p-major
    over [B, 4*nbp], against the limbs read as [4*nbp, Cw4]."""
    codes = np.concatenate([(rawp.astype(np.int64) >> (2 * p)) & 3
                            for p in range(4)], axis=1)
    w = limbs.reshape(-1, limbs.shape[-1]).astype(np.int64)
    return [(codes == code).astype(np.int64) @ w for code in (0, 2, 1)]


def test_fused_i8_products_plain_exact(jfs):
    """The kernel's plain version on the K-major limbs: H/E/M equal an
    int64 numpy oracle of indicators x limbs; folded S1/SQ/SM match the
    JAX kernel in interpret mode (both fold int32 -> float32 once;
    observed max abs difference 0 on this case)."""
    import jax.numpy as jnp

    c = _mk_case(4)
    jc = jfs.build_consts(c["cov"], c["res"], c["maskf"], c["ind"], c["sden"],
                          nb=c["nb"], split="i8")
    rawp = jfs.pad_raw(c["raw"])
    limbs = np.array(jc.Wp.limbs)
    H, E, M = kernels.fused_i8_products_plain(torch.from_numpy(rawp),
                                             torch.from_numpy(_kmajor_np(limbs)))
    for got, want in zip((H, E, M), _i8_oracle(rawp, limbs)):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    # through the wrapper on CPU tensors: the plain version, no launch
    n0 = kernels.fused_i8_products.launches
    op = tfs.I8Operand(torch.from_numpy(limbs), torch.from_numpy(np.array(jc.Wp.scale)))
    got = tfs.fused_products(torch.from_numpy(rawp), op)
    assert kernels.fused_i8_products.launches == n0
    want = jfs.fused_products(jnp.asarray(rawp), jc.Wp, interpret=True)
    for g, wv in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(wv), rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("N", [5, 257, 1025, 3001])
def test_plane_pack_i8_limbs_k(N):
    """plane_pack(split="i8") fills limbs_k: contiguous int8 [4*Cp, 4*nbp],
    the limbs read as [4*nbp, 4*Cp] and transposed (column k = p*nbp + c
    is plane p of byte c), for byte counts nb off the 256-byte tile."""
    rng = np.random.default_rng(N)
    Wext = rng.normal(size=(N, 9))
    nb = (N + 3) // 4
    op, _ = tfs.plane_pack(Wext, nb, "i8")
    nbp = op.limbs.shape[1]
    assert nbp % 256 == 0 and nb % 256 != 0
    assert op.limbs_k.dtype == torch.int8 and op.limbs_k.is_contiguous()
    assert tuple(op.limbs_k.shape) == (4 * 128, 4 * nbp)
    np.testing.assert_array_equal(op.limbs_k.numpy(), _kmajor_np(op.limbs.numpy()))
    lk = op.limbs_k.numpy()
    for p in range(4):  # plane p of byte c at column p*nbp + c
        np.testing.assert_array_equal(lk[:, p * nbp : (p + 1) * nbp],
                                      op.limbs.numpy()[p].T)


@pytest.mark.parametrize("seed", [3, 18])
def test_consts_from_numpy_plane_limbs_k(jfs, seed):
    """consts_from_numpy with the JAX package's plane-packed limbs gives
    the same K-major copy as the port's own build_consts."""
    c = _mk_case(seed, N=777 + seed)
    args = (c["cov"], c["res"], c["maskf"], c["ind"], c["sden"])
    jc = jfs.build_consts(*args, nb=c["nb"], dtype=np.float64, split="i8")
    carried = _port_consts(jc).Wp
    own = tfs.build_consts(*args, nb=c["nb"], split="i8").Wp
    assert carried.limbs_k.is_contiguous()
    np.testing.assert_array_equal(carried.limbs_k.numpy(),
                                  _kmajor_np(np.asarray(jc.Wp.limbs)))
    assert torch.equal(carried.limbs_k, own.limbs_k)


@pytest.mark.parametrize("pack,shift", [
    ("plane", 0.125), ("plane", 127 * 2.0**-5), ("sample", 0.125)])
def test_patch_res_columns_i8_limbs_k(jfs, pack, shift):
    """patch_res_columns updates the K-major copy with the limbs: for a
    plane-packed operand the patched limbs equal the JAX package's patch
    and limbs_k equals their K-major copy; a sample-packed operand's
    limbs_k equals its patched limbs.T, as before. The input operand is
    left unchanged."""
    c = _mk_case(8)
    args = (c["cov"], c["res"], c["maskf"], c["ind"], c["sden"])
    jc = jfs.build_consts(*args, nb=c["nb"], dtype=np.float64, split="i8",
                          pack=pack)
    K, P = jc.K, jc.P
    res2 = np.clip(c["res"] * 0.01, -shift, shift)
    res2[np.argmax(c["ind"]), 0] = shift
    res2 = res2 * c["ind"][:, None]
    if pack == "plane":
        res_pl = jfs.plane_order_rows(res2, c["nb"])
    else:
        res_pl = np.zeros(np.asarray(jc.Wp.limbs).shape[:-1] + (P,))
        res_pl[: len(res2)] = res2
    res_pl = res_pl.astype(np.float32)
    Cp = jc.Wp.scale.shape[0]
    port = _port_consts(jc).Wp
    before = port.limbs_k.clone()
    want = jfs.patch_res_columns(jc.Wp, res_pl, K, P, Cp, "i8")
    got = tfs.patch_res_columns(port, torch.from_numpy(res_pl), K, P, Cp)
    np.testing.assert_array_equal(got.limbs.numpy(), np.asarray(want.limbs))
    assert got.limbs_k.is_contiguous()
    np.testing.assert_array_equal(got.limbs_k.numpy(), _kmajor_np(got.limbs.numpy()))
    if pack == "sample":
        np.testing.assert_array_equal(got.limbs_k.numpy(), got.limbs.numpy().T)
    assert torch.equal(port.limbs_k, before)
    assert not torch.equal(got.limbs_k, before)


@pytest.mark.parametrize("seed,B,N", [(20, 37, 1025), (21, 1, 300), (22, 130, 2049)])
def test_fused_i8_products_plain_kmajor(jfs, seed, B, N):
    """fused_i8_products_plain on an operand's limbs_k equals the int64
    oracle, and fused_products on the operand, folded, equals the JAX
    package's fused_products in interpret mode (rtol 1e-6: both fold the
    exact int32 sums into float32 once)."""
    import jax.numpy as jnp

    c = _mk_case(seed, B=B, N=N)
    jc = jfs.build_consts(c["cov"], c["res"], c["maskf"], c["ind"], c["sden"],
                          nb=c["nb"], split="i8")
    rawp = jfs.pad_raw(c["raw"])
    op = _port_consts(jc).Wp
    got = kernels.fused_i8_products_plain(torch.from_numpy(rawp), op.limbs_k)
    for g, w in zip(got, _i8_oracle(rawp, np.asarray(jc.Wp.limbs))):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), w)
    want = jfs.fused_products(jnp.asarray(rawp), jc.Wp, interpret=True)
    for g, w in zip(tfs.fused_products(torch.from_numpy(rawp), op), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("layout", ["planes", "rows", "wrong_k"])
def test_fused_i8_rejects_non_kmajor_operand(layout):
    """An operand in the [4, nbp, Cw4] layout, read as [4*nbp, Cw4], or
    K-major with a second axis other than 4*nbp raises ValueError in the
    wrapper and in its plain version, before any launch."""
    rng = np.random.default_rng(23)
    nbp, Cw4 = 48, 32
    raw = torch.from_numpy(rng.integers(0, 256, (5, nbp), dtype=np.uint8))
    w = {"planes": torch.zeros((4, nbp, Cw4), dtype=torch.int8),
         "rows": torch.zeros((4 * nbp, Cw4), dtype=torch.int8),
         "wrong_k": torch.zeros((Cw4, 4 * nbp + 16), dtype=torch.int8)}[layout]
    n0 = kernels.fused_i8_products.launches
    for fn in (kernels.fused_i8_products, kernels.fused_i8_products_plain):
        with pytest.raises(ValueError, match="K-major"):
            fn(raw, w)
    assert kernels.fused_i8_products.launches == n0


def test_fused_products_reads_limbs_k():
    """fused_products hands the wrapper the operand's K-major copy: an
    operand whose limbs_k differs from the copy of its limbs gives the
    products of limbs_k; one built by hand without limbs_k takes the
    transposed view of its limbs, which the CPU's plain version takes,
    with no launch."""
    c = _mk_case(24, B=6, N=301)
    op, _ = tfs.plane_pack(np.random.default_rng(24).normal(size=(301, 7)),
                           c["nb"], "i8")
    raw = torch.from_numpy(tfs.pad_raw(c["raw"]))
    other_limbs = op.limbs.flip(1).contiguous()
    other = tfs.I8Operand(op.limbs, op.scale,
                          torch.from_numpy(_kmajor_np(other_limbs.numpy())))
    hand = tfs.I8Operand(op.limbs, op.scale)
    n0 = kernels.fused_i8_products.launches
    got = tfs.fused_products(raw, other)
    want = tfs.fused_products(raw, tfs.I8Operand(other_limbs, op.scale))
    base = tfs.fused_products(raw, op)
    for g, w, b, h in zip(got, want, base, tfs.fused_products(raw, hand)):
        assert torch.equal(g, w) and not torch.equal(g, b) and torch.equal(h, b)
    assert kernels.fused_i8_products.launches == n0


def test_plane_products_match_decoded_dosages(jfs):
    """The plane-packed products equal dosage products on the sample axis:
    the port's decode_bed_bytes gives the JAX package's genotypes, and
    G0 @ Wext, G0^2 @ Wext and miss @ Wext (missing as 0) are what
    fused_products_plain computes against plane_pack(Wext)."""
    from regenie_tpu.io.bed import decode_bed_bytes as jdecode

    from regenie_tpu_torch.io.bed import MISSING_GENO, decode_bed_bytes

    c = _mk_case(10)
    N = len(c["ind"])
    G = decode_bed_bytes(c["raw"], N)
    np.testing.assert_array_equal(G, jdecode(c["raw"], N))
    miss = (G == MISSING_GENO).astype(np.float64)
    G0 = np.where(G == MISSING_GENO, 0, G).astype(np.float64)
    Wext = np.random.default_rng(10).normal(size=(N, 9))
    Wp, _ = tfs.plane_pack(Wext, c["nb"], False)
    got = tfs.fused_products_plain(torch.from_numpy(tfs.pad_raw(c["raw"])), Wp)
    for g, want in zip(got, (G0 @ Wext, G0**2 @ Wext, miss @ Wext)):
        np.testing.assert_allclose(g[:, :9].numpy(), want, rtol=1e-12, atol=1e-10)


def test_fused_products_plain_f64_matches_xla(jfs):
    """float64 plain products against the JAX package's fused_products_xla."""
    import jax.numpy as jnp

    c = _mk_case(5)
    jc = jfs.build_consts(c["cov"], c["res"], c["maskf"], c["ind"], c["sden"],
                          nb=c["nb"], dtype=np.float64)
    rawp = jfs.pad_raw(c["raw"])
    got = tfs.fused_products_plain(torch.from_numpy(rawp), torch.from_numpy(np.array(jc.Wp)))
    want = jfs.fused_products_xla(jnp.asarray(rawp), jc.Wp)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12, atol=1e-12)


EPILOGUE_CASES = {
    # name: (test_type, strict, ref_first, flip, n_complete)
    "add": (0, False, False, False, 0),
    "add_flip": (0, False, False, True, 0),
    "dom": (1, False, False, False, 0),
    "rec": (2, False, False, False, 0),
    "strict": (0, True, False, False, 3),
    "ref_first": (0, False, True, False, 0),
    "mixed_inc": (0, False, False, True, 2),
}


@pytest.mark.parametrize("name", list(EPILOGUE_CASES))
def test_fused_epilogue_matches_jax(jfs, name):
    """fused_epilogue (and ref_first_products) on the same float64
    products: every output within rtol 1e-9, atol 1e-9."""
    import jax.numpy as jnp

    test_type, strict, ref_first, use_flip, n_complete = EPILOGUE_CASES[name]
    c = _mk_case(6, n_complete=n_complete)
    jc = jfs.build_consts(c["cov"], c["res"], c["maskf"], c["ind"], c["sden"],
                          nb=c["nb"], dtype=np.float64)
    S1, SQ, SM = (np.asarray(x) for x in jfs.fused_products_xla(
        jnp.asarray(jfs.pad_raw(c["raw"])), jc.Wp))
    flip = c["flip"] if use_flip else np.zeros(len(c["flip"]), bool)
    usum = np.asarray(jc.usum)
    if ref_first:
        jS1, jSQ = jfs.ref_first_products(S1, SQ, SM, usum)
        tS1, tSQ = tfs.ref_first_products(*(torch.tensor(x) for x in (S1, SQ, SM, usum)))
        np.testing.assert_allclose(tS1.numpy(), np.asarray(jS1), rtol=1e-12)
        np.testing.assert_allclose(tSQ.numpy(), np.asarray(jSQ), rtol=1e-12)
        S1, SQ = np.asarray(jS1), np.asarray(jSQ)
    common = (jc.K, jc.P, jc.scale_denom, jc.n_ind, test_type, jc.inc, strict)
    want = jfs.fused_epilogue(S1, SQ, SM, flip, usum, np.asarray(jc.covt_res),
                              np.asarray(jc.Mmat), *common)
    got = tfs.fused_epilogue(
        *(torch.tensor(x) for x in (S1, SQ, SM, flip, usum,
                                        np.asarray(jc.covt_res), np.asarray(jc.Mmat))),
        *common)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("test_type,ref_first,strict", [
    (0, False, False), (1, True, False), (2, False, True)])
def test_make_qt_block_fn_matches_jax(jfs, test_type, ref_first, strict):
    """The QT block function end to end at float64 (products, ref-first,
    epilogue and the product slices), the port's consts carried over from
    the JAX package's: within rtol 1e-9, atol 1e-9."""
    import jax.numpy as jnp

    c = _mk_case(7, n_complete=3 if strict else 1)
    jc = jfs.build_consts(c["cov"], c["res"], c["maskf"], c["ind"], c["sden"],
                          nb=c["nb"], dtype=np.float64)
    rawp = jfs.pad_raw(c["raw"])
    want = jfs.make_qt_block_fn(jc, False, test_type, ref_first, strict=strict)(
        jnp.asarray(rawp))
    got = tfs.make_qt_block_fn(_port_consts(jc), True, test_type, ref_first,
                               strict=strict)(torch.from_numpy(rawp))
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("shift", [0.125, 127 * 2.0**-5])
def test_patch_res_columns_i8_matches_jax(jfs, shift):
    """Per-chromosome residual patch of the int8 operand: the re-quantized
    limbs and scales equal the JAX package's (the second case puts a
    column's absmax / 127 on an exact power of two, where log2 decides)."""
    c = _mk_case(8)
    jc = jfs.build_consts(c["cov"], c["res"], c["maskf"], c["ind"], c["sden"],
                          nb=c["nb"], split="i8")
    K, P = jc.K, jc.P
    res2 = np.clip(c["res"] * 0.01, -shift, shift)
    res2[np.argmax(c["ind"]), 0] = shift
    res_pl = jfs.plane_order_rows(res2 * c["ind"][:, None], c["nb"]).astype(np.float32)
    Cp = jc.Wp.scale.shape[0]
    want = jfs.patch_res_columns(jc.Wp, res_pl, K, P, Cp, "i8")
    got = tfs.patch_res_columns(_port_consts(jc).Wp, torch.from_numpy(res_pl), K, P, Cp)
    np.testing.assert_array_equal(got.limbs.numpy(), np.asarray(want.limbs))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))


@pytest.mark.cuda
def test_fused_i8_kernel_matches_plain_on_cuda(cuda):
    """The CUDA kernel against its plain version on the card, on the K-major
    operand at ragged shapes (rows off the 128-row tile, byte counts that
    end mid-stage or give one stage or an odd number of stages, so that
    the two halves of the contraction are uneven or one is empty, columns
    off the 128-column tile): H/E/M equal, and each call counts one
    launch. A [4, nbp, Cw4] operand on the card raises, with no launch."""
    rng = np.random.default_rng(9)
    for B, nbp, Cw4 in ((37, 272, 400), (130, 512, 1536), (1, 16, 16),
                        (129, 48, 1552), (200, 16400, 400)):
        raw = torch.from_numpy(rng.integers(0, 256, (B, nbp), dtype=np.uint8)).to(cuda)
        limbs_k = torch.from_numpy(
            rng.integers(-128, 128, (Cw4, 4 * nbp), dtype=np.int8)).to(cuda)
        n0 = kernels.fused_i8_products.launches
        got = kernels.fused_i8_products(raw, limbs_k)
        assert kernels.fused_i8_products.launches == n0 + 1
        want = kernels.fused_i8_products_plain(raw, limbs_k)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    # the [4, nbp, Cw4] limbs, and their transposed view, on the card: no
    # kernel takes them, and no fallback to the plain version either
    limbs = limbs_k.T.reshape(4, nbp, Cw4).contiguous()
    n0 = kernels.fused_i8_products.launches
    with pytest.raises(ValueError, match="K-major"):
        kernels.fused_i8_products(raw, limbs)
    with pytest.raises(ValueError, match="contiguous"):
        tfs.fused_products(raw, tfs.I8Operand(limbs, torch.ones(Cw4 // 4, device=cuda)))
    assert kernels.fused_i8_products.launches == n0
    # a float64 operand on the card has no kernel: it raises, and does not
    # fall back to the plain version
    with pytest.raises(TypeError, match="no kernel takes a torch.float64"):
        tfs.fused_products(raw, torch.zeros((4, nbp, 128), dtype=torch.float64,
                                            device=cuda))



@pytest.mark.cuda
def test_fused_i8_byte_windows_on_cuda(cuda):
    """The 2-D mesh's launches (fused_score.operand_window): a plane-packed
    int8 operand padded to ns * _TC bytes, cut into ns byte windows, each
    a contiguous [Cw4, 4 * nbp / ns] K-major copy of four strided column
    windows; fused_i8 on each window of the block, one launch a window,
    summed, equals the whole block's products exactly (int32), on ragged
    row counts and on 2 and 4 windows."""
    rng = np.random.default_rng(21)
    for B, ns, N, C in ((37, 2, 1201, 130), (130, 4, 3001, 40), (1, 2, 513, 300)):
        nb = (N + 3) // 4
        Wp, _ = tfs.plane_pack(rng.normal(size=(N, C)), nb, "i8", device=cuda,
                               nbp_tile=ns * tfs._TC)
        nbp = tfs.op_nbp(Wp)
        w = nbp // ns
        raw = torch.from_numpy(tfs.pad_raw(
            rng.integers(0, 256, (B, nb), dtype=np.uint8), nbp)).to(cuda)
        want = kernels.fused_i8_products(raw, Wp.limbs_k)
        n0 = kernels.fused_i8_products.launches
        parts = []
        for c in range(ns):
            win = tfs.operand_window(Wp, c, ns)
            assert win.limbs_k.shape == (Wp.limbs_k.shape[0], 4 * w)
            assert win.limbs_k.is_contiguous()
            parts.append(kernels.fused_i8_products(raw[:, c * w:(c + 1) * w].contiguous(),
                                                   win.limbs_k))
        assert kernels.fused_i8_products.launches == n0 + ns
        torch.cuda.synchronize()
        for i, whole in enumerate(want):
            got = parts[0][i]
            for p in parts[1:]:
                got = got + p[i]
            assert torch.equal(got, whole)


def _quantize_columns(rng):
    """Columns that probe the int8 quantizer: random spans over many
    octaves, an all-zero column, half-way ties at every limb (k + 0.5
    steps of the scale), and column maxima at 127 * 2^k and one ulp
    either side of it."""
    R = 700
    W = rng.normal(size=(R, 64)) * np.exp2(rng.integers(-40, 40, 64))[None, :]
    W[:, 0] = 0.0
    k = np.arange(R) % 8
    W[:, 1] = (rng.integers(-126, 126, R) + 0.5) * 2.0**-3  # ties at limb 0
    W[0, 1] = 127 * 2.0**-3
    W[:, 2] = (rng.integers(-60, 60, R) + 0.5 / 128) * 2.0 ** (k - 4)  # limb 1
    W[0, 2] = 127 * 2.0**3
    for c, e in ((3, 5), (4, -7), (5, 0)):
        W[:, c] = rng.uniform(-1, 1, R) * 127 * 2.0**e
        W[1, c] = 127 * 2.0**e
    W[1, 4] = np.nextafter(127 * 2.0**-7, np.inf)
    W[1, 5] = np.nextafter(127.0, 0.0)
    W[:, 6] = -W[:, 3]
    return W


def test_i8_quantize_bit_for_bit():
    """i8_quantize (the operand builds' quantizer, which runs on the
    card) gives _i8_quantize_np's limbs and scales bit for bit and the
    exact column sums of the quantized values, on random columns, zero
    columns, half-way ties and maxima at and around 127 * 2^k; and
    plane_pack / sample_pack build the same operand either way."""
    rng = np.random.default_rng(30)
    W = _quantize_columns(rng)
    limbs, scale, usum = tfs.i8_quantize(torch.from_numpy(W))
    l_np, s_np, q_np = tfs._i8_quantize_np(W)
    np.testing.assert_array_equal(limbs.numpy(), l_np)
    np.testing.assert_array_equal(scale.numpy(), s_np)
    np.testing.assert_array_equal(usum, q_np.sum(axis=0))
    Wext = W[:, :50]
    op, us = tfs.plane_pack(Wext, 175, "i8")
    Wp = np.zeros((4, 256, 128))
    Wp[..., :50] = tfs._plane_order(Wext, 175, 256)
    l_np, s_np, q_np = tfs._i8_quantize_np(Wp)
    np.testing.assert_array_equal(op.limbs.numpy(), l_np)
    np.testing.assert_array_equal(op.scale.numpy(), s_np)
    np.testing.assert_array_equal(us, q_np.sum(axis=(0, 1)))
    op, us = tfs.sample_pack(Wext, "i8")
    Ws = np.zeros((768, 128))
    Ws[:700, :50] = Wext
    l_np, s_np, q_np = tfs._i8_quantize_np(Ws)
    np.testing.assert_array_equal(op.limbs.numpy(), l_np)
    np.testing.assert_array_equal(op.scale.numpy(), s_np)
    np.testing.assert_array_equal(us, q_np.sum(axis=0))


@pytest.mark.cuda
def test_i8_quantize_on_cuda(cuda):
    """The same quantization on the card: limbs and scales bit for bit
    the host's, the column sums exact."""
    rng = np.random.default_rng(31)
    W = _quantize_columns(rng)
    limbs, scale, usum = tfs.i8_quantize(torch.from_numpy(W).to(cuda))
    l_np, s_np, q_np = tfs._i8_quantize_np(W)
    np.testing.assert_array_equal(limbs.cpu().numpy(), l_np)
    np.testing.assert_array_equal(scale.cpu().numpy(), s_np)
    np.testing.assert_array_equal(usum, q_np.sum(axis=0))
