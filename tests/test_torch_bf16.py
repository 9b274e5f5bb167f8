"""Tests of the port's bf16 hi|mid|lo split operand (the JAX package's
build_consts(split=True) path, which no CLI option selects): the split
itself, the operand and constants, the residual patch, the fused_bf16 and
bgen_bf16 products, score_block_fused and the QT block functions, each
against the JAX package on the CPU at small sizes (the same numpy inputs,
made from a seed, go through both); and, with marker `cuda`, the two
hand-written kernels against their plain versions. On the GPU machine,
which has no JAX, run the card's tests with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_bf16.py
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


def _bits(x):
    """bfloat16 bits of a torch tensor or a JAX / ml_dtypes array, as
    uint16."""
    if isinstance(x, torch.Tensor):
        return x.cpu().view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)


def _mk_case(seed, B=24, N=1025, P=3, K=4, n_complete=1, excl_rate=0.1):
    """Random packed bytes (all four codes), probability planes (4%
    missing, k0 + k1 <= 255 elsewhere, padded to the sample-packed
    operand's length), per-trait flips and per-sample inputs, as
    tests/test_torch_f32.py builds them."""
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
    flip = rng.random(B) < 0.5
    return dict(raw=raw, nb=nb, planes=planes, ind=ind, cov=cov, res=res,
                maskf=maskf * indf[:, None], sden=float(ind.sum() - K),
                flip=flip)


def _args(c):
    return c["cov"], c["res"], c["maskf"], c["ind"], c["sden"]


def _tail(c):
    """The narrow SQ operand's columns [maskf | ind] (ind-masked)."""
    indf = c["ind"].astype(np.float64)[:, None]
    return np.concatenate([c["maskf"] * indf, indf], axis=1)


def _kw(c, pack):
    return dict(nb=c["nb"]) if pack == "plane" else dict(pack="sample")


def _fold64(bits):
    """float64 values of a bf16 split operand given as its uint16 bits:
    hi + mid + lo, summed exactly."""
    v = (bits.astype(np.uint32) << 16).view(np.float32).astype(np.float64)
    C = v.shape[-1] // 3
    return v[..., :C] + v[..., C : 2 * C] + v[..., 2 * C :]


# ---------------------------------------------------------------------------
# the split operand
# ---------------------------------------------------------------------------


def test_bf16_split3_matches_jax(jfs):
    """bf16_split3 on float32 values over many binades (zeros, tiny, huge,
    both signs) gives the JAX package's hi, mid and lo bits exactly: both
    round to nearest even."""
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    w = (rng.normal(size=4096) * np.exp2(rng.integers(-60, 60, 4096))).astype(np.float32)
    w[:8] = [0.0, -0.0, 1.0, -1.0, 1e-30, 3e38, 1.00390625, 1.01171875]
    got = tfs.bf16_split3(torch.from_numpy(w))
    want = jfs.bf16_split3(jnp.asarray(w))
    for g, x in zip(got, want):
        assert g.dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits(g), _bits(x))


@pytest.mark.parametrize("N", [1025, 300])
def test_plane_pack_split_matches_jax(jfs, N):
    """plane_pack(split=True): the bf16 [4, nbp, 3*Cp] operand has the
    JAX package's bits exactly, and usum is its float64 column sum."""
    rng = np.random.default_rng(N)
    Wext = rng.normal(size=(N, 77))
    nb = (N + 3) // 4
    Wp, usum = tfs.plane_pack(Wext, nb, True)
    jWp, jusum = jfs.plane_pack(Wext, nb, True)
    assert Wp.dtype == torch.bfloat16 and Wp.shape == (4, 256 * -(-nb // 256), 384)
    np.testing.assert_array_equal(_bits(Wp), _bits(jWp))
    np.testing.assert_array_equal(usum, np.asarray(jusum))


@pytest.mark.parametrize("narrow", [False, True])
def test_sample_pack_split_matches_jax(jfs, narrow):
    """sample_pack(split=True), full width and the narrow [maskf | ind]
    operand: the bf16 [Np, 3*Cp] bits and usum equal the JAX package's."""
    c = _mk_case(2)
    X = _tail(c) if narrow else np.concatenate([c["cov"], c["res"], _tail(c)], 1)
    Wp, usum = tfs.sample_pack(X, True)
    jWp, jusum = jfs.sample_pack(X, True)
    assert Wp.dtype == torch.bfloat16 and Wp.shape == (1280, 384)
    np.testing.assert_array_equal(_bits(Wp), _bits(jWp))
    np.testing.assert_array_equal(usum, np.asarray(jusum))


@pytest.mark.parametrize("pack", ["plane", "sample"])
def test_build_consts_split_matches_jax(jfs, pack):
    """build_consts(split=True): the operand's bits equal the JAX
    package's, the float64 constants round to its float32 constants.
    consts_from_numpy carries the JAX package's bf16 Wp and narrow Wq
    across bit for bit, given as the ml_dtypes array or its uint16 view."""
    c = _mk_case(3)
    pc = tfs.build_consts(*_args(c), split=True, **_kw(c, pack))
    jc = jfs.build_consts(*_args(c), split=True, **_kw(c, pack))
    jWq, _ = jfs.sample_pack(_tail(c), True)
    assert pc.split and jc.split
    assert pc.inc == jc.inc and pc.layout_C() == jc.layout_C()
    np.testing.assert_array_equal(_bits(pc.Wp), _bits(jc.Wp))
    for name in ("usum", "covt_res", "Mmat"):
        assert getattr(pc, name).dtype == torch.float64
        np.testing.assert_array_equal(_np(getattr(pc, name).float()),
                                      np.asarray(getattr(jc, name)))
    for view in (lambda a: np.asarray(a), lambda a: np.asarray(a).view(np.uint16)):
        carried = tfs.consts_from_numpy(
            Wp=view(jc.Wp), usum=np.asarray(jc.usum),
            covt_res=np.asarray(jc.covt_res), Mmat=np.asarray(jc.Mmat),
            n_ind=jc.n_ind, K=jc.K, P=jc.P, scale_denom=jc.scale_denom,
            split=jc.split, inc=jc.inc, wq=view(jWq))
        assert carried.Wp.dtype == carried.Wq.dtype == torch.bfloat16
        assert carried.split
        np.testing.assert_array_equal(_bits(carried.Wp), _bits(jc.Wp))
        np.testing.assert_array_equal(_bits(carried.Wq), _bits(jWq))


@pytest.mark.parametrize("layout", ["plane", "sample"])
def test_patch_res_columns_bf16_matches_jax(jfs, layout):
    """patch_res_columns on a bf16 split operand writes the hi, mid and lo
    parts of the float32 residuals into [K:K+P], [Cp+K:...] and
    [2Cp+K:...] with the bits of the JAX package's split patch, and leaves
    every other column."""
    import jax.numpy as jnp

    rng = np.random.default_rng(4)
    K, P, Cp = 2, 3, 128
    lead = (4, 8) if layout == "plane" else (32,)
    base = tfs.bf16_split3(torch.from_numpy(
        rng.normal(size=lead + (Cp,)).astype(np.float32)))
    base = torch.cat(base, dim=-1)
    res = rng.normal(size=lead + (P,))
    want = jfs.patch_res_columns(jnp.asarray(_np(base.float())).astype(jnp.bfloat16),
                                 res, K, P, Cp, True)
    got = tfs.patch_res_columns(base, torch.from_numpy(res), K, P, Cp)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(got), _bits(want))
    cols = np.r_[K : K + P, Cp + K : Cp + K + P, 2 * Cp + K : 2 * Cp + K + P]
    np.testing.assert_array_equal(np.delete(_bits(got), cols, -1),
                                  np.delete(_bits(base), cols, -1))
    np.testing.assert_allclose(_fold64(_bits(got))[..., K : K + P], res,
                               rtol=2e-7, atol=0)


# ---------------------------------------------------------------------------
# products
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("N", [1025, 300])
def test_fused_bf16_products_plain_matches_oracle(jfs, N):
    """fused_products on CPU tensors with the bf16 split takes the plain
    version of fused_bf16 (no launch): within 1e-9 of a float64 numpy
    oracle on the split bits (decoded genotypes times hi + mid + lo)."""
    from regenie_tpu.io.bed import decode_bed_bytes

    c = _mk_case(5, N=N)
    jc = jfs.build_consts(*_args(c), split=True, nb=c["nb"])
    rawp = jfs.pad_raw(c["raw"])
    n0 = kernels.fused_bf16_products.launches
    pc = tfs.consts_from_numpy(
        Wp=np.asarray(jc.Wp), usum=np.asarray(jc.usum),
        covt_res=np.asarray(jc.covt_res), Mmat=np.asarray(jc.Mmat),
        n_ind=jc.n_ind, K=jc.K, P=jc.P, scale_denom=jc.scale_denom, inc=jc.inc)
    got = tfs.fused_products(torch.from_numpy(rawp), pc.Wp)
    assert kernels.fused_bf16_products.launches == n0
    G = np.asarray(decode_bed_bytes(c["raw"], N)).astype(np.float64)  # -3 = missing
    W = _fold64(_bits(jc.Wp))  # [4, nbp, Cp], plane p byte c = sample 4c + p
    Wn = np.stack([W[s % 4, s // 4] for s in range(N)])
    miss = G == -3
    G0 = np.where(miss, 0.0, G)
    for g, w in zip(got, (G0 @ Wn, (G0**2) @ Wn, miss.astype(float) @ Wn)):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("ref", ["xla", "pallas_interpret"])
def test_fused_bf16_products_match_jax(jfs, ref):
    """The same products against the JAX package's fused_products_xla
    (the split folded to float32) and its Pallas _fused_kernel_split in
    interpret mode (float32 sums), on the same bf16 operand: the bars of
    tests/test_fused_score.py:239-242, rtol 2e-6 and atol 1e-4."""
    import jax.numpy as jnp

    c = _mk_case(6, B=16)
    jc = jfs.build_consts(*_args(c), split=True, nb=c["nb"])
    rawp = jfs.pad_raw(c["raw"])
    if ref == "xla":
        want = jfs.fused_products_xla(jnp.asarray(rawp), jc.Wp)
    else:
        want = jfs.fused_products(jnp.asarray(rawp), jc.Wp, interpret=True)
    got = tfs.fused_products(torch.from_numpy(rawp),
                             tfs.consts_from_numpy(
                                 Wp=np.asarray(jc.Wp), usum=np.asarray(jc.usum),
                                 covt_res=np.asarray(jc.covt_res),
                                 Mmat=np.asarray(jc.Mmat), n_ind=jc.n_ind,
                                 K=jc.K, P=jc.P, scale_denom=jc.scale_denom).Wp)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-6, atol=1e-4)


@pytest.mark.parametrize("narrow", [False, True])
def test_bgen_bf16_products_plain_matches_oracle(jfs, narrow):
    """bgen_fused_products on CPU tensors with the bf16 split (full width,
    or the narrow Wq with qs) takes the plain version of bgen_bf16 (no
    launch): within 1e-9 of a float64 numpy oracle on the split bits."""
    c = _mk_case(7)
    Wext = np.concatenate([c["cov"], c["res"], _tail(c)], axis=1)
    C_used = Wext.shape[1]
    Wp, _ = tfs.sample_pack(Wext, True)
    W = _fold64(_bits(Wp))
    N = len(c["ind"])
    k0 = c["planes"][:, 0, :N].astype(np.float64)
    k1 = c["planes"][:, 1, :N].astype(np.float64)
    miss = k0 + k1 > 255
    k0[miss] = 0.0
    k1[miss] = 0.0
    d = (2 * k0 + k1) / 255.0
    Wn = W[:N]
    want = (d @ Wn, (d**2) @ Wn, miss.astype(float) @ Wn,
            ((4 * k0 + k1) / 255.0) @ Wn)
    n0 = kernels.bgen_bf16_products.launches
    planes = torch.from_numpy(c["planes"])
    if narrow:
        qs = C_used - (c["res"].shape[1] + 1)
        Wq, _ = tfs.sample_pack(_tail(c), True)
        got = tfs.bgen_fused_products(planes, Wp, Wq, qs=qs, C_used=C_used)
        assert not got[1][:, :qs].any() and not got[1][:, C_used:].any()
    else:
        qs = 0
        got = tfs.bgen_fused_products(planes, Wp)
    assert kernels.bgen_bf16_products.launches == n0
    for i, (g, w) in enumerate(zip(got, want)):
        lo = qs if i == 1 else 0
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g[:, lo:C_used].numpy(), w[:, lo:C_used],
                                   rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("ref,narrow", [("xla", False), ("pallas_interpret", False),
                                        ("pallas_interpret", True)])
def test_bgen_bf16_products_match_jax(jfs, ref, narrow):
    """The same against the JAX package's bgen_fused_products_xla (the
    split folded to float32) and its Pallas _bgen_kernel_split with the
    bf16 operand in interpret mode (float32 sums), with and without the
    narrow Wq: the bars of tests/test_fused_score.py:559-561, rtol 2e-5
    and atol 2e-3."""
    import jax.numpy as jnp

    c = _mk_case(8, B=8, N=300)
    jc = jfs.build_consts(*_args(c), split=True, pack="sample")
    C_used = jc.layout_C()
    pj = jnp.asarray(c["planes"])
    planes = torch.from_numpy(c["planes"])
    carry = dict(usum=np.asarray(jc.usum), covt_res=np.asarray(jc.covt_res),
                 Mmat=np.asarray(jc.Mmat), n_ind=jc.n_ind, K=jc.K, P=jc.P,
                 scale_denom=jc.scale_denom)
    qs = 0
    if ref == "xla":
        want = jfs.bgen_fused_products_xla(pj, jc.Wp)
        got = tfs.bgen_fused_products(planes, tfs.consts_from_numpy(
            Wp=np.asarray(jc.Wp), **carry).Wp)
    elif narrow:
        qs = C_used - (jc.P + 1)
        jWq, _ = jfs.sample_pack(_tail(c), True)
        want = jfs.bgen_fused_products(pj, jc.Wp, jWq, qs=qs, C_used=C_used,
                                       interpret=True, tb=8)
        pc = tfs.consts_from_numpy(Wp=np.asarray(jc.Wp), wq=np.asarray(jWq),
                                   **carry)
        got = tfs.bgen_fused_products(planes, pc.Wp, pc.Wq, qs=qs, C_used=C_used)
    else:
        want = jfs.bgen_fused_products(pj, jc.Wp, interpret=True, tb=8)
        got = tfs.bgen_fused_products(planes, tfs.consts_from_numpy(
            Wp=np.asarray(jc.Wp), **carry).Wp)
    for i, (g, w) in enumerate(zip(got, want)):
        lo = qs if i == 1 else 0
        np.testing.assert_allclose(g[:, lo:C_used].numpy(),
                                   np.asarray(w)[:, lo:C_used],
                                   rtol=2e-5, atol=2e-3)


def test_bf16_wrappers_reject_bad_inputs():
    """A wrapper given tensors on two devices, or a CUDA-bound operand of
    the wrong dtype, raises; it does not move them or fall back."""
    raw = torch.zeros((2, 16), dtype=torch.uint8)
    with pytest.raises(ValueError, match="same CUDA device"):
        kernels.fused_bf16_products(
            raw, torch.zeros((4, 16, 8), dtype=torch.bfloat16, device="meta"))
    planes = torch.zeros((2, 2, 16), dtype=torch.uint8)
    w = torch.zeros((16, 8), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="same CUDA device"):
        kernels.bgen_bf16_products(planes, w, w.to("meta"))
    with pytest.raises(ValueError, match="same CUDA device"):
        kernels.decode_planes(raw.to("meta"))


# ---------------------------------------------------------------------------
# the slice: score_block_fused and the QT block functions
# ---------------------------------------------------------------------------


def _carried(jc, jWq=None):
    """The port's consts carried across from the JAX package's split
    consts, with float64 constants."""
    return tfs.consts_from_numpy(
        Wp=np.asarray(jc.Wp), usum=np.asarray(jc.usum, np.float64),
        covt_res=np.asarray(jc.covt_res, np.float64),
        Mmat=np.asarray(jc.Mmat, np.float64), n_ind=jc.n_ind, K=jc.K, P=jc.P,
        scale_denom=jc.scale_denom, split=jc.split, inc=jc.inc,
        wq=None if jWq is None else np.asarray(jWq))


def _folded_jax(jc):
    """The JAX package's float64 consts of the same case on the split
    values folded exactly to float64 (its float64 oracle)."""
    import jax.numpy as jnp

    return jc._replace(Wp=jnp.asarray(_fold64(_bits(jc.Wp))))


@pytest.mark.parametrize("seed", [9, 10])
def test_score_block_fused_split_matches_jax(jfs, seed):
    """score_block_fused with split consts carried across by
    consts_from_numpy and random allele flips, against the JAX package's
    score_block_fused: (a) on its float64 consts of the folded split
    values, XLA products, rtol 1e-9 and atol 1e-9; (b) on its split
    consts with the Pallas _fused_kernel_split in interpret mode (float32
    sums and float32 epilogue), rtol 1e-4 and atol 1e-4, the float32
    epilogue's reach at N=1025 (the incomplete traits' denominators
    cancel)."""
    import jax.numpy as jnp

    c = _mk_case(seed)
    jc = jfs.build_consts(*_args(c), split=True, nb=c["nb"], dtype=np.float64)
    pc = _carried(jc)
    rawp = jfs.pad_raw(c["raw"])
    got = tfs.score_block_fused(torch.from_numpy(rawp), torch.from_numpy(c["flip"]), pc)
    assert c["flip"].any() and not c["flip"].all()
    want64 = jfs.score_block_fused(jnp.asarray(rawp), jnp.asarray(c["flip"]),
                                   _folded_jax(jc), use_pallas=False)
    j32 = jfs.build_consts(*_args(c), split=True, nb=c["nb"])
    want32 = jfs.score_block_fused(jnp.asarray(rawp), jnp.asarray(c["flip"]),
                                   j32, interpret=True)
    assert len(got) == len(want64) == 5
    for g, w64, w32 in zip(got, want64, want32):
        g = g.numpy()
        np.testing.assert_allclose(g, np.asarray(w64), rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(g, np.asarray(w32), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("test_type,ref_first,strict", [
    (0, False, False), (1, True, False), (2, False, True)])
def test_make_qt_block_fn_split_matches_jax(jfs, test_type, ref_first, strict):
    """The QT block function on split consts carried across (products
    through fused_bf16's plain version, folded and scored in float64)
    against the JAX package's use_pallas=False function on its float64
    consts of the folded split values: rtol 1e-9, atol 1e-9."""
    import jax.numpy as jnp

    c = _mk_case(11, n_complete=3 if strict else 1)
    jc = jfs.build_consts(*_args(c), split=True, nb=c["nb"], dtype=np.float64)
    rawp = jfs.pad_raw(c["raw"])
    want = jfs.make_qt_block_fn(_folded_jax(jc), False, test_type,
                                ref_first, strict=strict)(jnp.asarray(rawp))
    got = tfs.make_qt_block_fn(_carried(jc), True, test_type, ref_first,
                               strict=strict)(torch.from_numpy(rawp))
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("ref_first,strict", [(False, False), (True, False),
                                              (False, True)])
def test_make_qt_bgen_fn_split_matches_jax(jfs, ref_first, strict):
    """The QT BGEN block function on split consts with the narrow bf16 Wq,
    carried across, against the JAX package's use_pallas=False function
    (full width) on its float64 consts of the folded split values: rtol
    1e-9, atol 1e-9; the squared-dosage slice on the narrow operand's
    columns, the only ones it has."""
    import jax.numpy as jnp

    c = _mk_case(12, n_complete=3 if strict else 1)
    jc = jfs.build_consts(*_args(c), split=True, pack="sample", dtype=np.float64)
    jWq, _ = jfs.sample_pack(_tail(c), True)
    want = jfs.make_qt_bgen_fn(_folded_jax(jc), False, ref_first,
                               strict=strict)(jnp.asarray(c["planes"]))
    pc = _carried(jc, jWq)
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
    """|kernel - plain| <= BF16_FLUSH x 2^-23 x the same product against
    |W|: about the worst-case rounding of one float32 partial sum of
    BF16_FLUSH terms, relative to its terms' magnitudes."""
    rel = kernels.BF16_FLUSH * 2.0**-23
    for g, w, b in zip(got, want, bar):
        assert torch.all((g - w).abs() <= rel * b)


def _bf16(rng, shape, device):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
        device).to(torch.bfloat16)


@pytest.mark.cuda
def test_fused_bf16_kernel_matches_plain_on_cuda(cuda):
    """fused_bf16 against its plain version on the card, on ragged shapes
    (rows, bytes and columns off the kernel's 128 x 64 tiles and 32-byte
    stages: B = 1 and 129, nbp = 16, less than one stage, 48, one and a
    half, and 1040, one flush and 16 bytes; Cw 1152, 400, 200, 72 and 24)
    and a contraction of several flushes, within the flush bar; 0/1
    operands give exactly the plain integers; each call counts one
    launch."""
    rng = np.random.default_rng(11)
    for B, nbp, Cw in ((37, 272, 400), (130, 2064, 1152), (5, 16, 24),
                       (1, 16, 72), (129, 1040, 200), (128, 48, 64)):
        raw = torch.from_numpy(rng.integers(0, 256, (B, nbp), dtype=np.uint8)).to(cuda)
        wp = _bf16(rng, (4, nbp, Cw), cuda)
        n0 = kernels.fused_bf16_products.launches
        got = kernels.fused_bf16_products(raw, wp)
        assert kernels.fused_bf16_products.launches == n0 + 1
        want = kernels.fused_bf16_products_plain(raw, wp)
        bar = kernels.fused_bf16_products_plain(raw, wp.abs())
        torch.cuda.synchronize()
        assert all(g.dtype == torch.float64 for g in got)
        _assert_within_bar(got, want, bar)
        ones = (wp > 0).to(torch.bfloat16)
        for g, w in zip(kernels.fused_bf16_products(raw, ones),
                        kernels.fused_bf16_products_plain(raw, ones)):
            assert torch.equal(g, w)


@pytest.mark.cuda
def test_bgen_bf16_kernel_matches_plain_on_cuda(cuda):
    """bgen_bf16 against its plain version on the card, on ragged shapes
    (rows, samples and columns off the kernel's 128 x 64 tiles and
    64-sample stages: B = 1 and 129, Np = 16, less than one stage, and
    4112, one flush and 16 samples, Cw and Cq not multiples of 64; about
    half the byte pairs missing) and a contraction of several flushes,
    within the flush bar; 0/1 operands give exactly the plain integers;
    each call counts one launch."""
    rng = np.random.default_rng(12)
    for B, Np, Cw, Cq in ((37, 272, 400, 144), (130, 9232, 1152, 384),
                          (1, 16, 72, 8), (129, 4112, 200, 136),
                          (129, 80, 64, 56)):
        planes = torch.from_numpy(rng.integers(0, 256, (B, 2, Np), dtype=np.uint8)).to(cuda)
        wp, wq = _bf16(rng, (Np, Cw), cuda), _bf16(rng, (Np, Cq), cuda)
        n0 = kernels.bgen_bf16_products.launches
        got = kernels.bgen_bf16_products(planes, wp, wq)
        assert kernels.bgen_bf16_products.launches == n0 + 1
        want = kernels.bgen_bf16_products_plain(planes, wp, wq)
        bar = kernels.bgen_bf16_products_plain(planes, wp.abs(), wq.abs())
        torch.cuda.synchronize()
        _assert_within_bar(got, want, bar)
        ones = (wp > 0).to(torch.bfloat16), (wq > 0).to(torch.bfloat16)
        for g, w in zip(kernels.bgen_bf16_products(planes, *ones),
                        kernels.bgen_bf16_products_plain(planes, *ones)):
            assert torch.equal(g, w)
