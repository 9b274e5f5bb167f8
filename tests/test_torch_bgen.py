"""Tests of the port's BGEN slice (Step-2 QT on BGEN v1.2 8-bit dosages):
the sample-ordered operand, the six plane products, the QT block
function and the CLI, each against the JAX package on the CPU; the
faults that must raise; and, with marker `cuda`, the hand-written
bgen_i8 kernel against its plain version. On the GPU machine, which has
no JAX, run the card's tests with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_bgen.py
"""

import os
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch

from chip_smoke import write_bgen_dataset
from regenie_tpu_torch.ops import fused_score as tfs
from regenie_tpu_torch.ops import kernels

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def _mk_case(seed, B=32, N=517, P=3, K=4):
    """Random probability planes (4% missing, k0 + k1 <= 255 elsewhere)
    and per-sample inputs, as tests/test_fused_score.py:_mk_bgen_case
    builds them; planes padded to the operand's sample count."""
    rng = np.random.default_rng(seed)
    k0 = rng.integers(0, 200, size=(B, N)).astype(np.uint8)
    k1 = np.minimum(rng.integers(0, 200, size=(B, N)),
                    255 - k0.astype(np.int64)).astype(np.uint8)
    miss = rng.random(size=(B, N)) < 0.04
    k0 = np.where(miss, 255, k0).astype(np.uint8)
    k1 = np.where(miss, 255, k1).astype(np.uint8)
    ind = rng.random(N) > 0.1
    res = rng.normal(size=(N, P)) * ind[:, None]
    maskf = (rng.random(size=(N, P)) > 0.08) * ind[:, None].astype(np.float64)
    cov = np.linalg.qr(rng.normal(size=(N, K)) * ind[:, None])[0]
    Np = -(-N // 256) * 256
    planes = np.zeros((B, 2, Np), np.uint8)
    planes[:, 0, :N], planes[:, 1, :N] = k0, k1
    return dict(planes=planes, ind=ind, res=res, maskf=maskf, cov=cov,
                sden=float(ind.sum() - K), K=K, P=P)


def _wext(c):
    """[cov | res | maskf | ind], the operand of the interpret-mode test
    of tests/test_fused_score.py."""
    return np.concatenate([c["cov"], c["res"], c["maskf"],
                           c["ind"].astype(float)[:, None]], axis=1)


def _i8(op):
    return tfs.I8Operand(torch.from_numpy(np.array(op.limbs)),
                         torch.from_numpy(np.array(op.scale)))


@pytest.mark.parametrize("split", ["i8", False])
def test_sample_pack_matches_jax(jfs, split):
    """sample_pack: the same operand (limbs and scales, or values) and
    the same usum, taken from the quantized values for "i8"."""
    Wext = _wext(_mk_case(1))
    Wp, usum = tfs.sample_pack(Wext, split)
    jWp, jusum = jfs.sample_pack(Wext, split, dtype=np.float64)
    np.testing.assert_array_equal(usum, np.asarray(jusum))
    if split == "i8":
        assert Wp.limbs.shape == (768, 4 * 128)
        np.testing.assert_array_equal(_np(Wp.limbs), np.asarray(jWp.limbs))
        np.testing.assert_array_equal(_np(Wp.scale), np.asarray(jWp.scale))
    else:
        np.testing.assert_array_equal(_np(Wp), np.asarray(jWp))


@pytest.mark.parametrize("split", ["i8", False])
def test_build_consts_sample_matches_jax(jfs, split):
    """build_consts(pack="sample"): operand, usum, covt_res, Mmat and inc
    equal the JAX package's; consts_from_numpy carries the JAX package's
    Wp limbs and scales and its narrow Wq limbs and scales across."""
    c = _mk_case(2)
    args = (c["cov"], c["res"], c["maskf"], c["ind"], c["sden"])
    pc = tfs.build_consts(*args, split=split, pack="sample")
    jc = jfs.build_consts(*args, dtype=np.float64, split=split, pack="sample")
    tail = np.concatenate([c["maskf"], c["ind"].astype(float)[:, None]], axis=1)
    jWq, _ = jfs.sample_pack(tail, "i8")
    op = (dict(limbs=np.asarray(jc.Wp.limbs), scale=np.asarray(jc.Wp.scale))
          if split == "i8" else dict(Wp=np.asarray(jc.Wp)))
    carried = tfs.consts_from_numpy(
        **op, usum=np.asarray(jc.usum), covt_res=np.asarray(jc.covt_res),
        Mmat=np.asarray(jc.Mmat), n_ind=jc.n_ind, K=jc.K, P=jc.P,
        scale_denom=jc.scale_denom, split=jc.split, inc=jc.inc,
        wq_limbs=np.asarray(jWq.limbs), wq_scale=np.asarray(jWq.scale))
    np.testing.assert_array_equal(_np(carried.Wq.limbs), np.asarray(jWq.limbs))
    np.testing.assert_array_equal(_np(carried.Wq.scale), np.asarray(jWq.scale))
    for got in (pc, carried):
        assert got.inc == jc.inc and got.layout_C() == jc.layout_C()
        if split == "i8":
            np.testing.assert_array_equal(_np(got.Wp.limbs), np.asarray(jc.Wp.limbs))
            np.testing.assert_array_equal(_np(got.Wp.scale), np.asarray(jc.Wp.scale))
        else:
            np.testing.assert_array_equal(_np(got.Wp), np.asarray(jc.Wp))
        for name in ("usum", "covt_res", "Mmat"):
            np.testing.assert_array_equal(_np(getattr(got, name)),
                                          np.asarray(getattr(jc, name)))


def test_patch_res_columns_sample_layout_matches_jax(jfs):
    """The per-chromosome residual patch on the [Np, 4*Cp] sample layout:
    re-quantized limbs and scales equal the JAX package's."""
    c = _mk_case(3)
    jc = jfs.build_consts(c["cov"], c["res"], c["maskf"], c["ind"], c["sden"],
                          split="i8", pack="sample")
    K, P = jc.K, jc.P
    Np = jc.Wp.limbs.shape[0]
    res_pl = np.zeros((Np, P), np.float32)
    res_pl[: c["res"].shape[0]] = 0.3 * c["res"][:, ::-1]
    Cp = jc.Wp.scale.shape[0]
    want = jfs.patch_res_columns(jc.Wp, res_pl, K, P, Cp, "i8")
    got = tfs.patch_res_columns(_i8(jc.Wp), torch.from_numpy(res_pl), K, P, Cp)
    np.testing.assert_array_equal(got.limbs.numpy(), np.asarray(want.limbs))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))


def _np_products(planes, wp, wq):
    """numpy int64 oracle of the six plane products."""
    k0 = planes[:, 0].astype(np.int64)
    k1 = planes[:, 1].astype(np.int64)
    miss = (k0 + k1) > 255
    k0, k1 = np.where(miss, 0, k0), np.where(miss, 0, k1)
    d2 = (2 * k0 + k1) ** 2
    wp, wq = wp.astype(np.int64), wq.astype(np.int64)
    return (k0 @ wp, k1 @ wp, (d2 & 255) @ wq, ((d2 >> 8) & 255) @ wq,
            (d2 >> 16) @ wq, miss.astype(np.int64) @ wp)


def test_bgen_i8_products_plain_exact():
    """The kernel's plain version equals a numpy int64 oracle exactly, on
    extreme bytes (k0 = 255 where not missing) and limbs (-128) too; the
    wrapper takes it for CPU tensors (the K-major operands) and counts no
    launch."""
    rng = np.random.default_rng(4)
    planes = _mk_case(4, B=9, N=300)["planes"]
    planes[0, 0], planes[0, 1] = 255, 0
    wp = rng.integers(-128, 128, (planes.shape[2], 48), dtype=np.int8)
    wq = rng.integers(-128, 128, (planes.shape[2], 32), dtype=np.int8)
    wp[:, 0] = -128
    n0 = kernels.bgen_i8_products.launches
    got = kernels.bgen_i8_products(*(torch.from_numpy(np.ascontiguousarray(x))
                                     for x in (planes, wp.T, wq.T)))
    assert kernels.bgen_i8_products.launches == n0
    for g, w in zip(got, _np_products(planes, wp, wq)):
        assert g.dtype == torch.int64
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("source", ["sample_pack", "consts_wp", "consts_wq"])
def test_limbs_k_is_kmajor_copy(jfs, source):
    """A sample-packed I8Operand carries limbs_k, the contiguous K-major
    copy [4*Cp, Np] of its limbs [Np, 4*Cp], bit for bit: from
    sample_pack, and for Wp and Wq carried across by consts_from_numpy
    from the JAX package's build_consts(pack="sample") arrays."""
    c = _mk_case(11)
    if source == "sample_pack":
        op, _ = tfs.sample_pack(_wext(c), "i8")
        want = op.limbs.numpy()
    else:
        jc = jfs.build_consts(c["cov"], c["res"], c["maskf"], c["ind"],
                              c["sden"], dtype=np.float64, split="i8",
                              pack="sample")
        tail = np.concatenate([c["maskf"], c["ind"].astype(float)[:, None]], axis=1)
        jWq, _ = jfs.sample_pack(tail, "i8")
        carried = tfs.consts_from_numpy(
            limbs=np.asarray(jc.Wp.limbs), scale=np.asarray(jc.Wp.scale),
            usum=np.asarray(jc.usum), covt_res=np.asarray(jc.covt_res),
            Mmat=np.asarray(jc.Mmat), n_ind=jc.n_ind, K=jc.K, P=jc.P,
            scale_denom=jc.scale_denom, split=jc.split, inc=jc.inc,
            wq_limbs=np.asarray(jWq.limbs), wq_scale=np.asarray(jWq.scale))
        op, want = ((carried.Wp, np.asarray(jc.Wp.limbs)) if source == "consts_wp"
                    else (carried.Wq, np.asarray(jWq.limbs)))
    Np, C4 = want.shape
    assert op.limbs_k.dtype == torch.int8 and op.limbs_k.is_contiguous()
    assert tuple(op.limbs_k.shape) == (C4, Np)
    np.testing.assert_array_equal(op.limbs_k.numpy(), want.T)


@pytest.mark.parametrize("pack", ["sample", "plane"])
def test_patch_res_columns_limbs_k(jfs, pack):
    """The residual patch updates the K-major copy with the limbs: after
    patch_res_columns on a sample-packed operand, limbs_k equals the
    patched limbs.T (which equal the JAX package's patched limbs), and the
    input operand is unchanged; a plane-packed operand's limbs_k is the
    K-major copy [4*Cp, 4*nbp] of its limbs before and after."""
    c = _mk_case(12)
    args = (c["cov"], c["res"], c["maskf"], c["ind"], c["sden"])
    pc = tfs.build_consts(*args, split="i8", pack=pack)
    K, P, Cp = pc.K, pc.P, pc.Wp.scale.shape[0]
    shape = pc.Wp.limbs.shape[:-1] + (P,)
    res_pl = (0.3 * np.random.default_rng(12).normal(size=shape)).astype(np.float32)
    got = tfs.patch_res_columns(pc.Wp, torch.from_numpy(res_pl), K, P, Cp)
    if pack == "plane":
        for op in (pc.Wp, got):
            assert op.limbs_k.is_contiguous()
            np.testing.assert_array_equal(
                op.limbs_k.numpy(), op.limbs.numpy().reshape(-1, op.limbs.shape[-1]).T)
        assert not torch.equal(pc.Wp.limbs_k, got.limbs_k)
        return
    jc = jfs.build_consts(*args, dtype=np.float64, split="i8", pack="sample")
    want = jfs.patch_res_columns(jc.Wp, res_pl, K, P, Cp, "i8")
    np.testing.assert_array_equal(got.limbs.numpy(), np.asarray(want.limbs))
    assert got.limbs_k.is_contiguous()
    np.testing.assert_array_equal(got.limbs_k.numpy(), got.limbs.numpy().T)
    np.testing.assert_array_equal(pc.Wp.limbs_k.numpy(), pc.Wp.limbs.numpy().T)
    assert not torch.equal(pc.Wp.limbs_k, got.limbs_k)


@pytest.mark.parametrize("case", ["every_pair", "one_row", "off_tiles",
                                  "int32_overflow"])
def test_bgen_i8_products_plain_kmajor_exact(case):
    """bgen_i8_products_plain on K-major operands [C, Np] equals the numpy
    int64 oracle: on every byte pair (about half of them missing) at
    ragged widths (one row and one 16-sample stage; rows, samples and
    columns off the kernel's 128 x 128 tiles), and on extreme bytes (k0 =
    255) and limbs (-128) over more than two 65,536-sample chunks, whose
    sums overflow int32."""
    rng = np.random.default_rng(13)
    if case != "int32_overflow":
        B, Np, Cw, Cq = {"every_pair": (5, 272, 400, 144), "one_row": (1, 16, 16, 16),
                         "off_tiles": (129, 144, 144, 528)}[case]
        planes = rng.integers(0, 256, (B, 2, Np), dtype=np.uint8)
        wp_k = rng.integers(-128, 128, (Cw, Np), dtype=np.int8)
        wq_k = rng.integers(-128, 128, (Cq, Np), dtype=np.int8)
        wp_k[0] = wq_k[-1] = -128
    else:
        B, Np = 3, 2 * 65536 + 16
        planes = np.zeros((B, 2, Np), np.uint8)
        planes[:, 0] = 255
        wp_k = wq_k = np.full((16, Np), -128, np.int8)
    got = kernels.bgen_i8_products_plain(
        *(torch.from_numpy(x) for x in (planes, wp_k, wq_k)))
    want = _np_products(planes, wp_k.T, wq_k.T)
    for g, w in zip(got, want):
        assert g.dtype == torch.int64
        np.testing.assert_array_equal(g.numpy(), w)
    if case == "int32_overflow":
        assert int(got[0][0, 0]) == -128 * 255 * Np < -(2**31)
        assert int(got[4][0, 0]) == -128 * (510 * 510 >> 16) * Np


def test_bgen_fused_products_reads_limbs_k():
    """bgen_fused_products hands the kernel wrapper the operands' K-major
    copies: an operand whose limbs_k differs from limbs.T gives the
    products of limbs_k, and one built without limbs_k those of limbs."""
    c = _mk_case(15, B=6, N=300)
    op, _ = tfs.sample_pack(_wext(c), "i8")
    planes = torch.from_numpy(c["planes"])
    other = tfs.I8Operand(op.limbs, op.scale, op.limbs_k.flip(0).contiguous())
    want = tfs.bgen_fused_products(
        planes, tfs.I8Operand(other.limbs_k.T.contiguous(), op.scale))
    got = tfs.bgen_fused_products(planes, other)
    base = tfs.bgen_fused_products(planes, op)
    for g, w, b in zip(got, want, base):
        assert torch.equal(g, w) and not torch.equal(g, b)


@pytest.mark.parametrize("which", ["wp", "wq"])
def test_bgen_i8_rejects_np_by_c_operand(which):
    """An operand in the [Np, C] layout (the limbs, not their K-major
    copy) raises ValueError in the wrapper and in its plain version."""
    rng = np.random.default_rng(14)
    planes = torch.from_numpy(rng.integers(0, 256, (4, 2, 272), dtype=np.uint8))
    ops = {"wp": torch.zeros((48, 272), dtype=torch.int8),
           "wq": torch.zeros((32, 272), dtype=torch.int8)}
    ops[which] = ops[which].T.contiguous()
    for fn in (kernels.bgen_i8_products, kernels.bgen_i8_products_plain):
        with pytest.raises(ValueError, match="K-major"):
            fn(planes, ops["wp"], ops["wq"])


@pytest.mark.parametrize("operand", ["f64", "i8"])
def test_bgen_products_plain_matches_xla(jfs, operand):
    """bgen_fused_products_plain against the JAX package's
    bgen_fused_products_xla on the same planes (with missing samples):
    the float64 operand, and the JAX package's i8 limbs carried across
    (the JAX side gets their exact float64 values). rel 1e-12."""
    import jax.numpy as jnp

    c = _mk_case(5)
    Wext = _wext(c)
    if operand == "f64":
        jWp, _ = jfs.sample_pack(Wext, False, dtype=np.float64)
        Wp = torch.from_numpy(np.array(jWp))
    else:
        jWp8, _ = jfs.sample_pack(Wext, "i8")
        Wp = _i8(jWp8)
        jWp = tfs.i8_fold(Wp.limbs.to(torch.int64), Wp.scale,
                           torch.float64).numpy()
    got = tfs.bgen_fused_products_plain(torch.from_numpy(c["planes"]), Wp)
    want = jfs.bgen_fused_products_xla(jnp.asarray(c["planes"]), jnp.asarray(jWp))
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("narrow", [False, True])
def test_bgen_products_i8_match_pallas_interpret(jfs, narrow):
    """The int8 path (the kernel's plain version on the CPU, folded in
    float64) against the JAX package's Pallas kernel in interpret mode,
    with and without the narrow Wq / qs, at the tolerance of
    tests/test_fused_score.py:546-582 (the Pallas kernel sums in
    float32)."""
    import jax.numpy as jnp

    c = _mk_case(6, B=8, N=300)
    Wext = _wext(c)
    jWp8, _ = jfs.sample_pack(Wext, "i8")
    pj = jnp.asarray(c["planes"])
    kw = {}
    if narrow:
        qs = c["K"] + c["P"]
        jWq8, _ = jfs.sample_pack(Wext[:, qs:], "i8")
        kw = dict(qs=qs, C_used=Wext.shape[1])
        want = jfs.bgen_fused_products(pj, jWp8, jWq8, interpret=True, tb=8, **kw)
        got = tfs.bgen_fused_products(torch.from_numpy(c["planes"]), _i8(jWp8),
                                      _i8(jWq8), **kw)
        sl = slice(qs, Wext.shape[1])
        np.testing.assert_allclose(got[1][:, sl].numpy(), np.asarray(want[1])[:, sl],
                                   rtol=2e-5, atol=2e-3)
        assert not got[1][:, :qs].any()
    else:
        want = jfs.bgen_fused_products(pj, jWp8, interpret=True, tb=8)
        got = tfs.bgen_fused_products(torch.from_numpy(c["planes"]), _i8(jWp8))
    for i, (g, w) in enumerate(zip(got, want)):
        if narrow and i == 1:
            continue
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-5, atol=2e-3)


@pytest.mark.parametrize("ref_first,strict", [(False, False), (True, False),
                                              (False, True)])
def test_make_qt_bgen_fn_matches_jax(jfs, ref_first, strict):
    """The QT BGEN block function end to end at float64 (products,
    ref-first with its info-linear transform, epilogue, product slices),
    the port's consts carried over from the JAX package's: within rtol
    1e-9, atol 1e-9."""
    import jax.numpy as jnp

    c = _mk_case(7)
    maskf = np.repeat(c["ind"][:, None], c["P"], 1).astype(float) if strict \
        else c["maskf"]
    jc = jfs.build_consts(c["cov"], c["res"], maskf, c["ind"], c["sden"],
                          dtype=np.float64, pack="sample")
    want = jfs.make_qt_bgen_fn(jc, False, ref_first, strict=strict)(
        jnp.asarray(c["planes"]))
    pc = tfs.consts_from_numpy(
        Wp=np.asarray(jc.Wp), usum=np.asarray(jc.usum),
        covt_res=np.asarray(jc.covt_res), Mmat=np.asarray(jc.Mmat),
        n_ind=jc.n_ind, K=jc.K, P=jc.P, scale_denom=jc.scale_denom,
        inc=jc.inc)
    got = tfs.make_qt_bgen_fn(pc, True, ref_first, strict=strict)(
        torch.from_numpy(c["planes"]))
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-9, atol=1e-9)


def test_i8_off_selects_f32_operand(jfs, monkeypatch):
    """REGENIE_TPU_I8=0 selects the float operand, as the JAX package's
    split_mode does: float32 on CUDA (the fused_f32 / bgen_f32 kernels),
    float64 on the CPU, where the variable has no effect. Without it the
    card takes the int8 limbs; the plain products (no kernel) keep
    float64 on any device."""
    for env, on_gpu, split, dt in (("0", True, False, torch.float32),
                                   ("0", False, False, torch.float64),
                                   ("1", True, "i8", None),
                                   (None, True, "i8", None),
                                   (None, False, False, torch.float64)):
        if env is None:
            monkeypatch.delenv("REGENIE_TPU_I8", raising=False)
        else:
            monkeypatch.setenv("REGENIE_TPU_I8", env)
        assert tfs.split_mode(on_gpu) == split
        assert jfs.split_mode(on_gpu) == split
        if dt is not None:
            assert tfs.operand_dtype(split, on_gpu) == dt
        assert tfs.operand_dtype(split, on_gpu, use_kernel=False) == torch.float64


# ---------------------------------------------------------------------------
# the CLI against the JAX package
# ---------------------------------------------------------------------------


def _run(module, args, env_extra, cwd):
    env = dict(os.environ)
    env.update(env_extra)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-m", module] + args, cwd=cwd,
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    return r.stdout


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_bgen"))
    bgen = write_bgen_dataset(d, seed=11, N=600, chroms=((1, 200), (2, 100)),
                              P=3, n_inc=1, n_cov=3, na_rate=0.1, n_remove=5,
                              effect_sd=1.0)
    with open(f"{d}/keep.txt", "w") as fh:
        fh.write("".join(f"F{i} I{i}\n" for i in range(0, 600, 3)
                         if i % 7))
    # LOCO predictions from the JAX Step 1 on the same data
    _run("regenie_tpu", [
        "--step", "1", "--bgen", bgen, "--sample", f"{d}/geno.sample",
        "--phenoFile", f"{d}/pheno.txt", "--covarFile", f"{d}/covar.txt",
        "--bsize", "100", "--out", f"{d}/fit"],
        {"REGENIE_TPU_PLATFORM": "cpu"}, d)
    return d, bgen


@pytest.mark.parametrize("scenario", ["ignore_pred", "pred", "ref_first",
                                      "min_info", "min_mac", "keep_remove"])
def test_cli_bgen_matches_jax_fused(dataset, scenario, monkeypatch):
    """The port's CLI on the CPU against the JAX package's fused BGEN path
    on the CPU (both in this process): same header (INFO included), row
    count and NA pattern, every numeric field within rel 1e-9 (float64 on
    both sides)."""
    from regenie_tpu import cli as jcli
    from test_torch_step2 import _assert_rows_equiv

    from regenie_tpu_torch import cli
    from regenie_tpu_torch.utils.device import DEVICE_ENV

    d, bgen = dataset
    common = ["--step", "2", "--bgen", bgen, "--sample", f"{d}/geno.sample",
              "--phenoFile", f"{d}/pheno.txt", "--covarFile",
              f"{d}/covar.txt", "--bsize", "128"]
    extra = {"ignore_pred": ["--ignore-pred"],
             "pred": ["--pred", f"{d}/fit_pred.list"],
             "ref_first": ["--ignore-pred", "--ref-first"],
             "min_info": ["--ignore-pred", "--minINFO", "0.75"],
             "min_mac": ["--ignore-pred", "--minMAC", "25"],
             "keep_remove": ["--ignore-pred", "--keep", f"{d}/keep.txt",
                             "--remove", f"{d}/remove.txt"]}[scenario]
    jx, pt = f"{d}/jax_{scenario}", f"{d}/pt_{scenario}"
    monkeypatch.setenv("REGENIE_TPU_FUSED", "1")
    monkeypatch.setenv(DEVICE_ENV, "cpu")
    jcli.main(common + extra + ["--out", jx])
    assert "fused packed-bytes scorer active (QT/BGEN fast path)" in open(
        f"{jx}.log").read()
    cli.main(common + extra + ["--out", pt])
    assert "fused packed-bytes scorer on cpu (BGEN" in open(f"{pt}.log").read()
    identical = [_assert_rows_equiv(f"{jx}_{ph}.regenie", f"{pt}_{ph}.regenie")
                 for ph in ("Y1", "Y2", "Y3")]
    rows = open(f"{pt}_Y1.regenie").read().splitlines()
    assert rows[0].split()[6] == "INFO"
    n_rows = len(rows) - 1
    assert 100 < n_rows <= 300
    if scenario in ("min_info", "min_mac"):
        assert n_rows < 300  # the filter drops some variants
    print(f"{scenario}: byte-identical per trait = {identical}")


# ---------------------------------------------------------------------------
# faults raise; nothing falls back
# ---------------------------------------------------------------------------


def _tiny_bgen(d, bits=8, clip=False):
    """A 3-variant, 10-sample BGEN (zlib) with one missing sample; bits=16
    or clip=True (k0 + k1 > 255 on a present sample) make the second
    variant one the extractor rejects. Returns (path, sample path)."""
    N, ids = 10, [f"I{i}" for i in range(10)]
    lsi = 8 + sum(2 + len(s) for s in ids)
    path = os.path.join(d, "tiny.bgen")
    with open(path, "wb") as fh:
        fh.write(struct.pack("<IIII", 20 + lsi, 20, 3, N) + b"bgen")
        fh.write(struct.pack("<I", 1 | (2 << 2) | (1 << 31)))
        fh.write(struct.pack("<II", lsi, N)
                 + b"".join(struct.pack("<H", len(s)) + s.encode() for s in ids))
        for v in range(3):
            nbits = bits if v == 1 else 8
            probs = np.tile(np.array([200, 40], np.uint8), N)
            if clip and v == 1:
                probs[0:2] = (200, 100)
            if nbits == 16:
                probs = np.repeat(probs, 2)
            ploidy = bytes([2] * (N - 1) + [0x82])
            g = (struct.pack("<IHBB", N, 2, 2, 2) + ploidy + bytes([0, nbits])
                 + probs.tobytes())
            z = zlib.compress(g)
            rs = f"v{v}".encode()
            fh.write(struct.pack("<H", 2) + rs + struct.pack("<H", 2) + rs
                     + struct.pack("<H", 1) + b"1"
                     + struct.pack("<IH", 100 + v, 2)
                     + struct.pack("<I", 1) + b"A" + struct.pack("<I", 1) + b"C"
                     + struct.pack("<II", len(z) + 4, len(g)) + z)
    sample = os.path.join(d, "tiny.sample")
    with open(sample, "w") as fh:
        fh.write("ID_1 ID_2 missing\n0 0 0\n")
        fh.write("".join(f"F{i} I{i} 0\n" for i in range(N)))
    return path, sample


@pytest.mark.parametrize("fault", ["bits16", "clipped"])
def test_extractor_rejected_block_raises(tmp_path, fault):
    """A block the plane extractor rejects raises RuntimeError; the good
    variants extract to k0/k1 planes with the missing sample at
    255/255."""
    from regenie_tpu_torch.io.bgen import extract_planes_block, open_bgen

    path, _ = _tiny_bgen(str(tmp_path), bits=16 if fault == "bits16" else 8,
                         clip=fault == "clipped")
    bf = open_bgen(path)
    planes = extract_planes_block(bf, [0, 2])
    assert planes.shape == (2, 2, 10)
    assert (planes[:, 0, :9] == 200).all() and (planes[:, 1, :9] == 40).all()
    assert (planes[:, :, 9] == 255).all()
    with pytest.raises(RuntimeError, match="rejected 1 of 3 variants"):
        extract_planes_block(bf, [0, 1, 2])
    bf.close()


def test_cli_rejected_block_raises(tmp_path, monkeypatch):
    """Through the CLI, a rejected block stops the run with RuntimeError
    (the JAX package would switch to its dense decoder)."""
    from regenie_tpu_torch import cli
    from regenie_tpu_torch.utils.device import DEVICE_ENV

    monkeypatch.setenv(DEVICE_ENV, "cpu")
    path, sample = _tiny_bgen(str(tmp_path), bits=16)
    with open(tmp_path / "ph.txt", "w") as fh:
        fh.write("FID IID Y1 Y2\n" + "".join(
            f"F{i} I{i} {0.1 * i:.2f} {0.3 * (i % 4):.2f}\n" for i in range(10)))
    with pytest.raises(RuntimeError, match="BGEN plane extraction rejected"):
        cli.main(["--step", "2", "--bgen", path, "--sample", sample,
                  "--phenoFile", str(tmp_path / "ph.txt"), "--ignore-pred",
                  "--bsize", "2", "--out", str(tmp_path / "o")])


def test_missing_extractor_symbol_raises(monkeypatch):
    """A plane extractor library without its entry point raises
    RuntimeError, not a silent None."""
    from regenie_tpu_torch.io import native

    monkeypatch.setattr(native, "PLANES_SYMBOL", "no_such_symbol")
    monkeypatch.setitem(native._state, "planes", None)
    with pytest.raises(RuntimeError, match="has no symbol no_such_symbol"):
        native.planes_lib()


def test_bgi_index_matches_scan(tmp_path):
    """--bgi: variant metadata and genotype-block offsets read through the
    .bgi sqlite index equal those of the file scan, with and without
    --ref-first."""
    import sqlite3

    from regenie_tpu_torch.io.bgen import open_bgen

    path, _ = _tiny_bgen(str(tmp_path))
    for ref_first in (False, True):
        scan = open_bgen(path, ref_first=ref_first)
        with open(path, "rb") as fh:
            first = struct.unpack("<I", fh.read(4))[0] + 4
        starts = [first] + [v.geno_offset + v.geno_size for v in scan.variants[:-1]]
        bgi = str(tmp_path / f"tiny{int(ref_first)}.bgen.bgi")
        con = sqlite3.connect(bgi)
        con.execute("CREATE TABLE Variant (chromosome TEXT, position INT, rsid TEXT, "
                    "number_of_alleles INT, allele1 TEXT, allele2 TEXT, "
                    "file_start_position INT, size_in_bytes INT)")
        con.executemany("INSERT INTO Variant VALUES (?, ?, ?, ?, ?, ?, ?, ?)", [
            ("1", s.physpos, s.ID, 2, "A", "C", st, 0)
            for s, st in zip(scan.snps, starts)])
        con.commit()
        con.close()
        idx = open_bgen(path, ref_first=ref_first, bgi_file=bgi)
        assert idx.snps == scan.snps and idx.variants == scan.variants
        scan.close()
        idx.close()


def test_zstd_bgen_raises(tmp_path):
    """zstd-compressed BGEN (compression flag 2) is outside the port's
    zlib extractor: NotImplementedError before any block is read."""
    from regenie_tpu_torch.io.bgen import extract_planes_block, open_bgen

    path, _ = _tiny_bgen(str(tmp_path))
    with open(path, "r+b") as fh:
        fh.seek(20)
        fh.write(struct.pack("<I", 2 | (2 << 2) | (1 << 31)))
    bf = open_bgen(path)
    assert bf.compression == 2
    with pytest.raises(NotImplementedError, match="zlib-compressed layout-2"):
        extract_planes_block(bf, [0])
    bf.close()


# ---------------------------------------------------------------------------
# the kernel on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_bgen_i8_kernel_matches_plain_on_cuda(cuda):
    """The CUDA kernel against its plain version on the card, on K-major
    operands [C, Np]: ragged shapes (rows, samples and columns off the
    kernel's 128 x 128 tiles and 128-sample stages, one row, one 16-sample
    stage), a sample axis longer than one 65,536-sample int32 chunk, and
    extreme values (k0 = 255, limbs -128) whose sums overflow int32. The
    six products are equal, and each call counts one launch."""
    rng = np.random.default_rng(9)
    cases = ((37, 272, 400, 144), (130, 768, 1536, 512), (70, 65808, 144, 16),
             (1, 16, 16, 16), (129, 144, 144, 528), (200, 65680, 1552, 16))
    for B, Np, Cw, Cq in cases:
        k0 = rng.integers(0, 256, (B, Np))
        k1 = rng.integers(0, 256, (B, Np))  # about half the pairs missing
        planes = torch.from_numpy(np.stack([k0, k1], 1).astype(np.uint8)).to(cuda)
        wp = torch.from_numpy(rng.integers(-128, 128, (Cw, Np), dtype=np.int8)).to(cuda)
        wq = torch.from_numpy(rng.integers(-128, 128, (Cq, Np), dtype=np.int8)).to(cuda)
        n0 = kernels.bgen_i8_products.launches
        got = kernels.bgen_i8_products(planes, wp, wq)
        assert kernels.bgen_i8_products.launches == n0 + 1
        want = kernels.bgen_i8_products_plain(planes, wp, wq)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    B, Np = 3, 2 * 65536 + 16
    planes = torch.zeros((B, 2, Np), dtype=torch.uint8, device=cuda)
    planes[:, 0] = 255
    wp = torch.full((16, Np), -128, dtype=torch.int8, device=cuda)
    got = kernels.bgen_i8_products(planes, wp, wp)
    torch.cuda.synchronize()
    assert int(got[0][0, 0]) == -128 * 255 * Np
    assert int(got[4][0, 0]) == -128 * (510 * 510 >> 16) * Np
    # a float64 operand on the card has no kernel: it raises, and does not
    # fall back to the plain version
    with pytest.raises(TypeError, match="no kernel takes a torch.float64"):
        tfs.bgen_fused_products(planes, torch.zeros((Np, 128), dtype=torch.float64,
                                                    device=cuda))
