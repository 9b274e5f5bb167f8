"""Fused Step-2 QT scorer in PyTorch: packed 2-bit PLINK bytes -> score
statistics, with the genotype matrix never materialized (the port of
regenie_tpu/ops/fused_score.py, plane-packed hardcall half).

The kernel streams the raw packed bytes ([B, nbp] uint8), decodes each
2-bit plane on chip and accumulates three products against a combined
per-sample operand

    Wext = [cov (K) | res (P) | cov_k*maskf_p (K*nI) | maskf (P) | ind (1)]

(rows of excluded samples zeroed on the host; CM columns only for the
nI traits with missing phenotype values, `FusedConsts.inc`):

    S1[b, :] = sum_n  g0[b, n]      * Wext[n, :]   (missing coded as 0)
    SQ[b, :] = sum_n  g0[b, n]^2    * Wext[n, :]
    SM[b, :] = sum_n  miss[b, n]    * Wext[n, :]

Everything the score test needs is then a [B, C] epilogue: mean
imputation is the rank-1 update S1 + m_b*SM / SQ + m_b^2*SM, allele
flips are algebraic in the same products, and the covariate projection
follows the one-pass algebra of compute_score_qt (Step2_Models.cpp:343).

Operands keep the JAX package's layouts: the plane-packed [4, nbp, Cp]
float operand, the int8 limb operand [4, nbp, 4*Cp] ([l0|l1|l2|l3]) and
the bf16 split operand [4, nbp, 3*Cp] ([hi|mid|lo]), so the same
constants feed both packages. On CUDA the limb operand (the default) and
the float32 operand (REGENIE_TPU_I8=0) run through their hand-written
kernels (ops/kernels.py), which sum in float64; on the CPU the operand
is float64 and the products use the plain version. The bf16 split
operand, as in the JAX package, is built only by build_consts(split=True)
and taken by the block functions and score_block_fused; no CLI option
selects it.

BGEN v1.2 8-bit input takes the sample-ordered operand [Np, Cp]
(sample_pack) instead: the host ships the two probability byte planes
k0, k1 of each variant ([B, 2, Np] uint8; missing = 255/255) and six
products rebuild every dosage moment exactly (bgen_fused_products,
_bgen_combine):

    d*255 = 2*k0 + k1,  (d*255)^2 = 65536*h2 + 256*h1 + h0  (bytes of d2),
    info-linear 4*p0 + p1 = (4*k0 + k1)/255.

The squared-dosage products feed only the [maskf | ind] tail, so they
run against a narrow operand Wq (FusedConsts.Wq) of those columns.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from . import kernels

# byte-padding multiple of the plane-packed operand (matches the JAX
# package's layout; the CUDA kernel needs no particular multiple)
_TC = 256


class FusedConsts(NamedTuple):
    """Precomputed constants for the fused scorer (one per
    run/chromosome, shapes independent of the SNP block)."""

    # [4, nbp, Cp] / [Np, Cp] float tensor, the bf16 [hi|mid|lo] split
    # [4, nbp, 3*Cp] / [Np, 3*Cp], or an I8Operand
    Wp: object
    usum: torch.Tensor  # [Cp] column sums of ind-masked Wext (for flips)
    covt_res: torch.Tensor  # [K, P]
    Mmat: torch.Tensor  # [nI, K, K]
    n_ind: float  # number of included samples
    K: int
    P: int
    scale_denom: float  # n_analyzed - ncov
    split: bool = False  # True for the int8 limb or the bf16 split operand
    inc: tuple = None  # incomplete-trait indices (None = all P traits)
    has_male: bool = False  # chrX male tail columns (not built by the port)
    # BGEN: the narrow operand of [maskf | ind], an [Np, 4*Cqp] I8Operand,
    # a float32 [Np, Cqp] tensor or a bf16 split [Np, 3*Cqp] tensor
    Wq: object = None

    def n_inc(self) -> int:
        return self.P if self.inc is None else len(self.inc)

    def layout_C(self) -> int:
        """Used columns: [cov K | res P | CM K*n_inc | maskf P | ind
        | male | maskf*male P (chrX only)]."""
        c = self.K + self.P + self.K * self.n_inc() + self.P + 1
        if self.has_male:
            c += self.P + 1
        return c


class I8Operand(NamedTuple):
    """int8 fixed-point operand for the s8xs8->s32 fused kernel.

    limbs: [..., 4*Cp] int8 — each column quantized as
        w ~= scale * (l0 + l1/128 + l2/128^2 + l3/128^3)
    with a power-of-two per-column `scale` ([Cp] float32): ~28
    fixed-point bits relative to the column max, and EXACT int32
    accumulation in the kernel (one fold at the end).

    Overflow bound: |dot| <= N * 127 per limb needs N < 8.4M samples for
    int32 — asserted at build time.

    limbs_k: the K-major copy of the limbs, limbs.reshape(-1, 4*Cp).T
    made contiguous, which the kernels read: [4*Cp, Np] for a
    sample-packed operand (limbs [Np, 4*Cp]; bgen_i8), [4*Cp, 4*nbp]
    with column k = p*nbp + c for a plane-packed one (limbs [4, nbp,
    4*Cp]; fused_i8). Built once with the operand, on its device
    (plane_pack, sample_pack, consts_from_numpy, patch_res_columns), never
    per block. None for an operand built by hand (the products then read
    the transposed view of the limbs, which only the CPU's plain versions
    take)."""

    limbs: torch.Tensor  # int8, trailing dim 4*Cp: [l0 | l1 | l2 | l3]
    scale: torch.Tensor  # float32 [Cp] power-of-two column scales
    limbs_k: torch.Tensor = None  # int8 [4*Cp, Np] or [4*Cp, 4*nbp]


def _i8_operand(limbs, scale):
    """An I8Operand of limbs ([Np, 4*Cp] or [4, nbp, 4*Cp]) and scale [Cp]
    tensors, with its K-major copy."""
    return I8Operand(limbs, scale, limbs.reshape(-1, limbs.shape[-1]).T.contiguous())


_I8_FOLDW = (1.0, 2.0**-7, 2.0**-14, 2.0**-21)


def _i8_quantize_np(W):
    """Host quantization: f64 [..., Cp] -> (limbs int8 [..., 4*Cp],
    scale f32 [Cp], Wq f64 exact quantized values)."""
    absmax = np.abs(W).reshape(-1, W.shape[-1]).max(axis=0)
    e = np.ceil(np.log2(np.maximum(absmax, 1e-300) / 127.0))
    s = np.exp2(e)
    s[absmax == 0] = 1.0
    q = W / s
    limbs = []
    for _ in range(4):
        l = np.rint(q)
        limbs.append(l.astype(np.int8))
        q = (q - l) * 128.0
    Wq = s * sum(l.astype(np.float64) * w for l, w in zip(limbs, _I8_FOLDW))
    return np.concatenate(limbs, axis=-1), s.astype(np.float32), Wq


def _i8_quantize_torch(W, s=None):
    """Device-side quantization in float32 (per-chromosome residual
    patches); log2 is taken as log(x)/log(2) as jnp.log2 does, so both
    packages pick the same power-of-two scales."""
    W = W.to(torch.float32)
    if s is None:
        absmax = W.abs().reshape(-1, W.shape[-1]).amax(dim=0)
        ln2 = torch.log(torch.tensor(2.0, dtype=torch.float32, device=W.device))
        e = torch.ceil(torch.log(torch.clamp(absmax, min=1e-30) / 127.0) / ln2)
        s = torch.where(absmax == 0, torch.ones_like(absmax), torch.exp2(e))
    q = W / s
    limbs = []
    for _ in range(4):
        l = torch.round(q)  # half to even, as np.rint / jnp.rint
        limbs.append(l.to(torch.int8))
        q = (q - l) * 128.0
    return torch.cat(limbs, dim=-1), s


def i8_fold(parts, scale, dtype=torch.float32):
    """[..., 4*Cp] int32 limb products -> [..., Cp] values in `dtype`
    (float32 as the JAX package folds; float64 is exact for int32)."""
    Cp = parts.shape[-1] // 4
    out = torch.zeros(parts.shape[:-1] + (Cp,), dtype=dtype,
                      device=parts.device)
    for k, w in enumerate(_I8_FOLDW):
        out = out + parts[..., k * Cp : (k + 1) * Cp].to(dtype) * w
    return out * scale.to(dtype)


def split_mode(on_gpu):
    """Operand encoding, as the JAX package picks it per backend: int8
    limbs ("i8") on CUDA unless REGENIE_TPU_I8=0, which selects the float
    operand (False; float32 on CUDA, see operand_dtype); the float64
    operand (False) on the CPU, where REGENIE_TPU_I8 has no effect."""
    if not on_gpu:
        return False
    return False if os.environ.get("REGENIE_TPU_I8") == "0" else "i8"


def operand_dtype(split, on_gpu, use_kernel=True):
    """dtype of a float operand: float32 where a kernel takes it (CUDA,
    split False: the fused_f32 / bgen_f32 kernels, as the JAX package
    builds dtype=float32 on a TPU), else float64 (the CPU, and the
    plain products on any device). The constants stay float64."""
    if on_gpu and use_kernel and split is False:
        return torch.float32
    return torch.float64


def op_nbp(Wp):
    """Contraction length (packed bytes) of a fused operand."""
    return (Wp.limbs if isinstance(Wp, I8Operand) else Wp).shape[-2]


def bf16_split3(w):
    """float32 tensor -> (hi, mid, lo) bfloat16 tensors with hi + mid + lo
    ~= w to 24 significant bits: hi = bf16(w), mid = bf16(w - hi),
    lo = bf16(w - hi - mid), each rounded to nearest even and each
    difference taken in float32, as the JAX package's bf16_split3 does."""
    hi = w.to(torch.bfloat16)
    r1 = w - hi.to(torch.float32)
    mid = r1.to(torch.bfloat16)
    lo = (r1 - mid.to(torch.float32)).to(torch.bfloat16)
    return hi, mid, lo


def _split_operand(W, device):
    """float64 numpy operand [..., Cp] -> its bf16 [hi|mid|lo] split
    [..., 3*Cp] on `device` (rounded to float32 first, as the JAX package
    builds it)."""
    return torch.cat(bf16_split3(_to_dev(W.astype(np.float32), device)), dim=-1)


def fold3(x):
    """[..., 3*C] products against the [hi|mid|lo] thirds -> [..., C]:
    their sum, in x's dtype."""
    C = x.shape[-1] // 3
    return x[..., :C] + x[..., C : 2 * C] + x[..., 2 * C :]


def _plane_order(X, nb, nbp):
    """[N, C] -> [4, nbp, C] float64: plane p, byte c <- sample 4c + p."""
    N, C = X.shape
    out = np.zeros((4, nbp, C), dtype=np.float64)
    for p in range(4):
        src = 4 * np.arange(nb) + p
        valid = src < N
        out[p, np.nonzero(valid)[0]] = X[src[valid]]
    return out


def _to_dev(a, device, dtype=None):
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:  # torch tensors may not alias read-only memory
        a = a.copy()
    t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype or t.dtype)


def plane_pack(Wext, nb, split, device="cpu", dtype=torch.float64,
               nbp_tile=None):
    """[N, C] per-sample operand -> plane-ordered kernel operand.

    Returns (Wp, usum): Wp is the [4, nbp, Cp] tensor (dtype), the bf16
    [4, nbp, 3*Cp] hi|mid|lo split (split=True) or an I8Operand
    (split="i8"); usum is the padded [Cp] numpy column-sum vector used by
    the flip algebra (for "i8" it sums the QUANTIZED values so the flip
    transform stays exact in the quantized system; otherwise the float64
    Wext). Rows must already be zeroed for excluded samples. nbp_tile:
    byte padding multiple (default _TC)."""
    N, C = Wext.shape
    Cp = -(-C // 128) * 128
    tile = nbp_tile or _TC
    nbp = -(-nb // tile) * tile
    Wp = np.zeros((4, nbp, Cp), dtype=np.float64)
    Wp[..., :C] = _plane_order(Wext, nb, nbp)
    usum = np.pad(Wext.sum(axis=0), (0, Cp - C))
    if split == "i8":
        assert N < 8_000_000, "int8 fused path: int32 accumulator bound"
        limbs, s, Wq = _i8_quantize_np(Wp)
        usum = Wq.sum(axis=(0, 1))
        return _i8_operand(_to_dev(limbs, device), _to_dev(s, device)), usum
    if split:
        return _split_operand(Wp, device), usum
    return _to_dev(Wp, device, dtype), usum


def sample_pack(Wext, split, device="cpu", dtype=torch.float64):
    """[N, C] per-sample operand -> sample-ordered padded operand for the
    BGEN byte planes: the [Np, Cp] tensor (dtype), the bf16 [Np, 3*Cp]
    hi|mid|lo split (split=True), or an I8Operand with limbs [Np, 4*Cp]
    (split="i8"; with its K-major copy limbs_k [4*Cp, Np]), and the padded
    [Cp] numpy usum (for "i8" the sum of the QUANTIZED values, as
    plane_pack). Np pads to a multiple of _TC samples, Cp to 128
    columns."""
    N, C = Wext.shape
    Cp = -(-C // 128) * 128
    Np = -(-N // _TC) * _TC
    W = np.zeros((Np, Cp), dtype=np.float64)
    W[:N, :C] = Wext
    usum = np.pad(Wext.sum(axis=0), (0, Cp - C))
    if split == "i8":
        limbs, s, Wq = _i8_quantize_np(W)
        usum = Wq.sum(axis=0)
        return _i8_operand(_to_dev(limbs, device), _to_dev(s, device)), usum
    if split:
        return _split_operand(W, device), usum
    return _to_dev(W, device, dtype), usum


def plane_order_rows(X, nb, nbp_tile=None):
    """[N, C] -> plane-ordered [4, nbp, C] float64 (the row permutation
    used by plane_pack, without padding columns)."""
    tile = nbp_tile or _TC
    return _plane_order(X, nb, -(-nb // tile) * tile)


def patch_res_columns(Wp_dev, res_planes, K, P, Cp):
    """Per-chromosome operand update: overwrite the residual columns
    [K:K+P] of a plane- or sample-packed Wext with the new LOCO residuals
    — a device slice update instead of re-packing and re-uploading the
    operand. Returns a new operand; the input is left unchanged.

    Wp_dev: [4, nbp, Cp] or [Np, Cp] tensor, the bf16 split [4, nbp, 3*Cp]
    or [Np, 3*Cp], or I8Operand; res_planes: the matching [4, nbp, P] or
    [Np, P] tensor (float32 for the int8 operand, which is re-quantized on
    the device with fresh column scales; its K-major limbs_k gets them,
    read as [-1, P] and transposed, in rows [k*Cp+K, k*Cp+K+P) of each
    limb k). A bf16 split operand gets the hi, mid and lo parts of the
    float32 residuals in columns [K:K+P], [Cp+K:Cp+K+P] and
    [2Cp+K:2Cp+K+P], as the JAX package's split patch does
    (regenie_tpu/ops/fused_score.py:251-257). A float operand gets
    the residuals in full at its own dtype. On a TPU the JAX package does
    not: regenie_tpu/run_step2.py:1125-1128 passes split=True with its
    float32 operand, so its split patch writes only the bf16 high part of
    each residual and drops the other two parts outside the operand. The
    port chooses the branch by the operand's dtype, so that fault is not
    copied here (ROADMAP.md §3)."""
    if isinstance(Wp_dev, I8Operand):
        limbs, s = _i8_quantize_torch(res_planes)
        W = Wp_dev.limbs.clone()
        Wk = None if Wp_dev.limbs_k is None else Wp_dev.limbs_k.clone()
        for k in range(4):
            part = limbs[..., k * P : (k + 1) * P]
            W[..., k * Cp + K : k * Cp + K + P] = part
            if Wk is not None:  # the same slice update on the K-major copy
                Wk[k * Cp + K : k * Cp + K + P] = part.reshape(-1, P).T
        scale = Wp_dev.scale.clone()
        scale[K : K + P] = s
        return I8Operand(W, scale, Wk)
    W = Wp_dev.clone()
    if W.dtype == torch.bfloat16:
        parts = bf16_split3(res_planes.to(torch.float32))
        for k, part in enumerate(parts):
            W[..., k * Cp + K : k * Cp + K + P] = part
        return W
    W[..., K : K + P] = res_planes.to(W.dtype)
    return W


def build_consts(cov, res, maskf, ind, scale_denom, nb=None, device="cpu",
                 dtype=torch.float64, split=False, nbp_tile=None,
                 pack="plane", op_dtype=None):
    """Build FusedConsts from per-sample arrays (numpy, float64 in).
    The constants (usum, covt_res, Mmat) land in `dtype`, a float operand
    in `op_dtype` (default `dtype`); usum always sums the float64 Wext,
    as the JAX package does.

    cov: [N, K] orthonormal covariate basis (rows of excluded samples
    arbitrary — zeroed here); res: [N, P] phenotype residuals;
    maskf: [N, P] per-trait inclusion; ind: [N] bool sample inclusion;
    nb: number of packed bytes per SNP (defaults to ceil(N/4));
    pack: "plane" (PLINK bytes) or "sample" (BGEN byte planes).
    """
    cov = np.asarray(cov, np.float64)
    res = np.asarray(res, np.float64)
    maskf = np.asarray(maskf, np.float64)
    ind = np.asarray(ind)
    N, K = cov.shape
    P = res.shape[1]
    if nb is None:
        nb = (N + 3) // 4
    indf = ind.astype(np.float64)
    covz = cov * indf[:, None]
    resz = res * indf[:, None]
    maskz = maskf * indf[:, None]
    # CM interaction columns exist only for traits with MISSING phenotype
    # values: for a complete trait the masked Gram is the identity
    # (orthonormal cov) and denum collapses to g2m - ||A||^2
    inc = tuple(
        int(p) for p in range(P)
        if maskz[:, p].sum() < indf.sum() - 0.5
    )
    CM = (
        covz[:, :, None] * maskz[:, None, list(inc)]
    ).reshape(N, K * len(inc))
    Wext = np.concatenate([covz, resz, CM, maskz, indf[:, None]], axis=1)
    if pack == "plane":
        Wp_out, usum = plane_pack(Wext, nb, split, device, op_dtype or dtype,
                                  nbp_tile)
    else:
        Wp_out, usum = sample_pack(Wext, split, device, op_dtype or dtype)
    Mmat = np.einsum("nk,np,nl->pkl", covz, maskz[:, list(inc)], covz)
    covt_res = covz.T @ resz
    return FusedConsts(
        Wp=Wp_out,
        usum=_to_dev(usum, device, dtype),
        covt_res=_to_dev(covt_res, device, dtype),
        Mmat=_to_dev(Mmat, device, dtype),
        n_ind=float(indf.sum()),
        K=K,
        P=P,
        scale_denom=float(scale_denom),
        split=bool(split),
        inc=inc,
    )


def consts_from_numpy(Wp=None, limbs=None, scale=None, *, usum, covt_res,
                      Mmat, n_ind, K, P, scale_denom, split=False, inc=None,
                      has_male=False, wq=None, wq_limbs=None, wq_scale=None,
                      device="cpu", dtype=torch.float64):
    """FusedConsts from the JAX package's FusedConsts fields as numpy
    arrays: the float operand `Wp`, or `limbs` + `scale` for the int8
    operand, and for BGEN the narrow SQ operand (the JAX package's
    separate Wq), as the float array `wq` or as `wq_limbs` + `wq_scale`.
    The constants land in `dtype` on `device`; the float operands keep
    their dtypes (the JAX package's float32 on a TPU), the int8 limbs and
    their float32 scales theirs; the limbs (plane- or sample-packed, and
    `wq_limbs`) get their K-major copy limbs_k. A bf16 split operand
    (`Wp` or `wq`) comes as a 2-byte array holding the bfloat16 bits: the
    JAX array's numpy view (ml_dtypes.bfloat16) or that viewed as uint16;
    its bits carry across unchanged into a torch.bfloat16 tensor."""
    if (Wp is None) == (limbs is None):
        raise ValueError("give exactly one of Wp or limbs/scale")
    if wq is not None and wq_limbs is not None:
        raise ValueError("give at most one of wq or wq_limbs/wq_scale")

    def i8(lb, sc):
        return _i8_operand(_to_dev(lb, device, torch.int8),
                           _to_dev(sc, device, torch.float32))

    def float_op(a):
        a = np.asarray(a)
        if a.dtype.itemsize == 2 and a.dtype.kind in "uiV":
            # bfloat16 bits: numpy has no bfloat16, so go through int16
            return _to_dev(a.view(np.int16), device).view(torch.bfloat16)
        return _to_dev(a, device)

    op = i8(limbs, scale) if limbs is not None else float_op(Wp)
    if wq is not None:
        wq = float_op(wq)
    elif wq_limbs is not None:
        wq = i8(wq_limbs, wq_scale)
    return FusedConsts(
        Wp=op, usum=_to_dev(usum, device, dtype),
        covt_res=_to_dev(covt_res, device, dtype),
        Mmat=_to_dev(Mmat, device, dtype), n_ind=float(n_ind), K=int(K),
        P=int(P), scale_denom=float(scale_denom), split=bool(split),
        inc=None if inc is None else tuple(int(i) for i in inc),
        has_male=bool(has_male),
        Wq=wq,
    )


def fused_products(raw, Wp, dtype=torch.float32):
    """raw: [B, nbp] packed uint8 (zero-padded rows/cols); Wp: an
    I8Operand, a float32 [4, nbp, C] operand, the bf16 [4, nbp, 3*Cp]
    split, or on the CPU a float64 one. Returns (S1, SQ, SM) each [B, Cp]:
    from the int8 operand in `dtype`, from the float32 and the bf16
    operands in float64, else in the operand's dtype.

    The int8 operand goes through kernels.fused_i8_products on its K-major
    copy limbs_k (_kmajor), the float32 operand through
    kernels.fused_f32_products (exact products, float64 sums), the bf16
    split through kernels.fused_bf16_products (float64 products against
    each third, folded hi + mid + lo in float64) — each the CUDA kernel
    for a CUDA tensor, its plain version for a CPU tensor — and the class
    products fold as the JAX package does: S1 = 2H+E, SQ = 4H+E, SM = M. A
    float64 operand takes the plain products on the CPU and raises on
    CUDA, where no kernel takes it.
    Padding safety: pad bytes decode to code 0 (hom-alt), but the
    corresponding operand rows are zero, so padded samples contribute 0
    to every product."""
    if isinstance(Wp, I8Operand):
        H, E, M = kernels.fused_i8_products(raw, _kmajor(Wp))
        Hf, Ef, Mf = (i8_fold(x, Wp.scale, dtype) for x in (H, E, M))
        return 2.0 * Hf + Ef, 4.0 * Hf + Ef, Mf
    if Wp.dtype == torch.float32:
        H, E, M = kernels.fused_f32_products(raw, Wp)
        return 2.0 * H + E, 4.0 * H + E, M
    if Wp.dtype == torch.bfloat16:
        H, E, M = (fold3(x) for x in kernels.fused_bf16_products(raw, Wp))
        return 2.0 * H + E, 4.0 * H + E, M
    if raw.is_cuda:
        raise TypeError(
            f"fused_products: no kernel takes a {Wp.dtype} operand on CUDA "
            "(the card's float operand is float32); use_kernel=False takes "
            "the plain products")
    return fused_products_plain(raw, Wp)


def _decode_planes(raw):
    """[B, nbp] uint8 -> 4 per-plane [B, nbp] 2-bit code tensors."""
    r = raw.to(torch.int32)
    return [(r >> (2 * p)) & 3 for p in range(4)]


def fused_products_plain(raw, Wp, dtype=torch.float32):
    """Plain PyTorch version of fused_products (the counterpart of the
    JAX package's fused_products_xla): decode the planes to dosage g,
    g^2 and missing indicators in the operand's dtype and take three
    matmuls per plane. An I8Operand folds its limbs to the quantized
    values in `dtype` first, a bf16 split its thirds to their float64 sum
    (the JAX package folds them in float32)."""
    if isinstance(Wp, I8Operand):
        Wp = i8_fold(Wp.limbs.to(torch.int32), Wp.scale, dtype)
    elif Wp.dtype == torch.bfloat16:
        Wp = fold3(Wp.to(torch.float64))
    dt = Wp.dtype
    S1 = SQ = SM = 0.0
    for p, codes in enumerate(_decode_planes(raw)):
        # PLINK bed 2-bit codes: 0->hom alt (2), 1->missing, 2->het (1),
        # 3->hom ref (0)  (buildLookupTable semantics, Geno.cpp:2414)
        h = (codes == 0).to(dt)
        e = (codes == 2).to(dt)
        m = (codes == 1).to(dt)
        w = Wp[p]
        S1 = S1 + (2.0 * h + e) @ w
        SQ = SQ + (4.0 * h + e) @ w
        SM = SM + m @ w
    return S1, SQ, SM


def fused_epilogue(S1, SQ, SM, flip, usum, covt_res, Mmat, K, P, scale_denom,
                   n_ind, test_type=0, inc=None, strict=False):
    """[B, C] products -> (stats, denum, scale_fac, low, af_num) on the
    score_qt_block_onepass contract.

    Applies (1) mean imputation as a rank-1 update in product space,
    (2) minor-allele flip G -> 2*ind - G algebraically (ADD) or the
    DOM/REC recoding via the class-product identities, (3) the
    orthonormal-covariate projection identities. Traits NOT in `inc`
    (= complete phenotypes) have no CM columns: their denum is exactly
    g2m - ||A||^2; Mmat covers only the `inc` traits.
    flip: [B] bool. af_num: [B] imputed allele-count sum (for AF/MAC).
    """
    if inc is None:
        inc = tuple(range(P))
    nI = len(inc)
    C_used = K + P + K * nI + P + 1
    S1f, SQf = finalized_products(
        S1[:, :C_used], SQ[:, :C_used], SM[:, :C_used], flip,
        usum[:C_used], C_used - 1, n_ind, test_type,
    )
    icol = C_used - 1
    af_num = S1f[:, icol]

    A = S1f[:, :K]
    numY = S1f[:, K : K + P]
    g2m = SQf[:, K + P + K * nI : K + P + K * nI + P]
    g2 = SQf[:, icol]
    A2 = (A**2).sum(dim=1)
    scale2 = (g2 - A2) / scale_denom
    scale_fac = torch.sqrt(torch.clamp(scale2, min=0.0))
    low = scale_fac < 1e-8
    num_raw = numY - A @ covt_res
    denum_raw = g2m - A2[:, None]  # exact for complete traits
    if nI:
        idx = torch.tensor(inc, device=S1.device)
        T = S1f[:, K + P : K + P + K * nI].reshape(-1, K, nI)
        denum_inc = (
            g2m[:, idx]
            - 2.0 * torch.einsum("bk,bkp->bp", A, T)
            + torch.einsum("bk,pkl,bl->bp", A, Mmat, A)
        )
        denum_raw = denum_raw.clone()
        denum_raw[:, idx] = denum_inc
    denum_raw = torch.clamp(denum_raw, min=1e-30)
    if strict:
        # --strict (and single-pheno runs, Pheno.cpp:201): every trait
        # is complete on ind, so the reference shortcuts denum to the
        # CONSTANT n_analyzed - ncov (compute_score_qt strict branch,
        # Step2_Models.cpp:352)
        denum = torch.full_like(num_raw, scale_denom)
        sf_safe = torch.where(low, torch.ones_like(scale_fac), scale_fac)
        stats = num_raw / sf_safe[:, None] / torch.sqrt(
            torch.tensor(scale_denom, dtype=num_raw.dtype, device=num_raw.device))
        return stats, denum, scale_fac, low, af_num
    stats = num_raw / torch.sqrt(denum_raw)
    denum = denum_raw / torch.where(low, torch.ones_like(scale2), scale2)[:, None]
    return stats, denum, scale_fac, low, af_num


def ref_first_products(S1, SQ, SM, usum):
    """--ref-first: alleles are swapped at decode (G -> 2 - G on
    NONMISSING entries). In product space:
    S1' = 2*(usum - SM) - S1, SQ' = 4*(usum - SM) - 4*S1 + SQ."""
    nm = usum[None, :] - SM  # per-SNP nonmissing-included column sums
    return 2.0 * nm - S1, 4.0 * nm - 4.0 * S1 + SQ


def finalized_products(S1, SQ, SM, flip, usum, icol, n_ind, test_type=0):
    """Products of the TESTED genotype coding, from the raw ADD products.

    test_type 0 (ADD): mean-impute + optional minor-allele flip
    (impute_flip_products). 1 (DOM, G==2 -> 1) and 2 (REC, G>=1 -> G-1):
    the observed part is a linear combination of the class products
    H = (SQ-S1)/2 and E = 2*S1-SQ, and the imputed slots carry the
    transformed mean v (the recoding applies AFTER imputation, so v = m
    unless m==2 for DOM / v = m-1 if m>=1 for REC)."""
    if test_type == 0:
        return impute_flip_products(S1, SQ, SM, flip, usum, icol, n_ind)
    n_obs = n_ind - SM[:, icol]
    m_b = S1[:, icol] / torch.clamp(n_obs, min=1.0)
    H = (SQ - S1) / 2.0
    if test_type == 1:
        E = 2.0 * S1 - SQ
        v = torch.where(m_b == 2.0, torch.ones_like(m_b), m_b)
        base = H + E
    else:
        v = torch.where(m_b >= 1.0, m_b - 1.0, m_b)
        base = H
    S1f = base + v[:, None] * SM
    SQf = base + (v**2)[:, None] * SM
    return S1f, SQf


def impute_flip_products(S1, SQ, SM, flip, usum, icol, n_ind):
    """Mean imputation + minor-allele flip applied IN PRODUCT SPACE to
    the raw (missing-as-zero) products, for any Wext column layout
    (mean_impute_g + flip_geno semantics, Geno.cpp:1983-2072).

    S1/SQ/SM: [B, C]; flip: [B] bool; usum: [C] ind-masked column sums;
    icol: index of the `ind` column; n_ind: number of included samples.
    Returns (S1f, SQf)."""
    n_obs = n_ind - SM[:, icol]  # included & nonmissing per SNP
    m_b = S1[:, icol] / torch.clamp(n_obs, min=1.0)
    # imputation: G += m_b at missing slots; G^2 += m_b^2 there
    S1i = S1 + m_b[:, None] * SM
    SQi = SQ + (m_b**2)[:, None] * SM
    # flip: G' = 2*ind - G on included samples
    #   G'@w  = 2*u - G@w ;  G'^2@w = 4*u - 4*G@w + G^2@w
    f = flip[:, None].to(S1.dtype)
    S1f = (1.0 - f) * S1i + f * (2.0 * usum[None, :] - S1i)
    SQf = (1.0 - f) * SQi + f * (4.0 * usum[None, :] - 4.0 * S1i + SQi)
    return S1f, SQf


def make_qt_block_fn(consts: FusedConsts, use_kernel: bool = True,
                     test_type=0, ref_first=False, mesh=None, strict=False):
    """QT block function: products + epilogue + the raw-product slices
    the host needs for per-variant stats. Built once per chromosome.
    use_kernel=False takes the plain products on any device."""
    if mesh is not None:
        raise NotImplementedError(
            "mesh (multi-device) scoring is not yet ported to regenie_tpu_torch")
    prod = fused_products if use_kernel else fused_products_plain
    C_used = consts.layout_C()

    def run(raw):
        # an int8 operand folds its exact int32 products into the dtype
        # of the constants, so the epilogue runs in one dtype
        S1, SQ, SM = prod(raw, consts.Wp, consts.usum.dtype)
        S1c, SQc, SMc = S1[:, :C_used], SQ[:, :C_used], SM[:, :C_used]
        usum = consts.usum.to(S1c.dtype)
        if ref_first:
            S1c, SQc = ref_first_products(S1c, SQc, SMc, usum[:C_used])
        flip = torch.zeros(raw.shape[0], dtype=torch.bool, device=raw.device)
        stats, denum, scale_fac, low, _af = fused_epilogue(
            S1c, SQc, SMc, flip, usum, consts.covt_res.to(S1c.dtype),
            consts.Mmat.to(S1c.dtype), consts.K, consts.P,
            consts.scale_denom, consts.n_ind, test_type, consts.inc, strict,
        )
        return stats, denum, scale_fac, low, S1c, SQc, SMc

    return run


def score_block_fused(raw, flip, consts: FusedConsts, use_kernel=True):
    """End-to-end fused scorer for one packed block (the JAX package's
    score_block_fused, with use_kernel in place of use_pallas): products
    + epilogue with the minor-allele flip applied in product space.

    raw: [B, nbp] uint8 tensor (pad with pad_raw); flip: [B] bool tensor.
    Returns (stats, denum, scale_fac, low, af_num). use_kernel=False takes
    the plain products on any device."""
    prod = fused_products if use_kernel else fused_products_plain
    S1, SQ, SM = prod(raw, consts.Wp, consts.usum.dtype)
    dt = S1.dtype
    return fused_epilogue(
        S1, SQ, SM, flip, consts.usum.to(dt), consts.covt_res.to(dt),
        consts.Mmat.to(dt), consts.K, consts.P, consts.scale_denom,
        consts.n_ind, 0, consts.inc,
    )


def pad_raw(raw: np.ndarray, nbp: int | None = None) -> np.ndarray:
    """Zero-pad packed bytes to the operand's byte-tile multiple."""
    B, nb = raw.shape
    if nbp is None:
        nbp = -(-nb // _TC) * _TC
    if nbp == nb:
        return raw
    out = np.zeros((B, nbp), dtype=np.uint8)
    out[:, :nb] = raw
    return out


# ---------------------------------------------------------------------------
# BGEN v1.2 8-bit fused scorer (sample-ordered operand)
# ---------------------------------------------------------------------------


def _bgen_combine(outs, split=False):
    """(D0, D1, Q0, Q1, Q2, M) byte-plane products -> (S1, SQ, SM, IL):
    dosage, squared-dosage, missing and info-linear (4*p0 + p1)
    products of the raw (missing-as-zero) dosages. split: the products
    are against the [hi|mid|lo] thirds of a bf16 operand, folded first
    (in their own dtype, float64 here)."""
    if split:
        outs = [fold3(x) for x in outs]
    D0, D1, Q0, Q1, Q2, M = outs
    S1 = (2.0 * D0 + D1) / 255.0
    SQ = (65536.0 * Q2 + 256.0 * Q1 + Q0) / (255.0 * 255.0)
    IL = (4.0 * D0 + D1) / 255.0
    return S1, SQ, M, IL


def bgen_fused_products(planes, Wp, Wq=None, qs=0, C_used=None,
                        dtype=torch.float64):
    """planes: [B, 2, Np] uint8 (Np a multiple of _TC, pad samples zero);
    Wp: the sample_pack operand, an I8Operand, a float32 [Np, Cp] tensor
    or the bf16 [Np, 3*Cp] split (or on the CPU a float64 one); Wq: the
    narrow SQ-consumer operand of the same kind (sample_pack of
    Wext[:, qs:], given with qs and C_used), or None to use the full
    width. Returns (S1, SQ, SM, IL) each [B, Cp]; with a narrow Wq, SQ's
    columns outside [qs:C_used] are ZERO.

    The int8 operand goes through kernels.bgen_i8_products on its K-major
    limbs_k, whose exact int64 products fold into `dtype` (float64: exact
    for every limb product); the float32 operand through kernels.bgen_f32_products
    (exact products, float64 sums); the bf16 split through
    kernels.bgen_bf16_products (float64 products against each third,
    folded hi + mid + lo in float64) — each the CUDA kernel for CUDA
    tensors, its plain version for CPU tensors. A float64 operand takes
    the plain products (full width) on the CPU and raises on CUDA."""
    if not isinstance(Wp, I8Operand) \
            and Wp.dtype not in (torch.float32, torch.bfloat16):
        if planes.is_cuda:
            raise TypeError(
                f"bgen_fused_products: no kernel takes a {Wp.dtype} operand "
                "on CUDA (the card's float operands are float32 and bf16); "
                "use_kernel=False takes the plain products")
        return bgen_fused_products_plain(planes, Wp, dtype)
    if Wq is None:
        Wq, qs = Wp, 0
    split = not isinstance(Wp, I8Operand) and Wp.dtype == torch.bfloat16
    if isinstance(Wp, I8Operand):
        D0, D1, Q0, Q1, Q2, M = kernels.bgen_i8_products(
            planes, _kmajor(Wp), _kmajor(Wq))
        D0, D1, M = (i8_fold(x, Wp.scale, dtype) for x in (D0, D1, M))
        Q0, Q1, Q2 = (i8_fold(x, Wq.scale, dtype) for x in (Q0, Q1, Q2))
    elif split:
        D0, D1, Q0, Q1, Q2, M = kernels.bgen_bf16_products(planes, Wp, Wq)
    else:
        D0, D1, Q0, Q1, Q2, M = kernels.bgen_f32_products(planes, Wp, Wq)
    S1, SQn, SM, IL = _bgen_combine((D0, D1, Q0, Q1, Q2, M), split)
    if not qs:
        return S1, SQn, SM, IL
    # scatter the narrow SQ back onto the full column frame (the other
    # columns are never read downstream)
    nq = C_used - qs
    SQ = torch.zeros_like(S1)
    SQ[:, qs : qs + nq] = SQn[:, :nq]
    return S1, SQ, SM, IL


def _kmajor(op):
    """The K-major limbs of an I8Operand ([4*Cp, Np] sample-packed, [4*Cp,
    4*nbp] plane-packed): its limbs_k, or for an operand built without
    them the transposed view limbs.reshape(-1, 4*Cp).T, which the CPU's
    plain versions take and the kernels refuse (not contiguous)."""
    if op.limbs_k is not None:
        return op.limbs_k
    return op.limbs.reshape(-1, op.limbs.shape[-1]).T


def bgen_fused_products_plain(planes, Wp, dtype=torch.float64):
    """Plain PyTorch version of bgen_fused_products (the counterpart of
    the JAX package's bgen_fused_products_xla): decode the planes to the
    six byte indicators in the operand's dtype and take six matmuls
    against the full-width operand. An I8Operand folds its limbs to the
    quantized values in `dtype` first, a bf16 split its thirds to their
    float64 sum (the JAX package folds them in float32)."""
    if isinstance(Wp, I8Operand):
        Wp = i8_fold(Wp.limbs.to(torch.int32), Wp.scale, dtype)
    elif Wp.dtype == torch.bfloat16:
        Wp = fold3(Wp.to(torch.float64))
    step = kernels.PLAIN_CHUNK  # bounds the float planes at biobank N
    outs = [0.0] * 6
    for n0 in range(0, planes.shape[2], step):
        w = Wp[n0 : n0 + step]
        outs = [o + x.to(Wp.dtype) @ w for o, x in zip(
            outs, kernels.bgen_indicators(planes[:, :, n0 : n0 + step]))]
    return _bgen_combine(outs)


def _bgen_prepare(S1, SQ, SM, IL, usum, C_used, ref_first):
    """Slice + optional --ref-first transform of the BGEN raw products,
    including the info-linear column set: with ds' = 2 - ds and
    ph' = p2 (unclipped), 4*p2 + p1 = 4 - 4*p0 - 3*p1 on nonmissing, so
    IL' = 4*(u - SM) + IL - 4*S1 (from P0 = (IL - S1)/2, P1 = 2*S1 - IL
    given IL = 4*P0 + P1 and S1 = 2*P0 + P1)."""
    S1c, SQc, SMc, ILc = (
        S1[:, :C_used], SQ[:, :C_used], SM[:, :C_used], IL[:, :C_used])
    if ref_first:
        ILc = 4.0 * (usum[None, :] - SMc) + ILc - 4.0 * S1c
        S1c, SQc = ref_first_products(S1c, SQc, SMc, usum)
    return S1c, SQc, SMc, ILc


def make_qt_bgen_fn(consts: FusedConsts, use_kernel: bool = True,
                    ref_first=False, strict=False):
    """QT block function over BGEN probability byte planes: the QT score
    outputs plus the raw product slices and the info-linear products
    (for the INFO column). With the kernel, the squared-dosage products
    of an int8, float32 or bf16 split operand run against consts.Wq, the
    narrow
    [maskf | ind] operand, whose columns start at qs = C_used - (P + 1).
    use_kernel=False takes the plain products on any device."""
    C_used = consts.layout_C()
    Wq = consts.Wq if use_kernel else None
    qs = C_used - (consts.P + 1) if Wq is not None else 0

    def run(planes):
        dt = consts.usum.dtype
        if use_kernel:
            S1, SQ, SM, IL = bgen_fused_products(planes, consts.Wp, Wq, qs,
                                                 C_used, dt)
        else:
            S1, SQ, SM, IL = bgen_fused_products_plain(planes, consts.Wp, dt)
        usum = consts.usum.to(S1.dtype)
        S1c, SQc, SMc, ILc = _bgen_prepare(S1, SQ, SM, IL, usum[:C_used],
                                           C_used, ref_first)
        flip = torch.zeros(planes.shape[0], dtype=torch.bool,
                           device=planes.device)
        stats, denum, scale_fac, low, _af = fused_epilogue(
            S1c, SQc, SMc, flip, usum, consts.covt_res.to(S1c.dtype),
            consts.Mmat.to(S1c.dtype), consts.K, consts.P,
            consts.scale_denom, consts.n_ind, 0, consts.inc, strict,
        )
        return stats, denum, scale_fac, low, S1c, SQc, SMc, ILc

    return run
