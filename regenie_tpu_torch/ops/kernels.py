"""Hand-written CUDA kernels of the port, their build, their wrappers and
their plain PyTorch versions.

Kernels (sources under ops/csrc/, one shared library each):

- fused_i8 (csrc/fused_i8.cu): the int8 fused Step-2 products, replacing
  the Pallas kernel regenie_tpu/ops/fused_score.py:403 _fused_kernel_i8.
- bgen_i8 (csrc/bgen_i8.cu): the six BGEN 8-bit dosage products, replacing
  the Pallas kernel regenie_tpu/ops/fused_score.py:1093 _bgen_kernel_i8.
- fused_f32 (csrc/fused_f32.cu): the fused Step-2 products against the
  float32 operand, summed in float64, replacing the Pallas kernel
  regenie_tpu/ops/fused_score.py:331 _fused_kernel.
- bgen_f32 (csrc/bgen_f32.cu): the six BGEN products against the float32
  operands, summed in float64, replacing the Pallas kernel
  regenie_tpu/ops/fused_score.py:1054 _bgen_kernel_split (f32 operand).
- fused_bf16 (csrc/fused_bf16.cu): the class-indicator products against
  the bf16 hi|mid|lo split operand, float32 sums of BF16_FLUSH terms
  added into float64, replacing the Pallas kernel
  regenie_tpu/ops/fused_score.py:364 _fused_kernel_split.
- bgen_bf16 (csrc/bgen_bf16.cu): the six BGEN products against the bf16
  split operands, summed the same way, replacing the Pallas kernel
  regenie_tpu/ops/fused_score.py:1054 _bgen_kernel_split (bf16 operand).
- decode_planes (csrc/decode_planes.cu): PLINK 2-bit bytes to plane-ordered
  float32 genotypes, replacing the Pallas kernel
  regenie_tpu/ops/pallas_ops.py:27 _decode_kernel.
- profile_fused (csrc/profile_fused.cu, five entry points): the profiling
  variants of fused_bf16 that scripts/profile_fused.py runs on a TPU
  (_stacked_kernel, also without the M product, _nodecode_kernel,
  _decode_only_kernel, _pipelined_kernel), reached through
  regenie_tpu_torch.scripts.profile_fused.
- profile_bgen (csrc/profile_bgen.cu, one entry point, seven variants):
  the profiling variants of bgen_i8 that scripts/profile_bgen.py runs on a
  TPU (kern_base / kern_sep, kern_noq / kern_sep_noq, kern_u8,
  kern_sep_merge, make_base(.., 3 / 2 / 4)), reached through
  regenie_tpu_torch.scripts.profile_bgen.

Build: `nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
-Xcompiler -fPIC` into regenie_tpu_torch/_build/ (git-ignored), at first
use or by build_all(), which starts one nvcc per source at once. The
libraries have plain C entry points and are loaded with ctypes; nothing
here imports or builds anything when the module is imported.

A wrapper launches its kernel for CUDA tensors (or raises) and uses the
kernel's plain version only for CPU tensors. Each wrapper counts its
launches in a plain integer attribute, `<wrapper>.launches`. The plain
versions of the float32- and bf16-operand kernels widen the operand and
sum in float64; the float32 kernels sum in float64 too, the bf16 kernels
sum BF16_FLUSH terms at a time in float32 and add those sums in float64.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
SOURCES = {"fused_i8": "fused_i8.cu", "bgen_i8": "bgen_i8.cu",
           "fused_f32": "fused_f32.cu", "bgen_f32": "bgen_f32.cu",
           "fused_bf16": "fused_bf16.cu", "bgen_bf16": "bgen_bf16.cu",
           "decode_planes": "decode_planes.cu",
           "profile_fused": "profile_fused.cu", "profile_bgen": "profile_bgen.cu"}
# the entry points `<entry>_launch` of a library with more than one (the
# others have one, `<name>_launch`)
ENTRIES = {"profile_fused": ("profile_fused_stacked", "profile_fused_stacked2",
                             "profile_fused_nodecode", "profile_fused_decode_only",
                             "profile_fused_pipelined")}
_LIB_OF = {e: name for name, entries in ENTRIES.items() for e in entries}
# argument types of each library's entry points
_FUSED_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 3 + [ctypes.c_void_p]
_BGEN_ARGS = [ctypes.c_void_p] * 9 + [ctypes.c_longlong] * 4 + [ctypes.c_void_p]
_ARGTYPES = {
    "fused_i8": _FUSED_ARGS, "bgen_i8": _BGEN_ARGS,
    "fused_f32": _FUSED_ARGS, "bgen_f32": _BGEN_ARGS,
    "fused_bf16": _FUSED_ARGS, "bgen_bf16": _BGEN_ARGS,
    "decode_planes": [ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 2
    + [ctypes.c_void_p],
    # _FUSED_ARGS with the configuration index before the stream
    "profile_fused": [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 4
    + [ctypes.c_void_p],
    # k0, k1, wp, wq, six outputs; row stride, B, Np, Cw, Cq, variant,
    # config; stream
    "profile_bgen": [ctypes.c_void_p] * 10 + [ctypes.c_longlong] * 7
    + [ctypes.c_void_p],
}
# terms per float32 partial sum of the bf16 kernels (csrc/fused_bf16.cu,
# csrc/bgen_bf16.cu: FLUSH), added into float64 after each; such a sum
# rounds by at most about BF16_FLUSH x 2^-23 of its terms' magnitudes (the
# tensor cores' own accumulation does not round to nearest)
BF16_FLUSH = 4096
_libs = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.isfile(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build on a "
                           "machine with the CUDA toolkit")
    return found


def _lib_path(name: str) -> str:
    with open(os.path.join(_CSRC, SOURCES[name]), "rb") as fh:
        tag = hashlib.sha256(fh.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"lib{name}_{tag}.so")


def build_all(names=None) -> dict:
    """Compile the named kernels (default: all) that are not built yet,
    one nvcc process per source, all started together. Returns
    {name: (seconds, ptxas report)} for the kernels compiled here."""
    names = list(SOURCES) if names is None else list(names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if os.path.isfile(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-o", tmp, os.path.join(_CSRC, SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.time())
    report = {}
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {SOURCES[name]}:\n{log}")
        os.replace(tmp, out)
        report[name] = (time.time() - t0, log)
    return report


def _lib(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(_lib_path(name))
        for entry in ENTRIES.get(name, (name,)):
            fn = getattr(lib, f"{entry}_launch")
            fn.restype = ctypes.c_int
            fn.argtypes = _ARGTYPES[name]
        _libs[name] = lib
    return lib


# samples (bytes) per chunk of the plain versions' float64 products on
# CUDA (one [2048, 400,128] float64 plane would take 6.6 GB)
PLAIN_CHUNK = 32768


def _chunk(n, device):
    return n if device.type == "cpu" else PLAIN_CHUNK


def _check_cuda_inputs(name, tensors, dtypes, col_mult):
    """The checks every wrapper makes before a launch: one CUDA device,
    the kernel's dtypes, contiguous, 16-byte aligned, and the last axis of
    each operand (tensors[1:]) a multiple of col_mult (16-byte loads)."""
    if len({t.device for t in tensors}) != 1 or not tensors[0].is_cuda:
        raise ValueError(f"{name}: inputs must be on the same CUDA device "
                         "(or all on the CPU)")
    if tuple(t.dtype for t in tensors) != dtypes:
        raise TypeError(f"{name}: input dtypes must be "
                        f"{', '.join(str(d) for d in dtypes)}, got "
                        f"{', '.join(str(t.dtype) for t in tensors)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: inputs must be 16-byte aligned")
    if any(t.shape[-1] % col_mult for t in tensors[1:]):
        raise ValueError(f"{name}: operand widths must be multiples of "
                         f"{col_mult}")


def _launch(name, device, *args):
    """Call the entry point `<name>_launch` of its kernel library on the
    current stream of `device`; raise if the launch failed."""
    lib = _lib(_LIB_OF.get(name, name))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, f"{name}_launch")(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


# ---------------------------------------------------------------------------
# PLINK bytes: fused_i8 (int8 limbs) and fused_f32 (float32 operand)
# ---------------------------------------------------------------------------


def _decode_indicators(raw):
    """[B, nbp] uint8 -> per plane p the (hom-alt, het, missing) boolean
    [B, nbp] masks of code_p = (raw >> 2p) & 3 == 0 / 2 / 1."""
    r = raw.to(torch.int32)
    out = []
    for p in range(4):
        codes = (r >> (2 * p)) & 3
        out.append((codes == 0, codes == 2, codes == 1))
    return out


def _fused_plain(raw, w, dt, ncls=3):
    """The three class-indicator products of raw [B, nbp] against
    w [4, nbp, C] as matmuls in dtype dt, chunked over bytes on CUDA; with
    ncls=2 the third (M) is left 0."""
    B, nbp = raw.shape
    acc = [torch.zeros((B, w.shape[-1]), dtype=dt, device=raw.device)
           for _ in range(3)]
    step = _chunk(nbp, raw.device)
    for c0 in range(0, nbp, step):
        for p, masks in enumerate(_decode_indicators(raw[:, c0 : c0 + step])):
            wp = w[p, c0 : c0 + step].to(dt)
            for a, ind in zip(acc[:ncls], masks):
                a += ind.to(dt) @ wp
    return acc


def _fused_call(name, raw, w, wdtype, odtype, col_mult, *extra):
    """Check raw [B, nbp] uint8 and w [4, nbp, C] and launch the fused
    kernel `name` (with the arguments `extra` after the shapes) into three
    new [B, C] outputs of dtype odtype."""
    _check_cuda_inputs(name, (raw, w), (torch.uint8, wdtype), col_mult)
    if raw.dim() != 2 or w.dim() != 3 or w.shape[0] != 4:
        raise ValueError(f"{name}: raw [B, nbp], operand [4, nbp, C]")
    B, nbp = raw.shape
    if w.shape[1] != nbp or nbp % 16:
        raise ValueError(f"{name}: raw has {nbp} bytes per row, the operand "
                         f"{w.shape[1]}; both a multiple of 16")
    outs = tuple(torch.empty((B, w.shape[2]), dtype=odtype, device=raw.device)
                 for _ in range(3))
    if B:
        _launch(name, raw.device, raw.data_ptr(), w.data_ptr(),
                *(o.data_ptr() for o in outs), B, nbp, w.shape[2], *extra)
    return outs


def fused_i8_products_plain(raw, limbs):
    """Plain version of the fused_i8 kernel: H, E, M [B, Cw4] int32 with
    H[b, j] = sum_p sum_c [code_p(raw[b, c]) == 0] * limbs[p, c, j] (E:
    code 2, M: code 1). Integer (int64) matmuls on the CPU; float64 on
    CUDA, exact there because every partial sum is an integer below
    2^53."""
    dt = torch.int64 if raw.device.type == "cpu" else torch.float64
    return tuple(a.to(torch.int32) for a in _fused_plain(raw, limbs, dt))


def fused_i8_products(raw, limbs):
    """raw [B, nbp] uint8, limbs [4, nbp, Cw4] int8 -> (H, E, M), each
    [B, Cw4] int32 (see fused_i8_products_plain). CUDA tensors launch
    the csrc/fused_i8.cu kernel on the current stream; CPU tensors take
    the plain version."""
    if raw.device.type == "cpu" and limbs.device.type == "cpu":
        return fused_i8_products_plain(raw, limbs)
    if 4 * raw.shape[-1] >= 8_000_000:
        raise ValueError("fused_i8_products: int32 accumulator bound "
                         "(N < 8,000,000 samples)")
    outs = _fused_call("fused_i8", raw, limbs, torch.int8, torch.int32, 16)
    if raw.shape[0]:
        fused_i8_products.launches += 1
    return outs


fused_i8_products.launches = 0


def fused_f32_products_plain(raw, wp):
    """Plain version of the fused_f32 kernel: for raw [B, nbp] uint8 and
    wp [4, nbp, Cp] float32, H, E, M [B, Cp] float64 with H[b, j] =
    sum_p sum_c [code_p(raw[b, c]) == 0] * wp[p, c, j] (E: code 2, M: code
    1). The operand is widened to float64 and the products are float64
    matmuls, chunked over bytes by PLAIN_CHUNK on CUDA."""
    return tuple(_fused_plain(raw, wp, torch.float64))


def fused_f32_products(raw, wp):
    """raw [B, nbp] uint8, wp [4, nbp, Cp] float32 -> (H, E, M), each
    [B, Cp] float64 (see fused_f32_products_plain). CUDA tensors launch
    the csrc/fused_f32.cu kernel on the current stream; CPU tensors take
    the plain version."""
    if raw.device.type == "cpu" and wp.device.type == "cpu":
        return fused_f32_products_plain(raw, wp)
    if 4 * raw.shape[-1] >= 2**31:
        raise ValueError("fused_f32_products: 4*nbp must be below 2^31")
    outs = _fused_call("fused_f32", raw, wp, torch.float32, torch.float64, 4)
    if raw.shape[0]:
        fused_f32_products.launches += 1
    return outs


fused_f32_products.launches = 0


def fused_bf16_products_plain(raw, wp):
    """Plain version of the fused_bf16 kernel: for raw [B, nbp] uint8 and
    the bf16 split operand wp [4, nbp, Cw] (Cw = 3*Cp, [hi|mid|lo]), H, E,
    M [B, Cw] float64 with H[b, j] = sum_p sum_c [code_p(raw[b, c]) == 0]
    * wp[p, c, j] (E: code 2, M: code 1), against each third separately.
    The operand is widened to float64 (exactly) and the products are
    float64 matmuls, chunked over bytes by PLAIN_CHUNK on CUDA."""
    return tuple(_fused_plain(raw, wp, torch.float64))


def fused_bf16_products(raw, wp):
    """raw [B, nbp] uint8, wp [4, nbp, Cw] bfloat16 -> (H, E, M), each
    [B, Cw] float64 (see fused_bf16_products_plain; the kernel sums
    BF16_FLUSH terms at a time in float32). CUDA tensors launch the
    csrc/fused_bf16.cu kernel on the current stream; CPU tensors take the
    plain version."""
    if raw.device.type == "cpu" and wp.device.type == "cpu":
        return fused_bf16_products_plain(raw, wp)
    if 4 * raw.shape[-1] >= 2**31:
        raise ValueError("fused_bf16_products: 4*nbp must be below 2^31")
    outs = _fused_call("fused_bf16", raw, wp, torch.bfloat16, torch.float64, 8)
    if raw.shape[0]:
        fused_bf16_products.launches += 1
    return outs


fused_bf16_products.launches = 0


# ---------------------------------------------------------------------------
# BGEN byte planes: bgen_i8 (int8 limbs) and bgen_f32 (float32 operands)
# ---------------------------------------------------------------------------


def _bgen_multiplicands(k0, k1):
    """[B, n] uint8 probability bytes k0, k1 -> int32 k0, k1 and miss (0/1):
    miss = k0 + k1 > 255, and k0 = k1 = 0 there."""
    k0 = k0.to(torch.int32)
    k1 = k1.to(torch.int32)
    miss = (k0 + k1) > 255
    return torch.where(miss, 0, k0), torch.where(miss, 0, k1), miss.to(torch.int32)


def _q_multiplicands(k0, k1, q="q3"):
    """The multiplicands of the products against the narrow operand, one
    per output, of the masked int32 k0, k1, with d = 2 k0 + k1: "q3" the
    bytes 0, 1, 2 of d^2; "e2" the bytes 0, 1 of (d - 255)^2; "dhl" the
    bytes 0, 1 of dlo^2 and dhi * dlo + dhi (dlo = d & 255, dhi = d >> 8:
    two products that go to one output); "noq" none."""
    d = 2 * k0 + k1
    if q == "q3":
        d2 = d * d
        return [d2 & 255, (d2 >> 8) & 255, d2 >> 16]
    if q == "e2":
        e2 = (d - 255) ** 2
        return [e2 & 255, e2 >> 8]
    if q == "dhl":
        dlo, dhi = d & 255, d >> 8
        dl2 = dlo * dlo
        return [dl2 & 255, dl2 >> 8, dhi * dlo + dhi]
    return []


def bgen_indicators(planes):
    """[B, 2, n] uint8 probability planes -> the six [B, n] int32
    multiplicands of the BGEN products, (k0, k1, h0, h1, h2, miss): miss
    = k0 + k1 > 255, k0 = k1 = 0 there, and h0, h1, h2 the bytes 0, 1, 2
    of d2 = (2 k0 + k1)^2."""
    k0, k1, miss = _bgen_multiplicands(planes[:, 0], planes[:, 1])
    return (k0, k1, *_q_multiplicands(k0, k1), miss)


def _bgen_plain(k0, k1, wp, wq, dt, q="q3"):
    """The byte-plane products of k0, k1 [B, Np] uint8 as matmuls in dtype
    dt, chunked over samples on CUDA: (k0, k1, miss) @ wp, then the
    multiplicands of _q_multiplicands(.., q) @ wq, in that order."""
    Np = k0.shape[1]
    step = _chunk(Np, k0.device)
    acc = None
    for n0 in range(0, max(Np, 1), step):
        a, b, miss = _bgen_multiplicands(k0[:, n0 : n0 + step], k1[:, n0 : n0 + step])
        w = wp[n0 : n0 + step].to(dt)
        v = wq[n0 : n0 + step].to(dt)
        terms = [x.to(dt) @ w for x in (a, b, miss)] + [
            x.to(dt) @ v for x in _q_multiplicands(a, b, q)]
        acc = terms if acc is None else [s + t for s, t in zip(acc, terms)]
    return acc


def _bgen_order(planes, wp, wq, dt):
    """_bgen_plain of planes [B, 2, Np] in the BGEN kernels' order (D0, D1,
    Q0, Q1, Q2, M)."""
    D0, D1, M, Q0, Q1, Q2 = _bgen_plain(planes[:, 0], planes[:, 1], wp, wq, dt)
    return D0, D1, Q0, Q1, Q2, M


def _bgen_call(name, planes, wp, wq, wdtype, odtype, col_mult):
    """Check planes [B, 2, Np] uint8, wp [Np, Cw] and wq [Np, Cq] and
    launch the BGEN kernel `name` into new outputs of dtype odtype,
    returned as (D0, D1, Q0, Q1, Q2, M)."""
    _check_cuda_inputs(name, (planes, wp, wq), (torch.uint8, wdtype, wdtype),
                       col_mult)
    if planes.dim() != 3 or planes.shape[1] != 2 or wp.dim() != 2 \
            or wq.dim() != 2:
        raise ValueError(f"{name}: planes [B, 2, Np], wp [Np, Cw], wq [Np, Cq]")
    B, _, Np = planes.shape
    Cw, Cq = wp.shape[1], wq.shape[1]
    if wp.shape[0] != Np or wq.shape[0] != Np or Np == 0 or Np % 16:
        raise ValueError(f"{name}: planes have {Np} samples, wp {wp.shape[0]}, "
                         f"wq {wq.shape[0]}; all a positive multiple of 16")
    if 2 * Np >= 2**31:
        raise ValueError(f"{name}: 2*Np must be below 2^31")
    D0, D1, M = (torch.empty((B, Cw), dtype=odtype, device=planes.device)
                 for _ in range(3))
    Q0, Q1, Q2 = (torch.empty((B, Cq), dtype=odtype, device=planes.device)
                  for _ in range(3))
    if B:
        _launch(name, planes.device, planes.data_ptr(), wp.data_ptr(),
                wq.data_ptr(), *(o.data_ptr() for o in (D0, D1, M, Q0, Q1, Q2)),
                B, Np, Cw, Cq)
    return D0, D1, Q0, Q1, Q2, M


def bgen_i8_products_plain(planes, wp, wq):
    """Plain version of the bgen_i8 kernel: for planes [B, 2, Np] uint8,
    wp [Np, Cw] int8 and wq [Np, Cq] int8 returns (D0, D1, Q0, Q1, Q2, M)
    int64: D0, D1 and M the products of k0, k1 and miss with wp, Q0, Q1
    and Q2 those of h0, h1 and h2 with wq (bgen_indicators). Integer
    (int64) matmuls on the CPU; float64 on CUDA, chunked over samples,
    exact there because every partial sum is an integer below 2^53
    (|sum| <= 255 * 128 * Np)."""
    dt = torch.int64 if planes.device.type == "cpu" else torch.float64
    return tuple(a.to(torch.int64) for a in _bgen_order(planes, wp, wq, dt))


def bgen_i8_products(planes, wp, wq):
    """planes [B, 2, Np] uint8, wp [Np, Cw] int8, wq [Np, Cq] int8 ->
    (D0, D1, Q0, Q1, Q2, M), int64, [B, Cw] for D0, D1, M and [B, Cq] for
    the Q (see bgen_i8_products_plain). CUDA tensors launch the
    csrc/bgen_i8.cu kernel on the current stream; CPU tensors take the
    plain version."""
    if {t.device for t in (planes, wp, wq)} == {torch.device("cpu")}:
        return bgen_i8_products_plain(planes, wp, wq)
    outs = _bgen_call("bgen_i8", planes, wp, wq, torch.int8, torch.int64, 16)
    if planes.shape[0]:
        bgen_i8_products.launches += 1
    return outs


bgen_i8_products.launches = 0


def bgen_f32_products_plain(planes, wp, wq):
    """Plain version of the bgen_f32 kernel: for planes [B, 2, Np] uint8,
    wp [Np, Cw] float32 and wq [Np, Cq] float32 returns (D0, D1, Q0, Q1,
    Q2, M) float64: D0, D1 and M the products of k0, k1 and miss with wp,
    Q0, Q1 and Q2 those of h0, h1 and h2 with wq (bgen_indicators). The
    operands are widened to float64 and the products are float64 matmuls,
    chunked over samples by PLAIN_CHUNK on CUDA."""
    return _bgen_order(planes, wp, wq, torch.float64)


def bgen_f32_products(planes, wp, wq):
    """planes [B, 2, Np] uint8, wp [Np, Cw] float32, wq [Np, Cq] float32
    -> (D0, D1, Q0, Q1, Q2, M), float64, [B, Cw] for D0, D1, M and [B, Cq]
    for the Q (see bgen_f32_products_plain). CUDA tensors launch the
    csrc/bgen_f32.cu kernel on the current stream; CPU tensors take the
    plain version."""
    if {t.device for t in (planes, wp, wq)} == {torch.device("cpu")}:
        return bgen_f32_products_plain(planes, wp, wq)
    outs = _bgen_call("bgen_f32", planes, wp, wq, torch.float32, torch.float64, 4)
    if planes.shape[0]:
        bgen_f32_products.launches += 1
    return outs


bgen_f32_products.launches = 0


def bgen_bf16_products_plain(planes, wp, wq):
    """Plain version of the bgen_bf16 kernel: for planes [B, 2, Np] uint8
    and the bf16 split operands wp [Np, Cw], wq [Np, Cq] ([hi|mid|lo]
    thirds) returns (D0, D1, Q0, Q1, Q2, M) float64 against each third
    separately: D0, D1 and M the products of k0, k1 and miss with wp, Q0,
    Q1 and Q2 those of h0, h1 and h2 with wq (bgen_indicators). The
    operands are widened to float64 (exactly) and the products are
    float64 matmuls, chunked over samples by PLAIN_CHUNK on CUDA."""
    return _bgen_order(planes, wp, wq, torch.float64)


def bgen_bf16_products(planes, wp, wq):
    """planes [B, 2, Np] uint8, wp [Np, Cw] bfloat16, wq [Np, Cq] bfloat16
    -> (D0, D1, Q0, Q1, Q2, M), float64, [B, Cw] for D0, D1, M and [B, Cq]
    for the Q (see bgen_bf16_products_plain; the kernel sums BF16_FLUSH
    terms at a time in float32). CUDA tensors launch the csrc/bgen_bf16.cu
    kernel on the current stream; CPU tensors take the plain version."""
    if {t.device for t in (planes, wp, wq)} == {torch.device("cpu")}:
        return bgen_bf16_products_plain(planes, wp, wq)
    outs = _bgen_call("bgen_bf16", planes, wp, wq, torch.bfloat16,
                      torch.float64, 8)
    if planes.shape[0]:
        bgen_bf16_products.launches += 1
    return outs


bgen_bf16_products.launches = 0


# ---------------------------------------------------------------------------
# PLINK bytes -> plane-ordered genotypes: decode_planes
# ---------------------------------------------------------------------------


def decode_planes_plain(raw):
    """Plain version of the decode_planes kernel: raw [B, nb] uint8 ->
    [B, 4*nb] float32 in plane order, column p*nb + c holding the genotype
    of sample 4c + p: code_p(raw[b, c]) 0 / 1 / 2 / 3 -> 2 / -3 / 1 / 0
    (hom-alt, missing, het, hom-ref)."""
    lut = torch.tensor([2.0, -3.0, 1.0, 0.0], dtype=torch.float32,
                       device=raw.device)
    r = raw.to(torch.int64)
    return torch.cat([lut[(r >> (2 * p)) & 3] for p in range(4)], dim=1)


def decode_planes(raw):
    """raw [B, nb] uint8 -> [B, 4*nb] float32 (see decode_planes_plain).
    A CUDA tensor launches the csrc/decode_planes.cu kernel on the current
    stream; a CPU tensor takes the plain version."""
    if raw.device.type == "cpu":
        return decode_planes_plain(raw)
    _check_cuda_inputs("decode_planes", (raw,), (torch.uint8,), 1)
    if raw.dim() != 2 or raw.shape[0] >= 65536:
        raise ValueError("decode_planes: raw [B, nb] with B below 65,536")
    B, nb = raw.shape
    out = torch.empty((B, 4 * nb), dtype=torch.float32, device=raw.device)
    if B and nb:
        _launch("decode_planes", raw.device, raw.data_ptr(), out.data_ptr(),
                B, nb)
        decode_planes.launches += 1
    return out


decode_planes.launches = 0


# ---------------------------------------------------------------------------
# the profiling variants of fused_bf16: profile_fused (five entry points)
# ---------------------------------------------------------------------------

# the Hopper configurations of the stacked and the pipelined kernels, by
# the `config` index of their entry points (csrc/profile_fused.cu)
PROFILE_STACKED_CONFIGS = ("64x64 tile, 3 stages", "64x64 tile, 4 stages",
                           "64x64 tile, 2 stages")
PROFILE_PIPELINED_CONFIGS = ("4 decode warps, 4 stages",
                             "2 decode warps, 4 stages")


def _profile_inputs(name, raw, wp, config=0, n_configs=1):
    """The checks of the profiling wrappers on any device: raw [B, nbp]
    uint8, wp [4, nbp, Cw] bfloat16, config in 0..n_configs-1. True when
    both tensors lie on the CPU."""
    if not 0 <= config < n_configs:
        raise ValueError(f"{name}: config {config} is not one of "
                         f"0..{n_configs - 1}")
    if raw.dtype != torch.uint8 or wp.dtype != torch.bfloat16:
        raise TypeError(f"{name}: raw must be torch.uint8 and wp torch.bfloat16, "
                        f"got {raw.dtype} and {wp.dtype}")
    if raw.dim() != 2 or wp.dim() != 3 or wp.shape[0] != 4 \
            or wp.shape[1] != raw.shape[1]:
        raise ValueError(f"{name}: raw [B, nbp] and wp [4, nbp, Cw], got "
                         f"{tuple(raw.shape)} and {tuple(wp.shape)}")
    return raw.device.type == "cpu" and wp.device.type == "cpu"


def _profile_call(entry, raw, wp, config=0):
    """Launch the profile_fused entry point `entry` (checked inputs)."""
    if 4 * raw.shape[-1] >= 2**31:
        raise ValueError(f"{entry}: 4*nbp must be below 2^31")
    return _fused_call(entry, raw, wp, torch.bfloat16, torch.float64, 8, config)


def profile_stacked_products_plain(raw, wp, with_m=True):
    """Plain version of the profile_fused stacked kernel, the function of
    fused_bf16 (fused_bf16_products_plain): H, E, M [B, Cw] float64; with
    with_m=False, M is 0 and not computed."""
    return tuple(_fused_plain(raw, wp, torch.float64, 3 if with_m else 2))


def profile_stacked_2dots_products_plain(raw, wp):
    """Plain version of the stacked kernel without the M product."""
    return profile_stacked_products_plain(raw, wp, with_m=False)


def profile_stacked_2dots_products(raw, wp):
    """raw [B, nbp] uint8, wp [4, nbp, Cw] bfloat16 -> (H, E, 0), each
    [B, Cw] float64: the stacked kernel with its M product not issued
    (scripts/profile_fused.py's stacked-2dots). A CUDA tensor launches the
    csrc/profile_fused.cu entry profile_fused_stacked2; CPU tensors take
    the plain version."""
    if _profile_inputs("profile_stacked_2dots_products", raw, wp):
        return profile_stacked_2dots_products_plain(raw, wp)
    outs = _profile_call("profile_fused_stacked2", raw, wp)
    if raw.shape[0]:
        profile_stacked_2dots_products.launches += 1
    return outs


profile_stacked_2dots_products.launches = 0


def profile_stacked_products(raw, wp, with_m=True, config=0):
    """raw [B, nbp] uint8, wp [4, nbp, Cw] bfloat16 (the hi|mid|lo split)
    -> (H, E, M), each [B, Cw] float64: fused_bf16's function, through the
    base of csrc/profile_fused.cu in its Hopper configuration `config`
    (PROFILE_STACKED_CONFIGS). with_m=False goes to
    profile_stacked_2dots_products (its own kernel and count). CUDA
    tensors launch the kernel; CPU tensors take the plain version."""
    if not with_m:
        return profile_stacked_2dots_products(raw, wp)
    if _profile_inputs("profile_stacked_products", raw, wp, config,
                       len(PROFILE_STACKED_CONFIGS)):
        return profile_stacked_products_plain(raw, wp)
    outs = _profile_call("profile_fused_stacked", raw, wp, config)
    if raw.shape[0]:
        profile_stacked_products.launches += 1
    return outs


profile_stacked_products.launches = 0


def profile_nodecode_products_plain(raw, wp):
    """Plain version of the nodecode kernel: H = E = M [B, Cw] float64 =
    sum_p sum_c raw[b, c] * wp[p, c, j], the byte taken as its value: a
    float64 matmul of raw, repeated per plane, against the widened
    wp.reshape(4*nbp, Cw), chunked over bytes by PLAIN_CHUNK on CUDA."""
    B, nbp = raw.shape
    acc = torch.zeros((B, wp.shape[-1]), dtype=torch.float64, device=raw.device)
    step = _chunk(nbp, raw.device)
    for c0 in range(0, nbp, step):
        r = raw[:, c0 : c0 + step].to(torch.float64)
        w = wp[:, c0 : c0 + step].reshape(-1, wp.shape[-1]).to(torch.float64)
        acc += torch.cat([r] * 4, dim=1) @ w
    return acc, acc.clone(), acc.clone()


def profile_nodecode_products(raw, wp):
    """raw [B, nbp] uint8, wp [4, nbp, Cw] bfloat16 -> (H, E, M), three
    equal [B, Cw] float64 (see profile_nodecode_products_plain); the kernel
    issues the three mma chains. A CUDA tensor launches the
    csrc/profile_fused.cu entry profile_fused_nodecode; CPU tensors take
    the plain version."""
    if _profile_inputs("profile_nodecode_products", raw, wp):
        return profile_nodecode_products_plain(raw, wp)
    outs = _profile_call("profile_fused_nodecode", raw, wp)
    if raw.shape[0]:
        profile_nodecode_products.launches += 1
    return outs


profile_nodecode_products.launches = 0


def profile_decode_only_products_plain(raw, wp):
    """Plain version of the decode-only kernel: H, E, M [B, Cw] float64,
    zero but for column 0, which holds each row's count of codes 0 / 2 / 1
    over its 4*nbp decoded samples (pad bytes are code 0), counted with
    integer operations."""
    B, Cw = raw.shape[0], wp.shape[-1]
    outs = [torch.zeros((B, Cw), dtype=torch.float64, device=raw.device)
            for _ in range(3)]
    if Cw:
        for masks in _decode_indicators(raw):
            for o, m in zip(outs, masks):
                o[:, 0] += m.sum(dim=1, dtype=torch.int64).to(torch.float64)
    return tuple(outs)


def profile_decode_only_products(raw, wp):
    """raw [B, nbp] uint8, wp [4, nbp, Cw] bfloat16 -> the code counts in
    column 0 of three [B, Cw] float64 (see
    profile_decode_only_products_plain); the kernel loads the operand's
    stages and issues no mma. A CUDA tensor launches the
    csrc/profile_fused.cu entry profile_fused_decode_only; CPU tensors
    take the plain version."""
    if _profile_inputs("profile_decode_only_products", raw, wp):
        return profile_decode_only_products_plain(raw, wp)
    outs = _profile_call("profile_fused_decode_only", raw, wp)
    if raw.shape[0]:
        profile_decode_only_products.launches += 1
    return outs


profile_decode_only_products.launches = 0


def profile_pipelined_products_plain(raw, wp):
    """Plain version of the pipelined kernel: fused_bf16's function."""
    return profile_stacked_products_plain(raw, wp)


def profile_pipelined_products(raw, wp, config=0):
    """raw [B, nbp] uint8, wp [4, nbp, Cw] bfloat16 -> (H, E, M), each
    [B, Cw] float64: fused_bf16's function, with decode warps filling a
    double-buffered indicator tile that the mma warps read one stage later,
    in the Hopper configuration `config` (PROFILE_PIPELINED_CONFIGS). A
    CUDA tensor launches the csrc/profile_fused.cu entry
    profile_fused_pipelined; CPU tensors take the plain version."""
    if _profile_inputs("profile_pipelined_products", raw, wp, config,
                       len(PROFILE_PIPELINED_CONFIGS)):
        return profile_pipelined_products_plain(raw, wp)
    outs = _profile_call("profile_fused_pipelined", raw, wp, config)
    if raw.shape[0]:
        profile_pipelined_products.launches += 1
    return outs


profile_pipelined_products.launches = 0


# ---------------------------------------------------------------------------
# the profiling variants of bgen_i8: profile_bgen (one entry point)
# ---------------------------------------------------------------------------

# variant: (m shifted, q products, the scripts/profile_bgen.py functions
# it computes), in the order of the entry point's `variant` index
# (csrc/profile_bgen.cu); the name reads decode / m / q: i32 decodes
# through 32-bit integers, u8 on packed bytes, "shift" takes m = (miss -
# 128) @ wp, "unshift" miss @ wp, "stacked" decodes into shared memory
PROFILE_BGEN_VARIANTS = {
    "i32_shift_q3": (True, "q3", "kern_base, kern_sep"),
    "i32_shift_noq": (True, "noq", "kern_noq, kern_sep_noq"),
    "u8_shift_q3": (True, "q3", "kern_u8"),
    "u8_unshift_q3_stacked": (False, "q3", "kern_sep_merge"),
    "u8_unshift_q3": (False, "q3", "make_base(.., 3)"),
    "u8_unshift_e2": (False, "e2", "make_base(.., 2)"),
    "u8_unshift_dhl": (False, "dhl", "make_base(.., 4)"),
}
# the Hopper tile configurations of u8_unshift_q3, by the `config` index
# (the other variants have configuration 0 only)
PROFILE_BGEN_CONFIGS = ("64x128 tile, 8 warps of 32x32",
                        "128x128 tile, 16 warps of 32x32",
                        "64x128 tile, 8 warps of 16x64")


def profile_bgen_products_plain(k0, k1, wp, wq, variant):
    """Plain version of the profile_bgen kernel `variant`
    (PROFILE_BGEN_VARIANTS): for k0, k1 [B, Np] uint8, wp [Np, Cw] int8 and
    wq [Np, Cq] int8, with miss = k0 + k1 > 255, k0 = k1 = 0 there, and
    s(x) = x - 128, returns (d0, d1, m, q0, q1, q2), int64:
    d0 = s(k0) @ wp, d1 = s(k1) @ wp, m = s(miss) @ wp ("shift") or
    miss @ wp ("unshift") [B, Cw]; q_i = s(x_i) @ wq for the multiplicands
    x_i of _q_multiplicands(.., q) [B, Cq] (dhl: q2 = s(dhi dlo) @ wq +
    s(dhi) @ wq), the q products the variant has not 0. The order is the
    TPU script's, not bgen_i8_products' (D0, D1, Q0, Q1, Q2, M). The -128
    shifts come off through the operands' column sums over all Np rows.
    Integer (int64) matmuls on the CPU; float64 on CUDA, chunked over
    samples, exact there because every partial sum is an integer below
    2^53."""
    shift_m, q, _ = PROFILE_BGEN_VARIANTS[variant]
    dt = torch.int64 if k0.device.type == "cpu" else torch.float64
    d0, d1, m, *qs = _bgen_plain(k0, k1, wp, wq, dt, q)
    cw = 128 * wp.sum(0, dtype=torch.int64).to(dt)
    cq = 128 * wq.sum(0, dtype=torch.int64).to(dt)
    outs = [d0 - cw, d1 - cw, m - cw if shift_m else m]
    outs += [x - cq for x in qs]
    if q == "dhl":
        outs[5] -= cq
    B, Cq = k0.shape[0], wq.shape[1]
    outs += [torch.zeros((B, Cq), dtype=dt, device=k0.device)
             for _ in range(6 - len(outs))]
    return tuple(x.to(torch.int64) for x in outs)


def _profile_bgen_inputs(name, k0, k1, wp, wq, config, n_configs):
    """The checks of the profile_bgen wrappers on any device: k0, k1
    [B, Np] uint8 with unit sample stride and one row stride (Np for two
    tensors, 2 Np for the planes of one [B, 2, Np] buffer: no copy is
    made), a multiple of 16 at least Np; wp [Np, Cw] and wq [Np, Cq] int8,
    contiguous; Np, Cw and Cq multiples of 16 (the kernel's 16-byte
    loads), Np > 0; config in 0..n_configs-1. True when every tensor lies
    on the CPU."""
    if not 0 <= config < n_configs:
        raise ValueError(f"{name}: config {config} is not one of "
                         f"0..{n_configs - 1}")
    ts = (k0, k1, wp, wq)
    if tuple(t.dtype for t in ts) != (torch.uint8, torch.uint8, torch.int8,
                                      torch.int8):
        raise TypeError(f"{name}: k0, k1 must be torch.uint8 and wp, wq "
                        f"torch.int8, got {', '.join(str(t.dtype) for t in ts)}")
    if k0.dim() != 2 or k1.shape != k0.shape or wp.dim() != 2 or wq.dim() != 2 \
            or wp.shape[0] != k0.shape[1] or wq.shape[0] != k0.shape[1]:
        raise ValueError(f"{name}: k0, k1 [B, Np], wp [Np, Cw], wq [Np, Cq], "
                         f"got {', '.join(str(tuple(t.shape)) for t in ts)}")
    Np = k0.shape[1]
    if Np == 0 or any(n % 16 for n in (Np, wp.shape[1], wq.shape[1])):
        raise ValueError(f"{name}: Np, Cw and Cq must be multiples of 16 and "
                         f"Np > 0, got {Np}, {wp.shape[1]}, {wq.shape[1]}")
    rs = k0.stride(0)
    if k0.stride() != k1.stride() or k0.stride(1) != 1 or rs % 16 \
            or (k0.shape[0] > 1 and rs < Np):
        raise ValueError(f"{name}: k0 and k1 need unit sample stride and one "
                         f"row stride, a multiple of 16, got {k0.stride()} and "
                         f"{k1.stride()}")
    if not (wp.is_contiguous() and wq.is_contiguous()):
        raise ValueError(f"{name}: wp and wq must be contiguous")
    return all(t.device.type == "cpu" for t in ts)


def _profile_bgen_wrapper(variant, index):
    """The wrapper of one profile_bgen variant, with its launch count."""
    n_configs = len(PROFILE_BGEN_CONFIGS) if variant == "u8_unshift_q3" else 1
    name = f"profile_bgen_{variant}_products"

    def wrapper(k0, k1, wp, wq, config=0):
        if _profile_bgen_inputs(name, k0, k1, wp, wq, config, n_configs):
            return profile_bgen_products_plain(k0, k1, wp, wq, variant)
        if len({t.device for t in (k0, k1, wp, wq)}) != 1 or not k0.is_cuda:
            raise ValueError(f"{name}: inputs must be on the same CUDA device "
                             "(or all on the CPU)")
        if any(t.data_ptr() % 16 for t in (k0, k1, wp, wq)):
            raise ValueError(f"{name}: inputs must be 16-byte aligned")
        B, Np = k0.shape
        Cw, Cq = wp.shape[1], wq.shape[1]
        outs = tuple(torch.empty((B, c), dtype=torch.int64, device=k0.device)
                     for c in (Cw, Cw, Cw, Cq, Cq, Cq))
        if B:
            _launch("profile_bgen", k0.device, k0.data_ptr(), k1.data_ptr(),
                    wp.data_ptr(), wq.data_ptr(), *(o.data_ptr() for o in outs),
                    k0.stride(0), B, Np, Cw, Cq, index, config)
            wrapper.launches += 1
        return outs

    shift_m, q, tpu = PROFILE_BGEN_VARIANTS[variant]
    wrapper.__name__ = wrapper.__qualname__ = name
    wrapper.__doc__ = (
        f"k0, k1 [B, Np] uint8 (two tensors, or the planes of one [B, 2, Np] "
        f"buffer), wp [Np, Cw] int8, wq [Np, Cq] int8 -> (d0, d1, m, q0, q1, "
        f"q2) int64: the function of scripts/profile_bgen.py's {tpu} "
        f"(profile_bgen_products_plain with variant {variant!r}). CUDA "
        f"tensors launch csrc/profile_bgen.cu's variant {index}"
        + (" in its configuration `config` (PROFILE_BGEN_CONFIGS)"
           if n_configs > 1 else "")
        + "; CPU tensors take the plain version.")
    wrapper.launches = 0
    return wrapper


# the wrapper of each variant, by variant name
PROFILE_BGEN = {v: _profile_bgen_wrapper(v, i)
                for i, v in enumerate(PROFILE_BGEN_VARIANTS)}

# every kernel wrapper by kernel name, for code that resets or reads the
# launch counts of a run
WRAPPERS = {"fused_i8": fused_i8_products, "bgen_i8": bgen_i8_products,
            "fused_f32": fused_f32_products, "bgen_f32": bgen_f32_products,
            "fused_bf16": fused_bf16_products, "bgen_bf16": bgen_bf16_products,
            "decode_planes": decode_planes,
            "profile_stacked": profile_stacked_products,
            "profile_stacked_2dots": profile_stacked_2dots_products,
            "profile_nodecode": profile_nodecode_products,
            "profile_decode_only": profile_decode_only_products,
            "profile_pipelined": profile_pipelined_products,
            **{f"profile_bgen_{v}": w for v, w in PROFILE_BGEN.items()}}
