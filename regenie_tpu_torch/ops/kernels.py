"""Hand-written CUDA kernels of the port, their build, their wrappers and
their plain PyTorch versions.

Kernels (sources under ops/csrc/, one shared library each):

- fused_i8 (csrc/fused_i8.cu): the int8 fused Step-2 products, replacing
  the Pallas kernel regenie_tpu/ops/fused_score.py:403 _fused_kernel_i8.
- bgen_i8 (csrc/bgen_i8.cu): the six BGEN 8-bit dosage products, replacing
  the Pallas kernel regenie_tpu/ops/fused_score.py:1093 _bgen_kernel_i8.

Build: `nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
-Xcompiler -fPIC` into regenie_tpu_torch/_build/ (git-ignored), at first
use or by build_all(), which starts one nvcc per source at once. The
libraries have plain C entry points and are loaded with ctypes; nothing
here imports or builds anything when the module is imported.

A wrapper launches its kernel for CUDA tensors (or raises) and uses the
kernel's plain version only for CPU tensors. Each wrapper counts its
launches in a plain integer attribute, `<wrapper>.launches`.
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
SOURCES = {"fused_i8": "fused_i8.cu", "bgen_i8": "bgen_i8.cu"}
# argument types of each library's `<name>_launch` entry point
_ARGTYPES = {
    "fused_i8": [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 3
    + [ctypes.c_void_p],
    "bgen_i8": [ctypes.c_void_p] * 9 + [ctypes.c_longlong] * 4
    + [ctypes.c_void_p],
}
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
        fn = getattr(lib, f"{name}_launch")
        fn.restype = ctypes.c_int
        fn.argtypes = _ARGTYPES[name]
        _libs[name] = lib
    return lib


def _decode_indicators(raw):
    """[B, nbp] uint8 -> per plane p the (hom-alt, het, missing) boolean
    [B, nbp] masks of code_p = (raw >> 2p) & 3 == 0 / 2 / 1."""
    r = raw.to(torch.int32)
    out = []
    for p in range(4):
        codes = (r >> (2 * p)) & 3
        out.append((codes == 0, codes == 2, codes == 1))
    return out


def fused_i8_products_plain(raw, limbs):
    """Plain version of the fused_i8 kernel: H, E, M [B, Cw4] int32 with
    H[b, j] = sum_p sum_c [code_p(raw[b, c]) == 0] * limbs[p, c, j] (E:
    code 2, M: code 1). Integer (int64) matmuls on the CPU; float64 on
    CUDA, exact there because every partial sum is an integer below
    2^53."""
    dt = torch.int64 if raw.device.type == "cpu" else torch.float64
    B, Cw4 = raw.shape[0], limbs.shape[-1]
    acc = [torch.zeros((B, Cw4), dtype=dt, device=raw.device) for _ in range(3)]
    for p, masks in enumerate(_decode_indicators(raw)):
        w = limbs[p].to(dt)
        for a, ind in zip(acc, masks):
            a += ind.to(dt) @ w
    return tuple(a.to(torch.int32) for a in acc)


def fused_i8_products(raw, limbs):
    """raw [B, nbp] uint8, limbs [4, nbp, Cw4] int8 -> (H, E, M), each
    [B, Cw4] int32 (see fused_i8_products_plain). CUDA tensors launch
    the csrc/fused_i8.cu kernel on the current stream; CPU tensors take
    the plain version."""
    if raw.device.type == "cpu" and limbs.device.type == "cpu":
        return fused_i8_products_plain(raw, limbs)
    if not (raw.is_cuda and limbs.is_cuda and raw.device == limbs.device):
        raise ValueError("fused_i8_products: raw and limbs must be on the "
                         "same CUDA device (or both on the CPU)")
    if raw.dtype != torch.uint8 or limbs.dtype != torch.int8:
        raise TypeError("fused_i8_products: raw must be uint8, limbs int8")
    if raw.dim() != 2 or limbs.dim() != 3 or limbs.shape[0] != 4:
        raise ValueError("fused_i8_products: raw [B, nbp], limbs [4, nbp, Cw4]")
    B, nbp = raw.shape
    Cw4 = limbs.shape[2]
    if limbs.shape[1] != nbp:
        raise ValueError(f"fused_i8_products: raw has {nbp} bytes per row, "
                         f"limbs {limbs.shape[1]}")
    if nbp % 16 or Cw4 % 16:
        raise ValueError("fused_i8_products: nbp and Cw4 must be multiples of 16")
    if 4 * nbp >= 8_000_000:
        raise ValueError("fused_i8_products: int32 accumulator bound "
                         "(N < 8,000,000 samples)")
    if not (raw.is_contiguous() and limbs.is_contiguous()):
        raise ValueError("fused_i8_products: inputs must be contiguous")
    if raw.data_ptr() % 16 or limbs.data_ptr() % 16:
        raise ValueError("fused_i8_products: inputs must be 16-byte aligned")
    outs = [torch.empty((B, Cw4), dtype=torch.int32, device=raw.device)
            for _ in range(3)]
    if B == 0:
        return tuple(outs)
    lib = _lib("fused_i8")
    with torch.cuda.device(raw.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fused_i8_launch(raw.data_ptr(), limbs.data_ptr(),
                                  outs[0].data_ptr(), outs[1].data_ptr(),
                                  outs[2].data_ptr(), B, nbp, Cw4, stream)
    if err != 0:
        raise RuntimeError(f"fused_i8 kernel launch failed: CUDA error {err}")
    fused_i8_products.launches += 1
    return tuple(outs)


fused_i8_products.launches = 0


# samples per chunk of the plain versions' float64 products on CUDA (one
# [2048, 400,128] float64 plane would take 6.6 GB)
PLAIN_CHUNK = 32768


def bgen_indicators(planes):
    """[B, 2, n] uint8 probability planes -> the six [B, n] int32
    multiplicands of the BGEN products, (k0, k1, h0, h1, h2, miss): miss
    = k0 + k1 > 255, k0 = k1 = 0 there, and h0, h1, h2 the bytes 0, 1, 2
    of d2 = (2 k0 + k1)^2."""
    k0 = planes[:, 0].to(torch.int32)
    k1 = planes[:, 1].to(torch.int32)
    miss = (k0 + k1) > 255
    k0 = torch.where(miss, 0, k0)
    k1 = torch.where(miss, 0, k1)
    d2 = (2 * k0 + k1) ** 2
    return k0, k1, d2 & 255, (d2 >> 8) & 255, d2 >> 16, miss.to(torch.int32)


def bgen_i8_products_plain(planes, wp, wq):
    """Plain version of the bgen_i8 kernel: for planes [B, 2, Np] uint8,
    wp [Np, Cw] int8 and wq [Np, Cq] int8 returns (D0, D1, Q0, Q1, Q2, M)
    int64: D0, D1 and M the products of k0, k1 and miss with wp, Q0, Q1
    and Q2 those of h0, h1 and h2 with wq (bgen_indicators). Integer
    (int64) matmuls on the CPU; float64 on CUDA, chunked over samples,
    exact there because every partial sum is an integer below 2^53
    (|sum| <= 255 * 128 * Np)."""
    cpu = planes.device.type == "cpu"
    dt = torch.int64 if cpu else torch.float64
    Np = planes.shape[2]
    step = Np if cpu else PLAIN_CHUNK
    acc = [0] * 6
    for n0 in range(0, Np, step):
        w = wp[n0 : n0 + step].to(dt)
        q = wq[n0 : n0 + step].to(dt)
        acc = [a + x.to(dt) @ op for a, x, op in zip(
            acc, bgen_indicators(planes[:, :, n0 : n0 + step]),
            (w, w, q, q, q, w))]
    return tuple(a.to(torch.int64) for a in acc)


def bgen_i8_products(planes, wp, wq):
    """planes [B, 2, Np] uint8, wp [Np, Cw] int8, wq [Np, Cq] int8 ->
    (D0, D1, Q0, Q1, Q2, M), int64, [B, Cw] for D0, D1, M and [B, Cq] for
    the Q (see bgen_i8_products_plain). CUDA tensors launch the
    csrc/bgen_i8.cu kernel on the current stream; CPU tensors take the
    plain version."""
    devs = {t.device for t in (planes, wp, wq)}
    if devs == {torch.device("cpu")}:
        return bgen_i8_products_plain(planes, wp, wq)
    if len(devs) != 1 or not planes.is_cuda:
        raise ValueError("bgen_i8_products: planes, wp and wq must be on the "
                         "same CUDA device (or all on the CPU)")
    if planes.dtype != torch.uint8 or wp.dtype != torch.int8 \
            or wq.dtype != torch.int8:
        raise TypeError("bgen_i8_products: planes must be uint8, wp and wq int8")
    if planes.dim() != 3 or planes.shape[1] != 2 or wp.dim() != 2 \
            or wq.dim() != 2:
        raise ValueError("bgen_i8_products: planes [B, 2, Np], wp [Np, Cw], "
                         "wq [Np, Cq]")
    B, _, Np = planes.shape
    Cw, Cq = wp.shape[1], wq.shape[1]
    if wp.shape[0] != Np or wq.shape[0] != Np:
        raise ValueError(f"bgen_i8_products: planes have {Np} samples, wp "
                         f"{wp.shape[0]}, wq {wq.shape[0]}")
    if Np == 0 or Np % 16 or Cw % 16 or Cq % 16:
        raise ValueError("bgen_i8_products: Np (> 0), Cw and Cq must be "
                         "multiples of 16")
    if not all(t.is_contiguous() for t in (planes, wp, wq)):
        raise ValueError("bgen_i8_products: inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in (planes, wp, wq)):
        raise ValueError("bgen_i8_products: inputs must be 16-byte aligned")
    outs = ([torch.empty((B, Cw), dtype=torch.int64, device=planes.device)
             for _ in range(3)]
            + [torch.empty((B, Cq), dtype=torch.int64, device=planes.device)
               for _ in range(3)])
    D0, D1, M, Q0, Q1, Q2 = outs
    if B == 0:
        return D0, D1, Q0, Q1, Q2, M
    lib = _lib("bgen_i8")
    with torch.cuda.device(planes.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.bgen_i8_launch(
            planes.data_ptr(), wp.data_ptr(), wq.data_ptr(),
            *(o.data_ptr() for o in outs), B, Np, Cw, Cq, stream)
    if err != 0:
        raise RuntimeError(f"bgen_i8 kernel launch failed: CUDA error {err}")
    bgen_i8_products.launches += 1
    return D0, D1, Q0, Q1, Q2, M


bgen_i8_products.launches = 0

# every kernel wrapper by kernel name, for code that resets or reads the
# launch counts of a run
WRAPPERS = {"fused_i8": fused_i8_products, "bgen_i8": bgen_i8_products}
