"""Hand-written CUDA kernels of the port, their build, their wrappers and
their plain PyTorch versions.

Kernels (sources under ops/csrc/, one shared library each):

- fused_i8 (csrc/fused_i8.cu): the int8 fused Step-2 products, replacing
  the Pallas kernel regenie_tpu/ops/fused_score.py:403 _fused_kernel_i8.

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
SOURCES = {"fused_i8": "fused_i8.cu"}
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
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 3 + [
            ctypes.c_void_p]
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
