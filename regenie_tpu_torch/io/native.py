"""ctypes bindings of native code (the port's copy of
regenie_tpu/io/native.py, trimmed to what the Step-2 paths call).

- The root native library (native/decoder.cpp): the BED decoder and the
  .regenie / HTP row formatters. libregenie_native.so is built with
  `make -C native` on first use when the toolchain (zlib and zstd
  headers) is there; every caller falls back to its numpy or per-row
  Python path when the library is missing.
- The BGEN plane extractor, the port's own copy in io/csrc/bgen_planes.cpp
  (zlib only, so it needs no zstd): built with g++ into
  regenie_tpu_torch/_build/ (git-ignored) at first use. The BGEN path has
  no other reader, so a failed build, a missing symbol or a rejected
  block raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NATIVE_DIR = os.path.join(os.path.dirname(_PKG_DIR), "native")
_PLANES_SRC = os.path.join(_PKG_DIR, "io", "csrc", "bgen_planes.cpp")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
PLANES_SYMBOL = "bgen12_extract_planes"
_state = {"lib": None, "tried": False, "planes": None}


def get_lib() -> Optional[ctypes.CDLL]:
    if _state["tried"]:
        return _state["lib"]
    _state["tried"] = True
    so = os.path.join(_NATIVE_DIR, "libregenie_native.so")
    if not os.path.isfile(so):
        try:
            subprocess.run(["make", "-C", _NATIVE_DIR], capture_output=True,
                           timeout=120, check=True)
        except (OSError, subprocess.SubprocessError):
            return None
    try:
        lib = ctypes.CDLL(so)
    except OSError:
        return None
    lib.bed_decode.restype = None
    lib.bed_decode.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p,
    ]
    if hasattr(lib, "format_sumstat_single"):
        lib.format_sumstat_single.restype = ctypes.c_int64
        lib.format_sumstat_single.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p,
        ]
        lib.sumstat_field_budget.restype = ctypes.c_int64
        lib.sumstat_field_budget.argtypes = []
    if hasattr(lib, "format_sumstat_htp"):
        lib.format_sumstat_htp.restype = ctypes.c_int64
        lib.format_sumstat_htp.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_double, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.htp_field_budget.restype = ctypes.c_int64
        lib.htp_field_budget.argtypes = []
    _state["lib"] = lib
    return lib


def bed_decode_native(raw: np.ndarray, n_samples: int) -> Optional[np.ndarray]:
    """[B, nbytes] packed -> [B, N] int8, or None if lib unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    raw = np.ascontiguousarray(raw)
    B, nb = raw.shape
    out = np.empty((B, n_samples), dtype=np.int8)
    lib.bed_decode(raw.ctypes.data, B, nb, n_samples, out.ctypes.data)
    return out


def planes_lib() -> ctypes.CDLL:
    """The BGEN plane extractor library (io/csrc/bgen_planes.cpp), built
    with g++ at first use and cached by the source's hash. Raises
    RuntimeError when it cannot be built or lacks PLANES_SYMBOL."""
    lib = _state["planes"]
    if lib is not None:
        return lib
    with open(_PLANES_SRC, "rb") as fh:
        tag = hashlib.sha256(fh.read()).hexdigest()[:12]
    so = os.path.join(BUILD_DIR, f"libbgen_planes_{tag}.so")
    if not os.path.isfile(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [os.environ.get("CXX", "g++"), "-O3", "-fPIC", "-shared",
               "-o", tmp, _PLANES_SRC, "-lz"]
        try:
            r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        except OSError as e:
            raise RuntimeError(f"cannot build the BGEN plane extractor: {e}") from e
        if r.returncode != 0:
            raise RuntimeError("building the BGEN plane extractor failed "
                               f"({' '.join(cmd)}):\n{r.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(so)
    if not hasattr(lib, PLANES_SYMBOL):
        raise RuntimeError(f"{so} has no symbol {PLANES_SYMBOL}")
    fn = getattr(lib, PLANES_SYMBOL)
    fn.restype = ctypes.c_int64
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
    ]
    _state["planes"] = lib
    return lib


def bgen12_extract_planes_native(comp: bytes, offsets, csizes, usizes,
                                 n_samples: int, compression: int) -> np.ndarray:
    """Inflate-only BGEN v1.2 8-bit plane extraction: [B, 2, N] uint8 (k0
    plane, k1 plane; missing samples = 255/255), the variants split over
    one thread per CPU (ctypes releases the GIL during each call). Raises
    RuntimeError when any variant of the block is rejected (not zlib, not
    unphased diploid biallelic 8-bit, or a clipped probability pair)."""
    fn = getattr(planes_lib(), PLANES_SYMBOL)
    n_var = len(offsets)
    planes = np.empty((n_var, 2, n_samples), dtype=np.uint8)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    csizes = np.ascontiguousarray(csizes, dtype=np.int64)
    usizes = np.ascontiguousarray(usizes, dtype=np.int64)

    def run(lo, hi):
        return fn(comp, offsets[lo:].ctypes.data, csizes[lo:].ctypes.data,
                  usizes[lo:].ctypes.data, hi - lo, n_samples, compression,
                  planes[lo:].ctypes.data)

    bounds = np.linspace(0, n_var, min(os.cpu_count() or 1, n_var) + 1).astype(int)
    with ThreadPoolExecutor(len(bounds) - 1 or 1) as pool:
        nfail = sum(pool.map(run, bounds[:-1], bounds[1:]))
    if nfail > 0:
        raise RuntimeError(
            f"BGEN plane extraction rejected {nfail} of {n_var} variants "
            "(the port reads only zlib-compressed, unphased diploid, "
            "biallelic 8-bit layout-2 blocks with probabilities summing "
            "to at most 1)")
    return planes
