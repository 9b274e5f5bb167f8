"""ctypes bindings for the root native library (native/decoder.cpp), the
port's copy of regenie_tpu/io/native.py trimmed to what the Step-2 BED
path calls: the BED decoder and the .regenie / HTP row formatters.

Builds libregenie_native.so with `make -C native` on first use when a
toolchain is available; every caller falls back to its numpy or
per-row Python path when the library is missing.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native")
_state = {"lib": None, "tried": False}


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
