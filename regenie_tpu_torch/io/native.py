"""ctypes bindings of native code (the port's copy of
regenie_tpu/io/native.py, trimmed to what the ported paths call).

- The root native library (native/decoder.cpp): the BED decoder and the
  .regenie / HTP row formatters. libregenie_native.so is built with
  `make -C native` on first use when the toolchain (zlib and zstd
  headers) is there; every caller falls back to its numpy or per-row
  Python path when the library is missing.
- The BGEN plane extractor, the port's own copy in io/csrc/bgen_planes.cpp
  (built against zlib alone; zstd records take ZSTD_decompress from
  libzstd.so.1 at run time, require_zstd): built with g++ into
  regenie_tpu_torch/_build/ (git-ignored) at first use. The BGEN path has
  no other reader, so a failed build, a missing symbol, a zstd file
  without the library or a rejected block raises.
- The LOCO/PRS row renderer, the port's own copy of format_loco_rows in
  io/csrc/loco_rows.cpp (single-threaded; callers split the rows over
  threads), built the same way. Step 1 has no other renderer at biobank
  scale, so a failed build or load raises.
- The PGEN block decoder, io/csrc/pgen_bytes.cpp (std::thread over
  variants), built the same way: PGEN hardcalls to BED-coded packed
  bytes on the kept-sample axis. Both steps read PGEN only through it,
  so a failed build, load or record raises.
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
_CSRC = os.path.join(_PKG_DIR, "io", "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
PLANES_SYMBOL = "bgen12_extract_planes"
LOCO_SYMBOL = "format_loco_rows"
ZSTD_SONAME = "libzstd.so.1"
PGEN_SYMBOL = "pgen_bed_bytes"
_state = {"lib": None, "tried": False, "planes": None, "loco": None,
          "pgen": None, "zstd": None}


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


def _build_lib(name: str, what: str, symbol: str, libs=()) -> ctypes.CDLL:
    """io/csrc/<name>.cpp built with g++ into BUILD_DIR at first use,
    cached by the source's hash, and loaded. Raises RuntimeError when it
    cannot be built or loaded, or lacks `symbol`."""
    src = os.path.join(_CSRC, f"{name}.cpp")
    with open(src, "rb") as fh:
        tag = hashlib.sha256(fh.read()).hexdigest()[:12]
    so = os.path.join(BUILD_DIR, f"lib{name}_{tag}.so")
    if not os.path.isfile(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [os.environ.get("CXX", "g++"), "-O3", "-fPIC", "-shared",
               "-o", tmp, src, *libs]
        try:
            r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        except OSError as e:
            raise RuntimeError(f"cannot build the {what}: {e}") from e
        if r.returncode != 0:
            raise RuntimeError(f"building the {what} failed "
                               f"({' '.join(cmd)}):\n{r.stderr}")
        os.replace(tmp, so)
    try:
        lib = ctypes.CDLL(so)
    except OSError as e:
        raise RuntimeError(f"cannot load the {what} ({so}): {e}") from e
    if not hasattr(lib, symbol):
        raise RuntimeError(f"{so} has no symbol {symbol}")
    return lib


def planes_lib() -> ctypes.CDLL:
    """The BGEN plane extractor library (io/csrc/bgen_planes.cpp), built
    with g++ at first use and cached by the source's hash. Raises
    RuntimeError when it cannot be built or lacks PLANES_SYMBOL."""
    lib = _state["planes"]
    if lib is not None:
        return lib
    lib = _build_lib("bgen_planes", "BGEN plane extractor", PLANES_SYMBOL,
                     ["-lz", "-ldl"])
    fn = getattr(lib, PLANES_SYMBOL)
    fn.restype = ctypes.c_int64
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.bgen_zstd_open.restype = ctypes.c_int
    lib.bgen_zstd_open.argtypes = [ctypes.c_char_p]
    _state["planes"] = lib
    return lib


def require_zstd() -> None:
    """Make the plane extractor read zstd records: load ZSTD_SONAME's
    ZSTD_decompress into it, once. Raises RuntimeError when the library
    cannot be loaded (zlib files never need it)."""
    if _state["zstd"] == ZSTD_SONAME:
        return
    if not planes_lib().bgen_zstd_open(ZSTD_SONAME.encode()):
        raise RuntimeError(
            f"zstd-compressed BGEN needs {ZSTD_SONAME} (ZSTD_decompress), "
            "which cannot be loaded on this machine")
    _state["zstd"] = ZSTD_SONAME


def bgen12_extract_planes_native(comp: bytes, offsets, csizes, usizes,
                                 n_samples: int, compression: int) -> np.ndarray:
    """Inflate-only BGEN v1.2 8-bit plane extraction: [B, 2, N] uint8 (k0
    plane, k1 plane; missing samples = 255/255), the variants split over
    one thread per CPU (ctypes releases the GIL during each call). Raises
    RuntimeError when any variant of the block is rejected (not zlib or
    zstd, not unphased diploid biallelic 8-bit, or a clipped probability
    pair), or for zstd (compression 2) when libzstd cannot be loaded."""
    fn = getattr(planes_lib(), PLANES_SYMBOL)
    if compression == 2:
        require_zstd()
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
            "(the port reads only zlib- or zstd-compressed, unphased "
            "diploid, biallelic 8-bit layout-2 blocks with probabilities "
            "summing to at most 1)")
    return planes


def loco_lib() -> ctypes.CDLL:
    """The LOCO row renderer (io/csrc/loco_rows.cpp), built with g++ at
    first use and cached by the source's hash. Raises RuntimeError when
    it cannot be built or loaded, or lacks LOCO_SYMBOL."""
    lib = _state["loco"]
    if lib is not None:
        return lib
    lib = _build_lib("loco_rows", "LOCO row renderer", LOCO_SYMBOL)
    fn = getattr(lib, LOCO_SYMBOL)
    fn.restype = ctypes.c_int64
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p]
    lib.loco_rows_budget.restype = ctypes.c_int64
    lib.loco_rows_budget.argtypes = [ctypes.c_int64, ctypes.c_int64]
    _state["loco"] = lib
    return lib


def pgen_lib() -> ctypes.CDLL:
    """The PGEN block decoder (io/csrc/pgen_bytes.cpp), built with g++ at
    first use and cached by the source's hash. Raises RuntimeError when
    it cannot be built or loaded, or lacks PGEN_SYMBOL."""
    lib = _state["pgen"]
    if lib is not None:
        return lib
    lib = _build_lib("pgen_bytes", "PGEN block decoder", PGEN_SYMBOL, ["-pthread"])
    fn = getattr(lib, PGEN_SYMBOL)
    fn.restype = ctypes.c_int64
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
    ]
    _state["pgen"] = lib
    return lib


def pgen_bed_bytes_native(pf, vidx, keep=None) -> np.ndarray:
    """A block of PGEN hardcalls as BED-coded packed bytes: [B, ceil(n /
    4)] uint8 on the kept-sample axis (n = len(keep), or every sample of
    the file when keep is None). `pf` is an io.pgen.PgenFile, `vidx` the
    variants' indices in the file. Raises RuntimeError when any variant of
    the block cannot be decoded (multiallelic, or a record out of the
    file's bounds)."""
    fn = getattr(pgen_lib(), PGEN_SYMBOL)
    data = np.frombuffer(pf._data, np.uint8)
    fpos = np.ascontiguousarray(pf.fpos, np.int64)
    vrtypes = np.ascontiguousarray(pf.vrtypes, np.uint8)
    if fpos.shape != vrtypes.shape:
        raise ValueError(f"{pf.path}: {len(fpos)} record offsets for "
                         f"{len(vrtypes)} record types")
    vidx = np.ascontiguousarray(vidx, np.int64)
    if keep is not None:
        keep = np.ascontiguousarray(keep, np.int64)
    n_out = pf.n_samples_file if keep is None else len(keep)
    out = np.empty((len(vidx), (n_out + 3) // 4), np.uint8)
    nfail = fn(data.ctypes.data, len(data), fpos.ctypes.data,
               vrtypes.ctypes.data, len(vrtypes), vidx.ctypes.data, len(vidx),
               pf.n_samples_file,
               None if keep is None else keep.ctypes.data,
               0 if keep is None else len(keep), os.cpu_count() or 1,
               out.ctypes.data)
    if nfail > 0:
        raise RuntimeError(
            f"PGEN block decoding rejected {nfail} of {len(vidx)} variants "
            f"of {pf.path} (multiallelic, or a record out of the file's "
            "bounds)")
    return out
