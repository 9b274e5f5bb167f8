"""ctypes bindings of native code (the port's copy of
regenie_tpu/io/native.py, trimmed to what the ported paths call).

- The root native library (native/decoder.cpp): the BED decoder and the
  .regenie / HTP row formatters. libregenie_native.so is built with
  `make -C native` on first use when the toolchain (zlib and zstd
  headers) is there; every caller falls back to its numpy or per-row
  Python path when the library is missing.
- The BGEN plane extractor, the port's own copy in io/csrc/bgen_planes.cpp
  (built against zlib alone; zstd records take ZSTD_decompress from
  libzstd.so.1 at run time, require_zstd), and in the same library the
  BGEN dosage decoder io/csrc/bgen_dosages.cpp (every layout, bit depth
  and compression; -ffp-contract=off, so its values equal numpy's
  expression order): built with g++ into regenie_tpu_torch/_build/
  (git-ignored) at first use. BGEN has no other reader, so a failed
  build, a missing symbol or a zstd file without the library raises. A
  block the extractor rejects raises PlanesRejected, on which a Step-2
  run moves to the dense route; a record the dosage decoder rejects
  raises RuntimeError.
- The LOCO/PRS row renderer, the port's own copy of format_loco_rows in
  io/csrc/loco_rows.cpp (single-threaded; callers split the rows over
  threads), built the same way. Step 1 has no other renderer at biobank
  scale, so a failed build or load raises.
- The PGEN block decoder, io/csrc/pgen_bytes.cpp (std::thread over
  variants), built the same way: PGEN hardcalls to BED-coded packed
  bytes on the kept-sample axis, or float64 ALT dosages from the 16-bit
  dosage tracks. Both steps read PGEN only through it, so a failed
  build, load or record raises.
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
DOSAGES_SYMBOL = "bgen_decode_dosages"
LOCO_SYMBOL = "format_loco_rows"
ZSTD_SONAME = "libzstd.so.1"
PGEN_SYMBOL = "pgen_bed_bytes"
PGEN_DOSAGES_SYMBOL = "pgen_dosages"
# the dosage decoder's status codes (bgen_dosages.cpp)
BGEN_REJECT = {1: "inflate failed or its size does not match",
               2: "sample count, allele count or ploidy range unexpected",
               3: "bit depth outside 1..32",
               4: "probabilities reach past the record",
               5: "unsupported layout"}
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


def _build_lib(name: str, what: str, symbol: str, libs=(),
               extra=()) -> ctypes.CDLL:
    """io/csrc/<name>.cpp (with io/csrc/<e>.cpp for each name in `extra`,
    into one library) built with g++ into BUILD_DIR at first use, cached
    by the sources' hash, and loaded. Raises RuntimeError when it cannot
    be built or loaded, or lacks `symbol`."""
    srcs = [os.path.join(_CSRC, f"{n}.cpp") for n in (name, *extra)]
    h = hashlib.sha256()
    for src in srcs:
        with open(src, "rb") as fh:
            h.update(fh.read())
    tag = h.hexdigest()[:12]
    so = os.path.join(BUILD_DIR, f"lib{name}_{tag}.so")
    if not os.path.isfile(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        # no -ffast-math, and no fused multiply-adds: the BGEN dosages
        # must round as numpy's expressions do
        cmd = [os.environ.get("CXX", "g++"), "-O3", "-ffp-contract=off",
               "-fPIC", "-shared", "-o", tmp, *srcs, *libs]
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
    """The BGEN library: the plane extractor (io/csrc/bgen_planes.cpp)
    and the dosage decoder (io/csrc/bgen_dosages.cpp), built with g++ at
    first use and cached by the sources' hash. Raises RuntimeError when
    it cannot be built or lacks PLANES_SYMBOL or DOSAGES_SYMBOL."""
    lib = _state["planes"]
    if lib is not None:
        return lib
    lib = _build_lib("bgen_planes", "BGEN plane extractor", PLANES_SYMBOL,
                     ["-lz", "-ldl"], extra=["bgen_dosages"])
    if not hasattr(lib, DOSAGES_SYMBOL):
        raise RuntimeError(f"the BGEN library has no symbol {DOSAGES_SYMBOL}")
    fn = getattr(lib, PLANES_SYMBOL)
    fn.restype = ctypes.c_int64
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
    ]
    fn = getattr(lib, DOSAGES_SYMBOL)
    fn.restype = ctypes.c_int64
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p,
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


class PlanesRejected(RuntimeError):
    """The plane extractor rejected records of a block (not 8-bit
    unphased layout 2, or a clipped probability pair): a Step-2 run
    scores that block and the rest of the file on the dense route."""


def _ranges(n: int):
    """(lo, hi) bounds splitting n items over one thread per CPU."""
    b = np.linspace(0, n, min(os.cpu_count() or 1, max(n, 1)) + 1).astype(int)
    return b[:-1], b[1:]


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

    lo, hi = _ranges(n_var)
    with ThreadPoolExecutor(len(lo)) as pool:
        nfail = sum(pool.map(run, lo, hi))
    if nfail > 0:
        raise PlanesRejected(
            f"BGEN plane extraction rejected {nfail} of {n_var} variants "
            "(the port reads only zlib- or zstd-compressed, unphased "
            "diploid, biallelic 8-bit layout-2 blocks with probabilities "
            "summing to at most 1)")
    return planes


def bgen_decode_dosages_native(comp, offsets, csizes, usizes, n_samples: int,
                               layout: int, compression: int, ref_first: bool,
                               keep=None):
    """BGEN dosages of a block of records through io/csrc/bgen_dosages.cpp:
    (dosage [B, n] float64 with missing = -3, INFO numerator [B, n],
    status [B] uint8: 0, or a BGEN_REJECT code) on the kept samples (n =
    len(keep), or every sample of the file when keep is None). `comp`
    holds the records' payloads (for compressed layout-2 records, after
    their 4-byte size), at `offsets`, of `csizes` bytes, inflating to
    `usizes`. The variants run over one thread per CPU (ctypes releases
    the GIL during each call); a rejected variant's rows are left
    unwritten, and the caller raises for it."""
    fn = getattr(planes_lib(), DOSAGES_SYMBOL)
    if compression == 2:
        require_zstd()
    n_var = len(offsets)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    csizes = np.ascontiguousarray(csizes, dtype=np.int64)
    usizes = np.ascontiguousarray(usizes, dtype=np.int64)
    if keep is not None:
        keep = np.ascontiguousarray(keep, dtype=np.int64)
        if len(keep) and (keep.min() < 0 or keep.max() >= n_samples):
            raise ValueError("sample index out of the file's range")
    n_out = n_samples if keep is None else len(keep)
    dosage = np.empty((n_var, n_out))
    info = np.empty((n_var, n_out))
    status = np.zeros(n_var, dtype=np.uint8)
    comp_buf = np.frombuffer(comp, dtype=np.uint8)
    if len(offsets) and (offsets.min() < 0
                         or (offsets + csizes).max() > len(comp_buf)):
        raise ValueError("record extent out of the buffer")

    def run(lo, hi):
        return fn(comp_buf.ctypes.data, offsets[lo:].ctypes.data,
                  csizes[lo:].ctypes.data, usizes[lo:].ctypes.data, hi - lo,
                  n_samples, layout, compression, int(bool(ref_first)),
                  None if keep is None else keep.ctypes.data, n_out,
                  dosage[lo:].ctypes.data, info[lo:].ctypes.data,
                  status[lo:].ctypes.data)

    lo, hi = _ranges(n_var)
    with ThreadPoolExecutor(len(lo)) as pool:
        list(pool.map(run, lo, hi))
    return dosage, info, status


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
    if not hasattr(lib, PGEN_DOSAGES_SYMBOL):
        raise RuntimeError(f"the PGEN decoder has no symbol {PGEN_DOSAGES_SYMBOL}")
    for name in (PGEN_SYMBOL, PGEN_DOSAGES_SYMBOL):
        fn = getattr(lib, name)
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
    return _pgen_block(pf, vidx, keep, PGEN_SYMBOL, "block decoding")


def pgen_dosages_native(pf, vidx, keep=None) -> np.ndarray:
    """A block of PGEN ALT dosages: [B, n] float64, missing = -3, on the
    kept-sample axis as in pgen_bed_bytes_native; the 16-bit dosage
    tracks (vrtype 0x20, 0x40, 0x60) override the hardcalls. Raises
    RuntimeError when any variant cannot be decoded (multiallelic, or a
    record or dosage track out of the file's bounds)."""
    return _pgen_block(pf, vidx, keep, PGEN_DOSAGES_SYMBOL, "dosage decoding")


def _pgen_block(pf, vidx, keep, symbol, what) -> np.ndarray:
    fn = getattr(pgen_lib(), symbol)
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
    out = (np.empty((len(vidx), (n_out + 3) // 4), np.uint8)
           if symbol == PGEN_SYMBOL else np.empty((len(vidx), n_out)))
    nfail = fn(data.ctypes.data, len(data), fpos.ctypes.data,
               vrtypes.ctypes.data, len(vrtypes), vidx.ctypes.data, len(vidx),
               pf.n_samples_file,
               None if keep is None else keep.ctypes.data,
               0 if keep is None else len(keep), os.cpu_count() or 1,
               out.ctypes.data)
    if nfail > 0:
        raise RuntimeError(
            f"PGEN {what} rejected {nfail} of {len(vidx)} variants "
            f"of {pf.path} (multiallelic, or a record out of the file's "
            "bounds)")
    return out
