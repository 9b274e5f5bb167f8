"""PLINK BED/BIM/FAM reader (the port's copy of regenie_tpu/io/bed.py).

Replaces the reference's BED path (`read_bed_bim_fam` Geno.cpp:498,
`parseSnpfromBed` Geno.cpp:2414, `buildLookupTable` Geno.cpp:2833). The
fused Step-2 scorer consumes the packed bytes as they are on disk
(read_block_bytes); decode_bed_bytes is the host decode of the same
bytes.

Genotype coding ('ref-last', matching the reference):
  bed bits 00 -> 2 (hom alt)   10 -> -3 (missing)
  bed bits 01 -> 1 (het)       11 -> 0 (hom ref)
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from .files import iter_lines

BED_MAGIC = b"\x6c\x1b\x01"
MISSING_GENO = -3.0

# 256-entry x 4-sample decode LUT (Geno.cpp:2833-2857)
_MAP = np.array([2, -3, 1, 0], dtype=np.int8)
_LUT = np.zeros((256, 4), dtype=np.int8)
for _b in range(256):
    for _j in range(4):
        _LUT[_b, _j] = _MAP[(_b >> (_j * 2)) & 3]


@dataclass(slots=True)
class SnpInfo:
    """Per-variant metadata (reference `struct snp`, Geno.hpp:47-62)."""

    chrom: int
    ID: str
    genpos: float
    physpos: int
    allele1: str  # ref (bim col 6 for ref-last)
    allele2: str  # alt / effect allele
    offset: int = 0  # variant index in file
    keep: bool = True
    mac_fail_if_checked: bool = True  # --extract-or/--exclude-or gate
    forced_mac_filter: bool = False  # --force-mac-filter member


@dataclass(slots=True)
class SampleInfo:
    FID: str
    IID: str
    sex: int = 0
    key: str = ""  # "FID_IID" map key (getIndivIndex convention)

    def __post_init__(self):
        if not self.key:
            self.key = f"{self.FID}_{self.IID}"


@dataclass
class BedFile:
    prefix: str
    snps: List[SnpInfo] = field(default_factory=list)
    samples: List[SampleInfo] = field(default_factory=list)
    _fh: Optional[object] = None
    _bytes_per_snp: int = 0

    @property
    def n_samples(self) -> int:
        return len(self.samples)

    @property
    def n_variants(self) -> int:
        return len(self.snps)

    def open(self):
        bed_path = self.prefix + ".bed"
        self._fh = open(bed_path, "rb")
        magic = self._fh.read(3)
        if magic != BED_MAGIC:
            raise ValueError(f"{bed_path}: not a SNP-major PLINK .bed file")
        self._bytes_per_snp = (self.n_samples + 3) // 4
        expected = 3 + self._bytes_per_snp * self.n_variants
        actual = os.path.getsize(bed_path)
        if actual != expected:
            raise ValueError(
                f"{bed_path}: size {actual} != expected {expected} "
                f"(N={self.n_samples}, M={self.n_variants})"
            )
        # mmap the genotype matrix: block reads become zero-copy views
        # into the page cache that go straight to the device transfer
        try:
            import mmap as _mmap

            self._mm = _mmap.mmap(self._fh.fileno(), 0,
                                  access=_mmap.ACCESS_READ)
        except (OSError, ValueError):
            self._mm = None
        return self

    def close(self):
        mm = getattr(self, "_mm", None)
        if mm is not None:
            self._mm = None
            try:
                mm.close()
            except BufferError:
                pass  # live zero-copy views; the mapping is released
                # by the OS when the last view is garbage-collected
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def read_block_bytes(self, start: int, count: int) -> np.ndarray:
        """Raw packed bytes for `count` consecutive variants: [count,
        ceil(N/4)] uint8 — a zero-copy mmap view when available."""
        assert self._fh is not None, "call open() first"
        if getattr(self, "_mm", None) is not None:
            off = 3 + start * self._bytes_per_snp
            return np.frombuffer(
                self._mm, dtype=np.uint8, count=count * self._bytes_per_snp,
                offset=off).reshape(count, self._bytes_per_snp)
        self._fh.seek(3 + start * self._bytes_per_snp)
        buf = self._fh.read(count * self._bytes_per_snp)
        return np.frombuffer(buf, dtype=np.uint8).reshape(count, self._bytes_per_snp)


def decode_bed_bytes(raw: np.ndarray, n_samples: int) -> np.ndarray:
    """[B, bytes] uint8 -> [B, N] int8 via the 256x4 LUT.

    Uses the native OpenMP decoder (native/decoder.cpp) when built,
    falling back to the numpy LUT path otherwise."""
    from .native import bed_decode_native

    out = bed_decode_native(raw, n_samples)
    if out is not None:
        return out
    block = _LUT[raw].reshape(raw.shape[0], -1)
    return block[:, :n_samples]


def encode_bed_bytes(G: np.ndarray) -> np.ndarray:
    """[B, N] additive hardcalls {0, 1, 2, -3} -> [B, ceil(N/4)] packed
    2-bit BED codes, the exact inverse of decode_bed_bytes and
    ops.geno_ops.decode_bed_packed (ref-last coding: 2->00, -3->01,
    1->10, 0->11; write_genovec, Masks.cpp:1177). The gene-based VC
    products ship scattered hardcall variants to the device this way
    (ops/vc_batch.py)."""
    G = np.asarray(G)
    B, N = G.shape
    codes = np.where(
        G == 2, 0, np.where(G == -3, 1, np.where(G == 1, 2, 3))
    ).astype(np.uint8)
    pad = (-N) % 4
    if pad:
        codes = np.concatenate([codes, np.zeros((B, pad), np.uint8)], axis=1)
    codes = codes.reshape(B, -1, 4)
    return (codes[:, :, 0] | (codes[:, :, 1] << 2) | (codes[:, :, 2] << 4)
            | (codes[:, :, 3] << 6)).astype(np.uint8)


def read_bim(path: str, ref_first: bool = False) -> List[SnpInfo]:
    """.bim: CHR ID GENPOS PHYSPOS A1 A2. Default ref-last (col6 = ref);
    with --ref-first col5 is the reference allele (Geno.cpp:44-49)."""
    snps = []
    for i, toks in enumerate(iter_lines(path)):
        if len(toks) != 6:
            raise ValueError(f"{path}: line {i+1} has {len(toks)} columns, expected 6")
        a_ref, a_alt = (toks[4], toks[5]) if ref_first else (toks[5], toks[4])
        snps.append(
            SnpInfo(
                chrom=chr_to_int(toks[0]),
                ID=toks[1],
                genpos=float(toks[2]),
                physpos=int(toks[3]),
                allele1=a_ref,  # ALLELE0 = reference
                allele2=a_alt,  # ALLELE1 = effect
                offset=i,
            )
        )
    return snps


def read_fam(path: str) -> List[SampleInfo]:
    samples = []
    for toks in iter_lines(path):
        sex = 0
        if len(toks) >= 5:
            try:
                sex = int(toks[4])
            except ValueError:
                sex = 0
        samples.append(SampleInfo(FID=toks[0], IID=toks[1], sex=sex))
    return samples


def chr_to_int(chrom: str, n_chrom: int = 23) -> int:
    """Chromosome string to int (reference chrStrToInt, Regenie.cpp)."""
    c = chrom
    if c.upper().startswith("CHR"):
        c = c[3:]
    if c in ("X", "x", "XY", "PAR1", "PAR2"):
        return n_chrom
    try:
        v = int(c)
    except ValueError:
        return -1
    return v if 0 < v <= n_chrom else -1


def open_bed(prefix: str, ref_first: bool = False) -> BedFile:
    bf = BedFile(prefix=prefix, snps=read_bim(prefix + ".bim", ref_first), samples=read_fam(prefix + ".fam"))
    return bf.open()
