"""BGEN v1.1/v1.2 reader (the port's copy of regenie_tpu/io/bgen.py).

The variant index is scanned once up front (or read from the .bgi sqlite
index); each block's genotype records are then read as bytes, in one
read of the block's span of the file, and handed to native code
(io/native.py): the plane extractor inflates 8-bit layout-2 records into
[B, 2, N_file] uint8 probability planes for the fused scorer, and the
dosage decoder (io/csrc/bgen_dosages.cpp) turns records of any layout,
bit depth and compression into [B, N] float64 dosages and INFO
numerators for the dense route and Step 1. The parsing decoders
(decode_variant, _decode_layout2, _decode_layout1, _unpack_bits) are
the dosage decoder's plain versions, for the tests.

Allele convention (ref-last default, Geno.cpp:44-49): allele0 in the
file is treated as ALT; dosage = p1 + 2*p0. With --ref-first the dosage
counts the last allele: p1 + 2*p2.
"""

from __future__ import annotations

import ctypes
import sqlite3
import struct
import zlib
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from ..config import Params
from .bed import SampleInfo, SnpInfo, chr_to_int
from .native import (BGEN_REJECT, PlanesRejected, ZSTD_SONAME,
                     bgen12_extract_planes_native, bgen_decode_dosages_native)


@dataclass
class BgenVariant:
    geno_offset: int  # file offset of the genotype block
    geno_size: int  # compressed size field (layout2: C incl. 4-byte D)


@dataclass
class BgenFile:
    path: str
    n_samples_file: int = 0
    n_variants: int = 0
    layout: int = 2
    compression: int = 1  # 0 none, 1 zlib, 2 zstd
    has_sample_ids: bool = False
    sample_ids: List[Tuple[str, str]] = field(default_factory=list)
    snps: List[SnpInfo] = field(default_factory=list)
    variants: List[BgenVariant] = field(default_factory=list)
    _fh: Optional[object] = None

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None


def open_bgen(path: str, n_chrom: int = 23, ref_first: bool = False,
              bgi_file: str | None = None) -> BgenFile:
    bf = BgenFile(path=path)
    fh = open(path, "rb")
    bf._fh = fh
    offset, hlen, M, N = struct.unpack("<IIII", fh.read(16))
    magic = fh.read(4)
    if magic not in (b"bgen", b"\x00\x00\x00\x00"):
        raise ValueError(f"{path}: not a BGEN file")
    fh.seek(4 + hlen - 4)
    (flags,) = struct.unpack("<I", fh.read(4))
    bf.compression = flags & 3
    bf.layout = (flags >> 2) & 0xF
    bf.has_sample_ids = bool(flags >> 31)
    bf.n_samples_file = N
    bf.n_variants = M
    if bf.layout not in (1, 2):
        raise ValueError(f"unsupported BGEN layout {bf.layout}")

    if bf.has_sample_ids:
        fh.seek(4 + hlen)
        _lsi, n_s = struct.unpack("<II", fh.read(8))
        for _ in range(n_s):
            (l,) = struct.unpack("<H", fh.read(2))
            sid = fh.read(l).decode()
            bf.sample_ids.append((sid, sid))

    # .bgi sqlite index: skip the O(file) variant scan
    # (read_bgi_file, Geno.cpp:180)
    if bgi_file and bf.layout == 2:
        con = sqlite3.connect(bgi_file)
        rows = con.execute(
            "SELECT chromosome, position, rsid, number_of_alleles, allele1, "
            "allele2, file_start_position, size_in_bytes FROM Variant "
            "ORDER BY file_start_position"
        ).fetchall()
        con.close()
        if len(rows) != M:
            raise ValueError(f"{bgi_file}: index lists {len(rows)} variants, "
                             f"bgen header says {M}")
        for i, (chrom, pos, rsid, n_all, a1v, a2v, fpos, _fsize) in enumerate(rows):
            if n_all != 2:
                raise ValueError(f"{rsid}: only bi-allelic variants supported")
            # genotype block: last 4+C bytes of the record; parse the
            # variant header to find it
            fh.seek(fpos)
            lid = struct.unpack("<H", fh.read(2))[0]
            fh.seek(lid, 1)
            lrsid = struct.unpack("<H", fh.read(2))[0]
            fh.seek(lrsid, 1)
            lchr = struct.unpack("<H", fh.read(2))[0]
            fh.seek(lchr + 4 + 2, 1)  # chrom str + pos + n_alleles
            for _ in range(2):
                (la,) = struct.unpack("<I", fh.read(4))
                fh.seek(la, 1)
            (csize,) = struct.unpack("<I", fh.read(4))
            geno_off = fh.tell()
            a1, a2 = (a1v, a2v) if ref_first else (a2v, a1v)
            bf.snps.append(SnpInfo(
                chrom=chr_to_int(str(chrom), n_chrom), ID=rsid, genpos=0.0,
                physpos=int(pos), allele1=a1, allele2=a2, offset=i,
            ))
            bf.variants.append(BgenVariant(geno_offset=geno_off, geno_size=csize))
        return bf

    # scan variant index (prep_bgen, Geno.cpp:24-100)
    fh.seek(offset + 4)
    for i in range(M):
        if bf.layout == 1:
            (_n_row,) = struct.unpack("<I", fh.read(4))
        lid = struct.unpack("<H", fh.read(2))[0]
        fh.read(lid)
        lrsid = struct.unpack("<H", fh.read(2))[0]
        rsid = fh.read(lrsid).decode()
        lchr = struct.unpack("<H", fh.read(2))[0]
        chrom = fh.read(lchr).decode()
        (pos,) = struct.unpack("<I", fh.read(4))
        if bf.layout == 2:
            (n_alleles,) = struct.unpack("<H", fh.read(2))
        else:
            n_alleles = 2
        alleles = []
        for _ in range(n_alleles):
            (la,) = struct.unpack("<I", fh.read(4))
            alleles.append(fh.read(la).decode())
        if n_alleles != 2:
            raise ValueError(f"{rsid}: only bi-allelic variants supported")
        if bf.layout == 2:
            (csize,) = struct.unpack("<I", fh.read(4))
            geno_off = fh.tell()
            fh.seek(csize, 1)
        else:
            if bf.compression == 1:
                (csize,) = struct.unpack("<I", fh.read(4))
            else:
                csize = 6 * bf.n_samples_file
            geno_off = fh.tell()
            fh.seek(csize, 1)
        if ref_first:
            a1, a2 = alleles[0], alleles[1]
        else:
            a1, a2 = alleles[1], alleles[0]  # allele0 treated as ALT
        bf.snps.append(
            SnpInfo(
                chrom=chr_to_int(chrom, n_chrom), ID=rsid, genpos=0.0,
                physpos=pos, allele1=a1, allele2=a2, offset=i,
            )
        )
        bf.variants.append(BgenVariant(geno_offset=geno_off, geno_size=csize))
    return bf


def planes_readable(bf: BgenFile) -> bool:
    """Whether the fused route can read this file's records at all: the
    plane extractor takes layout 2 (v1.2) with zlib or zstd compression.
    Whether each record is 8-bit unphased diploid is known only when its
    block is inflated (extract_planes_block raises PlanesRejected)."""
    return bf.layout == 2 and bf.compression in (1, 2)


def _read_records(bf: BgenFile, indices):
    """The genotype records of variants `indices`: (buffer, offsets,
    compressed sizes, inflated sizes) of their payloads, the 4-byte size
    field of a compressed layout-2 record skipped. The block's span of
    the file is read in one call when the records lie close together,
    else each record on its own."""
    vs = [bf.variants[i] for i in indices]
    starts = np.array([v.geno_offset for v in vs], np.int64)
    sizes = np.array([v.geno_size for v in vs], np.int64)
    if not vs:
        return b"", starts, sizes, sizes.copy()
    lo, hi = int(starts.min()), int((starts + sizes).max())
    if hi - lo <= 2 * int(sizes.sum()) + (1 << 20):
        bf._fh.seek(lo)
        buf = bf._fh.read(hi - lo)
        offs = starts - lo
    else:
        parts = []
        for v in vs:
            bf._fh.seek(v.geno_offset)
            parts.append(bf._fh.read(v.geno_size))
        buf = b"".join(parts)
        offs = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    if len(buf) < int((offs + sizes).max()):
        raise ValueError(f"{bf.path}: genotype records reach past the file")
    if bf.layout == 1:
        return buf, offs, sizes, np.full(len(vs), 6 * bf.n_samples_file, np.int64)
    if bf.compression == 0:
        return buf, offs, sizes, sizes.copy()
    usizes = np.array([struct.unpack_from("<I", buf, int(o))[0] for o in offs],
                      np.int64)
    return buf, offs + 4, sizes - 4, usizes


def extract_planes_block(bf: BgenFile, indices) -> np.ndarray:
    """Inflate-only plane extraction for the fused scorer: [B, 2, N_file]
    uint8 probability planes (k0, k1; missing = 255/255). Keeps the FILE
    sample axis; sample subsetting happens through zeroed operand rows on
    the device. Raises PlanesRejected when the file or any record of the
    block is outside what the extractor reads (the dense route reads
    it), RuntimeError for a zstd file without libzstd."""
    if not planes_readable(bf):
        raise PlanesRejected(
            f"BGEN layout {bf.layout} with compression {bf.compression}: the "
            "plane extractor reads zlib- or zstd-compressed layout-2 files")
    buf, offs, cs, us = _read_records(bf, indices)
    return bgen12_extract_planes_native(buf, offs, cs, us, bf.n_samples_file,
                                        bf.compression)


def decode_block(bf: BgenFile, indices, keep_idx: Optional[np.ndarray],
                 ref_first: bool):
    """Dosages of a block of variants through the native dosage decoder
    (the JAX package's decode_block_native, widened to every layout, bit
    depth and compression): (dosage [B, N_kept] float64 with missing =
    -3, info_num [B, N_kept], the per-sample INFO numerator). Raises
    RuntimeError naming the first variant whose record it cannot decode:
    there is no other reader."""
    indices = list(indices)
    buf, offs, cs, us = _read_records(bf, indices)
    ds, iv, status = bgen_decode_dosages_native(
        buf, offs, cs, us, bf.n_samples_file, bf.layout, bf.compression,
        ref_first, keep_idx)
    bad = np.flatnonzero(status)
    if len(bad):
        k = int(bad[0])
        raise RuntimeError(
            f"{bf.path}: the BGEN record of variant {bf.snps[indices[k]].ID} "
            f"cannot be decoded ({BGEN_REJECT.get(int(status[k]), 'rejected')});"
            f" {len(bad)} of {len(indices)} variants of the block rejected")
    return ds, iv


# ---- the dosage decoder's plain versions (tests only) ----
_zstd = None


def _get_zstd():
    global _zstd
    if _zstd is None:
        lib = ctypes.CDLL(ZSTD_SONAME)
        lib.ZSTD_decompress.restype = ctypes.c_size_t
        lib.ZSTD_decompress.argtypes = [
            ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_size_t,
        ]
        lib.ZSTD_isError.restype = ctypes.c_uint
        _zstd = lib
    return _zstd


def zstd_decompress(data: bytes, outsize: int) -> bytes:
    lib = _get_zstd()
    out = ctypes.create_string_buffer(outsize)
    n = lib.ZSTD_decompress(out, outsize, data, len(data))
    if lib.ZSTD_isError(ctypes.c_size_t(n)) or n != outsize:
        raise ValueError("zstd decompression failed")
    return out.raw


def _decompress(bf: BgenFile, raw: bytes, outsize: int) -> bytes:
    if bf.compression == 0:
        return raw
    if bf.compression == 1:
        out = zlib.decompress(raw)
        if len(out) != outsize:
            raise ValueError("zlib decompression size mismatch")
        return out
    return zstd_decompress(raw, outsize)


def decode_variant(bf: BgenFile, idx: int, keep_idx: Optional[np.ndarray], ref_first: bool):
    """Decode one variant -> (dosage [N_kept], info_num [N_kept]).

    Missing dosage = -3 (parseSnpfromBGEN, Geno.cpp:2263)."""
    v = bf.variants[idx]
    bf._fh.seek(v.geno_offset)
    Nf = bf.n_samples_file
    if bf.layout == 2:
        raw = bf._fh.read(v.geno_size)
        if bf.compression:
            (outsize,) = struct.unpack("<I", raw[:4])
            data = _decompress(bf, raw[4:], outsize)
        else:
            data = raw
        return _decode_layout2(data, Nf, keep_idx, ref_first)
    raw = bf._fh.read(v.geno_size)
    data = zlib.decompress(raw) if bf.compression == 1 else raw
    return _decode_layout1(data, Nf, keep_idx, ref_first)


def _decode_layout2(data: bytes, Nf: int, keep_idx, ref_first: bool):
    nindivs, n_alleles = struct.unpack("<IH", data[:6])
    if nindivs != Nf or n_alleles != 2:
        raise ValueError("unexpected genotype block contents")
    minp, maxp = data[6], data[7]
    if minp != 2 or maxp != 2:
        raise ValueError("only diploid unphased BGEN supported")
    ploidy = np.frombuffer(data, dtype=np.uint8, count=Nf, offset=8)
    phased = data[8 + Nf]
    bits = data[9 + Nf]
    body = np.frombuffer(data, dtype=np.uint8, offset=10 + Nf)
    missing = (ploidy & 0x80) != 0
    if bits == 8:
        probs = body[: 2 * Nf].reshape(Nf, 2).astype(np.float64) / 255.0
    elif bits == 16:
        probs = (
            np.frombuffer(body.tobytes(), dtype="<u2", count=2 * Nf)
            .reshape(Nf, 2).astype(np.float64) / 65535.0
        )
    else:
        probs = _unpack_bits(body, Nf * 2, bits).reshape(Nf, 2) / (2.0**bits - 1)
    if phased != 0:
        # phased diploid biallelic: one stored probability per haplotype
        # = P(hap carries allele1), collapsed to genotype probabilities by
        # the haplotype product
        h1, h2 = probs[:, 0], probs[:, 1]
        p0 = h1 * h2
        p2 = (1.0 - h1) * (1.0 - h2)
        p1 = np.maximum(1.0 - p0 - p2, 0.0)
    else:
        p0, p1 = probs[:, 0], probs[:, 1]
        p2 = np.maximum(1.0 - p0 - p1, 0.0)
    if ref_first:
        ds = p1 + 2 * p2
        ival = 4 * p2 + p1 - ds * ds
    else:
        ds = p1 + 2 * p0
        ival = 4 * p0 + p1 - ds * ds
    ds = np.where(missing, -3.0, ds)
    ival = np.where(missing, 0.0, ival)
    if keep_idx is not None:
        ds, ival = ds[keep_idx], ival[keep_idx]
    return ds, ival


def _decode_layout1(data: bytes, Nf: int, keep_idx, ref_first: bool):
    """v1.1: 3 x uint16 probabilities / 32768 (BgenParser path,
    bgen_to_vcf.hpp)."""
    probs = (
        np.frombuffer(data, dtype="<u2", count=3 * Nf).reshape(Nf, 3).astype(np.float64)
        / 32768.0
    )
    pAA, pAB, pBB = probs[:, 0], probs[:, 1], probs[:, 2]
    missing = (pAA + pAB + pBB) == 0
    if ref_first:
        ds = pAB + 2 * pBB
        ival = 4 * pBB + pAB - ds * ds
    else:
        ds = pAB + 2 * pAA
        ival = 4 * pAA + pAB - ds * ds
    ds = np.where(missing, -3.0, ds)
    ival = np.where(missing, 0.0, ival)
    if keep_idx is not None:
        ds, ival = ds[keep_idx], ival[keep_idx]
    return ds, ival


def _unpack_bits(body: np.ndarray, n_values: int, bits: int) -> np.ndarray:
    """General B-bit unpacking (rare path)."""
    bitarr = np.unpackbits(body[: (n_values * bits + 7) // 8], bitorder="little")
    bitarr = bitarr[: n_values * bits].reshape(n_values, bits)
    weights = (1 << np.arange(bits)).astype(np.float64)
    return bitarr @ weights


def read_sample_file(path: str):
    """Oxford .sample file: 2 header lines, then ID_1 ID_2 [missing sex].
    Returns (ids, sex): sex from the 4th column (1=male, 2=female,
    0/NA=unknown — read_bgen_sample, Geno.cpp:439-443), zeros when the
    column is absent."""
    ids = []
    sexes = []
    with open(path) as fh:
        fh.readline()
        fh.readline()
        for line in fh:
            toks = line.split()
            if not toks:
                continue
            ids.append((toks[0], toks[1]))
            if len(toks) >= 4:
                s = toks[3]
                if s in ("0", "NA"):
                    sexes.append(0)
                elif s in ("1", "2"):
                    sexes.append(int(s))
                else:
                    raise ValueError(
                        f"unrecognized sex code in file : '{s}'")
            else:
                sexes.append(0)
    return ids, np.asarray(sexes, dtype=np.int32)


def open_bgen_geno(params: Params):
    """GenoData for BGEN input (the counterpart of open_geno for BED)."""
    from .geno import GenoData, _read_id_file, _read_snp_file

    bf = open_bgen(params.bgen_file, params.n_chrom, params.ref_first,
                   params.bgi_file)

    raw_sex = None
    if params.sample_file:
        ids, raw_sex = read_sample_file(params.sample_file)
    elif bf.has_sample_ids:
        ids = bf.sample_ids
    else:
        raise ValueError("BGEN file has no sample IDs; provide --sample")
    if len(ids) != bf.n_samples_file:
        raise ValueError("sample file does not match BGEN sample count")
    raw_samples = []
    for a, b in ids:
        if a == b and params.sample_file is None:
            # embedded single-field ID: use as the FID_IID key directly
            raw_samples.append(SampleInfo(FID=a, IID=b, key=a))
        else:
            raw_samples.append(SampleInfo(FID=a, IID=b))

    gd = GenoData(params=params)
    gd._bgen = bf

    keep_mask = np.ones(len(raw_samples), dtype=bool)
    if params.keep_files:
        keep_ids = set()
        for f in params.keep_files:
            keep_ids |= _read_id_file(f)
        for i, s in enumerate(raw_samples):
            keep_mask[i] = s.key in keep_ids
    if params.remove_files:
        rm = set()
        for f in params.remove_files:
            rm |= _read_id_file(f)
        for i, s in enumerate(raw_samples):
            if s.key in rm:
                keep_mask[i] = False
    # sex-specific analyses (Geno.cpp:1287): sex codes come from the
    # .sample file's 4th column
    if params.sex_specific:
        if raw_sex is None:
            raise ValueError(
                "--sex-specific with BGEN requires a --sample file "
                "carrying a sex column")
        keep_mask &= raw_sex == params.sex_specific
    gd.sample_keep_idx = np.flatnonzero(keep_mask)
    gd._keep_all_samples = bool(keep_mask.all())
    gd.samples = [raw_samples[i] for i in gd.sample_keep_idx]
    # sex from the .sample file's 4th column (1=male); zeros when
    # unavailable (params->sex default, Geno.cpp:154)
    if raw_sex is not None:
        gd.sex = (raw_sex[gd.sample_keep_idx] == 1).astype(np.int32)
    else:
        gd.sex = np.zeros(len(gd.samples), dtype=np.int32)

    snp_keep = np.ones(len(bf.snps), dtype=bool)
    if params.extract_files:
        idset = set()
        for f in params.extract_files:
            idset |= _read_snp_file(f)
        for i, s in enumerate(bf.snps):
            snp_keep[i] = s.ID in idset
    if params.exclude_files:
        idset = set()
        for f in params.exclude_files:
            idset |= _read_snp_file(f)
        for i, s in enumerate(bf.snps):
            if s.ID in idset:
                snp_keep[i] = False
    if params.chr_list:
        chrs = {chr_to_int(c, params.n_chrom) for c in params.chr_list}
        for i, s in enumerate(bf.snps):
            if s.chrom not in chrs:
                snp_keep[i] = False
    if params.range_chr != -1:
        for i, s in enumerate(bf.snps):
            if (s.chrom != params.range_chr or s.physpos < params.range_min
                    or s.physpos > params.range_max):
                snp_keep[i] = False
    gd.snps = [s for s, k in zip(bf.snps, snp_keep) if k]

    for s in gd.snps:
        if s.chrom not in gd.chr_counts:
            gd.chr_counts[s.chrom] = 0
            gd.chr_read.append(s.chrom)
        gd.chr_counts[s.chrom] += 1

    params.n_samples = gd.n_samples
    params.n_variants = gd.n_variants
    return gd
