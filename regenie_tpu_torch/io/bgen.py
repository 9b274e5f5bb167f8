"""BGEN v1.2 reader for the fused Step-2 scorer (the port's copy of
regenie_tpu/io/bgen.py, trimmed to what the plane path reads).

The variant index is scanned once up front (or read from the .bgi sqlite
index); each block's genotype records are then read as compressed bytes
(zlib or zstd) and inflated by the native plane extractor into [B, 2,
N_file] uint8 probability planes (io/native.py). The parsing decoders of the dense
dosage path (decode_variant, _decode_layout1/2, decode_block_native) are
not ported.

Allele convention (ref-last default, Geno.cpp:44-49): allele0 in the
file is treated as ALT; dosage = p1 + 2*p0. With --ref-first the dosage
counts the last allele: p1 + 2*p2.
"""

from __future__ import annotations

import sqlite3
import struct
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from ..config import Params
from .bed import SampleInfo, SnpInfo, chr_to_int
from .native import bgen12_extract_planes_native, require_zstd


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


def require_planes(bf: BgenFile) -> None:
    """Raise NotImplementedError unless the plane extractor reads this
    file's records at all: layout 2 (v1.2) with zlib or zstd compression;
    a zstd file also needs libzstd (io/native.py require_zstd, which
    raises RuntimeError without it). Whether each record is 8-bit
    unphased diploid is known only when its block is inflated."""
    if bf.layout != 2 or bf.compression not in (1, 2):
        raise NotImplementedError(
            f"BGEN layout {bf.layout} with compression {bf.compression}: only "
            "zlib- or zstd-compressed layout-2 files are ported to "
            "regenie_tpu_torch")
    if bf.compression == 2:
        require_zstd()


def extract_planes_block(bf: BgenFile, indices) -> np.ndarray:
    """Inflate-only plane extraction for the fused scorer: [B, 2, N_file]
    uint8 probability planes (k0, k1; missing = 255/255). Keeps the FILE
    sample axis; sample subsetting happens through zeroed operand rows on
    the device. Raises when the file or any record of the block is
    outside what the extractor reads (there is no other reader)."""
    require_planes(bf)
    chunks, offs, cs, us = [], [], [], []
    pos = 0
    for idx in indices:
        v = bf.variants[idx]
        bf._fh.seek(v.geno_offset)
        raw = bf._fh.read(v.geno_size)
        (D,) = struct.unpack("<I", raw[:4])
        payload = raw[4:]
        chunks.append(payload)
        offs.append(pos)
        cs.append(len(payload))
        us.append(D)
        pos += len(payload)
    return bgen12_extract_planes_native(
        b"".join(chunks), np.array(offs, dtype=np.int64),
        np.array(cs, dtype=np.int64), np.array(us, dtype=np.int64),
        bf.n_samples_file, bf.compression,
    )


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
