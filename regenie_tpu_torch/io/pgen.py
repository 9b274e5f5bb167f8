"""PLINK2 PGEN reader (the port's copy of regenie_tpu/io/pgen.py):
header and record index, .pvar/.psam, and the plain per-variant decoder.

Storage modes 0x02 (fixed 2-bit records) and 0x10/0x11 (variable
records): 2-bit direct, 1-bit ("onebit") + exception difflist,
difflist-against-constant, and LD-compressed (difflist against the
previous non-LD variant, plus inverted variant); the 16-bit dosage tracks;
and phased files (hardcall-phase aux2 and phased-dosage dphase tracks
decode-and-drop). Multiallelic variants are not supported.

Format knowledge from the public PGEN spec (the byte layout parsed by
pgenlib_read.cc): 12-byte header; per-vblock (65536 variants) fpos
array, packed vrtypes (4- or 8-bit) and record lengths; difflists are
[vint len][group first-IDs][group fpos bytes][2-bit raregeno][vint
deltas].

Genotype codes: 0=hom-ref, 1=het, 2=hom-alt, 3=missing -> returned as
ALT counts {0,1,2,-3}. The file is memory-mapped, not read whole. The
fused Step-2 path and Step 1 read whole blocks through the port's native
block decoder (io/csrc/pgen_bytes.cpp), which writes BED-coded packed
bytes; PgenDecoder is its plain twin, for the tests.
"""

from __future__ import annotations

import mmap
import struct
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from .bed import SampleInfo, SnpInfo, chr_to_int
from .files import open_read, string_split

VBLOCK = 65536
GROUP = 64


def _vint31(buf, pos: int) -> Tuple[int, int]:
    val = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        val |= (b & 0x7F) << shift
        if not (b & 0x80):
            return val, pos
        shift += 7


@dataclass
class PgenFile:
    path: str
    n_variants: int = 0
    n_samples_file: int = 0
    vrtypes: np.ndarray = None  # [M] uint8
    fpos: np.ndarray = None  # [M] int64 record start
    vrec_lens: np.ndarray = None  # [M]
    _data: Optional[mmap.mmap] = None  # the whole file, memory-mapped

    def close(self):
        mm, self._data = self._data, None
        if mm is not None:
            try:
                mm.close()
            except BufferError:
                pass  # a numpy view still holds it; freed with the view


def open_pgen(path: str) -> PgenFile:
    pf = PgenFile(path=path)
    with open(path, "rb") as fh:
        data = mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_READ)
    pf._data = data
    if data[0] != 0x6C or data[1] != 0x1B:
        raise ValueError(f"{path}: not a PGEN file")
    mode = data[2]
    M, N = struct.unpack("<II", data[3:11])
    pf.n_variants, pf.n_samples_file = M, N
    if mode == 0x02:  # fixed-width 2-bit records
        pf.vrtypes = np.zeros(M, dtype=np.uint8)
        rec = (N + 3) // 4
        pf.fpos = 12 + rec * np.arange(M, dtype=np.int64)
        pf.vrec_lens = np.full(M, rec)
        return pf
    if mode not in (0x10, 0x11):
        raise NotImplementedError(f"PGEN storage mode {hex(mode)} not supported")
    header_ctrl = data[11]
    storage = header_ctrl & 15
    if storage & 8:
        raise NotImplementedError("special single-sample PGEN header modes not supported")
    vrec_len_byte_ct = 1 + (storage & 3)
    eight_bit_vrtypes = storage >= 4

    n_vblocks = (M + VBLOCK - 1) // VBLOCK
    pos = 12
    vblock_fpos = np.frombuffer(data, dtype="<u8", count=n_vblocks,
                                offset=pos).astype(np.int64)
    pos += 8 * n_vblocks

    vrtypes = np.empty(M, dtype=np.uint8)
    fpos_all, lens_all = [], []
    for vb in range(n_vblocks):
        cnt = min(VBLOCK, M - vb * VBLOCK)
        if eight_bit_vrtypes:
            vt = np.frombuffer(data, dtype=np.uint8, count=cnt, offset=pos)
            pos += cnt
        else:
            nb = (cnt + 1) // 2
            packed = np.frombuffer(data, dtype=np.uint8, count=nb, offset=pos)
            vt = np.empty(nb * 2, dtype=np.uint8)
            vt[0::2] = packed & 0xF
            vt[1::2] = packed >> 4
            vt = vt[:cnt]
            pos += nb
        vrtypes[vb * VBLOCK : vb * VBLOCK + cnt] = vt
        raw = np.frombuffer(data, dtype=np.uint8, count=cnt * vrec_len_byte_ct,
                            offset=pos)
        vl = np.zeros(cnt, dtype=np.int64)
        for b in range(vrec_len_byte_ct):
            vl |= raw[b::vrec_len_byte_ct].astype(np.int64) << (8 * b)
        pos += cnt * vrec_len_byte_ct
        fp = np.empty(cnt, dtype=np.int64)
        fp[0] = vblock_fpos[vb]
        if cnt > 1:
            fp[1:] = vblock_fpos[vb] + np.cumsum(vl[:-1])
        fpos_all.append(fp)
        lens_all.append(vl)
    pf.vrtypes = vrtypes
    pf.fpos = np.concatenate(fpos_all)
    pf.vrec_lens = np.concatenate(lens_all)
    return pf


def _unpack2(buf, pos: int, n: int) -> np.ndarray:
    """n 2-bit codes packed 4 to a byte, low bits first."""
    nb = (n + 3) // 4
    raw = np.frombuffer(buf, dtype=np.uint8, count=nb, offset=pos)
    codes = np.empty(nb * 4, dtype=np.uint8)
    for k in range(4):
        codes[k::4] = (raw >> (2 * k)) & 3
    return codes[:n]


def _parse_ids(data, pos: int, L: int, N: int, with_raregeno: bool):
    """The sample IDs of a difflist (with_raregeno, also its 2-bit codes)
    or a deltalist of length L > 0: (ids, raregeno or None, new_pos)."""
    sid_bytes = (int.bit_length(int(N)) + 7) // 8  # BytesToRepresentNzU32
    group_ct = (L + GROUP - 1) // GROUP
    first_ids = np.empty(group_ct, dtype=np.int64)
    for g in range(group_ct):
        v = 0
        for b in range(sid_bytes):
            v |= data[pos + b] << (8 * b)
        first_ids[g] = v
        pos += sid_bytes
    pos += group_ct - 1  # per-group byte-length entries (sequential skip)
    raregeno = None
    if with_raregeno:
        raregeno = _unpack2(data, pos, L)
        pos += (L + 3) // 4
    ids = np.empty(L, dtype=np.int64)
    k = 0
    for g in range(group_ct):
        cnt = min(GROUP, L - g * GROUP)
        cur = first_ids[g]
        ids[k] = cur
        k += 1
        for _ in range(cnt - 1):
            d, pos = _vint31(data, pos)
            cur += d
            ids[k] = cur
            k += 1
    return ids, raregeno, pos


def _parse_difflist(data, pos: int, N: int):
    """Returns (sample_ids [L], raregeno [L], new_pos)."""
    L, pos = _vint31(data, pos)
    if L == 0:
        return np.empty(0, dtype=np.int64), np.empty(0, dtype=np.uint8), pos
    return _parse_ids(data, pos, L, N, True)


def _parse_deltalist(data, pos: int, N: int):
    """Deltalist = difflist without the 2-bit raregeno track
    (ParseAndSaveDeltalist, pgenlib_read.cc). Returns (sample_ids, new_pos)."""
    L, pos = _vint31(data, pos)
    if L == 0:
        return np.empty(0, dtype=np.int64), pos
    ids, _, pos = _parse_ids(data, pos, L, N, False)
    return ids, pos


class PgenDecoder:
    """Sequential decoder with LD-base caching (PgrGet semantics)."""

    def __init__(self, pf: PgenFile):
        self.pf = pf
        self._ldbase_vidx = -1
        self._ldbase_codes: Optional[np.ndarray] = None

    def _non_ld_decode(self, vidx: int) -> Tuple[np.ndarray, int]:
        """Decode the hardcall track; returns (codes, end_pos) where
        end_pos is the file offset just past the genotype track (where
        the aux dosage tracks start)."""
        pf = self.pf
        N = pf.n_samples_file
        vrtype = int(pf.vrtypes[vidx])
        pos = int(pf.fpos[vidx])
        data = pf._data
        if vrtype & 8:
            raise NotImplementedError("multiallelic PGEN variants not supported")
        if not (vrtype & 4):
            if vrtype & 1:
                # onebit: [common2 byte][bitarray][exception difflist]
                common2 = data[pos]
                pos += 1
                base = common2 >> 2
                delta = common2 & 3
                nb = (N + 7) // 8
                bits = np.unpackbits(
                    np.frombuffer(data, dtype=np.uint8, count=nb, offset=pos),
                    bitorder="little",
                )[:N]
                codes = (base + bits * delta).astype(np.uint8)
                pos += nb
                ids, rare, pos = _parse_difflist(data, pos, N)
                codes[ids] = rare
            else:
                codes = _unpack2(data, pos, N)
                pos += (N + 3) // 4
            return codes, pos
        low2 = vrtype & 3
        if low2 == 1:
            return np.zeros(N, dtype=np.uint8), pos  # all hom-ref
        codes = np.full(N, low2, dtype=np.uint8)
        ids, rare, pos = _parse_difflist(data, pos, N)
        codes[ids] = rare
        return codes, pos

    def _decode_pos(self, vidx: int) -> Tuple[np.ndarray, int]:
        pf = self.pf
        vrtype = int(pf.vrtypes[vidx])
        if (vrtype & 6) == 2:  # LD-compressed: diff vs last non-LD variant
            base_vidx = vidx - 1
            while (int(pf.vrtypes[base_vidx]) & 6) == 2:
                base_vidx -= 1
            if self._ldbase_vidx != base_vidx:
                self._ldbase_codes = self._non_ld_decode(base_vidx)[0]
                self._ldbase_vidx = base_vidx
            codes = self._ldbase_codes.copy()
            if vrtype & 1:  # inverted: hom-ref <-> hom-alt
                codes = np.where(codes == 0, np.uint8(2),
                                 np.where(codes == 2, np.uint8(0), codes))
            ids, rare, pos = _parse_difflist(pf._data, int(pf.fpos[vidx]),
                                             pf.n_samples_file)
            codes[ids] = rare
            return codes, pos
        return self._non_ld_decode(vidx)

    def decode(self, vidx: int) -> np.ndarray:
        """[N_file] 2-bit codes (0 hom-ref, 1 het, 2 hom-alt, 3 missing)."""
        return self._decode_pos(vidx)[0]

    def dosages(self, vidx: int) -> np.ndarray:
        """ALT dosages [N] float64 with -3 for missing; parses the
        16-bit dosage tracks (ParseDosage16, pgenlib_read.cc:7185:
        0x20 deltalist, 0x40 dense, 0x60 bitarray; values on the
        0..32768 = 0..2 scale, 65535 = missing).

        Phase tracks decode-and-drop: the hardcall-phase aux2 track
        (vrtype & 0x10) is skipped with SkipAux2 semantics
        (pgenlib_read.cc:6819) to reach the dosage bytes, and the
        trailing phased-dosage dphase track (0x80) is never read."""
        codes, pos = self._decode_pos(vidx)
        out = codes.astype(np.float64)
        out[codes == 3] = -3.0
        vrtype = int(self.pf.vrtypes[vidx])
        dbits = vrtype & 0x60
        if not dbits:
            return out
        if vrtype & 0x08:
            raise NotImplementedError(
                "multiallelic PGEN variants not supported — split sites "
                "first (e.g. plink2 --make-bpgen multiallelics=-)"
            )
        data = self.pf._data
        N = self.pf.n_samples_file
        if vrtype & 0x10:
            # skip aux2 (hardcall phase): first part is 1 + het_ct/8
            # bytes; bit0 = explicit-phasepresent, then either phaseinfo
            # for all hets or phasepresent bits + separate phaseinfo
            het_ct = int((codes == 1).sum())
            first_bytes = 1 + het_ct // 8
            if data[pos] & 1:
                bits = np.unpackbits(
                    np.frombuffer(data, np.uint8, first_bytes, pos),
                    bitorder="little")
                phasepresent_ct = int(bits[1 : het_ct + 1].sum())
                pos += first_bytes + (phasepresent_ct + 7) // 8
            else:
                pos += first_bytes
        if dbits == 0x20:  # dosage deltalist
            ids, pos = _parse_deltalist(data, pos, N)
            vals = np.frombuffer(data, dtype="<u2", count=len(ids), offset=pos)
            out[ids] = vals / 16384.0
        elif dbits == 0x40:  # unconditional dense dosage
            vals = np.frombuffer(data, dtype="<u2", count=N, offset=pos)
            out = np.where(vals == 65535, -3.0, vals / 16384.0)
        else:  # 0x60: dosage bitarray
            nb = (N + 7) // 8
            present = np.unpackbits(
                np.frombuffer(data, dtype=np.uint8, count=nb, offset=pos),
                bitorder="little",
            )[:N].astype(bool)
            pos += nb
            vals = np.frombuffer(
                data, dtype="<u2", count=int(present.sum()), offset=pos)
            out[present] = vals / 16384.0
        return out


def read_pvar(path: str, n_chrom: int) -> List[SnpInfo]:
    """Variants of a .pvar (or a .bim-like file without a header): REF is
    ALLELE0, ALT the effect allele ALLELE1."""
    snps = []
    with open_read(path) as fh:
        header = None
        for line in fh:
            if line.startswith("##"):
                continue
            toks = string_split(line)
            if not toks:
                continue
            if header is None:
                if line.startswith("#"):
                    header = toks
                    header[0] = header[0].lstrip("#")
                    continue
                header = ["CHROM", "ID", "CM", "POS", "ALT", "REF"]  # .bim-like fallback
            cols = {nm: i for i, nm in enumerate(header)}
            chrom = chr_to_int(toks[cols.get("CHROM", 0)], n_chrom)
            snps.append(
                SnpInfo(
                    chrom=chrom,
                    ID=toks[cols["ID"]],
                    genpos=0.0,
                    physpos=int(toks[cols["POS"]]),
                    allele1=toks[cols["REF"]],  # ALLELE0 = REF
                    allele2=toks[cols["ALT"]],  # ALLELE1 = ALT (effect)
                    offset=len(snps),
                )
            )
    return snps


def read_psam(path: str) -> List[SampleInfo]:
    """Samples of a .psam (FID/IID and SEX columns; 1 = male)."""
    samples = []
    with open_read(path) as fh:
        header = None
        for line in fh:
            toks = string_split(line)
            if not toks:
                continue
            if header is None and line.startswith("#"):
                header = [t.lstrip("#") for t in toks]
                continue
            if header is None:
                header = ["FID", "IID"]
            cols = {nm: i for i, nm in enumerate(header)}
            fid = toks[cols["FID"]] if "FID" in cols else toks[cols.get("IID", 0)]
            iid = toks[cols.get("IID", 1 if "FID" in cols else 0)]
            sex = 0
            if "SEX" in cols:
                try:
                    sex = int(toks[cols["SEX"]])
                except ValueError:
                    sex = 0
            samples.append(SampleInfo(FID=fid, IID=iid, sex=sex))
    return samples
