"""Genotype data model + block lists (the port's copy of the BED, PGEN
and BGEN branches of regenie_tpu/io/geno.py).

File metadata, sample/variant filters and the chromosome map. The fused
Step-2 path reads packed bytes straight from the BedFile, BED-coded
packed bytes decoded from PGEN records on the kept-sample axis
(io/native.py, io/csrc/pgen_bytes.cpp), or probability planes from the
BgenFile (io/bgen.py). Dosage sources (BGEN, and PGEN files with dosage
tracks) give float64 dosages through read_dosages, BGEN's with the INFO
numerators of the same block. Step 1 and the dense Step-2 route read
blocks through read_block_host (host: packed bytes, or dosages) and
read_block_device (the block on the device: hardcalls decoded on the
card, or on the host for the CPU; dosages uploaded).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..config import Params
from .bed import (BedFile, SampleInfo, SnpInfo, chr_to_int, decode_bed_bytes,
                  open_bed)
from .files import iter_lines
from .native import pgen_bed_bytes_native, pgen_dosages_native


@dataclass
class GenoData:
    """Genotype file handle + metadata after filters."""

    params: Params
    snps: List[SnpInfo] = field(default_factory=list)  # kept variants, file order
    samples: List[SampleInfo] = field(default_factory=list)  # kept samples
    sample_keep_idx: np.ndarray = None  # indices into raw file sample order
    chr_read: List[int] = field(default_factory=list)  # chroms in file order
    chr_counts: Dict[int, int] = field(default_factory=dict)  # chrom -> #snps kept
    sex: np.ndarray = None  # [N] 1=male 0=other
    _bed: Optional[BedFile] = None
    _bgen: Optional[object] = None  # io.bgen.BgenFile
    _pgen: Optional[object] = None  # io.pgen.PgenDecoder
    _keep_all_samples: bool = True

    @property
    def n_samples(self) -> int:
        return len(self.samples)

    @property
    def n_variants(self) -> int:
        return len(self.snps)

    def sample_index(self) -> Dict[str, int]:
        """Map "FID_IID" -> row index (reference FID_IID_to_ind)."""
        return {s.key: i for i, s in enumerate(self.samples)}

    @property
    def dosage_source(self) -> bool:
        """Whether blocks are dosages (BGEN, or a PGEN with dosage tracks)
        rather than hardcalls."""
        return self._bgen is not None or (
            self._pgen is not None and self.params.pgen_dosage_present)

    def _keep(self) -> Optional[np.ndarray]:
        return None if self._keep_all_samples else self.sample_keep_idx

    def read_dosages(self, block_snps: List[SnpInfo]):
        """(G, info_num) of a block of a dosage source, on the kept
        samples: G [B, N] float64 dosages (missing = -3); info_num [B, N]
        the per-sample INFO numerators of a BGEN block, None for PGEN.
        Each native decoder raises on a record it cannot read."""
        offsets = [s.offset for s in block_snps]
        if self._bgen is not None:
            from .bgen import decode_block

            return decode_block(self._bgen, offsets, self._keep(),
                                self.params.ref_first)
        return pgen_dosages_native(self._pgen.pf, offsets, self._keep()), None

    def read_block_host(self, block_snps: List[SnpInfo]) -> np.ndarray:
        """What a reader thread reads of a block for read_block_device:
        float64 dosages of a dosage source, else read_block_bytes."""
        if self.dosage_source:
            return self.read_dosages(block_snps)[0]
        return self.read_block_bytes(block_snps)

    def read_block_bytes(self, block_snps: List[SnpInfo]) -> np.ndarray:
        """Packed 2-bit BED-coded bytes of a block of kept variants. BED:
        [B, ceil(N_file/4)] uint8, a copy of the rows of `block_snps`
        (which may skip variants of the file span, offsets - start), so
        the pages are read where this runs. PGEN: [B, ceil(N/4)] on the
        kept-sample axis, from the native block decoder."""
        if self._pgen is not None:
            return pgen_bed_bytes_native(
                self._pgen.pf, [s.offset for s in block_snps], self._keep())
        offsets = np.array([s.offset for s in block_snps])
        start, stop = int(offsets[0]), int(offsets[-1]) + 1
        raw = self._bed.read_block_bytes(start, stop - start)
        return np.ascontiguousarray(raw[offsets - start])

    def _on_file_axis(self) -> bool:
        """Whether read_block_bytes' rows lie on the file's sample axis
        (BED), which the decode then maps onto the kept samples, with
        --ref-first swapping alleles; PGEN bytes are on the kept axis
        already, and PGEN names REF and ALT itself."""
        return self._pgen is None

    def read_block(self, block_snps: List[SnpInfo],
                   raw: Optional[np.ndarray] = None) -> np.ndarray:
        """A block on the host, on the kept samples: [B, N] float64
        dosages of a dosage source (missing = -3), else the host decode
        of the BED or PGEN hardcalls, [B, N] int8 {0, 1, 2, -3}. `raw` is
        the block's read_block_host, read here when not given."""
        if raw is None:
            raw = self.read_block_host(block_snps)
        if self.dosage_source:
            return raw
        if not self._on_file_axis():
            return decode_bed_bytes(raw, self.n_samples)
        G = decode_bed_bytes(raw, self._bed.n_samples)
        if not self._keep_all_samples:
            G = G[:, self.sample_keep_idx]
        if getattr(self.params, "ref_first", False):
            # parseSnpfromBed (Geno.cpp:2440): hc = 2 - hc with --ref-first
            G = np.where(G == -3, G, 2 - G).astype(np.int8)
        return G

    def read_block_device(self, block_snps: List[SnpInfo], device,
                          raw: Optional[np.ndarray] = None):
        """A block as a tensor on `device`, on the kept samples: [B, N]
        float64 dosages of a dosage source, uploaded; else int8
        hardcalls: on CUDA the packed bytes are uploaded and decoded on
        the card (4x less host->device traffic than int8, no host
        decode), on the CPU the host decode runs. `raw` is the block's
        read_block_host, read here when not given."""
        import torch

        device = torch.device(device)
        if raw is None:
            raw = self.read_block_host(block_snps)
        if self.dosage_source or device.type != "cuda":
            return torch.from_numpy(self.read_block(block_snps, raw)).to(device)
        from ..ops.geno_ops import decode_bed_packed

        if not self._on_file_axis():
            return decode_bed_packed(torch.from_numpy(raw).to(device),
                                     self.n_samples)
        G = decode_bed_packed(torch.from_numpy(raw).to(device), self._bed.n_samples)
        if not self._keep_all_samples:
            keep = torch.from_numpy(self.sample_keep_idx).to(device)
            G = G.index_select(1, keep)
        if getattr(self.params, "ref_first", False):
            G = torch.where(G == -3, G, 2 - G)
        return G

    def read_block_host_scattered(self, block_snps: List[SnpInfo]) -> np.ndarray:
        """read_block_host of an arbitrary (possibly non-contiguous)
        variant list: a BED's rows are read a variant at a time."""
        if self._bed is None:
            return self.read_block_host(block_snps)
        return np.stack([self._bed.read_block_bytes(s.offset, 1)[0]
                         for s in block_snps])

    def read_block_scattered(self, block_snps: List[SnpInfo]) -> np.ndarray:
        """read_block of an arbitrary (possibly non-contiguous) variant
        list (conditioning variants, extract_condition_snps)."""
        return self.read_block(block_snps, self.read_block_host_scattered(block_snps))

    def close(self):
        for f in (self._bed, self._bgen,
                  None if self._pgen is None else self._pgen.pf):
            if f is not None:
                f.close()


def _read_id_file(path: str) -> set:
    ids = set()
    for toks in iter_lines(path):
        if len(toks) >= 2:
            ids.add(f"{toks[0]}_{toks[1]}")
        else:
            ids.add(f"{toks[0]}_{toks[0]}")
    return ids


def _read_snp_file(path: str) -> set:
    return {toks[0] for toks in iter_lines(path)}


def open_geno(params: Params) -> GenoData:
    """Open PLINK BED or PGEN files (or a BGEN file), apply sample/variant
    filters, build chr map.

    Reference: file_read_initialization (Data.cpp:155) +
    check_snps_include_exclude (Geno.cpp:1128) +
    check_samples_include_exclude (Geno.cpp:1263).
    """
    if params.file_type == "bgen":
        from .bgen import open_bgen_geno

        return open_bgen_geno(params)
    if params.file_type == "pgen":
        return _open_pgen_geno(params)
    if params.file_type != "bed":
        raise NotImplementedError(
            f"{params.file_type.upper()} input is not yet ported to "
            "regenie_tpu_torch")
    bed = open_bed(params.bed_prefix, params.ref_first)
    gd = GenoData(params=params)
    gd._bed = bed
    _apply_filters(params, gd, bed.snps, bed.samples)
    return gd


def _open_pgen_geno(params: Params) -> GenoData:
    """GenoData for PLINK2 .pgen/.pvar/.psam input (sexes from the .psam
    SEX column). A file with dosage tracks sets params.pgen_dosage_present
    (its blocks are dosages: the dense Step-2 route with an INFO column,
    and dosages in Step 1)."""
    from .pgen import PgenDecoder, open_pgen, read_psam, read_pvar

    pf = open_pgen(params.pgen_prefix + ".pgen")
    raw_snps = read_pvar(params.pgen_prefix + ".pvar", params.n_chrom)
    raw_samples = read_psam(params.pgen_prefix + ".psam")
    if len(raw_snps) != pf.n_variants or len(raw_samples) != pf.n_samples_file:
        pf.close()
        raise ValueError("pvar/psam do not match pgen dimensions")
    params.pgen_dosage_present = bool((pf.vrtypes & 0x60).any())
    gd = GenoData(params=params)
    gd._pgen = PgenDecoder(pf)
    _apply_filters(params, gd, raw_snps, raw_samples)
    return gd


def _apply_filters(params, gd, raw_snps, raw_samples):
    # ---- sample filters (keep/remove) ----
    keep_mask = np.ones(len(raw_samples), dtype=bool)
    if params.keep_files:
        keep_ids = set()
        for f in params.keep_files:
            keep_ids |= _read_id_file(f)
        for i, s in enumerate(raw_samples):
            keep_mask[i] = s.key in keep_ids
    if params.remove_files:
        rm_ids = set()
        for f in params.remove_files:
            rm_ids |= _read_id_file(f)
        for i, s in enumerate(raw_samples):
            if s.key in rm_ids:
                keep_mask[i] = False
    # sex-specific analyses (--sex-specific, Geno.cpp:1287)
    if params.sex_specific:
        for i, s in enumerate(raw_samples):
            if s.sex != params.sex_specific:
                keep_mask[i] = False
    gd.sample_keep_idx = np.flatnonzero(keep_mask)
    gd._keep_all_samples = bool(keep_mask.all())
    gd.samples = [raw_samples[i] for i in gd.sample_keep_idx]
    gd.sex = np.array([1 if s.sex == 1 else 0 for s in gd.samples], dtype=np.int32)

    # ---- variant filters (extract/exclude) ----
    snp_keep = np.ones(len(raw_snps), dtype=bool)
    # --range window (check_snps_include_exclude, Geno.cpp:2790)
    if params.range_chr != -1:
        for i, s in enumerate(raw_snps):
            if (s.chrom != params.range_chr or s.physpos < params.range_min
                    or s.physpos > params.range_max):
                snp_keep[i] = False
    if params.extract_files:
        ids = set()
        for f in params.extract_files:
            ids |= _read_snp_file(f)
        for i, s in enumerate(raw_snps):
            snp_keep[i] = s.ID in ids
    if params.exclude_files:
        ids = set()
        for f in params.exclude_files:
            ids |= _read_snp_file(f)
        for i, s in enumerate(raw_snps):
            if s.ID in ids:
                snp_keep[i] = False
    # chromosome filters (step 2 --chr/--chrList)
    if params.chr_list:
        chrs = {chr_to_int(c) for c in params.chr_list}
        for i, s in enumerate(raw_snps):
            if s.chrom not in chrs:
                snp_keep[i] = False
    gd.snps = [s for s, k in zip(raw_snps, snp_keep) if k]

    # --extract-or/--exclude-or: gate which variants the MAC filter
    # applies to (check_snps_include_exclude_or, Geno.cpp:1225-1241)
    if params.exclude_or_files:
        ids = set()
        for f in params.exclude_or_files:
            ids |= _read_snp_file(f)
        for s in gd.snps:
            s.mac_fail_if_checked = s.ID in ids
    elif params.extract_or_files:
        ids = set()
        for f in params.extract_or_files:
            ids |= _read_snp_file(f)
        for s in gd.snps:
            s.mac_fail_if_checked = s.ID not in ids

    # --force-mac-filter snpfile,MAC: separate threshold for a subset
    # (check_forced_MAC_file, Geno.cpp:1249)
    if params.forced_mac_snpfile:
        ids = _read_snp_file(params.forced_mac_snpfile)
        for s in gd.snps:
            s.forced_mac_filter = s.ID in ids

    # ---- chromosome map, file order (reference chr_read) ----
    for s in gd.snps:
        if s.chrom not in gd.chr_counts:
            gd.chr_counts[s.chrom] = 0
            gd.chr_read.append(s.chrom)
        gd.chr_counts[s.chrom] += 1

    params.n_samples = gd.n_samples
    params.n_variants = gd.n_variants


def make_blocks(gd: GenoData, block_size: int) -> List[Tuple[int, List[SnpInfo]]]:
    """Split kept variants into per-chromosome blocks of `block_size`
    (reference set_blocks, Data.cpp:311). Returns [(chrom, snps)]."""
    blocks = []
    by_chr: Dict[int, List[SnpInfo]] = {}
    for s in gd.snps:
        by_chr.setdefault(s.chrom, []).append(s)
    for chrom in gd.chr_read:
        snps = by_chr[chrom]
        for i in range(0, len(snps), block_size):
            blocks.append((chrom, snps[i : i + block_size]))
    return blocks
