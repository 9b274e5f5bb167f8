"""Gene-set / annotation / mask-definition file readers (the port's copy
of regenie_tpu/io/setfiles.py).

Reference: read_setlist (Geno.cpp:3278), read_anno (:3617),
read_anno_cat (:3559), read_masks (:3874), read_aafs (:3790).

Annotation categories are represented as bits in a uint64 (reference
`annoinfo.id`); a mask is a bit-union of its categories; a variant
belongs to a mask iff (anno_bits & mask_bits) != 0.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..config import Params
from .bed import chr_to_int
from .files import iter_lines


MAX_CAT = 64


@dataclass
class MaskDef:
    name: str
    bits: int  # category bit union
    region_name: str = ""  # domain prefix ("Domain." in mask IDs)
    region: int = -1  # domain bitmask filter; -1 = no domain filtering
    cats: List[str] = field(default_factory=list)  # category names (##MASKS)


@dataclass
class VariantSet:
    """One gene set (reference `struct vset`, Geno.hpp:224)."""

    ID: str
    chrom: int
    physpos: int
    snp_indices: List[int] = field(default_factory=list)  # indices into gd.snps


def _split_commas(toks: List[str]) -> List[str]:
    out = []
    for t in toks:
        out.extend(x for x in t.split(",") if x)
    return out


def read_anno_labels(path: str):
    """--anno-labels: '<number> <name>' per line. The NUMBER token is the
    category key used in both the annotation and mask-definition files
    (anno_map is keyed by tmp_str_vec[0], Geno.cpp:3598); the name is a
    display label shown in mask headers (Geno.cpp:3932). Returns
    (cat_bit: token -> bit index, display: token -> name)."""
    cat_bit: Dict[str, int] = {}
    display: Dict[str, str] = {}
    for lineno, toks in enumerate(iter_lines(path)):
        if len(toks) != 2:
            raise ValueError("incorrectly formatted annotation labels file")
        cval = int(toks[0])
        if cval < 0 or cval >= MAX_CAT:
            raise ValueError(f"category must be < {MAX_CAT}")
        if toks[0] in cat_bit:
            raise ValueError(f"duplicate category on line {lineno + 1}")
        cat_bit[toks[0]] = cval
        display[toks[0]] = toks[1]
    return cat_bit, display


def read_annotations(
    path: str,
    snp_id_to_idx: Dict[str, int],
    cat_bit: Optional[Dict[str, int]] = None,
    weight_col: int = 0,
):
    """--anno-file: 'variant set [domain] category' rows.

    Returns (anno: dict[(snp_idx, set_id)] -> category bit id,
             cat_bit: category name -> bit index,
             with_domains: bool, domains: dict[(snp_idx, set_id)] -> name).
    Categories are assigned bits in order of appearance when no labels
    file is given (with NULL=bit 0, read_anno Geno.cpp:3630).
    """
    user_labels = cat_bit is not None
    if cat_bit is None:
        cat_bit = {"NULL": 0}
    anno: Dict[Tuple[int, str], int] = {}
    domains: Dict[Tuple[int, str], int] = {}  # (snp, set) -> region bitmask
    region_names: Dict[str, List[str]] = {}  # set -> region names (bit order)
    set_weights: Dict[Tuple[int, str], float] = {}  # --weights-col
    with_domains = None
    for lineno, toks in enumerate(iter_lines(path)):
        if with_domains is None:
            # domains disabled when a custom weight column is given
            # (read_anno, Geno.cpp:3653)
            with_domains = len(toks) == 4 and weight_col == 0
        ncols = 4 if with_domains else 3
        if weight_col > 0:
            ncols = max(ncols, weight_col)
        if len(toks) < ncols:
            raise ValueError(f"incorrectly formatted annotation file at line {lineno+1}")
        vid, set_id = toks[0], toks[1]
        cat = toks[3] if with_domains else toks[2]
        if vid not in snp_id_to_idx:
            continue
        idx = snp_id_to_idx[vid]
        if cat not in cat_bit:
            if user_labels:
                raise ValueError(f"unknown annotation category '{cat}'")
            cat_bit[cat] = len(cat_bit)
            if len(cat_bit) > MAX_CAT:
                raise ValueError(f"too many annotation categories (>{MAX_CAT})")
        key = (idx, set_id)
        if key in anno and not with_domains:
            raise ValueError(f"duplicate variant annotation for {vid} in {set_id}")
        if with_domains:
            # domain bitmask per set (read_anno, Geno.cpp:3687-3711);
            # repeats of a variant in different domains OR the bits but
            # must keep the same category
            rnames = region_names.setdefault(set_id, [])
            rname = toks[2]
            if rname not in rnames:
                if len(rnames) >= MAX_CAT:
                    raise ValueError(f"more than {MAX_CAT} domains in set {set_id}")
                rnames.append(rname)
            rbit = 1 << rnames.index(rname)
            if key in anno and anno[key] != (1 << cat_bit[cat]):
                raise ValueError(f"inconsistent annotation for {vid} in {set_id}")
            domains[key] = domains.get(key, 0) | rbit
        anno[key] = 1 << cat_bit[cat]
        if weight_col > 0:
            w = float(toks[weight_col - 1])
            if w < 0:
                raise ValueError(f"negative weight for variant {vid} in {set_id}")
            set_weights[key] = w
    read_annotations.set_weights = set_weights
    return anno, cat_bit, bool(with_domains), domains, region_names


def read_mask_defs(path: str, cat_bit: Dict[str, int], log=print,
                   display: Optional[Dict[str, str]] = None) -> List[MaskDef]:
    """--mask-def: '<mask_name> <cat1,cat2,...>' (read_masks, Geno.cpp:3874).
    Unknown categories are ignored with a warning. `display` (from
    --anno-labels) maps numeric category tokens to their display names
    for the ##MASKS header (Geno.cpp:3932)."""
    masks = []
    for toks in iter_lines(path):
        if len(toks) < 2:
            raise ValueError("incorrectly formatted mask file")
        name = toks[0]
        bits = 0
        unknown = []
        cats = []
        for cat in _split_commas(toks[1:]):
            if cat in cat_bit:
                bits |= 1 << cat_bit[cat]
                cats.append(display.get(cat, cat) if display else cat)
            else:
                unknown.append(cat)
        if unknown:
            log(f"WARNING: mask '{name}' has unknown categories: {','.join(unknown)}")
        if bits == 0:
            log(f"WARNING: mask '{name}' has no valid categories; skipped")
            continue
        masks.append(MaskDef(name=name, bits=bits, cats=cats))
    if not masks:
        raise ValueError("no valid masks defined")
    return masks


def read_setlist(
    params: Params,
    path: str,
    snp_id_to_idx: Dict[str, int],
    snp_chroms: np.ndarray,
    anno: Dict[Tuple[int, str], int],
    all_mask_bits: int,
    chr_filter: Optional[set] = None,
    log=print,
) -> List[VariantSet]:
    """--set-list: 'SET CHR POS v1,v2,...' (read_setlist, Geno.cpp:3278).

    Variants missing from the genotype data are dropped; variants without
    an annotation for the set get the NULL category (bit 0); variants in
    none of the masks' categories are dropped from the set.
    """
    sets: List[VariantSet] = []
    keep_sets = set(params.extract_setlist) if params.extract_setlist else None
    if params.extract_sets:
        keep_sets = (keep_sets or set()) | {t[0] for t in (iter_lines(params.extract_sets))}
    rm_sets = set(params.exclude_setlist) if params.exclude_setlist else set()
    if params.exclude_sets:
        rm_sets |= {t[0] for t in iter_lines(params.exclude_sets)}

    for lineno, toks in enumerate(iter_lines(path)):
        toks = _split_commas(toks)
        if len(toks) < 4:
            raise ValueError(
                f"incorrectly formatted set list at line {lineno+1} ({len(toks)} columns)"
            )
        vs = VariantSet(ID=toks[0], chrom=chr_to_int(toks[1], params.n_chrom), physpos=int(toks[2]))
        if vs.chrom == -1:
            raise ValueError("unknown chromosome code in set list file")
        if keep_sets is not None and vs.ID not in keep_sets:
            continue
        if vs.ID in rm_sets:
            continue
        if chr_filter and vs.chrom not in chr_filter:
            continue
        for vid in toks[3:]:
            if vid not in snp_id_to_idx:
                continue
            idx = snp_id_to_idx[vid]
            key = (idx, vs.ID)
            if params.build_mask:
                if key not in anno:
                    anno[key] = 1 << 0  # NULL category
                if (anno[key] & all_mask_bits) == 0:
                    continue
            vs.snp_indices.append(idx)
        if vs.snp_indices:
            sets.append(vs)
    return sets


def read_aaf_file(path: str, snp_id_to_idx: Dict[str, int], n_snps: int,
                  w_singletons: bool = False):
    """--aaf-file: user-given AAFs per variant (read_aafs, Geno.cpp:3790).

    Plain format: 'ID AAF [singleton01]'; PLINK --freq format with a
    '#'-header is recognized via the ID/ALT_FREQS columns. Returns
    (aaf [n_snps] with -1 where absent, force_singleton [n_snps] bool
    or None)."""
    aaf = np.full(n_snps, -1.0)
    singleton = np.zeros(n_snps, dtype=bool) if w_singletons else None
    id_col, aaf_col, sing_col = 0, 1, 2
    first = True
    for toks in iter_lines(path):
        if first:
            first = False
            if toks[0].startswith("#"):
                if w_singletons:
                    raise ValueError("cannot use --set-singletons with PLINK AAF file")
                hdr = [t.lstrip("#") for t in toks]
                if "ID" not in hdr or "ALT_FREQS" not in hdr:
                    raise ValueError("could not find 'ID' or 'ALT_FREQS' in header")
                id_col, aaf_col = hdr.index("ID"), hdr.index("ALT_FREQS")
                continue
        if len(toks) < (3 if w_singletons else 2):
            raise ValueError("incorrectly formatted AAF file")
        if toks[id_col] not in snp_id_to_idx:
            continue
        i = snp_id_to_idx[toks[id_col]]
        aaf[i] = float(toks[aaf_col])
        if w_singletons:
            if toks[sing_col] not in ("0", "1"):
                raise ValueError("singleton column must be 0/1 in AAF file")
            singleton[i] = toks[sing_col] == "1"
    return aaf, singleton
