"""Burden-mask construction (annotation x AAF-bin collapse; the port's
copy of regenie_tpu/models/masks.py, on the host in numpy).

Re-implements the reference's GenoMask engine (Masks.cpp): setBins (:71),
set_snp_masks (:330), set_snp_aafs (:360), updateMasks/tally_masks
(:184/:560), buildMask (:948) — vectorized over the set's [M, N]
genotype matrix instead of per-variant sparse loops.

Rules: max (default), sum, comphet (sum clipped at 2). Bins: AAF
cutoffs + a singleton bin. Masks become pseudo-variants tested by the
shared Step-2 engine.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from ..config import Params
from ..io.bed import SnpInfo
from ..io.setfiles import MaskDef, VariantSet
from ..prep import fmt


@dataclass
class BuiltMask:
    snp: SnpInfo  # pseudo-variant metadata
    mask_name: str
    bin_name: str
    G: np.ndarray  # [N] imputed genotype vector
    af_t: np.ndarray  # [P]
    ns_t: np.ndarray  # [P]
    mac_t: np.ndarray  # [P]
    af1: float
    ignored_trait: np.ndarray  # [P] bool
    flipped: bool
    raw_vec: Optional[np.ndarray] = None  # pre-imputation (for --write-mask)
    vc_col: int = -1  # index into the (mask x bin) grid for VC tests
    in_vc_bin: bool = False
    sel_idx: Optional[np.ndarray] = None  # variant indices (within set) in the mask


def aaf_bin_values(params: Params) -> np.ndarray:
    """Sorted unique AAF cutoffs (setBins, Masks.cpp:71): default 0.01;
    'all' -> 1; vc_maxAAF appended when VC tests requested."""
    vals = []
    if params.aaf_bins:
        for b in params.aaf_bins:
            vals.append(1.0 if b == "all" else float(b))
    else:
        vals.append(0.01)
    if params.vc_tests:
        vals.append(params.vc_maxAAF)
    return np.unique(np.array(vals, dtype=np.float64))


def _singleton_flags(params, G, mac1, ind, singleton_custom=None):
    """Per-variant singleton flag: rounded MAC == 1 (compute_mac,
    Geno.cpp:3084), or exactly one carrier of the counted allele under
    --singleton-carrier (ncarriers counted at dosage >= 0.5,
    Geno.cpp:2020/2298/2457; singleton = (ncarriers == 1),
    Geno.cpp:3085); --set-singletons custom flags take precedence."""
    if singleton_custom is not None:
        return singleton_custom
    if params.singleton_carriers:
        return ((G >= 0.5) & ind[None, :]).sum(axis=1) == 1
    return np.floor(mac1 + 0.5) == 1


def bin_name(aafs: np.ndarray, j: int) -> str:
    """j=0 is the singleton bin; j>=1 maps to aafs[j-1] (computeMasks)."""
    if j == 0:
        return "singleton"
    if aafs[j - 1] == 1:
        return "all"
    return fmt(aafs[j - 1])


def build_masks_for_set(
    params: Params,
    vset: VariantSet,
    G: np.ndarray,  # [M, N] float, missing=-3, NOT imputed
    af1: np.ndarray,  # [M] alt allele freq over analyzed samples
    mac1: np.ndarray,  # [M] minor allele count
    ignored: np.ndarray,  # [M] bool (failed variant filters)
    anno_bits: np.ndarray,  # [M] uint64 category bits for this set
    mask_defs: List[MaskDef],
    aafs: np.ndarray,
    masked_indivs: np.ndarray,  # [N, P] bool
    ind_in_analysis: np.ndarray,  # [N] bool
    aaf_custom: Optional[np.ndarray] = None,
    singleton_custom: Optional[np.ndarray] = None,
    region_bits: Optional[np.ndarray] = None,  # [M] uint64 domain bits
) -> Tuple[List[BuiltMask], List[List[str]]]:
    """Build all (mask x aaf-bin) burden masks for one set.

    Returns (kept masks, snplists per built mask in grid order)."""
    M, N = G.shape
    P = masked_indivs.shape[1]
    n_bins = len(aafs) + 1  # + singleton bin
    take_max = params.mask_rule == "max"
    take_comphet = params.mask_rule == "comphet"
    ind = ind_in_analysis
    maskf = masked_indivs.astype(np.float64)

    singleton = _singleton_flags(params, G, mac1, ind, singleton_custom)

    afs_for_bins = aaf_custom if aaf_custom is not None else af1

    # membership grids (domain filter: updateMasks res2, Masks.cpp:831)
    keepmask = np.zeros((M, len(mask_defs)), dtype=bool)
    for mi, md in enumerate(mask_defs):
        keepmask[:, mi] = ((anno_bits & md.bits) != 0) & ~ignored
        if md.region >= 0 and region_bits is not None:
            keepmask[:, mi] &= (region_bits & np.uint64(md.region)) != 0
    keep_bin_cum = np.zeros((M, n_bins), dtype=bool)  # cumulative incl. singletons
    keep_bin_cum[:, 0] = singleton & ~ignored
    for j in range(1, n_bins):
        keep_bin_cum[:, j] = ((afs_for_bins <= aafs[j - 1]) | singleton) & ~ignored

    built: List[BuiltMask] = []
    snplists: List[List[str]] = []
    G_nonmiss = G >= 0

    for mi, md in enumerate(mask_defs):
        nsites_cum = 0
        for j in range(n_bins):
            sel = keepmask[:, mi] & keep_bin_cum[:, j]
            vc_col = mi * n_bins + j
            in_vc_bin = bool(
                params.vc_tests and j > 0 and aafs[j - 1] == params.vc_maxAAF
            )
            if not sel.any():
                snplists.append([])
                continue
            Gs = G[sel]  # [m, N]
            if take_max:
                mv = Gs.max(axis=0)
            else:
                any_nm = G_nonmiss[sel].any(axis=0)
                s = np.where(G_nonmiss[sel], Gs, 0.0).sum(axis=0)
                mv = np.where(any_nm, s, -3.0)
                if take_comphet:
                    mv = np.minimum(mv, 2.0)
            nsites = int(sel.sum())

            bm = _finalize_mask(
                params, vset, md, j, aafs, mv, nsites, maskf, ind, P,
                take_max or take_comphet,
            )
            snplists.append([])
            if bm is not None:
                bm.vc_col = vc_col
                bm.in_vc_bin = in_vc_bin
                bm.sel_idx = np.flatnonzero(sel)
                built.append(bm)
    return built, snplists


def _finalize_mask(
    params, vset, md, j, aafs, mv, nsites, maskf, ind, P, mac_capped
) -> Optional[BuiltMask]:
    """Per-mask stats + MAC filter + imputation (buildMask, Masks.cpp:948)."""
    mv = np.where(ind, mv, 0.0)  # non-analysis entries forced to 0
    valid = ind & (mv >= 0)
    validf = valid.astype(np.float64)
    vals = np.where(valid, mv, 0.0)
    total = vals.sum()
    ns1 = int(valid.sum())
    if ns1 == 0:
        return None

    total_t = vals @ maskf  # [P]
    ns_t = validf @ maskf

    ignored_trait = np.zeros(P, dtype=bool)
    ignored_all = False
    if mac_capped:
        mac = min(total, 2 * ns1 - total)
        mac_t = np.minimum(total_t, 2 * ns_t - total_t)
        if mac < params.min_mac_mask:
            ignored_all = True
    else:
        mac = total
        mac_t = total_t
    ignored_trait = mac_t < params.min_mac_mask
    if ignored_all:
        return None

    mean = total / ns1
    af1 = mean / 2.0
    af_t = total_t / (2.0 * ns_t)
    if not mac_capped:  # sum rule: average AAF across sites
        af1 /= nsites
        af_t = af_t / nsites

    flipped = False
    if params.use_spa and mac_capped and params.test_type == 0 and mean > 1:
        flipped = True
        mv = np.where(mv >= 0, 2.0 - mv, mv)
        mean = 2.0 - mean

    if params.test_type == 1:
        mv = np.where(mv == 2.0, 1.0, mv)
    elif params.test_type == 2:
        mv = np.where(mv >= 1.0, mv - 1.0, mv)
    if params.test_type > 0:
        sum_pos = np.where((mv >= 0) & ind, mv, 0.0).sum()
        mean = sum_pos / ns1
        if mean < params.numtol:
            return None

    raw_vec = mv.copy()
    # mean-impute missing, zero non-analysis (mean_impute_g)
    mv = np.where(~ind, 0.0, np.where(mv == -3.0, mean, mv))

    bname = bin_name(aafs, j)
    # domain-specific masks carry the region prefix in the ID
    # (Masks.cpp:698: setID + "." + region_name + mask.bin)
    snp = SnpInfo(
        chrom=vset.chrom,
        ID=f"{vset.ID}.{md.region_name}{md.name}.{bname}",
        genpos=0.0,
        physpos=vset.physpos,
        allele1="ref",
        allele2=f"{md.region_name}{md.name}.{bname}",
    )
    return BuiltMask(
        snp=snp, mask_name=md.name, bin_name=bname, G=mv,
        af_t=af_t, ns_t=ns_t, mac_t=mac_t, af1=af1,
        ignored_trait=ignored_trait, flipped=flipped, raw_vec=raw_vec,
    )


def build_lovo_masks(
    params: Params,
    vset: VariantSet,
    G: np.ndarray,
    af1: np.ndarray,
    mac1: np.ndarray,
    ignored: np.ndarray,
    anno_bits: np.ndarray,
    mask_def: MaskDef,
    bin_spec: str,
    snp_ids: List[str],
    masked_indivs: np.ndarray,
    ind_in_analysis: np.ndarray,
) -> List[BuiltMask]:
    """Leave-one-variant-out masks for one (set, mask, aaf-bin)
    (computeMasks_loo, Masks.cpp:739): the full mask plus one mask per
    variant with that variant excluded. Max rule only (reference
    restriction for LOVO with max)."""
    M, N = G.shape
    P = masked_indivs.shape[1]
    take_max = params.mask_rule == "max"
    ind = ind_in_analysis
    maskf = masked_indivs.astype(np.float64)
    singleton = _singleton_flags(params, G, mac1, ind)
    if bin_spec == "singleton":
        keep_bin = singleton
        aafs = np.array([])
        j = 0
    else:
        thr = 1.0 if bin_spec == "all" else float(bin_spec)
        keep_bin = (af1 <= thr) | singleton
        aafs = np.array([thr])
        j = 1
    sel = ((anno_bits & mask_def.bits) != 0) & ~ignored & keep_bin
    sel_idx = np.flatnonzero(sel)
    if len(sel_idx) == 0:
        return []
    Gs = G[sel].astype(np.float64)
    m = len(sel_idx)
    built: List[BuiltMask] = []

    # one-pass precomputation for O(M*N) leave-one-out collapses (the
    # naive per-variant recollapse is O(M^2*N) — prohibitive for
    # 500-variant genes at biobank N):
    # - max rule: per-sample (max, runner-up, argmax); leaving out the
    #   argmax row exposes the runner-up, any other row leaves the max
    # - sum/comphet: totals minus the left-out row
    if take_max:
        best = np.full(N, -np.inf)
        second = np.full(N, -np.inf)
        argbest = np.zeros(N, dtype=np.int64)
        for r in range(m):
            row = Gs[r]
            is_new_best = row > best
            second = np.where(is_new_best, best,
                              np.where(row > second, row, second))
            argbest = np.where(is_new_best, r, argbest)
            best = np.where(is_new_best, row, best)
    else:
        nonmiss = Gs >= 0
        nm_count = nonmiss.sum(axis=0)
        sm_total = np.where(nonmiss, Gs, 0.0).sum(axis=0)

    def collapse(leave_out=None):
        if take_max:
            if leave_out is None:
                return best
            if m == 1:
                return None
            return np.where(argbest == leave_out, second, best)
        if leave_out is None:
            nm, sm = nm_count, sm_total
        else:
            if m == 1:
                return None
            keep = nonmiss[leave_out]
            nm = nm_count - keep
            sm = sm_total - np.where(keep, Gs[leave_out], 0.0)
        mv = np.where(nm > 0, sm, -3.0)
        if params.mask_rule == "comphet":
            mv = np.minimum(mv, 2.0)
        return mv

    # full mask
    mv = collapse()
    bm = _finalize_mask(params, vset, mask_def, j, aafs, mv, m, maskf,
                        ind, P, take_max or params.mask_rule == "comphet")
    if bm is not None:
        bm.sel_idx = sel_idx
        built.append(bm)
    bname = bin_name(aafs, j)
    # --lovo-snplist restricts which variants get a leave-out mask
    # (check_lovo_snplist, Masks.cpp:1380)
    loo_allowed = None
    if getattr(params, "masks_loo_snpfile", None):
        from ..io.files import iter_lines

        loo_allowed = {t[0] for t in iter_lines(params.masks_loo_snpfile)}
    for k in range(m):
        if loo_allowed is not None and snp_ids[sel_idx[k]] not in loo_allowed:
            continue
        mv = collapse(k)
        if mv is None:
            continue
        bm = _finalize_mask(params, vset, mask_def, j, aafs, mv, m - 1, maskf,
                            ind, P, take_max or params.mask_rule == "comphet")
        if bm is None:
            continue
        bm.snp.ID = f"{vset.ID}.{mask_def.name}.{bname}_{snp_ids[sel_idx[k]]}"
        bm.sel_idx = np.array([r for r in sel_idx if r != sel_idx[k]])
        built.append(bm)
    return built
