"""Gene-based testing (the port's copy of regenie_tpu/run_genebased.py):
burden masks per variant set, scored as pseudo-variants by
the Step-2 engine's dense scorer, the SKAT/ACAT family on their VC score
products, and the joint tests and GENE_P over a set's masks.

Replaces the reference's Data::test_joint (Data.cpp:2629),
set_groups_for_testing (:2819), get_sum_stats/getMask (:2906/:2975).

Sets process in buckets of consecutive sets (REGENIE_TPU_GENE_BUCKET,
default 32): the host reads each set and builds its masks, one batched
device call per group gives the variant statistics and one per
chromosome run the burden tests, one batched call per bucket the VC
products (ops/vc_batch.py), then the host tails render rows in set
order. A set's numbers do not depend on its bucket: every device call
runs in fixed-shape pieces (MASK_ROWS rows; vc_batch.SLOTS_PER_CALL
slots), so any bucket size writes the same bytes.

On a multi-process run the sets go round-robin over the processes (unless
masks, mask snplists or the remeta LD files are written: then every
process tests every set and the output host writes), each process tests
its own sets alone, on a single-process copy of the global mesh's splits
(parallel.mesh.Mesh.replica: the same rows a shard, so the same bytes, and
no collective where the processes' work differs), and the buffered rows
are gathered and written in set order
(regenie_tpu/run_genebased.py:195-215, :520-535).
"""

from __future__ import annotations

import os
import time
from typing import Dict, List

import numpy as np
import torch

from .io.bed import chr_to_int
from .io.files import RowBuffer, iter_lines, open_write, open_write_bytes
from .io.setfiles import (MaskDef, read_aaf_file, read_anno_labels,
                          read_annotations, read_mask_defs, read_setlist)
from .models import joint as joint_mod
from .models import skat as skat_mod
from .models.masks import (BuiltMask, aaf_bin_values, build_lovo_masks,
                           build_masks_for_set)
from .ops.geno_ops import MISSING
from .parallel import mesh as pm
from .parallel.dist import allgather_py, process_count, process_index
from .run_step2 import BlockResult, Step2Engine, setup_writers, write_block_rows

# Rows of each device call of the variant statistics and the burden test.
# FIXED: a row's numbers then do not depend on how many rows share the
# call (bucket invariance); short calls are padded with empty rows.
MASK_ROWS = 64


def run_genebased(params, eng: Step2Engine, log=print) -> Step2Engine:
    """Step 2 with --set-list: every set's burden masks, VC tests and
    joint tests, one output file per trait. Returns the engine, its
    output files closed and its genotype source open."""
    gd, pd = eng.gd, eng.pd
    t0 = time.time()

    snp_id_to_idx = {s.ID: i for i, s in enumerate(gd.snps)}
    snp_chroms = np.array([s.chrom for s in gd.snps])

    cat_bit, cat_disp = (read_anno_labels(params.anno_labels_file)
                         if params.anno_labels_file else (None, None))
    anno, cat_bit, with_domains, domains, region_names = read_annotations(
        params.anno_file, snp_id_to_idx, cat_bit,
        weight_col=params.vc_weight_col if params.vc_with_weights else 0,
    )
    eng._set_weights = getattr(read_annotations, "set_weights", {})
    if with_domains:
        n_dom = sum(len(v) for v in region_names.values())
        log(f"   +number of domains across all sets = {n_dom}")
    mask_defs = read_mask_defs(params.mask_def, cat_bit, log, display=cat_disp)
    all_bits = 0
    for md in mask_defs:
        all_bits |= md.bits

    chr_filter = None
    if params.chr_list:
        chr_filter = {chr_to_int(c, params.n_chrom) for c in params.chr_list}
    sets = read_setlist(
        params, params.set_list, snp_id_to_idx, snp_chroms, anno, all_bits,
        chr_filter, log,
    )
    aafs = aaf_bin_values(params)

    # LODO mode: restrict to the named set/mask, single AAF bin
    # (mask_loo_set/mask_loo_name/mbins, Regenie.cpp:988-992; sets with a
    # different name are skipped, Geno.cpp:3680/3913)
    if params.mask_lodo:
        lodo_toks = params.mask_lodo.split(",")
        if not with_domains:
            raise ValueError(
                "--mask-lodo requires 4-column annotations with domains"
            )
        sets = [s for s in sets if s.ID == lodo_toks[0]]
        if not sets:
            raise ValueError(
                f"set '{lodo_toks[0]}' not found for LODO (or set name "
                "does not match the annotation file)"
            )
        mask_defs = [m for m in mask_defs if m.name == lodo_toks[1]]
        if not mask_defs:
            raise ValueError(f"mask '{lodo_toks[1]}' not found for LODO")
        if lodo_toks[2] == "singleton":
            aafs = []
        else:
            aafs = [1.0 if lodo_toks[2] == "all" else float(lodo_toks[2])]

    # user-given AAFs (--aaf-file, read_aafs Geno.cpp:3790)
    file_aaf, force_singleton = None, None
    if params.set_aaf_file:
        file_aaf, force_singleton = read_aaf_file(
            params.set_aaf_file, snp_id_to_idx, len(gd.snps),
            params.aaf_file_wSingletons,
        )
        log(f" * user-given AAFs: [{params.set_aaf_file}]")
    log(f" * set file: [{params.set_list}] n_sets = {len(sets)}")
    log(f" * masks: {[m.name for m in mask_defs]}")
    log(f" * aaf cutoffs: [ {len(aafs)} : " + " ".join(str(a) for a in aafs) + " ] + singletons")

    # ##MASKS=<M1="cats";...> meta line (build_header, Masks.cpp:1245)
    mask_hdr = "##MASKS=<" + ";".join(
        f'{md.name}="{",".join(md.cats)}"' for md in mask_defs
    ) + ">\n"
    writers, out_paths = setup_writers(params, pd.pheno_names, pre_header=mask_hdr)
    if params.vc_tests:
        skat_mod.check_tests(params.vc_tests)

    if params.remeta_save_ld:
        from .io.remeta import RegenieLDMatrixWriter

        log(" * saving SKAT LD matrices for REMETA")
        eng.remeta_writers = [
            RegenieLDMatrixWriter(
                f"{params.out_prefix}_{name}", int(pd.Neff[ph])
            ) if pd.pheno_pass[ph] else None
            for ph, name in enumerate(pd.pheno_names)
        ]

    # --check-burden-files: consistency report across set/anno/mask files
    # (check_sets..., Geno.cpp via --check-burden-files, Regenie.cpp:250)
    if params.check_burden_files:
        rpt = params.out_prefix + "_masks_report.txt"
        with open_write(rpt) as fh:
            fh.write("##Checking annotation/set-list/mask files\n")
            for md in mask_defs:
                fh.write(f"Mask {md.name}: OK\n")
            for vs_ in sets:
                miss = [
                    i for i in vs_.snp_indices if (i, vs_.ID) not in anno
                ]
                if miss:
                    ids_ = ",".join(gd.snps[i].ID for i in miss[:10])
                    fh.write(
                        f"Set {vs_.ID}: {len(miss)} variants without annotation "
                        f"(assigned NULL): {ids_}\n"
                    )
        log(f" * burden file check written to [{rpt}]")

    # --write-setlist: group written masks into new set lists
    # (prep_setlists/make_setlist, Masks.cpp:1270/1361)
    setlist_groups = None
    if params.write_masks and params.write_setlist:
        setlist_groups = []  # (suffix, set of mask names, fh)
        for toks in iter_lines(params.write_setlist):
            if len(toks) < 2:
                raise ValueError("write-setlist line has too few entries")
            names = set()
            for t in toks[1:]:
                names |= set(t.split(","))
            fh = open_write(f"{params.out_prefix}_{toks[0]}.setlist")
            setlist_groups.append((toks[0], names, fh))

    mask_bed = _MaskBedWriter(params, gd) if params.write_masks else None
    snplist_fh = (
        open_write(params.out_prefix + "_masks.snplist")
        if params.write_mask_snplist
        else None
    )

    # LOVO mode: restrict to the specified set/mask/bin (mask_loo,
    # Geno.cpp:3913; computeMasks_loo)
    lovo_spec = None
    if params.mask_lovo:
        toks = params.mask_lovo.split(",")
        if len(toks) < 3:
            raise ValueError("--mask-lovo expects SET,MASK,AAF_BIN")
        lovo_spec = toks
        sets = [s for s in sets if s.ID == toks[0]]
        if not sets:
            raise ValueError(f"set '{toks[0]}' not found for LOVO")
        mask_defs = [m for m in mask_defs if m.name == toks[1]]
        if not mask_defs:
            raise ValueError(f"mask '{toks[1]}' not found for LOVO")

    # order sets by chromosome (file order), then set position
    sets.sort(key=lambda s: (s.chrom, s.physpos))
    nproc = process_count()
    buffered = None  # this process's sets' rows, on a multi-process run
    if nproc > 1 and not (params.write_masks or params.write_mask_snplist
                          or params.remeta_save_ld):
        sets = sets[process_index()::nproc]
        buffered = []
        if eng.mesh is not None:
            eng.mesh = eng.mesh.replica()
            eng.replicas = pm.Replicas(eng.mesh)
        log(f" * multi-process gene-based tests: {nproc} processes, sets "
            "round-robin")

    uniq_writers: List = []
    seen = set()
    for w in writers:
        if w is not None and id(w) not in seen:
            seen.add(id(w))
            uniq_writers.append(w)

    bucket_size = max(1, int(os.environ.get("REGENIE_TPU_GENE_BUCKET", "32")))
    n_buckets = -(-len(sets) // bucket_size) if sets else 0

    # stage attribution (REGENIE_TPU_GENE_PROFILE=1): seconds per loop
    # stage, logged as a table at the end of the run
    prof_on = bool(os.environ.get("REGENIE_TPU_GENE_PROFILE"))
    prof: Dict[str, float] = {}

    class _stage:
        __slots__ = ("k", "t0")

        def __init__(self, k):
            self.k = k

        def __enter__(self):
            self.t0 = time.perf_counter()

        def __exit__(self, *exc):
            prof[self.k] = prof.get(self.k, 0.0) + (
                time.perf_counter() - self.t0)

    def _stage1_prepare(vset, snps, G, sb):
        """Host-side work for one set: mask building plus the aux mask
        writers. The device calls (the statistics, the burden test) run
        at the group level so one batched call serves many sets.
        Returns (bufs, writers_set, built, ignored)."""
        bufs = {id(w): RowBuffer() for w in uniq_writers}
        writers_set = [None if w is None else bufs[id(w)] for w in writers]
        total, ns = sb["total"], sb["ns"]
        mac1 = np.minimum(total, 2 * ns - total)
        ignored = mac1 < params.min_mac  # 0.5 in mask mode: drops monomorphic
        af1 = total / (2.0 * ns)

        anno_bits = np.array(
            [anno.get((i, vset.ID), 1) for i in vset.snp_indices], dtype=np.uint64
        )

        # 4-column annotations: expand masks per domain + all-domain mask
        # (GenoMask::setBins w_regions branch, Masks.cpp:134-155)
        set_mask_defs = mask_defs
        region_bits = None
        if with_domains and vset.ID in region_names:
            rnames = region_names[vset.ID]
            allbits = (1 << len(rnames)) - 1
            set_mask_defs = []
            for md in mask_defs:
                for k, rn in enumerate(rnames):
                    if params.mask_lodo:
                        set_mask_defs.append(MaskDef(
                            md.name, md.bits, f"LODO_{rn}.", allbits & ~(1 << k)
                        ))
                    else:
                        set_mask_defs.append(
                            MaskDef(md.name, md.bits, f"{rn}.", 1 << k)
                        )
                set_mask_defs.append(MaskDef(md.name, md.bits, "", allbits))
            region_bits = np.array(
                [domains.get((i, vset.ID), 0) for i in vset.snp_indices],
                dtype=np.uint64,
            )

        if lovo_spec is not None:
            built = build_lovo_masks(
                params, vset, G.astype(np.float64), af1, mac1, ignored,
                anno_bits, mask_defs[0], lovo_spec[2],
                [s.ID for s in snps], pd.masked_indivs, pd.ind_in_analysis,
            )
        else:
            aaf_custom = None
            singleton_custom = None
            if file_aaf is not None:
                fa = file_aaf[vset.snp_indices]
                aaf_custom = np.where(fa >= 0, fa, af1)
                if force_singleton is not None:
                    singleton_custom = force_singleton[vset.snp_indices]
            built, _ = build_masks_for_set(
                params, vset, G.astype(np.float64), af1, mac1, ignored, anno_bits,
                set_mask_defs, aafs, pd.masked_indivs, pd.ind_in_analysis,
                aaf_custom=aaf_custom, singleton_custom=singleton_custom,
                region_bits=region_bits,
            )

        if mask_bed is not None:
            for bm in built:
                mask_bed.add(bm)
        if setlist_groups is not None:
            for _sfx, names, fh in setlist_groups:
                ids = [
                    bm.snp.ID for bm in built
                    if bm.mask_name in names
                    or f"{bm.mask_name}.{bm.bin_name}" in names
                ]
                if ids:
                    fh.write(
                        f"{vset.ID} {vset.chrom} {vset.physpos} " + ",".join(ids) + "\n"
                    )
        if snplist_fh is not None:
            # maskID chrom pos v1,v2,... (make_snplist, Masks.cpp:1350)
            for bm in built:
                sel_ids = [snps[k].ID for k in bm.sel_idx]
                snplist_fh.write(
                    f"{bm.snp.ID}\t{bm.snp.chrom}\t{bm.snp.physpos}\t" + ",".join(sel_ids) + "\n"
                )
        return bufs, writers_set, built, ignored

    # group size for the batched stats / mask-test calls: the dense
    # concatenated [sum(M), N] G of one group is bounded by this many
    # megabytes (f64)
    group_cap = float(os.environ.get("REGENIE_TPU_GENE_GROUP_MB", "1024")) * 1e6
    n_ign0 = eng.n_ignored

    for b_idx in range(n_buckets):
        staged = []  # (vset, built, burden_result, bufs, vc_prep)
        b_lo = b_idx * bucket_size
        b_hi = min((b_idx + 1) * bucket_size, len(sets))
        groups, cur, cur_b = [], [], 0.0
        for set_idx in range(b_lo, b_hi):
            m_b = len(sets[set_idx].snp_indices) * float(params.n_samples) * 8.0
            if cur and cur_b + m_b > group_cap:
                groups.append(cur)
                cur, cur_b = [], 0.0
            cur.append(set_idx)
            cur_b += m_b
        if cur:
            groups.append(cur)
        for group in groups:
            # pass A: read every set's raw block, then one batched stats
            # call for the whole group (chromosome-free, so the concat
            # may span chromosomes); per-set stats are row slices
            reads = []
            with _stage("read"):
                for set_idx in group:
                    vset = sets[set_idx]
                    snps = [gd.snps[i] for i in vset.snp_indices]
                    G = gd.read_block_scattered(snps)  # [M, N], missing=-3
                    reads.append((vset, snps, G))
            with _stage("stats:dev"):
                sb_all = _block_stats(eng, np.concatenate([t[2] for t in reads]))
            sb_slices = []
            off = 0
            for t in reads:
                m = t[2].shape[0]
                sb_slices.append(
                    {k: v[off : off + m] for k, v in sb_all.items()})
                off += m
            # pass B: per-set host mask building + aux mask writers
            pend = []
            for (vset, snps, G), sb in zip(reads, sb_slices):
                with _stage("masks:host"):
                    bufs, writers_set, built, ignored = _stage1_prepare(
                        vset, snps, G, sb)
                pend.append(dict(
                    vset=vset, snps=snps, G=G, sb=sb, built=built,
                    ignored=ignored, bufs=bufs, writers_set=writers_set, r=None))
            if params.skip_test:
                continue  # --skip-test: masks written, no association
            # pass C: one batched burden-mask test per chromosome run
            # (test_prepared_block scores each pseudo-variant row
            # independently against the chromosome's LOCO residuals, so
            # concatenated sets == per-set calls, row for row)
            i = 0
            while i < len(pend):
                j = i
                while (j < len(pend)
                       and pend[j]["vset"].chrom == pend[i]["vset"].chrom):
                    j += 1
                run = [e for e in pend[i:j] if e["built"]]
                if run:
                    with _stage("burden:dev"):
                        eng.prep_chrom(pend[i]["vset"].chrom)
                        r_all = _test_masks(
                            eng, [bm for e in run for bm in e["built"]])
                    off = 0
                    for e in run:
                        m = len(e["built"])
                        e["r"] = r_all.slice_rows(off, off + m)
                        e["G_res"] = (None if eng.last_G_res is None
                                      else eng.last_G_res[off : off + m])
                        off += m
                i = j
            # pass D: per-set burden rows + VC prep + staging (set order)
            for e in pend:
                vset, built, r = e["vset"], e["built"], e["r"]
                eng.prep_chrom(vset.chrom)
                if built and r is not None and not params.p_joint_only:
                    write_block_rows(
                        params, pd, e["writers_set"],
                        [bm.snp for bm in built], r,
                        model_type=eng.model_type())
                prep = None
                if params.vc_tests:
                    with _stage("vcprep:host"):
                        prep = skat_mod.vc_prep(
                            params, eng, vset, e["snps"], e["G"], e["sb"],
                            e["ignored"], built, log)
                staged.append((vset, built, r, e.get("G_res"), e["bufs"], prep))

        # stage 2: one batched device call for the bucket's VC products
        if params.vc_tests and any(t[5] is not None for t in staged):
            with _stage("vcprod:dev"):
                skat_mod.vc_products_batched(
                    params, eng, [t[5] for t in staged if t[5] is not None]
                )

        # stage 3: per-set host tails + row rendering, in set order, on
        # one thread (a thread pool over the tails loses to the GIL)
        for vset, built, r, G_res, bufs, prep in staged:
            writers_set = [None if w is None else bufs[id(w)] for w in writers]
            eng.prep_chrom(vset.chrom)
            if params.verbose or params.debug:
                # per-set debug trail (getMask, Data.cpp:3007)
                log(f"   -set {vset.ID} [chr {vset.chrom}]")
            eng._last_mask_result = r
            eng.last_G_res = G_res
            if params.vc_tests:
                eng._last_vc_results = {}
                if prep is not None:
                    with _stage("vctails:host"):
                        skat_mod.vc_finish(params, eng, vset, prep, writers_set, log)

            # joint tests on burden p-values
            if params.apply_gene_pval_strategy:
                joint_mod.run_gene_p(params, eng, vset, built, writers_set, log)
            elif params.joint_tests:
                joint_mod.run_joint_tests(params, eng, vset, built, writers_set, log)

            if buffered is not None:
                buffered.append([bufs[id(w)].value() for w in uniq_writers])
                continue
            for w in uniq_writers:
                payload = bufs[id(w)].value()
                if payload:
                    w.write(payload)

    n_ign = eng.n_ignored - n_ign0
    if buffered is not None:
        # the ordered merge: set k of process p is set k * nproc + p
        every = allgather_py(buffered)
        n_ign = sum(allgather_py(n_ign))
        for k in range(len(every[0])):
            for rows in every:
                for w, text in zip(uniq_writers, rows[k] if k < len(rows) else ()):
                    if text:
                        w.write(text)
    for fh in uniq_writers:
        fh.close()
    for wr in getattr(eng, "remeta_writers", None) or []:
        if wr is not None:
            wr.close()
    if setlist_groups is not None:
        for _sfx, _names, fh in setlist_groups:
            fh.close()
    if mask_bed is not None:
        mask_bed.close()
    if snplist_fh is not None:
        snplist_fh.close()
    log("\nAssociation results stored separately for each trait in files:")
    for p_ in out_paths:
        log(f"* [{p_}]")
    if mask_bed is not None:
        log(f"Masks written to : [{params.out_prefix}_masks.{{bed,bim,fam}}]")
    log(f"Number of ignored tests due to low MAC : {n_ign * params.n_pheno}")
    if prof_on and prof:
        tot = sum(prof.values()) or 1.0
        log(" * gene-based stage attribution (s):")
        for k, v in sorted(prof.items(), key=lambda t: -t[1]):
            log(f"     {k:12s} {v:8.2f}  ({100 * v / tot:.0f}%)")
    log(f" * done ({time.time()-t0:.1f}s)")
    return eng


def _block_stats(eng: Step2Engine, G: np.ndarray) -> dict:
    """eng.block_stats of a [M, N] host block in calls of exactly
    MASK_ROWS rows (the last padded with all-missing rows, sliced off)."""
    M = G.shape[0]
    parts = []
    for lo in range(0, M, MASK_ROWS):
        Gc = G[lo : lo + MASK_ROWS]
        m = Gc.shape[0]
        if m < MASK_ROWS:
            Gc = np.concatenate(
                [Gc, np.full((MASK_ROWS - m, G.shape[1]), MISSING, G.dtype)])
        sb = eng.block_stats(Gc)
        parts.append({k: v[:m] for k, v in sb.items()})
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def _test_masks(eng: Step2Engine, built: List[BuiltMask]) -> BlockResult:
    """Score built masks as pseudo-variants on the engine's dense scorer,
    in calls of exactly MASK_ROWS rows. The padding rows are zero-G,
    ignored, all-trait-masked pseudo-variants: sliced off before any
    consumer sees them and taken back out of the engine's n_ignored
    tally. eng.last_G_res holds the residualized rows when a joint test
    or GENE_P reads them."""
    dev = eng.device
    B = len(built)
    N, P = built[0].G.shape[0], built[0].af_t.shape[0]
    parts, g_res = [], []
    for lo in range(0, B, MASK_ROWS):
        chunk = built[lo : lo + MASK_ROWS]
        m = len(chunk)
        npad = MASK_ROWS - m

        def stack(key, fill):
            rows = [getattr(bm, key) for bm in chunk]
            shape = np.shape(rows[0])
            return np.stack(rows + [np.full(shape, fill)] * npad)

        G = stack("G", 0.0)
        r = eng.test_prepared_block(
            torch.from_numpy(G).to(dev), stack("af_t", 0.0),
            stack("ns_t", 0.0), stack("mac_t", 0.0), np.arange(MASK_ROWS) >= m,
            np.vstack([np.stack([bm.ignored_trait for bm in chunk]),
                       np.ones((npad, P), bool)]),
            np.array([bm.flipped for bm in chunk] + [False] * npad),
            is_mask=True,
        )
        eng.n_ignored -= npad  # padding rows are not real tests
        parts.append(r.slice_rows(0, m))
        if eng.last_G_res is not None:
            g_res.append(eng.last_G_res[:m])
    r = BlockResult.concat_rows(parts)
    eng.last_G_res = np.concatenate(g_res) if g_res else None
    if eng.params.htp_out:
        # genotype class counts from the pre-imputation mask vectors
        # (update_genocounts on the collapsed mask, Masks.cpp path)
        raw = np.stack([
            bm.raw_vec if bm.raw_vec is not None else bm.G for bm in built
        ])
        r.genocounts = eng.compute_genocounts(torch.from_numpy(raw).to(dev),
                                              [bm.snp for bm in built])
    return r


class _MaskBedWriter:
    """Write built masks as PLINK bed/bim/fam (make_genovec/write_genovec/
    write_genobim, Masks.cpp:1177-1349)."""

    def __init__(self, params, gd):
        self.params = params
        self.n = params.n_samples
        self.bed = open_write_bytes(params.out_prefix + "_masks.bed")
        self.bed.write(b"\x6c\x1b\x01")
        self.bim = open_write(params.out_prefix + "_masks.bim")
        with open_write(params.out_prefix + "_masks.fam") as fam:
            for s in gd.samples:
                fam.write(f"{s.FID}\t{s.IID}\t0\t0\t{s.sex}\t0\n")

    def add(self, bm: BuiltMask):
        v = bm.raw_vec
        hc = np.where(v < 0, -3, np.round(np.clip(v, 0, 2))).astype(np.int8)
        # plink 2-bit codes, ref-last: 2->00, missing->01, 1->10, 0->11
        codes = np.where(hc == 2, 0, np.where(hc == -3, 1, np.where(hc == 1, 2, 3))).astype(
            np.uint8
        )
        pad = (-len(codes)) % 4
        if pad:
            codes = np.concatenate([codes, np.zeros(pad, dtype=np.uint8)])
        codes = codes.reshape(-1, 4)
        byts = (
            codes[:, 0] | (codes[:, 1] << 2) | (codes[:, 2] << 4) | (codes[:, 3] << 6)
        ).astype(np.uint8)
        self.bed.write(byts.tobytes())
        s = bm.snp
        self.bim.write(f"{s.chrom}\t{s.ID}\t0\t{s.physpos}\t{s.allele2}\t{s.allele1}\n")

    def close(self):
        self.bed.close()
        self.bim.close()


def build_requested_masks(params, eng: Step2Engine, want: Dict[str, List[str]], log):
    """The burden masks that --ld-extract's mask rows name (check_ld_list,
    Geno.cpp:1475-1485; the JAX package's build_requested_masks), built
    from --set-list, --anno-file and --mask-def as the gene-based tests
    build them.

    want: {set_id: [mask IDs like 'SET1.M1.0.01']}. Returns {mask_id: [N]
    genotype vector (missing = -3)}."""
    gd, pd = eng.gd, eng.pd
    snp_id_to_idx = {s.ID: i for i, s in enumerate(gd.snps)}
    snp_chroms = np.array([s.chrom for s in gd.snps])
    cat_bit, cat_disp = (read_anno_labels(params.anno_labels_file)
                         if params.anno_labels_file else (None, None))
    anno, cat_bit, _wd, _dom, _rn = read_annotations(
        params.anno_file, snp_id_to_idx, cat_bit)
    mask_defs = read_mask_defs(params.mask_def, cat_bit, log, display=cat_disp)
    all_bits = 0
    for md in mask_defs:
        all_bits |= md.bits
    sets = read_setlist(params, params.set_list, snp_id_to_idx, snp_chroms, anno,
                        all_bits, None, log)
    aafs = aaf_bin_values(params)
    out: Dict[str, np.ndarray] = {}
    for vset in sets:
        if vset.ID not in want:
            continue
        snps = [gd.snps[i] for i in vset.snp_indices]
        G = gd.read_block_scattered(snps)
        sb = eng.block_stats(G)
        total, ns = sb["total"], sb["ns"]
        mac1 = np.minimum(total, 2 * ns - total)
        with np.errstate(divide="ignore", invalid="ignore"):
            af1 = total / (2.0 * ns)
        anno_bits = np.array(
            [anno.get((i, vset.ID), 1) for i in vset.snp_indices], dtype=np.uint64)
        built, _ = build_masks_for_set(
            params, vset, G.astype(np.float64), af1, mac1, mac1 < 0.5, anno_bits,
            mask_defs, aafs, pd.masked_indivs, pd.ind_in_analysis)
        for bm in built:
            if bm.snp.ID in want[vset.ID]:
                out[bm.snp.ID] = bm.raw_vec if bm.raw_vec is not None else bm.G
    return out
