"""Step 1 on quantitative, binary, count and time-to-event traits from
PLINK BED or PGEN hardcalls or BGEN (and PGEN) dosages: whole-genome
block ridge -> LOCO predictions (the port of the single-device parts of
regenie_tpu/run_step1.py).

Replaces the reference's Data::run_step1 (Data.cpp:95-133),
level_0_calculations (:594), ridge_level_1* (Step1_Models.cpp:772+),
output/make_predictions/write_predictions (Data.cpp:956-1930) and the
split-L0 multi-job protocol (write_l0_master Data.cpp:244,
prep_parallel_l0 :818, write_l0_file/read_l0 Step1_Models.cpp:728/1921)
with file-compatible master/snplist/binary prediction formats.

Level 0 and level 1 run in float64 on the device (models/step1.py: DGEMM
on the FP64 tensor cores and cuSOLVER eigh on the card); each hardcall
block ships as packed bytes and is decoded there (ops/geno_ops.py), each
dosage block (io/csrc/bgen_dosages.cpp, io/csrc/pgen_bytes.cpp on the
reader thread) as float64. Binary, count and time-to-event traits first
fit their null models on the host (models/glm.py; Cox: models/survival.py),
then take the penalized logistic, Poisson or Cox level 1 on the device
(models/step1_bt.py); a time-to-event trait's LOCO file is written for its
time column. The LOCO rows render through io/csrc/loco_rows.cpp.
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .config import BT, QT, T2E, Params, ridge_h2_grid
from .io.files import GzipWriter, iter_lines, open_write, open_write_bytes, string_split
from .io.geno import make_blocks
from .io.output import format_value_rows
from .models import glm
from .models import step1 as m1
from .models import step1_bt
from .ops.geno_ops import MISSING, decode_bed_packed, prepare_block_step1
from .parallel import mesh as pm
from .parallel.dist import is_output_host, process_count, process_index
from .prep import fmt, prepare, write_debug_inputs
from .utils.device import resolve_device
from .utils.stats import rss_line, usage_info_line


def _parse_master(path: str):
    """Read a split-L0 .master file -> (n_geno, block_size, jobs) where
    jobs = [(prefix, n_blocks, n_snps)] (prep_parallel_l0, Data.cpp:818)."""
    with open(path) as fh:
        header = string_split(fh.readline())
        n_geno, bsize = int(header[0]), int(header[1])
        jobs = []
        for line in fh:
            toks = string_split(line)
            if toks:
                jobs.append((toks[0], int(toks[1]), int(toks[2])))
    return n_geno, bsize, jobs


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Step1Setup(NamedTuple):
    """The run-up of a Step-1 run (open_step1)."""

    gd: object  # io.geno.GenoData
    pd: object  # io.pheno.PhenoData
    blocks: list  # [(chrom, [SnpInfo])]
    h_l0: np.ndarray  # [J] level-0 heritability grid
    lambdas: np.ndarray  # [J] level-0 penalties
    taus: np.ndarray  # [T] level-1 penalties
    h_l1: np.ndarray  # [T] level-1 heritability grid
    fold_sizes: Optional[np.ndarray]  # [K] (K-fold) or None (LOOCV)
    master: Optional[Tuple]  # the split-L0 master file, parsed
    run_l0_job: Optional[int]
    device: torch.device
    # the single-process mesh of level 0 (parallel/mesh.py), or None;
    # `device` is then its first shard's device
    mesh: Optional[tuple] = None


def open_step1(params: Params, log=print, device=None) -> Step1Setup:
    """The run-up of run_step1 before level 0: the mode check, the device
    and the mesh, the split-L0 role, data preparation, the blocks and the
    ridge grids. `device` as in utils.device.resolve_device."""
    from .cli import unported

    why = unported(params, device)
    if why is not None:
        raise NotImplementedError(f"{why}: not yet ported to regenie_tpu_torch")
    dev = resolve_device(device)
    params.test_mode = False

    # ---- split-L0 job roles ----
    run_l0_job: Optional[int] = None
    master: Optional[Tuple] = None
    if params.run_l0:
        mfile, jobstr = params.run_l0.rsplit(",", 1)
        run_l0_job = int(jobstr)
        master = _parse_master(mfile)
        if master[1] != params.block_size:
            raise ValueError("invalid header line in master file (block size mismatch)")
        # restrict to this job's variants (prep_parallel_l0)
        job_prefix = master[2][run_l0_job - 1][0]
        params.extract_files = list(params.extract_files) + [job_prefix + ".snplist"]
    elif params.run_l1:
        master = _parse_master(params.run_l1)

    rd = prepare(params, log=log)
    gd, pd = rd.geno, rd.pheno

    # --l1-phenoList: run level 1 only for selected traits
    # (select_phenos_l1, Pheno.cpp:1948)
    if params.select_pheno_l1:
        sel = set(params.select_pheno_l1)
        for ph, name in enumerate(pd.pheno_names):
            if name not in sel:
                pd.pheno_pass[ph] = False

    if params.n_variants > 1_000_000 and not params.force_step1:
        raise ValueError(
            "too many variants for step 1 (> 1M); use --force-step1 to override"
        )

    blocks = make_blocks(gd, params.block_size)
    params.total_n_block = len(blocks)

    # binary traits: LOOCV below 5,000 analysed samples (Data.cpp:353)
    if params.trait_mode == BT and not params.use_loocv and params.n_analyzed < 5000:
        log("   -WARNING: sample size below 5,000: using LOOCV instead of K-fold CV.")
        params.use_loocv = True

    # ridge penalty grids (Regenie.cpp:1497, Data.cpp:607, Step1_Models.cpp:2099)
    n_geno_all = master[0] if run_l0_job is not None else params.n_variants
    total_blocks_all = (
        sum(j[1] for j in master[2]) if master is not None else params.total_n_block
    )
    h_l0 = params.user_lambda if params.user_lambda is not None else ridge_h2_grid(params.n_ridge_l0)
    lambdas = n_geno_all * (1.0 - h_l0) / h_l0
    h_l1 = params.user_tau if params.user_tau is not None else ridge_h2_grid(params.n_ridge_l1)
    taus = total_blocks_all * params.n_ridge_l0 * (1.0 - h_l1) / h_l1
    if params.trait_mode == BT:
        taus = taus * 3.0 / (np.pi**2)  # count traits: per trait in level 1
    fold_sizes = None
    if not params.use_loocv:
        fold_sizes = m1.compute_fold_sizes(pd.ind_in_analysis, params.cv_folds)
    # the sample-sharded level 0 (regenie_tpu/run_step1.py:250-345, its
    # single-process 1-D mesh): level 0 is the same linear ridge for every
    # trait type, so the mesh covers QT/BT/CT/T2E, LOOCV and K-fold. Level
    # 1 runs on the first shard's device.
    mesh = pm.run_mesh(params, dev)
    if mesh is not None:
        dev = mesh[0]
        log(f" * multi-device mesh: {mesh.describe()} (sample-axis sharding for "
            "level 0)")
    return Step1Setup(gd, pd, blocks, h_l0, lambdas, taus, h_l1, fold_sizes,
                      master, run_l0_job, dev, mesh)


def run_step1(params: Params, log=print, device=None) -> Step1Setup:
    """Step 1: <out>_<i>.loco per trait and <out>_pred.list (with
    --write-null-firth on binary traits <out>_<i>.firth and
    <out>_firth.list), or a split-L0 role (--split-l0 / --run-l0 /
    --run-l1). `device` as in utils.device.resolve_device (CUDA unless
    the CPU is asked for). Returns the run's setup (open_step1), its
    genotype source open."""
    st = open_step1(params, log, device)
    gd, pd, blocks, master = st.gd, st.pd, st.blocks, st.master

    # ---- split-L0 master writer ----
    if params.split_l0:
        prefix, njobs = params.split_l0.rsplit(",", 1)
        _write_l0_master(params, blocks, prefix, int(njobs), log)
        return st
    if params.print_block_betas and params.n_pheno > 1:
        raise ValueError("cannot have run --print in multi-trait mode!")

    log(f" * block size: [{params.block_size}]")
    log(usage_info_line(params))
    log(f" * # blocks: [{params.total_n_block}] for {params.n_variants} variants")
    if params.alpha_prior != -1:
        log(" * applying a MAF dependent prior to the SNP effect sizes in "
            f"level 0 models (alpha={fmt(params.alpha_prior)})")
    log(f" * # CV folds: [{params.n_analyzed if params.use_loocv else params.cv_folds}]")
    log(f" * ridge data_l0: [ {params.n_ridge_l0} : " + " ".join(fmt(x) for x in st.h_l0) + " ]")
    log(f" * ridge data_l1: [ {params.n_ridge_l1} : " + " ".join(fmt(x) for x in st.h_l1) + " ]")

    J, P, N = params.n_ridge_l0, params.n_pheno, params.n_samples

    # null models of binary and count traits against the covariates, on the
    # host in numpy float64, a trait at a time (fit_null_models,
    # Step1_Models.cpp:54+)
    offsets = None
    if params.trait_mode != QT:
        t0 = time.time()
        offsets = glm.fit_null_offsets(params, pd)
        log(f" * null model fits: {time.time() - t0:.3f}s "
            f"({int(pd.pheno_pass.sum())} of {P} traits, on the host)")
    if params.debug:
        # dump the model inputs (write_inputs, Data.cpp:114/911)
        write_debug_inputs(params, pd, offsets)

    # ---- level 0 (or read it from job files) ----
    if params.run_l1:
        W_all = _read_l0_jobs(master[2], N, J, P, st.fold_sizes)
        chr_nblocks: Dict[int, int] = {}
        for chrom, _ in blocks:
            chr_nblocks[chrom] = chr_nblocks.get(chrom, 0) + 1
        log(" (skipping to level 1 models)")
    else:
        W_all, chr_nblocks = _level0(params, st, log)

    if params.early_exit and st.run_l0_job is None:
        log("--early-exit: stopping after level 0 models")
        return st

    # level 1 and its files run on the output host alone (its first
    # shard's device); the other processes of a launch end after level 0
    if not is_output_host():
        return st
    # ---- run-l0 job: write binary predictions and exit ----
    if st.run_l0_job is not None:
        job_prefix = master[2][st.run_l0_job - 1][0]
        Wn = _as_sample_major(params, W_all, st.fold_sizes)
        for ph in range(P):
            # col-major doubles (write_l0_file, Step1_Models.cpp:728)
            Wn[:, :, ph].T.astype(np.float64).tofile(job_prefix + f"_l0_Y{ph+1}")
        log("Done writing level 0 predictions to file.")
        return st

    _level1_and_output(params, gd, pd, W_all, st.taus, st.h_l1, chr_nblocks,
                       st.fold_sizes, st.device, log, offsets)
    return st


def _read_l0_jobs(jobs, N, J, P, fold_sizes) -> np.ndarray:
    """--run-l1: the level-0 predictions of every --run-l0 job (read_l0,
    Step1_Models.cpp:1921), in the block-major layout of _level0 (K-fold
    pad rows 0)."""
    nb = sum(j[1] for j in jobs)
    if fold_sizes is None:
        W_all = np.zeros((nb, N, J, P))
    else:
        W_all = np.zeros((nb, len(fold_sizes), int(fold_sizes.max()), J, P))
        bounds = np.concatenate([[0], np.cumsum(fold_sizes)])
    b0 = 0
    for prefix, nb_job, _ns_job in jobs:
        for ph in range(P):
            fname = prefix + f"_l0_Y{ph+1}"
            dat = np.fromfile(fname, dtype=np.float64)
            if dat.size != N * nb_job * J:
                raise ValueError(f"{fname}: unexpected size")
            # col-major [N, F] doubles: [block, j, sample]
            dat = dat.reshape(nb_job, J, N).transpose(0, 2, 1)
            if fold_sizes is None:
                W_all[b0 : b0 + nb_job, :, :, ph] = dat
            else:
                for k in range(len(fold_sizes)):
                    W_all[b0 : b0 + nb_job, k, : fold_sizes[k], :, ph] = \
                        dat[:, bounds[k] : bounds[k + 1]]
        b0 += nb_job
    return W_all


def _as_sample_major(params, W_all, fold_sizes):
    """Block-major W_all ([nb, K, nmax, J, P] K-fold, [nb, N, J, P]
    LOOCV) -> [N, F, P] sample-major, F = nb * J."""
    if not params.use_loocv:
        W_all = np.concatenate(
            [W_all[:, k, : int(fold_sizes[k])] for k in range(params.cv_folds)], axis=1)
    nb, N, J, P = W_all.shape
    return W_all.transpose(1, 0, 2, 3).reshape(N, nb * J, P)


def _alloc_W(params, shape):
    """Host array of the level-0 predictions; --lowmem spills it to a
    memory-mapped scratch file instead of RAM (write_l0_file / read_l0
    mmap, Step1_Models.cpp:728/1921), removed at exit unless --keep-l0."""
    if not params.write_l0_pred:
        return np.zeros(shape, dtype=np.float64)
    import atexit

    prefix = params.loco_tmp_prefix or params.out_prefix
    path = prefix + "_l0_preds.bin"
    W = np.memmap(path, dtype=np.float64, mode="w+", shape=shape)
    if not params.keep_l0:
        atexit.register(lambda: os.path.exists(path) and os.remove(path))
    return W


class Level0:
    """The device operands of level 0 for one run, and its per-block
    steps (level_0_calculations, Data.cpp:594). On a mesh the trait
    operands live only sharded over the sample axis, zero-padded to the
    shard count (K-fold: each fold's padded axis nmax, each shard's fold
    slots gathered from the block on its own), and each block's ridge runs
    sample-sharded (parallel.mesh.sharded_level0_loocv /
    sharded_level0_kfold); the block's residualization stays whole on the
    first shard's device."""

    def __init__(self, params: Params, st: Step1Setup):
        pd, dev = st.pd, st.device
        self.params, self.device, self.mesh = params, dev, st.mesh
        self.lambdas, self.Neff = self._put(st.lambdas), self._put(pd.Neff)
        self.ind = torch.as_tensor(pd.ind_in_analysis, device=dev)
        self.cov = self._put(pd.new_cov)
        self.scale_denom = float(params.n_analyzed - params.ncov)
        Y = np.asarray(pd.phenotypes, np.float64)
        maskf = pd.masked_indivs.astype(np.float64)
        mesh = self.mesh
        # the per-host sample window (None unless taken)
        self.window = None
        if params.use_loocv:
            if mesh is None:
                self.Y, self.mask = self._put(Y), self._put(maskf)
            elif self._window_ok(st):
                self._open_window(st, Y, maskf)
            else:
                self.Y_sh, self.mask_sh = pm.shard(mesh, Y, 0), pm.shard(mesh, maskf, 0)
            return
        Y_folds, valid = m1.pad_folds(Y, st.fold_sizes)
        mask_folds, _ = m1.pad_folds(maskf, st.fold_sizes)
        fold_idx = m1.fold_index(st.fold_sizes)
        self.nmax = Y_folds.shape[1]
        if mesh is None:
            self.Y_folds, self.mask_folds = self._put(Y_folds), self._put(mask_folds)
            self.valid = self._put(valid)
            # device-side fold gather: folds are contiguous sample ranges,
            # so [K, nmax] indices replace a host restack; pad slots
            # gather sample 0 and are zeroed by the kernel's valid mask
            self.fold_idx = torch.as_tensor(fold_idx.reshape(-1), device=dev)
            return
        # the fold axis nmax padded to the shard count (pad slots gather
        # sample 0 and are zeroed by valid = 0), and each shard's slots
        # indexed apart
        self.Yf_sh, self.mf_sh, self.v_sh = (
            pm.shard(mesh, np.asarray(a, np.float64), 1)
            for a in (Y_folds, mask_folds, valid))
        idx, _ = pm.pad_to(fold_idx, mesh.size, 1)
        self.fold_idx_sh = [torch.as_tensor(np.ascontiguousarray(i).reshape(-1),
                                            device=dev)
                            for i in mesh.local(np.split(idx, mesh.size, axis=1))]

    def _put(self, a):
        return torch.as_tensor(np.asarray(a, np.float64), device=self.device)

    def _window_ok(self, st: Step1Setup) -> bool:
        """Whether each process decodes only its own sample window of a
        block (regenie_tpu/run_step1.py:270-310): a mesh that spans
        processes, LOOCV (the caller's test), a BED, no --prior-alpha (its
        allele frequencies are per block) and no --ref-first."""
        p = self.params
        return (self.mesh.spans_processes and st.gd._bed is not None
                and p.alpha_prior == -1 and not p.ref_first)

    def _open_window(self, st: Step1Setup, Y, maskf):
        """The per-host window's operands on the FILE sample axis, padded
        to 4 x the global shard count (whole bytes a shard): ind (0 at
        dropped and pad samples), the covariate basis, Y and the masks,
        zero outside the kept samples, sharded over it."""
        gd, pd, mesh = st.gd, st.pd, self.mesh
        unit = 4 * mesh.size
        n_pad = -(-gd._bed.n_samples // unit) * unit
        keep = (np.arange(self.params.n_samples) if gd._keep_all_samples
                else np.asarray(gd.sample_keep_idx))

        def scat(x):
            out = np.zeros((n_pad,) + x.shape[1:])
            out[keep] = x
            return pm.shard(mesh, out, 0)

        spp = n_pad // process_count()  # samples a process
        lo = process_index() * spp
        self.window = (lo // 4, (lo + spp) // 4, keep)
        self.ind_sh = scat(pd.ind_in_analysis.astype(np.float64))
        self.cov_sh = scat(np.asarray(pd.new_cov, np.float64))
        self.Y_sh, self.mask_sh = scat(Y), scat(maskf)

    def read_window(self, gd, bsnps) -> np.ndarray:
        """A block's bytes of this process's sample window, [B, bytes]
        (zero past the file's last byte): all this process reads."""
        blo, bhi, _ = self.window
        offsets = np.array([s.offset for s in bsnps])
        start, stop = int(offsets[0]), int(offsets[-1]) + 1
        raw = gd._bed.read_block_bytes(start, stop - start)
        if len(offsets) != stop - start:
            raw = raw[offsets - start]
        out = np.zeros((len(bsnps), bhi - blo), np.uint8)
        take = raw[:, blo : min(bhi, raw.shape[1])]
        out[:, : take.shape[1]] = take
        return out

    def window_loocv(self, win: np.ndarray, bsnps):
        """LOOCV W of a block from this process's window bytes: each local
        shard's bytes decoded on its device, then the whole chain
        sample-sharded (parallel.mesh.sharded_level0_loocv_full). Returns
        W [N, J, P] on the output host (None elsewhere); raises on a SNP of
        (near) zero variance."""
        mesh = self.mesh
        G8 = [decode_bed_packed(torch.from_numpy(np.ascontiguousarray(b)).to(d),
                                4 * b.shape[1])
              for b, d in zip(np.split(win, len(mesh), axis=1), mesh)]
        W, scale_G = pm.sharded_level0_loocv_full(
            mesh, G8, self.ind_sh, self.cov_sh, self.Y_sh, self.mask_sh,
            self.lambdas, self.Neff, self.scale_denom, dst=0)
        sg = scale_G.cpu().numpy()
        if not np.all(sg > self.params.numtol):
            bad = bsnps[int(np.argmin(sg))].ID
            raise ValueError(f"SNP {bad} has low variance in step 1 block")
        if W is None:
            return None
        return W[torch.as_tensor(self.window[2], device=W.device)]

    def residualized(self, G8: torch.Tensor, bsnps) -> torch.Tensor:
        """A block's int8 hardcalls or float64 dosages -> masked, imputed,
        covariate-residualized genotypes of unit variance [B, N]
        (float64), with --prior-alpha each row scaled by
        [p(1-p)]^((1+alpha)/2) (residualize_genotypes, Data.cpp:215).
        Raises on a SNP of (near) zero variance. The block's scale factors
        stay in self.scale_G (host)."""
        G = prepare_block_step1(G8, self.ind)
        G, scale_G = m1.residualize_geno_block(G, self.cov, self.scale_denom)
        sg = self.scale_G = scale_G.cpu().numpy()
        if not np.all(sg > self.params.numtol):
            bad = bsnps[int(np.argmin(sg))].ID
            raise ValueError(f"SNP {bad} has low variance in step 1 block")
        if self.params.alpha_prior != -1:
            # allele frequencies of the analysed samples' non-missing
            # calls, the power taken on the host as in the JAX package
            valid = (G8 != MISSING) & self.ind[None, :]
            tv = torch.stack([torch.where(valid, G8.to(torch.float64), 0.0).sum(dim=1),
                              valid.sum(dim=1).to(torch.float64)]).cpu().numpy()
            af = tv[0] / (2.0 * tv[1])
            G = G * torch.as_tensor(
                (af * (1.0 - af)) ** (0.5 * (self.params.alpha_prior + 1.0)),
                device=G.device)[:, None]
        return G

    def folds(self, G: torch.Tensor, idx=None) -> torch.Tensor:
        """[B, N] -> [K, B, nmax] by fold (pad slots from sample 0), or
        the slots that idx indexes."""
        idx = self.fold_idx if idx is None else idx
        return G.index_select(1, idx).view(
            G.shape[0], self.params.cv_folds, -1).transpose(0, 1)

    def fold_parts(self, G: torch.Tensor) -> list:
        """On a mesh: [B, N] -> each shard's [K, B, nmax_pad / shards] fold
        slots, on that shard's device."""
        return [self.folds(G, i).to(d) for i, d in zip(self.fold_idx_sh, self.mesh)]

    def kfold(self, G: torch.Tensor) -> torch.Tensor:
        """K-fold W of a residualized block: [K, nmax, J, P] (on a mesh
        that spans processes, on the output host; None elsewhere)."""
        if self.mesh is not None:
            W = pm.sharded_level0_kfold(
                self.mesh, self.fold_parts(G), self.Yf_sh, self.mf_sh, self.v_sh,
                self.lambdas, self.Neff, dst=0)
            return None if W is None else W[:, : self.nmax]
        return m1.level0_kfold_block(self.folds(G), self.Y_folds, self.mask_folds,
                                     self.valid, self.lambdas, self.Neff)

    def loocv(self, G3: torch.Tensor) -> torch.Tensor:
        """LOOCV W of a group of residualized blocks: [n, N, J, P] (as
        kfold on a mesh that spans processes)."""
        if self.mesh is not None:
            N = G3.shape[2]
            Ws = [pm.sharded_level0_loocv(self.mesh, g, self.Y_sh, self.mask_sh,
                                          self.lambdas, self.Neff, dst=0)
                  for g in G3]
            return None if Ws[0] is None else torch.stack([W[:N] for W in Ws])
        return m1.level0_loocv_blocks(G3, self.Y, self.mask, self.lambdas, self.Neff)


def _level0(params, st: Step1Setup, log):
    """Stream genotype blocks -> level-0 CV predictions W on the host
    (level_0_calculations, Data.cpp:594). Returns (W_all, blocks per
    chromosome). W_all is block-major, [nb, K, nmax, J, P] for K-fold or
    [nb, N, J, P] for LOOCV, so that each block's W lands in one
    contiguous host range (a strided write of [K, nmax, F, P] cost more
    than the block's device work)."""
    J, P, N = params.n_ridge_l0, params.n_pheno, params.n_samples
    gd, blocks, dev = st.gd, st.blocks, st.device
    l0 = Level0(params, st)
    chr_nblocks: Dict[int, int] = {}
    # only the output host, which runs level 1, keeps the predictions (on
    # a mesh that spans processes only it receives them)
    if not is_output_host():
        W_all = None
    elif params.use_loocv:
        W_all = _alloc_W(params, (len(blocks), N, J, P))
    else:
        W_all = _alloc_W(params, (len(blocks), params.cv_folds,
                                  int(st.fold_sizes.max()), J, P))
    log(f" * level 0 on {dev} (float64)" if st.mesh is None else
        f" * level 0 on {st.mesh.size} shards (float64, sample-sharded)")

    def store(bi, W):
        if W_all is not None:
            torch.from_numpy(W_all[bi]).copy_(W)

    # one-block read lookahead: the reader thread reads the next block's
    # packed bytes (or decodes its dosages) while this block solves; the
    # upload and the device decode stay on this thread's stream. With the
    # per-host window it reads only this process's window of each block.
    if l0.window is not None:
        log(f" * per-host decode: each of {process_count()} processes unpacks "
            "only its own sample byte window")
        read = lambda bsnps: l0.read_window(gd, bsnps)  # noqa: E731
    else:
        read = gd.read_block_host
    pool = ThreadPoolExecutor(max_workers=1)
    fut = pool.submit(read, blocks[0][1]) if blocks else None

    # LOOCV: consecutive same-shape blocks solve in ONE batched dispatch
    # (batched [n, B, B] eigh; Step1_Models.cpp:494). No block's W depends
    # on another's, so the grouping changes no result.
    # (on a mesh each block is solved alone, as in the JAX package)
    stack1 = (1 if st.mesh is not None else
              max(1, int(os.environ.get("REGENIE_TPU_STEP1_STACK", "4"))))
    grp: list = []

    def flush():
        if not grp:
            return
        try:
            Wg = l0.loocv(torch.stack([g for _, g in grp]))
            for i, (bi, _g) in enumerate(grp):
                store(bi, None if Wg is None else Wg[i])
        except torch.cuda.OutOfMemoryError:
            # the group holds its blocks, their stack and an [n, B, B]
            # eigh workspace at once; one block at a time may still fit
            log(f"   -batched level-0 group of {len(grp)} blocks ran out of "
                "device memory; solving its blocks one at a time "
                "(REGENIE_TPU_STEP1_STACK=1 to silence)")
            torch.cuda.empty_cache()
            for bi, g in grp:
                Wb = l0.loocv(g[None])
                store(bi, None if Wb is None else Wb[0])
        grp.clear()

    t0 = time.time()
    copy_s = 0.0
    if params.test_l0:
        params._l0_nspns_picked = np.zeros(P, dtype=int)
        params._l0_top_pgs = {}
    if params.print_block_betas:
        params._print_beta_snp = []
    try:
        for bidx, (chrom, bsnps) in enumerate(blocks):
            chr_nblocks[chrom] = chr_nblocks.get(chrom, 0) + 1
            raw = fut.result()
            if bidx + 1 < len(blocks):
                fut = pool.submit(read, blocks[bidx + 1][1])
            if params.debug:
                # the reference's per-block memory trail (Data.cpp:594+)
                log(f"   -level 0 block {bidx + 1}/{len(blocks)} chr {chrom} "
                    f"[{len(bsnps)} snps] {rss_line()}")
            tb = time.time()
            if l0.window is not None:
                store(bidx, l0.window_loocv(raw, bsnps))
                if params.verbose:
                    log(f"   -level 0 block {bidx + 1}/{len(blocks)} chr {chrom} "
                        f"[{len(bsnps)} snps]: {time.time() - tb:.3f}s")
                continue
            G = l0.residualized(gd.read_block_device(bsnps, dev, raw), bsnps)
            if params.test_l0:
                G = _test_l0(params, st.pd, G, bidx, chrom, log)
            if params.use_loocv and params.print_block_betas:
                # --print: the block's per-SNP level-0 betas on the raw
                # genotype scale (Data.cpp:674), one block at a time
                Wb, bsnp = m1.level0_loocv_block_betas(G, l0.Y, l0.mask, l0.lambdas,
                                                       l0.Neff)
                params._print_beta_snp.append(
                    (bsnps, bsnp.cpu().numpy() / (l0.scale_G[:, None] / st.pd.scale_Y[0])))
                store(bidx, Wb)
                what = ""
            elif params.use_loocv:
                if grp and grp[-1][1].shape != G.shape:
                    flush()
                grp.append((bidx, G))
                if len(grp) >= stack1 or bidx == len(blocks) - 1:
                    flush()
                what = ""
            else:
                Wb = l0.kfold(G)
                del G
                _sync(dev)
                tc = time.time()
                if Wb is not None:
                    store(bidx, Wb)
                del Wb
                dt = time.time() - tc
                copy_s += dt
                what = f", W to host {dt:.3f}s"
            if params.verbose:
                log(f"   -level 0 block {bidx + 1}/{len(blocks)} chr {chrom} "
                    f"[{len(bsnps)} snps]: {time.time() - tb:.3f}s{what}")
        flush()  # safety net; the loop flushes on its last block
    finally:
        pool.shutdown(wait=True)
    secs = time.time() - t0
    log(f" * level 0 done ({secs:.3f}s, {len(blocks)} blocks: "
        f"{secs / max(len(blocks), 1):.3f}s a block, "
        f"{params.n_variants / max(secs, 1e-9):.1f} variants/s"
        + ("" if params.use_loocv else f"; W to host {copy_s:.3f}s") + ")")
    return W_all, chr_nblocks


def _test_l0(params, pd, G, bidx, chrom, log):
    """--test-l0 on a residualized block: the top SNPs of each trait
    (models/step1.test_l0_block, on the host), their PGS summed per
    chromosome, and the block without the SNPs picked for every trait."""
    picked, n_new, pgs_blk = m1.test_l0_block(params, G.cpu().numpy(), pd.phenotypes,
                                             params._l0_nspns_picked, log)
    params._l0_nspns_picked += n_new
    if n_new.any():
        log(f"   -block {bidx + 1}: top SNPs per trait = {[int(x) for x in n_new]}")
        prev = params._l0_top_pgs.get(chrom)
        params._l0_top_pgs[chrom] = pgs_blk if prev is None else prev + pgs_blk
    rm = picked.all(axis=1)
    if rm.any():
        G = G[torch.as_tensor(np.flatnonzero(~rm), device=G.device)]
    return G


def _trait_W(W_all, ph, dev) -> torch.Tensor:
    """One trait's level-0 predictions on the device, columns F = nb * J
    in block order: [K, nmax, F] (K-fold) or [N, F] (LOOCV)."""
    w = torch.as_tensor(np.ascontiguousarray(W_all[..., ph]), device=dev)
    w = w.movedim(0, -2)  # [(K,) n, nb, J]
    return w.reshape(*w.shape[:-2], -1)


def _level1_and_output(params, gd, pd, W_all, taus, h_l1, chr_nblocks,
                       fold_sizes, dev, log, offsets=None):
    """Level-1 ridge per trait on the device, then its LOCO file
    (ridge_level_1*, make_predictions*, write_predictions): the linear
    ridge of quantitative traits, the penalized logistic, Poisson or Cox
    ridge of binary, count and time-to-event traits (models/step1_bt.py,
    on the null `offsets`), and with --write-null-firth a binary trait's
    .firth file of null Firth fits a chromosome."""
    J, P, N = params.n_ridge_l0, params.n_pheno, params.n_samples
    ind = pd.ind_in_analysis
    pred_list_path = params.out_prefix + "_pred.list"

    chr_order = [c for c in gd.chr_read if chr_nblocks.get(c, 0) > 0]
    spans = {}
    ctr = 0
    for c in chr_order:
        spans[c] = (ctr, chr_nblocks[c] * J)
        ctr += chr_nblocks[c] * J

    sample_ids = [s.key for s in gd.samples]
    order = sorted(range(N), key=lambda i: sample_ids[i])
    id_order = np.array([i for i in order if ind[i]], dtype=np.int64)
    header = "FID_IID " + " ".join(sample_ids[i] for i in id_order) + " \n"

    def put(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float64), device=dev)

    if params.use_loocv:
        Y_t = put(pd.phenotypes)
    else:
        Y_folds, valid = m1.pad_folds(pd.phenotypes, fold_sizes)
        Yf_t, valid_t = put(Y_folds), put(valid)
        bounds = np.concatenate([[0], np.cumsum(fold_sizes)])

    # --select-l0 FILE: the level-0 blocks' p-values per trait
    # (prep_l1_models, Data.cpp:785-805)
    l0_pv_tab = None
    F_total = ctr
    if params.select_l0:
        if not params.l0_pvals_file:
            raise ValueError(
                "--select-l0 as a bare flag needs in-run block p-values "
                "which are not recorded; pass a p-value FILE instead")
        l0_pv_tab = _read_l0_pvals(params, P)
    # --test-l0: the top SNPs' PGS per chromosome (top_snp_pgs, Data.cpp:628)
    pgs_by_chr = getattr(params, "_l0_top_pgs", {}) if params.test_l0 else {}
    pgs_tot = sum(pgs_by_chr.values()) if pgs_by_chr else None

    t0 = time.time()
    write_s = firth_s = 0.0
    gz = ".gz" if params.gz_out else ""
    prs_list = open_write(params.out_prefix + "_prs.list") if params.print_prs else None
    firth_list = (open_write(params.out_prefix + "_firth.list")
                  if params.write_null_firth else None)
    with open_write(pred_list_path) as plist:
        for ph in range(P):
            if not pd.pheno_pass[ph]:
                continue
            name = pd.pheno_names[ph]
            loco_path = params.out_prefix + f"_{ph+1}.loco" + gz
            log(f"phenotype {ph+1} ({name}):")
            predictions = np.zeros((N, len(chr_order)))
            l0_idx = ph
            if params.trait_mode == T2E and params.t2e_event_l0:
                # --t2e-event-l0: the event column's level-0 predictions
                # feed level 1 (l0_idx = event_index, Step1_Models.cpp:2259)
                l0_idx = pd.pheno_names.index(params.t2e_map[name])
            Wph = _trait_W(W_all, l0_idx, dev)
            # per-trait level-0 column selection (check_l0,
            # Step1_Models.cpp:1989): the kept columns, their spans and the
            # penalties rescaled by the kept share
            spans_ph, taus_ph, sel_mult = spans, np.asarray(taus), None
            if l0_pv_tab is not None:
                colkeep, mult_full = m1.check_l0_selection(params, l0_pv_tab[:, ph], log)
                if not colkeep.all() or (mult_full != 1).any():
                    sel_idx = np.flatnonzero(colkeep)
                    sel_mult = mult_full[colkeep]
                    spans_ph, ctr2 = {}, 0
                    for c in chr_order:
                        st, nn = spans[c]
                        kept = int(colkeep[st : st + nn].sum())
                        spans_ph[c] = (ctr2, kept)
                        ctr2 += kept
                    taus_ph = np.asarray(taus) * (len(sel_idx) / F_total)
                    if sel_mult.min() == 1.0:
                        sel_mult = None  # pure column dropping
                    Wph = Wph.index_select(-1, torch.as_tensor(sel_idx, device=dev))
            taus_t = put(taus_ph)
            mult_t = None if sel_mult is None else put(sel_mult)
            if params.trait_mode != QT:
                t1 = time.time()
                predictions, converged = step1_bt.level1_nonqt(
                    params, pd, Wph, offsets, taus_ph, ph, chr_order, spans_ph,
                    fold_sizes, log, ridge_mult=sel_mult)
                if params.verbose:
                    log(f"  level 1 of {name}: {time.time() - t1:.3f}s")
                if not converged:
                    log("Level 1 model did not converge. LOCO predictions skipped.")
                    continue
            elif params.use_loocv:
                pgs_t = None if pgs_tot is None else put(pgs_tot[:, ph])
                out = m1.level1_linear_loocv(
                    Wph, Y_t[:, ph], taus_t, float(pd.Neff[ph] - params.ncov),
                    ridge_mult=mult_t, pgs=pgs_t)
                cumsum, cumsum_full = ((out.cpu().numpy(), None) if pgs_t is None
                                       else (x.cpu().numpy() for x in out))
                best = m1.select_best_tau_qt(cumsum, pd.Neff[ph])
                _log_tau_table(log, h_l1, cumsum, best, pd.Neff[ph], cumsum_full)
                Yfit = Y_t[:, ph] if pgs_t is None else Y_t[:, ph] - pgs_t
                b0, bvec = m1.level1_linear_full_fit_loocv(
                    Wph, Yfit, float(taus_ph[best]), ridge_mult=mult_t)
                for ci, c in enumerate(chr_order):
                    st, nn = spans_ph[c]
                    predictions[:, ci] = (Wph[:, st : st + nn]
                                          * b0[st : st + nn].T).sum(dim=1).cpu().numpy()
                if params.print_block_betas:
                    _write_step1_betas(params, bvec.cpu().numpy(), log)
            else:
                pgs_f = None
                if pgs_tot is not None:
                    pgs_f = put(m1.pad_folds(pgs_tot[:, ph : ph + 1], fold_sizes)[0][:, :, 0])
                out = m1.level1_linear_kfold(Wph, Yf_t[:, :, ph], valid_t, taus_t,
                                             ridge_mult=mult_t, pgs_folds=pgs_f)
                beta, cumsum = out[0], out[1].cpu().numpy()
                cumsum_full = None if pgs_f is None else out[2].cpu().numpy()
                best = m1.select_best_tau_qt(cumsum, pd.Neff[ph])
                _log_tau_table(log, h_l1, cumsum, best, pd.Neff[ph], cumsum_full)
                if params.print_block_betas:
                    # K-fold --print: fold-averaged level-1 betas
                    # (make_predictions, Data.cpp:1221-1243)
                    beta_avg = beta[:, best, :].mean(dim=0).cpu().numpy()
                    with open(params.out_prefix + "_level1.betas", "a") as fh:
                        fh.write(f"{ph + 1} " + " ".join(fmt(b) for b in beta_avg) + "\n")
                for ci, c in enumerate(chr_order):
                    st, nn = spans_ph[c]
                    pc = (Wph[:, :, st : st + nn]
                          @ beta[:, best, st : st + nn, None])[..., 0].cpu().numpy()
                    for k in range(params.cv_folds):
                        predictions[bounds[k] : bounds[k + 1], ci] = pc[k, : int(fold_sizes[k])]
            if params.trait_mode == QT:
                # the top SNPs' PGS back into its own chromosome's
                # predictions (Data.cpp:1254/1324)
                for ci, c in enumerate(chr_order):
                    if c in pgs_by_chr:
                        predictions[:, ci] += pgs_by_chr[c][:, ph]
            del Wph

            tw = time.time()
            total = predictions.sum(axis=1)
            _write_loco(loco_path, header, params, pd, ph, predictions, total,
                        chr_order, id_order)
            plist.write(f"{name} {loco_path if params.use_rel_path else os.path.abspath(loco_path)}\n")
            log(f"  wrote {loco_path}")
            if prs_list is not None:
                # whole-genome PRS: single chr-0 row (write_predictions,
                # Data.cpp:1905-1925)
                prs_path = params.out_prefix + f"_{ph+1}.prs" + gz
                with _open_bytes(prs_path) as fh:
                    fh.write(header.encode())
                    fh.write(format_value_rows(total[id_order][None, :],
                                               pd.masked_indivs[id_order, ph], [0]))
                prs_list.write(f"{name} {prs_path if params.use_rel_path else os.path.abspath(prs_path)}\n")
            write_s += time.time() - tw
            if firth_list is not None and params.trait_mode == BT:
                tf = time.time()
                fpath = _write_null_firth_step1(params, pd, ph, predictions, total,
                                                chr_order, log)
                if fpath:
                    firth_list.write(f"{name} {os.path.abspath(fpath)}\n")
                firth_s += time.time() - tf
    if prs_list is not None:
        prs_list.close()
        log(f"List of files with whole genome PRS written to: [{params.out_prefix}_prs.list]")
    if firth_list is not None:
        firth_list.close()
        log("List of files with null Firth estimates written to: "
            f"[{params.out_prefix}_firth.list]")
    secs = time.time() - t0
    log(f" * level 1 + predictions done ({secs:.3f}s: level 1 "
        f"{secs - write_s - firth_s:.3f}s, LOCO files {write_s:.3f}s"
        + (f", null Firth files {firth_s:.3f}s" if firth_list is not None else "")
        + ")")
    log(f"List of blup files written to: [{pred_list_path}]")


def _write_l0_master(params, blocks, prefix, njobs, log):
    """write_l0_master (Data.cpp:244-309): master + per-job snplists."""
    total = len(blocks)
    if njobs <= 1:
        raise ValueError("number of jobs must be >1")
    if njobs > total:
        log("   -WARNING: Number of jobs cannot be greater than number of blocks.")
        njobs = total
    log(f" * running level 0 in parallel across {total} genotype blocks")
    log(f"   -using {njobs} jobs")
    mpath = prefix + ".master"
    nall = total // njobs
    remainder = total - nall * njobs
    with open_write(mpath) as mf:
        mf.write(f"{params.n_variants} {params.block_size}\n")
        jcount = 0
        bidx = 0
        while bidx < total:
            btarget = nall + (1 if jcount < remainder else 0)
            job_blocks = blocks[bidx : bidx + btarget]
            ns = sum(len(b[1]) for b in job_blocks)
            fname = f"{prefix}_job{jcount+1}"
            mf.write(f"{fname} {btarget} {ns}\n")
            with open_write(fname + ".snplist") as sf:
                for _, bsnps in job_blocks:
                    for s in bsnps:
                        sf.write(s.ID + "\n")
            bidx += btarget
            jcount += 1
    log(f"   -master file written to [{mpath}]")


def _log_tau_table(log, h_l1, cumsum, best, neff, cumsum_full=None):
    rsq = m1.cv_rsq(cumsum, neff)
    sse = (cumsum[2] + cumsum[3] - 2 * cumsum[4]) / neff
    rsq_full = m1.cv_rsq(cumsum_full, neff) if cumsum_full is not None else None
    for j in range(len(h_l1)):
        line = f"  {fmt(h_l1[j]):>5} : Rsq = {fmt(rsq[j])}"
        if rsq_full is not None:
            line += f" (with top_snps_pgs = {fmt(rsq_full[j])})"
        line += f", MSE = {fmt(sse[j])}"
        if j == best:
            line += "<- min value"
        log(line)


def _read_l0_pvals(params: Params, P: int) -> np.ndarray:
    """--select-l0 FILE: per-block -log10 p per trait (prep_l1_models,
    Data.cpp:785-805). Rows: CHROM BLOCK pv1..pvP."""
    pvs = np.zeros((params.total_n_block, P))
    lineread = 0
    for toks in iter_lines(params.l0_pvals_file):
        if lineread >= params.total_n_block:
            raise ValueError(
                "number of blocks in file is greater than that analyzed in run.")
        if len(toks) > P + 2:
            raise ValueError(
                "number of phenotypes in file is greater than that analyzed in run.")
        for i in range(P):
            pvs[lineread, i] = float(toks[i + 2])
        lineread += 1
    return pvs


def _write_step1_betas(params: Params, l1_betas: np.ndarray, log) -> None:
    """--print (LOOCV): <out>_step1_betas.txt with per-SNP level-0 and
    whole-model betas (print_snp_betas, Data.cpp:1755-1790)."""
    J = params.n_ridge_l0
    out = params.out_prefix + "_step1_betas.txt"
    with open_write(out) as fh:
        fh.write("SNP\tCHROM\tGENPOS\tALLELE0\tALLELE1\tBETA_level_0\tBETA\n")
        for block, (bsnps, bsnp) in enumerate(getattr(params, "_print_beta_snp", [])):
            bl1 = bsnp * l1_betas[block * J : (block + 1) * J][None, :]
            for i, s in enumerate(bsnps):
                fh.write(
                    f"{s.ID}\t{s.chrom}\t{s.physpos}\t{s.allele1}\t{s.allele2}\t"
                    f"{fmt(bsnp[i].sum())}\t{fmt(bl1[i].sum())}\n"
                )
    log(f"  wrote {out}")


def _write_loco(path, header, params: Params, pd, ph, predictions, total,
                chr_order, id_order):
    """Per-chromosome LOCO predictions (write_predictions, Data.cpp:1795):
    the header, then one row for every chromosome 1..n_chrom, present or
    not, each the whole-genome prediction less that chromosome's."""
    chr_idx = {c: i for i, c in enumerate(chr_order)}
    chroms = list(range(1, params.n_chrom + 1))
    V = np.tile(total[id_order], (len(chroms), 1))
    for r, chrom in enumerate(chroms):
        if chrom in chr_idx:
            V[r] -= predictions[id_order, chr_idx[chrom]]
    payload = format_value_rows(V, pd.masked_indivs[id_order, ph], chroms)
    with _open_bytes(path) as fh:
        fh.write(header.encode())
        fh.write(payload)


def _open_bytes(path):
    """A file for bytes: a GzipWriter for a .gz path (--gz); off the
    output host of a multi-process run a null sink."""
    return GzipWriter(path) if path.endswith(".gz") else open_write_bytes(path)


def _write_null_firth_step1(params, pd, ph, predictions, total, chr_order, log):
    """A binary trait's <out>_<i>.firth: the approximate-Firth null
    coefficients of each chromosome 1..n_chrom with that chromosome's
    LOCO offset (write_predictions firth branch, Data.cpp:1875-1902), on
    the host in numpy float64, each fit started from the previous one.
    Returns the path, or None when a fit fails."""
    from .models import firth as firth_mod

    fpath = params.out_prefix + f"_{ph+1}.firth" + (".gz" if params.gz_out else "")
    y = pd.phenotypes_raw[:, ph]
    mask = pd.masked_indivs[:, ph]
    chr_idx = {c: i for i, c in enumerate(chr_order)}
    bstart, _ = glm.fit_logistic_irls(y, pd.new_cov, np.zeros(len(y)), mask,
                                      params.niter_max, params.numtol)
    lines = []
    for chrom in range(1, params.n_chrom + 1):
        loco = total.copy()
        if chrom in chr_idx:
            loco -= predictions[:, chr_idx[chrom]]
        bnull, ok = firth_mod.fit_firth_null(
            y, pd.new_cov, loco * mask, mask, bstart.copy(),
            maxstep=params.maxstep_null, niter=params.niter_max_firth_null,
            tol=50 * params.numtol,
        )
        if not ok:  # retry from 0 with smaller steps (fit_approx_firth_null)
            b2 = np.zeros(pd.new_cov.shape[1])
            b2[0] = -(loco * mask)[mask].mean()
            bnull, ok = firth_mod.fit_firth_null(
                y, pd.new_cov, loco * mask, mask, b2,
                maxstep=params.maxstep_null // 5,
                niter=params.niter_max_firth_null * 5,
                tol=50 * params.numtol,
            )
        if not ok:
            log("WARNING: Firth failed to converge; skipping null-firth file")
            return None
        bstart = bnull  # the next chromosome starts here
        lines.append(f"{chrom} " + " ".join(fmt(b) for b in bnull))
    with open_write(fpath, gz=params.gz_out) as fh:
        fh.write("\n".join(lines) + "\n")
    return fpath
