#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (regenie_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, each of which must pass. The full-width datasets (the BED of
phases 3 to 3c with 3b's binary traits, the BGEN of 4 and 4b, the Step-1
BED of 5 to 5b with their binary and time-to-event tables, the PGEN of
5c, the gene BED of 5d and 5e) are written by one background process
from the end of the build on, while the card runs phases 2 and 2b, and
each slice waits for its own. Phase 3c runs first, alone on the card;
then the smoke runs in two lanes: a side process runs phase 6 (the
cross-check) and then phases 5 to 5b (the Step-1 slices), beside this
process's 3, 3a, 3a', 3b, 4, 4b and 5c to 5e, and 3c's CPU check runs in a
thread beside 3 and 3b (3b's host null fits leave the card idle); both
lanes spend most of their time on the host, and the card is shared
between them, so a CUDA-event time of a phase after 3c may include
kernels of the other lane. The lanes' largest card allocations, whose
peaks do not fit in the card's 80 GB together (4b, the two processes
of 3a', and level 1 at a real depth in 5, 5a and 5b), hold one lock in
turn (_card_heavy), and both processes' allocators map expandable
segments. A slice's Step-2 or Step-1 run goes through the port's CLI
(cli.main, its gate of unported modes and its <out>.log included) in its
lane's process, and its block checks reuse the engine or setup that
the CLI's entry point returned (run_cli_kept). The side process's lines print after 3b (phase 6) and
after 5e (phases 5 to 5b), its phases' "done at" times on this clock.

1. build: compile every CUDA kernel of the port from ops/csrc/ with nvcc
   (one process per source, started together), and report whether the
   native libraries (the root native/ library, the port's BGEN plane
   extractor with zstd, its PGEN block decoder) load, and with which
   symbols.
2. kernel: hold each kernel against its plain PyTorch version on the card
   on ragged shapes and at the full width of the repository's UKB shape
   (N=400,000 samples, P=50 traits of which 10 incomplete, K=20, blocks of
   2048 variants): the int8 kernels' integer products exactly equal, the
   float32-operand kernels' float64 products within 1e-12 of the same
   product against |W|, the bf16 split kernels' within 4096 x 2^-23 of it
   (one float32 partial sum of 4096 terms), the plane decode exactly
   equal; and time the kernel, its plain version, its bound and the
   library yardstick (for fused_i8 and bgen_i8, torch._int_mm with B
   row-major and with B K-major, the faster kept). The five profiling
   configurations of the bf16 products (csrc/profile_fused.cu: stacked,
   stacked-2dots, nodecode, decode-only, pipelined, and the other Hopper
   configurations of stacked and pipelined) are held the same way,
   decode-only exactly. The seven profiling variants of the BGEN int8
   products (csrc/profile_bgen.cu, and the other tile configurations of
   u8_unshift_q3) equal their plain versions exactly, on planes with
   missing samples, on both plane layouts (k0, k1 views of one [B, 2, Np]
   buffer, and two [B, Np] tensors), on ragged shapes and at bgen_i8's
   full width. fused_i8 and bgen_i8 are also held at the binary-trait
   operand's widths (fused_i8 Cw4 = 4 x 1,280; bgen_i8 Cw = 4 x 1,280,
   Cq = 4 x 256) against their plain versions and timed beside
   torch._int_mm (printed; the kernels line keeps the QT width), and the
   int8 operand's quantization on the card (fused_score.i8_quantize)
   against the host's numpy quantization on a full-height operand with a
   zero column, half-way ties and maxima at and around 127 x 2^k: limbs
   and scales bit for bit, column sums exact. The full-width block of
   fused_i8 and of bgen_i8 is also split into two row shards of the card
   (parallel/mesh.py), a launch a shard: the products put back together
   exactly equal the whole block's.
2b. profile path: the port's profiling entry points in this process at
   the full width with 1 round of 2 blocks, the launch counts set to 0
   just before each run and read just after:
   regenie_tpu_torch.scripts.profile_fused.main, where every variant's
   kernel launches as often as the script calls it and no other kernel,
   and its two correctness lines (pipelined and stacked against prod)
   stay within 2 x 4096 x 2^-23 of the products against |W|; then
   regenie_tpu_torch.scripts.profile_bgen.main in each of its four modes,
   where each line's kernel launches 4 times (a warm-up, a call a block,
   its check) and no other kernel, and every check line is 0.
3. BED slice: a synthetic PLINK BED at that shape (M = 2 blocks of
   2048 variants, null phenotypes) and the port's Step 2 on the card by
   default, where fused_i8 must launch once per
   block and no other kernel (the REGENIE_TPU_I8=0 CLI run, fused_f32,
   is the cross-check's BED --htp run); check the output files, and that
   the first block on the int8 and on the float32 operand (fused_f32, in
   memory) agrees with the port's plain path (float64 operand, plain
   products) on the card: max |dLOG10P| <= 1e-5, max |dBETA| <= 1e-6,
   the repository's cross-backend bar.
3a. mesh slice: on the BED slice's own BED, the same CLI run on the
   port's single-process mesh (REGENIE_TPU_MESH=1 with two shards of the
   one card, REGENIE_TPU_TORCH_MESH_DEVICES=cuda:0,cuda:0): each block's
   rows split in two, fused_i8 launched once a shard (twice a block, no
   other kernel) on one shared operand, the rows gathered back in order;
   its 50 files hold [bed slice]'s text fields and LOG10P / BETA within
   the slice bars, the rows not byte-identical counted; printed beside
   [bed slice]'s wall. One card shows the sharding, the per-shard
   launches and the gather; not copies between cards or their speed.
3a'. multiprocess slice: the same CLI run as two processes of one launch
   (parallel/dist.py: REGENIE_TPU_COORDINATOR=127.0.0.1:<free port>, each
   process REGENIE_TPU_TORCH_MESH_DEVICES=cuda:0, so a global mesh of two
   shards of the one card, gloo between the processes), started together
   through this file's child entry (python3 chip_smoke.py
   --multiprocess-child REPORT ARGV, which runs cli.main and reports its
   launch counts), under the lanes' card lock, beside phase 3b (whose host
   null fits leave the card idle; its checks print after 3b's lines):
   each process reads only
   its own rows of each block and launches fused_i8 once a block and no
   other kernel; the output host's log shows the distributed and the
   per-host decode lines; process 1 writes no file and prints nothing;
   the 50 files hold [mesh slice]'s within _compare_files' bars (|dLOG10P|
   <= 1e-5), the rows not byte-identical counted; both processes' walls
   printed beside [mesh slice]'s.
3b. BT slice: on the BED slice's own BED, a binary-trait table (its
   traits thresholded at 5-30% prevalence) and one run of the CLI with
   --bt --firth --approx --af-cc: fused_i8
   launches once per block and no other kernel, the 50 files are well
   formed; printed: the null fits' and the corrections' seconds, the
   corrected and failed counts, the wall and variants/s. Then block 1 in
   memory through the same engine: the operand rebuilt (int8, quantized
   on the card) and a float64 plain engine on the same null fits; flips
   equal, the int8 products' num, denum and statistics against the
   plain ones, the threshold rows (a statistic on the two sides of the
   correction threshold on the two routes) counted and printed, every
   other LOG10P within 1e-5, both routes correcting with SPA; the
   card's Firth and SPA against the host twins on one trait's corrected
   rows (flags equal, rtol 1e-6 and 1e-5); and exact Firth on the card
   (the batched float64 solver) for the rows past the threshold of two
   traits (at least 64), timed per row, 2 rows of each against the host
   twin: flags equal, LRT within rel 1e-8, |dLOG10P| within 1e-5.
3c. LD slice (before 3, alone on the card): on the BED of 3, the port's LD mode
   (--compute-corr, the default binary r^2 output) through the CLI on
   the card for M = 2,048 of its variants (every other one, by
   --extract): a gene region's or a remeta block's size, at N = 400,000,
   K = 20. No hand-written kernel may launch (the counts set to 0 just
   before the run and read just after); the .corr file's int32 [N, M]
   header and M (M - 1) / 2 uint16 codes, and the .corr.snplist, are
   checked. Printed, beside the card's name and power limit: the CLI wall
   and run-up, the host read of the packed bytes, their upload (decoded
   to int8 on the card), the card's imputation, covariate projection and
   G'G (CUDA events; G'G against its bound, the larger of 2 M^2 N FP64
   operations at 67 TFLOP/s and G's bytes at 3.35 TB/s), and the host's
   scaling and write. Then the same int8 codes through the same functions
   on the CPU (float64): the card's correlations within 1e-10 of the
   CPU's before quantization, and a uint16 code may differ by 1 only
   where the CPU's r^2 * 65535 + 0.5 lies within 1e-6 of an integer
   (counted and printed).
4. BGEN slice: the same on a synthetic 8-bit zlib BGEN at that shape
   (imputed-like probabilities, 1% missing; M = 2 blocks), through
   --bgen/--sample: bgen_i8 launches once per block and no other kernel
   (the REGENIE_TPU_I8=0 CLI run, bgen_f32, is the cross-check's BGEN
   --minINFO run); the first block on both operands meets the same bar,
   and its INFO and A1FREQ agree with the plain path within rel 1e-9.
   Split path (in each slice phase): the bf16 hi|mid|lo split consts,
   built by build_consts(split=True) from the engine's per-sample arrays,
   score the first block through make_qt_block_fn (BED, with
   score_block_fused on random allele flips beside it) or
   make_qt_bgen_fn (BGEN): fused_bf16 / bgen_bf16 launch and no other
   kernel, and the block meets the same bars against the plain path.
4b. dense slice: the dense Step-2 route (the JAX package's dense path,
   plain float64 torch ops) at the same width, on the BGEN slice's own
   dataset: its first block read through the port's dosage decoder
   (io/csrc/bgen_dosages.cpp), uploaded and scored by the BGEN slice's
   engine (host read, the records' Python read alone, upload, and the
   card's stats / finalize / one-pass parts with CUDA events), its INFO
   and A1FREQ within rel 1e-9 of the fused route's, N equal, LOG10P and
   BETA at the slice bars; then one CLI run with REGENIE_TPU_FUSED=0 and
   the slice's flags: no hand-written kernel may launch, the log must
   show the dense route on cuda, and the 50 files (both blocks) must
   meet the slice bars against the bgen_i8 run's (A1FREQ, INFO and N
   printing equal, or one unit of the sixth digit apart across a
   rounding boundary). Printed: each block's host read and upload (the
   CLI's block lines), the CLI wall and variants/s.
5. Step-1 slice: a synthetic PLINK BED at that width (N=400,000, P=50,
   K=20) with a polygenic effect, 2 chromosomes x 2,000 variants, and the
   port's Step-1 CLI on the card in the side process (--bsize 1000: 4
   level-0 blocks; 5-fold CV, J = T = 5), after checking that the
   temporary directory has room for the ~6 GB of LOCO files: no
   hand-written kernel may launch (Step 1 is float64 cuBLAS and
   cuSOLVER), the log must show level 0 on cuda, and the 50 .loco files
   and _pred.list must be well formed. The first block's level-0 parts
   are timed with CUDA events (and eigh with MAGMA beside cuSOLVER, not
   used), its W held against the same functions in float64 on the CPU
   (max |dW| <= 1e-8), the same block's level 0 sample-sharded on two
   shards of the card (run_step1.Level0 on a mesh for K-fold, and
   parallel.mesh.sharded_level0_loocv) against the unsharded K-fold and
   LOOCV W (max |dW| <= 1e-8), and level1_linear_kfold timed for one
   trait at a real depth (F = 2,500, 8 GB of synthetic predictions).
5a. Step-1 BT slice: on the Step-1 slice's own BED (its QT LOCO files
   removed), a binary-trait table of the writer's traits (5-30%
   prevalence) and the port's Step-1 CLI with --bt at the same width
   (K-fold, J = T = 5): no hand-written kernel may launch, level 0 on
   cuda, the 50 .loco files well formed; printed: the null fits', level
   0's, level 1's and the LOCO files' times. Then the penalized logistic
   level 1 of one trait at a real depth (F = 2,500, K-fold, N = 400,000,
   8 GB of predictions drawn on the card) timed per ridge parameter and
   per Newton iteration, and the same function at N = 20,000, F = 250 on
   the card against the CPU in float64 (the same ridge parameter,
   predictions within 1e-9 of their largest magnitude).
5b. T2E slice: on the Step-1 slice's own BED (its QT and BT LOCO files
   removed), 10 time-to-event endpoints (write_t2e_table: T1..T10 and
   E1..E10, log-hazards from the writer's traits with their covariate
   share rescaled, exponential times rounded to 0.01 so that event times
   tie, censoring spread for event rates of 5-30%, T1 and T2 with 5% NA
   times) and the port's Step-1 CLI with --t2e at the same width
   (K-fold, J = T = 5): no hand-written kernel may launch, level 0 on
   cuda, the 10 .loco files and _pred.list well formed; printed: the
   null fits', level 0's, each endpoint's level 1 and the LOCO files'
   times. The Cox level 1 alone at F = 2,500 (N = 400,000, 8 GB of
   predictions drawn on the card): 3 coordinate sweeps of one (fold,
   penalty) timed, the Gram of a sweep beside its FP64 bound; the same
   function at N = 20,000, F = 250 on the card against the CPU (the same
   penalty, predictions within 1e-9 of their largest magnitude). Then
   the Step-2 CLI with --t2e --pred on that _pred.list (no --firth: the host's
   null Cox Firth costs minutes an endpoint at this N): fused_i8 launches
   once per block and no other kernel, the 10 files well formed; printed:
   the null fits' seconds per chromosome, the wall and variants/s. The
   last chromosome's block in memory through the run's engine against a
   float64 plain engine on the same null fits: flips equal, max
   |dLOG10P| <= 1e-5, max |dBETA| <= 1e-6; fused_i8 at the Cox operand's
   width (Cw4 = 4 x 512) exactly equal to its plain version, timed beside
   torch._int_mm (B K-major; printed, the kernels line keeps the QT
   width).
5c. PGEN chrX slice: a synthetic PLINK2 PGEN at that width (storage
   mode 0x10; a quarter of the records LD-compressed difflists, half of
   them inverted; half the samples male in the .psam) of 2 blocks, one on
   chromosome 1 and one on chrX (1/8 of its variants in PAR1, the rest
   non-PAR), and the port's Step-2 CLI on the card with --gz: fused_i8
   launches once per block and no other kernel, the 50 .regenie.gz files
   decompress and are well formed; both blocks agree with the plain path
   on the card (the slice bars; on chrX A1FREQ, N and the hemizygous MAC
   within rel 1e-9). Printed: the PGEN host read (the native decoder) and
   fused_i8's time per block, block 1's operand build with the male tail,
   the split / merged / gzipped writes of the two blocks' rows, the CLI
   wall and variants/s.
5d. gene slice: an exome-like BED at that width (2 x 192 variants, 60%
   rare, in 16 sets of 24 annotated LoF, missense or synonymous; masks
   M1 to M3) and one gene-based CLI run on the card (--set-list,
   --aaf-bins 0.01,0.001, --vc-tests skato,acatv, --joint acat, buckets
   of 8 sets, the stage table on): no hand-written kernel launches, the
   50 files are well formed; printed: the wall, sets/s, the stage table,
   and the first bucket's VC products on the card (against their FP64
   bound) and on the CPU, within F64_SUM_BAR of each other.
5e. interaction slice: on the gene slice's own BED (N = 400,000, P = 50,
   K = 20), one CLI run of --interaction C1 on chromosome 1 (192
   variants; 60% rare) at the default robust settings: the HLM null of
   every trait (L-BFGS-B on the host, the objective on the card), HC3
   robust chunks for the common SNPs and HLM chunks for those of MAC
   below --rare-mac 1000, on the card in float64 (models/interaction.py;
   no hand-written kernel launches: the counts set to 0 just before the
   run and read just after); the 50 files well formed, both routes run;
   printed: the wall, variants/s and a stage table. Then through the
   run's engine: the robust chunk timed against its FP64 or byte bound,
   4 of its SNPs and an HLM chunk on 3 traits card against CPU on the
   card's inputs within the bars, and the HLM null of 2 traits again on
   the CPU (numpy): both converged, objectives within rel 1e-8. BT
   interaction timing: one fixed-shape chunk of the BT refits (two
   masked IRLS passes) at N = 400,000 for 50 synthetic traits, timed; two
   refits against the CPU.
6. cross-check: small runs (N=2,000) through the port on the card (by
   default and with REGENIE_TPU_I8=0) and on the CPU, each with
   --remove: a BED --htp run, a two-chromosome BGEN --minINFO run (their
   REGENIE_TPU_I8=0 runs launch fused_f32 / bgen_f32 once per block and
   no other kernel: the float32 kernels' counts in the kernels line), a
   chrX BED --htp run and a chrX BGEN run (PAR1, non-PAR and PAR2
   positions), a zstd BGEN run and a chrX PGEN run with --no-split --gz;
   and on the dense route, once on the card and once on the CPU: a
   16-bit phased uncompressed BGEN with --htp and --condition-file bgen,
   a layout-1 BGEN with --no-split --test dominant, a PGEN with dosage
   tracks with --nocov-approx on one trait (these three launch no
   kernel), and the chrX BED with --skip-dosage-comp, and with --test
   recessive --minHOMs 1, --condition-list and --tpheno-file (the
   non-PAR blocks dense); binary traits: a BGEN --firth --approx --af-cc
   run and a chrX PGEN --spa --htp run (fused, by default and with
   REGENIE_TPU_I8=0), a PGEN-dosages --firth --approx run (dense, no
   kernel) and a chrX BED --firth --approx --af-cc run (non-PAR blocks
   dense); time-to-event traits (2 endpoints): BED --t2e --firth --approx
   --htp --htp-with-event, chrX BED --firth --approx (PAR1, non-PAR and
   PAR2 on the fused route with the male tail) and PGEN --firth --approx
   --coxnofirth (fused, by default and with REGENIE_TPU_I8=0: each run
   launches fused_i8, or fused_f32, once per block and no other kernel,
   routes no block dense, and on chrX the log counts every non-PAR block
   fused with the male tail), BGEN --firth --approx and BED
   --coxscore-exact (dense, no kernel); every
   output field meets the same bar (a binary trait's and a Cox Firth
   run's HTP ratios on the log scale), and a BED --bt --firth --approx
   --write-null-firth run (its .firth files within one unit of the sixth
   significant digit). The BED --htp (REGENIE_TPU_I8=0), BGEN --minINFO
   (by default and with REGENIE_TPU_I8=0), BT BED --firth --approx, CT
   BED --af-cc and T2E BED --htp runs again on the mesh of two shards of
   the card (mesh_cross_check): their kernel (fused_f32, bgen_i8,
   bgen_f32, fused_i8) once a shard of every block, every
   field within its bar of the unsharded card run, the rows not
   byte-identical counted; and Step 1 K-fold and --loocv on the BED with
   the sample-sharded level 0 against the unsharded card runs, every
   .loco value within one unit of its sixth digit. The BT BED, T2E BED
   and BGEN --minINFO mesh runs, and the BED --htp and BGEN --minINFO
   REGENIE_TPU_I8=0 ones, again as two processes of one shard each
   (multiprocess_cross_check; the kernel once a block in each process,
   the BT launch's processes building fused_i8 at once into one empty
   directory), Step 1 K-fold and --loocv (the per-host sample window),
   a gene-based --set-list, a GxE --interaction and a --mt run (the
   launches two at a time), each against one process on two shards of
   the card: every field within
   its bar, .loco values within one unit of the sixth digit, process 1
   printing nothing and writing no file of its own. Then
   the two-step workflow on the BED dataset (K-fold and --loocv), on the
   PGEN (K-fold) and on the BGEN (K-fold, Step 2 with --force-ltco 2),
   on the card and on the CPU: Step 1, and Step 2 with --pred on that
   run's own _pred.list; every .loco value within one unit of its sixth
   significant digit, every Step-2 field within its bar. Binary and count
   traits the same way: Step 1 --bt --write-null-firth (LOOCV, forced
   below 5,000 samples) then exact Firth with --use-null-firth on the
   BED; Step 1 --bt K-fold at N = 6,000 on a BED of its own; --ct on the
   BED and on the BGEN, whose Step 2 on the card must launch fused_i8 /
   bgen_i8 once per block and no other kernel; and Step 1 --t2e on the
   BED (K-fold, with --t2e-l1-pi6 and with --t2e-event-l0), each then
   Step 2 --t2e with its predictions (fused_i8 once per block). Last,
   the gene-based runs (gene_cross_check): QT with the six VC tests and
   five joint tests, QT --rgc-gene-p, BT --firth --approx --htp, BT --spa
   --write-mask, CT and T2E burden masks, on the card and on the CPU,
   every row within the bar but the tails' rows of sets whose tails
   tail_verdict witnessed, which a CPU replay on the card's tail inputs
   must reproduce; and bucket 1 against 32 on the card, byte for byte.
   Interaction tests (interaction_cross_check), card against the CPU's
   per-SNP routes (REGENIE_TPU_NO_BATCH_INT=1): QT --interaction C1 (HC3
   and the HLM), a categorical E3 with --no-condtl --print-vcov (the .vcov
   files too), --force-hc4, --no-robust, GxG --interaction-snp from the
   BED and from --interaction-file bgen, GxPRS --interaction-prs on the
   two-step workflow's own _pred.list, BT --interaction with --firth
   --approx and with --spa; no kernel launches. The Step-1 options
   (step1_options_cross_check): --prior-alpha, --test-l0, --select-l0
   FILE (LOOCV), --print (K-fold and --loocv) and BT --debug, .loco and
   --print values within one unit of the sixth significant digit, the
   --debug inputs the same bytes. The modes of the whole-run entry points
   (modes_cross_check), card against CPU: --mcc --mcc-skew on a table of
   skewed traits, --mt --strict --no-split, --multiphen --strict in the
   default mode and with --multiphen-test cov_score (chromosome 2),
   --compute-corr with --output-corr-text, with --skip-scaleG --sparse-thr
   0.2, and with
   --ld-extract (variant rows, mask rows built from the gene-based run's
   files, names the data lacks; binary output), every field within its
   bar, the LD matrices within 1e-10 before quantization and the binary
   codes as in the LD slice; these launch no kernel. --af-cc on QT (the
   fused route: fused_i8 once per block and no other kernel, by default
   and with REGENIE_TPU_I8=0 fused_f32) and on CT (fused_i8 once per
   block).

After each phase a line gives the seconds since the start. The last
lines of standard output are a JSON line with every kernel's numbers,
the card's name and power limit (nvidia-smi), and
{"ok": true, "device": {...}}. Without a CUDA device it exits non-zero
before any phase.
"""

from __future__ import annotations

import contextlib
import glob
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

# dense rates of one H100 SXM (NVIDIA data sheet, 700 W)
PEAK_INT8_OPS = 1979e12
PEAK_BF16_OPS = 989e12
PEAK_FP64_TC_OPS = 67e12  # FP64 tensor cores
PEAK_BYTES = 3.35e12

# the repository's UKB shape (bench.py, BENCH_NOTES.md)
FULL = dict(N=400_000, P=50, n_inc=10, K=20, B=2048)
SLICE_BLOCKS = 2  # variant blocks of each full-width slice run
# the binary-trait operand at that shape: [cat P*(K+1) | gsm^2 P | maskf P |
# case P | ind] = 1,201 columns -> Cp = 1,280; BGEN's narrow Wq from gsm^2
# on, 151 columns -> 256
BT_CP, BT_CQP = 1280, 256
# Step 1 at full width: 4 level-0 blocks of 1000 on two chromosomes (a real
# Step 1 has ~500); level 1 timed alone at the real depth F = 500 x J
STEP1 = dict(chroms=((1, 2000), (2, 2000)), B=1000, effect_sd=0.1, real_F=2500)
LOCO_BYTES_PER_VALUE = 13  # " " and a %g prediction of 6 significant digits
LOG10P_TOL, BETA_TOL = 1e-5, 1e-6
F64_SUM_BAR = 1e-12  # float64 kernel sums: share of the product against |W|


def run_cli(argv):
    """The port's CLI in this process, its console lines kept out of the
    smoke's output (the CLI writes them to <out>.log as well)."""
    import io

    from regenie_tpu_torch import cli

    with contextlib.redirect_stdout(io.StringIO()):
        cli.main(argv)


def run_cli_kept(argv):
    """run_cli, keeping what the step's entry point (run_step1 or
    run_step2) was given and returned, so that a slice's checks reuse the
    run's setup or engine (its genotype source open) without a second
    run-up. Returns (its params, its return value, the lines of
    <out>.log)."""
    from regenie_tpu_torch import run_step1 as rs1
    from regenie_tpu_torch import run_step2 as rs2

    kept = []
    fns = [(m, m.__dict__[n]) for m, n in ((rs1, "run_step1"), (rs2, "run_step2"))]

    def keeping(fn):
        def run(params, *a, **kw):
            kept.append((params, fn(params, *a, **kw)))
            return kept[-1][1]
        return run

    for m, fn in fns:
        setattr(m, fn.__name__, keeping(fn))
    try:
        run_cli(argv)
    finally:
        for m, fn in fns:
            setattr(m, fn.__name__, fn)
    params, ret = kept[0]
    if hasattr(ret, "log"):
        ret.log = print  # the CLI's log file is closed now
    with open(argv[argv.index("--out") + 1] + ".log") as fh:
        return params, ret, fh.read().splitlines()


def card_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return r.stdout.strip().splitlines()[0]


# chrX pseudo-autosomal bounds of build 37 (the CLI's default --par-region)
PAR1_MAX, PAR2_MIN = 2_781_479, 155_701_383


def chrx_positions(n, n_par1, n_par2=0):
    """Positions of n chrX variants: the first n_par1 in PAR1, the last
    n_par2 in PAR2, the rest spread over the non-PAR region."""
    k = n - n_par1 - n_par2
    return np.concatenate([
        60_001 + 1000 * np.arange(n_par1),
        PAR1_MAX + 1 + (np.arange(k) * ((PAR2_MIN - PAR1_MAX - 2) // max(k, 1))),
        PAR2_MIN + 1000 * np.arange(n_par2)]).astype(np.int64)


def _in_row_slices(fn, n):
    """fn(lo, hi) for row slices [lo, hi) covering n rows, one per CPU, in
    threads (numpy releases the interpreter lock in the writers'
    elementwise passes; each slice writes its own rows, so the values do
    not depend on the threads)."""
    from concurrent.futures import ThreadPoolExecutor

    k = min(os.cpu_count() or 1, n)
    if k <= 1:
        fn(0, n)
        return
    bounds = np.linspace(0, n, k + 1).astype(int)
    with ThreadPoolExecutor(k) as pool:
        list(pool.map(fn, bounds[:-1], bounds[1:]))


def _by_rows(fn, x):
    """fn(x) with fn taking and giving arrays row for row, computed in row
    slices (_in_row_slices)."""
    first = fn(x[:1])
    out = np.empty((len(x),) + first.shape[1:], first.dtype)

    def part(lo, hi):
        out[lo:hi] = fn(x[lo:hi])

    _in_row_slices(part, len(x))
    return out


def _pack2_rows(codes, nb):
    """[c, N] 2-bit codes -> [c, nb] bytes, 4 samples a byte, low bits
    first (the BED layout)."""
    c = np.pad(codes, ((0, 0), (0, 4 * nb - codes.shape[1]))).reshape(-1, nb, 4)
    return (c[..., 0] | (c[..., 1] << 2) | (c[..., 2] << 4)
            | (c[..., 3] << 6)).astype(np.uint8)


def _pack2(codes):
    """1-D 2-bit codes, 4 to a byte, low bits first."""
    return _pack2_rows(codes[None, :], -(-len(codes) // 4))[0]


def _hardcall_blocks(rng, N, chroms, P, n_cov, miss, effect_sd, chunk,
                     af_given=None):
    """The hardcall generator of write_dataset and write_pgen_dataset:
    (beta, X, Y, chunks), where chunks yields (first variant index, [c,
    N] BED 2-bit codes) `chunk` variants at a time; the caller adds each
    chunk's causal effects to Y (_add_effects). The draws are sequential;
    the codes are made from them in row slices (_in_row_slices).
    af_given ([M] allele frequencies, e.g. gene_afs) replaces the
    frequencies drawn, and every other draw stays as without it."""
    M = sum(n for _, n in chroms)
    af = rng.uniform(0.01, 0.5, size=M)
    af[::17] = max(0.004, 5.0 / N)
    if af_given is not None:
        af = np.asarray(af_given, np.float64)
    beta = rng.normal(size=(M, P)) * effect_sd * (rng.random((M, P)) < 0.02)
    X = rng.normal(size=(N, n_cov))
    Y = X @ rng.normal(size=(n_cov, P)) + rng.normal(size=(N, P))
    lut = np.array([1, 0, 2, 3], np.uint8)  # missing, hom-alt, het, hom-ref

    def chunks():
        for s in range(0, M, chunk):
            a = af[s : s + chunk, None]
            t1 = miss
            t2 = (t1 + (1 - miss) * a * a).astype(np.float32)
            t3 = (t1 + (1 - miss) * a * a + (1 - miss) * 2 * a * (1 - a)).astype(np.float32)
            u = rng.random((len(a), N), dtype=np.float32)
            codes = np.empty(u.shape, np.uint8)

            def part(lo, hi):
                v = u[lo:hi]
                codes[lo:hi] = lut[(v >= t1).astype(np.uint8) + (v >= t2[lo:hi])
                                   + (v >= t3[lo:hi])]

            _in_row_slices(part, len(a))
            yield s, codes

    return beta, X, Y, chunks()


def _add_effects(Y, beta, s, codes):
    """Y += the per-allele effects of the causal variants among the BED
    codes of variants s, s + 1, ..."""
    causal = np.nonzero(beta[s : s + len(codes)].any(axis=1))[0]
    if len(causal):
        g = (2.0 * (codes[causal] == 0) + (codes[causal] == 2))
        Y += g.T @ beta[s + causal]


def _positions(chroms, positions, default):
    """[(chrom, positions)] of each chromosome: positions[chrom] where
    given, else default(chrom index, n)."""
    return [(c, np.asarray(positions[c]) if positions and c in positions
             else default(i, n)) for i, (c, n) in enumerate(chroms)]


def write_dataset(d, seed, N, chroms, P, n_inc, n_cov, miss=0.02,
                  na_rate=0.05, n_remove=0, effect_sd=0.0, chunk=128,
                  positions=None, af=None):
    """Synthetic PLINK BED/bim/fam (prefix d/geno), phenotypes
    (d/pheno.txt: Y1..YP, the first n_inc with na_rate NA), covariates
    (d/covar.txt: n_cov columns) and d/remove.txt (n_remove samples).

    Genotypes follow Hardy-Weinberg at allele frequencies uniform in
    [0.01, 0.5] (every 17th variant rare, at 0.004 or at 10 expected
    minor alleles in small cohorts, for the MAC filters), with
    missing codes at rate `miss`; they are drawn `chunk` variants at a
    time, so memory stays small at biobank N. Phenotypes are covariate
    effects plus noise and, when effect_sd > 0, per-allele effects of sd
    effect_sd on 2% of the variants. Samples of even index are male in
    the .fam. Variants sit at 1000 + 10 j on each chromosome, or at
    positions[chrom] where given (a chromosome named "X" is chrX; see
    chrx_positions). af: the variants' allele frequencies instead
    (gene_afs). Returns the BED prefix."""
    rng = np.random.default_rng(seed)
    beta, X, Y, chunks = _hardcall_blocks(rng, N, chroms, P, n_cov, miss,
                                          effect_sd, chunk, af)
    nb = (N + 3) // 4
    prefix = os.path.join(d, "geno")
    with open(prefix + ".bed", "wb") as fh:
        fh.write(b"\x6c\x1b\x01")
        for s, codes in chunks:
            _add_effects(Y, beta, s, codes)
            fh.write(_by_rows(lambda c: _pack2_rows(c, nb), codes).tobytes())
    with open(prefix + ".bim", "w") as fh:
        v = 0
        for chrom, pos in _positions(chroms, positions,
                                     lambda i, n: 1000 + 10 * np.arange(n)):
            fh.write("".join(f"{chrom} v{v + j} 0 {p} A C\n"
                             for j, p in enumerate(pos)))
            v += len(pos)
    with open(prefix + ".fam", "w") as fh:
        fh.write("".join(f"F{i} I{i} 0 0 {1 + i % 2} -9\n" for i in range(N)))
    _write_tables(d, rng, Y, X, n_inc, na_rate, n_remove)
    return prefix


def _vints(v):
    """LEB128 bytes (the PGEN format's vint) of each non-negative value of
    v, concatenated, and the byte count of each."""
    v = np.asarray(v, np.uint64)
    nby = np.ones(len(v), np.int64)
    for k in range(1, 5):
        nby += v >= np.uint64(1 << (7 * k))
    out = np.zeros(int(nby.sum()), np.uint8)
    start = np.concatenate([[0], np.cumsum(nby)[:-1]])
    for k in range(5):
        m = nby > k
        byte = (v[m] >> np.uint64(7 * k)) & np.uint64(0x7F)
        out[start[m] + k] = byte.astype(np.uint8) | np.where(nby[m] > k + 1, 0x80, 0)
    return out, nby


def _difflist(ids, codes, N):
    """A PGEN difflist of sorted sample ids with their new 2-bit codes:
    [vint L][first id of each group of 64][each group's delta bytes - 63,
    but the last's][raregeno][vint deltas]."""
    L = len(ids)
    head, _ = _vints([L])
    if L == 0:
        return head.tobytes()
    sid_bytes = (int(N).bit_length() + 7) // 8
    first = ids[::64].astype(np.int64)
    fb = ((first[:, None] >> (8 * np.arange(sid_bytes))) & 0xFF).astype(np.uint8)
    d = np.diff(ids)
    keep = np.ones(len(d), bool)
    keep[63::64] = False  # a group's first id is not a delta
    deltas, nby = _vints(d[keep])
    group_ct = len(first)
    sizes = np.bincount(np.arange(len(nby)) // 63, weights=nby,
                        minlength=group_ct).astype(np.int64)[: group_ct - 1] - 63
    return b"".join([head.tobytes(), fb.tobytes(), sizes.astype(np.uint8).tobytes(),
                     _pack2(codes).tobytes(), deltas.tobytes()])


def write_pgen_dataset(d, seed, N, chroms, P, n_inc, n_cov, miss=0.02,
                       na_rate=0.05, n_remove=0, effect_sd=0.0, chunk=128,
                       positions=None, ld_every=4, ld_diff=0.005, dosage=0.0,
                       bed_prefix=None, af=None):
    """Synthetic PLINK2 .pgen/.pvar/.psam (prefix d/geno; storage mode
    0x10, 4-bit vrtypes, 3-byte record lengths) with the genotypes of
    write_dataset's generator, and its phenotype, covariate and remove
    files. Every ld_every-th variant (from the second) is an
    LD-compressed record: the last non-LD variant's genotypes with a
    share ld_diff of samples redrawn, stored as a difflist against it
    (vrtype 2; every other one inverted, hom-ref and hom-alt swapped:
    vrtype 3); the others are 2-bit direct records (vrtype 0). With
    dosage > 0, that share of the variants also carries a dense 16-bit
    dosage track (vrtype bit 0x40; 8-bit vrtypes): the hardcall x 16384,
    moved by up to 4095 toward 1 on a tenth of the samples, 65535 where
    missing. The .psam has a SEX column (samples of even index male), the
    .pvar REF A and ALT C. With bed_prefix, the same hardcalls are also
    written as a PLINK BED there (.bed/.bim/.fam, write_dataset's allele
    coding; the dosage tracks left out). af as in write_dataset.
    Returns the prefix."""
    rng = np.random.default_rng(seed)
    M = sum(n for _, n in chroms)
    beta, X, Y, chunks = _hardcall_blocks(rng, N, chroms, P, n_cov, miss,
                                          effect_sd, chunk, af)
    has_dos = rng.random(M) < dosage if dosage > 0 else np.zeros(M, bool)
    to_pgen = np.array([2, 3, 1, 0], np.uint8)  # BED code -> ALT count code
    to_bed = np.array([3, 2, 0, 1], np.uint8)
    swap = np.array([2, 1, 0, 3], np.uint8)
    vblocks = (M + 65535) // 65536
    wide = bool(has_dos.any())  # 8-bit vrtypes, to hold bit 0x40
    index = 8 * vblocks + sum((min(65536, M - 65536 * b) + (0 if wide else 1))
                              // (1 if wide else 2) for b in range(vblocks)) + 3 * M
    vrtypes = np.zeros(M, np.uint8)
    lens = np.zeros(M, np.int64)
    prefix = os.path.join(d, "geno")
    bed = contextlib.nullcontext(None) if bed_prefix is None else open(
        bed_prefix + ".bed", "wb")
    with open(prefix + ".pgen", "wb") as fh, bed as bfh:
        if bfh is not None:
            bfh.write(b"\x6c\x1b\x01")
        fh.write(b"\x6c\x1b\x10" + np.array([M, N], "<u4").tobytes()
                 + (b"\x06" if wide else b"\x02"))
        fh.write(bytes(index))
        base = None
        nb = (N + 3) // 4
        for s, codes in chunks:
            pg = to_pgen[codes]
            ld = {}  # row of the chunk -> its difflist record
            for j in range(len(pg)):
                v = s + j
                if base is not None and v % ld_every == 1:
                    inv = (v // ld_every) % 2 == 1
                    ids = np.sort(rng.choice(N, size=max(1, int(ld_diff * N)),
                                             replace=False))
                    new = rng.integers(0, 4, len(ids)).astype(np.uint8)
                    pg[j] = swap[base] if inv else base
                    pg[j, ids] = new
                    ld[j] = _difflist(ids, new, N)
                    vrtypes[v] = 3 if inv else 2
                else:
                    base = pg[j].copy()
            packed = _by_rows(lambda c: _pack2_rows(c, nb), pg)
            for j in range(len(pg)):
                rec = ld[j] if j in ld else packed[j].tobytes()
                if has_dos[s + j]:
                    vrtypes[s + j] |= 0x40
                    dv = pg[j].astype(np.int64) * 16384
                    moved = rng.random(N) < 0.1
                    step = rng.integers(0, 4096, N)
                    dv = np.where(moved, dv + np.where(pg[j] == 0, step,
                                                       np.where(pg[j] == 2, -step, 0)), dv)
                    dv[pg[j] == 3] = 65535
                    rec += dv.astype("<u2").tobytes()
                lens[s + j] = len(rec)
                fh.write(rec)
            _add_effects(Y, beta, s, to_bed[pg])
            if bfh is not None:
                bfh.write(_by_rows(lambda c: _pack2_rows(to_bed[c], nb), pg).tobytes())
        fh.seek(12)
        start = 12 + index
        for b in range(vblocks):
            fh.write(np.array([start + lens[: 65536 * b].sum()], "<u8").tobytes())
        for b in range(vblocks):
            lo, hi = 65536 * b, min(M, 65536 * (b + 1))
            vt = np.zeros(2 * ((hi - lo + 1) // 2), np.uint8)
            vt[: hi - lo] = vrtypes[lo:hi]
            fh.write(vt[: hi - lo].tobytes() if wide
                     else (vt[0::2] | (vt[1::2] << 4)).tobytes())
            fh.write(((lens[lo:hi, None] >> (8 * np.arange(3))) & 0xFF)
                     .astype(np.uint8).tobytes())
    with open(prefix + ".pvar", "w") as fh:
        fh.write("#CHROM\tPOS\tID\tREF\tALT\n")
        v = 0
        for chrom, pos in _positions(chroms, positions,
                                     lambda i, n: 1000 + 10 * np.arange(n)):
            fh.write("".join(f"{chrom}\t{p}\tv{v + j}\tA\tC\n"
                             for j, p in enumerate(pos)))
            v += len(pos)
    with open(prefix + ".psam", "w") as fh:
        fh.write("#FID\tIID\tSEX\n")
        fh.write("".join(f"F{i}\tI{i}\t{1 + i % 2}\n" for i in range(N)))
    if bed_prefix is not None:
        with open(bed_prefix + ".bim", "w") as fh:
            v = 0
            for chrom, pos in _positions(chroms, positions,
                                         lambda i, n: 1000 + 10 * np.arange(n)):
                fh.write("".join(f"{chrom} v{v + j} 0 {p} A C\n"
                                 for j, p in enumerate(pos)))
                v += len(pos)
        with open(bed_prefix + ".fam", "w") as fh:
            fh.write("".join(f"F{i} I{i} 0 0 {1 + i % 2} -9\n" for i in range(N)))
    _write_tables(d, rng, Y, X, n_inc, na_rate, n_remove)
    return prefix


def _table_rows(first, V):
    """The rows "F{i} I{i} v ..." of samples first, first + 1, ... with
    values V [n, k] printed %.6f (nan as NA)."""
    row = " ".join(["%.6f"] * V.shape[1])
    return "".join(f"F{first + i} I{first + i} " + (row % tuple(v)).replace("nan", "NA")
                   + "\n" for i, v in enumerate(V))


# from this many samples on, the tables are printed by a pool of processes
TABLE_POOL_N = 50_000


def _print_tables(tables):
    """Write each (path, column names, values [N, k]) table for samples
    F{i} I{i}. At biobank N the rows are printed in slices by one process
    per CPU (the same bytes: the slices are joined in order)."""
    N = tables[0][2].shape[0]
    if N < TABLE_POOL_N:
        texts = [_table_rows(0, V) for _, _, V in tables]
    else:
        import multiprocessing

        cuts = np.linspace(0, N, 8 * (os.cpu_count() or 1) + 1).astype(int)
        with multiprocessing.get_context("spawn").Pool(os.cpu_count()) as pool:
            texts = ["".join(pool.starmap_async(_table_rows, [
                (int(a), V[a:b]) for a, b in zip(cuts[:-1], cuts[1:])]).get(600))
                for _, _, V in tables]
    for (path, names, _), text in zip(tables, texts):
        with open(path, "w") as fh:
            fh.write("FID IID " + " ".join(names) + "\n")
            fh.write(text)


def _write_tables(d, rng, Y, X, n_inc, na_rate, n_remove):
    """d/pheno.txt (the first n_inc traits with na_rate NA), d/covar.txt
    and d/remove.txt (n_remove samples) for samples F{i} I{i}."""
    N, P = Y.shape
    for p in range(n_inc):
        Y[rng.random(N) < na_rate, p] = np.nan
    _print_tables(((os.path.join(d, "pheno.txt"), [f"Y{p + 1}" for p in range(P)], Y),
                   (os.path.join(d, "covar.txt"),
                    [f"C{k + 1}" for k in range(X.shape[1])], X)))
    with open(os.path.join(d, "remove.txt"), "w") as fh:
        for i in rng.choice(N, size=n_remove, replace=False):
            fh.write(f"F{i} I{i}\n")


def dataset_traits(seed, N, chroms, P, n_cov):
    """The quantitative traits Y [N, P] and covariates X [N, n_cov] that
    write_dataset(seed=seed, N=N, chroms=chroms, P=P, n_cov=n_cov) writes
    with effect_sd=0, before its NA: the same generator draws, without
    the genotypes."""
    rng = np.random.default_rng(seed)
    _, X, Y, _ = _hardcall_blocks(rng, N, chroms, P, n_cov, 0.02, 0.0, 128)
    return Y, X


def write_bt_table(path, Y, seed, prev=(0.05, 0.3), n_inc=0, na_rate=0.05,
                   cases=None, X=None, cov_share=0.1):
    """A binary-trait table at `path` (Y1..YP for samples F{i} I{i}):
    each trait of the quantitative traits Y [N, P] thresholded at its
    upper quantile, the prevalences evenly spaced over `prev`; then the
    samples marked in `cases` ([N, P] bool, e.g. carriers of a rare
    variant) made cases, and the first n_inc traits given na_rate NA.
    Given the covariates X [N, k], each trait's covariate fit is first
    rescaled to explain `cov_share` of its variance (the writers'
    covariates explain most of Y, which would nearly separate cases from
    controls). Returns the [N, P] 0/1/NaN values written."""
    rng = np.random.default_rng(seed)
    N, P = Y.shape
    if X is not None:
        X1 = np.column_stack([np.ones(N), X])
        fit = X1 @ np.linalg.lstsq(X1, Y, rcond=None)[0]
        res = Y - fit
        fit -= fit.mean(axis=0)
        a = np.sqrt(cov_share / (1 - cov_share) * res.var(axis=0) / fit.var(axis=0))
        Y = res + a[None, :] * fit
    q = 1.0 - np.linspace(prev[0], prev[1], P)
    thr = np.array([np.quantile(Y[:, p], q[p]) for p in range(P)])
    Yb = (Y > thr[None, :]).astype(np.float64)
    if cases is not None:
        Yb[cases] = 1.0
    for p in range(n_inc):
        Yb[rng.random(N) < na_rate, p] = np.nan
    _print_tables(((path, [f"Y{p + 1}" for p in range(P)], Yb),))
    return Yb


def write_t2e_table(path, Y, seed, n_na=0, na_rate=0.05, rates=(0.05, 0.3),
                    X=None, cov_share=0.1):
    """A time-to-event table at `path` (T1..TP, then E1..EP, for samples
    F{i} I{i}) from the quantitative traits Y [N, P]: each trait, its
    covariate fit rescaled to `cov_share` of its variance as in
    write_bt_table (given X), standardized and halved, is the log-hazard
    of an exponential event time; a uniform censoring time, its scale
    solved per trait so that the event rates run evenly over `rates`,
    cuts it; times are rounded to 0.01, so event times tie. The first
    n_na endpoints get na_rate NA times. Returns (times, events), each
    [N, P] (NaN where NA)."""
    rng = np.random.default_rng(seed)
    N, P = Y.shape
    if X is not None:
        X1 = np.column_stack([np.ones(N), X])
        fit = X1 @ np.linalg.lstsq(X1, Y, rcond=None)[0]
        res = Y - fit
        fit -= fit.mean(axis=0)
        a = np.sqrt(cov_share / (1 - cov_share) * res.var(axis=0) / fit.var(axis=0))
        Y = res + a[None, :] * fit
    hazard = 0.1 * np.exp(0.5 * (Y - Y.mean(axis=0)) / Y.std(axis=0))
    T = rng.exponential(1.0, size=(N, P)) / hazard
    U = rng.random((N, P))
    times = np.empty((N, P))
    events = np.empty((N, P))
    for p, target in enumerate(np.linspace(rates[0], rates[1], P)):
        lo, hi = 1e-3, 1e6  # the censoring scale: event rate rises with it
        for _ in range(100):
            mid = np.sqrt(lo * hi)
            lo, hi = (mid, hi) if (T[:, p] <= mid * U[:, p]).mean() < target else (lo, mid)
        C = hi * U[:, p]
        events[:, p] = T[:, p] <= C
        times[:, p] = np.round(np.minimum(T[:, p], C), 2)
    for p in range(n_na):
        times[rng.random(N) < na_rate, p] = np.nan
    _print_tables(((path, [f"T{p + 1}" for p in range(P)]
                    + [f"E{p + 1}" for p in range(P)],
                    np.concatenate([times, events], axis=1)),))
    return times, events


def t2e_flags(P):
    """--t2e with the column lists of write_t2e_table's P endpoints."""
    return ["--t2e", "--phenoColList", ",".join(f"T{p + 1}" for p in range(P)),
            "--eventColList", ",".join(f"E{p + 1}" for p in range(P))]


def write_ct_table(path, Y, seed):
    """A count-trait table at `path` (Y1..YP for samples F{i} I{i}):
    Poisson counts whose log-rate is 0.3 x each trait of the quantitative
    traits Y [N, P] standardized; a NaN of Y stays NA."""
    rng = np.random.default_rng(seed)
    Z = np.nan_to_num((Y - np.nanmean(Y, 0)) / np.nanstd(Y, 0))
    C = rng.poisson(np.exp(0.3 * Z)).astype(np.float64)
    _print_tables(((path, [f"Y{p + 1}" for p in range(Y.shape[1])],
                    np.where(np.isnan(Y), np.nan, C)),))


def _bgen_probs(k, g, j, gmiss, N, bits, layout, phased):
    """The genotype block bodies [c, ...] uint8 of write_bgen_dataset's
    other encodings, from its 8-bit pairs k [c, N, 2] (first-allele
    counts g, uncertainty j): layout 2 at `bits` bits (each 8-bit value
    v stored as floor(v (2^bits - 1) / 255), so pairs never exceed the
    maximum), phased as one probability a haplotype (that it carries the
    first allele: 255 - j on the haplotypes that carry it, else j), or
    layout 1 (three uint16 probabilities / 32768, all zero at missing
    samples). Returns (bodies, first-allele dosages [c, N])."""
    c = len(k)
    if layout == 1:
        p = np.zeros((c, N, 3), "<u2")
        p[..., 0] = k[..., 0].astype(np.uint16) * 128
        p[..., 1] = k[..., 1].astype(np.uint16) * 128
        p[..., 2] = 32768 - p[..., 0] - p[..., 1]
        p[gmiss] = 0
        dose = (2.0 * p[..., 0] + p[..., 1]) / 32768.0
        return p.reshape(c, 3 * N).view(np.uint8), dose
    top = (1 << bits) - 1
    if phased:
        pair = np.stack([np.where(g >= 1, 255 - j, j),
                         np.where(g == 2, 255 - j, j)], axis=-1)
    else:
        pair = k
    vals = pair.astype(np.int64) * top // 255
    dose = ((vals[..., 0] + vals[..., 1]) if phased
            else (2 * vals[..., 0] + vals[..., 1])) / top
    bitv = (vals.reshape(c, 2 * N)[..., None] >> np.arange(bits)) & 1
    packed = np.packbits(bitv.reshape(c, -1).astype(np.uint8), axis=1,
                         bitorder="little")
    head = np.empty((c, 10 + N), np.uint8)
    head[:, :8] = np.frombuffer(np.array([N], "<u4").tobytes()
                                + np.array([2], "<u2").tobytes() + b"\x02\x02",
                                np.uint8)
    head[:, 8 : 8 + N] = np.where(gmiss, np.uint8(0x82), np.uint8(2))
    head[:, 8 + N] = int(phased)
    head[:, 9 + N] = bits
    return np.concatenate([head, packed], axis=1), dose


def write_bgen_dataset(d, seed, N, chroms, P, n_inc, n_cov, miss=0.01,
                       uncertain=0.1, na_rate=0.05, n_remove=0, effect_sd=0.0,
                       chunk=32, workers=8, positions=None, compress=None,
                       compression=1, bits=8, layout=2, phased=False, af=None):
    """Synthetic BGEN v1.2 (layout 2, zlib, 8-bit, unphased diploid, with
    sample IDs) at d/geno.bgen, its Oxford sample file d/geno.sample (with
    a sex column), and the phenotype, covariate and remove files of
    write_dataset, for samples F{i} I{i}.

    Probabilities are imputed-like: genotypes follow Hardy-Weinberg at
    allele frequencies uniform in [0.01, 0.5] (every 17th variant rare);
    on a share `uncertain` of each variant's samples up to half of the
    called genotype's probability moves to the neighbouring genotype, the
    others carry a hard call; a share `miss` is missing (ploidy byte
    0x82). k0 + k1 <= 255 always. Variants are drawn `chunk` at a time and
    compressed in a pool of `workers` threads, so memory stays small at
    biobank N. Variant v sits at 1000 + 10 v, or on a chromosome named
    in `positions` at positions[chrom]. `compress` (bytes -> bytes, zlib
    level 1 by default) with its header flag `compression` (2 for zstd)
    writes another compression; compression=0 stores the records
    uncompressed. bits, phased and layout=1 write the same draws in those
    encodings (_bgen_probs). af as in write_dataset. Returns the .bgen
    path."""
    import struct
    import zlib
    from concurrent.futures import ThreadPoolExecutor

    rng = np.random.default_rng(seed)
    M = sum(n for _, n in chroms)
    chrom_of = np.concatenate([np.full(n, c) for c, n in chroms])
    start = np.cumsum([0] + [n for _, n in chroms])
    pos_of = np.concatenate([p for _, p in _positions(
        chroms, positions, lambda i, n: 1000 + 10 * (start[i] + np.arange(n)))])
    if compress is None:
        compress = lambda b: zlib.compress(b, 1)  # noqa: E731
    af_given, af = af, rng.uniform(0.01, 0.5, size=M)
    af[::17] = max(0.004, 5.0 / N)
    if af_given is not None:
        af = np.asarray(af_given, np.float64)
    beta = rng.normal(size=(M, P)) * effect_sd * (rng.random((M, P)) < 0.02)
    X = rng.normal(size=(N, n_cov))
    Y = X @ rng.normal(size=(n_cov, P)) + rng.normal(size=(N, P))
    ids = [f"I{i}" for i in range(N)]
    lsi = 8 + sum(2 + len(s) for s in ids)
    path = os.path.join(d, "geno.bgen")
    head = np.frombuffer(struct.pack("<IHBB", N, 2, 2, 2), np.uint8)
    with open(path, "wb") as fh, ThreadPoolExecutor(workers) as pool:
        fh.write(struct.pack("<IIII", 20 + lsi, 20, M, N) + b"bgen")
        fh.write(struct.pack("<I", compression | (layout << 2) | (1 << 31)))
        fh.write(struct.pack("<II", lsi, N) + b"".join(
            struct.pack("<H", len(s)) + s.encode() for s in ids))

        def emit(s, width, comp):
            """Write the records of the chunk from variant s (bodies of
            `width` bytes; comp: each body, or the future of its
            compression)."""
            for i, z in enumerate(comp):
                z = z if isinstance(z, bytes) else z.result()
                v = s + i
                rsid = f"v{v}".encode()
                ch = str(chrom_of[v]).encode()
                if layout == 1:
                    rec = struct.pack("<I", N) + struct.pack("<H", len(rsid)) + rsid
                else:
                    rec = struct.pack("<H", len(rsid)) + rsid
                rec += (struct.pack("<H", len(rsid)) + rsid
                        + struct.pack("<H", len(ch)) + ch
                        + struct.pack("<I", int(pos_of[v]))
                        + (b"" if layout == 1 else struct.pack("<H", 2))
                        + struct.pack("<I", 1) + b"A" + struct.pack("<I", 1) + b"C")
                if compression == 0 and layout == 1:
                    rec += z  # 6N bytes, no size field
                elif compression == 0:
                    rec += struct.pack("<I", len(z)) + z
                elif layout == 1:
                    rec += struct.pack("<I", len(z)) + z
                else:
                    rec += struct.pack("<II", len(z) + 4, width) + z
                fh.write(rec)

        pending = None
        for s in range(0, M, chunk):
            a = af[s : s + chunk, None]
            c = len(a)
            u1 = rng.random((c, N), dtype=np.float32)
            # j/255 of the called genotype's probability moves to its
            # neighbour on uncertain samples
            u = rng.random((c, N), dtype=np.float32)
            ju = rng.integers(0, 128, (c, N), dtype=np.uint8)
            g = np.empty((c, N), np.uint8)  # first-allele count
            j = np.empty((c, N), np.uint8)
            gmiss = np.empty((c, N), bool)
            body = np.empty((c, 10 + 3 * N), np.uint8)
            k = body[:, 10 + N :].reshape(c, N, 2)  # k0, k1

            def part(lo, hi):
                v, aa = u1[lo:hi], a[lo:hi]
                g[lo:hi] = ((v < (aa * aa).astype(np.float32)).astype(np.uint8)
                            + (v < (1 - (1 - aa) ** 2).astype(np.float32)))
                gg, jj = g[lo:hi], np.where(u[lo:hi] < uncertain, ju[lo:hi],
                                            np.uint8(0))
                j[lo:hi] = jj
                gmiss[lo:hi] = u[lo:hi] > 1 - miss
                body[lo:hi, :8] = head
                body[lo:hi, 8 : 8 + N] = np.where(gmiss[lo:hi], np.uint8(0x82),
                                                  np.uint8(2))
                body[lo:hi, 8 + N] = 0
                body[lo:hi, 9 + N] = 8
                k[lo:hi, :, 0] = np.where(gg == 2, 255 - jj,
                                          np.where(gg == 1, jj >> 1, 0))
                k[lo:hi, :, 1] = np.where(gg == 2, jj, np.where(gg == 1, 255 - jj, jj))

            _in_row_slices(part, c)
            dose = None
            if bits != 8 or layout != 2 or phased:
                body, dose = _bgen_probs(k, g, j, gmiss, N, bits, layout, phased)
            causal = np.nonzero(beta[s : s + c].any(axis=1))[0]
            if len(causal):
                dc = (dose[causal] if dose is not None else
                      (2.0 * k[causal, :, 0] + k[causal, :, 1]) / 255.0)
                Y += np.where(gmiss[causal], 0.0, dc).T @ beta[s + causal]
            # the chunk's records compress in the pool while the next chunk
            # is drawn; the previous chunk's are written meanwhile
            if compression == 0:
                comp = [row.tobytes() for row in body]
            else:
                comp = [pool.submit(lambda row: compress(row.tobytes()), row)
                        for row in body]
            if pending is not None:
                emit(*pending)
            pending = (s, body.shape[1], comp)
        if pending is not None:
            emit(*pending)
    with open(os.path.join(d, "geno.sample"), "w") as fh:
        fh.write("ID_1 ID_2 missing sex\n0 0 0 D\n")
        fh.write("".join(f"F{i} I{i} 0 {1 + i % 2}\n" for i in range(N)))
    _write_tables(d, rng, Y, X, n_inc, na_rate, n_remove)
    return path


GENE_CATS = ("LoF", "missense", "synonymous")
# masks of the gene-based runs: M1 = LoF, M2 = LoF,missense, M3 = all
GENE_MASKS = (("M1", "LoF"), ("M2", "LoF,missense"), ("M3", "LoF,missense,synonymous"))


def gene_afs(M, N, seed):
    """Exome-like allele frequencies of M variants: half ultra-rare at
    0.5/N (singletons, doubletons and monomorphic variants: a mean minor
    allele count of 1), a fifth rare, log-uniform from 1.5/N to 0.01, and
    the rest uniform in [0.01, 0.5]."""
    rng = np.random.default_rng(seed)
    u = rng.random(M)
    af = rng.uniform(0.01, 0.5, size=M)
    rare = (u >= 0.5) & (u < 0.7)
    af[rare] = np.exp(rng.uniform(np.log(1.5 / N), np.log(0.01), size=int(rare.sum())))
    af[u < 0.5] = 0.5 / N
    return af


def write_gene_files(d, chroms, set_size, seed, positions=None, domains=False,
                     bgen=False):
    """The gene-based inputs of a dataset whose variants are v0, v1, ...
    on `chroms` ([(chrom, n)], the writers' argument): d/sets.txt, sets
    G{k} of `set_size` consecutive variants of a chromosome (SET CHROM
    POS IDS), d/anno.txt (each variant LoF, missense or synonymous at
    0.2/0.3/0.5; with domains, a 4th column, each set's variants in two
    domains D1 and D2), d/masks.txt (GENE_MASKS), d/aaf.txt (--aaf-file:
    every other variant, a frequency in [0, 0.05]) and d/set_ids.txt (the
    first half of the sets, for --extract-sets). positions as in the
    writers; bgen: positions numbered across chromosomes, as
    write_bgen_dataset places them. Returns the paths by name."""
    rng = np.random.default_rng(seed)
    sets, anno, v, k = [], [], 0, 0
    for chrom, n in chroms:
        pos = (np.asarray(positions[chrom]) if positions and chrom in positions
               else 1000 + 10 * ((v if bgen else 0) + np.arange(n)))
        for lo in range(0, n, set_size):
            ids = [f"v{v + j}" for j in range(lo, min(lo + set_size, n))]
            sets.append(f"G{k} {chrom} {int(pos[lo])} {','.join(ids)}\n")
            cats = rng.choice(len(GENE_CATS), size=len(ids), p=(0.2, 0.3, 0.5))
            for j, (vid, c) in enumerate(zip(ids, cats)):
                dom = f" D{1 + (2 * j >= len(ids))}" if domains else ""
                anno.append(f"{vid} G{k}{dom} {GENE_CATS[c]}\n")
            k += 1
        v += n
    paths = {name: os.path.join(d, f"{name}.txt")
             for name in ("sets", "anno", "masks", "aaf", "set_ids")}
    texts = {
        "sets": "".join(sets), "anno": "".join(anno),
        "masks": "".join(f"{m} {c}\n" for m, c in GENE_MASKS),
        "aaf": "".join(f"v{j} {a:.6f}\n" for j, a in
                       zip(range(0, v, 2), rng.uniform(0, 0.05, size=(v + 1) // 2))),
        "set_ids": "".join(f"G{j}\n" for j in range(k // 2)),
    }
    for name, text in texts.items():
        with open(paths[name], "w") as fh:
            fh.write(text)
    return paths


def _table_note(path, t0, **info):
    """Beside a trait table the background writer wrote: path.json with
    its summary and the seconds it took, for the phase that reads it."""
    with open(path + ".json", "w") as fh:
        json.dump(dict(info, seconds=time.time() - t0), fh)


def _read_note(path):
    with open(path + ".json") as fh:
        return json.load(fh)


def _bed_slice_data(d):
    f = FULL
    M = SLICE_BLOCKS * f["B"]
    write_dataset(d, seed=1, N=f["N"], chroms=((1, M),), P=f["P"],
                  n_inc=f["n_inc"], n_cov=f["K"] - 1)
    # [bt slice]'s table: the traits thresholded
    t0 = time.time()
    Y, X = dataset_traits(1, f["N"], ((1, M),), f["P"], f["K"] - 1)
    Yb = write_bt_table(f"{d}/pheno_bt.txt", Y, seed=5, n_inc=f["n_inc"], X=X)
    _table_note(f"{d}/pheno_bt.txt", t0, cases=int(np.nansum(Yb)))


def _bgen_slice_data(d):
    f = FULL
    write_bgen_dataset(d, seed=3, N=f["N"], chroms=((1, SLICE_BLOCKS * f["B"]),),
                       P=f["P"], n_inc=f["n_inc"], n_cov=f["K"] - 1)


def _step1_slice_data(d):
    f = FULL
    write_dataset(d, seed=5, N=f["N"], chroms=STEP1["chroms"], P=f["P"],
                  n_inc=f["n_inc"], n_cov=f["K"] - 1, effect_sd=STEP1["effect_sd"])
    # the tables of [step1 bt slice] and [t2e slice]
    t0 = time.time()
    Y, X = dataset_traits(5, f["N"], STEP1["chroms"], f["P"], f["K"] - 1)
    Yb = write_bt_table(f"{d}/pheno_bt.txt", Y, seed=6, n_inc=f["n_inc"], X=X)
    miss = np.isnan(Yb)
    _table_note(f"{d}/pheno_bt.txt", t0, cases=int(np.nansum(Yb)),
                n_in=int((~miss).any(axis=1).sum()),
                masked=[int(miss[:, 0].sum()), int(miss[:, -1].sum())])
    t0 = time.time()
    nt = T2E["endpoints"]
    times, events = write_t2e_table(f"{d}/pheno_t2e.txt", Y[:, :nt], seed=7,
                                    n_na=T2E["n_na"], X=X)
    rates = np.nanmean(events, axis=0)
    _table_note(f"{d}/pheno_t2e.txt", t0, rates=[float(rates.min()), float(rates.max())],
                times_t1=int(len(np.unique(times[:, 0]))),
                na_t1=int(np.isnan(times[:, 0]).sum()))


def _pgen_slice_data(d):
    f = FULL
    B = f["B"]
    write_pgen_dataset(d, seed=6, N=f["N"], chroms=((1, B), ("X", B)), P=f["P"],
                       n_inc=f["n_inc"], n_cov=f["K"] - 1,
                       positions={"X": chrx_positions(B, B // 8)})


# gene-based Step 2 at full width ([gene slice]): an exome-like BED of
# 2 x 192 variants in 16 sets of 24 (chip_smoke.gene_afs: 60% rare), the
# sets' products in 2 buckets of 8. The depth is cut from 32 sets, never
# N or P: the smoke took 1,188 s of its 1,200 s on a slow host with 32
GENE = dict(chroms=((1, 192), (2, 192)), set_size=24, bucket=8,
            aaf_bins="0.01,0.001", vc_tests="skato,acatv", joint="acat")


def _gene_slice_data(d):
    f = FULL
    M = sum(n for _, n in GENE["chroms"])
    write_dataset(d, seed=17, N=f["N"], chroms=GENE["chroms"], P=f["P"],
                  n_inc=f["n_inc"], n_cov=f["K"] - 1, af=gene_afs(M, f["N"], 18))
    write_gene_files(d, GENE["chroms"], GENE["set_size"], 19)


# the full-width datasets in the order the phases read them: the BED of
# [bed slice] and [bt slice], the two-chromosome BED of the Step-1,
# Step-1 BT and T2E slices (the side process takes it when [bt slice]
# starts), the BGEN of [bgen slice] and [dense slice], the PGEN of [pgen
# chrX slice], the exome-like BED of [gene slice]
_SHAPE = (f"N={FULL['N']} P={FULL['P']} K={FULL['K']}, "
          f"M={SLICE_BLOCKS} x {FULL['B']}")
FULL_DATASETS = {
    "bed": (_bed_slice_data, f"BED {_SHAPE}"),
    "step1": (_step1_slice_data, f"Step-1 BED N={FULL['N']}, "
              + " + ".join(str(n) for _, n in STEP1["chroms"]) + " variants"),
    "bgen": (_bgen_slice_data, f"BGEN (8-bit, zlib) {_SHAPE}"),
    "pgen": (_pgen_slice_data, f"PGEN {_SHAPE} (chromosome 1, chrX)"),
    "gene": (_gene_slice_data, f"gene-based BED N={FULL['N']} P={FULL['P']} "
             f"K={FULL['K']}, {sum(n for _, n in GENE['chroms'])} variants in "
             f"{sum(n for _, n in GENE['chroms']) // GENE['set_size']} sets")}


def _write_datasets(dirs, q):
    """Write FULL_DATASETS into dirs (name -> directory), in order; put
    (name, seconds) on the queue q as each is complete, or ("error",
    traceback) when one fails."""
    import traceback

    try:
        for name, d in dirs.items():
            t0 = time.time()
            FULL_DATASETS[name][0](d)
            q.put((name, time.time() - t0))
    except BaseException:
        q.put(("error", traceback.format_exc()))
        raise


class Datasets:
    """The full-width datasets, written by one background process (spawn)
    from the start of the smoke: the host idles while the card runs the
    kernel and profile phases, and writing a dataset costs ~30-90 s of
    host time. get(name) waits for one and returns its directory;
    close() stops the process."""

    def __init__(self, root):
        import multiprocessing

        self.dirs = {name: os.path.join(root, name) for name in FULL_DATASETS}
        for d in self.dirs.values():
            os.makedirs(d)
        ctx = multiprocessing.get_context("spawn")
        self.q = ctx.Queue()
        self.done = {}
        self.proc = ctx.Process(target=_write_datasets, args=(self.dirs, self.q))
        self.proc.start()

    def get(self, name):
        import queue

        t0 = time.time()
        while name not in self.done:
            try:
                got, secs = self.q.get(timeout=10)
            except queue.Empty:
                if not self.proc.is_alive():
                    raise RuntimeError("the dataset writer ended without "
                                       f"writing {name}") from None
                continue
            if got == "error":
                raise RuntimeError(f"the dataset writer failed:\n{secs}")
            self.done[got] = secs
        print(f"  dataset {FULL_DATASETS[name][1]}: written in the background in "
              f"{self.done[name]:.1f}s; waited {time.time() - t0:.1f}s for it")
        return self.dirs[name]

    def close(self):
        self.proc.join(10 if len(self.done) == len(self.dirs) else 0)
        if self.proc.is_alive():
            self.proc.terminate()
            self.proc.join(30)


def _bound(ops, nbytes, peak_ops):
    """(bound ms, what bounds it): the larger of the operations over the
    peak rate of their type and the compulsory bytes over the memory rate."""
    ms_ops, ms_bytes = ops / peak_ops * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(ms_ops, ms_bytes), ("operations" if ms_ops >= ms_bytes else "bytes")


def _time_ms(fn, reps):
    """Median milliseconds of fn() on the card (CUDA events, after one
    warm-up call)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def _check_i8_exact(raw, limbs_k, what):
    """Kernel against its plain version on the same card tensors (the
    K-major operand limbs_k [Cw4, 4*nbp]): H, E, M must be equal. Returns
    the max abs difference (0)."""
    import torch

    from regenie_tpu_torch.ops import kernels

    got = kernels.fused_i8_products(raw, limbs_k)
    want = kernels.fused_i8_products_plain(raw, limbs_k)
    torch.cuda.synchronize()
    err = max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
              for g, w in zip(got, want))
    print(f"  fused_i8 {what}: B={raw.shape[0]} nbp={raw.shape[1]} "
          f"Cw4={limbs_k.shape[0]} max|kernel-plain|={err}")
    if err != 0:
        raise AssertionError(f"fused_i8 kernel differs from its plain version "
                             f"({what}): max abs {err}")
    return err


def _shard_check(name, fn, x, dev, reps=10):
    """[mesh] fn (a kernel's wrapper, its operand bound) on x split into two
    row shards of one card (parallel.mesh.shard: a launch a shard) and put
    back together in shard order (parallel.mesh.gather) against fn on the
    whole block: the integer products must be exactly equal. Prints the
    two shards' launches timed together beside the whole block's launch
    (CUDA events, the split and the gather not timed). Returns the max
    abs difference (0)."""
    import torch

    from regenie_tpu_torch.parallel import mesh as pm

    mesh = pm.make_mesh([dev, dev])
    whole = fn(x)
    shards = pm.shard(mesh, x, 0)
    parts = [fn(part) for part in shards]
    got = [pm.gather([p[k] for p in parts], 0, x.shape[0])
           for k in range(len(whole))]
    torch.cuda.synchronize()
    err = max(int((g.long() - w.long()).abs().max()) for g, w in zip(got, whole))
    del whole, parts, got
    ms_whole = _time_ms(lambda: fn(x), reps)
    ms_shards = _time_ms(lambda: [fn(part) for part in shards], reps)
    print(f"  {name}, B = {x.shape[0]} on 2 shards of one card "
          f"({shards[0].shape[0]} rows each): max|sharded - whole| = {err}; "
          f"the two launches {ms_shards:.3f} ms, the whole block's {ms_whole:.3f} ms")
    if err != 0:
        raise AssertionError(f"{name}: the per-shard products differ from the "
                             f"whole block's (max abs {err})")
    return err


def _random_consts(rng, N, P, n_inc, K, device, pack="plane", split="i8"):
    """The port's fused operand for random inputs of the given shape
    (orthonormal covariates, n_inc traits with 5% missing): the int8
    limbs, or with split=False the float32 operand; for pack="sample"
    with the narrow [maskf | ind] operand in Wq."""
    import torch

    from regenie_tpu_torch.ops import fused_score as fsc

    ind = np.ones(N, bool)
    maskf = np.ones((N, P))
    for p in range(n_inc):
        maskf[rng.random(N) < 0.05, p] = 0.0
    res = rng.normal(size=(N, P)) * maskf
    cov = np.linalg.qr(rng.normal(size=(N, K)))[0]
    op = torch.float32 if split is False else None
    c = fsc.build_consts(cov, res, maskf, ind, float(N - K), device=device,
                         split=split, pack=pack, op_dtype=op)
    if pack == "sample":
        tail = np.concatenate([maskf, ind[:, None].astype(float)], axis=1)
        c = c._replace(Wq=fsc.sample_pack(tail, split, device,
                                          op or torch.float64)[0])
    return c


def fused_i8_phase(dev, reps=10):
    """fused_i8: exactness on ragged shapes (rows, bytes and columns off the
    128 x 128 tiles and the 32-byte stages, one stage or an odd number of
    them, so the two halves of the contraction are uneven or one is
    empty), on an operand built by the port at a small N (through its
    limbs_k), and at full width; times at full width. The K-major
    operands are built before any timing."""
    import torch

    from regenie_tpu_torch.ops import fused_score as fsc
    from regenie_tpu_torch.ops import kernels

    rng = np.random.default_rng(0)
    errs = []
    for B, nbp, Cw4 in ((37, 272, 400), (1, 16, 16), (129, 48, 1552),
                        (200, 16400, 400)):
        raw = torch.from_numpy(rng.integers(0, 256, (B, nbp), dtype=np.uint8)).to(dev)
        limbs_k = torch.from_numpy(
            rng.integers(-128, 128, (Cw4, 4 * nbp), dtype=np.int8)).to(dev)
        errs.append(_check_i8_exact(raw, limbs_k, "ragged, random limbs"))
    c = _random_consts(rng, 1025, 3, 1, 4, dev)
    raw = torch.from_numpy(fsc.pad_raw(
        rng.integers(0, 256, (37, 257), dtype=np.uint8))).to(dev)
    errs.append(_check_i8_exact(raw, c.Wp.limbs_k, "ragged, N=1025 operand"))

    f = FULL
    t0 = time.time()
    c = _random_consts(rng, f["N"], f["P"], f["n_inc"], f["K"], dev)
    nb = (f["N"] + 3) // 4
    raw = torch.from_numpy(fsc.pad_raw(
        rng.integers(0, 256, (f["B"], nb), dtype=np.uint8))).to(dev)
    limbs_k = c.Wp.limbs_k
    print(f"  full-width operand built in {time.time() - t0:.1f}s: "
          f"limbs {tuple(c.Wp.limbs.shape)}, limbs_k {tuple(limbs_k.shape)}, "
          f"C_used={c.layout_C()}")
    B, nbp = raw.shape
    Cw4 = limbs_k.shape[0]
    _launch_line("fused_i8", dev, B, Cw4)
    errs.append(_check_i8_exact(raw, limbs_k, "full width"))
    errs.append(_shard_check(
        "fused_i8", lambda x: kernels.fused_i8_products(x, limbs_k), raw, dev))
    ms = _time_ms(lambda: kernels.fused_i8_products(raw, limbs_k), reps)
    plain_ms = _time_ms(lambda: kernels.fused_i8_products_plain(raw, limbs_k), 3)

    # yardstick: one library int8 GEMM of the pre-decoded indicators (the
    # decode is not timed), with B row-major [4*nbp, Cw4] (the limbs) and
    # column-major (limbs_k.T, K contiguous, the layout cuBLASLt's int8
    # kernels take); each must give the kernel's numbers, the faster is
    # the row's library time
    r = raw.to(torch.int32)
    codes = [(r >> (2 * p)) & 3 for p in range(4)]
    ind = torch.cat([torch.cat([(cd == k).to(torch.int8) for cd in codes], 1)
                     for k in (0, 2, 1)], 0)  # [3B, 4*nbp], p-major columns
    del r, codes
    want = torch.cat(kernels.fused_i8_products(raw, limbs_k), 0)
    lib = {}
    for layout, w2 in (("row-major", c.Wp.limbs.reshape(4 * nbp, Cw4)),
                       ("K-major", limbs_k.T)):
        try:
            lib_out = torch._int_mm(ind, w2)
        except RuntimeError as e:
            print(f"  library int8 GEMM, B {layout}: refused ({e})")
            continue
        if not torch.equal(lib_out, want):
            raise AssertionError(f"library int8 GEMM (B {layout}) disagrees "
                                 "with the kernel")
        del lib_out
        lib[layout] = _time_ms(lambda: torch._int_mm(ind, w2), reps)
    del ind, want
    library_ms = min(lib.values()) if lib else None

    ops = 2.0 * 3 * B * (4 * nbp) * Cw4
    nbytes = B * nbp + 4 * nbp * Cw4 + 3 * B * Cw4 * 4
    bound_ms, bound_by = _bound(ops, nbytes, PEAK_INT8_OPS)
    print(f"  fused_i8 full width: {ms:.3f} ms (median of {reps}), plain "
          f"{plain_ms:.3f} ms, library int8 GEMM without decode "
          + ", ".join(f"B {k} {v:.3f} ms" for k, v in lib.items())
          + f", bound {bound_ms:.3f} ms ({bound_by}: "
          f"{ops:.3e} int8 ops, {nbytes / 1e9:.3f} GB); "
          f"{ops / ms / 1e9:.1f} TOP/s = {bound_ms / ms:.1%} of the bound")
    bt_width_fused_i8(dev, raw, reps)
    return dict(name="fused_i8", route="cuda",
                source="regenie_tpu_torch/ops/csrc/fused_i8.cu",
                replaces="regenie_tpu/ops/fused_score.py:403",
                launches=None, max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)


def bt_width_fused_i8(dev, raw, reps, limbs_k=None, what="BT width"):
    """fused_i8 at the binary-trait operand's width (Cw4 = 4 x 1,280; or
    on a given operand's K-major limbs_k) on the full-width block: exact
    against its plain version, timed beside torch._int_mm on the
    pre-decoded indicators (B K-major) and its bound. Printed, not a row
    of the kernels line (whose row is the QT width)."""
    import torch

    from regenie_tpu_torch.ops import kernels

    B, nbp = raw.shape
    if limbs_k is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(11)
        limbs_k = torch.randint(-128, 128, (4 * BT_CP, 4 * nbp), generator=gen,
                                device=dev, dtype=torch.int8)
    Cw4 = limbs_k.shape[0]
    _launch_line("fused_i8", dev, B, Cw4)
    _check_i8_exact(raw, limbs_k, what)
    ms = _time_ms(lambda: kernels.fused_i8_products(raw, limbs_k), reps)
    r = raw.to(torch.int32)
    codes = [(r >> (2 * p)) & 3 for p in range(4)]
    ind = torch.cat([torch.cat([(cd == k).to(torch.int8) for cd in codes], 1)
                     for k in (0, 2, 1)], 0)
    del r, codes
    lib_ms = _time_ms(lambda: torch._int_mm(ind, limbs_k.T), reps)
    del ind
    ops = 2.0 * 3 * B * (4 * nbp) * Cw4
    nbytes = B * nbp + 4 * nbp * Cw4 + 3 * B * Cw4 * 4
    bound_ms, bound_by = _bound(ops, nbytes, PEAK_INT8_OPS)
    print(f"  fused_i8 {what} (Cw4={Cw4}): {ms:.3f} ms (median of {reps}), "
          f"torch._int_mm B K-major {lib_ms:.3f} ms, bound {bound_ms:.3f} ms "
          f"({bound_by}: {ops:.3e} int8 ops); {bound_ms / ms:.1%} of the bound")


def bt_width_bgen_i8(dev, planes, gen, reps):
    """bgen_i8 at the binary-trait widths (Cw = 4 x 1,280, Cq = 4 x 256) on
    the full-width planes: exact against its plain version, timed beside
    six torch._int_mm of the shifted planes (B K-major) and its bound.
    Printed, not a row of the kernels line."""
    import torch

    from regenie_tpu_torch.ops import kernels

    B, _, Np = planes.shape
    Cw, Cq = 4 * BT_CP, 4 * BT_CQP
    wp, wq = (torch.randint(-128, 128, (cw, Np), generator=gen, device=dev,
                            dtype=torch.int8) for cw in (Cw, Cq))
    _launch_line("bgen_i8", dev, B, Cw, Cq)
    _check_bgen_exact(planes, wp, wq, "BT width")
    ms = _time_ms(lambda: kernels.bgen_i8_products(planes, wp, wq), reps)
    k0 = planes[:, 0].to(torch.int32)
    k1 = planes[:, 1].to(torch.int32)
    miss = (k0 + k1) > 255
    k0, k1 = torch.where(miss, 0, k0), torch.where(miss, 0, k1)
    d2 = (2 * k0 + k1) ** 2
    A = [(x - 128).to(torch.int8) for x in (k0, k1, d2 & 255, (d2 >> 8) & 255,
                                             d2 >> 16)] + [miss.to(torch.int8)]
    del k0, k1, miss, d2
    W = [wp.T, wp.T, wq.T, wq.T, wq.T, wp.T]
    lib_ms = _time_ms(lambda: [torch._int_mm(a, w) for a, w in zip(A, W)], reps)
    del A, W
    ops = 2.0 * B * Np * (3 * Cw + 3 * Cq)
    nbytes = 2 * B * Np + Np * (Cw + Cq) + 8 * B * (3 * Cw + 3 * Cq)
    bound_ms, bound_by = _bound(ops, nbytes, PEAK_INT8_OPS)
    print(f"  bgen_i8 BT width (Cw={Cw}, Cq={Cq}): {ms:.3f} ms (median of "
          f"{reps}), six torch._int_mm B K-major {lib_ms:.3f} ms, bound "
          f"{bound_ms:.3f} ms ({bound_by}: {ops:.3e} int8 ops); "
          f"{bound_ms / ms:.1%} of the bound")


def quantize_check(dev):
    """The int8 operand's quantization on the card (fused_score.i8_quantize,
    which plane_pack and sample_pack run) against the host's
    _i8_quantize_np on a full-height operand: random columns over many
    octaves, an all-zero column, half-way ties and column maxima at and
    one ulp around 127 x 2^k; limbs and scales bit for bit, column sums
    exact. Prints the card's time."""
    import torch

    from regenie_tpu_torch.ops import fused_score as fsc

    rng = np.random.default_rng(12)
    R = 4 * 100_096
    W = rng.normal(size=(R, 128)) * np.exp2(rng.integers(-40, 40, 128))[None, :]
    W[:, 0] = 0.0
    W[:, 1] = (rng.integers(-126, 126, R) + 0.5) * 2.0**-3
    W[0, 1] = 127 * 2.0**-3
    for c, e in ((2, 5), (3, -7), (4, 0)):
        W[:, c] = rng.uniform(-1, 1, R) * 127 * 2.0**e
        W[1, c] = 127 * 2.0**e
    W[1, 3] = np.nextafter(127 * 2.0**-7, np.inf)
    W[1, 4] = np.nextafter(127.0, 0.0)
    Wd = torch.from_numpy(W).to(dev)
    limbs, scale, usum = fsc.i8_quantize(Wd)
    torch.cuda.synchronize()
    t0 = time.time()
    fsc.i8_quantize(Wd)
    torch.cuda.synchronize()
    ms = (time.time() - t0) * 1e3
    l_np, s_np, q_np = fsc._i8_quantize_np(W)
    ok = (np.array_equal(limbs.cpu().numpy(), l_np)
          and np.array_equal(scale.cpu().numpy(), s_np)
          and np.array_equal(usum, q_np.sum(axis=0)))
    print(f"  int8 operand quantized on the card [{R}, 128]: {ms:.1f} ms; limbs, "
          f"scales and column sums equal to the host's: {ok}")
    if not ok:
        raise AssertionError("the card's int8 quantization differs from the host's")


def _check_bgen_exact(planes, wp_k, wq_k, what):
    """bgen_i8 against its plain version on the same card tensors (the
    K-major operands wp_k [Cw, Np], wq_k [Cq, Np]): the six int64 products
    must be equal. Returns the max abs difference (0)."""
    import torch

    from regenie_tpu_torch.ops import kernels

    got = kernels.bgen_i8_products(planes, wp_k, wq_k)
    want = kernels.bgen_i8_products_plain(planes, wp_k, wq_k)
    torch.cuda.synchronize()
    err = max(int((g - w).abs().max()) for g, w in zip(got, want))
    print(f"  bgen_i8 {what}: B={planes.shape[0]} Np={planes.shape[2]} "
          f"Cw={wp_k.shape[0]} Cq={wq_k.shape[0]} max|kernel-plain|={err}")
    if err != 0:
        raise AssertionError(f"bgen_i8 kernel differs from its plain version "
                             f"({what}): max abs {err}")
    return err


def _imputed_planes(gen, B, N, Np, dev, miss=0.01):
    """[B, 2, Np] uint8 probability planes drawn on the card: k0 uniform,
    k1 uniform below 256 - k0 (so k0 + k1 <= 255), a share `miss` of the
    pairs missing (255/255), pad samples zero."""
    import torch

    k0 = torch.randint(0, 256, (B, N), generator=gen, device=dev)
    k1 = (torch.rand((B, N), generator=gen, device=dev) * (256 - k0)).long()
    m = torch.rand((B, N), generator=gen, device=dev) < miss
    planes = torch.zeros((B, 2, Np), dtype=torch.uint8, device=dev)
    planes[:, 0, :N] = torch.where(m, 255, k0).to(torch.uint8)
    planes[:, 1, :N] = torch.where(m, 255, k1).to(torch.uint8)
    return planes


def bgen_i8_phase(dev, reps=10):
    """bgen_i8: exactness on ragged shapes (rows, samples and columns off
    the 128 x 128 tiles and the 128-sample stages, more than one
    65,536-sample int32 chunk), on an operand built by the port at a small
    N, and at full width; times at full width. The K-major operands are
    built before any timing."""
    import torch

    from regenie_tpu_torch.ops import fused_score as fsc
    from regenie_tpu_torch.ops import kernels

    rng = np.random.default_rng(5)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    errs = []
    # ragged (B, Np, Cw, Cq): rows off the row tile, samples ending
    # mid-stage or past a chunk, columns off the column tile, every byte
    # pair (about half of them missing)
    for B, Np, Cw, Cq in ((37, 272, 400, 144), (1, 16, 16, 16),
                          (129, 144, 144, 528), (200, 65536 + 144, 1552, 16)):
        planes = torch.from_numpy(
            rng.integers(0, 256, (B, 2, Np), dtype=np.uint8)).to(dev)
        wp, wq = (torch.from_numpy(rng.integers(-128, 128, (c, Np), dtype=np.int8)).to(dev)
                  for c in (Cw, Cq))
        errs.append(_check_bgen_exact(planes, wp, wq, "ragged, random limbs"))
    c = _random_consts(rng, 1025, 3, 1, 4, dev, pack="sample")
    Np = fsc.op_nbp(c.Wp)
    errs.append(_check_bgen_exact(_imputed_planes(gen, 37, 1025, Np, dev),
                                  c.Wp.limbs_k, c.Wq.limbs_k, "ragged, N=1025 operand"))

    # full width: the main path's shapes (C_used = 321 -> Cp = 384; the
    # [maskf | ind] tail of 51 columns -> Cqp = 128), random K-major limbs
    f = FULL
    Np = -(-f["N"] // 256) * 256
    B, Cw, Cq = f["B"], 4 * 384, 4 * 128
    planes = _imputed_planes(gen, B, f["N"], Np, dev)
    wp, wq = (torch.randint(-128, 128, (cw, Np), generator=gen, device=dev,
                            dtype=torch.int8) for cw in (Cw, Cq))
    _launch_line("bgen_i8", dev, B, Cw, Cq)
    errs.append(_check_bgen_exact(planes, wp, wq, "full width"))
    errs.append(_shard_check(
        "bgen_i8", lambda x: kernels.bgen_i8_products(x, wp, wq), planes, dev))
    ms = _time_ms(lambda: kernels.bgen_i8_products(planes, wp, wq), reps)
    plain_ms = _time_ms(lambda: kernels.bgen_i8_products_plain(planes, wp, wq), 3)
    # where the kernel's time goes: each operand's tiles with the other
    # operand cut to one 16-column tile (not checked)
    wp16, wq16 = wp[:16].contiguous(), wq[:16].contiguous()
    wp_ms = _time_ms(lambda: kernels.bgen_i8_products(planes, wp, wq16), reps)
    wq_ms = _time_ms(lambda: kernels.bgen_i8_products(planes, wp16, wq), reps)
    print(f"  bgen_i8 full width, Wp tiles with one 16-column Wq tile: {wp_ms:.3f} ms; "
          f"Wq tiles with one 16-column Wp tile: {wq_ms:.3f} ms")

    # yardstick: six library int8 GEMMs of the byte planes shifted by -128
    # (the TPU kernel's operands), built beforehand and not timed; its
    # int32 sums overflow at this N, so only its time is used
    k0 = planes[:, 0].to(torch.int32)
    k1 = planes[:, 1].to(torch.int32)
    miss = (k0 + k1) > 255
    k0, k1 = torch.where(miss, 0, k0), torch.where(miss, 0, k1)
    d2 = (2 * k0 + k1) ** 2
    A = [(x - 128).to(torch.int8) for x in (k0, k1, d2 & 255, (d2 >> 8) & 255,
                                             d2 >> 16)] + [miss.to(torch.int8)]
    del k0, k1, miss, d2
    # B row-major (the [Np, C] layout) and column-major (wp.T, wq.T of the
    # K-major operands, K contiguous); the faster is the row's library time
    lib = {}
    for layout, (w1, w2) in (("row-major", (wp.T.contiguous(), wq.T.contiguous())),
                             ("K-major", (wp.T, wq.T))):
        W = [w1, w1, w2, w2, w2, w1]
        try:
            torch._int_mm(A[0], W[0])
        except RuntimeError as e:
            print(f"  library int8 GEMMs, B {layout}: refused ({e})")
            continue
        lib[layout] = _time_ms(lambda: [torch._int_mm(a, w) for a, w in zip(A, W)],
                               reps)
        del W, w1, w2
    del A
    library_ms = min(lib.values()) if lib else None

    ops = 2.0 * B * Np * (3 * Cw + 3 * Cq)
    nbytes = 2 * B * Np + Np * (Cw + Cq) + 8 * B * (3 * Cw + 3 * Cq)
    bound_ms, bound_by = _bound(ops, nbytes, PEAK_INT8_OPS)
    print(f"  bgen_i8 full width: {ms:.3f} ms (median of {reps}), plain "
          f"{plain_ms:.3f} ms, library: six int8 GEMMs of the shifted planes, "
          + ", ".join(f"B {k} {v:.3f} ms" for k, v in lib.items())
          + f", bound {bound_ms:.3f} ms ({bound_by}: "
          f"{ops:.3e} int8 ops, {nbytes / 1e9:.3f} GB); "
          f"{ops / ms / 1e9:.1f} TOP/s = {bound_ms / ms:.1%} of the bound")
    del wp, wq, wp16, wq16
    bt_width_bgen_i8(dev, planes, gen, reps)
    return dict(name="bgen_i8", route="cuda",
                source="regenie_tpu_torch/ops/csrc/bgen_i8.cu",
                replaces="regenie_tpu/ops/fused_score.py:1093",
                launches=None, max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)


def _check_sums(name, got, want, bar, what, rel=F64_SUM_BAR):
    """A float-operand kernel against its plain version on the same card
    tensors: every float64 product within `rel` times the same product
    taken against |W| (`bar`). Returns the max abs difference."""
    import torch

    torch.cuda.synchronize()
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    share = max(float(((g - w).abs() / (rel * b).clamp(min=1e-300)).max())
                for g, w, b in zip(got, want, bar))
    print(f"  {name} {what}: max|kernel-plain|={err:.3e}, largest share of "
          f"the bar {share:.3e}")
    if share > 1.0:
        raise AssertionError(f"{name} kernel differs from its plain version "
                             f"({what}) beyond {rel:g} x |W| products")
    return err


def _matmul_ms(mats, reps):
    """Summed median milliseconds of one torch.matmul per (A, W) pair,
    each A built just before its timing and freed after it."""
    import torch

    total = 0.0
    for make_a, w in mats:
        a = make_a()
        total += _time_ms(lambda: torch.matmul(a, w), reps)
        del a
    return total


def _launch_line(name, dev, *shape):
    """Print the launch of a kernel with an info entry point (fused_i8,
    fused_f32, fused_bf16, bgen_i8, bgen_f32, bgen_bf16) at `shape` as the
    CUDA runtime
    reports it: blocks, blocks per SM, waves on this card's SMs,
    registers a thread."""
    import torch

    from regenie_tpu_torch.ops import kernels

    info = kernels.launch_info(name, *shape, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    waves = info["blocks"] / (sms * info["blocks_per_sm"])
    print(f"  {name} launch at full width: {info['blocks']} blocks of "
          f"{info['threads']} threads, {info['blocks_per_sm']} per SM, "
          f"{waves:.3f} waves on {sms} SMs; {info['registers']} registers "
          f"a thread, {info['smem_bytes']} bytes of shared memory")


def fused_f32_phase(dev, reps=10):
    """fused_f32: within the bar on ragged shapes, on an operand built by
    the port at a small N, and at full width; times at full width."""
    import torch

    from regenie_tpu_torch.ops import fused_score as fsc
    from regenie_tpu_torch.ops import kernels

    rng = np.random.default_rng(6)
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    errs = []

    def check(raw, wp, what):
        errs.append(_check_sums(
            "fused_f32", kernels.fused_f32_products(raw, wp),
            kernels.fused_f32_products_plain(raw, wp),
            kernels.fused_f32_products_plain(raw, wp.abs()), what))

    # ragged: rows off the 128-row tile, bytes ending mid-stage, Cp 384
    # and column counts off the 48-column tile; B = 1 on a contraction of
    # one 32-byte stage
    for B, nbp, Cp in ((37, 272, 400), (130, 512, 384), (129, 48, 52),
                       (1, 32, 44)):
        raw = torch.from_numpy(rng.integers(0, 256, (B, nbp), dtype=np.uint8)).to(dev)
        wp = torch.from_numpy(rng.normal(size=(4, nbp, Cp)).astype(np.float32)).to(dev)
        check(raw, wp, f"ragged B={B} nbp={nbp} Cp={Cp}")
    c = _random_consts(rng, 1025, 3, 1, 4, dev, split=False)
    raw = torch.from_numpy(fsc.pad_raw(
        rng.integers(0, 256, (37, 257), dtype=np.uint8))).to(dev)
    check(raw, c.Wp, f"ragged, N=1025 operand {tuple(c.Wp.shape)}")

    # full width: the main path's shapes (C_used = 321 -> Cp = 384), a
    # random float32 operand
    f = FULL
    nbp = -(-((f["N"] + 3) // 4) // 256) * 256
    B, Cp = f["B"], 384
    raw = torch.randint(0, 256, (B, nbp), generator=gen, device=dev, dtype=torch.uint8)
    wp = torch.randn((4, nbp, Cp), generator=gen, device=dev)
    check(raw, wp, "full width")
    _launch_line("fused_f32", dev, B, Cp)
    ms = _time_ms(lambda: kernels.fused_f32_products(raw, wp), reps)
    plain_ms = _time_ms(lambda: kernels.fused_f32_products_plain(raw, wp), 3)

    # yardstick: one float64 torch.matmul (cuBLAS DGEMM) per product, of
    # the indicators decoded beforehand against the widened operand
    w2 = wp.reshape(4 * nbp, Cp).double()

    def indicators(code):
        r = raw.to(torch.int32)
        return torch.cat([((r >> (2 * p)) & 3) == code for p in range(4)],
                         1).double()  # [B, 4*nbp], p-major columns

    library_ms = _matmul_ms([(lambda k=k: indicators(k), w2)
                                 for k in (0, 2, 1)], reps)
    del w2

    ops = 2.0 * 3 * B * (4 * nbp) * Cp
    nbytes = B * nbp + 4 * nbp * Cp * 4 + 3 * B * Cp * 8
    bound_ms, bound_by = _bound(ops, nbytes, PEAK_FP64_TC_OPS)
    print(f"  fused_f32 full width: {ms:.3f} ms (median of {reps}), plain "
          f"{plain_ms:.3f} ms, library: three float64 matmuls of decoded "
          f"indicators {library_ms:.3f} ms, bound {bound_ms:.3f} ms "
          f"({bound_by}: {ops:.3e} FP64 ops, {nbytes / 1e9:.3f} GB); "
          f"{ops / ms / 1e9:.2f} TFLOP/s = {bound_ms / ms:.1%} of the bound")
    return dict(name="fused_f32", route="cuda",
                source="regenie_tpu_torch/ops/csrc/fused_f32.cu",
                replaces="regenie_tpu/ops/fused_score.py:331",
                launches=None, max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)


def bgen_f32_phase(dev, reps=10):
    """bgen_f32: within the bar on ragged shapes, on an operand built by
    the port at a small N, and at full width; times at full width."""
    import torch

    from regenie_tpu_torch.ops import fused_score as fsc
    from regenie_tpu_torch.ops import kernels

    rng = np.random.default_rng(7)
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    errs = []

    def check(planes, wp, wq, what):
        errs.append(_check_sums(
            "bgen_f32", kernels.bgen_f32_products(planes, wp, wq),
            kernels.bgen_f32_products_plain(planes, wp, wq),
            kernels.bgen_f32_products_plain(planes, wp.abs(), wq.abs()), what))

    # ragged: rows off the row tile, samples ending mid-stage, columns off
    # the column tile, every byte pair (about half of them missing); B = 1
    # on a contraction of one 128-sample stage
    for B, Np, Cw, Cq in ((37, 272, 400, 144), (130, 768, 384, 128),
                          (65, 80, 68, 20), (1, 128, 4, 132)):
        planes = torch.from_numpy(rng.integers(0, 256, (B, 2, Np), dtype=np.uint8)).to(dev)
        wp, wq = (torch.from_numpy(rng.normal(size=(Np, cw)).astype(np.float32)).to(dev)
                  for cw in (Cw, Cq))
        check(planes, wp, wq, f"ragged B={B} Np={Np} Cw={Cw} Cq={Cq}")
    c = _random_consts(rng, 1025, 3, 1, 4, dev, pack="sample", split=False)
    Np = fsc.op_nbp(c.Wp)
    check(_imputed_planes(gen, 37, 1025, Np, dev), c.Wp, c.Wq,
          f"ragged, N=1025 operand {tuple(c.Wp.shape)} / {tuple(c.Wq.shape)}")

    # full width: the main path's shapes (Cp = 384; the [maskf | ind] tail
    # of 51 columns -> Cqp = 128), random float32 operands
    f = FULL
    Np = -(-f["N"] // 256) * 256
    B, Cw, Cq = f["B"], 384, 128
    planes = _imputed_planes(gen, B, f["N"], Np, dev)
    wp = torch.randn((Np, Cw), generator=gen, device=dev)
    wq = torch.randn((Np, Cq), generator=gen, device=dev)
    check(planes, wp, wq, "full width")
    _launch_line("bgen_f32", dev, B, Cw, Cq)
    ms = _time_ms(lambda: kernels.bgen_f32_products(planes, wp, wq), reps)
    plain_ms = _time_ms(lambda: kernels.bgen_f32_products_plain(planes, wp, wq), 3)

    # yardstick: six float64 torch.matmul (cuBLAS DGEMM), of the byte
    # multiplicands decoded beforehand against the widened operands
    wpd, wqd = wp.double(), wq.double()
    library_ms = _matmul_ms(
        [(lambda i=i: kernels.bgen_indicators(planes)[i].double(), w)
         for i, w in enumerate((wpd, wpd, wqd, wqd, wqd, wpd))], reps)
    del wpd, wqd

    ops = 2.0 * B * Np * (3 * Cw + 3 * Cq)
    nbytes = 2 * B * Np + Np * (Cw + Cq) * 4 + 8 * B * (3 * Cw + 3 * Cq)
    bound_ms, bound_by = _bound(ops, nbytes, PEAK_FP64_TC_OPS)
    print(f"  bgen_f32 full width: {ms:.3f} ms (median of {reps}), plain "
          f"{plain_ms:.3f} ms, library: six float64 matmuls of decoded "
          f"bytes {library_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}: "
          f"{ops:.3e} FP64 ops, {nbytes / 1e9:.3f} GB); "
          f"{ops / ms / 1e9:.2f} TFLOP/s = {bound_ms / ms:.1%} of the bound")
    return dict(name="bgen_f32", route="cuda",
                source="regenie_tpu_torch/ops/csrc/bgen_f32.cu",
                replaces="regenie_tpu/ops/fused_score.py:1054",
                launches=None, max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)


def _bf16_randn(gen, shape, dev):
    """Standard normal values drawn on the card, rounded to bf16."""
    import torch

    return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)


def fused_bf16_phase(dev, reps=10):
    """fused_bf16: within the flush bar on ragged shapes, on a split
    operand built by the port at a small N, and at full width, and
    exactly equal on 0/1 operands; times at full width."""
    import torch

    from regenie_tpu_torch.ops import fused_score as fsc
    from regenie_tpu_torch.ops import kernels

    rng = np.random.default_rng(8)
    gen = torch.Generator(device=dev)
    gen.manual_seed(8)
    rel = kernels.BF16_FLUSH * 2.0**-23
    errs = []

    def check(raw, wp, what):
        errs.append(_check_sums(
            "fused_bf16", kernels.fused_bf16_products(raw, wp),
            kernels.fused_bf16_products_plain(raw, wp),
            kernels.fused_bf16_products_plain(raw, wp.abs()), what, rel))

    def check01(raw, ones, what):
        # 0/1 operands: integer partial sums below 2 x 4096, so exactly
        # the plain integers (what shows a wrong k order or descriptor)
        err01 = max(float((g - w).abs().max()) for g, w in zip(
            kernels.fused_bf16_products(raw, ones),
            kernels.fused_bf16_products_plain(raw, ones)))
        print(f"  fused_bf16 {what}, 0/1 operand: max|kernel-plain|={err01}")
        if err01 != 0:
            raise AssertionError("fused_bf16 differs from its plain version "
                                 f"on a 0/1 operand ({what}): {err01}")

    # ragged: rows off the 128-row tile, bytes ending mid-stage, columns
    # off the 64-column tile; 2064 bytes = 3 float32 partial sums, the
    # last short; B = 1 on 16 bytes (less than one 32-byte stage), 1040
    # bytes (one flush and 16) with B = 129 (one row into a second tile),
    # 48 bytes (one and a half stages) on an exact tile
    for B, nbp, Cw in ((37, 272, 400), (130, 2064, 1152), (1, 16, 72),
                       (129, 1040, 200), (128, 48, 64)):
        raw = torch.from_numpy(rng.integers(0, 256, (B, nbp), dtype=np.uint8)).to(dev)
        wp = _bf16_randn(gen, (4, nbp, Cw), dev)
        what = f"ragged B={B} nbp={nbp} Cw={Cw}"
        check(raw, wp, what)
        check01(raw, (wp > 0).to(torch.bfloat16), what)
    c = _random_consts(rng, 1025, 3, 1, 4, dev, split=True)
    raw = torch.from_numpy(fsc.pad_raw(
        rng.integers(0, 256, (37, 257), dtype=np.uint8))).to(dev)
    check(raw, c.Wp, f"ragged, N=1025 split operand {tuple(c.Wp.shape)}")

    # full width: the main path's shapes (C_used = 321 -> Cp = 384, three
    # thirds -> Cw = 1152), a random bf16 operand
    f = FULL
    nbp = -(-((f["N"] + 3) // 4) // 256) * 256
    B, Cw = f["B"], 3 * 384
    raw = torch.randint(0, 256, (B, nbp), generator=gen, device=dev, dtype=torch.uint8)
    wp = _bf16_randn(gen, (4, nbp, Cw), dev)
    check(raw, wp, "full width")
    check01(raw, (wp > 0).to(torch.bfloat16), "full width")
    _launch_line("fused_bf16", dev, B, Cw)
    ms = _time_ms(lambda: kernels.fused_bf16_products(raw, wp), reps)
    plain_ms = _time_ms(lambda: kernels.fused_bf16_products_plain(raw, wp), 3)

    # yardstick: one bf16 torch.matmul (cuBLAS, float32 accumulation, bf16
    # output) per product, of the indicators decoded beforehand
    w2 = wp.reshape(4 * nbp, Cw)

    def indicators(code):
        r = raw.to(torch.int32)
        return torch.cat([((r >> (2 * p)) & 3) == code for p in range(4)],
                         1).to(torch.bfloat16)  # [B, 4*nbp], p-major columns

    library_ms = _matmul_ms([(lambda k=k: indicators(k), w2)
                             for k in (0, 2, 1)], reps)
    del w2

    ops = 2.0 * 3 * B * (4 * nbp) * Cw
    nbytes = B * nbp + 4 * nbp * Cw * 2 + 3 * B * Cw * 8
    bound_ms, bound_by = _bound(ops, nbytes, PEAK_BF16_OPS)
    print(f"  fused_bf16 full width: {ms:.3f} ms (median of {reps}), plain "
          f"{plain_ms:.3f} ms, library: three bf16 matmuls of decoded "
          f"indicators {library_ms:.3f} ms, bound {bound_ms:.3f} ms "
          f"({bound_by}: {ops:.3e} bf16 ops, {nbytes / 1e9:.3f} GB); "
          f"{ops / ms / 1e9:.1f} TFLOP/s = {bound_ms / ms:.1%} of the bound")
    return dict(name="fused_bf16", route="cuda",
                source="regenie_tpu_torch/ops/csrc/fused_bf16.cu",
                replaces="regenie_tpu/ops/fused_score.py:364",
                launches=None, max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)


def bgen_bf16_phase(dev, reps=10):
    """bgen_bf16: within the flush bar on ragged shapes, on split operands
    built by the port at a small N, and at full width, and exactly equal
    on 0/1 operands (the mask and ind columns); times at full width."""
    import torch

    from regenie_tpu_torch.ops import fused_score as fsc
    from regenie_tpu_torch.ops import kernels

    rng = np.random.default_rng(9)
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    rel = kernels.BF16_FLUSH * 2.0**-23
    errs = []

    def check(planes, wp, wq, what):
        errs.append(_check_sums(
            "bgen_bf16", kernels.bgen_bf16_products(planes, wp, wq),
            kernels.bgen_bf16_products_plain(planes, wp, wq),
            kernels.bgen_bf16_products_plain(planes, wp.abs(), wq.abs()),
            what, rel))

    def check01(planes, ones, what):
        # 0/1 operands: integer partial sums below 255 x 4096 < 2^24, so
        # exactly the plain integers (what keeps INFO and A1FREQ exact)
        err01 = max(float((g - w).abs().max()) for g, w in zip(
            kernels.bgen_bf16_products(planes, *ones),
            kernels.bgen_bf16_products_plain(planes, *ones)))
        print(f"  bgen_bf16 {what}, 0/1 operands: max|kernel-plain|={err01}")
        if err01 != 0:
            raise AssertionError("bgen_bf16 differs from its plain version on "
                                 f"0/1 operands ({what}): {err01}")

    # ragged: rows off the 128-row tile, samples ending mid-stage, columns
    # off the 64-column tile, every byte pair (about half of them
    # missing); 9232 samples = 3 float32 partial sums, the last short;
    # B = 1 on 16 samples (less than one stage), 4112 samples (one flush
    # and 16), B = 129 (one row into a second tile)
    for B, Np, Cw, Cq in ((37, 272, 400, 144), (130, 9232, 1152, 384),
                          (1, 16, 72, 8), (129, 4112, 200, 136),
                          (129, 80, 64, 56)):
        planes = torch.from_numpy(rng.integers(0, 256, (B, 2, Np), dtype=np.uint8)).to(dev)
        wp, wq = _bf16_randn(gen, (Np, Cw), dev), _bf16_randn(gen, (Np, Cq), dev)
        check(planes, wp, wq, f"ragged B={B} Np={Np} Cw={Cw} Cq={Cq}")
        ones = (wp > 0).to(torch.bfloat16), (wq > 0).to(torch.bfloat16)
        check01(planes, ones, f"ragged B={B} Np={Np} Cw={Cw} Cq={Cq}")
    c = _random_consts(rng, 1025, 3, 1, 4, dev, pack="sample", split=True)
    Np = fsc.op_nbp(c.Wp)
    check(_imputed_planes(gen, 37, 1025, Np, dev), c.Wp, c.Wq,
          f"ragged, N=1025 split operands {tuple(c.Wp.shape)} / {tuple(c.Wq.shape)}")

    # full width: the main path's shapes (Cp = 384, Cqp = 128, three
    # thirds each), random bf16 operands
    f = FULL
    Np = -(-f["N"] // 256) * 256
    B, Cw, Cq = f["B"], 3 * 384, 3 * 128
    planes = _imputed_planes(gen, B, f["N"], Np, dev)
    wp = _bf16_randn(gen, (Np, Cw), dev)
    wq = _bf16_randn(gen, (Np, Cq), dev)
    check(planes, wp, wq, "full width")
    check01(planes, ((wp > 0).to(torch.bfloat16), (wq > 0).to(torch.bfloat16)),
            "full width")
    _launch_line("bgen_bf16", dev, B, Cw, Cq)
    ms = _time_ms(lambda: kernels.bgen_bf16_products(planes, wp, wq), reps)
    plain_ms = _time_ms(lambda: kernels.bgen_bf16_products_plain(planes, wp, wq), 3)

    # yardstick: six bf16 torch.matmul (cuBLAS), of the byte multiplicands
    # decoded beforehand (exact in bf16)
    library_ms = _matmul_ms(
        [(lambda i=i: kernels.bgen_indicators(planes)[i].to(torch.bfloat16), w)
         for i, w in enumerate((wp, wp, wq, wq, wq, wp))], reps)

    ops = 2.0 * B * Np * (3 * Cw + 3 * Cq)
    nbytes = 2 * B * Np + Np * (Cw + Cq) * 2 + 8 * B * (3 * Cw + 3 * Cq)
    bound_ms, bound_by = _bound(ops, nbytes, PEAK_BF16_OPS)
    print(f"  bgen_bf16 full width: {ms:.3f} ms (median of {reps}), plain "
          f"{plain_ms:.3f} ms, library: six bf16 matmuls of decoded bytes "
          f"{library_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}: "
          f"{ops:.3e} bf16 ops, {nbytes / 1e9:.3f} GB); "
          f"{ops / ms / 1e9:.1f} TFLOP/s = {bound_ms / ms:.1%} of the bound")
    return dict(name="bgen_bf16", route="cuda",
                source="regenie_tpu_torch/ops/csrc/bgen_bf16.cu",
                replaces="regenie_tpu/ops/fused_score.py:1054",
                launches=None, max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)


def decode_planes_phase(dev, reps=10):
    """decode_planes: exactly equal to its plain version on ragged shapes
    (byte counts that are and are not multiples of 4) and at full width;
    times at full width. No single PyTorch call computes the decode, so
    there is no library time."""
    import torch

    from regenie_tpu_torch.ops import kernels
    from regenie_tpu_torch.ops import pallas_ops

    gen = torch.Generator(device=dev)
    gen.manual_seed(10)
    f = FULL
    full = (f["B"], (f["N"] + 3) // 4)
    for B, nb in ((37, 250), (5, 257), (130, 1024), full):
        raw = torch.randint(0, 256, (B, nb), generator=gen, device=dev,
                            dtype=torch.uint8)
        got = pallas_ops.decode_bed_planes(raw)
        want = pallas_ops.decode_bed_planes_plain(raw)
        torch.cuda.synchronize()
        same = torch.equal(got, want)
        print(f"  decode_planes B={B} nb={nb}: "
              f"{'equal' if same else 'DIFFERENT'} to the plain version")
        if not same:
            raise AssertionError(f"decode_planes differs from its plain version "
                                 f"at B={B} nb={nb}")
        del got, want
    ms = _time_ms(lambda: pallas_ops.decode_bed_planes(raw), reps)
    plain_ms = _time_ms(lambda: pallas_ops.decode_bed_planes_plain(raw), 3)
    B, nb = full
    nbytes = B * nb + 16 * B * nb
    bound_ms, bound_by = _bound(0.0, nbytes, PEAK_BF16_OPS)
    print(f"  decode_planes full width: {ms:.3f} ms (median of {reps}), plain "
          f"{plain_ms:.3f} ms, no library call, bound {bound_ms:.3f} ms "
          f"({bound_by}: {nbytes / 1e9:.3f} GB); "
          f"{nbytes / ms / 1e6:.1f} GB/s = {bound_ms / ms:.1%} of the bound")
    return dict(name="decode_planes", route="cuda",
                source="regenie_tpu_torch/ops/csrc/decode_planes.cu",
                replaces="regenie_tpu/ops/pallas_ops.py:27",
                launches=None, max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


def profile_fused_phase(dev, reps=10):
    """The five profile_fused configurations: within the flush bar (and
    decode-only exactly equal) on ragged shapes, on a split operand built
    by the port at a small N, and at fused_bf16's full width, where each
    is timed beside its plain version, its bound and its library
    yardstick. The other Hopper configurations of stacked and pipelined
    are checked and timed too; the rows take configuration 0."""
    import torch

    from regenie_tpu_torch.ops import fused_score as fsc
    from regenie_tpu_torch.ops import kernels as K

    rng = np.random.default_rng(14)
    gen = torch.Generator(device=dev)
    gen.manual_seed(14)
    rel = K.BF16_FLUSH * 2.0**-23
    # (row name, label, wrapper call, plain version, TPU kernel)
    cases = [("profile_stacked", f"stacked ({c})",
              lambda r, w, i=i: K.profile_stacked_products(r, w, config=i),
              K.profile_stacked_products_plain, "scripts/profile_fused.py:57")
             for i, c in enumerate(K.PROFILE_STACKED_CONFIGS)]
    cases += [("profile_stacked_2dots", "stacked-2dots",
               K.profile_stacked_2dots_products,
               K.profile_stacked_2dots_products_plain, "scripts/profile_fused.py:57"),
              ("profile_nodecode", "nodecode", K.profile_nodecode_products,
               K.profile_nodecode_products_plain, "scripts/profile_fused.py:82"),
              ("profile_decode_only", "decode-only", K.profile_decode_only_products,
               K.profile_decode_only_products_plain, "scripts/profile_fused.py:98")]
    cases += [("profile_pipelined", f"pipelined ({c})",
               lambda r, w, i=i: K.profile_pipelined_products(r, w, config=i),
               K.profile_pipelined_products_plain, "scripts/profile_fused.py:123")
              for i, c in enumerate(K.PROFILE_PIPELINED_CONFIGS)]
    errs = {}

    def check(raw, wp, what):
        plain = {}
        for row, label, fn, plain_fn, _ in cases:
            if plain_fn not in plain:
                plain[plain_fn] = (plain_fn(raw, wp), None if row == "profile_decode_only"
                                   else plain_fn(raw, wp.abs()))
            want, bar = plain[plain_fn]
            got = fn(raw, wp)
            if bar is None:
                torch.cuda.synchronize()
                same = all(torch.equal(g, w) for g, w in zip(got, want))
                print(f"  {label} {what}: {'equal' if same else 'DIFFERENT'} to "
                      "the plain version")
                if not same:
                    raise AssertionError(f"{label} differs from its plain version ({what})")
                err = 0.0
            else:
                err = _check_sums(label, got, want, bar, what, rel)
            errs[row] = max(errs.get(row, 0.0), err)

    # ragged: rows off the row tile, bytes ending mid-stage, columns off
    # the column tile; 2064 bytes = 3 float32 partial sums, the last short
    for B, nbp, Cw in ((37, 272, 400), (130, 2064, 1152)):
        raw = torch.from_numpy(rng.integers(0, 256, (B, nbp), dtype=np.uint8)).to(dev)
        check(raw, _bf16_randn(gen, (4, nbp, Cw), dev), f"ragged B={B} nbp={nbp} Cw={Cw}")
    c = _random_consts(rng, 1025, 3, 1, 4, dev, split=True)
    raw = torch.from_numpy(fsc.pad_raw(
        rng.integers(0, 256, (37, 257), dtype=np.uint8))).to(dev)
    check(raw, c.Wp, f"ragged, N=1025 split operand {tuple(c.Wp.shape)}")

    # full width: fused_bf16's shapes (Cw = 3 x 384), a random bf16 operand
    f = FULL
    nbp = -(-((f["N"] + 3) // 4) // 256) * 256
    B, Cw = f["B"], 3 * 384
    raw = torch.randint(0, 256, (B, nbp), generator=gen, device=dev, dtype=torch.uint8)
    wp = _bf16_randn(gen, (4, nbp, Cw), dev)
    check(raw, wp, "full width")
    times = {label: _time_ms(lambda fn=fn: fn(raw, wp), reps)
             for _, label, fn, _, _ in cases}
    bf16_ms = _time_ms(lambda: K.fused_bf16_products(raw, wp), reps)
    for label, ms in times.items():
        print(f"  {label} full width: {ms:.3f} ms (median of {reps})")
    print(f"  fused_bf16 on the same inputs: {bf16_ms:.3f} ms")

    # yardsticks: bf16 torch.matmul (cuBLAS) of the indicators (codes 0, 2,
    # 1) or of the bytes, decoded beforehand, against wp as [4*nbp, Cw]
    w2 = wp.reshape(4 * nbp, Cw)

    def indicators(code):
        r = raw.to(torch.int32)
        return torch.cat([((r >> (2 * p)) & 3) == code for p in range(4)],
                         1).to(torch.bfloat16)  # [B, 4*nbp], p-major columns

    lib_he = _matmul_ms([(lambda k=k: indicators(k), w2) for k in (0, 2)], reps)
    lib_m = _matmul_ms([(lambda: indicators(1), w2)], reps)
    lib_bytes = _matmul_ms([(lambda: torch.cat([raw.to(torch.bfloat16)] * 4, 1), w2)]
                           * 3, reps)
    del w2

    first = {}
    for row, label, _, plain_fn, src in cases:
        first.setdefault(row, (label, plain_fn, src))
    ops3 = 2.0 * 3 * B * (4 * nbp) * Cw
    nbytes = B * nbp + 4 * nbp * Cw * 2 + 3 * B * Cw * 8
    work = {"profile_stacked": (ops3, lib_he + lib_m),
            "profile_stacked_2dots": (ops3 * 2 / 3, lib_he),
            "profile_nodecode": (ops3, lib_bytes),
            "profile_decode_only": (0.0, None),
            "profile_pipelined": (ops3, lib_he + lib_m)}
    rows = []
    for row, (label, plain_fn, src) in first.items():
        ops, library_ms = work[row]
        ms = times[label]
        plain_ms = _time_ms(lambda plain_fn=plain_fn: plain_fn(raw, wp), 3)
        bound_ms, bound_by = _bound(ops, nbytes, PEAK_BF16_OPS)
        lib = "no library call" if library_ms is None else \
            f"library {library_ms:.3f} ms"
        print(f"  {label} full width: {ms:.3f} ms, plain {plain_ms:.3f} ms, {lib}, "
              f"bound {bound_ms:.3f} ms ({bound_by}: {ops:.3e} bf16 ops, "
              f"{nbytes / 1e9:.3f} GB) = {bound_ms / ms:.1%} of the bound")
        rows.append(dict(name=row, route="cuda",
                         source="regenie_tpu_torch/ops/csrc/profile_fused.cu",
                         replaces=src, launches=None, max_abs_err=errs[row], ms=ms,
                         plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                         library_ms=library_ms))
    st, nd, do = (times[first[r][0]] for r in ("profile_stacked", "profile_nodecode",
                                                "profile_decode_only"))
    print(f"  attribution (stacked {st:.3f} ms): decode ~ stacked - nodecode = "
          f"{st - nd:.3f} ms ({(st - nd) / st:.1%}); mma ~ stacked - decode-only = "
          f"{st - do:.3f} ms ({(st - do) / st:.1%}); on {card_line()}")
    return rows


# the kernel functions of scripts/profile_bgen.py: (function, the port's
# profile_bgen variant, the mode of the port's script that times it,
# whether that mode reads one [B, 2, Np] buffer, the function's line)
PROFILE_BGEN_ROWS = (
    ("kern_base", "i32_shift_q3", "variants", True, 174),
    ("kern_noq", "i32_shift_noq", "variants", True, 197),
    ("kern_u8", "u8_shift_q3", "variants", True, 216),
    ("kern_sep", "i32_shift_q3", "variants2", False, 300),
    ("kern_sep_noq", "i32_shift_noq", "variants2", False, 323),
    ("kern_sep_merge", "u8_unshift_q3_stacked", "variants2", False, 343),
    ("make_base(.., 3)", "u8_unshift_q3", "variants3", False, 477),
    ("make_base(.., 2)", "u8_unshift_e2", "variants3", False, 477),
    ("make_base(.., 4)", "u8_unshift_dhl", "variants3", False, 477),
)


def _profile_bgen_row(func, variant):
    return f"profile_bgen_{variant} ({func})"


def _library_pairs(planes, wp, wq, variant):
    """The int8 multiplicands of a profile_bgen variant's dots, decoded
    beforehand, each with its operand: s(k0), s(k1) and s(miss) or miss
    against wp, the shifted q bytes against wq (dhl's q2 as its two
    dots)."""
    import torch

    from regenie_tpu_torch.ops import kernels as K

    shift_m, q, _ = K.PROFILE_BGEN_VARIANTS[variant]
    k0 = planes[:, 0].to(torch.int32)
    k1 = planes[:, 1].to(torch.int32)
    miss = (k0 + k1) > 255
    k0, k1 = torch.where(miss, 0, k0), torch.where(miss, 0, k1)
    miss = miss.to(torch.int32)
    d = 2 * k0 + k1
    xq = {"noq": lambda: [], "q3": lambda: [d * d & 255, (d * d >> 8) & 255, d * d >> 16],
          "e2": lambda: [(d - 255) ** 2 & 255, (d - 255) ** 2 >> 8],
          "dhl": lambda: [(d & 255) ** 2 & 255, (d & 255) ** 2 >> 8,
                          (d >> 8) * (d & 255), d >> 8]}[q]()
    pairs = [((x - 128).to(torch.int8), wp) for x in (k0, k1)]
    pairs.append(((miss - 128 if shift_m else miss).to(torch.int8), wp))
    pairs += [((x - 128).to(torch.int8), wq) for x in xq]
    return pairs


def profile_bgen_phase(dev, reps=10):
    """The seven profile_bgen variants and the other tile configurations
    of u8_unshift_q3: exactly equal to their plain versions on both plane
    layouts, on ragged shapes (every byte pair, about half of them
    missing), on an operand built by the port at a small N and at
    bgen_i8's full width (1% missing); there each is timed on both layouts
    beside bgen_i8 on the same inputs, its plain version, its bound and
    its library yardstick. Returns one row per kernel function of
    scripts/profile_bgen.py, each timed on the layout its mode reads."""
    import torch

    from regenie_tpu_torch.ops import fused_score as fsc
    from regenie_tpu_torch.ops import kernels as K
    from regenie_tpu_torch.scripts import profile_bgen

    rng = np.random.default_rng(15)
    gen = torch.Generator(device=dev)
    gen.manual_seed(15)
    cases = [(v, c) for v in K.PROFILE_BGEN_VARIANTS
             for c in range(len(K.PROFILE_BGEN_CONFIGS) if v == "u8_unshift_q3" else 1)]
    errs = {}

    def label(v, c):
        return f"{v} ({K.PROFILE_BGEN_CONFIGS[c]})" if v == "u8_unshift_q3" else v

    def layouts(planes):
        return {True: (planes[:, 0], planes[:, 1]),
                False: (planes[:, 0].contiguous(), planes[:, 1].contiguous())}

    def check(planes, wp, wq, what):
        lay = layouts(planes)
        for v in K.PROFILE_BGEN_VARIANTS:
            want = K.profile_bgen_products_plain(*lay[True], wp, wq, v)
            for vc, c in cases:
                if vc != v:
                    continue
                err = 0
                for k0, k1 in lay.values():
                    got = K.PROFILE_BGEN[v](k0, k1, wp, wq, config=c)
                    torch.cuda.synchronize()
                    err = max(err, max(int((g - w).abs().max())
                                       for g, w in zip(got, want)))
                print(f"  {label(v, c)} {what}: both layouts, max|kernel-plain|={err}")
                if err != 0:
                    raise AssertionError(f"profile_bgen {label(v, c)} differs from its "
                                         f"plain version ({what}): max abs {err}")
                errs[v] = max(errs.get(v, 0), err)

    # ragged: rows off the row tile, samples ending mid-stage, columns off
    # the column tile, every byte pair (about half of them missing)
    planes = torch.from_numpy(rng.integers(0, 256, (37, 2, 272), dtype=np.uint8)).to(dev)
    wp, wq = (torch.from_numpy(rng.integers(-128, 128, (272, c), dtype=np.int8)).to(dev)
              for c in (400, 144))
    check(planes, wp, wq, "ragged B=37 Np=272 Cw=400 Cq=144")
    c = _random_consts(rng, 1025, 3, 1, 4, dev, pack="sample")
    Np = fsc.op_nbp(c.Wp)
    check(_imputed_planes(gen, 37, 1025, Np, dev), c.Wp.limbs, c.Wq.limbs,
          "ragged, N=1025 operand")

    # full width: bgen_i8's shapes (Cw = 4 x 384, Cq = 4 x 128), random limbs
    f = FULL
    Np = -(-f["N"] // 256) * 256
    B, Cw, Cq = f["B"], 4 * 384, 4 * 128
    planes = _imputed_planes(gen, B, f["N"], Np, dev)
    wp, wq = (torch.randint(-128, 128, (Np, cw), generator=gen, device=dev,
                            dtype=torch.int8) for cw in (Cw, Cq))
    check(planes, wp, wq, "full width")
    wp_k, wq_k = wp.T.contiguous(), wq.T.contiguous()  # bgen_i8's layout
    lay = layouts(planes)
    times = {}
    for v, c in cases:
        for packed, (k0, k1) in lay.items():
            times[v, c, packed] = _time_ms(
                lambda: K.PROFILE_BGEN[v](k0, k1, wp, wq, config=c), reps)
        print(f"  {label(v, c)} full width: {times[v, c, True]:.3f} ms on [B, 2, Np], "
              f"{times[v, c, False]:.3f} ms on two [B, Np] (median of {reps})")
    i8_ms = _time_ms(lambda: K.bgen_i8_products(planes, wp_k, wq_k), reps)
    del wp_k, wq_k
    print(f"  bgen_i8 on the same planes: {i8_ms:.3f} ms")
    del lay

    rows = []
    work = {}
    for v, (_, q, _) in K.PROFILE_BGEN_VARIANTS.items():
        n_q = profile_bgen.N_Q[q]
        ops = 2.0 * B * Np * (3 * Cw + n_q * Cq)
        nbytes = 2 * B * Np + Np * (Cw + (Cq if n_q else 0)) + 8 * B * (3 * Cw + 3 * Cq)
        plain_ms = _time_ms(lambda: K.profile_bgen_products_plain(
            planes[:, 0], planes[:, 1], wp, wq, v), 3)
        pairs = _library_pairs(planes, wp, wq, v)
        library_ms = _time_ms(lambda: [torch._int_mm(a, w) for a, w in pairs], reps)
        del pairs
        work[v] = (ops, nbytes, plain_ms, library_ms)
    for func, v, _, packed, line in PROFILE_BGEN_ROWS:
        ops, nbytes, plain_ms, library_ms = work[v]
        ms = times[v, 0, packed]
        bound_ms, bound_by = _bound(ops, nbytes, PEAK_INT8_OPS)
        print(f"  {_profile_bgen_row(func, v)} full width: {ms:.3f} ms, plain "
              f"{plain_ms:.3f} ms, library {library_ms:.3f} ms (one torch._int_mm a dot, "
              f"time only), bound {bound_ms:.3f} ms ({bound_by}: "
              f"{ops:.3e} int8 ops, {nbytes / 1e9:.3f} GB) = {bound_ms / ms:.1%} of the bound")
        rows.append(dict(name=_profile_bgen_row(func, v), route="cuda",
                         source="regenie_tpu_torch/ops/csrc/profile_bgen.cu",
                         replaces=f"scripts/profile_bgen.py:{line}", launches=None,
                         max_abs_err=errs[v], ms=ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms))
    t = {v: times[v, 0, False] for v in K.PROFILE_BGEN_VARIANTS}
    base = t["u8_unshift_q3"]
    print(f"  attribution on two [B, Np] (u8_unshift_q3 {base:.3f} ms, bgen_i8 "
          f"{i8_ms:.3f} ms): q products ~ i32_shift_q3 - i32_shift_noq = "
          f"{t['i32_shift_q3'] - t['i32_shift_noq']:.3f} ms "
          f"({1 - t['i32_shift_noq'] / t['i32_shift_q3']:.1%}); i32 / u8 decode "
          f"{t['i32_shift_q3'] / t['u8_shift_q3']:.3f}; stacked / registers "
          f"{t['u8_unshift_q3_stacked'] / base:.3f}; e2 / q3 {t['u8_unshift_e2'] / base:.3f}; "
          f"dhl / q3 {t['u8_unshift_dhl'] / base:.3f}; configurations "
          + ", ".join(f"{times['u8_unshift_q3', c, False]:.3f}"
                      for c in range(len(K.PROFILE_BGEN_CONFIGS)))
          + f" ms; on {card_line()}")
    return rows


def profile_path_phase():
    """The port's profiling entry point in this process at the full UKB
    width (1 round of 2 blocks), with the launch counts set to 0 just
    before it and read just after: each variant's kernel launches once per
    call the script makes (a warm-up and one per block for each line, one
    more for prod, stacked and pipelined in the correctness lines) and no
    other kernel; the correctness lines within 2 x BF16_FLUSH x 2^-23 of
    the products against |W| (both sides within half that of the exact
    products). Returns the launches of the profile_fused kernels."""
    import torch

    from regenie_tpu_torch.ops import kernels as K
    from regenie_tpu_torch.scripts import profile_fused

    f = FULL
    rounds, blocks = 1, 2
    os.environ.pop("REGENIE_TPU_TORCH_DEVICE", None)
    _reset_counts()
    t0 = time.time()
    out = profile_fused.main(n=f["N"], p=f["P"], k=f["K"], b=f["B"], rounds=rounds,
                             blocks=blocks, sweep=False)
    torch.cuda.synchronize()
    counts = _read_counts()
    calls = 1 + rounds * blocks
    want = {name: 0 for name in counts}
    want.update(fused_bf16=calls + 1, profile_stacked=calls + 1,
                profile_stacked_2dots=calls, profile_nodecode=calls,
                profile_decode_only=calls,
                profile_pipelined=len(K.PROFILE_PIPELINED_CONFIGS) * calls + 1)
    print(f"  profile_fused.main at N={f['N']} B={f['B']}: {time.time() - t0:.1f}s, "
          f"launches {counts}")
    if counts != want:
        raise AssertionError(f"kernel launches {counts}, expected {want}")
    if not out["device"].startswith("cuda") or len(out["lines"]) != 5 + len(
            K.PROFILE_PIPELINED_CONFIGS):
        raise AssertionError(f"profile lines {out['lines']} on {out['device']}")
    if not all(math.isfinite(ln["ms"]) and ln["ms"] > 0 for ln in out["lines"]):
        raise AssertionError(f"profile times {out['lines']}")
    bar = 2 * K.BF16_FLUSH * 2.0**-23
    worst = max(rel for ch in out["checks"].values() for _, rel in ch.values())
    print(f"  correctness lines: largest |d| relative to the |W| products "
          f"{worst:.3e} (bar {bar:.3e})")
    if worst > bar:
        raise AssertionError(f"profile correctness lines {out['checks']} beyond {bar:g}")
    return {name: counts[name] for name in K.WRAPPERS
            if name.startswith("profile_") and not name.startswith("profile_bgen_")}


def profile_bgen_path_phase():
    """The port's BGEN profiling entry point in this process at the full
    UKB width (1 round of 2 blocks), in each of its four modes, with the
    launch counts set to 0 just before each run and read just after: each
    line's kernel (bgen_i8 for prod) launches 4 times (a warm-up, a call a
    block, its check) and no other kernel runs; every check line is 0 (the
    script raises otherwise). Returns the launches of each kernel function
    of scripts/profile_bgen.py in the run of the mode that times it."""
    import torch

    from regenie_tpu_torch.scripts import profile_bgen

    f = FULL
    rounds, blocks = 1, 2
    os.environ.pop("REGENIE_TPU_TORCH_DEVICE", None)
    launches = {}
    for mode in profile_bgen.MODES:
        _reset_counts()
        t0 = time.time()
        out = profile_bgen.main(mode, n=f["N"], p=f["P"], k=f["K"], b=f["B"],
                                rounds=rounds, blocks=blocks)
        torch.cuda.synchronize()
        counts = _read_counts()
        want = {name: 0 for name in counts}
        for _, variant, _ in profile_bgen.lines_of(mode):
            want["bgen_i8" if variant is None else f"profile_bgen_{variant}"] += \
                2 + rounds * blocks
        print(f"  profile_bgen.main({mode!r}) at N={f['N']} B={f['B']}: "
              f"{time.time() - t0:.1f}s, launches "
              f"{ {k: v for k, v in counts.items() if v} }")
        if counts != want:
            raise AssertionError(f"kernel launches {counts}, expected {want}")
        lines = out["lines"]
        if not out["device"].startswith("cuda") or len(lines) != len(
                profile_bgen.lines_of(mode)) or any(out["checks"].values()):
            raise AssertionError(f"profile_bgen {mode}: {out}")
        if not all(math.isfinite(ln["ms"]) and ln["ms"] > 0 for ln in lines):
            raise AssertionError(f"profile times {lines}")
        for func, variant, m, _, _ in PROFILE_BGEN_ROWS:
            if m == mode:
                launches[_profile_bgen_row(func, variant)] = \
                    counts[f"profile_bgen_{variant}"]
    return launches


def _assert_close(name, a, b, tol, what="kernel path - plain path"):
    """Same NaN pattern, max |a - b| over the finite entries <= tol."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if not np.array_equal(np.isnan(a), np.isnan(b)):
        raise AssertionError(f"{name}: NaN patterns differ")
    ok = ~np.isnan(a)
    err = float(np.max(np.abs(a[ok] - b[ok]), initial=0.0))
    print(f"  {name}: max |{what}| = {err:.3e} (bar {tol:g})")
    if err > tol:
        raise AssertionError(f"{name}: {err:.3e} > {tol:g}")
    return err


def _assert_rel(name, a, b, rtol, what="kernel path - plain path"):
    """Same NaN pattern, max |a - b| / |b| over the finite entries <= rtol."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if not np.array_equal(np.isnan(a), np.isnan(b)):
        raise AssertionError(f"{name}: NaN patterns differ")
    ok = ~np.isnan(a)
    err = float(np.max(np.abs(a[ok] - b[ok]) / np.maximum(np.abs(b[ok]), 1e-300),
                       initial=0.0))
    print(f"  {name}: max rel |{what}| = {err:.3e} (bar {rtol:g})")
    if err > rtol:
        raise AssertionError(f"{name}: {err:.3e} > {rtol:g}")


def _reset_counts():
    from regenie_tpu_torch.ops import kernels

    for w in kernels.WRAPPERS.values():
        w.launches = 0


def _read_counts():
    from regenie_tpu_torch.ops import kernels

    return {name: w.launches for name, w in kernels.WRAPPERS.items()}


@contextlib.contextmanager
def _i8_env(off):
    """REGENIE_TPU_I8=0 set inside the block when `off`, else unset."""
    os.environ.pop("REGENIE_TPU_I8", None)
    if off:
        os.environ["REGENIE_TPU_I8"] = "0"
    try:
        yield
    finally:
        os.environ.pop("REGENIE_TPU_I8", None)


MESH_DEVICES = "cuda:0,cuda:0"  # two shards of the one card

# held by either lane for its largest card allocations ([dense slice], the
# Step-1 slices' level 1 at a real depth): the two lanes share the card's
# 80 GB, and those phases' peaks do not fit together (Side sets it)
_CARD_LOCK = None


@contextlib.contextmanager
def _card_heavy(what):
    """Hold the lanes' card lock (when the side lane runs) inside the
    block; prints the wait when there was one."""
    if _CARD_LOCK is None:
        yield
        return
    t0 = time.time()
    # a lane that died holding the lock must not hang the other
    if not _CARD_LOCK.acquire(timeout=600):
        raise RuntimeError(f"{what}: the other lane held the card lock 600 s")
    try:
        if time.time() - t0 > 0.5:
            print(f"  ({what} waited {time.time() - t0:.1f}s for the other "
                  "lane's large card allocations)")
        yield
    finally:
        _CARD_LOCK.release()


@contextlib.contextmanager
def _mesh_env(devices=MESH_DEVICES):
    """REGENIE_TPU_MESH=1 and REGENIE_TPU_TORCH_MESH_DEVICES=devices set
    inside the block (the port's single-process mesh), unset after."""
    keys = ("REGENIE_TPU_MESH", "REGENIE_TPU_TORCH_MESH_DEVICES")
    os.environ.update(dict(zip(keys, ("1", devices))))
    try:
        yield
    finally:
        for k in keys:
            os.environ.pop(k, None)


def _mesh_launches(what, log_path, kern, shards=2):
    """A mesh run's kernel launches: `kern` once a shard of every block
    (the block count read from the run's log, every block fused) and no
    other kernel, the log naming the mesh. Returns (launches, blocks)."""
    log = open(log_path).read()
    nblk = int(re.search(r"block loop: (\d+) blocks", log).group(1))
    if f"multi-device mesh: {shards} shards" not in log:
        raise AssertionError(f"{what}: the log shows no mesh of {shards} shards")
    if f"dense route: 0 of {nblk} blocks" not in log:
        raise AssertionError(f"{what}: a block left the fused route")
    counts = _read_counts()
    want = {k: shards * nblk if k == kern else 0 for k in counts}
    if counts != want:
        raise AssertionError(f"{what}: launches {counts}, expected {want}")
    return counts[kern], nblk


def _identical_rows(fa, fb):
    """(rows that are not byte-identical, rows) of two output files."""
    la, lb = _read_text(fa).splitlines()[1:], _read_text(fb).splitlines()[1:]
    return sum(a != b for a, b in zip(la, lb)), len(la)


def _read_text(path):
    """A text file's contents, decompressed when it ends in .gz."""
    import gzip

    with (gzip.open(path, "rt") if path.endswith(".gz") else open(path)) as fh:
        return fh.read()


def _check_rows(path, M):
    """A split .regenie file (gzipped or not) is well formed: the header
    of the QT format, M rows of as many fields, CHROM, GENPOS and N
    integers, A1FREQ in [0, 1], every other number a float or NA."""
    rows = _read_text(path).splitlines()
    head = rows[0].split()
    if head[:6] != ["CHROM", "GENPOS", "ID", "ALLELE0", "ALLELE1", "A1FREQ"] \
            or head[-2:] != ["LOG10P", "EXTRA"]:
        raise AssertionError(f"{path}: header {rows[0]!r}")
    if len(rows) - 1 != M:
        raise AssertionError(f"{path} has {len(rows) - 1} rows, not {M}")
    iN, iT = head.index("N"), head.index("TEST")
    for r in rows[1:]:
        t = r.split()
        if len(t) != len(head):
            raise AssertionError(f"{path}: row {r!r}")
        int(t[0]), int(t[1]), int(t[iN])
        if not 0.0 <= float(t[5]) <= 1.0:
            raise AssertionError(f"{path}: A1FREQ of {r!r}")
        for x in t[6:iN] + t[iT + 1 : -1]:
            if x != "NA":
                float(x)


def _slice_run(argv, kernel, what, suffix=".regenie"):
    """One Step-2 run of a slice through the port's CLI (run_cli_kept) in
    this process, with the launch counts set to 0 just before it and
    read just after: `kernel` must launch once per block and no other
    kernel, and the P output files <out>_Y<p><suffix> (gzipped when the
    suffix ends in .gz) must be well formed. Prints the per-block lines
    and the run's times. Returns (the kernel's launches, the run's engine
    with its genotype source open, its params), so that the slice's block
    checks need no second run-up."""
    import torch

    f = FULL
    M = SLICE_BLOCKS * f["B"]
    out = argv[argv.index("--out") + 1]
    _reset_counts()
    t0 = time.time()
    params, eng, log = run_cli_kept(argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = _read_counts()

    n_blocks = math.ceil(M / f["B"])
    for p in range(f["P"]):
        _check_rows(f"{out}_Y{p + 1}{suffix}", M)
    print(f"  {what}: {f['P']} well-formed {suffix} files of {M} rows; "
          f"launches {counts} for {n_blocks} blocks")
    want = {name: n_blocks if name == kernel else 0 for name in counts}
    if counts != want:
        raise AssertionError(f"kernel launches {counts}, expected {want}")
    for ln in log:
        if ln.startswith("   -block"):
            print(f"  {ln.strip()}")
    loop = [ln.strip(" *") for ln in log if "block loop:" in ln][0]
    reads = [ln.strip(" *") for ln in log if "host block reads:" in ln][0]
    loop_s = float(loop.rsplit(" in ", 1)[1].rstrip("s"))
    print(f"  run wall time {wall:.2f}s = {M / wall:.1f} variants/s (run-up "
          f"and output included); {loop} = {M / loop_s:.1f} variants/s; "
          f"{reads}; on {card_line()}")
    return counts[kernel], eng, params


def _diff_record(what, logp, bhat, ref, inc):
    """Print, not check, the first block's gaps to the plain path."""
    for name, a, b in (("LOG10P", logp, ref.logp), ("BETA", bhat, ref.bhat)):
        d = np.abs(a - b)
        print(f"  first block {name}, {what}: max |diff| {np.nanmax(d):.3e} "
              f"(incomplete traits {np.nanmax(d[:, inc]):.3e}, complete "
              f"{np.nanmax(np.delete(d, inc, axis=1)):.3e}); not checked")


def _f32_sums_block(eng, raw, is_bgen):
    """(BETA, LOG10P) of a block with the products of the float32 operand
    summed in float32 (the plain products, TF32 off), folded and scored in
    float64: what the float64 sums of the fused_f32 / bgen_f32 kernels
    buy."""
    import torch

    from regenie_tpu_torch.ops import fused_score as fsc

    c = eng._fused_consts
    x = eng._fused_upload(raw)
    C = c.layout_C()
    if is_bgen:
        S1, SQ, SM, IL = (t.double() for t in fsc.bgen_fused_products_plain(
            x, c.Wp, torch.float32))
        S1, SQ, SM, _ = fsc._bgen_prepare(S1, SQ, SM, IL, c.usum[:C], C, False)
    else:
        S1, SQ, SM = (t.double() for t in fsc.fused_products_plain(x, c.Wp))
    flip = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
    st, den, sf = (t.cpu().numpy() for t in fsc.fused_epilogue(
        S1, SQ, SM, flip, c.usum, c.covt_res, c.Mmat, c.K, c.P,
        c.scale_denom, c.n_ind, 0, c.inc, eng.strict)[:3])
    bhat, _, _, logp = eng._qt_post(st, den, sf, np.zeros(x.shape[0], bool))
    return bhat, logp


def slice_phase(tmp, src, keep=False):
    """The port's Step-2 QT CLI at full width on the card, on a BED
    (src="bed") or a BGEN (src="bgen") file, by default (int8 kernel; the
    REGENIE_TPU_I8=0 CLI runs are in the cross-check), then the first
    block in memory on the int8, the float32 and the plain float64
    operands. Returns the launches of the int8 kernel in its CLI run; with
    keep=True also the open int8 engine, its blocks and its first block's
    result (the caller closes the engine)."""
    import torch

    from regenie_tpu_torch.io.geno import make_blocks
    from regenie_tpu_torch.ops import fused_score as fsc
    from regenie_tpu_torch.run_step2 import Step2Engine

    f = FULL
    M = SLICE_BLOCKS * f["B"]
    kernels = {"bed": ("fused_i8", "fused_f32"), "bgen": ("bgen_i8", "bgen_f32")}[src]
    if src == "bed":
        geno = ["--bed", f"{tmp}/geno"]
    else:
        geno = ["--bgen", f"{tmp}/geno.bgen", "--sample", f"{tmp}/geno.sample"]
    argv = ["--step", "2", *geno, "--phenoFile", f"{tmp}/pheno.txt",
            "--covarFile", f"{tmp}/covar.txt", "--ignore-pred",
            "--bsize", str(f["B"]), "--verbose", "--out"]
    os.environ.pop("REGENIE_TPU_TORCH_DEVICE", None)
    count, eng, params = _slice_run(argv + [f"{tmp}/slice_{kernels[0]}"],
                                    kernels[0], f"{kernels[0]} run")
    launches = {kernels[0]: count}

    # first block: each kernel path against the plain path, all on the card,
    # through the run's engine
    blocks = make_blocks(eng.gd, params.block_size)
    with _i8_env(True):
        eng32 = Step2Engine(params, eng.gd, eng.pd, eng.blup_files, eng.log,
                            eng.device)
    plain = Step2Engine(params, eng.gd, eng.pd, eng.blup_files, eng.log,
                        eng.device, kernel=False)
    if eng32.op_dtype != torch.float32:
        raise AssertionError("REGENIE_TPU_I8=0 did not select the float32 operand")
    chrom, bsnps = blocks[0]
    raw = eng.read_block_raw(bsnps)
    out = {}
    for name, e in (("int8", eng), ("float32", eng32), ("plain", plain)):
        e.prep_chrom(chrom)
        out[name] = e.test_raw_block_fused(raw, bsnps)[0]
    ref, inc = out["plain"], list(eng._fused_consts.inc)
    if src == "bed":
        # for the record, not checked: the int8 products folded and scored
        # in float32, as the JAX package does on a TPU (why the port uses
        # float64)
        c = eng._fused_consts
        c32 = c._replace(usum=c.usum.float(), covt_res=c.covt_res.float(),
                         Mmat=c.Mmat.float())
        st, den, sf = (x.double().cpu().numpy() for x in fsc.make_qt_block_fn(
            c32, True)(eng._fused_upload(raw))[:3])
        bhat32, _, _, logp32 = eng._qt_post(st, den, sf, np.zeros(len(bsnps), bool))
        _diff_record("int8 operand, float32 fold and epilogue", logp32, bhat32,
                     ref, inc)
    bhat32, logp32 = _f32_sums_block(eng32, raw, src == "bgen")
    _diff_record("float32 operand, products summed in float32", logp32, bhat32,
                 ref, inc)
    for name in ("int8", "float32"):
        _assert_close(f"first block LOG10P, {name} operand", out[name].logp,
                      ref.logp, LOG10P_TOL)
        _assert_close(f"first block BETA, {name} operand", out[name].bhat,
                      ref.bhat, BETA_TOL)
        if src == "bgen":
            # the mask and ind columns are exact in both operands (0/1), so
            # these are exact sums of integer products on every path
            _assert_rel(f"first block INFO, {name} operand", out[name].info_t,
                        ref.info_t, 1e-9)
            _assert_rel(f"first block A1FREQ, {name} operand", out[name].af_t,
                        ref.af_t, 1e-9)
    launches.update(split_path(eng, plain, chrom, raw, bsnps, ref))
    if keep:
        return launches, eng, blocks, out["int8"]
    eng.gd.close()
    return launches


def mesh_slice_phase(tmp):
    """[mesh slice] The port's Step-2 QT CLI at full width on the BED of
    [bed slice] on the single-process mesh: REGENIE_TPU_MESH=1 and two
    shards of the one card (REGENIE_TPU_TORCH_MESH_DEVICES=cuda:0,cuda:0),
    each block's rows split in two, fused_i8 launched once a shard on one
    shared operand and the rows gathered back in order. fused_i8 must
    launch twice a block and no other kernel; the P files must be well
    formed and hold [bed slice]'s unsharded files' text fields, with
    |dLOG10P| <= 1e-5 and |dBETA| <= 1e-6 and every other number (SE,
    CHISQ) within _compare_files' bars (the rows not byte-identical
    counted). Prints the CLI wall beside [bed slice]'s (its log's elapsed
    time). Returns fused_i8's launches."""
    import torch

    f = FULL
    M = SLICE_BLOCKS * f["B"]
    argv = ["--step", "2", "--bed", f"{tmp}/geno", "--phenoFile",
            f"{tmp}/pheno.txt", "--covarFile", f"{tmp}/covar.txt",
            "--ignore-pred", "--bsize", str(f["B"]), "--verbose", "--out",
            f"{tmp}/slice_mesh"]
    os.environ.pop("REGENIE_TPU_TORCH_DEVICE", None)
    _reset_counts()
    t0 = time.time()
    with _mesh_env():
        _, eng, log = run_cli_kept(argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    eng.gd.close()
    n, nblk = _mesh_launches("[mesh slice]", f"{tmp}/slice_mesh.log", "fused_i8")
    for ln in log:
        if ln.startswith("   -block") or "multi-device mesh" in ln:
            print(f"  {ln.strip()}")
    worst = {"LOG10P": 0.0, "BETA": 0.0}
    ndiff, excess = 0, 0.0
    for p in range(f["P"]):
        fm, fu = f"{tmp}/slice_mesh_Y{p + 1}.regenie", f"{tmp}/slice_fused_i8_Y{p + 1}.regenie"
        _check_rows(fm, M)
        # every field, SE and CHISQ too, at the cross-check's bars
        excess = max(excess, _compare_files(fm, fu))
        la, lb = _read_text(fm).splitlines(), _read_text(fu).splitlines()
        head = la[0].split()
        if la[0] != lb[0] or len(la) != len(lb):
            raise AssertionError(f"{fm}: header or rows differ from {fu}")
        cols = {k: head.index(k) for k in worst}
        for ra, rb in zip(la[1:], lb[1:]):
            if ra == rb:
                continue
            ndiff += 1
            ta, tb = ra.split(), rb.split()
            for i, (x, y) in enumerate(zip(ta, tb)):
                if x != y and i not in cols.values() and head[i] not in ("SE", "CHISQ"):
                    raise AssertionError(f"{head[i]} differs:\n{ra}\n{rb}")
            for k, i in cols.items():
                if ta[i] != tb[i]:
                    worst[k] = max(worst[k], abs(float(ta[i]) - float(tb[i])))
    if worst["LOG10P"] > LOG10P_TOL or worst["BETA"] > BETA_TOL:
        raise AssertionError(f"[mesh slice] against [bed slice]: {worst}")
    bed_wall = [ln for ln in open(f"{tmp}/slice_fused_i8.log")
                if ln.startswith("Elapsed time")][0].split(":")[1].strip()
    print(f"  fused_i8 {n} launches for {nblk} blocks on 2 shards ({n // 2} a shard), "
          "no other kernel; "
          f"{f['P']} files against [bed slice]'s: {ndiff} of {f['P'] * M} rows not "
          f"byte-identical, max |dLOG10P| {worst['LOG10P']:.3e}, max |dBETA| "
          f"{worst['BETA']:.3e}; every field within the cross-check's bars "
          f"(largest excess ratio {excess:.3f})")
    print(f"  CLI wall {wall:.2f}s ({M / wall:.1f} variants/s) beside [bed slice]'s "
          f"{bed_wall} (its log); on {card_line()}")
    return n, wall


# the smoke's entry for one process of a multi-process launch (mp_launch)
MP_CHILD = "--multiprocess-child"
# a kernel build directory for a launch's processes (mp_child): both build
# the kernels they launch into it at once
MP_BUILD_ENV = "CHIP_SMOKE_BUILD_DIR"


def mp_child(report, argv) -> int:
    """One process of a multi-process launch: the port's CLI on argv in
    this process (cli.main; the launch's environment names the
    coordinator, the process and its shards), the launch counts set to 0
    just before it and read just after. Writes {"counts", "wall" (the
    CLI's seconds), "t_end" (the host clock at its end), "built" (the
    libraries in MP_BUILD_ENV's directory, when set)} to the JSON file
    `report`; the CLI's own lines go to stdout."""
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from regenie_tpu_torch import cli
    from regenie_tpu_torch.ops import kernels

    build = os.environ.get(MP_BUILD_ENV)
    if build:
        kernels.BUILD_DIR = build
    _reset_counts()
    t0 = time.time()
    cli.main(argv)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    out = {"counts": _read_counts(), "wall": time.time() - t0, "t_end": time.time(),
           "built": sorted(os.listdir(build)) if build else None}
    with open(report, "w") as fh:
        json.dump(out, fh)
    return 0


def mp_launch(argv, what, nproc=2, devices="cuda:0", env=None, timeout=600):
    """argv through the port's CLI as nproc processes of one launch
    (REGENIE_TPU_COORDINATOR=127.0.0.1:<a free port>, each process with
    the shards `devices`), started together through this file's child
    entry (mp_child). Returns each process's report with its "stdout"
    and "proc_wall" (its seconds from the launch to the end of its CLI),
    in process order. Raises when a process fails, and stops every
    process it started."""
    import socket

    sk = socket.socket()
    sk.bind(("127.0.0.1", 0))
    port = sk.getsockname()[1]
    sk.close()
    rdir = tempfile.mkdtemp(prefix="chip_smoke_mp_")
    procs = []
    t0 = time.time()
    try:
        for pid in range(nproc):
            e = dict(os.environ)
            e.pop("REGENIE_TPU_TORCH_DEVICE", None)
            e.update({"REGENIE_TPU_MESH": "1", "REGENIE_TPU_TORCH_MESH_DEVICES": devices,
                      "REGENIE_TPU_COORDINATOR": f"127.0.0.1:{port}",
                      "REGENIE_TPU_NUM_PROCESSES": str(nproc),
                      "REGENIE_TPU_PROCESS_ID": str(pid),
                      "REGENIE_TPU_DIST_TIMEOUT": "300", **(env or {})})
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), MP_CHILD,
                 f"{rdir}/{pid}.json", *argv], env=e, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
        outs = [p.communicate(timeout=timeout) for p in procs]
        for pid, (p, (o, err)) in enumerate(zip(procs, outs)):
            if p.returncode != 0:
                raise RuntimeError(f"{what}: process {pid} of the launch exited "
                                   f"{p.returncode}:\n{o[-3000:]}\n{err[-6000:]}")
        reports = []
        for pid, (o, _) in enumerate(outs):
            with open(f"{rdir}/{pid}.json") as fh:
                r = json.load(fh)
            r.update(stdout=o, proc_wall=r["t_end"] - t0)
            reports.append(r)
        return reports
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(rdir, ignore_errors=True)


def _mp_checks(what, reps, kern, nblk, log_path, lines=()):
    """A launch's common checks: every process launched `kern` once a
    block (None: no kernel), process 0's log holds the distributed line
    and `lines`, process 1 printed nothing. Returns the launches a
    process."""
    for pid, r in enumerate(reps):
        want = {k: nblk if k == kern else 0 for k in r["counts"]}
        if r["counts"] != want:
            raise AssertionError(f"{what}: process {pid} launched {r['counts']}, "
                                 f"expected {want}")
    log = open(log_path).read()
    for ln in ("distributed: process 0 of 2",) + tuple(lines):
        if ln not in log:
            raise AssertionError(f"{what}: the output host's log lacks {ln!r}")
    if reps[1]["stdout"]:
        raise AssertionError(f"{what}: process 1 printed {reps[1]['stdout'][:300]!r}")
    return [r["counts"].get(kern, 0) if kern else 0 for r in reps]


def _same_names(what, prefix, ref):
    """The files of a run (<prefix>*) are named as the reference run's."""
    names = lambda pre: sorted(f[len(pre):] for f in glob.glob(pre + "*"))  # noqa: E731
    if names(prefix) != names(ref):
        raise AssertionError(f"{what}: files {names(prefix)} against the single "
                             f"process's {names(ref)}")


def multiprocess_slice_launch(tmp):
    """[multiprocess slice]'s launch: the port's Step-2 QT CLI at full
    width on the BED of [bed slice] as two processes of one launch on the
    one card (each REGENIE_TPU_TORCH_MESH_DEVICES=cuda:0: a global mesh of
    2 shards, gloo between the processes), under the lanes' card lock.
    Returns mp_launch's reports; multiprocess_slice_phase checks them."""
    f = FULL
    argv = ["--step", "2", "--bed", f"{tmp}/geno", "--phenoFile",
            f"{tmp}/pheno.txt", "--covarFile", f"{tmp}/covar.txt",
            "--ignore-pred", "--bsize", str(f["B"]), "--verbose", "--out",
            f"{tmp}/slice_mp"]
    with _card_heavy("[multiprocess slice]"):
        return mp_launch(argv, "[multiprocess slice]")


def multiprocess_slice_phase(tmp, mesh_wall, reps):
    """[multiprocess slice] The checks of multiprocess_slice_launch's
    run (reps, its reports): each process read only its own rows of each
    block and launched fused_i8 once a block and no other kernel; the
    output host's log shows the distributed and the per-host decode
    lines; the run's files are the output host's log and 50 files, and
    process 1 printed nothing; the 50 files hold [mesh slice]'s within
    _compare_files' bars (|dLOG10P| <= 1e-5), the rows not byte-identical
    counted. Prints both processes' walls beside [mesh slice]'s. Returns
    fused_i8's launches a process."""
    f = FULL
    M = SLICE_BLOCKS * f["B"]
    got = {os.path.basename(x) for x in glob.glob(f"{tmp}/slice_mp*")}
    want = {"slice_mp.log"} | {f"slice_mp_Y{p + 1}.regenie" for p in range(f["P"])}
    if got != want:
        raise AssertionError(f"[multiprocess slice]: files {sorted(got - want)} "
                             f"written, {sorted(want - got)} missing")
    log = open(f"{tmp}/slice_mp.log").read()
    nblk = int(re.search(r"block loop: (\d+) blocks", log).group(1))
    n = _mp_checks("[multiprocess slice]", reps, "fused_i8", nblk, f"{tmp}/slice_mp.log",
                   ("multi-device mesh: 2 shards on 2 processes",
                    "per-host decode: each of 2 processes reads only its own variant",
                    f"dense route: 0 of {nblk} blocks"))
    for ln in log.splitlines():
        if ln.startswith("   -block") or "distributed:" in ln or "per-host" in ln:
            print(f"  {ln.strip()}")
    worst, ndiff, lp = 0.0, 0, 0.0
    for p in range(f["P"]):
        fm, fr = f"{tmp}/slice_mp_Y{p + 1}.regenie", f"{tmp}/slice_mesh_Y{p + 1}.regenie"
        _check_rows(fm, M)
        worst = max(worst, _compare_files(fm, fr))
        ndiff += _identical_rows(fm, fr)[0]
        la, lb = _read_text(fm).splitlines(), _read_text(fr).splitlines()
        i = la[0].split().index("LOG10P")
        lp = max([lp] + [abs(float(a.split()[i]) - float(b.split()[i]))
                         for a, b in zip(la[1:], lb[1:])
                         if a.split()[i] != b.split()[i]])
    print(f"  fused_i8 {n} launches a process for {nblk} blocks, no other kernel; "
          f"process 1 wrote no file and printed nothing; {f['P']} files against "
          f"[mesh slice]'s: {ndiff} of {f['P'] * M} rows not byte-identical, max "
          f"|dLOG10P| {lp:.3e}, every field within the cross-check's bars (largest "
          f"share {worst:.3f})")
    print(f"  CLI wall {reps[0]['wall']:.2f}s (process 0), {reps[1]['wall']:.2f}s "
          f"(process 1); from the launch {reps[0]['proc_wall']:.2f}s and "
          f"{reps[1]['proc_wall']:.2f}s (both started at once, start-up included; "
          f"beside [bt slice]), [mesh slice]'s CLI wall {mesh_wall:.2f}s (alone); "
          f"on {card_line()}")
    return n[0]


BT_FLAGS = ["--bt", "--firth", "--approx", "--af-cc"]


def _bt_twins(eng, x, outs, rows_cap=4, traits=1):
    """The card's corrections (models/corrections_device.py) against the
    host twins (models/firth.py, models/spa.py) on block 1's rows past the
    threshold, for the first `traits` traits with such rows (at most
    `rows_cap` rows each): the same converged / failed flags, Firth
    within rtol 1e-6 and SPA within rtol 1e-5 (the JAX package's own bars
    for its device twins). Prints the card's and the host's times."""
    import torch

    from regenie_tpu_torch.models import corrections_device as cdev
    from regenie_tpu_torch.models import firth as firth_mod
    from regenie_tpu_torch.models import spa as spa_mod
    from regenie_tpu_torch.models import step2_bt
    from regenie_tpu_torch.run_step2 import FusedRowSource

    _, _, _, flip, num, den, S1cat = outs
    st, pd, params = eng.null_state, eng.pd, eng.params
    fc = step2_bt.fused_consts(pd, st)
    z = math.sqrt(step2_bt.chisq_thr(params.alpha_pvalue))
    src = FusedRowSource(eng, x, flip, num, den, S1cat)
    stats = (num / torch.sqrt(torch.clamp(den, min=0))).cpu().numpy()
    done = 0
    for ph in fc.cols:
        j = fc.j_of[ph]
        idx = np.flatnonzero(np.abs(stats[:, j]) > z)[:rows_cap]
        if not len(idx):
            continue
        dc = step2_bt.dev_consts(st, pd, ph, x.device)
        it = torch.as_tensor(idx, device=x.device)
        K = st.X_gamma[ph].shape[1]
        G = step2_bt._gres_rows(src.rows_device(it), dc["gsm"], dc["XW"],
                                S1cat[it, j, :K])
        Gh = G.cpu().numpy()
        mask, gs = pd.masked_indivs[:, ph], st.gamma_sqrt[:, ph]
        t0 = time.time()
        fd = cdev.firth_snp_batch_dev(dc["y"], G / dc["gamma_sqrt"][None, :],
                                      dc["firth_offset"], dc["mask"],
                                      maxstep=params.maxstep,
                                      niter=params.niter_max_firth, tol=2.5e-4)
        sd = cdev.spa_batch_dev(stats[idx, j], den[it, j].cpu().numpy(), G,
                                dc["Y_hat"], dc["gamma_sqrt"], dc["mask"],
                                tol=params.tol_spa, niter_max=params.niter_max_spa)
        t_card = time.time() - t0
        t0 = time.time()
        fh = firth_mod.firth_snp_batch(pd.phenotypes_raw[:, ph], Gh / gs[None, :],
                                       st.firth_offset[:, ph], mask,
                                       maxstep=params.maxstep,
                                       niter=params.niter_max_firth, tol=2.5e-4)
        sh = spa_mod.spa_batch(stats[idx, j], den[it, j].cpu().numpy(), Gh,
                               st.Y_hat[:, ph], gs, mask, tol=params.tol_spa,
                               niter_max=params.niter_max_spa)
        t_host = time.time() - t0
        if not (np.array_equal(fd[3], fh[3]) and np.array_equal(sd[2], sh[2])):
            raise AssertionError(f"trait {ph + 1}: the card's correction flags "
                                 "differ from the host twins'")
        ok, oks = fd[3], ~sd[2]
        ferr = max(float(np.max(np.abs(a[ok] - b[ok]) / np.maximum(np.abs(b[ok]), 1e-12),
                                initial=0.0)) for a, b in zip(fd[:3], fh[:3]))
        serr = float(np.max(np.abs(sd[1][oks] - sh[1][oks])
                            / np.maximum(np.abs(sh[1][oks]), 1e-12), initial=0.0))
        print(f"  corrections, trait Y{ph + 1}, {len(idx)} rows: card against host "
              f"twins, Firth flags equal ({int(ok.sum())} converged), max rel "
              f"{ferr:.3e} (bar 1e-6); SPA flags equal ({int(oks.sum())} passed), "
              f"LOG10P max rel {serr:.3e} (bar 1e-5); card {t_card:.2f}s, host "
              f"{t_host:.2f}s")
        if ferr > 1e-6 or serr > 1e-5:
            raise AssertionError("the card's corrections miss the host twins' bars")
        done += 1
        if done == traits:
            break
    if not done:
        raise AssertionError("block 1 has no row past the correction threshold")


def _exact_firth_check(eng, x, outs, traits=2, rows_min=64, host_rows=2):
    """Exact Firth on the card (step2_bt.exact_firth_dev: the batched
    float64 solver of corrections_device, in groups sized to the free
    memory) on block 1's rows past the threshold of the first `traits`
    traits with such rows (at least `rows_min` rows together), timed per
    row; then `host_rows` rows of each trait through the host twin
    (step2_bt._exact_firth_snp, numpy float64): the same convergence
    flags, LRT within rel 1e-8 and |dLOG10P| within 1e-5."""
    import torch

    from regenie_tpu_torch.models import step2_bt
    from regenie_tpu_torch.run_step2 import FusedRowSource
    from regenie_tpu_torch.utils.stats import chisq_neglog10

    _, _, _, flip, num, den, S1cat = outs
    st, pd, params = eng.null_state, eng.pd, eng.params
    fc = step2_bt.fused_consts(pd, st)
    z = math.sqrt(step2_bt.chisq_thr(params.alpha_pvalue))
    src = FusedRowSource(eng, x, flip, num, den, S1cat)
    stats = (num / torch.sqrt(torch.clamp(den, min=0))).cpu().numpy()
    picked = [(ph, np.flatnonzero(np.abs(stats[:, fc.j_of[ph]]) > z)) for ph in fc.cols]
    picked = [(ph, idx) for ph, idx in picked if len(idx)][:traits]
    n_rows = sum(len(idx) for _, idx in picked)
    if len(picked) < traits or n_rows < rows_min:
        raise AssertionError(f"block 1 has {n_rows} rows past the threshold in "
                             f"{len(picked)} traits; the exact-Firth check needs "
                             f"{rows_min} in {traits}")
    for ph, idx in picked:
        G = src.rows_device(torch.as_tensor(idx, device=x.device))
        _sync(x.device)
        t0 = time.time()
        ok, beta, se, lrt = step2_bt.exact_firth_dev(params, pd, st, ph, G)
        t_card = time.time() - t0
        y = pd.phenotypes_raw[:, ph]
        mask = pd.masked_indivs[:, ph]
        offset = st.blups[:, ph] * mask
        Gh = G[:host_rows].cpu().numpy()
        t0 = time.time()
        host = [step2_bt._exact_firth_snp(params, pd, y, Gh[i], offset, mask, st, ph)
                for i in range(host_rows)]
        t_host = time.time() - t0
        hok = np.array([h[0] for h in host])
        if not np.array_equal(hok, ok[:host_rows]):
            raise AssertionError(f"trait Y{ph + 1}: exact Firth flags differ between "
                                 "the card and the host twin")
        hl = np.array([h[3] for h in host])[hok]
        cl = lrt[:host_rows][hok]
        rel = float(np.max(np.abs(cl - hl) / np.maximum(np.abs(hl), 1e-300),
                           initial=0.0))
        dlp = float(np.max(np.abs(chisq_neglog10(cl) - chisq_neglog10(hl)), initial=0.0))
        print(f"  exact Firth, trait Y{ph + 1}: {len(idx)} rows on the card in "
              f"{t_card:.2f}s ({1e3 * t_card / len(idx):.1f} ms a row; "
              f"{int(ok.sum())} converged); host twin {host_rows} rows in "
              f"{t_host:.2f}s ({t_host / host_rows:.2f}s a row): flags equal, LRT "
              f"max rel {rel:.3e} (bar 1e-8), |dLOG10P| {dlp:.3e} (bar 1e-5)")
        if rel > 1e-8 or dlp > LOG10P_TOL:
            raise AssertionError("the card's exact Firth misses the host twin's bars")


def bt_slice_phase(tmp):
    """The port's Step-2 BT run at full width on the card, on the [bed
    slice]'s BED (same directory): a binary-trait table (the BED writer's
    traits thresholded), one run of the CLI with
    --bt --firth --approx --af-cc, where fused_i8 must launch once per
    block and no other kernel, its 50 files well formed; then on block 1,
    through the same engine: the int8 products against the float64 plain
    products, the LOG10P of every trait against the plain route within
    1e-5 outside the threshold rows (a statistic on the other side of the
    correction threshold on the two routes; counted and printed), the
    card's corrections against the host twins, and SPA. Returns the
    launches of fused_i8 in the run."""
    import torch

    from regenie_tpu_torch.io.geno import make_blocks
    from regenie_tpu_torch.models import step2_bt
    from regenie_tpu_torch.run_step2 import Step2Engine

    f = FULL
    M = SLICE_BLOCKS * f["B"]
    note = _read_note(f"{tmp}/pheno_bt.txt")
    print(f"  BT table N={f['N']} P={f['P']} (prevalence 5-30%, covariates "
          f"10% of the liability, {note['cases']} cases) written in the "
          f"background in {note['seconds']:.1f}s")
    out = f"{tmp}/bt"
    argv = ["--step", "2", "--bed", f"{tmp}/geno", "--phenoFile",
            f"{tmp}/pheno_bt.txt", "--covarFile", f"{tmp}/covar.txt",
            "--ignore-pred", "--bsize", str(f["B"]), *BT_FLAGS, "--verbose",
            "--out", out]
    os.environ.pop("REGENIE_TPU_TORCH_DEVICE", None)
    _reset_counts()
    t0 = time.time()
    params, eng, lines = run_cli_kept(argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = _read_counts()
    for p in range(f["P"]):
        _check_rows(f"{out}_Y{p + 1}.regenie", M)
    want = {name: SLICE_BLOCKS if name == "fused_i8" else 0 for name in counts}
    print(f"  BT run: {f['P']} well-formed .regenie files of {M} rows; launches "
          f"{counts}")
    if counts != want:
        raise AssertionError(f"kernel launches {counts}, expected {want}")
    for ln in lines:
        if (ln.startswith("   -block") or "correction :" in ln or "failed tests" in ln
                or "null model fits" in ln or "block loop" in ln):
            print(f"  {ln.strip()}")
    loop = [ln.strip(" *") for ln in lines if "block loop:" in ln][0]
    loop_s = float(loop.rsplit(" in ", 1)[1].rstrip("s"))
    print(f"  BT wall time {wall:.2f}s = {M / wall:.1f} variants/s (run-up, null "
          f"fits and output included); block loop {M / loop_s:.1f} variants/s; "
          f"on {card_line()}")

    # block 1 again, in memory, through the run's engine (its null fits and
    # its int8 operand) and a plain engine on the same null fits
    chrom, bsnps = make_blocks(eng.gd, params.block_size)[0]
    raw = eng.read_block_raw(bsnps)
    eng._fused_chrom = None
    t0 = time.time()
    eng._ensure_fused_consts()
    torch.cuda.synchronize()
    t_op = time.time() - t0
    fb = eng._fused_bt
    plain = Step2Engine(params, eng.gd, eng.pd, None, eng.log, eng.device,
                        kernel=False)
    plain.cur_chrom, plain.null_state, plain.res = chrom, eng.null_state, eng.res
    t0 = time.time()
    plain._ensure_fused_consts()
    torch.cuda.synchronize()
    print(f"  BT operand at block 1 (Wext {fb.C_used} columns, Cp "
          f"{-(-fb.C_used // 128) * 128}): int8, quantized on the card, "
          f"{t_op:.2f}s; float64 plain operand {time.time() - t0:.2f}s")
    x = eng._fused_upload(raw)
    o8 = eng._fused_fn(x)
    op = plain._fused_fn(plain._fused_upload(raw))
    if not torch.equal(o8[3], op[3]):
        raise AssertionError("int8 and plain routes flip different variants")
    # the int8 products against the float64 plain ones, through num and
    # denum (the score's cancelling difference num = q - A xwt)
    for name, a, b in (("S1", o8[0], op[0]), ("num", o8[4], op[4]),
                       ("denum", o8[5], op[5])):
        d = float((a - b).abs().max())
        print(f"  block 1 {name}: max |int8 - plain| {d:.3e} "
              f"(max |plain| {float(b.abs().max()):.3e})")
    z = math.sqrt(step2_bt.chisq_thr(params.alpha_pvalue))
    s8 = (o8[4] / torch.sqrt(torch.clamp(o8[5], min=0))).cpu().numpy()
    sp = (op[4] / torch.sqrt(torch.clamp(op[5], min=0))).cpu().numpy()
    print(f"  block 1 score statistics: max |int8 - plain| "
          f"{np.nanmax(np.abs(s8 - sp)):.3e}")
    # the block scored on both routes with SPA (the run's own Firth rows
    # cost ~10x more on the card; both routes correct the same rows either
    # way)
    params.firth, params.use_spa = False, True
    n0, f0, c0 = eng.n_corrected, eng.n_failed, eng.bt_times["corr_s"]
    r8 = eng.test_raw_block_fused(raw, bsnps)[0]
    print(f"  block 1 with SPA: {eng.n_corrected - n0} corrected, "
          f"{eng.n_failed - f0} failed, {eng.bt_times['corr_s'] - c0:.2f}s")
    rp = plain.test_raw_block_fused(raw, bsnps)[0]
    params.firth, params.use_spa = True, False
    cols = step2_bt.fused_consts(eng.pd, eng.null_state).cols
    valid = ~(r8.ignored[:, None] | r8.ignored_trait)
    cross = np.zeros_like(valid)
    cross[:, cols] = (np.abs(s8) > z) != (np.abs(sp) > z)
    cross &= valid
    print(f"  block 1 threshold rows (|stat| on the two sides of {z:.4f} on the "
          f"int8 and plain routes): {int(cross.sum())}")
    for b, ph in zip(*np.nonzero(cross)):
        j = cols.index(ph)
        print(f"    variant {bsnps[b].ID} trait Y{ph + 1}: stat int8 "
              f"{s8[b, j]:.9f}, plain {sp[b, j]:.9f}; LOG10P {r8.logp[b, ph]:.6g} "
              f"and {rp.logp[b, ph]:.6g}")
    keep = valid & ~cross
    _assert_close("block 1 BT LOG10P outside the threshold rows, int8 operand",
                  np.where(keep, r8.logp, np.nan), np.where(keep, rp.logp, np.nan),
                  LOG10P_TOL)
    d = np.abs(r8.bhat - rp.bhat)[keep]
    print(f"  block 1 BT BETA: max |int8 - plain| {np.nanmax(d):.3e} (not checked); "
          f"TEST_FAIL rows {int((r8.test_fail & keep).sum())} and "
          f"{int((rp.test_fail & keep).sum())}")
    _bt_twins(eng, x, o8)
    _exact_firth_check(eng, x, o8)
    eng.gd.close()
    return counts["fused_i8"]


# LD mode at full width ([ld slice]): M variants of the BED slice's file,
# every other one (--extract), at N = 400,000 and K = 20
LD_M = 2048
LD_TIE, LD_BAR = 1e-6, 1e-10  # r^2 * 65535 + 0.5 this near an integer; |dcorr|


def _ld_versus_cpu(params, pd, ld, what):
    """The card's LD run (eng.ld of run_ldcomp) against the same raw block
    through the same functions on the CPU in float64: the correlations
    within LD_BAR before quantization, and a binary code may differ by 1
    only where the CPU's r^2 * 65535 + 0.5 lies within LD_TIE of an
    integer. Returns (max |dcorr|, codes that differ, CPU seconds)."""
    import torch

    from regenie_tpu_torch.run_step2 import ld_gram, ld_r2_codes, ld_scale

    t0 = time.time()
    LD_cpu = ld_scale(params, ld_gram(
        ld.src.cpu(), ld.rows, ld.vecs, len(ld.names),
        torch.as_tensor(pd.ind_in_analysis), torch.as_tensor(pd.new_cov)).numpy())
    secs = time.time() - t0
    gap = float(np.abs(ld.LD - LD_cpu).max()) if LD_cpu.size else 0.0
    if not gap <= LD_BAR:
        raise AssertionError(f"{what}: LD card vs CPU {gap:.3e} > {LD_BAR:g}")
    ca, cb = ld_r2_codes(ld.LD).astype(np.int64), ld_r2_codes(LD_cpu).astype(np.int64)
    off = ca != cb
    v = LD_cpu[np.triu_indices(LD_cpu.shape[0], k=1)] ** 2 * 65535 + 0.5
    if (np.abs(ca - cb) > 1).any() or (np.abs(v[off] - np.round(v[off])) > LD_TIE).any():
        raise AssertionError(f"{what}: binary codes differ away from a rounding tie")
    return gap, int(off.sum()), secs


def ld_slice_phase(tmp):
    """The port's LD mode at full width on the card, on the [bed slice]'s
    BED: LD_M of its variants (every other one, --extract), the default
    binary output, through the CLI (run_cli_kept). No kernel may launch;
    the .corr file and snplist are checked; the times printed. Returns
    the check of the card's matrix against the CPU's on the same raw
    block (_ld_versus_cpu), a function that returns its printed line (the
    raw block moved to the host), so that it can run beside the next
    phase."""
    import torch

    f = FULL
    with open(f"{tmp}/ld_extract.txt", "w") as fh:
        fh.write("".join(f"v{i}\n" for i in range(0, 2 * LD_M, 2)))
    out = f"{tmp}/ld"
    argv = ["--step", "2", "--bed", f"{tmp}/geno", "--phenoFile", f"{tmp}/pheno.txt",
            "--covarFile", f"{tmp}/covar.txt", "--ignore-pred", "--compute-corr",
            "--extract", f"{tmp}/ld_extract.txt", "--out", out]
    os.environ.pop("REGENIE_TPU_TORCH_DEVICE", None)
    _reset_counts()
    t0 = time.time()
    params, eng, lines = run_cli_kept(argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = _read_counts()
    if any(counts.values()):
        raise AssertionError(f"LD mode launched kernels: {counts}")
    ld = eng.ld
    M, N = len(ld.names), params.n_samples
    names = open(f"{out}.corr.snplist").read().split()
    if M != LD_M or names != [f"v{i}" for i in range(0, 2 * LD_M, 2)]:
        raise AssertionError(f"{out}.corr.snplist: {len(names)} names, not {LD_M}")
    raw = open(f"{out}.corr", "rb").read()
    head = np.frombuffer(raw[:8], np.int32)
    from regenie_tpu_torch.run_step2 import ld_r2_codes

    if (list(head) != [N, M] or len(raw) != 8 + M * (M - 1)
            or raw[8:] != ld_r2_codes(ld.LD).tobytes()):
        raise AssertionError(f"{out}.corr: header {list(head)} or codes wrong")
    if not (np.isfinite(ld.LD).all() and np.allclose(np.diag(ld.LD), 1.0)
            and np.abs(ld.LD).max() <= 1.0 + 1e-12):
        raise AssertionError("LD matrix: not a correlation matrix")
    ms = ld.card_ms
    bound, by = _bound(2.0 * M * M * N, M * N * 8 + M * M * 8, PEAK_FP64_TC_OPS)
    steps = ld.read_s + ld.upload_s + sum(ms.values()) / 1e3 + ld.write_s
    for ln in lines:
        if "LD matrix (" in ln:
            print(f"  {ln.strip(' *')}")
    card = card_line()
    for text in (
            f"CLI wall {wall:.2f}s for M = {M}, N = {N}, K = {f['K']} "
            f"({M * (M - 1) // 2 / wall:.0f} pairs/s), run-up {wall - steps:.2f}s",
            f"host read {ld.read_s:.3f}s (packed bytes of {M} variants)",
            f"upload {ld.upload_s:.3f}s (decoded to int8 on the card)",
            f"card imputation {ms['impute']:.3f} ms, projection {ms['project']:.3f} "
            f"ms, G'G {ms['gram']:.3f} ms against its {bound:.3f} ms bound by {by} "
            f"({bound / ms['gram'] * 100:.1f}%) (CUDA events)",
            f"host scaling and write {ld.write_s:.3f}s"):
        print(f"  LD {text}; on {card}")
    print("  LD mode: no kernel launched")
    ld.src = ld.src.cpu()
    pd = eng.pd
    del eng.ld
    eng.gd.close()

    def cpu_check(threads=None):
        import torch

        before = torch.get_num_threads()
        torch.set_num_threads(threads or before)
        try:
            gap, n_off, secs = _ld_versus_cpu(params, pd, ld, "[ld slice]")
        finally:
            torch.set_num_threads(before)
        return (f"  LD card vs CPU (the same int8 codes, float64, the CPU {secs:.1f}s"
                f"): max |dcorr| {gap:.3e} (bar {LD_BAR:g}); {n_off} of "
                f"{M * (M - 1) // 2} binary codes differ by 1, each at a rounding tie")
    return cpu_check


def _ld_files_close(a_prefix, b_prefix, argv):
    """Card and CPU LD files: the snplists the same bytes; text .corr
    numbers within 1e-9 relative (|dcorr| <= LD_BAR holds in memory)."""
    for ext in (".corr.snplist", ".corr.forcedIn.snplist"):
        a, b = (os.path.exists(x + ext) for x in (a_prefix, b_prefix))
        if a != b or (a and open(a_prefix + ext).read() != open(b_prefix + ext).read()):
            raise AssertionError(f"{ext} differs card vs CPU")
    if "--output-corr-text" in argv or "--skip-scaleG" in argv:
        la = open(a_prefix + ".corr").read().split()
        lb = open(b_prefix + ".corr").read().split()
        if len(la) != len(lb):
            raise AssertionError(".corr: token count differs card vs CPU")
        for x, y in zip(la, lb):
            if x != y and abs(float(x) - float(y)) > 1e-9 * max(1.0, abs(float(x))):
                raise AssertionError(f".corr: {x} against {y}")


def modes_cross_check(tmp, prefix, P):
    """The whole-run modes at N = 2,000 on the card and on the CPU, with
    --remove: --mcc --mcc-skew on a table of skewed traits, --mt, --multiphen
    (default and cov_score), and LD mode (--output-corr-text; --skip-scaleG
    --sparse-thr; --ld-extract on the gene-based run's BED and files, with
    variant and mask rows and names the data lacks). No kernel may launch
    on the card; every .regenie field within its bar (_compare_files), the
    LD matrices within LD_BAR and their codes as _ld_versus_cpu holds them."""
    rows = [ln.split() for ln in open(f"{tmp}/pheno.txt").read().splitlines()]
    with open(f"{tmp}/pheno_skew.txt", "w") as fh:
        fh.write(" ".join(rows[0]) + "\n")
        for t in rows[1:]:
            t = list(t)
            if t[2] != "NA":
                t[2] = f"{math.exp(float(t[2]) * 3):.6f}"
            if t[3] != "NA":
                t[3] = f"{float(t[3]) ** 3 * 100:.6f}"
            fh.write(" ".join(t) + "\n")
    g = os.path.join(tmp, "gene")
    with open(f"{g}/ldlist.txt", "w") as fh:
        fh.write("sv v5\nmask G0.M3.0.5 G0\nsv vABSENT\nmask G1.M2.0.05 G1\n"
                 "mask G2.M1.singleton G2\nsv v130\nmask G3.M9.0.5 G3\n"
                 "mask G10.M3.0.5 G10\nsv v200\n")
    split = [f"_Y{p + 1}.regenie" for p in range(P)]
    gene = ["--set-list", f"{g}/sets.txt", "--anno-file", f"{g}/anno.txt",
            "--mask-def", f"{g}/masks.txt", "--aaf-bins", "0.05,0.5"]
    runs = {
        "--mcc --mcc-skew 0.5 (Y1, Y2 skewed)": (tmp, "pheno_skew.txt", [
            "--bed", prefix, "--mcc", "--mcc-skew", "0.5"], split),
        "--mt --strict --no-split": (tmp, "pheno.txt", [
            "--bed", prefix, "--mt", "--strict", "--no-split"], [".regenie"]),
        "--multiphen --strict": (tmp, "pheno.txt", [
            "--bed", prefix, "--multiphen", "--strict"], [".regenie"]),
        # cov_score's per-SNP covariate fits cost ~20 ms a variant on the
        # host: chromosome 2 alone (200 variants)
        "--multiphen --strict --multiphen-test cov_score --chr 2": (tmp, "pheno.txt", [
            "--bed", prefix, "--multiphen", "--strict", "--multiphen-test",
            "cov_score", "--chr", "2"], [".regenie"]),
        "--compute-corr --output-corr-text": (tmp, "pheno.txt", [
            "--bed", prefix, "--compute-corr", "--output-corr-text"], None),
        "--compute-corr --skip-scaleG --sparse-thr 0.2": (tmp, "pheno.txt", [
            "--bed", prefix, "--compute-corr", "--skip-scaleG", "--sparse-thr",
            "0.2"], None),
        "--compute-corr --ld-extract (variants, masks, absent names)": (
            g, "pheno.txt", ["--bed", f"{g}/geno", "--compute-corr", "--ld-extract",
                             f"{g}/ldlist.txt", *gene], None),
    }
    for i, (what, (d, table, args, outs)) in enumerate(runs.items()):
        common = ["--step", "2", *args, "--phenoFile", f"{d}/{table}", "--covarFile",
                  f"{d}/covar.txt", "--remove", f"{d}/remove.txt", "--ignore-pred",
                  "--bsize", "256"]
        kept = {}
        secs = {}
        try:
            for where in ("gpu", "cpu"):
                os.environ.pop("REGENIE_TPU_TORCH_DEVICE", None)
                if where == "cpu":
                    os.environ["REGENIE_TPU_TORCH_DEVICE"] = "cpu"
                _reset_counts()
                t0 = time.time()
                params, eng, _ = run_cli_kept(common + ["--out", f"{d}/m{i}{where}"])
                secs[where] = time.time() - t0
                if where == "gpu" and any(_read_counts().values()):
                    raise AssertionError(f"{what}: kernels launched {_read_counts()}")
                if outs is None:
                    kept[where] = (params, eng.pd, eng.ld)
                eng.gd.close()
        finally:
            os.environ.pop("REGENIE_TPU_TORCH_DEVICE", None)
        a, b = f"{d}/m{i}gpu", f"{d}/m{i}cpu"
        if outs is None:
            (params, pd, la), (_, _, lb) = kept["gpu"], kept["cpu"]
            gap = float(np.abs(la.LD - lb.LD).max())
            if not gap <= LD_BAR:
                raise AssertionError(f"{what}: LD card vs CPU {gap:.3e}")
            n_off = 0
            if "--output-corr-text" not in args and "--skip-scaleG" not in args:
                n_off = _ld_versus_cpu(params, pd, la, what)[1]
            _ld_files_close(a, b, args)
            forced = (open(a + ".corr.forcedIn.snplist").read().split()
                      if os.path.exists(a + ".corr.forcedIn.snplist") else [])
            if "--ld-extract" in args and not (
                    "vABSENT" in forced
                    and [m for m in la.names if ".M" in m and m not in forced]):
                raise AssertionError(f"{what}: no mask row built, or an absent "
                                     "name not kept")
            what_ld = "|dcov|" if "--skip-scaleG" in args else "|dcorr|"
            detail = (f"{len(la.names)} x {len(la.names)}, max {what_ld} {gap:.3e}"
                      + (f", {len(forced)} names kept as zero rows" if forced else "")
                      + (f", {n_off} binary codes at a rounding tie"
                         if "--ld-extract" in args else ""))
        else:
            worst = max(_compare_files(a + o, b + o) for o in outs)
            nrow = len(_read_text(b + outs[0]).splitlines()) - 1
            detail = (f"{nrow} rows, every field within its bar (largest share of "
                      f"the bar used {worst:.3f})")
        print(f"  {what}: card {secs['gpu']:.1f}s, CPU {secs['cpu']:.1f}s; {detail}; "
              "no kernel launched")


def _dense_block_parts(eng, blk, bsnps, reps=3):
    """Card milliseconds (CUDA events, median of `reps` after a warm-up)
    of the dense route's parts on an uploaded block: the stats (the
    per-variant stats with their fetch, and BGEN's INFO product), the
    finalize (imputation) and the one-pass scorer."""
    import torch

    from regenie_tpu_torch.models import step2 as m2
    from regenie_tpu_torch.ops.geno_ops import finalize_block_step2

    G, info = blk
    d = eng._ensure_dense_consts()
    flip = torch.zeros(G.shape[0], dtype=torch.bool, device=G.device)
    parts = {
        "stats": lambda: (eng.block_stats(G, bsnps),
                          ((info * d.indf[None, :]) @ d.maskf).cpu()),
        "finalize": lambda: finalize_block_step2(G, d.ind, flip),
    }
    out = {name: _events_ms(fn, reps)[0] for name, fn in parts.items()}
    Gf = finalize_block_step2(G, d.ind, flip)
    out["onepass"] = _events_ms(lambda: m2.score_qt_block_onepass(
        Gf, d.cov, d.res, d.maskf, None, d.Mmat, d.covt_res, eng.scale_denom,
        W=d.W, maskf1=d.maskf1), reps)[0]
    return out


def _printed_equal_or_adjacent(path_a, path_b, cols):
    """Columns `cols` of two .regenie files print equal, or one unit of
    their sixth significant digit apart (two values on either side of a
    rounding boundary). Returns the count of adjacent prints."""
    la = _read_text(path_a).splitlines()
    lb = _read_text(path_b).splitlines()
    names = la[0].split()
    idx = [names.index(c) for c in cols]
    n_adj = 0
    for ra, rb in zip(la[1:], lb[1:]):
        ta, tb = ra.split(), rb.split()
        for i in idx:
            if ta[i] != tb[i]:
                if _sig6_excess(ta[i], tb[i]) > 1 + 1e-9:
                    raise AssertionError(f"{path_a}: {names[i]} {ta[i]} vs {tb[i]}")
                n_adj += 1
    return n_adj


def dense_slice_phase(tmp, kept):
    """The dense Step-2 route at full width on the card, on the BGEN
    slice's dataset in `tmp`: the first block through the open engine
    `eng` (read, upload and the card's parts timed; INFO and A1FREQ
    within rel 1e-9 of the fused route's first block `fused1`, N equal,
    LOG10P and BETA at the slice bars), then one CLI run with
    REGENIE_TPU_FUSED=0 and the slice's flags, where no hand-written
    kernel may launch, the log must show the dense route on cuda (each
    block's host read and upload), and both blocks' files must meet the
    slice bars against the default (bgen_i8) run's files. kept: the BGEN
    slice's [engine, blocks, first block's result], emptied here so that
    the engine is freed before the CLI run. Holds the lanes' card lock."""
    with _card_heavy("[dense slice]"):
        _dense_slice(tmp, kept)


def _dense_slice(tmp, kept):
    import torch

    from regenie_tpu_torch.io.bgen import _read_records

    eng, blocks, fused1 = kept
    kept.clear()  # this frame holds the only reference to the engine now

    f = FULL
    M = SLICE_BLOCKS * f["B"]
    chrom, bsnps = blocks[0]
    eng.prep_chrom(chrom)
    t0 = time.time()
    _read_records(eng.gd._bgen, [s.offset for s in bsnps])
    t1 = time.time()
    host = eng.read_block_dense(bsnps)
    t2 = time.time()
    blk = eng.upload_dense(host, bsnps)
    torch.cuda.synchronize()
    t3 = time.time()
    del host
    parts = _dense_block_parts(eng, blk, bsnps)
    dense = eng.test_raw_block(blk, bsnps)[0]
    del blk
    print(f"  block 1: host read {t2 - t1:.3f}s (of which the records' read "
          f"in Python {t1 - t0:.3f}s, measured alone), upload {t3 - t2:.3f}s "
          f"(2 x {f['B']} x {f['N']} float64), card "
          + ", ".join(f"{n} {ms:.3f} ms" for n, ms in parts.items())
          + f" (CUDA events, median of 3); on {card_line()}")
    what = "dense - fused"
    if not np.array_equal(dense.ignored, fused1.ignored):
        raise AssertionError("block 1: the routes filter other variants")
    keep = ~dense.ignored
    if not np.array_equal(dense.ns_t[keep], fused1.ns_t[keep]):
        raise AssertionError("block 1: N differs between the routes")
    _assert_rel("block 1 INFO", dense.info_t[keep], fused1.info_t[keep], 1e-9, what)
    _assert_rel("block 1 A1FREQ", dense.af_t[keep], fused1.af_t[keep], 1e-9, what)
    _assert_close("block 1 LOG10P", dense.logp[keep], fused1.logp[keep],
                  LOG10P_TOL, what)
    _assert_close("block 1 BETA", dense.bhat[keep], fused1.bhat[keep], BETA_TOL, what)
    eng.gd.close()
    del eng
    _free()

    argv = ["--step", "2", "--bgen", f"{tmp}/geno.bgen", "--sample",
            f"{tmp}/geno.sample", "--phenoFile", f"{tmp}/pheno.txt",
            "--covarFile", f"{tmp}/covar.txt", "--ignore-pred", "--bsize",
            str(f["B"]), "--verbose", "--out", f"{tmp}/dense"]
    os.environ["REGENIE_TPU_FUSED"] = "0"
    try:
        _reset_counts()
        t0 = time.time()
        run_cli(argv)
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = _read_counts()
    finally:
        os.environ.pop("REGENIE_TPU_FUSED")
    if any(counts.values()):
        raise AssertionError(f"kernel launches on the dense route: {counts}")
    log = open(f"{tmp}/dense.log").read().splitlines()
    if not any("dense scorer on cuda" in ln for ln in log):
        raise AssertionError("the log shows no dense route on cuda")
    for ln in log:
        if ln.startswith("   -block") or any(
                k in ln for k in ("block loop:", "dense route:")):
            print(f"  {ln.strip(' *')}")
    worst, n_adj = 0.0, 0
    for p in range(f["P"]):
        a, b = f"{tmp}/dense_Y{p + 1}.regenie", f"{tmp}/slice_bgen_i8_Y{p + 1}.regenie"
        _check_rows(a, M)
        worst = max(worst, _compare_files(a, b))
        n_adj += _printed_equal_or_adjacent(a, b, ["A1FREQ", "INFO", "N"])
    print(f"  dense CLI run (REGENIE_TPU_FUSED=0): launches {counts}; {f['P']} "
          f"files against the bgen_i8 run's: every field within its bar "
          f"(largest share {worst:.3f}); A1FREQ, INFO and N print equal "
          f"({n_adj} prints one unit of the sixth digit apart)")
    print(f"  CLI wall time {wall:.2f}s = {M / wall:.1f} variants/s (run-up and "
          f"output included); on {card_line()}")


def _split_engine(eng, chrom):
    """A Step-2 engine of the same run scoring through the bf16 split
    consts: build_consts(split=True) (and for BGEN the narrow split Wq)
    from the engine's per-sample arrays on the genotype file's sample
    axis, and make_qt_block_fn / make_qt_bgen_fn on them. No CLI option
    selects this operand, in the JAX package as here."""
    from regenie_tpu_torch.ops import fused_score as fsc
    from regenie_tpu_torch.run_step2 import Step2Engine

    sp = Step2Engine(eng.params, eng.gd, eng.pd, eng.blup_files, eng.log,
                     eng.device)
    sp.prep_chrom(chrom)
    is_bgen = sp.gd._bgen is not None
    ind_f = sp._scatter_file(sp.pd.ind_in_analysis.astype(np.float64)).astype(bool)
    mask_f = sp._scatter_file(sp.maskf)
    c = fsc.build_consts(
        sp._scatter_file(sp.pd.new_cov), sp._scatter_file(sp.res), mask_f,
        ind_f, sp.scale_denom, nb=(sp._fused_nfile() + 3) // 4,
        device=sp.device, split=True, pack="sample" if is_bgen else "plane")
    if is_bgen:
        indz = ind_f.astype(np.float64)[:, None]
        c = c._replace(Wq=fsc.sample_pack(
            np.concatenate([mask_f * indz, indz], axis=1), True, sp.device)[0])
        sp._fused_fn = fsc.make_qt_bgen_fn(c, True, strict=sp.strict)
    else:
        sp._fused_fn = fsc.make_qt_block_fn(c, True, strict=sp.strict)
    sp._fused_consts, sp._fused_op_nbp, sp._fused_chrom = c, fsc.op_nbp(c.Wp), chrom
    return sp


def split_path(eng, plain, chrom, raw, bsnps, ref):
    """The bf16 split operand's library path on the first block of a
    slice's dataset, with the launch counts set to 0 just before it and
    read just after: the split engine's block function (make_qt_block_fn
    or make_qt_bgen_fn) and, on BED, score_block_fused with random allele
    flips. Each meets the slice bars against the float64 plain path (BGEN
    INFO and A1FREQ too). Returns the launch counts of the bf16 kernel."""
    import torch

    from regenie_tpu_torch.ops import fused_score as fsc

    is_bgen = eng.gd._bgen is not None
    kernel = "bgen_bf16" if is_bgen else "fused_bf16"
    print(f"[split path, {'BGEN' if is_bgen else 'BED'}]")
    t0 = time.time()
    sp = _split_engine(eng, chrom)
    c = sp._fused_consts
    print(f"  split consts built in {time.time() - t0:.1f}s: Wp "
          f"{tuple(c.Wp.shape)} {c.Wp.dtype}"
          + (f", Wq {tuple(c.Wq.shape)}" if is_bgen else ""))
    x = sp._fused_upload(raw)
    B = x.shape[0]
    gen = torch.Generator(device=x.device)
    gen.manual_seed(11)
    flip = torch.rand(B, generator=gen, device=x.device) < 0.5

    _reset_counts()
    t0 = time.time()
    res = sp.test_raw_block_fused(x, bsnps)[0]
    flipped = None
    if not is_bgen:
        flipped = fsc.score_block_fused(x, flip, c)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = _read_counts()
    n_calls = 1 if is_bgen else 2
    print(f"  first block through the split consts: {wall:.3f}s, launches {counts}")
    want = {name: n_calls if name == kernel else 0 for name in counts}
    if counts != want:
        raise AssertionError(f"kernel launches {counts}, expected {want}")

    inc = list(c.inc)
    _assert_close("split path first block LOG10P", res.logp, ref.logp, LOG10P_TOL)
    _assert_close("split path first block BETA", res.bhat, ref.bhat, BETA_TOL)
    _diff_record("bf16 split operand", res.logp, res.bhat, ref, inc)
    if is_bgen:
        _assert_rel("split path first block INFO", res.info_t, ref.info_t, 1e-9)
        _assert_rel("split path first block A1FREQ", res.af_t, ref.af_t, 1e-9)
    else:
        # score_block_fused with flips against the plain products on the
        # plain engine's float64 consts, with the same flips
        want_f = fsc.score_block_fused(x, flip, plain._fused_consts, use_kernel=False)
        fl = flip.cpu().numpy()
        # variants of (near) zero variance after projection are not
        # tested (low); both sides leave them out
        low = (flipped[3] | want_f[3]).cpu().numpy()
        post = []
        for o in (flipped, want_f):
            bhat, _, _, logp = sp._qt_post(*(t.cpu().numpy() for t in o[:3]), fl)
            post.append((np.where(low[:, None], np.nan, bhat),
                         np.where(low[:, None], np.nan, logp)))
        print(f"  score_block_fused: {int(fl.sum())} of {B} variants flipped, "
              f"{int(low.sum())} of low variance")
        _assert_close("score_block_fused LOG10P, flipped", post[0][1], post[1][1],
                      LOG10P_TOL)
        _assert_close("score_block_fused BETA, flipped", post[0][0], post[1][0],
                      BETA_TOL)
    del sp, c, x
    return {kernel: counts[kernel]}


def _or_scale(ta, tb, i, tol):
    """(a, b, bar) for field i (8: Effect, 9, 10: its CI) of a binary
    trait's HTP rows ta, tb (split at tabs, ';' and '='): odds ratios
    compared on the log scale, where 6 printed digits are 1e-5. The CI's
    half-width x = z |log OR| / sqrt(chisq) (Firth: z |beta| / sqrt(LRT))
    magnifies a small statistic's digits, so its bar adds x times the
    relative change of |log OR| / sqrt(chisq) between the rows, each part
    held at its own bar (Effect here, LOG10P in its field)."""
    from scipy.stats import chi2

    la, lb = math.log(float(ta[i])), math.log(float(tb[i]))
    if i == 8:
        return la, lb, tol + 1e-5
    ea, eb = math.log(float(ta[8])), math.log(float(tb[8]))
    xa, xb = la - ea, lb - eb
    lp = [float(t[t.index("LOG10P") + 1]) for t in (ta, tb)]
    ca, cb = (chi2.isf(10.0 ** -v, 1) for v in lp)
    rel = (abs(abs(ea) - abs(eb)) / max(abs(ea), abs(eb), 1e-300)
           + abs(ca - cb) / (2.0 * max(min(ca, cb), 1e-300)))
    return xa, xb, tol + 1e-5 * (1.0 + abs(xa)) + abs(xa) * rel


def _compare_files(f_gpu, f_cpu):
    """Field-by-field comparison of two output files (HTP, split or
    merged .regenie, gzipped or not): text fields equal, LOG10P within
    1e-5, every other number within 1e-6 (a binary trait's HTP odds
    ratios on the log scale, _or_scale), each beyond the half-unit of the
    6 significant digits the files print. Returns the largest excess
    ratio (<= 1 passes)."""
    la = _read_text(f_gpu).splitlines()
    lb = _read_text(f_cpu).splitlines()
    if len(la) != len(lb) or la[0] != lb[0]:
        raise AssertionError(f"{f_gpu}: header or row count differs")
    htp = "\t" in la[0]
    names = la[0].split()
    worst = 0.0
    for ra, rb in zip(la[1:], lb[1:]):
        if htp:
            ta = ra.replace(";", "\t").replace("=", "\t").split("\t")
            tb = rb.replace(";", "\t").replace("=", "\t").split("\t")
        else:
            ta, tb = ra.split(), rb.split()
        if len(ta) != len(tb):
            raise AssertionError(f"field count differs:\n{ra}\n{rb}")
        for i, (x, y) in enumerate(zip(ta, tb)):
            if x == y:
                continue
            try:
                fx, fy = float(x), float(y)
            except ValueError:
                raise AssertionError(f"field differs:\n{ra}\n{rb}") from None
            if (ta[i - 1] if htp else names[i]).startswith("LOG10P"):
                tol = LOG10P_TOL
            elif htp and i == 11:  # Pval: compare as -log10
                fx, fy, tol = -math.log10(fx), -math.log10(fy), LOG10P_TOL
            else:
                tol = BETA_TOL
            lim = tol + 1e-5 * max(abs(fx), abs(fy))
            if htp and 8 <= i <= 10 and ta[7].endswith(("-LOG", "-SPA", "-FIRTH")):
                fx, fy, lim = _or_scale(ta, tb, i, tol)
            worst = max(worst, abs(fx - fy) / lim)
            if abs(fx - fy) > lim:
                raise AssertionError(f"field {i} differs beyond {tol:g}:\n{ra}\n{rb}")
    return worst


def _events_ms(fn, reps):
    """(median ms of fn() on the card with CUDA events, after one warm-up
    call; the last result)."""
    import torch

    out = fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times)), out


def _sig6_excess(xa, xb):
    """|a - b| in units of the sixth significant digit of the larger."""
    a, b = float(xa), float(xb)
    m = max(abs(a), abs(b))
    return abs(a - b) / 10.0 ** (math.floor(math.log10(m)) - 5) if m else 0.0


def _compare_loco(f_gpu, f_cpu, header=True):
    """Two .loco files (header=False: two .firth files, no header line):
    same header, rows and NA pattern, every value equal or within one unit
    of its sixth significant digit. Returns (the values that differ, the
    largest gap in those units)."""
    la = open(f_gpu).read().splitlines()
    lb = open(f_cpu).read().splitlines()
    if len(la) != len(lb) or (header and la[0] != lb[0]):
        raise AssertionError(f"{f_gpu}: header or row count differs")
    ndiff, worst = 0, 0.0
    for ra, rb in zip(la[int(header):], lb[int(header):]):
        ta, tb = ra.split(), rb.split()
        if len(ta) != len(tb) or ta[0] != tb[0]:
            raise AssertionError(f"{f_gpu}: row {ta[0]} differs in shape")
        for xa, xb in zip(ta[1:], tb[1:]):
            if xa != xb:
                ndiff += 1
                worst = max(worst, _sig6_excess(xa, xb))  # raises on NA vs a number
    if worst > 1 + 1e-9:
        raise AssertionError(f"{f_gpu}: a value differs by {worst:.3f} units "
                             "of its sixth significant digit")
    return ndiff, worst


def _check_loco_file(path, n_in, masked_n):
    """One .loco file: 25 lines (the header, chromosomes 1..23, nothing
    after the last newline), each of n_in + 2 fields (the label or
    "FID_IID", n_in values, a trailing space), row c starting "c ";
    with masked_n (not None) rows 1 and 23 parsed: finite values, NA
    exactly masked_n times. Returns (the header, the file's bytes)."""
    with open(path, "rb") as fh:
        data = fh.read()
    buf = np.frombuffer(data, np.uint8)
    ends = np.flatnonzero(buf == 10)  # memchr-speed passes, the GIL released
    if len(ends) != 24 or ends[-1] != len(data) - 1:
        raise AssertionError(f"{path}: {len(ends)} lines or text after the last")
    starts = np.concatenate([[0], ends[:-1] + 1])
    spaces = np.diff(np.searchsorted(np.flatnonzero(buf == 32),
                                     np.concatenate([[0], ends])))
    if not (spaces == n_in + 1).all():
        raise AssertionError(f"{path}: a line without {n_in + 1} spaces "
                             f"({spaces.min()}..{spaces.max()})")
    for c in range(1, 24):
        if not data.startswith(b"%d " % c, starts[c]):
            raise AssertionError(f"{path}: row {c} malformed")
    if masked_n is not None:
        for c in (1, 23):
            tok = data[starts[c] : ends[c]].split()[1:]
            na = np.array([t == b"NA" for t in tok])
            vals = np.array([float(t) for t, m in zip(tok, na) if not m])
            if na.sum() != masked_n or not np.isfinite(vals).all():
                raise AssertionError(f"{path}: {na.sum()} NA (want {masked_n}) "
                                     "or a value not finite")
    return data[: ends[0]], len(data)


def _check_loco_files(out, names, n_in, masked):
    """The run's _pred.list names every trait's .loco file; each file has
    the header of n_in samples and one row for chromosomes 1..23 of n_in
    values. Rows 1 and 23 of the first and last traits are parsed:
    finite values, NA exactly on the trait's masked samples (`masked`:
    trait index -> their count). The files are checked in threads."""
    from concurrent.futures import ThreadPoolExecutor

    rows = [ln.split() for ln in open(f"{out}_pred.list").read().splitlines()]
    if [r[0] for r in rows] != names:
        raise AssertionError(f"{out}_pred.list names {[r[0] for r in rows]}")
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        got = list(pool.map(lambda ph: _check_loco_file(rows[ph][1], n_in,
                                                         masked.get(ph)),
                            range(len(rows))))
    header = got[0][0]
    if any(h != header for h, _ in got):
        raise AssertionError(f"{out}: the .loco files' headers differ")
    if not header.startswith(b"FID_IID "):
        raise AssertionError(f"{out}: header {header[:40]!r}")
    return sum(n for _, n in got)


def step1_slice_phase(tmp):
    """The port's Step-1 QT CLI at full width on the card in this process
    (K-fold, J = T = 5, 4 blocks of 1000 variants), then the first block's
    level-0 parts timed with CUDA events and its W held against the CPU,
    and level 1 at a real depth on synthetic predictions."""
    import shutil

    import torch

    from regenie_tpu_torch.models import step1 as m1
    from regenie_tpu_torch.run_step1 import Level0

    f = FULL
    prefix = f"{tmp}/geno"
    need = f["P"] * 23 * f["N"] * LOCO_BYTES_PER_VALUE
    free = shutil.disk_usage(tmp).free
    print(f"  free space under {tmp}: {free / 1e9:.1f} GB; the {f['P']} LOCO "
          f"files need about {need / 1e9:.1f} GB")
    if free < need:
        raise AssertionError(f"{free / 1e9:.1f} GB free under {tmp}, the LOCO "
                             f"files need about {need / 1e9:.1f} GB")
    out = f"{tmp}/s1"
    argv = ["--step", "1", "--bed", prefix, "--phenoFile", f"{tmp}/pheno.txt",
            "--covarFile", f"{tmp}/covar.txt", "--bsize", str(STEP1["B"]),
            "--verbose", "--out", out]
    os.environ.pop("REGENIE_TPU_TORCH_DEVICE", None)
    _reset_counts()
    t0 = time.time()
    # the CLI; run_step1's setup serves the block checks
    params, st, log = run_cli_kept(argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = _read_counts()
    if any(counts.values()):
        raise AssertionError(f"kernel launches {counts} in Step 1; expected none")
    if " * level 0 on cuda (float64)" not in log:
        raise AssertionError("the Step-1 log does not show level 0 on cuda")
    for ln in log:
        if ln.startswith("   -level 0 block") or ln.startswith(" * level "):
            print(f"  {ln.strip()}")
    print(f"  run wall time {wall:.2f}s (run-up, level 0, level 1 and the "
          f"LOCO files); kernel launches {counts}; on {card_line()}")
    pd = st.pd
    n_in = int(pd.ind_in_analysis.sum())
    masked = {p: int((pd.ind_in_analysis & ~pd.masked_indivs[:, p]).sum())
              for p in (0, f["P"] - 1)}
    t0 = time.time()
    nbytes = _check_loco_files(out, pd.pheno_names, n_in, masked)
    print(f"  {f['P']} LOCO files of {n_in} samples x 23 rows ({nbytes / 1e9:.2f} "
          f"GB) and _pred.list well formed ({time.time() - t0:.1f}s)")

    # the first block's level-0 parts on the card, each timed alone
    dev = st.device
    chrom, bsnps = st.blocks[0]
    raw = st.gd.read_block_bytes(bsnps)
    l0 = Level0(params, st)
    parts = {}
    parts["upload, decode, impute, residualize"], G = _events_ms(
        lambda: l0.residualized(st.gd.read_block_device(bsnps, dev, raw), bsnps), 3)
    parts["fold gather"], Gf = _events_ms(lambda: l0.folds(G), 3)
    parts["Gram and cross products"], (Gv, GGt_f, GtY_f) = _events_ms(
        lambda: m1.kfold_grams(Gf, l0.Y_folds, l0.valid), 3)
    eigh = "eigh ({} x {} x {})".format(*GGt_f.shape)
    parts[eigh], (d, V) = _events_ms(lambda: m1.kfold_eigh(GGt_f), 3)
    if torch.cuda.has_magma:
        lib = torch.backends.cuda.preferred_linalg_library()
        try:
            torch.backends.cuda.preferred_linalg_library("magma")
            parts["eigh with magma (not used)"], _ = _events_ms(
                lambda: m1.kfold_eigh(GGt_f), 3)
        finally:
            torch.backends.cuda.preferred_linalg_library(lib)
    else:
        print("  this PyTorch has no MAGMA; eigh runs on cuSOLVER only")
    parts["ridge solutions"], beta = _events_ms(
        lambda: m1.kfold_beta(d, V, GtY_f, l0.lambdas), 3)
    parts["predictions and centring"], Wb = _events_ms(
        lambda: m1.kfold_predict(beta, Gv, l0.mask_folds, l0.Neff), 3)
    del Gv, GGt_f, GtY_f, Gf, G
    W_host = np.zeros((len(st.blocks),) + tuple(Wb.shape))  # run_step1's layout
    t0 = time.time()
    torch.from_numpy(W_host[0]).copy_(Wb)
    parts["W to host (host clock)"] = (time.time() - t0) * 1e3
    for name, ms in parts.items():
        print(f"  first block, {name}: {ms:.3f} ms")

    # the same block through the same functions in float64 on the CPU
    t0 = time.time()
    lc = Level0(params, st._replace(device=torch.device("cpu")))
    Wc = lc.kfold(lc.residualized(st.gd.read_block_device(bsnps, "cpu", raw), bsnps))
    cpu_s = time.time() - t0
    err = float((Wb.cpu() - Wc).abs().max())
    print(f"  first block W, card against CPU (float64, {cpu_s:.1f}s on "
          f"{torch.get_num_threads()} CPU threads): max |dW| {err:.3e} (bar 1e-08)")
    if not err <= 1e-8:
        raise AssertionError(f"first block W: {err:.3e} > 1e-08")
    del Wc, lc
    mesh_level0_check(params, st, bsnps, raw, l0, Wb)
    del Wb, l0
    st.gd.close()
    torch.cuda.empty_cache()

    # level 1 for one trait at a real depth (F = 500 blocks x J)
    with _card_heavy("level 1 at a real depth"):
        F, K = STEP1["real_F"], params.cv_folds
        nmax = -(-f["N"] // K)
        gen = torch.Generator(device=dev)
        gen.manual_seed(13)
        Wr = torch.randn(K, nmax, F, generator=gen, device=dev, dtype=torch.float64)
        Yr = torch.randn(K, nmax, generator=gen, device=dev, dtype=torch.float64)
        valid = torch.ones(K, nmax, device=dev, dtype=torch.float64)
        valid[-1, f["N"] - (K - 1) * nmax:] = 0.0
        taus = torch.as_tensor(st.taus / len(st.blocks) * (F // params.n_ridge_l0),
                               device=dev)
        ms, (beta, cs) = _events_ms(
            lambda: m1.level1_linear_kfold(Wr, Yr, valid, taus), 2)
        if not torch.isfinite(cs).all():
            raise AssertionError("level 1 at a real depth: metrics not finite")
        print(f"  level1_linear_kfold for one trait at F={F}, {K} folds, N={f['N']} "
              f"({Wr.numel() * 8 / 1e9:.1f} GB float64 on the card): {ms:.1f} ms")
        del Wr, Yr, valid, beta, cs
        torch.cuda.empty_cache()


def mesh_level0_check(params, st, bsnps, raw, l0, Wk):
    """[mesh] The first block of [step1 slice] (B = 1,000, N = 400,000)
    through the sample-sharded level 0 on two shards of the card, its
    K-fold W (run_step1.Level0 on the mesh: each shard's fold gather, then
    parallel.mesh.sharded_level0_kfold) against the unsharded Wk, and its
    LOOCV W (parallel.mesh.sharded_level0_loocv on the trait operands
    sharded once) against models/step1's unsharded level0_loocv_block:
    max |dW| <= 1e-8 each (the Step-1 bar). Times each side over the same
    span with CUDA events (one warm-up, the median of two): K-fold from
    the residualized block to W, fold gather included, and the sharded
    K-fold's two parts apart (the per-shard fold gathers; the sharded
    ridge)."""
    import torch

    from regenie_tpu_torch.models import step1 as m1
    from regenie_tpu_torch.parallel import mesh as pm
    from regenie_tpu_torch.run_step1 import Level0

    dev = st.device
    mesh = pm.make_mesh([dev, dev])
    G = l0.residualized(st.gd.read_block_device(bsnps, dev, raw), bsnps)
    lm = Level0(params, st._replace(mesh=mesh))
    ms_ku, _ = _events_ms(lambda: l0.kfold(G), 2)
    ms_k, Wm = _events_ms(lambda: lm.kfold(G), 2)
    err_k = float((Wm - Wk).abs().max())
    del Wm
    ms_fp, parts = _events_ms(lambda: lm.fold_parts(G), 2)
    ms_kr, _ = _events_ms(lambda: pm.sharded_level0_kfold(
        mesh, parts, lm.Yf_sh, lm.mf_sh, lm.v_sh, lm.lambdas, lm.Neff), 2)
    del parts, lm
    Y = torch.as_tensor(np.asarray(st.pd.phenotypes, np.float64), device=dev)
    mask = torch.as_tensor(st.pd.masked_indivs.astype(np.float64), device=dev)
    ms_u, Wu = _events_ms(lambda: m1.level0_loocv_block(
        G, Y, mask, l0.lambdas, l0.Neff), 2)
    Y_sh, m_sh = pm.shard(mesh, Y, 0), pm.shard(mesh, mask, 0)
    N = G.shape[1]
    ms_l, Wl = _events_ms(lambda: pm.sharded_level0_loocv(
        mesh, G, Y_sh, m_sh, l0.lambdas, l0.Neff)[:N], 2)
    err_l = float((Wl - Wu).abs().max())
    print(f"  [mesh] first block level 0 on 2 shards of the card (B = {G.shape[0]}, "
          f"N = {N}): K-fold {ms_k:.1f} ms (unsharded {ms_ku:.1f} ms, both from the "
          f"residualized block; sharded parts: fold gathers {ms_fp:.1f} ms, ridge "
          f"{ms_kr:.1f} ms), max |dW| {err_k:.3e} against unsharded; LOOCV "
          f"{ms_l:.1f} ms (unsharded {ms_u:.1f} ms), max |dW| {err_l:.3e} "
          "(bar 1e-08)")
    if not (err_k <= 1e-8 and err_l <= 1e-8):
        raise AssertionError(f"sharded level 0: K-fold {err_k:.3e}, LOOCV "
                             f"{err_l:.3e} > 1e-08")
    del G, Wu, Wl, Y_sh, m_sh, Y, mask
    torch.cuda.empty_cache()


def step1_bt_slice_phase(tmp):
    """The port's Step-1 CLI on binary traits at full width on the card,
    on the [step1 slice]'s BED (same directory, its QT LOCO files removed
    first): a binary-trait table from the BED writer's traits (5-30%
    prevalence, the first n_inc traits with 5% NA), one run with --bt
    (K-fold, J = T = 5): no hand-written kernel may launch, level 0 on
    cuda, the 50 .loco files and _pred.list well formed, the null fits',
    level 0's, level 1's and the LOCO files' times printed. Then level 1
    of one binary trait at a real depth (level1_bt_real_depth)."""
    import glob

    import torch

    f = FULL
    for path in glob.glob(f"{tmp}/s1_*.loco"):
        os.remove(path)
    note = _read_note(f"{tmp}/pheno_bt.txt")
    print(f"  BT table N={f['N']} P={f['P']} (prevalence 5-30%, {note['cases']} "
          f"cases) written in the background in {note['seconds']:.1f}s")
    out = f"{tmp}/s1bt"
    argv = ["--step", "1", "--bed", f"{tmp}/geno", "--phenoFile",
            f"{tmp}/pheno_bt.txt", "--covarFile", f"{tmp}/covar.txt", "--bt",
            "--bsize", str(STEP1["B"]), "--verbose", "--out", out]
    os.environ.pop("REGENIE_TPU_TORCH_DEVICE", None)
    _reset_counts()
    t0 = time.time()
    run_cli(argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = _read_counts()
    if any(counts.values()):
        raise AssertionError(f"kernel launches {counts} in Step 1; expected none")
    with open(f"{out}.log") as fh:
        log = fh.read().splitlines()
    if " * level 0 on cuda (float64)" not in log or " * # CV folds: [5]" not in log:
        raise AssertionError("the Step-1 BT log shows no 5-fold level 0 on cuda")
    for ln in log:
        if (ln.startswith("   -level 0 block") or ln.startswith(" * level ")
                or ln.startswith(" * null model fits")):
            print(f"  {ln.strip()}")
    print(f"  BT Step-1 CLI wall time {wall:.2f}s (run-up, null fits, level 0, "
          f"level 1 and the LOCO files); no kernel launched; on {card_line()}")
    t0 = time.time()
    n_in = note["n_in"]
    masked = dict(zip((0, f["P"] - 1), note["masked"]))
    names = [f"Y{p + 1}" for p in range(f["P"])]
    nbytes = _check_loco_files(out, names, n_in, masked)
    print(f"  {f['P']} LOCO files of {n_in} samples x 23 rows ({nbytes / 1e9:.2f} "
          f"GB) and _pred.list well formed ({time.time() - t0:.1f}s)")
    with _card_heavy("level 1 BT at a real depth"):
        level1_bt_real_depth(torch.device("cuda"))
        _free()


def _level1_bt_inputs(N, F, K, seed, dev):
    """Synthetic level-0 predictions of one binary trait at N samples and
    F columns, by fold ([K, nmax, F] on `dev`, pad rows 0; drawn there
    from a seeded generator), its outcomes (a logistic model of 200 of the
    columns, ~15% cases), 2% masked samples, the null offsets (the model's
    intercept, 0 on the masked samples), and the pd namespace
    level1_nonqt reads (host numpy)."""
    from types import SimpleNamespace

    import torch

    from regenie_tpu_torch.models import step1 as m1

    fold_sizes = m1.compute_fold_sizes(np.ones(N, bool), K)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    Wf = torch.randn(K, int(fold_sizes.max()), F, generator=gen, device=dev,
                     dtype=torch.float64) * 0.5
    valid = torch.as_tensor(m1.pad_folds(np.ones(N), fold_sizes)[1], device=dev)
    Wf *= valid[..., None]
    b = torch.randn(200, generator=gen, device=dev, dtype=torch.float64) * 0.02
    eta = (-1.9 + Wf[..., :200] @ b)[valid].cpu().numpy()
    u = torch.rand(N, 2, generator=gen, device=dev, dtype=torch.float64).cpu().numpy()
    y = (u[:, 0] < 1 / (1 + np.exp(-eta))).astype(np.float64)
    mask = u[:, 1] > 0.02
    pd = SimpleNamespace(phenotypes_raw=np.where(mask, y, -999.0)[:, None],
                         masked_indivs=mask[:, None],
                         Neff=np.array([float(mask.sum())]))
    return Wf, fold_sizes, np.where(mask, -1.9, 0.0)[:, None], pd


def level1_bt_real_depth(dev):
    """Level 1 of one binary trait at a real depth (F = 2,500 columns:
    500 blocks x J), K-fold at N = 400,000 on the card (8 GB of float64
    predictions), timed per ridge parameter and per Newton iteration;
    then the same function at N = 20,000, F = 250 on the card and on the
    CPU in float64: the same ridge parameter, the predictions' largest
    gap within 1e-9 of their largest magnitude."""
    import torch

    from regenie_tpu_torch.config import BT, Params, ridge_h2_grid
    from regenie_tpu_torch.models import step1_bt

    f = FULL
    params = Params(trait_mode=BT)
    chr_order = list(range(1, 23))

    def spans(F):
        per = F // len(chr_order)
        return {c: (i * per, per if c < 22 else F - 21 * per)
                for i, c in enumerate(chr_order)}

    def taus(F):
        h = ridge_h2_grid(params.n_ridge_l1)
        return F * (1 - h) / h * 3 / np.pi**2

    F = STEP1["real_F"]
    t0 = time.time()
    Wt, fold_sizes, off, pd = _level1_bt_inputs(f["N"], F, params.cv_folds, 21, dev)
    _sync(dev)
    print(f"  level 1 BT at F={F}, N={f['N']}: {Wt.numel() * 8 / 1e9:.1f} GB of "
          f"predictions drawn on the card in {time.time() - t0:.1f}s")
    trace, logs = [], []
    t0 = time.time()
    pred, ok = step1_bt.level1_nonqt(params, pd, Wt, off, taus(F), 0, chr_order,
                                     spans(F), fold_sizes, logs.append, trace=trace)
    _sync(dev)
    secs = time.time() - t0
    if not ok or not np.isfinite(pred).all():
        raise AssertionError("level 1 BT at a real depth did not converge")
    its = sum(t["iterations"] for t in trace)
    fit_s = sum(t["seconds"] for t in trace)
    per_tau = [sum(t["seconds"] for t in trace if t["tau"] == j)
               for j in range(params.n_ridge_l1)]
    best = [ln.strip() for ln in logs if "min value" in ln]
    print(f"  level1_nonqt (BT, K-fold) for one trait at F={F}, {params.cv_folds} "
          f"folds: {secs:.2f}s; {its} Newton iterations in {fit_s:.2f}s = "
          f"{1e3 * fit_s / its:.1f} ms an iteration; per ridge parameter (its "
          f"{params.cv_folds} folds) " + ", ".join(f"{x:.2f}s" for x in per_tau)
          + f"; chosen: {best}")
    del Wt
    _free()

    n, F = 20_000, 250
    Wc, fold_sizes, off, pd = _level1_bt_inputs(n, F, params.cv_folds, 22, "cpu")
    out = []
    for where in (dev, "cpu"):
        logs = []
        t0 = time.time()
        pred, ok = step1_bt.level1_nonqt(params, pd, Wc.to(where), off, taus(F), 0,
                                         chr_order, spans(F), fold_sizes, logs.append)
        out.append((pred, [ln for ln in logs if "min value" in ln], time.time() - t0))
        if not ok:
            raise AssertionError(f"level 1 BT at N={n} did not converge on {where}")
    if out[0][1] != out[1][1]:
        raise AssertionError(f"level 1 BT: the card chose {out[0][1]}, the CPU "
                             f"{out[1][1]}")
    a, b = out[0][0], out[1][0]
    err = float(np.abs(a - b).max() / np.abs(b).max())
    print(f"  level 1 BT at N={n}, F={F}, card against CPU float64 (card "
          f"{out[0][2]:.1f}s, CPU {out[1][2]:.1f}s on "
          f"{torch.get_num_threads()} threads): the same ridge parameter "
          f"({out[1][1][0].strip()}); predictions max |d| / max |CPU| "
          f"{err:.3e} (bar 1e-09)")
    if not err <= 1e-9:
        raise AssertionError(f"level 1 BT predictions: {err:.3e} > 1e-09")


T2E = dict(endpoints=10, n_na=2)  # the [t2e slice]'s Cox endpoints


def t2e_slice_phase(tmp):
    """Time-to-event traits at full width on the card, on the [step1
    slice]'s BED (same directory, its QT and BT LOCO files removed
    first): a table of 10 endpoints (write_t2e_table from the writer's
    traits: tied times, event rates 5-30%, the first 2 with 5% NA times),
    the Step-1 CLI with --t2e (K-fold, J = T = 5): no hand-written kernel
    may launch, level 0 on cuda, the 10 .loco files and _pred.list well
    formed; the Cox level 1 alone at the real depth and card against CPU
    (level1_t2e_real_depth); then the Step-2 CLI with --t2e --pred on that
    _pred.list (no --firth: the host's null Cox Firth costs minutes a
    trait at this N), where fused_i8 launches once per block and no other
    kernel, its 10 files well formed; and the last chromosome's block in
    memory through the run's engine against a float64 plain engine on the
    same null fits (flips equal, the slice bars), with fused_i8 at the Cox
    operand's width against its plain version and torch._int_mm. Returns
    the launches of fused_i8 in the Step-2 run."""
    import glob

    import torch

    from regenie_tpu_torch.io.geno import make_blocks
    from regenie_tpu_torch.run_step2 import Step2Engine

    f = FULL
    nt = T2E["endpoints"]
    for path in glob.glob(f"{tmp}/s1_*.loco") + glob.glob(f"{tmp}/s1bt_*.loco"):
        os.remove(path)
    note = _read_note(f"{tmp}/pheno_t2e.txt")
    print(f"  T2E table N={f['N']}: {nt} endpoints, event rates "
          f"{note['rates'][0]:.3f}-{note['rates'][1]:.3f}, {note['times_t1']} "
          f"distinct times of T1, written in the background in "
          f"{note['seconds']:.1f}s")
    flags = t2e_flags(nt)
    base = ["--bed", f"{tmp}/geno", "--phenoFile", f"{tmp}/pheno_t2e.txt",
            "--covarFile", f"{tmp}/covar.txt", *flags, "--verbose"]
    out = f"{tmp}/s1t2e"
    os.environ.pop("REGENIE_TPU_TORCH_DEVICE", None)
    _reset_counts()
    t0 = time.time()
    run_cli(["--step", "1", *base, "--bsize", str(STEP1["B"]), "--out", out])
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = _read_counts()
    if any(counts.values()):
        raise AssertionError(f"kernel launches {counts} in Step 1; expected none")
    with open(f"{out}.log") as fh:
        log = fh.read().splitlines()
    if " * level 0 on cuda (float64)" not in log or " * # CV folds: [5]" not in log:
        raise AssertionError("the Step-1 T2E log shows no 5-fold level 0 on cuda")
    for ln in log:
        if (ln.startswith(" * level ") or ln.startswith(" * null model fits")
                or ln.startswith("  level 1 of")):
            print(f"  {ln.strip()}")
    print(f"  T2E Step-1 CLI wall time {wall:.2f}s (run-up, null fits, level 0, "
          f"level 1 and the LOCO files); no kernel launched; on {card_line()}")
    t0 = time.time()
    masked = {0: note["na_t1"], nt - 1: 0}
    nbytes = _check_loco_files(out, [f"T{p + 1}" for p in range(nt)], f["N"], masked)
    print(f"  {nt} LOCO files of {f['N']} samples x 23 rows ({nbytes / 1e9:.2f} GB) "
          f"and _pred.list well formed ({time.time() - t0:.1f}s)")
    with _card_heavy("the Cox level 1 at a real depth"):
        level1_t2e_real_depth(torch.device("cuda"))
        _free()

    # Step 2 on the Step-1 predictions
    M = sum(n for _, n in STEP1["chroms"])
    s2 = f"{tmp}/t2e"
    argv = ["--step", "2", *base, "--pred", f"{out}_pred.list", "--bsize",
            str(f["B"]), "--out", s2]
    _reset_counts()
    t0 = time.time()
    params, eng, lines = run_cli_kept(argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = _read_counts()
    n_blocks = len(make_blocks(eng.gd, params.block_size))
    for p in range(nt):
        _check_rows(f"{s2}_T{p + 1}.regenie", M)
    want = {name: n_blocks if name == "fused_i8" else 0 for name in counts}
    print(f"  T2E Step-2 run: {nt} well-formed .regenie files of {M} rows; "
          f"launches {counts} for {n_blocks} blocks")
    if counts != want:
        raise AssertionError(f"kernel launches {counts}, expected {want}")
    for ln in lines:
        if (ln.startswith("   -block") or "null fits chr" in ln
                or "null model fits" in ln or "block loop" in ln):
            print(f"  {ln.strip()}")
    loop = [ln.strip(" *") for ln in lines if "block loop:" in ln][0]
    loop_s = float(loop.rsplit(" in ", 1)[1].rstrip("s"))
    print(f"  T2E Step-2 wall time {wall:.2f}s = {M / wall:.1f} variants/s "
          f"(run-up, null fits and output included); block loop "
          f"{M / loop_s:.1f} variants/s; on {card_line()}")

    # the last chromosome's block again, in memory, through the run's
    # engine (its null fits, its int8 operand) and a float64 plain engine
    # on the same null fits
    chrom, bsnps = [b for b in make_blocks(eng.gd, params.block_size)
                    if b[0] == eng.cur_chrom][0]
    raw = eng.read_block_raw(bsnps)
    plain = Step2Engine(params, eng.gd, eng.pd, eng.blup_files, eng.log,
                        eng.device, kernel=False)
    plain.cur_chrom, plain.null_state, plain.res = chrom, eng.null_state, eng.res
    t0 = time.time()
    plain._ensure_fused_consts()
    torch.cuda.synchronize()
    ft = eng._fused_t2e
    print(f"  Cox operand (Wext {ft.C_used} columns, Cp "
          f"{-(-ft.C_used // 128) * 128}); float64 plain operand built in "
          f"{time.time() - t0:.2f}s")
    r8, fl8 = eng.test_raw_block_fused(raw, bsnps)
    rp, flp = plain.test_raw_block_fused(raw, bsnps)
    if not np.array_equal(fl8, flp):
        raise AssertionError("int8 and plain routes flip different variants")
    _assert_close(f"chr{chrom} block T2E LOG10P, int8 operand", r8.logp, rp.logp,
                  LOG10P_TOL)
    _assert_close(f"chr{chrom} block T2E BETA, int8 operand", r8.bhat, rp.bhat,
                  BETA_TOL)
    x = eng._fused_upload(raw)
    bt_width_fused_i8(eng.device, x, 10, limbs_k=ft.Wp.limbs_k, what="Cox width")
    eng.gd.close()
    return counts["fused_i8"]


def _cox_level1_inputs(N, F, K, seed, dev, folds=True):
    """Synthetic level-0 predictions of one endpoint at N samples and F
    columns on `dev` (drawn there from a seeded generator): by fold [K,
    nmax, F] (pad rows 0) or sample-major [N, F]; the endpoint's tied
    times and events (a Cox model of 200 of the columns, ~25% events), 2%
    masked samples; the fold sizes, the null offsets (zero) and the pd
    namespace the level 1 reads (host numpy)."""
    from types import SimpleNamespace

    import torch

    from regenie_tpu_torch.models import step1 as m1

    fold_sizes = m1.compute_fold_sizes(np.ones(N, bool), K)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    W = torch.randn(N, F, generator=gen, device=dev, dtype=torch.float64) * 0.5
    b = torch.randn(200, generator=gen, device=dev, dtype=torch.float64) * 0.02
    eta = (W[:, :200] @ b).cpu().numpy()
    u = torch.rand(N, 3, generator=gen, device=dev, dtype=torch.float64).cpu().numpy()
    t = -np.log(u[:, 0]) / (0.1 * np.exp(eta))
    c = 4.0 * u[:, 1]
    times, events = np.round(np.minimum(t, c), 2), (t <= c).astype(np.float64)
    mask = u[:, 2] > 0.02
    if folds:
        idx = torch.as_tensor(m1.fold_index(fold_sizes).reshape(K, -1), device=dev)
        valid = torch.as_tensor(m1.pad_folds(np.ones(N), fold_sizes)[1], device=dev)
        W = W[idx] * valid[..., None]
    pd = SimpleNamespace(pheno_names=["T1", "E1"],
                         phenotypes_raw=np.column_stack([times, events]),
                         masked_indivs=np.column_stack([mask, mask]))
    return W, fold_sizes, np.zeros((N, 2)), pd


def level1_t2e_real_depth(dev):
    """The Cox level 1 of one endpoint at a real depth (F = 2,500
    columns, N = 400,000, 8 GB of float64 predictions drawn on the card):
    3 coordinate sweeps of one (fold, penalty), each the Gram X' diag(h)
    X, one triangular solve and the deviance, timed with CUDA events;
    then level1_nonqt at N = 20,000, F = 250 on the card and on the CPU in
    float64: the same penalty chosen, the predictions' largest gap within
    1e-9 of their largest magnitude."""
    import torch

    from regenie_tpu_torch.config import T2E as T2E_MODE
    from regenie_tpu_torch.config import Params
    from regenie_tpu_torch.models import step1_bt

    f = FULL
    params = Params(trait_mode=T2E_MODE, t2e_map={"T1": "E1"})
    F, K = STEP1["real_F"], params.cv_folds
    t0 = time.time()
    X, fold_sizes, _, pd = _cox_level1_inputs(f["N"], F, K, 31, dev, folds=False)
    _sync(dev)
    print(f"  Cox level 1 at F={F}, N={f['N']}: {X.numel() * 8 / 1e9:.1f} GB of "
          f"predictions drawn on the card in {time.time() - t0:.1f}s; "
          f"{int(pd.phenotypes_raw[:, 1].sum())} events")
    train = pd.masked_indivs[:, 0].copy()
    train[: int(fold_sizes[0])] = False  # fold 0 held out
    t0 = time.time()
    rk = step1_bt._CoxRisk(pd.phenotypes_raw[:, 0], pd.phenotypes_raw[:, 1],
                           train, dev)
    print(f"  risk sets of the training folds (host order, uploaded): "
          f"{time.time() - t0:.2f}s")
    m = torch.as_tensor(train.astype(np.float64), device=dev)
    beta = torch.zeros(F, dtype=torch.float64, device=dev)
    eta = torch.zeros(f["N"], dtype=torch.float64, device=dev)
    grad, _ = step1_bt._cox_grad(rk, eta)
    lam = float((X.T @ grad).abs().max()) / 1e-3 * 1e-3  # mid-path
    sweeps = []
    for _ in range(3):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        grad, hess = step1_bt._cox_grad(rk, eta)
        beta = step1_bt.cox_sweep(X, grad, hess, beta, lam)
        eta = m * (X @ beta)
        d = float(step1_bt._cox_deviance(rk, eta))
        b.record()
        b.synchronize()
        sweeps.append(a.elapsed_time(b))
    gram_ms, _ = _events_ms(lambda: step1_bt._weighted_gram(X, hess), 2)
    gram_flop = 2.0 * f["N"] * F * F
    print(f"  Cox level 1 at F={F}: a coordinate sweep {np.mean(sweeps):.1f} ms "
          f"(3 sweeps of fold 0 at lambda {lam:.4g}: "
          + ", ".join(f"{x:.1f}" for x in sweeps) + " ms; in each the Gram "
          f"X' diag(h) X, {gram_flop:.3e} FLOP: {gram_ms:.1f} ms alone, bound "
          f"{gram_flop / PEAK_FP64_TC_OPS * 1e3:.1f} ms); deviance {d:.6g}; "
          f"on {card_line()}")
    del X, rk, m, grad, hess
    _free()

    n, F = 20_000, 250
    chr_order = list(range(1, 23))
    per = F // len(chr_order)
    spans = {c: (i * per, per if c < 22 else F - 21 * per)
             for i, c in enumerate(chr_order)}
    Wc, fold_sizes, off, pd = _cox_level1_inputs(n, F, K, 32, "cpu")
    res = []
    for where in (dev, "cpu"):
        logs = []
        t0 = time.time()
        pred, ok = step1_bt.level1_nonqt(params, pd, Wc.to(where), off, None, 0,
                                         chr_order, spans, fold_sizes, logs.append)
        res.append((pred, [ln for ln in logs if "min value" in ln], time.time() - t0))
        if not ok:
            raise AssertionError(f"Cox level 1 at N={n} failed on {where}")
    if res[0][1] != res[1][1]:
        raise AssertionError(f"Cox level 1: the card chose {res[0][1]}, the CPU "
                             f"{res[1][1]}")
    a, b = res[0][0], res[1][0]
    err = float(np.abs(a - b).max() / np.abs(b).max())
    print(f"  Cox level 1 at N={n}, F={F}, card against CPU float64 (card "
          f"{res[0][2]:.1f}s, CPU {res[1][2]:.1f}s on {torch.get_num_threads()} "
          f"threads): the same penalty ({res[1][1][0].strip()}); predictions "
          f"max |d| / max |CPU| {err:.3e} (bar 1e-09)")
    if not err <= 1e-9:
        raise AssertionError(f"Cox level 1 predictions: {err:.3e} > 1e-09")


def pgen_chrx_slice_phase(tmp):
    """The port's Step-2 QT CLI at full width on the card on a PGEN of two
    blocks, one on chromosome 1 and one on chrX (1/8 of its variants in
    PAR1, the rest non-PAR; half the samples male), with --gz: fused_i8
    launches once per block and no other kernel, and the 50 .regenie.gz
    files are well formed. Then both blocks through the kernel path
    against the plain path on the card (the bars, and on chrX A1FREQ, N
    and the hemizygous MAC within rel 1e-9), with the host read and the
    kernel timed per block, block 1's operand build, and the split, merged
    and gzipped writes of the two blocks' rows. Returns fused_i8's
    launches in the CLI run."""
    import torch

    from regenie_tpu_torch.io.geno import make_blocks
    from regenie_tpu_torch.ops import kernels
    from regenie_tpu_torch.run_step2 import (Step2Engine, setup_writers,
                                             write_block_rows)

    f = FULL
    B = f["B"]
    prefix = f"{tmp}/geno"
    print(f"  PGEN file {os.path.getsize(prefix + '.pgen') / 1e6:.1f} MB")
    argv = ["--step", "2", "--pgen", prefix, "--phenoFile", f"{tmp}/pheno.txt",
            "--covarFile", f"{tmp}/covar.txt", "--ignore-pred", "--bsize", str(B),
            "--gz", "--verbose", "--out"]
    os.environ.pop("REGENIE_TPU_TORCH_DEVICE", None)
    launches, eng, params = _slice_run(argv + [f"{tmp}/pgen"], "fused_i8",
                                       "fused_i8 run (PGEN, chrX, --gz)",
                                       suffix=".regenie.gz")
    blocks = make_blocks(eng.gd, params.block_size)
    eng.refresh_masks()  # block 1's operand is built again below, and timed
    plain = Step2Engine(params, eng.gd, eng.pd, eng.blup_files, eng.log,
                        eng.device, kernel=False)
    vrt = eng.gd._pgen.pf.vrtypes
    print(f"  records: {int((vrt == 0).sum())} 2-bit, {int((vrt == 2).sum())} "
          f"LD-compressed, {int((vrt == 3).sum())} LD-compressed inverted; "
          f"{int(eng.gd.sex.sum())} of {eng.gd.n_samples} samples male")
    if [c for c, _ in blocks] != [1, 23]:
        raise AssertionError(f"blocks on chromosomes {[c for c, _ in blocks]}")
    t0 = time.time()
    eng.prep_chrom(1)
    eng._ensure_fused_consts()
    torch.cuda.synchronize()
    c = eng._fused_consts
    print(f"  block 1's operand build (int8 limbs and limbs_k, male tail): "
          f"{time.time() - t0:.2f}s; C_used={c.layout_C()}, "
          f"Cp={c.Wp.scale.shape[0]}, has_male={c.has_male}")
    results = []
    for chrom, bsnps in blocks:
        t0 = time.time()
        raw = eng.read_block_raw(bsnps)
        read_s = time.time() - t0
        out = {}
        for name, e in (("int8", eng), ("plain", plain)):
            e.prep_chrom(chrom)
            out[name] = e.test_raw_block_fused(raw, bsnps)[0]
        x = eng._fused_upload(raw)
        limbs_k = eng._fused_consts.Wp.limbs_k
        ms = _time_ms(lambda: kernels.fused_i8_products(x, limbs_k), 10)
        npb = eng.non_par_flags(bsnps)
        print(f"  chr{chrom} block: PGEN host read {read_s:.3f}s ({raw.nbytes / 1e6:.1f} MB "
              f"of BED-coded bytes); fused_i8 {ms:.3f} ms (median of 10); "
              f"{int(npb.sum())} of {len(bsnps)} variants non-PAR")
        ref = out["plain"]
        _assert_close(f"chr{chrom} LOG10P, int8 operand", out["int8"].logp,
                      ref.logp, LOG10P_TOL)
        _assert_close(f"chr{chrom} BETA, int8 operand", out["int8"].bhat,
                      ref.bhat, BETA_TOL)
        if chrom == 23:
            for name in ("af_t", "ns_t", "mac_t"):
                _assert_rel(f"chrX {name}, int8 operand", getattr(out["int8"], name),
                            getattr(ref, name), 1e-9)
            dip = np.minimum(ref.af_t * 2 * ref.ns_t, 2 * ref.ns_t * (1 - ref.af_t))
            if not (np.abs(ref.mac_t - dip)[npb] > 0.5).all():
                raise AssertionError("chrX non-PAR MAC is not the hemizygous MAC")
        results.append((bsnps, out["int8"]))

    pd = eng.pd
    for what, split, gz in (("split .regenie.gz (the CLI's)", True, True),
                            ("split .regenie", True, False),
                            ("merged .regenie (--no-split)", False, False),
                            ("merged .regenie.gz", False, True)):
        params.split_by_pheno, params.gz_out = split, gz
        params.out_prefix = f"{tmp}/w_{int(split)}{int(gz)}"
        t0 = time.time()
        writers, paths = setup_writers(params, pd.pheno_names, pd.pheno_pass)
        for bsnps, r in results:
            write_block_rows(params, pd, writers, bsnps, r, "ADD", eng.model_type())
        for fh in {id(w): w for w in writers}.values():
            fh.close()
        dt = time.time() - t0
        size = sum(os.path.getsize(p_) for p_ in paths)
        print(f"  write of {2 * B} variants x {f['P']} traits, {what}: {dt:.2f}s, "
              f"{len(paths)} file(s), {size / 1e6:.1f} MB")
    eng.gd.close()
    return launches


GENE_TESTS = ("ADD", "ADD-SKATO", "ADD-ACATV", "ADD-BURDEN-ACAT")


def _gene_rows(path):
    """A gene-based .regenie file's (header fields, data rows split), after
    its ##MASKS= line and the single-trait header."""
    rows = _read_text(path).splitlines()
    if not rows or not rows[0].startswith('##MASKS=<M1="LoF";M2="LoF,missense";'):
        raise AssertionError(f"{path}: no ##MASKS line")
    head = rows[1].split()
    if head[:6] != ["CHROM", "GENPOS", "ID", "ALLELE0", "ALLELE1", "A1FREQ"] \
            or head[-2:] != ["LOG10P", "EXTRA"]:
        raise AssertionError(f"{path}: header {rows[1]!r}")
    return head, [r.split() for r in rows[2:]]


def _check_gene_files(out, n_traits, n_inc, set_ids):
    """The [gene slice]'s files are well formed: per trait the ##MASKS
    line and the header, then for every set its burden rows (one per mask
    M1-M3 and bin: singleton, 0.001, 0.01, all), its SKATO and ACAT-V
    rows (the masks of the 'all' bin, the VC bin) and one BURDEN-ACAT
    row, no (ID, TEST) twice, every number finite (LOG10P >= 0). The 40
    complete traits test the same masks. Returns the row count per TEST
    of the files together and the masks per bin."""
    bins = ("singleton", "0.001", "0.01", "all")
    totals, per_bin, ref = {}, {}, None
    for p in range(n_traits):
        path = f"{out}_Y{p + 1}.regenie"
        head, rows = _gene_rows(path)
        iT, iN = head.index("TEST"), head.index("N")
        seen, sets_with = set(), {}
        for t in rows:
            if len(t) != len(head):
                raise AssertionError(f"{path}: row {t}")
            test, rid = t[iT], t[2]
            if test not in GENE_TESTS:
                raise AssertionError(f"{path}: unexpected test {test}")
            if (rid, test) in seen:
                raise AssertionError(f"{path}: {rid} {test} twice")
            seen.add((rid, test))
            int(t[0]), int(t[1]), int(t[iN])
            if not float(t[head.index("LOG10P")]) >= 0:
                raise AssertionError(f"{path}: LOG10P of {t}")
            for x in t[5:iN] + t[iT + 1 : -1]:
                if x != "NA" and not math.isfinite(float(x)):
                    raise AssertionError(f"{path}: {t}")
            if test == "ADD-BURDEN-ACAT":
                sid = rid
            else:
                sid, mask, b = rid.split(".", 2)
                if mask not in ("M1", "M2", "M3") or b not in bins:
                    raise AssertionError(f"{path}: mask ID {rid}")
                if test != "ADD" and b != "all":
                    raise AssertionError(f"{path}: {test} row of bin {b}")
                if test == "ADD" and p == 0:
                    per_bin[b] = per_bin.get(b, 0) + 1
            sets_with.setdefault(sid, set()).add(test)
            totals[test] = totals.get(test, 0) + 1
        if set(sets_with) != set(set_ids):
            raise AssertionError(f"{path}: sets {sorted(set(set_ids) - set(sets_with))} "
                                 "have no rows")
        for sid, tests in sets_with.items():
            if not {"ADD", "ADD-BURDEN-ACAT"} <= tests:
                raise AssertionError(f"{path}: set {sid} has only {tests}")
        if p >= n_inc:
            masks = sorted(k for k in seen if k[1] == "ADD")
            if ref is not None and masks != ref:
                raise AssertionError(f"{path}: another mask list than Y{n_inc + 1}")
            ref = masks
    return totals, per_bin


def gene_slice_phase(tmp):
    """Gene-based Step 2 at full width on the card: one CLI run with
    --set-list (the exome-like BED of GENE: burden masks M1-M3 in the
    bins singleton, 0.001, 0.01 and all, SKATO and ACAT-V, BURDEN-ACAT),
    the sets' VC products in buckets of GENE['bucket'] and the stage table
    on (REGENIE_TPU_GENE_PROFILE=1). No hand-written kernel launches (the
    launch counts set to 0 just before the run and read just after): the
    burden masks go through the dense scorer and the VC products are
    float64 torch batched products. The 50 files are well formed
    (_check_gene_files). Then the first bucket's products again, on the
    card (timed against their FP64 bound) and on the CPU: GtG, GtX and GtY
    within F64_SUM_BAR of the same products taken on absolute values.
    Returns the launches (all 0)."""
    import torch

    from regenie_tpu_torch.io.bed import decode_bed_bytes
    from regenie_tpu_torch.models import skat
    from regenie_tpu_torch.ops import vc_batch

    f = FULL
    prefix = f"{tmp}/geno"
    n_var = sum(n for _, n in GENE["chroms"])
    set_ids = [ln.split()[0] for ln in open(f"{tmp}/sets.txt")]
    print(f"  BED file {os.path.getsize(prefix + '.bed') / 1e6:.1f} MB: {n_var} "
          f"variants in {len(set_ids)} sets of {GENE['set_size']}")
    out = f"{tmp}/gene"
    argv = ["--step", "2", "--bed", prefix, "--phenoFile", f"{tmp}/pheno.txt",
            "--covarFile", f"{tmp}/covar.txt", "--ignore-pred",
            "--set-list", f"{tmp}/sets.txt", "--anno-file", f"{tmp}/anno.txt",
            "--mask-def", f"{tmp}/masks.txt", "--aaf-bins", GENE["aaf_bins"],
            "--vc-tests", GENE["vc_tests"], "--joint", GENE["joint"], "--out", out]
    first = []
    orig = skat.vc_products_batched

    def keep_first(params, eng, preps):
        if not first:
            first.append([p for p in preps if p is not None])
        return orig(params, eng, preps)

    os.environ.pop("REGENIE_TPU_TORCH_DEVICE", None)
    os.environ["REGENIE_TPU_GENE_BUCKET"] = str(GENE["bucket"])
    os.environ["REGENIE_TPU_GENE_PROFILE"] = "1"
    skat.vc_products_batched = keep_first
    try:
        _reset_counts()
        t0 = time.time()
        params, eng, log = run_cli_kept(argv)
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = _read_counts()
    finally:
        skat.vc_products_batched = orig
        for k in ("REGENIE_TPU_GENE_BUCKET", "REGENIE_TPU_GENE_PROFILE"):
            os.environ.pop(k)
    if any(counts.values()):
        raise AssertionError(f"gene-based run launched kernels: {counts}")
    totals, per_bin = _check_gene_files(out, f["P"], f["n_inc"], set_ids)
    print(f"  gene-based CLI run: {f['P']} well-formed files, rows {totals}; "
          f"burden masks per bin (Y1) {per_bin}; launches: {len(counts)} kernels, "
          "0 each (no hand-written kernel on this path)")
    print(f"  run wall time {wall:.2f}s = {len(set_ids) / wall:.3f} sets/s "
          f"({n_var} variants, {f['P']} traits; run-up and output included) on "
          f"{card_line()}")
    i = log.index(" * gene-based stage attribution (s):")
    for ln in log[i:]:
        if ln.startswith("     "):
            print(f"  stage {ln.strip()}")

    # the first bucket's largest equal-pad group, card against CPU
    preps = [p for p in first[0] if p.codes is not None]
    groups = {}
    for p in preps:
        u = p.ur_dense.shape[1]
        groups.setdefault((p.chrom, vc_batch._pad_dim(p.n_main),
                           0 if u == 0 else vc_batch._pad_dim(u, 1)), []).append(p)
    (chrom, Mm, U), ps = max(groups.items(), key=lambda kv: len(kv[1]))
    ps = ps[: vc_batch.SLOTS_PER_CALL]
    X, ind = eng.pd.new_cov, eng.pd.ind_in_analysis
    eng.prep_chrom(chrom)
    cache = eng._vc_cache
    cache.set_residuals(chrom, eng.res, X)
    args = ([p.codes for p in ps], [p.ur_dense for p in ps], [p.flip for p in ps],
            [p.imp for p in ps], [p.wvec for p in ps])
    ops = vc_batch.pack_slots(cache, *args, Mm, U)
    run = lambda: vc_batch._vc_chunks(*ops, cache.ind_c, cache.X_c, cache.Y_c)  # noqa: E731
    ms = _time_ms(run, 5)
    t0 = time.time()
    gpu = vc_batch.bucket_products(cache, *args)
    call_s = time.time() - t0
    cpu_cache = vc_batch.VCDeviceCache(X, ind, "cpu")
    cpu_cache.set_residuals(chrom, eng.res, X)
    t0 = time.time()
    cpu = vc_batch.bucket_products(cpu_cache, *args)
    cpu_s = time.time() - t0
    N, K, P = X.shape[0], X.shape[1], eng.res.shape[1]
    worst = 0.0
    for p, g, c in zip(ps, gpu, cpu):
        G = decode_bed_bytes(p.codes, N).astype(np.float64)
        G = np.where(G == -3, p.imp[:, None], np.where(p.flip[:, None], 2 - G, G))
        A = np.abs(np.concatenate([(G * ind * p.wvec[:, None]).T, p.ur_dense], axis=1))
        bars = (A.T @ A, A.T @ np.abs(X), A.T @ np.abs(eng.res))
        for a, b, bar in zip(g, c, bars):
            worst = max(worst, float((np.abs(a - b) / np.maximum(F64_SUM_BAR * bar,
                                                                   1e-300)).max()))
    # the bound counts each set's own columns (m_i + u_i), not the padding
    S, Mt = len(ps), Mm + U
    mt = [p.n_main + p.ur_dense.shape[1] for p in ps]
    ops_n = sum(2.0 * m * (m + K + P) * N for m in mt)
    nbytes = (sum(p.n_main for p in ps) * (N + 3) // 4 + 8 * N * (K + P + 1)
              + 8 * N * sum(p.ur_dense.shape[1] for p in ps)
              + sum(8 * m * (m + K + P) for m in mt))
    bound_ms, bound_by = _bound(ops_n, nbytes, PEAK_FP64_TC_OPS)
    print(f"  first bucket's products (chr{chrom}, {S} sets in one call of "
          f"{vc_batch.SLOTS_PER_CALL} slots padded to Mt={Mt}, the sets' own "
          f"m_i + u_i {min(mt)} to {max(mt)}: GtG | GtX | GtY over "
          f"{cache.nch} chunks of {vc_batch.CHUNK_SAMPLES}): card {ms:.3f} ms (median "
          f"of 5) against the FP64 bound {bound_ms:.3f} ms ({bound_by}; sum of 2 "
          f"(m_i + u_i) (m_i + u_i + K + P) N = {ops_n:.3e} operations); the call "
          f"with packing, upload and copy {call_s:.3f}s; the CPU {cpu_s:.2f}s")
    print(f"  first bucket's products, card against CPU: largest share of "
          f"F64_SUM_BAR ({F64_SUM_BAR:g} x the product on absolute values) "
          f"{worst:.3e}")
    if not worst <= 1.0:
        raise AssertionError(f"VC products card vs CPU: {worst:.3e} x the bar")
    eng.gd.close()
    return counts


# interaction tests at full width ([interaction slice]): GxE with the
# gene slice's covariate C1 on its exome-like BED (60% rare: the HLM takes
# the SNPs of MAC < --rare-mac 1000, the HC3 sandwich the others), the
# default robust settings; the depth cut to chromosome 1 (192 variants),
# never N, P or K
INTERACTION = dict(chrom="1", evar="C1", bsize=192)
INT_TESTS = ("ADD-CONDTL", "ADD-INT_SNP", "ADD-INT_SNPxC1", "ADD-INT_2DF")
HLM_OBJ_REL = 1e-8  # L-BFGS-B stops on a relative decrease of ~2.2e-9


def _check_int_file(path):
    """A trait's file of a one-block interaction run: well formed
    (_check_rows' header and fields), the block's marginal ADD-CONDTL rows
    first (its SNPs past the MAC filter), then every tested SNP's three
    interaction rows in order and in the marginal rows' SNP order.
    Returns (marginal rows, SNPs with interaction rows)."""
    rows = _read_text(path).splitlines()
    head = rows[0].split()
    _check_rows(path, len(rows) - 1)
    iT = head.index("TEST")
    tests = [r.split()[iT] for r in rows[1:]]
    ids = [r.split()[2] for r in rows[1:]]
    k = next((i for i, t in enumerate(tests) if t != INT_TESTS[0]), len(tests))
    rest = tests[k:]
    if INT_TESTS[0] in rest or len(rest) % 3 or any(
            rest[i : i + 3] != list(INT_TESTS[1:]) for i in range(0, len(rest), 3)):
        raise AssertionError(f"{path}: rows out of place")
    got = ids[k::3]
    order = {s: i for i, s in enumerate(ids[:k])}
    if [order[s] for s in got] != sorted(order[s] for s in got):
        raise AssertionError(f"{path}: interaction rows out of SNP order")
    return k, got


def _wald_bars(tau, V, tau_ref, V_ref):
    """Largest share of the smoke's bars between two sets of coefficients
    [..., nc] and covariances [..., nc, nc]: each coefficient's 1-df
    LOG10P within LOG10P_TOL, the coefficient within BETA_TOL + 1e-5 of
    its magnitude."""
    from regenie_tpu_torch.utils.stats import chisq_neglog10

    d, dr = np.diagonal(V, axis1=-2, axis2=-1), np.diagonal(V_ref, axis1=-2, axis2=-1)
    lp, lpr = chisq_neglog10(tau**2 / d), chisq_neglog10(tau_ref**2 / dr)
    return max(float((np.abs(lp - lpr) / LOG10P_TOL).max()),
               float((np.abs(tau - tau_ref) / (BETA_TOL + 1e-5 * np.abs(tau_ref))).max()))


def interaction_slice_phase(tmp):
    """GxE at full width on the card: one CLI run of --interaction C1 on
    the [gene slice]'s BED (N = 400,000, P = 50 of which 10 incomplete,
    K = 20), chromosome 1, the default robust settings (HC3 for common
    SNPs, the HLM below --rare-mac 1000), split output. No hand-written
    kernel launches (the launch counts set to 0 just before the run and
    read just after), both routes run (the log's counts), the 50 files
    are well formed (_check_int_file). Then, through the run's engine:
    the block's robust chunk (the run's fixed chunk size) timed on the
    card against its FP64 or byte bound, and 4 of its SNPs, and an HLM
    chunk of up to 8 rare SNPs on 3 traits (the card's null fits as
    inputs on both sides), card against CPU within the smoke's bars
    (_wald_bars); the HLM null of 2 traits fitted again on the CPU (the
    numpy twin): both converged, objectives within HLM_OBJ_REL. Returns
    the launches (all 0)."""
    import torch
    from types import SimpleNamespace

    from regenie_tpu_torch.io.geno import make_blocks
    from regenie_tpu_torch.models import interaction as pint

    f = FULL
    prefix = f"{tmp}/geno"
    out = f"{tmp}/int"
    argv = ["--step", "2", "--bed", prefix, "--phenoFile", f"{tmp}/pheno.txt",
            "--covarFile", f"{tmp}/covar.txt", "--ignore-pred", "--chr",
            INTERACTION["chrom"], "--bsize", str(INTERACTION["bsize"]),
            "--interaction", INTERACTION["evar"], "--out", out]
    os.environ.pop("REGENIE_TPU_TORCH_DEVICE", None)
    _reset_counts()
    t0 = time.time()
    params, eng, log = run_cli_kept(argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = _read_counts()
    if any(counts.values()):
        raise AssertionError(f"interaction run launched kernels: {counts}")
    line = next(ln for ln in log if ln.startswith(" * interaction tests:"))
    n_rob = int(line.split("robust ")[1].split()[0])
    n_hlm = int(line.split("HLM ")[1].split()[0])
    if not (n_rob > 0 and n_hlm > 0):
        raise AssertionError(f"interaction run: both routes must run: {line}")
    if "dense scorer on cuda" not in "\n".join(log):
        raise AssertionError("interaction run: no dense route on cuda")
    ic = eng.int_counts
    loop_s = float(next(ln for ln in log if ln.startswith(" * block loop:"))
                   .split(" in ")[1].rstrip("s"))
    blocks = make_blocks(eng.gd, params.block_size)
    M = sum(len(b) for _, b in blocks)
    names = eng.pd.pheno_names
    checked = [_check_int_file(f"{out}_{n}.regenie") for n in names]
    n_marg = [k for k, _ in checked]
    n_int = [len(g) for _, g in checked]
    if min(n_int) == 0:
        raise AssertionError("interaction run: a trait without interaction rows")
    h = eng.interaction.hlm
    fits = [x for x in h.fits if x is not None]
    print(f"  interaction CLI run (--interaction C1, chr{INTERACTION['chrom']}, {M} "
          f"variants): {len(names)} well-formed files, marginal rows per trait "
          f"{min(n_marg)} to {max(n_marg)}, the SNPs with interaction rows "
          f"{min(n_int)} to {max(n_int)}; robust {n_rob} SNPs, HLM {n_hlm} "
          f"SNPs; launches: {len(counts)} kernels, 0 each")
    print(f"  run wall time {wall:.2f}s = {M / wall:.2f} variants/s (run-up, HLM null "
          f"fits and output included) on {card_line()}")
    other = loop_s - eng.hlm_null_s - ic["robust_s"] - ic["hlm_s"] - ic["rows_s"]
    for stage, secs in (("run-up and after the loop (wall - block loop)", wall - loop_s),
                        (f"HLM null fits ({len(fits)} traits, L-BFGS-B on the host, "
                         f"{sum(x[3] for x in fits)} objective evaluations on the card)",
                         eng.hlm_null_s),
                        ("robust batches (HC3 sandwich, card)", ic["robust_s"]),
                        ("HLM batches (card)", ic["hlm_s"]),
                        ("mixed-block rows (Python)", ic["rows_s"]),
                        ("the rest of the block loop (read, marginal scores and rows)",
                         other)):
        print(f"  stage {stage}: {secs:.3f}s")

    # the block again through the run's engine
    chrom, bsnps = blocks[0]
    eng.prep_chrom(chrom)
    result, _ = eng.test_raw_block(eng.upload_dense(eng.read_block_dense(bsnps), bsnps),
                                   bsnps)
    G, Gr = eng.last_G_imputed, eng.last_G_int
    mac = result.af_t * 2 * result.ns_t
    mac = np.minimum(mac, 2 * result.ns_t - mac)
    rare = (mac < params.rare_mac_inter).any(axis=1) & ~result.ignored
    rob = np.flatnonzero(~rare & ~result.ignored)
    S = eng._int_chunks["robust"]
    chunk = list(rob[:S]) + [rob[min(S, len(rob)) - 1]] * max(0, S - len(rob))
    c = pint.RobustConsts(eng)
    idx = torch.as_tensor(chunk, device=G.device)
    sd = float(params.n_analyzed - eng.pd.new_cov.shape[1])
    ms, outs = _events_ms(lambda: pint.robust_batch(G[idx], Gr[idx], c.E, c.E_res, c.cov,
                                                   c.res, c.maskf, sd, False), 5)
    N, P = G.shape[1], c.res.shape[1]
    Ki, C = c.E.shape[1], c.cov.shape[1]
    nc = c.E_res.shape[1] + 1 + Ki
    ops = S * N * (4.0 * Ki * C + 4 * nc * nc + nc + P * (4.0 * nc + 2 * nc * nc + 4))
    nbytes = 8.0 * (2 * S * N + N * (Ki + c.E_res.shape[1] + C) + 2 * N * P)
    bound_ms, bound_by = _bound(ops, nbytes, PEAK_FP64_TC_OPS)
    print(f"  robust chunk ({S} SNPs, the run's fixed shape; N={N}, P={P}, nc={nc}): "
          f"card {ms:.3f} ms (median of 5) against its bound {bound_ms:.3f} ms "
          f"({bound_by}: {ops:.3e} FP64 operations, {nbytes / 1e9:.3f} GB)")
    host = [o.cpu().numpy() for o in outs]
    cpu = [o.numpy() for o in pint.robust_batch(
        G[idx[:4]].cpu(), Gr[idx[:4]].cpu(), c.E.cpu(), c.E_res.cpu(), c.cov.cpu(),
        c.res.cpu(), c.maskf.cpu(), sd, False)]
    tau, V3 = host[3][:4].transpose(0, 2, 1), host[4][:4]
    worst_r = _wald_bars(tau, V3, cpu[3].transpose(0, 2, 1), cpu[4])
    hl = np.flatnonzero(rare)[:8]
    gh = G[torch.as_tensor(hl, device=G.device)]
    Vlin = torch.as_tensor(h.Vlin, device=G.device)
    worst_h = 0.0
    for ph in (0, 1, f["P"] - 1):
        args = tuple(torch.as_tensor(a, device=G.device) for a in (
            Vlin[None] * gh[:, :, None], h.Dinv_sqrt[:, ph], h.Px[ph], h.yres[:, ph]))
        hm, (Dm, Vm, bh) = _events_ms(lambda: pint.hlm_batch(*args), 3)
        Dc, Vc, bc = (x.numpy() for x in pint.hlm_batch(*(a.cpu() for a in args)))
        worst_h = max(worst_h, _wald_bars(bh.cpu().numpy(), Vm.cpu().numpy(), bc, Vc))
    print(f"  card against CPU on the card's inputs (the CPU given the card's null "
          f"fits): 4 SNPs of the robust chunk x {P} traits, largest share of the bars "
          f"{worst_r:.3e}; an HLM chunk of {len(hl)} rare SNPs x 3 traits "
          f"({hm:.3f} ms a trait on the card), {worst_h:.3e}")
    if not (worst_r <= 1.0 and worst_h <= 1.0):
        raise AssertionError("interaction chunks: card against CPU beyond the bars")

    # the HLM null of two traits again on the CPU (the numpy twin)
    pd, st = eng.pd, eng.interaction
    sel = np.zeros(f["P"], bool)
    sel[[0, f["P"] - 1]] = True
    st2 = pint.InteractionState(E=st.E, hlm=pint._hlm_prep(params, pd, st))
    pdv = SimpleNamespace(phenotypes=pd.phenotypes, pheno_pass=sel, Neff=pd.Neff,
                          masked_indivs=pd.masked_indivs, new_cov=pd.new_cov)
    t0 = time.time()
    pint.hlm_fit_null(params, pdv, st2, None, print, None)
    cpu_s = time.time() - t0
    for ph in np.flatnonzero(sel):
        a, b = h.fits[ph], st2.hlm.fits[ph]
        gap = abs(a[0] - b[0]) / abs(b[0])
        dd = float(np.abs(np.asarray(torch.as_tensor(h.Dinv_sqrt[:, ph]).cpu())
                          - st2.hlm.Dinv_sqrt[:, ph]).max())
        print(f"  HLM null of {pd.pheno_names[ph]}: card objective {a[0]:.12g} ({a[2]} "
              f"iterations, {a[3]} evaluations), CPU {b[0]:.12g} ({b[2]}, {b[3]}); "
              f"relative gap {gap:.3e}, largest |dDinv_sqrt| {dd:.3e}")
        if not (a[1] and b[1] and gap <= HLM_OBJ_REL):
            raise AssertionError(f"HLM null of {pd.pheno_names[ph]}: card {a}, CPU {b}")
    print(f"  the CPU's two HLM null fits took {cpu_s:.2f}s; the card's {len(fits)} "
          f"took {eng.hlm_null_s:.2f}s")
    eng.gd.close()
    return counts


def bt_interaction_real_depth(dev):
    """The BT interaction refits alone at full width: one fixed-shape chunk
    (the engine's BT chunk size) of bt_design and bt_trait_fit (the two
    masked IRLS passes, the weighted Gram's eigh) on synthetic data at
    N = 400,000 for P = 50 traits (prevalence 5-30%, null offsets from
    the covariates), timed on the card; two (SNP, trait) refits held
    against the CPU twin (flags equal, coefficients within BETA_TOL +
    1e-5 of their magnitude)."""
    import torch

    from regenie_tpu_torch.models import interaction as pint

    f = FULL
    N, P, K = f["N"], f["P"], f["K"]
    gen = torch.Generator(device=dev).manual_seed(41)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev, dtype=torch.float64)

    def rand(*shape):
        return torch.rand(*shape, generator=gen, device=dev, dtype=torch.float64)

    free, _ = torch.cuda.mem_get_info(dev)
    C = 2  # [G, GxE] in the conditional mode
    S = int(min(256, max(1, free / 10 / (8.0 * N * C * 8))))
    cov = torch.linalg.qr(torch.cat([torch.ones(N, 1, dtype=torch.float64, device=dev),
                                     randn(N, K - 1)], 1))[0]
    E = randn(N, 1)
    af = 0.02 + 0.48 * rand(S, 1)
    g = (rand(S, N) < af).to(torch.float64) + (rand(S, N) < af).to(torch.float64)
    prev = torch.linspace(0.05, 0.3, P, dtype=torch.float64, device=dev)
    off = (cov @ (0.3 * randn(K, P))) + torch.log(prev / (1 - prev))[None, :]
    Y = (rand(N, P) < torch.sigmoid(off)).to(torch.float64)
    mf = torch.ones(N, dtype=torch.float64, device=dev)
    torch.cuda.synchronize()
    t0 = time.time()
    H, _, _ = pint.bt_design(g, cov, E, torch.zeros(N, 0, dtype=torch.float64,
                                                       device=dev), N - K)
    torch.cuda.synchronize()
    design_s = time.time() - t0
    per, ok_n, fits = [], 0, {}
    for ph in range(P):
        t0 = time.time()
        b, ok, Dmin, Vmat, _, _ = pint.bt_trait_fit(H, Y[:, ph], off[:, ph], mf, 30, 1e-6)
        torch.cuda.synchronize()
        per.append(time.time() - t0)
        ok_n += int(ok.sum())
        if ph in (0, P - 1):
            fits[ph] = (b.cpu().numpy(), ok.cpu().numpy())
    print(f"  BT interaction refits at N={N}, P={P}: a chunk of {S} SNPs (the engine's "
          f"fixed BT shape), design {design_s:.3f}s, the two IRLS passes and the eigh "
          f"{sum(per):.3f}s for {P} traits ({1e3 * np.mean(per):.1f} ms a trait, "
          f"{1e3 * max(per):.1f} ms the slowest); {ok_n} of {S * P} refits converged; "
          f"on {card_line()}")
    worst = 0.0
    for ph, s in ((0, 0), (P - 1, S - 1)):
        Hc, _, _ = pint.bt_design(g[s : s + 1].cpu(), cov.cpu(), E.cpu(),
                                  torch.zeros(N, 0, dtype=torch.float64), N - K)
        b, ok, *_ = pint.bt_trait_fit(Hc, Y[:, ph].cpu(), off[:, ph].cpu(), mf.cpu(),
                                      30, 1e-6)
        bg, okg = fits[ph][0][s], fits[ph][1][s]
        if bool(ok[0]) != bool(okg):
            raise AssertionError(f"BT refit (SNP {s}, trait {ph}): flags differ")
        worst = max(worst, float((np.abs(bg - b[0].numpy())
                                  / (BETA_TOL + 1e-5 * np.abs(b[0].numpy()))).max()))
    print(f"  BT refits card against CPU on 2 (SNP, trait) pairs: flags equal, largest "
          f"share of the coefficient bar {worst:.3e}")
    if not worst <= 1.0:
        raise AssertionError("BT interaction refits: card against CPU beyond the bar")


def _vcov_close(a_dir, a_prefix, b_prefix):
    """Every .vcov file of the card's run against the CPU's: the same
    files, every entry within BETA_TOL + 1e-5 of its magnitude. Returns
    the file count."""
    import glob

    got = sorted(glob.glob(f"{a_prefix}_*.vcov"))
    want = sorted(glob.glob(f"{b_prefix}_*.vcov"))
    if len(got) != len(want) or not got:
        raise AssertionError(f"--print-vcov: {len(got)} files on the card, {len(want)} "
                             "on the CPU")
    for fa in got:
        a, b = np.loadtxt(fa), np.loadtxt(fa.replace(a_prefix, b_prefix))
        if a.shape != b.shape or (np.abs(a - b) > BETA_TOL + 1e-5 * np.abs(b)).any():
            raise AssertionError(f"{fa}: differs beyond the bar")
    return len(got)


def interaction_cross_check(tmp, prefix, P, sub, geno):
    """Interaction runs at N=2,000 (--remove; chromosome 2, 200 variants)
    on the card and on the CPU, every field within its bar: QT --interaction on the continuous C1 (HC3
    and the HLM), on a categorical E3 with --no-condtl --print-vcov (the
    .vcov files too), --force-hc4, --no-robust; GxG --interaction-snp from
    the BED and from --interaction-file bgen; GxPRS --interaction-prs on
    the two-step workflow's own _pred.list; BT --interaction with --firth
    --approx and with --spa. The CPU runs take the per-SNP routes
    (REGENIE_TPU_NO_BATCH_INT=1): the oracle of the card's batched ones,
    rows in the same order; but with --print-vcov, where the card writes
    a mixed block's HLM rows before its robust ones as the JAX package's
    batched route does, the CPU keeps its default routing, which writes
    them so. No kernel launches on the card."""
    rng = np.random.default_rng(13)
    lines = open(f"{tmp}/covar.txt").read().splitlines()
    lv = rng.choice(["a", "b", "c"], size=len(lines) - 1, p=[0.5, 0.3, 0.2])
    with open(f"{tmp}/covar_cat.txt", "w") as fh:
        fh.write(lines[0] + " E3\n" + "".join(f"{ln} {v}\n" for ln, v in
                                                zip(lines[1:], lv)))
    split = [f"_Y{p + 1}.regenie" for p in range(P)]
    runs = {
        "QT --interaction C1": (["--interaction", "C1"], split),
        "QT categorical E3 --no-condtl --print-vcov": (
            ["--interaction", "E3", "--catCovarList", "E3", "--covarFile",
             f"{tmp}/covar_cat.txt", "--no-condtl", "--print-vcov"], split),
        "QT --interaction C1 --force-hc4": (["--interaction", "C1", "--force-hc4"], split),
        "QT --interaction C1 --no-robust": (["--interaction", "C1", "--no-robust"], split),
        "GxG --interaction-snp": (["--interaction-snp", "v450"], split),
        "GxG --interaction-file bgen": (
            ["--interaction-snp", "v450", "--interaction-file", f"bgen,{geno['bgen']}",
             "--interaction-file-sample", f"{sub['bgen']}/geno.sample"], split),
        "GxPRS --interaction-prs": (
            ["--interaction-prs", "--phenoColList", "Y1", "--pred",
             f"{tmp}/ts_kfold_cpu_pred.list"], ["_Y1.regenie"]),
        "BT --interaction C1 --firth --approx": (
            ["--bt", "--interaction", "C1", "--firth", "--approx"], split),
        "BT --interaction C1 --spa": (["--bt", "--interaction", "C1", "--spa"], split),
    }
    for i, (what, (args, outs)) in enumerate(runs.items()):
        table = "pheno_bt.txt" if "--bt" in args else "pheno.txt"
        cov = [] if "--covarFile" in args else ["--covarFile", f"{tmp}/covar.txt"]
        pred = [] if "--pred" in args else ["--ignore-pred"]
        common = ["--step", "2", "--bed", prefix, "--phenoFile", f"{tmp}/{table}", *cov,
                  "--remove", f"{tmp}/remove.txt", *pred, "--bsize", "256", "--chr", "2",
                  *args]
        gpu, cpu = f"{tmp}/int{i}_gpu", f"{tmp}/int{i}_cpu"
        os.environ.pop("REGENIE_TPU_TORCH_DEVICE", None)
        _reset_counts()
        run_cli(common + ["--out", gpu])
        counts = _read_counts()
        if any(counts.values()):
            raise AssertionError(f"{what}: kernels launched: {counts}")
        log = open(gpu + ".log").read()
        ln = next(x for x in log.splitlines() if x.startswith(" * interaction tests:"))
        os.environ["REGENIE_TPU_TORCH_DEVICE"] = "cpu"
        if "--print-vcov" not in args:
            os.environ["REGENIE_TPU_NO_BATCH_INT"] = "1"
        try:
            run_cli(common + ["--out", cpu])
        finally:
            os.environ.pop("REGENIE_TPU_TORCH_DEVICE")
            os.environ.pop("REGENIE_TPU_NO_BATCH_INT", None)
        worst = max(_compare_files(gpu + o, cpu + o) for o in outs)
        rows = len(_read_text(cpu + outs[0]).splitlines()) - 1
        vc = (f"; {_vcov_close(tmp, gpu, cpu)} .vcov files within the bar"
              if "--print-vcov" in args else "")
        routes = ln.split(": ", 1)[1].split("; HLM null")[0].split(", mixed")[0]
        print(f"  {what}: card vs CPU, {len(outs)} traits x {rows} rows: every field "
              f"within its bar (largest share of the bar used {worst:.3f}){vc}; "
              f"card routes: {routes}")


def step1_options_cross_check(tmp, prefix, P):
    """The Step-1 options at N=2,000 (--remove) on the card and on the
    CPU: --prior-alpha 0.5, --test-l0 (K-fold), --select-l0 FILE
    (LOOCV), --print (K-fold and --loocv, one trait) and --debug on binary
    traits (LOOCV below 5,000 samples); every .loco value and every number
    of the --print files within one unit of its sixth significant digit,
    the --debug inputs (_y.txt, _x.txt, _offset.txt) the same bytes. No
    kernel launches."""
    nb = 6  # 600 variants in blocks of 100
    rng = np.random.default_rng(14)
    pv = rng.uniform(0.0, 1.0, size=(nb, P))
    pv[2] = 8.0
    with open(f"{tmp}/l0_pv.txt", "w") as fh:
        for b in range(nb):
            fh.write(f"{1 if b < 4 else 2} {b + 1} " + " ".join(f"{x:.6f}" for x in pv[b])
                     + "\n")
    runs = {
        "--prior-alpha 0.5": (["--prior-alpha", "0.5"], "pheno.txt", [], P),
        "--test-l0": (["--test-l0", "--l0-pval-thr", "0.01"], "pheno.txt", [], P),
        "--select-l0 FILE --loocv": (["--select-l0", f"{tmp}/l0_pv.txt", "--loocv"],
                                     "pheno.txt", [], P),
        "--print (K-fold)": (["--print", "--phenoColList", "Y1"], "pheno.txt",
                             ["_level1.betas"], 1),
        "--print --loocv": (["--print", "--phenoColList", "Y1", "--loocv"], "pheno.txt",
                            ["_step1_betas.txt"], 1),
        "BT --debug": (["--bt", "--debug"], "pheno_bt.txt",
                       ["_y.txt", "_x.txt", "_offset.txt"], P),
    }
    for i, (what, (args, table, files, n)) in enumerate(runs.items()):
        common = ["--step", "1", "--bed", prefix, "--phenoFile", f"{tmp}/{table}",
                  "--covarFile", f"{tmp}/covar.txt", "--remove", f"{tmp}/remove.txt",
                  "--bsize", "100", *args]
        gpu, cpu = f"{tmp}/s1o{i}_gpu", f"{tmp}/s1o{i}_cpu"
        os.environ.pop("REGENIE_TPU_TORCH_DEVICE", None)
        _reset_counts()
        run_cli(common + ["--out", gpu])
        if any(_read_counts().values()):
            raise AssertionError(f"Step 1 {what}: kernels launched")
        os.environ["REGENIE_TPU_TORCH_DEVICE"] = "cpu"
        try:
            run_cli(common + ["--out", cpu])
        finally:
            os.environ.pop("REGENIE_TPU_TORCH_DEVICE")
        ndiff, worst = 0, 0.0
        for p in range(n):
            nd, w = _compare_loco(f"{gpu}_{p + 1}.loco", f"{cpu}_{p + 1}.loco")
            ndiff, worst = ndiff + nd, max(worst, w)
        extra = []
        for suf in files:
            a, b = open(gpu + suf, "rb").read(), open(cpu + suf, "rb").read()
            if suf.startswith("_") and suf.endswith(".txt") and "betas" not in suf:
                if a != b:
                    raise AssertionError(f"Step 1 {what}: {suf} differs")
                extra.append(f"{suf} the same bytes")
                continue
            ta, tb = a.decode().split(), b.decode().split()
            if len(ta) != len(tb):
                raise AssertionError(f"Step 1 {what}: {suf} differs in shape")
            w = 0.0
            for xa, xb in zip(ta, tb):
                if xa != xb:
                    w = max(w, _sig6_excess(xa, xb))
            if w > 1 + 1e-9:
                raise AssertionError(f"Step 1 {what}: {suf} beyond one unit of the "
                                     "sixth significant digit")
            extra.append(f"{suf} within {w:.3f} units")
        log = open(gpu + ".log").read()
        note = ("; top SNPs picked" if "top SNPs per trait" in log else
                "; blocks selected" if "blocks selected" in log else "")
        print(f"  Step 1 {what}: card vs CPU, {n} .loco files ({ndiff} values differ, "
              f"at most {worst:.3f} units of the sixth significant digit)"
              + "".join(f"; {e}" for e in extra) + note)


# what the tails of a gene-based run may move: the VC tests' inputs (score
# products, calibrations, the SKAT/SKATO inputs) must agree within
# TAIL_INPUT_BAR of their largest entry; a tails call whose results differ
# beyond rel 1e-9 is witnessed by WITNESS_DRAWS runs of the reference's own
# _skato_tests on its inputs scaled entry by entry by 1 + WITNESS_REL z (z
# standard normal, seeded): its key set must be one the reference gives,
# and each result's gap at most WITNESS_FACTOR x the reference's spread
TAIL_INPUT_BAR = 1e-12
WITNESS_DRAWS, WITNESS_REL, WITNESS_FACTOR = 32, 1e-15, 2.0


def _host(a):
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.array(a, copy=True)


def _rel_gap(a, b):
    """max |a - b| over the largest |a| (0 for two empty arrays)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if a.shape != b.shape:
        return math.inf
    if a.size == 0:
        return 0.0
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-300))


class TailTap:
    """What a gene-based run's tails read and gave, keyed by (kind, set
    ID, the call's index in the set), while installed (a context
    manager): "prod" the VC score products (Svals, Kmat) of each QT set
    (vc_finish's prep) and of each BT set and trait (skat._bt_products,
    or, for a package without it, the products bt_products(params, eng,
    GW_full) returns per trait), "corr" the Firth LRTs and SPA
    statistics that calibrate the BT VC tests (values, ok flags, "firth"
    or "spa"),
    "tails" each _skato_tests call (params, results before, inputs,
    results), "qr" each pivoted QR of the joint tests and GENE_P (the
    columns, the pivots).

    With replay (another run's TailTap), _skato_tests takes that run's
    inputs and results so far (a QT mask's ACAT-V) and the QR that run's
    pivots for the same key: the files this run writes are then its
    code's function of the other run's tail inputs (replay_matches)."""

    def __init__(self, skat, joint, firth, spa, replay=None, bt_products=None):
        self.mods = (skat, joint, firth, spa)
        self.replay, self.bt_products = replay, bt_products
        self.rec, self._n, self._undo, self._sid = {}, {}, [], None

    def _key(self, kind):
        k = (kind, self._sid)
        self._n[k] = self._n.get(k, -1) + 1
        return (kind, self._sid, self._n[k])

    def _wrap(self, mod, name, make):
        orig = getattr(mod, name)
        self._undo.append((mod, name, orig))
        setattr(mod, name, make(orig))

    def _in_set(self, rec_prod=False):
        def make(orig):
            def run(params, eng, vset, *a, **kw):
                self._sid = vset.ID
                if rec_prod and not a[0].is_bt:
                    self.rec[self._key("prod")] = (a[0].Svals.copy(), a[0].Kmat.copy())
                try:
                    return orig(params, eng, vset, *a, **kw)
                finally:
                    self._sid = None
            return run
        return make

    def _corr(self, name, ival, iok, good):
        def make(orig):
            def run(*a, **kw):
                out = orig(*a, **kw)
                if self._sid is not None:
                    ok = _host(out[iok]).astype(bool)
                    self.rec[self._key("corr")] = (_host(out[ival]),
                                                   ok if good else ~ok, name)
                return out
            return run
        return make

    def __enter__(self):
        skat, joint, firth, spa = self.mods
        self._wrap(skat, "vc_finish", self._in_set(rec_prod=True))
        for name in ("run_joint_tests", "run_gene_p"):
            self._wrap(joint, name, self._in_set())
        self._wrap(firth, "firth_snp_batch_auto", self._corr("firth", 2, 3, True))
        self._wrap(spa, "spa_batch_auto", self._corr("spa", 0, 2, False))

        def tails(orig):
            def run(params, results, *args):
                key = self._key("tails")
                if self.replay is not None:
                    _, before, args, _ = self.replay.rec[key]
                    results.clear()
                    results.update({k: v.copy() for k, v in before.items()})
                before = {k: v.copy(order="K") for k, v in results.items()}
                # copies in the arrays' own memory order: numpy's
                # reductions round differently along a strided axis
                args = tuple(a.copy(order="K") if isinstance(a, np.ndarray) else a
                             for a in args)
                orig(params, results, *args)
                self.rec[key] = (params, before, args,
                                 {k: v.copy() for k, v in results.items()})
            return run

        self._wrap(skat, "_skato_tests", tails)

        def qr(orig):
            def run(G, tol):
                q, r, piv = orig(G, tol)
                key = self._key("qr")
                if self.replay is not None:
                    piv = list(self.replay.rec[key][1])
                self.rec[key] = (np.array(G, copy=True), list(piv))
                return q, r, piv
            return run

        self._wrap(joint, "_qr_colperm", qr)
        if hasattr(skat, "_bt_products"):
            def bt(orig):
                def run(*a):
                    out = orig(*a)
                    self.rec[self._key("prod")] = (_host(out[2]), _host(out[3]))
                    return out
                return run

            self._wrap(skat, "_bt_products", bt)
        elif self.bt_products is not None:
            def bt_run(orig):
                def run(params, eng, vset, vc_masks, GW_full, *a):
                    for s, k in self.bt_products(params, eng, GW_full):
                        self.rec[self._key("prod")] = (s, k)
                    return orig(params, eng, vset, vc_masks, GW_full, *a)
                return run

            self._wrap(skat, "_run_vc_bt", bt_run)
        return self

    def __exit__(self, *exc):
        for mod, name, orig in reversed(self._undo):
            setattr(mod, name, orig)
        self._undo = []

    def of(self, kind):
        return {k: v for k, v in self.rec.items() if k[0] == kind}


def _results_gap(a, b):
    """The keys of two _skato_tests results whose [P, 2] values differ
    beyond rel 1e-9 (on max(1, |value|)), and whether the key sets differ."""
    keys = [k for k in a if k in b and (a[k].shape != b[k].shape or (
        np.abs(a[k] - b[k]) > 1e-9 * np.maximum(1.0, np.abs(a[k]))).any())]
    return keys, a.keys() != b.keys()


def tail_verdict(ref, got, ref_skat, corr_rtol):
    """Holds run `got`'s tails to run `ref`'s (TailTaps of the same
    inputs): the same calls; the products (Svals, Kmat) and the joint
    tests' QR columns within TAIL_INPUT_BAR of their largest entry, every
    _skato_tests kernel Km too and its scores Sm of sqrt(max diag Km),
    or within twice the calibrations' gap where that is larger (a BT
    kernel is scaled by its calibrations; the other arguments equal); the calibrations with the
    same flags and within corr_rtol[name] (relative, 1e-12 absolute below
    1); every tails call whose results differ beyond rel 1e-9 witnessed:
    the reference's own _skato_tests (ref_skat) on its inputs scaled by 1
    + r z (r the larger of WITNESS_REL and the call's own input gap) gives
    got's set of tests in one of WITNESS_DRAWS draws, and moves each
    result at least 1 / WITNESS_FACTOR of got's gap; every QR whose pivots
    differ by columns whose norms tie within 1e-12, so that rounding picks
    the order. Raises AssertionError; returns a summary dict: the worst
    product, input and calibration gaps and their counts, "gaps" [(set
    ID, what)] and "sets", the set IDs of the witnessed calls."""
    if ref.rec.keys() != got.rec.keys():
        diff = sorted(map(str, ref.rec.keys() ^ got.rec.keys()))[:6]
        raise AssertionError(f"tails calls differ: {diff}")
    out = {"prod": 0.0, "n_prod": 0, "inputs": 0.0, "n_tails": 0, "corr": 0.0,
           "n_corr": 0, "gaps": [], "sets": set()}
    for key, (s1, k1) in ref.of("prod").items():
        s2, k2 = got.rec[key]
        out["prod"] = max(out["prod"], _rel_gap(s1, s2), _rel_gap(k1, k2))
        out["n_prod"] += 1
    for key, (v1, ok1, name) in ref.of("corr").items():
        v2, ok2, _ = got.rec[key]
        if not np.array_equal(ok1, ok2):
            raise AssertionError(f"{key}: calibration flags differ")
        if ok1.any():
            d = float((np.abs(v1[ok1] - v2[ok1])
                       / np.maximum(np.abs(v1[ok1]), 1e-12 / corr_rtol[name])).max())
            if not d <= corr_rtol[name]:
                raise AssertionError(f"{key}: {name} calibrations differ by rel {d:.3e}")
            out["corr"] = max(out["corr"], d)
        out["n_corr"] += 1
    bar = max(TAIL_INPUT_BAR, 2 * out["corr"])
    for key, (g1, p1) in ref.of("qr").items():
        g2, p2 = got.rec[key]
        out["inputs"] = max(out["inputs"], _rel_gap(g1, g2))
        if p1 != p2:
            for g in (g1, g2):
                nrm = np.linalg.norm(g, axis=0)
                if not np.allclose(nrm, nrm[0], rtol=1e-12, atol=0):
                    raise AssertionError(f"{key}: pivots differ without a tie")
            out["sets"].add(key[1])
            out["gaps"].append((key[1], "joint tests' QR pivots (tied norms)"))
    rng = np.random.default_rng(0)
    for key, (params, before, a1, r1) in ref.of("tails").items():
        _, _, a2, r2 = got.rec[key]
        out["n_tails"] += 1
        for x, y in zip(a1[2:-1], a2[2:-1]):  # rho, nnz, P and the tests
            if not np.array_equal(x, y):
                raise AssertionError(f"{key}: tails argument {x!r} against {y!r}")
        # the scores Sm [P, m] against their own scale, sqrt of the
        # kernel's diagonal (a score is a sum with cancellation); the
        # kernel Km [m, m] against its largest entry
        (s1, k1), (s2, k2) = a1[:2], a2[:2]
        if s1.shape != s2.shape or k1.shape != k2.shape:
            raise AssertionError(f"{key}: tails inputs of other shapes")
        gap_in = max(float(np.abs(s1 - s2).max()
                           / max(math.sqrt(max(np.diag(k1).max(), 0.0)), 1e-300)),
                     _rel_gap(k1, k2))
        out["inputs"] = max(out["inputs"], gap_in)
        keys, keyset = _results_gap(r1, r2)
        if not keys and not keyset:
            continue
        rel = max(WITNESS_REL, gap_in)
        seen, spread = {tuple(sorted(r1))}, {}
        for _ in range(WITNESS_DRAWS):
            a = list(a1)
            for i in (0, 1):
                a[i] = a1[i] * (1 + rel * rng.standard_normal(a1[i].shape))
            a[1] = (a[1] + a[1].T) / 2
            res = {k: v.copy() for k, v in before.items()}
            with np.errstate(all="ignore"):
                ref_skat._skato_tests(params, res, *a)
            seen.add(tuple(sorted(res)))
            for k in res:
                if k in r1 and res[k].shape == r1[k].shape:
                    spread[k] = max(spread.get(k, 0.0),
                                    float(np.abs(res[k] - r1[k]).max()))
        if tuple(sorted(r2)) not in seen:
            raise AssertionError(f"{key}: tests {sorted(r2)}, the reference's "
                                 f"{sorted(seen)} under a {rel:.1e} perturbation")
        if keyset:
            out["gaps"].append((key[1], "tests on one side: " + ",".join(
                sorted(r1.keys() ^ r2.keys())) + f" (both in {WITNESS_DRAWS} "
                f"draws of a {rel:.1e} perturbation)"))
        for k in keys:
            gap = float(np.abs(r1[k] - r2[k]).max())
            if not gap <= WITNESS_FACTOR * spread.get(k, 0.0):
                raise AssertionError(
                    f"{key} {k}: gap {gap:.3e}, the reference's own "
                    f"{spread.get(k, 0.0):.3e} under a {rel:.1e} perturbation")
            out["gaps"].append((key[1], f"{k} |d| {gap:.3e}, the reference's own "
                                f"{spread[k]:.3e} under a {rel:.1e} perturbation"))
        out["sets"].add(key[1])
    if not (out["prod"] <= TAIL_INPUT_BAR and out["inputs"] <= bar):
        raise AssertionError(f"tail inputs differ: products {out['prod']:.3e}, "
                             f"tails inputs {out['inputs']:.3e} (bar {bar:.1e})")
    return out


def replay_matches(replay, got):
    """A replay (TailTap with replay=got) gave got's tails results bit for
    bit, call for call."""
    if replay.of("tails").keys() != got.of("tails").keys():
        raise AssertionError("the replay's tails calls differ")
    for key, rec in replay.of("tails").items():
        r1, r2 = rec[3], got.rec[key][3]
        if r1.keys() != r2.keys() or any(not np.array_equal(r1[k], r2[k]) for k in r1):
            raise AssertionError(f"{key}: the replay's tails differ")


def in_sets(row_id, sets):
    """Whether a row's ID is one of the set IDs or a mask of one."""
    return any(row_id == s or row_id.startswith(s + ".") for s in sets)


# the VC tests' rows and the gene-level rows combined from them
VC_TESTS = ("SKAT", "SKATO", "SKATO-ACAT", "ACATV", "ACATO", "ACATV-ACAT")


def _gene_tail_test(test, complete):
    """Whether a TEST (or HTP Model) is a row of the tails (TailTap): a VC
    test's, a gene-level row combined from them, and on a trait with no
    missing value GATES and SBAT, whose input columns that trait's pivoted
    QR orders by rounding (ROADMAP.md §3)."""
    t = test.split("ADD-")[-1].replace("WGR-", "").replace("BURDEN-", "")
    return (t.split("_")[0] in VC_TESTS or test.startswith("GENE_P")
            or (complete and t.split("_")[0] in ("GATES", "SBAT")))


def _gene_split(path, complete):
    """(header lines, the row layout, [(key, fields)] of the other rows,
    {key: fields} of the tails' rows in file order) of a gene-based output
    file; key = (ID, TEST). HTP rows split at tabs, ';' and '=' (so
    LOG10P's value follows a "LOG10P" field); the layout is (TEST's index,
    LOG10P's index or None for HTP)."""
    rows = _read_text(path).splitlines()
    hi = next(i for i, r in enumerate(rows) if not r.startswith("#"))
    htp = "\t" in rows[hi]
    head = rows[hi].split("\t" if htp else None)
    it = head.index("Model" if htp else "TEST")
    iid = head.index("Name" if htp else "ID")
    other, tails = [], {}
    for r in rows[hi + 1:]:
        t = (r.replace(";", "\t").replace("=", "\t").split("\t") if htp
             else r.split())
        key = (t[iid], t[it])
        if _gene_tail_test(t[it], complete):
            tails[key] = t
        else:
            other.append((key, t))
    return rows[: hi + 1], (it, None if htp else head.index("LOG10P")), other, tails


def _gene_fields_ok(ta, tb, layout):
    """The fields up to TEST identical; every other value equal or one unit
    of its sixth significant digit apart; LOG10P (and an HTP row's Pval,
    field 11, as -log10) within 1e-5. Returns (ok, |dLOG10P|)."""
    it, il = layout
    if len(ta) != len(tb) or ta[: it + 1] != tb[: it + 1]:
        return False, math.inf
    dl = 0.0
    for i in range(it + 1, len(ta)):
        x, y = ta[i], tb[i]
        if x == y:
            continue
        try:
            fx, fy = float(x), float(y)
        except ValueError:
            return False, math.inf
        pval = il is None and i == 11
        if pval:
            fx, fy = -math.log10(fx), -math.log10(fy)
        if pval or i == il or (il is None and ta[i - 1] == "LOG10P"):
            dl = max(dl, abs(fx - fy))
            if abs(fx - fy) > LOG10P_TOL:
                return False, dl
        if not pval and _sig6_excess(x, y) > 1 + 1e-9:
            return False, dl
    return True, dl


def _compare_gene_files(f_gpu, f_cpu, complete, sets=None):
    """A gene-based file on the card against the CPU's: every row the same
    in order, each within _gene_fields_ok; but a row of the tails
    (_gene_tail_test) may differ, or be on one side only, where its set is
    one of `sets` (tail_verdict's witnessed sets; None: none may).
    Returns (rows, tails' rows, tails' rows outside the bar, max
    |dLOG10P| of the rows within it)."""
    ha, layout, oa, va = _gene_split(f_gpu, complete)
    hb, _, ob, vb = _gene_split(f_cpu, complete)
    if ha != hb or [k for k, _ in oa] != [k for k, _ in ob]:
        raise AssertionError(f"{f_gpu}: header or rows differ from the CPU's")
    worst = 0.0
    for (k, ta), (_, tb) in zip(oa, ob):
        ok, dl = _gene_fields_ok(ta, tb, layout)
        if not ok:
            raise AssertionError(f"{f_gpu}: {k} differs beyond the bar:\n"
                                 f"{' '.join(ta)}\n{' '.join(tb)}")
        worst = max(worst, dl)
    if [k for k in va if k in vb] != [k for k in vb if k in va]:
        raise AssertionError(f"{f_gpu}: the tails' rows are in another order")
    off = 0
    for k in list(va) + [k for k in vb if k not in va]:
        ok, dl = (_gene_fields_ok(va[k], vb[k], layout) if k in va and k in vb
                  else (False, 0.0))
        if ok:
            worst = max(worst, dl)
            continue
        if sets is None or not in_sets(k[0], sets):
            raise AssertionError(f"{f_gpu}: {k} differs from the CPU's, its set's "
                                 "tails unwitnessed")
        off += 1
    return len(oa) + len(va), len(va), off, worst


def _complete_traits(table, names):
    """The traits of a phenotype table with no missing value."""
    head = _read_text(table).splitlines()
    cols = head[0].split()
    na = {c: False for c in cols}
    for r in head[1:]:
        for c, v in zip(cols, r.split()):
            na[c] |= v == "NA"
    return {n for n in names if not na.get(n, True)}


def gene_cross_check(tmp):
    """Gene-based runs at N = 2,000 (20 sets of 12 variants, gene_afs; 4
    traits, 2 with NA), each on the card and on the CPU: QT with the six
    VC tests and the five joint tests (--vc-maxAAF 0.01 keeps SBAT's Genz
    weights to 6 masks a set), QT --rgc-gene-p, BT --firth
    --approx --htp, BT --spa --write-mask, CT and T2E burden masks. No
    hand-written kernel launches on the card. Card against CPU
    (_compare_gene_files): every row in the same order, the fields up to
    TEST identical, every other printed value equal or adjacent in its
    last printed digit, |dLOG10P| <= 1e-5. The tails (TailTap, held by
    tail_verdict): the VC score products of every QT set and every BT set
    and trait, and every input of the SKAT/SKATO tails, within 1e-12 of
    their largest entry (the BT inputs within twice the calibrations'
    gap), the BT calibrations with the same flags and within the slices'
    bars (Firth rtol 1e-6, SPA 1e-5); a run with VC tests must record
    products. Where a tails call's results differ, the CPU's own tails on
    its inputs perturbed by as much must give the card's tests and move as
    far (tail_verdict); then only that set's tails rows may differ, and a
    CPU replay that takes the card's tail inputs (TailTap replay) must
    give the card's tails bit for bit and its files row for row within the
    bar. GATES and SBAT of an incomplete trait are other rows; of a
    complete one, rows of the tails. The mask BED is the same bytes. The
    QT run again with REGENIE_TPU_GENE_BUCKET=1 on the card writes the
    same bytes as with 32."""
    from regenie_tpu_torch.models import firth, joint, skat, spa

    P, NT, N = 4, 2, 2000
    chroms = ((1, 120), (2, 120))
    d = os.path.join(tmp, "gene")
    os.makedirs(d)
    prefix = write_dataset(d, seed=21, N=N, chroms=chroms, P=P, n_inc=2, n_cov=3,
                           n_remove=10, effect_sd=0.3, af=gene_afs(240, N, 22))
    write_gene_files(d, chroms, 12, 23)
    Y, X = (np.genfromtxt(f"{d}/{t}.txt", skip_header=1, usecols=range(2, 2 + k),
                          missing_values="NA") for t, k in (("pheno", P), ("covar", 3)))
    write_bt_table(f"{d}/pheno_bt.txt", np.nan_to_num(Y), seed=3, prev=(0.1, 0.3),
                   n_inc=2, X=X)
    write_ct_table(f"{d}/pheno_ct.txt", Y, seed=4)
    write_t2e_table(f"{d}/pheno_t2e.txt", np.nan_to_num(Y[:, :NT]), seed=5, n_na=1, X=X)
    ys = [f"Y{p + 1}" for p in range(P)]
    runs = {
        "QT, six VC tests, --joint minp,acat,ftest,gates,sbat": (
            "pheno.txt", ["--vc-tests", "skat,skato,skato-acat,acatv,acato,acato-full",
                          "--joint", "minp,acat,ftest,gates,sbat", "--vc-maxAAF",
                          "0.01"], ys),
        "QT --rgc-gene-p": ("pheno.txt", ["--rgc-gene-p"], ys),
        "BT --firth --approx --htp": (
            "pheno_bt.txt", ["--bt", "--firth", "--approx", "--htp", "SMOKE",
                             "--vc-tests", "skato,acatv", "--joint", "acat"], ys),
        "BT --spa --write-mask": (
            "pheno_bt.txt", ["--bt", "--spa", "--write-mask", "--vc-tests",
                             "skat,acatv", "--joint", "acat"], ys),
        "CT burden": ("pheno_ct.txt", ["--ct", "--joint", "acat"], ys),
        "T2E burden": ("pheno_t2e.txt", [*t2e_flags(NT), "--firth", "--approx",
                                         "--joint", "acat"],
                       [f"T{p + 1}" for p in range(NT)]),
    }
    mods = (skat, joint, firth, spa)
    for i, (what, (table, flags, names)) in enumerate(runs.items()):
        common = ["--step", "2", "--bed", prefix, "--phenoFile", f"{d}/{table}",
                  "--covarFile", f"{d}/covar.txt", "--remove", f"{d}/remove.txt",
                  "--ignore-pred", "--set-list", f"{d}/sets.txt", "--anno-file",
                  f"{d}/anno.txt", "--mask-def", f"{d}/masks.txt", *flags]
        complete = _complete_traits(f"{d}/{table}", names)
        taps, secs = {}, {}
        try:
            for where in ("gpu", "cpu", "replay"):
                os.environ.pop("REGENIE_TPU_TORCH_DEVICE", None)
                if where != "gpu":
                    os.environ["REGENIE_TPU_TORCH_DEVICE"] = "cpu"
                if where == "replay":
                    if not verdict["sets"]:
                        break
                    taps[where] = TailTap(*mods, replay=taps["gpu"])
                else:
                    taps[where] = TailTap(*mods)
                _reset_counts()
                t0 = time.time()
                with taps[where]:
                    run_cli(common + ["--out", f"{d}/g{i}{where}"])
                secs[where] = time.time() - t0
                if where == "gpu" and any(_read_counts().values()):
                    raise AssertionError(f"{what}: kernels launched {_read_counts()}")
                if where == "cpu":
                    verdict = tail_verdict(taps["cpu"], taps["gpu"], skat,
                                           corr_rtol={"firth": 1e-6, "spa": 1e-5})
        finally:
            os.environ.pop("REGENIE_TPU_TORCH_DEVICE", None)
        vc = any(f in flags for f in ("--vc-tests", "--rgc-gene-p"))
        if vc and not verdict["n_prod"]:
            raise AssertionError(f"{what}: no VC products recorded")
        tot = [0, 0, 0, 0.0]
        for name in names:
            n = _compare_gene_files(f"{d}/g{i}gpu_{name}.regenie",
                                    f"{d}/g{i}cpu_{name}.regenie", name in complete,
                                    verdict["sets"])
            tot = [a + b for a, b in zip(tot[:3], n[:3])] + [max(tot[3], n[3])]
            if "replay" in taps:
                _compare_gene_files(f"{d}/g{i}gpu_{name}.regenie",
                                    f"{d}/g{i}replay_{name}.regenie", name in complete)
        if "replay" in taps:
            replay_matches(taps["replay"], taps["gpu"])
        extra = ""
        if "--write-mask" in flags:
            for sfx in (".bed", ".bim", ".fam"):
                a, b = (open(f"{d}/g{i}{w}_masks{sfx}", "rb").read() for w in ("gpu", "cpu"))
                if a != b:
                    raise AssertionError(f"{what}: mask {sfx} differs card vs CPU")
            extra = "; mask BED/BIM/FAM the same bytes"
        prod = (f"max rel {verdict['prod']:.3e} over {verdict['n_prod']} sets and "
                f"traits, the tails' inputs {verdict['inputs']:.3e} over "
                f"{verdict['n_tails']} calls" if verdict["n_prod"]
                else "not measured (no VC tests)")
        if verdict["n_corr"]:
            prod += (f", calibrations rel {verdict['corr']:.3e} over "
                     f"{verdict['n_corr']} calls")
        print(f"  gene {what}: card {secs['gpu']:.1f}s, CPU {secs['cpu']:.1f}s; "
              f"{tot[0]} rows, {tot[0] - tot[2]} within the bar, max |dLOG10P| "
              f"{tot[3]:.3e}; VC products card vs CPU {prod}{extra}; no kernel "
              "launched")
        qr = sorted({sid for sid, t in verdict["gaps"] if t.startswith("joint")})
        if qr:
            print(f"    joint tests' QR pivots differ card vs CPU on tied column norms "
                  f"in {len(qr)} sets: {' '.join(qr)}")
        for sid, text in verdict["gaps"]:
            if not text.startswith("joint"):
                print(f"    tails of set {sid}, card vs CPU: {text}")
        if "replay" in taps:
            print(f"  gene {what}: {tot[2]} rows of the tails of "
                  f"{len(verdict['sets'])} sets outside the bar (ROADMAP.md §3); the "
                  "CPU on the card's tail inputs gives the card's files within it "
                  f"({secs['replay']:.1f}s)")
        if i == 0:
            os.environ["REGENIE_TPU_GENE_BUCKET"] = "1"
            try:
                run_cli(common + ["--out", f"{d}/g{i}b1"])
            finally:
                os.environ.pop("REGENIE_TPU_GENE_BUCKET")
            for name in names:
                a, b = (open(f"{d}/g{i}{w}_{name}.regenie", "rb").read()
                        for w in ("gpu", "b1"))
                if a != b:
                    raise AssertionError(f"{what}: bucket 1 and 32 differ on the card")
            print(f"  gene {what}: REGENIE_TPU_GENE_BUCKET=1 on the card writes the "
                  "same bytes as 32")


def two_step_cross_check(tmp, geno, P, modes=(("K-fold", []), ("--loocv", ["--loocv"])),
                         what="", step2=(), trait=(), table="pheno.txt", step1=(),
                         kernel=None, names=None):
    """The two-step workflow at N=2,000 on the card and on the CPU, in
    each of `modes` (K-fold and --loocv by default) on the genotype
    arguments `geno` (a BED, a PGEN or a BGEN) and the phenotypes of
    `table`: Step 1 with the flags `trait` and `step1`, then Step 2 with
    `trait`, --pred on that run's own _pred.list and the flags `step2`
    ("S1FIRTH" names Step 1's _firth.list). Every .loco value (and with
    Step 1 --write-null-firth every .firth value) within one unit of its
    sixth significant digit, every Step-2 field within its bar. kernel:
    (name, blocks) when the card's Step 2 must launch that kernel once per
    block and no other. names: the tested traits (Step 2's output names;
    their .loco files are the table's first len(names) columns), by
    default Y1..YP."""
    names = names or [f"Y{p + 1}" for p in range(P)]
    base = [*geno, "--phenoFile", f"{tmp}/{table}", "--covarFile",
            f"{tmp}/covar.txt", "--remove", f"{tmp}/remove.txt", *trait]
    for mode, extra in modes:
        tag = ((extra[0].strip("-").replace("-", "") if extra else "kfold")
               + "".join(a.strip("-")[:2] for a in trait))
        for dev in ("cuda", "cpu"):
            os.environ.pop("REGENIE_TPU_TORCH_DEVICE", None)
            if dev == "cpu":
                os.environ["REGENIE_TPU_TORCH_DEVICE"] = "cpu"
            try:
                s1 = f"{tmp}/ts_{tag}_{dev}"
                run_cli(["--step", "1", *base, *extra, *step1, "--bsize", "100",
                         "--out", s1])
                _reset_counts()
                run_cli(["--step", "2", *base, "--bsize", "256", "--pred",
                         f"{s1}_pred.list",
                         *[f"{s1}_firth.list" if a == "S1FIRTH" else a for a in step2],
                         "--out", f"{s1}_s2"])
                counts = _read_counts()
            finally:
                os.environ.pop("REGENIE_TPU_TORCH_DEVICE", None)
            if dev == "cuda" and kernel is not None:
                want = {k: kernel[1] if k == kernel[0] else 0 for k in counts}
                if counts != want:
                    raise AssertionError(f"two-step{what}: launches {counts}, "
                                         f"expected {want}")
        gpu, cpu = f"{tmp}/ts_{tag}_cuda", f"{tmp}/ts_{tag}_cpu"
        ndiff, worst_loco = 0, 0.0
        files = [(f"_{p + 1}.loco", True) for p in range(len(names))]
        if "--write-null-firth" in step1:
            files += [(f"_{p + 1}.firth", False) for p in range(len(names))]
        for suffix, header in files:
            nd, w = _compare_loco(gpu + suffix, cpu + suffix, header)
            ndiff, worst_loco = ndiff + nd, max(worst_loco, w)
        worst = max(_compare_files(f"{gpu}_s2_{n}.regenie", f"{cpu}_s2_{n}.regenie")
                    for n in names)
        kinds = ".loco" + (" and .firth" if "--write-null-firth" in step1 else "")
        print(f"  two-step{what} {mode}: card vs CPU, {len(files)} {kinds} files "
              f"({ndiff} values differ, at most {worst_loco:.3f} units of the "
              f"sixth significant digit) and Step 2 with --pred: every field "
              f"within its bar (largest share of the bar used {worst:.3f})"
              + ("" if kernel is None else f"; the card's Step 2 launched "
                 f"{kernel[0]} {kernel[1]} times, no other kernel"))


def zstd_compressor():
    """ZSTD_compress of libzstd.so.1 through ctypes, as bytes -> bytes
    (level 3). Raises OSError where the library is absent."""
    import ctypes

    z = ctypes.CDLL("libzstd.so.1")
    z.ZSTD_compressBound.restype = ctypes.c_size_t
    z.ZSTD_compressBound.argtypes = [ctypes.c_size_t]
    z.ZSTD_compress.restype = ctypes.c_size_t
    z.ZSTD_compress.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                                ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int]
    z.ZSTD_isError.restype = ctypes.c_uint
    z.ZSTD_isError.argtypes = [ctypes.c_size_t]

    def compress(b):
        cap = z.ZSTD_compressBound(len(b))
        out = ctypes.create_string_buffer(cap)
        n = z.ZSTD_compress(out, cap, b, len(b), 3)
        if z.ZSTD_isError(n):
            raise RuntimeError("ZSTD_compress failed")
        return out.raw[:n]

    return compress


def _variant_blocks(args, bsize=256):
    """(blocks, chrX blocks holding a non-PAR variant) of a BED or PGEN
    run's variant file at bsize: a block per bsize variants of a
    chromosome, in file order."""
    i = args.index("--bed") if "--bed" in args else args.index("--pgen")
    bed = args[i] == "--bed"
    by_chr = {}
    with open(args[i + 1] + (".bim" if bed else ".pvar")) as fh:
        for ln in fh:
            if not ln.startswith("#"):
                t = ln.split()
                by_chr.setdefault(t[0], []).append(int(t[3 if bed else 1]))
    n = nx = 0
    for chrom, pos in by_chr.items():
        for lo in range(0, len(pos), bsize):
            n += 1
            b = np.array(pos[lo : lo + bsize])
            nx += chrom in ("X", "23") and bool(((b > PAR1_MAX) & (b < PAR2_MIN)).any())
    return n, nx


# the cross-check's runs repeated on the mesh (two shards of the card):
# run -> ((REGENIE_TPU_I8=0, the kernel each shard launches), ...)
MESH_CROSS = {
    "BED --htp": ((True, "fused_f32"),),
    "BGEN --minINFO": ((False, "bgen_i8"), (True, "bgen_f32")),
    "BT BED --firth --approx --write-null-firth": ((False, "fused_i8"),),
    "CT BED --af-cc": ((False, "fused_i8"),),
    "T2E BED --firth --approx --htp --htp-with-event": ((False, "fused_i8"),),
}


def mesh_cross_check(runs, tmp, prefix):
    """[mesh] The runs of MESH_CROSS again on the port's single-process mesh
    (REGENIE_TPU_MESH=1, two shards of the card), each against the same run
    unsharded on the card: the kernel once a shard of every block and no
    other, every field within the card-vs-CPU bars (_compare_files), the
    rows that are not byte-identical counted. Then Step 1 K-fold and
    --loocv (sample-sharded level 0) against the same runs unsharded on
    the card: every .loco value within one unit of its sixth digit."""
    for what, (d, common, outs, tag) in runs.items():
        for off, kern in MESH_CROSS[what]:
            mtag = f"{d}/{tag}mesh{int(off)}"
            with _i8_env(off), _mesh_env():
                _reset_counts()
                run_cli(common + ["--out", mtag])
            n, nblk = _mesh_launches(what, f"{mtag}.log", kern)
            ref = f"{d}/{tag}gpu{int(off)}"
            worst = max(_compare_files(mtag + o, ref + o) for o in outs)
            diff = [_identical_rows(mtag + o, ref + o) for o in outs]
            print(f"  [mesh] {what}{' (REGENIE_TPU_I8=0)' if off else ''}: {kern} "
                  f"{n} launches for {nblk} blocks on 2 shards; against the "
                  f"unsharded card run {sum(a for a, _ in diff)} of "
                  f"{sum(b for _, b in diff)} rows not byte-identical, largest "
                  f"share of the bar {worst:.3f}")
    base = ["--step", "1", "--bed", prefix, "--phenoFile", f"{tmp}/pheno.txt",
            "--covarFile", f"{tmp}/covar.txt", "--remove", f"{tmp}/remove.txt",
            "--bsize", "100"]
    for what, extra in (("K-fold", []), ("LOOCV", ["--loocv"])):
        tag = f"{tmp}/s1mesh_{what.lower().replace('-', '')}"
        run_cli(base + extra + ["--out", f"{tag}_gpu"])
        with _mesh_env():
            _reset_counts()
            run_cli(base + extra + ["--out", f"{tag}_mesh"])
        log = open(f"{tag}_mesh.log").read()
        if "level 0 on 2 shards" not in log or any(_read_counts().values()):
            raise AssertionError(f"Step 1 {what}: no sharded level 0, or a "
                                 "kernel launched")
        names = [ln.split()[0] for ln in open(f"{tag}_gpu_pred.list")]
        nd = [_compare_loco(f"{tag}_mesh_{p + 1}.loco", f"{tag}_gpu_{p + 1}.loco")
              for p in range(len(names))]
        print(f"  [mesh] Step 1 {what}, level 0 on 2 shards of the card against "
              f"unsharded: {len(names)} .loco files, {sum(n for n, _ in nd)} values "
              f"differ (at most {max(w for _, w in nd):.3f} units of the sixth "
              "significant digit)")


# the cross-check's runs that mesh_cross_check also runs on two shards,
# again as two processes of one shard each: (run, REGENIE_TPU_I8=0, the
# kernel, whether the launch's processes build their kernels into an
# empty directory at once)
MP_CROSS = (("BT BED --firth --approx --write-null-firth", False, "fused_i8", True),
            ("T2E BED --firth --approx --htp --htp-with-event", False, "fused_i8",
             False),
            ("BGEN --minINFO", False, "bgen_i8", False),
            ("BED --htp", True, "fused_f32", False),
            ("BGEN --minINFO", True, "bgen_f32", False))


def multiprocess_cross_check(runs, tmp, prefix, P):
    """[multiprocess] Runs of the cross-check as two processes of one
    launch, one shard of the card each (mp_launch), against the same run
    in one process on two shards of the card: MP_CROSS's Step-2 runs
    against mesh_cross_check's outputs (each process launching the
    kernel once a block and no other, fused_i8 / bgen_i8 by default and
    fused_f32 / bgen_f32 with REGENIE_TPU_I8=0; the first launch's
    processes build fused_i8 into one empty directory at once), Step 1
    K-fold and --loocv (the per-host sample window) against its Step-1 mesh runs,
    and a gene-based --set-list run, a GxE --interaction run and --mt
    --strict --no-split against their one-process runs here (no kernel
    launches). Every field within the card-vs-CPU bars (_compare_files),
    .loco values within one unit of their sixth digit; the rows or values
    not byte-identical counted; process 1 prints nothing and its files
    are only the output host's. The launches run two at a time (their
    start-up is host-bound), beside the one-process references of the
    last three."""
    from concurrent.futures import ThreadPoolExecutor

    gdir = os.path.join(tmp, "mpgene")
    os.makedirs(gdir)
    g = write_gene_files(gdir, ((1, 400), (2, 200)), 24, seed=7)
    s2 = ["--step", "2", "--bed", prefix, "--phenoFile", f"{tmp}/pheno.txt",
          "--covarFile", f"{tmp}/covar.txt", "--remove", f"{tmp}/remove.txt",
          "--ignore-pred", "--bsize", "256"]
    split = [f"_Y{p + 1}.regenie" for p in range(P)]
    modes = {
        "gene-based --set-list": (
            ["--set-list", g["sets"], "--anno-file", g["anno"], "--mask-def", g["masks"],
             "--vc-tests", "skato,acatv", "--joint", "acat"], split,
            "multi-process gene-based tests: 2 processes"),
        "GxE --interaction C1": (["--interaction", "C1", "--chr", "1"], split, None),
        "--mt --strict --no-split": (["--mt", "--strict", "--no-split"], [".regenie"],
                                     "multi-process multi-trait tests: 2 processes"),
    }
    base = ["--step", "1", "--bed", prefix, "--phenoFile", f"{tmp}/pheno.txt",
            "--covarFile", f"{tmp}/covar.txt", "--remove", f"{tmp}/remove.txt",
            "--bsize", "100"]
    # (what, argv, launch env, the check of its reports)
    jobs = []
    build = tempfile.mkdtemp(prefix="chip_smoke_build_")

    def step2(what, off, kern, fresh):
        d, common, outs, tag = runs[what]
        mtag, ref = f"{d}/{tag}mp{int(off)}", f"{d}/{tag}mesh{int(off)}"
        what += " (REGENIE_TPU_I8=0)" if off else ""

        def check(reps):
            nblk = int(re.search(r"block loop: (\d+) blocks",
                                 open(f"{mtag}.log").read()).group(1))
            n = _mp_checks(what, reps, kern, nblk, f"{mtag}.log",
                           (f"dense route: 0 of {nblk} blocks",))
            _same_names(what, mtag, ref)
            worst = max(_compare_files(mtag + o, ref + o) for o in outs)
            diff = [_identical_rows(mtag + o, ref + o) for o in outs]
            built = ("; both processes built fused_i8 into one empty directory "
                     f"at once: {reps[0]['built']}" if fresh else "")
            print(f"  [multiprocess] {what}: {kern} {n} launches for {nblk} blocks; "
                  f"against one process on 2 shards {sum(a for a, _ in diff)} of "
                  f"{sum(b for _, b in diff)} rows not byte-identical, largest share "
                  f"of the bar {worst:.3f}; walls {reps[0]['proc_wall']:.1f}s, "
                  f"{reps[1]['proc_wall']:.1f}s{built}")

        env = {MP_BUILD_ENV: build} if fresh else {}
        jobs.append((what, common + ["--out", mtag],
                     {**env, "REGENIE_TPU_I8": "0"} if off else env, check))

    def step1(what, extra):
        tag = f"{tmp}/s1mesh_{what.lower().replace('-', '')}"

        def check(reps):
            _mp_checks(f"Step 1 {what}", reps, None, 0, f"{tag}_mp.log",
                       ("level 0 on 2 shards",) + (
                           ("per-host decode: each of 2 processes unpacks only its "
                            "own sample byte window",) if extra else ()))
            _same_names(f"Step 1 {what}", f"{tag}_mp", f"{tag}_mesh")
            nd = [_compare_loco(f"{tag}_mp_{p + 1}.loco", f"{tag}_mesh_{p + 1}.loco")
                  for p in range(P)]
            print(f"  [multiprocess] Step 1 {what}"
                  f"{' (per-host window)' if extra else ''}: no kernel; against one "
                  f"process on 2 shards {P} .loco files, {sum(k for k, _ in nd)} "
                  f"values differ (at most {max(w for _, w in nd):.3f} units of the "
                  f"sixth digit); walls {reps[0]['proc_wall']:.1f}s, "
                  f"{reps[1]['proc_wall']:.1f}s")

        jobs.append((f"Step 1 {what}", base + extra + ["--out", f"{tag}_mp"], None,
                     check))

    def mode(i, what, flags, outs, line):
        one, mtag = f"{tmp}/mpm{i}_one", f"{tmp}/mpm{i}_mp"

        def check(reps):
            _mp_checks(what, reps, None, 0, f"{mtag}.log", (line,) if line else ())
            _same_names(what, mtag, one)
            worst = max(_compare_files(mtag + o, one + o) for o in outs)
            diff = [_identical_rows(mtag + o, one + o) for o in outs]
            print(f"  [multiprocess] {what}: no kernel; against one process on 2 "
                  f"shards {sum(a for a, _ in diff)} of {sum(b for _, b in diff)} rows "
                  f"not byte-identical, largest share of the bar {worst:.3f}; walls "
                  f"{reps[0]['proc_wall']:.1f}s, {reps[1]['proc_wall']:.1f}s")

        jobs.append((what, s2 + flags + ["--out", mtag], None, check))

    for what, off, kern, fresh in MP_CROSS:
        step2(what, off, kern, fresh)
    for what, extra in (("K-fold", []), ("LOOCV", ["--loocv"])):
        step1(what, extra)
    try:
        with ThreadPoolExecutor(max_workers=2) as pool:
            # the launches whose references exist start at once; the
            # modes' one-process references run here meanwhile (each
            # launch sets its own device and mesh variables)
            futs = [pool.submit(mp_launch, argv, what, env=env)
                    for what, argv, env, _ in jobs]
            os.environ.pop("REGENIE_TPU_TORCH_DEVICE", None)
            for i, (what, (flags, outs, line)) in enumerate(modes.items()):
                with _mesh_env():
                    run_cli(s2 + flags + ["--out", f"{tmp}/mpm{i}_one"])
                mode(i, what, flags, outs, line)
                futs.append(pool.submit(mp_launch, jobs[-1][1], what, env=None))
            for (_, _, _, check), fut in zip(jobs, futs):
                check(fut.result())
    finally:
        shutil.rmtree(build, ignore_errors=True)


def cross_check_phase(tmp):
    """Small runs (N=2,000) through the port on the card (by default and
    with REGENIE_TPU_I8=0) and on the CPU, every output field within its
    bar: a BED --htp run, a two-chromosome BGEN --minINFO run, a chrX BED
    --htp run and a chrX BGEN run (positions in PAR1, non-PAR and PAR2;
    fused_i8 / bgen_i8 with the male tail), a zstd BGEN run, and a chrX
    PGEN run with --no-split --gz; each with --remove; the runs of the
    phase's docstring entry 6. The REGENIE_TPU_I8=0 runs of the BED --htp
    and the BGEN --minINFO runs must launch fused_f32 / bgen_f32 once per
    block and no other kernel: returns those launches, the float32
    kernels' on their paths. Then the two-step workflows, and the
    gene-based runs (gene_cross_check)."""
    P = 4
    NT = 2  # time-to-event endpoints of the pheno_t2e.txt tables
    kw = dict(seed=2, N=2000, P=P, n_inc=2, n_cov=3, n_remove=10, effect_sd=0.1)
    chrx = dict(chroms=((1, 300), ("X", 300)),
                positions={"X": chrx_positions(300, 40, 40)})
    sub = {}
    for name in ("bgen", "chrx_bed", "chrx_bgen", "zstd", "pgen", "bgen16",
                 "layout1", "pgen_dosage", "bt6k"):
        sub[name] = os.path.join(tmp, name)
        os.makedirs(sub[name])
    prefix = write_dataset(tmp, chroms=((1, 400), (2, 200)), **kw)
    geno = {
        "bgen": write_bgen_dataset(sub["bgen"], **{**kw, "seed": 4},
                                   chroms=((1, 400), (2, 200))),
        "chrx_bed": write_dataset(sub["chrx_bed"], **{**kw, "seed": 5}, **chrx),
        "chrx_bgen": write_bgen_dataset(sub["chrx_bgen"], **{**kw, "seed": 6}, **chrx),
        "zstd": write_bgen_dataset(sub["zstd"], **{**kw, "seed": 7},
                                   chroms=((1, 400), (2, 200)),
                                   compress=zstd_compressor(), compression=2),
        "pgen": write_pgen_dataset(sub["pgen"], **{**kw, "seed": 8}, **chrx),
        "bgen16": write_bgen_dataset(sub["bgen16"], **{**kw, "seed": 9},
                                     chroms=((1, 400), (2, 200)), bits=16,
                                     phased=True, compression=0),
        "layout1": write_bgen_dataset(sub["layout1"], **{**kw, "seed": 10},
                                      chroms=((1, 400), (2, 200)), layout=1),
        "pgen_dosage": write_pgen_dataset(sub["pgen_dosage"], **{**kw, "seed": 11},
                                          chroms=((1, 400), (2, 200)), dosage=0.5),
        # K-fold on binary traits needs 5,000 analysed samples
        "bt6k": write_dataset(sub["bt6k"], **{**kw, "seed": 12, "N": 6000},
                              chroms=((1, 200), (2, 100))),
    }
    with open(f"{tmp}/cond.txt", "w") as fh:
        fh.write("v3\nv77\nv450\n")
    # the chrX BED's phenotypes transposed: a row per trait
    rows = [ln.split() for ln in open(f"{sub['chrx_bed']}/pheno.txt").read().splitlines()]
    with open(f"{sub['chrx_bed']}/tpheno.txt", "w") as fh:
        fh.write("ID " + " ".join(f"{r[0]}_{r[1]}" for r in rows[1:]) + "\n")
        fh.write("".join(name + " " + " ".join(r[2 + j] for r in rows[1:]) + "\n"
                         for j, name in enumerate(rows[0][2:])))
    # binary traits: each dataset's traits thresholded (cross-check runs
    # with --bt read pheno_bt.txt); count traits: Poisson counts of them
    # (pheno_ct.txt); time-to-event traits: NT endpoints from their first
    # traits, T1 with 5% NA times (pheno_t2e.txt)
    for d in [tmp] + [sub[n] for n in ("bgen", "pgen", "chrx_bed", "pgen_dosage",
                                       "bt6k")]:
        Y, X = (np.genfromtxt(f"{d}/{t}.txt", skip_header=1,
                              usecols=range(2, 2 + k), missing_values="NA")
                for t, k in (("pheno", P), ("covar", 3)))
        write_bt_table(f"{d}/pheno_bt.txt", np.nan_to_num(Y), seed=3, n_inc=2, X=X)
        write_ct_table(f"{d}/pheno_ct.txt", Y, seed=4)
        write_t2e_table(f"{d}/pheno_t2e.txt", np.nan_to_num(Y[:, :NT]), seed=5,
                        n_na=1, X=X)
    split = [f"_Y{p + 1}.regenie" for p in range(P)]
    t2e = [*t2e_flags(NT), "--firth", "--approx"]
    t2e_split = [f"_T{p + 1}.regenie" for p in range(NT)]
    runs = {
        "BED --htp": (tmp, ["--bed", prefix, "--htp", "SMOKE"], split),
        "BGEN --minINFO": (sub["bgen"], ["--bgen", geno["bgen"], "--sample",
                                         f"{sub['bgen']}/geno.sample",
                                         "--minINFO", "0.8"], split),
        "chrX BED --htp": (sub["chrx_bed"], ["--bed", geno["chrx_bed"],
                                             "--htp", "SMOKE"], split),
        "chrX BGEN": (sub["chrx_bgen"], ["--bgen", geno["chrx_bgen"], "--sample",
                                         f"{sub['chrx_bgen']}/geno.sample"], split),
        "zstd BGEN": (sub["zstd"], ["--bgen", geno["zstd"], "--sample",
                                    f"{sub['zstd']}/geno.sample"], split),
        "chrX PGEN --no-split --gz": (sub["pgen"], ["--pgen", geno["pgen"],
                                                    "--no-split", "--gz"],
                                      [".regenie.gz"]),
        "BT BGEN --firth --approx --af-cc": (
            sub["bgen"], ["--bgen", geno["bgen"], "--sample",
                          f"{sub['bgen']}/geno.sample", *BT_FLAGS], split),
        "BT chrX PGEN --spa --htp": (sub["pgen"], ["--pgen", geno["pgen"], "--bt",
                                                   "--spa", "--htp", "SMOKE"], split),
        "BT BED --firth --approx --write-null-firth": (
            tmp, ["--bed", prefix, "--bt", "--firth", "--approx",
                  "--write-null-firth"], split),
        "T2E BED --firth --approx --htp --htp-with-event": (
            tmp, ["--bed", prefix, *t2e, "--htp", "SMOKE", "--htp-with-event"],
            t2e_split),
        "T2E chrX BED --firth --approx": (
            sub["chrx_bed"], ["--bed", geno["chrx_bed"], *t2e], t2e_split),
        "T2E PGEN --firth --approx --coxnofirth": (
            sub["pgen"], ["--pgen", geno["pgen"], *t2e, "--coxnofirth"], t2e_split),
        # --af-cc off binary traits: the case/control columns hold -1
        "QT BED --af-cc": (tmp, ["--bed", prefix, "--af-cc"], split),
        "CT BED --af-cc": (tmp, ["--bed", prefix, "--ct", "--af-cc"], split),
    }
    # the dense route (no int8 / float32 switch: each runs once on the card)
    dense = {
        "16-bit phased uncompressed BGEN --htp --condition-file bgen": (
            sub["bgen16"], ["--bgen", geno["bgen16"], "--sample",
                            f"{sub['bgen16']}/geno.sample", "--htp", "SMOKE",
                            "--condition-file", f"bgen,{geno['bgen']}",
                            "--condition-file-sample", f"{sub['bgen']}/geno.sample",
                            "--condition-list", f"{tmp}/cond.txt"], split, True),
        "layout-1 BGEN --no-split --test dominant": (
            sub["layout1"], ["--bgen", geno["layout1"], "--sample",
                             f"{sub['layout1']}/geno.sample", "--no-split",
                             "--test", "dominant"], [".regenie"], True),
        "PGEN dosages --nocov-approx --phenoColList Y2": (
            sub["pgen_dosage"], ["--pgen", geno["pgen_dosage"], "--nocov-approx",
                                 "--phenoColList", "Y2"], ["_Y2.regenie"], True),
        "chrX BED --skip-dosage-comp": (
            sub["chrx_bed"], ["--bed", geno["chrx_bed"], "--skip-dosage-comp"],
            split, False),
        "BT PGEN dosages --firth --approx": (
            sub["pgen_dosage"], ["--pgen", geno["pgen_dosage"], "--bt", "--firth",
                                 "--approx"], split, True),
        "BT chrX BED --firth --approx --af-cc": (
            sub["chrx_bed"], ["--bed", geno["chrx_bed"], *BT_FLAGS], split, False),
        "chrX BED --test recessive --minHOMs 1 --condition-list --tpheno-file": (
            sub["chrx_bed"], ["--bed", geno["chrx_bed"], "--test", "recessive",
                              "--minHOMs", "1", "--condition-list",
                              f"{tmp}/cond.txt", "--tpheno-file",
                              f"{sub['chrx_bed']}/tpheno.txt"], split, False),
        "T2E BGEN --firth --approx": (
            sub["bgen"], ["--bgen", geno["bgen"], "--sample",
                          f"{sub['bgen']}/geno.sample", *t2e], t2e_split, True),
        "T2E BED --coxscore-exact": (
            tmp, ["--bed", prefix, *t2e_flags(NT), "--coxscore-exact"], t2e_split,
            True),
    }
    # the float32 kernels' CLI runs (REGENIE_TPU_I8=0), 3 blocks of 256 each
    f32_runs = {"BED --htp": "fused_f32", "BGEN --minINFO": "bgen_f32"}
    f32_launches = {}
    mesh_runs = {}
    for i, (what, (d, args, outs, *_)) in enumerate({**runs, **dense}.items()):
        is_dense = what in dense
        table = ("pheno_bt.txt" if "--bt" in args else
                 "pheno_t2e.txt" if "--t2e" in args else
                 "pheno_ct.txt" if "--ct" in args else "pheno.txt")
        pheno = [] if "--tpheno-file" in args else ["--phenoFile", f"{d}/{table}"]
        common = ["--step", "2", *args, *pheno, "--covarFile", f"{d}/covar.txt",
                  "--remove", f"{d}/remove.txt", "--ignore-pred", "--bsize", "256"]
        tag = f"r{i}_"
        os.environ.pop("REGENIE_TPU_TORCH_DEVICE", None)
        switches = (False,) if is_dense else (False, True)
        for off in switches:
            with _i8_env(off):
                _reset_counts()
                run_cli(common + ["--out", f"{d}/{tag}gpu{int(off)}"])
            if off and what in f32_runs:
                counts = _read_counts()
                want = {k: 3 if k == f32_runs[what] else 0 for k in counts}
                if counts != want:
                    raise AssertionError(f"{what} (REGENIE_TPU_I8=0): launches "
                                         f"{counts}, expected {want}")
                f32_launches[f32_runs[what]] = counts[f32_runs[what]]
            if "--af-cc" in args and not what.startswith("BT"):
                # QT and CT --af-cc on the fused route: fused_i8 (or
                # fused_f32) once a block and no other kernel
                kern = "fused_f32" if off else "fused_i8"
                nblk, _ = _variant_blocks(args)
                counts = _read_counts()
                want = {k: nblk if k == kern else 0 for k in counts}
                if counts != want:
                    raise AssertionError(f"{what}{' (REGENIE_TPU_I8=0)' if off else ''}"
                                         f": launches {counts}, expected {want}")
                lines = _read_text(f"{d}/{tag}gpu{int(off)}{outs[0]}").splitlines()
                k = lines[0].split().index("A1FREQ_CASES")
                if not {ln.split()[k] for ln in lines[1:]} <= {"-1", "NA"}:
                    raise AssertionError(f"{what}: A1FREQ_CASES other than -1")
                print(f"  {what}{' (REGENIE_TPU_I8=0)' if off else ''}: {kern} "
                      f"{counts[kern]} launches for {nblk} blocks, no other kernel; "
                      "the case/control columns -1")
            if what.startswith("T2E") and not is_dense:
                # the Cox operand through fused_i8, or fused_f32 with
                # REGENIE_TPU_I8=0, once a block and no other kernel; every
                # block fused, the chrX non-PAR ones with the male tail
                kern = "fused_f32" if off else "fused_i8"
                nblk, nx = _variant_blocks(args)
                counts = _read_counts()
                want = {k: nblk if k == kern else 0 for k in counts}
                if counts != want:
                    raise AssertionError(f"{what}{' (REGENIE_TPU_I8=0)' if off else ''}"
                                         f": launches {counts}, expected {want}")
                log = open(f"{d}/{tag}gpu{int(off)}.log").read()
                if f"dense route: 0 of {nblk} blocks" not in log:
                    raise AssertionError(f"{what}: a block left the fused route")
                if nx and f"on the fused route (male tail): {nx}\n" not in log:
                    raise AssertionError(f"{what}: the {nx} chrX non-PAR blocks did "
                                         "not all take the fused route's male tail")
                print(f"  {what}{' (REGENIE_TPU_I8=0)' if off else ''}: {kern} "
                      f"{counts[kern]} launches for {nblk} blocks, no other kernel"
                      + (f"; {nx} chrX non-PAR blocks fused with the male tail"
                         if nx else ""))
        if what in MESH_CROSS:
            mesh_runs[what] = (d, common, outs, tag)
        if is_dense:
            log = open(f"{d}/{tag}gpu0.log").read()
            if "dense scorer on cuda" not in log:
                raise AssertionError(f"{what}: the log shows no dense route on cuda")
            if dense[what][3] and any(_read_counts().values()):
                raise AssertionError(f"{what}: kernels launched on the dense route")
        os.environ["REGENIE_TPU_TORCH_DEVICE"] = "cpu"
        try:
            run_cli(common + ["--out", f"{d}/{tag}cpu"])
        finally:
            os.environ.pop("REGENIE_TPU_TORCH_DEVICE")
        rows = len(_read_text(f"{d}/{tag}cpu{outs[0]}").splitlines()) - 1
        for off in switches:
            worst = max(_compare_files(f"{d}/{tag}gpu{int(off)}{o}", f"{d}/{tag}cpu{o}")
                        for o in outs)
            firth = ""
            if "--write-null-firth" in args:
                nd = [_compare_loco(f"{d}/{tag}gpu{int(off)}_{p + 1}.firth",
                                    f"{d}/{tag}cpu_{p + 1}.firth", header=False)
                      for p in range(P)]
                firth = (f"; {P} .firth files, {sum(n for n, _ in nd)} values differ "
                         f"(at most {max(w for _, w in nd):.3f} units of the sixth "
                         "significant digit)")
            print(f"  {what}{' (REGENIE_TPU_I8=0)' if off else ''}: card vs CPU, "
                  f"{P if len(outs) == 1 and '--phenoColList' not in args else len(outs)}"
                  f" traits x {rows} "
                  f"variants: every field within its bar (largest share of the "
                  f"bar used {worst:.3f}){firth}")
    mesh_cross_check(mesh_runs, tmp, prefix)
    multiprocess_cross_check(mesh_runs, tmp, prefix, P)
    two_step_cross_check(tmp, ["--bed", prefix], P)
    # interaction tests (GxPRS on the K-fold run's own _pred.list) and the
    # Step-1 options
    interaction_cross_check(tmp, prefix, P, sub, geno)
    step1_options_cross_check(tmp, prefix, P)
    two_step_cross_check(sub["pgen"], ["--pgen", geno["pgen"]], P,
                         modes=(("K-fold", []),), what=" on PGEN")
    two_step_cross_check(sub["bgen"], ["--bgen", geno["bgen"], "--sample",
                                       f"{sub['bgen']}/geno.sample"], P,
                         modes=(("K-fold", []),), what=" on BGEN, --force-ltco 2",
                         step2=["--force-ltco", "2"])
    # binary traits: Step 1 --bt (LOOCV, forced below 5,000 samples) with
    # its null Firth files, then exact Firth with --use-null-firth; K-fold
    # at N = 6,000; count traits on BED and BGEN (3 blocks of 256), whose
    # Step 2 runs fused_i8 / bgen_i8 once per block
    two_step_cross_check(tmp, ["--bed", prefix], P,
                         modes=(("LOOCV (forced below 5,000 samples)", []),),
                         what=" BT, --write-null-firth, exact Firth --use-null-firth",
                         trait=["--bt"], table="pheno_bt.txt",
                         step1=["--write-null-firth"],
                         step2=["--firth", "--use-null-firth", "S1FIRTH"])
    two_step_cross_check(sub["bt6k"], ["--bed", geno["bt6k"]], P,
                         modes=(("K-fold", []),), what=" BT at N=6,000",
                         trait=["--bt"], table="pheno_bt.txt")
    two_step_cross_check(tmp, ["--bed", prefix], P, modes=(("K-fold", []),),
                         what=" CT on BED", trait=["--ct"], table="pheno_ct.txt",
                         kernel=("fused_i8", 3))
    two_step_cross_check(sub["bgen"], ["--bgen", geno["bgen"], "--sample",
                                       f"{sub['bgen']}/geno.sample"], P,
                         modes=(("K-fold", []),), what=" CT on BGEN", trait=["--ct"],
                         table="pheno_ct.txt", kernel=("bgen_i8", 3))
    # time-to-event traits: Step 1 --t2e K-fold, with --t2e-l1-pi6 and with
    # --t2e-event-l0, each then Step 2 --t2e on its predictions (fused_i8
    # once per block)
    two_step_cross_check(tmp, ["--bed", prefix], P,
                         modes=(("K-fold", []), ("--t2e-l1-pi6", ["--t2e-l1-pi6"]),
                                ("--t2e-event-l0", ["--t2e-event-l0"])),
                         what=" T2E", trait=t2e_flags(NT), table="pheno_t2e.txt",
                         kernel=("fused_i8", 3), names=[f"T{p + 1}" for p in range(NT)])
    # gene-based tests (--set-list) on QT, BT, CT and T2E traits
    gene_cross_check(tmp)
    # MCC, multi-trait tests, MultiPhen and LD mode (the last on the gene
    # files too)
    modes_cross_check(tmp, prefix, P)
    return f32_launches


def _step1_slices(tmp, t_all):
    """[step1 slice], [step1 bt slice] and [t2e slice] on the Step-1
    dataset in `tmp`, which is removed after them; "(<phase> done at
    <s>)" lines count from t_all. Returns the launches of fused_i8 on the
    T2E Step-2 path."""
    print("[step1 slice]")
    step1_slice_phase(tmp)
    _free()
    _phase_time("step1 slice", t_all)
    print("[step1 bt slice]")
    step1_bt_slice_phase(tmp)
    _free()
    _phase_time("step1 bt slice", t_all)
    print("[t2e slice]")
    launches = t2e_slice_phase(tmp)
    print(f"  fused_i8 launches on the T2E Step-2 path: {launches}")
    shutil.rmtree(tmp)
    _free()
    _phase_time("t2e slice", t_all)
    return launches


def _side_child(q, step1_dir, t_all, lock):
    """The side process: cross_check_phase in a temporary directory of
    its own, then _step1_slices on step1_dir, each with its printed lines
    kept; puts (ok, lines, its return value, seconds) on the queue q for
    each, in that order, and stops at the first that fails. lock: the
    lanes' card lock (_card_heavy)."""
    import io
    import traceback

    import torch

    global _CARD_LOCK
    _CARD_LOCK = lock

    def run(fn, *args):
        buf = io.StringIO()
        t0 = time.time()
        try:
            with contextlib.redirect_stdout(buf):
                ret = fn(*args)
        except BaseException:
            q.put((False, buf.getvalue() + traceback.format_exc(), None,
                   time.time() - t0))
            raise
        q.put((True, buf.getvalue(), ret, time.time() - t0))

    torch.set_num_threads(SIDE_THREADS)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        run(cross_check_phase, tmp)
    # the Step-1 slices' CPU checks (level 1 at N = 20,000, a block's W)
    # take twice the cross-check's torch threads
    torch.set_num_threads(2 * SIDE_THREADS)
    run(_step1_slices, step1_dir, t_all)


# host threads of the side process (BLAS, and torch in the cross-check):
# the [bt slice]'s null fits beside it are BLAS-bound and slowed 1.8x by a
# cross-check and a CPU check on all cores
SIDE_THREADS = 2
_BLAS_ENV = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")


class Side:
    """A second lane of the smoke: one spawned process that runs the
    cross-check (N = 2,000) and then the three Step-1 slices at full
    width, beside the main process's Step-2 slices from [bed slice] on.
    Both lanes spend most of their time on the host ([bt slice]'s null
    fits leave the card idle for minutes; the Step-1
    slices write 11 GB of LOCO text and fit their nulls there), so on a
    host whose speed varies ~1.4x between machines the two lanes keep
    the smoke inside its time limit with no check cut. The card is
    shared: a CUDA-event time of either lane may include kernels of the
    other (the kernel phase and [ld slice] run before the lane starts).
    result(what, beside) waits for the next part, prints its lines and
    returns its value; close() stops the process."""

    def __init__(self, step1_dir, t_all):
        import multiprocessing

        global _CARD_LOCK
        ctx = multiprocessing.get_context("spawn")
        self.q = ctx.Queue()
        self.parts = 0  # results read
        _CARD_LOCK = ctx.Lock()
        self.proc = ctx.Process(target=_side_child,
                                args=(self.q, step1_dir, t_all, _CARD_LOCK))
        # the child reads its BLAS thread counts from the environment when
        # it imports numpy
        saved = {k: os.environ.get(k) for k in _BLAS_ENV}
        os.environ.update({k: str(SIDE_THREADS) for k in _BLAS_ENV})
        try:
            self.proc.start()
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v

    def result(self, what, beside):
        import queue

        t0 = time.time()
        while True:
            try:
                ok, lines, ret, secs = self.q.get(timeout=10)
                break
            except queue.Empty:
                if not self.proc.is_alive():
                    raise RuntimeError(f"the side process ended without the "
                                       f"result of the {what}") from None
        self.parts += 1
        print(lines, end="")
        if not ok:
            raise RuntimeError(f"the {what} failed")
        print(f"  {what}: {secs:.1f}s in the side process, beside {beside}; "
              f"waited {time.time() - t0:.1f}s for it")
        return ret

    def close(self):
        # after both parts the process ends by itself; else it is stopped
        self.proc.join(60 if self.parts == 2 else 0)
        if self.proc.is_alive():
            self.proc.terminate()
            self.proc.join(30)


def native_report():
    """Which native libraries load, with which symbols."""
    from regenie_tpu_torch.io import native

    lib = native.get_lib()
    syms = [n for n in ("bed_decode", "format_sumstat_single",
                        "format_sumstat_htp", "bgen12_extract_planes")
            if lib is not None and hasattr(lib, n)]
    print("  root native library (make -C native): "
          + (f"loaded, symbols {', '.join(syms)}" if lib is not None else
             "not built here; output rows render in Python"))
    t0 = time.time()
    native.planes_lib()
    print(f"  BGEN plane extractor (regenie_tpu_torch/io/csrc/bgen_planes.cpp, "
          f"g++): loaded, symbol {native.PLANES_SYMBOL} ({time.time() - t0:.1f}s)")
    native.require_zstd()
    print(f"  its zstd records: ZSTD_decompress loaded from {native.ZSTD_SONAME}")
    t0 = time.time()
    native.pgen_lib()
    print(f"  PGEN block decoder (regenie_tpu_torch/io/csrc/pgen_bytes.cpp, g++): "
          f"loaded, symbol {native.PGEN_SYMBOL} ({time.time() - t0:.1f}s)")


def _free():
    """Collect the engines of a finished phase (their operands sit in
    reference cycles) and return the card's cached blocks."""
    import gc

    import torch

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _sync(dev):
    """Wait for the card's queued work when `dev` is a CUDA device."""
    import torch

    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def _phase_time(name, t_all):
    """Print the seconds since the smoke started, after a phase."""
    print(f"  ({name} done at {time.time() - t_all:.1f}s)")


def main() -> int:
    # both lanes' allocators map growing segments, so that memory one phase
    # frees serves another's larger blocks (the lanes share the card)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the smoke runs on the card only",
              file=sys.stderr)
        return 2
    card = card_line()
    print(card)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from regenie_tpu_torch.ops import kernels
    from regenie_tpu_torch.utils.device import resolve_device

    dev = resolve_device("cuda")
    t_all = time.time()
    print("[build]")
    t0 = time.time()
    report = kernels.build_all()
    for name, (sec, log) in report.items():
        print(f"  {name}: nvcc {sec:.1f}s")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print("   ", line.strip())
    native_report()
    print(f"  build phase {time.time() - t0:.1f}s")
    # the full-width datasets are written in the background from here on
    root = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    data = Datasets(root.name)
    try:
        print("[kernel]")
        quantize_check(dev)
        rows = []
        for phase in (fused_i8_phase, bgen_i8_phase, fused_f32_phase, bgen_f32_phase,
                      fused_bf16_phase, bgen_bf16_phase, decode_planes_phase):
            rows.append(phase(dev))
            _free()
        rows += profile_fused_phase(dev)
        _free()
        rows += profile_bgen_phase(dev)
        _free()
        _phase_time("kernel", t_all)
        print("[profile path]")
        launches = profile_path_phase()
        _free()
        print("[profile path, BGEN]")
        launches.update(profile_bgen_path_phase())
        _free()
        tmp = data.get("bed")
        print("[ld slice]")
        ld_check = ld_slice_phase(tmp)
        _free()
        _phase_time("ld slice (the card's part)", t_all)
        # two lanes from here on: the side process (the cross-check, then
        # the Step-1 slices) and the LD slice's CPU check (a thread) run
        # beside the BED and BT slices, whose host run-up and null fits
        # leave the card idle, and the Step-2 slices after them
        from concurrent.futures import ThreadPoolExecutor

        side = Side(data.get("step1"), t_all)
        with ThreadPoolExecutor(max_workers=1) as pool:
            # half the host's cores: the BT null fits beside it are BLAS-bound
            ld_done = pool.submit(ld_check, max(1, (os.cpu_count() or 2) // 2))
            print("[bed slice] (the side process and the LD slice's CPU check "
                  "run beside it and [bt slice])")
            launches.update(slice_phase(tmp, "bed"))
            _free()
            _phase_time("bed slice", t_all)
            print("[mesh slice]")
            _, mesh_wall = mesh_slice_phase(tmp)
            _free()
            _phase_time("mesh slice", t_all)
            # the multi-process launch runs beside [bt slice], whose host
            # null fits leave the card idle; its checks print after it
            with ThreadPoolExecutor(max_workers=1) as mp_pool:
                mp_run = mp_pool.submit(multiprocess_slice_launch, tmp)
                print("[bt slice] ([multiprocess slice]'s two processes run beside it)")
                bt_launches = bt_slice_phase(tmp)
                print(f"  fused_i8 launches on the BT path: {bt_launches}")
                print("[multiprocess slice]")
                mp_launches = multiprocess_slice_phase(tmp, mesh_wall, mp_run.result())
            print(f"  fused_i8 launches a process on the multi-process path: "
                  f"{mp_launches}")
            print("[ld slice, CPU check]")
            print(ld_done.result())
        del ld_check, ld_done
        shutil.rmtree(tmp)
        _free()
        _phase_time("bt slice", t_all)
        print("[cross-check]")
        # the float32 kernels' CLI runs (REGENIE_TPU_I8=0) are the
        # cross-check's BED --htp and BGEN --minINFO runs
        launches.update(side.result("cross-check", "[bed slice] and [bt slice]"))
        _phase_time("cross-check", t_all)
        tmp = data.get("bgen")
        print("[bgen slice]")
        got, *kept = slice_phase(tmp, "bgen", keep=True)
        launches.update(got)
        _free()
        print("[dense slice]")
        dense_slice_phase(tmp, kept)
        del kept
        shutil.rmtree(tmp)
        _free()
        _phase_time("bgen and dense slices", t_all)
        tmp = data.get("pgen")
        print("[pgen chrX slice]")
        pgen_launches = pgen_chrx_slice_phase(tmp)
        print(f"  fused_i8 launches on the PGEN chrX path: {pgen_launches}")
        shutil.rmtree(tmp)
        _free()
        _phase_time("pgen chrX slice", t_all)
        tmp = data.get("gene")
        print("[gene slice]")
        gene_slice_phase(tmp)
        _free()
        _phase_time("gene slice", t_all)
        print("[interaction slice]")
        interaction_slice_phase(tmp)
        shutil.rmtree(tmp)
        _free()
        print("[bt interaction timing]")
        bt_interaction_real_depth(dev)
        _free()
        _phase_time("interaction slice", t_all)
        # the Step-1 slices' lines, from the side process
        side.result("Step-1 slices", "the Step-2 slices")
        _phase_time("side process", t_all)
    finally:
        if "side" in locals():
            side.close()
        data.close()
        root.cleanup()
    # decode_planes has no caller on any path of the port, as
    # _decode_kernel has none in the JAX package: 0 launches there
    launches["decode_planes"] = 0
    for row in rows:
        row["launches"] = launches[row["name"]]
    print(f"all phases passed in {time.time() - t_all:.1f}s")
    print(json.dumps({"kernels": rows}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == [MP_CHILD]:
        sys.exit(mp_child(sys.argv[2], sys.argv[3:]))
    sys.exit(main())
