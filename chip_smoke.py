#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (regenie_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, each of which must pass:

1. build: compile every CUDA kernel of the port from ops/csrc/ with nvcc
   (one process per source, started together), and report whether the
   native libraries (the root native/ library, the port's BGEN plane
   extractor) load, and with which symbols.
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
   full width.
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
3. BED slice: write a synthetic PLINK BED at that shape (M = 2 blocks of
   2048 variants, null phenotypes) and run the port's Step-2 CLI on the
   card in this process, twice: by default, where fused_i8 must launch
   once per block and no other kernel, and with REGENIE_TPU_I8=0, where
   fused_f32 must; check the output files, and that the first block of
   each agrees with the port's plain path (float64 operand, plain
   products) on the card: max |dLOG10P| <= 1e-5, max |dBETA| <= 1e-6,
   the repository's cross-backend bar.
4. BGEN slice: the same on a synthetic 8-bit zlib BGEN at that shape
   (imputed-like probabilities, 1% missing; M = 2 blocks), through
   --bgen/--sample: bgen_i8 (and with REGENIE_TPU_I8=0 bgen_f32)
   launches once per block and no other kernel; the first block meets
   the same bar, and its INFO and A1FREQ agree with the plain path
   within rel 1e-9.
   Split path (in each slice phase): the bf16 hi|mid|lo split consts,
   built by build_consts(split=True) from the engine's per-sample arrays,
   score the first block through make_qt_block_fn (BED, with
   score_block_fused on random allele flips beside it) or
   make_qt_bgen_fn (BGEN): fused_bf16 / bgen_bf16 launch and no other
   kernel, and the block meets the same bars against the plain path.
5. cross-check: small runs through the port on the card (by default and
   with REGENIE_TPU_I8=0) and on the CPU, a BED --htp run and a
   two-chromosome BGEN --minINFO run (N=2,000, M=600 each); every output
   field meets the same bar.

The last lines of standard output are a JSON line with every kernel's
numbers, the card's name and power limit (nvidia-smi), and
{"ok": true, "device": {...}}. Without a CUDA device it exits non-zero
before any phase.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
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
LOG10P_TOL, BETA_TOL = 1e-5, 1e-6
F64_SUM_BAR = 1e-12  # float64 kernel sums: share of the product against |W|


def run_cli(argv):
    """The port's CLI in this process, its console lines kept out of the
    smoke's output (the CLI writes them to <out>.log as well)."""
    import io

    from regenie_tpu_torch import cli

    with contextlib.redirect_stdout(io.StringIO()):
        cli.main(argv)


def card_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return r.stdout.strip().splitlines()[0]


def write_dataset(d, seed, N, chroms, P, n_inc, n_cov, miss=0.02,
                  na_rate=0.05, n_remove=0, effect_sd=0.0, chunk=128):
    """Synthetic PLINK BED/bim/fam (prefix d/geno), phenotypes
    (d/pheno.txt: Y1..YP, the first n_inc with na_rate NA), covariates
    (d/covar.txt: n_cov columns) and d/remove.txt (n_remove samples).

    Genotypes follow Hardy-Weinberg at allele frequencies uniform in
    [0.01, 0.5] (every 17th variant rare, at 0.004 or at 10 expected
    minor alleles in small cohorts, for the MAC filters), with
    missing codes at rate `miss`; they are drawn `chunk` variants at a
    time, so memory stays small at biobank N. Phenotypes are covariate
    effects plus noise and, when effect_sd > 0, per-allele effects of sd
    effect_sd on 2% of the variants. Returns the BED prefix."""
    rng = np.random.default_rng(seed)
    M = sum(n for _, n in chroms)
    af = rng.uniform(0.01, 0.5, size=M)
    af[::17] = max(0.004, 5.0 / N)
    beta = rng.normal(size=(M, P)) * effect_sd * (rng.random((M, P)) < 0.02)
    X = rng.normal(size=(N, n_cov))
    Y = X @ rng.normal(size=(n_cov, P)) + rng.normal(size=(N, P))
    nb = (N + 3) // 4
    lut = np.array([1, 0, 2, 3], np.uint8)  # missing, hom-alt, het, hom-ref
    prefix = os.path.join(d, "geno")
    with open(prefix + ".bed", "wb") as fh:
        fh.write(b"\x6c\x1b\x01")
        for s in range(0, M, chunk):
            a = af[s : s + chunk, None]
            t1 = miss
            t2 = t1 + (1 - miss) * a * a
            t3 = t2 + (1 - miss) * 2 * a * (1 - a)
            u = rng.random((len(a), N), dtype=np.float32)
            k = ((u >= t1).astype(np.uint8) + (u >= t2.astype(np.float32))
                 + (u >= t3.astype(np.float32)))
            codes = lut[k]
            causal = np.nonzero(beta[s : s + len(a)].any(axis=1))[0]
            if len(causal):
                g = (2.0 * (codes[causal] == 0) + (codes[causal] == 2))
                Y += g.T @ beta[s + causal]
            codes = np.pad(codes, ((0, 0), (0, 4 * nb - N))).reshape(-1, nb, 4)
            fh.write((codes[..., 0] | (codes[..., 1] << 2) | (codes[..., 2] << 4)
                      | (codes[..., 3] << 6)).astype(np.uint8).tobytes())
    with open(prefix + ".bim", "w") as fh:
        v = 0
        for chrom, n in chroms:
            fh.write("".join(f"{chrom} v{v + j} 0 {1000 + 10 * j} A C\n"
                             for j in range(n)))
            v += n
    with open(prefix + ".fam", "w") as fh:
        fh.write("".join(f"F{i} I{i} 0 0 {1 + i % 2} -9\n" for i in range(N)))
    _write_tables(d, rng, Y, X, n_inc, na_rate, n_remove)
    return prefix


def _write_tables(d, rng, Y, X, n_inc, na_rate, n_remove):
    """d/pheno.txt (the first n_inc traits with na_rate NA), d/covar.txt
    and d/remove.txt (n_remove samples) for samples F{i} I{i}."""
    N, P = Y.shape
    for p in range(n_inc):
        Y[rng.random(N) < na_rate, p] = np.nan

    def table(path, names, V):
        row = " ".join(["%.6f"] * V.shape[1])
        with open(path, "w") as fh:
            fh.write("FID IID " + " ".join(names) + "\n")
            fh.write("".join(f"F{i} I{i} " + (row % tuple(v)).replace("nan", "NA")
                             + "\n" for i, v in enumerate(V)))

    table(os.path.join(d, "pheno.txt"), [f"Y{p + 1}" for p in range(P)], Y)
    table(os.path.join(d, "covar.txt"), [f"C{k + 1}" for k in range(X.shape[1])], X)
    with open(os.path.join(d, "remove.txt"), "w") as fh:
        for i in rng.choice(N, size=n_remove, replace=False):
            fh.write(f"F{i} I{i}\n")


def write_bgen_dataset(d, seed, N, chroms, P, n_inc, n_cov, miss=0.01,
                       uncertain=0.1, na_rate=0.05, n_remove=0, effect_sd=0.0,
                       chunk=32, workers=8):
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
    biobank N. Returns the .bgen path."""
    import struct
    import zlib
    from concurrent.futures import ThreadPoolExecutor

    rng = np.random.default_rng(seed)
    M = sum(n for _, n in chroms)
    chrom_of = np.concatenate([np.full(n, c) for c, n in chroms])
    af = rng.uniform(0.01, 0.5, size=M)
    af[::17] = max(0.004, 5.0 / N)
    beta = rng.normal(size=(M, P)) * effect_sd * (rng.random((M, P)) < 0.02)
    X = rng.normal(size=(N, n_cov))
    Y = X @ rng.normal(size=(n_cov, P)) + rng.normal(size=(N, P))
    ids = [f"I{i}" for i in range(N)]
    lsi = 8 + sum(2 + len(s) for s in ids)
    path = os.path.join(d, "geno.bgen")
    head = np.frombuffer(struct.pack("<IHBB", N, 2, 2, 2), np.uint8)
    with open(path, "wb") as fh, ThreadPoolExecutor(workers) as pool:
        fh.write(struct.pack("<IIII", 20 + lsi, 20, M, N) + b"bgen")
        fh.write(struct.pack("<I", 1 | (2 << 2) | (1 << 31)))
        fh.write(struct.pack("<II", lsi, N) + b"".join(
            struct.pack("<H", len(s)) + s.encode() for s in ids))
        for s in range(0, M, chunk):
            a = af[s : s + chunk, None]
            c = len(a)
            u = rng.random((c, N), dtype=np.float32)
            g = ((u < (a * a).astype(np.float32)).astype(np.uint8)
                 + (u < (1 - (1 - a) ** 2).astype(np.float32)))  # first-allele count
            # j/255 of the called genotype's probability moves to its
            # neighbour on uncertain samples
            u = rng.random((c, N), dtype=np.float32)
            j = np.where(u < uncertain, rng.integers(0, 128, (c, N), dtype=np.uint8),
                         np.uint8(0))
            gmiss = u > 1 - miss
            body = np.empty((c, 10 + 3 * N), np.uint8)
            body[:, :8] = head
            body[:, 8 : 8 + N] = np.where(gmiss, np.uint8(0x82), np.uint8(2))
            body[:, 8 + N] = 0
            body[:, 9 + N] = 8
            k = body[:, 10 + N :].reshape(c, N, 2)  # k0, k1
            k[..., 0] = np.where(g == 2, 255 - j, np.where(g == 1, j >> 1, 0))
            k[..., 1] = np.where(g == 2, j, np.where(g == 1, 255 - j, j))
            causal = np.nonzero(beta[s : s + c].any(axis=1))[0]
            if len(causal):
                dose = (2.0 * k[causal, :, 0] + k[causal, :, 1]) / 255.0
                Y += np.where(gmiss[causal], 0.0, dose).T @ beta[s + causal]
            comp = pool.map(lambda row: zlib.compress(row.tobytes(), 1), body)
            for j, z in enumerate(comp):
                v = s + j
                rsid = f"v{v}".encode()
                ch = str(chrom_of[v]).encode()
                fh.write(struct.pack("<H", len(rsid)) + rsid
                         + struct.pack("<H", len(rsid)) + rsid
                         + struct.pack("<H", len(ch)) + ch
                         + struct.pack("<IH", 1000 + 10 * v, 2)
                         + struct.pack("<I", 1) + b"A" + struct.pack("<I", 1) + b"C"
                         + struct.pack("<II", len(z) + 4, body.shape[1]) + z)
    with open(os.path.join(d, "geno.sample"), "w") as fh:
        fh.write("ID_1 ID_2 missing sex\n0 0 0 D\n")
        fh.write("".join(f"F{i} I{i} 0 {1 + i % 2}\n" for i in range(N)))
    _write_tables(d, rng, Y, X, n_inc, na_rate, n_remove)
    return path


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
    return dict(name="fused_i8", route="cuda",
                source="regenie_tpu_torch/ops/csrc/fused_i8.cu",
                replaces="regenie_tpu/ops/fused_score.py:403",
                launches=None, max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)


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


def _assert_close(name, a, b, tol):
    """Same NaN pattern, max |a - b| over the finite entries <= tol."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if not np.array_equal(np.isnan(a), np.isnan(b)):
        raise AssertionError(f"{name}: NaN patterns differ")
    ok = ~np.isnan(a)
    err = float(np.max(np.abs(a[ok] - b[ok]), initial=0.0))
    print(f"  {name}: max |kernel path - plain path| = {err:.3e} (bar {tol:g})")
    if err > tol:
        raise AssertionError(f"{name}: {err:.3e} > {tol:g}")
    return err


def _assert_rel(name, a, b, rtol):
    """Same NaN pattern, max |a - b| / |b| over the finite entries <= rtol."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if not np.array_equal(np.isnan(a), np.isnan(b)):
        raise AssertionError(f"{name}: NaN patterns differ")
    ok = ~np.isnan(a)
    err = float(np.max(np.abs(a[ok] - b[ok]) / np.maximum(np.abs(b[ok]), 1e-300),
                       initial=0.0))
    print(f"  {name}: max rel |kernel path - plain path| = {err:.3e} (bar {rtol:g})")
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


def _slice_cli(argv, kernel, what):
    """One CLI run of a slice with the launch counts set to 0 just before
    it and read just after: `kernel` must launch once per block and no
    other kernel. Prints the per-block lines and the run's times."""
    import torch

    f = FULL
    M = SLICE_BLOCKS * f["B"]
    out = argv[-1]
    _reset_counts()
    t0 = time.time()
    run_cli(argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = _read_counts()

    n_blocks = math.ceil(M / f["B"])
    for p in range(f["P"]):
        with open(f"{out}_Y{p + 1}.regenie") as fh:
            n = sum(1 for _ in fh) - 1
        if n != M:
            raise AssertionError(f"{out}_Y{p + 1}.regenie has {n} rows, not {M}")
    print(f"  {what}: {f['P']} output files of {M} rows; launches {counts} "
          f"for {n_blocks} blocks")
    want = {name: n_blocks if name == kernel else 0 for name in counts}
    if counts != want:
        raise AssertionError(f"kernel launches {counts}, expected {want}")
    with open(f"{out}.log") as fh:
        log = fh.read().splitlines()
    for ln in log:
        if ln.startswith("   -block"):
            print(f"  {ln.strip()}")
    loop = [ln.strip(" *") for ln in log if "block loop:" in ln][0]
    reads = [ln.strip(" *") for ln in log if "host block reads:" in ln][0]
    loop_s = float(loop.rsplit(" in ", 1)[1].rstrip("s"))
    print(f"  CLI wall time {wall:.2f}s = {M / wall:.1f} variants/s (run-up "
          f"and output included); {loop} = {M / loop_s:.1f} variants/s; "
          f"{reads}; on {card_line()}")
    return counts[kernel]


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


def slice_phase(tmp, src):
    """The port's Step-2 QT CLI at full width on the card, on a BED
    (src="bed") or a BGEN (src="bgen") file, by default (int8 kernel) and
    with REGENIE_TPU_I8=0 (float32 kernel) on the same dataset. Returns
    the launches of each slice kernel in its CLI run."""
    import torch

    from regenie_tpu_torch import cli
    from regenie_tpu_torch.ops import fused_score as fsc
    from regenie_tpu_torch.run_step2 import Step2Engine, open_engine

    f = FULL
    M = SLICE_BLOCKS * f["B"]
    kernels = {"bed": ("fused_i8", "fused_f32"), "bgen": ("bgen_i8", "bgen_f32")}[src]
    t0 = time.time()
    if src == "bed":
        geno = ["--bed", write_dataset(tmp, seed=1, N=f["N"], chroms=((1, M),),
                                       P=f["P"], n_inc=f["n_inc"], n_cov=f["K"] - 1)]
    else:
        geno = ["--bgen", write_bgen_dataset(
            tmp, seed=3, N=f["N"], chroms=((1, M),), P=f["P"],
            n_inc=f["n_inc"], n_cov=f["K"] - 1),
            "--sample", f"{tmp}/geno.sample"]
    print(f"  {src.upper()} dataset N={f['N']} M={M} P={f['P']} K={f['K']} "
          f"written in {time.time() - t0:.1f}s")
    argv = ["--step", "2", *geno, "--phenoFile", f"{tmp}/pheno.txt",
            "--covarFile", f"{tmp}/covar.txt", "--ignore-pred",
            "--bsize", str(f["B"]), "--verbose", "--out"]
    os.environ.pop("REGENIE_TPU_TORCH_DEVICE", None)
    launches = {}
    for kernel, off in zip(kernels, (False, True)):
        with _i8_env(off):
            launches[kernel] = _slice_cli(
                argv + [f"{tmp}/slice_{kernel}"], kernel,
                f"{kernel} run" + (" (REGENIE_TPU_I8=0)" if off else ""))

    # first block: each kernel path against the plain path, all on the card
    params = cli.args_to_params(cli.build_parser().parse_args(argv + [f"{tmp}/x"]))
    eng, blocks = open_engine(params, log=lambda *a: None)
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
    eng.gd.close()
    return launches


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


def _compare_files(f_gpu, f_cpu):
    """Field-by-field comparison of two output files (HTP or split
    .regenie): text fields equal, LOG10P within 1e-5, every other number
    within 1e-6, each beyond the half-unit of the 6 significant digits the
    files print. Returns the largest excess ratio (<= 1 passes)."""
    la = open(f_gpu).read().splitlines()
    lb = open(f_cpu).read().splitlines()
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
            if (ta[i - 1] if htp else names[i]) == "LOG10P":
                tol = LOG10P_TOL
            elif htp and i == 11:  # Pval: compare as -log10
                fx, fy, tol = -math.log10(fx), -math.log10(fy), LOG10P_TOL
            else:
                tol = BETA_TOL
            lim = tol + 1e-5 * max(abs(fx), abs(fy))
            worst = max(worst, abs(fx - fy) / lim)
            if abs(fx - fy) > lim:
                raise AssertionError(f"field {i} differs beyond {tol:g}:\n{ra}\n{rb}")
    return worst


def cross_check_phase(tmp):
    """Small runs through the port on the card (by default and with
    REGENIE_TPU_I8=0) and on the CPU: a BED --htp run and a
    two-chromosome BGEN --minINFO run."""
    P = 4
    prefix = write_dataset(tmp, seed=2, N=2000, chroms=((1, 400), (2, 200)),
                           P=P, n_inc=2, n_cov=3, n_remove=10, effect_sd=0.1)
    bgen_dir = os.path.join(tmp, "bgen")
    os.makedirs(bgen_dir)
    bgen = write_bgen_dataset(bgen_dir, seed=4, N=2000,
                              chroms=((1, 400), (2, 200)), P=P, n_inc=2,
                              n_cov=3, n_remove=10, effect_sd=0.1)
    runs = {
        "BED --htp": (tmp, ["--bed", prefix, "--htp", "SMOKE"]),
        "BGEN --minINFO": (bgen_dir, ["--bgen", bgen, "--sample",
                                      f"{bgen_dir}/geno.sample",
                                      "--minINFO", "0.8"]),
    }
    for what, (d, args) in runs.items():
        common = ["--step", "2", *args, "--phenoFile", f"{d}/pheno.txt",
                  "--covarFile", f"{d}/covar.txt", "--remove", f"{d}/remove.txt",
                  "--ignore-pred", "--bsize", "256"]
        os.environ.pop("REGENIE_TPU_TORCH_DEVICE", None)
        for off in (False, True):
            with _i8_env(off):
                run_cli(common + ["--out", f"{d}/gpu{int(off)}"])
        os.environ["REGENIE_TPU_TORCH_DEVICE"] = "cpu"
        try:
            run_cli(common + ["--out", f"{d}/cpu"])
        finally:
            os.environ.pop("REGENIE_TPU_TORCH_DEVICE")
        for off in (False, True):
            worst = max(_compare_files(f"{d}/gpu{int(off)}_Y{p + 1}.regenie",
                                       f"{d}/cpu_Y{p + 1}.regenie")
                        for p in range(P))
            rows = len(open(f"{d}/cpu_Y1.regenie").read().splitlines()) - 1
            print(f"  {what}{' (REGENIE_TPU_I8=0)' if off else ''}: card vs CPU, "
                  f"{P} traits x {rows} variants: every field within its bar "
                  f"(largest share of the bar used {worst:.3f})")


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


def main() -> int:
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

    print("[kernel]")
    rows = []
    for phase in (fused_i8_phase, bgen_i8_phase, fused_f32_phase, bgen_f32_phase,
                  fused_bf16_phase, bgen_bf16_phase, decode_planes_phase):
        rows.append(phase(dev))
        torch.cuda.empty_cache()
    rows += profile_fused_phase(dev)
    torch.cuda.empty_cache()
    rows += profile_bgen_phase(dev)
    torch.cuda.empty_cache()
    print("[profile path]")
    launches = profile_path_phase()
    torch.cuda.empty_cache()
    print("[profile path, BGEN]")
    launches.update(profile_bgen_path_phase())
    torch.cuda.empty_cache()
    for src in ("bed", "bgen"):
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            print(f"[{src} slice]")
            launches.update(slice_phase(tmp, src))
        torch.cuda.empty_cache()
    # decode_planes has no caller on any path of the port, as
    # _decode_kernel has none in the JAX package: 0 launches there
    launches["decode_planes"] = 0
    for row in rows:
        row["launches"] = launches[row["name"]]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        print("[cross-check]")
        cross_check_phase(tmp)
    print(f"all phases passed in {time.time() - t_all:.1f}s")
    print(json.dumps({"kernels": rows}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
