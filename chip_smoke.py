#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (regenie_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, each of which must pass:

1. build: compile every CUDA kernel of the port from ops/csrc/ with nvcc.
2. kernel: hold each kernel against its plain PyTorch version on the card
   (the int8 fused products must be exactly equal, int32 for int32) on
   ragged shapes and at the full width of the repository's UKB shape
   (N=400,000 samples, P=50 traits of which 10 incomplete, K=20, blocks of
   2048 variants), and time the kernel, its plain version, its bound and
   the library yardstick.
3. slice: write a synthetic PLINK BED at that shape (M = 4 blocks of 2048
   variants, null phenotypes) and run the port's Step-2 CLI on the card
   in this process; check the output files, that the kernel launched once
   per block, and that the first block agrees with the port's plain path
   (float64 operand, plain products) on the card: max |dLOG10P| <= 1e-5,
   max |dBETA| <= 1e-6, the repository's cross-backend bar.
4. cross-check: a small --htp run (N=2,000, M=600, two chromosomes) through
   the port on the card and on the CPU; every output field meets the same
   bar.

The last lines of standard output are a JSON line with every kernel's
numbers, the card's name and power limit (nvidia-smi), and
{"ok": true, "device": {...}}. Without a CUDA device it exits non-zero
before any phase.
"""

from __future__ import annotations

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
PEAK_BYTES = 3.35e12

# the repository's UKB shape (bench.py, BENCH_NOTES.md)
FULL = dict(N=400_000, P=50, n_inc=10, K=20, B=2048)
LOG10P_TOL, BETA_TOL = 1e-5, 1e-6


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
    for p in range(n_inc):
        Y[rng.random(N) < na_rate, p] = np.nan

    def table(path, names, V):
        row = " ".join(["%.6f"] * V.shape[1])
        with open(path, "w") as fh:
            fh.write("FID IID " + " ".join(names) + "\n")
            fh.write("".join(f"F{i} I{i} " + (row % tuple(v)).replace("nan", "NA")
                             + "\n" for i, v in enumerate(V)))

    table(os.path.join(d, "pheno.txt"), [f"Y{p + 1}" for p in range(P)], Y)
    table(os.path.join(d, "covar.txt"), [f"C{k + 1}" for k in range(n_cov)], X)
    with open(os.path.join(d, "remove.txt"), "w") as fh:
        for i in rng.choice(N, size=n_remove, replace=False):
            fh.write(f"F{i} I{i}\n")
    return prefix


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


def _check_i8_exact(raw, limbs, what):
    """Kernel against its plain version on the same card tensors: H, E, M
    must be equal. Returns the max abs difference (0)."""
    import torch

    from regenie_tpu_torch.ops import kernels

    got = kernels.fused_i8_products(raw, limbs)
    want = kernels.fused_i8_products_plain(raw, limbs)
    torch.cuda.synchronize()
    err = max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
              for g, w in zip(got, want))
    print(f"  fused_i8 {what}: B={raw.shape[0]} nbp={raw.shape[1]} "
          f"Cw4={limbs.shape[2]} max|kernel-plain|={err}")
    if err != 0:
        raise AssertionError(f"fused_i8 kernel differs from its plain version "
                             f"({what}): max abs {err}")
    return err


def _random_consts(rng, N, P, n_inc, K, device):
    """The port's int8 fused operand for random inputs of the given shape
    (orthonormal covariates, n_inc traits with 5% missing)."""
    from regenie_tpu_torch.ops import fused_score as fsc

    ind = np.ones(N, bool)
    maskf = np.ones((N, P))
    for p in range(n_inc):
        maskf[rng.random(N) < 0.05, p] = 0.0
    res = rng.normal(size=(N, P)) * maskf
    cov = np.linalg.qr(rng.normal(size=(N, K)))[0]
    return fsc.build_consts(cov, res, maskf, ind, float(N - K),
                           device=device, split="i8")


def kernel_phase(dev, reps=10):
    """Exactness on ragged and full-width shapes; times at full width."""
    import torch

    from regenie_tpu_torch.ops import fused_score as fsc
    from regenie_tpu_torch.ops import kernels

    rng = np.random.default_rng(0)
    errs = []
    # ragged: rows not a multiple of the row tile, a byte count that ends
    # mid-stage, a column count that is not a multiple of the column tile
    raw = torch.from_numpy(rng.integers(0, 256, (37, 272), dtype=np.uint8)).to(dev)
    limbs = torch.from_numpy(
        rng.integers(-128, 128, (4, 272, 400), dtype=np.int8)).to(dev)
    errs.append(_check_i8_exact(raw, limbs, "ragged, random limbs"))
    c = _random_consts(rng, 1025, 3, 1, 4, dev)
    raw = torch.from_numpy(fsc.pad_raw(
        rng.integers(0, 256, (37, 257), dtype=np.uint8))).to(dev)
    errs.append(_check_i8_exact(raw, c.Wp.limbs, "ragged, N=1025 operand"))

    f = FULL
    t0 = time.time()
    c = _random_consts(rng, f["N"], f["P"], f["n_inc"], f["K"], dev)
    nb = (f["N"] + 3) // 4
    raw = torch.from_numpy(fsc.pad_raw(
        rng.integers(0, 256, (f["B"], nb), dtype=np.uint8))).to(dev)
    limbs = c.Wp.limbs
    print(f"  full-width operand built in {time.time() - t0:.1f}s: "
          f"limbs {tuple(limbs.shape)}, C_used={c.layout_C()}")
    errs.append(_check_i8_exact(raw, limbs, "full width"))

    B, nbp = raw.shape
    Cw4 = limbs.shape[2]
    ms = _time_ms(lambda: kernels.fused_i8_products(raw, limbs), reps)
    plain_ms = _time_ms(lambda: kernels.fused_i8_products_plain(raw, limbs), 3)

    # yardstick: one library int8 GEMM of the pre-decoded indicators (the
    # decode is not timed); it must give the kernel's numbers
    r = raw.to(torch.int32)
    codes = [(r >> (2 * p)) & 3 for p in range(4)]
    ind = torch.cat([torch.cat([(cd == k).to(torch.int8) for cd in codes], 1)
                     for k in (0, 2, 1)], 0)  # [3B, 4*nbp], p-major columns
    del r, codes
    w2 = limbs.reshape(4 * nbp, Cw4)
    lib_out = torch._int_mm(ind, w2)
    if not torch.equal(lib_out, torch.cat(kernels.fused_i8_products(raw, limbs), 0)):
        raise AssertionError("library int8 GEMM disagrees with the kernel")
    library_ms = _time_ms(lambda: torch._int_mm(ind, w2), reps)
    del ind, lib_out

    ops = 2.0 * 3 * B * (4 * nbp) * Cw4
    nbytes = B * nbp + 4 * nbp * Cw4 + 3 * B * Cw4 * 4
    bound_ms = max(ops / PEAK_INT8_OPS, nbytes / PEAK_BYTES) * 1e3
    bound_by = "operations" if ops / PEAK_INT8_OPS >= nbytes / PEAK_BYTES else "bytes"
    print(f"  fused_i8 full width: {ms:.3f} ms (median of {reps}), plain "
          f"{plain_ms:.3f} ms, library int8 GEMM without decode "
          f"{library_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}: "
          f"{ops:.3e} int8 ops, {nbytes / 1e9:.3f} GB); "
          f"{ops / ms / 1e9:.1f} TOP/s = {bound_ms / ms:.1%} of the bound")
    return dict(name="fused_i8", route="cuda",
                source="regenie_tpu_torch/ops/csrc/fused_i8.cu",
                replaces="regenie_tpu/ops/fused_score.py:403",
                launches=None, max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)


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


def slice_phase(tmp):
    """The port's Step-2 QT CLI at full width on the card."""
    import torch

    from regenie_tpu_torch import cli
    from regenie_tpu_torch.ops import fused_score as fsc
    from regenie_tpu_torch.ops import kernels
    from regenie_tpu_torch.run_step2 import Step2Engine, open_engine

    f = FULL
    M = 4 * f["B"]
    t0 = time.time()
    prefix = write_dataset(tmp, seed=1, N=f["N"], chroms=((1, M),), P=f["P"],
                           n_inc=f["n_inc"], n_cov=f["K"] - 1)
    print(f"  dataset N={f['N']} M={M} P={f['P']} K={f['K']} written in "
          f"{time.time() - t0:.1f}s")
    argv = ["--step", "2", "--bed", prefix, "--phenoFile", f"{tmp}/pheno.txt",
            "--covarFile", f"{tmp}/covar.txt", "--ignore-pred",
            "--bsize", str(f["B"]), "--verbose", "--out", f"{tmp}/slice"]
    os.environ.pop("REGENIE_TPU_TORCH_DEVICE", None)

    kernels.fused_i8_products.launches = 0
    t0 = time.time()
    cli.main(argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = kernels.fused_i8_products.launches

    n_blocks = math.ceil(M / f["B"])
    for p in range(f["P"]):
        with open(f"{tmp}/slice_Y{p + 1}.regenie") as fh:
            n = sum(1 for _ in fh) - 1
        if n != M:
            raise AssertionError(f"slice_Y{p + 1}.regenie has {n} rows, not {M}")
    print(f"  {f['P']} output files of {M} rows; fused_i8 launches {launches} "
          f"for {n_blocks} blocks")
    if launches != n_blocks:
        raise AssertionError(f"fused_i8 launched {launches} times for "
                             f"{n_blocks} blocks")
    with open(f"{tmp}/slice.log") as fh:
        loop = [ln.strip(" *\n") for ln in fh if "block loop:" in ln][0]
    loop_s = float(loop.rsplit(" in ", 1)[1].rstrip("s"))
    print(f"  CLI wall time {wall:.2f}s = {M / wall:.1f} variants/s (run-up "
          f"and output included); {loop} = {M / loop_s:.1f} variants/s; "
          f"on {card_line()}")

    # first block: the kernel path against the plain path, both on the card
    params = cli.args_to_params(cli.build_parser().parse_args(argv))
    eng, blocks = open_engine(params, log=lambda *a: None)
    plain = Step2Engine(params, eng.gd, eng.pd, eng.blup_files, eng.log,
                        eng.device, kernel=False)
    chrom, bsnps = blocks[0]
    raw = eng.read_block_raw(bsnps)
    out = []
    for e in (eng, plain):
        e.prep_chrom(chrom)
        out.append(e.test_raw_block_fused(raw, bsnps)[0])
    # for the record, not checked: the same products folded and scored in
    # float32, as the JAX package does on a TPU (why the port uses float64)
    c = eng._fused_consts
    c32 = c._replace(usum=c.usum.float(), covt_res=c.covt_res.float(),
                     Mmat=c.Mmat.float())
    st, den, sf = (x.double().cpu().numpy() for x in fsc.make_qt_block_fn(
        c32, True)(eng._fused_upload(raw))[:3])
    bhat32, _, _, logp32 = eng._qt_post(st, den, sf, np.zeros(len(bsnps), bool))
    inc = list(c.inc)
    for name, a, b in (("LOG10P", logp32, out[1].logp), ("BETA", bhat32, out[1].bhat)):
        d = np.abs(a - b)
        print(f"  first block {name}, float32 fold and epilogue: max |diff| "
              f"{np.nanmax(d):.3e} (incomplete traits {np.nanmax(d[:, inc]):.3e}, "
              f"complete {np.nanmax(np.delete(d, inc, axis=1)):.3e}); not checked")
    _assert_close("first block LOG10P", out[0].logp, out[1].logp, LOG10P_TOL)
    _assert_close("first block BETA", out[0].bhat, out[1].bhat, BETA_TOL)
    eng.gd.close()
    return launches


def _compare_htp(f_gpu, f_cpu):
    """Field-by-field comparison of two HTP files: text fields equal,
    LOG10P within 1e-5, every other number within 1e-6, each beyond the
    half-unit of the 6 significant digits the files print. Returns the
    largest excess ratio (<= 1 passes)."""
    la = open(f_gpu).read().splitlines()
    lb = open(f_cpu).read().splitlines()
    if len(la) != len(lb) or la[0] != lb[0]:
        raise AssertionError(f"{f_gpu}: header or row count differs")
    worst = 0.0
    for ra, rb in zip(la[1:], lb[1:]):
        ta = ra.replace(";", "\t").replace("=", "\t").split("\t")
        tb = rb.replace(";", "\t").replace("=", "\t").split("\t")
        if len(ta) != len(tb):
            raise AssertionError(f"field count differs:\n{ra}\n{rb}")
        for i, (x, y) in enumerate(zip(ta, tb)):
            if x == y:
                continue
            try:
                fx, fy = float(x), float(y)
            except ValueError:
                raise AssertionError(f"field differs:\n{ra}\n{rb}") from None
            if ta[i - 1] == "LOG10P":
                tol = LOG10P_TOL
            elif i == 11:  # Pval: compare as -log10
                fx, fy, tol = -math.log10(fx), -math.log10(fy), LOG10P_TOL
            else:
                tol = BETA_TOL
            lim = tol + 1e-5 * max(abs(fx), abs(fy))
            worst = max(worst, abs(fx - fy) / lim)
            if abs(fx - fy) > lim:
                raise AssertionError(f"field {i} differs beyond {tol:g}:\n{ra}\n{rb}")
    return worst


def cross_check_phase(tmp):
    """Small --htp run through the port on the card and on the CPU."""
    from regenie_tpu_torch import cli

    P = 4
    prefix = write_dataset(tmp, seed=2, N=2000, chroms=((1, 400), (2, 200)),
                           P=P, n_inc=2, n_cov=3, n_remove=10, effect_sd=0.1)
    common = ["--step", "2", "--bed", prefix, "--phenoFile", f"{tmp}/pheno.txt",
              "--covarFile", f"{tmp}/covar.txt", "--remove", f"{tmp}/remove.txt",
              "--ignore-pred", "--bsize", "256", "--htp", "SMOKE"]
    os.environ.pop("REGENIE_TPU_TORCH_DEVICE", None)
    cli.main(common + ["--out", f"{tmp}/gpu"])
    os.environ["REGENIE_TPU_TORCH_DEVICE"] = "cpu"
    try:
        cli.main(common + ["--out", f"{tmp}/cpu"])
    finally:
        os.environ.pop("REGENIE_TPU_TORCH_DEVICE")
    worst = max(_compare_htp(f"{tmp}/gpu_Y{p + 1}.regenie",
                             f"{tmp}/cpu_Y{p + 1}.regenie") for p in range(P))
    print(f"  card vs CPU, {P} traits x 600 variants: every field within its "
          f"bar (largest share of the bar used {worst:.3f})")


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
    print(f"  build phase {time.time() - t0:.1f}s")

    print("[kernel]")
    rows = [kernel_phase(dev)]
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        print("[slice]")
        launches = slice_phase(tmp)
        rows[0]["launches"] = launches
    torch.cuda.empty_cache()
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
