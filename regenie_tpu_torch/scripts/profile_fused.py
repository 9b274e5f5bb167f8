"""Attribution of the fused BED scorer's time on the card: the port's
counterpart of scripts/profile_fused.py.

    python -m regenie_tpu_torch.scripts.profile_fused          # on the card
    REGENIE_TPU_TORCH_DEVICE=cpu BENCH_N=700 BENCH_P=3 BENCH_K=2 BENCH_B=16 \\
        python -m regenie_tpu_torch.scripts.profile_fused      # plain versions

Builds the bf16 hi|mid|lo split operand of random inputs at the UKB bench
shape (BENCH_N=400000 samples, BENCH_P=50 traits of which P // 5 have 5%
missing, BENCH_K=20 covariates from the QR of a normal matrix) and
BENCH_BLOCKS=4 blocks of BENCH_B=2048 variants of random bytes, all from
numpy.random.default_rng(0), and prints one line per variant:

  prod           fused_products on the split operand: the fused_bf16
                 kernel and the float64 fold
  stacked        profile_stacked_products: fused_bf16's function through
                 the base of csrc/profile_fused.cu
  nodecode       the decode replaced by one byte -> bf16 conversion per A
                 element; three mma chains
  stacked-2dots  stacked without the M product
  decode-only    the stage loads and the decode, no mma
  pipelined      decode warps fill a double-buffered indicator tile that
                 the mma warps read one stage later, in each Hopper
                 configuration (kernels.PROFILE_PIPELINED_CONFIGS)

BENCH_SWEEP=1 adds stacked in its other configurations
(kernels.PROFILE_STACKED_CONFIGS). Each line gives ms per block (the best
of BENCH_ROUNDS=5 rounds over the BENCH_BLOCKS distinct blocks, after one
warm-up call; CUDA events on the card), SNPs/s, and the production
function's useful operations (2 x 3 products x 4*nbp x Cw per SNP, the
bound's count in chip_smoke.py) over that time as TFLOP/s and as a share
of the H100's 989 dense bf16 TFLOP/s. The card line (nvidia-smi name and
power limit) comes first; last come the folded S1 / SQ / SM of pipelined
and stacked against prod: max |d| and the largest |d| relative to the
same products taken against |wp|.

It runs on the card unless REGENIE_TPU_TORCH_DEVICE=cpu (or device="cpu")
asks for the CPU, where every wrapper takes its plain version and a line
gives the host time of that and no TFLOP/s. main() takes the knobs
as arguments too, so that chip_smoke.py and the tests call it in-process.
"""

from __future__ import annotations

import os
import subprocess
import time

import numpy as np
import torch

from ..ops import fused_score as fsc
from ..ops import kernels
from ..utils.device import resolve_device

PEAK_BF16_OPS = 989e12  # dense bf16 tensor-core rate of one H100 SXM (700 W)


def _knob(value, env, default):
    return int(os.environ.get(env, default)) if value is None else int(value)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return r.stdout.strip().splitlines()[0]


def make_inputs(N, P, K, B, n_blocks, device):
    """The synthetic inputs of scripts/profile_fused.py main(): the split
    operand Wp [4, nbp, 3*Cp] bfloat16 and n_blocks padded [B, nbp] uint8
    blocks, on `device`."""
    rng = np.random.default_rng(0)
    nb = (N + 3) // 4
    raws = [rng.integers(0, 256, size=(B, nb), dtype=np.uint8)
            for _ in range(n_blocks)]
    ind = np.ones(N, dtype=bool)
    res = rng.normal(size=(N, P))
    maskf = np.ones((N, P))
    for p in range(max(1, P // 5)):
        missing = rng.random(N) < 0.05
        maskf[missing, p] = 0.0
        res[missing, p] = 0.0
    cov = np.linalg.qr(rng.normal(size=(N, K)))[0]
    consts = fsc.build_consts(cov, res, maskf, ind, float(N - K), device=device,
                              split=True)
    nbp = consts.Wp.shape[1]
    rawps = [torch.from_numpy(fsc.pad_raw(r, nbp)).to(device) for r in raws]
    return consts.Wp, rawps


def _variants(sweep):
    """(line name, fn(raw, wp)) in the order of the lines."""
    st, pi = kernels.PROFILE_STACKED_CONFIGS, kernels.PROFILE_PIPELINED_CONFIGS
    out = [("prod", fsc.fused_products),
           (f"stacked ({st[0]})", kernels.profile_stacked_products),
           ("nodecode", kernels.profile_nodecode_products),
           ("stacked-2dots",
            lambda r, w: kernels.profile_stacked_products(r, w, with_m=False)),
           ("decode-only", kernels.profile_decode_only_products)]
    out += [(f"pipelined ({name})",
             lambda r, w, c=c: kernels.profile_pipelined_products(r, w, config=c))
            for c, name in enumerate(pi)]
    if sweep:
        out += [(f"stacked ({name})",
                 lambda r, w, c=c: kernels.profile_stacked_products(r, w, config=c))
                for c, name in enumerate(st) if c]
    return out


def _best_ms(fn, rawps, rounds, on_card):
    """Best over `rounds` of the mean milliseconds per block of fn over
    the distinct blocks, after one warm-up call: CUDA events on the card,
    the host clock on the CPU."""
    fn(rawps[0])
    if on_card:
        torch.cuda.synchronize()
    best = np.inf
    for _ in range(rounds):
        if on_card:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for r in rawps:
                fn(r)
            b.record()
            b.synchronize()
            ms = a.elapsed_time(b)
        else:
            t0 = time.perf_counter()
            for r in rawps:
                fn(r)
            ms = (time.perf_counter() - t0) * 1e3
        best = min(best, ms / len(rawps))
    return float(best)


def _folded(outs):
    """H, E, M products against the split thirds -> S1, SQ, SM."""
    H, E, M = (fsc.fold3(x) for x in outs)
    return 2.0 * H + E, 4.0 * H + E, M


def main(n=None, p=None, k=None, b=None, rounds=None, blocks=None, sweep=None,
         device=None) -> dict:
    """Run the variants and print their lines; each knob defaults to its
    BENCH_* variable. Returns {"device", "card", "shape", "lines": [{name,
    ms, snps_per_s, tflops, peak_share}] (no rates on the CPU), "checks":
    {variant: {S1|SQ|SM: (max |d|, max |d| relative to the |wp|
    product)}}}."""
    N = _knob(n, "BENCH_N", 400_000)
    P = _knob(p, "BENCH_P", 50)
    K = _knob(k, "BENCH_K", 20)
    B = _knob(b, "BENCH_B", 2048)
    R = _knob(rounds, "BENCH_ROUNDS", 5)
    NBLK = _knob(blocks, "BENCH_BLOCKS", 4)
    if sweep is None:
        sweep = bool(os.environ.get("BENCH_SWEEP"))
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    card = card_line() if on_card else None
    print(card if on_card else "device: cpu (plain versions)", flush=True)

    Wp, rawps = make_inputs(N, P, K, B, NBLK, dev)
    nbp, Cw = Wp.shape[1], Wp.shape[2]
    ops_per_snp = 2.0 * 3 * 4 * nbp * Cw
    print(f"N={N} P={P} K={K} B={B} nbp={nbp} Cw={Cw} blocks={NBLK} rounds={R} "
          f"ops/snp={ops_per_snp / 1e9:.3f} G", flush=True)

    lines = []
    for name, fn in _variants(sweep):
        ms = _best_ms(lambda r, fn=fn: fn(r, Wp), rawps, R, on_card)
        snps = B / ms * 1e3
        if on_card:
            tf = snps * ops_per_snp / 1e12
            lines.append(dict(name=name, ms=ms, snps_per_s=snps, tflops=tf,
                              peak_share=tf * 1e12 / PEAK_BF16_OPS))
            print(f"{name:40s} {ms:10.3f} ms  {snps:12.0f} SNPs/s  {tf:8.3f} "
                  f"TFLOP/s ({tf * 1e12 / PEAK_BF16_OPS:.1%} of peak)", flush=True)
        else:
            lines.append(dict(name=name, ms=ms, snps_per_s=snps, tflops=None,
                              peak_share=None))
            print(f"{name:40s} {ms:10.3f} ms  {snps:12.0f} SNPs/s  (host time of "
                  "the plain version)", flush=True)

    # correctness of pipelined and stacked against prod, after the fold
    rawp = rawps[0]
    prod = fsc.fused_products(rawp, Wp)
    bars = _folded(kernels.fused_bf16_products_plain(rawp, Wp.abs()))
    checks = {}
    for name, fn in (("pipelined", kernels.profile_pipelined_products),
                     ("stacked", kernels.profile_stacked_products)):
        checks[name] = {}
        for x, y, bar, nm in zip(prod, _folded(fn(rawp, Wp)), bars,
                                 ("S1", "SQ", "SM")):
            d = (x - y).abs()
            rel = float((d / bar.clamp(min=1e-300)).max())
            checks[name][nm] = (float(d.max()), rel)
            print(f"{name} vs prod max|d| {nm}: {float(d.max()):g} (relative "
                  f"to the |wp| product: {rel:.3e})", flush=True)
    return dict(device=str(dev), card=card,
                shape=dict(N=N, P=P, K=K, B=B, nbp=nbp, Cw=Cw, blocks=NBLK,
                           rounds=R),
                lines=lines, checks=checks)


if __name__ == "__main__":
    main()
