"""Attribution of the BGEN int8 products' time on the card: the port's
counterpart of scripts/profile_bgen.py.

    python -m regenie_tpu_torch.scripts.profile_bgen [variants|variants2|variants3]
    REGENIE_TPU_TORCH_DEVICE=cpu BENCH_N=1000 BENCH_P=3 BENCH_K=2 BENCH_B=16 \\
        python -m regenie_tpu_torch.scripts.profile_bgen variants   # plain versions

Builds the JAX script's synthetic inputs at the UKB bench shape: the int8
limbs of the sample-packed operand, build_consts(split="i8",
pack="sample") of a QR covariate basis (BENCH_K=20 columns) and normal
residuals (BENCH_P=50 traits, all complete), and of the narrow Wq =
sample_pack([maskf | ind]), both from numpy.random.default_rng(0) as the
JAX script builds them (N=400,000 samples: Np = 400,128, Cw = Cq = 512);
and BENCH_BLOCKS=4 blocks of BENCH_B=2048 variants (the port's block; the
JAX script's is 1024) of byte planes k0 ~ U{0..199}, k1 =
min(U{0..199}, 255 - k0). The planes are drawn on the device with a
seeded torch.Generator, 256 rows at a time (numpy's rng.integers at
that size would allocate int64, ~6.5 GB an array), so their bits are
not the JAX script's; pad samples are zero. Modes, and their lines under
the JAX script's names:

  (none)     2% of the samples set to the 255 sentinel, planes as one
             [B, 2, Np] buffer: prod (bgen_fused_products: the bgen_i8
             kernel on the operands' K-major limbs_k, and the fold; the
             variants read the [Np, C] limbs), then base-i32miss-3q in each Hopper
             configuration (kernels.PROFILE_BGEN_CONFIGS), in place of the
             TPU script's (tb, tc) sweep
  variants   no missing sample, one [B, 2, Np] buffer: base(=prod),
             no-q, u8-xor-wdots
  variants2  no missing sample, k0 and k1 as two [B, Np] tensors:
             sep-planes, sep-noq, sep-merge2dot
  variants3  as variants2: base-i32miss-3q, e2-2q, dhl-2q+2tiny

Each line gives ms per block (the best of BENCH_ROUNDS=5 rounds over the
BENCH_BLOCKS distinct blocks, after one warm-up call; CUDA events on the
card), SNPs/s, and the variant's own int8 dot count (2 x Np x (3 Cw + n
Cq) per SNP, n = 3 for the q3 products, 0 for no-q, 2 for e2, 4 for dhl)
over that time as TOP/s and as a share of the H100's 1,979 dense int8
TOP/s. The card line (nvidia-smi name and power limit) comes first; last
come the checks: each line's kernel against its plain version on the
first block, max |d|, which must be 0 (main raises otherwise).

It runs on the card unless REGENIE_TPU_TORCH_DEVICE=cpu (or device="cpu")
asks for the CPU, where every wrapper takes its plain version and a line
gives the host time of that and no rate. main() takes the mode and the
knobs as arguments too, so that chip_smoke.py and the tests call it
in-process.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from ..ops import fused_score as fsc
from ..ops import kernels
from ..utils.device import resolve_device
from .profile_fused import _best_ms, _knob, card_line

PEAK_INT8_OPS = 1979e12  # dense int8 tensor-core rate of one H100 SXM (700 W)
MODES = ("default", "variants", "variants2", "variants3")
# q products per SNP of each q mode, against the narrow operand
N_Q = {"q3": 3, "noq": 0, "e2": 2, "dhl": 4}


def lines_of(mode):
    """(line name, profile_bgen variant or None for prod, configuration)
    in the order of the mode's lines."""
    if mode == "default":
        return [("prod", None, 0)] + [
            (f"base-i32miss-3q ({c})", "u8_unshift_q3", i)
            for i, c in enumerate(kernels.PROFILE_BGEN_CONFIGS)]
    return {
        "variants": [("base(=prod)", "i32_shift_q3", 0), ("no-q", "i32_shift_noq", 0),
                     ("u8-xor-wdots", "u8_shift_q3", 0)],
        "variants2": [("sep-planes", "i32_shift_q3", 0), ("sep-noq", "i32_shift_noq", 0),
                      ("sep-merge2dot", "u8_unshift_q3_stacked", 0)],
        "variants3": [("base-i32miss-3q", "u8_unshift_q3", 0),
                      ("e2-2q", "u8_unshift_e2", 0),
                      ("dhl-2q+2tiny", "u8_unshift_dhl", 0)],
    }[mode]


def make_operands(N, P, K, device):
    """The JAX script's operands: FusedConsts with the int8 sample-packed
    Wp, and the narrow Wq I8Operand of [maskf | ind]."""
    rng = np.random.default_rng(0)
    cov = np.linalg.qr(rng.normal(size=(N, K)))[0]
    res = rng.normal(size=(N, P))
    maskf = np.ones((N, P))
    ind = np.ones(N, bool)
    consts = fsc.build_consts(cov, res, maskf, ind, float(N - K), device=device,
                              split="i8", pack="sample")
    tailz = np.concatenate([maskf * ind[:, None], ind[:, None].astype(float)], axis=1)
    Wq, _ = fsc.sample_pack(tailz, "i8", device)
    return consts, Wq


def make_blocks(B, N, Np, n_blocks, packed, miss, device, seed=0):
    """n_blocks blocks of byte planes on `device`, each {"planes": the [B,
    2, Np] buffer or None, "k0", "k1": [B, Np] uint8 views of it, or two
    tensors}: k0 ~ U{0..199}, k1 = min(U{0..199}, 255 - k0), a share
    `miss` of the samples set to 255 / 255, pad samples zero; drawn with a
    torch.Generator seeded `seed`, 256 rows at a time."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    blocks = []
    for _ in range(n_blocks):
        if packed:
            planes = torch.zeros((B, 2, Np), dtype=torch.uint8, device=device)
            k0, k1 = planes[:, 0], planes[:, 1]
        else:
            planes = None
            k0, k1 = (torch.zeros((B, Np), dtype=torch.uint8, device=device)
                      for _ in range(2))
        for r0 in range(0, B, 256):
            nr = min(256, B - r0)
            a = torch.randint(0, 200, (nr, N), generator=gen, device=device,
                              dtype=torch.uint8)
            b = torch.minimum(torch.randint(0, 200, (nr, N), generator=gen,
                                            device=device, dtype=torch.uint8),
                              255 - a)
            if miss:
                m = torch.rand((nr, N), generator=gen, device=device) < miss
                a, b = a.masked_fill(m, 255), b.masked_fill(m, 255)
            k0[r0 : r0 + nr, :N] = a
            k1[r0 : r0 + nr, :N] = b
        blocks.append(dict(planes=planes, k0=k0, k1=k1))
    return blocks


def main(mode="default", n=None, p=None, k=None, b=None, rounds=None, blocks=None,
         device=None) -> dict:
    """Run the mode's lines and print them; each knob defaults to its
    BENCH_* variable. Returns {"device", "card", "mode", "shape", "lines":
    [{name, variant, config, ms, snps_per_s, tops, peak_share}] (no rates
    on the CPU), "checks": {line name: max |kernel - plain| on the first
    block}}; raises AssertionError after the check lines if one is not 0."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} is not one of {', '.join(MODES)}")
    N = _knob(n, "BENCH_N", 400_000)
    P = _knob(p, "BENCH_P", 50)
    K = _knob(k, "BENCH_K", 20)
    B = _knob(b, "BENCH_B", 2048)
    R = _knob(rounds, "BENCH_ROUNDS", 5)
    NBLK = _knob(blocks, "BENCH_BLOCKS", 4)
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    card = card_line() if on_card else None
    print(card if on_card else "device: cpu (plain versions)", flush=True)

    consts, Wq = make_operands(N, P, K, dev)
    wl, ql = consts.Wp.limbs, Wq.limbs
    wk, qk = consts.Wp.limbs_k, Wq.limbs_k  # bgen_i8's K-major copies
    Np, Cw, Cq = wl.shape[0], wl.shape[1], ql.shape[1]
    C_used = consts.layout_C()
    blks = make_blocks(B, N, Np, NBLK, mode in ("default", "variants"),
                       0.02 if mode == "default" else 0.0, dev)
    print(f"mode={mode} N={N} P={P} K={K} B={B} Np={Np} Cw={Cw} Cq={Cq} "
          f"blocks={NBLK} rounds={R}", flush=True)

    def call(variant, config):
        if variant is None:
            return lambda x: fsc.bgen_fused_products(
                x["planes"], consts.Wp, Wq=Wq, qs=C_used - (P + 1), C_used=C_used)
        return lambda x: kernels.PROFILE_BGEN[variant](x["k0"], x["k1"], wl, ql,
                                                       config=config)

    lines = []
    for name, variant, config in lines_of(mode):
        ms = _best_ms(call(variant, config), blks, R, on_card)
        snps = B / ms * 1e3
        q = "q3" if variant is None else kernels.PROFILE_BGEN_VARIANTS[variant][1]
        ops_per_snp = 2.0 * Np * (3 * Cw + N_Q[q] * Cq)
        line = dict(name=name, variant=variant, config=config, ms=ms,
                    snps_per_s=snps, tops=None, peak_share=None)
        if on_card:
            line["tops"] = snps * ops_per_snp / 1e12
            line["peak_share"] = line["tops"] * 1e12 / PEAK_INT8_OPS
            print(f"{name:50s} {ms:10.3f} ms  {snps:12.0f} SNPs/s  "
                  f"{line['tops']:8.1f} TOP/s ({line['peak_share']:.1%} of peak)",
                  flush=True)
        else:
            print(f"{name:50s} {ms:10.3f} ms  {snps:12.0f} SNPs/s  (host time of "
                  "the plain version)", flush=True)
        lines.append(line)

    # each line's kernel against its plain version on the first block
    x = blks[0]
    checks = {}
    for name, variant, config in lines_of(mode):
        if variant is None:
            got = kernels.bgen_i8_products(x["planes"], wk, qk)
            want = kernels.bgen_i8_products_plain(x["planes"], wk, qk)
        else:
            got = kernels.PROFILE_BGEN[variant](x["k0"], x["k1"], wl, ql,
                                                config=config)
            want = kernels.profile_bgen_products_plain(x["k0"], x["k1"], wl, ql,
                                                       variant)
        checks[name] = max(int((g - w).abs().max()) for g, w in zip(got, want))
        print(f"{name} vs plain max|d|: {checks[name]}", flush=True)
    bad = {k: v for k, v in checks.items() if v}
    if bad:
        raise AssertionError(f"kernels differ from their plain versions: {bad}")
    return dict(device=str(dev), card=card, mode=mode,
                shape=dict(N=N, P=P, K=K, B=B, Np=Np, Cw=Cw, Cq=Cq, blocks=NBLK,
                           rounds=R),
                lines=lines, checks=checks)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "default")
