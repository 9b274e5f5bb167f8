"""Batched gene-set VC score products (the gene-based device engine; the
port's counterpart of regenie_tpu/ops/vc_batch.py, in plain torch ops).

The reference computes each gene's weighted-genotype score products with
per-gene Eigen matmuls inside an OpenMP loop (update_vc_gmat SKAT.cpp:70,
compute_vc_mats_qt SKAT.cpp:643). Here the per-set [N, M] weighted
matrices of a bucket of sets go to the device as 2-bit BED codes, plus a
few dense ultra-rare collapse columns, and a loop over sample chunks
decodes, imputes and weights them there and accumulates the three
products every VC test needs:

    GtG[s] = GW_s^T GW_s      [Mt, Mt]   (kernel)
    GtX[s] = GW_s^T X         [Mt, K]    (covariate projection)
    GtY[s] = GW_s^T Yres      [Mt, P]    (score numerators)

The products are float64 batched matmuls (no hand-written kernel: the
JAX package runs this as a jit-compiled scan, not a Pallas kernel).

Bucket invariance: a set's products must not depend on the bucket it
lands in, so that any REGENIE_TPU_GENE_BUCKET writes the same bytes.
Each set occupies its own padded slot (pad columns carry weight 0), the
chunk size is a fixed constant, and every launch has one fixed shape:
the slots go through the chunk loop in batches of exactly SLOTS_PER_CALL,
the last batch padded with zero slots. A batched matmul library may pick
another algorithm (another reduction split) for another batch count;
with the batch count fixed it picks the same one for every bucket.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

# Samples per chunk. FIXED: the accumulation order over chunks is part
# of the numeric contract (bucket-composition invariance).
CHUNK_SAMPLES = 8192
_CB = CHUNK_SAMPLES // 4  # packed bytes per chunk
# Slots per launch. FIXED, for the same reason: every batched product
# has this batch count whatever the bucket size.
SLOTS_PER_CALL = 16

_SHIFTS = (0, 2, 4, 6)


def _vc_chunks(codes_c, ur_c, flip, imp, w, ind_c, X_c, Y_c):
    """One batch of slots' products over the sample chunks.

    codes_c: [nch, S, Mm, CB] uint8 packed 2-bit BED codes
    ur_c:    [nch, S, U, NC] dense ultra-rare collapse columns (weighted)
    flip:    [S, Mm] bool   (af1 > 0.5 -> 2 - g)
    imp:     [S, Mm]        (missing -> 2*maf, post-flip)
    w:       [S, Mm]        (Beta(a1,a2) / user weights; 0 marks padding)
    ind_c:   [nch, NC]      (ind_in_analysis, 0 on sample padding)
    X_c:     [nch, NC, K]; Y_c: [nch, NC, P]
    Returns [S, Mt, Mt + K + P]: GtG | GtX | GtY, Mt = Mm + U.
    """
    dt = X_c.dtype
    nch, S, Mm, CB = codes_c.shape
    U = ur_c.shape[2]
    K, P = X_c.shape[2], Y_c.shape[2]
    Mt = Mm + U
    dev = X_c.device
    shifts = torch.tensor(_SHIFTS, dtype=torch.uint8, device=dev)
    gtg = torch.zeros((S, Mt, Mt), dtype=dt, device=dev)
    gtx = torch.zeros((S, Mt, K), dtype=dt, device=dev)
    gty = torch.zeros((S, Mt, P), dtype=dt, device=dev)
    flip3, imp3, w3 = flip[..., None], imp[..., None], w[..., None]
    for j in range(nch):
        # 2-bit decode (ref-last BED codes: 0->hom-alt 2, 1->missing,
        # 2->het 1, 3->hom-ref 0), as ops.geno_ops.decode_bed_packed
        c = (codes_c[j][..., None] >> shifts) & 3  # [S, Mm, CB, 4]
        c = c.reshape(S, Mm, CB * 4)
        g = 2.0 * (c == 0).to(dt) + (c == 2).to(dt)
        base = torch.where(flip3, 2.0 - g, g)
        # the elementwise chain (and multiply order) of the host dense
        # path in models.skat.vc_prep: flip -> impute -> *ind -> *w
        val = torch.where(c == 1, imp3, base)
        val = val * ind_c[j][None, None, :]
        val = val * w3
        full = torch.cat([val, ur_c[j]], dim=1)  # [S, Mt, NC]
        gtg = gtg + torch.matmul(full, full.transpose(1, 2))
        gtx = gtx + torch.matmul(full, X_c[j])
        gty = gty + torch.matmul(full, Y_c[j])
    return torch.cat([gtg, gtx, gty], dim=2)


class VCDeviceCache:
    """Per-run device operands of the VC products: the sample-chunked
    covariate basis and analysis mask (fixed) and the residual matrix
    (per LOCO chromosome), on `device`. Built once, reused for every
    bucket."""

    def __init__(self, X: np.ndarray, ind: np.ndarray, device):
        self.device = torch.device(device)
        N, K = X.shape
        self.N = N
        self.nch = max(1, -(-N // CHUNK_SAMPLES))
        self.Np = self.nch * CHUNK_SAMPLES
        padN = self.Np - N
        Xp = np.pad(np.asarray(X, np.float64), ((0, padN), (0, 0)))
        indp = np.pad(ind.astype(np.float64), (0, padN))
        self.X_c = torch.from_numpy(Xp.reshape(self.nch, CHUNK_SAMPLES, K)).to(self.device)
        self.ind_c = torch.from_numpy(indp.reshape(self.nch, CHUNK_SAMPLES)).to(self.device)
        self.chrom = None
        self.Y_c = None
        self.ytX = None  # host float64 [P, K]

    def set_residuals(self, chrom, yres: np.ndarray, X: np.ndarray):
        if self.chrom == chrom:
            return
        padN = self.Np - self.N
        Yp = np.pad(np.asarray(yres, np.float64), ((0, padN), (0, 0)))
        self.Y_c = torch.from_numpy(Yp.reshape(self.nch, CHUNK_SAMPLES, -1)).to(self.device)
        self.ytX = yres.T @ X
        self.chrom = chrom


def _pad_dim(m: int, lo: int = 8) -> int:
    """Per-set deterministic column padding (next power of two, floor
    `lo`), part of the numeric contract: a set's slot shape must not
    depend on which bucket it lands in."""
    p = lo
    while p < m:
        p *= 2
    return p


def pack_slots(cache: VCDeviceCache, codes, urs, flips, imps, ws, Mm: int,
               U: int):
    """SLOTS_PER_CALL slots of the given sets (at most that many), padded
    to Mm main and U ultra-rare columns and the chunked sample axis, as
    _vc_chunks' operands on the cache's device: (codes_c, ur_c, flip,
    imp, w)."""
    Sc = SLOTS_PER_CALL
    NBp = cache.nch * _CB
    cod = np.zeros((Sc, Mm, NBp), np.uint8)
    flp = np.zeros((Sc, Mm), bool)
    imp = np.zeros((Sc, Mm), np.float64)
    wgt = np.zeros((Sc, Mm), np.float64)
    urv = np.zeros((Sc, U, cache.Np), np.float64)
    for k in range(len(codes)):
        m = codes[k].shape[0]
        cod[k, :m, : codes[k].shape[1]] = codes[k]
        flp[k, :m] = flips[k]
        imp[k, :m] = imps[k]
        wgt[k, :m] = ws[k]
        u = urs[k].shape[1]
        if u:
            urv[k, :u, : cache.N] = urs[k].T
    codes_c = np.ascontiguousarray(
        cod.reshape(Sc, Mm, cache.nch, _CB).transpose(2, 0, 1, 3))
    ur_c = np.ascontiguousarray(
        urv.reshape(Sc, U, cache.nch, CHUNK_SAMPLES).transpose(2, 0, 1, 3))
    dev = cache.device
    return tuple(torch.from_numpy(a).to(dev) for a in (codes_c, ur_c, flp, imp, wgt))


def bucket_products(
    cache: VCDeviceCache,
    codes: List[np.ndarray],   # per set [m_i, NB] uint8
    urs: List[np.ndarray],     # per set [N, u_i] f64 (weighted, masked)
    flips: List[np.ndarray],   # per set [m_i] bool
    imps: List[np.ndarray],    # per set [m_i] f64
    ws: List[np.ndarray],      # per set [m_i] f64
) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Products for one equal-pad group of sets (all m_i pad to the same
    Mm, all u_i to the same U: the caller groups by (_pad_dim(m), U)).
    Returns per set (GtG [Mt_i, Mt_i], GtX [Mt_i, K], GtY [Mt_i, P]) with
    padding rows/cols stripped, main columns first then ultra-rare. The
    slots run SLOTS_PER_CALL at a time; each batch's three products come
    back to the host in one packed copy."""
    S = len(codes)
    Mm = _pad_dim(max(c.shape[0] for c in codes))
    U = max((u.shape[1] for u in urs), default=0)
    U = 0 if U == 0 else _pad_dim(U, 1)
    Mt = Mm + U
    K = cache.X_c.shape[2]

    out = []
    for lo in range(0, S, SLOTS_PER_CALL):
        sl = slice(lo, lo + SLOTS_PER_CALL)
        ops = pack_slots(cache, codes[sl], urs[sl], flips[sl], imps[sl], ws[sl],
                         Mm, U)
        blk = _vc_chunks(*ops, cache.ind_c, cache.X_c, cache.Y_c).cpu().numpy()
        gtg = blk[:, :, :Mt]
        gtx = blk[:, :, Mt : Mt + K]
        gty = blk[:, :, Mt + K :]
        for k, s in enumerate(range(lo, min(lo + SLOTS_PER_CALL, S))):
            m = codes[s].shape[0]
            u = urs[s].shape[1]
            rows = np.concatenate([np.arange(m), Mm + np.arange(u)]).astype(int)
            out.append((gtg[k][np.ix_(rows, rows)], gtx[k][rows], gty[k][rows]))
    return out
