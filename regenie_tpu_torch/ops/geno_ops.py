"""Device-side genotype block preparation (the port's copy of
regenie_tpu/ops/geno_ops.py), in torch on the tensors' device.

The host ships packed PLINK 2-bit bytes, which the card unpacks to int8
hardcalls [B, N] (values {0, 1, 2, -3}), or float64 dosages (missing =
-3). Step 1 masks out-of-analysis samples and mean-imputes missing
genotypes (prepare_block_step1); the dense Step-2 route takes each
block's per-variant statistics in one pass (snp_stats_block: totals,
AF, MAC and class counts, per trait through the mask matrix, with the
chrX non-PAR male rules) and imputes it (finalize_block_step2) —
replacing the reference's host-side LUT (buildLookupTable,
Geno.cpp:2833) and per-SNP loops (parseSnpfromBed, Geno.cpp:2414; get_G
-> mean_impute_g). The decode is a table lookup, and on hardcalls every
sum is of integers in float64, so exact.
"""

from __future__ import annotations

import numpy as np
import torch

MISSING = -3


def decode_bed_packed(raw: torch.Tensor, n_samples: int) -> torch.Tensor:
    """PLINK 2-bit decode on the tensor's device: [B, ceil(N/4)] uint8 ->
    [B, N] int8 {0, 1, 2, -3}, ref-last coding (00 -> 2, 01 -> -3
    missing, 10 -> 1, 11 -> 0; sample 4c + j in bits 2j of byte c)."""
    B, nb = raw.shape
    shifts = torch.arange(0, 8, 2, dtype=torch.uint8, device=raw.device)
    codes = ((raw.unsqueeze(-1) >> shifts) & 3).reshape(B, nb * 4)[:, :n_samples]
    lut = torch.tensor([2, MISSING, 1, 0], dtype=torch.int8, device=raw.device)
    return lut[codes.int()]


def prepare_block_step1(G_int8: torch.Tensor, ind_in_analysis: torch.Tensor,
                        dtype=torch.float64) -> torch.Tensor:
    """Step-1 block prep: mask out-of-analysis samples and mean-impute
    missing genotypes (reference get_G -> mean_impute_g path).

    G_int8: [B, N] int8 hardcalls or float64 dosages (missing = -3);
    ind_in_analysis: [N] bool, on G's device.
    Returns G: [B, N] `dtype`, imputed and masked."""
    G = G_int8.to(dtype)
    is_missing = G_int8 == MISSING
    valid = ~is_missing & ind_in_analysis[None, :]
    total = torch.where(valid, G, 0.0).sum(dim=1)
    mean = total / valid.sum(dim=1).to(dtype)
    G = torch.where(is_missing, mean[:, None], G)
    return G * ind_in_analysis.to(dtype)[None, :]


def snp_stats_block(G_raw: torch.Tensor, ind_in_analysis: torch.Tensor,
                    masked_indivs: torch.Tensor, non_par=None, sex=None,
                    skip_comp: bool = False) -> dict:
    """Batched per-variant statistics of a Step-2 block (the per-SNP stat
    loop of parseSnpfromBed, Geno.cpp:2414-2500, with its chrX non-PAR
    male handling, compute_mac :3077 and compute_aaf_info :3110): totals
    and counts over the analyzed samples, per trait through one mask
    product. On non-PAR chrX variants males (diploid-coded 0/2) count
    0.5*g toward the MAC and the mirrored minor count drops the male
    alleles; with skip_comp the caller halved male genotypes and the AF
    denominator drops one allele per male.

    G_raw: [B, N] int8 or float64 (missing = -3); ind_in_analysis: [N]
    bool; masked_indivs: [N, P] bool; non_par: [B] bool or None; sex:
    [N] int (1 = male) or None; all on one device. Returns a dict of
    float64 tensors: total, ns, af1, mac1 [B]; af, mac, ns_t [B, P];
    n_rr, n_aa [B] (integer counts)."""
    f64 = torch.float64
    G = G_raw.to(f64)
    is_missing = G == MISSING
    valid = ~is_missing & ind_in_analysis[None, :]
    validf = valid.to(f64)
    Gv = torch.where(valid, G, 0.0)
    total = Gv.sum(dim=1)
    ns = validf.sum(dim=1)
    maskf = masked_indivs.to(f64)
    total_t = Gv @ maskf
    ns_t = validf @ maskf

    if non_par is None or sex is None:
        return dict(
            total=total, ns=ns, af1=total / (2.0 * ns),
            af=total_t / (2.0 * ns_t),
            mac=torch.minimum(total_t, 2.0 * ns_t - total_t), ns_t=ns_t,
            n_rr=((G < 0.5) & valid).sum(dim=1).to(f64),
            n_aa=((G >= 1.5) & valid).sum(dim=1).to(f64),
            mac1=torch.minimum(total, 2.0 * ns - total),
        )

    male = (sex == 1)[None, :] & valid
    half = non_par[:, None] & male
    malef = male.to(f64)
    nmales = torch.where(non_par, malef.sum(dim=1), 0.0)
    nmales_t = (malef @ maskf) * non_par[:, None]
    # male allele count: g/2 unless the caller already halved (skip_comp)
    mval = Gv if skip_comp else torch.where(half, Gv * 0.5, Gv)
    mac1 = mval.sum(dim=1)
    mac_t_raw = mval @ maskf
    # with skip_comp a male carries one allele
    af1 = total / (2.0 * ns - (nmales if skip_comp else 0.0))
    af_t = total_t / (2.0 * ns_t - (nmales_t if skip_comp else 0.0))
    mac_t = torch.where(
        non_par[:, None],
        torch.minimum(mac_t_raw, 2.0 * ns_t - nmales_t - mac_t_raw),
        torch.minimum(total_t, 2.0 * ns_t - total_t),
    )
    # genotype class counts: non-PAR males are hemizygous 0/1; with
    # skip_comp the genotypes were already halved so standard thresholds
    # apply (Geno.cpp:2479-2486)
    hemi = torch.zeros_like(half) if skip_comp else half
    thr_rr = torch.where(hemi, 1.0, 0.5)
    thr_aa = torch.where(hemi, 1.0 - 1e-9, 1.5)
    n_rr = ((G < thr_rr) & valid).sum(dim=1).to(f64)
    n_aa = ((G >= thr_aa) & valid).sum(dim=1).to(f64)
    mac1_m = torch.where(
        non_par,
        torch.minimum(mac1, 2.0 * ns - nmales - mac1),
        torch.minimum(total, 2.0 * ns - total),
    )
    return dict(total=total, ns=ns, af1=af1, af=af_t, mac=mac_t, ns_t=ns_t,
                n_rr=n_rr, n_aa=n_aa, mac1=mac1_m)


def snp_stats_block_packed(raw: torch.Tensor, n_samples: int,
                           ind_in_analysis: torch.Tensor,
                           masked_indivs: torch.Tensor, non_par=None, sex=None,
                           skip_comp: bool = False) -> dict:
    """snp_stats_block on packed 2-bit BED-coded bytes [B, ceil(N/4)]
    (4 genotypes a byte over host->device, 4x less than int8), decoded on
    the device. Exact: pack_hardcalls / decode_bed_packed round-trip
    hardcalls {0, 1, 2, -3} bit for bit."""
    return snp_stats_block(decode_bed_packed(raw, n_samples), ind_in_analysis,
                           masked_indivs, non_par=non_par, sex=sex,
                           skip_comp=skip_comp)


# host-side inverse of decode_bed_packed's value map (2->00, -3->01,
# 1->10, 0->11), indexed by g+3 over the int8 domain {-3,0,1,2}
_PACK_LUT = np.zeros(6, np.uint8)
_PACK_LUT[-3 + 3] = 1
_PACK_LUT[0 + 3] = 3
_PACK_LUT[1 + 3] = 2
_PACK_LUT[2 + 3] = 0


def pack_hardcalls(arr: np.ndarray) -> np.ndarray:
    """[B, N] int8 hardcalls {0,1,2,-3} -> [B, ceil(N/4)] BED-coded
    bytes (decode_bed_packed inverts exactly)."""
    B, N = arr.shape
    pad = (-N) % 4
    codes = _PACK_LUT[arr.astype(np.int16) + 3]
    if pad:
        codes = np.concatenate(
            [codes, np.ones((B, pad), np.uint8)], axis=1)  # 01 = missing
    codes = codes.reshape(B, -1, 4)
    return (codes[:, :, 0] | (codes[:, :, 1] << 2)
            | (codes[:, :, 2] << 4) | (codes[:, :, 3] << 6)).astype(np.uint8)


def finalize_block_step2(G_raw: torch.Tensor, ind_in_analysis: torch.Tensor,
                         flip: torch.Tensor) -> torch.Tensor:
    """Flip to the minor allele where asked (flip_geno, Geno.cpp:3149),
    mean-impute missing genotypes over the analyzed samples and zero the
    others. G_raw: [B, N] int8 or float64 (missing = -3); flip: [B] bool.
    Returns G [B, N] float64."""
    f64 = torch.float64
    G = G_raw.to(f64)
    is_missing = G == MISSING
    G = torch.where(flip[:, None] & ~is_missing, 2.0 - G, G)
    valid = ~is_missing & ind_in_analysis[None, :]
    total = torch.where(valid, G, 0.0).sum(dim=1)
    mean = total / valid.sum(dim=1).to(f64)
    G = torch.where(is_missing, mean[:, None], G)
    return G * ind_in_analysis.to(f64)[None, :]
