"""Device-side genotype block preparation for Step 1 (the port's copy of
the Step-1 part of regenie_tpu/ops/geno_ops.py).

The host ships packed PLINK 2-bit bytes; the card unpacks them to int8
hardcalls [B, N] (values {0, 1, 2, -3}), then masks out-of-analysis
samples and mean-imputes missing genotypes in float64 — replacing the
reference's host-side LUT (buildLookupTable, Geno.cpp:2833) and per-SNP
loops (get_G -> mean_impute_g). Both are exact: the decode is a table
lookup and the imputation means are integer sums in float64.
"""

from __future__ import annotations

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

    G_int8: [B, N] int8; ind_in_analysis: [N] bool, on G's device.
    Returns G: [B, N] `dtype`, imputed and masked."""
    G = G_int8.to(dtype)
    is_missing = G_int8 == MISSING
    valid = ~is_missing & ind_in_analysis[None, :]
    total = torch.where(valid, G, 0.0).sum(dim=1)
    mean = total / valid.sum(dim=1).to(dtype)
    G = torch.where(is_missing, mean[:, None], G)
    return G * ind_in_analysis.to(dtype)[None, :]
