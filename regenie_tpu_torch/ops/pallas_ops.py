"""PLINK 2-bit decode into bit-plane order (the port of
regenie_tpu/ops/pallas_ops.py; the module keeps its name so that a reader
finds the counterpart).

decode_bed_planes turns packed bytes [B, nb] into float32 genotypes in a
BIT-PLANE layout: plane p holds every 4th sample starting at p, so column
p*nb + c is sample 4c + p. Each output element is a shift, a mask and a
select of one input byte, with no shuffle across samples. Per-sample
auxiliary arrays (residuals, masks, covariates) are permuted once into
plane order with plane_aux_order; every reduction over samples is
invariant under the permutation.

A CUDA tensor goes through the hand-written kernel (ops/kernels.py
decode_planes, csrc/decode_planes.cu) or raises; a CPU tensor takes the
kernel's plain version. No production path of the port calls it, as none
of the JAX package does.
"""

from __future__ import annotations

import numpy as np

from . import kernels


def decode_bed_planes(raw):
    """[B, nb] packed uint8 tensor -> [B, 4*nb] float32 in bit-plane
    order: column p*nb + c holds the genotype of file-order sample 4c + p,
    2 / -3 / 1 / 0 for PLINK codes 0 / 1 / 2 / 3 (hom-alt, missing, het,
    hom-ref)."""
    return kernels.decode_planes(raw)


# the plain PyTorch version of decode_bed_planes, on any device
decode_bed_planes_plain = kernels.decode_planes_plain


def plane_aux_order(n_samples: int, nb: int):
    """Indices mapping file-order per-sample arrays into plane order.

    Returns (idx [4*nb] int32 clipped to the valid range, valid [4*nb]
    bool): aux_planes = where(valid, aux[idx], 0) aligns with the
    decode_bed_planes columns; invalid slots (padding samples) must be
    masked to 0."""
    i = np.arange(4 * nb)
    src = 4 * (i % nb) + i // nb
    valid = src < n_samples
    return np.where(valid, src, 0).astype(np.int32), valid
