"""remeta SKAT LD-matrix writer (--remeta-save-ld; the port's copy of
regenie_tpu/io/remeta.py).

Byte-compatible with the reference's RegenieLDMatrixWriter
(external_libs/remeta/regenie_ld_matrix_writer.cpp): a BGZF stream
{prefix}.rg.ld starting with int32 sample size, followed per gene by a
sparse ('s', nrows, threshold, variances, (i,j,corr) entries,
(-1,-1,0) footer) or dense ('d', nrows, 0, lower-tri floats) record;
the BGZF index {prefix}.rg.ld.idx.gz lists "gene\\taddr\\tids".
"""

from __future__ import annotations

import struct
from typing import List

import numpy as np

from .bgzf import BgzfWriter


class RegenieLDMatrixWriter:
    def __init__(self, prefix: str, sample_size: int):
        self._w = BgzfWriter(prefix + ".rg.ld")
        self._idx = BgzfWriter(prefix + ".rg.ld.idx.gz")
        self._w.write_int32(int(sample_size))

    def write_matrix_sparse(self, ld_mat: np.ndarray, gene_name: str,
                            variant_ids: List[str], threshold: float):
        n = ld_mat.shape[0]
        assert ld_mat.shape[1] == n and len(variant_ids) == n
        variances = np.diag(ld_mat).astype(np.float64)
        sd = np.where(variances > 0, np.sqrt(np.where(variances > 0, variances, 1.0)), 0.0)
        with np.errstate(divide="ignore", invalid="ignore"):
            inv = np.where(sd > 0, 1.0 / np.where(sd > 0, sd, 1.0), 0.0)
        corr = ld_mat * inv[:, None] * inv[None, :]

        addr = self._w.tell()
        self._w.write(b"s")
        self._w.write_int32(n)
        self._w.write_float(threshold)
        for v in variances:
            self._w.write_float(float(v))
        self._write_idx(gene_name, variant_ids, addr)

        for i in range(n):
            for j in range(i):
                if abs(corr[i, j]) > threshold:
                    self._w.write(struct.pack("<iif", i, j, float(corr[i, j])))
        self._w.write(struct.pack("<iif", -1, -1, 0.0))

    def write_matrix_dense(self, ld_mat: np.ndarray, gene_name: str,
                           variant_ids: List[str]):
        n = ld_mat.shape[0]
        addr = self._w.tell()
        self._w.write(b"d")
        self._w.write_int32(n)
        self._w.write_int32(0)
        for i in range(n):
            for j in range(i + 1):
                self._w.write_float(float(ld_mat[i, j]))
        self._write_idx(gene_name, variant_ids, addr)

    def _write_idx(self, gene_name, variant_ids, addr):
        self._idx.write_str(f"{gene_name}\t{addr}\t" + ",".join(variant_ids) + "\n")

    def close(self):
        self._idx.close()
        self._w.close()
