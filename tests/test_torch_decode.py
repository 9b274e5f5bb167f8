"""Tests of the port's plane decode (regenie_tpu_torch/ops/pallas_ops.py):
decode_bed_planes against the JAX package's Pallas _decode_kernel in
interpret mode and against the file-order decode, plane_aux_order against
the JAX package's, the permuted-reduction identity of
tests/test_pallas_mesh.py:25-31; and, with marker `cuda`, the
hand-written decode_planes kernel against its plain version. On the GPU
machine, which has no JAX, run the card's tests with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_decode.py
"""

import numpy as np
import pytest
import torch

from regenie_tpu_torch.ops import kernels
from regenie_tpu_torch.ops import pallas_ops as tpo


@pytest.fixture(scope="module")
def jpo():
    """The JAX package's pallas_ops (tests that take it skip where JAX is
    not installed)."""
    pytest.importorskip("jax")
    from regenie_tpu.ops import pallas_ops

    return pallas_ops


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("B,N", [(64, 997), (32, 1024), (3, 5)])
def test_decode_bed_planes_matches_jax_interpret(jpo, B, N):
    """decode_bed_planes on a CPU tensor (the plain version, no launch)
    equals the JAX package's decode_bed_planes(interpret=True) exactly,
    including byte counts off the TPU kernel's tiles."""
    import jax.numpy as jnp

    rng = np.random.default_rng(N)
    raw = rng.integers(0, 256, size=(B, (N + 3) // 4), dtype=np.uint8)
    n0 = kernels.decode_planes.launches
    got = tpo.decode_bed_planes(torch.from_numpy(raw))
    assert kernels.decode_planes.launches == n0
    want = np.asarray(jpo.decode_bed_planes(jnp.asarray(raw), interpret=True))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_decode_bed_planes_matches_file_order_decode():
    """Reordered back to file order, the planes equal the JAX package's
    file-order decode (2 / -3 / 1 / 0), as tests/test_pallas_mesh.py:11
    checks the TPU kernel."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from regenie_tpu.ops.geno_ops import decode_bed_packed

    rng = np.random.default_rng(0)
    B, N = 64, 997
    nb = (N + 3) // 4
    raw = rng.integers(0, 256, size=(B, nb), dtype=np.uint8)
    ref = np.asarray(decode_bed_packed(jnp.asarray(raw), N)).astype(np.float32)
    planes = tpo.decode_bed_planes(torch.from_numpy(raw)).numpy()
    s = np.arange(N)
    np.testing.assert_array_equal(planes[:, (s % 4) * nb + s // 4], ref)


@pytest.mark.parametrize("N,nb", [(997, 250), (8, 2), (1025, 320)])
def test_plane_aux_order_matches_jax(jpo, N, nb):
    """plane_aux_order equals the JAX package's, padding slots
    included."""
    idx, valid = tpo.plane_aux_order(N, nb)
    jidx, jvalid = jpo.plane_aux_order(N, nb)
    assert idx.dtype == np.int32
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_array_equal(valid, jvalid)


def test_permuted_reduction_identity():
    """Auxiliary arrays permuted by plane_aux_order give the same sample
    reductions on the planes as on the file-order genotypes (the identity
    of tests/test_pallas_mesh.py:25-31), here in float64 to 1e-12."""
    rng = np.random.default_rng(1)
    B, N = 16, 997
    nb = (N + 3) // 4
    raw = rng.integers(0, 256, size=(B, nb), dtype=np.uint8)
    planes = tpo.decode_bed_planes_plain(torch.from_numpy(raw)).numpy()
    s = np.arange(N)
    ref = planes[:, (s % 4) * nb + s // 4].astype(np.float64)
    idx, valid = tpo.plane_aux_order(N, nb)
    aux = rng.normal(size=N)
    aux_p = np.where(valid, aux[idx], 0.0)
    lhs = np.where(ref == -3, 0, ref) @ aux
    rhs = np.where(planes == -3, 0, planes).astype(np.float64) @ aux_p
    np.testing.assert_allclose(lhs, rhs, rtol=1e-12, atol=1e-12)


@pytest.mark.cuda
def test_decode_planes_kernel_matches_plain_on_cuda(cuda):
    """decode_planes on the card equals its plain version exactly, on byte
    counts that are and are not multiples of 4 and on a row count off any
    tile; each call counts one launch."""
    rng = np.random.default_rng(2)
    for B, nb in ((37, 250), (5, 257), (130, 1024), (1, 3)):
        raw = torch.from_numpy(rng.integers(0, 256, (B, nb), dtype=np.uint8)).to(cuda)
        n0 = kernels.decode_planes.launches
        got = tpo.decode_bed_planes(raw)
        assert kernels.decode_planes.launches == n0 + 1
        want = tpo.decode_bed_planes_plain(raw)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
