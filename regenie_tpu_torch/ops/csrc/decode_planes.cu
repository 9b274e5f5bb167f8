// PLINK 2-bit decode into bit-plane order for Hopper (sm_90a): packed
// genotype bytes [B, nb] -> float32 genotypes [B, 4*nb], column p*nb + c
// holding sample 4c + p (plane p of byte c).
//
// Replaces the Pallas TPU kernel regenie_tpu/ops/pallas_ops.py:27
// (_decode_kernel, launched by decode_bed_planes at :46).
//
// Values: code_p(x) = (x >> 2p) & 3 -> 2 / -3 / 1 / 0 for codes
// 0 / 1 / 2 / 3 (hom-alt, missing, het, hom-ref).
//
// Bound: one elementwise pass, B x nb bytes read and 16 x B x nb bytes
// written; at the repository's full width (B=2048, nb=100,000) 0.205 GB
// + 3.277 GB = 3.48 GB, 1.04 ms at 3.35 TB/s: bound by bytes. The design
// does about it what an elementwise pass can: each thread reads one
// 32-bit word (4 bytes) of a row and writes one float4 to each of the
// four planes, so neighbouring threads read and write neighbouring
// addresses (coalesced 16-byte stores); rows whose byte count is not a
// multiple of 4 take a byte-at-a-time path.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;

__device__ __forceinline__ float val(const uint32_t code) {
  return code == 0 ? 2.f : code == 1 ? -3.f : code == 2 ? 1.f : 0.f;
}

// grid.x covers the 4-byte groups of a row, grid.y the rows
__global__ void __launch_bounds__(NTHREADS)
decode_planes_kernel(const uint8_t *__restrict__ raw, float *__restrict__ out,
                     const long long nb) {
  const long long q = (long long)blockIdx.x * NTHREADS + threadIdx.x;
  const long long b = blockIdx.y;
  const long long c = 4 * q;
  if (c >= nb) return;
  const uint8_t *row = raw + b * nb;
  float *orow = out + b * 4 * nb;
  if ((nb & 3) == 0) {
    const uint32_t w = *reinterpret_cast<const uint32_t *>(row + c);
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const uint32_t s = w >> (2 * p);
      *reinterpret_cast<float4 *>(orow + p * nb + c) =
          make_float4(val(s & 3), val((s >> 8) & 3), val((s >> 16) & 3),
                      val((s >> 24) & 3));
    }
  } else {
    for (long long i = c; i < c + 4 && i < nb; ++i) {
      const uint32_t x = row[i];
#pragma unroll
      for (int p = 0; p < 4; ++p) orow[p * nb + i] = val((x >> (2 * p)) & 3);
    }
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). Launches on `stream`, does not
// synchronise and allocates nothing; returns cudaGetLastError(). Requires
// B below 65,536 (the grid's y) and raw 4-byte aligned; the Python wrapper
// checks type, shape, contiguity and alignment.
extern "C" int decode_planes_launch(const void *raw, void *out, long long B,
                                    long long nb, void *stream) {
  const long long groups = (nb + 3) / 4;
  const dim3 grid((unsigned)((groups + NTHREADS - 1) / NTHREADS), (unsigned)B);
  decode_planes_kernel<<<grid, NTHREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const uint8_t *>(raw), static_cast<float *>(out), nb);
  return (int)cudaGetLastError();
}
