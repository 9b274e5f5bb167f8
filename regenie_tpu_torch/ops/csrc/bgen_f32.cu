// BGEN 8-bit dosage products for Hopper (sm_90a) against the float32
// operands: the two per-sample probability byte planes of a variant block
// times the f32 sample-ordered operands, summed in float64 on the tensor
// cores.
//
// Replaces the Pallas TPU kernel regenie_tpu/ops/fused_score.py:1054
// (_bgen_kernel_split with its f32 operand, launched by
// bgen_fused_products at :1256), which REGENIE_TPU_I8=0 selects.
//
// What it computes, for planes [B, 2, Np] uint8 (k0 = P(hom first) * 255,
// k1 = P(het) * 255, missing = any pair with k0 + k1 > 255), the operand
// Wp [Np, Cw] float32 and the narrow operand Wq [Np, Cq] float32:
//   miss = k0 + k1 > 255;  k0, k1 = 0 where miss;  d2 = (2 k0 + k1)^2
//   D0 = k0 @ Wp,  D1 = k1 @ Wp,  M = miss @ Wp                 [B, Cw]
//   Q0 = (d2 & 255) @ Wq,  Q1 = (d2 >> 8 & 255) @ Wq,  Q2 = (d2 >> 16) @ Wq
//                                                               [B, Cq]
// as float64. Each product of a byte and an f32 value is exact in
// float64, so there is no -128 shift and no int64 chunking as in
// bgen_i8.cu; the TPU kernel sums in float32. Rows past B, samples past
// Np and columns past Cw / Cq read as zero and are not stored.
//
// Bound at the repository's full width (B=2048, Np=400,128, Cw=384,
// Cq=128): 2 x 2048 x 400,128 x (3 x 384 + 3 x 128) = 2.517e12 FP64
// tensor-core operations per block, 37.6 ms at the H100's 67 TFLOP/s,
// against 2.46 GB of compulsory traffic (0.73 ms at 3.35 TB/s): bound by
// operations. The design is the simple one that is right:
//
// - Tensor cores: mma.sync.m8n8k4 f64. A block owns a 64-row x 64-column
//   output tile of either the three Wp products or the three Wq products
//   (the first ceil(Cw/64) column tiles are Wp's) and loops over the whole
//   sample axis, no split-K and no atomics; each warp holds a 32 x 16
//   tile of its three products (48 float64 accumulators a thread).
// - Contraction order: the kernel may permute samples as long as both
//   operands agree. In the 4 k-steps of a 16-sample group, lane t takes
//   the samples 4t .. 4t+3 of the group, one per k-step, so its A values
//   of one row come from one 32-bit word of each plane.
// - Decode in registers: from the (k0, k1) word pair, __vcmpgtu4 gives the
//   missing mask; a Wp block makes k0, k1 and miss, a Wq block the three
//   bytes of d2. Bytes become float64 exactly as (2^52 + x) - 2^52 (one
//   integer move and one FP64 add, no conversion instruction).
// - The operands are staged in shared memory as f32 (half the bytes of
//   f64) and widened at fragment load; stages of 64 samples arrive by
//   16-byte cp.async copies (zero-filled past the edges), three stages in
//   flight. The operand's columns are XOR-swizzled by sample
//   (j ^ 8 * ((n >> 2) & 3)) and the plane rows padded to 80 bytes, so the
//   fragment loads of a warp fall in distinct banks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;         // variant rows per block tile
constexpr int BN = 64;         // operand columns per block tile
constexpr int KS = 64;         // samples per stage
constexpr int AST = KS + 16;   // padded plane row stride (bytes)
constexpr int NSTAGE = 3;      // stages in flight
constexpr int NTHREADS = 256;  // 8 warps: 2 (rows) x 4 (columns)

struct __align__(16) Stage {
  float w[KS][BN];       // operand: sample n, column j ^ swz(n)
  uint8_t k0[BM][AST];   // plane k0 of the block's rows
  uint8_t k1[BM][AST];   // plane k1
};
constexpr int SMEM_BYTES = NSTAGE * (int)sizeof(Stage);

__device__ __forceinline__ int swz(const int col, const int n) {
  return col ^ (((n >> 2) & 3) << 3);
}

__device__ __forceinline__ void cp16(void *smem, const void *gmem, bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_f64(double (&c)[2], const double a,
                                        const double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
      "{%0,%1}, {%2}, {%3}, {%0,%1};\n"
      : "+d"(c[0]), "+d"(c[1])
      : "d"(a), "d"(b));
}

// an unsigned integer below 2^32 as float64, exactly
__device__ __forceinline__ double u2d(const uint32_t x) {
  return __hiloint2double(0x43300000, (int)x) - 4503599627370496.0;
}

template <bool SQ>
__device__ __forceinline__ void tile(Stage *st, const uint8_t *__restrict__ planes,
                                     const float *__restrict__ W,
                                     double *__restrict__ O0,
                                     double *__restrict__ O1,
                                     double *__restrict__ O2, const int B,
                                     const int Np, const int Cw, const int j0) {
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const int r0 = blockIdx.y * BM;

  // one stage: KS x BN/4 operand vectors (4 a thread), 2 x BM x KS/16
  // plane vectors (2 a thread)
  auto load = [&](Stage &s, const int n0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + NTHREADS * i;
      const int n = idx / (BN / 4), v = idx % (BN / 4);
      const bool ok = (n0 + n < Np) && (j0 + 4 * v < Cw);
      const float *src = ok ? W + (long long)(n0 + n) * Cw + j0 + 4 * v : W;
      cp16(&s.w[n][swz(4 * v, n)], src, ok);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + NTHREADS * i;
      const int pl = idx / (BM * KS / 16), row = (idx / (KS / 16)) % BM;
      const int v = idx % (KS / 16);
      const bool ok = (r0 + row < B) && (n0 + 16 * v < Np);
      const uint8_t *src =
          ok ? planes + ((long long)(r0 + row) * 2 + pl) * Np + n0 + 16 * v
             : planes;
      cp16((pl ? s.k1[row] : s.k0[row]) + 16 * v, src, ok);
    }
  };

  double acc[3][4][2][2];
#pragma unroll
  for (int ty = 0; ty < 3; ++ty)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) acc[ty][i][j][0] = acc[ty][i][j][1] = 0.0;

  const int nk = (Np + KS - 1) / KS;
#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s) {
    if (s < nk) load(st[s], s * KS);
    cp_commit();
  }

  for (int k = 0; k < nk; ++k) {
    cp_wait<NSTAGE - 2>();
    __syncthreads();
    if (k + NSTAGE - 1 < nk) load(st[(k + NSTAGE - 1) % NSTAGE], (k + NSTAGE - 1) * KS);
    cp_commit();
    const Stage &s = st[k % NSTAGE];

#pragma unroll
    for (int q = 0; q < KS / 16; ++q) {
      // samples 16q + 4t .. 16q + 4t + 3 of this warp's rows g, g+8, ...:
      // k0 and k1 with the missing pairs zeroed, and the missing mask
      uint32_t a[4], b[4], m[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = wm * 32 + 8 * i + g;
        const uint32_t x = *reinterpret_cast<const uint32_t *>(&s.k0[row][16 * q + 4 * t]);
        const uint32_t y = *reinterpret_cast<const uint32_t *>(&s.k1[row][16 * q + 4 * t]);
        m[i] = __vcmpgtu4(y, ~x);  // 0xff where k1 > 255 - k0
        a[i] = x & ~m[i];
        b[i] = y & ~m[i];
      }
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        // k-step ks: lane t takes sample n = 16q + 4t + ks, so
        // (n >> 2) & 3 == t in the operand's swizzle
        const int n = 16 * q + 4 * t + ks;
        double bf[2];
#pragma unroll
        for (int j = 0; j < 2; ++j)
          bf[j] = (double)s.w[n][(wn * 16 + 8 * j + g) ^ (t << 3)];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint32_t k0 = (a[i] >> (8 * ks)) & 255u;
          const uint32_t k1 = (b[i] >> (8 * ks)) & 255u;
          double x[3];
          if (!SQ) {
            x[0] = u2d(k0);
            x[1] = u2d(k1);
            x[2] = __hiloint2double(((m[i] >> (8 * ks)) & 1u) ? 0x3FF00000 : 0, 0);
          } else {
            const uint32_t d = 2u * k0 + k1, d2 = d * d;
            x[0] = u2d(d2 & 255u);
            x[1] = u2d((d2 >> 8) & 255u);
            x[2] = u2d(d2 >> 16);
          }
#pragma unroll
          for (int ty = 0; ty < 3; ++ty)
#pragma unroll
            for (int j = 0; j < 2; ++j) mma_f64(acc[ty][i][j], x[ty], bf[j]);
        }
      }
    }
  }
  cp_wait<0>();

  double *const outs[3] = {O0, O1, O2};
#pragma unroll
  for (int ty = 0; ty < 3; ++ty)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int row = r0 + wm * 32 + 8 * i + g;
        const int col = j0 + wn * 16 + 8 * j + 2 * t;
        if (row < B && col < Cw)
          *reinterpret_cast<double2 *>(outs[ty] + (long long)row * Cw + col) =
              make_double2(acc[ty][i][j][0], acc[ty][i][j][1]);
      }
}

__global__ void __launch_bounds__(NTHREADS, 1)
bgen_f32_kernel(const uint8_t *__restrict__ planes, const float *__restrict__ Wp,
                const float *__restrict__ Wq, double *__restrict__ D0,
                double *__restrict__ D1, double *__restrict__ M,
                double *__restrict__ Q0, double *__restrict__ Q1,
                double *__restrict__ Q2, const int B, const int Np,
                const int Cw, const int Cq, const int ntp) {
  extern __shared__ __align__(16) unsigned char smem[];
  Stage *st = reinterpret_cast<Stage *>(smem);
  if ((int)blockIdx.x < ntp) {
    tile<false>(st, planes, Wp, D0, D1, M, B, Np, Cw, blockIdx.x * BN);
  } else {
    tile<true>(st, planes, Wq, Q0, Q1, Q2, B, Np, Cq, (blockIdx.x - ntp) * BN);
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). Launches on `stream`, does not
// synchronise and allocates nothing; returns cudaGetLastError() (or the
// error of the shared-memory attribute call). Requires Np > 0, Np % 16 == 0
// and Cw, Cq multiples of 4 (16-byte copies); the Python wrapper checks
// shapes, types, contiguity and alignment.
extern "C" int bgen_f32_launch(const void *planes, const void *Wp,
                               const void *Wq, void *D0, void *D1, void *M,
                               void *Q0, void *Q1, void *Q2, long long B,
                               long long Np, long long Cw, long long Cq,
                               void *stream) {
  cudaError_t err = cudaFuncSetAttribute(
      bgen_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const int ntp = (int)((Cw + BN - 1) / BN);
  const int ntq = (int)((Cq + BN - 1) / BN);
  const dim3 grid((unsigned)(ntp + ntq), (unsigned)((B + BM - 1) / BM));
  bgen_f32_kernel<<<grid, NTHREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      static_cast<const uint8_t *>(planes), static_cast<const float *>(Wp),
      static_cast<const float *>(Wq), static_cast<double *>(D0),
      static_cast<double *>(D1), static_cast<double *>(M),
      static_cast<double *>(Q0), static_cast<double *>(Q1),
      static_cast<double *>(Q2), (int)B, (int)Np, (int)Cw, (int)Cq, ntp);
  return (int)cudaGetLastError();
}
