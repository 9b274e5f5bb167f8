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
// operations. The design aims at that rate:
//
// - Tensor cores: mma.sync.aligned.m16n8k16 f64 (SASS DMMA.16x8x16, from
//   cuobjdump -sass). On the H100 the m8n8k4 shape (DMMA.8x8x4) runs at
//   half the FP64 tensor rate, 33.5 of 67 TFLOP/s; m16n8k16 reaches 66-67
//   (chains of independent mma, NVIDIA H100 80GB HBM3, 700 W).
// - Work split and waves: a 256-thread block owns a 64-row x 64-column
//   output tile of either the three Wp products or the three Wq products
//   (the first ceil(Cw/64) column tiles are Wp's) and loops over the whole
//   sample axis, no split-K and no atomics; its 8 warps (4 rows x 2
//   columns) each hold a 16 x 32 tile of the three products (1 x 4 m16n8
//   tiles, 48 float64 accumulators a thread), so each row's bytes are
//   decoded by 2 warps and feed 4 column tiles. At the main shape (B=2048,
//   Cw=384, Cq=128) that is 8 x 32 = 256 blocks, one block per SM, 1.94
//   waves on 132 SMs (the second wave 94% full). Wp and Wq blocks do the
//   same mma work.
// - Contraction order: the kernel may permute samples as long as both
//   operands agree. In one m16n8k16 step of a 16-sample group, lane (g, t)
//   holds A(row g + 8r, k t + 4j) = the multiplicand of sample 4t + j of
//   the group (a[2j + r]) and B(k t + 4j, column g) = W[sample 4t + j]
//   (b[j]), so its A values of one row come from one 32-bit word of each
//   plane.
// - Decode in registers: from the (k0, k1) word pair, __vcmpgtu4 gives the
//   missing mask; a Wp block makes k0, k1 and miss, a Wq block the three
//   bytes of d2. A byte becomes a float64 by one I2F.F64.U32; the miss
//   indicator is the high word of 1.0 or 0.0. An FP64 add per byte,
//   (2^52 + v) - 2^52, costs chains of m16n8k16 19-28% at these ratios
//   (1/3 and 1/2 of one per 256 FMA); building the doubles from the
//   float32 (2^23 + v) - 2^23 with integer operations keeps them off the
//   FP64 pipe but spends 5 instructions a byte and ran 3% slower than
//   I2F here.
// - The operands are staged in shared memory as f32 (half the bytes of
//   f64) and widened at fragment load (F2F.F64.F32, 16 per 12 mma a warp;
//   replacing it by a plain move changed nothing measurable); stages of
//   128 samples arrive by 16-byte cp.async copies (zero-filled past the
//   edges), three stages in flight. The operand's columns are
//   XOR-swizzled by sample (j ^ 8 * ((n >> 2) & 3)) and the plane rows
//   padded to 144 bytes, so the fragment loads of a warp fall in distinct
//   banks.
// - Registers: ptxas reports 220 a thread, 0 bytes of spill (launch bound
//   256 threads, 1 block per SM); 153,600 bytes of shared memory.
// - What bounds it: the DMMA rate. Measured at full width on the H100:
//   44.9-45.4 ms, 83-84% of the bound, at 1980 MHz and 510-600 W (no
//   clock or power limit reached); 3% lost to the second wave's tail;
//   the byte decode costs 3.8% (a one-operation stand-in ran 43.2 ms);
//   the rest is the loop's loads, barriers and NOPs, 11.5-13.1
//   instructions a DMMA in all.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;         // variant rows per block tile
constexpr int BN = 64;         // operand columns per block tile
constexpr int KS = 128;        // samples per stage
constexpr int AST = KS + 16;   // padded plane row stride (bytes)
constexpr int NSTAGE = 3;      // stages in flight
constexpr int WM = 16, WN = 32;  // warp tile
constexpr int WARPS_N = BN / WN;  // warps along the columns
constexpr int NTHREADS = 32 * (BM / WM) * WARPS_N;  // 8 warps: 4 (rows) x 2
constexpr int MT = WM / 16, NT = WN / 8;

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

__device__ __forceinline__ void mma_f64(double (&c)[4], const double (&a)[8],
                                        const double (&b)[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7,%8,%9,%10,%11}, {%12,%13,%14,%15}, "
      "{%0,%1,%2,%3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]),
        "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

// byte j of x as float64 (I2F.F64.U32)
__device__ __forceinline__ double byte2d(const uint32_t x, const int j) {
  return (double)__byte_perm(x, 0, 0x4440 + j);
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
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int r0 = blockIdx.y * BM;

  // one stage: KS x BN/4 operand vectors, 2 x BM x KS/16 plane vectors
  auto load = [&](Stage &s, const int n0) {
#pragma unroll
    for (int i = 0; i < KS * BN / 4 / NTHREADS; ++i) {
      const int idx = tid + NTHREADS * i;
      const int n = idx / (BN / 4), v = idx % (BN / 4);
      const bool ok = (n0 + n < Np) && (j0 + 4 * v < Cw);
      const float *src = ok ? W + (long long)(n0 + n) * Cw + j0 + 4 * v : W;
      cp16(&s.w[n][swz(4 * v, n)], src, ok);
    }
#pragma unroll
    for (int i = 0; i < 2 * BM * KS / 16 / NTHREADS; ++i) {
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

  double acc[3][MT][NT][4];
#pragma unroll
  for (int ty = 0; ty < 3; ++ty)
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[ty][i][j][e] = 0.0;

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
      // B fragments: samples n = 16q + 4t + j, for which (n >> 2) & 3 == t
      // in the operand's swizzle
      double bf[NT][4];
#pragma unroll
      for (int jt = 0; jt < NT; ++jt)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          bf[jt][j] = (double)s.w[16 * q + 4 * t + j][(wn * WN + 8 * jt + g) ^ (t << 3)];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        // samples 16q + 4t .. 16q + 4t + 3 of rows g and g+8 of row tile
        // i: the three multiplicands of each, as float64
        double x[3][8];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = wm * WM + 16 * i + 8 * r + g;
          const uint32_t u = *reinterpret_cast<const uint32_t *>(&s.k0[row][16 * q + 4 * t]);
          const uint32_t v = *reinterpret_cast<const uint32_t *>(&s.k1[row][16 * q + 4 * t]);
          const uint32_t m = __vcmpgtu4(v, ~u);  // 0xff where k1 > 255 - k0
          const uint32_t a = u & ~m, b = v & ~m;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (!SQ) {
              x[0][2 * j + r] = byte2d(a, j);
              x[1][2 * j + r] = byte2d(b, j);
              x[2][2 * j + r] = __hiloint2double(
                  (int)(__byte_perm(m, 0, 0x1111 * j) & 0x3FF00000u), 0);
            } else {
              const uint32_t d = 2u * __byte_perm(a, 0, 0x4440 + j) +
                                 __byte_perm(b, 0, 0x4440 + j);
              const uint32_t d2 = d * d;
              x[0][2 * j + r] = (double)(d2 & 255u);
              x[1][2 * j + r] = byte2d(d2, 1);
              x[2][2 * j + r] = byte2d(d2, 2);
            }
          }
        }
#pragma unroll
        for (int ty = 0; ty < 3; ++ty)
#pragma unroll
          for (int jt = 0; jt < NT; ++jt) mma_f64(acc[ty][i][jt], x[ty], bf[jt]);
      }
    }
  }
  cp_wait<0>();

  double *const outs[3] = {O0, O1, O2};
#pragma unroll
  for (int ty = 0; ty < 3; ++ty)
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int jt = 0; jt < NT; ++jt)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = r0 + wm * WM + 16 * i + 8 * r + g;
          const int col = j0 + wn * WN + 8 * jt + 2 * t;
          if (row < B && col < Cw)
            *reinterpret_cast<double2 *>(outs[ty] + (long long)row * Cw + col) =
                make_double2(acc[ty][i][jt][2 * r], acc[ty][i][jt][2 * r + 1]);
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

// the grid: ceil(Cw/BN) Wp column tiles, then ceil(Cq/BN) Wq column tiles,
// by ceil(B/BM) row tiles; *ntp gets the Wp column tiles
dim3 grid_of(const long long B, const long long Cw, const long long Cq, int *ntp) {
  *ntp = (int)((Cw + BN - 1) / BN);
  const int ntq = (int)((Cq + BN - 1) / BN);
  return dim3((unsigned)(*ntp + ntq), (unsigned)((B + BM - 1) / BM));
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
  int ntp;
  const dim3 grid = grid_of(B, Cw, Cq, &ntp);
  bgen_f32_kernel<<<grid, NTHREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      static_cast<const uint8_t *>(planes), static_cast<const float *>(Wp),
      static_cast<const float *>(Wq), static_cast<double *>(D0),
      static_cast<double *>(D1), static_cast<double *>(M),
      static_cast<double *>(Q0), static_cast<double *>(Q1),
      static_cast<double *>(Q2), (int)B, (int)Np, (int)Cw, (int)Cq, ntp);
  return (int)cudaGetLastError();
}

// The launch's shape for B rows, Cw and Cq columns, as the CUDA runtime
// reports it: info = {blocks, blocks per SM, registers a thread,
// threads a block, dynamic shared memory bytes}. Returns a CUDA error code.
extern "C" int bgen_f32_info(long long B, long long Cw, long long Cq, int *info) {
  cudaError_t err = cudaFuncSetAttribute(
      bgen_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes at;
  err = cudaFuncGetAttributes(&at, bgen_f32_kernel);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bgen_f32_kernel,
                                                      NTHREADS, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  int ntp;
  const dim3 grid = grid_of(B, Cw, Cq, &ntp);
  info[0] = (int)(grid.x * grid.y);
  info[1] = per_sm;
  info[2] = at.numRegs;
  info[3] = NTHREADS;
  info[4] = SMEM_BYTES;
  return 0;
}
