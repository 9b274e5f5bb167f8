// BGEN 8-bit dosage products for Hopper (sm_90a) against the bf16
// hi|mid|lo split operands: the two per-sample probability byte planes of
// a variant block times the bf16 sample-ordered operands, on the bf16
// tensor cores, float32 partial sums added into float64.
//
// Replaces the Pallas TPU kernel regenie_tpu/ops/fused_score.py:1054
// (_bgen_kernel_split with its bf16 operand, launched by
// bgen_fused_products at :1256), which the JAX package reaches through
// sample_pack(split=True).
//
// What it computes, for planes [B, 2, Np] uint8 (k0 = P(hom first) * 255,
// k1 = P(het) * 255, missing = any pair with k0 + k1 > 255), the operand
// Wp [Np, Cw] bf16 and the narrow operand Wq [Np, Cq] bf16 (each 3 x the
// padded width: [hi | mid | lo] thirds):
//   miss = k0 + k1 > 255;  k0, k1 = 0 where miss;  d2 = (2 k0 + k1)^2
//   D0 = k0 @ Wp,  D1 = k1 @ Wp,  M = miss @ Wp                 [B, Cw]
//   Q0 = (d2 & 255) @ Wq,  Q1 = (d2 >> 8 & 255) @ Wq,  Q2 = (d2 >> 16) @ Wq
//                                                               [B, Cq]
// as float64, against each third separately (the caller folds them).
// Rows past B, samples past Np and columns past Cw / Cq read as zero and
// are not stored.
//
// Precision: every multiplicand (k0, k1, the d2 bytes: 0..255, miss: 0/1)
// is exact in bf16, so a product with a bf16 value (16 significant bits)
// is exact in float32. The TPU kernel carries float32 sums over all Np
// samples. The tensor cores' float32 accumulation does not round to
// nearest: sums carried in the mma accumulators over 1024 samples moved
// the first block's LOG10P by 1.7e-5 on a near-constant covariate column.
// So the mma sums run from zero over one stage (64 samples: a byte times
// one bf16 value summed 64 times stays below 2^22 units, exact), the
// stage sums are added in float32 with round-to-nearest adds, and every
// FLUSH = 4096 samples that float32 sum is added into a float64 sum the
// thread owns in shared memory: one float32 sum rounds by at most about
// FLUSH x 2^-23 of its terms' magnitudes. The mask and ind columns are
// 0/1: their partial sums are integers below 255 x 4096 < 2^24, exact, so
// the products behind INFO and A1FREQ are exact.
//
// Bound at the repository's full width (B=2048, Np=400,128, Cw=1152,
// Cq=384): 2 x 2048 x 400,128 x (3 x 1152 + 3 x 384) = 7.552e12 bf16
// tensor-core operations per block, 7.64 ms at the H100's 989 dense
// TFLOP/s, against 2.94 GB of compulsory traffic (0.88 ms at 3.35 TB/s):
// bound by operations. The design is the simple one that is right:
//
// - Tensor cores: mma.sync.m16n8k16 bf16 -> f32. A 256-thread block owns
//   a 64-row x 64-column output tile of either the three Wp products or
//   the three Wq products (the first ceil(Cw/64) column tiles are Wp's)
//   and loops over the whole sample axis, no split-K and no atomics; each
//   warp holds a 16 x 32 tile of its three products (48 mma and 48
//   float32 accumulators a thread, 48 float64 sums in shared memory).
// - Decode in registers: lane (g, t) loads the 16-bit sample pairs
//   (2t, 2t+1) and (2t+8, 2t+9) of k0 and k1 for its rows g and g+8;
//   __vcmpgtu4 gives the missing mask. A byte becomes a float32 as
//   (2^23 + x) - 2^23 (one byte permute and one add), whose top half is
//   its bf16 value: 256 + x has too many bits for bf16's 8, so the
//   magic-number step runs in float32. Two halves pack into one register
//   with one more byte permute; the 0/1 mask is built as 0x3F80 directly.
// - The operand keeps the JAX layout [n][j] (j contiguous): stages of 64
//   samples x 64 columns arrive by 16-byte cp.async copies (zero-filled
//   past the edges), three in flight, each 16-byte chunk of a row
//   XOR-swizzled by the row, and ldmatrix.trans turns them into B
//   fragments free of bank conflicts; plane rows are padded to 80 bytes.
// wgmma, TMA and warp specialisation are left for a later redesign.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;         // variant rows per block tile
constexpr int BN = 64;         // operand columns per block tile
constexpr int KS = 64;         // samples per stage
constexpr int AST = KS + 16;   // padded plane row stride (bytes)
constexpr int NSTAGE = 3;      // stages in flight
constexpr int NTHREADS = 256;  // 8 warps: 4 (rows) x 2 (columns)
constexpr int FLUSH = 4096;    // samples per float32 partial sum
constexpr int FLUSH_STAGES = FLUSH / KS;

struct __align__(16) Stage {
  uint16_t w[KS][BN];    // operand: sample n, column chunk (j/8) ^ (n & 7)
  uint8_t k0[BM][AST];   // plane k0 of the block's rows
  uint8_t k1[BM][AST];   // plane k1
};
// the stages, then 48 float64 sums a thread
constexpr int SMEM_BYTES = NSTAGE * (int)sizeof(Stage) + 48 * NTHREADS * 8;

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

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void *smem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t b0, const uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// byte I of v as a float32, exactly: (2^23 + x) - 2^23
template <int I>
__device__ __forceinline__ float bytef(const uint32_t v) {
  return __uint_as_float(__byte_perm(v, 0x4B000000u, 0x7650 + I)) - 8388608.f;
}

// two float32 values with zero low halves -> their bf16 pair (lo, hi)
__device__ __forceinline__ uint32_t pack2(const float lo, const float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// One (k0, k1) pair of 16-bit sample pairs -> the three A registers of a
// block kind: k0, k1 and missing (Wp tiles), or the bytes 0, 1, 2 of d2
// (Wq tiles). A missing pair reads as k0 = k1 = 0.
template <bool SQ>
__device__ __forceinline__ void decode(const uint32_t a, const uint32_t b,
                                       uint32_t &x0, uint32_t &x1,
                                       uint32_t &x2) {
  const uint32_t m = __vcmpgtu4(b, ~a);  // 0xff where k1 > 255 - k0
  const uint32_t k0 = a & ~m, k1 = b & ~m;
  if (!SQ) {
    x0 = pack2(bytef<0>(k0), bytef<1>(k0));
    x1 = pack2(bytef<0>(k1), bytef<1>(k1));
    uint32_t y = m & 0x0101u;
    y = (y | (y << 8)) & 0x00010001u;
    x2 = y * 0x3F80u;  // bf16 1.0 where missing
  } else {
    const uint32_t dl = 2u * (k0 & 255u) + (k1 & 255u);
    const uint32_t dh = 2u * (k0 >> 8) + (k1 >> 8);
    const uint32_t el = dl * dl, eh = dh * dh;
    x0 = pack2(bytef<0>(el), bytef<0>(eh));
    x1 = pack2(bytef<1>(el), bytef<1>(eh));
    x2 = pack2(bytef<2>(el), bytef<2>(eh));
  }
}

template <bool SQ>
__device__ __forceinline__ void tile(Stage *st, const uint8_t *__restrict__ planes,
                                     const uint16_t *__restrict__ W,
                                     double *__restrict__ O0,
                                     double *__restrict__ O1,
                                     double *__restrict__ O2, const int B,
                                     const int Np, const int Cw, const int j0) {
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;
  const int r0 = blockIdx.y * BM;

  // one stage: KS x BN/8 operand chunks (2 a thread), 2 x BM x KS/16
  // plane chunks (2 a thread)
  auto load = [&](Stage &s, const int n0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + NTHREADS * i;
      const int n = idx >> 3, v = idx & 7;
      const bool ok = (n0 + n < Np) && (j0 + 8 * v < Cw);
      const uint16_t *src = ok ? W + (long long)(n0 + n) * Cw + j0 + 8 * v : W;
      cp16(&s.w[n][8 * (v ^ (n & 7))], src, ok);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + NTHREADS * i;
      const int pl = idx >> 8, row = (idx >> 2) & (BM - 1), v = idx & 3;
      const bool ok = (r0 + row < B) && (n0 + 16 * v < Np);
      const uint8_t *src =
          ok ? planes + ((long long)(r0 + row) * 2 + pl) * Np + n0 + 16 * v
             : planes;
      cp16((pl ? s.k1[row] : s.k0[row]) + 16 * v, src, ok);
    }
  };

  // acc: the mma sums of one stage, from zero; part: their float32 sum
  // (round-to-nearest adds) since the last flush; sum: the float64 sums of
  // the flushed parts, in shared memory past the stages (element e of
  // thread tid at e * NTHREADS + tid, so a warp's accesses are contiguous)
  double *const sum = reinterpret_cast<double *>(st + NSTAGE);
  float acc[3][4][4], part[3][4][4];
#pragma unroll
  for (int ty = 0; ty < 3; ++ty)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        part[ty][nt][r] = 0.f;
        sum[((ty * 4 + nt) * 4 + r) * NTHREADS + tid] = 0.0;
      }

  const int nk = (Np + KS - 1) / KS;
#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s) {
    if (s < nk) load(st[s], s * KS);
    cp_commit();
  }

  // ldmatrix row of this lane: matrix mi = lane / 8 covers sample rows
  // 8 * (mi & 1) .. +7 and column chunk (mi >> 1) of a 16-column pair
  const int lm_k = 8 * ((lane >> 3) & 1) + (lane & 7);
  const int lm_chunk = wn * 4 + (lane >> 4);
  const int arow = wm * 16 + g;

  for (int k = 0; k < nk; ++k) {
    cp_wait<NSTAGE - 2>();
    __syncthreads();
    if (k + NSTAGE - 1 < nk) load(st[(k + NSTAGE - 1) % NSTAGE], (k + NSTAGE - 1) * KS);
    cp_commit();
    const Stage &s = st[k % NSTAGE];
#pragma unroll
    for (int ty = 0; ty < 3; ++ty)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[ty][nt][r] = 0.f;

#pragma unroll
    for (int ks = 0; ks < KS / 16; ++ks) {
      const int nb = 16 * ks;
      uint32_t bf[2][4];
      const int kr = nb + lm_k;
#pragma unroll
      for (int pr = 0; pr < 2; ++pr)
        ldsm_x4_t(bf[pr], &s.w[kr][8 * ((lm_chunk + 2 * pr) ^ (kr & 7))]);
      // A registers 0..3: samples (2t, 2t+1) of rows g, g+8, then
      // (2t+8, 2t+9) of rows g, g+8
      uint32_t a[3][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = arow + 8 * (i & 1);
        const int n = nb + 2 * t + 8 * (i >> 1);
        decode<SQ>(*reinterpret_cast<const uint16_t *>(&s.k0[row][n]),
                   *reinterpret_cast<const uint16_t *>(&s.k1[row][n]),
                   a[0][i], a[1][i], a[2][i]);
      }
#pragma unroll
      for (int ty = 0; ty < 3; ++ty)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_bf16(acc[ty][nt], a[ty], bf[nt >> 1][2 * (nt & 1)],
                   bf[nt >> 1][2 * (nt & 1) + 1]);
    }

#pragma unroll
    for (int ty = 0; ty < 3; ++ty)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) part[ty][nt][r] += acc[ty][nt][r];
    if ((k + 1) % FLUSH_STAGES == 0 || k + 1 == nk) {
#pragma unroll
      for (int ty = 0; ty < 3; ++ty)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            sum[((ty * 4 + nt) * 4 + r) * NTHREADS + tid] += (double)part[ty][nt][r];
            part[ty][nt][r] = 0.f;
          }
    }
  }
  cp_wait<0>();

  double *const outs[3] = {O0, O1, O2};
  const int row = r0 + arow;
#pragma unroll
  for (int ty = 0; ty < 3; ++ty)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = j0 + wn * 32 + nt * 8 + 2 * t;
      if (col >= Cw) continue;
      const double *e = sum + (ty * 4 + nt) * 4 * NTHREADS + tid;
      if (row < B)
        *reinterpret_cast<double2 *>(outs[ty] + (long long)row * Cw + col) =
            make_double2(e[0], e[NTHREADS]);
      if (row + 8 < B)
        *reinterpret_cast<double2 *>(outs[ty] + (long long)(row + 8) * Cw + col) =
            make_double2(e[2 * NTHREADS], e[3 * NTHREADS]);
    }
}

__global__ void __launch_bounds__(NTHREADS, 1)
bgen_bf16_kernel(const uint8_t *__restrict__ planes,
                 const uint16_t *__restrict__ Wp, const uint16_t *__restrict__ Wq,
                 double *__restrict__ D0, double *__restrict__ D1,
                 double *__restrict__ M, double *__restrict__ Q0,
                 double *__restrict__ Q1, double *__restrict__ Q2,
                 const int B, const int Np, const int Cw, const int Cq,
                 const int ntp) {
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
// and Cw, Cq multiples of 8 (16-byte copies); the Python wrapper checks
// shapes, types, contiguity and alignment.
extern "C" int bgen_bf16_launch(const void *planes, const void *Wp,
                                const void *Wq, void *D0, void *D1, void *M,
                                void *Q0, void *Q1, void *Q2, long long B,
                                long long Np, long long Cw, long long Cq,
                                void *stream) {
  cudaError_t err = cudaFuncSetAttribute(
      bgen_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const int ntp = (int)((Cw + BN - 1) / BN);
  const int ntq = (int)((Cq + BN - 1) / BN);
  const dim3 grid((unsigned)(ntp + ntq), (unsigned)((B + BM - 1) / BM));
  bgen_bf16_kernel<<<grid, NTHREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      static_cast<const uint8_t *>(planes), static_cast<const uint16_t *>(Wp),
      static_cast<const uint16_t *>(Wq), static_cast<double *>(D0),
      static_cast<double *>(D1), static_cast<double *>(M),
      static_cast<double *>(Q0), static_cast<double *>(Q1),
      static_cast<double *>(Q2), (int)B, (int)Np, (int)Cw, (int)Cq, ntp);
  return (int)cudaGetLastError();
}
