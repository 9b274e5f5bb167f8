// BGEN 8-bit dosage products for Hopper (sm_90a): the two per-sample
// probability byte planes of a variant block against the int8 limb
// operands, exact integer sums.
//
// Replaces the Pallas TPU kernel regenie_tpu/ops/fused_score.py:1093
// (_bgen_kernel_i8, launched by _bgen_products_i8 at :1171).
//
// What it computes, for planes [B, 2, Np] uint8 (k0 = P(hom first) * 255,
// k1 = P(het) * 255, missing = any pair with k0 + k1 > 255), the operand
// limbs Wp [Np, Cw] int8 and the narrow operand limbs Wq [Np, Cq] int8:
//   miss = k0 + k1 > 255;  k0, k1 = 0 where miss;  d2 = (2 k0 + k1)^2
//   D0 = k0 @ Wp,  D1 = k1 @ Wp,  M = miss @ Wp                 [B, Cw]
//   Q0 = (d2 & 255) @ Wq,  Q1 = (d2 >> 8 & 255) @ Wq,  Q2 = (d2 >> 16) @ Wq
//                                                               [B, Cq]
// all as exact int64. Rows past B, samples past Np and columns past
// Cw / Cq read as zero and are not stored.
//
// Bound at the repository's full width (B=2048, Np=400,128, Cw=1536,
// Cq=512): (3 x 1536 + 3 x 512) x 2 x 2048 x 400,128 = 1.007e13 int8
// operations per block, 5.09 ms at the H100's 1,979 dense int8 TOP/s,
// against 2.56 GB of compulsory traffic (planes 1.64 GB, 0.77 ms at
// 3.35 TB/s): bound by tensor-core operations. The design:
//
// - Tensor cores: mma.sync.m16n8k32 u8 x s8 -> s32 takes the unsigned
//   bytes as they are. (The TPU kernel shifts them by -128 into s8 and
//   adds 128 x column sums back.) Each warp holds a 32 x 32 tile of the
//   three products of its block (96 int32 accumulators per thread).
// - Exactness: |u8 x s8| <= 255 x 128, so an int32 sum is exact over at
//   most 65,536 samples. The contraction runs in chunks of 65,536; after
//   each chunk a thread adds its int32 partial sums into the int64
//   outputs it alone owns (a store for the first chunk), so there are no
//   atomics and the result does not depend on any order.
// - Work split: a 256-thread block owns a 64-row x 128-column output tile
//   of either the three Wp products or the three Wq products (the first
//   ceil(Cw/128) column tiles are Wp's), and loops over the whole sample
//   axis; the TPU kernel's sequential grid axis over sample tiles becomes
//   this in-block loop.
// - Decode in registers: each thread loads one (k0, k1) word pair per
//   A fragment register (4 samples) and makes every A fragment from it
//   (k0, k1 and the missing mask for Wp tiles; the three d2 bytes for Wq
//   tiles); no indicator tile goes through memory.
// - Contraction order: the kernel may permute samples as long as both
//   operands agree. In each 32-sample mma step, thread-column t takes the
//   sample words 8t + 2s and 8t + 2s + 1 of the 128-sample stage, so its
//   A words of one row are one 8-byte shared-memory load.
// - The operand is stored [n][j] (j contiguous), but a B fragment wants 4
//   consecutive samples per register: each stage is loaded with 16-byte
//   vectors of 4 rows, transposed in registers with byte permutes and
//   stored as words [n/4][j], XOR-swizzled on j so that the fragment
//   loads are free of bank conflicts; the plane rows are padded by 8
//   bytes for the same reason.
// - Two shared-memory stages with register staging: the global loads of
//   stage k+1 are in flight while stage k is multiplied; one barrier per
//   stage of 128 samples.
// wgmma, TMA and warp specialisation are left for a later redesign.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;         // variant rows per block tile
constexpr int BN = 128;        // operand columns per block tile
constexpr int KS = 128;        // samples per shared-memory stage
constexpr int AST = KS + 8;    // padded row stride (bytes) of a plane tile
constexpr int NTHREADS = 256;  // 8 warps: 2 (rows) x 4 (columns)
constexpr long long CHUNK = 65536;  // samples per exact int32 partial sum
constexpr long long STAGES_PER_CHUNK = CHUNK / KS;

struct __align__(16) Stage {
  uint32_t w[KS / 4][BN];  // operand: sample word q, column j^swz
  uint8_t k0[BM][AST];     // plane k0 of the block's rows
  uint8_t k1[BM][AST];     // plane k1
};
constexpr int SMEM_BYTES = 2 * (int)sizeof(Stage);

__device__ __forceinline__ int swz(int col, int q) {
  return col ^ (((q >> 3) & 3) << 3);
}

// Four rows of 16 operand bytes -> 16 words, word j holding column j of
// the four rows in bytes 0..3 (o.x: columns 0-3 ... o.w: 12-15 of each
// input word, column i of input word x in o.<i>).
__device__ __forceinline__ void transpose4(const uint32_t a, const uint32_t b,
                                           const uint32_t c, const uint32_t d,
                                           uint4 &o) {
  const uint32_t t0 = __byte_perm(a, b, 0x5140);
  const uint32_t t1 = __byte_perm(c, d, 0x5140);
  const uint32_t t2 = __byte_perm(a, b, 0x7362);
  const uint32_t t3 = __byte_perm(c, d, 0x7362);
  o.x = __byte_perm(t0, t1, 0x5410);
  o.y = __byte_perm(t0, t1, 0x7632);
  o.z = __byte_perm(t2, t3, 0x5410);
  o.w = __byte_perm(t2, t3, 0x7632);
}

// One (k0, k1) word pair (4 samples) -> the three A fragment words of a
// block kind: k0, k1 and missing (Wp tiles), or the bytes 0, 1, 2 of d2
// (Wq tiles). A missing pair reads as k0 = k1 = 0.
template <bool SQ>
__device__ __forceinline__ void decode(const uint32_t a, const uint32_t b,
                                       uint32_t &x0, uint32_t &x1,
                                       uint32_t &x2) {
  const uint32_t m = __vcmpgtu4(b, ~a);  // 0xff where k1 > 255 - k0
  const uint32_t k0 = a & ~m, k1 = b & ~m;
  if (!SQ) {
    x0 = k0;
    x1 = k1;
    x2 = m & 0x01010101u;
  } else {
    uint32_t d2[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t d = 2u * ((k0 >> (8 * i)) & 255u) + ((k1 >> (8 * i)) & 255u);
      d2[i] = d * d;
    }
    uint4 o;
    transpose4(d2[0], d2[1], d2[2], d2[3], o);
    x0 = o.x;
    x1 = o.y;
    x2 = o.z;
  }
}

__device__ __forceinline__ void mma_u8s8(int (&c)[4], const uint32_t a0,
                                         const uint32_t a1, const uint32_t a2,
                                         const uint32_t a3, const uint32_t b0,
                                         const uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

template <bool SQ>
__device__ __forceinline__ void tile(Stage *st, const uint8_t *__restrict__ planes,
                                     const int8_t *__restrict__ W,
                                     long long *__restrict__ O0,
                                     long long *__restrict__ O1,
                                     long long *__restrict__ O2, const int B,
                                     const long long Np, const int Cw,
                                     const int j0) {
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const int r0 = blockIdx.y * BM;

  // loader coordinates: operand sample word / 16-column vector, and plane
  // row / 32-sample segment
  const int lq = tid >> 3, ljv = tid & 7;
  const int lrow = tid >> 2, lseg = tid & 3;
  const int lj = j0 + ljv * 16;
  const bool lj_ok = lj < Cw;
  const bool lrow_ok = r0 + lrow < B;
  const uint8_t *const prow = planes + (long long)(r0 + lrow) * 2 * Np;

  uint4 vw[4];
  uint4 vp[4];  // k0 samples [0, 16), [16, 32) of the segment, then k1

  auto gload = [&](const long long n0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long n = n0 + 4 * lq + i;
      if (lj_ok && n < Np) {
        vw[i] = __ldg(reinterpret_cast<const uint4 *>(W + n * Cw + lj));
      } else {
        vw[i] = make_uint4(0, 0, 0, 0);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long n = n0 + 32 * lseg + 16 * (i & 1);
      if (lrow_ok && n < Np) {
        vp[i] = __ldg(reinterpret_cast<const uint4 *>(prow + (i >> 1) * Np + n));
      } else {
        vp[i] = make_uint4(0, 0, 0, 0);
      }
    }
  };

  auto sstore = [&](Stage &s) {
    uint4 o;
    transpose4(vw[0].x, vw[1].x, vw[2].x, vw[3].x, o);
    *reinterpret_cast<uint4 *>(&s.w[lq][swz(ljv * 16 + 0, lq)]) = o;
    transpose4(vw[0].y, vw[1].y, vw[2].y, vw[3].y, o);
    *reinterpret_cast<uint4 *>(&s.w[lq][swz(ljv * 16 + 4, lq)]) = o;
    transpose4(vw[0].z, vw[1].z, vw[2].z, vw[3].z, o);
    *reinterpret_cast<uint4 *>(&s.w[lq][swz(ljv * 16 + 8, lq)]) = o;
    transpose4(vw[0].w, vw[1].w, vw[2].w, vw[3].w, o);
    *reinterpret_cast<uint4 *>(&s.w[lq][swz(ljv * 16 + 12, lq)]) = o;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint8_t *dst = (i >> 1 ? s.k1[lrow] : s.k0[lrow]) + 32 * lseg + 16 * (i & 1);
      reinterpret_cast<uint2 *>(dst)[0] = make_uint2(vp[i].x, vp[i].y);
      reinterpret_cast<uint2 *>(dst)[1] = make_uint2(vp[i].z, vp[i].w);
    }
  };

  int acc[3][2][4][4];
  auto zero_acc = [&]() {
#pragma unroll
    for (int ty = 0; ty < 3; ++ty)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[ty][mt][nt][r] = 0;
  };

  // add this chunk's int32 partial sums into the int64 outputs (each
  // output element belongs to one thread of one block)
  auto flush = [&](const bool first) {
    long long *const outs[3] = {O0, O1, O2};
#pragma unroll
    for (int ty = 0; ty < 3; ++ty) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int col = j0 + wn * 32 + nt * 8 + 2 * t;
          if (col >= Cw) continue;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = r0 + wm * 32 + mt * 16 + g + 8 * h;
            if (row >= B) continue;
            longlong2 *p = reinterpret_cast<longlong2 *>(
                outs[ty] + (long long)row * Cw + col);
            longlong2 v = make_longlong2(acc[ty][mt][nt][2 * h],
                                         acc[ty][mt][nt][2 * h + 1]);
            if (!first) {
              const longlong2 old = *p;
              v.x += old.x;
              v.y += old.y;
            }
            *p = v;
          }
        }
      }
    }
  };

  zero_acc();
  const long long nk = (Np + KS - 1) / KS;
  gload(0);
  sstore(st[0]);
  __syncthreads();

  for (long long k = 0; k < nk; ++k) {
    Stage &s = st[k & 1];
    if (k + 1 < nk) gload((k + 1) * KS);

#pragma unroll
    for (int step = 0; step < 4; ++step) {
      // sample words q0 = 8t + 2 step (A/B registers 0, 1) and q0 + 1
      // (registers 2, 3 of A, 1 of B)
      const int q0 = 8 * t + 2 * step;
      uint32_t bf[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = wn * 32 + nt * 8 + g;
        bf[nt][0] = s.w[q0][swz(col, q0)];
        bf[nt][1] = s.w[q0 + 1][swz(col, q0 + 1)];
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int row = wm * 32 + mt * 16 + g;
        const uint2 a_lo = *reinterpret_cast<const uint2 *>(&s.k0[row][4 * q0]);
        const uint2 a_hi = *reinterpret_cast<const uint2 *>(&s.k0[row + 8][4 * q0]);
        const uint2 b_lo = *reinterpret_cast<const uint2 *>(&s.k1[row][4 * q0]);
        const uint2 b_hi = *reinterpret_cast<const uint2 *>(&s.k1[row + 8][4 * q0]);
        uint32_t a[3][4];
        decode<SQ>(a_lo.x, b_lo.x, a[0][0], a[1][0], a[2][0]);
        decode<SQ>(a_hi.x, b_hi.x, a[0][1], a[1][1], a[2][1]);
        decode<SQ>(a_lo.y, b_lo.y, a[0][2], a[1][2], a[2][2]);
        decode<SQ>(a_hi.y, b_hi.y, a[0][3], a[1][3], a[2][3]);
#pragma unroll
        for (int ty = 0; ty < 3; ++ty)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            mma_u8s8(acc[ty][mt][nt], a[ty][0], a[ty][1], a[ty][2], a[ty][3],
                     bf[nt][0], bf[nt][1]);
      }
    }

    if ((k + 1) % STAGES_PER_CHUNK == 0 || k + 1 == nk) {
      flush(k < STAGES_PER_CHUNK);
      zero_acc();
    }
    if (k + 1 < nk) sstore(st[(k + 1) & 1]);
    __syncthreads();
  }
}

__global__ void __launch_bounds__(NTHREADS, 1)
bgen_i8_kernel(const uint8_t *__restrict__ planes,
               const int8_t *__restrict__ Wp, const int8_t *__restrict__ Wq,
               long long *__restrict__ D0, long long *__restrict__ D1,
               long long *__restrict__ M, long long *__restrict__ Q0,
               long long *__restrict__ Q1, long long *__restrict__ Q2,
               const int B, const long long Np, const int Cw, const int Cq,
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
// error of the shared-memory attribute call). Requires Np > 0 and Np, Cw,
// Cq multiples of 16 (16-byte vector loads); the Python wrapper checks
// shapes, types and contiguity.
extern "C" int bgen_i8_launch(const void *planes, const void *Wp,
                              const void *Wq, void *D0, void *D1, void *M,
                              void *Q0, void *Q1, void *Q2, long long B,
                              long long Np, long long Cw, long long Cq,
                              void *stream) {
  cudaError_t err = cudaFuncSetAttribute(
      bgen_i8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const int ntp = (int)((Cw + BN - 1) / BN);
  const int ntq = (int)((Cq + BN - 1) / BN);
  const dim3 grid((unsigned)(ntp + ntq), (unsigned)((B + BM - 1) / BM));
  bgen_i8_kernel<<<grid, NTHREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      static_cast<const uint8_t *>(planes), static_cast<const int8_t *>(Wp),
      static_cast<const int8_t *>(Wq), static_cast<long long *>(D0),
      static_cast<long long *>(D1), static_cast<long long *>(M),
      static_cast<long long *>(Q0), static_cast<long long *>(Q1),
      static_cast<long long *>(Q2), (int)B, Np, (int)Cw, (int)Cq, ntp);
  return (int)cudaGetLastError();
}
