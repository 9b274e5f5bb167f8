// Fused int8 Step-2 products for Hopper (sm_90a): packed PLINK 2-bit
// genotype bytes against the int8 limb operand, exact int32 sums.
//
// Replaces the Pallas TPU kernel regenie_tpu/ops/fused_score.py:403
// (_fused_kernel_i8, launched by _i8_products at :434).
//
// What it computes, for raw [B, nbp] uint8 and limbs [4, nbp, Cw4] int8
// (Cw4 = 4*Cp, the [l0|l1|l2|l3] limb layout):
//   H[b, j] = sum_p sum_c [code_p(raw[b, c]) == 0] * limbs[p, c, j]
//   E[b, j] = the same sum with code == 2,  M[b, j] with code == 1
// where code_p(x) = (x >> 2p) & 3 (PLINK: 0 hom-alt, 1 missing, 2 het,
// 3 hom-ref). Pad bytes decode to code 0; the operand rows there are
// zero, and bytes past nbp / rows past B / columns past Cw4 are read
// as zero here, so the kernel relies on nothing else.
//
// Bound at the repository's full width (B=2048, N=400,000 -> nbp=100,096,
// Cw4=1536): 3 x 2 x 2048 x 400,384 x 1536 = 7.6e12 int8 operations per
// block, 3.8 ms at the H100's 1,979 dense int8 TOP/s, against 0.86 GB of
// compulsory traffic (0.26 ms at 3.35 TB/s): the kernel is bound by
// tensor-core operations, so the design keeps the tensor cores fed and
// spends as few other instructions per mma as it can:
//
// - Work split: each 256-thread block owns one 64-row x 128-column output
//   tile of all three products and loops over the whole nbp contraction
//   (no split-K, no atomics): results are exact and deterministic, and
//   the output needs no zero fill. The TPU kernel's sequential grid axis
//   over byte tiles becomes this in-block loop.
// - Tensor cores: mma.sync.m16n8k32 s8 x s8 -> s32. Each warp holds a
//   32 x 32 tile of H, E and M (96 int32 accumulators per thread).
// - Contraction order: the kernel is free to permute the contraction
//   index as long as both operands use the same order. One 32-bit word
//   of raw bytes (4 samples-bytes c..c+3) yields, per plane p, a 4-lane
//   int8 A fragment register directly: lane i = bit 8i+2p of the word's
//   decoded code masks. So the decode is 3 shifts and 6 three-input
//   logic ops per 4 fragment registers, with no lookup table.
// - The operand is stored [p][c][j] (j contiguous) but an mma B fragment
//   wants 4 consecutive c per register. Each 32-byte stage is loaded
//   with 16-byte vectors, transposed in registers with byte permutes,
//   and stored to shared memory as words [p][c/4][j], XOR-swizzled on j
//   so the fragment loads are free of bank conflicts.
// - Two shared-memory stages with register staging: the global loads of
//   stage k+1 are in flight while stage k is multiplied; one barrier per
//   stage.
// wgmma, TMA and warp specialisation are left for a later redesign.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;        // variant rows per block tile
constexpr int BN = 128;       // operand columns per block tile
constexpr int KC = 32;        // packed bytes per stage (4*KC contraction terms)
constexpr int NTHREADS = 256; // 8 warps: 2 (rows) x 4 (columns)

struct __align__(16) Stage {
  uint32_t w[4][KC / 4][BN];  // plane p, byte group c/4, column j^swz
  uint8_t raw[BM][KC];
};

__device__ __forceinline__ int swz(int col, int cq) {
  return col ^ (((cq >> 1) & 3) << 3);
}

// Four rows (c..c+3) of 16 operand bytes -> 16 words, word j holding
// column j of the four rows in bytes 0..3.
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

// Plane P of four raw bytes -> hom-alt / het / missing int8 lanes.
template <int P>
__device__ __forceinline__ void decode(const uint32_t w, uint32_t &h,
                                       uint32_t &e, uint32_t &m) {
  const uint32_t lo = w >> (2 * P);
  const uint32_t hi = w >> (2 * P + 1);
  h = ~(lo | hi) & 0x01010101u;  // code 0
  e = hi & ~lo & 0x01010101u;    // code 2
  m = lo & ~hi & 0x01010101u;    // code 1
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t a0,
                                       const uint32_t a1, const uint32_t a2,
                                       const uint32_t a3, const uint32_t b0,
                                       const uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(NTHREADS, 1)
fused_i8_kernel(const uint8_t *__restrict__ raw,
                const int8_t *__restrict__ limbs, int32_t *__restrict__ H,
                int32_t *__restrict__ E, int32_t *__restrict__ M,
                const int B, const long long nbp, const int Cw4) {
  __shared__ Stage st[2];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const int r0 = blockIdx.y * BM, j0 = blockIdx.x * BN;

  // loader coordinates: operand plane / byte group / 16-column vector,
  // and raw row / 16-byte half (threads 0..127)
  const int lp = tid >> 6, lcq = (tid >> 3) & 7, ljv = tid & 7;
  const int lrow = tid >> 1, lhalf = tid & 1;
  const int lj = j0 + ljv * 16;
  const bool lj_ok = lj < Cw4;
  const bool lraw = tid < 2 * BM;
  const bool lrow_ok = lraw && (r0 + lrow < B);

  uint4 vw[4];
  uint4 vr = make_uint4(0, 0, 0, 0);

  auto gload = [&](const long long c0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long c = c0 + 4 * lcq + i;
      if (lj_ok && c < nbp) {
        vw[i] = __ldg(reinterpret_cast<const uint4 *>(
            limbs + ((long long)lp * nbp + c) * Cw4 + lj));
      } else {
        vw[i] = make_uint4(0, 0, 0, 0);
      }
    }
    if (lraw) {
      const long long c = c0 + lhalf * 16;
      if (lrow_ok && c < nbp) {
        vr = __ldg(reinterpret_cast<const uint4 *>(
            raw + (long long)(r0 + lrow) * nbp + c));
      } else {
        vr = make_uint4(0, 0, 0, 0);
      }
    }
  };

  auto sstore = [&](Stage &s) {
    uint4 o;
    transpose4(vw[0].x, vw[1].x, vw[2].x, vw[3].x, o);
    *reinterpret_cast<uint4 *>(&s.w[lp][lcq][swz(ljv * 16 + 0, lcq)]) = o;
    transpose4(vw[0].y, vw[1].y, vw[2].y, vw[3].y, o);
    *reinterpret_cast<uint4 *>(&s.w[lp][lcq][swz(ljv * 16 + 4, lcq)]) = o;
    transpose4(vw[0].z, vw[1].z, vw[2].z, vw[3].z, o);
    *reinterpret_cast<uint4 *>(&s.w[lp][lcq][swz(ljv * 16 + 8, lcq)]) = o;
    transpose4(vw[0].w, vw[1].w, vw[2].w, vw[3].w, o);
    *reinterpret_cast<uint4 *>(&s.w[lp][lcq][swz(ljv * 16 + 12, lcq)]) = o;
    if (lraw) {
      *reinterpret_cast<uint4 *>(&s.raw[lrow][lhalf * 16]) = vr;
    }
  };

  int acc[3][2][4][4];
#pragma unroll
  for (int ty = 0; ty < 3; ++ty)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[ty][mt][nt][r] = 0;

  const long long nk = (nbp + KC - 1) / KC;
  gload(0);
  sstore(st[0]);
  __syncthreads();

  for (long long k = 0; k < nk; ++k) {
    Stage &s = st[k & 1];
    if (k + 1 < nk) gload((k + 1) * KC);

    // this thread's raw bytes [8t, 8t+8) of rows g and g+8 per m-tile
    uint2 rw[2][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int row = wm * 32 + mt * 16 + g;
      rw[mt][0] = *reinterpret_cast<const uint2 *>(&s.raw[row][8 * t]);
      rw[mt][1] = *reinterpret_cast<const uint2 *>(&s.raw[row + 8][8 * t]);
    }

#pragma unroll
    for (int step = 0; step < 4; ++step) {
      // contraction order of this k32 step: A register 0 (and B register
      // 0) = plane p0 of bytes 4*cq .. 4*cq+3, register 2 (B register 1)
      // = plane p0+1 of the same bytes, cq = 2t + step/2
      const int cq = 2 * t + (step >> 1);
      uint32_t bf[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = swz(wn * 32 + nt * 8 + g, cq);
        bf[nt][0] = s.w[2 * (step & 1)][cq][col];
        bf[nt][1] = s.w[2 * (step & 1) + 1][cq][col];
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const uint32_t wlo = (step >> 1) ? rw[mt][0].y : rw[mt][0].x;
        const uint32_t whi = (step >> 1) ? rw[mt][1].y : rw[mt][1].x;
        uint32_t a[3][4];
        if (step & 1) {
          decode<2>(wlo, a[0][0], a[1][0], a[2][0]);
          decode<2>(whi, a[0][1], a[1][1], a[2][1]);
          decode<3>(wlo, a[0][2], a[1][2], a[2][2]);
          decode<3>(whi, a[0][3], a[1][3], a[2][3]);
        } else {
          decode<0>(wlo, a[0][0], a[1][0], a[2][0]);
          decode<0>(whi, a[0][1], a[1][1], a[2][1]);
          decode<1>(wlo, a[0][2], a[1][2], a[2][2]);
          decode<1>(whi, a[0][3], a[1][3], a[2][3]);
        }
#pragma unroll
        for (int ty = 0; ty < 3; ++ty)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            mma_s8(acc[ty][mt][nt], a[ty][0], a[ty][1], a[ty][2], a[ty][3],
                   bf[nt][0], bf[nt][1]);
      }
    }

    if (k + 1 < nk) sstore(st[(k + 1) & 1]);
    __syncthreads();
  }

  int32_t *const outs[3] = {H, E, M};
#pragma unroll
  for (int ty = 0; ty < 3; ++ty) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int row = r0 + wm * 32 + mt * 16 + g;
        const int col = j0 + wn * 32 + nt * 8 + 2 * t;
        if (col >= Cw4) continue;
        const int *c = acc[ty][mt][nt];
        if (row < B) {
          *reinterpret_cast<int2 *>(outs[ty] + (long long)row * Cw4 + col) =
              make_int2(c[0], c[1]);
        }
        if (row + 8 < B) {
          *reinterpret_cast<int2 *>(outs[ty] + (long long)(row + 8) * Cw4 +
                                    col) = make_int2(c[2], c[3]);
        }
      }
    }
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). Launches on `stream`, does not
// synchronise and allocates nothing; returns cudaGetLastError().
// Requires nbp % 16 == 0 and Cw4 % 16 == 0 (16-byte vector loads); the
// Python wrapper checks shapes, types and contiguity.
extern "C" int fused_i8_launch(const void *raw, const void *limbs, void *H,
                               void *E, void *M, long long B, long long nbp,
                               long long Cw4, void *stream) {
  const dim3 grid((unsigned)((Cw4 + BN - 1) / BN), (unsigned)((B + BM - 1) / BM));
  fused_i8_kernel<<<grid, NTHREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const uint8_t *>(raw), static_cast<const int8_t *>(limbs),
      static_cast<int32_t *>(H), static_cast<int32_t *>(E),
      static_cast<int32_t *>(M), (int)B, nbp, (int)Cw4);
  return (int)cudaGetLastError();
}
