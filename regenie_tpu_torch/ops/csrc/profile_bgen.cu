// Profiling variants of the BGEN 8-bit dosage products for Hopper (sm_90a):
// seven functions built on the design of bgen_i8.cu, each differing from it
// in one part of the decode or of the products, so that their times
// attribute bgen_i8's time to the q products, the decode's arithmetic, a
// decode materialised in shared memory and the number of q limbs.
//
// Replace the Pallas TPU kernels of scripts/profile_bgen.py, the JAX
// package's attribution script for _bgen_kernel_i8. One entry point,
// profile_bgen_launch, takes the variant's index (ops/kernels.py:
// PROFILE_BGEN_VARIANTS) and, for variant 4, a tile configuration:
//   0 i32 / shift / q3       kern_base (:174, make_call :149), kern_sep
//                            (:300, make_call2 :383)
//   1 i32 / shift / noq      kern_noq (:197), kern_sep_noq (:323)
//   2 u8 / shift / q3        kern_u8 (:216)
//   3 u8 / unshift / q3 / stacked   kern_sep_merge (:343)
//   4 u8 / unshift / q3      make_base(miss_i32, 3).kern (:477, make_call3
//                            :531): production _bgen_kernel_i8's function
//   5 u8 / unshift / e2      make_base(miss_i32, 2).kern
//   6 u8 / unshift / dhl     make_base(miss_i32, 4).kern
// The TPU script reads the planes as one [B, 2, Np] block (row 9) or as two
// [B, Np] tiles (rows 10, 11); in device memory both are one run of bytes
// per variant row, so each function here takes k0 and k1 as two base
// pointers with one row stride (2 Np for the packed buffer, Np for two
// tensors) and the TPU's sublane relayout has no counterpart.
//
// What they compute, over all Np samples, for k0, k1 [B, Np] uint8, the
// operand limbs Wp [Np, Cw] int8 and the narrow operand limbs Wq [Np, Cq]
// int8, with s(x) = x - 128 taken as s8:
//   miss = k0 + k1 > 255;  k0, k1 = 0 where miss;  d = 2 k0 + k1
//   d0 = s(k0) @ Wp,  d1 = s(k1) @ Wp                            [B, Cw]
//   m  = s(miss) @ Wp (shift) or miss @ Wp (unshift)             [B, Cw]
//   q3:  q_i = s(byte_i(d^2)) @ Wq, i = 0, 1, 2                  [B, Cq]
//   noq: q0 = q1 = q2 = 0 (no Wq block is launched)
//   e2:  e = d - 255;  q0 = s(e^2 & 255) @ Wq,  q1 = s(e^2 >> 8) @ Wq,
//        q2 = 0
//   dhl: dlo = d & 255, dhi = d >> 8;  q0, q1 = s(bytes 0, 1 of dlo^2) @ Wq;
//        q2 = s(dhi dlo) @ Wq + s(dhi) @ Wq, two products into one output
// all as exact int64. Rows past B, samples past Np and columns past Cw / Cq
// read as zero and are not stored.
//
// Bound at the repository's full width (B=2048, Np=400,128, Cw=1536,
// Cq=512), 2 x 2048 x 400,128 x (3 x 1536 + n x 512) int8 operations at the
// H100's 1,979 dense int8 TOP/s: q3 (n=3) 5.088 ms, noq (n=0) 3.816 ms, e2
// (n=2) 4.664 ms, dhl (n=4) 5.512 ms, against 1.64 GB of planes (0.49 ms at
// 3.35 TB/s): bound by tensor-core operations. The design:
//
// - bgen_i8.cu's kernel: a block owns a BM x BN tile of the three Wp or
//   the three Wq products (the first ceil(Cw/BN) column tiles are Wp's)
//   and loops over the whole sample axis in stages of 128 samples, two
//   shared-memory stages with register staging, one barrier a stage; the
//   operand is transposed in registers into sample words [n/4][j],
//   XOR-swizzled on j; each warp holds a 16*MT x 8*NT tile of each
//   product. The A fragments take a sample permutation that both operands
//   share (thread-column t takes sample words 8t + 2s, 8t + 2s + 1).
// - Tensor cores: mma.sync.m16n8k32 s8 x s8 -> s32 (bgen_i8 multiplies the
//   unshifted bytes u8 x s8; here every multiplicand is a shifted s(x) or
//   the 0/1 miss, all valid s8 values).
// - Exactness: |s(x) w| <= 128 x 128, so an int32 sum is exact over 65,536
//   samples; dhl adds two products into q2, so its Wq blocks sum 32,768. A
//   thread adds its int32 chunk sums into the int64 outputs it alone owns
//   (a store for the first chunk): no atomics, no order dependence.
// - Decode i32 (variants 0, 1) against u8 (the others), as the TPU kernels
//   differ: i32 widens each byte to a 32-bit integer, masks, shifts and
//   compares there and packs the four results back (prmt); u8 works on four
//   packed bytes a word, the missing mask by __vcmpgtu4 and the shift by
//   x ^ 0x80808080. The q multiplicands (d, d^2, e^2, dlo^2, dhi dlo) are
//   made per sample in 32-bit integers after either decode, their bytes
//   gathered by byte permutes, as the TPU keeps them on its int32 path.
// - Decode in registers (all but variant 3): every warp makes the A
//   fragments of its rows from the staged plane words, as bgen_i8 does.
//   Variant 3 (stacked) decodes each stage once into a [3 BM, 128] s8 tile
//   in shared memory, the counterpart of kern_sep_merge's row-stacked
//   [3 tb, tc] operand (a Wp block the rows s(k0) | s(k1) | miss, a Wq
//   block the three q bytes), double-buffered, written by the thread that
//   loaded the plane bytes; the mma loop reads A from it by ldmatrix, one
//   [3 BM, 128] x [128, BN] product a stage. Its rows are padded to 144
//   bytes and stored in the permuted sample order, so that the ldmatrix
//   reads and the decode's stores are free of bank conflicts.
// - dhl issues its two q2 products as separate mma.sync (asm volatile)
//   into the same accumulators: s(dhi dlo) + s(dhi) overflows s8.
// - Tile configurations of variant 4 (ops/kernels.py PROFILE_BGEN_CONFIGS):
//   0: 64 x 128, 8 warps of 32 x 32 (bgen_i8's); 1: 128 x 128, 16 warps of
//   32 x 32; 2: 64 x 128, 8 warps of 16 x 64 (each decoded A fragment
//   feeds 8 column tiles, not 4). The others run configuration 0.
// wgmma, TMA and warp specialisation are left for the redesign.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum { DEC_I32 = 0, DEC_U8 = 1 };
enum { Q3 = 0, NOQ = 1, E2 = 2, DHL = 3 };

constexpr int KS = 128;       // samples per shared-memory stage
constexpr int AST = KS + 8;   // padded row stride (bytes) of a plane tile
constexpr int TST = KS + 16;  // padded row stride (bytes) of a stacked A tile
constexpr uint32_t SHIFT = 0x80808080u;

// a stage: the operand's sample words, then the block's plane rows (k0,
// k1) or, for the stacked variant, their decode ([NA x BM] rows)
template <int BM, int BN, bool STK, int NA>
struct __align__(16) Stage {
  uint32_t w[KS / 4][BN];
  uint8_t a[STK ? NA * BM : 2 * BM][STK ? TST : AST];
};

__device__ __forceinline__ int swz(int col, int q) {
  return col ^ (((q >> 3) & 3) << 3);
}

// Four rows of 16 bytes -> 16 words, word j holding column j of the four
// rows (o.x: columns 0-3 ... o.w: 12-15 of each input word, column i of
// input word x in o.<i>).
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

// the low bytes of four 32-bit integers -> one word
__device__ __forceinline__ uint32_t pack4(const int v0, const int v1,
                                          const int v2, const int v3) {
  return __byte_perm(__byte_perm(v0, v1, 0x0040), __byte_perm(v2, v3, 0x0040),
                     0x5410);
}

// A missing pair reads as k0 = k1 = 0: the four samples of a (k0, k1) word
// pair as masked 32-bit integers, by the decode DEC.
template <int DEC>
__device__ __forceinline__ void masked_ints(const uint32_t a, const uint32_t b,
                                            int (&k0)[4], int (&k1)[4]) {
  if constexpr (DEC == DEC_I32) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int x = (a >> (8 * i)) & 255, y = (b >> (8 * i)) & 255;
      const bool m = x + y > 255;
      k0[i] = m ? 0 : x;
      k1[i] = m ? 0 : y;
    }
  } else {
    const uint32_t m = __vcmpgtu4(b, ~a);  // 0xff where k1 > 255 - k0
    const uint32_t x = a & ~m, y = b & ~m;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      k0[i] = (x >> (8 * i)) & 255;
      k1[i] = (y >> (8 * i)) & 255;
    }
  }
}

// One (k0, k1) word pair (4 samples) -> the A words of a block kind:
// s(k0), s(k1) and s(miss) or miss (Wp tiles, MSH: m shifted), or the q
// multiplicands of QM (Wq tiles: q3 three, e2 two, dhl four words, the
// last two for q2).
template <int DEC, bool MSH, int QM, bool QSIDE, int NA>
__device__ __forceinline__ void decode(const uint32_t a, const uint32_t b,
                                       uint32_t (&x)[NA]) {
  if constexpr (!QSIDE) {
    if constexpr (DEC == DEC_I32) {
      int v0[4], v1[4], vm[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int p = (a >> (8 * i)) & 255, r = (b >> (8 * i)) & 255;
        const int m = p + r > 255 ? 1 : 0;
        v0[i] = (m ? 0 : p) - 128;
        v1[i] = (m ? 0 : r) - 128;
        vm[i] = MSH ? m - 128 : m;
      }
      x[0] = pack4(v0[0], v0[1], v0[2], v0[3]);
      x[1] = pack4(v1[0], v1[1], v1[2], v1[3]);
      x[2] = pack4(vm[0], vm[1], vm[2], vm[3]);
    } else {
      const uint32_t m = __vcmpgtu4(b, ~a);
      x[0] = (a & ~m) ^ SHIFT;
      x[1] = (b & ~m) ^ SHIFT;
      x[2] = (m & 0x01010101u) ^ (MSH ? SHIFT : 0u);
    }
  } else {
    int k0[4], k1[4];
    masked_ints<DEC>(a, b, k0, k1);
    uint32_t v[4];
    int hl[4], hi[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int d = 2 * k0[i] + k1[i];
      if constexpr (QM == Q3) {
        v[i] = (uint32_t)(d * d);
      } else if constexpr (QM == E2) {
        v[i] = (uint32_t)((d - 255) * (d - 255));
      } else {
        const int dlo = d & 255, dhi = d >> 8;
        v[i] = (uint32_t)(dlo * dlo);
        hl[i] = dhi * dlo;
        hi[i] = dhi;
      }
    }
    uint4 o;
    transpose4(v[0], v[1], v[2], v[3], o);
    x[0] = o.x ^ SHIFT;
    x[1] = o.y ^ SHIFT;
    if constexpr (QM == Q3) x[2] = o.z ^ SHIFT;
    if constexpr (QM == DHL) {
      x[2] = pack4(hl[0], hl[1], hl[2], hl[3]) ^ SHIFT;
      x[3] = pack4(hi[0], hi[1], hi[2], hi[3]) ^ SHIFT;
    }
  }
}

__device__ __forceinline__ void mma_s8s8(int (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t b0, const uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void *p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// the A words of a block kind and the outputs they go to
template <int QM, bool QSIDE>
__host__ __device__ constexpr int n_a() {
  return !QSIDE ? 3 : QM == E2 ? 2 : QM == DHL ? 4 : 3;
}

template <int DEC, bool MSH, int QM, bool STK, int WM, int WN, int MT, int NT,
          bool QSIDE>
__device__ __forceinline__ void tile(unsigned char *smem,
                                     const uint8_t *__restrict__ k0g,
                                     const uint8_t *__restrict__ k1g,
                                     const long long rs,
                                     const int8_t *__restrict__ W,
                                     long long *__restrict__ O0,
                                     long long *__restrict__ O1,
                                     long long *__restrict__ O2, const int B,
                                     const long long Np, const int C,
                                     const int j0) {
  constexpr int BM = WM * 16 * MT, BN = WN * 8 * NT, NTH = 32 * WM * WN;
  constexpr int NA = n_a<QM, QSIDE>();
  constexpr int NO = QSIDE && QM == E2 ? 2 : 3;
  constexpr long long CHUNK = QSIDE && QM == DHL ? 32768 : 65536;
  constexpr long long STAGES_PER_CHUNK = CHUNK / KS;
  constexpr int NV = BN / 16;  // 16-column operand vectors per sample row
  static_assert(4 * BM == NTH, "one plane segment per thread");
  static_assert(2 * BN <= NTH, "at most one operand unit per thread");
  using St = Stage<BM, BN, STK, NA>;
  St *st = reinterpret_cast<St *>(smem);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / WN, wn = warp % WN;
  const int r0 = blockIdx.y * BM;

  // loader coordinates: operand sample word / 16-column vector (threads
  // below 2 BN), and plane row / 32-sample segment
  const bool lw = tid < 2 * BN;
  const int lq = tid / NV, ljv = tid % NV;
  const int lrow = tid >> 2, lseg = tid & 3;
  const int lj = j0 + ljv * 16;
  const bool lj_ok = lw && lj < C;
  const bool lrow_ok = r0 + lrow < B;
  const long long roff = (long long)(r0 + lrow) * rs;

  uint4 vw[4];
  uint4 vp[4];  // k0 samples [0, 16), [16, 32) of the segment, then k1

  auto gload = [&](const long long n0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long n = n0 + 4 * lq + i;
      if (lj_ok && n < Np) {
        vw[i] = __ldg(reinterpret_cast<const uint4 *>(W + n * C + lj));
      } else {
        vw[i] = make_uint4(0, 0, 0, 0);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long n = n0 + 32 * lseg + 16 * (i & 1);
      if (lrow_ok && n < Np) {
        vp[i] = __ldg(reinterpret_cast<const uint4 *>((i >> 1 ? k1g : k0g) + roff + n));
      } else {
        vp[i] = make_uint4(0, 0, 0, 0);
      }
    }
  };

  auto sstore = [&](St &s) {
    if (lw) {
      uint4 o;
      transpose4(vw[0].x, vw[1].x, vw[2].x, vw[3].x, o);
      *reinterpret_cast<uint4 *>(&s.w[lq][swz(ljv * 16 + 0, lq)]) = o;
      transpose4(vw[0].y, vw[1].y, vw[2].y, vw[3].y, o);
      *reinterpret_cast<uint4 *>(&s.w[lq][swz(ljv * 16 + 4, lq)]) = o;
      transpose4(vw[0].z, vw[1].z, vw[2].z, vw[3].z, o);
      *reinterpret_cast<uint4 *>(&s.w[lq][swz(ljv * 16 + 8, lq)]) = o;
      transpose4(vw[0].w, vw[1].w, vw[2].w, vw[3].w, o);
      *reinterpret_cast<uint4 *>(&s.w[lq][swz(ljv * 16 + 12, lq)]) = o;
    }
    if constexpr (!STK) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        uint8_t *dst = s.a[(i >> 1) * BM + lrow] + 32 * lseg + 16 * (i & 1);
        reinterpret_cast<uint2 *>(dst)[0] = make_uint2(vp[i].x, vp[i].y);
        reinterpret_cast<uint2 *>(dst)[1] = make_uint2(vp[i].z, vp[i].w);
      }
    } else {
      // decode the 8 sample words q = 8 lseg + j of row lrow; word q goes
      // to 16-byte chunk q & 7, word q >> 3 of it (the permuted order)
      const uint32_t ka[8] = {vp[0].x, vp[0].y, vp[0].z, vp[0].w,
                              vp[1].x, vp[1].y, vp[1].z, vp[1].w};
      const uint32_t kb[8] = {vp[2].x, vp[2].y, vp[2].z, vp[2].w,
                              vp[3].x, vp[3].y, vp[3].z, vp[3].w};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t x[NA];
        decode<DEC, MSH, QM, QSIDE, NA>(ka[j], kb[j], x);
#pragma unroll
        for (int ty = 0; ty < NA; ++ty)
          reinterpret_cast<uint32_t *>(s.a[ty * BM + lrow])[4 * j + lseg] = x[ty];
      }
    }
  };

  int acc[3][MT][NT][4];
  auto zero_acc = [&]() {
#pragma unroll
    for (int ty = 0; ty < 3; ++ty)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[ty][mt][nt][r] = 0;
  };

  // add this chunk's int32 partial sums into the int64 outputs (each
  // output element belongs to one thread of one block)
  auto flush = [&](const bool first) {
    long long *const outs[3] = {O0, O1, O2};
#pragma unroll
    for (int ty = 0; ty < NO; ++ty) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int col = j0 + wn * 8 * NT + nt * 8 + 2 * t;
          if (col >= C) continue;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = r0 + wm * 16 * MT + mt * 16 + g + 8 * h;
            if (row >= B) continue;
            longlong2 *p = reinterpret_cast<longlong2 *>(
                outs[ty] + (long long)row * C + col);
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
    St &s = st[k & 1];
    if (k + 1 < nk) gload((k + 1) * KS);

#pragma unroll
    for (int step = 0; step < 4; ++step) {
      // sample words q0 = 8t + 2 step (A/B registers 0, 1) and q0 + 1
      // (registers 2, 3 of A, 1 of B)
      const int q0 = 8 * t + 2 * step;
      uint32_t bf[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = wn * 8 * NT + nt * 8 + g;
        bf[nt][0] = s.w[q0][swz(col, q0)];
        bf[nt][1] = s.w[q0 + 1][swz(col, q0 + 1)];
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int row = wm * 16 * MT + mt * 16 + g;
        if constexpr (!STK) {
          const uint2 a_lo = *reinterpret_cast<const uint2 *>(&s.a[row][4 * q0]);
          const uint2 a_hi = *reinterpret_cast<const uint2 *>(&s.a[row + 8][4 * q0]);
          const uint2 b_lo = *reinterpret_cast<const uint2 *>(&s.a[BM + row][4 * q0]);
          const uint2 b_hi = *reinterpret_cast<const uint2 *>(&s.a[BM + row + 8][4 * q0]);
          uint32_t x[4][NA];
          decode<DEC, MSH, QM, QSIDE, NA>(a_lo.x, b_lo.x, x[0]);
          decode<DEC, MSH, QM, QSIDE, NA>(a_hi.x, b_hi.x, x[1]);
          decode<DEC, MSH, QM, QSIDE, NA>(a_lo.y, b_lo.y, x[2]);
          decode<DEC, MSH, QM, QSIDE, NA>(a_hi.y, b_hi.y, x[3]);
#pragma unroll
          for (int ty = 0; ty < NA; ++ty) {
            const uint32_t a[4] = {x[0][ty], x[1][ty], x[2][ty], x[3][ty]};
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
              mma_s8s8(acc[ty < 3 ? ty : 2][mt][nt], a, bf[nt][0], bf[nt][1]);
          }
        } else {
          // matrices: rows +0..7 / +8..15 of chunks 2 step and 2 step + 1
          const int mi = lane >> 3;
          const int arow = row - g + (lane & 7) + 8 * (mi & 1);
          const int chunk = 2 * step + (mi >> 1);
#pragma unroll
          for (int ty = 0; ty < NA; ++ty) {
            uint32_t a[4];
            ldmatrix_x4(a, &s.a[ty * BM + arow][16 * chunk]);
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
              mma_s8s8(acc[ty < 3 ? ty : 2][mt][nt], a, bf[nt][0], bf[nt][1]);
          }
        }
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

template <int DEC, bool MSH, int QM, bool STK, int WM, int WN, int MT, int NT>
__global__ void __launch_bounds__(32 * WM * WN, 1)
profile_bgen_kernel(const uint8_t *__restrict__ k0, const uint8_t *__restrict__ k1,
                    const long long rs, const int8_t *__restrict__ Wp,
                    const int8_t *__restrict__ Wq, long long *__restrict__ D0,
                    long long *__restrict__ D1, long long *__restrict__ M,
                    long long *__restrict__ Q0, long long *__restrict__ Q1,
                    long long *__restrict__ Q2, const int B, const long long Np,
                    const int Cw, const int Cq, const int ntp) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int BN = WN * 8 * NT;
  if ((int)blockIdx.x < ntp) {
    tile<DEC, MSH, QM, STK, WM, WN, MT, NT, false>(smem, k0, k1, rs, Wp, D0, D1, M,
                                                   B, Np, Cw, blockIdx.x * BN);
  } else if constexpr (QM != NOQ) {
    tile<DEC, MSH, QM, STK, WM, WN, MT, NT, true>(smem, k0, k1, rs, Wq, Q0, Q1, Q2,
                                                  B, Np, Cq, (blockIdx.x - ntp) * BN);
  }
}

template <int DEC, bool MSH, int QM, bool STK, int WM, int WN, int MT, int NT>
int launch(const void *k0, const void *k1, const void *Wp, const void *Wq,
           void *D0, void *D1, void *M, void *Q0, void *Q1, void *Q2,
           long long rs, long long B, long long Np, long long Cw, long long Cq,
           cudaStream_t stream) {
  constexpr int BM = WM * 16 * MT, BN = WN * 8 * NT;
  constexpr int smem_p = (int)(2 * sizeof(Stage<BM, BN, STK, 3>));
  constexpr int smem_q = (int)(2 * sizeof(Stage<BM, BN, STK, n_a<QM, true>()>));
  constexpr int smem = smem_p > smem_q ? smem_p : smem_q;
  cudaError_t err = cudaFuncSetAttribute(
      profile_bgen_kernel<DEC, MSH, QM, STK, WM, WN, MT, NT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  // the q outputs this function leaves at 0, as the TPU kernel's _init does
  const size_t qbytes = (size_t)B * (size_t)Cq * sizeof(long long);
  if (QM == NOQ) {
    void *const qs[3] = {Q0, Q1, Q2};
    for (int i = 0; i < 3; ++i) {
      err = cudaMemsetAsync(qs[i], 0, qbytes, stream);
      if (err != cudaSuccess) return (int)err;
    }
  } else if (QM == E2) {
    err = cudaMemsetAsync(Q2, 0, qbytes, stream);
    if (err != cudaSuccess) return (int)err;
  }
  const int ntp = (int)((Cw + BN - 1) / BN);
  const int ntq = QM == NOQ ? 0 : (int)((Cq + BN - 1) / BN);
  const dim3 grid((unsigned)(ntp + ntq), (unsigned)((B + BM - 1) / BM));
  profile_bgen_kernel<DEC, MSH, QM, STK, WM, WN, MT, NT>
      <<<grid, 32 * WM * WN, smem, stream>>>(
      static_cast<const uint8_t *>(k0), static_cast<const uint8_t *>(k1), rs,
      static_cast<const int8_t *>(Wp), static_cast<const int8_t *>(Wq),
      static_cast<long long *>(D0), static_cast<long long *>(D1),
      static_cast<long long *>(M), static_cast<long long *>(Q0),
      static_cast<long long *>(Q1), static_cast<long long *>(Q2), (int)B, Np,
      (int)Cw, (int)Cq, ntp);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). Launches variant `variant` in
// tile configuration `config` on `stream`, does not synchronise and
// allocates nothing; returns cudaGetLastError() (or the error of the
// shared-memory attribute call or of a memset), and cudaErrorInvalidValue
// for a variant or configuration it does not have. k0 and k1 point at the
// first row of each plane, `rs` bytes apart from one row to the next.
// Requires Np > 0 and Np, rs, Cw, Cq multiples of 16 (16-byte vector
// loads); the Python wrapper checks shapes, types, strides and alignment.
extern "C" int profile_bgen_launch(const void *k0, const void *k1, const void *Wp,
                                   const void *Wq, void *D0, void *D1, void *M,
                                   void *Q0, void *Q1, void *Q2, long long rs,
                                   long long B, long long Np, long long Cw,
                                   long long Cq, long long variant,
                                   long long config, void *stream) {
#define PB_PASS k0, k1, Wp, Wq, D0, D1, M, Q0, Q1, Q2, rs, B, Np, Cw, Cq, \
                (cudaStream_t)stream
  if (config != 0 && variant != 4) return (int)cudaErrorInvalidValue;
  switch (variant) {
    case 0: return launch<DEC_I32, true, Q3, false, 2, 4, 2, 4>(PB_PASS);
    case 1: return launch<DEC_I32, true, NOQ, false, 2, 4, 2, 4>(PB_PASS);
    case 2: return launch<DEC_U8, true, Q3, false, 2, 4, 2, 4>(PB_PASS);
    case 3: return launch<DEC_U8, false, Q3, true, 2, 4, 2, 4>(PB_PASS);
    case 4:
      switch (config) {
        case 0: return launch<DEC_U8, false, Q3, false, 2, 4, 2, 4>(PB_PASS);
        case 1: return launch<DEC_U8, false, Q3, false, 4, 4, 2, 4>(PB_PASS);
        case 2: return launch<DEC_U8, false, Q3, false, 4, 2, 1, 8>(PB_PASS);
        default: return (int)cudaErrorInvalidValue;
      }
    case 5: return launch<DEC_U8, false, E2, false, 2, 4, 2, 4>(PB_PASS);
    case 6: return launch<DEC_U8, false, DHL, false, 2, 4, 2, 4>(PB_PASS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef PB_PASS
}
