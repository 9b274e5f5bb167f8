// BGEN 8-bit dosage products for Hopper (sm_90a) against the bf16
// hi|mid|lo split operands: the two per-sample probability byte planes of
// a variant block times the bf16 sample-ordered operands, on the bf16
// tensor cores by warpgroup products (wgmma) with A from registers,
// float32 partial sums added into float64.
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
// nearest: sums carried in the accumulators over 1024 samples moved the
// first block's LOG10P by 1.7e-5 on a near-constant covariate column. So
// the wgmma sums run from zero over one stage (64 samples: scale-d = 0 on
// a stage's first product), the stage sums are added in float32 with
// round-to-nearest adds, and every FLUSH = 4096 samples that float32 sum
// is added into the float64 output in device memory (the first flush
// stores): one float32 sum rounds by at most about FLUSH x 2^-23 of its
// terms' magnitudes. Each output element has one owning thread, so there
// are no atomics and the result is deterministic. The mask and ind
// columns are 0/1: their partial sums are integers below 255 x 4096 <
// 2^24, exact, so the products behind INFO and A1FREQ are exact.
//
// Bound at the repository's full width (B=2048, Np=400,128, Cw=1152,
// Cq=384): 2 x 2048 x 400,128 x (3 x 1152 + 3 x 384) = 7.552e12 bf16
// tensor-core operations per block, 7.64 ms at the H100's 989 dense
// TFLOP/s, against 2.94 GB of compulsory traffic (0.88 ms at 3.35 TB/s):
// bound by operations. The design:
//
// - Tensor cores: wgmma.mma_async m64n64k16 bf16 -> f32, A (the decoded
//   multiplicands) from registers, B (the operand tile) from shared
//   memory by descriptor. A 256-thread block is two warpgroups; it owns a
//   128-row x 64-column output tile of either the three Wp products or
//   the three Wq products (the first ceil(Cw/64) column tiles are Wp's)
//   and loops over the whole sample axis, no split-K: 384 blocks at full
//   width, one a SM. Each warpgroup owns 64 rows, so each decoded sample
//   pair feeds 3 x 64 columns; the three products share the B tile. A
//   thread holds 3 x 32 float32 accumulators and 3 x 32 float32 partial
//   sums.
// - Overlap: the wgmma are asynchronous, so a warp decodes the next 16
//   samples while the tensor cores run the products of the last 16. The
//   A registers are double-buffered: a step's decode never writes
//   registers that an in-flight wgmma reads (wgmma.wait_group 1 before a
//   buffer is written again). During a stage's last step the warps wait
//   for the next stage's data and decode its first step; that step's
//   three products are committed one group each, so each product's sums
//   are taken while the next one runs. The sums need every wgmma of the
//   stage done (ptxas serialises the wgmma if an accumulator is read
//   while a later wgmma on it may be in flight), so the tensor cores
//   drain once a stage.
// - Decode in registers: lane (g, t) of warp w of a warpgroup loads the
//   32-bit sample words 4t..4t+3 of k0 and k1 for its rows 16w + g and
//   16w + g + 8, which the A fragment reads at the k positions (2t, 2t+1,
//   2t+8, 2t+9); the operand rows are stored in the same order, so the
//   contraction is unchanged. __vcmpgtu4 gives the missing mask of four
//   samples at once. A byte becomes a float32 as (2^23 + x) - 2^23 (one
//   byte permute and one add), whose top half is its bf16 value; two
//   halves pack into one register with one more byte permute; the 0/1
//   mask is built as 0x3F80 directly.
// - The operand keeps the JAX layout [n][j] (j contiguous): stages of 64
//   samples x 64 columns (rows of 128 bytes) arrive by 16-byte cp.async
//   copies (zero-filled past the edges), five stages in a ring, three
//   loaded ahead, each 16-byte chunk of a row XOR-swizzled by the row:
//   the 128-byte swizzle of an MN-major wgmma B operand (transpose-B),
//   each stage on a 1024-byte boundary. Plane rows are padded to 80
//   bytes.
// What holds it back: the decode, the copies' addressing and the sums
// are integer and float instructions of the same SMs whose tensor cores
// run the wgmma, and on this card they hardly overlap them (the time is
// close to the tensor cores' time plus the instructions' time). TMA with
// mbarrier rings, clusters with multicast of the plane tile and
// persistent blocks are left for a later redesign.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;        // variant rows per block tile (64 a warpgroup)
constexpr int BN = 64;         // operand columns per block tile
constexpr int KS = 64;         // samples per stage
constexpr int AST = KS + 16;   // padded plane row stride (bytes)
constexpr int NSTAGE = 5;      // stages in the ring
constexpr int PREFETCH = NSTAGE - 2;  // stages loaded ahead of the one in use
constexpr int NTHREADS = 256;  // two warpgroups
constexpr int FLUSH = 4096;    // samples per float32 partial sum
constexpr int FLUSH_STAGES = FLUSH / KS;
constexpr int ORS = NTHREADS / 8;  // operand rows copied at once
constexpr int OCP = KS / ORS;      // operand copies a thread a stage
constexpr int PCH = KS / 16;       // 16-byte chunks of a plane row
constexpr int PRS = NTHREADS / PCH;  // plane rows copied at once

struct Stage {
  uint16_t w[KS][BN];    // operand: row k, column chunk (j/8) ^ (k & 7)
  uint8_t k0[BM][AST];   // plane k0 of the block's rows
  uint8_t k1[BM][AST];   // plane k1
};
static_assert(sizeof(Stage) % 1024 == 0, "stages on 1024-byte boundaries");
// the stages, and room to align the first to 1024 bytes
constexpr int SMEM_BYTES = NSTAGE * (int)sizeof(Stage) + 1024;

__device__ __forceinline__ void cp16(const unsigned smem, const void *gmem,
                                     const bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem),
               "l"(gmem), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// shared-memory writes of this thread (cp.async) visible to wgmma, which
// reads through the async proxy
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving reads of the accumulators above the
// wgmma.wait_group that makes them valid
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// part += acc once at most N wgmma groups are pending
template <int N>
__device__ __forceinline__ void sum_into(float (&part)[32], float (&acc)[32]) {
  wgmma_wait<N>();
  fence_regs(acc);
#pragma unroll
  for (int r = 0; r < 32; ++r) part[r] += acc[r];
}

// Descriptor of a 64-column bf16 B tile at shared address `saddr`
// (1024-byte aligned), MN-major with the 128-byte swizzle: start address
// >> 4, the stride between 8-row groups along K (1024 bytes) as SBO; the
// tile is one swizzle atom wide along N, so LBO (the stride between atoms
// along N) is never used and is given the same value; layout type 1 =
// SWIZZLE_128B.
__device__ __forceinline__ uint64_t b_desc(const unsigned saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// D[64 x 64] += A[64 x 16] B[16 x 64]: A from registers (this warp's 16
// rows in the mma.m16n8k16 A layout), B by descriptor, transposed
// (MN-major).
#define WGMMA_D32(c)                                                        \
  c(d[0]), c(d[1]), c(d[2]), c(d[3]), c(d[4]), c(d[5]), c(d[6]), c(d[7]),   \
      c(d[8]), c(d[9]), c(d[10]), c(d[11]), c(d[12]), c(d[13]), c(d[14]),   \
      c(d[15]), c(d[16]), c(d[17]), c(d[18]), c(d[19]), c(d[20]), c(d[21]), \
      c(d[22]), c(d[23]), c(d[24]), c(d[25]), c(d[26]), c(d[27]), c(d[28]), \
      c(d[29]), c(d[30]), c(d[31])
#define WGMMA_M64N64K16(scale_d)                                             \
  "{\n.reg .pred p;\nsetp.ne.b32 p, " scale_d ", 0;\n"                       \
  "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "                    \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
#define WGMMA_RW(x) "+f"(x)
#define WGMMA_W(x) "=f"(x)
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                const uint64_t desc) {
  asm volatile(WGMMA_M64N64K16("1")
               : WGMMA_D32(WGMMA_RW)
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc));
}
// the same with scale-d = 0: D = A B, D's old value neither read nor kept
__device__ __forceinline__ void wgmma_m64n64k16_first(float (&d)[32],
                                                      const uint32_t (&a)[4],
                                                      const uint64_t desc) {
  asm volatile(WGMMA_M64N64K16("0")
               : WGMMA_D32(WGMMA_W)
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc));
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

// One (k0, k1) pair of 32-bit words (samples s..s+3 of one row) -> the A
// registers of a block kind for samples (s, s+1) (lo) and (s+2, s+3)
// (hi): k0, k1 and missing (Wp tiles), or the bytes 0, 1, 2 of d2 (Wq
// tiles). A missing pair reads as k0 = k1 = 0.
template <bool SQ>
__device__ __forceinline__ void decode(const uint32_t a, const uint32_t b,
                                       uint32_t (&lo)[3], uint32_t (&hi)[3]) {
  const uint32_t m = __vcmpgtu4(b, ~a);  // 0xff where k1 > 255 - k0
  const uint32_t k0 = a & ~m, k1 = b & ~m;
  if (!SQ) {
    lo[0] = pack2(bytef<0>(k0), bytef<1>(k0));
    hi[0] = pack2(bytef<2>(k0), bytef<3>(k0));
    lo[1] = pack2(bytef<0>(k1), bytef<1>(k1));
    hi[1] = pack2(bytef<2>(k1), bytef<3>(k1));
    const uint32_t y = m & 0x01010101u;
    lo[2] = __byte_perm(y, 0, 0x4140) * 0x3F80u;  // bf16 1.0 where missing
    hi[2] = __byte_perm(y, 0, 0x4342) * 0x3F80u;
  } else {
    uint32_t e[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t d = 2u * ((k0 >> (8 * i)) & 255u) + ((k1 >> (8 * i)) & 255u);
      e[i] = d * d;
    }
    lo[0] = pack2(bytef<0>(e[0]), bytef<0>(e[1]));
    lo[1] = pack2(bytef<1>(e[0]), bytef<1>(e[1]));
    lo[2] = pack2(bytef<2>(e[0]), bytef<2>(e[1]));
    hi[0] = pack2(bytef<0>(e[2]), bytef<0>(e[3]));
    hi[1] = pack2(bytef<1>(e[2]), bytef<1>(e[3]));
    hi[2] = pack2(bytef<2>(e[2]), bytef<2>(e[3]));
  }
}

// The A fragments of this warp's 16 rows for the 16 samples at nb of a
// stage: registers 0..3 of product ty are (k 2t, 2t+1 | row g), (row
// g+8), (k 2t+8, 2t+9 | row g), (row g+8), holding samples 4t, 4t+1 and
// 4t+2, 4t+3.
template <bool SQ>
__device__ __forceinline__ void decode_step(const Stage &s, const int arow,
                                            const int nb, const int t,
                                            uint32_t (&a)[3][4]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = arow + 8 * h;
    uint32_t lo[3], hi[3];
    decode<SQ>(*reinterpret_cast<const uint32_t *>(&s.k0[row][nb + 4 * t]),
               *reinterpret_cast<const uint32_t *>(&s.k1[row][nb + 4 * t]),
               lo, hi);
#pragma unroll
    for (int ty = 0; ty < 3; ++ty) {
      a[ty][h] = lo[ty];
      a[ty][2 + h] = hi[ty];
    }
  }
}

// part into the float64 outputs O0, O1, O2 [B, Cw] at rows row0 and
// row0 + 8 and columns col0 + 8 c (+ 1): the first flush stores, later
// ones add (the old values loaded together); each element is this
// thread's alone. part is zeroed.
__device__ __forceinline__ void flush(float (&part)[3][32], double *const O0,
                                      double *const O1, double *const O2,
                                      const int row0, const int col0,
                                      const int B, const int Cw,
                                      const bool first) {
#pragma unroll
  for (int ty = 0; ty < 3; ++ty) {
    double *const o = ty == 0 ? O0 : ty == 1 ? O1 : O2;
    double2 old[BN / 8][2];
#pragma unroll
    for (int c = 0; c < BN / 8; ++c)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = col0 + 8 * c, row = row0 + 8 * h;
        old[c][h] = make_double2(0.0, 0.0);
        if (!first && col < Cw && row < B)
          old[c][h] = *reinterpret_cast<const double2 *>(o + (long long)row * Cw + col);
      }
#pragma unroll
    for (int c = 0; c < BN / 8; ++c)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = col0 + 8 * c, row = row0 + 8 * h;
        if (col < Cw && row < B)
          *reinterpret_cast<double2 *>(o + (long long)row * Cw + col) =
              make_double2(old[c][h].x + (double)part[ty][4 * c + 2 * h],
                           old[c][h].y + (double)part[ty][4 * c + 2 * h + 1]);
        part[ty][4 * c + 2 * h] = 0.f;
        part[ty][4 * c + 2 * h + 1] = 0.f;
      }
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
  const int r0 = blockIdx.y * BM;
  // rows of this lane: warpgroup warp >> 2 owns 64, its warp warp & 3
  // supplies 16 of them
  const int arow = (warp >> 2) * 64 + (warp & 3) * 16 + g;

  // One stage: KS x BN/8 operand chunks, OCP a thread (sample rows on +
  // ORS i, chunk ov), and 2 x BM x PCH plane chunks, 2 BM / PRS a thread
  // (rows prow + PRS h of each plane, chunk pv). Sample q of a
  // 16-sample group goes to operand row 2 (q >> 2) + (q & 1) + 8 ((q >> 1)
  // & 1), the k position where the A fragment holds it. The addresses
  // that do not change from stage to stage are computed once.
  const int on = tid >> 3, ov = tid & 7, oq = on & 15;
  const int okr = (on & ~15) | (2 * (oq >> 2) + (oq & 1) + 8 * ((oq >> 1) & 1));
  const bool ocol = j0 + 8 * ov < Cw;
  const uint16_t *const osrc = W + (long long)on * Cw + j0 + 8 * ov;
  const unsigned odst = (unsigned)(okr * BN + 8 * (ov ^ (okr & 7))) * 2u;
  const int prow = tid / PCH, pv = tid % PCH;
  const uint8_t *const psrc = planes + (long long)(r0 + prow) * 2 * Np + 16 * pv;
  const unsigned pdst = (unsigned)(offsetof(Stage, k0) + prow * AST + 16 * pv);
  const unsigned sbase = (unsigned)__cvta_generic_to_shared(st);
  // a copy whose predicate is false reads no bytes (its source size is
  // 0) and fills zeros, so its address need not be valid
  auto load = [&](const int slot, const int n0) {
    const unsigned sb = sbase + slot * (unsigned)sizeof(Stage);
    const uint16_t *const o = osrc + (long long)n0 * Cw;
#pragma unroll
    for (int i = 0; i < OCP; ++i)
      cp16(sb + odst + ORS * BN * 2 * i, o + (long long)(ORS * i) * Cw,
           ocol && n0 + on + ORS * i < Np);
    const uint8_t *const q = psrc + n0;
    const bool nok = n0 + 16 * pv < Np;
#pragma unroll
    for (int h = 0; h < BM / PRS; ++h)
#pragma unroll
      for (int pl = 0; pl < 2; ++pl)
        cp16(sb + pdst + (pl * BM + h * PRS) * AST,
             q + (long long)(2 * PRS * h + pl) * Np,
             nok && r0 + prow + PRS * h < B);
  };

  // acc: the wgmma sums of one stage, from zero; part: their float32 sum
  // (round-to-nearest adds) since the last flush. Element 4 c + r of
  // either is column 8 c + 2 t + (r & 1) of row arow + 8 (r >> 1).
  float acc[3][32], part[3][32];
#pragma unroll
  for (int ty = 0; ty < 3; ++ty)
#pragma unroll
    for (int r = 0; r < 32; ++r) part[ty][r] = 0.f;

  const int nk = (Np + KS - 1) / KS;
#pragma unroll
  for (int s = 0; s < PREFETCH; ++s) {
    if (s < nk) load(s, s * KS);
    cp_commit();
  }
  cp_wait<PREFETCH - 1>();
  fence_proxy_async();
  __syncthreads();

  // A buffers: a[0] for steps 0 and 2 of a stage, a[1] for steps 1 and 3;
  // a buffer is written again only after the wgmma group that read it is
  // done
  uint32_t a[2][3][4];
  decode_step<SQ>(st[0], arow, 0, t, a[0]);
  for (int k = 0; k < nk; ++k) {
    const Stage &s = st[k % NSTAGE];
    // 16 operand rows = 2048 bytes = 128 descriptor units a step
    const uint64_t desc = b_desc((unsigned)__cvta_generic_to_shared(&s.w[0][0]));
    // step 0 (decoded at the end of the last stage), from zero
    wgmma_fence();
#pragma unroll
    for (int ty = 0; ty < 3; ++ty) wgmma_m64n64k16_first(acc[ty], a[0][ty], desc);
    wgmma_commit();
    // the slot of stage k - 2, which every warp finished before the
    // barrier of the last stage
    if (k + PREFETCH < nk) load((k + PREFETCH) % NSTAGE, (k + PREFETCH) * KS);
    cp_commit();
#pragma unroll
    for (int j = 1; j < KS / 16; ++j) {
      // the A buffer of step j - 2 is free once its group is done
      if (j >= 2) wgmma_wait<1>();
      decode_step<SQ>(s, arow, 16 * j, t, a[j & 1]);
      wgmma_fence();
#pragma unroll
      for (int ty = 0; ty < 3; ++ty) {
        wgmma_m64n64k16(acc[ty], a[j & 1][ty], desc + 128 * j);
        // the last step: one group a product, so that its sums can be
        // taken while the next one runs
        if (j == KS / 16 - 1) wgmma_commit();
      }
      if (j < KS / 16 - 1) wgmma_commit();
    }
    // the next stage's data, and its first decode while step 3 runs
    if (k + 1 < nk) {
      cp_wait<PREFETCH - 1>();
      fence_proxy_async();
      __syncthreads();
      wgmma_wait<3>();  // step 2's group is done: a[0] is free
      decode_step<SQ>(st[(k + 1) % NSTAGE], arow, 0, t, a[0]);
    }
    sum_into<2>(part[0], acc[0]);
    sum_into<1>(part[1], acc[1]);
    sum_into<0>(part[2], acc[2]);
    if ((k + 1) % FLUSH_STAGES == 0 || k + 1 == nk)
      flush(part, O0, O1, O2, r0 + arow, j0 + 2 * t, B, Cw, k < FLUSH_STAGES);
  }
  cp_wait<0>();
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
  // the swizzle reads address bits 7..9: align the ring to 1024 bytes
  const unsigned base = (unsigned)__cvta_generic_to_shared(smem);
  Stage *st = reinterpret_cast<Stage *>(smem + ((1024u - (base & 1023u)) & 1023u));
  if ((int)blockIdx.x < ntp) {
    tile<false>(st, planes, Wp, D0, D1, M, B, Np, Cw, blockIdx.x * BN);
  } else {
    tile<true>(st, planes, Wq, Q0, Q1, Q2, B, Np, Cq, (blockIdx.x - ntp) * BN);
  }
}

dim3 grid_of(const long long B, const long long Cw, const long long Cq, int *ntp) {
  *ntp = (int)((Cw + BN - 1) / BN);
  const int ntq = (int)((Cq + BN - 1) / BN);
  return dim3((unsigned)(*ntp + ntq), (unsigned)((B + BM - 1) / BM));
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
  int ntp;
  const dim3 grid = grid_of(B, Cw, Cq, &ntp);
  bgen_bf16_kernel<<<grid, NTHREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      static_cast<const uint8_t *>(planes), static_cast<const uint16_t *>(Wp),
      static_cast<const uint16_t *>(Wq), static_cast<double *>(D0),
      static_cast<double *>(D1), static_cast<double *>(M),
      static_cast<double *>(Q0), static_cast<double *>(Q1),
      static_cast<double *>(Q2), (int)B, (int)Np, (int)Cw, (int)Cq, ntp);
  return (int)cudaGetLastError();
}

// The launch's shape for B rows, Cw and Cq columns, as the CUDA runtime
// reports it: info = {blocks, blocks per SM, registers a thread,
// threads a block, dynamic shared memory bytes}. Returns a CUDA error code.
extern "C" int bgen_bf16_info(long long B, long long Cw, long long Cq, int *info) {
  cudaError_t err = cudaFuncSetAttribute(
      bgen_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes at;
  err = cudaFuncGetAttributes(&at, bgen_bf16_kernel);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bgen_bf16_kernel,
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
