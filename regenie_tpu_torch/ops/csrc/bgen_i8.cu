// BGEN 8-bit dosage products for Hopper (sm_90a): the two per-sample
// probability byte planes of a variant block against the int8 limb
// operands, exact integer sums, on the int8 tensor cores by warpgroup
// products (wgmma) with A decoded into registers and B read K-major from
// shared memory.
//
// Replaces the Pallas TPU kernel regenie_tpu/ops/fused_score.py:1093
// (_bgen_kernel_i8, launched by _bgen_products_i8 at :1171).
//
// What it computes, for planes [B, 2, Np] uint8 (k0 = P(hom first) * 255,
// k1 = P(het) * 255, missing = any pair with k0 + k1 > 255) and the
// K-major operand limbs Wp [Cw, Np] int8 and Wq [Cq, Np] int8 (samples
// contiguous: the transposes of the sample-packed [Np, C] limbs):
//   miss = k0 + k1 > 255;  k0, k1 = 0 where miss;  d2 = (2 k0 + k1)^2
//   D0 = k0 @ Wp^T,  D1 = k1 @ Wp^T,  M = miss @ Wp^T            [B, Cw]
//   Q0 = (d2 & 255) @ Wq^T,  Q1 = (d2 >> 8 & 255) @ Wq^T,
//   Q2 = (d2 >> 16) @ Wq^T                                       [B, Cq]
// all as exact int64. Rows past B, samples past Np and columns past
// Cw / Cq read as zero and are not stored.
//
// Bound at the repository's full width (B=2048, Np=400,128, Cw=1536,
// Cq=512): (3 x 1536 + 3 x 512) x 2 x 2048 x 400,128 = 1.007e13 int8
// operations per block, 5.088 ms at the H100's 1,979 dense int8 TOP/s,
// against 2.56 GB of compulsory traffic (planes 1.64 GB; 0.76 ms at
// 3.35 TB/s): bound by tensor-core operations. The design:
//
// - Tensor cores: wgmma.mma_async m64n128k32 u8 x s8 -> s32 (SASS
//   IGMMA.64x128x32) takes the unsigned bytes as they are (the TPU kernel
//   shifts them by -128 into s8 and adds 128 x column sums back). A
//   (the decoded multiplicands) comes from registers in the m64k32 8-bit
//   fragment layout: lane (g, t) of warp w of a warpgroup holds rows
//   16w + g and 16w + g + 8 at k positions 4t..4t+3 and 16+4t..16+4t+3.
//   B (the operand tile) is read from shared memory by a descriptor,
//   K-major with the 128-byte swizzle: int8 wgmma reads B only K-major
//   (the PTX ISA allows the transpose flags only for 16-bit types), which
//   is why the operand is stored [C, Np].
// - Work split: a 256-thread block is two warpgroups and owns a 128-row x
//   128-column output tile of either the three Wp products or the three
//   Wq products (the first ceil(Cw/128) column tiles are Wp's), looping
//   over the whole sample axis (no split-K): 256 blocks at full width,
//   one a SM, 1.94 waves. Each warpgroup owns 64 rows; a thread decodes
//   its A words once a k-step and issues three wgmma, one a product,
//   which share the B tile. So each decoded (row, sample) pair feeds 128
//   columns of each of three products.
// - Exactness: |u8 x s8| <= 255 x 128, so an int32 sum is exact over at
//   most 65,536 samples. Each 65,536-sample chunk starts with scale-d = 0;
//   the 3 x 64 int32 accumulators of a thread are read only at a chunk's
//   end, after wgmma.wait_group 0, and added into the int64 outputs that
//   the thread alone owns (a store for the first chunk): no atomics, and
//   the result does not depend on any order.
// - Stages: 128 samples (four k-steps) a stage; each stage holds the B
//   tile (128 columns x 128 bytes, each 16-byte chunk XOR-swizzled by its
//   row as the 128-byte swizzle wants, on a 1024-byte boundary) and the
//   planes k0, k1 of the block's 128 rows (rows padded to 144 bytes, so
//   the fragments' 4-byte loads fall on distinct banks). Four stages in a
//   ring (214,016 bytes with the alignment slack), filled by 16-byte
//   cp.async copies of the tiles exactly as they are stored (zero-filled
//   past Np, B and C); no transposes. Two stages are in flight beyond the
//   one in use: the slot of the stage just finished may still be read by
//   its last wgmma when the next stage's barrier passes, so the copy
//   issued after that barrier fills the slot of the stage before it.
// - Overlap: the wgmma are asynchronous, so a thread decodes the next
//   k-step while the last one's products run. The A registers are
//   double-buffered: a buffer is written again only after
//   wgmma.wait_group 1 has retired the group that read it. The next
//   stage's barrier falls inside the stage's last k-step, after its
//   products are issued.
// - Decode in registers: the missing mask of four samples at once from
//   the per-byte carry of k0 + k1 (carry = maj(k0, k1, s) at bit 7 of each
//   byte, s the sum of the low seven bits; prmt replicates it over the
//   byte); Wp tiles take k0 & ~m, k1 & ~m and m & 0x01010101; Wq tiles
//   form d = 2 k0 + k1 of two samples at a time in 16-bit lanes (byte
//   permutes and one three-way add; d <= 765, so no carry between lanes),
//   square each, and gather the bytes 0, 1, 2 of four squares into three
//   A words by byte permutes.
// ptxas: 250 registers, no spill; the SASS holds 24 IGMMA.64x128x32.U8.S8
// and no IMMA. A middle k-step is 45 instructions a thread in Wp tiles and
// 125 in Wq tiles, and a stage's copies about 75 more.
//
// What holds it back (NVIDIA H100 80GB HBM3, 700 W; PERF.md section 6):
// 11.6 ms against the 5.09 ms bound. The tensor cores alone, with the
// stage loop and its barrier, take 7.0 ms: 256 blocks are 2 waves of
// 3.3 ms blocks, where back-to-back wgmma of the same shape run a block's
// work in 2.7 ms. The A path (plane loads and decode) adds about 3.4 ms and
// the copies' instructions about 1.2 ms: while the tensor cores run, the
// SM's other instructions add to their time. Shared-memory A loads by
// ldmatrix, the copies spread over the k-steps, clamped rows in place of
// predicated copies, __vcmpgtu4 for the mask and Wq tiles scheduled first
// were each slower. TMA, mbarrier rings, clusters, persistent blocks and
// setmaxnreg warp specialisation are left for a later redesign.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;        // variant rows per block tile (64 a warpgroup)
constexpr int BN = 128;        // operand columns per block tile
constexpr int KS = 128;        // samples per stage (four k-steps of 32)
constexpr int AST = KS + 16;   // padded plane row stride (bytes)
constexpr int NSTAGE = 4;      // stages in the ring
constexpr int PREFETCH = 2;    // stages in flight beyond the one in use
constexpr int NTHREADS = 256;  // two warpgroups
constexpr int CHUNK_STAGES = 65536 / KS;  // stages per exact int32 sum
constexpr int ORS = NTHREADS / (KS / 16);  // operand rows copied at once
constexpr int PRS = NTHREADS / (KS / 16);  // plane rows copied at once

struct Stage {
  uint8_t w[BN][KS];    // K-major operand: column n, chunk c at c ^ (n & 7)
  uint8_t k0[BM][AST];  // plane k0 of the block's rows
  uint8_t k1[BM][AST];  // plane k1
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
__device__ __forceinline__ void fence_regs(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// Descriptor of a 128-column int8 B tile at shared address `saddr`
// (1024-byte aligned), K-major with the 128-byte swizzle: start address
// >> 4; the stride between 8-row groups along N (1024 bytes) as SBO; LBO
// is not used by a swizzled K-major layout (1); layout type 1 =
// SWIZZLE_128B. The k-step s of a stage starts 32 s bytes in (+2 s).
__device__ __forceinline__ uint64_t b_desc(const unsigned saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// D[64 x 128] (+)= A[64 x 32] B[32 x 128], u8 x s8 -> s32: A from
// registers (this warp's 16 rows in the m16n8k32 A layout), B by
// descriptor (K-major). scale_d: "1" adds to D, a predicate register
// operand chooses at run time.
#define WGMMA_D64(c)                                                         \
  c(d[0]), c(d[1]), c(d[2]), c(d[3]), c(d[4]), c(d[5]), c(d[6]), c(d[7]),    \
      c(d[8]), c(d[9]), c(d[10]), c(d[11]), c(d[12]), c(d[13]), c(d[14]),    \
      c(d[15]), c(d[16]), c(d[17]), c(d[18]), c(d[19]), c(d[20]), c(d[21]),  \
      c(d[22]), c(d[23]), c(d[24]), c(d[25]), c(d[26]), c(d[27]), c(d[28]),  \
      c(d[29]), c(d[30]), c(d[31]), c(d[32]), c(d[33]), c(d[34]), c(d[35]),  \
      c(d[36]), c(d[37]), c(d[38]), c(d[39]), c(d[40]), c(d[41]), c(d[42]),  \
      c(d[43]), c(d[44]), c(d[45]), c(d[46]), c(d[47]), c(d[48]), c(d[49]),  \
      c(d[50]), c(d[51]), c(d[52]), c(d[53]), c(d[54]), c(d[55]), c(d[56]),  \
      c(d[57]), c(d[58]), c(d[59]), c(d[60]), c(d[61]), c(d[62]), c(d[63])
#define WGMMA_M64N128K32(scale_d)                                              \
  "{\n.reg .pred p;\nsetp.ne.b32 p, " scale_d ", 0;\n"                         \
  "wgmma.mma_async.sync.aligned.m64n128k32.s32.u8.s8 "                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "   \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "    \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "     \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "     \
  "%58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p;\n}\n"
#define WGMMA_RW(x) "+r"(x)
__device__ __forceinline__ void wgmma_m64n128k32(int (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 const uint64_t desc) {
  asm volatile(WGMMA_M64N128K32("1")
               : WGMMA_D64(WGMMA_RW)
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc));
}
// the same with scale-d chosen at run time: sc = 0 starts D from A B,
// D's old value neither read nor kept
__device__ __forceinline__ void wgmma_m64n128k32_sc(int (&d)[64],
                                                    const uint32_t (&a)[4],
                                                    const uint64_t desc,
                                                    const int sc) {
  asm volatile(WGMMA_M64N128K32("%69")
               : WGMMA_D64(WGMMA_RW)
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
                 "r"(sc));
}

// byte permute in the generic mode: a selector nibble 8 + i replicates the
// top bit of byte i over the result byte
__device__ __forceinline__ uint32_t prmt(const uint32_t x, const uint32_t y,
                                         const uint32_t sel) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(r) : "r"(x), "r"(y), "r"(sel));
  return r;
}

// One (k0, k1) pair of 32-bit words (four samples of one row) -> the three
// A words of a block kind: k0, k1 and missing (Wp tiles), or the bytes 0,
// 1, 2 of d2 (Wq tiles). A missing pair reads as k0 = k1 = 0.
template <bool SQ>
__device__ __forceinline__ void decode(const uint32_t a, const uint32_t b,
                                       uint32_t (&x)[3]) {
  // carry out of each byte of k0 + k1: bit 7 of maj(a, b, s), s the sum of
  // the low seven bits of each byte (no carry between bytes)
  const uint32_t s = (a & 0x7F7F7F7Fu) + (b & 0x7F7F7F7Fu);
  const uint32_t m = prmt((a & b) | ((a | b) & s), 0, 0xBA98);  // 0xff: missing
  const uint32_t k0 = a & ~m, k1 = b & ~m;
  if (!SQ) {
    x[0] = k0;
    x[1] = k1;
    x[2] = m & 0x01010101u;
  } else {
    // d = 2 k0 + k1 of samples 0, 2 (de) and 1, 3 (dq) in 16-bit lanes
    const uint32_t e0 = prmt(k0, 0, 0x4240), e1 = prmt(k1, 0, 0x4240);
    const uint32_t o0 = prmt(k0, 0, 0x4341), o1 = prmt(k1, 0, 0x4341);
    const uint32_t de = e0 + e0 + e1, dq = o0 + o0 + o1;
    const uint32_t d0 = de & 0xFFFFu, d2 = de >> 16;
    const uint32_t d1 = dq & 0xFFFFu, d3 = dq >> 16;
    const uint32_t s0 = d0 * d0, s1 = d1 * d1, s2 = d2 * d2, s3 = d3 * d3;
    // bytes 0 and 1 of (s0, s1) and of (s2, s3), then bytes 2
    const uint32_t t0 = prmt(s0, s1, 0x5140), t1 = prmt(s2, s3, 0x5140);
    const uint32_t t2 = prmt(s0, s1, 0x7362), t3 = prmt(s2, s3, 0x7362);
    x[0] = prmt(t0, t1, 0x5410);
    x[1] = prmt(t0, t1, 0x7632);
    x[2] = prmt(t2, t3, 0x5410);
  }
}

// The A fragments of this thread for the k-step at sample kb of a stage:
// register h + 2 kk of product ty holds the samples kb + 16 kk + 4t ..
// + 3 of row arow + 8 h.
template <bool SQ>
__device__ __forceinline__ void decode_step(const Stage &s, const int arow,
                                            const int kb, const int t,
                                            uint32_t (&a)[3][4]) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const int off = kb + 16 * kk + 4 * t;
      uint32_t x[3];
      decode<SQ>(*reinterpret_cast<const uint32_t *>(&s.k0[arow + 8 * h][off]),
                 *reinterpret_cast<const uint32_t *>(&s.k1[arow + 8 * h][off]),
                 x);
#pragma unroll
      for (int ty = 0; ty < 3; ++ty) a[ty][h + 2 * kk] = x[ty];
    }
}

// A chunk's int32 sums into the int64 outputs O0, O1, O2 [B, C] at rows
// row0 and row0 + 8 and columns col0 + 8 c (+ 1): element 4 c + 2 h + i
// of acc is column col0 + 8 c + i of row row0 + 8 h. The first chunk
// stores, later ones add; each element is this thread's alone.
__device__ __forceinline__ void flush(int (&acc)[3][64], long long *const O0,
                                      long long *const O1, long long *const O2,
                                      const int row0, const int col0,
                                      const int B, const int C,
                                      const bool first) {
#pragma unroll
  for (int ty = 0; ty < 3; ++ty) {
    long long *const o = ty == 0 ? O0 : ty == 1 ? O1 : O2;
#pragma unroll
    for (int c = 0; c < BN / 8; ++c)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = col0 + 8 * c, row = row0 + 8 * h;
        if (col >= C || row >= B) continue;
        longlong2 *const p =
            reinterpret_cast<longlong2 *>(o + (long long)row * C + col);
        longlong2 v = make_longlong2(acc[ty][4 * c + 2 * h], acc[ty][4 * c + 2 * h + 1]);
        if (!first) {
          const longlong2 old = *p;
          v.x += old.x;
          v.y += old.y;
        }
        *p = v;
      }
  }
}

template <bool SQ>
__device__ __forceinline__ void tile(Stage *st, const uint8_t *__restrict__ planes,
                                     const int8_t *__restrict__ W,
                                     long long *__restrict__ O0,
                                     long long *__restrict__ O1,
                                     long long *__restrict__ O2, const int B,
                                     const int Np, const int C, const int j0) {
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.y * BM;
  // rows of this lane: warpgroup warp >> 2 owns 64, its warp warp & 3
  // supplies 16 of them
  const int arow = (warp >> 2) * 64 + (warp & 3) * 16 + g;

  // One stage: BN operand rows and 2 x BM plane rows of KS / 16 chunks
  // each; a thread copies chunk cv of the operand rows on + ORS i and of
  // the plane rows on + PRS h. The addresses that do not change from stage
  // to stage are computed once.
  const int on = tid >> 3, cv = tid & 7;
  const int8_t *const osrc = W + (long long)(j0 + on) * Np + 16 * cv;
  const unsigned odst = (unsigned)(on * KS + 16 * (cv ^ (on & 7)));
  const uint8_t *const psrc = planes + (long long)(r0 + on) * 2 * Np + 16 * cv;
  const unsigned pdst = (unsigned)(offsetof(Stage, k0) + on * AST + 16 * cv);
  const unsigned sbase = (unsigned)__cvta_generic_to_shared(st);
  // a copy whose predicate is false reads no bytes (its source size is
  // 0) and fills zeros, so its address need not be valid
  auto load = [&](const int slot, const int n0) {
    const unsigned sb = sbase + slot * (unsigned)sizeof(Stage);
    const bool nok = n0 + 16 * cv < Np;
#pragma unroll
    for (int i = 0; i < BN / ORS; ++i)
      cp16(sb + odst + ORS * KS * i, osrc + (long long)(ORS * i) * Np + n0,
           nok && j0 + on + ORS * i < C);
#pragma unroll
    for (int h = 0; h < BM / PRS; ++h)
#pragma unroll
      for (int pl = 0; pl < 2; ++pl)
        cp16(sb + pdst + (pl * BM + h * PRS) * AST,
             psrc + (long long)(2 * PRS * h + pl) * Np + n0,
             nok && r0 + on + PRS * h < B);
  };

  // the int32 sums of this thread since its chunk began; element 4 c + r
  // of a product is column 8 c + 2 t + (r & 1) of row arow + 8 (r >> 1)
  int acc[3][64];

  const int nk = (Np + KS - 1) / KS;
#pragma unroll
  for (int s = 0; s < PREFETCH; ++s) {
    if (s < nk) load(s, s * KS);
    cp_commit();
  }
  cp_wait<PREFETCH - 1>();
  fence_proxy_async();
  __syncthreads();

  // A buffers: a[0] for k-steps 0 and 2 of a stage, a[1] for 1 and 3
  uint32_t a[2][3][4];
  decode_step<SQ>(st[0], arow, 0, t, a[0]);
  for (int k = 0; k < nk; ++k) {
    const Stage &s = st[k % NSTAGE];
    const uint64_t desc = b_desc((unsigned)__cvta_generic_to_shared(&s.w[0][0]));
    // k-step 0 (decoded at the end of the last stage); a chunk's first
    // starts its sums from zero
    const int sc = k % CHUNK_STAGES != 0;
    wgmma_fence();
#pragma unroll
    for (int ty = 0; ty < 3; ++ty) wgmma_m64n128k32_sc(acc[ty], a[0][ty], desc, sc);
    wgmma_commit();
    // the slot of stage k - 2, whose every wgmma and decode finished
    // before this stage's barrier
    if (k + PREFETCH < nk) load((k + PREFETCH) % NSTAGE, (k + PREFETCH) * KS);
    cp_commit();
#pragma unroll
    for (int j = 1; j < KS / 32; ++j) {
      // the A buffer of k-step j - 2 is free once its group is done
      wgmma_wait<1>();
      decode_step<SQ>(s, arow, 32 * j, t, a[j & 1]);
      wgmma_fence();
#pragma unroll
      for (int ty = 0; ty < 3; ++ty)
        wgmma_m64n128k32(acc[ty], a[j & 1][ty], desc + 2 * j);
      wgmma_commit();
    }
    if ((k + 1) % CHUNK_STAGES == 0 || k + 1 == nk) {
      wgmma_wait<0>();
#pragma unroll
      for (int ty = 0; ty < 3; ++ty) fence_regs(acc[ty]);
      flush(acc, O0, O1, O2, r0 + arow, j0 + 2 * t, B, C, k < CHUNK_STAGES);
    }
    // the next stage's data, and its first decode while k-step 3 runs
    if (k + 1 < nk) {
      cp_wait<PREFETCH - 1>();
      fence_proxy_async();
      __syncthreads();
      wgmma_wait<1>();  // k-step 2's group is done: a[0] is free
      decode_step<SQ>(st[(k + 1) % NSTAGE], arow, 0, t, a[0]);
    }
  }
  cp_wait<0>();
}

__global__ void __launch_bounds__(NTHREADS, 1)
bgen_i8_kernel(const uint8_t *__restrict__ planes,
               const int8_t *__restrict__ Wp, const int8_t *__restrict__ Wq,
               long long *__restrict__ D0, long long *__restrict__ D1,
               long long *__restrict__ M, long long *__restrict__ Q0,
               long long *__restrict__ Q1, long long *__restrict__ Q2,
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
// (16-byte copies of the K-major operand rows) and Cw, Cq multiples of 16;
// the Python wrapper checks shapes, types, contiguity and alignment.
extern "C" int bgen_i8_launch(const void *planes, const void *Wp,
                              const void *Wq, void *D0, void *D1, void *M,
                              void *Q0, void *Q1, void *Q2, long long B,
                              long long Np, long long Cw, long long Cq,
                              void *stream) {
  cudaError_t err = cudaFuncSetAttribute(
      bgen_i8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  int ntp;
  const dim3 grid = grid_of(B, Cw, Cq, &ntp);
  bgen_i8_kernel<<<grid, NTHREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      static_cast<const uint8_t *>(planes), static_cast<const int8_t *>(Wp),
      static_cast<const int8_t *>(Wq), static_cast<long long *>(D0),
      static_cast<long long *>(D1), static_cast<long long *>(M),
      static_cast<long long *>(Q0), static_cast<long long *>(Q1),
      static_cast<long long *>(Q2), (int)B, (int)Np, (int)Cw, (int)Cq, ntp);
  return (int)cudaGetLastError();
}

// The launch's shape for B rows, Cw and Cq columns, as the CUDA runtime
// reports it: info = {blocks, blocks per SM, registers a thread,
// threads a block, dynamic shared memory bytes}. Returns a CUDA error code.
extern "C" int bgen_i8_info(long long B, long long Cw, long long Cq, int *info) {
  cudaError_t err = cudaFuncSetAttribute(
      bgen_i8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes at;
  err = cudaFuncGetAttributes(&at, bgen_i8_kernel);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bgen_i8_kernel,
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
