// Fused Step-2 products for Hopper (sm_90a) against the bf16 hi|mid|lo
// split operand: packed PLINK 2-bit genotype bytes times the bf16
// [4, nbp, Cw] operand (Cw = 3*Cp, each f32 value w = hi + mid + lo), on
// the bf16 tensor cores by warpgroup products (wgmma) with A decoded into
// registers, float32 partial sums added into float64.
//
// Replaces the Pallas TPU kernel regenie_tpu/ops/fused_score.py:364
// (_fused_kernel_split, launched by fused_products at :488), which the
// JAX package reaches through build_consts(split=True).
//
// What it computes, for raw [B, nbp] uint8 and wp [4, nbp, Cw] bf16:
//   H[b, j] = sum_p sum_c [code_p(raw[b, c]) == 0] * wp[p, c, j]
//   E[b, j] = the same sum with code == 2,  M[b, j] with code == 1
// as [B, Cw] float64, against each third separately; code_p(x) =
// (x >> 2p) & 3 (PLINK: 0 hom-alt, 1 missing, 2 het, 3 hom-ref). The
// caller folds the thirds (hi + mid + lo) and then S1 = 2H + E,
// SQ = 4H + E, SM = M. Bytes past nbp, rows past B and columns past Cw
// read as zero and are not stored; pad bytes decode to code 0 against
// zero operand rows.
//
// Precision: an indicator times a bf16 value is exact. The TPU kernel
// carries float32 sums over the whole contraction (400,384 terms at
// N = 400,000), which moves LOG10P past the repository's 1e-5 bar; and
// the tensor cores' float32 accumulation does not round to nearest, so a
// sum carried in the accumulators drifts with its length (1024-sample
// runs missed the bar on BGEN). Here the wgmma sums run from zero over
// one stage (128 terms: scale-d = 0 on a stage's first product; integer
// multiples of one bf16 value stay exact), the stage sums are added in
// float32 with round-to-nearest adds, and every FLUSH = 4096 terms that
// float32 sum is added into a float64 sum (H's and E's in shared memory,
// M's in the output in device memory; the first flush stores): one
// float32 sum of FLUSH terms rounds by at most about FLUSH x 2^-23 of its
// terms' magnitudes. Each output element has one owning thread: no
// atomics, no split-K, deterministic. The
// indicators are decoded as bf16 2.0, not 1.0 (one bit each), so every
// product and every sum is twice its value, exactly (a power of two
// scales the tensor cores' truncating sums bit for bit), and the flush
// takes half of the float32 sum, exactly.
//
// Bound at the repository's full width (B=2048, nbp=100,096, Cw=1152):
// 2 x 3 x 2048 x 400,384 x 1152 = 5.668e12 bf16 tensor-core operations
// per block, 5.73 ms at the H100's 989 dense TFLOP/s, against 1.18 GB of
// compulsory traffic (0.35 ms at 3.35 TB/s): bound by operations. The
// design:
//
// - Tensor cores: wgmma.mma_async m64n64k16 bf16 -> f32, A (the decoded
//   indicators) from registers, B (the operand tile) from shared memory
//   by descriptor. A 256-thread block is two warpgroups; it owns a
//   128-row x 64-column output tile of H, E and M and loops over the
//   whole contraction, no split-K: 288 blocks at full width, one a SM.
//   Each warpgroup owns 64 rows and decodes them once, so a decoded byte
//   feeds 3 x 64 columns; the three products share the B tile. A thread
//   holds 3 x 32 float32 accumulators and 3 x 32 float32 partial sums in
//   registers (254 of them, no spill) and 2 x 32 float64 sums in shared
//   memory.
// - Contraction order: a stage is 32 bytes x 4 planes = 128 terms, eight
//   k-steps in the order (16-byte group, plane). Byte q of a group goes
//   to operand row 2 (q >> 2) + (q & 1) + 8 ((q >> 1) & 1) of its plane's
//   16 rows, the k position where the A fragment holds it, so lane
//   (g, t) reads one 32-bit word (bytes 4t..4t+3) of each of its rows g
//   and g + 8 for a group, and two byte permutes spread it into the A
//   registers of all four planes' k-steps.
// - Decode in registers: for plane p, X = s << (14 - 2p) and Y = s <<
//   (13 - 2p) put the code's two bits of each spread byte at bit 14 of
//   its half, and one three-input logic op each makes the bf16 2.0
//   (0x4000) indicators of codes 0, 2 and 1: no conversion, no multiply
//   and no indicator tile in memory.
// - Overlap: the wgmma are asynchronous, so a warp decodes the next
//   k-step while the tensor cores run the last. The A registers are
//   double-buffered: a step's decode never writes registers that an
//   in-flight wgmma reads (wgmma.wait_group 1 before a buffer is written
//   again). During a stage's last step the warps wait for the next
//   stage's data and decode its first step; that step's three products
//   are committed one group each, so each product's sums are taken while
//   the next one runs. The tensor cores drain once a stage (the sums
//   need every wgmma of the stage done).
// - The operand keeps the JAX layout [p][c][j] (j contiguous): stages of
//   4 planes x 32 bytes x 64 columns (rows of 128 bytes) arrive by
//   16-byte cp.async copies (zero-filled past the edges) from all
//   threads, four stages in a ring, two loaded ahead, each 16-byte chunk
//   of a row XOR-swizzled by the row: the 128-byte swizzle of an MN-major
//   wgmma B operand (transpose-B), each stage on a 1024-byte boundary.
//   Raw rows are padded to 48 bytes, which keeps the lanes' word loads
//   free of bank conflicts.
// - The float64 sums: a flush of all three products into device memory
//   reads and writes 393 KB a SM every 32 stages while the tensor cores
//   wait (on the H100 it took about a sixth of the time), so the sums of
//   H and E stay in shared memory (131,072 bytes beside the four stages)
//   and only M's go to device memory; the kernel's end stores H and E.
// What holds it back: the wave tail (288 blocks on 132 SMs run in 3
// waves, the last 18% full) and the instructions on the SMs that run
// the wgmma (the float32 adds of part once a stage, the copies, the
// decode, M's flush), which on this card add to the tensor time rather
// than overlap it. Splitting the contraction for the tail, TMA with an
// mbarrier ring and persistent blocks are left for a later redesign.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;        // variant rows per block tile (64 a warpgroup)
constexpr int BN = 64;         // operand columns per block tile
constexpr int KC = 32;         // packed bytes per stage (4*KC contraction terms)
constexpr int RST = KC + 16;   // padded raw row stride (bytes)
constexpr int NSTAGE = 4;      // stages in the ring
constexpr int PREFETCH = NSTAGE - 2;  // stages loaded ahead of the one in use
constexpr int NTHREADS = 256;  // two warpgroups
constexpr int FLUSH = 4096;    // terms per float32 partial sum
constexpr int FLUSH_STAGES = FLUSH / (4 * KC);
constexpr int NSTEP = 4 * KC / 16;  // k-steps a stage
// the value of a decoded indicator's reciprocal: the flush scales by it
constexpr double UNIT = 0.5;

struct Stage {
  uint16_t w[4][KC][BN];  // plane p, operand row k, column chunk (j/8) ^ (k & 7)
  uint8_t raw[BM][RST];   // the block's rows, bytes [0, KC)
};
static_assert(sizeof(Stage) % 1024 == 0, "stages on 1024-byte boundaries");
static_assert(4 * KC * BN / 8 == 4 * NTHREADS && 2 * BM == NTHREADS,
              "one raw and four operand copies a thread a stage");
// the stages, the float64 sums of H and E (64 a thread), and room to
// align the first stage to 1024 bytes
constexpr int SMEM_BYTES = NSTAGE * (int)sizeof(Stage) + 64 * NTHREADS * 8 + 1024;

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

// The raw bytes of this warp's 16 rows for the 16-byte group at cb of a
// stage, spread to one byte a 16-bit half in the A register order: rows
// g (sp[0], sp[2]) and g + 8 (sp[1], sp[3]), bytes 4t, 4t + 1 (k 2t,
// 2t + 1: sp[0], sp[1]) and 4t + 2, 4t + 3 (k 2t + 8, 2t + 9).
__device__ __forceinline__ void load_spread(const Stage &s, const int arow,
                                            const int cb, const int t,
                                            uint32_t (&sp)[4]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint32_t x =
        *reinterpret_cast<const uint32_t *>(&s.raw[arow + 8 * h][cb + 4 * t]);
    sp[h] = __byte_perm(x, 0, 0x4140);
    sp[2 + h] = __byte_perm(x, 0, 0x4342);
  }
}

// The A fragments of plane p's k-step from the spread bytes: the bf16
// indicators of code 0 (a[0], H), code 2 (a[1], E) and code 1 (a[2], M),
// each 2.0 (0x4000) where it holds, built at bit 14 of each half.
__device__ __forceinline__ void decode(const uint32_t (&sp)[4], const int p,
                                       uint32_t (&a)[3][4]) {
  constexpr uint32_t ONE = 0x40004000u;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t x = sp[i] << (14 - 2 * p), y = sp[i] << (13 - 2 * p);
    a[0][i] = ~(x | y) & ONE;
    a[1][i] = y & ~x & ONE;
    a[2][i] = x & ~y & ONE;
  }
}

// UNIT x part into the float64 sums: products 0 and 1 (H, E) into this
// thread's sums in shared memory (element e of product ty at ssum[(32 ty +
// e) NTHREADS + tid]), product 2 (M) into the output O2 [B, Cw] in device
// memory at rows row0 and row0 + 8 and columns col0 + 8 c (+ 1), the old
// values loaded together. The first flush stores, later ones add; each
// sum is this thread's alone. part is zeroed.
__device__ __forceinline__ void flush(float (&part)[3][32], double *const ssum,
                                      double *const O2, const int row0,
                                      const int col0, const int B,
                                      const int Cw, const bool first) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int ty = 0; ty < 2; ++ty)
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      double &s = ssum[(ty * 32 + r) * NTHREADS + tid];
      s = (first ? 0.0 : s) + UNIT * (double)part[ty][r];
      part[ty][r] = 0.f;
    }
  double2 old[BN / 8][2];
#pragma unroll
  for (int c = 0; c < BN / 8; ++c)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = col0 + 8 * c, row = row0 + 8 * h;
      old[c][h] = make_double2(0.0, 0.0);
      if (!first && col < Cw && row < B)
        old[c][h] = *reinterpret_cast<const double2 *>(O2 + (long long)row * Cw + col);
    }
#pragma unroll
  for (int c = 0; c < BN / 8; ++c)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = col0 + 8 * c, row = row0 + 8 * h;
      if (col < Cw && row < B)
        *reinterpret_cast<double2 *>(O2 + (long long)row * Cw + col) =
            make_double2(old[c][h].x + UNIT * (double)part[2][4 * c + 2 * h],
                         old[c][h].y + UNIT * (double)part[2][4 * c + 2 * h + 1]);
      part[2][4 * c + 2 * h] = 0.f;
      part[2][4 * c + 2 * h + 1] = 0.f;
    }
}

__global__ void __launch_bounds__(NTHREADS, 1)
fused_bf16_kernel(const uint8_t *__restrict__ raw,
                  const uint16_t *__restrict__ wp, double *__restrict__ H,
                  double *__restrict__ E, double *__restrict__ M, const int B,
                  const int nbp, const int Cw) {
  extern __shared__ __align__(16) unsigned char smem[];
  // the swizzle reads address bits 7..9: align the ring to 1024 bytes
  const unsigned base = (unsigned)__cvta_generic_to_shared(smem);
  Stage *st = reinterpret_cast<Stage *>(smem + ((1024u - (base & 1023u)) & 1023u));
  double *const ssum = reinterpret_cast<double *>(st + NSTAGE);
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.y * BM, j0 = blockIdx.x * BN;
  // rows of this lane: warpgroup warp >> 2 owns 64, its warp warp & 3
  // supplies 16 of them
  const int arow = (warp >> 2) * 64 + (warp & 3) * 16 + g;

  // One stage: 4 x KC x BN/8 operand chunks, four a thread (plane i, byte
  // oc, chunk ov), and BM x KC/16 raw chunks, one a thread (row rrow,
  // half rh). Byte q of a 16-byte group goes to operand row 2 (q >> 2) +
  // (q & 1) + 8 ((q >> 1) & 1) of its plane. The addresses that do not
  // change from stage to stage are computed once.
  const int oc = tid >> 3, ov = tid & 7, oq = oc & 15;
  const int okr = (oc & ~15) | (2 * (oq >> 2) + (oq & 1) + 8 * ((oq >> 1) & 1));
  const bool ocol = j0 + 8 * ov < Cw;
  const long long oplane = (long long)nbp * Cw;
  const uint16_t *const osrc = wp + (long long)oc * Cw + j0 + 8 * ov;
  const unsigned odst = (unsigned)(okr * BN + 8 * (ov ^ (okr & 7))) * 2u;
  const int rrow = tid >> 1, rh = tid & 1;
  const bool rok = r0 + rrow < B;
  const uint8_t *const rsrc = raw + (long long)(r0 + rrow) * nbp + 16 * rh;
  const unsigned rdst = (unsigned)(offsetof(Stage, raw) + rrow * RST + 16 * rh);
  const unsigned sbase = (unsigned)__cvta_generic_to_shared(st);
  // a copy whose predicate is false reads no bytes (its source size is
  // 0) and fills zeros, so its address need not be valid
  auto load = [&](const int slot, const int c0) {
    const unsigned sb = sbase + slot * (unsigned)sizeof(Stage);
    const uint16_t *const o = osrc + (long long)c0 * Cw;
    const bool cok = ocol && c0 + oc < nbp;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      cp16(sb + odst + i * KC * BN * 2, o + i * oplane, cok);
    cp16(sb + rdst, rsrc + c0, rok && c0 + 16 * rh < nbp);
  };

  // acc: the wgmma sums of one stage, from zero; part: their float32 sum
  // (round-to-nearest adds) since the last flush. Element 4 c + r of
  // either is column 8 c + 2 t + (r & 1) of row arow + 8 (r >> 1).
  float acc[3][32], part[3][32];
#pragma unroll
  for (int ty = 0; ty < 3; ++ty)
#pragma unroll
    for (int r = 0; r < 32; ++r) part[ty][r] = 0.f;
  const int row0 = r0 + arow, col0 = j0 + 2 * t;

  const int nk = (nbp + KC - 1) / KC;
#pragma unroll
  for (int s = 0; s < PREFETCH; ++s) {
    if (s < nk) load(s, s * KC);
    cp_commit();
  }
  cp_wait<PREFETCH - 1>();
  fence_proxy_async();
  __syncthreads();

  // A buffers: a[0] for the even steps of a stage, a[1] for the odd ones;
  // a buffer is written again only after the wgmma group that read it is
  // done. sp: the spread bytes of the current 16-byte group.
  uint32_t a[2][3][4], sp[4];
  load_spread(st[0], arow, 0, t, sp);
  decode(sp, 0, a[0]);
  for (int k = 0; k < nk; ++k) {
    const Stage &s = st[k % NSTAGE];
    // step (group hb, plane p) reads operand rows [p][16 hb, 16 hb + 16):
    // 4096 bytes = 256 descriptor units a plane, 2048 = 128 a group
    const uint64_t desc = b_desc((unsigned)__cvta_generic_to_shared(&s.w[0][0][0]));
    // step 0 (decoded at the end of the last stage), from zero
    wgmma_fence();
#pragma unroll
    for (int ty = 0; ty < 3; ++ty) wgmma_m64n64k16_first(acc[ty], a[0][ty], desc);
    wgmma_commit();
    // the slot of stage k - 2, which every warp finished before the
    // barrier of the last stage
    if (k + PREFETCH < nk) load((k + PREFETCH) % NSTAGE, (k + PREFETCH) * KC);
    cp_commit();
#pragma unroll
    for (int j = 1; j < NSTEP; ++j) {
      const int hb = j >> 2, p = j & 3;
      // the A buffer of step j - 2 is free once its group is done
      if (j >= 2) wgmma_wait<1>();
      if (p == 0) load_spread(s, arow, 16 * hb, t, sp);
      decode(sp, p, a[j & 1]);
      wgmma_fence();
#pragma unroll
      for (int ty = 0; ty < 3; ++ty) {
        wgmma_m64n64k16(acc[ty], a[j & 1][ty], desc + 256 * p + 128 * hb);
        // the last step: one group a product, so that its sums can be
        // taken while the next one runs
        if (j == NSTEP - 1) wgmma_commit();
      }
      if (j < NSTEP - 1) wgmma_commit();
    }
    // the next stage's data, and its first decode while the last step runs
    if (k + 1 < nk) {
      cp_wait<PREFETCH - 1>();
      fence_proxy_async();
      __syncthreads();
      wgmma_wait<3>();  // step NSTEP - 2's group is done: a[0] is free
      load_spread(st[(k + 1) % NSTAGE], arow, 0, t, sp);
      decode(sp, 0, a[0]);
    }
    sum_into<2>(part[0], acc[0]);
    sum_into<1>(part[1], acc[1]);
    sum_into<0>(part[2], acc[2]);
    if ((k + 1) % FLUSH_STAGES == 0 || k + 1 == nk)
      flush(part, ssum, M, row0, col0, B, Cw, k < FLUSH_STAGES);
  }
  // no bytes: the products are zero
  if (nk == 0) flush(part, ssum, M, row0, col0, B, Cw, true);
  cp_wait<0>();
  // the sums of H and E into device memory
#pragma unroll
  for (int ty = 0; ty < 2; ++ty)
#pragma unroll
    for (int c = 0; c < BN / 8; ++c)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = col0 + 8 * c, row = row0 + 8 * h;
        const double *const e = ssum + (ty * 32 + 4 * c + 2 * h) * NTHREADS + tid;
        if (col < Cw && row < B)
          *reinterpret_cast<double2 *>((ty == 0 ? H : E) + (long long)row * Cw + col) =
              make_double2(e[0], e[NTHREADS]);
      }
}

dim3 grid_of(const long long B, const long long Cw) {
  return dim3((unsigned)((Cw + BN - 1) / BN), (unsigned)((B + BM - 1) / BM));
}

}  // namespace

// Plain C entry point (loaded with ctypes). Launches on `stream`, does not
// synchronise and allocates nothing; returns cudaGetLastError() (or the
// error of the shared-memory attribute call). Requires nbp % 16 == 0 and
// Cw % 8 == 0 (16-byte copies); the Python wrapper checks shapes, types,
// contiguity and alignment.
extern "C" int fused_bf16_launch(const void *raw, const void *wp, void *H,
                                 void *E, void *M, long long B, long long nbp,
                                 long long Cw, void *stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fused_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  fused_bf16_kernel<<<grid_of(B, Cw), NTHREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      static_cast<const uint8_t *>(raw), static_cast<const uint16_t *>(wp),
      static_cast<double *>(H), static_cast<double *>(E),
      static_cast<double *>(M), (int)B, (int)nbp, (int)Cw);
  return (int)cudaGetLastError();
}

// The launch's shape for B rows and Cw columns, as the CUDA runtime
// reports it: info = {blocks, blocks per SM, registers a thread, threads
// a block, dynamic shared memory bytes}. Returns a CUDA error code.
extern "C" int fused_bf16_info(long long B, long long Cw, int *info) {
  cudaError_t err = cudaFuncSetAttribute(
      fused_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes at;
  err = cudaFuncGetAttributes(&at, fused_bf16_kernel);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_bf16_kernel,
                                                      NTHREADS, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid = grid_of(B, Cw);
  info[0] = (int)(grid.x * grid.y);
  info[1] = per_sm;
  info[2] = at.numRegs;
  info[3] = NTHREADS;
  info[4] = SMEM_BYTES;
  return 0;
}
