// Fused int8 Step-2 products for Hopper (sm_90a): packed PLINK 2-bit
// genotype bytes against the int8 limb operand, exact int32 sums, on the
// int8 tensor cores by warpgroup products (wgmma) with A decoded into
// registers and B read K-major from shared memory.
//
// Replaces the Pallas TPU kernel regenie_tpu/ops/fused_score.py:403
// (_fused_kernel_i8, launched by _i8_products at :444).
//
// What it computes, for raw [B, nbp] uint8 and the K-major operand
// limbs_k [Cw4, 4*nbp] int8 (Cw4 = 4*Cp, the [l0|l1|l2|l3] limb layout;
// column k = p*nbp + c holds plane p of byte c: the transpose of the
// plane-packed limbs [4, nbp, Cw4] read as [4*nbp, Cw4]):
//   H[b, j] = sum_p sum_c [code_p(raw[b, c]) == 0] * limbs_k[j, p*nbp + c]
//   E[b, j] = the same sum with code == 2,  M[b, j] with code == 1
// where code_p(x) = (x >> 2p) & 3 (PLINK: 0 hom-alt, 1 missing, 2 het,
// 3 hom-ref). Pad bytes decode to code 0; the operand there is zero, and
// bytes past nbp / rows past B / columns past Cw4 are read as zero here,
// so the kernel relies on nothing else.
//
// Bound at the repository's full width (B=2048, N=400,000 -> nbp=100,096,
// Cw4=1536): 3 x 2 x 2048 x 400,384 x 1536 = 7.557e12 int8 operations per
// block, 3.819 ms at the H100's 1,979 dense int8 TOP/s, against 0.858 GB
// of compulsory traffic (0.256 ms at 3.35 TB/s): bound by tensor-core
// operations. The design:
//
// - Tensor cores: wgmma.mma_async m64n128k32 u8 x s8 -> s32 (SASS
//   IGMMA.64x128x32). A (the 0/1 class indicators) comes from registers in
//   the m64k32 8-bit fragment layout: lane (g, t) of warp w of a
//   warpgroup holds rows 16w + g and 16w + g + 8 at k positions 4t..4t+3
//   and 16+4t..16+4t+3. B (the operand tile) is read from shared memory
//   by a descriptor, K-major with the 128-byte swizzle: int8 wgmma reads
//   B only K-major, which is why the operand has the copy limbs_k.
// - Contraction order: a stage is 32 raw bytes c0..c0+31, which is 128
//   contraction terms in four k-steps of 32; k-step s is plane s of those
//   bytes. The B tile row of column n is limbs_k[n, s*nbp + c0 .. + 32]
//   for s = 0..3 (8 chunks of 16 bytes). One 32-bit word of raw bytes
//   (bytes 4t..4t+3 of a row) gives, for plane s, exactly one A register
//   of each product: lane i = bit 8i of the word's plane-s code masks, 2
//   shifts and 3 three-input logic ops (decode<s>). So a thread's 4 raw
//   words of a stage (rows g and g+8, bytes 4t and 16+4t) feed all four
//   k-steps, and nothing is transposed.
// - Work split: a 256-thread block is two warpgroups and owns a 128-row x
//   128-column output tile of H, E and M over one of NSPLIT = 2 parts of
//   the contraction (the first ceil(stages / 2) stages, or the rest).
//   Each warpgroup owns 64 rows; a thread decodes its 4 words once a
//   k-step into 12 A registers and issues three wgmma, one a product,
//   which share the B tile: each decoded (row, byte) pair feeds 128
//   columns of each product. At full width the grid is 16 row tiles x
//   12 column tiles x 2 halves = 384 blocks, one a SM, 2.91 waves.
//   Blocks are numbered row tile fastest, then column tile, then half,
//   so the 132 blocks that run at once share column tiles of the operand
//   (16 row tiles each) and halves of the raw bytes.
// - Exactness: |sum| <= 128 x 4*nbp < 2^31 for N < 8,000,000 (the
//   wrapper's guard), so each block's 3 x 64 int32 accumulators a thread
//   start with scale-d = 0 and need no chunking. After wgmma.wait_group
//   0 a thread adds them into the outputs with red.global.add.s32; the
//   wrapper zero-fills the outputs. Integer addition makes the result
//   exact and independent of the order of the two halves.
// - Stages: each stage holds the B tile (128 columns x 128 bytes, each
//   16-byte chunk XOR-swizzled by its row as the 128-byte swizzle wants,
//   on a 1024-byte boundary) and the block's 128 raw rows of 32 bytes,
//   padded to a 48-byte stride so the fragment's 4-byte loads from rows
//   g..g+7 at bytes 4t and 16+4t fall on distinct banks: 22,528 bytes.
//   Four stages in a ring (91,136 bytes with the alignment slack; rings
//   of six and eight were no faster in turns), filled by 16-byte cp.async
//   copies of the tiles as they are stored (zero-filled past nbp, B and
//   Cw4): 5 a thread a stage. Two stages are in flight beyond the one in
//   use: the slot of the stage just finished may still be read by its
//   last wgmma when the next stage's barrier passes, so the copy issued
//   after that barrier fills the slot of the stage before it.
// - Overlap: the wgmma are asynchronous, so a thread decodes the next
//   k-step while the last one's products run. The A registers are
//   double-buffered: a buffer is written again only after
//   wgmma.wait_group 1 has retired the group that read it. The next
//   stage's barrier falls inside the stage's last k-step, after its
//   products are issued.
// ptxas: 252 registers, no spill; the SASS holds 12 IGMMA.64x128x32.U8.S8
// and no IMMA. A middle k-step is 27 instructions a thread (12 LOP3, 8
// SHF, 3 IGMMA, 2 WARPGROUP, 2 UIADD3), a whole stage 164 with its 5
// LDGSTS, 4 LDS and the barrier.
//
// What holds it back (NVIDIA H100 80GB HBM3, 700 W; PERF.md section 6):
// 4.25-4.48 ms against the 3.82 ms bound (85-90%). The kernel alone runs
// 4.17-4.25 ms: 3 waves of ~1.40 ms blocks, where a block's wgmma at one
// SM's share of the peak take 1.31 ms. The third wave is 91% full (3% of
// the bound); the decode, the copies and the per-stage barrier cost
// about 6% more; the wrapper's zero fill adds 0.05-0.08 ms and the
// reductions about 0.03 ms. Without the split (192 blocks, 1.45 waves)
// it took 5.53-5.71 ms. TMA, mbarrier rings, clusters, persistent blocks
// and setmaxnreg warp specialisation are left for a later redesign.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;        // variant rows per block tile (64 a warpgroup)
constexpr int BN = 128;        // operand columns per block tile
constexpr int KB = 32;         // raw bytes per stage (one k-step a plane)
constexpr int KS = 4 * KB;     // contraction terms per stage
constexpr int RST = KB + 16;   // padded raw row stride (bytes)
constexpr int NSTAGE = 4;      // stages in the ring
constexpr int PREFETCH = 2;    // stages in flight beyond the one in use
constexpr int NSPLIT = 2;      // parts of the contraction (grid z)
constexpr int NTHREADS = 256;  // two warpgroups
constexpr int ORS = NTHREADS / (KS / 16);  // operand rows copied at once

struct Stage {
  uint8_t w[BN][KS];     // K-major operand: column n, chunk q at q ^ (n & 7)
  uint8_t raw[BM][RST];  // raw bytes of the block's rows
};
static_assert(sizeof(Stage) % 1024 == 0, "stages on 1024-byte boundaries");
static_assert(BM * (KB / 16) == NTHREADS, "one raw copy a thread a stage");
static_assert(NSTAGE == PREFETCH + 2, "a copy refills the slot of stage k - 2");
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

// Plane S of this thread's four raw words -> the A registers of the
// three products: a[ty][i] from word i, lanes 0/1 (hom-alt, het, missing
// of the word's four bytes).
template <int S>
__device__ __forceinline__ void decode(const uint32_t (&rw)[4],
                                       uint32_t (&a)[3][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t lo = rw[i] >> (2 * S);
    const uint32_t hi = rw[i] >> (2 * S + 1);
    a[0][i] = ~(lo | hi) & 0x01010101u;  // code 0
    a[1][i] = hi & ~lo & 0x01010101u;    // code 2
    a[2][i] = lo & ~hi & 0x01010101u;    // code 1
  }
}

// This thread's raw words of a stage: word h + 2 kk holds bytes
// 16 kk + 4t .. + 3 of row arow + 8 h, so that plane s of it is A
// register h + 2 kk of k-step s.
__device__ __forceinline__ void raw_words(const Stage &s, const int arow,
                                          const int t, uint32_t (&rw)[4]) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
      rw[h + 2 * kk] =
          *reinterpret_cast<const uint32_t *>(&s.raw[arow + 8 * h][16 * kk + 4 * t]);
}

// One k-step (plane S) of a stage after the first: wait for the group
// that last read this A buffer, decode into it, issue the three products.
template <int S>
__device__ __forceinline__ void kstep(int (&acc)[3][64], uint32_t (&a)[3][4],
                                      const uint32_t (&rw)[4],
                                      const uint64_t desc) {
  wgmma_wait<1>();
  decode<S>(rw, a);
  wgmma_fence();
#pragma unroll
  for (int ty = 0; ty < 3; ++ty) wgmma_m64n128k32(acc[ty], a[ty], desc + 2 * S);
  wgmma_commit();
}

__device__ __forceinline__ void red_add(int32_t *p, const int v) {
  asm volatile("red.global.add.s32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

__global__ void __launch_bounds__(NTHREADS, 1)
fused_i8_kernel(const uint8_t *__restrict__ raw,
                const int8_t *__restrict__ Wk, int32_t *__restrict__ H,
                int32_t *__restrict__ E, int32_t *__restrict__ M,
                const int B, const int nbp, const int Cw4) {
  // this block's stages [ks, ks + nk) of the contraction
  const int nst = (nbp + KB - 1) / KB;
  const int per = (nst + NSPLIT - 1) / NSPLIT;
  const int ks = (int)blockIdx.z * per;
  const int nk = min(nst, ks + per) - ks;
  if (nk <= 0) return;

  extern __shared__ __align__(16) unsigned char smem[];
  // the swizzle reads address bits 7..9: align the ring to 1024 bytes
  const unsigned base = (unsigned)__cvta_generic_to_shared(smem);
  Stage *st = reinterpret_cast<Stage *>(smem + ((1024u - (base & 1023u)) & 1023u));

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.x * BM, j0 = blockIdx.y * BN;
  // rows of this lane: warpgroup warp >> 2 owns 64, its warp warp & 3
  // supplies 16 of them
  const int arow = (warp >> 2) * 64 + (warp & 3) * 16 + g;

  // One stage: BN operand rows of KS / 16 chunks (chunk cv is plane
  // cv >> 1, bytes 16 (cv & 1) of the stage) and BM raw rows of two; a
  // thread copies chunk cv of the operand rows on + ORS i and half rh of
  // raw row rr. The addresses that do not change from stage to stage are
  // computed once.
  const long long K4 = 4LL * nbp;
  const int on = tid >> 3, cv = tid & 7;
  const int8_t *const osrc =
      Wk + (long long)(j0 + on) * K4 + (long long)(cv >> 1) * nbp + 16 * (cv & 1);
  const unsigned odst = (unsigned)(on * KS + 16 * (cv ^ (on & 7)));
  const int rr = tid >> 1, rh = tid & 1;
  const uint8_t *const rsrc = raw + (long long)(r0 + rr) * nbp + 16 * rh;
  const unsigned rdst = (unsigned)(offsetof(Stage, raw) + rr * RST + 16 * rh);
  const bool rok = r0 + rr < B;
  const unsigned sbase = (unsigned)__cvta_generic_to_shared(st);
  // a copy whose predicate is false reads no bytes (its source size is
  // 0) and fills zeros, so its address need not be valid
  auto load = [&](const int slot, const int c0) {
    const unsigned sb = sbase + slot * (unsigned)sizeof(Stage);
    const bool ook = c0 + 16 * (cv & 1) < nbp;
#pragma unroll
    for (int i = 0; i < BN / ORS; ++i)
      cp16(sb + odst + ORS * KS * i, osrc + (long long)(ORS * i) * K4 + c0,
           ook && j0 + on + ORS * i < Cw4);
    cp16(sb + rdst, rsrc + c0, rok && c0 + 16 * rh < nbp);
  };

  // the int32 sums of this thread; element 4 c + r of a product is column
  // 8 c + 2 t + (r & 1) of row arow + 8 (r >> 1)
  int acc[3][64];

#pragma unroll
  for (int s = 0; s < PREFETCH; ++s) {
    if (s < nk) load(s, (ks + s) * KB);
    cp_commit();
  }
  cp_wait<PREFETCH - 1>();
  fence_proxy_async();
  __syncthreads();

  // A buffers: a[0] for k-steps 0 and 2 of a stage, a[1] for 1 and 3
  uint32_t a[2][3][4];
  uint32_t rw[4];
  raw_words(st[0], arow, t, rw);
  decode<0>(rw, a[0]);
  for (int k = 0; k < nk; ++k) {
    const Stage &s = st[k % NSTAGE];
    const uint64_t desc = b_desc((unsigned)__cvta_generic_to_shared(&s.w[0][0]));
    // k-step 0 (decoded at the end of the last stage); the first starts
    // the sums from zero
    wgmma_fence();
#pragma unroll
    for (int ty = 0; ty < 3; ++ty) wgmma_m64n128k32_sc(acc[ty], a[0][ty], desc, k);
    wgmma_commit();
    // the slot of stage k - 2, whose every wgmma and decode finished
    // before this stage's barrier (NSTAGE = PREFETCH + 2)
    if (k + PREFETCH < nk) load((k + PREFETCH) % NSTAGE, (ks + k + PREFETCH) * KB);
    cp_commit();
    kstep<1>(acc, a[1], rw, desc);
    kstep<2>(acc, a[0], rw, desc);
    kstep<3>(acc, a[1], rw, desc);
    // the next stage's data, and its first decode while k-step 3 runs
    if (k + 1 < nk) {
      cp_wait<PREFETCH - 1>();
      fence_proxy_async();
      __syncthreads();
      wgmma_wait<1>();  // k-step 2's group is done: a[0] is free
      raw_words(st[(k + 1) % NSTAGE], arow, t, rw);
      decode<0>(rw, a[0]);
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int ty = 0; ty < 3; ++ty) fence_regs(acc[ty]);
  cp_wait<0>();

  // this part's sums into the zero-filled outputs
  const int row0 = r0 + arow, col0 = j0 + 2 * t;
#pragma unroll
  for (int ty = 0; ty < 3; ++ty) {
    int32_t *const o = ty == 0 ? H : ty == 1 ? E : M;
#pragma unroll
    for (int c = 0; c < BN / 8; ++c)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = col0 + 8 * c, row = row0 + 8 * h;
        if (col >= Cw4 || row >= B) continue;
        int32_t *const p = o + (long long)row * Cw4 + col;
        red_add(p, acc[ty][4 * c + 2 * h]);
        red_add(p + 1, acc[ty][4 * c + 2 * h + 1]);
      }
  }
}

dim3 grid_of(const long long B, const long long Cw4) {
  return dim3((unsigned)((B + BM - 1) / BM), (unsigned)((Cw4 + BN - 1) / BN),
              NSPLIT);
}

}  // namespace

// Plain C entry point (loaded with ctypes). Launches on `stream`, does not
// synchronise and allocates nothing; adds into H, E, M, which the caller
// zero-fills; returns cudaGetLastError() (or the error of the
// shared-memory attribute call). Requires nbp % 16 == 0 (16-byte copies
// of the K-major operand rows) and Cw4 % 16 == 0; the Python wrapper
// checks shapes, types, contiguity and alignment.
extern "C" int fused_i8_launch(const void *raw, const void *limbs_k, void *H,
                               void *E, void *M, long long B, long long nbp,
                               long long Cw4, void *stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fused_i8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  fused_i8_kernel<<<grid_of(B, Cw4), NTHREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      static_cast<const uint8_t *>(raw), static_cast<const int8_t *>(limbs_k),
      static_cast<int32_t *>(H), static_cast<int32_t *>(E),
      static_cast<int32_t *>(M), (int)B, (int)nbp, (int)Cw4);
  return (int)cudaGetLastError();
}

// The launch's shape for B rows and Cw4 columns, as the CUDA runtime
// reports it: info = {blocks, blocks per SM, registers a thread, threads a
// block, dynamic shared memory bytes}. Returns a CUDA error code.
extern "C" int fused_i8_info(long long B, long long Cw4, int *info) {
  cudaError_t err = cudaFuncSetAttribute(
      fused_i8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes at;
  err = cudaFuncGetAttributes(&at, fused_i8_kernel);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_i8_kernel,
                                                      NTHREADS, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid = grid_of(B, Cw4);
  info[0] = (int)(grid.x * grid.y * grid.z);
  info[1] = per_sm;
  info[2] = at.numRegs;
  info[3] = NTHREADS;
  info[4] = SMEM_BYTES;
  return 0;
}
