// Fused Step-2 products for Hopper (sm_90a) against the bf16 hi|mid|lo
// split operand: packed PLINK 2-bit genotype bytes times the bf16
// [4, nbp, Cw] operand (Cw = 3*Cp, each f32 value w = hi + mid + lo), on
// the bf16 tensor cores, float32 partial sums added into float64.
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
// read as zero; pad bytes decode to code 0 against zero operand rows.
//
// Precision: an indicator times a bf16 value is exact. The TPU kernel
// carries float32 sums over the whole contraction (400,384 terms at
// N = 400,000), which moves LOG10P past the repository's 1e-5 bar; and
// the tensor cores' float32 accumulation does not round to nearest, so a
// sum carried in the mma accumulators drifts with its length (1024-sample
// runs missed the bar on BGEN). Here the mma sums run from zero over one
// stage (128 terms; integer multiples of one bf16 value stay exact), the
// stage sums are added in float32 with round-to-nearest adds, and every
// FLUSH = 4096 terms that float32 sum is added into a float64 sum the
// thread owns in shared memory. One float32 sum of FLUSH terms rounds by
// at most about FLUSH x 2^-23 of its terms' magnitudes (far less in
// practice), the float64 additions by nothing of note. Deterministic: no
// atomics, no split-K.
//
// Bound at the repository's full width (B=2048, nbp=100,096, Cw=1152):
// 2 x 3 x 2048 x 400,384 x 1152 = 5.668e12 bf16 tensor-core operations
// per block, 5.73 ms at the H100's 989 dense TFLOP/s, against 1.18 GB of
// compulsory traffic (0.35 ms at 3.35 TB/s): bound by operations. The
// design is the simple one that is right; wgmma, TMA and warp
// specialisation are left for a later redesign:
//
// - Tensor cores: mma.sync.m16n8k16 bf16 -> f32. A 256-thread block owns
//   a 64-row x 64-column output tile of H, E and M and loops over the
//   whole contraction; each warp holds a 16 x 32 tile of the three
//   products (48 mma and 48 float32 accumulators a thread, 48 float64
//   sums in shared memory).
// - Contraction order: a k-step of 16 is one plane p of 16 consecutive
//   bytes, so lane (g, t) needs bytes 2t, 2t+1 and 2t+8, 2t+9 of its rows
//   g and g+8; the four 16-bit byte pairs it loads per half-stage feed
//   the k-steps of all four planes.
// - Decode in registers: the indicators are made as bf16 bit patterns
//   (0x3F80 for 1.0) with integer operations on the spread byte pair: no
//   conversion instruction and no indicator tile in memory.
// - The operand keeps the JAX layout [p][c][j] (j contiguous): stages of
//   32 bytes x 4 planes x 64 columns arrive by 16-byte cp.async copies
//   (zero-filled past the edges), three in flight, each 16-byte chunk of
//   a row XOR-swizzled by the row, and ldmatrix.trans turns them into B
//   fragments free of bank conflicts.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;         // variant rows per block tile
constexpr int BN = 64;         // operand columns per block tile
constexpr int KC = 32;         // packed bytes per stage (4*KC contraction terms)
constexpr int RST = KC + 16;   // padded raw row stride (bytes)
constexpr int NSTAGE = 3;      // stages in flight
constexpr int NTHREADS = 256;  // 8 warps: 4 (rows) x 2 (columns)
constexpr int FLUSH = 4096;    // terms per float32 partial sum
constexpr int FLUSH_STAGES = FLUSH / (4 * KC);

struct __align__(16) Stage {
  uint16_t w[4][KC][BN];  // plane p, byte c, column chunk (j/8) ^ (c & 7)
  uint8_t raw[BM][RST];   // the block's rows, bytes [0, KC)
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

// a 16-bit byte pair -> byte 0 in bits 0-7, byte 1 in bits 16-23
__device__ __forceinline__ uint32_t spread(const uint32_t x) {
  return (x | (x << 8)) & 0x00FF00FFu;
}

__global__ void __launch_bounds__(NTHREADS, 1)
fused_bf16_kernel(const uint8_t *__restrict__ raw,
                  const uint16_t *__restrict__ wp, double *__restrict__ H,
                  double *__restrict__ E, double *__restrict__ M, const int B,
                  const int nbp, const int Cw) {
  extern __shared__ __align__(16) unsigned char smem[];
  Stage *st = reinterpret_cast<Stage *>(smem);
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;
  const int r0 = blockIdx.y * BM, j0 = blockIdx.x * BN;

  // one stage: 4 x KC x BN/8 operand chunks (4 a thread), BM x KC/16 raw
  // chunks (threads 0..127)
  auto load = [&](Stage &s, const int c0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + NTHREADS * i;
      const int p = idx >> 8, c = (idx >> 3) & (KC - 1), v = idx & 7;
      const bool ok = (c0 + c < nbp) && (j0 + 8 * v < Cw);
      const uint16_t *src =
          ok ? wp + ((long long)p * nbp + c0 + c) * Cw + j0 + 8 * v : wp;
      cp16(&s.w[p][c][8 * (v ^ (c & 7))], src, ok);
    }
    if (tid < 2 * BM) {
      const int row = tid >> 1, half = tid & 1;
      const bool ok = (r0 + row < B) && (c0 + 16 * half < nbp);
      const uint8_t *src =
          ok ? raw + (long long)(r0 + row) * nbp + c0 + 16 * half : raw;
      cp16(&s.raw[row][16 * half], src, ok);
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

  const int nk = (nbp + KC - 1) / KC;
#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s) {
    if (s < nk) load(st[s], s * KC);
    cp_commit();
  }

  // ldmatrix row of this lane: matrix mi = lane / 8 covers k rows
  // 8 * (mi & 1) .. +7 and column chunk (mi >> 1) of a 16-column pair
  const int lm_k = 8 * ((lane >> 3) & 1) + (lane & 7);
  const int lm_chunk = wn * 4 + (lane >> 4);
  const int arow = wm * 16 + g;

  for (int k = 0; k < nk; ++k) {
    cp_wait<NSTAGE - 2>();
    __syncthreads();
    if (k + NSTAGE - 1 < nk) load(st[(k + NSTAGE - 1) % NSTAGE], (k + NSTAGE - 1) * KC);
    cp_commit();
    const Stage &s = st[k % NSTAGE];
#pragma unroll
    for (int ty = 0; ty < 3; ++ty)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[ty][nt][r] = 0.f;

#pragma unroll
    for (int hb = 0; hb < 2; ++hb) {
      const int cb = 16 * hb;
      // byte pairs (2t, 2t+1) and (2t+8, 2t+9) of rows g and g+8: the A
      // registers 0..3 of every plane's k-step
      uint32_t sp[4];
      sp[0] = spread(*reinterpret_cast<const uint16_t *>(&s.raw[arow][cb + 2 * t]));
      sp[1] = spread(*reinterpret_cast<const uint16_t *>(&s.raw[arow + 8][cb + 2 * t]));
      sp[2] = spread(*reinterpret_cast<const uint16_t *>(&s.raw[arow][cb + 2 * t + 8]));
      sp[3] = spread(*reinterpret_cast<const uint16_t *>(&s.raw[arow + 8][cb + 2 * t + 8]));
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        uint32_t bf[2][4];
        const int kr = cb + lm_k;
#pragma unroll
        for (int pr = 0; pr < 2; ++pr)
          ldsm_x4_t(bf[pr], &s.w[p][kr][8 * ((lm_chunk + 2 * pr) ^ (kr & 7))]);
        uint32_t a[3][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint32_t lo = (sp[i] >> (2 * p)) & 0x00010001u;
          const uint32_t hi = (sp[i] >> (2 * p + 1)) & 0x00010001u;
          a[0][i] = ((lo | hi) ^ 0x00010001u) * 0x3F80u;  // code 0
          a[1][i] = (hi & ~lo) * 0x3F80u;                 // code 2
          a[2][i] = (lo & ~hi) * 0x3F80u;                 // code 1
        }
#pragma unroll
        for (int ty = 0; ty < 3; ++ty)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            mma_bf16(acc[ty][nt], a[ty], bf[nt >> 1][2 * (nt & 1)],
                     bf[nt >> 1][2 * (nt & 1) + 1]);
      }
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

  double *const outs[3] = {H, E, M};
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
  const dim3 grid((unsigned)((Cw + BN - 1) / BN), (unsigned)((B + BM - 1) / BM));
  fused_bf16_kernel<<<grid, NTHREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      static_cast<const uint8_t *>(raw), static_cast<const uint16_t *>(wp),
      static_cast<double *>(H), static_cast<double *>(E),
      static_cast<double *>(M), (int)B, (int)nbp, (int)Cw);
  return (int)cudaGetLastError();
}
