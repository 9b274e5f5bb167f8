// Fused Step-2 products for Hopper (sm_90a) against the float32 operand:
// packed PLINK 2-bit genotype bytes times the f32 [4, nbp, Cp] operand,
// summed in float64 on the tensor cores.
//
// Replaces the Pallas TPU kernel regenie_tpu/ops/fused_score.py:331
// (_fused_kernel, launched by fused_products at :513), which
// REGENIE_TPU_I8=0 selects.
//
// What it computes, for raw [B, nbp] uint8 and wp [4, nbp, Cp] float32:
//   H[b, j] = sum_p sum_c [code_p(raw[b, c]) == 0] * wp[p, c, j]
//   E[b, j] = the same sum with code == 2,  M[b, j] with code == 1
// as [B, Cp] float64, where code_p(x) = (x >> 2p) & 3 (PLINK: 0 hom-alt,
// 1 missing, 2 het, 3 hom-ref). The caller folds S1 = 2H + E,
// SQ = 4H + E, SM = M: the TPU kernel's g, g^2 and missing products.
// The TPU kernel sums in float32; here every product of an indicator and
// an f32 value is exact in float64 and the sums carry ~1e-16 relative
// error (a float32 sum over 400,000 samples would move LOG10P past the
// repository's 1e-5 bar in the incomplete traits' cancelling
// denominator). Bytes past nbp, rows past B and columns past Cp read as
// zero; pad bytes decode to code 0 against zero operand rows.
//
// Bound at the repository's full width (B=2048, nbp=100,096, Cp=384):
// 2 x 3 x 2048 x 400,384 x 384 = 1.889e12 FP64 tensor-core operations
// per block, 28.2 ms at the H100's 67 TFLOP/s, against 0.84 GB of
// compulsory traffic (0.25 ms at 3.35 TB/s): bound by operations. The
// design is the simple one that is right; making it fast is later work:
//
// - Tensor cores: mma.sync.m8n8k4 f64 (Hopper has no f64 wgmma). The
//   contraction index k of one mma is the 4 planes of one packed byte:
//   lane (g, t) holds A(row g, k t) = the indicator of code_t of its
//   row's byte and B(k t, column g) = wp[t, c, column]. One raw word per
//   lane and row feeds 4 mma k-steps; the indicators are made in
//   registers as the high word of 1.0 or 0.0, so no indicator tile goes
//   through memory and no conversion instruction is spent on A.
// - Work split: each 256-thread block owns one 64-row x 64-column output
//   tile of H, E and M and loops over the whole nbp contraction (no
//   split-K, no atomics): the result is deterministic. Each warp holds a
//   32 x 16 tile of the three products (48 float64 accumulators a
//   thread). The TPU kernel's sequential grid axis over byte tiles
//   becomes this in-block loop.
// - The operand is staged in shared memory as f32 (half the bytes of
//   f64) and widened at fragment load. Stages of 32 bytes x 4 planes x 64
//   columns arrive by 16-byte cp.async copies (zero-filled past the
//   edges), three stages in flight. Plane p is XOR-swizzled on the column
//   (j ^ 8p) so that the four planes' B-fragment loads of a warp fall in
//   distinct banks; raw rows are padded to 48 bytes for the same reason.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;         // variant rows per block tile
constexpr int BN = 64;         // operand columns per block tile
constexpr int KC = 32;         // packed bytes per stage (4*KC contraction terms)
constexpr int RST = KC + 16;   // padded raw row stride (bytes)
constexpr int NSTAGE = 3;      // stages in flight
constexpr int NTHREADS = 256;  // 8 warps: 2 (rows) x 4 (columns)

struct __align__(16) Stage {
  float w[4][KC][BN];     // plane p, byte c, column j ^ 8p
  uint8_t raw[BM][RST];   // the block's rows, bytes [0, KC)
};
constexpr int SMEM_BYTES = NSTAGE * (int)sizeof(Stage);

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

__device__ __forceinline__ void mma_f64(double (&c)[2], const double a,
                                        const double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
      "{%0,%1}, {%2}, {%3}, {%0,%1};\n"
      : "+d"(c[0]), "+d"(c[1])
      : "d"(a), "d"(b));
}

// 1.0 where the flag is set, else 0.0, built from the high word alone
__device__ __forceinline__ double ind(const bool f) {
  return __hiloint2double(f ? 0x3FF00000 : 0, 0);
}

__global__ void __launch_bounds__(NTHREADS, 1)
fused_f32_kernel(const uint8_t *__restrict__ raw, const float *__restrict__ wp,
                 double *__restrict__ H, double *__restrict__ E,
                 double *__restrict__ M, const int B, const int nbp,
                 const int Cp) {
  extern __shared__ __align__(16) unsigned char smem[];
  Stage *st = reinterpret_cast<Stage *>(smem);
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const int r0 = blockIdx.y * BM, j0 = blockIdx.x * BN;

  // one stage: 4 x KC x BN/4 operand vectors (8 a thread), BM x KC/16 raw
  // vectors (threads 0..127)
  auto load = [&](Stage &s, const int c0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int idx = tid + NTHREADS * i;
      const int p = idx / (KC * BN / 4), c = (idx / (BN / 4)) % KC;
      const int v = idx % (BN / 4);
      const bool ok = (c0 + c < nbp) && (j0 + 4 * v < Cp);
      const float *src =
          ok ? wp + ((long long)p * nbp + c0 + c) * Cp + j0 + 4 * v : wp;
      cp16(&s.w[p][c][(4 * v) ^ (p << 3)], src, ok);
    }
    if (tid < 2 * BM) {
      const int row = tid >> 1, half = tid & 1;
      const bool ok = (r0 + row < B) && (c0 + 16 * half < nbp);
      const uint8_t *src =
          ok ? raw + (long long)(r0 + row) * nbp + c0 + 16 * half : raw;
      cp16(&s.raw[row][16 * half], src, ok);
    }
  };

  double acc[3][4][2][2];
#pragma unroll
  for (int ty = 0; ty < 3; ++ty)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) acc[ty][i][j][0] = acc[ty][i][j][1] = 0.0;

  const int nk = (nbp + KC - 1) / KC;
#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s) {
    if (s < nk) load(st[s], s * KC);
    cp_commit();
  }

  const int sh = 2 * t;
  for (int k = 0; k < nk; ++k) {
    cp_wait<NSTAGE - 2>();
    __syncthreads();
    if (k + NSTAGE - 1 < nk) load(st[(k + NSTAGE - 1) % NSTAGE], (k + NSTAGE - 1) * KC);
    cp_commit();
    const Stage &s = st[k % NSTAGE];

#pragma unroll
    for (int q = 0; q < KC / 4; ++q) {
      // bytes 4q .. 4q+3 of this warp's rows g, g+8, g+16, g+24
      uint32_t rw[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        rw[i] = *reinterpret_cast<const uint32_t *>(
            &s.raw[wm * 32 + 8 * i + g][4 * q]);
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int c = 4 * q + b;
        double bf[2];
#pragma unroll
        for (int j = 0; j < 2; ++j)
          bf[j] = (double)s.w[t][c][(wn * 16 + 8 * j + g) ^ (t << 3)];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint32_t code = (rw[i] >> (8 * b + sh)) & 3u;
          const double h = ind(code == 0), e = ind(code == 2),
                       m = ind(code == 1);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            mma_f64(acc[0][i][j], h, bf[j]);
            mma_f64(acc[1][i][j], e, bf[j]);
            mma_f64(acc[2][i][j], m, bf[j]);
          }
        }
      }
    }
  }
  cp_wait<0>();

  double *const outs[3] = {H, E, M};
#pragma unroll
  for (int ty = 0; ty < 3; ++ty)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int row = r0 + wm * 32 + 8 * i + g;
        const int col = j0 + wn * 16 + 8 * j + 2 * t;
        if (row < B && col < Cp)
          *reinterpret_cast<double2 *>(outs[ty] + (long long)row * Cp + col) =
              make_double2(acc[ty][i][j][0], acc[ty][i][j][1]);
      }
}

}  // namespace

// Plain C entry point (loaded with ctypes). Launches on `stream`, does not
// synchronise and allocates nothing; returns cudaGetLastError() (or the
// error of the shared-memory attribute call). Requires nbp % 16 == 0 and
// Cp % 4 == 0 (16-byte copies); the Python wrapper checks shapes, types,
// contiguity and alignment.
extern "C" int fused_f32_launch(const void *raw, const void *wp, void *H,
                                void *E, void *M, long long B, long long nbp,
                                long long Cp, void *stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fused_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((Cp + BN - 1) / BN), (unsigned)((B + BM - 1) / BM));
  fused_f32_kernel<<<grid, NTHREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      static_cast<const uint8_t *>(raw), static_cast<const float *>(wp),
      static_cast<double *>(H), static_cast<double *>(E),
      static_cast<double *>(M), (int)B, (int)nbp, (int)Cp);
  return (int)cudaGetLastError();
}
