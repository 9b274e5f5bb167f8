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
// design aims at that rate:
//
// - Tensor cores: mma.sync.aligned.m16n8k8 f64 (SASS DMMA.16x8x8, from
//   cuobjdump -sass; Hopper has no f64 wgmma). On the H100 the m8n8k4
//   shape (DMMA.8x8x4) runs at half the FP64 tensor rate, 33.5 of 67
//   TFLOP/s, while the m16n8k4/k8/k16 shapes reach 65-67 (chains of
//   independent mma, NVIDIA H100 80GB HBM3, 700 W).
//   The 8 contraction terms of one mma are the 4 planes of 2 packed
//   bytes: lane (g, t) holds A(row g + 8r, k t + 4j) = the indicator of
//   code_t of byte 2h + j of its row's 32-bit raw word (a[2j + r]) and
//   B(k t + 4j, column g) = wp[t, 4q + 2h + j, column] (b[j]), h = 0, 1.
//   One raw word per lane and row feeds two k-steps of the three
//   products; the indicators are made in registers with integer
//   operations as the high word of 1.0 or 0.0, so no indicator tile goes
//   through memory and no FP64-pipe instruction is spent on A.
//   (m16n8k16 runs as fast in the chains, but its 8 A values a lane and
//   type pushed this tile past 255 registers into spills.)
// - Work split and waves: each 256-thread block owns one 128-row x
//   48-column output tile of H, E and M and loops over the whole nbp
//   contraction (no split-K, no atomics): the result is deterministic.
//   At the main shape (B=2048, Cp=384) that is 16 x 8 = 128 blocks, one
//   block per SM, 0.97 of one wave on 132 SMs (tiles of 64 x 64 would
//   give 192 blocks, 2 waves, the second 45% full). The 8 warps stand
//   in a column: each holds a 16 x 48 tile of the three products (1 x 6
//   m16n8 tiles, 72 float64 accumulators a thread), so each raw word is
//   decoded once per block and its indicators feed 6 column tiles; each
//   widened operand value feeds 3 products.
// - Registers: ptxas reports 254 a thread, 0 bytes of spill (launch bound
//   256 threads, 1 block per SM); 123,392 bytes of shared memory.
// - The operand is staged in shared memory as f32 (half the bytes of
//   f64) and widened at fragment load (F2F.F64.F32, 24 per 36 mma a
//   warp; replacing it by a plain move changed nothing measurable).
//   Stages of 32 bytes x 4 planes x 48 columns arrive by 16-byte cp.async
//   copies (zero-filled past the edges), four stages in flight. The
//   planes are padded to 1544 floats so that the four planes' B-fragment
//   loads of a warp fall in distinct banks; raw rows are padded to 48
//   bytes for the same reason. The 128 blocks run in step over the same
//   contraction range, so the 615 MB operand is read from device memory
//   about once and served to the 16 row tiles from L2.
// - What bounds it: the DMMA rate. Measured at full width on the H100:
//   32.1-32.5 ms, 87-88% of the bound, at 1980 MHz and 510-580 W (no
//   clock or power limit reached); 3% of the SMs idle; the indicators
//   cost 2.6% (a one-operation stand-in ran 31.3 ms); the rest is the
//   loop's loads, barriers and NOPs, 5.2 instructions a DMMA in all.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;        // variant rows per block tile
constexpr int BN = 48;         // operand columns per block tile
constexpr int KC = 32;         // packed bytes per stage (4*KC contraction terms)
constexpr int PS = KC * BN + 8;  // padded plane stride (floats)
constexpr int RST = KC + 16;   // padded raw row stride (bytes)
constexpr int NSTAGE = 4;      // stages in flight
constexpr int WM = 16, WN = 48;  // warp tile
constexpr int WARPS_N = BN / WN;  // warps along the columns
constexpr int NTHREADS = 32 * (BM / WM) * WARPS_N;  // 8 warps: 8 (rows) x 1
constexpr int MT = WM / 16, NT = WN / 8;

struct __align__(16) Stage {
  float w[4 * PS];        // plane p, byte c, column j at p * PS + c * BN + j
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

__device__ __forceinline__ void mma_f64(double (&c)[4], const double (&a)[4],
                                        const double (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

// 1.0 where bit 8j of the mask is set, else 0.0, built from the high word
__device__ __forceinline__ double ind(const uint32_t mask, const int j) {
  return __hiloint2double(((mask >> (8 * j)) & 1u) ? 0x3FF00000 : 0, 0);
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
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int r0 = blockIdx.y * BM, j0 = blockIdx.x * BN;

  // one stage: 4 x KC x BN/4 operand vectors, BM x KC/16 raw vectors
  auto load = [&](Stage &s, const int c0) {
#pragma unroll
    for (int i = 0; i < 4 * KC * (BN / 4) / NTHREADS; ++i) {
      const int idx = tid + NTHREADS * i;
      const int p = idx / (KC * BN / 4), c = (idx / (BN / 4)) % KC;
      const int v = idx % (BN / 4);
      const bool ok = (c0 + c < nbp) && (j0 + 4 * v < Cp);
      const float *src =
          ok ? wp + ((long long)p * nbp + c0 + c) * Cp + j0 + 4 * v : wp;
      cp16(&s.w[p * PS + c * BN + 4 * v], src, ok);
    }
#pragma unroll
    for (int i = 0; i < BM * KC / 16 / NTHREADS; ++i) {
      const int idx = tid + NTHREADS * i;
      const int row = idx / (KC / 16), v = idx % (KC / 16);
      const bool ok = (r0 + row < B) && (c0 + 16 * v < nbp);
      const uint8_t *src =
          ok ? raw + (long long)(r0 + row) * nbp + c0 + 16 * v : raw;
      cp16(&s.raw[row][16 * v], src, ok);
    }
  };

  double acc[3][MT][NT][4];
#pragma unroll
  for (int ty = 0; ty < 3; ++ty)
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[ty][i][j][e] = 0.0;

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

    // one raw word (bytes 4q .. 4q+3) a row, two k-steps of 8 terms
#pragma unroll 1
    for (int q = 0; q < KC / 4; ++q) {
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        // plane t of bytes 4q .. 4q+3 of rows g and g+8 of row tile i:
        // bit 8j of each mask marks code 0 (H), 2 (E), 1 (M) in byte j
        uint32_t cls[3][2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const uint32_t x = *reinterpret_cast<const uint32_t *>(
                                 &s.raw[wm * WM + 16 * i + 8 * r + g][4 * q]) >> sh;
          const uint32_t y = x >> 1;
          cls[0][r] = ~(x | y) & 0x01010101u;
          cls[1][r] = y & ~x & 0x01010101u;
          cls[2][r] = x & ~y & 0x01010101u;
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // B fragments: plane t, bytes 4q + 2h and 4q + 2h + 1, the
          // warp's column tiles
          double bf[NT][2];
#pragma unroll
          for (int jt = 0; jt < NT; ++jt)
#pragma unroll
            for (int j = 0; j < 2; ++j)
              bf[jt][j] = (double)s.w[t * PS + (4 * q + 2 * h + j) * BN + wn * WN + 8 * jt + g];
#pragma unroll
          for (int ty = 0; ty < 3; ++ty) {
            double a[4];
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              a[2 * j] = ind(cls[ty][0], 2 * h + j);
              a[2 * j + 1] = ind(cls[ty][1], 2 * h + j);
            }
#pragma unroll
            for (int jt = 0; jt < NT; ++jt) mma_f64(acc[ty][i][jt], a, bf[jt]);
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
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int jt = 0; jt < NT; ++jt)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = r0 + wm * WM + 16 * i + 8 * r + g;
          const int col = j0 + wn * WN + 8 * jt + 2 * t;
          if (row < B && col < Cp)
            *reinterpret_cast<double2 *>(outs[ty] + (long long)row * Cp + col) =
                make_double2(acc[ty][i][jt][2 * r], acc[ty][i][jt][2 * r + 1]);
        }
}

dim3 grid_of(const long long B, const long long Cp) {
  return dim3((unsigned)((Cp + BN - 1) / BN), (unsigned)((B + BM - 1) / BM));
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
  fused_f32_kernel<<<grid_of(B, Cp), NTHREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      static_cast<const uint8_t *>(raw), static_cast<const float *>(wp),
      static_cast<double *>(H), static_cast<double *>(E),
      static_cast<double *>(M), (int)B, (int)nbp, (int)Cp);
  return (int)cudaGetLastError();
}

// The launch's shape for B rows and Cp columns, as the CUDA runtime
// reports it: info = {blocks, blocks per SM, registers a thread,
// threads a block, dynamic shared memory bytes}. Returns a CUDA error code.
extern "C" int fused_f32_info(long long B, long long Cp, int *info) {
  cudaError_t err = cudaFuncSetAttribute(
      fused_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes at;
  err = cudaFuncGetAttributes(&at, fused_f32_kernel);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_f32_kernel,
                                                      NTHREADS, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid = grid_of(B, Cp);
  info[0] = (int)(grid.x * grid.y);
  info[1] = per_sm;
  info[2] = at.numRegs;
  info[3] = NTHREADS;
  info[4] = SMEM_BYTES;
  return 0;
}
