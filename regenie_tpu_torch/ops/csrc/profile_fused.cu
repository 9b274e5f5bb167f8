// Profiling variants of the fused BED products for Hopper (sm_90a): five
// kernels built on the first design of fused_bf16.cu (mma.sync, 64 x 64
// tiles; that kernel has since moved to wgmma), each with a part of that
// design switched off or moved, so that their times attribute the bf16
// kernel's time to the decode, the tensor-core products and their overlap.
//
// Replace the Pallas TPU kernels of scripts/profile_fused.py, the JAX
// package's attribution script for _fused_kernel_split:
//   profile_fused_stacked     _stacked_kernel (:57, launched by run_variant
//                             :192)
//   profile_fused_stacked2    _stacked_kernel with with_m=False
//   profile_fused_nodecode    _nodecode_kernel (:82)
//   profile_fused_decode_only _decode_only_kernel (:98)
//   profile_fused_pipelined   _pipelined_kernel (:123, launched by
//                             run_pipelined :164)
//
// Inputs of every kernel: raw [B, nbp] uint8 (packed PLINK 2-bit codes,
// code_p(x) = (x >> 2p) & 3) and the bf16 hi|mid|lo split operand wp
// [4, nbp, Cw] (Cw = 3*Cp). Outputs: H, E, M [B, Cw] float64, against each
// third separately, as fused_bf16.cu writes them.
//   stacked, pipelined  H, E, M = sum_p sum_c [code_p(raw[b, c]) == 0 / 2 /
//                       1] * wp[p, c, j]: fused_bf16's function.
//   stacked2            H and E as stacked; the M product is not issued and
//                       M is 0.
//   nodecode            H = E = M = sum_p sum_c raw[b, c] * wp[p, c, j], the
//                       byte taken as its value (0..255, exact in bf16);
//                       three mma chains are issued, as the TPU issues three
//                       dots.
//   decode_only         column 0 of H / E / M holds the row's count of codes
//                       0 / 2 / 1 over all 4*nbp decoded samples (pad bytes
//                       are zero, code 0, and count in H); every other
//                       column is 0. No mma.
// Rows past B, bytes past nbp and columns past Cw read as zero and are not
// stored.
//
// Precision: as fused_bf16.cu. The mma sums run from zero over one stage,
// the stage sums are added in float32 with round-to-nearest adds, and
// every FLUSH = 4096 terms that float32 sum is added into a float64 sum in
// shared memory: one float32 sum rounds by at most about FLUSH x 2^-23 of
// its terms' magnitudes. The counts of decode_only are exact integers.
//
// Bound at the repository's full width (B=2048, nbp=100,096, Cw=1152):
// stacked, pipelined and nodecode do 2 x 3 x 2048 x 400,384 x 1152 =
// 5.668e12 bf16 tensor-core operations (5.73 ms at 989 dense TFLOP/s,
// against 1.18 GB of compulsory traffic, 0.35 ms at 3.35 TB/s: bound by
// operations); stacked2 two thirds of that; decode_only issues no mma and
// is bound by its 1.18 GB (0.35 ms).
//
// Design. One templated __global__ (profile_kernel):
//
// - The base (stacked, stacked2, nodecode, decode_only) is fused_bf16.cu's
//   first kernel: a 256-thread block owns a 64-row x 64-column tile of H,
//   E and M and loops over the whole contraction; each warp holds a 16 x
//   32 tile;
//   mma.sync.m16n8k16 bf16 -> f32 with a k-step of one plane of 16 bytes;
//   stages of 32 bytes x 4 planes x 64 columns arrive by cp.async, NSTAGE
//   in flight (3 by default; 2 and 4 for the sweep), XOR-swizzled and read
//   by ldmatrix.trans; the indicators are made in registers as bf16 bit
//   patterns (0x3F80 for 1.0) from a spread byte pair. The variants switch
//   parts off: stacked2 drops the M chain; nodecode makes each A register
//   once per half-stage from the byte pair as (2^23 + x) - 2^23 in float32
//   (bgen_bf16.cu's conversion) and feeds it to all planes and all three
//   chains; decode_only keeps the stage loads (raw and operand, as the TPU
//   variant's BlockSpec still copies the Wp tiles) and the full decode in
//   every block, issues no ldmatrix and no mma, and sums the decoded
//   indicators into per-row counts (so the decode stays), which only the
//   blocks holding column 0 store; every other block stores zeros.
// - pipelined moves the decode out of the mma warps, as the TPU kernel
//   moves it out of the dots of the same tile: NPW producer warps load the
//   stages (cp.async, NS slots of 16 bytes x 4 planes) and decode stage j
//   into a double-buffered bf16 indicator tile [3 classes][64 rows][64 k]
//   in shared memory (16-byte chunks XOR-swizzled by the row), while the 8
//   consumer warps run the 48 mma of stage j-1 from it, A by ldmatrix and B
//   by ldmatrix.trans. Named barriers order the hand-off: FULL[j & 1]
//   (producers arrive, consumers wait) and EMPTY[j & 1] (consumers arrive,
//   producers wait before refilling the buffer and the stage slot of stage
//   j - 2). The stages are 16 bytes so that the two indicator buffers, four
//   stage slots and the float64 sums fit in one block's shared memory
//   (184 KB); flushes stay at 4096 terms (64 stages). The price is shared-
//   memory traffic: per 16 bytes a block writes the 24 KB indicator tile
//   and reads it twice (both column warps of a row need the same A), about
//   115 KB in all against the base's 42 KB, at 128 bytes a clock an SM.
//
// wgmma and TMA are left for the redesign of the ported kernels.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Mode { STACKED = 0, STACKED2 = 1, NODECODE = 2, DECODE_ONLY = 3, PIPELINED = 4 };

constexpr int BM = 64;         // variant rows per block tile
constexpr int BN = 64;         // operand columns per block tile
constexpr int NCONS = 256;     // threads holding the products: 8 warps, 4 (rows) x 2 (columns)
constexpr int FLUSH = 4096;    // terms per float32 partial sum
constexpr int SUMS_BYTES = 48 * NCONS * 8;  // 48 float64 sums a product thread

// the base: stages of KC bytes
constexpr int KC = 32;
constexpr int RST = KC + 16;   // padded raw row stride (bytes)
struct __align__(16) Stage {
  uint16_t w[4][KC][BN];  // plane p, byte c, column chunk (j/8) ^ (c & 7)
  uint8_t raw[BM][RST];   // the block's rows, bytes [0, KC)
};

// pipelined: stages of KP bytes, the decoded indicators double-buffered
constexpr int KP = 16;
struct __align__(16) PStage {
  uint16_t w[4][KP][BN];  // as Stage
  uint8_t raw[BM][KP];
};
struct __align__(16) Ind {
  uint16_t v[3][BM][4 * KP];  // class, row, k = 16p + c at chunk (k/8) ^ (row & 7)
};

template <int MODE, int A, int NS>
constexpr int smem_bytes() {
  return MODE == PIPELINED
             ? NS * (int)sizeof(PStage) + 2 * (int)sizeof(Ind) + SUMS_BYTES
             : A * (int)sizeof(Stage) + SUMS_BYTES;
}

__device__ __forceinline__ void cp16(void *smem, const void *gmem, bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp8(void *smem, const void *gmem, bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
               "l"(gmem), "r"(ok ? 8 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void bar_sync(const int id, const int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(const int id, const int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void *smem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
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

// the class indicators of plane p of a spread byte pair, as bf16 pairs:
// code 0 (H), code 2 (E), code 1 (M)
__device__ __forceinline__ void classes(const uint32_t s, const int p,
                                        uint32_t &h, uint32_t &e, uint32_t &m) {
  const uint32_t lo = (s >> (2 * p)) & 0x00010001u;
  const uint32_t hi = (s >> (2 * p + 1)) & 0x00010001u;
  h = ((lo | hi) ^ 0x00010001u) * 0x3F80u;
  e = (hi & ~lo) * 0x3F80u;
  m = (lo & ~hi) * 0x3F80u;
}

// a 16-bit byte pair -> its two bytes as a bf16 pair (byte 0 in the low
// half): each byte as (2^23 + x) - 2^23 in float32, whose top half is its
// bf16 value
__device__ __forceinline__ uint32_t bytes_bf16(const uint32_t v) {
  const float lo = __uint_as_float(__byte_perm(v, 0x4B000000u, 0x7650)) - 8388608.f;
  const float hi = __uint_as_float(__byte_perm(v, 0x4B000000u, 0x7651)) - 8388608.f;
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// Adds a stage's mma sums into the float32 partial sums and, at the end of
// a flush or of the contraction, those into the float64 sums (element e of
// thread tid at e * NCONS + tid).
template <int NCLS>
__device__ __forceinline__ void accumulate(float (&acc)[3][4][4],
                                           float (&part)[3][4][4], double *sum,
                                           const int tid, const bool flush) {
#pragma unroll
  for (int ty = 0; ty < NCLS; ++ty)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) part[ty][nt][r] += acc[ty][nt][r];
  if (flush) {
#pragma unroll
    for (int ty = 0; ty < NCLS; ++ty)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          sum[((ty * 4 + nt) * 4 + r) * NCONS + tid] += (double)part[ty][nt][r];
          part[ty][nt][r] = 0.f;
        }
  }
}

// Writes a product thread's part of the block's H, E, M tile: the float64
// sums of the first NCLS products, zeros for the others; for decode_only
// the counts cnt (rows g and g+8) in column 0 and zeros elsewhere.
template <int MODE, int NCLS>
__device__ __forceinline__ void store_tile(const double *sum,
                                           const uint32_t (&cnt)[3][2],
                                           double *H, double *E, double *M,
                                           const int B, const int Cw) {
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;
  const int row = blockIdx.y * BM + wm * 16 + g;
  double *const outs[3] = {H, E, M};
#pragma unroll
  for (int ty = 0; ty < 3; ++ty)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = blockIdx.x * BN + wn * 32 + nt * 8 + 2 * t;
      if (col >= Cw) continue;
      double v[4] = {0.0, 0.0, 0.0, 0.0};
      if (MODE == DECODE_ONLY) {
        if (col == 0) {
          v[0] = (double)cnt[ty][0];
          v[2] = (double)cnt[ty][1];
        }
      } else if (ty < NCLS) {
        const double *e = sum + (ty * 4 + nt) * 4 * NCONS + tid;
#pragma unroll
        for (int r = 0; r < 4; ++r) v[r] = e[r * NCONS];
      }
      if (row < B)
        *reinterpret_cast<double2 *>(outs[ty] + (long long)row * Cw + col) =
            make_double2(v[0], v[1]);
      if (row + 8 < B)
        *reinterpret_cast<double2 *>(outs[ty] + (long long)(row + 8) * Cw + col) =
            make_double2(v[2], v[3]);
    }
}

// The base: fused_bf16.cu's first kernel with NSTAGE stages in flight and the
// parts of MODE switched off.
template <int MODE, int NSTAGE>
__device__ __forceinline__ void base_body(const uint8_t *__restrict__ raw,
                                          const uint16_t *__restrict__ wp,
                                          double *H, double *E, double *M,
                                          const int B, const int nbp,
                                          const int Cw) {
  constexpr int NCLS = MODE == STACKED2 ? 2 : 3;  // mma chains
  constexpr bool MMA = MODE != DECODE_ONLY;
  constexpr int FLUSH_STAGES = FLUSH / (4 * KC);
  extern __shared__ __align__(16) unsigned char smem[];
  Stage *st = reinterpret_cast<Stage *>(smem);
  double *const sum = reinterpret_cast<double *>(st + NSTAGE);
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
      const int idx = tid + NCONS * i;
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

  float acc[3][4][4], part[3][4][4];
  uint32_t cnt[3][2] = {{0u, 0u}, {0u, 0u}, {0u, 0u}};
  if (MMA) {
#pragma unroll
    for (int ty = 0; ty < NCLS; ++ty)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          part[ty][nt][r] = 0.f;
          sum[((ty * 4 + nt) * 4 + r) * NCONS + tid] = 0.0;
        }
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
    if (MMA) {
#pragma unroll
      for (int ty = 0; ty < NCLS; ++ty)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[ty][nt][r] = 0.f;
    }
    // decode_only: this stage's indicators of a class in rows g and g+8
    // (0x3F80 >> 7 = 127 each), the even and the odd bytes in the low and
    // the high 16 bits (at most 16 x 127 each)
    uint32_t pk[3][2] = {{0u, 0u}, {0u, 0u}, {0u, 0u}};

#pragma unroll
    for (int hb = 0; hb < 2; ++hb) {
      const int cb = 16 * hb;
      // past nbp the stage holds zero bytes (code 0): not counted
      if (MODE == DECODE_ONLY && k * KC + cb >= nbp) continue;
      // byte pairs (2t, 2t+1) and (2t+8, 2t+9) of rows g and g+8: the A
      // registers 0..3 of every plane's k-step
      uint32_t w16[4];
      w16[0] = *reinterpret_cast<const uint16_t *>(&s.raw[arow][cb + 2 * t]);
      w16[1] = *reinterpret_cast<const uint16_t *>(&s.raw[arow + 8][cb + 2 * t]);
      w16[2] = *reinterpret_cast<const uint16_t *>(&s.raw[arow][cb + 2 * t + 8]);
      w16[3] = *reinterpret_cast<const uint16_t *>(&s.raw[arow + 8][cb + 2 * t + 8]);
      uint32_t sp[4], byt[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (MODE == NODECODE)
          byt[i] = bytes_bf16(w16[i]);
        else
          sp[i] = spread(w16[i]);
      }
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        uint32_t bf[2][4];
        if (MMA) {
          const int kr = cb + lm_k;
#pragma unroll
          for (int pr = 0; pr < 2; ++pr)
            ldsm_x4_t(bf[pr], &s.w[p][kr][8 * ((lm_chunk + 2 * pr) ^ (kr & 7))]);
        }
        uint32_t a[3][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (MODE == NODECODE)
            a[0][i] = a[1][i] = a[2][i] = byt[i];
          else
            classes(sp[i], p, a[0][i], a[1][i], a[2][i]);
        }
        if (MMA) {
#pragma unroll
          for (int ty = 0; ty < NCLS; ++ty)
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
              mma_bf16(acc[ty][nt], a[ty], bf[nt >> 1][2 * (nt & 1)],
                       bf[nt >> 1][2 * (nt & 1) + 1]);
        } else {
#pragma unroll
          for (int ty = 0; ty < 3; ++ty)
#pragma unroll
            for (int i = 0; i < 4; ++i) pk[ty][i & 1] += a[ty][i] >> 7;
        }
      }
    }

    if (MMA) {
      accumulate<NCLS>(acc, part, sum, tid,
                       (k + 1) % FLUSH_STAGES == 0 || k + 1 == nk);
    } else {
#pragma unroll
      for (int ty = 0; ty < 3; ++ty)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          cnt[ty][h] += ((pk[ty][h] & 0xFFFFu) + (pk[ty][h] >> 16)) / 127u;
    }
  }
  cp_wait<0>();

  if (MODE == DECODE_ONLY) {
    // the four lanes of a row group hold disjoint bytes of the same rows
#pragma unroll
    for (int ty = 0; ty < 3; ++ty)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        cnt[ty][h] += __shfl_xor_sync(0xFFFFFFFFu, cnt[ty][h], 1);
        cnt[ty][h] += __shfl_xor_sync(0xFFFFFFFFu, cnt[ty][h], 2);
      }
  }
  store_tile<MODE, NCLS>(sum, cnt, H, E, M, B, Cw);
}

// pipelined: NPW producer warps load and decode, the 8 product warps run
// the mma of the stage decoded one step earlier.
template <int NPW, int NS>
__device__ __forceinline__ void pipe_body(const uint8_t *__restrict__ raw,
                                          const uint16_t *__restrict__ wp,
                                          double *H, double *E, double *M,
                                          const int B, const int nbp,
                                          const int Cw) {
  static_assert(NS >= 3, "loads run NS - 2 stages ahead");
  constexpr int NPT = 32 * NPW;          // producer threads
  constexpr int NT = NCONS + NPT;        // threads at each named barrier
  constexpr int HALVES = 2 * BM / NPT;   // 8-byte row halves a producer decodes a stage
  constexpr int WCHUNKS = 4 * KP * BN / 8 / NPT;  // operand chunks a producer loads a stage
  constexpr int FLUSH_STAGES = FLUSH / (4 * KP);
  constexpr int FULL = 1, EMPTY = 3;     // named barriers FULL + (k & 1), EMPTY + (k & 1)
  static_assert(HALVES >= 1 && 2 * BM % NPT == 0, "producer threads divide the rows");
  extern __shared__ __align__(16) unsigned char smem[];
  PStage *st = reinterpret_cast<PStage *>(smem);
  Ind *ind = reinterpret_cast<Ind *>(st + NS);
  double *const sum = reinterpret_cast<double *>(ind + 2);
  const int tid = threadIdx.x;
  const int r0 = blockIdx.y * BM, j0 = blockIdx.x * BN;
  const int nk = nbp / KP;  // nbp is a multiple of KP

  if (tid >= NCONS) {
    // producer: thread tp loads and decodes the halves tp + NPT * h (row
    // q & 63, bytes 8 * (q >> 6) .. +7), so it reads only its own copies
    const int tp = tid - NCONS;
    auto load = [&](PStage &s, const int c0) {
#pragma unroll
      for (int i = 0; i < WCHUNKS; ++i) {
        const int idx = tp + NPT * i;
        const int p = idx >> 7, c = (idx >> 3) & (KP - 1), v = idx & 7;
        const bool ok = j0 + 8 * v < Cw;
        const uint16_t *src =
            ok ? wp + ((long long)p * nbp + c0 + c) * Cw + j0 + 8 * v : wp;
        cp16(&s.w[p][c][8 * (v ^ (c & 7))], src, ok);
      }
#pragma unroll
      for (int h = 0; h < HALVES; ++h) {
        const int q = tp + NPT * h, row = q & (BM - 1), half = q >> 6;
        const bool ok = r0 + row < B;
        const uint8_t *src =
            ok ? raw + (long long)(r0 + row) * nbp + c0 + 8 * half : raw;
        cp8(&s.raw[row][8 * half], src, ok);
      }
    };
#pragma unroll
    for (int s = 0; s < NS - 2; ++s) {
      if (s < nk) load(st[s], s * KP);
      cp_commit();
    }
    for (int k = 0; k < nk; ++k) {
      // stage k - 2 is consumed: its buffer and its slot are free
      if (k >= 2) bar_sync(EMPTY + (k & 1), NT);
      if (k + NS - 2 < nk) load(st[(k + NS - 2) % NS], (k + NS - 2) * KP);
      cp_commit();
      cp_wait<NS - 2>();
      const PStage &s = st[k % NS];
      Ind &d = ind[k & 1];
#pragma unroll
      for (int h = 0; h < HALVES; ++h) {
        const int q = tp + NPT * h, row = q & (BM - 1), half = q >> 6;
        const uint2 w = *reinterpret_cast<const uint2 *>(&s.raw[row][8 * half]);
        const uint32_t sp[4] = {spread(w.x & 0xFFFFu), spread(w.x >> 16),
                                spread(w.y & 0xFFFFu), spread(w.y >> 16)};
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          uint32_t a[3][4];
#pragma unroll
          for (int i = 0; i < 4; ++i) classes(sp[i], p, a[0][i], a[1][i], a[2][i]);
          const int chunk = (2 * p + half) ^ (row & 7);
#pragma unroll
          for (int ty = 0; ty < 3; ++ty)
            *reinterpret_cast<uint4 *>(&d.v[ty][row][8 * chunk]) =
                make_uint4(a[ty][0], a[ty][1], a[ty][2], a[ty][3]);
        }
      }
      bar_arrive(FULL + (k & 1), NT);
    }
    cp_wait<0>();
    return;
  }

  // product warps
  const int lane = tid & 31, warp = tid >> 5;
  const int wn = warp & 1, wm = warp >> 1;
  float acc[3][4][4], part[3][4][4];
  const uint32_t cnt[3][2] = {{0u, 0u}, {0u, 0u}, {0u, 0u}};
#pragma unroll
  for (int ty = 0; ty < 3; ++ty)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        part[ty][nt][r] = 0.f;
        sum[((ty * 4 + nt) * 4 + r) * NCONS + tid] = 0.0;
      }
  // B: as the base; A: lane l gives row l & 15 of the warp's 16 and k
  // chunk l >> 4 of the plane's two
  const int lm_k = 8 * ((lane >> 3) & 1) + (lane & 7);
  const int lm_chunk = wn * 4 + (lane >> 4);
  const int a_row = wm * 16 + (lane & 15), a_half = lane >> 4;

  for (int k = 0; k < nk; ++k) {
    bar_sync(FULL + (k & 1), NT);
    const PStage &s = st[k % NS];
    const Ind &d = ind[k & 1];
#pragma unroll
    for (int ty = 0; ty < 3; ++ty)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[ty][nt][r] = 0.f;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      uint32_t bf[2][4], a[3][4];
#pragma unroll
      for (int pr = 0; pr < 2; ++pr)
        ldsm_x4_t(bf[pr], &s.w[p][lm_k][8 * ((lm_chunk + 2 * pr) ^ (lm_k & 7))]);
      const int chunk = (2 * p + a_half) ^ (a_row & 7);
#pragma unroll
      for (int ty = 0; ty < 3; ++ty) ldsm_x4(a[ty], &d.v[ty][a_row][8 * chunk]);
#pragma unroll
      for (int ty = 0; ty < 3; ++ty)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_bf16(acc[ty][nt], a[ty], bf[nt >> 1][2 * (nt & 1)],
                   bf[nt >> 1][2 * (nt & 1) + 1]);
    }
    // the producers wait on stage k only to refill at k + 2
    if (k + 2 < nk) bar_arrive(EMPTY + (k & 1), NT);
    accumulate<3>(acc, part, sum, tid, (k + 1) % FLUSH_STAGES == 0 || k + 1 == nk);
  }
  store_tile<PIPELINED, 3>(sum, cnt, H, E, M, B, Cw);
}

// A: NSTAGE of the base, or the producer warps of pipelined; NS: the
// stage slots of pipelined
template <int MODE, int A, int NS>
__global__ void __launch_bounds__(MODE == PIPELINED ? NCONS + 32 * A : NCONS, 1)
profile_kernel(const uint8_t *__restrict__ raw, const uint16_t *__restrict__ wp,
               double *__restrict__ H, double *__restrict__ E,
               double *__restrict__ M, const int B, const int nbp,
               const int Cw) {
  if constexpr (MODE == PIPELINED)
    pipe_body<A, NS>(raw, wp, H, E, M, B, nbp, Cw);
  else
    base_body<MODE, A>(raw, wp, H, E, M, B, nbp, Cw);
}

template <int MODE, int A, int NS>
int launch(const void *raw, const void *wp, void *H, void *E, void *M,
           long long B, long long nbp, long long Cw, void *stream) {
  constexpr int smem = smem_bytes<MODE, A, NS>();
  constexpr int threads = MODE == PIPELINED ? NCONS + 32 * A : NCONS;
  cudaError_t err = cudaFuncSetAttribute(
      profile_kernel<MODE, A, NS>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((Cw + BN - 1) / BN), (unsigned)((B + BM - 1) / BM));
  profile_kernel<MODE, A, NS><<<grid, threads, smem, (cudaStream_t)stream>>>(
      static_cast<const uint8_t *>(raw), static_cast<const uint16_t *>(wp),
      static_cast<double *>(H), static_cast<double *>(E),
      static_cast<double *>(M), (int)B, (int)nbp, (int)Cw);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each launches on `stream`,
// does not synchronise and allocates nothing; it returns cudaGetLastError()
// (or the error of the shared-memory attribute call), and
// cudaErrorInvalidValue for a configuration it does not have. Require
// nbp % 16 == 0 and Cw % 8 == 0 (16-byte copies); the Python wrappers
// check shapes, types, contiguity and alignment. `config` picks the Hopper
// configuration (ops/kernels.py: PROFILE_STACKED_CONFIGS,
// PROFILE_PIPELINED_CONFIGS); the other kernels have only config 0.
#define PROFILE_ARGS                                                          \
  const void *raw, const void *wp, void *H, void *E, void *M, long long B, \
      long long nbp, long long Cw, long long config, void *stream
#define PROFILE_PASS raw, wp, H, E, M, B, nbp, Cw, stream

extern "C" int profile_fused_stacked_launch(PROFILE_ARGS) {
  switch (config) {
    case 0: return launch<STACKED, 3, 0>(PROFILE_PASS);
    case 1: return launch<STACKED, 4, 0>(PROFILE_PASS);
    case 2: return launch<STACKED, 2, 0>(PROFILE_PASS);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int profile_fused_stacked2_launch(PROFILE_ARGS) {
  return config == 0 ? launch<STACKED2, 3, 0>(PROFILE_PASS)
                     : (int)cudaErrorInvalidValue;
}

extern "C" int profile_fused_nodecode_launch(PROFILE_ARGS) {
  return config == 0 ? launch<NODECODE, 3, 0>(PROFILE_PASS)
                     : (int)cudaErrorInvalidValue;
}

extern "C" int profile_fused_decode_only_launch(PROFILE_ARGS) {
  return config == 0 ? launch<DECODE_ONLY, 3, 0>(PROFILE_PASS)
                     : (int)cudaErrorInvalidValue;
}

extern "C" int profile_fused_pipelined_launch(PROFILE_ARGS) {
  switch (config) {
    case 0: return launch<PIPELINED, 4, 4>(PROFILE_PASS);
    case 1: return launch<PIPELINED, 2, 4>(PROFILE_PASS);
    default: return (int)cudaErrorInvalidValue;
  }
}
