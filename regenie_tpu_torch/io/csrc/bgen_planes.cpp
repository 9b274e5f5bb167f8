// BGEN v1.2 8-bit probability-plane extraction for the fused Step-2
// scorer: inflate only, no parse. The port's own copy of
// bgen12_extract_planes in native/decoder.cpp, for zlib (compression 1)
// and zstd (compression 2) records. It builds against zlib alone: zstd's
// two entry points are declared here and taken from the shared library
// at run time (bgen_zstd_open, dlopen), since a machine may have
// libzstd.so.1 without its headers; a zlib file never loads it.
//
// For each variant it emits the two per-sample probability bytes
// de-interleaved (k0 = P(hom first allele), k1 = P(het)), with missing
// samples (ploidy byte bit 0x80) marked by the impossible pair
// k0 = k1 = 255. The device kernel reconstructs dosage = (2 k0 + k1)/255
// (ref-last coding) and its square from the byte planes.
//
// Returns the number of variants it could not extract (> 0 fails the
// whole block): an inflate error or size mismatch (zstd records too when
// bgen_zstd_open has not loaded the library), a variant that is not
// unphased diploid biallelic 8-bit, or a non-missing sample with
// k0 + k1 > 255 (p2 would clip, and the linear ref-first identity
// 2 - dosage would break).
//
// Single-threaded and reentrant: the caller runs calls on disjoint
// variant ranges in parallel threads (io/native.py), so the build needs
// no OpenMP runtime. bgen_inflate is shared with the dosage decoder
// (bgen_dosages.cpp), which builds into the same library.
//
// Build (one library with the dosage decoder):
//   g++ -O3 -ffp-contract=off -fPIC -shared -o libbgen_planes.so
//       bgen_planes.cpp bgen_dosages.cpp -lz -ldl

#include <dlfcn.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>
#include <zlib.h>

#include <atomic>

namespace {
// zstd.h's ZSTD_decompress and ZSTD_isError
typedef size_t (*zstd_decompress_fn)(void*, size_t, const void*, size_t);
typedef unsigned (*zstd_iserror_fn)(size_t);
struct Zstd {
  zstd_decompress_fn decompress;
  zstd_iserror_fn is_error;
};
std::atomic<const Zstd*> g_zstd{nullptr};
Zstd g_zstd_fns;
}  // namespace

// Load ZSTD_decompress and ZSTD_isError from the shared library `soname`
// (libzstd.so.1). Returns 1 when both resolve, else 0 (the extractor
// keeps what an earlier call loaded, if anything). Call it before
// extracting a zstd file, not while an extraction runs.
extern "C" int bgen_zstd_open(const char* soname) {
  void* h = dlopen(soname, RTLD_NOW | RTLD_LOCAL);
  if (!h) return 0;
  const auto dec = (zstd_decompress_fn)dlsym(h, "ZSTD_decompress");
  const auto err = (zstd_iserror_fn)dlsym(h, "ZSTD_isError");
  if (!dec || !err) {
    dlclose(h);
    return 0;
  }
  if (g_zstd.load() == nullptr) {
    g_zstd_fns = Zstd{dec, err};
    g_zstd.store(&g_zstd_fns);
  }
  return 1;
}

// Inflate a record payload of csize bytes into buf, which holds usize
// bytes: compression 0 copies (csize must equal usize), 1 zlib, 2 zstd
// (once bgen_zstd_open has loaded the library). Returns whether the
// payload filled buf exactly.
bool bgen_inflate(const uint8_t* src, int64_t csize, uint8_t* buf,
                  int64_t usize, int compression) {
  if (compression == 0) {
    if (csize != usize) return false;
    memcpy(buf, src, usize);
    return true;
  }
  if (compression == 1) {
    uLongf dlen = (uLongf)usize;
    return (uncompress(buf, &dlen, src, (uLong)csize) == Z_OK) &&
           ((int64_t)dlen == usize);
  }
  if (compression == 2) {
    const Zstd* z = g_zstd.load();
    if (!z) return false;
    const size_t n = z->decompress(buf, (size_t)usize, src, (size_t)csize);
    return !z->is_error(n) && (int64_t)n == usize;
  }
  return false;
}

extern "C" int64_t bgen12_extract_planes(const uint8_t* comp,
                                         const int64_t* offsets,
                                         const int64_t* csizes,
                                         const int64_t* usizes, int64_t n_var,
                                         int64_t n_samples, int compression,
                                         uint8_t* planes_out) {
  int64_t n_fail = 0;
  for (int64_t v = 0; v < n_var; v++) {
    const uint8_t* src = comp + offsets[v];
    const int64_t usize = usizes[v];
    uint8_t* buf = new uint8_t[usize > 0 ? usize : 1];
    // records without compression carry no size field: not for this path
    bool ok = (compression == 1 || compression == 2) &&
              bgen_inflate(src, csizes[v], buf, usize, compression);
    uint8_t* k0 = planes_out + v * 2 * n_samples;
    uint8_t* k1 = k0 + n_samples;
    if (ok && usize >= 10) {
      uint32_t N;
      memcpy(&N, buf, 4);
      uint16_t K;
      memcpy(&K, buf + 4, 2);
      const uint8_t minp = buf[6], maxp = buf[7];
      // validate the whole header and body extent before reading at the
      // N-dependent offsets
      if ((int64_t)N != n_samples || K != 2 || minp != 2 || maxp != 2 ||
          usize < (int64_t)(10 + (uint64_t)N + 2 * (uint64_t)N)) {
        ok = false;
      } else {
        const uint8_t* ploidy = buf + 8;
        const uint8_t phased = buf[8 + N];
        const uint8_t bits = buf[9 + N];
        if (phased != 0 || bits != 8) {
          ok = false;
        } else {
          const uint8_t* body = buf + 10 + N;
          for (int64_t i = 0; i < n_samples; i++) {
            if (ploidy[i] & 0x80) {
              k0[i] = 255;
              k1[i] = 255;
              continue;
            }
            const uint8_t a = body[2 * i], b = body[2 * i + 1];
            if ((int)a + (int)b > 255) {
              ok = false;
              break;
            }
            k0[i] = a;
            k1[i] = b;
          }
        }
      }
    } else {
      ok = false;
    }
    if (!ok) n_fail += 1;
    delete[] buf;
  }
  return n_fail;
}
