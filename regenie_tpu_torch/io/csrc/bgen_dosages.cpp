// BGEN dosage decode for the dense Step-2 route and Step 1: the port's
// own copy of bgen12_decode in native/decoder.cpp, widened to what the
// JAX package's per-variant reader decodes (regenie_tpu/io/bgen.py
// decode_variant, _decode_layout2, _decode_layout1, _unpack_bits):
//
// - layout 2 (v1.2) at any bit depth 1..32, unphased or phased (a phased
//   diploid record stores P(haplotype carries the first allele) for each
//   haplotype; genotype probabilities are their products), and layout 1
//   (v1.1, three uint16 probabilities / 32768, all zero = missing);
// - compression 0 (none), 1 (zlib) or 2 (zstd, through the function
//   bgen_zstd_open loads in bgen_planes.cpp; both sources build into one
//   library);
// - ref-last (the dosage counts the first allele) or --ref-first (the
//   last allele).
//
// For each variant it writes the dosage (missing = -3) and the per-sample
// INFO numerator 4 p_hom + p_het - dosage^2 (0 at missing samples) of
// the kept samples (keep[j] of the file, or every sample when keep is
// null). The arithmetic is numpy's in the JAX reader, operation for
// operation, and the library is built with -ffp-contract=off and without
// -ffast-math, so every value equals the reader's bit for bit.
//
// status[v] is 0 for a decoded variant, else the reason it was rejected
// (see the enum); the return value counts the rejected variants. A
// rejected variant's rows are left unwritten. Reentrant and
// single-threaded: the caller runs calls on disjoint variant ranges in
// threads (io/native.py).

#include <stddef.h>
#include <stdint.h>
#include <string.h>

#include <vector>

// bgen_planes.cpp: inflate one record payload of csize bytes into usize
bool bgen_inflate(const uint8_t* src, int64_t csize, uint8_t* buf,
                  int64_t usize, int compression);

namespace {

enum Status : uint8_t {
  kOk = 0,
  kInflate = 1,  // inflate failed, or the size does not match
  kHeader = 2,   // sample count, allele count or ploidy range unexpected
  kBits = 3,     // bit depth outside 1..32
  kShort = 4,    // the probabilities reach past the record
  kLayout = 5,   // layout other than 1 or 2
};

// the n-th of a stream of `bits`-bit unsigned values, little-endian bit
// order (numpy.unpackbits(bitorder="little") weighted by 2^j)
inline uint64_t get_bits(const uint8_t* body, int64_t n, int bits) {
  const uint64_t first = (uint64_t)n * (uint64_t)bits;
  uint64_t v = 0;
  for (int j = 0; j < bits; j++) {
    const uint64_t b = first + (uint64_t)j;
    v |= (uint64_t)((body[b >> 3] >> (b & 7)) & 1) << j;
  }
  return v;
}

inline void put(double p_hom, double p1, bool missing, double* ds,
                double* iv) {
  const double d = p1 + 2.0 * p_hom;
  if (missing) {
    *ds = -3.0;
    *iv = 0.0;
  } else {
    *ds = d;
    *iv = 4.0 * p_hom + p1 - d * d;
  }
}

uint8_t decode_layout2(const uint8_t* buf, int64_t usize, int64_t n_file,
                       int ref_first, const int64_t* keep, int64_t n_out,
                       double* ds, double* iv) {
  if (usize < 10) return kHeader;
  uint32_t N;
  memcpy(&N, buf, 4);
  uint16_t K;
  memcpy(&K, buf + 4, 2);
  if ((int64_t)N != n_file || K != 2 || buf[6] != 2 || buf[7] != 2 ||
      usize < (int64_t)(10 + (uint64_t)N))
    return kHeader;
  const uint8_t* ploidy = buf + 8;
  const bool phased = buf[8 + N] != 0;
  const int bits = buf[9 + N];
  if (bits < 1 || bits > 32) return kBits;
  const uint64_t body_bytes = (2 * (uint64_t)N * (uint64_t)bits + 7) / 8;
  if ((uint64_t)usize < 10 + (uint64_t)N + body_bytes) return kShort;
  const uint8_t* body = buf + 10 + N;
  const double scale = (double)((1ull << bits) - 1);
  for (int64_t j = 0; j < n_out; j++) {
    const int64_t i = keep ? keep[j] : j;
    double a, b;
    if (bits == 8) {
      a = (double)body[2 * i] / scale;
      b = (double)body[2 * i + 1] / scale;
    } else if (bits == 16) {
      uint16_t u[2];
      memcpy(u, body + 4 * i, 4);
      a = (double)u[0] / scale;
      b = (double)u[1] / scale;
    } else {
      a = (double)get_bits(body, 2 * i, bits) / scale;
      b = (double)get_bits(body, 2 * i + 1, bits) / scale;
    }
    double p0, p1, p2;
    if (phased) {
      p0 = a * b;
      p2 = (1.0 - a) * (1.0 - b);
      p1 = 1.0 - p0 - p2;
      if (p1 < 0.0) p1 = 0.0;
    } else {
      p0 = a;
      p1 = b;
      p2 = 1.0 - p0 - p1;
      if (p2 < 0.0) p2 = 0.0;
    }
    put(ref_first ? p2 : p0, p1, (ploidy[i] & 0x80) != 0, ds + j, iv + j);
  }
  return kOk;
}

uint8_t decode_layout1(const uint8_t* buf, int64_t usize, int64_t n_file,
                       int ref_first, const int64_t* keep, int64_t n_out,
                       double* ds, double* iv) {
  if (usize < 6 * n_file) return kShort;
  for (int64_t j = 0; j < n_out; j++) {
    const int64_t i = keep ? keep[j] : j;
    uint16_t u[3];
    memcpy(u, buf + 6 * i, 6);
    const double pAA = (double)u[0] / 32768.0;
    const double pAB = (double)u[1] / 32768.0;
    const double pBB = (double)u[2] / 32768.0;
    put(ref_first ? pBB : pAA, pAB, (pAA + pAB + pBB) == 0.0, ds + j, iv + j);
  }
  return kOk;
}

}  // namespace

extern "C" int64_t bgen_decode_dosages(
    const uint8_t* comp, const int64_t* offsets, const int64_t* csizes,
    const int64_t* usizes, int64_t n_var, int64_t n_samples_file, int layout,
    int compression, int ref_first, const int64_t* keep, int64_t n_keep,
    double* dosage, double* info_num, uint8_t* status) {
  const int64_t n_out = keep ? n_keep : n_samples_file;
  int64_t n_fail = 0;
  std::vector<uint8_t> buf;
  for (int64_t v = 0; v < n_var; v++) {
    const int64_t usize = usizes[v];
    uint8_t st = kOk;
    const uint8_t* data = comp + offsets[v];
    if (usize < 0) {
      st = kInflate;
    } else if (compression != 0) {
      buf.resize(usize > 0 ? usize : 1);
      if (!bgen_inflate(data, csizes[v], buf.data(), usize, compression))
        st = kInflate;
      data = buf.data();
    } else if (csizes[v] != usize) {
      st = kInflate;
    }
    if (st == kOk) {
      double* ds = dosage + v * n_out;
      double* iv = info_num + v * n_out;
      if (layout == 2)
        st = decode_layout2(data, usize, n_samples_file, ref_first, keep, n_out,
                            ds, iv);
      else if (layout == 1)
        st = decode_layout1(data, usize, n_samples_file, ref_first, keep, n_out,
                            ds, iv);
      else
        st = kLayout;
    }
    status[v] = st;
    if (st != kOk) n_fail++;
  }
  return n_fail;
}
