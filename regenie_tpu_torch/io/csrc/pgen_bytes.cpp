// PGEN hardcalls -> BED-coded packed bytes on the kept-sample axis, for
// the fused Step-2 scorer and Step 1's level 0: the port's own block
// decoder of PLINK2 .pgen records.
//
// Reads the hardcall track of storage modes 0x02 (fixed 2-bit records)
// and 0x10/0x11 (variable records: vrtype 0 2-bit direct, 1 onebit with
// an exception difflist, 4/6/7 a difflist against a constant genotype,
// 5 all hom-ref, 2/3 LD-compressed, a difflist against the last non-LD
// variant, 3 with hom-ref and hom-alt swapped). Aux tracks (phase,
// dosage) follow the hardcall track and are not read. The byte layout is
// the public PGEN format as pgenlib_read.cc reads it; the plain twin is
// PgenDecoder in io/pgen.py.
//
// Output: one row of ceil(n_out / 4) bytes a variant, sample j of the
// kept axis (keep[j] of the file, or j when keep is null) in bits
// 2(j%4)..2(j%4)+1 of byte j/4, coded as PLINK 1 BED (PGEN code 0
// hom-ref -> 3, 1 het -> 2, 2 hom-alt -> 0, 3 missing -> 1); the unused
// bits of the last byte are 0. These are the bytes the JAX package
// repacks from decoded ALT counts (regenie_tpu/run_step2.py:1008-1030).
//
// A second entry, pgen_dosages, writes float64 ALT dosages of the same
// rows (missing = -3): the hardcalls, overwritten by the 16-bit dosage
// track where the record has one (vrtype bits 0x60: 0x20 a deltalist,
// 0x40 dense with 65535 = missing, 0x60 a presence bitarray; values
// v / 16384), after skipping the hardcall-phase track (0x10). It mirrors
// pgen_decode_block in native/decoder.cpp and PgenDecoder.dosages in
// io/pgen.py (its plain twin), value for value.
//
// Each returns the number of variants it could not decode (a
// multiallelic record, a record, difflist or dosage track reaching past
// the file, a sample index out of range); > 0 fails the whole block. The
// variants are split over n_threads std::threads (the card's g++ has no
// OpenMP), each with its own LD-base cache.
//
// Build: g++ -O3 -fPIC -shared -pthread -o libpgen_bytes.so pgen_bytes.cpp

#include <stdint.h>
#include <string.h>

#include <thread>
#include <vector>

namespace {

struct Src {
  const uint8_t* data;
  int64_t len;
  const int64_t* fpos;
  const uint8_t* vrtypes;
  int64_t n_samples;
};

// a bounds-checked little-endian reader over the mapped file
struct Reader {
  const Src& s;
  int64_t pos;
  bool ok = true;
  Reader(const Src& src, int64_t p) : s(src), pos(p) {}
  bool have(int64_t n) {
    if (pos < 0 || n < 0 || pos + n > s.len) ok = false;
    return ok;
  }
  uint32_t byte() {
    if (!have(1)) return 0;
    return s.data[pos++];
  }
  uint32_t vint() {
    uint32_t v = 0;
    for (int shift = 0; ok && shift < 35; shift += 7) {
      const uint32_t b = byte();
      v |= (b & 0x7F) << shift;
      if (!(b & 0x80)) return v;
    }
    ok = false;
    return 0;
  }
};

// parse the sample ids of a difflist (with_rare: and its 2-bit codes) or
// a deltalist at r.pos, whose length L was read already, calling
// visit(k, id, rare_code) for each entry k in order
template <class F>
bool parse_ids(Reader& r, uint32_t L, bool with_rare, F visit) {
  const int64_t N = r.s.n_samples;
  int sid_bytes = 0;  // bytes that represent N (BytesToRepresentNzU32)
  for (uint64_t n = (uint64_t)N; n; n >>= 8) sid_bytes++;
  const int64_t group_ct = ((int64_t)L + 63) / 64;
  std::vector<int64_t> first(group_ct);
  for (int64_t g = 0; g < group_ct; g++) {
    int64_t v = 0;
    for (int b = 0; b < sid_bytes; b++) v |= (int64_t)r.byte() << (8 * b);
    first[g] = v;
  }
  r.pos += group_ct - 1;  // per-group byte counts: the parse is sequential
  const int64_t rare_pos = r.pos;
  if (with_rare) {
    const int64_t rare_bytes = ((int64_t)L + 3) / 4;
    if (!r.have(rare_bytes)) return false;
    r.pos += rare_bytes;
  }
  int64_t k = 0;
  for (int64_t g = 0; g < group_ct && r.ok; g++) {
    const int64_t cnt = (g + 1 < group_ct) ? 64 : (int64_t)L - 64 * g;
    int64_t cur = first[g];
    for (int64_t i = 0; i < cnt; i++, k++) {
      if (i) cur += r.vint();
      if (!r.ok || cur < 0 || cur >= N) return false;
      visit(k, cur,
            with_rare ? (r.s.data[rare_pos + k / 4] >> (2 * (k % 4))) & 3 : 0);
    }
  }
  return r.ok;
}

// apply a difflist at r.pos to codes: codes[id] = raregeno for each entry
bool apply_difflist(Reader& r, uint8_t* codes) {
  const uint32_t L = r.vint();
  if (!r.ok) return false;
  if (L == 0) return true;
  return parse_ids(r, L, true,
                   [&](int64_t, int64_t id, uint8_t c) { codes[id] = c; });
}

// the hardcall track of a non-LD record; *end is set to the offset just
// past it (where the aux tracks start)
bool decode_non_ld(const Src& s, int64_t vidx, uint8_t* codes, int64_t* end) {
  const int64_t N = s.n_samples;
  const uint32_t vrtype = s.vrtypes[vidx];
  if (vrtype & 8) return false;  // multiallelic
  Reader r(s, s.fpos[vidx]);
  bool ok;
  if (!(vrtype & 4)) {
    if (vrtype & 1) {
      // onebit: [common2 byte][bit array][exception difflist]
      const uint32_t common2 = r.byte();
      const uint8_t base = common2 >> 2, delta = common2 & 3;
      const int64_t nb = (N + 7) / 8;
      if (base + delta > 3 || !r.have(nb)) return false;
      const uint8_t* bits = s.data + r.pos;
      for (int64_t i = 0; i < N; i++)
        codes[i] = base + ((bits[i >> 3] >> (i & 7)) & 1) * delta;
      r.pos += nb;
      ok = apply_difflist(r, codes);
    } else {
      const int64_t nb = (N + 3) / 4;
      if (!r.have(nb)) return false;
      const uint8_t* raw = s.data + r.pos;
      for (int64_t i = 0; i < N; i++)
        codes[i] = (raw[i >> 2] >> (2 * (i & 3))) & 3;
      r.pos += nb;
      ok = true;
    }
  } else if ((vrtype & 3) == 1) {  // all hom-ref, no record bytes
    memset(codes, 0, N);
    ok = true;
  } else {
    memset(codes, vrtype & 3, N);
    ok = apply_difflist(r, codes);
  }
  *end = r.pos;
  return ok;
}

struct Decoder {
  const Src& s;
  std::vector<uint8_t> base;  // codes of the cached LD base variant
  int64_t base_vidx = -1;
  explicit Decoder(const Src& src) : s(src), base(src.n_samples) {}

  // the hardcall codes of variant vidx; *end as in decode_non_ld
  bool decode(int64_t vidx, uint8_t* codes, int64_t* end) {
    const uint32_t vrtype = s.vrtypes[vidx];
    if (vrtype & 8) return false;  // multiallelic
    if ((vrtype & 6) != 2) return decode_non_ld(s, vidx, codes, end);
    int64_t b = vidx - 1;
    while (b >= 0 && (s.vrtypes[b] & 6) == 2) b--;
    if (b < 0) return false;
    if (b != base_vidx) {
      base_vidx = -1;
      int64_t base_end;
      if (!decode_non_ld(s, b, base.data(), &base_end)) return false;
      base_vidx = b;
    }
    const int64_t N = s.n_samples;
    if (vrtype & 1) {  // inverted: hom-ref <-> hom-alt
      for (int64_t i = 0; i < N; i++) {
        const uint8_t c = base[i];
        codes[i] = (c == 0) ? 2 : (c == 2) ? 0 : c;
      }
    } else {
      memcpy(codes, base.data(), N);
    }
    Reader r(s, s.fpos[vidx]);
    const bool ok = apply_difflist(r, codes);
    *end = r.pos;
    return ok;
  }
};

// the ALT dosages of variant vidx into ds [n_samples]: the hardcalls
// (missing -3), then the 16-bit dosage track where vrtype has one
bool dosages(Decoder& dec, int64_t vidx, uint8_t* codes, double* ds) {
  const Src& s = dec.s;
  const int64_t N = s.n_samples;
  int64_t end;
  if (!dec.decode(vidx, codes, &end)) return false;
  for (int64_t i = 0; i < N; i++) ds[i] = codes[i] == 3 ? -3.0 : (double)codes[i];
  const uint32_t vrtype = s.vrtypes[vidx];
  const uint32_t dbits = vrtype & 0x60;
  if (!dbits) return true;
  Reader r(s, end);
  if (vrtype & 0x10) {
    // skip the hardcall-phase track (SkipAux2, pgenlib_read.cc:6819):
    // 1 + het_ct / 8 bytes whose bit 0 says whether a phasepresent
    // bitarray over the hets (bits 1..het_ct) precedes the phase bits
    int64_t het_ct = 0;
    for (int64_t i = 0; i < N; i++) het_ct += codes[i] == 1;
    const int64_t first = 1 + het_ct / 8;
    if (!r.have(first)) return false;
    const uint8_t* p = s.data + r.pos;
    if (p[0] & 1) {
      int64_t pp_ct = 0;
      for (int64_t k = 1; k <= het_ct; k++) pp_ct += (p[k >> 3] >> (k & 7)) & 1;
      r.pos += first + (pp_ct + 7) / 8;
    } else {
      r.pos += first;
    }
  }
  auto val = [&](int64_t k) {
    uint16_t v;
    memcpy(&v, s.data + r.pos + 2 * k, 2);
    return v;
  };
  if (dbits == 0x20) {  // deltalist: ids, then their values
    const uint32_t L = r.vint();
    if (!r.ok) return false;
    if (L == 0) return true;
    std::vector<int64_t> ids(L);
    if (!parse_ids(r, L, false, [&](int64_t k, int64_t id, uint8_t) { ids[k] = id; }))
      return false;
    if (!r.have(2 * (int64_t)L)) return false;
    for (uint32_t k = 0; k < L; k++) ds[ids[k]] = val(k) / 16384.0;
  } else if (dbits == 0x40) {  // dense
    if (!r.have(2 * N)) return false;
    for (int64_t i = 0; i < N; i++) {
      const uint16_t v = val(i);
      ds[i] = v == 65535 ? -3.0 : v / 16384.0;
    }
  } else {  // 0x60: presence bitarray, then the present samples' values
    const int64_t nb = (N + 7) / 8;
    if (!r.have(nb)) return false;
    const uint8_t* present = s.data + r.pos;
    int64_t n_present = 0;
    for (int64_t i = 0; i < N; i++) n_present += (present[i >> 3] >> (i & 7)) & 1;
    r.pos += nb;
    if (!r.have(2 * n_present)) return false;
    int64_t k = 0;
    for (int64_t i = 0; i < N; i++)
      if ((present[i >> 3] >> (i & 7)) & 1) ds[i] = val(k++) / 16384.0;
  }
  return true;
}

const uint8_t kBed[4] = {3, 2, 0, 1};  // PGEN code -> BED code

// BED-coded bytes of rows lo..hi-1 (one row of ceil(n_out / 4) bytes)
int64_t run_bytes(const Src& s, const int64_t* vidx, int64_t lo, int64_t hi,
                  const int64_t* keep, int64_t n_out, uint8_t* out) {
  Decoder dec(s);
  std::vector<uint8_t> codes(s.n_samples);
  const int64_t nb = (n_out + 3) / 4;
  int64_t n_fail = 0;
  for (int64_t v = lo; v < hi; v++) {
    uint8_t* row = out + v * nb;
    memset(row, 0, nb);
    int64_t end;
    if (!dec.decode(vidx[v], codes.data(), &end)) {
      n_fail++;
      continue;
    }
    for (int64_t j = 0; j < n_out; j++) {
      const uint8_t c = codes[keep ? keep[j] : j];
      row[j >> 2] |= kBed[c] << (2 * (j & 3));
    }
  }
  return n_fail;
}

// float64 ALT dosages of rows lo..hi-1 (one row of n_out values)
int64_t run_dosages(const Src& s, const int64_t* vidx, int64_t lo, int64_t hi,
                    const int64_t* keep, int64_t n_out, double* out) {
  Decoder dec(s);
  std::vector<uint8_t> codes(s.n_samples);
  std::vector<double> ds(s.n_samples);
  int64_t n_fail = 0;
  for (int64_t v = lo; v < hi; v++) {
    if (!dosages(dec, vidx[v], codes.data(), ds.data())) {
      n_fail++;
      continue;
    }
    double* row = out + v * n_out;
    for (int64_t j = 0; j < n_out; j++) row[j] = ds[keep ? keep[j] : j];
  }
  return n_fail;
}

// check the indices, then run `work(lo, hi)` on n_threads ranges of the
// variants; returns the failed count (n_var for a bad index)
template <class W>
int64_t run_threads(const Src& s, int64_t n_variants_file, const int64_t* vidx,
                    int64_t n_var, const int64_t* keep, int64_t n_keep,
                    int n_threads, W run) {
  for (int64_t v = 0; v < n_var; v++)
    if (vidx[v] < 0 || vidx[v] >= n_variants_file) return n_var;
  for (int64_t j = 0; keep && j < n_keep; j++)
    if (keep[j] < 0 || keep[j] >= s.n_samples) return n_var;
  int64_t T = n_threads < 1 ? 1 : n_threads;
  if (T > n_var) T = n_var < 1 ? 1 : n_var;
  std::vector<int64_t> fails(T, 0);
  std::vector<std::thread> pool;
  for (int64_t t = 0; t < T; t++) {
    const int64_t lo = n_var * t / T, hi = n_var * (t + 1) / T;
    auto work = [&, t, lo, hi] { fails[t] = run(lo, hi); };
    try {
      pool.emplace_back(work);
    } catch (...) {  // no thread to be had: decode this range here
      work();
    }
  }
  int64_t n_fail = 0;
  for (auto& th : pool) th.join();
  for (int64_t t = 0; t < T; t++) n_fail += fails[t];
  return n_fail;
}

}  // namespace

extern "C" int64_t pgen_bed_bytes(const uint8_t* data, int64_t data_len,
                                  const int64_t* fpos, const uint8_t* vrtypes,
                                  int64_t n_variants_file, const int64_t* vidx,
                                  int64_t n_var, int64_t n_samples_file,
                                  const int64_t* keep, int64_t n_keep,
                                  int n_threads, uint8_t* out) {
  const Src s{data, data_len, fpos, vrtypes, n_samples_file};
  const int64_t n_out = keep ? n_keep : n_samples_file;
  return run_threads(s, n_variants_file, vidx, n_var, keep, n_keep, n_threads,
                     [&](int64_t lo, int64_t hi) {
                       return run_bytes(s, vidx, lo, hi, keep, n_out, out);
                     });
}

extern "C" int64_t pgen_dosages(const uint8_t* data, int64_t data_len,
                                const int64_t* fpos, const uint8_t* vrtypes,
                                int64_t n_variants_file, const int64_t* vidx,
                                int64_t n_var, int64_t n_samples_file,
                                const int64_t* keep, int64_t n_keep,
                                int n_threads, double* out) {
  const Src s{data, data_len, fpos, vrtypes, n_samples_file};
  const int64_t n_out = keep ? n_keep : n_samples_file;
  return run_threads(s, n_variants_file, vidx, n_var, keep, n_keep, n_threads,
                     [&](int64_t lo, int64_t hi) {
                       return run_dosages(s, vidx, lo, hi, keep, n_out, out);
                     });
}
