// LOCO/PRS prediction rows (write_predictions, Data.cpp:1795): R rows of
// "label v_1 .. v_N \n" with %g values (6 significant digits, the "C"
// numeric locale) and NA for masked samples. The port's own copy of
// format_loco_rows in native/decoder.cpp, without OpenMP: one call
// formats a range of rows on the calling thread, and callers run ranges
// on threads of their own (ctypes releases the GIL during the call). It
// touches only its arguments, so calls on disjoint outputs may run at
// once.
//
//   g++ -O3 -fPIC -shared -o libloco_rows.so loco_rows.cpp

#include <clocale>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <locale.h>

namespace {

locale_t c_numeric_locale() {
  // a function-local static is initialised once, thread-safely (C++11)
  static locale_t loc = newlocale(LC_NUMERIC_MASK, "C", (locale_t)0);
  return loc;
}

}  // namespace

extern "C" {

// Bytes `out` must hold for R rows of N values.
int64_t loco_rows_budget(int64_t R, int64_t N) { return R * (16 + 15 * N); }

// vals [R, N] row-major, mask [N] (0 = NA), labels [R]. Each row is
// written at out + r * (16 + 15 N), then the rows are moved together
// front to back. Returns the bytes written; row_len[r] holds each row's.
int64_t format_loco_rows(const double* vals, int64_t R, int64_t N,
                         const uint8_t* mask, const int32_t* labels,
                         char* out, int64_t* row_len) {
  const int64_t budget = 16 + 15 * N;
  locale_t prev = uselocale(c_numeric_locale());
  for (int64_t r = 0; r < R; r++) {
    char* q = out + r * budget;
    const char* p = q;
    q += snprintf(q, 16, "%d", labels[r]);
    const double* v = vals + r * N;
    for (int64_t i = 0; i < N; i++) {
      if (!mask[i]) {
        memcpy(q, " NA", 3);
        q += 3;
      } else if (std::isnan(v[i])) {
        memcpy(q, " nan", 4);
        q += 4;
      } else {
        *q++ = ' ';
        q += snprintf(q, 32, "%g", v[i]);
      }
    }
    memcpy(q, " \n", 2);
    q += 2;
    row_len[r] = q - p;
  }
  uselocale(prev);
  int64_t total = 0;
  for (int64_t r = 0; r < R; r++) {
    const char* src = out + r * budget;
    if (out + total != src) memmove(out + total, src, row_len[r]);
    total += row_len[r];
  }
  return total;
}

}  // extern "C"
