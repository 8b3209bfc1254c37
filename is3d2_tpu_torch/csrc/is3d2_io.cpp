// Native I/O runtime for is3d2_tpu_torch: the port's own copy of the JAX
// package's csrc/is3d2_io.cpp, built with g++ at first use by
// is3d2_tpu_torch/io/fastio.py and called through ctypes.
//
// Fast whitespace-separated numeric table parser (the freezeout-surface
// files are 100s of MB of text for production MUSIC surfaces; this replaces
// numpy.loadtxt on the hot ingest path).  Threaded chunk parsing with a
// final stitch.
//
// API:
//   i3d_count_rows(path, n_cols_out) -> n_rows (also reports column count of
//                                       the first row)
//   i3d_parse(path, out, capacity)   -> n_values parsed into out (row-major)

#include <cfloat>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cerrno>
#include <cstdint>
#include <vector>
#include <thread>

extern "C" {

// read whole file into a malloc'd buffer (returns size, buffer via out)
static char *read_file(const char *path, size_t *size_out) {
  FILE *f = fopen(path, "rb");
  if (!f) return nullptr;
  fseek(f, 0, SEEK_END);
  long sz = ftell(f);
  fseek(f, 0, SEEK_SET);
  char *buf = (char *)malloc((size_t)sz + 1);
  if (!buf) { fclose(f); return nullptr; }
  size_t rd = fread(buf, 1, (size_t)sz, f);
  fclose(f);
  buf[rd] = '\0';
  *size_out = rd;
  return buf;
}

static inline bool is_ws(char c) {
  return c == ' ' || c == '\t' || c == '\n' || c == '\r' || c == '\f' || c == '\v';
}

// parse one chunk [begin, end) of the buffer into vals.
// '#' starts a comment running to end-of-line (numpy.loadtxt semantics) —
// numerals inside comments must not be parsed as data.
static void parse_chunk(const char *begin, const char *end,
                        std::vector<double> *vals) {
  const char *p = begin;
  while (p < end) {
    while (p < end && is_ws(*p)) p++;
    if (p >= end) break;
    if (*p == '#') {  // comment: skip to end of line
      while (p < end && *p != '\n') p++;
      continue;
    }
    char *next = nullptr;
    double v = strtod(p, &next);
    if (next == p) { p++; continue; }  // skip unparsable byte
    vals->push_back(v);
    p = next;
  }
}

long long i3d_count_rows(const char *path, long long *n_cols_out) {
  size_t size;
  char *buf = read_file(path, &size);
  if (!buf) return -1;
  long long rows = 0, cols = 0;
  bool counted_cols = false;
  const char *p = buf;
  const char *end = buf + size;
  while (p < end) {
    // skip leading whitespace of the line (but not the newline logic below)
    const char *line_start = p;
    bool has_token = false;
    long long line_cols = 0;
    while (p < end && *p != '\n') {
      if (*p == '#') {  // comment: rest of line is not data
        while (p < end && *p != '\n') p++;
        break;
      }
      if (!is_ws(*p)) {
        has_token = true;
        line_cols++;
        while (p < end && *p != '\n' && !is_ws(*p) && *p != '#') p++;
      } else {
        p++;
      }
    }
    if (p < end) p++;  // consume newline
    if (has_token) {
      rows++;
      if (!counted_cols) { cols = line_cols; counted_cols = true; }
    }
    (void)line_start;
  }
  free(buf);
  if (n_cols_out) *n_cols_out = cols;
  return rows;
}

long long i3d_parse(const char *path, double *out, long long capacity) {
  size_t size;
  char *buf = read_file(path, &size);
  if (!buf) return -1;

  unsigned n_threads = std::thread::hardware_concurrency();
  if (n_threads == 0) n_threads = 1;
  if (n_threads > 16) n_threads = 16;
  if (size < (size_t)1 << 20) n_threads = 1;

  // split at LINE boundaries: a comment runs to end-of-line, so chunk
  // boundaries must never fall inside a line or a '#'-comment's tail would
  // be parsed as data by the next thread
  std::vector<const char *> splits(n_threads + 1);
  splits[0] = buf;
  splits[n_threads] = buf + size;
  for (unsigned t = 1; t < n_threads; t++) {
    const char *p = buf + (size * t) / n_threads;
    while (p < buf + size && *p != '\n') p++;
    splits[t] = p;
  }

  std::vector<std::vector<double>> parts(n_threads);
  std::vector<std::thread> threads;
  for (unsigned t = 0; t < n_threads; t++) {
    parts[t].reserve(size / (12 * n_threads) + 16);
    threads.emplace_back(parse_chunk, splits[t], splits[t + 1], &parts[t]);
  }
  for (auto &th : threads) th.join();
  free(buf);

  long long total = 0;
  for (auto &part : parts) total += (long long)part.size();
  if (total > capacity) return -2;

  long long off = 0;
  for (auto &part : parts) {
    memcpy(out + off, part.data(), part.size() * sizeof(double));
    off += (long long)part.size();
  }
  return total;
}

// ----------------------------------------------------------------------
// Threaded per-event particle-list writer (the reverse hot path: an
// oversampling run exports ~1e7 hadrons across up to 1e3 event files).
//
//   path_pattern     printf pattern with one %lld for the 1-based event id
//   header           first line of every file (newline appended)
//   sep              column separator (' ' or ',')
//   precision        digits for %.Ne formatting
//   include_counter  1 -> per-file row counter as the first column (OSCAR)
//   offsets          (n_events+1) row offsets; event e owns [off[e], off[e+1])
//   mcid             per-row particle id column
//   cols/n_cols      column-major double arrays, all of length offsets[n_events]
//
// Fast "%.*e" for precision <= 17: scale into [1, 10) with a long-double
// power-of-ten table (64-bit mantissa keeps the digit string correctly
// rounded except for rare 1-in-last-digit ties), then emit digits with
// integer ops; glibc's snprintf takes its general multiprecision path for
// %.16e.  Non-finite values fall back to snprintf.
static long double POW10L[700];  // 10^(i-323), covers subnormals' 10^324 scale
static bool pow10l_init_done = false;
static void pow10l_init() {
  for (int i = 0; i < 700; i++) POW10L[i] = powl(10.0L, (long double)(i - 323));
  pow10l_init_done = true;
}
static const char DIGIT2[201] =
    "00010203040506070809101112131415161718192021222324"
    "25262728293031323334353637383940414243444546474849"
    "50515253545556575859606162636465666768697071727374"
    "75767778798081828384858687888990919293949596979899";

static inline int format_e(char *out, double x, int precision) {
#if LDBL_MANT_DIG < 64
  // the digit-string rounding below needs a >=64-bit long-double mantissa
  // (x87/f128); where long double == double (MSVC, Apple arm64) fall back
  // to snprintf so the last digit stays exactly rounded
  return snprintf(out, 64, "%.*e", precision, x);
#else
  if (!(x == x) || x - x != 0.0 || precision > 17)  // nan, +-inf, odd prec
    return snprintf(out, 64, "%.*e", precision, x);
  char *p = out;
  if (std::signbit(x)) { *p++ = '-'; x = -x; }
  int e10 = 0;
  unsigned long long digits;
  const unsigned long long scale =
      (unsigned long long)llroundl(POW10L[precision + 323]);  // 10^precision
  if (x == 0.0) {
    digits = 0;
  } else {
    // decimal exponent estimate from the binary exponent (log10(2) slope);
    // at most one off, corrected after rounding below
    e10 = (int)((long long)(ilogb(x) * 19728) >> 16);  // 19728/65536~log10(2)
    if (e10 < -324) e10 = -324;
    long double m = (long double)x * POW10L[323 - e10];
    digits = (unsigned long long)llroundl(m * (long double)scale);
    // re-round at the corrected exponent (dividing the digit string would
    // truncate instead of round)
    while (digits >= 10ULL * scale) {
      e10++;
      m = (long double)x * POW10L[323 - e10];
      digits = (unsigned long long)llroundl(m * (long double)scale);
    }
    while (digits < scale && digits != 0) {
      e10--;
      m = (long double)x * POW10L[323 - e10];
      digits = (unsigned long long)llroundl(m * (long double)scale);
    }
  }
  // emit precision+1 significant digits: d.ddd...
  char tmp[24];
  int nd = precision + 1;
  for (int i = nd; i > 1; i -= 2) {
    unsigned rem = (unsigned)(digits % 100ULL);
    digits /= 100ULL;
    tmp[i - 1] = DIGIT2[rem * 2 + 1];
    tmp[i - 2] = DIGIT2[rem * 2];
  }
  if (nd & 1) tmp[0] = (char)('0' + (unsigned)(digits % 10ULL));
  *p++ = tmp[0];
  *p++ = '.';
  memcpy(p, tmp + 1, (size_t)precision);
  p += precision;
  *p++ = 'e';
  if (e10 < 0) { *p++ = '-'; e10 = -e10; } else *p++ = '+';
  if (e10 >= 100) { *p++ = (char)('0' + e10 / 100); e10 %= 100; }
  *p++ = DIGIT2[e10 * 2];
  *p++ = DIGIT2[e10 * 2 + 1];
  return (int)(p - out);
#endif  // LDBL_MANT_DIG >= 64
}

// Rows must be pre-sorted by event (Python does one argsort).  Local event e
// writes file id event_base + e + 1, so a streaming caller can export one
// chunk's slice [event_base, event_base + n_events) of a larger campaign.
// Returns the number of rows written, or -1 on I/O failure.
long long i3d_write_events(const char *path_pattern, const char *header,
                           char sep, int precision, int include_counter,
                           long long event_base,
                           long long n_events, const long long *offsets,
                           const long long *mcid,
                           const double *const *cols, int n_cols) {
  unsigned n_threads = std::thread::hardware_concurrency();
  if (n_threads == 0) n_threads = 1;
  if (n_threads > 16) n_threads = 16;
  if ((unsigned long long)n_events < n_threads) n_threads = (unsigned)n_events;
  if (n_threads == 0) n_threads = 1;

  std::vector<long long> written(n_threads, 0);
  std::vector<int> failed(n_threads, 0);
  if (!pow10l_init_done) pow10l_init();

  // fast signed itoa (DIGIT2 pairs)
  auto format_ll = [](char *out, long long v) -> int {
    char *p = out;
    unsigned long long u = (unsigned long long)v;
    if (v < 0) { *p++ = '-'; u = (unsigned long long)(-v); }
    char tmp[24];
    int n = 0;
    while (u >= 100) {
      unsigned rem = (unsigned)(u % 100ULL);
      u /= 100ULL;
      tmp[n++] = DIGIT2[rem * 2 + 1];
      tmp[n++] = DIGIT2[rem * 2];
    }
    if (u >= 10) {
      tmp[n++] = DIGIT2[u * 2 + 1];
      tmp[n++] = DIGIT2[u * 2];
    } else {
      tmp[n++] = (char)('0' + u);
    }
    while (n) *p++ = tmp[--n];
    return (int)(p - out);
  };

  auto work = [&](unsigned t) {
    // raw cursor into a flush buffer: per-token vector inserts cost as much
    // as the formatting itself at this precision
    const size_t BUF = 1 << 20;
    std::vector<char> buf(BUF + 4096);
    char path[4096];
    for (long long e = t; e < n_events; e += n_threads) {
      snprintf(path, sizeof path, path_pattern, event_base + e + 1);
      FILE *f = fopen(path, "wb");
      if (!f) { failed[t] = 1; return; }
      char *w = buf.data();
      size_t hlen = strlen(header);
      memcpy(w, header, hlen);
      w += hlen;
      *w++ = '\n';
      long long row_in_file = 0;
      for (long long r = offsets[e]; r < offsets[e + 1]; r++) {
        if (include_counter) {
          w += format_ll(w, row_in_file);
          *w++ = sep;
        }
        w += format_ll(w, mcid[r]);
        for (int c = 0; c < n_cols; c++) {
          *w++ = sep;
          w += format_e(w, cols[c][r], precision);
        }
        *w++ = '\n';
        row_in_file++;
        size_t used = (size_t)(w - buf.data());
        if (used > BUF) {
          if (fwrite(buf.data(), 1, used, f) != used) {
            failed[t] = 1; fclose(f); return;
          }
          w = buf.data();
        }
      }
      size_t used = (size_t)(w - buf.data());
      if (used &&
          fwrite(buf.data(), 1, used, f) != used) {
        failed[t] = 1; fclose(f); return;
      }
      fclose(f);
      written[t] += offsets[e + 1] - offsets[e];
    }
  };

  std::vector<std::thread> threads;
  for (unsigned t = 0; t < n_threads; t++) threads.emplace_back(work, t);
  for (auto &th : threads) th.join();

  long long total = 0;
  for (unsigned t = 0; t < n_threads; t++) {
    if (failed[t]) return -1;
    total += written[t];
  }
  return total;
}


// Generic per-file block-table writer: n_files text files (path_pattern %
// file_ids[i]), each file the rows [offsets[i], offsets[i+1]) of the shared
// float columns, with an optional blank line after every `blank_every` rows
// (blank_tail: also after the final block).  Threaded over files like
// i3d_write_events -- the op-1 continuous writers emit one file per species
// (hundreds) of ~2500-110000 rows each.
long long i3d_write_blocks(const char *path_pattern, const char *header,
                           char sep, int precision,
                           long long n_files, const long long *file_ids,
                           const long long *offsets,
                           const double *const *cols, int n_cols,
                           long long blank_every, int blank_tail) {
  unsigned n_threads = std::thread::hardware_concurrency();
  if (n_threads == 0) n_threads = 1;
  if (n_threads > 16) n_threads = 16;
  if ((unsigned long long)n_files < n_threads) n_threads = (unsigned)n_files;
  if (n_threads == 0) n_threads = 1;

  std::vector<long long> written(n_threads, 0);
  std::vector<int> failed(n_threads, 0);
  if (!pow10l_init_done) pow10l_init();

  auto work = [&](unsigned t) {
    const size_t BUF = 1 << 20;
    std::vector<char> buf(BUF + 4096);
    char path[4096];
    for (long long e = t; e < n_files; e += n_threads) {
      snprintf(path, sizeof path, path_pattern, file_ids[e]);
      FILE *f = fopen(path, "wb");
      if (!f) { failed[t] = 1; return; }
      char *w = buf.data();
      size_t hlen = strlen(header);
      if (hlen) {
        memcpy(w, header, hlen);
        w += hlen;
        *w++ = '\n';
      }
      long long row_in_block = 0;
      long long last = offsets[e + 1] - 1;
      for (long long r = offsets[e]; r < offsets[e + 1]; r++) {
        for (int c = 0; c < n_cols; c++) {
          if (c) *w++ = sep;
          w += format_e(w, cols[c][r], precision);
        }
        *w++ = '\n';
        if (blank_every > 0 && ++row_in_block == blank_every) {
          row_in_block = 0;
          if (blank_tail || r != last) *w++ = '\n';
        }
        size_t used = (size_t)(w - buf.data());
        if (used > BUF) {
          if (fwrite(buf.data(), 1, used, f) != used) {
            failed[t] = 1; fclose(f); return;
          }
          w = buf.data();
        }
      }
      size_t used = (size_t)(w - buf.data());
      if (used && fwrite(buf.data(), 1, used, f) != used) {
        failed[t] = 1; fclose(f); return;
      }
      fclose(f);
      written[t] += offsets[e + 1] - offsets[e];
    }
  };

  std::vector<std::thread> threads;
  for (unsigned t = 0; t < n_threads; t++) threads.emplace_back(work, t);
  for (auto &th : threads) th.join();

  long long total = 0;
  for (unsigned t = 0; t < n_threads; t++) {
    if (failed[t]) return -1;
    total += written[t];
  }
  return total;
}

// ---------------------------------------------------------------------
// Walker alias tables for the sampler's per-hadron species draw.
//
// Vose's O(S) construction per cell (inherently sequential per cell: a
// small/large stack pairing), threaded over cells.  The draw on the device
// is then two gathers per hadron (prob + alias) from (C, S) tables.  Built
// in f64; the stored f32 prob rounds each species probability by <= 2^-24
// relative.
long long i3d_build_alias(const double *rates, long long C, long long S,
                          float *prob, int *alias_idx, int n_threads_req) {
  if (C <= 0 || S <= 0 || S > 0x7FFF) return -1;
  unsigned n_threads = n_threads_req > 0
      ? (unsigned)n_threads_req
      : std::max(1u, std::thread::hardware_concurrency());
  if ((long long)n_threads > C) n_threads = (unsigned)C;

  auto work = [&](unsigned t) {
    std::vector<int> small((size_t)S), large((size_t)S);
    std::vector<double> p((size_t)S);
    long long c0 = C * t / n_threads, c1 = C * (t + 1) / n_threads;
    for (long long c = c0; c < c1; c++) {
      const double *r = rates + c * S;
      float *pb = prob + c * S;
      int *ab = alias_idx + c * S;
      double tot = 0.0;
      for (long long s = 0; s < S; s++) tot += r[s] > 0.0 ? r[s] : 0.0;
      if (!(tot > 0.0)) {  // masked/empty cell: uniform table, never drawn
        for (long long s = 0; s < S; s++) { pb[s] = 1.0f; ab[s] = (int)s; }
        continue;
      }
      int ns = 0, nl = 0;
      double scale = (double)S / tot;
      for (long long s = 0; s < S; s++) {
        p[s] = (r[s] > 0.0 ? r[s] : 0.0) * scale;
        if (p[s] < 1.0) small[ns++] = (int)s; else large[nl++] = (int)s;
      }
      while (ns && nl) {
        int s = small[--ns], l = large[--nl];
        pb[s] = (float)p[s];
        ab[s] = l;
        p[l] = (p[l] + p[s]) - 1.0;
        if (p[l] < 1.0) small[ns++] = l; else large[nl++] = l;
      }
      // leftovers are exactly-1 columns (f64 roundoff aside)
      while (nl) { int l = large[--nl]; pb[l] = 1.0f; ab[l] = l; }
      while (ns) { int s = small[--ns]; pb[s] = 1.0f; ab[s] = s; }
    }
  };

  std::vector<std::thread> threads;
  for (unsigned t = 0; t < n_threads; t++) threads.emplace_back(work, t);
  for (auto &th : threads) th.join();
  return C * S;
}

}  // extern "C"
