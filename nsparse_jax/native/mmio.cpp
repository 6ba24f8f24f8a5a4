// Fast Matrix Market coordinate reader (native host runtime component).
//
// Semantics match nsparse_jax.io.matrix_market.read_mtx_arrays, which in turn
// mirrors the reference's convert_file_csr (cuda-c/src/nsparse.cu:14-136):
//   - symmetrize unless the banner contains "general" (skew negates mirrors)
//   - missing value field -> 1.0 (pattern matrices)
//   - complex: keep real part
//   - 1-based -> 0-based
//
// Exposed via a small 3-call ctypes protocol (read -> fill -> free) so the
// Python side can allocate NumPy arrays of exactly the right size.

#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Parsed {
  std::vector<int64_t> rows, cols;
  std::vector<double> vals;
  int64_t m = 0, n = 0;
};

Parsed *g_state = nullptr;

// Parse one signed integer, advancing p past it and following spaces.
inline bool parse_ll(const char *&p, const char *end, int64_t &out) {
  while (p < end && (*p == ' ' || *p == '\t')) ++p;
  if (p >= end) return false;
  bool neg = false;
  if (*p == '-') { neg = true; ++p; }
  if (p >= end || !isdigit((unsigned char)*p)) return false;
  int64_t v = 0;
  while (p < end && isdigit((unsigned char)*p)) v = v * 10 + (*p++ - '0');
  out = neg ? -v : v;
  return true;
}

inline bool parse_double(const char *&p, const char *end, double &out) {
  while (p < end && (*p == ' ' || *p == '\t')) ++p;
  if (p >= end || *p == '\n' || *p == '\r') return false;
  char *q = nullptr;
  out = strtod(p, &q);
  if (q == p) return false;
  p = q;
  return true;
}

}  // namespace

extern "C" {

// Returns 0 on success (-1 on failure); outputs matrix dims and the
// post-symmetrization nnz. Parsed data is held until nsp_free_mtx.
int64_t nsp_read_mtx(const char *path, int64_t *out_m, int64_t *out_n,
                     int64_t *out_nnz) {
  FILE *f = fopen(path, "rb");
  if (!f) return -1;
  fseek(f, 0, SEEK_END);
  long sz = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::string buf;
  buf.resize(sz);
  if (sz > 0 && fread(&buf[0], 1, sz, f) != (size_t)sz) {
    fclose(f);
    return -1;
  }
  fclose(f);

  const char *p = buf.data();
  const char *end = p + buf.size();

  // banner
  const char *eol = (const char *)memchr(p, '\n', end - p);
  if (!eol) return -1;
  std::string banner(p, eol);
  for (auto &ch : banner) ch = (char)tolower((unsigned char)ch);
  if (banner.find("%%matrixmarket") == std::string::npos) return -1;
  if (banner.find("coordinate") == std::string::npos) return -1;
  bool general = banner.find("general") != std::string::npos;
  bool skew = banner.find("skew-symmetric") != std::string::npos;
  bool pattern = banner.find("pattern") != std::string::npos;
  p = eol + 1;

  // comments
  while (p < end && *p == '%') {
    eol = (const char *)memchr(p, '\n', end - p);
    if (!eol) return -1;
    p = eol + 1;
  }

  int64_t m, n, nz;
  if (!parse_ll(p, end, m) || !parse_ll(p, end, n) || !parse_ll(p, end, nz))
    return -1;
  eol = (const char *)memchr(p, '\n', end - p);
  p = eol ? eol + 1 : end;

  auto *st = new Parsed();
  st->m = m;
  st->n = n;
  size_t cap = general ? (size_t)nz : (size_t)nz * 2;
  st->rows.reserve(cap);
  st->cols.reserve(cap);
  st->vals.reserve(cap);

  for (int64_t i = 0; i < nz; ++i) {
    int64_t r, c;
    double v = 1.0;
    if (!parse_ll(p, end, r) || !parse_ll(p, end, c)) {
      delete st;
      return -1;
    }
    if (!pattern) {
      double tmp;
      if (parse_double(p, end, tmp)) v = tmp;  // else pattern-like line -> 1.0
    }
    eol = (const char *)memchr(p, '\n', end - p);
    p = eol ? eol + 1 : end;
    --r;
    --c;
    st->rows.push_back(r);
    st->cols.push_back(c);
    st->vals.push_back(v);
    if (!general && r != c) {
      st->rows.push_back(c);
      st->cols.push_back(r);
      st->vals.push_back(skew ? -v : v);
    }
  }

  if (g_state) delete g_state;
  g_state = st;
  *out_m = m;
  *out_n = n;
  *out_nnz = (int64_t)st->rows.size();
  return 0;
}

int nsp_fill_mtx(int64_t *rows, int64_t *cols, double *vals) {
  if (!g_state) return -1;
  memcpy(rows, g_state->rows.data(), g_state->rows.size() * sizeof(int64_t));
  memcpy(cols, g_state->cols.data(), g_state->cols.size() * sizeof(int64_t));
  memcpy(vals, g_state->vals.data(), g_state->vals.size() * sizeof(double));
  return 0;
}

void nsp_free_mtx() {
  delete g_state;
  g_state = nullptr;
}

}  // extern "C"
