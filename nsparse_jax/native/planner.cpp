// SpGEMM symbolic-phase planner (host, C++, multithreaded).
//
// Native analog of the reference's symbolic phase (set_row_nnz,
// cuda-c/src/kernel/kernel_spgemm_hash_template.cu) for the JAX rebuild:
// the sparsity of C = A @ B is host precompute (its size must reach the
// host anyway to allocate C), so it is computed natively — expansion of
// intermediate products, a per-row sort by column (the ESC formulation
// replacing the reference's shared-memory hash tables), and boundary
// compaction into gather/segment indices the device numeric phase consumes.
//
// Parallelism: rows are partitioned across threads balanced by product
// count (the role of the reference's FLOP binning, set_max_bin) — each
// thread sorts its rows' product lists independently; a prefix sum over
// per-row unique counts then fixes global output slots in a second
// parallel pass.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Prod {
  int32_t col;
  int32_t apos;
  int32_t bpos;
};

int n_threads() {
  unsigned hc = std::thread::hardware_concurrency();
  if (hc == 0) hc = 4;
  if (hc > 64) hc = 64;
  return static_cast<int>(hc);
}

// Partition rows [0, m) into nt chunks with roughly equal product counts.
std::vector<int64_t> balance_rows(const int64_t* prodoff, int64_t m, int nt) {
  std::vector<int64_t> bounds(nt + 1, m);
  bounds[0] = 0;
  const int64_t total = prodoff[m];
  for (int t = 1; t < nt; ++t) {
    const int64_t target = total * t / nt;
    bounds[t] = std::lower_bound(prodoff, prodoff + m + 1, target) - prodoff;
  }
  std::sort(bounds.begin(), bounds.end());
  return bounds;
}

}  // namespace

extern "C" {

// Returns c_nnz (>= 0) or -1 on error.  All buffers caller-allocated:
//   apos/bpos/out_pos: size P;  c_rpt: m+1;  c_col: size >= P (upper bound);
//   prodoff: scratch, size m+1 (also an output: per-row product offsets).
int64_t nsp_spgemm_plan(const int32_t* rpt_a, const int32_t* col_a, int64_t m,
                        const int32_t* rpt_b, const int32_t* col_b,
                        int32_t* apos, int32_t* bpos, int32_t* out_pos,
                        int32_t* c_rpt, int32_t* c_col, int64_t* prodoff,
                        int64_t P) {
  if (m < 0 || P < 0) return -1;

  // per-row product offsets
  prodoff[0] = 0;
  for (int64_t i = 0; i < m; ++i) {
    int64_t cnt = 0;
    for (int32_t e = rpt_a[i]; e < rpt_a[i + 1]; ++e) {
      const int32_t k = col_a[e];
      cnt += rpt_b[k + 1] - rpt_b[k];
    }
    prodoff[i + 1] = prodoff[i] + cnt;
  }
  if (prodoff[m] != P) return -1;

  const int nt = n_threads();
  std::vector<int64_t> bounds = balance_rows(prodoff, m, nt);
  std::vector<int64_t> uniq(m, 0);  // per-row output nnz

  // Pass 1: expand + sort each row's products by column; record local ids.
  // out_pos temporarily holds the row-local unique index.
  std::vector<std::thread> threads;
  threads.reserve(nt);
  for (int t = 0; t < nt; ++t) {
    threads.emplace_back([&, t]() {
      std::vector<Prod> buf;
      for (int64_t i = bounds[t]; i < bounds[t + 1]; ++i) {
        const int64_t base = prodoff[i];
        const int64_t cnt = prodoff[i + 1] - base;
        if (cnt == 0) continue;
        buf.clear();
        buf.reserve(static_cast<size_t>(cnt));
        for (int32_t e = rpt_a[i]; e < rpt_a[i + 1]; ++e) {
          const int32_t k = col_a[e];
          for (int32_t f = rpt_b[k]; f < rpt_b[k + 1]; ++f) {
            buf.push_back(Prod{col_b[f], e, f});
          }
        }
        std::stable_sort(buf.begin(), buf.end(),
                         [](const Prod& x, const Prod& y) {
                           return x.col < y.col;
                         });
        int64_t u = -1;
        int32_t prev = -1;
        for (int64_t j = 0; j < cnt; ++j) {
          const Prod& p = buf[static_cast<size_t>(j)];
          if (p.col != prev) {
            ++u;
            prev = p.col;
            c_col[base + u] = p.col;  // staged at product offset; compacted later
          }
          apos[base + j] = p.apos;
          bpos[base + j] = p.bpos;
          out_pos[base + j] = static_cast<int32_t>(u);
        }
        uniq[i] = u + 1;
      }
    });
  }
  for (auto& th : threads) th.join();

  // c_rpt = prefix of per-row unique counts
  c_rpt[0] = 0;
  for (int64_t i = 0; i < m; ++i) {
    c_rpt[i + 1] = c_rpt[i] + static_cast<int32_t>(uniq[i]);
  }
  const int64_t c_nnz = c_rpt[m];

  // Pass 2: globalize out_pos; compact staged c_col (front-to-back is safe:
  // c_rpt[i] <= prodoff[i] always, so reads stay ahead of writes).
  threads.clear();
  for (int t = 0; t < nt; ++t) {
    threads.emplace_back([&, t]() {
      for (int64_t i = bounds[t]; i < bounds[t + 1]; ++i) {
        const int64_t base = prodoff[i];
        const int64_t cnt = prodoff[i + 1] - base;
        const int32_t coff = c_rpt[i];
        for (int64_t j = 0; j < cnt; ++j) out_pos[base + j] += coff;
      }
    });
  }
  for (auto& th : threads) th.join();
  for (int64_t i = 0; i < m; ++i) {
    const int64_t base = prodoff[i];
    const int32_t coff = c_rpt[i];
    const int64_t u = uniq[i];
    if (base != coff) {
      std::memmove(c_col + coff, c_col + base,
                   static_cast<size_t>(u) * sizeof(int32_t));
    }
  }
  return c_nnz;
}

}  // extern "C"
