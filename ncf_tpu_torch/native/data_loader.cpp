// Native host-side data pipeline ops: the port's copy of
// ncf_tpu/native/data_loader.cpp (same ABI, same results).
//
// The reference's input pipeline burns its time in per-row Python:
// rejection sampling per item (reference: src/model/data_prep.py:134-161),
// per-element collate loops (:251-283) and chunked pandas history building
// (:163-176).  Device-side sampling covers the train path; this library
// covers the host-side paths that must stay exact (eval candidate sets,
// history CSR construction) at C++ speed for 100M-row logs.
//
// Exposed C ABI (ctypes-bound in ncf_tpu_torch/native/__init__.py):
//   ncf_build_histories   — per-user CSR of sorted item histories
//   ncf_sample_negatives  — weighted (alias-method) negative sampling with
//                           exact per-user-history exclusion, the
//                           _sample_negative semantics (<=R rejection
//                           rounds, then linear fallback scan)
//   ncf_shuffled_indices  — fast epoch permutation (SplitMix64 + Fisher-Yates)
//
// Build: at first use, by ncf_tpu_torch/native/__init__.py with the flags
// of ncf_tpu/native/Makefile (g++ -O3 -shared -fPIC)

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------- RNG

static inline uint64_t splitmix64(uint64_t* s) {
  uint64_t z = (*s += 0x9E3779B97F4A7C15ULL);
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
  return z ^ (z >> 31);
}

static inline double uniform01(uint64_t* s) {
  return (double)(splitmix64(s) >> 11) * (1.0 / 9007199254740992.0);
}

// ------------------------------------------------------- histories CSR

// user_ids/item_ids: int32[n]; offsets_out: int64[num_users+1];
// items_out: int32[n] (sorted within each user's segment).
void ncf_build_histories(const int32_t* user_ids, const int32_t* item_ids,
                         int64_t n, int32_t num_users,
                         int64_t* offsets_out, int32_t* items_out) {
  std::vector<int64_t> counts(num_users + 1, 0);
  for (int64_t i = 0; i < n; ++i) counts[user_ids[i] + 1]++;
  for (int32_t u = 0; u < num_users; ++u) counts[u + 1] += counts[u];
  std::memcpy(offsets_out, counts.data(), sizeof(int64_t) * (num_users + 1));
  std::vector<int64_t> cursor(counts.begin(), counts.end() - 1);
  for (int64_t i = 0; i < n; ++i)
    items_out[cursor[user_ids[i]]++] = item_ids[i];
  for (int32_t u = 0; u < num_users; ++u)
    std::sort(items_out + offsets_out[u], items_out + offsets_out[u + 1]);
}

// ----------------------------------------------------- alias sampling

struct AliasTable {
  std::vector<double> prob;
  std::vector<int32_t> alias;
};

static void build_alias(const double* w, int32_t n, AliasTable* t) {
  t->prob.resize(n);
  t->alias.resize(n);
  double sum = 0;
  for (int32_t i = 0; i < n; ++i) sum += w[i];
  std::vector<double> scaled(n);
  for (int32_t i = 0; i < n; ++i) scaled[i] = w[i] * n / (sum > 0 ? sum : 1);
  std::vector<int32_t> small, large;
  small.reserve(n);
  large.reserve(n);
  for (int32_t i = 0; i < n; ++i)
    (scaled[i] < 1.0 ? small : large).push_back(i);
  while (!small.empty() && !large.empty()) {
    int32_t s = small.back(); small.pop_back();
    int32_t l = large.back(); large.pop_back();
    t->prob[s] = scaled[s];
    t->alias[s] = l;
    scaled[l] = scaled[l] + scaled[s] - 1.0;
    (scaled[l] < 1.0 ? small : large).push_back(l);
  }
  for (int32_t i : small) { t->prob[i] = 1.0; t->alias[i] = i; }
  for (int32_t i : large) { t->prob[i] = 1.0; t->alias[i] = i; }
}

static inline int32_t alias_draw(const AliasTable& t, uint64_t* s) {
  int32_t n = (int32_t)t.prob.size();
  int32_t k = (int32_t)(splitmix64(s) % (uint64_t)n);
  return uniform01(s) < t.prob[k] ? k : t.alias[k];
}

static inline bool in_sorted(const int32_t* begin, const int32_t* end,
                             int32_t x) {
  return std::binary_search(begin, end, x);
}

// For each of n rows: draw num_neg negatives from weights[num_items],
// excluding the row's user full history (CSR) and its positive item.
// <= max_rounds weighted draws per slot, then a linear scan fallback over
// the catalog (the reference's exact-fallback, data_prep.py:150-161).
void ncf_sample_negatives(const int32_t* users, const int32_t* pos_items,
                          int64_t n, const double* weights,
                          int32_t num_items, int32_t num_neg,
                          const int64_t* hist_offsets,
                          const int32_t* hist_items, uint64_t seed,
                          int32_t max_rounds, int32_t* out /*[n*num_neg]*/) {
  AliasTable alias;
  build_alias(weights, num_items, &alias);
  uint64_t state = seed ? seed : 0x853C49E6748FEA9BULL;
  for (int64_t i = 0; i < n; ++i) {
    const int32_t* h0 = hist_items + hist_offsets[users[i]];
    const int32_t* h1 = hist_items + hist_offsets[users[i] + 1];
    for (int32_t j = 0; j < num_neg; ++j) {
      int32_t cand = -1;
      for (int32_t r = 0; r < max_rounds; ++r) {
        int32_t c = alias_draw(alias, &state);
        if (c != pos_items[i] && !in_sorted(h0, h1, c)) { cand = c; break; }
      }
      if (cand < 0) {
        // exact fallback: scan from a random start for the first
        // non-excluded item
        int32_t start = (int32_t)(splitmix64(&state) % (uint64_t)num_items);
        for (int32_t d = 0; d < num_items; ++d) {
          int32_t c = (start + d) % num_items;
          if (c != pos_items[i] && !in_sorted(h0, h1, c)) { cand = c; break; }
        }
        if (cand < 0) cand = (pos_items[i] + 1) % num_items;  // degenerate
      }
      out[i * num_neg + j] = cand;
    }
  }
}

// --------------------------------------------------------- permutation

void ncf_shuffled_indices(int64_t n, uint64_t seed, int64_t* out) {
  for (int64_t i = 0; i < n; ++i) out[i] = i;
  uint64_t state = seed ? seed : 1;
  for (int64_t i = n - 1; i > 0; --i) {
    int64_t j = (int64_t)(splitmix64(&state) % (uint64_t)(i + 1));
    std::swap(out[i], out[j]);
  }
}

}  // extern "C"
