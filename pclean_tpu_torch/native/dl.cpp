// Native kernel: batched restricted Damerau-Levenshtein (optimal string
// alignment) distance matrix between two interned string vocabularies.
//
// TPU-native counterpart of the reference's per-pair, memoized host
// computation (PClean src/distributions/add_typos.jl:47-66, which
// calls StringDistances.DamerauLevenshtein lazily per (observed, word) pair
// and caches in a global Dict). Here the whole [Vo x Vs] matrix is
// precomputed once at model-compile time so the AddTypos likelihood becomes a
// dense gather/matmul operand on device; this O(Vo*Vs*L^2) char-level DP is
// the hot host-side op, hence C++ + OpenMP rather than Python.
//
// Build: g++ -O3 -march=native -shared -fPIC -fopenmp dl.cpp -o _dl.so
#include <cstdint>
#include <vector>
#include <algorithm>

extern "C" {

// a: [na, maxlen] int32 char codes (padded with -1), alen: [na] lengths.
// b: [nb, maxlen], blen: [nb]. out: [na, nb] int32 OSA distances.
void osa_distance_matrix(const int32_t* a, const int32_t* alen, int64_t na,
                         const int32_t* b, const int32_t* blen, int64_t nb,
                         int64_t maxlen, int32_t* out) {
#pragma omp parallel
  {
    // Three rolling DP rows per thread.
    std::vector<int32_t> buf(3 * (maxlen + 1));
#pragma omp for schedule(dynamic, 4)
    for (int64_t i = 0; i < na; ++i) {
      const int32_t* sa = a + i * maxlen;
      const int32_t la = alen[i];
      for (int64_t j = 0; j < nb; ++j) {
        const int32_t* sb = b + j * maxlen;
        const int32_t lb = blen[j];
        if (la == 0 || lb == 0) {
          out[i * nb + j] = std::max(la, lb);
          continue;
        }
        int32_t* prev2 = buf.data();
        int32_t* prev = buf.data() + (maxlen + 1);
        int32_t* cur = buf.data() + 2 * (maxlen + 1);
        for (int32_t q = 0; q <= lb; ++q) prev[q] = q;
        for (int32_t p = 1; p <= la; ++p) {
          cur[0] = p;
          const int32_t ca = sa[p - 1];
          for (int32_t q = 1; q <= lb; ++q) {
            const int32_t cb = sb[q - 1];
            int32_t cost = (ca == cb) ? 0 : 1;
            int32_t d = std::min({prev[q] + 1, cur[q - 1] + 1, prev[q - 1] + cost});
            if (p > 1 && q > 1 && ca == sb[q - 2] && sa[p - 2] == cb) {
              d = std::min(d, prev2[q - 2] + 1);
            }
            cur[q] = d;
          }
          int32_t* tmp = prev2;
          prev2 = prev;
          prev = cur;
          cur = tmp;
        }
        out[i * nb + j] = prev[lb];
      }
    }
  }
}

// Batched "is `short` a subsequence of `long`" matrix, case-insensitive
// lowering is done by the caller. Counterpart of the reference's
// is_short_version (PClean src/distributions/expand_on_short_version.jl:6-19).
void subsequence_matrix(const int32_t* a, const int32_t* alen, int64_t na,
                        const int32_t* b, const int32_t* blen, int64_t nb,
                        int64_t maxlen, uint8_t* out) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < na; ++i) {
    const int32_t* ss = a + i * maxlen;
    const int32_t ls = alen[i];
    for (int64_t j = 0; j < nb; ++j) {
      const int32_t* sl = b + j * maxlen;
      const int32_t ll = blen[j];
      int32_t p = 0;
      for (int32_t q = 0; q < ll && p < ls; ++q) {
        if (ss[p] == sl[q]) ++p;
      }
      out[i * nb + j] = (p >= ls) ? 1 : 0;
    }
  }
}

}  // extern "C"
