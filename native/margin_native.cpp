// Native host-runtime helpers for marginalign_trna_tpu.
//
// The reference framework's host-side hot loops live in C (sonLib, cPecan
// drivers); here the device does the DP compute and the tracebacks, and
// the native layer covers the sequential host work that Python is slow at:
//   - colinear seed chaining (O(h^2) DP over k-mer hits)
//   - banded-batch packing
//
// Exposed as a C ABI for ctypes (no pybind11 dependency).

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <vector>

extern "C" {

// ----------------------------------------------------------------- chaining

// Best colinear chain over seed hits sorted by (r, q).  Scores = chain
// length; constraints mirror align/guide.chain_seeds.  Writes the selected
// hit indices (in chain order) to out_idx; returns chain length.
int64_t chain_seeds(
    const int64_t* q, const int64_t* r, int64_t h,
    int64_t max_gap2, int64_t max_drift,
    int64_t* out_idx, int64_t max_out) {
  if (h <= 0) return 0;
  std::vector<int64_t> score(h, 1), parent(h, -1);
  int64_t best = 0;
  for (int64_t i = 0; i < h; ++i) {
    for (int64_t j2 = 0; j2 < i; ++j2) {
      int64_t dq = q[i] - q[j2];
      int64_t dr = r[i] - r[j2];
      if (dq > 0 && dr > 0 && dq + dr <= max_gap2 &&
          std::abs(dq - dr) <= max_drift && score[j2] + 1 > score[i]) {
        score[i] = score[j2] + 1;
        parent[i] = j2;
      }
    }
    if (score[i] > score[best]) best = i;
  }
  std::vector<int64_t> chain;
  for (int64_t at = best; at >= 0; at = parent[at]) chain.push_back(at);
  int64_t len = static_cast<int64_t>(chain.size());
  if (len > max_out) return -1;
  for (int64_t t = 0; t < len; ++t) out_idx[t] = chain[len - 1 - t];
  return len;
}

// ------------------------------------------------------------ band packing

// ------------------------------------------------------------------ packing

// Fill the [D1, Wp, B] banded arrays (xb ref codes, yb read codes, valid)
// for lanes 0..b0-1 of a batch whose arrays are zeroed beforehand.  Lane
// b's read and ref codes start at read_off[b] / ref_off[b] of the
// concatenated read/ref buffers; lo is [D1, B] int32.  The loops run
// diagonal-major with lanes innermost, so every output row is written in
// address order: writing lane by lane instead strides by B bytes per
// cell, which measured 51 ms per 3.5 kb lane.  Semantics are
// ops/band.pack_banded_batch's numpy path (cells past a lane's last
// diagonal m + n stay zero).
void pack_band_batch(
    const int8_t* reads, const int64_t* read_off, const int32_t* m_arr,
    const int8_t* refs, const int64_t* ref_off, const int32_t* n_arr,
    const int32_t* lo, int64_t width,
    int64_t d1, int64_t wp, int64_t b_stride, int64_t b0,
    int8_t* xb, int8_t* yb, uint8_t* valid) {
  for (int64_t d = 0; d < d1; ++d) {
    const int32_t* lo_d = lo + d * b_stride;
    for (int64_t k = 0; k < wp; ++k) {
      const int64_t row = (d * wp + k) * b_stride;
      for (int64_t lane = 0; lane < b0; ++lane) {
        const int64_t m = m_arr[lane], n = n_arr[lane];
        if (d > m + n) continue;
        const int64_t i = lo_d[lane] + k;
        const int64_t j = d - i;
        const bool ok =
            k < width && i >= 0 && i <= m && i <= d && j >= 0 && j <= n;
        valid[row + lane] = ok ? 1 : 0;
        const int64_t yi = std::min(std::max(i - 1, (int64_t)0),
                                    std::max(m - 1, (int64_t)0));
        const int64_t xj = std::min(std::max(j - 1, (int64_t)0),
                                    std::max(n - 1, (int64_t)0));
        yb[row + lane] = m > 0 ? reads[read_off[lane] + yi] : 4;
        xb[row + lane] = n > 0 ? refs[ref_off[lane] + xj] : 4;
      }
    }
  }
}

}  // extern "C"
