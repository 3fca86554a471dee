// Host window packing for the cold path (a copy of the JAX package's
// native/windowpack.cpp, with one entry point added for the bf16-delta
// layout).
//
// The judge packs thousands of ragged (times, values) series per tick
// into fixed-shape [B, T] batches before the upload to the card. A
// per-series Python loop into a zeroed scratch is the cold tick's
// dominant host cost, so the scatter runs here instead.
//
// ABI: plain C, loaded with ctypes (foremast_tpu_torch/native.py).
// Inputs are per-series pointer tables plus a lengths array, so Python
// makes one call per batch whatever B is, and no staging copy is made.
// Built with g++ -O3 -shared -fPIC -pthread on first use.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Run fn(lo, hi) over [0, B), on up to 8 threads for large batches; the
// per-series work is a short copy, so threads start only with volume.
template <typename Fn>
void parallel_rows(int64_t B, Fn fn) {
  const int64_t kParallelThreshold = 1024;
  unsigned hw = std::thread::hardware_concurrency();
  if (B < kParallelThreshold || hw < 2) {
    fn(int64_t{0}, B);
    return;
  }
  const int64_t n_threads = std::min<int64_t>(hw, 8);
  std::vector<std::thread> workers;
  workers.reserve(n_threads);
  const int64_t chunk = (B + n_threads - 1) / n_threads;
  for (int64_t t = 0; t < n_threads; ++t) {
    const int64_t lo = t * chunk;
    const int64_t hi = std::min(lo + chunk, B);
    if (lo >= hi) break;
    workers.emplace_back(fn, lo, hi);
  }
  for (auto& w : workers) w.join();
}

// float32 -> bfloat16 bits, round to nearest even on the bits (the
// ml_dtypes rule): subnormals, -0.0 and the overflow to +-Inf come out
// as a bit-wise rounding gives them; any NaN becomes the quiet NaN of
// its sign (0x7FC0 / 0xFFC0).
inline uint16_t to_bf16(float f) {
  uint32_t u;
  std::memcpy(&u, &f, sizeof(u));
  if ((u & 0x7FFFFFFFu) > 0x7F800000u) {
    return static_cast<uint16_t>(((u >> 16) & 0x8000u) | 0x7FC0u);
  }
  return static_cast<uint16_t>((u + 0x7FFFu + ((u >> 16) & 1u)) >> 16);
}

}  // namespace

extern "C" {

// Pack ragged series into [B, T] values/times/mask.
//  values: float32*[B]   per-series value buffers (raw numpy pointers)
//  times:  int64*[B]     per-series timestamp buffers
//  lens:   int64[B]      per-series lengths
//  B, T:   batch and window length
//  out_values: float32[B*T]   caller-zeroed (np.zeros): only the valid
//  out_times:  int32[B*T]     prefix is written, so the padding stays on
//  out_mask:   uint8[B*T]     zero pages that are never faulted in.
//                             out_times may be null: times are skipped.
// Series longer than T are truncated to their first T samples (the
// semantics of MetricWindows.from_ragged).
void fp_pack_windows(const float* const* values, const int64_t* const* times,
                     const int64_t* lens, int64_t B, int64_t T,
                     float* out_values, int32_t* out_times,
                     uint8_t* out_mask) {
  parallel_rows(B, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      const int64_t n = std::min<int64_t>(lens[i], T);
      std::memcpy(out_values + i * T, values[i], sizeof(float) * n);
      if (out_times != nullptr) {
        int32_t* ot = out_times + i * T;
        const int64_t* ts = times[i];
        for (int64_t j = 0; j < n; ++j) ot[j] = static_cast<int32_t>(ts[j]);
      }
      std::memset(out_mask + i * T, 1, n);
    }
  });
}

// The judge's bf16-delta layout: per row, anchor = first valid value
// (0 for an empty row), delta[j] = bf16(values[j] - anchor) on the valid
// prefix (the subtraction in float32) and +0.0 on the padding, lens =
// min(len, L). Every element of out_delta is written, so the caller may
// hand over an uninitialized (pinned) buffer.
//  values: float32*[B], lens: int64[B]
//  out_delta: bf16 bits [B*L], out_anchor: float32[B], out_lens: int32[B]
void fp_pack_bf16_delta(const float* const* values, const int64_t* lens,
                        int64_t B, int64_t L, uint16_t* out_delta,
                        float* out_anchor, int32_t* out_lens) {
  parallel_rows(B, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      const int64_t n = std::min<int64_t>(lens[i], L);
      const float* v = values[i];
      const float anchor = n > 0 ? v[0] : 0.0f;
      uint16_t* od = out_delta + i * L;
      for (int64_t j = 0; j < n; ++j) od[j] = to_bf16(v[j] - anchor);
      std::memset(od + n, 0, sizeof(uint16_t) * (L - n));
      out_anchor[i] = anchor;
      out_lens[i] = static_cast<int32_t>(n);
    }
  });
}

// ABI version tag so the Python side can detect a stale build.
int32_t fp_abi_version() { return 6; }

}  // extern "C"
