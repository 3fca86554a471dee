// holt_winters_scan: additive Holt-Winters over a masked [B, T] batch for
// G smoothing-parameter triples at once, or one triple per series.
//
// Replaces the XLA `lax.scan` bodies `_hw_season_blocked` and `_hw_rolled`
// of foremast_tpu/ops/forecasters.py (`holt_winters`, and
// `fit_holt_winters`'s vmap over `_HW_GRID`); the JAX package has no
// Pallas kernel for them. One recurrence for every season length m: the
// TPU's two program shapes (unrolled phases for m <= 64, a rolled step for
// longer m) existed for XLA's compile size and do not carry over.
//
// Design: one thread per (series b, parameter set g), the G lanes of a
// series in neighbouring threads (lane i = b * G + g). Level, trend, the
// inited flag and the running SSE stay in registers. The season lives in
// device memory as [m, B * G], so at phase p (shared by the whole batch:
// indexing is by absolute step) a warp reads and writes one coalesced
// 128-byte row; for m = 24 a block's season (12 KB) stays in L1, for
// m = 1440 it streams from L2/HBM. That buffer is also the terminal-season
// output. Values and masks are read straight from the [B, T] rows; the
// G lanes of a series share each line through L1.
//
// What bounds it on the H100: the dependent chain, T steps of the
// level/trend update (about 7 dependent f32 operations a step), and at
// m = 1440 the season load's latency inside that chain. Bytes (5 B a point
// of history, the season in and out, 4 B a point of `pred` when written)
// are a smaller bound at the main path's shapes. Speed is a later
// redesign's work (persistent blocks, staged tiles, a chain stopped at the
// last valid index).
//
// Arithmetic: every product and sum is rounded on its own
// (__fmul_rn / __fadd_rn / __fsub_rn), so nvcc contracts nothing into a
// fused multiply-add and the kernel reproduces the plain PyTorch version
// (`ops/kernels.py`) bit for bit; the SSE is accumulated in f64 in time
// order, as the plain version does.
#include "common.cuh"

namespace {

constexpr int kHwThreads = 128;

__global__ void __launch_bounds__(kHwThreads)
    holt_winters_scan_kernel(const float* __restrict__ values,
                             const uint8_t* __restrict__ mask,
                             const float* __restrict__ init_level,
                             const float* __restrict__ init_season,
                             const float* __restrict__ params,
                             float* level_out, float* trend_out,
                             float* season, double* sse_out, float* pred,
                             bool per_series, long long B, long long T,
                             long long m, long long G) {
  const long long N = B * G;
  const long long i = static_cast<long long>(blockIdx.x) * kHwThreads + threadIdx.x;
  if (i >= N) return;
  const long long b = i / G;
  const long long g = i - b * G;
  const float* p = params + 3 * (per_series ? b : g);
  const float alpha = p[0], beta = p[1], gamma = p[2];
  const float oma = __fsub_rn(1.f, alpha);
  const float omb = __fsub_rn(1.f, beta);
  const float omg = __fsub_rn(1.f, gamma);

  for (long long q = 0; q < m; ++q) season[q * N + i] = init_season[b * m + q];
  float level = init_level[b];
  float trend = 0.f;
  bool inited = false;
  double sse = 0.0;
  const float* xr = values + b * T;
  const uint8_t* mr = mask + b * T;
  float* pr_row = pred ? pred + b * T : nullptr;
  long long phase = 0;
  for (long long t = 0; t < T; ++t) {
    const float x = __ldg(xr + t);
    const bool msk = __ldg(mr + t) != 0;
    float* sp = season + phase * N + i;
    const float s = *sp;
    const float lt = __fadd_rn(level, trend);
    const float forecast = __fadd_rn(lt, s);
    const float new_level =
        __fadd_rn(__fmul_rn(alpha, __fsub_rn(x, s)), __fmul_rn(oma, lt));
    const float new_trend = __fadd_rn(__fmul_rn(beta, __fsub_rn(new_level, level)),
                                      __fmul_rn(omb, trend));
    const float new_s =
        __fadd_rn(__fmul_rn(gamma, __fsub_rn(x, new_level)), __fmul_rn(omg, s));
    if (msk && inited) {
      *sp = new_s;
      level = new_level;
      trend = new_trend;
    }
    const float out = inited ? forecast : x;  // zero residual before the first point
    if (pr_row) pr_row[t] = out;
    if (msk) {
      const float r = __fsub_rn(x, out);
      sse += static_cast<double>(__fmul_rn(r, r));
    }
    inited = inited || msk;
    if (++phase == m) phase = 0;
  }
  level_out[i] = level;
  trend_out[i] = trend;
  sse_out[i] = sse;
}

}  // namespace

// values [B, T] f32, mask [B, T] bytes, init_level [B], init_season [B, m];
// params [G, 3] (per_series = 0) or [B, 3] with G = 1 (per_series = 1),
// rows (alpha, beta, gamma). Outputs per lane i = b * G + g: level, trend,
// sse (f64) [B * G], season [m, B * G]; pred [B, T] (G = 1 only) or null.
FM_API int fm_holt_winters_scan(const float* values, const uint8_t* mask,
                                const float* init_level, const float* init_season,
                                const float* params, float* level, float* trend,
                                float* season, double* sse, float* pred,
                                long long per_series, long long B, long long T,
                                long long m, long long G, cudaStream_t stream) {
  const long long n = B * G;
  if (n > 0) {
    const long long blocks = (n + kHwThreads - 1) / kHwThreads;
    holt_winters_scan_kernel<<<static_cast<unsigned>(blocks), kHwThreads, 0, stream>>>(
        values, mask, init_level, init_season, params, level, trend, season, sse,
        pred, per_series != 0, B, T, m, G);
  }
  return static_cast<int>(cudaGetLastError());
}
