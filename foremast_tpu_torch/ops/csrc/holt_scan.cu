// holt_scan: Holt's linear-trend recurrence (double exponential
// smoothing) over a masked [B, T] batch, one sequential chain per series.
//
// Replaces the XLA `lax.scan` of `double_exponential` in
// foremast_tpu/ops/forecasters.py (no Pallas kernel there). Level starts
// at the first valid point with trend 0; masked steps carry the state;
// `pred` is the one-step-ahead forecast (the point itself before the
// first valid point).
//
// Design: one thread per series; level, trend and the inited flag in
// registers; values and masks read straight from the row (L1 serves the
// following 31 steps of each 128-byte line). What bounds it on the H100:
// the dependent chain of T steps (about 6 dependent f32 operations a
// step); bytes are 5 B a point in and 4 B a point of `pred` out.
//
// Every product and sum is rounded on its own, so no fused multiply-add
// separates the kernel from the plain PyTorch version (`ops/kernels.py`).
#include "common.cuh"

namespace {

constexpr int kHoltThreads = 128;

__global__ void __launch_bounds__(kHoltThreads)
    holt_scan_kernel(const float* __restrict__ values,
                     const uint8_t* __restrict__ mask,
                     const float* __restrict__ alpha_in,
                     const float* __restrict__ beta_in, float* level_out,
                     float* trend_out, float* pred, long long B, long long T) {
  const long long b = static_cast<long long>(blockIdx.x) * kHoltThreads + threadIdx.x;
  if (b >= B) return;
  const float alpha = alpha_in[b], beta = beta_in[b];
  const float oma = __fsub_rn(1.f, alpha);
  const float omb = __fsub_rn(1.f, beta);
  const float* xr = values + b * T;
  const uint8_t* mr = mask + b * T;
  float* pr = pred + b * T;
  float level = 0.f, trend = 0.f;
  bool inited = false;
  for (long long t = 0; t < T; ++t) {
    const float x = __ldg(xr + t);
    const bool msk = __ldg(mr + t) != 0;
    const float lt = __fadd_rn(level, trend);
    const float new_level = __fadd_rn(__fmul_rn(alpha, x), __fmul_rn(oma, lt));
    const float new_trend = __fadd_rn(__fmul_rn(beta, __fsub_rn(new_level, level)),
                                      __fmul_rn(omb, trend));
    pr[t] = inited ? lt : x;
    if (msk) {
      level = inited ? new_level : x;
      trend = inited ? new_trend : 0.f;
    }
    inited = inited || msk;
  }
  level_out[b] = level;
  trend_out[b] = trend;
}

}  // namespace

// values [B, T] f32, mask [B, T] bytes, alpha/beta [B] -> level, trend [B],
// pred [B, T].
FM_API int fm_holt_scan(const float* values, const uint8_t* mask, const float* alpha,
                        const float* beta, float* level, float* trend, float* pred,
                        long long B, long long T, cudaStream_t stream) {
  if (B > 0) {
    const long long blocks = (B + kHoltThreads - 1) / kHoltThreads;
    holt_scan_kernel<<<static_cast<unsigned>(blocks), kHoltThreads, 0, stream>>>(
        values, mask, alpha, beta, level, trend, pred, B, T);
  }
  return static_cast<int>(cudaGetLastError());
}
