// ma_judgment: the fused moving_average_all judgment from f32 history.
//
// Replaces the Pallas kernel `ma_judgment` / `_judgment_kernel` of
// foremast_tpu/ops/kernels.py. On the H100 it is bound by device-memory
// bytes: the [B, Th] history costs 5 bytes a point (f32 value + bool mask
// byte), against a handful of flops, and the [B, Tc] current window is
// tiny beside it. The simple design gives each row one 256-thread block:
// a strided, vectorised first pass for count and sum, a second centred
// pass that hits L2 (same two-pass numerics as the TPU kernel), then the
// same block judges the Tc current points and writes verdict, flags and
// band. Anomaly flags are written as bytes and viewed as torch.bool.
#include "common.cuh"

namespace {

template <bool kVec>
__global__ void __launch_bounds__(fm::kThreads)
    ma_judgment_kernel(const float* __restrict__ hv,
                       const uint8_t* __restrict__ hm,
                       const float* __restrict__ cv,
                       const uint8_t* __restrict__ cm,
                       const float* __restrict__ thr,
                       const int* __restrict__ bnd,
                       const float* __restrict__ mlb,
                       const float* __restrict__ mnp, int* verdict,
                       uint8_t* anom, float* upper, float* lower,
                       long long Th, long long Tc) {
  __shared__ float fscratch[fm::kWarps];
  __shared__ int iscratch[fm::kWarps];
  const long long row = blockIdx.x;
  const fm::RowStats s =
      fm::row_stats<kVec>(hv + row * Th, hm + row * Th, Th, fscratch, iscratch);
  fm::judge_row(row, s.n, s.mean, s.sigma, cv, cm, thr, bnd, mlb, mnp,
                verdict, anom, upper, lower, Tc, iscratch);
}

}  // namespace

FM_API int fm_ma_judgment(const float* hv, const uint8_t* hm, const float* cv,
                          const uint8_t* cm, const float* thr, const int* bnd,
                          const float* mlb, const float* mnp, int* verdict,
                          uint8_t* anom, float* upper, float* lower,
                          long long B, long long Th, long long Tc,
                          cudaStream_t stream) {
  if (B > 0) {
    const bool vec = Th % 4 == 0 && fm::aligned(hv, 16) && fm::aligned(hm, 4);
    if (vec)
      ma_judgment_kernel<true><<<B, fm::kThreads, 0, stream>>>(
          hv, hm, cv, cm, thr, bnd, mlb, mnp, verdict, anom, upper, lower, Th,
          Tc);
    else
      ma_judgment_kernel<false><<<B, fm::kThreads, 0, stream>>>(
          hv, hm, cv, cm, thr, bnd, mlb, mnp, verdict, anom, upper, lower, Th,
          Tc);
  }
  return static_cast<int>(cudaGetLastError());
}
