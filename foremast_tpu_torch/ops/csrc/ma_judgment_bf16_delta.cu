// ma_judgment_bf16_delta: the moving_average_all judgment from the
// anchor-shifted bf16-delta history layout.
//
// Replaces the Pallas kernel `ma_judgment_bf16_delta` /
// `_judgment_bf16_kernel` of foremast_tpu/ops/kernels.py. On the H100 it
// is bound by device-memory bytes: the history costs 2 bytes a point
// (bf16 delta; the count comes from `lens`, so no mask is read). The
// simple design gives each row one 256-thread block that makes ONE pass:
// 16-byte loads of 8 bf16 deltas, converted with __bfloat1622float2 and
// accumulated as f32 sum and sum of squares. mean = anchor + E[d],
// var = max(E[d^2] - E[d]^2, 0): deltas are exact zeros outside the valid
// slots, so plain sums are the masked sums. The same block then judges
// the Tc current points.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

// kVec: Th % 8 == 0 and delta 16-byte aligned.
template <bool kVec>
__global__ void __launch_bounds__(fm::kThreads)
    ma_judgment_bf16_delta_kernel(const float* __restrict__ anchor,
                                  const __nv_bfloat16* __restrict__ delta,
                                  const int* __restrict__ lens,
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
  const __nv_bfloat16* d = delta + row * Th;
  float s1 = 0.f, s2 = 0.f;
  if (kVec) {
    const uint4* d8 = reinterpret_cast<const uint4*>(d);
    for (long long i = threadIdx.x; i < Th / 8; i += fm::kThreads) {
      const uint4 u = d8[i];
      const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 f = __bfloat1622float2(p[k]);
        s1 += f.x + f.y;
        s2 += f.x * f.x + f.y * f.y;
      }
    }
  } else {
    for (long long i = threadIdx.x; i < Th; i += fm::kThreads) {
      const float f = __bfloat162float(d[i]);
      s1 += f;
      s2 += f * f;
    }
  }
  s1 = fm::block_sum(s1, fscratch);
  s2 = fm::block_sum(s2, fscratch);
  const float n = static_cast<float>(lens[row]);
  const float c = fmaxf(n, 1.f);
  const float mean_d = s1 / c;
  const float mean = n > 0.f ? __fadd_rn(anchor[row], mean_d) : 0.f;
  const float var =
      n > 0.f ? fmaxf(__fsub_rn(s2 / c, __fmul_rn(mean_d, mean_d)), 0.f) : 0.f;
  fm::judge_row(row, n, mean, sqrtf(var), cv, cm, thr, bnd, mlb, mnp, verdict,
                anom, upper, lower, Tc, iscratch);
}

}  // namespace

FM_API int fm_ma_judgment_bf16_delta(
    const float* anchor, const __nv_bfloat16* delta, const int* lens,
    const float* cv, const uint8_t* cm, const float* thr, const int* bnd,
    const float* mlb, const float* mnp, int* verdict, uint8_t* anom,
    float* upper, float* lower, long long B, long long Th, long long Tc,
    cudaStream_t stream) {
  if (B > 0) {
    const bool vec = Th % 8 == 0 && fm::aligned(delta, 16);
    if (vec)
      ma_judgment_bf16_delta_kernel<true><<<B, fm::kThreads, 0, stream>>>(
          anchor, delta, lens, cv, cm, thr, bnd, mlb, mnp, verdict, anom,
          upper, lower, Th, Tc);
    else
      ma_judgment_bf16_delta_kernel<false><<<B, fm::kThreads, 0, stream>>>(
          anchor, delta, lens, cv, cm, thr, bnd, mlb, mnp, verdict, anom,
          upper, lower, Th, Tc);
  }
  return static_cast<int>(cudaGetLastError());
}
