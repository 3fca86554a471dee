// Shared device code of the scoring kernels: block reductions, the
// two-pass masked row moments, and the judgment tail (band, flags,
// measurability gate, verdict) for one row.
//
// Every kernel runs one thread block of kThreads threads per row of the
// batch; threads stride over the time axis, so neighbouring threads read
// neighbouring addresses. Bool tensors are read and written as bytes.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define FM_API extern "C" __attribute__((visibility("default")))

namespace fm {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Verdict codes — must match engine/scoring.py.
constexpr int kHealthy = 0;
constexpr int kUnhealthy = 1;
constexpr int kUnknown = 2;

// Block-wide sum; every thread returns the same value (the per-warp
// partials are added in one fixed order). `scratch` holds kWarps values.
template <typename T>
__device__ __forceinline__ T block_sum(T v, T* scratch) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();  // a previous call may still be reading scratch
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  T s = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s += scratch[w];
  return s;
}

struct RowStats {
  float n;      // valid count
  float mean;
  float sigma;  // std, ddof 0
};

// Masked count, mean and two-pass std of one row x[0:T] under mask m.
// The second pass re-reads the row, which the first pass has just
// brought into L2. kVec: T % 4 == 0, x 16-byte and m 4-byte aligned.
template <bool kVec>
__device__ RowStats row_stats(const float* __restrict__ x,
                              const uint8_t* __restrict__ m, long long T,
                              float* fscratch, int* iscratch) {
  int cnt = 0;
  float s1 = 0.f;
  if (kVec) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    const uchar4* m4 = reinterpret_cast<const uchar4*>(m);
    for (long long i = threadIdx.x; i < T / 4; i += kThreads) {
      const float4 v = x4[i];
      const uchar4 k = m4[i];
      cnt += (k.x != 0) + (k.y != 0) + (k.z != 0) + (k.w != 0);
      s1 += (k.x ? v.x : 0.f) + (k.y ? v.y : 0.f) + (k.z ? v.z : 0.f) +
            (k.w ? v.w : 0.f);
    }
  } else {
    for (long long i = threadIdx.x; i < T; i += kThreads) {
      if (m[i]) {
        cnt += 1;
        s1 += x[i];
      }
    }
  }
  const float n = static_cast<float>(block_sum(cnt, iscratch));
  const float c = fmaxf(n, 1.f);
  const float mu = block_sum(s1, fscratch) / c;
  float s2 = 0.f;
  if (kVec) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    const uchar4* m4 = reinterpret_cast<const uchar4*>(m);
    for (long long i = threadIdx.x; i < T / 4; i += kThreads) {
      const float4 v = x4[i];
      const uchar4 k = m4[i];
      const float a = k.x ? v.x - mu : 0.f;
      const float b = k.y ? v.y - mu : 0.f;
      const float d = k.z ? v.z - mu : 0.f;
      const float e = k.w ? v.w - mu : 0.f;
      s2 += a * a + b * b + d * d + e * e;
    }
  } else {
    for (long long i = threadIdx.x; i < T; i += kThreads) {
      const float d = m[i] ? x[i] - mu : 0.f;
      s2 += d * d;
    }
  }
  const float var = block_sum(s2, fscratch) / c;
  return {n, mu, sqrtf(var)};
}

// Band, bound-selector flags, measurability gate and verdict for row
// `row`, from its history count/mean/sigma. Called by every thread of the
// block. The band products use explicit round-to-nearest so no fused
// multiply-add makes the kernel's bounds differ from the plain version.
__device__ void judge_row(long long row, float n, float mean, float sigma,
                          const float* __restrict__ cv,
                          const uint8_t* __restrict__ cm,
                          const float* __restrict__ thr,
                          const int* __restrict__ bnd,
                          const float* __restrict__ mlb,
                          const float* __restrict__ mnp, int* verdict,
                          uint8_t* anom, float* upper, float* lower,
                          long long Tc, int* iscratch) {
  const float band = __fmul_rn(thr[row], sigma);
  const float up = __fadd_rn(mean, band);
  const float lo = fmaxf(__fsub_rn(mean, band), mlb[row]);
  const int b = bnd[row];
  const bool use_up = (b == 1) || (b == 3);
  const bool use_lo = (b == 2) || (b == 3);
  const float* cvr = cv + row * Tc;
  const uint8_t* cmr = cm + row * Tc;

  int ncur = 0;
  for (long long j = threadIdx.x; j < Tc; j += kThreads) ncur += cmr[j] != 0;
  ncur = block_sum(ncur, iscratch);
  const bool measurable = (n >= mnp[row]) && (ncur > 0);

  int any = 0;
  for (long long j = threadIdx.x; j < Tc; j += kThreads) {
    const float x = cvr[j];
    const bool f = measurable && cmr[j] &&
                   ((use_up && x > up) || (use_lo && x < lo));
    anom[row * Tc + j] = f;
    upper[row * Tc + j] = up;
    lower[row * Tc + j] = lo;
    any |= f;
  }
  any = __syncthreads_or(any);
  if (threadIdx.x == 0)
    verdict[row] = measurable ? (any ? kUnhealthy : kHealthy) : kUnknown;
}

inline bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace fm

FM_API const char* fm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
