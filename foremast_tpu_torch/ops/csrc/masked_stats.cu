// masked_stats: count, mean and std (ddof 0) of a masked [B, T] f32 batch.
//
// Replaces the Pallas kernel `masked_stats` / `_stats_kernel` of
// foremast_tpu/ops/kernels.py. On the H100 it is bound by device-memory
// bytes: each point costs 5 bytes (f32 value + bool mask byte) and a few
// flops. The simple design reads each row with one 256-thread block,
// 16-byte value loads and 4-byte mask loads when the row allows it, so
// the first pass streams at full width; the second (centred) pass re-reads
// the row, which the first pass has just pulled into L2, so device memory
// sees the row about once. The TPU kernel's 32-row tiles, 128-lane padding
// and f32 mask are dropped.
#include "common.cuh"

namespace {

template <bool kVec>
__global__ void __launch_bounds__(fm::kThreads)
    masked_stats_kernel(const float* __restrict__ values,
                        const uint8_t* __restrict__ mask, float* cnt,
                        float* mean, float* std, long long T) {
  __shared__ float fscratch[fm::kWarps];
  __shared__ int iscratch[fm::kWarps];
  const long long row = blockIdx.x;
  const fm::RowStats s = fm::row_stats<kVec>(values + row * T, mask + row * T,
                                             T, fscratch, iscratch);
  if (threadIdx.x == 0) {
    cnt[row] = s.n;
    mean[row] = s.mean;
    std[row] = s.sigma;
  }
}

}  // namespace

FM_API int fm_masked_stats(const float* values, const uint8_t* mask,
                           float* cnt, float* mean, float* std, long long B,
                           long long T, cudaStream_t stream) {
  if (B > 0) {
    const bool vec = T % 4 == 0 && fm::aligned(values, 16) && fm::aligned(mask, 4);
    if (vec)
      masked_stats_kernel<true><<<B, fm::kThreads, 0, stream>>>(
          values, mask, cnt, mean, std, T);
    else
      masked_stats_kernel<false><<<B, fm::kThreads, 0, stream>>>(
          values, mask, cnt, mean, std, T);
  }
  return static_cast<int>(cudaGetLastError());
}
