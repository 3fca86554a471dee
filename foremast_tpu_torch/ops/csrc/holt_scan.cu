// holt_scan: Holt's linear-trend recurrence (double exponential
// smoothing) over a masked [B, T] batch, one sequential chain per series.
//
// Replaces the XLA `lax.scan` of `double_exponential` in
// foremast_tpu/ops/forecasters.py (no Pallas kernel there). Level starts
// at the first valid point with trend 0; masked steps carry the state;
// `pred` is the one-step-ahead forecast (the point itself before the
// first valid point).
//
// What bounds it on the H100 (PERF.md has the numbers): each series'
// chain of dependent steps (level -> level + trend -> product -> new
// level -> difference -> product -> new trend, about 24 cycles a step;
// ~12 instructions), one chain warp to an SM at B = 4,096. Bytes (5 B a
// point of history up to the last valid step, 4 B a point of `pred` out)
// are a smaller bound.
//
// Design (scan_tiles.cuh has the layout): one chain thread per series, 32
// series a block, so B = 4,096 puts one block on each of 128 SMs. The
// chain warp only computes: a loader warp stages [32, 64] tiles of values
// and mask in shared memory (cp.async, four stages) and a storer warp
// writes `pred` from shared memory as 16-byte row stores. The chain stops
// at the end of the tile that holds the block's last valid step (the
// largest last valid index among its rows); every warp of the block then
// fills the rest of `pred` (fill_tail) with the frozen level + trend, or
// x on a row that never saw a valid point.
//
// Every product and sum is rounded on its own, so no fused multiply-add
// separates the kernel from the plain PyTorch version (`ops/kernels.py`):
// the two are bit for bit equal.
#include "scan_tiles.cuh"

namespace {

using namespace fm::scan;

__global__ void __launch_bounds__(3 * kLanes)
    holt_scan_kernel(const float* __restrict__ values, const uint8_t* __restrict__ mask,
                     const int* __restrict__ last_valid, const float* __restrict__ alpha_in,
                     const float* __restrict__ beta_in, float* __restrict__ level_out,
                     float* __restrict__ trend_out, float* __restrict__ pred, long long B,
                     long long T, bool vec) {
  constexpr int R = kLanes;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int chain_slot;
  const int tid = threadIdx.x;
  const long long b0 = static_cast<long long>(blockIdx.x) * R;
  const int rows = static_cast<int>(B - b0 < R ? B - b0 : R);

  Pipe p;
  p.vals = reinterpret_cast<float*>(smem);
  p.ptiles = p.vals + kStages * R * kValStride;
  p.masks = reinterpret_cast<uint8_t*>(p.ptiles + kPredSlots * R * kValStride);
  p.values = values;
  p.mask = mask;
  p.pred = pred;
  p.b0 = b0;
  p.T = T;
  p.rows = rows;
  p.R = R;
  p.bar_threads = 2 * kLanes;
  p.vec = vec;

  // the tiles cover the chain; past them fill_tail writes the frozen state
  const int chain_end = block_chain_end(last_valid, b0, rows, 1, &chain_slot);
  p.n_tiles = (chain_end + kTile - 1) / kTile;
  const long long t_tail = static_cast<long long>(p.n_tiles) * kTile;
  const long long n_steps = t_tail < T ? t_tail : T;
  __shared__ float tail_lt[R];
  __shared__ int tail_inited[R];
  if (tid >= kLanes) {
    if (tid < 2 * kLanes)
      load_tiles(p, tid - kLanes);
    else
      store_tiles(p, tid - 2 * kLanes);
    fill_tail(p, t_tail, tail_lt, tail_inited, nullptr, 0, 1);
    return;
  }

  const int r = tid;
  const bool active = r < rows;
  const long long b = b0 + (active ? r : 0);
  const float alpha = alpha_in[b], beta = beta_in[b];
  const float oma = __fsub_rn(1.f, alpha);
  const float omb = __fsub_rn(1.f, beta);
  float level = 0.f, trend = 0.f;
  bool inited = false;

  chain_tiles<true>(p, [&](const float* vt, const uint8_t* mt, float* pt, long long t0) {
    const float* vrow = vt + r * kValStride;
    const uint8_t* mrow = mt + r * kMaskStride;
#pragma unroll 1
    for (int j0 = 0; j0 < kTile; j0 += kGroup) {
      if (t0 + j0 >= n_steps) break;  // uniform across the block
      Group grp;
      grp.load(vrow, mrow, j0);
      float out[kGroup];
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        const float x = grp.x[j];
        const bool msk = grp.valid(j);
        const float lt = __fadd_rn(level, trend);
        const float new_level = __fadd_rn(__fmul_rn(alpha, x), __fmul_rn(oma, lt));
        const float new_trend = __fadd_rn(__fmul_rn(beta, __fsub_rn(new_level, level)),
                                          __fmul_rn(omb, trend));
        out[j] = inited ? lt : x;
        if (msk) {
          level = inited ? new_level : x;
          trend = inited ? new_trend : 0.f;
        }
        inited = inited || msk;
      }
      put_group(pt + r * kValStride, j0, out);
    }
  });
  tail_lt[r] = __fadd_rn(level, trend);
  tail_inited[r] = inited;
  fill_tail(p, t_tail, tail_lt, tail_inited, nullptr, 0, 1);

  if (!active) return;
  level_out[b] = level;
  trend_out[b] = trend;
}

}  // namespace

// values [B, T] f32, mask [B, T] bytes, last_valid [B] int32 (each row's
// last valid index, -1 for none), alpha/beta [B] -> level, trend [B],
// pred [B, T]. Refuses T >= 2^31 (cudaErrorInvalidValue).
FM_API int fm_holt_scan(const float* values, const uint8_t* mask, const int* last_valid,
                        const float* alpha, const float* beta, float* level, float* trend,
                        float* pred, long long B, long long T, cudaStream_t stream) {
  if (T < 0 || T >= (1ll << 31)) return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return static_cast<int>(cudaSuccess);
  const int smem = static_cast<int>(tile_bytes(kLanes, true));
  const cudaError_t err =
      cudaFuncSetAttribute(holt_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>((B + kLanes - 1) / kLanes);
  holt_scan_kernel<<<blocks, 3 * kLanes, smem, stream>>>(values, mask, last_valid, alpha, beta,
                                                      level, trend, pred, B, T,
                                                      vector_rows(T, values, mask, pred));
  return static_cast<int>(cudaGetLastError());
}
