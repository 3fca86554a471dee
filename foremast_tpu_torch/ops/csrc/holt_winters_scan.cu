// holt_winters_scan: additive Holt-Winters over a masked [B, T] batch for
// G smoothing-parameter triples at once, or one triple per series.
//
// Replaces the XLA `lax.scan` bodies `_hw_season_blocked` and `_hw_rolled`
// of foremast_tpu/ops/forecasters.py (`holt_winters`, and
// `fit_holt_winters`'s vmap over `_HW_GRID`); the JAX package has no
// Pallas kernel for them. One recurrence for every season length m.
//
// What bounds it on the H100 (PERF.md has the numbers): each lane's chain
// of dependent steps (level -> level + trend -> product -> new level ->
// difference -> product -> new trend, about 28 cycles a step) and the ~40
// instructions a step issues, with one or two chain warps to a scheduler
// (4,096 or 32,768 lanes on 132 SMs); at m = 1440 the grid launch's
// 189 MB season, past the 50 MB L2, streams 8 bytes a lane-step from
// device memory. The contract's bytes (5 B a point of history up to the
// last valid step, the season in and out, 4 B a point of `pred`) are a
// smaller bound.
//
// Design (scan_tiles.cuh has the block layout and the tile pipeline):
//   * The chain stops at the block's last valid step: the wrapper passes
//     each row's last valid index and a block runs to the largest among
//     its rows, plus one (to the end of that tile with `pred`). Masked
//     steps change no state and add nothing to the SSE. With `pred`, every
//     warp of the block then fills the rest of the rows from the frozen
//     state (fill_tail): (level + trend) + season[t mod m] with the
//     chain's two rounded adds, or x on a row that never saw a valid point.
//   * The chain warps only compute. A loader warp stages [R, 64] tiles of
//     values and mask in shared memory (cp.async, four stages) and a
//     storer warp writes `pred` from shared memory as 16-byte row stores.
//   * A per-series block owns 32 series (B = 4,096 fills 128 SMs with one
//     block each); a grid block 128 lanes (16 series at G = 8: 256
//     blocks, about two an SM, each with 4 chain warps).
//   * A season of m <= kSeasonSmemMax lives in shared memory as
//     [m][lanes], a conflict-free row a step, read kRing steps ahead
//     through a register ring when m > kRing. A longer one stays in
//     device memory as [m, B * G], one coalesced row a step, read a group
//     of kGroup steps at a time two groups ahead (a register ring of
//     single loads loses its depth to the few scoreboards a warp has).
//   * Each step is branch-free: a step that updates nothing stores back
//     the entry it read.
//
// Arithmetic: every product and sum is rounded on its own
// (__fmul_rn / __fadd_rn / __fsub_rn), so nvcc contracts nothing into a
// fused multiply-add and the kernel reproduces the plain PyTorch version
// (`ops/kernels.py`) bit for bit; the SSE is accumulated in f64 in time
// order, as the plain version does. Only the memory schedule, the thread
// layout and the steps that run the chain differ from a plain loop.
#include "scan_tiles.cuh"

namespace {

using namespace fm::scan;

constexpr int kRing = kGroup;         // steps a shared-memory season load runs ahead
constexpr int kSeasonSmemMax = 160;   // the longest season kept in shared memory
static_assert(kTile % (2 * kGroup) == 0, "a tile holds pairs of groups");
static_assert(kSeasonSmemMax >= 2 * kGroup, "a device-memory season has m >= 2 kGroup");

struct HwArgs {
  const float* values;       // [B, T]
  const uint8_t* mask;       // [B, T]
  const int* last_valid;     // [B]
  const float* init_level;   // [B]
  const float* init_season;  // [B, m]
  const float* params;       // [G, 3] or [B, 3] (per_series)
  float* level;              // [B * G]
  float* trend;              // [B * G]
  float* season;             // [m, B * G]
  double* sse;               // [B * G]
  float* pred;               // [B, T] or null
  long long B, T;
  int m, G;
  bool per_series, vec;
};

// kSmemSeason: the season lives in shared memory (m <= kSeasonSmemMax),
// read kRing steps ahead through a register ring when kRingSeason (m > kRing),
// else at each step. Otherwise it lives in device memory and is read a
// group at a time, two groups ahead.
template <bool kSmemSeason, bool kRingSeason, bool kPred>
__global__ void __launch_bounds__(kMaxBlock) holt_winters_scan_kernel(const HwArgs a) {
  static_assert(kSmemSeason || !kRingSeason, "a device-memory season is read by groups");
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int chain_slot;
  const int G = a.G, m = a.m;
  const int R = rows_per_block(G);
  const int lanes = R * G;
  const int C = chain_threads(G);  // chain threads; then the loader and storer warps
  const int tid = threadIdx.x;
  const long long b0 = static_cast<long long>(blockIdx.x) * R;
  const int rows = static_cast<int>(a.B - b0 < R ? a.B - b0 : R);

  Pipe p;
  p.vals = reinterpret_cast<float*>(smem);
  p.ptiles = kPred ? p.vals + kStages * R * kValStride : nullptr;
  p.masks = reinterpret_cast<uint8_t*>(p.vals + (kStages + (kPred ? kPredSlots : 0)) * R * kValStride);
  float* sseason = reinterpret_cast<float*>(p.masks + kStages * R * kMaskStride);
  p.values = a.values;
  p.mask = a.mask;
  p.pred = a.pred;
  p.b0 = b0;
  p.T = a.T;
  p.rows = rows;
  p.R = R;
  p.bar_threads = C + kLanes;
  p.vec = a.vec;

  // The tiles cover the chain. With pred, the last tile's steps past
  // chain_end run as masked steps (the frozen state's forecast), and
  // fill_tail writes the columns after it.
  const int chain_end = block_chain_end(a.last_valid, b0, rows, G, &chain_slot);
  p.n_tiles = (chain_end + kTile - 1) / kTile;
  const long long t_tail = static_cast<long long>(p.n_tiles) * kTile;
  const long long n_steps = !kPred ? chain_end : t_tail < a.T ? t_tail : a.T;
  __shared__ float tail_lt[kLanes];  // pred implies G = 1: one lane a row, C = kLanes
  __shared__ int tail_inited[kLanes];
  // row r's season entry of phase q: tail_season[r + q * stride]
  float* tail_season = kSmemSeason ? sseason : a.season + b0;
  if (tid >= C) {
    if (tid < C + kLanes)
      load_tiles(p, tid - C);
    else
      store_tiles(p, tid - C - kLanes);
    if constexpr (kPred)
      fill_tail(p, t_tail, tail_lt, tail_inited, tail_season,
                kSmemSeason ? C : static_cast<int>(a.B), m);
    return;
  }

  // A chain thread past the block's lanes (G not dividing its lanes) or
  // rows reads row 0 or a zero row and stores nothing; pred implies G = 1,
  // where neither writes a prediction another thread writes.
  const bool lane_ok = tid < lanes;
  const int r = lane_ok ? tid / G : 0;
  const int g = lane_ok ? tid - r * G : 0;
  const bool active = lane_ok && r < rows;
  const long long b = b0 + (active ? r : 0);
  const long long n_lanes = a.B * G;
  const long long lane = b0 * G + (active ? tid : 0);

  const float* pp = a.params + 3 * (a.per_series ? b : g);
  const float alpha = pp[0], beta = pp[1], gamma = pp[2];
  const float oma = __fsub_rn(1.f, alpha);
  const float omb = __fsub_rn(1.f, beta);
  const float omg = __fsub_rn(1.f, gamma);

  // this lane's season: entry q at sp[q * stride]; in shared memory every
  // chain thread has its own column
  float* sp = kSmemSeason ? sseason + tid : a.season + lane;
  const int stride = kSmemSeason ? C : static_cast<int>(n_lanes);
  const int wrap = m * stride;  // < 2^31: the entry point checks
  const bool store = kSmemSeason || active;
  const float* init_row = a.init_season + b * m;
  if (store)
    for (int q = 0; q < m; ++q) sp[q * stride] = init_row[q];

  float level = a.init_level[b];
  float trend = 0.f;
  bool inited = false;
  double sse = 0.0;
  int off = 0;     // step t's entry, (t mod m) * stride
  int off_ld = 0;  // the next entry the ring or the group buffers load
  const auto next = [stride, wrap](int o) { return o + stride == wrap ? 0 : o + stride; };
  // Shared memory, m > kRing: the entry of step t sits in ring[t mod
  // kRing], loaded at step t - kRing, after that step's store. Device
  // memory: sa / sb hold the season of a group and of the next; the group
  // after those is loaded once a group's stores are issued. Either read
  // is of an entry last written m or more steps before the step that uses
  // it, by the same thread, and after that store in program order (m >
  // kRing; m >= 2 kGroup), so it sees the store.
  float ring[kRing], sa[kGroup], sb[kGroup];
  const auto fetch = [&](float (&buf)[kGroup]) {
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      buf[j] = sp[off_ld];
      off_ld = next(off_ld);
    }
  };
  if (kSmemSeason && kRingSeason) fetch(ring);
  if (!kSmemSeason) {
    fetch(sa);
    fetch(sb);
  }

  // kGroup steps from column j0 of the stage's rows
  const auto run_group = [&](const float* vrow, const uint8_t* mrow, float* prow, int j0,
                             float (&buf)[kGroup]) {
    Group grp;
    grp.load(vrow, mrow, j0);
    float out[kGroup];
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      const float x = grp.x[j];
      const bool msk = grp.valid(j);
      const float s = !kSmemSeason ? buf[j] : kRingSeason ? ring[j] : sp[off];
      const float lt = __fadd_rn(level, trend);
      const float forecast = __fadd_rn(lt, s);
      const float new_level = __fadd_rn(__fmul_rn(alpha, __fsub_rn(x, s)), __fmul_rn(oma, lt));
      const float new_trend =
          __fadd_rn(__fmul_rn(beta, __fsub_rn(new_level, level)), __fmul_rn(omb, trend));
      const float new_s = __fadd_rn(__fmul_rn(gamma, __fsub_rn(x, new_level)), __fmul_rn(omg, s));
      // branch-free: a step that updates nothing stores back the entry it
      // read, unchanged
      const bool upd = msk && inited;
      if (store) sp[off] = upd ? new_s : s;
      level = upd ? new_level : level;
      trend = upd ? new_trend : trend;
      if (kSmemSeason && kRingSeason) {
        ring[j] = sp[off_ld];
        off_ld = next(off_ld);
      }
      out[j] = inited ? forecast : x;  // zero residual before the first point
      if (msk) {
        const float e = __fsub_rn(x, out[j]);
        sse += static_cast<double>(__fmul_rn(e, e));
      }
      inited = inited || msk;
      off = next(off);
    }
    if (!kSmemSeason) fetch(buf);  // the group after the next one
    if (kPred) put_group(prow, j0, out);
  };

  chain_tiles<kPred>(p, [&](const float* vt, const uint8_t* mt, float* pt, long long t0) {
    const float* vrow = vt + r * kValStride;
    const uint8_t* mrow = mt + r * kMaskStride;
    float* prow = kPred ? pt + r * kValStride : nullptr;
    // groups alternate between sa and sb; a tile holds an even count
#pragma unroll 1
    for (int j0 = 0; j0 < kTile; j0 += 2 * kGroup) {
      if (t0 + j0 >= n_steps) break;  // uniform across the block
      run_group(vrow, mrow, prow, j0, sa);
      if (t0 + j0 + kGroup >= n_steps) break;
      run_group(vrow, mrow, prow, j0 + kGroup, sb);
    }
  });
  if constexpr (kPred) {
    tail_lt[tid] = __fadd_rn(level, trend);
    tail_inited[tid] = inited;
    fill_tail(p, t_tail, tail_lt, tail_inited, tail_season, stride, m);
  }

  if (!active) return;
  if (kSmemSeason)
    for (int q = 0; q < m; ++q) a.season[q * n_lanes + lane] = sp[q * stride];
  a.level[lane] = level;
  a.trend[lane] = trend;
  a.sse[lane] = sse;
}

template <bool kSmemSeason, bool kRingSeason, bool kPred>
cudaError_t launch(const HwArgs& a, unsigned blocks, int threads, int smem, cudaStream_t stream) {
  auto kernel = holt_winters_scan_kernel<kSmemSeason, kRingSeason, kPred>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// values [B, T] f32, mask [B, T] bytes, last_valid [B] int32 (each row's
// last valid index, -1 for none), init_level [B], init_season [B, m];
// params [G, 3] (per_series = 0) or [B, 3] with G = 1 (per_series = 1),
// rows (alpha, beta, gamma). Outputs per lane i = b * G + g: level, trend,
// sse (f64) [B * G], season [m, B * G]; pred [B, T] (G = 1 only) or null.
// Refuses (cudaErrorInvalidValue) G outside [1, 256], m < 1, T >= 2^31,
// pred with G > 1 and a device-memory season of 2^31 entries or more (its
// offsets are 32-bit); the wrapper splits larger calls into launches.
FM_API int fm_holt_winters_scan(const float* values, const uint8_t* mask, const int* last_valid,
                                const float* init_level, const float* init_season,
                                const float* params, float* level, float* trend,
                                float* season, double* sse, float* pred,
                                long long per_series, long long B, long long T,
                                long long m, long long G, cudaStream_t stream) {
  if (G < 1 || G > kMaxG || m < 1 || T < 0 || T >= (1ll << 31) || (pred && G != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return static_cast<int>(cudaSuccess);
  const int R = rows_per_block(G);
  const int C = chain_threads(G);
  const bool smem_season = m <= kSeasonSmemMax;
  if (!smem_season && m * B * G >= (1ll << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const HwArgs a{values, mask, last_valid, init_level, init_season, params,
                 level, trend, season, sse, pred, B, T, static_cast<int>(m),
                 static_cast<int>(G), per_series != 0,
                 vector_rows(T, values, mask, pred)};
  const unsigned blocks = static_cast<unsigned>((B + R - 1) / R);
  const int threads = C + kLanes * (pred ? 2 : 1);
  const int smem = static_cast<int>(tile_bytes(R, pred != nullptr) +
                                    (smem_season ? m * C * 4 : 0));
  cudaError_t err;
  if (smem_season && m > kRing)
    err = pred ? launch<true, true, true>(a, blocks, threads, smem, stream)
               : launch<true, true, false>(a, blocks, threads, smem, stream);
  else if (smem_season)
    err = pred ? launch<true, false, true>(a, blocks, threads, smem, stream)
               : launch<true, false, false>(a, blocks, threads, smem, stream);
  else
    err = pred ? launch<false, false, true>(a, blocks, threads, smem, stream)
               : launch<false, false, false>(a, blocks, threads, smem, stream);
  return static_cast<int>(err);
}

// The layout callers shape their edge cases by: out[0..3] = time steps a
// staged tile, steps the shared-memory season is read ahead (a ring for m
// above it), the longest season kept in shared memory, the most parameter
// sets a launch takes.
FM_API void fm_holt_winters_scan_layout(long long* out) {
  out[0] = kTile;
  out[1] = kRing;
  out[2] = kSeasonSmemMax;
  out[3] = kMaxG;
}
