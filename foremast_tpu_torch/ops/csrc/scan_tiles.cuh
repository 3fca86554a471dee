// Shared device code of the two scan kernels (holt_winters_scan,
// holt_scan): the block layout, the pipeline that stages [rows, kTile]
// tiles of the history in shared memory, and the coalesced write-back of
// tiles of predictions.
//
// A block owns R series, one chain thread per (series, parameter set):
// R * G chain threads in whole warps (rows_per_block). Beside the chain
// warps, a loader warp copies [R, kTile] tiles of values (f32) and mask
// (bytes) into a ring of kStages stages with cp.async, 16 bytes a thread,
// coalesced along each row, and, when the kernel writes predictions, a
// storer warp copies each finished [R, kTile] tile of `pred` from shared
// memory to device memory as 16-byte row stores. The chain warps only
// compute: a chain thread reads its row's next kGroup steps as four float4
// and one uint4 (the G threads of a series read the same words: a
// broadcast) and writes its predictions the same way. The three roles hand
// stages over through named barriers (a producer arrives, the consumer
// waits), so the chain never waits on device memory while the loader runs
// kStages - 1 tiles ahead. Rows are padded by 16 bytes (kValStride,
// kMaskStride), so the eight 16-byte reads of a quarter warp, one per row,
// fall in eight different bank groups: no conflict, and every cp.async
// destination stays 16-byte aligned.
#pragma once

#include "common.cuh"

namespace fm {
namespace scan {

constexpr int kLanes = 32;               // a warp; the series of a per-series block
constexpr int kGridLanes = 128;          // lanes a block of G > 1 parameter sets aims for
constexpr int kMaxG = 256;               // at most G = 256 parameter sets a launch
constexpr int kMaxBlock = kMaxG + 2 * kLanes;  // chain warps, loader, storer
constexpr int kTile = 64;                // time steps a staged tile
constexpr int kStages = 4;               // tiles in the ring
constexpr int kPredSlots = 2;            // prediction tiles in the ring
constexpr int kGroup = 16;               // steps a thread reads at once
constexpr int kValStride = kTile + 4;    // floats a row of a values / pred tile
constexpr int kMaskStride = kTile + 16;  // bytes a row of a mask tile

// Named barriers (0 is __syncthreads): stage s is full / may be refilled,
// prediction slot p is full / may be rewritten.
constexpr int kBarFull = 1;
constexpr int kBarEmpty = kBarFull + kStages;
constexpr int kBarPredFull = kBarEmpty + kStages;
constexpr int kBarPredEmpty = kBarPredFull + kPredSlots;
static_assert(kBarPredEmpty + kPredSlots <= 16, "a block has 16 named barriers");

// Series a block owns for G lanes a series: one warp of series when G =
// 1 (B = 4,096 series fill 128 SMs with one block each), else about
// kGridLanes lanes (the grid's 8 x 4,096 lanes: two blocks an SM).
__host__ __device__ constexpr int rows_per_block(long long G) {
  return G == 1 ? kLanes : G >= kGridLanes ? 1 : static_cast<int>(kGridLanes / G);
}

// Chain threads of a block: its R * G lanes rounded up to whole warps.
__host__ __device__ constexpr int chain_threads(long long G) {
  return (rows_per_block(G) * static_cast<int>(G) + kLanes - 1) / kLanes * kLanes;
}

// Dynamic shared memory of the tiles: kStages values and mask tiles, and
// kPredSlots prediction tiles when `pred`.
__host__ __device__ constexpr long long tile_bytes(int R, bool pred) {
  return static_cast<long long>(kStages) * R * (kValStride * 4 + kMaskStride) +
         (pred ? static_cast<long long>(kPredSlots) * R * kValStride * 4 : 0);
}

// True when every tile may move as 16-byte cp.async / float4 copies: rows
// start 16-byte aligned in both tensors, and a 16-step mask chunk lies
// wholly inside or wholly past the row.
inline bool vector_rows(long long T, const void* values, const void* mask,
                        const void* pred) {
  return T % 16 == 0 && aligned(values, 16) && aligned(mask, 16) &&
         (pred == nullptr || aligned(pred, 16));
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Arrive without waiting; the fence orders this thread's writes to shared
// memory (its copies, its predictions) before the arrival.
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  __threadfence_block();
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// 16 bytes from device to shared memory; zeros, and no read, when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void st_global_v4(float* dst, float4 v) {
  asm volatile("st.global.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"l"(dst), "f"(v.x), "f"(v.y),
               "f"(v.z), "f"(v.w)
               : "memory");
}

// What the three roles of a block share: the block's rows and tiles.
struct Pipe {
  float* vals;     // [kStages][R][kValStride]
  uint8_t* masks;  // [kStages][R][kMaskStride]
  float* ptiles;   // [kPredSlots][R][kValStride], or null
  const float* __restrict__ values;
  const uint8_t* __restrict__ mask;
  float* pred;
  long long b0, T;
  int rows, R, n_tiles;
  int bar_threads;  // chain threads + one warp
  bool vec;

  __device__ float* stage_vals(int k) const { return vals + (k % kStages) * R * kValStride; }
  __device__ uint8_t* stage_mask(int k) const { return masks + (k % kStages) * R * kMaskStride; }
  __device__ float* pred_slot(int k) const { return ptiles + (k % kPredSlots) * R * kValStride; }
};

// Loader lane l: copy columns [t0, t0 + kTile) of the block's rows into
// tile k's stage; zeros past T and past the last row.
__device__ __forceinline__ void stage_tile(const Pipe& p, int k, int l) {
  float* vt = p.stage_vals(k);
  uint8_t* mt = p.stage_mask(k);
  const long long t0 = static_cast<long long>(k) * kTile;
  if (p.vec) {
    // values: 16 chunks of 4 steps a row, lane l takes chunk l % 16 of
    // every second row; mask: 4 chunks of 16 steps, chunk l % 4 of every
    // eighth row. T % 16 == 0, so a chunk is wholly inside or past T.
    const int q = l & 15;
    const long long t = t0 + q * 4;
#pragma unroll 4
    for (int r = l >> 4; r < p.R; r += 2) {
      const bool ok = r < p.rows && t < p.T;
      const float* src = p.values + (ok ? (p.b0 + r) * p.T + t : 0);
      cp_async16(vt + r * kValStride + q * 4, src, ok);
    }
    const int qm = l & 3;
    const long long tm = t0 + qm * 16;
#pragma unroll 4
    for (int r = l >> 2; r < p.R; r += 8) {
      const bool ok = r < p.rows && tm < p.T;
      const uint8_t* src = p.mask + (ok ? (p.b0 + r) * p.T + tm : 0);
      cp_async16(mt + r * kMaskStride + qm * 16, src, ok);
    }
    return;
  }
  for (int c = l; c < p.R * kTile; c += kLanes) {
    const int r = c / kTile, j = c % kTile;
    const long long t = t0 + j;
    const bool ok = r < p.rows && t < p.T;
    vt[r * kValStride + j] = ok ? p.values[(p.b0 + r) * p.T + t] : 0.f;
    mt[r * kMaskStride + j] = ok ? p.mask[(p.b0 + r) * p.T + t] : 0;
  }
}

// Storer lane l: write tile k's prediction slot to columns [t0, t0 +
// kTile) of the block's rows of pred [B, T], clipped at T.
__device__ __forceinline__ void store_pred_tile(const Pipe& p, int k, int l) {
  const float* pt = p.pred_slot(k);
  const long long t0 = static_cast<long long>(k) * kTile;
  if (p.vec) {
    const int q = l & 15;
    const long long t = t0 + q * 4;
    if (t >= p.T) return;  // T % 4 == 0: a chunk is wholly inside or past T
#pragma unroll 4
    for (int r = l >> 4; r < p.rows; r += 2)
      st_global_v4(p.pred + (p.b0 + r) * p.T + t,
                   *reinterpret_cast<const float4*>(pt + r * kValStride + q * 4));
    return;
  }
  for (int c = l; c < p.rows * kTile; c += kLanes) {
    const int r = c / kTile, j = c % kTile;
    const long long t = t0 + j;
    if (t < p.T) p.pred[(p.b0 + r) * p.T + t] = pt[r * kValStride + j];
  }
}

// The loader warp: keeps kStages - 1 tiles in flight ahead of the chain.
__device__ __forceinline__ void load_tiles(const Pipe& p, int l) {
#pragma unroll 1
  for (int k = 0; k < kStages - 1; ++k) {
    if (k < p.n_tiles) stage_tile(p, k, l);
    cp_async_commit();  // an empty group keeps the count uniform
  }
#pragma unroll 1
  for (int k = 0; k < p.n_tiles; ++k) {
    cp_async_wait<kStages - 2>();  // tile k landed (the kStages - 2 after it may not)
    bar_arrive(kBarFull + k % kStages, p.bar_threads);
    const int kn = k + kStages - 1;
    if (kn < p.n_tiles) {
      if (kn >= kStages) bar_sync(kBarEmpty + kn % kStages, p.bar_threads);  // tile kn - kStages read
      stage_tile(p, kn, l);
    }
    cp_async_commit();
  }
}

// The storer warp: writes each prediction tile once the chain filled it.
__device__ __forceinline__ void store_tiles(const Pipe& p, int l) {
#pragma unroll 1
  for (int k = 0; k < p.n_tiles; ++k) {
    bar_sync(kBarPredFull + k % kPredSlots, p.bar_threads);
    store_pred_tile(p, k, l);
    if (k + kPredSlots < p.n_tiles) bar_arrive(kBarPredEmpty + k % kPredSlots, p.bar_threads);
  }
}

// The chain warps: `body(vt, mt, pt, t0)` consumes tile k (vt / mt: the
// stage's [R][kValStride] values and [R][kMaskStride] mask tiles, t0 =
// k * kTile) and, with kPred, fills the prediction slot pt.
template <bool kPred, typename Body>
__device__ __forceinline__ void chain_tiles(const Pipe& p, Body&& body) {
#pragma unroll 1
  for (int k = 0; k < p.n_tiles; ++k) {
    bar_sync(kBarFull + k % kStages, p.bar_threads);
    float* pt = nullptr;
    if (kPred) {
      if (k >= kPredSlots) bar_sync(kBarPredEmpty + k % kPredSlots, p.bar_threads);
      pt = p.pred_slot(k);
    }
    body(p.stage_vals(k), p.stage_mask(k), pt, static_cast<long long>(k) * kTile);
    if (k + kStages < p.n_tiles) bar_arrive(kBarEmpty + k % kStages, p.bar_threads);
    if (kPred) bar_arrive(kBarPredFull + k % kPredSlots, p.bar_threads);
  }
}

// The kGroup steps of one row at column j0 of a stage's tiles: values in
// x[0..15], mask bytes packed four to a word in w[0..3].
struct Group {
  float x[kGroup];
  uint32_t w[kGroup / 4];

  __device__ __forceinline__ void load(const float* vrow, const uint8_t* mrow, int j0) {
    const float4* v4 = reinterpret_cast<const float4*>(vrow + j0);
#pragma unroll
    for (int q = 0; q < kGroup / 4; ++q) {
      const float4 v = v4[q];
      x[4 * q] = v.x;
      x[4 * q + 1] = v.y;
      x[4 * q + 2] = v.z;
      x[4 * q + 3] = v.w;
    }
    const uint4 m = *reinterpret_cast<const uint4*>(mrow + j0);
    w[0] = m.x;
    w[1] = m.y;
    w[2] = m.z;
    w[3] = m.w;
  }

  __device__ __forceinline__ bool valid(int j) const {
    return ((w[j >> 2] >> ((j & 3) * 8)) & 0xffu) != 0;
  }
};

// Store kGroup predictions at column j0 of a prediction tile row.
__device__ __forceinline__ void put_group(float* prow, int j0, const float* out) {
  float4* p4 = reinterpret_cast<float4*>(prow + j0);
#pragma unroll
  for (int q = 0; q < kGroup / 4; ++q)
    p4[q] = make_float4(out[4 * q], out[4 * q + 1], out[4 * q + 2], out[4 * q + 3]);
}

// Columns [t_from, T) of the block's rows of pred, past the tiles the
// chain ran, where every row's state is frozen: lt[r] + season_r[t mod m]
// (lt[r] without a season) on a row that saw a valid point (inited[r]),
// x[r, t] on one that did not; the same rounded add as the chain's
// forecast. Row r's season entry of phase q is season[r + q * stride].
// Every thread of the block takes part: it opens with a __syncthreads
// that publishes lt, inited and the season; then lane l writes row l, a
// warp kGroup steps of it at a time (64 bytes a lane: whole sectors), the
// warps in turn. A warp's season reads are one coalesced row (device
// memory) or one conflict-free row (shared memory) a step, kGroup of them
// in flight.
__device__ __forceinline__ void fill_tail(const Pipe& p, long long t_from,
                                          const float* lt_rows, const int* inited_rows,
                                          const float* season, int stride, int m) {
  __syncthreads();
  const int l = threadIdx.x % kLanes;
  if (l >= p.rows || t_from >= p.T) return;
  const int step = kGroup * static_cast<int>(blockDim.x / kLanes);
  const int advance = step % m;
  const float lt = lt_rows[l];
  const bool inited = inited_rows[l] != 0;
  const float* xrow = p.values + (p.b0 + l) * p.T;
  float* prow = p.pred + (p.b0 + l) * p.T;
  long long t = t_from + kGroup * (threadIdx.x / kLanes);
  int q = static_cast<int>(t % m);
#pragma unroll 2
  for (; t < p.T; t += step) {
    float v[kGroup];
    if (inited) {
      int qi = q;
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
        v[i] = season ? __fadd_rn(lt, season[l + qi * stride]) : lt;
        qi = qi + 1 == m ? 0 : qi + 1;
      }
    } else {
#pragma unroll
      for (int i = 0; i < kGroup; ++i) v[i] = t + i < p.T ? xrow[t + i] : 0.f;
    }
    if (p.vec) {  // T % 16 == 0: the kGroup steps lie wholly inside T
#pragma unroll
      for (int i = 0; i < kGroup; i += 4)
        st_global_v4(prow + t + i, make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]));
    } else {
#pragma unroll
      for (int i = 0; i < kGroup; ++i)
        if (t + i < p.T) prow[t + i] = v[i];
    }
    q += advance;
    if (q >= m) q -= m;
  }
}

// The chain's length for a block: its rows' largest last valid index,
// plus one (0 when no row has a valid point). Every thread gets it.
__device__ __forceinline__ int block_chain_end(const int* __restrict__ last_valid,
                                               long long b0, int rows, int G,
                                               int* slot) {
  if (threadIdx.x == 0) *slot = 0;
  __syncthreads();
  const int r = threadIdx.x / G;
  if (r < rows && threadIdx.x % G == 0) atomicMax(slot, last_valid[b0 + r] + 1);
  __syncthreads();
  return *slot;
}

}  // namespace scan
}  // namespace fm
