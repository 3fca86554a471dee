// lstm_ae_backward: backpropagation through time of the masked LSTM
// autoencoder for S models: per-model gradients of every parameter leaf
// from the upstream gradient of err [S, W, T].
//
// Replaces `jax.grad(loss_fn)` of the JAX package's
// foremast_tpu/models/lstm_ae.py:128-131 (no Pallas kernel: XLA
// differentiates the `lax.scan`). `lstm_ae_forward` saved each step's
// activations (i, f, g, o after their nonlinearities, c, h; masked
// encoder steps save the carried state), so no step is recomputed except
// the decoder's output y_t = h_t @ w_out + b_out.
//
// BPTT has a dependent part, the carry (dh, dc) walked from the last step
// to the first with dh_prev = w_h . da, and a part that depends on nothing
// carried: every parameter gradient is a sum over the (window, step)
// pairs of products of saved activations with the step's gate gradients
// da or output gradients dy. Two kernels, launched back to back:
//
//  1. chain: one block a model, one warp a window, lane j unit j. It walks
//     the decoder from t = T-1 down, then the encoder, and writes each
//     step's da to dA [S, W, 2T, 4H] (unit-major: unit j's i, f, g, o at
//     4j, one float4 a lane; zeros at a masked encoder step, which passes
//     dh and dc through). No weight gradient is summed here. The 2T
//     activation rows (768 B each) are read once, in descending order,
//     through a per-warp ring of kRing rows in shared memory filled by
//     cp.async kRing - 1 rows ahead; a row serves its own step and then,
//     as the previous state, the step above. dh_prev: lane j holds its
//     own 4 gate columns of w_h for all 32 rows (128 registers), forms its
//     share of every dh_prev entry and a 31-shuffle reduce-scatter sums
//     the shares. The decoder's dy [S, W, T, F] and its w_out dy term are
//     formed 32 steps at a time, one step a lane, off the carried chain.
//  2. products: one block a (model, cell) forms
//       [h_prev | x | 1]^T dA -> dW_h, the encoder's dW_x, db
//       [h | 1]^T dy          -> dW_out, db_out (decoder)
//     over K = W * T pairs: tiles of kTileK steps staged in shared memory
//     by cp.async, two in flight; each thread owns 12 rows x 4 columns of
//     the [48, 4H] product over every other step of a tile, and the two
//     halves are added in one order at the end. No atomics; every gradient
//     element is written once, so two calls give the same bits.
//
// What bounds it on the H100: the chain is latency-bound: 245 registers a
// thread leave one 8-warp block an SM, two warps a scheduler, and a step
// is ~300 instructions a warp (128 FMAs, the reduce-scatter, the cell)
// along one dependent path. The products stream dA (written and read once
// more: 134 MB at S=512, W=8, T=32) and h, ~2.4 GFLOP, two blocks an SM.
#include "lstm_ae.cuh"

namespace {

using namespace fm;

constexpr int kMaxW = 8;                  // windows a model: one warp each
constexpr int kRing = 8;                  // activation rows a warp holds in shared memory
constexpr int kChunk = 32;                // steps of x / mask / grad_err a lane load covers
constexpr int kPieces = kActStride / 4;   // 16-byte pieces of an activation row (48)
constexpr int kRows = 48;                 // product rows: h (32), then x (F) and 1, padded
constexpr int kRowsPerWarp = kRows / 4;   // 12: warps w and w + 4 own rows 12w .. 12w + 11
constexpr int kTileK = 32;                // steps a staged product tile

// The activation rows of one window, in descending order, through a ring
// of kRing rows in shared memory. Each row is one cp.async group, so the
// count of groups in flight stays uniform (an absent row commits an empty
// group).
struct RowStream {
  const float* rows;  // the window's [2T][kActStride]
  float* ring;        // [kRing][kActStride]
  int lane;

  __device__ __forceinline__ void fetch(int u) const {
    if (u >= 0) {
      float* dst = ring + (u % kRing) * kActStride;
      const float* src = rows + static_cast<long long>(u) * kActStride;
      cp_async16(dst + 4 * lane, src + 4 * lane, true);
      if (lane < kPieces - 32) cp_async16(dst + 128 + 4 * lane, src + 128 + 4 * lane, true);
    }
    cp_async_commit();
  }

  // Row u - 1 (the state before step u; zero before step 0), once row u
  // is in registers; then row u - kRing takes row u's slot.
  __device__ __forceinline__ Step advance(int u) const {
    cp_async_wait<kRing - 2>();
    __syncwarp();
    Step prev = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (u > 0) prev = load_step(ring + ((u - 1) % kRing) * kActStride, lane);
    fetch(u - kRing);
    return prev;
  }
};

// One model's w_h [H][4H] into shared memory, block-wide and coalesced.
__device__ __forceinline__ void stage_wh(const float* __restrict__ w, float* dst) {
  const float4* src = reinterpret_cast<const float4*>(w);
  for (int i = threadIdx.x; i < kH * kG / 4; i += blockDim.x) reinterpret_cast<float4*>(dst)[i] = src[i];
}

// Lane L's columns of a staged w_h, rows XOR-permuted: wc[k][g] =
// w_h[k ^ L][g * H + L]. With that order the reduce-scatter in cell_back
// always keeps the low half of its registers and sends the high half.
__device__ __forceinline__ void load_wh_cols(const float* w, int lane, float (&wc)[kH][4]) {
#pragma unroll
  for (int k = 0; k < kH; ++k) {
    const float* row = w + (k ^ lane) * kG + lane;  // lane-consecutive: no bank conflict
#pragma unroll
    for (int g = 0; g < 4; ++g) wc[k][g] = row[g * kH];
  }
}

// One round of the reduce-scatter: the low n registers gain the partner's
// high n (lane L ^ n holds the same entries there, by the XOR order).
template <int N>
__device__ __forceinline__ void reduce_scatter_round(float (&v)[kH]) {
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] += __shfl_xor_sync(kFull, v[i + N], N);
}

// One cell step backward from the step's activations, the previous c and
// the incoming dh (output + carried) and dc: writes the gate
// pre-activation gradients da to `out` (the step's dA row) and returns
// dh_prev = w_h . da for this lane's unit; dc becomes the carry dc * f.
// Each lane forms its own gate columns' share of all 32 dh_prev entries
// (128 FMAs); a reduce-scatter of 31 shuffles sums the shares, leaving
// entry L on lane L.
__device__ __forceinline__ float cell_back(const Step& s, float c_prev, float dh, float& dc,
                                           const float (&wc)[kH][4], float4* __restrict__ out, int lane) {
  const float tc = tanhf(s.c);
  const float d_o = dh * tc;
  dc += dh * s.o * (1.f - tc * tc);
  const float d_i = dc * s.g;
  const float d_g = dc * s.i;
  const float d_f = dc * c_prev;
  float da[4];
  da[0] = d_i * s.i * (1.f - s.i);
  da[1] = d_f * s.f * (1.f - s.f);
  da[2] = d_g * (1.f - s.g * s.g);
  da[3] = d_o * s.o * (1.f - s.o);
  out[lane] = make_float4(da[0], da[1], da[2], da[3]);
  float v[kH];
#pragma unroll
  for (int k = 0; k < kH; ++k) v[k] = ((wc[k][0] * da[0] + wc[k][1] * da[1]) + wc[k][2] * da[2]) + wc[k][3] * da[3];
  reduce_scatter_round<16>(v);
  reduce_scatter_round<8>(v);
  reduce_scatter_round<4>(v);
  reduce_scatter_round<2>(v);
  reduce_scatter_round<1>(v);
  dc *= s.f;
  return v[0];
}

__global__ void __launch_bounds__(32 * kMaxW, 1)
    lstm_ae_chain_kernel(const float* __restrict__ enc_wh,
                         const float* __restrict__ dec_wh,
                         const float* __restrict__ w_out,
                         const float* __restrict__ b_out,
                         const float* __restrict__ x,
                         const uint8_t* __restrict__ mask,
                         const float* __restrict__ act,
                         const float* __restrict__ grad_err,
                         float* __restrict__ d_gates, float* __restrict__ d_out,
                         int W, int T, int F) {
  extern __shared__ __align__(16) float smem[];
  float* s_wdec = smem;                           // [H][4H]: the decoder's w_h
  float* s_wenc = s_wdec + kH * kG;               // the encoder's
  float* s_ring = s_wenc + kH * kG;               // [W][kRing][kActStride]
  float* s_dy = s_ring + W * kRing * kActStride;  // [W][kChunk][kMaxF]: a chunk's dy
  float* s_wo = s_dy + W * kChunk * kMaxF;        // [H][kMaxF]: w_out, zero past F

  const long long s = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long win = s * W + warp;
  const float* xw = x + win * T * F;
  const uint8_t* mw = mask + win * T;
  const float* gw = grad_err + win * T;
  const float* aw = act + win * 2LL * T * kActStride;
  float4* dA = reinterpret_cast<float4*>(d_gates + win * 2LL * T * kG);
  float* dy = d_out + win * T * F;
  float* dyk = s_dy + warp * kChunk * kMaxF;

  stage_wh(dec_wh + s * kH * kG, s_wdec);
  stage_wh(enc_wh + s * kH * kG, s_wenc);
  for (int i = threadIdx.x; i < kH * kMaxF; i += blockDim.x) {
    const int j = i / kMaxF, f = i % kMaxF;
    s_wo[i] = f < F ? w_out[(s * kH + j) * F + f] : 0.f;
  }
  __syncthreads();

  float wc[kH][4];
  load_wh_cols(s_wdec, lane, wc);
  float wo[kMaxF];  // this lane's row of w_out
#pragma unroll
  for (int f = 0; f < kMaxF; ++f) wo[f] = s_wo[lane * kMaxF + f];
  float bo[kMaxF];
#pragma unroll
  for (int f = 0; f < kMaxF; ++f) bo[f] = f < F ? b_out[s * F + f] : 0.f;
  const RowStream rs{aw, s_ring + warp * kRing * kActStride, lane};
  const int n = 2 * T;
#pragma unroll
  for (int d = 0; d < kRing; ++d) rs.fetch(n - 1 - d);
  cp_async_wait<kRing - 1>();
  __syncwarp();
  Step cur = load_step(rs.ring + ((n - 1) % kRing) * kActStride, lane);

  // ---- decoder, t = T-1 .. 0: step u = T + t; its previous state is
  // row u - 1, the encoder's final state at t = 0
  float dh = 0.f, dc = 0.f;
  const float two_over_f = 2.f / static_cast<float>(F);
  for (int t = T - 1; t >= 0; --t) {
    const int k = (T - 1 - t) % kChunk;
    if (k == 0) {
      // the output gradients of steps t .. t - 31, one a lane, off the
      // carried chain: dy = d err / d y = 2 (y - x) / F where the step
      // counts, y = h w_out + b_out from the step's saved h
      const int tl = t - lane;
      float d[kMaxF];
#pragma unroll
      for (int f = 0; f < kMaxF; ++f) d[f] = 0.f;
      if (tl >= 0 && mw[tl]) {
        const float de = gw[tl] * two_over_f;
        const float4* h4 = reinterpret_cast<const float4*>(aw + static_cast<long long>(T + tl) * kActStride + 5 * kH);
        float y[kMaxF];
#pragma unroll
        for (int f = 0; f < kMaxF; ++f) y[f] = 0.f;
#pragma unroll
        for (int q = 0; q < kH / 4; ++q) {
          const float4 hv = h4[q];
          const float hs[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float4* w4 = reinterpret_cast<const float4*>(s_wo + (4 * q + c) * kMaxF);
            const float4 lo = w4[0];
            y[0] += hs[c] * lo.x;
            y[1] += hs[c] * lo.y;
            y[2] += hs[c] * lo.z;
            y[3] += hs[c] * lo.w;
            if (F > 4) {
              const float4 hi = w4[1];
              y[4] += hs[c] * hi.x;
              y[5] += hs[c] * hi.y;
              y[6] += hs[c] * hi.z;
              y[7] += hs[c] * hi.w;
            }
          }
        }
#pragma unroll
        for (int f = 0; f < kMaxF; ++f)
          if (f < F) d[f] = de * ((y[f] + bo[f]) - xw[tl * F + f]);
      }
      if (tl >= 0) {
#pragma unroll
        for (int f = 0; f < kMaxF; ++f)
          if (f < F) dy[tl * F + f] = d[f];
      }
      __syncwarp();  // every lane has read the last chunk's slots
      float4* slot = reinterpret_cast<float4*>(dyk + lane * kMaxF);
      slot[0] = make_float4(d[0], d[1], d[2], d[3]);
      slot[1] = make_float4(d[4], d[5], d[6], d[7]);
      __syncwarp();
    }
    const Step prev = rs.advance(T + t);
    const float4* dk = reinterpret_cast<const float4*>(dyk + k * kMaxF);
    const float4 d0 = dk[0];
    dh += ((wo[0] * d0.x + wo[1] * d0.y) + wo[2] * d0.z) + wo[3] * d0.w;
    if (F > 4) {
      const float4 d1 = dk[1];
      dh += ((wo[4] * d1.x + wo[5] * d1.y) + wo[6] * d1.z) + wo[7] * d1.w;
    }
    dh = cell_back(cur, prev.c, dh, dc, wc, dA + (T + t) * kH, lane);
    cur = prev;
  }

  // ---- encoder, t = T-1 .. 0; a masked step passes dh, dc through and
  // leaves a zero dA row
  load_wh_cols(s_wenc, lane, wc);
  int keep_c = 0;
  for (int t = T - 1; t >= 0; --t) {
    const int k = (T - 1 - t) % kChunk;
    if (k == 0) keep_c = t - lane >= 0 && mw[t - lane];
    const Step prev = rs.advance(t);
    float4* out = dA + t * kH;
    if (__shfl_sync(kFull, keep_c, k)) {
      dh = cell_back(cur, prev.c, dh, dc, wc, out, lane);
    } else {
      out[lane] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    cur = prev;
  }
  cp_async_wait<0>();  // no copy outlives the block
}

// Stage product tile `tile` (window tile / tiles_w, steps t0 .. t0 + n - 1)
// of one (model, cell) into stage buffers a / b / y: one cp.async group.
struct ProductTiles {
  const float* x;
  const float* act;
  const float* d_gates;
  const float* d_out;
  long long s;
  int cell, W, T, F, tiles_w;

  __device__ __forceinline__ void stage(int tile, float (*a)[kRows], float (*b)[kG], float (*y)[kMaxF]) const {
    const int t0 = (tile % tiles_w) * kTileK;
    const int n = min(kTileK, T - t0);
    const long long win = s * W + tile / tiles_w;
    const int u0 = cell * T + t0;  // the window's row of step t0
    const float* src = d_gates + (win * 2LL * T + u0) * kG;
    for (int i = threadIdx.x; i < n * (kG / 4); i += blockDim.x)
      cp_async16(&b[0][0] + 4 * i, src + 4 * i, true);
    // h of row u0 + k - 1 for k = 0 .. n: 8 pieces a row; zeros before the
    // encoder's first step
    const float* aw = act + win * 2LL * T * kActStride + 5 * kH;
    for (int i = threadIdx.x; i < (n + 1) * (kH / 4); i += blockDim.x) {
      const int k = i / (kH / 4), p = i % (kH / 4);
      const int u = u0 + k - 1;
      cp_async16(&a[k][4 * p], u >= 0 ? aw + static_cast<long long>(u) * kActStride + 4 * p : aw, u >= 0);
    }
    const long long xy = (win * T + t0) * F;
    if (cell == 0) {
      for (int i = threadIdx.x; i < n * F; i += blockDim.x) cp_async4(&a[i / F][kH + i % F], x + xy + i);
    } else {
      for (int i = threadIdx.x; i < n * F; i += blockDim.x) cp_async4(&y[i / F][i % F], d_out + xy + i);
    }
  }
};

__global__ void __launch_bounds__(256, 2)
    lstm_ae_products_kernel(const float* __restrict__ x,
                            const float* __restrict__ act,
                            const float* __restrict__ d_gates,
                            const float* __restrict__ d_out,
                            float* __restrict__ g_enc_wx,
                            float* __restrict__ g_enc_wh,
                            float* __restrict__ g_enc_b,
                            float* __restrict__ g_dec_wh,
                            float* __restrict__ g_dec_b,
                            float* __restrict__ g_wout,
                            float* __restrict__ g_bout, int W, int T, int F) {
  // Two stages. s_a[st][k]: h of the step before step t0 + k (cols 0..31),
  // then step t0 + k's x (encoder) and the bias' 1, zeros to kRows; row
  // kTileK holds only h, the last step's own (the output layer's h of step
  // t0 + k is s_a[st][k + 1]). s_b[st][k]: dA of step t0 + k, unit-major.
  __shared__ __align__(16) float s_a[2][kTileK + 1][kRows];
  __shared__ __align__(16) float s_b[2][kTileK][kG];
  __shared__ float s_y[2][kTileK][kMaxF];  // dy of step t0 + k (decoder)

  const int cell = blockIdx.y;  // 0: encoder, 1: decoder (its rows T .. 2T-1)
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int kgroup = tid >> 7;       // the half of each tile's steps this warp sums
  const int wq = (tid >> 5) & 3;     // rows 12 wq .. 12 wq + 11
  const int n_rows = kH + 1 + (cell == 0 ? F : 0);
  const bool gates = wq * kRowsPerWarp < n_rows;  // warp-uniform
  // the decoder's gate rows end at 33: warps 3 and 7 form [h | 1]^T dy,
  // lane j row j of dW_out (and lane f < F entry f of db_out)
  const bool outputs = cell == 1 && !gates;
  const int tiles_w = (T + kTileK - 1) / kTileK;
  const int n_tiles = W * tiles_w;
  const ProductTiles pt{x, act, d_gates, d_out, static_cast<long long>(blockIdx.x), cell, W, T, F, tiles_w};
  const long long s = pt.s;

  // the columns no copy writes: the bias' 1 and the padding
  for (int i = tid; i < 2 * kTileK * (kRows - kH); i += blockDim.x) {
    const int st = i / (kTileK * (kRows - kH)), k = (i / (kRows - kH)) % kTileK, r = i % (kRows - kH);
    if (cell == 1 || r >= F) s_a[st][k][kH + r] = r == (cell == 0 ? F : 0) ? 1.f : 0.f;
  }
  for (int i = tid; i < 2 * kTileK * kMaxF; i += blockDim.x)
    if (i % kMaxF >= F) (&s_y[0][0][0])[i] = 0.f;
  if (n_tiles > 0) pt.stage(0, s_a[0], s_b[0], s_y[0]);
  cp_async_commit();

  float acc[kRowsPerWarp][4];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
  float acc_o[kMaxF], acc_b = 0.f;
#pragma unroll
  for (int f = 0; f < kMaxF; ++f) acc_o[f] = 0.f;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int st = tile & 1;
    if (tile + 1 < n_tiles) pt.stage(tile + 1, s_a[st ^ 1], s_b[st ^ 1], s_y[st ^ 1]);
    cp_async_commit();
    cp_async_wait<1>();  // this tile landed; the next may still be in flight
    __syncthreads();
    const int n = min(kTileK, T - (tile % tiles_w) * kTileK);
    if (gates) {
#pragma unroll 2
      for (int k = kgroup; k < n; k += 2) {
        const float4 b = reinterpret_cast<const float4*>(s_b[st][k])[lane];
        const float4* a4 = reinterpret_cast<const float4*>(&s_a[st][k][wq * kRowsPerWarp]);
        float a[kRowsPerWarp];
#pragma unroll
        for (int p = 0; p < kRowsPerWarp / 4; ++p) {
          const float4 v = a4[p];
          a[4 * p] = v.x;
          a[4 * p + 1] = v.y;
          a[4 * p + 2] = v.z;
          a[4 * p + 3] = v.w;
        }
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          acc[r][0] += a[r] * b.x;
          acc[r][1] += a[r] * b.y;
          acc[r][2] += a[r] * b.z;
          acc[r][3] += a[r] * b.w;
        }
      }
    } else if (outputs) {
#pragma unroll 2
      for (int k = kgroup; k < n; k += 2) {
        const float hv = s_a[st][k + 1][lane];
        const float4* y4 = reinterpret_cast<const float4*>(s_y[st][k]);
        const float4 lo = y4[0], hi = y4[1];
        acc_o[0] += hv * lo.x;
        acc_o[1] += hv * lo.y;
        acc_o[2] += hv * lo.z;
        acc_o[3] += hv * lo.w;
        acc_o[4] += hv * hi.x;
        acc_o[5] += hv * hi.y;
        acc_o[6] += hv * hi.z;
        acc_o[7] += hv * hi.w;
        acc_b += s_y[st][k][lane % kMaxF];
      }
    }
    __syncthreads();  // the stage is free for tile + 2
  }
  cp_async_wait<0>();

  // the two step halves, added in one order: kgroup 0's sum + kgroup 1's
  float* red = &s_b[0][0][0];      // [kRows][kG], free now
  float* red_o = &s_y[0][0][0];    // [H][kMaxF] and [kMaxF]
  if (gates && kgroup == 1) {
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r)
      reinterpret_cast<float4*>(red + (wq * kRowsPerWarp + r) * kG)[lane] =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  } else if (outputs && kgroup == 1) {
#pragma unroll
    for (int f = 0; f < kMaxF; ++f) red_o[lane * kMaxF + f] = acc_o[f];
    if (lane < kMaxF) red_o[kH * kMaxF + lane] = acc_b;
  }
  __syncthreads();
  if (gates && kgroup == 0) {
    float* wh = cell == 0 ? g_enc_wh : g_dec_wh;
    float* bias = cell == 0 ? g_enc_b : g_dec_b;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int row = wq * kRowsPerWarp + r;
      if (row >= n_rows) break;
      const float4 other = reinterpret_cast<const float4*>(red + row * kG)[lane];
      float* out = row < kH ? wh + (s * kH + row) * kG
                   : row < n_rows - 1 ? g_enc_wx + (s * F + row - kH) * kG
                                      : bias + s * kG;
      // unit `lane`'s four gate columns
      out[lane] = acc[r][0] + other.x;
      out[kH + lane] = acc[r][1] + other.y;
      out[2 * kH + lane] = acc[r][2] + other.z;
      out[3 * kH + lane] = acc[r][3] + other.w;
    }
  } else if (outputs && kgroup == 0) {
#pragma unroll
    for (int f = 0; f < kMaxF; ++f)
      if (f < F) g_wout[(s * kH + lane) * F + f] = acc_o[f] + red_o[lane * kMaxF + f];
    if (lane < F) g_bout[s * F + lane] = acc_b + red_o[kH * kMaxF + lane];
  }
}

// Dynamic shared memory of the chain kernel at W windows a model: both
// w_h, the activation rings, the chunks' dy and w_out.
size_t chain_smem(long long W) {
  return (2 * kH * kG + W * (kRing * kActStride + kChunk * kMaxF) + kH * kMaxF) * sizeof(float);
}

}  // namespace

// parts: 1 runs the chain, 2 the products, 3 both (the products read the
// chain's d_gates / d_out; a part alone is for timing).
FM_API int fm_lstm_ae_backward(const float* enc_wh, const float* dec_wh,
                               const float* w_out, const float* b_out,
                               const float* x, const uint8_t* mask,
                               const float* act, const float* grad_err,
                               float* d_gates, float* d_out,
                               float* g_enc_wx, float* g_enc_wh,
                               float* g_enc_b, float* g_dec_wh,
                               float* g_dec_b, float* g_wout, float* g_bout,
                               long long S, long long W, long long T,
                               long long F, long long parts, cudaStream_t stream) {
  if (S > 0 && W >= 1 && W <= kMaxW && F >= 1 && F <= kMaxF) {
    const int w = static_cast<int>(W), t = static_cast<int>(T), f = static_cast<int>(F);
    if ((parts & 1) && T > 0) {
      const size_t smem = chain_smem(W);
      const cudaError_t e = cudaFuncSetAttribute(lstm_ae_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
      lstm_ae_chain_kernel<<<static_cast<unsigned>(S), static_cast<unsigned>(32 * W), smem, stream>>>(
          enc_wh, dec_wh, w_out, b_out, x, mask, act, grad_err, d_gates, d_out, w, t, f);
    }
    if (parts & 2) {
      // shared memory before L1: two 47 KB blocks an SM (their registers' limit)
      const cudaError_t e = cudaFuncSetAttribute(lstm_ae_products_kernel,
                                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                                 static_cast<int>(cudaSharedmemCarveoutMaxShared));
      if (e != cudaSuccess) return static_cast<int>(e);
      lstm_ae_products_kernel<<<dim3(static_cast<unsigned>(S), 2), 256, 0, stream>>>(
          x, act, d_gates, d_out, g_enc_wx, g_enc_wh, g_enc_b, g_dec_wh, g_dec_b, g_wout,
          g_bout, w, t, f);
    }
  } else if (S > 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
