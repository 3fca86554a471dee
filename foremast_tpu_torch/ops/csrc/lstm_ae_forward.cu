// lstm_ae_forward: the masked LSTM-autoencoder's per-step reconstruction
// error err[s, w, t] = mean_f (y_t - x_t)^2 (0 where masked), for S
// models over W windows each, and optionally every step's activations
// for the backward pass.
//
// Replaces the JAX package's `reconstruct` / `recon_error` (no Pallas
// kernel: `lax.scan` over `_cell_step` inside one jitted, vmapped
// program, foremast_tpu/models/lstm_ae.py:82-125, and
// `score_rows_cutoff`, :287). As per-step torch ops a window costs ~12
// launches a cell step, 2T steps; here every window runs in one launch.
//
// One warp runs one (model, window) pair; lane j owns hidden unit j and
// forms the four gate pre-activations of its unit (columns j, H+j, 2H+j,
// 3H+j) each step. What bounds it on the H100, and what the design does:
//
//  * A step's 128 multiply-adds of h_prev . w_h. Lane j holds its own 4
//    gate columns of the current cell's w_h for all 32 rows in registers
//    (128), loaded once per cell; the encoder's w_x (<= 8 x 4) and the
//    biases stay in registers too. Nothing is re-read from shared memory
//    but h_prev itself: each step writes h to a per-warp row in shared
//    memory and every lane reads it back as 8 float4 broadcast loads.
//    Each gate's sum starts from the bias plus the input part (x_t . w_x,
//    which does not wait on h) and runs as two chains of 16 rows of k.
//  * The decoder's output layer is off the chain: its h_t rows stay in a
//    ring of 32 rows, and every 32 steps (or at the end) lane l forms
//    y_t = h_t . w_out + b_out and err for step t0 + l.
//  * x and mask are read once, 32 steps a chunk, coalesced: lane l loads
//    step t0 + l's row into registers one chunk ahead; the encoder reads
//    the chunk's rows from a per-warp shared slot (broadcast) and its
//    mask as one ballot word; the decoder's outputs reuse the registers.
//  * The cell's nonlinearities sit on the chain: expf and tanhf stay the
//    accurate library forms, the sigmoid's reciprocal is rcp.approx (no
//    branch), so the four gates' nonlinearities overlap.
//  * Training (save_act) streams the [2T, 6H] f32 activations out (201 MB
//    at S=512, W=8, T=32): the memory-rate floor. A step is ~280
//    instructions a warp along one dependent path; ~250 registers a
//    thread leave 8 warps an SM, so the chain's latency, not the bytes,
//    sets the time.
//
// Two grid mappings, one kernel template (kStaged):
//  * W >= 2 (training, error moments): a block is up to kModelWarps
//    windows of one model (grid S x ceil(W / kModelWarps)); both w_h
//    matrices are staged once in shared memory by cp.async and each warp
//    copies its columns from there, at the start and at the hand-over
//    from encoder to decoder.
//  * W == 1 (scoring, the `rows` gather of the warm re-check): a block is
//    kPairWarps consecutive pairs of any models; each warp loads its own
//    model's columns straight from device memory, every load in flight,
//    and asks L2 for the decoder's w_h at the start.
// No atomics and a fixed order of every sum: two calls give the same bits.
#include "lstm_ae.cuh"

namespace {

using namespace fm;

constexpr int kMaxW = 32;       // windows a model
constexpr int kModelWarps = 8;  // kStaged: windows of one model a block
constexpr int kPairWarps = 4;   // !kStaged: (model, window) pairs a block
constexpr int kChunk = 32;      // steps a lane-per-step load or output pass covers
constexpr int kRow = 36;        // floats an h row: 16-byte aligned, and lane l's
                                // float4 reads of row l meet no bank conflict

// One warp's shared memory.
struct WarpSmem {
  float h[kChunk + 2][kRow];  // decoder step t's h at row t % 32; the encoder's
                              // at rows 32 + (t & 1) (row 33 is zero before step 0)
  float x[kChunk][kMaxF];     // the current chunk's x rows, zero past F
  float wo[kH][kMaxF];        // w_out, zero past F
  float bo[kMaxF];            // b_out, zero past F
};

// Lane L's gate columns of one cell's w_h [H][4H]: wc[k][g] = w[k][g H + L]
// (consecutive lanes on consecutive words: one 128-byte line a load, no
// bank conflict from shared memory).
__device__ __forceinline__ void load_cols(const float* __restrict__ w, int lane, float (&wc)[kH][4]) {
#pragma unroll
  for (int k = 0; k < kH; ++k)
#pragma unroll
    for (int g = 0; g < 4; ++g) wc[k][g] = w[k * kG + g * kH + lane];
}

// Step t0 + lane's x row (zeros past T and F) and mask.
__device__ __forceinline__ void load_rows(const float* __restrict__ xw, const uint8_t* __restrict__ mw, int t0,
                                          int lane, int T, int F, float (&xr)[kMaxF], bool& mr) {
  const int t = t0 + lane;
  mr = t < T && mw[t];
#pragma unroll
  for (int f = 0; f < kMaxF; ++f) xr[f] = (t < T && f < F) ? xw[t * F + f] : 0.f;
}

// a[g] += h_prev . wc[:, g]; hrow is a shared row. Rows 0..15 are summed
// onto a in order, rows 16..31 into a second sum from 0 in order, and the
// two are added last: two chains of 16 a gate, which the scheduler
// overlaps better than one of 32.
__device__ __forceinline__ void gate_sums(const float* hrow, const float (&wc)[kH][4], float (&a)[4]) {
  const float4* h4 = reinterpret_cast<const float4*>(hrow);
  float hi[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int q = 0; q < kH / 4; ++q) {
    const float4 v = h4[q];
    const float hv[4] = {v.x, v.y, v.z, v.w};
    float(&p)[4] = q < kH / 8 ? a : hi;
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int g = 0; g < 4; ++g) p[g] = fmaf(hv[r], wc[4 * q + r][g], p[g]);
  }
#pragma unroll
  for (int g = 0; g < 4; ++g) a[g] += hi[g];
}

// 1 / (1 + e^-v). The reciprocal is rcp.approx (at most 1 ulp off, no
// branch): the IEEE division's slow-path branch would fence each gate's
// nonlinearity off from the next and serialize the four.
__device__ __forceinline__ float sigmoid(float v) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(1.f + expf(-v)));
  return r;
}

// The cell from its pre-activations and the previous c: gates after
// their nonlinearities, the new c and h.
__device__ __forceinline__ Step cell(const float (&a)[4], float c) {
  Step st;
  st.i = sigmoid(a[0]);
  st.f = sigmoid(a[1]);
  st.g = tanhf(a[2]);
  st.o = sigmoid(a[3]);
  st.c = st.f * c + st.i * st.g;
  st.h = st.o * tanhf(st.c);
  return st;
}

template <bool kSave, bool kStaged>
__global__ void __launch_bounds__(32 * kModelWarps, 1)
    lstm_ae_forward_kernel(const float* __restrict__ enc_wx,
                           const float* __restrict__ enc_wh,
                           const float* __restrict__ enc_b,
                           const float* __restrict__ dec_wh,
                           const float* __restrict__ dec_b,
                           const float* __restrict__ w_out,
                           const float* __restrict__ b_out,
                           const long long* __restrict__ rows,
                           const float* __restrict__ x,
                           const uint8_t* __restrict__ mask,
                           float* __restrict__ err, float* __restrict__ act,
                           long long S, int W, int T, int F) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* s_wh = smem;  // kStaged: [2][H][4H], the encoder's w_h then the decoder's
  WarpSmem& sm = reinterpret_cast<WarpSmem*>(smem + (kStaged ? 2 * kH * kG : 0))[warp];

  long long s;
  int w;
  if (kStaged) {
    s = blockIdx.x;
    w = blockIdx.y * kModelWarps + warp;
  } else {
    const long long pair = static_cast<long long>(blockIdx.x) * kPairWarps + warp;
    s = pair / W;
    w = static_cast<int>(pair % W);
    if (s >= S) return;  // the last block's spare warps (no block barrier follows)
  }
  const long long p = rows ? rows[s] : s;
  const float* ewh = enc_wh + p * kH * kG;
  const float* dwh = dec_wh + p * kH * kG;
  if (kStaged) {
    for (int i = threadIdx.x; i < kH * kG / 4; i += blockDim.x) {
      cp_async16(s_wh + 4 * i, ewh + 4 * i, true);
      cp_async16(s_wh + kH * kG + 4 * i, dwh + 4 * i, true);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (w >= W) return;  // the last block's windows past W
  } else {
    // the decoder's w_h into L2 now, read at the hand-over: 128 lines
    const char* d = reinterpret_cast<const char*>(dwh);
    for (int i = lane; i < kH * kG * 4 / 128; i += 32) asm volatile("prefetch.global.L2 [%0];" ::"l"(d + i * 128));
  }

  const long long win = s * W + w;
  const float* xw = x + win * T * F;
  const uint8_t* mw = mask + win * T;
  float* ew = err + win * T;
  float* aw = kSave ? act + win * 2LL * T * kActStride : nullptr;

  float wc[kH][4];
  load_cols(kStaged ? s_wh : ewh, lane, wc);
  float wx[kMaxF][4];
#pragma unroll
  for (int f = 0; f < kMaxF; ++f)
#pragma unroll
    for (int g = 0; g < 4; ++g) wx[f][g] = f < F ? enc_wx[(p * F + f) * kG + g * kH + lane] : 0.f;
  float b[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) b[g] = enc_b[p * kG + g * kH + lane];
  float xr[kMaxF];
  bool mr;
  load_rows(xw, mw, 0, lane, T, F, xr, mr);
  sm.h[kChunk + 1][lane] = 0.f;  // h before the encoder's first step

  const int n_chunks = (T + kChunk - 1) / kChunk;
  float h = 0.f, c = 0.f;
  // ---- encoder: a masked step carries (h, c) and saves the carried state
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int t0 = ch * kChunk;
    const int n = min(kChunk, T - t0);
    __syncwarp();  // every lane has read the last chunk's x rows
    float4* xs = reinterpret_cast<float4*>(sm.x[lane]);
    xs[0] = make_float4(xr[0], xr[1], xr[2], xr[3]);
    xs[1] = make_float4(xr[4], xr[5], xr[6], xr[7]);
    const unsigned keep = __ballot_sync(kFull, mr);
    __syncwarp();
    if (ch + 1 < n_chunks) load_rows(xw, mw, t0 + kChunk, lane, T, F, xr, mr);  // one chunk ahead
    for (int k = 0; k < n; ++k) {
      const int t = t0 + k;
      float a[4] = {b[0], b[1], b[2], b[3]};
      // the input part: x_t from the chunk's shared row (a broadcast)
      const float4* x4 = reinterpret_cast<const float4*>(sm.x[k]);
      const float4 lo = x4[0];
      const float4 hi = F > 4 ? x4[1] : make_float4(0.f, 0.f, 0.f, 0.f);
      const float xv[kMaxF] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
      for (int f = 0; f < kMaxF; ++f) {
        if (f < F) {
#pragma unroll
          for (int g = 0; g < 4; ++g) a[g] = fmaf(xv[f], wx[f][g], a[g]);
        }
      }
      gate_sums(sm.h[kChunk + ((t + 1) & 1)], wc, a);
      Step st = cell(a, c);
      if ((keep >> k) & 1u) {
        c = st.c;
        h = st.h;
      }
      st.c = c;
      st.h = h;
      if (kSave) store_step(aw + t * kActStride, lane, st);
      sm.h[kChunk + (t & 1)][lane] = h;
      __syncwarp();
    }
  }

  // ---- hand-over: the decoder's weights, the output layer, chunk 0's rows
  load_cols(kStaged ? s_wh + kH * kG : dwh, lane, wc);
#pragma unroll
  for (int g = 0; g < 4; ++g) b[g] = dec_b[p * kG + g * kH + lane];
#pragma unroll
  for (int f = 0; f < kMaxF; ++f) sm.wo[lane][f] = f < F ? w_out[(p * kH + lane) * F + f] : 0.f;
  if (lane < kMaxF) sm.bo[lane] = lane < F ? b_out[p * F + lane] : 0.f;
  load_rows(xw, mw, 0, lane, T, F, xr, mr);

  // ---- decoder: zero input (its x . w_x is exactly 0), every step updates
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int t0 = ch * kChunk;
    const int n = min(kChunk, T - t0);
    for (int k = 0; k < n; ++k) {
      const int t = t0 + k;
      float a[4] = {b[0], b[1], b[2], b[3]};
      gate_sums(t == 0 ? sm.h[kChunk + ((T - 1) & 1)] : sm.h[(k + kChunk - 1) % kChunk], wc, a);
      const Step st = cell(a, c);
      c = st.c;
      h = st.h;

      if (kSave) store_step(aw + (T + t) * kActStride, lane, st);
      sm.h[k][lane] = h;
      __syncwarp();
    }
    // the chunk's outputs, step t0 + lane a lane, off the chain
    if (lane < n) {
      float y[kMaxF];
#pragma unroll
      for (int f = 0; f < kMaxF; ++f) y[f] = 0.f;
      const float4* h4 = reinterpret_cast<const float4*>(sm.h[lane]);
#pragma unroll
      for (int q = 0; q < kH / 4; ++q) {
        const float4 v = h4[q];
        const float hv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float4* w4 = reinterpret_cast<const float4*>(sm.wo[4 * q + r]);
          const float4 lo = w4[0];
          y[0] = fmaf(hv[r], lo.x, y[0]);
          y[1] = fmaf(hv[r], lo.y, y[1]);
          y[2] = fmaf(hv[r], lo.z, y[2]);
          y[3] = fmaf(hv[r], lo.w, y[3]);
          if (F > 4) {
            const float4 hi = w4[1];
            y[4] = fmaf(hv[r], hi.x, y[4]);
            y[5] = fmaf(hv[r], hi.y, y[5]);
            y[6] = fmaf(hv[r], hi.z, y[6]);
            y[7] = fmaf(hv[r], hi.w, y[7]);
          }
        }
      }
      float e = 0.f;
#pragma unroll
      for (int f = 0; f < kMaxF; ++f) {
        if (f < F) {
          const float d = (y[f] + sm.bo[f]) - xr[f];
          e = fmaf(d, d, e);
        }
      }
      ew[t0 + lane] = mr ? e / static_cast<float>(F) : 0.f;
    }
    __syncwarp();  // every lane has read the chunk's rows before step t0 + 32 writes row 0
    if (ch + 1 < n_chunks) load_rows(xw, mw, t0 + kChunk, lane, T, F, xr, mr);
  }
}

template <bool kSave, bool kStaged>
cudaError_t launch(dim3 grid, int warps, const float* enc_wx, const float* enc_wh, const float* enc_b,
                   const float* dec_wh, const float* dec_b, const float* w_out, const float* b_out,
                   const long long* rows, const float* x, const uint8_t* mask, float* err, float* act,
                   long long S, int W, int T, int F, cudaStream_t stream) {
  const size_t smem = (kStaged ? 2 * kH * kG * sizeof(float) : 0) + warps * sizeof(WarpSmem);
  auto* kernel = lstm_ae_forward_kernel<kSave, kStaged>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, 32 * warps, smem, stream>>>(enc_wx, enc_wh, enc_b, dec_wh, dec_b, w_out, b_out, rows, x, mask,
                                             err, act, S, W, T, F);
  return cudaGetLastError();
}

}  // namespace

FM_API int fm_lstm_ae_forward(const float* enc_wx, const float* enc_wh,
                              const float* enc_b, const float* dec_wh,
                              const float* dec_b, const float* w_out,
                              const float* b_out, const long long* rows,
                              const float* x, const uint8_t* mask, float* err,
                              float* act, long long S, long long W,
                              long long T, long long F, cudaStream_t stream) {
  if (S <= 0 || T <= 0) return static_cast<int>(cudaGetLastError());
  if (W < 1 || W > kMaxW || F < 1 || F > kMaxF) return static_cast<int>(cudaErrorInvalidValue);
  const int w = static_cast<int>(W), t = static_cast<int>(T), f = static_cast<int>(F);
  cudaError_t e;
  if (W >= 2) {
    const dim3 grid(static_cast<unsigned>(S), static_cast<unsigned>((W + kModelWarps - 1) / kModelWarps));
    const int warps = static_cast<int>(W < kModelWarps ? W : kModelWarps);
    e = act ? launch<true, true>(grid, warps, enc_wx, enc_wh, enc_b, dec_wh, dec_b, w_out, b_out, rows, x, mask,
                                 err, act, S, w, t, f, stream)
            : launch<false, true>(grid, warps, enc_wx, enc_wh, enc_b, dec_wh, dec_b, w_out, b_out, rows, x, mask,
                                  err, act, S, w, t, f, stream);
  } else {
    const dim3 grid(static_cast<unsigned>((S * W + kPairWarps - 1) / kPairWarps));
    e = act ? launch<true, false>(grid, kPairWarps, enc_wx, enc_wh, enc_b, dec_wh, dec_b, w_out, b_out, rows, x,
                                  mask, err, act, S, w, t, f, stream)
            : launch<false, false>(grid, kPairWarps, enc_wx, enc_wh, enc_b, dec_wh, dec_b, w_out, b_out, rows, x,
                                   mask, err, act, S, w, t, f, stream);
  }
  return static_cast<int>(e);
}
