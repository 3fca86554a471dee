// lstm_ae_forward: the masked LSTM-autoencoder's per-step reconstruction
// error err[s, w, t] = mean_f (y_t - x_t)^2 (0 where masked), for S
// models over W windows each, and optionally every step's activations
// for the backward pass.
//
// Replaces the JAX package's `reconstruct` / `recon_error` (no Pallas
// kernel: `lax.scan` over `_cell_step` inside one jitted, vmapped
// program, foremast_tpu/models/lstm_ae.py:82-125). As per-step torch ops
// a window costs ~12 launches a cell step, 2T steps; here a whole model's
// windows run in one block.
//
// What bounds it on the H100: the dependent chain of 2T cell steps. A
// step is ~4H(F+H) f32 multiply-adds a window (a lane: 4(F+32) FMAs, 32
// shuffles, 3 sigmoids, 2 tanh), plus F butterfly sums in the decoder;
// the bytes (x, mask, err, the ~37 KB of parameters a model) are small.
// The design keeps the chain on chip: one warp a window (lane j owns
// unit j), both w_h matrices, the encoder's w_x, the biases and the
// output layer in shared memory, staged once per model; lane j reads
// w_h[k][j + gH] for a fixed k, consecutive lanes on consecutive words
// (no bank conflict). The decoder's input is zero, so its x @ w_x is
// skipped (exactly 0 in the reference). A masked encoder step carries
// (h, c) by a select. `rows` (nullable) gathers each model's parameters
// from a [capacity, ...] stack: the warm re-check's arena rows.
#include "lstm_ae.cuh"

namespace {

using namespace fm;

template <bool kSave>
__global__ void __launch_bounds__(1024)
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
                           int W, int T, int F) {
  extern __shared__ float smem[];
  float* s_ewh = smem;                // [H][4H]
  float* s_dwh = s_ewh + kH * kG;     // [H][4H]
  float* s_ewx = s_dwh + kH * kG;     // [F][4H]
  float* s_eb = s_ewx + kMaxF * kG;   // [4H]
  float* s_db = s_eb + kG;            // [4H]
  float* s_wout = s_db + kG;          // [H][F]
  float* s_bout = s_wout + kH * kMaxF;  // [F]

  const long long s = blockIdx.x;
  const long long p = rows ? rows[s] : s;
  for (int i = threadIdx.x; i < kH * kG; i += blockDim.x) {
    s_ewh[i] = enc_wh[p * kH * kG + i];
    s_dwh[i] = dec_wh[p * kH * kG + i];
  }
  for (int i = threadIdx.x; i < F * kG; i += blockDim.x) s_ewx[i] = enc_wx[p * F * kG + i];
  for (int i = threadIdx.x; i < kG; i += blockDim.x) {
    s_eb[i] = enc_b[p * kG + i];
    s_db[i] = dec_b[p * kG + i];
  }
  for (int i = threadIdx.x; i < kH * F; i += blockDim.x) s_wout[i] = w_out[p * kH * F + i];
  for (int i = threadIdx.x; i < F; i += blockDim.x) s_bout[i] = b_out[p * F + i];
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long win = s * W + warp;
  const float* xw = x + win * T * F;
  const uint8_t* mw = mask + win * T;
  float* ew = err + win * T;
  float* aw = kSave ? act + win * 2LL * T * kActStride : nullptr;

  float h = 0.f, c = 0.f;
  for (int t = 0; t < T; ++t) {  // encoder
    float ai = 0.f, af = 0.f, ag = 0.f, ao = 0.f;
    for (int f = 0; f < F; ++f) {
      const float xv = xw[t * F + f];
      const float* wx = s_ewx + f * kG + lane;
      ai += xv * wx[0];
      af += xv * wx[kH];
      ag += xv * wx[2 * kH];
      ao += xv * wx[3 * kH];
    }
    float hi = 0.f, hf = 0.f, hg = 0.f, ho = 0.f;
#pragma unroll
    for (int k = 0; k < kH; ++k) {
      const float hk = __shfl_sync(kFull, h, k);
      const float* wh = s_ewh + k * kG + lane;
      hi += hk * wh[0];
      hf += hk * wh[kH];
      hg += hk * wh[2 * kH];
      ho += hk * wh[3 * kH];
    }
    Step st;
    st.i = sigmoid((ai + hi) + s_eb[lane]);
    st.f = sigmoid((af + hf) + s_eb[kH + lane]);
    st.g = tanhf((ag + hg) + s_eb[2 * kH + lane]);
    st.o = sigmoid((ao + ho) + s_eb[3 * kH + lane]);
    const float cn = st.f * c + st.i * st.g;
    const float hn = st.o * tanhf(cn);
    if (mw[t]) {
      c = cn;
      h = hn;
    }
    st.c = c;
    st.h = h;
    if (kSave) store_step(aw + t * kActStride, lane, st);
  }
  for (int t = 0; t < T; ++t) {  // decoder: zero input, every step updates
    float hi = 0.f, hf = 0.f, hg = 0.f, ho = 0.f;
#pragma unroll
    for (int k = 0; k < kH; ++k) {
      const float hk = __shfl_sync(kFull, h, k);
      const float* wh = s_dwh + k * kG + lane;
      hi += hk * wh[0];
      hf += hk * wh[kH];
      hg += hk * wh[2 * kH];
      ho += hk * wh[3 * kH];
    }
    Step st;
    st.i = sigmoid(hi + s_db[lane]);
    st.f = sigmoid(hf + s_db[kH + lane]);
    st.g = tanhf(hg + s_db[2 * kH + lane]);
    st.o = sigmoid(ho + s_db[3 * kH + lane]);
    c = st.f * c + st.i * st.g;
    h = st.o * tanhf(c);
    st.c = c;
    st.h = h;
    if (kSave) store_step(aw + (T + t) * kActStride, lane, st);
    float e = 0.f;
    for (int f = 0; f < F; ++f) {
      const float d = project(h, s_wout, s_bout[f], lane, f, F) - xw[t * F + f];
      e += d * d;
    }
    if (lane == 0) ew[t] = mw[t] ? e / static_cast<float>(F) : 0.f;
  }
}

}  // namespace

FM_API int fm_lstm_ae_forward(const float* enc_wx, const float* enc_wh,
                              const float* enc_b, const float* dec_wh,
                              const float* dec_b, const float* w_out,
                              const float* b_out, const long long* rows,
                              const float* x, const uint8_t* mask, float* err,
                              float* act, long long S, long long W,
                              long long T, long long F, cudaStream_t stream) {
  if (S > 0 && T > 0) {
    const size_t smem = (2 * kH * kG + kMaxF * kG + 2 * kG + kH * kMaxF + kMaxF) * sizeof(float);
    const dim3 block(static_cast<unsigned>(32 * W));
    if (act)
      lstm_ae_forward_kernel<true><<<S, block, smem, stream>>>(
          enc_wx, enc_wh, enc_b, dec_wh, dec_b, w_out, b_out, rows, x, mask,
          err, act, static_cast<int>(W), static_cast<int>(T), static_cast<int>(F));
    else
      lstm_ae_forward_kernel<false><<<S, block, smem, stream>>>(
          enc_wx, enc_wh, enc_b, dec_wh, dec_b, w_out, b_out, rows, x, mask,
          err, act, static_cast<int>(W), static_cast<int>(T), static_cast<int>(F));
  }
  return static_cast<int>(cudaGetLastError());
}
