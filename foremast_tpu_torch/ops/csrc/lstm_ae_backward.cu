// lstm_ae_backward: backpropagation through time of the masked LSTM
// autoencoder, one launch for S models: per-model gradients of every
// parameter leaf from the upstream gradient of err [S, W, T].
//
// Replaces `jax.grad(loss_fn)` of the JAX package's
// foremast_tpu/models/lstm_ae.py:128-131 (no Pallas kernel: XLA
// differentiates the `lax.scan`). `lstm_ae_forward` saved each step's
// activations (i, f, g, o after their nonlinearities, c, h; masked
// encoder steps save the carried state), so no step is recomputed except
// the decoder's output y_t = h_t @ w_out + b_out.
//
// What bounds it on the H100: the dependent chain of 2T steps backward;
// a step is ~2x the forward's f32 work (the dW_h outer product and the
// dh_prev = dgates @ w_h^T product, 4H(F+H) multiply-adds each). Design:
// one block a model, one warp a window, walking the decoder from t = T-1
// down, then the encoder, carrying dh and dc; a masked encoder step
// passes them through untouched. Only the upstream err gradient at
// unmasked steps seeds dy (the caller's loss normalization rides in
// that gradient). Lane j owns gate columns j, H+j, 2H+j, 3H+j: their
// bias, w_x and w_out-row gradients accumulate in registers; its dW_h
// columns accumulate in the warp's own [H][4H] partial in shared memory
// (16 KB a warp, no atomics). dh_prev reads a transposed copy of the
// cell's w_h in shared memory: reading w_h row-wise across lanes would be
// a 32-way bank conflict. At the end of each cell the W warps' partials
// are summed in a fixed warp order and written to this model's gradient
// rows: every model owns its parameters, so nothing reduces across
// blocks and the result does not depend on scheduling.
#include "lstm_ae.cuh"

namespace {

using namespace fm;

struct Carry {
  float dh, dc;
};

// One cell step backward from the step's activations, the previous
// state, and the incoming dh (output + carried) / dc. Accumulates the
// bias gradient in `db`, the dW_h partial in `part` (this warp's), and
// returns the gate pre-activation gradients in `da`; the new carry.
__device__ __forceinline__ Carry cell_back(const Step& s, float c_prev,
                                           float h_prev, float dh, float dc,
                                           const float* __restrict__ wt,
                                           float* __restrict__ part,
                                           float* db, float* da, int lane) {
  const float tc = tanhf(s.c);
  const float d_o = dh * tc;
  dc += dh * s.o * (1.f - tc * tc);
  const float d_i = dc * s.g;
  const float d_g = dc * s.i;
  const float d_f = dc * c_prev;
  da[0] = d_i * s.i * (1.f - s.i);
  da[1] = d_f * s.f * (1.f - s.f);
  da[2] = d_g * (1.f - s.g * s.g);
  da[3] = d_o * s.o * (1.f - s.o);
#pragma unroll
  for (int g = 0; g < 4; ++g) db[g] += da[g];
#pragma unroll 8
  for (int k = 0; k < kH; ++k) {
    const float hk = __shfl_sync(kFull, h_prev, k);
    float* row = part + k * kG + lane;
#pragma unroll
    for (int g = 0; g < 4; ++g) row[g * kH] += hk * da[g];
  }
  float dh_prev = 0.f;
#pragma unroll
  for (int g = 0; g < 4; ++g) {
#pragma unroll 8
    for (int j = 0; j < kH; ++j) {
      const float v = __shfl_sync(kFull, da[g], j);
      dh_prev += wt[(g * kH + j) * kH + lane] * v;
    }
  }
  return {dh_prev, dc * s.f};
}

// w [H][4H] (one model's w_h) -> wt [4H][H], block-wide.
__device__ __forceinline__ void stage_transposed(const float* __restrict__ w, float* wt) {
  for (int i = threadIdx.x; i < kH * kG; i += blockDim.x) {
    const int k = i / kG, col = i % kG;
    wt[col * kH + k] = w[i];
  }
}

// Sum the W warps' partials [W][n] in warp order into out[0:n].
__device__ __forceinline__ void reduce_warps(const float* part, int W, int n, float* out) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    float v = 0.f;
    for (int w = 0; w < W; ++w) v += part[w * kH * kG + i];
    out[i] = v;
  }
}

__global__ void __launch_bounds__(256)
    lstm_ae_backward_kernel(const float* __restrict__ enc_wh,
                            const float* __restrict__ dec_wh,
                            const float* __restrict__ w_out,
                            const float* __restrict__ b_out,
                            const float* __restrict__ x,
                            const uint8_t* __restrict__ mask,
                            const float* __restrict__ act,
                            const float* __restrict__ grad_err,
                            float* __restrict__ g_enc_wx,
                            float* __restrict__ g_enc_wh,
                            float* __restrict__ g_enc_b,
                            float* __restrict__ g_dec_wh,
                            float* __restrict__ g_dec_b,
                            float* __restrict__ g_wout,
                            float* __restrict__ g_bout, int W, int T, int F) {
  extern __shared__ float smem[];
  float* parts = smem;                 // [W][H][4H]: per-warp partials
  float* wt = parts + W * kH * kG;     // [4H][H]: the cell's w_h transposed
  float* s_wout = wt + kH * kG;        // [H][F]
  float* s_bout = s_wout + kH * kMaxF; // [F]

  const long long s = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long win = s * W + warp;
  const float* xw = x + win * T * F;
  const uint8_t* mw = mask + win * T;
  const float* gw = grad_err + win * T;
  const float* aw = act + win * 2LL * T * kActStride;
  float* part = parts + warp * kH * kG;

  stage_transposed(dec_wh + s * kH * kG, wt);
  for (int i = threadIdx.x; i < kH * F; i += blockDim.x) s_wout[i] = w_out[s * kH * F + i];
  for (int i = threadIdx.x; i < F; i += blockDim.x) s_bout[i] = b_out[s * F + i];
  for (int i = lane; i < kH * kG; i += 32) part[i] = 0.f;
  __syncthreads();

  // ---- decoder, t = T-1 .. 0 (step u = T + t; its previous state is
  // step u - 1, the encoder's final state at t = 0)
  float db[4] = {0.f, 0.f, 0.f, 0.f};
  float dwo[kMaxF], dbo[kMaxF];
#pragma unroll
  for (int f = 0; f < kMaxF; ++f) dwo[f] = dbo[f] = 0.f;
  float da[4];
  Carry cr = {0.f, 0.f};
  for (int t = T - 1; t >= 0; --t) {
    const int u = T + t;
    const Step st = load_step(aw + u * kActStride, lane);
    const Step pv = load_step(aw + (u - 1) * kActStride, lane);
    const float de = mw[t] ? gw[t] : 0.f;
    float dh = cr.dh;
    for (int f = 0; f < F; ++f) {
      const float y = project(st.h, s_wout, s_bout[f], lane, f, F);
      const float dy = de * 2.f * (y - xw[t * F + f]) / static_cast<float>(F);
      dwo[f] += st.h * dy;
      dbo[f] += dy;
      dh += s_wout[lane * F + f] * dy;
    }
    cr = cell_back(st, pv.c, pv.h, dh, cr.dc, wt, part, db, da, lane);
  }
  __syncthreads();
  reduce_warps(parts, W, kH * kG, g_dec_wh + s * kH * kG);
  __syncthreads();
  // the warp's small accumulators, through its own (now free) partial
  for (int g = 0; g < 4; ++g) part[g * kH + lane] = db[g];
  for (int f = 0; f < F; ++f) {
    part[kG + lane * F + f] = dwo[f];
    if (lane == 0) part[kG + kH * F + f] = dbo[f];
  }
  __syncthreads();
  reduce_warps(parts, W, kG, g_dec_b + s * kG);
  reduce_warps(parts + kG, W, kH * F, g_wout + s * kH * F);
  reduce_warps(parts + kG + kH * F, W, F, g_bout + s * F);
  __syncthreads();

  // ---- encoder, t = T-1 .. 0; a masked step passes dh, dc through
  stage_transposed(enc_wh + s * kH * kG, wt);
  for (int i = lane; i < kH * kG; i += 32) part[i] = 0.f;
  __syncthreads();
#pragma unroll
  for (int g = 0; g < 4; ++g) db[g] = 0.f;
  float dwx[kMaxF][4];
#pragma unroll
  for (int f = 0; f < kMaxF; ++f)
#pragma unroll
    for (int g = 0; g < 4; ++g) dwx[f][g] = 0.f;
  for (int t = T - 1; t >= 0; --t) {
    if (!mw[t]) continue;
    const Step st = load_step(aw + t * kActStride, lane);
    float c_prev = 0.f, h_prev = 0.f;
    if (t > 0) {
      const Step pv = load_step(aw + (t - 1) * kActStride, lane);
      c_prev = pv.c;
      h_prev = pv.h;
    }
    cr = cell_back(st, c_prev, h_prev, cr.dh, cr.dc, wt, part, db, da, lane);
#pragma unroll
    for (int f = 0; f < kMaxF; ++f) {
      if (f < F) {
        const float xv = xw[t * F + f];
#pragma unroll
        for (int g = 0; g < 4; ++g) dwx[f][g] += xv * da[g];
      }
    }
  }
  __syncthreads();
  reduce_warps(parts, W, kH * kG, g_enc_wh + s * kH * kG);
  __syncthreads();
  for (int g = 0; g < 4; ++g) part[g * kH + lane] = db[g];
#pragma unroll
  for (int f = 0; f < kMaxF; ++f)
    if (f < F)
#pragma unroll
      for (int g = 0; g < 4; ++g) part[kG + f * kG + g * kH + lane] = dwx[f][g];
  __syncthreads();
  reduce_warps(parts, W, kG, g_enc_b + s * kG);
  reduce_warps(parts + kG, W, F * kG, g_enc_wx + s * F * kG);
}

}  // namespace

FM_API int fm_lstm_ae_backward(const float* enc_wh, const float* dec_wh,
                               const float* w_out, const float* b_out,
                               const float* x, const uint8_t* mask,
                               const float* act, const float* grad_err,
                               float* g_enc_wx, float* g_enc_wh,
                               float* g_enc_b, float* g_dec_wh,
                               float* g_dec_b, float* g_wout, float* g_bout,
                               long long S, long long W, long long T,
                               long long F, cudaStream_t stream) {
  if (S > 0) {
    const size_t smem = ((W + 1) * kH * kG + kH * kMaxF + kMaxF) * sizeof(float);
    cudaError_t e = cudaFuncSetAttribute(lstm_ae_backward_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    lstm_ae_backward_kernel<<<S, static_cast<unsigned>(32 * W), smem, stream>>>(
        enc_wh, dec_wh, w_out, b_out, x, mask, act, grad_err, g_enc_wx,
        g_enc_wh, g_enc_b, g_dec_wh, g_dec_b, g_wout, g_bout,
        static_cast<int>(W), static_cast<int>(T), static_cast<int>(F));
  }
  return static_cast<int>(cudaGetLastError());
}
