// Shared layout of the LSTM-autoencoder kernels (lstm_ae_forward.cu,
// lstm_ae_backward.cu).
//
// The model is the JAX package's `models/lstm_ae.py`: an encoder LSTM
// over a [T, F] window whose masked steps carry (h, c) through, a decoder
// LSTM that starts from the encoder's final state and runs T steps on a
// zero input, and the output y_t = h_t @ w_out + b_out compared with x_t
// in time order. Gates are stacked [i, f, g, o] along the last axis of
// w_x [F, 4H], w_h [H, 4H] and b [4H].
//
// One warp runs one window: lane j holds h_j and c_j and computes the
// four gate pre-activations of unit j (columns j, H+j, 2H+j, 3H+j). The
// judge always builds H = 32, so a warp is exactly one hidden state. How
// each kernel maps windows to blocks and moves h between lanes is in its
// own header comment.
#pragma once

#include "common.cuh"

namespace fm {

constexpr int kH = 32;         // hidden width: one lane per unit
constexpr int kG = 4 * kH;     // gate columns [i, f, g, o]
constexpr int kMaxF = 8;       // metrics a window may carry
constexpr int kActStride = 6 * kH;  // saved per step: i, f, g, o, c, h
constexpr unsigned kFull = 0xffffffffu;

// Activations of one step (one lane's unit), as the forward pass saves
// them for the backward pass.
struct Step {
  float i, f, g, o, c, h;
};

__device__ __forceinline__ void store_step(float* a, int lane, const Step& s) {
  a[0 * kH + lane] = s.i;
  a[1 * kH + lane] = s.f;
  a[2 * kH + lane] = s.g;
  a[3 * kH + lane] = s.o;
  a[4 * kH + lane] = s.c;
  a[5 * kH + lane] = s.h;
}

__device__ __forceinline__ Step load_step(const float* a, int lane) {
  return {a[0 * kH + lane], a[1 * kH + lane], a[2 * kH + lane],
          a[3 * kH + lane], a[4 * kH + lane], a[5 * kH + lane]};
}

}  // namespace fm
