"""The algorithm of `lstm_ae_forward`'s kernel, on the CPU.

The card's forward runs one warp a (model, window) pair, lane j owning
hidden unit j. Each step a lane forms its unit's four gate
pre-activations as running sums in a fixed order: the bias, then the
input part x_t[f] w_x[f] for f = 0..F-1 (encoder only; the decoder's
input is zero), then h_prev[k] w_h[k] for k = 0..15 onto that sum and
k = 16..31 into a second one from zero, each k in order, the two added
last. The decoder's outputs y_t = h_t w_out + b_out and the error
mean_f (y_t - x_t)^2 (0 at a masked step) are formed off the chain, for
blocks of 32 steps at a time, each step's sum over k in order, then
b_out. With `save_act` each step's (i, f, g, o, c, h) lands in act [S,
W, 2T, 6H], encoder steps first; a masked encoder step keeps the
carried (c, h).

The kernel cannot run here, so this file holds a step-by-step torch
reference of exactly that, in f32, and holds it

  * against the plain loop (`_lstm_ae_forward_plain`, both f32; err within
    1e-6 relative + 1e-7 absolute: only the order of the f32 sums
    differs) and its activations against `_lstm_ae_act_plain` (1e-6
    absolute: gates and states lie in [-1, 1] up to c's growth);
  * against the JAX package's `recon_error` (1e-5 relative + 1e-7
    absolute, as tests/test_torch_lstm_ae.py; XLA sums in its own order);
  * with its recorded act fed to the split backward reference of
    tests/test_torch_lstm_ae_bptt.py (float64), whose gradients must be
    within 1e-4 of each leaf's largest gradient from float64 autograd of
    the plain loop (the forward's act carries f32 rounding).

Shapes: S in {1, 3}, W in {1, 3, 8}, T in {1, 8, 33, 64} (33: one past a
32-step output block), F in {1, 4, 8}; masks cycle through full,
all-masked, single-step, leading-masked, ragged-tail and random windows,
shifted per case so single-window cases meet each kind.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foremast_tpu.models import lstm_ae as J
from foremast_tpu_torch.ops import kernels as K
from tests.test_torch_lstm_ae_bptt import _chain, _leaf_close, _loss_grad_err, _params, _products

H = 32
G = 4 * H
BLOCK = 32  # decoder steps whose outputs are formed together


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Loops of small tensor ops: the intra-op pool only contends with the
    other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _windows(rng, s, w, t_len, f, shift):
    """x [S, W, T, F] and a mask whose windows cycle through full,
    all-masked, single-step, leading-masked, ragged-tail and random
    kinds, starting at kind `shift`."""
    x = rng.normal(0.5, 0.5, (s, w, t_len, f))
    m = np.zeros((s, w, t_len), bool)
    for i in range(s):
        for j in range(w):
            kind = (i * w + j + shift) % 6
            cut = int(rng.integers(1, t_len)) if t_len > 1 else 1
            if kind == 0:
                m[i, j] = True
            elif kind == 2:
                m[i, j, rng.integers(t_len)] = True
            elif kind == 3:
                m[i, j, cut:] = True
            elif kind == 4:
                m[i, j, :cut] = True
            elif kind == 5:
                m[i, j] = rng.random(t_len) < 0.6
    return x, m


def _kernel_forward(leaves, x, mask):
    """The kernel's algorithm step by step -> (err [S, W, T], act [S, W,
    2T, 6H])."""
    ewx, ewh, eb, _dwx, dwh, db, wout, bout = leaves
    s, w, t_len, f_n = x.shape
    h = x.new_zeros((s, w, H))
    c = torch.zeros_like(h)
    act = x.new_zeros((s, w, 2 * t_len, 6 * H))
    err = x.new_zeros((s, w, t_len))

    def gate_sums(a, h, w_h):
        hi = torch.zeros_like(a)
        for k in range(H // 2):  # a lane's two running sums, k in order
            a = a + h[..., k, None] * w_h[:, None, k, :]
        for k in range(H // 2, H):
            hi = hi + h[..., k, None] * w_h[:, None, k, :]
        return a + hi

    def cell(a, c):
        i, f, g, o = (torch.sigmoid(a[..., :H]), torch.sigmoid(a[..., H:2 * H]), torch.tanh(a[..., 2 * H:3 * H]),
                      torch.sigmoid(a[..., 3 * H:]))
        c_new = f * c + i * g
        return i, f, g, o, c_new, o * torch.tanh(c_new)

    for t in range(t_len):  # encoder
        a = eb[:, None].expand(s, w, G)
        for fi in range(f_n):
            a = a + x[:, :, t, fi, None] * ewx[:, None, fi, :]
        i, f, g, o, c_new, h_new = cell(gate_sums(a, h, ewh), c)
        keep = mask[:, :, t, None]
        c, h = torch.where(keep, c_new, c), torch.where(keep, h_new, h)
        act[:, :, t] = torch.cat([i, f, g, o, c, h], dim=-1)
    rows = []  # the decoder's h of the current output block
    for t in range(t_len):  # decoder
        i, f, g, o, c, h = cell(gate_sums(db[:, None].expand(s, w, G), h, dwh), c)
        act[:, :, t_len + t] = torch.cat([i, f, g, o, c, h], dim=-1)
        rows.append(h)
        if len(rows) == BLOCK or t == t_len - 1:  # the block's outputs, a step a lane
            t0 = t + 1 - len(rows)
            hb = torch.stack(rows, dim=2)
            y = x.new_zeros((s, w, len(rows), f_n))
            for k in range(H):
                y = y + hb[..., k, None] * wout[:, None, None, k, :]
            d = (y + bout[:, None, None, :]) - x[:, :, t0:t + 1]
            e = x.new_zeros((s, w, len(rows)))
            for fi in range(f_n):
                e = e + d[..., fi] * d[..., fi]
            err[:, :, t0:t + 1] = torch.where(mask[:, :, t0:t + 1], e / f_n, torch.zeros_like(e))
            rows = []
    return err, act


CASES = [(s, w, t_len, f) for s in (1, 3) for w in (1, 3, 8) for t_len in (1, 8, 33, 64) for f in (1, 4, 8)]


def _case(idx, s, w, t_len, f):
    """Seeded f32 leaves (as numpy float64, f32-representable), x and mask."""
    rng = np.random.default_rng(9000 + idx)
    p = [a.astype(np.float32) for a in _params(rng, s, f)]
    x, m = _windows(rng, s, w, t_len, f, shift=idx)
    return p, x.astype(np.float32), m


@pytest.mark.parametrize("idx,s,w,t_len,f", [(i, *c) for i, c in enumerate(CASES)])
def test_kernel_algorithm_matches_plain_loop(idx, s, w, t_len, f):
    p, x, m = _case(idx, s, w, t_len, f)
    leaves = [torch.from_numpy(a) for a in p]
    xt, mt = torch.from_numpy(x), torch.from_numpy(m)
    err, act = _kernel_forward(leaves, xt, mt)
    want = K._lstm_ae_forward_plain(leaves, xt, mt)
    np.testing.assert_allclose(err.numpy(), want.numpy(), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(act.numpy(), K._lstm_ae_act_plain(leaves, xt, mt).numpy(), rtol=0, atol=1e-6)
    assert not err[~mt].any()  # a masked step's error is exactly 0
    # the CPU path of the wrapper is the plain loop, and saves nothing
    got, none = K.lstm_ae_forward(leaves, xt, mt, save_act=True)
    assert none is None and torch.equal(got, want)


@pytest.mark.parametrize("idx,s,w,t_len,f", [(i, *c) for i, c in enumerate(CASES)])
def test_kernel_algorithm_matches_jax_recon_error(idx, s, w, t_len, f):
    p, x, m = _case(idx, s, w, t_len, f)
    jp = J.AEParams(J.LSTMParams(*map(jnp.asarray, p[0:3])), J.LSTMParams(*map(jnp.asarray, p[3:6])),
                    jnp.asarray(p[6]), jnp.asarray(p[7]))
    want = np.asarray(jax.vmap(J.recon_error)(jp, jnp.asarray(x), jnp.asarray(m)))
    err, _ = _kernel_forward([torch.from_numpy(a) for a in p], torch.from_numpy(x), torch.from_numpy(m))
    np.testing.assert_allclose(err.numpy(), want, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("idx,s,w,t_len,f", [(i, *c) for i, c in enumerate(CASES)])
def test_kernel_act_feeds_split_backward(idx, s, w, t_len, f):
    """The recorded act through the backward's chain and products
    (float64) against float64 autograd of the plain loop, with the
    loss's upstream gradient 1/n_s."""
    p, x, m = _case(idx, s, w, t_len, f)
    _, act = _kernel_forward([torch.from_numpy(a) for a in p], torch.from_numpy(x), torch.from_numpy(m))
    leaves = [torch.from_numpy(a).double() for a in p]
    xt, mt = torch.from_numpy(x).double(), torch.from_numpy(m)
    grad_err = _loss_grad_err(mt)
    act = act.double()
    d_gates, d_out = _chain(leaves, xt, mt, act, grad_err)
    got = _products(xt, act, d_gates, d_out)
    want = K._lstm_ae_backward_plain(leaves, xt, mt, grad_err)
    _leaf_close(got, want, 1e-4, f"S={s} W={w} T={t_len} F={f}")
