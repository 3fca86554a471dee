"""The split backpropagation of `lstm_ae_backward`'s kernels, on the CPU.

The card's backward runs in two kernels: a chain that walks the decoder
from its last step down, then the encoder, carrying (dh, dc) and writing
each step's gate gradients dA [S, W, 2T, 4H] (zeros at a masked encoder
step) and the decoder's output gradients dy [S, W, T, F]; then products
that form every weight gradient from those and the saved activations:

    dW_h = sum h_prev^T dA   dW_x = sum x^T dA (encoder)   db = sum dA
    dW_out = sum h^T dy      db_out = sum dy

with h_prev zero before the encoder's first step and the encoder's final
(carried) state before the decoder's. The kernels cannot run here, so this
file holds a step-by-step torch reference of that algorithm, reading the
activations in the layout `lstm_ae_forward` saves them ([S, W, 2T, 6H]:
i, f, g, o, c, h a step; masked encoder steps keep the carried c, h),
against float64 autograd of the plain loop (`_lstm_ae_backward_plain`;
1e-5 of each leaf's largest gradient, both in float64: only the order of
the sums differs) and against `jax.grad` of the JAX package's `loss_fn`
(1e-4 of each leaf's largest gradient: JAX runs in f32 and sums in XLA's
order, as in tests/test_torch_lstm_ae.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foremast_tpu.models import lstm_ae as J
from foremast_tpu_torch.ops import kernels as K

H = 32
G = 4 * H


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Loops of small tensor ops: the intra-op pool only contends with the
    other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(rng, s, f):
    """Random leaves in `AE_LEAVES` order (glorot-scaled weights, biases
    and the output layer perturbed), as float64 numpy."""
    def u(*shape, scale):
        return rng.uniform(-scale, scale, shape)

    return [
        u(s, f, G, scale=(6 / (f + G)) ** 0.5), u(s, H, G, scale=(6 / (H + G)) ** 0.5), u(s, G, scale=0.5),
        u(s, f, G, scale=(6 / (f + G)) ** 0.5), u(s, H, G, scale=(6 / (H + G)) ** 0.5), u(s, G, scale=0.5),
        u(s, H, f, scale=(6 / (H + f)) ** 0.5), u(s, f, scale=0.5),
    ]


def _windows(rng, s, w, t_len, f):
    """Windows cycling through full, all-masked, single-valid-step,
    leading-masked, ragged-tail and random masks."""
    x = rng.normal(0.5, 0.5, (s, w, t_len, f))
    m = np.zeros((s, w, t_len), bool)
    for i in range(s):
        for j in range(w):
            kind = (i * w + j) % 6
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


def _forward_act(leaves, x, mask):
    """The encoder and the zero-input decoder, saving each step's (i, f,
    g, o, c, h) as `lstm_ae_forward` does -> act [S, W, 2T, 6H]."""
    ewx, ewh, eb, _dwx, dwh, db, _wout, _bout = leaves
    s, w, t_len, _ = x.shape
    h = x.new_zeros((s, w, H))
    c = torch.zeros_like(h)
    rows = []

    def gates(z):
        return (torch.sigmoid(z[..., :H]), torch.sigmoid(z[..., H:2 * H]), torch.tanh(z[..., 2 * H:3 * H]),
                torch.sigmoid(z[..., 3 * H:]))

    for t in range(t_len):
        i, f, g, o = gates(torch.bmm(x[:, :, t], ewx) + torch.bmm(h, ewh) + eb[:, None])
        c_new = f * c + i * g
        h_new = o * torch.tanh(c_new)
        keep = mask[:, :, t, None]
        c, h = torch.where(keep, c_new, c), torch.where(keep, h_new, h)
        rows.append(torch.cat([i, f, g, o, c, h], dim=-1))
    for _ in range(t_len):
        i, f, g, o = gates(torch.bmm(h, dwh) + db[:, None])
        c = f * c + i * g
        h = o * torch.tanh(c)
        rows.append(torch.cat([i, f, g, o, c, h], dim=-1))
    return torch.stack(rows, dim=2)


def _chain(leaves, x, mask, act, grad_err):
    """The chain kernel's walk: dA [S, W, 2T, 4H] and dy [S, W, T, F]."""
    _ewx, ewh, _eb, _dwx, dwh, _db, wout, bout = leaves
    s, w, t_len, f_n = x.shape
    i, f, g, o, c, h = act.split(H, dim=-1)
    d_gates = act.new_zeros((s, w, 2 * t_len, G))
    d_out = x.new_zeros((s, w, t_len, f_n))
    dh = x.new_zeros((s, w, H))
    dc = torch.zeros_like(dh)

    def cell_back(u, c_prev, dh, dc, w_h):
        tc = torch.tanh(c[:, :, u])
        d_o = dh * tc
        dc = dc + dh * o[:, :, u] * (1 - tc * tc)
        da = torch.cat([
            dc * g[:, :, u] * i[:, :, u] * (1 - i[:, :, u]),
            dc * c_prev * f[:, :, u] * (1 - f[:, :, u]),
            dc * i[:, :, u] * (1 - g[:, :, u] ** 2),
            d_o * o[:, :, u] * (1 - o[:, :, u]),
        ], dim=-1)
        return torch.bmm(da, w_h.transpose(1, 2)), dc * f[:, :, u], da

    for t in reversed(range(t_len)):  # decoder: step u = T + t, previous state u - 1
        u = t_len + t
        y = torch.bmm(h[:, :, u], wout) + bout[:, None]
        de = torch.where(mask[:, :, t], grad_err[:, :, t], torch.zeros_like(grad_err[:, :, t]))
        dy = de[..., None] * 2 * (y - x[:, :, t]) / f_n
        d_out[:, :, t] = dy
        dh = dh + torch.bmm(dy, wout.transpose(1, 2))
        dh, dc, d_gates[:, :, u] = cell_back(u, c[:, :, u - 1], dh, dc, dwh)
    for t in reversed(range(t_len)):  # encoder: a masked step passes the carry through
        c_prev = c[:, :, t - 1] if t > 0 else torch.zeros_like(dc)
        dh_new, dc_new, da = cell_back(t, c_prev, dh, dc, ewh)
        keep = mask[:, :, t, None]
        dh, dc = torch.where(keep, dh_new, dh), torch.where(keep, dc_new, dc)
        d_gates[:, :, t] = torch.where(keep, da, torch.zeros_like(da))
    return d_gates, d_out


def _products(x, act, d_gates, d_out, link=True):
    """The product kernel's sums over (window, step). `link=False` breaks
    the decoder's first h_prev (zero instead of the encoder's final
    state), to show a case depends on it."""
    t_len = x.shape[2]
    h = act[..., 5 * H:]
    h_enc = torch.cat([torch.zeros_like(h[:, :, :1]), h[:, :, : t_len - 1]], dim=2)
    h_dec = h[:, :, t_len - 1 : 2 * t_len - 1].clone()
    if not link:
        h_dec[:, :, 0] = 0
    da_enc, da_dec = d_gates[:, :, :t_len], d_gates[:, :, t_len:]
    return (
        torch.einsum("swtf,swtc->sfc", x, da_enc),
        torch.einsum("swtk,swtc->skc", h_enc, da_enc),
        da_enc.sum(dim=(1, 2)),
        torch.zeros((x.shape[0], x.shape[3], G), dtype=x.dtype),
        torch.einsum("swtk,swtc->skc", h_dec, da_dec),
        da_dec.sum(dim=(1, 2)),
        torch.einsum("swtk,swtf->skf", h[:, :, t_len:], d_out),
        d_out.sum(dim=(1, 2)),
    )


def _split_backward(leaves, x, mask, grad_err, link=True):
    act = _forward_act(leaves, x, mask)
    d_gates, d_out = _chain(leaves, x, mask, act, grad_err)
    return _products(x, act, d_gates, d_out, link), d_gates


def _leaf_close(got, want, tol, what):
    for name, g, w in zip(K.AE_LEAVES, got, want):
        g = np.asarray(g, np.float64)
        w = np.asarray(w, np.float64)
        err = np.abs(g - w).max() if g.size else 0.0
        scale = np.abs(w).max() if w.size else 0.0
        assert err <= tol * scale + 1e-12, f"{what} {name}: off by {err:.3e}, leaf max {scale:.3e}"


def _loss_grad_err(mask):
    """The loss's upstream gradient: 1 / (the model's valid count)."""
    n = mask.sum(dim=(1, 2)).double().clamp_min(1.0)
    return (1.0 / n)[:, None, None].expand(mask.shape).contiguous()


CASES = [  # (S, W, T, F)
    (2, 1, 8, 1),
    (3, 8, 16, 3),
    (1, 8, 5, 8),
    (4, 1, 16, 8),
    (2, 8, 1, 3),
    (4, 8, 12, 1),
]


@pytest.mark.parametrize("s,w,t_len,f", CASES)
def test_split_backward_matches_f64_autograd(s, w, t_len, f):
    rng = np.random.default_rng(1000 * s + 100 * w + t_len + f)
    leaves = [torch.from_numpy(a) for a in _params(rng, s, f)]
    x, m = _windows(rng, s, w, t_len, f)
    x, mask = torch.from_numpy(x), torch.from_numpy(m)
    grad_err = torch.from_numpy(rng.uniform(0.1, 1.0, (s, w, t_len)))
    got, d_gates = _split_backward(leaves, x, mask, grad_err)
    want = K._lstm_ae_backward_plain(leaves, x, mask, grad_err)
    _leaf_close(got, want, 1e-5, f"S={s} W={w} T={t_len} F={f}")
    # a masked encoder step leaves a zero row for the products
    assert not d_gates[:, :, :t_len][~mask].any()
    assert not got[3].any()  # the decoder's w_x sees a zero input


@pytest.mark.parametrize("s,w,t_len,f", CASES)
def test_split_backward_matches_jax_grad(s, w, t_len, f):
    """Per-model gradients of the loss (upstream 1/n_s) against
    `jax.grad(loss_fn)` on the same f32 parameters and windows."""
    rng = np.random.default_rng(7 + 1000 * s + 100 * w + t_len + f)
    p32 = [a.astype(np.float32) for a in _params(rng, s, f)]
    x, m = _windows(rng, s, w, t_len, f)
    x32 = x.astype(np.float32)
    jp = J.AEParams(J.LSTMParams(*map(jnp.asarray, p32[0:3])), J.LSTMParams(*map(jnp.asarray, p32[3:6])),
                    jnp.asarray(p32[6]), jnp.asarray(p32[7]))
    jg = jax.vmap(jax.grad(J.loss_fn))(jp, jnp.asarray(x32), jnp.asarray(m))
    want = [np.asarray(a) for a in jax.tree.leaves(jg)]
    mask = torch.from_numpy(m)
    got, _ = _split_backward([torch.from_numpy(a).double() for a in p32], torch.from_numpy(x32).double(), mask,
                             _loss_grad_err(mask))
    _leaf_close(got, want, 1e-4, f"S={s} W={w} T={t_len} F={f}")


def test_all_masked_model_has_zero_gradients():
    """A model whose every window is masked: no output counts, so every
    gradient is exactly zero (the chain writes only zero dA rows)."""
    rng = np.random.default_rng(5)
    s, w, t_len, f = 2, 8, 6, 3
    leaves = [torch.from_numpy(a) for a in _params(rng, s, f)]
    x, m = _windows(rng, s, w, t_len, f)
    m[1] = False
    mask = torch.from_numpy(m)
    got, d_gates = _split_backward(leaves, torch.from_numpy(x), mask, _loss_grad_err(mask))
    assert not d_gates[1].any()
    for leaf in got:
        assert not leaf[1].any()
    assert got[1][0].abs().max() > 0  # the other model trains


@pytest.mark.parametrize("t_len", [1, 4])
def test_decoder_first_step_links_to_encoder_final_state(t_len):
    """The decoder's step 0 takes the encoder's final state (carried over
    a masked tail) as h_prev and c_prev: the split reference matches
    autograd with that link and misses it with a zero h_prev there."""
    rng = np.random.default_rng(21 + t_len)
    s, w, f = 2, 3, 3
    leaves = [torch.from_numpy(a) for a in _params(rng, s, f)]
    x = torch.from_numpy(rng.normal(0.5, 0.5, (s, w, t_len, f)))
    m = np.ones((s, w, t_len), bool)
    if t_len > 1:
        m[:, 1, -2:] = False  # a masked tail: the final state is carried
    mask = torch.from_numpy(m)
    grad_err = _loss_grad_err(mask)
    want = K._lstm_ae_backward_plain(leaves, x, mask, grad_err)
    got, _ = _split_backward(leaves, x, mask, grad_err)
    _leaf_close(got, want, 1e-5, "linked")
    broken, _ = _split_backward(leaves, x, mask, grad_err, link=False)
    err = (broken[4] - want[4]).abs().max()
    assert err > 1e-3 * want[4].abs().max()  # dec w_h depends on the link
