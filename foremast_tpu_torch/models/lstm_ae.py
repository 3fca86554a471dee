"""LSTM-autoencoder multivariate anomaly detector (train + score).

The JAX package's `models/lstm_ae.py` on torch: parameters as NamedTuples
of tensors stacked [S, ...] along a leading service axis, one small model
per service; the encoder's masked steps carry state through unchanged,
the decoder runs on a zero input from the encoder's final state, and a
window point is anomalous where its reconstruction error exceeds the
model's calibrated cutoff (`ae_cutoff`).

On the card the forward and backward passes are the hand-written
`lstm_ae_forward` / `lstm_ae_backward` kernels (`ops/kernels.py`),
reached through the `LSTMAEError` autograd function in training and the
forward wrapper in scoring. Adam is applied to the stacked leaves in
optax's order (`mu`, `nu`, bias correction, `eps` outside the root):
Adam works element by element, so one Adam over the stack equals optax's
vmapped per-model Adam, and the objective is the SUM of the per-model
losses (each normalized by its own mask count) so no model's gradient
is scaled by 1/S.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from foremast_tpu_torch.ops import kernels
from foremast_tpu_torch.ops.quantiles import gamma_ppf, two_sided_tail


class LSTMParams(NamedTuple):
    """One LSTM cell: gates stacked [i, f, g, o] along the last axis."""

    w_x: torch.Tensor  # [F_in, 4H]
    w_h: torch.Tensor  # [H, 4H]
    b: torch.Tensor  # [4H]


class AEParams(NamedTuple):
    enc: LSTMParams  # features -> hidden
    dec: LSTMParams  # zeros-input decoder conditioned on encoder state
    w_out: torch.Tensor  # [H, F]
    b_out: torch.Tensor  # [F]


@dataclasses.dataclass(frozen=True)
class LSTMAEConfig:
    features: int = 4  # metrics per service (latency/err4xx/err5xx/tps)
    hidden: int = 32
    learning_rate: float = 1e-2


# Adam's constants (optax.adam defaults)
_B1, _B2, _EPS = 0.9, 0.999, 1e-8


def leaves(p: AEParams) -> list:
    """The 8 leaves in the JAX pytree order (`kernels.AE_LEAVES`)."""
    return [*p.enc, *p.dec, p.w_out, p.b_out]


def from_leaves(ls) -> AEParams:
    ls = list(ls)
    return AEParams(enc=LSTMParams(*ls[0:3]), dec=LSTMParams(*ls[3:6]), w_out=ls[6], b_out=ls[7])


def tree_map(fn, *trees: AEParams) -> AEParams:
    return from_leaves(fn(*xs) for xs in zip(*(leaves(t) for t in trees)))


def init_many(gen: torch.Generator, n: int, cfg: LSTMAEConfig, device="cpu") -> AEParams:
    """[n, ...]-stacked params: glorot-uniform weights from `gen` (drawn on
    the CPU), zero biases but the forget gate's 1.0. JAX's random stream
    is not reproduced: carried weights go through `interop`."""
    f, h = cfg.features, cfg.hidden

    def glorot(fan_in, fan_out):
        limit = math.sqrt(6.0 / (fan_in + fan_out))
        u = torch.rand((n, fan_in, fan_out), generator=gen, dtype=torch.float32)
        return ((2.0 * u - 1.0) * limit).to(device)

    def cell():
        b = torch.zeros((n, 4 * h), dtype=torch.float32)
        b[:, h : 2 * h] = 1.0  # forget-gate bias (stable-training init)
        return LSTMParams(w_x=glorot(f, 4 * h), w_h=glorot(h, 4 * h), b=b.to(device))

    enc = cell()
    dec = cell()
    return AEParams(
        enc=enc, dec=dec, w_out=glorot(h, f), b_out=torch.zeros((n, f), dtype=torch.float32, device=device)
    )


def init(gen: torch.Generator, cfg: LSTMAEConfig, device="cpu") -> AEParams:
    """One model's params (the [0] slice of `init_many`)."""
    return tree_map(lambda a: a[0], init_many(gen, 1, cfg, device))


def _stack1(params: AEParams) -> list:
    return [leaf[None] for leaf in leaves(params)]


def reconstruct(params: AEParams, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Encode-decode one model's windows (plain torch on any device).
    x: [B, T, F], mask: [B, T] -> recon [B, T, F]."""
    return kernels._lstm_ae_reconstruct_plain(_stack1(params), x[None], mask[None])[0]


def recon_error(params: AEParams, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-step reconstruction error (mean squared over features), [B, T]."""
    return kernels.lstm_ae_forward(_stack1(params), x[None].contiguous(), mask[None].contiguous())[0][0]


def loss_fn(params: AEParams, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    e = kernels.LSTMAEError.apply(x[None].contiguous(), mask[None].contiguous(), *_stack1(params))[0]
    n = mask.sum().to(e.dtype).clamp_min(1.0)
    return e.sum() / n


class AdamState(NamedTuple):
    count: int
    mu: list
    nu: list


def adam_init(params: AEParams) -> AdamState:
    return AdamState(0, [torch.zeros_like(p) for p in leaves(params)], [torch.zeros_like(p) for p in leaves(params)])


def _losses(ls, x, mask) -> torch.Tensor:
    """Per-model losses [S]: sum of err over (W, T) over the mask count."""
    err = kernels.LSTMAEError.apply(x, mask, *ls)
    n = mask.sum(dim=(1, 2)).to(err.dtype).clamp_min(1.0)
    return err.sum(dim=(1, 2)) / n


def bias_corrections(count: int) -> tuple[float, float]:
    """Adam's (1 - b1^count, 1 - b2^count), rounded as float32 on the
    host: Python floats reach the update without a host-to-device copy."""
    b1, b2 = (torch.tensor(b, dtype=torch.float32) for b in (_B1, _B2))
    return float(1.0 - b1**count), float(1.0 - b2**count)


def train_step_many(params: AEParams, opt: AdamState, x: torch.Tensor, mask: torch.Tensor, cfg: LSTMAEConfig):
    """One Adam step of every model: params/opt stacked [S, ...], x [S,
    W, T, F], mask [S, W, T]. Returns (params, opt, loss [S]) — the loss
    before the step, as JAX's `train_step_many` returns it."""
    ls = [p.detach().requires_grad_() for p in leaves(params)]
    with torch.enable_grad():
        loss = _losses(ls, x, mask)
        grads = torch.autograd.grad(loss.sum(), ls)
    count = opt.count + 1
    bc1, bc2 = bias_corrections(count)
    new_p, new_mu, new_nu = [], [], []
    with torch.no_grad():
        for p, g, mu, nu in zip(ls, grads, opt.mu, opt.nu):
            mu = (1 - _B1) * g + _B1 * mu
            nu = (1 - _B2) * (g * g) + _B2 * nu
            upd = (mu / bc1) / (torch.sqrt(nu / bc2) + _EPS)
            new_p.append(p.detach() + (-cfg.learning_rate) * upd)
            new_mu.append(mu)
            new_nu.append(nu)
    return from_leaves(new_p), AdamState(count, new_mu, new_nu), loss.detach()


def _error_moments(params: AEParams, x, mask):
    err = kernels.lstm_ae_forward(leaves(params), x, mask)[0]
    n = mask.sum(dim=(1, 2)).to(err.dtype).clamp_min(1.0)
    mean_e = err.sum(dim=(1, 2)) / n
    dev2 = torch.where(mask, (err - mean_e[:, None, None]) ** 2, torch.zeros_like(err))
    return mean_e, torch.sqrt(dev2.sum(dim=(1, 2)) / n)


def fit_many(
    gen: torch.Generator | None,
    x: torch.Tensor,
    mask: torch.Tensor,
    cfg: LSTMAEConfig | None = None,
    steps: int = 100,
    params: AEParams | None = None,
):
    """Train S per-service models on [S, W, T, F] windows (W <= 8 on the
    card) from `init_many(gen)` (seed 0 when `gen` is None) or from
    `params`. Returns (params [S, ...], err_mean [S], err_std [S],
    losses [steps, S]): the trained model's in-sample
    reconstruction-error moments feed `ae_cutoff`."""
    if cfg is None:
        cfg = LSTMAEConfig(features=x.shape[-1])
    x = x.float().contiguous()
    mask = mask.contiguous()
    if params is None:
        if gen is None:
            gen = torch.Generator().manual_seed(0)
        params = init_many(gen, x.shape[0], cfg, device=x.device)
    opt = adam_init(params)
    losses = []
    for _ in range(steps):
        params, opt, loss = train_step_many(params, opt, x, mask, cfg)
        losses.append(loss)
    mean_e, std_e = _error_moments(params, x, mask)
    stacked = torch.stack(losses) if losses else x.new_zeros((0, x.shape[0]))
    return params, mean_e, std_e, stacked


def shardings(mesh, params: AEParams, opt_state: AdamState, hidden: int):
    """Placements of stacked params / Adam state on a (data, model) mesh:
    the leading service axis over `data`, everything else whole.

    The JAX package also splits each 4H gate axis over `model`. The
    port's LSTM-AE kernels keep a model's whole 4H gate row in one warp
    (each lane's 4 gate columns of w_h in registers), so the gate axis
    stays on its card: `model` replicates the parameters. Placement
    only — results are unchanged (ROADMAP.md Queue 3)."""
    from foremast_tpu_torch.parallel import mesh as meshlib

    del hidden  # the gate axis is never split here

    def spec(leaf):
        return meshlib.data_sharding(mesh, leaf.ndim) if isinstance(leaf, torch.Tensor) else None

    return tree_map(spec, params), AdamState(opt_state.count, [spec(m) for m in opt_state.mu], [spec(v) for v in opt_state.nu])


def ae_cutoff(err_mean, err_std, threshold) -> np.ndarray:
    """Quantile-matched reconstruction-error cutoff, [S] (host-side).

    The training-error moments fit a gamma (k = mean^2/var, theta =
    var/mean) and the cutoff is its quantile with the same tail mass as
    the two-sided normal tail P(|z| > threshold); never less than the
    classic mean + threshold*sigma. `threshold` scalar or [S]. Guards as
    the JAX package keeps them: var > 0, a non-finite quantile falls back
    to the mean."""
    mean = np.maximum(np.asarray(err_mean, np.float64), 1e-300)
    std = np.asarray(err_std, np.float64)
    var = np.maximum(std * std, 0.0)
    p_tail = two_sided_tail(np.asarray(threshold, np.float64))
    with np.errstate(divide="ignore", invalid="ignore"):
        k = np.where(var > 0, mean * mean / np.maximum(var, 1e-300), 1.0)
        theta = np.where(var > 0, var / mean, 0.0)
        gq = gamma_ppf(1.0 - p_tail, k, theta)
    gq = np.where((var > 0) & np.isfinite(gq), gq, mean)
    return np.maximum(gq, np.asarray(err_mean) + np.asarray(threshold) * std).astype(np.float32)


def score_many(params: AEParams, x, mask, err_mean, err_std, threshold):
    """Flags [S, B, T] against the classic mean + threshold*sigma bound,
    and the errors (the simple API; the judge uses `score_many_cutoff`)."""
    err = kernels.lstm_ae_forward(leaves(params), x, mask)[0]
    thr = torch.as_tensor(threshold, dtype=err.dtype, device=err.device)
    bound = (err_mean + thr * err_std)[:, None, None]
    return mask & (err > bound), err


def score_many_cutoff(params: AEParams, x, mask, cutoff):
    """Flags [S, B, T] against per-model cutoffs [S] (`ae_cutoff`), and
    the errors."""
    err = kernels.lstm_ae_forward(leaves(params), x, mask)[0]
    return mask & (err > cutoff[:, None, None]), err


def score_rows_cutoff(params: AEParams, rows, x, mask, cutoff):
    """`score_many_cutoff` against arena-resident models: leaves stacked
    [capacity, ...], `rows` [S] int64 picks each model, gathered inside
    the forward kernel (no parameter stack moves)."""
    err = kernels.lstm_ae_forward(leaves(params), x, mask, rows=rows)[0]
    return mask & (err > cutoff[:, None, None]), err


def params_from_tree(tree, leaf_fn=np.asarray) -> AEParams:
    """An AE parameter tree in any layout a checkpoint or the JAX package
    hands over -> `AEParams` with `leaf_fn` applied to each leaf: a
    NamedTuple with `enc`/`dec` cells (this module's or the JAX
    package's), a dict of dicts, or nested sequences in pytree order."""

    def cell(c) -> LSTMParams:
        if isinstance(c, dict):
            return LSTMParams(*(leaf_fn(c[k]) for k in ("w_x", "w_h", "b")))
        return LSTMParams(*(leaf_fn(v) for v in c))

    if isinstance(tree, dict):
        return AEParams(cell(tree["enc"]), cell(tree["dec"]), leaf_fn(tree["w_out"]), leaf_fn(tree["b_out"]))
    if hasattr(tree, "enc"):
        return AEParams(cell(tree.enc), cell(tree.dec), leaf_fn(tree.w_out), leaf_fn(tree.b_out))
    enc, dec, w_out, b_out = tree
    return AEParams(cell(enc), cell(dec), leaf_fn(w_out), leaf_fn(b_out))
