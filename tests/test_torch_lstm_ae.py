"""The port's LSTM autoencoder on the CPU against the JAX package's.

JAX's `init_many` parameters (as numpy) are carried into the port with
`interop.ae_params_from_numpy`, so both sides run the same model on the
same seeded windows. On the CPU the port runs the kernels' plain
versions (`_lstm_ae_forward_plain`, autograd of the same loop).
Tolerances, with their reasons:

  * forward error: 1e-5 relative (+1e-7 absolute) — f32 products summed
    in another order than XLA's;
  * gradients, and parameters after 3 Adam steps: 1e-4 of each leaf's
    largest entry — the same, through backpropagation;
  * a 60-step training run: the per-model loss follows JAX's within
    1e-3 relative at every step (Adam normalizes each step, so rounding
    that flips the sign of a near-zero gradient moves a weight by a
    whole learning rate and the curves part slowly — a longer run would
    need a wider band);
  * the host quantiles (`ae_cutoff`, `chi2_quantile`) against scipy:
    1e-9 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foremast_tpu.models import lstm_ae as J
from foremast_tpu.models.residual_mvn import chi2_quantile as jax_chi2
from foremast_tpu_torch.interop import ae_params_from_numpy
from foremast_tpu_torch.models import lstm_ae as P
from foremast_tpu_torch.models.residual_mvn import chi2_quantile
from foremast_tpu_torch.ops import kernels as K
from foremast_tpu_torch.ops.quantiles import gamma_ppf


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run loops of small tensor ops, where torch's intra-op
    thread pool adds nothing but contention with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _windows(rng, s, w, t_len, f):
    """Seeded windows and a mask mixing full, all-masked, single-step,
    ragged-tail and random windows."""
    x = rng.normal(0.5, 0.3, (s, w, t_len, f)).astype(np.float32)
    m = np.zeros((s, w, t_len), bool)
    for i in range(s):
        for j in range(w):
            kind = (i * w + j) % 5
            if kind == 0:
                m[i, j] = True
            elif kind == 2:
                m[i, j, rng.integers(t_len)] = True
            elif kind == 3:
                m[i, j, : rng.integers(1, t_len + 1)] = True
            elif kind == 4:
                m[i, j] = rng.random(t_len) < 0.7
    return x, m


def _models(s, f, seed=1):
    jp = J.init_many(jax.random.key(seed), s, J.LSTMAEConfig(features=f))
    return jp, ae_params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _leaf_close(got, want, tol, what=""):
    for name, g, w in zip(K.AE_LEAVES, got, want):
        g = np.asarray(g, np.float64)
        w = np.asarray(w, np.float64)
        scale = np.abs(w).max()
        assert np.abs(g - w).max() <= tol * scale + 1e-12, f"{what} {name}: {np.abs(g - w).max()} vs {scale}"


@pytest.mark.parametrize("s,w,t_len,f", [(3, 4, 8, 3), (2, 8, 32, 4), (1, 1, 16, 2)])
def test_forward_matches_jax_recon_error(s, w, t_len, f):
    rng = np.random.default_rng(s * 100 + t_len)
    x, m = _windows(rng, s, w, t_len, f)
    jp, pp = _models(s, f)
    want = np.asarray(jax.vmap(J.recon_error)(jp, jnp.asarray(x), jnp.asarray(m)))
    got, act = K.lstm_ae_forward(P.leaves(pp), torch.from_numpy(x), torch.from_numpy(m))
    assert act is None  # no activations leave the CPU path
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-7)
    # one model's API and the reconstruction itself
    np.testing.assert_allclose(
        P.recon_error(P.tree_map(lambda a: a[0], pp), torch.from_numpy(x[0]), torch.from_numpy(m[0])).numpy(),
        want[0], rtol=1e-5, atol=1e-7,
    )
    r = jax.tree.map(lambda a: a[0], jp)
    np.testing.assert_allclose(
        P.reconstruct(P.tree_map(lambda a: a[0], pp), torch.from_numpy(x[0]), torch.from_numpy(m[0])).numpy(),
        np.asarray(J.reconstruct(r, jnp.asarray(x[0]), jnp.asarray(m[0]))), rtol=1e-5, atol=1e-6,
    )


@pytest.mark.parametrize("s,w,t_len,f", [(3, 5, 8, 3), (2, 8, 32, 4)])
def test_gradients_match_jax_grad(s, w, t_len, f):
    """Per-model gradients of Σ_s loss_s (the autograd Function's CPU
    path, and `lstm_ae_backward`'s plain version) against
    `jax.grad(loss_fn)` per model; all-masked windows included."""
    rng = np.random.default_rng(7 + t_len)
    x, m = _windows(rng, s, w, t_len, f)
    m[0, 1] = False  # an all-masked window in a model with valid ones
    jp, pp = _models(s, f, seed=3)
    jg = jax.vmap(jax.grad(J.loss_fn))(jp, jnp.asarray(x), jnp.asarray(m))
    want = [np.asarray(a) for a in jax.tree.leaves(jg)]
    ls = [p.detach().requires_grad_() for p in P.leaves(pp)]
    xt, mt = torch.from_numpy(x), torch.from_numpy(m)
    with torch.enable_grad():
        got = torch.autograd.grad(P._losses(ls, xt, mt).sum(), ls)
    _leaf_close(got, want, 1e-4, "Function")
    n = mt.sum(dim=(1, 2)).float().clamp_min(1.0)
    grad_err = (1.0 / n)[:, None, None].expand(s, w, t_len).contiguous()
    plain = K.lstm_ae_backward(P.leaves(pp), xt, mt, None, grad_err)
    _leaf_close(plain, want, 1e-4, "backward")
    assert not plain[3].any()  # the decoder's w_x sees a zero input


def test_three_adam_steps_match_train_step_many():
    s, f = 3, 3
    rng = np.random.default_rng(11)
    x, m = _windows(rng, s, 4, 16, f)
    jp, pp = _models(s, f, seed=5)
    cfg = J.LSTMAEConfig(features=f)
    jo = jax.vmap(J.make_optimizer(cfg).init)(jp)
    po = P.adam_init(pp)
    xt, mt = torch.from_numpy(x), torch.from_numpy(m)
    for _ in range(3):
        jp, jo, jl = J.train_step_many(jp, jo, jnp.asarray(x), jnp.asarray(m), cfg)
        pp, po, pl = P.train_step_many(pp, po, xt, mt, P.LSTMAEConfig(features=f))
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=1e-5)
    _leaf_close(P.leaves(pp), [np.asarray(a) for a in jax.tree.leaves(jp)], 1e-4, "after 3 steps")
    assert po.count == 3


def test_bias_corrections_equal_f32_tensors():
    """Adam's bias corrections come from the host as Python floats; for
    counts 1..60 they equal, bit for bit, the float32 tensors
    1 - b^count that the step once built per call."""
    for count in range(1, 61):
        got = torch.tensor(P.bias_corrections(count), dtype=torch.float32)
        want = torch.stack([1.0 - torch.tensor(b, dtype=torch.float32) ** count for b in (P._B1, P._B2)])
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), count


def test_sixty_step_run_follows_jax_loss():
    """fit_many from the same start for the judge's 60 steps: the loss
    curves stay within 1e-3 of each other, and the trained moments too."""
    s, f = 4, 4
    rng = np.random.default_rng(13)
    x = rng.normal(0.5, 0.1, (s, 8, 32, f)).astype(np.float32)
    x += 0.3 * np.sin(np.arange(32) / 4.0)[None, None, :, None].astype(np.float32)
    m = np.ones((s, 8, 32), bool)
    m[1, 6:] = False  # a short history: two masked training windows
    jp, pp = _models(s, f, seed=9)
    cfg = J.LSTMAEConfig(features=f)

    @jax.jit
    def jax_fit(p):
        o = jax.vmap(J.make_optimizer(cfg).init)(p)

        def body(c, _):
            p2, o2, loss = J.train_step_many(c[0], c[1], jnp.asarray(x), jnp.asarray(m), cfg)
            return (p2, o2), loss

        (p, _), losses = jax.lax.scan(body, (p, o), None, length=60)
        err = jax.vmap(J.recon_error)(p, jnp.asarray(x), jnp.asarray(m))
        return losses, err

    jl, jerr = jax_fit(jp)
    params, mean_e, std_e, pl = P.fit_many(None, torch.from_numpy(x), torch.from_numpy(m), steps=60, params=pp)
    jl = np.asarray(jl)
    assert pl.shape == (60, s)
    rel = np.abs(pl.numpy() - jl) / jl
    assert rel.max() < 1e-3, rel.max()
    assert (pl[-1] < pl[0]).all()  # it trained
    jn = m.sum(axis=(1, 2))
    np.testing.assert_allclose(mean_e.numpy(), np.asarray(jerr).sum(axis=(1, 2)) / jn, rtol=1e-3)


def test_score_rows_cutoff_gathers_repeated_rows():
    """Arena-style scoring: a [capacity, ...] stack, repeated rows."""
    cap, f = 5, 3
    rng = np.random.default_rng(17)
    jp, pp = _models(cap, f, seed=11)
    rows = np.array([3, 3, 0, 4, 3], np.int64)
    x, m = _windows(rng, len(rows), 1, 16, f)
    cut = np.array([0.1, 0.05, 0.2, 0.1, 0.0], np.float32)
    jf, je = J.score_rows_cutoff(jp, jnp.asarray(rows), jnp.asarray(x), jnp.asarray(m), jnp.asarray(cut))
    pf, pe = P.score_rows_cutoff(pp, torch.from_numpy(rows), torch.from_numpy(x), torch.from_numpy(m), torch.from_numpy(cut))
    np.testing.assert_allclose(pe.numpy(), np.asarray(je), rtol=1e-5, atol=1e-7)
    near = m & (np.abs(np.asarray(je) - cut[:, None, None]) <= 1e-5 * np.abs(cut[:, None, None]))
    assert not near.any()  # no valid error within rounding of its cutoff
    np.testing.assert_array_equal(pf.numpy(), np.asarray(jf))
    # repeated rows score identical windows identically
    pe2 = P.score_many_cutoff(P.tree_map(lambda a: a[torch.from_numpy(rows)], pp), torch.from_numpy(x),
                              torch.from_numpy(m), torch.from_numpy(cut))[1]
    assert torch.equal(pe, pe2)


THRESHOLDS = (2.0, 2.5, 3.0, 4.0, 5.0, 6.0)


def test_ae_cutoff_matches_scipy():
    """The gamma-quantile cutoff against the JAX package's scipy-backed
    one, over shapes k from 1e-6 (k << 1) to 1e8, var = 0 rows, a zero
    mean, and thresholds 2-6 (scalar and per row): equal in float32."""
    means, stds = [], []
    for k in (1e-6, 1e-3, 0.05, 0.5, 1.0, 3.7, 40.0, 1e4, 1e8):
        for mean in (1e-4, 0.02, 3.0):
            means.append(mean)
            stds.append(mean / np.sqrt(k))
    means += [0.5, 0.0, 1e-3]
    stds += [0.0, 0.0, 0.0]  # var = 0: the mean, then mean + thr*std
    mu = np.asarray(means, np.float32)
    sd = np.asarray(stds, np.float32)
    for thr in THRESHOLDS:
        np.testing.assert_allclose(P.ae_cutoff(mu, sd, thr), J.ae_cutoff(mu, sd, thr), rtol=1e-9)
    per_row = np.asarray([THRESHOLDS[i % len(THRESHOLDS)] for i in range(len(mu))], np.float32)
    np.testing.assert_allclose(P.ae_cutoff(mu, sd, per_row), J.ae_cutoff(mu, sd, per_row), rtol=1e-9)


def test_host_quantiles_match_scipy():
    """chi2_quantile at F = 1..8 and the gamma quantile in float64 before
    any cast: 1e-9 relative."""
    from scipy import stats

    for thr in THRESHOLDS + (4.0 + 1.0, 0.5):
        for dof in range(1, 9):
            assert chi2_quantile(thr, dof) == pytest.approx(jax_chi2(thr, dof), rel=1e-9)
        q = 1.0 - min(max(2.0 * stats.norm.sf(thr), 1e-300), 1.0)
        for k in (1e-6, 1e-3, 0.05, 0.5, 1.0, 3.7, 40.0, 1e4, 1e8):
            want = stats.gamma.ppf(q, k, scale=0.37)
            assert float(gamma_ppf(q, k, 0.37)) == pytest.approx(want, rel=1e-9)
