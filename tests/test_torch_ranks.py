"""The port's rank tests on the CPU against the JAX package's.

Values are multiples of 1/4 (exact in binary) drawn from a small range,
so ties are common, and masks drop random points. Ranks, tie terms and
gates are exact counts and must match exactly. Statistics and p-values
are the same f32 formulas (erfc / upper incomplete gamma evaluated by
two libraries), so they match to 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foremast_tpu.ops import ranks as jr
from foremast_tpu_torch.ops import ranks as tr


def _tied_pair(seed, b=8, n=30):
    rng = np.random.default_rng(seed)
    x = (rng.integers(0, 24, (b, n)) / 4.0).astype(np.float32)
    y = (rng.integers(0, 24, (b, n)) / 4.0).astype(np.float32)
    y[:3] += 1.5  # shifted rows: some tests reject
    xm = rng.random((b, n)) > 0.15
    ym = rng.random((b, n)) > 0.15
    xm[-1, 4:] = False  # below every min-points gate
    ym[-2] = False  # no baseline at all
    y[-3] = x[-3]  # identical pairs: Wilcoxon drops all, Friedman ties
    return x, xm, y, ym


def test_masked_ranks_match_jax():
    x, xm, _, _ = _tied_pair(0)
    got_r, got_t = tr.masked_ranks(torch.from_numpy(x), torch.from_numpy(xm))
    want_r, want_t = jr.masked_ranks(jnp.asarray(x), jnp.asarray(xm))
    np.testing.assert_array_equal(got_r.numpy(), np.asarray(want_r))
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    assert (got_t.numpy() > 0).any()  # the data really has ties


def test_two_sample_rank_stats_match_jax():
    args = _tied_pair(1)
    got = tr._two_sample_rank_stats(*map(torch.from_numpy, args))
    want = jr._two_sample_rank_stats(*map(jnp.asarray, args))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize(
    "name,min_points",
    [
        ("mann_whitney_u", 20),
        ("wilcoxon_signed_rank", 20),
        ("kruskal_wallis", 5),
        ("friedman_chi_square", 20),
    ],
)
def test_rank_test_matches_jax(name, min_points):
    args = _tied_pair(2)
    got = getattr(tr, name)(*map(torch.from_numpy, args), min_points=min_points)
    want = getattr(jr, name)(*map(jnp.asarray, args), min_points=min_points)
    stat, p, ok = got
    np.testing.assert_array_equal(ok.numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(stat.numpy(), np.asarray(want[0]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(p.numpy(), np.asarray(want[1]), rtol=1e-5, atol=1e-5)
    assert ok.any() and not ok.all()  # both gated and live rows
    assert (p.numpy()[~ok.numpy()] == 1.0).all()
