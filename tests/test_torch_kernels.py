"""The port's kernel wrappers on the CPU (their plain PyTorch versions)
against the JAX package's Pallas kernels in interpret mode.

Same numpy inputs to both. Counts, verdicts and anomaly flags must match
exactly. Means, stds and bands of the f32 kernels match to 1e-4 (rtol and
atol): both are two-pass f32 reductions, summed in another order. The
bf16-delta kernel's bands match to 1e-5: one f32 pass over the same
bf16 deltas, again only the summation order differs.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foremast_tpu.ops import kernels as jk
from foremast_tpu_torch.ops import _build
from foremast_tpu_torch.ops import kernels as tk


def _rand_batch(rng, b, t):
    vals = rng.normal(2.0, 1.5, size=(b, t)).astype(np.float32)
    mask = rng.random((b, t)) > 0.2
    mask[0] = False  # one fully-masked series
    mask[1, 5:] = False  # one nearly-empty series
    return vals, mask


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("b,t", [(5, 300), (3, 131)])
def test_masked_stats_plain_matches_pallas(b, t):
    rng = np.random.default_rng(0)
    vals, mask = _rand_batch(rng, b, t)
    want = jk.masked_stats(jnp.asarray(vals), jnp.asarray(mask), interpret=True)
    got = tk.masked_stats(_t(vals), _t(mask))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)


def _judgment_inputs(rng, b, th, tc):
    hist_v, hist_m = _rand_batch(rng, b, th)
    cur_v = rng.normal(2.0, 1.5, size=(b, tc)).astype(np.float32)
    cur_v[2, tc // 2] = 50.0  # guaranteed upper breach
    cur_v[-1, 0] = -50.0  # guaranteed lower breach
    cur_m = np.ones((b, tc), bool)
    cur_m[1, :] = False  # no current data -> unknown
    cur_m[-1, -1] = False
    # every row's selector in turn: upper, lower, both
    bound = np.array([1, 2, 3] * b, np.int32)[:b]
    thr = np.full(b, 2.0, np.float32)
    mlb = np.where(np.arange(b) % 2 == 0, 0.0, 1.0).astype(np.float32)
    mnp = np.full(b, 10, np.int32)
    return hist_v, hist_m, cur_v, cur_m, thr, bound, mlb, mnp


@pytest.mark.parametrize("b,th,tc", [(6, 400, 30), (3, 131, 7)])
def test_ma_judgment_plain_matches_pallas(b, th, tc):
    rng = np.random.default_rng(2)
    args = _judgment_inputs(rng, b, th, tc)
    want = jk.ma_judgment(*map(jnp.asarray, args), interpret=True)
    got = tk.ma_judgment(*map(_t, args))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[1].any() and got[0].dtype == torch.int32
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)


def test_ma_judgment_plain_takes_scalar_operands():
    """Per-row operands may be scalars, as in the JAX signature."""
    rng = np.random.default_rng(4)
    hist_v, hist_m, cur_v, cur_m, *_ = _judgment_inputs(rng, 4, 64, 8)
    vec = tk.ma_judgment(
        _t(hist_v), _t(hist_m), _t(cur_v), _t(cur_m),
        torch.full((4,), 2.0), torch.full((4,), 3, dtype=torch.int32),
        torch.zeros(4), torch.full((4,), 10),
    )
    sca = tk.ma_judgment(_t(hist_v), _t(hist_m), _t(cur_v), _t(cur_m), 2.0, 3, 0.0, 10)
    for a, b in zip(vec, sca):
        assert torch.equal(a, b)


def _bf16_inputs(rng, b, th, tc, lens):
    anchor = rng.normal(2.0, 0.5, b).astype(np.float32)
    delta = rng.normal(0.0, 0.5, (b, th)).astype(np.float32)
    delta[np.arange(th)[None, :] >= np.asarray(lens)[:, None]] = 0.0
    cur_v = (anchor[:, None] + rng.normal(0.0, 0.5, (b, tc))).astype(np.float32)
    cur_v[0, -1] = 40.0
    cur_m = np.ones((b, tc), bool)
    bound = np.array([1, 3, 2] * b, np.int32)[:b]
    thr = np.full(b, 2.5, np.float32)
    mlb = np.zeros(b, np.float32)
    mnp = np.full(b, 10, np.int32)
    return anchor, delta, np.asarray(lens, np.int32), cur_v, cur_m, thr, bound, mlb, mnp


@pytest.mark.parametrize(
    "th,tc,lens", [(300, 30, [300, 300, 150, 40, 5, 0]), (131, 7, [131, 0, 5])]
)
def test_ma_judgment_bf16_delta_plain_matches_pallas(th, tc, lens):
    rng = np.random.default_rng(3)
    args = _bf16_inputs(rng, len(lens), th, tc, lens)
    anchor, delta, *rest = args
    want = jk.ma_judgment_bf16_delta(
        jnp.asarray(anchor), jnp.asarray(delta, jnp.bfloat16),
        *map(jnp.asarray, rest), interpret=True,
    )
    got = tk.ma_judgment_bf16_delta(
        _t(anchor), _t(delta).to(torch.bfloat16), *map(_t, rest)
    )
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert (got[0].numpy()[np.asarray(lens) < 10] == 2).all()  # too short: unknown
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


def test_wrappers_refuse_mixed_devices():
    """A wrapper takes all-CPU (plain version) or all-CUDA (kernel)
    operands; anything else raises instead of picking a path."""
    v = torch.zeros((2, 8))
    with pytest.raises(ValueError):
        tk.masked_stats(v, torch.zeros((2, 8), dtype=torch.bool, device="meta"))


def test_launch_counts_untouched_by_plain_versions():
    before = dict(tk.LAUNCHES)
    tk.masked_stats(torch.zeros((2, 8)), torch.ones((2, 8), dtype=torch.bool))
    assert tk.LAUNCHES == before
    assert set(tk.LAUNCHES) == set(_build._ARGTYPES)


@pytest.mark.parametrize("name", sorted(_build._ARGTYPES))
def test_c_entry_points_match_ctypes_signatures(name):
    """No compiler runs here, so hold each `fm_<name>` C signature in its
    .cu source to the argtypes the loader sets: same parameter count, a
    pointer where the loader passes c_void_p, a 64-bit int where it passes
    c_int64, and the stream last."""
    src = (_build.SRC_DIR / f"{name}.cu").read_text()
    m = re.search(rf"FM_API int fm_{name}\((.*?)\)\s*{{", src, re.S)
    assert m, f"fm_{name} not defined in {name}.cu"
    params = [p.strip() for p in m.group(1).split(",")]
    types = _build._ARGTYPES[name]
    assert len(params) == len(types) + 1
    for p, ty in zip(params, types):
        if ty is _build._P:
            assert "*" in p, p
        else:
            assert p.startswith("long long"), p
    assert params[-1].startswith("cudaStream_t")


def test_source_hash_covers_every_source():
    digest = _build._source_hash()
    assert digest == _build._source_hash() and len(digest) == 16
    names = {p.stem for p in _build.SRC_DIR.glob("*.cu")}
    assert names == set(_build._ARGTYPES)
