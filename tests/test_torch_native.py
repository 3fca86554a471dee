"""The port's host packing library (`foremast_tpu_torch/native.py` over
its copy of `windowpack.cpp`) against the JAX package's `native` module,
the JAX judge's bf16-delta packing and the port's numpy row loops.

Same numpy inputs, made from a seed, to every side; every comparison is
exact (bit for bit)."""

import ml_dtypes
import numpy as np
import pytest
import torch

from foremast_tpu import native as jn
from foremast_tpu.engine import judge as jj
from foremast_tpu_torch import native as tn
from foremast_tpu_torch.engine import judge as tj
from foremast_tpu_torch.ops import windows as tw

pytestmark = pytest.mark.skipif(
    not (jn.ensure_built() and tn.ensure_built()), reason="g++ could not build a packing library"
)

# binary edge values: signed zeros, NaN of both signs, infinities, the
# smallest and largest subnormals, the largest finite f32 (rounds to
# Inf in bf16), and exact rounding ties to even and to odd
_EDGE_BITS = np.array(
    [0x00000000, 0x80000000, 0x7FC00000, 0xFFC00000, 0x7F800001, 0x7F800000, 0xFF800000,
     0x00000001, 0x007FFFFF, 0x807FFFFF, 0x7F7FFFFF, 0x3F808000, 0x3F818000, 0xBF808000,
     0x3F80FFFF, 0x00008000],
    np.uint32,
)


def _ragged(seed, lens, edge=False):
    rng = np.random.default_rng(seed)
    series = []
    for i, n in enumerate(lens):
        v = (rng.normal(0, 1, n) * 10.0 ** rng.integers(-3, 4)).astype(np.float32)
        if edge and n:
            k = min(n, len(_EDGE_BITS))
            # the anchor is v[0]: zero it in every other row so the edge
            # values reach the deltas unshifted
            if i % 2 == 0:
                v[0] = 0.0
            v[1 : 1 + k] = _EDGE_BITS[: min(k, n - 1)].view(np.float32)
        series.append((np.sort(rng.integers(0, 2**31 - 1, n)).astype(np.int64), v))
    return series


_SHAPES = {
    "ragged": ([400, 17, 0, 1, 400], 512),
    "over_long": ([600, 3, 513], 512),
    "empty_rows": ([0, 0, 5], 8),
    "no_rows": ([], 16),
    "zero_length": ([3, 0], 0),
    "parallel": ([int(n) for n in np.random.default_rng(0).integers(0, 40, 2500)], 32),
}


@pytest.mark.parametrize("name", sorted(_SHAPES))
def test_pack_windows_equals_jax_and_the_numpy_loop(name):
    lens, length = _SHAPES[name]
    series = _ragged(1, lens)
    got = tn.pack_windows(series, length)
    plain = tn.pack_windows_plain(series, length)
    want = jn.pack_windows(series, length)
    for g, p, w in zip(got, plain, want):
        assert g.dtype == p.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(p, w)
    values, times, mask = tn.pack_windows(series, length, with_times=False)
    assert times is None
    np.testing.assert_array_equal(values, want[0])
    np.testing.assert_array_equal(mask, want[2])


def test_pack_windows_rejects_length_mismatch_as_jax_does():
    series = [(np.arange(3, dtype=np.int64), np.zeros(5, np.float32))]
    with pytest.raises(ValueError):
        jn.pack_windows(series, 8)
    with pytest.raises(ValueError):
        tn.pack_windows(series, 8)


def test_from_ragged_goes_through_the_library_and_equals_jax():
    from foremast_tpu.ops import windows as jw

    series = _ragged(4, [30, 0, 7, 64])
    want = jw.MetricWindows.from_ragged(series, 48)
    got = tw.MetricWindows.from_ragged(series, 48, device="cpu")
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_array_equal(got.times.numpy(), np.asarray(want.times))


@pytest.mark.parametrize("edge", [False, True], ids=["normal", "edge_values"])
@pytest.mark.parametrize("name", sorted(_SHAPES))
def test_bf16_delta_is_bit_equal_to_jax_and_the_plain_loop(name, edge):
    lens, length = _SHAPES[name]
    series = _ragged(2 + edge, lens, edge=edge)
    a_j, d_j, l_j = jj._pack_hist_bf16_host(series, length)
    a_n, d_n, l_n = tn.pack_bf16_delta(series, length)
    a_p, d_p, l_p = tn.pack_bf16_delta_plain(series, length)
    a_t, d_t, l_t = tj._pack_hist_bf16_host(series, length)
    want_d = np.asarray(d_j).view(np.uint16)
    for a, d, lens_ in ((a_n, d_n, l_n), (a_p, d_p, l_p), (a_t, d_t.view(torch.int16).numpy().view(np.uint16), l_t)):
        np.testing.assert_array_equal(np.asarray(a, np.float32).view(np.uint32), np.asarray(a_j, np.float32).view(np.uint32))
        np.testing.assert_array_equal(lens_, l_j)
        assert d.dtype == np.uint16 and d.shape == want_d.shape
        np.testing.assert_array_equal(d, want_d)
    assert d_t.dtype == torch.bfloat16


def test_bf16_rounding_matches_torch_on_every_non_nan_value():
    """The library's rounding is torch's cast on everything but NaN: a
    sweep of f32 bit patterns around every rounding boundary, the edges
    above, and random values. (torch's vectorized CPU cast writes every
    NaN as 0xFFFF; the JAX package keeps the quiet NaN of its sign, and
    the port follows the JAX package.)"""
    rng = np.random.default_rng(7)
    bits = np.concatenate([
        _EDGE_BITS,
        rng.integers(0, 2**32, 200_000, dtype=np.uint64).astype(np.uint32),
        (np.arange(-4, 5, dtype=np.int64)[None, :] + (np.arange(0, 2**32, 2**16, dtype=np.int64) + 2**15)[:, None])
        .ravel().astype(np.uint64).astype(np.uint32),
    ])
    x = bits.view(np.float32)
    series = [(np.arange(len(x) + 1, dtype=np.int64), np.concatenate([[np.float32(0)], x]))]
    _, got, _ = tn.pack_bf16_delta(series, len(x) + 1)
    got = got[0, 1:]
    nan = np.isnan(x)
    via_torch = torch.from_numpy(x.copy()).to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(got[~nan], via_torch[~nan])
    with np.errstate(invalid="ignore"):
        np.testing.assert_array_equal(got, x.astype(ml_dtypes.bfloat16).view(np.uint16))
    np.testing.assert_array_equal(tn.bf16_bits(x), got)


@pytest.mark.parametrize("fill", [0xABCD, 0xFFFF, 0x7FC0])
def test_bf16_delta_fills_an_uninitialized_buffer(fill):
    """Every element of the caller's buffer is written, padding included,
    whatever it held (a bf16 NaN, -NaN or a finite value)."""
    series = _ragged(5, [10, 0, 3])
    out = np.full((3, 16), fill, np.uint16)
    _, d, _ = tn.pack_bf16_delta(series, 16, out=out)
    assert d is out
    np.testing.assert_array_equal(out, tn.pack_bf16_delta_plain(series, 16)[1])
    with pytest.raises(ValueError):
        tn.pack_bf16_delta(series, 16, out=np.zeros((3, 8), np.uint16))


def test_library_off_switch_falls_back_to_the_loop(monkeypatch):
    monkeypatch.setenv("FOREMAST_NATIVE", "0")
    assert tn.pack_windows([], 4) is None and tn.pack_bf16_delta([], 4) is None
    series = _ragged(6, [9, 2])
    a, d, lens = tj._pack_hist_bf16_host(series, 12)
    a_p, d_p, l_p = tn.pack_bf16_delta_plain(series, 12)
    np.testing.assert_array_equal(d.view(torch.int16).numpy().view(np.uint16), d_p)
    np.testing.assert_array_equal(a, a_p)
    np.testing.assert_array_equal(lens, l_p)
    got = tw.MetricWindows.from_ragged(series, 12, device="cpu")
    np.testing.assert_array_equal(got.values.numpy(), tn.pack_windows_plain(series, 12)[0])
