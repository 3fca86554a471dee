"""The scan kernels' plain versions stop after the last valid step.

`holt_winters_scan` and `holt_scan` run their recurrence only to the
batch's last valid step (the CUDA kernels to each block's) and fill the
rest of `pred` from the frozen state: masked steps change no state and
add nothing to the SSE. The reference here is the full-length step loop
over every column, written out below with the same rounded f32
operations; state, SSE and predictions must hold the same bits
(tolerance 0), on masks with trailing padding, interior gaps, late
starts, all-masked rows and single points.
"""

import re

import numpy as np
import pytest
import torch

from foremast_tpu_torch.ops import _build
from foremast_tpu_torch.ops import forecasters as tf
from foremast_tpu_torch.ops import kernels as K

GRID = torch.tensor(tf._HW_GRID, dtype=torch.float32)


def _hw_full(values, mask, init_level, init_season, params, per_series):
    """Holt-Winters over all T columns, no early stop: [G, B] state,
    [G, B, m] season, [G, B] f64 SSE, pred of parameter set 0."""
    b, t_len = values.shape
    m = init_season.shape[1]
    cols = (params[:, 0], params[:, 1], params[:, 2]) if per_series else (
        params[:, 0:1], params[:, 1:2], params[:, 2:3])
    alpha, beta, gamma = cols
    g = 1 if per_series else params.shape[0]
    level = init_level.expand(g, b).clone()
    trend = torch.zeros((g, b))
    season = init_season.t()[:, None, :].expand(m, g, b).clone()
    sse = torch.zeros((g, b), dtype=torch.float64)
    inited = torch.zeros(b, dtype=torch.bool)
    preds = []
    for t in range(t_len):
        x, msk = values[:, t], mask[:, t]
        s = season[t % m].clone()
        lt = level + trend
        forecast = lt + s
        new_level = alpha * (x - s) + (1.0 - alpha) * lt
        new_trend = beta * (new_level - level) + (1.0 - beta) * trend
        new_s = gamma * (x - new_level) + (1.0 - gamma) * s
        upd = msk & inited
        season[t % m] = torch.where(upd, new_s, s)
        level = torch.where(upd, new_level, level)
        trend = torch.where(upd, new_trend, trend)
        out = torch.where(inited, forecast, x)
        r = x - out
        sse = sse + torch.where(msk, r * r, torch.zeros_like(r)).double()
        preds.append(out[0])
        inited = inited | msk
    pred = torch.stack(preds, dim=1) if preds else values.new_zeros((b, 0))
    return level, trend, season.permute(1, 2, 0), sse, pred


def _holt_full(values, mask, alpha, beta):
    b, t_len = values.shape
    level = torch.zeros(b)
    trend = torch.zeros(b)
    inited = torch.zeros(b, dtype=torch.bool)
    preds = []
    for t in range(t_len):
        x, msk = values[:, t], mask[:, t]
        lt = level + trend
        new_level = alpha * x + (1.0 - alpha) * lt
        new_trend = beta * (new_level - level) + (1.0 - beta) * trend
        first = msk & ~inited
        upd = msk & inited
        level = torch.where(first, x, torch.where(upd, new_level, level))
        trend = torch.where(first, torch.zeros_like(trend), torch.where(upd, new_trend, trend))
        preds.append(torch.where(inited, lt, x))
        inited = inited | msk
    pred = torch.stack(preds, dim=1) if preds else values.new_zeros((b, 0))
    return level, trend, pred


def _assert_bits(got, want):
    for a, w in zip(got, want):
        assert a.dtype == w.dtype and a.shape == w.shape
        ints = torch.int32 if a.dtype == torch.float32 else torch.int64
        assert torch.equal(a.contiguous().view(ints), w.contiguous().view(ints))


def _batch(seed, b, t_len, m, end):
    """Rows cycling through all-masked, a single point, an interior gap, a
    late start and full, every row's history ending at `end` (bucket
    padding after it) but for the first two full ones, which end earlier."""
    rng = np.random.default_rng(seed)
    v = (2.0 + np.sin(2 * np.pi * np.arange(t_len) / max(m, 2))[None, :]
         + rng.normal(0, 0.1, (b, t_len))).astype(np.float32)
    mk = np.zeros((b, t_len), bool)
    mk[:, :end] = True
    k = np.arange(b) % 5
    mk[k == 0] = False
    mk[k == 1] = False
    mk[k == 1, end // 2] = True
    mk[k == 2, end // 4 : end // 2] = False
    mk[k == 3, : (2 * end) // 3] = False
    mk[4, end // 3 :] = False
    mk[9, end - 7 :] = False
    return torch.from_numpy(v), torch.from_numpy(mk)


@pytest.mark.parametrize("m_len", [1, 24, 60, 1440])
@pytest.mark.parametrize("padded", [True, False], ids=["padded", "ragged"])
def test_stopped_holt_winters_equals_full_loop(m_len, padded):
    """Grid and per-series runs of the stopped plain version against the
    full loop, bit for bit; "padded" ends every row 37 steps before T."""
    t_len = 2 * m_len + 37
    end = t_len - 37 if padded else t_len
    values, mask = _batch(m_len, 12, t_len, m_len, end)
    il, isn = tf._hw_init(values, mask, m_len)
    got = K.holt_winters_scan(values, mask, il, isn, GRID)
    want = _hw_full(values, mask, il, isn, GRID, False)
    _assert_bits(got[:4], want[:4])
    params = GRID[torch.arange(12) % len(GRID)].contiguous()
    got = K.holt_winters_scan(values, mask, il, isn, params, per_series=True, want_pred=True)
    _assert_bits(got, _hw_full(values, mask, il, isn, params, True))


@pytest.mark.parametrize("padded", [True, False], ids=["padded", "ragged"])
def test_stopped_holt_equals_full_loop(padded):
    t_len = 300
    values, mask = _batch(5, 12, t_len, 24, t_len - 61 if padded else t_len)
    alpha = torch.linspace(0.05, 0.9, 12)
    beta = torch.linspace(0.01, 0.4, 12)
    _assert_bits(K.holt_scan(values, mask, alpha, beta), _holt_full(values, mask, alpha, beta))


def test_holt_winters_scan_takes_a_given_last_valid():
    """`fit_holt_winters` passes the mask's last valid index to both of
    its launches; that computes the same numbers as leaving it out, and an
    empty row is -1."""
    values, mask = _batch(3, 10, 100, 12, 80)
    lv = K.last_valid_index(mask)
    assert int(lv[0]) == -1 and int(lv.max()) == 79
    il, isn = tf._hw_init(values, mask, 12)
    _assert_bits(K.holt_winters_scan(values, mask, il, isn, GRID, last_valid=lv)[:4],
                 K.holt_winters_scan(values, mask, il, isn, GRID)[:4])
    assert torch.equal(K.last_valid_index(torch.zeros((3, 0), dtype=torch.bool)), torch.full((3,), -1))


@pytest.mark.parametrize("t_len", [1, 7, 300])
def test_last_valid_index_is_the_largest_valid_column(t_len):
    rng = np.random.default_rng(t_len)
    mask = torch.from_numpy(rng.random((9, t_len)) > 0.7)
    mask[0] = False
    mask[1] = True
    want = torch.where(mask, torch.arange(t_len)[None, :], -1).amax(dim=-1)
    got = K.last_valid_index(mask)
    assert got.dtype == torch.int64 and torch.equal(got, want)


@pytest.mark.parametrize("value,dtype", [
    (0.3, torch.float32), (np.float32(0.1), torch.float32), (np.float64(0.7), torch.float32),
    (3, torch.int32), (np.int64(2), torch.int32),
])
def test_scalar_rows_are_filled_as_the_tensor_path_converts(value, dtype):
    """A number per-row operand (the scans' alpha / beta) is filled on the
    device with the bits `torch.as_tensor(value).to(dtype)` gives."""
    got = K._row(value, 5, dtype, "cpu")
    want = torch.as_tensor(value).to(dtype).expand(5)
    assert got.dtype == dtype and got.is_contiguous() and torch.equal(got, want)


def test_fit_holt_winters_builds_the_initial_state_once(monkeypatch):
    """The grid launch and the per-series launch share one `_hw_init` pass."""
    calls = []
    real = tf._hw_init
    monkeypatch.setattr(tf, "_hw_init", lambda *a: calls.append(1) or real(*a))
    values, mask = _batch(4, 10, 120, 12, 120)
    tf.fit_holt_winters(values, mask, 12)
    assert len(calls) == 1


@pytest.mark.parametrize("split", ["parameter sets", "series", "series with predictions"])
def test_holt_winters_scan_splits_what_one_launch_cannot_take(monkeypatch, split):
    """More parameter sets than a launch takes, or a season of 2^31
    entries or more, run as several calls of the kernel (here the plain
    version, with the limits lowered); the joined result holds the bits of
    one call."""
    m_len, b = 200, 12
    t_len = 2 * m_len + 37
    values, mask = _batch(8, b, t_len, m_len, t_len - 37)
    il, isn = tf._hw_init(values, mask, m_len)
    per_series = split == "series with predictions"
    params = GRID[torch.arange(b) % len(GRID)].contiguous() if per_series else GRID
    want = K.holt_winters_scan(values, mask, il, isn, params, per_series, per_series)
    if split == "parameter sets":
        monkeypatch.setattr(K, "_MAX_G", 3)  # 8 = 3 + 3 + 2
    else:
        g = 1 if per_series else len(GRID)
        monkeypatch.setattr(K, "_SEASON_ENTRIES", 5 * m_len * g + 1)  # 12 rows = 5 + 5 + 2
    calls = []
    plain = K._holt_winters_scan_plain
    monkeypatch.setattr(K, "_holt_winters_scan_plain", lambda *a: calls.append(a[0].shape[0]) or plain(*a))
    got = K.holt_winters_scan(values, mask, il, isn, params, per_series, per_series)
    assert calls == ([b] * 3 if split == "parameter sets" else [5, 5, 2])
    _assert_bits(got[:4], want[:4])
    assert (got[4] is None) == (not per_series)
    if per_series:
        _assert_bits(got[4:], want[4:])


def test_parameter_set_limit_is_the_entry_points():
    """The wrapper splits at the parameter sets `fm_holt_winters_scan`
    refuses beyond (no compiler runs here: read from the source)."""
    src = (_build.SRC_DIR / "scan_tiles.cuh").read_text()
    assert re.findall(r"constexpr int kMaxG = (\d+);", src) == [str(K._MAX_G)]
