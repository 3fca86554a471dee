"""The LSTM-AE kernels' work from shapes, pinned at the shape
`chip_smoke.py` phase 8(b) reckons (S=512, W=8, T=32, F=4, H=32). No
cell launches these kernels yet, so no run loads these files; the cell
that does will read them by the kernel's name."""

import importlib.util
import os

from conftest import BENCH
from portbench import peaks


def _work(kernel):
    path = os.path.join(BENCH, "rooflines", f"{kernel}.py")
    mod_spec = importlib.util.spec_from_file_location(f"roofline_{kernel}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.work


def test_forward_and_backward_work_at_the_training_shape():
    fwd = _work("lstm_ae_forward")
    bwd = _work("lstm_ae_backward")
    s, w, t, f, h = 512, 8, 32, 4, 32
    act = s * w * 2 * t * 6 * h * 4
    assert act == 201_326_592  # the 201 MB of saved activations
    params = s * 4 * (f * 128 + h * 128 + 128 + h * 128 + 128 + h * f + f)
    assert params == 18_620_416
    flops, nbytes = fwd(s, w, t, f, h)
    assert flops == 131072 * (2 * 128 * 36 + 2 * 128 * 32 + 2 * 32 * 4) == 2_315_255_808
    assert nbytes == params + 131072 * 21 + act
    b_flops, b_bytes = bwd(s, w, t, f, h)
    assert b_flops == 2 * flops and b_bytes == params // 2 + 131072 * 21 + act + params
    # the scoring forward: one window a model, no activations
    s_flops, s_bytes = fwd(s, 1, t, f, h, save_act=False, rows=True)
    assert s_flops == flops // w and s_bytes == params + s * t * 21
    # bytes bound both at the card's rate: 0.0665 and 0.0693 ms, PERF.md's bound_ms
    assert round(max(nbytes / peaks.HBM_BYTES_PER_S, flops / peaks.F32_FLOPS) * 1e3, 4) == 0.0665
    assert round(max(b_bytes / peaks.HBM_BYTES_PER_S, b_flops / peaks.F32_FLOPS) * 1e3, 4) == 0.0693


def test_roofline_share():
    assert peaks.roofline_share(0, peaks.HBM_BYTES_PER_S * 1e-3, 2e-3) == 50.0
