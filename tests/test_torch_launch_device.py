"""Every kernel wrapper launches on its operands' device (`ops/kernels.py`
`_launch`): it makes that device current for the call and launches on
that device's current stream, not the current device's. A mesh block on
another card would otherwise launch on the wrong card's stream.

There is no card here, so the test stands in for the CUDA side: the
wrappers take their kernel route (`_on_cuda` patched true) on CPU
tensors, the kernel library is a stub that records each launch, and
`torch.cuda.device` / `torch.cuda.current_stream` are stubs that record
the device entered and the device whose stream was asked for. A wrapper
that asked for the current device's stream gets a stream of another
device ("cuda:0") and fails the check."""

from __future__ import annotations

import contextlib

import pytest
import torch

from foremast_tpu_torch.ops import _build, kernels


class _StubLib:
    def __init__(self, record):
        self.record = record

    def __getattr__(self, attr):
        if attr == "fm_holt_winters_scan_layout":
            def layout(out):
                for i, v in enumerate((64, 16, 160, 256)):
                    out[i] = v
            return layout
        if attr.startswith("fm_"):
            def entry(*args):
                self.record.append(("launch", attr[3:], args[-1]))
                return 0
            return entry
        raise AttributeError(attr)


class _Stream:
    def __init__(self, dev):
        self.cuda_stream = f"stream:{dev}"


@pytest.fixture
def stub(monkeypatch):
    record: list = []
    entered: list = []
    lib = _StubLib(record)
    monkeypatch.setattr(kernels, "_on_cuda", lambda *ts: True)
    monkeypatch.setattr(_build, "library", lambda name: lib)

    @contextlib.contextmanager
    def device(dev):
        entered.append(str(dev))
        yield

    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _Stream("cuda:0" if device is None else device))
    return record, entered


def _ae(s=2, w=2, t=5, f=3):
    h = 32
    g = 4 * h
    leaves = [
        torch.zeros(s, f, g), torch.zeros(s, h, g), torch.zeros(s, g),
        torch.zeros(s, f, g), torch.zeros(s, h, g), torch.zeros(s, g),
        torch.zeros(s, h, f), torch.zeros(s, f),
    ]
    x = torch.zeros(s, w, t, f)
    mask = torch.ones(s, w, t, dtype=torch.bool)
    return leaves, x, mask


def _calls():
    b, t, tc, m = 4, 16, 6, 3
    v = torch.zeros(b, t)
    mk = torch.ones(b, t, dtype=torch.bool)
    cur = torch.zeros(b, tc)
    cm = torch.ones(b, tc, dtype=torch.bool)
    tail = (cur, cm, torch.ones(b), torch.ones(b, dtype=torch.int32), torch.zeros(b), torch.zeros(b, dtype=torch.int32))
    leaves, x, mask = _ae()
    act = torch.zeros(2, 2, 10, 6 * 32)
    return {
        "masked_stats": lambda: kernels.masked_stats(v, mk),
        "ma_judgment": lambda: kernels.ma_judgment(v, mk, *tail),
        "ma_judgment_bf16_delta": lambda: kernels.ma_judgment_bf16_delta(
            torch.zeros(b), torch.zeros(b, t, dtype=torch.bfloat16), torch.full((b,), t, dtype=torch.int32), *tail
        ),
        "holt_winters_scan": lambda: kernels.holt_winters_scan(
            v, mk, torch.zeros(b), torch.zeros(b, m), torch.zeros(2, 3)
        ),
        "holt_scan": lambda: kernels.holt_scan(v, mk, 0.5, 0.1),
        "lstm_ae_forward": lambda: kernels.lstm_ae_forward(leaves, x, mask),
        "lstm_ae_backward": lambda: kernels.lstm_ae_backward(leaves, x, mask, act, torch.zeros(2, 2, 5)),
    }


@pytest.mark.parametrize("name", sorted(kernels.LAUNCHES))
def test_wrapper_launches_on_its_operands_device(stub, name):
    record, entered = stub
    before = kernels.LAUNCHES[name]
    _calls()[name]()
    launches = [r for r in record if r[0] == "launch" and r[1] == name]
    assert launches, f"{name} never reached its kernel entry point"
    # the operands lie on the CPU here: every launch entered that device
    # and ran on ITS stream, never the current device's ("cuda:0")
    assert entered and set(entered) == {"cpu"}
    assert {r[2] for r in launches} == {"stream:cpu"}
    assert kernels.LAUNCHES[name] - before == len(launches)
    kernels.LAUNCHES[name] = before


def test_operands_on_two_cards_raise():
    """A wrapper refuses operands spread over two cards (stand-ins that
    carry only a device: `_on_cuda` reads nothing else)."""
    from types import SimpleNamespace

    on = [SimpleNamespace(device=torch.device("cuda", i)) for i in (0, 1)]
    with pytest.raises(ValueError, match="several CUDA devices"):
        kernels._on_cuda(*on)
    assert kernels._on_cuda(on[1], on[1]) is True
