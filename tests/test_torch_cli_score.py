"""`score` through both CLIs: the JAX package's `foremast_tpu.cli` and the
port's `foremast_tpu_torch.cli` (`--device cpu`, every kernel's plain
version) on the score cases of `tests/test_cli.py`.

Each case runs the same request and replay traces through both and
compares the printed JSON response and the exit code. The tolerance is
none: statuses, reasons and the anomaly's flat [t, v, ...] pairs are
equal as JSON (the flagged values are the traces' own points, so they
carry no arithmetic of either package)."""

from __future__ import annotations

import io
import json
import os

import pytest

from foremast_tpu.cli import main as jax_main
from foremast_tpu_torch.cli import main as port_main

DATA = os.path.join(os.path.dirname(__file__), "data")
NORMAL = os.path.join(DATA, "demo_canary_normal.csv")
SPIKE = os.path.join(DATA, "demo_canary_spike.csv")


def make_request(tmp_path, aliases=("error4xx",)):
    def mq(query):
        return {
            "dataSourceType": "prometheus",
            "parameters": {
                "endpoint": "http://prometheus:9090/api/v1/",
                "query": query,
                "start": "1600000000",
                "end": "1600000600",
                "step": "60",
            },
        }

    req = {
        "appName": "demo-app",
        "startTime": "2020-09-13T12:26:40Z",
        "endTime": "2020-09-13T12:36:40Z",
        "strategy": "canary",
        "metrics": {
            "current": {a: mq(f"cur:{a}") for a in aliases},
            "baseline": {a: mq(f"base:{a}") for a in aliases},
            "historical": {a: mq(f"hist:{a}") for a in aliases},
        },
    }
    path = tmp_path / "request.json"
    path.write_text(json.dumps(req))
    return str(path)


def _argv(request_path, current, baseline, historical):
    argv = ["score", "--request", request_path]
    for flag, traces in (("--current", current), ("--baseline", baseline), ("--historical", historical)):
        for alias, path in traces.items():
            argv += [flag, f"{alias}={path}"]
    return argv


def both(capsys, argv, stdin: str | None = None, monkeypatch=None):
    """(rc, response) of the JAX CLI and of the port's, on `argv`."""
    out = []
    for main, extra in ((jax_main, []), (port_main, ["--device", "cpu"])):
        if stdin is not None:
            monkeypatch.setattr("sys.stdin", io.StringIO(stdin))
        rc = main(argv + extra)
        out.append((rc, json.loads(capsys.readouterr().out)))
    return out


def test_score_spike_trace_is_anomaly(tmp_path, capsys):
    req = make_request(tmp_path)
    (rc_j, jax), (rc_p, port) = both(capsys, _argv(req, {"error4xx": SPIKE}, {"error4xx": NORMAL},
                                                   {"error4xx": NORMAL}))
    assert rc_p == rc_j == 0
    assert port == jax
    assert port["status"] == "anomaly"
    pairs = port["anomalyInfo"]["values"]["error4xx"]
    assert len(pairs) % 2 == 0 and any(v > 30 for v in pairs[1::2])


def test_score_normal_trace_is_healthy(tmp_path, capsys):
    req = make_request(tmp_path)
    (rc_j, jax), (rc_p, port) = both(capsys, _argv(req, {"error4xx": NORMAL}, {"error4xx": NORMAL},
                                                   {"error4xx": NORMAL}))
    assert rc_p == rc_j == 0
    assert port == jax and port["status"] == "success"


def test_score_without_traces_fails_like_jax(tmp_path, capsys):
    """No trace for any window: nothing is judged, and both exit 1 with the
    same document."""
    req = make_request(tmp_path)
    (rc_j, jax), (rc_p, port) = both(capsys, ["score", "--request", req])
    assert rc_p == rc_j == 1
    assert port == jax


def test_score_unknown_alias_rejected(tmp_path, capsys):
    req = make_request(tmp_path)
    messages = []
    for main, extra in ((jax_main, []), (port_main, ["--device", "cpu"])):
        with pytest.raises(SystemExit) as ei:
            main(["score", "--request", req, "--current", f"nope={NORMAL}"] + extra)
        messages.append(str(ei.value.code))
    assert messages[0] == messages[1] and "nope" in messages[1]


def test_score_reads_stdin(tmp_path, capsys, monkeypatch):
    req_path = make_request(tmp_path)
    argv = _argv("-", {"error4xx": NORMAL}, {"error4xx": NORMAL}, {"error4xx": NORMAL})
    (rc_j, jax), (rc_p, port) = both(capsys, argv, stdin=open(req_path).read(), monkeypatch=monkeypatch)
    assert rc_p == rc_j == 0
    assert port == jax and port["status"] == "success"


def test_score_honors_env_config(tmp_path, capsys, monkeypatch):
    """Both build their worker from BrainConfig.from_env(): a near-zero
    threshold flips even the normal trace to anomaly in both."""
    monkeypatch.setenv("metric_type_threshold_count", "1")
    monkeypatch.setenv("metric_type0", "error4xx")
    monkeypatch.setenv("threshold0", "0.0001")
    req = make_request(tmp_path)
    (rc_j, jax), (rc_p, port) = both(capsys, _argv(req, {"error4xx": NORMAL}, {"error4xx": NORMAL},
                                                   {"error4xx": NORMAL}))
    assert rc_p == rc_j
    assert port == jax and port["status"] == "anomaly"


def test_score_refuses_a_missing_card(tmp_path, capsys):
    """`--device cuda` (the default) judges on the card and raises where
    there is none; it never falls back to the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    req = make_request(tmp_path)
    with pytest.raises(RuntimeError):
        port_main(_argv(req, {"error4xx": NORMAL}, {"error4xx": NORMAL}, {"error4xx": NORMAL}))
