"""The port's recording- and alert-rule generator
(`foremast_tpu_torch/metrics/rules.py`) and the CLI's `rules` against the
JAX package's.

Every case of `tests/test_rules.py` has a counterpart here that asks the
same of both packages and holds the port's answer equal to JAX's; the
manifest's YAML and `python -m foremast_tpu_torch rules`' stdout are
byte-equal to JAX's for the default namespace and for others."""

from __future__ import annotations

import io
import os
import subprocess
import sys
from contextlib import redirect_stdout

import pytest
import yaml

import foremast_tpu.metrics.rules as J
import foremast_tpu_torch.metrics.rules as P

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_every_metric_recorded_at_all_three_levels():
    assert P.ALL_METRICS == J.ALL_METRICS and P.REQUEST_CLASSES == J.REQUEST_CLASSES
    names = {r.record for r in P.all_rules()}
    assert names == {r.record for r in J.all_rules()}
    for metric in P.ALL_METRICS:
        for level in ("namespace_pod", "namespace_app", "namespace_app_per_pod"):
            assert f"{level}:{metric}" in names


def test_per_pod_is_quotient_of_app_and_pod_count():
    for record in ("namespace_app_per_pod:http_server_requests_latency", "namespace_app:pod_count"):
        assert P.rule_expr(record) == J.rule_expr(record) is not None
    assert P.rule_expr("namespace_app_per_pod:http_server_requests_latency") == (
        "namespace_app:http_server_requests_latency / namespace_app:pod_count")


def test_status_class_selectors():
    for record in ("namespace_pod:http_server_requests_error_5xx", "namespace_pod:http_server_requests_errors",
                   "namespace_pod:http_server_requests_count", "namespace_app:http_server_requests_latency"):
        assert P.rule_expr(record) == J.rule_expr(record)
    assert 'status=~"5[0-9]+"' in P.rule_expr("namespace_pod:http_server_requests_error_5xx")
    assert "status" not in P.rule_expr("namespace_pod:http_server_requests_count")


def test_resource_rules_join_app_label():
    for record in ("namespace_app:cpu_usage_seconds_total", "namespace_pod:memory_usage_bytes",
                   "namespace_pod:cpu_usage_seconds_total", "namespace_app:memory_usage_bytes"):
        assert P.rule_expr(record) == J.rule_expr(record)
    assert "group_left(app)" in P.rule_expr("namespace_app:cpu_usage_seconds_total")


def test_no_duplicate_records():
    for part in ("core_rules", "request_rules", "brain_rules", "all_rules"):
        got = [r.to_dict() for r in getattr(P, part)()]
        assert got == [r.to_dict() for r in getattr(J, part)()], part
    records = [r.record for r in P.all_rules()]
    assert len(records) == len(set(records))


def test_manifest_yaml_roundtrip():
    text = P.to_yaml()
    assert text == J.to_yaml()
    parsed = yaml.safe_load(text)
    assert parsed == P.prometheus_rule_manifest() == J.prometheus_rule_manifest()


def test_alert_rules_cover_every_metric_and_engine_liveness():
    assert P.alert_rules() == J.alert_rules()
    assert len(P.alert_rules()) == 2 * len(P.ALL_METRICS) + 1


def test_brain_rules_pin_colon_spelling_for_every_published_metric():
    """The colon spellings are JAX's, and each rule's expression is a
    family the port's `BrainGauges` exports."""
    from prometheus_client import CollectorRegistry

    from foremast_tpu_torch.observe.gauges import BrainGauges

    assert P.BRAIN_GAUGE_SUFFIXES == J.BRAIN_GAUGE_SUFFIXES
    assert [r.to_dict() for r in P.brain_rules()] == [r.to_dict() for r in J.brain_rules()]
    reg = CollectorRegistry()
    g = BrainGauges(registry=reg)
    for metric in P.ALL_METRICS:
        g.publish(P.brain_gauge_series(metric), "ns", "app", upper=1.0, lower=0.0, anomaly_value=2.0)
    exported = {m.name for m in reg.collect()}
    for r in P.brain_rules():
        assert r.expr in exported


def test_unknown_record_resolves_none():
    for record in ("namespace_pod:nope", "", "foremastbrain:nope_upper"):
        assert P.rule_expr(record) is None and J.rule_expr(record) is None


def test_every_record_resolves_as_jax():
    for r in J.all_rules():
        assert P.rule_expr(r.record) == J.rule_expr(r.record) == r.expr


@pytest.mark.parametrize("kw", [{}, {"namespace": "observability"}, {"name": "x", "namespace": "a-b"}])
def test_manifest_and_yaml_are_byte_equal(kw):
    assert P.prometheus_rule_manifest(**kw) == J.prometheus_rule_manifest(**kw)
    assert P.to_yaml(P.prometheus_rule_manifest(**kw)) == J.to_yaml(J.prometheus_rule_manifest(**kw))


@pytest.mark.parametrize("doc", [
    {"a": "x", "b": [1, 2.5, True, None, "s"], "c": {}, "d": [], "e": [{"f": {"g": "h\"i"}}, {"j": [{"k": 1}]}]},
    {"unicode": "tö", "nested": [[1, 2], "x"], "empty": ""},
])
def test_yaml_emitter_matches_on_other_documents(doc):
    assert P.to_yaml(doc) == J.to_yaml(doc)


@pytest.mark.parametrize("args", [[], ["--namespace", "observability"]])
def test_cli_rules_stdout_is_byte_equal(args):
    """`python -m foremast_tpu_torch rules` as a process, and `main` in
    this one, print JAX's `rules` output byte for byte."""
    from foremast_tpu.cli import main as jax_main
    from foremast_tpu_torch.cli import main as port_main

    outs = []
    for fn in (jax_main, port_main):
        buf = io.StringIO()
        with redirect_stdout(buf):
            assert fn(["rules", *args]) == 0
        outs.append(buf.getvalue())
    proc = subprocess.run([sys.executable, "-m", "foremast_tpu_torch", "rules", *args], cwd=ROOT,
                          capture_output=True, timeout=120)
    assert proc.returncode == 0, proc.stderr.decode()
    assert proc.stdout.decode() == outs[1] == outs[0]
    assert yaml.safe_load(outs[1])["metadata"]["namespace"] == (args[1] if args else "monitoring")


def test_rules_prints_manifest(capsys):
    """tests/test_cli.py's `rules` case on the port's CLI, and the same
    output as JAX's."""
    from foremast_tpu.cli import main as jax_main
    from foremast_tpu_torch.cli import main as port_main

    assert port_main(["rules", "--namespace", "observ"]) == 0
    out = capsys.readouterr().out
    parsed = yaml.safe_load(out)
    assert parsed["kind"] == "PrometheusRule" and parsed["metadata"]["namespace"] == "observ"
    assert jax_main(["rules", "--namespace", "observ"]) == 0
    assert capsys.readouterr().out == out
