"""BENCHMARK.json against the contract's rules, and a configuration,
mix and metric added as new files found by name."""

import json
import os
import shutil

from conftest import BENCH, ROOT, rehearse
from portbench import spec

SPEC = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))


def test_names_and_units_keep_the_allowed_characters():
    assert spec.check_names(SPEC) == []
    assert spec.check_names({"end_to_end": [{"name": "bad name", "unit": "tokens per second",
                                             "better": "up"}]}) == [
        "metric name 'bad name'", "bad name: unit 'tokens per second'", "bad name: better 'up'"]


def test_entries_have_the_contract_keys_and_bounds():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "portbench/run.py"] and SPEC["paths"] == ["portbench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    configs = {c["name"] for c in SPEC["configs"]}
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and os.path.exists(os.path.join(ROOT, c["file"]))
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] == 1 and len(w["why"]) <= 200
        assert os.path.exists(os.path.join(BENCH, "traffic", f"{w['traffic']}.json"))
    assert {c["name"] for c in SPEC["configs"]} == {w["config"] for w in SPEC["workloads"]}
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert set(m.get("workloads", cells)) <= cells
        spec.metric_reader(m["name"])  # each has its reader file
    for cell in cells:  # every cell reports setup_s, another end-to-end metric and a per-layer one
        assert any(m["name"] != "setup_s" and cell in m.get("workloads", cells) for m in SPEC["end_to_end"])
        assert any(cell in m.get("workloads", cells) for m in SPEC["per_layer"])


def test_a_new_config_mix_and_metric_are_found_by_name(tmp_path):
    """Files added in a copy (a configuration with its own reference, a
    mix, a metric reader), and entries naming them: no existing file of
    the harness is edited."""
    shutil.copytree(BENCH, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    new = json.loads(json.dumps(SPEC))
    cfg = json.load(open(os.path.join(BENCH, "configs", "ma_fleet.json")))
    cfg["name"] = "ma_small"
    cfg["fleet"]["canary_every"] = 4
    cfg["reference"] = "ma_judge_copy"
    (tmp_path / "portbench" / "configs" / "ma_small.json").write_text(json.dumps(cfg))
    shutil.copy(os.path.join(BENCH, "reference", "ma_judge.py"),
                tmp_path / "portbench" / "reference" / "ma_judge_copy.py")
    mix = json.load(open(os.path.join(BENCH, "traffic", "rollout.json")))
    mix.update(name="fast_churn", churn=0.5)
    (tmp_path / "portbench" / "traffic" / "fast_churn.json").write_text(json.dumps(mix))
    (tmp_path / "portbench" / "metrics" / "sweeps_read.py").write_text(
        "def read(ctx):\n    return float(ctx.sweeps) if ctx.sweeps else None\n")
    new["configs"].append(dict(SPEC["configs"][0], name="ma_small", file="portbench/configs/ma_small.json"))
    new["workloads"].append({"name": "small.churn", "config": "ma_small", "traffic": "fast_churn", "chips": 1,
                             "why": "a test cell"})
    new["per_layer"].append({"name": "sweeps_read", "unit": "sweeps", "better": "higher",
                             "source": "program_span", "layer": "worker host path", "moves": "windows_per_s",
                             "workloads": ["small.churn"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(new))
    rc, res, err = rehearse("small.churn", seed=5, trace=1, cwd=str(tmp_path), env={"PYTHONPATH": ROOT})
    assert rc == 0, err[-3000:]
    assert res["correct"] is True and res["metrics"]["sweeps_read"]["value"] >= 1
    assert "unspanned_share" in res["metrics"]
