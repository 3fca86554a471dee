"""What a run measures, found by name from `BENCHMARK.json`.

Every part of a cell lives in a file of its own under `portbench/`:

  * a configuration: `configs/<config>.json` (the deployment: the
    worker's environment, the fleet's shape, the series' scales);
  * a traffic mix: `traffic/<traffic>.json` (the parameters that the one
    generator in `fleet.py` reads);
  * a per-layer metric: `metrics/<name>.py`, a reader with
    `read(ctx) -> float | None`;
  * a configuration's plain reference: `reference/<reference>.py`, named
    by the configuration's `reference` key, with `expected(...)` and the
    precision names `CONFIG` and `CONTROL`.

A later cell, configuration or metric is a new file and a new entry in
`BENCHMARK.json`; no file here changes for it.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import re

HERE = os.path.dirname(os.path.abspath(__file__))

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


class SpecError(ValueError):
    """BENCHMARK.json or a file it names is missing or malformed."""


@dataclasses.dataclass(frozen=True)
class Cell:
    """One workload of BENCHMARK.json with everything it names loaded."""

    name: str
    config_name: str
    traffic_name: str
    config: dict
    traffic: dict
    end_to_end: tuple  # the metric entries this cell reports with --trace 0
    per_layer: tuple  # ... and with --trace 1
    run_seconds: int


def load_json(path: str) -> dict:
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError as e:
        raise SpecError(f"missing file {path}") from e
    except json.JSONDecodeError as e:
        raise SpecError(f"{path} is not JSON: {e}") from e


def benchmark(root: str) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def _reports(metric: dict, cell: str) -> bool:
    """A metric with a `workloads` key is reported in those cells only;
    without one, in every cell."""
    return "workloads" not in metric or cell in metric["workloads"]


def cell(root: str, name: str, bench_dir: str | None = None) -> Cell:
    """The workload `name` of `root`/BENCHMARK.json, its configuration
    and traffic read from `bench_dir` (default: this package's folder)."""
    bench_dir = bench_dir or HERE
    spec = benchmark(root)
    by_name = {w["name"]: w for w in spec.get("workloads", [])}
    if name not in by_name:
        raise SpecError(f"no workload {name!r} in BENCHMARK.json (have {sorted(by_name)})")
    w = by_name[name]
    config = load_json(os.path.join(bench_dir, "configs", f"{w['config']}.json"))
    traffic = load_json(os.path.join(bench_dir, "traffic", f"{w['traffic']}.json"))
    return Cell(
        name=name,
        config_name=w["config"],
        traffic_name=w["traffic"],
        config=config,
        traffic=traffic,
        end_to_end=tuple(m for m in spec["end_to_end"] if _reports(m, name)),
        per_layer=tuple(m for m in spec["per_layer"] if _reports(m, name)),
        run_seconds=int(spec["run_seconds"]),
    )


def _module(kind: str, name: str, bench_dir: str | None = None):
    if not NAME_RE.match(name):
        raise SpecError(f"bad {kind} name {name!r}")
    path = os.path.join(bench_dir or HERE, kind, f"{name}.py")
    if not os.path.exists(path):
        raise SpecError(f"no {kind} file {path}")
    mod_spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, bench_dir: str | None = None):
    """`read(ctx)` of `metrics/<name>.py`."""
    return _module("metrics", name, bench_dir).read


def reference(name: str, bench_dir: str | None = None):
    """The module `reference/<name>.py`."""
    return _module("reference", name, bench_dir)


def check_names(spec: dict) -> list[str]:
    """The contract's character rules on names and units; returns the
    faults found (empty when the file keeps them)."""
    faults = []
    for entry in spec.get("configs", []) + spec.get("workloads", []):
        if not NAME_RE.match(entry.get("name", "")):
            faults.append(f"name {entry.get('name')!r}")
    for w in spec.get("workloads", []):
        for key in ("config", "traffic"):
            if not NAME_RE.match(w.get(key, "")):
                faults.append(f"{w.get('name')}: {key} {w.get(key)!r}")
    for c in spec.get("configs", []):
        for key in c.get("reduced", []):
            if not NAME_RE.match(key):
                faults.append(f"{c.get('name')}: reduced key {key!r}")
    for m in spec.get("end_to_end", []) + spec.get("per_layer", []):
        if not NAME_RE.match(m.get("name", "")):
            faults.append(f"metric name {m.get('name')!r}")
        if not UNIT_RE.match(m.get("unit", "")):
            faults.append(f"{m.get('name')}: unit {m.get('unit')!r}")
        if m.get("better") not in ("lower", "higher"):
            faults.append(f"{m.get('name')}: better {m.get('better')!r}")
    return faults
