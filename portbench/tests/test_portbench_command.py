"""The command end to end at a tiny size on the CPU: the result line,
the exits without a card or without the program."""

import json
import os
import shutil

import pytest

from conftest import BENCH, ROOT, rehearse, run_cmd

CELLS = [w["name"] for w in json.load(open(os.path.join(ROOT, "BENCHMARK.json")))["workloads"]]
LINE_KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_end_to_end_on_cpu(workload, trace):
    rc, res, err = rehearse(workload, seed=2**31 + 11, trace=trace)
    assert rc == 0, err[-3000:]
    # the contract's keys, `breakdown` only with a device trace, and the
    # compared numbers last
    assert [k for k in res if k != "breakdown"] == LINE_KEYS
    assert "breakdown" not in res  # a CPU run has no device trace
    assert res["correct"] is True, res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    group = spec["per_layer"] if trace else spec["end_to_end"]
    allowed = {m["name"] for m in group if "workloads" not in m or workload in m["workloads"]}
    assert set(res["metrics"]) <= allowed
    if not trace:
        assert set(res["metrics"]) == allowed  # every end-to-end metric is a host-clock reading
    for name, m in res["metrics"].items():
        assert m["value"] > 0 or name == "device_idle", (name, m)
    # the compared numbers close standard error, each beside its limit
    tail = err.strip().splitlines()[-len(res["checks"]):]
    assert [t.split()[1] for t in tail] == list(res["checks"])
    assert all(" limit " in t for t in tail)


def test_same_seed_same_inputs():
    import numpy as np
    import torch

    from portbench import fleet, spec

    cell = spec.cell(ROOT, "ma.rollout")
    shape = fleet.FleetShape.from_config(cell.config, 8)
    a = fleet.make_pools(shape, 2**31 + 5, torch.device("cpu"))
    b = fleet.make_pools(shape, 2**31 + 5, torch.device("cpu"))
    c = fleet.make_pools(shape, 2**31 + 6, torch.device("cpu"))
    for p in (a, b, c):
        p.ensure(shape.current_points + 4)
    assert np.array_equal(a.hist, b.hist) and np.array_equal(a.cont, b.cont)
    assert not np.array_equal(a.hist, c.hist)
    # the series do not depend on how far, or in how many steps, a run grew them
    b.ensure(3 * fleet.CONT_BLOCK + 1)
    d = fleet.make_pools(shape, 2**31 + 5, torch.device("cpu"))
    d.ensure(3 * fleet.CONT_BLOCK + 1)
    w = a.cont.shape[1]
    assert np.array_equal(b.cont, d.cont) and np.array_equal(b.base, d.base)
    assert np.array_equal(a.cont, b.cont[:, :w]) and np.array_equal(a.base, b.base[:, :w])


def test_every_seed_gets_the_same_counts():
    from portbench import fleet, spec

    cell = spec.cell(ROOT, "ma.rollout")
    shape = fleet.FleetShape.from_config(cell.config, 100)
    traffic = fleet.Traffic.from_dict(cell.traffic)
    counts = []
    for seed in (1, 2**31 + 3, 77):
        s = fleet.Schedule(shape, traffic, seed)
        s.newcomers(25)
        counts.append([(len(s.by_sweep[k]), sum(d.spiked for d in s.by_sweep[k])) for k in range(26)])
    assert counts[0] == counts[1] == counts[2]
    assert counts[0][1][0] == 0 and counts[0][2][0] == 10  # the sweep-1 leavers come back at sweep 2


def test_no_card_exits_without_a_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    rc, out, err = run_cmd(["--workload", CELLS[0], "--seed", "3", "--seconds", "1", "--trace", "0"])
    assert rc != 0 and not out and "no CUDA" in err


def test_benchmark_files_alone_exit_without_a_result(tmp_path):
    """A directory with only BENCHMARK.json and the harness: the program is
    missing, so the run fails and prints nothing."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    rc, out, err = run_cmd(["--workload", CELLS[0], "--seed", "3", "--seconds", "1", "--trace", "0",
                            "--device", "cpu", "--services", "8"], cwd=str(tmp_path))
    assert rc != 0 and not out
    assert "foremast_tpu_torch" in err


def test_traced_run_on_the_card_reads_the_device(card):
    rc, out, err = run_cmd(["--workload", CELLS[0], "--seed", str(2**31 + 17), "--seconds", "3",
                            "--trace", "1"])
    assert rc == 0, err[-3000:]
    res = json.loads(out[-1])
    assert res["correct"] is True
    assert res["device"]["platform"] == "gpu" and res["device"]["busy_s"] > 0
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
    assert "breakdown" in res and len(res["breakdown"]["device_ops"]) <= 10
