"""The plain reference against SciPy's published tests, its control,
and the check failing a run whose timed path is broken underneath."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from conftest import ROOT, TINY
from portbench.reference import ma_judge

PW = dict(p_threshold=0.05, min_mw=20, min_wx=20, min_kw=5, min_fr=20)


def test_rank_tests_equal_scipy():
    stats = pytest.importorskip("scipy.stats")
    rng = np.random.default_rng(3)
    x = np.round(rng.normal(0, 1, (40, 30)) * 4) / 4  # ties, as rounding makes them
    y = np.round(rng.normal(0.3, 1, (40, 30)) * 4) / 4
    x[0] = y[0]  # every difference zero but none: the Wilcoxon gate
    x[0, 0] += 1.0
    oks = []
    for i in range(1, 40):
        mw = stats.mannwhitneyu(x[i], y[i], alternative="two-sided", method="asymptotic", use_continuity=True)
        kw = stats.kruskal(x[i], y[i])
        wx = stats.wilcoxon(x[i], y[i], zero_method="wilcox", correction=False, method="approx")
        ps = [mw.pvalue, wx.pvalue, kw.pvalue]
        p, differs, _ = ma_judge.pairwise_all(x[i : i + 1], y[i : i + 1], **PW)
        # p is the largest of the gated-in tests (Friedman's too)
        assert p[0] >= max(ps) - 1e-12
        oks.append(np.isclose(p[0], max(ps), atol=1e-12) or p[0] > max(ps))
    assert all(oks)


def test_friedman_two_groups_is_the_sign_statistic():
    x = np.arange(30, dtype=float)[None, :]
    y = x.copy()
    y[0, :20] += 1  # 20 below, 10 ties
    # C = 1 - 10/30; stat = (2/30 (35^2 + 55^2) - 270) / C
    k, n_minus, ties = 30, 20, 10
    ra, rb = 2 * 0 + n_minus + 1.5 * ties, 2 * n_minus + 0 + 1.5 * ties
    want = (2 / k * (ra**2 + rb**2) - 9 * k) / (1 - ties / k)
    from math import erfc, sqrt

    p, _, _ = ma_judge.pairwise_all(x, y, p_threshold=0.05, min_mw=999, min_wx=999, min_kw=999, min_fr=20)
    assert np.isclose(p[0], erfc(sqrt(want / 2)), rtol=1e-12)


def test_band_and_flags():
    hist = np.tile(np.float32([1.0, 3.0]), (2, 50))  # mean 2, sd 1, exact in bfloat16
    mean, sd, n = ma_judge.fit(hist)
    assert np.allclose(mean, 2.0) and np.allclose(sd, 1.0) and (n == 100).all()
    cur = np.array([[2.0, 4.1, 2.0], [2.0, -0.5, 2.0]])
    res = ma_judge.judge(mean, sd, n, cur, np.full((2, 3), np.nan), [2.0, 2.0], [1, 3], [0.0, 0.0], PW, 10)
    # row 0 flags above its upper edge only; row 1 both ways, below its
    # lower edge floored at 0
    assert res["verdict"].tolist() == [1, 1]
    assert res["flags"].tolist() == [[False, True, False], [False, True, False]]
    assert np.isclose(res["upper"][0], 4.0) and res["lower"][1] == 0.0
    res = ma_judge.judge(mean, sd, n, cur[:, [0, 2]], np.full((2, 2), np.nan), [2.0, 2.0], [1, 3], [0.0, 0.0],
                         PW, 10)
    assert res["verdict"].tolist() == [0, 0] and res["p"].tolist() == [1.0, 1.0]


def test_control_fails_the_check_at_a_test_size():
    """The reference one step lower (float8 deltas, bfloat16 windows and
    edges) in the program's place: the check must call it wrong."""
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "portbench", "run.py"), "--workload", "ma.recheck", "--seed",
         str(2**31 + 9), "--device", "cpu", "--services", "64", "--control-sweeps", "6"],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is False, res["checks"]
    num, lim = res["control"], {k: c["limit"] for k, c in res["checks"].items()}
    assert num["band_gap"] > 10 * lim["band_gap"] and num["p_gap"] > 10 * lim["p_gap"]


FAULTS = {
    # the fit returns its starting state: the level stays at the anchor
    "state unchanged": """
from foremast_tpu_torch.engine import scoring
fit = scoring.fit_ma_from_bf16_delta
def broken(anchor, delta, lens):
    mean, sd, n = fit(anchor, delta, lens)
    return anchor.clone(), sd, n
scoring.fit_ma_from_bf16_delta = broken
""",
    # half of each history left out, the moments taken over the rest
    "half the batch left out": """
from foremast_tpu_torch.engine import scoring
fit = scoring.fit_ma_from_bf16_delta
def broken(anchor, delta, lens):
    half = (lens // 2).to(lens.dtype)
    keep = delta.clone()
    import torch
    keep[torch.arange(keep.shape[1], device=keep.device)[None, :] >= half[:, None]] = 0
    return fit(anchor, keep, half)
scoring.fit_ma_from_bf16_delta = broken
""",
    # half of each claim never judged
    "half the claim left out": """
from foremast_tpu_torch.jobs import worker
claim = worker.BrainWorker._claim_cycle
def broken(self, led, micro):
    docs = claim(self, led, micro)
    return docs[: len(docs) // 2]
worker.BrainWorker._claim_cycle = broken
""",
    # an answer altered where it is produced: one flag flipped a batch
    "an answer altered": """
from foremast_tpu_torch.engine import scoring
detect = scoring.detect_anomalies
def broken(*a, **kw):
    flags = detect(*a, **kw).clone()
    flags[0, 0] = ~flags[0, 0]
    return flags
scoring.detect_anomalies = broken
""",
}
DRIVER = """
import sys
sys.path.insert(0, {root!r})
{patch}
from portbench import cli
sys.exit(cli.main({argv!r}, {root!r}, 0.0))
"""


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", ["ma.recheck", "ma.rollout"])
def test_a_broken_timed_path_is_not_correct(fault, workload):
    """The exchange between chips, the fourth fault, has no place here:
    every cell runs on one card."""
    argv = ["--workload", workload, "--seed", str(2**31 + 21), "--seconds", "1", "--trace", "0",
            "--device", "cpu", "--services", str(TINY)]
    code = DRIVER.format(root=ROOT, patch=FAULTS[fault], argv=argv)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is False, res["checks"]
