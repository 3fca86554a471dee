"""How `correct` is decided: what the timed sweeps wrote for the sampled
documents, held to the configuration's plain reference
(`reference/<name>.py`, named by the configuration's `reference` key).

For every sampled document and every sweep of the window in which it
was open, the reference works out again from the harness's own series
what the worker should have written: the status, code, reason and
anomaly pairs, and per alias the verdict, the flagged points, the band's
last point and the pairwise p and decision. The observed side is what
the store received and what the verdict hook saw. The numbers compared,
each against its limit in the configuration (`checks`):

  * `unmatched`: (document, sweep) pairs that one side has and the other
    lacks (a verdict missing, late into another sweep, or written for a
    document that should have left): exact, limit 0;
  * `status_mismatch`: pairs whose (status, code, reason, anomaly pairs)
    differ: exact, limit 0;
  * `flag_mismatch`: windows whose verdict, flagged points or pairwise
    decision differ: exact, limit 0;
  * `band_gap`: the widest gap of a band edge, over the larger of the
    reference edge and the band's half-width;
  * `p_gap`: the widest gap of the pairwise p.

A window or pair whose outcome rounding may decide (a point within 1e-5
of an edge, a p within 1e-4 of the threshold) is left out of the exact
counts and the gaps, and counted as `near`.
"""

from __future__ import annotations

import numpy as np

from portbench.stores import VERDICT_STATUSES


def observed(store_log, hook_rows, first: int, last: int) -> tuple[dict, int]:
    """The same structure from what the store received and the hook saw,
    and the count of duplicate writes (a document written twice in one
    sweep)."""
    out: dict = {}
    dup = 0
    for sweep, doc_id, status, code, reason, frozen in store_log:
        if not first <= sweep <= last or status not in VERDICT_STATUSES:
            continue
        key = (doc_id, sweep)
        if key in out:
            dup += 1
        values = {alias: list(pairs) for alias, pairs in frozen}
        out[key] = {"status": (status, code, reason, values), "windows": {}}
    for sweep, doc_id, rec in hook_rows:
        if not first <= sweep <= last:
            continue
        entry = out.setdefault((doc_id, sweep), {"status": None, "windows": {}})
        for alias, verdict, pairs, upper, lower, p, differs in rec:
            entry["windows"][alias] = (verdict, tuple(pairs[0::2]), upper, lower, p, differs)
    return out, dup


def compare(exp: dict, obs: dict, dup: int = 0) -> dict:
    """The numbers compared, and the counts beside them."""
    unmatched = dup + sum(1 for k in exp if k not in obs) + sum(1 for k in obs if k not in exp)
    status_mismatch = flag_mismatch = near = checked = 0
    band_gap = p_gap = 0.0
    for key, e in exp.items():
        o = obs.get(key)
        if o is None:
            continue
        if e["near"]:
            near += 1
            continue
        if o["status"] is None or set(o["windows"]) != set(e["windows"]):
            unmatched += 1
            continue
        if o["status"] != e["status"]:
            status_mismatch += 1
        for alias, (v, times, up, lo, p, dif) in e["windows"].items():
            ov, otimes, oup, olo, op, odif = o["windows"][alias]
            checked += 1
            if ov != v or tuple(otimes) != times or odif != dif:
                flag_mismatch += 1
            half = abs(up - lo) / 2.0
            for got, want in ((oup, up), (olo, lo)):
                gap = abs(got - want) / max(abs(want), half, 1e-30)
                band_gap = max(band_gap, gap if np.isfinite(gap) else np.inf)
            p_gap = max(p_gap, abs(op - p) if np.isfinite(op) else np.inf)
    return dict(unmatched=unmatched, status_mismatch=status_mismatch, flag_mismatch=flag_mismatch,
                band_gap=band_gap, p_gap=p_gap, windows_checked=checked, near=near, pairs=len(exp))


COMPARED = ("unmatched", "status_mismatch", "flag_mismatch", "band_gap", "p_gap")


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) for the compared numbers: a
    number passes when it is finite and at most its limit, and the check
    needs a window to look at."""
    shown = {k: {"value": numbers[k], "limit": limits[k]} for k in COMPARED}
    ok = numbers["windows_checked"] > 0 and all(
        np.isfinite(numbers[k]) and numbers[k] <= limits[k] for k in COMPARED
    )
    return bool(ok), shown


def control_observed(exp_control: dict) -> dict:
    """The control's outputs in the observed form."""
    return {k: {"status": v["status"], "windows": v["windows"]} for k, v in exp_control.items()}
