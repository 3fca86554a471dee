"""Deficit-weighted round-robin.

The scheduling half of the QoS plane: given per-tenant backlogs, emit
the order in which queued work should be served so that over any
window each backlogged tenant receives service proportional to its
weight. Used by the sweep pool's slice ordering (``_SweepPool.take``)
and the dirty-set drain (``DirtySet.take``) — the two seams where a
whale tenant's backlog could otherwise starve a quiet tenant, because
both drain strictly FIFO today.

Classic DRR with unit-cost items: each round every backlogged tenant
earns its weight in credits and is served while its deficit covers the
next item. Deficits persist across calls (a tenant that got less than
its share this slice catches up on the next), but a tenant with no
backlog banks nothing — idle credit must not turn into a burst that
starves everyone else later.

The picker is deterministic (tenants rotate in sorted-name order) and
carries NO locks: each consumer calls it under its own lock.
"""

from __future__ import annotations

from typing import Mapping


class DeficitRoundRobin:
    def __init__(
        self, weights: Mapping[str, float], default_weight: float = 1.0
    ):
        self._weights = dict(weights)
        self._default = max(float(default_weight), 1e-9)
        self._deficit: dict[str, float] = {}

    def weight(self, tenant: str) -> float:
        w = self._weights.get(tenant, self._default)
        return w if w > 0 else self._default

    def pick(self, queued: Mapping[str, int], n: int) -> list[str]:
        """A tenant name per service slot: serve up to ``n`` items from
        the given per-tenant backlog counts, weight-proportionally.
        The result's length is ``min(n, sum(queued))``; consumers pop
        their per-tenant FIFOs in this order."""
        remaining = {t: int(c) for t, c in queued.items() if c > 0}
        # empty tenants bank no credit; drop their stale deficits so
        # the dict stays bounded by the active-tenant set
        for t in list(self._deficit):
            if t not in remaining:
                del self._deficit[t]
        out: list[str] = []
        if n <= 0 or not remaining:
            return out
        rotation = sorted(remaining)
        # weights are normalized so the lightest backlogged tenant
        # earns ~1 credit per round: every round serves at least one
        # item and heavy tenants get proportionally more
        min_w = min(self.weight(t) for t in rotation)
        while len(out) < n and remaining:
            for t in rotation:
                if t not in remaining:
                    continue
                self._deficit[t] = self._deficit.get(t, 0.0) + (
                    self.weight(t) / min_w
                )
                while (
                    self._deficit.get(t, 0.0) >= 1.0
                    and t in remaining
                    and len(out) < n
                ):
                    self._deficit[t] -= 1.0
                    remaining[t] -= 1
                    if remaining[t] <= 0:
                        del remaining[t]
                        # served dry: surplus credit is forfeited, not
                        # banked (see module docstring)
                        self._deficit.pop(t, None)
                    out.append(t)
                if len(out) >= n:
                    break
        return out
