"""Provisional-fit bookkeeping for short-history admission.

The port's copy of the JAX package's `foremast_tpu/jobs/refine.py`.

A newcomer admitted on 1-2 days of ring coverage (`RingSource.
hist_columns` status "partial") carries a PROVISIONAL fit: verdict-
capable now, but fitted on less history than the document requested.
This module is the worker's ledger of those fits and the pacing logic
that upgrades them in the background:

  * `RefineBook.note_*` records a provisional fit the moment the
    worker's fetch path admits one (fetch-pool threads, so the book is
    lock-guarded);
  * on idle and all-warm ticks the worker drains up to
    `FOREMAST_REFINE_DOCS_PER_TICK` records through `take()` (round-
    robin, so no record starves) and INVALIDATES the ones whose ring
    coverage grew enough. The next claim refits them from the ring
    through the production slow path, which is what makes band parity
    hold: a refined fit IS a from-scratch fit on the larger window, same
    code path, same columns;
  * growth is paced geometrically (`GROWTH_FACTOR`): each refit needs
    ~50% more points than the last, so a fit refines O(log) times on its
    way from the admission floor to the full 7-day window, not once per
    tick;
  * a record FINALIZES (one last refit, then dropped) when the ring
    covers the full requested window or the window's end: past the
    window head nothing new can arrive inside it, so that refit is the
    terminal, from-scratch-identical one.

The book is bounded: past `cap` the oldest record is dropped (its fit
stays at whatever refinement it last reached: degraded pacing, never a
wrong verdict).
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict

from foremast_tpu_torch.models.cache import is_pad_fit_key

# each refit must see ~this factor more points than the previous fit:
# geometric pacing bounds a fit's lifetime refits to O(log(full/floor))
GROWTH_FACTOR = 1.5

DEFAULT_CAP = 16_384

DEFAULT_REFINE_DOCS_PER_TICK = 256


def refine_docs_per_tick_from_env() -> int:
    """THE resolution of FOREMAST_REFINE_DOCS_PER_TICK (empty string
    means unset): one definition so the worker's budget and the CLI's
    startup log can never report different values."""
    return int(os.environ.get("FOREMAST_REFINE_DOCS_PER_TICK", "") or DEFAULT_REFINE_DOCS_PER_TICK)


class RefineBook:
    """Thread-safe ledger of provisional fits awaiting refinement.

    Records are keyed ("uni", fit_cache_fullkey) for univariate fits and
    ("joint", doc_id) for joint docs (whose cache keys the worker
    resolves through its admission cache at invalidation time). Each
    record carries the historical URLs to probe and the point count the
    current fit was made from.
    """

    def __init__(self, cap: int = DEFAULT_CAP):
        self.cap = int(cap)
        self._lock = threading.Lock()
        self._recs: OrderedDict[tuple, dict] = OrderedDict()
        self._counts = {"noted": 0, "refit": 0, "finalized": 0, "settled": 0, "dropped": 0}
        # optional write-through hook (FitJournal.append, duck-typed like
        # ModelCache.journal): the fit journals restore a provisional FIT
        # warm, so the restored doc takes the fast path and nothing would
        # ever re-note it; without persistence the fit stays parked at its
        # admitted short history. Called OUTSIDE self._lock (per-key
        # records, last write wins)
        self.journal = None

    # -- write side (fetch-pool threads) ---------------------------------

    def _note(self, bkey: tuple, rec: dict) -> None:
        # a batch-padding fit key must never become a provisional record:
        # refinement would chase a document that does not exist
        if is_pad_fit_key(bkey):
            return
        puts: list = []
        dels: list = []
        with self._lock:
            prev = self._recs.get(bkey)
            if prev is None:
                self._counts["noted"] += 1
                self._recs[bkey] = rec
                puts.append((bkey, dict(rec)))
            else:
                # re-noted after a refit: update the fitted point count
                # (pacing baseline), keep the round-robin position
                prev["points"] = rec["points"]
                prev["urls"] = rec["urls"]
                puts.append((bkey, dict(prev)))
            while len(self._recs) > self.cap:
                k, _ = self._recs.popitem(last=False)
                self._counts["dropped"] += 1
                dels.append((k, None))
        j = self.journal
        if j is not None:
            j(puts)
            if dels:
                j(dels, deleted=True)

    def note_uni(self, fullkey, gap_key, url: str, points: int) -> None:
        """One univariate alias fitted on a partial ring window."""
        self._note(
            ("uni", fullkey),
            {"kind": "uni", "fullkey": fullkey, "gap_key": gap_key, "urls": (url,), "points": int(points)},
        )

    def note_joint(self, doc_id: str, app: str, urls: tuple, points: int) -> None:
        """A joint (multi-alias) doc fitted on partial ring windows.
        `app` rides along because the joint judge's slow-path cache keys
        carry no history content: invalidating a doc that never warmed
        into the fast-path admission cache has to pop by app."""
        self._note(
            ("joint", doc_id),
            {"kind": "joint", "doc_id": doc_id, "app": app, "urls": tuple(urls), "points": int(points)},
        )

    # -- refinement pass (tick thread) -----------------------------------

    def take(self, limit: int) -> list[tuple[tuple, dict]]:
        """Up to `limit` records in round-robin order: taken records
        rotate to the back so every record gets probed eventually even
        when the book outnumbers the per-tick budget."""
        with self._lock:
            n = min(int(limit), len(self._recs))
            out = []
            for _ in range(n):
                bkey, rec = self._recs.popitem(last=False)
                self._recs[bkey] = rec  # rotate to the back
                out.append((bkey, dict(rec)))
            return out

    def refit(self, bkey: tuple, points: int) -> None:
        """Record a growth-triggered invalidation: the record stays
        provisional with the new pacing baseline."""
        with self._lock:
            rec = self._recs.get(bkey)
            if rec is None:
                # evicted by a cap-pressed note_* between take() and here:
                # nothing is being paced, so nothing to count
                return
            rec["points"] = int(points)
            self._counts["refit"] += 1
            snap = dict(rec)
        j = self.journal
        if j is not None:
            j([(bkey, snap)])

    def drop(self, bkey: tuple, reason: str = "finalized") -> None:
        """Remove a record (reason "finalized" after the terminal refit,
        "settled" when the window closed with nothing left to refit,
        "dropped" when the ring lost the series)."""
        removed = False
        with self._lock:
            if self._recs.pop(bkey, None) is not None:
                self._counts[reason] += 1
                removed = True
        j = self.journal
        if removed and j is not None:
            j([(bkey, None)], deleted=True)

    # -- persistence (duck-typed FitJournal surface) ----------------------

    def restore_lazy(self, items) -> int:
        """Seed restored records (FitJournal.restore output); resident
        records win. Named for the ModelCache surface FitJournal attaches
        to; the book is small, so restore is eager."""
        with self._lock:
            n = 0
            for k, v in dict(items).items():
                if k not in self._recs:
                    self._recs[k] = dict(v)
                    n += 1
            while len(self._recs) > self.cap:
                self._recs.popitem(last=False)
            return n

    def persistable_snapshot(self) -> dict:
        """Point-in-time copy for journal compaction."""
        with self._lock:
            return {k: dict(v) for k, v in self._recs.items()}

    @staticmethod
    def due(points_then: int, points_now: int) -> bool:
        """Geometric pacing rule: is a refit worth it yet?"""
        return points_now >= max(points_then + 1, int(points_then * GROWTH_FACTOR))

    # -- introspection ----------------------------------------------------

    def __len__(self) -> int:
        with self._lock:
            return len(self._recs)

    def debug_state(self) -> dict:
        with self._lock:
            return {"pending": len(self._recs), **self._counts}
