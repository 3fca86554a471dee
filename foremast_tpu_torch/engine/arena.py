"""Device-resident fitted-state arena: gather-keyed warm-tick scoring.

One device ROW per fit key, as in the JAX package's `engine/arena.py`:

  * state lives on the judge's device as [capacity] tensors plus a
    [capacity, m] season buffer; a tick's batch is assembled ON DEVICE
    by `index_select` with a [B] row-index tensor
    (`engine.scoring.score_from_arena`) — no host restack for warm rows;
  * a churned claim set uploads exactly the changed rows (`scatter`:
    one host-to-device copy of the packed rows, then one indexed
    in-place copy per state tensor), so 10 % churn costs 10 %;
  * capacity is sized by BYTES (FOREMAST_ARENA_BYTES, default 256 MB),
    grows in powers of two toward FOREMAST_ARENA_MAX_BYTES, and is
    capped at 262,144 rows;
  * hit/miss/eviction counters match the JAX arena key for key: the row
    assignment below is that arena's host bookkeeping, unchanged.

The host fit cache (`models.cache.ModelCache`) stays authoritative; the
arena is a device-side acceleration of it. Every fit-cache miss is refit
and force-scattered, so a stale row never outlives its host entry.

`TreeArena` holds the joint detectors' rows (a fixed-shape state tree a
row) on the same bookkeeping.

Single device only: `shards > 1` (the data-axis-sharded arena) and the
tenant-budget hook are not ported (ROADMAP.md Queue 1 items 6 and 7).
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

from foremast_tpu_torch.engine.scoring import tile_season
from foremast_tpu_torch.ops.windows import resolve_device, to_device

log = logging.getLogger("foremast_tpu_torch.arena")

_DEFAULT_BYTES = 256 * 1024 * 1024
# hard auto-grow ceiling: a working set past the soft budget grows the
# arena instead of silently restacking every tick
_DEFAULT_MAX_BYTES = 2 * 1024 * 1024 * 1024
_MAX_ROWS = 262_144
_MIN_ROWS = 8_192

# Explicit overrides beat the env (set before the first tick; existing
# arenas keep the capacity they were built with).
_BYTES_OVERRIDE: int | None = None
_MAX_BYTES_OVERRIDE: int | None = None


def set_arena_budget(soft_bytes: int | None, max_bytes: int | None) -> None:
    """Pin the arena byte budgets for this process (None clears an
    override back to the env or default)."""
    global _BYTES_OVERRIDE, _MAX_BYTES_OVERRIDE
    _BYTES_OVERRIDE = None if soft_bytes is None else int(soft_bytes)
    _MAX_BYTES_OVERRIDE = None if max_bytes is None else int(max_bytes)


def _arena_bytes() -> int:
    if _BYTES_OVERRIDE is not None:
        return _BYTES_OVERRIDE
    return int(os.environ.get("FOREMAST_ARENA_BYTES", _DEFAULT_BYTES))


def _arena_max_bytes() -> int:
    if _MAX_BYTES_OVERRIDE is not None:
        return _MAX_BYTES_OVERRIDE
    return int(os.environ.get("FOREMAST_ARENA_MAX_BYTES", _DEFAULT_MAX_BYTES))


def _row_bytes(m: int) -> int:
    # level f32 + trend f32 + phase i32 + scale f32 + n_hist i32 + season
    return 20 + 4 * m


def _is_pad_key(k) -> bool:
    """Batch-padding keys ("__pad__*" strings): resident machinery that
    never counts as fleet state in the operator counters."""
    return isinstance(k, str) and k.startswith("__pad__")


def _pow2(n: int) -> int:
    b = 8
    while b < n:
        b *= 2
    return b


class RowArena:
    """Row-assignment machinery of a device state arena: byte-budgeted
    capacity with pow2 auto-grow toward the hard cap, approximate-LRU
    recycling, hit/miss/eviction counters, and per-call transient-row
    aging. Subclasses own the device layout via `_alloc` / `_grow` and
    their own `scatter`.

    Not thread-safe by design: an arena belongs to one judge's dispatch
    thread; the ModelCache is the layer other threads see."""

    def __init__(self, row_bytes: int, max_bytes: int | None = None, shards: int = 1):
        if int(shards) > 1:
            raise NotImplementedError(
                "the data-axis-sharded arena is not ported to torch yet: "
                "ROADMAP.md Queue 1, 'Multi-GPU'"
            )
        self.row_bytes = max(int(row_bytes), 1)
        budget = _arena_bytes() if max_bytes is None else max_bytes
        self.max_rows = min(_MAX_ROWS, max(budget // self.row_bytes, 8))
        # soft budget: a batch larger than max_rows auto-grows toward the
        # hard cap (one log per growth); only past hard_rows does
        # assign() refuse
        self.hard_rows = min(_MAX_ROWS, max(_arena_max_bytes() // self.row_bytes, 8))
        self.cap = 0
        self.state = None  # layout owned by the subclass
        self.rows: dict = {}  # fit key -> row index
        self.row_key: list = []  # row index -> fit key | None
        # fit key -> the host entry OBJECT its row was scattered from
        # (kept by TreeArena's callers, which detect a refreshed entry by
        # identity); evictions prune it
        self.row_entry: dict = {}
        self.free: list[int] = []  # unassigned row indices
        self._transients: list[int] = []  # last call's unkeyed rows
        self.stamp = np.zeros(0, np.int64)  # per-row last-use tick
        self.tick = 0
        self.hits = 0
        self.misses = 0  # rows scattered (new or refreshed)
        self.evictions = 0
        self.shard_moves = 0  # always 0 on one device
        # resident rows held by batch-padding keys: subtracted from
        # rows_live; their hits and misses are never counted
        self.pad_live = 0

    # -- layout hooks (subclass-owned) ------------------------------------

    def _alloc(self, cap: int):
        """Fresh all-zero state for `cap` rows."""
        raise NotImplementedError

    def _grow(self, pad: int):
        """`self.state` extended by `pad` zero rows."""
        raise NotImplementedError

    # -- memory ----------------------------------------------------------

    def _ensure_capacity(self, need: int) -> bool:
        """Grow (doubling) to host `need` concurrent rows; False when even
        the hard byte cap cannot fit the batch (the caller falls back to
        a one-off stacked dispatch — counted, never silent)."""
        if need > self.max_rows:
            if need > self.hard_rows:
                return False
            # auto-grow past the soft budget: an LRU arena smaller than
            # the working set thrashes (cyclic access misses every row)
            self.max_rows = min(self.hard_rows, _pow2(need))
            log.warning(
                "arena grown past FOREMAST_ARENA_BYTES soft budget: "
                "%d rows x %d B = %.0f MB; set FOREMAST_ARENA_BYTES>=%d "
                "to silence",
                need,
                self.row_bytes,
                need * self.row_bytes / 1e6,
                need * self.row_bytes,
            )
        if need <= self.cap:
            return True
        new_cap = min(self.max_rows, max(_pow2(need), self._min_rows()))
        pad = new_cap - self.cap
        if self.state is None:
            self.state = self._alloc(new_cap)
        else:
            self.state = self._grow(pad)
        self.row_key.extend([None] * pad)
        self.stamp = np.concatenate([self.stamp, np.full(pad, -1, np.int64)])
        self.free.extend(range(self.cap, new_cap))
        self.cap = new_cap
        return True

    def _min_rows(self) -> int:
        """Initial-allocation floor."""
        return _MIN_ROWS

    def clear(self) -> None:
        """Release device buffers and all row assignments."""
        self.cap = 0
        self.state = None
        self.rows.clear()
        self.row_entry.clear()
        self.row_key = []
        self.stamp = np.zeros(0, np.int64)
        self.free = []
        self._transients = []
        self.pad_live = 0

    # -- assignment ------------------------------------------------------

    def assign(self, keys, force, n_real: int | None = None) -> tuple[np.ndarray, list[int]] | None:
        """Map a batch's fit keys onto arena rows.

        keys:  per-task cache keys (None => transient row, scattered and
               recyclable at the next call).
        force: positions whose entries were (re)fitted this tick — their
               rows are scattered even if the key already has a row.
        n_real: positions >= this are batch-padding keys: they get rows
               and scatters like any key but are excluded from the
               hit/miss/rows_live counters. Default: every position.

        Returns (rows [B] int64, scatter_positions), or None when the
        batch cannot fit in the byte budget. Rows touched this call
        carry stamp == tick and are never eviction candidates; last
        call's transient rows are aged to stamp -1 up front, making them
        the preferred recycling pool."""
        for r in self._transients:
            if self.row_key[r] is None:
                self.stamp[r] = -1
        self._transients.clear()
        self.tick += 1
        n = len(keys)
        nr = n if n_real is None else n_real
        if not self._ensure_capacity(n):
            return None
        getrow = self.rows.get
        rows = np.fromiter(
            ((getrow(k, -1) if k is not None else -1) for k in keys),
            np.int64,
            count=n,
        )
        hit = rows >= 0
        if hit.any():
            self.stamp[rows[hit]] = self.tick
        nhits = int(hit[:nr].sum())
        scatter: list[int] = []
        if force:
            for i in force:
                if hit[i]:
                    scatter.append(i)
            nhits -= len(scatter)
            self.misses += len(scatter)
        self.hits += nhits
        alloc = np.nonzero(~hit)[0]
        if len(alloc):
            # Working-set growth: a warm tick split across sibling bucket
            # calls (the baseline-less and canary columnar buckets share
            # this arena) has a working set larger than any one batch.
            # Rows touched within the last two calls count as resident:
            # when the allocation cannot be served from the free pool plus
            # rows idle for 3+ calls, grow instead of recycling them.
            available = len(self.free) + int(((self.stamp >= 0) & (self.stamp < self.tick - 2)).sum())
            shortfall = len(alloc) - available
            if shortfall > 0 and self.cap + shortfall <= self.hard_rows:
                self._ensure_capacity(self.cap + shortfall)
            order = None
            oi = 0
            for ai, i in enumerate(alloc.tolist()):
                alloc_left = len(alloc) - ai  # incl. this allocation
                k = keys[i]
                if k is not None:
                    r = getrow(k, -1)
                    if r >= 0:
                        # duplicate key later in the same batch: reuse
                        # the row its first occurrence just claimed
                        rows[i] = r
                        continue
                if not self.free:
                    if order is None:
                        order = np.argsort(self.stamp, kind="stable")
                    # in-loop anti-thrash backstop: if the next eviction
                    # candidate was used within the last 8 calls, the
                    # working set exceeds capacity — grow ONCE for the
                    # remaining allocations instead of recycling live rows
                    pi = oi
                    while pi < len(order) and self.stamp[order[pi]] == self.tick:
                        pi += 1
                    if (
                        pi < len(order)
                        and self.stamp[order[pi]] >= self.tick - 8
                        and self.cap + alloc_left <= self.hard_rows
                    ):
                        self._ensure_capacity(self.cap + alloc_left)
                if self.free:
                    r = self.free.pop()
                else:
                    while True:
                        if oi >= len(order):
                            # unreachable: cap >= n and at most n rows carry
                            # this call's stamp. Returning None would leave
                            # the maps half-mutated with rows never
                            # scattered, so fail loudly.
                            raise RuntimeError(
                                "StateArena.assign invariant violated: "
                                f"no evictable row (need={n}, cap={self.cap})"
                            )
                        r = int(order[oi])
                        oi += 1
                        # current stamp, not the argsort snapshot: rows
                        # touched THIS call are protected
                        if self.stamp[r] != self.tick:
                            break
                    old = self.row_key[r]
                    if old is not None:
                        del self.rows[old]
                        self.row_entry.pop(old, None)
                        self.evictions += 1
                        if _is_pad_key(old):
                            self.pad_live -= 1
                if k is not None:
                    self.rows[k] = r
                    self.row_key[r] = k
                    if i >= nr:
                        self.pad_live += 1
                else:
                    # transient: recyclable at the next assign
                    self.row_key[r] = None
                    self._transients.append(r)
                self.stamp[r] = self.tick
                rows[i] = r
                scatter.append(i)
                if i < nr:
                    self.misses += 1
        return rows, scatter

    def device_bytes(self) -> int:
        """Device-memory footprint of this arena's buffers."""
        return self.cap * self.row_bytes

    def counters(self) -> dict:
        return {
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "rows_live": len(self.rows) - self.pad_live,
            "capacity_rows": self.cap,
            "shard_moves": self.shard_moves,
        }


class StateArena(RowArena):
    """Univariate fitted-forecast rows on `device`: level, trend, phase,
    scale and n_hist as [capacity] tensors plus a [capacity, m] season
    buffer — the layout `scoring.score_from_arena` gathers, in its
    argument order (`state`)."""

    def __init__(
        self,
        season_len: int,
        max_bytes: int | None = None,
        shards: int = 1,
        device="cuda",
    ):
        self.m = max(int(season_len), 1)
        self.device = resolve_device(device)
        super().__init__(_row_bytes(self.m), max_bytes=max_bytes, shards=shards)

    def _alloc(self, cap: int):
        f32, i32, dev = torch.float32, torch.int32, self.device
        return (
            torch.zeros(cap, dtype=f32, device=dev),
            torch.zeros(cap, dtype=f32, device=dev),
            torch.zeros((cap, self.m), dtype=f32, device=dev),
            torch.zeros(cap, dtype=i32, device=dev),
            torch.zeros(cap, dtype=f32, device=dev),
            torch.zeros(cap, dtype=i32, device=dev),
        )

    def _grow(self, pad: int):
        return tuple(
            torch.cat([s, torch.zeros((pad, *s.shape[1:]), dtype=s.dtype, device=s.device)])
            for s in self.state
        )

    # -- data movement ---------------------------------------------------

    def scatter(self, rows: np.ndarray, positions: list[int], entries) -> None:
        """Upload the (re)fitted entries into their rows.

        entries[i] layout: (level, trend, season[np], phase, scale,
        n_hist) — the ModelCache terminal-state tuple. The rows travel
        as ONE [k, 6 + m] 32-bit host buffer (row index, the five
        scalars, the tiled season; integer columns bit-cast), one
        host-to-device copy, then one indexed in-place copy per state
        tensor. Duplicate positions carry identical rows."""
        k = len(positions)
        if k == 0:
            return
        m = self.m
        packed = np.empty((k, 6 + m), np.float32)
        as_int = packed.view(np.int32)
        picked = [entries[i] for i in positions]
        as_int[:, 0] = np.asarray(rows, np.int64)[positions]
        packed[:, 1] = [e[0] for e in picked]
        packed[:, 2] = [e[1] for e in picked]
        as_int[:, 3] = [e[3] for e in picked]
        packed[:, 4] = [e[4] for e in picked]
        as_int[:, 5] = [e[5] for e in picked]
        packed[:, 6:] = np.stack([tile_season(np.asarray(e[2], np.float32), m) for e in picked])
        dev = to_device(packed, self.device)
        ints = dev.view(torch.int32)
        idx = ints[:, 0].long()
        lvl, tr, se, ph, sc, nh = self.state
        lvl.index_copy_(0, idx, dev[:, 1])
        tr.index_copy_(0, idx, dev[:, 2])
        ph.index_copy_(0, idx, ints[:, 3])
        sc.index_copy_(0, idx, dev[:, 4])
        nh.index_copy_(0, idx, ints[:, 5])
        se.index_copy_(0, idx, dev[:, 6:])

    def counters(self) -> dict:
        out = super().counters()
        out["season_len"] = self.m
        return out



class TreeArena(RowArena):
    """Device rows of an arbitrary fixed-shape state tree — the joint
    detectors' counterpart of `StateArena`.

    One row holds everything a joint model needs to score warm: the
    bivariate fit (mean [2], cov [2, 2]), or the LSTM-AE hybrid's
    parameter leaves plus its residual-MVN state. `template` maps each
    leaf name to its per-row (shape, dtype); nested dicts and
    NamedTuples of such pairs are trees too. Every leaf is a [capacity,
    ...] tensor on `device`, and a warm batch is gathered on the device
    inside the joint programs (`index_select` with a [B] row index).
    Budget, pow2 growth, LRU and counters are `RowArena`'s."""

    def __init__(self, template, max_bytes: int | None = None, shards: int = 1, device="cuda"):
        self.template = template
        self.device = resolve_device(device)
        row_bytes = sum(
            int(np.prod(shape, dtype=np.int64)) * torch.empty((), dtype=dtype).element_size()
            for shape, dtype in _tree_leaves(template)
        )
        super().__init__(row_bytes or 1, max_bytes=max_bytes, shards=shards)

    def _min_rows(self) -> int:
        # joint rows are fat (an F=4 LSTM-AE row is ~60 KB): a small floor
        return 64

    def _alloc(self, cap: int):
        dev = self.device
        return tree_map_leaves(lambda leaf: torch.zeros((cap, *leaf[0]), dtype=leaf[1], device=dev), self.template)

    def _grow(self, pad: int):
        return tree_map_leaves(
            lambda s, leaf: torch.cat([s, torch.zeros((pad, *leaf[0]), dtype=leaf[1], device=s.device)]),
            self.state,
            self.template,
        )

    def scatter(self, rows: np.ndarray, positions: list[int], entries) -> None:
        """Upload (re)fitted row trees into their rows: entries[i] is a
        tree of host numpy leaves shaped as the template's rows (callers
        tile season buffers beforehand). One host-to-device copy and one
        indexed in-place copy per leaf."""
        if not positions:
            return
        dev = self.device
        idx = to_device(np.asarray(rows, np.int64)[positions], dev)
        picked = [entries[i] for i in positions]

        def put(state, *leaves):
            host = np.stack([np.asarray(x) for x in leaves])
            state.index_copy_(0, idx, to_device(host, dev).to(state.dtype))
            return state

        tree_map_leaves(put, self.state, *picked)


def _is_pair(x) -> bool:
    return isinstance(x, tuple) and len(x) == 2 and isinstance(x[1], torch.dtype)


def _tree_leaves(tree) -> list:
    """Leaves of a template tree ((shape, dtype) pairs) in order."""
    if _is_pair(tree):
        return [tree]
    if isinstance(tree, dict):
        return [leaf for k in tree for leaf in _tree_leaves(tree[k])]
    return [leaf for v in tree for leaf in _tree_leaves(v)]


def tree_map_leaves(fn, tree, *rest):
    """`fn` over matching leaves of a state tree and any trees shaped like
    it (dicts by key, tuples and NamedTuples by position); the first
    tree's structure is kept. A template's (shape, dtype) pair is a leaf,
    and so is anything that is not a dict or a tuple."""
    if isinstance(tree, dict):
        return {k: tree_map_leaves(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, tuple) and not _is_pair(tree):
        out = [tree_map_leaves(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
        return type(tree)(*out) if hasattr(tree, "_fields") else tuple(out)
    return fn(tree, *rest)
