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

Tenancy (`_ArenaTenancy`, the JAX arena's): with two or more tenants
configured, or an `arena_rows` envelope, `assign` recycles an
over-envelope tenant's OWN least-recent row and charges each eviction to
the tenant whose allocation forced it. It is host bookkeeping over the
same row maps; no device tensor is read. Untenanted, or one tenant
without an envelope, the placement is byte-identical to an untenanted
arena's.

Over a device mesh (`sharding`, a `parallel.mesh.Placement`), every state
tensor is a `parallel.mesh.Blocks` whose block i is the buffer of block
i's device. With `shards > 1` the row space splits over the data axis
into [cap_s, ...] shard blocks (global row g = shard * cap_s + local), a
device's buffer holding its shards' blocks end to end (one block a card
on distinct cards; all of them on a mesh that lists one card several
times), and `assign` places position i of a B-row batch only in shard
i // (B / shards) — the batch's own block — so the warm gather never
crosses a device (`_assign_sharded`, the JAX arena's block placement
rule, row maps and migrations unchanged; `device_rows` turns a global
row into its device buffer's). Replicated (`FOREMAST_ARENA_SHARDED=0`),
each device holds a whole copy and every scatter writes all of them.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

from foremast_tpu_torch.engine.scoring import tile_season
from foremast_tpu_torch.ops.windows import resolve_device, to_device
from foremast_tpu_torch.parallel.mesh import device_slots, stack_blocks, tree_map

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


class _ArenaTenancy:
    """Arena-rows budget envelopes + eviction attribution.

    Tracks which tenant owns each KEYED resident row (resolved once at
    assignment from the fit key's URL-encoded tenant label, cached by
    the registry) so `assign` can (a) recycle an over-envelope tenant's
    OWN least-recent row instead of evicting a neighbor's, and (b)
    charge every eviction to the tenant whose allocation forced it.
    Pads and transients stay untenanted. Single-threaded like the arena
    itself; the accounting ledger flush at the end of each assign call
    is the only lock it ever touches (tenant.accounting, a leaf)."""

    __slots__ = ("registry", "acct", "envelopes", "rows", "of", "_pending")

    def __init__(self, registry, acct):
        self.registry = registry
        self.acct = acct
        self.envelopes = {name: s.arena_rows for name, s in registry.specs.items() if s.arena_rows > 0}
        self.rows: dict = {}  # tenant -> keyed resident row count
        self.of: dict = {}  # fit key -> tenant
        self._pending: dict = {}  # tenant -> evictions this assign call

    @staticmethod
    def build(tenancy=None):
        """A tracker when the process is tenanted and tenancy could
        matter here (>=2 tenants, or any arena_rows envelope), else
        None — the parity pin: an untenanted or single-tenant arena
        keeps today's row placement byte-for-byte."""
        from foremast_tpu_torch.tenant import accounting_for, get_tenancy

        if tenancy is None:
            tenancy = get_tenancy()
        if tenancy is None:
            return None
        if not (tenancy.fair or any(s.arena_rows > 0 for s in tenancy.specs.values())):
            return None
        return _ArenaTenancy(tenancy, accounting_for(tenancy))

    def tenant_of(self, key):
        """Owning tenant for a REAL fit key (callers skip pads/None)."""
        return self.registry.tenant_of_key(key)

    def note_assign(self, key, tenant) -> None:
        self.of[key] = tenant
        self.rows[tenant] = self.rows.get(tenant, 0) + 1

    def note_drop(self, key) -> None:
        t = self.of.pop(key, None)
        if t is not None:
            left = self.rows.get(t, 0) - 1
            if left > 0:
                self.rows[t] = left
            else:
                self.rows.pop(t, None)

    def over(self, tenant) -> bool:
        env = self.envelopes.get(tenant, 0)
        return env > 0 and self.rows.get(tenant, 0) >= env

    def charge(self, tenant) -> None:
        self._pending[tenant] = self._pending.get(tenant, 0) + 1

    def flush(self) -> None:
        if self._pending:
            for t, n in self._pending.items():
                self.acct.count_eviction(t, n)
            self._pending.clear()

    def clear(self) -> None:
        self.rows.clear()
        self.of.clear()
        self._pending.clear()


class RowArena:
    """Row-assignment machinery of a device state arena: byte-budgeted
    capacity with pow2 auto-grow toward the hard cap, approximate-LRU
    recycling, hit/miss/eviction counters, and per-call transient-row
    aging. Subclasses make one device's rows (`_alloc_on`) and own
    their own `scatter`.

    Not thread-safe by design: an arena belongs to one judge's dispatch
    thread; the ModelCache is the layer other threads see.

    `sharding` (a mesh `Placement`, None for the subclass's one device)
    places the device buffers over a mesh's data axis: block-sharded
    when `shards` > 1 (byte budgets are then PER SHARD, so capacity
    scales with the mesh), a replica per device otherwise."""

    def __init__(self, row_bytes: int, max_bytes: int | None = None, shards: int = 1, sharding=None):
        self.sharding = sharding
        self.shards = max(int(shards), 1)
        if self.shards > 1 and (sharding is None or len(sharding.mesh.data_devices) != self.shards):
            raise ValueError(f"a {self.shards}-shard arena needs a mesh with {self.shards} data-axis devices")
        self.row_bytes = max(int(row_bytes), 1)
        budget = _arena_bytes() if max_bytes is None else max_bytes
        self.max_rows = min(_MAX_ROWS, max(budget // self.row_bytes, 8))
        # soft budget: a batch larger than max_rows auto-grows toward the
        # hard cap (one log per growth); only past hard_rows does
        # assign() refuse
        self.hard_rows = min(_MAX_ROWS, max(_arena_max_bytes() // self.row_bytes, 8))
        self.cap = 0  # TOTAL rows (= shards * cap_s when sharded)
        self.cap_s = 0  # per-shard rows (== cap when shards == 1)
        self.state = None  # layout owned by the subclass
        self._parts: list = []  # per-device buffers behind `state`
        self.rows: dict = {}  # fit key -> row index
        self.row_key: list = []  # row index -> fit key | None
        # fit key -> the host entry OBJECT its row was scattered from
        # (kept by TreeArena's callers, which detect a refreshed entry by
        # identity); evictions prune it
        self.row_entry: dict = {}
        self.free: list[int] = []  # unassigned row indices (shards == 1)
        # sharded: per-shard free lists of LOCAL indices (stable across
        # growth; global ones renumber)
        self._free_s: list[list[int]] = [[] for _ in range(self.shards)]
        self._transients: list[int] = []  # last call's unkeyed rows
        self.stamp = np.zeros(0, np.int64)  # per-row last-use tick
        self.tick = 0
        self.hits = 0
        self.misses = 0  # rows scattered (new or refreshed)
        self.evictions = 0
        self.shard_moves = 0  # rows migrated between shards (sharded)
        # resident rows held by batch-padding keys: subtracted from
        # rows_live; their hits and misses are never counted
        self.pad_live = 0
        # multi-tenant QoS: None unless the process is tenanted with >=2
        # tenants or an arena_rows envelope (the parity pin above)
        self._qos = _ArenaTenancy.build()

    # -- layout (the subclass makes one device's rows) ---------------------

    def _alloc_on(self, rows: int, dev: torch.device):
        """Fresh all-zero state of `rows` rows on `dev`."""
        raise NotImplementedError

    def _slots(self) -> tuple[list, list, list]:
        """(each device part's device, each data-axis block's part, its
        rank among its part's blocks): one part per distinct device."""
        if self.sharding is None:
            return [self.device], [0], [0]
        return device_slots(self.sharding.mesh.data_devices)

    def _compose(self):
        """`state` from the device parts: the one device's tree, or a tree
        of `Blocks` whose block i is block i's device buffer (the blocks
        a device holds share it)."""
        if self.sharding is None:
            return self._parts[0]
        _, part, _ = self._slots()
        return stack_blocks([self._parts[p] for p in part], replicated=self.shards == 1)

    def _alloc(self, cap: int):
        """Fresh all-zero state for `cap` rows: on the one device; or, over
        a mesh, one buffer a device — its k shard blocks of cap / shards
        rows end to end, or a whole replica."""
        devs, part, _ = self._slots()
        per = cap // self.shards if self.shards > 1 else cap
        self._parts = [
            self._alloc_on(per * (part.count(p) if self.shards > 1 else 1), d) for p, d in enumerate(devs)
        ]
        return self._compose()

    def _grow(self, pad: int):
        """`state` with `pad` zero rows more a block: at the end of the
        buffer, or, sharded, at the end of each of its shard blocks (rows
        keep their block)."""
        _, part, _ = self._slots()

        def grow(a, k):
            tail = a.shape[1:]
            blocks = a.reshape(k, a.shape[0] // k, *tail)
            zeros = torch.zeros((k, pad, *tail), dtype=a.dtype, device=a.device)
            return torch.cat([blocks, zeros], dim=1).reshape(-1, *tail)

        ks = [part.count(p) if self.shards > 1 else 1 for p in range(len(self._parts))]
        self._parts = [tree_map(lambda a, k=k: grow(a, k), t) for t, k in zip(self._parts, ks)]
        return self._compose()

    def device_rows(self, rows: np.ndarray) -> np.ndarray:
        """Global rows as rows of their device's buffer: a shard's block
        starts at its rank among its device's blocks times cap_s (its
        local row where each device holds one block)."""
        rows = np.asarray(rows, np.int64)
        if self.shards == 1:
            return rows
        _, _, rank = self._slots()
        shard = rows // self.cap_s
        return np.asarray(rank, np.int64)[shard] * self.cap_s + rows % self.cap_s

    def _targets(self, rows: np.ndarray):
        """(part, positions, rows of that part's buffer) for each device
        buffer a scatter to global `rows` writes: the one device, every
        replica, or each device holding one of the rows' shards."""
        devs, part, _ = self._slots()
        if self.shards == 1:
            return [(p, np.arange(len(rows)), rows) for p in range(len(devs))]
        of = np.asarray(part, np.int64)[rows // self.cap_s]
        local = self.device_rows(rows)
        out = []
        for p in np.unique(of).tolist():
            sel = np.nonzero(of == p)[0]
            out.append((p, sel, local[sel]))
        return out

    def _part_device(self, p) -> torch.device:
        return self._slots()[0][p]

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
        self.cap_s = new_cap
        return True

    def _ensure_capacity_sharded(self, need_s: int) -> bool:
        """Sharded-mode `_ensure_capacity`: `need_s` is the PER-SHARD row
        count this call must host. The same soft-budget auto-grow and
        hard-cap refusal, per shard. Growth pads each block at its end
        on its device, so no row leaves its shard; the global indices of
        the host maps renumber (g = shard * cap_s + local)."""
        if need_s > self.max_rows:
            if need_s > self.hard_rows:
                return False
            self.max_rows = min(self.hard_rows, _pow2(need_s))
            log.warning(
                "sharded arena grown past FOREMAST_ARENA_BYTES soft budget: %d rows/shard x %d shards x %d B "
                "= %.0f MB aggregate; set FOREMAST_ARENA_BYTES>=%d to silence",
                need_s,
                self.shards,
                self.row_bytes,
                need_s * self.shards * self.row_bytes / 1e6,
                need_s * self.row_bytes,
            )
        if need_s <= self.cap_s:
            return True
        new_s = min(self.max_rows, max(_pow2(need_s), max(self._min_rows() // self.shards, 8)))
        old_s = self.cap_s
        if self.state is None:
            self.state = self._alloc(self.shards * new_s)
        else:
            self.state = self._grow(new_s - old_s)
        if old_s:

            def remap(g: int) -> int:
                return (g // old_s) * new_s + (g % old_s)

            self.rows = {k: remap(g) for k, g in self.rows.items()}
            new_keys: list = [None] * (self.shards * new_s)
            for g, k in enumerate(self.row_key):
                if k is not None:
                    new_keys[remap(g)] = k
            self.row_key = new_keys
            st = np.full((self.shards, new_s), -1, np.int64)
            st[:, :old_s] = self.stamp.reshape(self.shards, old_s)
            self.stamp = st.ravel()
            self._transients = [remap(g) for g in self._transients]
        else:
            self.row_key = [None] * (self.shards * new_s)
            self.stamp = np.full(self.shards * new_s, -1, np.int64)
        for fl in self._free_s:
            fl.extend(range(old_s, new_s))
        self.cap_s = new_s
        self.cap = self.shards * new_s
        return True

    def _min_rows(self) -> int:
        """Initial-allocation floor."""
        return _MIN_ROWS

    def clear(self) -> None:
        """Release device buffers and all row assignments."""
        self.cap = 0
        self.cap_s = 0
        self.state = None
        self._parts = []
        self.rows.clear()
        self.row_entry.clear()
        self.row_key = []
        self.stamp = np.zeros(0, np.int64)
        self.free = []
        self._free_s = [[] for _ in range(self.shards)]
        self._transients = []
        self.pad_live = 0
        if self._qos is not None:
            self._qos.clear()

    # -- assignment ------------------------------------------------------

    def _own_victim(self, order: list, tenant, start: int) -> tuple[int, int]:
        """First evictable row (stamp != this call's tick) OWNED by
        `tenant`, walking `order` (a stamp argsort: LRU first) from
        `start`; returns (row, where the tenant's next walk starts), row -1
        when every row of the tenant is protected this call: the envelope
        then falls through to normal placement, because a budget may
        reorder row recycling but must never block a verdict.

        The walk resumes where the tenant's last one stopped (`start`), and
        finds the row a walk from the front would: a row passed over was
        protected (and stays so), or held by another tenant or none (and
        becomes this tenant's only through an assignment this call, which
        protects it), or was taken (and so protected)."""
        qos = self._qos
        stamp, row_key, tick, of = self.stamp, self.row_key, self.tick, qos.of
        for j in range(start, len(order)):
            r = order[j]
            if stamp[r] == tick:
                continue
            k = row_key[r]
            if k is not None and of.get(k) == tenant:
                return r, j + 1
        return -1, len(order)

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
        the preferred recycling pool. With tenancy, an over-envelope
        tenant recycles its own least-recent row first (`_ArenaTenancy`).

        Sharded arenas (`shards` > 1) route to `_assign_sharded`: the
        same surface, each position's row in its data-axis block."""
        if self.shards > 1:
            return self._assign_sharded(keys, force, n_real)
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
            qos = self._qos
            order = None
            oi = 0
            own_order = None  # `order` as a list, for the envelope's walks
            own_from: dict = {}  # tenant -> where its next own-row walk starts
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
                tenant = None
                if qos is not None and k is not None and not _is_pad_key(k):
                    tenant = qos.tenant_of(k)
                if tenant is not None and qos.over(tenant):
                    # arena_rows envelope: an over-budget tenant recycles
                    # its OWN least-recent row (never a neighbor's, the
                    # free pool or capacity growth), charged to it
                    if order is None:
                        order = np.argsort(self.stamp, kind="stable")
                    if own_order is None:
                        own_order = order.tolist()
                    rv, own_from[tenant] = self._own_victim(own_order, tenant, own_from.get(tenant, 0))
                    if rv >= 0:
                        old = self.row_key[rv]
                        del self.rows[old]
                        self.row_entry.pop(old, None)
                        self.evictions += 1
                        qos.note_drop(old)
                        qos.charge(tenant)
                        self.rows[k] = rv
                        self.row_key[rv] = k
                        qos.note_assign(k, tenant)
                        self.stamp[rv] = self.tick
                        rows[i] = rv
                        scatter.append(i)
                        if i < nr:
                            self.misses += 1
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
                        if qos is not None:
                            qos.note_drop(old)
                            if tenant is not None:
                                qos.charge(tenant)
                if k is not None:
                    self.rows[k] = r
                    self.row_key[r] = k
                    if i >= nr:
                        self.pad_live += 1
                    if tenant is not None:
                        qos.note_assign(k, tenant)
                else:
                    # transient: recyclable at the next assign
                    self.row_key[r] = None
                    self._transients.append(r)
                self.stamp[r] = self.tick
                rows[i] = r
                scatter.append(i)
                if i < nr:
                    self.misses += 1
        if self._qos is not None:
            self._qos.flush()
        return rows, scatter

    def _assign_sharded(self, keys, force, n_real: int | None = None) -> tuple[np.ndarray, list[int]] | None:
        """`assign` under the data-axis block placement rule: position i
        of a B-row batch lives in shard i // (B / shards) and its row
        must belong to that shard's block, so the warm gather never
        crosses a device. As in the JAX arena:

          * a key whose position moved to another block since its last
            call MIGRATES — old row freed, a fresh row scattered in the
            new shard (`shard_moves` counts these);
          * a key already claimed by one position this call and ALSO at
            a position of another shard scores that position from a
            transient row;
          * ALL growth happens before rows are handed out (growing
            renumbers global indices), using the 8-call idle window of
            the replicated path's backstop.

        One departure: after that growth the JAX arena reads the key map
        from before the renumbering; this one reads the new map, so no
        row is ever handed to two keys."""
        n = len(keys)
        nr = n if n_real is None else n_real
        shards = self.shards
        if n % shards:
            log.warning(
                "sharded arena assign: batch of %d rows is not a multiple of %d shards — stacked fallback",
                n,
                shards,
            )
            return None
        for r in self._transients:
            if self.row_key[r] is None:
                self.stamp[r] = -1
        self._transients.clear()
        self.tick += 1
        per = n // shards
        if not self._ensure_capacity_sharded(per):
            return None
        getrow = self.rows.get

        def sweep() -> np.ndarray:
            return np.fromiter(((getrow(k, -1) if k is not None else -1) for k in keys), np.int64, count=n)

        rows = sweep()
        shard_of = np.repeat(np.arange(shards, dtype=np.int64), per)
        hit = (rows >= 0) & ((rows // self.cap_s) == shard_of)
        miss_shard = shard_of[~hit]
        if len(miss_shard):
            counts = np.bincount(miss_shard, minlength=shards)
            st2 = self.stamp.reshape(shards, self.cap_s)
            idle = ((st2 >= 0) & (st2 < self.tick - 8)).sum(axis=1)
            free_n = np.asarray([len(f) for f in self._free_s])
            short = int((counts - idle - free_n).max())
            if short > 0 and self.cap_s + short <= self.hard_rows:
                self._ensure_capacity_sharded(self.cap_s + short)
                # growth renumbered every global index into a NEW map:
                # read that one from here on. (The JAX arena keeps reading
                # the old map, and can then hand one row to two keys:
                # ROADMAP.md Queue 3.)
                getrow = self.rows.get
                rows = sweep()
                hit = (rows >= 0) & ((rows // self.cap_s) == shard_of)
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
            claimed = {keys[i] for i in np.nonzero(hit)[0] if keys[i] is not None}
            qos = self._qos
            cap_s = self.cap_s
            order_s: list = [None] * shards
            oi_s = [0] * shards
            own_order_s: list = [None] * shards  # global rows, LRU first
            own_from: dict = {}  # (shard, tenant) -> next own-row walk start
            for i in alloc.tolist():
                k = keys[i]
                s = int(shard_of[i])
                base = s * cap_s
                transient = k is None
                if k is not None:
                    g = getrow(k, -1)
                    if g >= 0:
                        if g // cap_s == s:
                            # duplicate key later in the batch: reuse the
                            # row its first occurrence just claimed
                            rows[i] = g
                            continue
                        if k in claimed:
                            # the key's row belongs to another position
                            # this call: score this one from a transient
                            transient = True
                        else:
                            # block membership changed since last call:
                            # migrate the row to this position's shard
                            self.row_key[g] = None
                            self.stamp[g] = -1
                            self._free_s[g // cap_s].append(g % cap_s)
                            del self.rows[k]
                            self.row_entry.pop(k, None)
                            self.shard_moves += 1
                            if _is_pad_key(k):
                                self.pad_live -= 1
                            if qos is not None:
                                # migration, not pressure: nobody is charged
                                qos.note_drop(k)
                tenant = None
                if qos is not None and not transient and not _is_pad_key(k):
                    tenant = qos.tenant_of(k)
                if tenant is not None and qos.over(tenant):
                    # arena_rows envelope, block-local: the over-budget
                    # tenant recycles its own least-recent row in THIS
                    # position's shard, charged to it
                    if own_order_s[s] is None:
                        own_order_s[s] = (base + np.argsort(self.stamp[base : base + cap_s], kind="stable")).tolist()
                    rv, own_from[(s, tenant)] = self._own_victim(
                        own_order_s[s], tenant, own_from.get((s, tenant), 0)
                    )
                    if rv >= 0:
                        old = self.row_key[rv]
                        del self.rows[old]
                        self.row_entry.pop(old, None)
                        self.evictions += 1
                        qos.note_drop(old)
                        qos.charge(tenant)
                        self.rows[k] = rv
                        self.row_key[rv] = k
                        claimed.add(k)
                        qos.note_assign(k, tenant)
                        self.stamp[rv] = self.tick
                        rows[i] = rv
                        scatter.append(i)
                        if i < nr:
                            self.misses += 1
                        continue
                freel = self._free_s[s]
                if freel:
                    r = base + freel.pop()
                else:
                    if order_s[s] is None:
                        order_s[s] = np.argsort(self.stamp[base : base + cap_s], kind="stable")
                    order = order_s[s]
                    oi = oi_s[s]
                    while True:
                        if oi >= len(order):
                            # unreachable: cap_s >= per and at most `per`
                            # rows of a shard carry this call's stamp
                            raise RuntimeError(
                                "sharded arena assign invariant violated: no evictable row in shard "
                                f"{s} (per={per}, cap_s={cap_s})"
                            )
                        r = base + int(order[oi])
                        oi += 1
                        if self.stamp[r] != self.tick:
                            break
                    oi_s[s] = oi
                    old = self.row_key[r]
                    if old is not None:
                        del self.rows[old]
                        self.row_entry.pop(old, None)
                        self.evictions += 1
                        if _is_pad_key(old):
                            self.pad_live -= 1
                        if qos is not None:
                            qos.note_drop(old)
                            if tenant is not None:
                                qos.charge(tenant)
                if transient:
                    self.row_key[r] = None
                    self._transients.append(r)
                else:
                    self.rows[k] = r
                    self.row_key[r] = k
                    claimed.add(k)
                    if i >= nr:
                        self.pad_live += 1
                    if tenant is not None:
                        qos.note_assign(k, tenant)
                self.stamp[r] = self.tick
                rows[i] = r
                scatter.append(i)
                if i < nr:
                    self.misses += 1
        if self._qos is not None:
            self._qos.flush()
        return rows, scatter

    def device_bytes(self) -> int:
        """Device-memory footprint of this arena's buffers on ONE device:
        the whole capacity on one device or a replica, one shard's block
        when sharded (times the device count: the shard sum)."""
        return (self.cap // self.shards) * self.row_bytes

    def total_device_bytes(self) -> int:
        """Device-memory footprint of this arena's buffers on every device
        that holds one (one buffer a distinct data-axis device): the
        shard sum when sharded, a replica a device when replicated."""
        if self.shards > 1:
            return self.cap * self.row_bytes
        return len(self._slots()[0]) * self.device_bytes()

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
        sharding=None,
    ):
        self.m = max(int(season_len), 1)
        self.device = resolve_device(device)
        super().__init__(_row_bytes(self.m), max_bytes=max_bytes, shards=shards, sharding=sharding)

    def _alloc_on(self, cap: int, dev: torch.device):
        f32, i32 = torch.float32, torch.int32
        return (
            torch.zeros(cap, dtype=f32, device=dev),
            torch.zeros(cap, dtype=f32, device=dev),
            torch.zeros((cap, self.m), dtype=f32, device=dev),
            torch.zeros(cap, dtype=i32, device=dev),
            torch.zeros(cap, dtype=f32, device=dev),
            torch.zeros(cap, dtype=i32, device=dev),
        )

    # -- data movement ---------------------------------------------------

    def scatter(self, rows: np.ndarray, positions: list[int], entries) -> None:
        """Upload the (re)fitted entries into their rows.

        entries[i] layout: (level, trend, season[np], phase, scale,
        n_hist) — the ModelCache terminal-state tuple. The rows travel
        as ONE [k, 6 + m] 32-bit host buffer (row index, the five
        scalars, the tiled season; integer columns bit-cast), one
        host-to-device copy, then one indexed in-place copy per state
        tensor. Duplicate positions carry identical rows. Over a mesh the
        same happens once per device part a row lands on (each replica,
        or the shard holding it, with its local row)."""
        k = len(positions)
        if k == 0:
            return
        m = self.m
        packed = np.empty((k, 6 + m), np.float32)
        as_int = packed.view(np.int32)
        picked = [entries[i] for i in positions]
        glob = np.asarray(rows, np.int64)[positions]
        packed[:, 1] = [e[0] for e in picked]
        packed[:, 2] = [e[1] for e in picked]
        as_int[:, 3] = [e[3] for e in picked]
        packed[:, 4] = [e[4] for e in picked]
        as_int[:, 5] = [e[5] for e in picked]
        packed[:, 6:] = np.stack([tile_season(np.asarray(e[2], np.float32), m) for e in picked])
        for p, sel, local in self._targets(glob):
            part = packed[sel]
            part.view(np.int32)[:, 0] = local
            dev = to_device(part, self._part_device(p))
            ints = dev.view(torch.int32)
            idx = ints[:, 0].long()
            lvl, tr, se, ph, sc, nh = self._parts[p]
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

    def __init__(self, template, max_bytes: int | None = None, shards: int = 1, device="cuda", sharding=None):
        self.template = template
        self.device = resolve_device(device)
        row_bytes = sum(
            int(np.prod(shape, dtype=np.int64)) * torch.empty((), dtype=dtype).element_size()
            for shape, dtype in _tree_leaves(template)
        )
        super().__init__(row_bytes or 1, max_bytes=max_bytes, shards=shards, sharding=sharding)

    def _min_rows(self) -> int:
        # joint rows are fat (an F=4 LSTM-AE row is ~60 KB): a small floor
        return 64

    def _alloc_on(self, cap: int, dev: torch.device):
        return tree_map_leaves(lambda leaf: torch.zeros((cap, *leaf[0]), dtype=leaf[1], device=dev), self.template)

    def scatter(self, rows: np.ndarray, positions: list[int], entries) -> None:
        """Upload (re)fitted row trees into their rows: entries[i] is a
        tree of host numpy leaves shaped as the template's rows (callers
        tile season buffers beforehand). One host-to-device copy and one
        indexed in-place copy per leaf, on each device part the rows land
        on."""
        if not positions:
            return
        glob = np.asarray(rows, np.int64)[positions]
        for p, sel, local in self._targets(glob):
            dev = self._part_device(p)
            idx = to_device(local, dev)
            picked = [entries[positions[j]] for j in sel.tolist()]

            def put(state, *leaves):
                host = np.stack([np.asarray(x) for x in leaves])
                state.index_copy_(0, idx, to_device(host, dev).to(state.dtype))
                return state

            tree_map_leaves(put, self._parts[p], *picked)


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
