"""Sharded batch scoring over a device mesh of one process.

The JAX package's `parallel/batch.py` on torch: the (service x metric)
population is one `[B, ...]` batch whose leading axis splits over the
mesh's `data` axis (`parallel.mesh.Blocks`), and every scoring program
runs on each block's device (`mesh.per_block`): once a block on the
cold fits and the object path, once a device on the warm columnar
dispatch (the blocks a device holds batched, so its launches do not
grow with them). Windows are independent, so no block needs another's
data; only the small results come back, one copy into one host buffer
(`judge._HostCopy`).

`ShardedJudge` is a drop-in `HealthJudge`: batches are rounded up to a
multiple of the data axis (pad rows are fully masked -> verdict UNKNOWN,
dropped on decode), and arenas split their row space over the same axis
(`FOREMAST_ARENA_SHARDED=0` keeps a replica per device). Admission,
fit-cache identity and every degradation contract are unchanged.

Over a pod's mesh (`parallel.mesh.Pod`, pod mode) every rank holds the
same batch, places and judges only its own blocks, and `_fetch` gathers
every rank's result rows to every rank, cold fits' states included, so
every rank's fit cache holds the same entries; the arenas are then
replicated on every rank's devices (`_resolve_arena_shards`).
"""

from __future__ import annotations

import logging
import os
import time

import numpy as np
import torch

from foremast_tpu_torch.config import BrainConfig
from foremast_tpu_torch.engine import scoring
from foremast_tpu_torch.engine.judge import HealthJudge, MetricTask, _HostCopy
from foremast_tpu_torch.ops.windows import MetricWindows, resolve_device
from foremast_tpu_torch.parallel import mesh as meshlib

log = logging.getLogger("foremast_tpu_torch.worker")


def pad_batch(batch: scoring.ScoreBatch, multiple: int) -> scoring.ScoreBatch:
    """Pad the leading axis to a multiple; padded rows are all-masked
    (zeros, made where each tensor lies)."""
    b = batch.current.values.shape[0]
    target = meshlib.pad_to_multiple(b, multiple)
    if target == b:
        return batch

    def pad_leading(a):
        if a is None:
            return None
        return torch.cat([a, torch.zeros((target - b, *a.shape[1:]), dtype=a.dtype, device=a.device)])

    return meshlib.tree_map(pad_leading, batch)


def shard_batch(batch: scoring.ScoreBatch, mesh: meshlib.Mesh) -> scoring.ScoreBatch:
    """Place a (padded) batch with its leading axis over the data axis."""
    return meshlib.shard_leading(batch, mesh)


def sharded_univariate(config: BrainConfig | None = None, mesh=None, device="cuda"):
    """The worker's mesh judge, or None for the plain single-device one.

    THE one place a device mesh turns into a univariate judge: the
    worker (its `device_mesh="env"` default and an explicit mesh) and
    the CLI construct through here, so the resolution rules
    (`mesh.worker_device_mesh`: the auto span, the 1-device identity,
    the CPU and process-group guards, the infeasible-grid fallback)
    cannot drift between them. `mesh=None` resolves
    FOREMAST_DEVICE_MESH for a worker on `device`."""
    if mesh is None:
        mesh = meshlib.worker_device_mesh(device=device)
    if mesh is None:
        return None
    judge = ShardedJudge(config, mesh=mesh)
    log.info("device mesh: judge partitioned over %s", mesh.shape)
    return judge


class ShardedJudge(HealthJudge):
    """HealthJudge whose programs run block by block over a mesh.

    The same `judge(tasks)` and `judge_columnar[_async](...)` surfaces;
    placement only. Batches split their leading axis over `data`
    (`_place`, `_place_cols`), arenas split their ROW space over the same
    axis (`_arena_sharding`, `_arena_shards`; FOREMAST_ARENA_SHARDED=0
    keeps a replica per device), and results come back through one host
    buffer (`_fetch`). `mesh_stats` accounts the two host<->device legs
    the mesh changes: placement (seconds, bytes, calls) and the result
    fetch (seconds, bytes; on a warm tick the fetch also waits for the
    device work the dispatch queued); over a pod also the result gathers
    between ranks (calls, bytes gathered, and seconds on the gloo route,
    where the gather runs after the copy; on the NCCL route it is queued
    on the card and its time is part of the fetch's)."""

    def __init__(self, config: BrainConfig | None = None, mesh: meshlib.Mesh | None = None):
        self.mesh = mesh if mesh is not None else meshlib.make_mesh()
        super().__init__(config, device=self.mesh.data_devices[0])
        for d in self.mesh.data_devices:
            resolve_device(d)
        # the whole pod's data axis (batches pad to it) and this rank's
        # share of it (the blocks it places and judges)
        self.n_data = int(self.mesh.shape[meshlib.DATA_AXIS])
        self.n_local = len(self.mesh.data_devices)
        self._arena_shards_n = self._resolve_arena_shards()  # foremast: sharded-arena
        self.mesh_stats = {
            "place_seconds": 0.0,
            "place_bytes": 0,
            "place_calls": 0,
            "fetch_seconds": 0.0,
            "fetch_bytes": 0,
            "gathers": 0,
            "gather_seconds": 0.0,
            "gather_bytes": 0,
        }

    def _batch_multiple(self) -> int:
        return self.n_data

    def _account_place(self, t0: float, placed) -> None:
        """Shared epilogue of both placement hooks: the in-run assert
        that the leading axis is partitioned (every block holds
        B/n_data rows) and the accounting. Block shapes only."""
        blocks = [x for x in meshlib.tree_leaves(placed) if isinstance(x, meshlib.Blocks)]
        if not blocks:
            return
        meshlib.assert_partitioned(blocks[0], self.n_local)
        st = self.mesh_stats
        st["place_seconds"] += time.perf_counter() - t0
        st["place_bytes"] += sum(b.nbytes() for b in blocks)
        st["place_calls"] += 1

    def _place(self, tree):
        # leading axis over `data`; the batch is padded to a multiple of
        # the data axis already (the columnar rounding, or
        # `_judge_bucket`'s task-list pad below)
        t0 = time.perf_counter()
        placed = meshlib.shard_leading(tree, self.mesh)
        self._account_place(t0, placed)
        return placed

    def _place_cols(self, *arrays):
        t0 = time.perf_counter()
        placed = tuple(meshlib.shard_leading(a, self.mesh) for a in arrays)
        self._account_place(t0, placed)
        return placed

    def _host_copy(self, tree) -> _HostCopy:
        pod = self.mesh.pod
        if pod is None or pod.backend != "nccl":
            return _HostCopy(tree)
        # the NCCL route: every rank's packed rows gathered on the card,
        # queued on the stream (the host does not wait), then one copy
        copy = _HostCopy(tree, gather=pod.gather_device)
        self.mesh_stats["gathers"] += 1
        self.mesh_stats["gather_bytes"] += copy.nbytes
        return copy

    def _fetch(self, tree):
        # the "host gather" leg: one buffer for every block's result; on
        # a warm tick this wait also absorbs the device work the
        # dispatch queued. Over a pod on the gloo route every rank's rows
        # of that buffer are then gathered in rank order (block order)
        t0 = time.perf_counter()
        copy = tree if isinstance(tree, _HostCopy) else self._host_copy(tree)
        pod = self.mesh.pod
        st = self.mesh_stats
        if pod is not None and pod.backend == "gloo":
            copy.synchronize()
            t1 = time.perf_counter()
            buf = pod.gather_host(copy.buf)
            st["gathers"] += 1
            st["gather_seconds"] += time.perf_counter() - t1
            st["gather_bytes"] += buf.numel()
            out = copy.unpack(buf)
        else:
            out = copy.wait()
        st["fetch_seconds"] += time.perf_counter() - t0
        st["fetch_bytes"] += int(sum(a.nbytes for a in out))
        return out

    def mesh_debug(self) -> dict:
        """The worker's `/debug/state` device_mesh section body."""
        rows = self.batch_rows_total
        pod = self.mesh.pod
        return {
            "shape": dict(self.mesh.shape),
            "devices": self.mesh.size,
            "batch_rows_total": rows,
            "pad_rows_total": self.pad_rows_total,
            "padded_row_fraction": (round(self.pad_rows_total / rows, 4) if rows else None),
            **{k: round(v, 4) if isinstance(v, float) else v for k, v in self.mesh_stats.items()},
            "pod": (
                None
                if pod is None
                else {
                    "rank": pod.rank,
                    "processes": pod.world,
                    "blocks": [pod.first, pod.first + pod.n_local - 1],
                    "gather_backend": pod.backend,
                }
            ),
        }

    # Decides the layout once; reads no rows.
    # foremast: sharded-arena
    def _resolve_arena_shards(self) -> int:
        """How many data-axis blocks the arena row space splits into,
        decided ONCE at construction (a later env change must not flip a
        live judge's layout): n_data by default, 1 (a replica per
        device) when FOREMAST_ARENA_SHARDED is off, or over a pod: each
        rank addresses only its own blocks' devices, and pod row
        assignment relies on every rank deriving identical maps
        (`parallel.distributed`), so pods keep replicas."""
        raw = (os.environ.get("FOREMAST_ARENA_SHARDED") or "1").strip().lower()
        if raw in ("0", "off", "false", "no", "none", "disabled"):
            return 1
        if self.mesh.pod is not None:
            return 1
        return self.n_data

    # foremast: sharded-arena
    def _arena_shards(self) -> int:
        return self._arena_shards_n

    # The block layout of the batch itself: position i's row on i's device.
    # foremast: sharded-arena
    def _arena_sharding(self):
        # the state rows split over the data axis in the batch's own
        # contiguous blocks: the block placement rule
        # (engine.arena._assign_sharded) puts position i's row on the
        # device of batch position i, so the warm gather stays on its
        # device while capacity grows with the mesh
        if self._arena_shards_n > 1:
            return meshlib.data_sharding(self.mesh, 1)
        return meshlib.replicated(self.mesh)

    def _judge_bucket(self, tasks, th, tc):
        # pad the TASK LIST to the data axis: pad tasks are empty
        # windows, decoded then dropped. Their fit keys are constant, so
        # the empty-history "fit" caches once and warm ticks stay
        # fit-free; a sharded arena gets one pad key PER data-axis block
        # (a single key would migrate between blocks with b).
        # `models.cache.is_pad_fit_key` matches the whole "__pad__*"
        # family, so none of them journals or chases a document.
        b = len(tasks)
        target = meshlib.pad_to_multiple(b, self.n_data)
        if target != b:
            empty = np.zeros(0, np.float32)
            et = np.zeros(0, np.int64)
            # one pad key a block: each pad position's key names the block
            # the placement rule puts it on
            # foremast: sharded-arena
            shards = self._arena_shards()
            per = target // shards

            def pad_task(pos: int) -> MetricTask:
                fk = "__pad__" if shards == 1 else f"__pad__@{pos // per}"
                return MetricTask(
                    job_id="__pad__",
                    alias="__pad__",
                    metric_type=None,
                    hist_times=et,
                    hist_values=empty,
                    cur_times=et,
                    cur_values=empty,
                    fit_key=fk,
                )

            tasks = list(tasks) + [pad_task(pos) for pos in range(b, target)]
        out = super()._judge_bucket(tasks, th, tc)
        return out[:b]


def throughput_batch(
    n_windows: int,
    hist_len: int,
    cur_len: int,
    seed: int = 0,
    device="cuda",
    mesh: meshlib.Mesh | None = None,
) -> scoring.ScoreBatch:
    """The JAX package's synthetic benchmark batch (same seeded numpy
    data: 0.5 +- 0.05 noise, full masks, threshold 5, upper bound, with
    a baseline), built on `device` — or, given a `mesh`, padded to its
    data axis and split over it."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    hv = (0.5 + 0.05 * rng.standard_normal((n_windows, hist_len))).astype(np.float32)
    cv = (0.5 + 0.05 * rng.standard_normal((n_windows, cur_len))).astype(np.float32)
    bv = (0.5 + 0.05 * rng.standard_normal((n_windows, cur_len))).astype(np.float32)
    t0 = 1_700_000_000
    # A bench-only constructor: it builds the synthetic batch on `dev`
    # directly, and a mesh run re-places it through shard_batch below.
    # foremast: ignore[sharding-contract]
    ht = t0 + 60 * torch.arange(hist_len, dtype=torch.int32, device=dev)
    # foremast: ignore[sharding-contract]
    ct = t0 + 60 * torch.arange(cur_len, dtype=torch.int32, device=dev)

    def win(v: np.ndarray, t: torch.Tensor) -> MetricWindows:
        return MetricWindows(
            # foremast: ignore[sharding-contract, device-flow]
            values=torch.from_numpy(v).to(dev),
            # foremast: ignore[sharding-contract]
            mask=torch.ones(v.shape, dtype=torch.bool, device=dev),
            times=t.expand(v.shape).contiguous(),
        )

    def full(value, dtype) -> torch.Tensor:
        # foremast: ignore[sharding-contract]
        return torch.full((n_windows,), value, dtype=dtype, device=dev)

    batch = scoring.ScoreBatch(
        historical=win(hv, ht),
        current=win(cv, ct),
        baseline=win(bv, ct),
        threshold=full(5.0, torch.float32),
        bound=full(1, torch.int32),
        min_lower_bound=full(0.0, torch.float32),
        min_points=full(10, torch.int32),
    )
    if mesh is not None:
        batch = shard_batch(pad_batch(batch, mesh.shape[meshlib.DATA_AXIS]), mesh)
    return batch
