"""Planned state handoff: a rebalance as a TRANSFER, not a refit.

The port's copy of the JAX package's `foremast_tpu/mesh/handoff.py`. An
unplanned death costs the survivors a stuck-claim takeover and a cold
refit of the inherited partition. A PLANNED change (scale-up, drain, a
rolling restart) moves state instead: the current owner of every route
key the change moves streams the affected ring series and fit-cache
entries to the new owner, as crc-framed pickled records
(`ingest/snapshot.py` `append_record`), POSTed to the new owner's
receiver (``/api/v1/transfer``) and applied through the ring's push path,
so budgets, coverage spans and last-write-wins merges hold for
transferred state exactly as for pushed state.

  * scale-up: the joiner registers ``joining`` (its lease counts, its
    record advertises the endpoint, it is fenced from the claim ring);
    every active member streams it the keys the target ring moves to it
    and ends with a ``done`` marker. With a ``done`` from every active
    member, or at `deadline_seconds`, it flips ``active`` and its first
    claims judge from transferred state.
  * drain: the leaver flips ``draining``, keeps claiming and judging, and
    streams its ring series and fits to the post-drain owners; then it
    leaves.

Records: ``("hello", HANDOFF_VERSION, sender)``, ``("series", key, times,
values, spans)``, ``("fit", cache, key, value)`` and ``("done", sender,
n_series, n_fits)``. Every kind is idempotent. Values are host values:
what the caches hold (floats, ints, numpy arrays), with torch tensors
copied to numpy and the joint LSTM entries' parameter NamedTuples written
as the dict-of-dicts layout both packages' joint judges coerce
(`_wire_value`); no CUDA tensor is ever pickled. The receiver unpickles
through `_TransferUnpickler`, which maps the JAX package's classes and
arrays to the port's own and numpy, so a mixed fleet hands off both ways
without this package importing the JAX one.

Degradation (chaos edge ``transfer``): every POST runs through the chaos
seam and the edge's circuit breaker; transport failures and transient
statuses retry with jittered backoff, a hard 4xx is a permanent verdict,
and a transfer given up on is counted and abandoned: the receiving side
cold-refits what never arrived. A torn stream keeps its healthy prefix.
"""

from __future__ import annotations

import dataclasses
import io
import logging
import os
import pickle
import random
import threading
import time
import urllib.error
import urllib.request

import numpy as np

from foremast_tpu_torch.ingest.receiver import TRANSFER_PATH
from foremast_tpu_torch.ingest.snapshot import append_record, read_record_stream
from foremast_tpu_torch.mesh.membership import STATE_JOINING, MemberRecord
from foremast_tpu_torch.mesh.routing import series_route_key

log = logging.getLogger("foremast_tpu_torch.mesh")

HANDOFF_VERSION = 1

DEFAULT_DEADLINE_SECONDS = 30.0
DEFAULT_BATCH_BYTES = 1 << 20  # well under the receiver's 8 MiB body cap
DEFAULT_RETRIES = 2
DEFAULT_BACKOFF_SECONDS = 0.2
DEFAULT_TIMEOUT_SECONDS = 10.0

# transfer outcome label values (foremast_handoff_transfers{role,result})
SEND_RESULTS = ("ok", "failed", "rejected")
RECEIVE_RESULTS = ("ok", "rejected", "torn", "duplicate")


def fit_route_key(name: str, key, value) -> str | None:
    """The route key (app) a fit-cache entry belongs to, per cache (the
    worker's key shapes). None = no partition identity: the entry stays
    and the new owner cold-refits it."""
    try:
        if name == "fits":  # (algo, season, "app|alias|url")
            return key[2].split("|", 1)[0] or None
        if name == "gaps":  # "app|alias|url"
            return key.split("|", 1)[0] or None
        if name == "joint":  # (mode, app, ...)
            return key[1] or None
        if name == "jmeta":  # ("jmeta", mode, app, ...)
            return key[2] or None
        if name == "refine":  # ("uni", (algo, season, "app|alias|url")) | ("joint", doc)
            if key[0] == "uni":
                return key[1][2].split("|", 1)[0] or None
            return (value or {}).get("app") or None
    except (TypeError, IndexError, KeyError, AttributeError):
        return None
    return None


def _wire_value(v):
    """A cache value as it goes on the wire: tensors become numpy, and
    NamedTuples (the LSTM-AE parameter trees) the dict-of-dicts layout."""
    if hasattr(v, "_fields") and isinstance(v, tuple):
        return {f: _wire_value(x) for f, x in zip(v._fields, v)}
    if isinstance(v, tuple):
        return tuple(_wire_value(x) for x in v)
    if isinstance(v, list):
        return [_wire_value(x) for x in v]
    if isinstance(v, dict):
        return {k: _wire_value(x) for k, x in v.items()}
    if type(v).__module__.startswith("torch") and hasattr(v, "numpy"):
        return v.detach().cpu().numpy()
    return v


def _host_array(fun, args, arr_state, aval_state):
    """Rebuild a pickled JAX array as the numpy array it wraps."""
    value = fun(*args)
    value.__setstate__(arr_state)
    return value


# what a transfer record may name besides the port's own record types:
# numpy's array, scalar and dtype reconstruction, and plain builtins and
# containers. The endpoint faces the network, so nothing else resolves
_NUMPY_MODULES = frozenset({"numpy", "numpy.core.multiarray", "numpy._core.multiarray",
                            "numpy.core.numeric", "numpy._core.numeric"})
_NUMPY_NAMES = frozenset({"_reconstruct", "_frombuffer", "scalar", "ndarray", "dtype"})
_PLAIN_NAMES = {
    "builtins": frozenset({"bool", "int", "float", "complex", "str", "bytes", "bytearray", "tuple", "list",
                           "dict", "set", "frozenset", "slice", "range"}),
    "collections": frozenset({"OrderedDict", "defaultdict", "deque"}),
}


class _TransferUnpickler(pickle.Unpickler):
    """Reads transfer records from either package, resolving an
    allow-list: the JAX package's classes resolve to the port's module of
    the same name, its arrays to numpy; of the port's modules only record
    types (NamedTuples and dataclasses) resolve. Any other global, JAX's
    or a callable such as `os.system`, fails the record (kept as a tear)."""

    def find_class(self, module, name):
        if module == "jax._src.array" and name == "_reconstruct_array":
            return _host_array
        root = module.split(".", 1)[0]
        if root == "foremast_tpu":
            module, root = "foremast_tpu_torch" + module[len(root):], "foremast_tpu_torch"
        if root == "foremast_tpu_torch":
            obj = super().find_class(module, name)
            if isinstance(obj, type) and (issubclass(obj, tuple) or dataclasses.is_dataclass(obj)):
                return obj
        elif ((module in _NUMPY_MODULES and name in _NUMPY_NAMES) or name in _PLAIN_NAMES.get(module, ())
              or (module == "numpy.dtypes" and name.endswith("DType"))):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(f"transfer record needs {module}.{name}")


def _loads(payload: bytes):
    return _TransferUnpickler(io.BytesIO(payload)).load()


class HandoffManager:
    """One worker's handoff plane: sender, receiver, and the joining /
    draining bookkeeping. Thread-safe: the receiver's handler threads
    apply inbound transfers while the tick side streams outbound ones."""

    def __init__(
        self,
        ring_store=None,  # ingest.shards.RingStore (optional)
        route_label: str = "app",
        deadline_seconds: float | None = None,
        batch_bytes: int = DEFAULT_BATCH_BYTES,
        retries: int = DEFAULT_RETRIES,
        backoff_seconds: float = DEFAULT_BACKOFF_SECONDS,
        timeout: float = DEFAULT_TIMEOUT_SECONDS,
        chaos=None,  # chaos.EdgeChaos of the "transfer" edge
        breaker=None,  # chaos.CircuitBreaker of the "transfer" edge
        clock=time.time,
        sleep=time.sleep,
        rng=None,
    ):
        if deadline_seconds is None:
            deadline_seconds = float(
                os.environ.get("FOREMAST_HANDOFF_DEADLINE_SECONDS", "") or DEFAULT_DEADLINE_SECONDS
            )
        self.ring_store = ring_store
        self.route_label = route_label
        self.deadline_seconds = float(deadline_seconds)
        self.batch_bytes = int(batch_bytes)
        self.retries = max(0, int(retries))
        self.backoff_seconds = float(backoff_seconds)
        self.timeout = float(timeout)
        self.chaos = chaos
        self.breaker = breaker
        self._clock = clock
        self._sleep = sleep
        self._rng = rng or random.Random()
        # name -> ModelCache / RefineBook (BrainWorker.attach_handoff)
        self.fit_caches: dict[str, object] = {}
        self._lock = threading.Lock()
        self.counters = {
            "series_sent": 0,
            "series_received": 0,
            "fits_sent": 0,
            "fits_received": 0,
            "send": dict.fromkeys(SEND_RESULTS, 0),
            "receive": dict.fromkeys(RECEIVE_RESULTS, 0),
        }
        # receiver side: series applied by a transfer, kept from
        # evict_unowned until the claim ring catches up (TTL 2x deadline)
        self._protected: dict[str, float] = {}
        # joiner side: senders whose `done` arrived, and who we wait on
        self._done_from: set[str] = set()
        self._join_expected: set[str] | None = None
        self._join_deadline: float | None = None
        self._join_started: float | None = None
        self.join_wait_seconds: float | None = None
        # sender side: joiners already streamed to (a failed send counts as
        # served: the joiner's deadline owns the degradation)
        self._served: set[str] = set()
        # membership fingerprint at the last note_members: a set that moves
        # under an in-flight join re-streams the served joiners
        self._members_fp: tuple | None = None

    # -- cache registration -----------------------------------------------

    def register_caches(self, caches: dict) -> None:
        """Attach the caches the sender enumerates (`persistable_snapshot`)
        and the receiver applies into (`put_many`, else `restore_lazy`)."""
        self.fit_caches = dict(caches)

    # -- counters ----------------------------------------------------------

    def _count(self, key: str, n: int = 1) -> None:
        with self._lock:
            self.counters[key] += n

    def _count_result(self, role: str, result: str, n: int = 1) -> None:
        with self._lock:
            self.counters[role][result] += n

    # -- eviction protection -----------------------------------------------

    def protect(self, keys) -> None:
        deadline = self._clock() + 2.0 * self.deadline_seconds
        with self._lock:
            for k in keys:
                self._protected[k] = deadline

    def is_protected(self, key: str) -> bool:
        with self._lock:
            dl = self._protected.get(key)
            if dl is None:
                return False
            if self._clock() > dl:
                del self._protected[key]
                return False
            return True

    def purge_protected(self, now: float | None = None) -> None:
        now = self._clock() if now is None else now
        with self._lock:
            for k in [k for k, dl in self._protected.items() if now > dl]:
                del self._protected[k]

    # -- join fencing --------------------------------------------------------

    def begin_join(self, expected_senders: set[str]) -> None:
        """Arm the joiner: it activates on a `done` from every member of
        `expected_senders` (the active set at join time), or at the
        deadline, whichever comes first."""
        now = self._clock()
        with self._lock:
            self._join_expected = set(expected_senders)
            self._join_started = now
            self._join_deadline = now + self.deadline_seconds

    def join_ready(self, live_active_ids: set[str]) -> bool:
        """Whether the fenced joiner may activate: every expected sender
        still alive and active has sent its `done` (a sender that died or
        left is discounted), or the deadline passed."""
        now = self._clock()
        with self._lock:
            if self._join_expected is None:
                return True
            pending = (self._join_expected & live_active_ids) - self._done_from
            if not pending:
                self.join_wait_seconds = now - (self._join_started or now)
                self._join_expected = None
                return True
            if self._join_deadline is not None and now >= self._join_deadline:
                log.warning(
                    "handoff join deadline (%.1fs) passed with %d sender(s) pending (%s); activating anyway: "
                    "missing state cold-refits through the rebalance path",
                    self.deadline_seconds, len(pending), sorted(pending),
                )
                self.join_wait_seconds = now - (self._join_started or now)
                self._join_expected = None
                return True
            return False

    def join_pending(self) -> bool:
        with self._lock:
            return self._join_expected is not None

    # -- sender side -----------------------------------------------------------

    def note_members(self, members: list[MemberRecord]) -> None:
        """Prune the served set against the live view; when the member set
        moves under an in-flight join, re-queue every served joiner for a
        fresh (idempotent) stream."""
        joining = {m.worker_id for m in members if m.state == STATE_JOINING}
        fingerprint = tuple(sorted((m.worker_id, m.state) for m in members))
        with self._lock:
            self._served &= joining
            if fingerprint != self._members_fp:
                self._members_fp = fingerprint
                self._served.clear()

    def pending_joiners(self, members: list[MemberRecord], self_id: str) -> list[MemberRecord]:
        with self._lock:
            served = set(self._served)
        return [
            m
            for m in members
            if m.state == STATE_JOINING and m.worker_id != self_id and m.worker_id not in served and m.ingest_address
        ]

    def mark_served(self, worker_id: str) -> None:
        with self._lock:
            self._served.add(worker_id)

    def _moving_records(self, router, target_ids: set):
        """Yield ``(target_id, record)`` for every record this member
        streams to a target in `target_ids`: resident ring series first
        (consistent column copies, one pass over the shards however many
        targets), then fit-cache entries. Claim-owned here, target-owned
        there."""
        ring = self.ring_store
        if ring is not None:
            for i in range(ring.shard_count):
                for key, t, v, cf, ct, older in ring.shard_state(i):
                    tid = router.transfer_target(series_route_key(key, self.route_label))
                    if tid not in target_ids:
                        continue
                    spans = [list(iv) for iv in older]
                    if cf is not None or ct is not None:
                        spans.append([cf, ct])
                    yield tid, ("series", key, t, v, spans)
        for name, cache in self.fit_caches.items():
            snap = getattr(cache, "persistable_snapshot", None)
            if snap is None:
                continue
            for key, value in snap().items():
                rk = fit_route_key(name, key, value)
                if rk is None:
                    continue
                tid = router.transfer_target(rk)
                if tid not in target_ids:
                    continue
                yield tid, ("fit", name, key, _wire_value(value))

    def _post(self, address: str, body: bytes) -> None:
        """One framed batch over the wire: the choke point the chaos seam
        and the breaker guard."""
        if self.breaker is not None:
            self.breaker.allow()  # raises BreakerOpen: fail fast
        try:
            if self.chaos is not None:
                self.chaos.perturb(address)
            req = urllib.request.Request(
                f"http://{address}{TRANSFER_PATH}",
                data=body,
                method="POST",
                headers={"Content-Type": "application/octet-stream"},
            )
            with urllib.request.urlopen(req, timeout=self.timeout):
                pass
        except Exception:
            if self.breaker is not None:
                self.breaker.record_failure()
            raise
        if self.breaker is not None:
            self.breaker.record_success()

    def _post_with_retry(self, address: str, body: bytes) -> str:
        """POST with jittered exponential backoff on transient failures;
        returns ``"ok"``, ``"rejected"`` (a hard 4xx, counted here) or
        ``"failed"`` (retries exhausted; the caller counts it)."""
        from foremast_tpu_torch.chaos.degrade import is_transient_error

        for attempt in range(self.retries + 1):
            try:
                self._post(address, body)
                return "ok"
            except urllib.error.HTTPError as e:
                code = e.code
                e.close()
                if code < 500 and code != 429:
                    self._count_result("send", "rejected")
                    log.warning("handoff transfer to %s rejected (HTTP %d); abandoning: the receiver cold-refits",
                                address, code)
                    return "rejected"
            except Exception as e:  # noqa: BLE001 - classified below
                if not is_transient_error(e):
                    raise
            if attempt == self.retries:
                return "failed"
            delay = self.backoff_seconds * (2.0**attempt)
            self._sleep(delay * (0.5 + self._rng.random()))
        return "failed"

    def send_to(self, record: MemberRecord, router, self_id: str) -> bool:
        """Stream what the planned change moves from this member to one
        target; True when every batch landed."""
        return self.send_all([record], router, self_id)[record.worker_id]

    def send_all(self, records: list[MemberRecord], router, self_id: str) -> dict[str, bool]:
        """Stream what the planned change moves from this member to EVERY
        target in `records`, enumerating the ring and the caches once and
        bucketing records by target. Each target gets bounded batches
        ending with its own ``done`` marker; a target whose batch fails
        gets nothing more. Returns per-target landed flags."""

        def frame(buf, rec) -> None:
            append_record(buf, pickle.dumps(rec, protocol=pickle.HIGHEST_PROTOCOL))

        streams = {}
        for record in records:
            buf = io.BytesIO()
            frame(buf, ("hello", HANDOFF_VERSION, self_id))
            streams[record.worker_id] = {"record": record, "buf": buf, "series": 0, "fits": 0, "outcome": None}

        def flush(s) -> None:
            body = s["buf"].getvalue()
            s["buf"] = io.BytesIO()
            frame(s["buf"], ("hello", HANDOFF_VERSION, self_id))
            result = self._post_with_retry(s["record"].ingest_address, body)
            if result != "ok":
                s["outcome"] = result

        for tid, rec in self._moving_records(router, set(streams)):
            s = streams[tid]
            if s["outcome"] is not None:  # this target already failed
                continue
            s["series" if rec[0] == "series" else "fits"] += 1
            frame(s["buf"], rec)
            if s["buf"].tell() >= self.batch_bytes:
                flush(s)
        for tid, s in streams.items():
            if s["outcome"] is None:
                frame(s["buf"], ("done", self_id, s["series"], s["fits"]))
                flush(s)
            if s["outcome"] is None:
                s["outcome"] = "ok"
                self._count("series_sent", s["series"])
                self._count("fits_sent", s["fits"])
                self._count_result("send", "ok")
                log.info("handoff: streamed %d series / %d fit(s) to %s (%s)",
                         s["series"], s["fits"], tid, s["record"].ingest_address)
            elif s["outcome"] == "failed":
                # a rejected batch was counted at the POST
                self._count_result("send", "failed")
                log.warning("handoff transfer to %s (%s) failed after retries; abandoned: %s cold-refits the "
                            "moved partition", tid, s["record"].ingest_address, tid)
        return {tid: s["outcome"] == "ok" for tid, s in streams.items()}

    # -- receiver side ---------------------------------------------------------

    def apply_transfer(self, raw: bytes) -> tuple[int, dict]:
        """Apply one framed transfer batch (the ``/api/v1/transfer`` body);
        returns (http_status, body). A torn or undecodable record keeps the
        applied prefix; a missing or mismatched hello rejects the batch
        (400) with nothing applied."""
        n_series = n_fits = 0
        torn = done = False
        sender = None
        fit_batches: dict[str, list] = {}
        protected: list[str] = []
        first = True
        for payload, reason in read_record_stream(io.BytesIO(raw)):
            if reason is not None:
                torn = True
                break
            try:
                rec = _loads(payload)
                kind = rec[0]
                if first:
                    if kind != "hello" or int(rec[1]) != HANDOFF_VERSION:
                        self._count_result("receive", "rejected")
                        log.warning("handoff transfer rejected: %s", "missing hello frame" if kind != "hello"
                                    else f"version {rec[1]} (want {HANDOFF_VERSION})")
                        return 400, {"reason": "handoff version mismatch", "want": HANDOFF_VERSION}
                    sender = str(rec[2])
                    first = False
                    continue
                if kind == "series":
                    _, key, t, v, spans = rec
                    self._apply_series(key, t, v, spans)
                    protected.append(key)
                    n_series += 1
                elif kind == "fit":
                    _, name, fkey, value = rec
                    fit_batches.setdefault(name, []).append((fkey, value))
                    n_fits += 1
                elif kind == "done":
                    sender = str(rec[1])
                    done = True
            except Exception as e:  # noqa: BLE001 - one bad record
                torn = True
                log.warning("handoff transfer: undecodable record (%s); keeping the applied prefix", e)
                break
        if first:
            # no intact hello decoded: nothing in the batch is trusted
            self._count_result("receive", "rejected")
            return 400, {"reason": "missing hello frame"}
        for name, items in fit_batches.items():
            self._apply_fits(name, items)
        if protected:
            self.protect(protected)
        duplicate = False
        if done and sender is not None:
            with self._lock:
                duplicate = sender in self._done_from
                self._done_from.add(sender)
        self._count("series_received", n_series)
        self._count("fits_received", n_fits)
        self._count_result("receive", "torn" if torn else ("duplicate" if duplicate else "ok"))
        if torn:
            log.warning("handoff transfer torn mid-stream: applied %d series / %d fit(s), the rest cold-refits",
                        n_series, n_fits)
        return 200, {"applied_series": n_series, "applied_fits": n_fits, "torn": torn, "done": done}

    def _apply_series(self, key: str, t, v, spans) -> None:
        """Replay one transferred series through the push path: the older
        coverage spans first as empty backfills, then the columns under the
        head span (the snapshot restore's order)."""
        ring = self.ring_store
        if ring is None:
            return
        t = np.asarray(t, np.int64)
        v = np.asarray(v, np.float32)
        spans = list(spans or ())
        head = spans[-1] if spans else (None, None)
        for iv in spans[:-1]:
            try:
                f0, f1 = float(iv[0]), float(iv[1])
            except (TypeError, ValueError, IndexError):
                continue
            ring.push(key, (), (), start=f0, end=f1, record_lag=False)
        cf = None if head[0] is None else float(head[0])
        ct = None if head[1] is None else float(head[1])
        ring.push(key, t, v, start=cf, end=ct, record_lag=False)

    def _apply_fits(self, name: str, items: list) -> None:
        cache = self.fit_caches.get(name)
        if cache is None:
            return
        put_many = getattr(cache, "put_many", None)
        if put_many is not None:
            put_many(items)
            return
        restore = getattr(cache, "restore_lazy", None)
        if restore is not None:
            restore(dict(items))

    # -- observability -----------------------------------------------------------

    def counters_snapshot(self) -> dict:
        with self._lock:
            out = dict(self.counters)
            out["send"] = dict(self.counters["send"])
            out["receive"] = dict(self.counters["receive"])
            return out

    def debug_state(self) -> dict:
        with self._lock:
            return {
                "series_sent": self.counters["series_sent"],
                "series_received": self.counters["series_received"],
                "fits_sent": self.counters["fits_sent"],
                "fits_received": self.counters["fits_received"],
                "send": dict(self.counters["send"]),
                "receive": dict(self.counters["receive"]),
                "join_pending": self._join_expected is not None,
                "join_wait_seconds": (
                    round(self.join_wait_seconds, 3) if self.join_wait_seconds is not None else None
                ),
                "done_from": sorted(self._done_from),
                "protected_series": len(self._protected),
                "deadline_seconds": self.deadline_seconds,
            }
