"""Durable ring state: per-shard column snapshots + append logs.

The port's copy of the JAX package's `foremast_tpu/ingest/snapshot.py`,
on the same on-disk format (the npz snapshot layout, the crc-framed log
records and their pickled payloads), so a directory written by either
package restores in the other. The record framing also carries the
worker's fit journals (`models.cache.FitJournal`).

The ingest plane made the data plane stateful — a worker restart used
to mean a fleet-wide cold start (every series re-fetched over HTTP,
every history re-uploaded). This module makes restarts warm: under
`FOREMAST_SNAPSHOT_DIR` each ring shard gets

  * a SNAPSHOT file (``ring-<i>.snap.npz``): the shard's resident
    series as raw int64/float32 columns plus their
    ``covered_from``/``covered_to`` watermarks, written to a temp file
    and published with one atomic ``os.replace`` — a reader never sees
    a half-written snapshot under its final name;
  * an APPEND LOG (``ring-<i>.log``): every push between snapshots,
    one crc-framed record each, flushed at write time so the bytes
    survive a SIGKILL (page cache outlives the process; only power
    loss needs fsync, which judgment data does not warrant).

`RingSnapshotter.restore()` replays snapshot + log into a fresh
`RingStore` through the store's own `push` (so budget accounting,
eviction, and coverage semantics are the production ones), applies the
snapshot-age cutoff, and DEGRADES PER SERIES: a torn log tail, a
version-mismatched header, a truncated snapshot file, or one broken
series inside an otherwise healthy snapshot each discard only the
affected state — counted on the `foremast_snapshot_*` families, never
a crash. A discarded series simply cold-fits through the existing
fallback path on its next fetch.

Snapshot ordering is crash-consistent without fsync barriers: the
current log is first ROTATED aside to a fresh ``.log.old.<N>``
generation (ratcheting — an earlier crash's rotated log is never
clobbered), a new log opened, THEN the shard state captured and the
snapshot renamed into place, and only then ALL rotated generations
deleted. A crash between any two steps leaves a state where
{latest durable snapshot} + {rotated generations, oldest first} +
{live log} together hold every journaled push — restore replays them
in exactly that order, and the ring's last-write-wins merge makes
double-applied samples a no-op.
"""

from __future__ import annotations

import json
import logging
import os
import pickle
import re
import struct
import threading
import time
import zlib

import numpy as np

from foremast_tpu_torch.ingest.shards import RingStore

log = logging.getLogger("foremast_tpu_torch.ingest")

SNAP_VERSION = 1
_LOG_MAGIC = b"FMRL"
# magic(4) + payload_len(u32) + crc32(u32)
_LOG_HEADER = struct.Struct("<4sII")

DEFAULT_INTERVAL_SECONDS = 60.0
DEFAULT_MAX_AGE_SECONDS = 86_400.0
DEFAULT_LOG_MAX_BYTES = 64 * 1024 * 1024

# discard reasons (the `foremast_snapshot_discards{reason}` label set);
# fit-journal reasons live here too so one family covers the data plane
DISCARD_REASONS = (
    "version",        # snapshot header from a different format version
    "unreadable",     # snapshot file truncated/corrupt past np.load
    "series",         # one series' arrays inconsistent (mid-eviction
                      # capture, external corruption) — that series only
    "stale",          # covered_to older than the restore age cutoff
    "torn_log",       # append-log tail cut mid-record (crash mid-write)
    "fit_unreadable", # fit-journal snapshot unreadable
    "fit_torn",       # fit-journal log tail cut mid-record
)


def _empty_discards() -> dict:
    return dict.fromkeys(DISCARD_REASONS, 0)


# ---------------------------------------------------------------------------
# crc-framed append-log records (shared with models.cache.FitJournal)
# ---------------------------------------------------------------------------


def append_record(fh, payload: bytes) -> int:
    """Frame + append one payload; returns bytes written. The caller
    holds whatever lock serializes the file handle."""
    header = _LOG_HEADER.pack(_LOG_MAGIC, len(payload), zlib.crc32(payload))
    fh.write(header + payload)
    fh.flush()  # page cache now owns the bytes: SIGKILL-safe
    return len(header) + len(payload)


def read_record_stream(fh):
    """Yield (payload, None) per intact record from an open binary
    stream, then (None, "torn_log") once if the tail is torn — short
    header/payload, bad magic, crc mismatch. Everything BEFORE the
    first bad frame is served; nothing after it is trusted (a corrupt
    length field would desync every later frame)."""
    while True:
        header = fh.read(_LOG_HEADER.size)
        if not header:
            return  # clean EOF
        if len(header) < _LOG_HEADER.size:
            yield None, "torn_log"
            return
        magic, length, crc = _LOG_HEADER.unpack(header)
        if magic != _LOG_MAGIC:
            yield None, "torn_log"
            return
        payload = fh.read(length)
        if len(payload) < length or zlib.crc32(payload) != crc:
            yield None, "torn_log"
            return
        yield payload, None


def read_records(path: str):
    """`read_record_stream` over a file path (missing file = no records)."""
    try:
        fh = open(path, "rb")
    except OSError:
        return
    with fh:
        yield from read_record_stream(fh)


def rotated_logs(base_path: str) -> list[str]:
    """Every ``<base>.old.<N>`` generation, oldest first — the replay
    order that reproduces the original append order across crashes."""
    d = os.path.dirname(os.path.abspath(base_path)) or "."
    prefix = os.path.basename(base_path) + ".old."
    out = []
    try:
        names = os.listdir(d)
    except OSError:
        return []
    for name in names:
        if name.startswith(prefix):
            tail = name[len(prefix):]
            if tail.isdigit():
                out.append((int(tail), os.path.join(d, name)))
    return [p for _, p in sorted(out)]


def lock_snapshot_dir(directory: str):
    """Advisory EXCLUSIVE lock on a snapshot directory: two live
    workers appending to the same shard logs through independent
    buffered handles would interleave torn frames. Returns an open handle — keep it
    referenced for the process lifetime — or None when another LIVE
    process holds the directory. flock releases on process death,
    SIGKILL included, so a crashed worker's replacement acquires it
    immediately; only a genuinely concurrent second worker is
    refused."""
    import fcntl

    os.makedirs(directory, exist_ok=True)
    fh = open(os.path.join(directory, ".lock"), "a+")
    try:
        fcntl.flock(fh.fileno(), fcntl.LOCK_EX | fcntl.LOCK_NB)
    except OSError:
        fh.close()
        return None
    return fh


def atomic_write(path: str, data: bytes) -> None:
    """Write bytes to a temp file in the target directory, then
    os.replace into place — readers see the old file or the new one,
    never a prefix."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as fh:
            fh.write(data)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


# ---------------------------------------------------------------------------
# the snapshotter
# ---------------------------------------------------------------------------


class _ShardLog:
    """One shard's append log: a lock + a lazily opened handle."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        self._fh = None
        self.bytes = 0

    def append(self, payload: bytes) -> None:
        # this lock EXISTS to serialize the file handle — the held I/O
        # is the critical section's whole job, and the write is a
        # page-cache append (microseconds; module docstring)
        with self._lock:
            if self._fh is None:
                os.makedirs(
                    os.path.dirname(os.path.abspath(self.path)),
                    exist_ok=True,
                )
                self._fh = open(self.path, "ab")  # foremast: ignore[blocking-under-lock] — the lock serializes this handle
                self.bytes = self._fh.tell()
            # foremast: ignore[blocking-under-lock] — the lock serializes this handle
            self.bytes += append_record(self._fh, payload)

    def rotate(self) -> str | None:
        """Move the live log aside to a FRESH ``.old.<N>`` generation
        and start a new log; returns the rotated path (None when there
        was nothing). Generations ratchet: an earlier crash's rotated
        log (not yet folded into a durable snapshot) must never be
        clobbered by the next rotation — restore replays every
        generation in order, and only a COMPLETED snapshot pass deletes
        them. Called only from the snapshot path; pushes landing
        mid-rotate simply go to the fresh log."""
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None
            self.bytes = 0
            if not os.path.exists(self.path):
                return None
            n = 0
            for old in rotated_logs(self.path):
                n = max(n, int(old.rsplit(".", 1)[1]) + 1)
            target = f"{self.path}.old.{n}"
            # the rename must be atomic against concurrent append()
            # reopening the live log — same handle-serializing lock
            os.replace(self.path, target)  # foremast: ignore[blocking-under-lock] — atomic against append()
            return target

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None


class RingSnapshotter:
    """Snapshot/restore + write-ahead journaling for one `RingStore`.

    Lifecycle (the order matters — see `restore`): construct against a
    FRESH store, `restore()` once, then `attach()` so live pushes
    journal; `maybe_snapshot()` from the tick loop turns the log into
    bounded-size snapshots. All files live under `directory`.
    """

    def __init__(
        self,
        store: RingStore,
        directory: str,
        interval_seconds: float = DEFAULT_INTERVAL_SECONDS,
        max_age_seconds: float = DEFAULT_MAX_AGE_SECONDS,
        log_max_bytes: int = DEFAULT_LOG_MAX_BYTES,
        clock=time.time,
    ):
        self.store = store
        self.directory = directory
        self.interval_seconds = float(interval_seconds)
        self.max_age_seconds = float(max_age_seconds)
        self.log_max_bytes = int(log_max_bytes)
        self._clock = clock
        # counters/_last_snapshot guard (held only for metadata reads/
        # writes — a scrape must never wait on snapshot file I/O) and a
        # separate pass mutex serializing whole snapshot passes
        self._lock = threading.Lock()
        self._pass_lock = threading.Lock()
        self._last_snapshot = 0.0
        n = store.shard_count
        self._logs = [
            _ShardLog(os.path.join(directory, f"ring-{i}.log"))
            for i in range(n)
        ]
        self.counters = {
            "snapshots": 0,
            "restored_series": 0,
            "restored_samples": 0,
            "discards": _empty_discards(),
        }
        self._log_warned: set[int] = set()
        os.makedirs(directory, exist_ok=True)

    @staticmethod
    def from_env(store: RingStore, directory: str, env=None) -> "RingSnapshotter":
        e = os.environ if env is None else env
        return RingSnapshotter(
            store,
            directory,
            interval_seconds=float(
                e.get("FOREMAST_SNAPSHOT_INTERVAL_SECONDS", "")
                or DEFAULT_INTERVAL_SECONDS
            ),
            max_age_seconds=float(
                e.get("FOREMAST_SNAPSHOT_MAX_AGE_SECONDS", "")
                or DEFAULT_MAX_AGE_SECONDS
            ),
            log_max_bytes=int(
                e.get("FOREMAST_SNAPSHOT_LOG_MAX_BYTES", "")
                or DEFAULT_LOG_MAX_BYTES
            ),
        )

    # -- journaling (the store's push hook) -----------------------------

    def attach(self) -> None:
        """Start journaling live pushes. Call AFTER `restore()` — the
        restore path replays through `store.push`, and journaling those
        replays would double every restart's log."""
        self.store.journal = self._journal

    def detach(self) -> None:
        if self.store.journal is self._journal:
            self.store.journal = None

    def _journal(self, shard_index, key, times, values, start, end) -> None:
        payload = pickle.dumps(
            (
                key,
                np.asarray(times, np.int64),
                np.asarray(values, np.float32),
                None if start is None else float(start),
                None if end is None else float(end),
            ),
            protocol=pickle.HIGHEST_PROTOCOL,
        )
        try:
            self._logs[shard_index].append(payload)
        except OSError as e:
            # a full/broken snapshot disk must degrade durability (the
            # next restart is colder), never the live push plane; one
            # warning per shard, not one per push
            if shard_index not in self._log_warned:
                self._log_warned.add(shard_index)
                log.warning(
                    "ring append log for shard %d unwritable (%s); "
                    "pushes continue UNJOURNALED — the next restart "
                    "cold-fits whatever the last snapshot misses",
                    shard_index, e,
                )

    # -- snapshot --------------------------------------------------------

    def _snap_path(self, i: int) -> str:
        return os.path.join(self.directory, f"ring-{i}.snap.npz")

    def snapshot(self) -> int:
        """Write every shard's resident state; returns series written.
        See the module docstring for the crash-consistent ordering."""
        written = 0
        # _pass_lock exists to serialize whole snapshot passes — file
        # I/O held under it is the design (counters/_lock stay free so
        # scrapes never wait on disk); nothing else ever contends here
        with self._pass_lock:  # one pass at a time; I/O outside _lock
            for i in range(self.store.shard_count):
                self._logs[i].rotate()  # foremast: ignore[blocking-under-lock] — _pass_lock serializes passes
                state = self.store.shard_state(i)
                arrays: dict[str, np.ndarray] = {
                    "version": np.asarray([SNAP_VERSION], np.int64),
                }
                keys = []
                cov = np.empty((len(state), 2), np.float64)
                extras: dict[str, list] = {}
                for j, (key, t, v, cf, ct, ivs) in enumerate(state):
                    keys.append(key)
                    arrays[f"t{j}"] = t
                    arrays[f"v{j}"] = v
                    cov[j, 0] = np.nan if cf is None else cf
                    cov[j, 1] = np.nan if ct is None else ct
                    if ivs:
                        extras[str(j)] = [list(iv) for iv in ivs]
                arrays["cov"] = cov
                if extras:
                    # older disjoint coverage spans (historical
                    # backfills living next to the live push stream) —
                    # absent on pre-multi-interval snapshots, so the
                    # format stays version-1 compatible both ways
                    arrays["cove"] = np.frombuffer(
                        json.dumps(extras).encode(), np.uint8
                    )
                arrays["keys"] = np.frombuffer(
                    json.dumps(keys).encode(), np.uint8
                )
                import io

                buf = io.BytesIO()
                np.savez(buf, **arrays)
                atomic_write(self._snap_path(i), buf.getvalue())  # foremast: ignore[blocking-under-lock] — as rotate
                # the snapshot is durably in place: every rotated
                # generation it subsumes (including any left by
                # earlier crashed passes) can finally go
                for old in rotated_logs(self._logs[i].path):
                    os.unlink(old)
                written += len(state)
            with self._lock:
                self.counters["snapshots"] += 1
                self._last_snapshot = self._clock()
        return written

    def maybe_snapshot(self, now: float | None = None) -> bool:
        """Tick-cadence trigger: snapshot when the interval elapsed or
        any shard's log outgrew the replay budget."""
        now = self._clock() if now is None else now
        with self._lock:
            due = now - self._last_snapshot >= self.interval_seconds
        if not due:
            due = any(
                logf.bytes > self.log_max_bytes for logf in self._logs
            )
        if not due:
            return False
        self.snapshot()
        return True

    # -- restore ---------------------------------------------------------

    def _discard(self, reason: str, n: int = 1) -> None:
        with self._lock:
            self.counters["discards"][reason] += n

    def _disk_shard_indices(self) -> set[int]:
        """Every shard index that has state on disk (snapshot, live
        log, or rotated generation) — possibly written by a run with a
        different shard count."""
        out: set[int] = set()
        try:
            names = os.listdir(self.directory)
        except OSError:
            return out
        for name in names:
            m = re.match(r"ring-(\d+)\.(snap\.npz|log(\.old\.\d+)?)$", name)
            if m:
                out.add(int(m.group(1)))
        return out

    def restore(self, now: float | None = None) -> dict:
        """Replay snapshot + log into the (fresh) store. Returns the
        restore stats also kept on `self.counters`. Never raises on bad
        input files — every failure mode degrades to cold state for the
        affected series/shard and a discard counter."""
        now = self._clock() if now is None else now
        cutoff = now - self.max_age_seconds
        series = 0
        samples = 0
        # replay every shard index present ON DISK, not just the
        # store's current shard count: replay re-hashes keys through
        # store.push anyway, so files written under a different
        # FOREMAST_INGEST_SHARDS (an operator retuning across the very
        # restart durability exists for) restore fine — skipping them
        # would silently lose durable state with no discard counter
        for i in sorted(
            set(range(self.store.shard_count)) | self._disk_shard_indices()
        ):
            n_series, n_samples = self._restore_snapshot(
                self._snap_path(i), cutoff
            )
            series += n_series
            samples += n_samples
            # rotated generations first, oldest to newest (crashes
            # mid-snapshot leave them behind — possibly several), then
            # the live log; double-applied samples merge last-write-wins
            base = os.path.join(self.directory, f"ring-{i}.log")
            for path in rotated_logs(base) + [base]:
                samples += self._replay_log(path, cutoff)
        # series restored = what is RESIDENT after replay (the log can
        # create series no snapshot ever captured — a worker killed
        # before its first snapshot pass restores from log alone)
        series = max(series, self.store.stats()["series"])
        with self._lock:
            self.counters["restored_series"] = series
            self.counters["restored_samples"] = samples
            discards = dict(self.counters["discards"])
        log.info(
            "ring restore: %d series / %d samples from %s (discards: %s)",
            series,
            samples,
            self.directory,
            {k: v for k, v in discards.items() if v},
        )
        return {
            "restored_series": series,
            "restored_samples": samples,
            "discards": discards,
        }

    def _restore_snapshot(self, path: str, cutoff: float) -> tuple[int, int]:
        if not os.path.exists(path):
            return 0, 0
        try:
            with np.load(path, allow_pickle=False) as z:
                version = int(z["version"][0])
                if version != SNAP_VERSION:
                    self._discard("version")
                    log.warning(
                        "snapshot %s is version %d (want %d); discarded",
                        path, version, SNAP_VERSION,
                    )
                    return 0, 0
                keys = json.loads(bytes(z["keys"]).decode())
                cov = np.asarray(z["cov"], np.float64)
                extras: dict = {}
                if "cove" in z.files:
                    try:
                        extras = json.loads(bytes(z["cove"]).decode())
                    except Exception:  # noqa: BLE001 — optional block
                        extras = {}
                data = {}
                for j in range(len(keys)):
                    tn, vn = f"t{j}", f"v{j}"
                    if tn in z.files and vn in z.files:
                        data[j] = (z[tn], z[vn])
        except Exception as e:  # noqa: BLE001 — torn/corrupt file
            self._discard("unreadable")
            log.warning("snapshot %s unreadable (%s); discarded", path, e)
            return 0, 0
        series = 0
        samples = 0
        for j, key in enumerate(keys):
            try:
                t, v = data[j]
                t = np.asarray(t, np.int64)
                v = np.asarray(v, np.float32)
                if t.ndim != 1 or v.ndim != 1 or len(t) != len(v):
                    raise ValueError("column shape mismatch")
                if j >= len(cov):
                    raise ValueError("coverage row missing")
                cf = None if np.isnan(cov[j, 0]) else float(cov[j, 0])
                ct = None if np.isnan(cov[j, 1]) else float(cov[j, 1])
            except (KeyError, ValueError, TypeError) as e:
                # one broken series (a snapshot captured mid-eviction,
                # external corruption): cold-fit it, keep its shard
                self._discard("series")
                log.warning(
                    "snapshot %s: series %r broken (%s); discarded",
                    path, key, e,
                )
                continue
            if ct is not None and ct < cutoff:
                self._discard("stale")
                continue
            # older disjoint coverage spans re-assert through the push
            # path as empty authoritative batches, so a restored ring
            # keeps serving historical backfills without re-fetching
            # (the recovery tick's cold fits stay zero-HTTP).
            # Asserted BEFORE the sample push: when the restored ring is
            # smaller than the one snapshotted (max_points retuned down),
            # the sample push drops the oldest samples and its overwrite
            # clamp must clamp these spans too — re-asserting them after
            # would claim authority over ranges whose samples were just
            # discarded, serving truncated "full" histories instead of
            # degrading to the pull path
            for iv in extras.get(str(j), ()):
                try:
                    f0, f1 = float(iv[0]), float(iv[1])
                except (TypeError, ValueError, IndexError):
                    continue
                if f1 < cutoff:
                    continue  # aged out like any stale span
                self.store.push(
                    key, (), (), start=f0, end=f1, record_lag=False
                )
            self.store.push(
                key, t, v, start=cf, end=ct, record_lag=False
            )
            series += 1
            samples += len(t)
        return series, samples

    def _replay_log(self, path: str, cutoff: float) -> int:
        samples = 0
        for payload, reason in read_records(path):
            if reason is not None:
                self._discard(reason)
                log.warning(
                    "append log %s: torn tail; replayed the healthy "
                    "prefix only", path,
                )
                break
            try:
                key, t, v, start, end = pickle.loads(payload)
                # the age cutoff applies to the LOG too, or a worker
                # killed before its first snapshot pass would resurrect
                # week-old series the snapshot path is documented to
                # discard. A record's effective head = the newest thing
                # it vouches for (coverage end or newest sample).
                head = end
                if len(t):
                    newest = float(np.asarray(t, np.int64).max())
                    head = newest if head is None else max(head, newest)
                if head is not None and head < cutoff:
                    self._discard("stale")
                    continue
                samples += self.store.push(
                    key, t, v, start=start, end=end, record_lag=False
                )
            except Exception as e:  # noqa: BLE001 — one bad record
                self._discard("torn_log")
                log.warning(
                    "append log %s: undecodable record (%s); stopping "
                    "replay", path, e,
                )
                break
        return samples

    # -- lifecycle / observability --------------------------------------

    def close(self) -> None:
        self.detach()
        for logf in self._logs:
            logf.close()

    def stats(self) -> dict:
        """Locked copy of counters + snapshot age (scrape-thread safe —
        the collector and /debug/state both read through here)."""
        with self._lock:
            out = dict(self.counters)
            out["discards"] = dict(self.counters["discards"])
            out["age_seconds"] = (
                max(0.0, self._clock() - self._last_snapshot)
                if self._last_snapshot
                else None
            )
            return out

    def debug_state(self) -> dict:
        s = self.stats()
        return {
            "directory": self.directory,
            "interval_seconds": self.interval_seconds,
            "snapshots_written": s["snapshots"],
            "last_snapshot_age_seconds": (
                round(s["age_seconds"], 2)
                if s["age_seconds"] is not None
                else None
            ),
            "restored_series": s["restored_series"],
            "restored_samples": s["restored_samples"],
            "log_bytes": sum(lf.bytes for lf in self._logs),
            "discards": s["discards"],
        }


# ---------------------------------------------------------------------------
# Prometheus exposition
# ---------------------------------------------------------------------------


class SnapshotCollector:
    """prometheus_client custom collector over the durability plane:
    the ring snapshotter plus any fit journals (models.cache.FitJournal)
    — discards share one family so 'how much state did the restart
    lose' is a single query."""

    def __init__(self, snapshotter: RingSnapshotter | None = None, journals=()):
        self._snap = snapshotter
        self._journals = tuple(journals)

    def collect(self):
        from prometheus_client.core import (
            CounterMetricFamily,
            GaugeMetricFamily,
        )

        discards = _empty_discards()
        restored_series = 0
        restored_samples = 0
        snapshots = 0
        age = -1.0
        if self._snap is not None:
            c = self._snap.stats()
            for k, v in c["discards"].items():
                discards[k] += v
            restored_series = c["restored_series"]
            restored_samples = c["restored_samples"]
            snapshots = c["snapshots"]
            if c["age_seconds"] is not None:
                age = c["age_seconds"]
        restored_fits = 0
        for j in self._journals:
            js = j.stats()
            for k, v in js["discards"].items():
                discards[k] += v
            restored_fits += js["restored_entries"]
        fam = CounterMetricFamily(
            "foremast_snapshot_discards",
            "state discarded during snapshot restore, by reason "
            "(torn log tails, version-mismatched or unreadable "
            "snapshots, broken or age-expired series, fit-journal "
            "damage) — each degrades that state to a cold fit, never "
            "a crash",
            labels=["reason"],
        )
        for reason in DISCARD_REASONS:
            fam.add_metric([reason], discards[reason])
        yield fam
        yield GaugeMetricFamily(
            "foremast_snapshot_restored_series",
            "ring series restored by the last startup restore",
            value=restored_series,
        )
        yield GaugeMetricFamily(
            "foremast_snapshot_restored_samples",
            "ring samples restored by the last startup restore "
            "(snapshot + append-log replay)",
            value=restored_samples,
        )
        yield GaugeMetricFamily(
            "foremast_snapshot_restored_fits",
            "fitted-model cache entries restored by the last startup "
            "restore (rehydrated lazily on first claim)",
            value=restored_fits,
        )
        yield CounterMetricFamily(
            "foremast_snapshot_writes",
            "ring snapshot passes completed (all shards, atomic rename)",
            value=snapshots,
        )
        yield GaugeMetricFamily(
            "foremast_snapshot_age_seconds",
            "seconds since the last completed ring snapshot (-1 before "
            "the first)",
            value=age,
        )
