"""Bounded per-(service, metric) model cache with optional checkpointing.

The reference brain holds fitted models in a bounded in-memory cache
(`MAX_CACHE_SIZE`, `foremast-brain/README.md:30`) and recomputes on a
miss. This is the JAX package's `models/cache.py` `ModelCache` on the
host, unchanged in semantics: an LRU of fitted terminal state keyed by
(algorithm, season, fit key), with batched lookups, a write-through
`journal` hook and a lazily rehydrated restore overlay. The checkpoint
goes through `torch.save` instead of orbax.

Not ported yet (ROADMAP.md Queue 1, the worker slice): `FitJournal`.
"""

from __future__ import annotations

import os
import pickle
import tempfile
import threading
from collections import OrderedDict
from typing import Any, Hashable

import numpy as np
import torch

_MISS = object()  # sentinel: "not in the restored overlay"


class ModelCache:
    """Thread-safe LRU of fitted model state.

    Two optional durability hooks:

      * ``journal`` — a write-through callback invoked AFTER every
        mutation with the changed items (puts as ``(key, value)``,
        deletions as ``(key, None)`` with ``deleted=True``), outside
        the lock so journal I/O never extends lock holds;
      * ``restore_lazy(items)`` — stages a restored dict BESIDE the
        LRU: entries rehydrate one by one on their first lookup miss,
        so a restore larger than ``max_size`` never blows the LRU.
    """

    def __init__(self, max_size: int = 1000):
        self.max_size = max_size
        self._d: OrderedDict[Hashable, Any] = OrderedDict()
        # reentrant: the rehydration helper takes the lock itself, from
        # locked callers and from the lock-free peek alike
        self._lock = threading.RLock()
        # bumped on every mutation, so callers can revalidate views of
        # the entries with one integer compare
        self.version = 0
        self.journal = None  # optional write-through hook
        # restored-but-not-yet-claimed overlay; None = nothing staged
        self._restored: dict | None = None

    def restore_lazy(self, items) -> int:
        """Stage restored entries for lazy rehydration; returns how
        many were staged. Entries already resident (or later put) win
        over their restored versions."""
        with self._lock:
            staged = {k: v for k, v in dict(items).items() if k not in self._d}
            self._restored = staged if staged else None
            self.version += 1
            return len(staged)

    def restored_pending(self) -> int:
        with self._lock:
            return len(self._restored) if self._restored else 0

    def _rehydrate(self, key):
        """Move one staged entry into the LRU; returns the value or
        _MISS. Not journaled: restored entries came from the journal."""
        with self._lock:
            r = self._restored
            if r is None:
                return _MISS
            v = r.pop(key, _MISS)
            if not r:
                self._restored = None
            if v is _MISS:
                return _MISS
            self.version += 1
            self._d[key] = v
            self._d.move_to_end(key)
            while len(self._d) > self.max_size:
                self._d.popitem(last=False)
            return v

    def get(self, key: Hashable):
        with self._lock:
            if key in self._d:
                self._d.move_to_end(key)
                return self._d[key]
            v = self._rehydrate(key)
            return None if v is _MISS else v

    def peek(self, key: Hashable):
        """Lock-free read that does NOT refresh LRU order (a single dict
        read is atomic under the GIL). Only a key actually staged in the
        restored overlay pays the one locked rehydration."""
        v = self._d.get(key)
        if v is None:
            r = self._restored
            if r is not None and key in r:
                return self.get(key)
        return v

    def put(self, key: Hashable, value) -> None:
        with self._lock:
            self.version += 1
            self._d[key] = value
            self._d.move_to_end(key)
            if self._restored is not None:
                # a fresh fit shadows (and must outlive) the restored one
                self._restored.pop(key, None)
            while len(self._d) > self.max_size:
                self._d.popitem(last=False)
        if self.journal is not None:
            self.journal([(key, value)])

    def get_many(self, keys) -> list:
        """Batched get under ONE lock acquisition (a fleet tick looks up
        every fit key at once). None keys and misses yield None."""
        with self._lock:
            d = self._d
            out = []
            for k in keys:
                if k is not None and k in d:
                    d.move_to_end(k)
                    out.append(d[k])
                elif k is not None and self._restored is not None:
                    v = self._rehydrate(k)
                    out.append(None if v is _MISS else v)
                else:
                    out.append(None)
            return out

    def put_many(self, items) -> None:
        """Batched put of (key, value) pairs under one lock."""
        items = list(items)
        with self._lock:
            self.version += 1
            d = self._d
            for k, v in items:
                d[k] = v
                d.move_to_end(k)
                if self._restored is not None:
                    self._restored.pop(k, None)
            while len(d) > self.max_size:
                d.popitem(last=False)
        if self.journal is not None and items:
            self.journal(items)

    def pop(self, key: Hashable) -> None:
        """Drop an entry if present."""
        with self._lock:
            self.version += 1
            self._d.pop(key, None)
            if self._restored is not None:
                self._restored.pop(key, None)
        if self.journal is not None:
            self.journal([(key, None)], deleted=True)

    def pop_where(self, pred) -> int:
        """Drop every entry (resident and restored overlay) whose key
        satisfies `pred`; returns how many were dropped. One lock
        acquisition, one version bump, journaled as deletions."""
        with self._lock:
            doomed = [k for k in self._d if pred(k)]
            for k in doomed:
                del self._d[k]
            if self._restored is not None:
                staged = [k for k in self._restored if pred(k)]
                for k in staged:
                    del self._restored[k]
                if not self._restored:
                    self._restored = None
                doomed += staged
            if doomed:
                self.version += 1
        if self.journal is not None and doomed:
            self.journal([(k, None) for k in doomed], deleted=True)
        return len(doomed)

    def clear(self) -> None:
        with self._lock:
            self.version += 1
            self._d.clear()
            self._restored = None
        if self.journal is not None:
            self.journal((), cleared=True)

    def __len__(self) -> int:
        with self._lock:
            return len(self._d)

    def snapshot(self) -> dict:
        """Point-in-time copy of the contents (lock-guarded)."""
        with self._lock:
            return dict(self._d)

    def persistable_snapshot(self) -> dict:
        """Resident entries PLUS the not-yet-rehydrated restored
        overlay (an entry no tick has claimed yet is still warm state)."""
        with self._lock:
            out = dict(self._restored) if self._restored else {}
            out.update(self._d)
            return out

    # -- checkpoint (torch serialization) --------------------------------

    def save(self, path: str) -> None:
        """Checkpoint the contents as the tree `{"keys": [str], "values":
        [...]}` with `torch.save`. numpy leaves are stored as tensors so
        `load` reads the file with `weights_only=True`."""
        with self._lock:
            items = dict(self._d)
        keys = sorted(items, key=str)
        tree = {
            "keys": [str(k) for k in keys],
            "values": [_map_leaves(items[k], _to_tensor) for k in keys],
        }
        torch.save(tree, path)

    def load(self, path: str, key_parser=None) -> int:
        """Restore a `save` checkpoint; keys come back as strings unless
        a `key_parser` maps them back. Returns the number of entries."""
        tree = torch.load(path, weights_only=True)
        keys, values = tree["keys"], tree["values"]
        for k, v in zip(keys, values):
            self.put(key_parser(k) if key_parser else k, _map_leaves(v, _to_numpy))
        return len(keys)

    # -- host-local durability -------------------------------------------

    def save_local(self, path: str) -> None:
        """Host-local checkpoint (pickle, atomic rename): keys round-trip
        natively."""
        with self._lock:
            items = dict(self._d)
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, prefix=".model_cache.")
        try:
            with os.fdopen(fd, "wb") as f:
                pickle.dump(items, f, protocol=pickle.HIGHEST_PROTOCOL)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def load_local(self, path: str) -> int:
        """Restore a `save_local` checkpoint (a file this program wrote).
        Returns the number of entries loaded."""
        with open(path, "rb") as f:
            items = pickle.load(f)
        self.put_many(items.items())
        return len(items)


def _to_tensor(x):
    return torch.from_numpy(np.ascontiguousarray(x)) if isinstance(x, np.ndarray) else x


def _to_numpy(x):
    return x.numpy() if isinstance(x, torch.Tensor) else x


def _map_leaves(v, fn):
    """`fn` over the leaves of nested tuples/lists/dicts."""
    if isinstance(v, tuple):
        return tuple(_map_leaves(x, fn) for x in v)
    if isinstance(v, list):
        return [_map_leaves(x, fn) for x in v]
    if isinstance(v, dict):
        return {k: _map_leaves(x, fn) for k, x in v.items()}
    return fn(v)


# Batch-padding fit keys: the judge pads batch leading axes with
# constant-key empty tasks — "__pad__" on the object path, "__pad__col__"
# on the columnar path. Their empty-history "fits" live in the in-memory
# caches (one cached pad fit keeps warm ticks fit-free) but are dispatch
# artifacts, not fleet state: every sink that records fits filters
# through this predicate.
PAD_FIT_MARKERS = frozenset({"__pad__", "__pad__col__"})
# the whole family is prefix-matched (shard-qualified "__pad__@3" too)
_PAD_FIT_PREFIX = "__pad__"


def is_pad_fit_key(key) -> bool:
    """True when `key` is (or wraps) a judge batch-padding fit key."""
    if isinstance(key, tuple):
        return bool(key) and is_pad_fit_key(key[-1])
    return isinstance(key, str) and key.startswith(_PAD_FIT_PREFIX)
