"""Runtime lock witness: pin the port's static lock-order model to
reality.

The port's own copy of `foremast_tpu/analysis/witness.py`. The static
graph (`analysis/lock_order.py`, committed as
``analysis_lockgraph_torch.json``) is built by an over-approximating
resolver and is useful only if it is a SUPERSET of what the threads do.
This module checks that from the runtime side:

  * `install()` replaces ``threading.Lock``/``RLock`` with factories
    that wrap locks CREATED BY THE PORT'S CODE (decided by the immediate
    caller's frame, so stdlib internals such as queue, logging and
    Event's Condition keep their raw locks and semantics);
  * each wrapped lock remembers its creation site (``path:line``,
    exactly the site the static graph records for the
    ``threading.Lock()`` call);
  * every acquisition records, per thread, an edge from each lock
    already held to the one being acquired (re-entrant RLock
    acquisitions are reentrancy, not ordering, and are skipped);
  * `unobserved_edges(graph)` maps the observed creation-site edges
    back to static node IDs and returns every edge the static graph is
    MISSING.

A worker runs the same witness under ``FOREMAST_LOCK_WITNESS=1``: the
CLI installs it first thing and logs its verdict at exit. The cost is
one thread-local list append per acquisition.

A module-level lock made at import time stays raw when its module was
imported before `install()`, and edges involving locks the static model
does not know (test-local locks) are ignored: the contract is "every
observed edge BETWEEN PACKAGE LOCKS exists statically".
"""

from __future__ import annotations

import atexit
import logging
import os
import sys
import threading
from _thread import allocate_lock as _raw_lock

log = logging.getLogger("foremast_tpu_torch.analysis")

_PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REPO_DIR = os.path.dirname(_PACKAGE_DIR)
_THIS_FILE = os.path.abspath(__file__)


class LockWitness:
    """Collects (creation-site -> creation-site) acquisition edges."""

    def __init__(self):
        self._edges: set[tuple[str, str]] = set()
        self._edges_lock = _raw_lock()
        self._tls = threading.local()
        self._installed = False
        self._orig_lock = None
        self._orig_rlock = None

    # -- recording -------------------------------------------------------

    def _held(self) -> list:
        held = getattr(self._tls, "held", None)
        if held is None:
            held = self._tls.held = []
        return held

    def record_acquire(self, lock: "_WitnessLockBase") -> None:
        held = self._held()
        if any(entry is lock for entry in held):
            # re-entrant RLock acquisition: same object, no ordering
            held.append(lock)
            return
        if held:
            new_edges = {
                (h.site, lock.site)
                for h in held
                if h.site != lock.site
            } - self._edges
            if new_edges:
                with self._edges_lock:
                    self._edges |= new_edges
        held.append(lock)

    def record_release(self, lock: "_WitnessLockBase") -> None:
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i] is lock:
                del held[i]
                return

    # -- install / uninstall ---------------------------------------------

    def install(self) -> "LockWitness":
        if not self._installed:
            self._orig_lock = threading.Lock
            self._orig_rlock = threading.RLock
            threading.Lock = self._factory(self._orig_lock, _WitnessLock)
            threading.RLock = self._factory(self._orig_rlock, _WitnessRLock)
            self._installed = True
        return self

    def uninstall(self) -> None:
        if self._installed:
            threading.Lock = self._orig_lock
            threading.RLock = self._orig_rlock
            self._installed = False

    def _factory(self, orig, wrapper_cls):
        witness = self

        def make():
            inner = orig()
            site = _caller_site()
            if site is None:
                return inner  # not package code: raw lock, raw semantics
            return wrapper_cls(inner, site, witness)

        return make

    # -- checking --------------------------------------------------------

    def edges(self) -> set[tuple[str, str]]:
        with self._edges_lock:
            return set(self._edges)

    def unobserved_edges(self, graph: dict) -> list[tuple[str, str]]:
        """Observed edges between package locks that the static graph
        is missing, as (from-id, to-id) pairs. Empty = the static
        model covers everything reality did."""
        site_to_id = {n["site"]: n["id"] for n in graph.get("nodes", ())}
        static = {(e["from"], e["to"]) for e in graph.get("edges", ())}
        reentrant = {r["id"] for r in graph.get("reentrant", ())}
        missing = []
        for a_site, b_site in sorted(self.edges()):
            a, b = site_to_id.get(a_site), site_to_id.get(b_site)
            if a is None or b is None:
                continue  # a lock the static model does not track
            if a == b and a in reentrant:
                continue
            if (a, b) not in static:
                missing.append((a, b))
        return missing


class _WitnessLockBase:
    """Wrapper sharing the real lock's blocking semantics; only
    successful acquisitions touch the witness."""

    __slots__ = ("_inner", "site", "_witness")

    def __init__(self, inner, site: str, witness: LockWitness):
        self._inner = inner
        self.site = site
        self._witness = witness

    def acquire(self, blocking: bool = True, timeout: float = -1):
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._witness.record_acquire(self)
        return got

    def release(self):
        self._witness.record_release(self)
        self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self):
        return self._inner.locked()


class _WitnessLock(_WitnessLockBase):
    __slots__ = ()


class _WitnessRLock(_WitnessLockBase):
    __slots__ = ()


def _caller_site() -> str | None:
    """`relpath:line` of the frame that called the lock factory, when
    that frame is package code (excluding this module); else None."""
    frame = sys._getframe(2)  # make() -> factory caller
    abspath = os.path.abspath(frame.f_code.co_filename)
    if abspath == _THIS_FILE or not abspath.startswith(_PACKAGE_DIR + os.sep):
        return None
    rel = os.path.relpath(abspath, _REPO_DIR).replace(os.sep, "/")
    return f"{rel}:{frame.f_lineno}"


# ---------------------------------------------------------------------------
# module-level lifecycle
# ---------------------------------------------------------------------------

_current: LockWitness | None = None


def install() -> LockWitness:
    """Install (or return the already-installed) process witness."""
    global _current
    if _current is None:
        _current = LockWitness()
    _current.install()
    return _current


def uninstall() -> None:
    global _current
    if _current is not None:
        _current.uninstall()
        _current = None


def current() -> LockWitness | None:
    return _current


def load_graph() -> dict | None:
    """The committed `analysis_lockgraph_torch.json`, or None."""
    from foremast_tpu_torch.analysis.core import repo_root
    from foremast_tpu_torch.analysis.lock_order import load_graph as _load

    return _load(repo_root())


def install_from_env(env=None) -> LockWitness | None:
    """`FOREMAST_LOCK_WITNESS=1` wiring for long-lived entry points
    (the CLI's worker): install early, verify against the committed
    graph at interpreter exit, log (never raise) on an unknown edge."""
    e = os.environ if env is None else env
    if e.get("FOREMAST_LOCK_WITNESS", "") != "1":
        return None
    witness = install()

    def _report():
        graph = load_graph()
        if graph is None:
            log.warning(
                "lock witness: no committed analysis_lockgraph_torch.json to "
                "verify against (%d edges observed)", len(witness.edges()),
            )
            return
        missing = witness.unobserved_edges(graph)
        if missing:
            log.warning(
                "lock witness: %d observed acquisition edge(s) MISSING "
                "from the static lock graph — the model is stale or the "
                "resolver has a hole; run `python -m foremast_tpu_torch.analysis "
                "--write-lockgraph` and review: %s",
                len(missing), missing,
            )
        else:
            log.info(
                "lock witness: %d observed edge(s), all within the "
                "static graph", len(witness.edges()),
            )

    atexit.register(_report)
    return witness
