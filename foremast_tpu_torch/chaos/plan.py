"""Seeded, scheduled fault plans — the injection half of the chaos plane
(the port's copy of the JAX package's `foremast_tpu/chaos/plan.py`).

A `FaultPlan` is a list of `FaultRule`s, each scoped to one dependency
EDGE and optionally to a time window relative to plan activation. The
port wires six edges: the worker's ``store`` (`ElasticsearchStore`'s
guarded session), ``prometheus`` (`PrometheusSource`'s request choke
point), ``receiver`` (the ingest receiver's handler, which answers a
fault as its HTTP status), ``transfer`` (the mesh handoff's POST,
`mesh.HandoffManager`) and ``clock`` (the skewed clock mesh membership
stamps and reads leases by, `EdgeChaos.clock()`), and the watch plane's
``kube`` (`watch.kubeapi.HttpKube`'s request and watch choke points,
wired by `watch-plane`). A plan may name any other edge: it parses, and
its rules count nothing until a client asks for it. Clients hold an `EdgeChaos` view and call
``perturb(op)`` at their single request choke point; with no plan
attached (`chaos is None`, the production default) the seam is a plain
attribute check and nothing else.

Determinism: every probabilistic decision draws from a per-edge
`random.Random` seeded from (plan seed, edge name), so a chaos test
replays identically given the same call order — no global RNG, no
wall-clock dependence beyond the injectable plan clock.

Fault kinds (per rule):
  * ``latency_seconds``   sleep before the real call (slow dependency;
                          a large value vs the client timeout is the
                          classic slow-drip);
  * ``error_rate``        probability of raising an `InjectedFault`
                          per call (1.0 = hard outage);
  * ``kind``              what the fault looks like: ``connection``
                          (refused/reset), ``timeout`` (client-side
                          read timeout), or ``status`` with ``status``
                          (servers we control answer that HTTP code;
                          pure clients raise — see InjectedFault);
  * ``blackhole``         shorthand: hold the call for the rule's
                          latency (default: the edge's typical client
                          timeout is expected to fire first), then
                          raise a timeout — packets leave, nothing
                          returns;
  * ``skew_seconds``      clock skew served by ``EdgeChaos.clock()``
                          for components reading leases/watermarks.

`FOREMAST_CHAOS_PLAN` holds the plan as inline JSON or ``@/path/to``
a JSON file; `chaos_from_env()` returns None when unset so callers wire
seams only when chaos is actually requested.
"""

from __future__ import annotations

import json
import logging
import os
import random
import threading
import time
import zlib
from dataclasses import dataclass, field

log = logging.getLogger("foremast_tpu_torch.chaos")

KIND_CONNECTION = "connection"
KIND_TIMEOUT = "timeout"
KIND_STATUS = "status"
_KINDS = (KIND_CONNECTION, KIND_TIMEOUT, KIND_STATUS)


class InjectedFault(ConnectionError):
    """A chaos-synthesized dependency failure.

    Subclasses ConnectionError on purpose: every transient-failure net
    in the repo (PrometheusSource retries, the resilient store writes,
    breaker classification) already treats ConnectionError as
    transient, so injected faults exercise exactly the degradation
    paths a real outage would — no special-casing in product code.
    ``status`` carries the HTTP code for servers that can ANSWER the
    fault (receiver, fake kube, bench store) instead of raising it.
    """

    def __init__(self, edge: str, kind: str, status: int = 503):
        super().__init__(f"chaos[{edge}]: injected {kind}")
        self.edge = edge
        self.kind = kind
        self.status = status


class InjectedTimeout(InjectedFault, TimeoutError):
    """Injected client-side timeout (also a TimeoutError so timeout
    classification paths fire)."""


@dataclass(frozen=True)
class FaultRule:
    """One scheduled fault on one dependency edge."""

    edge: str
    op: str = ""  # substring match on the call's op/url ("" = all)
    after: float = 0.0  # seconds since plan activation
    duration: float | None = None  # None = until the plan ends
    latency_seconds: float = 0.0
    error_rate: float = 0.0
    kind: str = KIND_CONNECTION
    status: int = 503
    blackhole: bool = False
    skew_seconds: float = 0.0

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")

    def active(self, elapsed: float) -> bool:
        if elapsed < self.after:
            return False
        if self.duration is None:
            return True
        return elapsed < self.after + self.duration

    @staticmethod
    def from_json(d: dict) -> "FaultRule":
        known = {
            "edge", "op", "after", "duration", "latency_seconds",
            "error_rate", "kind", "status", "blackhole", "skew_seconds",
        }
        extra = set(d) - known
        if extra:
            raise ValueError(f"unknown fault-rule fields {sorted(extra)}")
        return FaultRule(**d)


@dataclass
class FaultPlan:
    """The scheduled fault set plus its activation clock and counters."""

    rules: tuple[FaultRule, ...] = ()
    seed: int = 0
    clock: object = field(default=time.monotonic, repr=False)

    def __post_init__(self):
        self.rules = tuple(
            r if isinstance(r, FaultRule) else FaultRule.from_json(r)
            for r in self.rules
        )
        # construction-time writes: dataclasses run __post_init__ before
        # the instance is published to any other thread, so these three
        # are the same pre-publication case as a plain __init__ body
        self._epoch: float | None = None  # foremast: ignore[lock-discipline] — pre-publication init
        self._lock = threading.Lock()
        # (edge, kind) -> count; mutated under _lock (perturb runs on
        # receiver handler threads AND worker fetch pools concurrently)
        self.injections: dict[tuple[str, str], int] = {}  # foremast: ignore[lock-discipline] — pre-publication init
        self._edges: dict[str, EdgeChaos] = {}  # foremast: ignore[lock-discipline] — pre-publication init

    # -- lifecycle ------------------------------------------------------

    def activate(self, now: float | None = None) -> "FaultPlan":
        """Start the schedule clock; idempotent (first activation wins,
        so every edge shares one epoch)."""
        with self._lock:
            if self._epoch is None:
                self._epoch = self.clock() if now is None else now
        return self

    def elapsed(self, now: float | None = None) -> float:
        with self._lock:
            epoch = self._epoch
        if epoch is None:
            return -1.0  # not yet activated: nothing fires
        return (self.clock() if now is None else now) - epoch

    # -- edge views -----------------------------------------------------

    def edge(self, name: str) -> "EdgeChaos":
        """The client-facing view for one dependency edge (memoized so
        perturb's rule scan is precomputed per edge)."""
        with self._lock:
            ec = self._edges.get(name)
            if ec is None:
                rng = random.Random(
                    (self.seed << 32) ^ zlib.crc32(name.encode())
                )
                ec = EdgeChaos(self, name, rng)
                self._edges[name] = ec
        return ec

    def active_rules(self, edge: str, op: str = "") -> list[FaultRule]:
        elapsed = self.elapsed()
        return [
            r
            for r in self.rules
            if r.edge == edge
            and r.active(elapsed)
            and (not r.op or r.op in op)
        ]

    def count(self, edge: str, kind: str) -> None:
        with self._lock:
            key = (edge, kind)
            self.injections[key] = self.injections.get(key, 0) + 1

    def injections_snapshot(self) -> dict[tuple[str, str], int]:
        with self._lock:
            return dict(self.injections)

    def debug_state(self) -> dict:
        return {
            "seed": self.seed,
            "rules": len(self.rules),
            "elapsed_seconds": round(self.elapsed(), 3),
            "injections": {
                f"{e}/{k}": n
                for (e, k), n in sorted(self.injections_snapshot().items())
            },
        }

    # -- parsing --------------------------------------------------------

    @staticmethod
    def from_json(obj: dict, clock=time.monotonic) -> "FaultPlan":
        return FaultPlan(
            rules=tuple(obj.get("rules", ())),
            seed=int(obj.get("seed", 0)),
            clock=clock,
        )


class EdgeChaos:
    """One dependency edge's injection seam.

    Clients call ``perturb(op)`` at their single request choke point;
    the op string (usually the URL or RPC op name) scopes rules with an
    ``op`` substring. Servers that can ANSWER faults call
    ``perturb(op, raise_faults=False)`` and get the fault back as a
    return value to turn into an HTTP status.
    """

    def __init__(self, plan: FaultPlan, edge: str, rng: random.Random):
        self.plan = plan
        self.edge = edge
        self._rng = rng
        # rng draws are not atomic across threads; serialize them so
        # the deterministic sequence survives concurrent handlers
        self._rng_lock = threading.Lock()

    def perturb(
        self, op: str = "", raise_faults: bool = True
    ) -> InjectedFault | None:
        """Apply every active rule for this edge: sleep the max latency,
        then (probabilistically) fault. Returns the fault instead of
        raising when ``raise_faults`` is False."""
        rules = self.plan.active_rules(self.edge, op)
        if not rules:
            return None
        delay = 0.0
        fault: InjectedFault | None = None
        for r in rules:
            delay = max(delay, r.latency_seconds)
            if fault is None and (r.blackhole or r.error_rate > 0.0):
                if r.blackhole:
                    hit = True
                else:
                    with self._rng_lock:
                        hit = self._rng.random() < r.error_rate
                if hit:
                    kind = KIND_TIMEOUT if r.blackhole else r.kind
                    cls = (
                        InjectedTimeout
                        if kind == KIND_TIMEOUT
                        else InjectedFault
                    )
                    fault = cls(self.edge, kind, status=r.status)
        if delay > 0.0:
            self.plan.count(self.edge, "latency")
            time.sleep(delay)
        if fault is not None:
            self.plan.count(self.edge, fault.kind)
            if raise_faults:
                raise fault
        return fault

    def skew_seconds(self) -> float:
        """The currently-active clock skew for this edge (0 outside any
        skew rule's window)."""
        skew = 0.0
        for r in self.plan.active_rules(self.edge):
            if r.skew_seconds:
                skew = r.skew_seconds
        return skew

    def clock(self, base=time.time):
        """A skew-applying wall clock for components that read leases /
        watermarks by their own clock (mesh membership)."""

        def skewed() -> float:
            return base() + self.skew_seconds()

        return skewed


def chaos_from_env(env=None) -> FaultPlan | None:
    """Build + activate the plan from `FOREMAST_CHAOS_PLAN` (inline
    JSON, or ``@path`` to a JSON file); None when unset — the caller
    then wires NO seams and every client keeps its zero-cost None
    check. Malformed plans raise: a chaos run that silently tests
    nothing is worse than a crash at startup."""
    e = os.environ if env is None else env
    raw = e.get("FOREMAST_CHAOS_PLAN", "")
    if not raw:
        return None
    if raw.startswith("@"):
        with open(raw[1:], encoding="utf-8") as fh:
            raw = fh.read()
    plan = FaultPlan.from_json(json.loads(raw))
    plan.activate()
    log.warning(
        "CHAOS PLAN ACTIVE: %d rule(s), seed %d — this process is "
        "deliberately injecting dependency faults",
        len(plan.rules), plan.seed,
    )
    return plan
