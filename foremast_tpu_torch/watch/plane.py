"""The deployed watch-plane process: informer-equivalent loop tying
Barrelman (deployment events) and MonitorController (status poll +
remediation) to a KubeClient.

The reference runs two shared informers — Deployments resynced every 30 s
and DeploymentMonitors polled every 10 s (`cmd/manager/main.go:39-104`,
`Barrelman.go:467-472`). Kubernetes watch streams are an optimization of
list+diff; this plane implements the same event semantics with periodic
lists diffed against a local snapshot (add/update/delete by UID + spec),
which survives API-server reconnects for free and needs no client
machinery. Event *detection* granularity is the resync period, exactly
like a reference informer that missed its watch stream.

The missed watch stream exists too: `FOREMAST_WATCH_STREAM=1`
(or ``stream=True``) runs the REACTIVE loop instead — `HttpKube`'s
``watch=true`` long-poll delivers deployment events on arrival
(`reactive/watchstream.py`), resourceVersion resume + 410-Gone re-list
cover the reconnect cases, and the 30 s resync demotes to a repair
sweep that only catches what the stream lost. Detection granularity
drops from the resync period to stream delivery (milliseconds).
"""

from __future__ import annotations

import logging
import time as _time
from typing import Callable

from foremast_tpu_torch.watch.barrelman import Barrelman
from foremast_tpu_torch.watch.controller import MonitorController
from foremast_tpu_torch.watch.kubeapi import KubeClient

log = logging.getLogger("foremast_tpu_torch.watch.plane")

DEPLOY_RESYNC_SECONDS = 30.0  # main.go:58 (deployment informer resync)
MONITOR_POLL_SECONDS = 10.0  # Barrelman.go:467


def _key(dep: dict) -> tuple[str, str]:
    meta = dep.get("metadata", {})
    return meta.get("namespace", ""), meta.get("name", "")


class DeploymentInformer:
    """List+diff informer: emits add/update/delete events with the
    previous object, matching the handler contract of
    Barrelman.handle_deployment."""

    def __init__(
        self,
        kube: KubeClient,
        handler: Callable[[str, dict, dict | None], None],
    ) -> None:
        self.kube = kube
        self.handler = handler
        self._snapshot: dict[tuple[str, str], dict] = {}
        self._primed = False

    def resync(self) -> None:
        self._apply_list(
            {_key(d): d for d in self.kube.list_deployments()}
        )

    def _apply_list(self, current: dict[tuple[str, str], dict]) -> None:
        """Diff a fresh list against the snapshot and emit events — the
        resync body, shared with the streaming informer's repair/
        re-list path (reactive/watchstream.py)."""
        if not self._primed:
            # first list primes the cache; emit adds so monitors get
            # created for pre-existing Deployments (AddFunc semantics)
            self._primed = True
            for dep in current.values():
                self._emit("add", dep, None)
            self._snapshot = current
            return
        for key, dep in current.items():
            old = self._snapshot.get(key)
            if old is None:
                self._emit("add", dep, None)
            elif dep.get("metadata", {}).get("resourceVersion") != old.get(
                "metadata", {}
            ).get("resourceVersion"):
                self._emit("update", dep, old)
        for key, old in self._snapshot.items():
            if key not in current:
                self._emit("delete", old, None)
        self._snapshot = current

    def _emit(self, event: str, dep: dict, old: dict | None) -> None:
        try:
            self.handler(event, dep, old)
        except Exception:  # noqa: BLE001 - one bad object must not kill the loop
            log.exception("handler failed for %s %s", event, _key(dep))


class WatchPlane:
    """The whole deployed controller: deployment informer + monitor poll."""

    def __init__(
        self,
        kube: KubeClient,
        own_namespace: str = "foremast",
        clock: Callable[[], float] = _time.time,
        sleep: Callable[[float], None] = _time.sleep,
        analyst_factory=None,
        tracer=None,
        registry=None,
        stream: bool | None = None,
    ) -> None:
        self.barrelman = Barrelman(
            kube,
            own_namespace=own_namespace,
            clock=clock,
            analyst_factory=analyst_factory,
        )
        self.controller = MonitorController(
            kube,
            barrelman=self.barrelman,
            clock=clock,
            tracer=tracer,
            registry=registry,
        )
        # Event-driven detection (the reactive plane): `stream`
        # (env FOREMAST_WATCH_STREAM) swaps the list+diff informer for
        # a streaming one — deployment events dispatch on ARRIVAL from
        # the API server's watch stream, the 30 s resync demotes to a
        # repair sweep, and run() takes the event loop below. Requires
        # a kube client that can stream (HttpKube); InMemoryKube keeps
        # the poll loop (its event delivery is already synchronous).
        if stream is None:
            import os as _os

            stream = _os.environ.get("FOREMAST_WATCH_STREAM", "0") == "1"
        self.stream = bool(stream) and hasattr(kube, "watch_deployments")
        if self.stream:
            from foremast_tpu_torch.reactive.watchstream import (
                StreamingInformer,
                WatchStreamMetrics,
            )

            self.informer = StreamingInformer(
                kube,
                self.barrelman.handle_deployment,
                metrics=WatchStreamMetrics(registry=registry),
            )
        else:
            self.informer = DeploymentInformer(
                kube, self.barrelman.handle_deployment
            )
        self.clock = clock
        self.sleep = sleep
        self._started = clock()

    def debug_state(self) -> dict:
        """The /debug/state varz payload for the controller's scrape
        port (observe.start_observe_server): identity, cached informer
        size, and the tracer's poll-stage breakdown."""
        from foremast_tpu_torch import __version__

        state = {
            "component": "controller",
            "version": __version__,
            "uptime_seconds": round(self.clock() - self._started, 1),
            "deployments_cached": len(self.informer._snapshot),
            "watch_stream": self.stream,
        }
        if self.stream:
            state["stream"] = self.informer.debug_state()
        if self.controller.tracer is not None:
            state["trace"] = self.controller.tracer.debug_state()
        return state

    def step(self, now: float | None = None, last_resync: float = 0.0) -> float:
        """One scheduler step: monitor tick always; deployment resync when
        due. Returns the new last_resync time."""
        now = self.clock() if now is None else now
        if now - last_resync >= DEPLOY_RESYNC_SECONDS or last_resync == 0.0:
            self.informer.resync()
            last_resync = now
        self.controller.tick()
        return last_resync

    def run(self, stop: Callable[[], bool] = lambda: False) -> None:
        if self.stream:
            return self.run_stream(stop)
        last_resync = 0.0
        while not stop():
            try:
                last_resync = self.step(last_resync=last_resync)
            except Exception:  # noqa: BLE001 - keep the control loop alive
                log.exception("watch-plane step failed")
            self.sleep(MONITOR_POLL_SECONDS)

    def run_stream(self, stop: Callable[[], bool] = lambda: False) -> None:
        """Event-driven loop: hold the watch stream open between
        scheduler duties, dispatching deployment events the instant
        they arrive. Monitor polling keeps its 10 s cadence (job
        status is a poll by nature until the service pushes), and the
        30 s deployment resync is DEMOTED to a repair sweep — it no
        longer bounds detection latency, it only catches what a lossy
        stream (410 re-lists, compaction) might have dropped."""
        last_resync = self.clock()
        last_poll = 0.0
        try:
            self.informer.resync()  # prime the snapshot + resume point
        except Exception:  # noqa: BLE001 - retried inside the loop
            log.exception("watch-plane initial list failed")
        while not stop():
            try:
                now = self.clock()
                if now - last_poll >= MONITOR_POLL_SECONDS:
                    self.controller.tick()
                    last_poll = now
                if now - last_resync >= DEPLOY_RESYNC_SECONDS:
                    self.informer.resync()  # repair sweep
                    last_resync = now
                window = min(
                    MONITOR_POLL_SECONDS - (self.clock() - last_poll),
                    DEPLOY_RESYNC_SECONDS - (self.clock() - last_resync),
                )
                window = max(0.05, min(window, MONITOR_POLL_SECONDS))
                t0 = self.clock()
                self.informer.consume(window)
                leftover = window - (self.clock() - t0)
                if leftover > 0.05:
                    # the stream died early (API server down, breaker
                    # open): pace the reconnects instead of spinning
                    self.sleep(min(leftover, 1.0))
            except Exception:  # noqa: BLE001 - keep the control loop alive
                log.exception("watch-plane stream step failed")
                self.sleep(1.0)
