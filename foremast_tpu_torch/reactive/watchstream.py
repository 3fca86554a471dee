"""Streaming deployment informer — the watch half of the reactive plane.

`StreamingInformer` replaces the list+diff `DeploymentInformer`'s
*detection* path with the API server's own event stream
(`HttpKube.watch_deployments`): events dispatch to the Barrelman
handler the instant the server writes them, instead of waiting out the
30 s resync. The list+diff machinery is NOT deleted — it becomes the
recovery and repair path, exactly client-go's reflector shape:

  * **prime**: one list (capturing the list's resourceVersion as the
    watch resume point) populates the snapshot and emits adds;
  * **consume**: hold the watch open for a scheduler window, applying
    each event to the snapshot and emitting the same
    add/update/delete handler calls the poll informer makes (one
    handler contract, two delivery mechanisms);
  * **resume**: a window that ends cleanly (server timeout), a
    mid-stream disconnect, or a torn tail reconnects from the last
    resourceVersion actually APPLIED — nothing is dropped, at-least-
    once delivery is the informer contract (handlers are level-driven);
  * **410 Gone** (resume point fell out of the server's event window):
    re-list and DIFF against the snapshot — missed events collapse
    into synthetic add/update/delete exactly like a resync, so the
    handler sees every net change even across a lossy stream;
  * **stall** (server stops writing without closing): the client's
    read timeout fires (`stall_margin`), counted and reconnected —
    a wedged proxy degrades to one margin of latency, never a hang;
  * **repair sweep**: the plane still calls `resync()` on the old
    30 s cadence, now only to catch divergence (it normally diffs to
    zero events).

Failure accounting rides `WatchStreamMetrics`
(``foremast_watch_stream_events`` / ``foremast_watch_stream_restarts``,
docs/observability.md) plus a local counter dict for /debug/state.
"""

from __future__ import annotations

import logging
import time

from foremast_tpu_torch.watch.kubeapi import WatchGone
from foremast_tpu_torch.watch.plane import DeploymentInformer, _key

log = logging.getLogger("foremast_tpu_torch.watch.stream")

_EVENT_TYPES = ("added", "modified", "deleted", "error")
_RESTART_REASONS = ("gone", "stall", "error", "end")


class WatchStreamMetrics:
    """The two watch-stream families, on the default or an injected
    registry (the same `counter` sharing discipline the controller's
    transition counter uses)."""

    def __init__(self, registry=None):
        from foremast_tpu_torch.observe.spans import counter

        self.events = counter(
            "foremast_watch_stream_events_total",
            "deployment watch-stream events dispatched, by event type "
            "(added/modified/deleted/error)",
            ("type",),
            registry,
        )
        self.restarts = counter(
            "foremast_watch_stream_restarts_total",
            "watch-stream reconnects, by cause (gone=410 re-list, "
            "stall=read timeout, error=transport/breaker, end=server "
            "closed the window)",
            ("reason",),
            registry,
        )


class StreamingInformer(DeploymentInformer):
    """Event-driven deployment informer over a streaming kube client.

    Same handler contract as `DeploymentInformer` (add/update/delete
    with the previous object); `resync()` stays the repair/recovery
    path and additionally captures the list resourceVersion when the
    client exposes `list_deployments_rv`."""

    def __init__(
        self,
        kube,
        handler,
        namespace: str | None = None,
        metrics: WatchStreamMetrics | None = None,
        clock=time.monotonic,
    ) -> None:
        super().__init__(kube, handler)
        self.namespace = namespace
        self.metrics = metrics
        self._clock = clock
        self._rv = ""  # last resourceVersion APPLIED (resume point)
        # /debug/state mirror of the metric families (single-threaded
        # mutation: the plane loop owns this informer)
        self.counts = {
            "events": 0,
            **{f"restart_{r}": 0 for r in _RESTART_REASONS},
        }

    # -- repair / recovery (list+diff) ----------------------------------

    def resync(self) -> None:
        lister = getattr(self.kube, "list_deployments_rv", None)
        if lister is None:
            return super().resync()
        items, rv = lister(self.namespace)
        if rv:
            self._rv = rv
        self._apply_list({_key(d): d for d in items})

    # -- the stream -----------------------------------------------------

    def consume(self, seconds: float, stall_margin: float = 5.0) -> int:
        """Hold the watch open for ~`seconds`, dispatching each event
        on arrival. Returns #events dispatched. Never raises: stream
        failures are counted restarts and the next call reconnects
        (a 410 triggers the re-list + diff recovery HERE, so no caller
        can forget it)."""
        if not self._primed or not self._rv:
            # not yet primed, OR the resume point was invalidated by a
            # 410 whose recovery re-list ALSO failed (apiserver still
            # down at that instant): keep retrying the list on every
            # window — detection must come back the moment the server
            # does, not at the next 30 s repair sweep
            try:
                self.resync()
            except Exception:  # noqa: BLE001 — next window retries
                self._count_restart("error")
                log.warning(
                    "watch list failed; retrying on the next window"
                )
                return 0
        if not self._rv:
            # a client that lists without a resourceVersion cannot
            # resume; the resync above already delivered the state
            return 0
        n = 0
        try:
            for etype, obj in self.kube.watch_deployments(
                namespace=self.namespace,
                resource_version=self._rv,
                timeout_seconds=seconds,
                stall_margin=stall_margin,
            ):
                self._dispatch(etype, obj)
                n += 1
            self._count_restart("end")
        except WatchGone:
            self._count_restart("gone")
            log.info(
                "watch resume point %s expired (410); re-listing", self._rv
            )
            self._rv = ""
            try:
                self.resync()  # diff emits whatever the stream lost
            except Exception:  # noqa: BLE001 - next window retries
                log.exception("re-list after 410 failed")
        except TimeoutError:
            # the server stopped writing without closing: a stall
            self._count_restart("stall")
            log.warning(
                "watch stream stalled (> %.1fs without data); "
                "reconnecting from rv %s", seconds + stall_margin, self._rv,
            )
        except OSError as e:
            # disconnects, refused connections, open breakers
            # (BreakerOpen ⊂ ConnectionError) — reconnect next window
            self._count_restart("error")
            log.warning(
                "watch stream error (%s: %s); reconnecting from rv %s",
                type(e).__name__, e, self._rv,
            )
        return n

    def _dispatch(self, etype: str, obj: dict) -> None:
        rv = str(obj.get("metadata", {}).get("resourceVersion") or "")
        key = _key(obj)
        low = etype.lower()
        self.counts["events"] += 1
        if self.metrics is not None:
            self.metrics.events.labels(
                type=low if low in _EVENT_TYPES else "error"
            ).inc()
        if etype == "DELETED":
            self._snapshot.pop(key, None)
            self._emit("delete", obj, None)
        elif etype in ("ADDED", "MODIFIED"):
            old = self._snapshot.get(key)
            self._snapshot[key] = obj
            if old is None:
                self._emit("add", obj, None)
            elif rv and rv != str(
                old.get("metadata", {}).get("resourceVersion") or ""
            ):
                self._emit("update", obj, old)
        else:
            log.debug("ignoring watch event type %r for %s", etype, key)
        if rv:
            # advance the resume point only AFTER the event is applied:
            # a crash between read and apply must re-deliver, not skip
            self._rv = rv

    def _count_restart(self, reason: str) -> None:
        self.counts[f"restart_{reason}"] += 1
        if self.metrics is not None:
            self.metrics.restarts.labels(reason=reason).inc()

    def debug_state(self) -> dict:
        return {
            "resource_version": self._rv,
            "deployments_cached": len(self._snapshot),
            **self.counts,
        }
