"""Pluggable Kubernetes API for the watch plane.

The reference talks to K8s through client-go clientsets + generated CRD
clients (`foremast-barrelman/pkg/client/`, ~2,200 LoC of codegen). Here the
same surface is a small protocol with two implementations:

* ``InMemoryKube`` — the test substrate, replacing the reference's
  generated fake clientsets
  (`pkg/client/clientset/versioned/fake/clientset_generated.go`).
* ``HttpKube`` — a direct REST client against the API server using the
  in-cluster service-account credentials (no kubernetes python package in
  the image; the API surface needed is tiny).

Builtin objects (Deployment / ReplicaSet / Pod / Namespace) are handled in
their K8s wire form (plain dicts); the two foremast CRDs are typed
(`crds.py`).
"""

from __future__ import annotations

import copy
import json
import os
import ssl
import urllib.parse
import urllib.request
from typing import Any, Callable, Iterable, Protocol

from foremast_tpu_torch.watch.crds import (
    API_VERSION,
    GROUP,
    VERSION,
    DeploymentMetadata,
    DeploymentMonitor,
)


class NotFound(KeyError):
    """Object absent — the analogue of a k8s 404 / IsNotFound."""


class WatchGone(Exception):
    """410 Gone from a watch: the resume `resourceVersion` fell out of
    the API server's event window — the stream cannot resume and the
    watcher must RE-LIST (client-go's ErrResourceExpired → reflector
    relist). Raised both for an immediate 410 answer and for the
    mid-stream ``{"type": "ERROR", ...code 410}`` event."""


class KubeClient(Protocol):
    # builtin workloads ---------------------------------------------------
    def list_namespaces(self) -> list[dict]: ...
    def get_namespace(self, name: str) -> dict: ...
    def list_deployments(self, namespace: str | None = None) -> list[dict]: ...
    def get_deployment(self, namespace: str, name: str) -> dict: ...
    def patch_deployment(self, namespace: str, name: str, patch: dict) -> dict: ...
    def list_replicasets(self, namespace: str) -> list[dict]: ...
    def list_pods(self, namespace: str) -> list[dict]: ...
    def create_event(self, namespace: str, event: dict) -> dict: ...

    # foremast CRDs -------------------------------------------------------
    def get_metadata(self, namespace: str, name: str) -> DeploymentMetadata: ...
    def list_monitors(self, namespace: str | None = None) -> list[DeploymentMonitor]: ...
    def get_monitor(self, namespace: str, name: str) -> DeploymentMonitor: ...
    def upsert_monitor(self, monitor: DeploymentMonitor) -> DeploymentMonitor: ...
    def patch_monitor(
        self, namespace: str, name: str, patch: dict
    ) -> DeploymentMonitor: ...
    def delete_monitor(self, namespace: str, name: str) -> None: ...


# ---------------------------------------------------------------------------
# helpers shared by both implementations and by Barrelman
# ---------------------------------------------------------------------------


def owner_uids(obj: dict) -> set[str]:
    return {
        ref.get("uid", "")
        for ref in obj.get("metadata", {}).get("ownerReferences", []) or []
    }


def deployment_containers(dep: dict) -> list[dict]:
    return (
        dep.get("spec", {})
        .get("template", {})
        .get("spec", {})
        .get("containers", [])
        or []
    )


def deployment_revision(dep: dict) -> int:
    """`deployment.kubernetes.io/revision` annotation as int (0 if unset)."""
    ann = dep.get("metadata", {}).get("annotations", {}) or {}
    try:
        return int(ann.get("deployment.kubernetes.io/revision", 0))
    except (TypeError, ValueError):
        return 0


# ---------------------------------------------------------------------------
# In-memory fake
# ---------------------------------------------------------------------------


class InMemoryKube:
    """Dict-backed kube API with synchronous event delivery.

    Tests seed namespaces/deployments/replicasets/pods, register handlers
    (the informer-equivalent), and mutate objects through
    ``apply_deployment`` to fire add/update events — covering what the
    reference exercised through client-go informers + fake clientsets.
    """

    def __init__(self) -> None:
        self.namespaces: dict[str, dict] = {}
        self.deployments: dict[tuple[str, str], dict] = {}
        self.replicasets: dict[tuple[str, str], dict] = {}
        self.pods: dict[tuple[str, str], dict] = {}
        self.metadatas: dict[tuple[str, str], DeploymentMetadata] = {}
        self.monitors: dict[tuple[str, str], DeploymentMonitor] = {}
        self.deployment_handlers: list[Callable[[str, dict, dict | None], None]] = []
        self.monitor_handlers: list[
            Callable[[str, DeploymentMonitor, DeploymentMonitor | None], None]
        ] = []
        # audit trail of (verb, kind, namespace, name, detail) for asserts
        self.actions: list[tuple[str, str, str, str, Any]] = []
        self.events: list[dict] = []

    def create_event(self, namespace: str, event: dict) -> dict:
        self.events.append(event)
        return event

    # --- seeding / events ------------------------------------------------

    def add_namespace(self, name: str, annotations: dict | None = None) -> None:
        self.namespaces[name] = {
            "metadata": {"name": name, "annotations": annotations or {}}
        }

    def on_deployment(self, fn: Callable[[str, dict, dict | None], None]) -> None:
        self.deployment_handlers.append(fn)

    def on_monitor(
        self, fn: Callable[[str, DeploymentMonitor, DeploymentMonitor | None], None]
    ) -> None:
        self.monitor_handlers.append(fn)

    def apply_deployment(self, dep: dict) -> None:
        """Create or update a Deployment and fire the informer event."""
        meta = dep["metadata"]
        key = (meta["namespace"], meta["name"])
        old = self.deployments.get(key)
        self.deployments[key] = dep
        event = "update" if old is not None else "add"
        for fn in list(self.deployment_handlers):
            fn(event, dep, old)

    def remove_deployment(self, namespace: str, name: str) -> None:
        dep = self.deployments.pop((namespace, name), None)
        if dep is not None:
            for fn in list(self.deployment_handlers):
                fn("delete", dep, None)

    def add_replicaset(self, rs: dict) -> None:
        meta = rs["metadata"]
        self.replicasets[(meta["namespace"], meta["name"])] = rs

    def add_pod(self, pod: dict) -> None:
        meta = pod["metadata"]
        self.pods[(meta["namespace"], meta["name"])] = pod

    def add_metadata(self, md: DeploymentMetadata) -> None:
        self.metadatas[(md.namespace, md.name)] = md

    # --- KubeClient ------------------------------------------------------

    def list_namespaces(self) -> list[dict]:
        return list(self.namespaces.values())

    def get_namespace(self, name: str) -> dict:
        try:
            return self.namespaces[name]
        except KeyError:
            raise NotFound(name)

    def list_deployments(self, namespace: str | None = None) -> list[dict]:
        return [
            d
            for (ns, _), d in self.deployments.items()
            if namespace is None or ns == namespace
        ]

    def get_deployment(self, namespace: str, name: str) -> dict:
        try:
            return self.deployments[(namespace, name)]
        except KeyError:
            raise NotFound(f"{namespace}/{name}")

    def patch_deployment(self, namespace: str, name: str, patch: dict) -> dict:
        dep = self.get_deployment(namespace, name)
        old = copy.deepcopy(dep)  # handlers must see the pre-patch object
        _deep_merge(dep, patch)
        self.actions.append(("patch", "Deployment", namespace, name, patch))
        for fn in list(self.deployment_handlers):
            fn("update", dep, old)
        return dep

    def list_replicasets(self, namespace: str) -> list[dict]:
        return [r for (ns, _), r in self.replicasets.items() if ns == namespace]

    def list_pods(self, namespace: str) -> list[dict]:
        return [p for (ns, _), p in self.pods.items() if ns == namespace]

    def get_metadata(self, namespace: str, name: str) -> DeploymentMetadata:
        try:
            return self.metadatas[(namespace, name)]
        except KeyError:
            raise NotFound(f"{namespace}/{name}")

    def list_monitors(self, namespace: str | None = None) -> list[DeploymentMonitor]:
        return [
            m
            for (ns, _), m in self.monitors.items()
            if namespace is None or ns == namespace
        ]

    def get_monitor(self, namespace: str, name: str) -> DeploymentMonitor:
        try:
            return self.monitors[(namespace, name)]
        except KeyError:
            raise NotFound(f"{namespace}/{name}")

    def upsert_monitor(self, monitor: DeploymentMonitor) -> DeploymentMonitor:
        key = (monitor.namespace, monitor.name)
        old = self.monitors.get(key)
        self.monitors[key] = monitor
        self.actions.append(
            ("update" if old else "create", "DeploymentMonitor", *key, None)
        )
        for fn in list(self.monitor_handlers):
            fn("update" if old else "add", monitor, old)
        return monitor

    def patch_monitor(
        self, namespace: str, name: str, patch: dict
    ) -> DeploymentMonitor:
        """Merge-patch a monitor (what `kubectl patch --type=merge` does):
        only the patched fields change, concurrent writers are preserved."""
        old = self.get_monitor(namespace, name)
        # to_json() returns the monitor's live dicts by reference; deepcopy
        # before merging so handlers see the true pre-patch object (same
        # reason patch_deployment deepcopies).
        obj = copy.deepcopy(old.to_json())
        _deep_merge(obj, patch)
        merged = DeploymentMonitor.from_json(obj)
        self.monitors[(namespace, name)] = merged
        self.actions.append(("patch", "DeploymentMonitor", namespace, name, patch))
        for fn in list(self.monitor_handlers):
            fn("update", merged, old)
        return merged

    def delete_monitor(self, namespace: str, name: str) -> None:
        m = self.monitors.pop((namespace, name), None)
        if m is not None:
            self.actions.append(("delete", "DeploymentMonitor", namespace, name, None))
            for fn in list(self.monitor_handlers):
                fn("delete", m, None)


def record_event(
    kube: "KubeClient",
    namespace: str,
    name: str,
    reason: str,
    message: str,
    event_type: str = "Normal",
    kind: str = "Deployment",
) -> None:
    """Emit a corev1 Event against an object (the reference does this via
    an EventBroadcaster, Barrelman.go:272-276 / MonitorController.go:59-63).
    Best-effort: event failures must never affect the control loop."""
    import time

    event = {
        "apiVersion": "v1",
        "kind": "Event",
        "metadata": {
            # client-go convention: unique per emission (a counter would
            # repeat names after restart -> silent 409 drops)
            "name": f"{name}.{time.time_ns():x}",
            "namespace": namespace,
        },
        "involvedObject": {
            "kind": kind,
            "namespace": namespace,
            "name": name,
            "apiVersion": "apps/v1" if kind == "Deployment" else API_VERSION,
        },
        "reason": reason,
        "message": message,
        "type": event_type,
        "source": {"component": "foremast-watch"},
        "count": 1,
    }
    try:
        kube.create_event(namespace, event)
    except Exception:  # noqa: BLE001 - never let event plumbing break control
        import logging

        logging.getLogger("foremast_tpu_torch.watch").debug(
            "event emit failed for %s/%s %s", namespace, name, reason
        )


def _deep_merge(dst: dict, patch: dict) -> None:
    for k, v in patch.items():
        if v is None:
            dst.pop(k, None)  # strategic-merge null deletes the key
        elif isinstance(v, dict) and isinstance(dst.get(k), dict):
            _deep_merge(dst[k], v)
        else:
            dst[k] = v


# ---------------------------------------------------------------------------
# In-cluster REST client
# ---------------------------------------------------------------------------

_SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"


class HttpKube:
    """Direct REST client for the API server (in-cluster credentials).

    Covers the verbs the control plane needs: list/get/patch on apps/v1
    Deployments, list on ReplicaSets/Pods/Namespaces, CRUD on the two
    foremast CRDs. Uses blocking urllib (the plane's loop is one
    thread).

    Robustness: every request carries an
    explicit socket timeout (`timeout`, env
    ``FOREMAST_KUBE_TIMEOUT_SECONDS``, covering connect AND read — the
    urllib timeout applies to each blocking socket op), and transient
    failures on GETs retry with jittered exponential backoff under
    exactly `PrometheusSource`'s classification: HTTP 429/5xx +
    connection/timeout errors retry (`retries`, env
    ``FOREMAST_FETCH_RETRIES``), hard 4xx fails fast (404 stays
    `NotFound`). Writes (POST/PUT/PATCH/DELETE) stay single-shot: a
    timeout is AMBIGUOUS — the server may have committed — so a blind
    retry could duplicate an Event or turn a committed PUT into a
    spurious 409; the control loop's own reconcile cycle is the retry
    for writes. `chaos`/`breaker` (both default None = pass-through)
    are the ``kube`` chaos edge and its breaker, at the one request
    choke point.
    """

    def __init__(
        self,
        base_url: str | None = None,
        token: str | None = None,
        ca_file: str | None = None,
        timeout: float | None = None,
        retries: int | None = None,
        backoff_seconds: float = 0.25,
        chaos=None,
        breaker=None,
    ) -> None:
        host = os.environ.get("KUBERNETES_SERVICE_HOST", "kubernetes.default.svc")
        port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
        self.base_url = (base_url or f"https://{host}:{port}").rstrip("/")
        if token is None and os.path.exists(f"{_SA_DIR}/token"):
            with open(f"{_SA_DIR}/token") as f:
                token = f.read().strip()
        self.token = token
        ca = ca_file or (f"{_SA_DIR}/ca.crt" if os.path.exists(f"{_SA_DIR}/ca.crt") else None)
        self._ctx = ssl.create_default_context(cafile=ca) if ca else None
        if timeout is None:
            timeout = float(
                os.environ.get("FOREMAST_KUBE_TIMEOUT_SECONDS", "") or 30.0
            )
        self.timeout = timeout
        if retries is None:
            retries = int(os.environ.get("FOREMAST_FETCH_RETRIES", "") or 2)
        self.retries = max(0, int(retries))
        self.backoff_seconds = float(backoff_seconds)
        self.chaos = chaos
        self.breaker = breaker

    # the transient-status set shared with PrometheusSource: throttling
    # and server-side failures retry; configuration errors fail fast
    def _req(self, method: str, path: str, body: dict | None = None,
             content_type: str = "application/json") -> dict:
        import random as _random
        import time as _time

        from foremast_tpu_torch.metrics.source import RETRY_STATUSES

        url = f"{self.base_url}{path}"
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(url, data=data, method=method)
        req.add_header("Accept", "application/json")
        if data is not None:
            req.add_header("Content-Type", content_type)
        if self.token:
            req.add_header("Authorization", f"Bearer {self.token}")
        breaker = self.breaker
        if breaker is not None:
            breaker.allow()
        # non-idempotent verbs never retry (see class docstring)
        retries = self.retries if method == "GET" else 0
        for attempt in range(retries + 1):
            last = attempt == retries
            try:
                if self.chaos is not None:
                    self.chaos.perturb(path)
                with urllib.request.urlopen(
                    req, context=self._ctx, timeout=self.timeout
                ) as resp:
                    out = json.loads(resp.read() or b"{}")
                if breaker is not None:
                    breaker.record_success()
                return out
            except urllib.error.HTTPError as e:
                code = e.code
                e.close()
                if code not in RETRY_STATUSES:
                    # the API server ANSWERED: the endpoint is alive
                    # regardless of what it thought of the request
                    if breaker is not None:
                        breaker.record_success()
                    if code == 404:
                        raise NotFound(path) from None
                    raise
                if last:
                    if breaker is not None:
                        breaker.record_failure()
                    raise
            except OSError:
                # URLError (connection refused/reset/DNS), socket
                # timeouts, and injected chaos faults all land here
                if last:
                    if breaker is not None:
                        breaker.record_failure()
                    raise
            _time.sleep(
                self.backoff_seconds
                * (2**attempt)
                * (0.5 + 0.5 * _random.random())
            )
        raise AssertionError("unreachable")  # pragma: no cover

    # --- streaming watch (the reactive plane) ---------------------------

    def _deployments_path(self, namespace: str | None) -> str:
        return (
            f"/apis/apps/v1/namespaces/{namespace}/deployments"
            if namespace
            else "/apis/apps/v1/deployments"
        )

    def list_deployments_rv(
        self, namespace: str | None = None
    ) -> tuple[list[dict], str]:
        """One list round trip returning (items, list resourceVersion) —
        the watch resume point (a plain `list_deployments` throws the
        list's own resourceVersion away, forcing the first watch to
        start from "now" and miss anything between list and watch)."""
        out = self._req("GET", self._deployments_path(namespace))
        return out.get("items", []), str(
            (out.get("metadata") or {}).get("resourceVersion") or ""
        )

    def watch_deployments(
        self,
        namespace: str | None = None,
        resource_version: str = "",
        timeout_seconds: float = 30.0,
        stall_margin: float = 5.0,
    ):
        """Long-poll streaming watch (``?watch=true``): yields
        ``(type, object)`` pairs — type ADDED/MODIFIED/DELETED — as the
        API server writes them, until the server closes the window
        (``timeoutSeconds``) or the stream dies.

        Semantics mirror client-go's reflector contract:

          * a 410 answer OR a mid-stream ERROR event with code 410
            raises `WatchGone` — the caller must re-list (the informer
            diffs the fresh list against its snapshot, so no event is
            lost, only batched);
          * a stream STALL (the server stops writing without closing —
            half-open TCP, wedged proxy) surfaces as the socket read
            timeout: every read blocks at most ``timeout_seconds +
            stall_margin``, so a stalled stream raises `TimeoutError`
            instead of hanging the watcher forever;
          * a torn tail (disconnect mid-JSON-line) ends the stream
            cleanly at the last complete event — the caller resumes
            from the last resourceVersion it APPLIED;
          * chaos/breaker ride the same per-request seam as `_req`
            (edge ``kube``): the op string contains ``watch=true`` so
            plans can scope stream-stall rules to the watch alone. No
            retry loop here — the informer's reconnect IS the retry.
        """
        # the apiserver takes integer seconds (min 1); the client's
        # stall detector must measure from the window actually SENT,
        # or a sub-second request would read its own rounding as a
        # stalled stream
        window = max(1, int(round(timeout_seconds)))
        q = f"?watch=true&timeoutSeconds={window}"
        if resource_version:
            q += f"&resourceVersion={urllib.parse.quote(str(resource_version))}"
        path = self._deployments_path(namespace) + q
        url = f"{self.base_url}{path}"
        req = urllib.request.Request(url, method="GET")
        req.add_header("Accept", "application/json")
        if self.token:
            req.add_header("Authorization", f"Bearer {self.token}")
        from foremast_tpu_torch.metrics.source import RETRY_STATUSES

        breaker = self.breaker
        if breaker is not None:
            breaker.allow()
        try:
            # perturb INSIDE the try (the _req composition): an
            # injected fault is a ConnectionError and must land in the
            # OSError arm below so it drives breaker accounting — and a
            # half-open probe granted by allow() always records an
            # outcome
            if self.chaos is not None:
                self.chaos.perturb(path)
            resp = urllib.request.urlopen(
                req,
                context=self._ctx,
                timeout=window + max(0.0, float(stall_margin)),
            )
        except urllib.error.HTTPError as e:
            code = e.code
            e.close()
            if breaker is not None:
                # _req's policy: the API server ANSWERED, so outside
                # the transient statuses the endpoint is alive — a 403
                # on the watch path must not open the shared kube
                # breaker for the whole controller
                if code in RETRY_STATUSES:
                    breaker.record_failure()
                else:
                    breaker.record_success()
            if code == 410:
                raise WatchGone(path) from None
            raise
        except OSError:
            if breaker is not None:
                breaker.record_failure()
            raise
        if breaker is not None:
            breaker.record_success()
        import http.client as _http_client

        with resp:
            while True:
                try:
                    raw = resp.readline()
                except _http_client.HTTPException:
                    # a REAL apiserver streams chunked; a connection
                    # torn mid-chunk raises IncompleteRead (NOT an
                    # OSError) — same torn-tail semantics: end at the
                    # last complete event, resume from the applied rv
                    return
                if not raw:
                    return  # clean window end
                line = raw.strip()
                if not line:
                    continue
                try:
                    evt = json.loads(line)
                except ValueError:
                    return  # torn tail: resume from the last applied rv
                etype = evt.get("type", "")
                obj = evt.get("object") or {}
                if etype == "ERROR":
                    if int(obj.get("code", 0) or 0) == 410:
                        raise WatchGone(path)
                    # a server-side failure event (etcd leader change,
                    # internal error): surface as a connection-class
                    # error so the informer counts an ERROR restart,
                    # not a benign clean end
                    raise ConnectionError(
                        f"watch ERROR event on {path}: {obj}"
                    )
                yield etype, obj

    # --- builtin workloads ----------------------------------------------

    def list_namespaces(self) -> list[dict]:
        return self._req("GET", "/api/v1/namespaces").get("items", [])

    def get_namespace(self, name: str) -> dict:
        return self._req("GET", f"/api/v1/namespaces/{name}")

    def list_deployments(self, namespace: str | None = None) -> list[dict]:
        return self._req("GET", self._deployments_path(namespace)).get(
            "items", []
        )

    def get_deployment(self, namespace: str, name: str) -> dict:
        return self._req("GET", f"/apis/apps/v1/namespaces/{namespace}/deployments/{name}")

    def patch_deployment(self, namespace: str, name: str, patch: dict) -> dict:
        return self._req(
            "PATCH",
            f"/apis/apps/v1/namespaces/{namespace}/deployments/{name}",
            patch,
            content_type="application/strategic-merge-patch+json",
        )

    def list_replicasets(self, namespace: str) -> list[dict]:
        return self._req(
            "GET", f"/apis/apps/v1/namespaces/{namespace}/replicasets"
        ).get("items", [])

    def list_pods(self, namespace: str) -> list[dict]:
        return self._req("GET", f"/api/v1/namespaces/{namespace}/pods").get("items", [])

    def create_event(self, namespace: str, event: dict) -> dict:
        return self._req("POST", f"/api/v1/namespaces/{namespace}/events", event)

    # --- foremast CRDs ---------------------------------------------------

    def _crd_path(self, plural: str, namespace: str | None, name: str | None = None) -> str:
        p = f"/apis/{GROUP}/{VERSION}"
        if namespace:
            p += f"/namespaces/{namespace}"
        p += f"/{plural}"
        if name:
            p += f"/{urllib.parse.quote(name)}"
        return p

    def get_metadata(self, namespace: str, name: str) -> DeploymentMetadata:
        obj = self._req("GET", self._crd_path("deploymentmetadatas", namespace, name))
        return DeploymentMetadata.from_json(obj)

    def list_monitors(self, namespace: str | None = None) -> list[DeploymentMonitor]:
        items = self._req("GET", self._crd_path("deploymentmonitors", namespace)).get(
            "items", []
        )
        return [DeploymentMonitor.from_json(o) for o in items]

    def get_monitor(self, namespace: str, name: str) -> DeploymentMonitor:
        obj = self._req("GET", self._crd_path("deploymentmonitors", namespace, name))
        return DeploymentMonitor.from_json(obj)

    def upsert_monitor(self, monitor: DeploymentMonitor) -> DeploymentMonitor:
        path = self._crd_path("deploymentmonitors", monitor.namespace, monitor.name)
        try:
            existing = self._req("GET", path)
            body = monitor.to_json()
            body["metadata"]["resourceVersion"] = existing["metadata"].get(
                "resourceVersion", ""
            )
            return DeploymentMonitor.from_json(self._req("PUT", path, body))
        except NotFound:
            return DeploymentMonitor.from_json(
                self._req(
                    "POST",
                    self._crd_path("deploymentmonitors", monitor.namespace),
                    monitor.to_json(),
                )
            )

    def patch_monitor(
        self, namespace: str, name: str, patch: dict
    ) -> DeploymentMonitor:
        obj = self._req(
            "PATCH",
            self._crd_path("deploymentmonitors", namespace, name),
            patch,
            content_type="application/merge-patch+json",
        )
        return DeploymentMonitor.from_json(obj)

    def delete_monitor(self, namespace: str, name: str) -> None:
        try:
            self._req("DELETE", self._crd_path("deploymentmonitors", namespace, name))
        except NotFound:
            pass
