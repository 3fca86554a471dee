"""Tenant resolution + budget envelopes.

A tenant is resolved from the canonical series/doc label named by
``FOREMAST_TENANT_LABEL`` (default ``tenant``); anything unlabeled maps
to ``default``, so an unlabeled fleet keeps today's semantics exactly.
Per-tenant weights and budget envelopes come from ``FOREMAST_TENANTS``
(inline JSON, or ``@path`` to a JSON file — the ``FOREMAST_CHAOS_PLAN``
convention). Unset means no registry: every seam keeps its zero-cost
``None`` check and nothing changes.

Envelope JSON — either a bare ``{name: spec}`` map or
``{"tenants": {name: spec}}``::

    {"acme": {"weight": 4, "ring_bytes": 4194304,
              "arena_rows": 512, "ingest_bytes_per_s": 262144},
     "default": {"weight": 1}}

All spec fields are optional; ``0`` means "no envelope" for budgets and
weights default to 1.0. Malformed JSON raises at startup — a QoS plane
that silently protects nothing is worse than a crash.

Metric-label capping is BrainGauges-style: configured tenants always
get their own label value; unconfigured-but-labeled tenants claim label
slots up to ``FOREMAST_TENANT_LABEL_MAX`` distinct values, after which
they fold into the ``other`` overflow bucket (dropped names counted
once each, warn-once).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import re
import threading
import urllib.parse

from foremast_tpu_torch.ingest.wire import canonical_series

log = logging.getLogger("foremast_tpu_torch.tenant")

DEFAULT_TENANT = "default"
OTHER_TENANT = "other"
DEFAULT_LABEL = "tenant"
DEFAULT_LABEL_MAX = 64

# label extraction from a CANONICAL selector (label values are escaped
# and sorted by wire.canonical_series, so a plain scan for
# `label="value"` is exact, not heuristic — as reactive/dirty._label_re)
_LABEL_RE_CACHE: dict[str, re.Pattern] = {}


def _label_re(label: str) -> re.Pattern:
    pat = _LABEL_RE_CACHE.get(label)
    if pat is None:
        pat = re.compile(r'[{,]\s*%s="((?:[^"\\]|\\.)*)"' % re.escape(label))
        _LABEL_RE_CACHE[label] = pat
    return pat


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant's scheduling weight and budget envelopes. A budget of
    0 means "no envelope" — the tenant competes under the global caps
    only, exactly as in an untenanted process."""

    name: str
    weight: float = 1.0
    ring_bytes: int = 0
    arena_rows: int = 0
    ingest_bytes_per_s: int = 0
    burst_bytes: int = 0

    @classmethod
    def from_json(cls, name: str, obj) -> "TenantSpec":
        if not isinstance(obj, dict):
            raise ValueError(f"tenant {name!r}: spec must be an object")
        known = {
            "weight",
            "ring_bytes",
            "arena_rows",
            "ingest_bytes_per_s",
            "burst_bytes",
        }
        bad = set(obj) - known
        if bad:
            raise ValueError(f"tenant {name!r}: unknown fields {sorted(bad)}")
        weight = float(obj.get("weight", 1.0))
        if weight <= 0:
            raise ValueError(f"tenant {name!r}: weight must be > 0")
        return cls(
            name=name,
            weight=weight,
            ring_bytes=int(obj.get("ring_bytes", 0)),
            arena_rows=int(obj.get("arena_rows", 0)),
            ingest_bytes_per_s=int(obj.get("ingest_bytes_per_s", 0)),
            burst_bytes=int(obj.get("burst_bytes", 0)),
        )


_DEFAULT_SPEC = TenantSpec(name=DEFAULT_TENANT)


class TenantRegistry:
    """Tenant resolution + spec lookup. Resolution caches are bounded
    and guarded by one leaf lock; spec data is immutable after
    construction so reads need no lock."""

    def __init__(
        self,
        specs: dict[str, TenantSpec],
        label: str | None = None,
        label_max: int = DEFAULT_LABEL_MAX,
    ):
        self.label = label or tenant_label()
        self.specs = dict(specs)
        self.label_max = max(int(label_max), 1)
        # >= 2 configured tenants activates fair scheduling; with one
        # (or zero) the claim order must stay byte-identical to an
        # untenanted build (the parity pin)
        self.fair = len(self.specs) >= 2
        self._lock = threading.Lock()  # tenant.registry (leaf)
        self._doc_cache: dict[str, str] = {}
        self._series_cache: dict[str, str] = {}
        self._key_cache: dict = {}
        self._cache_max = 65536
        # metric-label cardinality cap (BrainGauges-style): configured
        # tenants are always exported; unknown labels claim slots up to
        # label_max, then fold into the `other` overflow bucket
        self._metric_names: set[str] = set(self.specs) | {DEFAULT_TENANT}
        # the cap budget covers UNCONFIGURED values only — configured
        # tenants (+ default) are the operator's own bounded set and
        # must never crowd the observation budget (or vice versa)
        self._configured_names = len(self._metric_names)
        self._dropped_names: set[str] = set()
        self._dropped_track_limit = max(4 * self.label_max, 1024)
        self.dropped_label_values = 0
        self._cap_warned = False

    # -- spec lookup ----------------------------------------------------

    def spec(self, tenant: str) -> TenantSpec:
        s = self.specs.get(tenant)
        if s is not None:
            return s
        return _DEFAULT_SPEC

    def weight(self, tenant: str) -> float:
        return self.spec(tenant).weight

    def weights(self) -> dict[str, float]:
        return {name: s.weight for name, s in self.specs.items()}

    # -- resolution -----------------------------------------------------

    def _extract(self, text: str) -> str:
        m = _label_re(self.label).search(text)
        if m:
            return m.group(1)
        return DEFAULT_TENANT

    def tenant_of_series(self, key: str) -> str:
        """Tenant of a pushed/stored series, from its canonical
        selector. Unlabeled series -> ``default``."""
        with self._lock:
            t = self._series_cache.get(key)
            if t is not None:
                return t
        t = self._extract(canonical_series(key))
        with self._lock:
            if len(self._series_cache) >= self._cache_max:
                self._series_cache.clear()
            self._series_cache[key] = t
        return t

    def tenant_of_doc(self, doc) -> str:
        """Tenant of a document, from the tenant label inside its query
        config strings (URL-encoded PromQL selectors included — the
        config is unquoted before the scan). Cached by doc id: ids are
        content-addressed, so the resolution is immutable per id."""
        doc_id = getattr(doc, "id", None)
        if doc_id is not None:
            with self._lock:
                t = self._doc_cache.get(doc_id)
                if t is not None:
                    return t
        text = "%s\n%s" % (
            getattr(doc, "current_config", "") or "",
            getattr(doc, "historical_config", "") or "",
        )
        t = self._extract(urllib.parse.unquote(text))
        if doc_id is not None:
            with self._lock:
                if len(self._doc_cache) >= self._cache_max:
                    self._doc_cache.clear()
                self._doc_cache[doc_id] = t
        return t

    def tenant_of_key(self, key) -> str:
        """Tenant of an arena fit key. Univariate keys embed the
        history URL (URL-encoded selector, tenant label included);
        joint keys carry only app/alias names and resolve to
        ``default`` unless an alias happens to carry the label."""
        try:
            hash(key)
            hashable = True
        except TypeError:
            hashable = False
        if hashable:
            with self._lock:
                t = self._key_cache.get(key)
                if t is not None:
                    return t
        t = self._extract(urllib.parse.unquote(str(key)))
        if hashable:
            with self._lock:
                if len(self._key_cache) >= self._cache_max:
                    self._key_cache.clear()
                self._key_cache[key] = t
        return t

    # -- metric-label capping -------------------------------------------

    def metric_tenant(self, tenant: str) -> str:
        """The label value to export for ``tenant``: itself while under
        the cardinality cap, ``other`` past it. Configured tenants and
        ``default`` always export; the cap only bounds unconfigured
        label values (a tenant-shaped cardinality attack on the
        registry's histograms)."""
        with self._lock:
            if tenant in self._metric_names:
                return tenant
            if (
                len(self._metric_names) - self._configured_names
                < self.label_max
            ):
                self._metric_names.add(tenant)
                return tenant
            if tenant not in self._dropped_names:
                if len(self._dropped_names) < self._dropped_track_limit:
                    self._dropped_names.add(tenant)
                self.dropped_label_values += 1
                if not self._cap_warned:
                    self._cap_warned = True
                    log.warning(
                        "tenant label cardinality cap (%d) reached; "
                        "folding new tenant label values into %r",
                        self.label_max,
                        OTHER_TENANT,
                    )
            return OTHER_TENANT

    # -- introspection --------------------------------------------------

    def debug_state(self) -> dict:
        with self._lock:
            exported = len(self._metric_names)
            dropped = self.dropped_label_values
        return {
            "label": self.label,
            "configured": {
                name: dataclasses.asdict(s)
                for name, s in sorted(self.specs.items())
            },
            "fair": self.fair,
            "label_max": self.label_max,
            "label_values_exported": exported,
            "label_values_dropped": dropped,
        }


# -- env wiring ---------------------------------------------------------


def tenant_label(env=None) -> str:
    e = os.environ if env is None else env
    return e.get("FOREMAST_TENANT_LABEL", "") or DEFAULT_LABEL


def _label_max(env=None) -> int:
    e = os.environ if env is None else env
    raw = e.get("FOREMAST_TENANT_LABEL_MAX", "")
    if not raw:
        return DEFAULT_LABEL_MAX
    try:
        return max(int(raw), 1)
    except ValueError:
        log.warning(
            "FOREMAST_TENANT_LABEL_MAX=%r is not an int; using %d",
            raw,
            DEFAULT_LABEL_MAX,
        )
        return DEFAULT_LABEL_MAX


def tenancy_from_env(env=None) -> TenantRegistry | None:
    """Build the registry from ``FOREMAST_TENANTS`` (inline JSON, or
    ``@path`` to a JSON file); None when unset — the caller then wires
    NO seams and every client keeps its zero-cost None check. Malformed
    envelopes raise: a QoS plane that silently protects nothing is
    worse than a crash at startup."""
    e = os.environ if env is None else env
    raw = e.get("FOREMAST_TENANTS", "")
    if not raw:
        return None
    if raw.startswith("@"):
        with open(raw[1:], encoding="utf-8") as fh:
            raw = fh.read()
    obj = json.loads(raw)
    if not isinstance(obj, dict):
        raise ValueError("FOREMAST_TENANTS: top level must be an object")
    tenants = obj.get("tenants", obj)
    if not isinstance(tenants, dict):
        raise ValueError("FOREMAST_TENANTS: 'tenants' must be an object")
    specs = {
        str(name): TenantSpec.from_json(str(name), spec)
        for name, spec in tenants.items()
    }
    reg = TenantRegistry(
        specs, label=tenant_label(e), label_max=_label_max(e)
    )
    log.info(
        "tenant QoS plane active: %d tenant(s) on label %r, fair=%s",
        len(specs),
        reg.label,
        reg.fair,
    )
    return reg


# Process-global registry: the worker, receiver, ring and arena all see
# one resolution + accounting view. Lazily built from env on first use;
# tests/benches swap it with set_tenancy().
_GLOBAL_LOCK = threading.Lock()  # tenant.global (leaf)
_GLOBAL: TenantRegistry | None = None
_GLOBAL_SET = False


def get_tenancy() -> TenantRegistry | None:
    global _GLOBAL, _GLOBAL_SET
    with _GLOBAL_LOCK:
        if _GLOBAL_SET:
            return _GLOBAL
    # build OUTSIDE the lock: an @path envelope opens a file, and the
    # global lock is a leaf that must never wrap I/O. Two threads racing
    # here both build the same registry (deterministic from env) and only
    # the first install wins.
    reg = tenancy_from_env()
    with _GLOBAL_LOCK:
        if not _GLOBAL_SET:
            _GLOBAL = reg
            _GLOBAL_SET = True
        return _GLOBAL


def set_tenancy(reg: TenantRegistry | None) -> TenantRegistry | None:
    """Install (or clear) the process-global registry; returns the
    previous one so tests can restore it."""
    global _GLOBAL, _GLOBAL_SET
    with _GLOBAL_LOCK:
        prev = _GLOBAL if _GLOBAL_SET else None
        _GLOBAL = reg
        _GLOBAL_SET = True
        return prev
