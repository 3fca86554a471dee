"""Tenant attribution export.

`TenantCollector` is a prometheus_client custom collector over one
`TenantAccounting` ledger — the ``foremast_tenant_*`` families of the
JAX package, materialized at scrape time so none of the
charging seams (receiver admission, ring eviction, arena recycling,
claim scheduling) ever touch prometheus_client on a hot path.

Every family's ``tenant`` label is bounded by the registry's
cardinality cap (``FOREMAST_TENANT_LABEL_MAX`` + the ``other``
overflow bucket): the ledger folds names BEFORE they become keys, so
the exported label set can never exceed cap + 1 values.

`debug_tenants` renders the same ledger (plus the registry's envelope
config and the ingest governor's live buckets) as the ``tenants``
section of ``/debug/state``.
"""

from __future__ import annotations

import time

from foremast_tpu_torch.tenant.accounting import TenantAccounting


class TenantCollector:
    def __init__(self, accounting: TenantAccounting):
        self._accounting = accounting

    def collect(self):
        from prometheus_client.core import (
            CounterMetricFamily,
            GaugeMetricFamily,
        )

        snap = self._accounting.snapshot()
        shed = CounterMetricFamily(
            "foremast_tenant_shed",
            "pushes shed charged to the tenant over its ingest envelope "
            "(receiver admission 429s + decode-pool sheds blamed on the "
            "deepest-over-budget tenant); tenant label bounded by "
            "FOREMAST_TENANT_LABEL_MAX + the `other` overflow bucket",
            labels=["tenant"],
        )
        evictions = CounterMetricFamily(
            "foremast_tenant_evictions",
            "ring series + arena row evictions charged to the tenant "
            "CAUSING the pressure (the pusher/allocator, not the "
            "victim); tenant label bounded by FOREMAST_TENANT_LABEL_MAX "
            "+ the `other` overflow bucket",
            labels=["tenant"],
        )
        claims = CounterMetricFamily(
            "foremast_tenant_claims",
            "documents scheduled into sweep slices and micro-ticks, by "
            "tenant (the deficit-weighted fair share actually served); "
            "tenant label bounded by FOREMAST_TENANT_LABEL_MAX + the "
            "`other` overflow bucket",
            labels=["tenant"],
        )
        ring_bytes = GaugeMetricFamily(
            "foremast_tenant_ring_bytes",
            "resident ring bytes by tenant (the live share of the "
            "FOREMAST_RING_BYTES budget); tenant label bounded by "
            "FOREMAST_TENANT_LABEL_MAX + the `other` overflow bucket",
            labels=["tenant"],
        )
        for tenant, row in snap.items():
            shed.add_metric([tenant], row["shed"])
            evictions.add_metric([tenant], row["evictions"])
            claims.add_metric([tenant], row["claims"])
            ring_bytes.add_metric([tenant], row["ring_bytes"])
        yield shed
        yield evictions
        yield claims
        yield ring_bytes


def register_collector(prom_registry, accounting) -> bool:
    """Idempotently join ``prom_registry``'s exposition with the
    ``foremast_tenant_*`` families over ``accounting``. Safe to call
    from every worker construction: prometheus_client rejects a second
    collector exporting the same family names with ValueError, which
    here just means an earlier worker (or the lint harness) already
    wired this registry — not an error."""
    if prom_registry is None:
        return False
    try:
        prom_registry.register(TenantCollector(accounting))
        return True
    except ValueError:
        return False


def debug_tenants(
    registry,
    accounting: TenantAccounting | None = None,
    governor=None,
    now: float | None = None,
) -> dict:
    """The ``tenants`` section of ``/debug/state``: envelope config,
    the per-tenant attribution ledger, and (when the receiver wired a
    governor) the live ingest buckets."""
    out = {"registry": registry.debug_state()}
    if accounting is not None:
        out["accounting"] = accounting.snapshot()
    if governor is not None:
        out["ingest_buckets"] = governor.debug_state(
            time.monotonic() if now is None else now
        )
    return out
