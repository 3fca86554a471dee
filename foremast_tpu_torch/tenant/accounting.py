"""Per-tenant accounting.

One leaf-locked ledger per registry: sheds (receiver admission +
decode-pool pressure), evictions (ring LRU + arena row recycling,
charged to the tenant CAUSING the eviction, not the one losing the
row), claims (docs scheduled into sweep slices / micro-ticks) and
resident ring bytes. The collector exports these as the
``foremast_tenant_*`` families; ``/debug/state`` renders the same
snapshot.

Tenant names are folded through the registry's metric-label cap before
they become ledger keys, so the ledger is bounded by the same
cardinality bound as the exported labels (cap + ``other`` overflow
bucket).

Lock order: the registry's resolution lock is taken and released while
folding the tenant name BEFORE the ledger lock is acquired — the two
leaf locks never nest.
"""

from __future__ import annotations

import threading

from foremast_tpu_torch.tenant.registry import TenantRegistry

_COUNTER_KINDS = ("shed", "evictions", "claims")


class TenantAccounting:
    """Thread-safe per-tenant counters. Counter kinds are monotonic;
    ``ring_bytes`` is a gauge maintained by byte deltas from the ring
    shards (clamped at zero: a shard restart must not export negative
    residency)."""

    def __init__(self, registry: TenantRegistry):
        self.registry = registry
        self._lock = threading.Lock()  # tenant.accounting (leaf)
        self.shed: dict[str, int] = {}
        self.evictions: dict[str, int] = {}
        self.claims: dict[str, int] = {}
        self.ring_bytes: dict[str, int] = {}

    def _bump(self, table: dict[str, int], tenant: str, n: int) -> None:
        # fold through the cardinality cap OUTSIDE the ledger lock
        # (registry lock and ledger lock are both leaves, never nested)
        name = self.registry.metric_tenant(tenant)
        with self._lock:
            table[name] = table.get(name, 0) + n

    def count_shed(self, tenant: str, n: int = 1) -> None:
        self._bump(self.shed, tenant, n)

    def count_eviction(self, tenant: str, n: int = 1) -> None:
        self._bump(self.evictions, tenant, n)

    def count_claims(self, tenant: str, n: int = 1) -> None:
        self._bump(self.claims, tenant, n)

    def add_ring_bytes(self, tenant: str, delta: int) -> None:
        if not delta:
            return
        name = self.registry.metric_tenant(tenant)
        with self._lock:
            cur = self.ring_bytes.get(name, 0) + delta
            self.ring_bytes[name] = cur if cur > 0 else 0

    def snapshot(self) -> dict[str, dict[str, int]]:
        """``{tenant: {shed, evictions, claims, ring_bytes}}`` over
        every tenant any table has seen, sorted for stable rendering
        (/debug/state, bench reports)."""
        with self._lock:
            tenants = (
                set(self.shed)
                | set(self.evictions)
                | set(self.claims)
                | set(self.ring_bytes)
            )
            return {
                t: {
                    "shed": self.shed.get(t, 0),
                    "evictions": self.evictions.get(t, 0),
                    "claims": self.claims.get(t, 0),
                    "ring_bytes": self.ring_bytes.get(t, 0),
                }
                for t in sorted(tenants)
            }


# One ledger per registry: the ring, arena, receiver and worker must
# all charge into the same tables or /debug/state and the collector
# would each see a partial picture.
_ACCT_LOCK = threading.Lock()  # tenant.accounting-factory (leaf)


def accounting_for(registry: TenantRegistry) -> TenantAccounting:
    acct = getattr(registry, "_accounting", None)
    if acct is None:
        with _ACCT_LOCK:
            acct = getattr(registry, "_accounting", None)
            if acct is None:
                acct = TenantAccounting(registry)
                registry._accounting = acct
    return acct
