"""Multi-tenant QoS plane (the port's copy of the JAX package's
`foremast_tpu/tenant/`).

The tenant is a scheduling and accounting dimension everywhere a shared
resource is contended: one tenant's push flood must not shed every
tenant's samples, one tenant's large sweep must not delay every tenant's
verdicts, and ring and arena budgets must not be one global pool.

- :mod:`registry` — tenant resolution from the canonical series/doc
  label plus per-tenant weights and budget envelopes
  (``FOREMAST_TENANTS``, inline JSON or ``@path``).
- :mod:`accounting` — per-tenant shed/eviction/claim/ring-byte
  counters behind one leaf lock, cardinality-capped.
- :mod:`fairness` — deficit-weighted round-robin used by the sweep
  pool's slice ordering and the dirty-set drain.
- :mod:`envelopes` — ingest byte-rate governor (token buckets) whose
  429s + Retry-After target the flooding tenant's pushes.
- :mod:`collector` — the ``foremast_tenant_*`` metric families and the
  ``/debug/state`` tenants section.

The contract throughout: tenancy reorders claims and redirects
eviction/shed pressure; it never changes a verdict. With one (or zero)
tenants configured every seam keeps its zero-cost ``None`` check and
behavior is byte-identical to an untenanted build.
"""

from foremast_tpu_torch.tenant.accounting import TenantAccounting, accounting_for
from foremast_tpu_torch.tenant.collector import (
    TenantCollector,
    debug_tenants,
    register_collector,
)
from foremast_tpu_torch.tenant.envelopes import IngestGovernor
from foremast_tpu_torch.tenant.fairness import DeficitRoundRobin
from foremast_tpu_torch.tenant.registry import (
    DEFAULT_TENANT,
    OTHER_TENANT,
    TenantRegistry,
    TenantSpec,
    get_tenancy,
    set_tenancy,
    tenancy_from_env,
)

__all__ = [
    "DEFAULT_TENANT",
    "OTHER_TENANT",
    "DeficitRoundRobin",
    "IngestGovernor",
    "TenantAccounting",
    "TenantCollector",
    "TenantRegistry",
    "TenantSpec",
    "accounting_for",
    "debug_tenants",
    "register_collector",
    "get_tenancy",
    "set_tenancy",
    "tenancy_from_env",
]
