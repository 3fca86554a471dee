"""Worker mesh: consistent-hash fleet partitioning across N workers.

The port's copy of the JAX package's `foremast_tpu/mesh/`, all host code:

  * membership: heartbeat documents in the job store
    (`mesh/membership.py`), dead peers found by lease expiry;
  * partitioning: a consistent-hash ring over live members
    (`mesh/partition.py`) gives every document's route key one owner, and
    the worker claims only its partition (claim-CAS stays the net);
  * routed ingest: each worker runs its own receiver and ring; a push for
    a series another member owns is accepted AND answered with the
    owner's address (`mesh/routing.py`), so pushers converge in one cycle;
  * rebalance: an unplanned death heals the ring, orphaned claims age out
    through the stuck-claim CAS and the new owners refit cold; a planned
    join or drain streams ring series and fits to the new owners
    (`mesh/handoff.py`) under the `joining` / `draining` fences;
  * autoscaling: `mesh/autoscale.py` turns saturation signals into
    hysteretic join and leave decisions.
"""

from foremast_tpu_torch.mesh.autoscale import AutoscaleConfig, AutoscaleDriver
from foremast_tpu_torch.mesh.handoff import HandoffManager
from foremast_tpu_torch.mesh.membership import (
    CLAIM_STATES,
    MEMBER_STATES,
    MESH_APP,
    STATE_ACTIVE,
    STATE_DRAINING,
    STATE_JOINING,
    STATUS_MESH_LEFT,
    STATUS_MESH_MEMBER,
    TARGET_STATES,
    MemberRecord,
    Membership,
    live_members,
    member_doc_id,
)
from foremast_tpu_torch.mesh.node import MeshCollector, MeshNode
from foremast_tpu_torch.mesh.partition import HashRing
from foremast_tpu_torch.mesh.routing import MeshRouter, RoutingPusher, doc_route_key, series_route_key

__all__ = [
    "CLAIM_STATES",
    "MEMBER_STATES",
    "MESH_APP",
    "STATE_ACTIVE",
    "STATE_DRAINING",
    "STATE_JOINING",
    "STATUS_MESH_LEFT",
    "STATUS_MESH_MEMBER",
    "TARGET_STATES",
    "AutoscaleConfig",
    "AutoscaleDriver",
    "HandoffManager",
    "HashRing",
    "MemberRecord",
    "Membership",
    "MeshCollector",
    "MeshNode",
    "MeshRouter",
    "RoutingPusher",
    "doc_route_key",
    "live_members",
    "member_doc_id",
    "series_route_key",
]
