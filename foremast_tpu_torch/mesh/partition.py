"""Consistent-hash partitioning: which member owns which route key.

The port's copy of the JAX package's `foremast_tpu/mesh/partition.py`,
placement for placement: the mesh shards the fleet by hashing route keys
(`mesh/routing.py`: app names for documents, the routing label for
series) onto a ring of virtual nodes, `replicas` per unit of a member's
capacity. Three properties the rest of the mesh stands on:

  * deterministic across processes and across the two packages: the hash
    is blake2b with an 8-byte digest, never Python's randomized `hash()`,
    so a mixed fleet computes the SAME owner for the same (members, key);
  * minimal movement: when a member dies, only the keys it owned move (to
    their next clockwise survivor), so a rebalance refits only the
    orphaned documents;
  * weightable: a member's `capacity` multiplies its virtual nodes, so a
    half-sized worker owns about half a share.

A `HashRing` is immutable after construction; the router swaps whole
rings on a membership change, so no lock is needed here.
"""

from __future__ import annotations

import bisect
import hashlib


def _point(data: str) -> int:
    """64-bit ring coordinate (blake2b, 8-byte digest, big-endian)."""
    return int.from_bytes(hashlib.blake2b(data.encode("utf-8"), digest_size=8).digest(), "big")


class HashRing:
    """Immutable consistent-hash ring over member ids."""

    def __init__(self, members: dict[str, int] | list[str] | tuple[str, ...], replicas: int = 64):
        """`members` is a list of ids (capacity 1 each) or an id ->
        capacity map; `replicas` virtual nodes per unit of capacity."""
        if not isinstance(members, dict):
            members = {m: 1 for m in members}
        self.replicas = max(1, int(replicas))
        self.members = tuple(sorted(members))
        points: list[tuple[int, str]] = []
        for member, capacity in members.items():
            for i in range(self.replicas * max(1, int(capacity))):
                points.append((_point(f"{member}#{i}"), member))
        points.sort()
        self._points = [p for p, _ in points]
        self._owners = [m for _, m in points]

    def __len__(self) -> int:
        return len(self.members)

    def owner(self, key: str) -> str | None:
        """The member owning `key` (the first virtual node clockwise), or
        None on an empty ring."""
        if not self._points:
            return None
        i = bisect.bisect_right(self._points, _point(key))
        return self._owners[0 if i == len(self._points) else i]

    def owns(self, key: str, member: str) -> bool:
        return self.owner(key) == member
