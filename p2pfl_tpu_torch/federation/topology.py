"""Hierarchical aggregation topology: edge clusters → regional → global (a
copy of ``p2pfl_tpu/federation/topology.py``: host logic, no tensors).

HierFAVG (Liu et al., ICC 2020) shows that inserting an edge-aggregation
tier between clients and the cloud cuts global communication by an order
of magnitude: clients talk to a *nearby* regional aggregator every local
round, and only the regionals' already-merged aggregates cross the
expensive tier. Composed with FedBuff buffering, each tier merges at its
own cadence — a slow edge delays nothing but its own contribution.

The topology is a **pure function of the sorted member list** (plus the
cluster size), so every node derives the identical assignment with zero
coordination — the same trick as the deterministic per-round trace ids:
agreement on membership (which the heartbeat plane provides) IS agreement
on topology. The elastic layer builds on exactly that property: the
:class:`~p2pfl_tpu_torch.federation.routing.TierRouter` chunks the FULL
membership (live and dead) through this class and overlays dead members
as *holes* — a death re-elects roles only within its own cluster plus the
root chain instead of re-chunking everyone (the bounded-disruption
contract), while a join re-derives the whole assignment.

Roles nest rather than exclude: the global root is also the regional
aggregator of its own cluster and trains like any edge — aggregation is a
*duty*, not a node type. ``cluster_size <= 1`` (or ≥ the fleet) collapses
to the flat FedBuff shape: one cluster, one aggregator, no regional tier.
"""

from __future__ import annotations

from typing import Dict, List, Optional


class HierarchicalTopology:
    """Deterministic cluster assignment + aggregator election.

    ``members`` may arrive in any order; it is sorted once and chunked
    into clusters of ``cluster_size``. The first member of each cluster
    is its **regional aggregator**; the first regional is the **global
    root**. (Election by sort order is deliberate: it needs no extra
    wire traffic and re-derives identically everywhere. A production
    deployment would sort by a locality key — the mechanism is the
    point, not the key.)
    """

    def __init__(self, members: List[str], cluster_size: int = 0) -> None:
        self.members = sorted(set(members))
        if not self.members:
            raise ValueError("topology needs at least one member")
        n = len(self.members)
        if cluster_size is None or cluster_size <= 1 or cluster_size >= n:
            cluster_size = n  # flat: one cluster, one aggregator
        self.cluster_size = cluster_size
        self.clusters: List[List[str]] = [
            self.members[i : i + cluster_size] for i in range(0, n, cluster_size)
        ]
        # a trailing 1-member "cluster" would make that member its own
        # regional with no edges — fold it into the previous cluster
        if len(self.clusters) > 1 and len(self.clusters[-1]) == 1:
            self.clusters[-2].extend(self.clusters.pop())
        self.regionals: List[str] = [c[0] for c in self.clusters]
        self.global_root: str = self.regionals[0]
        self._cluster_of: Dict[str, int] = {
            addr: i for i, cluster in enumerate(self.clusters) for addr in cluster
        }

    # ---- roles ----

    def tier(self, addr: str) -> str:
        """``"global" | "regional" | "edge"`` — the node's HIGHEST duty."""
        if addr == self.global_root:
            return "global"
        if addr in self._cluster_of and addr == self.regionals[self._cluster_of[addr]]:
            return "regional"
        return "edge"

    def is_flat(self) -> bool:
        return len(self.clusters) == 1

    def cluster_index(self, addr: str) -> Optional[int]:
        """The index of ``addr``'s cluster, or None for a non-member —
        the routing layer's membership probe."""
        return self._cluster_of.get(addr)

    def cluster_of(self, addr: str) -> List[str]:
        return list(self.clusters[self._cluster_of[addr]])

    def aggregator_for(self, addr: str) -> str:
        """Where ``addr`` pushes its training updates: its cluster's
        regional (which may be ``addr`` itself — offer locally then)."""
        return self.regionals[self._cluster_of[addr]]

    def parent_of(self, addr: str) -> Optional[str]:
        """The next tier up: edge → its regional, regional → the global
        root, global root → None."""
        if addr == self.global_root:
            return None
        regional = self.aggregator_for(addr)
        return self.global_root if addr == regional else regional

    def children_of(self, addr: str) -> List[str]:
        """Who ``addr`` pushes fresh global models to (one tier down):
        the global root reaches the other regionals plus its own cluster;
        a regional reaches its cluster's edges; an edge reaches nobody."""
        out: List[str] = []
        if addr == self.global_root:
            out.extend(r for r in self.regionals if r != addr)
        if addr in self._cluster_of and addr == self.regionals[self._cluster_of[addr]]:
            out.extend(m for m in self.cluster_of(addr) if m != addr)
        return out

    def describe(self) -> dict:
        return {
            "members": len(self.members),
            "clusters": [len(c) for c in self.clusters],
            "regionals": list(self.regionals),
            "global_root": self.global_root,
            "flat": self.is_flat(),
        }
