"""The node-free tier-routing core: one state machine for sim and production
(a copy of ``p2pfl_tpu/federation/routing.py``: host logic, no tensors).

Before this module, the tier-routing glue (which buffer an arriving
update feeds, where a node pushes its training updates, who receives a
freshly minted global, which aggregation duties a node holds) lived
TWICE: threaded inside ``workflow.AsyncContext`` and mirrored by hand in
``simfleet.SimulatedAsyncFleet`` — a routing change in one had to be
re-implemented in the other, so elastic behavior could not be validated
at 10k simulated nodes before it touched a real wire. :class:`TierRouter`
is that logic extracted into a pure function of

    ``(sorted_membership, dead_set, cluster_size)``

with no Node, no transport, no threads: both engines construct one,
re-construct it on every membership event (join, graceful leave,
eviction), and read routing decisions from it. Because the derivation is
deterministic and order-invariant, every node that agrees on the
membership view agrees on the whole topology — the same zero-coordination
trick as the deterministic trace ids.

**Membership change IS topology change.** The full membership list (live
AND dead) is chunked into clusters exactly like
:class:`~p2pfl_tpu_torch.federation.topology.HierarchicalTopology`; dead
members keep their cluster slots as *holes* instead of re-chunking, so a
death disturbs only the affected cluster's role assignments plus the
root chain (the bounded-disruption contract the property tests pin). A
join grows the membership and re-chunks — the buffer-migration machinery
(flush-or-forward on demotion, seeded creation on promotion) makes that
safe.

**Roles with holes.** A cluster's regional aggregator is its first LIVE
member; the global root is the first live regional in cluster order. So
when a regional dies, the next-sorted live member of its cluster
self-elects as successor regional, and when the global root dies, the
next-sorted live regional self-elects as successor root — zero
coordination, no election traffic. Version monotonicity across a root
handover is the successor's responsibility: it seeds its global buffer
from :class:`VersionHighWater` (the highest global version it ever
observed, including ``base_version`` fields of in-flight "vv" triples),
and :class:`~p2pfl_tpu_torch.federation.buffer.BufferedAggregator` jumps its
counter past any later-observed base version, so a minted version can
never regress below what any live node already adopted.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterable, List, NamedTuple, Optional

from p2pfl_tpu_torch.federation.topology import HierarchicalTopology


class BufferPlan(NamedTuple):
    """Which aggregation buffers a node should hold, and their K clamps.

    ``None`` means "no buffer of that tier" — an edge holds neither, a
    regional holds a cluster buffer, the global root holds a global
    buffer (plus a cluster buffer when the topology is hierarchical).
    K is clamped to the LIVE fan-in of the tier so a cluster that lost
    members still flushes (the eviction-repair contract).
    """

    regional_k: Optional[int]
    global_k: Optional[int]


class BufferOp(NamedTuple):
    """One buffer-migration step (see :meth:`TierRouter.reconcile_ops`)."""

    op: str  #: "forward" (demotion) | "create" (promotion) | "resize" (K re-clamp)
    tier: str  #: "regional" | "global"
    k: Optional[int]  #: the tier's K clamp (create/resize)
    target: Optional[str]  #: where a demoted buffer's pending forwards (forward)


class VersionHighWater:
    """The highest global model version a node has ever *observed*.

    Fed from two sources: versions the node adopted (``async_model``
    pushes / minted flushes) and the ``base_version`` field of every
    version triple that passes through it. The second source is what
    makes root failover version-safe when the successor itself missed
    the last minted globals (a partition, a dropped push): the corpse's
    freshest version still reaches the successor *inside the updates
    trained from it*, and the successor mints strictly above the mark.
    Thread-safe (production handlers feed it from delivery threads).
    """

    def __init__(self, initial: int = 0) -> None:
        self._lock = threading.Lock()
        self._mark = int(initial)

    def observe(self, version: Optional[int]) -> None:
        if version is None:
            return
        with self._lock:
            if version > self._mark:
                self._mark = int(version)

    @property
    def mark(self) -> int:
        with self._lock:
            return self._mark


class TierRouter:
    """Routing decisions for one membership view (immutable once built).

    ``members`` is the FULL membership ever observed (live and dead —
    dead members keep their cluster slots as holes, which is what bounds
    the disruption of a death); ``dead`` marks evicted/left members;
    ``cluster_size`` is the HierFAVG cluster width (0/1 = flat FedBuff).
    Membership events never mutate a router — engines build a new one
    and reconcile their buffers against its :meth:`buffer_plan`.
    """

    def __init__(
        self, members: Iterable[str], cluster_size: int = 0, dead: Iterable[str] = ()
    ) -> None:
        self.topo = HierarchicalTopology(sorted(set(members)), cluster_size)
        self.cluster_size = cluster_size
        self.dead = frozenset(dead) & set(self.topo.members)
        # per-cluster live regional (None = the whole cluster is dead)
        self._regional: List[Optional[str]] = [
            next((m for m in cluster if m not in self.dead), None)
            for cluster in self.topo.clusters
        ]
        #: live regionals in cluster order — the global tier's fan-in
        self.regionals: List[str] = [r for r in self._regional if r is not None]
        # membership probe for the per-arrival update_sink hot path (the
        # router is immutable — never rebuild this per message)
        self._regional_set = frozenset(self.regionals)
        #: the first live regional self-elects as global root (successor
        #: election = the same rule applied to the post-death view)
        self.root: Optional[str] = self.regionals[0] if self.regionals else None

    # ---- views ----

    @property
    def live_members(self) -> List[str]:
        return [m for m in self.topo.members if m not in self.dead]

    def is_live(self, addr: str) -> bool:
        return self.topo.cluster_index(addr) is not None and addr not in self.dead

    def role(self, addr: str) -> Optional[str]:
        """``"global" | "regional" | "edge" | "dead"`` — None for a
        non-member (an address this view has never seen)."""
        if self.topo.cluster_index(addr) is None:
            return None
        if addr in self.dead:
            return "dead"
        if addr == self.root:
            return "global"
        if self._regional[self.topo.cluster_index(addr)] == addr:
            return "regional"
        return "edge"

    def roles(self) -> Dict[str, str]:
        """Every member's role — the property-test surface."""
        return {m: self.role(m) for m in self.topo.members}

    # ---- routing decisions ----

    def push_target(self, addr: str) -> Optional[str]:
        """Where ``addr``'s training updates go: its cluster's live
        regional (possibly ``addr`` itself — offer locally then). A
        not-yet-chunked joiner or a fully dead cluster falls back to the
        global root."""
        ci = self.topo.cluster_index(addr)
        if ci is None:
            return self.root
        regional = self._regional[ci]
        return regional if regional is not None else self.root

    def live_children(self, addr: str) -> List[str]:
        """``addr``'s push-down fan-out for fresh globals: the root
        reaches the other live regionals; a cluster's live regional
        reaches its cluster's live members (the root is also its own
        cluster's regional — roles nest)."""
        out: List[str] = []
        if addr == self.root:
            out.extend(r for r in self.regionals if r != addr)
        ci = self.topo.cluster_index(addr)
        if ci is not None and self._regional[ci] == addr:
            out.extend(
                m for m in self.topo.clusters[ci] if m != addr and m not in self.dead
            )
        return out

    def update_sink(self, addr: str, origin: str) -> Optional[str]:
        """Which buffer an ``async_update`` arriving at ``addr`` feeds:
        ``"global"`` (a peer regional's aggregate reaching the root, or
        any arrival in a flat topology), ``"regional"`` (cluster
        contributions — at the root this also ABSORBS updates from
        demoted/orphaned producers whose aggregator died, the PR-9
        orphan-adoption semantics), or None (``addr`` holds no buffer in
        this view — the caller stashes for a possible role change)."""
        if addr == self.root:
            if self.topo.is_flat():
                return "global"
            if origin != addr and origin in self._regional_set:
                return "global"
            return "regional"
        ci = self.topo.cluster_index(addr)
        if ci is not None and self._regional[ci] == addr:
            return "regional"
        return None

    def buffer_plan(self, addr: str, k: int) -> BufferPlan:
        """The aggregation duties ``addr`` holds in this view (K clamped
        to live fan-in; see :class:`BufferPlan`)."""
        if self.topo.is_flat():
            if addr == self.root:
                return BufferPlan(None, max(1, min(k, len(self.live_members))))
            return BufferPlan(None, None)
        regional_k = None
        ci = self.topo.cluster_index(addr)
        if ci is not None and self._regional[ci] == addr:
            live = [m for m in self.topo.clusters[ci] if m not in self.dead]
            regional_k = max(1, min(k, len(live)))
        global_k = (
            max(1, min(k, len(self.regionals))) if addr == self.root else None
        )
        return BufferPlan(regional_k, global_k)

    def reconcile_ops(
        self, addr: str, k: int, has_regional: bool, has_global: bool
    ) -> List["BufferOp"]:
        """The buffer-migration steps an engine must apply to move ``addr``
        from its current buffer set to this view's :meth:`buffer_plan` —
        the SHARED reconcile contract (one more piece both engines consume
        instead of mirroring):

        - ``forward``: the tier is no longer held (demotion / leave) —
          drain the buffer raw (``BufferedAggregator.take_pending``) and
          forward each update, version triple intact, to ``op.target``
          (the successor tier: the cluster's live regional for a regional
          buffer, the global root for a global buffer). The successor's
          version vector re-dedups replays.
        - ``create``: the tier is newly held (promotion) — build the
          buffer seeded with the node's last adopted global (params AND
          version); a GLOBAL buffer additionally seeds its counter from
          the node's version high-water mark so minting never regresses
          across a root handover.
        - ``resize``: same tier, live fan-in changed — re-clamp K
          (``set_k``), which may fire the flush a dead member was
          blocking (the eviction-repair contract); the engine propagates
          the returned flush.
        """
        plan = self.buffer_plan(addr, k)
        ops: List[BufferOp] = []
        if plan.regional_k is None:
            if has_regional:
                ops.append(BufferOp("forward", "regional", None, self.push_target(addr)))
        elif not has_regional:
            ops.append(BufferOp("create", "regional", plan.regional_k, None))
        else:
            ops.append(BufferOp("resize", "regional", plan.regional_k, None))
        if plan.global_k is None:
            if has_global:
                ops.append(BufferOp("forward", "global", None, self.root))
        elif not has_global:
            ops.append(BufferOp("create", "global", plan.global_k, None))
        else:
            ops.append(BufferOp("resize", "global", plan.global_k, None))
        return ops

    def describe(self) -> dict:
        d = self.topo.describe()
        d.update(
            {
                "dead": sorted(self.dead),
                "live_regionals": list(self.regionals),
                "root": self.root,
            }
        )
        return d
