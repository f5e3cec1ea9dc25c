"""Deterministic event-driven async-fleet simulator (1k–10k virtual nodes;
counterpart of ``p2pfl_tpu/federation/simfleet.py``).

Real threaded nodes cannot replay bit-identically — the OS scheduler
decides which K updates share a buffer window. This engine replaces
threads with a **virtual clock**: every train completion, update arrival,
model push and membership event is an event on one heap, popped in
``(time, insertion seq)`` order, so the entire run — including which
updates land in which merge, every staleness value, every fault verdict,
every join/leave/failover — is a pure function of ``(seed, fault plan,
fleet shape)``. That purity is what the replay tests pin (same inputs ⇒
bit-identical final global), and what makes 1k-node hierarchical churn
drives affordable: no sockets, no sleeps, the only real compute is the
buffers' merges and the consensus task's steps, torch programs on the
fleet's ``device`` (the card by default).

The simulated fleet shares the production plane's *state machines*: the
same :class:`~p2pfl_tpu_torch.federation.buffer.BufferedAggregator` instances,
the same version triples and staleness arithmetic, and — since the
node-free routing core landed — the SAME
:class:`~p2pfl_tpu_torch.federation.routing.TierRouter` the production
``workflow.AsyncContext`` consumes: tier derivation, buffer placement,
update sinks, push-down fan-outs, successor election on death and the
version high-water handover are one implementation exercised by both
engines. Only the transport (heap events instead of ``_do_send``) and the
learner (a seeded consensus task instead of a training epoch) are
deliberate stand-ins. Faults reuse :class:`FaultPlan` semantics at the
same conceptual seam: per-edge drop/duplicate verdicts from the plan's
per-edge streams, ``slow_nodes`` as inbound latency,
``CrashSpec(stage="AsyncTrainStage", round_no=k)`` as "dies starting its
k-th local update" — and the elastic churn events ride the same plan:
``JoinSpec(at_s)`` adds a member mid-run (it bootstraps from its
aggregator's current global), ``LeaveSpec(at_s, graceful=True)`` removes
one (a graceful aggregator forwards its partial buffer to the successor
tier before exiting; an abrupt one is discovered like a crash, after
``evict_delay``), ``RestartSpec`` kills a node like a CrashSpec and
``resume_after_s`` later resurrects it from its (virtual) journal — same
address, retained sequence counters and adopted global, catching up via
a bootstrap pull — so kill-and-resurrect replays bit-exact on the
virtual clock, and ``ByzantineSpec`` attackers corrupt their payloads
on the virtual wire through the SAME ``byz_corrupt_update`` helper the
live injector runs — with ``Settings.BYZ_SCREEN`` on, each aggregator's
:class:`~p2pfl_tpu_torch.federation.defense.ByzantineDefense` screens arrivals
and a crossed suspicion threshold becomes a deterministic evict event
(the virtual stand-in for the production quarantine → eviction path).

The default workload is a consensus least-squares task: node ``i`` pulls
its model toward a seeded private target ``tᵢ``; the fleet's fixed point
is the weighted target mean over the LIVE membership, and
``loss(global) = ‖w − t̄‖²`` measures convergence — enough structure to
show time-to-target beating a barrier-synchronized fleet under
stragglers (and bounded disruption under churn), with zero ML runtime
cost.
"""

from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

import torch

from p2pfl_tpu_torch.federation.buffer import BufferedAggregator
from p2pfl_tpu_torch.federation.routing import TierRouter
from p2pfl_tpu_torch.learning.weights import ModelUpdate

Pytree = Any


@dataclass
class FleetResult:
    """What a simulated drive produced (the determinism-test surface)."""

    params: Pytree  #: final global model
    version: int  #: final global version
    virtual_time: float  #: when the last event fired
    time_to_target: Optional[float]  #: first global-flush time with loss < target
    loss_curve: List[Tuple[float, int, float]]  #: (virtual t, version, loss)
    updates_sent: int = 0
    updates_delivered: int = 0
    updates_dropped_wire: int = 0
    duplicates_injected: int = 0
    crashed: List[str] = field(default_factory=list)
    merges: int = 0
    joined: List[str] = field(default_factory=list)
    left: List[str] = field(default_factory=list)
    failovers: int = 0  #: how many times the global root changed hands
    byz_corrupted: int = 0  #: payloads corrupted by ByzantineSpec attackers
    screen_rejects: int = 0  #: contributions the admission screen refused
    quarantined: List[str] = field(default_factory=list)  #: evicted attackers
    restarted: List[str] = field(default_factory=list)  #: RestartSpec resurrections

    def final_loss(self) -> float:
        return self.loss_curve[-1][2] if self.loss_curve else float("inf")


class _SimNode:
    __slots__ = (
        "addr", "idx", "model", "base_version", "known_version", "high_water",
        "global_params", "pending_global", "seq", "updates_done", "crashed",
        "num_samples", "duration",
    )

    def __init__(self, addr: str, idx: int, model: Pytree, num_samples: int, duration: float) -> None:
        self.addr = addr
        self.idx = idx
        self.model = model
        self.base_version = 0
        self.known_version = 0
        #: highest global version observed (adoptions + arriving triples)
        #: — the seed for a promoted aggregator's version counter
        self.high_water = 0
        #: last adopted global params — what a promoted buffer seeds from
        self.global_params: Optional[Pytree] = None
        self.pending_global: Optional[Tuple[Pytree, int]] = None
        self.seq = itertools.count(1)
        self.updates_done = 0
        self.crashed = False
        self.num_samples = num_samples
        self.duration = duration


class SimulatedAsyncFleet:
    """One simulated fleet; :meth:`run` drives it to completion.

    ``train_fn(idx, params, rng) -> params`` and ``loss_fn(params) ->
    float`` default to the consensus task. ``plan`` (a
    :class:`~p2pfl_tpu_torch.communication.faults.FaultPlan`) injects
    drop/duplicate/slow/crash — and the churn events ``plan.joins`` /
    ``plan.leaves`` — exactly as the threaded chaos suite would;
    ``slow_frac``/``slow_factor`` additionally stretch a deterministic
    subset of nodes' train durations (the straggler population the async
    plane exists for). ``evict_delay`` is the virtual stand-in for the
    heartbeat eviction window: how long after a crash/abrupt leave the
    survivors re-derive the topology around the corpse. ``device`` (default
    the card, :func:`~p2pfl_tpu_torch.resolve_device`) holds every model
    tree, so the buffers' merges and the Byzantine screen run there; the
    loss is read on the host.

    **Ownership contract (copy-on-write):** params trees on the virtual
    wire are immutable and pass by REFERENCE — deliveries, adoptions,
    buffer seeds and bootstrap pulls alias the producer's tree instead
    of deep-copying it per event (the pre-megafleet per-delivery
    ``_copy_tree`` was the 1k-heap drives' hottest line). The sites that
    *change* a tree already produce fresh ones: ``train_fn`` must return
    a new tree (the default does — mutating its input in place is a
    contract violation that would corrupt aliased buffer snapshots),
    ``BufferedAggregator`` merges build new params, and ``byz_corrupt_update`` corrupts a fresh copy, never the
    honest original.
    """

    def __init__(
        self,
        n_nodes: int,
        *,
        seed: int = 0,
        cluster_size: int = 0,
        k: Optional[int] = None,
        alpha: Optional[float] = None,
        server_lr: Optional[float] = None,
        max_staleness: Optional[int] = None,
        updates_per_node: int = 4,
        base_duration: float = 1.0,
        link_delay: float = 0.01,
        slow_frac: float = 0.0,
        slow_factor: float = 10.0,
        plan=None,
        dim: int = 16,
        local_lr: float = 0.5,
        target_loss: float = 0.0,
        evict_delay: float = 0.5,
        train_fn: Optional[Callable] = None,
        loss_fn: Optional[Callable] = None,
        init_params: Optional[Pytree] = None,
        device=None,
    ) -> None:
        from p2pfl_tpu_torch import resolve_device
        from p2pfl_tpu_torch.settings import Settings

        self.device = resolve_device(device)
        self.seed = int(seed)
        self.n = int(n_nodes)
        self.updates_per_node = int(updates_per_node)
        self.link_delay = float(link_delay)
        self.plan = plan
        self.target_loss = float(target_loss)
        self.evict_delay = float(evict_delay)
        self.cluster_size = cluster_size
        self._base_duration = float(base_duration)
        self._slow_frac = float(slow_frac)
        self._slow_factor = float(slow_factor)
        self._base_k = max(1, int(Settings.FEDBUFF_K if k is None else k))
        self._alpha = alpha
        self._server_lr = server_lr
        self._max_staleness = max_staleness
        addrs = [f"sim-{i:04d}" for i in range(self.n)]
        self._members: set = set(addrs)
        self._dead: set = set()
        self.router = TierRouter(addrs, cluster_size)

        # seeded consensus task (see module docs): every node's target is
        # a SHARED offset plus private noise — the fleet's fixed point is
        # ≈ the offset, so a zero-initialized global has an O(dim) loss to
        # close and "converged" is a real statement even at n=1000 (pure
        # zero-mean targets would average to a fixed point at the origin)
        self._dim = int(dim)
        self._target_base = (
            np.random.default_rng([self.seed, 5]).normal(size=dim).astype(np.float32) * 2.0
        )
        self._targets: Dict[int, np.ndarray] = {}
        #: the targets on the fleet's device (the default train step's)
        self._targets_dev: Dict[int, torch.Tensor] = {}
        self._local_lr = float(local_lr)
        if init_params is None:
            init_params = {"w": torch.zeros(dim, dtype=torch.float32, device=self.device)}
        self._init = init_params
        self.train_fn = train_fn or self._default_train
        self.loss_fn = loss_fn or self._default_loss

        # per-node deterministic shape: duration jitter, slow membership,
        # sample weights — each from its own stream, FaultPlan-style.
        # Joiners continue the idx sequence, so their streams are as
        # deterministic as the founders'.
        self.nodes: Dict[str, _SimNode] = {}
        self._next_idx = 0
        for addr in addrs:
            self._make_node(addr)

        self._up_seq: Dict[str, Any] = {}
        #: per-node death generation for RestartSpec resurrections: a
        #: pending evict event carries the epoch of the death that armed
        #: it, so an evict that was overtaken by a resurrection (or a
        #: later second death) is a no-op instead of evicting a LIVE node
        self._death_epoch: Dict[str, int] = {}
        self._buffers: Dict[str, Dict[str, BufferedAggregator]] = {}
        #: per-aggregator admission screens (federation/defense.py) —
        #: created lazily, only under Settings.BYZ_SCREEN; no callback:
        #: quarantines are POLLED after each offer and turned into
        #: deterministic evict events on the virtual clock
        self._defenses: Dict[str, Any] = {}
        self._reconcile(0.0)

        # event heap: (time, insertion seq, kind, payload) — the seq makes
        # pop order total and therefore the whole run deterministic
        self._heap: list = []
        self._evseq = itertools.count()
        self.result = FleetResult(
            params=init_params, version=0, virtual_time=0.0,
            time_to_target=None, loss_curve=[],
        )

    @property
    def topo(self):
        """Full-membership cluster chunking (routing.TierRouter view)."""
        return self.router.topo

    def _draw_duration(self, idx: int) -> float:
        rng = np.random.default_rng([self.seed, 11, idx])
        dur = self._base_duration * (0.8 + 0.4 * float(rng.random()))
        if self._slow_frac > 0.0 and float(rng.random()) < self._slow_frac:
            dur *= self._slow_factor
        return dur

    def _make_node(self, addr: str) -> _SimNode:
        idx = self._next_idx
        self._next_idx += 1
        node = _SimNode(addr, idx, self._init, 1 + idx % 3, self._draw_duration(idx))
        self.nodes[addr] = node
        return node

    def _target(self, idx: int) -> np.ndarray:
        t = self._targets.get(idx)
        if t is None:
            t = self._targets[idx] = self._target_base + np.random.default_rng(
                [self.seed, 7, idx]
            ).normal(size=self._dim).astype(np.float32)
        return t

    def _next_up(self, addr: str) -> int:
        # persistent per-node upward counter: a re-promoted aggregator
        # continuing at seq 1 would be rejected as a replay by its
        # parent's version vector
        c = self._up_seq.get(addr)
        if c is None:
            c = self._up_seq[addr] = itertools.count(1)
        return next(c)

    def export_spec(self, extra: int = 0, allow_custom: bool = False) -> Dict[str, Any]:
        """Dense-array export of this fleet's population, the megafleet
        parity hook: :meth:`p2pfl_tpu_torch.federation.megafleet.FleetSpec.
        from_sim` builds the vectorized engine's population from exactly
        these arrays (sorted-address order == index order, so the two
        engines' fold keys agree), which lets the 1k parity tests drive the
        same fleet through both engines.

        ``extra`` appends that many pending-joiner rows past the current
        population, drawn from the per-idx streams a later join would use,
        so a churn plan's joiners carry the same durations, samples and
        targets in both engines before they exist in the heap.
        ``allow_custom`` skips only the train_fn/loss_fn check: the
        gradient-task parity pin drives the heap with a vectorized-twin
        closure and exports the same population shape."""
        if set(self._init) != {"w"}:
            raise ValueError(
                "export_spec supports the consensus-task layout ({'w': [dim]}): custom workloads have no "
                "vectorized twin")
        if not allow_custom and (
            getattr(self.train_fn, "__func__", None) is not SimulatedAsyncFleet._default_train
            or getattr(self.loss_fn, "__func__", None) is not SimulatedAsyncFleet._default_loss
        ):
            raise ValueError(
                "export_spec supports the default consensus workload: a custom train_fn/loss_fn has no "
                "vectorized twin")
        if self.n + extra > 10_000:
            # 4-digit addresses: past 10k their sorted order is no longer
            # index order (use FleetSpec.synth for larger populations)
            raise ValueError(
                "export_spec is the <=10k parity hook (4-digit address regime); use FleetSpec.synth for "
                "larger populations")
        nodes = [self.nodes[a] for a in sorted(self.nodes)]
        # (idx, addr, samples, duration): live nodes, then pending joiners
        # continuing the idx sequence
        table = [(n.idx, n.addr, n.num_samples, n.duration) for n in nodes]
        for idx in range(self._next_idx, self._next_idx + extra):
            table.append((idx, f"sim-{idx:04d}", 1 + idx % 3, self._draw_duration(idx)))
        slow = np.zeros(len(table), np.float64)
        if self.plan is not None:
            for j, t in enumerate(table):
                slow[j] = float(self.plan.slow_nodes.get(t[1], 0.0))
        init = self._init["w"]
        return {
            "durations": np.asarray([t[3] for t in table], np.float64),
            "num_samples": np.asarray([t[2] for t in table], np.float32),
            "targets": np.stack([self._target(t[0]) for t in table]).astype(np.float32),
            "slow": slow,
            "init": (init.detach().cpu().numpy() if isinstance(init, torch.Tensor) else np.asarray(init)
                     ).astype(np.float32),
            "seed": self.seed,
            "link_delay": self.link_delay,
        }

    # ---- default workload ----

    def _default_train(self, idx: int, params: Pytree, rng: np.random.Generator) -> Pytree:
        w = params["w"]
        t = self._targets_dev.get(idx)
        if t is None:
            t = self._targets_dev[idx] = torch.from_numpy(self._target(idx)).to(w.device)
        # fp32 elementwise, in the JAX package's order: bit-equal to it
        return {"w": w + self._local_lr * (t - w)}

    def _default_loss(self, params: Pytree) -> float:
        live = [a for a in self.router.live_members if a in self.nodes]
        weights = np.asarray([self.nodes[a].num_samples for a in live], np.float32)
        targets = np.stack([self._target(self.nodes[a].idx) for a in live])
        t_mean = (weights[:, None] * targets).sum(0) / weights.sum()
        diff = params["w"].detach().cpu().numpy().astype(np.float32) - t_mean
        return float(diff @ diff)

    # ---- fault plumbing (FaultPlan semantics on the virtual wire) ----

    def _edge_verdict(self, src: str, dst: str) -> Tuple[bool, bool, float]:
        """(dropped, duplicated, extra inbound latency) for one delivery."""
        slow = 0.0
        if self.plan is None:
            return False, False, slow
        slow = float(self.plan.slow_nodes.get(dst, 0.0))
        if self.plan.partitioned(src, dst):
            return True, False, slow
        fault = self.plan.edge_fault(src, dst)
        rng = self.plan.rng(src, dst)
        drop_u, dup_u, _jit_u = rng.random(), rng.random(), rng.random()
        dropped = bool(fault.drop) and drop_u < fault.drop
        dup = (not dropped) and bool(fault.duplicate) and dup_u < fault.duplicate
        return dropped, dup, slow + fault.delay

    def _crash_spec(self, addr: str):
        if self.plan is None:
            return None
        return self.plan.crashes.get(addr)

    def _restart_spec(self, addr: str):
        """The node's kill-and-resurrect spec, fire-once (the plan's
        ``_crashed`` set — the same latch the live stage hook uses, so a
        resumed node re-reaching the trigger round does not die again)."""
        if self.plan is None or addr in self.plan._crashed:
            return None
        return getattr(self.plan, "restarts", {}).get(addr)

    def _defense_for(self, addr: str):
        """The aggregator's admission screen (None when screening is off)."""
        from p2pfl_tpu_torch.settings import Settings

        if not Settings.BYZ_SCREEN:
            return None
        d = self._defenses.get(addr)
        if d is None:
            from p2pfl_tpu_torch.federation.defense import ByzantineDefense

            d = self._defenses[addr] = ByzantineDefense(addr)
        return d

    def _drain_quarantines(self, t: float, addr: str) -> None:
        """Turn an aggregator's fresh quarantine decisions into evict
        events — the virtual stand-in for the production path (defense →
        ``Neighbors.evict`` → eviction listeners → re-derivation). The
        attacker keeps training and pushing (its control plane is
        healthy); its arrivals are dropped by the quarantine gate and the
        topology re-derives around it like around any other hole."""
        d = self._defenses.get(addr)
        if d is None:
            return
        for origin in d.take_quarantined():
            if origin not in self.result.quarantined:
                self.result.quarantined.append(origin)
            self._push(t, "evict", (origin,))

    # ---- membership events (the elastic seam) ----

    def _rederive(self, t: float) -> None:
        old_root = self.router.root
        self.router = TierRouter(self._members, self.cluster_size, dead=self._dead)
        if self.router.root != old_root:
            self.result.failovers += 1
        self._reconcile(t)

    def _agg_snapshot(self, addr: str) -> Tuple[Pytree, int]:
        """An aggregator's current global view (bootstrap-pull stand-in)."""
        bufs = self._buffers.get(addr, {})
        for tier in ("global", "regional"):
            if tier in bufs:
                return bufs[tier].snapshot()
        node = self.nodes.get(addr)
        if node is not None and node.global_params is not None:
            return node.global_params, node.known_version
        return self._init, 0

    def _reconcile(self, t: float) -> None:
        """Migrate every live node's buffers to the new router's plan by
        executing the SHARED reconcile contract
        (:meth:`TierRouter.reconcile_ops`) — the same ops the production
        ``AsyncContext._reconcile_locked`` executes, so promotion
        seeding, demotion forwarding and K re-clamps cannot drift
        between the engines."""
        for addr in sorted(self.nodes):
            node = self.nodes[addr]
            if node.crashed or addr in self._dead:
                # a corpse's buffers die with it (graceful leavers already
                # forwarded theirs before this point)
                self._buffers.pop(addr, None)
                continue
            bufs = self._buffers.get(addr, {})
            ops = self.router.reconcile_ops(
                addr, self._base_k, "regional" in bufs, "global" in bufs
            )
            for op in ops:
                if op.op == "forward":
                    self._forward_pending(t, addr, bufs.pop(op.tier), op.target)
                elif op.op == "create":
                    params, version = (
                        (node.global_params, node.known_version)
                        if node.global_params is not None
                        else (self._init, 0)
                    )
                    regional = op.tier == "regional"
                    floor = version if regional else max(version, node.high_water)
                    b = BufferedAggregator(
                        addr, params, k=op.k,
                        alpha=self._alpha, server_lr=self._server_lr,
                        max_staleness=self._max_staleness, bump_on_flush=not regional,
                        defense=self._defense_for(addr),
                    )
                    if floor > 0:
                        b.set_global(params, floor)
                    bufs[op.tier] = b
                else:  # resize
                    res = bufs[op.tier].set_k(op.k)
                    if res:
                        if op.tier == "global":
                            self._on_global_flush(t, res, addr)
                        else:
                            self._propagate_regional_flush(t, addr, res)
                        self._drain_quarantines(t, addr)
            if bufs:
                self._buffers[addr] = bufs
            else:
                self._buffers.pop(addr, None)

    def _forward_pending(
        self, t: float, src: str, buf: BufferedAggregator, dst: Optional[str]
    ) -> None:
        if dst is None or dst == src:
            return
        for upd in buf.take_pending():
            self._deliver_update(t, src, dst, upd)

    def _on_join(self, t: float, addr: str) -> None:
        if addr in self.nodes:
            return
        node = self._make_node(addr)
        self._members.add(addr)
        self.result.joined.append(addr)
        self._rederive(t)
        # bootstrap: pull the aggregator's current global (async_pull) —
        # the joiner's first update then trains from the fleet's state
        target = self.router.push_target(addr)
        if target is not None and target != addr:
            params, version = self._agg_snapshot(target)
            if version > 0:
                self._push(
                    t + self.link_delay, "model_arrive",
                    (addr, params, version, target),
                )
        self._push(t + self.link_delay + node.duration, "train_done", (addr,))

    def _on_leave(self, t: float, addr: str, graceful: bool) -> None:
        node = self.nodes.get(addr)
        if node is None or node.crashed or addr in self._dead:
            return
        node.crashed = True  # stops training and arrivals
        self.result.left.append(addr)
        if not graceful:
            # abrupt: discovered like a crash, one eviction window later
            self._push(t + self.evict_delay, "evict", (addr,))
            return
        # graceful: capture the partial buffers (and the pre-leave
        # fan-out) BEFORE the re-derivation drops them, announce
        # (everyone re-derives instantly in sim), then forward the
        # partials to the successor tiers
        bufs = self._buffers.pop(addr, {})
        pre_children = self.router.live_children(addr)
        self._dead.add(addr)
        self._rederive(t)
        b = bufs.get("regional")
        if b is not None:
            self._forward_pending(t, addr, b, self.router.push_target(addr))
        b = bufs.get("global")
        if b is not None:
            self._forward_pending(t, addr, b, self.router.root)
        # hand the successor tiers the freshest global the leaver holds —
        # the same handoff as production's graceful_leave_actions (the
        # leaver may be the only node that adopted the last mint)
        if node.global_params is not None and node.known_version > 0:
            targets = (set(self.router.regionals) | set(pre_children)) - {addr}
            for tgt in sorted(targets):
                if tgt not in self._dead:
                    self._deliver_model(
                        t, addr, tgt, node.global_params, node.known_version
                    )

    def _on_evict(self, t: float, addr: str, epoch: Optional[int] = None) -> None:
        # epoch-guarded evicts come from RestartSpec deaths: if the node
        # resurrected (or died again) since this evict was armed, the
        # epoch moved on and this event is about a corpse that no longer
        # exists. Un-epoched evicts (quarantine, abrupt leave, CrashSpec)
        # stay unconditional — their targets never come back.
        if epoch is not None and self._death_epoch.get(addr, 0) != epoch:
            return
        if addr in self._dead:
            return
        self._dead.add(addr)
        self._buffers.pop(addr, None)  # a corpse's pending dies with it
        self._rederive(t)

    def _on_resurrect(self, t: float, addr: str) -> None:
        """A RestartSpec node comes back FROM ITS JOURNAL: same address,
        retained ``seq`` counter / ``high_water`` / model and adopted
        global (the :class:`_SimNode`'s in-memory retention is the
        virtual stand-in for a perfect :class:`~p2pfl_tpu_torch.federation.
        durability.NodeJournal`), re-entering through the same elastic
        seam a joiner uses — re-derivation plus a bootstrap pull that
        catches it up on any global minted while it was dead. Because
        ``seq`` continues where it stopped, upstream version vectors
        accept its first post-resurrection push and dedup any pre-crash
        in-flight duplicate — the property the live drill pins."""
        node = self.nodes.get(addr)
        if node is None or not node.crashed:
            return
        # invalidate this death's pending evict whether or not it fired
        self._death_epoch[addr] = self._death_epoch.get(addr, 0) + 1
        node.crashed = False
        self.result.restarted.append(addr)
        if addr in self._dead:
            self._dead.discard(addr)
            self._rederive(t)
        # bootstrap pull (the _on_join idiom): adopt anything newer than
        # the journaled global; _adopt's version gate drops a stale reply
        target = self.router.push_target(addr)
        if target is not None and target != addr:
            params, version = self._agg_snapshot(target)
            if version > 0:
                self._push(
                    t + self.link_delay, "model_arrive",
                    (addr, params, version, target),
                )
        if node.updates_done < self.updates_per_node:
            self._push(t + node.duration, "train_done", (addr,))

    # ---- event loop ----

    def _push(self, t: float, kind: str, payload: tuple) -> None:
        heapq.heappush(self._heap, (t, next(self._evseq), kind, payload))

    def run(self) -> FleetResult:
        for addr in sorted(self.nodes):
            self._push(self.nodes[addr].duration, "train_done", (addr,))
        if self.plan is not None:
            for addr in sorted(getattr(self.plan, "joins", {})):
                self._push(self.plan.joins[addr].at_s, "join", (addr,))
            for addr in sorted(getattr(self.plan, "leaves", {})):
                spec = self.plan.leaves[addr]
                self._push(spec.at_s, "leave", (addr, bool(spec.graceful)))
        while self._heap:
            t, _seq, kind, payload = heapq.heappop(self._heap)
            self.result.virtual_time = t
            if kind == "train_done":
                self._on_train_done(t, *payload)
            elif kind == "update_arrive":
                self._on_update_arrive(t, *payload)
            elif kind == "model_arrive":
                self._on_model_arrive(t, *payload)
            elif kind == "join":
                self._on_join(t, *payload)
            elif kind == "leave":
                self._on_leave(t, *payload)
            elif kind == "evict":
                self._on_evict(t, *payload)
            elif kind == "resurrect":
                self._on_resurrect(t, *payload)
        root = self.router.root
        gbuf = self._buffers.get(root, {}).get("global") if root else None
        if gbuf is not None:
            self.result.params, self.result.version = gbuf.snapshot()
            self.result.merges = gbuf.merges
        self.result.screen_rejects = sum(
            d.screen_rejects for d in self._defenses.values()
        )
        return self.result

    def _on_train_done(self, t: float, addr: str) -> None:
        node = self.nodes[addr]
        if node.crashed:
            return
        spec = self._crash_spec(addr)
        if (
            spec is not None
            and spec.stage == "AsyncTrainStage"
            and (spec.round_no is None or spec.round_no == node.updates_done)
        ):
            node.crashed = True
            self.result.crashed.append(addr)
            # survivors discover the corpse one eviction window later and
            # re-derive the topology around the hole (successor election,
            # K repair) — the heartbeat plane's virtual stand-in
            self._push(t + self.evict_delay, "evict", (addr,))
            return
        rspec = self._restart_spec(addr)
        if (
            rspec is not None
            and rspec.stage == "AsyncTrainStage"
            and (rspec.round_no is None or rspec.round_no == node.updates_done)
        ):
            self.plan._crashed.add(addr)
            node.crashed = True
            self.result.crashed.append(addr)
            ep = self._death_epoch.get(addr, 0) + 1
            self._death_epoch[addr] = ep
            # the evict carries this death's epoch: a resurrection that
            # lands before the eviction window closes invalidates it
            self._push(t + self.evict_delay, "evict", (addr, ep))
            self._push(t + max(rspec.resume_after_s, 1e-6), "resurrect", (addr,))
            return
        # adopt the freshest global that arrived while "training"
        if node.pending_global is not None:
            params, version = node.pending_global
            node.model = params
            node.base_version = version
            node.pending_global = None
        rng = np.random.default_rng([self.seed, 13, node.idx, node.updates_done])
        node.model = self.train_fn(node.idx, node.model, rng)
        node.updates_done += 1
        upd = ModelUpdate(node.model, [addr], node.num_samples)
        upd.version = (addr, next(node.seq), node.base_version)
        self.result.updates_sent += 1
        target = self.router.push_target(addr)
        if target is not None:
            self._deliver_update(t, addr, target, upd)
        if node.updates_done < self.updates_per_node:
            self._push(t + node.duration, "train_done", (addr,))

    def _deliver_update(self, t: float, src: str, dst: str, upd: ModelUpdate) -> None:
        if src == dst:
            self._push(t, "update_arrive", (dst, upd, src))
            return
        if self.plan is not None and self.plan.byzantine:
            # the virtual wire's _do_send seam: the SAME corruption helper
            # the live FaultInjector runs, so a plan's attack replays
            # bit-exact on the virtual clock (self-pushes above stay
            # honest, matching production where they skip the send seam)
            from p2pfl_tpu_torch.communication.faults import byz_corrupt_update

            bad = byz_corrupt_update(self.plan, src, dst, upd, "async_update")
            if bad is not None:
                self.result.byz_corrupted += 1
                upd = bad
        dropped, dup, extra = self._edge_verdict(src, dst)
        if dropped:
            self.result.updates_dropped_wire += 1
            return
        self._push(t + self.link_delay + extra, "update_arrive", (dst, upd, src))
        if dup:
            self.result.duplicates_injected += 1
            fault = self.plan.edge_fault(src, dst)
            self._push(
                t + self.link_delay + extra + max(fault.duplicate_delay, 1e-6),
                "update_arrive",
                (dst, upd, src),
            )

    def _on_update_arrive(self, t: float, dst: str, upd: ModelUpdate, src: str) -> None:
        node = self.nodes.get(dst)
        if node is None or node.crashed:
            return
        if upd.version:
            node.high_water = max(node.high_water, int(upd.version[2]))
        origin = str(upd.version[0]) if upd.version else ""
        sink = self.router.update_sink(dst, origin)
        bufs = self._buffers.get(dst)
        if sink is None or bufs is None or sink not in bufs:
            return  # mis-route under the current view (sender ahead of an event)
        self.result.updates_delivered += 1
        # screen attribution = the delivering peer (production parity:
        # the in-payload origin is attacker-controlled, a framing vector)
        if sink == "global":
            res = bufs["global"].offer(upd, screen_origin=src)
            if res:
                self._on_global_flush(t, res, dst)
        else:
            res = bufs["regional"].offer(upd, screen_origin=src)
            if res:
                self._propagate_regional_flush(t, dst, res)
        # an offer may have crossed an origin's suspicion threshold:
        # quarantine = an evict event, deterministically placed at t
        self._drain_quarantines(t, dst)

    def _propagate_regional_flush(self, t: float, addr: str, res) -> None:
        up = ModelUpdate(res.params, res.contributors, res.num_samples)
        up.version = (addr, self._next_up(addr), res.version)
        bufs = self._buffers.get(addr, {})
        if "global" in bufs:  # the root's own cluster feeding its global tier
            gres = bufs["global"].offer(up)
            if gres:
                self._on_global_flush(t, gres, addr)
            return
        root = self.router.root
        if root is not None and root != addr:
            self._deliver_update(t, addr, root, up)

    def _on_global_flush(self, t: float, res, root: str) -> None:
        loss = float(self.loss_fn(res.params))
        self.result.loss_curve.append((t, res.version, loss))
        if self.result.time_to_target is None and loss <= self.target_loss:
            self.result.time_to_target = t
        self._adopt(t, root, res.params, res.version, forward=False)
        for child in self.router.live_children(root):
            self._deliver_model(t, root, child, res.params, res.version)

    def _deliver_model(self, t: float, src: str, dst: str, params: Pytree, version: int) -> None:
        dropped, dup, extra = self._edge_verdict(src, dst)
        if dropped:
            return
        self._push(t + self.link_delay + extra, "model_arrive", (dst, params, version, src))
        if dup:
            fault = self.plan.edge_fault(src, dst)
            self._push(
                t + self.link_delay + extra + max(fault.duplicate_delay, 1e-6),
                "model_arrive",
                (dst, params, version, src),
            )

    def _on_model_arrive(self, t: float, dst: str, params: Pytree, version: int, src: str) -> None:
        self._adopt(t, dst, params, version, forward=True, source=src)

    def _adopt(
        self, t: float, addr: str, params: Pytree, version: int,
        forward: bool, source: Optional[str] = None,
    ) -> None:
        node = self.nodes.get(addr)
        if node is None or node.crashed:
            return
        node.high_water = max(node.high_water, version)
        if version <= node.known_version:
            return
        node.known_version = version
        node.global_params = params
        node.pending_global = (params, version)
        bufs = self._buffers.get(addr)
        if bufs is not None and "regional" in bufs:
            bufs["regional"].set_global(params, version)
        if forward:
            for child in self.router.live_children(addr):
                if child != source:
                    self._deliver_model(t, addr, child, params, version)


