"""The async learning workflow: train → push → merge, no round barrier
(counterpart of ``p2pfl_tpu/federation/workflow.py``).

Selected by ``Settings.FEDERATION_MODE == "async"`` in
``Node._run_learning`` — the learning thread runs this instead of the
stages FSM. Control flow per node:

1. **Init sync** — identical to the sync plane
   (``stages.learning_stages.sync_initial_model``): everyone starts from
   the initiator's weights, version 0. A node *joining* a running
   experiment (``Node.join_async_experiment``) skips this and instead
   bootstraps by pulling the nearest aggregator's current global
   (``async_pull``) before contributing.
2. **Topology** — every node derives the same
   :class:`~p2pfl_tpu_torch.federation.routing.TierRouter` from its sorted
   membership view (``Settings.HIER_CLUSTER_SIZE``) — and RE-derives it
   on every membership event: a join, a graceful leave (``async_leave``)
   or an eviction is a topology change, handled by migrating buffer
   state (promotion seeds from the version high-water mark, demotion
   flushes-or-forwards its partial buffer) rather than restarting.
3. **Local loop** — each node trains ``total_rounds`` local updates
   (reusing the fused-round learner path where the learner supports it),
   stamps each with its version triple, and pushes it to its cluster's
   regional aggregator. Between updates it adopts the freshest global
   model that arrived (``async_model`` push) — it never *waits* for one.
4. **Aggregation duties** — regional/global buffers
   (:class:`~p2pfl_tpu_torch.federation.buffer.BufferedAggregator`) run inside
   the receive handlers (``commands/federation.py``): a flush at a
   regional pushes ONE aggregate up; a flush at the global root mints a
   new global version and pushes it down the tiers. When the root dies,
   the next-sorted live regional self-elects as successor root (the same
   zero-coordination derivation) and resumes minting above the high-water
   mark carried in the "vv" triples, so versions never regress.
5. **Drain** — a node that finished its budget broadcasts ``async_done``;
   aggregators keep serving until every member is done or dead (bounded
   by ``Settings.ASYNC_DRAIN_TIMEOUT``), so slow members' tails still
   merge.

Every push rides ``protocol.send`` / the gossiper's concurrent dispatch
pool over the single ``_do_send`` seam — FaultPlan chaos, breaker-fed
eviction, retry accounting and telemetry send spans all apply unchanged,
and under ``Settings.WEIGHTS_PLANE="ici"`` a push between two nodes on the
shard plane moves slot to slot (``communication/ici.py::try_shard_send``;
kernel 9 on a card).
Fan-outs (a fresh global to N children) go through
``Gossiper._dispatch_sends`` so one slow child costs a worker slot, not
the push.

Not composed in this control plane (guarded loudly at start):
``SECURE_AGGREGATION`` (pairwise masks need a fixed cohort per merge —
a buffer of whoever-arrived breaks cancellation) and
``WIRE_COMPRESSION="topk8"`` (delta anchors are pinned per sync round;
the async plane has no shared round to anchor on). Dense and ``int8``
wire compression work as-is.
"""

from __future__ import annotations

import threading
import time
from typing import TYPE_CHECKING, Any, List, Optional, Tuple

from p2pfl_tpu_torch.federation.buffer import BufferedAggregator, FlushResult
from p2pfl_tpu_torch.federation.durability import SeqCounter, rebuild_updates
from p2pfl_tpu_torch.federation.routing import TierRouter, VersionHighWater
from p2pfl_tpu_torch.federation.staleness import as_version, xp_mismatch
from p2pfl_tpu_torch.learning.weights import ModelUpdate
from p2pfl_tpu_torch.management.logger import logger
from p2pfl_tpu_torch.management.telemetry import telemetry
from p2pfl_tpu_torch.settings import Settings

if TYPE_CHECKING:
    from p2pfl_tpu_torch.node import Node

Pytree = Any

#: outbound action: (weights command, target address, update)
Action = Tuple[str, str, ModelUpdate]




class AsyncContext:
    """Per-experiment async state attached to the node (``node.async_ctx``).

    Owns the node's aggregation buffers (placed by the
    :class:`~p2pfl_tpu_torch.federation.routing.TierRouter`'s buffer plan) and
    the freshest-global mailbox. The router is swapped — never mutated —
    on every membership event, and :meth:`_reconcile_locked` migrates the
    buffers to the new plan. The locking contract that keeps the
    in-memory transport's synchronous delivery chains deadlock-free:
    **no lock is ever held across a send** — handlers compute under
    locks, collect :data:`Action` tuples, and :meth:`execute_actions`
    runs outside every lock (the context lock is an RLock so flush
    propagation can nest under a reconcile).
    """

    def __init__(
        self,
        node: "Node",
        router: TierRouter,
        params: Pytree,
        xid: Optional[str] = None,
        joining: bool = False,
    ) -> None:
        self.node = node
        self.addr = node.addr
        self.lock = threading.RLock()
        self.accepting = True
        self.router = router
        #: every member ever observed (monotone — dead members keep their
        #: cluster slots as holes, the bounded-disruption contract)
        self.members = set(router.topo.members)
        self._dead = set(router.dead)
        #: experiment identity stamped on the wire ("xp" header); a joiner
        #: starts without one and adopts it from its bootstrap global
        self.xid = xid
        #: the newest global version this node KNOWS about (its learner
        #: may lag until the loop adopts pending_global). A joiner starts
        #: at -1 so a version-0 bootstrap global still passes the adopt
        #: gate (an experiment whose root has not minted yet).
        self.global_version = -1 if joining else 0
        #: the version the learner's current params came from — what the
        #: node stamps as base_version on its next update
        self.base_version = 0
        #: highest global version ever OBSERVED (adoptions + the
        #: base_version of every "vv" triple passing through) — what a
        #: successor root seeds its minting from (routing.py docs)
        self.high_water = VersionHighWater()
        self.pending_global: Optional[Tuple[Pytree, int]] = None
        #: last adopted/minted global (params, version) — what the drain's
        #: final-sync re-pushes carry
        self.last_global: Optional[Tuple[Pytree, int]] = None
        #: encode-once for drain re-pushes: one ModelUpdate per version,
        #: reused across ticks/children so byte transports serialize the
        #: full model once per version, not once per re-push fan-out
        self._final_push: Optional[Tuple[int, ModelUpdate]] = None
        #: experiment-start params — seeds promoted buffers before any
        #: global exists
        self._init_params = params
        #: set by a membership re-derivation; the workflow drains the
        #: async stash when it observes it (a stashed update may be
        #: routable under the new roles)
        self._stash_dirty = False
        #: counts every async_model that passed the experiment gates —
        #: lets a pull's wait loop stop as soon as the reply ARRIVED,
        #: even when its version is one the adopt gate rejects as held
        self.models_seen = 0
        #: this node's most recent own training update / upward
        #: aggregate: when a re-derivation CHANGES the push target (the
        #: old aggregator died), the last push may have died with it —
        #: mid-run the next update supersedes it, but near the run's end
        #: nothing does, so the re-derivation re-pushes it to the
        #: successor (the update-plane twin of the drain's final-sync
        #: model re-push; the successor's version vector drops the copy
        #: if the original somehow also arrived)
        self.last_own_update: Optional[ModelUpdate] = None
        self.last_up_push: Optional[ModelUpdate] = None
        #: the aggregator a joiner is pulling its bootstrap global from —
        #: while set, async_model is accepted ONLY from it (and the
        #: experiment identity is adopted only from it): a previous
        #: experiment's redelivered straggler must not seed the joiner's
        #: model or bind it to the wrong xid while its adopt gate is at
        #: -1. Cleared when the bootstrap window closes.
        self._bootstrap_from: Optional[str] = None
        #: per-node monotone counters: training updates vs upward
        #: regional aggregates are deduped in DIFFERENT version vectors,
        #: but each stream must be monotone on its own — and must survive
        #: role changes (a re-promoted aggregator continuing at seq 1
        #: would be rejected as a replay by its parent's version vector).
        #: SeqCounter (not itertools.count) so the journal can read the
        #: stream position and a resurrection can resume strictly past it
        self.train_seq = SeqCounter(1)
        self._up_seq = SeqCounter(1)
        self.rbuf: Optional[BufferedAggregator] = None
        self.gbuf: Optional[BufferedAggregator] = None
        self._apply_initial_plan()

    def _apply_initial_plan(self) -> None:
        plan = self.router.buffer_plan(self.addr, Settings.FEDBUFF_K)
        defense = self.node.defense
        if plan.regional_k is not None:
            self.rbuf = BufferedAggregator(
                self.addr, self._init_params, k=plan.regional_k,
                bump_on_flush=False, defense=defense,
            )
        if plan.global_k is not None:
            self.gbuf = BufferedAggregator(
                self.addr, self._init_params, k=plan.global_k, defense=defense
            )

    @property
    def is_aggregator(self) -> bool:
        return self.rbuf is not None or self.gbuf is not None

    # ---- mailbox ----

    def take_pending_global(self) -> Optional[Tuple[Pytree, int]]:
        with self.lock:
            pend, self.pending_global = self.pending_global, None
        return pend

    def _adopt(self, params: Pytree, version: int) -> bool:
        """Record a newer global: mailbox for the learner + regional
        buffer re-base. False for stale pushes."""
        with self.lock:
            if version <= self.global_version:
                return False
            self.global_version = version
            self.high_water.observe(version)
            self.pending_global = (params, version)
            self.last_global = (params, version)
            rbuf = self.rbuf
        if rbuf is not None:
            rbuf.set_global(params, version)
        return True

    # ---- membership events (joins, leaves, evictions) ----

    def add_member(self, addr: str) -> List[Action]:
        """A joiner ANNOUNCED itself (``async_join``, TTL-flooded): fold
        it into the membership and re-derive.

        Membership is MONOTONE: joiners are added on their announcement
        (mere overlay presence is NOT membership — a monitor or a
        not-yet-joined node connecting mid-run must not be elected
        aggregator and blackhole a tier), departures are handled by
        :meth:`mark_dead` (eviction / ``async_leave``) so dead members
        keep their cluster slots as holes. Returns the buffer-migration
        sends the re-derivation produced."""
        with self.lock:
            if addr in self.members:
                return []
            self.members.add(addr)
            return self._rederive_locked("join", {"joined": [addr]})

    def merge_view(self, members, dead) -> List[Action]:
        """Fold a peer's ``(members, dead)`` view in (monotone union) —
        the ``async_view`` reply a bootstrap pull carries.

        A joiner's own heartbeat view lacks the dead members every
        survivor keeps as cluster HOLES (a corpse evicted before the
        join never enters the joiner's overlay view), so deriving only
        from its live view would chunk clusters differently from the
        rest of the fleet — permanently. Merging the serving
        aggregator's view restores the shared derivation."""
        with self.lock:
            new_members = set(members) - self.members
            new_dead = {
                d for d in dead if d != self.addr and d not in self._dead
            }
            if not new_members and not new_dead:
                return []
            self.members |= new_members | set(new_dead)
            self._dead |= new_dead
            return self._rederive_locked(
                "view_merge",
                {"joined": sorted(new_members), "dead": sorted(new_dead)},
            )

    def mark_dead(self, addr: str, reason: str = "evicted") -> List[Action]:
        """A member died or left: re-derive the topology with it as a
        hole. Successor roles self-elect in the re-derivation (the next
        live member of a dead regional's cluster; the next live regional
        for a dead root), K clamps shrink to the live fan-in (may fire
        the flush the corpse was blocking — the eviction-repair
        contract), and this node's own buffers migrate to its new plan.
        Returns the sends all of that produced."""
        with self.lock:
            if addr == self.addr or addr in self._dead or addr not in self.members:
                return []
            self._dead.add(addr)
            return self._rederive_locked(reason, {"member": addr})

    def _rederive_locked(self, event: str, attrs: dict) -> List[Action]:
        old = self.router
        self.router = TierRouter(self.members, old.cluster_size, dead=self._dead)
        new = self.router
        logger.log_comm_metric(self.addr, "membership_changed")
        telemetry.event(
            self.addr,
            "membership_changed",
            kind="stage",
            attrs={
                "event": event,
                "members": len(self.members),
                "dead": len(self._dead),
                **attrs,
            },
        )
        old_role, new_role = old.role(self.addr), new.role(self.addr)
        if old_role != new_role:
            logger.log_comm_metric(self.addr, "role_changed")
            telemetry.event(
                self.addr,
                "role_changed",
                kind="stage",
                attrs={"from": old_role, "to": new_role},
            )
            logger.info(self.addr, f"Async role change: {old_role} → {new_role} ({event})")
        if new.root == self.addr and old.root != self.addr:
            floor = max(self.global_version, self.high_water.mark)
            logger.log_comm_metric(self.addr, "root_failover")
            telemetry.event(
                self.addr,
                "root_failover",
                kind="stage",
                attrs={"old_root": old.root, "seed_version": floor},
            )
            logger.warning(
                self.addr,
                f"Global-root failover: {old.root} → {self.addr} "
                f"(minting resumes above v{floor})",
            )
        self._stash_dirty = True
        actions = self._reconcile_locked(new)
        # the update-plane twin of the final-sync re-push: a changed push
        # target means the old aggregator (and whatever of ours it held)
        # is gone — hand the successor our freshest contribution; its
        # version vector dedups any copy that survived
        if (
            old.push_target(self.addr) != new.push_target(self.addr)
            and self.last_own_update is not None
        ):
            target = new.push_target(self.addr)
            if target is not None:
                actions.append(("async_update", target, self.last_own_update))
        if (
            old.root != new.root
            and self.last_up_push is not None
            and new.root is not None
            and new.root != self.addr
        ):
            actions.append(("async_update", new.root, self.last_up_push))
        return actions

    def _global_snapshot_locked(self) -> Tuple[Pytree, int]:
        if self.last_global is not None:
            return self.last_global
        return self._init_params, 0

    def _reconcile_locked(self, router: TierRouter) -> List[Action]:
        """Migrate this node's buffers to the new router's plan by
        executing the SHARED reconcile contract
        (:meth:`TierRouter.reconcile_ops` — the simulator executes the
        same ops, so promotion seeding, demotion forwarding and K
        re-clamps cannot drift between engines)."""
        actions: List[Action] = []
        ops = router.reconcile_ops(
            self.addr,
            Settings.FEDBUFF_K,
            self.rbuf is not None,
            self.gbuf is not None,
        )
        for op in ops:
            regional = op.tier == "regional"
            if op.op == "forward":
                buf = self.rbuf if regional else self.gbuf
                pending = buf.take_pending()
                if regional:
                    self.rbuf = None
                else:
                    self.gbuf = None
                if pending and op.target is not None and op.target != self.addr:
                    logger.log_comm_metric(
                        self.addr, "async_buffer_migrated", len(pending)
                    )
                    actions += [("async_update", op.target, u) for u in pending]
            elif op.op == "create":
                params, version = self._global_snapshot_locked()
                if regional:
                    self.rbuf = BufferedAggregator(
                        self.addr, params, k=op.k, bump_on_flush=False,
                        defense=self.node.defense,
                    )
                    if version > 0:
                        self.rbuf.set_global(params, version)
                else:
                    floor = max(version, self.global_version, self.high_water.mark)
                    self.gbuf = BufferedAggregator(
                        self.addr, params, k=op.k, defense=self.node.defense
                    )
                    if floor > 0:
                        self.gbuf.set_global(params, floor)
            else:  # resize
                buf = self.rbuf if regional else self.gbuf
                res = buf.set_k(op.k)
                if res:
                    logger.log_comm_metric(self.addr, "async_k_repair")
                    actions += (
                        self._regional_flush(res) if regional else self._global_flush(res)
                    )
        return actions

    def take_stash_dirty(self) -> bool:
        with self.lock:
            dirty, self._stash_dirty = self._stash_dirty, False
        return dirty

    # ---- crash-resurrection (federation/durability.py) ----

    def restore_from_journal(self, snap) -> List[Action]:
        """Re-arm this context from a recovered journal snapshot — the
        resurrection's second half, run on the learning thread right
        after the stash drain and BEFORE the elastic bootstrap join.

        Restores, in order: the journaled ``(members, dead)`` view
        (monotone union + re-derive, exactly like ``merge_view`` — the
        resurrectee's fresh heartbeat view lacks the dead members every
        survivor keeps as cluster holes); the version state (high-water,
        adopted global pre-seeded into the mailbox so ``_bootstrap_join``
        returns instantly and the pull only fetches anything NEWER the
        fleet minted meanwhile); the own-sequence counters, resumed
        strictly past the journaled position plus
        ``Settings.JOURNAL_SEQ_MARGIN`` (covers updates minted after the
        last snapshot but before the crash — upstream VersionVectors
        treat the gap as lost updates, never as replays); each journaled
        buffer tier (version floor + VV marks + pending re-buffered, or
        — when the restart's re-derivation demoted this node — the
        pending successor-forwarded raw with original triples, the PR-11
        migration idiom); and the Byzantine suspicion/quarantine state.
        Returns the actions all of that produced (possible flushes,
        migration forwards) for the caller to execute outside the lock.
        """
        actions: List[Action] = []
        with self.lock:
            new_members = set(snap.members) - self.members
            new_dead = {
                d for d in snap.dead if d != self.addr and d not in self._dead
            }
            if new_members or new_dead:
                self.members |= new_members | set(new_dead)
                self._dead |= new_dead
                actions += self._rederive_locked(
                    "journal_recover",
                    {"joined": sorted(new_members), "dead": sorted(new_dead)},
                )
            if (
                snap.global_params is not None
                and snap.global_version > self.global_version
            ):
                self.global_version = snap.global_version
                self.pending_global = (snap.global_params, snap.global_version)
                self.last_global = (snap.global_params, snap.global_version)
            self.base_version = max(self.base_version, snap.base_version)
            self.high_water.observe(snap.high_water)
            margin = max(0, int(Settings.JOURNAL_SEQ_MARGIN))
            self.train_seq = SeqCounter(
                max(self.train_seq.next_value, snap.train_seq + margin)
            )
            self._up_seq = SeqCounter(
                max(self._up_seq.next_value, snap.up_seq + margin)
            )
            rbuf = self.rbuf
            if rbuf is not None and self.last_global is not None:
                rbuf.set_global(*self.last_global)
            for bj in snap.buffers:
                regional = bj.tier == "regional"
                buf = self.rbuf if regional else self.gbuf
                updates = rebuild_updates(bj, self.xid)
                if buf is not None:
                    res = buf.restore_journal(bj.version, bj.vv, updates)
                    if res:
                        actions += (
                            self._regional_flush(res)
                            if regional
                            else self._global_flush(res)
                        )
                elif updates:
                    # the restart landed this node in a smaller role than
                    # it died in: forward the journaled pending raw to the
                    # successor tier, original triples intact — its own
                    # version vector re-dedups any copy that also reached
                    # it directly while we were dead
                    target = (
                        self.router.push_target(self.addr)
                        if regional
                        else self.router.root
                    )
                    if target is not None:
                        logger.log_comm_metric(
                            self.addr, "async_buffer_migrated", len(updates)
                        )
                        actions += [("async_update", target, u) for u in updates]
            restored_pending = sum(len(b.pending) for b in snap.buffers)
        self.node.defense.restore(snap.suspicion, snap.quarantined)
        logger.log_comm_metric(self.addr, "journal_restored")
        telemetry.event(
            self.addr,
            "journal_restored",
            kind="stage",
            attrs={
                "snap": snap.snap,
                "version": snap.global_version,
                "pending": restored_pending,
                "train_seq": snap.train_seq,
                "up_seq": snap.up_seq,
            },
        )
        return actions

    # ---- receive paths (commands + local offers) ----

    def handle_update(self, update: ModelUpdate, source: Optional[str] = None) -> List[Action]:
        """Route a contribution into the buffer the router names; returns
        the sends its flush (if any) produced. An update this node holds
        no buffer for in its CURRENT view is stashed, not dropped — the
        sender's view may be ahead of ours (we are about to observe the
        death that promotes us).

        ``source`` is the DELIVERING peer (the wire envelope's sender;
        None only for this node's own local offers). The Byzantine screen
        attributes rejections to it, NOT to the in-payload version
        origin: the origin is attacker-controlled, and keying suspicion
        on it would let a lying sender frame (and get evicted) an honest
        node. Origin != source legitimately only on buffer-migration
        forwards — which the forwarder already screened at its own offer,
        so clean forwards indict nobody and a poisoned forward indicts
        the forwarder (federation/defense.py threat model)."""
        ver = as_version(update.version)
        with self.lock:
            # cross-experiment straggler (a retried/duplicated tail from
            # a previous run): the buffer's version vector has never seen
            # its (origin, seq), so without this gate it would merge
            # stale-experiment params at full weight — the exact residual
            # the "xp" header was minted to close
            if xp_mismatch(self.addr, update.xp, self.xid):
                return []
            in_origin = ver.origin if ver is not None else (
                update.contributors[0] if update.contributors else None
            )
            defense = self.node.defense
            if (source is not None and defense.is_quarantined(source)) or (
                in_origin is not None and defense.is_quarantined(in_origin)
            ):
                # a quarantined attacker keeps talking (its control plane
                # is healthy): drop whatever it DELIVERS (source) and
                # whatever claims to ORIGINATE from it (its content is
                # suspect even when an honest aggregator forwards it)
                # before it can stash, inflate the high-water or reach a
                # buffer
                logger.log_comm_metric(self.addr, "byz_quarantined_drop")
                return []
            if (
                ver is not None
                and ver.base_version - self.global_version
                <= Settings.ASYNC_MAX_STALENESS
            ):
                # the promotion floor only trusts base_versions within the
                # staleness bound of our own view — an unvalidated triple
                # from a pre-xp cross-experiment straggler must not poison
                # a future successor's minting floor (same bound as the
                # buffer's counter jump)
                self.high_water.observe(ver.base_version)
            origin = ver.origin if ver is not None else (
                update.contributors[0] if update.contributors else self.addr
            )
            sink = self.router.update_sink(self.addr, origin)
            if sink == "global" and self.gbuf is not None:
                res = self.gbuf.offer(update, screen_origin=source)
                return self._global_flush(res) if res else []
            if sink == "regional" and self.rbuf is not None:
                res = self.rbuf.offer(update, screen_origin=source)
                return self._regional_flush(res) if res else []
        self.node.stash_async_update(update, source)
        logger.log_comm_metric(self.addr, "async_routed_stash")
        logger.debug(
            self.addr,
            "async_update received with no matching buffer in the current "
            "view — stashed for a role change",
        )
        return []

    def live_children(self) -> List[str]:
        """This node's push-down fan-out under the current view (the
        router already removed dead members and re-elected successors)."""
        with self.lock:
            return self.router.live_children(self.addr)

    def push_target(self) -> str:
        """Where this node's training updates go: its cluster's live
        regional (possibly itself — offer locally then). Successor
        regionals/roots are already folded into the router's view."""
        with self.lock:
            target = self.router.push_target(self.addr)
        return target if target is not None else self.addr

    def handle_model(self, update: ModelUpdate, source: str) -> List[Action]:
        """A fresh global pushed down from above: adopt + forward one
        tier further down."""
        ver = as_version(update.version)
        version = ver.base_version if ver is not None else 0
        with self.lock:
            # cross-experiment global (see handle_update's gate)
            if xp_mismatch(self.addr, update.xp, self.xid):
                return []
            if self._bootstrap_from is not None and source != self._bootstrap_from:
                # bootstrap window: the joiner's adopt gate sits at -1,
                # so ANY straggler (e.g. a previous experiment's
                # redelivered async_model, which a still-None xid cannot
                # filter) would win — accept only the pulled aggregator's
                # reply until the window closes
                logger.log_comm_metric(self.addr, "async_model_dropped")
                return []
            if (
                self.xid is None
                and update.xp is not None
                and (self._bootstrap_from is None or self._bootstrap_from == source)
            ):
                # a joiner adopts the running experiment's identity from
                # its bootstrap global (it never saw start_learning) — or,
                # when the bootstrap pull failed entirely (both targets
                # were corpses mid-failover), from the first global that
                # passes the gates after the window: staying id-less for
                # the whole run would leave this node's frames unfiltered
                # and, if later promoted, reopen the cross-experiment
                # residual at its aggregation tier
                self.xid = update.xp
                self.node.state.experiment_xid = update.xp
                self.node.protocol.experiment_xid = update.xp
            self.models_seen += 1
        if not self._adopt(update.params, version):
            logger.log_comm_metric(self.addr, "async_model_stale")
            return []
        logger.log_comm_metric(self.addr, "async_model_adopt")
        telemetry.event(
            self.addr, "async_model_adopt", kind="stage", attrs={"version": version}
        )
        return [
            ("async_model", child, update)
            for child in self.live_children()
            if child != source
        ]

    # ---- flush propagation ----

    def _regional_flush(self, res: FlushResult) -> List[Action]:
        """A regional buffer filled: one merged aggregate goes UP."""
        with self.lock:
            upd = ModelUpdate(res.params, res.contributors, res.num_samples)
            upd.version = (self.addr, next(self._up_seq), res.version)
            upd.xp = self.xid
            if self.gbuf is not None:  # the root's own cluster feeding its global tier
                gres = self.gbuf.offer(upd)
                return self._global_flush(gres) if gres else []
            self.last_up_push = upd
            root = self.router.root
        if root is None or root == self.addr:
            return []
        return [("async_update", root, upd)]

    def _global_flush(self, res: FlushResult) -> List[Action]:
        """The global buffer filled: a new global version exists — adopt
        locally and push it down every child tier."""
        self._adopt(res.params, res.version)
        with self.lock:
            upd = ModelUpdate(res.params, [self.addr], 1)
            upd.version = (self.addr, res.version, res.version)
            upd.xp = self.xid
        return [("async_model", child, upd) for child in self.live_children()]

    # ---- join / leave support ----

    def pull_target(self) -> Optional[str]:
        """Who a joiner bootstraps from: the global root, or (when the
        joiner itself re-derived as root) any other live member."""
        with self.lock:
            root = self.router.root
            if root is not None and root != self.addr:
                return root
            others = [m for m in self.router.live_members if m != self.addr]
        return others[0] if others else None

    def bootstrap_reply(self, requester: str) -> List[Action]:
        """Answer an ``async_pull``: push the current global (or the
        experiment-start params at version 0 when nothing was minted yet
        — a joiner's adopt gate starts at -1, so even that seeds it).
        Reuses the drain's encode-once per-version update, so a whole
        fleet's exit pulls serialize the model once per version, not once
        per reply."""
        with self.lock:
            params, version = self._global_snapshot_locked()
            if self._final_push is not None and self._final_push[0] == version:
                upd = self._final_push[1]
            else:
                upd = ModelUpdate(params, [self.addr], 1)
                upd.version = (self.addr, version, version)
                upd.xp = self.xid
                self._final_push = (version, upd)
        return [("async_model", requester, upd)]

    def view_snapshot(self):
        """The ``(members, dead)`` lists an ``async_view`` reply ships —
        the one public reader of the membership state (the command layer
        must not reach into the context's privates)."""
        with self.lock:
            return sorted(self.members), sorted(self._dead)

    def graceful_leave_actions(self) -> List[Action]:
        """Everything this node must hand off before leaving: partial
        buffers forward raw to the successor tiers derived from the
        post-leave view (the same self-election every survivor will
        derive once the ``async_leave`` lands)."""
        with self.lock:
            post = TierRouter(
                self.members, self.router.cluster_size, dead=self._dead | {self.addr}
            )
            actions: List[Action] = []
            if self.rbuf is not None:
                pending = self.rbuf.take_pending()
                self.rbuf = None
                target = post.push_target(self.addr)
                if pending and target is not None:
                    logger.log_comm_metric(
                        self.addr, "async_buffer_migrated", len(pending)
                    )
                    actions += [("async_update", target, u) for u in pending]
            if self.gbuf is not None:
                pending = self.gbuf.take_pending()
                self.gbuf = None
                if pending and post.root is not None:
                    logger.log_comm_metric(
                        self.addr, "async_buffer_migrated", len(pending)
                    )
                    actions += [("async_update", post.root, u) for u in pending]
            # hand the successor tiers the freshest global we hold: the
            # leaver may be the only node that adopted the last mint
            lg = self.last_global
            if lg is not None:
                params, version = lg
                upd = ModelUpdate(params, [self.addr], 1)
                upd.version = (self.addr, version, version)
                upd.xp = self.xid
                targets = set(post.regionals) | set(
                    self.router.live_children(self.addr)
                )
                targets.discard(self.addr)
                actions += [("async_model", t, upd) for t in sorted(targets)]
        return actions

    # ---- repair + drain support ----

    def final_sync_actions(self) -> List[Action]:
        """Re-push the last-known global to this node's children (drain
        phase): a fresh-global push is fire-and-forget — superseded by the
        next merge in steady state — but at the END of a run there is no
        next merge, so a single dropped push would strand a subtree on an
        old version. Children already at the version ignore it."""
        children = self.live_children()
        with self.lock:
            lg = self.last_global
            if lg is None or not children:
                return []
            params, version = lg
            if self._final_push is not None and self._final_push[0] == version:
                upd = self._final_push[1]  # encode-once: reuse across ticks
            else:
                upd = ModelUpdate(params, [self.addr], 1)
                upd.version = (self.addr, version, version)
                upd.xp = self.xid
                self._final_push = (version, upd)
        return [("async_model", child, upd) for child in children]

    # ---- outbound ----

    def execute_actions(self, actions: List[Action]) -> None:
        """Send the collected pushes through the gossiper's concurrent
        dispatch pool (stalled-peer skip, per-send budget, breaker
        feedback) — one slow child must not serialize a global push.
        Actions targeting THIS node (a buffer migration whose successor
        is the migrating node's other tier) feed back through
        :meth:`handle_update` instead of the wire."""
        proto = self.node.protocol
        while actions:
            sends, local = [], []
            for cmd, target, upd in actions:
                if target == self.addr:
                    local.append(upd)
                    continue
                ver = as_version(upd.version)
                sends.append(
                    (target, proto.build_weights(cmd, ver.seq if ver else 0, upd))
                )
            if sends:
                results, skipped = proto.gossiper._dispatch_sends(
                    sends, create_connection=True
                )
                for ok in results:
                    if ok is False:
                        logger.log_comm_metric(self.addr, "async_push_fail")
                if skipped:
                    logger.log_comm_metric(self.addr, "async_push_skipped", len(skipped))
            actions = []
            for upd in local:
                # self-delivery (a migration whose successor is this
                # node's other tier): already screened when first
                # admitted — attribute to self, never to the in-payload
                # origin (the screen's self-exemption)
                actions += self.handle_update(upd, source=self.addr)


class AsyncLearningWorkflow:
    """Drives one node's async experiment end to end (see module docs)."""

    def run(self, node: "Node") -> None:
        from p2pfl_tpu_torch.communication.faults import FaultCrash
        from p2pfl_tpu_torch.stages.learning_stages import (
            RoundFinishedStage,
            sync_initial_model,
        )

        state = node.state
        joining = node.consume_async_join()
        node._last_async_global = None  # the previous experiment's result
        state.set_experiment(
            node.experiment_name, node.total_rounds, xid=node._pending_xid
        )
        node.protocol.experiment_xid = state.experiment_xid
        logger.experiment_started(node.addr)
        node.learner.set_epochs(node.epochs)
        node.learner.set_addr(node.addr)
        node.learner.pop_round_metrics()

        if Settings.SECURE_AGGREGATION:
            logger.error(
                node.addr,
                "FEDERATION_MODE='async' does not compose with "
                "SECURE_AGGREGATION (pairwise masks need a fixed cohort "
                "per merge; a staleness-weighted buffer breaks exact "
                "cancellation) — aborting the experiment",
            )
            state.clear()
            return
        if Settings.WIRE_COMPRESSION == "topk8":
            logger.error(
                node.addr,
                "FEDERATION_MODE='async' does not support topk8 wire "
                "compression (delta anchors are pinned per sync round; "
                "the async plane has no shared round) — aborting; use "
                "'none' or 'int8'",
            )
            state.clear()
            return

        ctx: Optional[AsyncContext] = None
        left = False
        try:
            if not joining and not sync_initial_model(node):
                return
            # let heartbeats flood so every node derives the topology from
            # the same membership (agreement on membership IS agreement on
            # topology — the deterministic-derivation trick)
            time.sleep(Settings.WAIT_HEARTBEATS_CONVERGENCE)
            members = sorted(
                set(node.protocol.get_neighbors(only_direct=False)) | {node.addr}
            )
            router = TierRouter(members, Settings.HIER_CLUSTER_SIZE)
            ctx = AsyncContext(
                node,
                router,
                node.learner.get_parameters(),
                xid=state.experiment_xid,
                joining=joining,
            )
            node.async_ctx = ctx
            logger.info(
                node.addr,
                f"Async federation: role={router.role(node.addr)} "
                f"topology={router.describe()}",
            )
            # drain updates that raced ahead of the context (fast edges
            # finishing their first local update during our init gossip);
            # the stash's xp/epoch/TTL filters already dropped a previous
            # experiment's retried stragglers
            from p2pfl_tpu_torch.commands.federation import drain_async_stash

            drain_async_stash(node, ctx)
            # crash-resurrection: restore buffers/counters/membership from
            # the recovered journal BEFORE the bootstrap join — the
            # journaled global pre-seeds the mailbox, so the join's pull
            # wait returns instantly and only fetches anything newer
            snap = node.consume_resume_snapshot()
            if snap is not None:
                ctx.execute_actions(ctx.restore_from_journal(snap))
            if joining:
                self._bootstrap_join(node, ctx)
            self._local_loop(node, ctx)
            if node.learning_interrupted():
                return
            if node.async_leave_requested():
                # graceful leave: hand off buffers + the freshest global,
                # announce, and skip the drain — survivors re-derive the
                # topology around the hole and keep going
                left = True
                ctx.execute_actions(ctx.graceful_leave_actions())
                node.protocol.broadcast(node.protocol.build_msg("async_leave"))
                node.protocol.broadcast(node.protocol.build_msg("async_done"))
                logger.log_comm_metric(node.addr, "async_left")
                logger.info(node.addr, "Left the async experiment gracefully")
            else:
                node.protocol.broadcast(node.protocol.build_msg("async_done"))
                self._drain(node, ctx)
            # final snapshot: the journal's recovery point covers the
            # drain's late adoptions too (a crash after this line resumes
            # with the experiment's end state, not one update behind)
            if node.journal is not None:
                self._journal_snapshot(node, ctx)
            # the experiment's RESULT is the latest global model this node
            # knows — not its local tail update (which it already pushed;
            # whether that merged or was discarded with a partial buffer,
            # the canonical fleet model is the last minted version), so
            # every node's final evaluation measures the same model modulo
            # lost pushes
            with ctx.lock:
                lg = ctx.last_global
            if lg is not None and not node.learning_interrupted():
                node.learner.set_parameters(lg[0])
                # keep the result servable after this context dies: a
                # peer's exit pull (async_pull after ITS drain found no
                # global) may arrive once we are already torn down
                node._last_async_global = (lg[0], lg[1], ctx.xid)
        except FaultCrash as exc:
            # injected hard crash: stop executing like a killed process —
            # no drain, no metrics flush, no state.clear
            if node.learner is not None:
                node.learner.pop_round_metrics()
            logger.info(node.addr, f"{exc}")
            return
        except Exception as exc:  # noqa: BLE001 — workflow failure ends learning, not the node
            if node.learning_interrupted():
                logger.info(node.addr, "Async learning interrupted")
            else:
                logger.error(node.addr, f"Async workflow failed: {exc!r}")
                state.clear()
            return
        finally:
            if ctx is not None:
                ctx.accepting = False
                node.async_ctx = None
            # a straggler stashed during teardown must not sit until the
            # next experiment (its xp/TTL bounds the damage; this bounds
            # the memory)
            node.take_async_stash()
            try:
                RoundFinishedStage._flush_round_metrics(node)
            except Exception:  # noqa: BLE001 — abort-path flush never masks the exit
                pass
        # natural finish (or graceful leave): final evaluation, clear
        # state (mirrors RoundFinishedStage's experiment-over path)
        metrics = node.learner.evaluate()
        for k, v in (metrics or {}).items():
            logger.log_metric(
                node.addr, k, float(v), round=state.round, experiment=state.experiment_name
            )
        logger.experiment_finished(node.addr)
        state.clear()
        if left:
            node._async_leave.clear()

    # ---- phases ----

    def _bootstrap_join(self, node: "Node", ctx: AsyncContext) -> None:
        """A joiner announces itself (``async_join`` — members fold it
        into the topology on that announcement, not on mere overlay
        presence) and pulls the nearest aggregator's current global
        before contributing, so its first update trains from the fleet's
        state instead of its own cold init. While the pull is in flight,
        ``async_model`` is accepted only from the pulled aggregator (the
        joiner's adopt gate sits at -1 — see ``_bootstrap_from``)."""
        node.protocol.broadcast(node.protocol.build_msg("async_join"))
        # up to two pull attempts: the first target may be a corpse the
        # joiner has not evicted yet (it can join DURING a failover — the
        # dead root is still in its fresh heartbeat view); by the second
        # attempt the eviction has usually landed and pull_target resolves
        # to the successor
        per_attempt = max(0.5, Settings.ASYNC_JOIN_TIMEOUT / 2)
        tried: set = set()
        for _attempt in range(2):
            target = ctx.pull_target()
            if target is None or target in tried:
                break
            tried.add(target)
            with ctx.lock:
                ctx._bootstrap_from = target
            node.protocol.send(
                target, node.protocol.build_msg("async_pull"), create_connection=True
            )
            deadline = time.monotonic() + per_attempt
            while time.monotonic() < deadline and not node.learning_interrupted():
                with ctx.lock:
                    if ctx.pending_global is not None:
                        break
                time.sleep(0.05)
            with ctx.lock:
                if ctx.pending_global is not None:
                    break
        with ctx.lock:
            bootstrapped = ctx.pending_global is not None
            ctx._bootstrap_from = None  # window closed: normal adoption
            if ctx.global_version < 0:
                ctx.global_version = 0  # nothing arrived: train from own init
        logger.log_comm_metric(node.addr, "async_join")
        telemetry.event(
            node.addr,
            "async_join",
            kind="stage",
            attrs={"bootstrapped": bootstrapped, "from": target},
        )
        if not bootstrapped:
            logger.warning(
                node.addr,
                "Join bootstrap pull produced no global within "
                "ASYNC_JOIN_TIMEOUT — contributing from local init",
            )

    def _local_loop(self, node: "Node", ctx: AsyncContext) -> None:
        from p2pfl_tpu_torch.commands.federation import drain_async_stash
        from p2pfl_tpu_torch.stages.learning_stages import RoundFinishedStage

        state = node.state
        budget = node.total_rounds
        for i in range(budget):
            if node.learning_interrupted() or node.async_leave_requested():
                return
            # membership events land on handler threads (async_join →
            # add_member, async_leave / eviction → mark_dead); here we
            # only drain the stash a role change may have made routable
            if ctx.take_stash_dirty():
                drain_async_stash(node, ctx)
            # stall-watchdog + crash-at-stage seams, same as the FSM loop
            state.current_stage = "AsyncTrainStage"
            state.last_transition = time.monotonic()
            for hook in node.stage_hooks:
                hook(node, "AsyncTrainStage")
            # adopt the freshest global that arrived while training — the
            # pull happens HERE, on the learning thread, so the learner is
            # never mutated mid-fit by a handler thread
            pend = ctx.take_pending_global()
            if pend is not None:
                params, version = pend
                node.learner.set_parameters(params)
                ctx.base_version = version
            trace_id = (
                f"{state.experiment_name or 'exp'}:"
                f"{state.experiment_epoch}:u{i}"
            )
            with telemetry.span(
                node.addr,
                "AsyncTrainStage",
                kind="stage",
                attrs={
                    "round": i,
                    "experiment": state.experiment_name,
                    "base_version": ctx.base_version,
                },
                trace_id=trace_id,
            ):
                own = None
                if Settings.ROUND_FUSED and not node.learning_interrupted():
                    own = node.learner.fused_round()
                if own is None:
                    if node.learning_interrupted():
                        return
                    node.learner.fit()
                    own = node.learner.get_model_update()
                # the fused path's device-resident partial fold belongs to
                # the sync FedAvg seam; the buffer folds staleness-weighted
                own.partial_acc = None
                own.version = (node.addr, next(ctx.train_seq), ctx.base_version)
                own.xp = ctx.xid
                with ctx.lock:
                    ctx.last_own_update = own
            if node.learning_interrupted():
                return
            # one batched metric flush per local update (fused path stash)
            RoundFinishedStage._flush_round_metrics(node)
            state.round = i + 1
            # the target is this node's cluster's LIVE regional under the
            # current view — a dead aggregator's successor (or, for a
            # fully dead cluster, the global root) is already folded in
            target = ctx.push_target()
            if target == node.addr:
                ctx.execute_actions(ctx.handle_update(own))
            else:
                env = node.protocol.build_weights("async_update", i, own)
                ok = node.protocol.send(target, env, create_connection=True)
                # protocol.send skips breaker feedback on the
                # create_connection path — feed it explicitly, or a dead
                # aggregator's edges would never accelerate its eviction
                # (and with it the successor election above)
                node.protocol._record_send_outcome(target, ok)
                if not ok:
                    # dropped, not retried: the next local update
                    # supersedes this one anyway
                    logger.log_comm_metric(node.addr, "async_push_fail")
            # durable recovery point AFTER the push: the journaled
            # train_seq then already counts the update just sent, so a
            # resurrection's seq margin only has to cover in-flight
            # duplicates, never a whole un-journaled update
            if (
                node.journal is not None
                and (i + 1) % max(1, int(Settings.JOURNAL_EVERY_N_UPDATES)) == 0
            ):
                self._journal_snapshot(node, ctx)

    @staticmethod
    def _journal_snapshot(node: "Node", ctx: AsyncContext) -> None:
        """Capture under the locks, commit OUTSIDE them (commit_snapshot
        is blocking disk I/O, held to the same no-lock-across rule as a
        send). A failed snapshot is a logged
        gap in durability, never a crashed learning thread."""
        from p2pfl_tpu_torch.federation.durability import capture_snapshot

        try:
            snap = capture_snapshot(node, ctx)
            node.journal.commit_snapshot(snap, learner=node.learner)
        except Exception as exc:  # noqa: BLE001 — durability must not take the node down
            logger.error(node.addr, f"Journal snapshot failed: {exc!r}")

    def _drain(self, node: "Node", ctx: AsyncContext) -> None:
        """Every node serves until the whole fleet is done or dead:
        aggregators keep merging slower members' tails, edges keep
        adopting the globals those tail merges mint — so in the common
        case the run ends with everyone holding the latest version.
        Bounded by ``ASYNC_DRAIN_TIMEOUT``; a dead member (eviction took
        it out of the overlay) or a graceful leaver releases the wait,
        and a member joining DURING the drain is waited on like anyone
        else (its updates still merge). Buffered-but-unflushed updates at
        exit are discarded — FedBuff semantics, a partial buffer is not a
        merge."""
        from p2pfl_tpu_torch.commands.federation import drain_async_stash

        state = node.state
        deadline = time.monotonic() + Settings.ASYNC_DRAIN_TIMEOUT
        graceful = False
        tick = 0
        pushed_version = -1
        with telemetry.span(node.addr, "async_drain", kind="stage"):
            while time.monotonic() < deadline and not node.learning_interrupted():
                live = set(node.protocol.get_neighbors(only_direct=False))
                if ctx.take_stash_dirty():
                    drain_async_stash(node, ctx)
                self._adopt_pending(node, ctx)
                # aggregators re-push the latest global so a dropped push
                # cannot strand a subtree at run end — when the VERSION
                # CHANGED since the last re-push, plus a slow (~2 s)
                # fallback cadence covering the dropped-re-push case
                # (every tick would fan the full model out 20×/s for
                # children that just drop it as stale)
                with ctx.lock:
                    current = ctx.last_global[1] if ctx.last_global else -1
                if current != pushed_version or tick % 40 == 0:
                    ctx.execute_actions(ctx.final_sync_actions())
                    pushed_version = current
                tick += 1
                with state.status_merge_lock:
                    done = set(state.async_done_peers)
                with ctx.lock:
                    others = ctx.members - {node.addr} - ctx._dead
                waiting = {m for m in others if m not in done and m in live}
                if not waiting:
                    graceful = True
                    break
                time.sleep(0.05)
            if graceful:
                # fold every member that vanished from the overlay into the
                # dead set BEFORE the last fan-out: the eviction listener's
                # repair runs on its own daemon thread, so the drain can
                # observe the corpse gone from the neighbor view while this
                # node's router still names it regional — and a final push
                # routed to a corpse's stale role would strand its
                # promoted successor's subtree on an old version
                live = set(node.protocol.get_neighbors(only_direct=False))
                with ctx.lock:
                    vanished = ctx.members - ctx._dead - live - {node.addr}
                for m in sorted(vanished):
                    ctx.execute_actions(ctx.mark_dead(m))
                if ctx.take_stash_dirty():
                    drain_async_stash(node, ctx)
                # grace window: merges triggered by the LAST members' final
                # updates are still propagating down the tiers
                time.sleep(min(0.5, Settings.ASYNC_DRAIN_TIMEOUT / 10))
                ctx.execute_actions(ctx.final_sync_actions())
                time.sleep(0.1)
            else:
                logger.info(
                    node.addr,
                    "Async drain window closed with members still pending — exiting",
                )
            self._adopt_pending(node, ctx)
            # push-based final sync can still miss a node: exit timing is
            # jittered across the fleet by per-node eviction clocks, so
            # the last minted version's push can land after a child's
            # grace window closed (worst under failover, where a node's
            # every earlier global came through a corpse). Before leaving,
            # every non-root node PULLS the current global once — the
            # bootstrap verb reused; servable even by peers that already
            # exited (Node._last_async_global) — bounded by one
            # round-trip. A reply at the version we already hold is
            # ignored by the adopt gate.
            with ctx.lock:
                is_root = ctx.router.root == node.addr
            if not is_root and not node.learning_interrupted():
                # pull until STABLE (two consecutive pulls at the same
                # version, max 3): the first reply can race the root's
                # last tail merge — a second pull then lands either on the
                # root's drain (newer version) or, after its exit, on the
                # kept result (Node._last_async_global), which IS final
                prev_version = None
                for _attempt in range(3):
                    target = ctx.pull_target()
                    if target is None:
                        break
                    with ctx.lock:
                        seen_before = ctx.models_seen
                    logger.log_comm_metric(node.addr, "async_exit_pull")
                    node.protocol.send(
                        target,
                        node.protocol.build_msg("async_pull"),
                        create_connection=True,
                    )
                    pull_deadline = time.monotonic() + min(
                        2.0, Settings.ASYNC_DRAIN_TIMEOUT / 5
                    )
                    while time.monotonic() < pull_deadline:
                        with ctx.lock:
                            if ctx.models_seen > seen_before:
                                break
                        time.sleep(0.05)
                    self._adopt_pending(node, ctx)
                    with ctx.lock:
                        got = ctx.models_seen > seen_before
                        version = ctx.last_global[1] if ctx.last_global else -1
                    if not got or version == prev_version:
                        break  # no reply (bounded exit) or stable
                    prev_version = version

    @staticmethod
    def _adopt_pending(node: "Node", ctx: AsyncContext) -> None:
        pend = ctx.take_pending_global()
        if pend is not None:
            params, version = pend
            node.learner.set_parameters(params)
            ctx.base_version = version
