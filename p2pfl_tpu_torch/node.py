"""The user-facing gossip Node (counterpart of ``p2pfl_tpu/node.py``).

Wires a transport, an aggregator, a learner and the command registry, and
owns the learning thread that drives the round FSM (vote → train →
partial FedAvg gossip → diffusion, ``stages/learning_stages.py``). With
``Settings.WEIGHTS_PLANE="ici"`` a started node registers on the shard
plane (``communication/ici.py``), and model payloads between registered
nodes move slot to slot. ``Node(None, None)`` is valid for
pure-communication use.

The transport is the in-memory one by default or the gRPC one
(``communication/grpc_transport.py``); byte transports ship the P2TW
codec (``"none"``, ``"int8"`` or ``"topk8"`` with error feedback),
decoded onto the learner's device. ``Settings.SECURE_AGGREGATION`` masks
the train set's contributions (``learning/secagg.py``), and
``Settings.BYZ_SCREEN`` screens every contribution at both aggregator
seams (``federation/defense.py``; a quarantine drives the eviction path).
``Settings.FEDERATION_MODE="async"`` runs the FedBuff control plane
(``federation/workflow.py``) in place of the round FSM; with
:meth:`Node.enable_journal` it commits crash-consistent snapshots, and
:meth:`Node.resume` brings a killed node back as itself. Not ported: the
DCN plane; ``WEIGHTS_PLANE="dcn"`` (and an unknown ``FEDERATION_MODE``)
raises at :meth:`Node.start`, never in the middle of a round.
"""

from __future__ import annotations

import threading
import time
import uuid
import weakref
from typing import Any, Optional, Type, Union

from p2pfl_tpu_torch.commands import (
    AddModelCommand,
    AsyncDoneCommand,
    AsyncJoinCommand,
    AsyncLeaveCommand,
    AsyncModelCommand,
    AsyncPullCommand,
    AsyncUpdateCommand,
    AsyncViewCommand,
    HeartbeatCommand,
    InitModelCommand,
    MetricsCommand,
    ModelInitializedCommand,
    ModelsAggregatedCommand,
    ModelsReadyCommand,
    SecAggNeedCommand,
    SecAggPubCommand,
    SecAggRecoverCommand,
    SecAggRevealCommand,
    SecAggShareCommand,
    StartLearningCommand,
    StopLearningCommand,
    VoteTrainSetCommand,
)
from p2pfl_tpu_torch.communication.memory import InMemoryProtocol
from p2pfl_tpu_torch.communication.protocol import CommunicationProtocol
from p2pfl_tpu_torch.exceptions import NodeRunningException, UnsupportedByPortError, ZeroRoundsException
from p2pfl_tpu_torch.learning.aggregators.fedavg import FedAvg
from p2pfl_tpu_torch.learning.weights import ModelUpdate
from p2pfl_tpu_torch.management.logger import logger
from p2pfl_tpu_torch.node_state import NodeState
from p2pfl_tpu_torch.ops.tree import tree_items
from p2pfl_tpu_torch.settings import FEDERATION_MODES, Settings

#: weak registry of every constructed Node: harnesses find and stop leaked
#: nodes with :func:`stop_leaked_nodes`
ALL_NODES: "weakref.WeakSet[Node]" = weakref.WeakSet()


def stop_leaked_nodes() -> list[str]:
    """Stop every still-running Node in the process; returns their addrs."""
    leaked = []
    for node in list(ALL_NODES):
        if getattr(node, "_running", False):
            leaked.append(node.addr)
            try:
                node.stop()
            except Exception:  # noqa: BLE001 — best-effort teardown
                pass
    return leaked


def _check_supported() -> None:
    """Refuse, before anything runs, what the port does not do yet."""
    if Settings.WEIGHTS_PLANE not in ("bytes", "ici"):
        raise UnsupportedByPortError(
            f"WEIGHTS_PLANE={Settings.WEIGHTS_PLANE!r}: only bytes and ici are ported "
            "(the DCN plane is ROADMAP Queue A item 9)"
        )
    if Settings.FEDERATION_MODE not in FEDERATION_MODES:
        raise ValueError(
            f"FEDERATION_MODE={Settings.FEDERATION_MODE!r}: expected one of {FEDERATION_MODES}"
        )


class Node:
    def __init__(
        self,
        model: Any = None,
        data: Any = None,
        address: Optional[str] = None,
        learner: Any = None,
        aggregator: Any = None,
        protocol: Union[CommunicationProtocol, Type[CommunicationProtocol]] = InMemoryProtocol,
        simulation: bool = False,
    ) -> None:
        self.protocol: CommunicationProtocol = (
            protocol(address) if isinstance(protocol, type) else protocol
        )
        self.addr = self.protocol.get_address()
        self.state = NodeState(self.addr, simulation=simulation)
        # Byzantine defense-in-depth (federation/defense.py): one screen and
        # suspicion tracker for both aggregation seams (the sync aggregator,
        # the async context's buffers); inert until Settings.BYZ_SCREEN. A
        # quarantine drives the eviction path a heartbeat death takes
        from p2pfl_tpu_torch.federation.defense import ByzantineDefense

        self.defense = ByzantineDefense(self.addr, on_quarantine=self._quarantine_peer)
        self.aggregator = aggregator if aggregator is not None else FedAvg(self.addr)
        self.aggregator.node_name = self.addr
        self.aggregator.defense = self.defense

        # learner: instance, or class to instantiate with (model, data)
        if learner is None and model is not None:
            from p2pfl_tpu_torch.learning.learner import TorchLearner

            learner = TorchLearner(model, data)
        elif isinstance(learner, type):
            learner = learner(model, data)
        self.learner = learner
        self.state.learner = learner
        if learner is not None:
            # streamed weights decode straight onto the learner's device
            self.protocol.receive_device = lambda: next(
                leaf.device for _, leaf in tree_items(learner.get_parameters())
            )

        self.experiment_name = "experiment"
        self.total_rounds = 0
        self.epochs = 1
        self.pending_init_update: Optional[ModelUpdate] = None
        # the round-start global, kept under secure aggregation for a round
        # whose masked aggregate cannot be recovered (the stages' no-op)
        self.round_start_params: Optional[Any] = None
        # an init_model that raced ahead of start_learning, with its arrival
        # time, consumed by StartLearningStage while fresh
        self._early_init_lock = threading.Lock()
        self._early_init: Optional[tuple[float, ModelUpdate]] = None
        self._pending_xid: Optional[str] = None
        # async control plane (federation/workflow.py): the experiment's
        # AsyncContext (None outside an async experiment: the async_*
        # commands drop their payloads then), the bounded stash of
        # async_updates that beat its creation, the join flag the workflow
        # consumes (skip the init sync, bootstrap-pull instead) and the
        # graceful-leave latch
        self.async_ctx: Optional[Any] = None
        self._early_async_lock = threading.Lock()
        self._early_async: list = []
        self._async_join = False
        self._async_leave = threading.Event()
        # crash resurrection (federation/durability.py): an attached journal
        # snapshots after every Nth own update; a snapshot recovered by
        # Node.resume waits here for the workflow to restore from
        self.journal: Optional[Any] = None
        self._resume_snapshot: Optional[Any] = None
        # the finished async experiment's (params, version, xid), kept so an
        # async_pull can be served after the workflow exited
        self._last_async_global: Optional[tuple] = None
        self._interrupt = threading.Event()
        self._learning_thread: Optional[threading.Thread] = None
        self._running = False
        #: ``hook(node, stage_name)`` on every stage transition (the
        #: crash-at-stage seam of the JAX package's fault injector)
        self.stage_hooks: list = []
        # mid-round train-set repair on heartbeat eviction
        self.protocol.add_evict_listener(self._on_peer_evicted)
        ALL_NODES.add(self)

        for cmd in (
            HeartbeatCommand(self.protocol.heartbeater),
            StartLearningCommand(self),
            StopLearningCommand(self),
            ModelInitializedCommand(self.state),
            VoteTrainSetCommand(self.state),
            ModelsAggregatedCommand(self),
            ModelsReadyCommand(self.state),
            MetricsCommand(self.state),
            SecAggPubCommand(self.state),
            SecAggRecoverCommand(self.state),
            SecAggNeedCommand(self),
            SecAggShareCommand(self.state),
            SecAggRevealCommand(self.state),
            InitModelCommand(self),
            AddModelCommand(self),
            AsyncUpdateCommand(self),
            AsyncModelCommand(self),
            AsyncDoneCommand(self.state),
            AsyncPullCommand(self),
            AsyncJoinCommand(self),
            AsyncViewCommand(self),
            AsyncLeaveCommand(self),
        ):
            self.protocol.add_command(cmd)

    # ---- lifecycle ----

    def start(self, wait: bool = False) -> None:
        if self._running:
            raise NodeRunningException(f"Node {self.addr} already running")
        _check_supported()
        logger.register_node(self.addr, self.state, self.state.simulation)
        from p2pfl_tpu_torch.management.watchdog import StallWatchdog

        StallWatchdog.ensure_started()  # a no-op unless Settings.STALL_WATCHDOG_S > 0
        self.protocol.start()
        if self.learner is not None:
            # shard-plane presence: registration is unconditional and cheap,
            # the plane gates on Settings.WEIGHTS_PLANE per send
            from p2pfl_tpu_torch.communication.ici import IciEndpoint, ShardPlaneRegistry

            ShardPlaneRegistry.register(self.addr, IciEndpoint(self))
        self._running = True
        if wait:
            self.protocol.wait_for_termination()

    def stop(self) -> None:
        if not self._running:
            return
        self._running = False
        from p2pfl_tpu_torch.communication.ici import ShardPlaneRegistry

        ShardPlaneRegistry.unregister(self.addr)
        self._stop_learning()
        self.protocol.stop()
        logger.unregister_node(self.addr)

    def stop_async(self) -> None:
        """Stop from a server/command thread without deadlocking it."""
        threading.Thread(target=self.stop, name=f"stop-{self.addr}", daemon=True).start()

    # ---- neighborhood ----

    def connect(self, addr: str) -> bool:
        if self.state.round is not None:
            logger.info(self.addr, "Joining a network mid-learning is unsupported")
            return False
        return self.protocol.connect(addr)

    def disconnect(self, addr: str) -> None:
        self.protocol.disconnect(addr)

    def get_neighbors(self, only_direct: bool = False) -> dict:
        return self.protocol.get_neighbors(only_direct)

    def is_running(self) -> bool:
        return self._running

    # ---- learning control ----

    def set_start_learning(self, rounds: int = 1, epochs: int = 1) -> None:
        if rounds < 1:
            raise ZeroRoundsException("rounds must be >= 1")
        if self.state.round is not None:
            logger.info(self.addr, "Learning already in progress")
            return
        # the fleet-wide experiment identity rides the broadcast and every
        # frame's "xp" header
        self._pending_xid = uuid.uuid4().hex[:16]
        self.protocol.broadcast(
            self.protocol.build_msg("start_learning", [str(rounds), str(epochs), self._pending_xid])
        )
        # this node is THE initializer: its current weights seed the network
        self.state.model_initialized_event.set()
        self.protocol.broadcast(self.protocol.build_msg("model_initialized"))
        self._start_learning_thread(rounds, epochs)

    def join_async_experiment(self, rounds: int = 1, epochs: int = 1) -> None:
        """Join a RUNNING async experiment (elastic membership). The joiner
        must already be connected to the overlay; its workflow skips the
        initial-model sync and bootstraps by pulling its aggregator's
        current global (``async_pull``) before contributing. Only under
        ``Settings.FEDERATION_MODE == "async"``."""
        if rounds < 1:
            raise ZeroRoundsException("rounds must be >= 1")
        if Settings.FEDERATION_MODE != "async":
            logger.error(self.addr, "join_async_experiment requires FEDERATION_MODE='async' — ignored")
            return
        if self.state.round is not None:
            logger.info(self.addr, "Learning already in progress")
            return
        # a joiner never saw this experiment's start_learning: it adopts the
        # running experiment's id from its bootstrap global
        self._pending_xid = None
        self._async_join = True
        self._start_learning_thread(rounds, epochs)

    def enable_journal(self, directory: str, keep_n: Optional[int] = None) -> None:
        """Attach a crash-resurrection journal (federation/durability.py):
        the async workflow commits a snapshot every
        ``Settings.JOURNAL_EVERY_N_UPDATES`` own updates (and one at
        drain), and :meth:`resume` brings the node back from ``directory``."""
        from p2pfl_tpu_torch.federation.durability import NodeJournal

        self.journal = NodeJournal(directory, node_name=self.addr, keep_n=keep_n)

    @classmethod
    def resume(
        cls,
        journal_dir: str,
        model: Any = None,
        data: Any = None,
        learner: Any = None,
        protocol: Type[CommunicationProtocol] = InMemoryProtocol,
        bootstrap: Optional[list] = None,
        rounds: Optional[int] = None,
        epochs: int = 1,
        start: bool = True,
        simulation: bool = False,
    ) -> "Node":
        """Resurrect a node from its journal: it comes back as ITSELF.

        Recovers the last committed snapshot, rebuilds a Node under the
        journaled address (identity is what makes upstream version vectors
        dedup its pre-crash in-flight updates), restores the learner's
        params and opt state onto its device, and re-enters the running
        experiment through the elastic join: ``async_join``, a bootstrap
        pull, then buffers, version vector, membership, suspicion and
        sequence counters from the snapshot, the counters resumed past the
        journaled position plus ``Settings.JOURNAL_SEQ_MARGIN``.

        ``bootstrap`` lists peers to connect to (default: the journaled live
        membership minus self); ``rounds`` is the remaining local budget
        (default: journaled ``total_rounds`` minus updates done, floor 1).
        The caller supplies ``model``/``data`` or a ready ``learner`` as for
        ``__init__``: datasets are not journaled. Raises
        ``FileNotFoundError`` when the journal has no recoverable snapshot.
        """
        import os

        from p2pfl_tpu_torch.federation.durability import NodeJournal
        from p2pfl_tpu_torch.learning.weights import restore_like
        from p2pfl_tpu_torch.management.telemetry import telemetry

        t0 = time.monotonic()
        journal = NodeJournal(journal_dir)
        snap = journal.recover()
        if snap is None:
            raise FileNotFoundError(f"no recoverable journal snapshot under {journal_dir}")
        journal.node_name = snap.addr
        node = cls(
            model, data, address=snap.addr, learner=learner,
            protocol=protocol(snap.addr) if isinstance(protocol, type) else protocol,
            simulation=simulation,
        )
        if node.learner is not None:
            template = node.learner.get_parameters()
            if snap.learner_step is not None:
                from p2pfl_tpu_torch.learning.checkpoint import restore_learner

                restore_learner(os.path.join(journal.directory, "learner"), node.learner, step=snap.learner_step)
                node.learner.bump_model_version()
            elif snap.learner_params is not None:
                node.learner.set_parameters(restore_like(template, snap.learner_params))
            # the journaled flat dicts as trees of the learner's structure,
            # on its device (the fleet shares one model structure)
            if snap.global_params is not None:
                snap.global_params = restore_like(template, snap.global_params)
            for bj in snap.buffers:
                bj.pending = [(o, s, b, c, n, restore_like(template, p)) for o, s, b, c, n, p in bj.pending]
        node.journal = journal
        node._resume_snapshot = snap
        # the elastic join with the journaled identity: KEEP the experiment
        # id (a resurrectee did see start_learning)
        node._pending_xid = snap.xid
        node._async_join = True
        if start:
            node.start()
            peers = bootstrap if bootstrap is not None else [
                a for a in snap.members if a != snap.addr and a not in snap.dead
            ]
            for peer in peers:
                node.connect(peer)
            budget = rounds if rounds is not None else max(snap.total_rounds - snap.updates_done, 1)
            logger.log_comm_metric(snap.addr, "node_resumed")
            telemetry.event(
                snap.addr, "node_resumed", kind="stage",
                attrs={"snap": snap.snap, "version": snap.global_version, "updates_done": snap.updates_done,
                       "resume_ms": round((time.monotonic() - t0) * 1000.0, 3)},
            )
            node._start_learning_thread(budget, epochs)
        return node

    def consume_resume_snapshot(self) -> Optional[Any]:
        """Pop the recovered snapshot (restored from exactly once)."""
        snap, self._resume_snapshot = self._resume_snapshot, None
        return snap

    def request_async_leave(self) -> None:
        """Ask the running async workflow to leave GRACEFULLY: it stops after
        the current local update, forwards its partial buffers to the
        successor tiers, broadcasts ``async_leave`` + ``async_done`` and
        finishes its experiment locally. A no-op outside an async
        experiment."""
        self._async_leave.set()

    def async_leave_requested(self) -> bool:
        return self._async_leave.is_set()

    def consume_async_join(self) -> bool:
        """Pop the join flag (the workflow reads it exactly once)."""
        joining, self._async_join = self._async_join, False
        return joining

    def set_stop_learning(self) -> None:
        if self.state.round is None:
            logger.info(self.addr, "Learning is not running")
            return
        self.protocol.broadcast(self.protocol.build_msg("stop_learning"))
        self._stop_learning()

    def learning_interrupted(self) -> bool:
        return self._interrupt.is_set()

    def learning_active(self) -> bool:
        """True while a learning thread is running."""
        t = self._learning_thread
        return t is not None and t.is_alive()

    # ---- internals (called by commands too) ----

    def _start_learning_thread(self, rounds: int, epochs: int) -> None:
        with self.state.start_thread_lock:
            if self._learning_thread is not None and self._learning_thread.is_alive():
                logger.debug(self.addr, "Learning thread already running")
                return
            self.total_rounds = rounds
            self.epochs = epochs
            self._interrupt.clear()
            self._async_leave.clear()
            self._learning_thread = threading.Thread(
                target=self._run_learning, name=f"learning-{self.addr}", daemon=True
            )
            self._learning_thread.start()

    def _run_learning(self) -> None:
        # suspicion and quarantine are per-experiment state
        self.defense.reset()
        # the control plane: the round FSM or the async bounded-staleness
        # plane (Node.start refused any other mode)
        if Settings.FEDERATION_MODE == "async":
            from p2pfl_tpu_torch.federation.workflow import AsyncLearningWorkflow

            AsyncLearningWorkflow().run(self)
            return
        from p2pfl_tpu_torch.stages.workflow import LearningWorkflow

        LearningWorkflow().run(self)

    def stash_early_init(self, update: ModelUpdate) -> None:
        """Hold an init_model that arrived before start_learning for
        StartLearningStage; a timer drops it after ``EARLY_INIT_TTL``."""
        slot = (time.monotonic(), update)
        with self._early_init_lock:
            self._early_init = slot

        def _expire() -> None:
            with self._early_init_lock:
                if self._early_init is slot:
                    self._early_init = None

        t = threading.Timer(Settings.EARLY_INIT_TTL, _expire)
        t.daemon = True
        t.start()

    def take_early_init(self) -> Optional[ModelUpdate]:
        """Pop the pre-start init_model stash if it belongs to THIS
        experiment: exact when both sides carry an experiment id, else the
        ``EARLY_INIT_TTL`` freshness window."""
        with self._early_init_lock:
            slot, self._early_init = self._early_init, None
        if slot is None:
            return None
        stashed_at, update = slot
        xid = self.state.experiment_xid
        if update.xp is not None and xid is not None:
            return update if update.xp == xid else None
        if time.monotonic() - stashed_at > Settings.EARLY_INIT_TTL:
            return None
        return update

    def stash_async_update(self, update: ModelUpdate, source: Optional[str] = None) -> None:
        """Hold an async_update that beat the AsyncContext's creation for the
        workflow to drain: bounded, the oldest dropped past 64 (a superseded
        update is droppable by design). ``source``, the delivering peer,
        rides along for the Byzantine screen's attribution."""
        with self._early_async_lock:
            self._early_async.append((self.state.experiment_epoch, time.monotonic(), update, source))
            while len(self._early_async) > 64:
                self._early_async.pop(0)

    def take_async_stash(self) -> list:
        """Pop the stash, keeping only THIS experiment's entries: exact when
        the entry and this node both carry an experiment id, else the
        experiment epoch at stash time and the ``EARLY_INIT_TTL`` window."""
        with self._early_async_lock:
            entries, self._early_async = self._early_async, []
        now = time.monotonic()
        epoch = self.state.experiment_epoch
        xid = self.state.experiment_xid
        fresh = []
        for e, t, u, src in entries:
            if u.xp is not None and xid is not None:
                if u.xp == xid:
                    fresh.append((u, src))
                continue
            if e == epoch and now - t <= Settings.EARLY_INIT_TTL:
                fresh.append((u, src))
        if len(fresh) < len(entries):
            logger.debug(self.addr, "Discarded stale early async_update stash entries")
        return fresh

    def _quarantine_peer(self, addr: str) -> None:
        """Byzantine quarantine: drive the eviction path a corpse takes
        (eviction listeners run train-set repair or the async re-derivation)
        with the quarantine flag, so the attacker's healthy heartbeats do
        not re-admit it at once. Runs on the defense's daemon thread, never
        under an aggregator or buffer lock."""
        logger.warning(self.addr, f"Evicting {addr} from the overlay (Byzantine quarantine)")
        self.protocol.neighbors.evict(addr, quarantine=True)

    def _on_peer_evicted(self, addr: str) -> None:
        """Mid-round train-set repair: a train-set member was evicted. If
        it has not contributed, shrink the round's coverage target to the
        survivors and re-announce our coverage. Inert under secure
        aggregation: a survivors-only close would apply an aggregate still
        carrying the dead member's pair masks, and the stages' seed
        recovery owns the dropout there."""
        st = self.state
        # wake a vote wait blocked on the evicted peer's vote
        st.votes_ready_event.set()
        ctx = self.async_ctx
        if ctx is not None:
            # async plane: an eviction is a membership event, re-derived
            # with the corpse as a hole (AsyncContext.mark_dead). The repair
            # may flush a buffer and push full models, so it runs on its own
            # thread: inline it would silence this node's heartbeats during
            # a failure window
            def _repair(ctx=ctx, addr=addr) -> None:
                try:
                    ctx.execute_actions(ctx.mark_dead(addr))
                    if ctx.accepting and ctx.take_stash_dirty():
                        from p2pfl_tpu_torch.commands.federation import drain_async_stash

                        drain_async_stash(self, ctx)
                except Exception as exc:  # noqa: BLE001 — repair is best-effort
                    logger.error(self.addr, f"Async eviction repair failed for {addr}: {exc!r}")

            threading.Thread(target=_repair, name=f"async-repair-{self.addr}", daemon=True).start()
            return
        if not Settings.TRAIN_SET_REPAIR or Settings.SECURE_AGGREGATION:
            return
        with st.train_set_lock:
            if st.round is None or addr == self.addr:
                return
            if addr not in st.train_set or addr in st.train_set_evicted:
                return
            st.train_set_evicted = st.train_set_evicted | {addr}
            survivors = [n for n in st.train_set if n not in st.train_set_evicted]
        logger.warning(
            self.addr, f"Train-set member {addr} evicted mid-round — gossip targets repaired to {survivors}"
        )
        covered = self.aggregator.discard_member(addr)
        if covered:
            self.protocol.broadcast(
                self.protocol.build_msg("models_aggregated", covered, round=st.round or 0)
            )

    def _stop_learning(self) -> None:
        self._interrupt.set()
        with self._early_init_lock:
            self._early_init = None
        with self._early_async_lock:
            self._early_async = []
        if self.learner is not None:
            self.learner.interrupt_fit()
        self.aggregator.clear()
        self.aggregator.reset_experiment()
        self.state.clear()
        self.state.votes_ready_event.set()
