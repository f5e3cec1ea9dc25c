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
the train set's contributions (``learning/secagg.py``). Not ported: the
async control plane, the journal and resume, and the DCN plane; a setting
that asks for one of them raises at :meth:`Node.start`, never in the
middle of a round.
"""

from __future__ import annotations

import threading
import time
import uuid
import weakref
from typing import Any, Optional, Type, Union

from p2pfl_tpu_torch.commands import (
    AddModelCommand,
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
from p2pfl_tpu_torch.settings import Settings

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
        self.aggregator = aggregator if aggregator is not None else FedAvg(self.addr)
        self.aggregator.node_name = self.addr

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
        ):
            self.protocol.add_command(cmd)

    # ---- lifecycle ----

    def start(self, wait: bool = False) -> None:
        if self._running:
            raise NodeRunningException(f"Node {self.addr} already running")
        _check_supported()
        logger.register_node(self.addr, self.state, self.state.simulation)
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
            self._learning_thread = threading.Thread(
                target=self._run_learning, name=f"learning-{self.addr}", daemon=True
            )
            self._learning_thread.start()

    def _run_learning(self) -> None:
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
        if self.learner is not None:
            self.learner.interrupt_fit()
        self.aggregator.clear()
        self.aggregator.reset_experiment()
        self.state.clear()
        self.state.votes_ready_event.set()
