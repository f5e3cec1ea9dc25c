"""Learning-lifecycle commands: start/stop, init weights, model ingestion.

Counterpart of ``p2pfl_tpu/commands/learning.py``. Weights arrive as live
tensors (the in-memory transport, the ICI plane) or as wire bytes (gRPC,
``MEMORY_WIRE_CODEC``) that the learner decodes on receipt; a payload
that does not decode or does not match the model stops the node, as in
the reference, while a delta-coded payload against another round's anchor
is skipped. A diffused aggregate marked ``secagg.CLEAN_MARKER`` (finalized
under double masking) has the marker stripped and ``secagg_clean`` set.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

from p2pfl_tpu_torch.commands.command import Command
from p2pfl_tpu_torch.exceptions import AnchorMismatchError, DecodingParamsError, ModelNotMatchingError
from p2pfl_tpu_torch.learning.weights import ModelUpdate
from p2pfl_tpu_torch.management.logger import logger

if TYPE_CHECKING:
    from p2pfl_tpu_torch.node import Node

ModelInitializedName = "model_initialized"


class StartLearningCommand(Command):
    """Spawn the learning thread with (rounds, epochs[, experiment id])."""

    def __init__(self, node: "Node") -> None:
        self._node = node

    @staticmethod
    def get_name() -> str:
        return "start_learning"

    def execute(self, source: str, round: int, *args, **kwargs) -> None:  # noqa: A002
        rounds = int(args[0]) if args else 1
        epochs = int(args[1]) if len(args) > 1 else 1
        self._node._pending_xid = args[2] if len(args) > 2 else None
        self._node._start_learning_thread(rounds, epochs)


class StopLearningCommand(Command):
    """Interrupt the learner, clear aggregator + state, release latches."""

    def __init__(self, node: "Node") -> None:
        self._node = node

    @staticmethod
    def get_name() -> str:
        return "stop_learning"

    def execute(self, source: str, round: int, *args, **kwargs) -> None:  # noqa: A002
        self._node._stop_learning()


class InitModelCommand(Command):
    """Initial weights payload: store → signal → re-announce.

    Stashed on the node (``pending_init_update``) and applied by the stage
    after its latch fires. An init_model that beat this node's
    start_learning is stashed unlatched (``Node.stash_early_init``) and
    consumed by ``StartLearningStage`` while fresh.
    """

    def __init__(self, node: "Node") -> None:
        self._node = node

    @staticmethod
    def get_name() -> str:
        return "init_model"

    def execute(self, source: str, round: int, *args, update: ModelUpdate = None, **kwargs) -> None:  # noqa: A002
        node = self._node
        state = node.state
        if not node.learning_active() or state.round is None:
            node.stash_early_init(update)
            logger.debug(state.addr, f"init_model from {source} stashed — no experiment running yet")
            return
        if state.model_initialized_event.is_set():
            logger.debug(state.addr, f"init_model from {source} ignored — already initialized")
            return
        try:
            update = node.learner.decode_update(update)
        except (DecodingParamsError, ModelNotMatchingError, AnchorMismatchError) as exc:
            logger.error(state.addr, f"init_model decode failed: {exc} — stopping node")
            node.stop_async()
            return
        node.pending_init_update = update
        state.model_initialized_event.set()
        node.protocol.broadcast(node.protocol.build_msg(ModelInitializedName))


class AddModelCommand(Command):
    """Model/partial-aggregation ingestion → aggregator."""

    def __init__(self, node: "Node") -> None:
        self._node = node

    @staticmethod
    def get_name() -> str:
        return "add_model"

    def execute(self, source: str, round: int, *args, update: ModelUpdate = None, **kwargs) -> None:  # noqa: A002
        node = self._node
        state = node.state
        if not state.model_initialized_event.is_set():
            logger.debug(state.addr, f"add_model from {source} before init — ignored")
            return
        if update is not None and update.contributors:
            from p2pfl_tpu_torch.learning.secagg import CLEAN_MARKER

            if CLEAN_MARKER in update.contributors:
                # a finalized (self-mask-free) aggregate under double
                # masking: strip the pseudo-contributor before any coverage
                # comparison, and keep the fact for _secagg_finalize
                update.contributors = [c for c in update.contributors if c != CLEAN_MARKER]
                update.secagg_clean = True
        # decode BEFORE the round gates: a decode takes time, and a payload
        # gated against the round it arrived in must not land in the window
        # of the round the node moved to meanwhile
        try:
            clean = update.secagg_clean
            update = node.learner.decode_update(update)
            update.secagg_clean = clean
        except AnchorMismatchError as exc:
            # delta-coded against an anchor this node does not hold (a
            # round behind or ahead of the sender): skip it and wait for
            # one it can reconstruct; not fatal, unlike a corrupt payload
            logger.info(state.addr, f"add_model from {source} skipped: {exc}")
            return
        except (DecodingParamsError, ModelNotMatchingError) as exc:
            logger.error(state.addr, f"add_model decode failed: {exc} — stopping node")
            node.stop_async()
            return
        if state.round is not None and round < state.round:
            # stale payload from a peer still finishing an older round: the
            # train set is reused across rounds, so the aggregator would
            # take it as this round's full aggregate
            logger.debug(
                state.addr,
                f"add_model from {source} for stale round {round} (at {state.round}) — ignored",
            )
            return
        if state.round is not None and round > state.round:
            # a future round: only a full aggregate (the catch-up case)
            full = set(state.train_set)
            survivors = full - state.train_set_evicted
            if not survivors or not (survivors <= set(update.contributors) <= full):
                logger.debug(
                    state.addr,
                    f"add_model from {source} for future round {round} (at "
                    f"{state.round}) is not a full aggregate — ignored",
                )
                return
        covered = node.aggregator.add_model(update, source=source)
        if covered:
            node.protocol.broadcast(
                node.protocol.build_msg("models_aggregated", covered, round=state.round or 0)
            )
