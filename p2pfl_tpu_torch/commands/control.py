"""Small control-plane commands: votes, round status, metrics.

Counterpart of ``p2pfl_tpu/commands/control.py`` without the secure-
aggregation verbs. All mutate :class:`~p2pfl_tpu_torch.node_state.NodeState`
under its locks; the status merges are monotone (a stale redelivery never
regresses a view) and serialized by ``status_merge_lock``.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

from p2pfl_tpu_torch.commands.command import Command
from p2pfl_tpu_torch.management.logger import logger

if TYPE_CHECKING:
    from p2pfl_tpu_torch.node_state import NodeState


class ModelInitializedCommand(Command):
    """Peer announced its model is initialized → ``nei_status[source] = -1``
    (only for a peer with no status yet: status only moves forward)."""

    def __init__(self, state: "NodeState") -> None:
        self._state = state

    @staticmethod
    def get_name() -> str:
        return "model_initialized"

    def execute(self, source: str, round: int, *args, **kwargs) -> None:  # noqa: A002
        with self._state.status_merge_lock:
            self._state.nei_status.setdefault(source, -1)


class VoteTrainSetCommand(Command):
    """Train-set vote: flat ``[name, weight, name, weight, ...]`` pairs,
    accepted for the current round or the next one."""

    def __init__(self, state: "NodeState") -> None:
        self._state = state

    @staticmethod
    def get_name() -> str:
        return "vote_train_set"

    def execute(self, source: str, round: int, *args, **kwargs) -> None:  # noqa: A002
        st = self._state
        if st.round is not None and round not in (st.round, st.round + 1):
            logger.debug(st.addr, f"Vote from {source} for stale round {round} (at {st.round}) — ignored")
            return
        if len(args) % 2 != 0:
            logger.error(st.addr, f"Malformed vote from {source}: odd arg count")
            return
        votes = {args[i]: int(args[i + 1]) for i in range(0, len(args), 2)}
        with st.train_set_votes_lock:
            st.train_set_votes[source] = votes
        st.votes_ready_event.set()


class ModelsAggregatedCommand(Command):
    """Peer reports which contributors it has folded in this round."""

    def __init__(self, node) -> None:  # "Node"; untyped to avoid the import cycle
        self._node = node

    @staticmethod
    def get_name() -> str:
        return "models_aggregated"

    def execute(self, source: str, round: int, *args, **kwargs) -> None:  # noqa: A002
        st = self._node.state
        # capture the coverage dict BEFORE the round check: increase_round()
        # bumps the round and THEN swaps the dict, so a merge racing it
        # lands in the discarded old dict
        coverage = st.models_aggregated
        if st.round is None or round != st.round:
            return
        # union-merge, never overwrite: a stale redelivery must not shrink
        # a newer coverage view (the round-0 wedge of the JAX package)
        with st.status_merge_lock:
            prev = coverage.get(source)
            coverage[source] = sorted(set(prev) | set(args)) if prev else list(args)


class ModelsReadyCommand(Command):
    """Peer finished a round: ``nei_status[source] = round`` (max-merge;
    round - 1 tolerated)."""

    def __init__(self, state: "NodeState") -> None:
        self._state = state

    @staticmethod
    def get_name() -> str:
        return "models_ready"

    def execute(self, source: str, round: int, *args, **kwargs) -> None:  # noqa: A002
        st = self._state
        if st.round is not None and round in (st.round - 1, st.round):
            with st.status_merge_lock:
                st.nei_status[source] = max(st.nei_status.get(source, -1), round)
        else:
            logger.debug(st.addr, f"models_ready from {source} for round {round} (at {st.round}) — ignored")


class MetricsCommand(Command):
    """Peer evaluation metrics → global metric store, keyed by the peer."""

    def __init__(self, state: "NodeState") -> None:
        self._state = state

    @staticmethod
    def get_name() -> str:
        return "metrics"

    def execute(self, source: str, round: int, *args, **kwargs) -> None:  # noqa: A002
        for i in range(0, len(args) - 1, 2):
            logger.log_metric(
                source, args[i], float(args[i + 1]), round=round,
                experiment=self._state.experiment_name,
            )
