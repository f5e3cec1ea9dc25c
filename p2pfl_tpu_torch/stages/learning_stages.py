"""The six stages of a federated round.

Counterpart of ``p2pfl_tpu/stages/learning_stages.py`` without the
secure-aggregation branches, the wire-codec anchors of topk8 (ROADMAP
item 4b) and the Byzantine admission screen (item 7). Semantics follow
the reference, quirks included: voting happens only in round 0 and the
elected train set is reused for every round.
Device work (fit / evaluate / aggregate) happens inside the learner and
the aggregator; every ``wait`` here is a host-side event.
"""

from __future__ import annotations

import math
import random
import time
from typing import TYPE_CHECKING, Optional, Type

from p2pfl_tpu_torch.management.logger import logger
from p2pfl_tpu_torch.management.telemetry import telemetry
from p2pfl_tpu_torch.settings import Settings
from p2pfl_tpu_torch.stages.stage import Stage

if TYPE_CHECKING:
    from p2pfl_tpu_torch.node import Node


def _wait_span(node: "Node", name: str):
    """A sub-span on the stage plane for a wait that gates the round."""
    return telemetry.span(
        node.addr, name, kind="stage",
        attrs={"round": node.state.round, "experiment": node.state.experiment_name},
    )


def broadcast_metrics(node: "Node", metrics: dict) -> None:
    """The one builder of the ``metrics`` wire message."""
    if not metrics:
        return
    flat: list[str] = []
    for k, v in metrics.items():
        flat += [k, str(float(v))]
    node.protocol.broadcast(node.protocol.build_msg("metrics", flat, round=node.state.round or 0))


def sync_initial_model(node: "Node") -> bool:
    """Synchronize the experiment's initial weights across the overlay:
    consume an init_model that raced ahead of ``start_learning``, wait for
    the ``model_initialized`` latch, apply the pending init, then push the
    init weights to peers that have not announced initialization. False
    when the experiment cannot proceed (init timeout → graceful abort;
    architecture mismatch → the node stops itself; interrupt)."""
    state = node.state
    early = node.take_early_init()
    if early is not None and not state.model_initialized_event.is_set():
        try:
            node.pending_init_update = node.learner.decode_update(early)
            state.model_initialized_event.set()
            node.protocol.broadcast(node.protocol.build_msg("model_initialized"))
        except Exception as exc:  # noqa: BLE001 — a bad stash falls back to the normal wait
            logger.info(node.addr, f"Stashed early init_model unusable ({exc!r}) — waiting for redelivery")

    if not state.model_initialized_event.wait(timeout=Settings.AGGREGATION_TIMEOUT):
        logger.error(
            node.addr,
            "Initial model never arrived within AGGREGATION_TIMEOUT — "
            "aborting the experiment (node keeps serving)",
        )
        node.take_early_init()
        state.clear()
        return False
    if node.pending_init_update is not None:
        try:
            node.learner.set_parameters(node.pending_init_update.params)
        except Exception as exc:  # noqa: BLE001 — mismatched init stops the node
            logger.error(node.addr, f"Initial model does not match architecture: {exc} — stopping")
            node.stop_async()
            return False
        node.pending_init_update = None

    def candidates() -> list[str]:
        neis = node.protocol.get_neighbors(only_direct=True)
        return [n for n in neis if state.nei_status.get(n, 0) != -1]

    def model_fn(nei: str):
        # encode-once: the update carries the learner's payload cache, so
        # byte transports serialize once per model version, not once per
        # candidate per tick
        return node.protocol.build_weights("init_model", 0, node.learner.get_model_update())

    node.protocol.gossip_weights(
        early_stopping_fn=node.learning_interrupted,
        get_candidates_fn=candidates,
        status_fn=lambda: sorted(candidates()),
        model_fn=model_fn,
    )
    return not node.learning_interrupted()


class StartLearningStage(Stage):
    """Set up the experiment, synchronize initial weights across the overlay."""

    name = "StartLearningStage"

    @staticmethod
    def execute(node: "Node") -> Optional[Type[Stage]]:
        state = node.state
        state.set_experiment(node.experiment_name, node.total_rounds, xid=node._pending_xid)
        node.protocol.experiment_xid = state.experiment_xid
        logger.experiment_started(node.addr)
        node.aggregator.reset_experiment()
        node.learner.set_epochs(node.epochs)
        node.learner.set_addr(node.addr)
        # a metric stash left by an aborted round must not flush into this
        # experiment's round 0
        node.learner.pop_round_metrics()
        if not sync_initial_model(node):
            return None
        # let heartbeats flood so the full membership is known before voting
        time.sleep(Settings.WAIT_HEARTBEATS_CONVERGENCE)
        return VoteTrainSetStage


class VoteTrainSetStage(Stage):
    """Elect the train set by weighted random voting."""

    name = "VoteTrainSetStage"

    @staticmethod
    def execute(node: "Node") -> Optional[Type[Stage]]:
        state = node.state
        candidates = list(node.protocol.get_neighbors(only_direct=False)) + [node.addr]

        # up to TRAIN_SET_SIZE random picks, weight ~ floor(U(0,1000)/(i+1))
        samples = min(Settings.TRAIN_SET_SIZE, len(candidates))
        picks = random.sample(candidates, samples)
        my_votes = {n: math.floor(random.randint(0, 1000) / (i + 1)) for i, n in enumerate(picks)}
        with state.train_set_votes_lock:
            state.train_set_votes[node.addr] = dict(my_votes)
        flat: list[str] = []
        for n, w in my_votes.items():
            flat += [n, str(w)]
        node.protocol.broadcast(node.protocol.build_msg("vote_train_set", flat, round=state.round or 0))

        # collect until every LIVE candidate voted or VOTE_TIMEOUT; liveness
        # is re-read every iteration so an evicted candidate releases the wait
        deadline = time.monotonic() + Settings.VOTE_TIMEOUT
        while not node.learning_interrupted():
            with state.train_set_votes_lock:
                voted = set(state.train_set_votes)
            live = set(node.protocol.get_neighbors(only_direct=False)) | {node.addr}
            waiting = (set(candidates) & live) - voted
            if not waiting:
                dead = sorted(set(candidates) - live)
                if dead:
                    logger.info(
                        node.addr,
                        f"Vote: all live candidates voted — proceeding without "
                        f"evicted candidate(s) {dead}",
                    )
                break
            if time.monotonic() >= deadline:
                logger.info(node.addr, f"Vote timeout — proceeding with {len(voted)}/{len(candidates)} votes")
                break
            state.votes_ready_event.wait(timeout=2)
            state.votes_ready_event.clear()
        if node.learning_interrupted():
            return None

        # tally with a deterministic tie-break (votes desc, then name desc)
        with state.train_set_votes_lock:
            all_votes = {v: dict(w) for v, w in state.train_set_votes.items()}
            state.train_set_votes.clear()
        results: dict[str, int] = {}
        for votes in all_votes.values():
            for n, w in votes.items():
                results[n] = results.get(n, 0) + int(w)
        ranked = sorted(results.items(), key=lambda kv: (kv[1], kv[0]), reverse=True)
        train_set = [n for n, _ in ranked[: Settings.TRAIN_SET_SIZE]]

        with state.train_set_lock:
            live = set(node.protocol.get_neighbors(only_direct=False)) | {node.addr}
            state.train_set = [n for n in train_set if n in live]
            state.train_set_evicted = set()
        logger.info(node.addr, f"Train set: {state.train_set}")
        return TrainStage if node.addr in state.train_set else WaitAggregatedModelsStage


class TrainStage(Stage):
    """Local training + partial-aggregation gossip within the train set."""

    name = "TrainStage"

    @staticmethod
    def execute(node: "Node") -> Optional[Type[Stage]]:
        state = node.state
        node.aggregator.set_nodes_to_aggregate(state.train_set)
        for gone in list(state.train_set_evicted):
            node.aggregator.discard_member(gone)

        # local compute. Fused (Settings.ROUND_FUSED): the eval of the
        # incoming model, every local epoch and the own weighted partial
        # fold in one call (one replayed CUDA graph on a card); its metrics
        # stay device tensors until RoundFinishedStage's flush. Learners
        # that cannot fuse return None and take the staged path, the
        # parity baseline
        own = None
        if Settings.ROUND_FUSED and not node.learning_interrupted():
            own = node.learner.fused_round()
        if own is None:
            broadcast_metrics(node, node.learner.evaluate())
            if node.learning_interrupted():
                return None
            node.learner.fit()
            if node.learning_interrupted():
                return None
            own = node.learner.get_model_update()
        if node.learning_interrupted():
            return None
        if not node.aggregator.SUPPORTS_PARTIALS:
            # robust strategies fold individual models: the fused round's
            # pre-averaged accumulator must never reach them (add_model
            # raises on it); own.params is the individual model either way
            own.partial_acc = None
        covered = node.aggregator.add_model(own)
        node.protocol.broadcast(
            node.protocol.build_msg("models_aggregated", covered, round=state.round or 0)
        )

        TrainStage._gossip_partial_aggregations(node)
        if node.learning_interrupted():
            return None
        return GossipModelStage

    @staticmethod
    def _gossip_partial_aggregations(node: "Node") -> None:
        """Push partials to train-set peers until everyone has full
        coverage; each candidate gets exactly the contributions it misses."""
        state = node.state

        def live_train() -> set:
            # re-read every tick: mid-round repair records evictions here
            return set(state.train_set) - state.train_set_evicted

        def candidates() -> list[str]:
            train = live_train()
            return [
                n for n in train - {node.addr}
                if not (train <= set(state.models_aggregated.get(n, [])))
            ]

        def status():
            train = live_train()
            return {n: tuple(sorted(state.models_aggregated.get(n, []))) for n in sorted(train)}

        def model_fn(nei: str):
            peer_has = state.models_aggregated.get(nei, [])
            partial = node.aggregator.get_partial_aggregation(peer_has)
            if partial is None:
                todo = node.aggregator.get_models_to_send(peer_has)
                if not todo:
                    return None
                partial = todo[0]
            return node.protocol.build_weights("add_model", state.round or 0, partial)

        with _wait_span(node, "gossip_partials"):
            node.protocol.gossip_weights(
                early_stopping_fn=node.learning_interrupted,
                get_candidates_fn=candidates,
                status_fn=status,
                model_fn=model_fn,
                create_connection=True,
            )


class WaitAggregatedModelsStage(Stage):
    """Non-train-set path: wait for the aggregated model to be pushed to us."""

    name = "WaitAggregatedModelsStage"

    @staticmethod
    def execute(node: "Node") -> Optional[Type[Stage]]:
        node.aggregator.set_waiting_aggregated_model(node.state.train_set)
        for gone in list(node.state.train_set_evicted):
            node.aggregator.discard_member(gone)
        return GossipModelStage


class GossipModelStage(Stage):
    """Close the round's aggregation and diffuse the result outward."""

    name = "GossipModelStage"

    @staticmethod
    def execute(node: "Node") -> Optional[Type[Stage]]:
        state = node.state
        with _wait_span(node, "aggregation_wait") as sp:
            agg = node.aggregator.wait_and_get_aggregation()
            if sp is not None:
                sp.attrs["contributors"] = len(agg.contributors)
        node.learner.set_parameters(agg.params)
        if node.learning_interrupted():
            return None
        node.protocol.broadcast(node.protocol.build_msg("models_ready", [], round=state.round or 0))

        # diffusion: push the aggregate to direct neighbors behind on this round
        def candidates() -> list[str]:
            neis = node.protocol.get_neighbors(only_direct=True)
            return [n for n in neis if state.nei_status.get(n, -1) < (state.round or 0)]

        def model_fn(nei: str):
            # encode-once here too: contributors ride the envelope header,
            # not the encoded bytes, so rewriting them keeps the cache valid
            update = node.learner.get_model_update()
            # claim the survivors: after repair the aggregate lacks the evicted
            update.contributors = [n for n in state.train_set if n not in state.train_set_evicted]
            return node.protocol.build_weights("add_model", state.round or 0, update)

        with _wait_span(node, "diffusion"):
            node.protocol.gossip_weights(
                early_stopping_fn=node.learning_interrupted,
                get_candidates_fn=candidates,
                status_fn=lambda: sorted(candidates()),
                model_fn=model_fn,
            )
        if node.learning_interrupted():
            return None
        return RoundFinishedStage


class RoundFinishedStage(Stage):
    """Advance or finish. The next round skips voting (round-0 train set
    reused); non-elected nodes go back to waiting."""

    name = "RoundFinishedStage"

    @staticmethod
    def _flush_round_metrics(node: "Node") -> None:
        """The fused round's one metric flush a round: convert what
        ``fused_round`` stashed (after aggregation forced the round, so
        the conversions wait for nothing) and publish it as the staged
        path would have: the per-epoch ``train_loss`` series into the
        local store at ``fit``'s step numbers, the eval metrics as the
        ``metrics`` message."""
        metrics = node.learner.pop_round_metrics()
        if not metrics:
            return
        series = metrics.pop("train_loss_series", None)
        if series is not None:
            losses, steps = series
            for step, loss in zip(steps, losses.tolist()):
                logger.log_metric(node.addr, "train_loss", float(loss), step=step)
        broadcast_metrics(node, metrics)

    @staticmethod
    def execute(node: "Node") -> Optional[Type[Stage]]:
        state = node.state
        if node.learning_interrupted():
            logger.info(node.addr, "Early stopping.")
            return None
        RoundFinishedStage._flush_round_metrics(node)
        node.aggregator.clear()
        state.increase_round()
        logger.round_finished(node.addr)
        if state.round is not None and state.total_rounds is not None and state.round < state.total_rounds:
            if Settings.VOTE_EVERY_ROUND:
                return VoteTrainSetStage
            return TrainStage if node.addr in state.train_set else WaitAggregatedModelsStage
        # experiment over: final evaluation, clear state
        metrics = node.learner.evaluate()
        for k, v in (metrics or {}).items():
            logger.log_metric(node.addr, k, float(v), round=state.round, experiment=state.experiment_name)
        logger.experiment_finished(node.addr)
        state.clear()
        return None
