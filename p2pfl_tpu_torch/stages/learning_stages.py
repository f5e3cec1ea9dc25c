"""The six stages of a federated round.

Counterpart of ``p2pfl_tpu/stages/learning_stages.py``. Semantics follow
the reference, quirks included: voting happens only in round 0 and the
elected train set is reused for every round. topk8's delta-coding anchor
is pinned where every node holds the round's shared model (after the
init-weights sync, at each round boundary); under
``Settings.SECURE_AGGREGATION`` the stages run the key exchange, mask
the own contribution and strip what masks remain from the aggregate
(``learning/secagg.py``).
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

        if Settings.SECURE_AGGREGATION:
            from p2pfl_tpu_torch.learning import secagg

            # misconfigurations fail before any training: masks cancel only
            # through a lossless, linear aggregation path
            if Settings.WIRE_COMPRESSION != "none":
                logger.error(
                    node.addr,
                    f"SECURE_AGGREGATION is incompatible with WIRE_COMPRESSION="
                    f"{Settings.WIRE_COMPRESSION!r}: per-node quantization of the "
                    "masks breaks exact cancellation — aborting the experiment",
                )
                state.clear()
                return None
            if not getattr(node.aggregator, "MASK_COMPATIBLE", False):
                logger.error(
                    node.addr,
                    f"SECURE_AGGREGATION requires a linear aggregator (FedAvg "
                    f"family); {type(node.aggregator).__name__} would operate on "
                    "masked noise — aborting the experiment",
                )
                state.clear()
                return None
            # announce this experiment's DH public key and sample count (the
            # peers' pair mask scales need it); the count is latched, and
            # masking later checks the actual one against it
            state.secagg_priv, pub = secagg.dh_keypair()
            state.secagg_samples = node.learner.get_num_samples()
            node.protocol.broadcast(
                node.protocol.build_msg("secagg_pub", [f"{pub:x}", str(state.secagg_samples)], round=0)
            )

        if not sync_initial_model(node):
            return None
        # every node now holds the round's shared init weights: pin them as
        # topk8's delta-coding anchor for this round's payloads
        node.learner.set_wire_anchor(
            node.learner.get_parameters(), tag=f"{state.experiment_epoch}:{state.round or 0}"
        )
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
        # the Byzantine admission screen compares contributions with the
        # round-start global every train-set member shares (by reference)
        node.aggregator.set_screen_reference(node.learner.get_parameters())
        node.aggregator.set_nodes_to_aggregate(state.train_set)
        for gone in list(state.train_set_evicted):
            node.aggregator.discard_member(gone)
        if Settings.SECURE_AGGREGATION:
            # if a dropout leaves the masked aggregate unrecoverable, the
            # round falls back to this model instead of applying noise
            node.round_start_params = node.learner.get_parameters()

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
        if Settings.WIRE_COMPRESSION == "topk8" and Settings.TOPK_ERROR_FEEDBACK and not Settings.SECURE_AGGREGATION:
            # error feedback rides only on the own contribution: exactly one
            # encode a round writes the residual store
            own.ef_residual = node.learner.ef_residual_store()
        if Settings.SECURE_AGGREGATION and len(state.train_set) > 1:
            own = TrainStage._secagg_mask(node, own)
        if own is not None and not node.aggregator.SUPPORTS_PARTIALS:
            # robust strategies fold individual models: the fused round's
            # pre-averaged accumulator must never reach them (add_model
            # raises on it); own.params is the individual model either way
            own.partial_acc = None
        if own is not None:
            covered = node.aggregator.add_model(own)
            node.protocol.broadcast(
                node.protocol.build_msg("models_aggregated", covered, round=state.round or 0)
            )

        TrainStage._gossip_partial_aggregations(node)
        if node.learning_interrupted():
            return None
        return GossipModelStage

    @staticmethod
    def _secagg_mask(node: "Node", own):
        """Pairwise-mask the node's contribution (``learning/secagg.py``).

        Peers' DH keys were flooded at experiment start; a short poll covers
        gossip propagation lag. If masking still cannot be done safely,
        returns None — the contribution is SKIPPED, never sent unmasked
        (peers' halves of the pairwise masks would go uncancelled and turn a
        full-coverage aggregate into undetected noise; incomplete coverage
        is detected and reported by ``wait_and_get_aggregation`` instead).
        """
        from p2pfl_tpu_torch.exceptions import SecAggError
        from p2pfl_tpu_torch.learning import secagg

        state = node.state
        peers = [n for n in state.train_set if n != node.addr]
        deadline = time.monotonic() + Settings.VOTE_TIMEOUT
        while (
            any(n not in state.secagg_pubs for n in peers)
            and time.monotonic() < deadline
            and not node.learning_interrupted()
        ):
            time.sleep(0.1)
        round_no = state.round or 0
        # snapshot ONCE: the gossip thread keeps latching pubs while we run;
        # a key arriving between the double-mask gate and mask_update would
        # otherwise produce a pair-masked contribution with NO self mask and
        # no distributed shares — unresolvable for every peer, a guaranteed
        # federation-wide no-op round
        pubs = dict(state.secagg_pubs)
        self_seed = None
        if Settings.SECAGG_DOUBLE_MASK and peers and all(n in pubs for n in peers):
            # Bonawitz double mask: fresh per-round self seed, t-of-n
            # Shamir-shared with the train-set peers BEFORE contributing —
            # if we crash after our masked update lands, the surviving
            # majority reconstructs b^r and unsticks the aggregate, while
            # a wire snoop (who never gets t shares' plaintext — each is
            # encrypted to its holder) cannot strip the self mask
            import secrets as _secrets

            self_seed = _secrets.randbits(256)
            state.secagg_self_seed[round_no] = self_seed
            holders = sorted(peers)
            t = secagg.share_threshold(len(state.train_set))
            shares = secagg.shamir_split(self_seed, len(holders), t)
            exp = state.experiment_name or ""
            payload: list[str] = [exp]
            for holder, (x, y) in zip(holders, shares):
                key = secagg.dh_share_key(
                    state.secagg_priv, pubs[holder][0], exp
                )
                payload += [
                    holder,
                    str(x),
                    secagg.encrypt_share(y, key, round_no, node.addr, holder).hex(),
                ]
            node.protocol.broadcast(
                node.protocol.build_msg("secagg_share", payload, round=round_no)
            )
        try:
            return secagg.mask_update(
                own,
                node.addr,
                state.train_set,
                state.secagg_priv,
                pubs,
                state.experiment_name or "",
                round_no,
                announced_samples=state.secagg_samples,
                self_seed=self_seed,
            )
        except SecAggError as exc:
            logger.error(node.addr, f"SecAgg: {exc} — skipping this round's contribution")
            # peers hold shares of our self seed but our masked update never
            # entered the aggregate: make sure WE never reveal b^r either
            state.secagg_self_seed.pop(round_no, None)
            return None

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


def _noop_round_update(node: "Node", train: set):
    """The shared failed-recovery fallback: keep the round-start globals,
    flagged ``noop_round`` so GossipModelStage never diffuses them as the
    round's aggregate. One definition — three recovery paths
    (pair seeds, self seeds, missing weights) must stay in sync."""
    from p2pfl_tpu_torch.learning.weights import ModelUpdate

    prev = getattr(node, "round_start_params", None)
    if prev is None:
        prev = node.learner.get_parameters()
    return ModelUpdate(prev, sorted(train), 1, noop_round=True)


class GossipModelStage(Stage):
    """Close the round's aggregation and diffuse the result outward."""

    name = "GossipModelStage"

    @staticmethod
    def execute(node: "Node") -> Optional[Type[Stage]]:
        state = node.state
        timeout = None
        if Settings.SECURE_AGGREGATION and node.addr not in state.train_set:
            # non-train-set nodes only accept a full-coverage diffusion;
            # leave headroom for the train set's seed-recovery round to
            # finish before giving up on that diffusion arriving
            timeout = Settings.AGGREGATION_TIMEOUT + Settings.SECAGG_RECOVERY_TIMEOUT
        with _wait_span(node, "aggregation_wait") as sp:
            agg = node.aggregator.wait_and_get_aggregation(timeout=timeout)
            if sp is not None:
                # partial coverage here means the wait closed by timeout or
                # repair, not full arrival — the report's timeout-burn signal
                sp.attrs["contributors"] = len(agg.contributors)
        if Settings.SECURE_AGGREGATION:
            agg = GossipModelStage._secagg_finalize(node, agg)
        node.learner.set_parameters(agg.params)
        if node.learning_interrupted():
            return None
        node.protocol.broadcast(
            node.protocol.build_msg("models_ready", [], round=state.round or 0)
        )
        if agg.noop_round:
            # failed secagg recovery: our params are the round-start global,
            # NOT this round's aggregate — diffusing them with the full
            # train set as contributors would let behind neighbors adopt
            # stale params as round-r consensus while recovered peers
            # diffuse the real aggregate. Finish the round quietly; behind
            # neighbors get the aggregate from a recovered peer (or no-op
            # this round exactly as we did).
            logger.warning(
                node.addr,
                "SecAgg: no-op round — skipping outward diffusion of the "
                "round-start globals (not this round's aggregate)",
            )
            return RoundFinishedStage

        # diffusion: push the aggregated model to direct neighbors that are
        # behind on this round (reference gossip_model_stage.py:100-124)
        def candidates() -> list[str]:
            neis = node.protocol.get_neighbors(only_direct=True)
            return [n for n in neis if state.nei_status.get(n, -1) < (state.round or 0)]

        def model_fn(nei: str):
            # encode-once applies here too: contributors ride the envelope
            # header, not the encoded tensor bytes, so rewriting them below
            # never invalidates the cached payload
            update = node.learner.get_model_update()
            # claim the survivors, not the full elected set: after repair
            # the round's aggregate genuinely lacks the evicted members
            update.contributors = [
                n for n in state.train_set if n not in state.train_set_evicted
            ]
            if Settings.SECURE_AGGREGATION and Settings.SECAGG_DOUBLE_MASK:
                # mark the diffusion as FINALIZED (self-mask-free): a
                # receiver's aggregator may otherwise hold a bit-different
                # full-coverage sum assembled from still-masked partials
                from p2pfl_tpu_torch.learning.secagg import CLEAN_MARKER

                update.contributors = [*update.contributors, CLEAN_MARKER]
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

    @staticmethod
    def _secagg_finalize(node: "Node", agg):
        """Strip whatever masks remain on the round's resolved aggregate.

        Three layers, each a no-op when not applicable:

        1. PAIR recovery (partial coverage): the Bonawitz-style seed
           re-disclosure round (:meth:`_secagg_pair_recovery`).
        2. SELF-mask removal (``Settings.SECAGG_DOUBLE_MASK``): every
           contributor's per-round self mask is subtracted once its seed is
           revealed by its owner — or reconstructed from t-of-n Shamir
           shares when the owner contributed and then crashed
           (:meth:`_secagg_self_unmask`).
        3. Aggregates a peer diffused AFTER finalizing (``secagg_clean``
           flag from the wire marker) are already mask-free and pass
           through.

        Any failure resolves to a no-op round (round-start global kept)
        rather than applying a noised model.
        """
        state = node.state
        train = set(state.train_set)
        covered = set(agg.contributors)
        if len(train) <= 1 or agg.secagg_clean or agg.noop_round:
            return agg
        if covered != train:
            agg = GossipModelStage._secagg_pair_recovery(node, agg)
            if agg.noop_round or agg.secagg_clean:
                # secagg_clean: the split-brain rescue adopted a recovered
                # peer's finalized diffusion — already self-mask-free
                return agg
        elif node.addr not in train:
            # waiting-mode nodes only ever accept full-coverage diffusions;
            # an unmarked one predates double masking (or it is off) —
            # nothing to strip here either way
            return agg
        if Settings.SECAGG_DOUBLE_MASK:
            agg = GossipModelStage._secagg_self_unmask(node, agg)
        return agg

    @staticmethod
    def _secagg_pair_recovery(node: "Node", agg):
        """Dropout recovery: strip uncancelled PAIR masks from a partial
        aggregate.

        Partial coverage (some train-set member died before contributing) →
        the Bonawitz-style seed-recovery round (``learning/secagg.py``
        module docs): every survivor re-discloses its pair seeds *for the
        missing members only* (``secagg_recover`` broadcast), then everyone
        subtracts the exact uncancelled mask sum and continues with the
        survivors' clean partial aggregate — the same graceful degradation
        the reference's plain path has
        (``p2pfl/learning/aggregators/aggregator.py:236-242``). If the
        disclosures do not complete in ``Settings.SECAGG_RECOVERY_TIMEOUT``,
        the noised aggregate is DISCARDED and the round resolves to the
        round-start global (a no-op round) rather than destroying the model.
        """
        from p2pfl_tpu_torch.learning import secagg
        from p2pfl_tpu_torch.learning.weights import ModelUpdate

        state = node.state
        train = set(state.train_set)
        covered = set(agg.contributors)
        round_no = state.round or 0
        missing = sorted(train - covered)
        for j in missing:
            # Bonawitz invariant: members whose pair seeds this round may
            # get disclosed must never have their self seed reconstructed
            state.secagg_round_dropped.add((round_no, j))
        survivors = sorted(covered)
        logger.warning(
            node.addr,
            f"SecAgg: round {round_no} aggregate covers {survivors} — "
            f"recovering from dropout of {missing}",
        )

        weights: dict[str, int] = {n: pk[1] for n, pk in state.secagg_pubs.items()}
        if state.secagg_samples is not None:
            weights[node.addr] = state.secagg_samples
        recoverable = all(n in weights for n in set(survivors) | set(missing))

        # Recovery is request/response: broadcast WHICH members' masks we
        # cannot cancel (secagg_need) — every train-set member answers with
        # its pair seed for exactly those members (SecAggNeedCommand),
        # INCLUDING peers whose own coverage reached full and finalized
        # early (coverage views can differ at timeout: a partial that
        # reached us may have been lost to a peer). Proactively disclose our
        # own seeds for our own missing set too — peers recovering the same
        # view get them without a round trip. A LONE survivor never
        # discloses (its "aggregate" is its own model; the seeds would let
        # a wire snoop unmask it, and no peer holds anything that needs
        # them). Divergence note: if a needed disclosure is still lost,
        # some nodes recover while others no-op the round — they briefly
        # hold different models, exactly like the reference's plain
        # partial-timeout path, and the next round's aggregation
        # re-converges them.
        # pairs involving this node are locally computable by DH symmetry —
        # only the strictly-foreign pairs need the gossip plane, and only
        # when some exist is a secagg_need broadcast justified (a lone
        # survivor asking would solicit disclosures nobody uses)
        needed = {
            (i, j) for i in survivors for j in missing if node.addr not in (i, j)
        }
        exp = state.experiment_name or ""
        if recoverable and needed:
            node.protocol.broadcast(
                node.protocol.build_msg(
                    "secagg_need",
                    [exp] + sorted({j for _i, j in needed}),
                    round=round_no,
                )
            )
        live = set(node.protocol.get_neighbors(only_direct=False))
        if recoverable and node.addr in covered and len(survivors) > 1:
            # same standard of evidence as the secagg_need ANSWER path
            # (SecAggNeedCommand's liveness check): a member merely missing
            # from OUR coverage view may have contributed elsewhere and
            # already revealed its self seed on that evidence — proactively
            # disclosing its pair seeds while it is still live on the
            # overlay would publish both seed types for one (node, round)
            for j in missing:
                if j in live:
                    logger.warning(
                        node.addr,
                        f"SecAgg: {j} is missing from our coverage but still "
                        "live — withholding its pair seeds (a peer may hold "
                        "its contribution)",
                    )
                    continue
                if (round_no, j, j) in state.secagg_share_reveals:
                    # j's SELF seed is already public this round (it
                    # contributed somewhere and revealed before dying):
                    # disclosing its pair seeds too would publish both seed
                    # types for one (node, round) — the exact breach double
                    # masking exists to prevent. Privacy over availability.
                    logger.warning(
                        node.addr,
                        f"SecAgg: {j} already revealed its self seed this "
                        "round — withholding its pair seeds",
                    )
                    continue
                if j not in state.secagg_pubs or (round_no, j) in state.secagg_disclosure_sent:
                    continue
                state.secagg_disclosure_sent.add((round_no, j))
                seed = secagg.dh_pair_seed(state.secagg_priv, state.secagg_pubs[j][0], exp)
                node.protocol.broadcast(
                    node.protocol.build_msg("secagg_recover", [j, f"{seed:x}"], round=round_no)
                )
        if recoverable and any(j in live for j in missing):
            # a LIVE "missing" member means every honest peer (us included)
            # refuses to disclose its pair seeds — this seed recovery
            # provably cannot complete. Its contribution reached somebody
            # (that is why it is alive and un-evicted), so skip the futile
            # disclosure wait and adopt the recovered peers' finalized
            # diffusion instead — entering waiting mode NOW, while their
            # diffusion gossip is still retrying against us.
            rescued = GossipModelStage._secagg_split_brain_rescue(node, train, missing)
            if rescued is not None:
                return rescued
            logger.error(
                node.addr,
                "SecAgg: split-brain with a live missing member and no "
                "finalized diffusion arrived — no-op round",
            )
            return _noop_round_update(node, train)

        deadline = time.monotonic() + Settings.SECAGG_RECOVERY_TIMEOUT
        while (
            recoverable
            and not all((round_no, j, i) in state.secagg_disclosed for i, j in needed)
            and time.monotonic() < deadline
            and not node.learning_interrupted()
        ):
            time.sleep(0.1)

        seeds: dict[tuple[str, str], int] = {}
        if recoverable:
            for i, j in needed:
                v = state.secagg_disclosed.get((round_no, j, i))
                if v is None:
                    recoverable = False
                    break
                seeds[(i, j)] = v
        if recoverable:
            for i in survivors:
                for j in missing:
                    if node.addr == i:
                        seeds[(i, j)] = secagg.dh_pair_seed(
                            state.secagg_priv, state.secagg_pubs[j][0], exp
                        )
                    elif node.addr == j:
                        seeds[(i, j)] = secagg.dh_pair_seed(
                            state.secagg_priv, state.secagg_pubs[i][0], exp
                        )

        if not recoverable:
            rescued = GossipModelStage._secagg_split_brain_rescue(
                node, train, missing
            )
            if rescued is not None:
                return rescued
            # never apply or diffuse a known-noised model — give
            # the round up instead, keeping the round-start global
            logger.error(
                node.addr,
                "SecAgg: seed recovery incomplete — discarding the noised "
                "aggregate; this round is a no-op (round-start global kept)",
            )
            return _noop_round_update(node, train)

        correction = secagg.dropout_correction(
            agg.params, survivors, missing, seeds, weights, round_no
        )
        params = secagg.apply_dropout_correction(
            agg.params, correction, float(agg.num_samples)
        )
        logger.info(
            node.addr,
            f"SecAgg: recovered the survivors' clean aggregate ({len(survivors)} "
            f"of {len(train)} members, {len(missing)} seed set(s) disclosed)",
        )
        return ModelUpdate(params, list(agg.contributors), agg.num_samples)

    @staticmethod
    def _secagg_split_brain_rescue(node: "Node", train: set, missing: list):
        """Pair recovery failed but a "missing" member is still LIVE: it
        contributed to peers whose coverage view includes it (that is WHY
        everyone refuses to disclose its pair seeds — the refusal protects
        a real contribution). Those peers therefore hold the round's clean
        aggregate and their diffusion targets us — we have not announced
        ``models_ready`` yet, so we count as behind. Wait for the finalized
        diffusion like a non-train-set node instead of no-opping a round
        whose result demonstrably exists. Returns the adopted update, or
        None when no (trustably finalized) diffusion arrives in time.
        """
        state = node.state
        live = set(node.protocol.get_neighbors(only_direct=False))
        if not any(j in live for j in missing):
            return None  # genuinely dead members: nothing to wait for
        logger.warning(
            node.addr,
            "SecAgg: a missing member is still live (split-brain coverage) "
            "— waiting for a recovered peer's finalized diffusion instead "
            "of no-opping",
        )
        node.aggregator.set_waiting_aggregated_model(list(train))
        try:
            rescued = node.aggregator.wait_and_get_aggregation(
                timeout=Settings.SECAGG_RECOVERY_TIMEOUT
            )
        except Exception:  # noqa: BLE001 — nothing arrived: fall through to no-op
            return None
        if set(rescued.contributors) == train:
            # a still-MASKED full-coverage aggregate (a peer's partial
            # gossip covering the whole train set, no CLEAN_MARKER) is just
            # as good: pair masks cancel at full coverage and the caller's
            # finalize flow runs the normal self-unmask pass on anything
            # not flagged clean — rejecting it would throw away the round's
            # result AND burn the one-shot waiting window
            logger.info(
                node.addr,
                "SecAgg: adopted a peer's full-coverage aggregate "
                f"(split-brain rescue, finalized={rescued.secagg_clean})",
            )
            return rescued
        return None

    @staticmethod
    def _secagg_self_unmask(node: "Node", agg):
        """Bonawitz double masking, unmask phase.

        Every contributor's ``STD·PRG_self(b_i^r)`` still rides on the
        aggregate. This node (a) discloses its OWN per-round seed — unless
        any pair-seed disclosure about it was observed this round (the
        at-most-one-of-{pair,self} invariant); (b) waits for every
        contributor's seed, revealing its held Shamir shares ONLY for
        owners whose direct reveal hasn't landed after a grace period (the
        crash backstop — flooding all n−1 shares every round would be
        O(n²) control traffic for nothing in the no-crash common case);
        then (c) subtracts the summed self masks. Incomplete ⇒ no-op
        round, exactly like pair recovery: privacy over availability.
        """
        from p2pfl_tpu_torch.learning import secagg
        from p2pfl_tpu_torch.learning.weights import ModelUpdate

        state = node.state
        train = set(state.train_set)
        round_no = state.round or 0
        contributors = sorted(set(agg.contributors))
        exp = state.experiment_name or ""
        my_b = state.secagg_self_seed.get(round_no)

        if node.addr in contributors:
            secagg.maybe_reveal_self_seed(node, round_no)

        t = secagg.share_threshold(len(train))

        def resolve_seeds():
            """(seeds or None, owners still unresolved)."""
            # shares that arrived for THIS round while the node was still in
            # the previous one were stashed un-judged (the holder list
            # hadn't latched); the train set is live now, so re-validate and
            # promote them before reading the reveal table
            from p2pfl_tpu_torch.commands.control import promote_early_reveals

            promote_early_reveals(state)
            seeds: dict[str, int] = {}
            unresolved: list[str] = []
            for i in contributors:
                if i == node.addr and my_b is not None:
                    seeds[i] = my_b
                    continue
                direct = state.secagg_share_reveals.get((round_no, i, i))
                if direct is not None and direct[0] == 0:
                    seeds[i] = direct[1]
                    continue
                distinct = {
                    xy[0]: xy[1]
                    for (r, o, _src), xy in list(state.secagg_share_reveals.items())
                    if r == round_no and o == i and xy[0] >= 1
                }
                own_share = state.secagg_shares_held.get((round_no, i))
                if own_share is not None:
                    # our own held share never rides the broadcast back to
                    # us (protocol.broadcast is neighbors-only) — without it
                    # a single crash is unrecoverable for n <= 5
                    distinct.setdefault(own_share[0], own_share[1])
                if len(distinct) >= t:
                    b = secagg.shamir_reconstruct(list(distinct.items()))
                    if b < (1 << 256):  # corrupted shares reconstruct garbage
                        seeds[i] = b
                        continue
                unresolved.append(i)
            return (None if unresolved else seeds), unresolved

        def reveal_shares_for(owners: list[str]) -> None:
            for i in owners:
                if i == node.addr or (round_no, i) in state.secagg_round_dropped:
                    continue
                if (round_no, i) in state.secagg_reveal_sent:
                    continue
                share = state.secagg_shares_held.get((round_no, i))
                if share is None:
                    continue
                state.secagg_reveal_sent.add((round_no, i))
                node.protocol.broadcast(
                    node.protocol.build_msg(
                        "secagg_reveal",
                        [exp, i, str(share[0]), f"{share[1]:x}"],
                        round=round_no,
                    )
                )

        deadline = time.monotonic() + Settings.SECAGG_RECOVERY_TIMEOUT
        grace = time.monotonic() + min(2.0, Settings.SECAGG_RECOVERY_TIMEOUT / 3)
        seeds, unresolved = resolve_seeds()
        while seeds is None and time.monotonic() < deadline and not node.learning_interrupted():
            if time.monotonic() >= grace and unresolved:
                reveal_shares_for(unresolved)  # latched: re-calls are no-ops
            time.sleep(0.1)
            seeds, unresolved = resolve_seeds()

        if seeds is None:
            logger.error(
                node.addr,
                "SecAgg: self-mask seeds unresolved — discarding the masked "
                "aggregate; this round is a no-op (round-start global kept)",
            )
            return _noop_round_update(node, train)

        weights: dict[str, int] = {n: pk[1] for n, pk in state.secagg_pubs.items()}
        if state.secagg_samples is not None:
            weights[node.addr] = state.secagg_samples
        if any(i not in weights for i in contributors):
            logger.error(
                node.addr,
                "SecAgg: missing announced weights for a contributor — "
                "cannot scale self-mask correction; no-op round",
            )
            return _noop_round_update(node, train)
        correction = secagg.self_mask_correction(
            agg.params, contributors, seeds, weights, round_no
        )
        params = secagg.apply_dropout_correction(
            agg.params, correction, float(agg.num_samples)
        )
        logger.info(
            node.addr,
            f"SecAgg: self masks removed for {len(contributors)} contributor(s) "
            f"(round {round_no})",
        )
        return ModelUpdate(params, list(agg.contributors), agg.num_samples)


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
        # round boundary: the diffused aggregate is the next round's shared
        # model. Re-pin the anchor here, not in set_parameters: this round's
        # remaining diffusion sends still delta-code against the anchor the
        # behind nodes hold
        node.learner.set_wire_anchor(node.learner.get_parameters(), tag=f"{state.experiment_epoch}:{state.round}")
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
