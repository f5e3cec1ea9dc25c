"""Small control-plane commands: votes, round status, metrics.

Counterpart of ``p2pfl_tpu/commands/control.py``, the secure-aggregation
verbs included (``secagg_pub``, ``secagg_recover``, ``secagg_need``,
``secagg_share``, ``secagg_reveal``; ``learning/secagg.py``). All mutate
:class:`~p2pfl_tpu_torch.node_state.NodeState` under its locks; the status
merges are monotone (a stale redelivery never regresses a view) and
serialized by ``status_merge_lock``.
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


class SecAggPubCommand(Command):
    """Peer announced its DH public key + sample count for secure aggregation.

    Args: ``[pub_hex, num_samples]``; flooded over the message gossip at
    experiment start (``learning/secagg.py`` — the sample counts set the
    pairwise mask scales). No round check — keys are per-experiment.
    """

    def __init__(self, state: "NodeState") -> None:
        self._state = state

    @staticmethod
    def get_name() -> str:
        return "secagg_pub"

    def execute(self, source: str, round: int, *args, **kwargs) -> None:  # noqa: A002
        if len(args) < 2:
            logger.error(self._state.addr, f"Malformed secagg_pub from {source}: need key + samples")
            return
        try:
            pub = int(args[0], 16)
            samples = int(args[1])
        except ValueError:
            logger.error(self._state.addr, f"Malformed secagg_pub from {source}: bad values")
            return
        from p2pfl_tpu_torch.learning.secagg import valid_public_key

        if not valid_public_key(pub):
            # 0/1/p-1 make the pair's shared secret trivially computable —
            # an active attacker spoofing this message could strip the
            # victim's masks; never store a degenerate key
            logger.error(self._state.addr, f"Degenerate DH key from {source} — rejected")
            return
        if samples <= 0:
            logger.error(self._state.addr, f"Non-positive sample count from {source} — rejected")
            return
        held = self._state.secagg_pubs.get(source)
        if held is not None:
            # latch the FIRST key per (source, experiment): the gossip plane
            # is unauthenticated, so a later re-broadcast with a spoofed
            # source must not replace the key a victim's peers already use
            # (an attacker-controlled key would let them derive all of the
            # victim's pair seeds and strip its masks). Identical
            # re-deliveries are normal gossip redundancy.
            if held != (pub, samples):
                logger.error(
                    self._state.addr,
                    f"secagg_pub from {source} tried to replace an already-"
                    "latched key — rejected (possible spoofing)",
                )
            return
        self._state.secagg_pubs[source] = (pub, samples)


class SecAggRecoverCommand(Command):
    """A survivor re-disclosed its pair seed for a dropped train-set member.

    Args: ``[dropped_addr, seed_hex]``; the message's round field pins the
    round being recovered. Stored under (round, dropped, source) — the
    recovery routine in ``stages/learning_stages.py`` waits until every
    survivor's seed for every missing member is present, then subtracts
    the uncancelled mask sum (``learning/secagg.py:dropout_correction``).
    """

    def __init__(self, state: "NodeState") -> None:
        self._state = state

    @staticmethod
    def get_name() -> str:
        return "secagg_recover"

    def execute(self, source: str, round: int, *args, **kwargs) -> None:  # noqa: A002
        st = self._state
        if len(args) < 2:
            logger.error(st.addr, f"Malformed secagg_recover from {source}")
            return
        try:
            seed = int(args[1], 16)
        except ValueError:
            logger.error(st.addr, f"Malformed secagg_recover seed from {source}")
            return
        if not 0 <= seed < (1 << 256):
            # an out-of-range stored seed would make _leaf_mask's
            # to_bytes(32) raise mid-recovery and kill the experiment on
            # every survivor — one malformed message must not do that
            logger.error(st.addr, f"Out-of-range secagg_recover seed from {source} — rejected")
            return
        if st.round is not None and round != st.round:
            logger.debug(st.addr, f"secagg_recover from {source} for round {round} (at {st.round}) — ignored")
            return
        key = (round, args[0], source)
        # first disclosure wins, same latch rationale as secagg_pub
        st.secagg_disclosed.setdefault(key, seed)
        # Bonawitz invariant: once ANY pair-seed disclosure about a member
        # is observed this round, never help reconstruct its self seed
        st.secagg_round_dropped.add((round, args[0]))


class SecAggNeedCommand(Command):
    """A recovering peer announced which members' masks it cannot cancel.

    Args: ``[experiment_name, missing...]``. A train-set member answers by
    re-disclosing its pair seed for the named members — INCLUDING when its
    own coverage reached full (early finalizers would otherwise never
    disclose, leaving a peer with a smaller coverage view to burn its
    recovery timeout for nothing) and INCLUDING when it already disclosed
    for an earlier request (a lagging requester drops disclosures for
    rounds it has not reached yet; re-broadcasts are idempotent because
    receivers latch first-wins). Pair seeds are per-experiment, so
    answering for the previous round is safe; the experiment name in the
    request guards against latching a wrong-experiment seed.

    A request is a claim, not proof — the responder demands its OWN
    evidence before disclosing anything: it only answers for members that
    are no longer live on the overlay (heartbeat-evicted; a genuinely
    dropped node disappears within HEARTBEAT_TIMEOUT, long before any
    AGGREGATION_TIMEOUT fires). A forged secagg_need naming a live member
    is refused — the requester then no-ops its round (availability
    sacrificed, the live member's masks kept). Requests must also come
    from a train-set member. Under VOTE_EVERY_ROUND a re-voted train set
    can make cross-round requests unanswerable (``j not in train``) — the
    requester degrades to a no-op round.
    """

    def __init__(self, node) -> None:  # "Node"; untyped to avoid the import cycle
        self._node = node

    @staticmethod
    def get_name() -> str:
        return "secagg_need"

    def execute(self, source: str, round: int, *args, **kwargs) -> None:  # noqa: A002
        from p2pfl_tpu_torch.learning import secagg

        node = self._node
        st = node.state
        if st.secagg_priv is None or len(args) < 2 or st.round is None:
            return
        if round not in (st.round - 1, st.round):
            return
        exp = st.experiment_name or ""
        if args[0] != exp:
            logger.debug(st.addr, f"secagg_need from {source} for experiment {args[0]!r} — ignored")
            return
        train = set(st.train_set)
        if node.addr not in train or source not in train or len(train) <= 2:
            # non-members have no standing to request; in a 2-member train
            # set the only pair seed IS the full mask of the other member's
            # update — never disclose it
            return
        live = set(node.protocol.get_neighbors(only_direct=False))
        for j in args[1:]:
            if j in train and j != node.addr:
                # a need CLAIM alone poisons j's self-seed reconstruction
                # for this round (Bonawitz invariant: some peer may answer
                # it even if we refuse) — conservative, costs availability
                # only in the forged/split-brain case. NOT for ourselves:
                # while we are alive, honest peers refuse to disclose our
                # pair seeds regardless of claims (their liveness check),
                # so our own reveal stays safe — self-poisoning here would
                # let any split-brain need starve a round whose clean
                # aggregate exists (the rescue path depends on our reveal)
                st.secagg_round_dropped.add((round, j))
            if j == node.addr or j == source or j not in train or j not in st.secagg_pubs:
                continue
            if j in live:
                logger.warning(
                    st.addr,
                    f"secagg_need from {source} names {j}, which is still live "
                    "here — refusing to disclose its pair seed",
                )
                continue
            if (round, j, j) in st.secagg_share_reveals:
                # the invariant's OTHER direction: j already revealed its
                # SELF seed this round (it contributed somewhere, then
                # died) — disclosing its pair seeds too would publish both
                # seed types and unmask its captured update. Our aggregate
                # stays stuck instead (no-op round): privacy > availability.
                logger.warning(
                    st.addr,
                    f"secagg_need from {source} names {j}, whose self seed "
                    "is already revealed this round — refusing to disclose "
                    "its pair seeds (it contributed before dying)",
                )
                continue
            # Latch per (round, j, REQUESTER), not per (round, j): a lagging
            # requester may have dropped an earlier broadcast triggered by a
            # different peer's request (SecAggRecoverCommand ignores frames
            # whose round != st.round), so a global send-once latch would
            # leave it burning SECAGG_RECOVERY_TIMEOUT for nothing —
            # re-broadcasting the same seed is idempotent (receivers latch
            # first-wins). Keying by requester keeps amplification bounded:
            # a replaying attacker must be a train-set member (standing
            # check above), so the worst case is one broadcast per
            # (accepted round — st.round-1 and st.round both qualify —
            # × missing member × requesting member), fixed per experiment
            # round; replays beyond that are absorbed by the latch.
            if (round, j, source) in st.secagg_disclosure_sent:
                continue
            st.secagg_disclosure_sent.add((round, j, source))
            # the 2-tuple key still lets the proactive disclosure path
            # (learning_stages._secagg_finalize) skip its redundant send
            st.secagg_disclosure_sent.add((round, j))
            seed = secagg.dh_pair_seed(st.secagg_priv, st.secagg_pubs[j][0], exp)
            node.protocol.broadcast(
                node.protocol.build_msg("secagg_recover", [j, f"{seed:x}"], round=round)
            )


class SecAggShareCommand(Command):
    """A contributor distributed Shamir shares of its per-round self-mask
    seed (Bonawitz double masking, ``learning/secagg.py``).

    Args: ``[experiment, holder1, x1, ct1_hex, holder2, x2, ct2_hex, ...]``
    — one encrypted share per train-set peer, all in one broadcast; each
    holder decrypts only its own entry (stream-keyed by the DH pair seed
    and the round). Stored under (round, owner); first delivery wins.
    """

    def __init__(self, state: "NodeState") -> None:
        self._state = state

    @staticmethod
    def get_name() -> str:
        return "secagg_share"

    def execute(self, source: str, round: int, *args, **kwargs) -> None:  # noqa: A002
        from p2pfl_tpu_torch.exceptions import SecAggError
        from p2pfl_tpu_torch.learning import secagg

        st = self._state
        if st.secagg_priv is None or len(args) < 4 or (len(args) - 1) % 3 != 0:
            return
        if st.round is None or round not in (st.round - 1, st.round, st.round + 1):
            # same window discipline as secagg_reveal/_recover, plus one
            # round AHEAD (shares are distributed during TrainStage, where
            # a fast peer can be a round past us); without a window a noisy
            # peer could grow secagg_shares_held unboundedly with
            # fabricated round numbers
            return
        if (round, source) in st.secagg_shares_held:
            return  # gossip redundancy / replay: first delivery latched
        exp = st.experiment_name or ""
        if args[0] != exp:
            return
        if source not in st.secagg_pubs:
            logger.debug(st.addr, f"secagg_share from {source} before its key — ignored")
            return
        # share indices run 1..len(holders) over the SENDER's sorted holder
        # list, and this very message carries that whole list (one triple
        # per holder) — so the index bound comes from the MESSAGE, not from
        # our instantaneous train set. The old cap
        # max(2*len(st.train_set), 1024) mis-scored exactly the r±1 shares
        # this handler accepts: a share arriving for round r+1 BEFORE our
        # train set latches (len=0) fell back to the 1024 floor, so a
        # legitimate index from a >1025-member federation was dropped,
        # while junk indices up to 1024 sailed through a 5-member round.
        n_holders = (len(args) - 1) // 3
        for i in range(1, len(args), 3):
            holder, x_str, ct_hex = args[i], args[i + 1], args[i + 2]
            if holder != st.addr:
                continue
            try:
                x = int(x_str)
                ct = bytes.fromhex(ct_hex)
                key = secagg.dh_share_key(st.secagg_priv, st.secagg_pubs[source][0], exp)
                y = secagg.decrypt_share(ct, key, round, source, st.addr)
            except (ValueError, SecAggError):
                logger.error(st.addr, f"Malformed secagg_share from {source}")
                return
            if not 1 <= x <= n_holders or not 0 <= y < secagg.SHAMIR_PRIME:
                logger.error(st.addr, f"Out-of-range secagg_share from {source} — rejected")
                return
            st.secagg_shares_held[(round, source)] = (x, y)
            return


class SecAggRevealCommand(Command):
    """A share-reveal for a contributor's per-round self-mask seed.

    Args: ``[experiment, owner, x, y_hex]``. ``x == 0`` is the owner's
    DIRECT disclosure (y = b^r itself, only accepted from the owner);
    ``x >= 1`` is a holder revealing its Shamir share. Stored under
    (round, owner, revealer), first value wins — the finalize routine
    reconstructs once ``share_threshold`` distinct x's are present.
    """

    def __init__(self, state: "NodeState") -> None:
        self._state = state

    @staticmethod
    def get_name() -> str:
        return "secagg_reveal"

    def execute(self, source: str, round: int, *args, **kwargs) -> None:  # noqa: A002
        from p2pfl_tpu_torch.learning import secagg

        st = self._state
        if len(args) < 4:
            logger.error(st.addr, f"Malformed secagg_reveal from {source}")
            return
        exp = st.experiment_name or ""
        if args[0] != exp:
            return
        owner = args[1]
        try:
            x = int(args[2])
            y = int(args[3], 16)
        except ValueError:
            logger.error(st.addr, f"Malformed secagg_reveal values from {source}")
            return
        if x < 0 or not 0 <= y < secagg.SHAMIR_PRIME:
            # no fixed upper cap on x: the exact assigned-index check below
            # is the real gate, and any constant cap (the old
            # ``max(2*len(train_set), 1024)``) silently dropped legitimate
            # early shares in federations larger than the constant while
            # the local train set hadn't latched yet
            logger.error(st.addr, f"Out-of-range secagg_reveal from {source} — rejected")
            return
        if x == 0 and (source != owner or y >= (1 << 256)):
            # direct seed disclosures only from the owner, and only
            # seed-sized (an oversized value would blow up _leaf_mask's
            # to_bytes(32) mid-finalize on every node)
            logger.error(st.addr, f"Invalid direct secagg_reveal from {source} — rejected")
            return
        if st.round is None or round not in (st.round - 1, st.round, st.round + 1):
            # one round AHEAD is legitimate: reveals are latched send-once,
            # and a fast peer already finalizing round r+1 broadcasts its
            # direct reveal while we are still resolving round r — dropping
            # it would permanently starve OUR r+1 finalize. st.round None
            # (idle) accepts nothing: fabricated round numbers would
            # otherwise grow secagg_share_reveals without bound (same
            # rationale as SecAggShareCommand's window)
            return
        if x >= 1:
            if round > st.round:
                # the share is for a round whose train set THIS node has
                # not latched yet — judging it against the current round's
                # set would reject legitimate early arrivals (and latch
                # nothing, since reveals are send-once). Stash it;
                # promote_early_reveals re-validates at consume time, once
                # the set for that round is the live one. Bounded: the
                # round window above pins ``round``, and one slot per
                # (round, owner, source) triple.
                if len(st.secagg_early_reveals) < 4 * max(len(st.train_set), 64) ** 2:
                    st.secagg_early_reveals.setdefault((round, owner, source), (x, y))
                return
            # Shamir-share reveals: only train-set members have standing,
            # and each holder's share index is DETERMINED by the sorted
            # holder list (TrainStage zips sorted(peers) with x = 1..n) —
            # enforcing it means a forger cannot inject a bogus point at an
            # unused x and poison every honest node's Lagrange
            # reconstruction into a permanent no-op round
            train = set(st.train_set)
            if source not in train or owner not in train or source == owner:
                logger.debug(st.addr, f"secagg_reveal share from {source} without standing — ignored")
                return
            holders = sorted(m for m in st.train_set if m != owner)
            if source not in holders or x != holders.index(source) + 1:
                logger.error(
                    st.addr,
                    f"secagg_reveal share from {source} with index {x} != its "
                    "assigned share index — rejected (forgery or stale train set)",
                )
                return
        st.secagg_share_reveals.setdefault((round, owner, source), (x, y))


def promote_early_reveals(state: "NodeState") -> None:
    """Re-validate stashed ahead-of-round share reveals against the now-
    latched train set and promote the legitimate ones.

    :class:`SecAggRevealCommand` cannot judge a share for round ``r+1``
    while the node is still in round ``r`` — the holder list (and with it
    every assigned share index) is only determined once ``r+1``'s train
    set latches. Early arrivals are stashed instead; the finalize routine
    (``stages/learning_stages.py``) calls this right before reading
    ``secagg_share_reveals``, so by then ``state.train_set`` IS the set the
    shares were cut against and the same standing + exact-index checks
    apply. Entries for rounds already passed are pruned.
    """
    st = state
    if st.round is None or not st.secagg_early_reveals:
        return
    train = set(st.train_set)
    for key in list(st.secagg_early_reveals):
        r, owner, source = key
        if r < st.round:
            del st.secagg_early_reveals[key]
            continue
        if r > st.round:
            continue  # still early — keep waiting
        x, y = st.secagg_early_reveals.pop(key)
        if source not in train or owner not in train or source == owner:
            logger.debug(st.addr, f"early secagg_reveal from {source} without standing — dropped")
            continue
        holders = sorted(m for m in st.train_set if m != owner)
        if source not in holders or x != holders.index(source) + 1:
            logger.error(
                st.addr,
                f"early secagg_reveal from {source} with index {x} != its "
                "assigned share index — rejected (forgery or stale train set)",
            )
            continue
        st.secagg_share_reveals.setdefault(key, (x, y))


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
    """Peer reports which contributors it has folded in this round.

    Under double masking a peer's coverage naming this node is also the
    earliest safe moment to reveal its own self-mask seed: its masked
    update is folded into the round for good (the reveal stays gated by
    ``secagg.maybe_reveal_self_seed``)."""

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
        from p2pfl_tpu_torch.settings import Settings

        if Settings.SECURE_AGGREGATION and Settings.SECAGG_DOUBLE_MASK and st.addr in args:
            from p2pfl_tpu_torch.learning.secagg import maybe_reveal_self_seed

            maybe_reveal_self_seed(self._node, round)


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
