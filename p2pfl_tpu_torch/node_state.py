"""Per-node mutable learning state (counterpart of ``p2pfl_tpu/node_state.py``).

The reference's four lock-latches are real :class:`threading.Event`
objects here, as in the JAX package.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional


class NodeState:
    def __init__(self, addr: str, simulation: bool = False) -> None:
        self.addr = addr
        self.simulation = simulation
        self.status = "Idle"
        self.experiment_name: Optional[str] = None
        #: fleet-wide experiment identity, minted by the start_learning
        #: initiator and stamped on every frame as ``xp``
        self.experiment_xid: Optional[str] = None
        self.round: Optional[int] = None
        self.total_rounds: Optional[int] = None
        self.learner: Optional[Any] = None

        # addr -> list of contributors that addr has already aggregated
        self.models_aggregated: Dict[str, List[str]] = {}
        # addr -> last round that addr reported finishing (-1 = model init'd)
        self.nei_status: Dict[str, int] = {}

        self.train_set: List[str] = []
        # members evicted mid-round (Node._on_peer_evicted): train_set stays
        # the full elected set (the aggregator still accepts an evicted
        # member's contributions that reached peers); gossip targeting
        # subtracts this set. Writers replace it, never mutate it.
        self.train_set_evicted: set = set()
        self.train_set_votes: Dict[str, Dict[str, int]] = {}

        # secure aggregation (learning/secagg.py): this node's DH private key
        # for the experiment and peers' announced (public key, sample count),
        # the first announcement per peer latched (SecAggPubCommand)
        self.secagg_priv: Optional[int] = None
        self.secagg_pubs: Dict[str, tuple] = {}
        # the sample count THIS node announced: masking must use exactly it
        self.secagg_samples: Optional[int] = None
        # dropout recovery: (round, dropped, survivor) -> the pair seed the
        # survivor re-disclosed (secagg_recover)
        self.secagg_disclosed: Dict[tuple, int] = {}
        # (round, dropped) (and (round, dropped, requester)) this node
        # already disclosed its seed for
        self.secagg_disclosure_sent: set = set()
        # double masking: round -> this node's self-mask seed b_i^r
        self.secagg_self_seed: Dict[int, int] = {}
        # (round, owner) -> this node's decrypted Shamir share (x, y)
        self.secagg_shares_held: Dict[tuple, tuple] = {}
        # (round, owner, revealer) -> revealed (x, y); x == 0 is the owner's
        # direct disclosure of its seed
        self.secagg_share_reveals: Dict[tuple, tuple] = {}
        # share reveals for a round ahead of this node's, re-validated by
        # commands/control.py::promote_early_reveals once its set latches
        self.secagg_early_reveals: Dict[tuple, tuple] = {}
        # (round, owner) reveals THIS node already broadcast
        self.secagg_reveal_sent: set = set()
        # (round, addr) treated as dropped this round: never help rebuild
        # the self seed of a node whose pair seeds may have been disclosed
        self.secagg_round_dropped: set = set()

        # async federation: peers that announced their local budget spent
        # (async_done, TTL-flooded), releasing aggregators' drain waits;
        # union-merged under status_merge_lock
        self.async_done_peers: set = set()

        # counts experiments entered: tells "never started" from "finished"
        self.experiment_epoch = 0
        self.last_transition: Optional[float] = None
        self.current_stage: str = ""

        # train_set has two writers (the vote tally on the learning thread,
        # mid-round repair on the heartbeater): both take this lock
        self.train_set_lock = threading.Lock()
        # serializes the control handlers' monotone merges of
        # models_aggregated / nei_status
        self.status_merge_lock = threading.Lock()
        self.train_set_votes_lock = threading.Lock()
        self.start_thread_lock = threading.Lock()
        self.votes_ready_event = threading.Event()
        self.model_initialized_event = threading.Event()

    def set_experiment(self, exp_name: str, total_rounds: int, xid: Optional[str] = None) -> None:
        """Enter learning mode."""
        self.status = "Learning"
        self.experiment_name = exp_name
        self.experiment_xid = xid
        self.total_rounds = total_rounds
        self.round = 0
        self.experiment_epoch += 1
        # a late async_done of the previous experiment must not mark its
        # sender done in this one
        with self.status_merge_lock:
            self.async_done_peers = set()

    def increase_round(self) -> None:
        """Advance the round; clears per-round caches. The round is bumped
        BEFORE models_aggregated is replaced (ModelsAggregatedCommand
        relies on that order)."""
        if self.round is None:
            raise ValueError("round not initialized")
        self.round += 1
        self.models_aggregated = {}

    def clear(self) -> None:
        """Back to idle."""
        self.status = "Idle"
        self.experiment_name = None
        self.experiment_xid = None
        self.round = None
        self.total_rounds = None
        self.models_aggregated = {}
        self.nei_status = {}
        with self.train_set_lock:
            self.train_set = []
            self.train_set_evicted = set()
        self.train_set_votes = {}
        self.secagg_priv = None
        self.secagg_pubs = {}
        self.secagg_samples = None
        self.secagg_disclosed = {}
        self.secagg_disclosure_sent = set()
        self.secagg_self_seed = {}
        self.secagg_shares_held = {}
        self.secagg_share_reveals = {}
        self.secagg_early_reveals = {}
        self.secagg_reveal_sent = set()
        self.secagg_round_dropped = set()
        with self.status_merge_lock:
            self.async_done_peers = set()
        self.votes_ready_event.clear()
        self.model_initialized_event.clear()
