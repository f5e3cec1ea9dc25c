"""Async-federation commands: update/model push, done/leave/pull verbs
(counterpart of ``p2pfl_tpu/commands/federation.py``).

The async control plane's wire verbs (``federation/workflow.py``):

- ``async_update`` (weights plane) — a node's training update, or a
  regional's merged aggregate, pushed to the next aggregation tier up;
- ``async_model`` (weights plane) — a freshly minted global model pushed
  down the tiers (also the reply to an ``async_pull``);
- ``async_done`` (control plane, TTL-flooded) — a node announcing its
  local update budget is spent, releasing aggregators' drain waits;
- ``async_join`` (control plane, TTL-flooded) — a joiner announcing it
  is ENTERING the running experiment: members fold it into the topology
  on this announcement (mere overlay presence is not membership — a
  monitor connecting mid-run must not be elected aggregator);
- ``async_pull`` (control plane, direct) — a joiner asking its nearest
  aggregator for the current global (the elastic-membership bootstrap);
- ``async_leave`` (control plane, TTL-flooded) — a member announcing a
  GRACEFUL departure: receivers mark it done AND dead, re-deriving the
  topology around the hole immediately instead of waiting a heartbeat
  eviction window.

Both weights handlers drop (never stop the node) on malformed payloads:
an async fleet is long-running by design, and one garbage frame from a
flaky peer must not take an *aggregator* down with it — the sync plane's
stop-on-decode-failure matches its initiator-seeded trust model, not this
one. Drops are loud (``async_decode_fail`` metric + error log). The
``async_pull``/``async_view`` control verbs hold the same contract
(``async_ctl_malformed``): a pull or view carrying a weights payload, a
view missing its member lists, or any frame whose handling raises is
dropped and counted, never allowed to feed the topology derivation or
unwind the serving thread.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

from p2pfl_tpu_torch.commands.command import Command
from p2pfl_tpu_torch.exceptions import AnchorMismatchError, DecodingParamsError, ModelNotMatchingError
from p2pfl_tpu_torch.federation.staleness import xp_mismatch
from p2pfl_tpu_torch.learning.weights import ModelUpdate
from p2pfl_tpu_torch.management.logger import logger

if TYPE_CHECKING:
    from p2pfl_tpu_torch.node import Node


def materialize_or_drop(node: "Node", update: ModelUpdate, cmd: str):
    """Decode a wire payload onto the learner's device, or None (counted +
    logged) when malformed."""
    try:
        if update.params is None:
            update = node.learner.decode_update(update)
        return update
    except (DecodingParamsError, ModelNotMatchingError, AnchorMismatchError) as exc:
        logger.log_comm_metric(node.addr, "async_decode_fail")
        logger.error(node.addr, f"{cmd} decode failed: {exc} — dropped")
        return None


def drain_async_stash(node: "Node", ctx) -> None:
    """Feed every stashed early async_update into the context — the ONE
    drain routine (the workflow's post-install drain and the command
    side's race-close both call it; ``take_async_stash`` pops atomically,
    so each entry is processed exactly once whichever side wins). Entries
    carry their delivering peer so the Byzantine screen attributes a
    stashed poison exactly like a direct delivery."""
    for early, src in node.take_async_stash():
        early = materialize_or_drop(node, early, "async_update(stash)")
        if early is not None:
            ctx.execute_actions(ctx.handle_update(early, source=src))


class AsyncUpdateCommand(Command):
    """A contribution arriving at an aggregation tier → buffer offer."""

    def __init__(self, node: "Node") -> None:
        self._node = node

    @staticmethod
    def get_name() -> str:
        return "async_update"

    def execute(self, source: str, round: int, *args, update: ModelUpdate = None, **kwargs) -> None:  # noqa: A002
        node = self._node
        ctx = node.async_ctx
        if ctx is None:
            if node.learning_active():
                # a fast edge's update beat this aggregator's context
                # creation (it is still in init gossip / topology
                # derivation): stash for the workflow to drain — the async
                # twin of the early-init stash
                node.stash_async_update(update, source)
                logger.log_comm_metric(node.addr, "async_update_stashed")
                # close the install race: if the context landed between our
                # None-read and the stash append, the workflow's one-shot
                # drain may already have run — drain again ourselves
                ctx = node.async_ctx
                if ctx is not None and ctx.accepting:
                    drain_async_stash(node, ctx)
                return
            logger.log_comm_metric(node.addr, "async_update_dropped")
            logger.debug(node.addr, f"async_update from {source} with no async context — dropped")
            return
        if not ctx.accepting:
            logger.log_comm_metric(node.addr, "async_update_dropped")
            return
        update = materialize_or_drop(node, update, "async_update")
        if update is None:
            return
        # handlers run on whatever thread delivered the message; the
        # context computes under its locks and returns the sends, which
        # run here OUTSIDE every lock (deadlock contract — workflow docs).
        # source rides along for the Byzantine screen's attribution: a
        # poisoned payload indicts its DELIVERER, not the (attacker-
        # controlled) origin named in its version triple
        ctx.execute_actions(ctx.handle_update(update, source=source))


class AsyncModelCommand(Command):
    """A fresh global model pushed down a tier → adopt + forward."""

    def __init__(self, node: "Node") -> None:
        self._node = node

    @staticmethod
    def get_name() -> str:
        return "async_model"

    def execute(self, source: str, round: int, *args, update: ModelUpdate = None, **kwargs) -> None:  # noqa: A002
        node = self._node
        ctx = node.async_ctx
        if ctx is None or not ctx.accepting:
            logger.log_comm_metric(node.addr, "async_model_dropped")
            return
        update = materialize_or_drop(node, update, "async_model")
        if update is None:
            return
        ctx.execute_actions(ctx.handle_model(update, source))


class AsyncDoneCommand(Command):
    """Peer spent its local update budget (TTL-flooded announcement)."""

    def __init__(self, state) -> None:  # NodeState
        self._state = state

    @staticmethod
    def get_name() -> str:
        return "async_done"

    def execute(self, source: str, round: int, *args, **kwargs) -> None:  # noqa: A002
        st = self._state
        # experiment-identity gate: a slow peer's done broadcast from the
        # PREVIOUS experiment (TTL-relayed duplicate landing after our
        # set_experiment) must not pre-mark it done for THIS one — the
        # drain would skip the window that merges its tail. Frames
        # without the header fall back to the set-reset at experiment
        # boundaries alone.
        if xp_mismatch(st.addr, kwargs.get("xp"), st.experiment_xid):
            return
        # monotone set-union under the same merge lock as the other
        # control-plane lattices; cleared at experiment boundaries
        with st.status_merge_lock:
            st.async_done_peers.add(source)


class AsyncJoinCommand(Command):
    """A joiner announced itself: membership grows, topology re-derives."""

    def __init__(self, node: "Node") -> None:
        self._node = node

    @staticmethod
    def get_name() -> str:
        return "async_join"

    def execute(self, source: str, round: int, *args, **kwargs) -> None:  # noqa: A002
        node = self._node
        ctx = node.async_ctx
        if ctx is None or not ctx.accepting:
            return
        if xp_mismatch(node.addr, kwargs.get("xp"), node.state.experiment_xid):
            return
        ctx.execute_actions(ctx.add_member(source))
        if ctx.accepting and ctx.take_stash_dirty():
            drain_async_stash(node, ctx)


class AsyncPullCommand(Command):
    """A joiner's bootstrap request: push it the current global."""

    def __init__(self, node: "Node") -> None:
        self._node = node

    @staticmethod
    def get_name() -> str:
        return "async_pull"

    def execute(self, source: str, round: int, *args, **kwargs) -> None:  # noqa: A002
        node = self._node
        if kwargs.get("update") is not None:
            # a weights frame hijacking a control verb (fuzzed/garbage
            # wire input): drop loudly — parity with async_update's
            # decode-or-drop, a long-running fleet must absorb it
            logger.log_comm_metric(node.addr, "async_ctl_malformed")
            logger.error(
                node.addr,
                f"async_pull from {source} carried a weights payload — dropped",
            )
            return
        try:
            self._serve(source)
        except Exception as exc:  # noqa: BLE001 — one garbage frame must not kill a serving node
            logger.log_comm_metric(node.addr, "async_ctl_malformed")
            logger.error(node.addr, f"async_pull from {source} failed: {exc!r} — dropped")

    def _serve(self, source: str) -> None:
        node = self._node
        ctx = node.async_ctx
        if ctx is not None and ctx.accepting:
            logger.log_comm_metric(node.addr, "async_pull_served")
            # ship our (members, dead) view alongside the global: the
            # puller (a joiner) derives its topology from a live overlay
            # view that lacks the dead members everyone else keeps as
            # cluster holes — without the merge its chunking would
            # diverge from the fleet's for the rest of the run
            members, dead = ctx.view_snapshot()
            node.protocol.send(
                source,
                node.protocol.build_msg("async_view", [";".join(members), ";".join(dead)]),
                create_connection=True,
            )
            ctx.execute_actions(ctx.bootstrap_reply(source))
            return
        # the workflow already exited: serve the finished experiment's
        # canonical result (a peer's EXIT pull — its every inbound push
        # targeted a corpse — may arrive after our teardown; exit timing
        # across the fleet is jittered by per-node eviction clocks)
        last = node._last_async_global
        if last is not None:
            params, version, xid = last
            upd = ModelUpdate(params, [node.addr], 1)
            upd.version = (node.addr, version, version)
            upd.xp = xid
            env = node.protocol.build_weights("async_model", version, upd)
            node.protocol.send(source, env, create_connection=True)
            logger.log_comm_metric(node.addr, "async_pull_served")
            return
        logger.log_comm_metric(node.addr, "async_pull_dropped")


class AsyncViewCommand(Command):
    """A peer's (members, dead) membership view — merged monotonically."""

    def __init__(self, node: "Node") -> None:
        self._node = node

    @staticmethod
    def get_name() -> str:
        return "async_view"

    def execute(self, source: str, round: int, *args, **kwargs) -> None:  # noqa: A002
        node = self._node
        if kwargs.get("update") is not None or len(args) < 2:
            # missing member/dead lists, or a weights frame hijacking the
            # verb: a malformed view must not feed the topology derivation
            # (and must not kill the node) — drop loudly, parity with
            # async_update's decode-or-drop
            logger.log_comm_metric(node.addr, "async_ctl_malformed")
            logger.error(node.addr, f"malformed async_view from {source} — dropped")
            return
        ctx = node.async_ctx
        if ctx is None or not ctx.accepting:
            return
        if xp_mismatch(node.addr, kwargs.get("xp"), node.state.experiment_xid):
            return
        try:
            members = [m for m in str(args[0]).split(";") if m]
            dead = [d for d in str(args[1]).split(";") if d]
            ctx.execute_actions(ctx.merge_view(members, dead))
        except Exception as exc:  # noqa: BLE001 — one garbage frame must not kill a serving node
            logger.log_comm_metric(node.addr, "async_ctl_malformed")
            logger.error(node.addr, f"async_view from {source} failed: {exc!r} — dropped")
            return
        if ctx.accepting and ctx.take_stash_dirty():
            drain_async_stash(node, ctx)


class AsyncLeaveCommand(Command):
    """A member left gracefully: done + dead in one announcement."""

    def __init__(self, node: "Node") -> None:
        self._node = node

    @staticmethod
    def get_name() -> str:
        return "async_leave"

    def execute(self, source: str, round: int, *args, **kwargs) -> None:  # noqa: A002
        node = self._node
        st = node.state
        if xp_mismatch(st.addr, kwargs.get("xp"), st.experiment_xid):
            return
        with st.status_merge_lock:
            st.async_done_peers.add(source)
        ctx = node.async_ctx
        if ctx is None or not ctx.accepting:
            return
        # same membership event as an eviction, minus the detection
        # latency (the leaver TOLD us); may promote this node / fire the
        # flush the leaver's contributions were part of
        ctx.execute_actions(ctx.mark_dead(source, reason="left"))
        if ctx.accepting and ctx.take_stash_dirty():
            drain_async_stash(node, ctx)
