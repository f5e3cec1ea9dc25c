"""The transport seam: ``CommunicationProtocol`` (counterpart of ``p2pfl_tpu/communication/protocol.py``).

Same 12-operation surface as the reference ABC
(``p2pfl/communication/communication_protocol.py:27-190``), so transports are
interchangeable per node. Unlike the reference — where the gRPC and memory
protocol classes duplicate their wiring byte-for-byte
(``memory_communication_protocol.py:47-66``) — the shared wiring (gossiper,
heartbeater, command registry, dispatch with TTL re-gossip and dedup) lives
here once, and concrete transports only provide a server, a client and a
neighbors manager.
"""

from __future__ import annotations

import contextlib
import random
import threading
from abc import ABC, abstractmethod
from typing import TYPE_CHECKING, Callable, Optional

from p2pfl_tpu_torch.communication.gossiper import Gossiper
from p2pfl_tpu_torch.communication.heartbeater import Heartbeater
from p2pfl_tpu_torch.communication.message import CommandResult, Message, WeightsEnvelope
from p2pfl_tpu_torch.communication.neighbors import Neighbors
from p2pfl_tpu_torch.communication.reliability import CircuitBreaker
from p2pfl_tpu_torch.learning.weights import ModelUpdate
from p2pfl_tpu_torch.management.logger import logger
from p2pfl_tpu_torch.management.telemetry import telemetry

if TYPE_CHECKING:
    import torch


class CommunicationProtocol(ABC):
    """Base for all transports. Owns gossip, heartbeat, membership, dispatch."""

    def __init__(self, address: str) -> None:
        self._address = address
        self._commands: dict[str, "Command"] = {}  # noqa: F821 — commands registered by Node
        self._terminated = threading.Event()
        #: per-neighbor consecutive-failure detector; every plane's send
        #: outcome feeds it, suspects are evicted early by the heartbeater
        self.breaker = CircuitBreaker(address)
        #: optional chaos seam (communication/faults.py FaultInjector):
        #: when set, every outgoing send routes through it with the real
        #: transport send as the continuation
        self.fault_injector: Optional[Callable] = None
        #: callbacks fired with the address of every heartbeat-evicted
        #: neighbor (Node hooks mid-round train-set repair here)
        self._evict_listeners: list[Callable[[str], None]] = []
        #: current experiment identity (set by the workflows from
        #: NodeState.experiment_xid): stamped as the optional "xp" header
        #: on every outgoing envelope so receivers can filter
        #: cross-experiment stragglers exactly. Deliberately NOT cleared
        #: at experiment end — a tail frame between experiments carrying
        #: the OLD id is precisely what the filter exists to reject.
        self.experiment_xid: Optional[str] = None
        #: the device a streamed weights transfer decodes onto: the Node
        #: points it at its learner's device (several nodes of one process
        #: may sit on different slots); None decodes onto the CPU
        self.receive_device: Callable[[], Optional["torch.device"]] = lambda: None
        self.neighbors: Neighbors = self._make_neighbors()
        self.neighbors.on_evict = self._neighbor_evicted
        self.gossiper = Gossiper(
            address, send_fn=self._do_send, on_result=self._record_send_outcome
        )
        self.heartbeater = Heartbeater(address, self)

    # ---- transport-specific pieces ----

    @abstractmethod
    def _make_neighbors(self) -> Neighbors:
        ...

    @abstractmethod
    def _server_start(self) -> None:
        ...

    @abstractmethod
    def _server_stop(self) -> None:
        ...

    @abstractmethod
    def _send_to_neighbor(self, nei: str, env, create_connection: bool = False) -> bool:
        """Deliver one envelope to one peer. Returns False on failure."""

    # ---- lifecycle ----

    def start(self) -> None:
        self._terminated.clear()
        self._server_start()
        self.heartbeater.start()
        self.gossiper.start()

    def stop(self) -> None:
        self.heartbeater.stop()
        self.gossiper.stop()
        self._server_stop()
        self.neighbors.clear(disconnect=True)
        self.breaker.reset()
        self._terminated.set()

    def wait_for_termination(self) -> None:
        self._terminated.wait()

    # ---- command registry ----

    def add_command(self, cmd) -> None:
        self._commands[cmd.get_name()] = cmd

    # ---- message construction ----

    def build_msg(self, cmd: str, args: Optional[list[str]] = None, round: int = -1) -> Message:
        from p2pfl_tpu_torch.settings import Settings

        # flight recorder: outgoing envelopes are stamped with the BUILDING
        # thread's trace context (usually a stage span on the learning
        # thread) — the seam where causality is still known; the worker
        # threads that later transmit the envelope have no context of
        # their own, and the same Message object is shared across a whole
        # broadcast, so per-send mutation would race
        return Message(
            self._address,
            cmd,
            tuple(args or ()),
            round,
            ttl=Settings.TTL,
            trace_ctx=telemetry.current_ctx(),
            xp=self.experiment_xid,
        )

    def build_weights(
        self, cmd: str, round: int, update: ModelUpdate
    ) -> WeightsEnvelope:
        # experiment identity rides both the envelope and the update (the
        # update is what stash filters hold after decode); one update may
        # be shared across a broadcast — identical stamp, benign
        if update.xp is None and self.experiment_xid is not None:
            update.xp = self.experiment_xid
        # the round completes the payload-cache key (learning/weights.py):
        # byte transports then reuse the encode across candidates and ticks
        # for as long as the learner's model version is unchanged
        update.cache_round = round
        # shard-plane handshake: when the ICI weights plane is on, every
        # weights frame advertises this node's slice topology ("sp",
        # communication/ici.py)
        from p2pfl_tpu_torch.communication.ici import stamp_handshake

        stamp_handshake(self._address, update)
        return WeightsEnvelope(
            self._address, round, cmd, update, trace_ctx=telemetry.current_ctx(),
            xp=update.xp or self.experiment_xid,
        )

    # ---- sending ----

    def _do_send(self, nei: str, env, create_connection: bool = False) -> bool:
        """Transport send behind the fault-injection seam — EVERY outgoing
        envelope (both gossip planes, direct sends, broadcasts) passes
        through here, so a chaos plan sees all of them — and behind the
        flight recorder's send span: one ``send:<cmd>`` span per attempt,
        parented to the envelope's wire trace context, with the outcome
        and peer in its attrs (the RoundReport's edge attribution reads
        exactly these). Beats are span-exempt by default
        (``Settings.TELEMETRY_BEAT_SPANS``) — they flood at
        1/HEARTBEAT_PERIOD per neighbor and would drown the ring."""
        from p2pfl_tpu_torch.settings import Settings

        cmd = getattr(env, "cmd", "?")
        if not telemetry.enabled() or (
            cmd == "beat" and not Settings.TELEMETRY_BEAT_SPANS
        ):
            return self._transport_send(nei, env, create_connection)
        is_weights = isinstance(env, WeightsEnvelope)
        with telemetry.span(
            self._address,
            f"send:{cmd}",
            kind="heartbeat" if cmd == "beat" else "gossip",
            parent=getattr(env, "trace_ctx", None),
            attrs={"peer": nei, "plane": "weights" if is_weights else "control"},
        ) as sp:
            ok = self._transport_send(nei, env, create_connection)
            if sp is not None:
                sp.attrs["ok"] = bool(ok)
        return ok

    def _transport_send(self, nei: str, env, create_connection: bool) -> bool:
        fi = self.fault_injector
        if fi is not None:
            return fi(nei, env, create_connection, self._send_to_neighbor)
        return self._send_to_neighbor(nei, env, create_connection=create_connection)

    def send(self, nei: str, env, create_connection: bool = False) -> bool:
        ok = self._do_send(nei, env, create_connection=create_connection)
        if not create_connection:
            self._record_send_outcome(nei, ok)
            if not ok and isinstance(env, Message):
                # counted separately from the gossiper's gossip_send_fail:
                # direct sends (command broadcasts, coverage re-announcements)
                # fail outside the dispatch path — without this metric a
                # retry scheduled here has no matching failure counter and
                # the chaos suite's "retries are 1:1-backed by failures"
                # budget would be unsound (e.g. sends to a crashed peer in
                # the window before its eviction)
                logger.log_comm_metric(self._address, "send_fail_direct")
                # The reference evicts a neighbor on ANY send failure
                # (grpc_client.py:173-179) — and the message is simply gone.
                # One transient failure is not death: the message is retried
                # with backoff on the gossip thread (schedule_retry exempts
                # beats), while the breaker's consecutive-failure count
                # decides suspicion and the heartbeater owns the
                # (accelerated) eviction.
                self.gossiper.schedule_retry(nei, env, attempt=1)
        return ok

    def broadcast(self, env, exclude: tuple[str, ...] = ()) -> None:
        for nei in self.neighbors.get_all(only_direct=True):
            if nei not in exclude:
                self.send(nei, env)

    def _record_send_outcome(self, nei: str, ok: bool) -> None:
        """Feed the breaker — but never for failures to NON-members: an
        in-flight backoff retry to an already-evicted neighbor would
        otherwise repopulate the state ``forget()`` just cleared, leaving a
        permanent suspect entry no eviction sweep ever forgets (the sweeps
        only touch current members)."""
        if ok or self.neighbors.get(nei) is not None:
            self.breaker.record(nei, ok)

    # ---- eviction notifications ----

    def add_evict_listener(self, fn: Callable[[str], None]) -> None:
        self._evict_listeners.append(fn)

    def _neighbor_evicted(self, addr: str) -> None:
        logger.log_comm_metric(self._address, "neighbor_evicted")
        # eviction transition on the flight-recorder timeline: every
        # eviction path (stale beats, breaker suspect fast path, one-way
        # partition) funnels through here
        telemetry.event(
            self._address, "neighbor_evicted", kind="fault", attrs={"peer": addr}
        )
        self.breaker.forget(addr)
        for fn in self._evict_listeners:
            try:
                fn(addr)
            except Exception as exc:  # noqa: BLE001 — listeners must not kill the heartbeater
                logger.error(self._address, f"Evict listener failed for {addr}: {exc!r}")

    # ---- membership ----

    def connect(self, addr: str, non_direct: bool = False) -> bool:
        return self.neighbors.add(addr, non_direct=non_direct)

    def disconnect(self, addr: str, disconnect_msg: bool = True) -> None:
        self.breaker.forget(addr)  # deliberate disconnect is not a failure
        self.neighbors.remove(addr, disconnect_msg=disconnect_msg)

    def get_neighbors(self, only_direct: bool = False) -> dict:
        return self.neighbors.get_all(only_direct)

    def get_address(self) -> str:
        return self._address

    # ---- model-plane gossip (synchronous loop used by stages) ----

    def gossip_weights(
        self,
        early_stopping_fn: Callable[[], bool],
        get_candidates_fn: Callable[[], list[str]],
        status_fn: Callable[[], object],
        model_fn: Callable[[str], Optional[tuple]],
        period: Optional[float] = None,
        create_connection: bool = False,
    ) -> None:
        self.gossiper.gossip_weights(
            early_stopping_fn,
            get_candidates_fn,
            status_fn,
            model_fn,
            period=period,
            create_connection=create_connection,
        )

    # ---- receive path (called by transport servers) ----

    def handle_message(self, msg: Message) -> CommandResult:
        """Control-plane receive: dedup → TTL re-gossip → dispatch.

        Mirrors ``grpc_server.py:130-166``.
        """
        if not self.gossiper.check_and_set_processed(msg.msg_id):
            return CommandResult(ok=True)  # duplicate — already handled
        if msg.ttl > 1:
            # the relay keeps the ORIGIN's trace context: every hop of a
            # TTL flood stays one causal tree rooted at the first sender
            relay = Message(
                msg.source, msg.cmd, msg.args, msg.round, msg.ttl - 1, msg.msg_id,
                trace_ctx=msg.trace_ctx, xp=msg.xp,
            )
            pending = [n for n in self.neighbors.get_all(only_direct=True) if n != msg.source]
            self.gossiper.add_message(relay, pending)
        return self._dispatch(
            msg.cmd, msg.source, msg.round, list(msg.args), None,
            trace_ctx=msg.trace_ctx, xp=msg.xp,
        )

    def handle_weights(self, env: WeightsEnvelope) -> CommandResult:
        """Data-plane receive: direct dispatch, no TTL/dedup (``grpc_server.py:168-197``)."""
        return self._dispatch(
            env.cmd, env.source, env.round, [], env.update,
            trace_ctx=env.trace_ctx, xp=env.xp or env.update.xp,
        )

    def handle_weights_stream(self, env: WeightsEnvelope, chunks) -> CommandResult:
        """Streaming data-plane receive: feed ``P2TC`` chunks into a
        :class:`~p2pfl_tpu_torch.learning.weights.StreamDecoder`, then
        dispatch exactly like :meth:`handle_weights`.

        ``env`` is the stream's payload-free header envelope; ``chunks``
        iterates framed chunks as they arrive (off the wire or out of the
        memory transport's bounded queue). Leaves are decoded onto
        :attr:`receive_device` as their bytes complete, so the unary frame
        never exists on this side. Any violation mid-stream (a chunk's CRC,
        order, truncation, the total CRC) drops the WHOLE transfer as one
        failed receive, so the sender's breakers, retries and fault
        verdicts see one failed send, as for a unary transfer.
        """
        from p2pfl_tpu_torch.learning.weights import StreamDecoder
        from p2pfl_tpu_torch.settings import Settings

        if not Settings.WIRE_STREAM_ENABLED:
            # the sender matches this exact error and retries as unary
            return CommandResult(ok=False, error="stream-unsupported")
        dec = StreamDecoder(device=self.receive_device())
        try:
            for frame in chunks:
                dec.feed(frame)
            if not dec.complete:
                raise ValueError("stream ended before its end chunk")
            if dec.reassembled:
                # a delta-coded (tk8) stream: the unary frame, decoded by
                # the learner against its anchor
                env.update.encoded = dec.result_payload()
            else:
                env.update.decoded_flat = dec.result_flat()
                env.update.encoded = None
        except Exception as exc:  # noqa: BLE001 — one bad chunk = one failed transfer
            logger.log_comm_metric(self._address, "stream_recv_drop")
            logger.error(self._address, f"Dropping weights stream from {env.source}: {exc}")
            return CommandResult(ok=False, error=f"stream aborted: {exc}")
        logger.log_comm_metric(self._address, "stream_recv")
        logger.log_comm_metric(self._address, "stream_recv_chunks", dec.chunks)
        return self.handle_weights(env)

    def _dispatch(
        self,
        cmd: str,
        source: str,
        round: int,
        args: list[str],
        update: Optional[ModelUpdate],
        trace_ctx: Optional[tuple[str, str]] = None,
        xp: Optional[str] = None,
    ) -> CommandResult:
        from p2pfl_tpu_torch.settings import Settings

        if cmd != "beat" or not Settings.EXCLUDE_BEAT_LOGS:
            # beat floods at 1/HEARTBEAT_PERIOD per neighbor — excluded from
            # logs by default, same knob as the reference
            logger.debug(self._address, f"Received '{cmd}' from {source}")
        handler = self._commands.get(cmd)
        if handler is None:
            logger.error(self._address, f"Unknown command '{cmd}' from {source}")
            return CommandResult(ok=False, error=f"unknown command {cmd}")
        # the receiver's half of the wire-propagated causal edge: a
        # recv:<cmd> span parented to the SENDER's span via trace_ctx, so
        # the round's tree crosses nodes; beats span-exempt as on send
        if cmd != "beat" or Settings.TELEMETRY_BEAT_SPANS:
            span_cm = telemetry.span(
                self._address,
                f"recv:{cmd}",
                kind="heartbeat" if cmd == "beat" else "gossip",
                parent=trace_ctx,
                attrs={"src": source, "round": round},
            )
        else:
            span_cm = contextlib.nullcontext()
        try:
            with span_cm:
                # xp: the frame's experiment identity (optional — None on
                # old/sync frames); commands that gate on experiment
                # boundaries read it from kwargs
                if update is not None:
                    handler.execute(source, round, update=update, xp=xp)
                else:
                    handler.execute(source, round, *args, xp=xp)
            return CommandResult(ok=True)
        except Exception as exc:  # noqa: BLE001 — commands must not kill the server thread
            logger.error(self._address, f"Error executing {cmd} from {source}: {exc!r}")
            return CommandResult(ok=False, error=str(exc))


def random_subset(items: list[str], k: int) -> list[str]:
    """k random picks without replacement (gossip target selection)."""
    if len(items) <= k:
        return list(items)
    return random.sample(items, k)
