"""In-process transport: N nodes in one process without sockets.

Counterpart of ``p2pfl_tpu/communication/memory.py``: a process-global
registry maps address → protocol instance and "sending" is a direct
method call on the receiver. Weights are passed by reference as a live
:class:`ModelUpdate`, so a simulated federation never serializes;
``Settings.MEMORY_WIRE_CODEC=True`` opts back into the byte path (the
payload is encoded on send, through the encode-once cache, and decoded by
the receiving learner, as on a network transport), and payloads at or
above ``WIRE_STREAM_THRESHOLD`` stream as P2TC chunks through a bounded
queue. Delivery goes through the same
:meth:`CommunicationProtocol.handle_message` / :meth:`handle_weights`
dispatch as every transport.

With ``Settings.WEIGHTS_PLANE="ici"`` a weights envelope first goes to
the shard plane (:func:`~p2pfl_tpu_torch.communication.ici.try_shard_send`)
from inside :meth:`InMemoryProtocol._send_to_neighbor`, so the fault
injector, send spans and breaker feeds of the ``_do_send`` seam wrap an
ICI transfer unchanged.
"""

from __future__ import annotations

import itertools
import threading
from typing import Optional

from p2pfl_tpu_torch.communication.message import Message, WeightsEnvelope
from p2pfl_tpu_torch.communication.neighbors import Neighbors
from p2pfl_tpu_torch.communication.protocol import CommunicationProtocol
from p2pfl_tpu_torch.exceptions import NeighborNotConnectedError


class MemoryRegistry:
    """Process-global address → running protocol map."""

    _lock = threading.Lock()
    _servers: dict[str, "InMemoryProtocol"] = {}
    _counter = itertools.count(1)

    @classmethod
    def register(cls, addr: str, proto: "InMemoryProtocol") -> None:
        with cls._lock:
            cls._servers[addr] = proto

    @classmethod
    def unregister(cls, addr: str) -> None:
        with cls._lock:
            cls._servers.pop(addr, None)

    @classmethod
    def get(cls, addr: str) -> Optional["InMemoryProtocol"]:
        with cls._lock:
            return cls._servers.get(addr)

    @classmethod
    def next_address(cls) -> str:
        with cls._lock:
            return f"node-{next(cls._counter)}"

    @classmethod
    def reset(cls) -> None:
        with cls._lock:
            cls._servers.clear()
            cls._counter = itertools.count(1)


class InMemoryNeighbors(Neighbors):
    def _connect(self, addr: str, handshake: bool):
        peer = MemoryRegistry.get(addr)
        if peer is None:
            raise NeighborNotConnectedError(f"no in-memory server at {addr}")
        if handshake:
            peer.handshake(self.self_addr)
        return peer

    def _disconnect(self, addr: str, conn, notify: bool) -> None:
        peer = MemoryRegistry.get(addr)
        if peer is not None and notify:
            peer.peer_disconnected(self.self_addr)


class InMemoryProtocol(CommunicationProtocol):
    """N simulated nodes in one process; delivery is a direct method call."""

    def __init__(self, address: Optional[str] = None) -> None:
        super().__init__(address or MemoryRegistry.next_address())
        self._running = False

    # ---- transport pieces ----

    def _make_neighbors(self) -> Neighbors:
        return InMemoryNeighbors(self._address)

    def _server_start(self) -> None:
        MemoryRegistry.register(self._address, self)
        self._running = True

    def _server_stop(self) -> None:
        self._running = False
        MemoryRegistry.unregister(self._address)

    def crash(self) -> None:
        """Hard crash: vanish from the registry with no disconnect
        notifications; peers find out through send failures and silence."""
        self._server_stop()

    def _send_to_neighbor(self, nei: str, env, create_connection: bool = False) -> bool:
        info = self.neighbors.get(nei)
        if info is None or not info.direct:
            if not create_connection:
                return False
        peer = MemoryRegistry.get(nei)
        if peer is None or not peer._running:
            return False
        try:
            if isinstance(env, WeightsEnvelope):
                from p2pfl_tpu_torch.communication.ici import try_shard_send

                handled = try_shard_send(self, nei, env)
                if handled is not None:
                    return handled
                from p2pfl_tpu_torch.settings import Settings

                if Settings.MEMORY_WIRE_CODEC and env.update.params is not None:
                    # the byte path without sockets: every optional header
                    # of wire_headers.py must ride this re-wrap, or
                    # simulations diverge from the network transports
                    from p2pfl_tpu_torch.learning.weights import estimate_payload_bytes

                    est = estimate_payload_bytes(env.update)
                    if (
                        Settings.WIRE_STREAM_ENABLED
                        and est is not None
                        and est >= Settings.WIRE_STREAM_THRESHOLD * 1024 * 1024
                    ):
                        return self._stream_to_peer(peer, env)
                    env = _wire_envelope(env, env.update.encode())
                return peer.handle_weights(env).ok
            if isinstance(env, Message):
                return peer.handle_message(env).ok
        except Exception:  # noqa: BLE001 — peer died mid-call
            return False
        return False

    def _stream_to_peer(self, peer: "InMemoryProtocol", env: WeightsEnvelope) -> bool:
        """The streaming byte path without sockets: a producer thread pumps
        the chunk frames through a queue of ``Settings.WIRE_STREAM_WINDOW``
        frames while the receiver's incremental decoder drains it, so at
        most window x chunk bytes are in flight. A receiver-side abort is
        this ONE send returning False, as on gRPC."""
        import queue

        from p2pfl_tpu_torch.settings import Settings

        try:
            chunks = env.update.iter_chunks()
        except Exception:  # noqa: BLE001 — encode trouble = failed send
            return False
        wire_env = _wire_envelope(env, None)
        q: "queue.Queue" = queue.Queue(maxsize=max(1, Settings.WIRE_STREAM_WINDOW))
        abort = threading.Event()  # set when the receiver stops draining

        def _put(item) -> bool:
            while not abort.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    continue
            return False

        def _produce() -> None:
            for c in chunks:
                if not _put(c):
                    return
            _put(None)

        producer = threading.Thread(target=_produce, daemon=True, name="stream-pump")
        producer.start()

        def _drain():
            while True:
                c = q.get()
                if c is None:
                    return
                yield c

        try:
            return peer.handle_weights_stream(wire_env, _drain()).ok
        finally:
            abort.set()
            producer.join(timeout=5)

    # ---- server-side entry points (called by peers) ----

    def handshake(self, source: str) -> None:
        """Reverse direct edge, no handshake back."""
        if self._running:
            self.neighbors.add(source, non_direct=False, handshake=False)

    def peer_disconnected(self, source: str) -> None:
        if self._running:
            self.neighbors.remove(source)


def _wire_envelope(env: WeightsEnvelope, encoded: Optional[bytes]) -> WeightsEnvelope:
    """``env`` as a byte transport delivers it: the update without params,
    carrying ``encoded`` (None for a stream's header envelope) and every
    optional header key (``version``, ``xp``, ``sp``, ``trace_ctx``)."""
    from p2pfl_tpu_torch.learning.weights import ModelUpdate

    wire = ModelUpdate(
        params=None,
        contributors=list(env.update.contributors),
        num_samples=env.update.num_samples,
        encoded=encoded,
        version=env.update.version,
        xp=env.update.xp,
        sp=env.update.sp,
    )
    return WeightsEnvelope(
        env.source, env.round, env.cmd, wire, env.msg_id, trace_ctx=env.trace_ctx, xp=env.xp,
    )
