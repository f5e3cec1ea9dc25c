"""Real-network transport over gRPC (counterpart of
``p2pfl_tpu/communication/grpc_transport.py``).

The semantics are the reference's proto service: four unary RPCs,
``handshake``, ``disconnect``, ``send_message``, ``send_weights``, over
insecure channels, control messages TTL-flooded with dedup, weight
payloads point to point, plus the client-streaming
``send_weights_stream`` for large payloads (P2TC chunks). The service uses
gRPC *generic handlers* over raw bytes with the compact envelope codec
(a JSON header and the P2TW weights bytes of ``learning/weights.py``,
byte layout in ``proto/node.proto``), the same frames as the JAX package,
so a JAX node and a port node federate over one socket.

Interop: ``Settings.WIRE_FORMAT="protobuf"`` switches outgoing frames to
the reference's protobuf schema (``proto_wire.py``) and dials the
reference's method paths ``/node.NodeServices/*``. The server registers
that prefix and the native ``/p2pfl.NodeServices/`` one, and every entry
point sniffs the frame format, so mixed-format fleets interoperate frame
by frame; replies match the request's format.

A weights send climbs a per-edge ladder: the ICI plane for a peer of this
process on the shard plane (kernel 9 on a card, ``communication/ici.py``),
then the bytes: a stream for payloads at or above
``Settings.WIRE_STREAM_THRESHOLD``, with a counted fallback to unary for
peers that refuse streams, else one unary frame. (The DCN rung between
the two is ROADMAP Queue A item 9.) Received payloads are decoded against
the receiving learner's tree, onto its device.

``grpc`` is imported by this module only (and ``google.protobuf`` by
``proto_wire.py``): the rest of the package imports without them.
"""

from __future__ import annotations

import json
import threading
from concurrent import futures
from typing import Optional

import grpc

from p2pfl_tpu_torch.communication import proto_wire as pw
from p2pfl_tpu_torch.communication.message import Message, WeightsEnvelope
from p2pfl_tpu_torch.communication.neighbors import Neighbors
from p2pfl_tpu_torch.communication.protocol import CommunicationProtocol
from p2pfl_tpu_torch.exceptions import NeighborNotConnectedError
from p2pfl_tpu_torch.learning.weights import ModelUpdate
from p2pfl_tpu_torch.management.logger import logger
from p2pfl_tpu_torch.settings import Settings

_SERVICE = "/p2pfl.NodeServices/"
#: the reference's actual service path — its proto declares ``package node;``
#: so generated stubs use /node.NodeServices/* (reference node_pb2_grpc.py:44)
_SERVICE_REF = "/node.NodeServices/"
_METHODS = ("handshake", "disconnect", "send_message", "send_weights")
#: client-streaming RPCs (chunked weights transfers) — routed through
#: ``grpc.stream_unary_rpc_method_handler`` instead of unary_unary
_STREAM_METHODS = ("send_weights_stream",)


# ---- envelope codec ----

# Optional header keys ("tc"/"vv"/"xp"/"sp") are declared in ONE registry,
# communication/wire_headers.py, with their compat contract (guarded
# encode, .get() decode, memory byte-path copy, no protobuf leak). Add a
# key there first.


def encode_message(msg: Message) -> bytes:
    d = {
        "src": msg.source,
        "cmd": msg.cmd,
        "args": list(msg.args),
        "round": msg.round,
        "ttl": msg.ttl,
        "id": msg.msg_id,
    }
    if msg.trace_ctx is not None:
        # flight-recorder trace context (management/telemetry.py): optional
        # key — absent on old senders, ignored by old receivers, so both
        # wire directions stay compatible with pre-telemetry frames
        d["tc"] = list(msg.trace_ctx)
    if msg.xp is not None:
        # experiment identity (Node.set_start_learning) — optional like
        # "tc": old frames decode unchanged, receivers use it to filter
        # cross-experiment stragglers exactly
        d["xp"] = msg.xp
    return json.dumps(d).encode()


def _trace_ctx(d: dict):
    tc = d.get("tc")
    return (str(tc[0]), str(tc[1])) if tc else None


def decode_message(data: bytes) -> Message:
    d = json.loads(data.decode())
    return Message(
        d["src"], d["cmd"], tuple(d["args"]), d["round"], d["ttl"], d["id"],
        trace_ctx=_trace_ctx(d), xp=d.get("xp"),
    )


def encode_weights(env: WeightsEnvelope, payload: Optional[bytes] = None) -> bytes:
    # update.encode() is served by the encode-once payload cache while the
    # sender's model version is unchanged (learning/weights.py) — only this
    # small envelope header is built per send. ``payload`` overrides the
    # update's encoded bytes: the streaming path passes b"" to build the
    # payload-free header frame that precedes the P2TC chunks (the header
    # must carry every optional wire key, so it is built HERE — the one
    # function the wire-header-compat rule audits for guarded stores).
    d = {
        "src": env.source,
        "round": env.round,
        "cmd": env.cmd,
        "contributors": env.update.contributors,
        "num_samples": env.update.num_samples,
        "id": env.msg_id,
    }
    if env.trace_ctx is not None:
        d["tc"] = list(env.trace_ctx)  # optional — see encode_message
    if env.update.version is not None:
        # async-federation version triple (origin, seq, base_version) —
        # optional like "tc": absent on sync senders, ignored by old
        # receivers; the protobuf interop schema never carries it
        d["vv"] = list(env.update.version)
    xp = env.xp or env.update.xp
    if xp is not None:
        # experiment identity — optional like "tc"/"vv"; rides BOTH the
        # envelope and the decoded update so stash filters see it
        d["xp"] = xp
    if env.update.sp is not None:
        # shard-plane handshake triple (slice_shape, slice_index, codec)
        # — optional like "vv": a byte-path frame advertising the
        # sender's slice topology (communication/ici.py)
        d["sp"] = [list(env.update.sp[0]), env.update.sp[1], env.update.sp[2]]
    header = json.dumps(d).encode()
    body = env.update.encode() if payload is None else payload
    return b"".join((len(header).to_bytes(4, "little"), header, body))


def _sp_header(d: dict):
    sp = d.get("sp")
    return (tuple(sp[0]), int(sp[1]), str(sp[2])) if sp else None


def decode_weights(data: bytes) -> WeightsEnvelope:
    hlen = int.from_bytes(data[:4], "little")
    d = json.loads(data[4 : 4 + hlen].decode())
    vv = d.get("vv")
    update = ModelUpdate(
        params=None,
        contributors=list(d["contributors"]),
        num_samples=int(d["num_samples"]),
        encoded=data[4 + hlen :],
        version=(str(vv[0]), int(vv[1]), int(vv[2])) if vv else None,
        xp=d.get("xp"),
        sp=_sp_header(d),
    )
    return WeightsEnvelope(
        d["src"], d["round"], d["cmd"], update, d["id"], trace_ctx=_trace_ctx(d),
        xp=d.get("xp"),
    )


def _reply(ok: bool, error: str = "") -> bytes:
    return json.dumps({"ok": ok, "error": error}).encode()


def _reply_ok(data: bytes) -> bool:
    try:
        return bool(json.loads(data.decode()).get("ok"))
    except Exception:  # noqa: BLE001
        return False


def _reply_error(data: bytes) -> str:
    try:
        return str(json.loads(data.decode()).get("error") or "")
    except Exception:  # noqa: BLE001
        return ""


def _channel_options() -> list:
    """Message-size options for every channel AND the server: gRPC's 4 MB
    default silently caps unary weights payloads (RESOURCE_EXHAUSTED) far
    below real model sizes — raise both directions to
    ``Settings.GRPC_MAX_MESSAGE_MB``."""
    max_len = int(Settings.GRPC_MAX_MESSAGE_MB) * 1024 * 1024
    return [
        ("grpc.max_send_message_length", max_len),
        ("grpc.max_receive_message_length", max_len),
    ]


# ---- wire-format dispatch (envelope default; protobuf = reference interop) ----


def _pbuf() -> bool:
    return Settings.WIRE_FORMAT == "protobuf"


def _svc() -> str:
    """Dial path for outgoing RPCs: the reference's real /node.NodeServices/
    when speaking protobuf (so a reference server routes us), the native
    /p2pfl.NodeServices/ otherwise."""
    return _SERVICE_REF if _pbuf() else _SERVICE


def _enc_handshake(addr: str) -> bytes:
    return pw.encode_handshake_pb(addr) if _pbuf() else addr.encode()


def _enc_message(msg: Message) -> bytes:
    return pw.encode_message_pb(msg) if _pbuf() else encode_message(msg)


def _enc_weights(env: WeightsEnvelope) -> bytes:
    return pw.encode_weights_pb(env) if _pbuf() else encode_weights(env)


def _resp_ok(data: bytes) -> bool:
    return pw.decode_response_ok_pb(data) if _pbuf() else _reply_ok(data)


# ---- transport pieces ----


class GrpcNeighbors(Neighbors):
    def _connect(self, addr: str, handshake: bool):
        # encode before opening the channel: a misconfigured WIRE_FORMAT
        # (protobuf runtime absent) must raise without leaking a channel
        payload = _enc_handshake(self.self_addr) if handshake else b""
        channel = grpc.insecure_channel(addr, options=_channel_options())
        if handshake:
            try:
                caller = channel.unary_unary(_svc() + "handshake")
                resp = caller(payload, timeout=Settings.GRPC_TIMEOUT)
                if not _resp_ok(resp):
                    raise NeighborNotConnectedError(f"handshake rejected by {addr}")
            except grpc.RpcError as exc:
                channel.close()
                raise NeighborNotConnectedError(f"cannot reach {addr}: {exc.code()}") from exc
        return channel

    def _disconnect(self, addr: str, conn, notify: bool) -> None:
        if conn is None:
            return
        if notify:
            try:
                conn.unary_unary(_svc() + "disconnect")(
                    _enc_handshake(self.self_addr), timeout=Settings.GRPC_TIMEOUT
                )
            except (grpc.RpcError, RuntimeError):
                # RuntimeError: WIRE_FORMAT='protobuf' without the runtime —
                # best-effort notify must still close the channel below
                pass
        conn.close()


class GrpcProtocol(CommunicationProtocol):
    """gRPC transport: one server + heartbeat/gossip threads per node.

    Reference: ``grpc_communication_protocol.py:35`` + ``grpc_server.py`` +
    ``grpc_client.py``. ``address`` defaults to ``127.0.0.1`` with a free
    port (``communication/address.py``).
    """

    def __init__(self, address: Optional[str] = None) -> None:
        from p2pfl_tpu_torch.communication.address import parse_address

        super().__init__(parse_address(address).target)
        self._server: Optional[grpc.Server] = None
        self._lock = threading.Lock()
        # egress accounting (control vs weight plane), written from the
        # gossiper/heartbeater threads AND server-executor handlers, so
        # increments hold _lock; only acknowledged sends count
        self.wire_stats: dict[str, int] = {
            "weights_bytes": 0, "weights_msgs": 0,
            "control_bytes": 0, "control_msgs": 0,
            # streaming byte plane: successful chunked transfers, chunks
            # shipped, and loud stream→unary fallbacks (peer rejected)
            "stream_sends": 0, "stream_chunks": 0, "stream_fallback_unary": 0,
        }
        #: peers that rejected streaming: the loud fallback logs ONCE per
        #: peer, then keeps falling back silently
        self._stream_fallback_noted: set[str] = set()

    # ---- server ----

    def _make_neighbors(self) -> Neighbors:
        return GrpcNeighbors(self._address)

    def _server_start(self) -> None:
        # executor size is a knob (reference hardcodes 4, grpc_server.py:62):
        # a high-fan-in aggregator would serialize receives behind too few
        # handler threads, and a streamed transfer occupies one for its
        # whole duration
        server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=Settings.GRPC_SERVER_WORKERS),
            options=_channel_options(),
        )
        server.add_generic_rpc_handlers((_Handler(self),))
        bound = server.add_insecure_port(self._address)
        if bound == 0:
            raise NeighborNotConnectedError(f"cannot bind {self._address}")
        server.start()
        self._server = server

    def _server_stop(self) -> None:
        if self._server is not None:
            self._server.stop(grace=0.5)
            self._server = None

    # ---- client ----

    def _send_to_neighbor(self, nei: str, env, create_connection: bool = False) -> bool:
        info = self.neighbors.get(nei)
        channel = info.conn if info is not None and info.direct else None
        adhoc = None
        if channel is None:
            if not create_connection:
                return False
            # reference grpc_client.py:142-144
            adhoc = grpc.insecure_channel(nei, options=_channel_options())
            channel = adhoc
        try:
            kind = "weights" if isinstance(env, WeightsEnvelope) else "control"
            if kind == "weights":
                # the per-edge ladder, ICI then bytes: two gRPC nodes of ONE
                # process on the shard plane move model payloads slot to
                # slot (communication/ici.py) while control keeps riding the
                # socket; it sits inside the transport send, so the fault
                # injector and spans at the _do_send seam wrap it unchanged.
                # Peers in other processes are never on the shard registry
                # and fall through to the wire below
                from p2pfl_tpu_torch.communication.ici import try_shard_send

                handled = try_shard_send(self, nei, env)
                if handled is not None:
                    return handled
                # streaming byte plane: large payloads go as a chunked
                # client stream (encode/wire/decode overlap, bounded
                # memory); None ⇒ ineligible or peer rejected → unary below
                handled = self._try_stream_send(channel, nei, env)
                if handled is not None:
                    return handled
                payload = _enc_weights(env)
                resp = channel.unary_unary(_svc() + "send_weights")(
                    payload, timeout=Settings.GRPC_TIMEOUT
                )
            else:
                payload = _enc_message(env)
                resp = channel.unary_unary(_svc() + "send_message")(
                    payload, timeout=Settings.GRPC_TIMEOUT
                )
            with self._lock:
                self.wire_stats[f"{kind}_bytes"] += len(payload)
                self.wire_stats[f"{kind}_msgs"] += 1
            return _resp_ok(resp)
        except grpc.RpcError:
            return False
        finally:
            if adhoc is not None:
                adhoc.close()

    def _try_stream_send(self, channel, nei: str, env) -> Optional[bool]:
        """Chunked weights send. Returns None when the transfer should fall
        through to the unary path (small payload, protobuf interop, peer
        rejects streaming) — a real mid-stream failure returns False: the
        whole stream is ONE failed send at the ``_do_send`` seam, so the
        breaker, retry scheduling and FaultPlan verdicts see it exactly
        like a failed unary transfer."""
        if _pbuf() or not Settings.WIRE_STREAM_ENABLED:
            return None  # the reference's protobuf schema has no stream RPC
        with self._lock:
            if nei in self._stream_fallback_noted:
                return None  # peer already said no — don't re-probe each send
        from p2pfl_tpu_torch.learning.weights import estimate_payload_bytes

        est = estimate_payload_bytes(env.update)
        if est is None or est < Settings.WIRE_STREAM_THRESHOLD * 1024 * 1024:
            return None
        try:
            # lazy producer: the encode pipeline (or cache hit) runs here,
            # the per-chunk framing+CRC runs as gRPC's sender thread pulls
            # frames — overlapping with the wire and the receiver's decode
            chunk_iter = env.update.iter_chunks()
        except Exception as exc:  # noqa: BLE001 — encode trouble ⇒ let unary try
            logger.error(self._address, f"stream encode failed, trying unary: {exc!r}")
            return None
        sent = {"chunks": 0, "bytes": 0}

        def _frames():
            # payload-free header frame first: carries every optional wire
            # key (tc/vv/xp/sp) exactly like a unary envelope, then P2TC
            head = encode_weights(env, payload=b"")
            sent["bytes"] += len(head)
            yield head
            for c in chunk_iter:
                sent["chunks"] += 1
                sent["bytes"] += len(c)
                yield c

        try:
            resp = channel.stream_unary(_svc() + "send_weights_stream")(
                _frames(), timeout=Settings.GRPC_TIMEOUT
            )
        except grpc.RpcError as exc:
            if exc.code() == grpc.StatusCode.UNIMPLEMENTED:
                # pre-streaming peer: its generic handler has no such route
                self._note_stream_fallback(nei, "UNIMPLEMENTED")
                return None
            return False  # mid-stream death/timeout — one failed send
        if not _reply_ok(resp):
            if _reply_error(resp) == "stream-unsupported":
                # peer runs with WIRE_STREAM_ENABLED off — fall back loudly
                self._note_stream_fallback(nei, "stream-unsupported")
                return None
            return False  # receiver aborted (CRC, decode, dispatch error)
        with self._lock:
            self.wire_stats["weights_bytes"] += sent["bytes"]
            self.wire_stats["weights_msgs"] += 1
            self.wire_stats["stream_sends"] += 1
            self.wire_stats["stream_chunks"] += sent["chunks"]
        logger.log_comm_metric(self._address, "stream_send")
        logger.log_comm_metric(self._address, "stream_chunks_sent", sent["chunks"])
        return True

    def _note_stream_fallback(self, nei: str, why: str) -> None:
        with self._lock:
            self.wire_stats["stream_fallback_unary"] += 1
            first = nei not in self._stream_fallback_noted
            self._stream_fallback_noted.add(nei)
        logger.log_comm_metric(self._address, "stream_fallback_unary")
        if first:
            # loud once per peer, silent after, as the ICI plane's
            # fallbacks: a fleet quietly degrading to unary is a
            # misconfiguration someone should see
            logger.info(
                self._address,
                f"Peer {nei} rejects streaming ({why}) — falling back to "
                "unary send_weights for this and future transfers",
            )

    # ---- server-side entry points ----

    # every entry point sniffs the frame format and replies in kind, so a
    # mixed-format federation (or a reference node) interoperates without
    # any receiver-side configuration

    @staticmethod
    def _reply_as(pbuf: bool, ok: bool, error: str = "") -> bytes:
        return pw.encode_response_pb(ok, error) if pbuf else _reply(ok, error)

    def _sniff(self, data: bytes, looks_protobuf: bool):
        """(is_protobuf, rejection_reply_or_None): a frame that LOOKS
        protobuf while the runtime is absent must be refused — decoding it
        as an envelope would silently accept garbage (e.g. a corrupt
        neighbor address)."""
        if not looks_protobuf:
            return False, None
        if not pw.HAVE_PROTOBUF:
            logger.error(
                self._address,
                "Received a protobuf frame but google.protobuf is not "
                "installed — rejecting (pip install protobuf for interop)",
            )
            return False, self._reply_as(False, False, "protobuf runtime unavailable")
        return True, None

    def rpc_handshake(self, data: bytes, context) -> bytes:
        pbuf, rejection = self._sniff(data, pw.is_protobuf_handshake(data))
        if rejection is not None:
            return rejection
        source = pw.decode_handshake_pb(data) if pbuf else data.decode()
        self.neighbors.add(source, non_direct=False, handshake=False)
        return self._reply_as(pbuf, True)

    def rpc_disconnect(self, data: bytes, context) -> bytes:
        pbuf, rejection = self._sniff(data, pw.is_protobuf_handshake(data))
        if rejection is not None:
            return rejection
        self.neighbors.remove(pw.decode_handshake_pb(data) if pbuf else data.decode())
        return self._reply_as(pbuf, True)

    def rpc_send_message(self, data: bytes, context) -> bytes:
        pbuf, rejection = self._sniff(data, pw.is_protobuf_message(data))
        if rejection is not None:
            return rejection
        msg = pw.decode_message_pb(data) if pbuf else decode_message(data)
        res = self.handle_message(msg)
        return self._reply_as(pbuf, res.ok, res.error or "")

    def rpc_send_weights(self, data: bytes, context) -> bytes:
        pbuf, rejection = self._sniff(data, pw.is_protobuf_weights(data))
        if rejection is not None:
            return rejection
        try:
            env = pw.decode_weights_pb(data) if pbuf else decode_weights(data)
        except Exception as exc:  # noqa: BLE001 — malformed payload
            logger.error(
                self._address,
                f"Malformed weights payload: {exc}"
                + (
                    ""
                    if pbuf
                    else " (if the sender speaks protobuf, note the sniff "
                    "requires a non-empty Weights.source — an empty source "
                    "frame is misrouted to the envelope decoder)"
                ),
            )
            return self._reply_as(pbuf, False, "malformed weights payload")
        res = self.handle_weights(env)
        return self._reply_as(pbuf, res.ok, res.error or "")

    def rpc_send_weights_stream(self, request_iterator, context) -> bytes:
        """Client-streaming weights receive: header frame, then P2TC chunks.

        The first message is a payload-free envelope (same codec as unary —
        every optional wire key rides it); the rest are self-delimiting
        chunks fed straight into the shared
        :meth:`CommunicationProtocol.handle_weights_stream`, which decodes
        leaves as their bytes complete. Only the native envelope format
        streams — protobuf interop peers never dial this method."""
        it = iter(request_iterator)
        try:
            first = next(it)
        except StopIteration:
            return _reply(False, "empty stream")
        try:
            env = decode_weights(first)
        except Exception as exc:  # noqa: BLE001 — malformed header frame
            logger.error(self._address, f"Malformed stream header frame: {exc}")
            return _reply(False, "malformed weights payload")
        res = self.handle_weights_stream(env, it)
        return _reply(res.ok, res.error or "")


class _Handler(grpc.GenericRpcHandler):
    def __init__(self, protocol: GrpcProtocol) -> None:
        # both prefixes route to the same sniffing handlers: the reference's
        # stubs call /node.NodeServices/* (its proto's `package node;`),
        # existing repo federations call /p2pfl.NodeServices/*
        self._routes = {
            svc + m: getattr(protocol, f"rpc_{m}")
            for svc in (_SERVICE, _SERVICE_REF)
            for m in _METHODS
        }
        self._stream_routes = {
            svc + m: getattr(protocol, f"rpc_{m}")
            for svc in (_SERVICE, _SERVICE_REF)
            for m in _STREAM_METHODS
        }

    def service(self, call_details):
        fn = self._stream_routes.get(call_details.method)
        if fn is not None:
            return grpc.stream_unary_rpc_method_handler(fn)
        fn = self._routes.get(call_details.method)
        if fn is None:
            return None
        return grpc.unary_unary_rpc_method_handler(fn)


