"""Protobuf wire interop: speak the reference's frames on the same RPCs
(a port of ``p2pfl_tpu/communication/proto_wire.py``).

- Frames: ``Settings.WIRE_FORMAT = "protobuf"`` makes every outgoing frame
  a reference-schema protobuf (``proto/interop.proto``, field for field
  the reference's ``node.proto``); replies are ``ResponseMessage``.
- Routes: the reference's proto declares ``package node;``, so its stubs
  serve and call ``/node.NodeServices/*``; ``grpc_transport.py`` registers
  that prefix and the native ``/p2pfl.NodeServices/*`` and dials the
  reference's in protobuf mode.
- Receivers need no switch: every server entry point sniffs the frame.
  JSON frames open with ``{`` (0x7B), envelope weights frames with a
  little-endian header length whose high bytes are zero followed by
  ``{``, and a protobuf frame of these schemas with the field-1
  length-delimited tag 0x0A.

The bytes inside ``Weights.weights`` are the P2TW codec
(``learning/weights.py``), never the reference's pickle: unpickling wire
bytes runs arbitrary code, so a payload that is not P2TW is refused.

``google.protobuf`` is imported here and by the generated stub only;
without it ``WIRE_FORMAT="protobuf"`` raises at send time and sniffing
falls through to the envelope path.
"""

from __future__ import annotations

import hashlib
from typing import Optional

from p2pfl_tpu_torch.communication.message import Message, WeightsEnvelope
from p2pfl_tpu_torch.learning.weights import ModelUpdate

try:
    from p2pfl_tpu_torch.communication.proto import interop_pb2 as pb

    HAVE_PROTOBUF = True
except ImportError:
    pb = None
    HAVE_PROTOBUF = False

# NOTE: this codec is the reference-interop schema: the optional native
# envelope headers registered in communication/wire_headers.py never
# appear here (tests/test_torch_grpc.py checks it).

#: the P2TW magic (learning/weights.py) — the only weight payload accepted
_P2TW_MAGIC = b"P2TW"
#: protobuf field-1 length-delimited tag; both formats' first byte differs
_TAG_FIELD1 = 0x0A


def _require() -> None:
    if not HAVE_PROTOBUF:
        raise RuntimeError(
            "WIRE_FORMAT='protobuf' needs the google.protobuf runtime "
            "(pip install protobuf)"
        )


def _hash64(msg_id: str) -> int:
    """Map our string message ids onto the reference's int64 ``hash``.

    Ids that ARRIVED as a protobuf hash (decode sets ``msg_id=str(hash)``)
    must round-trip to the SAME integer when relayed — re-hashing would
    give every gossip hop a fresh dedup id and the flood would never be
    suppressed (each receiver dispatching the same command once per hop).
    Reference nodes derive the hash from Python's SIGNED hash, so negative
    values round-trip too.
    """
    digits = msg_id[1:] if msg_id.startswith("-") else msg_id
    # ascii-only: str.isdigit() accepts Unicode digits that int() rejects,
    # and a peer-controlled id must never crash the relaying gossiper
    if digits.isascii() and digits.isdigit():
        v = int(msg_id)
        if -(1 << 63) <= v < (1 << 63):  # the FULL signed-int64 range
            return v
    return int.from_bytes(hashlib.sha256(msg_id.encode()).digest()[:8], "big") >> 1


# ---- sniffing ----


def is_protobuf_message(data: bytes) -> bool:
    """True when a send_message frame is reference-schema protobuf.

    JSON envelope frames always start with ``{``; a protobuf ``Message``
    always starts with the field-1 tag. ASSUMPTION (documented limit of
    the sniff): ``source`` is non-empty. proto3 omits default-valued
    fields, so a Message with ``source=""`` would serialize starting at
    the ttl/hash tag (0x10/0x18) and be misrouted to the envelope decoder.
    Every sender in both implementations stamps its own address as the
    source (the gossip dedup and eviction logic require it), so an
    empty-source frame is malformed at the protocol level anyway — the
    envelope decoder's error message names this cause.
    """
    return bool(data) and data[0] == _TAG_FIELD1


def is_protobuf_weights(data: bytes) -> bool:
    """True when a send_weights frame is reference-schema protobuf.

    The envelope format opens with a 4-byte little-endian JSON-header
    length followed by ``{``; any header under 16 MB (the top byte of the
    length is zero — real headers are a few hundred bytes, and even a
    pathological many-thousand-contributor aggregate stays far below)
    matches ``data[3] == 0 and data[4] == '{'``. A protobuf ``Weights``
    opens with tag 0x0A + the length-prefixed source string, whose bytes
    land at data[2:] — an address never contains NUL, so ``data[3]`` is
    nonzero there and the two formats cannot collide. Same non-empty
    ``source`` assumption as :func:`is_protobuf_message` (an empty source
    would start the frame at the round/weights tag and misroute it).
    """
    if len(data) < 5:
        return False
    envelope = data[3] == 0 and data[4] == 0x7B
    return data[0] == _TAG_FIELD1 and not envelope


def is_protobuf_handshake(data: bytes) -> bool:
    """Addresses (host:port / unix paths) never start with 0x0A."""
    return bool(data) and data[0] == _TAG_FIELD1


# ---- control plane ----


def encode_message_pb(msg: Message) -> bytes:
    _require()
    out = pb.Message(
        source=msg.source,
        ttl=msg.ttl,
        hash=_hash64(msg.msg_id),
        cmd=msg.cmd,
        args=list(msg.args),
    )
    if msg.round >= 0:
        out.round = msg.round
    return out.SerializeToString()


def decode_message_pb(data: bytes) -> Message:
    _require()
    m = pb.Message.FromString(data)
    return Message(
        m.source,
        m.cmd,
        tuple(m.args),
        m.round if m.HasField("round") else -1,
        m.ttl,
        # keep the reference's dedup id stable across relays
        msg_id=str(m.hash),
    )


def encode_handshake_pb(addr: str) -> bytes:
    _require()
    return pb.HandShakeRequest(addr=addr).SerializeToString()


def decode_handshake_pb(data: bytes) -> str:
    _require()
    return pb.HandShakeRequest.FromString(data).addr


def encode_response_pb(ok: bool, error: str = "") -> bytes:
    _require()
    out = pb.ResponseMessage()
    if not ok:
        out.error = error or "error"
    return out.SerializeToString()


def decode_response_ok_pb(data: bytes) -> bool:
    _require()
    try:
        return not pb.ResponseMessage.FromString(data).HasField("error")
    except Exception:  # noqa: BLE001 — malformed reply = failure
        return False


# ---- data plane ----


def encode_weights_pb(env: WeightsEnvelope) -> bytes:
    _require()
    return pb.Weights(
        source=env.source,
        round=env.round,
        weights=env.update.encode(),
        contributors=list(env.update.contributors),
        weight=int(env.update.num_samples),
        cmd=env.cmd,
    ).SerializeToString()


def decode_weights_pb(data: bytes) -> WeightsEnvelope:
    _require()
    w = pb.Weights.FromString(data)
    if not w.weights.startswith(_P2TW_MAGIC):
        # almost certainly the reference's pickled-numpy payload:
        # unpickling wire bytes is arbitrary code execution; refuse loudly
        raise ValueError(
            "weights payload is not the P2TW codec (refusing to unpickle "
            "foreign bytes, see communication/proto_wire.py)"
        )
    update = ModelUpdate(
        params=None,
        contributors=list(w.contributors),
        num_samples=int(w.weight),
        encoded=bytes(w.weights),
    )
    return WeightsEnvelope(w.source, w.round, w.cmd, update)
