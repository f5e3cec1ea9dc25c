"""The one registry of OPTIONAL envelope header keys (a copy of
``p2pfl_tpu/communication/wire_headers.py``).

Every optional key the native wire envelope may carry (``tc``, ``vv``,
``xp``, ``sp``) follows one backward-compat contract:

- **absent-frame decode**: a frame without the key decodes exactly as a
  frame from before the key did (``d.get(key)``, never ``d[key]``);
- **guarded encode**: ``None`` is never serialized: the encoder writes the
  key only under an ``is not None`` guard, so old receivers keep parsing
  new senders and the bytes of a frame stay stable;
- **memory byte path copies it**: the in-memory transport's
  ``MEMORY_WIRE_CODEC`` re-wrap (``communication/memory.py``) carries the
  key's backing attributes onto the rebuilt envelope and update, or
  simulations diverge from the network transports;
- **never in the protobuf interop schema**: the reference's proto schema
  (``proto_wire.py``) predates these keys and stays byte-compatible with
  reference nodes;
- **streamed transfers inherit for free**: the streaming plane's first
  frame is a payload-free envelope built by the same ``encode_weights``
  (``grpc_transport.py`` passes ``payload=b""``).

``tests/test_torch_grpc.py`` checks every key declared here against the
three codec files; adding an optional header means adding a
:class:`WireHeader` entry and meeting each leg.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class WireHeader:
    """One optional envelope header key and where it must be handled.

    ``planes``: which native codecs carry it — ``"message"`` (control
    plane: ``encode_message``/``decode_message``) and/or ``"weights"``
    (data plane: ``encode_weights``/``decode_weights``).

    ``memory_copies``: ``(constructor, kwarg)`` pairs the in-memory byte
    path's re-wrap must pass — e.g. ``("ModelUpdate", "version")`` means
    the rebuilt wire update must copy ``version=``.
    """

    key: str
    planes: Tuple[str, ...]
    memory_copies: Tuple[Tuple[str, str], ...]
    doc: str


OPTIONAL_WIRE_HEADERS: Tuple[WireHeader, ...] = (
    WireHeader(
        key="tc",
        planes=("message", "weights"),
        memory_copies=(("WeightsEnvelope", "trace_ctx"),),
        doc=(
            "flight-recorder trace context (trace_id, parent_span_id) — "
            "management/telemetry.py; joins receiver spans to the "
            "sender's causal tree"
        ),
    ),
    WireHeader(
        key="vv",
        planes=("weights",),
        memory_copies=(("ModelUpdate", "version"),),
        doc=(
            "async-federation version triple (origin, seq, base_version) "
            "— federation/staleness.py; dedup + staleness weighting"
        ),
    ),
    WireHeader(
        key="xp",
        planes=("message", "weights"),
        memory_copies=(("ModelUpdate", "xp"), ("WeightsEnvelope", "xp")),
        doc=(
            "experiment identity minted by the start_learning initiator — "
            "receivers filter cross-experiment stragglers exactly"
        ),
    ),
    WireHeader(
        key="sp",
        planes=("weights",),
        memory_copies=(("ModelUpdate", "sp"),),
        doc=(
            "shard-plane handshake triple (slice_shape, slice_index, "
            "codec) — communication/ici.py; byte-path frames advertise "
            "the sender's slice topology so receivers can validate "
            "co-location for the ICI weights plane"
        ),
    ),
)
