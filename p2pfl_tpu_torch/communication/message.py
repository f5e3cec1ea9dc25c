"""Transport-agnostic message model (a copy of ``p2pfl_tpu/communication/message.py``).

A small control ``Message`` that TTL-floods the overlay and a
``WeightsEnvelope`` that moves point to point. The in-memory transport
and the ICI plane pass them by reference, weights as a live
:class:`~p2pfl_tpu_torch.learning.weights.ModelUpdate`; the gRPC
transport maps them to and from its frames (``grpc_transport.py``,
``proto_wire.py``).
"""

from __future__ import annotations

import hashlib
import itertools
import time
from dataclasses import dataclass, field
from typing import Optional, Union

from p2pfl_tpu_torch.learning.weights import ModelUpdate

_seq = itertools.count()


def _message_id(source: str, cmd: str, args: tuple[str, ...]) -> str:
    """Unique-enough id for gossip dedup.

    The reference hashes cmd+args+now+random (``grpc_client.py:72``); a
    monotonic per-process sequence number removes the (tiny) collision
    probability while staying cheap.
    """
    raw = f"{source}|{cmd}|{'|'.join(args)}|{time.monotonic_ns()}|{next(_seq)}"
    return hashlib.blake2s(raw.encode(), digest_size=16).hexdigest()


@dataclass
class Message:
    """A small control-plane message (vote, beat, round status, ...).

    ``trace_ctx`` is the sender's ``(trace_id, parent_span_id)``
    (``management/telemetry.py``), stamped by ``protocol.build_msg`` so the
    receiver's dispatch span joins the sender's causal tree. ``xp`` is the
    experiment identity minted by the ``start_learning`` initiator
    (``Node.set_start_learning``); receivers filter cross-experiment
    stragglers on it.
    """

    source: str
    cmd: str
    args: tuple[str, ...] = ()
    round: int = -1
    ttl: int = 1
    msg_id: str = ""
    trace_ctx: Optional[tuple[str, str]] = None
    xp: Optional[str] = None

    def __post_init__(self) -> None:
        self.args = tuple(str(a) for a in self.args)
        if not self.msg_id:
            self.msg_id = _message_id(self.source, self.cmd, self.args)


@dataclass
class WeightsEnvelope:
    """A model payload moving between nodes (data plane).

    ``update`` holds live tensors (in-process transports, the ICI plane)
    or only ``update.encoded`` bytes / ``update.decoded_flat`` leaves
    (byte transports, until the receiving learner decodes them).
    ``trace_ctx`` carries the sender's trace context exactly like
    :class:`Message` (stamped by ``protocol.build_weights``); ``xp`` the
    experiment identity (same optional-key contract — it also rides
    ``update.xp`` so stash filters see it after decode).
    """

    source: str
    round: int
    cmd: str  # "init_model" | "add_model"
    update: ModelUpdate
    msg_id: str = field(default="")
    trace_ctx: Optional[tuple[str, str]] = None
    xp: Optional[str] = None

    def __post_init__(self) -> None:
        if not self.msg_id:
            self.msg_id = _message_id(self.source, self.cmd, ())


Envelope = Union[Message, WeightsEnvelope]


@dataclass
class CommandResult:
    """Outcome of dispatching a message to a command handler."""

    ok: bool = True
    error: Optional[str] = None
