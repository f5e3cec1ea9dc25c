"""Staleness weighting and per-node version vectors (a copy of
``p2pfl_tpu/federation/staleness.py``: host logic, no tensors).

The async control plane has no rounds, so "how old is this update?" can't
be a round delta. Instead every aggregator tier counts **global model
versions** (one merge = one version), and every update carries the version
it was trained *from* (``UpdateVersion.base_version``). Staleness is then

    τ = version_at_merge − base_version      (≥ 0, no global clock needed)

and the update's effective weight is ``num_samples · w(τ)`` with the
FedBuff polynomial weight ``w(τ) = 1/(1+τ)^α`` (Nguyen et al. 2022 §5).
``Settings.ASYNC_MAX_STALENESS`` bounds τ: beyond it the update is dropped
outright — a wedged straggler's ancient update must never touch the model,
however small its weight (bounded staleness, not merely decayed).

:class:`VersionVector` is the dedup half: one monotone per-origin sequence
counter. The data plane has no dedup ring (weights envelopes are
re-deliverable by design — FaultPlan duplicates, send retries, TTL relays),
and in the sync FSM the aggregator's contributor-overlap checks absorb
replays. The async buffer has no contributor algebra, so the version
vector is what keeps a duplicated or reordered delivery from ever merging
twice: an ``(origin, seq)`` at or below the vector's entry is a replay.
"""

from __future__ import annotations

import threading
from typing import Dict, NamedTuple, Optional


class UpdateVersion(NamedTuple):
    """The wire version triple riding ``ModelUpdate.version``.

    Serialized as the optional ``"vv"`` key of the gRPC weights-envelope
    header (absent → old frames decode unchanged; the protobuf interop
    schema never carries it — same compatibility contract as the
    telemetry ``"tc"`` field).
    """

    origin: str  #: producing node (or regional aggregator) address
    seq: int  #: monotone per-origin update counter (dedup key)
    base_version: int  #: global model version the update was trained from


def as_version(value) -> Optional[UpdateVersion]:
    """Normalize a wire tuple/list (or None) into an :class:`UpdateVersion`."""
    if value is None:
        return None
    origin, seq, base = value
    return UpdateVersion(str(origin), int(seq), int(base))


def xp_mismatch(addr: str, frame_xp: Optional[str], local_xid: Optional[str]) -> bool:
    """True when a frame's experiment identity contradicts ours — the ONE
    filtering rule every async plane shares (weights handlers, the
    done/join/leave control gates, the stash filters' exact branch).

    Only a definite contradiction filters: frames from pre-"xp" senders
    (``frame_xp is None``) and nodes without an identity yet (a joiner
    before its bootstrap) fall through to each caller's fallback
    heuristics. Counts ``async_xp_filtered`` so filtered cross-experiment
    stragglers are visible in the comm metrics.
    """
    if frame_xp is None or local_xid is None or frame_xp == local_xid:
        return False
    from p2pfl_tpu_torch.management.logger import logger

    logger.log_comm_metric(addr, "async_xp_filtered")
    return True


def staleness_weight(tau: float, alpha: float) -> float:
    """FedBuff polynomial staleness weight ``w(τ) = 1/(1+τ)^α``.

    ``w(0) = 1`` always; ``alpha = 0`` disables down-weighting (every
    update counts at full weight regardless of age); larger α discounts
    stale updates harder. Negative τ (an update trained from a version
    the merging tier has not reached — possible transiently when a
    regional's global view lags a fast edge) clamps to 0: "from the
    future" is simply fresh.
    """
    tau = max(float(tau), 0.0)
    if alpha == 0.0:
        return 1.0
    return 1.0 / (1.0 + tau) ** float(alpha)


class VersionVector:
    """Per-origin high-water marks: ``origin → highest seq accepted``.

    ``observe`` is the single gate: it returns True exactly once per
    ``(origin, seq)`` *at or above* the current mark — duplicates and
    anything at/below the mark are rejected. Out-of-order arrivals
    *ahead* of the mark are accepted (seq 3 after seq 1 when seq 2 was
    dropped on the wire: the update is real and newer, the gap is a
    lost update, not a protocol error); the mark then jumps, so the
    late seq-2 straggler is rejected as stale. That asymmetry is
    deliberate: the buffer wants the newest state of every node, not an
    exactly-once ledger.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._seen: Dict[str, int] = {}

    def observe(self, origin: str, seq: int) -> bool:
        """Accept-and-advance; False for duplicates / superseded seqs."""
        with self._lock:
            if seq <= self._seen.get(origin, 0):
                return False
            self._seen[origin] = seq
            return True

    def last(self, origin: str) -> int:
        with self._lock:
            return self._seen.get(origin, 0)

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._seen)

    def merge(self, other: Dict[str, int]) -> None:
        """Pointwise max-merge (monotone, like every control-plane merge
        since the round-0 wedge fix — version vectors form a lattice)."""
        with self._lock:
            for origin, seq in other.items():
                if seq > self._seen.get(origin, 0):
                    self._seen[origin] = seq
