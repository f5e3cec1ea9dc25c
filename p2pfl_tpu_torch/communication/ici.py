"""The ICI weights plane: model payloads move slot to slot on the device.

Counterpart of ``p2pfl_tpu/communication/ici.py`` for
``Settings.WIRE_COMPRESSION="none"`` (the int8/topk8 composition,
``_move_codec``, is not ported). ``Settings.WEIGHTS_PLANE = "ici"``
re-routes MODEL payloads between nodes registered in this process
through :func:`~p2pfl_tpu_torch.parallel.ici_plane.shard_transfer`: the
sender's tensors are copied into fresh buffers on the receiver's slot by
kernel 9 (on a card) or its plain version (on the CPU). Votes, coverage,
beats and TTL floods keep riding the transport.

- **The ``_do_send`` seam.** :func:`try_shard_send` runs inside the
  transport's ``_send_to_neighbor``, behind the protocol's send span and
  the fault-injection continuation, so they wrap an ICI transfer exactly
  as they wrap a reference send.
- **Failure semantics.** An ineligible peer (unregistered, no learner,
  mismatched architecture or slice topology, overlapping slices, leaves
  off the learner's slice) falls back loudly to the transport's path for
  that peer only (``ici_fallback_bytes``, one log line per edge and
  reason). A dead peer fails the send as the transport would. A transfer
  that raises (a kernel that does not build or launch) is logged as
  "ICI shard transfer to <peer> failed" and fails the send.
- **Co-resident slices** (the same slots: learners without a mesh on one
  device, the way single-chip JAX learners on one device are) get a
  zero-copy handoff, the reference path's read-only contract, and count
  zero bytes moved. **Disjoint slices** get a real transfer, counted in
  ``bytes_moved``, even when both slices name the same card.

Delivery lands on the receiver's device, so
:func:`~p2pfl_tpu_torch.ops.tree.tree_align_devices` is a checked no-op
downstream: the plane counts a violation (``align_violations``) and
re-places the leaf if one ever lands elsewhere.
"""

from __future__ import annotations

import threading
import weakref
from typing import Optional, Tuple

from p2pfl_tpu_torch.communication.message import WeightsEnvelope
from p2pfl_tpu_torch.learning.weights import ModelUpdate
from p2pfl_tpu_torch.management.logger import logger
from p2pfl_tpu_torch.management.telemetry import telemetry
from p2pfl_tpu_torch.ops.tree import tree_align_copy_count, tree_align_devices, tree_leaves, tree_structure
from p2pfl_tpu_torch.parallel.ici_plane import (
    SliceInfo,
    same_devices,
    shard_transfer,
    slice_info_of,
    tree_device_bytes,
)

# ---- process-wide accounting (tests and chip_smoke read these) ----

_stats_lock = threading.Lock()
_stats = {
    "shard_sends": 0,       # payloads delivered over the ICI plane
    "bytes_moved": 0,       # bytes copied between slots (handoffs count 0)
    "fallback_bytes": 0,    # sends that fell back to the transport's path
    "align_violations": 0,  # delivered leaves that needed re-placement
}


def ici_stats() -> dict:
    with _stats_lock:
        return dict(_stats)


def reset_ici_stats() -> None:
    with _stats_lock:
        for k in _stats:
            _stats[k] = 0


def _count(key: str, n: int = 1) -> None:
    with _stats_lock:
        _stats[key] += n


class IciEndpoint:
    """One node's presence on the shard plane: a weak reference to the
    node (the registry never keeps a stopped node alive) and its slot on
    the global mesh's nodes axis when known (``slice_index``, rides the
    ``sp`` handshake)."""

    def __init__(self, node, slice_index: int = -1) -> None:
        self._node_ref = weakref.ref(node)
        self.slice_index = slice_index

    def node(self):
        return self._node_ref()

    @property
    def learner(self):
        node = self.node()
        return None if node is None else node.learner

    def slice_info(self, tree=None) -> Optional[SliceInfo]:
        """The slice of ``tree`` (default: the learner's parameters) on the
        learner's mesh; None when ineligible."""
        learner = self.learner
        if learner is None:
            return None
        try:
            params = learner.get_parameters() if tree is None else tree
            return slice_info_of(params, getattr(learner, "mesh", None))
        except Exception:  # noqa: BLE001 — learner mid-teardown
            return None

    def handshake(self, codec: str) -> Optional[Tuple]:
        """The ``sp`` triple (slice_shape, slice_index, codec)."""
        info = self.slice_info()
        if info is None:
            return None
        return (info.shape, self.slice_index, codec)


class ShardPlaneRegistry:
    """Process-global address → :class:`IciEndpoint` map. A peer absent
    from it is not co-located; its sends take the transport's path."""

    _lock = threading.Lock()
    _endpoints: dict[str, IciEndpoint] = {}
    #: (src, dst, reason) triples already logged
    _warned: set = set()

    @classmethod
    def register(cls, addr: str, endpoint: IciEndpoint) -> None:
        with cls._lock:
            cls._endpoints[addr] = endpoint

    @classmethod
    def unregister(cls, addr: str) -> None:
        with cls._lock:
            cls._endpoints.pop(addr, None)

    @classmethod
    def get(cls, addr: str) -> Optional[IciEndpoint]:
        with cls._lock:
            return cls._endpoints.get(addr)

    @classmethod
    def reset(cls) -> None:
        with cls._lock:
            cls._endpoints.clear()
            cls._warned.clear()

    @classmethod
    def warn_once(cls, src: str, dst: str, reason: str) -> bool:
        key = (src, dst, reason)
        with cls._lock:
            if key in cls._warned:
                return False
            cls._warned.add(key)
            return True


def stamp_handshake(addr: str, update: ModelUpdate) -> None:
    """Stamp the ``sp`` handshake on an outgoing update when the plane is on."""
    from p2pfl_tpu_torch.settings import Settings

    if Settings.WEIGHTS_PLANE != "ici" or update.sp is not None:
        return
    ep = ShardPlaneRegistry.get(addr)
    if ep is not None:
        update.sp = ep.handshake(Settings.WIRE_COMPRESSION)


def _fallback(src: str, nei: str, reason: str) -> None:
    """Per-peer loud degradation to the transport's path (never aborts)."""
    _count("fallback_bytes")
    logger.log_comm_metric(src, "ici_fallback_bytes")
    if ShardPlaneRegistry.warn_once(src, nei, reason):
        logger.info(
            src,
            f"ICI weights plane ineligible for {nei} ({reason}) — "
            "falling back to the transport's path for this peer",
        )
    telemetry.event(src, "ici_fallback", kind="gossip", attrs={"peer": nei, "reason": reason})


def _leaf_meta_matches(a, b) -> bool:
    return all(
        tuple(x.shape) == tuple(y.shape) and x.dtype == y.dtype
        for x, y in zip(tree_leaves(a), tree_leaves(b))
    )


def try_shard_send(proto, nei: str, env) -> Optional[bool]:
    """Attempt an ICI delivery of one outgoing envelope.

    Returns ``True``/``False`` when the plane handled the send (the
    transport must not deliver it again), or ``None`` when this envelope
    or peer is not eligible and the transport's path proceeds.
    """
    from p2pfl_tpu_torch.settings import Settings

    if Settings.WEIGHTS_PLANE != "ici" or not isinstance(env, WeightsEnvelope):
        return None
    update = env.update
    src = proto.get_address()
    src_ep = ShardPlaneRegistry.get(src)
    dst_ep = ShardPlaneRegistry.get(nei)
    if src_ep is None or dst_ep is None:
        _fallback(src, nei, "peer_not_on_shard_plane")
        return None
    dst_node = dst_ep.node()
    if dst_node is None or not getattr(dst_node, "_running", False):
        # dead peer: let the transport fail the send so breakers/eviction
        # see exactly the signals they are built for
        return None
    dst_learner = dst_ep.learner
    if dst_learner is None:
        _fallback(src, nei, "peer_has_no_learner")
        return None
    try:
        template = dst_learner.get_parameters()
    except Exception:  # noqa: BLE001 — learner mid-teardown
        return None
    if tree_structure(template) != tree_structure(update.params):
        _fallback(src, nei, "architecture_mismatch")
        return None
    if not _leaf_meta_matches(update.params, template):
        _fallback(src, nei, "shape_dtype_mismatch")
        return None
    src_info = src_ep.slice_info(update.params)
    dst_info = dst_ep.slice_info(template)
    if src_info is None or dst_info is None:
        _fallback(src, nei, "params_not_on_slice")
        return None
    if src_info.shape != dst_info.shape or src_info.mesh.axis_names != dst_info.mesh.axis_names:
        _fallback(src, nei, "slice_topology_mismatch")
        return None
    co_resident = src_info.device_ids == dst_info.device_ids
    if not co_resident and (src_info.device_ids & dst_info.device_ids):
        _fallback(src, nei, "slices_overlap")
        return None
    if src_info.device.type != dst_info.device.type:
        # a CPU slice and a card slice: no kernel stores across them, and
        # the plane never stages through the host
        _fallback(src, nei, "device_type_mismatch")
        return None

    mode = Settings.WIRE_COMPRESSION
    try:
        if same_devices(src_info, dst_info):
            # the tensors already lie where the receiver wants them: a
            # zero-copy handoff, the reference path's read-only contract
            moved, params = 0, update.params
        else:
            moved = tree_device_bytes(update.params)
            params = shard_transfer(update.params, template, src_info, dst_info)
    except Exception as exc:  # noqa: BLE001 — a failed transfer is a failed send
        logger.error(src, f"ICI shard transfer to {nei} failed: {exc!r}")
        return False

    delivered = ModelUpdate(
        params,
        list(update.contributors),
        update.num_samples,
        xp=update.xp or env.xp,
        sp=src_ep.handshake(mode),
    )
    # the no-fix-up contract, checked: delivery already lies on the
    # receiver's device, so aligning against it must move nothing
    before = tree_align_copy_count()
    delivered.params = tree_align_devices(delivered.params, template)
    misplaced = tree_align_copy_count() - before
    if misplaced:
        _count("align_violations", misplaced)
        logger.log_comm_metric(src, "ici_align_violation", misplaced)
        logger.error(
            src,
            f"ICI delivery to {nei} needed {misplaced} device fix-up "
            "copies — the shard plane mis-placed a leaf (re-placed)",
        )

    denv = WeightsEnvelope(
        env.source, env.round, env.cmd, delivered, env.msg_id, trace_ctx=env.trace_ctx, xp=env.xp,
    )
    try:
        result = dst_node.protocol.handle_weights(denv)
    except Exception:  # noqa: BLE001 — peer died mid-delivery
        return False
    _count("shard_sends")
    _count("bytes_moved", moved)
    logger.log_comm_metric(src, "ici_send_shard")
    logger.log_comm_metric(src, "ici_bytes_moved", moved)
    telemetry.event(
        src, "ici_transfer", kind="gossip",
        attrs={"peer": nei, "codec": mode, "bytes": moved},
    )
    return bool(result.ok)
