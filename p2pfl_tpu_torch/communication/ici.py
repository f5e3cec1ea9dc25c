"""The ICI weights plane: model payloads move slot to slot on the device.

Counterpart of ``p2pfl_tpu/communication/ici.py``.
``Settings.WEIGHTS_PLANE = "ici"`` re-routes MODEL payloads between nodes
registered in this process through
:func:`~p2pfl_tpu_torch.parallel.ici_plane.shard_transfer`: the sender's
tensors are copied into fresh buffers on the receiver's slot by kernel 9
(on a card) or its plain version (on the CPU). Votes, coverage, beats and
TTL floods keep riding the transport. Under ``WIRE_COMPRESSION`` ``"int8"``
or ``"topk8"`` the plane composes with the device codec
(:func:`_move_codec`): encode where the sender's params live, move the
compressed buffers and the raw leaves in one exchange, decode against the
receiver's anchor where it lives; nothing crosses to the host.

- **The ``_do_send`` seam.** :func:`try_shard_send` runs inside the
  transport's ``_send_to_neighbor``, behind the protocol's send span and
  the fault-injection continuation, so they wrap an ICI transfer exactly
  as they wrap a reference send.
- **Failure semantics.** An ineligible peer (unregistered, no learner,
  mismatched architecture, slice topology or per-leaf specs, overlapping
  slices, leaves off the learner's slice) falls back loudly to the transport's path for
  that peer only (``ici_fallback_bytes``, one log line per edge and
  reason). A dead peer fails the send as the transport would. A transfer
  that raises (a kernel that does not build or launch) is logged as
  "ICI shard transfer to <peer> failed" and fails the send.
- **Sharded learners** (a slice of several slots, ``TorchLearner(mesh=,
  partition_rules=)``): the specs come from the sender's placed leaves on
  its learner's slice, and :func:`shard_transfer` moves each (leaf, slot)
  block to the same slot of the receiver's slice in the one exchange of
  the tree. Under a codec the encode reads the gathered tensors and the
  decode is placed by the receiver's layout.
- **Co-resident slices** (the same slots: learners without a mesh on one
  device, the way single-chip JAX learners on one device are) get a
  zero-copy handoff, the reference path's read-only contract, and count
  zero bytes moved (under a codec the buffers are encoded and decoded,
  and move zero bytes). **Disjoint slices** get a real transfer, counted in
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
from p2pfl_tpu_torch.learning.weights import ModelUpdate, named_leaves
from p2pfl_tpu_torch.management.logger import logger
from p2pfl_tpu_torch.management.telemetry import telemetry
from p2pfl_tpu_torch.ops.tree import (
    tree_align_copy_count,
    tree_align_devices,
    tree_leaves,
    tree_structure,
    tree_unflatten,
)
from p2pfl_tpu_torch.parallel.ici_plane import (
    SliceInfo,
    same_devices,
    shard_transfer,
    slice_info_of,
    transfer_buffers,
    tree_device_bytes,
)
from p2pfl_tpu_torch.parallel.sharding import gather, place_like, tree_is_placed

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


def _move_codec(
    update: ModelUpdate,
    template,
    src_info: SliceInfo,
    dst_info: SliceInfo,
    dst_learner,
    mode: str,
    sent: Optional[list] = None,
) -> Optional[Tuple[dict, int]]:
    """int8/topk8 on the plane: device encode → one exchange → device
    decode against the receiver's anchor. ``(params, bytes moved)``, or
    None when the receiver's anchor is of another round (the caller falls
    back, and the byte path's AnchorMismatch skip applies). ``sent``, when
    given, receives the buffers handed to the exchange."""
    from p2pfl_tpu_torch.ops.compression import build_topk_plan, decode_shard_device, encode_shard_device
    from p2pfl_tpu_torch.settings import Settings

    # the codec runs on whole tensors: a sharded learner's placed leaves
    # are gathered on their slice's device (the decode is placed again by
    # the receiver's layout below)
    named = _gathered(update.params)
    anchor_named = _gathered(update.anchor) if update.anchor is not None else None
    topk_plan = build_topk_plan(named, anchor_named, Settings.TOPK_FRACTION if mode == "topk8" else 0.0)
    dst_anchor_named = None
    if topk_plan:
        # delta segments reconstruct against the receiver's anchor: both
        # ends must hold the same round's (their divergence is part of the
        # codec's loss, as on the byte path)
        dst_anchor, dst_tag = dst_learner.wire_anchor()
        if dst_anchor is None or dst_tag != update.anchor_tag:
            return None
        dst_anchor_named = _gathered(dst_anchor)

    # encode once per content: repeat sends reuse the device buffers, and
    # the residual folds once per content across both planes (whichever
    # encodes first owns the fold, PayloadCache.ef_fold_once)
    with update._encode_lock:
        cache = update.payload_cache
        key = None
        if cache is not None and update.cache_version is not None:
            key = ("ici", update.cache_version, update.cache_round, mode, update.anchor_tag,
                   update.ef_residual is not None)
            cached = cache.get(key)
        else:
            cached = getattr(update, "_ici_payload", None)
        if cached is None:
            residual = update.ef_residual
            if residual is not None and cache is not None and update.cache_version is not None:
                if not cache.ef_fold_once(update.ef_fold_key(mode)):
                    residual = None
            cached = encode_shard_device(named, anchor_named, topk_plan, residual)
            if key is not None:
                cache.put(key, cached)
            else:
                update._ici_payload = cached
    tk_spec, dense_spec, payload = cached

    coded = {k for k, _s, _b in tk_spec} | {k for k, _s in dense_spec}
    raw_keys = [k for k in sorted(named) if k not in coded]
    # one exchange: the codec buffers and the raw leaves together
    names = [f"c/{k}" for k in sorted(payload)] + [f"r/{k}" for k in raw_keys]
    srcs = [payload[n[2:]] for n in names if n[0] == "c"] + [named[k] for k in raw_keys]
    if sent is not None:
        sent.extend(srcs)
    if same_devices(src_info, dst_info):
        moved, landed = 0, srcs
    else:
        moved = sum(t.numel() * t.element_size() for t in srcs)
        landed = transfer_buffers(srcs, dst_info)
    by_name = dict(zip(names, landed))
    template_named = dict(named_leaves(template)[1])
    out = decode_shard_device(
        {n[2:]: t for n, t in by_name.items() if n[0] == "c"}, tk_spec, dense_spec, dst_anchor_named, template_named
    )
    for k in raw_keys:
        out[k] = by_name[f"r/{k}"]
    restored = tree_unflatten(out)
    if tree_is_placed(template):
        restored = place_like(restored, template)
    return restored, moved


def _gathered(tree) -> dict:
    """``{path: whole tensor}`` of a tree (a placed leaf gathered)."""
    return {k: gather(v) for k, v in named_leaves(tree)[1]}


def move_codec_against_bytes(
    update: ModelUpdate, template, src_info: SliceInfo, dst_info: SliceInfo, dst_learner, mode: str
) -> Tuple[dict, dict, int, list]:
    """One update through :func:`_move_codec` and through the byte path on
    the same inputs (``encode_params`` → ``decode_params`` against the
    receiver's anchor, then ``restore_like`` the template), for the checks
    that hold the two equal bit for bit. ``update`` carries no payload
    cache; its residual, if any, folds into both encodes (the byte path
    folds a copy taken first). The byte path must run the device producer
    (``settings.wire_compression_device``), as the plane always does.
    Returns ``(got, want, moved, srcs)``: both trees, the bytes the plane
    moved and the buffers it handed to the exchange."""
    from p2pfl_tpu_torch.learning.weights import decode_params, encode_params, restore_like
    from p2pfl_tpu_torch.settings import wire_compression_device

    leaves = tree_leaves(update.params)
    if not wire_compression_device(leaves[0].device):
        raise ValueError("the byte path must run the device producer to match the plane's encode")
    residual = None if update.ef_residual is None else {k: v.clone() for k, v in update.ef_residual.items()}
    anchor, tag = dst_learner.wire_anchor()
    srcs: list = []
    out = _move_codec(update, template, src_info, dst_info, dst_learner, mode, sent=srcs)
    if out is None:
        raise ValueError(f"the receiver's anchor {tag!r} is not the update's {update.anchor_tag!r}")
    got, moved = out
    frame = encode_params(update.params, compression=mode, anchor=update.anchor, anchor_tag=update.anchor_tag,
                          residual=residual)
    device = tree_leaves(template)[0].device
    want = restore_like(template, decode_params(frame, device, anchor=anchor, anchor_tag=tag))
    return got, want, moved, srcs


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
    if src_info.specs != dst_info.specs:
        # the payload's layout differs from the receiver's placement (a
        # tree laid out by other rules): slot p would not hold block p
        _fallback(src, nei, "spec_mismatch")
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
        if mode in ("int8", "topk8"):
            out = _move_codec(update, template, src_info, dst_info, dst_learner, mode)
            if out is None:
                _fallback(src, nei, "anchor_round_mismatch")
                return None
            params, moved = out
        elif same_devices(src_info, dst_info):
            # the tensors already lie where the receiver wants them: a
            # zero-copy handoff, the reference path's read-only contract
            moved, params = 0, update.params
        else:
            moved = tree_device_bytes(update.params)
            params = shard_transfer(update.params, template, src_info, dst_info)
    except Exception as exc:  # noqa: BLE001 — a failed transfer is a failed send
        logger.error(src, f"ICI shard transfer to {nei} failed: {exc!r}")
        return False

    # the receiver re-encodes relays against its own anchor, as after the
    # byte path's decode
    dst_anchor, dst_tag = dst_learner.wire_anchor()
    delivered = ModelUpdate(
        params,
        list(update.contributors),
        update.num_samples,
        xp=update.xp or env.xp,
        version=update.version,
        sp=src_ep.handshake(mode),
        anchor=dst_anchor,
        anchor_tag=dst_tag,
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
