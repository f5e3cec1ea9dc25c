"""Weights containers and the P2TW wire codec (counterpart of
``p2pfl_tpu/learning/weights.py``).

:class:`ModelUpdate` is the unit of the partial-aggregation algebra: a
model (or an aggregate of models) with the contributors folded into it
and their total sample weight. On the in-memory transport and the ICI
weights plane it carries live tensors. Byte transports (gRPC, the memory
transport's ``MEMORY_WIRE_CODEC`` path) ship it in the JAX package's
self-describing P2TW format, byte for byte: a JSON header of named paths,
shapes and dtypes, then the raw little-endian buffers, under a CRC32C.
Names, not positions, match leaves, so a mismatched architecture raises
:class:`ModelNotMatchingError`; nothing is pickled. bfloat16 leaves are
written through ``t.view(torch.int16)`` under the dtype name
``"bfloat16"`` and read back the same way.

Large payloads also travel as a P2TC chunk stream (:func:`iter_chunked_payload`,
:class:`StreamDecoder`): the chunk bodies concatenate to exactly the
unary frame, every chunk carries its own CRC32C, and the receiver decodes
each leaf the moment its bytes complete.

Encode-once, send-many: gossip pushes one model version to many peers
over many ticks, so the learner attaches its :class:`PayloadCache` and
model version to every update it hands out and :meth:`ModelUpdate.encode`
keys the bytes on ``(model version, round, wire compression, producer,
anchor tag, error feedback?)``. The anchor tag is in the key because
topk8 bytes are deltas against one round's anchor; the error-feedback
flag isolates the one encode a round that folds (and writes) the
residual store, and :meth:`PayloadCache.ef_fold_once` gives that fold to
whichever plane (bytes or ICI) encodes the content first.

Compression (``Settings.WIRE_COMPRESSION``): ``"int8"`` quantizes every
float leaf symmetrically (``i8`` entries); ``"topk8"`` ships, for every
float leaf of more than 16 elements with an anchor, the top
``TOPK_FRACTION`` coordinates of ``params − anchor`` by magnitude as
(uint32 index, int8 value) pairs (``tk8`` entries) under the round's
``anchor_tag``, with error feedback through a residual store. Two
producers emit the same layout: the host one (numpy and the native
library, the JAX package's host producer byte for byte) and the device
one (``ops/compression.py``, torch ops where the params live, the JAX
package's device producer byte for byte); ``WIRE_COMPRESSION_DEVICE``
picks (``settings.wire_compression_device``). bfloat16 leaves ship raw
in both, as numpy's dtype kind decides it in the JAX package.

Devices: encoding pulls each leaf to the host with a synchronous
``.cpu()`` (it waits for the stream that wrote the params); decoding
lands every leaf on the device the caller names (the receiving learner's),
and a tk8 leaf on its anchor's device.

Tensors handed around in an update are never written in place: the
zero-copy paths (the memory transport's reference handoff, the ICI
plane's co-resident handoff) give the receiver the sender's own tensors,
the way JAX relies on immutable arrays.
"""

from __future__ import annotations

import json
import struct
import threading
from dataclasses import dataclass, field
from typing import Any, Optional, Union

import numpy as np
import torch

from p2pfl_tpu_torch.exceptions import AnchorMismatchError, DecodingParamsError, ModelNotMatchingError
from p2pfl_tpu_torch.ops.tree import tree_items, tree_structure, tree_unflatten

Tree = Any

# process-wide encode accounting: every real run of the encode pipeline
# counts, cache hits do not
_encode_lock = threading.Lock()
_encode_calls = 0
_wire_stats = {
    "raw_bytes": 0,        # bytes of the leaves encoded
    "payload_bytes": 0,    # framed bytes produced
    "d2h_bytes": 0,        # bytes pulled from a device to the host
    "host_encodes": 0,
    "device_encodes": 0,
    "stream_encodes": 0,
    # high-water mark (max, not sum) of any StreamDecoder's buffered bytes:
    # the receiver's bounded-memory claim, O(chunk + largest leaf)
    "stream_peak_scratch_bytes": 0,
}


def encode_call_count() -> int:
    """Total runs of the encode pipeline in this process."""
    with _encode_lock:
        return _encode_calls


def wire_stats() -> dict:
    """Process-wide wire-byte counters."""
    with _encode_lock:
        return dict(_wire_stats)


def reset_wire_stats() -> None:
    with _encode_lock:
        for k in _wire_stats:
            _wire_stats[k] = 0


class PayloadCache:
    """Content-addressed cache of encoded weight payloads (encode-once).

    A small FIFO-bounded map: keys are monotone (the model version only
    grows), so old entries die naturally. Unary entries hold the framed
    bytes; chunk entries (keys starting ``"chunks"``) hold the tuple of
    P2TC frames, so a streamed fan-out to K peers frames once. Hits and
    misses feed ``logger.get_comm_metrics``.
    """

    MAX_ENTRIES = 4

    def __init__(self, owner: str = "") -> None:
        self.owner = owner
        self._lock = threading.Lock()
        self._entries: "dict[tuple, object]" = {}
        # error-feedback fold ownership per content (ef_fold_once), apart
        # from _entries so markers never evict payloads
        self._ef_marks: "dict[tuple, None]" = {}
        self.hits = 0
        self.misses = 0

    def get(self, key: tuple) -> Optional[Any]:
        from p2pfl_tpu_torch.management.logger import logger

        with self._lock:
            cached = self._entries.get(key)
            if cached is not None:
                self.hits += 1
            else:
                self.misses += 1
        logger.log_comm_metric(self.owner, "encode_cache_hit" if cached is not None else "encode_cache_miss")
        return cached

    def peek(self, key: tuple) -> Optional[Any]:
        """:meth:`get` without accounting, for cross-flavour probes (a unary
        encode looking for a cached chunk list and back), which must not
        add a miss to the one a content is allowed."""
        with self._lock:
            return self._entries.get(key)

    def put(self, key: tuple, payload: Any) -> None:
        with self._lock:
            self._entries[key] = payload
            while len(self._entries) > self.MAX_ENTRIES:
                self._entries.pop(next(iter(self._entries)))

    def ef_fold_once(self, key: tuple) -> bool:
        """True exactly once per content key: the caller that gets True
        owns the error-feedback fold of that content; every later encoder
        of it (the other plane's, which caches under another key) encodes
        without the residual instead of folding the just-written carry
        again. Claimed through :meth:`ModelUpdate.ef_fold_key`."""
        with self._lock:
            if key in self._ef_marks:
                return False
            self._ef_marks[key] = None
            while len(self._ef_marks) > self.MAX_ENTRIES * 2:
                self._ef_marks.pop(next(iter(self._ef_marks)))
            return True


_MAGIC = b"P2TW"  # p2pfl-tpu weights
_VERSION = 1


def named_leaves(tree: Tree):
    """``(structure, [(path key, leaf), ...])`` in leaf order: the one
    source of the ``/``-joined path-key scheme (flax leaf names)."""
    return tree_structure(tree), list(tree_items(tree))


# ---- leaves to bytes and back ----

#: dtype names the decoder can hold in torch (numpy name → torch dtype);
#: "bfloat16" rides as int16 bits
_TORCH_DTYPES = {
    "bool": torch.bool, "uint8": torch.uint8, "int8": torch.int8, "int16": torch.int16,
    "int32": torch.int32, "int64": torch.int64, "float16": torch.float16, "bfloat16": torch.bfloat16,
    "float32": torch.float32, "float64": torch.float64, "complex64": torch.complex64,
    "complex128": torch.complex128,
    # unsigned widths beyond uint8, where this torch has them
    **{name: getattr(torch, name) for name in ("uint16", "uint32", "uint64") if hasattr(torch, name)},
}


def _host_array(leaf) -> tuple[np.ndarray, str, int]:
    """``(contiguous host array, dtype name, bytes pulled from a device)``.

    A tensor on a device comes to the host with a synchronous ``.cpu()``;
    bfloat16 is viewed as int16 (same bytes) and named ``"bfloat16"``.
    Other leaves (numpy arrays, Python scalars) go through ``np.asarray``
    as in the JAX package."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        d2h = t.numel() * t.element_size() if t.device.type != "cpu" else 0
        t = t.cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16", d2h
        if t.dtype not in _TORCH_DTYPES.values():
            raise ValueError(f"cannot encode a {t.dtype} leaf")
        arr = t.numpy()
        return arr, arr.dtype.name, d2h
    arr = np.ascontiguousarray(np.asarray(leaf))
    return arr, arr.dtype.name, 0


def _as_u8(arr: np.ndarray) -> memoryview:
    """Zero-copy uint8 view of a contiguous array's bytes: the frame and
    chunk writers make the one copy into the outgoing frame."""
    return memoryview(arr.reshape(-1).view(np.uint8))


def _dtype_name(leaf) -> str:
    """The numpy name of a leaf's dtype (``"bfloat16"`` for torch's)."""
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).replace("torch.", "")
    return np.dtype(leaf.dtype).name


def anchor_digest(tree: Tree) -> int:
    """CRC32C over a tree's buffers in canonical (sorted path) order."""
    from p2pfl_tpu_torch import native

    flat = {key: _host_array(leaf)[0] for key, leaf in named_leaves(tree)[1]}
    crc = 0
    for key in sorted(flat):
        crc = native.crc32c(_as_u8(flat[key]), crc)
    return crc


def _store_size(x) -> Optional[int]:
    if isinstance(x, torch.Tensor):
        return x.numel()
    return getattr(x, "size", None)


def _validate_residual(residual: Optional[dict], eligible_sizes: dict) -> None:
    """Drop stale error-feedback entries in place before an encode: a key
    that is not delta-coded this encode (a mode flip, a lost anchor, a
    tensor under the size floor), or whose stored size no longer matches
    its tensor (a changed architecture), would otherwise re-enter stale
    or break the encode."""
    if residual is None:
        return
    for key in list(residual):
        size = eligible_sizes.get(key)
        if size is None or _store_size(residual[key]) != size:
            del residual[key]


def _host_f32(x) -> np.ndarray:
    """A leaf, anchor or stored residual as a host fp32 array (a carry the
    device producer left on a card comes over once)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).cpu().numpy()
    return np.asarray(x, dtype=np.float32)


def _encode_host(
    named: dict,
    compression: Optional[str],
    anchor_named: Optional[dict],
    topk_plan: dict,
    residual: Optional[dict],
) -> tuple[list, int]:
    """The host producer: per leaf in sorted path order, its header entry
    and its bytes as zero-copy views. ``topk_plan`` (``{path: budget}``)
    says which leaves are delta-coded (``tk8``: ``np.argpartition``'s top-k
    of ``params − anchor (+ residual)``, the native quantize, the residual
    written back); under ``int8``/``topk8`` every other float leaf is
    ``i8``, and the rest ship raw. The JAX package's host producer, byte
    for byte. Returns ``(plans, d2h_bytes)``."""
    from p2pfl_tpu_torch import native
    from p2pfl_tpu_torch.ops.compression import is_float_leaf

    plans = []
    d2h = 0
    for key in sorted(named):
        arr, dtype_name, pulled = _host_array(named[key])
        d2h += pulled
        entry = {"k": key, "shape": list(arr.shape), "dtype": dtype_name}
        if key in topk_plan:
            anchor_leaf = anchor_named[key]
            anchor_arr = _host_f32(anchor_leaf)
            if isinstance(anchor_leaf, torch.Tensor) and anchor_leaf.device.type != "cpu":
                d2h += anchor_arr.nbytes
            delta = _host_f32(named[key]).ravel() - anchor_arr.ravel()
            if residual is not None and key in residual:
                delta = delta + _host_f32(residual[key])
            k = topk_plan[key]
            idx = np.argpartition(np.abs(delta), -k)[-k:].astype(np.uint32)
            idx.sort()
            vals = delta[idx]
            q, scale = native.quantize(vals)
            if residual is not None:
                # error feedback: what this payload does not carry (dropped
                # coordinates and quantization error) feeds the next round
                sent = np.zeros_like(delta)
                sent[idx] = native.dequantize(q, scale)
                residual[key] = delta - sent
            bufs = (_as_u8(idx), _as_u8(q))
            entry["enc"] = "tk8"
            entry["scale"] = scale
            entry["nnz"] = int(k)
        elif compression in ("int8", "topk8") and is_float_leaf(named[key]):
            q, scale = native.quantize(_host_f32(named[key]))
            bufs = (_as_u8(q),)
            entry["enc"] = "i8"
            entry["scale"] = scale
        else:
            bufs = (_as_u8(arr),)
        plans.append((entry, bufs))
    return plans, d2h


def _frame_parts(plans: list, anchor_tag: Optional[str] = None) -> tuple[bytes, list]:
    """``(prefix, buffers)`` of the framed payload: ``prefix`` is the unary
    frame's magic + header length + JSON header, ``buffers`` the per-leaf
    byte views in entry order; their concatenation IS the unary payload,
    which makes chunk streams byte-compatible with unary frames. A frame
    with a ``tk8`` entry carries ``anchor_tag`` in its header."""
    from p2pfl_tpu_torch import native

    entries = []
    buffers = []
    crc = 0
    for entry, bufs in plans:
        entry["n"] = sum(len(b) for b in bufs)
        for b in bufs:
            crc = native.crc32c(b, crc)
            buffers.append(b)
        entries.append(entry)
    head = {"v": _VERSION, "t": entries, "crc": crc}
    if any(e.get("enc") == "tk8" for e in entries):
        head["anchor_tag"] = anchor_tag if anchor_tag is not None else ""
    header = json.dumps(head).encode("utf-8")
    prefix = bytearray(8 + len(header))
    prefix[0:4] = _MAGIC
    struct.pack_into("<I", prefix, 4, len(header))
    prefix[8:] = header
    return bytes(prefix), buffers


def _frame(plans: list, anchor_tag: Optional[str] = None) -> bytes:
    """One preallocated frame: the payload bytes are written once."""
    prefix, buffers = _frame_parts(plans, anchor_tag)
    out = bytearray(len(prefix) + sum(len(b) for b in buffers))
    out[0 : len(prefix)] = prefix
    off = len(prefix)
    for b in buffers:
        out[off : off + len(b)] = b
        off += len(b)
    return bytes(out)


# ---- chunk stream framing (the streaming byte plane) ----

_CHUNK_MAGIC = b"P2TC"  # p2pfl-tpu chunk
#: the header chunk carries the unary frame's prefix, data chunks carry
#: consecutive payload slabs, the end chunk the expected chunk count
CHUNK_HEADER, CHUNK_DATA, CHUNK_END = 0, 1, 2
_CHUNK_OVERHEAD = 17  # magic(4) + type(1) + seq(4) + body length(4) + crc32c(4)
_MIN_CHUNK_BYTES = 64 * 1024


def _chunk_bytes_setting() -> int:
    from p2pfl_tpu_torch.settings import Settings

    return max(int(Settings.WIRE_CHUNK_MB * 1024 * 1024), _MIN_CHUNK_BYTES)


def _chunk(ctype: int, seq: int, body) -> bytes:
    from p2pfl_tpu_torch import native

    n = len(body)
    out = bytearray(_CHUNK_OVERHEAD + n)
    out[0:4] = _CHUNK_MAGIC
    out[4] = ctype
    struct.pack_into("<III", out, 5, seq, n, native.crc32c(body, 0))
    out[_CHUNK_OVERHEAD:] = body
    return bytes(out)


def parse_stream_chunk(frame) -> tuple[int, int, memoryview, int]:
    """``(type, seq, body, body_crc)`` of one self-delimiting chunk, after
    checking its magic, framed length and CRC32C; raises
    :class:`DecodingParamsError` on any violation."""
    from p2pfl_tpu_torch import native

    mv = memoryview(frame)
    if len(mv) < _CHUNK_OVERHEAD or bytes(mv[:4]) != _CHUNK_MAGIC:
        raise DecodingParamsError("bad chunk magic — not a p2pfl_tpu stream chunk")
    ctype = mv[4]
    seq, n, crc = struct.unpack_from("<III", mv, 5)
    body = mv[_CHUNK_OVERHEAD:]
    if len(body) != n:
        raise DecodingParamsError(f"chunk {seq}: body {len(body)} bytes != framed {n}")
    if native.crc32c(body, 0) != crc:
        raise DecodingParamsError(f"chunk {seq}: CRC mismatch — corrupted in flight")
    if ctype not in (CHUNK_HEADER, CHUNK_DATA, CHUNK_END):
        raise DecodingParamsError(f"chunk {seq}: unknown chunk type {ctype}")
    return ctype, seq, body, crc


def _gen_chunks(prefix: bytes, buffers, chunk_bytes: int):
    """Yield ``(prefix, buffers)`` as stream chunks, one at a time. Header
    and data bodies concatenate to exactly ``prefix + b"".join(buffers)``;
    cuts are leaf-aligned whenever the next buffer fits a fresh slab, and
    larger buffers are split. A generator, so framing overlaps the wire."""
    from p2pfl_tpu_torch import native

    yield _chunk(CHUNK_HEADER, 0, prefix)
    seq = 1
    pending: list = []
    pending_n = 0

    def _flush() -> bytes:
        nonlocal pending, pending_n, seq
        frame = bytearray(_CHUNK_OVERHEAD + pending_n)
        frame[0:4] = _CHUNK_MAGIC
        frame[4] = CHUNK_DATA
        off = _CHUNK_OVERHEAD
        for piece in pending:
            frame[off : off + len(piece)] = piece
            off += len(piece)
        crc = native.crc32c(memoryview(frame)[_CHUNK_OVERHEAD:], 0)
        struct.pack_into("<III", frame, 5, seq, pending_n, crc)
        seq += 1
        pending, pending_n = [], 0
        return bytes(frame)

    for b in buffers:
        mv = b if isinstance(b, memoryview) else memoryview(b)
        if pending_n and pending_n + len(mv) > chunk_bytes and len(mv) <= chunk_bytes:
            yield _flush()
        while len(mv) > 0:
            take = min(len(mv), chunk_bytes - pending_n)
            pending.append(mv[:take])
            pending_n += take
            mv = mv[take:]
            if pending_n >= chunk_bytes:
                yield _flush()
    if pending_n:
        yield _flush()
    yield _chunk(CHUNK_END, seq, json.dumps({"n": seq}).encode("utf-8"))


def iter_chunked_payload(payload: bytes, chunk_bytes: Optional[int] = None):
    """Lazily cut an already-framed unary payload into stream chunks
    (leaf-aligned through the header's entry sizes). The frame is checked
    before the first yield, so a malformed payload raises at call time."""
    if chunk_bytes is None:
        chunk_bytes = _chunk_bytes_setting()
    mv = memoryview(payload)
    if bytes(mv[:4]) != _MAGIC:
        raise DecodingParamsError("bad magic — not a p2pfl_tpu weights payload")
    (hlen,) = struct.unpack("<I", mv[4:8])
    header = json.loads(bytes(mv[8 : 8 + hlen]).decode("utf-8"))
    prefix = bytes(mv[: 8 + hlen])
    buffers = []
    off = 8 + hlen
    for e in header["t"]:
        n = int(e["n"])
        if off + n > len(payload):
            raise DecodingParamsError(f"truncated payload at {e['k']}")
        buffers.append(mv[off : off + n])
        off += n
    if off != len(payload):
        raise DecodingParamsError("payload longer than its header declares")
    return _gen_chunks(prefix, buffers, chunk_bytes)


def chunk_encoded_payload(payload: bytes, chunk_bytes: Optional[int] = None) -> list[bytes]:
    """Materialized :func:`iter_chunked_payload` (the cache stores lists)."""
    return list(iter_chunked_payload(payload, chunk_bytes))


def payload_from_chunks(chunks) -> bytes:
    """The unary frame rebuilt from a P2TC chunk list."""
    out = bytearray()
    for frame in chunks:
        ctype, _, body, _ = parse_stream_chunk(frame)
        if ctype != CHUNK_END:
            out += body
    return bytes(out)


# ---- encode ----


def encode_params(
    tree: Tree,
    compression: Optional[str] = None,
    anchor: Optional[Tree] = None,
    anchor_tag: Optional[str] = None,
    residual: Optional[dict] = None,
    owner: Optional[str] = None,
) -> bytes:
    """Serialize a tree to the P2TW frame, byte-identical to the JAX
    package's for the same leaves, mode and producer.

    ``compression`` (default ``Settings.WIRE_COMPRESSION``): ``"none"``,
    ``"int8"`` or ``"topk8"``. Under topk8 the eligible leaves are
    delta-coded against ``anchor`` (the round-start global model) and the
    frame carries ``anchor_tag`` (the round identity ``"epoch:round"``);
    without an anchor every float leaf falls back to dense int8.
    ``residual`` (a mutable ``{path: flat fp32}`` dict) turns on error
    feedback: the mass a round drops re-enters the next round's delta.
    Stale residual entries are dropped first (:func:`_validate_residual`).
    The device producer (``ops/compression.py``) runs when
    ``settings.wire_compression_device`` says so for the params' device,
    else the host producer. ``owner`` (the node address) routes the
    per-node wire-byte counters into ``logger.get_comm_metrics``;
    process-wide totals are always kept."""
    plans, named, d2h, producer = _encode_plans(tree, compression, anchor, residual)
    payload = _frame(plans, anchor_tag)
    _account_encode(named, len(payload), d2h, producer, owner)
    return payload


def encode_params_chunked(
    tree: Tree,
    compression: Optional[str] = None,
    anchor: Optional[Tree] = None,
    anchor_tag: Optional[str] = None,
    residual: Optional[dict] = None,
    owner: Optional[str] = None,
    chunk_bytes: Optional[int] = None,
) -> list[bytes]:
    """:func:`encode_params` emitted as P2TC chunk frames; the unary frame
    is never built (the sender holds one copy of the payload, as chunks)."""
    if chunk_bytes is None:
        chunk_bytes = _chunk_bytes_setting()
    plans, named, d2h, producer = _encode_plans(tree, compression, anchor, residual)
    prefix, buffers = _frame_parts(plans, anchor_tag)
    chunks = list(_gen_chunks(prefix, buffers, chunk_bytes))
    _account_encode(named, len(prefix) + sum(len(b) for b in buffers), d2h, producer, owner, streamed=True)
    return chunks


def _leaves_device(named: dict):
    return next((v.device for v in named.values() if isinstance(v, torch.Tensor)), None)


def _encode_plans(
    tree: Tree, compression: Optional[str], anchor: Optional[Tree], residual: Optional[dict]
) -> tuple[list, dict, int, str]:
    """The pipeline behind both entry points: producer selection and the
    per-tensor plans. ``(plans, named, d2h_bytes, producer)``."""
    from p2pfl_tpu_torch.ops.compression import build_topk_plan, leaf_size
    from p2pfl_tpu_torch.settings import Settings, wire_compression_device

    global _encode_calls
    with _encode_lock:
        _encode_calls += 1
    if compression is None:
        compression = Settings.WIRE_COMPRESSION
    if compression not in ("none", "int8", "topk8"):
        raise ValueError(f"unknown wire compression {compression!r}")
    from p2pfl_tpu_torch.parallel.sharding import gather_tree

    topk_frac = Settings.TOPK_FRACTION if compression == "topk8" else 0.0
    # a sharded learner's placed leaves go on the wire whole
    named = dict(named_leaves(gather_tree(tree))[1])
    anchor_named = dict(named_leaves(gather_tree(anchor))[1]) if anchor is not None else None
    topk_plan = build_topk_plan(named, anchor_named, topk_frac)
    _validate_residual(residual, {key: leaf_size(named[key]) for key in topk_plan})
    device = _leaves_device(named)
    if compression in ("int8", "topk8") and device is not None and wire_compression_device(device):
        from p2pfl_tpu_torch.ops.compression import encode_device

        plans, d2h = encode_device(named, anchor_named, topk_plan, residual)
        return plans, named, d2h, "device"
    plans, d2h = _encode_host(named, compression, anchor_named, topk_plan, residual)
    return plans, named, d2h, "host"


def _leaf_nbytes(leaf) -> int:
    if isinstance(leaf, torch.Tensor):
        return leaf.numel() * leaf.element_size()
    return np.asarray(leaf).nbytes


def _account_encode(
    named: dict, payload_len: int, d2h: int, producer: str, owner: Optional[str], streamed: bool = False
) -> None:
    raw_bytes = sum(_leaf_nbytes(leaf) for leaf in named.values())
    with _encode_lock:
        _wire_stats["raw_bytes"] += raw_bytes
        _wire_stats["payload_bytes"] += payload_len
        _wire_stats["d2h_bytes"] += d2h
        _wire_stats[f"{producer}_encodes"] += 1
        if streamed:
            _wire_stats["stream_encodes"] += 1
    if owner:
        from p2pfl_tpu_torch.management.logger import logger

        logger.log_comm_metric(owner, "wire_raw_bytes", raw_bytes)
        logger.log_comm_metric(owner, "wire_payload_bytes", payload_len)
        logger.log_comm_metric(owner, "wire_d2h_bytes", d2h)
        logger.log_comm_metric(owner, f"wire_encode_{producer}")


# ---- decode ----

Device = Union[str, torch.device, None]


def _leaf_meta(e: dict) -> tuple[torch.dtype, int]:
    """Check one header entry against its byte length; ``(torch dtype,
    element count)``. Shared by the unary and the streaming decoder (one
    decoder core)."""
    dtype = _TORCH_DTYPES.get(e["dtype"])
    if dtype is None:
        raise DecodingParamsError(f"{e['k']}: dtype {e['dtype']!r} has no torch counterpart")
    count = int(np.prod(e["shape"], dtype=np.int64)) if e["shape"] else 1
    enc = e.get("enc")
    if enc == "tk8":
        expect = int(e["nnz"]) * 5  # uint32 index + int8 value a coordinate
    elif enc == "i8":
        expect = count
    elif enc is None:
        expect = count * dtype.itemsize
    else:
        raise DecodingParamsError(f"{e['k']}: unknown encoding {enc!r}")
    if e["n"] != expect:
        raise DecodingParamsError(f"inconsistent header for {e['k']}: n={e['n']} vs shape {e['shape']}")
    return dtype, count


def _decode_dense_leaf(e: dict, buf, device: Device) -> torch.Tensor:
    """One raw or ``i8`` leaf from exactly its ``e['n']`` bytes, as a
    tensor on ``device``. A read-only source (a slice of received
    ``bytes``) is copied once on the host; a writable one (the stream
    decoder's per-leaf buffer) is wrapped. Either copy to a card is
    synchronous, so the source outlives it. tk8 leaves never come here:
    they need the anchor."""
    from p2pfl_tpu_torch import native

    dtype, count = _leaf_meta(e)
    if e.get("enc") == "i8":
        q = np.frombuffer(buf, dtype=np.int8, count=count)
        arr = native.dequantize(q, float(e["scale"])).astype(np.dtype(e["dtype"]))
        t = torch.from_numpy(arr)
    else:
        np_dtype = np.int16 if dtype == torch.bfloat16 else np.dtype(e["dtype"])
        arr = np.frombuffer(buf, dtype=np_dtype, count=count)
        if not arr.flags.writeable:
            arr = arr.copy()
        t = torch.from_numpy(arr)
        if dtype == torch.bfloat16:
            t = t.view(torch.bfloat16)
    t = t.reshape(e["shape"])
    return t if device is None else t.to(device)


def decode_params(
    payload: bytes, device: Device = None, anchor: Optional[Tree] = None, anchor_tag: Optional[str] = None
) -> dict[str, torch.Tensor]:
    """Decode a P2TW frame to ``{path: tensor}`` on ``device`` (the CPU when
    None). Checks the magic, version, every entry against its byte length,
    and the CRC; any malformed payload raises :class:`DecodingParamsError`.

    A delta-coded (``tk8``) frame needs an ``anchor`` whose round identity
    ``anchor_tag`` equals the header's, else :class:`AnchorMismatchError`:
    reconstructing against another round's model would be silently wrong.
    Its indices must be strictly ascending and in range (both producers
    emit them so). A tk8 leaf is ``anchor + scatter(q·scale)``: on the
    anchor's device by ``ops/compression.py::decode_tk8_device`` when
    ``settings.wire_compression_device`` says so for that device (after
    the CRC verifies), else on the host; either lands it as the anchor
    leaf's device and the frame's dtype say (the host result on
    ``device``)."""
    try:
        mv = memoryview(payload)
        if bytes(mv[:4]) != _MAGIC:
            raise DecodingParamsError("bad magic — not a p2pfl_tpu weights payload")
        (hlen,) = struct.unpack("<I", mv[4:8])
        header = json.loads(bytes(mv[8 : 8 + hlen]).decode("utf-8"))
        if header["v"] != _VERSION:
            raise DecodingParamsError(f"unsupported weights version {header['v']}")
        from p2pfl_tpu_torch import native
        from p2pfl_tpu_torch.settings import wire_compression_device

        anchor_flat = None
        if "anchor_tag" in header:
            if anchor is None:
                raise AnchorMismatchError("payload is delta-coded (topk8) but no anchor is available")
            if (anchor_tag or "") != header["anchor_tag"]:
                raise AnchorMismatchError(
                    f"anchor round mismatch (local {anchor_tag!r} != payload "
                    f"{header['anchor_tag']!r}) — sender delta-coded against a "
                    "different round's model"
                )
            from p2pfl_tpu_torch.parallel.sharding import gather_tree

            # a sharded learner's anchor: its placed leaves whole
            anchor_flat = dict(named_leaves(gather_tree(anchor))[1])

        off = 8 + hlen
        crc = 0
        for e in header["t"]:
            _leaf_meta(e)
            if off + e["n"] > len(payload):
                raise DecodingParamsError(f"truncated payload at {e['k']}")
            crc = native.crc32c(mv[off : off + e["n"]], crc)
            off += e["n"]
        if "crc" in header and header["crc"] != crc:
            raise DecodingParamsError(f"CRC mismatch: payload corrupted ({crc} != {header['crc']})")

        flat = {}
        deferred: list = []  # tk8 leaves reconstructed where their anchor lives
        off = 8 + hlen
        for e in header["t"]:
            dtype, count = _leaf_meta(e)
            if e.get("enc") != "tk8":
                flat[e["k"]] = _decode_dense_leaf(e, mv[off : off + e["n"]], device)
                off += e["n"]
                continue
            nnz = int(e["nnz"])
            if anchor_flat is None or e["k"] not in anchor_flat:
                raise AnchorMismatchError(f"no anchor tensor for delta-coded {e['k']}")
            idx = np.frombuffer(payload, dtype=np.uint32, count=nnz, offset=off)
            q = np.frombuffer(payload, dtype=np.int8, count=nnz, offset=off + nnz * 4)
            if nnz and int(idx.max()) >= count:
                raise DecodingParamsError(f"index out of range in {e['k']}")
            if nnz > 1 and np.any(np.diff(idx.astype(np.int64)) <= 0):
                raise DecodingParamsError(f"duplicate or unsorted indices in {e['k']}")
            anchor_leaf = anchor_flat[e["k"]]
            # both consumers: a scatter past the anchor's end would raise on
            # the host and trap the card's context (every co-resident node)
            size = anchor_leaf.numel() if isinstance(anchor_leaf, torch.Tensor) else np.size(anchor_leaf)
            if size != count:
                raise ModelNotMatchingError(f"anchor leaf {e['k']} has {size} elements, frame {count}")
            vals = native.dequantize(q, float(e["scale"]))
            if isinstance(anchor_leaf, torch.Tensor) and wire_compression_device(anchor_leaf.device):
                deferred.append((e["k"], anchor_leaf, idx, vals, tuple(e["shape"]), dtype))
            else:
                dense = _host_f32(anchor_leaf).ravel().copy()
                dense[idx] = dense[idx] + vals
                t = torch.from_numpy(dense).reshape(e["shape"]).to(dtype)
                flat[e["k"]] = t if device is None else t.to(device)
            off += e["n"]
        if deferred:
            from p2pfl_tpu_torch.ops.compression import decode_tk8_device

            flat.update(decode_tk8_device(deferred))
        return flat
    except (DecodingParamsError, AnchorMismatchError):
        raise
    except Exception as exc:  # noqa: BLE001 — any malformed payload is a decode error
        raise DecodingParamsError(str(exc)) from exc


class StreamDecoder:
    """Incremental decoder of one ``P2TC`` chunk stream.

    Feed frames in order with :meth:`feed`. Each raw or ``i8`` leaf is
    decoded onto ``device`` the moment its bytes complete, so the receiver
    holds at most one chunk frame and one open leaf buffer
    (``peak_scratch_bytes``) instead of the model. A delta-coded stream
    (its header carries ``anchor_tag``) needs the receiver's anchor, which
    the transport does not hold: the decoder then reassembles the unary
    frame byte for byte (:meth:`result_payload`, about 0.25 bytes a
    parameter) for :func:`decode_params` at materialize time. Every chunk's CRC is checked on arrival and
    folded into the header's whole-payload CRC with
    :func:`~p2pfl_tpu_torch.native.crc32c_combine` (no second pass over
    the bytes), which is verified at the end chunk with the chunk count
    and the per-leaf byte totals. Any violation raises
    :class:`DecodingParamsError`: the caller drops the stream as ONE
    failed transfer.
    """

    def __init__(self, device: Device = None):
        self._device = device
        self._expect_seq = 0
        self.header: Optional[dict] = None
        self._entries: list = []
        self._entry_idx = 0
        self._leaf_buf: Optional[bytearray] = None
        self._leaf_fill = 0
        self._crc = 0
        self._flat: dict = {}
        self._reassemble: Optional[bytearray] = None
        self._done = False
        self.chunks = 0
        self.payload_bytes = 0
        #: high-water mark of bytes held at once (chunk frame + open leaf)
        self.peak_scratch_bytes = 0

    @property
    def complete(self) -> bool:
        return self._done

    @property
    def reassembled(self) -> bool:
        return self._reassemble is not None

    def feed(self, frame) -> None:
        ctype, seq, body, crc = parse_stream_chunk(frame)
        if self._done:
            raise DecodingParamsError("chunk after end-of-stream")
        if seq != self._expect_seq:
            raise DecodingParamsError(f"out-of-order chunk: seq {seq}, expected {self._expect_seq}")
        self._expect_seq += 1
        self.chunks += 1
        if ctype == CHUNK_HEADER:
            self._start(body)
        elif ctype == CHUNK_DATA:
            self._data(body, crc)
        else:  # parse_stream_chunk admits only the three known types
            self._finish(body)
        held = self._reassemble if self._reassemble is not None else self._leaf_buf
        scratch = len(frame) + (len(held) if held is not None else 0)
        self.peak_scratch_bytes = max(self.peak_scratch_bytes, scratch)

    def _start(self, body) -> None:
        if self.header is not None:
            raise DecodingParamsError("duplicate stream header chunk")
        if bytes(body[:4]) != _MAGIC:
            raise DecodingParamsError("bad magic in stream header chunk")
        (hlen,) = struct.unpack("<I", body[4:8])
        if len(body) != 8 + hlen:
            raise DecodingParamsError("stream header chunk length mismatch")
        header = json.loads(bytes(body[8:]).decode("utf-8"))
        if header["v"] != _VERSION:
            raise DecodingParamsError(f"unsupported weights version {header['v']}")
        self.header = header
        self._entries = header["t"]
        for e in self._entries:
            _leaf_meta(e)  # check every entry before any bytes land
        if "anchor_tag" in header or any(e.get("enc") == "tk8" for e in self._entries):
            self._reassemble = bytearray(body)
        else:
            self._advance_leaf()

    def _advance_leaf(self) -> None:
        # zero-size leaves carry no bytes: complete them at once
        while self._entry_idx < len(self._entries):
            e = self._entries[self._entry_idx]
            if e["n"] == 0:
                self._flat[e["k"]] = _decode_dense_leaf(e, bytearray(), self._device)
                self._entry_idx += 1
                continue
            self._leaf_buf = bytearray(e["n"])
            self._leaf_fill = 0
            return
        self._leaf_buf = None

    def _data(self, body, crc: int) -> None:
        if self.header is None:
            raise DecodingParamsError("data chunk before stream header")
        from p2pfl_tpu_torch import native

        self._crc = native.crc32c_combine(self._crc, crc, len(body))
        self.payload_bytes += len(body)
        if self._reassemble is not None:
            self._reassemble += body
            return
        off, n = 0, len(body)
        while off < n:
            if self._leaf_buf is None:
                raise DecodingParamsError("payload bytes past the last leaf")
            e = self._entries[self._entry_idx]
            take = min(n - off, e["n"] - self._leaf_fill)
            self._leaf_buf[self._leaf_fill : self._leaf_fill + take] = body[off : off + take]
            self._leaf_fill += take
            off += take
            if self._leaf_fill == e["n"]:
                self._flat[e["k"]] = _decode_dense_leaf(e, self._leaf_buf, self._device)
                self._entry_idx += 1
                self._advance_leaf()

    def _finish(self, body) -> None:
        if self.header is None:
            raise DecodingParamsError("end chunk before stream header")
        try:
            declared = json.loads(bytes(body).decode("utf-8"))["n"]
        except (ValueError, KeyError, UnicodeDecodeError) as exc:
            raise DecodingParamsError(f"malformed end chunk: {exc}") from exc
        if declared != self._expect_seq - 1:
            raise DecodingParamsError(f"chunk count mismatch: end declares {declared}, saw {self._expect_seq - 1}")
        expect_bytes = sum(int(e["n"]) for e in self._entries)
        if self.payload_bytes != expect_bytes:
            raise DecodingParamsError(
                f"stream truncated: {self.payload_bytes} payload bytes, header declares {expect_bytes}"
            )
        if "crc" in self.header and self.header["crc"] != self._crc:
            raise DecodingParamsError(f"CRC mismatch: stream corrupted ({self._crc} != {self.header['crc']})")
        self._done = True
        with _encode_lock:
            _wire_stats["stream_peak_scratch_bytes"] = max(
                _wire_stats["stream_peak_scratch_bytes"], self.peak_scratch_bytes
            )

    def result_flat(self) -> dict:
        """The decoded ``{path: tensor}`` dict (streams without tk8)."""
        if not self._done:
            raise DecodingParamsError("stream incomplete")
        if self._reassemble is not None:
            raise DecodingParamsError("delta-coded stream has no eager flat result — use result_payload()")
        return self._flat

    def result_payload(self) -> bytes:
        """The reassembled unary frame (delta-coded streams only)."""
        if not self._done:
            raise DecodingParamsError("stream incomplete")
        if self._reassemble is None:
            raise DecodingParamsError("dense stream was leaf-decoded on arrival — use result_flat()")
        return bytes(self._reassemble)


def estimate_payload_bytes(update: "ModelUpdate") -> Optional[int]:
    """The encoded size of an update without encoding it (transports pick
    unary or streaming from it): exact when the bytes exist, else the
    leaves' bytes scaled by the wire compression (int8 a quarter, topk8
    with an anchor a twelfth, on the safe side of its density) plus header
    slack; None when nothing is known."""
    if update.encoded is not None:
        return len(update.encoded)
    if update.params is None:
        return None
    from p2pfl_tpu_torch.settings import Settings

    raw = sum(_leaf_nbytes(leaf) for _, leaf in named_leaves(update.params)[1])
    comp = Settings.WIRE_COMPRESSION
    if comp == "int8":
        raw //= 4
    elif comp == "topk8" and update.anchor is not None:
        raw //= 12
    return raw + 4096


def restore_like(template: Tree, flat: dict) -> Tree:
    """A tree of ``template``'s structure from a flat ``{path: tensor}``
    dict, each leaf on the device and in the dtype of its template leaf.
    Raises :class:`ModelNotMatchingError` on any structural mismatch."""
    tmpl = dict(named_leaves(template)[1])
    if set(tmpl) != set(flat):
        missing = set(tmpl) ^ set(flat)
        raise ModelNotMatchingError(f"param paths differ (symmetric diff: {sorted(missing)[:5]}...)")
    out = {}
    for key, leaf in tmpl.items():
        arr = flat[key]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ModelNotMatchingError(f"shape mismatch at {key}: {tuple(arr.shape)} vs {tuple(leaf.shape)}")
        out[key] = arr.to(device=leaf.device, dtype=leaf.dtype)
    return tree_unflatten(out)


@dataclass
class ModelUpdate:
    """A model (or partial aggregation of models) moving through the network.

    ``contributors`` is the set of node addresses whose local training is
    already folded into ``params``; ``num_samples`` their total sample
    weight. ``encoded`` holds the P2TW bytes on a byte transport (params
    None until the receiver decodes them); ``decoded_flat`` the leaves a
    streamed transfer decoded on arrival. ``xp`` (experiment identity),
    ``version`` (the async triple) and ``sp`` (the shard-plane handshake
    ``(slice_shape, slice_index, codec)``, ``communication/ici.py``) ride
    the wire as the optional header keys of ``wire_headers.py``.
    """

    params: Tree
    contributors: list[str] = field(default_factory=list)
    num_samples: int = 1
    encoded: Optional[bytes] = None
    #: a streamed transfer's ``{path: tensor}`` on the receiver's device;
    #: never serialized
    decoded_flat: Optional[dict] = None
    xp: Optional[str] = None
    version: Optional[tuple] = None
    sp: Optional[tuple] = None
    #: round identity of the delta-coding anchor, e.g. ``"1:3"``
    anchor_tag: Optional[str] = None
    #: the round-start global model topk8 delta-codes against; attached by
    #: the learner, inherited through aggregation, never serialized
    anchor: Optional[Tree] = None
    #: the error-feedback store (``{path: residual}``), set only on a
    #: node's own train-stage contribution so exactly one encode a round
    #: writes it
    ef_residual: Optional[dict] = None
    #: the round-start global kept by a failed secure-aggregation recovery
    #: (a no-op round): GossipModelStage never diffuses it. Never serialized
    noop_round: bool = False
    #: a finalized (self-mask-free) aggregate a peer diffused under double
    #: masking: set when AddModelCommand strips ``secagg.CLEAN_MARKER``
    secagg_clean: bool = False
    #: the node's own fused-round accumulator ``(psum, wsum)``:
    #: ``num_samples × params`` in ``Settings.AGG_DTYPE``, folded inside
    #: the fused round (``parallel/spmd.py::fused_node_round``), and the
    #: matching weight. Set only on a node's own train-stage contribution;
    #: FedAvg continues its fold from it. Never serialized.
    partial_acc: Optional[tuple] = None
    #: encode-once plumbing: the learner's cache and model version when
    #: this update was handed out; ``cache_round`` is stamped by
    #: ``protocol.build_weights``. Never serialized.
    payload_cache: Optional[PayloadCache] = None
    cache_version: Optional[int] = None
    cache_round: Optional[int] = None
    #: serializes encode(): the send fan-out may encode one instance from
    #: several worker threads, and an error-feedback encode writes the
    #: residual store, exactly once, under this lock
    _encode_lock: threading.Lock = field(default_factory=threading.Lock, repr=False, compare=False)

    def ef_fold_key(self, compression: str) -> tuple:
        """The one key by which every encoder of this content (the byte
        path here, the ICI plane in ``communication/ici.py``) claims the
        error-feedback fold (``PayloadCache.ef_fold_once``)."""
        return (self.cache_version, self.cache_round, compression, self.anchor_tag)

    def _cache_key(self) -> Optional[tuple]:
        """The unary payload's cache key, or None when not cacheable. The
        resolved producer is in it: device and host bytes decode alike but
        differ at quantization ties."""
        from p2pfl_tpu_torch.settings import Settings, wire_compression_device

        if self.payload_cache is None or self.cache_version is None:
            return None
        device = _leaves_device(dict(named_leaves(self.params)[1])) if self.params is not None else None
        return (
            self.cache_version,
            self.cache_round,
            Settings.WIRE_COMPRESSION,
            wire_compression_device(device),
            self.anchor_tag,
            self.ef_residual is not None,
        )

    def _owner(self) -> Optional[str]:
        return self.payload_cache.owner if self.payload_cache is not None else None

    def _fold_residual(self) -> Optional[dict]:
        """The residual this encode may fold: None when another plane's
        encode of the same content already owns the fold."""
        from p2pfl_tpu_torch.settings import Settings

        residual = self.ef_residual
        cache = self.payload_cache
        if residual is not None and cache is not None and self.cache_version is not None:
            if not cache.ef_fold_once(self.ef_fold_key(Settings.WIRE_COMPRESSION)):
                return None
        return residual

    def _encode_fresh(self) -> bytes:
        return encode_params(
            self.params, anchor=self.anchor, anchor_tag=self.anchor_tag,
            residual=self._fold_residual(), owner=self._owner(),
        )

    def encode(self) -> bytes:
        with self._encode_lock:
            return self._encode_locked()

    def _encode_locked(self) -> bytes:
        if self.encoded is not None:
            return self.encoded
        cache = self.payload_cache
        key = self._cache_key()
        if key is not None:
            cached = cache.get(key)
            if cached is not None:
                self.encoded = cached
                return cached
            chunked = cache.peek(("chunks", *key, _chunk_bytes_setting()))
            if chunked is not None:
                # a streamed send already encoded this content: its chunk
                # bodies concatenate to the unary frame
                self.encoded = payload_from_chunks(chunked)
                cache.put(key, self.encoded)
                return self.encoded
        self.encoded = self._encode_fresh()
        if key is not None:
            cache.put(key, self.encoded)
        return self.encoded

    def encode_chunks(self, chunk_bytes: Optional[int] = None) -> list:
        """The P2TC chunk list, with :meth:`encode`'s encode-once rules: the
        list is cached per content, and unary bytes already encoded are
        re-sliced instead of re-encoded (and back). The error-feedback fold
        is claimed through the same :meth:`ef_fold_key`."""
        cbytes = chunk_bytes if chunk_bytes is not None else _chunk_bytes_setting()
        with self._encode_lock:
            if self.encoded is not None:
                return chunk_encoded_payload(self.encoded, cbytes)
            cache = self.payload_cache
            key = self._cache_key()
            if key is not None:
                cached = cache.get(("chunks", *key, cbytes))
                if cached is not None:
                    return cached
                unary = cache.peek(key)
                if unary is not None:
                    chunks = chunk_encoded_payload(unary, cbytes)
                    cache.put(("chunks", *key, cbytes), chunks)
                    return chunks
            chunks = encode_params_chunked(
                self.params, anchor=self.anchor, anchor_tag=self.anchor_tag,
                residual=self._fold_residual(), owner=self._owner(), chunk_bytes=cbytes,
            )
            if key is not None:
                cache.put(("chunks", *key, cbytes), chunks)
            return chunks

    def iter_chunks(self, chunk_bytes: Optional[int] = None):
        """Chunk frames for ONE streamed send, framed lazily: only the encode
        (or the cache lookup) runs before this returns; the per-chunk copy
        and CRC run as the transport pulls frames. The finished list is
        cached, so a fan-out of the same content skips both."""
        cbytes = chunk_bytes if chunk_bytes is not None else _chunk_bytes_setting()
        with self._encode_lock:
            cache = self.payload_cache
            key = self._cache_key()
            if key is not None:
                cached = cache.get(("chunks", *key, cbytes))
                if cached is not None:
                    return iter(cached)
            payload = self.encoded
            if payload is None and key is not None:
                payload = cache.peek(key)
            if payload is None:
                payload = self._encode_fresh()
                self.encoded = payload
                if key is not None:
                    cache.put(key, payload)

        def _frames():
            collected = []
            for frame in iter_chunked_payload(payload, cbytes):
                collected.append(frame)
                yield frame
            if key is not None:
                cache.put(("chunks", *key, cbytes), collected)

        return _frames()

    @staticmethod
    def decode(payload: bytes, template: Tree, contributors: list[str], num_samples: int) -> "ModelUpdate":
        """Decode against ``template``: leaves land on its leaves' device."""
        device = named_leaves(template)[1][0][1].device
        return ModelUpdate(restore_like(template, decode_params(payload, device)), list(contributors), num_samples)
