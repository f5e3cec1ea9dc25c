"""The int8/topk8 wire codec's device producer (counterpart of
``p2pfl_tpu/ops/compression.py``).

The host producer (``learning/weights.py::_encode_host``) pulls every
tensor to numpy, argpartitions it and quantizes it in the native library.
This module is the other producer behind
``Settings.WIRE_COMPRESSION_DEVICE``: the same math as torch ops where the
params live, so on a card only the compressed ``(int32 idx, int8 q, fp32
scale)`` buffers cross to the host, and the error-feedback residual stays
on the card between rounds.

- The model is a sequence of flat fp32 segments with static sizes and
  budgets: :func:`split_codec_specs` gives ``(key, size, budget)`` per
  delta-coded tensor and ``(key, size)`` per dense-int8 one from the one
  eligibility predicate, :func:`build_topk_plan`, shared with the host
  producer and the ICI plane's codec (``communication/ici.py``).
- A delta segment is ``(params − anchor) + residual``; its top-k by
  magnitude is selected as ``jax.lax.top_k`` selects: every coordinate
  strictly above the k-th magnitude, then the lowest indices among those
  equal to it (:func:`topk_positions`; ``torch.topk`` breaks ties
  otherwise, even on the CPU). Positions ship ascending.
- Quantization is symmetric per segment: ``scale = absmax · fl(1/127)``
  (1.0 for an all-zero segment; the JAX package writes ``absmax / 127``,
  and XLA turns a division by a constant into that product), then
  ``q = clip(rint(v / scale), ±127)``, a true division (a CUDA kernel
  dividing by a host scalar multiplies by its reciprocal instead, so the
  divisor is a tensor on the params' device).
- The new residual is the delta with ``vals − q·scale`` written at the
  selected coordinates, rounded once (the fused multiply-add the JAX
  package's XLA:CPU program computes), taken exactly in fp64, so the
  card's residual equals the CPU's and JAX's bit for bit. It is written
  into the stored residual in place; an encode that raises drops the
  entries it took (:func:`_run_encode`).

Non-float leaves, bfloat16 included (numpy's dtype kind ``"V"``, as the
JAX package decides it), are neither delta-coded nor quantized: they ship
raw, as from the host producer. Both producers feed the same framing
(``learning/weights.py``), so one decoder reads either.
:func:`decode_tk8_device` is the consumer: dequantized deltas added onto
the receiver's anchor where it lives.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

#: torch dtypes of numpy kind "f" (bfloat16 is not one: JAX ships it raw)
_FLOAT_DTYPES = (torch.float16, torch.float32, torch.float64)


def topk_budget(size: int, topk_frac: float) -> int:
    """Per-tensor top-k budget, the host producer's formula."""
    return max(1, int(np.ceil(size * topk_frac)))


def leaf_size(leaf) -> int:
    """Element count of a leaf (1 for a scalar)."""
    shape = tuple(leaf.shape) if hasattr(leaf, "shape") else np.shape(leaf)
    return int(np.prod(shape, dtype=np.int64)) if shape else 1


def is_float_leaf(leaf) -> bool:
    """numpy dtype kind ``"f"``: float16/32/64, never bfloat16."""
    if isinstance(leaf, torch.Tensor):
        return leaf.dtype in _FLOAT_DTYPES
    return np.dtype(leaf.dtype).kind == "f"


def build_topk_plan(named: dict, anchor_named: Optional[dict], topk_frac: float) -> dict:
    """``{path: budget}`` of the delta-coded tensors: topk active, a float
    leaf, an anchor leaf at the same path, more than 16 elements. The one
    predicate of both producers and the ICI plane's codec."""
    if topk_frac <= 0.0 or anchor_named is None:
        return {}
    return {
        key: topk_budget(leaf_size(leaf), topk_frac)
        for key, leaf in named.items()
        if is_float_leaf(leaf) and key in anchor_named and leaf_size(leaf) > 16
    }


def split_codec_specs(named: dict, topk_plan: dict) -> tuple[list, tuple, tuple]:
    """Sorted keys and the static segment specs: ``tk_spec`` is
    ``(key, size, budget)`` per delta-coded tensor, ``dense_spec``
    ``(key, size)`` per dense-int8 float tensor; other leaves ship raw."""
    keys = sorted(named)
    tk_spec: list = []
    dense_spec: list = []
    for key in keys:
        leaf = named[key]
        if not is_float_leaf(leaf):
            continue
        if key in topk_plan:
            tk_spec.append((key, leaf_size(leaf), topk_plan[key]))
        else:
            dense_spec.append((key, leaf_size(leaf)))
    return keys, tuple(tk_spec), tuple(dense_spec)


# ---- the encode ----


def topk_positions(mags: torch.Tensor, k: int) -> torch.Tensor:
    """Ascending int64 positions of the ``k`` largest of the 1-D ``mags``,
    ties at the k-th value going to the lowest indices (``jax.lax.top_k``'s
    set). Deterministic on the CPU and on a card, and without a host sync:
    the selected coordinates are ranked by a cumulative sum and scattered
    into ``k`` slots (every unselected one into a discarded slot ``k``)."""
    n = mags.numel()
    dev = mags.device
    if k >= n:
        return torch.arange(n, dtype=torch.int64, device=dev)
    kth = torch.topk(mags, k, sorted=False).values.min()
    above = mags > kth
    tied = mags == kth
    need = k - above.sum()
    sel = above | (tied & (torch.cumsum(tied, 0) <= need))
    slot = torch.where(sel, torch.cumsum(sel, 0) - 1, k)
    out = torch.empty(k + 1, dtype=torch.int64, device=dev)
    out.scatter_(0, slot, torch.arange(n, dtype=torch.int64, device=dev))
    return out[:k]


#: fp32 1/127: the product XLA computes for the JAX package's ``x / 127``
_INV_127 = np.float32(1.0) / np.float32(127.0)


def _scale_of(absmax: torch.Tensor) -> torch.Tensor:
    """``absmax · fl(1/127)`` in fp32, 1.0 for an all-zero segment."""
    inv = torch.tensor(_INV_127, dtype=torch.float32, device=absmax.device)
    return torch.where(absmax > 0, absmax * inv, torch.ones_like(absmax))


def _quantize(vals: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(vals / scale), -127, 127).to(torch.int8)


def _quantize_seg(vals: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 of one flat fp32 segment: ``(q, scale)``."""
    if vals.numel() == 0:
        return vals.to(torch.int8), torch.ones((), dtype=torch.float32, device=vals.device)
    scale = _scale_of(vals.abs().max())
    return _quantize(vals, scale), scale


def _flat_f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, device=device).reshape(-1).to(torch.float32)


def _encode_tk(leaf, anchor, res: Optional[torch.Tensor], budget: int, want_res: bool):
    """One delta segment: ``(idx int32, q int8, scale, new residual or None)``.
    ``res`` (flat fp32 on the leaf's device), when given, receives the
    delta and then the new residual in place."""
    dev = leaf.device
    delta = _flat_f32(leaf, dev) - _flat_f32(anchor, dev)
    if res is not None:
        # r + (p − a) has the bits of (p − a) + r: fp32 addition commutes
        d = res.add_(delta)
    else:
        d = delta
    mags = d.abs()
    scale = _scale_of(mags.max())
    pos = topk_positions(mags, budget)
    vals = d[pos]
    q = _quantize(vals, scale)
    new_res = None
    if want_res:
        # vals − q·scale rounded once, as the JAX package's program computes
        # it (XLA contracts it into a fused multiply-add): in fp64 the
        # product (8 × 24 bits) and the difference (operands within a few
        # binades) are exact, so the one rounding to fp32 is the FMA's on
        # any device, whatever the compiler contracts
        err = (vals.to(torch.float64) - q.to(torch.float64) * scale.to(torch.float64)).to(torch.float32)
        d.index_copy_(0, pos, err)
        new_res = d
    return pos.to(torch.int32), q, scale, new_res


def _run_encode(
    named: dict,
    anchor_named: Optional[dict],
    tk_spec: tuple,
    dense_spec: tuple,
    residual: Optional[dict],
) -> dict:
    """Every segment's encode, and the residual written back.

    ``{"tk": (idx, q, scales), "dense": (dq, dscales)}`` as concatenated
    tensors on the params' device (keys present only for non-empty
    specs). The residual store is updated in place; an encode that raises
    drops every delta segment's entry (a taken buffer may be half written,
    a new one belongs to a failed encode), so the next encode restarts
    those carries from zero."""
    out: dict = {}
    try:
        if tk_spec:
            idx_parts, q_parts, scales = [], [], []
            for key, _size, budget in tk_spec:
                leaf = named[key]
                res = None
                if residual is not None and key in residual:
                    # a flat fp32 carry on the leaf's device is a view of
                    # the stored buffer (written in place); any other is
                    # converted once and replaced below
                    res = _flat_f32(residual[key], leaf.device)
                idx, q, scale, new_res = _encode_tk(leaf, anchor_named[key], res, budget, residual is not None)
                if residual is not None:
                    residual[key] = new_res
                idx_parts.append(idx)
                q_parts.append(q)
                scales.append(scale)
            out["tk"] = (torch.cat(idx_parts), torch.cat(q_parts), torch.stack(scales))
        if dense_spec:
            dq_parts, dscales = [], []
            for key, _size in dense_spec:
                leaf = named[key]
                q, scale = _quantize_seg(_flat_f32(leaf, leaf.device))
                dq_parts.append(q)
                dscales.append(scale)
            out["dense"] = (torch.cat(dq_parts), torch.stack(dscales))
    except Exception:
        if residual is not None:
            for key, _size, _budget in tk_spec:
                residual.pop(key, None)
        raise
    return out


def _named_tensors(named: dict, device) -> dict:
    """Leaves as tensors: stray numpy leaves are uploaded once."""
    return {k: v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v), device=device)
            for k, v in named.items()}


def _device_of(named: dict):
    return next((v.device for v in named.values() if isinstance(v, torch.Tensor)), torch.device("cpu"))


def encode_device(
    named: dict,
    anchor_named: Optional[dict],
    topk_plan: dict,
    residual: Optional[dict],
) -> tuple[list, int]:
    """The device producer: per-tensor wire plans from torch ops where the
    params live, for the ``int8``/``topk8`` modes (every float leaf off the
    topk plan is dense int8).

    Returns ``(plans, d2h_bytes)``, ``plans`` being ``[(entry, buffers)]``
    in sorted-key order with the host producer's entry and byte layout,
    ready for ``learning/weights.py``'s framing. ``residual`` (when given)
    is updated in place with flat fp32 carries on the params' device.
    ``d2h_bytes`` counts every byte materialized on the host: the
    compressed buffers and the raw passthrough leaves."""
    from p2pfl_tpu_torch.learning.weights import _dtype_name, _host_array

    dev = _device_of(named)
    tensors = _named_tensors(named, dev)
    anchors = _named_tensors(anchor_named, dev) if anchor_named is not None else None
    keys, tk_spec, dense_spec = split_codec_specs(tensors, topk_plan)
    outs = _run_encode(tensors, anchors, tk_spec, dense_spec, residual)

    d2h = 0
    idx_np = q_np = scales_np = None
    if tk_spec:
        idx_np, q_np, scales_np = (t.cpu().numpy() for t in outs["tk"])
        d2h += idx_np.nbytes + q_np.nbytes + scales_np.nbytes
    qd_np = scales_d_np = None
    if dense_spec:
        qd_np, scales_d_np = (t.cpu().numpy() for t in outs["dense"])
        d2h += qd_np.nbytes + scales_d_np.nbytes

    plans = []
    tk_of = {k: (i, b) for i, (k, _s, b) in enumerate(tk_spec)}
    dense_of = {k: i for i, (k, _s) in enumerate(dense_spec)}
    tk_off = dense_off = 0
    for key in keys:
        leaf = tensors[key]
        entry = {"k": key, "shape": list(leaf.shape), "dtype": _dtype_name(leaf)}
        if key in tk_of:
            i, budget = tk_of[key]
            idx = idx_np[tk_off : tk_off + budget].view(np.uint32)
            q = q_np[tk_off : tk_off + budget]
            entry["enc"] = "tk8"
            entry["scale"] = float(scales_np[i])
            entry["nnz"] = int(budget)
            plans.append((entry, (idx.tobytes(), q.tobytes())))
            tk_off += budget
        elif key in dense_of:
            size = leaf_size(leaf)
            entry["enc"] = "i8"
            entry["scale"] = float(scales_d_np[dense_of[key]])
            plans.append((entry, (qd_np[dense_off : dense_off + size].tobytes(),)))
            dense_off += size
        else:
            arr, _name, _pulled = _host_array(leaf)
            raw = arr.tobytes()
            d2h += len(raw)
            plans.append((entry, (raw,)))
    return plans, d2h


# ---- the decode ----


def _scatter_add(anchor: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """``anchor + scatter(vals)`` as a fresh flat fp32 tensor (the anchor is
    never written). Indices are unique, so one gather, add and scatter."""
    flat = anchor.reshape(-1).to(torch.float32, copy=True)
    flat.index_copy_(0, idx, flat[idx] + vals)
    return flat


def decode_tk8_device(items: list) -> dict:
    """The consumer of a payload's ``tk8`` entries, where the anchor lives.

    ``items`` is ``[(key, anchor_leaf, idx_u32, vals_f32, shape, dtype)]``:
    the validated (strictly ascending, in range) indices and the
    already-dequantized values as numpy arrays, the anchor a tensor, the
    dtype a torch dtype. Returns ``{key: anchor + scatter(vals)}`` in each
    entry's shape and dtype, on the anchor's device."""
    out = {}
    for key, anchor, idx, vals, shape, dtype in items:
        dev = anchor.device
        idx_t = torch.from_numpy(np.asarray(idx, np.int64)).to(dev)
        vals_t = torch.from_numpy(np.ascontiguousarray(vals, np.float32)).to(dev)
        out[key] = _scatter_add(anchor, idx_t, vals_t).reshape(shape).to(dtype)
    return out


# ---- the ICI plane's codec: payloads that stay on the device ----


def encode_shard_device(
    named: dict,
    anchor_named: Optional[dict],
    topk_plan: dict,
    residual: Optional[dict],
) -> tuple[tuple, tuple, dict]:
    """The encode with nothing copied to the host: ``(tk_spec, dense_spec,
    payload)``, ``payload`` mapping ``"idx"``/``"q"``/``"scales"`` (delta
    segments) and ``"dq"``/``"dscales"`` (dense int8) to tensors on the
    params' device, the buffers :func:`decode_shard_device` consumes on
    the receiver's slot. Non-float leaves belong to neither spec (the
    caller moves them raw). ``residual`` as in :func:`encode_device`."""
    dev = _device_of(named)
    tensors = _named_tensors(named, dev)
    anchors = _named_tensors(anchor_named, dev) if anchor_named is not None else None
    _keys, tk_spec, dense_spec = split_codec_specs(tensors, topk_plan)
    outs = _run_encode(tensors, anchors, tk_spec, dense_spec, residual)
    payload: dict = {}
    if tk_spec:
        payload["idx"], payload["q"], payload["scales"] = outs["tk"]
    if dense_spec:
        payload["dq"], payload["dscales"] = outs["dense"]
    return tk_spec, dense_spec, payload


def decode_shard_device(
    payload: dict,
    tk_spec: tuple,
    dense_spec: tuple,
    anchor_named: Optional[dict],
    template_named: dict,
) -> dict:
    """The mirror of :func:`encode_shard_device` on the receiver: delta
    segments added onto the receiver's anchor, dense segments dequantized
    (``q·scale`` in fp32, the byte decoder's product), each output in its
    ``template_named`` leaf's shape and dtype, on the payload's device."""
    out: dict = {}
    off = 0
    for i, (key, _size, budget) in enumerate(tk_spec):
        tmpl = template_named[key]
        seg = payload["idx"][off : off + budget].to(torch.int64)
        vals = payload["q"][off : off + budget].to(torch.float32) * payload["scales"][i]
        out[key] = _scatter_add(anchor_named[key], seg, vals).reshape(tmpl.shape).to(tmpl.dtype)
        off += budget
    off = 0
    for i, (key, size) in enumerate(dense_spec):
        tmpl = template_named[key]
        seg = payload["dq"][off : off + size].to(torch.float32) * payload["dscales"][i]
        out[key] = seg.reshape(tmpl.shape).to(tmpl.dtype)
        off += size
    return out
