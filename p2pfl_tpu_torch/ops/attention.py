"""Dense causal attention and ring attention for long context.

Counterpart of ``p2pfl_tpu/ops/attention.py``. Scores and softmax are fp32
from input-dtype operands; the probabilities are cast to the input dtype
before the product with V, as in JAX.

Ring attention (Liu et al. 2023) shards the sequence over the ``model``
axis of a :class:`~p2pfl_tpu_torch.parallel.mesh.Mesh`: shard r lives on
the axis's device r, and K/V blocks travel one device along the ring per
hop while each shard merges what it sees with an online softmax. The port
runs the ring in one process: JAX's ``ppermute`` becomes ``Tensor.to`` of
the next device (a no-op when a mesh names one device R times), and
autograd's backward of that copy is the reverse ring, as ``shard_map``'s
is in JAX. Every hop is launched, fully masked ones included, as in JAX.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """Accumulation type: fp32 for 16/32-bit inputs, fp64 for fp64 inputs
    (gradcheck). Products of bf16 values are exact in fp32, so an fp32
    product of upcast operands is a bf16 product with fp32 accumulation."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def causal_attention(q, k, v, scale: Optional[float] = None) -> torch.Tensor:
    """q, k, v: [B, T, H, D] (GQA heads already repeated) → [B, T, H, D]."""
    b, t, h, d = q.shape
    scale = (d ** -0.5) if scale is None else scale
    acc = acc_dtype(q.dtype)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(acc), k.to(acc)) * scale
    mask = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
    # a scalar fill, not a host tensor: a CUDA graph capture (a captured
    # MoE round runs dense attention) refuses host-to-device copies
    logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(acc), v.to(acc)).to(q.dtype)


def _block_attend(q, k, v, q_off: int, k_off: int, scale: float, causal: bool):
    """One dense block: (numerator [B,Tq,H,D], denominator [B,H,Tq], running
    max [B,H,Tq]), all fp32, for q against one K/V block at global offsets."""
    tq, tk = q.shape[1], k.shape[1]
    acc = acc_dtype(q.dtype)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(acc), k.to(acc)) * scale
    if causal:
        q_pos = q_off + torch.arange(tq, device=q.device)
        k_pos = k_off + torch.arange(tk, device=q.device)
        mask = q_pos[:, None] >= k_pos[None, :]
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    # fully masked rows: exp(NEG_INF - NEG_INF) = 1 would pollute the denominator
    p = torch.where(m[..., None] <= NEG_INF / 2, torch.zeros_like(p), p)
    num = torch.einsum("bhqk,bkhd->bqhd", p.to(q.dtype).to(acc), v.to(acc)).to(q.dtype).to(acc)
    return num, p.sum(-1), m


def _as_bthd(w: torch.Tensor) -> torch.Tensor:
    """[B, H, T] row weights → [B, T, H, 1]."""
    return w.transpose(1, 2)[..., None]


def _dense_hop(state, q, kb, vb, q_off, k_off, scale, causal):
    """Merge one dense block into ``state = (acc, den, m)``."""
    acc, den, m = state
    num_i, den_i, m_i = _block_attend(q, kb, vb, q_off, k_off, scale, causal)
    m_new = torch.maximum(m, m_i)
    # rows where nothing is visible yet keep NEG_INF statistics
    alpha = torch.where(m <= NEG_INF / 2, torch.zeros_like(m), torch.exp(m - m_new))
    beta = torch.where(m_i <= NEG_INF / 2, torch.zeros_like(m_i), torch.exp(m_i - m_new))
    return acc * _as_bthd(alpha) + num_i * _as_bthd(beta), den * alpha + den_i * beta, m_new


def merge_lse(out, lse, ob, lb):
    """Log-sum-exp merge of one flash block ``(ob, lb)`` into the running
    ``(out [B,H,T,D] fp32, lse [B,H,T] fp32)``, the kernels' layout.
    NEG_INF is a finite sentinel, so rows are tested with
    ``<= NEG_INF / 2``, never isfinite; two sentinel rows merge to weights
    0 with finite gradients."""
    new = torch.logaddexp(lse, lb)
    wo = torch.where(lse <= NEG_INF / 2, torch.zeros_like(lse), torch.exp(lse - new))
    wn = torch.where(lb <= NEG_INF / 2, torch.zeros_like(lb), torch.exp(lb - new))
    return out * wo[..., None] + ob.to(out.dtype) * wn[..., None], new


def _ring_attention_sharded(qs, ks, vs, devices, causal: bool):
    """Dense ring body: ``qs[r]``/``ks[r]``/``vs[r]`` are shard r's
    [B, T_local, H, D] blocks on ``devices[r]``. Returns the output shards."""
    ring = len(qs)
    b, tl, h, d = qs[0].shape
    scale = d ** -0.5
    acc_t = acc_dtype(qs[0].dtype)
    states = [
        (torch.zeros((b, tl, h, d), dtype=acc_t, device=dev),
         torch.zeros((b, h, tl), dtype=acc_t, device=dev),
         torch.full((b, h, tl), NEG_INF, dtype=acc_t, device=dev))
        for dev in devices
    ]
    kb, vb = list(ks), list(vs)
    for i in range(ring):
        for my in range(ring):
            src = (my - i) % ring  # which shard this K/V block came from
            states[my] = _dense_hop(states[my], qs[my], kb[my], vb[my], my * tl, src * tl, scale, causal)
        if i + 1 < ring:
            kb, vb = _rotate(kb, devices), _rotate(vb, devices)
    return [(acc / den.clamp_min(1e-30).transpose(1, 2)[..., None]).to(q.dtype)
            for (acc, den, _), q in zip(states, qs)]


def _ring_flash_sharded(qs, ks, vs, devices, config):
    """Flash ring body: every hop runs the offset-aware flash kernel on the
    shard's Q against the incoming K/V shard (O(T_local·D) memory instead of
    the dense body's O(T_local²) logits) and merges by log-sum-exp.

    Each shard is transposed to the kernels' [B, H, T_local, D] once, so
    every hop of a shard reads (and saves for the backward) the same
    tensors, and its gradients sum in that layout before one transpose
    back. The running output and lse stay in that layout too, so hop merges
    never depend on the configured block shapes."""
    from p2pfl_tpu_torch.ops.flash_attention import FlashAttentionBlock

    ring = len(qs)
    dt = qs[0].dtype
    qs, kb, vb = ([x.transpose(1, 2).contiguous() for x in xs] for xs in (qs, ks, vs))
    b, h, tl, d = qs[0].shape
    acc_t = acc_dtype(dt)
    outs = [torch.zeros((b, h, tl, d), dtype=acc_t, device=dev) for dev in devices]
    lses = [torch.full((b, h, tl), NEG_INF, dtype=acc_t, device=dev) for dev in devices]
    for i in range(ring):
        for my in range(ring):
            src = (my - i) % ring
            ob, lb = FlashAttentionBlock.apply(qs[my], kb[my], vb[my], my * tl, src * tl, config)
            outs[my], lses[my] = merge_lse(outs[my], lses[my], ob, lb.to(acc_t))
        if i + 1 < ring:
            kb, vb = _rotate(kb, devices), _rotate(vb, devices)
    return [o.to(dt).transpose(1, 2) for o in outs]


def _rotate(blocks, devices):
    """``ppermute`` j → j+1 around the ring: device j+1 receives block j."""
    ring = len(blocks)
    return [blocks[(j - 1) % ring].to(devices[j]) for j in range(ring)]


def ring_attention(
    q, k, v, mesh, axis_name: str, causal: bool = True, impl: str = "dense",
    block: int = 128, flash_config=None,
) -> torch.Tensor:
    """Full-sequence attention with T sharded over ``axis_name`` of ``mesh``.

    q, k, v: [B, T, H, D] (T divisible by the axis size); the result comes
    back on q's device. ``impl="flash"`` runs each hop through the
    offset-aware flash kernels (causal only); ``flash_config`` pins their
    schedule, and ``block`` is the square-block shorthand used without one.
    The ring uses the axis's devices at index 0 of every other mesh axis.
    """
    if impl not in ("dense", "flash"):
        raise ValueError(f"unknown ring impl {impl!r} (dense|flash)")
    if impl == "flash" and not causal:
        raise ValueError("impl='flash' supports causal attention only")
    devices = mesh.axis_devices(axis_name)
    ring = len(devices)
    t = q.shape[1]
    if t % ring:
        raise ValueError(f"T={t} is not divisible by the {axis_name!r} axis size {ring}")
    tl = t // ring

    def shards(x):
        return [x[:, r * tl:(r + 1) * tl].to(dev) for r, dev in enumerate(devices)]

    qs, ks, vs = shards(q), shards(k), shards(v)
    if impl == "flash":
        from p2pfl_tpu_torch.ops.flash_attention import FlashConfig

        config = flash_config or FlashConfig(block_q=min(block, tl), block_k=min(block, tl))
        outs = _ring_flash_sharded(qs, ks, vs, devices, config)
    else:
        outs = _ring_attention_sharded(qs, ks, vs, devices, causal)
    return torch.cat([o.to(q.device) for o in outs], dim=1)
