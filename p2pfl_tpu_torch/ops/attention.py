"""Dense causal attention: the ``"dense"`` backend of the port.

Counterpart of ``p2pfl_tpu/ops/attention.py::causal_attention``. Scores
and softmax are fp32 from input-dtype operands; the probabilities are cast
to the input dtype before the product with V, as in JAX. Ring attention
needs a sequence-sharded mesh and is not ported yet (ROADMAP).
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
    logits = torch.where(mask, logits, torch.tensor(NEG_INF, dtype=acc, device=q.device))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(acc), v.to(acc)).to(q.dtype)
