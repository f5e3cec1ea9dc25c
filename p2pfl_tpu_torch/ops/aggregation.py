"""Aggregation kernels as torch ops (subset of ``p2pfl_tpu/ops/aggregation.py``).

Plain tensor code, as the JAX package left it to XLA: no hand kernel.
"""

from __future__ import annotations

import torch

from p2pfl_tpu_torch.ops.tree import tree_map


def fedavg(stacked: dict, weights: torch.Tensor, agg_dtype: str = "float32") -> dict:
    """Sample-weighted mean over the leading axis; ``weights`` [N] are
    unnormalized sample counts. Normalize, then one weighted contraction
    per leaf in ``agg_dtype``, cast back to the leaf's dtype."""
    acc = getattr(torch, agg_dtype)
    w = weights.to(acc)
    w = w / w.sum()
    return tree_map(
        lambda x: torch.tensordot(w.to(x.device), x.to(acc), dims=([0], [0])).to(x.dtype), stacked
    )
