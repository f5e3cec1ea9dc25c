"""ops of the PyTorch port (see the JAX package's module of the same path)."""

from p2pfl_tpu_torch.ops.tree import (
    tree_add,
    tree_allclose,
    tree_bytes,
    tree_num_params,
    tree_scale,
    tree_stack,
    tree_sub,
    tree_unstack,
    tree_weighted_mean,
    tree_zeros_like,
)

__all__ = [
    "tree_add",
    "tree_allclose",
    "tree_bytes",
    "tree_num_params",
    "tree_scale",
    "tree_stack",
    "tree_sub",
    "tree_unstack",
    "tree_weighted_mean",
    "tree_zeros_like",
]
