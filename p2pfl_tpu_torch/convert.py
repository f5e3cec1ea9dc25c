"""Parameter trees between the JAX package and the port.

The port keeps flax's leaf names (``wq/kernel``, ``lora_a``, ``lora_b``,
``attn_norm/scale``, ``embed``, ...) and its ``[in, out]`` kernel layout,
so conversion is a 1:1 copy of leaves. Two JAX layouts exist for the
transformer: unrolled (``layer_{i}/...``) and scanned
(``layers/block/...`` with a leading ``[L]`` axis, ``scan_layers=True``).
The port always holds the unrolled one. The vision trees have a single
layout and convert leaf for leaf, dtypes kept: the MLP's
(``Dense_{i}/kernel`` as ``[in, out]``, ``Dense_{i}/bias``) and the
CNN's, whose conv leaves keep flax's HWIO kernels
(``Conv_{i}/kernel`` as ``[kh, kw, in, out]``, ``Conv_{i}/bias``; the
module permutes them at use). So a JAX ``mlp(seed)`` or ``cnn(seed)``
init loads into ``p2pfl_tpu_torch.models.vision`` unchanged.

The JAX side is plain nested dicts of numpy arrays
(``jax.tree.map(np.asarray, params)``); nothing here imports JAX.
:func:`placed_params_from_jax` places such a tree on a node slice by
partition rules, as a sharded JAX node holds it.
"""

from __future__ import annotations

import numpy as np
import torch

from p2pfl_tpu_torch import resolve_device
from p2pfl_tpu_torch.ops.tree import tree_leaves, tree_map

_SCANNED = ("layers", "block")


def _to_torch(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16: torch has no numpy route
        return torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def is_scanned(tree: dict) -> bool:
    return _SCANNED[0] in tree and _SCANNED[1] in tree[_SCANNED[0]]


def params_from_jax(tree: dict, device=None) -> dict:
    """JAX parameter tree (either layout) → the port's unrolled tree of
    tensors on ``device`` (``None`` = ``cuda``, as every entry point)."""
    device = resolve_device(device)
    out = {k: v for k, v in tree.items() if k != _SCANNED[0]}
    if is_scanned(tree):
        block = tree[_SCANNED[0]][_SCANNED[1]]
        n_layers = np.shape(tree_leaves(block)[0])[0]
        for i in range(n_layers):
            out[f"layer_{i}"] = tree_map(lambda a, i=i: np.asarray(a)[i], block)
    return tree_map(lambda a: _to_torch(a, device), out)


def placed_params_from_jax(tree: dict, mesh, rules=None) -> dict:
    """A JAX node's parameter tree (numpy, either layout) → the port's
    tree placed on the slice ``mesh`` by partition ``rules``
    (``parallel/sharding.py``; None: the transformer defaults): each leaf
    the rules shard as one shard a slot, the rest whole on the slice's
    first device. The same rules on JAX's slice give each device the
    block the port gives the slot at its position."""
    from p2pfl_tpu_torch.parallel.sharding import DEFAULT_TRANSFORMER_RULES, shard_tree

    params = params_from_jax(tree, device=mesh.devices.flat[0])
    return shard_tree(mesh, params, DEFAULT_TRANSFORMER_RULES if rules is None else rules)


def params_to_jax(params: dict, scan_layers: bool = False) -> dict:
    """The port's tree (placed leaves gathered) → nested dicts of numpy
    arrays in the JAX layout (``scan_layers=True``: stacked under
    ``layers/block``)."""
    from p2pfl_tpu_torch.parallel.sharding import gather_tree

    out = tree_map(_to_numpy, gather_tree(params))
    if not scan_layers:
        return out
    names = sorted((k for k in out if k.startswith("layer_")), key=lambda k: int(k[6:]))
    layers = [out.pop(k) for k in names]
    out[_SCANNED[0]] = {_SCANNED[1]: tree_map(lambda *xs: np.stack(xs), *layers)}
    return out

