"""Weights containers (subset of ``p2pfl_tpu/learning/weights.py``).

:class:`ModelUpdate` is the unit of the partial-aggregation algebra: a
model (or an aggregate of models) with the contributors folded into it
and their total sample weight. On the in-memory transport and the ICI
weights plane it carries live tensors; nothing in the port serializes
it. The P2TW byte codec, the encode-once payload cache and the streaming
frames are ROADMAP A3/A4: ``Settings.MEMORY_WIRE_CODEC=True`` raises at
``Node.start``.

Tensors handed around in an update are never written in place: the
zero-copy paths (the memory transport's reference handoff, the ICI
plane's co-resident handoff) give the receiver the sender's own tensors,
the way JAX relies on immutable arrays.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

from p2pfl_tpu_torch.ops.tree import tree_items, tree_structure

Tree = Any


def named_leaves(tree: Tree):
    """``(structure, [(path key, leaf), ...])`` in leaf order — the one
    source of the ``/``-joined path-key scheme (flax leaf names)."""
    return tree_structure(tree), list(tree_items(tree))


@dataclass
class ModelUpdate:
    """A model (or partial aggregation of models) moving through the network.

    ``contributors`` is the set of node addresses whose local training is
    already folded into ``params``; ``num_samples`` their total sample
    weight. ``xp`` is the experiment identity (stamped by
    ``protocol.build_weights``); ``sp`` the shard-plane handshake
    ``(slice_shape, slice_index, codec)`` (``communication/ici.py``).
    """

    params: Tree
    contributors: list[str] = field(default_factory=list)
    num_samples: int = 1
    xp: Optional[str] = None
    sp: Optional[tuple] = None
