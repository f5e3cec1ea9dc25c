"""Nested-dict parameter trees: the port's stand-in for JAX pytrees.

Parameters are nested dicts of tensors keyed by the flax leaf names
(``layer_0/attn/wq/kernel`` is ``p["layer_0"]["attn"]["wq"]["kernel"]``),
so trees convert 1:1 with the JAX package's. Leaves are visited in
sorted-key order, which is also the order ``jax.tree.leaves`` uses for
dicts.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Iterator

import torch

Tree = Any


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """Apply ``fn`` leafwise over trees of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    return fn(tree, *rest)


def tree_items(tree: Tree, prefix: str = "") -> Iterator[tuple[str, Any]]:
    """``(path, leaf)`` pairs with ``/``-joined paths, in sorted-key order."""
    for k in sorted(tree):
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(tree[k], dict):
            yield from tree_items(tree[k], path)
        else:
            yield path, tree[k]


def tree_leaves(tree: Tree) -> list:
    return [leaf for _, leaf in tree_items(tree)]


def tree_structure(tree: Tree) -> tuple:
    """The tree's leaf paths in leaf order: equal for two trees exactly
    when they have the same structure (``jax.tree.structure`` equality)."""
    return tuple(path for path, _ in tree_items(tree)) if isinstance(tree, dict) else ("",)


def tree_stack(trees: list) -> Tree:
    """Stack same-structure trees leafwise on a new leading axis."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


#: per-THREAD count of leaves :func:`tree_align_devices` had to move (a
#: consumer measures the delta around its own call, as in JAX)
_align = threading.local()


def tree_align_copy_count() -> int:
    """Leaves re-placed by :func:`tree_align_devices` on this thread."""
    return getattr(_align, "copies", 0)


def tree_align_devices(tree: Tree, like: Tree) -> Tree:
    """``tree`` with every leaf on the device of the matching leaf of
    ``like``; the input comes back untouched when nothing differs. Each
    moved leaf is counted (:func:`tree_align_copy_count`)."""
    pairs = list(zip(tree_leaves(tree), tree_leaves(like)))
    if all(a.device == b.device for a, b in pairs):
        return tree
    _align.copies = tree_align_copy_count() + sum(a.device != b.device for a, b in pairs)
    return tree_map(lambda a, b: a if a.device == b.device else a.to(b.device), tree, like)


def tree_unflatten(items: dict[str, Any]) -> Tree:
    """Inverse of :func:`tree_items`: ``{"a/b": x}`` → ``{"a": {"b": x}}``."""
    out: dict = {}
    for path, leaf in items.items():
        node = out
        *parents, last = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return out
