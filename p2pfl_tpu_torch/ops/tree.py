"""Nested-dict parameter trees: the port's stand-in for JAX pytrees.

Parameters are nested dicts of tensors keyed by the flax leaf names
(``layer_0/attn/wq/kernel`` is ``p["layer_0"]["attn"]["wq"]["kernel"]``),
so trees convert 1:1 with the JAX package's. Leaves are visited in
sorted-key order, which is also the order ``jax.tree.leaves`` uses for
dicts.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator

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
