"""Partition-rule engine: regex rules over named trees → per-slot shards
(counterpart of ``p2pfl_tpu/parallel/sharding.py``).

Model (and optimizer) state placement is driven by a *rule set*: an
ordered list of ``(path regex, axis spec)`` pairs matched against each
leaf's ``/``-joined tree path, **first match wins**. Axis specs name
LOGICAL axes (``"model"``, ``"data"``, ``"nodes"``) which resolve to the
mesh axis names in :class:`~p2pfl_tpu_torch.settings.Settings` when a spec
is built, so a rule set is independent of the mesh's layout. The port
keeps flax's leaf names and ``[in, out]`` kernels (``convert.py``), so the
rules and specs mean what they mean in JAX.

Contract (:func:`check_partition_rules`, run at construction, so a typo'd
regex fails at startup instead of silently replicating a large tensor):

- every non-scalar leaf path is matched by some rule (scalars always
  replicate);
- no dead rules: every rule is the winning (first) match for some path;
- every named axis of a winning spec exists in the target mesh.

Placement drops (replicates) an axis whose mesh size does not divide the
leaf dimension; the lint reports these as ``indivisible``.

A spec is a tuple with one entry a leading dimension (JAX's
``PartitionSpec`` as a tuple): ``None``, a mesh axis name, or a tuple of
axis names (the dimension split over their product, the first axis
major). ``()`` replicates.

**Placed leaves.** Torch tensors carry no sharding, so a leaf the rules
shard is a :class:`SlotSharded`: the slice mesh and spec
(:class:`SlotSharding`), the global shape and dtype, and one shard tensor
per slot of the mesh in slot order, each on its slot's device; slot ``p``
holds the block JAX's ``NamedSharding`` gives device ``p``
(:meth:`SlotSharding.shard_shape` is ``NamedSharding.shard_shape``). A
replicated leaf stays a plain tensor, on the slice's first device, so
every one-slot path is unchanged.

On one card every slot names ``cuda:0`` (``parallel/mesh.py``): the shards
are separate tensors on one device. A step computes on the gathered
tensors (:func:`gather_tree`, one same-device copy a leaf), splits the
gradients back into slot shards (:func:`split_like`, views) and steps the
optimizer shard by shard over the *shard-flat* tree (:func:`shard_flat`:
each placed leaf becomes ``{"#k": shard k}``), which an elementwise
optimizer (Adam, SGD) steps exactly as it steps the whole tensor.
Optimizer state needs no separate rules: its paths embed the param path
(``mu/layer_0/attn/wq/kernel``), and the rules use ``re.search``.

**Node-stacked state.** A federation of N nodes on a ``(nodes, ...)``
mesh places its ``[N, ...]`` leaves by the node-shifted spec
``(nodes, *spec)`` (:func:`node_stacked_shardings`): N/k nodes a row of
the nodes axis, the rules' axes one dimension to the right.
:func:`split_rows` cuts such a tree into its rows (each row's block on the
row's slots: a plain tensor where the row holds it whole, a
:class:`SlotSharded` on the row's slice where the rules split it) and
:func:`join_rows` puts rows back into the mesh's layout.
"""

from __future__ import annotations

import itertools
import math
import re
from dataclasses import dataclass, field
from typing import Any, Callable, Iterator, Optional, Sequence

import torch

from p2pfl_tpu_torch.analysis.findings import Finding, Severity
from p2pfl_tpu_torch.ops.tree import tree_map
from p2pfl_tpu_torch.parallel.mesh import Mesh
from p2pfl_tpu_torch.settings import Settings

Tree = Any

# One axis entry: None (replicate this dim), a logical axis name, or a
# tuple of logical axis names (shard one dim over several mesh axes).
AxisSpec = Optional[Any]
PartitionRules = Sequence[tuple[str, Sequence[AxisSpec]]]

# (path regex, spec): first match wins; paths look like
# "layer_0/attn/wq/kernel". LoRA params replicate (they are the federated
# unit). The trailing catch-all replicates everything else (norm scales,
# biases), explicit so the set satisfies the "every path matched" contract.
DEFAULT_TRANSFORMER_RULES: PartitionRules = (
    (r"lora_", ()),  # replicated
    (r"attn/(wq|wk|wv)/kernel", (None, "model")),  # column-parallel
    (r"attn/wo/kernel", ("model", None)),  # row-parallel
    (r"mlp/(w1|w3)/kernel", (None, "model")),  # column-parallel
    (r"mlp/w2/kernel", ("model", None)),  # row-parallel
    # expert parallelism: MoE expert stacks [E, ...] shard the expert axis;
    # the router replicates
    (r"mlp/router$", ()),
    (r"mlp/w[123]$", ("model", None, None)),
    (r"embed", ("model", None)),  # vocab-sharded embeddings
    (r".*", ()),  # everything else replicates
)

# Logical axis tokens → Settings attribute carrying the mesh axis name.
_LOGICAL_AXES = {
    "model": "MESH_MODEL_AXIS",
    "data": "MESH_DATA_AXIS",
    "nodes": "MESH_NODES_AXIS",
}

#: the key prefix of a slot's shard in a shard-flat tree
SLOT_KEY = "#"


def resolve_axis(token: AxisSpec) -> AxisSpec:
    """Logical axis token → concrete mesh axis name (tuples element-wise)."""
    if token is None:
        return None
    if isinstance(token, (tuple, list)):
        return tuple(resolve_axis(t) for t in token)
    return getattr(Settings, _LOGICAL_AXES.get(token, ""), token)


# ---- named trees: dicts, optimizer states (named tuples), tuples ----


def _children(tree) -> Optional[list]:
    """``[(name, child), ...]`` of a container, None for a leaf. Dicts in
    sorted-key order (``ops/tree.py``), named tuples by field name."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return list(zip(tree._fields, tree))
    if isinstance(tree, (tuple, list)):
        return [(str(i), x) for i, x in enumerate(tree)]
    return None


def _walk(tree, prefix: str = "") -> Iterator[tuple[str, Any]]:
    kids = _children(tree)
    if kids is None:
        yield prefix, tree
        return
    for name, child in kids:
        yield from _walk(child, f"{prefix}/{name}" if prefix else name)


def map_with_path(fn: Callable, tree, prefix: str = ""):
    """``fn(path, leaf)`` over every leaf, the containers rebuilt."""
    kids = _children(tree)
    if kids is None:
        return fn(prefix, tree)
    out = [map_with_path(fn, child, f"{prefix}/{name}" if prefix else name) for name, child in kids]
    if isinstance(tree, dict):
        return {k: v for (k, _), v in zip(kids, out)}
    if hasattr(tree, "_fields"):
        return type(tree)(*out)
    return type(tree)(out)


def named_paths(tree: Tree) -> list[tuple[str, Any]]:
    """``[(slash/joined/path, leaf), ...]`` for every leaf of ``tree``."""
    return list(_walk(tree))


def _is_scalar(leaf) -> bool:
    shape = tuple(getattr(leaf, "shape", ()))
    return len(shape) == 0 or math.prod(shape) == 1


def _match_one(rules: PartitionRules, path: str) -> Optional[int]:
    """Index of the first rule matching ``path`` (None = unmatched)."""
    for i, (pattern, _) in enumerate(rules):
        if re.search(pattern, path):
            return i
    return None


def _rule_spec(rules: PartitionRules, path: str, leaf, unmatched: list) -> tuple:
    if _is_scalar(leaf):
        return ()
    idx = _match_one(rules, path)
    if idx is None:
        unmatched.append(path)
        return ()
    return tuple(resolve_axis(a) for a in rules[idx][1])


def _raise_unmatched(unmatched: list) -> None:
    raise ValueError(
        f"no partition rule matches {len(unmatched)} path(s): {unmatched[:8]}"
        + (" …" if len(unmatched) > 8 else "")
        + " — add a rule (a trailing ('.*', ()) replicates the rest)"
    )


def match_partition_rules(rules: PartitionRules, tree: Tree, *, on_unmatched: str = "error") -> Tree:
    """Spec tree for ``tree`` under ``rules`` (first match wins): the
    tree's structure with a spec tuple a leaf.

    Scalar leaves (0-d or single-element) always get ``()``.
    ``on_unmatched``: ``"error"`` raises naming every unmatched path;
    ``"replicate"`` maps them to ``()``. Axis tokens resolve through
    ``Settings.MESH_*_AXIS`` at call time."""
    if on_unmatched not in ("error", "replicate"):
        raise ValueError(f"on_unmatched must be 'error'|'replicate', got {on_unmatched!r}")
    unmatched: list[str] = []
    specs = map_with_path(lambda path, leaf: _rule_spec(rules, path, leaf, unmatched), tree)
    if unmatched and on_unmatched == "error":
        _raise_unmatched(unmatched)
    return specs


@dataclass
class RuleLintReport:
    """Outcome of :func:`lint_partition_rules`; empty lists mean clean.

    ``unmatched``: non-scalar paths no rule matches. ``dead_rules``: rule
    patterns never the winning (first) match. ``unknown_axes``:
    ``(pattern, axis)`` pairs whose axis the mesh lacks. ``indivisible``:
    ``(path, axis)`` pairs whose axis size does not divide the leaf dim
    (placement replicates those). :meth:`findings` gives the same facts as
    the analyzer's :class:`~p2pfl_tpu_torch.analysis.findings.Finding`:
    error severity for the first three, info for ``indivisible``."""

    unmatched: list[str] = field(default_factory=list)
    dead_rules: list[str] = field(default_factory=list)
    unknown_axes: list[tuple[str, str]] = field(default_factory=list)
    indivisible: list[tuple[str, str]] = field(default_factory=list)

    def findings(self, path: str = "partition-rules") -> list[Finding]:
        """One :class:`Finding` a fact; ``path`` labels the rule set's
        source (rules are data: line and column are 0)."""

        def make(rule: str, message: str, severity: Severity = Severity.ERROR) -> Finding:
            return Finding(rule=rule, path=path, line=0, col=0, message=message, severity=severity)

        out = [make("partition-unmatched", f"unmatched path: {p}") for p in self.unmatched]
        out += [make("partition-dead-rule", f"dead rule (never first match): {r!r}") for r in self.dead_rules]
        out += [
            make("partition-unknown-axis", f"rule {r!r} names axis {a!r} not in the mesh")
            for r, a in self.unknown_axes
        ]
        out += [
            make("partition-indivisible", f"axis {a!r} does not divide {p!r} — leaf replicates", Severity.INFO)
            for p, a in self.indivisible
        ]
        return out

    @property
    def errors(self) -> list[str]:
        return [f.message for f in self.findings() if f.severity is Severity.ERROR]

    def ok(self) -> bool:
        return not self.errors


def lint_partition_rules(rules: PartitionRules, tree: Tree, mesh: Optional[Mesh] = None) -> RuleLintReport:
    """Check ``rules`` against ``tree``'s named paths (and ``mesh``):
    unmatched paths, dead rules, unknown axes; ``indivisible`` is
    informational. Divisibility is against the PRODUCT of a dimension's
    mesh axes, what placement divides by."""
    report = RuleLintReport()
    wins: set[int] = set()
    for path, leaf in named_paths(tree):
        idx = _match_one(rules, path)
        if _is_scalar(leaf):
            # a rule whose only matches are size-1 leaves is still live
            if idx is not None:
                wins.add(idx)
            continue
        if idx is None:
            report.unmatched.append(path)
            continue
        wins.add(idx)
        if mesh is None:
            continue
        shape = tuple(getattr(leaf, "shape", ()))
        for dim, token in enumerate(rules[idx][1]):
            axis = resolve_axis(token)
            if axis is None:
                continue
            group = axis if isinstance(axis, tuple) else (axis,)
            known = [ax for ax in group if ax in mesh.shape]
            for ax in group:
                if ax not in mesh.shape:
                    report.unknown_axes.append((rules[idx][0], ax))
            size = math.prod(mesh.shape[ax] for ax in known)
            if known and (dim >= len(shape) or shape[dim] % size != 0):
                report.indivisible.append((path, ax if len(group) == 1 else "+".join(group)))
    report.dead_rules = [pat for i, (pat, _) in enumerate(rules) if i not in wins]
    report.unknown_axes = list(dict.fromkeys(report.unknown_axes))
    return report


def check_partition_rules(
    rules: PartitionRules, tree: Tree, mesh: Optional[Mesh] = None, *, allow_dead: bool = False
) -> RuleLintReport:
    """:func:`lint_partition_rules`, raising ``ValueError`` on any error.
    ``allow_dead=True`` skips the dead-rule check (the built-in default
    set is wider than any one model by design)."""
    report = lint_partition_rules(rules, tree, mesh)
    errors = report.errors
    if allow_dead:
        errors = [e for e in errors if not e.startswith("dead rule")]
    if errors:
        raise ValueError(
            "partition rule set fails lint:\n  " + "\n  ".join(errors[:16]) + ("\n  …" if len(errors) > 16 else "")
        )
    return report


# ---- shardings ----


@dataclass(frozen=True)
class SlotSharding:
    """A spec on a slice mesh: the port's ``NamedSharding``."""

    mesh: Mesh
    spec: tuple

    def _dim_axes(self) -> list[tuple]:
        return [() if a is None else (a if isinstance(a, tuple) else (a,)) for a in self.spec]

    def shard_shape(self, shape: Sequence[int]) -> tuple:
        """Each slot's block shape; a sharded dimension its mesh axes'
        product does not divide raises, as ``NamedSharding.shard_shape``."""
        out = list(shape)
        for dim, axes in enumerate(self._dim_axes()):
            if not axes:
                continue
            n = math.prod(self.mesh.shape[a] for a in axes)
            if out[dim] % n:
                raise ValueError(f"dimension {dim} of {tuple(shape)} is not divisible by {n} ({axes})")
            out[dim] //= n
        return tuple(out)

    def global_shape(self, block: Sequence[int]) -> tuple:
        """The whole shape whose slot blocks are ``block``."""
        out = list(block)
        for dim, axes in enumerate(self._dim_axes()):
            out[dim] *= math.prod(self.mesh.shape[a] for a in axes)
        return tuple(out)

    @property
    def is_fully_replicated(self) -> bool:
        return all(not axes or math.prod(self.mesh.shape[a] for a in axes) == 1 for axes in self._dim_axes())

    def block_slices(self, shape: Sequence[int]) -> list[tuple]:
        """Per slot (slot order: the mesh's positions row-major), the
        index slices of its block in the global tensor."""
        block = self.shard_shape(shape)
        names = self.mesh.axis_names
        out = []
        for coords in itertools.product(*(range(self.mesh.shape[a]) for a in names)):
            at = dict(zip(names, coords))
            idx = []
            for dim, axes in enumerate(self._dim_axes()):
                b = 0
                for a in axes:
                    b = b * self.mesh.shape[a] + at[a]
                idx.append(slice(b * block[dim], (b + 1) * block[dim]) if axes else slice(None))
            out.append(tuple(idx))
        return out

    @property
    def devices(self) -> list[torch.device]:
        return list(self.mesh.devices.flat)


class SlotSharded:
    """A leaf placed on a slice: one shard tensor per slot, in slot order.

    ``shape``, ``dtype`` and ``device`` describe the whole tensor (its
    first slot's device), so shape and structure checks read a placed leaf
    as a tensor. :meth:`full` gathers the whole tensor; the shards are
    never written in place (every step makes new ones)."""

    __slots__ = ("sharding", "shape", "dtype", "shards")

    def __init__(self, sharding: SlotSharding, shape, dtype: torch.dtype, shards: list) -> None:
        self.sharding = sharding
        self.shape = torch.Size(shape)
        self.dtype = dtype
        self.shards = list(shards)
        if len(self.shards) != sharding.mesh.devices.size:
            raise ValueError(f"{len(self.shards)} shards for a slice of {sharding.mesh.devices.size} slots")

    @property
    def mesh(self) -> Mesh:
        return self.sharding.mesh

    @property
    def spec(self) -> tuple:
        return self.sharding.spec

    @property
    def device(self) -> torch.device:
        return self.shards[0].device

    def numel(self) -> int:
        return math.prod(self.shape)

    def element_size(self) -> int:
        return self.shards[0].element_size()

    @property
    def nbytes(self) -> int:
        """Bytes held across the slots (replicated blocks count on each)."""
        return sum(s.numel() * s.element_size() for s in self.shards)

    @classmethod
    def place(cls, tensor: torch.Tensor, sharding: SlotSharding, copy: bool = True) -> "SlotSharded":
        """Split ``tensor`` into its slots' blocks, each on its slot's
        device (``copy=False`` keeps views where the device is the
        tensor's: the gradient split of a step)."""
        shards = []
        for idx, dev in zip(sharding.block_slices(tensor.shape), sharding.devices):
            block = tensor[idx]
            block = block.to(dev) if block.device != dev else block
            shards.append(block.clone(memory_format=torch.contiguous_format) if copy else block)
        return cls(sharding, tensor.shape, tensor.dtype, shards)

    def full(self) -> torch.Tensor:
        """The whole tensor on the first slot's device (a gather: each
        distinct block copied once)."""
        out = torch.empty(self.shape, dtype=self.dtype, device=self.device)
        seen = set()
        for idx, shard in zip(self.sharding.block_slices(self.shape), self.shards):
            key = tuple((s.start, s.stop) for s in idx)
            if key not in seen:
                seen.add(key)
                out[idx] = shard
        return out

    def with_shards(self, shards: list) -> "SlotSharded":
        return SlotSharded(self.sharding, self.shape, shards[0].dtype, shards)

    def __repr__(self) -> str:
        return f"SlotSharded(shape={tuple(self.shape)}, dtype={self.dtype}, spec={self.spec}, slots={len(self.shards)})"


def _register_pytree() -> None:
    """Let ``torch.utils._pytree`` see a placed leaf as its shards, so the
    CUDA-graph capture of a step and its state copies reach them."""
    from torch.utils import _pytree

    _pytree.register_pytree_node(
        SlotSharded,
        lambda x: (x.shards, (x.sharding, tuple(x.shape), x.dtype)),
        lambda shards, ctx: SlotSharded(ctx[0], ctx[1], ctx[2], list(shards)),
    )


_register_pytree()


def is_placed(leaf) -> bool:
    return isinstance(leaf, SlotSharded)


def tree_is_placed(tree: Tree) -> bool:
    """True when any leaf of ``tree`` is a :class:`SlotSharded`."""
    return any(is_placed(x) for _, x in _walk(tree))


def tree_shardings(
    mesh: Mesh, tree: Tree, rules: PartitionRules = DEFAULT_TRANSFORMER_RULES, *, on_unmatched: str = "error"
) -> Tree:
    """:class:`SlotSharding` tree placing ``tree`` on ``mesh`` per ``rules``.
    An axis whose size does not divide the leaf dim is dropped (that dim
    replicates); an axis the mesh lacks raises."""
    if on_unmatched not in ("error", "replicate"):
        raise ValueError(f"on_unmatched must be 'error'|'replicate', got {on_unmatched!r}")
    unmatched: list[str] = []

    def one(path, leaf):
        spec = _rule_spec(rules, path, leaf, unmatched)
        shape = tuple(getattr(leaf, "shape", ()))
        fixed = []
        for i, axis in enumerate(spec):
            if axis is None:
                fixed.append(None)
                continue
            axes = axis if isinstance(axis, tuple) else (axis,)
            for ax in axes:
                if ax not in mesh.shape:
                    raise ValueError(f"partition spec names axis {ax!r} not in the mesh (axes: {tuple(mesh.shape)})")
            size = math.prod(mesh.shape[ax] for ax in axes)
            fixed.append(axis if i < len(shape) and shape[i] % size == 0 else None)
        return SlotSharding(mesh, tuple(fixed))

    out = map_with_path(one, tree)
    if unmatched and on_unmatched == "error":
        _raise_unmatched(unmatched)
    return out


def place(leaf, sharding: SlotSharding):
    """One leaf in ``sharding``'s layout: a :class:`SlotSharded` where it
    shards, else the whole tensor on the slice's first device. A placed
    leaf of another layout is gathered first; one already in it is kept."""
    if is_placed(leaf):
        if leaf.sharding == sharding:
            return leaf
        leaf = leaf.full()
    if sharding.is_fully_replicated:
        dev = sharding.devices[0]
        return leaf if leaf.device == dev else leaf.to(dev)
    return SlotSharded.place(leaf, sharding)


def place_tree(tree: Tree, shardings: Tree) -> Tree:
    """Every leaf of ``tree`` placed by the matching sharding (:func:`place`)."""
    return tree_map(place, tree, shardings)


def shard_tree(
    mesh: Mesh, tree: Tree, rules: PartitionRules = DEFAULT_TRANSFORMER_RULES, *, on_unmatched: str = "error"
) -> Tree:
    """Place ``tree`` onto ``mesh`` per ``rules``."""
    return place_tree(tree, tree_shardings(mesh, tree, rules, on_unmatched=on_unmatched))


def place_like(tree: Tree, like: Tree) -> Tree:
    """``tree`` in the layout of ``like`` (a placed tree of the same
    structure): the port's ``conform_specs`` for trees that came from
    elsewhere (a byte path's decode, another slice's layout)."""
    return tree_map(
        lambda x, ref: place(x, ref.sharding) if is_placed(ref)
        else (x.full() if is_placed(x) else x).to(ref.device), tree, like,
    )


def gather(leaf):
    return leaf.full() if is_placed(leaf) else leaf


def gather_tree(tree: Tree) -> Tree:
    """Whole tensors for every placed leaf; an unplaced tree is returned
    as it is."""
    if not tree_is_placed(tree):
        return tree
    return tree_map(gather, tree)


def split_like(tree: Tree, like: Tree) -> Tree:
    """Whole tensors → views of their blocks wherever ``like`` is placed
    (a step's gradients into the params' slot shards)."""
    return tree_map(lambda x, ref: SlotSharded.place(x, ref.sharding, copy=False) if is_placed(ref) else x, tree, like)


def shard_flat(tree: Tree) -> Tree:
    """The shard-flat form: each placed leaf becomes ``{"#k": shard k}``.
    Trees of one placement have one shard-flat structure, so any
    tensor-tree function (an elementwise optimizer step, a fold) runs on
    it shard by shard."""
    return tree_map(
        lambda x: {f"{SLOT_KEY}{k}": s for k, s in enumerate(x.shards)} if is_placed(x) else x, tree
    )


def from_shard_flat(flat: Tree, like: Tree) -> Tree:
    """Inverse of :func:`shard_flat`, the layout from ``like``."""
    if isinstance(like, dict):
        return {k: from_shard_flat(flat[k], like[k]) for k in sorted(like)}
    if is_placed(like):
        return like.with_shards([flat[f"{SLOT_KEY}{k}"] for k in range(len(like.shards))])
    return flat


def map_state(fn: Callable, state):
    """``fn`` over every dict field of an optimizer state (named tuple or
    tuple); scalar fields (the step count) pass through."""
    if isinstance(state, dict):
        return fn(state)
    if isinstance(state, tuple):
        out = [map_state(fn, x) for x in state]
        return type(state)(*out) if hasattr(state, "_fields") else type(state)(out)
    return state


def map_shards(fn: Callable, *leaves):
    """``fn`` on matching shards of placed leaves (one layout), or on the
    tensors; the result placed like the first leaf."""
    first = leaves[0]
    if is_placed(first):
        return first.with_shards([fn(*parts) for parts in zip(*(x.shards for x in leaves))])
    return fn(*leaves)


def tree_map_shards(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """:func:`~p2pfl_tpu_torch.ops.tree.tree_map` of :func:`map_shards`:
    an elementwise function over placed trees, shard by shard."""
    return tree_map(lambda *xs: map_shards(fn, *xs), tree, *rest)


def slot_bytes(*trees: Tree, mesh: Optional[Mesh] = None) -> dict:
    """Bytes each slot holds across ``trees``, keyed by ``(mesh uid,
    slot)``: a shard counts on its slot, and a replicated tensor on every
    slot of ``mesh`` (None: of the one mesh the placed leaves lie on), as
    JAX's replicated array has a copy a device: the count is what a slice
    of distinct cards would hold."""
    if mesh is None:
        meshes = {x.mesh.uid: x.mesh for t in trees for _, x in _walk(t) if is_placed(x)}
        if len(meshes) > 1:
            raise ValueError("slot_bytes: leaves of several meshes; pass the slice as mesh=")
        mesh = next(iter(meshes.values()), None)
    out: dict = {}

    def add(key, n):
        out[key] = out.get(key, 0) + n

    for tree in trees:
        for _, x in _walk(tree):
            if is_placed(x):
                for slot, s in zip(x.mesh.slots.flat, x.shards):
                    add((x.mesh.uid, int(slot)), s.numel() * s.element_size())
            elif isinstance(x, torch.Tensor) and mesh is not None:
                for slot in mesh.slots.flat:
                    add((mesh.uid, int(slot)), x.numel() * x.element_size())
    return out


def shard_bytes_accounting(mesh: Mesh, tree: Tree, rules: PartitionRules = DEFAULT_TRANSFORMER_RULES,
                           on_unmatched: str = "error") -> int:
    """Bytes one slot of ``mesh`` holds of ``tree`` under ``rules``, by
    :meth:`SlotSharding.shard_shape` (metadata only: a meta-device tree
    works)."""
    shardings = tree_shardings(mesh, tree, rules, on_unmatched=on_unmatched)
    total = 0
    for (_, leaf), (_, sh) in zip(_walk(tree), _walk(shardings)):
        shape = sh.shard_shape(tuple(leaf.shape))
        total += math.prod(shape) * torch.empty((), dtype=leaf.dtype).element_size()
    return total


# ---- transformer-rule conveniences (the pre-engine public API) ----


def partition_spec_for(path: str) -> tuple:
    """Spec for one path under :data:`DEFAULT_TRANSFORMER_RULES`."""
    idx = _match_one(DEFAULT_TRANSFORMER_RULES, path)
    return tuple(resolve_axis(a) for a in DEFAULT_TRANSFORMER_RULES[idx][1])  # catch-all: never None


def transformer_shardings(mesh: Mesh, params: Tree) -> Tree:
    """:class:`SlotSharding` tree for a transformer param tree on ``mesh``."""
    return tree_shardings(mesh, params, DEFAULT_TRANSFORMER_RULES)



def shard_transformer(mesh: Mesh, params: Tree) -> Tree:
    """Place a transformer param tree onto ``mesh`` per the tensor-parallel
    rules (JAX's ``shard_transformer``)."""
    return place_tree(params, transformer_shardings(mesh, params))


# ---- node-stacked trees on a (nodes, ...) mesh ----


def node_shifted_spec(mesh: Mesh, spec: Sequence[AxisSpec], shape: Sequence[int]) -> tuple:
    """``(nodes, *spec)`` for a node-stacked leaf whose one-node shape is
    ``shape``: an axis whose mesh size does not divide its dimension falls
    back to ``None`` (JAX's ``SpmdLmFederation._node_stacked_shardings``)."""
    fixed: list = [Settings.MESH_NODES_AXIS]
    for i, axis in enumerate(spec):
        if axis is None:
            fixed.append(None)
            continue
        axes = axis if isinstance(axis, tuple) else (axis,)
        size = math.prod(mesh.shape[a] for a in axes)
        fixed.append(axis if i < len(shape) and shape[i] % size == 0 else None)
    return tuple(fixed)


def node_stacked_shardings(mesh: Mesh, tree: Tree, rules: Optional[PartitionRules] = None) -> Tree:
    """:class:`SlotSharding` tree for the node-stacked form of ``tree`` (a
    one-node tree): every leaf split over the nodes axis, and with
    ``rules`` each leaf's rule spec shifted one dimension right
    (:func:`node_shifted_spec`)."""
    unmatched: list[str] = []

    def one(path, leaf):
        spec = _rule_spec(rules, path, leaf, unmatched) if rules is not None else ()
        return SlotSharding(mesh, node_shifted_spec(mesh, spec, tuple(leaf.shape)))

    out = map_with_path(one, tree)
    if unmatched:
        _raise_unmatched(unmatched)
    return out


def n_rows(leaf) -> int:
    """The nodes-axis size of the mesh a node-stacked leaf is placed on (1
    for a plain tensor)."""
    return leaf.mesh.shape[Settings.MESH_NODES_AXIS] if is_placed(leaf) else 1


def row_block(leaf, i: int, k: int):
    """Row ``i`` (of ``k``) of a leaf placed on a ``(nodes, ...)`` mesh:
    its block on the row's slots, a plain tensor where the row holds it
    whole (its first slot's copy), else a :class:`SlotSharded` on the
    row's slice. A plain leaf is its own row (one row, or a global kept
    whole on the first device)."""
    if not is_placed(leaf):
        return leaf
    nodes = Settings.MESH_NODES_AXIS
    m = len(leaf.shards) // k
    stacked = bool(leaf.spec) and leaf.spec[0] == nodes
    shape = (leaf.shape[0] // k, *leaf.shape[1:]) if stacked else tuple(leaf.shape)
    sharding = SlotSharding(leaf.mesh.node_rows()[i], tuple(None if a == nodes else a for a in leaf.spec))
    shards = leaf.shards[i * m:(i + 1) * m]
    return shards[0] if sharding.is_fully_replicated else SlotSharded(sharding, shape, leaf.dtype, shards)


def _leaf_map(fn: Callable, tree):
    """``fn`` over the leaves of a named tree, a placed leaf one leaf."""
    return map_with_path(lambda _, x: fn(x), tree)


def split_rows(tree: Tree, k: int) -> list:
    """The ``k`` rows of a tree placed along a mesh's nodes axis
    (:func:`row_block` leaf by leaf); a ``None`` tree gives ``None`` rows."""
    if tree is None:
        return [None] * k
    return [_leaf_map(lambda x, i=i: row_block(x, i, k), tree) for i in range(k)]


def join_rows(rows: list, like: Tree) -> Tree:
    """Rows back into ``like``'s layout, the inverse of :func:`split_rows`:
    a placed leaf's shards are its rows' shards (a row's whole block
    serves every slot of the row, moved to each slot's device), a plain
    leaf is row 0's (one row, or a count every row stepped alike)."""
    flat = [dict(named_paths(r)) for r in rows]

    def one(path, ref):
        blocks = [f[path] for f in flat]
        if not is_placed(ref):
            b = blocks[0]
            return b.to(ref.device) if isinstance(b, torch.Tensor) and b.device != ref.device else b
        shards = []
        for i, b in enumerate(blocks):
            if is_placed(b):
                shards += b.shards
            else:
                shards += [b if b.device == d else b.to(d) for d in ref.mesh.node_rows()[i].devices.flat]
        return SlotSharded(ref.sharding, ref.shape, blocks[0].dtype, shards)

    return map_with_path(one, like)


def select0(leaf, r: int):
    """Index ``r`` of a leaf's leading dimension, which no axis splits
    (a fused span's round axis ``[R, N, ...]``)."""
    if not is_placed(leaf):
        return leaf[r]
    if leaf.spec and leaf.spec[0] is not None:
        raise ValueError(f"select0: the leading dimension is split ({leaf.spec})")
    sharding = SlotSharding(leaf.mesh, tuple(leaf.spec[1:]))
    return SlotSharded(sharding, leaf.shape[1:], leaf.dtype, [s[r] for s in leaf.shards])
