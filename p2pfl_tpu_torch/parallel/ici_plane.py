"""Slot-to-slot transfer glue for the ICI weights plane.

Counterpart of ``p2pfl_tpu/parallel/ici_plane.py``: move a parameter tree
that lives on one node's slice onto the matching slots of a peer's slice,
without the data visiting the host.

- A slice is described by :class:`SliceInfo`: the node's slice mesh
  (``parallel/mesh.py``) and one spec per leaf. Torch tensors carry no
  sharding, so the slice comes from the learner (its ``mesh``), and the
  specs from the leaves: a leaf the learner's partition rules shard is a
  ``SlotSharded`` (``parallel/sharding.py``, one shard a slot) with its
  spec, any other leaf a whole tensor on the slice's first slot (spec
  ``()``).
- Identity is by slot (``Mesh.slot_keys``), never by ``tensor.device``:
  on one card every tensor is on ``cuda:0``, and keying on the device
  would make every send a co-resident handoff. Two slices are the SAME
  slice when they hold the same slots (a zero-copy handoff), and a
  transfer is well-defined when they share none, even on one card.
- :func:`shard_transfer` allocates the receiver's buffers on the
  destination slots' devices and copies every (leaf, slot) block into
  them in one exchange (slot p of the sender to slot p of the receiver,
  JAX's pair exchange with ``sub_axes``): kernel 9 (``csrc/ici_exchange.cu`` through
  :func:`p2pfl_tpu_torch.ops._kernels.ici_exchange`) for tensors on a
  card, :func:`exchange_plain` (a per-leaf ``copy_``, the role of JAX's
  ``ppermute`` tier) for tensors on the CPU. The ``filler`` (the
  receiver's live model, in ``try_shard_send``) fixes placement and
  structure only and is never written: in JAX it is immutable; here
  writing it would overwrite the receiver's parameters before it
  aggregates.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from p2pfl_tpu_torch.ops.tree import tree_items, tree_leaves, tree_map, tree_structure, tree_unflatten
from p2pfl_tpu_torch.parallel.mesh import Mesh
from p2pfl_tpu_torch.parallel.sharding import SlotSharded, SlotSharding, is_placed, place

Tree = Any

#: the spec of a leaf held whole on every slot of its slice
REPLICATED: tuple = ()
#: synthesized axis name of the one-device slice of a learner without a mesh
_SUB_AXIS = "ici_sub"


@dataclass(frozen=True)
class SliceInfo:
    """Where a tree lives: the slice mesh and one spec per leaf (leaf order)."""

    mesh: Mesh
    specs: tuple

    @property
    def device_ids(self) -> frozenset:
        """The slots of the slice (``(mesh uid, slot)`` keys): its identity."""
        return self.mesh.slot_keys

    @property
    def shape(self) -> tuple:
        """The slice's devices-array shape (the ``sp`` handshake's first element)."""
        return tuple(self.mesh.devices.shape)

    @property
    def device(self) -> torch.device:
        """The device of the slice's first slot (where whole leaves lie)."""
        return self.mesh.devices.flat[0]


#: one synthesized one-device mesh per device: every learner without a mesh
#: on that device shares it, so such learners are co-resident, as
#: single-chip JAX learners on one device are
_device_meshes: dict = {}


def _single_device_mesh(device: torch.device) -> Mesh:
    mesh = _device_meshes.get(str(device))
    if mesh is None:
        arr = np.empty((1,), dtype=object)
        arr[0] = device
        mesh = _device_meshes.setdefault(str(device), Mesh(arr, (_SUB_AXIS,)))
    return mesh


def slice_info_of(tree: Tree, mesh: Optional[Mesh] = None) -> Optional[SliceInfo]:
    """The :class:`SliceInfo` of a live tree on ``mesh`` (a learner's
    slice; ``None`` = the one-device slice of the leaves' device), or
    ``None`` when the tree is not eligible: a leaf that is neither a
    tensor nor placed on ``mesh`` (host arrays, another slice's shards),
    or whole leaves off the slice's first device. The caller then falls
    back to the byte path."""
    leaves = tree_leaves(tree) if isinstance(tree, dict) else []
    if not leaves or not all(isinstance(x, torch.Tensor) or is_placed(x) for x in leaves):
        return None
    whole = {x.device for x in leaves if not is_placed(x)}
    if mesh is None:
        if len(whole) != 1 or any(is_placed(x) for x in leaves):
            return None
        mesh = _single_device_mesh(next(iter(whole)))
    elif whole - {mesh.devices.flat[0]} or any(is_placed(x) and x.mesh is not mesh for x in leaves):
        return None
    return SliceInfo(mesh=mesh, specs=tuple(x.spec if is_placed(x) else REPLICATED for x in leaves))


def same_devices(src: SliceInfo, dst: SliceInfo) -> bool:
    """The SAME slots with the same layout: a transfer is a zero-copy handoff."""
    return src.device_ids == dst.device_ids and src.shape == dst.shape and src.specs == dst.specs


def transfer_compatible(src: SliceInfo, dst: SliceInfo) -> bool:
    """Same slice topology and per-leaf specs, disjoint slots."""
    return (
        src.shape == dst.shape
        and src.mesh.axis_names == dst.mesh.axis_names
        and src.specs == dst.specs
        and not (src.device_ids & dst.device_ids)
    )


def tree_device_bytes(tree: Tree) -> int:
    """Payload bytes of a tree's tensors (metadata only)."""
    return sum(
        x.nbytes if is_placed(x) else x.numel() * x.element_size()
        for x in tree_leaves(tree) if isinstance(x, torch.Tensor) or is_placed(x)
    )


# ---- the exchange ----


def exchange_plain(srcs: list, dsts: list) -> None:
    """The plain version of kernel 9: per-leaf ``dst.copy_(src)``."""
    for s, d in zip(srcs, dsts):
        d.copy_(s)


def exchange(srcs: list, dsts: list) -> None:
    """Copy ``srcs`` into ``dsts``: kernel 9 when the tensors lie on a card
    (the wrapper launches or raises), the plain version on the CPU."""
    if not srcs:
        return
    if srcs[0].is_cuda or dsts[0].is_cuda:
        from p2pfl_tpu_torch.ops import _kernels

        _kernels.ici_exchange(srcs, dsts)
    else:
        exchange_plain(srcs, dsts)


def _blocks(leaf) -> list:
    """A leaf's blocks in slot order (one for a whole tensor)."""
    return leaf.shards if is_placed(leaf) else [leaf]


def shard_transfer(tree: Tree, filler: Tree, src: SliceInfo, dst: SliceInfo) -> Tree:
    """Move ``tree`` from slice ``src`` onto slice ``dst``, slot to slot.

    Block k of a placed leaf (the shard on the sender's slot k) lands on
    the receiver's slot k, a whole leaf on its first slot. ``filler`` is a
    structurally identical tree already on ``dst`` (the receiver's current
    parameters); it fixes where the output lands and is never written.
    The output's blocks are fresh buffers on ``dst``'s slots, filled by
    one :func:`exchange` for the whole tree (kernel 9 on a card, the plain
    version on the CPU; one a pair of devices where a slice spans
    several cards)."""
    if tree_structure(tree) != tree_structure(filler):
        raise ValueError("shard_transfer: tree and filler differ in structure")
    if not transfer_compatible(src, dst):
        raise ValueError("shard_transfer: slices are not transfer-compatible")
    items = list(tree_items(tree))
    fillers = tree_leaves(filler)
    dst_devices = list(dst.mesh.devices.flat)
    srcs, dsts = [], []
    for (path, leaf), fill in zip(items, fillers):
        if tuple(fill.shape) != tuple(leaf.shape) or fill.dtype != leaf.dtype:
            raise ValueError(f"shard_transfer: leaf {path} {tuple(leaf.shape)} {leaf.dtype} "
                             f"for filler {tuple(fill.shape)} {fill.dtype}")
        blocks = _blocks(leaf)
        if is_placed(leaf) != is_placed(fill) or len(blocks) != len(_blocks(fill)):
            raise ValueError(f"shard_transfer: leaf {path} is laid out otherwise than its filler")
        if (is_placed(leaf) and leaf.mesh is not src.mesh) or (is_placed(fill) and fill.mesh is not dst.mesh):
            raise ValueError(f"shard_transfer: leaf {path} off its slice")
        for k, block in enumerate(blocks):
            if block.device != src.mesh.devices.flat[k] or _blocks(fill)[k].device != dst_devices[k]:
                raise ValueError(f"shard_transfer: leaf {path} block {k} off its slot's device")
            srcs.append(block)
            dsts.append(torch.empty(block.shape, dtype=block.dtype, device=dst_devices[k]))
    # one exchange a (source card, destination card) pair: on one card,
    # one launch of kernel 9 for every block of the tree
    groups: dict = {}
    for i, (a, b) in enumerate(zip(srcs, dsts)):
        groups.setdefault((a.device, b.device), []).append(i)
    for idx in groups.values():
        exchange([srcs[i] for i in idx], [dsts[i] for i in idx])
    outs = iter(dsts)
    new = {}
    for (path, leaf), spec in zip(items, dst.specs):
        if is_placed(leaf):
            shards = [next(outs) for _ in leaf.shards]
            new[path] = SlotSharded(SlotSharding(dst.mesh, spec), leaf.shape, leaf.dtype, shards)
        else:
            new[path] = next(outs)
    return tree_unflatten(new)


def conform_specs(tree: Tree, mesh: Mesh, specs: tuple) -> tuple[Tree, int]:
    """Re-lay out a tree to ``specs`` on ``mesh``, counting the moved
    leaves: a leaf already in its target layout is kept, any other is
    re-placed on the slice's own devices (a gather and split, never the
    host). The sender conforms a payload whose layout differs from the
    receiver's (an aggregate made elsewhere), so the transfer lands every
    block where the receiver reads it. Returns ``(tree, moved)``."""
    items = list(tree_items(tree))
    moved = 0
    out = {}
    for (path, leaf), spec in zip(items, specs):
        target = SlotSharding(mesh, tuple(spec))
        if is_placed(leaf) and leaf.sharding == target:
            out[path] = leaf
        elif not is_placed(leaf) and target.is_fully_replicated and leaf.device == mesh.devices.flat[0]:
            out[path] = leaf
        else:
            moved += 1
            out[path] = place(leaf, target)
    return tree_unflatten(out), moved


def replicate_on_slice(tree: Tree, info: SliceInfo) -> Tree:
    """Every leaf whole on the slice's first slot, where the port holds a
    replicated leaf (a placed leaf is gathered there, on the device): the
    deterministic layout codec buffers take before a transfer. A tree
    already so is returned as it is."""
    dev = info.device
    return tree_map(lambda x: place(x, SlotSharding(info.mesh, REPLICATED)) if is_placed(x) or x.device != dev
                    else x, tree)


def transfer_buffers(srcs: list, dst: SliceInfo) -> list:
    """Fresh buffers on ``dst``'s first slot holding ``srcs``, filled by
    one :func:`exchange` (one launch of kernel 9 on a card): the transfer
    of the ICI plane's codec payloads (``communication/ici.py``), whose
    int8/int32 buffers have byte lengths of any residue mod 16."""
    outs = [torch.empty(x.shape, dtype=x.dtype, device=dst.device) for x in srcs]
    exchange(srcs, outs)
    return outs
