"""Slot-to-slot transfer glue for the ICI weights plane.

Counterpart of ``p2pfl_tpu/parallel/ici_plane.py``: move a parameter tree
that lives on one node's slice onto the matching slots of a peer's slice,
without the data visiting the host.

- A slice is described by :class:`SliceInfo`: the node's slice mesh
  (``parallel/mesh.py``) and one spec per leaf. Torch tensors carry no
  sharding, so the slice comes from the learner (its ``mesh``), not from
  the leaves; the leaves are only checked against it. Every leaf is
  whole on the slice's one slot (replicated, spec ``()``): the port's
  learners hold one slot (ROADMAP Queue A item 5).
- Identity is by slot (``Mesh.slot_keys``), never by ``tensor.device``:
  on one card every tensor is on ``cuda:0``, and keying on the device
  would make every send a co-resident handoff. Two slices are the SAME
  slice when they hold the same slots (a zero-copy handoff), and a
  transfer is well-defined when they share none, even on one card.
- :func:`shard_transfer` allocates the receiver's buffers on the
  destination slot's device and copies every leaf into them in one
  exchange: kernel 9 (``csrc/ici_exchange.cu`` through
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

from p2pfl_tpu_torch.ops.tree import tree_items, tree_leaves, tree_structure, tree_unflatten
from p2pfl_tpu_torch.parallel.mesh import Mesh

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
        """The device of the slice's (one) slot."""
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
    ``None`` when the tree is not eligible: a leaf that is not a tensor
    (host arrays), leaves on different devices, or leaves off the slice's
    device. The caller then falls back to the byte path."""
    leaves = tree_leaves(tree) if isinstance(tree, dict) else []
    if not leaves or not all(isinstance(x, torch.Tensor) for x in leaves):
        return None
    devices = {x.device for x in leaves}
    if len(devices) != 1:
        return None
    (dev,) = devices
    if mesh is None:
        mesh = _single_device_mesh(dev)
    elif mesh.devices.size != 1 or mesh.devices.flat[0] != dev:
        return None
    return SliceInfo(mesh=mesh, specs=tuple(REPLICATED for _ in leaves))


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
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree) if isinstance(x, torch.Tensor))


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


def shard_transfer(tree: Tree, filler: Tree, src: SliceInfo, dst: SliceInfo) -> Tree:
    """Move ``tree`` from slice ``src`` onto slice ``dst``, slot to slot.

    ``filler`` is a structurally identical tree already on ``dst`` (the
    receiver's current parameters); it fixes where the output lands and
    is never written. The output leaves are fresh buffers on ``dst``'s
    device, filled by one :func:`exchange` (kernel 9 on a card, the
    plain version on the CPU)."""
    if tree_structure(tree) != tree_structure(filler):
        raise ValueError("shard_transfer: tree and filler differ in structure")
    if not transfer_compatible(src, dst):
        raise ValueError("shard_transfer: slices are not transfer-compatible")
    items = list(tree_items(tree))
    fillers = tree_leaves(filler)
    for leaf, fill in zip((x for _, x in items), fillers):
        if fill.device != dst.device or leaf.device != src.device:
            raise ValueError("shard_transfer: leaves off their slices' devices")
        if fill.shape != leaf.shape or fill.dtype != leaf.dtype:
            raise ValueError(f"shard_transfer: leaf {tuple(leaf.shape)} {leaf.dtype} "
                             f"for filler {tuple(fill.shape)} {fill.dtype}")
    outs = transfer_buffers([x for _, x in items], dst)
    return tree_unflatten({k: o for (k, _), o in zip(items, outs)})


def transfer_buffers(srcs: list, dst: SliceInfo) -> list:
    """Fresh buffers on ``dst``'s slot holding ``srcs``, filled by one
    :func:`exchange` (one launch of kernel 9 on a card): the transfer of
    :func:`shard_transfer` and of the ICI plane's codec payloads
    (``communication/ici.py``), whose int8/int32 buffers have byte
    lengths of any residue mod 16."""
    outs = [torch.empty(x.shape, dtype=x.dtype, device=dst.device) for x in srcs]
    exchange(srcs, outs)
    return outs

