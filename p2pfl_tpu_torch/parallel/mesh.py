"""Mesh construction (counterpart of ``p2pfl_tpu/parallel/mesh.py``).

A mesh here is a named array of ``torch.device``s (axis names from
:class:`p2pfl_tpu_torch.settings.Settings`) plus the **slot** each
position occupies. The port runs in one process.

A mesh may name one device several times. That is how a ring of R shards
runs on one card (``devices=["cuda:0"] * R``) and on the CPU
(``devices=["cpu"] * R``), and how several nodes own disjoint slices of
one card, as the JAX tests run their rings and placed federations on
forced host devices. Identity is therefore the slot, not the device:
slot ``i`` of a mesh is ``(mesh uid, i)``, and a slice cut from a mesh by
:func:`node_slices` keeps its parent's slot keys. Two slices are the same
slice when they hold the same slots, and disjoint when they share none,
even when every slot names ``cuda:0``.

Two layouts ship:

- :func:`federation_mesh` — ``(nodes, model)``: ring attention places
  sequence shard r on the model axis's slot r and moves K/V blocks
  between them with ``Tensor.to`` (a no-op within one device).
- :func:`submesh_federation_mesh` — ``(nodes, data, model)``: each gossip
  node owns a ``(data, model)`` slice (:func:`node_slices`), and the ICI
  weights plane moves model payloads between slices
  (``parallel/ici_plane.py``).
- :func:`pipeline_mesh` — ``(pipe,)``: GPipe stage s runs on position s
  (``parallel/pipeline.py``).

A node-stacked federation (``parallel/spmd.py``) places ``[N, ...]``
state along the first (nodes) axis; :meth:`Mesh.node_rows` gives the
slice at each index of that axis, the slots one row of nodes computes on.
"""

from __future__ import annotations

import itertools
from typing import Optional, Sequence, Union

import numpy as np
import torch

from p2pfl_tpu_torch import resolve_device
from p2pfl_tpu_torch.settings import Settings

_uids = itertools.count(1)


class Mesh:
    """``devices``: an object array of ``torch.device``; ``shape`` maps each
    axis name to its size, as ``jax.sharding.Mesh.shape`` does; ``slots``
    (same shape, ints) numbers the positions within the root mesh ``uid``."""

    def __init__(
        self,
        devices: np.ndarray,
        axis_names: tuple[str, ...],
        slots: Optional[np.ndarray] = None,
        uid: Optional[int] = None,
    ) -> None:
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d device array for axes {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))
        self.uid = next(_uids) if uid is None else uid
        self.slots = np.arange(devices.size).reshape(devices.shape) if slots is None else slots
        if self.slots.shape != devices.shape:
            raise ValueError(f"slots {self.slots.shape} do not match devices {devices.shape}")
        self._rows: Optional[list] = None

    @property
    def slot_keys(self) -> frozenset:
        """The global identity of every position: ``(uid, slot)`` pairs."""
        return frozenset((self.uid, int(s)) for s in self.slots.flat)

    def node_rows(self) -> list["Mesh"]:
        """:func:`node_slices` of this mesh, made once, so a row keeps one
        identity (its shardings compare equal from call to call)."""
        if self._rows is None:
            self._rows = node_slices(self)
        return self._rows

    def axis_devices(self, axis_name: str) -> list[torch.device]:
        """The devices along ``axis_name`` at index 0 of every other axis."""
        arr = np.moveaxis(self.devices, self.axis_names.index(axis_name), -1)
        return list(arr.reshape(-1, self.shape[axis_name])[0])


def _devices(devices: Optional[Sequence[Union[str, torch.device]]]) -> list[torch.device]:
    """``None`` → every visible CUDA device (raising without one); a bare
    ``"cuda"`` is the current card, with its index, as tensors report it."""
    if devices is None:
        resolve_device(None)
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devs = [resolve_device(d) for d in devices]
    return [
        torch.device("cuda", torch.cuda.current_device()) if d.type == "cuda" and d.index is None else d
        for d in devs
    ]


def default_devices(device=None) -> list[torch.device]:
    """The devices a federation's default mesh spans: every visible card
    for ``device=None`` (raising without one), else the one device asked
    for."""
    return _devices(None if device is None else [device])


def _object_array(devs: list, shape: tuple) -> np.ndarray:
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    return arr.reshape(shape)


def federation_mesh(
    n_nodes: Optional[int] = None,
    model_parallel: int = 1,
    devices: Optional[Sequence[Union[str, torch.device]]] = None,
) -> Mesh:
    """Build a ``(nodes, model)`` mesh.

    ``devices=None`` takes every visible CUDA device (and raises without
    one, as every entry point of the port does). ``n_nodes`` is the number
    of slots on the nodes axis and defaults to ``len(devices) //
    model_parallel``; a slot count that would strand devices raises, as in
    JAX. The same device may appear more than once (see the module
    docstring).
    """
    devs = _devices(devices)
    if model_parallel < 1 or len(devs) % model_parallel != 0:
        raise ValueError(f"model_parallel={model_parallel} does not divide {len(devs)} devices")
    slots = len(devs) // model_parallel
    if n_nodes is not None and n_nodes < slots:
        raise ValueError(
            f"n_nodes={n_nodes} mesh slots would strand "
            f"{len(devs) - n_nodes * model_parallel} of {len(devs)} devices "
            f"(model_parallel={model_parallel}). Pass "
            f"devices=devices[:{n_nodes * model_parallel}] to use a subset "
            "deliberately, or let n_nodes default so logical nodes fold onto "
            "all slots."
        )
    return Mesh(
        _object_array(devs, (slots, model_parallel)),
        (Settings.MESH_NODES_AXIS, Settings.MESH_MODEL_AXIS),
    )


def submesh_federation_mesh(
    n_nodes: int,
    model_parallel: int = 1,
    data_parallel: int = 1,
    devices: Optional[Sequence[Union[str, torch.device]]] = None,
) -> Mesh:
    """Build the ``(nodes, data, model)`` global mesh for placed nodes.

    Exactly ``n_nodes * data_parallel * model_parallel`` slots: every
    federated node owns a ``(data_parallel, model_parallel)`` slice, the
    consecutive runs of ``devices`` in order. With ``devices=None`` the
    first ``needed`` visible CUDA devices are taken. A device may repeat:
    ``devices=["cuda:0"] * n`` gives n nodes disjoint slots of one card.
    """
    if n_nodes < 1 or model_parallel < 1 or data_parallel < 1:
        raise ValueError(
            f"n_nodes={n_nodes}, data_parallel={data_parallel}, "
            f"model_parallel={model_parallel} must all be >= 1"
        )
    needed = n_nodes * data_parallel * model_parallel
    explicit = devices is not None
    devs = _devices(devices)
    if (explicit and len(devs) != needed) or len(devs) < needed:
        raise ValueError(
            f"submesh federation needs exactly {needed} devices "
            f"({n_nodes} nodes x {data_parallel} data x {model_parallel} "
            f"model), got {len(devs)}"
        )
    return Mesh(
        _object_array(devs[:needed], (n_nodes, data_parallel, model_parallel)),
        (Settings.MESH_NODES_AXIS, Settings.MESH_DATA_AXIS, Settings.MESH_MODEL_AXIS),
    )


def node_slices(mesh: Mesh) -> list[Mesh]:
    """Per-node ``(data, model)`` submeshes of a ``(nodes, data, model)``
    mesh; slice ``i`` keeps its slots' global identity (``uid``, slot)."""
    nodes_axis = Settings.MESH_NODES_AXIS
    if nodes_axis not in mesh.shape:
        raise ValueError(f"mesh has no {nodes_axis!r} axis: {dict(mesh.shape)}")
    axis_names = tuple(a for a in mesh.axis_names if a != nodes_axis)
    node_dim = mesh.axis_names.index(nodes_axis)
    return [
        Mesh(
            np.take(mesh.devices, [i], axis=node_dim).squeeze(node_dim),
            axis_names,
            slots=np.take(mesh.slots, [i], axis=node_dim).squeeze(node_dim),
            uid=mesh.uid,
        )
        for i in range(mesh.shape[nodes_axis])
    ]


def pipeline_mesh(
    n_stages: int, devices: Optional[Sequence[Union[str, torch.device]]] = None, axis: str = "pipe"
) -> Mesh:
    """A 1-axis mesh of ``n_stages`` positions for a GPipe pipeline (JAX's
    ``pipeline_mesh``): the first ``n_stages`` of ``devices``, which may
    repeat (``["cuda:0"] * 4`` runs four stages in turn on one card);
    ``None`` takes the visible CUDA devices. Too few devices raise."""
    devs = _devices(devices)[:n_stages]
    if len(devs) < n_stages:
        raise ValueError(f"need {n_stages} devices, have {len(devs)}")
    return Mesh(_object_array(devs, (n_stages,)), (axis,))
