"""Mesh construction (counterpart of ``p2pfl_tpu/parallel/mesh.py``).

A mesh here is a named ``(nodes, model)`` array of ``torch.device``s
(axis names from :class:`p2pfl_tpu_torch.settings.Settings`). The port
runs in one process: ring attention
(:func:`p2pfl_tpu_torch.ops.attention.ring_attention`) places sequence
shard r on the model axis's device r and moves K/V blocks between them
with ``Tensor.to``.

A mesh may name one device several times. That is how a ring of R shards
runs on one card (``devices=["cuda:0"] * R``) and on the CPU
(``devices=["cpu"] * R``), as the JAX tests run their rings on forced host
devices; each hop's move is then a no-op. Node placement over the
``nodes`` axis and the submesh layout are not ported (ROADMAP A6).
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

from p2pfl_tpu_torch import resolve_device
from p2pfl_tpu_torch.settings import Settings


class Mesh:
    """``devices``: an object array of ``torch.device``; ``shape`` maps each
    axis name to its size, as ``jax.sharding.Mesh.shape`` does."""

    def __init__(self, devices: np.ndarray, axis_names: tuple[str, ...]) -> None:
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d device array for axes {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))

    def axis_devices(self, axis_name: str) -> list[torch.device]:
        """The devices along ``axis_name`` at index 0 of every other axis."""
        arr = np.moveaxis(self.devices, self.axis_names.index(axis_name), -1)
        return list(arr.reshape(-1, self.shape[axis_name])[0])


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
    if devices is None:
        resolve_device(None)
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devs = [resolve_device(d) for d in devices]
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
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(slots, model_parallel), (Settings.MESH_NODES_AXIS, Settings.MESH_MODEL_AXIS))
