"""The clients-axis mesh of the sharded megafleet engine (counterpart of
``p2pfl_tpu/parallel/fleet_mesh.py``).

The megafleet engine's only fleet-scale state is the per-client parameter
matrix ``w [N, dim+1]``; everything else (the global history, the
windows, the counters) is sized by the version count. The sharded engine
(:class:`p2pfl_tpu_torch.ops.fleet_kernels.ShardedFleet`) therefore uses
the simplest layout: a 1-D mesh over ``Settings.MESH_CLIENTS_AXIS`` with
``w`` split into blocks by client id and the small state replicated, kept
once on the mesh's first slot.

Ownership is the static block rule shared by the host layout and the
engine:

- ``shard_capacity(n, p)`` gives ``ncap = ceil(n / p)`` rows a shard;
- client ``i`` lives on shard ``i // ncap`` at local row ``i % ncap``;
- each shard carries one more local row (``ncap``, its trash row), which
  dead lanes scatter to, as the chunked engine's global trash row.

A mesh may name one device several times (``devices=["cuda:0"] * P``:
P slots of one card; ``["cpu"] * P``: P CPU slots), the port's stand-in
for JAX's forced host devices. A request the devices cannot seat raises.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from p2pfl_tpu_torch.parallel.mesh import Mesh, _devices, _object_array
from p2pfl_tpu_torch.settings import Settings


def shard_capacity(n_clients: int, n_shards: int) -> int:
    """Client rows owned a shard (its trash row aside):
    ``ceil(n_clients / n_shards)``. The last shard may own fewer real
    clients; its surplus rows are padding no event addresses."""
    if n_clients < 1 or n_shards < 1:
        raise ValueError(f"n_clients={n_clients}, n_shards={n_shards} must both be >= 1")
    return -(-n_clients // n_shards)


def fleet_clients_mesh(
    n_shards: Optional[int] = None,
    devices: Optional[Sequence[Union[str, torch.device]]] = None,
) -> Mesh:
    """The 1-D ``(clients,)`` mesh of the sharded fleet engine.

    ``devices=None`` takes every visible card (and raises without one).
    ``n_shards`` defaults to every device given. Asking for more shards
    than devices raises (a shard is one device's slot); asking for fewer
    takes the first ``n_shards``."""
    devs = _devices(devices)
    n = len(devs) if n_shards is None else int(n_shards)
    if n < 1:
        raise ValueError(f"n_shards={n} must be >= 1")
    if n > len(devs):
        raise ValueError(
            f"n_shards={n} exceeds the {len(devs)} available devices; to run {n} shards in turn on one "
            f"device, name its slots: fleet_clients_mesh({n}, devices=['cuda:0'] * {n})")
    return Mesh(_object_array(devs[:n], (n,)), (Settings.MESH_CLIENTS_AXIS,))
