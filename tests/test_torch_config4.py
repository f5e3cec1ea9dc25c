"""BASELINE config 4's Krum rounds under attack, in both packages on the
CPU, round by round (``bench_suite.py:601-649``; ``chip_smoke.py``'s
``config4``).

The recipe at reduced width: 10 nodes, 2 Byzantine slots, Krum with
f = 2, ``remat``, seed 3, the modes-2 synthetic task, but a
reduced-depth ResNet (stages (1, 1), fp32 compute) on 8x8x3 images, 64
samples a node in batches of 32 (2 steps a round). Both start from
flax's init of that ResNet (``convert.py::params_from_jax``). Before
every round the 2 Byzantine slots are overwritten with one attack tree,
built once with numpy as JAX builds it: JAX draws every leaf from the
same key (``PRNGKey(0)``), so leaves of one shape get the same noise;
here every shape gets one draw, times 10. Each round's Krum selection is
recorded in each package (JAX through a ``jax.debug.callback`` in the
traced round, the port at its eager call). Every round starts both from
JAX's params (the recipe resets the optimizer state each round), so the
two sequences must be equal: the rule is bitwise equal on identical
stacks (``test_torch_aggregation.py``), and one fp32 round of each
agrees far closer than the Krum scores of two honest nodes lie apart.

Run free, the two federations drift apart (Adam moves an element whose
gradient sits at rounding noise by ±lr whichever side of zero it lands),
and a selection may differ once the two packages' Krum scores part by
more than the two best honest nodes' scores lie apart: the test prints
both, round by round, and holds every free selection whose scores lie
closer than a quarter of that margin.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from p2pfl_tpu.learning.dataset import FederatedDataset as JaxDataset
from p2pfl_tpu.models import vision as jv
from p2pfl_tpu.models.base import FlaxModel
from p2pfl_tpu.ops import aggregation as jagg
from p2pfl_tpu.parallel import SpmdFederation as JaxFederation
from p2pfl_tpu.parallel.mesh import federation_mesh
from p2pfl_tpu_torch.convert import params_from_jax
from p2pfl_tpu_torch.learning.dataset import FederatedDataset
from p2pfl_tpu_torch.models import vision as tv
from p2pfl_tpu_torch.models.base import TorchModel
from p2pfl_tpu_torch.ops import aggregation as tagg
from p2pfl_tpu_torch.ops.tree import tree_items, tree_unflatten
from p2pfl_tpu_torch.parallel.spmd import SpmdFederation

torch.set_num_threads(2)

SHAPE = (8, 8, 3)
NODES, BYZ, ROUNDS = 10, 2, 10
DATA = dict(n_train=NODES * 64, n_test=NODES * 16, dim=SHAPE, modes=2, noise=0.5, proto_scale=0.7)
KW = dict(n_nodes=NODES, batch_size=32, vote=False, aggregator="krum", trim=BYZ, clip_tau=3.0, seed=3,
          remat=True)


def attack_tree(paths_shapes) -> dict:
    """The Byzantine slots' params: N(0, 1)·10, one numpy draw a shape
    (JAX's one key for every leaf gives equal-shaped leaves equal noise)."""
    by_shape: dict = {}
    out = {}
    for path, shape in paths_shapes:
        if shape not in by_shape:
            by_shape[shape] = np.random.default_rng(0).standard_normal(shape).astype(np.float32) * 10.0
        out[path] = by_shape[shape]
    return out


def _scores(flat: torch.Tensor, f: int) -> torch.Tensor:
    """Krum scores in fp64 (exact enough to compare two stacks by)."""
    d = torch.cdist(flat.double(), flat.double()) ** 2
    return torch.sort(d, dim=1).values[:, 1:flat.shape[0] - f - 1].sum(dim=1)


def test_krum_selects_the_same_node_every_round(monkeypatch):
    """First free (each package its own trajectory), then every round
    from JAX's state: the free selections agree while the two stacks'
    Krum scores lie closer than the two best honest nodes' (printed
    round by round), and from a shared state every selection agrees."""
    jmodel = FlaxModel.create(jv.ResNet(stage_sizes=(1, 1), dtype=jnp.float32), SHAPE, seed=0)
    jparams = jax.tree.map(np.asarray, jmodel.params)
    noise = attack_tree((p, tuple(x.shape)) for p, x in tree_items(params_from_jax(jparams, device="cpu")))
    jnoise = tree_unflatten({p: jnp.asarray(v) for p, v in noise.items()})

    picked = {"jax": [], "port": []}
    stacks = {"jax": [], "port": []}
    jselect, tkrum = jagg.krum_select, tagg.krum

    def jax_select(stacked, n_byzantine, multi=1):
        idx = jselect(stacked, n_byzantine, multi)
        flat = jnp.concatenate([x.reshape(x.shape[0], -1) for x in jax.tree.leaves(stacked)], axis=1)

        def keep(i, fl):
            picked["jax"].append(int(i[0]))
            stacks["jax"].append(torch.from_numpy(np.array(fl)))

        jax.debug.callback(keep, idx, flat)
        return idx

    def port_krum(stacked, n_byzantine, multi=1):
        picked["port"].append(int(tagg.krum_select(stacked, n_byzantine, multi)[0]))
        stacks["port"].append(torch.cat([x.reshape(x.shape[0], -1) for _, x in tree_items(stacked)], dim=1))
        return tkrum(stacked, n_byzantine, multi)

    monkeypatch.setattr(jagg, "krum_select", jax_select)
    monkeypatch.setattr(tagg, "krum", port_krum)

    def feds():
        jfed = JaxFederation.from_dataset(jmodel, JaxDataset.synthetic_mnist(**DATA),
                                          mesh=federation_mesh(devices=jax.devices()[:1]), **KW)
        tmodel = TorchModel(tv.ResNet((1, 1), dtype=torch.float32), params_from_jax(jparams, device="cpu"), SHAPE)
        return jfed, SpmdFederation.from_dataset(tmodel, FederatedDataset.synthetic_mnist(**DATA), device="cpu", **KW)

    def attack(jfed, tfed, shared: bool):
        jfed.params = jax.tree.map(lambda x, z: x.at[:BYZ].set(z.astype(x.dtype)), jfed.params, jnoise)
        if shared:
            tfed.params = params_from_jax(jax.tree.map(np.asarray, jfed.params), device="cpu")
        else:
            tfed.params = tree_unflatten({
                p: torch.cat([torch.from_numpy(noise[p])[None].expand(BYZ, *x.shape[1:]).to(x.dtype), x[BYZ:]])
                for p, x in tree_items(tfed.params)
            })

    for shared in (False, True):
        jfed, tfed = feds()
        for _ in range(ROUNDS):
            attack(jfed, tfed, shared)
            jfed.run_round()
            tfed.run_round()
        jax.effects_barrier()
        assert len(picked["port"]) == len(picked["jax"]) == ROUNDS
        if not shared:
            for r in range(ROUNDS):
                sj, st = _scores(stacks["jax"][r], BYZ), _scores(stacks["port"][r], BYZ)
                honest = torch.sort(st[BYZ:]).values
                gap = float((sj - st)[BYZ:].abs().max() / honest[0])
                margin = float((honest[1] - honest[0]) / honest[0])
                print(f"free round {r + 1}: JAX picks {picked['jax'][r]}, the port {picked['port'][r]}; "
                      f"scores apart {gap:.3g} of the best, the best two honest {margin:.3g}")
                if gap < margin / 4:
                    assert picked["port"][r] == picked["jax"][r], r
        else:
            assert picked["port"] == picked["jax"]
        # the attackers are never picked
        assert min(picked["port"] + picked["jax"]) >= BYZ
        for v in (*picked.values(), *stacks.values()):
            v.clear()
