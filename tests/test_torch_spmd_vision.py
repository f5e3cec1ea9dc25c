"""The vision models in the port's ``SpmdFederation`` against the JAX
package on the CPU: the CIFAR-shaped data and its Dirichlet shards
bitwise; a reduced-depth ResNet (``ResNet(stage_sizes=(1, 1))``, fp32,
16x16x3, 2 nodes) through one step's gradients and two rounds; an
explicit, per-node clipped transform in a round; and the CIFAR examples
(``round_flops`` is ``tests/test_torch_vision_flops.py``).

Tolerances: the gradients of the same params on the same batch within
1e-5 relative L2 (fp32 convolutions and GroupNorms in another order);
the params after two rounds of SGD within 1e-4 relative L2. The rounds
run SGD: Adam's first steps move an element whose gradient sits at
rounding noise by ±lr whichever side of zero it lands, so after Adam
rounds the gap measures sign flips, not the round program.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from p2pfl_tpu.learning.dataset import FederatedDataset as JaxDataset
from p2pfl_tpu.learning.learner import _loss as jax_loss
from p2pfl_tpu.models import vision as jv
from p2pfl_tpu.models.base import FlaxModel
from p2pfl_tpu.parallel import SpmdFederation as JaxFederation
from p2pfl_tpu.parallel import spmd as jspmd
from p2pfl_tpu_torch.convert import params_from_jax, params_to_jax
from p2pfl_tpu_torch.learning import optimizers
from p2pfl_tpu_torch.learning.dataset import FederatedDataset
from p2pfl_tpu_torch.models import vision as tv
from p2pfl_tpu_torch.models.base import TorchModel
from p2pfl_tpu_torch.ops.tree import tree_map
from p2pfl_tpu_torch.parallel import spmd as tspmd
from p2pfl_tpu_torch.parallel.spmd import SpmdFederation

torch.set_num_threads(2)

SHAPE = (16, 16, 3)
N_NODES, BATCH = 2, 16
TASK = dict(dim=SHAPE, modes=2, noise=0.5, proto_scale=0.7)
DATA = dict(n_train=N_NODES * 2 * BATCH, n_test=N_NODES * 16, **TASK)  # 2 steps a round


def _rel_l2(want: list, got: list) -> float:
    num = sum(float(np.sum((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)) for a, b in zip(want, got))
    return (num / sum(float(np.sum(np.asarray(a, np.float64) ** 2)) for a in want)) ** 0.5


def _jax_resnet() -> FlaxModel:
    """The reduced ResNet with the port's init converted (flax's eager
    init of it takes seconds)."""
    params = tv.init_resnet_params(tv.ResNet((1, 1)), SHAPE, 0, torch.device("cpu"))
    return FlaxModel(jv.ResNet(stage_sizes=(1, 1), dtype=jnp.float32), params_to_jax(params), SHAPE)


def _port(jmodel: FlaxModel, module) -> TorchModel:
    return TorchModel(module, params_from_jax(jax.tree.map(np.asarray, jmodel.params), device="cpu"), SHAPE)


def test_cifar_data_and_dirichlet_shards_bitwise():
    """The CIFAR-shaped synthetic task (config 2's and config 4's knobs)
    and its Dirichlet(0.3) shards, staged for 5 nodes: the same arrays in
    both packages."""
    for task in (dict(dim=(32, 32, 3), modes=8, noise=0.7, proto_scale=0.5), TASK):
        data = dict(n_train=400, n_test=80, seed=2, **task)
        jd, td = JaxDataset.synthetic_mnist(**data), FederatedDataset.synthetic_mnist(**data)
        for key in ("x_train", "y_train", "x_test", "y_test"):
            assert np.array_equal(getattr(jd, key), getattr(td, key)), key
        jsh = [jd.partition(i, 5, "dirichlet", alpha=0.3) for i in range(5)]
        tsh = [td.partition(i, 5, "dirichlet", alpha=0.3) for i in range(5)]
        want, got = jspmd.stage_node_shards(jsh, 8), tspmd.stage_node_shards(tsh, 8)
        assert want["sizes"] == got["sizes"] and want["nb"] == got["nb"] and len(set(got["sizes"])) > 1
        for key in ("x", "y", "x_test", "y_test"):
            assert all(np.array_equal(a, b) for a, b in zip(want[key], got[key])), key


def test_resnet_gradients_and_rounds_match_jax():
    """One step's gradients of every node (node i's params scaled by
    1 + 0.01·i) on the same batch, then two rounds of 2 SGD steps from the
    same init, data and seed: gradients within 1e-5 relative L2 of JAX's and
    of the port's own fp64 run, params within 1e-4, the losses within 1e-5
    relative. A perturbation of a few percent can move an activation onto
    a ReLU's kink, where fp32 rounding on either side changes a node's
    gradient by far more than 1e-5: the test then measures that kink, not
    the port."""
    jmodel = _jax_resnet()
    module = tv.ResNet((1, 1), dtype=torch.float32)
    stacked = jax.tree.map(lambda a: np.stack([np.asarray(a) * (1 + 0.01 * i) for i in range(N_NODES)]), jmodel.params)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((N_NODES, BATCH, *SHAPE)).astype(np.float32)
    y = rng.integers(0, 10, (N_NODES, BATCH)).astype(np.int32)
    jgrads = jax.jit(jax.vmap(jax.grad(lambda p, x_, y_: jax_loss(p, jmodel.module, x_, y_)[0])))(stacked, x, y)
    grads = {}
    for dtype in (torch.float32, torch.float64):
        _, grads[dtype] = tspmd._value_and_grad(
            tspmd._node_loss(tv.ResNet((1, 1), dtype=dtype), 0.0),
            tree_map(lambda a, dt=dtype: torch.tensor(a, dtype=dt), stacked),
            torch.from_numpy(x).to(dtype), torch.from_numpy(y),
        )
    got = jax.tree.leaves(params_to_jax(grads[torch.float32]))
    assert _rel_l2(jax.tree.leaves(jax.tree.map(np.asarray, jgrads)), got) <= 1e-5
    assert _rel_l2(jax.tree.leaves(params_to_jax(grads[torch.float64])), got) <= 1e-5

    kw = dict(n_nodes=N_NODES, batch_size=BATCH, vote=False, seed=3, optimizer="sgd", learning_rate=0.05)
    jfed = JaxFederation.from_dataset(jmodel, JaxDataset.synthetic_mnist(**DATA), **kw)
    tfed = SpmdFederation.from_dataset(_port(jmodel, module), FederatedDataset.synthetic_mnist(**DATA), device="cpu", **kw)
    for _ in range(2):
        jl, tl = float(jfed.run_round()["train_loss"]), float(tfed.run_round()["train_loss"])
        assert abs(jl - tl) <= 1e-5 * abs(jl)
    want = jax.tree.leaves(jax.tree.map(np.asarray, jfed.params))
    assert _rel_l2(want, jax.tree.leaves(params_to_jax(tfed.params))) <= 1e-4
    assert jfed.evaluate()["test_acc"] == pytest.approx(tfed.evaluate()["test_acc"], abs=1 / 32)


def test_per_node_clipped_transform_matches_jax():
    """An explicit transform that is not elementwise, global-norm clipping
    before SGD with momentum: the port's federation steps the node-stacked
    tree in its per-node form, JAX vmaps optax's chain per node. One
    round of the MLP (fp32) agrees to a few ulps."""
    from p2pfl_tpu.models.vision import MLP as JaxMLP
    from p2pfl_tpu_torch.models.vision import MLP

    jmodel = FlaxModel.create(JaxMLP(dtype=jnp.float32), (28, 28, 1), seed=0)
    data = dict(n_train=4 * 64, n_test=64)
    kw = dict(n_nodes=4, batch_size=32, vote=False, seed=3)
    jfed = JaxFederation.from_dataset(
        jmodel, JaxDataset.synthetic_mnist(**data),
        tx=optax.chain(optax.clip_by_global_norm(0.5), optax.sgd(0.05, momentum=0.9)), **kw,
    )
    tx = optimizers.clipped("sgd", 0.05, 0.5)
    tmodel = TorchModel(MLP(dtype=torch.float32), params_from_jax(jax.tree.map(np.asarray, jmodel.params), device="cpu"),
                        (28, 28, 1))
    tfed = SpmdFederation.from_dataset(tmodel, FederatedDataset.synthetic_mnist(**data), tx=tx, device="cpu", **kw)
    assert tfed.tx is tx.node_stacked
    jfed.run_round()
    tfed.run_round()
    want = jax.tree.leaves(jax.tree.map(np.asarray, jfed.params))
    got = jax.tree.leaves(params_to_jax(tfed.params))
    assert max(float(np.abs(a - b).max()) for a, b in zip(want, got)) <= 1e-6


def test_cifar_examples_on_the_cpu(capsys, monkeypatch):
    """``examples/spmd_cifar.py`` (ResNet-18, and ``--large``'s ResNet-50
    federation built) and ``examples/heterogeneous.py`` (on a small MNIST
    stand-in) at a tiny size."""
    from p2pfl_tpu_torch.examples import heterogeneous, spmd_cifar

    spmd_cifar.main(["--device", "cpu", "--nodes", "2", "--samples", "64", "--batch-size", "16", "--rounds", "1",
                     "--measure_time"])
    out = capsys.readouterr().out
    assert "round 1: loss=" in out and "11.2M params" in out
    large = spmd_cifar.make_federation(spmd_cifar.parse_args(["--large", "--device", "cpu", "--nodes", "2",
                                                               "--samples", "512", "--batch-size", "16"]))
    assert large.model.num_classes == 100 and large.model.param_count == 23_705_252
    small = FederatedDataset.synthetic_mnist(n_train=512, n_test=64, modes=8, noise=0.7, proto_scale=0.5)
    monkeypatch.setattr(FederatedDataset, "mnist", classmethod(lambda cls, *a, **k: small))
    curves = heterogeneous.main(["--device", "cpu", "--nodes", "2", "--rounds", "2", "--batch-size", "32"])
    assert set(curves) == set(heterogeneous.ALGOS) and all(len(c) == 2 for c in curves.values())
    assert "best final accuracy" in capsys.readouterr().out
