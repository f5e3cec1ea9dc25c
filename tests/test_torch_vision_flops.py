"""``SpmdFederation.round_flops`` for every model of the port's zoo, on
the CPU: the MLP's count is the one its formula gave before the count
went through ``FlopCounterMode`` (bit for bit); the reduced ResNet's
agrees with the JAX package's XLA cost analysis within 15 % (XLA also
counts the elementwise work: activations, GroupNorms, the loss); the
CNN's and a small ViT's forward FLOPs equal their analytic conv and
GEMM counts; ``remat`` adds one forward a step.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import pytest
import torch

from p2pfl_tpu.learning.dataset import FederatedDataset as JaxDataset
from p2pfl_tpu.models import vision as jv
from p2pfl_tpu.models.base import FlaxModel
from p2pfl_tpu.parallel import SpmdFederation as JaxFederation
from p2pfl_tpu.parallel.mesh import federation_mesh
from p2pfl_tpu_torch.convert import params_to_jax
from p2pfl_tpu_torch.learning.dataset import FederatedDataset
from p2pfl_tpu_torch.models import vision as tv
from p2pfl_tpu_torch.models.base import TorchModel
from p2pfl_tpu_torch.parallel import spmd as tspmd
from p2pfl_tpu_torch.parallel.spmd import SpmdFederation

torch.set_num_threads(2)

CPU = torch.device("cpu")


def _mlp_formula(fed) -> float:
    """The MLP's count as ``round_flops`` wrote it before it counted with
    ``FlopCounterMode``: 6·in·out a sample a layer less 2·in·out for the
    first, Adam 14 a parameter a step, 5 a parameter a node."""
    kernels = [fed.model.params[f"Dense_{i}"]["kernel"].shape for i in range(3)]
    gemm = sum(2 * a * b for a, b in kernels)
    per_sample = 3 * gemm - 2 * kernels[0][0] * kernels[0][1]
    n_params = fed.model.param_count
    return float(fed.n * fed._nb * (fed.batch_size * per_sample + 14 * n_params) + 5 * n_params * fed.n)


def _fed(model: TorchModel, **kw) -> SpmdFederation:
    data = FederatedDataset.synthetic_mnist(n_train=2 * 32, n_test=32, dim=model.input_shape)
    return SpmdFederation.from_dataset(model, data, n_nodes=2, batch_size=16, vote=False, seed=3, device="cpu", **kw)


def _round(fed, forward_and_backward: int) -> float:
    """A round's count from one node-step's model FLOPs: Adam 14 a
    parameter a step, 5 a parameter a node for the aggregation."""
    p = fed.model.param_count
    return float(fed.n * fed._nb * (forward_and_backward + 14 * p) + 5 * p * fed.n)


def test_round_flops_mlp_unchanged():
    model = tv.mlp(device="cpu")
    fed = SpmdFederation.from_dataset(model, FederatedDataset.synthetic_mnist(n_train=4 * 128, n_test=64),
                                      n_nodes=4, batch_size=64, vote=False, device="cpu")
    assert fed.round_flops() == _mlp_formula(fed)


def test_round_flops_resnet_against_jax():
    """The reduced ResNet's round against JAX's cost analysis (JAX's
    federation on a one-device mesh: on the tests' virtual mesh XLA reports
    the per-device program), and ``remat``'s extra forward."""
    shape = (16, 16, 3)
    tmod = tv.ResNet((1, 1), dtype=torch.float32)
    params = tv.init_resnet_params(tmod, shape, 0, CPU)
    jmodel = FlaxModel(jv.ResNet(stage_sizes=(1, 1), dtype=jnp.float32), params_to_jax(params), shape)
    jfed = JaxFederation.from_dataset(jmodel, JaxDataset.synthetic_mnist(n_train=2 * 32, n_test=32, dim=shape),
                                      n_nodes=2, batch_size=16, vote=False, seed=3,
                                      mesh=federation_mesh(n_nodes=1, devices=jax.devices()[:1]))
    fed = _fed(TorchModel(tmod, params, shape))
    want, got = jfed.round_flops(), fed.round_flops()
    assert got == pytest.approx(want, rel=0.15), (got, want)
    remat = _fed(TorchModel(tmod, params, shape), remat=True)
    forward, _ = tspmd._model_step_flops(tmod, params, remat.x_all, remat.y_all, 16)
    assert remat.round_flops() == got + 2 * remat._nb * forward


def test_round_flops_cnn_and_vit_analytic():
    """Forward FLOPs a batch of B: the CNN's two 3x3 convs (28x28, 14x14)
    and two Dense; the ViT's patch conv, every block's qkv, scores, P·V,
    proj, fc1, fc2 and the head. The round counts them with the backward."""
    b = 16
    cnn = tv.cnn(device="cpu")
    want = 2 * b * (28 * 28 * 9 * 1 * 32 + 14 * 14 * 9 * 32 * 64 + 7 * 7 * 64 * 128 + 128 * 10)
    fed = _fed(cnn)
    forward, step = tspmd._model_step_flops(cnn.module, cnn.params, fed.x_all, fed.y_all, b)
    assert forward == want and step > 2 * forward
    assert fed.round_flops() == _round(fed, step)
    d, depth, t, classes = 32, 2, 16, 10
    vit = tv.vit(input_shape=(16, 16, 3), dim=d, depth=depth, heads=2, dtype=torch.float32, device="cpu")
    block = 2 * t * d * 3 * d + 2 * (2 * t * t * d) + 2 * t * d * d + 2 * (2 * t * d * 4 * d)
    want = b * (2 * t * 16 * 3 * d + depth * block + 2 * d * classes)
    fed = _fed(vit)
    forward, step = tspmd._model_step_flops(vit.module, vit.params, fed.x_all, fed.y_all, b)
    assert forward == want
    assert fed.round_flops() == _round(fed, step)

