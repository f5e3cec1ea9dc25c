"""Vision models (subset of ``p2pfl_tpu/models/vision.py``): the MLP.

784-256-128-10, the reference's MNIST model and the gossip Node's model.
Compute in bfloat16, parameters and logits in float32, as in flax: each
``Dense`` casts its input, kernel and bias to the compute dtype, takes
the product and adds the bias in that dtype. Parameters keep flax's
names and layout (``Dense_{i}/kernel`` as ``[in, out]``, then ``bias``),
so JAX init params load 1:1 through :mod:`p2pfl_tpu_torch.convert`.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from p2pfl_tpu_torch import resolve_device
from p2pfl_tpu_torch.models.base import TorchModel
from p2pfl_tpu_torch.models.transformer import _lecun_normal
from p2pfl_tpu_torch.settings import Settings


class MLP(nn.Module):
    """Parameter-free module: ``forward(params, x)`` → fp32 logits."""

    def __init__(
        self, hidden: Sequence[int] = (256, 128), num_classes: int = 10, dtype=None
    ) -> None:
        super().__init__()
        self.hidden = tuple(hidden)
        self.num_classes = num_classes
        # None: ``Settings.COMPUTE_DTYPE`` (bfloat16 unless changed)
        self.dtype = getattr(torch, Settings.COMPUTE_DTYPE) if dtype is None else dtype

    def forward(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x = x.reshape(x.shape[0], -1).to(dt)
        n = len(self.hidden) + 1
        for i in range(n):
            p = params[f"Dense_{i}"]
            x = x @ p["kernel"].to(dt) + p["bias"].to(dt)
            if i < n - 1:
                x = torch.relu(x)
        return x.float()


def init_mlp_params(
    in_features: int, hidden: Sequence[int], num_classes: int, seed: int, device
) -> dict:
    """flax ``Dense`` defaults from a seeded ``torch.Generator``: kernels
    ``lecun_normal``, biases zero (fp32)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    sizes = [in_features, *hidden, num_classes]
    return {
        f"Dense_{i}": {
            "kernel": _lecun_normal((fan_in, fan_out), gen, device),
            "bias": torch.zeros(fan_out, device=device),
        }
        for i, (fan_in, fan_out) in enumerate(zip(sizes, sizes[1:]))
    }


def mlp(seed: int = 0, num_classes: int = 10, input_shape=(28, 28, 1), device=None) -> TorchModel:
    """The MLP bound to fresh parameters on ``device`` (``None`` = cuda)."""
    module = MLP(num_classes=num_classes)
    in_features = 1
    for s in input_shape:
        in_features *= s
    params = init_mlp_params(in_features, module.hidden, num_classes, seed, resolve_device(device))
    return TorchModel(module, params, tuple(input_shape), num_classes)
