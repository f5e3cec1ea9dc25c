"""Model wrapper: a module + its parameters + metadata.

Counterpart of ``p2pfl_tpu/models/base.py::FlaxModel``. As in flax, the
module holds structure only and the parameters are a separate nested dict
of tensors (flax leaf names and ``[in, out]`` kernel layout), so one
module serves every node of a federation and trees convert 1:1 with the
JAX package's (``p2pfl_tpu_torch/convert.py``).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from p2pfl_tpu_torch.ops.tree import tree_leaves


@dataclass
class TorchModel:
    """A parameter-free ``nn.Module`` bound to a concrete parameter tree."""

    module: torch.nn.Module  # forward(params, x)
    params: dict
    input_shape: tuple[int, ...]  # per-example shape, no batch dim
    num_classes: int = 10
    extra: dict = field(default_factory=dict)

    @property
    def param_count(self) -> int:
        return sum(int(p.numel()) for p in tree_leaves(self.params))
