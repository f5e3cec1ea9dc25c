"""FedAvg: sample-weighted mean (McMahan et al. 2017).

Counterpart of ``p2pfl_tpu/learning/aggregators/fedavg.py`` on its staged
path (the port has no fused round, so no ``partial_acc`` fold): stack the
contributions, one weighted contraction per leaf.
"""

from __future__ import annotations

import torch

from p2pfl_tpu_torch.learning.aggregators.aggregator import Aggregator
from p2pfl_tpu_torch.learning.weights import ModelUpdate
from p2pfl_tpu_torch.management.logger import logger
from p2pfl_tpu_torch.ops.aggregation import fedavg
from p2pfl_tpu_torch.ops.tree import tree_align_copy_count, tree_align_devices, tree_stack
from p2pfl_tpu_torch.settings import Settings


class FedAvg(Aggregator):
    SUPPORTS_PARTIALS = True

    def aggregate(self, models: list[ModelUpdate]) -> ModelUpdate:
        align_before = tree_align_copy_count()
        try:
            contributors = sorted({c for m in models for c in m.contributors})
            total = sum(m.num_samples for m in models)
            # a zero-copy peer's tensors may lie on another device: move
            # them to the first model's (counted; the ICI plane's
            # deliveries already lie on this node's device and move nothing)
            stacked = tree_stack([tree_align_devices(m.params, models[0].params) for m in models])
            weights = torch.tensor([float(m.num_samples) for m in models])
            return ModelUpdate(fedavg(stacked, weights, Settings.AGG_DTYPE), contributors, total)
        finally:
            copies = tree_align_copy_count() - align_before
            if copies:
                logger.log_comm_metric(self.node_name, "tree_align_copies", copies)
