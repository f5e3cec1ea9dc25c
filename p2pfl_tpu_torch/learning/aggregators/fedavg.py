"""FedAvg: sample-weighted mean (McMahan et al. 2017).

Counterpart of ``p2pfl_tpu/learning/aggregators/fedavg.py``. When the
round ran fused (``Settings.ROUND_FUSED``), the node's own contribution
arrives with its ``partial_acc`` (``weight × params`` folded inside the
round), and the aggregate continues that fold with the peers
(``fedavg_fold_acc``); otherwise it stacks the contributions, one
weighted contraction per leaf.
"""

from __future__ import annotations

import torch

from p2pfl_tpu_torch.learning.aggregators.aggregator import Aggregator, stack_models
from p2pfl_tpu_torch.learning.weights import ModelUpdate
from p2pfl_tpu_torch.management.logger import logger
from p2pfl_tpu_torch.ops.aggregation import fedavg, fedavg_fold_acc
from p2pfl_tpu_torch.ops.tree import tree_align_copy_count, tree_align_devices
from p2pfl_tpu_torch.settings import Settings


class FedAvg(Aggregator):
    SUPPORTS_PARTIALS = True
    MASK_COMPATIBLE = True  # linear: secure aggregation's masks cancel through it

    def aggregate(self, models: list[ModelUpdate]) -> ModelUpdate:
        align_before = tree_align_copy_count()
        try:
            return self._aggregate(models)
        finally:
            copies = tree_align_copy_count() - align_before
            if copies:
                logger.log_comm_metric(self.node_name, "tree_align_copies", copies)

    def _aggregate(self, models: list[ModelUpdate]) -> ModelUpdate:
        own = next((m for m in models if m.partial_acc is not None), None)
        if own is not None:
            # continue the round's fold; the accumulator is read, never
            # written (the memoized partials reuse it). Zero-copy peers may
            # lie on another device: align them to the accumulator's
            # (counted; the ICI plane's deliveries move nothing)
            others = [m for m in models if m is not own]
            psum, wsum = own.partial_acc
            params = fedavg_fold_acc(
                psum, wsum,
                tuple(tree_align_devices(m.params, own.params) for m in others),
                torch.tensor([float(m.num_samples) for m in others]),
                own.params, Settings.AGG_DTYPE,
            )
        else:
            weights = torch.tensor([float(m.num_samples) for m in models])
            params = fedavg(stack_models(models), weights, Settings.AGG_DTYPE)
        return self.result(params, models)
