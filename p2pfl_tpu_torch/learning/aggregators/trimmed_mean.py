"""Coordinate-wise trimmed mean (Yin et al. 2018), a robust aggregator
(counterpart of ``p2pfl_tpu/learning/aggregators/trimmed_mean.py``)."""

from __future__ import annotations

import torch

from p2pfl_tpu_torch.learning.aggregators.aggregator import Aggregator, stack_models
from p2pfl_tpu_torch.learning.weights import ModelUpdate
from p2pfl_tpu_torch.ops.aggregation import fedavg, trimmed_mean


class TrimmedMean(Aggregator):
    SUPPORTS_PARTIALS = False

    def __init__(self, node_name: str = "unknown", trim: int = 1) -> None:
        super().__init__(node_name)
        self.trim = trim

    def aggregate(self, models: list[ModelUpdate]) -> ModelUpdate:
        n = len(models)
        trim = min(self.trim, max((n - 1) // 2, 0))
        stacked = stack_models(models)
        # too few models to trim: the plain unweighted mean
        params = trimmed_mean(stacked, trim) if trim > 0 else fedavg(stacked, torch.ones(n))
        return self.result(params, models)
