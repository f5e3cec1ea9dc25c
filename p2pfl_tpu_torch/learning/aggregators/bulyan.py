"""Bulyan (El Mhamdi et al. 2018): Krum selection, then a trimmed mean
(counterpart of ``p2pfl_tpu/learning/aggregators/bulyan.py``). Needs
N ≥ 4f + 3."""

from __future__ import annotations

from p2pfl_tpu_torch.learning.aggregators.aggregator import Aggregator, stack_models
from p2pfl_tpu_torch.learning.weights import ModelUpdate
from p2pfl_tpu_torch.ops.aggregation import bulyan


class Bulyan(Aggregator):
    SUPPORTS_PARTIALS = False  # needs the individual models, like Krum

    def __init__(self, node_name: str = "unknown", n_byzantine: int = 1) -> None:
        super().__init__(node_name)
        self.n_byzantine = n_byzantine

    def aggregate(self, models: list[ModelUpdate]) -> ModelUpdate:
        return self.result(bulyan(stack_models(models), self.n_byzantine), models)
