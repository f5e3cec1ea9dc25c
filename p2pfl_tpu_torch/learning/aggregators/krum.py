"""(Multi-)Krum (Blanchard et al. 2017): Byzantine-robust selection
(counterpart of ``p2pfl_tpu/learning/aggregators/krum.py``). The pairwise
distances are one ``[N, P] @ [P, N]`` matmul (``ops/aggregation.py::krum_select``)."""

from __future__ import annotations

from p2pfl_tpu_torch.learning.aggregators.aggregator import Aggregator, stack_models
from p2pfl_tpu_torch.learning.weights import ModelUpdate
from p2pfl_tpu_torch.ops.aggregation import krum


class Krum(Aggregator):
    SUPPORTS_PARTIALS = False

    def __init__(self, node_name: str = "unknown", n_byzantine: int = 1, multi: int = 1) -> None:
        super().__init__(node_name)
        self.n_byzantine = n_byzantine
        self.multi = multi

    def aggregate(self, models: list[ModelUpdate]) -> ModelUpdate:
        params = krum(stack_models(models), self.n_byzantine, min(self.multi, len(models)))
        return self.result(params, models)
