"""FedMedian: coordinate-wise median (Yin et al. 2018), a robust
aggregator (counterpart of ``p2pfl_tpu/learning/aggregators/fedmedian.py``)."""

from __future__ import annotations

from p2pfl_tpu_torch.learning.aggregators.aggregator import Aggregator, stack_models
from p2pfl_tpu_torch.learning.weights import ModelUpdate
from p2pfl_tpu_torch.ops.aggregation import fedmedian


class FedMedian(Aggregator):
    # medians over pre-averaged partials are not medians over models
    SUPPORTS_PARTIALS = False

    def aggregate(self, models: list[ModelUpdate]) -> ModelUpdate:
        return self.result(fedmedian(stack_models(models)), models)
