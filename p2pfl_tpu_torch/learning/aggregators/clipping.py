"""Centered clipping (Karimireddy, He & Jaggi 2021), a history-aware
robust aggregator (counterpart of
``p2pfl_tpu/learning/aggregators/clipping.py``): from the previous
round's global model ``v``, iterate ``v ← v + mean_i clip_τ(x_i − v)``,
so an attacker moves the aggregate by at most τ a round."""

from __future__ import annotations

from p2pfl_tpu_torch.learning.aggregators.aggregator import Aggregator, stack_models
from p2pfl_tpu_torch.learning.weights import ModelUpdate
from p2pfl_tpu_torch.ops.aggregation import centered_clip, fedmedian


class CenteredClip(Aggregator):
    """No partials: the clip is nonlinear per node, so peers gossip
    individual models. Stateful: the clip center is the previous round's
    global model, resynced by :meth:`on_result` when a peer's finished
    aggregate arrives first, dropped by :meth:`reset_experiment`."""

    SUPPORTS_PARTIALS = False
    ALWAYS_AGGREGATE = True  # the center advances once a round

    def __init__(self, node_name: str = "unknown", tau: float = 1.0, iters: int = 3) -> None:
        super().__init__(node_name)
        if tau <= 0:
            # tau <= 0 zeroes every clip factor: the aggregate would never move
            raise ValueError(f"tau must be > 0 (got {tau})")
        if iters < 1:
            raise ValueError(f"iters must be >= 1 (got {iters})")
        self.tau = float(tau)
        self.iters = int(iters)
        self._center = None  # the previous round's global model

    def aggregate(self, models: list[ModelUpdate]) -> ModelUpdate:
        stacked = stack_models(models)
        # round 0 has no history: start from the coordinate-wise median (a
        # mean would hand a round-0 attacker the center)
        center = fedmedian(stacked) if self._center is None else self._center
        params = centered_clip(stacked, center, self.tau, self.iters)
        self._center = params
        return self.result(params, models)

    def on_result(self, update: ModelUpdate) -> ModelUpdate:
        # a peer's consensus aggregate is the next round's center
        self._center = update.params
        return update

    def reset_experiment(self) -> None:
        # a new experiment re-bootstraps from the median
        self._center = None
