"""FedOpt: server-side adaptive optimizers (Reddi et al. 2021)
(counterpart of ``p2pfl_tpu/learning/aggregators/fedopt.py``).

The round's FedAvg is not the new model: ``prev_global − fedavg`` is a
pseudo-gradient for a server optimizer (Adam, Yogi or Adagrad,
``ops/aggregation.py::fedopt_update``). The server state lives on every
aggregating node and stays identical across nodes while the train set is
stable (the reference votes in round 0 only); with
``Settings.VOTE_EVERY_ROUND`` a newly elected node starts from fresh
moments (warned once).
"""

from __future__ import annotations

import torch

from p2pfl_tpu_torch.learning.aggregators.aggregator import Aggregator, stack_models
from p2pfl_tpu_torch.learning.weights import ModelUpdate
from p2pfl_tpu_torch.management.logger import logger
from p2pfl_tpu_torch.ops.aggregation import fedavg, fedopt_update
from p2pfl_tpu_torch.ops.tree import tree_leaves, tree_map
from p2pfl_tpu_torch.settings import Settings


def _zeros(tree: dict) -> dict:
    return tree_map(lambda x: torch.zeros_like(x, dtype=torch.float32), tree)


class FedOpt(Aggregator):
    """FedAvg plus a server step; subclasses pin the optimizer. No
    partials: the step is nonlinear and stateful, so it runs once a round
    on the individual models."""

    SUPPORTS_PARTIALS = False
    ALWAYS_AGGREGATE = True  # one model must still take the server step
    SERVER_OPT = "adam"

    def __init__(
        self, node_name: str = "unknown", server_lr: float = 0.1, beta1: float = 0.9,
        beta2: float = 0.99, tau: float = 1e-3,
    ) -> None:
        super().__init__(node_name)
        self.server_lr = server_lr
        self.beta1 = beta1
        self.beta2 = beta2
        self.tau = tau
        self._prev = None  # the previous global model (the server's x_t)
        self._m = None
        self._v = None
        self._t = 0
        self._warned = False

    def aggregate(self, models: list[ModelUpdate]) -> ModelUpdate:
        weights = torch.tensor([float(m.num_samples) for m in models])
        avg = fedavg(stack_models(models), weights, Settings.AGG_DTYPE)
        if self._prev is None:
            # round 0: adopt the average and start the server state there
            if Settings.VOTE_EVERY_ROUND and not self._warned:
                self._warned = True
                logger.warning(
                    self.node_name,
                    "FedOpt with per-round voting: newly elected nodes start with fresh "
                    "server moments and briefly diverge from peers",
                )
            self._prev, self._m, self._v = avg, _zeros(avg), _zeros(avg)
            return self.result(avg, models)
        self._t += 1
        t = torch.tensor(float(self._t), device=tree_leaves(avg)[0].device)
        new, self._m, self._v = fedopt_update(
            self._prev, avg, self._m, self._v, t, opt=self.SERVER_OPT, lr=self.server_lr,
            b1=self.beta1, b2=self.beta2, tau=self.tau,
        )
        self._prev = new
        return self.result(new, models)

    def on_result(self, update: ModelUpdate) -> ModelUpdate:
        # the round resolved to a peer's server-stepped aggregate: it is
        # the server's x_t, and the moments must exist for the node's own
        # next aggregate
        self._prev = update.params
        if self._m is None:
            self._m, self._v = _zeros(update.params), _zeros(update.params)
        return update

    def reset_experiment(self) -> None:
        self._prev = self._m = self._v = None
        self._t = 0


class FedAdam(FedOpt):
    SERVER_OPT = "adam"


class FedYogi(FedOpt):
    SERVER_OPT = "yogi"


class FedAdagrad(FedOpt):
    SERVER_OPT = "adagrad"
