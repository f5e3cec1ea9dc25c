"""Aggregation strategies of the port: the base collection state and FedAvg."""

from p2pfl_tpu_torch.learning.aggregators.aggregator import Aggregator
from p2pfl_tpu_torch.learning.aggregators.fedavg import FedAvg

__all__ = ["Aggregator", "FedAvg"]
