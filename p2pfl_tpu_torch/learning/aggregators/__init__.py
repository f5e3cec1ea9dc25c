"""Aggregation strategies of the port: the base collection state, FedAvg,
the robust rules and the FedOpt server optimizers."""

from p2pfl_tpu_torch.learning.aggregators.aggregator import Aggregator
from p2pfl_tpu_torch.learning.aggregators.bulyan import Bulyan
from p2pfl_tpu_torch.learning.aggregators.clipping import CenteredClip
from p2pfl_tpu_torch.learning.aggregators.fedavg import FedAvg
from p2pfl_tpu_torch.learning.aggregators.fedmedian import FedMedian
from p2pfl_tpu_torch.learning.aggregators.fedopt import FedAdagrad, FedAdam, FedOpt, FedYogi
from p2pfl_tpu_torch.learning.aggregators.krum import Krum
from p2pfl_tpu_torch.learning.aggregators.trimmed_mean import TrimmedMean

__all__ = [
    "Aggregator",
    "Bulyan",
    "CenteredClip",
    "FedAdagrad",
    "FedAdam",
    "FedAvg",
    "FedMedian",
    "FedOpt",
    "FedYogi",
    "Krum",
    "TrimmedMean",
]
