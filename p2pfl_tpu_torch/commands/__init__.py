"""Wire-protocol verbs of the port's gossip Node (the sync round's and the
secure-aggregation verbs of ``p2pfl_tpu/commands``; the async and DCN verbs
are not ported)."""

from p2pfl_tpu_torch.commands.command import Command
from p2pfl_tpu_torch.commands.control import (
    MetricsCommand,
    ModelInitializedCommand,
    ModelsAggregatedCommand,
    ModelsReadyCommand,
    SecAggNeedCommand,
    SecAggPubCommand,
    SecAggRecoverCommand,
    SecAggRevealCommand,
    SecAggShareCommand,
    VoteTrainSetCommand,
)
from p2pfl_tpu_torch.commands.heartbeat import HeartbeatCommand
from p2pfl_tpu_torch.commands.learning import (
    AddModelCommand,
    InitModelCommand,
    StartLearningCommand,
    StopLearningCommand,
)

__all__ = [
    "Command",
    "HeartbeatCommand",
    "StartLearningCommand",
    "StopLearningCommand",
    "ModelInitializedCommand",
    "VoteTrainSetCommand",
    "ModelsAggregatedCommand",
    "ModelsReadyCommand",
    "MetricsCommand",
    "SecAggPubCommand",
    "SecAggNeedCommand",
    "SecAggRecoverCommand",
    "SecAggRevealCommand",
    "SecAggShareCommand",
    "InitModelCommand",
    "AddModelCommand",
]
