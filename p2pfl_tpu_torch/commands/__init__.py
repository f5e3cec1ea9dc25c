"""Wire-protocol verbs of the port's gossip Node (the sync round's, the
secure-aggregation and the async-federation verbs of ``p2pfl_tpu/commands``;
the DCN verbs are not ported)."""

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
from p2pfl_tpu_torch.commands.federation import (
    AsyncDoneCommand,
    AsyncJoinCommand,
    AsyncLeaveCommand,
    AsyncModelCommand,
    AsyncPullCommand,
    AsyncUpdateCommand,
    AsyncViewCommand,
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
    "AsyncUpdateCommand",
    "AsyncModelCommand",
    "AsyncDoneCommand",
    "AsyncJoinCommand",
    "AsyncPullCommand",
    "AsyncViewCommand",
    "AsyncLeaveCommand",
]
