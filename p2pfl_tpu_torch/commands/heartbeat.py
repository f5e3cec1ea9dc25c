"""``beat`` command (reference ``p2pfl/commands/heartbeat_command.py:70``)."""

from __future__ import annotations

from p2pfl_tpu_torch.commands.command import Command


class HeartbeatCommand(Command):
    def __init__(self, heartbeater) -> None:
        self._heartbeater = heartbeater

    @staticmethod
    def get_name() -> str:
        return "beat"

    def execute(self, source: str, round: int, *args, **kwargs) -> None:  # noqa: A002
        t = float(args[0]) if args else 0.0
        self._heartbeater.beat(source, t)
