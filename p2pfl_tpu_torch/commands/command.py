"""Command ABC (reference ``p2pfl/commands/command.py:24-43``)."""

from __future__ import annotations

from abc import ABC, abstractmethod


class Command(ABC):
    @staticmethod
    @abstractmethod
    def get_name() -> str:
        ...

    @abstractmethod
    def execute(self, source: str, round: int, *args, **kwargs) -> None:  # noqa: A002
        ...
