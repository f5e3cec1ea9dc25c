"""Stage ABC (reference ``p2pfl/stages/stage.py:23-34``)."""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import TYPE_CHECKING, Optional, Type

if TYPE_CHECKING:
    from p2pfl_tpu_torch.node import Node


class Stage(ABC):
    """One state of the round FSM. ``execute`` returns the next stage class."""

    name = "Stage"

    @staticmethod
    @abstractmethod
    def execute(node: "Node") -> Optional[Type["Stage"]]:
        ...
