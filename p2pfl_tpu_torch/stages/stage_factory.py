"""String-keyed stage registry (reference ``stages/stage_factory.py:26-59``).

The reference uses lazy imports here to break circular dependencies; this
rebuild's stages don't import the factory, so a plain registry suffices.
Custom workflows can register their own stages and jump into the FSM.
"""

from __future__ import annotations

from typing import Type

from p2pfl_tpu_torch.stages.stage import Stage


class StageFactory:
    _registry: dict[str, Type[Stage]] = {}

    @classmethod
    def register(cls, stage: Type[Stage]) -> Type[Stage]:
        cls._registry[stage.name] = stage
        return stage

    @classmethod
    def get_stage(cls, name: str) -> Type[Stage]:
        cls._ensure_builtins()
        if name not in cls._registry:
            raise KeyError(f"unknown stage {name!r}; known: {sorted(cls._registry)}")
        return cls._registry[name]

    @classmethod
    def _ensure_builtins(cls) -> None:
        if cls._registry:
            return
        from p2pfl_tpu_torch.stages import learning_stages as ls

        for stage in (
            ls.StartLearningStage,
            ls.VoteTrainSetStage,
            ls.TrainStage,
            ls.WaitAggregatedModelsStage,
            ls.GossipModelStage,
            ls.RoundFinishedStage,
        ):
            cls._registry[stage.name] = stage
