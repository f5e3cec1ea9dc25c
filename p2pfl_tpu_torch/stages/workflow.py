"""Workflow loop (counterpart of ``p2pfl_tpu/stages/workflow.py``)."""

from __future__ import annotations

import time
from typing import TYPE_CHECKING

from p2pfl_tpu_torch.management.logger import logger
from p2pfl_tpu_torch.management.telemetry import telemetry

if TYPE_CHECKING:
    from p2pfl_tpu_torch.node import Node


class LearningWorkflow:
    """Runs stages until one returns ``None``. Exceptions end the experiment."""

    def run(self, node: "Node") -> None:
        from p2pfl_tpu_torch.communication.faults import FaultCrash
        from p2pfl_tpu_torch.stages.learning_stages import RoundFinishedStage, StartLearningStage

        def flush_pending_metrics() -> None:
            # a round that trained but never reached RoundFinishedStage
            # (interrupt mid-gossip, stage failure) still publishes the
            # metrics the staged path would have, before state.clear() so
            # they keep their experiment; the transport may be stopping
            try:
                RoundFinishedStage._flush_round_metrics(node)
            except Exception:  # noqa: BLE001 — the abort-path flush never masks the exit
                pass

        stage = StartLearningStage
        try:
            while stage is not None:
                logger.debug(node.addr, f"── stage: {stage.name}")
                state = node.state
                state.current_stage = stage.name
                state.last_transition = time.monotonic()
                # one deterministic trace id per (experiment epoch, round): every
                # node's spans of a round share it with no coordination
                trace_id = f"{state.experiment_name or 'exp'}:{state.experiment_epoch}:r{state.round or 0}"
                try:
                    for hook in node.stage_hooks:
                        hook(node, stage.name)
                    with telemetry.span(
                        node.addr, stage.name, kind="stage",
                        attrs={"round": state.round, "experiment": state.experiment_name},
                        trace_id=trace_id,
                    ):
                        stage = stage.execute(node)
                except Exception as exc:  # noqa: BLE001 — stage failure ends learning, not the node
                    if isinstance(exc, FaultCrash):
                        # an injected crash publishes nothing, like a killed process
                        node.learner.pop_round_metrics()
                    else:
                        flush_pending_metrics()
                    if node.learning_interrupted():
                        logger.info(node.addr, f"Learning interrupted during {stage.name}")
                    else:
                        logger.error(node.addr, f"Stage {stage.name} failed: {exc!r}")
                        # a failed stage must not leave experiment state or an
                        # open aggregation window latched into the next experiment
                        node.state.clear()
                        node.aggregator.clear()
                    return
        finally:
            # every other exit (a stage returning None mid-round); a no-op
            # after a flush, the stash pops on read
            flush_pending_metrics()
