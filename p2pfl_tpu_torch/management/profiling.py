"""Dispatch accounting (the ``dispatch_span`` part of ``p2pfl_tpu/management/profiling.py``).

Process-wide counters of model-plane device dispatches at the learner's
and the aggregator's call sites (``eval_step``, ``train_epoch``,
``aggregate``), in the telemetry registry's ``"dispatch"`` group; the
per-node count also lands in the node's ``"device_dispatch"`` comm
metric.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

from p2pfl_tpu_torch.management.logger import logger
from p2pfl_tpu_torch.management.telemetry import telemetry


def record_dispatch(site: str, node: str = "") -> None:
    """Count one model-plane device dispatch issued at ``site``."""
    telemetry.inc("dispatch", "", site)
    if node:
        logger.log_comm_metric(node, "device_dispatch")


def get_dispatch_counts() -> dict:
    return {k: int(v) for k, v in telemetry.counters("dispatch", "").items()}


def reset_dispatch_counts() -> None:
    telemetry.reset_counters("dispatch")


@contextlib.contextmanager
def dispatch_span(site: str, node: str = "", **attrs) -> Iterator[None]:
    """Wrap one model-plane call site: a ``"dispatch"``-plane span around
    the host-side dispatch, and a count once the body succeeded."""
    with telemetry.span(node, site, kind="dispatch", attrs=attrs or None):
        yield
    record_dispatch(site, node)
