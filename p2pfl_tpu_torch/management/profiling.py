"""Profiling helpers (counterpart of ``p2pfl_tpu/management/profiling.py``):
a barrier for timers, the card's peak FLOP/s and MFU, and dispatch
accounting.

Dispatch accounting: process-wide counters of model-plane device
dispatches at the learner's and the aggregator's call sites
(``eval_step``, ``train_epoch``, ``aggregate``), in the telemetry
registry's ``"dispatch"`` group; the per-node count also lands in the
node's ``"device_dispatch"`` comm metric.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional

import torch

from p2pfl_tpu_torch.management.logger import logger
from p2pfl_tpu_torch.management.telemetry import telemetry


# bf16 dense tensor-core peak FLOP/s by device name (NVIDIA data sheets,
# no sparsity; the SXM parts at their full power limit); used to turn
# achieved FLOP/s into model-FLOPs-utilization
_PEAK_FLOPS = {
    "H100 80GB HBM3": 989e12,  # H100 SXM5
    "H100 PCIe": 756e12,
    "A100": 312e12,
}


def peak_flops(device=None) -> Optional[float]:
    """Peak bf16 FLOP/s of a CUDA device (``None``: the current one), or
    None for the CPU and for cards not in the table."""
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device)
    return next((peak for key, peak in _PEAK_FLOPS.items() if key in name), None)


def force_execution(tree) -> float:
    """Block until ``tree``'s pending device work finished: synchronize
    the card, then fetch one element of the first leaf (a tiny transfer
    that depends on the work). Every timer of the port uses this."""
    leaves = torch.utils._pytree.tree_leaves(tree)
    if not leaves:
        return 0.0
    leaf = leaves[0]
    if not isinstance(leaf, torch.Tensor):
        return float(leaf)
    if leaf.is_cuda:
        torch.cuda.synchronize(leaf.device)
    return float(leaf.reshape(-1)[0])


def mfu(flops: Optional[float], seconds: float, n_devices: int = 1, device=None) -> Optional[float]:
    """Model-FLOPs-utilization: achieved FLOP/s over the devices' peak;
    None off the card or for an unknown card."""
    peak = peak_flops(device)
    if flops is None or peak is None or seconds <= 0:
        return None
    return flops / seconds / (peak * n_devices)


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
