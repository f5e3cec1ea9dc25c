"""Profiling helpers (counterpart of ``p2pfl_tpu/management/profiling.py``):
``torch.profiler`` traces and ranges, a barrier for timers, the card's
peak FLOP/s and MFU, FLOP counts, dispatch accounting and a section
stopwatch.

Dispatch accounting: process-wide counters of model-plane device
dispatches at the learner's, the aggregator's and the SPMD federation's
call sites (``eval_step``, ``train_epoch``, ``fused_round``,
``aggregate``, ``spmd_round``, ``spmd_rounds_fused``), in the telemetry
registry's ``"dispatch"`` group; the per-node count also lands in the
node's ``"device_dispatch"`` comm metric. :func:`dispatch_span` also
opens a ``p2pfl:<site>`` range of ``torch.profiler`` when
``settings.telemetry_annotations()`` is on, so one :func:`trace` holds
the host's dispatch ranges beside the card's kernels.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import tempfile
import threading
import time
from typing import Iterator, Optional

import torch

from p2pfl_tpu_torch.management.logger import logger
from p2pfl_tpu_torch.management.telemetry import LatencyHistogram, telemetry
from p2pfl_tpu_torch.settings import telemetry_annotations

_trace_seq = itertools.count()


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None) -> Iterator[torch.profiler.profile]:
    """Profile the enclosed block with ``torch.profiler`` (CPU and CUDA
    activity; CPU alone where no card is in use) and write its Chrome
    trace into ``log_dir`` (default: ``p2pfl_tpu_torch_trace`` in the
    temporary directory). Yields the live profile: after the block,
    ``prof.events()`` holds the events and ``prof.trace_path`` the file.
    The card is synchronised before the profiler stops, so the block's
    device work is inside the window."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "p2pfl_tpu_torch_trace")
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if cuda:
            torch.cuda.synchronize()
        prof.stop()
        os.makedirs(log_dir, exist_ok=True)
        prof.trace_path = os.path.join(log_dir, f"trace_{os.getpid()}_{next(_trace_seq)}.json")
        prof.export_chrome_trace(prof.trace_path)
        logger.info("profiler", f"trace written to {prof.trace_path}")


@contextlib.contextmanager
def annotate(name: str, step: Optional[int] = None) -> Iterator[None]:
    """Label the enclosed work in a profiler trace (``name`` or
    ``name#step``)."""
    with torch.profiler.record_function(name if step is None else f"{name}#{step}"):
        yield


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


def compiled_flops(fn, *args, **kwargs) -> Optional[float]:
    """FLOPs of one call of ``fn(*args, **kwargs)``, counted while the
    call RUNS: ``fn`` is called once, for real, and what it does stands
    (``compiled_flops(fed.run_round)`` trains one more round). Unlike the
    JAX package's, which lowers and compiles without running, PyTorch has
    no program to read a cost from before it runs. The count sums the
    formulas of ``torch.utils.flop_counter.flop_registry``: matmuls,
    convolutions, SDPA, forward and backward. The hand-written kernels,
    which launch through ``ctypes`` (the flash kernels), and elementwise
    work count nothing. A plain dispatch mode, not ``FlopCounterMode``:
    that one's module tracker raises inside ``torch.autograd.grad`` over
    leaves, which the LoRA rounds use. An error of ``fn`` propagates; None
    if a formula failed (the count would be short)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    class _Count(TorchDispatchMode):
        flops = 0
        failed = False

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            formula = flop_registry.get(func._overloadpacket)
            if formula is not None and not self.failed:
                try:
                    self.flops += formula(*args, **kwargs, out_val=out)
                except Exception:  # noqa: BLE001 — a formula's own fault: the count is lost, the call is not
                    self.failed = True
            return out

    with _Count() as counter:
        fn(*args, **kwargs)
    return None if counter.failed else float(counter.flops)


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


def total_dispatches() -> int:
    return int(sum(get_dispatch_counts().values()))


def reset_dispatch_counts() -> None:
    telemetry.reset_counters("dispatch")


def snapshot_and_reset_dispatch_counts() -> dict:
    """Read and clear the counts under one lock: a get-then-reset pair
    loses dispatches that land between the two calls."""
    return {k: int(v) for k, v in telemetry.snapshot_and_reset("dispatch", "").items()}


@contextlib.contextmanager
def dispatch_span(site: str, node: str = "", device=None, **attrs) -> Iterator[None]:
    """Wrap one model-plane call site: a ``"dispatch"``-plane span around
    the host-side dispatch (PyTorch returns before the card finishes), a
    ``p2pfl:<site>`` range of ``torch.profiler`` around the body when
    ``telemetry_annotations(device)`` is on, and a count once the body
    succeeded (a failed fused round falls back to the staged path and
    must not count twice)."""
    with telemetry.span(node, site, kind="dispatch", attrs=attrs or None):
        if telemetry_annotations(device):
            with torch.profiler.record_function(f"p2pfl:{site}"):
                yield
        else:
            yield
    record_dispatch(site, node)


class Stopwatch:
    """Wall-clock section timing: ``with sw.section("fit"): ...`` then
    ``sw.summary()``. Thread-safe (sections run on gossip worker threads
    too); each section is a :class:`LatencyHistogram`, so the summary has
    percentiles beside the totals."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._hists: dict[str, LatencyHistogram] = {}

    @contextlib.contextmanager
    def section(self, name: str) -> Iterator[None]:
        t0 = time.monotonic_ns()
        try:
            yield
        finally:
            hist = self._hists.get(name)
            if hist is None:
                with self._lock:
                    hist = self._hists.setdefault(name, LatencyHistogram())
            hist.record(time.monotonic_ns() - t0)

    @property
    def totals(self) -> dict[str, float]:
        with self._lock:
            items = list(self._hists.items())
        return {k: h.sum_ns / 1e9 for k, h in items}

    @property
    def counts(self) -> dict[str, int]:
        with self._lock:
            items = list(self._hists.items())
        return {k: h.count for k, h in items}

    def summary(self) -> dict[str, dict[str, float]]:
        with self._lock:
            items = list(self._hists.items())
        out: dict[str, dict[str, float]] = {}
        for k, h in items:
            s = h.summary()
            if not s.get("count"):
                continue
            out[k] = {
                "total_s": round(s["total_s"], 4),
                "calls": s["count"],
                "mean_s": round(s["total_s"] / s["count"], 4),
                "p50_ms": s["p50_ms"],
                "p95_ms": s["p95_ms"],
                "p99_ms": s["p99_ms"],
            }
        return out
