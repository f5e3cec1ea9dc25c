"""Per-node resource monitor (counterpart of
``p2pfl_tpu/management/node_monitor.py``).

A daemon thread samples every ``Settings.RESOURCE_MONITOR_PERIOD``
seconds: CPU %, RAM % and network MB/s out and in from psutil, and
``device{i}_mem_mb``, the memory PyTorch's allocator holds on each visible
CUDA device (``torch.cuda.memory_stats(i)["allocated_bytes.all.current"]``).
Unlike the JAX package's monitor, which returns when psutil is missing,
this one samples the card regardless: without psutil it reports the
device memory alone.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

import torch

from p2pfl_tpu_torch.management.logger import logger
from p2pfl_tpu_torch.settings import Settings

ReportFn = Callable[[str, str, float], None]  # (node, metric, value)


def _default_report(node: str, metric: str, value: float) -> None:
    logger.log_metric(node, metric, value, step=int(time.time()))


class NodeMonitor:
    def __init__(self, node: str, report_fn: Optional[ReportFn] = None) -> None:
        self.node = node
        self._report = report_fn or _default_report
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._last_net: Optional[tuple[float, float, float]] = None

    def start(self) -> None:
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, name=f"monitor-{self.node}", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None

    def _run(self) -> None:
        try:
            import psutil
        except ImportError:
            psutil = None
            logger.debug(self.node, "psutil unavailable: the monitor samples device memory alone")
        while not self._stop.is_set():
            try:
                if psutil is not None:
                    self._report_host(psutil)
                self._report_device_memory()
            except Exception as exc:  # noqa: BLE001 — a monitor never kills a node
                logger.debug(self.node, f"monitor sample failed: {exc}")
            if self._stop.wait(timeout=Settings.RESOURCE_MONITOR_PERIOD):
                return

    def _report_host(self, psutil) -> None:
        self._report(self.node, "cpu_percent", psutil.cpu_percent(interval=None))
        self._report(self.node, "ram_percent", psutil.virtual_memory().percent)
        net = psutil.net_io_counters()
        now = time.monotonic()
        if self._last_net is not None:
            t0, sent0, recv0 = self._last_net
            dt = max(now - t0, 1e-6)
            self._report(self.node, "net_out_mbs", (net.bytes_sent - sent0) / dt / 1e6)
            self._report(self.node, "net_in_mbs", (net.bytes_recv - recv0) / dt / 1e6)
        self._last_net = (now, net.bytes_sent, net.bytes_recv)

    def _report_device_memory(self) -> None:
        if not torch.cuda.is_available():
            return
        for i in range(torch.cuda.device_count()):
            stats = torch.cuda.memory_stats(i)
            if "allocated_bytes.all.current" in stats:
                self._report(self.node, f"device{i}_mem_mb", stats["allocated_bytes.all.current"] / 1e6)
