"""Logger singleton facade (counterpart of ``p2pfl_tpu/management/logger.py``).

Colored stdout, an optional rotating file (:meth:`P2pflLogger.
enable_file_logging`), a per-node registry (for the experiment and round a
metric belongs to, and the stall watchdog's scan), the local and global
metric stores, the communication counters, which live in the telemetry
registry (group ``"comm"``), and an optional web dashboard
(:meth:`P2pflLogger.connect_web_services`): once connected, node
registrations, log lines and metrics mirror to it, and each registered
node runs a :class:`~p2pfl_tpu_torch.management.node_monitor.NodeMonitor`
reporting to it. Per-node log lines are prefixed ``[addr]``.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from logging.handlers import RotatingFileHandler
from typing import Any, Dict, Optional, Tuple

from p2pfl_tpu_torch.management.metric_storage import GlobalMetricStorage, LocalMetricStorage
from p2pfl_tpu_torch.settings import Settings

_COLORS = {
    "DEBUG": "\033[90m",
    "INFO": "\033[32m",
    "WARNING": "\033[33m",
    "ERROR": "\033[31m",
    "CRITICAL": "\033[41m",
}
_RESET = "\033[0m"


class _ColorFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        color = _COLORS.get(record.levelname, "")
        record.levelcolor = f"{color}{record.levelname}{_RESET}"
        return super().format(record)


class _WebLogHandler(logging.Handler):
    """Ships every log line to the dashboard. It sits behind a
    ``QueueListener``, so a slow or dead dashboard never blocks the thread
    that logged."""

    def __init__(self, web: Any) -> None:
        super().__init__()
        self._web = web

    def emit(self, record: logging.LogRecord) -> None:
        try:
            node = getattr(record, "node", "unknown")
            self._web.send_log(time.strftime("%Y-%m-%d %H:%M:%S"), node, record.levelname, record.getMessage())
        except Exception:  # noqa: BLE001 — dashboard failures never break training
            pass


class P2pflLogger:
    """Singleton. Use the module-level ``logger`` instance."""

    _instance: Optional["P2pflLogger"] = None
    _instance_lock = threading.Lock()

    def __new__(cls) -> "P2pflLogger":
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = super().__new__(cls)
                cls._instance._init()
            return cls._instance

    def _init(self) -> None:
        self._logger = logging.getLogger("p2pfl_tpu_torch")
        self._logger.setLevel(Settings.LOG_LEVEL)
        self._logger.propagate = False
        if not self._logger.handlers:
            sh = logging.StreamHandler()
            sh.setFormatter(_ColorFormatter("%(asctime)s | %(levelcolor)s | %(message)s", datefmt="%H:%M:%S"))
            self._logger.addHandler(sh)
        self._file_handler: Optional[logging.Handler] = None
        self.local_metrics = LocalMetricStorage()
        self.global_metrics = GlobalMetricStorage()
        # addr -> (node_state, simulation_flag)
        self._nodes: Dict[str, Tuple[Any, bool]] = {}
        self._nodes_lock = threading.Lock()
        # the optional dashboard: log lines and metrics mirror to it, and a
        # NodeMonitor runs a registered node
        self._web: Any = None
        self._monitors: Dict[str, Any] = {}
        self._web_listener: Any = None
        self._web_queue_handler: Optional[logging.Handler] = None

    # ---- setup ----

    def set_level(self, level: str) -> None:
        self._logger.setLevel(level)

    def enable_file_logging(self, log_dir: Optional[str] = None) -> str:
        """Add a rotating file (10 MB, 3 backups) in ``log_dir`` (default
        ``Settings.LOG_DIR``); returns its path. A second call keeps the
        first file."""
        if self._file_handler is None:
            log_dir = log_dir or Settings.LOG_DIR
            os.makedirs(log_dir, exist_ok=True)
            fh = RotatingFileHandler(
                os.path.join(log_dir, "p2pfl_tpu_torch.log"), maxBytes=10_000_000, backupCount=3
            )
            fh.setFormatter(logging.Formatter("%(asctime)s | %(levelname)s | %(message)s"))
            self._logger.addHandler(fh)
            self._file_handler = fh
        return self._file_handler.baseFilename

    def disable_file_logging(self) -> None:
        if self._file_handler is not None:
            self._logger.removeHandler(self._file_handler)
            self._file_handler.close()
            self._file_handler = None

    def connect_web_services(self, web: Any) -> None:
        """Attach a :class:`~p2pfl_tpu_torch.management.web_services.
        WebServices`: later node registrations, log lines and metrics are
        pushed to the dashboard, and each node registered from now on runs
        a resource monitor reporting to it."""
        import queue
        from logging.handlers import QueueHandler, QueueListener

        self.disconnect_web_services()
        self._web = web
        q: "queue.SimpleQueue[logging.LogRecord]" = queue.SimpleQueue()
        self._web_queue_handler = QueueHandler(q)
        self._web_listener = QueueListener(q, _WebLogHandler(web))
        self._web_listener.start()
        self._logger.addHandler(self._web_queue_handler)

    def disconnect_web_services(self) -> None:
        """Stop every monitor and the log queue; detach the dashboard."""
        for monitor in self._monitors.values():
            monitor.stop()
        self._monitors.clear()
        if self._web_queue_handler is not None:
            self._logger.removeHandler(self._web_queue_handler)
            self._web_queue_handler = None
        if self._web_listener is not None:
            self._web_listener.stop()
            self._web_listener = None
        self._web = None

    # ---- leveled logging, keyed by node addr ----

    def log(self, level: int, node: str, message: str) -> None:
        self._logger.log(level, f"[{node}] {message}", extra={"node": node})

    def debug(self, node: str, message: str) -> None:
        self.log(logging.DEBUG, node, message)

    def info(self, node: str, message: str) -> None:
        self.log(logging.INFO, node, message)

    def warning(self, node: str, message: str) -> None:
        self.log(logging.WARNING, node, message)

    def error(self, node: str, message: str) -> None:
        self.log(logging.ERROR, node, message)

    def critical(self, node: str, message: str) -> None:
        self.log(logging.CRITICAL, node, message)

    # ---- metrics ----

    def log_metric(
        self,
        node: str,
        metric: str,
        value: float,
        step: Optional[int] = None,
        round: Optional[int] = None,  # noqa: A002 — reference API name
        experiment: Optional[str] = None,
    ) -> None:
        exp = experiment or self._experiment_for(node) or "unknown-exp"
        if round is None:
            round = self._round_for(node)  # noqa: A001
        if round is None:
            round = 0  # noqa: A001
        web = self._web
        if step is None:
            self.global_metrics.add_log(exp, round, metric, node, value)
            if web is not None:
                web.send_global_metric(exp, round, metric, node, value)
        else:
            self.local_metrics.add_log(exp, round, metric, node, value, step)
            if web is not None:
                web.send_local_metric(exp, round, metric, node, step, value)

    def get_local_logs(self):
        return self.local_metrics.get_all_logs()

    def get_global_logs(self):
        return self.global_metrics.get_all_logs()

    # ---- communication metrics (a view of telemetry's "comm" counters) ----

    def log_comm_metric(self, node: str, metric: str, value: float = 1.0) -> None:
        from p2pfl_tpu_torch.management.telemetry import telemetry

        telemetry.inc("comm", node, metric, value)

    def get_comm_metrics(self, node: Optional[str] = None) -> Dict:
        from p2pfl_tpu_torch.management.telemetry import telemetry

        return telemetry.counters("comm", node)

    def reset_comm_metrics(self) -> None:
        from p2pfl_tpu_torch.management.telemetry import telemetry

        telemetry.reset_counters("comm")

    def snapshot_and_reset_comm_metrics(self, node: Optional[str] = None) -> Dict:
        """Read and clear the comm counters under one lock: a get-then-reset
        pair loses increments that land between the two calls."""
        from p2pfl_tpu_torch.management.telemetry import telemetry

        return telemetry.snapshot_and_reset("comm", node)

    # ---- node registry ----

    def register_node(self, node: str, state: Any = None, simulation: bool = False) -> None:
        with self._nodes_lock:
            self._nodes[node] = (state, simulation)
        web = self._web
        if web is not None:
            from p2pfl_tpu_torch.management.node_monitor import NodeMonitor

            web.register_node(node, is_simulated=simulation)
            monitor = NodeMonitor(
                node, report_fn=lambda n, m, v: web.send_system_metric(n, m, v, time.strftime("%Y-%m-%d %H:%M:%S"))
            )
            monitor.start()
            previous = self._monitors.pop(node, None)
            if previous is not None:  # a node registered twice keeps one monitor
                previous.stop()
            self._monitors[node] = monitor

    def learning_states(self) -> list:
        """``(addr, state)`` of every registered node that has a state
        object: the stall watchdog's scan."""
        with self._nodes_lock:
            return [(n, s) for n, (s, _sim) in self._nodes.items() if s is not None]

    def unregister_node(self, node: str) -> None:
        with self._nodes_lock:
            self._nodes.pop(node, None)
        monitor = self._monitors.pop(node, None)
        if monitor is not None:
            monitor.stop()
        if self._web is not None:
            self._web.unregister_node(node)

    def _experiment_for(self, node: str) -> Optional[str]:
        with self._nodes_lock:
            entry = self._nodes.get(node)
        state = entry[0] if entry else None
        return getattr(state, "experiment_name", None) if state is not None else None

    def _round_for(self, node: str) -> Optional[int]:
        with self._nodes_lock:
            entry = self._nodes.get(node)
        state = entry[0] if entry else None
        return getattr(state, "round", None) if state is not None else None

    # ---- lifecycle hooks ----

    def experiment_started(self, node: str) -> None:
        self.debug(node, "experiment started")

    def experiment_finished(self, node: str) -> None:
        self.debug(node, "experiment finished")

    def round_finished(self, node: str) -> None:
        self.debug(node, "round finished")


logger = P2pflLogger()
