"""Logger singleton facade (counterpart of ``p2pfl_tpu/management/logger.py``).

Colored stdout, a per-node registry (for the experiment and round a
metric belongs to), the local and global metric stores, and the
communication counters, which live in the telemetry registry (group
``"comm"``). The file handler and the web dashboard are not ported.
Per-node log lines are prefixed ``[addr]``.
"""

from __future__ import annotations

import logging
import threading
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
        self.local_metrics = LocalMetricStorage()
        self.global_metrics = GlobalMetricStorage()
        # addr -> (node_state, simulation_flag)
        self._nodes: Dict[str, Tuple[Any, bool]] = {}
        self._nodes_lock = threading.Lock()

    def set_level(self, level: str) -> None:
        self._logger.setLevel(level)

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
        if step is None:
            self.global_metrics.add_log(exp, round, metric, node, value)
        else:
            self.local_metrics.add_log(exp, round, metric, node, value, step)

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

    # ---- node registry ----

    def register_node(self, node: str, state: Any = None, simulation: bool = False) -> None:
        with self._nodes_lock:
            self._nodes[node] = (state, simulation)

    def unregister_node(self, node: str) -> None:
        with self._nodes_lock:
            self._nodes.pop(node, None)

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
