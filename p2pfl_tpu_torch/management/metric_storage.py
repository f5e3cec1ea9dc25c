"""In-memory metric stores (a copy of ``p2pfl_tpu/management/metric_storage.py``).

Reference: ``p2pfl/management/metric_storage.py:30-247``.

- :class:`LocalMetricStorage` — per-step training metrics:
  ``exp -> round -> node -> metric -> [(step, value), ...]``
- :class:`GlobalMetricStorage` — per-round evaluation metrics:
  ``exp -> node -> metric -> [(round, value), ...]`` with round dedup.
"""

from __future__ import annotations

import bisect
import copy
import threading
from typing import Dict, List, Set, Tuple

LocalLogs = Dict[str, Dict[int, Dict[str, Dict[str, List[Tuple[int, float]]]]]]
GlobalLogs = Dict[str, Dict[str, Dict[str, List[Tuple[int, float]]]]]


class LocalMetricStorage:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._logs: LocalLogs = {}

    def add_log(self, exp: str, rnd: int, metric: str, node: str, value: float, step: int) -> None:
        with self._lock:
            series = (
                self._logs.setdefault(exp, {})
                .setdefault(rnd, {})
                .setdefault(node, {})
                .setdefault(metric, [])
            )
            series.append((step, float(value)))

    def get_all_logs(self) -> LocalLogs:
        with self._lock:
            return copy.deepcopy(self._logs)

    def get_experiment_logs(self, exp: str):
        with self._lock:
            return copy.deepcopy(self._logs.get(exp, {}))

    def get_experiment_round_logs(self, exp: str, rnd: int):
        with self._lock:
            return copy.deepcopy(self._logs.get(exp, {}).get(rnd, {}))


class GlobalMetricStorage:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._logs: GlobalLogs = {}
        # per-series round membership: the dedup check is O(1) instead of
        # a full scan, and insertion keeps the series sorted via
        # bisect.insort instead of re-sorting the whole list per append —
        # add_log used to be O(n) per call, quadratic over an experiment
        self._rounds: Dict[Tuple[str, str, str], Set[int]] = {}

    def add_log(self, exp: str, rnd: int, metric: str, node: str, value: float) -> None:
        with self._lock:
            seen = self._rounds.setdefault((exp, node, metric), set())
            if rnd in seen:  # dedup by round, first write wins (reference 156-247)
                return
            seen.add(rnd)
            series = self._logs.setdefault(exp, {}).setdefault(node, {}).setdefault(metric, [])
            bisect.insort(series, (rnd, float(value)), key=lambda rv: rv[0])

    def get_all_logs(self) -> GlobalLogs:
        with self._lock:
            return copy.deepcopy(self._logs)

    def get_experiment_logs(self, exp: str):
        with self._lock:
            return copy.deepcopy(self._logs.get(exp, {}))
