"""Stall watchdog (counterpart of ``p2pfl_tpu/management/watchdog.py``):
thread-stack dumps when a learning round stops moving.

Every stage transition stamps ``NodeState.current_stage`` and
``last_transition`` (``stages/workflow.py``). A daemon thread watches every
registered learning node and, when one sits in one stage longer than
``Settings.STALL_WATCHDOG_S``, logs the node, its stage and round and the
stack of every live thread (``sys._current_frames``), once a stall, and
counts a ``stall_detected`` comm metric. Detection only: it never kills
anything.
"""

from __future__ import annotations

import sys
import threading
import time
import traceback
from typing import Optional

from p2pfl_tpu_torch.management.logger import logger
from p2pfl_tpu_torch.settings import Settings


class StallWatchdog:
    """Process-wide daemon, started by ``Node.start()`` when
    ``Settings.STALL_WATCHDOG_S > 0``."""

    _instance: Optional["StallWatchdog"] = None
    _lock = threading.Lock()

    def __init__(self) -> None:
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        #: the stuck transition reported per node: one report a stall
        self._reported: dict[str, float] = {}

    # ---- lifecycle ----

    @classmethod
    def ensure_started(cls) -> Optional["StallWatchdog"]:
        if Settings.STALL_WATCHDOG_S <= 0:
            return None
        with cls._lock:
            if cls._instance is None:
                cls._instance = cls()
                cls._instance._start()
            return cls._instance

    @classmethod
    def shutdown(cls) -> None:
        with cls._lock:
            if cls._instance is not None:
                cls._instance._stop.set()
                cls._instance = None

    def _start(self) -> None:
        self._thread = threading.Thread(target=self._run, name="stall-watchdog", daemon=True)
        self._thread.start()

    # ---- detection ----

    def _run(self) -> None:
        while True:
            # re-read each tick so a changed knob takes effect; the 0.1 s
            # floor keeps a knob set to 0 after start from spinning
            period = max(min(1.0, Settings.STALL_WATCHDOG_S / 4), 0.1)
            if self._stop.wait(period):
                return
            try:
                self._scan()
            except Exception:  # noqa: BLE001 — diagnostics never take a node down
                pass

    def _scan(self) -> None:
        if Settings.STALL_WATCHDOG_S <= 0:
            return
        now = time.monotonic()
        states = logger.learning_states()
        live = {a for a, _s in states}
        for gone in [a for a in self._reported if a not in live]:
            self._reported.pop(gone, None)
        for addr, state in states:
            last = getattr(state, "last_transition", None)
            if last is None or state.status != "Learning" or now - last < Settings.STALL_WATCHDOG_S:
                self._reported.pop(addr, None)
                continue
            if self._reported.get(addr) == last:
                continue  # this stall is reported
            self._reported[addr] = last
            stage = getattr(state, "current_stage", "?")
            logger.log_comm_metric(addr, "stall_detected")
            logger.error(
                addr,
                f"STALL: no stage transition for {now - last:.0f}s "
                f"(stuck in {stage}, round {state.round}). Thread stacks:\n" + all_thread_stacks(),
            )


def all_thread_stacks() -> str:
    """Formatted stacks of every live thread, tagged with thread names."""
    names = {t.ident: t.name for t in threading.enumerate()}
    return "\n".join(
        f"--- thread {names.get(ident, ident)} ---\n" + "".join(traceback.format_stack(frame))
        for ident, frame in sys._current_frames().items()
    )
