"""Control-plane reliability: retry backoff policy + per-neighbor breaker (a copy of ``p2pfl_tpu/communication/reliability.py``).

Two pieces against silent message loss (a failed ``_send`` returning
False with the broadcast simply gone):

- :func:`retry_delay` — bounded exponential backoff with jitter for
  message-plane retries (the :class:`~p2pfl_tpu_torch.communication.gossiper.
  Gossiper` schedules failed control sends through it, up to
  ``Settings.MESSAGE_RETRY_MAX`` attempts).
- :class:`CircuitBreaker` — per-neighbor consecutive-failure tracking.
  After ``Settings.BREAKER_THRESHOLD`` consecutive send failures a
  neighbor becomes *suspect*; the heartbeater evicts suspect neighbors
  after ``Settings.BREAKER_SUSPECT_TIMEOUT`` seconds of beat silence
  instead of waiting out the full ``HEARTBEAT_TIMEOUT`` — an
  accrual-style failure detector in the spirit of Hayashibara et al.
  (*The φ Accrual Failure Detector*, SRDS 2004): send outcomes feed the
  suspicion level continuously rather than a single binary timeout. One
  success closes the breaker.

Every transition is counted into the logger's communication metrics
(``breaker_open`` / ``breaker_close``; the heartbeater adds
``breaker_suspect_evict``), so chaos tests can assert that retries stay
bounded and suspects actually accelerate eviction.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Optional

from p2pfl_tpu_torch.management.logger import logger
from p2pfl_tpu_torch.settings import Settings


def retry_delay(attempt: int, rng: Optional[random.Random] = None) -> float:
    """Backoff before retry ``attempt`` (1-based): ``BASE * 2**(a-1)``
    capped at ``MESSAGE_RETRY_CAP``, times U(0.5, 1.0) jitter so a burst
    of failures against one neighbor does not retry in lockstep."""
    r = rng.random() if rng is not None else random.random()
    base = Settings.MESSAGE_RETRY_BASE * (2 ** max(attempt - 1, 0))
    return min(base, Settings.MESSAGE_RETRY_CAP) * (0.5 + r / 2)


class CircuitBreaker:
    """Consecutive-failure tracking per neighbor, thread-safe.

    ``record`` is called with every send outcome (all planes — beats,
    control gossip, model gossip all route through the protocol's send
    seam). State per neighbor: consecutive failure count, and — once the
    count crosses ``Settings.BREAKER_THRESHOLD`` — the monotonic time the
    breaker opened. Suspects are reported to the heartbeater's eviction
    sweep; :meth:`forget` drops all state when a neighbor is evicted or
    deliberately disconnected.
    """

    def __init__(self, self_addr: str) -> None:
        self.self_addr = self_addr
        self._lock = threading.Lock()
        self._failures: dict[str, int] = {}
        self._suspect_since: dict[str, float] = {}
        #: most recent failure per neighbor — the unreachable-despite-beats
        #: eviction requires the evidence to be ONGOING, not just old (see
        #: :meth:`suspects_older_than`)
        self._last_failure: dict[str, float] = {}

    def record(self, nei: str, ok: bool) -> None:
        with self._lock:
            if ok:
                self._failures.pop(nei, None)
                self._last_failure.pop(nei, None)
                if self._suspect_since.pop(nei, None) is not None:
                    logger.log_comm_metric(self.self_addr, "breaker_close")
                    from p2pfl_tpu_torch.management.telemetry import telemetry

                    telemetry.event(
                        self.self_addr, "breaker_close", kind="fault", attrs={"peer": nei}
                    )
                    logger.info(
                        self.self_addr,
                        f"Breaker closed for {nei} — send succeeded again",
                    )
                return
            count = self._failures.get(nei, 0) + 1
            self._failures[nei] = count
            self._last_failure[nei] = time.monotonic()
            if count >= Settings.BREAKER_THRESHOLD and nei not in self._suspect_since:
                self._suspect_since[nei] = time.monotonic()
                logger.log_comm_metric(self.self_addr, "breaker_open")
                # flight-recorder event on the affected edge: inside a send
                # span when the failing send is what tripped the breaker
                from p2pfl_tpu_torch.management.telemetry import telemetry

                telemetry.event(
                    self.self_addr,
                    "breaker_open",
                    kind="fault",
                    attrs={"peer": nei, "failures": count},
                )
                logger.info(
                    self.self_addr,
                    f"Breaker open for {nei}: {count} consecutive send "
                    "failures — suspect (early heartbeat eviction armed)",
                )

    def is_suspect(self, nei: str) -> bool:
        with self._lock:
            return nei in self._suspect_since

    def suspects(self) -> set[str]:
        with self._lock:
            return set(self._suspect_since)

    def suspects_older_than(self, age: float, fresh_within: Optional[float] = None) -> set[str]:
        """Neighbors whose breaker has been open for at least ``age``
        seconds — i.e. not one successful send in all that time. The
        heartbeater evicts these even if their beats still arrive (a
        one-way partition: the peer is alive but unreachable, so it is
        useless as a gossip target).

        ``fresh_within`` additionally requires the MOST RECENT failure to
        be at most that many seconds old: an open breaker whose evidence
        stopped accruing (the peer simply fell out of every send path —
        e.g. a non-direct gossip target the model plane converged away
        from) says nothing about the peer NOW, and evicting a live,
        beating neighbor on a stale burst of failures would be a false
        positive. Direct neighbors are beat targets every
        ``HEARTBEAT_PERIOD``, so a genuinely unreachable one keeps its
        evidence fresh for free."""
        now = time.monotonic()
        with self._lock:
            return {
                n
                for n, t0 in self._suspect_since.items()
                if now - t0 >= age
                and (
                    fresh_within is None
                    or now - self._last_failure.get(n, 0.0) <= fresh_within
                )
            }

    def forget(self, nei: str) -> None:
        with self._lock:
            self._failures.pop(nei, None)
            self._suspect_since.pop(nei, None)
            self._last_failure.pop(nei, None)

    def reset(self) -> None:
        with self._lock:
            self._failures.clear()
            self._suspect_since.clear()
            self._last_failure.clear()
