"""Two-mode gossiper: async message plane + synchronous model-gossip loop (a copy of ``p2pfl_tpu/communication/gossiper.py``).

Reference semantics (``p2pfl/communication/gossiper.py:31-243``):

(a) *Message plane* — a daemon thread drains a queue of
    ``(message, pending_neighbors)`` pairs, at most
    ``GOSSIP_MESSAGES_PER_PERIOD`` sends per ``GOSSIP_PERIOD``; a bounded
    ring of seen message ids provides network-wide dedup.

(b) *Model plane* — ``gossip_weights`` runs a synchronous tick loop on the
    calling (stage) thread: each tick picks ``GOSSIP_MODELS_PER_ROUND``
    random candidates, builds a per-candidate payload, sends it, and exits
    when there are no candidates, the early-stop predicate fires, or the
    observed status is unchanged for ``GOSSIP_EXIT_ON_X_EQUAL_ROUNDS`` ticks
    (convergence detector, reference 209-226).

Concurrent fan-out (departure from the reference, which sends strictly
sequentially on both planes): sends are dispatched through a bounded
``ThreadPoolExecutor`` of ``Settings.GOSSIP_SEND_WORKERS`` threads with a
per-batch wall-clock budget of ``Settings.GOSSIP_SEND_TIMEOUT``. A stalled
peer therefore costs one worker slot, not the tick: the other candidates'
payloads are already on the wire while it hangs, and the tick moves on once
the budget expires. A send still in flight marks its neighbor busy — the
next tick skips that neighbor instead of stacking a second worker behind the
same stall — and results are collected in submission order so the caller's
convergence accounting is deterministic.

Control-plane reliability (departure from the reference, where a failed
send simply loses the message): a message-plane send that returns a
definitive False is retried with exponential backoff + jitter
(``communication/reliability.py``) up to ``Settings.MESSAGE_RETRY_MAX``
attempts before being dropped loudly (``msg_retry_exhausted`` metric);
``CommunicationProtocol.send`` routes its broadcast failures into the same
queue. Every definitive outcome also feeds the protocol's per-neighbor
circuit breaker via ``on_result``, which is what accelerates heartbeat
eviction of genuinely dead peers. Payload construction (``model_fn``)
stays on the calling thread — aggregator/learner state is never read
concurrently — but it is LAZY: the model plane passes payload builders, and
``_dispatch_sends`` resolves each one right before submitting its
neighbor's task, so candidate ``i+1``'s payload build (a partial
aggregate, or on the ICI plane nothing until the send itself) overlaps
candidate ``i``'s in-flight send. Send outcomes are counted into the logger's
communication metrics (``gossip_send_ok`` / ``_fail`` / ``_timeout`` /
``_inflight_skip``).
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time
from collections import OrderedDict, deque
from functools import partial
from concurrent.futures import CancelledError, Future, ThreadPoolExecutor
from concurrent.futures import TimeoutError as FuturesTimeout  # builtin alias only on 3.11+
from typing import Callable, Optional

from p2pfl_tpu_torch.communication.heartbeater import BEAT_CMD
from p2pfl_tpu_torch.communication.message import Message
from p2pfl_tpu_torch.communication.reliability import retry_delay
from p2pfl_tpu_torch.management.logger import logger
from p2pfl_tpu_torch.settings import Settings


class Gossiper:
    def __init__(
        self,
        self_addr: str,
        send_fn: Callable[..., bool],
        on_result: Optional[Callable[[str, bool], None]] = None,
    ) -> None:
        self.self_addr = self_addr
        self._send = send_fn  # (nei, env, create_connection=False) -> bool
        # definitive per-neighbor send outcomes (True/False, never
        # timeouts — a stalled-but-running send is not evidence of death)
        # are reported here; the protocol feeds its circuit breaker
        self._on_result = on_result
        # message-plane queue entries: (message, pending_neighbors, attempt)
        self._queue: deque[tuple[Message, list[str], int]] = deque()
        self._queue_cv = threading.Condition()
        # failed control sends wait out their backoff here:
        # (due_monotonic, seq, attempt, neighbor, message) — guarded by
        # _queue_cv's lock; the gossip thread drains due entries each tick
        self._retries: list[tuple[float, int, int, str, Message]] = []
        self._retry_seq = itertools.count()
        self._processed: OrderedDict[str, None] = OrderedDict()
        self._processed_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._pool: Optional[ThreadPoolExecutor] = None
        # neighbor -> the specific send task that outlived its budget and is
        # STILL running — guarded by _stalled_lock, cleared when THAT task
        # completes (a different plane's send to the same neighbor finishing
        # must not unmark a still-stuck one). Only marked neighbors are
        # skipped. NOTE: ordering is guaranteed per neighbor only WITHIN a
        # dispatch batch; cross-batch sends to one neighbor may interleave
        # (receivers' dedup/overlap rejection absorbs reordering).
        self._stalled: dict[str, Future] = {}
        self._stalled_lock = threading.Lock()

    # ---- lifecycle ----

    def start(self) -> None:
        self._stop.clear()
        with self._queue_cv:
            # backoff entries scheduled against the previous run's overlay
            # state must not fire into a fresh start
            self._retries.clear()
        with self._stalled_lock:
            # a send that hung past stop() never runs its done-callback
            # (shutdown can't cancel RUNNING tasks), so its _stalled entry
            # would outlive the old pool and silently exclude that neighbor
            # from every future tick; a fresh start gets a clean slate (the
            # orphaned callback's identity check no-ops against new entries)
            self._stalled.clear()
        self._pool = ThreadPoolExecutor(
            max_workers=max(1, Settings.GOSSIP_SEND_WORKERS),
            thread_name_prefix=f"gossip-send-{self.self_addr}",
        )
        self._thread = threading.Thread(
            target=self._run, name=f"gossiper-{self.self_addr}", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        with self._queue_cv:
            self._queue_cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None
        if self._pool is not None:
            # don't wait: a stalled peer's send may never return
            self._pool.shutdown(wait=False, cancel_futures=True)
            self._pool = None

    # ---- dedup ring ----

    def check_and_set_processed(self, msg_id: str) -> bool:
        """True if unseen (and marks it seen); False for duplicates."""
        with self._processed_lock:
            if msg_id in self._processed:
                return False
            self._processed[msg_id] = None
            while len(self._processed) > Settings.AMOUNT_LAST_MESSAGES_SAVED:
                self._processed.popitem(last=False)
            return True

    def _report(self, nei: str, ok: bool) -> None:
        if self._on_result is not None:
            try:
                self._on_result(nei, ok)
            except Exception:  # noqa: BLE001 — observers must not break sends
                pass

    # ---- concurrent send dispatch (both planes) ----

    def _dispatch_sends(
        self,
        sends: list[tuple[str, object]],
        create_connection: bool = False,
        on_late_failure: Optional[Callable[[str, object], None]] = None,
    ) -> tuple[list[Optional[bool]], list[tuple[str, object]]]:
        """Fan ``(neighbor, envelope)`` sends out across the worker pool.

        Sends are grouped per neighbor — one worker task per batch per
        neighbor runs that neighbor's envelopes in order (distinct
        neighbors proceed concurrently; ordering across batches is NOT
        guaranteed). An envelope may be a zero-arg CALLABLE: it is resolved
        on the calling thread immediately before its neighbor's task is
        submitted, so payload construction (a partial aggregate) for candidate ``i+1`` overlaps candidate ``i``'s in-flight send
        instead of serializing ahead of the whole batch — while aggregator
        and learner state are still only ever read from this one thread. A
        callable resolving to ``None`` declines the send (its slot stays
        ``None`` in the results). Returns ``(results, skipped)``: per-send
        outcomes in submission order — True/False from the transport, or
        None when the send outlived its ``GOSSIP_SEND_TIMEOUT`` budget (it
        keeps running on its worker; the neighbor is marked stalled until
        that exact task finishes) — plus the sends that were never
        submitted because their neighbor was already stalled (the message
        plane requeues those; the model plane rebuilds next tick anyway).

        A timed-out send's LATE outcome is not discarded: when the worker
        eventually finishes, the result still feeds metrics and the
        breaker, and each envelope that ultimately FAILED is handed to
        ``on_late_failure`` (the message plane schedules a retry there —
        without this, a send that hung past its budget and then failed
        would be silently lost, the exact hole the retry queue closes for
        prompt failures).
        """
        pool = self._pool
        if pool is None or Settings.GOSSIP_SEND_WORKERS <= 1:
            # not started (unit tests poking the loop directly), or
            # explicitly sequential: send inline on the calling thread —
            # the pre-overhaul behavior, each plane its own serial lane
            out: list[Optional[bool]] = []
            for nei, env in sends:
                if callable(env):
                    env = env()
                if env is None:
                    out.append(None)
                    continue
                ok = self._send(nei, env, create_connection=create_connection)
                logger.log_comm_metric(
                    self.self_addr, "gossip_send_ok" if ok else "gossip_send_fail"
                )
                self._report(nei, bool(ok))
                out.append(ok)
            return out, []
        timeout = Settings.GOSSIP_SEND_TIMEOUT
        workers = max(1, Settings.GOSSIP_SEND_WORKERS)
        results: list[Optional[bool]] = [None] * len(sends)
        grouped: "OrderedDict[str, list[tuple[int, object]]]" = OrderedDict()
        for i, (nei, env) in enumerate(sends):
            grouped.setdefault(nei, []).append((i, env))

        # per-task start times: the per-send budget counts from when the
        # task actually STARTS on a worker — a healthy send queued behind a
        # full pool is not "stalled", it just hasn't run yet
        starts: dict[str, float] = {}

        def send_all(nei: str, envs: list[object]) -> list[bool]:
            starts[nei] = time.monotonic()
            return [self._send(nei, env, create_connection=create_connection) for env in envs]

        skipped: list[tuple[str, object]] = []
        futures: list[tuple[str, list[int], list[object], Future]] = []
        for nei, items in grouped.items():
            with self._stalled_lock:
                if nei in self._stalled:
                    # a previous batch's send to this peer is stuck past its
                    # budget — submitting more would strand a second worker
                    # behind the same stall
                    logger.log_comm_metric(
                        self.self_addr, "gossip_send_inflight_skip", len(items)
                    )
                    for i, env in items:
                        results[i] = False
                        skipped.append((nei, env))
                    continue
            # resolve lazy payloads NOW, on the calling thread: the previous
            # neighbor's task is already running on a worker, so this
            # build hides under that in-flight send
            resolved: list[tuple[int, object]] = []
            for i, env in items:
                if callable(env):
                    env = env()
                if env is None:
                    continue  # payload declined — not a send, not a failure
                resolved.append((i, env))
            if not resolved:
                continue
            try:
                fut = pool.submit(send_all, nei, [env for _i, env in resolved])
            except RuntimeError:  # stop() shut the pool down under us
                for i, _env in resolved:
                    results[i] = False
                continue

            def _done(_fut, nei=nei):
                with self._stalled_lock:
                    # only the task that set the mark may clear it — another
                    # plane's send to the same neighbor finishing must not
                    # unmark a still-stuck one
                    if self._stalled.get(nei) is _fut:
                        del self._stalled[nei]

            fut.add_done_callback(_done)
            futures.append(
                (nei, [i for i, _env in resolved], [env for _i, env in resolved], fut)
            )
        # everything-is-stuck backstop: enough budget for every task to get
        # a worker slot and its own timeout, then stop waiting regardless
        hard_deadline = time.monotonic() + timeout * (1 + len(futures) / workers)
        for nei, idxs, envs, fut in futures:
            timed_out = False
            while True:
                now = time.monotonic()
                started = starts.get(nei)
                if not fut.done():  # a finished task is never "timed out"
                    if started is not None and now - started >= timeout:
                        timed_out = True  # genuinely running too long
                        break
                    if now >= hard_deadline:
                        timed_out = True
                        break
                # queued tasks get short polls; running ones their remainder
                wait = 0.05 if started is None else max(0.0, started + timeout - now)
                try:
                    oks = fut.result(timeout=max(0.0, min(wait, hard_deadline - now)))
                except (FuturesTimeout, TimeoutError):
                    continue
                except CancelledError:  # stop() cancelled the queued send
                    oks = None
                except Exception as exc:  # noqa: BLE001 — transport raised on the worker
                    oks = None
                    logger.debug(self.self_addr, f"Send to {nei} raised {exc!r}")
                if oks is None:
                    for i in idxs:
                        results[i] = False
                    logger.log_comm_metric(self.self_addr, "gossip_send_fail", len(idxs))
                    self._report(nei, False)
                else:
                    for i, ok in zip(idxs, oks):
                        results[i] = bool(ok)
                        logger.log_comm_metric(
                            self.self_addr, "gossip_send_ok" if ok else "gossip_send_fail"
                        )
                        self._report(nei, bool(ok))
                break
            if timed_out:
                with self._stalled_lock:
                    # mark only tasks that actually STARTED and overran: a
                    # task still queued at the hard deadline is a healthy
                    # neighbor behind a congested pool, not a stall
                    if not fut.done() and starts.get(nei) is not None:
                        self._stalled[nei] = fut

                # the late outcome still matters: when the hung worker
                # finally finishes, feed metrics + breaker and hand each
                # envelope that FAILED to the caller (message plane retries
                # it) — otherwise a send that overran its budget and then
                # returned False would be silently lost
                def _late(f, nei=nei, envs=envs):
                    try:
                        oks = f.result()
                    except Exception:  # noqa: BLE001 — cancelled or transport raised
                        oks = None
                    if oks is None:
                        oks = [False] * len(envs)
                    for env, ok in zip(envs, oks):
                        logger.log_comm_metric(
                            self.self_addr,
                            "gossip_send_ok" if ok else "gossip_send_fail",
                        )
                        self._report(nei, bool(ok))
                        if not ok and on_late_failure is not None:
                            try:
                                on_late_failure(nei, env)
                            except Exception:  # noqa: BLE001 — observer must not kill the worker
                                pass

                fut.add_done_callback(_late)
                logger.log_comm_metric(self.self_addr, "gossip_send_timeout")
                logger.debug(
                    self.self_addr,
                    f"Send to {nei} exceeded GOSSIP_SEND_TIMEOUT "
                    f"({timeout}s) — continuing without it",
                )
        return results, skipped

    # ---- message plane ----

    def add_message(self, msg: Message, pending_neis: list[str], attempt: int = 0) -> None:
        if not pending_neis:
            return
        with self._queue_cv:
            self._queue.append((msg, list(pending_neis), attempt))
            self._queue_cv.notify()

    def schedule_retry(self, nei: str, msg: Message, attempt: int) -> None:
        """Queue retry ``attempt`` (1-based) of a failed control send.

        The entry waits out an exponential backoff (``reliability.
        retry_delay``) on the gossip thread, then rides a normal dispatch
        batch. Beyond ``Settings.MESSAGE_RETRY_MAX`` the message is
        dropped loudly (``msg_retry_exhausted``) — by then the breaker
        has marked the neighbor suspect and eviction owns the rest.

        Beats are exempt, HERE, for every path that funnels into the
        retry queue (direct sends, the queue's failure loop, late
        failures of budget-overrunning sends): a beat is superseded by
        the next one every HEARTBEAT_PERIOD, so a retry would only
        deliver stale liveness info while its backoff entries crowd the
        per-tick budget out from under genuine control messages during
        exactly the failure windows that matter (the failed send still
        fed the breaker).
        """
        from p2pfl_tpu_torch.management.telemetry import telemetry

        if msg.cmd == BEAT_CMD:
            return
        if attempt > Settings.MESSAGE_RETRY_MAX:
            logger.log_comm_metric(self.self_addr, "msg_retry_exhausted")
            telemetry.event(
                self.self_addr,
                "retry_exhausted",
                kind="retry",
                attrs={"peer": nei, "cmd": msg.cmd},
            )
            logger.debug(
                self.self_addr,
                f"Dropping '{msg.cmd}' for {nei} after "
                f"{Settings.MESSAGE_RETRY_MAX} retries",
            )
            return
        delay = retry_delay(attempt)
        due = time.monotonic() + delay
        logger.log_comm_metric(self.self_addr, "msg_retry_scheduled")
        # retry-plane event: the RoundReport sums delay_s per peer into the
        # round's retry/backoff-wait attribution
        telemetry.event(
            self.self_addr,
            "retry_scheduled",
            kind="retry",
            attrs={"peer": nei, "cmd": msg.cmd, "attempt": attempt, "delay_s": round(delay, 4)},
        )
        with self._queue_cv:
            heapq.heappush(self._retries, (due, next(self._retry_seq), attempt, nei, msg))
            self._queue_cv.notify()

    def _pop_due_retries_locked(self) -> tuple[list[tuple[str, Message, int]], Optional[float]]:
        """(due retries as (nei, msg, attempt), next due time). Caller
        holds ``_queue_cv``."""
        now = time.monotonic()
        due: list[tuple[str, Message, int]] = []
        while self._retries and self._retries[0][0] <= now:
            _due, _seq, attempt, nei, msg = heapq.heappop(self._retries)
            due.append((nei, msg, attempt))
        return due, (self._retries[0][0] if self._retries else None)

    def _run(self) -> None:
        while not self._stop.is_set():
            with self._queue_cv:
                due, next_due = self._pop_due_retries_locked()
                if not self._queue and not due:
                    wait = Settings.GOSSIP_PERIOD
                    if next_due is not None:
                        wait = min(wait, max(next_due - time.monotonic(), 0.01))
                    self._queue_cv.wait(timeout=wait)
                    continue
                # (neighbor, message, attempt) — attempt 0 is a first
                # delivery, >= 1 a backoff retry re-entering the batch
                batch: list[tuple[str, Message, int]] = list(due)
                budget = Settings.GOSSIP_MESSAGES_PER_PERIOD - len(batch)
                while self._queue and budget > 0:
                    msg, neis, attempt = self._queue.popleft()
                    take, rest = neis[:budget], neis[budget:]
                    batch.extend((n, msg, attempt) for n in take)
                    budget -= len(take)
                    if rest:
                        self._queue.appendleft((msg, rest, attempt))
                        break
            if self._stop.is_set():
                return
            attempts = {(n, id(m)): a for n, m, a in batch}

            def _late_failure(nei: str, env: object, attempts=attempts) -> None:
                # a send that overran its budget and THEN failed on its
                # worker is still a definitive failure — retry it like a
                # prompt one (schedule_retry exempts beats)
                if isinstance(env, Message):
                    self.schedule_retry(nei, env, attempts.get((nei, id(env)), 0) + 1)

            results, skipped = self._dispatch_sends(
                [(n, m) for n, m, _a in batch], on_late_failure=_late_failure
            )
            # a send skipped for a stalled neighbor was never attempted —
            # requeued below at the same attempt, not counted as a failure
            skipset = {(nei, id(msg)) for nei, msg in skipped}
            for (nei, msg, attempt), ok in zip(batch, results):
                if (nei, id(msg)) in skipset:
                    continue
                if ok is False:
                    # definitive transport failure: back off and retry —
                    # a plain False must never silently lose a broadcast
                    # (relayed beats ride this queue too; schedule_retry
                    # exempts them)
                    self.schedule_retry(nei, msg, attempt + 1)
                elif ok and attempt > 0:
                    logger.log_comm_metric(self.self_addr, "msg_retry_ok")
                # ok is None: the send outlived its budget and is still
                # running on its worker — _dispatch_sends' late-result
                # callback will report it (and retry via _late_failure if
                # it ultimately fails)
            for nei, msg in skipped:
                # control messages must not be lost to a transient stall —
                # requeue for the stalled neighbor (the pre-overhaul serial
                # plane eventually delivered them); delivery resumes once
                # the stuck task completes or the neighbor is evicted
                self.add_message(msg, [nei], attempt=attempts.get((nei, id(msg)), 0))
            time.sleep(Settings.GOSSIP_PERIOD)

    # ---- model plane ----

    def gossip_weights(
        self,
        early_stopping_fn: Callable[[], bool],
        get_candidates_fn: Callable[[], list[str]],
        status_fn: Callable[[], object],
        model_fn: Callable[[str], Optional[object]],
        period: Optional[float] = None,
        create_connection: bool = False,
    ) -> None:
        from p2pfl_tpu_torch.communication.protocol import random_subset

        period = Settings.GOSSIP_MODELS_PERIOD if period is None else period
        last_status: object = None
        equal_ticks = 0
        while True:
            if early_stopping_fn() or self._stop.is_set():
                return
            candidates = get_candidates_fn()
            if not candidates:
                return
            status = status_fn()
            if status == last_status:
                equal_ticks += 1
                if equal_ticks >= Settings.GOSSIP_EXIT_ON_X_EQUAL_ROUNDS:
                    logger.debug(
                        self.self_addr,
                        f"Gossip stalled for {equal_ticks} ticks — stopping (status={status})",
                    )
                    return
            else:
                equal_ticks = 0
                last_status = status
            # payloads stay lazily built ON the calling thread (learner /
            # aggregator state is never read concurrently), but resolution
            # happens per neighbor at submit time inside _dispatch_sends:
            # candidate i+1's payload build overlaps candidate i's
            # in-flight send instead of running before the first send
            sends: list[tuple[str, object]] = [
                (nei, partial(model_fn, nei))
                for nei in random_subset(candidates, Settings.GOSSIP_MODELS_PER_ROUND)
            ]
            if sends:
                self._dispatch_sends(sends, create_connection=create_connection)
            time.sleep(period)
