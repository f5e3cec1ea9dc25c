"""Spans, events and counters (the core of ``p2pfl_tpu/management/telemetry.py``).

One process-wide registry, :data:`telemetry`:

- **Spans**: ``with telemetry.span(node, name, kind=..., attrs=...)``
  records monotonic-ns start and end into a bounded per-node ring
  (``Settings.TELEMETRY_RING_SPANS``). Nesting is tracked per thread; an
  explicit ``parent`` (a wire ``(trace_id, span_id)`` pair) overrides it,
  which is how a receiver's span joins the sender's causal tree.
  :meth:`Telemetry.event` records an instant span.
- **Counters**: the registry behind ``logger.log_comm_metric`` (group
  ``"comm"``) and ``profiling.dispatch_span`` (group ``"dispatch"``);
  counters are always on. Span durations feed log2-bucket latency
  histograms.

Records stay in the process: the Chrome-trace export and the per-round
report of the JAX package are not ported.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from p2pfl_tpu_torch.settings import Settings

TraceCtx = Tuple[str, str]  # (trace_id, span_id)

_seq = itertools.count(1)
# per-process entropy in every id: a round's trace id is the same on every
# node, so bare sequential span ids would collide across processes
_proc_tag = f"{os.getpid():x}-{os.urandom(3).hex()}"


def _new_id(prefix: str = "s") -> str:
    return f"{prefix}{_proc_tag}-{next(_seq):x}"


class Span:
    """One recorded operation: [t0_ns, t1_ns) on one node, one plane."""

    __slots__ = ("trace_id", "span_id", "parent_id", "node", "name", "kind", "t0_ns", "t1_ns", "attrs")

    def __init__(
        self, node: str, name: str, kind: str, trace_id: str, parent_id: Optional[str],
        attrs: Optional[dict],
    ) -> None:
        self.node = node
        self.name = name
        self.kind = kind
        self.trace_id = trace_id
        self.span_id = _new_id()
        self.parent_id = parent_id
        self.t0_ns = time.monotonic_ns()
        self.t1_ns = self.t0_ns
        self.attrs: dict = attrs if attrs is not None else {}

    @property
    def duration_ns(self) -> int:
        return self.t1_ns - self.t0_ns

    @property
    def ctx(self) -> TraceCtx:
        return (self.trace_id, self.span_id)


class _SpanHandle:
    __slots__ = ("_registry", "span")

    def __init__(self, registry: "Telemetry", span: Span) -> None:
        self._registry = registry
        self.span = span

    def __enter__(self) -> Span:
        self._registry._push(self.span)
        return self.span

    def __exit__(self, exc_type, exc, tb) -> bool:
        span = self.span
        span.t1_ns = time.monotonic_ns()
        if exc_type is not None:
            span.attrs.setdefault("error", repr(exc))
        self._registry._pop(span)
        self._registry._commit(span)
        return False


class _NoopHandle:
    """Shared do-nothing handle: the disabled path allocates nothing."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


_NOOP = _NoopHandle()


class LatencyHistogram:
    """Log2-bucketed latency histogram in ns (thread-safe, ≤2× quantile error)."""

    __slots__ = ("_lock", "counts", "count", "sum_ns", "max_ns")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.counts: Dict[int, int] = {}
        self.count = 0
        self.sum_ns = 0
        self.max_ns = 0

    def record(self, ns: int) -> None:
        ns = max(int(ns), 0)
        bucket = ns.bit_length()
        with self._lock:
            self.counts[bucket] = self.counts.get(bucket, 0) + 1
            self.count += 1
            self.sum_ns += ns
            self.max_ns = max(self.max_ns, ns)

    def percentile(self, q: float) -> float:
        """Approximate q-th percentile in ns (geometric bucket midpoint)."""
        with self._lock:
            if self.count == 0:
                return 0.0
            target = q / 100.0 * self.count
            seen = 0
            for bucket in sorted(self.counts):
                seen += self.counts[bucket]
                if seen >= target:
                    lo = 0 if bucket <= 1 else 1 << (bucket - 1)
                    hi = (1 << bucket) - 1 if bucket > 0 else 0
                    return (lo + hi) / 2.0
            return float(self.max_ns)

    def summary(self) -> dict:
        with self._lock:
            count, sum_ns = self.count, self.sum_ns
        if count == 0:
            return {"count": 0}
        return {
            "count": count,
            "total_s": round(sum_ns / 1e9, 6),
            "mean_ms": round(sum_ns / count / 1e6, 4),
            "p50_ms": round(self.percentile(50) / 1e6, 4),
            "p95_ms": round(self.percentile(95) / 1e6, 4),
            "max_ms": round(self.max_ns / 1e6, 4),
        }


class ValueHistogram:
    """Exact counts over small non-negative integers (thread-safe): the
    async plane's staleness τ in model versions, where log2 time buckets
    would blur the distribution and mislabel its units."""

    __slots__ = ("_lock", "counts", "count", "total")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.counts: Dict[int, int] = {}
        self.count = 0
        self.total = 0

    def record(self, value: int) -> None:
        value = max(int(value), 0)
        with self._lock:
            self.counts[value] = self.counts.get(value, 0) + 1
            self.count += 1
            self.total += value

    def summary(self) -> dict:
        with self._lock:
            if self.count == 0:
                return {"count": 0}
            values = sorted(self.counts)
            cum, p50, p95 = 0, values[-1], values[-1]
            for v in values:
                cum += self.counts[v]
                if p50 == values[-1] and cum >= 0.50 * self.count:
                    p50 = v
                if cum >= 0.95 * self.count:
                    p95 = v
                    break
            return {
                "count": self.count,
                "mean": round(self.total / self.count, 4),
                "p50": p50,
                "p95": p95,
                "max": values[-1],
                "counts": {str(v): self.counts[v] for v in values},
            }


class Telemetry:
    """Process-wide registry. Use the module-level :data:`telemetry`."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._rings: Dict[str, deque] = {}
        # group → node → name → value
        self._counters: Dict[str, Dict[str, Dict[str, float]]] = {}
        self._hists: Dict[Tuple[str, str], LatencyHistogram] = {}
        self._value_hists: Dict[Tuple[str, str], ValueHistogram] = {}
        self._tls = threading.local()

    # ---- spans ----

    @staticmethod
    def enabled() -> bool:
        return bool(Settings.TELEMETRY_ENABLED)

    def _stack(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def _push(self, span: Span) -> None:
        self._stack().append(span)

    def _pop(self, span: Span) -> None:
        stack = self._stack()
        if stack and stack[-1] is span:
            stack.pop()
        elif span in stack:
            stack.remove(span)

    def _ring(self, node: str) -> deque:
        ring = self._rings.get(node)
        if ring is None:
            with self._lock:
                ring = self._rings.setdefault(
                    node, deque(maxlen=max(int(Settings.TELEMETRY_RING_SPANS), 1))
                )
        return ring

    def _commit(self, span: Span) -> None:
        self._ring(span.node).append(span)
        self.observe(span.node, f"{span.kind}.{span.name}", span.duration_ns)

    def span(
        self,
        node: str,
        name: str,
        kind: str = "stage",
        attrs: Optional[dict] = None,
        parent: Optional[TraceCtx] = None,
        trace_id: Optional[str] = None,
    ):
        """Open a span (a context manager yielding the live :class:`Span`,
        or a no-op handle when telemetry is off). ``parent`` is a wire
        ``(trace_id, span_id)``; ``trace_id`` forces the trace identity."""
        if not self.enabled():
            return _NOOP
        parent_id: Optional[str] = None
        if parent is not None:
            tid, parent_id = parent
        else:
            stack = self._stack()
            if stack:
                tid, parent_id = stack[-1].trace_id, stack[-1].span_id
            else:
                tid = _new_id("t")
        if trace_id is not None:
            tid = trace_id
        return _SpanHandle(self, Span(node, name, kind, tid, parent_id, attrs))

    def event(self, node: str, name: str, kind: str = "fault", attrs: Optional[dict] = None) -> None:
        """Record an instant span, parented to this thread's current span."""
        if not self.enabled():
            return
        stack = self._stack()
        if stack:
            tid, parent_id = stack[-1].trace_id, stack[-1].span_id
        else:
            tid, parent_id = _new_id("t"), None
        self._ring(node).append(Span(node, name, kind, tid, parent_id, attrs))

    def current_ctx(self) -> Optional[TraceCtx]:
        """The calling thread's active ``(trace_id, span_id)``."""
        stack = getattr(self._tls, "stack", None)
        return stack[-1].ctx if stack else None

    def spans(self, node: Optional[str] = None) -> List[Span]:
        with self._lock:
            rings = list(self._rings.values()) if node is None else (
                [self._rings[node]] if node in self._rings else []
            )
        out: List[Span] = []
        for ring in rings:
            out.extend(list(ring))
        out.sort(key=lambda s: s.t0_ns)
        return out

    def reset_spans(self) -> None:
        with self._lock:
            self._rings.clear()

    # ---- counters ----

    def inc(self, group: str, node: str, name: str, value: float = 1.0) -> None:
        with self._lock:
            per_node = self._counters.setdefault(group, {}).setdefault(node, {})
            per_node[name] = per_node.get(name, 0.0) + value

    def counters(self, group: str, node: Optional[str] = None) -> Dict:
        """``{name: value}`` for one node, or ``{node: {...}}``."""
        with self._lock:
            g = self._counters.get(group, {})
            if node is not None:
                return dict(g.get(node, {}))
            return {n: dict(d) for n, d in g.items()}

    def reset_counters(self, group: str) -> None:
        with self._lock:
            self._counters.pop(group, None)

    def snapshot_and_reset(self, group: str, node: Optional[str] = None) -> Dict:
        """Read and clear a counter group (or one node's slice) under one lock."""
        with self._lock:
            g = self._counters.get(group)
            if g is None:
                return {}
            if node is not None:
                return dict(g.pop(node, {}))
            self._counters.pop(group, None)
            return {n: dict(d) for n, d in g.items()}

    # ---- histograms ----

    def observe(self, node: str, name: str, ns: int) -> None:
        if not self.enabled():
            return
        key = (node, name)
        hist = self._hists.get(key)
        if hist is None:
            with self._lock:
                hist = self._hists.setdefault(key, LatencyHistogram())
        hist.record(ns)

    def histograms(self, node: Optional[str] = None) -> Dict[str, dict]:
        with self._lock:
            items = list(self._hists.items())
        if node is not None:
            return {name: h.summary() for (n, name), h in items if n == node}
        return {f"{n}/{name}": h.summary() for (n, name), h in items}

    def observe_value(self, node: str, name: str, value: int) -> None:
        """Record a small non-negative integer into a :class:`ValueHistogram`;
        always on, like the counters (the staleness distribution is read by
        tests and the card drive)."""
        key = (node, name)
        hist = self._value_hists.get(key)
        if hist is None:
            with self._lock:
                hist = self._value_hists.setdefault(key, ValueHistogram())
        hist.record(value)

    def value_histograms(self, node: Optional[str] = None) -> Dict[str, dict]:
        """Like :meth:`histograms`, for the raw-value family."""
        with self._lock:
            items = list(self._value_hists.items())
        if node is not None:
            return {name: h.summary() for (n, name), h in items if n == node}
        return {f"{n}/{name}": h.summary() for (n, name), h in items}

    def reset(self) -> None:
        with self._lock:
            self._rings.clear()
            self._counters.clear()
            self._hists.clear()
            self._value_hists.clear()


#: the process-wide registry
telemetry = Telemetry()
