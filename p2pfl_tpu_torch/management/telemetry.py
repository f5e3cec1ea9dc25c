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
- **Exports**: :meth:`Telemetry.export_chrome_trace` writes Chrome
  trace-event JSON (one ``pid`` a node, one ``tid`` a plane of
  :data:`PLANES`), loadable in Perfetto; :meth:`Telemetry.round_report`
  walks one round's spans and attributes its wall clock to stages and
  waits, edges (send time plus retry backoff), faults and the critical
  path. A ``torch.profiler`` trace of the same run (``profiling.trace``)
  holds the device side: ``profiling.dispatch_span`` opens a
  ``p2pfl:<site>`` range there.

``P2PFL_TELEMETRY_DUMP=<dir>`` writes ``trace.json`` and
``round_reports.json`` (and ``value_histograms.json`` after an async run)
into ``<dir>`` when the process exits (:func:`dump_flight_record`).
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from p2pfl_tpu_torch.settings import Settings

TraceCtx = Tuple[str, str]  # (trace_id, span_id)

#: span kinds → Chrome trace ``tid`` (one timeline lane a plane)
PLANES: Dict[str, int] = {
    "stage": 1,
    "gossip": 2,
    "heartbeat": 3,
    "dispatch": 4,
    "retry": 5,
    "fault": 6,
}
_OTHER_PLANE = 9

#: the round FSM's top-level stages: a round report splits stage time over
#: these alone, so nested spans (aggregation_wait, diffusion) count as waits
FSM_STAGES = (
    "StartLearningStage",
    "VoteTrainSetStage",
    "TrainStage",
    "WaitAggregatedModelsStage",
    "GossipModelStage",
    "RoundFinishedStage",
)

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

    def to_dict(self) -> dict:
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "node": self.node,
            "name": self.name,
            "kind": self.kind,
            "t0_ns": self.t0_ns,
            "t1_ns": self.t1_ns,
            "attrs": dict(self.attrs),
        }


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
            "p99_ms": round(self.percentile(99) / 1e6, 4),
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

    def reset_histograms(self) -> None:
        with self._lock:
            self._hists.clear()
            self._value_hists.clear()

    def reset(self) -> None:
        with self._lock:
            self._rings.clear()
            self._counters.clear()
            self._hists.clear()
            self._value_hists.clear()

    # ---- Chrome trace-event export ----

    def export_chrome_trace(self, path: Optional[str] = None, nodes: Optional[List[str]] = None) -> dict:
        """Chrome trace-event JSON: one ``pid`` a node, one ``tid`` a plane,
        ``X`` complete events for spans and ``i`` instants for events
        (timestamps in µs of the monotonic clock). Returns the document and
        writes it to ``path`` when given."""
        spans = self.spans()
        if nodes is not None:
            wanted = set(nodes)
            spans = [s for s in spans if s.node in wanted]
        pid_of = {n: i + 1 for i, n in enumerate(sorted({s.node for s in spans}))}
        events: List[dict] = [
            {"ph": "M", "name": "process_name", "pid": pid, "tid": 0, "args": {"name": node}}
            for node, pid in pid_of.items()
        ]
        named_lanes = set()
        for s in spans:
            pid = pid_of[s.node]
            tid = PLANES.get(s.kind, _OTHER_PLANE)
            if (pid, tid) not in named_lanes:
                named_lanes.add((pid, tid))
                events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": tid, "args": {"name": s.kind}})
            args = {k: v for k, v in s.attrs.items() if v is not None}
            args["trace_id"] = s.trace_id
            args["span_id"] = s.span_id
            if s.parent_id:
                args["parent_span_id"] = s.parent_id
            event = {"name": s.name, "pid": pid, "tid": tid, "ts": s.t0_ns / 1000.0, "args": args, "cat": s.kind}
            if s.duration_ns > 0:
                event["ph"] = "X"
                event["dur"] = s.duration_ns / 1000.0
            else:
                event["ph"] = "i"
                event["s"] = "t"  # thread-scoped instant
            events.append(event)
        doc = {"traceEvents": events, "displayTimeUnit": "ms"}
        if path is not None:
            with open(path, "w") as f:
                json.dump(doc, f)
        return doc

    # ---- per-round attribution ----

    def round_report(self, round_no: int, experiment: Optional[str] = None) -> "RoundReport":
        """What gated one round. Stage spans carry ``attrs={"round",
        "experiment"}`` (the workflow stamps them); sends, retries and
        faults count when they fall inside the round's window. The
        critical path names the node with the longest round, its longest
        stage, the edge that burned the most send plus retry time, and
        the peer most sends failed to (a crashed peer fails fast but
        often)."""
        spans = self.spans()
        stage_spans = [
            s for s in spans
            if s.kind == "stage" and s.attrs.get("round") == round_no
            and (experiment is None or s.attrs.get("experiment") == experiment)
        ]
        per_node: Dict[str, dict] = {}
        for s in stage_spans:
            info = per_node.setdefault(s.node, {"t0_ns": s.t0_ns, "t1_ns": s.t1_ns, "stages": {}, "waits": {}})
            info["t0_ns"] = min(info["t0_ns"], s.t0_ns)
            info["t1_ns"] = max(info["t1_ns"], s.t1_ns)
            bucket = "stages" if s.name in FSM_STAGES else "waits"
            info[bucket][s.name] = info[bucket].get(s.name, 0) + s.duration_ns
        if not per_node:
            return RoundReport(round_no=round_no, experiment=experiment)
        if experiment is None:
            experiment = next((s.attrs.get("experiment") for s in stage_spans if s.attrs.get("experiment")), None)

        w0 = min(i["t0_ns"] for i in per_node.values())
        w1 = max(i["t1_ns"] for i in per_node.values())
        edges: Dict[Tuple[str, str], dict] = {}
        retry_wait: Dict[str, float] = {}
        faults: Dict[str, int] = {}
        for s in spans:
            if s.t0_ns > w1 or s.t1_ns < w0:
                continue
            if s.kind == "gossip" and s.name.startswith("send:"):
                peer = s.attrs.get("peer")
                if peer is None:
                    continue
                e = edges.setdefault((s.node, peer), {"busy_ns": 0, "sends": 0, "failures": 0})
                e["busy_ns"] += s.duration_ns
                e["sends"] += 1
                if s.attrs.get("ok") is False:
                    e["failures"] += 1
            elif s.kind == "retry":
                peer = s.attrs.get("peer")
                if peer is not None:
                    retry_wait[peer] = retry_wait.get(peer, 0.0) + float(s.attrs.get("delay_s", 0.0))
            elif s.kind == "fault":
                faults[s.name] = faults.get(s.name, 0) + 1

        critical_node = max(per_node, key=lambda n: per_node[n]["t1_ns"] - per_node[n]["t0_ns"])
        crit = per_node[critical_node]
        critical_stage = max(crit["stages"], key=crit["stages"].get) if crit["stages"] else None
        critical_edge = None
        if edges:
            src, dst = max(edges, key=lambda e: edges[e]["busy_ns"] + retry_wait.get(e[1], 0.0) * 1e9)
            e = edges[(src, dst)]
            critical_edge = {
                "src": src, "dst": dst, "busy_s": round(e["busy_ns"] / 1e9, 4), "sends": e["sends"],
                "failures": e["failures"], "retry_wait_s": round(retry_wait.get(dst, 0.0), 4),
            }
        fail_by_dst: Dict[str, int] = {}
        for (_src, dst), e in edges.items():
            fail_by_dst[dst] = fail_by_dst.get(dst, 0) + e["failures"]
        for peer in retry_wait:
            fail_by_dst.setdefault(peer, 0)
        most_failed_peer = None
        if fail_by_dst and max(fail_by_dst.values()) > 0:
            most_failed_peer = max(fail_by_dst, key=fail_by_dst.get)

        return RoundReport(
            round_no=round_no,
            experiment=experiment,
            wall_s=round((w1 - w0) / 1e9, 4),
            per_node={
                n: {
                    "wall_s": round((i["t1_ns"] - i["t0_ns"]) / 1e9, 4),
                    "stages_s": {k: round(v / 1e9, 4) for k, v in i["stages"].items()},
                    "waits_s": {k: round(v / 1e9, 4) for k, v in i["waits"].items()},
                }
                for n, i in per_node.items()
            },
            edges={
                f"{src}->{dst}": {"busy_s": round(e["busy_ns"] / 1e9, 4), "sends": e["sends"], "failures": e["failures"]}
                for (src, dst), e in edges.items()
            },
            retry_wait_s={k: round(v, 4) for k, v in retry_wait.items()},
            faults=faults,
            critical_node=critical_node,
            critical_stage=critical_stage,
            critical_edge=critical_edge,
            most_failed_peer=most_failed_peer,
        )

    def observed_rounds(self) -> List[Tuple[Optional[str], int]]:
        """Distinct ``(experiment, round)`` pairs that have stage spans."""
        seen = set()
        for s in self.spans():
            if s.kind == "stage" and isinstance(s.attrs.get("round"), int):
                seen.add((s.attrs.get("experiment"), s.attrs["round"]))
        return sorted(seen, key=lambda er: (er[0] or "", er[1]))


class RoundReport:
    """One round's wall-clock attribution (:meth:`Telemetry.round_report`)."""

    def __init__(
        self,
        round_no: int,
        experiment: Optional[str] = None,
        wall_s: float = 0.0,
        per_node: Optional[dict] = None,
        edges: Optional[dict] = None,
        retry_wait_s: Optional[dict] = None,
        faults: Optional[dict] = None,
        critical_node: Optional[str] = None,
        critical_stage: Optional[str] = None,
        critical_edge: Optional[dict] = None,
        most_failed_peer: Optional[str] = None,
    ) -> None:
        self.round_no = round_no
        self.experiment = experiment
        self.wall_s = wall_s
        self.per_node = per_node or {}
        self.edges = edges or {}
        self.retry_wait_s = retry_wait_s or {}
        self.faults = faults or {}
        self.critical_node = critical_node
        self.critical_stage = critical_stage
        self.critical_edge = critical_edge
        self.most_failed_peer = most_failed_peer

    def to_dict(self) -> dict:
        return {
            "round": self.round_no,
            "experiment": self.experiment,
            "wall_s": self.wall_s,
            "per_node": self.per_node,
            "edges": self.edges,
            "retry_wait_s": self.retry_wait_s,
            "faults": self.faults,
            "critical_path": {
                "node": self.critical_node,
                "stage": self.critical_stage,
                "edge": self.critical_edge,
                "most_failed_peer": self.most_failed_peer,
            },
        }

    def describe(self) -> str:
        """A short human summary."""
        if not self.per_node:
            return f"round {self.round_no}: no spans recorded"
        lines = [
            f"round {self.round_no} ({self.experiment or 'unknown-exp'}): "
            f"wall {self.wall_s:.2f}s across {len(self.per_node)} node(s)"
        ]
        if self.critical_node is not None:
            node = self.per_node[self.critical_node]
            lines.append(
                f"  critical node: {self.critical_node} ({node['wall_s']:.2f}s, longest stage: {self.critical_stage})"
            )
        if self.critical_edge is not None:
            e = self.critical_edge
            lines.append(
                f"  critical edge: {e['src']}->{e['dst']} ({e['busy_s']:.2f}s busy, {e['failures']} failure(s))"
            )
        if self.most_failed_peer is not None:
            lines.append(f"  most-failed peer: {self.most_failed_peer}")
        if self.faults:
            lines.append(f"  injected faults: {self.faults}")
        return "\n".join(lines)


def validate_chrome_trace(doc: dict) -> int:
    """Check a document against the Chrome trace-event schema; returns the
    event count or raises ``ValueError``."""
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        raise ValueError("missing traceEvents")
    events = doc["traceEvents"]
    if not isinstance(events, list):
        raise ValueError("traceEvents must be a list")
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            raise ValueError(f"event {i} is not an object")
        ph = ev.get("ph")
        if ph not in ("X", "i", "M", "B", "E"):
            raise ValueError(f"event {i}: unknown ph {ph!r}")
        for key in ("name", "pid", "tid"):
            if key not in ev:
                raise ValueError(f"event {i}: missing {key}")
        if ph == "X":
            if not isinstance(ev.get("ts"), (int, float)) or not isinstance(ev.get("dur"), (int, float)):
                raise ValueError(f"event {i}: X event needs numeric ts/dur")
            if ev["dur"] < 0:
                raise ValueError(f"event {i}: negative dur")
        elif ph == "i":
            if not isinstance(ev.get("ts"), (int, float)):
                raise ValueError(f"event {i}: instant needs numeric ts")
    json.dumps(doc)  # must serialise as it is
    return len(events)


#: the process-wide registry
telemetry = Telemetry()


def dump_flight_record(out_dir: str) -> List[str]:
    """Write ``trace.json`` and ``round_reports.json`` (and, when an async
    run recorded any, ``value_histograms.json``) under ``out_dir``; returns
    the paths."""
    os.makedirs(out_dir, exist_ok=True)
    trace_path = os.path.join(out_dir, "trace.json")
    telemetry.export_chrome_trace(path=trace_path)
    reports = [telemetry.round_report(rnd, experiment=exp).to_dict() for exp, rnd in telemetry.observed_rounds()]
    report_path = os.path.join(out_dir, "round_reports.json")
    with open(report_path, "w") as f:
        json.dump(reports, f, indent=1)
    paths = [trace_path, report_path]
    value_hists = telemetry.value_histograms()
    if value_hists:
        vh_path = os.path.join(out_dir, "value_histograms.json")
        with open(vh_path, "w") as f:
            json.dump(value_hists, f, indent=1)
        paths.append(vh_path)
    return paths


def _install_exit_dump() -> None:
    """With ``P2PFL_TELEMETRY_DUMP`` set, dump the flight record at exit."""
    import atexit

    out_dir = os.environ.get("P2PFL_TELEMETRY_DUMP")
    if not out_dir:
        return

    def _dump() -> None:
        try:
            dump_flight_record(out_dir)
        except Exception:  # noqa: BLE001 — an exit dump never masks the exit code
            pass

    atexit.register(_dump)


_install_exit_dump()
