"""The port's flight recorder against the JAX package's: spans, wire trace
context, the round report, the Chrome-trace export, the counter registry
and the thread-safety of the stopwatch and the snapshots.

One twin of each test of ``tests/test_telemetry.py`` on the port (memory
Nodes with ``DummyLearner`` on the CPU; the slow peer and the chaos run
through the port's ``communication/faults.py``), then parity: the same
spans (node, name, kind, t0, t1, attrs, parent links) fed to both
registries give equal ``export_chrome_trace`` documents and equal
``RoundReport.to_dict()``, and ``validate_chrome_trace`` reaches JAX's
verdict on the same malformed documents.
"""

import json
import threading
import time

import numpy as np
import pytest
import torch

from p2pfl_tpu.management import telemetry as jax_telemetry_mod
from p2pfl_tpu_torch.communication.faults import (
    CrashSpec,
    EdgeFault,
    FaultPlan,
    install_fault_plan,
    remove_fault_plan,
)
from p2pfl_tpu_torch.communication.memory import MemoryRegistry
from p2pfl_tpu_torch.learning.learner import DummyLearner
from p2pfl_tpu_torch.management import telemetry as telemetry_mod
from p2pfl_tpu_torch.management.logger import logger
from p2pfl_tpu_torch.management.telemetry import PLANES, telemetry, validate_chrome_trace
from p2pfl_tpu_torch.node import Node, stop_leaked_nodes
from p2pfl_tpu_torch.settings import Settings, set_test_settings
from p2pfl_tpu_torch.utils import full_connection, wait_convergence, wait_to_finish

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _clean():
    set_test_settings()
    logger.set_level("INFO")
    MemoryRegistry.reset()
    telemetry.reset()
    yield
    stop_leaked_nodes()
    MemoryRegistry.reset()
    telemetry.reset()
    set_test_settings()


def _mk_nodes(n: int) -> list:
    nodes = [Node(learner=DummyLearner(value=float(i), device="cpu")) for i in range(n)]
    for node in nodes:
        node.start()
    for node in nodes:
        full_connection(node, nodes)
    wait_convergence(nodes, n - 1, only_direct=True, wait=10)
    return nodes


def _stop_all(nodes):
    for n in nodes:
        n.stop()


# ---- span API ----


def test_span_nesting_and_context():
    with telemetry.span("n1", "outer", kind="stage") as outer:
        assert telemetry.current_ctx() == (outer.trace_id, outer.span_id)
        with telemetry.span("n1", "inner", kind="gossip") as inner:
            assert inner.trace_id == outer.trace_id
            assert inner.parent_id == outer.span_id
            assert telemetry.current_ctx() == (inner.trace_id, inner.span_id)
        assert telemetry.current_ctx() == (outer.trace_id, outer.span_id)
    assert telemetry.current_ctx() is None
    spans = telemetry.spans("n1")
    assert [s.name for s in spans] == ["outer", "inner"]
    assert all(s.t1_ns >= s.t0_ns for s in spans)
    # to_dict carries every field, attrs copied
    d = spans[1].to_dict()
    assert d["parent_id"] == spans[0].span_id and d["kind"] == "gossip" and d["attrs"] is not spans[1].attrs


def test_explicit_parent_overrides_stack():
    with telemetry.span("n1", "local", kind="stage"):
        with telemetry.span("n2", "recv", kind="gossip", parent=("tX", "sX")) as sp:
            assert sp.trace_id == "tX"
            assert sp.parent_id == "sX"


def test_span_disabled_records_nothing():
    Settings.TELEMETRY_ENABLED = False
    try:
        with telemetry.span("n1", "x") as sp:
            assert sp is None
        telemetry.event("n1", "boom")
        assert telemetry.spans() == []
        assert telemetry.current_ctx() is None
    finally:
        Settings.TELEMETRY_ENABLED = True


def test_ring_bounded_under_concurrent_writers():
    Settings.TELEMETRY_RING_SPANS = 128
    telemetry.reset_spans()
    n_threads, per_thread = 8, 200
    errors = []

    def hammer(i):
        try:
            for k in range(per_thread):
                with telemetry.span("ring-node", f"w{i}", kind="gossip", attrs={"k": k}):
                    pass
        except Exception as exc:  # noqa: BLE001
            errors.append(exc)

    threads = [threading.Thread(target=hammer, args=(i,)) for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    spans = telemetry.spans("ring-node")
    assert len(spans) == 128
    assert max(s.attrs["k"] for s in spans) == per_thread - 1
    assert min(s.attrs["k"] for s in spans) >= per_thread - 1 - 128


def test_histogram_percentiles_ordered():
    for ms in (1, 2, 3, 5, 8, 13, 100, 400):
        telemetry.observe("h-node", "lat", ms * 1_000_000)
    h = telemetry.histograms("h-node")["lat"]
    assert h["count"] == 8
    assert h["p50_ms"] <= h["p95_ms"] <= h["p99_ms"] <= 2 * h["max_ms"]
    assert 2 <= h["p50_ms"] <= 12
    telemetry.reset_histograms()
    assert telemetry.histograms("h-node") == {}


# ---- the counter registry and atomic snapshots ----


def test_comm_metrics_view_backed_by_registry():
    logger.log_comm_metric("cnode", "m", 2.0)
    logger.log_comm_metric("cnode", "m", 3.0)
    assert logger.get_comm_metrics("cnode") == {"m": 5.0}
    assert telemetry.counters("comm", "cnode") == {"m": 5.0}
    logger.reset_comm_metrics()
    assert logger.get_comm_metrics("cnode") == {}


def test_snapshot_and_reset_loses_no_increments():
    total_writes = 4000
    done = threading.Event()

    def writer():
        for _ in range(total_writes):
            logger.log_comm_metric("atomic-node", "hits")
        done.set()

    t = threading.Thread(target=writer)
    t.start()
    harvested = 0.0
    while not done.is_set():
        harvested += logger.snapshot_and_reset_comm_metrics("atomic-node").get("hits", 0.0)
    t.join()
    harvested += logger.snapshot_and_reset_comm_metrics("atomic-node").get("hits", 0.0)
    assert harvested == total_writes


def test_dispatch_counts_snapshot_and_reset():
    from p2pfl_tpu_torch.management.profiling import (
        get_dispatch_counts,
        record_dispatch,
        reset_dispatch_counts,
        snapshot_and_reset_dispatch_counts,
        total_dispatches,
    )

    reset_dispatch_counts()
    record_dispatch("site_a")
    record_dispatch("site_a")
    record_dispatch("site_b")
    assert total_dispatches() == 3
    snap = snapshot_and_reset_dispatch_counts()
    assert snap == {"site_a": 2, "site_b": 1}
    assert get_dispatch_counts() == {}


def test_stopwatch_thread_safe():
    from p2pfl_tpu_torch.management.profiling import Stopwatch

    sw = Stopwatch()
    n_threads, per_thread = 8, 300

    def hammer():
        for _ in range(per_thread):
            with sw.section("hot"):
                pass

    threads = [threading.Thread(target=hammer) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert sw.counts["hot"] == n_threads * per_thread
    s = sw.summary()
    assert s["hot"]["calls"] == n_threads * per_thread
    assert "p95_ms" in s["hot"] and "p99_ms" in s["hot"]


def test_global_metric_storage_dedup_and_sorted():
    from p2pfl_tpu_torch.management.metric_storage import GlobalMetricStorage

    store = GlobalMetricStorage()
    store.add_log("e", 3, "acc", "n", 0.3)
    store.add_log("e", 1, "acc", "n", 0.1)
    store.add_log("e", 1, "acc", "n", 0.999)  # a duplicate round: dropped
    store.add_log("e", 2, "acc", "n", 0.2)
    assert store.get_all_logs()["e"]["n"]["acc"] == [(1, 0.1), (2, 0.2), (3, 0.3)]
    store.add_log("e", 1, "loss", "n", 9.0)
    assert store.get_all_logs()["e"]["n"]["loss"] == [(1, 9.0)]


# ---- wire trace context ----


def test_trace_ctx_grpc_codec_roundtrip():
    from p2pfl_tpu_torch.communication.grpc_transport import (
        decode_message,
        decode_weights,
        encode_message,
        encode_weights,
    )
    from p2pfl_tpu_torch.communication.message import Message, WeightsEnvelope
    from p2pfl_tpu_torch.learning.weights import ModelUpdate

    msg = Message("a:1", "vote", ("x", "1"), round=2, trace_ctx=("tid9", "sid7"))
    back = decode_message(encode_message(msg))
    assert back.trace_ctx == ("tid9", "sid7")
    assert (back.source, back.cmd, tuple(back.args)) == (msg.source, msg.cmd, tuple(msg.args))

    old = json.loads(encode_message(msg).decode())
    del old["tc"]
    legacy = decode_message(json.dumps(old).encode())
    assert legacy.trace_ctx is None
    assert legacy.msg_id == msg.msg_id

    update = ModelUpdate({"w": torch.ones(4)}, ["a:1"], 10)
    env = WeightsEnvelope("a:1", 1, "add_model", update, trace_ctx=("tw", "sw"))
    wire = encode_weights(env)
    assert decode_weights(wire).trace_ctx == ("tw", "sw")
    hlen = int.from_bytes(wire[:4], "little")
    header = json.loads(wire[4 : 4 + hlen].decode())
    del header["tc"]
    raw = json.dumps(header).encode()
    legacy_wire = b"".join((len(raw).to_bytes(4, "little"), raw, wire[4 + hlen :]))
    assert decode_weights(legacy_wire).trace_ctx is None


def test_trace_ctx_links_sender_and_receiver_in_memory():
    nodes = _mk_nodes(2)
    try:
        a, b = nodes
        telemetry.reset_spans()
        with telemetry.span(a.addr, "probe_stage", kind="stage") as sp:
            msg = a.protocol.build_msg("metrics", ["test_acc", "1.0"], round=0)
            assert msg.trace_ctx == (sp.trace_id, sp.span_id)
            assert a.protocol.send(b.addr, msg)
        recv = [s for s in telemetry.spans(b.addr) if s.name == "recv:metrics" and s.node == b.addr]
        assert recv, "receiver recorded no recv span"
        assert recv[0].trace_id == sp.trace_id
        assert recv[0].parent_id == sp.span_id
    finally:
        _stop_all(nodes)


# ---- the round report and the Chrome export on a federation ----


@pytest.fixture()
def _slow_peer_federation():
    nodes = _mk_nodes(4)
    slow = nodes[-1]
    install_fault_plan(nodes, FaultPlan(seed=42, slow_nodes={slow.addr: 0.25}))
    telemetry.reset_spans()
    yield nodes, slow
    remove_fault_plan(nodes)
    _stop_all(nodes)


def test_round_report_names_slow_peer(_slow_peer_federation):
    nodes, slow = _slow_peer_federation
    Settings.TRAIN_SET_SIZE = 4
    nodes[0].set_start_learning(rounds=1, epochs=1)
    wait_to_finish(nodes, timeout=45)
    report = telemetry.round_report(0)
    assert set(report.per_node) == {n.addr for n in nodes}
    assert report.critical_edge is not None
    assert report.critical_edge["dst"] == slow.addr
    assert report.critical_edge["busy_s"] >= 0.25
    assert report.faults.get("fault_slow", 0) >= 1
    for info in report.per_node.values():
        assert info["wall_s"] > 0
        assert info["stages_s"]
    assert "critical edge" in report.describe()


def test_chrome_trace_export_schema(tmp_path, _slow_peer_federation):
    nodes, _slow = _slow_peer_federation
    Settings.TRAIN_SET_SIZE = 4
    nodes[0].set_start_learning(rounds=1, epochs=1)
    wait_to_finish(nodes, timeout=45)
    out = tmp_path / "trace.json"
    doc = telemetry.export_chrome_trace(path=str(out))
    n_events = validate_chrome_trace(doc)
    assert n_events > 20
    reloaded = json.loads(out.read_text())
    assert validate_chrome_trace(reloaded) == n_events
    events = reloaded["traceEvents"]
    proc_names = {e["pid"]: e["args"]["name"] for e in events if e.get("name") == "process_name"}
    assert set(proc_names.values()) >= {n.addr for n in nodes}
    tids = {e["tid"] for e in events if e.get("ph") == "X"}
    assert PLANES["stage"] in tids and PLANES["gossip"] in tids
    x_events = [e for e in events if e.get("ph") == "X"]
    assert all("trace_id" in e["args"] and "span_id" in e["args"] for e in x_events)
    # a node filter keeps that node's lanes alone
    one = telemetry.export_chrome_trace(nodes=[nodes[0].addr])
    assert {e["args"]["name"] for e in one["traceEvents"] if e.get("name") == "process_name"} == {nodes[0].addr}


def test_validate_chrome_trace_rejects_malformed():
    with pytest.raises(ValueError):
        validate_chrome_trace({"no": "traceEvents"})
    with pytest.raises(ValueError):
        validate_chrome_trace({"traceEvents": [{"ph": "X", "name": "x", "pid": 1, "tid": 1}]})
    with pytest.raises(ValueError):
        validate_chrome_trace({"traceEvents": [{"ph": "?", "name": "x", "pid": 1, "tid": 1}]})


def test_deterministic_round_trace_id_across_nodes():
    nodes = _mk_nodes(2)
    try:
        telemetry.reset_spans()
        nodes[0].set_start_learning(rounds=1, epochs=1)
        wait_to_finish(nodes, timeout=30)
        by_node = {}
        for s in telemetry.spans():
            if s.kind == "stage" and s.attrs.get("round") == 0 and s.name in ("TrainStage", "GossipModelStage"):
                by_node.setdefault(s.node, set()).add(s.trace_id)
        assert len(by_node) == 2
        ids = set().union(*by_node.values())
        assert len(ids) == 1, f"round 0 split into traces: {ids}"
        assert [rnd for _exp, rnd in telemetry.observed_rounds()] == [0]
    finally:
        _stop_all(nodes)


def test_flight_recorder_chaos_federation(tmp_path):
    """Seeded 6-node chaos run (5 % drop, a slow peer, a crash in round 0):
    the dumped trace validates and the report names the slow peer and the
    crashed one."""
    Settings.TRAIN_SET_SIZE = 6
    Settings.AGGREGATION_TIMEOUT = 60.0
    nodes = _mk_nodes(6)
    victim, slow = nodes[3], nodes[-1]
    plan = FaultPlan(
        seed=1905,
        default=EdgeFault(drop=0.05),
        slow_nodes={slow.addr: 0.3},
        crashes={victim.addr: CrashSpec(stage="TrainStage", round_no=0)},
    )
    install_fault_plan(nodes, plan)
    telemetry.reset_spans()
    survivors = [n for n in nodes if n is not victim]
    try:
        nodes[0].set_start_learning(rounds=2, epochs=1)
        wait_to_finish(survivors, timeout=45)
        assert not victim._running

        paths = telemetry_mod.dump_flight_record(str(tmp_path))
        trace = json.loads(open(paths[0]).read())
        assert validate_chrome_trace(trace) > 50
        reports = json.loads(open(paths[1]).read())
        affected = [r for r in reports if r["round"] == 0]
        assert affected, "round 0 produced no report"
        rep = affected[0]
        assert rep["critical_path"]["edge"]["dst"] in (slow.addr, victim.addr)
        busiest = max(rep["edges"].items(), key=lambda kv: kv[1]["busy_s"])
        assert busiest[0].endswith(f"->{slow.addr}")
        assert rep["faults"].get("fault_crash", 0) >= 1
        assert rep["critical_path"]["most_failed_peer"] == victim.addr
        spans = telemetry.spans()
        by_id = {s.span_id: s for s in spans}
        cross = [
            s for s in spans
            if s.name.startswith("recv:") and s.parent_id in by_id and by_id[s.parent_id].node != s.node
        ]
        assert cross, "no cross-node parent links recorded"
    finally:
        remove_fault_plan(nodes)
        _stop_all(nodes)


def test_disabled_span_is_cheap():
    n = 20_000
    Settings.TELEMETRY_ENABLED = False
    try:
        t0 = time.perf_counter()
        for _ in range(n):
            with telemetry.span("x", "s"):
                pass
        off = time.perf_counter() - t0
    finally:
        Settings.TELEMETRY_ENABLED = True
    t0 = time.perf_counter()
    for _ in range(n):
        with telemetry.span("x", "s"):
            pass
    on = time.perf_counter() - t0
    assert off < on
    assert on / n < 200e-6


# ---- parity with the JAX package's recorder ----


def _feed(registry, span_cls, rows) -> None:
    """Put ``rows`` (``Span.to_dict`` form) into ``registry`` as spans with
    exactly those fields."""
    for row in rows:
        span = span_cls(row["node"], row["name"], row["kind"], row["trace_id"], row["parent_id"], dict(row["attrs"]))
        span.span_id = row["span_id"]
        span.t0_ns, span.t1_ns = row["t0_ns"], row["t1_ns"]
        registry._ring(row["node"]).append(span)


def _seeded_rows(seed: int) -> list:
    """A seeded flight record of 4 nodes over 2 rounds of 2 experiments:
    FSM stages and nested waits, sends (some failed), retries, faults,
    events and a span of an unknown kind, with parent links."""
    rng = np.random.default_rng(seed)
    nodes = [f"n{i}" for i in range(4)]
    rows, k = [], 0

    def add(node, name, kind, t0, dur, attrs, parent=None, trace="t"):
        nonlocal k
        k += 1
        rows.append({"trace_id": trace, "span_id": f"s{k}", "parent_id": parent, "node": node, "name": name,
                     "kind": kind, "t0_ns": int(t0), "t1_ns": int(t0 + dur), "attrs": attrs})
        return f"s{k}"

    t = 1_000_000_000
    for exp in ("exp-a", "exp-b"):
        for rnd in range(2):
            trace = f"{exp}:0:r{rnd}"
            for node in nodes:
                clock = t + int(rng.integers(0, 5_000_000))
                for stage in ("VoteTrainSetStage", "TrainStage", "GossipModelStage", "RoundFinishedStage"):
                    dur = int(rng.integers(1_000_000, 80_000_000))
                    sid = add(node, stage, "stage", clock, dur, {"round": rnd, "experiment": exp}, trace=trace)
                    if stage == "TrainStage":
                        add(node, "aggregation_wait", "stage", clock + dur // 4, dur // 2,
                            {"round": rnd, "experiment": exp}, parent=sid, trace=trace)
                    for peer in nodes:
                        if peer != node and rng.random() < 0.6:
                            ok = bool(rng.random() > 0.15)
                            add(node, "send:add_model", "gossip", clock + dur // 3, int(rng.integers(0, 30_000_000)),
                                {"peer": peer, "ok": ok, "bytes": None}, parent=sid, trace=trace)
                            if not ok:
                                add(node, "retry", "retry", clock + dur // 2, 0,
                                    {"peer": peer, "delay_s": float(rng.random() / 4)}, parent=sid, trace=trace)
                    if rng.random() < 0.3:
                        add(node, "fault_drop", "fault", clock + dur // 5, 0, {"peer": nodes[0]}, parent=sid,
                            trace=trace)
                    clock += dur
                add(node, "beat", "heartbeat", clock, 1000, {})
                add(node, "custom", "other-kind", clock, 5000, {"x": 1})
                add(node, "StartLearningStage", "stage", t - 10_000_000, 5_000_000, {"round": None, "experiment": exp})
            t += 200_000_000
    return rows


def _registries(rows):
    port, jax_reg = telemetry_mod.Telemetry(), jax_telemetry_mod.Telemetry()
    _feed(port, telemetry_mod.Span, rows)
    _feed(jax_reg, jax_telemetry_mod.Span, rows)
    return port, jax_reg


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_export_and_report_equal_jax_on_the_same_spans(seed):
    rows = _seeded_rows(seed)
    port, jax_reg = _registries(rows)
    assert port.export_chrome_trace() == jax_reg.export_chrome_trace()
    assert port.export_chrome_trace(nodes=["n1", "n3"]) == jax_reg.export_chrome_trace(nodes=["n1", "n3"])
    assert port.observed_rounds() == jax_reg.observed_rounds() == [("exp-a", 0), ("exp-a", 1), ("exp-b", 0), ("exp-b", 1)]
    for exp, rnd in [*port.observed_rounds(), (None, 0), (None, 1), ("exp-a", 7)]:
        mine, theirs = port.round_report(rnd, exp), jax_reg.round_report(rnd, exp)
        assert mine.to_dict() == theirs.to_dict()
        assert mine.describe() == theirs.describe()
    assert [s.to_dict() for s in port.spans()] == [s.to_dict() for s in jax_reg.spans()]


def test_report_of_a_port_federation_equals_jax_on_its_spans(_slow_peer_federation):
    """The spans a real port round recorded (ids aside: replayed as they
    are) give JAX's export and report."""
    nodes, _slow = _slow_peer_federation
    Settings.TRAIN_SET_SIZE = 4
    nodes[0].set_start_learning(rounds=1, epochs=1)
    wait_to_finish(nodes, timeout=45)
    rows = [s.to_dict() for s in telemetry.spans()]
    _port, jax_reg = _registries(rows)
    assert telemetry.export_chrome_trace() == jax_reg.export_chrome_trace()
    for exp, rnd in telemetry.observed_rounds():
        assert telemetry.round_report(rnd, exp).to_dict() == jax_reg.round_report(rnd, exp).to_dict()


MALFORMED = [
    None,
    [],
    {"no": "traceEvents"},
    {"traceEvents": {}},
    {"traceEvents": [1]},
    {"traceEvents": [{"ph": "X", "name": "x", "pid": 1, "tid": 1}]},
    {"traceEvents": [{"ph": "?", "name": "x", "pid": 1, "tid": 1}]},
    {"traceEvents": [{"ph": "X", "pid": 1, "tid": 1, "ts": 0, "dur": 1}]},
    {"traceEvents": [{"ph": "X", "name": "x", "tid": 1, "ts": 0, "dur": 1}]},
    {"traceEvents": [{"ph": "X", "name": "x", "pid": 1, "ts": 0, "dur": 1}]},
    {"traceEvents": [{"ph": "X", "name": "x", "pid": 1, "tid": 1, "ts": "0", "dur": 1}]},
    {"traceEvents": [{"ph": "X", "name": "x", "pid": 1, "tid": 1, "ts": 0, "dur": -1}]},
    {"traceEvents": [{"ph": "i", "name": "x", "pid": 1, "tid": 1}]},
    {"traceEvents": [{"ph": "M", "name": "x", "pid": 1, "tid": 1, "args": {"v": {1, 2}}}]},
    {"traceEvents": [{"ph": "B", "name": "x", "pid": 1, "tid": 1}, {"ph": "E", "name": "x", "pid": 1, "tid": 1}]},
    {"traceEvents": [{"ph": "i", "name": "x", "pid": 1, "tid": 1, "ts": 2.5, "s": "t"}], "displayTimeUnit": "ms"},
]


@pytest.mark.parametrize("doc", MALFORMED, ids=range(len(MALFORMED)))
def test_validate_chrome_trace_verdict_equals_jax(doc):
    def verdict(fn):
        try:
            return ("ok", fn(doc))
        except (ValueError, TypeError) as exc:
            return (type(exc).__name__, str(exc))

    assert verdict(validate_chrome_trace) == verdict(jax_telemetry_mod.validate_chrome_trace)


def test_dump_flight_record_writes_value_histograms_only_when_recorded(tmp_path):
    with telemetry.span("n", "TrainStage", kind="stage", attrs={"round": 0, "experiment": "e"}):
        pass
    paths = telemetry_mod.dump_flight_record(str(tmp_path / "a"))
    assert [p.rsplit("/", 1)[-1] for p in paths] == ["trace.json", "round_reports.json"]
    telemetry.observe_value("n", "staleness", 2)
    paths = telemetry_mod.dump_flight_record(str(tmp_path / "b"))
    assert paths[-1].endswith("value_histograms.json")
    assert json.loads(open(paths[-1]).read())["n/staleness"]["count"] == 1


def test_exit_dump_env_writes_the_record(tmp_path):
    """``P2PFL_TELEMETRY_DUMP`` in a fresh process: the record lands there
    at exit."""
    import subprocess
    import sys

    out = tmp_path / "dump"
    code = (
        "from p2pfl_tpu_torch.management.telemetry import telemetry\n"
        "with telemetry.span('n', 'TrainStage', kind='stage', attrs={'round': 0, 'experiment': 'e'}):\n"
        "    pass\n"
    )
    env = {**__import__("os").environ, "P2PFL_TELEMETRY_DUMP": str(out)}
    subprocess.run([sys.executable, "-c", code], check=True, env=env, timeout=120,
                   cwd=str(__import__("pathlib").Path(__file__).resolve().parent.parent))
    reports = json.loads((out / "round_reports.json").read_text())
    assert reports[0]["round"] == 0 and reports[0]["critical_path"]["stage"] == "TrainStage"
    assert validate_chrome_trace(json.loads((out / "trace.json").read_text())) == 3
