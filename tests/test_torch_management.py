"""The port's operations surface against the JAX package's: the CLI, the
node monitor, the web dashboard client and its wiring into the logger, the
file log, the stall watchdog, the plots, the low-latency settings, the
public exceptions and ``ops.tree``'s tree arithmetic.

Twins of ``tests/test_management.py``'s CLI, monitor and web tests, of
``tests/test_watchdog.py`` and of ``tests/test_plotting.py``. The logger,
its web handler and the watchdog are process-wide: every test that
connects, starts or changes one disconnects, stops and restores it in a
``finally`` (the suite runs several tests a worker process). The web tests
serve on a loopback port and wait on an event per expected path, never on
a sleep.
"""

from __future__ import annotations

import http.server
import json
import logging
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2pfl_tpu import settings as jax_settings
from p2pfl_tpu.ops import tree as jax_tree
from p2pfl_tpu_torch import ops as port_ops
from p2pfl_tpu_torch.management.logger import logger
from p2pfl_tpu_torch.settings import Settings, set_test_settings

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _port_env():
    set_test_settings()
    logger.set_level("INFO")
    yield
    set_test_settings()


# ---- the CLI ----


def test_cli_experiment_list(capsys):
    from p2pfl_tpu_torch.cli import main

    assert main(["experiment", "list"]) == 0
    out = capsys.readouterr().out
    names = [line.split()[0] for line in out.splitlines()]
    assert {"mnist", "spmd_mnist", "lora_ft", "bench_mnist"} <= set(names)
    # a pipe (pytest's capture) keeps the plain two-column form
    assert "┌" not in out and "\033[" not in out


def test_cli_experiment_list_fancy_on_tty(capsys, monkeypatch):
    import p2pfl_tpu_torch.cli as cli

    monkeypatch.setattr(cli, "_fancy", lambda: True)
    assert cli.main(["experiment", "list"]) == 0
    out = capsys.readouterr().out
    assert "┌" in out and "│ experiment" in out and "└" in out
    assert "mnist" in out and "PyTorch" in out


def test_cli_table_renders_rows():
    from p2pfl_tpu_torch.cli import _table

    t = _table(["a", "bb"], [["x", "y"], ["longer", "z"]])
    lines = t.splitlines()
    assert lines[0].startswith("┌") and lines[-1].startswith("└")
    assert len({len(line) for line in lines}) == 1
    assert "longer" in t and "bb" in t
    assert _table(["h"], []).count("\n") == 3


def test_cli_unknown_experiment_and_stubs(capsys):
    from p2pfl_tpu_torch.cli import main

    assert main(["experiment", "run", "nope"]) == 1
    assert "mnist" in capsys.readouterr().out
    for stub in ("login", "remote", "launch"):
        assert main([stub]) == 0
        assert "coming soon" in capsys.readouterr().out
    assert main([]) == 1
    assert main(["experiment"]) == 1


def test_cli_runs_an_example_on_the_cpu(capsys):
    from p2pfl_tpu_torch.cli import main

    assert main(["experiment", "run", "mnist", "--device", "cpu", "--nodes", "2", "--rounds", "1",
                 "--samples", "512", "--batch-size", "64"]) == 0
    out = capsys.readouterr().out
    assert out.count("test_acc") == 2


def test_cli_run_defaults_to_the_card():
    """Without ``--device`` an example asks for CUDA: here, with none, it
    raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the run would take it")
    from p2pfl_tpu_torch import DeviceUnavailableError
    from p2pfl_tpu_torch.cli import main

    with pytest.raises(DeviceUnavailableError):
        main(["experiment", "run", "mnist", "--nodes", "2", "--rounds", "1"])


def test_python_m_help_runs():
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-m", "p2pfl_tpu_torch", "--help"], capture_output=True, text=True,
                          timeout=120, cwd=repo)
    assert proc.returncode == 0 and "experiment" in proc.stdout


# ---- the node monitor ----


def test_node_monitor_reports():
    from p2pfl_tpu_torch.management.node_monitor import NodeMonitor

    Settings.RESOURCE_MONITOR_PERIOD = 0.05
    seen, enough = [], threading.Event()

    def report(node, metric, value):
        seen.append((metric, value))
        if {"cpu_percent", "ram_percent", "net_out_mbs"} <= {m for m, _ in seen}:
            enough.set()

    mon = NodeMonitor("test-node", report_fn=report)
    try:
        mon.start()
        assert enough.wait(10.0)
    finally:
        mon.stop()
    metrics = {m for m, _ in seen}
    assert {"cpu_percent", "ram_percent", "net_out_mbs", "net_in_mbs"} <= metrics
    # no card here: no device memory sample
    assert not any(m.startswith("device") for m in metrics) or torch.cuda.is_available()


def test_node_monitor_without_psutil_still_samples_the_card(monkeypatch):
    """Where psutil is missing the monitor keeps running and reports the
    device memory alone (stand-in card with 3 MB held)."""
    import builtins

    from p2pfl_tpu_torch.management import node_monitor

    real_import = builtins.__import__

    def no_psutil(name, *a, **kw):
        if name == "psutil":
            raise ImportError("no psutil")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_psutil)
    monkeypatch.setattr(node_monitor.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(node_monitor.torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(node_monitor.torch.cuda, "memory_stats", lambda i: {"allocated_bytes.all.current": 3_000_000})
    Settings.RESOURCE_MONITOR_PERIOD = 0.05
    seen, twice = [], threading.Event()

    def report(node, metric, value):
        seen.append((metric, value))
        if len(seen) >= 2:
            twice.set()

    mon = node_monitor.NodeMonitor("no-psutil", report_fn=report)
    try:
        mon.start()
        assert twice.wait(10.0)
    finally:
        mon.stop()
    assert {m for m, _ in seen} == {"device0_mem_mb"}
    assert seen[0][1] == 3.0


# ---- the web dashboard client ----


def test_web_services_swallow_failures():
    from p2pfl_tpu_torch.management.web_services import WebServices

    ws = WebServices("http://127.0.0.1:1", "key", timeout=0.2)
    ws.register_node("n1")  # nothing listens: must not raise
    ws.send_global_metric("e", 0, "acc", "n1", 0.5)
    assert ws._node_key is None


class _Dashboard:
    """A loopback HTTP server recording every POST; ``wait(path)`` blocks
    until one reached ``path``."""

    def __init__(self) -> None:
        self.received: list = []
        self._events: dict = {}
        self._lock = threading.Lock()
        dash = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_POST(self):
                body = self.rfile.read(int(self.headers["Content-Length"]))
                with dash._lock:
                    dash.received.append((self.path, self.headers.get("x-api-key"), json.loads(body)))
                    dash._event(self.path).set()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.end_headers()
                self.wfile.write(b'{"node_key": "k1"}')

            def log_message(self, *a):
                pass

        self.server = http.server.HTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.server.server_port}"
        threading.Thread(target=self.server.serve_forever, daemon=True).start()

    def _event(self, path: str) -> threading.Event:
        return self._events.setdefault(path, threading.Event())

    def wait(self, path: str, timeout: float = 10.0) -> bool:
        with self._lock:
            ev = self._event(path)
        return ev.wait(timeout)

    def close(self) -> None:
        self.server.shutdown()
        self.server.server_close()


def test_web_services_posts():
    from p2pfl_tpu_torch.management.web_services import WebServices

    dash = _Dashboard()
    try:
        ws = WebServices(dash.url, "secret")
        ws.register_node("n1", is_simulated=True)
        ws.send_local_metric("exp", 1, "loss", "n1", 5, 0.25)
        ws.send_global_metric("exp", 1, "acc", "n1", 0.5)
        ws.send_system_metric("n1", "cpu_percent", 12.0, "now")
        ws.send_log("now", "n1", "INFO", "hi")
        ws.unregister_node("n1")
        paths = [p for p, _, _ in dash.received]
        assert paths == ["/node", "/node-metric/local", "/node-metric/global", "/node-metric/system",
                         "/node-log", "/node-stop"]
        assert all(key == "secret" for _, key, _ in dash.received)
        assert dash.received[1][2]["metric"] == "loss" and dash.received[1][2]["step"] == 5
        assert dash.received[0][2] == {"address": "n1", "is_simulated": True}
        assert ws._node_key == "k1"
    finally:
        dash.close()


def test_logger_web_wiring():
    """register_node and log_metric mirror to the dashboard; the monitor
    reports system metrics; log lines ship through the queue listener;
    unregister_node stops the monitor and tells the dashboard."""
    from p2pfl_tpu_torch.management.web_services import WebServices

    Settings.RESOURCE_MONITOR_PERIOD = 0.05
    dash = _Dashboard()
    try:
        logger.connect_web_services(WebServices(dash.url, "k"))
        logger.register_node("web-node-1", simulation=True)
        assert "web-node-1" in logger._monitors
        logger.log_metric("web-node-1", "acc", 0.9, round=1, experiment="e1")
        logger.log_metric("web-node-1", "loss", 1.0, step=3, round=1, experiment="e1")
        logger.info("web-node-1", "hello dashboard")
        for path in ("/node", "/node-metric/global", "/node-metric/local", "/node-metric/system", "/node-log"):
            assert dash.wait(path), f"no POST to {path}"
        logger.unregister_node("web-node-1")
        assert "web-node-1" not in logger._monitors
        assert dash.wait("/node-stop")
        logs = [b for p, _, b in dash.received if p == "/node-log"]
        assert any("hello dashboard" in b["message"] and b["address"] == "web-node-1" for b in logs)
        system = [b for p, _, b in dash.received if p == "/node-metric/system"]
        assert {"cpu_percent", "ram_percent"} <= {b["metric"] for b in system}
    finally:
        logger.disconnect_web_services()
        logger.unregister_node("web-node-1")
        dash.close()
    assert logger._web is None and logger._web_listener is None and not logger._monitors
    # disconnected: nothing more is mirrored
    n = len(dash.received)
    logger.log_metric("web-node-1", "acc", 0.1, round=2, experiment="e1")
    assert len(dash.received) == n


def test_file_logging(tmp_path):
    path = logger.enable_file_logging(str(tmp_path / "logs"))
    try:
        assert logger.enable_file_logging(str(tmp_path / "other")) == path  # a second call keeps the file
        logger.info("file-node", "to the file")
        logger.critical("file-node", "critical line")
        logger._file_handler.flush()
        text = open(path).read()
        assert "[file-node] to the file" in text and "CRITICAL | [file-node] critical line" in text
        assert path == str(tmp_path / "logs" / "p2pfl_tpu_torch.log")
    finally:
        logger.disable_file_logging()
    assert logger._file_handler is None
    assert not (tmp_path / "other").exists()


def test_learning_states_lists_registered_states():
    from p2pfl_tpu_torch.node_state import NodeState

    st = NodeState("ls-node")
    logger.register_node("ls-node", st)
    logger.register_node("ls-bare")
    try:
        states = dict(logger.learning_states())
        assert states.get("ls-node") is st and "ls-bare" not in states
    finally:
        logger.unregister_node("ls-node")
        logger.unregister_node("ls-bare")


# ---- the stall watchdog ----


@pytest.fixture
def _watchdog():
    from p2pfl_tpu_torch.management.watchdog import StallWatchdog

    try:
        yield StallWatchdog
    finally:
        StallWatchdog.shutdown()
        Settings.STALL_WATCHDOG_S = 0.0
        logger.unregister_node("stuck-node")
        logger.unregister_node("moving-node")


def test_all_thread_stacks_names_threads():
    from p2pfl_tpu_torch.management.watchdog import all_thread_stacks

    dump = all_thread_stacks()
    assert "MainThread" in dump and "test_all_thread_stacks" in dump


def test_watchdog_disabled_by_default(_watchdog):
    assert Settings.STALL_WATCHDOG_S == 0.0
    assert _watchdog.ensure_started() is None


def test_stall_detected_and_reported_once(_watchdog):
    from p2pfl_tpu_torch.node_state import NodeState

    records = []

    class _Capture(logging.Handler):
        def emit(self, record):
            records.append(record)

    handler = _Capture()
    logging.getLogger("p2pfl_tpu_torch").addHandler(handler)
    try:
        Settings.STALL_WATCHDOG_S = 0.4
        stuck = NodeState("stuck-node")
        stuck.status = "Learning"
        stuck.round = 1
        stuck.current_stage = "VoteTrainSetStage"
        stuck.last_transition = time.monotonic() - 10.0
        logger.register_node("stuck-node", stuck)
        moving = NodeState("moving-node")
        moving.status = "Learning"
        moving.last_transition = time.monotonic()
        logger.register_node("moving-node", moving)
        logger.reset_comm_metrics()
        assert _watchdog.ensure_started() is not None
        assert _watchdog.ensure_started() is _watchdog._instance

        def wait_for_hits(expected, timeout=5.0):
            deadline = time.monotonic() + timeout
            while time.monotonic() < deadline:
                moving.last_transition = time.monotonic()
                got = [r for r in records if "STALL" in r.getMessage()]
                if len(got) >= expected:
                    return got
                time.sleep(0.05)
            return [r for r in records if "STALL" in r.getMessage()]

        hits = wait_for_hits(1)
        assert hits, "the watchdog never reported the stall"
        msg = hits[0].getMessage()
        assert "stuck-node" in msg and "VoteTrainSetStage" in msg
        assert "stall-watchdog" in msg or "MainThread" in msg
        assert all("moving-node" not in r.getMessage() for r in hits)
        assert logger.get_comm_metrics("stuck-node").get("stall_detected", 0) == 1
        assert logger.get_comm_metrics("moving-node").get("stall_detected", 0) == 0
        # one report a stall, not one a tick
        assert len(wait_for_hits(2, timeout=1.0)) == len(hits)
        # a transition clears the latch: a new stall reports again
        stuck.last_transition = time.monotonic() - 10.0
        assert len(wait_for_hits(len(hits) + 1, timeout=2.0)) == len(hits) + 1
    finally:
        logging.getLogger("p2pfl_tpu_torch").removeHandler(handler)


def test_node_start_starts_the_watchdog(_watchdog):
    from p2pfl_tpu_torch.communication.memory import MemoryRegistry
    from p2pfl_tpu_torch.learning.learner import DummyLearner
    from p2pfl_tpu_torch.node import Node

    Settings.STALL_WATCHDOG_S = 30.0
    node = Node(learner=DummyLearner(device="cpu"))
    try:
        node.start()
        assert _watchdog._instance is not None
    finally:
        node.stop()
        MemoryRegistry.reset()


# ---- the plots ----


def test_plot_global_and_local_from_logger(tmp_path):
    pytest.importorskip("matplotlib")
    from p2pfl_tpu_torch.management.plotting import plot_global_metrics, plot_local_metrics

    logger.register_node("plot-node")
    try:
        for rnd in (0, 1, 2):
            logger.log_metric("plot-node", "test_acc", 0.5 + 0.1 * rnd, round=rnd, experiment="plot-exp")
            for step in range(4):
                logger.log_metric("plot-node", "train_loss", 2.0 - 0.1 * step, step=step, round=rnd,
                                  experiment="plot-exp")
        g = plot_global_metrics(str(tmp_path / "g.png"), experiment="plot-exp")
        loc = plot_local_metrics(str(tmp_path / "l.png"), experiment="plot-exp")
        assert g and os.path.getsize(g) > 1000
        assert loc and os.path.getsize(loc) > 1000
    finally:
        logger.unregister_node("plot-node")


def test_plot_global_empty_returns_none(tmp_path):
    from p2pfl_tpu_torch.management.plotting import plot_global_metrics

    assert plot_global_metrics(str(tmp_path / "x.png"), experiment="no-such-exp") is None


def test_plot_history(tmp_path):
    pytest.importorskip("matplotlib")
    from p2pfl_tpu_torch.management.plotting import plot_history

    hist = [{"round": r, "train_loss": torch.tensor(2.0 / (r + 1)), "test_acc": 0.3 + 0.2 * r} for r in range(4)]
    p = plot_history(hist, str(tmp_path / "h.png"), title="t")
    assert p and os.path.getsize(p) > 1000
    assert plot_history([], str(tmp_path / "e.png")) is None


def test_plot_history_late_appearing_metric(tmp_path):
    pytest.importorskip("matplotlib")
    from p2pfl_tpu_torch.management.plotting import plot_history

    hist = [
        {"round": 0, "train_loss": 2.0},
        {"round": 1, "train_loss": 1.5},
        {"round": 2, "train_loss": 1.2, "test_acc": 0.41},
        {"round": 3, "train_loss": 1.0, "test_acc": 0.55},
    ]
    p = plot_history(hist, str(tmp_path / "late.png"), title="late")
    assert p and os.path.getsize(p) > 1000


def test_plotting_imports_no_matplotlib():
    import subprocess
    import sys

    code = ("import sys, p2pfl_tpu_torch.management.plotting, p2pfl_tpu_torch.examples.spmd_mnist\n"
            "sys.exit(1 if 'matplotlib' in sys.modules else 0)\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert subprocess.run([sys.executable, "-c", code], cwd=repo, timeout=120).returncode == 0


# ---- settings and exceptions ----


def test_low_latency_settings_equal_jax():
    from p2pfl_tpu_torch.settings import set_low_latency_settings

    keys = ("GRPC_TIMEOUT", "HEARTBEAT_PERIOD", "HEARTBEAT_TIMEOUT", "GOSSIP_PERIOD", "GOSSIP_MODELS_PERIOD",
            "VOTE_TIMEOUT", "AGGREGATION_TIMEOUT", "SECAGG_RECOVERY_TIMEOUT", "WAIT_HEARTBEATS_CONVERGENCE",
            "MESSAGE_RETRY_BASE", "MESSAGE_RETRY_CAP", "BREAKER_SUSPECT_TIMEOUT", "GOSSIP_MODELS_PER_ROUND")
    jax_before = {k: getattr(jax_settings.Settings, k) for k in keys}
    try:
        set_low_latency_settings()
        jax_settings.set_low_latency_settings()
        assert {k: getattr(Settings, k) for k in keys} == {k: getattr(jax_settings.Settings, k) for k in keys}
    finally:
        for k, v in jax_before.items():
            setattr(jax_settings.Settings, k, v)


def test_telemetry_annotations_switch():
    from p2pfl_tpu_torch.settings import telemetry_annotations

    assert Settings.TELEMETRY_ANNOTATIONS is None
    try:
        assert telemetry_annotations(torch.device("cuda", 0)) is True
        assert telemetry_annotations("cuda:1") is True
        assert telemetry_annotations("cpu") is False
        assert telemetry_annotations() is False
        Settings.TELEMETRY_ANNOTATIONS = False
        assert telemetry_annotations("cuda") is False
        Settings.TELEMETRY_ANNOTATIONS = True
        assert telemetry_annotations("cpu") is True
    finally:
        Settings.TELEMETRY_ANNOTATIONS = None


def test_dispatch_span_opens_a_profiler_range_when_annotating(tmp_path):
    from p2pfl_tpu_torch.management import profiling

    def ranges(annotate):
        Settings.TELEMETRY_ANNOTATIONS = annotate
        try:
            with profiling.trace(str(tmp_path)) as prof:
                with profiling.dispatch_span("probe_site", "n"):
                    torch.ones(8).sum()
        finally:
            Settings.TELEMETRY_ANNOTATIONS = None
        return [e.name for e in prof.events() if e.name.startswith("p2pfl:")], prof.trace_path

    names, path = ranges(True)
    assert names == ["p2pfl:probe_site"] and os.path.getsize(path) > 0
    assert ranges(False)[0] == []
    assert profiling.get_dispatch_counts()["probe_site"] == 2


@pytest.mark.parametrize("optimizer, per_param", [("adam", 14), ("sgd", 2)])
def test_compiled_flops_against_round_flops_on_the_mlp_round(optimizer, per_param):
    """``compiled_flops`` over one MLP round (4 nodes, 2 steps) held to the
    federation's analytic ``round_flops``: FlopCounterMode counts the
    GEMMs of every step (``round_flops``' per-step model FLOPs) and the
    aggregation's contraction (2 a parameter a node), and leaves out what
    has no formula: the optimizer's elementwise operations (``per_param``
    a parameter a step) and the rest of the aggregation (3 a parameter a
    node of ``round_flops``' 5)."""
    from p2pfl_tpu_torch.learning.dataset import FederatedDataset
    from p2pfl_tpu_torch.management.profiling import compiled_flops
    from p2pfl_tpu_torch.models.vision import mlp
    from p2pfl_tpu_torch.parallel.spmd import SpmdFederation, _model_step_flops

    data = FederatedDataset.synthetic_mnist(n_train=512, n_test=64)
    fed = SpmdFederation.from_dataset(mlp(device="cpu"), data, n_nodes=4, batch_size=64, vote=False, device="cpu",
                                      optimizer=optimizer)
    analytic = fed.round_flops()
    _fwd, step = _model_step_flops(fed.module, fed.model.params, fed.x_all, fed.y_all, fed.batch_size)
    counted = compiled_flops(fed.run_round)
    assert fed.round == 1  # the counted call ran
    n, steps, p = fed.n, fed._nb, fed.model.param_count
    assert counted == n * steps * step + 2 * n * p
    assert analytic - counted == n * steps * per_param * p + 3 * n * p
    with pytest.raises(ZeroDivisionError):
        compiled_flops(lambda: 1 / 0)


def test_compiled_flops_is_none_when_a_formula_fails(monkeypatch):
    """A formula's own failure loses the count, not the call: the call
    still runs to its end."""
    from torch.utils import flop_counter

    from p2pfl_tpu_torch.management.profiling import compiled_flops

    def broken(*args, **kwargs):
        raise ValueError("no formula")

    monkeypatch.setitem(flop_counter.flop_registry, torch.ops.aten.mm, broken)
    x, ran = torch.ones(2, 2), []
    assert compiled_flops(lambda: ran.append(x @ x)) is None
    assert len(ran) == 1 and torch.equal(ran[0], torch.full((2, 2), 2.0))


def test_capture_guard_collects_first_and_quiets_the_collector():
    """Every capture site enters ``capture_guard``: cyclic garbage is
    collected before the capture, which holds the process's capture lock
    with automatic collection off until it ends, an error included."""
    import gc
    import weakref

    from p2pfl_tpu_torch.parallel import spmd

    class Cycle:
        pass

    def garbage():
        c = Cycle()
        c.me = c
        return weakref.ref(c)

    thresholds = gc.get_threshold()
    gc.disable()  # keep the garbage until the guard collects it
    try:
        ref = garbage()
        assert ref() is not None
        gc.set_threshold(1_000_000)
        gc.enable()
        with spmd.capture_guard():
            assert ref() is None and spmd._CAPTURE_LOCK.locked() and not gc.isenabled()
        assert not spmd._CAPTURE_LOCK.locked() and gc.isenabled()
        with pytest.raises(RuntimeError), spmd.capture_guard():
            raise RuntimeError("capture failed")
        assert not spmd._CAPTURE_LOCK.locked() and gc.isenabled()
        gc.disable()
        with spmd.capture_guard():
            pass
        assert not gc.isenabled()  # a caller's disabled collector stays so
    finally:
        gc.set_threshold(*thresholds)
        gc.enable()


def test_compiled_flops_counts_a_lora_round_where_flop_counter_mode_raises():
    """The LoRA round takes ``torch.autograd.grad`` over its leaves, where
    ``FlopCounterMode``'s module tracker raises; ``compiled_flops`` counts
    it. On the CPU the flash path is the plain blocked version, aten
    products that count; dense attention's products count the same way."""
    from torch.utils.flop_counter import FlopCounterMode

    from p2pfl_tpu_torch.learning.dataset import FederatedDataset
    from p2pfl_tpu_torch.management.profiling import compiled_flops
    from p2pfl_tpu_torch.models.transformer import TransformerConfig, tiny_transformer
    from p2pfl_tpu_torch.parallel.spmd_lora import SpmdLoraFederation

    cfg = TransformerConfig(vocab_size=64, dim=64, n_heads=2, n_kv_heads=1, n_layers=1, ffn_hidden=64, lora_rank=4)
    data = FederatedDataset.synthetic_lm(vocab_size=64, seq_len=32, n_train=8, n_test=4)
    counts = {}
    for attn in ("dense", "flash"):
        model = tiny_transformer(seq_len=32, seed=0, cfg=cfg, attn=attn, device="cpu")
        fed = SpmdLoraFederation.from_dataset(model, data, n_nodes=2, batch_size=2, vote=False, seed=3, device="cpu")
        if attn == "dense":
            with pytest.raises(RuntimeError, match="autograd.grad"):
                with FlopCounterMode(display=False):
                    fed.run_round()
        counts[attn] = compiled_flops(fed.run_round)
    assert counts["dense"] > 0 and counts["flash"] >= counts["dense"]


def test_exceptions_exported():
    from p2pfl_tpu_torch import exceptions

    assert issubclass(exceptions.CommunicationError, Exception)
    assert issubclass(exceptions.LearnerNotSetException, Exception)


# ---- tree arithmetic against JAX ----


def _trees(seed: int):
    rng = np.random.default_rng(seed)
    shapes = {"a": {"w": (3, 4), "b": (4,)}, "c": (2, 2, 2)}

    def make():
        out = {}
        for k, v in shapes.items():
            out[k] = {kk: rng.standard_normal(s).astype(np.float32) for kk, s in v.items()} if isinstance(v, dict) \
                else rng.standard_normal(v).astype(np.float32)
        return out

    return [make() for _ in range(3)]


def _to_torch(tree):
    return port_ops.tree.tree_map(lambda x: torch.from_numpy(np.array(x)), tree)


def _to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _close(port_tree, jax_tree_, atol=1e-6):
    ours = [np.asarray(x) for x in port_ops.tree.tree_leaves(port_tree)]
    theirs = [np.asarray(x) for x in jax.tree.leaves(jax_tree_)]
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(a, b, atol=atol, rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_tree_ops_equal_jax(seed):
    t0, t1, t2 = _trees(seed)
    p = [_to_torch(t) for t in (t0, t1, t2)]
    j = [_to_jax(t) for t in (t0, t1, t2)]
    _close(port_ops.tree_add(p[0], p[1]), jax_tree.tree_add(j[0], j[1]))
    _close(port_ops.tree_sub(p[0], p[1]), jax_tree.tree_sub(j[0], j[1]))
    _close(port_ops.tree_scale(p[0], 0.37), jax_tree.tree_scale(j[0], 0.37))
    _close(port_ops.tree_zeros_like(p[2]), jax_tree.tree_zeros_like(j[2]))
    w = [3.0, 1.0, 4.0]
    _close(port_ops.tree_weighted_mean(p, w), jax_tree.tree_weighted_mean(j, w))
    stacked = port_ops.tree_stack(p)
    for ours, theirs in zip(port_ops.tree_unstack(stacked, 3), jax_tree.tree_unstack(jax_tree.tree_stack(j), 3)):
        _close(ours, theirs)
    assert port_ops.tree_bytes(p[0]) == jax_tree.tree_bytes(j[0])
    assert port_ops.tree_num_params(p[0]) == jax_tree.tree_num_params(j[0])
    near = port_ops.tree_scale(p[0], 1.01)
    assert port_ops.tree_allclose(p[0], near, atol=0.1) == jax_tree.tree_allclose(j[0], jax_tree.tree_scale(j[0], 1.01))
    assert port_ops.tree_allclose(p[0], p[1], atol=1e-3) == jax_tree.tree_allclose(j[0], j[1], atol=1e-3) is False
    assert port_ops.tree_allclose(p[0], {"a": p[0]["a"]}) is False


def test_tree_ops_keep_bf16():
    x = {"w": torch.ones(4, dtype=torch.bfloat16)}
    assert port_ops.tree_scale(x, 0.5)["w"].dtype == torch.bfloat16
    assert port_ops.tree_weighted_mean([x, x], [1, 1])["w"].dtype == torch.bfloat16
    assert port_ops.tree_bytes(x) == 8
