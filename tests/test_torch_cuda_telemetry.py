"""The operations surface on the card: ``profiling.trace`` sees kernel 9's
device events, ``dispatch_span``'s ``p2pfl:`` range sits beside them,
``NodeMonitor`` reports the card's memory, and the port's CUDA graph
captures still succeed after a profiled round (``capture_guard``).

Marked ``cuda``: they need an NVIDIA GPU with ``nvcc`` and skip elsewhere.
This file imports only the port (the card machine has no flax):

    timeout 300 python -m pytest -m cuda tests/test_torch_cuda_telemetry.py

``chip_smoke.py`` (phases ``gossip`` and ``main``) drives the same surface
on the Node path and the flash round.
"""

import gc
import json
import subprocess
import sys
import threading
import weakref

import pytest
import torch

from p2pfl_tpu_torch.management import profiling
from p2pfl_tpu_torch.management.node_monitor import NodeMonitor
from p2pfl_tpu_torch.ops import _kernels
from p2pfl_tpu_torch.settings import Settings

pytestmark = pytest.mark.cuda

#: the profiler may lose a window whole: a check that needs device events
#: profiles up to this many windows
TRIES = 3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    _kernels.build()
    return torch.device("cuda")


def test_trace_sees_kernel9_and_the_dispatch_range(cuda, tmp_path):
    gen = torch.Generator(device=cuda).manual_seed(0)
    srcs = [torch.randn(n, device=cuda, generator=gen) for n in (784 * 256, 256, 256 * 128, 128, 1280, 10)]
    dsts = [torch.empty_like(x) for x in srcs]
    _kernels.ici_exchange(srcs, dsts)  # warm: the first launch loads the library
    torch.cuda.synchronize()
    for _ in range(TRIES):
        with profiling.trace(str(tmp_path)) as prof:
            with profiling.dispatch_span("exchange_probe", device=cuda):
                _kernels.ici_exchange(srcs, dsts)
        device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if any("ici_exchange" in e.name for e in device):
            break
    assert any("ici_exchange" in e.name for e in device), f"{TRIES} profiled windows lost every device event"
    assert any(e.name == "p2pfl:exchange_probe" for e in prof.events())
    assert (tmp_path / prof.trace_path.rsplit("/", 1)[-1]).stat().st_size > 0
    assert all(torch.equal(a, b) for a, b in zip(srcs, dsts))


def test_node_monitor_reports_device_memory(cuda):
    resident = torch.empty(1 << 20, device=cuda)  # 4 MB the allocator holds
    prev = Settings.RESOURCE_MONITOR_PERIOD
    Settings.RESOURCE_MONITOR_PERIOD = 0.05
    seen, got = [], threading.Event()

    def report(node, metric, value):
        seen.append((metric, value))
        if metric == "device0_mem_mb":
            got.set()

    monitor = NodeMonitor("card-node", report_fn=report)
    try:
        monitor.start()
        assert got.wait(10.0)
    finally:
        monitor.stop()
        Settings.RESOURCE_MONITOR_PERIOD = prev
    mem = [v for m, v in seen if m == "device0_mem_mb"]
    assert min(mem) >= resident.numel() * 4 / 1e6


#: one CUDA graph capture in a process of its own (a failed capture can
#: leave the allocator routing to the dead graph's pool), after garbage
#: that only reference cycles keep. argv[1]:
#: "graph": a replayed graph is the garbage; a collection inside the
#:     capture frees it (its finalizer runs on the capturing thread);
#: "held": a block of all the card's free memory but 1 GiB is the
#:     garbage; ``torch.cuda.graph`` (which empties the cache but no
#:     longer collects) captures a body that needs 2 GiB;
#: "late": the same block; a collection inside the capture frees it
#:     before the body's 2 GiB are allocated;
#: "guarded": both, the collector on at a threshold of one allocation;
#:     ``capture_guard`` then ``torch.cuda.graph``, the 2 GiB body.
_CAPTURE_AFTER_GARBAGE = """
import gc, json, sys
import torch
from p2pfl_tpu_torch.parallel.spmd import capture_guard

class Cycle:
    pass

dev = torch.device("cuda")
x = torch.ones(1 << 10, device=dev)
side = torch.cuda.Stream(dev)
gc.disable()
kind = sys.argv[1]
c = Cycle()
c.me = c
if kind in ("graph", "guarded"):
    c.graph = torch.cuda.CUDAGraph()
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        x * 2
        with torch.cuda.graph(c.graph, stream=side):
            x * 2
    torch.cuda.current_stream(dev).wait_stream(side)
    c.graph.replay()
if kind != "graph":
    free, _ = torch.cuda.mem_get_info()
    c.block = torch.empty(free - (1 << 30), dtype=torch.uint8, device=dev)
torch.cuda.synchronize()
del c

def body():
    if kind == "graph":
        x * 2
    else:
        torch.empty(2 << 30, dtype=torch.uint8, device=dev).fill_(1)
    if kind == "guarded":
        [Cycle() for _ in range(1000)]

graph = torch.cuda.CUDAGraph()
out = {}
try:
    if kind == "guarded":
        gc.set_threshold(1)
        gc.enable()
        with capture_guard(), torch.cuda.graph(graph):
            body()
    elif kind == "held":
        with torch.cuda.graph(graph):
            body()
    else:
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                gc.collect()
                body()
            finally:
                graph.capture_end()
    torch.cuda.synchronize()
    out["captured"] = True
except Exception as exc:
    out = {"captured": False, "error": type(exc).__name__ + ": " + str(exc).splitlines()[0][:300]}
out["reserved_gib"] = torch.cuda.memory_reserved() / 2**30
out["allocated_gib"] = torch.cuda.memory_allocated() / 2**30
print(json.dumps(out))
"""


def test_garbage_fails_a_capture_unless_collected_first(cuda):
    """Why ``capture_guard`` exists. A collection inside a capture that
    frees a dead CUDA graph fails the capture ("graph"). Card memory that
    only a reference cycle keeps fails a capture that needs it ("held"),
    and a collection inside the capture comes too late: the memory goes to
    the allocator's cache, where the capture's private pool cannot use it
    ("late"). Collected and the cache emptied before the capture, with
    the collector off across it, both kinds of garbage are harmless
    ("guarded")."""
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    got = {}
    for kind in ("graph", "held", "late", "guarded"):
        run = subprocess.run([sys.executable, "-c", _CAPTURE_AFTER_GARBAGE, kind], capture_output=True, text=True,
                             timeout=120, cwd=root, env={**os.environ, "PYTHONPATH": root})
        assert run.returncode == 0, run.stderr[-2000:]
        got[kind] = json.loads(run.stdout.strip().splitlines()[-1])
    print(json.dumps(got))
    assert not got["graph"]["captured"] and "during capture" in got["graph"]["error"], got
    assert not got["held"]["captured"] and not got["late"]["captured"], got
    # held: the block still allocated; late: freed into the cache, not returned
    assert got["held"]["allocated_gib"] > 10 and got["late"]["allocated_gib"] < 1, got
    assert got["late"]["reserved_gib"] > 10, got
    assert got["guarded"]["captured"], got


class _Cycle:
    pass


def _dead_block(device) -> weakref.ref:
    """All the card's free memory but 256 MiB in a block that only a
    reference cycle keeps: the garbage an earlier drive's Nodes or
    federation leave (Nodes hold their threads, callbacks and learners in
    cycles)."""
    free, _ = torch.cuda.mem_get_info(device)
    c = _Cycle()
    c.me, c.block = c, torch.empty(free - (256 << 20), dtype=torch.uint8, device=device)
    return weakref.ref(c)


def test_captures_after_a_profiled_round(cuda, tmp_path):
    """One SPMD round under ``profiling.trace`` (its ``p2pfl:`` range in
    the profile), then, in the same process, with the collector off and
    most of the card held by dead garbage before each capture:
    ``run_fused`` captures its span and a learner's fused round captures
    its step (``CapturedTrainStep``), both without degrading; each
    capture's guard freed the garbage first."""
    from p2pfl_tpu_torch.learning.dataset import FederatedDataset
    from p2pfl_tpu_torch.learning.learner import TorchLearner
    from p2pfl_tpu_torch.management.logger import logger
    from p2pfl_tpu_torch.models.vision import mlp
    from p2pfl_tpu_torch.parallel.spmd import SpmdFederation

    data = FederatedDataset.synthetic_mnist(n_train=1024, n_test=128)
    fed = SpmdFederation.from_dataset(mlp(device=cuda), data, n_nodes=4, batch_size=64, vote=False)
    with profiling.trace(str(tmp_path)) as prof:
        fed.run_round()
    assert any(e.name == "p2pfl:spmd_round" for e in prof.events())
    del prof
    learner = TorchLearner(mlp(seed=0, device=cuda), data, addr="card-capture", batch_size=128, epochs=1, seed=0)
    gc.disable()
    try:
        dead = _dead_block(cuda)
        entries = fed.run_fused(2)
        assert dead() is None and len(fed._spans) == 1
        assert all(torch.isfinite(e["train_loss"]) for e in entries)
        logger.reset_comm_metrics()
        dead = _dead_block(cuda)
        for _ in range(2):
            assert learner.fused_round() is not None
            learner.set_parameters(learner.get_parameters())
        assert dead() is None
        counts = logger.get_comm_metrics(learner.addr)
    finally:
        gc.enable()
    assert counts.get("fused_graph_capture") == 1 and counts.get("fused_graph_replay") == 1, counts
    assert "fused_round_degraded" not in counts, counts
