"""The port's fault injection against the JAX package's.

The per-edge verdict streams (drop, duplicate, jitter) and the Byzantine
corruptions are drawn from the same seeded ``random.Random`` streams and
numpy generators in both packages, so 1,000 sends per edge must give the
same verdicts and bit-equal corrupted payloads. Then the plan on a live
port federation: partitions, slow peers, a crash at a stage that the
survivors repair, install/remove, and the churn specs (restart, join,
leave and the live fleet's churn timers).
"""

import threading
import time

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from p2pfl_tpu.communication import faults as jf
from p2pfl_tpu.communication.message import Message as JaxMessage
from p2pfl_tpu.learning.weights import ModelUpdate as JaxModelUpdate
from p2pfl_tpu.learning.weights import named_leaves as jax_named_leaves
from p2pfl_tpu_torch.communication import faults as tf
from p2pfl_tpu_torch.communication.memory import MemoryRegistry
from p2pfl_tpu_torch.communication.message import Message, WeightsEnvelope
from p2pfl_tpu_torch.learning.dataset import FederatedDataset
from p2pfl_tpu_torch.learning.learner import DummyLearner, TorchLearner
from p2pfl_tpu_torch.learning.weights import ModelUpdate
from p2pfl_tpu_torch.management.logger import logger
from p2pfl_tpu_torch.models.vision import mlp
from p2pfl_tpu_torch.node import Node, stop_leaked_nodes
from p2pfl_tpu_torch.ops.tree import tree_items
from p2pfl_tpu_torch.settings import set_test_settings
from p2pfl_tpu_torch.utils import full_connection, wait_convergence, wait_to_finish

torch.set_num_threads(2)
SENDS = 1000
EDGES = [("a", "b"), ("b", "a"), ("a", "c"), ("127.0.0.1:5000", "127.0.0.1:5001")]


@pytest.fixture(autouse=True)
def _port_env():
    set_test_settings()
    logger.set_level("INFO")
    MemoryRegistry.reset()
    yield
    stop_leaked_nodes()
    MemoryRegistry.reset()


def _record(log: list, lock: threading.Lock):
    def transport_send(nei, env, create_connection=False):
        with lock:
            log.append((nei, getattr(env, "cmd", "?")))
        return True

    return transport_send


def _drive(pkg, seed: int, fault_kw: dict, sends: int) -> tuple[list, int]:
    """``sends`` sends on every edge, interleaved; returns the per-send
    results and the number of delayed duplicate deliveries."""
    plan = pkg.FaultPlan(seed, default=pkg.EdgeFault(**fault_kw))
    msg_cls = JaxMessage if pkg is jf else Message
    injectors = {src: pkg.FaultInjector(plan, src) for src, _ in EDGES}
    log: list = []
    lock = threading.Lock()
    send = _record(log, lock)
    results = []
    for k in range(sends):
        for src, dst in EDGES:
            env = msg_cls(src, "beat", (str(k),))
            results.append((src, dst, injectors[src](dst, env, False, send)))
    time.sleep(0.2)  # the duplicates land after duplicate_delay
    return results, len(log) - sum(ok for *_, ok in results)


@pytest.mark.parametrize(
    "fault_kw",
    [dict(drop=0.3), dict(duplicate=0.25, duplicate_delay=0.001), dict(drop=0.2, duplicate=0.4, duplicate_delay=0.001),
     dict(drop=0.5, scope="weights")],
    ids=["drop", "duplicate", "drop_duplicate", "weights_scope"],
)
def test_edge_verdicts_are_bitwise_equal_over_1000_sends(fault_kw):
    want, want_dups = _drive(jf, 11, fault_kw, SENDS)
    got, got_dups = _drive(tf, 11, fault_kw, SENDS)
    assert got == want
    assert got_dups == want_dups
    drops = sum(not ok for *_, ok in got)
    if "weights" == fault_kw.get("scope"):
        assert drops == 0  # control messages are out of the fault's scope
    elif fault_kw.get("drop"):
        assert 0.5 * fault_kw["drop"] < drops / len(got) < 1.5 * fault_kw["drop"]


def test_jitter_draws_match_jax():
    """The third draw of each verdict tuple is the jitter: the edge
    streams advance identically, so each delay is the same."""
    for src, dst in EDGES:
        jp, tp = jf.FaultPlan(5), tf.FaultPlan(5)
        for _ in range(SENDS):
            assert [tp.rng(src, dst).random() for _ in range(3)] == [jp.rng(src, dst).random() for _ in range(3)]
        assert tp.byz_rng(src, dst).getrandbits(32) == jp.byz_rng(src, dst).getrandbits(32)


def _trees(seed: int):
    rng = np.random.default_rng(seed)
    np_tree = {
        "Dense_0": {"kernel": rng.standard_normal((6, 4)).astype(np.float32),
                    "bias": rng.standard_normal(4).astype(np.float32)},
        "emb": rng.standard_normal((3, 5)).astype(ml_dtypes.bfloat16),
        "steps": np.arange(3, dtype=np.int32),
    }

    def to_t(x):
        if isinstance(x, dict):
            return {k: to_t(v) for k, v in x.items()}
        if x.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
        return torch.from_numpy(x.copy())

    return np_tree, to_t(np_tree)


def _port_leaves(params) -> dict:
    out = {}
    for k, v in tree_items(params):
        out[k] = v.view(torch.int16).numpy().view(ml_dtypes.bfloat16) if v.dtype == torch.bfloat16 else v.numpy()
    return out


@pytest.mark.parametrize("kind", ["sign_flip", "scale", "noise", "stale_replay", "equivocate"])
def test_byzantine_payloads_are_bitwise_equal_over_1000_sends(kind):
    spec = dict(kind=kind, lam=7.5, noise_std=0.3)
    jplan = jf.FaultPlan(3, byzantine={"a": jf.ByzantineSpec(**spec)})
    tplan = tf.FaultPlan(3, byzantine={"a": tf.ByzantineSpec(**spec)})
    for k in range(SENDS):
        np_tree, t_tree = _trees(k % 7)
        dst = ("b", "c")[k % 2]
        want = jf.byz_corrupt_update(jplan, "a", dst, JaxModelUpdate(jax.tree.map(np.asarray, np_tree), ["a"], 5),
                                     "add_model")
        got = tf.byz_corrupt_update(tplan, "a", dst, ModelUpdate(t_tree, ["a"], 5), "add_model")
        assert got.contributors == want.contributors and got.num_samples == want.num_samples
        want_flat = {key: np.asarray(v) for key, v in jax_named_leaves(want.params)[1]}
        got_flat = _port_leaves(got.params)
        assert sorted(got_flat) == sorted(want_flat)
        for key, w in want_flat.items():
            g = got_flat[key]
            assert g.dtype == w.dtype and g.shape == w.shape and g.tobytes() == w.tobytes(), (k, key)
        # the honest tree is never written
        assert torch.equal(t_tree["Dense_0"]["bias"], _trees(k % 7)[1]["Dense_0"]["bias"])
    # a command outside the spec's cmds, or a byte-only update: no lie
    assert tf.byz_corrupt_update(tplan, "a", "b", ModelUpdate(t_tree, ["a"], 5), "init_model") is None
    assert tf.byz_corrupt_update(tplan, "a", "b", ModelUpdate(None, ["a"], 5), "add_model") is None
    assert tf.byz_corrupt_update(tplan, "z", "b", ModelUpdate(t_tree, ["a"], 5), "add_model") is None


def test_byzantine_noise_lands_on_the_leaf_device_and_dtype():
    _, t_tree = _trees(0)
    plan = tf.FaultPlan(1, byzantine={"a": tf.ByzantineSpec(kind="noise")})
    bad = tf.byz_corrupt_update(plan, "a", "b", ModelUpdate(t_tree, ["a"], 1), "add_model")
    for (k, v), (_, w) in zip(tree_items(bad.params), tree_items(t_tree)):
        assert v.dtype == w.dtype and v.device == w.device and v.data_ptr() != w.data_ptr(), k


def test_partitions_and_slow_peers():
    plan = tf.FaultPlan(0, partitions=[("a", "b")], slow_nodes={"c": 0.15})
    inj = tf.FaultInjector(plan, "a")
    log: list = []
    send = _record(log, threading.Lock())
    assert not inj("b", Message("a", "beat"), False, send)  # a -> b is cut
    assert tf.FaultInjector(plan, "b")("a", Message("b", "beat"), False, send)  # one way only
    t0 = time.monotonic()
    assert inj("c", Message("a", "beat"), False, send)
    fast = time.monotonic() - t0
    t0 = time.monotonic()
    env = WeightsEnvelope("a", 0, "add_model", ModelUpdate({"w": torch.zeros(2)}, ["a"], 1))
    assert inj("c", env, False, send)
    assert time.monotonic() - t0 >= 0.15 > fast  # weights pay the straggler's latency, control does not
    assert log == [("a", "beat"), ("c", "beat"), ("c", "add_model")]


def test_a_duplicated_control_message_comes_back_with_a_fresh_id():
    env = Message("a", "vote_train_set", ("x", "1"), round=2, ttl=5, trace_ctx=("t", "s"), xp="e")
    copy = tf._stale_copy(env)
    assert copy.msg_id != env.msg_id and copy.ttl == 1 and (copy.cmd, copy.args, copy.xp) == (env.cmd, env.args, "e")
    w = WeightsEnvelope("a", 0, "add_model", ModelUpdate(None, ["a"], 1))
    assert tf._stale_copy(w) is w
    jcopy = jf._stale_copy(JaxMessage("a", "vote_train_set", ("x", "1"), round=2, ttl=5))
    assert (jcopy.ttl, jcopy.round) == (copy.ttl, copy.round)


@pytest.mark.parametrize("spec", ["RestartSpec", "JoinSpec", "LeaveSpec", "schedule_churn"])
def test_churn_runs_as_in_jax(spec):
    """The churn half of the plan: each spec has JAX's fields and defaults
    and drives what it drives there (a restart kills then resurrects, a
    join and a leave churn a simulated fleet exactly as JAX's does), and
    schedule_churn fires the live fleet's join and leave callbacks."""
    import dataclasses

    from p2pfl_tpu.federation.simfleet import SimulatedAsyncFleet as JFleet
    from p2pfl_tpu_torch.federation.simfleet import SimulatedAsyncFleet

    if spec != "schedule_churn":
        fields = [(f.name, f.default) for f in dataclasses.fields(getattr(tf, spec))]
        assert fields == [(f.name, f.default) for f in dataclasses.fields(getattr(jf, spec))]
    if spec == "RestartSpec":
        node = Node(learner=DummyLearner(device="cpu"))
        node.start()
        node.state.round = 1
        revived = threading.Event()
        plan = tf.FaultPlan(0, restarts={node.addr: tf.RestartSpec(round_no=1, resume_after_s=0.05)})
        hook = tf.make_stage_hook(plan, resurrect_fn=lambda addr: revived.set())
        hook(node, "TrainStage")  # another stage: nothing
        assert node.is_running()
        with pytest.raises(tf.FaultCrash):
            hook(node, "AsyncTrainStage")
        assert not node.is_running() and revived.wait(5) and node.addr in plan._crashed
        hook(node, "AsyncTrainStage")  # fires once
    elif spec in ("JoinSpec", "LeaveSpec"):
        def plan(pkg):
            churn = {"joins": {"sim-j000": pkg.JoinSpec(0.6), "sim-j001": pkg.JoinSpec(1.1)}} if spec == "JoinSpec" \
                else {"leaves": {"sim-0003": pkg.LeaveSpec(0.5), "sim-0000": pkg.LeaveSpec(0.7, graceful=False)}}
            return pkg.FaultPlan(seed=5, **churn)

        want = JFleet(40, seed=3, cluster_size=8, updates_per_node=4, plan=plan(jf)).run()
        got = SimulatedAsyncFleet(40, seed=3, cluster_size=8, updates_per_node=4, plan=plan(tf), device="cpu").run()
        assert (got.joined, got.left, got.failovers, got.merges) == (want.joined, want.left, want.failovers, want.merges)
        assert got.joined or got.left
    else:
        calls, lock = [], threading.Lock()
        plan = tf.FaultPlan(0, joins={"j": tf.JoinSpec(0.05)}, leaves={"l": tf.LeaveSpec(0.1, graceful=False)})

        def record(*a):
            with lock:
                calls.append(a)

        timers = tf.schedule_churn(plan, record, record)
        for t in timers:
            t.join(5)
        assert len(timers) == 2 and sorted(calls) == [("j",), ("l", False)]


def _fleet(n: int):
    data = FederatedDataset.synthetic_mnist(n_train=128 * n, n_test=32)
    nodes = [Node(learner=TorchLearner(mlp(seed=i, device="cpu"), data.partition(i, n), batch_size=64, seed=i))
             for i in range(n)]
    for node in nodes:
        node.start()
    for node in nodes:
        full_connection(node, nodes)
    wait_convergence(nodes, n - 1, only_direct=True, wait=10)
    return nodes


def test_a_crash_at_a_stage_is_repaired_by_the_survivors():
    """A node hard-crashes entering its round-0 TrainStage: no goodbyes;
    the survivors evict it by heartbeat silence, repair the train set and
    finish the experiment on one model."""
    nodes = _fleet(3)
    victim = nodes[2]
    plan = tf.FaultPlan(0, crashes={victim.addr: tf.CrashSpec("TrainStage", round_no=0)})
    tf.install_fault_plan(nodes, plan)
    try:
        nodes[0].set_start_learning(rounds=1, epochs=1)
        wait_to_finish(nodes[:2], timeout=60)
        assert not victim.is_running() and victim.addr in plan._crashed
        a, b = (dict(tree_items(n.learner.get_parameters())) for n in nodes[:2])
        assert all(torch.equal(a[k], b[k]) for k in a)
        assert logger.get_comm_metrics(victim.addr).get("fault_crash") == 1
    finally:
        tf.remove_fault_plan(nodes)
        assert all(n.protocol.fault_injector is None and not n.stage_hooks for n in nodes)
        for n in nodes:
            n.stop()


def test_a_lossy_plan_on_a_live_federation_still_converges():
    """10% drops and 20% duplicates on every edge (the retry queue and the
    aggregator's contributor checks absorb them): both nodes end on one
    model, and the injector's verdicts show in the comm metrics."""
    nodes = _fleet(2)
    tf.install_fault_plan(nodes, tf.FaultPlan(7, default=tf.EdgeFault(drop=0.1, duplicate=0.2, duplicate_delay=0.01)))
    try:
        nodes[0].set_start_learning(rounds=2, epochs=1)
        wait_to_finish(nodes, timeout=60)
        a, b = (dict(tree_items(n.learner.get_parameters())) for n in nodes)
        assert all(torch.equal(a[k], b[k]) for k in a)
        metrics = [logger.get_comm_metrics(n.addr) for n in nodes]
        assert sum(m.get("fault_drop", 0) for m in metrics) > 0
        assert sum(m.get("fault_duplicate", 0) for m in metrics) > 0
    finally:
        for n in nodes:
            n.stop()
