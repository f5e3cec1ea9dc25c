"""The async control plane's host logic in the port against the JAX package.

Staleness weights, version vectors, the HierFAVG topology and the
TierRouter's whole decision surface (roles, push targets, update sinks,
fan-outs, buffer plans, reconcile ops, successor election) are host code:
over random memberships and dead sets the port must answer exactly as
JAX does. Then the wire's version triple and experiment identity
(byte-identical frames, old frames decode unchanged), and the settings
fault this slice repairs: ``FEDERATION_MODE="async"`` reaches the async
workflow and an unknown mode raises at ``Node.start``.
"""

import random

import numpy as np
import pytest
import torch

from p2pfl_tpu.communication import grpc_transport as jg
from p2pfl_tpu.communication.message import Message as JMessage
from p2pfl_tpu.communication.message import WeightsEnvelope as JEnvelope
from p2pfl_tpu.federation import routing as jr
from p2pfl_tpu.federation import staleness as js
from p2pfl_tpu.federation import topology as jt
from p2pfl_tpu.learning.weights import ModelUpdate as JUpdate
from p2pfl_tpu_torch.communication import grpc_transport as tg
from p2pfl_tpu_torch.communication.memory import MemoryRegistry
from p2pfl_tpu_torch.communication.message import Message, WeightsEnvelope
from p2pfl_tpu_torch.federation import routing as tr
from p2pfl_tpu_torch.federation import staleness as ts
from p2pfl_tpu_torch.federation import topology as tt
from p2pfl_tpu_torch.learning.learner import DummyLearner
from p2pfl_tpu_torch.learning.weights import ModelUpdate
from p2pfl_tpu_torch.management.logger import logger
from p2pfl_tpu_torch.node import Node, stop_leaked_nodes
from p2pfl_tpu_torch.settings import Settings, set_test_settings
from p2pfl_tpu_torch.utils import full_connection, wait_convergence, wait_to_finish


@pytest.fixture(autouse=True)
def _port_env():
    set_test_settings()
    logger.set_level("INFO")
    MemoryRegistry.reset()
    yield
    stop_leaked_nodes()
    Settings.FEDERATION_MODE = "sync"
    Settings.HIER_CLUSTER_SIZE = 0
    MemoryRegistry.reset()


def _memberships(seed: int, count: int):
    """``count`` random (members, dead, cluster_size) views, exact."""
    rng = random.Random(seed)
    for _ in range(count):
        n = rng.randint(1, 60)
        members = [f"node-{rng.randint(0, 999):03d}" for _ in range(n)]
        dead = set(rng.sample(members, rng.randint(0, len(members))))
        yield members, dead, rng.choice([0, 1, 2, 3, 4, 5, 8, 16, 32, 64])


def test_staleness_weight_bit_equal():
    rng = np.random.default_rng(0)
    for tau in list(range(-3, 40)) + list(rng.uniform(-2, 1e4, 200)):
        for alpha in (0.0, 0.25, 0.5, 1.0, 2.0, 3.7):
            assert ts.staleness_weight(tau, alpha) == js.staleness_weight(tau, alpha)  # exact


def test_version_vector_and_high_water_follow_jax():
    """The same random (origin, seq) observations and merges give the same
    verdicts and marks in both packages."""
    rng = random.Random(1)
    a, b = js.VersionVector(), ts.VersionVector()
    ha, hb = jr.VersionHighWater(), tr.VersionHighWater()
    for _ in range(2000):
        origin, seq = rng.choice("abcdef"), rng.randint(0, 30)
        if rng.random() < 0.05:
            other = {rng.choice("abcdefg"): rng.randint(0, 40) for _ in range(3)}
            a.merge(other)
            b.merge(other)
        assert a.observe(origin, seq) == b.observe(origin, seq)
        v = rng.choice([None, rng.randint(0, 50)])
        ha.observe(v)
        hb.observe(v)
    assert a.snapshot() == b.snapshot() and ha.mark == hb.mark
    assert ts.as_version(["x", "3", 4.0]) == js.as_version(["x", "3", 4.0]) == ("x", 3, 4)
    assert ts.as_version(None) is None


def test_topology_describe_and_roles_bit_equal():
    for members, _dead, cs in _memberships(2, 300):
        a, b = jt.HierarchicalTopology(members, cs), tt.HierarchicalTopology(members, cs)
        assert a.describe() == b.describe()
        for m in a.members:
            assert (a.tier(m), a.aggregator_for(m), a.parent_of(m), a.children_of(m)) == (
                b.tier(m), b.aggregator_for(m), b.parent_of(m), b.children_of(m))


def _router_answers(r, members, k: int) -> dict:
    out = {"describe": r.describe(), "roles": r.roles(), "root": r.root, "regionals": r.regionals}
    probes = sorted(set(members)) + ["node-zzz"]  # a non-member too
    for m in probes:
        out[m] = (
            r.push_target(m), r.live_children(m), tuple(r.buffer_plan(m, k)),
            [r.update_sink(m, o) for o in probes],
            [tuple(op) for hr in (False, True) for hg in (False, True) for op in r.reconcile_ops(m, k, hr, hg)],
        )
    return out


def test_tier_router_decision_matrix_and_reconcile_ops_bit_equal():
    """Every routing decision over 150 random views, the reconcile ops for
    every buffer state included, equals JAX's."""
    for members, dead, cs in _memberships(3, 150):
        k = 1 + len(members) % 6
        assert _router_answers(tr.TierRouter(members, cs, dead=dead), members, k) == _router_answers(
            jr.TierRouter(members, cs, dead=dead), members, k)


def test_successor_election_follows_jax_as_members_die():
    """Members die one at a time, every other death the current root's:
    after each death the root, the regionals and every role are JAX's (the
    successor chain)."""
    rng = random.Random(4)
    for cs in (0, 3, 4, 8):
        members = [f"n{i:02d}" for i in range(24)]
        dead: set = set()
        roots = []
        for step in range(len(members)):
            live = [m for m in members if m not in dead]
            root = tr.TierRouter(members, cs, dead=dead).root
            dead.add(root if step % 2 == 0 else rng.choice(live))
            a, b = jr.TierRouter(members, cs, dead=dead), tr.TierRouter(members, cs, dead=dead)
            assert (a.root, a.regionals, a.roles()) == (b.root, b.regionals, b.roles())
            roots.append(b.root)
        assert roots[-1] is None and len(set(roots)) > 2  # the root did move


def test_wire_version_and_xp_roundtrip_match_jax_frames():
    """The "vv" and "xp" keys: the port's frame is byte-identical to JAX's,
    each decodes the other's, and frames without them (older senders) carry
    neither key and decode to None."""
    w = np.arange(6, dtype=np.float32)
    for version, xp in ((("a", 7, 3), "xid-2"), (None, None), (("reg", 1, 0), None)):
        jupd = JUpdate({"w": w.copy()}, ["a"], 2)
        jupd.version, jupd.xp = version, xp
        tupd = ModelUpdate({"w": torch.from_numpy(w.copy())}, ["a"], 2, xp=xp, version=version)
        jraw = jg.encode_weights(JEnvelope("a", 0, "async_update", jupd, "m1"))
        traw = tg.encode_weights(WeightsEnvelope("a", 0, "async_update", tupd, "m1"))
        assert traw == jraw
        out = tg.decode_weights(jraw)
        assert out.update.version == version and out.update.xp == xp
        assert jg.decode_weights(traw).update.version == version
        assert (b'"vv"' in traw) == (version is not None) and (b'"xp"' in traw) == (xp is not None)
    msg = tg.decode_message(jg.encode_message(JMessage("a", "async_done", (), 0, xp="xid-1")))
    assert msg.xp == "xid-1" and msg.cmd == "async_done"
    assert tg.encode_message(Message("a", "async_leave", (), 0, msg_id="m2")) == jg.encode_message(
        JMessage("a", "async_leave", (), 0, msg_id="m2"))


def _nodes(n: int):
    nodes = [Node(learner=DummyLearner(value=float(i), device="cpu")) for i in range(n)]
    for node in nodes:
        node.start()
    for node in nodes:
        full_connection(node, nodes)
    wait_convergence(nodes, n - 1, only_direct=True, wait=10)
    return nodes


def test_federation_mode_async_reaches_the_async_workflow(monkeypatch):
    """On the parent tree FEDERATION_MODE="async" silently ran the round
    FSM. Now it runs AsyncLearningWorkflow: the async verbs carry the
    updates and no sync stage is entered."""
    from p2pfl_tpu_torch.federation import workflow

    ran = []
    real = workflow.AsyncLearningWorkflow.run
    monkeypatch.setattr(workflow.AsyncLearningWorkflow, "run", lambda self, node: (ran.append(node.addr), real(self, node)))
    Settings.FEDERATION_MODE = "async"
    Settings.FEDBUFF_K = 2
    nodes = _nodes(2)
    try:
        nodes[0].set_start_learning(rounds=2, epochs=1)
        wait_to_finish(nodes, timeout=30)
        assert sorted(ran) == sorted(n.addr for n in nodes)
        metrics = logger.get_comm_metrics()
        assert sum(m.get("async_merge", 0) for m in metrics.values()) >= 1
        assert not any(m.get("models_aggregated", 0) for m in metrics.values())
    finally:
        for n in nodes:
            n.stop()


def test_unknown_federation_mode_raises_at_start():
    Settings.FEDERATION_MODE = "barrierless"
    node = Node(learner=DummyLearner(device="cpu"))
    with pytest.raises(ValueError, match="FEDERATION_MODE"):
        node.start()
    assert not node.is_running()
