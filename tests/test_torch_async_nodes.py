"""Live port Nodes on the async control plane, on the CPU.

The counterparts of the JAX package's threaded async, elastic, Byzantine
and durability drills: flat and hierarchical federations converge under
chaos; a dead regional and a dead root fail over; a joiner bootstraps and
a leaver hands off; an equivocating attacker is quarantined through the
eviction path; a killed node resumes from its journal (memory transport
and real gRPC sockets: its first push accepted, a pre-crash duplicate
dropped); garbage control frames are dropped without killing the node;
secure aggregation and topk8 abort an async experiment loudly; and the
sync plane's add_model screens contributions under ``BYZ_SCREEN``.

Nodes hold ``DummyLearner``s (``{"w": [4]}``, +1 a local update), so a
converged fleet ends on equal params; one federation of MLP
``TorchLearner``s converges on the synthetic MNIST task. Each test runs
under a SIGALRM deadline.
"""

import signal
import threading
import time

import numpy as np
import pytest
import torch

from p2pfl_tpu_torch.communication import ici
from p2pfl_tpu_torch.communication.faults import (
    ByzantineSpec,
    CrashSpec,
    EdgeFault,
    FaultPlan,
    RestartSpec,
    hard_crash,
    install_fault_plan,
    remove_fault_plan,
)
from p2pfl_tpu_torch.communication.memory import MemoryRegistry
from p2pfl_tpu_torch.federation.buffer import BufferedAggregator
from p2pfl_tpu_torch.federation.defense import ByzantineDefense
from p2pfl_tpu_torch.federation.durability import NodeJournal
from p2pfl_tpu_torch.learning.aggregators.fedavg import FedAvg
from p2pfl_tpu_torch.learning.dataset import FederatedDataset
from p2pfl_tpu_torch.learning.learner import DummyLearner, TorchLearner
from p2pfl_tpu_torch.learning.weights import ModelUpdate
from p2pfl_tpu_torch.management.logger import logger
from p2pfl_tpu_torch.models.vision import mlp
from p2pfl_tpu_torch.node import Node, stop_leaked_nodes
from p2pfl_tpu_torch.ops.tree import tree_items
from p2pfl_tpu_torch.settings import Settings, set_test_settings
from p2pfl_tpu_torch.utils import full_connection, wait_convergence, wait_to_finish

torch.set_num_threads(2)
DEADLINE_S = 150
#: converged DummyLearner fleets end on one global (the JAX suite's bound)
ATOL = 1e-5
#: MLP survivors of a sync round repaired after a mid-round eviction
SYNC_REPAIR_ATOL = 1e-2


@pytest.fixture(autouse=True)
def _deadline():
    if threading.current_thread() is not threading.main_thread():
        yield
        return

    def _expired(signum, frame):
        raise TimeoutError(f"test exceeded its {DEADLINE_S}s deadline")

    prev = signal.signal(signal.SIGALRM, _expired)
    signal.alarm(DEADLINE_S)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, prev)


@pytest.fixture(autouse=True)
def _env():
    set_test_settings()
    logger.set_level("INFO")
    logger.reset_comm_metrics()
    MemoryRegistry.reset()
    ici.ShardPlaneRegistry.reset()
    yield
    stop_leaked_nodes()
    for name, value in (("FEDERATION_MODE", "sync"), ("HIER_CLUSTER_SIZE", 0), ("BYZ_SCREEN", False),
                        ("ASYNC_ROBUST_AGG", "fedavg"), ("BYZ_SUSPICION_BETA", 0.5),
                        ("SECURE_AGGREGATION", False), ("WIRE_COMPRESSION", "none"), ("WEIGHTS_PLANE", "bytes")):
        setattr(Settings, name, value)
    MemoryRegistry.reset()
    ici.ShardPlaneRegistry.reset()


def _metric(name: str) -> float:
    return sum(d.get(name, 0.0) for d in logger.get_comm_metrics().values())


def _pace(seconds: float):
    """A stage hook pacing local updates so faults land mid-run."""

    def hook(node, stage_name):
        if stage_name == "AsyncTrainStage":
            time.sleep(seconds)

    return hook


def _nodes(n: int, prefix: str = "node", protocol=None):
    nodes = [
        Node(learner=DummyLearner(value=float(i), device="cpu"),
             **({"protocol": protocol("127.0.0.1:0")} if protocol else {"address": f"{prefix}-{i}"}))
        for i in range(n)
    ]
    for node in nodes:
        node.start()
    for node in nodes:
        full_connection(node, nodes)
    wait_convergence(nodes, n - 1, only_direct=True, wait=10)
    return nodes


def _stop(nodes):
    for n in nodes:
        n.stop()


def _assert_one_global(nodes, atol: float = ATOL):
    params = [n.learner.get_parameters()["w"].numpy() for n in nodes]
    assert np.all(np.isfinite(params[0]))
    for p in params[1:]:
        np.testing.assert_allclose(p, params[0], atol=atol)


def _async(k: int = 3, cluster: int = 0):
    Settings.FEDERATION_MODE = "async"
    Settings.FEDBUFF_K = k
    Settings.HIER_CLUSTER_SIZE = cluster


def test_flat_async_federation_of_mlp_learners_converges():
    """4 MLP TorchLearners, flat FedBuff, 3 local updates each: every node
    ends on the last minted global, which classifies the synthetic task."""
    _async(k=3)
    data = FederatedDataset.synthetic_mnist(n_train=2048, n_test=256)
    nodes = [Node(learner=TorchLearner(mlp(seed=i, device="cpu"), data.partition(i, 4), batch_size=64, seed=i),
                  address=f"mlp-{i}") for i in range(4)]
    for n in nodes:
        n.start()
    for n in nodes:
        full_connection(n, nodes)
    wait_convergence(nodes, 3, only_direct=True, wait=10)
    try:
        nodes[0].set_start_learning(rounds=3, epochs=1)
        wait_to_finish(nodes, timeout=90)
        assert _metric("async_merge") >= 3 and _metric("async_model_adopt") >= 3
        leaves = [dict(tree_items(n.learner.get_parameters())) for n in nodes]
        assert all(torch.equal(leaves[0][k], other[k]) for other in leaves[1:] for k in leaves[0])
        assert min(n.learner.evaluate()["test_acc"] for n in nodes) > 0.5
    finally:
        _stop(nodes)


def test_hierarchical_federation_under_chaos():
    """6 nodes in 2 clusters under 5% drop, a slow peer and a mid-run edge
    crash: survivors finish, both tiers merge, one global."""
    _async(k=3, cluster=3)
    nodes = _nodes(6)
    victim, slow = nodes[4], nodes[5]
    plan = FaultPlan(seed=1905, default=EdgeFault(drop=0.05), slow_nodes={slow.addr: 0.2},
                     crashes={victim.addr: CrashSpec(stage="AsyncTrainStage", round_no=1)})
    install_fault_plan(nodes, plan)
    survivors = [n for n in nodes if n is not victim]
    try:
        nodes[0].set_start_learning(rounds=3, epochs=1)
        wait_to_finish(survivors, timeout=45)
        assert not victim.is_running() and _metric("fault_crash") == 1
        assert _metric("async_merge") >= 2
        _assert_one_global(survivors)
    finally:
        remove_fault_plan(nodes)
        _stop(nodes)


@pytest.mark.parametrize("who", ["regional", "root"])
def test_a_dead_aggregator_fails_over(who):
    """A dead regional's cluster re-elects its next live member and the
    root absorbs its orphans; a dead ROOT hands the fleet to the next live
    regional (root_failover). Survivors converge either way."""
    _async(k=3, cluster=3)
    nodes = _nodes(6, prefix=f"fo{who[:2]}")
    by_addr = {n.addr: n for n in nodes}
    dead = by_addr[sorted(by_addr)[3 if who == "regional" else 0]]
    install_fault_plan(nodes, FaultPlan(seed=1905, crashes={dead.addr: CrashSpec(stage="AsyncTrainStage", round_no=1)}))
    for n in nodes:
        n.stage_hooks.append(_pace(0.3))
    survivors = [n for n in nodes if n is not dead]
    try:
        survivors[0].set_start_learning(rounds=5, epochs=1)
        wait_to_finish(survivors, timeout=60)
        assert not dead.is_running() and _metric("async_merge") >= 2
        if who == "root":
            assert _metric("root_failover") >= 1 and _metric("role_changed") >= 1
        _assert_one_global(survivors)
    finally:
        remove_fault_plan(nodes)
        _stop(nodes)


def test_join_mid_experiment_and_graceful_leave():
    """A joiner bootstraps from the running fleet's global and ends on the
    final one; a member that leaves gracefully hands off, stays up, and the
    fleet completes around the hole."""
    _async(k=3)
    nodes = _nodes(4, prefix="jl-a")
    for n in nodes:
        n.stage_hooks.append(_pace(0.3))
    joiner = Node(learner=DummyLearner(value=99.0, device="cpu"), address="jl-z-joiner")
    joiner.start()
    leaver = nodes[2]
    try:
        nodes[0].set_start_learning(rounds=8, epochs=1)
        time.sleep(1.0)
        full_connection(joiner, nodes)
        wait_convergence([joiner], 4, only_direct=True, wait=10)
        joiner.join_async_experiment(rounds=2, epochs=1)
        time.sleep(0.3)
        leaver.request_async_leave()
        wait_to_finish(nodes + [joiner], timeout=60)
        assert _metric("async_join") == 1 and _metric("async_pull_served") >= 1
        assert _metric("async_left") == 1 and _metric("membership_changed") >= 1
        assert leaver.is_running() and leaver.state.round is None
        _assert_one_global([n for n in nodes if n is not leaver] + [joiner])
        assert float(joiner.learner.get_parameters()["w"][0]) < 50.0  # not its own init
    finally:
        _stop(nodes + [joiner])


def test_live_equivocating_attacker_is_quarantined():
    """An equivocating edge (a different lie per peer per send) against
    the trimmed mean + screen: byz_evicted fires, the eviction path
    re-derives the topology, and the survivors end on one finite global."""
    _async(k=3, cluster=3)
    Settings.ASYNC_ROBUST_AGG = "trimmed-mean"
    Settings.BYZ_SCREEN = True
    Settings.BYZ_SUSPICION_BETA = 0.8  # one clear rejection quarantines
    nodes = _nodes(6, prefix="byz")
    attacker = {n.addr: n for n in nodes}[sorted(n.addr for n in nodes)[1]]
    install_fault_plan(nodes, FaultPlan(seed=1905, byzantine={attacker.addr: ByzantineSpec(kind="equivocate", lam=40.0)}))
    survivors = [n for n in nodes if n is not attacker]
    try:
        nodes[0].set_start_learning(rounds=3, epochs=1)
        wait_to_finish(nodes, timeout=45)
        assert _metric("fault_byzantine") >= 1 and _metric("screen_reject") >= 1
        assert _metric("byz_evicted") >= 1 and _metric("membership_changed") >= 1
        _assert_one_global(survivors)
        assert float(survivors[0].learner.get_parameters()["w"].abs().max()) < 50.0
    finally:
        remove_fault_plan(nodes)
        _stop(nodes)


def test_kill_and_resurrect_drill_over_memory(tmp_path):
    """A RestartSpec hard-crashes an edge mid-run; resurrect_fn resumes it
    from its journal; it rejoins through the elastic path and the whole
    fleet, resurrectee included, converges on one global."""
    _async(k=2)
    Settings.FEDBUFF_K = 2
    jdir = str(tmp_path / "journal")
    nodes = _nodes(5, prefix="rz")
    victim = nodes[3]
    victim.enable_journal(jdir)
    revived = []

    def resurrect(addr):
        assert addr == victim.addr
        revived.append(Node.resume(jdir, learner=DummyLearner(value=0.0, device="cpu"), rounds=2))

    install_fault_plan(nodes, FaultPlan(seed=7, restarts={victim.addr: RestartSpec(round_no=2, resume_after_s=1.0)}),
                       resurrect_fn=resurrect)
    for n in nodes:
        n.stage_hooks.append(_pace(0.3))
    try:
        nodes[0].set_start_learning(rounds=6, epochs=1)
        deadline = time.monotonic() + 30
        while not revived and time.monotonic() < deadline:
            time.sleep(0.1)
        assert revived, "the resurrection timer never fired"
        survivors = [n for n in nodes if n is not victim] + revived
        wait_to_finish(survivors, timeout=60)
        assert revived[0].addr == victim.addr
        for name in ("node_resumed", "journal_recovered", "journal_restored"):
            assert _metric(name) == 1, name
        assert _metric("fault_crash") >= 1 and _metric("async_merge") >= 2
        _assert_one_global(survivors)
    finally:
        remove_fault_plan(nodes)
        _stop(nodes + revived)


def test_grpc_resume_first_push_accepted_and_precrash_duplicate_dropped(tmp_path):
    """Over real sockets: after resurrection the node's pushes are accepted
    (its sequence resumed past the journal plus the margin), while the
    pre-crash duplicate of its last update, delivered late, is deduped."""
    from p2pfl_tpu_torch.communication.grpc_transport import GrpcProtocol

    _async(k=2)
    Settings.GRPC_TIMEOUT = 5.0
    jdir = str(tmp_path / "journal")
    nodes = _nodes(3, protocol=GrpcProtocol)
    by_addr = sorted(n.addr for n in nodes)
    root = next(n for n in nodes if n.addr == by_addr[0])
    victim = next(n for n in nodes if n.addr == by_addr[-1])
    victim.enable_journal(jdir)
    for n in nodes:
        n.stage_hooks.append(_pace(0.35))
    revived = None
    try:
        root.set_start_learning(rounds=8, epochs=1)
        deadline = time.monotonic() + 25
        while _metric("journal_snapshot") < 2 and time.monotonic() < deadline:
            time.sleep(0.1)
        assert _metric("journal_snapshot") >= 2
        hard_crash(victim)
        peek = NodeJournal(jdir).recover()
        last_seq = peek.train_seq - 1
        dup_base = _metric("async_dup_drop")
        revived = Node.resume(jdir, learner=DummyLearner(value=0.0, device="cpu"), protocol=GrpcProtocol, rounds=3)
        assert revived.addr == victim.addr
        dup = ModelUpdate({"w": torch.zeros(4)}, [victim.addr], 1, xp=peek.xid,
                          version=(victim.addr, last_seq, peek.base_version))
        assert revived.protocol.send(root.addr, revived.protocol.build_weights("async_update", 0, dup),
                                     create_connection=True)
        deadline = time.monotonic() + 10
        while _metric("async_dup_drop") < dup_base + 1 and time.monotonic() < deadline:
            time.sleep(0.1)
        survivors = [n for n in nodes if n is not victim] + [revived]
        wait_to_finish(survivors, timeout=60)
        # the ONLY drop is the forged duplicate: every push after the
        # resume was accepted
        assert _metric("async_dup_drop") == dup_base + 1
        assert _metric("node_resumed") == 1 and _metric("async_merge") >= 2
        _assert_one_global(survivors)
    finally:
        _stop(nodes + ([revived] if revived is not None else []))


def test_malformed_control_frames_drop_loudly_without_killing_the_node():
    _async(k=2)
    nodes = _nodes(2, prefix="mal")
    victim, peer = nodes
    try:
        garbage = ModelUpdate(None, [peer.addr], 1, encoded=b"NOT WEIGHTS")
        for cmd in ("async_pull", "async_view"):
            assert victim.protocol._dispatch(cmd, peer.addr, 0, [], garbage).ok
        for args in ([], ["only-one"], ["\x00\xff;;;", ""]):
            assert victim.protocol._dispatch("async_view", peer.addr, 0, list(args), None).ok
        assert _metric("async_ctl_malformed") >= 2
        victim.set_start_learning(rounds=2, epochs=1)
        deadline = time.monotonic() + 10
        while victim.async_ctx is None and time.monotonic() < deadline:
            time.sleep(0.02)
        for args in ([], ["only-one"]):
            assert victim.protocol._dispatch("async_view", peer.addr, 0, list(args), None).ok
        assert victim.protocol._dispatch("async_pull", peer.addr, 0, [], garbage).ok
        # a garbage weights payload on the update verb: decode fails, dropped
        assert victim.protocol._dispatch("async_update", peer.addr, 0, [], garbage).ok
        wait_to_finish(nodes, timeout=30)
        assert _metric("async_ctl_malformed") >= 5 and all(n.is_running() for n in nodes)
        _assert_one_global(nodes, atol=1e-6)
    finally:
        _stop(nodes)


@pytest.mark.parametrize("refused", ["secure_aggregation", "topk8"])
def test_refused_compositions_abort_the_async_experiment_loudly(refused):
    _async()
    nodes = _nodes(2, prefix=f"ref{refused[:3]}")
    try:
        if refused == "topk8":
            Settings.WIRE_COMPRESSION = "topk8"
        else:
            Settings.SECURE_AGGREGATION = True
        nodes[0].set_start_learning(rounds=1, epochs=1)
        deadline = time.monotonic() + 10
        while nodes[0].learning_active() and time.monotonic() < deadline:
            time.sleep(0.05)
        assert nodes[0].state.round is None and nodes[0].is_running()
        assert _metric("async_merge") == 0
    finally:
        Settings.SECURE_AGGREGATION = False
        Settings.WIRE_COMPRESSION = "none"
        _stop(nodes)


def test_sync_add_model_screens_with_source_attribution():
    """On the parent tree BYZ_SCREEN=True left the sync aggregator
    unscreened. Now a poisoned relay indicts its DELIVERER, never the
    honest contributor named inside, and an honest model is collected."""
    Settings.BYZ_SCREEN = True
    d = ByzantineDefense("me")
    agg = FedAvg("me")
    agg.defense = d
    agg.set_screen_reference({"w": torch.ones(4)})
    agg.set_nodes_to_aggregate(["me", "honest", "attacker"])
    assert agg.add_model(ModelUpdate({"w": -torch.ones(4)}, ["honest"], 1), source="attacker") == []
    assert d.suspicion("attacker") > 0.0 and d.suspicion("honest") == 0.0
    assert agg.add_model(ModelUpdate({"w": torch.full((4,), 1.05)}, ["honest"], 1), source="honest") == ["honest"]
    # the async seam attributes to the deliverer as well
    buf = BufferedAggregator("agg", {"w": torch.ones(4)}, k=3, defense=ByzantineDefense("agg"))
    assert buf.offer(ModelUpdate({"w": -torch.ones(4)}, ["victim"], 1, version=("victim", 1, 0)),
                     screen_origin="attacker") is None
    assert buf.defense.suspicion("attacker") > 0.0 and buf.defense.suspicion("victim") == 0.0


def test_a_sync_federation_screens_a_sign_flip_attacker():
    """The screen on live sync rounds: a sign-flip attacker's models are
    rejected at every honest receiver and it is quarantined, while the
    honest nodes finish the experiment on one unpoisoned model. When the
    quarantine lands mid-round, train-set repair closes the round and a
    survivor's aggregate may or may not hold a contribution that reached
    it first: survivors then differ by up to 4.3e-3 (measured), hence
    ``SYNC_REPAIR_ATOL``; otherwise they end bit-equal."""
    Settings.BYZ_SCREEN = True
    Settings.BYZ_SUSPICION_BETA = 0.8
    Settings.TRAIN_SET_SIZE = 4
    data = FederatedDataset.synthetic_mnist(n_train=1024, n_test=64)
    nodes = [Node(learner=TorchLearner(mlp(seed=0, device="cpu"), data.partition(i, 4), batch_size=64, seed=i),
                  address=f"sy-{i}") for i in range(4)]
    for n in nodes:
        n.start()
    for n in nodes:
        full_connection(n, nodes)
    wait_convergence(nodes, 3, only_direct=True, wait=10)
    attacker = nodes[3]
    install_fault_plan(nodes, FaultPlan(seed=3, byzantine={attacker.addr: ByzantineSpec(kind="sign_flip")}))
    honest = nodes[:3]
    try:
        nodes[0].set_start_learning(rounds=2, epochs=1)
        wait_to_finish(honest, timeout=90)
        assert _metric("screen_reject") >= 1 and _metric("byz_evicted") >= 1
        leaves = [dict(tree_items(n.learner.get_parameters())) for n in honest]
        gap = max(float((leaves[0][k] - other[k]).abs().max()) for other in leaves[1:] for k in leaves[0])
        assert gap <= SYNC_REPAIR_ATOL
        # a folded sign-flipped model would wreck the global; screened, it
        # classifies as an honest fleet does
        assert min(n.learner.evaluate()["test_acc"] for n in honest) >= 0.5  # 16 test samples a node
    finally:
        remove_fault_plan(nodes)
        _stop(nodes)


def test_one_async_update_over_the_ici_plane_equals_the_byte_path():
    """The version triple and experiment id ride an ICI delivery (the
    plane dropped the triple before this slice), and the delivered params
    equal the byte path's encode → decode bit for bit (the plain exchange
    here; kernel 9 in the card test)."""
    import chip_smoke

    out = chip_smoke.async_update_through_plane("cpu")
    assert all(out["checks"].values()), out


def _upd(value: float, origin: str, seq: int = 1, base: int = 0, xp=None) -> ModelUpdate:
    return ModelUpdate({"w": torch.full((4,), value)}, [origin], 1, xp=xp, version=(origin, seq, base))


def test_stash_and_handlers_filter_other_experiments():
    """The "xp" identity, exact where both sides carry it: the early stash
    keeps only this experiment's entries (an identity-less one falls back
    to the epoch and TTL heuristics), and a context drops a previous
    experiment's async_update and async_model on the direct path."""
    from p2pfl_tpu_torch.federation.routing import TierRouter
    from p2pfl_tpu_torch.federation.workflow import AsyncContext

    node = Node(learner=DummyLearner(device="cpu"), address="xp-node")
    node.state.experiment_xid = "this-exp"
    for xp in ("previous-exp", "this-exp", None):
        node.stash_async_update(_upd(1.0, "p", xp=xp), "p")
    node.state.experiment_epoch += 1  # invalidates only the heuristic path
    assert [u.xp for u, _src in node.take_async_stash()] == ["this-exp"]
    ctx = AsyncContext(node, TierRouter([node.addr, "zz-peer"], 0), {"w": torch.zeros(4)}, xid="exp2")
    assert ctx.handle_update(_upd(9.0, "ghost", xp="exp1")) == [] and ctx.gbuf.pending() == 0
    assert ctx.handle_model(_upd(9.0, "ghost", 5, 5, xp="exp1"), "ghost") == [] and ctx.global_version == 0
    assert _metric("async_xp_filtered") >= 2
    ctx.handle_update(_upd(1.0, "peer", xp="exp2"))
    assert ctx.gbuf.pending() == 1


def test_view_merge_restores_the_fleets_chunking_and_roots_mint_monotonically():
    """A joiner's live view lacks the survivors' holes: merging the pull
    server's (members, dead) view restores the shared chunking. A
    successor root seeded below the fleet's version jumps past the base
    versions it observes, so it never mints a version already adopted."""
    from p2pfl_tpu_torch.federation.routing import TierRouter
    from p2pfl_tpu_torch.federation.workflow import AsyncContext

    node = Node(learner=DummyLearner(device="cpu"), address="vm-node")
    members = ["a", "b", "c", "d", "e", "f"]
    survivor = TierRouter(members + [node.addr], 3, dead={"c"})
    ctx = AsyncContext(node, TierRouter([m for m in members if m != "c"] + [node.addr], 3), {"w": torch.zeros(4)})
    assert ctx.router.topo.clusters != survivor.topo.clusters
    ctx.merge_view(members + [node.addr], ["c"])
    assert ctx.router.topo.clusters == survivor.topo.clusters and ctx.router.roles() == survivor.roles()
    assert ctx.merge_view(members + [node.addr], ["c"]) == []
    buf = BufferedAggregator("succ", {"w": torch.zeros(4)}, k=2, alpha=0.0)
    buf.offer(_upd(1.0, "a", base=5))
    assert buf.version == 5
    assert buf.offer(_upd(2.0, "b", base=5)).version == 6


def test_simulation_learn_drives_the_async_plane():
    """``Simulation.learn`` under FEDERATION_MODE="async": the same call
    runs the async workflow on every node (rounds = local updates)."""
    from p2pfl_tpu_torch.learning.dataset import FederatedDataset
    from p2pfl_tpu_torch.simulation import SimulatedAsyncFleet, Simulation

    assert SimulatedAsyncFleet.__module__ == "p2pfl_tpu_torch.federation.simfleet"
    _async(k=2)
    sim = Simulation(3, lambda i, shard: DummyLearner(value=float(i), device="cpu"),
                     FederatedDataset.synthetic_mnist(n_train=96, n_test=16), topology="full").start()
    try:
        sim.learn(rounds=2, epochs=1, timeout=60)
        assert _metric("async_merge") >= 1
        _assert_one_global(sim.nodes)
    finally:
        sim.stop()
