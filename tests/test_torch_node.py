"""The port's gossip Node path against the JAX package: the MLP, one
epoch of training, FedAvg, a 2-node federation over the in-memory
transport, and the reference scenarios of ``tests/test_node.py``
(convergence, dummy learners, interrupt, a node dying mid-learning).

Inputs come from numpy seeds; JAX init params are loaded through
``p2pfl_tpu_torch.convert``. The JAX side runs its staged round
(``ROUND_FUSED=False``), the port's only path. Each tolerance is stated
where it is used.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from p2pfl_tpu.communication.memory import MemoryRegistry as JaxMemoryRegistry
from p2pfl_tpu.learning import learner as jl
from p2pfl_tpu.learning.aggregators.fedavg import FedAvg as JaxFedAvg
from p2pfl_tpu.learning.dataset import FederatedDataset as JaxDataset
from p2pfl_tpu.learning.learner import JaxLearner
from p2pfl_tpu.learning.weights import ModelUpdate as JaxModelUpdate
from p2pfl_tpu.models.base import FlaxModel
from p2pfl_tpu.models.vision import MLP as JaxMLP
from p2pfl_tpu.node import Node as JaxNode
from p2pfl_tpu.settings import Settings as JaxSettings
from p2pfl_tpu.utils import wait_convergence as jax_wait_convergence
from p2pfl_tpu.utils import wait_to_finish as jax_wait_to_finish
from p2pfl_tpu_torch.communication import ici
from p2pfl_tpu_torch.communication.memory import MemoryRegistry
from p2pfl_tpu_torch.convert import params_from_jax, params_to_jax
from p2pfl_tpu_torch.learning import learner as tl
from p2pfl_tpu_torch.learning.aggregators.fedavg import FedAvg
from p2pfl_tpu_torch.learning.dataset import FederatedDataset
from p2pfl_tpu_torch.learning.learner import DummyLearner, TorchLearner
from p2pfl_tpu_torch.learning.weights import ModelUpdate
from p2pfl_tpu_torch.management.logger import logger
from p2pfl_tpu_torch.models.base import TorchModel
from p2pfl_tpu_torch.models.vision import MLP, mlp
from p2pfl_tpu_torch.node import Node, stop_leaked_nodes
from p2pfl_tpu_torch.settings import Settings, set_test_settings
from p2pfl_tpu_torch.utils import (
    check_equal_models,
    connect_line,
    full_connection,
    wait_convergence,
    wait_to_finish,
)

torch.set_num_threads(2)

LR = 1e-3  # the learners' Adam rate (JaxLearner's and TorchLearner's default)
DTYPES = {"bf16": (jnp.bfloat16, torch.bfloat16), "f32": (jnp.float32, torch.float32)}


@pytest.fixture(autouse=True)
def _port_env():
    set_test_settings()
    logger.set_level("INFO")
    MemoryRegistry.reset()
    JaxMemoryRegistry.reset()
    ici.ShardPlaneRegistry.reset()
    ici.reset_ici_stats()
    yield
    stop_leaked_nodes()
    MemoryRegistry.reset()
    JaxMemoryRegistry.reset()
    ici.ShardPlaneRegistry.reset()


def _jax_mlp(seed: int, dtype=jnp.bfloat16) -> FlaxModel:
    return FlaxModel.create(JaxMLP(dtype=dtype), (28, 28, 1), seed=seed)


def _port_mlp(jax_model: FlaxModel, dtype=torch.bfloat16) -> TorchModel:
    params = params_from_jax(jax.tree.map(np.asarray, jax_model.params), device="cpu")
    return TorchModel(MLP(dtype=dtype), params, (28, 28, 1))


def _leaf_pairs(jax_tree, port_tree):
    ported = params_to_jax(port_tree)
    return [
        (np.asarray(jax_tree[layer][name], np.float32), ported[layer][name].astype(np.float32))
        for layer in sorted(jax_tree) for name in sorted(jax_tree[layer])
    ]


def _batch(n=64, seed=0):
    rng = np.random.default_rng(seed)
    return rng.random((n, 28, 28, 1), dtype=np.float32), rng.integers(0, 10, n).astype(np.int32)


# ---- the MLP, its gradients and one epoch ----


def test_mlp_init_tree_matches_flax_layout():
    """The port's own init has flax's leaf names, layout and dtypes."""
    jtree = jax.tree.map(np.asarray, _jax_mlp(0).params)
    ttree = params_to_jax(mlp(seed=0, device="cpu").params)
    assert jax.tree.structure(jtree) == jax.tree.structure(ttree)
    for a, b in zip(jax.tree.leaves(jtree), jax.tree.leaves(ttree)):
        assert a.shape == b.shape and a.dtype == b.dtype


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_mlp_logits_and_grads_match_flax(dtype):
    """Same JAX init, same batch. bf16 compute: logits within one bf16
    ulp (2^-7 of the value; measured bit-equal); gradients within 2^-7 of
    the value plus 2^-6 of the leaf's largest element — the bias
    gradients are batch sums in bf16 that round in another order, off by
    up to one ulp at the leaf's largest element (the kernels' gradients
    are bit-equal). fp32 compute: 1e-5 on logits and 1e-6 on gradients
    (fp32 summation order)."""
    jdt, tdt = DTYPES[dtype]
    jm = _jax_mlp(0, jdt)
    tm = _port_mlp(jm, tdt)
    x, y = _batch()
    jlog = np.asarray(jm.module.apply({"params": jm.params}, jnp.asarray(x)))
    tlog = tm.module(tm.params, torch.from_numpy(x)).numpy()
    assert tlog.dtype == np.float32

    def jloss(p):
        logits = jm.module.apply({"params": p}, jnp.asarray(x))
        return optax.softmax_cross_entropy_with_integer_labels(logits, jnp.asarray(y)).mean()

    jgrads = jax.tree.map(np.asarray, jax.grad(jloss)(jm.params))
    _, tgrads = tl.loss_and_grads(tm.params, tm.module, torch.from_numpy(x), torch.from_numpy(y))
    if dtype == "bf16":
        np.testing.assert_allclose(tlog, jlog, rtol=2.0 ** -7, atol=1e-7)
        for a, b in _leaf_pairs(jgrads, tgrads):
            np.testing.assert_allclose(b, a, rtol=2.0 ** -7, atol=2.0 ** -6 * np.abs(a).max())
    else:
        np.testing.assert_allclose(tlog, jlog, atol=1e-5, rtol=1e-5)
        for a, b in _leaf_pairs(jgrads, tgrads):
            np.testing.assert_allclose(b, a, atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_train_epoch_matches_jax(dtype):
    """One epoch (8 Adam steps) from the same init on the same batches.
    The mean loss agrees to 1e-5 relative in fp32 and 1e-3 in bf16. Adam
    normalizes each step, so an element whose gradient sits at rounding
    noise can move by up to about lr per step either way: every element
    within 2·lr·steps, and the mean difference far below one step
    (measured fp32 2.6e-6 max / 4e-9 mean; bf16 2.5e-3 max / 2e-5 mean)."""
    jdt, tdt = DTYPES[dtype]
    jm = _jax_mlp(1, jdt)
    tm = _port_mlp(jm, tdt)
    data = JaxDataset.synthetic_mnist(n_train=512, n_test=64, seed=0)
    xs, ys = data.epoch_batches(64, np.random.default_rng(3))
    tx = jl.adam(LR)
    jparams, _, jloss = jl.train_epoch(jm.params, tx.init(jm.params), jnp.asarray(xs), jnp.asarray(ys), jm.module, tx)
    ttx = tl.adam(LR)
    tparams, _, tloss = tl.train_epoch(
        tm.params, ttx.init(tm.params), torch.from_numpy(xs), torch.from_numpy(ys), tm.module, ttx
    )
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5 if dtype == "f32" else 1e-3)
    pairs = _leaf_pairs(jax.tree.map(np.asarray, jparams), tparams)
    steps = xs.shape[0]
    assert max(np.abs(a - b).max() for a, b in pairs) <= 2 * LR * steps
    mean = np.mean([np.abs(a - b).mean() for a, b in pairs])
    assert mean <= (1e-6 if dtype == "f32" else 1e-4), mean


def test_train_epoch_writes_no_tensor_in_place():
    """Training returns new tensors: the input params and Adam state are
    untouched (the zero-copy weights paths hand these tensors to peers)."""
    tm = mlp(seed=0, device="cpu")
    tx = tl.adam(LR)
    state = tx.init(tm.params)
    before = {k: v.clone() for k, v in tm.params["Dense_0"].items()}
    xs, ys = _batch(32)
    new, new_state, _ = tl.train_epoch(
        tm.params, state, torch.from_numpy(xs).reshape(2, 16, 28, 28, 1),
        torch.from_numpy(ys).reshape(2, 16), tm.module, tx,
    )
    for k, v in before.items():
        assert torch.equal(tm.params["Dense_0"][k], v)
        assert new["Dense_0"][k].data_ptr() != tm.params["Dense_0"][k].data_ptr()
    assert state.count == 0 and all(float(m.abs().sum()) == 0 for m in state.mu["Dense_0"].values())


def test_epoch_batches_and_data_bitwise():
    jd = JaxDataset.synthetic_mnist(n_train=300, n_test=50, seed=5, modes=2)
    td = FederatedDataset.synthetic_mnist(n_train=300, n_test=50, seed=5, modes=2)
    for a, b in ((jd.x_train, td.x_train), (jd.y_train, td.y_train), (jd.x_test, td.x_test)):
        np.testing.assert_array_equal(a, b)
    jx, jy = jd.partition(1, 3).epoch_batches(32, np.random.default_rng(7))
    tx_, ty = td.partition(1, 3).epoch_batches(32, np.random.default_rng(7))
    np.testing.assert_array_equal(jx, tx_)
    np.testing.assert_array_equal(jy, ty)
    np.testing.assert_array_equal(jd.test_arrays()[1], td.test_arrays()[1])


def test_fedavg_matches_jax():
    """FedAvg of the same three contributions, unequal sample counts:
    ≤1e-6 relative (fp32 sums in another order)."""
    rng = np.random.default_rng(11)
    trees = [
        {"a": {"kernel": rng.normal(size=(6, 5)).astype(np.float32),
               "bias": rng.normal(size=(5,)).astype(np.float32)}}
        for _ in range(3)
    ]
    samples = [10, 30, 7]
    names = ["n1", "n2", "n3"]
    jres = JaxFedAvg("j").aggregate(
        [JaxModelUpdate(jax.tree.map(jnp.asarray, t), [n], s) for t, n, s in zip(trees, names, samples)]
    )
    tres = FedAvg("t").aggregate(
        [ModelUpdate(params_from_jax(t, device="cpu"), [n], s) for t, n, s in zip(trees, names, samples)]
    )
    assert tres.contributors == sorted(names) and tres.num_samples == sum(samples)
    for a, b in _leaf_pairs(jax.tree.map(np.asarray, jres.params), tres.params):
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-7)


def test_learner_refuses_a_slice_of_several_slots():
    from p2pfl_tpu_torch.parallel.mesh import node_slices, submesh_federation_mesh

    slices = node_slices(submesh_federation_mesh(2, model_parallel=2, devices=["cpu"] * 4))
    with pytest.raises(NotImplementedError, match="A5"):
        TorchLearner(mlp(seed=0, device="cpu"), FederatedDataset.synthetic_mnist(n_train=64, n_test=16),
                     mesh=slices[0])


# ---- federations ----


def _jax_fleet_params(n, rounds, dtype, n_train=512, **learner_kw):
    """Run the JAX staged federation; return each node's final params."""
    JaxSettings.ROUND_FUSED = False
    data = JaxDataset.synthetic_mnist(n_train=n_train, n_test=128, seed=0)
    nodes = [
        JaxNode(learner=JaxLearner(_jax_mlp(i, dtype), data.partition(i, n), batch_size=64, seed=i, **learner_kw))
        for i in range(n)
    ]
    try:
        for node in nodes:
            node.start()
        nodes[0].connect(nodes[1].addr)
        jax_wait_convergence(nodes, n - 1, only_direct=True)
        nodes[0].set_start_learning(rounds=rounds, epochs=1)
        jax_wait_to_finish(nodes, timeout=60)
        return [jax.tree.map(np.asarray, node.learner.get_parameters()) for node in nodes]
    finally:
        for node in nodes:
            node.stop()


def _port_fleet_params(n, rounds, dtype, n_train=512, mesh_slices=None):
    jdt, tdt = DTYPES[dtype]
    data = FederatedDataset.synthetic_mnist(n_train=n_train, n_test=128, seed=0)
    nodes = [
        Node(learner=TorchLearner(
            _port_mlp(_jax_mlp(i, jdt), tdt), data.partition(i, n), batch_size=64, seed=i,
            mesh=None if mesh_slices is None else mesh_slices[i],
        ))
        for i in range(n)
    ]
    try:
        for node in nodes:
            node.start()
        nodes[0].connect(nodes[1].addr)
        wait_convergence(nodes, n - 1, only_direct=True)
        nodes[0].set_start_learning(rounds=rounds, epochs=1)
        wait_to_finish(nodes, timeout=60)
        return [node.learner.get_parameters() for node in nodes]
    finally:
        for node in nodes:
            node.stop()


def assert_fleet_parity(jax_params, port_params, dtype, steps):
    """Within the port's run every node holds the same model (≤1e-5, the
    JAX package's per-run statement); against the JAX federation node by
    node, every element within 2·lr·steps (Adam, as in the epoch test)
    and the mean difference under 1e-6 (fp32) or 5e-4 (bf16); measured
    fp32 2.2e-4 max / 1e-8 mean, bf16 5.8e-3 / 9e-5 over 2 rounds."""
    first = params_to_jax(port_params[0])
    for other in port_params[1:]:
        for a, b in zip(jax.tree.leaves(first), jax.tree.leaves(params_to_jax(other))):
            np.testing.assert_allclose(b, a, atol=1e-5, rtol=0)
    for jp, tp in zip(jax_params, port_params):
        pairs = _leaf_pairs(jp, tp)
        assert max(np.abs(a - b).max() for a, b in pairs) <= 2 * LR * steps
        mean = np.mean([np.abs(a - b).mean() for a, b in pairs])
        assert mean <= (1e-6 if dtype == "f32" else 5e-4), mean


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_two_node_memory_federation_matches_jax(dtype):
    """2 nodes, 2 rounds, 1 epoch of 4 steps each, FedAvg of two terms
    (order-free): the port's final params against the JAX federation's."""
    jax_params = _jax_fleet_params(2, 2, DTYPES[dtype][0])
    port_params = _port_fleet_params(2, 2, dtype)
    assert_fleet_parity(jax_params, port_params, dtype, steps=2 * 4)


# ---- the reference scenarios (tests/test_node.py) ----


def _mk_ml_nodes(n, n_train=512, n_test=128):
    full = FederatedDataset.synthetic_mnist(n_train=n_train, n_test=n_test)
    nodes = [
        Node(learner=TorchLearner(mlp(seed=i, device="cpu"), full.partition(i, n), batch_size=64))
        for i in range(n)
    ]
    for node in nodes:
        node.start()
    return nodes


def _stop_all(nodes):
    for n in nodes:
        n.stop()


@pytest.mark.parametrize("rounds", [1, 2])
def test_convergence_two_nodes(rounds):
    """``test_node.py::test_convergence_two_nodes``: epochs=0 rounds end
    with equal models (the reference's 1e-1 check)."""
    nodes = _mk_ml_nodes(2)
    nodes[0].connect(nodes[1].addr)
    wait_convergence(nodes, 1, only_direct=True)
    nodes[0].set_start_learning(rounds=rounds, epochs=0)
    wait_to_finish(nodes, timeout=60)
    check_equal_models(nodes)
    _stop_all(nodes)


def test_convergence_four_nodes_line_with_training():
    """4 nodes on a line, one epoch of real training per round: the
    fleet ends on equal models (the reference's 1e-1 check: under load a
    slow node can close a round by timeout with partial coverage) and
    learned (accuracy over 0.8)."""
    nodes = _mk_ml_nodes(4, n_train=1024)
    connect_line(nodes)
    wait_convergence(nodes, 3, only_direct=False)
    nodes[0].set_start_learning(rounds=2, epochs=1)
    wait_to_finish(nodes, timeout=60)
    check_equal_models(nodes)
    assert nodes[0].learner.evaluate()["test_acc"] > 0.8
    _stop_all(nodes)


def test_federation_records_stages_spans_dispatches_and_metrics():
    """What a round leaves behind: the stage registry's names, one stage
    span per FSM stage and node, receive spans parented to the sender's
    wire context, dispatch counts per site, train-loss and test metrics."""
    from p2pfl_tpu_torch.management.profiling import get_dispatch_counts, reset_dispatch_counts
    from p2pfl_tpu_torch.management.telemetry import telemetry
    from p2pfl_tpu_torch.stages import learning_stages as ls
    from p2pfl_tpu_torch.stages.stage_factory import StageFactory

    assert StageFactory.get_stage("TrainStage") is ls.TrainStage
    with pytest.raises(KeyError):
        StageFactory.get_stage("NoSuchStage")
    # the counters are process-wide: no learning thread of an earlier
    # test may still be unwinding into them
    import threading

    deadline = time.monotonic() + 10
    while any(t.name.startswith("learning-") for t in threading.enumerate()) and time.monotonic() < deadline:
        time.sleep(0.05)
    reset_dispatch_counts()
    telemetry.reset_spans()
    nodes = _mk_ml_nodes(2)
    nodes[0].connect(nodes[1].addr)
    wait_convergence(nodes, 1, only_direct=True)
    nodes[0].set_start_learning(rounds=1, epochs=1)
    wait_to_finish(nodes, timeout=60)
    counts = get_dispatch_counts()
    # each node: one fused round (the eval before training and the epoch
    # in one call, Settings.ROUND_FUSED) and a final eval
    assert counts["fused_round"] == 2 and counts["eval_step"] == 2 and counts.get("aggregate", 0) >= 1
    assert "train_epoch" not in counts
    spans = telemetry.spans()
    for node in nodes:
        stages = {s.name for s in spans if s.node == node.addr and s.kind == "stage"}
        assert {"StartLearningStage", "VoteTrainSetStage", "TrainStage", "GossipModelStage",
                "RoundFinishedStage", "gossip_partials", "aggregation_wait"} <= stages
    ids = {s.span_id for s in spans}
    recvs = [s for s in spans if s.name == "recv:add_model"]
    assert recvs and all(s.parent_id in ids for s in recvs)
    exp = nodes[0].experiment_name
    for node in nodes:
        assert logger.get_global_logs()[exp][node.addr]["test_acc"]
        assert any(node.addr in per_round for per_round in logger.get_local_logs()[exp].values())
    _stop_all(nodes)


def test_dummy_learner_federation():
    """FSM correctness without ML: dummy learners converge to one value."""
    nodes = [Node(learner=DummyLearner(value=float(i), device="cpu")) for i in range(3)]
    for n in nodes:
        n.start()
    for n in nodes:
        full_connection(n, nodes)
    wait_convergence(nodes, 2, only_direct=True)
    nodes[0].set_start_learning(rounds=1, epochs=1)
    wait_to_finish(nodes, timeout=30)
    check_equal_models(nodes, atol=1e-6)
    # init from node 0 (value 0), one fit (+1) each, FedAvg of equal models
    assert float(nodes[1].learner.get_parameters()["w"][0]) == 1.0
    _stop_all(nodes)


def test_interrupt_learning():
    nodes = _mk_ml_nodes(2)
    nodes[0].connect(nodes[1].addr)
    wait_convergence(nodes, 1, only_direct=True)
    nodes[0].set_start_learning(rounds=10, epochs=1)
    time.sleep(0.5)
    nodes[0].set_stop_learning()
    deadline = time.monotonic() + 15
    while time.monotonic() < deadline:
        if all(n.state.round is None for n in nodes):
            break
        time.sleep(0.1)
    assert all(n.state.round is None for n in nodes)
    _stop_all(nodes)


def _hard_crash(node) -> None:
    """Die like a killed process (``communication/faults.py::hard_crash``
    of the JAX package): no goodbyes, peers find out by silence."""
    node._interrupt.set()
    node.learner.interrupt_fit()
    node.protocol.crash()
    node.protocol.heartbeater.stop()
    node.protocol.gossiper.stop()
    node._running = False


def test_node_down_on_learning():
    """Kill a node mid-learning; the rest still finish. The port's round
    outruns a fixed sleep, so the victim dies as it enters TrainStage of
    round 0: its contribution never comes, and the survivors finish
    through heartbeat eviction and train-set repair (under load a
    survivor may instead close a round by AGGREGATION_TIMEOUT with partial
    coverage, the reference's graceful degradation, so finishing is the
    contract, as in ``tests/test_node.py``)."""
    nodes = _mk_ml_nodes(4)
    for n in nodes:
        full_connection(n, nodes)
    wait_convergence(nodes, 3, only_direct=True)
    victim = nodes[-1]
    victim.stage_hooks.append(lambda node, stage: _hard_crash(node) if stage == "TrainStage" else None)
    nodes[0].set_start_learning(rounds=2, epochs=1)
    wait_to_finish(nodes[:-1], timeout=60)
    assert not victim.is_running()
    assert all(n.state.experiment_epoch == 1 for n in nodes[:-1])
    _stop_all(nodes[:-1])


def test_stale_and_future_round_add_model_gates():
    """A previous round's aggregate and a future round's individual model
    must not enter the current window; a future full aggregate may."""
    from p2pfl_tpu_torch.commands.learning import AddModelCommand

    learner = TorchLearner(mlp(seed=0, device="cpu"), FederatedDataset.synthetic_mnist(n_train=64, n_test=16))
    node = Node(learner=learner)
    node.start()
    try:
        node.state.model_initialized_event.set()
        node.state.round = 2
        node.state.train_set = [node.addr, "peer"]
        node.aggregator.set_nodes_to_aggregate([node.addr, "peer"])
        cmd = AddModelCommand(node)
        cmd.execute("peer", 1, update=ModelUpdate(learner.get_parameters(), [node.addr, "peer"], 10))
        cmd.execute("peer", 3, update=ModelUpdate(learner.get_parameters(), ["peer"], 10))
        assert node.aggregator.get_aggregated_models() == []
        cmd.execute("peer", 3, update=ModelUpdate(learner.get_parameters(), [node.addr, "peer"], 10))
        assert node.aggregator.get_aggregated_models() == sorted([node.addr, "peer"])
    finally:
        node.stop()


def test_unported_settings_raise_at_start():
    """The DCN plane is still refused at ``Node.start``; secure aggregation
    and the int8/topk8 codecs on either plane now start. Secure
    aggregation with a lossy codec aborts the experiment in
    ``StartLearningStage`` with the JAX package's message, before any
    training."""
    node = Node(learner=DummyLearner(device="cpu"))
    Settings.WEIGHTS_PLANE = "dcn"
    try:
        with pytest.raises(ValueError, match="only bytes.*item 9"):
            node.start()
    finally:
        Settings.WEIGHTS_PLANE = "bytes"
    assert not node.is_running()
    for knob, value in (("SECURE_AGGREGATION", True), ("MEMORY_WIRE_CODEC", True)):
        setattr(Settings, knob, value)
        try:
            node.start()
            assert node.is_running()
        finally:
            node.stop()
            setattr(Settings, knob, False)
    for plane, mode in (("ici", "topk8"), ("ici", "int8"), ("bytes", "int8"), ("bytes", "topk8")):
        Settings.WEIGHTS_PLANE, Settings.WIRE_COMPRESSION = plane, mode
        n = Node(learner=DummyLearner(device="cpu"))
        try:
            n.start()
            assert n.is_running()
        finally:
            n.stop()
            Settings.WEIGHTS_PLANE, Settings.WIRE_COMPRESSION = "bytes", "none"
    # secure aggregation with a lossy codec: the experiment aborts at start
    errors: list = []
    Settings.SECURE_AGGREGATION, Settings.WIRE_COMPRESSION = True, "int8"
    n = Node(learner=DummyLearner(device="cpu"))
    prev_error = logger.error
    logger.error = lambda node, msg: errors.append(msg)
    try:
        n.start()
        n.set_start_learning(rounds=1, epochs=1)
        deadline = time.monotonic() + 10
        while n.learning_active() and time.monotonic() < deadline:
            time.sleep(0.05)
        assert not n.learning_active() and n.state.round is None
        assert any("SECURE_AGGREGATION is incompatible with WIRE_COMPRESSION='int8'" in e for e in errors)
    finally:
        logger.error = prev_error
        n.stop()
        Settings.SECURE_AGGREGATION, Settings.WIRE_COMPRESSION = False, "none"


def test_example_runs_on_the_cpu_and_refuses_without_a_card(monkeypatch):
    """The acceptance drive: the example's path on the CPU with the ICI
    plane (the plain version of kernel 9): real transfers, no fallback,
    no alignment fix-up, no failed transfer."""
    from p2pfl_tpu_torch.examples import mnist as example

    errors: list = []
    monkeypatch.setattr(logger, "error", lambda node, msg: errors.append(msg))
    out = example.run(nodes=2, rounds=1, samples=512, batch_size=64, device="cpu", weights_plane="ici")
    assert all(m["test_acc"] > 0.5 for m in out["metrics"])
    assert len(out["round_s"]) == 1 and out["elapsed_s"] > 0
    stats = ici.ici_stats()
    assert stats["shard_sends"] > 0 and stats["bytes_moved"] > 0
    assert stats["fallback_bytes"] == 0 and stats["align_violations"] == 0
    assert not [m for m in errors if m.startswith("ICI shard transfer")]
    if not torch.cuda.is_available():
        from p2pfl_tpu_torch import DeviceUnavailableError

        with pytest.raises(DeviceUnavailableError):
            example.run(nodes=2, rounds=1, device=None)
