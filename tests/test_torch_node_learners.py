"""The gossip Node's learners and strategies on the port, against the JAX
package: ``LoRALearner``, ``TorchLearner``'s FedProx and DP-SGD knobs and
the accountant, the robust aggregator classes and FedOpt, the CNN, the
wrong-model scenario, ``Simulation`` and the gossip ``lora_ft``.

Inputs come from numpy seeds or JAX inits loaded through
``p2pfl_tpu_torch.convert``; every tolerance is stated where it is used.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2pfl_tpu.communication.memory import MemoryRegistry as JaxMemoryRegistry
from p2pfl_tpu.learning import aggregators as jaggs
from p2pfl_tpu.learning.dataset import FederatedDataset as JaxDataset
from p2pfl_tpu.learning.learner import JaxLearner
from p2pfl_tpu.learning.lora import LoRALearner as JaxLoRALearner
from p2pfl_tpu.learning.weights import ModelUpdate as JaxModelUpdate
from p2pfl_tpu.models import transformer as jtr
from p2pfl_tpu.models.base import FlaxModel
from p2pfl_tpu.models.vision import CNN as JaxCNN
from p2pfl_tpu.models.vision import MLP as JaxMLP
from p2pfl_tpu.models.vision import cnn as jax_cnn
from p2pfl_tpu_torch import DeviceUnavailableError
from p2pfl_tpu_torch.communication.memory import MemoryRegistry
from p2pfl_tpu_torch.convert import params_from_jax, params_to_jax
from p2pfl_tpu_torch.learning import aggregators as taggs
from p2pfl_tpu_torch.learning.dataset import FederatedDataset
from p2pfl_tpu_torch.learning.learner import TorchLearner
from p2pfl_tpu_torch.learning.lora import LoRALearner
from p2pfl_tpu_torch.learning.weights import ModelUpdate
from p2pfl_tpu_torch.management.logger import logger
from p2pfl_tpu_torch.models.base import TorchModel
from p2pfl_tpu_torch.models.transformer import CausalLM, TransformerConfig
from p2pfl_tpu_torch.models.vision import CNN, MLP, cnn, mlp
from p2pfl_tpu_torch.node import Node, stop_leaked_nodes
from p2pfl_tpu_torch.ops.tree import tree_leaves, tree_map
from p2pfl_tpu_torch.settings import Settings, set_test_settings
from p2pfl_tpu_torch.simulation import Simulation
from p2pfl_tpu_torch.utils import check_equal_models, full_connection, wait_convergence, wait_to_finish

torch.set_num_threads(2)

LR = 1e-3
SMALL = dict(vocab_size=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, ffn_hidden=128, lora_rank=4, lora_mlp=True)
SEQ = 32


@pytest.fixture(autouse=True)
def _port_env():
    set_test_settings()
    logger.set_level("INFO")
    MemoryRegistry.reset()
    JaxMemoryRegistry.reset()
    yield
    stop_leaked_nodes()
    MemoryRegistry.reset()
    JaxMemoryRegistry.reset()


def _pairs(jax_tree, port_tree) -> list:
    """(JAX leaf, port leaf) as fp32 numpy, in the shared leaf order."""
    port = jax.tree.leaves(params_to_jax(port_tree))
    return [(np.asarray(a, np.float32), b.astype(np.float32)) for a, b in zip(jax.tree.leaves(jax_tree), port)]


# ---- LoRALearner ----


def _lora_pair(dtype=jnp.float32, tdtype=torch.float32, seed: int = 0):
    jcfg = jtr.TransformerConfig(**SMALL, dtype=dtype)
    jmodel = jtr.tiny_transformer(seq_len=SEQ, seed=seed, cfg=jcfg)
    cfg = TransformerConfig(**SMALL, dtype=tdtype)
    params = params_from_jax(jax.tree.map(np.asarray, jmodel.params), device="cpu")
    return jmodel, TorchModel(CausalLM(cfg), params, (SEQ,), cfg.vocab_size, {"config": cfg})


def test_lora_learner_matches_jax_and_freezes_base():
    """One epoch (8 Adam steps at lr 1e-2) from the same init, data and
    rng seed, fp32 compute. The eval before training agrees to 1e-5
    relative, after it to 1e-4; each adapter element within 2·lr·steps
    and the mean difference under 1e-5 (Adam moves an element whose
    gradient sits at rounding noise by up to lr a step). The base is
    bit-unchanged and only the adapters are exchanged."""
    jdata = JaxDataset.synthetic_lm(vocab_size=256, seq_len=SEQ, n_train=64, n_test=16)
    tdata = FederatedDataset.synthetic_lm(vocab_size=256, seq_len=SEQ, n_train=64, n_test=16)
    jmodel, tmodel = _lora_pair()
    jl = JaxLoRALearner(jmodel, jdata, batch_size=8, learning_rate=1e-2, seed=4)
    tl = LoRALearner(tmodel, tdata, batch_size=8, learning_rate=1e-2, seed=4)
    assert sorted(tree_leaves(tl.get_parameters())[0].shape) == [4, 64]
    assert all("lora_" in path for path in _paths(tl.get_parameters()))
    base_before = [x.clone() for x in tree_leaves(tl.base)]
    je, te = jl.evaluate(), tl.evaluate()
    assert te["test_loss"] == pytest.approx(je["test_loss"], rel=1e-5)
    version = tl.model_version
    jl.fit()
    tl.fit()
    assert tl.model_version == version + 1
    je, te = jl.evaluate(), tl.evaluate()
    assert te["test_loss"] == pytest.approx(je["test_loss"], rel=1e-4)
    pairs = _pairs(jl.get_parameters(), tl.get_parameters())
    steps = 64 // 8
    assert max(np.abs(a - b).max() for a, b in pairs) <= 2 * 1e-2 * steps
    assert np.mean([np.abs(a - b).mean() for a, b in pairs]) <= 1e-5
    assert all(torch.equal(a, b) for a, b in zip(base_before, tree_leaves(tl.base)))
    moved = [float((a - b).abs().max()) for a, b in zip(tree_leaves(tmodel.params), tree_leaves(tl.full_parameters()))]
    assert max(moved) > 0.0


def _paths(tree) -> list:
    from p2pfl_tpu_torch.ops.tree import tree_items

    return [p for p, _ in tree_items(tree)]


def test_lora_learner_keeps_a_bf16_base_by_reference():
    """Under bf16 compute the frozen base holds its kernels and embedding
    once in bf16 (the model casts them at every use, so this is exact) and
    the norm scales in fp32; merging hands the same tensors over."""
    _, tmodel = _lora_pair(jnp.bfloat16, torch.bfloat16)
    data = FederatedDataset.synthetic_lm(vocab_size=256, seq_len=SEQ, n_train=32, n_test=8)
    tl = LoRALearner(tmodel, data, batch_size=8)
    assert tl.base["embed"].dtype == torch.bfloat16
    assert tl.base["layer_0"]["attn"]["wq"]["kernel"].dtype == torch.bfloat16
    assert tl.base["final_norm"]["scale"].dtype == torch.float32
    assert tl.full_parameters()["embed"] is tl.base["embed"]
    x = torch.from_numpy(data.x_test)
    full = tmodel.module(tmodel.params, x)
    frozen = tmodel.module(tl.full_parameters(), x)
    assert torch.equal(full, frozen)


def test_federated_lora_over_memory_transport():
    """Two Nodes exchange only adapter subtrees and end on equal adapters
    (the reference test's 1e-4), each base bit-unchanged."""
    data = FederatedDataset.synthetic_lm(vocab_size=256, seq_len=SEQ, n_train=128, n_test=16)
    nodes = []
    for i in range(2):
        _, tmodel = _lora_pair(jnp.bfloat16, torch.bfloat16)
        nodes.append(Node(learner=LoRALearner(tmodel, data.partition(i, 2), batch_size=8)))
    bases = [[x.clone() for x in tree_leaves(n.learner.base)] for n in nodes]
    try:
        for n in nodes:
            n.start()
        nodes[0].connect(nodes[1].addr)
        wait_convergence(nodes, 1, only_direct=True)
        nodes[0].set_start_learning(rounds=2, epochs=1)
        wait_to_finish(nodes, timeout=120)
        check_equal_models(nodes, atol=1e-4)
        for n, before in zip(nodes, bases):
            assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves(n.learner.base)))
            assert n.learner.fused_round() is None  # the staged path, as in JAX
    finally:
        for n in nodes:
            n.stop()


# ---- TorchLearner: FedProx, DP-SGD, the accountant ----


def _mlp_pair(seed: int = 0):
    jm = FlaxModel.create(JaxMLP(dtype=jnp.float32), (28, 28, 1), seed=seed)
    params = params_from_jax(jax.tree.map(np.asarray, jm.params), device="cpu")
    return jm, TorchModel(MLP(dtype=torch.float32), params, (28, 28, 1))


@pytest.mark.parametrize("knobs", [dict(prox_mu=0.1), dict(dp_clip=1.0), dict(dp_clip=0.5, prox_mu=0.05)],
                         ids=["fedprox", "dp_clip", "dp_clip_fedprox"])
def test_learner_epochs_match_jax(knobs):
    """Two fit() epochs (4 Adam steps each) of FedProx and of clip-only
    DP-SGD (no noise: deterministic) from the same init, data and rng
    seed, fp32 compute: each element within 2·lr·steps and the mean
    difference under 1e-6 (per-example gradients sum in another order;
    Adam turns noise-level gradients into up to lr a step); the rng
    streams consumed identically."""
    jdata = JaxDataset.synthetic_mnist(n_train=256, n_test=64, seed=0)
    tdata = FederatedDataset.synthetic_mnist(n_train=256, n_test=64, seed=0)
    jm, tm = _mlp_pair(2)
    jl = JaxLearner(jm, jdata, batch_size=64, epochs=2, seed=5, **knobs)
    tl = TorchLearner(tm, tdata, batch_size=64, epochs=2, seed=5, **knobs)
    jl.fit()
    tl.fit()
    pairs = _pairs(jl.get_parameters(), tl.get_parameters())
    assert max(np.abs(a - b).max() for a, b in pairs) <= 2 * LR * 8
    assert np.mean([np.abs(a - b).mean() for a, b in pairs]) <= 1e-6
    assert jl._rng.bit_generator.state == tl._rng.bit_generator.state


def test_dp_accountant_epsilon_equals_jax():
    """The same DP configuration and epochs: the same step count and a
    bit-equal ε (the accountant is the same Python arithmetic)."""
    jdata = JaxDataset.synthetic_mnist(n_train=256, n_test=64, seed=0)
    tdata = FederatedDataset.synthetic_mnist(n_train=256, n_test=64, seed=0)
    jm, tm = _mlp_pair(0)
    jl = JaxLearner(jm, jdata, batch_size=64, epochs=2, seed=5, dp_clip=1.0, dp_noise=1.1)
    tl = TorchLearner(tm, tdata, batch_size=64, epochs=2, seed=5, dp_clip=1.0, dp_noise=1.1)
    assert tl.accountant.q == jl.accountant.q
    jl.fit()
    tl.fit()
    assert tl.accountant.steps == jl.accountant.steps == 8
    assert tl.accountant.epsilon(1e-5) == jl.accountant.epsilon(1e-5) > 0
    # the noise is real: the same run without it ends elsewhere
    plain = TorchLearner(_mlp_pair(0)[1], tdata, batch_size=64, epochs=2, seed=5, dp_clip=1.0)
    plain.fit()
    assert max(float((a - b).abs().max()) for a, b in zip(tree_leaves(plain.params), tree_leaves(tl.params))) > 1e-4


def test_dp_noise_without_clip_is_rejected():
    data = FederatedDataset.synthetic_mnist(n_train=64, n_test=16)
    with pytest.raises(ValueError, match="dp_clip"):
        TorchLearner(mlp(seed=0, device="cpu"), data, dp_noise=1.0)


def test_keep_opt_state_carries_the_moments():
    data = FederatedDataset.synthetic_mnist(n_train=128, n_test=16)
    for keep in (False, True):
        learner = TorchLearner(mlp(seed=0, device="cpu"), data, batch_size=64, keep_opt_state=keep)
        learner.fit()
        learner.set_parameters(learner.get_parameters())
        assert int(learner.opt_state.count) == (2 if keep else 0)


# ---- the aggregator classes ----


def _stack_inputs(n: int = 7, seed: int = 0) -> list:
    rng = np.random.default_rng(seed)
    return [
        ({"a": {"kernel": rng.normal(size=(5, 4)).astype(np.float32)}, "b": rng.normal(size=(6,)).astype(np.float32)},
         int(rng.integers(10, 100)))
        for _ in range(n)
    ]


AGGREGATORS = {
    "krum": lambda m: m.Krum(n_byzantine=1),
    "multi_krum": lambda m: m.Krum(n_byzantine=2, multi=3),
    "trimmed_mean": lambda m: m.TrimmedMean(trim=2),
    "fedmedian": lambda m: m.FedMedian(),
    "bulyan": lambda m: m.Bulyan(n_byzantine=1),
    "centered_clip": lambda m: m.CenteredClip(tau=0.5),
    "fedadam": lambda m: m.FedAdam(),
    "fedyogi": lambda m: m.FedYogi(),
    "fedadagrad": lambda m: m.FedAdagrad(),
}


@pytest.mark.parametrize("name", sorted(AGGREGATORS))
def test_aggregator_class_matches_jax(name):
    """Each strategy class on identical individual models (7 models of a
    small fp32 tree, unequal sample counts), over three rounds so the
    stateful ones (FedOpt's moments, the clip center) step: within 1e-6
    of the JAX class (fp32 summation order), the same contributors and
    sample count."""
    jagg, tagg = AGGREGATORS[name](jaggs), AGGREGATORS[name](taggs)
    assert tagg.SUPPORTS_PARTIALS is jagg.SUPPORTS_PARTIALS is False
    assert tagg.ALWAYS_AGGREGATE is jagg.ALWAYS_AGGREGATE
    for rnd in range(3):
        inputs = _stack_inputs(seed=rnd)
        jres = jagg.aggregate([JaxModelUpdate(jax.tree.map(jnp.asarray, p), [f"n{i}"], w)
                               for i, (p, w) in enumerate(inputs)])
        tres = tagg.aggregate([ModelUpdate(tree_map(torch.from_numpy, p), [f"n{i}"], w)
                               for i, (p, w) in enumerate(inputs)])
        for a, b in zip(jax.tree.leaves(jres.params), tree_leaves(tres.params)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6, rtol=0)
        assert tres.contributors == jres.contributors and tres.num_samples == jres.num_samples


def test_trimmed_mean_too_few_models_takes_the_plain_mean():
    inputs = _stack_inputs(2)
    jres = jaggs.TrimmedMean(trim=1).aggregate(
        [JaxModelUpdate(jax.tree.map(jnp.asarray, p), [f"n{i}"], w) for i, (p, w) in enumerate(inputs)])
    tres = taggs.TrimmedMean(trim=1).aggregate(
        [ModelUpdate(tree_map(torch.from_numpy, p), [f"n{i}"], w) for i, (p, w) in enumerate(inputs)])
    for a, b in zip(jax.tree.leaves(jres.params), tree_leaves(tres.params)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-7, rtol=0)


def test_fedopt_on_result_then_aggregate():
    """``tests/test_privacy.py::test_fedopt_on_result_then_aggregate``: a
    node whose first round resolves to a peer's aggregate (on_result)
    still aggregates itself next round, stepping off the adopted x_t."""
    agg = taggs.FedAdam("me")
    consensus = ModelUpdate({"w": torch.full((4,), 0.5)}, ["me", "peer"], 20)
    assert agg.on_result(consensus) is consensus
    r = agg.aggregate([
        ModelUpdate({"w": torch.full((4,), 0.2)}, ["me"], 10),
        ModelUpdate({"w": torch.full((4,), 0.4)}, ["peer"], 10),
    ])
    assert bool(torch.isfinite(r.params["w"]).all())
    assert agg._t == 1


def test_centered_clip_on_result_and_experiment_reset():
    """``tests/test_centered_clip.py::test_centered_clip_experiment_reset``
    plus the resync: a peer's aggregate becomes the center, the per-round
    clear keeps it, the experiment boundary drops it."""
    agg = taggs.CenteredClip("test", tau=1.0)
    agg.aggregate([ModelUpdate({"w": torch.full((4,), v)}, [f"n{i}"], 1) for i, v in enumerate([1.0, 2.0])])
    assert agg._center is not None
    peer = ModelUpdate({"w": torch.full((4,), 3.0)}, ["n0", "n1"], 2)
    agg.on_result(peer)
    assert agg._center is peer.params
    agg.clear()
    assert agg._center is not None
    agg.reset_experiment()
    assert agg._center is None
    with pytest.raises(ValueError):
        taggs.CenteredClip(tau=0.0)


def test_waiting_node_resolves_through_on_result():
    """A waiting node's round resolves to the first full aggregate through
    the on_result hook, which resyncs a stateful strategy."""
    agg = taggs.FedAdam("me")
    agg.set_waiting_aggregated_model(["a", "b"])
    full = ModelUpdate({"w": torch.full((3,), 0.7)}, ["a", "b"], 20)
    assert agg.add_model(full) == ["a", "b"]
    assert agg.wait_and_get_aggregation(timeout=1) is full
    assert agg._prev is full.params and agg._m is not None


@pytest.mark.parametrize("name", ["fedmedian", "krum", "fedadam"])
def test_robust_strategy_refuses_a_partial_acc(name):
    """A strategy without partials raises on the fused round's
    accumulator instead of folding pre-averaged state."""
    agg = AGGREGATORS[name](taggs)
    agg.set_nodes_to_aggregate(["me", "peer"])
    update = ModelUpdate({"w": torch.ones(3)}, ["me"], 10)
    update.partial_acc = ({"w": torch.ones(3) * 10}, torch.tensor(10.0))
    with pytest.raises(ValueError, match="SUPPORTS_PARTIALS"):
        agg.add_model(update)
    update.partial_acc = None
    assert agg.add_model(update) == ["me"]


@pytest.mark.parametrize("epochs", [0, 1])
def test_fedmedian_gossip_three_nodes(epochs):
    """``tests/test_robust_gossip.py::test_fedmedian_gossip_three_nodes``:
    3 Nodes with FedMedian end on equal models (the reference's 1e-1
    check); with an epoch of training the fused round's own accumulator
    is stripped before the robust strategy sees it."""
    full = FederatedDataset.synthetic_mnist(n_train=768, n_test=128)
    nodes = [
        Node(learner=TorchLearner(mlp(seed=i, device="cpu"), full.partition(i, 3), batch_size=64),
             aggregator=taggs.FedMedian())
        for i in range(3)
    ]
    try:
        for n in nodes:
            n.start()
        for n in nodes:
            full_connection(n, nodes)
        wait_convergence(nodes, 2, only_direct=True)
        nodes[0].set_start_learning(rounds=1, epochs=epochs)
        wait_to_finish(nodes, timeout=90)
        check_equal_models(nodes)
    finally:
        for n in nodes:
            n.stop()


@pytest.mark.parametrize("name", ["centered_clip", "fedadam", "trimmed_mean"])
def test_stateful_and_robust_strategies_on_a_gossip_fleet(name):
    """3 Nodes, 2 rounds of one fused epoch, with a strategy that keeps
    server state (CenteredClip's center, FedAdam's moments: each node
    aggregates, or resyncs through on_result) or trims: every node ends
    on one model (1e-5: each aggregates the same individual models, and
    these rules depend on their order only through fp32 summation,
    measured 1.4e-6) with a finite loss. Krum
    is left out: two models that are each other's nearest neighbour tie,
    and the tie goes to the first in the node's own arrival order, in
    JAX as here."""
    full = FederatedDataset.synthetic_mnist(n_train=768, n_test=128)
    nodes = [
        Node(learner=TorchLearner(mlp(seed=i, device="cpu"), full.partition(i, 3), batch_size=64),
             aggregator=AGGREGATORS[name](taggs))
        for i in range(3)
    ]
    try:
        for n in nodes:
            n.start()
        for n in nodes:
            full_connection(n, nodes)
        wait_convergence(nodes, 2, only_direct=True)
        nodes[0].set_start_learning(rounds=2, epochs=1)
        wait_to_finish(nodes, timeout=90)
        check_equal_models(nodes, atol=1e-5)
        assert np.isfinite(nodes[0].learner.evaluate()["test_loss"])
    finally:
        for n in nodes:
            n.stop()


# ---- the CNN and the wrong-model scenario ----


def test_cnn_init_tree_matches_flax_layout():
    jtree = jax.tree.map(np.asarray, jax_cnn(seed=0).params)
    ttree = params_to_jax(cnn(seed=0, device="cpu").params)
    assert jax.tree.structure(jtree) == jax.tree.structure(ttree)
    for a, b in zip(jax.tree.leaves(jtree), jax.tree.leaves(ttree)):
        assert a.shape == b.shape and a.dtype == b.dtype
    assert ttree["Conv_0"]["kernel"].shape == (3, 3, 1, 32)  # HWIO


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_cnn_logits_match_flax(dtype):
    """The flax ``cnn(seed)`` init converted, the same NHWC batch. fp32
    compute: 1e-4 (conv summation order). bf16 compute: both round each
    layer's output to bf16, in another summation order, so a logit may
    move by a few bf16 ulps of the layer values: 2^-5 relative plus
    2^-5 of the largest logit."""
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (jnp.float32, torch.float32)
    jm = FlaxModel.create(JaxCNN(dtype=jdt), (28, 28, 1), seed=3)
    params = params_from_jax(jax.tree.map(np.asarray, jm.params), device="cpu")
    rng = np.random.default_rng(0)
    x = rng.random((16, 28, 28, 1), dtype=np.float32)
    want = np.asarray(jm.module.apply({"params": jm.params}, jnp.asarray(x)))
    got = CNN(dtype=tdt)(params, torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32 and got.shape == (16, 10)
    if dtype == "f32":
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    else:
        np.testing.assert_allclose(got, want, rtol=2.0 ** -5, atol=2.0 ** -5 * np.abs(want).max())


def test_cnn_trains_on_the_node():
    data = FederatedDataset.synthetic_mnist(n_train=256, n_test=64)
    learner = TorchLearner(cnn(seed=0, device="cpu"), data, batch_size=64)
    before = learner.evaluate()["test_loss"]
    for _ in range(3):
        learner.fit()
    assert learner.evaluate()["test_loss"] < before


def test_wrong_model_does_not_hang(monkeypatch):
    """``tests/test_node.py::test_wrong_model_does_not_hang`` (MLP against
    CNN): the mismatched node stops itself and the other one finishes.
    Short vote and aggregation timeouts keep it fast."""
    monkeypatch.setattr(Settings, "VOTE_TIMEOUT", 2.0)
    monkeypatch.setattr(Settings, "AGGREGATION_TIMEOUT", 2.0)
    data = FederatedDataset.synthetic_mnist(n_train=256, n_test=64)
    n1 = Node(learner=TorchLearner(mlp(seed=0, device="cpu"), data.partition(0, 2), batch_size=64))
    n2 = Node(learner=TorchLearner(cnn(seed=1, device="cpu"), data.partition(1, 2), batch_size=64))
    try:
        n1.start()
        n2.start()
        n1.connect(n2.addr)
        wait_convergence([n1, n2], 1, only_direct=True)
        n1.set_start_learning(rounds=1, epochs=0)
        wait_to_finish([n1], timeout=30)
    finally:
        n1.stop()
        n2.stop()


# ---- Simulation and the gossip lora_ft ----


def test_simulation_runs_two_experiments():
    """``Simulation`` builds, connects and runs Nodes; a second ``learn``
    runs the next experiment; every node ends on one model."""
    data = FederatedDataset.synthetic_mnist(n_train=256, n_test=64)
    sim = Simulation(
        3, lambda i, shard: TorchLearner(mlp(seed=i, device="cpu"), shard, batch_size=64), data,
        topology="ring",
    )
    try:
        sim.start().learn(rounds=1, epochs=1)
        sim.learn(rounds=1, epochs=1)
        assert all(n.state.experiment_epoch == 2 for n in sim.nodes)
        check_equal_models(sim.nodes, atol=1e-5)
        assert all("test_acc" in m for m in sim.evaluate().values())
    finally:
        sim.stop()


def test_lora_ft_gossip_runs_on_the_cpu(capsys):
    """The example without ``--spmd``: a gossip LoRA federation through
    ``Simulation`` and ``LoRALearner`` with flash attention's plain
    versions, every node reporting its metrics; without a card and
    without ``--device cpu`` it raises."""
    from p2pfl_tpu_torch.examples import lora_ft

    lora_ft.main(["--device", "cpu", "--nodes", "2", "--rounds", "1", "--layers", "1", "--dim", "128",
                  "--seq-len", "64", "--attn", "flash", "--batch-size", "8"])
    lines = [line for line in capsys.readouterr().out.splitlines() if "test_acc" in line]
    assert len(lines) == 2
    if not torch.cuda.is_available():
        with pytest.raises(DeviceUnavailableError):
            lora_ft.main(["--layers", "1", "--dim", "128"])
