"""FedPer on the port (``p2pfl_tpu_torch/learning/personalization.py``):
JAX's ``tests/test_personalization.py`` cases (the gRPC federation
unmarked: it is quick on the port), and a 2-node FedPer federation held
against the JAX package's from the same flax inits loaded through
``convert.params_from_jax``.

Tolerances: the ported cases keep JAX's (bodies within 1e-1 across
nodes, accuracy over 0.7); against JAX, node by node, every element
within 2·lr·steps (Adam flips on near-zero gradients, as in
``test_torch_node.py``) and the mean gap under 1e-6 (fp32).
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2pfl_tpu.communication.memory import MemoryRegistry as JaxMemoryRegistry
from p2pfl_tpu.learning.dataset import FederatedDataset as JaxDataset
from p2pfl_tpu.learning.personalization import PersonalizedLearner as JaxPersonalizedLearner
from p2pfl_tpu.models.base import FlaxModel
from p2pfl_tpu.models.vision import MLP as JaxMLP
from p2pfl_tpu.node import Node as JaxNode
from p2pfl_tpu.settings import Settings as JaxSettings
from p2pfl_tpu.utils import wait_convergence as jax_wait_convergence
from p2pfl_tpu.utils import wait_to_finish as jax_wait_to_finish
from p2pfl_tpu_torch.communication.grpc_transport import GrpcProtocol
from p2pfl_tpu_torch.communication.memory import MemoryRegistry
from p2pfl_tpu_torch.convert import params_from_jax, params_to_jax
from p2pfl_tpu_torch.exceptions import ModelNotMatchingError
from p2pfl_tpu_torch.learning.dataset import FederatedDataset
from p2pfl_tpu_torch.learning.learner import TorchLearner
from p2pfl_tpu_torch.learning.personalization import PersonalizedLearner
from p2pfl_tpu_torch.management.logger import logger
from p2pfl_tpu_torch.models.base import TorchModel
from p2pfl_tpu_torch.models.vision import MLP, mlp
from p2pfl_tpu_torch.node import Node, stop_leaked_nodes
from p2pfl_tpu_torch.ops.tree import tree_items
from p2pfl_tpu_torch.settings import Settings, set_test_settings
from p2pfl_tpu_torch.utils import full_connection, wait_convergence, wait_to_finish

torch.set_num_threads(2)
HEAD = "Dense_2"  # the MLP's output layer
LR = 1e-3


@pytest.fixture(autouse=True)
def _clean():
    set_test_settings()
    logger.set_level("INFO")
    MemoryRegistry.reset()
    JaxMemoryRegistry.reset()
    yield
    stop_leaked_nodes()
    MemoryRegistry.reset()
    JaxMemoryRegistry.reset()


def _learner(i, n, full, **kw):
    return PersonalizedLearner(mlp(seed=i, device="cpu"), full.partition(i, n), batch_size=64, personal=(HEAD,),
                               seed=i, **kw)


def _flat(tree) -> dict:
    return {k: v.detach().float().numpy() for k, v in tree_items(tree)}


def test_update_excludes_personal_paths():
    learner = _learner(0, 2, FederatedDataset.synthetic_mnist(n_train=256, n_test=64))
    paths = set(_flat(learner.get_model_update().params))
    assert paths and all(not p.startswith(HEAD) for p in paths)
    assert any(p.startswith(HEAD) for p in _flat(learner.params))


def test_set_parameters_preserves_head_and_checks_structure():
    full = FederatedDataset.synthetic_mnist(n_train=256, n_test=64)
    a, b = _learner(0, 2, full), _learner(1, 2, full)
    head_before = {k: v for k, v in _flat(a.params).items() if k.startswith(HEAD)}
    version = a.model_version
    a.set_parameters(b.get_model_update().params)  # a body-only tree
    assert a.model_version == version + 1
    flat, bflat = _flat(a.params), _flat(b.params)
    for k, v in head_before.items():
        np.testing.assert_array_equal(flat[k], v)
    for k in flat:
        if not k.startswith(HEAD):
            np.testing.assert_array_equal(flat[k], bflat[k])
    with pytest.raises(ModelNotMatchingError):
        a.set_parameters({"bogus": torch.zeros((2, 2))})


def test_bad_personal_prefixes_rejected():
    full = FederatedDataset.synthetic_mnist(n_train=256, n_test=64)
    with pytest.raises(ValueError, match="matches no parameters"):
        PersonalizedLearner(mlp(device="cpu"), full.partition(0, 2), personal=("NoSuchLayer",))
    with pytest.raises(ValueError, match="Dens_1"):
        PersonalizedLearner(mlp(device="cpu"), full.partition(0, 2), personal=(HEAD, "Dens_1"))
    with pytest.raises(ValueError, match="at least one"):
        PersonalizedLearner(mlp(device="cpu"), full.partition(0, 2), personal=())
    with pytest.raises(ValueError, match="nothing left to federate"):
        PersonalizedLearner(mlp(device="cpu"), full.partition(0, 2), personal=("Dense_0", "Dense_1", HEAD))


def test_fused_round_declines_and_the_anchor_is_the_body():
    """The staged path runs (the fused fold would take the whole tree),
    and topk8's anchor is the body, the only thing on the wire."""
    learner = _learner(0, 2, FederatedDataset.synthetic_mnist(n_train=256, n_test=64))
    assert learner.fused_round() is None
    Settings.WIRE_COMPRESSION = "topk8"
    try:
        learner.set_wire_anchor(learner.params, "1:0")
        anchor, tag = learner.wire_anchor()
        assert tag == "1:0" and not any(k.startswith(HEAD) for k in _flat(anchor))
        assert learner.get_model_update().anchor is anchor
    finally:
        Settings.WIRE_COMPRESSION = "none"


@pytest.mark.parametrize("mode", ["none", "topk8"])
def test_personalized_federation_over_grpc(mode):
    """3 personalized Nodes over real sockets: body-only payloads cross as
    bytes (dense, and under topk8 delta-coded against the body anchor) and
    restore against each receiver's body template. The majority property
    of JAX's test: under the test clocks a node's last aggregation may
    close on a partial."""
    Settings.GRPC_TIMEOUT = 5.0
    Settings.WIRE_COMPRESSION = mode
    full = FederatedDataset.synthetic_mnist(n_train=768, n_test=128)
    nodes = [Node(learner=_learner(i, 3, full), protocol=GrpcProtocol("127.0.0.1:0")) for i in range(3)]
    try:
        for n in nodes:
            n.start()
        for n in nodes:
            full_connection(n, nodes)
        wait_convergence(nodes, 2, only_direct=True)
        nodes[0].set_start_learning(rounds=3, epochs=2)
        wait_to_finish(nodes, timeout=120)
        accs = sorted(n.learner.evaluate()["test_acc"] for n in nodes)
        assert accs[-1] > 0.7 and accs[-2] > 0.6, accs
        assert all(n.protocol.wire_stats["weights_bytes"] > 0 for n in nodes)
    finally:
        for n in nodes:
            n.stop()
        Settings.WIRE_COMPRESSION = "none"


def test_mixed_plain_and_personalized_fails_loudly_not_hanging():
    """A plain learner mixed into a personalized federation cannot take
    body-only updates: it stops itself on the model-mismatch path over a
    byte transport, never hangs the experiment."""
    Settings.MEMORY_WIRE_CODEC = True
    full = FederatedDataset.synthetic_mnist(n_train=512, n_test=64)
    plain = Node(learner=TorchLearner(mlp(seed=0, device="cpu"), full.partition(0, 2), batch_size=64))
    pers = Node(learner=_learner(1, 2, full))
    try:
        plain.start()
        pers.start()
        plain.connect(pers.addr)
        wait_convergence([plain, pers], 1, only_direct=True)
        pers.set_start_learning(rounds=1, epochs=1)
        deadline = time.monotonic() + 60
        while plain.is_running() and time.monotonic() < deadline:
            time.sleep(0.2)
        assert not plain.is_running()
    finally:
        plain.stop()
        pers.stop()
        Settings.MEMORY_WIRE_CODEC = False


def test_personalized_federation_end_to_end():
    """3 Nodes federate their bodies: bodies end equal (1e-1, JAX's),
    heads stay apart, and every node that trained has a working model."""
    full = FederatedDataset.synthetic_mnist(n_train=1536, n_test=256)
    nodes = [Node(learner=_learner(i, 3, full)) for i in range(3)]
    try:
        for n in nodes:
            n.start()
        for n in nodes:
            full_connection(n, nodes)
        wait_convergence(nodes, 2, only_direct=True)
        nodes[0].set_start_learning(rounds=3, epochs=2)
        wait_to_finish(nodes, timeout=120)
        flats = [_flat(n.learner.params) for n in nodes]
        body = [k for k in flats[0] if not k.startswith(HEAD)]
        head = [k for k in flats[0] if k.startswith(HEAD)]
        assert body and head
        for k in body:
            np.testing.assert_allclose(flats[0][k], flats[1][k], atol=1e-1)
        assert any(not np.allclose(flats[0][k], flats[1][k], atol=1e-3) for k in head)
        trained = [n for n in nodes if n.learner._steps_done > 0]
        assert len(trained) >= 2
        for n in trained:
            assert n.learner.evaluate()["test_acc"] > 0.7
    finally:
        for n in nodes:
            n.stop()


# ---- against the JAX package ----


def _jax_mlp(seed: int) -> FlaxModel:
    return FlaxModel.create(JaxMLP(dtype=jnp.float32), (28, 28, 1), seed=seed)


def test_fedper_federation_matches_jax():
    """2 FedPer Nodes, 2 rounds of 1 epoch (4 steps), fp32, in each
    package from the same flax inits (converted for the port) and data:
    node by node the final trees (bodies and heads) agree within
    2·lr·steps, the mean gap under 1e-6."""
    JaxSettings.ROUND_FUSED = False
    jdata = JaxDataset.synthetic_mnist(n_train=512, n_test=128, seed=0)
    tdata = FederatedDataset.synthetic_mnist(n_train=512, n_test=128, seed=0)
    jmodels = [_jax_mlp(i) for i in range(2)]
    jnodes = [JaxNode(learner=JaxPersonalizedLearner(jmodels[i], jdata.partition(i, 2), batch_size=64, seed=i,
                                                     personal=(HEAD,))) for i in range(2)]
    tnodes = [
        Node(learner=PersonalizedLearner(
            TorchModel(MLP(dtype=torch.float32),
                       params_from_jax(jax.tree.map(np.asarray, jmodels[i].params), device="cpu"), (28, 28, 1)),
            tdata.partition(i, 2), batch_size=64, seed=i, personal=(HEAD,)))
        for i in range(2)
    ]
    try:
        for n in jnodes:
            n.start()
        jnodes[0].connect(jnodes[1].addr)
        jax_wait_convergence(jnodes, 1, only_direct=True)
        jnodes[0].set_start_learning(rounds=2, epochs=1)
        jax_wait_to_finish(jnodes, timeout=60)
        for n in tnodes:
            n.start()
        tnodes[0].connect(tnodes[1].addr)
        wait_convergence(tnodes, 1, only_direct=True)
        tnodes[0].set_start_learning(rounds=2, epochs=1)
        wait_to_finish(tnodes, timeout=60)
    finally:
        for n in (*jnodes, *tnodes):
            n.stop()
    steps = 2 * 4
    for jn, tn in zip(jnodes, tnodes):
        jp = jax.tree.map(np.asarray, jn.learner.params)
        tp = params_to_jax(tn.learner.params)
        gaps = [np.abs(np.asarray(jp[layer][name], np.float32) - tp[layer][name].astype(np.float32))
                for layer in jp for name in jp[layer]]
        assert max(g.max() for g in gaps) <= 2 * LR * steps
        assert np.mean([g.mean() for g in gaps]) <= 1e-6
    # the heads stayed each node's own in both packages
    h0, h1 = (params_to_jax(n.learner.params)[HEAD]["kernel"] for n in tnodes)
    assert not np.allclose(h0, h1, atol=1e-3)
