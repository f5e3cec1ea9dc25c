"""Secure aggregation on the port (``p2pfl_tpu_torch/learning/secagg.py``)
against the JAX package.

Every test of JAX's ``tests/test_secagg.py`` runs here on the port (its
two ``slow`` ones unmarked: the dropout federation and the node-stacked
masking are quick on the port), and the packages are held against each
other on fixed keys and numpy inputs: ``_leaf_mask`` bit-equal;
``pairwise_mask``, ``mask_update``, ``self_mask``, ``dropout_correction``
and Shamir bit-equal or equal; a federation of one JAX node and one port
node under secure aggregation ends on the unmasked FedAvg.

Tolerances: bit-equality where both packages run the same numpy and fp32
arithmetic; the JAX tests' own bounds where masks cancel in a sum (1e-3
on the weighted mean with masks of STD 100; 1e-2 for the double mask's
fp32 sum); federations' nodes within 1e-3 of the unmasked FedAvg.
"""

import itertools
import secrets as pysecrets
import threading
import time

import numpy as np
import pytest
import torch

from p2pfl_tpu.communication import grpc_transport as jg
from p2pfl_tpu.learning import secagg as jsecagg
from p2pfl_tpu.learning.dataset import FederatedDataset as JaxDataset
from p2pfl_tpu.learning.learner import JaxLearner
from p2pfl_tpu.learning.weights import ModelUpdate as JaxModelUpdate
from p2pfl_tpu.learning.weights import named_leaves as jax_named_leaves
from p2pfl_tpu.models import mlp as jax_mlp
from p2pfl_tpu.node import Node as JaxNode
from p2pfl_tpu.settings import Settings as JaxSettings
from p2pfl_tpu_torch.commands.control import (
    SecAggNeedCommand,
    SecAggPubCommand,
    SecAggRevealCommand,
    SecAggShareCommand,
    promote_early_reveals,
)
from p2pfl_tpu_torch.communication import grpc_transport as tg
from p2pfl_tpu_torch.communication.faults import CrashSpec, FaultPlan, install_fault_plan
from p2pfl_tpu_torch.communication.memory import MemoryRegistry
from p2pfl_tpu_torch.exceptions import SecAggError
from p2pfl_tpu_torch.learning import secagg
from p2pfl_tpu_torch.learning.aggregators.krum import Krum
from p2pfl_tpu_torch.learning.dataset import FederatedDataset
from p2pfl_tpu_torch.learning.learner import DummyLearner, TorchLearner
from p2pfl_tpu_torch.learning.weights import ModelUpdate
from p2pfl_tpu_torch.management.logger import logger
from p2pfl_tpu_torch.models.vision import mlp
from p2pfl_tpu_torch.node import Node, stop_leaked_nodes
from p2pfl_tpu_torch.node_state import NodeState
from p2pfl_tpu_torch.ops.tree import tree_items, tree_leaves
from p2pfl_tpu_torch.settings import Settings, set_test_settings
from p2pfl_tpu_torch.stages.learning_stages import GossipModelStage, RoundFinishedStage, TrainStage
from p2pfl_tpu_torch.utils import check_equal_models, full_connection, wait_convergence, wait_to_finish

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _clean():
    set_test_settings()
    logger.set_level("INFO")
    MemoryRegistry.reset()
    yield
    stop_leaked_nodes()
    MemoryRegistry.reset()
    Settings.SECURE_AGGREGATION = JaxSettings.SECURE_AGGREGATION = False
    Settings.SECAGG_DOUBLE_MASK = JaxSettings.SECAGG_DOUBLE_MASK = True


def _w(x) -> dict:
    return {"w": torch.as_tensor(np.asarray(x, np.float32))}


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def test_dh_pair_seed_symmetric():
    xa, pa = secagg.dh_keypair()
    xb, pb = secagg.dh_keypair()
    assert secagg.dh_pair_seed(xa, pb, "exp") == secagg.dh_pair_seed(xb, pa, "exp")
    assert secagg.dh_pair_seed(xa, pb, "exp") != secagg.dh_pair_seed(xa, pb, "exp2")


def _mask_for(addr, addrs, privs, pubs, params, num_samples, round_no=0):
    return secagg.mask_update(ModelUpdate(params, [addr], num_samples), addr, addrs, privs[addr], pubs, "exp",
                              round_no)


def test_masks_cancel_in_weighted_fedavg():
    """Σ w_i·masked_i == Σ w_i·p_i once every pair is present (1e-3)."""
    addrs = ["a", "b", "c", "d"]
    keys = {n: secagg.dh_keypair() for n in addrs}
    privs = {n: k[0] for n, k in keys.items()}
    weights = {"a": 10, "b": 20, "c": 30, "d": 40}
    pubs = {n: (keys[n][1], weights[n]) for n in addrs}
    rng = np.random.default_rng(0)
    params = {n: _w(rng.normal(size=(16, 8))) for n in addrs}
    masked = {n: _mask_for(n, addrs, privs, pubs, params[n], weights[n]) for n in addrs}
    for n in addrs:
        assert np.std(_np(masked[n].params["w"]) - _np(params[n]["w"])) > 1.0
    w_total = sum(weights.values())
    true_avg = sum(weights[n] * _np(params[n]["w"]).astype(np.float64) for n in addrs) / w_total
    masked_avg = sum(weights[n] * _np(masked[n].params["w"]).astype(np.float64) for n in addrs) / w_total
    np.testing.assert_allclose(masked_avg, true_avg, atol=1e-3)


def test_mask_fresh_per_round():
    addrs = ["a", "b"]
    keys = {n: secagg.dh_keypair() for n in addrs}
    privs = {n: k[0] for n, k in keys.items()}
    pubs = {n: (k[1], 1) for n, k in keys.items()}
    p = _w(np.zeros((4, 4)))
    m0 = _mask_for("a", addrs, privs, pubs, p, 1, round_no=0)
    m1 = _mask_for("a", addrs, privs, pubs, p, 1, round_no=1)
    assert not np.allclose(_np(m0.params["w"]), _np(m1.params["w"]))


def test_unsafe_masking_raises_never_unmasked():
    addrs = ["a", "b"]
    priv, _pub = secagg.dh_keypair()
    _priv_b, pub_b = secagg.dh_keypair()
    p32 = _w(np.ones((2, 2)))
    with pytest.raises(SecAggError, match="missing DH"):
        secagg.mask_update(ModelUpdate(p32, ["a"], 5), "a", addrs, priv, {}, "exp", 0)
    with pytest.raises(SecAggError, match="zero sample"):
        secagg.mask_update(ModelUpdate(p32, ["a"], 0), "a", addrs, priv, {"b": (pub_b, 5)}, "exp", 0)
    p16 = {"w": torch.ones((2, 2), dtype=torch.bfloat16)}
    with pytest.raises(SecAggError, match="float32"):
        secagg.mask_update(ModelUpdate(p16, ["a"], 5), "a", addrs, priv, {"b": (pub_b, 5)}, "exp", 0)
    Settings.WIRE_COMPRESSION = "int8"
    try:
        with pytest.raises(SecAggError, match="lossless"):
            secagg.mask_update(ModelUpdate(p32, ["a"], 5), "a", addrs, priv, {"b": (pub_b, 5)}, "exp", 0)
    finally:
        Settings.WIRE_COMPRESSION = "none"


def test_degenerate_dh_keys_rejected():
    priv, _ = secagg.dh_keypair()
    for bad in (0, 1, secagg.DH_PRIME - 1, secagg.DH_PRIME):
        assert not secagg.valid_public_key(bad)
        with pytest.raises(SecAggError, match="degenerate"):
            secagg.dh_pair_seed(priv, bad, "exp")
    state = NodeState("me")
    cmd = SecAggPubCommand(state)
    cmd.execute("attacker", 0, "1", "5")
    assert "attacker" not in state.secagg_pubs
    _, good = secagg.dh_keypair()
    cmd.execute("peer", 0, f"{good:x}", "0")
    assert "peer" not in state.secagg_pubs
    cmd.execute("peer", 0, f"{good:x}", "5")
    assert state.secagg_pubs["peer"] == (good, 5)


def test_secagg_misconfig_aborts_experiment():
    """SecAgg with a robust aggregator aborts in StartLearningStage: no
    training runs (DummyLearner.fit would have moved the params)."""
    Settings.SECURE_AGGREGATION = True
    nodes = [Node(learner=DummyLearner(device="cpu"), aggregator=Krum()) for _ in range(2)]
    for n in nodes:
        n.start()
    try:
        nodes[0].connect(nodes[1].addr)
        wait_convergence(nodes, 1, only_direct=True)
        nodes[0].set_start_learning(rounds=1, epochs=1)
        time.sleep(1.5)
        for n in nodes:
            assert n.state.round is None
            assert float(n.learner.get_parameters()["w"].mean()) == 0.0
    finally:
        for n in nodes:
            n.stop()


def _fleet(n: int, samples: int = 1024, batch: int = 64, learner_cls=TorchLearner):
    full = FederatedDataset.synthetic_mnist(n_train=samples, n_test=256)
    nodes = []
    for i in range(n):
        node = Node(learner=learner_cls(mlp(seed=i, device="cpu"), full.partition(i, n), batch_size=batch, seed=i))
        node.start()
        nodes.append(node)
    for node in nodes:
        full_connection(node, nodes)
    wait_convergence(nodes, n - 1, only_direct=True)
    return nodes


def test_secure_federation_end_to_end():
    """4 Nodes with SECURE_AGGREGATION: every aggregator input is masked,
    yet the fleet ends on one working model."""
    Settings.SECURE_AGGREGATION = True
    nodes = _fleet(4)
    try:
        nodes[0].set_start_learning(rounds=2, epochs=1)
        wait_to_finish(nodes, timeout=120)
        check_equal_models(nodes)
        assert nodes[0].learner.evaluate()["test_acc"] > 0.7
    finally:
        for n in nodes:
            n.stop()


def test_mask_stream_is_version_stable():
    """The mask PRG is SHAKE-256 through Box–Muller: JAX's golden values
    (a few fp32 ulps: libm's log/cos/sin), a standard normal."""
    m = secagg._leaf_mask(123456789, 3, (4,), 1)
    np.testing.assert_allclose(m, np.array([0.7085209, 0.7587952, -0.349858, 0.37594432], np.float32), rtol=1e-5)
    big = secagg._leaf_mask(7, 0, (100000,), 0)
    assert abs(float(big.mean())) < 0.02 and abs(float(big.std()) - 1.0) < 0.02


def test_secagg_pub_first_key_latched():
    state = NodeState("me")
    cmd = SecAggPubCommand(state)
    _, first = secagg.dh_keypair()
    _, attacker = secagg.dh_keypair()
    cmd.execute("victim", 0, f"{first:x}", "5")
    cmd.execute("victim", 0, f"{attacker:x}", "5")
    cmd.execute("victim", 0, f"{first:x}", "7")
    cmd.execute("victim", 0, f"{first:x}", "5")
    assert state.secagg_pubs["victim"] == (first, 5)
    state.clear()
    cmd.execute("victim", 0, f"{attacker:x}", "5")
    assert state.secagg_pubs["victim"] == (attacker, 5)


def test_announced_sample_count_latched():
    addrs = ["a", "b"]
    priv, _ = secagg.dh_keypair()
    _, pub_b = secagg.dh_keypair()
    p = _w(np.ones((2, 2)))
    with pytest.raises(SecAggError, match="changed since"):
        secagg.mask_update(ModelUpdate(p, ["a"], 7), "a", addrs, priv, {"b": (pub_b, 5)}, "exp", 0,
                           announced_samples=5)
    assert secagg.mask_update(ModelUpdate(p, ["a"], 5), "a", addrs, priv, {"b": (pub_b, 5)}, "exp", 0,
                              announced_samples=5) is not None


def test_dropout_correction_recovers_survivor_mean():
    """With one member missing, subtracting dropout_correction / W from
    the survivors' weighted mean gives their true mean (1e-3)."""
    addrs = ["a", "b", "c", "d"]
    keys = {n: secagg.dh_keypair() for n in addrs}
    privs = {n: k[0] for n, k in keys.items()}
    weights = {"a": 10, "b": 20, "c": 30, "d": 40}
    pubs = {n: (keys[n][1], weights[n]) for n in addrs}
    rng = np.random.default_rng(1)
    params = {n: _w(rng.normal(size=(16, 8))) for n in addrs}
    masked = {n: _mask_for(n, addrs, privs, pubs, params[n], weights[n]) for n in addrs}
    survivors, missing = ["a", "b", "c"], ["d"]
    w_s = sum(weights[n] for n in survivors)
    noised = sum(weights[n] * _np(masked[n].params["w"]).astype(np.float64) for n in survivors) / w_s
    true_mean = sum(weights[n] * _np(params[n]["w"]).astype(np.float64) for n in survivors) / w_s
    assert np.abs(noised - true_mean).max() > 10
    seeds = {(i, "d"): secagg.dh_pair_seed(privs[i], pubs["d"][0], "exp") for i in survivors}
    corr = secagg.dropout_correction(params["a"], survivors, missing, seeds, weights, 0)
    fixed = secagg.apply_dropout_correction(_w(noised), corr, float(w_s))
    np.testing.assert_allclose(_np(fixed["w"]).astype(np.float64), true_mean, atol=1e-3)


def test_secagg_dropout_recovery_end_to_end():
    """A train-set member hard-crashes as it enters round 0's TrainStage,
    after announcing its key: the survivors recover their clean aggregate
    by seed disclosure and end on one working model."""
    Settings.SECURE_AGGREGATION = True
    Settings.AGGREGATION_TIMEOUT = 4.0
    nodes = _fleet(4)
    try:
        install_fault_plan(nodes, FaultPlan(seed=0, crashes={nodes[3].addr: CrashSpec("TrainStage", 0)}))
        nodes[0].set_start_learning(rounds=1, epochs=1)
        wait_to_finish(nodes[:3], timeout=120)
        check_equal_models(nodes[:3])
        assert nodes[0].learner.evaluate()["test_acc"] > 0.7  # masks recovered: not noise
    finally:
        for n in nodes:
            n.stop()


class _Proto:
    def __init__(self, live=(), sink=None):
        self._live = live
        self.sent = sink if sink is not None else []
        self.gossip = 0

    def broadcast(self, msg):
        self.sent.append(msg)

    def build_msg(self, cmd, args=(), round=0):  # noqa: A002
        return (cmd, list(args), round)

    def get_neighbors(self, only_direct=False):
        return dict.fromkeys(self._live)

    def gossip_weights(self, *a, **k):
        self.gossip += 1


def test_secagg_unrecoverable_round_is_noop():
    """Seed disclosures that never arrive: the noised aggregate is dropped
    and the round resolves to the round-start global, flagged no-op."""
    Settings.SECURE_AGGREGATION = True
    Settings.SECAGG_RECOVERY_TIMEOUT = 0.3
    state = NodeState("a")
    state.set_experiment("exp", 1)
    state.train_set = ["a", "b", "c"]
    state.secagg_priv, _pub = secagg.dh_keypair()
    state.secagg_samples = 10
    for peer in ("b", "c"):
        state.secagg_pubs[peer] = (secagg.dh_keypair()[1], 10)

    class _Learner:
        def get_parameters(self):
            return _w(np.full((2, 2), 7.0))

    class _FakeNode:
        addr = "a"

        def __init__(self):
            self.state = state
            self.protocol = _Proto()
            self.learner = _Learner()
            self.round_start_params = _w(np.full((2, 2), 7.0))

        def learning_interrupted(self):
            return False

    out = GossipModelStage._secagg_finalize(_FakeNode(), ModelUpdate(_w(np.full((2, 2), 999.0)), ["a", "b"], 20))
    np.testing.assert_array_equal(_np(out.params["w"]), 7.0)
    assert set(out.contributors) == {"a", "b", "c"} and out.noop_round


def test_noop_round_skips_outward_diffusion():
    Settings.SECURE_AGGREGATION = True
    proto = _Proto()

    class _Agg:
        def wait_and_get_aggregation(self, timeout=None):
            return ModelUpdate(_w(np.full((2, 2), 7.0)), ["a", "b"], 2, noop_round=True)

    class _Learner:
        def set_parameters(self, p):
            pass

    class _FakeNode:
        addr = "a"

        def __init__(self):
            self.state = NodeState("a")
            self.state.set_experiment("exp", 1)
            self.state.train_set = ["a", "b"]
            self.protocol = proto
            self.aggregator = _Agg()
            self.learner = _Learner()

        def learning_interrupted(self):
            return False

    assert GossipModelStage.execute(_FakeNode()) is RoundFinishedStage
    assert proto.gossip == 0
    assert any(m[0] == "models_ready" for m in proto.sent)


def test_secagg_need_answered_by_full_coverage_peer():
    sent: list = []

    class _FakeNode:
        def __init__(self, addr, train, live):
            self.addr = addr
            self.state = NodeState(addr)
            self.state.set_experiment("exp", 1)
            self.state.train_set = list(train)
            self.protocol = _Proto(live, sent)

    node = _FakeNode("a", ["a", "b", "c", "d"], live=["b", "c"])
    priv, _ = secagg.dh_keypair()
    node.state.secagg_priv = priv
    for peer in ("b", "c", "d"):
        node.state.secagg_pubs[peer] = (secagg.dh_keypair()[1], 10)
    cmd = SecAggNeedCommand(node)
    cmd.execute("b", 0, "exp", "d")
    expected = secagg.dh_pair_seed(priv, node.state.secagg_pubs["d"][0], "exp")
    assert len(sent) == 1 and sent[0][0] == "secagg_recover" and sent[0][1][0] == "d"
    assert int(sent[0][1][1], 16) == expected
    cmd.execute("c", 0, "exp", "d")  # another requester: answered again
    assert len(sent) == 2 and int(sent[1][1][1], 16) == expected
    cmd.execute("c", 0, "exp", "d")
    cmd.execute("b", 0, "exp", "d")
    cmd.execute("b", 0, "exp", "a", "b", "zz")
    cmd.execute("b", 0, "exp", "c")  # names a live member: refused
    cmd.execute("zz", 0, "exp", "d")
    cmd.execute("b", 0, "other_exp", "d")
    assert len(sent) == 2
    sent.clear()
    pair = _FakeNode("a", ["a", "b"], live=[])
    pair.state.secagg_priv = priv
    pair.state.secagg_pubs["b"] = node.state.secagg_pubs["b"]
    SecAggNeedCommand(pair).execute("b", 0, "exp", "b")
    assert sent == []


def test_masked_stack_keeps_the_weighted_fedavg():
    """The node-stacked masking: every slot drowned in noise, the weighted
    FedAvg unchanged (1e-3)."""
    n = 8
    gen = torch.Generator().manual_seed(0)
    stack = {"w": torch.randn((n, 32, 16), generator=gen)}
    weights = torch.tensor([10.0, 20.0, 30.0, 40.0, 10.0, 20.0, 30.0, 40.0])
    masked = secagg.masked_stack(stack, weights, 7)
    assert bool(((masked["w"] - stack["w"]).std(dim=(1, 2)) > 0.5).all())
    w = weights / weights.sum()
    np.testing.assert_allclose(torch.einsum("n,nij->ij", w, masked["w"]).numpy(),
                               torch.einsum("n,nij->ij", w, stack["w"]).numpy(), atol=1e-3)
    assert torch.equal(secagg.masked_stack(stack, weights, 7)["w"], masked["w"])  # one key, one mask


def test_shamir_split_reconstruct_roundtrip():
    secret = int.from_bytes(b"\x42" * 32, "big")
    shares = secagg.shamir_split(secret, n=5, t=3)
    assert len(shares) == 5 and len({x for x, _ in shares}) == 5
    for combo in itertools.combinations(shares, 3):
        assert secagg.shamir_reconstruct(list(combo)) == secret
    assert secagg.shamir_reconstruct(shares[:2]) != secret


def test_shamir_threshold_policy():
    for n in range(1, 40):
        assert secagg.share_threshold(n) == jsecagg.share_threshold(n)
    assert [secagg.share_threshold(n) for n in (2, 3, 4, 9)] == [1, 2, 3, 5]


def test_share_encryption_roundtrip_and_binding():
    key = 123456789
    y = secagg.SHAMIR_PRIME - 7
    ct = secagg.encrypt_share(y, key, 3, "a", "b")
    assert secagg.decrypt_share(ct, key, 3, "a", "b") == y
    assert secagg.decrypt_share(ct, key + 1, 3, "a", "b") != y
    assert secagg.decrypt_share(ct, key, 4, "a", "b") != y
    assert secagg.decrypt_share(ct, key, 3, "b", "a") != y
    assert secagg.encrypt_share(y, key, 3, "a", "b") != secagg.encrypt_share(y, key, 3, "b", "a")
    assert ct == jsecagg.encrypt_share(y, key, 3, "a", "b")  # the JAX package's bytes
    priv_a, pub_a = secagg.dh_keypair()
    priv_b, pub_b = secagg.dh_keypair()
    assert secagg.dh_share_key(priv_a, pub_b, "exp") != secagg.dh_pair_seed(priv_a, pub_b, "exp")
    assert secagg.dh_share_key(priv_a, pub_b, "exp") == secagg.dh_share_key(priv_b, pub_a, "exp")


def test_double_mask_cancels_with_self_seed_disclosure():
    """Σ w_i·masked_i − Σ w_i·STD·PRG_self(b_i) == Σ w_i·p_i (1e-2, the
    JAX test's bound on the fp32 sum)."""
    addrs = ["a", "b", "c"]
    keys = {n: secagg.dh_keypair() for n in addrs}
    privs = {n: k[0] for n, k in keys.items()}
    weights = {"a": 5, "b": 7, "c": 9}
    pubs = {n: (keys[n][1], weights[n]) for n in addrs}
    self_seeds = {n: pysecrets.randbits(256) for n in addrs}
    rng = np.random.default_rng(1)
    params = {n: _w(rng.normal(size=(8, 4))) for n in addrs}
    masked = {n: secagg.mask_update(ModelUpdate(params[n], [n], weights[n]), n, addrs, privs[n], pubs, "exp", 2,
                                    self_seed=self_seeds[n]) for n in addrs}
    pair_only = secagg.mask_update(ModelUpdate(params["a"], ["a"], weights["a"]), "a", addrs, privs["a"], pubs,
                                   "exp", 2)
    assert not np.allclose(_np(masked["a"].params["w"]), _np(pair_only.params["w"]))
    w_total = sum(weights.values())
    true_avg = sum(weights[n] * _np(params[n]["w"]) for n in addrs) / w_total
    avg = _w(sum(weights[n] * _np(masked[n].params["w"]).astype(np.float64) for n in addrs).astype(np.float32)
             / w_total)
    corr = secagg.self_mask_correction(avg, addrs, self_seeds, weights, round_no=2)
    clean = secagg.apply_dropout_correction(avg, corr, float(w_total))
    np.testing.assert_allclose(_np(clean["w"]), true_avg, atol=1e-2)


def test_double_mask_e2e_share_and_reveal_flow():
    """3 Nodes under double masking: the fleet converges (within 2e-3, the
    JAX test's), and every round each node distributes shares and
    reveals its seed."""
    Settings.AGGREGATION_TIMEOUT *= 3
    Settings.SECAGG_RECOVERY_TIMEOUT *= 3
    Settings.VOTE_TIMEOUT *= 3
    Settings.SECURE_AGGREGATION = True
    assert Settings.SECAGG_DOUBLE_MASK
    seen = {"secagg_share": 0, "secagg_reveal": 0}
    lock = threading.Lock()
    full = FederatedDataset.synthetic_mnist(n_train=192, n_test=64)
    nodes = []
    for i in range(3):
        n = Node(learner=TorchLearner(mlp(seed=i, device="cpu"), full.partition(i, 3), batch_size=32, seed=i))
        orig = n.protocol.broadcast

        def counting(msg, _orig=orig):
            with lock:
                if msg.cmd in seen:
                    seen[msg.cmd] += 1
            return _orig(msg)

        n.protocol.broadcast = counting
        n.start()
        nodes.append(n)
    try:
        for n in nodes:
            full_connection(n, nodes)
        wait_convergence(nodes, 2, only_direct=True)
        nodes[0].set_start_learning(rounds=2, epochs=1)
        wait_to_finish(nodes, timeout=120)
        p0 = tree_leaves(nodes[0].learner.get_parameters())
        for n in nodes[1:]:
            for a, b in zip(p0, tree_leaves(n.learner.get_parameters())):
                np.testing.assert_allclose(_np(a), _np(b), atol=2e-3)
        assert seen["secagg_share"] >= 3 and seen["secagg_reveal"] >= 3
    finally:
        for n in nodes:
            n.stop()


def test_dropped_node_self_seed_never_revealed():
    st = NodeState("a")
    st.set_experiment("exp", 1)
    st.train_set = ["a", "b", "c"]
    st.secagg_shares_held[(0, "b")] = (1, 12345)
    st.secagg_round_dropped.add((0, "b"))
    proto = _Proto()

    class _L:
        def get_parameters(self):
            return _w(np.zeros((2, 2)))

    class _FakeNode:
        addr = "a"
        state = st
        protocol = proto
        learner = _L()

        def learning_interrupted(self):
            return True

    out = GossipModelStage._secagg_self_unmask(_FakeNode(), ModelUpdate(_w(np.zeros((2, 2))), ["b", "c"], 2))
    assert not any(m[0] == "secagg_reveal" and m[1][1] == "b" for m in proto.sent)
    assert out.noop_round


def test_self_seed_shamir_reconstruction_for_crashed_contributor():
    """'d' double-masked and died: 'a' rebuilds b_d from its own share and
    two revealed ones, and strips the exact self-mask sum (1e-3)."""
    train = ["a", "b", "c", "d"]
    weights = {"a": 3, "b": 5, "c": 7, "d": 9}
    seeds = {n: pysecrets.randbits(256) for n in train}
    w_total = float(sum(weights.values()))
    template = _w(np.zeros((6, 4)))
    clean = np.full((6, 4), 0.25, np.float32)
    masked = clean.copy()
    for n in train:
        masked = masked + (weights[n] / w_total) * secagg.self_mask(template, seeds[n], 0)["w"]
    st = NodeState("a")
    st.set_experiment("exp", 1)
    st.round = 0
    st.train_set = list(train)
    st.secagg_samples = weights["a"]
    st.secagg_pubs = {n: (2, weights[n]) for n in ("b", "c", "d")}
    st.secagg_self_seed[0] = seeds["a"]
    st.secagg_share_reveals[(0, "b", "b")] = (0, seeds["b"])
    st.secagg_share_reveals[(0, "c", "c")] = (0, seeds["c"])
    shares = secagg.shamir_split(seeds["d"], 3, secagg.share_threshold(4))
    st.secagg_shares_held[(0, "d")] = shares[0]
    st.secagg_share_reveals[(0, "d", "b")] = shares[1]
    st.secagg_share_reveals[(0, "d", "c")] = shares[2]
    proto = _Proto()

    class _FakeNode:
        addr = "a"
        protocol = proto
        state = st
        learner = None

        def learning_interrupted(self):
            return False

    out = GossipModelStage._secagg_self_unmask(_FakeNode(), ModelUpdate(_w(masked), list(train), int(w_total)))
    assert not out.noop_round
    np.testing.assert_allclose(_np(out.params["w"]), clean, atol=1e-3)
    assert any(m[0] == "secagg_reveal" and m[1][1] == "a" for m in proto.sent)


def test_split_brain_rescue_adopts_finalized_diffusion():
    Settings.SECURE_AGGREGATION = True
    Settings.SECAGG_RECOVERY_TIMEOUT = 2.0
    train = ["a", "b", "c"]
    clean = _w(np.full((2, 2), 3.0))
    calls = {"waiting": None}

    class _Agg:
        def set_waiting_aggregated_model(self, nodes):
            calls["waiting"] = list(nodes)

        def wait_and_get_aggregation(self, timeout=None):
            return ModelUpdate(clean, list(train), 3, secagg_clean=True)

    st = NodeState("a")
    st.set_experiment("exp", 1)
    st.round = 0
    st.train_set = list(train)
    st.secagg_priv, _pub = secagg.dh_keypair()
    st.secagg_samples = 5
    for n in ("b", "c"):
        st.secagg_pubs[n] = (secagg.dh_keypair()[1], 5)

    class _FakeNode:
        addr = "a"
        state = st
        protocol = _Proto(live=["b", "c"])
        aggregator = _Agg()
        learner = None

        def learning_interrupted(self):
            return False

    agg = ModelUpdate(_w(np.zeros((2, 2))), ["a", "b"], 10)
    out = GossipModelStage._secagg_pair_recovery(_FakeNode(), agg)
    assert sorted(calls["waiting"]) == train
    assert out.secagg_clean and not out.noop_round
    np.testing.assert_array_equal(_np(out.params["w"]), 3.0)
    assert GossipModelStage._secagg_finalize(_FakeNode(), agg).secagg_clean


def test_single_member_train_set_double_mask_no_crash():
    Settings.SECURE_AGGREGATION = True
    node = Node(learner=DummyLearner(value=3.0, device="cpu"))
    node.start()
    try:
        node.set_start_learning(rounds=1, epochs=1)
        wait_to_finish([node], timeout=30)
        assert float(node.learner.get_parameters()["w"].mean()) == pytest.approx(4.0)
    finally:
        node.stop()


def test_secagg_mask_lone_member_direct_no_shamir_crash():
    st = NodeState("solo")
    st.train_set = {"solo"}
    st.round = 1
    st.experiment_name = "exp"
    st.secagg_priv, _pub = secagg.dh_keypair()

    class _NoSend(_Proto):
        def broadcast(self, msg):
            raise AssertionError("lone member must not distribute shares")

    class _FakeNode:
        addr = "solo"
        state = st
        protocol = _NoSend()

        def learning_interrupted(self):
            return False

    Settings.SECURE_AGGREGATION = True
    u = ModelUpdate(_w(np.ones((2, 2))), ["solo"], 10)
    out = TrainStage._secagg_mask(_FakeNode(), u)
    assert out is not None and torch.equal(out.params["w"], u.params["w"])


def _share_state(round_no=1):
    st = NodeState("me")
    st.round = round_no
    st.experiment_name = "exp"
    priv_o, pub_o = secagg.dh_keypair()
    st.secagg_priv, my_pub = secagg.dh_keypair()
    st.secagg_pubs["owner"] = (pub_o, 5)
    return st, secagg.dh_share_key(priv_o, my_pub, "exp")


def test_share_index_cap_derives_from_message():
    st, key = _share_state()
    st.train_set = {f"n{i}" for i in range(1500)} | {"me", "owner"}
    cmd = SecAggShareCommand(st)
    ct = secagg.encrypt_share(12345, key, 1, "owner", "me").hex()
    filler = [e for i in range(1399) for e in (f"n{i}", str(i + 1), "00")]
    cmd.execute("owner", 1, "exp", *filler, "me", "1400", ct)
    assert st.secagg_shares_held.get((1, "owner")) == (1400, 12345)
    st.secagg_shares_held.clear()
    cmd.execute("owner", 1, "exp", *filler, "me", "1401", ct)
    assert (1, "owner") not in st.secagg_shares_held


def test_share_for_next_round_accepted_before_train_set_latches():
    st, key = _share_state(round_no=1)
    st.train_set = set()
    cmd = SecAggShareCommand(st)
    ct = secagg.encrypt_share(777, key, 2, "owner", "me").hex()
    cmd.execute("owner", 2, "exp", "a", "1", "00", "me", "2", ct, "z", "3", "00")
    assert st.secagg_shares_held.get((2, "owner")) == (2, 777)
    st.secagg_shares_held.clear()
    cmd.execute("owner", 2, "exp", "a", "1", "00", "me", "4", ct, "z", "3", "00")
    assert (2, "owner") not in st.secagg_shares_held


def test_reveal_index_uncapped_for_large_federations():
    st = NodeState("me")
    st.round = 1
    st.experiment_name = "exp"
    members = sorted(f"n{i:04d}" for i in range(1500))
    st.train_set = list(members)
    owner = members[0]
    holders = sorted(m for m in members if m != owner)
    cmd = SecAggRevealCommand(st)
    cmd.execute(holders[1300], 1, "exp", owner, "1301", "ff")
    assert st.secagg_share_reveals.get((1, owner, holders[1300])) == (1301, 0xFF)
    cmd.execute(holders[10], 1, "exp", owner, "99", "ff")
    assert (1, owner, holders[10]) not in st.secagg_share_reveals


def test_early_reveal_stashed_then_promoted_once_set_latches():
    st = NodeState("me")
    st.round = 1
    st.experiment_name = "exp"
    st.train_set = ["me", "x"]
    cmd = SecAggRevealCommand(st)
    cmd.execute("b", 2, "exp", "a", "1", "aa")
    assert (2, "a", "b") not in st.secagg_share_reveals
    assert st.secagg_early_reveals.get((2, "a", "b")) == (1, 0xAA)
    cmd.execute("c", 2, "exp", "a", "7", "bb")
    st.round = 2
    st.train_set = ["a", "b", "c", "me"]
    promote_early_reveals(st)
    assert st.secagg_share_reveals.get((2, "a", "b")) == (1, 0xAA)
    assert (2, "a", "c") not in st.secagg_share_reveals
    assert not st.secagg_early_reveals


def test_stale_early_reveals_pruned():
    st = NodeState("me")
    st.round = 1
    st.experiment_name = "exp"
    st.train_set = ["me", "x"]
    SecAggRevealCommand(st).execute("b", 2, "exp", "a", "1", "aa")
    assert st.secagg_early_reveals
    st.round = 3
    st.train_set = ["a", "b", "me"]
    promote_early_reveals(st)
    assert not st.secagg_early_reveals and (2, "a", "b") not in st.secagg_share_reveals


# ---- the port against JAX on fixed keys ----


def _fixed_keys(addrs):
    """Deterministic DH pairs (priv from a seed, pub = g^priv mod p)."""
    rng = np.random.default_rng(11)
    privs = {n: int.from_bytes(rng.bytes(32), "big") for n in addrs}
    return privs, {n: pow(secagg.DH_GENERATOR, p, secagg.DH_PRIME) for n, p in privs.items()}


def test_constants_and_leaf_mask_bit_equal_to_jax():
    assert secagg.DH_PRIME == jsecagg.DH_PRIME and secagg.SHAMIR_PRIME == jsecagg.SHAMIR_PRIME
    assert secagg.CLEAN_MARKER == jsecagg.CLEAN_MARKER and secagg.SHARE_BYTES == jsecagg.SHARE_BYTES
    for seed, rnd, shape, li in ((123456789, 3, (4,), 1), (2**255 + 17, 0, (33, 7), 5), (9, 12, (), 0)):
        for domain in (b"p2pfl-secagg-mask\x00", b"p2pfl-secagg-self\x00"):
            a = secagg._leaf_mask(seed, rnd, shape, li, domain)
            b = jsecagg._leaf_mask(seed, rnd, shape, li, domain)
            assert a.dtype == b.dtype == np.float32 and a.tobytes() == b.tobytes()


def test_masks_and_corrections_equal_to_jax_on_fixed_keys():
    """pairwise_mask, mask_update (with a self seed), self_mask,
    self_mask_correction, dropout_correction and
    apply_dropout_correction: the JAX package's values bit for bit from
    the same keys, seeds and params."""
    addrs = ["10.0.0.1:1", "10.0.0.2:1", "10.0.0.3:1"]
    privs, pubs_int = _fixed_keys(addrs)
    weights = {"10.0.0.1:1": 5, "10.0.0.2:1": 7, "10.0.0.3:1": 9}
    pubs = {n: (pubs_int[n], weights[n]) for n in addrs}
    rng = np.random.default_rng(4)
    params_np = {"Dense_0": {"kernel": rng.normal(size=(6, 5)).astype(np.float32),
                             "bias": rng.normal(size=5).astype(np.float32)}}
    params_t = {"Dense_0": {k: torch.from_numpy(v.copy()) for k, v in params_np["Dense_0"].items()}}
    me = addrs[0]
    seeds = {n: secagg.dh_pair_seed(privs[me], pubs_int[n], "exp") for n in addrs[1:]}
    assert seeds == {n: jsecagg.dh_pair_seed(privs[me], pubs_int[n], "exp") for n in addrs[1:]}
    scales = {n: secagg.pair_scale(5, weights[n]) / 5 for n in addrs[1:]}
    for a, b in ((secagg.pairwise_mask(params_t, me, seeds, 2, scales), jsecagg.pairwise_mask(params_np, me, seeds, 2, scales)),
                 (secagg.self_mask(params_t, 99, 2), jsecagg.self_mask(params_np, 99, 2))):
        assert sorted(a) == sorted(b) and all(a[k].tobytes() == b[k].tobytes() for k in b)
    got = secagg.mask_update(ModelUpdate(params_t, [me], 5), me, addrs, privs[me], pubs, "exp", 2, self_seed=99)
    want = jsecagg.mask_update(JaxModelUpdate(params_np, [me], 5), me, addrs, privs[me], pubs, "exp", 2, self_seed=99)
    want_flat = {k: np.asarray(v) for k, v in jax_named_leaves(want.params)[1]}
    for k, v in tree_items(got.params):
        assert _np(v).tobytes() == want_flat[k].tobytes(), k
    pair_seeds = {(i, addrs[2]): secagg.dh_pair_seed(privs[i], pubs_int[addrs[2]], "exp") for i in addrs[:2]}
    a = secagg.dropout_correction(params_t, addrs[:2], addrs[2:], pair_seeds, weights, 1)
    b = jsecagg.dropout_correction(params_np, addrs[:2], addrs[2:], pair_seeds, weights, 1)
    assert all(a[k].tobytes() == b[k].tobytes() for k in b)
    c = secagg.self_mask_correction(params_t, addrs, {n: i + 1 for i, n in enumerate(addrs)}, weights, 1)
    d = jsecagg.self_mask_correction(params_np, addrs, {n: i + 1 for i, n in enumerate(addrs)}, weights, 1)
    assert all(c[k].tobytes() == d[k].tobytes() for k in d)
    fixed_t = secagg.apply_dropout_correction(params_t, a, 12.0)
    fixed_j = {k: np.asarray(v) for k, v in jax_named_leaves(jsecagg.apply_dropout_correction(params_np, b, 12.0))[1]}
    for k, v in tree_items(fixed_t):
        assert _np(v).tobytes() == fixed_j[k].tobytes(), k


def test_shamir_shares_cross_the_packages():
    secret = int.from_bytes(bytes(range(32)), "big")
    shares = secagg.shamir_split(secret, 5, 3)
    assert jsecagg.shamir_reconstruct(shares[1:4]) == secret
    assert secagg.shamir_reconstruct(jsecagg.shamir_split(secret, 5, 3)[:3]) == secret


@pytest.mark.parametrize("double_mask", [False, True])
def test_a_jax_node_and_a_port_node_federate_under_secure_aggregation(double_mask):
    """One Node of each package over loopback gRPC with
    SECURE_AGGREGATION on both, 2 rounds: DH keys, pair masks and (double
    masking) shares and reveals cross the packages. The port node ends on
    the FedAvg of the last round's unmasked contributions (1e-3); so does
    the JAX node with pair masks alone. Under double masking the JAX node
    is not held to it: when the port's finalized diffusion reaches it
    over gRPC before its own window closes, the JAX package's
    ``materialize`` returns a new update without ``secagg_clean`` and its
    finalize strips the self masks a second time (ROADMAP Queue C); the
    port keeps the flag through its decode."""
    Settings.SECURE_AGGREGATION = JaxSettings.SECURE_AGGREGATION = True
    Settings.SECAGG_DOUBLE_MASK = JaxSettings.SECAGG_DOUBLE_MASK = double_mask
    Settings.GRPC_TIMEOUT = JaxSettings.GRPC_TIMEOUT = 5.0
    recorded: dict = {}
    real_t, real_j = secagg.mask_update, jsecagg.mask_update

    def rec_t(update, my_addr, train_set, priv, pubs, experiment, round_no, **kw):
        recorded[(round_no, my_addr)] = ({k: _np(v).astype(np.float64) for k, v in tree_items(update.params)},
                                         update.num_samples)
        return real_t(update, my_addr, train_set, priv, pubs, experiment, round_no, **kw)

    def rec_j(update, my_addr, train_set, priv, pubs, experiment, round_no, **kw):
        recorded[(round_no, my_addr)] = ({k: np.asarray(v, np.float64) for k, v in jax_named_leaves(update.params)[1]},
                                         update.num_samples)
        return real_j(update, my_addr, train_set, priv, pubs, experiment, round_no, **kw)

    secagg.mask_update, jsecagg.mask_update = rec_t, rec_j
    jdata = JaxDataset.synthetic_mnist(n_train=512, n_test=64)
    tdata = FederatedDataset.synthetic_mnist(n_train=512, n_test=64)
    jnode = JaxNode(learner=JaxLearner(jax_mlp(seed=0), jdata.partition(0, 2), batch_size=64, seed=0),
                    protocol=jg.GrpcProtocol("127.0.0.1:0"))
    tnode = Node(learner=TorchLearner(mlp(seed=1, device="cpu"), tdata.partition(1, 2), batch_size=64, seed=1),
                 protocol=tg.GrpcProtocol("127.0.0.1:0"))
    jnode.start()
    tnode.start()
    try:
        assert tnode.connect(jnode.addr)
        deadline = time.monotonic() + 20
        while len(jnode.get_neighbors(only_direct=True)) < 1 or len(tnode.get_neighbors(only_direct=True)) < 1:
            assert time.monotonic() < deadline, "no handshake"
            time.sleep(0.05)
        tnode.set_start_learning(rounds=2, epochs=1)
        deadline = time.monotonic() + 120
        while not all(n.state.experiment_epoch >= 1 and n.state.round is None for n in (jnode, tnode)):
            assert time.monotonic() < deadline, "the mixed fleet did not finish"
            time.sleep(0.1)
    finally:
        secagg.mask_update, jsecagg.mask_update = real_t, real_j
        tnode.stop()
        jnode.stop()
    last = [c for (r, _a), c in recorded.items() if r == 1]
    assert len(last) == 2, sorted(recorded)
    total = sum(w for _p, w in last)
    want = {k: sum(w * p[k] for p, w in last) / total for k in last[0][0]}
    jflat = {k: np.asarray(v, np.float64) for k, v in jax_named_leaves(jnode.learner.get_parameters())[1]}
    tflat = {k: _np(v).astype(np.float64) for k, v in tree_items(tnode.learner.get_parameters())}
    for k in want:
        assert np.abs(tflat[k] - want[k]).max() <= 1e-3, k
        if not double_mask:
            assert np.abs(jflat[k] - want[k]).max() <= 1e-3, k


def test_spmd_federations_refuse_secure_aggregation():
    """One program on one device is one trust domain: both SPMD
    federations refuse SECURE_AGGREGATION with the JAX package's message
    instead of training unmasked."""
    from p2pfl_tpu_torch.models.transformer import TransformerConfig, tiny_transformer
    from p2pfl_tpu_torch.parallel import SpmdFederation, SpmdLoraFederation

    Settings.SECURE_AGGREGATION = True
    data = FederatedDataset.synthetic_mnist(n_train=64, n_test=16)
    with pytest.raises(ValueError, match="SECURE_AGGREGATION=True has no effect inside SpmdFederation"):
        SpmdFederation(mlp(seed=0, device="cpu"), [data.partition(i, 2) for i in range(2)], batch_size=8,
                       device="cpu")
    cfg = TransformerConfig(vocab_size=32, dim=32, n_layers=1, n_heads=2, n_kv_heads=1, ffn_hidden=32, lora_rank=2)
    lm = FederatedDataset.synthetic_lm(vocab_size=32, seq_len=16, n_train=8, n_test=4)
    with pytest.raises(ValueError, match="one trust domain"):
        SpmdLoraFederation.from_dataset(tiny_transformer(seq_len=16, cfg=cfg, device="cpu"), lm, n_nodes=2,
                                        batch_size=2, device="cpu")
