"""The port's ICI weights plane against the JAX package.

The transfer primitive with the plain version of kernel 9 (the CPU's
half of the wrapper), slice identity by mesh slot, the co-resident
handoff's read-only contract, per-peer fallbacks and failed transfers,
and a placed 2-node federation against the JAX placed federation of
``tests/test_ici_plane.py`` (model_parallel = 1) on the same seeds.
Kernel 9 itself runs only on a card: ``tests/test_torch_cuda_kernels.py``
and ``chip_smoke.py`` hold it against the plain version there.
"""

import jax
import numpy as np
import pytest
import torch

from p2pfl_tpu.communication import ici as jax_ici
from p2pfl_tpu.communication.memory import MemoryRegistry as JaxMemoryRegistry
from p2pfl_tpu.learning.dataset import FederatedDataset as JaxDataset
from p2pfl_tpu.learning.learner import JaxLearner
from p2pfl_tpu.models.base import FlaxModel
from p2pfl_tpu.models.vision import MLP as JaxMLP
from p2pfl_tpu.node import Node as JaxNode
from p2pfl_tpu.parallel.mesh import node_slices as jax_node_slices
from p2pfl_tpu.parallel.mesh import submesh_federation_mesh as jax_submesh_federation_mesh
from p2pfl_tpu.settings import Settings as JaxSettings
from p2pfl_tpu.utils import full_connection as jax_full_connection
from p2pfl_tpu.utils import wait_convergence as jax_wait_convergence
from p2pfl_tpu.utils import wait_to_finish as jax_wait_to_finish
from p2pfl_tpu_torch.communication import ici
from p2pfl_tpu_torch.communication.memory import MemoryRegistry
from p2pfl_tpu_torch.convert import params_from_jax, params_to_jax
from p2pfl_tpu_torch.learning.dataset import FederatedDataset
from p2pfl_tpu_torch.learning.learner import DummyLearner, TorchLearner
from p2pfl_tpu_torch.management.logger import logger
from p2pfl_tpu_torch.models.base import TorchModel
from p2pfl_tpu_torch.models.vision import MLP, mlp
from p2pfl_tpu_torch.node import Node, stop_leaked_nodes
from p2pfl_tpu_torch.ops import _kernels
from p2pfl_tpu_torch.ops.tree import tree_items, tree_leaves, tree_map
from p2pfl_tpu_torch.parallel import ici_plane
from p2pfl_tpu_torch.parallel.mesh import node_slices, submesh_federation_mesh
from p2pfl_tpu_torch.settings import Settings, set_test_settings
from p2pfl_tpu_torch.utils import full_connection, wait_convergence, wait_to_finish

torch.set_num_threads(2)

LR = 1e-3
# the JAX test's rules, on a (data, model) slice of size (1, 1)
JAX_MLP_RULES = (
    (r"Dense_0/kernel", (None, "model")),
    (r"Dense_1/kernel", ("model", None)),
    (r"Dense_2/kernel", (None, "model")),
    (r".*", ()),
)


@pytest.fixture(autouse=True)
def _port_env():
    set_test_settings()
    logger.set_level("INFO")
    MemoryRegistry.reset()
    JaxMemoryRegistry.reset()
    ici.ShardPlaneRegistry.reset()
    ici.reset_ici_stats()
    jax_ici.ShardPlaneRegistry.reset()
    yield
    stop_leaked_nodes()
    MemoryRegistry.reset()
    JaxMemoryRegistry.reset()
    ici.ShardPlaneRegistry.reset()
    jax_ici.ShardPlaneRegistry.reset()
    Settings.WEIGHTS_PLANE = "bytes"
    JaxSettings.WEIGHTS_PLANE = "bytes"


def _two_cpu_slices():
    return node_slices(submesh_federation_mesh(2, devices=["cpu", "cpu"]))


def _bits(t):
    """A tensor's bits as integers (bit-exact comparison, bf16 included)."""
    return t.reshape(-1).view(torch.int16 if t.element_size() == 2 else torch.int32)


def _tree(seed=0):
    """fp32 and bf16 leaves, odd sizes, nested."""
    rng = np.random.default_rng(seed)
    return {
        "Dense_0": {
            "kernel": torch.from_numpy(rng.normal(size=(7, 5)).astype(np.float32)),
            "bias": torch.from_numpy(rng.normal(size=(5,)).astype(np.float32)),
        },
        "emb": torch.from_numpy(rng.normal(size=(3, 11)).astype(np.float32)).to(torch.bfloat16),
        "scalar": torch.tensor(1.5),
    }


# ---- the transfer primitive ----


def test_shard_transfer_plain_bit_exact_under_receiver_slice():
    """Two slots of ["cpu", "cpu"]: every leaf arrives bit for bit, in
    fresh buffers on the receiver's slice, and the filler (the receiver's
    live model) is not written."""
    a, b = _two_cpu_slices()
    tree = _tree(0)
    filler = _tree(1)
    filler_before = {k: v.clone() for k, v in tree_items(filler)}
    src = ici_plane.slice_info_of(tree, a)
    dst = ici_plane.slice_info_of(filler, b)
    assert ici_plane.transfer_compatible(src, dst) and not ici_plane.same_devices(src, dst)
    out = ici_plane.shard_transfer(tree, filler, src, dst)
    assert ici_plane.slice_info_of(out, b) is not None
    for (ka, x), (kb, y), (_, f) in zip(tree_items(tree), tree_items(out), tree_items(filler)):
        assert ka == kb and x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(_bits(x), _bits(y))
        assert y.data_ptr() not in (x.data_ptr(), f.data_ptr())
    for k, v in tree_items(filler):
        assert torch.equal(_bits(v), _bits(filler_before[k]))
    # the tensors lie on the CPU, so the plain version served the exchange
    assert _kernels._lib is None and _kernels.LAUNCHES["ici_exchange"] == 0


def test_shard_transfer_refuses_mismatches():
    a, b = _two_cpu_slices()
    tree = _tree(0)
    src = ici_plane.slice_info_of(tree, a)
    with pytest.raises(ValueError, match="transfer-compatible"):
        ici_plane.shard_transfer(tree, _tree(1), src, src)
    other = _tree(1)
    other["extra"] = torch.zeros(2)
    with pytest.raises(ValueError, match="structure"):
        ici_plane.shard_transfer(tree, other, src, ici_plane.slice_info_of(other, b))


def test_slice_identity_is_by_slot_not_device():
    """Every slot names the CPU, yet two nodes' slices are disjoint; a
    slice is the same as itself; learners without a mesh on one device
    share a slice (co-resident); a slice of another shape is incompatible."""
    a, b = _two_cpu_slices()
    tree = _tree(0)
    ia, ib = ici_plane.slice_info_of(tree, a), ici_plane.slice_info_of(tree, b)
    assert ia.device == ib.device == torch.device("cpu")
    assert not (ia.device_ids & ib.device_ids)
    assert ici_plane.same_devices(ia, ici_plane.slice_info_of(_tree(2), a))
    assert ici_plane.same_devices(ici_plane.slice_info_of(tree), ici_plane.slice_info_of(_tree(3)))
    wide = node_slices(submesh_federation_mesh(1, model_parallel=2, devices=["cpu", "cpu"]))[0]
    assert ici_plane.slice_info_of(tree, wide) is None  # one-slot slices only
    three = node_slices(submesh_federation_mesh(3, devices=["cpu"] * 3))
    assert ici_plane.transfer_compatible(ia, ici_plane.slice_info_of(tree, three[2]))


def test_slice_info_of_rejections():
    a, _ = _two_cpu_slices()
    assert ici_plane.slice_info_of({"w": np.arange(4.0)}) is None  # host arrays
    mixed = {"a": torch.zeros(2), "b": torch.zeros(2, device="meta")}
    assert ici_plane.slice_info_of(mixed) is None  # leaves on two devices
    assert ici_plane.slice_info_of({"w": torch.zeros(2, device="meta")}, a) is None  # off the slice
    assert ici_plane.slice_info_of({}) is None
    info = ici_plane.slice_info_of(_tree(0), a)
    assert info.shape == (1, 1) and all(s == ici_plane.REPLICATED for s in info.specs)
    assert ici_plane.tree_device_bytes(_tree(0)) == (35 + 5 + 1) * 4 + 33 * 2


def test_kernel_wrapper_takes_only_card_tensors():
    """The plain version serves CPU tensors because they lie on the CPU;
    the kernel's wrapper refuses them (and built nothing)."""
    src, dst = [torch.arange(6.0)], [torch.empty(6)]
    with pytest.raises(ValueError, match="CUDA"):
        _kernels.ici_exchange(src, dst)
    ici_plane.exchange(src, dst)
    assert torch.equal(src[0], dst[0])
    assert _kernels._lib is None and _kernels.LAUNCHES["ici_exchange"] == 0


# ---- the plane (communication/ici.py) ----


def _learner_node(seed=0, mesh=None, value=None):
    if value is not None:
        learner = DummyLearner(value=value, device="cpu")
        learner.mesh = mesh
    else:
        learner = TorchLearner(
            mlp(seed=seed, device="cpu"),
            FederatedDataset.synthetic_mnist(n_train=64, n_test=16, seed=seed), batch_size=16, mesh=mesh,
        )
    node = Node(learner=learner)
    node.start()
    return node


def _capture(node) -> dict:
    """Record what the plane delivers to ``node`` instead of dispatching it."""
    got: dict = {}

    class _Ok:
        ok = True

    def handle(env):
        got["env"] = env
        return _Ok()

    node.protocol.handle_weights = handle
    return got


def _send(src_node, dst_node, update):
    env = src_node.protocol.build_weights("add_model", 0, update)
    return ici.try_shard_send(src_node.protocol, dst_node.addr, env)


def test_co_resident_handoff_moves_zero_bytes_and_stays_read_only():
    """Two learners without a mesh on the CPU share one slice: the plane
    hands the sender's own tensors over (0 bytes moved), and the
    receiver training on them leaves the sender's tensors unchanged."""
    Settings.WEIGHTS_PLANE = "ici"
    sender, receiver = _learner_node(0), _learner_node(1)
    sender.connect(receiver.addr)
    got = _capture(receiver)
    params = sender.learner.get_parameters()
    before = {k: v.clone() for k, v in tree_items(params)}
    assert _send(sender, receiver, sender.learner.get_model_update()) is True
    stats = ici.ici_stats()
    assert stats["shard_sends"] == 1 and stats["bytes_moved"] == 0 and stats["fallback_bytes"] == 0
    delivered = got["env"].update.params
    assert delivered["Dense_0"]["kernel"] is params["Dense_0"]["kernel"]
    receiver.learner.set_parameters(delivered)
    receiver.learner.fit()
    assert not torch.equal(receiver.learner.get_parameters()["Dense_0"]["kernel"], before["Dense_0/kernel"])
    for k, v in tree_items(params):
        assert torch.equal(v, before[k])


def test_disjoint_slots_transfer_and_fallbacks():
    """Disjoint slots of the CPU: a real transfer (bytes counted, fresh
    buffers); an unregistered peer, an architecture mismatch and a CPU/card
    slice pair fall back loudly per peer; a dead peer is left to the
    transport."""
    Settings.WEIGHTS_PLANE = "ici"
    a, b = _two_cpu_slices()
    sender, receiver = _learner_node(0, a), _learner_node(1, b)
    got = _capture(receiver)
    update = sender.learner.get_model_update()
    assert _send(sender, receiver, update) is True
    assert ici.ici_stats()["bytes_moved"] == ici_plane.tree_device_bytes(update.params) > 0
    for (_, x), (_, y) in zip(tree_items(update.params), tree_items(got["env"].update.params)):
        assert torch.equal(x, y) and x.data_ptr() != y.data_ptr()
    assert got["env"].update.sp == ((1, 1), -1, "none")

    stranger = _learner_node(2, value=0.0)  # DummyLearner: another architecture
    assert _send(sender, stranger, update) is None
    ici.ShardPlaneRegistry.unregister(stranger.addr)
    assert _send(sender, stranger, update) is None
    assert ici.ici_stats()["fallback_bytes"] == 2
    receiver._running = False
    assert _send(sender, receiver, update) is None  # dead: the transport fails it
    receiver._running = True
    assert ici.ici_stats()["fallback_bytes"] == 2


def test_failed_transfer_fails_the_send_loudly(monkeypatch, caplog):
    """A transfer that raises (a kernel that does not build or launch) is
    one failed send with an "ICI shard transfer ... failed" log line,
    never a silent success."""
    Settings.WEIGHTS_PLANE = "ici"
    a, b = _two_cpu_slices()
    sender, receiver = _learner_node(0, a), _learner_node(1, b)

    def broken(*args, **kwargs):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(ici, "shard_transfer", broken)
    messages = []
    monkeypatch.setattr(logger, "error", lambda node, msg: messages.append(msg))
    assert _send(sender, receiver, sender.learner.get_model_update()) is False
    assert any(m.startswith(f"ICI shard transfer to {receiver.addr} failed") for m in messages)
    assert ici.ici_stats()["shard_sends"] == 0


# ---- the placed federation against JAX ----


def _jax_placed_fleet(n, rounds):
    JaxSettings.ROUND_FUSED = False
    JaxSettings.WEIGHTS_PLANE = "ici"
    full = JaxDataset.synthetic_mnist(n_train=n * 64, n_test=64, seed=0)
    slices = jax_node_slices(jax_submesh_federation_mesh(n, model_parallel=1, devices=jax.devices()[:n]))
    nodes = [
        JaxNode(learner=JaxLearner(
            FlaxModel.create(JaxMLP(), (28, 28, 1), seed=i), full.partition(i, n), batch_size=16,
            seed=i, mesh=slices[i], partition_rules=JAX_MLP_RULES,
        ))
        for i in range(n)
    ]
    try:
        for node in nodes:
            node.start()
        for node in nodes:
            jax_full_connection(node, nodes)
        jax_wait_convergence(nodes, n - 1, only_direct=True, wait=15)
        jax_ici.reset_ici_stats()
        nodes[0].set_start_learning(rounds=rounds, epochs=1)
        jax_wait_to_finish(nodes, timeout=90)
        assert jax_ici.ici_stats()["bytes_moved"] > 0
        return [jax.tree.map(np.asarray, node.learner.get_parameters()) for node in nodes]
    finally:
        for node in nodes:
            node.stop()


def test_ici_placed_federation_matches_jax(monkeypatch):
    """2 nodes on disjoint slots of ["cpu", "cpu"], WEIGHTS_PLANE="ici",
    2 rounds: the plane moved real bytes with zero fallbacks and zero
    alignment fix-ups, the fleet ends on one model (≤1e-5), and each node
    matches the JAX placed federation (model_parallel = 1) on the same
    seeds: every element within 2·lr·steps (Adam turns rounding-level
    gradient differences into up to a step either way), mean under 5e-4
    (bf16 compute; the 2-node memory federation measured 9e-5)."""
    jax_params = _jax_placed_fleet(2, rounds=2)

    errors: list = []
    real_error = logger.error
    monkeypatch.setattr(logger, "error", lambda node, msg: (errors.append(msg), real_error(node, msg)))
    Settings.WEIGHTS_PLANE = "ici"
    slices = _two_cpu_slices()
    full = FederatedDataset.synthetic_mnist(n_train=2 * 64, n_test=64, seed=0)
    nodes = []
    for i in range(2):
        jinit = jax.tree.map(np.asarray, FlaxModel.create(JaxMLP(), (28, 28, 1), seed=i).params)
        model = TorchModel(MLP(), params_from_jax(jinit, device="cpu"), (28, 28, 1))
        nodes.append(Node(learner=TorchLearner(model, full.partition(i, 2), batch_size=16, seed=i, mesh=slices[i])))
    for node in nodes:
        node.start()
    for node in nodes:
        full_connection(node, nodes)
    wait_convergence(nodes, 1, only_direct=True, wait=15)
    nodes[0].set_start_learning(rounds=2, epochs=1)
    wait_to_finish(nodes, timeout=60)
    stats = ici.ici_stats()
    assert stats["shard_sends"] > 0 and stats["bytes_moved"] > 0
    assert stats["fallback_bytes"] == 0 and stats["align_violations"] == 0
    assert not [m for m in errors if m.startswith("ICI shard transfer")]
    port_params = [params_to_jax(n.learner.get_parameters()) for n in nodes]
    for other in port_params[1:]:
        for x, y in zip(jax.tree.leaves(port_params[0]), jax.tree.leaves(other)):
            np.testing.assert_allclose(y, x, atol=1e-5, rtol=0)
    steps = 2 * 4  # 2 rounds of 64 samples at batch 16
    for jp, tp in zip(jax_params, port_params):
        diffs = [np.abs(np.asarray(x, np.float32) - y) for x, y in zip(jax.tree.leaves(jp), jax.tree.leaves(tp))]
        assert max(d.max() for d in diffs) <= 2 * LR * steps
        assert np.mean([d.mean() for d in diffs]) <= 5e-4
    for node in nodes:
        node.stop()


def _pair_leaves(plane: str) -> list:
    """``examples/mnist.py``'s path with 2 nodes on disjoint CPU slots,
    equal shards, 2 rounds: each node's final leaves as fp32."""
    from p2pfl_tpu_torch.examples import mnist as example

    out = example.run(nodes=2, rounds=2, samples=256, batch_size=32, device="cpu",
                      weights_plane=plane, topology="full", timeout=60)
    return [[x.float() for x in tree_leaves(p)] for p in out["params"]]


def _max_gap(a: list, b: list) -> float:
    return max((x - y).abs().max().item() for la, lb in zip(a, b) for x, y in zip(la, lb))


def test_two_node_planes_agree_bit_for_bit_and_a_wrong_delivery_does_not(monkeypatch):
    """Two nodes with equal shards: FedAvg of two halves is exact in either
    arrival order, so the bytes and ICI runs end bit-equal (gap 0). The
    control: the same ICI run with a delivery that hands each receiver
    its own model (the filler) instead of the sender's ends far apart
    (above 1e-3: each node keeps its own model)."""
    byt = _pair_leaves("bytes")
    ici.reset_ici_stats()
    via_ici = _pair_leaves("ici")
    stats = ici.ici_stats()
    assert stats["shard_sends"] > 0 and stats["bytes_moved"] > 0 and stats["fallback_bytes"] == 0
    assert _max_gap(byt, via_ici) == 0.0
    assert _max_gap(via_ici[:1], via_ici[1:]) == 0.0

    monkeypatch.setattr(ici, "shard_transfer", lambda tree, filler, src, dst: tree_map(torch.clone, filler))
    wrong = _pair_leaves("ici")
    assert _max_gap(byt, wrong) > 1e-3
    assert _max_gap(wrong[:1], wrong[1:]) > 1e-3


def test_plane_counters_lose_no_update_under_threads():
    """The plane's stats, the comm counters and the kernels' launch counts
    are read-modify-writes hit from every gossip worker: 16 threads, a
    1 µs switch interval, no lost increment."""
    import sys
    import threading

    from p2pfl_tpu_torch.management.telemetry import telemetry

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(2000):
                ici._count("shard_sends")
                telemetry.inc("comm", "stress", "ici_send_shard")
                _kernels._check("ici_exchange", 0)  # a launch that returned cudaSuccess

        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(prev)
    assert ici.ici_stats()["shard_sends"] == 16 * 2000
    assert telemetry.counters("comm", "stress")["ici_send_shard"] == 16 * 2000
    assert _kernels.LAUNCHES["ici_exchange"] == 16 * 2000
    telemetry.reset_counters("comm")
    _kernels.reset_launches()
