"""The port's gRPC transport against the JAX package's, on loopback.

Frames (the native envelope and the reference's protobuf interop
schema) are byte-identical from both packages and decode both ways;
address parsing and the optional-header registry agree; two port nodes
federate over real sockets; a JAX ``Node`` and a port ``Node`` federate
with each other, each initiating once; a mismatched architecture stops
the receiving node; streams cross the packages both ways, and a peer with
streaming off forces the counted unary fallback; the ICI plane carries
the weights between gRPC nodes of one process; and the two-process demo
(``examples/node1.py``, ``node2.py``) runs on ``--device cpu``.

Every test binds ``127.0.0.1:0`` only and runs under its own deadline
(``_deadline``: SIGALRM on the main thread), and each wait inside is
bounded. Federations compare the nodes' final fp32 params within 1e-5
(the two packages' FedAvg round differently in the last ulp at most).
"""

import ast
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from p2pfl_tpu.communication import grpc_transport as jg
from p2pfl_tpu.communication import proto_wire as jpw
from p2pfl_tpu.communication import wire_headers as jwh
from p2pfl_tpu.communication.address import parse_address as jax_parse_address
from p2pfl_tpu.communication.message import Message as JaxMessage
from p2pfl_tpu.communication.message import WeightsEnvelope as JaxWeightsEnvelope
from p2pfl_tpu.learning.dataset import FederatedDataset as JaxDataset
from p2pfl_tpu.learning.learner import JaxLearner
from p2pfl_tpu.learning.weights import ModelUpdate as JaxModelUpdate
from p2pfl_tpu.learning.weights import named_leaves as jax_named_leaves
from p2pfl_tpu.models import mlp as jax_mlp
from p2pfl_tpu.node import Node as JaxNode
from p2pfl_tpu.settings import Settings as JaxSettings
from p2pfl_tpu_torch.communication import grpc_transport as tg
from p2pfl_tpu_torch.communication import ici
from p2pfl_tpu_torch.communication import proto_wire as tpw
from p2pfl_tpu_torch.communication import wire_headers as twh
from p2pfl_tpu_torch.communication.address import parse_address
from p2pfl_tpu_torch.communication.message import Message, WeightsEnvelope
from p2pfl_tpu_torch.learning import weights as tw
from p2pfl_tpu_torch.learning.dataset import FederatedDataset
from p2pfl_tpu_torch.learning.learner import TorchLearner
from p2pfl_tpu_torch.management.logger import logger
from p2pfl_tpu_torch.models.vision import mlp
from p2pfl_tpu_torch.node import Node, stop_leaked_nodes
from p2pfl_tpu_torch.ops import _kernels
from p2pfl_tpu_torch.ops.tree import tree_items
from p2pfl_tpu_torch.parallel.mesh import node_slices, submesh_federation_mesh
from p2pfl_tpu_torch.settings import Settings, set_test_settings
from p2pfl_tpu_torch.utils import wait_convergence, wait_to_finish

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "p2pfl_tpu_torch"
DEADLINE_S = 150  # per test: every wait inside is bounded well below it
TOL = 1e-5


@pytest.fixture(autouse=True)
def _deadline():
    """Fail a test that outlives DEADLINE_S instead of hanging the run."""
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
def _port_env():
    set_test_settings()
    # a federation of real sockets on a loaded host: a call may wait
    # longer than the test preset's half second
    Settings.GRPC_TIMEOUT = JaxSettings.GRPC_TIMEOUT = 5.0
    logger.set_level("INFO")
    ici.ShardPlaneRegistry.reset()
    ici.reset_ici_stats()
    yield
    stop_leaked_nodes()
    ici.ShardPlaneRegistry.reset()


# ---- frames ----


def _msg_pair(**kw):
    args = dict(source="127.0.0.1:5000", cmd="vote_train_set", args=("a", "1", "b", "2"), round=3, ttl=7,
                msg_id="abc123", **kw)
    return Message(**args), JaxMessage(**args)


@pytest.mark.parametrize("optional", [{}, {"trace_ctx": ("t1", "s1"), "xp": "exp42"}])
def test_message_envelopes_are_byte_identical(optional):
    port, jax_msg = _msg_pair(**optional)
    frame = tg.encode_message(port)
    assert frame == jg.encode_message(jax_msg)
    assert tg.decode_message(frame) == port
    assert jg.decode_message(frame) == jax_msg


def _weights_pair(payload: bytes, optional: bool):
    extra = dict(version=("n1", 4, 2), xp="exp42", sp=((1,), 3, "none")) if optional else {}
    port = WeightsEnvelope("src:1", 2, "add_model",
                           tw.ModelUpdate(None, ["n1", "n2"], 42, encoded=payload, **extra),
                           msg_id="id9", trace_ctx=("t", "s") if optional else None)
    jax_env = JaxWeightsEnvelope("src:1", 2, "add_model",
                                 JaxModelUpdate(None, ["n1", "n2"], 42, encoded=payload, **extra),
                                 msg_id="id9", trace_ctx=("t", "s") if optional else None)
    return port, jax_env


@pytest.mark.parametrize("optional", [False, True])
def test_weights_envelopes_are_byte_identical_and_cross_decode(optional):
    payload = tw.encode_params({"w": torch.arange(6.0).reshape(2, 3)})
    port, jax_env = _weights_pair(payload, optional)
    frame = tg.encode_weights(port)
    assert frame == jg.encode_weights(jax_env)
    assert tg.encode_weights(port, payload=b"") == jg.encode_weights(jax_env, payload=b"")
    for env in (tg.decode_weights(frame), jg.decode_weights(frame)):
        assert (env.source, env.round, env.cmd, env.msg_id) == ("src:1", 2, "add_model", "id9")
        assert env.update.contributors == ["n1", "n2"] and env.update.num_samples == 42
        assert env.update.encoded == payload and env.update.params is None
        assert env.update.version == (("n1", 4, 2) if optional else None)
        assert env.update.sp == (((1,), 3, "none") if optional else None)
        assert env.trace_ctx == (("t", "s") if optional else None)


def test_protobuf_frames_are_byte_identical_and_cross_decode():
    payload = tw.encode_params({"w": torch.ones(4)})
    port, jax_msg = _msg_pair()
    assert tpw.encode_message_pb(port) == jpw.encode_message_pb(jax_msg)
    frame = tpw.encode_message_pb(port)
    assert tpw.decode_message_pb(frame).msg_id == jpw.decode_message_pb(frame).msg_id
    assert tpw.decode_message_pb(frame).args == port.args
    penv, jenv = _weights_pair(payload, optional=False)
    wframe = tpw.encode_weights_pb(penv)
    assert wframe == jpw.encode_weights_pb(jenv)
    assert tpw.decode_weights_pb(wframe).update.encoded == payload
    assert jpw.decode_weights_pb(wframe).update.encoded == payload
    assert tpw.encode_handshake_pb("127.0.0.1:1") == jpw.encode_handshake_pb("127.0.0.1:1")
    for ok, err in ((True, ""), (False, "boom")):
        assert tpw.encode_response_pb(ok, err) == jpw.encode_response_pb(ok, err)
        assert tpw.decode_response_ok_pb(jpw.encode_response_pb(ok, err)) is ok
    # the sniffers agree on every frame kind of both formats
    frames = [frame, wframe, tg.encode_message(port), tg.encode_weights(penv), b"127.0.0.1:1",
              tpw.encode_handshake_pb("127.0.0.1:1"), b""]
    for f in frames:
        assert tpw.is_protobuf_message(f) == jpw.is_protobuf_message(f)
        assert tpw.is_protobuf_weights(f) == jpw.is_protobuf_weights(f)
        assert tpw.is_protobuf_handshake(f) == jpw.is_protobuf_handshake(f)
    with pytest.raises(ValueError, match="P2TW"):
        tpw.decode_weights_pb(tpw.pb.Weights(source="x", weights=b"\x80\x04pickle").SerializeToString())


@pytest.mark.parametrize(
    "addr", ["127.0.0.1:5555", "localhost:80", "[::1]:7000", "unix:/tmp/p2pfl.sock", "10.0.0.1:1"]
)
def test_address_parsing_matches_jax(addr):
    assert parse_address(addr).__dict__ == jax_parse_address(addr).__dict__


@pytest.mark.parametrize("addr", [None, "", "127.0.0.1", "127.0.0.1:0"])
def test_free_port_addresses_match_jax_but_the_port(addr):
    got, want = parse_address(addr), jax_parse_address(addr)
    assert (got.kind, got.host) == (want.kind, want.host) and got.port > 0
    with pytest.raises(ValueError):
        parse_address("no:such:thing:")


def test_wire_header_registry_matches_jax_and_each_leg_holds():
    """The registry is JAX's, and each declared key keeps its contract in
    the port's codec files: a guarded store in the encoders, a ``.get``
    in the decoders, its attributes copied by the memory byte path, and
    never a mention in the protobuf interop codec."""
    assert twh.OPTIONAL_WIRE_HEADERS == tuple(
        twh.WireHeader(h.key, h.planes, h.memory_copies, h.doc) for h in jwh.OPTIONAL_WIRE_HEADERS
    )
    grpc_src = (PKG / "communication" / "grpc_transport.py").read_text()
    memory_src = (PKG / "communication" / "memory.py").read_text()
    proto_src = (PKG / "communication" / "proto_wire.py").read_text()
    tree = ast.parse(memory_src)
    rewrap = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == "_wire_envelope")
    kwargs = {(c.func.id, k.arg) for c in ast.walk(rewrap) if isinstance(c, ast.Call)
              and isinstance(c.func, ast.Name) for k in c.keywords}
    for h in twh.OPTIONAL_WIRE_HEADERS:
        assert f'd["{h.key}"] = ' in grpc_src, h.key
        assert f'd.get("{h.key}")' in grpc_src, h.key
        assert f'"{h.key}"' not in proto_src, h.key
        for ctor, kwarg in h.memory_copies:
            assert (ctor, kwarg) in kwargs, (h.key, ctor, kwarg)


# ---- federations over real sockets ----


def _port_grpc_node(seed: int, part: int, data, n: int = 2, device="cpu", **learner_kw) -> Node:
    learner = TorchLearner(mlp(seed=seed, device=device, **learner_kw), data.partition(part, n),
                           batch_size=64, seed=part)
    node = Node(learner=learner, protocol=tg.GrpcProtocol("127.0.0.1:0"))
    node.start()
    return node


def _jax_grpc_node(seed: int, part: int, data, n: int = 2) -> JaxNode:
    node = JaxNode(learner=JaxLearner(jax_mlp(seed=seed), data.partition(part, n), batch_size=64, seed=part),
                   protocol=jg.GrpcProtocol("127.0.0.1:0"))
    node.start()
    return node


def _jax_flat(params) -> dict:
    return {k: np.asarray(v, dtype=np.float32) for k, v in jax_named_leaves(params)[1]}


def _port_flat(params) -> dict:
    return {k: v.float().cpu().numpy() for k, v in tree_items(params)}


def _wait_handshake(jnode, tnode) -> None:
    deadline = time.monotonic() + 20
    while len(jnode.get_neighbors(only_direct=True)) < 1 or len(tnode.get_neighbors(only_direct=True)) < 1:
        assert time.monotonic() < deadline, "no handshake"
        time.sleep(0.05)


def _max_gap(a: dict, b: dict) -> float:
    assert sorted(a) == sorted(b)
    return max(float(np.abs(a[k] - b[k]).max()) for k in a)


def _run(nodes, initiator, rounds: int = 2, timeout: float = 90):
    wait_convergence(nodes, len(nodes) - 1, only_direct=True, wait=20)
    initiator.set_start_learning(rounds=rounds, epochs=1)
    wait_to_finish(nodes, timeout=timeout)


def test_two_port_nodes_federate_over_grpc():
    data = FederatedDataset.synthetic_mnist(n_train=512, n_test=64)
    a, b = _port_grpc_node(0, 0, data), _port_grpc_node(1, 1, data)
    try:
        assert b.connect(a.addr)
        _run([a, b], a)
        gap = _max_gap(_port_flat(a.learner.get_parameters()), _port_flat(b.learner.get_parameters()))
        assert gap <= TOL
        assert a.learner.evaluate()["test_acc"] > 0.5
        for node in (a, b):
            stats = node.protocol.wire_stats
            assert stats["weights_bytes"] > 0 and stats["weights_msgs"] > 0 and stats["control_msgs"] > 0
            assert stats["stream_sends"] == 0  # the MLP (0.94 MB) is under the 8 MB threshold
    finally:
        a.stop()
        b.stop()


@pytest.mark.parametrize("initiator", ["jax", "port"])
def test_a_jax_node_and_a_port_node_federate(initiator):
    """One Node of each package over loopback gRPC, 2 rounds of the MLP:
    init, votes, partial aggregates and diffusion cross the packages in
    the native envelope and P2TW frames, and both end on one model."""
    jdata = JaxDataset.synthetic_mnist(n_train=512, n_test=64)
    tdata = FederatedDataset.synthetic_mnist(n_train=512, n_test=64)
    jnode = _jax_grpc_node(0, 0, jdata)
    tnode = _port_grpc_node(1, 1, tdata)
    try:
        assert tnode.connect(jnode.addr)
        _wait_handshake(jnode, tnode)
        (jnode if initiator == "jax" else tnode).set_start_learning(rounds=2, epochs=1)
        deadline = time.monotonic() + 90
        while not all(n.state.experiment_epoch >= 1 and n.state.round is None for n in (jnode, tnode)):
            assert time.monotonic() < deadline, "the mixed fleet did not finish"
            time.sleep(0.1)
        gap = _max_gap(_jax_flat(jnode.learner.get_parameters()), _port_flat(tnode.learner.get_parameters()))
        assert gap <= TOL
        assert tnode.learner.evaluate()["test_acc"] > 0.5
        assert tnode.protocol.wire_stats["weights_bytes"] > 0 and jnode.protocol.wire_stats["weights_bytes"] > 0
    finally:
        tnode.stop()
        jnode.stop()


def test_a_mismatched_architecture_stops_the_receiving_node():
    data = FederatedDataset.synthetic_mnist(n_train=256, n_test=32)
    a = _port_grpc_node(0, 0, data)
    b = _port_grpc_node(1, 1, data, num_classes=4)
    try:
        assert b.connect(a.addr)
        wait_convergence([a, b], 1, only_direct=True, wait=20)
        a.set_start_learning(rounds=1, epochs=1)
        deadline = time.monotonic() + 30
        while b.is_running() and time.monotonic() < deadline:
            time.sleep(0.1)
        assert not b.is_running()
    finally:
        a.stop()
        b.stop()


def _stream_pair(sender_pkg: str):
    """One port node and one JAX node, connected; the sender streams."""
    jdata = JaxDataset.synthetic_mnist(n_train=128, n_test=32)
    tdata = FederatedDataset.synthetic_mnist(n_train=128, n_test=32)
    jnode, tnode = _jax_grpc_node(0, 0, jdata), _port_grpc_node(0, 1, tdata)
    assert tnode.connect(jnode.addr)
    _wait_handshake(jnode, tnode)
    return (tnode, jnode) if sender_pkg == "port" else (jnode, tnode)


def _init_envelope(sender):
    return sender.protocol.build_weights("init_model", 0, sender.learner.get_model_update())


@pytest.mark.parametrize("sender_pkg", ["port", "jax"])
def test_streams_cross_the_packages(sender_pkg):
    """A 0.94 MB MLP streamed in 64 KiB chunks (threshold lowered on both
    sides) from one package to the other: one stream, no fallback, and
    the receiver's leaves equal the sender's bit for bit."""
    for s in (Settings, JaxSettings):
        s.WIRE_STREAM_THRESHOLD = 0.1
        s.WIRE_CHUNK_MB = 0.0625
    sender, receiver = _stream_pair(sender_pkg)
    got = {}
    real = receiver.protocol.handle_weights

    def capture(env):
        got["update"] = env.update
        return real(env)

    receiver.protocol.handle_weights = capture
    try:
        assert sender.protocol.send(receiver.addr, _init_envelope(sender))
        stats = sender.protocol.wire_stats
        assert stats["stream_sends"] == 1 and stats["stream_fallback_unary"] == 0
        assert stats["stream_chunks"] >= 15
        flat = got["update"].decoded_flat
        want = (_port_flat if sender_pkg == "port" else _jax_flat)(sender.learner.get_parameters())
        have = {k: np.asarray(v, dtype=np.float32) if sender_pkg == "port" else v.float().numpy()
                for k, v in flat.items()}
        assert _max_gap(want, have) == 0.0
    finally:
        sender.stop()
        receiver.stop()


def test_a_peer_with_streaming_off_forces_the_counted_unary_fallback():
    """The receiver (a JAX node here, whose settings are its own) answers
    ``stream-unsupported``; the port sender falls back to one unary send,
    counts it, and stops probing that peer."""
    Settings.WIRE_STREAM_THRESHOLD = 0.1
    JaxSettings.WIRE_STREAM_ENABLED = False
    sender, receiver = _stream_pair("port")
    try:
        for _ in range(2):
            assert sender.protocol.send(receiver.addr, _init_envelope(sender))
        stats = sender.protocol.wire_stats
        assert stats["stream_fallback_unary"] == 1 and stats["stream_sends"] == 0
        assert stats["weights_msgs"] == 2
    finally:
        sender.stop()
        receiver.stop()


def test_an_unimplemented_stream_route_falls_back_to_unary(monkeypatch):
    """A peer whose server has no ``send_weights_stream`` route answers
    UNIMPLEMENTED: the same counted fallback."""
    Settings.WIRE_STREAM_THRESHOLD = 0.1
    monkeypatch.setattr(tg, "_STREAM_METHODS", ())
    data = FederatedDataset.synthetic_mnist(n_train=128, n_test=32)
    a, b = _port_grpc_node(0, 0, data), _port_grpc_node(1, 1, data)
    try:
        assert a.connect(b.addr)
        assert a.protocol.send(b.addr, _init_envelope(a))
        assert a.protocol.wire_stats["stream_fallback_unary"] == 1
        assert a.protocol.wire_stats["stream_sends"] == 0
    finally:
        a.stop()
        b.stop()


def test_the_ici_plane_carries_the_weights_between_grpc_nodes():
    """Two gRPC nodes of one process on disjoint CPU slots with
    ``WEIGHTS_PLANE="ici"``: the weights move slot to slot (kernel 9's
    plain version here), control rides the sockets, no weight byte
    crosses gRPC and nothing falls back."""
    Settings.WEIGHTS_PLANE = "ici"
    data = FederatedDataset.synthetic_mnist(n_train=256, n_test=32)
    slices = node_slices(submesh_federation_mesh(2, devices=["cpu"] * 2))
    nodes = []
    try:
        for i in range(2):
            learner = TorchLearner(mlp(seed=i, device="cpu"), data.partition(i, 2), batch_size=64, seed=i,
                                   mesh=slices[i])
            nodes.append(Node(learner=learner, protocol=tg.GrpcProtocol("127.0.0.1:0")))
            nodes[-1].start()
        assert nodes[1].connect(nodes[0].addr)
        _run(nodes, nodes[0])
        stats = ici.ici_stats()
        assert stats["shard_sends"] > 0 and stats["bytes_moved"] > 0 and stats["fallback_bytes"] == 0
        assert all(n.protocol.wire_stats["weights_bytes"] == 0 for n in nodes)
        assert all(n.protocol.wire_stats["control_msgs"] > 0 for n in nodes)
        assert _kernels.LAUNCHES["ici_exchange"] == 0  # CPU tensors: the plain version
        gap = _max_gap(_port_flat(nodes[0].learner.get_parameters()), _port_flat(nodes[1].learner.get_parameters()))
        assert gap <= TOL
    finally:
        for n in nodes:
            n.stop()
        Settings.WEIGHTS_PLANE = "bytes"


def test_protobuf_frames_federate_with_a_jax_node():
    """The port speaking the reference's protobuf schema to a JAX node on
    envelope frames: each side sniffs the other's frames, one round."""
    Settings.WIRE_FORMAT = "protobuf"
    jdata = JaxDataset.synthetic_mnist(n_train=256, n_test=32)
    tdata = FederatedDataset.synthetic_mnist(n_train=256, n_test=32)
    jnode, tnode = _jax_grpc_node(0, 0, jdata), _port_grpc_node(1, 1, tdata)
    try:
        assert tnode.connect(jnode.addr)
        _wait_handshake(jnode, tnode)
        tnode.set_start_learning(rounds=1, epochs=1)
        deadline = time.monotonic() + 60
        while not all(n.state.experiment_epoch >= 1 and n.state.round is None for n in (jnode, tnode)):
            assert time.monotonic() < deadline
            time.sleep(0.1)
        assert _max_gap(_jax_flat(jnode.learner.get_parameters()), _port_flat(tnode.learner.get_parameters())) <= TOL
    finally:
        tnode.stop()
        jnode.stop()
        Settings.WIRE_FORMAT = "envelope"


def test_two_process_demo_on_the_cpu(tmp_path):
    """``node1`` and ``node2`` as two OS processes over a real socket, each
    under its own timeout: both exit 0 and node2 prints its accuracy."""
    from p2pfl_tpu_torch.communication.address import free_port

    port = str(free_port())
    common = ["--device", "cpu", "--n_train", "256"]
    env = {"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "2", "HOME": str(tmp_path)}
    log1 = tmp_path / "node1.log"
    with open(log1, "w") as out1:  # a file, not a pipe nobody drains
        n1 = subprocess.Popen(
            [sys.executable, "-m", "p2pfl_tpu_torch.examples.node1", port, *common, "--timeout", "100"],
            cwd=tmp_path, env=env, stdout=out1, stderr=subprocess.STDOUT, text=True,
        )
    try:
        deadline = time.monotonic() + 60
        while "listening" not in log1.read_text():
            assert time.monotonic() < deadline and n1.poll() is None, "node1 did not start"
            time.sleep(0.1)
        n2 = subprocess.run([sys.executable, "-m", "p2pfl_tpu_torch.examples.node2", port, *common, "--rounds", "1"],
                            cwd=tmp_path, env=env, capture_output=True, text=True, timeout=100)
        assert n2.returncode == 0, n2.stdout[-2000:] + n2.stderr[-2000:]
        assert "done: {" in n2.stdout and "test_acc" in n2.stdout
        assert n1.wait(timeout=60) == 0, log1.read_text()[-2000:]
        assert "node1 done" in log1.read_text()
    finally:
        if n1.poll() is None:
            n1.kill()
            n1.wait()
