"""The int8/topk8 wire codecs of the port against the JAX package.

JAX's ``tests/test_topk_compression.py`` and ``test_device_compression.py``
cases run on the port, and the two packages are held against each other
on the same numpy inputs from seeds:

- ``build_topk_plan`` equal; the device producer's idx, q, scale and
  residual bit-equal to JAX's ``_run_encode_jit`` (``_encode_jit``) over
  three rounds of error feedback, on a tree with an all-zero delta leaf,
  a leaf of repeated magnitudes, a bf16 leaf and a leaf of at most 16
  elements; ``decode_tk8_device`` bit-equal;
- host-producer and device-producer frames byte-identical to JAX's
  (each package's producer of the same kind), each decoded by the other
  package bit for bit;
- a tk8 stream cut into small chunks reassembled by the port's
  ``StreamDecoder``; corrupted tk8 payloads raise decode errors;
- ``ici._move_codec`` between two CPU slots equal to the byte path;
- a JAX node and a port node federating over one gRPC socket under topk8
  and under int8.

Tolerances: bit-equality where the packages run the same arithmetic
(every comparison above but the lossy ones); the codec's own loss where
the ported JAX tests state it (int8 steps 0.02-0.05); the mixed
federations' nodes within 5e-2 of each other (max abs: each node folds
its own params exactly and its peer's through the codec).
"""

import signal
import threading
import time

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from p2pfl_tpu.communication import grpc_transport as jg
from p2pfl_tpu.learning import weights as jw
from p2pfl_tpu.learning.dataset import FederatedDataset as JaxDataset
from p2pfl_tpu.learning.learner import JaxLearner
from p2pfl_tpu.learning.weights import named_leaves as jax_named_leaves
from p2pfl_tpu.models import mlp as jax_mlp
from p2pfl_tpu.node import Node as JaxNode
from p2pfl_tpu.ops import compression as jcomp
from p2pfl_tpu.settings import Settings as JaxSettings
from p2pfl_tpu_torch import native
from p2pfl_tpu_torch.communication import grpc_transport as tg
from p2pfl_tpu_torch.communication import ici
from p2pfl_tpu_torch.communication.memory import MemoryRegistry
from p2pfl_tpu_torch.exceptions import AnchorMismatchError, DecodingParamsError, ModelNotMatchingError
from p2pfl_tpu_torch.learning import weights as tw
from p2pfl_tpu_torch.learning.dataset import FederatedDataset
from p2pfl_tpu_torch.learning.learner import TorchLearner
from p2pfl_tpu_torch.learning.weights import (
    ModelUpdate,
    PayloadCache,
    StreamDecoder,
    _frame,
    anchor_digest,
    decode_params,
    encode_params,
    reset_wire_stats,
    wire_stats,
)
from p2pfl_tpu_torch.management.logger import logger
from p2pfl_tpu_torch.models.vision import mlp
from p2pfl_tpu_torch.node import Node, stop_leaked_nodes
from p2pfl_tpu_torch.ops import compression as comp
from p2pfl_tpu_torch.ops.tree import tree_items
from p2pfl_tpu_torch.parallel.ici_plane import slice_info_of
from p2pfl_tpu_torch.parallel.mesh import node_slices, submesh_federation_mesh
from p2pfl_tpu_torch.settings import Settings, set_test_settings
from p2pfl_tpu_torch.utils import check_equal_models, full_connection, wait_convergence, wait_to_finish

torch.set_num_threads(2)
CHUNK = 64 * 1024
DEADLINE_S = 150


@pytest.fixture(autouse=True)
def _env():
    set_test_settings()
    logger.set_level("INFO")
    MemoryRegistry.reset()
    ici.ShardPlaneRegistry.reset()
    ici.reset_ici_stats()
    yield
    stop_leaked_nodes()
    MemoryRegistry.reset()
    ici.ShardPlaneRegistry.reset()
    for s in (Settings, JaxSettings):
        s.WIRE_COMPRESSION = "none"
        s.WIRE_COMPRESSION_DEVICE = True
        s.TOPK_FRACTION = 0.05
        s.TOPK_ERROR_FEEDBACK = True


@pytest.fixture
def deadline():
    """Fail a federation test that outlives DEADLINE_S instead of hanging."""
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


def _t(tree):
    """A numpy tree as torch tensors (bf16 through its bits)."""
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    arr = np.asarray(tree)
    if arr.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(arr.copy())


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return x.view(torch.int16).numpy().view(ml_dtypes.bfloat16) if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(x)


def _same_bits(a, b) -> bool:
    a, b = np.ascontiguousarray(_np(a)), np.ascontiguousarray(_np(b))
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def _both(flag: bool) -> None:
    JaxSettings.WIRE_COMPRESSION_DEVICE = Settings.WIRE_COMPRESSION_DEVICE = flag


# ---- JAX's tests/test_topk_compression.py on the port ----


def _tree(seed=0, shape=(64, 32)):
    rng = np.random.default_rng(seed)
    return {"w": torch.from_numpy(rng.normal(size=shape).astype(np.float32))}


def test_topk_roundtrip_and_shrink():
    anchor = _tree(0)
    delta = np.zeros(tuple(anchor["w"].shape), np.float32)
    rng = np.random.default_rng(1)
    hot = rng.choice(delta.size, size=delta.size * 3 // 100, replace=False)
    delta.ravel()[hot] = rng.normal(size=hot.size).astype(np.float32)
    params = {"w": anchor["w"] + torch.from_numpy(delta)}
    payload = encode_params(params, compression="topk8", anchor=anchor)
    dense = encode_params(params, compression="none")
    assert len(payload) < len(dense) / 6, (len(payload), len(dense))
    flat = decode_params(payload, anchor=anchor)
    # every moved coordinate is inside the kept 5 %: the error is int8's
    np.testing.assert_allclose(flat["w"].numpy(), params["w"].numpy(), atol=0.02)


def test_topk_anchor_mismatch_detected():
    anchor = _tree(0)
    params = {"w": anchor["w"] + 0.1}
    payload = encode_params(params, compression="topk8", anchor=anchor, anchor_tag="1:2")
    with pytest.raises(AnchorMismatchError, match="no anchor"):
        decode_params(payload)
    decode_params(payload, anchor=anchor, anchor_tag="1:2")
    with pytest.raises(AnchorMismatchError, match="round mismatch"):
        decode_params(payload, anchor=_tree(9), anchor_tag="1:3")


def test_topk_falls_back_dense_without_anchor():
    params = _tree(2)
    flat = decode_params(encode_params(params, compression="topk8", anchor=None))
    np.testing.assert_allclose(flat["w"].numpy(), params["w"].numpy(), atol=0.05)


@pytest.mark.parametrize("device_producer", [False, True])
def test_error_feedback_recovers_dropped_mass(device_producer):
    """EF telescopes: residual_T == T·delta − Σ sent_t, so the mean sent
    delta converges to the true delta (JAX's test, on either producer)."""
    Settings.WIRE_COMPRESSION_DEVICE = device_producer
    anchor = _tree(0)
    rng = np.random.default_rng(3)
    delta = rng.normal(size=tuple(anchor["w"].shape)).astype(np.float32)
    params = {"w": anchor["w"] + torch.from_numpy(delta)}
    Settings.TOPK_FRACTION = 0.3
    residual, sent = {}, []
    for _ in range(4):
        p = encode_params(params, compression="topk8", anchor=anchor, residual=residual)
        sent.append(decode_params(p, anchor=anchor)["w"].numpy() - anchor["w"].numpy())
    one_shot_err = np.linalg.norm(delta - sent[0])
    mean_err = np.linalg.norm(delta - np.mean(sent, axis=0))
    assert mean_err < one_shot_err * 0.6, (one_shot_err, mean_err)
    np.testing.assert_allclose(_np(residual["w"]).reshape(delta.shape), 4 * delta - np.sum(sent, axis=0), atol=1e-3)
    assert isinstance(residual["w"], torch.Tensor) == device_producer


def test_anchor_digest_stability_and_jax_equality():
    t = _tree(5)
    assert anchor_digest(t) == anchor_digest({"w": t["w"].clone()})
    assert anchor_digest(t) != anchor_digest(_tree(6))
    assert anchor_digest(t) == jw.anchor_digest({"w": t["w"].numpy()})


def test_corrupted_tk8_payloads_never_escape_decode_errors():
    """A flipped byte anywhere in a tk8 frame, and truncation at every
    framing boundary, surface as DecodingParamsError or
    AnchorMismatchError, never as a silently wrong tensor."""
    anchor = _tree(0)
    params = {"w": anchor["w"] + 0.1}
    payload = bytearray(encode_params(params, compression="topk8", anchor=anchor, anchor_tag="1:1"))
    rng = np.random.default_rng(0)
    for _ in range(60):
        corrupted = bytearray(payload)
        pos = int(rng.integers(len(corrupted)))
        corrupted[pos] ^= int(rng.integers(1, 256))
        with pytest.raises((DecodingParamsError, AnchorMismatchError)):
            decode_params(bytes(corrupted), anchor=anchor, anchor_tag="1:1")
    for cut in (2, 6, len(payload) // 2, len(payload) - 1):
        with pytest.raises((DecodingParamsError, AnchorMismatchError)):
            decode_params(bytes(payload[:cut]), anchor=anchor, anchor_tag="1:1")


def test_topk_federation_grpc_end_to_end(deadline):
    """4 port Nodes over real gRPC sockets under topk8 (fraction 0.2):
    every node learns, the fleet ends on one model within the codec's
    loss, and a delta-coded payload is a third of its dense int8 twin."""
    Settings.GRPC_TIMEOUT = 5.0
    Settings.WIRE_COMPRESSION = "topk8"
    Settings.TOPK_FRACTION = 0.2
    full = FederatedDataset.synthetic_mnist(n_train=1024, n_test=256)
    nodes = []
    try:
        for i in range(4):
            learner = TorchLearner(mlp(seed=i, device="cpu"), full.partition(i, 4), batch_size=64, seed=i)
            nodes.append(Node(learner=learner, protocol=tg.GrpcProtocol("127.0.0.1:0")))
            nodes[-1].start()
        for n in nodes:
            full_connection(n, nodes)
        wait_convergence(nodes, 3, only_direct=True, wait=20)
        nodes[0].set_start_learning(rounds=2, epochs=1)
        wait_to_finish(nodes, timeout=120)
        accs = [n.learner.evaluate()["test_acc"] for n in nodes]
        assert min(accs) > 0.5 and float(np.mean(accs)) > 0.65, accs
        check_equal_models(nodes)
        upd = nodes[0].learner.get_model_update()
        assert upd.anchor is not None
        Settings.TOPK_FRACTION = 0.05
        sparse = len(encode_params(upd.params, compression="topk8", anchor=upd.anchor))
        dense8 = len(encode_params(upd.params, compression="int8"))
        assert sparse < dense8 / 3, (sparse, dense8)
    finally:
        for n in nodes:
            n.stop()


# ---- JAX's tests/test_device_compression.py on the port ----


def _mixed(seed=0):
    """Big and medium float leaves (topk), a tiny float leaf (dense i8
    under topk8) and an int leaf (raw)."""
    rng = np.random.default_rng(seed)
    return {
        "layer0/w": rng.normal(size=(64, 32)).astype(np.float32),
        "layer1/w": rng.normal(size=(300,)).astype(np.float32),
        "tiny/b": rng.normal(size=(10,)).astype(np.float32),
        "steps": np.arange(5, dtype=np.int32),
    }


def _anchor_of(tree):
    return {k: (v - 0.01 if np.dtype(v.dtype).kind == "f" else v) for k, v in tree.items()}


def _close(a, b, atol):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_allclose(_np(a[k]).astype(np.float32), _np(b[k]).astype(np.float32), atol=atol)


@pytest.mark.parametrize("mode", ["int8", "topk8"])
def test_cross_producer_frames_decode_with_one_decoder(mode):
    """Host and device frames decode with either consumer, within int8's
    step; raw leaves bit-preserved."""
    params = _mixed(0)
    anchor = _anchor_of(params)
    kw = {"compression": mode, **({"anchor": _t(anchor), "anchor_tag": "1:1"} if mode == "topk8" else {})}
    dk = {"anchor": _t(anchor), "anchor_tag": "1:1"} if mode == "topk8" else {}
    Settings.WIRE_COMPRESSION_DEVICE = False
    host_payload = encode_params(_t(params), **kw)
    Settings.WIRE_COMPRESSION_DEVICE = True
    device_payload = encode_params(_t(params), **kw)
    for consumer in (False, True):
        Settings.WIRE_COMPRESSION_DEVICE = consumer
        ref = decode_params(host_payload, **dk)
        _close(ref, decode_params(device_payload, **dk), atol=0.05)
        _close(ref, params, atol=0.05)
        assert _same_bits(decode_params(device_payload, **dk)["steps"], params["steps"])


def test_host_path_bit_identical_to_jax_and_to_the_frozen_reference():
    """``WIRE_COMPRESSION_DEVICE=False``: the port's host frames equal the
    JAX package's host frames, which its own test pins to the frozen
    pre-device algorithm; residuals bit-equal."""
    _both(False)
    params = _mixed(3)
    anchor = _anchor_of(params)
    for mode in ("none", "int8"):
        assert encode_params(_t(params), compression=mode) == jw.encode_params(params, compression=mode)
    res_t, res_j = {}, {}
    for _ in range(3):
        got = encode_params(_t(params), compression="topk8", anchor=_t(anchor), anchor_tag="2:7", residual=res_t)
        want = jw.encode_params(params, compression="topk8", anchor=anchor, anchor_tag="2:7", residual=res_j)
        assert got == want
        assert sorted(res_t) == sorted(res_j) and all(_same_bits(res_t[k], res_j[k]) for k in res_j)


def test_stale_residual_entries_dropped_not_crashed():
    Settings.WIRE_COMPRESSION_DEVICE = False
    params = _t(_mixed(2))
    anchor = _t(_anchor_of(_mixed(2)))
    residual = {
        "layer0/w": np.zeros(999, np.float32),  # wrong size
        "ghost/w": np.zeros(64, np.float32),  # no such key
        "tiny/b": np.zeros(10, np.float32),  # off the topk path
        "layer1/w": np.full(300, 0.5, np.float32),  # valid
    }
    payload = encode_params(params, compression="topk8", anchor=anchor, anchor_tag="0:0", residual=residual)
    decode_params(payload, anchor=anchor, anchor_tag="0:0")
    assert set(residual) == {"layer0/w", "layer1/w"}
    assert not np.allclose(_np(residual["layer1/w"]), 0.5)


def test_residual_survives_producer_flips():
    """host → device → host encodes share one store: each producer converts
    the other's entries; a mode flip prunes the store."""
    params_np = _mixed(4)
    anchor_np = _anchor_of(params_np)
    residual = {}
    for flag in (False, True, False):
        Settings.WIRE_COMPRESSION_DEVICE = flag
        payload = encode_params(_t(params_np), compression="topk8", anchor=_t(anchor_np), anchor_tag="0:0",
                                residual=residual)
        _close(decode_params(payload, anchor=_t(anchor_np), anchor_tag="0:0"), params_np, atol=0.05)
        assert all(isinstance(v, torch.Tensor) == flag for v in residual.values())
    encode_params(_t(params_np), compression="int8", anchor=None, residual=residual)
    assert residual == {}


def _tk8_frame(key, shape, idx, q, scale, nnz, anchor_tag="0:0"):
    entry = {"k": key, "shape": list(shape), "dtype": "float32", "enc": "tk8", "scale": float(scale), "nnz": int(nnz)}
    return _frame([(entry, (np.asarray(idx, np.uint32).tobytes(), np.asarray(q, np.int8).tobytes()))], anchor_tag)


@pytest.mark.parametrize("device", [False, True])
def test_malformed_tk8_payloads_rejected(device):
    Settings.WIRE_COMPRESSION_DEVICE = device
    dk = {"anchor": {"w": torch.zeros((8, 8))}, "anchor_tag": "0:0"}
    ok = _tk8_frame("w", (8, 8), [1, 5, 9], [10, -20, 30], 0.01, 3)
    np.testing.assert_allclose(decode_params(ok, **dk)["w"].numpy().ravel()[[1, 5, 9]], [0.1, -0.2, 0.3], atol=1e-6)
    with pytest.raises(DecodingParamsError, match="duplicate or unsorted"):
        decode_params(_tk8_frame("w", (8, 8), [1, 5, 5], [1, 2, 3], 0.01, 3), **dk)
    with pytest.raises(DecodingParamsError, match="duplicate or unsorted"):
        decode_params(_tk8_frame("w", (8, 8), [9, 5, 1], [1, 2, 3], 0.01, 3), **dk)
    with pytest.raises(DecodingParamsError, match="out of range"):
        decode_params(_tk8_frame("w", (8, 8), [1, 5, 64], [1, 2, 3], 0.01, 3), **dk)
    with pytest.raises(DecodingParamsError, match="inconsistent header"):
        decode_params(_tk8_frame("w", (8, 8), [1, 5, 9], [1, 2, 3], 0.01, 7), **dk)
    with pytest.raises(DecodingParamsError):
        decode_params(_tk8_frame("w", (2,), [0, 1, 1], [1, 2, 3], 0.01, 3), anchor={"w": torch.zeros(2)},
                      anchor_tag="0:0")
    with pytest.raises(AnchorMismatchError, match="no anchor tensor"):
        decode_params(_tk8_frame("nope", (8, 8), [1], [5], 0.01, 1), **dk)


@pytest.mark.parametrize("frame_size", [100, 40])
@pytest.mark.parametrize("device", [False, True])
def test_tk8_leaf_of_another_size_than_the_anchor_rejected(device, frame_size):
    """A peer's tk8 leaf whose element count is not the receiver's anchor
    leaf's fails the decode in both consumers, before any scatter: past the
    anchor's end the card's scatter would trap the context."""
    Settings.WIRE_COMPRESSION_DEVICE = device
    frame = _tk8_frame("w", (frame_size,), [1, 30, frame_size - 1], [10, -20, 30], 0.01, 3)
    with pytest.raises(DecodingParamsError, match=f"anchor leaf w has 64 elements, frame {frame_size}") as exc:
        decode_params(frame, anchor={"w": torch.zeros((8, 8))}, anchor_tag="0:0")
    assert isinstance(exc.value.__cause__, ModelNotMatchingError)


def test_wire_byte_counters_per_node_and_process():
    logger.reset_comm_metrics()
    reset_wire_stats()
    Settings.WIRE_COMPRESSION = "topk8"
    upd = ModelUpdate(_t(_mixed(0)), ["nodeA:1"], 1, anchor=_t(_anchor_of(_mixed(0))), anchor_tag="0:0",
                      payload_cache=PayloadCache(owner="nodeA:1"), cache_version=1)
    upd.cache_round = 0
    payload = upd.encode()
    assert upd.encode() is payload  # cached: no new counters
    m = logger.get_comm_metrics("nodeA:1")
    assert m["wire_encode_device"] == 1 and "wire_encode_host" not in m
    assert m["wire_payload_bytes"] == len(payload)
    assert m["wire_raw_bytes"] > m["wire_payload_bytes"] > m["wire_d2h_bytes"] * 0.2
    assert m["wire_d2h_bytes"] < m["wire_raw_bytes"] / 4
    s = wire_stats()
    assert s["device_encodes"] >= 1 and s["payload_bytes"] >= len(payload)


def test_payload_cache_key_includes_producer_flag():
    Settings.WIRE_COMPRESSION = "int8"
    params = _t(_mixed(0))
    cache = PayloadCache(owner="n")

    def fresh():
        u = ModelUpdate(params, ["n"], 1, payload_cache=cache, cache_version=7)
        u.cache_round = 0
        return u

    Settings.WIRE_COMPRESSION_DEVICE = True
    a = fresh().encode()
    Settings.WIRE_COMPRESSION_DEVICE = False
    b = fresh().encode()
    assert cache.misses == 2, (cache.hits, cache.misses)
    _close(decode_params(a), decode_params(b), atol=0.05)


def test_a_failed_encode_drops_the_residual_entries(monkeypatch):
    """JAX's donation rule: an encode that raises part way leaves no
    half-written carry behind; the next encode restarts from zero."""
    Settings.WIRE_COMPRESSION_DEVICE = True
    params, anchor = _t(_mixed(0)), _t(_anchor_of(_mixed(0)))
    store = {"layer0/w": np.full(64 * 32, 0.5, np.float32), "layer1/w": np.full(300, 0.5, np.float32)}
    real, calls = comp._encode_tk, []

    def flaky(*a, **k):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("out of memory")
        return real(*a, **k)

    monkeypatch.setattr(comp, "_encode_tk", flaky)
    with pytest.raises(RuntimeError, match="out of memory"):
        encode_params(params, compression="topk8", anchor=anchor, anchor_tag="0:0", residual=store)
    assert store == {}
    monkeypatch.undo()
    encode_params(params, compression="topk8", anchor=anchor, anchor_tag="0:0", residual=store)
    assert set(store) == {"layer0/w", "layer1/w"}


def test_error_feedback_folds_once_across_planes():
    """The byte encode and the ICI plane's encode of one content claim the
    fold through one key: the second encodes without the residual."""
    Settings.WIRE_COMPRESSION = "topk8"
    store = {}
    cache = PayloadCache(owner="n")
    upd = ModelUpdate(_t(_mixed(0)), ["n"], 1, anchor=_t(_anchor_of(_mixed(0))), anchor_tag="0:0",
                      payload_cache=cache, cache_version=3, ef_residual=store)
    upd.cache_round = 0
    assert cache.ef_fold_once(upd.ef_fold_key("topk8"))  # the ICI plane took it
    upd.encode()
    assert store == {}  # residual-free: nothing folded twice
    other = ModelUpdate(upd.params, ["n"], 1, anchor=upd.anchor, anchor_tag="0:0", payload_cache=cache,
                        cache_version=4, ef_residual=store)
    other.cache_round = 0
    other.encode()
    assert set(store) == {"layer0/w", "layer1/w"}


# ---- the port against JAX on the same inputs ----


def _tie_tree(seed: int) -> dict:
    """An all-zero-delta leaf, repeated magnitudes, a bf16 leaf, a leaf of
    at most 16 elements, an int leaf."""
    rng = np.random.default_rng(seed)
    return {
        "a/kernel": rng.normal(size=(40, 33)).astype(np.float32),
        "a/bias": np.zeros(40, np.float32),
        "b/steps": (np.round(rng.normal(size=300) * 2) / 2).astype(np.float32),
        "c": rng.normal(size=12).astype(np.float32),
        "d": rng.normal(size=(6, 9)).astype(ml_dtypes.bfloat16),
        "e": np.arange(7, dtype=np.int32),
    }


def _tie_anchor() -> dict:
    t = _tie_tree(99)
    t["a/bias"] = np.zeros(40, np.float32)
    t["b/steps"] = np.zeros(300, np.float32)
    return t


def test_build_topk_plan_matches_jax():
    tree, anchor = _tie_tree(0), _tie_anchor()
    for frac in (0.0, 0.05, 0.3, 1.0):
        want = jcomp.build_topk_plan(tree, anchor, frac)
        assert comp.build_topk_plan(_t(tree), _t(anchor), frac) == want
        assert comp.split_codec_specs(_t(tree), want)[1:] == jcomp.split_codec_specs(tree, want)[1:]
    assert comp.build_topk_plan(_t(tree), None, 0.05) == {}
    assert "d" not in jcomp.build_topk_plan(tree, anchor, 0.05)  # bf16 ships raw


def test_device_encode_bit_equal_to_jax_encode_jit_over_three_rounds():
    """idx, q, scales and the residual carry of ``_run_encode`` against
    JAX's ``_run_encode_jit`` (``_encode_jit``), three rounds of error
    feedback, ties included: bit for bit."""
    anchor = _tie_anchor()
    j_res, t_res = {}, {}
    for r in range(3):
        tree = _tie_tree(r)
        tree["a/bias"] = np.zeros(40, np.float32)  # its delta stays all zero: ties
        plan = jcomp.build_topk_plan(tree, anchor, 0.05)
        _, tk_spec, dense_spec = jcomp.split_codec_specs(tree, plan)
        jt = {k: jnp.asarray(v) for k, v in tree.items()}
        ja = {k: jnp.asarray(v) for k, v in anchor.items()}
        want = jcomp._run_encode_jit(jt, ja, tk_spec, dense_spec, j_res)
        got = comp._run_encode(_t(tree), _t(anchor), tk_spec, dense_spec, t_res)
        for a, b in zip(got["tk"], want["tk"][:3]):
            assert _same_bits(a, b)
        for a, b in zip(got["dense"], want["dense"]):
            assert _same_bits(a, b)
        assert sorted(t_res) == sorted(j_res) == sorted(plan)
        for k in j_res:
            assert _same_bits(t_res[k], j_res[k]), (k, r)


def test_topk_positions_break_ties_as_jax_top_k():
    for mags, k in (([0, 1, 0, 1, 0, 0, 1, 0], 5), ([0] * 40, 6), ([3, 1, 3, 2, 3, 1], 2), ([2.0] * 7, 7)):
        a = np.asarray(mags, np.float32)
        want = np.sort(np.asarray(jax.lax.top_k(jnp.asarray(a), k)[1]))
        assert comp.topk_positions(torch.from_numpy(a), k).tolist() == want.tolist()


def test_decode_tk8_device_bit_equal_to_jax():
    rng = np.random.default_rng(5)
    anchor = rng.normal(size=(30, 20)).astype(np.float32)
    idx = np.sort(rng.choice(600, size=31, replace=False)).astype(np.uint32)
    vals = native.dequantize(rng.integers(-127, 128, size=31).astype(np.int8), 0.0123)
    want = jcomp.decode_tk8_device([("w", jnp.asarray(anchor), idx, vals, (30, 20), np.float32)])["w"]
    got = comp.decode_tk8_device([("w", torch.from_numpy(anchor), idx, vals, (30, 20), torch.float32)])["w"]
    assert _same_bits(got, want)


@pytest.mark.parametrize("device_producer", [False, True])
@pytest.mark.parametrize("mode", ["int8", "topk8"])
def test_frames_byte_identical_to_jax_and_cross_decode(mode, device_producer):
    """The same producer kind in both packages emits the same frame, three
    rounds of error feedback long; each package decodes the other's frame
    to the same bits."""
    _both(device_producer)
    anchor = _tie_anchor()
    j_res, t_res = {}, {}
    for r in range(3):
        tree = _tie_tree(r)
        tree["a/bias"] = np.zeros(40, np.float32)
        jt = {k: jnp.asarray(v) for k, v in tree.items()} if device_producer else tree
        ja = {k: jnp.asarray(v) for k, v in anchor.items()} if device_producer else anchor
        kw = {"anchor_tag": "0:1", "residual": j_res if mode == "topk8" else None}
        jbytes = jw.encode_params(jt, compression=mode, anchor=ja, **kw)
        tbytes = encode_params(_t(tree), compression=mode, anchor=_t(anchor), anchor_tag="0:1",
                               residual=t_res if mode == "topk8" else None)
        assert tbytes == jbytes, r
        got = decode_params(jbytes, anchor=_t(anchor), anchor_tag="0:1")
        want = jw.decode_params(tbytes, anchor=anchor, anchor_tag="0:1")
        assert sorted(got) == sorted(want)
        for k in want:
            assert _same_bits(got[k], want[k]), (k, r)
        for k in j_res:
            assert _same_bits(t_res[k], j_res[k]), (k, r)


@pytest.mark.parametrize("sender", ["port", "jax"])
def test_stream_decoder_reassembles_a_tk8_stream(sender):
    """A tk8 frame cut into small P2TC chunks: the port's decoder
    reassembles the unary frame byte for byte (delta-coded streams wait
    for the anchor), and decoding it equals the unary decode."""
    tree = {"w": np.random.default_rng(0).normal(size=(1000, 400)).astype(np.float32)}
    anchor = {"w": np.zeros((1000, 400), np.float32)}
    if sender == "port":
        frame = encode_params(_t(tree), compression="topk8", anchor=_t(anchor), anchor_tag="0:1")
        chunks = tw.chunk_encoded_payload(frame, CHUNK)
    else:
        frame = jw.encode_params(tree, compression="topk8", anchor=anchor, anchor_tag="0:1")
        chunks = jw.chunk_encoded_payload(frame, CHUNK)
    assert len(chunks) > 3
    dec = StreamDecoder()
    for c in chunks:
        dec.feed(c)
    assert dec.complete and dec.reassembled and dec.result_payload() == frame
    with pytest.raises(DecodingParamsError, match="result_payload"):
        dec.result_flat()
    got = decode_params(dec.result_payload(), anchor=_t(anchor), anchor_tag="0:1")
    assert _same_bits(got["w"], decode_params(frame, anchor=_t(anchor), anchor_tag="0:1")["w"])


@pytest.mark.parametrize("mode", ["int8", "topk8"])
def test_move_codec_on_two_cpu_slots_equals_the_byte_path(mode):
    params, anchor, template = (dict(mlp(seed=s, device="cpu").params) for s in (0, 1, 2))
    for t, s in ((params, 0), (anchor, 1), (template, 2)):
        t["extra"] = {"half": torch.full((3, 5), float(s)).to(torch.bfloat16), "count": torch.arange(3) + s}
    slices = node_slices(submesh_federation_mesh(2, devices=["cpu"] * 2))
    src, dst = slice_info_of(params, slices[0]), slice_info_of(template, slices[1])

    class _Receiver:
        @staticmethod
        def wire_anchor():
            return anchor, "1:0"

    update = ModelUpdate(params, ["a"], 10, anchor=anchor, anchor_tag="1:0")
    got, want, moved, srcs = ici.move_codec_against_bytes(update, template, src, dst, _Receiver(), mode)
    assert 0 < moved == sum(x.numel() * x.element_size() for x in srcs)
    assert moved < sum(x.numel() * x.element_size() for _, x in tree_items(params))
    want = dict(tree_items(want))
    for key, leaf in tree_items(got):
        assert _same_bits(leaf, want[key]), key
    # a receiver holding another round's anchor: the caller falls back
    class _Behind:
        @staticmethod
        def wire_anchor():
            return anchor, "0:9"

    assert (ici._move_codec(update, template, src, dst, _Behind(), "topk8") is None) == True  # noqa: E712
    # the same update again reuses its encode: the payload is not rebuilt
    assert ici._move_codec(update, template, src, dst, _Receiver(), mode)[1] == moved


@pytest.mark.parametrize("mode", ["topk8", "int8"])
def test_a_jax_node_and_a_port_node_federate_under_a_lossy_codec(mode, deadline):
    """The mixed federation of ``test_torch_grpc.py`` over one gRPC socket, each package's
    ``WIRE_COMPRESSION`` set to ``mode``: the frames cross (tk8 against
    each side's own anchor, both at the same round tag), both nodes learn
    and end within the codec's loss of each other."""
    for s in (Settings, JaxSettings):
        s.WIRE_COMPRESSION = mode
        s.GRPC_TIMEOUT = 5.0
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
        deadline_t = time.monotonic() + 20
        while len(jnode.get_neighbors(only_direct=True)) < 1 or len(tnode.get_neighbors(only_direct=True)) < 1:
            assert time.monotonic() < deadline_t, "no handshake"
            time.sleep(0.05)
        tnode.set_start_learning(rounds=2, epochs=1)
        deadline_t = time.monotonic() + 120
        while not all(n.state.experiment_epoch >= 1 and n.state.round is None for n in (jnode, tnode)):
            assert time.monotonic() < deadline_t, "the mixed fleet did not finish"
            time.sleep(0.1)
        jflat = {k: np.asarray(v, np.float32) for k, v in jax_named_leaves(jnode.learner.get_parameters())[1]}
        tflat = {k: v.float().numpy() for k, v in tree_items(tnode.learner.get_parameters())}
        gap = max(float(np.abs(jflat[k] - tflat[k]).max()) for k in jflat)
        assert gap <= 5e-2, gap
        assert tnode.learner.evaluate()["test_acc"] > 0.5
        raw = sum(v.size * 4 for v in jflat.values())
        for node in (jnode, tnode):
            stats = node.protocol.wire_stats
            assert 0 < stats["weights_bytes"] < stats["weights_msgs"] * raw / 2
    finally:
        tnode.stop()
        jnode.stop()
