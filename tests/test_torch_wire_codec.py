"""The port's byte codec against the JAX package: P2TW frames and P2TC
chunk streams of the same tree are byte-identical from both packages,
and each decodes the other's; the native library against JAX's and its
numpy twins; the stream decoder fed frame by frame and its rejections;
the encode-once payload cache; and the in-memory transport's byte path
(``MEMORY_WIRE_CODEC``), unary and streamed, against its reference path.

Inputs come from numpy seeds. Every byte comparison is exact (the codec
is host-side and integer); the federations compare fp32 params exactly
where the byte path must not change a bit.
"""

import json
import struct
import time

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from p2pfl_tpu import native as jnative
from p2pfl_tpu.learning import weights as jw
from p2pfl_tpu.models.base import FlaxModel
from p2pfl_tpu.models.vision import MLP as JaxMLP
from p2pfl_tpu.settings import Settings as JaxSettings
from p2pfl_tpu_torch import native
from p2pfl_tpu_torch.communication import ici
from p2pfl_tpu_torch.communication.memory import MemoryRegistry
from p2pfl_tpu_torch.exceptions import DecodingParamsError, ModelNotMatchingError
from p2pfl_tpu_torch.learning import weights as tw
from p2pfl_tpu_torch.learning.dataset import FederatedDataset
from p2pfl_tpu_torch.learning.learner import DummyLearner, TorchLearner
from p2pfl_tpu_torch.management.logger import logger
from p2pfl_tpu_torch.models.vision import mlp
from p2pfl_tpu_torch.node import Node, stop_leaked_nodes
from p2pfl_tpu_torch.ops.tree import tree_leaves, tree_map
from p2pfl_tpu_torch.settings import Settings, set_test_settings
from p2pfl_tpu_torch.utils import full_connection, wait_convergence, wait_to_finish

torch.set_num_threads(2)
CHUNK = 64 * 1024  # the smallest slab the codec allows: many chunks at test sizes


@pytest.fixture(autouse=True)
def _port_env():
    set_test_settings()
    logger.set_level("INFO")
    MemoryRegistry.reset()
    ici.ShardPlaneRegistry.reset()
    yield
    stop_leaked_nodes()
    MemoryRegistry.reset()
    ici.ShardPlaneRegistry.reset()


# ---- trees: numpy leaves for JAX, the same bytes as tensors for the port ----


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    a = np.asarray(tree)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _as_numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.cpu().view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.cpu().numpy()


def _same_leaf(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def _mlp_tree():
    model = FlaxModel.create(JaxMLP(dtype=jnp.bfloat16), (28, 28, 1), seed=0)
    return jax.tree.map(np.asarray, model.params)


def _bf16_tree():
    rng = np.random.default_rng(1)
    return {
        "layer_0": {"w": rng.standard_normal((64, 48)).astype(ml_dtypes.bfloat16),
                    "b": rng.standard_normal(48).astype(ml_dtypes.bfloat16)},
        "norm": {"scale": rng.standard_normal(48).astype(np.float32)},
    }


def _int_bool_tree():
    rng = np.random.default_rng(2)
    return {
        "count": np.int32(7),
        "ids": rng.integers(-1000, 1000, (17, 3), dtype=np.int64),
        "mask": rng.random((5, 5)) < 0.5,
        "bytes": rng.integers(0, 256, 33, dtype=np.uint8),
        "empty": np.zeros((0, 4), np.float32),
        "half": rng.standard_normal(9).astype(np.float16),
    }


TREES = {"mlp": _mlp_tree, "bf16": _bf16_tree, "int_bool": _int_bool_tree}


@pytest.mark.parametrize("name", sorted(TREES))
def test_p2tw_frames_are_byte_identical_and_cross_decode(name):
    tree = TREES[name]()
    # numpy leaves: jnp.asarray would narrow int64 to int32 (x64 is off)
    jax_bytes = jw.encode_params(tree, compression="none")
    if name != "int_bool":
        assert jw.encode_params(jax.tree.map(jnp.asarray, tree), compression="none") == jax_bytes
    port_bytes = tw.encode_params(_to_torch(tree))
    assert port_bytes == jax_bytes
    # each package decodes the other's frame bit for bit
    from_jax = tw.decode_params(jax_bytes)
    from_port = jw.decode_params(port_bytes)
    assert sorted(from_jax) == sorted(from_port)
    for key, leaf in from_port.items():
        assert _same_leaf(_as_numpy(from_jax[key]), leaf), key


@pytest.mark.parametrize("name", sorted(TREES))
def test_p2tc_streams_are_byte_identical_and_cross_decode(name):
    tree = TREES[name]()
    jax_chunks = jw.encode_params_chunked(tree, compression="none", chunk_bytes=CHUNK)
    port_chunks = tw.encode_params_chunked(_to_torch(tree), chunk_bytes=CHUNK)
    assert port_chunks == jax_chunks
    payload = tw.encode_params(_to_torch(tree))
    assert tw.chunk_encoded_payload(payload, CHUNK) == jw.chunk_encoded_payload(payload, CHUNK)
    assert tw.payload_from_chunks(jax_chunks) == payload == jw.payload_from_chunks(port_chunks)
    port_dec, jax_dec = tw.StreamDecoder(), jw.StreamDecoder()
    for frame in jax_chunks:
        port_dec.feed(frame)
    for frame in port_chunks:
        jax_dec.feed(frame)
    got, want = port_dec.result_flat(), jax_dec.result_flat()
    assert sorted(got) == sorted(want)
    for key in want:
        assert _same_leaf(_as_numpy(got[key]), want[key]), key


@pytest.mark.parametrize("mode", ["int8", "topk8"])
def test_lossy_frames_and_encodes_raise_naming_item_4(mode):
    """Until ROADMAP item 4b a JAX peer's int8 or topk8 frame raised on the
    port; now the port decodes it, unary and streamed, to the leaves JAX's
    own decoder gives (bit for bit, on the same anchor), and the port's
    encode of the same tree under the same mode is JAX's frame byte for
    byte (both host producers)."""
    tree = {"w": np.linspace(-1, 1, 4096, dtype=np.float32)}
    anchor = {"w": np.zeros(4096, np.float32)}
    prev = (JaxSettings.WIRE_COMPRESSION_DEVICE, Settings.WIRE_COMPRESSION_DEVICE)
    JaxSettings.WIRE_COMPRESSION_DEVICE = Settings.WIRE_COMPRESSION_DEVICE = False
    try:
        frame = jw.encode_params(tree, compression=mode, anchor=anchor, anchor_tag="0:1")
        want = jw.decode_params(frame, anchor=anchor, anchor_tag="0:1")["w"]
        got = tw.decode_params(frame, anchor=_to_torch(anchor), anchor_tag="0:1")["w"]
        assert _same_leaf(_as_numpy(got), want)
        dec = tw.StreamDecoder()
        for chunk in jw.chunk_encoded_payload(frame, CHUNK):
            dec.feed(chunk)
        if mode == "topk8":
            # delta-coded: the stream reassembles the unary frame
            assert dec.reassembled and dec.result_payload() == frame
        else:
            assert _same_leaf(_as_numpy(dec.result_flat()["w"]), want)
        port = tw.encode_params(_to_torch(tree), compression=mode, anchor=_to_torch(anchor), anchor_tag="0:1")
        assert port == frame
    finally:
        JaxSettings.WIRE_COMPRESSION_DEVICE, Settings.WIRE_COMPRESSION_DEVICE = prev


def test_a_dtype_torch_cannot_hold_is_a_decode_error():
    frame = jw.encode_params({"x": np.ones(3, np.float128)}, compression="none")
    with pytest.raises(DecodingParamsError, match="float128"):
        tw.decode_params(frame)


# ---- the native library ----


@pytest.mark.parametrize("n", [0, 1, 7, 63, 64, 65, 4096 + 3, 1 << 20])
def test_crc32c_matches_jax_and_the_numpy_twin(n):
    data = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8).tobytes()
    for seed in (0, 0xDEADBEEF):
        want = jnative.crc32c(data, seed)
        assert native.crc32c(data, seed) == want
        assert native.crc32c(memoryview(data), seed) == want
        assert native.crc32c_np(data, seed) == want
        if n <= 4096 + 3:
            assert jnative._crc32c_py(data, seed) == want


def test_crc32c_combine_matches_jax():
    rng = np.random.default_rng(3)
    for la, lb in [(0, 5), (5, 0), (1, 1), (1000, 70000), (65536, 65536)]:
        a, b = rng.integers(0, 256, la, dtype=np.uint8).tobytes(), rng.integers(0, 256, lb, dtype=np.uint8).tobytes()
        got = native.crc32c_combine(native.crc32c(a), native.crc32c(b), lb)
        assert got == native.crc32c(a + b) == jnative.crc32c_combine(jnative.crc32c(a), jnative.crc32c(b), lb)


@pytest.mark.parametrize("n", [1, 7, 1000, 1 << 16])
def test_quantize_dequantize_match_jax_and_the_numpy_twins(n):
    rng = np.random.default_rng(n)
    x = (rng.standard_normal(n) * rng.uniform(0.01, 100)).astype(np.float32)
    q, scale = native.quantize(x)
    jq, jscale = jnative.quantize(x)
    tq, tscale = native.quantize_np(x)
    assert native.NATIVE and jnative.NATIVE
    assert scale == jscale == tscale
    assert np.array_equal(q, jq) and np.array_equal(q, tq)
    back = native.dequantize(q, scale)
    assert back.tobytes() == jnative.dequantize(q, scale).tobytes() == native.dequantize_np(q, scale).tobytes()
    zq, zscale = native.quantize(np.zeros(4, np.float32))
    assert zscale == native.quantize_np(np.zeros(4, np.float32))[1] == 1.0 and not zq.any()


def test_library_builds_beside_the_package_keyed_on_the_source():
    path = native.library_path()
    assert native.NATIVE and path.exists()
    assert path.parent == native.BUILD_DIR and path.parent.parts[-2:] == ("build", "p2pfl_tpu_torch")
    assert native.build() == path  # built once, then found


# ---- the stream decoder ----


def _mlp_chunks():
    return tw.encode_params_chunked(_to_torch(_mlp_tree()), chunk_bytes=CHUNK)


def test_stream_decoder_completes_leaves_frame_by_frame():
    """Sixteen 64 KiB leaves in 64 KiB chunks: leaves complete as their
    chunks arrive, and the decoder never holds more than one chunk frame
    and one open leaf, however large the model."""
    rng = np.random.default_rng(4)
    tree = {f"layer_{i:02d}": torch.from_numpy(rng.standard_normal((128, 128)).astype(np.float32))
            for i in range(16)}
    chunks = tw.encode_params_chunked(tree, chunk_bytes=CHUNK)
    dec = tw.StreamDecoder(device="cpu")
    done = []
    for frame in chunks:
        assert not dec.complete
        dec.feed(frame)
        done.append(len(dec.result_flat()) if dec.complete else len(dec._flat))
    assert dec.complete and dec.chunks == len(chunks) == 16 + 2
    assert done == [0, *range(1, 17), 16]
    assert dec.peak_scratch_bytes <= 2 * CHUNK + 64
    assert dec.payload_bytes >= 7 * dec.peak_scratch_bytes
    for key, leaf in dec.result_flat().items():
        assert torch.equal(leaf, tree[key])


def _with_crc(frame: bytearray) -> bytes:
    struct.pack_into("<I", frame, 13, native.crc32c(memoryview(frame)[17:], 0))
    return bytes(frame)


def _flip_body(chunks):
    bad = bytearray(chunks[2])
    bad[40] ^= 0xFF  # the chunk's own CRC no longer matches
    return chunks[:2] + [bytes(bad)] + chunks[3:]


def _flip_total_crc(chunks):
    bad = bytearray(chunks[2])
    bad[40] ^= 0xFF
    return chunks[:2] + [_with_crc(bad)] + chunks[3:]  # chunk CRC fixed, payload CRC not


def _bad_magic(chunks):
    return [b"XXXX" + chunks[0][4:]] + chunks[1:]


def _bad_inner_magic(chunks):
    head = bytearray(chunks[0])
    head[17:21] = b"NOPE"
    return [_with_crc(head)] + chunks[1:]


REJECTIONS = {
    "bad chunk crc": (_flip_body, "CRC mismatch"),
    "bad payload crc": (_flip_total_crc, "CRC mismatch"),
    "truncated": (lambda c: c[:-3] + c[-1:], "chunk count mismatch|truncated|out-of-order"),
    "no end chunk": (lambda c: c[:-1], "incomplete"),
    "wrong magic": (_bad_magic, "bad chunk magic"),
    "wrong payload magic": (_bad_inner_magic, "bad magic"),
    "out of order": (lambda c: [c[0], c[2], c[1], *c[3:]], "out-of-order"),
    "duplicate header": (lambda c: [c[0], c[0], *c[1:]], "out-of-order"),
    "data before header": (lambda c: c[1:], "out-of-order"),
}


@pytest.mark.parametrize("case", sorted(REJECTIONS))
def test_stream_decoder_rejects(case):
    mutate, err = REJECTIONS[case]
    dec = tw.StreamDecoder()
    with pytest.raises(DecodingParamsError, match=err):
        for frame in mutate(_mlp_chunks()):
            dec.feed(frame)
        dec.result_flat()


def test_end_chunk_lies_are_caught():
    chunks = _mlp_chunks()
    end = tw._chunk(tw.CHUNK_END, len(chunks) - 1, json.dumps({"n": 3}).encode())
    dec = tw.StreamDecoder()
    with pytest.raises(DecodingParamsError, match="chunk count mismatch"):
        for frame in chunks[:-1] + [end]:
            dec.feed(frame)


def test_unary_decoder_rejects_corruption_and_truncation():
    payload = tw.encode_params(_to_torch(_mlp_tree()))
    bad = bytearray(payload)
    bad[-5] ^= 1
    with pytest.raises(DecodingParamsError, match="CRC"):
        tw.decode_params(bytes(bad))
    with pytest.raises(DecodingParamsError, match="truncated"):
        tw.decode_params(payload[:-10])
    with pytest.raises(DecodingParamsError, match="bad magic"):
        tw.decode_params(b"PKL!" + payload[4:])


def test_decoded_leaves_own_their_memory_on_the_named_device():
    payload = tw.encode_params(_to_torch(_bf16_tree()))
    flat = tw.decode_params(payload, device="cpu")
    for t in flat.values():
        assert t.device.type == "cpu"
        t.add_(1)  # writable, and never a view of the received bytes
    assert tw.decode_params(payload)["norm/scale"].tolist() != flat["norm/scale"].tolist()


def test_restore_like_and_decode_check_the_structure():
    tmpl = _to_torch(_bf16_tree())
    payload = tw.encode_params(tmpl)
    update = tw.ModelUpdate.decode(payload, tmpl, ["a"], 3)
    assert update.contributors == ["a"] and update.num_samples == 3
    for a, b in zip(tree_leaves(update.params), tree_leaves(tmpl)):
        assert _same_leaf(_as_numpy(a), _as_numpy(b))
    with pytest.raises(ModelNotMatchingError, match="paths differ"):
        tw.ModelUpdate.decode(payload, {"other": torch.zeros(2)}, [], 1)
    wrong = tree_map(lambda t: t[:1], tmpl)
    with pytest.raises(ModelNotMatchingError, match="shape mismatch"):
        tw.ModelUpdate.decode(payload, wrong, [], 1)


def test_anchor_digest_and_size_estimate_match_jax():
    tree = _mlp_tree()
    assert tw.anchor_digest(_to_torch(tree)) == jw.anchor_digest(tree)
    upd = tw.ModelUpdate(_to_torch(tree), ["a"], 1)
    raw = sum(np.asarray(x).nbytes for x in jax.tree.leaves(tree))
    assert tw.estimate_payload_bytes(upd) == raw + 4096 == jw.estimate_payload_bytes(jw.ModelUpdate(tree))
    upd.encode()
    assert tw.estimate_payload_bytes(upd) == len(upd.encoded)
    assert tw.estimate_payload_bytes(tw.ModelUpdate(None)) is None


# ---- the encode-once payload cache ----


@pytest.mark.parametrize("sends", [1, 4])
def test_one_encode_per_model_version_across_k_sends(sends):
    learner = DummyLearner(device="cpu")
    learner.set_addr("me")
    for flavour in ("unary", "chunks", "iter"):
        learner.bump_model_version()
        before = tw.encode_call_count()
        payloads = []
        for _ in range(sends):
            upd = learner.get_model_update()
            upd.cache_round = 0
            if flavour == "unary":
                payloads.append(upd.encode())
            elif flavour == "chunks":
                payloads.append(tw.payload_from_chunks(upd.encode_chunks()))
            else:
                payloads.append(tw.payload_from_chunks(list(upd.iter_chunks())))
        assert tw.encode_call_count() - before == 1, flavour
        assert len(set(payloads)) == 1
    # a new version (or another round) encodes again
    before = tw.encode_call_count()
    learner.fit()
    upd = learner.get_model_update()
    upd.cache_round = 0
    upd.encode()
    upd2 = learner.get_model_update()
    upd2.cache_round = 1
    upd2.encode()
    assert tw.encode_call_count() - before == 2
    cache = learner.payload_cache()
    assert cache.owner == "me" and cache.hits >= 2 * (sends - 1)


def test_unary_and_chunk_entries_reuse_each_other():
    learner = DummyLearner(device="cpu")
    upd = learner.get_model_update()
    upd.cache_round = 0
    before = tw.encode_call_count()
    chunks = upd.encode_chunks()
    again = learner.get_model_update()
    again.cache_round = 0
    assert again.encode() == tw.payload_from_chunks(chunks)
    assert tw.encode_call_count() - before == 1


def test_ef_fold_is_owned_once_per_content():
    cache = tw.PayloadCache("me")
    upd = tw.ModelUpdate({"w": torch.zeros(2)}, ["me"], 1, payload_cache=cache, cache_version=3, cache_round=1)
    key = upd.ef_fold_key("none")
    assert cache.ef_fold_once(key) and not cache.ef_fold_once(key)
    assert jw.ModelUpdate(None, cache_version=3, cache_round=1).ef_fold_key("none") == key


# ---- the in-memory transport's byte path ----


def _fleet(n: int, data, seed_base: int = 0):
    nodes = [
        Node(learner=TorchLearner(mlp(seed=seed_base + i, device="cpu"), data.partition(i, n),
                                  batch_size=64, seed=i))
        for i in range(n)
    ]
    for node in nodes:
        node.start()
    for node in nodes:
        full_connection(node, nodes)
    wait_convergence(nodes, n - 1, only_direct=True, wait=10)
    return nodes


def _federate(codec: bool, threshold_mb: float = 8.0) -> tuple[list, dict]:
    Settings.MEMORY_WIRE_CODEC = codec
    Settings.WIRE_STREAM_THRESHOLD = threshold_mb
    MemoryRegistry.reset()
    tw.reset_wire_stats()
    logger.reset_comm_metrics()
    data = FederatedDataset.synthetic_mnist(n_train=512, n_test=64)
    nodes = _fleet(2, data)
    try:
        nodes[0].set_start_learning(rounds=2, epochs=1)
        wait_to_finish(nodes, timeout=60)
        params = [[x.clone() for x in tree_leaves(n.learner.get_parameters())] for n in nodes]
        metrics = {n.addr: logger.get_comm_metrics(n.addr) for n in nodes}
    finally:
        for n in nodes:
            n.stop()
    return params, metrics


@pytest.mark.parametrize("threshold_mb", [8.0, 0.1])
def test_memory_byte_path_is_bit_equal_to_the_reference_path(threshold_mb):
    """2 nodes, 2 rounds: FedAvg of two halves is exact in any order, so
    shipping fp32 params through the codec (unary at the default
    threshold, streamed at 0.1 MB) changes no bit of the result."""
    ref, _ = _federate(codec=False)
    got, metrics = _federate(codec=True, threshold_mb=threshold_mb)
    stats = tw.wire_stats()
    assert stats["payload_bytes"] > 0 and tw.encode_call_count() > 0
    for a, b in zip(ref, got):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    for x, y in zip(got[0], got[1]):
        assert torch.equal(x, y)
    if threshold_mb < 1:
        assert stats["stream_encodes"] + sum(m.get("stream_recv", 0) for m in metrics.values()) > 0
        assert sum(m.get("stream_recv", 0) for m in metrics.values()) > 0
        assert 0 < stats["stream_peak_scratch_bytes"] < 2 * 1024 * 1024
    else:
        assert stats["stream_encodes"] == 0


def test_memory_byte_path_mismatched_architecture_stops_the_receiver():
    """The byte codec checks structure by name and shape: a peer with
    another head (4 classes, not 10) makes the receiving node stop itself
    on the initial model instead of hanging."""
    Settings.MEMORY_WIRE_CODEC = True
    data = FederatedDataset.synthetic_mnist(n_train=256, n_test=32)
    a = Node(learner=TorchLearner(mlp(seed=0, device="cpu"), data.partition(0, 2), batch_size=64))
    b = Node(learner=TorchLearner(mlp(seed=1, num_classes=4, device="cpu"), data.partition(1, 2), batch_size=64))
    for n in (a, b):
        n.start()
    try:
        a.connect(b.addr)
        wait_convergence([a, b], 1, only_direct=True, wait=10)
        a.set_start_learning(rounds=1, epochs=1)
        deadline = time.monotonic() + 20
        while b.is_running() and time.monotonic() < deadline:
            time.sleep(0.1)
        assert not b.is_running()
    finally:
        a.stop()
        b.stop()
