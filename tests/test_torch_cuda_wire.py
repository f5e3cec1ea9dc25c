"""The byte codec on the card: encoding tensors that live on a GPU gives
the bytes of encoding their CPU copies, and decoding lands bit-equal
bf16 and fp32 leaves on the receiving learner's device, unary and
streamed.

Marked ``cuda``: it needs an NVIDIA GPU and skips elsewhere. It imports
nothing of the JAX package, so it runs on a machine without flax:

    timeout 300 python -m pytest -m cuda tests/test_torch_cuda_wire.py
"""

import pytest
import torch

from p2pfl_tpu_torch import native
from p2pfl_tpu_torch.learning import weights as tw
from p2pfl_tpu_torch.learning.dataset import FederatedDataset
from p2pfl_tpu_torch.learning.learner import TorchLearner
from p2pfl_tpu_torch.models.vision import mlp
from p2pfl_tpu_torch.ops.tree import tree_items, tree_map

CHUNK = 64 * 1024


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the codec's device-to-host and host-to-device paths)")
    return torch.device("cuda")


def _trees(device) -> dict:
    gen = torch.Generator(device="cpu").manual_seed(0)
    bf16 = {
        "layer_0": {"wq": torch.randn(256, 192, generator=gen).to(torch.bfloat16),
                    "norm": torch.randn(192, generator=gen).to(torch.bfloat16)},
        "steps": torch.arange(5, dtype=torch.int32),
    }
    return {"mlp_fp32": mlp(seed=0, device=device).params, "bf16": tree_map(lambda t: t.to(device), bf16)}


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.reshape(-1).view(torch.uint8).cpu(), b.reshape(-1).view(torch.uint8).cpu()
    )


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["mlp_fp32", "bf16"])
def test_encoding_card_tensors_gives_the_bytes_of_their_cpu_copies(cuda, name):
    tree = _trees(cuda)[name]
    on_cpu = tree_map(lambda t: t.cpu(), tree)
    before = tw.wire_stats()["d2h_bytes"]
    assert tw.encode_params(tree) == tw.encode_params(on_cpu)
    assert tw.encode_params_chunked(tree, chunk_bytes=CHUNK) == tw.encode_params_chunked(on_cpu, chunk_bytes=CHUNK)
    raw = sum(t.numel() * t.element_size() for _, t in tree_items(tree))
    assert tw.wire_stats()["d2h_bytes"] - before == 2 * raw
    assert native.NATIVE


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["mlp_fp32", "bf16"])
def test_decoding_lands_bit_equal_leaves_on_the_named_card(cuda, name):
    tree = _trees(cuda)[name]
    payload = tw.encode_params(tree)
    flat = tw.decode_params(payload, device=cuda)
    dec = tw.StreamDecoder(device=cuda)
    for frame in tw.chunk_encoded_payload(payload, CHUNK):
        dec.feed(frame)
    for got in (flat, dec.result_flat()):
        for key, leaf in tree_items(tree):
            assert got[key].device == leaf.device and _bits_equal(got[key], leaf), key


@pytest.mark.cuda
def test_the_learner_decodes_onto_its_own_card(cuda):
    data = FederatedDataset.synthetic_mnist(n_train=64, n_test=16)
    sender = TorchLearner(mlp(seed=1, device="cpu"), data)
    receiver = TorchLearner(mlp(seed=2, device=cuda), data)
    wire = tw.ModelUpdate(None, ["peer"], 7, encoded=tw.encode_params(sender.get_parameters()))
    got = receiver.decode_update(wire)
    assert got.contributors == ["peer"] and got.num_samples == 7
    for (key, a), (_, b) in zip(tree_items(got.params), tree_items(sender.get_parameters())):
        assert a.device.type == "cuda" and _bits_equal(a, b), key
