"""The int8/topk8 codec on the card: the device producer's idx, q, scale,
residual and frame equal the CPU's run of it bit for bit (exact ties
included) over three rounds of error feedback, kernel 9 moves an
odd-length int8/int32 codec tree as its plain version does, and one
update through the ICI plane's ``_move_codec`` between two slots of the
card equals ``encode_params`` → ``decode_params`` of it; a tk8 leaf of
another size than the receiver's anchor fails its decode and leaves the
card's context working.

Marked ``cuda``: it needs an NVIDIA GPU and skips elsewhere. It imports
nothing of the JAX package, so it runs on a machine without flax:

    timeout 300 python -m pytest -m cuda tests/test_torch_cuda_compress.py
"""

import numpy as np
import pytest
import torch

from p2pfl_tpu_torch.communication import ici
from p2pfl_tpu_torch.learning import weights as tw
from p2pfl_tpu_torch.models.vision import mlp
from p2pfl_tpu_torch.ops import _kernels
from p2pfl_tpu_torch.ops import compression as comp
from p2pfl_tpu_torch.ops.tree import tree_items, tree_leaves, tree_map
from p2pfl_tpu_torch.parallel.ici_plane import exchange_plain, slice_info_of
from p2pfl_tpu_torch.parallel.mesh import node_slices, submesh_federation_mesh
from p2pfl_tpu_torch.settings import Settings


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the device producer on the card, kernel 9)")
    prev = Settings.WIRE_COMPRESSION_DEVICE
    Settings.WIRE_COMPRESSION_DEVICE = True
    yield torch.device("cuda")
    Settings.WIRE_COMPRESSION_DEVICE = prev


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.reshape(-1).view(torch.uint8).cpu(), b.reshape(-1).view(torch.uint8).cpu()
    )


def _tree(seed: int) -> dict:
    """Ties on purpose: an all-zero delta leaf, a leaf of repeated
    magnitudes, a leaf of at most 16 elements, a bf16 and an int leaf."""
    rng = np.random.default_rng(seed)
    return {
        "dense": torch.from_numpy(rng.normal(size=(96, 40)).astype(np.float32)),
        "zeros": torch.zeros(300),
        "steps": torch.from_numpy((np.round(rng.normal(size=500) * 2) / 2).astype(np.float32)),
        "small": torch.from_numpy(rng.normal(size=12).astype(np.float32)),
        "half": torch.from_numpy(rng.normal(size=(8, 9)).astype(np.float32)).to(torch.bfloat16),
        "count": torch.arange(7, dtype=torch.int32),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["int8", "topk8"])
def test_device_producer_on_the_card_equals_the_cpu_bit_for_bit(cuda, mode):
    anchor = _tree(1)
    anchor["zeros"] = torch.zeros(300)
    res_card, res_cpu = {}, {}
    for r in range(3):
        params = _tree(10 + r)
        params["zeros"] = torch.zeros(300)  # delta all zero: every magnitude ties
        card = tw.encode_params(tree_map(lambda t: t.to(cuda), params), compression=mode,
                                anchor=tree_map(lambda t: t.to(cuda), anchor), anchor_tag="0:1", residual=res_card)
        cpu = tw.encode_params(params, compression=mode, anchor=anchor, anchor_tag="0:1", residual=res_cpu)
        assert card == cpu, (mode, r)
        assert sorted(res_card) == sorted(res_cpu)
        for key in res_cpu:
            assert res_card[key].device.type == "cuda"
            assert _bits_equal(res_card[key], res_cpu[key]), (key, r)
        got = tw.decode_params(card, cuda, anchor=tree_map(lambda t: t.to(cuda), anchor), anchor_tag="0:1")
        want = tw.decode_params(cpu, anchor=anchor, anchor_tag="0:1")
        for key in want:
            assert got[key].device.type == "cuda" and _bits_equal(got[key], want[key]), key


@pytest.mark.cuda
def test_topk_positions_take_the_lowest_indices_among_ties_on_the_card(cuda):
    for mags, k, want in (([0, 1, 0, 1, 0, 0, 1, 0], 5, [0, 1, 2, 3, 6]), ([0] * 40, 6, list(range(6)))):
        t = torch.tensor(mags, dtype=torch.float32, device=cuda)
        assert comp.topk_positions(t, k).cpu().tolist() == want


@pytest.mark.cuda
def test_kernel_9_moves_an_odd_length_codec_tree_as_its_plain_version(cuda):
    gen = torch.Generator(device="cuda").manual_seed(3)
    srcs = [
        torch.randint(-2**31, 2**31 - 1, (n,), generator=gen, device=cuda, dtype=torch.int32)
        for n in (1, 7, 10037, 1639)
    ] + [
        torch.randint(-127, 128, (n,), generator=gen, device=cuda, dtype=torch.int8) for n in (1, 15, 17, 11683)
    ] + [torch.randn(5, generator=gen, device=cuda), torch.randn((3, 5, 7), generator=gen, device=cuda).to(torch.bfloat16)]
    assert {s.numel() * s.element_size() % 16 for s in srcs} - {0}
    dsts = [torch.full_like(s, 0) for s in srcs]
    refs = [torch.full_like(s, 0) for s in srcs]
    before = _kernels.LAUNCHES["ici_exchange"]
    _kernels.ici_exchange(srcs, dsts)
    exchange_plain(srcs, refs)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["ici_exchange"] == before + 1
    assert all(_bits_equal(d, r) and _bits_equal(d, s) for d, r, s in zip(dsts, refs, srcs))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["int8", "topk8"])
def test_move_codec_between_two_slots_equals_the_byte_path(cuda, mode):
    params, anchor, template = (dict(mlp(seed=s, device=cuda).params) for s in (0, 1, 2))
    for t, s in ((params, 0), (anchor, 1), (template, 2)):
        t["extra"] = {"half": torch.full((3, 5), float(s), device=cuda).to(torch.bfloat16)}
    slices = node_slices(submesh_federation_mesh(2, devices=[cuda] * 2))
    src, dst = slice_info_of(params, slices[0]), slice_info_of(template, slices[1])

    class _Receiver:
        @staticmethod
        def wire_anchor():
            return anchor, "1:0"

    # a residual an earlier round left behind folds into both encodes
    residual = {} if mode == "topk8" else None
    tw.encode_params(template, compression=mode, anchor=anchor, anchor_tag="0:9", residual=residual)
    before = _kernels.LAUNCHES["ici_exchange"]
    update = tw.ModelUpdate(params, ["a"], 10, anchor=anchor, anchor_tag="1:0", ef_residual=residual)
    got, want, moved, srcs = ici.move_codec_against_bytes(update, template, src, dst, _Receiver(), mode)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["ici_exchange"] == before + 1  # one exchange a send
    assert 0 < moved == sum(t.numel() * t.element_size() for t in srcs)
    assert moved < sum(t.numel() * t.element_size() for t in tree_leaves(params))
    want = dict(tree_items(want))
    for key, leaf in tree_items(got):
        assert leaf.device.type == "cuda" and _bits_equal(leaf, want[key]), key


@pytest.mark.cuda
@pytest.mark.parametrize("frame_size", [100, 40])
def test_tk8_leaf_larger_or_smaller_than_the_anchor_rejected_on_the_card(cuda, frame_size):
    """The device consumer checks a peer's leaf size against the anchor
    before its scatter: past the anchor's end the scatter would trap the
    card's context for every node in the process."""
    frame = tw.encode_params({"w": torch.arange(frame_size, dtype=torch.float32, device=cuda)}, compression="topk8",
                             anchor={"w": torch.zeros(frame_size, device=cuda)}, anchor_tag="0:0")
    with pytest.raises(tw.DecodingParamsError, match=f"anchor leaf w has 64 elements, frame {frame_size}"):
        tw.decode_params(frame, cuda, anchor={"w": torch.zeros((8, 8), device=cuda)}, anchor_tag="0:0")
    # the context still works
    assert torch.zeros(4, device=cuda).add_(1).sum().item() == 4
