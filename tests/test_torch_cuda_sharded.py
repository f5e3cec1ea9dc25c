"""Sharded nodes on the card: kernel 9 over per-slot blocks and the
sharded federation's bit-equality across ``model_parallel``.

Marked ``cuda``: they need an NVIDIA GPU with ``nvcc`` and skip elsewhere.
This file imports only the port (the card machine has no flax):

    timeout 600 python -m pytest -m cuda tests/test_torch_cuda_sharded.py

``chip_smoke.py --only sharded`` drives the same paths at config 5's
width and on gossip Nodes.
"""

import pytest
import torch

from p2pfl_tpu_torch.learning.dataset import FederatedDataset
from p2pfl_tpu_torch.models.transformer import TransformerConfig, tiny_transformer
from p2pfl_tpu_torch.ops import _kernels
from p2pfl_tpu_torch.ops.flash_attention import FlashConfig
from p2pfl_tpu_torch.ops.tree import tree_items, tree_leaves
from p2pfl_tpu_torch.parallel import ShardedNodeFederation, ici_plane
from p2pfl_tpu_torch.parallel import sharding as tsh
from p2pfl_tpu_torch.parallel.mesh import node_slices, submesh_federation_mesh

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    _kernels.build()
    return torch.device("cuda")


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1).view(torch.uint8)


def test_kernel9_moves_every_slot_block_of_a_mixed_tree_in_one_launch(cuda):
    """A mixed fp32 / bf16 / int32 tree placed on a (1, 4) slice of the
    card moves onto a disjoint slice with one launch of kernel 9; every
    block equals what the plain version copies, bit for bit, and lands
    on the receiver's slot."""
    slices = node_slices(submesh_federation_mesh(2, 4, devices=["cuda:0"] * 8))
    rules = ((r"^w$", (None, "model")), (r"^e$", ("model", None)), (r".*", ()))
    gen = torch.Generator(device=cuda).manual_seed(5)

    def tree(sl, salt):
        t = {"w": torch.randn(33, 64, generator=gen, device=cuda) + salt,
             "e": torch.randn(128, 7, generator=gen, device=cuda).to(torch.bfloat16),
             "i": torch.randint(0, 1000, (17,), generator=gen, device=cuda, dtype=torch.int32),
             "s": torch.randn((), generator=gen, device=cuda)}
        return tsh.shard_tree(sl, t, rules)

    src_tree, filler = tree(slices[0], 0.0), tree(slices[1], 1.0)
    src = ici_plane.slice_info_of(src_tree, slices[0])
    dst = ici_plane.slice_info_of(filler, slices[1])
    _kernels.reset_launches()
    out = ici_plane.shard_transfer(src_tree, filler, src, dst)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["ici_exchange"] == 1
    srcs = [b for _, leaf in tree_items(src_tree) for b in ici_plane._blocks(leaf)]
    got = [b for _, leaf in tree_items(out) for b in ici_plane._blocks(leaf)]
    want = [torch.empty_like(b) for b in srcs]
    ici_plane.exchange_plain(srcs, want)
    assert len(got) == 4 + 4 + 1 + 1 and all(torch.equal(_bits(a), _bits(b)) for a, b in zip(got, want))
    assert out["w"].mesh is slices[1] and out["w"].spec == (None, "model")
    assert [tuple(b.shape) for b in out["e"].shards] == [(32, 7)] * 4


def _fed(model_parallel: int):
    cfg = TransformerConfig(vocab_size=256, dim=256, n_heads=4, n_kv_heads=2, n_layers=2, ffn_hidden=512, lora_rank=0,
                            flash_config=FlashConfig(bwd_mode="split"))
    data = FederatedDataset.synthetic_lm(vocab_size=256, seq_len=256, n_train=8, n_test=4, seed=7)
    model = tiny_transformer(seq_len=256, seed=0, cfg=cfg, attn="flash")
    return ShardedNodeFederation.from_dataset(model, data, n_nodes=2, model_parallel=model_parallel, batch_size=2,
                                              vote=False, seed=3, learning_rate=1e-3)


def test_two_rounds_at_model_parallel_2_equal_model_parallel_1_bit_for_bit(cuda):
    """Two rounds of a 2-layer flash LM federation (split backward:
    kernels 1, 3, 4, deterministic) at model_parallel 2 and 1 from one
    seed: every node's params bit-equal, the fold's inputs slot-shard
    stacks, and kernels 1, 3 and 4 launched nodes x steps x layers times
    a round."""
    outs = {}
    for m in (2, 1):
        fed = _fed(m)
        _kernels.reset_launches()
        fed.run(rounds=2)
        torch.cuda.synchronize()
        per_round = 2 * fed._nb * 2
        assert {k: _kernels.LAUNCHES[k] for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "flash_bwd_dkvq")} == \
            {"flash_fwd": 2 * per_round, "flash_bwd_dq": 2 * per_round, "flash_bwd_dkv": 2 * per_round,
             "flash_bwd_dkvq": 0}
        outs[m] = [tree_leaves(tsh.gather_tree(fed.node_params(i))) for i in range(2)]
        if m == 2:
            blocks = fed.last_fold["blocks"]
            assert blocks[("layer_0/attn/wq/kernel", 1)] == (2, 256, 128)
    for i in range(2):
        assert all(torch.equal(a, b) for a, b in zip(outs[2][i], outs[1][i]))
