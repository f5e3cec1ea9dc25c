"""Time-sharing on the card: ``ChunkedFederation``'s chunk paths (the
serial reduce, the fused one eager and the fused one as a captured CUDA
graph) bit for bit, and the LoRA LM's ``mlp_qkv`` remat against no remat
through the flash kernels.

Marked ``cuda``: it needs an NVIDIA GPU and skips elsewhere. It imports
nothing of the JAX package, so it runs on a machine without flax:

    timeout 600 python -m pytest -m cuda tests/test_torch_cuda_chunked.py
"""

from dataclasses import replace

import pytest
import torch

from p2pfl_tpu_torch.learning.dataset import FederatedDataset
from p2pfl_tpu_torch.learning.learner import GradientTransformation
from p2pfl_tpu_torch.learning.optimizers import adam, warmup_cosine_decay_schedule
from p2pfl_tpu_torch.models.base import TorchModel
from p2pfl_tpu_torch.models.vision import ResNet, init_resnet_params
from p2pfl_tpu_torch.ops.tree import tree_items, tree_map
from p2pfl_tpu_torch.parallel import ChunkedFederation
from p2pfl_tpu_torch.settings import Settings

SHAPE = (16, 16, 3)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the chunk graph and the flash kernels run there)")
    yield torch.device("cuda")
    Settings.CHUNK_FUSED_REDUCE, Settings.CHUNK_STAGING_DEPTH = True, 2


def _fed(cuda, capturable: bool = True, resident: bool = True) -> ChunkedFederation:
    """8 nodes in chunks of 4 of a reduced-depth ResNet under remat, Adam
    over a schedule with averaged moments."""
    tx = adam(warmup_cosine_decay_schedule(0.0, 3e-3, 4, 40, 1e-4))
    if not capturable:
        tx = GradientTransformation(tx.init, tx.update, False, tx.node_stacked)
    module = ResNet((1, 1))
    model = TorchModel(module, init_resnet_params(module, SHAPE, 0, cuda), SHAPE)
    data = FederatedDataset.synthetic_mnist(n_train=8 * 64, n_test=8 * 16, dim=SHAPE, modes=2, noise=0.5,
                                            proto_scale=0.7)
    return ChunkedFederation.from_dataset(model, data, n_nodes=8, chunk_size=4, batch_size=16, vote=False,
                                          seed=3, remat=True, tx=tx, keep_opt_state=True, resident=resident,
                                          device=cuda)


def _state(fed) -> list:
    return torch.utils._pytree.tree_leaves((fed.params, fed.opt_state))


@pytest.mark.cuda
def test_fused_path_is_bit_equal_to_the_serial_path(cuda):
    """The fused reduce (eager, in-place accumulators, staging depth 2,
    data streamed from pinned host memory) against the serial reduce
    (staging depth 1): the same params, averaged moments and losses."""
    Settings.CHUNK_FUSED_REDUCE, Settings.CHUNK_STAGING_DEPTH = False, 1
    serial = _fed(cuda)
    want = [serial.run_round()["train_loss"] for _ in range(2)]
    Settings.CHUNK_FUSED_REDUCE, Settings.CHUNK_STAGING_DEPTH = True, 2
    fused = _fed(cuda, capturable=False, resident=False)
    got = [fused.run_round()["train_loss"] for _ in range(2)]
    assert got == want and not fused._graphs
    assert all(torch.equal(a, b) for a, b in zip(_state(fused), _state(serial), strict=True))


@pytest.mark.cuda
def test_captured_chunk_is_bit_equal_to_eager(cuda):
    """The chunk program (remat included) captured once a chunk shape and
    replayed for every chunk of 3 rounds, a reset between: the eager
    fused path's bits, round after round."""
    graph, eager = _fed(cuda), _fed(cuda, capturable=False)
    for r in range(3):
        if r == 2:
            graph.reset(seed=3)
            eager.reset(seed=3)
        assert graph.run_round()["train_loss"] == eager.run_round()["train_loss"]
        assert all(torch.equal(a, b) for a, b in zip(_state(graph), _state(eager), strict=True))
    assert len(graph._graphs) == 1 and not eager._graphs


@pytest.mark.cuda
def test_mlp_qkv_remat_against_no_remat_through_the_flash_kernels(cuda):
    """A 2-layer LoRA LM at head dim 64 (256d/4h/kv2, seq 256) on the
    flash kernels: with the split backward (kernels 3 and 4, each tile
    from one block) one step's loss and adapter gradients under every
    remat policy equal those without remat bit for bit; with the fused
    backward (kernel 2 adds dQ tiles in the order its blocks finish) the
    loss is bit-equal and the gradients within twice the gap of two runs
    without remat."""
    from p2pfl_tpu_torch.learning.lora import _lm_loss, split_lora
    from p2pfl_tpu_torch.models.transformer import CausalLM, TransformerConfig, init_params
    from p2pfl_tpu_torch.ops.flash_attention import FlashConfig

    def rel(a, b):
        num = sum(float((x - y).double().square().sum()) for x, y in zip(a, b))
        return (num / sum(float(x.double().square().sum()) for x in a)) ** 0.5

    base_cfg = TransformerConfig(vocab_size=512, dim=256, n_layers=2, n_heads=4, n_kv_heads=2, ffn_hidden=512,
                                 lora_mlp=True)
    lora, base = split_lora(init_params(base_cfg, seed=0, device=cuda))
    gen = torch.Generator(device=cuda).manual_seed(1)
    lora = tree_map(lambda t: t + 0.02 * torch.randn(t.shape, generator=gen, device=cuda), lora)
    x = torch.randint(0, 512, (4, 256), generator=gen, device=cuda)
    y = torch.randint(0, 512, (4, 256), generator=gen, device=cuda)

    def step(cfg):
        leaves = tree_map(lambda t: t.detach().clone().requires_grad_(True), lora)
        loss, _ = _lm_loss(leaves, base, CausalLM(cfg), x, y)
        loss.backward()
        return loss.detach(), [t.grad.float() for _, t in tree_items(leaves)]

    for mode in ("split", "fused"):
        plain = replace(base_cfg, flash_config=FlashConfig(bwd_mode=mode))
        ref, again = step(plain), step(plain)
        for policy in (None, "mlp", "mlp_qkv"):
            loss, grads = step(replace(plain, remat=True, remat_policy=policy))
            assert torch.equal(loss, ref[0]), (mode, policy)
            if mode == "split":
                assert all(torch.equal(a, b) for a, b in zip(grads, ref[1])), policy
            else:
                assert rel(ref[1], grads) <= 2 * rel(ref[1], again[1]), policy
