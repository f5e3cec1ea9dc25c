"""The MoE federation and ``attn="auto"`` on the card.

Marked ``cuda``: they need an NVIDIA GPU and skip elsewhere. On the card:

    timeout 300 python -m pytest -m cuda tests/test_torch_cuda_moe.py

``chip_smoke.py --only moe config7`` drives the same paths at config 10's
and config 7's sizes.
"""

import pytest
import torch

import chip_smoke
from p2pfl_tpu_torch.ops import _kernels

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_moe_round_on_card_matches_cpu(cuda):
    """One SpmdLmFederation round of 2 nodes at 2L/64d with 4 experts
    (fp32, SGD) on the card against the CPU from one init and data: the
    routing of one input identical on both devices, the params within
    ``chip_smoke.C10_PAIR_REL_L2`` relative L2."""
    ok, out = chip_smoke.moe_pair()
    assert out["routing_identical_on_one_input"]
    assert out["params_rel_l2"] <= chip_smoke.C10_PAIR_REL_L2, out
    assert ok


def test_moe_fused_round_is_captured_and_matches_eager(cuda):
    """``run_fused`` captures the MoE round program as a CUDA graph (the
    routing reads nothing back to the host) and its replay equals the
    eager span bit for bit."""
    from p2pfl_tpu_torch.learning.learner import GradientTransformation, adam
    from p2pfl_tpu_torch.ops.tree import tree_leaves

    runs = []
    for capturable in (True, False):
        tx = adam(1e-3)
        if not capturable:
            tx = GradientTransformation(tx.init, tx.update, False, tx.node_stacked)
        fed = chip_smoke._moe_fed(chip_smoke.C10_PAIR, 32, 2, 8, 32, 16, tx=tx)
        losses = [float(e["train_loss"]) for _ in range(2) for e in fed.run_fused(1)]
        runs.append((tree_leaves(fed.params), losses, bool(fed._spans)))
    assert runs[0][2] and not runs[1][2]
    assert runs[0][1] == runs[1][1]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][0], runs[1][0]))


@pytest.mark.parametrize("seq,attn", [(256, "dense"), (512, "flash")])
def test_auto_picks_flash_from_the_threshold_on_the_card(cuda, seq, attn):
    """``attn="auto"`` on the card: dense below ``FLASH_MIN_SEQ_LEN``, the
    flash kernels (launched at head width 32) from it on."""
    from p2pfl_tpu_torch.models.transformer import TransformerConfig, pick_attention, tiny_transformer

    assert pick_attention(seq) == attn
    cfg = TransformerConfig(vocab_size=128, dim=64, n_layers=1, n_heads=2, n_kv_heads=2, ffn_hidden=64, lora_rank=0)
    model = tiny_transformer(seq_len=seq, cfg=cfg, attn="auto")
    _kernels.reset_launches()
    with torch.no_grad():
        model.module(model.params, torch.zeros((1, seq), dtype=torch.long, device=cuda))
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES_BY_WIDTH["flash_fwd"][32] == (1 if attn == "flash" else 0)
