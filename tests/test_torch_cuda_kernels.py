"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: they need an NVIDIA GPU with ``nvcc`` (Hopper, sm_90a)
and skip elsewhere. Run them on the card with

    python -m pytest -m cuda tests/test_torch_cuda_kernels.py

``chip_smoke.py`` checks the same kernels at the main path's shape.
"""

import pytest
import torch

from p2pfl_tpu_torch.ops import _kernels
from p2pfl_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda

# same rounding points on both sides, fp32 sums in other orders (and
# atomics for the fused dQ): a bf16 output may move by an ulp or two, so
# each element is held to RTOL·|ref| plus RTOL of the reference's RMS (a
# limit set by the typical value, not by the few largest rows)
RTOL = 2.0 ** -6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(cuda, b=2, h=4, t=128, d=64, n=4, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    return [
        torch.randn((b, h, t, d), generator=gen, device=cuda).to(torch.bfloat16) for _ in range(n)
    ]


def _close(got, want):
    got, want = got.float(), want.float()
    atol = RTOL * want.pow(2).mean().sqrt().item()
    assert ((got - want).abs() <= RTOL * want.abs() + atol).all()


@pytest.mark.parametrize("causal", [True, False])
def test_kernels_match_plain(cuda, causal):
    q, k, v, do = _inputs(cuda)
    o, lse = _kernels.flash_fwd(q, k, v, causal)
    o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, causal, 64, 64)
    _close(o, o_ref)
    assert (lse - lse_ref).abs().max().item() <= 1e-4
    delta = (do.float() * o.float()).sum(-1)
    want = fa.flash_bwd_fused_plain(q, k, v, do, lse, delta, causal, 64, 64)
    for got_fused, got_split, ref in zip(
        _kernels.flash_bwd_fused(q, k, v, do, lse, delta, causal),
        _kernels.flash_bwd_split(q, k, v, do, lse, delta, causal),
        want,
    ):
        _close(got_fused, ref)
        _close(got_split, ref)
    torch.cuda.synchronize()


@pytest.mark.parametrize("bwd_mode", ["fused", "split"])
def test_autograd_on_card_matches_cpu_plain(cuda, bwd_mode):
    q, k, v, g = (x.transpose(1, 2) for x in _inputs(cuda, t=192))
    cfg = fa.FlashConfig(64, 64, bwd_mode=bwd_mode)
    grads = []
    for dev in (cuda, torch.device("cpu")):
        xs = [x.detach().to(dev).requires_grad_(True) for x in (q, k, v)]
        out = fa.flash_attention(*xs, True, cfg)
        out.backward(g.to(dev))
        grads.append([out.detach().cpu()] + [x.grad.cpu() for x in xs])
    for got, want in zip(*grads):
        _close(got, want)


def test_launch_counts_and_refusals(cuda):
    q, k, v, _ = _inputs(cuda)
    _kernels.reset_launches()
    _kernels.flash_fwd(q, k, v, True)
    assert _kernels.LAUNCHES["flash_fwd"] == 1
    with pytest.raises(TypeError):
        _kernels.flash_fwd(q.float(), k.float(), v.float(), True)
    with pytest.raises(ValueError, match="multiple"):
        _kernels.flash_fwd(q[:, :, :100].contiguous(), k[:, :, :100].contiguous(), v[:, :, :100].contiguous(), True)
    with pytest.raises(ValueError, match="head_dim"):
        _kernels.flash_fwd(*(x[..., :32].contiguous() for x in (q, k, v)), True)
    with pytest.raises(ValueError, match="contiguous"):
        _kernels.flash_fwd(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), True)
    assert _kernels.LAUNCHES["flash_fwd"] == 1
