"""The plain flash versions at head widths 32 and 128 (the CUDA kernels'
other two builds) against the JAX package's Pallas kernels in interpret
mode on the CPU: the forward's O and lse in fp32 and bf16, and both
backward structures (fused, split) against ``jax.grad`` through the
Pallas backward kernels, causal and full, at the CPU defaults row's
blocks. The card holds each width's kernels against these plain versions
(``tests/test_torch_cuda_kernels.py``, ``chip_smoke.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2pfl_tpu.ops import flash_attention as jfa
from p2pfl_tpu_torch.ops import autotune
from p2pfl_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(2)

WIDTHS = (32, 128)
# fp32: both sides sum the same fp32 products in another order
FP32_ATOL = 2e-6
GRAD_ATOL = 1e-5


def _qkv(t: int, d: int, seed: int, n: int = 4, b: int = 1, h: int = 2):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, t, h, d)).astype(np.float32) for _ in range(n)]


def _cfgs(t: int, d: int, bwd_mode: str = "auto"):
    """The port's CPU defaults row at (t, d) and JAX's config of the same
    blocks."""
    cfg = autotune.default_flash_config(t, d)
    return (tfa.FlashConfig(cfg.block_q, cfg.block_k, bwd_mode=bwd_mode),
            jfa.FlashConfig(cfg.block_q, cfg.block_k, bwd_mode=bwd_mode))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", WIDTHS)
def test_plain_forward_matches_pallas_interpret_at_width(d, causal):
    """O and lse at T 256 (two 128-row blocks of the defaults row), fp32
    within 2e-6; bf16 inputs within one bf16 ulp at |O| <= 1 (2^-7)."""
    t = 256
    q, k, v = _qkv(t, d, seed=d + causal, n=3)
    tcfg, jcfg = _cfgs(t, d)
    want, (_, _, _, _, want_lse) = jfa._fwd(*(jnp.asarray(x) for x in (q, k, v)), causal, jcfg, True)
    qt, kt, vt = (torch.tensor(x).transpose(1, 2).contiguous() for x in (q, k, v))
    out, lse = tfa.flash_fwd_bhtd(qt, kt, vt, causal, tcfg)
    np.testing.assert_allclose(out.transpose(1, 2).numpy(), np.asarray(want), atol=FP32_ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse)[:, :, 0, :], atol=FP32_ATOL)
    jb = jfa.flash_attention(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), causal, jcfg, True)
    tb = tfa.flash_attention(*(torch.tensor(x, dtype=torch.bfloat16) for x in (q, k, v)), causal, tcfg)
    np.testing.assert_allclose(tb.float().numpy(), np.asarray(jb.astype(jnp.float32)), atol=2.0 ** -7)


@pytest.mark.parametrize("bwd_mode", ["fused", "split"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", WIDTHS)
def test_plain_backward_matches_pallas_interpret_at_width(d, causal, bwd_mode):
    """dQ, dK, dV of the autograd.Function under each backward structure
    against ``jax.grad`` of the Pallas flash attention in interpret mode
    (its fused or split backward kernels) at T 256 (two blocks), fp32
    within 1e-5."""
    t = 256
    q, k, v, g = _qkv(t, d, seed=10 + d + causal)
    tcfg, jcfg = _cfgs(t, d, bwd_mode)
    want = jax.grad(
        lambda a, b, c: jnp.sum(jfa.flash_attention(a, b, c, causal, jcfg, True) * g), argnums=(0, 1, 2)
    )(*(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    tfa.flash_attention(tq, tk, tv, causal, tcfg).backward(torch.tensor(g))
    for w, x in zip(want, (tq, tk, tv)):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(w), atol=GRAD_ATOL)
