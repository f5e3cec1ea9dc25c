"""The port's flash attention (plain PyTorch versions, CPU) against the JAX
package: Pallas kernels in interpret mode for the forward, ``jax.grad`` of
the dense reference for the backward, and ``torch.autograd.gradcheck`` in
float64. The CUDA kernels themselves are held against these plain versions
on the card (``tests/test_torch_cuda_kernels.py``, ``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2pfl_tpu.ops import autotune as jax_autotune
from p2pfl_tpu.ops import flash_attention as jfa
from p2pfl_tpu.ops.attention import causal_attention as jax_causal_attention
from p2pfl_tpu_torch.ops import _kernels, autotune
from p2pfl_tpu_torch.ops import flash_attention as tfa
from p2pfl_tpu_torch.ops.attention import causal_attention

torch.set_num_threads(2)

# fp32 paths: both sides sum the same fp32 products in another order
FP32_ATOL = 2e-6


def _qkv(b=2, t=32, h=4, d=16, seed=0, n=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, t, h, d)).astype(np.float32) for _ in range(n)]


def _t(*arrays, dtype=torch.float32, grad=False):
    return [torch.tensor(a, dtype=dtype, requires_grad=grad) for a in arrays]


def _dense_full(q, k, v):
    """Non-causal reference attention in JAX (fp32)."""
    s = jnp.einsum("bqhd,bkhd->bhqk", q, k) * (q.shape[-1] ** -0.5)
    return jnp.einsum("bhqk,bkhd->bqhd", jax.nn.softmax(s, axis=-1), v)


SCHEDULES = [(16, 16, 1), (16, 8, 2), (8, 16, 2), (8, 8, 4)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("block_q,block_k,q_span", SCHEDULES)
def test_plain_forward_matches_pallas_interpret(causal, block_q, block_k, q_span):
    """O and lse of the plain forward equal the Pallas kernel's (interpret
    mode) at blocks != T, including q_span > 1. Tolerance: fp32, 2e-6."""
    q, k, v = _qkv()
    jcfg = jfa.FlashConfig(block_q, block_k, q_span=q_span)
    want, (_, _, _, _, want_lse) = jfa._fwd(
        *(jnp.asarray(x) for x in (q, k, v)), causal, jcfg, True
    )
    cfg = tfa.FlashConfig(block_q, block_k, q_span=q_span)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in _t(q, k, v))
    out, lse = tfa.flash_fwd_bhtd(qt, kt, vt, causal, cfg)
    np.testing.assert_allclose(out.transpose(1, 2).numpy(), np.asarray(want), atol=FP32_ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse)[:, :, 0, :], atol=FP32_ATOL)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_forward_bf16_matches_pallas_interpret(causal):
    """bf16 inputs: the same rounding points (P cast before P·V, output
    cast once) give outputs within one bf16 ulp at |O| <= 1 (2^-7)."""
    q, k, v = _qkv(seed=1)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = jfa.flash_attention(jq, jk, jv, causal, jfa.FlashConfig(16, 8), True)
    got = tfa.flash_attention(*_t(q, k, v, dtype=torch.bfloat16), causal, tfa.FlashConfig(16, 8))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want.astype(jnp.float32)), atol=2.0 ** -7
    )


@pytest.mark.parametrize("bwd_mode", ["fused", "split", "auto"])
@pytest.mark.parametrize("causal", [True, False])
def test_autograd_matches_jax_grad_of_dense(bwd_mode, causal):
    """dQ, dK, dV of the autograd.Function (both backward structures)
    against jax.grad of the dense reference. Tolerance: fp32, 1e-5."""
    q, k, v, g = _qkv(n=4, seed=2)
    ref = jax_causal_attention if causal else _dense_full
    want = jax.grad(lambda a, b, c: jnp.sum(ref(a, b, c) * g), argnums=(0, 1, 2))(
        *(jnp.asarray(x) for x in (q, k, v))
    )
    tq, tk, tv = _t(q, k, v, grad=True)
    out = tfa.flash_attention(tq, tk, tv, causal, tfa.FlashConfig(16, 8, bwd_mode=bwd_mode))
    out.backward(torch.tensor(g))
    for w, x in zip(want, (tq, tk, tv)):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(w), atol=1e-5)


@pytest.mark.parametrize("bwd_mode", ["fused", "split"])
def test_bwd_block_override_matches_pallas_schedule(bwd_mode):
    """block_q_bwd/block_k_bwd re-block only the backward: same gradients."""
    q, k, v, g = _qkv(n=4, seed=3)
    grads = []
    for cfg in (
        tfa.FlashConfig(16, 16, bwd_mode=bwd_mode),
        tfa.FlashConfig(16, 16, block_q_bwd=8, block_k_bwd=32, bwd_mode=bwd_mode),
    ):
        tq, tk, tv = _t(q, k, v, grad=True)
        tfa.flash_attention(tq, tk, tv, True, cfg).backward(torch.tensor(g))
        grads.append([x.grad for x in (tq, tk, tv)])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=FP32_ATOL, rtol=0)


@pytest.mark.parametrize("bwd_mode", ["fused", "split"])
@pytest.mark.parametrize("causal", [True, False])
def test_gradcheck_float64(bwd_mode, causal):
    """Finite differences in float64 at a tiny size (blocks 4 of T 8)."""
    q, k, v = _t(*_qkv(b=1, t=8, h=2, d=4, seed=4), dtype=torch.float64, grad=True)
    cfg = tfa.FlashConfig(4, 4, bwd_mode=bwd_mode)
    assert torch.autograd.gradcheck(
        lambda a, b, c: tfa.flash_attention(a, b, c, causal, cfg), (q, k, v)
    )


def test_dense_causal_attention_matches_jax():
    """The port's "dense" backend, fp32 (2e-6) and bf16 (one ulp, 2^-7)."""
    q, k, v = _qkv(seed=5)
    want = jax_causal_attention(*(jnp.asarray(x) for x in (q, k, v)))
    np.testing.assert_allclose(causal_attention(*_t(q, k, v)).numpy(), np.asarray(want), atol=FP32_ATOL)
    jb = jax_causal_attention(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)))
    got = causal_attention(*_t(q, k, v, dtype=torch.bfloat16))
    np.testing.assert_allclose(got.float().numpy(), np.asarray(jb.astype(jnp.float32)), atol=2.0 ** -7)


@pytest.mark.parametrize("t,d", [(32, 16), (96, 32), (1024, 64), (4096, 128), (8192, 128), (200, 64)])
@pytest.mark.parametrize("mode", ["auto", "fused", "split"])
def test_schedule_helpers_match_jax(t, d, mode):
    """_fit, default_flash_config ("cpu" row), _fit_q_span, _bwd_use_fused
    and _bwd_blocks decide exactly as in the JAX package."""
    assert autotune._fit(t, 128) == jax_autotune._fit(t, 128)
    want = jax_autotune.default_flash_config(t, d, kind="cpu")
    got = autotune.default_flash_config(t, d)
    assert (got.block_q, got.block_k, got.q_span) == (want.block_q, want.block_k, want.q_span)
    jcfg = jfa.FlashConfig(want.block_q, want.block_k, bwd_mode=mode)
    tcfg = tfa.FlashConfig(got.block_q, got.block_k, bwd_mode=mode)
    assert tfa._bwd_use_fused(t, d, mode) == jfa._bwd_use_fused(t, d, mode)
    assert tfa._bwd_blocks(t, d, tcfg) == jfa._bwd_blocks(t, d, jcfg)
    for span in (1, 2, 3, 4):
        assert tfa._fit_q_span(t, got.block_q, span) == jfa._fit_q_span(t, want.block_q, span)


def test_flash_config_validates_like_jax():
    with pytest.raises(ValueError, match="bwd_mode"):
        tfa.FlashConfig(bwd_mode="sideways")
    with pytest.raises(ValueError):
        tfa.FlashConfig(block_q=0)
    with pytest.raises(ValueError, match="divide"):
        tfa._clamp_blocks(48, 32, 16)


def test_cuda_wrappers_refuse_cpu_tensors():
    """A wrapper never falls back: a CPU tensor given to a kernel wrapper
    raises before anything is built or launched."""
    q, k, v = (x.transpose(1, 2).contiguous() for x in _t(*_qkv(t=64, d=64), dtype=torch.bfloat16))
    before = dict(_kernels.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        _kernels.flash_fwd(q, k, v, True)
    lse = torch.zeros(q.shape[:3])
    with pytest.raises(ValueError, match="CUDA"):
        _kernels.flash_bwd_fused(q, k, v, q, lse, lse, True)
    with pytest.raises(ValueError, match="CUDA"):
        _kernels.flash_bwd_split(q, k, v, q, lse, lse, True)
    with pytest.raises(ValueError, match="CUDA"):
        _kernels.flash_fwd_offs(q, k, v, 64, 0)
    for offs_bwd in (_kernels.flash_bwd_fused_offs, _kernels.flash_bwd_split_offs,
                     _kernels.flash_bwd_dq_offs, _kernels.flash_bwd_dkv_offs):
        with pytest.raises(ValueError, match="CUDA"):
            offs_bwd(q, k, v, q, lse, lse, lse, 64, 0)
    assert _kernels.LAUNCHES == before
    assert _kernels._lib is None  # nothing was built


def test_dispatch_refuses_other_devices():
    q = torch.zeros((1, 4, 64, 16), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tfa.flash_fwd_bhtd(q, q, q, True, tfa.FlashConfig())
