"""Flash-attention schedule defaults (subset of ``p2pfl_tpu/ops/autotune.py``).

Only the shipped ``"cpu"`` row is carried over, so the plain PyTorch
versions on the CPU walk the same blocks as the JAX kernels in interpret
mode, at every head width (its blocks depend on T alone). There is no GPU
row: the CUDA kernels have no block sizes to choose.

On CUDA the kernels use their own fixed tiles at each head width (32, 64
and 128): the forward of ``csrc/flash_fwd_sm90.cu`` 128 q rows a block
(two warpgroups of 64) against 64-row K/V tiles; the split dQ pass of
``csrc/flash_bwd_dq_sm90.cu`` 192 q rows a block (128 at D = 128); the
fused backward and the split dK/dV pass of ``csrc/flash_bwd_sm90.cu`` 128
k rows a block (two warpgroups of 64) against 64-row Q/dO tiles. From a
:class:`FlashConfig` they read only ``bwd_mode`` (fused or split
backward, through ``_bwd_use_fused``) and the ``causal`` flag passed
beside it; block sizes and ``q_span`` shape only the plain versions. The
tuning caches and sweeps are not ported (ROADMAP): with fixed tiles a
sweep would have only ``bwd_mode`` to choose.
"""

from __future__ import annotations

from typing import Optional

from p2pfl_tpu_torch.ops.flash_attention import FlashConfig, _fit_q_span


def _fit(t: int, n: int) -> int:
    """Largest divisor of t that is <= n and a multiple of 8, falling back
    to t itself (block == T always tiles)."""
    got = next((b for b in range(min(n, t), 7, -1) if t % b == 0 and b % 8 == 0), None)
    return got or t


def _clamped(t: int, block_q: int, block_k: int, q_span: int = 1, **kw) -> FlashConfig:
    bq, bk = _fit(t, block_q), _fit(t, block_k)
    return FlashConfig(block_q=bq, block_k=bk, q_span=_fit_q_span(t, bq, q_span), **kw)


DEFAULTS = {
    "cpu": lambda t, d: _clamped(t, 128, 128),
}


def default_flash_config(
    t: int, d: int, dtype=None, causal: bool = True, kind: Optional[str] = None
) -> FlashConfig:
    """The shipped defaults-table config for this shape (the ``cpu`` row is
    the only one; see the module docstring for what CUDA reads of it)."""
    del dtype, causal, kind  # one row, shape-driven
    return DEFAULTS["cpu"](t, d)
