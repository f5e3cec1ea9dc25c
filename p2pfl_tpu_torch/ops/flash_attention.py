"""Flash attention, forward and backward, as a ``torch.autograd.Function``.

Counterpart of ``p2pfl_tpu/ops/flash_attention.py`` (kernels 1-4 of the
Pallas set: ``_flash_kernel``, ``_dkvq_kernel``, ``_dq_kernel``,
``_dkv_kernel``). The public layout stays ``[B, T, H, D]`` (GQA heads
already repeated); inside, everything is ``[B, H, T, D]`` with the
log-sum-exp in the block-size-independent ``[B, H, T]`` fp32 row layout.
Residuals are ``(q, k, v, o, lse)``; Δ = rowsum(dO∘O) is an fp32 torch op
outside the kernels, as in JAX.

Dispatch is by the device of the tensors and nothing else:

- a CUDA tensor goes to the hand-written kernels of
  ``csrc/flash_attention.cu`` (:mod:`p2pfl_tpu_torch.ops._kernels`), or
  the wrapper raises;
- a CPU tensor goes to the plain PyTorch versions below, which follow the
  JAX kernels' blocked algorithm (same blocks, same causal split of the k
  stream, same online softmax, same NEG_INF sentinel, same rounding
  points) so that the CPU tests hold them against Pallas interpret mode.

``config=None`` resolves the ``cpu`` row of
:func:`p2pfl_tpu_torch.ops.autotune.default_flash_config`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from p2pfl_tpu_torch.ops.attention import NEG_INF, acc_dtype


@dataclasses.dataclass(frozen=True)
class FlashConfig:
    """Static schedule of the flash kernels.

    ``block_q`` x ``block_k`` tiles and ``q_span`` q blocks per program for
    the forward; ``block_q_bwd``/``block_k_bwd`` override the backward
    tiles (``None`` → :func:`_bwd_blocks`); ``bwd_mode`` picks the backward
    structure: ``"fused"`` (one sweep, dQ summed across k blocks),
    ``"split"`` (separate dQ and dK/dV passes) or ``"auto"`` (fused while
    the fp32 [T, D] dQ accumulator is at most 4 MiB). The CUDA kernels read
    only ``bwd_mode``; see :mod:`p2pfl_tpu_torch.ops.autotune`.
    """

    block_q: int = 128
    block_k: int = 128
    q_span: int = 1
    block_q_bwd: Optional[int] = None
    block_k_bwd: Optional[int] = None
    bwd_mode: str = "auto"  # auto | fused | split

    def __post_init__(self) -> None:
        if self.bwd_mode not in ("auto", "fused", "split"):
            raise ValueError(f"bwd_mode {self.bwd_mode!r} (auto|fused|split)")
        if self.block_q < 1 or self.block_k < 1 or self.q_span < 1:
            raise ValueError("block_q/block_k/q_span must be >= 1")


def _resolve(config: Optional[FlashConfig], t: int, d: int) -> FlashConfig:
    if config is not None:
        return config
    from p2pfl_tpu_torch.ops.autotune import default_flash_config

    return default_flash_config(t, d)


def _clamp_blocks(t: int, block_q: int, block_k: int) -> tuple[int, int]:
    block_q, block_k = min(block_q, t), min(block_k, t)
    if t % block_q or t % block_k:
        raise ValueError(f"T={t} must divide the block sizes ({block_q}, {block_k})")
    return block_q, block_k


def _fit_q_span(t: int, block_q: int, q_span: int) -> int:
    """Largest span <= q_span that divides the q-block count."""
    nq = t // block_q
    return next(s for s in range(min(q_span, nq), 0, -1) if nq % s == 0)


_FUSED_SCRATCH_LIMIT = 4 * 1024 * 1024  # bytes of fp32 [T, D] dQ accumulator


def _bwd_use_fused(t: int, d: int, mode: str) -> bool:
    if mode == "fused":
        return True
    if mode == "split":
        return False
    return t * d * 4 <= _FUSED_SCRATCH_LIMIT


def _bwd_blocks(t: int, d: int, cfg: FlashConfig) -> tuple[int, int]:
    """Backward block sizes: ``block_q_bwd``/``block_k_bwd`` override; fused
    keeps the forward's blocks; split at wide heads takes the largest
    multiple-of-8 divisor of T up to 1024."""
    if cfg.block_q_bwd is not None or cfg.block_k_bwd is not None:
        return _clamp_blocks(t, cfg.block_q_bwd or cfg.block_q, cfg.block_k_bwd or cfg.block_k)
    bq, bk = _clamp_blocks(t, cfg.block_q, cfg.block_k)
    if _bwd_use_fused(t, d, cfg.bwd_mode):
        return bq, bk
    if d >= 128:
        big = next(
            (b for b in range(min(1024, t), bq, -1) if t % b == 0 and b % 8 == 0), None
        )
        if big:
            return big, big
    return bq, bk


# ---- plain PyTorch versions of the four kernels ([B, H, T, D] layout) ----


def _causal_mask(s, row0: int, col0: int):
    bq, bk = s.shape[-2:]
    rows = row0 + torch.arange(bq, device=s.device)[:, None]
    cols = col0 + torch.arange(bk, device=s.device)[None, :]
    return torch.where(rows >= cols, s, torch.full_like(s, NEG_INF))


def flash_fwd_plain(q, k, v, causal: bool, block_q: int, block_k: int):
    """Plain version of ``_flash_kernel``: → (O [B,H,T,D], lse [B,H,T] fp32).

    Every q block streams its visible k blocks with an online softmax;
    under ``causal`` the blocks fully below the diagonal take no mask and
    only the frontier blocks do (``_fwd_tile``'s split)."""
    b, h, t, d = q.shape
    scale = d ** -0.5
    dt, acc_t = q.dtype, acc_dtype(q.dtype)
    qf, kf, vf = q.to(acc_t), k.to(acc_t), v.to(acc_t)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, t), dtype=acc_t, device=q.device)
    for qi in range(t // block_q):
        rows = slice(qi * block_q, (qi + 1) * block_q)
        qb = qf[:, :, rows]
        acc = torch.zeros((b, h, block_q, d), dtype=acc_t, device=q.device)
        m = torch.full((b, h, block_q, 1), NEG_INF, dtype=acc_t, device=q.device)
        l = torch.zeros((b, h, block_q, 1), dtype=acc_t, device=q.device)
        if causal:
            n_full = qi * block_q // block_k
            n_all = ((qi + 1) * block_q + block_k - 1) // block_k
        else:
            n_full = n_all = t // block_k
        for j in range(n_all):
            masked = j >= n_full
            cols = slice(j * block_k, (j + 1) * block_k)
            s = (qb @ kf[:, :, cols].transpose(-1, -2)) * scale
            if masked:
                s = _causal_mask(s, qi * block_q, j * block_k)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp(s - m_new)
            if masked:
                p = torch.where(m_new <= NEG_INF / 2, torch.zeros_like(p), p)
                alpha = torch.where(m <= NEG_INF / 2, torch.zeros_like(m), torch.exp(m - m_new))
            else:
                alpha = torch.exp(m - m_new)
            acc = acc * alpha + p.to(dt).to(acc_t) @ vf[:, :, cols]
            l = l * alpha + p.sum(-1, keepdim=True)
            m = m_new
        out[:, :, rows] = (acc / l.clamp_min(1e-30)).to(dt)
        blk = torch.where(m <= NEG_INF / 2, torch.full_like(m, NEG_INF), m + torch.log(l.clamp_min(1e-30)))
        lse[:, :, rows] = blk[..., 0]
    return out, lse


def _p_ds(qb, kb, vb, dob, lse_b, delta_b, scale, dt, masked, row0, col0):
    """One (q block, k block) pair of the backward: P and dS (fp32; dS
    before its cast), recomputing S from the saved lse."""
    s = scale * (qb @ kb.transpose(-1, -2))
    if masked:
        s = _causal_mask(s, row0, col0)
    p = torch.exp(s - lse_b[..., None])  # masked entries underflow to 0
    dp = dob @ vb.transpose(-1, -2)
    return p, p * (dp - delta_b[..., None])


def flash_bwd_dq_plain(q, k, v, do, lse, delta, causal: bool, block_q: int, block_k: int):
    """Plain version of ``_dq_kernel``: dQ per q block."""
    b, h, t, d = q.shape
    scale = d ** -0.5
    dt, acc_t = q.dtype, acc_dtype(q.dtype)
    qf, kf, vf, dof = (x.to(acc_t) for x in (q, k, v, do))
    dq = torch.empty_like(q)
    for qi in range(t // block_q):
        rows = slice(qi * block_q, (qi + 1) * block_q)
        acc = torch.zeros((b, h, block_q, d), dtype=acc_t, device=q.device)
        if causal:
            n_full = qi * block_q // block_k
            n_all = ((qi + 1) * block_q + block_k - 1) // block_k
        else:
            n_full = n_all = t // block_k
        for j in range(n_all):
            cols = slice(j * block_k, (j + 1) * block_k)
            _, ds = _p_ds(
                qf[:, :, rows], kf[:, :, cols], vf[:, :, cols], dof[:, :, rows],
                lse[:, :, rows], delta[:, :, rows], scale, dt, j >= n_full,
                qi * block_q, j * block_k,
            )
            acc = acc + scale * (ds.to(dt).to(acc_t) @ kf[:, :, cols])
        dq[:, :, rows] = acc.to(dt)
    return dq


def _dkv_sweep(q, k, v, do, lse, delta, causal, block_q, block_k, with_dq):
    """Plain version of ``_dkv_kernel`` (``with_dq=False``) and of the fused
    ``_dkvq_kernel`` (``with_dq=True``): per k block, stream the q blocks
    from the causal frontier on; the diagonal band takes the mask."""
    b, h, t, d = q.shape
    scale = d ** -0.5
    dt, acc_t = q.dtype, acc_dtype(q.dtype)
    qf, kf, vf, dof = (x.to(acc_t) for x in (q, k, v, do))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    dq_acc = torch.zeros(q.shape, dtype=acc_t, device=q.device) if with_dq else None
    nq = t // block_q
    for kj in range(t // block_k):
        cols = slice(kj * block_k, (kj + 1) * block_k)
        kb, vb = kf[:, :, cols], vf[:, :, cols]
        dk_acc = torch.zeros((b, h, block_k, d), dtype=acc_t, device=q.device)
        dv_acc = torch.zeros_like(dk_acc)
        if causal:
            start = kj * block_k // block_q
            full = ((kj + 1) * block_k + block_q - 1) // block_q
        else:
            start = full = 0
        for i in range(start, nq):
            rows = slice(i * block_q, (i + 1) * block_q)
            qb, dob = qf[:, :, rows], dof[:, :, rows]
            p, ds = _p_ds(
                qb, kb, vb, dob, lse[:, :, rows], delta[:, :, rows], scale, dt,
                i < full, i * block_q, kj * block_k,
            )
            ds = ds.to(dt).to(acc_t)
            dv_acc = dv_acc + p.to(dt).to(acc_t).transpose(-1, -2) @ dob
            dk_acc = dk_acc + scale * (ds.transpose(-1, -2) @ qb)
            if with_dq:
                dq_acc[:, :, rows] += scale * (ds @ kb)
        dk[:, :, cols] = dk_acc.to(dt)
        dv[:, :, cols] = dv_acc.to(dt)
    return dq_acc, dk, dv


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal: bool, block_q: int, block_k: int):
    """Plain version of ``_dkv_kernel``: (dK, dV)."""
    _, dk, dv = _dkv_sweep(q, k, v, do, lse, delta, causal, block_q, block_k, False)
    return dk, dv


def flash_bwd_fused_plain(q, k, v, do, lse, delta, causal: bool, block_q: int, block_k: int):
    """Plain version of ``_dkvq_kernel``: (dQ, dK, dV) in one sweep."""
    dq_acc, dk, dv = _dkv_sweep(q, k, v, do, lse, delta, causal, block_q, block_k, True)
    return dq_acc.to(q.dtype), dk, dv


# ---- dispatch: CUDA kernels or plain versions, by device ----


def _device_kind(x: torch.Tensor) -> str:
    if x.device.type in ("cuda", "cpu"):
        return x.device.type
    raise ValueError(f"flash attention runs on cuda or cpu tensors, not {x.device}")


def flash_fwd_bhtd(q, k, v, causal: bool, cfg: FlashConfig):
    """[B, H, T, D] → (O, lse [B, H, T] fp32)."""
    if _device_kind(q) == "cuda":
        from p2pfl_tpu_torch.ops import _kernels

        return _kernels.flash_fwd(q, k, v, causal)
    # q_span only regroups q blocks per program and each sub-tile keeps its
    # own frontier, so the plain version's per-block loop is the same math
    bq, bk = _clamp_blocks(q.shape[2], cfg.block_q, cfg.block_k)
    return flash_fwd_plain(q, k, v, causal, bq, bk)


def flash_bwd_bhtd(q, k, v, o, lse, do, causal: bool, cfg: FlashConfig):
    """→ (dQ, dK, dV), all [B, H, T, D]."""
    t, d = q.shape[2], q.shape[3]
    # Δ_i = Σ_d dO_id · O_id in fp32, the lse row layout
    delta = (do.to(acc_dtype(q.dtype)) * o.to(acc_dtype(q.dtype))).sum(-1)
    fused = _bwd_use_fused(t, d, cfg.bwd_mode)
    if _device_kind(q) == "cuda":
        from p2pfl_tpu_torch.ops import _kernels

        run = _kernels.flash_bwd_fused if fused else _kernels.flash_bwd_split
        return run(q, k, v, do, lse, delta, causal)
    bq, bk = _bwd_blocks(t, d, cfg)
    if fused:
        return flash_bwd_fused_plain(q, k, v, do, lse, delta, causal, bq, bk)
    dq = flash_bwd_dq_plain(q, k, v, do, lse, delta, causal, bq, bk)
    dk, dv = flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal, bq, bk)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """The ``custom_vjp`` of the JAX package: forward saves (q, k, v, o,
    lse); backward recomputes P from lse. Inputs [B, T, H, D]."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, config: FlashConfig):
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        o, lse = flash_fwd_bhtd(qt, kt, vt, causal, config)
        ctx.save_for_backward(qt, kt, vt, o, lse)
        ctx.causal, ctx.config = causal, config
        return o.transpose(1, 2)

    @staticmethod
    def backward(ctx, g):
        qt, kt, vt, o, lse = ctx.saved_tensors
        do = g.transpose(1, 2).contiguous()
        dq, dk, dv = flash_bwd_bhtd(qt, kt, vt, o, lse, do, ctx.causal, ctx.config)
        return dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2), None, None


def flash_attention(q, k, v, causal: bool = True, config: Optional[FlashConfig] = None):
    """Flash attention. q, k, v: [B, T, H, D] (GQA heads pre-repeated)."""
    cfg = _resolve(config, q.shape[1], q.shape[-1])
    return FlashAttention.apply(q, k, v, causal, cfg)
