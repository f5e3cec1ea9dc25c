"""Flash attention, forward and backward, as ``torch.autograd.Function``s.

Counterpart of ``p2pfl_tpu/ops/flash_attention.py``: kernels 1-4 of the
Pallas set (``_flash_kernel``, ``_dkvq_kernel``, ``_dq_kernel``,
``_dkv_kernel``) behind :func:`flash_attention`, and their offset-aware
siblings 5-8 (``_flash_kernel_offs``, ``_dkvq_kernel_offs``,
``_dq_kernel_offs``, ``_dkv_kernel_offs``) behind
:func:`flash_attention_block`, the per-hop call of ring attention. The
public layout stays ``[B, T, H, D]`` (GQA heads already repeated); inside,
everything is ``[B, H, T, D]`` with the log-sum-exp in the
block-size-independent ``[B, H, T]`` fp32 row layout
(:func:`flash_attention_block` returns it as JAX's ``[B, H, 1, T]``).
Residuals are ``(q, k, v, o, lse)``; Δ = rowsum(dO∘O) is an fp32 torch op
outside the kernels, as in JAX.

Dispatch is by the device of the tensors and nothing else:

- a CUDA tensor goes to the hand-written kernels of ``csrc/``
  (:mod:`p2pfl_tpu_torch.ops._kernels`), or the wrapper raises;
- a CPU tensor goes to the plain PyTorch versions below, which follow the
  JAX kernels' blocked algorithm (same blocks, same causal split of the k
  stream, same online softmax, same NEG_INF sentinel, same rounding
  points) so that the CPU tests hold them against Pallas interpret mode.

``config=None`` resolves the ``cpu`` row of
:func:`p2pfl_tpu_torch.ops.autotune.default_flash_config`.

Loop bounds of the offset variants divide with :func:`_tdiv`, which
truncates toward zero like JAX's ``lax.div`` and CUDA's ``/`` (Python's
``//`` floors). Where the numerator is negative that can keep one fully
masked k block in a q block's stream; it adds nothing to the output, and
all three versions keep it, so they walk the same blocks.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, Optional

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


# ---- loop bounds: (first, split, end) block indices of one sweep ----


def _tdiv(a: int, b: int) -> int:
    """a / b truncated toward zero (``lax.div``, CUDA ``/``), for b > 0."""
    q = abs(a) // b
    return q if a >= 0 else -q


def _clip(x: int, lo: int, hi: int) -> int:
    return min(max(x, lo), hi)


def _causal_q_bounds(qi, block_q, block_k, nk, causal):
    """k blocks of q block ``qi``: ``[0, n_full)`` unmasked, then
    ``[n_full, n_all)`` masked (``_fwd_tile``'s split)."""
    if not causal:
        return nk, nk
    return qi * block_q // block_k, ((qi + 1) * block_q + block_k - 1) // block_k


def _offs_q_bounds(qi, q_off, k_off, block_q, block_k, nk):
    """The same in global coordinates (``_fwd_tile_offs``, ``_dq_kernel_offs``):
    stream the k blocks whose first column is <= the q block's last row;
    those whose last column is <= its first row need no mask."""
    last_row = q_off + (qi + 1) * block_q - 1
    n_blocks = _clip(_tdiv(last_row - k_off, block_k) + 1, 0, nk)
    n_full = _clip(_tdiv(q_off + qi * block_q - k_off + 1, block_k), 0, n_blocks)
    return n_full, n_blocks


def _causal_kv_bounds(kj, block_q, block_k, nq, causal):
    """q blocks of k block ``kj``: from ``start`` on; ``[start, full)``
    masked (``_dkv_kernel``)."""
    if not causal:
        return 0, 0
    return kj * block_k // block_q, ((kj + 1) * block_k + block_q - 1) // block_q


def _offs_kv_bounds(kj, q_off, k_off, block_q, block_k, nq):
    """``_offs_kv_bounds`` of JAX: (start, full) in global coordinates."""
    first_col = k_off + kj * block_k
    start = _clip(_tdiv(first_col - q_off, block_q), 0, nq)
    full = _clip(_tdiv(k_off + (kj + 1) * block_k - 1 - q_off + block_q - 1, block_q), start, nq)
    return start, full


# ---- plain PyTorch versions of the kernels ([B, H, T, D] layout) ----
#
# One sweep per kernel structure, parametrised by its loop bounds and the
# global offsets of row 0 and column 0; kernels 1-4 pass offsets 0 and no
# lse cotangent, kernels 5-8 their ring hop's offsets and ``glse``.


def _causal_mask(s, row0: int, col0: int):
    bq, bk = s.shape[-2:]
    rows = row0 + torch.arange(bq, device=s.device)[:, None]
    cols = col0 + torch.arange(bk, device=s.device)[None, :]
    return torch.where(rows >= cols, s, torch.full_like(s, NEG_INF))


def _fwd_sweep(q, k, v, block_q: int, block_k: int, bounds: Callable, q_off=0, k_off=0,
               magnitude: bool = False):
    """Every q block streams its k blocks ``bounds(qi) = (n_full, n_all)``
    with an online softmax; only the blocks from ``n_full`` on take the
    mask. → (O [B,H,T,D], lse [B,H,T] fp32). A row that sees nothing keeps
    O = 0 and lse = NEG_INF. With ``magnitude`` O is Σ_k |P||V| / l
    instead, in the accumulation dtype: the sum of the magnitudes of the
    terms that form each element."""
    b, h, t, d = q.shape
    scale = d ** -0.5
    dt, acc_t = q.dtype, acc_dtype(q.dtype)
    qf, kf, vf = q.to(acc_t), k.to(acc_t), v.to(acc_t)
    if magnitude:
        vf = vf.abs()
    out = torch.empty(q.shape, dtype=acc_t if magnitude else dt, device=q.device)
    lse = torch.empty((b, h, t), dtype=acc_t, device=q.device)
    for qi in range(t // block_q):
        rows = slice(qi * block_q, (qi + 1) * block_q)
        qb = qf[:, :, rows]
        acc = torch.zeros((b, h, block_q, d), dtype=acc_t, device=q.device)
        m = torch.full((b, h, block_q, 1), NEG_INF, dtype=acc_t, device=q.device)
        l = torch.zeros((b, h, block_q, 1), dtype=acc_t, device=q.device)
        n_full, n_all = bounds(qi)
        for j in range(n_all):
            masked = j >= n_full
            cols = slice(j * block_k, (j + 1) * block_k)
            s = (qb @ kf[:, :, cols].transpose(-1, -2)) * scale
            if masked:
                s = _causal_mask(s, q_off + qi * block_q, k_off + j * block_k)
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
        out[:, :, rows] = (acc / l.clamp_min(1e-30)).to(out.dtype)
        blk = torch.where(m <= NEG_INF / 2, torch.full_like(m, NEG_INF), m + torch.log(l.clamp_min(1e-30)))
        lse[:, :, rows] = blk[..., 0]
    return out, lse


def flash_fwd_plain(q, k, v, causal: bool, block_q: int, block_k: int):
    """Plain version of ``_flash_kernel``: → (O [B,H,T,D], lse [B,H,T] fp32)."""
    nk = q.shape[2] // block_k
    return _fwd_sweep(q, k, v, block_q, block_k,
                      partial(_causal_q_bounds, block_q=block_q, block_k=block_k, nk=nk, causal=causal))


def flash_fwd_offs_plain(q, k, v, q_off: int, k_off: int, block_q: int, block_k: int):
    """Plain version of ``_flash_kernel_offs``: q row i attends k row j
    where ``q_off + i >= k_off + j``."""
    nk = q.shape[2] // block_k
    bounds = partial(_offs_q_bounds, q_off=q_off, k_off=k_off, block_q=block_q, block_k=block_k, nk=nk)
    return _fwd_sweep(q, k, v, block_q, block_k, bounds, q_off, k_off)


def _p_ds(qb, kb, vb, dob, lse_b, delta_b, scale, masked, row0, col0, glse_b=None):
    """One (q block, k block) pair of the backward: P and dS (fp32; dS
    before its cast), recomputing S from the saved lse. ``glse_b`` is the
    lse cotangent of the offset variants: dS = P·(dP − Δ + g_lse)."""
    s = scale * (qb @ kb.transpose(-1, -2))
    if masked:
        s = _causal_mask(s, row0, col0)
    lse_c = lse_b[..., None]
    # a row that sees nothing in this call keeps lse at the sentinel, and
    # its masked scores are the sentinel too: exp(s - lse) would be 1 there,
    # so P is forced to 0 (JAX: _dq_kernel_offs, _dkv_step_offs). Rows of
    # kernels 1-4 always see their diagonal, so this changes nothing there.
    p = torch.where(lse_c <= NEG_INF / 2, torch.zeros_like(s), torch.exp(s - lse_c))
    dp = dob @ vb.transpose(-1, -2) - delta_b[..., None]
    if glse_b is not None:
        dp = dp + glse_b[..., None]
    return p, p * dp


def _dq_sweep(q, k, v, do, lse, delta, glse, block_q, block_k, bounds, q_off=0, k_off=0):
    """dQ per q block over its k blocks ``bounds(qi) = (n_full, n_all)``."""
    b, h, t, d = q.shape
    scale = d ** -0.5
    dt, acc_t = q.dtype, acc_dtype(q.dtype)
    qf, kf, vf, dof = (x.to(acc_t) for x in (q, k, v, do))
    dq = torch.empty_like(q)
    for qi in range(t // block_q):
        rows = slice(qi * block_q, (qi + 1) * block_q)
        acc = torch.zeros((b, h, block_q, d), dtype=acc_t, device=q.device)
        n_full, n_all = bounds(qi)
        for j in range(n_all):
            cols = slice(j * block_k, (j + 1) * block_k)
            _, ds = _p_ds(
                qf[:, :, rows], kf[:, :, cols], vf[:, :, cols], dof[:, :, rows],
                lse[:, :, rows], delta[:, :, rows], scale, j >= n_full,
                q_off + qi * block_q, k_off + j * block_k,
                None if glse is None else glse[:, :, rows],
            )
            acc = acc + scale * (ds.to(dt).to(acc_t) @ kf[:, :, cols])
        dq[:, :, rows] = acc.to(dt)
    return dq


def _dkv_sweep(q, k, v, do, lse, delta, glse, block_q, block_k, bounds, with_dq, q_off=0, k_off=0,
               magnitude: bool = False):
    """Plain version of the dK/dV kernels (``with_dq=False``) and of the
    fused ones (``with_dq=True``): per k block, stream the q blocks from
    ``start`` on, where ``bounds(kj) = (start, full)``; ``[start, full)``
    takes the mask. q rows no k block reaches keep a zero dQ. With
    ``magnitude`` every product takes the magnitudes of its factors (dQ =
    scale·Σ_k |dS||K|, dK = scale·Σ_q |dS||Q|, dV = Σ_q |P||dO|) and dK, dV
    stay in the accumulation dtype: the sum of the magnitudes of the terms
    that form each element."""
    b, h, t, d = q.shape
    scale = d ** -0.5
    dt, acc_t = q.dtype, acc_dtype(q.dtype)
    qf, kf, vf, dof = (x.to(acc_t) for x in (q, k, v, do))
    mag = torch.abs if magnitude else (lambda x: x)
    out_t = acc_t if magnitude else dt
    dk = torch.empty(k.shape, dtype=out_t, device=k.device)
    dv = torch.empty(v.shape, dtype=out_t, device=v.device)
    dq_acc = torch.zeros(q.shape, dtype=acc_t, device=q.device) if with_dq else None
    nq = t // block_q
    for kj in range(t // block_k):
        cols = slice(kj * block_k, (kj + 1) * block_k)
        kb, vb = kf[:, :, cols], vf[:, :, cols]
        dk_acc = torch.zeros((b, h, block_k, d), dtype=acc_t, device=q.device)
        dv_acc = torch.zeros_like(dk_acc)
        start, full = bounds(kj)
        for i in range(start, nq):
            rows = slice(i * block_q, (i + 1) * block_q)
            qb, dob = qf[:, :, rows], dof[:, :, rows]
            p, ds = _p_ds(
                qb, kb, vb, dob, lse[:, :, rows], delta[:, :, rows], scale,
                i < full, q_off + i * block_q, k_off + kj * block_k,
                None if glse is None else glse[:, :, rows],
            )
            ds = mag(ds.to(dt).to(acc_t))
            dv_acc = dv_acc + p.to(dt).to(acc_t).transpose(-1, -2) @ mag(dob)
            dk_acc = dk_acc + scale * (ds.transpose(-1, -2) @ mag(qb))
            if with_dq:
                dq_acc[:, :, rows] += scale * (ds @ mag(kb))
        dk[:, :, cols] = dk_acc.to(out_t)
        dv[:, :, cols] = dv_acc.to(out_t)
    return dq_acc, dk, dv


def _causal_bounds(q, causal, block_q, block_k):
    t = q.shape[2]
    return (
        partial(_causal_q_bounds, block_q=block_q, block_k=block_k, nk=t // block_k, causal=causal),
        partial(_causal_kv_bounds, block_q=block_q, block_k=block_k, nq=t // block_q, causal=causal),
    )


def _offs_bounds(q, q_off, k_off, block_q, block_k):
    t = q.shape[2]
    kw = dict(q_off=q_off, k_off=k_off, block_q=block_q, block_k=block_k)
    return partial(_offs_q_bounds, nk=t // block_k, **kw), partial(_offs_kv_bounds, nq=t // block_q, **kw)


def flash_bwd_dq_plain(q, k, v, do, lse, delta, causal: bool, block_q: int, block_k: int):
    """Plain version of ``_dq_kernel``: dQ per q block."""
    qb, _ = _causal_bounds(q, causal, block_q, block_k)
    return _dq_sweep(q, k, v, do, lse, delta, None, block_q, block_k, qb)


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal: bool, block_q: int, block_k: int):
    """Plain version of ``_dkv_kernel``: (dK, dV)."""
    _, kvb = _causal_bounds(q, causal, block_q, block_k)
    _, dk, dv = _dkv_sweep(q, k, v, do, lse, delta, None, block_q, block_k, kvb, False)
    return dk, dv


def flash_bwd_fused_plain(q, k, v, do, lse, delta, causal: bool, block_q: int, block_k: int):
    """Plain version of ``_dkvq_kernel``: (dQ, dK, dV) in one sweep."""
    _, kvb = _causal_bounds(q, causal, block_q, block_k)
    dq_acc, dk, dv = _dkv_sweep(q, k, v, do, lse, delta, None, block_q, block_k, kvb, True)
    return dq_acc.to(q.dtype), dk, dv


def flash_bwd_dq_offs_plain(q, k, v, do, lse, delta, glse, q_off: int, k_off: int, block_q: int, block_k: int):
    """Plain version of ``_dq_kernel_offs``."""
    qb, _ = _offs_bounds(q, q_off, k_off, block_q, block_k)
    return _dq_sweep(q, k, v, do, lse, delta, glse, block_q, block_k, qb, q_off, k_off)


def flash_bwd_dkv_offs_plain(q, k, v, do, lse, delta, glse, q_off: int, k_off: int, block_q: int, block_k: int):
    """Plain version of ``_dkv_kernel_offs``: (dK, dV)."""
    _, kvb = _offs_bounds(q, q_off, k_off, block_q, block_k)
    _, dk, dv = _dkv_sweep(q, k, v, do, lse, delta, glse, block_q, block_k, kvb, False, q_off, k_off)
    return dk, dv


def flash_bwd_fused_offs_plain(q, k, v, do, lse, delta, glse, q_off: int, k_off: int, block_q: int, block_k: int):
    """Plain version of ``_dkvq_kernel_offs``: (dQ, dK, dV) in one sweep."""
    _, kvb = _offs_bounds(q, q_off, k_off, block_q, block_k)
    dq_acc, dk, dv = _dkv_sweep(q, k, v, do, lse, delta, glse, block_q, block_k, kvb, True, q_off, k_off)
    return dq_acc.to(q.dtype), dk, dv


# ---- magnitudes: for each output element, the sum of the magnitudes of
# the terms that form it. A check of a kernel against its plain version
# scales its limit by them: both round each term's P or dS to bf16, and
# where the two roundings differ the element moves by up to an ulp of that
# term, however much the terms cancel. ----


def flash_fwd_magnitude(q, k, v, causal: bool, block_q: int, block_k: int):
    """Σ_k |P||V| / l of each element of :func:`flash_fwd_plain`'s O (fp32)."""
    nk = q.shape[2] // block_k
    bounds = partial(_causal_q_bounds, block_q=block_q, block_k=block_k, nk=nk, causal=causal)
    return _fwd_sweep(q, k, v, block_q, block_k, bounds, magnitude=True)[0]


def flash_fwd_offs_magnitude(q, k, v, q_off: int, k_off: int, block_q: int, block_k: int):
    """The same for :func:`flash_fwd_offs_plain`."""
    nk = q.shape[2] // block_k
    bounds = partial(_offs_q_bounds, q_off=q_off, k_off=k_off, block_q=block_q, block_k=block_k, nk=nk)
    return _fwd_sweep(q, k, v, block_q, block_k, bounds, q_off, k_off, magnitude=True)[0]


def flash_bwd_magnitude(q, k, v, do, lse, delta, causal: bool, block_q: int, block_k: int):
    """(scale·Σ_k |dS||K|, scale·Σ_q |dS||Q|, Σ_q |P||dO|) of each element
    of dQ, dK and dV (fp32): the terms of kernels 2, 3 and 4."""
    _, kvb = _causal_bounds(q, causal, block_q, block_k)
    return _dkv_sweep(q, k, v, do, lse, delta, None, block_q, block_k, kvb, True, magnitude=True)


def flash_bwd_offs_magnitude(q, k, v, do, lse, delta, glse, q_off: int, k_off: int, block_q: int, block_k: int):
    """The same with the offsets and the lse cotangent: kernels 6, 7 and 8."""
    _, kvb = _offs_bounds(q, q_off, k_off, block_q, block_k)
    return _dkv_sweep(q, k, v, do, lse, delta, glse, block_q, block_k, kvb, True, q_off, k_off, magnitude=True)


# ---- dispatch: CUDA kernels or plain versions, by device ----


def _device_kind(x: torch.Tensor) -> str:
    if x.device.type in ("cuda", "cpu"):
        return x.device.type
    raise ValueError(f"flash attention runs on cuda or cpu tensors, not {x.device}")


def _delta(do, o):
    """Δ_i = Σ_d dO_id · O_id in fp32, the lse row layout."""
    acc = acc_dtype(do.dtype)
    return (do.to(acc) * o.to(acc)).sum(-1)


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
    delta = _delta(do, o)
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


def flash_fwd_offs_bhtd(q, k, v, q_off: int, k_off: int, cfg: FlashConfig):
    """Offset-aware forward, [B, H, T, D] → (O, lse [B, H, T] fp32)."""
    if _device_kind(q) == "cuda":
        from p2pfl_tpu_torch.ops import _kernels

        return _kernels.flash_fwd_offs(q, k, v, q_off, k_off)
    bq, bk = _clamp_blocks(q.shape[2], cfg.block_q, cfg.block_k)
    return flash_fwd_offs_plain(q, k, v, q_off, k_off, bq, bk)


def flash_bwd_offs_bhtd(q, k, v, o, lse, do, glse, q_off: int, k_off: int, cfg: FlashConfig):
    """Offset-aware backward with the lse cotangent ``glse`` [B, H, T]
    (``_fab_bwd``) → (dQ, dK, dV)."""
    t, d = q.shape[2], q.shape[3]
    delta = _delta(do, o)
    # rows invisible in this call (lse at the -1e30 sentinel) carry no lse
    # gradient; NEG_INF is finite, so compare, never isfinite
    glse = torch.where(lse <= NEG_INF / 2, torch.zeros_like(lse), glse.to(lse.dtype))
    fused = _bwd_use_fused(t, d, cfg.bwd_mode)
    if _device_kind(q) == "cuda":
        from p2pfl_tpu_torch.ops import _kernels

        run = _kernels.flash_bwd_fused_offs if fused else _kernels.flash_bwd_split_offs
        return run(q, k, v, do, lse, delta, glse, q_off, k_off)
    bq, bk = _bwd_blocks(t, d, cfg)
    if fused:
        return flash_bwd_fused_offs_plain(q, k, v, do, lse, delta, glse, q_off, k_off, bq, bk)
    dq = flash_bwd_dq_offs_plain(q, k, v, do, lse, delta, glse, q_off, k_off, bq, bk)
    dk, dv = flash_bwd_dkv_offs_plain(q, k, v, do, lse, delta, glse, q_off, k_off, bq, bk)
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


class FlashAttentionBlock(torch.autograd.Function):
    """The ``custom_vjp`` of JAX's ``flash_attention_block`` in the kernels'
    layout: q, k, v, O ``[B, H, T, D]`` contiguous, lse ``[B, H, T]`` fp32.
    Two outputs and a backward that takes both cotangents; the ring merge
    differentiates through lse. Δ comes from this call's own output. The
    inputs are saved as given, so a ring that hands every hop the same
    shard tensors keeps one copy of each."""

    @staticmethod
    def forward(ctx, q, k, v, q_off: int, k_off: int, config: FlashConfig):
        o, lse = flash_fwd_offs_bhtd(q, k, v, q_off, k_off, config)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.offs, ctx.config = (q_off, k_off), config
        return o, lse

    @staticmethod
    def backward(ctx, g, g_lse):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd_offs_bhtd(q, k, v, o, lse, g.contiguous(), g_lse.contiguous(),
                                         *ctx.offs, ctx.config)
        return dq, dk, dv, None, None, None


def flash_attention_block(q, k, v, q_off: int, k_off: int, config: Optional[FlashConfig] = None):
    """One causal-by-global-offset attention block: q row i attends k row j
    where ``q_off + i >= k_off + j``. q, k, v: [B, T, H, D] (T = the local
    shard); the offsets are Python ints. Returns ``(out, lse)`` with lse
    ``[B, H, 1, T]`` fp32, which makes results mergeable across ring hops;
    a row that sees nothing gets out 0 and lse NEG_INF. The ring calls
    :class:`FlashAttentionBlock` directly on shards it transposed once."""
    cfg = _resolve(config, q.shape[1], q.shape[-1])
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    o, lse = FlashAttentionBlock.apply(qt, kt, vt, int(q_off), int(k_off), cfg)
    return o.transpose(1, 2), lse.unsqueeze(2)
