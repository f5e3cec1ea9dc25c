"""Decoder-only transformer (TinyLlama-style) with LoRA adapters.

Counterpart of ``p2pfl_tpu/models/transformer.py``: RMSNorm → GQA
attention with RoPE → SwiGLU, bf16 matmuls, norms and softmax statistics
in fp32, tied embeddings. The modules hold structure only; ``forward``
takes the parameter subtree (flax names, ``[in, out]`` kernels), so
:mod:`p2pfl_tpu_torch.convert` maps trees 1:1.

Rounding points follow the JAX model: RMSNorm in fp32 (eps 1e-6 inside
the rsqrt, times the fp32 scale, then cast); rope in fp32 on the two
halves; ``LoRADense`` as ``x@W`` in bf16 plus ``((x@A)@B)·(α/r)`` in bf16;
logits as a bf16 product cast to fp32.

Every module takes any number of leading dimensions. A LoRA adapter leaf
with one more leading axis than usual (``lora_a`` of ``[N, in, r]``) is a
node-stacked adapter and pairs with an input whose first axis is N: the
federation runs all nodes in one call this way instead of vmapping.

Attention backends: ``"dense"`` (``ops/attention.py``) and ``"flash"``
(``ops/flash_attention.py``: CUDA kernels on the GPU, their plain
versions on the CPU). The layers always loop in Python; ``scan_layers``
only says which JAX layout :mod:`p2pfl_tpu_torch.convert` reads and
writes.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial
from typing import Any, Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from p2pfl_tpu_torch import resolve_device
from p2pfl_tpu_torch.models.base import TorchModel
from p2pfl_tpu_torch.ops.attention import causal_attention
from p2pfl_tpu_torch.ops.flash_attention import FlashConfig


@dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 2048
    dim: int = 256
    n_layers: int = 4
    n_heads: int = 8
    n_kv_heads: int = 4
    ffn_hidden: int = 688
    rope_theta: float = 10000.0
    lora_rank: int = 8
    lora_alpha: float = 16.0
    lora_mlp: bool = False
    dtype: Any = torch.bfloat16
    # not ported yet: CausalLM raises on these (ROADMAP Queue A)
    n_experts: int = 0
    remat: bool = False
    # the JAX parameter layout (scanned ``layers/block`` with a leading
    # [L] axis, or unrolled ``layer_{i}``); the port always loops
    scan_layers: bool = False
    # flash schedule: set → Attention runs flash attention under it
    flash_config: Optional[FlashConfig] = None

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads


def _node_axis(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Broadcast a node-stacked ``[N, a, b]`` adapter against ``x`` of
    ``[N, ..., T, a]``: the matmul batch dims of x are ``[N, ...]``."""
    if w.dim() == 2:
        return w
    return w.reshape(w.shape[0], *([1] * (x.dim() - 3)), *w.shape[1:])


class RMSNorm(nn.Module):
    def __init__(self, dtype=torch.bfloat16) -> None:
        super().__init__()
        self.dtype = dtype

    def forward(self, p: dict, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        norm = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + 1e-6)
        return (norm * p["scale"]).to(self.dtype)


class LoRADense(nn.Module):
    """Dense with optional low-rank adapter: ``y = xW + (alpha/r)·xAB``."""

    def __init__(self, features: int, rank: int = 0, alpha: float = 16.0, dtype=torch.bfloat16):
        super().__init__()
        self.features, self.rank, self.alpha, self.dtype = features, rank, alpha, dtype

    def forward(self, p: dict, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        xd = x.to(dt)
        y = xd @ p["kernel"].to(dt)
        if self.rank > 0:
            a = _node_axis(p["lora_a"].to(dt), xd)
            b = _node_axis(p["lora_b"].to(dt), xd)
            y = y + ((xd @ a) @ b) * (self.alpha / self.rank)
        return y


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary position embedding over [..., T, H, D] (D even)."""
    t, d = x.shape[-3], x.shape[-1]
    half = d // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half))
    ang = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] * freqs[None, :]
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]  # [T, 1, half]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(x.dtype)


class Attention(nn.Module):
    def __init__(self, cfg: TransformerConfig, attn_fn: Optional[Callable] = None) -> None:
        super().__init__()
        self.cfg = cfg
        dense = partial(LoRADense, rank=cfg.lora_rank, alpha=cfg.lora_alpha, dtype=cfg.dtype)
        hd = cfg.head_dim
        self.wq = dense(cfg.n_heads * hd)
        self.wk = dense(cfg.n_kv_heads * hd)
        self.wv = dense(cfg.n_kv_heads * hd)
        self.wo = dense(cfg.dim)
        if attn_fn is None and cfg.flash_config is not None:
            from p2pfl_tpu_torch.ops.flash_attention import flash_attention

            attn_fn = partial(flash_attention, causal=True, config=cfg.flash_config)
        self.attend = attn_fn or causal_attention

    def forward(self, p: dict, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        hd = cfg.head_dim
        lead, t = x.shape[:-2], x.shape[-2]
        q = rope(self.wq(p["wq"], x).reshape(*lead, t, cfg.n_heads, hd), cfg.rope_theta)
        k = rope(self.wk(p["wk"], x).reshape(*lead, t, cfg.n_kv_heads, hd), cfg.rope_theta)
        v = self.wv(p["wv"], x).reshape(*lead, t, cfg.n_kv_heads, hd)
        # GQA: repeat K/V heads to match Q heads (autograd sums them back)
        rep = cfg.n_heads // cfg.n_kv_heads
        k = k.repeat_interleave(rep, dim=-2)
        v = v.repeat_interleave(rep, dim=-2)
        flat = (-1, t, cfg.n_heads, hd)
        out = self.attend(q.reshape(flat), k.reshape(flat), v.reshape(flat))
        return self.wo(p["wo"], out.reshape(*lead, t, cfg.dim))


class MLP(nn.Module):
    def __init__(self, cfg: TransformerConfig) -> None:
        super().__init__()
        rank = cfg.lora_rank if cfg.lora_mlp else 0
        dense = partial(LoRADense, rank=rank, alpha=cfg.lora_alpha, dtype=cfg.dtype)
        self.w1, self.w3, self.w2 = dense(cfg.ffn_hidden), dense(cfg.ffn_hidden), dense(cfg.dim)

    def forward(self, p: dict, x: torch.Tensor) -> torch.Tensor:
        gate = self.w1(p["w1"], x)
        up = self.w3(p["w3"], x)
        return self.w2(p["w2"], F.silu(gate) * up)


class Block(nn.Module):
    def __init__(self, cfg: TransformerConfig, attn_fn: Optional[Callable] = None) -> None:
        super().__init__()
        self.attn_norm = RMSNorm(cfg.dtype)
        self.attn = Attention(cfg, attn_fn)
        self.mlp_norm = RMSNorm(cfg.dtype)
        self.mlp = MLP(cfg)

    def forward(self, p: dict, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(p["attn"], self.attn_norm(p["attn_norm"], x))
        return x + self.mlp(p["mlp"], self.mlp_norm(p["mlp_norm"], x))


class CausalLM(nn.Module):
    """tokens [..., T] int → logits [..., T, vocab] fp32."""

    def __init__(self, cfg: TransformerConfig, attn_fn: Optional[Callable] = None) -> None:
        super().__init__()
        if cfg.n_experts > 0:
            raise NotImplementedError(
                "MoE FFN is not ported yet (ROADMAP Queue A 7: transformer breadth)"
            )
        if cfg.remat:
            raise NotImplementedError(
                "remat is not ported yet (ROADMAP Queue A 7: torch.utils.checkpoint)"
            )
        self.cfg = cfg
        self.layers = nn.ModuleList(Block(cfg, attn_fn) for _ in range(cfg.n_layers))
        self.final_norm = RMSNorm(cfg.dtype)

    def forward(self, params: dict, tokens: torch.Tensor) -> torch.Tensor:
        dt = self.cfg.dtype
        emb = params["embed"]
        x = F.embedding(tokens.long(), emb).to(dt)
        for i, block in enumerate(self.layers):
            x = block(params[f"layer_{i}"], x)
        x = self.final_norm(params["final_norm"], x)
        return (x @ emb.to(dt).t()).float()  # tied embeddings


def resolve_attention(attn: str, config: Optional[FlashConfig] = None) -> Optional[Callable]:
    """Map a backend name to an ``(q, k, v) -> out`` callable (``None`` =
    dense, as in JAX)."""
    if attn == "dense":
        return None
    if attn == "flash":
        from p2pfl_tpu_torch.ops.flash_attention import flash_attention

        return partial(flash_attention, causal=True, config=config)
    if attn in ("ring", "ring_flash", "auto"):
        raise NotImplementedError(
            f"attn={attn!r} is not ported yet (ROADMAP Queue B4: ring flash over "
            "torch.distributed; 'auto' waits for a measured crossover)"
        )
    raise ValueError(f"unknown attention backend {attn!r} (dense|flash)")


# ---- initialisation (flax's initialisers, from a torch.Generator) ----


def _normal(shape, std, gen, device):
    return torch.randn(shape, generator=gen, device=device, dtype=torch.float32) * std


def _lecun_normal(shape, gen, device):
    """flax ``lecun_normal``: truncated normal in [-2, 2] std, variance 1/fan_in."""
    std = math.sqrt(1.0 / shape[0]) / 0.87962566103423978
    lo, hi = (1 + math.erf(-2 / math.sqrt(2))) / 2, (1 + math.erf(2 / math.sqrt(2))) / 2
    u = torch.rand(shape, generator=gen, device=device, dtype=torch.float32) * (hi - lo) + lo
    return torch.erfinv(2 * u - 1) * math.sqrt(2) * std


def init_params(cfg: TransformerConfig, seed: int = 0, device=None) -> dict:
    """Fresh parameters in the unrolled layout, drawn from one seeded
    ``torch.Generator`` on ``device``. Adapters start as identity
    (``lora_b`` zero)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    hd = cfg.head_dim

    def dense(fan_in, fan_out, rank):
        p = {"kernel": _lecun_normal((fan_in, fan_out), gen, dev)}
        if rank > 0:
            p["lora_a"] = _normal((fan_in, rank), 0.02, gen, dev)
            p["lora_b"] = torch.zeros((rank, fan_out), device=dev)
        return p

    def norm():
        return {"scale": torch.ones(cfg.dim, device=dev)}

    r, r_mlp = cfg.lora_rank, cfg.lora_rank if cfg.lora_mlp else 0
    params: dict = {"embed": _normal((cfg.vocab_size, cfg.dim), 0.02, gen, dev)}
    for i in range(cfg.n_layers):
        params[f"layer_{i}"] = {
            "attn_norm": norm(),
            "attn": {
                "wq": dense(cfg.dim, cfg.n_heads * hd, r),
                "wk": dense(cfg.dim, cfg.n_kv_heads * hd, r),
                "wv": dense(cfg.dim, cfg.n_kv_heads * hd, r),
                "wo": dense(cfg.n_heads * hd, cfg.dim, r),
            },
            "mlp_norm": norm(),
            "mlp": {
                "w1": dense(cfg.dim, cfg.ffn_hidden, r_mlp),
                "w3": dense(cfg.dim, cfg.ffn_hidden, r_mlp),
                "w2": dense(cfg.ffn_hidden, cfg.dim, r_mlp),
            },
        }
    params["final_norm"] = norm()
    return params


def tiny_transformer(
    seq_len: int = 128,
    seed: int = 0,
    cfg: Optional[TransformerConfig] = None,
    attn_fn: Optional[Callable] = None,
    attn: str = "dense",
    device=None,
) -> TorchModel:
    """A LoRA-ready causal LM bound to fresh parameters on ``device``.

    ``attn`` is ``"dense"`` or ``"flash"``; ``attn_fn`` overrides it. For
    flash, ``cfg.flash_config`` pins the schedule, else the defaults row
    of :mod:`p2pfl_tpu_torch.ops.autotune` is resolved here.
    """
    cfg = cfg or TransformerConfig()
    if attn_fn is None:
        if attn == "flash":
            from p2pfl_tpu_torch.ops.autotune import _fit, default_flash_config

            if _fit(seq_len, 512) > 512:
                raise ValueError(
                    f"attn='flash' needs a flash block <= 512 dividing the attended "
                    f"length: {seq_len} has no multiple-of-8 divisor"
                )
            flash_cfg = cfg.flash_config or default_flash_config(seq_len, cfg.head_dim)
            attn_fn = resolve_attention("flash", config=flash_cfg)
        else:
            attn_fn = resolve_attention(attn)
    module = CausalLM(cfg, attn_fn)
    params = init_params(cfg, seed, device)
    model = TorchModel(module, params, (seq_len,), cfg.vocab_size)
    model.extra["config"] = cfg
    return model
