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

The FFN is SwiGLU, or with ``n_experts > 0`` :class:`MoEMLP` (capacity
dispatch over stacked ``[E, ...]`` experts). Its router losses reach the
training loss through :meth:`CausalLM.forward_with_aux` and
:func:`p2pfl_tpu_torch.models.base.apply_with_aux` (flax sows them; the
port returns them beside the logits).

Attention backends: ``"dense"`` (``ops/attention.py``), ``"flash"``
(``ops/flash_attention.py``: CUDA kernels on the GPU, their plain
versions on the CPU), ``"auto"`` (:func:`pick_attention`: flash on a CUDA
device from ``Settings.FLASH_MIN_SEQ_LEN`` on, else dense), and the
sequence-sharded rings ``"ring"`` and
``"ring_flash"`` (``ops/attention.py::ring_attention``); the node-stacked
batch is flattened to ``[N·bs, T, H, D]`` before attention, so a ring
sees it as one batch. The layers always loop in Python; ``scan_layers``
only says which JAX layout :mod:`p2pfl_tpu_torch.convert` reads and
writes.

``remat`` recomputes activations in the backward
(``torch.utils.checkpoint``, non-reentrant), a block at a time, with
JAX's ``remat_policy`` names. JAX's policies name the tensors to keep
(``save_only_these_names``); PyTorch's selective-checkpoint policies
decide per ATen op and cannot see the flash kernels, which launch
through ``ctypes``. So each policy here is where the checkpointed
segments of a block start and end:

- ``None``: the whole block is one segment; its backward re-runs the
  whole block forward;
- ``"mlp"``: keeps the FFN's activations. One segment from the block
  input to the FFN's input (norm, q/k/v, attention, output projection,
  residual, norm); the FFN runs outside it, so its gate and up are kept.
  The backward re-runs the attention side;
- ``"mlp_qkv"``: also keeps the post-RoPE q, k and v (before the GQA
  repeat). The q/k/v projections run outside any segment; one segment
  from (block input, q, k, v) to the FFN's input holds the attention,
  the output projection, the residual and the norm. Its backward re-runs
  the flash forward (kernel 1, for the lse it saves), the output
  projection and elementwise glue, as JAX's backward under this policy
  does.

A segment's backward gives the gradients the unsegmented block gives, bit
for bit (``tests/test_torch_transformer.py``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial
from typing import Any, Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from p2pfl_tpu_torch import resolve_device
from p2pfl_tpu_torch.models.base import TorchModel
from p2pfl_tpu_torch.ops.attention import causal_attention
from p2pfl_tpu_torch.ops.flash_attention import FlashConfig


#: what each ``remat_policy`` keeps (JAX's ``checkpoint_name``s)
_REMAT_SAVE_NAMES = {
    "mlp": ("ffn_gate", "ffn_up"),
    "mlp_qkv": ("ffn_gate", "ffn_up", "attn_q", "attn_k", "attn_v"),
}


def _check_remat_policy(name: Optional[str]) -> None:
    if name is not None and name not in _REMAT_SAVE_NAMES:
        raise ValueError(f"unknown remat_policy {name!r} (None|{'|'.join(_REMAT_SAVE_NAMES)})")


def _segment(fn, *args):
    """``fn(*args)`` as a checkpointed segment: its activations are dropped
    after the forward and recomputed in the backward. No model op draws
    random numbers, so no rng state is saved (a CUDA graph capture
    refuses that query)."""
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)


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
    # mixture-of-experts FFN (n_experts=0: dense SwiGLU everywhere); the
    # capacity is C = ceil(k·S/E · moe_capacity) tokens an expert
    n_experts: int = 0
    moe_top_k: int = 2
    moe_capacity: float = 1.25
    moe_aux_coef: float = 1e-2  # Switch load-balance loss coefficient
    moe_zloss_coef: float = 1e-3  # router z-loss coefficient
    # per-block rematerialization and its policy (None | "mlp" |
    # "mlp_qkv", the module docstring); a policy needs remat=True
    remat: bool = False
    remat_policy: Optional[str] = None
    # the JAX parameter layout (scanned ``layers/block`` with a leading
    # [L] axis, or unrolled ``layer_{i}``); the port always loops
    scan_layers: bool = False
    # flash schedule: set → Attention runs flash attention under it
    flash_config: Optional[FlashConfig] = None

    def __post_init__(self) -> None:
        if self.remat_policy is not None:
            _check_remat_policy(self.remat_policy)
            if not self.remat:
                raise ValueError(
                    "remat_policy is only meaningful with remat=True — a "
                    "policy on a no-remat model would silently change the "
                    "memory/FLOPs profile the caller asked for"
                )

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
        return self.core(p, *self.qkv(p, x))

    def qkv(self, p: dict, x: torch.Tensor) -> tuple:
        """Post-RoPE q ``[..., T, H, D]`` and k, v ``[..., T, kv, D]``
        (before the GQA repeat): what ``mlp_qkv`` keeps."""
        cfg = self.cfg
        hd = cfg.head_dim
        lead, t = x.shape[:-2], x.shape[-2]
        q = rope(self.wq(p["wq"], x).reshape(*lead, t, cfg.n_heads, hd), cfg.rope_theta)
        k = rope(self.wk(p["wk"], x).reshape(*lead, t, cfg.n_kv_heads, hd), cfg.rope_theta)
        v = self.wv(p["wv"], x).reshape(*lead, t, cfg.n_kv_heads, hd)
        return q, k, v

    def core(self, p: dict, q, k, v) -> torch.Tensor:
        """Attention over q, k, v and the output projection."""
        cfg = self.cfg
        lead, t = q.shape[:-3], q.shape[-3]
        # GQA: repeat K/V heads to match Q heads (autograd sums them back)
        rep = cfg.n_heads // cfg.n_kv_heads
        k = k.repeat_interleave(rep, dim=-2)
        v = v.repeat_interleave(rep, dim=-2)
        flat = (-1, t, cfg.n_heads, cfg.head_dim)
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


def moe_route(probs: torch.Tensor, top_k: int, capacity: int) -> tuple[torch.Tensor, torch.Tensor]:
    """JAX's iterative top-k dispatch of ``MoEMLP``: router probabilities
    ``[..., S, E]`` fp32 → (combine ``[..., S, E, C]``, the top-1 one-hot
    ``[..., S, E]``). Each pass takes every token's best remaining expert
    (``argmax``: the first of ties), its slot is the count of earlier
    tokens that chose that expert (a running fill count across passes), a
    token past the capacity is dropped, and the kept gates are
    renormalised to sum to 1 a token. One-hots are comparisons against
    ``arange``, so the function batches under ``torch.func.vmap``."""
    e = probs.shape[-1]
    experts = torch.arange(e, device=probs.device)
    slots = torch.arange(capacity, device=probs.device)
    combine = probs.new_zeros((*probs.shape, capacity))
    counts = probs.new_zeros((*probs.shape[:-2], 1, e))
    p = probs
    top1 = None
    for _ in range(top_k):
        onehot = (p.argmax(dim=-1, keepdim=True) == experts).to(probs.dtype)  # [.., S, E]
        if top1 is None:
            top1 = onehot
        gate = (p * onehot).sum(-1)
        # position of each token within its chosen expert's buffer
        pos = onehot.cumsum(dim=-2) - onehot + counts
        pos_in_e = (pos * onehot).sum(-1)
        keep = (pos_in_e < capacity).to(probs.dtype)
        slot = (pos_in_e.clamp(max=capacity - 1).long()[..., None] == slots).to(probs.dtype)  # [.., S, C]
        combine = combine + (gate * keep)[..., None, None] * onehot[..., None] * slot[..., None, :]
        counts = counts + onehot.sum(dim=-2, keepdim=True)
        p = p * (1.0 - onehot)  # mask the chosen expert for the next pass
    total = combine.sum(dim=(-2, -1), keepdim=True)
    return combine / total.clamp(min=1e-9), top1


class MoEMLP(nn.Module):
    """Mixture-of-experts SwiGLU FFN with capacity-based dense dispatch
    (JAX's ``MoEMLP``, the GShard/Switch formulation): the router's
    ``[S, E, C]`` dispatch and combine tensors turn the layer into batched
    matmuls of static shapes, the experts stacked on a leading ``[E, ...]``
    axis. Tokens past an expert's capacity ``C = ceil(k·S/E · capacity)``
    are dropped (their combine weight is 0; the residual carries them).

    Routing runs over the last two input dims ``[b, t]`` (S = b·t tokens),
    as JAX's layer sees ``[b, t, d]``; any dims before them (a node-stacked
    input) route apart. ``forward`` returns ``(out, aux)`` with aux the
    Switch load-balance loss ``E·Σ_e f_e·p̄_e`` times ``moe_aux_coef``
    plus the router z-loss ``mean(logsumexp(logits)²)`` times
    ``moe_zloss_coef``, one a routing group (a scalar for ``[b, t, d]``)."""

    def __init__(self, cfg: TransformerConfig) -> None:
        super().__init__()
        self.cfg = cfg

    def forward(self, p: dict, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        dt, e, k = cfg.dtype, cfg.n_experts, cfg.moe_top_k
        lead, d = x.shape[:-3], x.shape[-1]
        s = x.shape[-3] * x.shape[-2]
        xs = x.reshape(*lead, s, d)
        logits = xs.float() @ p["router"].float()  # [.., S, E]
        probs = torch.softmax(logits, dim=-1)
        capacity = max(1, int(-(-k * s // e) * cfg.moe_capacity))
        combine, top1 = moe_route(probs, k, capacity)
        dispatch = (combine > 0.0).to(dt)  # [.., S, E, C]
        xe = torch.einsum("...sec,...sd->...ecd", dispatch, xs.to(dt))  # [.., E, C, D]
        gate = torch.einsum("...ecd,edf->...ecf", xe, p["w1"].to(dt))
        up = torch.einsum("...ecd,edf->...ecf", xe, p["w3"].to(dt))
        ye = torch.einsum("...ecf,efd->...ecd", F.silu(gate) * up, p["w2"].to(dt))
        out = torch.einsum("...sec,...ecd->...sd", combine.to(dt), ye)
        # Switch load-balance loss: E · Σ_e (top-1 token fraction · mean prob)
        balance = e * (top1.mean(dim=-2) * probs.mean(dim=-2)).sum(-1)
        zloss = (torch.logsumexp(logits, dim=-1) ** 2).mean(-1)
        aux = cfg.moe_aux_coef * balance + cfg.moe_zloss_coef * zloss
        return out.reshape(x.shape), aux


class Block(nn.Module):
    def __init__(self, cfg: TransformerConfig, attn_fn: Optional[Callable] = None) -> None:
        super().__init__()
        self.cfg = cfg
        self.attn_norm = RMSNorm(cfg.dtype)
        self.attn = Attention(cfg, attn_fn)
        self.mlp_norm = RMSNorm(cfg.dtype)
        self.mlp = MoEMLP(cfg) if cfg.n_experts > 0 else MLP(cfg)

    def forward(self, p: dict, x: torch.Tensor) -> torch.Tensor:
        return self.forward_with_aux(p, x)[0]

    def forward_with_aux(self, p: dict, x: torch.Tensor) -> tuple:
        """``(x, aux)``: the block's output and its FFN's router losses
        (``None`` for the dense SwiGLU). Under ``remat_policy`` "mlp" and
        "mlp_qkv" the FFN (experts too) runs outside every segment, so its
        gate and up activations are kept."""
        cfg = self.cfg
        if not cfg.remat:
            return self._block(p, x)
        if cfg.remat_policy is None:
            return _segment(self._block, p, x)
        if cfg.remat_policy == "mlp":
            x, h = _segment(self._attn_side, p, x)
        else:  # "mlp_qkv"
            q, k, v = self.attn.qkv(p["attn"], self.attn_norm(p["attn_norm"], x))
            x, h = _segment(self._attn_rest, p, x, q, k, v)
        out, aux = self._ffn(p["mlp"], h)
        return x + out, aux

    def _ffn(self, p: dict, h: torch.Tensor) -> tuple:
        if isinstance(self.mlp, MoEMLP):
            return self.mlp(p, h)
        return self.mlp(p, h), None

    def _block(self, p: dict, x: torch.Tensor) -> tuple:
        x, h = self._attn_side(p, x)
        out, aux = self._ffn(p["mlp"], h)
        return x + out, aux

    def _attn_side(self, p: dict, x: torch.Tensor) -> tuple:
        """The residual after attention and the FFN's normed input."""
        return self._attn_rest(p, x, *self.attn.qkv(p["attn"], self.attn_norm(p["attn_norm"], x)))

    def _attn_rest(self, p: dict, x: torch.Tensor, q, k, v) -> tuple:
        x = x + self.attn.core(p["attn"], q, k, v)
        return x, self.mlp_norm(p["mlp_norm"], x)


class CausalLM(nn.Module):
    """tokens [..., T] int → logits [..., T, vocab] fp32."""

    def __init__(self, cfg: TransformerConfig, attn_fn: Optional[Callable] = None) -> None:
        super().__init__()
        if cfg.scan_layers and cfg.n_experts > 0:
            # as JAX: its scanned layout cannot hold MoE layers (flax's scan
            # does not thread the sown router losses)
            raise NotImplementedError("scan_layers with MoE: use unrolled layers for MoE")
        self.cfg = cfg
        self.layers = nn.ModuleList(Block(cfg, attn_fn) for _ in range(cfg.n_layers))
        self.final_norm = RMSNorm(cfg.dtype)

    def forward(self, params: dict, tokens: torch.Tensor) -> torch.Tensor:
        return self.forward_with_aux(params, tokens)[0]

    def forward_with_aux(self, params: dict, tokens: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """``(logits, aux)``: aux sums the MoE layers' router losses (what
        JAX's ``apply_with_aux`` reads from the sown collection), an fp32
        zero for a dense model."""
        dt = self.cfg.dtype
        emb = params["embed"]
        x = F.embedding(tokens.long(), emb).to(dt)
        aux = None
        for i, block in enumerate(self.layers):
            x, a = block.forward_with_aux(params[f"layer_{i}"], x)
            if a is not None:
                aux = a if aux is None else aux + a
        x = self.final_norm(params["final_norm"], x)
        logits = (x @ emb.to(dt).t()).float()  # tied embeddings
        return logits, logits.new_zeros(()) if aux is None else aux


def pick_attention(seq_len: int, device=None) -> str:
    """The ``attn="auto"`` policy (JAX's ``pick_attention``): ``"flash"``
    on a CUDA device from ``Settings.FLASH_MIN_SEQ_LEN`` on, ``"dense"``
    below it and anywhere else. JAX answers dense off the TPU, where its
    kernel would run in interpret mode; here the CPU's flash is the plain
    versions, a correctness path, not a fast one. ``device=None`` is the
    card, as every entry point's default. Single-device policy: the rings
    shard the sequence over a mesh and are chosen explicitly."""
    from p2pfl_tpu_torch.settings import Settings

    if resolve_device(device).type != "cuda":
        return "dense"
    return "flash" if seq_len >= Settings.FLASH_MIN_SEQ_LEN else "dense"


def resolve_attention(
    attn: str, config: Optional[FlashConfig] = None, mesh: Any = None,
    seq_len: Optional[int] = None, device=None,
) -> Optional[Callable]:
    """Map a backend name to an ``(q, k, v) -> out`` callable (``None`` =
    dense, as in JAX). ``"auto"`` picks dense or flash by ``seq_len`` on
    ``device`` (:func:`pick_attention`). ``"ring"`` and ``"ring_flash"``
    shard the sequence over the ``Settings.MESH_MODEL_AXIS`` axis of
    ``mesh``; ``config`` is the flash schedule of ``"flash"`` and of every
    ring hop of ``"ring_flash"``."""
    if attn == "auto":
        if seq_len is None:
            raise ValueError("attn='auto' needs seq_len to pick a backend")
        attn = pick_attention(seq_len, device)
    if attn == "dense":
        return None
    if attn == "flash":
        from p2pfl_tpu_torch.ops.flash_attention import flash_attention

        return partial(flash_attention, causal=True, config=config)
    if attn in ("ring", "ring_flash"):
        if mesh is None:
            raise ValueError(f"attn={attn!r} needs a mesh (sequence is sharded over it)")
        from p2pfl_tpu_torch.ops.attention import ring_attention
        from p2pfl_tpu_torch.settings import Settings

        flash = attn == "ring_flash"
        return partial(
            ring_attention, mesh=mesh, axis_name=Settings.MESH_MODEL_AXIS,
            impl="flash" if flash else "dense", flash_config=config if flash else None,
        )
    raise ValueError(f"unknown attention backend {attn!r} (auto|dense|flash|ring|ring_flash)")


# ---- initialisation (flax's initialisers, from a torch.Generator) ----


def _normal(shape, std, gen, device):
    return torch.randn(shape, generator=gen, device=device, dtype=torch.float32) * std


def _lecun_normal(shape, gen, device):
    """flax ``lecun_normal``: truncated normal in [-2, 2] std, variance
    1/fan_in, fan_in = shape[-2] times the leading dims (flax's receptive
    field: an ``[E, in, out]`` expert stack has fan_in E·in)."""
    std = math.sqrt(1.0 / math.prod(shape[:-1])) / 0.87962566103423978
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

    def moe():
        # JAX's MoEMLP params: the router, then the [E, ...] expert stacks
        e, d, f = cfg.n_experts, cfg.dim, cfg.ffn_hidden
        return {
            "router": _normal((d, e), 0.02, gen, dev),
            "w1": _lecun_normal((e, d, f), gen, dev),
            "w3": _lecun_normal((e, d, f), gen, dev),
            "w2": _lecun_normal((e, f, d), gen, dev),
        }

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
            "mlp": moe() if cfg.n_experts > 0 else {
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
    mesh: Any = None,
) -> TorchModel:
    """A LoRA-ready causal LM bound to fresh parameters on ``device``.

    ``attn`` is ``"auto"`` (:func:`pick_attention` for ``seq_len`` on
    ``device``), ``"dense"``, ``"flash"``, ``"ring"`` or ``"ring_flash"``
    (the ring ones need ``mesh``, a
    :func:`~p2pfl_tpu_torch.parallel.mesh.federation_mesh` whose ``model``
    axis shards the sequence); ``attn_fn`` overrides it. For flash,
    ``cfg.flash_config`` pins the schedule, else the defaults row of
    :mod:`p2pfl_tpu_torch.ops.autotune` is resolved here for the attended
    length: the whole sequence for ``"flash"``, one shard for
    ``"ring_flash"`` (each hop's kernel sees ``seq_len // model``).
    """
    cfg = cfg or TransformerConfig()
    if attn == "auto":
        attn = pick_attention(seq_len, device)
    if attn_fn is None:
        if attn in ("flash", "ring_flash"):
            from p2pfl_tpu_torch.ops.autotune import _fit, default_flash_config

            basis = seq_len
            if attn == "ring_flash":
                if mesh is None:
                    raise ValueError("attn='ring_flash' needs a mesh")
                from p2pfl_tpu_torch.settings import Settings

                basis = seq_len // mesh.shape[Settings.MESH_MODEL_AXIS]
            if _fit(basis, 512) > 512:
                raise ValueError(
                    f"attn={attn!r} needs a flash block <= 512 dividing the attended "
                    f"length: {basis} (seq_len per shard) has no multiple-of-8 divisor"
                )
            flash_cfg = cfg.flash_config or default_flash_config(basis, cfg.head_dim)
            attn_fn = resolve_attention(attn, config=flash_cfg, mesh=mesh)
        else:
            attn_fn = resolve_attention(attn, mesh=mesh)
    module = CausalLM(cfg, attn_fn)
    params = init_params(cfg, seed, device)
    model = TorchModel(module, params, (seq_len,), cfg.vocab_size)
    model.extra["config"] = cfg
    return model
