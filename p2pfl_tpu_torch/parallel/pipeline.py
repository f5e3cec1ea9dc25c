"""GPipe pipeline parallelism over a mesh axis (counterpart of
``p2pfl_tpu/parallel/pipeline.py``).

A stack of L identical layers (transformer blocks) splits into ``P =
mesh.shape[axis]`` contiguous stages: stage s holds layers ``[s·L/P,
(s+1)·L/P)`` on its mesh position's device. Microbatches stream through
the stages on the GPipe schedule of ``M + P − 1`` steps: at step t stage s
runs microbatch ``t − s``, and its activation passes to stage s + 1 by
``Tensor.to`` (a no-op when both stages name one device).

JAX runs the schedule as one SPMD program (a ``lax.scan`` over the steps,
a ``ppermute`` hand-off each): every stage computes at every step, and the
fill and drain steps' garbage is masked out of the outputs and the aux
sum. The port runs only the valid (step, stage) pairs, so it computes
exactly what JAX's masks keep: the same result. The host enqueues the
pairs in schedule order, so stages on distinct cards overlap; stages on
one card run in turn. Autograd runs through the whole schedule (a
hand-off's backward is the reverse copy), so the gradient of a pipelined
loss is the gradient of the sequential one.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch
import torch.nn.functional as F

from p2pfl_tpu_torch.ops.tree import tree_leaves, tree_map
from p2pfl_tpu_torch.parallel.mesh import Mesh, pipeline_mesh

__all__ = ["pipeline_mesh", "stack_layers", "pipeline_apply", "pipelined_lm_apply"]

Tree = Any


def stack_layers(per_layer_params: list) -> Tree:
    """Stack per-layer param trees into one ``[L, ...]`` tree."""
    return tree_map(lambda *xs: torch.stack(xs), *per_layer_params)


def stage_layers(layers: list, mesh: Mesh, axis: str = "pipe") -> list:
    """``[(device, [layer trees]), ...]`` a stage: the layers split into
    ``mesh.shape[axis]`` contiguous runs, each run's params on its stage's
    device. Indivisible layers raise."""
    n_stages = mesh.shape[axis]
    if len(layers) % n_stages != 0:
        raise ValueError(f"{len(layers)} layers not divisible by {n_stages} stages")
    per = len(layers) // n_stages
    return [
        (dev, [tree_map(lambda x, dev=dev: x.to(dev), p) for p in layers[s * per:(s + 1) * per]])
        for s, dev in enumerate(mesh.axis_devices(axis))
    ]


def gpipe(stages: list, xs: list, apply_layer: Callable) -> tuple[list, torch.Tensor]:
    """The GPipe schedule over ``stages`` (:func:`stage_layers`) for the
    microbatches ``xs``. ``apply_layer(p_layer, act) -> (act, aux)`` with
    ``aux`` an fp32 scalar. Returns the M outputs (on the last stage's
    device) and the aux summed over layers and averaged over microbatches
    (each stage's sum over its valid steps, then the stages' sum, as JAX's
    ``psum``)."""
    n_stages, m_micro = len(stages), len(xs)
    held = list(xs)  # microbatch m's activation, bound for the stage that runs it next
    stage_aux: list[Optional[torch.Tensor]] = [None] * n_stages
    for step in range(m_micro + n_stages - 1):
        for s in range(n_stages):
            m = step - s
            if not 0 <= m < m_micro:
                continue  # a fill or drain pair: JAX computes it and masks it out
            dev, layers = stages[s]
            act, aux = held[m].to(dev), None
            for p in layers:
                act, a = apply_layer(p, act)
                aux = a if aux is None else aux + a
            stage_aux[s] = aux if stage_aux[s] is None else stage_aux[s] + aux
            held[m] = act if s == n_stages - 1 else act.to(stages[s + 1][0])
    last = stages[-1][0]
    total = None
    for a in stage_aux:
        total = a.to(last) if total is None else total + a.to(last)
    return held, total / m_micro


def pipeline_apply(
    stacked_params: Tree,
    x_microbatches: torch.Tensor,
    apply_layer: Callable,
    mesh: Mesh,
    axis: str = "pipe",
    with_aux: bool = False,
):
    """Run ``[M, mb, ...]`` microbatches through pipelined stacked layers.

    ``stacked_params``: a tree with a leading layer axis ``[L, ...]``, L
    divisible by ``mesh.shape[axis]``. ``apply_layer(p_layer, act) ->
    act`` applies one layer; with ``with_aux=True`` it returns ``(act,
    aux_scalar)`` and the call returns ``(out, aux)``, aux summed over
    layers and averaged over microbatches (how MoE balance losses ride the
    pipeline). Differentiable end to end; the output lies on the last
    stage's device."""
    n_layers = tree_leaves(stacked_params)[0].shape[0] if isinstance(stacked_params, dict) \
        else stacked_params.shape[0]
    layers = [tree_map(lambda x, i=i: x[i], stacked_params) for i in range(n_layers)]
    stages = stage_layers(layers, mesh, axis)
    if with_aux:
        layer_fn = apply_layer
    else:
        def layer_fn(p, act):
            return apply_layer(p, act), torch.zeros((), dtype=torch.float32, device=act.device)

    ys, aux = gpipe(stages, list(x_microbatches.unbind(0)), layer_fn)
    out = torch.stack(ys)
    return (out, aux) if with_aux else out


def pipelined_lm_apply(
    params: dict,
    tokens: torch.Tensor,
    cfg,
    mesh: Mesh,
    axis: str = "pipe",
    n_micro: int = 0,
    attn_fn: Optional[Callable] = None,
    return_aux: bool = False,
):
    """Forward a :class:`~p2pfl_tpu_torch.models.transformer.CausalLM`
    param tree with its ``layer_i`` blocks pipelined over ``mesh[axis]``.

    The embedding, the final norm and the tied head stay on the params'
    device; only the blocks stream through the stages, each stage's layers
    moved to its device (nothing moves on one card). ``n_micro`` defaults
    to the stage count; the batch must divide into ``n_micro``
    microbatches. ``attn_fn`` is the model's attention (``CausalLM.attn_fn``);
    with none, ``cfg.flash_config`` picks the flash kernels inside every
    stage's ``Block``, as the monolithic model does.

    MoE blocks (``cfg.n_experts > 0``): each microbatch routes apart (its
    balance fractions are its own, not the full batch's), and the router
    losses come back with ``return_aux=True``; without it an MoE config
    raises, as JAX does (dropping them silently breaks routing)."""
    from p2pfl_tpu_torch.models.transformer import Block, RMSNorm

    if cfg.n_experts > 0 and not return_aux:
        raise ValueError(
            "MoE pipeline: pass return_aux=True and add the aux loss "
            "(silently dropping router balance losses breaks routing)"
        )
    n_micro = n_micro or mesh.shape[axis]
    b = tokens.shape[0]
    if b % n_micro != 0:
        raise ValueError(f"batch {b} not divisible into {n_micro} microbatches")
    dt = cfg.dtype
    emb = params["embed"]
    x = F.embedding(tokens.long().to(emb.device), emb).to(dt)  # [B, T, D]
    xs = list(x.reshape(n_micro, b // n_micro, *x.shape[1:]).unbind(0))
    block = Block(cfg, attn_fn)

    def apply_layer(p, act):
        out, aux = block.forward_with_aux(p, act)
        return out, torch.zeros((), dtype=torch.float32, device=act.device) if aux is None else aux

    stages = stage_layers([params[f"layer_{i}"] for i in range(cfg.n_layers)], mesh, axis)
    ys, aux = gpipe(stages, xs, apply_layer)
    y = RMSNorm(dt)(params["final_norm"], torch.cat(ys).to(emb.device))
    logits = (y @ emb.to(dt).t()).float()  # tied embeddings
    return (logits, aux.to(emb.device)) if return_aux else logits
