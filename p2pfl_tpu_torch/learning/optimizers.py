"""Optimizer constructors and learning-rate schedules (counterpart of
``p2pfl_tpu/learning/optimizers.py``).

The transforms build on :func:`~p2pfl_tpu_torch.learning.learner.adam`
and :func:`~p2pfl_tpu_torch.learning.learner.sgd`, the port's one
implementation of each step in optax's order and rounding. The JAX
module caches its constructors so that equal configurations share one
jit cache entry; nothing here is traced, so nothing is cached.

A schedule is a function of the int32 step count, a 0-d tensor on the
device, and returns a 0-d fp32 tensor there: a scheduled step reads
nothing back to the host and replays inside a captured CUDA graph.
Schedules compute as optax's do in fp32, in the same order; the cosine is
taken correctly rounded, as XLA's nearly always is, so a schedule equals
optax's at nearly every count and is within 2 ulps at the others
(``tests/test_torch_optimizers.py``).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from p2pfl_tpu_torch.learning import learner
from p2pfl_tpu_torch.learning.learner import GradientTransformation, LearningRate
from p2pfl_tpu_torch.ops.tree import tree_items, tree_leaves, tree_map, tree_unflatten


def linear_schedule(init_value: float, end_value: float, transition_steps: int, transition_begin: int = 0):
    """optax's ``linear_schedule``: ``init`` until ``transition_begin``, then
    linear to ``end`` over ``transition_steps``, then ``end``."""
    if transition_steps <= 0:
        return lambda count: torch.full((), init_value, dtype=torch.float32, device=count.device)
    begin = max(transition_begin, 0)

    def schedule(count: torch.Tensor) -> torch.Tensor:
        frac = 1 - torch.clamp(count - begin, 0, transition_steps) / transition_steps
        return (init_value - end_value) * frac + end_value

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0, exponent: float = 1.0):
    """optax's ``cosine_decay_schedule``: ``init · ((1 − α)·c^p + α)`` with
    ``c = ½(1 + cos(π·min(count, T)/T))``."""
    if not decay_steps > 0:
        raise ValueError(f"The cosine_decay_schedule requires positive decay_steps, got {decay_steps=}.")
    steps = float(decay_steps)

    def schedule(count: torch.Tensor) -> torch.Tensor:
        t = torch.clamp(count.float(), max=steps)
        # the fp32 cosine correctly rounded (taken in fp64), as XLA's nearly
        # always is: near the end of the decay 1 + cos cancels, and an ulp
        # of the cosine there is many ulps of the schedule
        cosine = 0.5 * (1 + torch.cos((math.pi * t / steps).double()).float())
        return init_value * ((1 - alpha) * cosine**exponent + alpha)

    return schedule


def warmup_cosine_decay_schedule(
    init_value: float, peak_value: float, warmup_steps: int, decay_steps: int,
    end_value: float = 0.0, exponent: float = 1.0,
):
    """optax's ``warmup_cosine_decay_schedule``: linear warmup from
    ``init_value`` to ``peak_value`` over ``warmup_steps``, then cosine decay
    to ``end_value`` at ``decay_steps`` (warmup included)."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    warmup = linear_schedule(init_value, peak_value, warmup_steps)
    decay = cosine_decay_schedule(peak_value, decay_steps - warmup_steps, alpha, exponent)

    def schedule(count: torch.Tensor) -> torch.Tensor:
        # optax's join_schedules: the second schedule counts from the boundary
        return torch.where(count < warmup_steps, warmup(count), decay(count - warmup_steps))

    return schedule


def adam(lr: LearningRate = 1e-3, b1: float = 0.9, b2: float = 0.999) -> GradientTransformation:
    return learner.adam(lr, b1=b1, b2=b2)


def adamw(lr: LearningRate = 1e-3, weight_decay: float = 1e-4) -> GradientTransformation:
    return learner.adam(lr, weight_decay=weight_decay)


def sgd(lr: LearningRate = 1e-2, momentum: float = 0.9, nesterov: bool = False) -> GradientTransformation:
    return learner.sgd(lr, momentum=momentum, nesterov=nesterov)


def adam_cosine(lr: float = 1e-3, decay_steps: int = 10_000, warmup_steps: int = 100) -> GradientTransformation:
    """Adam with linear warmup + cosine decay (the standard LM recipe)."""
    return learner.adam(warmup_cosine_decay_schedule(0.0, lr, warmup_steps=warmup_steps, decay_steps=decay_steps))


def clip_by_global_norm(max_norm: float, node_axis: bool = False) -> GradientTransformation:
    """optax's ``clip_by_global_norm``: an update whose global L2 norm is at
    least ``max_norm`` becomes ``(t / norm) · max_norm``, chosen on the
    device. ``node_axis``: the tree is node-stacked ``[N, ...]`` and each
    node's norm is its own (the form ``SpmdFederation`` runs)."""
    lead = 1 if node_axis else 0

    def update(grads: dict, state, params=None):
        del params
        sq = sum(g.float().square().sum(dim=tuple(range(lead, g.dim()))) for g in tree_leaves(grads))
        norm = torch.sqrt(sq)
        keep = norm < max_norm

        def clip(t: torch.Tensor) -> torch.Tensor:
            shape = norm.shape + (1,) * (t.dim() - lead)
            return torch.where(keep.reshape(shape), t, (t / norm.reshape(shape).to(t.dtype)) * max_norm)

        return tree_map(clip, grads), state

    stacked = None if node_axis else clip_by_global_norm(max_norm, node_axis=True)
    return GradientTransformation(lambda params: (), update, capturable=True, node_stacked=stacked)


def chain(*txs: GradientTransformation) -> GradientTransformation:
    """optax's ``chain``: each transform's updates feed the next; the state
    is the tuple of their states."""

    def init(params: dict) -> tuple:
        return tuple(tx.init(params) for tx in txs)

    def update(grads: dict, state: tuple, params=None):
        out = []
        for tx, s in zip(txs, state):
            grads, s = tx.update(grads, s, params)
            out.append(s)
        return grads, tuple(out)

    stacked = None
    if any(tx.node_stacked is not None for tx in txs):
        stacked = chain(*(tx.node_stacked or tx for tx in txs))
    return GradientTransformation(init, update, all(tx.capturable for tx in txs), stacked,
                                  elementwise=all(tx.elementwise for tx in txs))


def clipped(name: str = "adam", lr: LearningRate = 1e-3, max_norm: float = 1.0) -> GradientTransformation:
    """Global-norm gradient clipping around a base optimizer."""
    base = {"adam": adam, "adamw": adamw, "sgd": sgd}[name](lr)
    return chain(clip_by_global_norm(max_norm), base)


class FactoredState(NamedTuple):
    """Adafactor's state, optax's ``FactoredState``: the int32 step count on
    the device and, a leaf each, the row and column statistics of a
    factored leaf or the full second moment of another (``[1]`` zeros
    where a leaf has none of the kind, as in optax)."""

    count: torch.Tensor
    v_row: dict
    v_col: dict
    v: dict


def _factored_dims(shape, factored: bool, min_dim_size_to_factor: int) -> Optional[tuple[int, int]]:
    """optax's choice: the two largest axes ``(d1, d0)`` of a leaf of rank
    >= 2 whose second largest is at least ``min_dim_size_to_factor``
    (numpy's ``argsort``, as optax, so ties fall alike), else None."""
    if not factored or len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return int(order[-2]), int(order[-1])


def adafactor(
    learning_rate: Optional[LearningRate] = None,
    min_dim_size_to_factor: int = 128,
    decay_rate: float = 0.8,
    decay_offset: int = 0,
    multiply_by_parameter_scale: bool = True,
    clipping_threshold: Optional[float] = 1.0,
    eps: float = 1e-30,
    factored: bool = True,
) -> GradientTransformation:
    """optax's ``adafactor`` (Shazeer and Stern, 2018) with its defaults, as
    ``optax.adafactor(learning_rate=...)`` chains them:

    1. ``scale_by_factored_rms``: the decay ``1 − (t + 1)^−decay_rate`` of
       step t; a leaf of rank >= 2 whose two largest axes are at least
       ``min_dim_size_to_factor`` keeps row and column means of ``g² +
       eps`` and scales ``g`` by ``(v_row / mean(v_row))^−½`` and
       ``v_col^−½``; any other leaf keeps the full ``v`` and scales by
       ``v^−½``;
    2. ``clip_by_block_rms(clipping_threshold)``: each leaf divided by
       ``max(1, rms / threshold)``;
    3. the learning rate (a float, or a schedule of the step count);
    4. ``multiply_by_parameter_scale``: times the leaf's parameter rms, at
       least 1e-3;
    5. times −1.

    The leaves step one at a time in fp32 on the device (the step count
    too), so a step reads nothing back to the host. optax's ``momentum``
    and ``weight_decay_rate`` are not ported (both default to off)."""

    def init(params: dict) -> FactoredState:
        rows, cols, full = {}, {}, {}
        for path, p in tree_items(params):
            dims = _factored_dims(tuple(p.shape), factored, min_dim_size_to_factor)
            one = torch.zeros((1,), dtype=p.dtype, device=p.device)
            if dims is None:
                rows[path], cols[path], full[path] = one, one.clone(), torch.zeros_like(p)
            else:
                d1, d0 = dims
                rows[path] = torch.zeros([s for i, s in enumerate(p.shape) if i != d0], dtype=p.dtype, device=p.device)
                cols[path] = torch.zeros([s for i, s in enumerate(p.shape) if i != d1], dtype=p.dtype, device=p.device)
                full[path] = one.clone()
        return FactoredState(learner._zero_count(params), tree_unflatten(rows), tree_unflatten(cols),
                             tree_unflatten(full))

    def update(grads: dict, state: FactoredState, params=None):
        if params is None:
            raise ValueError("adafactor needs the params (multiply_by_parameter_scale and the factoring)")
        t = (state.count - decay_offset + 1).float()
        decay = 1.0 - t ** (-decay_rate)
        rows, cols, full = dict(tree_items(state.v_row)), dict(tree_items(state.v_col)), dict(tree_items(state.v))
        out, new_rows, new_cols, new_full = {}, {}, {}, {}
        lr = learning_rate(state.count) if callable(learning_rate) else learning_rate
        for (path, g), p in zip(tree_items(grads), tree_leaves(params)):
            dims = _factored_dims(tuple(p.shape), factored, min_dim_size_to_factor)
            g_sq = g * g + eps
            if dims is not None:
                d1, d0 = dims
                v_row = (decay * rows[path] + (1.0 - decay) * g_sq.mean(dim=d0)).to(p.dtype)
                v_col = (decay * cols[path] + (1.0 - decay) * g_sq.mean(dim=d1)).to(p.dtype)
                reduced_d1 = d1 - 1 if d1 > d0 else d1
                row_factor = (v_row / v_row.mean(dim=reduced_d1, keepdim=True)) ** -0.5
                u = g * row_factor.unsqueeze(d0) * (v_col ** -0.5).unsqueeze(d1)
                new_rows[path], new_cols[path], new_full[path] = v_row, v_col, full[path]
            else:
                v = (decay * full[path] + (1.0 - decay) * g_sq).to(p.dtype)
                u = g * v ** -0.5
                new_rows[path], new_cols[path], new_full[path] = rows[path], cols[path], v
            if clipping_threshold is not None:
                u = u / torch.clamp(torch.sqrt((u * u).mean()) / clipping_threshold, min=1.0)
            if lr is not None:
                u = u * lr
            if multiply_by_parameter_scale:
                rms = torch.sqrt((p * p).mean())
                u = u * torch.where(rms <= 1e-3, torch.full_like(rms, 1e-3), rms)
            out[path] = u * -1
        count = torch.where(state.count < torch.iinfo(torch.int32).max, state.count + 1, state.count)
        state = FactoredState(count, tree_unflatten(new_rows), tree_unflatten(new_cols), tree_unflatten(new_full))
        return tree_unflatten(out), state

    return GradientTransformation(init, update, capturable=True)
