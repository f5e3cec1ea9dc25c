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

import torch

from p2pfl_tpu_torch.learning import learner
from p2pfl_tpu_torch.learning.learner import GradientTransformation, LearningRate
from p2pfl_tpu_torch.ops.tree import tree_leaves, tree_map


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
    return GradientTransformation(init, update, all(tx.capturable for tx in txs), stacked)


def clipped(name: str = "adam", lr: LearningRate = 1e-3, max_norm: float = 1.0) -> GradientTransformation:
    """Global-norm gradient clipping around a base optimizer."""
    base = {"adam": adam, "adamw": adamw, "sgd": sgd}[name](lr)
    return chain(clip_by_global_norm(max_norm), base)
