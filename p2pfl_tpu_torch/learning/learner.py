"""Optimizer and loss math (subset of ``p2pfl_tpu/learning/learner.py``).

``adam`` follows optax's semantics exactly (moment updates written as
optax writes them, bias correction in fp32, ``eps`` outside the square
root, updates scaled by ``-lr`` and added to the params) and works
elementwise, so a node-stacked ``[N, ...]`` tree steps every node at once.
The gossip ``NodeLearner`` family waits for the node slice (ROADMAP).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from p2pfl_tpu_torch.ops.tree import tree_map


class AdamState(NamedTuple):
    count: int
    mu: dict
    nu: dict


class GradientTransformation(NamedTuple):
    """optax's ``(init, update)`` pair; ``update(grads, state, params)``
    returns ``(updates, new_state)``."""

    init: Callable
    update: Callable


def adam(
    lr: float = 1e-3, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8
) -> GradientTransformation:
    def init(params: dict) -> AdamState:
        zeros = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
        return AdamState(0, zeros, tree_map(torch.clone, zeros))

    def update(grads: dict, state: AdamState, params=None):
        del params
        mu = tree_map(lambda g, m: (1 - b1) * g + b1 * m, grads, state.mu)
        nu = tree_map(lambda g, v: (1 - b2) * (g * g) + b2 * v, grads, state.nu)
        count = state.count + 1
        f32 = torch.float32
        bc1 = 1 - torch.tensor(b1, dtype=f32) ** count
        bc2 = 1 - torch.tensor(b2, dtype=f32) ** count
        updates = tree_map(
            lambda m, v: (m / bc1.to(m.device)) / (torch.sqrt(v / bc2.to(v.device)) + eps) * (-lr),
            mu, nu,
        )
        return updates, AdamState(count, mu, nu)

    return GradientTransformation(init, update)


def apply_updates(params: dict, updates: dict) -> dict:
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-position CE, written as optax's
    ``softmax_cross_entropy_with_integer_labels``."""
    logits = logits - logits.amax(-1, keepdim=True).detach()
    label_logits = logits.gather(-1, labels.long()[..., None])[..., 0]
    return torch.log(torch.exp(logits).sum(-1)) - label_logits


def ce_eval(params: dict, module, x, y):
    """Pure-CE eval loss (mean over every position) + logits."""
    logits = module(params, x)
    return softmax_cross_entropy(logits, y).mean(), logits
