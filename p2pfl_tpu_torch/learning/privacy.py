"""Differential privacy: DP-SGD gradients and an RDP accountant
(counterpart of ``p2pfl_tpu/learning/privacy.py``).

- Per-example gradients: the single-example loss is vmapped over the
  batch (``torch.func.vmap``), each example reading its own expanded copy
  of the parameters, and one autograd pass returns every example's
  gradient at once. Autograd (not ``torch.func.grad``) keeps
  ``torch.utils.checkpoint`` available for ``remat``.
- Each example's gradient is clipped to global L2 norm ``clip``.
- Gaussian noise ``N(0, (noise · clip / B)²)`` is added to the mean, drawn
  from a ``torch.Generator``: JAX's threefry streams have no torch
  counterpart, so the noise matches JAX's in distribution only.
- :func:`dp_train_epoch` is the gossip Node's DP epoch
  (``TorchLearner(dp_clip=...)``); the SPMD federation calls
  :func:`dp_grads` with its node axis.

:class:`PrivacyAccountant` is plain Python math, the JAX package's
accountant line for line, so its ε is bit-equal to JAX's.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
from torch.utils.checkpoint import checkpoint

from p2pfl_tpu_torch.ops.tree import tree_items, tree_leaves, tree_map, tree_unflatten


def clip_by_global_norm(grads: dict, clip: float, batch_dims: int = 0) -> dict:
    """Scale ``grads`` so its global L2 norm is at most ``clip``. With
    ``batch_dims`` leading axes (examples, nodes) each index of those axes
    is one tree, clipped on its own."""

    def sq(g: torch.Tensor) -> torch.Tensor:
        return g.float().square().sum(dim=tuple(range(batch_dims, g.dim())))

    norm = torch.sqrt(sum(sq(g) for g in tree_leaves(grads)))
    scale = torch.clamp(clip / torch.clamp(norm, min=1e-12), max=1.0)

    def apply(g: torch.Tensor) -> torch.Tensor:
        s = scale.reshape(scale.shape + (1,) * (g.dim() - batch_dims))
        return (g.float() * s).to(g.dtype)

    return tree_map(apply, grads)


def dp_grads(
    loss_one: Callable, params: dict, x: torch.Tensor, y: torch.Tensor, clip: float,
    noise: float, generator: Optional[torch.Generator] = None, remat: bool = False,
    anchor: Optional[dict] = None, node_axis: bool = False,
):
    """Per-example clipped + noised mean gradient (the DP-SGD estimator).

    ``loss_one(p, x_i, y_i, anchor) -> scalar`` is the single-example
    loss; ``anchor`` (FedProx's round-start tree, or None) is passed
    through. ``x``/``y`` carry the batch axis, after the node axis when
    ``node_axis`` (then ``params`` and ``anchor`` are node-stacked too).
    ``remat`` recomputes the forward in the backward
    (``torch.utils.checkpoint``). Returns ``(grads, mean loss)``, the loss
    per node when ``node_axis``.
    """
    lead = 2 if node_axis else 1  # [N,] B
    batch = x.shape[lead - 1]
    paths = [p for p, _ in tree_items(params)]
    # each example's own copy of its node's params: one autograd pass
    # then returns a per-example gradient
    leaves = [
        p.unsqueeze(lead - 1).expand(*x.shape[:lead], *p.shape[lead - 1:]).detach().requires_grad_(True)
        for p in tree_leaves(params)
    ]
    fn = torch.func.vmap(loss_one, in_dims=(0, 0, 0, None))
    if node_axis:
        fn = torch.func.vmap(fn, in_dims=(0, 0, 0, 0 if anchor is not None else None))

    def losses(*lv):
        return fn(tree_unflatten(dict(zip(paths, lv))), x, y, anchor)

    with torch.enable_grad():
        per = checkpoint(losses, *leaves, use_reentrant=False) if remat else losses(*leaves)
        grads = torch.autograd.grad(per.sum(), leaves)
    clipped = clip_by_global_norm(tree_unflatten(dict(zip(paths, grads))), clip, batch_dims=lead)
    sigma = noise * clip / batch

    def finish(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
        mean = g.float().mean(dim=lead - 1)
        if sigma > 0.0:
            mean = mean + sigma * torch.randn(
                mean.shape, generator=generator, device=mean.device, dtype=torch.float32
            )
        return mean.to(p.dtype)

    return tree_map(finish, clipped, params), per.detach().mean(dim=-1)


@torch.no_grad()
def dp_train_epoch(
    params: dict, opt_state, xs: torch.Tensor, ys: torch.Tensor, generator: torch.Generator,
    module, tx, clip: float, noise: float, prox_mu: float = 0.0, anchor: Optional[dict] = None,
):
    """One DP-SGD epoch of the gossip Node's learner over ``[nb, bs, ...]``
    batches: :func:`dp_grads` without a node axis, the noise drawn from
    ``generator``, one optimizer step a batch. ``prox_mu > 0`` keeps
    FedProx's pull toward ``anchor`` inside each example's loss. Returns
    ``(params, opt_state, mean loss)``."""
    from p2pfl_tpu_torch.learning.learner import _loss, _prox_term, apply_updates

    def loss_one(p, xi, yi, anchor_):
        loss = _loss(p, module, xi[None], yi[None])[0]
        if prox_mu > 0.0:
            loss = loss + _prox_term(p, anchor_, prox_mu)
        return loss

    losses = []
    for b in range(xs.shape[0]):
        grads, loss = dp_grads(loss_one, params, xs[b], ys[b], clip, noise, generator, anchor=anchor)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = apply_updates(params, updates)
        losses.append(loss)
    return params, opt_state, torch.stack(losses).mean()


class PrivacyAccountant:
    """(ε, δ) tracking for the subsampled Gaussian mechanism.

    ``q`` = batch/shard sampling rate, ``noise`` = noise multiplier σ.
    ``step(n)`` records n mechanism invocations (one per DP-SGD step).
    RDP of one step at integer order α (Abadi et al. 2016 / Mironov 2017),
    composed linearly, converted by ``ε = min_α RDP(α)·T + log(1/δ)/(α−1)``.
    """

    ORDERS = tuple(range(2, 65))

    def __init__(self, noise: float, q: float) -> None:
        if noise <= 0 or not 0 < q <= 1:
            raise ValueError("need noise > 0 and 0 < q <= 1")
        self.noise = noise
        self.q = q
        self.steps = 0
        self._rdp_per_step = [self._rdp_one(a) for a in self.ORDERS]

    def _rdp_one(self, alpha: int) -> float:
        """RDP of ONE subsampled-Gaussian step at integer order ``alpha``."""
        q, sigma = self.q, self.noise
        if q == 1.0:
            return alpha / (2.0 * sigma**2)
        # log Σ_k C(α,k) (1−q)^{α−k} q^k exp(k(k−1)/2σ²), stable in log-space
        log_terms = [
            math.lgamma(alpha + 1)
            - math.lgamma(k + 1)
            - math.lgamma(alpha - k + 1)
            + (alpha - k) * math.log1p(-q)
            + k * math.log(q)
            + (k * (k - 1)) / (2.0 * sigma**2)
            for k in range(alpha + 1)
        ]
        m = max(log_terms)
        return (m + math.log(sum(math.exp(t - m) for t in log_terms))) / (alpha - 1)

    def step(self, n: int = 1) -> None:
        self.steps += n

    def epsilon(self, delta: float = 1e-5) -> float:
        """Smallest ε over the tracked orders for the given δ."""
        if self.steps == 0:
            return 0.0
        return min(
            r * self.steps + math.log(1.0 / delta) / (a - 1)
            for a, r in zip(self.ORDERS, self._rdp_per_step)
        )
