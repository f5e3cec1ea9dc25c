"""One-program federation: N federated nodes on one device
(counterpart of ``p2pfl_tpu/parallel/spmd.py``).

The JAX package runs N nodes as one SPMD program over a device mesh. The
port runs them on one device with the node axis written out as the
leading tensor dimension:

- node-stacked params, optimizer state and data ``[N, ...]``;
- local training is one batched forward/backward a step for all N nodes:
  the model's single-node forward is ``torch.func.vmap``-ed over the node
  axis (its GEMMs become batched GEMMs) and autograd takes the gradient
  of the sum of the nodes' losses, which gives every node the gradient of
  its own loss;
- aggregation (FedAvg or a robust rule) is a reduction over that axis and
  the diffusion a broadcast back;
- election, shuffles and masks are host-side (the JAX package's code,
  copied, so one seed consumes the numpy and Python rng streams
  identically) and enter as index and mask tensors.

Nothing reads a value back to the host inside a round or a fused span:
losses and accuracies stay device tensors until the caller converts them.
The algorithm knobs of the JAX round program are all here: FedProx,
SCAFFOLD (fused-ci and option II), the FedOpt server step, DP-SGD, remat
(``torch.utils.checkpoint``) and the robust aggregators. The gossip
Node's fused round lives here too, as in JAX (:func:`fused_node_round`,
one replayed CUDA graph a node on the card). Every model of the port's
zoo runs here: the MLP's and ViT's GEMMs become batched GEMMs, and the
CNN's and ResNet's convolutions grouped convolutions (``groups = N``)
under the vmap. Checkpoints go through ``learning/checkpoint.py``;
``profile_round`` times a round's phases. Not ported: the device mesh
(ROADMAP Queue A item 5). ``parallel/chunked.py`` streams the nodes
through the device in chunks where their state does not fit.
"""

from __future__ import annotations

import math
import random
import threading
from functools import partial
from typing import Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from p2pfl_tpu_torch import resolve_device
from p2pfl_tpu_torch.learning.dataset import FederatedDataset
from p2pfl_tpu_torch.learning.learner import (
    GradientTransformation, _loss, _prox_term, adam, apply_updates, eval_step, sgd,
    softmax_cross_entropy, train_epoch, train_step,
)
from p2pfl_tpu_torch.learning.privacy import PrivacyAccountant, dp_grads
from p2pfl_tpu_torch.models.base import TorchModel
from p2pfl_tpu_torch.ops import aggregation as ops
from p2pfl_tpu_torch.ops.tree import tree_items, tree_leaves, tree_map, tree_unflatten
from p2pfl_tpu_torch.settings import Settings

_AGGREGATORS = ("fedavg", "median", "trimmed_mean", "krum", "bulyan", "clip")


# ---- the round program ----


def _node_loss(module, prox_mu: float):
    """One node's training loss ``(params, x, y, anchor) -> scalar``: CE
    (+ the FedProx pull toward ``anchor``)."""

    def loss(p, x, y, anchor):
        out = _loss(p, module, x, y)[0]
        if prox_mu > 0.0:
            out = out + _prox_term(p, anchor, prox_mu)
        return out

    return loss


def _value_and_grad(node_loss, params: dict, x, y, anchor=None, remat: bool = False):
    """Every node's loss ``[N]`` and gradient tree ``[N, ...]`` from one
    batched forward (``node_loss`` vmapped over the node axis) and one
    backward of the losses' sum. ``remat`` recomputes the forward in the
    backward instead of keeping its activations."""
    paths = [p for p, _ in tree_items(params)]
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    fn = torch.func.vmap(node_loss, in_dims=(0, 0, 0, 0 if anchor is not None else None))

    def losses(*lv):
        return fn(tree_unflatten(dict(zip(paths, lv))), x, y, anchor)

    with torch.enable_grad():
        # no random op runs in a model's forward, so the recompute needs no
        # saved rng state (whose query a CUDA graph capture refuses)
        per = checkpoint(losses, *leaves, use_reentrant=False, preserve_rng_state=False) \
            if remat else losses(*leaves)
        grads = torch.autograd.grad(per.sum(), leaves)
    return per.detach(), tree_unflatten(dict(zip(paths, grads)))


def _local_epoch(
    params, opt_state, xs, ys, module, tx, remat: bool = False,
    prox_mu: float = 0.0, anchor=None, corr=None,
    dp_clip: float = 0.0, dp_noise: float = 0.0, dp_gen=None,
    accumulate_grads: bool = False,
):
    """Every node's epoch: node-stacked params, ``xs`` ``[N, nb, bs, ...]``
    and ``ys`` ``[N, nb, bs]``; one optimizer step a batch (the JAX
    package's per-node scan, the nodes batched).

    ``prox_mu``/``anchor``: FedProx's pull toward the round's global
    model. ``corr``: SCAFFOLD's ``c − c_i`` added to every step's
    gradient. ``dp_clip > 0``: DP-SGD, per-example clipped gradients plus
    Gaussian noise (multiplier ``dp_noise``) from ``dp_gen``.
    ``accumulate_grads``: also return the fp32 sum of the raw step
    gradients (SCAFFOLD's fused-ci variate). Returns ``(params, opt_state,
    mean loss [N][, gsum])``.
    """
    node_loss = _node_loss(module, prox_mu)

    def loss_one(p, xi, yi, anchor_):
        return node_loss(p, xi[None], yi[None], anchor_)

    gsum = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params) \
        if accumulate_grads else None
    losses = []
    for s in range(xs.shape[1]):
        x, y = xs[:, s], ys[:, s]
        if dp_clip > 0.0:
            grads, loss = dp_grads(
                loss_one, params, x, y, dp_clip, dp_noise, dp_gen, remat=remat, anchor=anchor,
                node_axis=True,
            )
        else:
            loss, grads = _value_and_grad(node_loss, params, x, y, anchor, remat)
        if accumulate_grads:
            gsum = tree_map(lambda s_, g: s_ + g.float(), gsum, grads)
        if corr is not None:
            grads = tree_map(lambda g, c: g + c.to(g.dtype), grads, corr)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = apply_updates(params, updates)
        losses.append(loss)
    mean = torch.stack(losses).mean(dim=0)
    if accumulate_grads:
        return params, opt_state, mean, gsum
    return params, opt_state, mean


def _aggregate(p_used, mask, weights, sel_idx, agg: str, trim: int, center=None, clip_tau: float = 1.0):
    """Combine node-stacked params [N, ...] into one model (fp32 accumulate).

    ``sel_idx`` is the [K] tensor of train-set ∩ active node indices. The
    robust aggregators see only those K rows: the other slots hold stale
    copies of the previous aggregate, which would dominate the median and
    win Krum's score (host Node mode likewise aggregates train-set models
    only). ``center`` is the clip aggregator's starting point.
    """
    if agg == "fedavg":
        return ops.fedavg(p_used, mask * weights)
    k = sel_idx.shape[0]
    p_sel = tree_map(lambda x: x.index_select(0, sel_idx), p_used)
    if agg == "median":
        return ops.fedmedian(p_sel)
    if agg == "trimmed_mean":
        # clamp like the host-side TrimmedMean class: 2*trim must leave >=1 row
        return ops.trimmed_mean(p_sel, min(trim, (k - 1) // 2))
    if agg == "krum":
        return ops.krum(p_sel, n_byzantine=trim, multi=1)
    if agg == "bulyan":
        return ops.bulyan(p_sel, n_byzantine=trim)
    if agg == "clip":
        if center is None:
            raise ValueError("the clip aggregator needs the round's center")
        return ops.centered_clip(p_sel, center, clip_tau)
    raise ValueError(f"unknown aggregator {agg}")


def _round_core(
    stacked_params, opt_states, x_all, y_all,
    perm,  # [N, epochs, nb, bs] shuffle indices (host-generated)
    mask,  # [N] 1.0 = in train set
    weights,  # [N] sample counts
    sel_idx,  # [K] indices of mask == 1 rows (robust aggregation)
    *,
    module,
    tx: GradientTransformation,
    agg: str = "fedavg",
    trim: int = 0,
    clip_tau: float = 1.0,
    keep_opt_state: bool = False,
    remat: bool = False,
    prox_mu: float = 0.0,
    scaffold: bool = False,
    scaffold_fused_ci: bool = True,
    local_lr: float = 1e-3,
    c_global=None,  # SCAFFOLD server control variate
    c_local=None,  # SCAFFOLD per-node control variates [N, ...]
    server_opt: str = "",  # FedOpt: "adam" | "yogi" | "adagrad" ("" = plain)
    server_lr: float = 0.1,
    opt_m=None,  # FedOpt server moments and 1-based step (fp32 tensor)
    opt_v=None,
    opt_t=None,
    dp_clip: float = 0.0,
    dp_noise: float = 0.0,
    dp_gen: Optional[torch.Generator] = None,
):
    """One federated round (train → aggregate → diffuse). Returns
    ``(out_params, out_opt, mean_loss, scaffold_state, fedopt_state,
    agg_params)``; the state tuples are ``()`` when the feature is off."""
    n = mask.shape[0]
    fused_ci = scaffold and scaffold_fused_ci
    # SCAFFOLD correction c − c_i, once for every node and step
    corr = tree_map(
        lambda c, cl, p: (c[None] - cl).to(p.dtype), c_global, c_local, stacked_params
    ) if scaffold else None
    # the round-start params, kept only where something reads them later
    anchor = stacked_params if (prox_mu > 0.0 or (scaffold and not fused_ci)) else None
    nodes = torch.arange(n, device=perm.device)[:, None, None]
    p, o = stacked_params, opt_states
    gsum = tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32, device=x.device), p) \
        if fused_ci else None
    epoch_losses = []
    for e in range(perm.shape[1]):
        idx = perm[:, e].long()  # [N, nb, bs]
        out = _local_epoch(
            p, o, x_all[nodes, idx], y_all[nodes, idx], module, tx, remat,
            prox_mu=prox_mu, anchor=anchor, corr=corr,
            dp_clip=dp_clip, dp_noise=dp_noise, dp_gen=dp_gen, accumulate_grads=fused_ci,
        )
        if fused_ci:
            p, o, loss, g_ep = out
            gsum = tree_map(torch.add, gsum, g_ep)
        else:
            p, o, loss = out
        epoch_losses.append(loss)
    losses = torch.stack(epoch_losses).mean(dim=0)  # [N]
    k_steps = perm.shape[1] * perm.shape[2]
    if fused_ci:
        # under plain SGD option II's c_i⁺ reduces exactly to the mean
        # step gradient: no round-start params, no cancellation
        ci_new = tree_map(lambda g: g / k_steps, gsum)
    elif scaffold:
        # c_i⁺ = c_i − c + (x_global − y_i)/(K·η)  (SCAFFOLD option II)
        ci_new = tree_map(
            lambda cl, c, a, y_: cl - c + (a.float() - y_.float()) / (k_steps * local_lr),
            c_local, c_global, anchor, p,
        )

    def sel(new, old):
        # non-train-set nodes contribute their previous params
        m = mask.reshape((n,) + (1,) * (new.dim() - 1)).to(new.dtype)
        return new * m + old * (1 - m)

    p_used = tree_map(sel, p, stacked_params)
    # clip center: the coordinate-wise median of the elected rows of the
    # round's incoming params (every slot holds the shared model after a
    # diffusion; a tampered slot cannot choose the center)
    center = tree_map(lambda x: ops.median0(x.index_select(0, sel_idx)), stacked_params) \
        if agg == "clip" else None
    agg_params = _aggregate(p_used, mask, weights, sel_idx, agg, trim, center=center, clip_tau=clip_tau)

    fedopt_state = ()
    if server_opt:
        # pseudo-gradient prev_global − aggregate; slot 0's incoming params
        # are the previous global (diffusion left every slot identical)
        prev_global = tree_map(lambda x: x[0], stacked_params)
        agg_params, opt_m, opt_v = ops.fedopt_update(
            prev_global, agg_params, opt_m, opt_v, opt_t, opt=server_opt, lr=server_lr
        )
        fedopt_state = (opt_m, opt_v)

    # diffusion: every node receives the aggregate
    out_params = tree_map(lambda a: a[None].expand(n, *a.shape).clone(), agg_params)
    # keep_opt_state carries every node's own trained moments across rounds
    out_opt = o if keep_opt_state else tx.init(out_params)
    train = mask.bool()
    mean_loss = torch.where(train, losses, torch.zeros_like(losses)).sum() / train.sum()

    scaffold_state = ()
    if scaffold:
        # only train-set nodes commit their new variates; the server
        # variate moves by |S|/N times the mean train-set delta
        c_local_out = tree_map(sel, ci_new, c_local)
        n_train = torch.clamp(mask.sum(), min=1.0)

        def upd(c, cn, co):
            m = mask.reshape((n,) + (1,) * (cn.dim() - 1))
            return c + (n_train / n) * (((cn - co) * m).sum(dim=0) / n_train)

        scaffold_state = (tree_map(upd, c_global, ci_new, c_local), c_local_out)
    return out_params, out_opt, mean_loss, scaffold_state, fedopt_state, agg_params


def _agg_acc(module, agg_params, x_test, y_test) -> torch.Tensor:
    """Mean over nodes of the aggregated model's accuracy on each node's
    test shard (``argmax`` takes the first of tied logits, as JAX's)."""
    n, t = x_test.shape[:2]
    logits = module(agg_params, x_test.reshape(n * t, *x_test.shape[2:]))
    return (logits.argmax(dim=-1).reshape(n, t) == y_test.long()).float().mean(dim=1).mean()


@torch.no_grad()
def spmd_round(
    stacked_params, opt_states, x_all, y_all, perm, mask, weights, sel_idx,
    *, c_global=None, c_local=None, opt_m=None, opt_v=None,
    x_test=None, y_test=None, **kw,
):
    """One federated round for all N nodes. Returns (params', opt', mean
    loss[, c_global', c_local'][, opt_m', opt_v'][, test acc]): with test
    data, the aggregated model's accuracy, computed before returning."""
    out_params, out_opt, mean_loss, scaffold_state, fedopt_state, agg_params = _round_core(
        stacked_params, opt_states, x_all, y_all, perm, mask, weights, sel_idx,
        c_global=c_global, c_local=c_local, opt_m=opt_m, opt_v=opt_v, **kw,
    )
    if x_test is None:
        return (out_params, out_opt, mean_loss, *scaffold_state, *fedopt_state)
    acc = _agg_acc(kw["module"], agg_params, x_test, y_test)
    return (out_params, out_opt, mean_loss, *scaffold_state, *fedopt_state, acc)


@torch.no_grad()
def spmd_rounds_fused(
    stacked_params, opt_states, x_all, y_all, perms, mask, weights, sel_idx,
    *, c_global=None, c_local=None, opt_m=None, opt_v=None, opt_t=None,
    x_test=None, y_test=None, **kw,
):
    """R rounds in one call (``perms`` [R, N, epochs, nb, bs]) with one
    fixed train set (the reference votes in round 0 only). Nothing is read
    back between rounds: with test data each round's aggregated model is
    evaluated on the device, an accuracy curve [R]. ``opt_t`` is the
    FedOpt step the span starts from (each round adds one). Returns
    (params', opt', losses [R][, c_global', c_local'][, opt_m',
    opt_v'][, accs [R]])."""
    scaffold = kw.get("scaffold", False)
    server_opt = kw.get("server_opt", "")
    t = torch.zeros((), dtype=torch.float32, device=mask.device) if opt_t is None else opt_t
    p, o, cg, cl, m_, v_ = stacked_params, opt_states, c_global, c_local, opt_m, opt_v
    losses, accs = [], []
    for perm in perms:
        t = t + 1.0
        p, o, loss, sstate, fstate, agg_params = _round_core(
            p, o, x_all, y_all, perm, mask, weights, sel_idx,
            c_global=cg, c_local=cl, opt_m=m_, opt_v=v_, opt_t=t, **kw,
        )
        cg, cl = sstate if scaffold else (cg, cl)
        m_, v_ = fstate if server_opt else (m_, v_)
        losses.append(loss)
        if x_test is not None:
            accs.append(_agg_acc(kw["module"], agg_params, x_test, y_test))
    scaffold_state = (cg, cl) if scaffold else ()
    fedopt_state = (m_, v_) if server_opt else ()
    if x_test is None:
        return (p, o, torch.stack(losses), *scaffold_state, *fedopt_state)
    return (p, o, torch.stack(losses), *scaffold_state, *fedopt_state, torch.stack(accs))


@torch.no_grad()
def spmd_eval(stacked_params, x_test, y_test, *, module):
    """Per-node eval over node-stacked test shards: ([N] loss, [N] acc)."""
    logits = torch.func.vmap(module)(stacked_params, x_test)
    loss = softmax_cross_entropy(logits, y_test).mean(dim=-1)
    acc = (logits.argmax(dim=-1) == y_test.long()).float().mean(dim=-1)
    return loss, acc


class _CapturedSpan:
    """One fused span of the round program captured as a CUDA graph: the
    torch counterpart of XLA's one program a chunk.

    Eager, a span of the bench's configuration launches about 1,100
    kernels a round from Python, and the card waits on the host. Captured
    once, a replay launches them all from one call. The graph runs the
    same code on the same kernels, so a replay computes what the eager
    span computes. It reads fixed buffers: before a replay the federation's
    carried state (params, optimizer state) and the span's shuffles, mask
    and selected rows are copied in; the graph writes the new state back
    into the same buffers, which then are the federation's state. The
    losses and accuracies are cloned out, so they outlive the next replay.
    """

    def __init__(self, fed: "SpmdFederation", perms, mask, sel_idx, eval_: bool) -> None:
        self.state = torch.utils._pytree.tree_map(torch.clone, (fed.params, fed.opt_state))
        self.perms, self.mask, self.sel_idx = perms.clone(), mask.clone(), sel_idx.clone()
        kw = fed._round_kwargs()
        test = (fed.x_test, fed.y_test) if eval_ else (None, None)

        def body():
            p, o, *outs = spmd_rounds_fused(
                *self.state, fed.x_all, fed.y_all, self.perms, self.mask, fed._samples, self.sel_idx,
                x_test=test[0], y_test=test[1], **kw, **fed._algo_kwargs(0),
            )
            _copy_tree((p, o), self.state)
            return outs

        # warm the kernels up on a side stream, as capture requires
        side = torch.cuda.Stream(fed.device)
        side.wait_stream(torch.cuda.current_stream(fed.device))
        with torch.cuda.stream(side):
            body()
        torch.cuda.current_stream(fed.device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.outs = body()

    def run(self, fed: "SpmdFederation", perms, mask, sel_idx) -> tuple:
        """Replay on ``fed``'s state and inputs; returns (params, opt,
        *outputs) as ``spmd_rounds_fused`` does."""
        _copy_tree((fed.params, fed.opt_state), self.state)
        self.perms.copy_(perms)
        self.mask.copy_(mask)
        self.sel_idx.copy_(sel_idx)
        self.graph.replay()
        return (*self.state, *(t.clone() for t in self.outs))


# ---- the gossip Node's fused round ----


@torch.no_grad()
def fused_node_round(
    params, opt_state, xs, ys, weight, x_test=None, y_test=None, *,
    module, tx, prox_mu: float = 0.0, with_acc: bool = True, agg_dtype: str = "float32",
    epoch=train_epoch,
) -> dict:
    """One overlay Node's whole round compute in one call: eval of the
    incoming ``params`` (when test data is given), every epoch of ``xs``
    ``[E, nb, bs, ...]`` / ``ys`` through the staged path's own step loop
    (``learning/learner.py::train_epoch``, so fused and staged agree bit
    for bit), and with ``with_acc`` the own fold ``psum = weight ·
    params`` and ``wsum = weight`` in ``agg_dtype``. ``params`` is read,
    never written: the zero-copy weights paths may hand the same tensors
    to other nodes. ``opt_state`` is the round-carried state; ``weight``
    a 0-d fp32 tensor of the node's sample count. Returns a dict of
    device tensors: ``params``, ``opt_state``, ``train_losses`` [E] (each
    epoch's mean loss), ``eval_loss``/``eval_acc``, ``psum``/``wsum``.
    ``epoch`` runs an epoch with :func:`train_epoch`'s contract: on the
    card a :meth:`CapturedTrainStep.epoch`."""
    out = {}
    if x_test is not None:
        out["eval_loss"], out["eval_acc"] = eval_step(params, x_test, y_test, module)
    anchor = params if prox_mu > 0.0 else None
    losses = []
    for e in range(xs.shape[0]):
        params, opt_state, loss = epoch(
            params, opt_state, xs[e], ys[e], module, tx, prox_mu=prox_mu, anchor=anchor
        )
        losses.append(loss)
    out["params"], out["opt_state"] = params, opt_state
    out["train_losses"] = torch.stack(losses)
    if with_acc:
        acc = getattr(torch, agg_dtype)
        w = weight.to(acc)
        out["psum"] = tree_map(lambda p: p.to(acc) * w, params)
        out["wsum"] = w
    return out


def tree_has_deleted(tree) -> bool:
    """True if a tensor leaf of ``tree`` lost its storage (resized to
    zero bytes while it holds elements): the port's form of a buffer
    consumed by a failed call."""
    for leaf in torch.utils._pytree.tree_leaves(tree):
        if isinstance(leaf, torch.Tensor) and leaf.numel() > 0 and leaf.untyped_storage().nbytes() == 0:
            return True
    return False


#: one capture at a time in the process: the Nodes' threads share a card
_CAPTURE_LOCK = threading.Lock()


class CapturedTrainStep:
    """One optimizer step of a Node's fused round (``train_step``)
    captured as a CUDA graph for one batch shape, replayed for every
    batch of every round with that shape.

    A step, not the round: capturing costs host time for every launch it
    records, several times an eager launch's, so a round's capture would
    cost more than a short experiment's replays save, while one step's
    pays back inside its own round. Construction warms the step up on this thread and a
    side stream (a cuBLAS handle and workspace, the allocator), then
    captures it there with ``capture_error_mode="thread_local"``: the
    other Nodes' threads keep launching on the card during a capture,
    which the default global mode would fail. The graph reads its
    params, opt state, batch and FedProx anchor from its own buffers and
    writes the stepped params and opt state back into them. Replays run
    the captured kernels, so an epoch of replays computes what
    :func:`train_epoch` computes. A failed capture raises.
    """

    def __init__(self, params, opt_state, x, y, *, module, tx, prox_mu: float = 0.0) -> None:
        device = x.device
        clone = partial(torch.utils._pytree.tree_map, torch.clone)
        self.state = clone((params, opt_state))
        self.batch = (x.clone(), y.clone())
        self.anchor = clone(params) if prox_mu > 0.0 else None

        def body():
            p, o, loss = train_step(*self.state, *self.batch, module, tx, prox_mu, self.anchor)
            _copy_tree((p, o), self.state)
            return loss

        self.graph = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            body()
        with _CAPTURE_LOCK, torch.cuda.stream(side):
            self.graph.capture_begin(capture_error_mode="thread_local")
            try:
                self.loss = body()
            finally:
                self.graph.capture_end()
        torch.cuda.current_stream(device).wait_stream(side)

    def epoch(self, params, opt_state, xs, ys, module=None, tx=None, prox_mu: float = 0.0, anchor=None):
        """:func:`train_epoch` over ``xs``/``ys`` ``[nb, bs, ...]``, one
        replay a batch (the module, optimizer and ``prox_mu`` are the
        captured ones). Returns new tensors."""
        _copy_tree((params, opt_state), self.state)
        if self.anchor is not None:
            _copy_tree(params if anchor is None else anchor, self.anchor)
        losses = torch.empty(xs.shape[0], dtype=self.loss.dtype, device=self.loss.device)
        for b in range(xs.shape[0]):
            self.batch[0].copy_(xs[b])
            self.batch[1].copy_(ys[b])
            self.graph.replay()
            losses[b].copy_(self.loss)
        params, opt_state = torch.utils._pytree.tree_map(torch.clone, self.state)
        return params, opt_state, losses.mean()


def _copy_tree(src, dst) -> None:
    """Copy every tensor leaf of ``src`` into ``dst`` (same structure);
    a leaf that already is its destination is skipped."""
    flat_src, spec_src = torch.utils._pytree.tree_flatten(src)
    flat_dst, spec_dst = torch.utils._pytree.tree_flatten(dst)
    if spec_src != spec_dst:
        raise ValueError("carried state changed structure")
    for a, b in zip(flat_src, flat_dst):
        if a is not b:
            b.copy_(a)


def _model_step_flops(module, params: dict, x_all, y_all, batch_size: int) -> tuple[int, int]:
    """``(forward, forward + backward)`` FLOPs of one node's training loss
    on one batch, as ``torch.utils.flop_counter.FlopCounterMode`` counts
    them (matmuls and convolutions, each backward product autograd runs),
    on meta tensors of the shapes: nothing is computed or allocated. For
    the MLP this is ``6·in·out`` a sample a layer, less ``2·in·out`` for
    the first (its input is data)."""
    from torch.utils.flop_counter import FlopCounterMode

    meta = torch.device("meta")
    items = [(k, torch.empty(v.shape, dtype=v.dtype, device=meta).requires_grad_(True)) for k, v in tree_items(params)]
    x = torch.empty((batch_size, *x_all.shape[2:]), dtype=x_all.dtype, device=meta)
    y = torch.zeros((batch_size, *y_all.shape[2:]), dtype=y_all.dtype, device=meta)
    with torch.enable_grad():
        with FlopCounterMode(display=False) as fwd:
            loss = _loss(tree_unflatten(dict(items)), module, x, y)[0]
        with FlopCounterMode(display=False) as bwd:
            torch.autograd.grad(loss, [v for _, v in items])
    forward = fwd.get_total_flops()
    return forward, forward + bwd.get_total_flops()


# ---- the host side: the federation ----


def stage_node_shards(datasets, batch_size: int) -> dict:
    """Host-side shard staging shared by every node-stacked driver: train
    shards padded to the common max by wrap-around, test shards clipped to
    the common min, per-round batch count from the smallest shard."""
    sizes = [d.num_samples for d in datasets]
    tr_min, tr_max = min(sizes), max(sizes)
    te_min = min(len(d.y_test) for d in datasets)
    if tr_min < batch_size:
        raise ValueError(f"smallest shard ({tr_min}) < batch size ({batch_size})")

    def wrap(a: np.ndarray, target: int) -> np.ndarray:
        if len(a) == target:
            return a
        reps = -(-target // len(a))
        return np.concatenate([a] * reps, axis=0)[:target]

    return {
        "x": [wrap(d.x_train, tr_max) for d in datasets],
        "y": [wrap(d.y_train, tr_max) for d in datasets],
        "x_test": [d.x_test[:te_min] for d in datasets],
        "y_test": [d.y_test[:te_min] for d in datasets],
        "sizes": sizes,
        "nb": tr_min // batch_size,
    }


def draw_node_perms(
    rng: np.random.Generator, sizes: list[int], nb: int, batch_size: int, epochs: int
) -> np.ndarray:
    """Per-node per-epoch shuffle indices ``[N, epochs, nb, bs]`` (int32):
    node-major, then epoch-major, one ``rng.permutation`` over each node's
    own sample range per draw."""
    take = nb * batch_size  # always <= min shard size
    return np.stack(
        [
            np.stack(
                [
                    rng.permutation(sizes[i])[:take].reshape(nb, batch_size)
                    for _ in range(epochs)
                ]
            )
            for i in range(len(sizes))
        ]
    ).astype(np.int32)


def elect_train_set_mask(n: int, py_rng) -> np.ndarray:
    """Round-0 election: every node casts weighted random votes
    (reference ``vote_train_set_stage.py:78-81``); top ``TRAIN_SET_SIZE`` win."""
    names = list(range(n))
    tally: dict[int, int] = {}
    k = min(Settings.TRAIN_SET_SIZE, n)
    for _voter in names:
        picks = py_rng.sample(names, k)
        for i, cand in enumerate(picks):
            tally[cand] = tally.get(cand, 0) + math.floor(py_rng.randint(0, 1000) / (i + 1))
    ranked = sorted(tally.items(), key=lambda kv: (kv[1], kv[0]), reverse=True)
    mask = np.zeros(n, dtype=np.float32)
    for cand, _ in ranked[:k]:
        mask[cand] = 1.0
    return mask


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP Queue A item {item})")


class SpmdFederation:
    """N federated nodes stacked on one device's leading tensor axis.

    The drop-in high-throughput alternative to running N ``Node`` objects:
    same round semantics, same aggregators and algorithms as the JAX
    class, none of the per-message overhead. ``device=None`` is the card.
    """

    def __init__(
        self,
        model: TorchModel,
        datasets: list[FederatedDataset],
        mesh=None,
        batch_size: int = 128,
        learning_rate: float = 1e-3,
        aggregator: str = "fedavg",
        trim: int = 0,
        clip_tau: float = 1.0,
        vote: bool = True,
        keep_opt_state: bool = False,
        remat: bool = False,
        participation: float = 1.0,
        seed: int = 0,
        prox_mu: float = 0.0,
        scaffold: bool = False,
        optimizer: str = "adam",
        server_opt: str = "",
        server_lr: float = 0.1,
        dp_clip: float = 0.0,
        dp_noise: float = 0.0,
        tx: Optional[GradientTransformation] = None,
        device=None,
    ) -> None:
        self.device = resolve_device(device)
        if mesh is not None:
            raise _not_ported("a device mesh for SpmdFederation", "5")
        self.model = model
        self.module = model.module
        self.n = len(datasets)
        if self.n < 1:
            raise ValueError("need at least one dataset shard")
        if Settings.SECURE_AGGREGATION:
            # secagg hides updates from the peers that relay them; one
            # program on one device is a single trust domain
            raise ValueError(
                "SECURE_AGGREGATION=True has no effect inside SpmdFederation: "
                "the SPMD mesh is one trust domain (one program, one address "
                "space). Use gossip Node mode for secure aggregation, or set "
                "Settings.SECURE_AGGREGATION=False for mesh runs."
            )
        self.datasets = datasets
        self.batch_size = batch_size
        if scaffold and (optimizer != "sgd" or tx is not None):
            # the (x − y_i)/(K·η) variate update assumes η-scaled SGD steps
            raise ValueError("scaffold=True requires optimizer='sgd'")
        self.optimizer = optimizer
        if tx is None:
            tx = sgd(learning_rate) if optimizer == "sgd" else adam(learning_rate)
        # an explicit transform, e.g. Adam over a warmup-cosine schedule:
        # with keep_opt_state=True its step count survives round boundaries
        # (config 2's federated LR schedule); a transform that is not
        # elementwise steps the node-stacked tree in its per-node form
        self.tx = tx.node_stacked or tx
        self.learning_rate = learning_rate
        self.prox_mu = float(prox_mu)
        self.scaffold = scaffold
        if server_opt and server_opt not in ops.FEDOPT:
            raise ValueError(f"unknown server_opt {server_opt!r}")
        self.server_opt = server_opt
        self.server_lr = server_lr
        self.dp_clip = float(dp_clip)
        self.dp_noise = float(dp_noise)
        if self.dp_noise > 0.0 and self.dp_clip <= 0.0:
            raise ValueError("dp_noise > 0 requires dp_clip > 0")
        if aggregator not in _AGGREGATORS:
            raise ValueError(f"unknown aggregator {aggregator!r}")
        self.aggregator = aggregator
        self.trim = trim
        if aggregator == "clip" and clip_tau <= 0:
            # tau <= 0 zeroes every clip factor: training would freeze
            raise ValueError(f"clip_tau must be > 0 (got {clip_tau})")
        self.clip_tau = float(clip_tau)
        self.keep_opt_state = keep_opt_state
        self.remat = remat
        if not 0.0 < participation <= 1.0:
            raise ValueError("participation must be in (0, 1]")
        self.participation = participation
        self._rng = np.random.default_rng(seed)
        self._py_rng = random.Random(seed)

        self._stage_data()
        # captured fused spans by (perms shape, eval, selected rows)
        self._spans: dict = {}
        # per-node (ε, δ): every node runs the same mechanism on its shard
        self.accountant = None
        if self.dp_clip > 0.0 and self.dp_noise > 0.0:
            q = min(1.0, self.batch_size / min(self._sizes))
            self.accountant = PrivacyAccountant(self.dp_noise, q)
        # node-stacked state: every node starts from the same params
        self._stage_state()

        # election state (round-0 vote, reused thereafter — reference quirk)
        self.train_mask = np.ones(self.n, dtype=np.float32)
        self._vote = vote
        # node failure = masking the slot out of training and aggregation
        self.active_mask = np.ones(self.n, dtype=np.float32)
        self.round = 0
        self.history: list[dict] = []
        self.last_profile: Optional[dict] = None

    def reset(self, seed: int = 0) -> None:
        """Back to round 0 with fresh state, keeping data and device."""
        self._rng = np.random.default_rng(seed)
        self._py_rng = random.Random(seed)
        self.train_mask = np.ones(self.n, dtype=np.float32)
        self.active_mask = np.ones(self.n, dtype=np.float32)
        self.round = 0
        self.history = []
        self._stage_state()

    def _stage_state(self) -> None:
        n, dev = self.n, self.device

        def zeros(x):
            return torch.zeros(x.shape, dtype=torch.float32, device=dev)

        self.params = tree_map(lambda x: x.to(dev)[None].expand(n, *x.shape).clone(), self.model.params)
        self.opt_state = self.tx.init(self.params)
        self._server_t = 0  # FedOpt server step count (stays 0 without server_opt)
        if self.scaffold:
            # control variates start at zero (Karimireddy et al. 2020 §3)
            self.c_global = tree_map(zeros, self.model.params)
            self.c_local = tree_map(zeros, self.params)
        if self.server_opt:
            self.opt_m = tree_map(zeros, self.model.params)
            self.opt_v = tree_map(zeros, self.model.params)

    def _stage_data(self) -> None:
        # shards padded to a common length stack into [N, S, ...]; each
        # node's shuffle still draws from its own sample range
        staged = stage_node_shards(self.datasets, self.batch_size)

        def put(arrays):
            return torch.from_numpy(np.stack(arrays)).to(self.device)

        self.x_all = put(staged["x"])
        self.y_all = put(staged["y"])
        self.x_test = put(staged["x_test"])
        self.y_test = put(staged["y_test"])
        self._samples = torch.tensor(
            [float(s) for s in staged["sizes"]], dtype=torch.float32, device=self.device
        )
        self._sizes = staged["sizes"]
        self._nb = staged["nb"]

    # ---- election (host control plane — reference vote semantics) ----

    def elect_train_set(self) -> np.ndarray:
        return elect_train_set_mask(self.n, self._py_rng)

    # ---- round inputs ----

    def _make_perm_np(self, epochs: int) -> np.ndarray:
        return draw_node_perms(self._rng, self._sizes, self._nb, self.batch_size, epochs)

    def _make_perm(self, epochs: int) -> torch.Tensor:
        return torch.from_numpy(self._make_perm_np(epochs)).to(self.device)

    def _effective_mask(self) -> np.ndarray:
        """Train-set ∩ active nodes, optionally client-sampled per round."""
        effective = self.train_mask * self.active_mask
        if self.participation < 1.0:
            eligible = np.flatnonzero(effective)
            k = max(1, round(self.participation * len(eligible)))
            chosen = self._rng.choice(eligible, size=k, replace=False)
            effective = np.zeros_like(effective)
            effective[chosen] = 1.0
        if effective.sum() == 0:
            raise RuntimeError("no active train-set nodes left")
        return effective

    def _mask_inputs(self, effective: np.ndarray) -> tuple[torch.Tensor, torch.Tensor]:
        """The mask [N] and the selected rows' indices [K] on the device."""
        mask = torch.from_numpy(effective).to(self.device)
        return mask, torch.from_numpy(np.flatnonzero(effective)).to(self.device)

    def drop_node(self, i: int) -> None:
        """Mark a logical node failed: it stops training and contributing
        (the reference's heartbeat-eviction outcome)."""
        self.active_mask[i] = 0.0

    def restore_node(self, i: int) -> None:
        self.active_mask[i] = 1.0

    def _round_kwargs(self) -> dict:
        return dict(
            module=self.module, tx=self.tx, agg=self.aggregator, trim=self.trim,
            clip_tau=self.clip_tau, keep_opt_state=self.keep_opt_state, remat=self.remat,
        )

    def _algo_kwargs(self, opt_t: float) -> dict:
        """The ``_round_core`` algorithm knobs, one source for run_round
        and run_fused. ``opt_t`` is the FedOpt server step: 1-based for a
        single round, the 0-based starting count for a fused span (each
        round adds one first)."""
        return dict(
            prox_mu=self.prox_mu,
            scaffold=self.scaffold,
            # read per call, so flipping the Setting reaches the next round
            scaffold_fused_ci=bool(Settings.SCAFFOLD_FUSED_CI),
            local_lr=self.learning_rate,
            server_opt=self.server_opt,
            server_lr=self.server_lr,
            c_global=self.c_global if self.scaffold else None,
            c_local=self.c_local if self.scaffold else None,
            opt_m=self.opt_m if self.server_opt else None,
            opt_v=self.opt_v if self.server_opt else None,
            opt_t=torch.tensor(float(opt_t), device=self.device) if self.server_opt else None,
            dp_clip=self.dp_clip,
            dp_noise=self.dp_noise,
        )

    def _dp_round_keys(self) -> Optional[torch.Generator]:
        """The DP noise generator of a round or fused span, or None
        without DP. It takes the one draw of the numpy stream that JAX's
        root key takes, so the shuffles after it stay in step with JAX's;
        the noise itself cannot match JAX's threefry bits."""
        if self.dp_clip <= 0.0:
            return None
        seed = int(self._rng.integers(2**31))
        return torch.Generator(device=self.device).manual_seed(seed)

    def _fused_inputs(self, rounds: int, epochs: int):
        """Guards + device inputs of a fused span: ``(perms [R, N, epochs,
        nb, bs], mask, sel_idx)``. A span needs one fixed mask."""
        if self._vote and self.round == 0:
            self.train_mask = self.elect_train_set()
        if (self._vote and Settings.VOTE_EVERY_ROUND) or self.participation < 1.0:
            raise ValueError(
                "run_fused needs a fixed mask: per-round voting/client "
                "sampling re-elects between rounds — use run_round"
            )
        perms = torch.from_numpy(
            np.stack([self._make_perm_np(epochs) for _ in range(rounds)])
        ).to(self.device)
        return (perms, *self._mask_inputs(self._effective_mask()))

    def _capturable(self) -> bool:
        """A fused span may run as a captured CUDA graph: on the card, with
        a capturable transform (the port's own: state all tensors,
        schedules read the step count on the device), and none of the knobs
        that carry more state or draw random numbers in the span. ``remat``
        captures: the non-reentrant checkpoint's recompute is recorded with
        the backward."""
        return (
            self.device.type == "cuda" and self.tx.capturable
            and not (self.scaffold or self.server_opt or self.dp_clip > 0.0)
        )

    def _take_state(self, result: tuple) -> int:
        """Store the carried state a round program returned after (params,
        opt, loss); the index of the next output."""
        self.params, self.opt_state = result[:2]
        i = 3
        if self.scaffold:
            self.c_global, self.c_local = result[i:i + 2]
            i += 2
        if self.server_opt:
            self.opt_m, self.opt_v = result[i:i + 2]
            i += 2
        return i

    # ---- rounds ----

    def run_round(self, epochs: int = 1, eval: bool = False, profile: bool = False) -> dict:  # noqa: A002
        if self._vote and (self.round == 0 or Settings.VOTE_EVERY_ROUND):
            self.train_mask = self.elect_train_set()
        if profile:
            # the phases of the round about to run, kept on self.last_profile
            self.profile_round(epochs)
        perm = self._make_perm(epochs)
        mask, sel_idx = self._mask_inputs(self._effective_mask())
        result = spmd_round(
            self.params, self.opt_state, self.x_all, self.y_all, perm, mask, self._samples, sel_idx,
            x_test=self.x_test if eval else None, y_test=self.y_test if eval else None,
            dp_gen=self._dp_round_keys(), **self._round_kwargs(),
            **self._algo_kwargs(self._server_t + 1 if self.server_opt else 0),
        )
        self._take_state(result)
        if self.server_opt:
            self._server_t += 1
        if self.accountant is not None:
            self.accountant.step(epochs * self._nb)
        self.round += 1
        # the loss stays a device scalar: no host sync between rounds
        entry = {"round": self.round, "train_loss": result[2]}
        if eval:
            entry["test_acc"] = result[-1]
        self.history.append(entry)
        return entry

    def profile_round(self, epochs: int = 1, iters: int = 3) -> dict:
        """Wall-clock seconds of a round's phases, changing no state.

        Times the round programs on the federation's real inputs, each the
        median of ``iters`` calls ended by a device synchronize:

        - ``train_s``: the plain round (SCAFFOLD and FedOpt stripped, the
          same optimizer, mask and shuffle shapes): local epochs,
          aggregation and diffusion;
        - ``total_s``: the round as configured;
        - ``aggregate_s``: the masked reduce and the diffusion alone;
        - ``correction_s``: ``total − train``, what SCAFFOLD's correction
          and the variate updates (or FedOpt's server step) add.

        Each timed call gets copies of the carried state, made before its
        timer starts. The numpy rng is restored on every exit, a failed
        call's included, so the rounds after draw what they would have
        drawn. Sets ``self.last_profile`` and returns it."""
        rng_state = self._rng.bit_generator.state
        try:
            profile = self._profile_round_body(epochs, iters)
        finally:
            self._rng.bit_generator.state = rng_state
        self.last_profile = profile
        return profile

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _median_s(self, call, stage, iters: int) -> float:
        """Median seconds of ``call(*stage())`` over ``iters`` calls after a
        warm one, each staged before its timer starts."""
        import time

        call(*stage())
        self._sync()
        ts = []
        for _ in range(iters):
            args = stage()
            self._sync()
            t0 = time.perf_counter()
            call(*args)
            self._sync()
            ts.append(time.perf_counter() - t0)
        return sorted(ts)[len(ts) // 2]

    def _profile_round_body(self, epochs: int, iters: int) -> dict:
        perm = self._make_perm(epochs)
        mask, sel_idx = self._mask_inputs(self._effective_mask())
        clone = partial(torch.utils._pytree.tree_map, torch.clone)

        def timed(algo_kw: dict) -> float:
            def stage():
                carried = {k: clone(v) for k, v in algo_kw.items()
                           if k in ("c_global", "c_local", "opt_m", "opt_v") and v is not None}
                return clone(self.params), clone(self.opt_state), {**algo_kw, **carried}

            def call(p, o, kw):
                return spmd_round(
                    p, o, self.x_all, self.y_all, perm, mask, self._samples, sel_idx,
                    dp_gen=self._dp_round_keys(), **self._round_kwargs(), **kw,
                )

            return self._median_s(call, stage, iters)

        full_kw = self._algo_kwargs(self._server_t + 1 if self.server_opt else 0)
        plain_kw = {
            **full_kw,
            "scaffold": False, "c_global": None, "c_local": None,
            "server_opt": "", "opt_m": None, "opt_v": None, "opt_t": None,
        }
        t_total = timed(full_kw)
        t_train = timed(plain_kw) if (self.scaffold or self.server_opt) else t_total

        # "clip" needs the round's center, which the probe does not carry;
        # its reduce and diffusion cost FedAvg's to first order
        agg = "fedavg" if self.aggregator == "clip" else self.aggregator

        @torch.no_grad()
        def agg_call():
            out = _aggregate(self.params, mask, self._samples, sel_idx, agg, self.trim)
            return tree_map(lambda a: a[None].expand(self.n, *a.shape).clone(), out)

        t_agg = self._median_s(agg_call, tuple, iters)
        return {
            "total_s": round(t_total, 4),
            "train_s": round(t_train, 4),
            "correction_s": round(max(t_total - t_train, 0.0), 4),
            "aggregate_s": round(t_agg, 4),
            "overhead_x": round(t_total / t_train, 2) if t_train > 0 else None,
        }

    def run(self, rounds: int, epochs: int = 1, eval_every: int = 0) -> list[dict]:
        for r in range(rounds):
            entry = self.run_round(epochs)
            if eval_every and (r + 1) % eval_every == 0:
                entry.update(self.evaluate())
        return self.history

    def run_fused(self, rounds: int, epochs: int = 1, eval: bool = False) -> list[dict]:  # noqa: A002
        """``rounds`` rounds in one call with no host sync between them
        (the train set fixed for the span, as the reference votes in round 0
        only). With ``eval=True`` each round's accuracy is computed on the
        device; the entries hold device scalars.

        On the card a span of the plain path (a transform of this package's,
        schedules included, remat too; no SCAFFOLD, FedOpt or DP-SGD) is
        captured as a CUDA graph the
        first time its shape is seen and replayed after that
        (:class:`_CapturedSpan`); the other spans, and every span on the
        CPU, run eagerly."""
        perms, mask, sel_idx = self._fused_inputs(rounds, epochs)
        dp_gen = self._dp_round_keys()
        if self._capturable():
            key = (tuple(perms.shape), eval, sel_idx.numel())
            if key not in self._spans:
                self._spans[key] = _CapturedSpan(self, perms, mask, sel_idx, eval)
            result = self._spans[key].run(self, perms, mask, sel_idx)
        else:
            result = spmd_rounds_fused(
                self.params, self.opt_state, self.x_all, self.y_all, perms, mask, self._samples, sel_idx,
                x_test=self.x_test if eval else None, y_test=self.y_test if eval else None,
                dp_gen=dp_gen, **self._round_kwargs(), **self._algo_kwargs(self._server_t),
            )
        i = self._take_state(result)
        if self.server_opt:
            self._server_t += rounds
        if self.accountant is not None:
            self.accountant.step(rounds * epochs * self._nb)
        losses, accs = result[2], result[i] if eval else None
        entries = []
        for r in range(rounds):
            self.round += 1
            entry = {"round": self.round, "train_loss": losses[r]}
            if eval:
                entry["test_acc"] = accs[r]
            self.history.append(entry)
            entries.append(entry)
        return entries

    def round_flops(self, epochs: int = 1) -> float:
        """FLOPs of one no-eval round, counted from the shapes: the model's
        GEMMs and convolutions for one node's step on one batch as autograd
        runs them (forward, weight gradients and the input gradients it
        needs; ``remat`` adds one more forward), counted by
        :func:`_model_step_flops`; the optimizer's elementwise operations a
        parameter a step (Adam 14, SGD 2); the extra per-step operations of
        FedProx, SCAFFOLD and DP-SGD's per-example clipping; and the
        aggregation (5 a parameter a node: the mask select and the weighted
        sum). Activations, norms, biases and the loss are left out (under
        0.2% of the MLP's round). The JAX package reads XLA's cost analysis
        instead.

        Like the JAX method, it draws the round inputs it would run with
        (shuffle, client sample, DP key), so the rng streams stay in step."""
        self._make_perm_np(epochs)
        self._effective_mask()
        self._dp_round_keys()
        forward, step = _model_step_flops(self.module, self.model.params, self.x_all, self.y_all, self.batch_size)
        if self.remat:
            step += forward
        n_params = self.model.param_count
        per_step = (2 if self.optimizer == "sgd" else 14) * n_params  # an explicit tx counts as Adam
        if self.prox_mu > 0.0:
            per_step += 6 * n_params  # (w − a)², its sum, its gradient
        if self.scaffold:
            per_step += 2 * n_params  # the correction, the gradient sum
        if self.dp_clip > 0.0:
            per_step += 5 * n_params * self.batch_size  # norm, scale, mean a sample
        steps = epochs * self._nb
        round_ops = 5 * n_params * self.n
        return float(self.n * steps * (step + per_step) + round_ops)

    def evaluate(self) -> dict:
        loss, acc = spmd_eval(self.params, self.x_test, self.y_test, module=self.module)
        return {
            "test_loss": float(loss.mean()),
            "test_acc": float(acc.mean()),
            "per_node_acc": acc.cpu().numpy().tolist(),
        }

    # ---- checkpoint / resume ----

    def save(self, directory: str) -> None:
        from p2pfl_tpu_torch.learning.checkpoint import save_federation

        save_federation(directory, self)

    def restore(self, directory: str, step: Optional[int] = None) -> None:
        from p2pfl_tpu_torch.learning.checkpoint import restore_federation

        restore_federation(directory, self, step)

    # ---- interop ----

    def node_params(self, i: int) -> dict:
        """One node's slice of the node-stacked state."""
        return tree_map(lambda x: x[i], self.params)

    @classmethod
    def from_dataset(
        cls,
        model: TorchModel,
        dataset: FederatedDataset,
        n_nodes: int,
        strategy: str = "iid",
        alpha: float = 0.5,
        **kwargs,
    ) -> "SpmdFederation":
        shards = [dataset.partition(i, n_nodes, strategy, alpha) for i in range(n_nodes)]
        return cls(model, shards, **kwargs)
