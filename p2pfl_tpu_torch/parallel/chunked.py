"""Time-shared federation: N logical nodes streamed through one device in
chunks (counterpart of ``p2pfl_tpu/parallel/chunked.py``).

BASELINE config 3 is 64 ResNet-50 nodes. :class:`SpmdFederation` keeps
every node's params and Adam moments resident, and so runs config 3 only
at a node count that fits. This class runs the stated node count by
time-sharing the device:

- nodes train in chunks of ``chunk_size``: each chunk broadcasts the
  round-start aggregate to its C slots, runs the local epochs
  (``spmd.py::_local_epoch``: the model's forward vmapped over the slots)
  and reduces the trained models to an fp32 weighted partial sum on the
  device;
- FedAvg becomes a running (partial sum, weight) accumulation across
  chunks, so what stays resident is one aggregate and one chunk's
  workspace; nothing per node leaves the device;
- with ``Settings.CHUNK_FUSED_REDUCE`` each chunk adds its contribution
  into preallocated fp32 accumulators as part of its own work (in place
  under ``CHUNK_DONATE_BUFFERS``, JAX's donated buffers), where the
  serial path adds whole trees after each chunk; the sums start at zero
  and add in JAX's order (0 + x first), so both paths give the same bits;
- a chunk's inputs are staged ``Settings.CHUNK_STAGING_DEPTH`` chunks
  ahead: on the card their host-to-device copies go out from pinned
  memory on a side stream with ``non_blocking=True``, so chunk k+1's
  copies overlap chunk k's compute;
- optimizer moments are aggregated with the same weighted mean as the
  params ("federated moment averaging"): per-node moments are exactly
  the state that does not fit. Every node starts a round from
  (aggregate params, aggregate moments); integer leaves (the step count
  a schedule reads) pass through, so schedules keep counting across
  rounds. This is the JAX class's documented divergence from
  :class:`SpmdFederation`'s per-node ``keep_opt_state``.

On the card the fused path replays one captured CUDA graph a chunk
shape (:class:`_CapturedChunk`), the counterpart of XLA's one program a
chunk; ``remat`` (non-reentrant ``torch.utils.checkpoint``) captures.
FedAvg only, as in JAX: one streaming pass cannot take medians or Krum
distances.
"""

from __future__ import annotations

import random
from functools import partial
from typing import Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from p2pfl_tpu_torch import resolve_device
from p2pfl_tpu_torch.learning.dataset import FederatedDataset
from p2pfl_tpu_torch.learning.learner import GradientTransformation, adam, softmax_cross_entropy
from p2pfl_tpu_torch.models.base import TorchModel
from p2pfl_tpu_torch.ops.tree import tree_map
from p2pfl_tpu_torch.parallel.spmd import (
    _copy_tree, _local_epoch, _model_step_flops, capture_guard, draw_node_perms, elect_train_set_mask,
    stage_node_shards,
)
from p2pfl_tpu_torch.settings import Settings


def _is_inexact(x: torch.Tensor) -> bool:
    return x.is_floating_point() or x.is_complex()


def _broadcast(tree, c: int):
    """The aggregate on C slots: floating leaves ``[C, ...]``; integer
    leaves (a step count, shared by every slot of a node-stacked state)
    stay as they are."""
    return pytree.tree_map(lambda a: a[None].expand(c, *a.shape).clone() if _is_inexact(a) else a, tree)


@torch.no_grad()
def _chunk_contrib(agg_params, agg_opt, x, y, perm, mask, weights, module, tx, remat):
    """One chunk's round contribution: broadcast the aggregate to C slots,
    run each slot's epochs (``perm`` ``[C, epochs, nb, bs]`` into the
    chunk's data ``x`` ``[C, S, ...]``), reduce to (weighted fp32 param
    sum, weighted fp32 opt sum, total weight, mean loss). Masked slots
    train but weigh zero; integer opt leaves come from the chunk as they
    are."""
    c = mask.shape[0]
    p, o = _broadcast(agg_params, c), _broadcast(agg_opt, c)
    nodes = torch.arange(c, device=perm.device)[:, None, None]
    losses = []
    for e in range(perm.shape[1]):
        idx = perm[:, e].long()
        p, o, loss = _local_epoch(p, o, x[nodes, idx], y[nodes, idx], module, tx, remat)
        losses.append(loss)
    return _weighted_sums(p, o, torch.stack(losses).mean(dim=0), mask, weights)


@torch.no_grad()
def _weighted_sums(p, o, losses, mask, weights):
    """The chunk's trained slots reduced: (fp32 param sum, fp32 opt sum,
    total weight, mean loss), each slot weighted by ``mask * weights``."""
    w = (mask * weights).float()

    def wsum(t):
        return torch.tensordot(w, t.float(), dims=([0], [0]))

    psum = tree_map(wsum, p)
    osum = pytree.tree_map(lambda t: wsum(t) if _is_inexact(t) else t, o)
    total = w.sum()
    loss = (losses * w).sum() / torch.clamp(total, min=1e-9)
    return psum, osum, total, loss


def _zero_acc(params, opt_state):
    """Fresh accumulators: fp32 zero sums, zero weight and loss."""
    dev = pytree.tree_leaves(params)[0].device
    psum = tree_map(lambda a: torch.zeros(a.shape, dtype=torch.float32, device=dev), params)
    osum = pytree.tree_map(lambda a: torch.zeros(a.shape, dtype=torch.float32 if _is_inexact(a) else a.dtype, device=dev),
                opt_state)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    return psum, osum, zero, zero.clone()


@torch.no_grad()
def _chunk_round_acc(acc, agg_params, agg_opt, x, y, perm, mask, weights, *, module, tx, remat,
                     in_place: bool):
    """The fused chunk step: train the chunk and fold its contribution into
    the accumulators ``acc`` = (psum, osum, wsum, loss_sum)
    (:func:`_accumulate`)."""
    contrib = _chunk_contrib(agg_params, agg_opt, x, y, perm, mask, weights, module, tx, remat)
    return _accumulate(acc, contrib, in_place)


@torch.no_grad()
def _accumulate(acc, contrib, in_place: bool):
    """Fold one chunk's contribution into ``acc``. ``in_place`` adds into
    ``acc``'s tensors (``add_``; integer opt leaves copied), else returns
    fresh ones. The sums started at zero, so the order of additions is the
    serial path's."""
    psum, osum, wsum, loss_sum = acc
    p_c, o_c, w_c, l_c = contrib
    if in_place:
        pl, ol = pytree.tree_leaves(psum), pytree.tree_leaves(osum)
        torch._foreach_add_(pl, pytree.tree_leaves(p_c))
        for a, b in zip(ol, pytree.tree_leaves(o_c)):
            a.add_(b) if _is_inexact(b) else a.copy_(b)
        wsum.add_(w_c)
        loss_sum.add_(l_c * w_c)
        return acc
    psum = tree_map(torch.add, psum, p_c)
    osum = pytree.tree_map(lambda a, b: a + b if _is_inexact(b) else b, osum, o_c)
    return psum, osum, wsum + w_c, loss_sum + l_c * w_c


@torch.no_grad()
def _finalize(psum, osum, wsum, params_ref, opt_ref, *, tx, keep_opt: bool):
    """The new aggregate from the sums: params ``psum / wsum`` in their
    dtype; the opt state the averaged moments (``keep_opt``) or fresh."""
    params = tree_map(lambda s, ref: (s / wsum).to(ref.dtype), psum, params_ref)
    if keep_opt:
        opt = pytree.tree_map(lambda s, ref: (s / wsum).to(ref.dtype) if _is_inexact(ref) else s, osum, opt_ref)
    else:
        opt = tx.init(params)
    return params, opt


@torch.no_grad()
def _chunk_eval(module, agg_params, x_t, y_t):
    """The aggregate on each node's test shard: ([C] loss, [C] acc)."""
    c, t = x_t.shape[:2]
    logits = module(agg_params, x_t.reshape(c * t, *x_t.shape[2:])).reshape(c, t, -1)
    loss = softmax_cross_entropy(logits, y_t).mean(dim=-1)
    acc = (logits.argmax(dim=-1) == y_t.long()).float().mean(dim=-1)
    return loss, acc


class _CapturedChunk:
    """The fused chunk step captured as a CUDA graph for one chunk shape.

    The graph reads fixed buffers: the round's aggregate (params and opt
    state, copied in once a round), the chunk's data, shuffle, mask and
    weights (copied in before each replay), and adds into its own
    accumulators, which :meth:`start_round` clears at the start of a round. It
    runs the eager step's code on the same kernels, so a replay adds what
    the eager step adds."""

    def __init__(self, fed: "ChunkedFederation", inputs: tuple) -> None:
        clone = partial(pytree.tree_map, torch.clone)
        self.agg = clone((fed.params, fed.opt_state))
        self.inputs = clone(inputs)
        self.acc = _zero_acc(fed.params, fed.opt_state)
        kw = dict(module=fed.module, tx=fed._tx_stacked, remat=fed.remat, in_place=True)

        def body():
            _chunk_round_acc(self.acc, *self.agg, *self.inputs, **kw)

        # warm the kernels up on a side stream, as capture requires
        side = torch.cuda.Stream(fed.device)
        side.wait_stream(torch.cuda.current_stream(fed.device))
        with torch.cuda.stream(side):
            body()
        torch.cuda.current_stream(fed.device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with capture_guard(), torch.cuda.graph(self.graph):
            body()

    def start_round(self, params, opt_state) -> None:
        _copy_tree((params, opt_state), self.agg)
        for t in pytree.tree_leaves(self.acc):
            t.zero_()

    def run(self, inputs: tuple) -> None:
        _copy_tree(inputs, self.inputs)
        self.graph.replay()


class ChunkedFederation:
    """N-node FedAvg federation streamed through one device ``chunk_size``
    nodes at a time. The round semantics of :class:`SpmdFederation` but
    the moment averaging of the module docstring. ``device=None`` is the
    card; ``resident=False`` keeps the data in (pinned) host memory and
    streams it a chunk at a time."""

    def __init__(
        self,
        model: TorchModel,
        datasets: list[FederatedDataset],
        chunk_size: int,
        batch_size: int = 128,
        learning_rate: float = 1e-3,
        keep_opt_state: bool = False,
        remat: bool = False,
        vote: bool = False,
        seed: int = 0,
        tx: Optional[GradientTransformation] = None,
        resident: bool = True,
        device=None,
    ) -> None:
        self.device = resolve_device(device)
        self.model = model
        self.module = model.module
        self._resident = resident
        self.n = len(datasets)
        if self.n % chunk_size != 0:
            raise ValueError(f"{self.n} nodes not divisible into chunks of {chunk_size}")
        self._chunk_size = chunk_size
        self.datasets = datasets
        self.batch_size = batch_size
        self.tx = tx if tx is not None else adam(learning_rate)
        # the slots of a chunk are node-stacked: a transform that is not
        # elementwise steps them in its per-node form
        self._tx_stacked = self.tx.node_stacked or self.tx
        self.keep_opt_state = keep_opt_state
        self.remat = remat
        self._vote = vote
        self._rng = np.random.default_rng(seed)
        self._py_rng = random.Random(seed)

        staged = stage_node_shards(datasets, batch_size)
        self._stage_chunks(staged)
        self.x_test = torch.from_numpy(np.stack(staged["x_test"])).to(self.device)
        self.y_test = torch.from_numpy(np.stack(staged["y_test"])).to(self.device)
        self._sizes = staged["sizes"]
        self._samples = np.asarray(self._sizes, np.float32)
        self._nb = staged["nb"]
        # a side stream for the chunk inputs' copies, on the card only
        self._copy_stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        self._graphs: dict = {}

        self.train_mask = np.ones(self.n, dtype=np.float32)
        self.active_mask = np.ones(self.n, dtype=np.float32)
        self.round = 0
        self.history: list[dict] = []
        self._stage_state()

    def _stage_chunks(self, staged: Optional[dict] = None) -> None:
        """The data split a chunk at a time: on the device (``resident``),
        or as host tensors (pinned on the card) streamed chunk by chunk."""
        c = self._chunk_size
        staged = staged or stage_node_shards(self.datasets, self.batch_size)
        xs = [np.stack(staged["x"][c0:c0 + c]) for c0 in range(0, self.n, c)]
        ys = [np.stack(staged["y"][c0:c0 + c]) for c0 in range(0, self.n, c)]
        if self._resident:
            self.x_chunks = [torch.from_numpy(x).to(self.device) for x in xs]
            self.y_chunks = [torch.from_numpy(y).to(self.device) for y in ys]
            self._x_host = self._y_host = None
        else:
            self._x_host = [self._host(x) for x in xs]
            self._y_host = [self._host(y) for y in ys]
            self.x_chunks = self.y_chunks = None

    def _host(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(a)
        return t.pin_memory() if self.device.type == "cuda" else t

    @property
    def chunk_size(self) -> int:
        return self._chunk_size

    @chunk_size.setter
    def chunk_size(self, value: int) -> None:
        if self.n % value != 0:
            raise ValueError(f"{self.n} nodes not divisible into chunks of {value}")
        if value != self._chunk_size:
            self._chunk_size = value
            self._stage_chunks()

    def _stage_state(self) -> None:
        self.params = tree_map(lambda x: x.to(self.device).clone(), self.model.params)
        self.opt_state = self.tx.init(self.params)

    def reset(self, seed: int = 0) -> None:
        """Back to round 0 with fresh state, keeping data, device and graphs."""
        self._rng = np.random.default_rng(seed)
        self._py_rng = random.Random(seed)
        self.train_mask = np.ones(self.n, dtype=np.float32)
        self.active_mask = np.ones(self.n, dtype=np.float32)
        self.round = 0
        self.history = []
        self._stage_state()

    def drop_node(self, i: int) -> None:
        self.active_mask[i] = 0.0

    def restore_node(self, i: int) -> None:
        self.active_mask[i] = 1.0

    def elect_train_set(self) -> np.ndarray:
        """Reference vote semantics (``spmd.py::elect_train_set_mask``)."""
        return elect_train_set_mask(self.n, self._py_rng)

    def _make_perm_np(self, epochs: int) -> np.ndarray:
        return draw_node_perms(self._rng, self._sizes, self._nb, self.batch_size, epochs)

    def _stage_chunk_inputs(self, ci: int, perm_np: np.ndarray, eff: np.ndarray) -> tuple:
        """Start chunk ``ci``'s host-to-device copies: ``(x, y, perm, mask,
        weights)`` on the device. On the card they go from pinned memory
        on the side stream; the event that ends them is kept with them."""
        c, c0 = self._chunk_size, ci * self._chunk_size
        host = [torch.from_numpy(a[c0:c0 + c].copy()) for a in (perm_np, eff, self._samples)]
        if self._copy_stream is None:
            perm, mask, w = (t.to(self.device) for t in host)
            x = self.x_chunks[ci] if self._resident else self._x_host[ci]
            y = self.y_chunks[ci] if self._resident else self._y_host[ci]
            return (x, y, perm, mask, w), None
        self._copy_stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self._copy_stream):
            perm, mask, w = (t.pin_memory().to(self.device, non_blocking=True) for t in host)
            if self._resident:
                x, y = self.x_chunks[ci], self.y_chunks[ci]
            else:
                x = self._x_host[ci].to(self.device, non_blocking=True)
                y = self._y_host[ci].to(self.device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._copy_stream)
        return (x, y, perm, mask, w), done

    def _take(self, staged: dict, ci: int) -> tuple:
        """Chunk ``ci``'s staged inputs, ordered after their copies."""
        inputs, done = staged.pop(ci)
        if done is not None:
            main = torch.cuda.current_stream(self.device)
            main.wait_event(done)
            for t in inputs:
                t.record_stream(main)
        return inputs

    def _captured(self) -> bool:
        """The fused path replays a captured graph: on the card, with a
        capturable transform."""
        return self.device.type == "cuda" and self.tx.capturable and bool(Settings.CHUNK_FUSED_REDUCE)

    # ---- rounds ----

    def run_round(self, epochs: int = 1, eval: bool = False) -> dict:  # noqa: A002
        if self._vote and (self.round == 0 or Settings.VOTE_EVERY_ROUND):
            self.train_mask = self.elect_train_set()
        perm_np = self._make_perm_np(epochs)
        eff = self.train_mask * self.active_mask
        if eff.sum() == 0:
            raise RuntimeError("no active train-set nodes left")

        c = self._chunk_size
        # fully masked chunks contribute nothing: never staged, never run
        live = [ci for ci in range(self.n // c) if eff[ci * c:ci * c + c].sum() > 0]
        depth = max(1, int(Settings.CHUNK_STAGING_DEPTH))
        staged = {ci: self._stage_chunk_inputs(ci, perm_np, eff) for ci in live[:depth]}

        def stage_next(i: int) -> None:
            if i + depth < len(live):
                staged[live[i + depth]] = self._stage_chunk_inputs(live[i + depth], perm_np, eff)

        # loss and weight accumulate on the device: no host sync between
        # chunks, so chunk k+1's staging goes out while chunk k computes
        kw = dict(module=self.module, tx=self._tx_stacked, remat=self.remat)
        if Settings.CHUNK_FUSED_REDUCE:
            captured, graph = self._captured(), None
            acc = None if captured else _zero_acc(self.params, self.opt_state)
            in_place = bool(Settings.CHUNK_DONATE_BUFFERS)
            for i, ci in enumerate(live):
                inputs = self._take(staged, ci)
                if captured:
                    if graph is None:
                        # one graph a chunk shape, captured on its first chunk
                        key = (c, epochs)
                        if key not in self._graphs:
                            self._graphs[key] = _CapturedChunk(self, inputs)
                        graph = self._graphs[key]
                        graph.start_round(self.params, self.opt_state)
                    graph.run(inputs)
                else:
                    acc = _chunk_round_acc(acc, self.params, self.opt_state, *inputs, in_place=in_place, **kw)
                stage_next(i)
            psum, osum, wsum, loss_acc = graph.acc if captured else acc
            self.params, self.opt_state = _finalize(
                psum, osum, wsum, self.params, self.opt_state, tx=self.tx, keep_opt=self.keep_opt_state
            )
            if captured:
                # the graph's buffers are read again next round: keep copies
                wsum, loss_acc = wsum.clone(), loss_acc.clone()
                if self.keep_opt_state:
                    self.opt_state = pytree.tree_map(torch.clone, self.opt_state)
        else:
            # the serial reference path: whole-tree adds after every chunk
            psum = osum = None
            wsum = torch.zeros((), dtype=torch.float32, device=self.device)
            loss_acc = torch.zeros((), dtype=torch.float32, device=self.device)
            for i, ci in enumerate(live):
                p_c, o_c, w_c, l_c = _chunk_contrib(self.params, self.opt_state, *self._take(staged, ci),
                                                    kw["module"], kw["tx"], kw["remat"])
                stage_next(i)
                if psum is None:
                    psum, osum = p_c, o_c
                else:
                    psum = tree_map(torch.add, psum, p_c)
                    osum = pytree.tree_map(lambda a, b: a + b if _is_inexact(a) else a, osum, o_c)
                wsum = wsum + w_c
                loss_acc = loss_acc + l_c * w_c
            self.params, self.opt_state = _finalize(
                psum, osum, wsum, self.params, self.opt_state, tx=self.tx, keep_opt=self.keep_opt_state
            )
        self.round += 1
        entry: dict = {"round": self.round, "train_loss": float(loss_acc / wsum)}
        if eval:
            entry.update(self.evaluate())
        self.history.append(entry)
        return entry

    def evaluate(self) -> dict:
        losses, accs = [], []
        for c0 in range(0, self.n, self._chunk_size):
            loss, acc = _chunk_eval(
                self.module, self.params, self.x_test[c0:c0 + self._chunk_size],
                self.y_test[c0:c0 + self._chunk_size],
            )
            losses.append(loss)
            accs.append(acc)
        return {
            "test_loss": float(torch.cat(losses).mean()),
            "test_acc": float(torch.cat(accs).mean()),
        }

    def round_flops(self, epochs: int = 1, hw: bool = False) -> float:
        """FLOPs of one full round (all N nodes), counted from the shapes as
        :meth:`SpmdFederation.round_flops` counts a step (the model's
        products forward and backward, :func:`~p2pfl_tpu_torch.parallel.spmd._model_step_flops`,
        plus the optimizer's 14 operations a parameter).

        ``hw=False``: model FLOPs, no recompute (the useful work).
        ``hw=True``: with ``remat``, one more forward a step, the
        recompute the round executes (the JAX method counts it from the
        step compiled under ``jax.checkpoint``)."""
        x0 = self.x_chunks[0] if self._resident else self._x_host[0]
        y0 = self.y_chunks[0] if self._resident else self._y_host[0]
        forward, step = _model_step_flops(self.module, self.model.params, x0, y0, self.batch_size)
        if hw and self.remat:
            step += forward
        step += 14 * self.model.param_count
        return float(self.n * epochs * self._nb * step)

    @classmethod
    def from_dataset(
        cls,
        model: TorchModel,
        dataset: FederatedDataset,
        n_nodes: int,
        chunk_size: int,
        strategy: str = "iid",
        alpha: float = 0.5,
        **kwargs,
    ) -> "ChunkedFederation":
        shards = [dataset.partition(i, n_nodes, strategy, alpha) for i in range(n_nodes)]
        return cls(model, shards, chunk_size, **kwargs)
