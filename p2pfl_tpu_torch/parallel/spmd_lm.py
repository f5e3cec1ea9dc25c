"""Full-parameter causal-LM federations: MoE expert parallelism and GPipe
(counterpart of ``p2pfl_tpu/parallel/spmd_lm.py``).

- :class:`SpmdLmFederation` trains a whole transformer LM (dense or MoE)
  on every node as one round program (``parallel/spmd.py``'s machinery):
  local epochs with the batched forward and backward, the masked
  aggregation, the diffusion. The local loss is the mean next-token CE
  plus the MoE layers' router losses
  (:func:`p2pfl_tpu_torch.models.base.apply_with_aux`), so the routers
  learn through the federation. On a ``(nodes, model)`` mesh the
  node-stacked state ``[N, ...]`` splits over ``nodes`` and each leaf's
  tensor-parallel rule over ``model`` (``parallel/sharding.py``'s rules
  shifted one axis right): MoE expert stacks ``[N, E, ...]`` put E/m
  experts on a slot (expert parallelism), the dense projections go
  column- and row-parallel. A row's step computes on the gathered tensors
  and steps Adam shard by shard. The round program is
  ``SpmdFederation``'s with no FedProx, SCAFFOLD, FedOpt or DP-SGD, which
  the constructor refuses as JAX's does; ``run_fused`` replays one
  captured CUDA graph a span shape on the card, mesh or not.
- :class:`PipelineFederation`: federated nodes whose local training runs
  the GPipe-pipelined model (``parallel/pipeline.py``). The nodes
  time-share the pipe mesh, one node's epochs after another's, and a
  sample-weighted FedAvg closes the round (the stand-in for the exchange
  between per-node slices).
"""

from __future__ import annotations

import math
import time
from typing import Optional

import numpy as np
import torch

from p2pfl_tpu_torch import resolve_device
from p2pfl_tpu_torch.learning.learner import adam, apply_updates, ce_eval, softmax_cross_entropy
from p2pfl_tpu_torch.ops.aggregation import fedavg
from p2pfl_tpu_torch.ops.tree import tree_items, tree_leaves, tree_map, tree_stack, tree_unflatten
from p2pfl_tpu_torch.parallel.mesh import Mesh, default_devices, pipeline_mesh
from p2pfl_tpu_torch.parallel.pipeline import pipelined_lm_apply
from p2pfl_tpu_torch.parallel.sharding import (
    DEFAULT_TRANSFORMER_RULES, gather_tree, n_rows, node_stacked_shardings, split_rows,
)
from p2pfl_tpu_torch.parallel.spmd import SpmdFederation, _whole, spmd_round, spmd_rounds_fused
from p2pfl_tpu_torch.settings import Settings

#: JAX's LM round programs: ``SpmdFederation``'s with FedProx, SCAFFOLD,
#: FedOpt and DP-SGD off, ``(stacked, opt_states, x_all, y_all, perm(s),
#: mask, weights, sel_idx, *, module, tx, agg, trim, keep_opt_state,
#: remat)`` → (params', opt', loss or losses [R])
spmd_lm_round = spmd_round
spmd_lm_rounds_fused = spmd_rounds_fused


@torch.no_grad()
def spmd_lm_eval(stacked, x_test, y_test, *, module):
    """Each node's pure-CE test loss and next-token accuracy over its test
    shard ``[N, S, T]``: ([N], [N]); a row of the mesh's nodes axis on its
    device, on its gathered params."""

    def node_eval(p, x, y):
        loss, logits = ce_eval(p, module, x, y)
        return loss, (logits.argmax(dim=-1) == y.long()).float().mean()

    k = n_rows(x_test)
    losses, accs = [], []
    for p, x, y in zip(split_rows(stacked, k), split_rows(x_test, k), split_rows(y_test, k)):
        loss, acc = torch.func.vmap(node_eval)(gather_tree(p), x, y)
        losses.append(loss)
        accs.append(acc)
    return _whole(losses, losses[0].device), _whole(accs, accs[0].device)


class SpmdLmFederation(SpmdFederation):
    """Full-parameter LM federation on a ``(nodes, model)`` mesh.

    ``expert_parallel`` sets the model-axis size of the default mesh (JAX's
    slot count: the most rows that divide N with ``expert_parallel``
    devices a row, from the visible devices; too few raise); a given
    ``mesh`` sets it itself. The tensor- and expert-parallel rules of
    ``parallel/sharding.py`` place every node-stacked leaf
    (:meth:`_param_shardings`); the Adam moments take the params' layout.
    SCAFFOLD, FedOpt, DP-SGD and FedProx are refused, as in JAX."""

    _MODEL_AXIS = True

    def __init__(self, model, datasets, mesh=None, expert_parallel: int = 1, **kwargs) -> None:
        for unsupported in ("scaffold", "server_opt", "dp_clip", "dp_noise", "prox_mu"):
            if kwargs.get(unsupported):
                raise ValueError(f"SpmdLmFederation does not support {unsupported}")
        if isinstance(mesh, Mesh) and expert_parallel > 1 and mesh.shape.get(Settings.MESH_MODEL_AXIS) != expert_parallel:
            raise ValueError(f"expert_parallel={expert_parallel} against a mesh of {dict(mesh.shape)}")
        self.expert_parallel = expert_parallel
        super().__init__(model, datasets, mesh=mesh, **kwargs)
        if self.mesh.devices.size > self.mesh.shape[Settings.MESH_NODES_AXIS] and not self.tx.elementwise:
            # a norm or a factored moment would be taken shard by shard
            raise ValueError("a transform that is not elementwise cannot step a node's tensors shard by shard")

    def _row_width(self) -> int:
        return self.expert_parallel

    def _param_shardings(self, params: dict) -> dict:
        """``(nodes, *tp_spec)`` a leaf: the tensor- and expert-parallel
        rules shifted one axis right; an axis that does not divide its
        dimension falls back to ``None`` (JAX's
        ``_node_stacked_shardings``)."""
        return node_stacked_shardings(self.mesh, params, DEFAULT_TRANSFORMER_RULES)

    def evaluate(self) -> dict:
        loss, acc = spmd_lm_eval(self.params, self.x_test, self.y_test, module=self.module)
        return {
            "test_loss": float(loss.mean()),
            "test_acc": float(acc.mean()),
            "per_node_acc": acc.cpu().numpy().tolist(),
        }


class PipelineFederation:
    """Federated nodes whose local training is GPipe-pipelined.

    Each round every node starts from the global model, runs ``epochs``
    pipelined epochs on the pipe mesh (one node after another: the
    single-process stand-in for per-node slices), and the round closes
    with a sample-weighted FedAvg. The reference's round semantics: every
    node trains, FedAvg, a fresh Adam every round unless
    ``keep_opt_state``.

    ``mesh`` is a :func:`pipeline_mesh`; without one, ``n_stages`` stages
    run on the visible cards for ``device=None`` (default: the largest
    divisor of ``n_layers`` they allow; too few cards raise, as in JAX),
    or on ``device`` repeated (default one stage). Layer i lives on its
    stage's device, the embedding and the final norm on the first stage's;
    each stage's Adam steps its own leaves (an elementwise optimizer: the
    whole tree's bits).
    """

    def __init__(
        self,
        model,
        datasets: list,
        mesh: Optional[Mesh] = None,
        n_stages: int = 0,
        batch_size: int = 8,
        learning_rate: float = 1e-3,
        n_micro: int = 0,
        keep_opt_state: bool = False,
        seed: int = 0,
        device=None,
    ) -> None:
        cfg = model.extra.get("config")
        if cfg is None:
            raise ValueError("model must be a tiny_transformer-built CausalLM")
        dev = resolve_device(device)
        if mesh is None and device is None:
            visible = default_devices()
            n_stages = n_stages or max(s for s in range(1, len(visible) + 1) if cfg.n_layers % s == 0)
            mesh = pipeline_mesh(n_stages, devices=visible)
        elif mesh is None:
            mesh = pipeline_mesh(n_stages or 1, devices=[dev] * (n_stages or 1))
        elif not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a p2pfl_tpu_torch.parallel.mesh.Mesh, got {type(mesh).__name__}")
        for d in mesh.devices.flat:
            if d.type != dev.type:
                raise ValueError(f"mesh slot on {d}: the federation runs on {dev.type}")
        self.mesh = mesh
        self.axis = mesh.axis_names[0]
        n_st = mesh.shape[self.axis]
        if cfg.n_layers % n_st != 0:
            raise ValueError(f"{cfg.n_layers} layers not divisible into {n_st} stages")
        self.cfg = cfg
        self.model = model
        self.attn_fn = getattr(model.module, "attn_fn", None)
        self.stage_devices = mesh.axis_devices(self.axis)
        self.device = self.stage_devices[0]
        self.params = self._place(model.params)
        self.n = len(datasets)
        self.batch_size = batch_size
        self.n_micro = n_micro or n_st
        if batch_size % self.n_micro != 0:
            raise ValueError(f"batch {batch_size} not divisible into {self.n_micro} microbatches")
        self.tx = adam(learning_rate)
        self.keep_opt_state = keep_opt_state
        self._opts = [self._init_opt(self.params) for _ in range(self.n)] if keep_opt_state else None
        self._rng = np.random.default_rng(seed)
        self.datasets = datasets
        smallest = min(d.num_samples for d in datasets)
        if smallest < batch_size:
            # an undersized shard would give zero steps and a NaN round
            # loss with the params silently unchanged
            raise ValueError(f"smallest shard ({smallest}) < batch size ({batch_size})")
        self._samples = np.asarray([d.num_samples for d in datasets], np.float32)
        self.round = 0
        self.history: list[dict] = []
        self.last_profile: Optional[dict] = None
        # captured train steps by batch shape (one card)
        self._steps: dict = {}

    # ---- placement: a stage's layers on its device ----

    def _stage_of(self, key: str) -> int:
        per = self.cfg.n_layers // len(self.stage_devices)
        return int(key.split("_", 1)[1]) // per if key.startswith("layer_") else 0

    def _place(self, params: dict) -> dict:
        # sorted keys, as every tree the rounds build (a captured step's
        # buffers keep one structure)
        return {
            k: tree_map(lambda x, d=self.stage_devices[self._stage_of(k)]: x.to(d), params[k]) for k in sorted(params)
        }

    def _groups(self, tree: dict) -> list[dict]:
        """The tree's top-level entries by stage."""
        groups: list[dict] = [{} for _ in self.stage_devices]
        for k, v in tree.items():
            groups[self._stage_of(k)][k] = v
        return groups

    def _init_opt(self, params: dict) -> list:
        return [self.tx.init(g) for g in self._groups(params)]

    # ---- the pipelined step ----

    def _loss_and_grads(self, params: dict, bx: torch.Tensor, by: torch.Tensor):
        paths = [p for p, _ in tree_items(params)]
        leaves = [x.detach().requires_grad_(True) for x in tree_leaves(params)]
        with torch.enable_grad():
            logits, aux = pipelined_lm_apply(
                tree_unflatten(dict(zip(paths, leaves))), bx, self.cfg, self.mesh, self.axis,
                n_micro=self.n_micro, attn_fn=self.attn_fn, return_aux=True,
            )
            loss = softmax_cross_entropy(logits, by.to(logits.device)).mean() + aux
            grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), tree_unflatten(dict(zip(paths, grads)))

    def _train_step(self, params: dict, opt: list, x: torch.Tensor, y: torch.Tensor, anchor=None):
        """One GPipe train step: the pipelined value and gradient, each
        stage's Adam on its leaves. Returns ``(params, opt, loss)``."""
        loss, grads = self._loss_and_grads(params, x, y)
        new_p, new_o = {}, []
        for g, o, p in zip(self._groups(grads), opt, self._groups(params)):
            updates, o = self.tx.update(g, o, p)
            new_p.update(apply_updates(p, updates))
            new_o.append(o)
        return {k: new_p[k] for k in params}, new_o, loss

    def _epoch(self, params: dict, opt: list, xs: torch.Tensor, ys: torch.Tensor):
        """One pipelined epoch over ``[nb, bs, T]`` batches: a GPipe train
        step a batch. When every stage is one card the step is a captured
        CUDA graph (``spmd.py::CapturedTrainStep``, one a batch shape),
        replayed a batch: the host's ~M·L block calls a step, each a few
        small kernels, would otherwise keep the card waiting."""
        if self.device.type == "cuda" and len(set(self.stage_devices)) == 1:
            from p2pfl_tpu_torch.parallel.spmd import CapturedTrainStep

            key = tuple(xs.shape[1:])
            if key not in self._steps:
                self._steps[key] = CapturedTrainStep(params, opt, xs[0], ys[0], step=self._train_step)
            return self._steps[key].epoch(params, opt, xs, ys)
        losses = []
        for b in range(xs.shape[0]):
            params, opt, loss = self._train_step(params, opt, xs[b], ys[b])
            losses.append(loss)
        return params, opt, torch.stack(losses).mean()

    def _node_batches(self, i: int, epochs: int):
        """Node i's epochs of batches: one permutation of its shard an
        epoch from the shared numpy stream, node by node (JAX's order)."""
        d = self.datasets[i]
        nb = d.num_samples // self.batch_size
        for _ in range(epochs):
            idx = self._rng.permutation(d.num_samples)[: nb * self.batch_size].reshape(nb, self.batch_size)
            yield (torch.from_numpy(np.asarray(d.x_train[idx])).to(self.device),
                   torch.from_numpy(np.asarray(d.y_train[idx])).to(self.device))

    def _sync(self) -> None:
        for d in set(self.stage_devices):
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    def run_round(self, epochs: int = 1, profile: bool = False) -> dict:
        """One federated round; ``profile=True`` times each node's epochs
        and the FedAvg (a device synchronize after each) into
        ``last_profile``, which any other round clears."""
        prof = {"node_epoch_s": [0.0] * self.n, "fedavg_s": 0.0}
        trained, losses = [], []
        for i in range(self.n):
            p = self.params
            o = self._opts[i] if self.keep_opt_state else self._init_opt(p)
            t0 = time.monotonic()
            loss = None
            for xs, ys in self._node_batches(i, epochs):
                p, o, loss = self._epoch(p, o, xs, ys)
            if loss is None:
                # zero batches (epochs=0): the untouched global keeps its
                # place in the FedAvg (the weights are positional)
                from p2pfl_tpu_torch.management.logger import logger

                logger.warning("pipeline-fed", f"node {i} produced zero batches this round — skipping its loss")
                trained.append(p)
                continue
            if profile:
                self._sync()
                prof["node_epoch_s"][i] = round(time.monotonic() - t0, 3)
            if self.keep_opt_state:
                self._opts[i] = o
            trained.append(p)
            losses.append(loss)
        # the FedAvg: the exchange between per-node slices
        t0 = time.monotonic()
        self.params = fedavg(tree_stack(trained), torch.from_numpy(self._samples))
        if profile:
            self._sync()
            prof["fedavg_s"] = round(time.monotonic() - t0, 3)
        # a stale profile must not be read as this round's
        self.last_profile = prof if profile else None
        self.round += 1
        entry = {
            "round": self.round,
            "train_loss": float(np.mean([float(x) for x in losses])) if losses else math.nan,
        }
        self.history.append(entry)
        return entry

    @torch.no_grad()
    def _eval_acc(self, x: torch.Tensor, y: torch.Tensor) -> float:
        logits, _ = pipelined_lm_apply(
            self.params, x, self.cfg, self.mesh, self.axis, n_micro=self.n_micro, attn_fn=self.attn_fn,
            return_aux=True,
        )
        return float((logits.argmax(dim=-1) == y.to(logits.device).long()).float().mean())

    def evaluate(self) -> dict:
        """Each node's next-token accuracy on its test split in batches of
        ``batch_size`` (the remainder dropped), and their mean."""
        accs = []
        for d in self.datasets:
            n = (len(d.y_test) // self.batch_size) * self.batch_size
            if n == 0:
                raise ValueError(f"test split smaller than one batch ({len(d.y_test)})")
            acc = [
                self._eval_acc(torch.from_numpy(np.asarray(d.x_test[s:s + self.batch_size])).to(self.device),
                               torch.from_numpy(np.asarray(d.y_test[s:s + self.batch_size])))
                for s in range(0, n, self.batch_size)
            ]
            accs.append(float(np.mean(acc)))
        return {"test_acc": float(np.mean(accs)), "per_node_acc": accs}
