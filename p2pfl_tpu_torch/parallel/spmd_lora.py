"""SPMD federated LoRA (counterpart of ``p2pfl_tpu/parallel/spmd_lora.py``).

Node-stacked state is only the adapter subtree ``[N, ...]``; the frozen
base model is stored once. Every local step runs all N nodes in one
batched forward/backward (tokens ``[N, bs, T]``, adapters ``[N, ...]``).
The loss autograd sees is the SUM over nodes of each node's mean CE,
which gives every node exactly the gradient of its own loss (a global
mean would scale each by 1/N). The frozen base keeps its kernels and
embedding as a bf16 copy: the model casts them to bf16 at every use, so
casting once is exact and halves the memory; norm scales stay fp32.
``node_chunk`` trains the nodes that many at a time and ``remat``
recomputes each step's forward in its backward, as in JAX; the model's
own per-block remat is ``TransformerConfig.remat``/``remat_policy``.

On a ``(nodes, model)`` mesh the adapters are node-stacked over the nodes
axis (each row's nodes train on its device) and, with
``model_parallel_base=True``, the frozen base is placed by the
tensor-parallel rules (``sharding.shard_transformer``) as slot shards over
the model axis. A row's round computes on its gathered base (a copy of
the same bits), so a split base gives the round a replicated one gives.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from p2pfl_tpu_torch.learning.dataset import FederatedDataset
from p2pfl_tpu_torch.learning.learner import apply_updates, init_opt_state, softmax_cross_entropy
from p2pfl_tpu_torch.learning.lora import _lm_loss, frozen_base, merge_params, split_lora
from p2pfl_tpu_torch.models.base import TorchModel
from p2pfl_tpu_torch.ops.tree import tree_items, tree_leaves, tree_map, tree_unflatten
from p2pfl_tpu_torch.parallel.sharding import (
    gather, join_rows, n_rows, place_tree, row_block, shard_transformer, split_rows,
    tree_is_placed,
)
from p2pfl_tpu_torch.parallel.spmd import SpmdFederation, _aggregate, _diffuse, _on_row, _steps_mean, _whole


def _node_epochs(lora, opt, base, x_all, y_all, perm, *, module, tx, remat: bool):
    """Every node's local epochs (``perm`` [N, epochs, nb, bs]) with the
    nodes batched: one forward and backward a step for all N. ``remat``
    recomputes the whole loss's forward in the backward. Returns
    (adapters', opt', mean train loss [N])."""
    n, epochs, nb = perm.shape[0], perm.shape[1], perm.shape[2]
    nodes = torch.arange(n, device=perm.device)[:, None]
    paths = [p for p, _ in tree_items(lora)]
    epoch_losses = []
    for e in range(epochs):
        step_losses = []
        for s in range(nb):
            idx = perm[:, e, s].long()  # [N, bs]
            bx, by = x_all[nodes, idx], y_all[nodes, idx]  # [N, bs, T]
            leaves = [x.detach().requires_grad_(True) for x in tree_leaves(lora)]

            def loss_of(*lv, bx=bx, by=by):
                return _lm_loss(tree_unflatten(dict(zip(paths, lv))), base, module, bx, by, node_axis=True)[0]

            with torch.enable_grad():
                node_loss = checkpoint(loss_of, *leaves, use_reentrant=False, preserve_rng_state=False) \
                    if remat else loss_of(*leaves)
                grads = torch.autograd.grad(node_loss.sum(), leaves)
            updates, opt = tx.update(tree_unflatten(dict(zip(paths, grads))), opt, lora)
            lora = apply_updates(lora, updates)
            step_losses.append(node_loss.detach())
        epoch_losses.append(_steps_mean(step_losses))
    return lora, opt, _steps_mean(epoch_losses)


def _rows(tree, lo: int, hi: int):
    """Rows ``lo:hi`` of a node-stacked state; a shared 0-d leaf (the
    optimizer's step count) as it is."""
    return torch.utils._pytree.tree_map(lambda a: a[lo:hi] if a.dim() else a, tree)


def _lora_round_core(
    stacked_lora, opt_states, base, x_all, y_all, perm, mask, weights, sel_idx,
    *, module, tx, agg: str = "fedavg", trim: int = 0, keep_opt_state: bool = False,
    remat: bool = False, node_chunk: int = 0,
):
    """One round: every node runs its local Adam epochs on its own batches
    (``perm`` [N, epochs, nb, bs]), the train-set nodes' adapters are
    aggregated (``agg`` over the ``sel_idx`` rows for the robust rules)
    and broadcast back, and the optimizer state resets from the aggregate
    unless ``keep_opt_state``. ``node_chunk``: the nodes train that many
    at a time, a Python loop over node-stacked chunks (JAX's ``lax.scan``
    of vmapped chunks): activation memory follows the nodes in flight.
    The node-stacked inputs may be placed along a mesh's nodes axis and
    the base over its model axis: each row trains on its device with its
    gathered base, and the rows fold as ``SpmdFederation``'s do. Returns
    (adapters', opt', mean train loss over the train-set nodes)."""
    kw = dict(module=module, tx=tx, remat=remat)
    k = n_rows(mask)
    rows = []
    for i, (lora_i, opt_i, x_i, y_i, perm_i, mask_i) in enumerate(
        zip(*(split_rows(t, k) for t in (stacked_lora, opt_states, x_all, y_all, perm, mask)))
    ):
        n = perm_i.shape[0]
        # the row's base, whole on the row's device (a placed base gathered)
        dev = perm_i.device
        opt_i = _on_row(opt_i, dev)
        base_i = tree_map(lambda b: gather(row_block(b, i, k)).to(dev), base)
        if node_chunk and node_chunk < n:
            parts = [
                _node_epochs(_rows(lora_i, c0, c0 + node_chunk), _rows(opt_i, c0, c0 + node_chunk),
                             base_i, x_i[c0:c0 + node_chunk], y_i[c0:c0 + node_chunk],
                             perm_i[c0:c0 + node_chunk], **kw)
                for c0 in range(0, n, node_chunk)
            ]
            # every chunk stepped the shared count alike: keep the last one's
            lora, opt, losses = torch.utils._pytree.tree_map(
                lambda *xs: torch.cat(xs) if xs[0].dim() else xs[-1], *parts
            )
        else:
            lora, opt, losses = _node_epochs(lora_i, opt_i, base_i, x_i, y_i, perm_i, **kw)

        def sel(new, old, m=mask_i, n=n):
            m = m.reshape((n,) + (1,) * (new.dim() - 1)).to(new.dtype)
            return new * m + old * (1 - m)

        rows.append((tree_map(sel, lora, lora_i), opt, losses))
    first = sel_idx.device
    mask_all = gather(mask)
    agg_lora = _aggregate([r[0] for r in rows], mask_all, gather(weights), sel_idx, agg, trim)
    out = _diffuse(tree_map(lambda a: a.to(first), agg_lora), stacked_lora)
    if keep_opt_state:
        out_opt = join_rows([r[1] for r in rows], opt_states) if tree_is_placed(stacked_lora) else rows[0][1]
    else:
        out_opt = init_opt_state(tx, out)
    return out, out_opt, _whole([r[2] for r in rows], first)[mask_all.bool()].mean()


def spmd_lora_round(stacked_lora, opt_states, base, x_all, y_all, perm, mask, weights, sel_idx, **kw):
    return _lora_round_core(
        stacked_lora, opt_states, base, x_all, y_all, perm, mask, weights, sel_idx, **kw
    )


def spmd_lora_rounds_fused(
    stacked_lora, opt_states, base, x_all, y_all, perms, mask, weights, sel_idx, **kw
):
    """R rounds in one call (``perms`` [R, N, epochs, nb, bs]); the host
    reads nothing between rounds. Returns (adapters', opt', losses [R])."""
    from p2pfl_tpu_torch.parallel.sharding import select0

    p, o, losses = stacked_lora, opt_states, []
    for r in range(perms.shape[0]):
        p, o, loss = _lora_round_core(p, o, base, x_all, y_all, select0(perms, r), mask, weights, sel_idx, **kw)
        losses.append(loss)
    return p, o, torch.stack(losses)


@torch.no_grad()
def spmd_lora_eval(stacked_lora, base, x_test, y_test, *, module):
    """Per-node (test CE [N], next-token accuracy [N]); a row of the
    mesh's nodes axis on its device, with its gathered base."""
    k = n_rows(x_test)
    ces, accs = [], []
    for i, (lora, x, y) in enumerate(zip(*(split_rows(t, k) for t in (stacked_lora, x_test, y_test)))):
        base_i = tree_map(lambda b: gather(row_block(b, i, k)).to(x.device), base)
        logits = module(merge_params(base_i, lora), x)
        n = x.shape[0]
        ces.append(softmax_cross_entropy(logits, y).reshape(n, -1).mean(1))
        accs.append((logits.argmax(-1) == y.long()).float().reshape(n, -1).mean(1))
    return _whole(ces, ces[0].device), _whole(accs, accs[0].device)


class SpmdLoraFederation(SpmdFederation):
    """Federation over adapter subtrees; frozen base stored once (split
    over the mesh's model axis with ``model_parallel_base``)."""

    _MODEL_AXIS = True

    def __init__(
        self, model: TorchModel, datasets: list[FederatedDataset], mesh=None,
        model_parallel_base: bool = False, node_chunk: int = 0, **kwargs,
    ) -> None:
        lora0, base0 = split_lora(model.params)
        if not tree_leaves(lora0):
            raise ValueError("model has no lora_* params")
        n = len(datasets)
        if node_chunk and node_chunk < n and n % node_chunk:
            raise ValueError(f"node_chunk {node_chunk} must divide n_nodes {n}")
        self._lora_template = lora0
        self._base_template = base0
        self._mp_base = model_parallel_base
        self.node_chunk = node_chunk
        super().__init__(model, datasets, mesh=mesh, **kwargs)

    def _stage_state(self) -> None:
        n, dev = self.n, self.device
        self.params = place_tree(
            tree_map(lambda x: x.to(dev)[None].expand(n, *x.shape).clone(), self._lora_template),
            self._param_shardings(self._lora_template),
        )
        self.opt_state = init_opt_state(self.tx, self.params)
        cfg = self.model.extra.get("config")
        dtype = cfg.dtype if cfg is not None else torch.bfloat16
        self.base = frozen_base(self._base_template, dtype, dev)
        if self._mp_base:
            self.base = shard_transformer(self.mesh, self.base)

    def _round_kwargs(self) -> dict:
        return dict(
            module=self.module, tx=self.tx, agg=self.aggregator, trim=self.trim,
            keep_opt_state=self.keep_opt_state, remat=self.remat, node_chunk=self.node_chunk,
        )

    def run_round(self, epochs: int = 1) -> dict:
        from p2pfl_tpu_torch.settings import Settings

        if self._vote and (self.round == 0 or Settings.VOTE_EVERY_ROUND):
            self.train_mask = self.elect_train_set()
        from p2pfl_tpu_torch.management.profiling import dispatch_span

        perm = self._make_perm(epochs)
        mask, sel_idx = self._mask_inputs(self._effective_mask())
        with dispatch_span("spmd_round", "spmd", device=self.device, nodes=self.n, epochs=epochs):
            self.params, self.opt_state, loss = spmd_lora_round(
                self.params, self.opt_state, self.base, self.x_all, self.y_all, perm, mask,
                self._samples, sel_idx, **self._round_kwargs(),
            )
        self.round += 1
        entry = {"round": self.round, "train_loss": loss}
        self.history.append(entry)
        return entry

    def run_fused(self, rounds: int, epochs: int = 1, eval: bool = False) -> list[dict]:  # noqa: A002
        """R adapter-federation rounds in one call (fixed train set for the
        span; no per-round voting). ``eval`` is not fused: call
        :meth:`evaluate`."""
        if eval:
            raise ValueError("SpmdLoraFederation.run_fused has no fused eval; call evaluate()")
        from p2pfl_tpu_torch.management.profiling import dispatch_span

        perms, mask, sel_idx = self._fused_inputs(rounds, epochs)
        with dispatch_span("spmd_rounds_fused", "spmd", device=self.device, nodes=self.n, rounds=rounds):
            self.params, self.opt_state, losses = spmd_lora_rounds_fused(
                self.params, self.opt_state, self.base, self.x_all, self.y_all, perms, mask,
                self._samples, sel_idx, **self._round_kwargs(),
            )
        entries = []
        for r in range(rounds):
            self.round += 1
            entry = {"round": self.round, "train_loss": losses[r]}
            self.history.append(entry)
            entries.append(entry)
        return entries

    def evaluate(self) -> dict:
        loss, acc = spmd_lora_eval(
            self.params, self.base, self.x_test, self.y_test, module=self.module
        )
        return {
            "test_loss": float(loss.mean()),
            "test_acc": float(acc.mean()),
            "per_node_acc": acc.cpu().numpy().tolist(),
        }
