"""Federated LoRA: train and exchange only the adapters (counterpart of
``p2pfl_tpu/learning/lora.py``).

BASELINE config 5. The full model stays frozen on the node; the round
payload, and the aggregators' algebra, see only the ``lora_*`` subtree
(:class:`~p2pfl_tpu_torch.models.transformer.LoRADense`): for the 0.98B
config-5 model a few MB instead of 2 GB. :class:`LoRALearner` is the
gossip Node's learner for it; ``parallel/spmd_lora.py`` runs the same
math node-stacked.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch

from p2pfl_tpu_torch.learning.learner import (
    NodeLearner, _check_structure, adam, apply_updates, ce_eval, softmax_cross_entropy,
)
from p2pfl_tpu_torch.management.logger import logger
from p2pfl_tpu_torch.models.base import apply_with_aux
from p2pfl_tpu_torch.ops.tree import tree_items, tree_leaves, tree_unflatten


def split_lora(params: dict) -> tuple[dict, dict]:
    """Split a nested-dict param tree into (lora_subtree, base_subtree)."""

    def walk(node):
        lora, base = {}, {}
        for key, val in node.items():
            if isinstance(val, dict):
                sub_l, sub_b = walk(val)
                if sub_l:
                    lora[key] = sub_l
                if sub_b:
                    base[key] = sub_b
            elif key.startswith("lora_"):
                lora[key] = val
            else:
                base[key] = val
        return lora, base

    return walk(params)


def merge_params(base: dict, overlay: dict) -> dict:
    """Recursively overlay one nested dict onto another (no copies)."""
    out = dict(base)
    for key, val in overlay.items():
        if key in out and isinstance(out[key], dict) and isinstance(val, dict):
            out[key] = merge_params(out[key], val)
        else:
            out[key] = val
    return out


def frozen_base(base: dict, dtype: torch.dtype, device: torch.device) -> dict:
    """The frozen base on ``device`` with its kernels and embedding in the
    compute dtype and everything else as is. The model casts kernels and
    the embedding to that dtype at every use, so casting once is exact
    and halves the memory; the norm scales stay fp32."""
    items = {
        path: leaf.to(device=device, dtype=dtype)
        if path.rsplit("/", 1)[-1] in ("kernel", "embed") else leaf.to(device)
        for path, leaf in tree_items(base)
    }
    return tree_unflatten(items)


def _lm_loss(lora, base, module, x, y, node_axis: bool = False):
    """Training loss + logits: mean CE plus the MoE layers' router losses
    (:func:`apply_with_aux`), as JAX's ``_lm_loss``. ``node_axis``: x, y
    and the adapters carry a leading node axis N and the loss is each
    node's, shape [N] (the MoE layers route each node's tokens apart)."""
    logits, aux = apply_with_aux(module, merge_params(base, lora), x)
    ce = softmax_cross_entropy(logits, y)
    if node_axis:
        return ce.reshape(ce.shape[0], -1).mean(1) + aux, logits
    return ce.mean() + aux, logits


def lora_train_epoch(lora: dict, opt_state, base: dict, xs: torch.Tensor, ys: torch.Tensor, module, tx):
    """One epoch of optimizer steps on the adapters over ``[nb, bs, T]``
    batches, the frozen base an input (no gradient reaches it). Returns
    ``(lora, opt_state, mean loss)`` as new tensors."""
    paths = [p for p, _ in tree_items(lora)]
    losses = []
    for b in range(xs.shape[0]):
        leaves = [x.detach().requires_grad_(True) for x in tree_leaves(lora)]
        with torch.enable_grad():
            loss, _ = _lm_loss(tree_unflatten(dict(zip(paths, leaves))), base, module, xs[b], ys[b])
            grads = torch.autograd.grad(loss, leaves)
        updates, opt_state = tx.update(tree_unflatten(dict(zip(paths, grads))), opt_state, lora)
        lora = apply_updates(lora, updates)
        losses.append(loss.detach())
    return lora, opt_state, torch.stack(losses).mean()


@torch.no_grad()
def lora_eval(lora, base, x, y, module):
    loss, logits = ce_eval(merge_params(base, lora), module, x, y)
    acc = (logits.argmax(-1) == y.long()).float().mean()
    return loss, acc


class LoRALearner(NodeLearner):
    """A Node learner whose exchanged parameters are the adapter subtree.

    ``get_parameters``, ``set_parameters`` and ``get_model_update`` speak
    the adapters only, so the aggregators, the weights codec and both
    weights planes work unchanged on the small tree. The base is frozen:
    :func:`frozen_base` of the model's (the compute-dtype copy on the
    adapters' device), never written, and merged with the adapters by
    reference at every step. ``fit`` and ``set_parameters`` bump the model
    version. No fused round (the reference's LoRA learner takes the staged
    path too): the Node runs ``evaluate`` + ``fit``.
    """

    def __init__(
        self, model, data, addr: str = "", epochs: int = 1, batch_size: int = 16,
        learning_rate: float = 1e-3, seed: int = 0,
    ) -> None:
        self.model = model
        self.module = model.module
        self.data = data
        self.addr = addr
        self.epochs = epochs
        self.batch_size = batch_size
        self.tx = adam(learning_rate)
        lora, base = split_lora(model.params)
        if not tree_leaves(lora):
            raise ValueError("model has no lora_* params: use TorchLearner instead")
        self.device = tree_leaves(lora)[0].device
        cfg = model.extra.get("config")
        self.lora = lora
        self.base = frozen_base(base, cfg.dtype if cfg is not None else torch.bfloat16, self.device)
        self.opt_state = self.tx.init(self.lora)
        self._rng = np.random.default_rng(seed)
        self._interrupt = threading.Event()
        self._steps_done = 0
        self._test: Optional[tuple] = None

    # ---- exchanged params = adapters only ----

    def set_parameters(self, params) -> None:
        _check_structure(params, self.lora)
        self.lora = params
        self.opt_state = self.tx.init(params)
        # the payload cache keys encoded bytes on the model version
        self.bump_model_version()

    def get_parameters(self):
        return self.lora

    def full_parameters(self) -> dict:
        return merge_params(self.base, self.lora)

    def set_epochs(self, epochs: int) -> None:
        self.epochs = epochs

    # ---- training ----

    def fit(self) -> None:
        from p2pfl_tpu_torch.management.profiling import dispatch_span

        self._interrupt.clear()
        for _ in range(self.epochs):
            if self._interrupt.is_set():
                logger.info(self.addr, "Training interrupted")
                return
            xs, ys = self.data.epoch_batches(self.batch_size, self._rng)
            with dispatch_span("train_epoch", self.addr, device=self.device):
                self.lora, self.opt_state, loss = lora_train_epoch(
                    self.lora, self.opt_state, self.base, torch.from_numpy(xs).to(self.device),
                    torch.from_numpy(ys).to(self.device), self.module, self.tx,
                )
            self._steps_done += xs.shape[0]
            logger.log_metric(self.addr, "train_loss", float(loss), step=self._steps_done)
        # trained adapters are new payload content
        self.bump_model_version()

    def interrupt_fit(self) -> None:
        self._interrupt.set()

    def evaluate(self) -> dict[str, float]:
        from p2pfl_tpu_torch.management.profiling import dispatch_span

        x, y = self._test_tensors()
        if len(y) == 0:
            return {}
        with dispatch_span("eval_step", self.addr, device=self.device):
            loss, acc = lora_eval(self.lora, self.base, x, y, self.module)
        return {"test_loss": float(loss), "test_acc": float(acc)}

    def get_num_samples(self) -> int:
        return self.data.num_samples
