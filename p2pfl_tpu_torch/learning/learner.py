"""Learners and their step math (counterpart of ``p2pfl_tpu/learning/learner.py``).

``adam`` and ``sgd`` follow optax's semantics (moment updates written as
optax writes them, bias correction in fp32 from a step count kept on the
device, ``eps`` outside the square root, updates scaled by ``-lr`` and
added to the params) and work elementwise, so a node-stacked ``[N, ...]``
tree steps every node at once.

:class:`TorchLearner` is the gossip Node's learner, the counterpart of
``JaxLearner``: one Adam step per batch of an epoch drawn by
``FederatedDataset.epoch_batches`` from the learner's own numpy rng (the
same draws as JAX from the same seed), and an eval step. Every step is
functional: parameters and optimizer state are replaced by new tensors,
never updated in place, because the zero-copy weights paths hand the
same tensors to other nodes (JAX's ``train_epoch`` does not donate params
for the same reason). No DP-SGD, FedProx or fused round: ``TrainStage``
takes the staged ``evaluate`` + ``fit``.
"""

from __future__ import annotations

import threading
from abc import ABC, abstractmethod
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from p2pfl_tpu_torch import resolve_device
from p2pfl_tpu_torch.learning.weights import ModelUpdate
from p2pfl_tpu_torch.management.logger import logger
from p2pfl_tpu_torch.ops.tree import tree_items, tree_leaves, tree_map, tree_structure, tree_unflatten


class AdamState(NamedTuple):
    #: int32 step count, a 0-d tensor on the params' device: the bias
    #: correction is computed there, so a step copies nothing from the host
    count: torch.Tensor
    mu: dict
    nu: dict


class GradientTransformation(NamedTuple):
    """optax's ``(init, update)`` pair; ``update(grads, state, params)``
    returns ``(updates, new_state)``."""

    init: Callable
    update: Callable


def _paths_leaves(tree: dict) -> tuple[list, list]:
    items = list(tree_items(tree))
    return [p for p, _ in items], [x for _, x in items]


def adam(
    lr: float = 1e-3, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8
) -> GradientTransformation:
    """optax's ``adam``: each arithmetic step is one ``torch._foreach_*`` op
    over every leaf (one launch for the tree on the card), in optax's
    order and rounding, so the tree steps as the per-leaf form would.
    The bias correction ``1 - b**count`` is computed on the device in
    fp32; it agrees with XLA's to an ulp (neither ``pow`` is correctly
    rounded)."""

    def init(params: dict) -> AdamState:
        zeros = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
        device = tree_leaves(params)[0].device
        count = torch.zeros((), dtype=torch.int32, device=device)
        return AdamState(count, zeros, tree_map(torch.clone, zeros))

    def update(grads: dict, state: AdamState, params=None):
        del params
        paths, g = _paths_leaves(grads)
        mu = torch._foreach_add(torch._foreach_mul(g, 1 - b1), torch._foreach_mul(tree_leaves(state.mu), b1))
        g2 = torch._foreach_mul(g, g)
        nu = torch._foreach_add(torch._foreach_mul(g2, 1 - b2), torch._foreach_mul(tree_leaves(state.nu), b2))
        count = state.count + 1
        bc1, bc2 = 1 - b1 ** count.float(), 1 - b2 ** count.float()
        den = torch._foreach_add(torch._foreach_sqrt(torch._foreach_div(nu, bc2)), eps)
        updates = torch._foreach_mul(torch._foreach_div(torch._foreach_div(mu, bc1), den), -lr)

        def tree(leaves):
            return tree_unflatten(dict(zip(paths, leaves)))

        return tree(updates), AdamState(count, tree(mu), tree(nu))

    return GradientTransformation(init, update)


def sgd(lr: float = 1e-3) -> GradientTransformation:
    """optax's ``sgd`` without momentum: updates ``-lr · g`` in the
    gradient's dtype, an empty state. SCAFFOLD's variate update assumes it."""

    def update(grads: dict, state: tuple, params=None):
        del params
        paths, g = _paths_leaves(grads)
        return tree_unflatten(dict(zip(paths, torch._foreach_mul(g, -lr)))), state

    return GradientTransformation(lambda params: (), update)


def apply_updates(params: dict, updates: dict) -> dict:
    """``p + u`` for every leaf in one foreach op, cast back to the
    param's dtype (optax's ``apply_updates``)."""
    paths, p = _paths_leaves(params)
    out = torch._foreach_add(p, tree_leaves(updates))
    return tree_unflatten({k: o.to(x.dtype) for k, o, x in zip(paths, out, p)})


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-position CE, written as optax's
    ``softmax_cross_entropy_with_integer_labels``."""
    logits = logits - logits.amax(-1, keepdim=True).detach()
    label_logits = logits.gather(-1, labels.long()[..., None])[..., 0]
    return torch.log(torch.exp(logits).sum(-1)) - label_logits


def _loss(params: dict, module, x: torch.Tensor, y: torch.Tensor):
    """Training loss and logits: mean CE plus the model's auxiliary
    losses. The JAX package adds the MoE layers' sown router losses; the
    port has no MoE layer, so the auxiliary term is 0 and the loss is the
    mean CE."""
    logits = module(params, x)
    return softmax_cross_entropy(logits, y).mean(), logits


def _prox_term(params: dict, anchor: dict, mu: float) -> torch.Tensor:
    """FedProx penalty μ/2·‖w − anchor‖², summed over leaves in fp32."""
    sq = sum(
        ((a.float() - b.float()) ** 2).sum()
        for a, b in zip(tree_leaves(params), tree_leaves(anchor))
    )
    return 0.5 * mu * sq


def ce_eval(params: dict, module, x, y):
    """Pure-CE eval loss (mean over every position) + logits."""
    logits = module(params, x)
    return softmax_cross_entropy(logits, y).mean(), logits


# ---- the gossip Node's step math ----


def loss_and_grads(params: dict, module, x: torch.Tensor, y: torch.Tensor):
    """Training loss (mean CE) and its gradient tree, by autograd through
    fresh leaves that share the params' storage (nothing is written)."""
    items = list(tree_items(params))
    leaves = [p.detach().requires_grad_(True) for _, p in items]
    logits = module(tree_unflatten({k: v for (k, _), v in zip(items, leaves)}), x)
    loss = softmax_cross_entropy(logits, y).mean()
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), tree_unflatten({k: g for (k, _), g in zip(items, grads)})


def train_epoch(params: dict, opt_state, xs: torch.Tensor, ys: torch.Tensor, module, tx):
    """One epoch of optimizer steps over ``[nb, bs, ...]`` batches;
    returns ``(params, opt_state, mean loss)`` as new tensors."""
    losses = []
    for b in range(xs.shape[0]):
        loss, grads = loss_and_grads(params, module, xs[b], ys[b])
        updates, opt_state = tx.update(grads, opt_state, params)
        params = apply_updates(params, updates)
        losses.append(loss)
    return params, opt_state, torch.stack(losses).mean()


@torch.no_grad()
def eval_step(params: dict, x: torch.Tensor, y: torch.Tensor, module):
    loss, logits = ce_eval(params, module, x, y)
    acc = (logits.argmax(-1) == y).float().mean()
    return loss, acc


class NodeLearner(ABC):
    """Template for node learners (JAX ``NodeLearner``, without the codec
    parts: wire anchors, error feedback, payload cache, materialize)."""

    @abstractmethod
    def set_parameters(self, params: Any) -> None: ...

    @abstractmethod
    def get_parameters(self) -> Any: ...

    @abstractmethod
    def set_epochs(self, epochs: int) -> None: ...

    @abstractmethod
    def fit(self) -> None: ...

    @abstractmethod
    def interrupt_fit(self) -> None: ...

    @abstractmethod
    def evaluate(self) -> dict[str, float]: ...

    @abstractmethod
    def get_num_samples(self) -> int: ...

    addr: str = ""
    #: the node's slice of a mesh (``parallel/mesh.py::node_slices``), or
    #: None for a learner on one device; the ICI weights plane reads it
    mesh: Any = None

    def set_addr(self, addr: str) -> None:
        self.addr = addr

    @property
    def model_version(self) -> int:
        """Monotone counter of the parameter content, bumped by
        ``set_parameters`` and ``fit``."""
        return getattr(self, "_model_version", 0)

    def bump_model_version(self) -> None:
        self._model_version = self.model_version + 1

    def get_model_update(self) -> ModelUpdate:
        return ModelUpdate(self.get_parameters(), [self.addr], self.get_num_samples())


def _check_structure(params, current) -> None:
    if tree_structure(params) != tree_structure(current):
        from p2pfl_tpu_torch.exceptions import ModelNotMatchingError

        raise ModelNotMatchingError("incoming params do not match model structure")


class TorchLearner(NodeLearner):
    """The gossip Node's learner: Adam epochs over the node's shard.

    The learner runs on one device: that of ``mesh``, a node's slice from
    :func:`~p2pfl_tpu_torch.parallel.mesh.node_slices` with one slot, or
    else that of the model's parameters. A slice of more than one slot
    raises (sharded learners are ROADMAP A6). As in the reference, every
    round starts a fresh optimizer (``set_parameters``).
    """

    def __init__(
        self,
        model,
        data,
        addr: str = "",
        epochs: int = 1,
        batch_size: int = 128,
        learning_rate: float = 1e-3,
        seed: int = 0,
        mesh=None,
    ) -> None:
        self.model = model
        self.module = model.module
        self.data = data
        self.addr = addr
        self.epochs = epochs
        self.batch_size = batch_size
        self.tx = adam(learning_rate)
        self.mesh = mesh
        if mesh is not None:
            slots = list(mesh.devices.flat)
            if len(slots) != 1:
                raise NotImplementedError(
                    f"a learner slice of {len(slots)} slots: sharded learners are not "
                    "ported yet (ROADMAP A6); use one slot per node"
                )
            self.device = resolve_device(slots[0])
        else:
            self.device = tree_leaves(model.params)[0].device
        self.params = tree_map(lambda p: p.to(self.device), model.params)
        self.opt_state = self.tx.init(self.params)
        self._rng = np.random.default_rng(seed)
        self._interrupt = threading.Event()
        self._steps_done = 0
        self._test: Optional[tuple] = None

    # ---- params ----

    def set_parameters(self, params) -> None:
        _check_structure(params, self.params)
        self.params = params
        self.bump_model_version()
        self.opt_state = self.tx.init(self.params)

    def get_parameters(self):
        return self.params

    def set_epochs(self, epochs: int) -> None:
        self.epochs = epochs

    # ---- training ----

    def fit(self) -> None:
        self._interrupt.clear()
        if self.epochs == 0:
            return  # test mode, like the reference's epochs=0 runs
        self.bump_model_version()
        from p2pfl_tpu_torch.management.profiling import dispatch_span

        for _ in range(self.epochs):
            if self._interrupt.is_set():
                logger.info(self.addr, "Training interrupted")
                return
            xs, ys = self.data.epoch_batches(self.batch_size, self._rng)
            with dispatch_span("train_epoch", self.addr):
                self.params, self.opt_state, loss = train_epoch(
                    self.params, self.opt_state,
                    torch.from_numpy(xs).to(self.device), torch.from_numpy(ys).to(self.device),
                    self.module, self.tx,
                )
            self._steps_done += xs.shape[0]
            logger.log_metric(self.addr, "train_loss", float(loss), step=self._steps_done)

    def interrupt_fit(self) -> None:
        self._interrupt.set()

    def evaluate(self) -> dict[str, float]:
        if self._test is None:
            x, y = self.data.test_arrays()
            self._test = (torch.from_numpy(x).to(self.device), torch.from_numpy(y).to(self.device))
        x, y = self._test
        if len(y) == 0:
            return {}
        from p2pfl_tpu_torch.management.profiling import dispatch_span

        with dispatch_span("eval_step", self.addr):
            loss, acc = eval_step(self.params, x, y, self.module)
        return {"test_loss": float(loss), "test_acc": float(acc)}

    def get_num_samples(self) -> int:
        return self.data.num_samples


class DummyLearner(NodeLearner):
    """No-ML learner for FSM/communication tests: params is ``{"w": [4]}``."""

    def __init__(self, model=None, data=None, value: float = 0.0, device=None) -> None:
        self.params = {"w": torch.full((4,), float(value), device=resolve_device(device))}
        self.epochs = 1
        self._num_samples = 10

    def set_parameters(self, params) -> None:
        _check_structure(params, self.params)
        self.params = params
        self.bump_model_version()

    def get_parameters(self):
        return self.params

    def set_epochs(self, epochs: int) -> None:
        self.epochs = epochs

    def fit(self) -> None:
        self.params = tree_map(lambda x: x + 1.0, self.params)
        self.bump_model_version()

    def interrupt_fit(self) -> None:
        pass

    def evaluate(self) -> dict[str, float]:
        return {"dummy_metric": float(self.params["w"].mean())}

    def get_num_samples(self) -> int:
        return self._num_samples
