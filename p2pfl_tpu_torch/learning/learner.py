"""Learners and their step math (counterpart of ``p2pfl_tpu/learning/learner.py``).

``adam`` and ``sgd`` follow optax's semantics (moment updates written as
optax writes them, bias correction in fp32 from a step count kept on the
device, ``eps`` outside the square root, updates scaled by ``-lr`` and
added to the params) and work elementwise, so a node-stacked ``[N, ...]``
tree steps every node at once. ``lr`` is a float or a schedule of the
device-side step count; ``learning/optimizers.py`` builds the optimizer
zoo and the schedules on these two.

:class:`TorchLearner` is the gossip Node's learner, the counterpart of
``JaxLearner``: one Adam step per batch of an epoch drawn by
``FederatedDataset.epoch_batches`` from the learner's own numpy rng (the
same draws as JAX from the same seed), and an eval step. Every step is
functional: parameters and optimizer state are replaced by new tensors,
never updated in place, because the zero-copy weights paths hand the
same tensors to other nodes (JAX's ``train_epoch`` does not donate params
for the same reason). The staged path (``evaluate`` + ``fit``) and the
fused round (``fused_round``, ``parallel/spmd.py::fused_node_round``) run
one step function, :func:`train_step` (on the card the fused round
replays it as a captured CUDA graph), so they agree bit for bit.
"""

from __future__ import annotations

import threading
from abc import ABC, abstractmethod
from typing import Any, Callable, NamedTuple, Optional, Union

import numpy as np
import torch

from p2pfl_tpu_torch import resolve_device
from p2pfl_tpu_torch.learning.weights import ModelUpdate, PayloadCache, decode_params, restore_like
from p2pfl_tpu_torch.management.logger import logger
from p2pfl_tpu_torch.models.base import apply_with_aux
from p2pfl_tpu_torch.ops.tree import tree_items, tree_leaves, tree_map, tree_structure, tree_unflatten


class AdamState(NamedTuple):
    #: int32 step count, a 0-d tensor on the params' device: the bias
    #: correction and a schedule are computed there, so a step copies
    #: nothing from the host
    count: torch.Tensor
    mu: dict
    nu: dict


class SgdState(NamedTuple):
    """SGD's state where it has one: the step count a schedule reads and
    the momentum trace (``{}`` without momentum)."""

    count: torch.Tensor
    trace: dict


class GradientTransformation(NamedTuple):
    """optax's ``(init, update)`` pair; ``update(grads, state, params)``
    returns ``(updates, new_state)``.

    ``capturable``: every update is device work on tensor state, reading
    nothing back to the host, so a span of steps may be captured as a CUDA
    graph. The port's constructors set it; a caller's pair defaults to
    False. ``node_stacked``: the same transform over node-stacked trees
    ``[N, ...]`` where it differs (a global norm is taken per node), None
    for an elementwise transform, which steps a stacked tree as it is."""

    init: Callable
    update: Callable
    capturable: bool = False
    node_stacked: Optional["GradientTransformation"] = None


#: a learning rate: a float, or a schedule, a function of the int32 step
#: count (a 0-d tensor on the device) that returns a 0-d fp32 tensor there
LearningRate = Union[float, Callable[[torch.Tensor], torch.Tensor]]


def _paths_leaves(tree: dict) -> tuple[list, list]:
    items = list(tree_items(tree))
    return [p for p, _ in items], [x for _, x in items]


def _step_size(lr: LearningRate, count: torch.Tensor):
    """optax's ``scale_by_learning_rate``: ``-lr``, or ``-lr(count)`` from
    the count before this step (a schedule's first step reads count 0)."""
    return -lr(count) if callable(lr) else -lr


def _zero_count(params: dict) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=tree_leaves(params)[0].device)


def adam(
    lr: LearningRate = 1e-3, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
    weight_decay: float = 0.0,
) -> GradientTransformation:
    """optax's ``adam`` (``adamw`` with ``weight_decay > 0``): each
    arithmetic step is one ``torch._foreach_*`` op over every leaf (one
    launch for the tree on the card), in optax's order and rounding, so
    the tree steps as the per-leaf form would. The bias correction
    ``1 - b**count`` is computed on the device in fp32; it agrees with
    XLA's to an ulp (neither ``pow`` is correctly rounded). ``lr`` is a
    float or a schedule (:data:`LearningRate`); ``weight_decay`` adds
    ``wd · params`` to the scaled moments before the learning rate, as
    optax's ``add_decayed_weights``."""

    def init(params: dict) -> AdamState:
        zeros = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
        return AdamState(_zero_count(params), zeros, tree_map(torch.clone, zeros))

    def update(grads: dict, state: AdamState, params=None):
        paths, g = _paths_leaves(grads)
        mu = torch._foreach_add(torch._foreach_mul(g, 1 - b1), torch._foreach_mul(tree_leaves(state.mu), b1))
        g2 = torch._foreach_mul(g, g)
        nu = torch._foreach_add(torch._foreach_mul(g2, 1 - b2), torch._foreach_mul(tree_leaves(state.nu), b2))
        count = state.count + 1
        bc1, bc2 = 1 - b1 ** count.float(), 1 - b2 ** count.float()
        den = torch._foreach_add(torch._foreach_sqrt(torch._foreach_div(nu, bc2)), eps)
        updates = torch._foreach_div(torch._foreach_div(mu, bc1), den)
        if weight_decay:
            updates = torch._foreach_add(updates, torch._foreach_mul(tree_leaves(params), weight_decay))
        updates = torch._foreach_mul(updates, _step_size(lr, state.count))

        def tree(leaves):
            return tree_unflatten(dict(zip(paths, leaves)))

        return tree(updates), AdamState(count, tree(mu), tree(nu))

    return GradientTransformation(init, update, capturable=True)


def sgd(lr: LearningRate = 1e-3, momentum: Optional[float] = None, nesterov: bool = False) -> GradientTransformation:
    """optax's ``sgd``: updates ``-lr · g`` in the gradient's dtype; with
    ``momentum`` optax's ``trace`` first (``t = g + m·t``, the update ``t``,
    or ``g + m·t`` under Nesterov). Plain SGD at a constant rate keeps an
    empty state (SCAFFOLD's variate update assumes it); a schedule or
    momentum keeps :class:`SgdState`."""
    stateful = momentum is not None or callable(lr)

    def init(params: dict):
        if not stateful:
            return ()
        trace = tree_map(torch.zeros_like, params) if momentum is not None else {}
        return SgdState(_zero_count(params), trace)

    def update(grads: dict, state, params=None):
        del params
        paths, g = _paths_leaves(grads)
        if not stateful:
            return tree_unflatten(dict(zip(paths, torch._foreach_mul(g, -lr)))), state
        trace = state.trace
        if momentum is not None:
            t = torch._foreach_add(g, torch._foreach_mul(tree_leaves(state.trace), momentum))
            g = torch._foreach_add(g, torch._foreach_mul(t, momentum)) if nesterov else t
            trace = tree_unflatten(dict(zip(paths, t)))
        updates = torch._foreach_mul(g, _step_size(lr, state.count))
        return tree_unflatten(dict(zip(paths, updates))), SgdState(state.count + 1, trace)

    return GradientTransformation(init, update, capturable=True)


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
    """Training loss and logits: mean CE plus the model's auxiliary losses
    (the MoE layers' router losses, :func:`apply_with_aux`; 0 for a dense
    model), as JAX's learner."""
    logits, aux = apply_with_aux(module, params, x)
    return softmax_cross_entropy(logits, y).mean() + aux, logits


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


def loss_and_grads(params: dict, module, x: torch.Tensor, y: torch.Tensor,
                   prox_mu: float = 0.0, anchor: Optional[dict] = None):
    """Training loss (mean CE, plus FedProx's pull toward ``anchor`` when
    ``prox_mu > 0``) and its gradient tree, by autograd through fresh
    leaves that share the params' storage (nothing is written)."""
    items = list(tree_items(params))
    leaves = [p.detach().requires_grad_(True) for _, p in items]
    tree = tree_unflatten({k: v for (k, _), v in zip(items, leaves)})
    with torch.enable_grad():
        loss = softmax_cross_entropy(module(tree, x), y).mean()
        if prox_mu > 0.0:
            loss = loss + _prox_term(tree, anchor, prox_mu)
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), tree_unflatten({k: g for (k, _), g in zip(items, grads)})


def train_step(params: dict, opt_state, x: torch.Tensor, y: torch.Tensor, module, tx,
               prox_mu: float = 0.0, anchor: Optional[dict] = None):
    """One optimizer step on one batch → ``(params, opt_state, loss)`` as
    new tensors: the step of :func:`train_epoch` and of the fused round's
    captured graph (``parallel/spmd.py::CapturedTrainStep``)."""
    loss, grads = loss_and_grads(params, module, x, y, prox_mu, anchor)
    updates, opt_state = tx.update(grads, opt_state, params)
    return apply_updates(params, updates), opt_state, loss


def train_epoch(params: dict, opt_state, xs: torch.Tensor, ys: torch.Tensor, module, tx,
                prox_mu: float = 0.0, anchor: Optional[dict] = None):
    """One epoch of optimizer steps over ``[nb, bs, ...]`` batches;
    returns ``(params, opt_state, mean loss)`` as new tensors. The one
    step loop of the Node's learner: the staged ``fit`` and the fused
    round both run it. ``prox_mu > 0`` adds FedProx's
    ``μ/2·‖w − anchor‖²`` (``anchor`` defaults to the epoch's start)."""
    if prox_mu > 0.0 and anchor is None:
        anchor = params
    losses = []
    for b in range(xs.shape[0]):
        params, opt_state, loss = train_step(params, opt_state, xs[b], ys[b], module, tx, prox_mu, anchor)
        losses.append(loss)
    return params, opt_state, torch.stack(losses).mean()


@torch.no_grad()
def eval_step(params: dict, x: torch.Tensor, y: torch.Tensor, module):
    loss, logits = ce_eval(params, module, x, y)
    acc = (logits.argmax(-1) == y).float().mean()
    return loss, acc


class NodeLearner(ABC):
    """Template for node learners (JAX ``NodeLearner``)."""

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

    def fused_round(self) -> Optional[ModelUpdate]:
        """The train stage's compute as one call, or None.

        Under ``Settings.ROUND_FUSED``: evaluate the incoming model, run
        every local epoch and fold the node's own weighted partial
        aggregate in one call, returning the own :class:`ModelUpdate`
        with ``partial_acc`` set; the metrics stay device tensors, stashed
        for :meth:`pop_round_metrics`. None (the default) means this
        learner cannot fuse, and ``TrainStage`` takes the staged
        ``evaluate()`` + ``fit()`` path.
        """
        return None

    def pop_round_metrics(self) -> dict:
        """Take and clear what :meth:`fused_round` stashed:
        ``{"train_loss_series": ([E] tensor, [E] step numbers)[,
        "test_loss", "test_acc"]}``, values as device tensors; the stage's
        flush converts them once a round."""
        out = getattr(self, "_round_metrics", None) or {}
        self._round_metrics = {}
        return out

    def _test_tensors(self) -> tuple:
        """The test split on the learner's device (``self.device``), moved
        once and kept in ``self._test``."""
        if getattr(self, "_test", None) is None:
            x, y = self.data.test_arrays()
            self._test = (torch.from_numpy(x).to(self.device), torch.from_numpy(y).to(self.device))
        return self._test

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

    def payload_cache(self) -> PayloadCache:
        """The learner's shared encode-once cache (made on first use)."""
        cache = getattr(self, "_payload_cache", None)
        if cache is None:
            cache = PayloadCache(owner=self.addr)
            self._payload_cache = cache
        cache.owner = self.addr  # addr may be set after first use
        return cache

    def get_model_update(self) -> ModelUpdate:
        """The current params as an update that carries the learner's
        payload cache and model version (byte transports then encode each
        model version once, however many peers and ticks it is sent to)
        and, under topk8, the pinned wire anchor."""
        update = ModelUpdate(self.get_parameters(), [self.addr], self.get_num_samples())
        anchor = getattr(self, "_wire_anchor", None)
        if anchor is not None:
            update.anchor = anchor
            update.anchor_tag = getattr(self, "_wire_anchor_tag", None)
        update.payload_cache = self.payload_cache()
        update.cache_version = self.model_version
        return update

    def set_wire_anchor(self, params, tag: str) -> None:
        """Pin the round-start global model as topk8's delta-coding anchor.

        The stages call it where every node holds the round's shared model:
        after the init-weights sync and at each round boundary. ``tag`` is
        the round identity (``"experiment_epoch:round"``) both ends of a
        delta-coded transfer must agree on. Under any other compression the
        anchor is dropped."""
        from p2pfl_tpu_torch.settings import Settings

        if Settings.WIRE_COMPRESSION != "topk8":
            self._wire_anchor = None
            return
        self._wire_anchor = params
        self._wire_anchor_tag = tag

    def wire_anchor(self) -> tuple:
        """``(anchor tree or None, its tag or None)``."""
        return getattr(self, "_wire_anchor", None), getattr(self, "_wire_anchor_tag", None)

    def ef_residual_store(self) -> dict:
        """The node's error-feedback residual (``{path: dropped delta mass}``).

        ``TrainStage`` attaches it to the node's own contribution only, so
        exactly one encode a round folds it (repeat sends hit the cached
        bytes). Under the device producer its entries are tensors on the
        params' device, written in place by the encode; the host producer
        keeps numpy arrays. Either producer converts the other's entries
        once, and entries whose tensor changed shape or left the topk path
        are dropped at encode time. Code that mutates the dict directly
        must call :meth:`bump_model_version`, or a cached payload built
        from the old residual would be replayed."""
        if not hasattr(self, "_ef_residual"):
            self._ef_residual = {}
        return self._ef_residual

    def _decode_template(self, flat: dict):
        """The tree a decoded flat dict restores into: the parameters."""
        return self.get_parameters()

    def decode_update(self, update: ModelUpdate) -> ModelUpdate:
        """A wire update decoded against this learner's tree and wire
        anchor, its leaves on the learner's devices (a streamed transfer's
        dense leaves were decoded on arrival). Raises
        ``ModelNotMatchingError`` on a structural mismatch,
        ``DecodingParamsError`` on a malformed payload and
        ``AnchorMismatchError`` on a delta-coded payload against another
        round's anchor (or none). The result carries this learner's anchor,
        so a relay re-encodes against it."""
        if update.params is not None:
            return update
        anchor, tag = self.wire_anchor()
        if update.decoded_flat is not None:
            flat = update.decoded_flat
        else:
            device = tree_leaves(self.get_parameters())[0].device
            flat = decode_params(update.encoded, device, anchor=anchor, anchor_tag=tag)
        return ModelUpdate(
            restore_like(self._decode_template(flat), flat), list(update.contributors), update.num_samples,
            xp=update.xp, version=update.version, anchor=anchor, anchor_tag=tag,
        )


def _check_structure(params, current) -> None:
    if tree_structure(params) != tree_structure(current):
        from p2pfl_tpu_torch.exceptions import ModelNotMatchingError

        raise ModelNotMatchingError("incoming params do not match model structure")


class TorchLearner(NodeLearner):
    """The gossip Node's learner: Adam epochs over the node's shard.

    The learner runs on one device: that of ``mesh``, a node's slice from
    :func:`~p2pfl_tpu_torch.parallel.mesh.node_slices` with one slot, or
    else that of the model's parameters. A slice of more than one slot
    raises (sharded learners are ROADMAP A5). As in the reference, every
    round starts a fresh optimizer (``set_parameters``) unless
    ``keep_opt_state``. ``prox_mu > 0`` adds FedProx's pull toward the
    round's incoming model; ``dp_clip > 0`` trains by DP-SGD
    (per-example clipping, Gaussian noise of multiplier ``dp_noise``,
    an RDP accountant when there is noise). Under
    ``Settings.ROUND_FUSED`` the Node runs :meth:`fused_round`; DP-SGD
    and ``epochs == 0`` take the staged path.
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
        keep_opt_state: bool = False,
        prox_mu: float = 0.0,
        dp_clip: float = 0.0,
        dp_noise: float = 0.0,
        mesh=None,
    ) -> None:
        self.model = model
        self.module = model.module
        self.data = data
        self.addr = addr
        self.epochs = epochs
        self.batch_size = batch_size
        self.tx = adam(learning_rate)
        self.keep_opt_state = keep_opt_state
        self.prox_mu = float(prox_mu)
        self.dp_clip = float(dp_clip)
        self.dp_noise = float(dp_noise)
        if self.dp_noise > 0.0 and self.dp_clip <= 0.0:
            # noise without a clip bound has no privacy meaning, and the
            # DP path is gated on the clip: it would be ignored
            raise ValueError("dp_noise > 0 requires dp_clip > 0")
        self.accountant = None
        if self.dp_clip > 0.0 and self.dp_noise > 0.0:
            from p2pfl_tpu_torch.learning.privacy import PrivacyAccountant

            self.accountant = PrivacyAccountant(self.dp_noise, min(1.0, batch_size / max(1, data.num_samples)))
        self.mesh = mesh
        if mesh is not None:
            slots = list(mesh.devices.flat)
            if len(slots) != 1:
                raise NotImplementedError(
                    f"a learner slice of {len(slots)} slots: sharded learners are not "
                    "ported yet (ROADMAP A5, with parallel/sharding.py); use one slot per node"
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
        #: the fused round's captured step graphs, by batch shape
        self._graphs: dict = {}

    # ---- params ----

    def set_parameters(self, params) -> None:
        _check_structure(params, self.params)
        self.params = params
        self.bump_model_version()
        if not self.keep_opt_state:
            # the reference's fresh optimizer a round; keep_opt_state
            # carries the Adam moments across rounds instead
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

        # the round's incoming model: FedProx's anchor on both paths
        anchor = self.params if self.prox_mu > 0.0 else None
        for _ in range(self.epochs):
            if self._interrupt.is_set():
                logger.info(self.addr, "Training interrupted")
                return
            xs, ys = self.data.epoch_batches(self.batch_size, self._rng)
            xs_t, ys_t = torch.from_numpy(xs).to(self.device), torch.from_numpy(ys).to(self.device)
            if self.dp_clip > 0.0:
                from p2pfl_tpu_torch.learning.privacy import dp_train_epoch

                # one draw of the learner's rng seeds the epoch's noise, as
                # JAX draws its PRNG key (the noise matches in distribution)
                gen = torch.Generator(device=self.device).manual_seed(int(self._rng.integers(2**31)))
                with dispatch_span("train_epoch", self.addr, device=self.device, dp=True):
                    self.params, self.opt_state, loss = dp_train_epoch(
                        self.params, self.opt_state, xs_t, ys_t, gen, self.module, self.tx,
                        self.dp_clip, self.dp_noise, prox_mu=self.prox_mu, anchor=anchor,
                    )
                if self.accountant is not None:
                    self.accountant.step(xs.shape[0])
            else:
                with dispatch_span("train_epoch", self.addr, device=self.device):
                    self.params, self.opt_state, loss = train_epoch(
                        self.params, self.opt_state, xs_t, ys_t, self.module, self.tx,
                        prox_mu=self.prox_mu, anchor=anchor,
                    )
            self._steps_done += xs.shape[0]
            logger.log_metric(self.addr, "train_loss", float(loss), step=self._steps_done)

    def fused_round(self) -> Optional[ModelUpdate]:
        """Eval of the incoming model, every local epoch and the own
        partial fold as one call (``parallel/spmd.py::fused_node_round``):
        on a card every step one replay of a CUDA graph captured for this
        node and its batch shape, on the CPU the eager program. The returned own
        update carries ``partial_acc``; the metrics stay device tensors
        for :meth:`pop_round_metrics`.

        None for DP-SGD (its noise draws are ``fit``'s) and ``epochs ==
        0``, and after an interrupt during the batch draw (the rng
        rewound). A failed call also returns None, after rewinding the rng
        and rebuilding a freed opt state: the round takes the staged path,
        and the degradation is logged and counted (``fused_round_degraded``
        comm metric)."""
        if self.epochs == 0 or self.dp_clip > 0.0:
            return None
        from p2pfl_tpu_torch.management.profiling import dispatch_span
        from p2pfl_tpu_torch.parallel.spmd import tree_has_deleted
        from p2pfl_tpu_torch.settings import Settings

        self._interrupt.clear()
        rng_state = self._rng.bit_generator.state
        xs_eps, ys_eps = [], []
        for _ in range(self.epochs):
            xs, ys = self.data.epoch_batches(self.batch_size, self._rng)
            xs_eps.append(xs)
            ys_eps.append(ys)
        if self._interrupt.is_set():
            # interrupt_fit() landed during the draw: abort before the
            # uninterruptible call, side-effect free
            self._rng.bit_generator.state = rng_state
            logger.info(self.addr, "Training interrupted")
            return None
        x_test, y_test = self._test_tensors()
        test = (x_test, y_test) if len(y_test) > 0 else (None, None)
        # under secure aggregation the own contribution is masked before
        # it enters the aggregator: an unmasked fold would bypass the mask
        with_acc = not Settings.SECURE_AGGREGATION
        inputs = (np.stack(xs_eps), np.stack(ys_eps), float(self.get_num_samples()), *test)
        try:
            with dispatch_span("fused_round", self.addr, device=self.device, epochs=self.epochs):
                out = self._fused_call(inputs, with_acc, Settings.AGG_DTYPE)
        except Exception as exc:  # noqa: BLE001 — degrade to staged, counted and logged
            self._rng.bit_generator.state = rng_state
            if tree_has_deleted(self.opt_state):
                self.opt_state = self.tx.init(self.params)
            logger.log_comm_metric(self.addr, "fused_round_degraded")
            logger.error(
                self.addr, f"Fused round failed ({exc!r}): rng rewound, the round takes the staged path"
            )
            return None
        self.params = out["params"]
        self.opt_state = out["opt_state"]
        self.bump_model_version()
        nb = xs_eps[0].shape[0]
        base = self._steps_done
        self._steps_done += self.epochs * nb
        # the step numbers fit() logs its per-epoch losses at
        metrics = {
            "train_loss_series": (out["train_losses"], [base + (e + 1) * nb for e in range(self.epochs)])
        }
        if test[0] is not None:
            metrics["test_loss"] = out["eval_loss"]
            metrics["test_acc"] = out["eval_acc"]
        self._round_metrics = metrics
        update = self.get_model_update()
        if with_acc:
            update.partial_acc = (out["psum"], out["wsum"])
        return update

    def _fused_call(self, inputs: tuple, with_acc: bool, agg_dtype: str) -> dict:
        """Run the fused round on ``inputs`` = (xs, ys as numpy, weight,
        x_test, y_test): eagerly on the CPU; on a card with every step a
        replay of this node's captured step graph for the batch shape,
        which the first round with that shape captures."""
        from p2pfl_tpu_torch.parallel.spmd import CapturedTrainStep, fused_node_round

        kw = dict(module=self.module, tx=self.tx, prox_mu=self.prox_mu, with_acc=with_acc, agg_dtype=agg_dtype)
        xs, ys, weight, x_test, y_test = inputs
        dev = self.device
        args = (self.params, self.opt_state, torch.from_numpy(xs).to(dev), torch.from_numpy(ys).to(dev),
                torch.tensor(weight, dtype=torch.float32, device=dev), x_test, y_test)
        if dev.type != "cuda":
            return fused_node_round(*args, **kw)
        # everything the capture bakes in: the batch's shapes, the step's
        # branches, the module
        key = (xs.shape[2:], xs.dtype.str, ys.shape[2:], self.prox_mu, id(self.module))
        step = self._graphs.get(key)
        if step is None:
            from p2pfl_tpu_torch.management.telemetry import telemetry

            with telemetry.span(self.addr, "fused_graph_capture", kind="dispatch"):
                step = CapturedTrainStep(self.params, self.opt_state, args[2][0, 0], args[3][0, 0],
                                         module=self.module, tx=self.tx, prox_mu=self.prox_mu)
            self._graphs[key] = step
            logger.log_comm_metric(self.addr, "fused_graph_capture")
        else:
            logger.log_comm_metric(self.addr, "fused_graph_replay")
        return fused_node_round(*args, **kw, epoch=step.epoch)

    def interrupt_fit(self) -> None:
        self._interrupt.set()

    def evaluate(self) -> dict[str, float]:
        x, y = self._test_tensors()
        if len(y) == 0:
            return {}
        from p2pfl_tpu_torch.management.profiling import dispatch_span

        with dispatch_span("eval_step", self.addr, device=self.device):
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
