"""Sharded nodes: one federation node = a ``(data, model)`` slice
(counterpart of ``p2pfl_tpu/parallel/submesh.py``).

The global mesh (:func:`~p2pfl_tpu_torch.parallel.mesh.submesh_federation_mesh`)
is carved into N node slices (``node_slices``). Each node's params AND
optimizer state are placed by the partition-rule engine
(``parallel/sharding.py``): every leaf the rules shard is held as one
shard a slot (``SlotSharded``), so the resident state of a node is split
over its slots. Identity is the slot, not the device: on one card every
slot names ``cuda:0`` (``parallel/mesh.py``), and what this module holds
per slot is what a slice of distinct cards would hold per card.

A node's round (:func:`submesh_node_round`) is the gossip Node's fused
round (``parallel/spmd.py::fused_node_round``) with the batches gathered
on the device from the node's resident shard by the host-drawn ``perm``
and the accumulator given a leading length-1 node axis. Its steps compute
on the node's gathered tensors (one same-device copy of the params a
step) and step the optimizer shard by shard; Adam and SGD are
elementwise, so at ``model_parallel > 1`` a round gives every shard the
bits the ``model_parallel=1`` round gives the whole tensor.

Cross-slice aggregation is shard-wise: shard k of every node's
accumulator is stacked into a ``[N, *block]`` tensor
(:func:`stack_across_slices`, keyed by slot) and folded into shard k of
the aggregate (:func:`~p2pfl_tpu_torch.ops.aggregation.fedavg_fold_stacked`,
or ``robust_fold_stacked`` over the raw params for ``robust_agg``). No
fold input or output is a whole sharded leaf (checked every round,
``_assert_fold_shardings``). Diffusion places shard k of the aggregate on
slot k of every node (:func:`slice_views`: on one card the nodes' slot k
share that tensor, as it is never written in place).

Scope, as in JAX: FedAvg (+ FedProx local steps) and the robust
``"median"`` / ``"trimmed-mean"`` folds (full participation only);
``optimizer`` ``"adam"`` or ``"sgd"``. Non-elected nodes are not run and
contribute an all-zeros accumulator; under ``keep_opt_state=True`` their
optimizer state stays at its pre-round value. ``data_parallel`` is a
layout here: a node's batches run whole on its gathered tensors.
"""

from __future__ import annotations

import random
from typing import Any, Iterator, Optional, Sequence

import numpy as np
import torch

from p2pfl_tpu_torch import resolve_device
from p2pfl_tpu_torch.learning.dataset import FederatedDataset
from p2pfl_tpu_torch.learning.learner import adam, eval_step, init_opt_state, sgd
from p2pfl_tpu_torch.models.base import TorchModel
from p2pfl_tpu_torch.ops.aggregation import fedavg_fold_stacked, robust_fold_stacked
from p2pfl_tpu_torch.ops.tree import tree_items, tree_map, tree_unflatten
from p2pfl_tpu_torch.parallel.mesh import Mesh, node_slices, submesh_federation_mesh
from p2pfl_tpu_torch.parallel.sharding import (
    DEFAULT_TRANSFORMER_RULES,
    SLOT_KEY,
    PartitionRules,
    SlotSharded,
    SlotSharding,
    check_partition_rules,
    is_placed,
    place_tree,
    slot_bytes,
    tree_map_shards,
    tree_shardings,
)
from p2pfl_tpu_torch.parallel.spmd import draw_node_perms, elect_train_set_mask, fused_node_round, stage_node_shards
from p2pfl_tpu_torch.settings import Settings

Tree = Any


def _lead(leaf):
    """A leaf with a leading length-1 node axis (its shards too)."""
    if is_placed(leaf):
        sharding = SlotSharding(leaf.mesh, (None, *leaf.spec))
        return SlotSharded(sharding, (1, *leaf.shape), leaf.dtype, [s[None] for s in leaf.shards])
    return leaf[None]


@torch.no_grad()
def submesh_node_round(
    params, opt_state, x, y, perm, weight, x_test=None, y_test=None, *,
    module, tx, prox_mu: float = 0.0, with_acc: bool = True, agg_dtype: str = "float32",
) -> dict:
    """One sharded node's whole round: :func:`fused_node_round` (the
    same step loop, so ``model_parallel=1`` is the bit-parity baseline)
    with two differences, as in JAX:

    - the round's batches are gathered on the device from the node's
      resident shard ``x`` ``[S, ...]`` / ``y`` by ``perm`` ``[E, nb, bs]``
      (int32; only it crosses from the host a round);
    - ``psum``/``wsum`` come back with a leading length-1 node axis, so
      each slot's accumulator shard is block ``(i, k)`` of the
      node-stacked accumulator (:func:`stack_across_slices`).

    ``params`` may be placed (``SlotSharded`` leaves); the accumulator
    keeps their layout. ``params`` is read, never written."""
    idx = perm.reshape(-1).long()
    xs = x.index_select(0, idx).reshape(*perm.shape, *x.shape[1:])
    ys = y.index_select(0, idx).reshape(*perm.shape, *y.shape[1:])
    out = fused_node_round(
        params, opt_state, xs, ys, weight, x_test, y_test,
        module=module, tx=tx, prox_mu=prox_mu, with_acc=with_acc, agg_dtype=agg_dtype,
    )
    if with_acc:
        out["psum"] = tree_map(_lead, out["psum"])
        out["wsum"] = out["wsum"][None]
    return out


def _node_blocks(tree: Tree) -> Iterator[tuple[str, Optional[int], torch.Tensor]]:
    """``(path, slot or None, tensor)`` for every shard of a placed leaf
    and every whole tensor, in leaf order."""
    for path, leaf in tree_items(tree):
        if is_placed(leaf):
            for k, s in enumerate(leaf.shards):
                yield path, k, s
        else:
            yield path, None, leaf


def stacked_blocks(per_node: Sequence[Tree]) -> Iterator[tuple[str, Optional[int], torch.Tensor]]:
    """The node-stacked blocks, one at a time: ``(path, slot, [N, *block])``,
    block ``i`` of the stack being node ``i``'s ``[1, *block]`` shard on
    that slot. The blocks of one slot come from the same slot of every
    node; nothing is gathered across slots."""
    for parts in zip(*(_node_blocks(t) for t in per_node)):
        path, k, _ = parts[0]
        yield path, k, torch.cat([t for _, _, t in parts])


def _slot_key(k: int) -> str:
    return f"{SLOT_KEY}{k}"


def stack_across_slices(per_node: Sequence[Tree]) -> Tree:
    """Node-stacked blocks from per-slice ``[1, ...]`` trees, keyed by slot:
    the shard-flat tree ``{path: {"#k": [N, *block]}}`` (a whole
    ``[N, ...]`` tensor for a replicated leaf). The port's form of JAX's
    zero-copy assembly of the global ``P(nodes, *spec)`` array."""
    flat: dict = {}
    for path, k, t in stacked_blocks(per_node):
        flat[path if k is None else f"{path}/{_slot_key(k)}"] = t
    return tree_unflatten(flat)


def slice_views(agg: Tree, slice_mesh: Mesh, shardings: Tree) -> Tree:
    """A node's view of the aggregate: the shard-flat ``agg`` placed on
    ``slice_mesh`` by ``shardings``, shard k on slot k's device (the same
    tensor where that is the shard's device: the aggregate is never
    written in place)."""

    def one(sh: SlotSharding, x):
        if sh.mesh is not slice_mesh:
            raise ValueError("slice_views: a sharding of another slice")
        if sh.is_fully_replicated:
            return x.to(sh.devices[0])
        shards = [x[_slot_key(k)].to(d) for k, d in enumerate(sh.devices)]
        return SlotSharded(sh, sh.global_shape(shards[0].shape), shards[0].dtype, shards)

    return tree_map(one, shardings, agg)


#: resident bytes a slot, keyed by ``(mesh uid, slot)``: JAX's name for
#: the accounting behind the no-full-model check
per_device_bytes = slot_bytes


class ShardedNodeFederation:
    """N federated nodes, each a ``(data, model)`` slice — FedAvg across
    slices, shard by shard.

    The sibling of :class:`~p2pfl_tpu_torch.parallel.spmd.SpmdFederation`
    for models bigger than a card: the same election and the same perm
    rng stream (``draw_node_perms``) and ``AGG_DTYPE`` accumulator. At
    ``model_parallel > 1`` a round is the ``model_parallel=1`` round bit
    for bit while no leaf the rules shard is ever held whole in the
    federation's state or the fold.

    ``rules`` (``parallel/sharding.py``; None: the transformer defaults)
    is linted against the model and a node slice here; the same rules
    place the optimizer state. ``devices`` are the global mesh's slots in
    order (``n * data_parallel * model_parallel`` of them); None puts
    every slot on ``device`` (None: the card)."""

    def __init__(
        self,
        model: TorchModel,
        datasets: list[FederatedDataset],
        *,
        model_parallel: int = 1,
        data_parallel: int = 1,
        rules: Optional[PartitionRules] = None,
        mesh: Optional[Mesh] = None,
        devices: Optional[Sequence] = None,
        device=None,
        batch_size: int = 128,
        learning_rate: float = 1e-3,
        optimizer: str = "adam",
        vote: bool = True,
        keep_opt_state: bool = False,
        prox_mu: float = 0.0,
        seed: int = 0,
        robust_agg: Optional[str] = None,
    ) -> None:
        self.model = model
        self.module = model.module
        self.n = len(datasets)
        if self.n < 1:
            raise ValueError("need at least one dataset shard")
        if Settings.SECURE_AGGREGATION:
            raise ValueError(
                "SECURE_AGGREGATION=True has no effect inside "
                "ShardedNodeFederation: the mesh is one trust domain. Use "
                "gossip Node mode for secure aggregation."
            )
        if robust_agg not in (None, "median", "trimmed-mean"):
            raise ValueError(f"robust_agg must be None | 'median' | 'trimmed-mean', got {robust_agg!r}")
        #: robust cross-slice fold over the node-stacked PARAMS shard by
        #: shard; full participation only (run_round raises otherwise)
        self.robust_agg = robust_agg
        self.datasets = datasets
        self.batch_size = batch_size
        self.learning_rate = learning_rate
        self.prox_mu = float(prox_mu)
        self.keep_opt_state = keep_opt_state
        if optimizer not in ("adam", "sgd"):
            raise ValueError(f"optimizer must be 'adam'|'sgd', got {optimizer!r}")
        self.tx = sgd(learning_rate) if optimizer == "sgd" else adam(learning_rate)
        self._rng = np.random.default_rng(seed)
        self._py_rng = random.Random(seed)

        if mesh is None:
            if devices is None:
                devices = [resolve_device(device)] * (self.n * data_parallel * model_parallel)
            mesh = submesh_federation_mesh(self.n, model_parallel, data_parallel, devices=devices)
        nodes_axis = Settings.MESH_NODES_AXIS
        if mesh.shape.get(nodes_axis) != self.n:
            raise ValueError(f"mesh {dict(mesh.shape)} does not carry {self.n} slots on the {nodes_axis!r} axis")
        self.mesh = mesh
        self.slices = node_slices(mesh)
        self.device = resolve_device(self.slices[0].devices.flat[0])

        # partition rules: lint loudly at construction; the built-in set
        # is wider than any one model (dead rules on an MLP are by design),
        # explicit rules must be exactly right
        explicit = rules is not None
        self.rules: PartitionRules = tuple(rules) if explicit else DEFAULT_TRANSFORMER_RULES
        check_partition_rules(self.rules, model.params, self.slices[0], allow_dead=not explicit)
        self._param_shardings = [tree_shardings(s, model.params, self.rules) for s in self.slices]

        self._stage_data()
        self._stage_state()
        self._build_fold()

        self.train_mask = np.ones(self.n, dtype=np.float32)
        self._vote = vote
        self.active_mask = np.ones(self.n, dtype=np.float32)
        self.round = 0
        self.history: list[dict] = []
        #: set by run_round: {"blocks": {(path, slot): fold-input block
        #: shape}, "wsum": [N] weights (None for a robust fold)}; metadata
        #: and the tiny weight vector only, never the stacked accumulators
        self.last_fold: Optional[dict] = None

    # ---- staging ----

    def _stage_state(self) -> None:
        self.params = [
            place_tree(tree_map(lambda p, d=s.devices.flat[0]: p.to(d), self.model.params), self._param_shardings[i])
            for i, s in enumerate(self.slices)
        ]
        self.opt_state = [init_opt_state(self.tx, p) for p in self.params]

    def _stage_data(self) -> None:
        # padding/truncation/nb policy: the shared helper, so the two
        # drivers draw their perms from identical sizes
        staged = stage_node_shards(self.datasets, self.batch_size)
        self._sizes = staged["sizes"]
        self._nb = staged["nb"]

        def put(arrays, i):
            return torch.from_numpy(np.ascontiguousarray(arrays[i])).to(self.slices[i].devices.flat[0])

        # each node's shard lives on its slice once; a round ships only perm
        self._x_dev = [put(staged["x"], i) for i in range(self.n)]
        self._y_dev = [put(staged["y"], i) for i in range(self.n)]
        self._xt_dev = [put(staged["x_test"], i) for i in range(self.n)]
        self._yt_dev = [put(staged["y_test"], i) for i in range(self.n)]

    def _build_fold(self) -> None:
        #: output dtypes and whole shapes a leaf path
        self._ref_dtype = {path: x.dtype for path, x in tree_items(self.model.params)}
        self._full_shape = {path: tuple(x.shape) for path, x in tree_items(self.model.params)}
        # read OUTSIDE the fold: a setting read inside would be fixed at
        # the first fold and go stale
        self._trim = int(Settings.ASYNC_TRIM)

    def _zero_acc(self, i: int) -> tuple:
        """A non-elected node's accumulator: zeros in the node's [1, ...]
        layout (the explicit w=0 term of the SPMD masked reduce)."""
        acc = getattr(torch, Settings.AGG_DTYPE)
        psum = tree_map(_lead, tree_map_shards(lambda p: torch.zeros(p.shape, dtype=acc, device=p.device),
                                               self.params[i]))
        return psum, torch.zeros((1,), dtype=acc, device=self.slices[i].devices.flat[0])

    # ---- election / failure (host control plane, SPMD semantics) ----

    def elect_train_set(self) -> np.ndarray:
        return elect_train_set_mask(self.n, self._py_rng)

    def drop_node(self, i: int) -> None:
        self.active_mask[i] = 0.0

    def restore_node(self, i: int) -> None:
        self.active_mask[i] = 1.0

    # ---- round driver ----

    def _effective_mask(self) -> np.ndarray:
        effective = self.train_mask * self.active_mask
        if effective.sum() == 0:
            raise RuntimeError("no active train-set nodes left")
        return effective

    def _fold(self, per_node: list, wsum: Optional[torch.Tensor]) -> tuple[dict, dict]:
        """Shard by shard: stack block k of every node, fold it into block
        k of the aggregate. Returns the shard-flat aggregate and the input
        block shapes."""
        flat: dict = {}
        blocks: dict = {}
        for path, k, stacked in stacked_blocks(per_node):
            ref = torch.empty((), dtype=self._ref_dtype[path])
            if self.robust_agg is not None:
                out = robust_fold_stacked({"x": stacked}, {"x": ref}, self.robust_agg, trim=self._trim)["x"]
            else:
                out = fedavg_fold_stacked({"x": stacked}, wsum, {"x": ref})["x"]
            blocks[(path, k)] = tuple(stacked.shape)
            flat[path if k is None else f"{path}/{_slot_key(k)}"] = out
            del stacked
        return tree_unflatten(flat), blocks

    def _assert_fold_shardings(self, blocks: dict, agg: dict) -> None:
        """The no-whole-sharded-leaf contract, checked every round: every
        fold input of a leaf the rules shard is a ``[N, *block]`` stack of
        its slot shards, and every output of such a leaf is its slot
        blocks (metadata only)."""
        flat_out = dict(tree_items(agg))
        for path, sh in tree_items(self._param_shardings[0]):
            if sh.is_fully_replicated:
                continue
            block = sh.shard_shape(self._full_shape[path])
            slots = sh.mesh.devices.size
            for k in range(slots):
                got = blocks.get((path, k))
                if got is None or got != (self.n, *block):
                    raise RuntimeError(
                        f"cross-slice fold input {path} slot {k} is {got}, not the stack of its "
                        f"{block} shards — a whole sharded leaf entered the fold"
                    )
                out = flat_out.get(f"{path}/{_slot_key(k)}")
                if out is None or tuple(out.shape) != block:
                    raise RuntimeError(
                        f"cross-slice fold output {path} slot {k} is "
                        f"{None if out is None else tuple(out.shape)}, not its {block} shard"
                    )

    def run_round(self, epochs: int = 1, eval: bool = False) -> dict:  # noqa: A002
        if self._vote and (self.round == 0 or Settings.VOTE_EVERY_ROUND):
            self.train_mask = self.elect_train_set()
        perms = draw_node_perms(self._rng, self._sizes, self._nb, self.batch_size, epochs)
        eff = self._effective_mask()
        robust = self.robust_agg is not None
        if robust and not all(eff):
            raise RuntimeError(
                f"robust_agg={self.robust_agg!r} requires full participation: a rank "
                "statistic over a stack holding non-elected/dropped nodes' stale "
                "params would silently fold garbage (elect everyone, or use the FedAvg fold)"
            )
        from p2pfl_tpu_torch.management.profiling import dispatch_span

        agg_dtype = Settings.AGG_DTYPE
        psums, wsums, losses, evals = [], [], [], []
        for i in range(self.n):
            if not eff[i]:
                psum, w = self._zero_acc(i)
                psums.append(psum)
                wsums.append(w)
                continue
            dev = self.slices[i].devices.flat[0]
            xt, yt = (self._xt_dev[i], self._yt_dev[i]) if eval else (None, None)
            with dispatch_span("submesh_node_round", "spmd", device=dev, node_idx=i, epochs=epochs):
                out = submesh_node_round(
                    self.params[i], self.opt_state[i], self._x_dev[i], self._y_dev[i],
                    torch.from_numpy(perms[i]).to(dev), torch.tensor(float(self._sizes[i]), device=dev),
                    xt, yt, module=self.module, tx=self.tx, prox_mu=self.prox_mu,
                    # the robust fold reads raw params, never the accumulator
                    with_acc=not robust, agg_dtype=agg_dtype,
                )
            self.params[i] = out["params"]
            self.opt_state[i] = out["opt_state"]
            if not robust:
                psums.append(out["psum"])
                wsums.append(out["wsum"])
            losses.append(out["train_losses"])
            if eval:
                evals.append((out["eval_loss"], out["eval_acc"]))

        if robust:
            # the rank statistic runs over the raw node-stacked params
            with dispatch_span("cross_slice_robust_fold", "spmd", nodes=self.n):
                agg, blocks = self._fold([tree_map(_lead, p) for p in self.params], None)
            wsum = None
        else:
            wsum = torch.cat([w.to(wsums[0].device) for w in wsums])
            with dispatch_span("cross_slice_fold", "spmd", nodes=self.n):
                agg, blocks = self._fold(psums, wsum)
            del psums
        self._assert_fold_shardings(blocks, agg)
        self.last_fold = {"blocks": blocks, "wsum": wsum}

        # diffusion: shard k of the aggregate lands on slot k of every node
        for i in range(self.n):
            self.params[i] = slice_views(agg, self.slices[i], self._param_shardings[i])
            if not self.keep_opt_state:
                self.opt_state[i] = init_opt_state(self.tx, self.params[i])
        self.round += 1
        entry: dict = {
            "round": self.round,
            # one host sync a round
            "train_loss": float(np.mean([float(ls.float().mean()) for ls in losses])),
        }
        if eval:
            entry["test_loss"] = float(np.mean([float(lo) for lo, _ in evals]))
            entry["test_acc"] = float(np.mean([float(a) for _, a in evals]))
        self.history.append(entry)
        return entry

    def run(self, rounds: int, epochs: int = 1) -> list[dict]:
        for _ in range(rounds):
            self.run_round(epochs)
        return self.history

    # ---- evaluation / interop ----

    def evaluate(self) -> dict:
        """Per-node eval of each node's current params on its own slice."""
        accs, tlosses = [], []
        for i in range(self.n):
            loss, acc = eval_step(self.params[i], self._xt_dev[i], self._yt_dev[i], self.module)
            tlosses.append(float(loss))
            accs.append(float(acc))
        return {"test_loss": float(np.mean(tlosses)), "test_acc": float(np.mean(accs)), "per_node_acc": accs}

    def node_params(self, i: int) -> Tree:
        """One node's params (placed on its slice): the parity seam."""
        return self.params[i]

    def per_device_bytes(self) -> dict:
        """Resident params + optimizer bytes a slot, keyed by ``(mesh uid,
        slot)``: a shard on its slot, a replicated tensor on every slot of
        its node's slice."""
        out: dict = {}
        for i in range(self.n):
            out.update(per_device_bytes(self.params[i], self.opt_state[i], mesh=self.slices[i]))
        return out

    @classmethod
    def from_dataset(
        cls, model: TorchModel, dataset: FederatedDataset, n_nodes: int, strategy: str = "iid",
        alpha: float = 0.5, **kwargs,
    ) -> "ShardedNodeFederation":
        shards = [dataset.partition(i, n_nodes, strategy, alpha) for i in range(n_nodes)]
        return cls(model, shards, **kwargs)
