"""One-program federation state machine (subset of ``p2pfl_tpu/parallel/spmd.py``).

The JAX package runs N federated nodes as one SPMD program over a device
mesh. The port runs them on one device with the node axis written out as
the leading tensor dimension: node-stacked state ``[N, ...]``, one batched
forward/backward per local step, FedAvg as a weighted reduction over that
axis. The host-side control plane (shard staging, the per-round shuffle
streams, the reference vote) is the JAX package's, copied so the same
seed consumes the numpy and Python rng streams identically.

Ported here: what :class:`~p2pfl_tpu_torch.parallel.spmd_lora.SpmdLoraFederation`
uses. The full-model rounds (``_local_epoch``, ``spmd_rounds_fused``, the
MNIST main path), the robust aggregators, FedProx, SCAFFOLD, FedOpt and
DP-SGD are the next slices (ROADMAP Queue A 2 and 6).
"""

from __future__ import annotations

import math
import random

import numpy as np
import torch

from p2pfl_tpu_torch import resolve_device
from p2pfl_tpu_torch.learning.dataset import FederatedDataset
from p2pfl_tpu_torch.learning.learner import adam
from p2pfl_tpu_torch.models.base import TorchModel
from p2pfl_tpu_torch.ops.tree import tree_map
from p2pfl_tpu_torch.settings import Settings

_AGGREGATORS = ("fedavg", "median", "trimmed_mean", "krum", "bulyan", "clip")


def _aggregate(p_used: dict, mask, weights, agg: str) -> dict:
    """Combine node-stacked params [N, ...] into one model (fp32 accumulate).

    FedAvg weights are the sample counts under the train-set mask. The
    robust aggregators (and the selected-row index and trim count they
    read) are not ported yet."""
    if agg != "fedavg":
        raise NotImplementedError(
            f"aggregator {agg!r} is not ported yet (ROADMAP Queue A 6: SPMD breadth)"
        )
    w = (mask * weights).to(torch.float32)
    wn = w / w.sum()
    return tree_map(
        lambda x: torch.tensordot(wn, x.to(torch.float32), dims=([0], [0])).to(x.dtype),
        p_used,
    )


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


class SpmdFederation:
    """N federated nodes stacked on one device's leading tensor axis.

    The state machine of the JAX class (election, masks, shuffles, node
    failure, fused spans). Subclasses stage the node-stacked state
    (``_stage_state``) and run the rounds.
    """

    def __init__(
        self,
        model: TorchModel,
        datasets: list[FederatedDataset],
        batch_size: int = 128,
        learning_rate: float = 1e-3,
        aggregator: str = "fedavg",
        vote: bool = True,
        keep_opt_state: bool = False,
        participation: float = 1.0,
        seed: int = 0,
        device=None,
    ) -> None:
        self.device = resolve_device(device)
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
        if aggregator not in _AGGREGATORS:
            raise ValueError(f"unknown aggregator {aggregator!r}")
        if aggregator != "fedavg":
            raise NotImplementedError(
                f"aggregator {aggregator!r} is not ported yet (ROADMAP Queue A 6)"
            )
        if not 0.0 < participation <= 1.0:
            raise ValueError("participation must be in (0, 1]")
        self.datasets = datasets
        self.batch_size = batch_size
        self.tx = adam(learning_rate)
        self.aggregator = aggregator
        self.keep_opt_state = keep_opt_state
        self.participation = participation
        self._rng = np.random.default_rng(seed)
        self._py_rng = random.Random(seed)

        self._stage_data()
        # node-stacked state: every node starts from the same params
        self._stage_state()

        # election state (round-0 vote, reused thereafter — reference quirk)
        self.train_mask = np.ones(self.n, dtype=np.float32)
        self._vote = vote
        # node failure = masking the slot out of training and aggregation
        self.active_mask = np.ones(self.n, dtype=np.float32)
        self.round = 0
        self.history: list[dict] = []

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
        raise NotImplementedError(
            "full-model SpmdFederation rounds are the next slice (ROADMAP Queue A 2); "
            "use SpmdLoraFederation"
        )

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

    def drop_node(self, i: int) -> None:
        """Mark a logical node failed: it stops training and contributing
        (the reference's heartbeat-eviction outcome)."""
        self.active_mask[i] = 0.0

    def restore_node(self, i: int) -> None:
        self.active_mask[i] = 1.0

    def _fused_inputs(self, rounds: int, epochs: int):
        """Guards + device inputs of a fused span: ``(perms [R, N, epochs,
        nb, bs], mask)``. A span needs one fixed mask."""
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
        return perms, torch.from_numpy(self._effective_mask()).to(self.device)

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
