"""Federated dataset: synthetic tasks, per-node partitioning, batching.

A copy of the numpy-only parts of ``p2pfl_tpu/learning/dataset.py`` that
the ported slices use: the same seed gives bit-identical arrays and the
same rng gives bit-identical epoch batches in both packages (held by
``tests/test_torch_spmd_lora.py`` and ``tests/test_torch_node.py``). Data
stays numpy; learners move it to the device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class FederatedDataset:
    """One node's data shard (or the full dataset before partitioning)."""

    x_train: np.ndarray
    y_train: np.ndarray
    x_test: np.ndarray
    y_test: np.ndarray
    num_classes: int = 10
    #: data provenance ("synthetic" | "idx"), recorded by benchmarks
    source: str = "synthetic"

    @classmethod
    def synthetic_mnist(
        cls,
        n_train: int = 60_000,
        n_test: int = 10_000,
        num_classes: int = 10,
        dim: tuple[int, ...] = (28, 28, 1),
        seed: int = 31,
        noise: float = 0.35,
        modes: int = 1,
        proto_scale: float = 1.0,
    ) -> "FederatedDataset":
        """MNIST-shaped classification: class prototypes (``modes`` per
        class) plus Gaussian noise, squashed to [0, 1]. Downloads nothing."""
        rng = np.random.default_rng(seed)
        d = int(np.prod(dim))
        protos = rng.normal(0.0, proto_scale, size=(num_classes, modes, d)).astype(np.float32)

        def make(n: int, split_seed: int):
            r = np.random.default_rng(seed + split_seed)
            y = r.integers(0, num_classes, size=n)
            if modes > 1:
                mode = r.integers(0, modes, size=n)
            else:
                mode = np.zeros(n, dtype=np.int64)
            x = protos[y, mode] + r.normal(0.0, noise, size=(n, d)).astype(np.float32)
            x = 1.0 / (1.0 + np.exp(-x))  # pixel-like range
            return x.reshape((n, *dim)).astype(np.float32), y.astype(np.int32)

        x_tr, y_tr = make(n_train, 1)
        x_te, y_te = make(n_test, 2)
        return cls(x_tr, y_tr, x_te, y_te, num_classes)

    @classmethod
    def synthetic_lm(
        cls,
        vocab_size: int = 2048,
        seq_len: int = 128,
        n_train: int = 2048,
        n_test: int = 256,
        determinism: float = 0.9,
        seed: int = 17,
        shift_frac: float = 0.0,
        shift_seed: Optional[int] = None,
    ) -> "FederatedDataset":
        """Next-token prediction over a near-deterministic Markov chain.

        Each token maps to a fixed successor with probability ``determinism``
        (uniform otherwise). x = tokens, y = tokens shifted left.
        ``shift_frac`` re-deranges that fraction of the successor table
        (from ``shift_seed``): the domain shift LoRA fine-tuning closes.
        """
        rng = np.random.default_rng(seed)
        succ = rng.permutation(vocab_size)  # deterministic successor table
        if shift_frac > 0.0:
            r2 = np.random.default_rng(seed + 1000 if shift_seed is None else shift_seed)
            k = max(2, int(round(shift_frac * vocab_size)))
            idx = r2.choice(vocab_size, size=k, replace=False)
            # cyclic rotation: every selected token's successor changes
            succ[idx] = np.roll(succ[idx], 1)

        def make(n: int, split_seed: int):
            r = np.random.default_rng(seed + split_seed)
            toks = np.empty((n, seq_len + 1), dtype=np.int32)
            toks[:, 0] = r.integers(0, vocab_size, size=n)
            for t in range(seq_len):
                follow = r.random(n) < determinism
                rand = r.integers(0, vocab_size, size=n)
                toks[:, t + 1] = np.where(follow, succ[toks[:, t]], rand)
            return toks[:, :-1], toks[:, 1:].astype(np.int32)

        x_tr, y_tr = make(n_train, 1)
        x_te, y_te = make(n_test, 2)
        return cls(x_tr, y_tr, x_te, y_te, vocab_size)

    def partition(
        self,
        sub_id: int,
        n_parts: int,
        strategy: str = "iid",
        alpha: float = 0.5,
        seed: int = 0,
        test_strategy: Optional[str] = None,
    ) -> "FederatedDataset":
        """Extract shard ``sub_id`` of ``n_parts`` (``iid`` | ``sorted`` |
        ``dirichlet``); the test split defaults to ``iid``."""
        tr = _partition_indices(self.y_train, sub_id, n_parts, strategy, alpha, seed)
        te = _partition_indices(
            self.y_test, sub_id, n_parts, test_strategy or "iid", alpha, seed
        )
        return FederatedDataset(
            self.x_train[tr], self.y_train[tr], self.x_test[te], self.y_test[te],
            self.num_classes, source=self.source,
        )

    @property
    def num_samples(self) -> int:
        return len(self.y_train)

    def epoch_batches(self, batch_size: int, rng: np.random.Generator) -> tuple[np.ndarray, np.ndarray]:
        """One shuffled epoch as ``[nb, bs, ...]`` arrays (remainder dropped)."""
        n = len(self.y_train)
        nb = max(n // batch_size, 1)
        take = min(nb * batch_size, n)
        perm = rng.permutation(n)[:take]
        xs = self.x_train[perm].reshape(nb, -1, *self.x_train.shape[1:])
        ys = self.y_train[perm].reshape(nb, -1, *self.y_train.shape[1:])
        return xs, ys

    def test_arrays(self) -> tuple[np.ndarray, np.ndarray]:
        return self.x_test, self.y_test


def _partition_indices(
    y: np.ndarray, sub_id: int, n_parts: int, strategy: str, alpha: float, seed: int
) -> np.ndarray:
    n = len(y)
    if not 0 <= sub_id < n_parts:
        raise ValueError(f"sub_id {sub_id} out of range for {n_parts} parts")
    if strategy == "iid":
        size = n // n_parts
        return np.arange(sub_id * size, (sub_id + 1) * size if sub_id < n_parts - 1 else n)
    if strategy == "sorted":
        order = np.argsort(y, kind="stable")
        size = n // n_parts
        lo = sub_id * size
        hi = (sub_id + 1) * size if sub_id < n_parts - 1 else n
        return order[lo:hi]
    if strategy == "dirichlet":
        rng = np.random.default_rng(seed)
        classes = np.unique(y)
        # same proportions matrix on every node (shared seed) → consistent split
        props = rng.dirichlet([alpha] * n_parts, size=len(classes))  # [C, parts]
        own: list[np.ndarray] = []
        for ci, c in enumerate(classes):
            idx = np.flatnonzero(y == c)
            rng_c = np.random.default_rng(seed + 1000 + int(c))
            idx = rng_c.permutation(idx)
            bounds = (np.cumsum(props[ci]) * len(idx)).astype(np.int64)
            lo = 0 if sub_id == 0 else bounds[sub_id - 1]
            own.append(idx[lo : bounds[sub_id]])
        out = np.concatenate(own) if own else np.empty(0, dtype=np.int64)
        return np.sort(out)
    raise ValueError(f"unknown partition strategy: {strategy}")
