"""Checkpoints of the port (``learning/checkpoint.py``) on the CPU: a
federation resumed from a checkpoint is the run that never stopped, bit
for bit, plain, under SCAFFOLD and under FedAdam (the JAX package checks
the restored state, ``tests/test_management.py`` and
``tests/test_fedopt_scaffold.py``; the port also resumes the round's
rngs and train set); a learner's round trip; retention under ``keep_n``
and ``Settings.CHECKPOINT_KEEP_N``; the refusals.

Each resumed run is compared with ``torch.equal``: the same kernels on
the same inputs.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from p2pfl_tpu_torch.learning import checkpoint as ckpt
from p2pfl_tpu_torch.learning.dataset import FederatedDataset
from p2pfl_tpu_torch.learning.learner import TorchLearner
from p2pfl_tpu_torch.learning.optimizers import adam, warmup_cosine_decay_schedule
from p2pfl_tpu_torch.models.vision import mlp
from p2pfl_tpu_torch.parallel.spmd import SpmdFederation
from p2pfl_tpu_torch.settings import Settings

torch.set_num_threads(2)

ALGOS = {
    "plain": {},
    "scaffold": dict(scaffold=True, optimizer="sgd", learning_rate=0.05),
    "fedadam": dict(server_opt="adam", server_lr=0.01),
    "scheduled": dict(tx=adam(warmup_cosine_decay_schedule(0.0, 3e-3, 4, 40, 1e-4)), keep_opt_state=True),
}


def _data() -> FederatedDataset:
    return FederatedDataset.synthetic_mnist(n_train=4 * 96, n_test=64)


def _fed(seed: int = 0, **kw) -> SpmdFederation:
    return SpmdFederation.from_dataset(
        mlp(seed=seed, device="cpu"), _data(), n_nodes=4, batch_size=32, vote=True, seed=2, device="cpu", **kw
    )


def _state(fed) -> list:
    state = [fed.params, fed.opt_state]
    if fed.scaffold:
        state += [fed.c_global, fed.c_local]
    if fed.server_opt:
        state += [fed.opt_m, fed.opt_v]
    return torch.utils._pytree.tree_leaves(state)


@pytest.mark.parametrize("algo", sorted(ALGOS))
def test_resume_is_the_run_that_never_stopped(tmp_path, algo):
    """Save after round 1 (with a vote in round 0), restore into a fresh
    federation of another init, and run rounds 2-3: the losses, params,
    optimizer and algorithm state equal the uninterrupted run's bit for
    bit, and the restored state sits on the federation's device."""
    Settings.TRAIN_SET_SIZE = 3
    try:
        a = _fed(**ALGOS[algo])
        a.run_round()
        a.save(str(tmp_path))
        want = [float(a.run_round()["train_loss"]) for _ in range(2)]
        b = _fed(seed=5, **ALGOS[algo])
        b.restore(str(tmp_path))
        assert b.round == 1 and np.array_equal(b.train_mask, a.train_mask) and b.train_mask.sum() == 3
        assert all(x.device.type == "cpu" for x in _state(b))
        got = [float(b.run_round()["train_loss"]) for _ in range(2)]
    finally:
        Settings.TRAIN_SET_SIZE = 4
    assert got == want
    assert all(torch.equal(x, y) for x, y in zip(_state(a), _state(b)))
    assert b._server_t == a._server_t and b.round == a.round == 3
    assert np.array_equal(a._make_perm_np(1), b._make_perm_np(1))


def test_learner_roundtrip_and_named_steps(tmp_path):
    """A learner's params and Adam state after a fit, restored into another
    learner bit for bit; a named step restores that step, the latest by
    default."""
    data = FederatedDataset.synthetic_mnist(n_train=256, n_test=64)
    learner = TorchLearner(mlp(device="cpu"), data, batch_size=64)
    ckpt.save_learner(str(tmp_path), learner, round=1)
    first = [t.clone() for t in torch.utils._pytree.tree_leaves(learner.params)]
    learner.fit()
    ckpt.save_learner(str(tmp_path), learner, round=3)
    other = TorchLearner(mlp(seed=9, device="cpu"), data, batch_size=64)
    ckpt.restore_learner(str(tmp_path), other)
    for a, b in zip(torch.utils._pytree.tree_leaves((learner.params, learner.opt_state)),
                    torch.utils._pytree.tree_leaves((other.params, other.opt_state))):
        assert torch.equal(a, b)
    assert int(other.opt_state.count) == int(learner.opt_state.count) > 0
    ckpt.restore_learner(str(tmp_path), other, step=1)
    assert all(torch.equal(a, b) for a, b in zip(first, torch.utils._pytree.tree_leaves(other.params)))
    assert ckpt.steps(str(tmp_path)) == [1, 3]


def test_retention_keep_n(tmp_path):
    """``keep_n`` newest steps survive a save; ``None`` reads
    ``Settings.CHECKPOINT_KEEP_N`` (0, the default, keeps every step)."""
    state = {"w": torch.arange(3.0)}
    for step in range(4):
        ckpt.save_state(str(tmp_path / "a"), state, step=step)
    assert ckpt.steps(str(tmp_path / "a")) == [0, 1, 2, 3]
    for step in range(5):
        ckpt.save_state(str(tmp_path / "b"), state, step=step, keep_n=2)
    assert ckpt.steps(str(tmp_path / "b")) == [3, 4]
    assert sorted(os.listdir(tmp_path / "b")) == ["3", "4"]
    Settings.CHECKPOINT_KEEP_N = 1
    try:
        for step in (7, 9):
            ckpt.save_state(str(tmp_path / "c"), state, step=step)
    finally:
        Settings.CHECKPOINT_KEEP_N = 0
    assert ckpt.steps(str(tmp_path / "c")) == [9]
    assert torch.equal(ckpt.restore_state(str(tmp_path / "c"), {"w": torch.zeros(3)})["w"], state["w"])


def test_refusals(tmp_path):
    """A directory without a checkpoint, a missing step, a half-written
    step (no state file) and a template of another structure."""
    with pytest.raises(FileNotFoundError):
        ckpt.restore_state(str(tmp_path / "none"), {"w": torch.zeros(3)})
    fed = _fed()
    with pytest.raises(FileNotFoundError):
        fed.restore(str(tmp_path / "none"))
    ckpt.save_state(str(tmp_path), {"w": torch.zeros(3)}, step=2)
    os.makedirs(tmp_path / "5")  # a step whose write never finished
    assert ckpt.steps(str(tmp_path)) == [2]
    with pytest.raises(FileNotFoundError, match="step 4"):
        ckpt.restore_state(str(tmp_path), {"w": torch.zeros(3)}, step=4)
    with pytest.raises(ValueError, match="leaves"):
        ckpt.restore_state(str(tmp_path), {"w": torch.zeros(3), "v": torch.zeros(1)})
    with pytest.raises(ValueError, match="does not match"):
        ckpt.restore_state(str(tmp_path), {"w": torch.zeros(4)})
