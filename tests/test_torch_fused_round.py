"""The gossip Node's fused round on the port, against its staged path and
against the JAX package (the twin of ``tests/test_fused_round.py``).

- Parity: ``TorchLearner.fused_round`` runs the staged path's own step
  loop, so fused == staged to 1e-6 on params and opt state (measured
  bit-equal on the CPU), with the same rng stream and a metric stash
  equal to the staged floats; and the fused round equals JAX's
  ``fused_node_round`` on the same numpy inputs within the epoch test's
  bf16/fp32 bounds.
- The fold: FedAvg from the own accumulator against the restack, the
  fold functions against JAX's, ``AGG_DTYPE`` reaching the fold.
- Dispatch budget, failure hygiene (interrupt rewind, a failed call
  degrades and is counted, an aborted round still flushes its metrics)
  and a 2-node fused federation.
"""

from __future__ import annotations

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2pfl_tpu.learning import learner as jl
from p2pfl_tpu.learning.dataset import FederatedDataset as JaxDataset
from p2pfl_tpu.models.base import FlaxModel
from p2pfl_tpu.models.vision import MLP as JaxMLP
from p2pfl_tpu.ops import aggregation as jagg
from p2pfl_tpu.parallel.spmd import fused_node_round as jax_fused_node_round
from p2pfl_tpu_torch.communication.memory import MemoryRegistry
from p2pfl_tpu_torch.convert import params_from_jax, params_to_jax
from p2pfl_tpu_torch.learning.aggregators.fedavg import FedAvg
from p2pfl_tpu_torch.learning.dataset import FederatedDataset
from p2pfl_tpu_torch.learning.learner import TorchLearner
from p2pfl_tpu_torch.learning.weights import ModelUpdate
from p2pfl_tpu_torch.management.logger import logger
from p2pfl_tpu_torch.management.profiling import (
    reset_dispatch_counts,
    snapshot_and_reset_dispatch_counts,
)
from p2pfl_tpu_torch.models.vision import MLP, mlp
from p2pfl_tpu_torch.node import Node, stop_leaked_nodes
from p2pfl_tpu_torch.ops import aggregation as tagg
from p2pfl_tpu_torch.ops.tree import tree_leaves, tree_map
from p2pfl_tpu_torch.parallel import spmd
from p2pfl_tpu_torch.settings import Settings, set_test_settings
from p2pfl_tpu_torch.utils import wait_to_finish

torch.set_num_threads(2)

LR = 1e-3
DTYPES = {"bf16": (jnp.bfloat16, torch.bfloat16), "f32": (jnp.float32, torch.float32)}


@pytest.fixture(autouse=True)
def _port_env():
    set_test_settings()
    logger.set_level("INFO")
    MemoryRegistry.reset()
    yield
    stop_leaked_nodes()
    MemoryRegistry.reset()


@pytest.fixture()
def data():
    return FederatedDataset.synthetic_mnist(n_train=512, n_test=128)


def _max_diff(a, b) -> float:
    leaves = zip(torch.utils._pytree.tree_leaves(a), torch.utils._pytree.tree_leaves(b))
    return max(float((x.double() - y.double()).abs().max()) for x, y in leaves)


def _learner(data, addr: str, epochs: int = 2, **kw) -> TorchLearner:
    return TorchLearner(mlp(seed=0, device="cpu"), data, addr=addr, batch_size=64, epochs=epochs, seed=11, **kw)


def _wait_no_learning_threads() -> None:
    # the dispatch counters are process-wide: no learning thread of an
    # earlier test may still be unwinding into them
    deadline = time.monotonic() + 10
    while any(t.name.startswith("learning-") for t in threading.enumerate()) and time.monotonic() < deadline:
        time.sleep(0.05)


# ---- parity ----


class TestFusedParity:
    @pytest.mark.parametrize("prox_mu", [0.0, 0.1])
    def test_fused_matches_staged_bitwise(self, data, prox_mu):
        """Same seed → the same params, opt state, accumulator, rng and
        metrics on both paths (plain and FedProx)."""
        staged = _learner(data, "staged", prox_mu=prox_mu)
        fused = _learner(data, "fused", prox_mu=prox_mu)
        staged_metrics = staged.evaluate()
        staged.fit()
        own = fused.fused_round()
        assert own is not None and own.partial_acc is not None
        assert _max_diff(staged.params, fused.params) <= 1e-6
        assert _max_diff(staged.opt_state, fused.opt_state) <= 1e-6
        psum, wsum = own.partial_acc
        expect = tree_map(lambda p: p.float() * float(data.num_samples), staged.params)
        assert _max_diff(expect, psum) <= 1e-4
        assert float(wsum) == float(data.num_samples)
        assert staged._rng.bit_generator.state == fused._rng.bit_generator.state
        stash = fused.pop_round_metrics()
        assert float(stash["test_loss"]) == pytest.approx(staged_metrics["test_loss"], abs=1e-6)
        assert float(stash["test_acc"]) == pytest.approx(staged_metrics["test_acc"], abs=1e-6)
        losses, steps = stash["train_loss_series"]
        assert len(losses) == fused.epochs == len(steps)
        assert steps[-1] == fused._steps_done == staged._steps_done
        staged_series = [
            v for per_round in logger.get_local_logs().get("unknown-exp", {}).values()
            for addr, metrics in per_round.items() if addr == "staged"
            for v in metrics.get("train_loss", [])
        ]
        assert [s for s, _ in staged_series][-fused.epochs:] == steps
        np.testing.assert_array_equal([v for _, v in staged_series][-fused.epochs:], losses.tolist())
        assert fused.pop_round_metrics() == {}

    @pytest.mark.parametrize("dtype", sorted(DTYPES))
    def test_fused_round_matches_jax(self, dtype):
        """The port's ``fused_node_round`` against JAX's on the same numpy
        batches, init and test set (2 epochs of 8 Adam steps, weight 512).
        The eval metrics and the first epoch's loss to 1e-5 relative in
        fp32 and 1e-3 in bf16 (the epoch test's bounds); the second
        epoch starts from params that already differ by Adam's sign flips,
        so its loss is held to 1e-5 / 5e-3 (bf16 measured 1.7e-3);
        params within 2·lr·steps each and a mean far below one step
        (the epoch test's bounds: Adam turns rounding noise on near-zero
        gradients into up to lr a step); the accumulator is weight ×
        those params."""
        jdt, tdt = DTYPES[dtype]
        jm = FlaxModel.create(JaxMLP(dtype=jdt), (28, 28, 1), seed=1)
        tparams = params_from_jax(jax.tree.map(np.asarray, jm.params), device="cpu")
        module = MLP(dtype=tdt)
        jdata = JaxDataset.synthetic_mnist(n_train=512, n_test=128, seed=0)
        rng = np.random.default_rng(3)
        batches = [jdata.epoch_batches(64, rng) for _ in range(2)]
        xs = np.stack([b[0] for b in batches])
        ys = np.stack([b[1] for b in batches])
        x_test, y_test = jdata.test_arrays()
        jtx, ttx = jl.adam(LR), spmd.adam(LR)
        jout = jax_fused_node_round(
            jm.params, jtx.init(jm.params), jnp.asarray(xs), jnp.asarray(ys), jnp.float32(512.0),
            jnp.asarray(x_test), jnp.asarray(y_test), module=jm.module, tx=jtx,
        )
        tout = spmd.fused_node_round(
            tparams, ttx.init(tparams), torch.from_numpy(xs), torch.from_numpy(ys), torch.tensor(512.0),
            torch.from_numpy(x_test), torch.from_numpy(y_test), module=module, tx=ttx,
        )
        rtol = 1e-5 if dtype == "f32" else 1e-3
        for e, epoch_rtol in enumerate((rtol, 1e-5 if dtype == "f32" else 5e-3)):
            np.testing.assert_allclose(float(tout["train_losses"][e]), float(jout["train_losses"][e]),
                                       rtol=epoch_rtol)
        np.testing.assert_allclose(float(tout["eval_loss"]), float(jout["eval_loss"]), rtol=rtol)
        assert float(tout["eval_acc"]) == pytest.approx(float(jout["eval_acc"]), abs=1e-6)
        steps = xs.shape[0] * xs.shape[1]
        for key, scale in (("params", 1.0), ("psum", 512.0)):
            port = params_to_jax(tout[key])
            pairs = [(np.asarray(a, np.float32), b.astype(np.float32))
                     for a, b in zip(jax.tree.leaves(jout[key]), jax.tree.leaves(port))]
            assert max(np.abs(a - b).max() for a, b in pairs) <= 2 * LR * steps * scale
            mean = np.mean([np.abs(a - b).mean() for a, b in pairs])
            assert mean <= (1e-6 if dtype == "f32" else 1e-4) * scale, (key, mean)
        assert float(tout["wsum"]) == float(jout["wsum"]) == 512.0

    def test_fold_respects_agg_dtype(self, data, monkeypatch):
        """A non-default AGG_DTYPE reaches the fused fold: the accumulator
        is built in it."""
        monkeypatch.setattr(Settings, "AGG_DTYPE", "float64")
        own = _learner(data, "dtyped").fused_round()
        assert own is not None and own.partial_acc is not None
        psum, wsum = own.partial_acc
        assert all(leaf.dtype == torch.float64 for leaf in tree_leaves(psum))
        assert wsum.dtype == torch.float64

    def test_interrupt_during_batch_draw_aborts(self, data):
        """interrupt_fit() landing during the batch draw aborts the fused
        round side-effect free (rng rewound, params untouched)."""
        learner = _learner(data, "interrupted")
        rng_before = learner._rng.bit_generator.state
        params_before = learner.params
        orig = learner.data.epoch_batches

        def draw_then_interrupt(*a, **k):
            learner.interrupt_fit()
            return orig(*a, **k)

        learner.data.epoch_batches = draw_then_interrupt
        try:
            assert learner.fused_round() is None
        finally:
            learner.data.epoch_batches = orig
        assert learner._rng.bit_generator.state == rng_before
        assert learner.params is params_before

    def test_fused_round_declines_dp_and_test_mode(self, data):
        """DP-SGD (its noise draws are fit()'s) and epochs == 0 take the
        staged path, as in JAX."""
        assert _learner(data, "dp", dp_clip=1.0).fused_round() is None
        assert _learner(data, "zero", epochs=0).fused_round() is None

    def test_fedavg_fold_matches_restack(self, data):
        """FedAvg from the own accumulator == FedAvg from restacked params."""
        own_learner = _learner(data, "own")
        own = own_learner.fused_round()
        assert own is not None and own.partial_acc is not None
        peer = ModelUpdate(tree_map(lambda p: p + 0.25, own_learner.params), ["peer"], 300)
        agg = FedAvg("own")
        folded = agg.aggregate([own, peer])
        restacked = agg.aggregate([ModelUpdate(own.params, own.contributors, own.num_samples), peer])
        assert _max_diff(folded.params, restacked.params) <= 1e-5
        assert folded.num_samples == restacked.num_samples
        assert folded.contributors == restacked.contributors

    def test_fold_functions_match_jax(self):
        """``fedavg_fold_acc`` (with 0 and 2 peers) and
        ``fedavg_fold_stacked`` against JAX's on the same fp32 inputs:
        the same accumulate-then-divide order, within 1e-6 (measured
        bit-equal)."""
        rng = np.random.default_rng(0)
        tree = {"a": {"kernel": rng.normal(size=(6, 5)).astype(np.float32)}, "b": rng.normal(size=(7,)).astype(np.float32)}
        peers = [jax.tree.map(lambda x, i=i: (x + 0.1 * (i + 1)).astype(np.float32), tree) for i in range(2)]
        psum = jax.tree.map(lambda x: x * np.float32(300.0), tree)
        w = np.asarray([100.0, 50.0], np.float32)
        t = lambda tr: tree_map(torch.from_numpy, tr)  # noqa: E731
        for k in (0, 2):
            want = jagg.fedavg_fold_acc(psum, jnp.float32(300.0), tuple(peers[:k]), jnp.asarray(w[:k]), tree)
            got = tagg.fedavg_fold_acc(t(psum), torch.tensor(300.0), tuple(t(p) for p in peers[:k]),
                                       torch.from_numpy(w[:k]), t(tree))
            for a, b in zip(jax.tree.leaves(want), tree_leaves(got)):
                np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6, rtol=0)
        stacked = jax.tree.map(lambda *xs: np.stack(xs), tree, *peers)
        ws = np.asarray([300.0, 100.0, 50.0], np.float32)
        want = jagg.fedavg_fold_stacked(stacked, jnp.asarray(ws), tree)
        got = tagg.fedavg_fold_stacked(t(stacked), torch.from_numpy(ws), t(tree))
        for a, b in zip(jax.tree.leaves(want), tree_leaves(got)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6, rtol=0)

    def test_staged_path_reachable_behind_flag(self, monkeypatch):
        """ROUND_FUSED=False routes TrainStage through evaluate()+fit():
        the learner's fused entry point is never consulted."""
        calls = []
        monkeypatch.setattr(Settings, "ROUND_FUSED", False)
        orig = TorchLearner.fused_round
        monkeypatch.setattr(TorchLearner, "fused_round", lambda self: calls.append("x") or orig(self))
        full = FederatedDataset.synthetic_mnist(n_train=256, n_test=64)
        nodes = [Node(learner=_learner(full.partition(i, 2), f"n{i}", epochs=1)) for i in range(2)]
        try:
            for n in nodes:
                n.start()
            nodes[0].connect(nodes[1].addr)
            time.sleep(0.5)
            nodes[0].set_start_learning(rounds=1, epochs=1)
            wait_to_finish(nodes, timeout=60)
        finally:
            for n in nodes:
                n.stop()
        assert calls == []
        assert _max_diff(nodes[0].learner.get_parameters(), nodes[1].learner.get_parameters()) <= 1e-6


    def test_fused_rounds_from_threads_match_sequential(self, data):
        """Four learners' fused rounds at once from four threads (a short
        switch interval forces interleaving) end bit-equal to the same
        rounds run one learner at a time: the round program shares no
        state across learners."""
        import sys

        shards = [data.partition(i, 4) for i in range(4)]

        def fleet():
            return [TorchLearner(mlp(seed=i, device="cpu"), shards[i], addr=f"t{i}", batch_size=32, seed=i)
                    for i in range(4)]

        def rounds(learner, errors):
            try:
                for _ in range(3):
                    assert learner.fused_round() is not None
                    learner.set_parameters(learner.get_parameters())
            except Exception as exc:  # noqa: BLE001 — reported below
                errors.append(exc)

        sequential, errors = fleet(), []
        for learner in sequential:
            rounds(learner, errors)
        threaded = fleet()
        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        try:
            threads = [threading.Thread(target=rounds, args=(lr, errors)) for lr in threaded]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
        finally:
            sys.setswitchinterval(interval)
        assert not any(t.is_alive() for t in threads) and not errors, errors
        for a, b in zip(sequential, threaded):
            assert _max_diff(a.params, b.params) == 0.0
            assert a._rng.bit_generator.state == b._rng.bit_generator.state


# ---- dispatch budget ----


class TestDispatchBudget:
    def test_fused_round_two_dispatches_vs_staged(self, data):
        """Fused: ≤ 2 model-plane dispatches a round (the round and one
        aggregate). Staged: ≥ epochs + 2 (an eval, one a epoch, the
        aggregate), at 5 epochs ≥ 3x the fused count."""
        epochs = 5

        def one_round(learner, agg, fused: bool):
            agg.set_nodes_to_aggregate([learner.addr, "peer"])
            own = learner.fused_round() if fused else None
            if own is None:
                learner.evaluate()
                learner.fit()
                own = learner.get_model_update()
            agg.add_model(own)
            agg.add_model(ModelUpdate(tree_map(lambda p: p + 0.1, learner.params), ["peer"], 100))
            return agg.wait_and_get_aggregation(timeout=1)

        _wait_no_learning_threads()
        reset_dispatch_counts()
        one_round(_learner(data, "staged-n", epochs=epochs), FedAvg("staged-n"), fused=False)
        staged_counts = snapshot_and_reset_dispatch_counts()
        staged_total = sum(staged_counts.values())
        assert staged_total >= epochs + 2, staged_counts
        one_round(_learner(data, "fused-n", epochs=epochs), FedAvg("fused-n"), fused=True)
        fused_counts = snapshot_and_reset_dispatch_counts()
        fused_total = sum(fused_counts.values())
        assert fused_total <= 2, fused_counts
        assert staged_total >= 3 * fused_total, (staged_counts, fused_counts)

    def test_per_node_dispatch_comm_metric(self, data):
        learner = _learner(data, "metered")
        logger.reset_comm_metrics()
        assert learner.fused_round() is not None
        assert logger.get_comm_metrics("metered").get("device_dispatch") == 1.0


# ---- failure hygiene ----


class TestFailureHygiene:
    def test_failed_fused_dispatch_degrades_to_staged(self, data, monkeypatch):
        """A call that dies after freeing the opt state's storage returns
        None (the staged path takes the round), rewinds the rng, rebuilds
        the opt state and counts the degradation."""
        learner = _learner(data, "crashy")
        rng_before = learner._rng.bit_generator.state

        def boom(params, opt_state, *a, **k):
            for leaf in torch.utils._pytree.tree_leaves(opt_state):
                leaf.untyped_storage().resize_(0)
            raise RuntimeError("mid-call failure")

        monkeypatch.setattr(spmd, "fused_node_round", boom)
        logger.reset_comm_metrics()
        assert learner.fused_round() is None
        assert learner._rng.bit_generator.state == rng_before
        assert not spmd.tree_has_deleted(learner.opt_state)
        assert logger.get_comm_metrics("crashy").get("fused_round_degraded") == 1.0
        monkeypatch.undo()
        learner.fit()  # the staged fallback trains on the rebuilt state
        assert int(learner.opt_state.count) == learner._steps_done

    def test_tree_has_deleted(self):
        tree = {"a": torch.ones(3), "b": {"c": torch.zeros(2)}}
        assert not spmd.tree_has_deleted(tree)
        tree["b"]["c"].untyped_storage().resize_(0)
        assert spmd.tree_has_deleted(tree)
        assert not spmd.tree_has_deleted({"empty": torch.zeros(0)})

    def test_aborted_round_still_flushes_metrics(self, data):
        """A round that trained but dies before RoundFinishedStage still
        publishes its train_loss series (the workflow's exit flush)."""
        node = Node(learner=_learner(data, "unused-addr", epochs=1))
        node.start()
        try:

            def boom(_n, stage_name):
                if stage_name == "RoundFinishedStage":
                    raise RuntimeError("injected stage failure")

            node.stage_hooks.append(boom)
            node.set_start_learning(rounds=1, epochs=1)
            deadline = time.monotonic() + 60
            time.sleep(0.3)
            while node.learning_active() and time.monotonic() < deadline:
                time.sleep(0.1)
            assert not node.learning_active()
            per_round = logger.get_local_logs().get(node.experiment_name, {})
            found = [
                series for per_node in per_round.values()
                for addr, metrics in per_node.items() if addr == node.addr
                for name, series in metrics.items() if name == "train_loss"
            ]
            assert found, "the aborted round's train_loss series was dropped"
        finally:
            node.stop()


# ---- end to end ----


class TestFusedFederationE2E:
    def test_two_node_fused_round_converges(self):
        """A 2-node overlay federation on the fused path: 2 rounds of 2
        epochs, 4 fused rounds and no staged epoch, both nodes on one
        aggregate, the metrics flushed into the local store."""
        assert Settings.ROUND_FUSED  # the test settings' default
        full = FederatedDataset.synthetic_mnist(n_train=512, n_test=128)
        nodes = [Node(learner=_learner(full.partition(i, 2), f"e2e{i}", epochs=2)) for i in range(2)]
        try:
            for n in nodes:
                n.start()
            nodes[0].connect(nodes[1].addr)
            time.sleep(0.5)
            _wait_no_learning_threads()
            reset_dispatch_counts()
            nodes[0].set_start_learning(rounds=2, epochs=2)
            wait_to_finish(nodes, timeout=90)
            counts = snapshot_and_reset_dispatch_counts()
            assert counts.get("fused_round") == 4, counts
            assert counts.get("train_epoch") is None, counts
            assert _max_diff(nodes[0].learner.get_parameters(), nodes[1].learner.get_parameters()) <= 1e-6
            found = {
                metric for rounds in logger.get_local_logs().values()
                for per_node in rounds.values() for metrics in per_node.values() for metric in metrics
            }
            assert "train_loss" in found
        finally:
            for n in nodes:
                n.stop()
