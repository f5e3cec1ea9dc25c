"""The port's ``ChunkedFederation`` (``parallel/chunked.py``) on the CPU:
the ten tests of ``tests/test_chunked.py`` on the port, its rounds
against the JAX package's ``ChunkedFederation`` in every mode, and a
reduced ResNet under ``remat``.

Against JAX, both start from flax's init of the fp32 MLP
(``convert.py::params_from_jax``) on the same data and seed, 2 rounds at
lr 1e-2. Adam turns an element whose gradient sits at rounding noise
into a ±lr step whichever side of zero it lands, so every element is
held within 2·lr a step taken and the mean difference to 1e-5 (the bound
of ``test_torch_spmd.py``'s Adam rounds); averaged moments to 1e-4 of
their scale; the loss to 1e-4 relative. Within the port the execution
strategies (fused or serial reduce, staging depth, in-place or fresh
accumulators, resident or streamed data) give the same bits.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from p2pfl_tpu.learning.dataset import FederatedDataset as JaxDataset
from p2pfl_tpu.models.base import FlaxModel
from p2pfl_tpu.models.vision import MLP as JaxMLP
from p2pfl_tpu.parallel import ChunkedFederation as JaxChunked
from p2pfl_tpu.settings import Settings as JaxSettings
from p2pfl_tpu_torch.convert import params_from_jax
from p2pfl_tpu_torch.examples.bench_mnist import HARD_TASK
from p2pfl_tpu_torch.learning.dataset import FederatedDataset
from p2pfl_tpu_torch.learning.learner import adam
from p2pfl_tpu_torch.learning.optimizers import warmup_cosine_decay_schedule
from p2pfl_tpu_torch.models.base import TorchModel
from p2pfl_tpu_torch.models.vision import MLP, ResNet, init_resnet_params, mlp
from p2pfl_tpu_torch.ops.tree import tree_leaves
from p2pfl_tpu_torch.parallel import ChunkedFederation
from p2pfl_tpu_torch.parallel.spmd import SpmdFederation
from p2pfl_tpu_torch.settings import Settings

torch.set_num_threads(2)

LR = 1e-2


@pytest.fixture(autouse=True)
def _restore_round_knobs():
    yield
    for s in (Settings, JaxSettings):
        s.CHUNK_STAGING_DEPTH = 2
        s.CHUNK_FUSED_REDUCE = True
        s.CHUNK_DONATE_BUFFERS = True


def _data(n_train=256, seed=5):
    return FederatedDataset.synthetic_mnist(n_train=n_train, n_test=64, seed=seed)


def _max_diff(a, b) -> float:
    return max(float((x.float() - y.float()).abs().max())
               for x, y in zip(torch.utils._pytree.tree_leaves(a), torch.utils._pytree.tree_leaves(b)))


def _counts(opt_state) -> list:
    return [int(x) for x in torch.utils._pytree.tree_leaves(opt_state)
            if not x.is_floating_point() and x.dim() == 0]


# ---- the JAX package's ten tests, on the port ----


def test_single_chunk_matches_spmd_federation():
    """chunk_size == n, keep_opt_state=False: the round semantics of
    SpmdFederation (the same perms from the same seeded rng calls)."""
    data = _data()
    kw = dict(n_nodes=4, batch_size=16, vote=False, seed=7, device="cpu")
    spmd = SpmdFederation.from_dataset(mlp(seed=0, device="cpu"), data, **kw)
    chunked = ChunkedFederation.from_dataset(mlp(seed=0, device="cpu"), data, chunk_size=4, **kw)
    for _ in range(2):
        spmd.run_round(epochs=1)
        chunked.run_round(epochs=1)
    assert _max_diff(spmd.node_params(0), chunked.params) < 2e-2  # bf16-scale tolerance
    assert abs(spmd.evaluate()["test_acc"] - chunked.evaluate()["test_acc"]) < 0.05


def test_chunking_is_invariant_to_chunk_size():
    """Chunks of 2 give the aggregate one chunk of 4 gives (FedAvg is a
    weighted sum, associative across chunks)."""
    data = _data()
    kw = dict(n_nodes=4, batch_size=16, vote=False, seed=3, device="cpu")
    one = ChunkedFederation.from_dataset(mlp(seed=0, device="cpu"), data, chunk_size=4, **kw)
    two = ChunkedFederation.from_dataset(mlp(seed=0, device="cpu"), data, chunk_size=2, **kw)
    for _ in range(2):
        one.run_round(epochs=1)
        two.run_round(epochs=1)
    assert _max_diff(one.params, two.params) < 2e-2


def test_mask_skips_chunks_and_excludes_contribution(monkeypatch):
    """A dropped node contributes nothing; a fully masked chunk is never
    staged or run, and the aggregate comes from the surviving chunk."""
    data = _data()
    kw = dict(chunk_size=2, n_nodes=4, batch_size=16, vote=False, seed=3, device="cpu")
    fed = ChunkedFederation.from_dataset(mlp(seed=0, device="cpu"), data, **kw)
    ref = ChunkedFederation.from_dataset(mlp(seed=0, device="cpu"), data, **kw)
    fed.drop_node(2)
    fed.drop_node(3)
    ref.chunk_size = 4
    ref.drop_node(2)
    ref.drop_node(3)
    staged = []
    real = fed._stage_chunk_inputs
    monkeypatch.setattr(fed, "_stage_chunk_inputs", lambda ci, *a: staged.append(ci) or real(ci, *a))
    fed.run_round(epochs=1)
    ref.run_round(epochs=1)
    assert staged == [0]
    assert _max_diff(fed.params, ref.params) < 2e-2


def test_keep_opt_state_moment_averaging_trains():
    """The documented divergence: averaged Adam moments and the schedule's
    surviving step count still train (the loss falls over rounds), and
    the integer count advances by every step taken."""
    data = _data(n_train=512)
    sched = warmup_cosine_decay_schedule(0.0, 3e-3, 8, 64, end_value=1e-4)
    fed = ChunkedFederation.from_dataset(
        mlp(seed=0, device="cpu"), data, chunk_size=2, n_nodes=4, batch_size=16, vote=False,
        seed=3, tx=adam(sched), keep_opt_state=True, device="cpu",
    )
    losses = [fed.run_round(epochs=1)["train_loss"] for _ in range(4)]
    assert losses[-1] < losses[0]
    counts = _counts(fed.opt_state)
    assert counts and all(c == 4 * fed._nb for c in counts)
    assert fed.evaluate()["test_acc"] > 0.5


def test_vote_and_round_flops():
    data = _data()
    fed = ChunkedFederation.from_dataset(
        mlp(seed=0, device="cpu"), data, chunk_size=2, n_nodes=4, batch_size=16, vote=True, seed=3, device="cpu"
    )
    fed.run_round(epochs=1)
    assert fed.train_mask.sum() >= 1
    assert fed.round_flops() > 0


def _run_with_knobs(fused, depth, donate=True, resident=True, keep=False, rounds=2):
    Settings.CHUNK_FUSED_REDUCE = fused
    Settings.CHUNK_STAGING_DEPTH = depth
    Settings.CHUNK_DONATE_BUFFERS = donate
    fed = ChunkedFederation.from_dataset(
        mlp(seed=0, device="cpu"), _data(), chunk_size=2, n_nodes=4, batch_size=16, vote=False,
        seed=3, resident=resident, keep_opt_state=keep, device="cpu",
    )
    entries = [fed.run_round(epochs=1) for _ in range(rounds)]
    return fed, entries


def test_overlapped_path_matches_serial_path():
    """The fused path (accumulators from zero, staged-ahead inputs) adds in
    the serial path's order: the same bits, the same loss."""
    fast, ef = _run_with_knobs(fused=True, depth=2)
    ref, er = _run_with_knobs(fused=False, depth=1)
    assert _max_diff(fast.params, ref.params) == 0.0
    assert ef[-1]["train_loss"] == er[-1]["train_loss"]


def test_overlap_knobs_do_not_change_results():
    """In-place accumulators, staging depth and streamed data are
    execution strategies: the same bits."""
    base, _ = _run_with_knobs(fused=True, depth=2)
    for kw in ({"donate": False}, {"depth": 1}, {"depth": 4}, {"resident": False}):
        other, _ = _run_with_knobs(fused=True, **{"depth": 2, **kw})
        assert _max_diff(base.params, other.params) == 0.0, kw


def test_overlapped_keep_opt_state_matches_serial():
    """The averaged moments through the fused accumulators: the fused
    finalize divides the serial path's weighted sums, bit for bit; the
    integer step counts advance alike."""
    fast, _ = _run_with_knobs(fused=True, depth=2, keep=True)
    ref, _ = _run_with_knobs(fused=False, depth=1, keep=True)
    assert _max_diff(fast.opt_state, ref.opt_state) == 0.0
    assert _counts(fast.opt_state) == _counts(ref.opt_state)


def test_nonresident_streaming_masks_and_flops():
    """``resident=False`` keeps the data on the host and streams it a chunk
    at a time: dropped nodes and round_flops behave as resident."""
    Settings.CHUNK_STAGING_DEPTH = 3
    fed = ChunkedFederation.from_dataset(
        mlp(seed=0, device="cpu"), _data(), chunk_size=2, n_nodes=4, batch_size=16, vote=False,
        seed=3, resident=False, device="cpu",
    )
    assert fed.x_chunks is None and len(fed._x_host) == 2
    fed.drop_node(2)
    fed.drop_node(3)
    fed.run_round(epochs=1)
    assert fed.round == 1
    assert fed.round_flops() > 0
    assert fed.evaluate()["test_acc"] >= 0.0


def test_rejects_indivisible_chunks():
    data = _data()
    with pytest.raises(ValueError, match="not divisible"):
        ChunkedFederation.from_dataset(mlp(seed=0, device="cpu"), data, chunk_size=3, n_nodes=4,
                                       batch_size=16, device="cpu")
    fed = ChunkedFederation.from_dataset(mlp(seed=0, device="cpu"), data, chunk_size=2, n_nodes=4,
                                         batch_size=16, device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        fed.chunk_size = 3
    fed.drop_node(0), fed.drop_node(1), fed.drop_node(2), fed.drop_node(3)
    with pytest.raises(RuntimeError, match="no active"):
        fed.run_round()


# ---- against the JAX package ----


def _pair(n_nodes: int, chunk: int, keep: bool, resident: bool = True, sched: bool = False):
    """A JAX and a port ChunkedFederation from flax's init of the fp32
    MLP, on one data and seed."""
    jmodel = FlaxModel.create(JaxMLP(dtype=jnp.float32), (28, 28, 1), seed=0)
    tmodel = TorchModel(MLP(dtype=torch.float32), params_from_jax(jax.tree.map(np.asarray, jmodel.params),
                                                                  device="cpu"), (28, 28, 1))
    data = dict(n_train=n_nodes * 96, n_test=n_nodes * 16, **HARD_TASK)  # 3 steps a round
    kw = dict(n_nodes=n_nodes, chunk_size=chunk, batch_size=32, vote=False, seed=3, keep_opt_state=keep,
              resident=resident)
    jtx = optax.adam(optax.warmup_cosine_decay_schedule(0.0, LR, 2, 12, 1e-4)) if sched else optax.adam(LR)
    ttx = adam(warmup_cosine_decay_schedule(0.0, LR, 2, 12, 1e-4)) if sched else adam(LR)
    jfed = JaxChunked.from_dataset(jmodel, JaxDataset.synthetic_mnist(**data), tx=jtx, **kw)
    tfed = ChunkedFederation.from_dataset(tmodel, FederatedDataset.synthetic_mnist(**data), tx=ttx,
                                          device="cpu", **kw)
    return jfed, tfed


def _gap(jtree, ttree) -> tuple[float, float]:
    """(max, mean) absolute difference over every floating element."""
    js = [np.asarray(x, np.float64) for x in jax.tree.leaves(jtree) if jnp.issubdtype(x.dtype, jnp.floating)]
    ts = [x.double().numpy() for x in torch.utils._pytree.tree_leaves(ttree) if x.is_floating_point()]
    diffs = np.concatenate([np.abs(a - b).ravel() for a, b in zip(js, ts)])
    return float(diffs.max()), float(diffs.mean())


CASES = {
    "fresh-4x2": dict(n_nodes=4, chunk=2, keep=False),
    "kept-4x2": dict(n_nodes=4, chunk=2, keep=True, sched=True),
    "kept-8x4": dict(n_nodes=8, chunk=4, keep=True),
    "serial-8x4": dict(n_nodes=8, chunk=4, keep=True, fused=False),
    "depth1-8x2": dict(n_nodes=8, chunk=2, keep=False, depth=1),
    "depth3-8x2": dict(n_nodes=8, chunk=2, keep=True, depth=3),
    "streamed-4x2": dict(n_nodes=4, chunk=2, keep=True, resident=False),
    "masked-8x4": dict(n_nodes=8, chunk=4, keep=True, masked=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_rounds_match_jax(case):
    """2 rounds of each mode against JAX's: params, averaged moments, the
    step counts and the round loss (tolerances in the module docstring);
    the masked case drops a whole chunk and one node of another."""
    kw = dict(CASES[case])
    fused, depth, masked = kw.pop("fused", True), kw.pop("depth", 2), kw.pop("masked", False)
    for s in (Settings, JaxSettings):
        s.CHUNK_FUSED_REDUCE, s.CHUNK_STAGING_DEPTH = fused, depth
    jfed, tfed = _pair(**kw)
    if masked:
        for fed in (jfed, tfed):
            for i in (1, 4, 5, 6, 7):
                fed.drop_node(i)
    for _ in range(2):
        je, te = jfed.run_round(), tfed.run_round()
        assert abs(te["train_loss"] - je["train_loss"]) <= 1e-4 * abs(je["train_loss"])
    steps = 2 * tfed._nb
    worst, mean = _gap(jfed.params, tfed.params)
    assert worst <= 2 * LR * steps and mean <= 1e-5, (worst, mean)
    if kw["keep"]:
        jmu = [x for x in jax.tree.leaves(jfed.opt_state) if jnp.issubdtype(x.dtype, jnp.floating)]
        scale = max(float(np.abs(np.asarray(x)).max()) for x in jmu)
        assert _gap(jfed.opt_state, tfed.opt_state)[0] <= 1e-4 * scale
        jcounts = [int(x) for x in jax.tree.leaves(jfed.opt_state) if jnp.issubdtype(x.dtype, jnp.integer)]
        assert set(jcounts) == set(_counts(tfed.opt_state)) == {steps}
    assert abs(tfed.evaluate()["test_acc"] - jfed.evaluate()["test_acc"]) <= 0.05


def test_round_flops_against_jax():
    """``round_flops`` against JAX's XLA count for the MLP under remat:
    model FLOPs (``hw=False``) within 2 % (the port counts the products
    and Adam's 14 operations a parameter, XLA every operation);
    ``hw=True`` adds the recompute the port executes, one forward a step.
    (XLA's count of the CPU program shows no recompute: it drops the
    MLP's checkpoint there, so JAX's ``hw=True`` reads as its ``hw=False``.)"""
    from p2pfl_tpu_torch.parallel.spmd import _model_step_flops

    jfed, tfed = _pair(n_nodes=4, chunk=2, keep=False)
    jfed.remat = tfed.remat = True
    want, got = jfed.round_flops(hw=False), tfed.round_flops(hw=False)
    assert abs(got - want) <= 0.02 * want, (got, want)
    forward, _ = _model_step_flops(tfed.module, tfed.model.params, tfed.x_chunks[0], tfed.y_chunks[0], 32)
    assert tfed.round_flops(hw=True) - got == tfed.n * tfed._nb * forward


def test_resnet_chunks_under_remat_match_jax():
    """A reduced-depth ResNet (stages (1, 1), fp32, 16x16x3) in chunks of 2
    of 4 nodes with ``remat`` and SGD against JAX's, one round: the params
    within 1e-4 relative L2 (``test_torch_spmd_vision.py``'s bound of SGD
    rounds), the loss within 1e-5 relative."""
    from p2pfl_tpu.models import vision as jv
    from p2pfl_tpu_torch.convert import params_to_jax
    from p2pfl_tpu_torch.learning.learner import sgd

    shape = (16, 16, 3)
    params = init_resnet_params(ResNet((1, 1)), shape, 0, torch.device("cpu"))
    jmodel = FlaxModel(jv.ResNet(stage_sizes=(1, 1), dtype=jnp.float32), params_to_jax(params), shape)
    tmodel = TorchModel(ResNet((1, 1), dtype=torch.float32), params, shape)
    data = dict(n_train=4 * 32, n_test=4 * 8, dim=shape, modes=2, noise=0.5, proto_scale=0.7)
    kw = dict(n_nodes=4, chunk_size=2, batch_size=16, vote=False, seed=3, remat=True)
    jfed = JaxChunked.from_dataset(jmodel, JaxDataset.synthetic_mnist(**data), tx=optax.sgd(0.05), **kw)
    tfed = ChunkedFederation.from_dataset(tmodel, FederatedDataset.synthetic_mnist(**data), tx=sgd(0.05),
                                          device="cpu", **kw)
    je, te = jfed.run_round(), tfed.run_round()
    assert abs(te["train_loss"] - je["train_loss"]) <= 1e-5 * abs(je["train_loss"])
    want = [np.asarray(x, np.float64) for x in jax.tree.leaves(jfed.params)]
    got = [x.double().numpy() for x in tree_leaves(tfed.params)]
    num = sum(float(np.sum((a - b) ** 2)) for a, b in zip(want, got))
    assert (num / sum(float(np.sum(a ** 2)) for a in want)) ** 0.5 <= 1e-4
