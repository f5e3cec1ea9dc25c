"""The port's optimizers and learning-rate schedules
(``learning/optimizers.py`` over ``learning/learner.py``'s ``adam`` and
``sgd``) against optax on the CPU, on numpy-seeded trees.

Schedules are held bit-equal at 99 % of the counts 0-500 and within 2
fp32 ulps relative at every one: the port takes the cosine correctly
rounded, XLA's misses that by an ulp at a few arguments, and near
the end of the decay ``1 + cos`` cancels, so one ulp of the cosine there
is two of the schedule (read at one count of 501 for config 2's
schedule); every optimizer to 1e-6 over 10 steps (the updates are fp32 products of the same operations in the same
order; Adam's bias correction ``b**count`` may differ by an ulp).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from p2pfl_tpu_torch.learning import learner, optimizers
from p2pfl_tpu_torch.learning.learner import apply_updates
from p2pfl_tpu_torch.ops.tree import tree_leaves, tree_map

COUNTS = np.arange(0, 501, dtype=np.int32)


def _tree(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"a": {"kernel": rng.standard_normal((5, 3)).astype(np.float32)},
            "b": rng.standard_normal(7).astype(np.float32)}


def _ulps(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    """|got − want| in units of the fp32 spacing at ``want`` (1 ulp relative)."""
    return np.abs(got.astype(np.float64) - want) / np.spacing(np.abs(want).astype(np.float32))


@pytest.mark.parametrize("name,args", [
    ("warmup_cosine_decay_schedule", (0.0, 3e-3, 32, 400, 1e-4)),  # config 2's recipe
    ("warmup_cosine_decay_schedule", (1e-4, 1e-3, 100, 10_000, 0.0)),
    ("warmup_cosine_decay_schedule", (0.0, 1e-2, 10, 300, 1e-3, 2.0)),
    ("linear_schedule", (1.0, 0.01, 100)),
    ("linear_schedule", (0.5, 0.1, 50, 20)),
    ("cosine_decay_schedule", (2e-3, 250, 0.1)),
])
def test_schedules_match_optax(name, args):
    """Every count 0-500 (past the ends of the warmup and the decay) from
    an int32 device count: a 0-d fp32 tensor, equal to optax's at 99 % of
    the counts and within 2 ulps at every one."""
    want = np.asarray(jax.vmap(getattr(optax, name)(*args))(jnp.asarray(COUNTS)), np.float32)
    schedule = getattr(optimizers, name)(*args)
    got = np.array([float(schedule(torch.tensor(c))) for c in COUNTS], np.float32)
    one = schedule(torch.tensor(7, dtype=torch.int32))
    assert one.dtype == torch.float32 and one.shape == ()
    ulps = _ulps(got, want)
    assert ulps.max() <= 2.0 and np.mean(ulps == 0) >= 0.99


def test_schedule_refusals_and_constants():
    with pytest.raises(ValueError, match="positive decay_steps"):
        optimizers.cosine_decay_schedule(1.0, 0)
    flat = optimizers.linear_schedule(0.3, 0.0, 0)
    assert float(flat(torch.tensor(9))) == pytest.approx(0.3)


def _run(jtx, ttx, steps: int = 10, seed: int = 0):
    """``steps`` steps of both transforms on the same params and gradients
    (each step's gradient a fresh draw); returns the max absolute
    difference of the params and the port's final state."""
    rng = np.random.default_rng(seed)
    params = _tree(seed)
    jp, tp = jax.tree.map(jnp.asarray, params), tree_map(torch.tensor, params)
    js, ts = jtx.init(jp), ttx.init(tp)
    for _ in range(steps):
        g = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), params)
        ju, js = jtx.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = ttx.update(tree_map(torch.tensor, g), ts, tp)
        tp = apply_updates(tp, tu)
    want = jax.tree.leaves(jax.tree.map(np.asarray, jp))
    got = [x.numpy() for x in tree_leaves(tp)]
    return max(float(np.abs(a - b).max()) for a, b in zip(want, got)), ts


@pytest.mark.parametrize("momentum,nesterov", [(0.9, False), (0.9, True), (0.5, True)])
def test_sgd_momentum_matches_optax(momentum, nesterov):
    err, state = _run(optax.sgd(0.1, momentum=momentum, nesterov=nesterov),
                      optimizers.sgd(0.1, momentum=momentum, nesterov=nesterov))
    assert err <= 1e-6
    assert int(state.count) == 10 and set(state.trace) == {"a", "b"}


def test_plain_sgd_keeps_an_empty_state():
    """SCAFFOLD's variate update assumes plain SGD: without momentum or a
    schedule the state stays ``()``."""
    err, state = _run(optax.sgd(0.05), learner.sgd(0.05))
    assert err <= 1e-6 and state == ()


@pytest.mark.parametrize("build", ["adamw", "scheduled_adam", "adam_cosine", "scheduled_sgd"])
def test_adaptive_and_scheduled_match_optax(build):
    sched = (0.0, 3e-2, 4, 12, 1e-3)
    jtx, ttx = {
        "adamw": (optax.adamw(1e-2, weight_decay=0.1), optimizers.adamw(1e-2, weight_decay=0.1)),
        "scheduled_adam": (optax.adam(optax.warmup_cosine_decay_schedule(*sched)),
                           optimizers.adam(optimizers.warmup_cosine_decay_schedule(*sched))),
        "adam_cosine": (optax.adam(optax.warmup_cosine_decay_schedule(0.0, 1e-2, warmup_steps=3, decay_steps=8)),
                        optimizers.adam_cosine(1e-2, decay_steps=8, warmup_steps=3)),
        "scheduled_sgd": (optax.sgd(optax.linear_schedule(0.1, 0.0, 8), momentum=0.9),
                          optimizers.sgd(optimizers.linear_schedule(0.1, 0.0, 8))),
    }[build]
    err, state = _run(jtx, ttx)
    assert err <= 1e-6
    assert int(state.count) == 10


@pytest.mark.parametrize("name,max_norm", [("adam", 0.5), ("adamw", 0.5), ("sgd", 100.0), ("sgd", 0.1)])
def test_clipped_matches_optax(name, max_norm):
    """Global-norm clipping chained before the base optimizer: the
    gradients' norm (about 4.5) is clipped at 0.5 and 0.1 and passes at 100."""
    jbase = {"adam": optax.adam(1e-2), "adamw": optax.adamw(1e-2), "sgd": optax.sgd(1e-2, momentum=0.9)}[name]
    err, state = _run(optax.chain(optax.clip_by_global_norm(max_norm), jbase),
                      optimizers.clipped(name, 1e-2, max_norm))
    assert err <= 1e-6
    assert state[0] == () and int(state[1].count) == 10


def test_node_stacked_clip_is_per_node():
    """Over a node-stacked tree ``[N, ...]`` the transform's per-node form
    clips each node by its own norm: node i's update equals the update of
    node i's tree alone."""
    tx = optimizers.clipped("adam", 1e-2, 1.0)
    assert tx.capturable and tx.node_stacked is not None
    stacked_tx = tx.node_stacked
    trees = [_tree(i) for i in range(3)]
    grads = [tree_map(lambda a, s=s: torch.tensor(a * s), _tree(10 + i)) for i, s in enumerate((0.01, 1.0, 30.0))]
    params = tree_map(lambda *xs: torch.tensor(np.stack(xs)), *trees)
    g = tree_map(lambda *xs: torch.stack(xs), *grads)
    updates, _ = stacked_tx.update(g, stacked_tx.init(params), params)
    for i in range(3):
        p_i = tree_map(torch.tensor, trees[i])
        want, _ = tx.update(grads[i], tx.init(p_i), p_i)
        for a, b in zip(tree_leaves(updates), tree_leaves(want)):
            assert torch.allclose(a[i], b, rtol=1e-6, atol=0)


def test_learner_adam_is_the_one_implementation():
    """``optimizers.adam`` is ``learner.adam``'s step (no copy): the same
    updates bit for bit, a float rate or a constant schedule alike, and the
    Node's learner and the federation keep using ``learner.adam``."""
    params = tree_map(torch.tensor, _tree(1))
    g = tree_map(lambda x: x * 0.3, params)
    a, b = learner.adam(1e-3), optimizers.adam(1e-3)
    const = learner.adam(lambda count: torch.full((), 1e-3))
    ua, _ = a.update(g, a.init(params), params)
    ub, _ = b.update(g, b.init(params), params)
    uc, _ = const.update(g, const.init(params), params)
    for x, y, z in zip(tree_leaves(ua), tree_leaves(ub), tree_leaves(uc)):
        assert torch.equal(x, y) and torch.equal(x, z)
    assert a.capturable and optimizers.chain(a, b).capturable
    assert not learner.GradientTransformation(a.init, a.update).capturable


def _adafactor_tree(seed: int) -> dict:
    """Leaves of every kind Adafactor tells apart: rank 1 (full moment),
    rank 2 factored (both axes >= 128), a tie of equal axes, one axis at
    127 (the factor-size edge: full moment), rank 3 factored over its two
    largest axes, and a small weight whose rms sits under the 1e-3 floor."""
    rng = np.random.default_rng(seed)
    shapes = {"bias": (200,), "kernel": (256, 130), "square": (128, 128), "edge": (256, 127),
              "stack": (3, 130, 160)}
    tree = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    tree["tiny"] = (1e-4 * rng.standard_normal((8, 4))).astype(np.float32)
    return tree


@pytest.mark.parametrize("lr", [3e-3, "schedule"], ids=["const", "schedule"])
def test_adafactor_matches_optax(lr):
    """``adafactor`` (optax's defaults: ``min_dim_size_to_factor`` 128,
    decay 0.8, clipping 1.0, parameter scale, eps 1e-30) against
    ``optax.adafactor`` over 20 steps of numpy-seeded gradients, some 100x
    larger so the block clip engages: params to 1e-6 relative to their
    scale at every step, the factored statistics to 1e-5 relative (fp32
    products in the same order; XLA's and torch's ``pow`` may differ by an
    ulp), the count equal. The factoring chooses the leaves optax does."""
    sched_args = (0.0, 3e-3, 5, 20, 1e-4)
    jlr = optax.warmup_cosine_decay_schedule(*sched_args) if lr == "schedule" else lr
    tlr = optimizers.warmup_cosine_decay_schedule(*sched_args) if lr == "schedule" else lr
    jtx, ttx = optax.adafactor(learning_rate=jlr), optimizers.adafactor(learning_rate=tlr)
    params = _adafactor_tree(0)
    jp = jax.tree.map(jnp.asarray, params)
    tp = {k: torch.tensor(v) for k, v in params.items()}
    js, ts = jtx.init(jp), ttx.init(tp)
    rng = np.random.default_rng(1)
    for step in range(20):
        scale = 100.0 if step % 5 == 0 else 1.0
        grads = {k: (scale * rng.standard_normal(v.shape)).astype(np.float32) for k, v in params.items()}
        ju, js = jtx.update(jax.tree.map(jnp.asarray, grads), js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = ttx.update({k: torch.tensor(v) for k, v in grads.items()}, ts, tp)
        tp = apply_updates(tp, tu)
        for k in params:
            want = np.asarray(jp[k])
            np.testing.assert_allclose(tp[k].numpy(), want, rtol=0, atol=1e-6 * np.abs(want).max(), err_msg=f"{k}@{step}")
    jfac = js[0]
    assert int(ts.count) == int(jfac.count) == 20
    for name in ("v_row", "v_col", "v"):
        for k in params:
            want, got = np.asarray(getattr(jfac, name)[k]), getattr(ts, name)[k].numpy()
            assert got.shape == want.shape, (name, k)
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=0, err_msg=f"{name}/{k}")
    factored = {k for k in params if getattr(ts, "v")[k].shape == (1,)}
    assert factored == {"kernel", "square", "stack"}


def test_adafactor_refuses_a_step_without_params():
    tx = optimizers.adafactor(1e-3)
    p = {"w": torch.ones(3)}
    with pytest.raises(ValueError, match="needs the params"):
        tx.update(p, tx.init(p))
