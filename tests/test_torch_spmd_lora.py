"""The port's LoRA federation against the JAX package: data and rng
streams bitwise, Adam and FedAvg, per-node gradients of the node-axis
loss, and a 4-node federation (one round, fused rounds, eval) from the
same converted init."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from p2pfl_tpu.learning import lora as jlora
from p2pfl_tpu.learning.dataset import FederatedDataset as JaxDataset
from p2pfl_tpu.models import transformer as jtr
from p2pfl_tpu.ops.flash_attention import FlashConfig as JaxFlashConfig
from p2pfl_tpu.parallel import SpmdLoraFederation as JaxFederation
from p2pfl_tpu.parallel import spmd as jspmd
from p2pfl_tpu.settings import Settings as JaxSettings
from p2pfl_tpu_torch.convert import params_from_jax, params_to_jax
from p2pfl_tpu_torch.learning.dataset import FederatedDataset
from p2pfl_tpu_torch.learning.learner import adam, apply_updates, softmax_cross_entropy
from p2pfl_tpu_torch.learning.lora import _lm_loss, lora_eval, merge_params, split_lora
from p2pfl_tpu_torch.models.base import TorchModel
from p2pfl_tpu_torch.models.transformer import CausalLM, TransformerConfig
from p2pfl_tpu_torch.ops.flash_attention import FlashConfig
from p2pfl_tpu_torch.ops.tree import tree_items, tree_map
from p2pfl_tpu_torch.parallel import spmd as tspmd
from p2pfl_tpu_torch.parallel.spmd_lora import SpmdLoraFederation
from p2pfl_tpu_torch.settings import Settings

torch.set_num_threads(2)

SEQ, VOCAB = 32, 128
SMALL = dict(vocab_size=VOCAB, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, ffn_hidden=96, lora_mlp=True)


@pytest.mark.parametrize("shift_frac", [0.0, 0.15])
@pytest.mark.parametrize("seed", [17, 3])
def test_synthetic_lm_and_partition_bitwise(seed, shift_frac):
    kw = dict(vocab_size=VOCAB, seq_len=SEQ, n_train=40, n_test=12, seed=seed, shift_frac=shift_frac)
    want, got = JaxDataset.synthetic_lm(**kw), FederatedDataset.synthetic_lm(**kw)
    for name in ("x_train", "y_train", "x_test", "y_test"):
        a, b = getattr(want, name), getattr(got, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    for i in range(3):
        pa, pb = want.partition(i, 3), got.partition(i, 3)
        assert np.array_equal(pa.x_train, pb.x_train) and np.array_equal(pa.y_test, pb.y_test)


@pytest.mark.parametrize("strategy", ["iid", "sorted", "dirichlet"])
def test_partition_strategies_bitwise(strategy):
    """The label-driven strategies on a labelled set (one label per row)."""
    rng = np.random.default_rng(4)
    arrays = (rng.standard_normal((60, 3)), rng.integers(0, 5, 60), rng.standard_normal((20, 3)), rng.integers(0, 5, 20))
    want, got = JaxDataset(*arrays, num_classes=5), FederatedDataset(*arrays, num_classes=5)
    for i in range(4):
        pa = want.partition(i, 4, strategy, alpha=0.3, seed=7)
        pb = got.partition(i, 4, strategy, alpha=0.3, seed=7)
        for name in ("x_train", "y_train", "x_test", "y_test"):
            assert np.array_equal(getattr(pa, name), getattr(pb, name)), name


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_rng_streams_bitwise(seed):
    """draw_node_perms and the vote consume the numpy / Python rng streams
    exactly as the JAX driver does."""
    sizes, nb, bs = [10, 12, 9, 10], 4, 2
    a, b = np.random.default_rng(seed), np.random.default_rng(seed)
    for epochs in (1, 2):
        want = jspmd.draw_node_perms(a, sizes, nb, bs, epochs)
        got = tspmd.draw_node_perms(b, sizes, nb, bs, epochs)
        assert want.dtype == got.dtype and np.array_equal(want, got)
    for k in (2, 4):
        JaxSettings.TRAIN_SET_SIZE = Settings.TRAIN_SET_SIZE = k
        try:
            ra, rb = random.Random(seed), random.Random(seed)
            for n in (4, 7):
                assert np.array_equal(
                    jspmd.elect_train_set_mask(n, ra), tspmd.elect_train_set_mask(n, rb)
                )
        finally:
            Settings.TRAIN_SET_SIZE = 4


def test_stage_node_shards_match():
    data = FederatedDataset.synthetic_lm(vocab_size=VOCAB, seq_len=8, n_train=30, n_test=10)
    shards = [data.partition(i, 4) for i in range(4)]  # 7, 7, 7, 9 rows
    want, got = jspmd.stage_node_shards(shards, 2), tspmd.stage_node_shards(shards, 2)
    assert want["sizes"] == got["sizes"] and want["nb"] == got["nb"]
    for key in ("x", "y", "x_test", "y_test"):
        assert all(np.array_equal(a, b) for a, b in zip(want[key], got[key]))


def test_adam_matches_optax():
    """optax semantics step by step on node-stacked leaves. Tolerance: two
    fp32 ulps at |p| ~ 1 (the pow/sqrt implementations differ)."""
    rng = np.random.default_rng(0)
    params = {"a": {"lora_a": rng.standard_normal((4, 8, 3)).astype(np.float32)}, "b": rng.standard_normal((4, 5)).astype(np.float32)}
    tx_j, tx_t = optax.adam(1e-2), adam(1e-2)
    pj, pt = jax.tree.map(jnp.asarray, params), tree_map(torch.tensor, params)
    sj, st = tx_j.init(pj), tx_t.init(pt)
    for step in range(5):
        g = jax.tree.map(lambda x: (rng.standard_normal(x.shape) * 10.0 ** -step).astype(np.float32), params)
        uj, sj = tx_j.update(jax.tree.map(jnp.asarray, g), sj, pj)
        pj = optax.apply_updates(pj, uj)
        ut, st = tx_t.update(tree_map(torch.tensor, g), st, pt)
        pt = apply_updates(pt, ut)
        for (_, a), (_, b) in zip(tree_items(jax.tree.map(np.asarray, pj)), tree_items(pt)):
            np.testing.assert_allclose(b.numpy(), a, atol=2.5e-7, rtol=0)
    assert st.count == int(sj[0].count) == 5


def test_fedavg_matches_jax_aggregate():
    rng = np.random.default_rng(1)
    stack = {"w": {"lora_a": rng.standard_normal((4, 6, 2)).astype(np.float32)}}
    mask = np.array([1, 0, 1, 1], np.float32)
    weights = np.array([10, 12, 9, 10], np.float32)
    sel = np.flatnonzero(mask).astype(np.int32)
    want = jspmd._aggregate(jax.tree.map(jnp.asarray, stack), jnp.asarray(mask), jnp.asarray(weights), sel, "fedavg", 0)
    tsel = torch.tensor(sel, dtype=torch.long)
    got = tspmd._aggregate(tree_map(torch.tensor, stack), torch.tensor(mask), torch.tensor(weights), tsel, "fedavg", 0)
    np.testing.assert_allclose(got["w"]["lora_a"].numpy(), np.asarray(want["w"]["lora_a"]), atol=1e-7)
    # the robust rules aggregate the selected rows only: the median of 3
    want = jspmd._aggregate(jax.tree.map(jnp.asarray, stack), jnp.asarray(mask), jnp.asarray(weights), sel, "median", 0)
    got = tspmd._aggregate(tree_map(torch.tensor, stack), torch.tensor(mask), torch.tensor(weights), tsel, "median", 0)
    np.testing.assert_array_equal(got["w"]["lora_a"].numpy(), np.asarray(want["w"]["lora_a"]))


def _jax_model(flash: bool, dtype, seed: int = 0):
    cfg = jtr.TransformerConfig(**SMALL, dtype=dtype, flash_config=JaxFlashConfig(16, 16) if flash else None)
    return jtr.tiny_transformer(seq_len=SEQ, seed=seed, cfg=cfg)


def _port_model(jmodel, flash: bool, dtype) -> TorchModel:
    cfg = TransformerConfig(**SMALL, dtype=dtype, flash_config=FlashConfig(16, 16) if flash else None)
    params = params_from_jax(jax.tree.map(np.asarray, jmodel.params), device="cpu")
    return TorchModel(CausalLM(cfg), params, (SEQ,), VOCAB, {"config": cfg})


def test_node_axis_loss_gives_each_node_its_own_gradient():
    """The port writes the node axis out: the loss autograd sees is the sum
    of each node's mean CE. Its gradient for node n must equal jax.grad of
    node n's own loss (a global mean would be 1/N of it). fp32, 1e-5 of the
    largest gradient."""
    jmodel = _jax_model(False, jnp.float32, seed=4)
    rng = np.random.default_rng(5)
    p = jax.tree_util.tree_map_with_path(
        lambda path, x: np.asarray(x) + (0.02 * rng.standard_normal(x.shape).astype(np.float32)
                                        if "lora_b" in jax.tree_util.keystr(path) else 0.0),
        jmodel.params,
    )
    n = 3
    x = rng.integers(0, VOCAB, (n, 2, SEQ)).astype(np.int32)
    y = rng.integers(0, VOCAB, (n, 2, SEQ)).astype(np.int32)
    jl, jb = jax.tree.map(jnp.asarray, jlora.split_lora(p))
    stacked_np = jax.tree.map(lambda a: np.stack([np.asarray(a) * (1 + 0.1 * i) for i in range(n)]), jl)
    want = [
        jax.grad(lambda lo: jlora._lm_loss(lo, jb, jmodel.module, x[i], y[i])[0])(
            jax.tree.map(lambda a: jnp.asarray(a[i]), stacked_np)
        )
        for i in range(n)
    ]
    tparams = params_from_jax(p, device="cpu")
    cfg = TransformerConfig(**SMALL, dtype=torch.float32)
    _, base = split_lora(tparams)
    stacked = tree_map(lambda a: torch.tensor(a).requires_grad_(True), stacked_np)
    node_loss, _ = _lm_loss(stacked, base, CausalLM(cfg), torch.tensor(x), torch.tensor(y), node_axis=True)
    assert node_loss.shape == (n,)
    node_loss.sum().backward()
    for i in range(n):
        w = dict(tree_items(jax.tree.map(np.asarray, want[i])))
        scale = max(np.abs(v).max() for v in w.values())
        for path, leaf in tree_items(stacked):
            np.testing.assert_allclose(leaf.grad[i].numpy(), w[path], atol=1e-5 * scale, err_msg=path)


# Federation tolerances. The losses agree to fp32 rounding. The adapters
# after a round do not agree as tightly: Adam divides each moment by its
# own square root, so a gradient element near 0 (lora_a's first gradient
# is exactly 0 while lora_b starts at 0) moves by ~±lr whichever side of
# zero the rounding put it. fp32 holds the adapters to 5e-4 absolute at
# lr 1e-2 after one round (their magnitude ~0.1); bf16 only to 2·lr per
# Adam step taken, with the mean difference far below that.
FED = dict(n_nodes=4, batch_size=4, vote=True, seed=3, learning_rate=1e-2)


def _federations(flash: bool, dtype: str):
    jdt, tdt = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    kw = dict(vocab_size=VOCAB, seq_len=SEQ, n_train=32, n_test=16)
    jmodel = _jax_model(flash, jdt)
    jfed = JaxFederation.from_dataset(jmodel, JaxDataset.synthetic_lm(**kw), **FED)
    tfed = SpmdLoraFederation.from_dataset(
        _port_model(jmodel, flash, tdt), FederatedDataset.synthetic_lm(**kw), device="cpu", **FED
    )
    return jfed, tfed


def _adapter_diff(jfed, tfed) -> tuple[float, float]:
    want = jax.tree.map(np.asarray, jfed.params)
    got = params_to_jax(tfed.params)
    diffs = [np.abs(a - b) for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got))]
    assert jax.tree.structure(want) == jax.tree.structure(got)
    return max(d.max() for d in diffs), float(np.mean([d.mean() for d in diffs]))


@pytest.mark.parametrize("flash", [False, True], ids=["dense", "flash"])
def test_federation_fp32_matches_jax(flash):
    jfed, tfed = _federations(flash, "fp32")
    je, te = jfed.run_round(), tfed.run_round()
    assert np.array_equal(jfed.train_mask, tfed.train_mask)
    assert float(te["train_loss"]) == pytest.approx(float(je["train_loss"]), abs=2e-5)
    worst, _ = _adapter_diff(jfed, tfed)
    assert worst <= 5e-4
    # every node holds the aggregate after diffusion
    for path, leaf in tree_items(tfed.params):
        assert torch.equal(leaf[0], leaf[-1]), path

    jf, tf = jfed.run_fused(2), tfed.run_fused(2)
    for a, b in zip(jf, tf):
        assert a["round"] == b["round"]
        assert float(b["train_loss"]) == pytest.approx(float(a["train_loss"]), abs=1e-4)
    jm, tm = jfed.evaluate(), tfed.evaluate()
    assert tm["test_loss"] == pytest.approx(jm["test_loss"], abs=1e-4)
    assert tm["test_acc"] == pytest.approx(jm["test_acc"], abs=1.0 / (4 * SEQ))
    assert tfed.round == jfed.round == 3


def test_federation_bf16_flash_matches_jax():
    jfed, tfed = _federations(True, "bf16")
    je, te = jfed.run_round(), tfed.run_round()
    assert float(te["train_loss"]) == pytest.approx(float(je["train_loss"]), rel=2e-3)
    worst, mean = _adapter_diff(jfed, tfed)
    steps = tfed._nb
    assert worst <= 2 * FED["learning_rate"] * steps
    assert mean <= 0.05 * FED["learning_rate"]
    jm, tm = jfed.evaluate(), tfed.evaluate()
    assert tm["test_loss"] == pytest.approx(jm["test_loss"], rel=2e-3)


def test_federation_state_machine():
    jmodel = _jax_model(False, jnp.float32)
    data = FederatedDataset.synthetic_lm(vocab_size=VOCAB, seq_len=SEQ, n_train=32, n_test=16)
    fed = SpmdLoraFederation.from_dataset(
        _port_model(jmodel, False, torch.float32), data, n_nodes=4, batch_size=4, vote=False,
        seed=1, device="cpu",
    )
    lora, base = split_lora(fed.model.params)
    n_lora = sum(v.numel() for _, v in tree_items(lora))
    assert sum(v.numel() for _, v in tree_items(fed.params)) == 4 * n_lora
    # node failure: a dropped node neither trains nor contributes
    fed.drop_node(2)
    fed.run_round()
    mask = fed._effective_mask()
    assert mask.tolist() == [1.0, 1.0, 0.0, 1.0]
    fed.restore_node(2)
    fed.reset(seed=1)
    assert fed.round == 0 and fed.history == []
    # reset restages the initial adapters on every node
    got = fed.node_params(1)
    assert all(torch.equal(got_leaf, l0) for (_, got_leaf), (_, l0) in zip(tree_items(got), tree_items(lora)))
    with pytest.raises(ValueError, match="fused eval"):
        fed.run_fused(1, eval=True)


def test_federation_refusals():
    jmodel = _jax_model(False, jnp.float32)
    model = _port_model(jmodel, False, torch.float32)
    data = FederatedDataset.synthetic_lm(vocab_size=VOCAB, seq_len=SEQ, n_train=16, n_test=8)
    Settings.SECURE_AGGREGATION = True
    try:
        with pytest.raises(ValueError, match="SECURE_AGGREGATION"):
            SpmdLoraFederation.from_dataset(model, data, n_nodes=4, batch_size=2, device="cpu")
    finally:
        Settings.SECURE_AGGREGATION = False
    # the robust aggregators are ported: krum builds and runs a round
    fed = SpmdLoraFederation.from_dataset(
        model, data, n_nodes=4, batch_size=2, aggregator="krum", trim=1, device="cpu"
    )
    assert fed.aggregator == "krum" and np.isfinite(float(fed.run_round()["train_loss"]))
    with pytest.raises(ValueError, match="unknown aggregator"):
        SpmdLoraFederation.from_dataset(model, data, n_nodes=4, batch_size=2, aggregator="mode", device="cpu")
    fed = SpmdLoraFederation.from_dataset(model, data, n_nodes=4, batch_size=2, device="cpu")
    Settings.VOTE_EVERY_ROUND = True
    try:
        with pytest.raises(ValueError, match="fixed mask"):
            fed.run_fused(2)
    finally:
        Settings.VOTE_EVERY_ROUND = False


def test_lora_eval_and_ce_match_optax():
    rng = np.random.default_rng(9)
    logits = rng.standard_normal((2, 5, VOCAB)).astype(np.float32) * 3
    labels = rng.integers(0, VOCAB, (2, 5)).astype(np.int32)
    want = optax.softmax_cross_entropy_with_integer_labels(jnp.asarray(logits), jnp.asarray(labels))
    got = softmax_cross_entropy(torch.tensor(logits), torch.tensor(labels))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)

    jmodel = _jax_model(False, jnp.float32)
    x = rng.integers(0, VOCAB, (3, SEQ)).astype(np.int32)
    y = rng.integers(0, VOCAB, (3, SEQ)).astype(np.int32)
    jl, jb = jlora.split_lora(jmodel.params)
    wl, wa = jlora.lora_eval(jl, jb, x, y, jmodel.module)
    tl, tb = split_lora(params_from_jax(jax.tree.map(np.asarray, jmodel.params), device="cpu"))
    cfg = TransformerConfig(**SMALL, dtype=torch.float32)
    gl, ga = lora_eval(tl, tb, torch.tensor(x), torch.tensor(y), CausalLM(cfg))
    assert float(gl) == pytest.approx(float(wl), abs=1e-5)
    assert float(ga) == pytest.approx(float(wa), abs=1e-6)
    assert merge_params({"a": {"b": 1, "c": 2}}, {"a": {"c": 3}}) == {"a": {"b": 1, "c": 3}}
