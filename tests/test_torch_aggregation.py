"""The port's aggregators against the JAX package's: the robust rules
and the FedOpt server step on identical node-stacked trees (even and odd
node counts, tied rows), then one round of each through the full-model
``SpmdFederation`` and the LoRA federation."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2pfl_tpu.learning.dataset import FederatedDataset as JaxDataset
from p2pfl_tpu.models import transformer as jtr
from p2pfl_tpu.models.base import FlaxModel
from p2pfl_tpu.models.vision import MLP as JaxMLP
from p2pfl_tpu.ops import aggregation as jops
from p2pfl_tpu.parallel import SpmdFederation as JaxFederation
from p2pfl_tpu.parallel import SpmdLoraFederation as JaxLoraFederation
from p2pfl_tpu.parallel import spmd as jspmd
from p2pfl_tpu_torch.convert import params_from_jax, params_to_jax
from p2pfl_tpu_torch.learning.dataset import FederatedDataset
from p2pfl_tpu_torch.models.base import TorchModel
from p2pfl_tpu_torch.models.transformer import CausalLM, TransformerConfig
from p2pfl_tpu_torch.models.vision import MLP
from p2pfl_tpu_torch.ops import aggregation as tops
from p2pfl_tpu_torch.ops.tree import tree_map
from p2pfl_tpu_torch.parallel.spmd import SpmdFederation
from p2pfl_tpu_torch.parallel.spmd_lora import SpmdLoraFederation

torch.set_num_threads(2)


def _stack(k: int, tied: bool, seed: int = 0) -> dict:
    """A node-stacked tree of K rows (fp32 and one bf16 leaf). ``tied``:
    row 2 repeats row 0 (two identical models: equal Krum scores, equal
    values at the median) and every row shares one coordinate's value."""
    rng = np.random.default_rng(seed)
    tree = {
        "Dense_0": {"kernel": rng.standard_normal((k, 6, 4)).astype(np.float32),
                    "bias": rng.standard_normal((k, 4)).astype(np.float32)},
        "scale": (rng.standard_normal((k, 3)) * 3).astype(np.float32),
        "half": rng.standard_normal((k, 5)).astype(np.float32),
    }
    if tied:
        tree = jax.tree.map(lambda a: np.concatenate([a[:2], a[:1], a[3:]]), tree)
        tree["scale"][:, 0] = 1.5
    return tree


def _both(tree: dict):
    """The JAX and the port tree (``half`` in bf16 on both sides)."""
    jt = jax.tree.map(jnp.asarray, tree)
    jt["half"] = jt["half"].astype(jnp.bfloat16)
    tt = tree_map(torch.tensor, tree)
    tt["half"] = tt["half"].to(torch.bfloat16)
    return jt, tt


def _gap(jtree, ttree) -> float:
    want = jax.tree.leaves(jax.tree.map(lambda a: np.asarray(a, np.float32), jtree))
    got = [np.asarray(x, np.float32) for x in jax.tree.leaves(params_to_jax(ttree))]
    return float(max(np.abs(a - b).max() for a, b in zip(want, got)))


CASES = [(4, False), (5, False), (7, False), (4, True), (7, True)]
IDS = [f"K{k}{'-tied' if t else ''}" for k, t in CASES]


@pytest.mark.parametrize("k,tied", CASES, ids=IDS)
def test_coordinatewise_rules_match_jax(k, tied):
    """Median (an even K averages the middle pair) and trimmed mean are
    sorts and one arithmetic step: the same bits but for the order of the
    trimmed mean's sum (one fp32 ulp, 1e-6 at these magnitudes); bf16
    leaves stay bf16."""
    jt, tt = _both(_stack(k, tied))
    got, want = tops.fedmedian(tt), jops.fedmedian(jt)
    assert _gap(want, got) == 0.0
    assert got["half"].dtype == torch.bfloat16 and got["scale"].dtype == torch.float32
    for trim in (0, 1, (k - 1) // 2):
        assert _gap(jops.trimmed_mean(jt, trim), tops.trimmed_mean(tt, trim)) <= 1e-6
    # the clip center's fp32 median, as the round program takes it
    x = tt["Dense_0"]["kernel"]
    assert torch.equal(tops.median0(x), torch.tensor(np.asarray(jnp.median(jt["Dense_0"]["kernel"], axis=0))))


@pytest.mark.parametrize("k,tied", CASES, ids=IDS)
def test_krum_and_bulyan_match_jax(k, tied):
    """Krum's selection is exact, ties going to the lower index (row 2
    repeats row 0 in the tied stacks); Multi-Krum's order too. Bulyan's
    iterated picks equal JAX's host loop and its round-program form."""
    jt, tt = _both(_stack(k, tied))
    for f in range(0, max(1, (k - 3) // 2) + 1):
        for multi in (1, 2, k - 1):
            want = np.asarray(jops.krum_select(jt, n_byzantine=f, multi=multi))
            got = tops.krum_select(tt, n_byzantine=f, multi=multi).numpy()
            assert np.array_equal(want, got), (f, multi, want, got)
        assert _gap(jops.krum(jt, n_byzantine=f, multi=2), tops.krum(tt, n_byzantine=f, multi=2)) <= 1e-6
    f = (k - 3) // 4
    assert _gap(jops.bulyan(jt, n_byzantine=f), tops.bulyan(tt, n_byzantine=f)) <= 1e-6
    sel = jnp.arange(k, dtype=jnp.int32)
    want = jspmd._aggregate(jt, jnp.ones(k), jnp.ones(k), sel, "bulyan", f)
    assert _gap(want, tops.bulyan(tt, n_byzantine=f)) <= 1e-6
    with pytest.raises(ValueError, match="4f \\+ 3"):
        tops.bulyan(tt, n_byzantine=(k - 3) // 4 + 1)


@pytest.mark.parametrize("k,tied", CASES, ids=IDS)
def test_centered_clip_matches_jax(k, tied):
    """Three clipping iterations from a center, fp32: within 1e-6 (sum
    order of the per-node norms)."""
    jt, tt = _both(_stack(k, tied))
    rng = np.random.default_rng(1)
    center = jax.tree.map(lambda a: rng.standard_normal(a.shape[1:]).astype(np.float32) * 0.1, _stack(k, tied))
    for tau in (0.1, 1.0, 100.0):
        want = jops.centered_clip(jt, jax.tree.map(jnp.asarray, center), tau)
        got = tops.centered_clip(tt, tree_map(torch.tensor, center), tau)
        assert _gap(want, got) <= 1e-6


@pytest.mark.parametrize("opt", ["adam", "yogi", "adagrad"])
def test_fedopt_update_matches_jax(opt):
    """Three server steps with carried moments and a 1-based fp32 step:
    params, m and v within 2e-6 (Adam's ``b**t`` may differ by an ulp)."""
    rng = np.random.default_rng(2)
    prev = {"w": rng.standard_normal((6, 4)).astype(np.float32), "b": rng.standard_normal(4).astype(np.float32)}
    jp, tp = jax.tree.map(jnp.asarray, prev), tree_map(torch.tensor, prev)
    jm = jv = jax.tree.map(jnp.zeros_like, jp)
    tm = tv = tree_map(torch.zeros_like, tp)
    for step in range(1, 4):
        avg = jax.tree.map(lambda a: a + rng.standard_normal(a.shape).astype(np.float32) * 0.1, prev)
        jp, jm, jv = jops.fedopt_update(jp, jax.tree.map(jnp.asarray, avg), jm, jv, jnp.float32(step), opt=opt)
        tp, tm, tv = tops.fedopt_update(tp, tree_map(torch.tensor, avg), tm, tv, torch.tensor(float(step)), opt=opt)
        for a, b in ((jp, tp), (jm, tm), (jv, tv)):
            assert _gap(a, b) <= 2e-6
    with pytest.raises(ValueError, match="unknown server opt"):
        tops.fedopt_update(tp, tp, tm, tv, torch.tensor(1.0), opt="sgd")


# ---- one round of each through the federations ----

ROBUST = [
    dict(aggregator="median"), dict(aggregator="trimmed_mean", trim=1), dict(aggregator="krum", trim=1),
    dict(aggregator="bulyan", trim=0), dict(aggregator="clip", clip_tau=0.5),
]
ROBUST_IDS = [c["aggregator"] for c in ROBUST]


@pytest.mark.parametrize("kw", ROBUST, ids=ROBUST_IDS)
def test_robust_round_through_spmd_federation(kw):
    """The MLP federation at full width, 5 nodes with a 4-node train set,
    fp32 SGD (no Adam flips): two rounds, params within 2e-6."""
    from p2pfl_tpu.settings import Settings as JaxSettings
    from p2pfl_tpu_torch.settings import Settings

    data = dict(n_train=5 * 64, n_test=5 * 16, modes=8, noise=0.7, proto_scale=0.5)
    fed_kw = dict(n_nodes=5, batch_size=32, vote=True, seed=3, optimizer="sgd", learning_rate=0.1, **kw)
    jmodel = FlaxModel.create(JaxMLP(dtype=jnp.float32), (28, 28, 1), seed=0)
    tmodel = TorchModel(MLP(dtype=torch.float32), params_from_jax(jax.tree.map(np.asarray, jmodel.params), device="cpu"), (28, 28, 1))
    JaxSettings.TRAIN_SET_SIZE = Settings.TRAIN_SET_SIZE = 4
    jfed = JaxFederation.from_dataset(jmodel, JaxDataset.synthetic_mnist(**data), **fed_kw)
    tfed = SpmdFederation.from_dataset(tmodel, FederatedDataset.synthetic_mnist(**data), device="cpu", **fed_kw)
    for _ in range(2):
        je, te = jfed.run_round(eval=True), tfed.run_round(eval=True)
        assert float(te["train_loss"]) == pytest.approx(float(je["train_loss"]), rel=1e-6)
    assert tfed.train_mask.sum() == 4 and np.array_equal(jfed.train_mask, tfed.train_mask)
    assert _gap(jfed.params, tfed.params) <= 2e-6


SEQ, VOCAB = 16, 128
SMALL = dict(vocab_size=VOCAB, dim=64, n_layers=1, n_heads=4, n_kv_heads=2, ffn_hidden=96, lora_mlp=True)


def _lora_pair(**kw):
    jmodel = jtr.tiny_transformer(seq_len=SEQ, seed=0, cfg=jtr.TransformerConfig(**SMALL, dtype=jnp.float32))
    cfg = TransformerConfig(**SMALL, dtype=torch.float32)
    tmodel = TorchModel(CausalLM(cfg), params_from_jax(jax.tree.map(np.asarray, jmodel.params), device="cpu"),
                        (SEQ,), VOCAB, {"config": cfg})
    data = dict(vocab_size=VOCAB, seq_len=SEQ, n_train=32, n_test=8)
    fed_kw = dict(n_nodes=4, batch_size=4, vote=False, seed=3, learning_rate=1e-2, **kw)
    return (JaxLoraFederation.from_dataset(jmodel, JaxDataset.synthetic_lm(**data), **fed_kw),
            SpmdLoraFederation.from_dataset(tmodel, FederatedDataset.synthetic_lm(**data), device="cpu", **fed_kw))


@pytest.mark.parametrize("kw", ROBUST, ids=ROBUST_IDS)
def test_robust_round_through_lora_federation(kw):
    """One LoRA round per robust rule: loss to 2e-5, adapters within 5e-4
    (the LoRA tests' fp32 Adam bound at lr 1e-2). The clip rule needs a
    center that the LoRA round does not pass, in both packages: it
    raises in both."""
    jfed, tfed = _lora_pair(**kw)
    if kw["aggregator"] == "clip":
        with pytest.raises(ValueError):
            jfed.run_round()
        with pytest.raises(ValueError, match="center"):
            tfed.run_round()
        return
    je, te = jfed.run_round(), tfed.run_round()
    assert float(te["train_loss"]) == pytest.approx(float(je["train_loss"]), abs=2e-5)
    assert _gap(jfed.params, tfed.params) <= 5e-4
    jf, tf = jfed.run_fused(1), tfed.run_fused(1)
    assert float(tf[0]["train_loss"]) == pytest.approx(float(jf[0]["train_loss"]), abs=1e-4)
