"""The SPMD federations' meshes against the JAX package on the CPU:
``SpmdFederation`` over a nodes axis, ``SpmdLmFederation``'s expert
parallelism, ``SpmdLoraFederation``'s base split over the model axis and
the GPipe ``PipelineFederation``.

JAX's side runs on the virtual CPU devices ``tests/conftest.py`` forces;
the port's meshes repeat the CPU (``federation_mesh(..., devices=["cpu"]
* k)``). One flax init is converted for both sides, data and seeds are
the same. Tolerances, stated where used: fp32 on both sides; the port
against itself bit for bit across slot counts (the fold sums node by
node); against JAX ``rtol 2e-5, atol 1e-6`` a step, 1e-5 relative L2
after SGD rounds, and for Adam rounds the verify notes' bound (an element
whose gradient sits at rounding noise flips by ±lr a step).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2pfl_tpu.learning.dataset import FederatedDataset as JaxDataset
from p2pfl_tpu.models import transformer as jtr
from p2pfl_tpu.models.base import FlaxModel
from p2pfl_tpu.models.vision import MLP as JaxMLP
from p2pfl_tpu.parallel import PipelineFederation as JaxPipelineFederation
from p2pfl_tpu.parallel import SpmdFederation as JaxFederation
from p2pfl_tpu.parallel import SpmdLmFederation as JaxLmFederation
from p2pfl_tpu.parallel import mesh as jmesh
from p2pfl_tpu.parallel import sharding as jsh
from p2pfl_tpu_torch import DeviceUnavailableError
from p2pfl_tpu_torch.convert import params_from_jax, params_to_jax
from p2pfl_tpu_torch.learning.dataset import FederatedDataset
from p2pfl_tpu_torch.learning.optimizers import adafactor
from p2pfl_tpu_torch.models import transformer as ttr
from p2pfl_tpu_torch.models.base import TorchModel
from p2pfl_tpu_torch.models.vision import MLP
from p2pfl_tpu_torch.ops.tree import tree_items, tree_leaves, tree_map
from p2pfl_tpu_torch.parallel import sharding as tsh
from p2pfl_tpu_torch.parallel.mesh import Mesh, federation_mesh, pipeline_mesh
from p2pfl_tpu_torch.parallel.spmd import SpmdFederation
from p2pfl_tpu_torch.parallel.spmd_lm import PipelineFederation, SpmdLmFederation
from p2pfl_tpu_torch.parallel.spmd_lora import SpmdLoraFederation
from p2pfl_tpu_torch.settings import Settings

torch.set_num_threads(2)

CPU = ["cpu"]


def _equal(a, b) -> bool:
    """Bit-equal trees (a placed leaf compared shard by shard)."""
    la, lb = torch.utils._pytree.tree_leaves(a), torch.utils._pytree.tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def _rel_l2(want, got) -> float:
    a, b = (np.concatenate([np.asarray(x, np.float64).ravel() for x in jax.tree.leaves(t)]) for t in (want, got))
    return float(np.linalg.norm(a - b) / np.linalg.norm(a))


def _spec(sharding) -> tuple:
    """A JAX spec as the port writes it (a tuple, trailing Nones kept)."""
    return tuple(sharding.spec)


# ---- SpmdFederation over a nodes axis ----


def _mlp_pair(seed: int = 0):
    """A JAX and a port MLP (fp32 compute) from one flax init."""
    jm = FlaxModel.create(JaxMLP(dtype=jnp.float32), (28, 28, 1), seed=seed)
    tm = TorchModel(MLP(dtype=torch.float32), params_from_jax(jax.tree.map(np.asarray, jm.params), device="cpu"),
                    (28, 28, 1))
    return jm, tm


MLP_DATA = dict(n_train=8 * 48, n_test=8 * 8, seed=5)


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("agg", ["fedavg", "trimmed_mean"])
def test_spmd_federation_over_k_slots_is_one_slot_bit_for_bit(k, agg):
    """8 MLP nodes over k rows of the nodes axis: every node-stacked tensor
    placed N/k a row, each row's nodes stepped on its slot, the fold node
    by node: two voted rounds and a fused span with eval give the one-slot
    federation's params, losses and accuracies bit for bit."""
    _, tm = _mlp_pair()
    data = FederatedDataset.synthetic_mnist(**MLP_DATA)
    kw = dict(n_nodes=8, batch_size=16, vote=True, seed=3, aggregator=agg, trim=1, keep_opt_state=True, device="cpu")
    one = SpmdFederation.from_dataset(tm, data, **kw)
    many = SpmdFederation.from_dataset(tm, data, mesh=federation_mesh(k, devices=CPU * k), **kw)
    x_all = many.x_all
    assert isinstance(x_all, tsh.SlotSharded) and len(x_all.shards) == k and x_all.shards[0].shape[0] == 8 // k
    assert all(len(x.shards) == k for x in tree_leaves(many.params))
    for fed in (one, many):
        fed.entries = [fed.run_round(eval=True) for _ in range(2)] + fed.run_fused(2, eval=True)
    for a, b in zip(one.entries, many.entries):
        assert float(a["train_loss"]) == float(b["train_loss"]) and float(a["test_acc"]) == float(b["test_acc"])
    assert all(_equal(one.node_params(i), many.node_params(i)) for i in range(8))
    assert one.evaluate() == many.evaluate()


@pytest.mark.parametrize("k", [2, 4])
def test_dp_sgd_over_k_slots(k):
    """DP-SGD on a nodes axis of k rows, each node's noise from its own
    generator on its row's slot: clipping alone gives the one-slot
    federation's bits, and so does noise (a node's noise does not depend
    on its row); two federations of one seed give the same bits, the
    noise moves the params off the noiseless run's, and the accountant
    counts what one slot counts."""
    _, tm = _mlp_pair()
    data = FederatedDataset.synthetic_mnist(**MLP_DATA)
    kw = dict(n_nodes=8, batch_size=16, vote=False, seed=3, optimizer="sgd", learning_rate=0.05, dp_clip=1.0,
              device="cpu")
    mesh = federation_mesh(k, devices=CPU * k)
    feds = {}
    for name, extra in (("one", {}), ("many", dict(mesh=mesh)), ("noised", dict(mesh=mesh, dp_noise=1.1)),
                        ("noised_again", dict(mesh=mesh, dp_noise=1.1)), ("noised_one", dict(dp_noise=1.1))):
        fed = SpmdFederation.from_dataset(tm, data, **kw, **extra)
        fed.losses = [float(fed.run_round()["train_loss"])] + [float(e["train_loss"]) for e in fed.run_fused(2)]
        feds[name] = fed
    one, many, noised, again = feds["one"], feds["many"], feds["noised"], feds["noised_again"]
    assert one.losses == many.losses and all(_equal(one.node_params(i), many.node_params(i)) for i in range(8))
    assert noised.losses == again.losses and all(_equal(noised.node_params(i), again.node_params(i)) for i in range(8))
    assert all(math.isfinite(x) for x in noised.losses)
    assert not _equal(noised.node_params(0), many.node_params(0))
    noised_one = feds["noised_one"]
    assert noised.losses == noised_one.losses
    assert all(_equal(noised.node_params(i), noised_one.node_params(i)) for i in range(8))
    assert noised.accountant.epsilon() == noised_one.accountant.epsilon()


def test_spmd_federation_mesh_matches_jax():
    """The port over 4 slots against JAX's federation over its default
    mesh (8 virtual devices, one node each): two SGD rounds of 8 nodes
    from one flax init, the params within 1e-5 relative L2 and the
    losses within 1e-5 (fp32; the GEMMs and the fold sum in other
    orders)."""
    jm, tm = _mlp_pair()
    kw = dict(n_nodes=8, batch_size=16, vote=False, seed=3, optimizer="sgd", learning_rate=0.05)
    jfed = JaxFederation.from_dataset(jm, JaxDataset.synthetic_mnist(**MLP_DATA), **kw)
    tfed = SpmdFederation.from_dataset(tm, FederatedDataset.synthetic_mnist(**MLP_DATA), device="cpu",
                                       mesh=federation_mesh(4, devices=CPU * 4), **kw)
    assert dict(jfed.mesh.shape)[Settings.MESH_NODES_AXIS] == 8
    for _ in range(2):
        jl = float(jfed.run_round()["train_loss"])
        tl = float(tfed.run_round()["train_loss"])
        assert abs(jl - tl) <= 1e-5 * abs(jl)
    for i in (0, 7):
        jparams = jax.tree.map(lambda a, i=i: np.asarray(a)[i], jfed.params)
        assert _rel_l2(jparams, params_to_jax(tfed.node_params(i))) <= 1e-5


def test_mesh_refusals():
    """A non-Mesh, a slot of another device type, a node count the rows do
    not divide, a model axis for a federation that keeps a node on one
    slot, an expert_parallel wider than the devices or than the mesh's
    model axis, and a transform that is not elementwise over a split
    node: each raises at construction."""
    _, tm = _mlp_pair()
    data = FederatedDataset.synthetic_mnist(**MLP_DATA)
    kw = dict(batch_size=16, vote=False, device="cpu")
    with pytest.raises(TypeError, match="must be a p2pfl_tpu_torch.parallel.mesh.Mesh"):
        SpmdFederation.from_dataset(tm, data, n_nodes=8, mesh=object(), **kw)
    with pytest.raises(ValueError, match="do not fold evenly"):
        SpmdFederation.from_dataset(tm, data, n_nodes=6, mesh=federation_mesh(4, devices=CPU * 4), **kw)
    with pytest.raises(ValueError, match="needs a subclass"):
        SpmdFederation.from_dataset(tm, data, n_nodes=8, mesh=federation_mesh(4, 2, devices=CPU * 8), **kw)
    cuda_slots = np.empty((2, 1), dtype=object)
    cuda_slots[:] = [[torch.device("cuda", 0)], [torch.device("cuda", 0)]]
    with pytest.raises(ValueError, match="mesh slot on cuda:0: the federation runs on cpu"):
        SpmdFederation.from_dataset(tm, data, n_nodes=8, mesh=Mesh(cuda_slots, ("nodes", "model")), **kw)
    cfg = ttr.TransformerConfig(**MOE_CFG, dtype=torch.float32)
    model = ttr.tiny_transformer(seq_len=32, cfg=cfg, device="cpu")
    lm_data = FederatedDataset.synthetic_lm(**MOE_DATA)
    with pytest.raises(ValueError, match="expert_parallel=2 needs at least 2 devices, have 1"):
        SpmdLmFederation.from_dataset(model, lm_data, n_nodes=4, expert_parallel=2, **kw)
    with pytest.raises(ValueError, match="expert_parallel=4 against a mesh"):
        SpmdLmFederation.from_dataset(model, lm_data, n_nodes=4, expert_parallel=4,
                                      mesh=federation_mesh(4, 2, devices=CPU * 8), **kw)
    with pytest.raises(ValueError, match="not elementwise"):
        SpmdLmFederation.from_dataset(model, lm_data, n_nodes=4, mesh=federation_mesh(2, 2, devices=CPU * 4),
                                      tx=adafactor(1e-2), **kw)


# ---- expert parallelism ----

MOE_CFG = dict(vocab_size=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=4, ffn_hidden=128, lora_rank=0,
               n_experts=4, moe_top_k=2)
MOE_DATA = dict(n_train=8 * 32, n_test=64, seq_len=32, vocab_size=256)


def _moe_models(seed: int = 0):
    jcfg = jtr.TransformerConfig(**MOE_CFG, dtype=jnp.float32)
    jm = jtr.tiny_transformer(seq_len=32, cfg=jcfg, seed=seed)
    tm = ttr.tiny_transformer(seq_len=32, cfg=ttr.TransformerConfig(**MOE_CFG, dtype=torch.float32), device="cpu")
    return jm, dataclasses.replace(tm, params=params_from_jax(jax.tree.map(np.asarray, jm.params), device="cpu"))


def _ep_fed(tm, n=8, ep=2, rows=4, **kw):
    return SpmdLmFederation.from_dataset(
        tm, FederatedDataset.synthetic_lm(**MOE_DATA), n_nodes=n, batch_size=16, vote=False, seed=5, device="cpu",
        mesh=federation_mesh(rows, ep, devices=CPU * (rows * ep)), expert_parallel=ep, **kw)


def test_expert_parallel_leaves_shard_like_jax():
    """dp x ep x tp layout: every node-stacked leaf's spec and per-slot
    block shape equal JAX's ``NamedSharding`` on its (4, 2) default mesh
    (expert stacks ``P(nodes, model)``, routers and norms replicated over
    model, the dense projections column- and row-parallel)."""
    jm, tm = _moe_models()
    jfed = JaxLmFederation.from_dataset(jm, JaxDataset.synthetic_lm(**MOE_DATA), n_nodes=4, batch_size=16,
                                        vote=False, expert_parallel=2)
    tfed = _ep_fed(tm, n=4)
    assert dict(jfed.mesh.shape) == dict(tfed.mesh.shape) == {Settings.MESH_NODES_AXIS: 4, Settings.MESH_MODEL_AXIS: 2}
    jleaves = {jsh._path_str(kp): x for kp, x in jax.tree_util.tree_flatten_with_path(jfed.params)[0]}
    tleaves = dict(tree_items(tfed.params))
    assert set(jleaves) == set(tleaves)
    for path, jx in jleaves.items():
        tx = tleaves[path]
        assert _spec(jx.sharding) == tx.spec, path
        assert tuple(jx.sharding.shard_shape(jx.shape)) == tuple(tx.shards[0].shape), path
    nodes, model = Settings.MESH_NODES_AXIS, Settings.MESH_MODEL_AXIS
    assert tleaves["layer_0/mlp/w1"].spec[:2] == (nodes, model)
    assert tleaves["layer_0/mlp/router"].spec == (nodes,)
    assert tleaves["layer_0/attn/wq/kernel"].spec == (nodes, None, model)
    # the Adam moments take the params' layout
    assert all(m.spec == p.spec for m, p in zip(tree_leaves(tfed.opt_state.mu), tree_leaves(tfed.params)))


def test_expert_parallel_round_matches_jax():
    """One SGD round of 4 MoE nodes at expert_parallel 2, from one flax
    init: the port's (4, 2) CPU mesh against JAX's (4, 2) virtual mesh,
    the loss within 1e-5 and the params within 1e-5 relative L2 (a row of
    one node routes in another contraction order than JAX's, fp32 ulps)."""
    jm, tm = _moe_models(seed=7)
    kw = dict(n_nodes=4, batch_size=16, vote=False, seed=5, optimizer="sgd", learning_rate=0.05, expert_parallel=2)
    jfed = JaxLmFederation.from_dataset(jm, JaxDataset.synthetic_lm(**MOE_DATA), **kw)
    tfed = SpmdLmFederation.from_dataset(tm, FederatedDataset.synthetic_lm(**MOE_DATA), device="cpu",
                                         mesh=federation_mesh(4, 2, devices=CPU * 8), **kw)
    jl = float(jfed.run_round()["train_loss"])
    tl = float(tfed.run_round()["train_loss"])
    assert abs(jl - tl) <= 1e-5 * abs(jl)
    jparams = jax.tree.map(lambda a: np.asarray(a)[2], jfed.params)
    assert _rel_l2(jparams, params_to_jax(tfed.node_params(2))) <= 1e-5


def test_expert_parallel_trains_in_sync_and_fused_equals_rounds():
    """8 MoE nodes at expert_parallel 2 on (4, 2): the loss falls over
    three rounds, every node holds the same params after a round, three
    fused rounds equal three rounds bit for bit, and the run equals
    expert_parallel 1 on the same nodes axis (4, 1) bit for bit."""
    _, tm = _moe_models()
    a, b, c = _ep_fed(tm), _ep_fed(tm), _ep_fed(tm, ep=1)
    la = [float(a.run_round()["train_loss"]) for _ in range(3)]
    lb = [float(e["train_loss"]) for e in b.run_fused(3)]
    lc = [float(c.run_round()["train_loss"]) for _ in range(3)]
    assert la[-1] < la[0] and la == lb == lc
    assert all(_equal(a.node_params(0), a.node_params(i)) for i in range(1, 8))
    assert _equal(a.node_params(5), b.node_params(5)) and _equal(a.node_params(5), c.node_params(5))
    assert 0.0 <= a.evaluate()["test_acc"] <= 1.0


def test_expert_parallel_checkpoint_roundtrip(tmp_path):
    """save/restore carries the EP federation's placed params and Adam
    moments: a federation from another init restored from the checkpoint
    holds the same shards and continues identically."""
    _, tm = _moe_models()
    fed = _ep_fed(tm)
    fed.run_round()
    fed.save(str(tmp_path / "lmfed"))
    other = dataclasses.replace(tm, params=ttr.tiny_transformer(
        seq_len=32, seed=9, cfg=ttr.TransformerConfig(**MOE_CFG, dtype=torch.float32), device="cpu").params)
    fed2 = _ep_fed(other)
    assert not _equal(fed.node_params(0), fed2.node_params(0))
    fed2.restore(str(tmp_path / "lmfed"))
    assert fed2.round == 1 and all(isinstance(x, tsh.SlotSharded) for x in tree_leaves(fed2.params))
    assert _equal(fed.params, fed2.params) and _equal(fed.opt_state.nu, fed2.opt_state.nu)
    assert float(fed.run_round()["train_loss"]) == float(fed2.run_round()["train_loss"])
    assert _equal(fed.node_params(3), fed2.node_params(3))


# ---- the LoRA base split over the model axis ----

LORA_CFG = dict(vocab_size=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, ffn_hidden=128, lora_rank=4,
                lora_mlp=True)
LORA_DATA = dict(vocab_size=256, seq_len=32, n_train=8 * 32, n_test=64)


def test_lora_base_split_places_like_jax():
    """``shard_transformer`` of the frozen base on a (1, 4) mesh: every
    leaf's spec and block shape equal JAX's; the federation's base on a
    (2, 4) mesh holds each slot's accounting bytes, and its adapters are
    node-stacked over the nodes axis."""
    jcfg = jtr.TransformerConfig(**LORA_CFG, dtype=jnp.float32)
    jm = jtr.tiny_transformer(seq_len=32, cfg=jcfg)
    jplaced = jsh.shard_transformer(jmesh.federation_mesh(model_parallel=4, devices=jax.devices()[:4]), jm.params)
    tplaced = tsh.shard_transformer(federation_mesh(1, 4, devices=CPU * 4), params_from_jax(jm.params, device="cpu"))
    tleaves = dict(tree_items(tplaced))
    for kp, jx in jax.tree_util.tree_flatten_with_path(jplaced)[0]:
        path = jsh._path_str(kp)
        tx = tleaves[path]
        if isinstance(tx, tsh.SlotSharded):
            assert _spec(jx.sharding) == tx.spec, path
            assert tuple(jx.sharding.shard_shape(jx.shape)) == tuple(tx.shards[0].shape), path
        else:
            assert jx.sharding.is_fully_replicated, path
    tm = ttr.tiny_transformer(seq_len=32, cfg=ttr.TransformerConfig(**LORA_CFG, dtype=torch.float32), device="cpu")
    mesh = federation_mesh(2, 4, devices=CPU * 8)
    fed = SpmdLoraFederation.from_dataset(tm, FederatedDataset.synthetic_lm(**LORA_DATA), n_nodes=4, batch_size=8,
                                          vote=False, mesh=mesh, model_parallel_base=True, device="cpu")
    meta = tree_map(lambda x: torch.empty(tuple(x.shape), dtype=x.dtype, device="meta"), fed.base)
    assert set(tsh.slot_bytes(fed.base, mesh=mesh).values()) == {tsh.shard_bytes_accounting(mesh, meta)}
    assert all(x.spec == (Settings.MESH_NODES_AXIS,) and x.shards[0].shape[0] == 2 for x in tree_leaves(fed.params))


def test_lora_base_split_forward_and_round_equal_the_replicated_base():
    """The split base gathered is the replicated base (a copy of its
    bits): the forward equals the replicated one, and a round of 4 nodes on
    a (2, 4) mesh with the base split equals the replicated base's and the
    one-slot federation's bit for bit, eval included; the round against
    JAX's one-slot LoRA federation within 1e-5 (fp32)."""
    tcfg = ttr.TransformerConfig(**LORA_CFG, dtype=torch.float32)
    tm = ttr.tiny_transformer(seq_len=32, cfg=tcfg, device="cpu")
    placed = tsh.shard_transformer(federation_mesh(1, 4, devices=CPU * 4), tm.params)
    toks = torch.arange(32)[None] % 256
    assert torch.equal(tm.module(tsh.gather_tree(placed), toks), tm.module(tm.params, toks))
    kw = dict(n_nodes=4, batch_size=8, vote=False, seed=2, device="cpu")
    data = FederatedDataset.synthetic_lm(**LORA_DATA)
    mesh = federation_mesh(2, 4, devices=CPU * 8)
    feds = [SpmdLoraFederation.from_dataset(tm, data, mesh=mesh, model_parallel_base=mp, **kw) for mp in (True, False)]
    feds.append(SpmdLoraFederation.from_dataset(tm, data, **kw))
    losses = [[float(f.run_round()["train_loss"])] + [float(e["train_loss"]) for e in f.run_fused(2)] for f in feds]
    assert losses[0] == losses[1] == losses[2]
    assert all(_equal(feds[0].node_params(i), f.node_params(i)) for f in feds[1:] for i in range(4))
    assert feds[0].evaluate() == feds[2].evaluate()


# ---- GPipe: PipelineFederation ----

PIPE_CFG = dict(vocab_size=256, dim=64, n_layers=4, n_heads=4, n_kv_heads=4, ffn_hidden=128, lora_rank=0)
PIPE_DATA = dict(n_train=2 * 48, n_test=32, seq_len=32, vocab_size=256)


def _pipe_models(**over):
    cfg = {**PIPE_CFG, **over}
    jm = jtr.tiny_transformer(seq_len=32, cfg=jtr.TransformerConfig(**cfg, dtype=jnp.float32))
    tm = ttr.tiny_transformer(seq_len=32, cfg=ttr.TransformerConfig(**cfg, dtype=torch.float32), device="cpu")
    return jm, dataclasses.replace(tm, params=params_from_jax(jax.tree.map(np.asarray, jm.params), device="cpu"))


def _pipe_fed(tm, data=None, **kw):
    data = data or FederatedDataset.synthetic_lm(**PIPE_DATA)
    shards = [data.partition(i, 2) for i in range(2)]
    stages = kw.pop("n_stages", 4)
    return PipelineFederation(tm, shards, mesh=pipeline_mesh(stages, devices=CPU * stages), batch_size=8, seed=0,
                              device="cpu", **kw)


def test_pipeline_federation_matches_jax_trajectory():
    """2 nodes x 4 GPipe stages, two rounds from one flax init, one seed:
    the shuffles are JAX's (one permutation an epoch, node by node), each
    round's loss within 1e-5 of JAX's and the params within the Adam bound
    (each element within 2·lr a step, the mean gap under 1e-6; fp32);
    the evaluation within 2 tokens of JAX's."""
    jm, tm = _pipe_models()
    jdata = JaxDataset.synthetic_lm(**PIPE_DATA)
    jfed = JaxPipelineFederation(jm, [jdata.partition(i, 2) for i in range(2)], n_stages=4, batch_size=8, seed=0)
    tfed = _pipe_fed(tm)
    for _ in range(2):
        jl = jfed.run_round()["train_loss"]
        tl = tfed.run_round()["train_loss"]
        assert abs(jl - tl) <= 1e-5 * abs(jl)
    steps = 2 * (PIPE_DATA["n_train"] // 2 // 8)
    diffs = [np.abs(np.asarray(a) - np.asarray(b)) for a, b in
             zip(jax.tree.leaves(jfed.params), jax.tree.leaves(params_to_jax(tfed.params)))]
    assert max(float(d.max()) for d in diffs) <= 2 * 1e-3 * steps
    assert np.mean([d.mean() for d in diffs]) < 1e-6
    je, te = jfed.evaluate(), tfed.evaluate()
    assert abs(je["test_acc"] - te["test_acc"]) <= 2 / (16 * 32)


def test_pipelined_moe_federation_trains():
    """MoE blocks inside GPipe stages inside a federation: the routers'
    aux rides the pipeline and three rounds lower the loss."""
    _, tm = _pipe_models(n_experts=4, moe_top_k=2)
    fed = _pipe_fed(tm, learning_rate=3e-3)
    losses = [fed.run_round()["train_loss"] for _ in range(3)]
    assert losses[-1] < losses[0], losses


def test_pipeline_federation_rounds_profile_and_checks():
    """``profile=True`` fills ``last_profile`` and any other round clears
    it; a zero-batch round logs, records NaN and leaves the global model;
    keep_opt_state carries each node's Adam; the constructor's checks
    (stage count, microbatches, undersized shards, a non-Mesh) raise."""
    _, tm = _pipe_models()
    fed = _pipe_fed(tm, n_stages=2)
    before = tree_map(torch.clone, fed.params)
    entry = fed.run_round(epochs=0, profile=True)
    assert math.isnan(entry["train_loss"]) and fed.last_profile["node_epoch_s"] == [0.0, 0.0]
    assert _equal(before, fed.params)
    fed.run_round(profile=True)
    assert all(s > 0 for s in fed.last_profile["node_epoch_s"])
    fed.run_round()
    assert fed.last_profile is None and fed.round == 3
    kept = _pipe_fed(tm, keep_opt_state=True)
    kept.run_round()
    assert int(kept._opts[0][0].count) == PIPE_DATA["n_train"] // 2 // 8
    data = FederatedDataset.synthetic_lm(**PIPE_DATA)
    with pytest.raises(ValueError, match="not divisible into 3 stages"):
        PipelineFederation(tm, [data], mesh=pipeline_mesh(3, devices=CPU * 3), device="cpu")
    with pytest.raises(ValueError, match="not divisible into 3 microbatches"):
        PipelineFederation(tm, [data], mesh=pipeline_mesh(2, devices=CPU * 2), n_micro=3, device="cpu")
    with pytest.raises(ValueError, match="batch size"):
        PipelineFederation(tm, [data.partition(0, 2)], n_stages=2, batch_size=64, device="cpu")
    with pytest.raises(TypeError, match="Mesh"):
        PipelineFederation(tm, [data], mesh=object(), device="cpu")
    # the stage count defaults from the devices: one device asked for, one stage
    assert PipelineFederation(tm, [data], device="cpu").mesh.shape == {"pipe": 1}
    if not torch.cuda.is_available():
        # device=None is the card, as every entry point's default
        with pytest.raises(DeviceUnavailableError):
            PipelineFederation(tm, [data])
        with pytest.raises(DeviceUnavailableError):
            pipeline_mesh(2)
