"""The SPMD federations' meshes and GPipe on the card: slots of one card
as a nodes axis, expert parallelism, the LoRA base split over the model
axis, GPipe with the flash kernels in its stages, and the captured GPipe
step.

Marked ``cuda``: they need an NVIDIA GPU with ``nvcc`` and skip elsewhere.
This file imports only the port (the card machine has no flax):

    timeout 600 python -m pytest -m cuda tests/test_torch_cuda_meshes.py

``chip_smoke.py --only meshes`` drives the same paths at full width.
"""

import math

import pytest
import torch

from p2pfl_tpu_torch.learning.dataset import FederatedDataset
from p2pfl_tpu_torch.learning.learner import softmax_cross_entropy
from p2pfl_tpu_torch.models.transformer import TransformerConfig, tiny_transformer
from p2pfl_tpu_torch.models.vision import mlp
from p2pfl_tpu_torch.ops import _kernels
from p2pfl_tpu_torch.ops.flash_attention import FlashConfig
from p2pfl_tpu_torch.ops.tree import tree_items, tree_leaves, tree_map, tree_unflatten
from p2pfl_tpu_torch.parallel import sharding as tsh
from p2pfl_tpu_torch.parallel.mesh import federation_mesh, pipeline_mesh
from p2pfl_tpu_torch.parallel.pipeline import pipelined_lm_apply
from p2pfl_tpu_torch.parallel.spmd import SpmdFederation
from p2pfl_tpu_torch.parallel.spmd_lm import PipelineFederation, SpmdLmFederation
from p2pfl_tpu_torch.parallel.spmd_lora import SpmdLoraFederation

pytestmark = pytest.mark.cuda

#: config 5's widths (22L cut to 2-4 layers here)
C5 = dict(vocab_size=4096, dim=2048, n_heads=32, n_kv_heads=4, ffn_hidden=5632)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    _kernels.build()
    return torch.device("cuda")


def _equal(a, b) -> bool:
    """Bit-equal trees (compared on the host: the leaves may lie on two cards)."""
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x.cpu(), y.cpu()) for x, y in zip(la, lb))


def _value_and_grad(params, fwd, x, y):
    paths = [p for p, _ in tree_items(params)]
    leaves = [v.detach().requires_grad_(True) for v in tree_leaves(params)]
    logits, aux = fwd(tree_unflatten(dict(zip(paths, leaves))), x)
    loss = softmax_cross_entropy(logits, y).mean() + aux
    return loss.detach(), torch.autograd.grad(loss, leaves)


def test_gpipe_at_config5_width_runs_flash_in_every_stage(cuda):
    """GPipe over 2 stages at config 5's width (4 layers), batch 2 in 2
    microbatches: kernels 1 and 2 launch once a layer a microbatch; the
    loss equals the monolithic step's (a sequence's forward does not
    depend on its batch: the gap read 0 in every run at 22 layers) and the
    grads agree within 2e-2 relative L2 (the weight gradients sum the
    microbatches in another order)."""
    cfg = TransformerConfig(**C5, n_layers=4, lora_rank=0)
    model = tiny_transformer(seq_len=1024, cfg=cfg, attn="flash")
    gen = torch.Generator(device=cuda).manual_seed(5)
    tok = torch.randint(0, cfg.vocab_size, (2, 1025), device=cuda, generator=gen)
    mesh = pipeline_mesh(2, devices=["cuda:0"] * 2)
    _kernels.reset_launches()
    lp, gp = _value_and_grad(model.params, lambda p, x: pipelined_lm_apply(
        p, x, cfg, mesh, n_micro=2, attn_fn=model.module.attn_fn, return_aux=True), tok[:, :-1], tok[:, 1:])
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["flash_fwd"] == 8 and _kernels.LAUNCHES["flash_bwd_dkvq"] == 8
    lm, gm = _value_and_grad(model.params, model.module.forward_with_aux, tok[:, :-1], tok[:, 1:])
    num = sum(float(((a.float() - b.float()) ** 2).sum()) for a, b in zip(gp, gm))
    den = sum(float((b.float() ** 2).sum()) for b in gm)
    assert math.sqrt(num / den) <= 2e-2
    assert float(lp) == float(lm)


def test_pipeline_federation_captured_step_equals_eager(cuda):
    """On one card the GPipe train step is a captured CUDA graph: a
    replayed epoch gives the eager steps' params, Adam state and loss bit
    for bit, and a profiled round fills ``last_profile``."""
    cfg = TransformerConfig(vocab_size=256, dim=64, n_layers=4, n_heads=4, n_kv_heads=4, ffn_hidden=128, lora_rank=0)
    data = FederatedDataset.synthetic_lm(vocab_size=256, seq_len=32, n_train=2 * 64, n_test=32)
    shards = [data.partition(i, 2) for i in range(2)]
    fed = PipelineFederation(tiny_transformer(seq_len=32, cfg=cfg), shards, mesh=pipeline_mesh(4, devices=["cuda:0"] * 4),
                             batch_size=8, n_micro=4, seed=3)
    xs, ys = next(fed._node_batches(0, 1))
    opt = fed._init_opt(fed.params)
    p, o, losses = fed.params, opt, []
    for b in range(xs.shape[0]):  # the eager steps
        p, o, loss = fed._train_step(p, o, xs[b], ys[b])
        losses.append(loss)
    cp, co, closs = fed._epoch(fed.params, opt, xs, ys)
    assert fed._steps
    assert torch.equal(closs, torch.stack(losses).mean())
    state = torch.utils._pytree.tree_leaves
    assert _equal(cp, p) and all(torch.equal(a, b) for a, b in zip(state(co), state(o), strict=True))
    fed.run_round(profile=True)
    assert fed.last_profile is not None and len(fed.last_profile["node_epoch_s"]) == 2


def test_expert_parallel_is_bit_equal_to_its_nodes_axis_and_holds_half_the_experts(cuda):
    """Config 10's MoE at 2 layers, 8 nodes: expert_parallel 2 on a (4, 2)
    mesh of the card against 1 on (4, 1), two rounds and a fused span:
    params and losses bit-equal; each slot holds half its nodes' experts,
    as ``SlotSharding.shard_shape`` counts."""
    cfg = TransformerConfig(vocab_size=512, dim=128, n_layers=2, n_heads=8, n_kv_heads=8, ffn_hidden=256,
                            lora_rank=0, n_experts=8, moe_top_k=2)
    data = FederatedDataset.synthetic_lm(vocab_size=512, n_train=8 * 32, n_test=64)
    feds, losses = {}, {}
    for ep in (2, 1):
        model = tiny_transformer(seq_len=128, cfg=cfg)
        fed = SpmdLmFederation.from_dataset(
            model, data, n_nodes=8, batch_size=16, vote=False, seed=3,
            mesh=federation_mesh(4, model_parallel=ep, devices=["cuda:0"] * (4 * ep)), expert_parallel=ep)
        losses[ep] = [float(fed.run_round()["train_loss"]) for _ in range(2)]
        losses[ep] += [float(e["train_loss"]) for e in fed.run_fused(2)]
        feds[ep] = fed
    assert losses[2] == losses[1]
    assert all(_equal(feds[2].node_params(i), feds[1].node_params(i)) for i in range(8))
    w1 = dict(tree_items(feds[2].params))["layer_0/mlp/w1"]
    per_slot = tsh.slot_bytes({"w1": w1}, mesh=feds[2].mesh)
    assert set(per_slot.values()) == {math.prod(w1.sharding.shard_shape(tuple(w1.shape))) * w1.element_size()}
    assert w1.shards[0].shape[:2] == (2, 4)  # 2 nodes a row, 4 of 8 experts a slot


def test_lora_base_split_is_bit_equal_to_the_replicated_base(cuda):
    """Config 5's width at 2 layers, 4 nodes on a (4, 2) mesh, split
    backward: the base split over the model axis gives the replicated
    base's round bit for bit; each slot holds the accounting's bytes;
    kernels 1, 3, 4 launch once a layer a step a row."""
    cfg = TransformerConfig(**C5, n_layers=2, lora_rank=8, lora_mlp=True, flash_config=FlashConfig(bwd_mode="split"))
    model = tiny_transformer(seq_len=1024, cfg=cfg, attn="flash")
    data = FederatedDataset.synthetic_lm(vocab_size=4096, seq_len=1024, n_train=8, n_test=8)
    mesh = federation_mesh(4, model_parallel=2, devices=["cuda:0"] * 8)
    out = {}
    for mp in (True, False):
        fed = SpmdLoraFederation.from_dataset(model, data, n_nodes=4, batch_size=1, vote=False, seed=3, mesh=mesh,
                                              model_parallel_base=mp)
        _kernels.reset_launches()
        loss = float(fed.run_round()["train_loss"])
        out[mp] = (fed, loss, dict(_kernels.LAUNCHES))
    (a, la, ka), (b, lb, _) = out[True], out[False]
    assert la == lb and all(_equal(a.node_params(i), b.node_params(i)) for i in range(4))
    meta = tree_map(lambda x: torch.empty(tuple(x.shape), dtype=x.dtype, device="meta"), a.base)
    assert set(tsh.slot_bytes(a.base, mesh=mesh).values()) == {tsh.shard_bytes_accounting(mesh, meta)}
    want = 4 * a._nb * cfg.n_layers
    assert ka["flash_fwd"] == ka["flash_bwd_dq"] == ka["flash_bwd_dkv"] == want


def test_spmd_federation_over_slots_of_the_card(cuda):
    """16 MLP nodes over 4 slots against one slot: a round and a captured
    fused span, replayed from its graph, give the one-slot federation's
    losses and params bit for bit (the fold sums node by node; the batched
    GEMMs gave 4 and 16 nodes the same bits on the card)."""
    data = FederatedDataset.synthetic_mnist(n_train=16 * 64, n_test=16 * 8, seed=5)
    feds, losses = {}, {}
    for k in (1, 4):
        fed = SpmdFederation.from_dataset(mlp(seed=0), data, n_nodes=16, batch_size=32, vote=False, seed=3,
                                          keep_opt_state=True, mesh=federation_mesh(k, devices=["cuda:0"] * k))
        losses[k] = [float(fed.run_round()["train_loss"])]
        losses[k] += [float(e["train_loss"]) for e in fed.run_fused(3) + fed.run_fused(3)]
        feds[k] = fed
    assert len(feds[4]._spans) == 1
    assert losses[1] == losses[4]
    assert all(_equal(feds[1].node_params(i), feds[4].node_params(i)) for i in range(16))


def test_meshes_on_two_cards_or_more_equal_one_card(cuda):
    """Rows, stages and shards on distinct cards (every hand-off a real
    copy, each row's nodes stepping on their card, the fold crossing
    cards) against the same meshes on one card: a nodes axis of MLP nodes
    and GPipe stages (eager across cards, captured on one card), an
    expert-parallel LM and the LoRA base split, bit for bit (one card
    model, the same kernels)."""
    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        pytest.skip("needs two cards or more")
    k = 4 if n_cards >= 4 else 2
    cards = [f"cuda:{i}" for i in range(k)]
    one = ["cuda:0"] * k

    data = FederatedDataset.synthetic_mnist(n_train=8 * 64, n_test=8 * 8, seed=5)
    mlps = []
    for devices in (cards, one):
        fed = SpmdFederation.from_dataset(mlp(seed=0), data, n_nodes=8, batch_size=32, vote=False, seed=3,
                                          keep_opt_state=True, mesh=federation_mesh(k, devices=devices))
        losses = [float(fed.run_round()["train_loss"])] + [float(e["train_loss"]) for e in fed.run_fused(2)]
        mlps.append((fed, losses))
    assert mlps[0][1] == mlps[1][1]
    assert all(_equal(mlps[0][0].node_params(i), mlps[1][0].node_params(i)) for i in range(8))
    assert mlps[0][0].node_params(7)["Dense_0"]["kernel"].device == torch.device(cards[-1])

    cfg = TransformerConfig(vocab_size=256, dim=64, n_layers=4, n_heads=4, n_kv_heads=4, ffn_hidden=128, lora_rank=0)
    lm = FederatedDataset.synthetic_lm(vocab_size=256, seq_len=32, n_train=2 * 64, n_test=32)
    shards = [lm.partition(i, 2) for i in range(2)]
    pipes = []
    for devices in (cards, one):
        fed = PipelineFederation(tiny_transformer(seq_len=32, cfg=cfg), shards,
                                 mesh=pipeline_mesh(k, devices=devices), batch_size=8, n_micro=4, seed=3)
        pipes.append((fed, fed.run_round()["train_loss"]))
    assert pipes[0][1] == pipes[1][1] and _equal(pipes[0][0].params, pipes[1][0].params)

    moe = TransformerConfig(vocab_size=512, dim=128, n_layers=2, n_heads=8, n_kv_heads=8, ffn_hidden=256,
                            lora_rank=0, n_experts=8, moe_top_k=2)
    moe_data = FederatedDataset.synthetic_lm(vocab_size=512, n_train=4 * 32, n_test=64)
    eps = []
    for devices in (cards, one):
        fed = SpmdLmFederation.from_dataset(
            tiny_transformer(seq_len=128, cfg=moe), moe_data, n_nodes=4, batch_size=16, vote=False, seed=3,
            mesh=federation_mesh(k // 2, model_parallel=2, devices=devices), expert_parallel=2)
        eps.append((fed, float(fed.run_round()["train_loss"])))
    assert eps[0][1] == eps[1][1] and all(_equal(eps[0][0].node_params(i), eps[1][0].node_params(i)) for i in range(4))

    lcfg = TransformerConfig(vocab_size=256, dim=128, n_layers=2, n_heads=4, n_kv_heads=2, ffn_hidden=256,
                             lora_rank=4, lora_mlp=True)
    ldata = FederatedDataset.synthetic_lm(vocab_size=256, seq_len=64, n_train=4 * 8, n_test=16)
    loras = []
    for devices in (cards, one):
        fed = SpmdLoraFederation.from_dataset(
            tiny_transformer(seq_len=64, cfg=lcfg), ldata, n_nodes=4, batch_size=4, vote=False, seed=3,
            mesh=federation_mesh(k // 2, model_parallel=2, devices=devices), model_parallel_base=True)
        loras.append((fed, float(fed.run_round()["train_loss"])))
    assert loras[0][1] == loras[1][1]
    assert all(_equal(loras[0][0].node_params(i), loras[1][0].node_params(i)) for i in range(4))


def test_default_federation_on_two_cards_or_more_runs_dp_sgd_and_fused_spans(cuda):
    """``device=None`` spans every visible card (JAX's default mesh: as
    many rows as divide N): a plain federation's round and fused span
    (eager across cards) equal the same rows on one card (a captured span)
    bit for bit; DP-SGD runs on it, each node's noise from a generator on
    its row's card, clipping alone and the noised rounds equal to the
    one-card rows' bits, the noised rounds repeatable from the seed. (Rows
    of 2 nodes against one row of 8 differed in the last bits on the H100:
    cuBLAS picks its batched GEMM by the batch count.)"""
    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        pytest.skip("needs two cards or more")
    data = FederatedDataset.synthetic_mnist(n_train=8 * 64, n_test=8 * 8, seed=5)
    kw = dict(n_nodes=8, batch_size=32, vote=False, seed=3, keep_opt_state=True)

    def run(**extra):
        fed = SpmdFederation.from_dataset(mlp(seed=0), data, **kw, **extra)
        losses = [float(fed.run_round()["train_loss"])] + [float(e["train_loss"]) for e in fed.run_fused(2)]
        return fed, losses

    rows = max(r for r in range(1, n_cards + 1) if 8 % r == 0)
    one = dict(mesh=federation_mesh(rows, devices=["cuda:0"] * rows))
    for extra in ({}, dict(dp_clip=1.0), dict(dp_clip=1.0, dp_noise=1.1)):
        (fed, losses), (ref, ref_losses) = run(**extra), run(**one, **extra)
        assert fed.mesh.devices.size == rows and len(set(fed.mesh.devices.flat)) == rows
        assert losses == ref_losses
        assert all(_equal(fed.node_params(i), ref.node_params(i)) for i in range(8))
        if not extra:
            assert ref._spans and not fed._spans  # one card captured, several eager
    (a, la), (b, lb) = run(dp_clip=1.0, dp_noise=1.1), run(dp_clip=1.0, dp_noise=1.1)
    assert la == lb and all(math.isfinite(x) for x in la)
    assert all(_equal(a.node_params(i), b.node_params(i)) for i in range(8))
