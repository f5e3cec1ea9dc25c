"""The port's mixture-of-experts FFN and full-parameter LM federation
against the JAX package on the CPU: ``moe_route`` against the routing
inside flax's ``MoEMLP`` bit for bit; the layer's output and router losses
from the same (converted) params, with tokens dropped at a tight capacity
and one expert equal to plain SwiGLU; ``apply_with_aux``; the MoE causal
LM's logits, loss and gradients; ``attn="auto"``; one ``SpmdLmFederation``
round and one fused round against JAX's; the refusals; and the example.

Inputs are drawn with numpy from fixed seeds and handed to both sides.
Tolerances are stated where used: fp32 on both sides, the two frameworks
sum the products in other orders.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2pfl_tpu.learning.dataset import FederatedDataset as JaxDataset
from p2pfl_tpu.models import transformer as jtr
from p2pfl_tpu.models.base import apply_with_aux as jax_apply_with_aux
from p2pfl_tpu.parallel import SpmdLmFederation as JaxLmFederation
from p2pfl_tpu_torch.convert import params_from_jax, params_to_jax
from p2pfl_tpu_torch.learning.dataset import FederatedDataset
from p2pfl_tpu_torch.learning.learner import sgd
from p2pfl_tpu_torch.models import transformer as ttr
from p2pfl_tpu_torch.models.base import TorchModel, apply_with_aux
from p2pfl_tpu_torch.ops.tree import tree_items, tree_map
from p2pfl_tpu_torch.parallel.spmd_lm import PipelineFederation, SpmdLmFederation

torch.set_num_threads(2)

MOE = dict(vocab_size=64, dim=32, n_layers=2, n_heads=2, n_kv_heads=2, ffn_hidden=64, n_experts=4,
           moe_top_k=2, lora_rank=0)
# fp32 on both sides; products summed in other orders: the layer's
# outputs and the model's logits agree to a few fp32 ulps of their size
LAYER_TOL = 2e-5
AUX_TOL = 1e-6


def _cfgs(**kw):
    both = {**MOE, **kw}
    return jtr.TransformerConfig(**both, dtype=jnp.float32), ttr.TransformerConfig(**both, dtype=torch.float32)


def _layer_params(jcfg, seed: int, b: int = 2, t: int = 16):
    x = np.random.default_rng(seed).standard_normal((b, t, jcfg.dim)).astype(np.float32)
    params = jtr.MoEMLP(jcfg).init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"]
    return jax.tree.map(np.asarray, params), x


def _jax_layer(jcfg, params, x, monkeypatch):
    """flax's MoEMLP, eagerly, with the router probabilities (softmax's
    output) and the combine tensor (the last einsum's operand) recorded:
    → (out, aux, probs, combine, dispatch)."""
    seen: dict = {}
    softmax, einsum = jax.nn.softmax, jnp.einsum

    def rec_softmax(*a, **k):
        out = softmax(*a, **k)
        seen.setdefault("probs", np.asarray(out))
        return out

    def rec_einsum(spec, *ops, **k):
        if spec == "sec,ecd->sd":
            seen["combine"] = np.asarray(ops[0])
        if spec == "sec,sd->ecd":
            seen["dispatch"] = np.asarray(ops[0])
        return einsum(spec, *ops, **k)

    monkeypatch.setattr(jax.nn, "softmax", rec_softmax)
    monkeypatch.setattr(jnp, "einsum", rec_einsum)
    out, mut = jtr.MoEMLP(jcfg).apply({"params": params}, jnp.asarray(x), mutable=["moe_losses"])
    monkeypatch.undo()
    aux = float(sum(jax.tree.leaves(mut)))
    return np.asarray(out), aux, seen["probs"], seen["combine"], seen["dispatch"]


# the routing cases: the configs' top-2 of 4 experts, a tight capacity
# that drops tokens, top-1 of 8 and top-3 (each pass's running fill count)
ROUTES = {"top2": {}, "tight": {"moe_capacity": 0.25}, "top1_e8": {"moe_top_k": 1, "n_experts": 8},
          "top3": {"moe_top_k": 3, "moe_capacity": 0.5}}


@pytest.mark.parametrize("case", list(ROUTES))
def test_moe_route_matches_jax_bit_for_bit(case, monkeypatch):
    """Given flax's router probabilities, ``moe_route`` gives flax's combine
    and dispatch tensors bit for bit (argmax takes the first of ties on
    both sides; every step is exact in fp32 but the renormalising sum,
    which adds at most k nonzero terms). The routing is held apart from
    the logits: XLA's and torch's fp32 dot may differ in the last ulp and
    flip a near-tie."""
    jcfg, tcfg = _cfgs(**ROUTES[case])
    params, x = _layer_params(jcfg, seed=11)
    _, _, probs, combine, dispatch = _jax_layer(jcfg, params, x, monkeypatch)
    s, e = probs.shape
    k = tcfg.moe_top_k
    capacity = max(1, int(-(-k * s // e) * tcfg.moe_capacity))
    got, top1 = ttr.moe_route(torch.from_numpy(probs.copy()), k, capacity)
    assert got.shape == combine.shape == (s, e, capacity)
    assert np.array_equal(got.numpy(), combine)
    assert np.array_equal((got > 0).numpy(), dispatch.astype(bool))
    assert np.array_equal(top1.argmax(-1).numpy(), probs.argmax(-1))
    if case == "tight":  # tokens past an expert's capacity are dropped
        assert (combine.sum((1, 2)) == 0).any()


@pytest.mark.parametrize("case", ["top2", "tight", "one_expert"])
def test_moe_layer_matches_flax(case, monkeypatch):
    """The layer's output and router losses against flax's on the same
    params and inputs (fp32: LAYER_TOL, AUX_TOL); "one_expert" (E = 1,
    k = 1, ample capacity) also equals the plain SwiGLU of the expert's
    weights."""
    kw = {"one_expert": {"n_experts": 1, "moe_top_k": 1, "moe_capacity": 2.0}}.get(case, ROUTES.get(case, {}))
    jcfg, tcfg = _cfgs(**kw)
    params, x = _layer_params(jcfg, seed=12)
    jout, jaux, _, _, _ = _jax_layer(jcfg, params, x, monkeypatch)
    p = params_from_jax(params, device="cpu")
    out, aux = ttr.MoEMLP(tcfg)(p, torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), jout, atol=LAYER_TOL, rtol=0)
    assert abs(float(aux) - jaux) <= AUX_TOL
    if case == "one_expert":
        w1, w3, w2 = (p[n][0] for n in ("w1", "w3", "w2"))
        xt = torch.from_numpy(x)
        plain = (torch.nn.functional.silu(xt @ w1) * (xt @ w3)) @ w2
        torch.testing.assert_close(out, plain, atol=LAYER_TOL, rtol=0)


def test_apply_with_aux_is_zero_for_a_dense_model():
    """A dense LM's aux is an fp32 0 (as JAX's empty collection gives),
    also under vmap over a node axis; a non-LM module's too."""
    from p2pfl_tpu_torch.models.vision import mlp

    cfg = ttr.TransformerConfig(**{**MOE, "n_experts": 0})
    model = ttr.tiny_transformer(seq_len=16, cfg=cfg, device="cpu")
    x = torch.from_numpy(np.random.default_rng(0).integers(0, 64, (3, 2, 16)))
    logits, aux = apply_with_aux(model.module, model.params, x[0])
    assert aux.dtype == torch.float32 and float(aux) == 0.0
    torch.testing.assert_close(logits, model.module(model.params, x[0]), atol=0, rtol=0)
    stacked = tree_map(lambda a: a[None].expand(3, *a.shape).clone(), model.params)
    _, auxes = torch.func.vmap(lambda p, xx: apply_with_aux(model.module, p, xx))(stacked, x)
    assert auxes.tolist() == [0.0, 0.0, 0.0]
    m = mlp(device="cpu")
    assert float(apply_with_aux(m.module, m.params, torch.zeros((2, 28, 28, 1)))[1]) == 0.0


def test_moe_model_matches_flax_and_batches_under_vmap():
    """The 2-layer MoE LM from flax's params: logits, aux and the
    gradients of CE + aux against flax's (fp32; logits LAYER_TOL,
    gradients 1e-4 of the largest); under vmap over 2 nodes each node
    routes its own tokens, as its own call does."""
    import optax

    jcfg, tcfg = _cfgs()
    jmodel = jtr.tiny_transformer(seq_len=16, seed=5, cfg=jcfg)
    rng = np.random.default_rng(6)
    x = rng.integers(0, 64, (2, 16)).astype(np.int32)
    y = rng.integers(0, 64, (2, 16)).astype(np.int32)

    def jloss(p):
        logits, aux = jax_apply_with_aux(jmodel.module, p, x)
        return optax.softmax_cross_entropy_with_integer_labels(logits, y).mean() + aux, (logits, aux)

    (_, (jlogits, jaux)), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jmodel.params)
    p = params_from_jax(jax.tree.map(np.asarray, jmodel.params), device="cpu")
    leaves = {k: v.requires_grad_(True) for k, v in tree_items(p)}
    from p2pfl_tpu_torch.learning.learner import _loss
    from p2pfl_tpu_torch.ops.tree import tree_unflatten

    module = ttr.CausalLM(tcfg)
    loss, logits = _loss(tree_unflatten(leaves), module, torch.from_numpy(x), torch.from_numpy(y))
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), atol=LAYER_TOL, rtol=0)
    with torch.no_grad():
        _, aux = apply_with_aux(module, p, torch.from_numpy(x))
    assert abs(float(aux) - float(jaux)) <= AUX_TOL
    want = dict(tree_items(jax.tree.map(np.asarray, jgrads)))
    scale = max(np.abs(g).max() for g in want.values())
    assert want.keys() == leaves.keys()
    for path, leaf in leaves.items():
        np.testing.assert_allclose(leaf.grad.numpy(), want[path], atol=1e-4 * scale, err_msg=path)
    stacked = tree_map(lambda a: a.detach()[None].expand(2, *a.shape).clone(), p)
    xs = torch.from_numpy(np.stack([x, x[::-1].copy()]))
    vl, va = torch.func.vmap(lambda q, xx: apply_with_aux(module, q, xx))(stacked, xs)
    for n in range(2):
        ol, oa = apply_with_aux(module, p, xs[n])
        torch.testing.assert_close(vl[n], ol.detach(), atol=1e-6, rtol=0)
        torch.testing.assert_close(va[n], oa.detach(), atol=1e-7, rtol=0)


def test_moe_params_convert_and_init_like_flax():
    """``mlp/router`` and the ``[E, ...]`` expert stacks cross the
    converter unchanged both ways, and the port's init draws the same
    tree (paths, shapes) as flax's."""
    jcfg, tcfg = _cfgs()
    jp = jax.tree.map(np.asarray, jtr.tiny_transformer(seq_len=16, seed=1, cfg=jcfg).params)
    back = params_to_jax(params_from_jax(jp, device="cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(jp)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        assert np.array_equal(a, b)
    mine = dict(tree_items(ttr.init_params(tcfg, seed=1, device="cpu")))
    theirs = dict(tree_items(jp))
    assert {k: tuple(v.shape) for k, v in mine.items()} == {k: v.shape for k, v in theirs.items()}
    assert mine["layer_0/mlp/w1"].shape == (4, 32, 64) and mine["layer_0/mlp/router"].shape == (32, 4)


@pytest.mark.parametrize("policy", [None, "mlp", "mlp_qkv"], ids=["full", "mlp", "mlp_qkv"])
def test_moe_remat_is_bit_equal_to_no_remat(policy):
    """Under every remat policy the MoE model's loss (CE + aux) and its
    gradients equal those without remat bit for bit (the FFN's experts run
    outside the segments of "mlp" and "mlp_qkv")."""
    from p2pfl_tpu_torch.learning.learner import _loss
    from p2pfl_tpu_torch.ops.tree import tree_unflatten

    _, tcfg = _cfgs()
    params = ttr.init_params(tcfg, seed=2, device="cpu")
    rng = np.random.default_rng(3)
    x, y = (torch.from_numpy(rng.integers(0, 64, (2, 16))) for _ in range(2))
    outs = []
    for cfg in (tcfg, dataclasses.replace(tcfg, remat=True, remat_policy=policy)):
        leaves = {k: v.clone().requires_grad_(True) for k, v in tree_items(params)}
        loss, _ = _loss(tree_unflatten(leaves), ttr.CausalLM(cfg), x, y)
        loss.backward()
        outs.append((loss.detach(), {k: v.grad for k, v in leaves.items()}))
    assert torch.equal(outs[0][0], outs[1][0])
    for k in outs[0][1]:
        assert torch.equal(outs[0][1][k], outs[1][1][k]), k


def test_pick_attention_and_auto_on_the_cpu():
    """``attn="auto"`` on the CPU is dense at every length (JAX answers
    dense off its accelerator); on a CUDA device it would be flash from
    ``Settings.FLASH_MIN_SEQ_LEN`` on (512: the card's config-7 crossover,
    where JAX keeps its TPU's 1024). ``resolve_attention("auto")`` needs
    the length."""
    from p2pfl_tpu.settings import Settings as JaxSettings
    from p2pfl_tpu_torch.settings import Settings

    assert Settings.FLASH_MIN_SEQ_LEN == 512 and JaxSettings.FLASH_MIN_SEQ_LEN == 1024
    for t in (16, 1024, 8192):
        assert ttr.pick_attention(t, "cpu") == "dense"
        assert ttr.resolve_attention("auto", seq_len=t, device="cpu") is None
    with pytest.raises(ValueError, match="seq_len"):
        ttr.resolve_attention("auto", device="cpu")
    cfg = ttr.TransformerConfig(**{**MOE, "n_experts": 0}, dtype=torch.float32)
    auto = ttr.tiny_transformer(seq_len=16, seed=4, cfg=cfg, attn="auto", device="cpu")
    dense = ttr.tiny_transformer(seq_len=16, seed=4, cfg=cfg, device="cpu")
    x = torch.from_numpy(np.random.default_rng(1).integers(0, 64, (2, 16)))
    assert torch.equal(auto.module(auto.params, x), dense.module(dense.params, x))


# ---- the LM federation ----

FED = dict(vocab_size=64, dim=64, n_layers=2, n_heads=2, n_kv_heads=2, ffn_hidden=64, n_experts=4,
           moe_top_k=2, lora_rank=0)
FED_DATA = dict(vocab_size=64, seq_len=32, n_train=2 * 16, n_test=2 * 8)
FED_KW = dict(n_nodes=2, batch_size=8, vote=False, seed=3, learning_rate=0.05)


def _fed_pair():
    """A JAX and a port SpmdLmFederation from one flax init (fp32 compute),
    one dataset and seed, under SGD."""
    jcfg = jtr.TransformerConfig(**FED, dtype=jnp.float32)
    tcfg = ttr.TransformerConfig(**FED, dtype=torch.float32)
    jmodel = jtr.tiny_transformer(seq_len=32, seed=7, cfg=jcfg)
    tmodel = TorchModel(ttr.CausalLM(tcfg), params_from_jax(jax.tree.map(np.asarray, jmodel.params), device="cpu"),
                        (32,), 64)
    base = {**FED_KW, "optimizer": "sgd"}
    jfed = JaxLmFederation.from_dataset(jmodel, JaxDataset.synthetic_lm(**FED_DATA), **base)
    tfed = SpmdLmFederation.from_dataset(tmodel, FederatedDataset.synthetic_lm(**FED_DATA), device="cpu", **base)
    return jfed, tfed


def _rel_l2(want, got) -> float:
    """Relative L2 distance of two trees of numpy arrays (same structure)."""
    a, b = (np.concatenate([np.asarray(x, np.float64).ravel() for x in jax.tree.leaves(t)]) for t in (want, got))
    return float(np.linalg.norm(a - b) / np.linalg.norm(a))


@pytest.mark.parametrize("fused", [False, True], ids=["round", "fused_round"])
def test_lm_federation_round_matches_jax(fused):
    """One ``run_round`` (or ``run_fused(1)``) of 2 nodes at 2L/64d with 4
    experts under SGD, from one flax init: the params after the round
    within 1e-5 relative L2 of JAX's (fp32; the routing is identical, the
    products sum in other orders), the train loss within 1e-5, and the
    evaluation's loss and accuracy likewise."""
    jfed, tfed = _fed_pair()
    if fused:
        jl = float(jfed.run_fused(1)[0]["train_loss"])
        tl = float(tfed.run_fused(1)[0]["train_loss"])
    else:
        jl = float(jfed.run_round()["train_loss"])
        tl = float(tfed.run_round()["train_loss"])
    assert abs(jl - tl) <= 1e-5 * abs(jl)
    jparams = jax.tree.map(lambda a: np.asarray(a)[0], jfed.params)
    tparams = params_to_jax(tree_map(lambda t: t[0], tfed.params))
    assert _rel_l2(jparams, tparams) <= 1e-5
    je, te = jfed.evaluate(), tfed.evaluate()
    assert abs(je["test_loss"] - te["test_loss"]) <= 1e-5 * je["test_loss"]
    assert abs(je["test_acc"] - te["test_acc"]) <= 1e-6
    assert len(te["per_node_acc"]) == 2


def test_lm_federation_refusals():
    """SCAFFOLD, FedOpt, DP-SGD and FedProx are refused as in JAX; a mesh
    and expert parallelism are not ported (ROADMAP item 5), nor is the
    GPipe federation."""
    cfg = ttr.TransformerConfig(**FED, dtype=torch.float32)
    model = ttr.tiny_transformer(seq_len=32, cfg=cfg, device="cpu")
    data = FederatedDataset.synthetic_lm(**FED_DATA)
    for kw in ({"scaffold": True}, {"server_opt": "adam"}, {"dp_clip": 1.0}, {"dp_noise": 1.0}, {"prox_mu": 0.1}):
        with pytest.raises(ValueError, match="does not support"):
            SpmdLmFederation.from_dataset(model, data, n_nodes=2, batch_size=8, device="cpu", **kw)
    for kw in ({"expert_parallel": 2}, {"mesh": object()}):
        with pytest.raises(NotImplementedError, match="item 5"):
            SpmdLmFederation.from_dataset(model, data, n_nodes=2, batch_size=8, device="cpu", **kw)
    with pytest.raises(NotImplementedError, match="item 5"):
        PipelineFederation(model, [data])
    tfed = SpmdLmFederation.from_dataset(model, data, n_nodes=2, batch_size=8, device="cpu", tx=sgd(0.1))
    assert tfed.round_flops() > 0


def test_moe_example_runs_on_the_cpu_and_gpipe_raises(capsys):
    """``examples/moe_gpipe_federation.py --mode moe`` trains a small MoE
    federation on the CPU; ``--mode gpipe`` names the ROADMAP item."""
    from p2pfl_tpu_torch.examples import moe_gpipe_federation as ex

    ex.main(["--mode", "moe", "--device", "cpu", "--nodes", "2", "--rounds", "1", "--layers", "1",
             "--dim", "32", "--seq-len", "32", "--samples", "32"])
    out = capsys.readouterr().out
    assert "round 1" in out and "done in" in out
    with pytest.raises(NotImplementedError, match="item 5"):
        ex.main(["--mode", "gpipe", "--device", "cpu"])


def test_entry_points_default_to_the_card():
    """Without a card, the federation, the MoE model and the example raise
    instead of running on the CPU (``device=None`` is the card)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None resolves to it")
    from p2pfl_tpu_torch import DeviceUnavailableError
    from p2pfl_tpu_torch.examples import moe_gpipe_federation as ex

    cfg = ttr.TransformerConfig(**FED, dtype=torch.float32)
    with pytest.raises(DeviceUnavailableError):
        ttr.tiny_transformer(seq_len=32, cfg=cfg)
    with pytest.raises(DeviceUnavailableError):
        ttr.pick_attention(4096)
    model = ttr.tiny_transformer(seq_len=32, cfg=cfg, device="cpu")
    with pytest.raises(DeviceUnavailableError):
        SpmdLmFederation.from_dataset(model, FederatedDataset.synthetic_lm(**FED_DATA), n_nodes=2, batch_size=8)
    with pytest.raises(DeviceUnavailableError):
        ex.main(["--mode", "moe", "--layers", "1", "--dim", "32", "--seq-len", "32", "--samples", "32"])
