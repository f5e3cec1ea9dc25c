"""The port's causal LM against the flax model: logits and adapter
gradients from the same (converted) parameters, both JAX parameter
layouts, and the converter's round trip."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from p2pfl_tpu.models import transformer as jtr
from p2pfl_tpu.ops.flash_attention import FlashConfig as JaxFlashConfig
from p2pfl_tpu_torch.convert import is_scanned, params_from_jax, params_to_jax
from p2pfl_tpu_torch.learning.lora import _lm_loss, split_lora
from p2pfl_tpu_torch.models import transformer as ttr
from p2pfl_tpu_torch.ops.flash_attention import FlashConfig
from p2pfl_tpu_torch.ops.tree import tree_items, tree_map

torch.set_num_threads(2)

SEQ = 32
SMALL = dict(vocab_size=128, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, ffn_hidden=96, lora_mlp=True)
DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
# fp32: same math, other summation order. bf16: the two frameworks round
# every bf16 product and elementwise op at the same points, but their
# fp32 sums inside a product differ in order, which moves a bf16 result
# by an ulp now and then; through 2 layers that stays within 3e-2 on
# logits of magnitude ~1.
LOGIT_TOL = {"fp32": 3e-5, "bf16": 3e-2}


def _configs(dtype: str, flash: bool, scan: bool):
    jdt, tdt = DTYPES[dtype]
    jcfg = jtr.TransformerConfig(
        **SMALL, dtype=jdt, scan_layers=scan,
        flash_config=JaxFlashConfig(16, 16) if flash else None,
    )
    tcfg = ttr.TransformerConfig(
        **SMALL, dtype=tdt, scan_layers=scan, flash_config=FlashConfig(16, 16) if flash else None
    )
    return jcfg, tcfg


def _jax_params(jcfg, seed=0):
    """flax init, with lora_b moved off zero so every adapter path is live."""
    model = jtr.tiny_transformer(seq_len=SEQ, seed=seed, cfg=jcfg)
    rng = np.random.default_rng(seed + 100)
    return model, jax.tree_util.tree_map_with_path(
        lambda path, x: np.asarray(x) + (
            0.02 * rng.standard_normal(x.shape).astype(np.float32)
            if "lora_b" in jax.tree_util.keystr(path) else 0.0
        ),
        model.params,
    )


def _tokens(seed=1, b=2):
    rng = np.random.default_rng(seed)
    return rng.integers(0, SMALL["vocab_size"], (b, SEQ)).astype(np.int32), rng.integers(
        0, SMALL["vocab_size"], (b, SEQ)
    ).astype(np.int32)


@pytest.mark.parametrize("scan", [False, True], ids=["unrolled", "scanned"])
@pytest.mark.parametrize("flash", [False, True], ids=["dense", "flash"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_logits_match_flax(dtype, flash, scan):
    jcfg, tcfg = _configs(dtype, flash, scan)
    jmodel, p = _jax_params(jcfg)
    x, _ = _tokens()
    want = np.asarray(jmodel.module.apply({"params": jax.tree.map(jnp.asarray, p)}, x))
    assert is_scanned(p) == scan
    got = ttr.CausalLM(tcfg)(params_from_jax(p, device="cpu"), torch.tensor(x))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=LOGIT_TOL[dtype])


# adapter gradients of the mean CE: fp32 to 1e-5 of the largest gradient;
# bf16 to 5e-2 of it (bf16 activations on both sides, rounded at the same
# points, summed in other orders)
GRAD_TOL = {"fp32": 1e-5, "bf16": 5e-2}


@pytest.mark.parametrize("attn", ["dense", "flash"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_adapter_gradients_match_flax(dtype, attn):
    """d(mean CE)/d(adapters) against jax.grad through the flax model with
    dense attention (the Pallas backward's own reference)."""
    jcfg, tcfg = _configs(dtype, attn == "flash", False)
    jcfg = dataclasses.replace(jcfg, flash_config=None)
    jmodel, p = _jax_params(jcfg, seed=2)
    x, y = _tokens(seed=3)
    jlora, jbase = jax.tree.map(jnp.asarray, split_lora(p))

    def jloss(lo):
        from p2pfl_tpu.learning.lora import merge_params

        logits = jmodel.module.apply({"params": merge_params(jbase, lo)}, x)
        return optax.softmax_cross_entropy_with_integer_labels(logits, y).mean()

    want = dict(tree_items(jax.tree.map(np.asarray, jax.grad(jloss)(jlora))))
    tparams = params_from_jax(p, device="cpu")
    lora, base = split_lora(tparams)
    lora = tree_map(lambda t: t.requires_grad_(True), lora)
    loss, _ = _lm_loss(lora, base, ttr.CausalLM(tcfg), torch.tensor(x), torch.tensor(y))
    loss.backward()
    got = {path: leaf.grad.numpy() for path, leaf in tree_items(lora)}
    assert got.keys() == want.keys()
    scale = max(np.abs(g).max() for g in want.values())
    for path in want:
        np.testing.assert_allclose(got[path], want[path], atol=GRAD_TOL[dtype] * scale, err_msg=path)


@pytest.mark.parametrize("scan", [False, True], ids=["unrolled", "scanned"])
def test_convert_round_trip_is_exact(scan):
    """params_to_jax(params_from_jax(p)) == p, leaf for leaf, same tree."""
    jcfg, _ = _configs("bf16", False, scan)
    _, p = _jax_params(jcfg)
    back = params_to_jax(params_from_jax(p, device="cpu"), scan_layers=scan)
    assert jax.tree.structure(back) == jax.tree.structure(p)
    for a, b in zip(jax.tree.leaves(p), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_init_tree_matches_flax_layout():
    """tiny_transformer's fresh tree has the flax unrolled tree's paths and
    shapes, adapters start as identity (lora_b = 0), norm scales at 1."""
    jcfg, tcfg = _configs("bf16", False, False)
    jmodel = jtr.tiny_transformer(seq_len=SEQ, cfg=jcfg)
    tmodel = ttr.tiny_transformer(seq_len=SEQ, seed=0, cfg=tcfg, device="cpu")
    want = {k: v.shape for k, v in tree_items(jax.tree.map(np.asarray, jmodel.params))}
    got = {k: tuple(v.shape) for k, v in tree_items(tmodel.params)}
    assert got == want
    assert tmodel.param_count == sum(int(np.prod(s)) for s in want.values())
    for path, leaf in tree_items(tmodel.params):
        if path.endswith("lora_b"):
            assert torch.count_nonzero(leaf) == 0
        if path.endswith("scale"):
            assert torch.all(leaf == 1)
    # flax lecun_normal: truncated at 2 std, variance 1/fan_in
    k = tmodel.params["layer_0"]["mlp"]["w2"]["kernel"]
    assert abs(k.std().item() - (1 / SMALL["ffn_hidden"]) ** 0.5) < 0.1 * (1 / SMALL["ffn_hidden"]) ** 0.5
    bound = 2 * (1 / SMALL["ffn_hidden"]) ** 0.5 / 0.87962566103423978
    assert k.abs().max().item() <= bound * (1 + 1e-5)


def test_init_is_seeded():
    _, tcfg = _configs("bf16", False, False)
    a = ttr.init_params(tcfg, seed=5, device="cpu")
    b = ttr.init_params(tcfg, seed=5, device="cpu")
    c = ttr.init_params(tcfg, seed=6, device="cpu")
    assert all(torch.equal(x, y) for (_, x), (_, y) in zip(tree_items(a), tree_items(b)))
    assert not torch.equal(a["embed"], c["embed"])


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_building_blocks_match_flax(dtype):
    """rope, RMSNorm and LoRADense one by one (fp32 2e-6; bf16 one ulp)."""
    jdt, tdt = DTYPES[dtype]
    tol = 2e-6 if dtype == "fp32" else 2.0 ** -7
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, SEQ, 4, 16)).astype(np.float32)
    want = jtr.rope(jnp.asarray(x, jdt), 10000.0).astype(jnp.float32)
    got = ttr.rope(torch.tensor(x, dtype=tdt), 10000.0).float()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol * 4)

    h = rng.standard_normal((2, SEQ, 64)).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    want = jtr.RMSNorm(jdt).apply({"params": {"scale": scale}}, jnp.asarray(h, jdt))
    got = ttr.RMSNorm(tdt)({"scale": torch.tensor(scale)}, torch.tensor(h, dtype=tdt))
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want.astype(jnp.float32)), atol=tol * 4, rtol=tol
    )

    dense = {
        "kernel": rng.standard_normal((64, 32)).astype(np.float32) * 0.1,
        "lora_a": rng.standard_normal((64, 4)).astype(np.float32) * 0.1,
        "lora_b": rng.standard_normal((4, 32)).astype(np.float32) * 0.1,
    }
    want = jtr.LoRADense(32, rank=4, dtype=jdt).apply({"params": dense}, jnp.asarray(h, jdt))
    got = ttr.LoRADense(32, rank=4, dtype=tdt)(
        {k: torch.tensor(v) for k, v in dense.items()}, torch.tensor(h, dtype=tdt)
    )
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want.astype(jnp.float32)), atol=tol * 4, rtol=tol
    )


def test_node_stacked_adapters_equal_per_node_calls():
    """A leading node axis on x and the adapters is N independent models."""
    _, tcfg = _configs("fp32", False, False)
    params = ttr.init_params(tcfg, seed=3, device="cpu")
    lora, base = split_lora(params)
    gen = torch.Generator().manual_seed(0)
    stacked = tree_map(lambda t: t[None] + 0.05 * torch.randn((3, *t.shape), generator=gen), lora)
    x = torch.randint(0, SMALL["vocab_size"], (3, 2, SEQ), generator=gen)
    model = ttr.CausalLM(tcfg)
    from p2pfl_tpu_torch.learning.lora import merge_params

    together = model(merge_params(base, stacked), x)
    for n in range(3):
        alone = model(merge_params(base, tree_map(lambda t: t[n], stacked)), x[n])
        torch.testing.assert_close(together[n], alone, atol=2e-5, rtol=0)


@pytest.mark.parametrize("kwargs,match", [({"n_experts": 4}, "MoE")])
def test_unported_options_raise(kwargs, match):
    """The MoE FFN is ported: the model builds with it, and, as in JAX,
    refuses it only with scanned layers (the JAX layout of which cannot
    hold MoE params: flax's scan does not thread the sown losses)."""
    ttr.CausalLM(ttr.TransformerConfig(**SMALL, **kwargs))
    for mod in (jtr, ttr):
        cfg = mod.TransformerConfig(**SMALL, **kwargs, scan_layers=True)
        with pytest.raises(NotImplementedError, match=match):
            if mod is jtr:
                mod.tiny_transformer(seq_len=SEQ, cfg=cfg)
            else:
                mod.CausalLM(cfg)


def test_remat_policy_validation_matches_jax():
    """An unknown policy and a policy without remat raise ValueError with
    the JAX config's messages; every known policy builds."""
    for mod in (jtr, ttr):
        with pytest.raises(ValueError, match="unknown remat_policy"):
            mod.TransformerConfig(**SMALL, remat=True, remat_policy="attn")
        with pytest.raises(ValueError, match="only meaningful with remat=True"):
            mod.TransformerConfig(**SMALL, remat_policy="mlp")
    for policy in (None, "mlp", "mlp_qkv"):
        ttr.CausalLM(ttr.TransformerConfig(**SMALL, remat=True, remat_policy=policy))


POLICIES = [None, "mlp", "mlp_qkv"]


def _logits_and_grads(tcfg, p, x, y):
    """fp32 logits and d(mean CE)/d(adapters) of the port's model, with the
    flash forward's and backward's calls counted."""
    from p2pfl_tpu_torch.ops import flash_attention as fa

    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = fa.flash_fwd_bhtd, fa.flash_bwd_bhtd

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    lora, base = split_lora(params_from_jax(p, device="cpu"))
    lora = tree_map(lambda t: t.requires_grad_(True), lora)
    fa.flash_fwd_bhtd, fa.flash_bwd_bhtd = count("fwd", fwd), count("bwd", bwd)
    try:
        loss, logits = _lm_loss(lora, base, ttr.CausalLM(tcfg), torch.tensor(x), torch.tensor(y))
        loss.backward()
    finally:
        fa.flash_fwd_bhtd, fa.flash_bwd_bhtd = fwd, bwd
    return logits.detach(), {path: leaf.grad for path, leaf in tree_items(lora)}, calls


@pytest.mark.parametrize("policy", POLICIES, ids=["full", "mlp", "mlp_qkv"])
@pytest.mark.parametrize("attn", ["dense", "flash"])
def test_remat_is_bit_equal_to_no_remat(attn, policy):
    """Every policy's logits and adapter gradients equal those without
    remat bit for bit (fp32 and bf16 compute, on the CPU). With flash
    attention the backward re-runs the flash forward once a layer under
    every policy (each segment holds the attention), and the backward
    runs once a layer."""
    layers = SMALL["n_layers"]
    for dtype in DTYPES:
        jcfg, tcfg = _configs(dtype, attn == "flash", False)
        _, p = _jax_params(jcfg, seed=4)
        x, y = _tokens(seed=5)
        ref = _logits_and_grads(tcfg, p, x, y)
        got = _logits_and_grads(dataclasses.replace(tcfg, remat=True, remat_policy=policy), p, x, y)
        assert torch.equal(got[0], ref[0])
        assert ref[1].keys() == got[1].keys()
        for path in ref[1]:
            assert torch.equal(got[1][path], ref[1][path]), (dtype, path)
        if attn == "flash":
            assert ref[2] == {"fwd": layers, "bwd": layers}
            assert got[2] == {"fwd": 2 * layers, "bwd": layers}


@pytest.mark.parametrize("policy", POLICIES, ids=["full", "mlp", "mlp_qkv"])
def test_remat_policies_match_flax(policy):
    """Under each policy the port's logits and adapter gradients agree with
    flax's under the same policy (``nn.remat`` with JAX's
    ``save_only_these_names``) from the same params, at 2 layers, fp32,
    with flash attention (the Pallas kernel in interpret mode): logits to
    ``LOGIT_TOL``, gradients to ``GRAD_TOL`` of the largest."""
    jcfg, tcfg = _configs("fp32", True, False)
    jcfg = dataclasses.replace(jcfg, remat=True, remat_policy=policy)
    tcfg = dataclasses.replace(tcfg, remat=True, remat_policy=policy)
    jmodel, p = _jax_params(jcfg, seed=6)
    x, y = _tokens(seed=7)
    jlora, jbase = jax.tree.map(jnp.asarray, split_lora(p))

    def jloss(lo):
        from p2pfl_tpu.learning.lora import merge_params

        logits = jmodel.module.apply({"params": merge_params(jbase, lo)}, x)
        return optax.softmax_cross_entropy_with_integer_labels(logits, y).mean(), logits

    (_, jlogits), jgrads = jax.value_and_grad(jloss, has_aux=True)(jlora)
    want = dict(tree_items(jax.tree.map(np.asarray, jgrads)))
    logits, got, _ = _logits_and_grads(tcfg, p, x, y)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=LOGIT_TOL["fp32"])
    assert got.keys() == want.keys()
    scale = max(np.abs(g).max() for g in want.values())
    for path in want:
        np.testing.assert_allclose(got[path].numpy(), want[path], atol=GRAD_TOL["fp32"] * scale, err_msg=path)


@pytest.mark.parametrize("attn", ["ring", "ring_flash", "auto"])
def test_unported_attention_backends_raise(attn):
    """Every backend is ported; an unknown name raises. "auto" on the CPU
    builds the dense model (bit-equal logits), as JAX's answers dense off
    its accelerator. The rings without a mesh raise, with a CPU ring of 4
    shards their logits equal the dense model's (fp32, 3e-5)."""
    cfg = ttr.TransformerConfig(**SMALL, dtype=torch.float32)
    with pytest.raises(ValueError, match="unknown"):
        ttr.resolve_attention("sparse")
    if attn == "auto":
        auto = ttr.tiny_transformer(seq_len=SEQ, seed=2, cfg=cfg, attn=attn, device="cpu")
        dense = ttr.tiny_transformer(seq_len=SEQ, seed=2, cfg=cfg, device="cpu")
        x, _ = _tokens(seed=4)
        assert torch.equal(auto.module(auto.params, torch.tensor(x)), dense.module(dense.params, torch.tensor(x)))
        assert jtr.pick_attention(8192, backend="cpu") == ttr.pick_attention(8192, "cpu") == "dense"
        return
    from p2pfl_tpu_torch.parallel.mesh import federation_mesh

    with pytest.raises(ValueError, match="needs a mesh"):
        ttr.tiny_transformer(seq_len=SEQ, cfg=cfg, attn=attn, device="cpu")
    mesh = federation_mesh(model_parallel=4, devices=["cpu"] * 4)
    ring = ttr.tiny_transformer(seq_len=SEQ, seed=2, cfg=cfg, attn=attn, mesh=mesh, device="cpu")
    dense = ttr.tiny_transformer(seq_len=SEQ, seed=2, cfg=cfg, device="cpu")
    x, _ = _tokens(seed=4)
    want = dense.module(dense.params, torch.tensor(x))
    got = ring.module(ring.params, torch.tensor(x))
    torch.testing.assert_close(got, want, atol=LOGIT_TOL["fp32"], rtol=0)
