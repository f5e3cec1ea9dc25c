"""The port's ring attention and offset-aware flash blocks (plain PyTorch
versions, CPU) against the JAX package: the Pallas offset kernels in
interpret mode, JAX's ``ring_attention`` on the forced host devices, the
ring model against JAX's ``attn="ring"`` model, and one federation round
with ring flash against JAX's dense-attention round. The CUDA offset
kernels are held against these plain versions on the card
(``tests/test_torch_cuda_kernels.py``, ``chip_smoke.py``).
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax import lax

from p2pfl_tpu.learning.dataset import FederatedDataset as JaxDataset
from p2pfl_tpu.models.base import FlaxModel
from p2pfl_tpu.models import transformer as jtr
from p2pfl_tpu.ops import attention as jatt
from p2pfl_tpu.ops import flash_attention as jfa
from p2pfl_tpu.parallel import SpmdLoraFederation as JaxFederation
from p2pfl_tpu.parallel import federation_mesh as jax_mesh
from p2pfl_tpu_torch import DeviceUnavailableError
from p2pfl_tpu_torch.convert import params_from_jax, params_to_jax
from p2pfl_tpu_torch.learning.dataset import FederatedDataset
from p2pfl_tpu_torch.learning.lora import _lm_loss, merge_params, split_lora
from p2pfl_tpu_torch.models import transformer as ttr
from p2pfl_tpu_torch.models.base import TorchModel
from p2pfl_tpu_torch.ops import attention as tatt
from p2pfl_tpu_torch.ops import flash_attention as tfa
from p2pfl_tpu_torch.ops.attention import NEG_INF
from p2pfl_tpu_torch.ops.tree import tree_items, tree_map
from p2pfl_tpu_torch.parallel.mesh import federation_mesh
from p2pfl_tpu_torch.parallel.spmd_lora import SpmdLoraFederation

torch.set_num_threads(2)

# fp32: both sides sum the same fp32 products in another order
FP32_ATOL = 2e-6
# the ring against JAX's ring: the tolerances of tests/test_ring_flash.py
RING_FWD_ATOL, RING_GRAD_ATOL = 3e-5, 1e-4


def _arrays(*shape, n=3, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def _cpu_mesh(ring: int):
    return federation_mesh(model_parallel=ring, devices=["cpu"] * ring)


# ---- loop bounds: truncating division, as lax.div ----


def test_bounds_divide_like_lax_div():
    """_tdiv truncates toward zero like lax.div, negative numerators
    included, and the offset loop bounds equal the JAX kernels' formulas
    over offsets that make the numerators negative."""
    for a, b in itertools.product(range(-40, 41), (1, 8, 16)):
        assert tfa._tdiv(a, b) == int(lax.div(jnp.int32(a), jnp.int32(b))), (a, b)
    t, bq, bk = 32, 8, 16
    nq, nk = t // bq, t // bk
    for q_off, k_off in itertools.product((0, 5, 12, 40), (0, 7, 20, 48)):
        for qi in range(nq):
            last_row = q_off + (qi + 1) * bq - 1
            n_blocks = int(jnp.clip(lax.div(last_row - k_off, bk) + 1, 0, nk))
            n_full = int(jnp.clip(lax.div(q_off + qi * bq - k_off + 1, bk), 0, n_blocks))
            assert tfa._offs_q_bounds(qi, q_off, k_off, bq, bk, nk) == (n_full, n_blocks)
        for kj in range(nk):
            want = jfa._offs_kv_bounds(kj, q_off, k_off, bq, bk, nq)
            assert tfa._offs_kv_bounds(kj, q_off, k_off, bq, bk, nq) == tuple(int(x) for x in want)
    # a negative numerator in (-block_k, 0) keeps one fully masked k block
    # under truncation where flooring would keep none
    assert tfa._offs_q_bounds(0, 0, 20, 8, 16, 2) == (0, 1)


# ---- the plain offset kernels against the Pallas kernels ----

# (q_off, k_off): diagonal, fully visible, fully masked, and an off-tile
# pair whose mask cuts through tiles, with sentinel rows inside a visited
# block and negative numerators in the loop bounds
CASES = {"diagonal": (0, 0), "visible": (100, 0), "masked": (0, 100), "offtile": (5, 12)}


@pytest.mark.parametrize("bwd_mode", ["fused", "split"])
@pytest.mark.parametrize("case", list(CASES))
def test_plain_offset_kernels_match_pallas_interpret(case, bwd_mode):
    """O, lse, dQ, dK, dV of flash_attention_block with a nonzero lse
    cotangent against JAX's (Pallas interpret mode) at blocks 8 of T 32.
    Tolerance: fp32, 2e-6."""
    q_off, k_off = CASES[case]
    q, k, v, g = _arrays(2, 32, 2, 16, n=4, seed=1)
    (g_lse,) = _arrays(2, 2, 1, 32, n=1, seed=2)
    jcfg = jfa.FlashConfig(8, 8, bwd_mode=bwd_mode)
    (want_o, want_lse), vjp = jax.vjp(
        lambda a, b, c: jfa.flash_attention_block(a, b, c, q_off, k_off, jcfg, True),
        *(jnp.asarray(x) for x in (q, k, v)),
    )
    want_grads = vjp((jnp.asarray(g), jnp.asarray(g_lse)))
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out, lse = tfa.flash_attention_block(tq, tk, tv, q_off, k_off, tfa.FlashConfig(8, 8, bwd_mode=bwd_mode))
    assert lse.shape == (2, 2, 1, 32) and lse.dtype == torch.float32
    torch.autograd.backward((out, lse), (torch.tensor(g), torch.tensor(g_lse)))
    for got, want in zip((out, lse, tq.grad, tk.grad, tv.grad), (want_o, want_lse, *want_grads)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=FP32_ATOL)


@pytest.mark.parametrize("bwd_mode", ["fused", "split"])
def test_fully_masked_block_is_exactly_zero(bwd_mode):
    """Nothing visible: O is exactly 0, lse sits at the sentinel, and every
    gradient is exactly 0 even with a nonzero lse cotangent."""
    q, k, v, g = (torch.tensor(x, requires_grad=True) for x in _arrays(1, 16, 2, 8, n=4, seed=3))
    out, lse = tfa.flash_attention_block(q, k, v, 0, 16, tfa.FlashConfig(8, 8, bwd_mode=bwd_mode))
    assert torch.count_nonzero(out) == 0 and bool((lse == NEG_INF).all())
    torch.autograd.backward((out, lse), (g.detach(), torch.ones_like(lse)))
    for x in (q, k, v):
        assert torch.count_nonzero(x.grad) == 0


def test_p_ds_guards_sentinel_rows():
    """A row at the lse sentinel whose scores are all masked must get P = 0
    and dS = 0; without the guard exp(NEG_INF - NEG_INF) = 1 there."""
    qb, kb, vb, dob = (torch.tensor(x) for x in _arrays(1, 1, 4, 8, n=4, seed=4))
    lse = torch.tensor([[[NEG_INF, NEG_INF, 0.5, 0.7]]])
    delta = torch.zeros(1, 1, 4)
    glse = torch.ones(1, 1, 4)
    # rows 0-1 at global 0-1 see nothing of columns 2-5
    p, ds = tfa._p_ds(qb, kb, vb, dob, lse, delta, 8 ** -0.5, True, 0, 2, glse)
    assert torch.count_nonzero(p[..., :2, :]) == 0 and torch.count_nonzero(ds[..., :2, :]) == 0
    assert torch.count_nonzero(p[..., 2:, :]) > 0
    # in context: the dQ pass of a partly visible hop against Pallas
    q, k, v, g = _arrays(1, 16, 1, 8, n=4, seed=5)
    jcfg = jfa.FlashConfig(8, 8, bwd_mode="split")
    _, vjp = jax.vjp(lambda a: jfa.flash_attention_block(a, jnp.asarray(k), jnp.asarray(v), 0, 4, jcfg, True), jnp.asarray(q))
    (want,) = vjp((jnp.asarray(g), jnp.ones((1, 1, 1, 16), jnp.float32)))
    tq = torch.tensor(q, requires_grad=True)
    out, lse_t = tfa.flash_attention_block(tq, torch.tensor(k), torch.tensor(v), 0, 4, tfa.FlashConfig(8, 8, bwd_mode="split"))
    torch.autograd.backward((out, lse_t), (torch.tensor(g), torch.ones_like(lse_t)))
    np.testing.assert_allclose(tq.grad.numpy(), np.asarray(want), atol=FP32_ATOL)
    assert torch.count_nonzero(tq.grad[:, :4]) == 0  # rows 0-3 see nothing


@pytest.mark.parametrize("bwd_mode", ["fused", "split"])
def test_block_gradcheck_float64_through_both_cotangents(bwd_mode):
    """Finite differences in float64 of O and lse at an off-tile offset pair
    (blocks 4 of T 8), so dS carries the lse cotangent."""
    q, k, v = (torch.tensor(x, dtype=torch.float64, requires_grad=True) for x in _arrays(1, 8, 2, 4, seed=6))
    cfg = tfa.FlashConfig(4, 4, bwd_mode=bwd_mode)
    assert torch.autograd.gradcheck(lambda a, b, c: tfa.flash_attention_block(a, b, c, 6, 3, cfg), (q, k, v))


# ---- the ring ----


def _jax_ring_and_grads(q, k, v, g, ring, impl):
    mesh = jax_mesh(model_parallel=ring)

    @jax.jit
    def run(a, b, c):
        out, vjp = jax.vjp(lambda x, y, z: jatt.ring_attention(x, y, z, mesh, "model", impl=impl, block=8), a, b, c)
        return out, vjp(jnp.asarray(g))

    return run(*(jnp.asarray(x) for x in (q, k, v)))


@pytest.mark.parametrize("impl", ["dense", "flash"])
@pytest.mark.parametrize("ring", [2, 4])
def test_ring_matches_jax_ring(ring, impl):
    """The port's ring (one process, R shards on one CPU device) against
    JAX's shard_map ring on R forced host devices, T 64, block 8: forward
    to 3e-5 and gradients to 1e-4."""
    q, k, v, g = _arrays(2, 64, 2, 16, n=4, seed=7)
    want, want_grads = _jax_ring_and_grads(q, k, v, g, ring, impl)
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = tatt.ring_attention(tq, tk, tv, _cpu_mesh(ring), "model", impl=impl, block=8)
    out.backward(torch.tensor(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), atol=RING_FWD_ATOL)
    for got, w in zip((tq.grad, tk.grad, tv.grad), want_grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=RING_GRAD_ATOL)


def test_ring_flash_equals_flash_and_dense_ring():
    """Within the port: the flash ring, the dense ring and unsharded flash
    attention compute the same function (fp32, 2e-6 forward and grads)."""
    q, k, v, g = (torch.tensor(x) for x in _arrays(1, 32, 2, 8, n=4, seed=8))
    results = []
    for fn in (
        lambda a, b, c: tfa.flash_attention(a, b, c, True, tfa.FlashConfig(8, 8)),
        lambda a, b, c: tatt.ring_attention(a, b, c, _cpu_mesh(4), "model", impl="flash", block=8),
        lambda a, b, c: tatt.ring_attention(a, b, c, _cpu_mesh(4), "model", impl="dense"),
    ):
        xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
        out = fn(*xs)
        out.backward(g)
        results.append([out.detach()] + [x.grad for x in xs])
    for other in results[1:]:
        for a, b in zip(results[0], other):
            torch.testing.assert_close(b, a, atol=FP32_ATOL, rtol=0)


def test_merge_of_a_shard_that_sees_nothing_has_finite_grads():
    """A whole shard sees nothing in its first hops (sentinel lse on both
    sides of the merge): the merge's backward stays finite, and the result
    and gradients equal those of the visible hop alone."""
    q, k, v, g = (torch.tensor(x) for x in _arrays(1, 8, 2, 4, n=4, seed=9))
    cfg = tfa.FlashConfig(4, 4)

    def run(hops):  # as the ring runs them: [B, H, T, D] blocks, [B, H, T] lse
        xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
        out = torch.zeros((1, 2, 8, 4))
        lse = torch.full((1, 2, 8), NEG_INF)
        for q_off, k_off in hops:
            ob, lb = tfa.FlashAttentionBlock.apply(*(x.transpose(1, 2).contiguous() for x in xs), q_off, k_off, cfg)
            out, lse = tatt.merge_lse(out, lse, ob, lb)
        (out.transpose(1, 2) * g).sum().backward()
        return out.detach(), [x.grad for x in xs]

    out, grads = run([(0, 8), (0, 16), (8, 0)])  # two empty hops, then a visible one
    assert all(bool(torch.isfinite(x).all()) for x in [out, *grads])
    want_out, want_grads = run([(8, 0)])
    torch.testing.assert_close(out, want_out, atol=FP32_ATOL, rtol=0)
    for a, b in zip(grads, want_grads):
        torch.testing.assert_close(a, b, atol=FP32_ATOL, rtol=0)


def test_ring_refusals():
    q = torch.zeros((1, 32, 2, 8))
    with pytest.raises(ValueError, match="causal"):
        tatt.ring_attention(q, q, q, _cpu_mesh(2), "model", causal=False, impl="flash")
    with pytest.raises(ValueError, match="divisible"):
        tatt.ring_attention(q[:, :30], q[:, :30], q[:, :30], _cpu_mesh(4), "model")
    with pytest.raises(ValueError, match="impl"):
        tatt.ring_attention(q, q, q, _cpu_mesh(2), "model", impl="sparse")
    # a non-causal dense ring is full attention
    x = torch.tensor(_arrays(1, 16, 2, 8, n=1, seed=10)[0])
    full = tfa.flash_attention(x, x, x, False, tfa.FlashConfig(8, 8))
    torch.testing.assert_close(tatt.ring_attention(x, x, x, _cpu_mesh(2), "model", causal=False), full,
                               atol=FP32_ATOL, rtol=0)


# ---- the mesh ----


def test_mesh_matches_jax_checks():
    mesh = federation_mesh(model_parallel=4, devices=["cpu"] * 8)
    want = jax_mesh(model_parallel=4)
    assert mesh.axis_names == tuple(want.axis_names) == ("nodes", "model")
    assert mesh.shape == dict(want.shape) == {"nodes": 2, "model": 4}
    assert mesh.axis_devices("model") == [torch.device("cpu")] * 4
    assert mesh.axis_devices("nodes") == [torch.device("cpu")] * 2
    with pytest.raises(ValueError, match="does not divide"):
        federation_mesh(model_parallel=3, devices=["cpu"] * 8)
    with pytest.raises(ValueError, match="does not divide"):
        federation_mesh(model_parallel=0, devices=["cpu"] * 8)
    with pytest.raises(ValueError, match="strand"):
        federation_mesh(n_nodes=1, model_parallel=2, devices=["cpu"] * 8)
    assert federation_mesh(n_nodes=6, model_parallel=2, devices=["cpu"] * 8).shape == {"nodes": 4, "model": 2}


def test_mesh_without_devices_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: devices=None resolves to it")
    with pytest.raises(DeviceUnavailableError):
        federation_mesh(model_parallel=2)
    with pytest.raises(DeviceUnavailableError):
        federation_mesh(devices=["cuda:0"])


# ---- the model and one federation round ----

SEQ, VOCAB, RING = 32, 128, 4
SMALL = dict(vocab_size=VOCAB, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, ffn_hidden=96, lora_mlp=True)


def _jax_lm(attn: str = "dense"):
    """JAX's causal LM (fp32) with ``attn`` = "dense" or "ring" (R = 4),
    its params from a jitted flax init (the eager init costs seconds)."""
    cfg = jtr.TransformerConfig(**SMALL, dtype=jnp.float32)
    module = jtr.CausalLM(cfg, jtr.resolve_attention(attn, mesh=jax_mesh(model_parallel=RING)))
    params = jax.jit(module.init)(jax.random.PRNGKey(0), jnp.zeros((1, SEQ), jnp.int32))["params"]
    model = FlaxModel(module, params, (SEQ,), VOCAB)
    model.extra["config"] = cfg
    return model


def _live_adapters(params, seed):
    """lora_b moved off zero, so every adapter path is live."""
    rng = np.random.default_rng(seed + 100)
    return jax.tree_util.tree_map_with_path(
        lambda path, x: np.asarray(x) + (
            0.02 * rng.standard_normal(x.shape).astype(np.float32) if "lora_b" in jax.tree_util.keystr(path) else 0.0
        ),
        params,
    )


def _ring_flash_lm():
    cfg = ttr.TransformerConfig(**SMALL, dtype=torch.float32)
    attn = ttr.resolve_attention("ring_flash", config=tfa.FlashConfig(8, 8), mesh=_cpu_mesh(RING))
    return cfg, ttr.CausalLM(cfg, attn)


def test_ring_flash_model_matches_jax_ring_model():
    """Logits and LoRA gradients of the port's ring-flash LM against JAX's
    attn="ring" LM (pure XLA) from the same params, with a node-stacked
    batch [N, bs, T] that the model flattens before attention. fp32:
    logits 3e-5, gradients 1e-5 of the largest."""
    jmodel = _jax_lm("ring")
    p = _live_adapters(jmodel.params, seed=0)
    rng = np.random.default_rng(1)
    x = rng.integers(0, VOCAB, (3, 2, SEQ)).astype(np.int32)
    y = rng.integers(0, VOCAB, (3, 2, SEQ)).astype(np.int32)
    jlora, jbase = jax.tree.map(jnp.asarray, split_lora(p))

    @jax.jit
    def jax_logits_and_grads(lo):
        from p2pfl_tpu.learning.lora import merge_params as jmerge

        def loss(lo):
            logits = jmodel.module.apply({"params": jmerge(jbase, lo)}, x.reshape(6, SEQ))
            return optax.softmax_cross_entropy_with_integer_labels(logits, y.reshape(6, SEQ)).mean(), logits

        return jax.grad(loss, has_aux=True)(lo)

    jgrads, want_logits = jax_logits_and_grads(jlora)
    _, module = _ring_flash_lm()
    tparams = params_from_jax(p, device="cpu")
    lora, base = split_lora(tparams)
    lora = tree_map(lambda t: t.requires_grad_(True), lora)
    logits = module(merge_params(base, lora), torch.tensor(x))
    assert logits.shape == (3, 2, SEQ, VOCAB)
    np.testing.assert_allclose(logits.detach().numpy().reshape(6, SEQ, VOCAB), np.asarray(want_logits), atol=3e-5)
    loss, _ = _lm_loss(lora, base, module, torch.tensor(x.reshape(6, SEQ)), torch.tensor(y.reshape(6, SEQ)))
    loss.backward()
    want = dict(tree_items(jax.tree.map(np.asarray, jgrads)))
    scale = max(np.abs(w).max() for w in want.values())
    for path, leaf in tree_items(lora):
        np.testing.assert_allclose(leaf.grad.numpy(), want[path], atol=1e-5 * scale, err_msg=path)


FED = dict(n_nodes=4, batch_size=4, vote=True, seed=3, learning_rate=1e-2)


def test_federation_round_with_ring_flash_matches_jax_dense_round():
    """One SpmdLoraFederation round, fused rounds and eval with ring-flash
    attention (R = 4) against JAX's round of the dense-attention model on
    the same data and params (ring attention computes the same function;
    no JAX test runs a ring inside the federation). The fp32 tolerances of
    test_federation_fp32_matches_jax."""
    jmodel = _jax_lm()
    kw = dict(vocab_size=VOCAB, seq_len=SEQ, n_train=32, n_test=16)
    jfed = JaxFederation.from_dataset(jmodel, JaxDataset.synthetic_lm(**kw), **FED)
    tcfg, module = _ring_flash_lm()
    tmodel = TorchModel(module, params_from_jax(jax.tree.map(np.asarray, jmodel.params), device="cpu"),
                        (SEQ,), VOCAB, {"config": tcfg})
    tfed = SpmdLoraFederation.from_dataset(tmodel, FederatedDataset.synthetic_lm(**kw), device="cpu", **FED)

    je, te = jfed.run_round(), tfed.run_round()
    assert np.array_equal(jfed.train_mask, tfed.train_mask)
    assert float(te["train_loss"]) == pytest.approx(float(je["train_loss"]), abs=2e-5)
    want, got = jax.tree.map(np.asarray, jfed.params), params_to_jax(tfed.params)
    assert max(np.abs(a - b).max() for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got))) <= 5e-4
    for a, b in zip(jfed.run_fused(1), tfed.run_fused(1)):
        assert float(b["train_loss"]) == pytest.approx(float(a["train_loss"]), abs=1e-4)
    jm, tm = jfed.evaluate(), tfed.evaluate()
    assert tm["test_loss"] == pytest.approx(jm["test_loss"], abs=1e-4)
    assert tm["test_acc"] == pytest.approx(jm["test_acc"], abs=1.0 / (4 * SEQ))


def test_tiny_transformer_ring_flash_resolves_per_shard_schedule():
    """attn="ring_flash" fits the flash schedule to seq_len // model, and a
    shard length with no usable block is refused as in JAX."""
    cfg = ttr.TransformerConfig(**SMALL)
    model = ttr.tiny_transformer(seq_len=4096, cfg=cfg, attn="ring_flash", mesh=_cpu_mesh(4), device="cpu")
    hop_cfg = model.module.layers[0].attn.attend.keywords["flash_config"]
    assert (hop_cfg.block_q, hop_cfg.block_k) == (128, 128)
    short = ttr.tiny_transformer(seq_len=256, cfg=cfg, attn="ring_flash", mesh=_cpu_mesh(4), device="cpu")
    assert short.module.layers[0].attn.attend.keywords["flash_config"].block_q == 64
    with pytest.raises(ValueError, match="per shard"):
        ttr.tiny_transformer(seq_len=4 * 1030, cfg=cfg, attn="ring_flash", mesh=_cpu_mesh(4), device="cpu")
    with pytest.raises(ValueError, match="needs a mesh"):
        ttr.tiny_transformer(seq_len=64, cfg=cfg, attn="ring_flash", device="cpu")
