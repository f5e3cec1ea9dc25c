"""The port's GPipe pipeline (``p2pfl_tpu_torch/parallel/pipeline.py``)
against sequential execution and against the JAX package's
``pipeline_apply`` / ``pipelined_lm_apply`` on the CPU.

JAX's side runs on the virtual CPU devices ``tests/conftest.py`` forces,
one stage a device; the port's stages are CPU positions of one
``pipeline_mesh``. Inputs are drawn with numpy from fixed seeds and handed
to both sides. fp32 throughout: against JAX ``rtol 2e-5, atol 1e-6``
(the frameworks sum products in other orders); the port against its own
sequential or monolithic run bit for bit where the shapes are the same.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from p2pfl_tpu.models import transformer as jtr
from p2pfl_tpu.parallel import pipeline as jpipe
from p2pfl_tpu_torch.convert import params_from_jax
from p2pfl_tpu_torch.learning.learner import adam, apply_updates, softmax_cross_entropy
from p2pfl_tpu_torch.models import transformer as ttr
from p2pfl_tpu_torch.ops.tree import tree_items, tree_leaves, tree_map, tree_unflatten
from p2pfl_tpu_torch.parallel import pipeline as tpipe
from p2pfl_tpu_torch.parallel.mesh import pipeline_mesh

torch.set_num_threads(2)

RTOL, ATOL = 2e-5, 1e-6


def _cpu_mesh(n: int):
    return pipeline_mesh(n, devices=["cpu"] * n)


def _toy_layers(n_layers: int, dim: int = 16, seed: int = 0) -> list:
    rng = np.random.default_rng(seed)
    return [
        {"w": (rng.standard_normal((dim, dim)) * 0.3).astype(np.float32),
         "b": (rng.standard_normal(dim) * 0.1).astype(np.float32)}
        for _ in range(n_layers)
    ]


def _t_toy(p, act):
    return torch.tanh(act @ p["w"] + p["b"])


def _j_toy(p, act):
    return jnp.tanh(act @ p["w"] + p["b"])


def _t_sequential(layers, x):
    for p in layers:
        x = _t_toy(p, x)
    return x


def _torch_layers(layers):
    return [tree_map(torch.from_numpy, p) for p in layers]


@pytest.mark.parametrize("n_stages,n_micro", [(4, 4), (4, 8), (8, 8), (2, 6)])
def test_pipeline_forward_matches_sequential_and_jax(n_stages, n_micro):
    """The GPipe schedule's output is the sequential run's bit for bit (the
    same per-microbatch products) and JAX's ``pipeline_apply`` within fp32
    ulps."""
    layers = _toy_layers(n_layers=n_stages * 2 if n_stages == 2 else n_stages)
    x = np.random.default_rng(9).standard_normal((n_micro, 4, 16)).astype(np.float32)
    tl = _torch_layers(layers)
    out = tpipe.pipeline_apply(tpipe.stack_layers(tl), torch.from_numpy(x), _t_toy, _cpu_mesh(n_stages))
    assert out.shape == (n_micro, 4, 16)
    assert torch.equal(out, _t_sequential(tl, torch.from_numpy(x)))
    want = jpipe.pipeline_apply(
        jpipe.stack_layers(jax.tree.map(jnp.asarray, layers)), jnp.asarray(x), _j_toy, jpipe.pipeline_mesh(n_stages)
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n_stages,n_micro", [(4, 6), (2, 4)])
def test_pipeline_grads_match_sequential_and_jax(n_stages, n_micro):
    """Autograd through the schedule gives the sequential loss's gradient
    (a weight's gradient summed microbatch by microbatch, the sequential
    run's in one product: fp32 ulps apart) and JAX's ``jax.grad`` of its
    pipelined loss."""
    layers = _toy_layers(n_layers=4)
    x = np.random.default_rng(3).standard_normal((n_micro, 4, 16)).astype(np.float32)
    tl = _torch_layers(layers)
    stacked = tree_map(lambda a: a.requires_grad_(True), tpipe.stack_layers(tl))
    loss = (tpipe.pipeline_apply(stacked, torch.from_numpy(x), _t_toy, _cpu_mesh(n_stages)) ** 2).sum()
    g = torch.autograd.grad(loss, tree_leaves(stacked))
    seq = tree_map(lambda a: a.clone().requires_grad_(True), tpipe.stack_layers(tl))
    ref_loss = (_t_sequential([tree_map(lambda a, i=i: a[i], seq) for i in range(4)], torch.from_numpy(x)) ** 2).sum()
    g_ref = torch.autograd.grad(ref_loss, tree_leaves(seq))
    for a, b in zip(g, g_ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL, atol=ATOL)

    mesh = jpipe.pipeline_mesh(n_stages)
    jx = jnp.asarray(x)
    jg = jax.grad(lambda sp: jnp.sum(jpipe.pipeline_apply(sp, jx, _j_toy, mesh) ** 2))(
        jpipe.stack_layers(jax.tree.map(jnp.asarray, layers))
    )
    for a, b in zip(g, [jg["b"], jg["w"]]):  # sorted-key order: b, w
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-5)


def test_pipeline_rejects_indivisible_layers_and_short_meshes():
    tl = _torch_layers(_toy_layers(n_layers=3))
    with pytest.raises(ValueError, match="not divisible"):
        tpipe.pipeline_apply(tpipe.stack_layers(tl), torch.zeros(4, 2, 16), _t_toy, _cpu_mesh(4))
    with pytest.raises(ValueError, match="not divisible"):
        jpipe.pipeline_apply(
            jpipe.stack_layers(jax.tree.map(jnp.asarray, _toy_layers(n_layers=3))), jnp.zeros((4, 2, 16)),
            _j_toy, jpipe.pipeline_mesh(4),
        )
    # as JAX's: more stages than devices raise
    with pytest.raises(ValueError, match="need 4 devices, have 2"):
        pipeline_mesh(4, devices=["cpu"] * 2)


def _lm(n_experts: int = 0, seed: int = 0, **kw):
    """(jax cfg, jax model, port cfg, port model) from one JAX init."""
    both = dict(vocab_size=64, dim=32, n_layers=4, n_heads=2, n_kv_heads=2, ffn_hidden=64, lora_rank=0,
                n_experts=n_experts, **kw)
    jcfg = jtr.TransformerConfig(**both, dtype=jnp.float32)
    tcfg = ttr.TransformerConfig(**both, dtype=torch.float32)
    jm = jtr.tiny_transformer(seq_len=16, cfg=jcfg, seed=seed)
    tm = ttr.tiny_transformer(seq_len=16, cfg=tcfg, device="cpu")
    tm = dataclasses.replace(tm, params=params_from_jax(jm.params, device="cpu"))
    return jcfg, jm, tcfg, tm


def test_pipelined_transformer_matches_monolithic_and_jax():
    """``pipelined_lm_apply`` of a 4-layer LM over 4 stages: the port's
    monolithic forward bit for bit, JAX's pipelined forward within fp32
    ulps; fewer microbatches than stages and the indivisible batch."""
    jcfg, jm, tcfg, tm = _lm()
    tokens = np.random.default_rng(1).integers(0, 64, (8, 16))
    tt = torch.from_numpy(tokens)
    mono = tm.module(tm.params, tt)
    for n_micro in (0, 2, 8):
        out = tpipe.pipelined_lm_apply(tm.params, tt, tcfg, _cpu_mesh(4), n_micro=n_micro)
        assert torch.equal(out, mono), n_micro
    want = jpipe.pipelined_lm_apply(jm.params, jnp.asarray(tokens), jcfg, jpipe.pipeline_mesh(4))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=RTOL, atol=1e-5)
    with pytest.raises(ValueError, match="not divisible into 3 microbatches"):
        tpipe.pipelined_lm_apply(tm.params, tt, tcfg, _cpu_mesh(4), n_micro=3)


def test_pipelined_moe_aux_flows_and_equals_jax():
    """MoE blocks in the pipeline: each microbatch routes apart, the aux is
    summed over layers and averaged over microbatches as JAX's, the router
    gradients flow, and an MoE config without ``return_aux`` raises."""
    jcfg, jm, tcfg, tm = _lm(n_experts=4)
    tokens = np.random.default_rng(5).integers(0, 64, (8, 16))
    tt = torch.from_numpy(tokens)
    with pytest.raises(ValueError, match="return_aux"):
        tpipe.pipelined_lm_apply(tm.params, tt, tcfg, _cpu_mesh(4))
    logits, aux = tpipe.pipelined_lm_apply(tm.params, tt, tcfg, _cpu_mesh(4), return_aux=True)
    jlogits, jaux = jpipe.pipelined_lm_apply(jm.params, jnp.asarray(tokens), jcfg, jpipe.pipeline_mesh(4),
                                             return_aux=True)
    assert logits.shape == (8, 16, 64) and float(aux) > 0.0
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=RTOL, atol=1e-5)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=RTOL, atol=ATOL)
    # per-microbatch balance fractions: not the monolithic model's full-batch aux
    _, mono_aux = tm.module.forward_with_aux(tm.params, tt)
    assert abs(float(mono_aux) - float(aux)) > 0.0

    paths = [p for p, _ in tree_items(tm.params)]
    leaves = [v.clone().requires_grad_(True) for v in tree_leaves(tm.params)]
    targets = torch.roll(tt, -1, dims=1)
    lo, a = tpipe.pipelined_lm_apply(tree_unflatten(dict(zip(paths, leaves))), tt, tcfg, _cpu_mesh(4),
                                     return_aux=True)
    g = torch.autograd.grad(softmax_cross_entropy(lo, targets).mean() + a, leaves)
    router = [gr for p, gr in zip(paths, g) if "router" in p]
    assert router and all(float(gr.abs().max()) > 0 for gr in router)


def test_pipelined_transformer_train_step():
    """A pipelined train step: its gradients equal the monolithic model's
    (a weight's gradient summed microbatch by microbatch: fp32 ulps) and
    JAX's pipelined gradients; eight Adam steps lower the loss."""
    jcfg, jm, tcfg, tm = _lm()
    tokens = np.random.default_rng(2).integers(0, 64, (8, 16))
    tt, targets = torch.from_numpy(tokens), torch.from_numpy(np.roll(tokens, -1, axis=1))
    mesh = _cpu_mesh(4)
    paths = [p for p, _ in tree_items(tm.params)]

    def value_and_grad(params, fwd):
        leaves = [v.detach().requires_grad_(True) for v in tree_leaves(params)]
        loss = softmax_cross_entropy(fwd(tree_unflatten(dict(zip(paths, leaves)))), targets).mean()
        return loss.detach(), tree_unflatten(dict(zip(paths, torch.autograd.grad(loss, leaves))))

    def pipe(p):
        return tpipe.pipelined_lm_apply(p, tt, tcfg, mesh)

    _, g = value_and_grad(tm.params, pipe)
    _, g_ref = value_and_grad(tm.params, lambda p: tm.module(p, tt))
    for (path, a), (_, b) in zip(tree_items(g), tree_items(g_ref)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL, atol=ATOL, err_msg=path)

    jmesh = jpipe.pipeline_mesh(4)

    def jloss(p):
        logits = jpipe.pipelined_lm_apply(p, jnp.asarray(tokens), jcfg, jmesh)
        return optax.softmax_cross_entropy_with_integer_labels(logits, jnp.asarray(targets.numpy())).mean()

    jg = params_from_jax(jax.grad(jloss)(jm.params), device="cpu")
    for (path, a), (_, b) in zip(tree_items(g), tree_items(jg)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-6, err_msg=path)

    tx = adam(1e-2)
    params, opt = tm.params, tx.init(tm.params)
    losses = []
    for _ in range(8):
        loss, grads = value_and_grad(params, pipe)
        updates, opt = tx.update(grads, opt, params)
        params = apply_updates(params, updates)
        losses.append(float(loss))
    assert losses[-1] < losses[0]
