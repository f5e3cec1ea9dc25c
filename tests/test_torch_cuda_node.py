"""The gossip Node's round on the card: the fused round's CUDA graph and
``LoRALearner`` through flash kernels 1-4.

Marked ``cuda``: they need an NVIDIA GPU with ``nvcc`` and skip elsewhere.
This file imports only the port (the card machine has no flax):

    timeout 600 python -m pytest -m cuda tests/test_torch_cuda_node.py

``chip_smoke.py`` (phases ``gossip`` and ``node_lora``) drives the same
paths at full width.
"""

import threading

import numpy as np
import pytest
import torch

import chip_smoke
from p2pfl_tpu_torch.learning.dataset import FederatedDataset
from p2pfl_tpu_torch.learning.learner import TorchLearner
from p2pfl_tpu_torch.learning.lora import LoRALearner, _lm_loss
from p2pfl_tpu_torch.management.logger import logger
from p2pfl_tpu_torch.models.transformer import TransformerConfig, tiny_transformer
from p2pfl_tpu_torch.models.vision import mlp
from p2pfl_tpu_torch.ops import _kernels
from p2pfl_tpu_torch.ops import flash_attention as fa
from p2pfl_tpu_torch.ops.flash_attention import FlashConfig
from p2pfl_tpu_torch.ops.tree import tree_items, tree_leaves, tree_unflatten
from p2pfl_tpu_torch.parallel import spmd

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    _kernels.build()
    return torch.device("cuda")


def _learner(cuda, seed: int, data, prox_mu: float = 0.0) -> TorchLearner:
    return TorchLearner(mlp(seed=seed, device=cuda), data, addr=f"card-{seed}", batch_size=128, epochs=2, seed=seed,
                        prox_mu=prox_mu)


def _eager_twin(learner: TorchLearner):
    """The next fused round of ``learner`` computed eagerly, without
    touching it: the same rng draws, params and opt state."""
    rng = np.random.default_rng()
    rng.bit_generator.state = learner._rng.bit_generator.state
    batches = [learner.data.epoch_batches(learner.batch_size, rng) for _ in range(learner.epochs)]
    dev = learner.device
    x_test, y_test = learner._test_tensors()
    return spmd.fused_node_round(
        learner.params, learner.opt_state,
        torch.from_numpy(np.stack([b[0] for b in batches])).to(dev),
        torch.from_numpy(np.stack([b[1] for b in batches])).to(dev),
        torch.tensor(float(learner.get_num_samples()), device=dev), x_test, y_test,
        module=learner.module, tx=learner.tx, prox_mu=learner.prox_mu,
    )


def _equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(torch.utils._pytree.tree_leaves(a), torch.utils._pytree.tree_leaves(b)))


@pytest.mark.parametrize("prox_mu", [0.0, 0.01])
def test_fused_round_graph_replay_is_bit_equal_to_eager(cuda, prox_mu):
    """Round 0 captures the node's step graph, every round replays it for
    each of its 2 epochs' batches; every round's params, opt state,
    accumulator and metrics equal the eager program's bit for bit, with
    no degradation; with FedProx too (the graph's anchor buffer)."""
    data = FederatedDataset.synthetic_mnist(n_train=2048, n_test=256)
    learner = _learner(cuda, 0, data, prox_mu)
    logger.reset_comm_metrics()
    for _ in range(4):
        want = _eager_twin(learner)
        own = learner.fused_round()
        assert own is not None
        metrics = learner.pop_round_metrics()
        assert _equal(learner.params, want["params"]) and _equal(learner.opt_state, want["opt_state"])
        assert _equal(own.partial_acc, (want["psum"], want["wsum"]))
        assert torch.equal(metrics["train_loss_series"][0], want["train_losses"])
        assert torch.equal(metrics["test_loss"], want["eval_loss"])
        # the next round starts from a fresh optimizer on the aggregate
        learner.set_parameters(learner.get_parameters())
    counts = logger.get_comm_metrics(learner.addr)
    assert counts.get("fused_graph_capture") == 1 and counts.get("fused_graph_replay") == 3
    assert "fused_round_degraded" not in counts


def test_back_to_back_fused_rounds_from_four_threads(cuda):
    """Four learners' threads run 20 fused rounds each at once on one card
    (captures included): no hang, no degradation, and each learner ends
    bit-equal to the same 20 rounds run eagerly on one thread."""
    data = FederatedDataset.synthetic_mnist(n_train=2048, n_test=256)
    shards = [data.partition(i, 4) for i in range(4)]
    learners = [_learner(cuda, i, shards[i]) for i in range(4)]
    twins = [_learner(cuda, i, shards[i]) for i in range(4)]
    logger.reset_comm_metrics()
    errors: list = []

    def run(learner):
        try:
            for _ in range(20):
                assert learner.fused_round() is not None
                learner.set_parameters(learner.get_parameters())
        except Exception as exc:  # noqa: BLE001 — reported below
            errors.append(exc)

    threads = [threading.Thread(target=run, args=(lr,)) for lr in learners]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads), "a fused-round thread hung"
    assert not errors, errors
    torch.cuda.synchronize()
    for twin in twins:
        for _ in range(20):
            out = _eager_twin(twin)
            twin._rng = _advance(twin)
            twin.set_parameters(out["params"])
    for learner, twin in zip(learners, twins):
        assert _equal(learner.params, twin.params)
    counts = logger.get_comm_metrics()
    assert all(counts[lr.addr].get("fused_graph_replay") == 19 for lr in learners), counts
    assert not any("fused_round_degraded" in c for c in counts.values()), counts


def _advance(learner: TorchLearner):
    """The learner's rng after one round's draws."""
    for _ in range(learner.epochs):
        learner.data.epoch_batches(learner.batch_size, learner._rng)
    return learner._rng


def _lora_grads(model, base, lora, x, y):
    paths = [p for p, _ in tree_items(lora)]
    leaves = [v.detach().requires_grad_(True) for v in tree_leaves(lora)]
    loss, _ = _lm_loss(tree_unflatten(dict(zip(paths, leaves))), base, model.module, x, y)
    return loss.detach(), torch.autograd.grad(loss, leaves)


def _relative_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got.float() - want.float()).norm() / want.float().norm().clamp_min(1e-30)).item()


@pytest.mark.parametrize("bwd_mode", ["auto", "split"])
def test_lora_learner_step_with_kernels_matches_plain(cuda, bwd_mode, monkeypatch):
    """A ``LoRALearner``'s step on the card (2 layers at config 5's width,
    seq 256, batch 2) with flash kernels 1 and 2 (``auto``) or 1, 3 and 4
    (``split``): every kernel call of the step, on the step's own
    activations, within chip_smoke's card limit of its plain version; the
    step itself against the same step through the plain versions on the
    card: the loss to 1e-3 relative and each adapter gradient to 2^-4
    relative L2 (the kernels' ulp-level differences pass through two
    layers of bf16 GEMMs, so the per-element kernel limit does not apply
    to the gradients); the learner's own epoch launches the kernels and
    leaves the base bit-unchanged."""
    cfg = TransformerConfig(
        vocab_size=4096, dim=2048, n_heads=32, n_kv_heads=4, n_layers=2, ffn_hidden=5632, lora_rank=8,
        lora_mlp=True, flash_config=None if bwd_mode == "auto" else FlashConfig(bwd_mode=bwd_mode),
    )
    data = FederatedDataset.synthetic_lm(vocab_size=4096, seq_len=256, n_train=2, n_test=2)
    model = tiny_transformer(seq_len=256, seed=0, cfg=cfg, attn="flash", device=cuda)
    learner = LoRALearner(model, data, batch_size=2)
    # nonzero lora_b, so every adapter has a gradient
    gen = torch.Generator(device=cuda).manual_seed(1)
    learner.set_parameters(tree_unflatten({
        p: (torch.randn(v.shape, generator=gen, device=cuda) * 0.02 if p.endswith("lora_b") else v)
        for p, v in tree_items(learner.get_parameters())
    }))
    x = torch.from_numpy(data.x_train).to(cuda)
    y = torch.from_numpy(data.y_train).to(cuda)
    calls = {"fwd": [], "bwd": []}
    fwd, bwd = fa.flash_fwd_bhtd, fa.flash_bwd_bhtd
    with monkeypatch.context() as m:
        m.setattr(fa, "flash_fwd_bhtd", lambda *a: calls["fwd"].append(a) or fwd(*a))
        m.setattr(fa, "flash_bwd_bhtd", lambda *a: calls["bwd"].append(a) or bwd(*a))
        _kernels.reset_launches()
        loss_k, grads_k = _lora_grads(model, learner.base, learner.lora, x, y)
        launched = {k: v for k, v in _kernels.LAUNCHES.items() if v}
    want = {"flash_fwd", "flash_bwd_dkvq"} if bwd_mode == "auto" else {"flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"}
    assert set(launched) == want and len(calls["fwd"]) == len(calls["bwd"]) == 2, launched
    for q, k, v, causal, _ in calls["fwd"]:
        o, lse = _kernels.flash_fwd(q, k, v, causal)
        o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, causal, 64, 64)
        assert chip_smoke.check(o, o_ref, fa.flash_fwd_magnitude(q, k, v, causal, 64, 64))[2] <= 1
        assert (lse - lse_ref).abs().max().item() <= chip_smoke.LSE_TOL
    for q, k, v, o, lse, do, causal, _ in calls["bwd"]:
        delta = fa._delta(do, o)
        args = (q, k, v, do, lse, delta, causal)
        got = _kernels.flash_bwd_fused(*args) if bwd_mode == "auto" else _kernels.flash_bwd_split(*args)
        ref = fa.flash_bwd_fused_plain(*args, 64, 64)
        for g, r, terms in zip(got, ref, fa.flash_bwd_magnitude(*args, 64, 64)):
            assert chip_smoke.check(g, r, terms)[2] <= 1
    with monkeypatch.context() as m:
        m.setattr(fa, "_device_kind", lambda t: "cpu")  # the plain versions, on the card
        _kernels.reset_launches()
        loss_p, grads_p = _lora_grads(model, learner.base, learner.lora, x, y)
        assert not any(_kernels.LAUNCHES.values())
    assert abs(loss_k.item() - loss_p.item()) <= 1e-3 * abs(loss_p.item())
    errors = [_relative_l2(gk, gp) for gk, gp in zip(grads_k, grads_p)]
    print(f"[{bwd_mode}] adapter gradients, relative L2 error: max {max(errors):.3e}, "
          f"median {float(np.median(errors)):.3e}")
    assert max(errors) <= 2.0 ** -4
    base = [v.clone() for v in tree_leaves(learner.base)]
    _kernels.reset_launches()
    learner.fit()
    assert all(_kernels.LAUNCHES[k] == 2 for k in want)  # 2 layers, one step
    assert all(torch.equal(a, b) for a, b in zip(base, tree_leaves(learner.base)))
