"""The full-model SpmdFederation on the card: ``run_fused`` replays a
captured CUDA graph there, held bit for bit against the eager program
(the MLP, and a scheduled ResNet span with and without remat); a
checkpoint restores onto the card and resumes bit for bit; two processes
run the same rounds to the same bits; fp32 products are IEEE fp32 there
(the package turns TF32 off when imported).

Marked ``cuda``: it needs an NVIDIA GPU and skips elsewhere. It imports
nothing of the JAX package, so it runs on a machine without flax:

    timeout 300 python -m pytest -m cuda tests/test_torch_cuda_spmd.py
"""

import pytest
import torch

from p2pfl_tpu_torch.examples.bench_mnist import HARD_TASK as HARD
from p2pfl_tpu_torch.learning.dataset import FederatedDataset
from p2pfl_tpu_torch.models.vision import mlp
from p2pfl_tpu_torch.ops.tree import tree_items
from p2pfl_tpu_torch.parallel import spmd as tspmd
from p2pfl_tpu_torch.parallel.spmd import SpmdFederation

N_NODES, BATCH = 4, 32


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (fused spans are captured as CUDA graphs there)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_captured_spans_match_eager_spans(cuda):
    """On the card ``run_fused`` replays a captured CUDA graph: two spans
    (with and without eval), a reset and a third span give, bit for bit,
    what the eager program gives from the same state and shuffles."""
    data = FederatedDataset.synthetic_mnist(n_train=N_NODES * 128, n_test=N_NODES * 32, **HARD)
    model = mlp(seed=0, device=cuda)
    kw = dict(n_nodes=N_NODES, batch_size=BATCH, vote=True, seed=3, keep_opt_state=True)
    fed = SpmdFederation.from_dataset(model, data, device=cuda, **kw)
    ref = SpmdFederation.from_dataset(model, data, device=cuda, **kw)
    assert fed._capturable()

    def eager(eval_):
        perms, mask, sel = ref._fused_inputs(2, 1)
        out = tspmd.spmd_rounds_fused(
            ref.params, ref.opt_state, ref.x_all, ref.y_all, perms, mask, ref._samples, sel,
            x_test=ref.x_test if eval_ else None, y_test=ref.y_test if eval_ else None,
            **ref._round_kwargs(), **ref._algo_kwargs(0),
        )
        ref.params, ref.opt_state = out[:2]
        ref.round += 2
        return out[2:]

    for eval_ in (True, False, True):
        got = fed.run_fused(2, eval=eval_)
        want = eager(eval_)
        assert torch.equal(torch.stack([e["train_loss"] for e in got]), want[0])
        if eval_:
            assert torch.equal(torch.stack([e["test_acc"] for e in got]), want[1])
        for (_, a), (_, b) in zip(tree_items(fed.params), tree_items(ref.params)):
            assert torch.equal(a, b)
        assert int(fed.opt_state.count) == int(ref.opt_state.count)
    assert len(fed._spans) == 2
    fed.reset(seed=3)
    ref.reset(seed=3)
    got, want = fed.run_fused(2, eval=True), eager(True)
    assert torch.equal(torch.stack([e["test_acc"] for e in got]), want[1])


def _resnet_fed(cuda, seed: int = 0, **kw) -> SpmdFederation:
    """Config 2's recipe at a reduced depth: ResNet(stage_sizes=(1, 1)) at
    full width on 2 nodes, Adam over the warmup-cosine schedule with kept
    moments, the synthetic-hard CIFAR-shaped task."""
    from p2pfl_tpu_torch.learning.optimizers import adam, warmup_cosine_decay_schedule
    from p2pfl_tpu_torch.models.base import TorchModel
    from p2pfl_tpu_torch.models.vision import ResNet, init_resnet_params

    module = ResNet((1, 1))
    model = TorchModel(module, init_resnet_params(module, (32, 32, 3), seed, cuda), (32, 32, 3))
    data = FederatedDataset.synthetic_mnist(n_train=2 * 64, n_test=64, dim=(32, 32, 3), **HARD)
    tx = adam(warmup_cosine_decay_schedule(0.0, 3e-3, 4, 40, 1e-4))
    return SpmdFederation.from_dataset(model, data, n_nodes=2, batch_size=16, vote=False, seed=3,
                                       tx=tx, keep_opt_state=True, device=cuda, **kw)


@pytest.mark.cuda
def test_captured_resnet_span_matches_eager(cuda):
    """A scheduled ResNet span (``run_fused``, 2 rounds with eval) replays
    as a captured CUDA graph and gives, bit for bit, what the eager program
    gives from the same state and shuffles; the schedule's step count lives
    on the card and moves with the replays."""
    fed, ref = _resnet_fed(cuda), _resnet_fed(cuda)
    assert fed._capturable()
    for _ in range(2):
        got = fed.run_fused(2, eval=True)
        perms, mask, sel = ref._fused_inputs(2, 1)
        out = tspmd.spmd_rounds_fused(
            ref.params, ref.opt_state, ref.x_all, ref.y_all, perms, mask, ref._samples, sel,
            x_test=ref.x_test, y_test=ref.y_test, **ref._round_kwargs(), **ref._algo_kwargs(0),
        )
        ref.params, ref.opt_state = out[:2]
        assert torch.equal(torch.stack([e["train_loss"] for e in got]), out[2])
        assert torch.equal(torch.stack([e["test_acc"] for e in got]), out[3])
        for (_, a), (_, b) in zip(tree_items(fed.params), tree_items(ref.params)):
            assert torch.equal(a, b)
    assert len(fed._spans) == 1 and int(fed.opt_state.count) == 4 * fed._nb


@pytest.mark.cuda
def test_checkpoint_restores_onto_the_card(cuda, tmp_path):
    """Saved after round 1 (the files hold host copies), restored into a
    fresh federation on the card: the state lands on the card and round 2
    equals the uninterrupted run's bit for bit."""
    a = _resnet_fed(cuda)
    a.run_round()
    a.save(str(tmp_path))
    want = a.run_round()["train_loss"]
    b = _resnet_fed(cuda, seed=1)
    b.restore(str(tmp_path))
    leaves = torch.utils._pytree.tree_leaves((b.params, b.opt_state))
    assert all(x.is_cuda for x in leaves) and b.round == 1
    assert torch.equal(b.run_round()["train_loss"], want)
    for x, y in zip(torch.utils._pytree.tree_leaves((a.params, a.opt_state)),
                    torch.utils._pytree.tree_leaves((b.params, b.opt_state))):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_captured_remat_span_matches_eager(cuda):
    """With ``remat`` (non-reentrant checkpoint) the span still captures,
    and its replays give the eager program's bits."""
    fed, ref = _resnet_fed(cuda, remat=True), _resnet_fed(cuda, remat=True)
    assert fed._capturable()
    for _ in range(2):
        got = fed.run_fused(1)
        perms, mask, sel = ref._fused_inputs(1, 1)
        out = tspmd.spmd_rounds_fused(ref.params, ref.opt_state, ref.x_all, ref.y_all, perms, mask,
                                      ref._samples, sel, **ref._round_kwargs(), **ref._algo_kwargs(0))
        ref.params, ref.opt_state = out[:2]
        assert torch.equal(got[0]["train_loss"], out[2][0])
        for (_, a), (_, b) in zip(tree_items(fed.params), tree_items(ref.params)):
            assert torch.equal(a, b)
    assert len(fed._spans) == 1


_TWO_PROCESS = """
import hashlib, sys, torch
sys.path[:0] = [{repo!r}, {repo!r} + "/tests"]
from test_torch_cuda_spmd import _resnet_fed
fed = _resnet_fed(torch.device("cuda"))
for _ in range(3):
    fed.run_fused(1, eval=True)
h = hashlib.sha256()
for t in torch.utils._pytree.tree_leaves((fed.params, fed.opt_state)):
    h.update(t.detach().reshape(-1).cpu().view(torch.uint8).numpy().tobytes())
print("DIGEST", h.hexdigest())
"""


@pytest.mark.cuda
def test_two_processes_give_the_same_bits(cuda):
    """Config 2's recipe at a reduced depth, 3 captured rounds with eval,
    in two processes with other ``PYTHONHASHSEED``s: the params and Adam
    state end bit-equal (Queue C's C3: nothing of the round program varies
    from process to process)."""
    import os
    import pathlib
    import subprocess
    import sys

    repo = str(pathlib.Path(__file__).resolve().parents[1])
    digests = []
    for seed in ("1", "2"):
        proc = subprocess.run([sys.executable, "-c", _TWO_PROCESS.format(repo=repo)], capture_output=True,
                              text=True, timeout=300, env=dict(os.environ, PYTHONHASHSEED=seed), cwd=repo)
        assert proc.returncode == 0, proc.stderr[-2000:]
        digests.append(next(line for line in proc.stdout.splitlines() if line.startswith("DIGEST")))
    assert digests[0] == digests[1]


@pytest.mark.cuda
def test_fp32_products_are_ieee_on_the_card(cuda):
    """Importing the package turned both TF32 flags off, and building and
    running a federation on the card leaves them off."""
    assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32
    _resnet_fed(cuda).run_round()
    assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32
