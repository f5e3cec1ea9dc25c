"""The full-model SpmdFederation on the card: ``run_fused`` replays a
captured CUDA graph there, held bit for bit against the eager program.

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
