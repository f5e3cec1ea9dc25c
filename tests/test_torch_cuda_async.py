"""The async control plane on the card.

Marked ``cuda``: they need an NVIDIA GPU with ``nvcc`` and skip elsewhere.
This file imports only the port (the card machine has no flax):

    timeout 600 python -m pytest -m cuda tests/test_torch_cuda_async.py

``chip_smoke.py --only async`` drives the same paths at full size.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from p2pfl_tpu_torch.ops import _kernels
from p2pfl_tpu_torch.settings import Settings

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel 9 has no CPU mode)")
    _kernels.build()
    yield torch.device("cuda")
    Settings.WEIGHTS_PLANE = "bytes"


@pytest.mark.parametrize("cluster", [0, 32])
def test_simulated_fleet_merges_on_the_card_follow_the_cpu(cuda, cluster):
    """300 nodes x 4 updates under the bench's faults: the merges run on
    the card, and the merge count, minted versions, merge times and crash
    list equal the CPU fleet's; losses within 1e-5 relative."""
    sim = dict(chip_smoke.ASYNC_SIM, nodes=300, updates=4)
    card, _ = chip_smoke.async_simulated("cuda", cluster, sim)
    host, _ = chip_smoke.async_simulated("cpu", cluster, sim)
    assert card.params["w"].is_cuda and card.merges == host.merges > 0
    assert [(t, v) for t, v, _ in card.loss_curve] == [(t, v) for t, v, _ in host.loss_curve]
    assert card.crashed == host.crashed
    np.testing.assert_allclose([l for *_, l in card.loss_curve], [l for *_, l in host.loss_curve], rtol=1e-5)


def test_one_async_update_through_kernel_9_equals_the_byte_path(cuda):
    out = chip_smoke.async_update_through_plane("cuda")
    assert all(out["checks"].values()), out
    assert out["launches_ici_exchange"] == 1
