"""The megafleet chunk step's kernel (``csrc/fleet_chunk.cu``) on the card.

Marked ``cuda``: they need an NVIDIA GPU with ``nvcc`` and skip elsewhere
(the kernel has no CPU mode; on the CPU the engine runs its plain twin,
which ``tests/test_torch_megafleet.py`` holds against JAX). This file
imports only the port (the card machine has no flax):

    timeout 600 python -m pytest -m cuda tests/test_torch_cuda_megafleet.py

``chip_smoke.py --only megafleet`` drives the same paths and the 1M fleet.
"""

import pytest
import torch

import chip_smoke
from p2pfl_tpu_torch.ops import _kernels
from p2pfl_tpu_torch.settings import set_test_settings

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the fleet_chunk kernel has no CPU mode)")
    _kernels.build()
    set_test_settings()
    yield torch.device("cuda")


@pytest.mark.parametrize("case", ["flat", "hier", "median", "trimmed", "chaos", "byzantine", "churn", "linear_task",
                                  "mlp_task"])
def test_kernel_matches_its_twin_and_repeats_bit_for_bit(cuda, case):
    """The chunked engine on the card (one kernel launch a chunk, and one
    more for each lane a gradient task retrains mid-chunk) against the
    same engine on the CPU (the plain twin): counters, histograms, mint
    times and window keys equal, params within ``MF_PARAM_TOL`` of the
    largest; a second card run equals the first bit for bit."""
    if case.endswith("_task"):
        mega = chip_smoke._mf_grad(case.split("_")[0], 0 if case == "linear_task" else 16)
    elif case in ("median", "trimmed"):
        mega = chip_smoke._mf_attack("median" if case == "median" else "trimmed-mean", 32)
    elif case in ("chaos", "byzantine", "churn"):
        mega = chip_smoke._mf_faults(case)
    else:
        mega = chip_smoke._mf_small(cluster_size=0 if case == "flat" else 32, chunk=48, device="cuda")
    _kernels.reset_launches()
    card = [mega.chunked_engine() for _ in range(2)]
    for eng in card:
        eng.run()
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["fleet_chunk"] == 2 * card[0].n_chunks + card[0].resumes + card[1].resumes
    assert (card[0].resumes > 0) == (mega.task is not None)
    twin = mega.chunked_engine(device="cpu")
    twin.run()
    exact, gap, scale = chip_smoke.compare_carries(card[0], twin)
    assert exact
    assert gap <= chip_smoke.MF_PARAM_TOL * max(scale, 1.0)
    assert all(torch.equal(card[0].carry[k], card[1].carry[k]) for k in card[0].carry)
    assert int(card[0].carry["si"][2]) > 0  # merged


def test_chunked_engine_on_the_card_follows_the_per_event_engine(cuda):
    rows = chip_smoke.megafleet_engines("cuda")
    bad = {name: row["checks"] for name, row in rows.items() if not all(row["checks"].values())}
    assert not bad


def test_gradient_task_fleet_runs_on_the_card(cuda):
    """``MegaFleet(task=...)`` at its default device: the card's run
    merges as the CPU's, its loss falls within 1e-4 of the CPU's."""
    res = chip_smoke._mf_grad("linear", 0, device=None).run()
    ref = chip_smoke._mf_grad("linear", 0, device="cpu").run()
    assert res.params["w"].device.type == "cuda"
    assert (res.merges, [x[:2] for x in res.loss_curve]) == (ref.merges, [x[:2] for x in ref.loss_curve])
    assert abs(res.final_loss() - ref.final_loss()) <= 1e-4 * max(abs(ref.final_loss()), 1.0)
