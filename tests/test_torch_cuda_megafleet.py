"""The megafleet chunk step's kernel (``csrc/fleet_chunk.cu``: a span of
chunks a launch, pass A inside for the consensus task) on the card, and
the sharded engine (pass A a shard on slots of ``cuda:0`` or on two
cards, the kernel's staged launches) against the one-slot engine.

Marked ``cuda``: they need an NVIDIA GPU with ``nvcc`` and skip elsewhere
(the kernel has no CPU mode; on the CPU the engine runs its plain twin,
which ``tests/test_torch_megafleet.py`` holds against JAX). This file
imports only the port (the card machine has no flax):

    timeout 600 python -m pytest -m cuda tests/test_torch_cuda_megafleet.py

``chip_smoke.py --only megafleet`` drives the same paths and the 1M fleet;
``--only megafleet_sharded`` the 1M fleet on 2 and 8 slots. The two-card
case runs on a machine with two cards or more (``-k two_cards``).
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


CASES = ["flat", "hier", "median", "trimmed", "chaos", "byzantine", "churn", "linear_task", "mlp_task"]
CONSENSUS = [c for c in CASES if not c.endswith("_task")]


def _fleet(case):
    if case.endswith("_task"):
        return chip_smoke._mf_grad(case.split("_")[0], 0 if case == "linear_task" else 16)
    if case in ("median", "trimmed"):
        return chip_smoke._mf_attack("median" if case == "median" else "trimmed-mean", 32)
    if case in ("chaos", "byzantine", "churn"):
        return chip_smoke._mf_faults(case)
    return chip_smoke._mf_small(cluster_size=0 if case == "flat" else 32, chunk=48, device="cuda")


def _same(a, b) -> bool:
    return all(torch.equal(a.carry[k], b.carry[k]) for k in a.carry)


@pytest.mark.parametrize("case", CASES)
def test_kernel_matches_its_twin_and_repeats_bit_for_bit(cuda, case):
    """The chunked engine on the card (a consensus fleet in one launch; a
    gradient task one launch a chunk and one more for each lane it
    retrains mid-chunk) against the same engine on the CPU (the plain
    twin): counters, histograms, mint times and window keys equal, params
    within ``MF_PARAM_TOL`` of the largest; a second card run equals the
    first bit for bit."""
    mega = _fleet(case)
    _kernels.reset_launches()
    card = [mega.chunked_engine() for _ in range(2)]
    for eng in card:
        eng.run()
    torch.cuda.synchronize()
    per_run = card[0].n_chunks if mega.task is not None else 1
    assert _kernels.LAUNCHES["fleet_chunk"] == 2 * per_run + card[0].resumes + card[1].resumes
    assert (card[0].resumes > 0) == (mega.task is not None)
    twin = mega.chunked_engine(device="cpu")
    twin.run()
    exact, gap, scale = chip_smoke.compare_carries(card[0], twin)
    assert exact
    assert gap <= chip_smoke.MF_PARAM_TOL * max(scale, 1.0)
    assert _same(card[0], card[1])
    assert int(card[0].carry["si"][2]) > 0  # merged


@pytest.mark.parametrize("case", CONSENSUS)
@pytest.mark.parametrize("span", [1, 5])
def test_span_launches_equal_the_one_launch_run(cuda, case, span):
    """Launches of ``span`` chunks (``ceil(chunks / span)`` of them) give
    the one-launch run's carry bit for bit."""
    mega = _fleet(case)
    whole = mega.chunked_engine()
    whole.run()
    _kernels.reset_launches()
    spans = mega.chunked_engine()
    spans.run(span)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["fleet_chunk"] == -(-spans.n_chunks // span)
    assert _same(whole, spans)


@pytest.mark.parametrize("case", ["flat", "hier", "chaos", "byzantine", "churn", "median"])
def test_regional_counters_in_device_memory_equal_shared_memory(cuda, case):
    """The regionals' counters and the folds' window rows kept in device
    memory (the layout of a fleet too large for shared memory: each fold
    then reads its rows there and the window waits for it) give the
    shared-memory run's carry bit for bit, in one launch and chunk by
    chunk."""
    mega = _fleet(case)
    shared = mega.chunked_engine()
    shared.run()
    place = _kernels.fleet_chunk_place(shared.kernel_args)
    assert place["fold_rows"] and place["regionals"] == (case != "flat")
    for span in (None, 1):
        dev = mega.chunked_engine()
        dev.reg_layout = "device"
        dev.run(span)
        place = _kernels.fleet_chunk_place(dev.kernel_args)
        assert not place["regionals"] and not place["fold_rows"]
        assert _same(shared, dev)


@pytest.mark.parametrize("case", CONSENSUS)
def test_fused_pass_a_equals_pytorch_pass_a(cuda, case):
    """Pass A inside the kernel against PyTorch's pass A (the kernel then
    stopping at each lane an in-chunk mint moved, the host retraining it):
    the same carry bit for bit, and PyTorch's flow resumes exactly as
    often as the twin retrains."""
    mega = _fleet(case)
    fused = mega.chunked_engine()
    fused.run()
    staged = mega.chunked_engine()
    staged.torch_pass_a = True
    staged.run()
    assert _same(fused, staged)
    assert staged.resumes == _twin_retrains(mega)


def _twin_retrains(mega) -> int:
    """How many lanes the plain twin retrains mid-chunk."""
    twin = mega.chunked_engine(device="cpu")
    count = [0]
    real = twin.retrain

    def counted(*a):
        count[0] += 1
        return real(*a)

    twin.retrain = counted
    twin.run()
    return count[0]


@pytest.mark.parametrize("case", ["linear_task", "mlp_task"])
def test_gradient_task_stops_as_often_as_the_twin_retrains(cuda, case):
    mega = _fleet(case)
    card = mega.chunked_engine()
    card.run()
    assert card.resumes == _twin_retrains(mega) > 0


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


# ---- the sharded engine on slots of cuda:0 and on two cards ----


def _slots(p: int):
    from p2pfl_tpu_torch.parallel.fleet_mesh import fleet_clients_mesh

    return fleet_clients_mesh(p, devices=["cuda:0"] * p)


def _sharded_fleet(case, **over):
    if case in ("chaos", "byzantine", "churn"):
        return chip_smoke._mf_faults(case, **over)
    return chip_smoke._mf_small(cluster_size=0 if case == "flat" else 32, chunk=48, **{"device": "cuda", **over})


def _same_result(a, b) -> bool:
    return (a.merges, a.regional_merges, a.loss_curve, a.staleness_hist_edge, a.staleness_hist_global,
            a.byz_corrupted, a.duplicates_injected) == (
        b.merges, b.regional_merges, b.loss_curve, b.staleness_hist_edge, b.staleness_hist_global,
        b.byz_corrupted, b.duplicates_injected) and torch.equal(a.params["w"].cpu(), b.params["w"].cpu())


@pytest.mark.parametrize("case", ["flat", "hier", "chaos", "byzantine", "churn"])
@pytest.mark.parametrize("shards", [2, 8])
def test_sharded_slots_equal_one_slot(cuda, case, shards):
    """The sharded engine on ``shards`` slots of ``cuda:0`` (pass A a
    shard, the gather, kernel 10's staged launches) against the one-slot
    engine (one launch, pass A inside): the same results bit for bit, and
    one launch a chunk plus one a resume."""
    ref = _sharded_fleet(case).run()
    _kernels.reset_launches()
    with chip_smoke.sharded_engines() as engines:
        got = _sharded_fleet(case, mesh=_slots(shards)).run()
    torch.cuda.synchronize()
    assert len(engines) == 1 and len(engines[0].blocks) == shards
    assert _kernels.LAUNCHES["fleet_chunk"] == engines[0].n_chunks + engines[0].resumes
    assert ref.merges > 0 and _same_result(ref, got)


def test_sharded_parity_cells(cuda):
    """``chip_smoke``'s part (f): ``bench_async.py``'s 20,000-client parity
    cells on 2 and 8 slots, every check."""
    out = chip_smoke.megafleet_sharded_parity()
    bad = {name: row["checks"] for name, row in out["cells"].items() if not all(row["checks"].values())}
    assert not bad


def test_sharded_on_two_cards_equals_one_card(cuda):
    """``shards=2`` on a card fleet: the first two cards (the gather
    crosses cards), bit-equal to one card."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    ref = _sharded_fleet("hier").run()
    got = _sharded_fleet("hier", shards=2, device=None).run()
    assert _same_result(ref, got)
    fleet = _sharded_fleet("flat", shards=2, device=None)
    assert [str(d) for d in fleet.mesh.devices.flat] == ["cuda:0", "cuda:1"]
    assert _same_result(_sharded_fleet("flat").run(), fleet.run())
