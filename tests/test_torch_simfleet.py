"""``SimulatedAsyncFleet`` in the port against the JAX package's.

The same ``(seed, plan)`` through both engines, the port's on the CPU:
flat, hierarchical (cluster 32), churn (joins, graceful and abrupt leaves,
a root kill), kill-and-restart and Byzantine attackers with the defense on.
The merge count, the minted version sequence, the virtual times of the
merges, the quarantine sequence and the crashed, restarted, joined and left
lists must be JAX's exactly; the loss curve within ``LOSS_RTOL`` (the
buffer folds are fp32 sums in another order; at these sizes they have come
out bit-equal). Then the port alone replays a run bit for bit.
"""

import numpy as np
import pytest
import torch

from p2pfl_tpu.communication import faults as jf
from p2pfl_tpu.federation.simfleet import SimulatedAsyncFleet as JFleet
from p2pfl_tpu.settings import Settings as JSettings
from p2pfl_tpu_torch.communication import faults as tf
from p2pfl_tpu_torch.exceptions import UnsupportedByPortError
from p2pfl_tpu_torch.federation.simfleet import SimulatedAsyncFleet
from p2pfl_tpu_torch.management.logger import logger
from p2pfl_tpu_torch.settings import Settings, set_test_settings

#: relative tolerance of each loss-curve point against JAX's
LOSS_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _env():
    set_test_settings()
    logger.set_level("INFO")
    yield
    Settings.BYZ_SCREEN = JSettings.BYZ_SCREEN = False
    Settings.ASYNC_ROBUST_AGG = JSettings.ASYNC_ROBUST_AGG = "fedavg"


def _addrs(n):
    return [f"sim-{i:04d}" for i in range(n)]


def _chaos(pkg, n):
    return pkg.FaultPlan(
        seed=1905, default=pkg.EdgeFault(drop=0.01, duplicate=0.03, duplicate_delay=0.3),
        slow_nodes={a: 0.5 for a in _addrs(n)[::10]},
        crashes={a: pkg.CrashSpec(stage="AsyncTrainStage", round_no=2) for a in _addrs(n)[5::100]},
    )


def _churn(pkg, n):
    addrs = _addrs(n)
    k = max(2, n // 20)
    leaves = {a: pkg.LeaveSpec(at_s=0.4 + 0.03 * j, graceful=j % 2 == 0)
              for j, a in enumerate(addrs[3::max(1, n // k)][:k])}
    leaves[addrs[0]] = pkg.LeaveSpec(at_s=0.7, graceful=False)  # the root, abruptly
    return pkg.FaultPlan(seed=1905, default=pkg.EdgeFault(drop=0.01), leaves=leaves,
                         joins={f"sim-j{j:03d}": pkg.JoinSpec(at_s=0.6 + 0.05 * j) for j in range(k)})


def _restart(pkg, n):
    return pkg.FaultPlan(seed=1905, restarts={
        _addrs(n)[i]: pkg.RestartSpec(round_no=1, resume_after_s=ra) for i, ra in ((3, 2.0), (11, 0.2), (27, 3.0))})


def _byzantine(pkg, n):
    return pkg.FaultPlan(seed=1905, default=pkg.EdgeFault(drop=0.01), byzantine={
        a: pkg.ByzantineSpec(kind=("sign_flip", "scale", "equivocate")[j % 3]) for j, a in enumerate(_addrs(n)[::10])})


SCENARIOS = {
    # name: (nodes, cluster, plan factory, fleet kwargs)
    "flat": (300, 0, _chaos, dict(slow_frac=0.1, slow_factor=10.0, local_lr=0.7)),
    "hier": (1000, 32, _chaos, dict(slow_frac=0.1, slow_factor=10.0, local_lr=0.7)),
    "churn": (300, 32, _churn, dict(slow_frac=0.1, slow_factor=8.0)),
    "restart": (200, 16, _restart, dict(evict_delay=0.5)),
    "byzantine": (200, 16, _byzantine, dict(k=4, target_loss=0.5)),
}


def _run(cls, pkg, name, device=None):
    n, cluster, plan, kw = SCENARIOS[name]
    extra = {} if device is None else {"device": device}
    return cls(n, seed=11, cluster_size=cluster, updates_per_node=5, plan=plan(pkg, n), **kw, **extra).run()


def _same_run(a, b) -> None:
    """Exact equality of everything but the loss values; those within
    LOSS_RTOL; the final params likewise."""
    assert a.merges == b.merges and a.version == b.version and a.merges > 0
    assert [(t, v) for t, v, _ in a.loss_curve] == [(t, v) for t, v, _ in b.loss_curve]
    np.testing.assert_allclose([l for *_, l in a.loss_curve], [l for *_, l in b.loss_curve], rtol=LOSS_RTOL)
    for f in ("crashed", "restarted", "joined", "left", "quarantined", "failovers", "updates_sent",
              "updates_delivered", "updates_dropped_wire", "duplicates_injected", "byz_corrupted",
              "screen_rejects", "virtual_time"):
        assert getattr(a, f) == getattr(b, f), f
    np.testing.assert_allclose(np.asarray(a.params["w"]), b.params["w"].cpu().numpy(), rtol=LOSS_RTOL, atol=1e-6)


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_simfleet_matches_jax(name):
    if name == "byzantine":
        Settings.BYZ_SCREEN = JSettings.BYZ_SCREEN = True
        Settings.ASYNC_ROBUST_AGG = JSettings.ASYNC_ROBUST_AGG = "trimmed-mean"
    want = _run(JFleet, jf, name)
    got = _run(SimulatedAsyncFleet, tf, name, device="cpu")
    _same_run(want, got)
    versions = [v for _t, v, _l in got.loss_curve]
    assert versions == sorted(set(versions))  # minted strictly monotone, failovers included
    if name == "churn":
        assert got.joined and got.left and got.failovers >= 1
    if name == "restart":
        assert sorted(got.restarted) == ["sim-0003", "sim-0011", "sim-0027"]
    if name == "byzantine":
        assert got.quarantined and got.screen_rejects > 0 and got.byz_corrupted > 0


def test_simfleet_same_seed_replays_bit_for_bit_in_the_port():
    Settings.BYZ_SCREEN = True
    Settings.ASYNC_ROBUST_AGG = "median"
    a, b = (_run(SimulatedAsyncFleet, tf, "byzantine", device="cpu") for _ in range(2))
    assert a.loss_curve == b.loss_curve and a.quarantined == b.quarantined
    assert torch.equal(a.params["w"], b.params["w"])
    n, cluster, plan, kw = SCENARIOS["byzantine"]
    c = SimulatedAsyncFleet(n, seed=12, cluster_size=cluster, updates_per_node=5, plan=plan(tf, n),
                            device="cpu", **kw).run()
    assert not torch.equal(a.params["w"], c.params["w"])  # another seed diverges


def test_simfleet_defaults_to_the_card_and_export_spec_waits_for_a8():
    """The fleet defaults to the card; ``export_spec`` (the megafleet
    engine's population hook, ROADMAP A8) equals JAX's export array for
    array, pending joiners and slow nodes included, and refuses what JAX's
    refuses."""
    if not torch.cuda.is_available():
        from p2pfl_tpu_torch import DeviceUnavailableError

        with pytest.raises(DeviceUnavailableError):
            SimulatedAsyncFleet(8)
    fleet = SimulatedAsyncFleet(8, device="cpu")
    assert fleet.result.params["w"].device.type == "cpu"
    n, cluster, plan, kw = SCENARIOS["flat"]
    jfleet = JFleet(n, seed=11, cluster_size=cluster, updates_per_node=5, plan=plan(jf, n), **kw)
    tfleet = SimulatedAsyncFleet(n, seed=11, cluster_size=cluster, updates_per_node=5, plan=plan(tf, n),
                                 device="cpu", **kw)
    want, got = jfleet.export_spec(extra=4), tfleet.export_spec(extra=4)
    assert want.keys() == got.keys()
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert v.dtype == got[k].dtype and np.array_equal(v, got[k]), k
        else:
            assert v == got[k], k
    assert got["durations"].shape == (n + 4,) and got["slow"].max() == 0.5
    with pytest.raises(ValueError, match="no vectorized twin"):
        SimulatedAsyncFleet(8, train_fn=lambda i, p, r: p, device="cpu").export_spec()
    with pytest.raises(ValueError, match="4-digit address"):
        SimulatedAsyncFleet(10_001, cluster_size=32, device="cpu").export_spec()
    assert not issubclass(ValueError, UnsupportedByPortError)
