"""The port's sharded megafleet engine on CPU slots.

``MegaFleet(shards=P, device="cpu")`` splits the client rows over P CPU
slots (:class:`~p2pfl_tpu_torch.ops.fleet_kernels.ShardedFleet`): each
shard trains its own lanes of a chunk, the trained rows come back through
one concatenation and a permutation a chunk, and admission stays
replicated. So every counter, the loss curve and the final params must
equal the one-slot chunked engine's bit for bit. The cases are the JAX
package's sharded tests (``tests/test_megafleet_sharded.py``), held
against the port's chunked engine (JAX's sharded engine fails under jax
0.9.0's ``shard_map``), plus a gradient-task fleet, whose corrected
adopters are retrained into their owner's block. Against the JAX
package: the mesh helpers' values and errors, the segment layout bit for
bit, and one sharded run against JAX's chunked engine within the port's
chunked tolerance (``REL``, as ``tests/test_torch_megafleet.py``).
"""

import json

import jax
import numpy as np
import pytest
import torch

from p2pfl_tpu.federation import megafleet as jm
from p2pfl_tpu.parallel import fleet_mesh as jfm
from p2pfl_tpu.settings import Settings as JSettings
from p2pfl_tpu_torch import DeviceUnavailableError
from p2pfl_tpu_torch.communication.faults import ByzantineSpec, FaultPlan, JoinSpec, LeaveSpec
from p2pfl_tpu_torch.federation import megafleet as tm
from p2pfl_tpu_torch.ops import fleet_autotune as ft
from p2pfl_tpu_torch.ops import fleet_kernels as tfk
from p2pfl_tpu_torch.parallel import fleet_clients_mesh, shard_capacity
from p2pfl_tpu_torch.settings import Settings, set_test_settings

SEED = 1234
#: the port against JAX's chunked engine, as a share of the largest value
#: (``tests/test_torch_megafleet.py``'s limit: fp32 folds summed in
#: another order)
REL = 1e-5
CPU = ["cpu"]


@pytest.fixture(autouse=True)
def _env():
    set_test_settings()
    yield
    ft.clear_memory_cache()


def _fleet(n, *, shards=None, chunk=48, cluster_size=0, plan=None, dim=6, **kw):
    """The JAX sharded tests' fleet (``_run``): K ``max(4, n // 32)``, 3
    updates a client, on the CPU."""
    spec = tm.FleetSpec.synth(n, seed=SEED, dim=dim)
    return tm.MegaFleet(spec, k=max(4, n // 32), updates_per_node=3, chunk=chunk, shards=shards,
                        cluster_size=cluster_size, plan=plan, device="cpu", **kw)


def _sharded(n, shards, monkeypatch, **kw):
    """A sharded run that must not fall back to the one-slot engine."""

    def refuse(*a, **k):
        raise AssertionError("the one-slot chunked engine ran in a sharded fleet")

    fleet = _fleet(n, shards=shards, **kw)
    if shards > 1:
        monkeypatch.setattr(fleet, "_run_chunked", refuse)
    return fleet.run()


def _assert_bit_identical(a, b):
    """Every counter exact, the loss curve and the final params bit for bit."""
    for f in ("version", "merges", "regional_merges", "buffered", "stale_dropped", "rate_limited", "unselected",
              "byz_corrupted", "duplicates_injected", "updates_sent", "updates_delivered", "updates_dropped_wire",
              "n_events", "staleness_hist_edge", "staleness_hist_global", "virtual_time", "time_to_target",
              "joined", "left", "failovers", "crashed"):
        assert getattr(a, f) == getattr(b, f), f
    la, lb = np.asarray([x[2] for x in a.loss_curve]), np.asarray([x[2] for x in b.loss_curve])
    assert [x[:2] for x in a.loss_curve] == [x[:2] for x in b.loss_curve]
    assert np.array_equal(la, lb), f"loss diverges by {np.abs(la - lb).max()}"
    assert torch.equal(a.params["w"], b.params["w"])


# ---- the mesh helpers against JAX ----


@pytest.mark.parametrize("n, p", [(1000, 4), (1001, 4), (1, 1), (7, 8), (1_000_000, 8), (40, 3)])
def test_shard_capacity_equals_jax(n, p):
    assert shard_capacity(n, p) == jfm.shard_capacity(n, p)


@pytest.mark.parametrize("n, p", [(0, 4), (4, 0), (-1, 2)])
def test_shard_capacity_errors_equal_jax(n, p):
    with pytest.raises(ValueError):
        jfm.shard_capacity(n, p)
    with pytest.raises(ValueError, match="must both be >= 1"):
        shard_capacity(n, p)


def test_fleet_clients_mesh_against_jax():
    """The ``(clients,)`` axis and its size as JAX's; fewer shards than
    devices take the first ones; more raise (naming the slots of one
    device), as do 0 shards; without a card the default devices raise."""
    want = jfm.fleet_clients_mesh(2)
    got = fleet_clients_mesh(2, devices=CPU * 8)
    assert got.axis_names == want.axis_names == (Settings.MESH_CLIENTS_AXIS,)
    assert got.size == want.size == 2 and got.shape == dict(want.shape)
    assert fleet_clients_mesh(devices=CPU * 3).size == 3
    mixed = fleet_clients_mesh(2, devices=["cpu", "meta", "cpu"])
    assert [d.type for d in mixed.devices.flat] == ["cpu", "meta"]
    with pytest.raises(ValueError, match="exceeds"):
        jfm.fleet_clients_mesh(jax.device_count() + 1)
    with pytest.raises(ValueError, match=r"exceeds the 2 available devices.*\['cuda:0'\] \* 3"):
        fleet_clients_mesh(3, devices=CPU * 2)
    for mod, kw in ((jfm, {}), (None, {"devices": CPU * 2})):
        with pytest.raises(ValueError, match=">= 1"):
            (mod.fleet_clients_mesh if mod else fleet_clients_mesh)(0, **kw)
    if not torch.cuda.is_available():
        with pytest.raises(DeviceUnavailableError):
            fleet_clients_mesh(1)


# ---- the segment layout against JAX, bit for bit ----

LAYOUTS = {
    # name: (clients, chunk, shards, slack, the greedy fallback taken)
    "aligned": (1000, 48, 4, 2.0, False),
    "aligned_2": (1000, 48, 2, 2.0, False),
    "eight_shards_overflow": (1000, 48, 8, 2.0, True),
    "greedy_repeats": (40, 48, 4, 2.0, True),
    "imbalanced_slack_1": (1000, 48, 4, 1.0, True),
}


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_shard_layout_equals_jax(name):
    n, chunk, shards, slack, greedy = LAYOUTS[name]
    jspec = jm.FleetSpec.synth(n, seed=SEED, dim=6)
    tspec = tm.FleetSpec.synth(n, seed=SEED, dim=6)
    jmf = jm.MegaFleet(jspec, k=max(4, n // 32), updates_per_node=3, chunk=chunk)
    tmf = tm.MegaFleet(tspec, k=max(4, n // 32), updates_per_node=3, chunk=chunk, device="cpu")
    jev, tev = jmf._events(jmf._tier_arrays()), tmf._events(tmf._tier_arrays())
    assert np.array_equal(jev["client"], tev["client"])
    ncap = shard_capacity(n, shards)
    cp = max(1, int(np.ceil(slack * chunk / shards)))
    want = jmf._shard_layout(jev["client"], chunk, shards, cp, ncap)
    got = tmf._shard_layout(tev["client"], chunk, shards, cp, ncap)
    for w, g in zip(want, got):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    # the aligned layout is the events in order; the greedy one closes a
    # chunk early (a pad inside the run)
    E = len(tev["client"])
    assert (not np.array_equal(got[0].ravel()[:E], np.arange(E))) == greedy


def test_sharded_grids_address_the_owner_blocks():
    """Each live segment lane points at its event's chronological position
    and at its client's row in the owner's block; dead lanes at the trash
    row; ``invperm`` undoes the segment order."""
    fleet = _fleet(1000, shards=4)
    p = fleet._prepare()
    cfg = p["make_cfg"](48)
    ev = p["ev"]
    events, _ = fleet._sharded_grids(cfg, p["tiers"], ev, p["clients"], p["agg"])
    ncap, S = shard_capacity(1000, 4), events["client"].shape[0]
    cp = events["seg_fwd"].shape[1] // 4
    live = events["seg_live"]
    lane_client = np.take_along_axis(events["client"], events["seg_fwd"].astype(np.int64), axis=1)
    assert np.array_equal(events["seg_loc"][live], lane_client[live] % ncap)
    owner = np.repeat(np.arange(4), cp)[None].repeat(S, 0)
    assert np.array_equal(owner[live], lane_client[live] // ncap)
    assert (events["seg_loc"][~live] == ncap).all()
    back = np.take_along_axis(np.where(live, events["seg_fwd"], -1), events["invperm"].astype(np.int64), axis=1)
    chron = np.broadcast_to(np.arange(events["client"].shape[1]), back.shape)
    assert np.array_equal(back[events["live"]], chron[events["live"]])


# ---- the sharded engine against the chunked engine, bit for bit ----


@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
@pytest.mark.parametrize("cluster_size", [0, 64], ids=["flat", "hier"])
def test_sharded_bit_identical_1k(n_shards, cluster_size, monkeypatch):
    base = _fleet(1000, cluster_size=cluster_size).run()
    got = _sharded(1000, n_shards, monkeypatch, cluster_size=cluster_size)
    assert base.merges > 0 and (cluster_size == 0 or base.regional_merges > 0)
    _assert_bit_identical(base, got)


@pytest.mark.parametrize("n_shards", [2, 8])
def test_sharded_bit_identical_byzantine(n_shards, monkeypatch):
    """sign_flip, scale and noise attackers: the corruption counts and the
    payloads, corrupted on the replicated side after the gather."""
    plan = FaultPlan(seed=3, byzantine={
        "sim-0002": ByzantineSpec(kind="sign_flip"),
        "sim-0010": ByzantineSpec(kind="scale", lam=4.0),
        "sim-0020": ByzantineSpec(kind="noise", noise_std=0.5),
    })
    base = _fleet(600, plan=plan).run()
    assert base.byz_corrupted > 0
    _assert_bit_identical(base, _sharded(600, n_shards, monkeypatch, plan=plan))


@pytest.mark.parametrize("n_shards", [2, 8])
def test_sharded_bit_identical_churn(n_shards, monkeypatch):
    plan = FaultPlan(seed=3, joins={"sim-0599": JoinSpec(at_s=2.0)}, leaves={"sim-0005": LeaveSpec(at_s=1.5)})
    base = _fleet(600, plan=plan).run()
    got = _sharded(600, n_shards, monkeypatch, plan=plan)
    _assert_bit_identical(base, got)
    assert got.joined == base.joined and got.left == base.left


def test_sharded_greedy_fallback(monkeypatch):
    """40 clients, 3 updates each, 48 events a chunk: clients repeat inside
    a chunk, so the greedy segment layout runs, with the same verdicts."""
    base = _fleet(40).run()
    _assert_bit_identical(base, _sharded(40, 4, monkeypatch))


def _grad_fleet(shards=None):
    task = tm.GradTask(kind="linear", d_in=6, n_out=3, batch=4, steps=2, data_seed=5)
    spec = tm.FleetSpec.synth(200, seed=SEED, dim=task.param_dim())
    return tm.MegaFleet(spec, k=4, updates_per_node=4, local_lr=0.3, task=task, chunk=48, shards=shards,
                        device="cpu")


def test_sharded_gradient_task_retrains_on_the_owner_shard(monkeypatch):
    """A gradient-task fleet on 2 shards: the chunked engine's counters,
    curve and params bit for bit. Its chunks mint, so lanes are retrained
    mid-chunk, each into its owner's block alone (the other block keeps
    its bits)."""
    base = _grad_fleet().run()
    eng = _grad_fleet(shards=2).sharded_engine()
    writes = []
    real = eng.retrain

    def spy(s, j, version):
        owner = int(eng.client_host[s, j]) // eng.ncap
        before = [w.clone() for w in eng.blocks]
        out = real(s, j, version)
        changed = [not torch.equal(b, w) for b, w in zip(before, eng.blocks)]
        writes.append((owner, changed))
        return out

    eng.retrain = spy
    out = eng.run()
    assert len(writes) > 0 and {o for o, _ in writes} == {0, 1}
    assert all(changed[1 - o] is False for o, changed in writes)
    dim = eng.cfg.dim
    assert [tuple(w.shape) for w in eng.blocks] == [(eng.ncap + 1, dim + 1)] * 2
    assert int(out["merges"]) == base.merges and int(out["version"]) == base.version
    assert torch.equal(out["G"][base.version], base.params["w"])
    fleet = _grad_fleet(shards=2)
    monkeypatch.setattr(fleet, "_run_chunked", None)
    _assert_bit_identical(base, fleet.run())


def test_sharded_engine_layout_of_the_blocks():
    """Client ``i`` lies at row ``i % ncap`` of block ``i // ncap``: the
    joined blocks are the chunked engine's rows, the trash rows aside."""
    chunked = _fleet(1000).chunked_engine()
    chunked.run()
    sharded = _fleet(1000, shards=8).sharded_engine()
    sharded.run()
    assert len(sharded.blocks) == 8 and sharded.ncap == 125
    assert "w" not in sharded.carry
    assert torch.equal(sharded.client_rows(), chunked.client_rows())
    for p, w in enumerate(sharded.blocks):
        assert torch.equal(w[:125], chunked.carry["w"][125 * p:125 * (p + 1)])


def test_sharded_against_jax_chunked_engine(monkeypatch):
    """1k flat on 2 shards against the JAX package's chunked engine (its
    sharded one is a reference caveat): integers and times exact, losses
    and params within ``REL`` of the largest value."""
    spec = jm.FleetSpec.synth(1000, seed=SEED, dim=6)
    j = jm.MegaFleet(spec, k=1000 // 32, updates_per_node=3, chunk=48, shards=None).run()
    t = _sharded(1000, 2, monkeypatch)
    for f in ("merges", "version", "n_events", "buffered", "stale_dropped", "rate_limited", "staleness_hist_edge",
              "staleness_hist_global", "updates_sent", "virtual_time"):
        assert getattr(j, f) == getattr(t, f), f
    assert [x[:2] for x in j.loss_curve] == [x[:2] for x in t.loss_curve]
    jl, tl = np.asarray([x[2] for x in j.loss_curve]), np.asarray([x[2] for x in t.loss_curve])
    np.testing.assert_allclose(tl, jl, rtol=0, atol=REL * np.abs(jl).max())
    jw = np.asarray(j.params["w"])
    np.testing.assert_allclose(t.params["w"].numpy(), jw, rtol=0, atol=REL * max(np.abs(jw).max(), 1.0))


# ---- seating the shards ----


def test_seating():
    """A CPU fleet's shards are CPU slots; a mesh names the slots (its
    first slot the fleet's device); a shard count or device that
    contradicts the mesh raises; ``shards`` 0 and 1 are one slot."""
    spec = tm.FleetSpec.synth(40, seed=SEED, dim=4)
    fleet = tm.MegaFleet(spec, shards=3, device="cpu")
    assert fleet.mesh.size == 3 and fleet.device == torch.device("cpu")
    assert tm.MegaFleet(spec, shards=1, device="cpu").mesh is None
    mesh = fleet_clients_mesh(2, devices=CPU * 2)
    by_mesh = tm.MegaFleet(spec, mesh=mesh)
    assert by_mesh.shards == 2 and by_mesh.mesh is mesh and by_mesh.device == torch.device("cpu")
    with pytest.raises(ValueError, match="against a mesh"):
        tm.MegaFleet(spec, shards=4, mesh=mesh)
    with pytest.raises(ValueError, match="against a mesh"):
        tm.MegaFleet(spec, mesh=mesh, device="meta")
    with pytest.raises(ValueError, match="one axis"):
        from p2pfl_tpu_torch.parallel import federation_mesh

        tm.MegaFleet(spec, mesh=federation_mesh(2, devices=CPU * 2))
    with pytest.raises(ValueError, match="needs shards > 1"):
        tm.MegaFleet(spec, device="cpu").sharded_engine()
    if torch.cuda.device_count() < 64:
        # a card fleet takes the visible cards and raises past them (here:
        # without a card, the card itself raises)
        with pytest.raises((ValueError, DeviceUnavailableError)):
            tm.MegaFleet(spec, shards=64)


# ---- the chunk autotune keys the shard count ----


def test_autotune_keys_shards_apart(tmp_path):
    """``chunk=0`` on 2 shards measures the sharded engine and caches under
    ``cpu|shards=2|``; one slot measures apart under ``cpu|shards=1|``; a
    fresh process state replays both from disk with no measurement."""
    Settings.FLEET_TUNE_CACHE = JSettings.FLEET_TUNE_CACHE = str(tmp_path / "tune.json")
    ft.clear_memory_cache()
    spec = tm.FleetSpec.synth(400, seed=2, dim=4)
    ran = []

    def fleet(shards):
        m = tm.MegaFleet(spec, k=16, updates_per_node=3, chunk=0, shards=shards, device="cpu")
        for name in ("_run_sharded", "_run_chunked"):
            real = getattr(m, name)
            setattr(m, name, lambda *a, _r=real, _n=name: ran.append(_n) or _r(*a))
        return m

    m2 = fleet(2)
    r2 = m2.run()
    assert set(ran) == {"_run_sharded"} and len(ran) == 2 * len(ft.DEFAULT_CANDIDATES) + 1
    ran.clear()
    m1 = fleet(None)
    m1.run()
    assert set(ran) == {"_run_chunked"}
    raw = json.loads((tmp_path / "tune.json").read_text())
    assert sorted(k.split("|")[1] for k in raw) == ["shards=1", "shards=2"]
    assert all(k.startswith("cpu|") for k in raw)
    ft.clear_memory_cache()
    ran.clear()
    again = fleet(2)
    _assert_bit_identical(r2, again.run())
    assert ran == ["_run_sharded"] and again.chunk == m2.chunk


def test_kernel_table_of_a_sharded_engine_has_no_client_rows():
    """What a sharded engine hands the kernel: the staged mode and no
    client table (the kernel reads no row of one; a sharded run has
    none)."""
    eng = _fleet(1000, shards=2).sharded_engine()
    vals = eng.kernel_values()
    assert vals["staged"] == 1 and vals.get("w") is None
    assert isinstance(eng, tfk.ShardedFleet) and eng.torch_pass_a
