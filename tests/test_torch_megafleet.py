"""The megafleet engine in the port against the JAX package's, on the CPU.

The same population, plan and knobs through JAX's ``MegaFleet`` and the
port's (``device="cpu"``: the chunk step's plain twin and the per-event
engine's torch rows):

- the host arrays (tiers, aggregate grids, sorted events, chunk layout,
  regional chains, the chunk grids) equal JAX's bit for bit;
- merge counts, version sequences, mint times, staleness histograms and
  the fault counters equal JAX's exactly; losses and params within
  ``REL`` of the largest value (fp32 folds summed in another order; the
  staleness weight ``1/(1+τ)^α`` may differ from XLA's by an ulp);
- the port's chunked engine is bit-identical to its own per-event engine;
- the gradient task's threefry bits equal ``jax.random``'s, its normals
  within ``NORMAL_ULPS`` ulps (XLA's erfinv polynomial on another
  ``log1p``), its local round within ``GRAD_TOL``.
"""

import numpy as np
import pytest
import torch

from p2pfl_tpu.communication import faults as jf
from p2pfl_tpu.federation import megafleet as jm
from p2pfl_tpu.ops import fleet_kernels as jfk
from p2pfl_tpu.settings import Settings as JSettings
from p2pfl_tpu_torch.communication import faults as tf
from p2pfl_tpu_torch.exceptions import UnsupportedByPortError
from p2pfl_tpu_torch.federation import megafleet as tm
from p2pfl_tpu_torch.federation.simfleet import SimulatedAsyncFleet
from p2pfl_tpu_torch.ops import fleet_kernels as tfk
from p2pfl_tpu_torch.settings import Settings, set_test_settings

SEED = 1905
#: losses and params against JAX, as a share of the largest |value|
REL = 1e-5
#: jax.random.normal against the port's, in fp32 ulps of the value
NORMAL_ULPS = 4
#: the gradient task's local round against JAX's (fp32 matmuls and
#: softmax in another order)
GRAD_TOL = 1e-5


@pytest.fixture(autouse=True)
def _env():
    set_test_settings()
    yield
    Settings.ASYNC_ROBUST_AGG = JSettings.ASYNC_ROBUST_AGG = "fedavg"


def _plans(pkg, n):
    """Named fault plans, built from either package's faults module."""
    return {
        "none": None,
        "chaos": pkg.FaultPlan(seed=SEED, default=pkg.EdgeFault(drop=0.05, jitter=0.002, duplicate=0.2),
                               slow_nodes={f"sim-{i:04d}": 0.3 for i in range(1, n, 37)},
                               crashes={"sim-0007": pkg.CrashSpec(stage="AsyncTrainStage", round_no=2)}),
        "byzantine": pkg.FaultPlan(seed=SEED, byzantine={
            f"sim-{i:04d}": pkg.ByzantineSpec(kind=("sign_flip", "scale", "noise")[i % 3], lam=5.0, noise_std=2.0)
            for i in range(0, n, 16)}),
        "churn": pkg.FaultPlan(seed=SEED, joins={f"sim-{i:04d}": pkg.JoinSpec(at_s=1.5 + 0.1 * (i - n + 6))
                                                 for i in range(n - 6, n)},
                               leaves={"sim-0005": pkg.LeaveSpec(at_s=2.5, graceful=True),
                                       "sim-0033": pkg.LeaveSpec(at_s=3.0, graceful=False)}),
        "root_leave": pkg.FaultPlan(seed=SEED, leaves={"sim-0000": pkg.LeaveSpec(at_s=2.2, graceful=True)}),
    }


def _fleets(n, plan, dim=8, **kw):
    """(JAX fleet, port fleet) on one synthetic population."""
    jspec = jm.FleetSpec.synth(n, seed=SEED, dim=dim, slow_frac=0.1)
    tspec = tm.FleetSpec.synth(n, seed=SEED, dim=dim, slow_frac=0.1)
    for f in ("durations", "num_samples", "targets", "slow", "init"):
        assert np.array_equal(getattr(jspec, f), getattr(tspec, f))
    return (jm.MegaFleet(jspec, plan=_plans(jf, n)[plan], **kw),
            tm.MegaFleet(tspec, plan=_plans(tf, n)[plan], device="cpu", **kw))


def _equal(a, b, where=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _equal(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (tuple, list)) and a and isinstance(a[0], np.ndarray):
        assert len(a) == len(b), where
        for x, y in zip(a, b):
            _equal(x, y, where)
    elif isinstance(a, np.ndarray):
        assert a.dtype == np.asarray(b).dtype and np.array_equal(a, b), where
    else:
        assert a == b, where


HOST_CASES = {
    "flat": (300, 0, "none", {}),
    "hier_chaos": (300, 16, "chaos", dict(k=4, pace_window=0.4, select_frac=0.8)),
    "hier_byzantine": (300, 16, "byzantine", dict(k=4)),
    "hier_churn": (300, 32, "churn", {}),
}


@pytest.mark.parametrize("name", list(HOST_CASES))
def test_host_arrays_equal_jax_bit_for_bit(name):
    n, cluster, plan, kw = HOST_CASES[name]
    jmf, tmf = _fleets(n, plan, cluster_size=cluster, **kw)
    jt, tt = jmf._tier_arrays(), tmf._tier_arrays()
    _equal(jt, tt, "tiers")
    jev, tev = jmf._events(jt), tmf._events(tt)
    _equal(jev, tev, "events")
    stride = 7
    _equal(jmf._agg_grids(jt, stride), tmf._agg_grids(tt, stride), "agg")
    for C in (7, 48):
        rows = jmf._chunk_layout(jev["client"], C)
        _equal(rows, tmf._chunk_layout(tev["client"], C), "layout")
        if cluster:
            r_e = jt["regional_of"][jev["client"]]
            R = jt["k_reg"].shape[1]
            _equal(jm.MegaFleet._chain_cols(rows, r_e, R), tm.MegaFleet._chain_cols(rows, r_e, R), "chains")
    # the grids the engines read: JAX's jnp arrays against the port's numpy
    import jax.numpy as jnp

    jp, tp = jmf, tmf._prepare()
    cfg = tp["make_cfg"](48)
    rows = tmf._chunk_layout(tev["client"], 48)
    jclients, tclients = {}, dict(tp["clients"])
    jagg = jmf._agg_grids(jt, cfg.agg_key_stride)
    jcfg = jfk.FleetConfig(unroll=1, **cfg._asdict())  # the port's config is JAX's less its scan unroll
    jgrid, jreg = jp._chunk_grids(jfk, jnp, jcfg, jt, jev, jclients, jagg, rows)
    tgrid, treg = tmf._chunk_grids(cfg, tt, {k: v for k, v in tev.items() if not k.startswith("_")}, tclients,
                                   tp["agg"], rows)
    for k, v in jgrid.items():
        assert np.array_equal(np.asarray(v), tgrid[k]), k
    for k, v in jreg.items():
        # JAX pads one trash row the port does not need
        assert np.array_equal(np.asarray(v)[: treg[k].shape[0]], treg[k]), k
    if "noise" in jclients:
        assert np.array_equal(np.asarray(jclients["noise"]), tclients["noise"])


def test_staleness_weights_match_jax_to_an_ulp():
    taus = np.arange(-3, 40, dtype=np.int32)
    for alpha in (0.0, 0.5, 1.0, 2.0, 0.3):
        got = tfk.staleness_weight_arr(torch.from_numpy(taus), alpha).numpy()
        want = np.asarray(jfk.staleness_weight_arr(taus, alpha))
        ulps = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32).astype(np.int64))
        assert ulps.max() <= 1, alpha
    cfg = tfk.FleetConfig(hier=False, n_clients=1, dim=1, n_regionals=1, k_global=1, k_reg_max=1, v_cap=2,
                          alpha=0.5, server_lr=1.0, local_lr=0.5, max_staleness=16, rate_gap_reg=0.0,
                          rate_gap_glob=0.0, hist_bins=18, agg_key_stride=2)
    assert torch.equal(tfk.weight_table(cfg), tfk.staleness_weight_arr(torch.arange(18), 0.5))


def _window(k, dim, n_live, seed, keys_hi=None):
    rng = np.random.default_rng(seed)
    rows = rng.normal(size=(k, dim)).astype(np.float32)
    w = np.zeros(k, np.float32)
    w[:n_live] = rng.uniform(0.2, 3.0, n_live).astype(np.float32)
    lo = np.full(k, tfk.PAD_KEY, np.int32)
    hi = np.full(k, tfk.PAD_KEY, np.int32)
    perm = rng.permutation(n_live)
    lo[:n_live] = 1 + perm % 4
    hi[:n_live] = (perm // 4 if keys_hi is None else keys_hi[:n_live])
    prev = rng.normal(size=dim).astype(np.float32)
    return rows, w, lo, hi, prev


@pytest.mark.parametrize("kind", ["fedavg", "trimmed-mean", "median"])
@pytest.mark.parametrize("n_live", [1, 5, 8])
def test_fold_window_matches_jax(kind, n_live):
    """Padded windows (8 slots, ``n_live`` filled, unsorted keys), merged
    at server lr 0.7: within ``REL`` of the largest value (sums in another
    order; XLA may fuse the merge's multiply-add)."""
    rows, w, lo, hi, prev = _window(8, 6, n_live, seed=n_live)
    want = np.asarray(jfk.fold_window(rows, w, lo, prev, 0.7, kind=kind, trim=1, keys_hi=hi))
    got = tfk.fold_window(*(torch.from_numpy(x) for x in (rows, w, lo)), torch.from_numpy(prev), 0.7,
                          kind=kind, trim=1, keys_hi=torch.from_numpy(hi)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=REL * np.abs(want).max())
    if kind == "median":
        # the median itself is bit-equal (the merge may round once more in XLA)
        args = [torch.from_numpy(x) for x in (rows, w, lo, prev)]
        got = tfk.fold_window(*args, 1.0, kind=kind, keys_hi=torch.from_numpy(hi)).numpy()
        np.testing.assert_array_equal(got, np.asarray(jfk.fold_window(rows, w, lo, prev, 1.0, kind=kind, keys_hi=hi)))


def test_fold_key_two_word_order_at_int32_boundary():
    """Origins deep in the range where a product key ``i·(M+1)+m`` would
    wrap int32: the two-word key folds in the ``(origin, seq)`` tuple
    order, bit-equal to a fold by rank-compressed keys, and JAX's fold."""
    his = np.asarray([2 ** 31 - 2, 2 ** 30 + 5, 2 ** 31 - 2, 2 ** 30 + 5, 2 ** 29], np.int64)
    los = np.asarray([3, 1, 1, 2, 4], np.int64)
    rng = np.random.default_rng(3)
    rows = rng.normal(size=(5, 4)).astype(np.float32)
    w = rng.uniform(1, 2, size=5).astype(np.float32)
    prev = np.zeros(4, np.float32)
    hi32 = (his - 2 ** 31).astype(np.int32)
    got = tfk.fold_window(torch.from_numpy(rows), torch.from_numpy(w), torch.from_numpy(los.astype(np.int32)),
                          torch.from_numpy(prev), 0.7, keys_hi=torch.from_numpy(hi32))
    order = sorted(range(5), key=lambda j: (his[j], los[j]))
    ranks = np.empty(5, np.int32)
    ranks[order] = np.arange(5, dtype=np.int32)
    ref = tfk.fold_window(torch.from_numpy(rows), torch.from_numpy(w), torch.from_numpy(ranks),
                          torch.from_numpy(prev), 0.7)
    assert torch.equal(got, ref)
    want = np.asarray(jfk.fold_window(rows, w, los.astype(np.int32), prev, 0.7, keys_hi=hi32))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=REL * np.abs(want).max())


def _same_run(j, t, loss_rel=REL):
    """Integers exact (merges, versions, mint times, histograms, fault
    counters); losses and params within ``loss_rel`` of the largest."""
    for f in ("merges", "regional_merges", "version", "n_events", "buffered", "stale_dropped", "rate_limited",
              "unselected", "updates_sent", "updates_delivered", "updates_dropped_wire", "duplicates_injected",
              "byz_corrupted", "staleness_hist_edge", "staleness_hist_global", "crashed", "joined", "left",
              "failovers", "virtual_time", "time_to_target"):
        assert getattr(j, f) == getattr(t, f), f
    assert [x[:2] for x in j.loss_curve] == [x[:2] for x in t.loss_curve]
    jl, tl = np.asarray([x[2] for x in j.loss_curve]), np.asarray([x[2] for x in t.loss_curve])
    np.testing.assert_allclose(tl, jl, rtol=0, atol=loss_rel * max(np.abs(jl).max(), 1e-9))
    jw = np.asarray(j.params["w"])
    np.testing.assert_allclose(t.params["w"].numpy(), jw, rtol=0, atol=loss_rel * max(np.abs(jw).max(), 1.0))


ENGINE_CASES = {
    # name: (clients, cluster, plan, knobs)
    "per_event_flat": (500, 0, "none", dict(k=8, chunk=1)),
    "chunked_flat": (500, 0, "none", dict(k=8, chunk=48)),
    "per_event_hier": (500, 32, "none", dict(k=8, chunk=1)),
    "chunked_hier": (500, 32, "none", dict(k=8, chunk=48)),
    "chunked_hier_chaos_knobs": (300, 16, "chaos", dict(k=4, pace_window=0.4, select_frac=0.8,
                                                          rate_limit_regional=0.02, rate_limit_global=0.01)),
    "byzantine_flat": (300, 0, "byzantine", dict(k=8)),
    "byzantine_hier_aggregate_seam": (200, 25, "byzantine", dict(k=4)),
    "churn_hier": (300, 32, "churn", dict()),
    "churn_root_failover": (200, 25, "root_leave", dict(k=4)),
}


@pytest.mark.parametrize("name", list(ENGINE_CASES))
def test_engines_match_jax(name):
    n, cluster, plan, kw = ENGINE_CASES[name]
    jmf, tmf = _fleets(n, plan, cluster_size=cluster, updates_per_node=4, local_lr=0.7, **kw)
    t = tmf.run()
    _same_run(jmf.run(), t)
    if name == "churn_root_failover":
        assert t.failovers == 1 and t.left == ["sim-0000"]


@pytest.mark.parametrize("fold", ["trimmed-mean", "median"])
def test_robust_folds_under_attack_match_jax(fold):
    """A 10 % scale-attacker population, the window folded by the rank
    rules (flat, 300 clients): JAX's counts exactly, losses within REL."""
    byz = {f"sim-{i:04d}": dict(kind="scale", lam=50.0) for i in range(0, 300, 10)}
    plans = [pkg.FaultPlan(seed=SEED, byzantine={a: pkg.ByzantineSpec(**s) for a, s in byz.items()})
             for pkg in (jf, tf)]
    specs = [pkg.FleetSpec.synth(300, seed=SEED, dim=8) for pkg in (jm, tm)]
    j = jm.MegaFleet(specs[0], k=8, local_lr=0.7, plan=plans[0], fold=fold).run()
    t = tm.MegaFleet(specs[1], k=8, local_lr=0.7, plan=plans[1], fold=fold, device="cpu").run()
    _same_run(j, t)
    assert t.byz_corrupted > 0


def test_duplicates_are_counted_no_ops():
    """A duplicate plan moves no result of the port (the version vector
    drops every replay) and counts JAX's injections at both seams."""
    plan = (jf.FaultPlan(seed=SEED, default=jf.EdgeFault(duplicate=0.5)),
            tf.FaultPlan(seed=SEED, default=tf.EdgeFault(duplicate=0.5)))
    spec = tm.FleetSpec.synth(300, seed=SEED, dim=8)
    base = tm.MegaFleet(spec, cluster_size=16, k=4, local_lr=0.7, device="cpu").run()
    dup = tm.MegaFleet(spec, cluster_size=16, k=4, local_lr=0.7, plan=plan[1], device="cpu").run()
    want = jm.MegaFleet(jm.FleetSpec.synth(300, seed=SEED, dim=8), cluster_size=16, k=4, local_lr=0.7,
                        plan=plan[0]).run()
    assert dup.duplicates_injected == want.duplicates_injected > 0
    assert dup.merges == base.merges and dup.loss_curve == base.loss_curve
    assert torch.equal(dup.params["w"], base.params["w"])


@pytest.mark.parametrize("cluster", [0, 32])
def test_chunked_engine_bit_identical_to_per_event(cluster):
    """The chunked engine (pass A batched, the twin's admission, the
    in-chunk retraining of adopters) changes nothing: chunks that do and do
    not divide the event count give the per-event engine's run bit for bit."""
    spec = tm.FleetSpec.synth(500, seed=SEED, dim=8)

    def run(chunk):
        return tm.MegaFleet(spec, cluster_size=cluster, k=8, updates_per_node=4, local_lr=0.7, chunk=chunk,
                            device="cpu").run()

    ref = run(1)
    for chunk in (7, 48, 256):
        got = run(chunk)
        assert got.merges == ref.merges and got.regional_merges == ref.regional_merges
        assert got.loss_curve == ref.loss_curve
        assert torch.equal(got.params["w"], ref.params["w"])


@pytest.mark.parametrize("cluster", [0, 32])
def test_port_megafleet_pairs_with_the_port_heap_fleet(cluster):
    """The JAX tests' ``_pair`` inside the port: ``SimulatedAsyncFleet``
    and ``MegaFleet`` on its exported population. Merges and the version
    sequence exact; flat mint times within 1e-4 and losses within 1e-5 of
    the largest; hier losses within 0.15 of the largest (an aggregate is
    offered at its regional's flush) and the final loss within 1e-2."""
    n = 300 if cluster == 0 else 1000
    fleet = SimulatedAsyncFleet(n, seed=SEED, cluster_size=cluster, updates_per_node=4, slow_frac=0.1,
                                local_lr=0.7, device="cpu")
    spec = tm.FleetSpec.from_sim(fleet)
    assert spec.link_delay == fleet.link_delay
    heap = fleet.run()
    mega = tm.MegaFleet(spec, cluster_size=cluster, updates_per_node=4, local_lr=0.7, device="cpu").run()
    assert mega.merges == heap.merges > 0
    assert [x[1] for x in mega.loss_curve] == [x[1] for x in heap.loss_curve]
    hl = np.asarray([x[2] for x in heap.loss_curve])
    ml = np.asarray([x[2] for x in mega.loss_curve])
    if cluster == 0:
        np.testing.assert_allclose([x[0] for x in mega.loss_curve], [x[0] for x in heap.loss_curve], atol=1e-4)
        np.testing.assert_allclose(ml, hl, rtol=0, atol=hl.max() * 1e-5)
        np.testing.assert_allclose(mega.params["w"].numpy(), heap.params["w"].numpy(), rtol=0, atol=1e-5)
    else:
        np.testing.assert_allclose(ml, hl, rtol=0, atol=hl.max() * 0.15)
        assert abs(mega.final_loss() - heap.final_loss()) <= 1e-2 * heap.final_loss()


def test_from_sim_matches_jax():
    """``FleetSpec.from_sim`` of the two packages' heap fleets (pending
    joiners included) are equal array for array."""
    fleets = [cls(40, seed=SEED, cluster_size=8, updates_per_node=2, slow_frac=0.25, plan=pkg.FaultPlan(
        seed=SEED, slow_nodes={"sim-0003": 0.5}), **kw)
        for cls, pkg, kw in ((__import__("p2pfl_tpu.federation.simfleet", fromlist=["x"]).SimulatedAsyncFleet,
                              jf, {}), (SimulatedAsyncFleet, tf, {"device": "cpu"}))]
    j, t = (mod.FleetSpec.from_sim(f, extra=3) for mod, f in zip((jm, tm), fleets))
    for f in ("durations", "num_samples", "targets", "slow", "init"):
        a, b = getattr(j, f), getattr(t, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert (j.seed, j.link_delay, j.n) == (t.seed, t.link_delay, 43)


def test_refusals():
    """What the JAX engine refuses the port refuses too, and the sharded
    engine raises citing ROADMAP item 5."""
    spec = tm.FleetSpec.synth(40, seed=SEED, dim=4)
    with pytest.raises(UnsupportedByPortError, match="item 5"):
        tm.MegaFleet(spec, shards=2, device="cpu")
    with pytest.raises(ValueError, match="per-edge"):
        tm.MegaFleet(spec, plan=tf.FaultPlan(seed=SEED, edges={("a", "b"): tf.EdgeFault(drop=1.0)}), device="cpu")
    with pytest.raises(ValueError, match="heap engine"):
        tm.MegaFleet(spec, plan=tf.FaultPlan(seed=SEED, byzantine={"sim-0002": tf.ByzantineSpec(kind="equivocate")}),
                     device="cpu")
    churn = dict(joins={"sim-0039": tf.JoinSpec(at_s=3.0)})
    with pytest.raises(ValueError, match="heap engine"):
        tm.MegaFleet(spec, plan=tf.FaultPlan(seed=SEED, **churn), fold="median", device="cpu")
    with pytest.raises(ValueError, match="heap engine"):
        tm.MegaFleet(spec, fold="krum-screen", device="cpu")
    with pytest.raises(ValueError, match="param"):
        tm.MegaFleet(spec, task=tm.GradTask(kind="linear", d_in=6, n_out=3), device="cpu")
    if not torch.cuda.is_available():
        from p2pfl_tpu_torch import DeviceUnavailableError

        with pytest.raises(DeviceUnavailableError):
            tm.MegaFleet(spec)


# ---- the gradient task ----


def test_threefry_fold_in_and_bits_equal_jax():
    import jax

    for seed in (0, 5, 2 ** 31 - 1):
        root = jax.random.PRNGKey(seed)
        key = tfk.prng_key(seed)
        assert [int(x) for x in key] == [int(x) for x in jax.random.key_data(root)]
        for i, m in ((0, 1), (7, 3), (123456, 4), (2 ** 31 - 2, 1)):
            want = jax.random.fold_in(jax.random.fold_in(root, i), m)
            got = tfk.fold_in(tfk.fold_in(key, i), m)
            assert [int(x) for x in got] == [int(x) for x in jax.random.key_data(want)]
            bits = tfk.random_bits(got, 96).numpy()
            assert np.array_equal(bits.astype(np.uint32), np.asarray(jax.random.bits(want, (96,))))


def test_normal_equals_jax_to_a_few_ulps():
    import jax

    key = jax.random.fold_in(jax.random.PRNGKey(5), 3)
    want = np.asarray(jax.random.normal(key, (20000,), np.float32))
    got = tfk.normal(tfk.fold_in(tfk.prng_key(5), 3), 20000).numpy()
    ulps = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32).astype(np.int64))
    assert ulps.max() <= NORMAL_ULPS
    assert (ulps == 0).mean() > 0.5


@pytest.mark.parametrize("kind", ["linear", "mlp"])
def test_gen_batch_and_train_one_match_jax(kind):
    import jax.numpy as jnp

    hidden = 5 if kind == "mlp" else 0
    args = (kind, 6, 3, hidden, 4, 3, 0.5, 5)
    jgen, jtrain, _ = jfk.make_grad_fns(*args)
    tgen, ttrain, tvec = tfk.make_grad_fns(*args)
    task = tm.GradTask(kind=kind, d_in=6, n_out=3, hidden=hidden, batch=4, steps=3, data_seed=5)
    mu, tw, tb, _, _ = task.arrays(4)
    flat0 = np.random.default_rng(11).normal(size=task.param_dim()).astype(np.float32)
    outs = []
    for i, m in ((0, 1), (3, 2)):
        jx, jy = jgen(i, m, jnp.asarray(mu[i]), jnp.asarray(tw), jnp.asarray(tb))
        tx, ty = tgen(i, m, torch.from_numpy(mu[i]), torch.from_numpy(tw), torch.from_numpy(tb))
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0, atol=GRAD_TOL)
        assert np.array_equal(ty.numpy(), np.asarray(jy))
        want = np.asarray(jtrain(jnp.asarray(flat0), jx, jy))
        got = ttrain(torch.from_numpy(flat0), tx, ty).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=GRAD_TOL)
        outs.append(got)
    # the lane-batched round equals the one-lane rounds
    lanes = tvec(torch.from_numpy(np.stack([flat0, flat0])), torch.tensor([0, 3]), torch.tensor([1, 2]),
                 torch.from_numpy(mu[[0, 3]]), torch.from_numpy(tw), torch.from_numpy(tb))
    np.testing.assert_allclose(lanes.numpy(), np.stack(outs), rtol=0, atol=1e-6)


def test_grad_task_single_client_chunked_trajectory():
    """One client, K 1, server lr 1, α 0: every mint is the client's next
    local round, so the chunked engine follows the train_one chain on the
    counter-keyed batches (round m == the fold key's key_lo)."""
    task = tm.GradTask(kind="linear", d_in=6, n_out=3, batch=4, steps=3, data_seed=5)
    spec = tm.FleetSpec.synth(1, seed=3, dim=task.param_dim())
    res = tm.MegaFleet(spec, cluster_size=0, k=1, updates_per_node=4, alpha=0.0, server_lr=1.0, task=task,
                       link_delay=0.0, chunk=48, device="cpu").run()
    assert res.version == 4
    gen, train, _ = tfk.make_grad_fns("linear", 6, 3, 0, 4, 3, 0.5, data_seed=5)
    mu, tw, tb, _, _ = task.arrays(1)
    p = torch.zeros(task.param_dim())
    for m in range(1, 5):
        xs, ys = gen(0, m, torch.from_numpy(mu[0]), torch.from_numpy(tw), torch.from_numpy(tb))
        p = train(p, xs, ys)
    np.testing.assert_allclose(res.params["w"].numpy(), p.numpy(), rtol=0, atol=1e-6)


def test_grad_task_mlp_fleet_follows_jax():
    """The mlp task through the chunked engine: JAX's merges and versions
    exactly, its eval-set loss curve within ``GRAD_TOL`` (JAX's own
    "learns" test fails on jax 0.9.0, ROADMAP Queue C: this holds the
    port to JAX's trajectory, not to learning)."""
    task_args = dict(kind="mlp", d_in=6, n_out=3, hidden=5, batch=4, steps=2, data_seed=9)
    j = jm.MegaFleet(jm.FleetSpec.synth(40, seed=3, dim=jm.GradTask(**task_args).param_dim()), k=4,
                     task=jm.GradTask(**task_args), local_lr=0.7).run()
    t = tm.MegaFleet(tm.FleetSpec.synth(40, seed=3, dim=tm.GradTask(**task_args).param_dim()), k=4,
                     task=tm.GradTask(**task_args), local_lr=0.7, device="cpu").run()
    assert t.merges == j.merges > 0 and [x[:2] for x in t.loss_curve] == [x[:2] for x in j.loss_curve]
    np.testing.assert_allclose([x[2] for x in t.loss_curve], [x[2] for x in j.loss_curve], rtol=0, atol=GRAD_TOL)
