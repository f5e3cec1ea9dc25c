"""The async buffer's merge programs and the Byzantine screen, port against JAX.

``buffered_robust_merge`` for every ``ASYNC_ROBUST_AGG`` kind,
``krum_screen_merge``, ``screen_stats`` and ``server_merge`` on the same
stacked inputs (made from a seed with numpy) agree with the JAX programs
within 1e-6 relative L2 (fp32 folds summed in another order: a few ulps).
Then the stateful layers: ``BufferedAggregator`` fed the same offers
(duplicates, stale drops, K repairs) flushes what JAX's flushes — versions,
contributors, staleness and params — and ``ByzantineDefense`` admits,
suspects and quarantines as JAX's does. Within the port a flush is
independent of arrival order bit for bit.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2pfl_tpu.federation.buffer import BufferedAggregator as JBuffer
from p2pfl_tpu.federation.defense import ByzantineDefense as JDefense
from p2pfl_tpu.learning.weights import ModelUpdate as JUpdate
from p2pfl_tpu.ops import aggregation as ja
from p2pfl_tpu.settings import Settings as JSettings
from p2pfl_tpu_torch.federation.buffer import BufferedAggregator
from p2pfl_tpu_torch.federation.defense import ByzantineDefense
from p2pfl_tpu_torch.learning.weights import ModelUpdate
from p2pfl_tpu_torch.management.logger import logger
from p2pfl_tpu_torch.ops import aggregation as ta
from p2pfl_tpu_torch.settings import Settings, set_test_settings

REL_L2 = 1e-6
KINDS = ("fedavg", "trimmed-mean", "median", "krum-screen")
SHAPES = {"dense/kernel": (7, 5), "dense/bias": (5,), "out": (3,)}


@pytest.fixture(autouse=True)
def _env():
    set_test_settings()
    logger.set_level("INFO")
    yield
    Settings.BYZ_SCREEN = JSettings.BYZ_SCREEN = False
    Settings.ASYNC_ROBUST_AGG = JSettings.ASYNC_ROBUST_AGG = "fedavg"
    Settings.BYZ_SUSPICION_BETA = JSettings.BYZ_SUSPICION_BETA = 0.5


def _flat(tree) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update({f"{k}/{kk}": vv for kk, vv in _flat(v).items()})
        else:
            out[k] = np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor) else v, np.float64)
    return out


def _tree(flat: dict, torch_leaves: bool) -> dict:
    out: dict = {}
    for path, a in flat.items():
        node = out
        *parents, last = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = torch.from_numpy(a.copy()) if torch_leaves else jnp.asarray(a)
    return out


def _stack(seed: int, n: int, outlier: bool = False) -> dict:
    rng = np.random.default_rng(seed)
    flat = {k: rng.normal(size=(n, *s)).astype(np.float32) for k, s in SHAPES.items()}
    if outlier:
        for a in flat.values():
            a[n // 2] *= -25.0
    return flat


def _rel(a, b) -> float:
    fa, fb = _flat(a), _flat(b)
    assert fa.keys() == fb.keys()
    num = sum(((fa[k] - fb[k]) ** 2).sum() for k in fa)
    den = sum((fb[k] ** 2).sum() for k in fb)
    return float(np.sqrt(num / max(den, 1e-30)))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", [1, 2, 3, 5, 8])
def test_buffered_robust_merge_matches_jax(kind, n):
    for seed in range(3):
        flat = _stack(seed, n, outlier=seed == 2)
        weights = np.random.default_rng(100 + seed).uniform(0.2, 3.0, n).astype(np.float32)
        got = ta.buffered_robust_merge(_tree(flat, True), torch.from_numpy(weights), kind, trim=1, f=1)
        want = ja.buffered_robust_merge(_tree(flat, False), jnp.asarray(weights), kind, trim=1, f=1)
        assert _rel(got, want) <= REL_L2, (kind, n, seed)


def test_krum_screen_merge_drops_the_outliers_jax_drops():
    flat = _stack(5, 7, outlier=True)
    weights = np.arange(1, 8, dtype=np.float32)
    for f in (1, 2, 3):
        got = ta.krum_screen_merge(_tree(flat, True), torch.from_numpy(weights), f)
        want = ja.krum_screen_merge(_tree(flat, False), jnp.asarray(weights), f)
        assert _rel(got, want) <= REL_L2
    with pytest.raises(ValueError, match="ASYNC_ROBUST_AGG"):
        ta.buffered_robust_merge(_tree(flat, True), torch.from_numpy(weights), "mode")


def test_screen_stats_and_server_merge_match_jax():
    rng = np.random.default_rng(7)
    for scale in (1.0, -1.0, 8.0, 1e-3):
        p = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
        r = {k: (scale * p[k] + 0.1 * rng.normal(size=p[k].shape)).astype(np.float32) for k in p}
        got = [float(x) for x in ta.screen_stats(_tree(p, True), _tree(r, True))]
        want = [float(x) for x in ja.screen_stats(_tree(p, False), _tree(r, False))]
        np.testing.assert_allclose(got, want, rtol=1e-6)
        for lr in (1.0, 0.5, 0.1):
            assert _rel(ta.server_merge(_tree(p, True), _tree(r, True), lr=lr),
                        ja.server_merge(_tree(p, False), _tree(r, False), lr=lr)) <= REL_L2


def _offers(seed: int, n: int = 60):
    """A random offer stream: origins, seqs (duplicates and reorders
    included), base versions (some past the staleness bound) and params."""
    rng = random.Random(seed)
    nrng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        origin = rng.choice(["a", "b", "c", "d", "e", "f"])
        out.append((origin, rng.randint(1, 12), rng.randint(0, 25), 1 + rng.randint(0, 4),
                    nrng.normal(size=6).astype(np.float32)))
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_buffered_aggregator_flushes_as_jax_does(kind):
    """The same offers (and a set_global and a K repair midway) into both
    packages' buffers: every flush equal in version, contributors, sample
    count and staleness; params within REL_L2; the same drops counted."""
    Settings.ASYNC_ROBUST_AGG = JSettings.ASYNC_ROBUST_AGG = kind
    start = np.linspace(-1, 1, 6).astype(np.float32)
    kw = dict(k=3, alpha=0.5, server_lr=0.7, max_staleness=8)
    jb = JBuffer("jax-agg", {"w": jnp.asarray(start)}, **kw)
    tb = BufferedAggregator("port-agg", {"w": torch.from_numpy(start.copy())}, **kw)
    flushes = 0
    for i, (origin, seq, base, ns, w) in enumerate(_offers(11)):
        if i == 20:
            assert jb.set_global({"w": jnp.asarray(start * 2)}, 6) == tb.set_global({"w": torch.from_numpy(start * 2)}, 6)
        if i == 40:
            jr, tr = jb.set_k(2), tb.set_k(2)
        else:
            ju = JUpdate({"w": jnp.asarray(w)}, [origin], ns)
            ju.version = (origin, seq, base)
            jr = jb.offer(ju)
            tr = tb.offer(ModelUpdate({"w": torch.from_numpy(w.copy())}, [origin], ns, version=(origin, seq, base)))
        assert (jr is None) == (tr is None), i
        if jr is not None:
            flushes += 1
            assert (tr.version, tr.contributors, tr.num_samples, tr.taus) == (
                jr.version, jr.contributors, jr.num_samples, jr.taus)
            assert _rel(tr.params, jr.params) <= REL_L2
    assert flushes >= 4 and jb.merges == tb.merges and jb.version == tb.version
    assert jb.version_vector() == tb.version_vector() and jb.pending() == tb.pending()
    assert ([u.version for u in jb.take_pending()] == [u.version for u in tb.take_pending()])


@pytest.mark.parametrize("kind", KINDS)
def test_flush_is_arrival_order_independent_bit_for_bit(kind):
    Settings.ASYNC_ROBUST_AGG = kind
    rng = np.random.default_rng(3)
    ups = [(f"n{i}", rng.normal(size=(4, 3)).astype(np.float32), 1 + i % 3) for i in range(5)]
    results = []
    for order in ([0, 1, 2, 3, 4], [4, 2, 0, 3, 1], [3, 4, 1, 0, 2]):
        buf = BufferedAggregator("me", {"w": torch.zeros(4, 3)}, k=5, alpha=0.5)
        res = None
        for i in order:
            o, w, ns = ups[i]
            res = buf.offer(ModelUpdate({"w": torch.from_numpy(w)}, [o], ns, version=(o, 1, 0)))
        results.append(res.params["w"])
    assert all(torch.equal(results[0], r) for r in results[1:])


def test_defense_admits_suspects_and_quarantines_as_jax():
    """The same contributions through both packages' screens: every
    verdict, every suspicion level and the one-shot quarantine equal."""
    Settings.BYZ_SCREEN = JSettings.BYZ_SCREEN = True
    Settings.BYZ_SUSPICION_BETA = JSettings.BYZ_SUSPICION_BETA = 0.5
    rng = np.random.default_rng(9)
    ref = rng.normal(size=20).astype(np.float32)
    jd, td = JDefense("me"), ByzantineDefense("me")
    cases = []
    for _ in range(80):
        origin = str(rng.choice(["h1", "h2", "att", "me"]))
        kind = rng.integers(4)
        noise = 0.05 * rng.normal(size=20).astype(np.float32)
        w = {0: ref + noise, 1: -ref, 2: 9.0 * ref, 3: rng.normal(size=20).astype(np.float32)}[int(kind)]
        if origin.startswith("h"):
            w = ref + noise
        cases.append((origin, w.astype(np.float32)))
    for origin, w in cases:
        a = jd.admit(origin, {"w": jnp.asarray(w)}, {"w": jnp.asarray(ref)})
        b = td.admit(origin, {"w": torch.from_numpy(w)}, {"w": torch.from_numpy(ref)})
        assert a == b
        assert td.suspicion(origin) == pytest.approx(jd.suspicion(origin), abs=0)
    assert jd.take_quarantined() == td.take_quarantined() == ["att"]
    assert jd.screen_rejects == td.screen_rejects > 0
    # a zero reference has no direction: the screen abstains in both
    assert td.admit("h9", {"w": torch.ones(20)}, {"w": torch.zeros(20)})
