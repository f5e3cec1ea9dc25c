"""The megafleet chunk step as the card's kernel walks it, held on the CPU.

``csrc/fleet_chunk.cu`` runs a span of chunks in one launch (pass A
inside for the consensus task), keeps each regional window's sample sum
as a running sum and folds a fedavg window with its weights divided by
the total once. Its plain twin is :meth:`ChunkedFleet.pass_a` then
:func:`fleet_chunk_plain`, chunk by chunk (:func:`fleet_span_plain`):

- the twin over a span equals chunk-by-chunk stepping bit for bit, and
  the fleet through it equals JAX's engine (integers exactly, params
  within ``REL``), flat and hierarchical, under the robust folds,
  Byzantine senders, churn and the chaos knobs;
- the running sample sum equals the slot-order sum bit for bit (pads add
  +0), and both equal numpy's and JAX's sums on integer-valued samples;
- the kernel's fedavg arithmetic (key-order total, weights divided once,
  key-order terms) equals the per-term division it replaced bit for bit,
  and ``fold_window`` and JAX's fold bit for bit where every sum is exact,
  within ``REL`` elsewhere (torch and XLA sum in a library order);
- ``FLEET_ARGS`` is the source's ``FleetArgs`` struct, name for name.
"""

import re

import numpy as np
import pytest
import torch

import test_torch_megafleet as base
from p2pfl_tpu.ops import fleet_kernels as jfk
from p2pfl_tpu.settings import Settings as JSettings
from p2pfl_tpu_torch.ops import _kernels
from p2pfl_tpu_torch.ops import fleet_kernels as tfk
from p2pfl_tpu_torch.settings import Settings, set_test_settings

REL = base.REL


@pytest.fixture(autouse=True)
def _env():
    set_test_settings()
    yield
    Settings.ASYNC_ROBUST_AGG = JSettings.ASYNC_ROBUST_AGG = "fedavg"


SPAN_CASES = {
    # name: (clients, cluster, plan, knobs)
    "flat": (500, 0, "none", dict(k=8, chunk=48)),
    "hier": (500, 32, "none", dict(k=8, chunk=48)),
    "median": (300, 0, "byzantine", dict(k=8, fold="median")),
    "trimmed": (300, 0, "byzantine", dict(k=8, fold="trimmed-mean")),
    "byzantine_hier": (200, 25, "byzantine", dict(k=4)),
    "churn_hier": (300, 32, "churn", dict()),
    "chaos_hier": (300, 16, "chaos", dict(k=4, pace_window=0.4, select_frac=0.8, rate_limit_regional=0.02,
                                          rate_limit_global=0.01)),
}


@pytest.mark.parametrize("name", list(SPAN_CASES))
def test_span_plain_equals_chunk_steps_and_jax(name):
    """One span over the whole run, spans of 5 chunks and one chunk a step
    leave the same carry bit for bit; the fleet (one span, as
    ``MegaFleet.run`` runs it) equals JAX's."""
    n, cluster, plan, kw = SPAN_CASES[name]
    jmf, tmf = base._fleets(n, plan, cluster_size=cluster, updates_per_node=4, local_lr=0.7, **kw)
    whole = tmf.chunked_engine(device="cpu")
    whole.run()
    spans = tmf.chunked_engine(device="cpu")
    spans.run(5)
    stepped = tmf.chunked_engine(device="cpu")
    for s in range(stepped.n_chunks):
        stepped.step(s)
    assert whole.n_chunks > 5
    for eng in (spans, stepped):
        for k, v in whole.carry.items():
            assert torch.equal(v, eng.carry[k]), k
    base._same_run(jmf.run(), tmf.run())


def _fsum(values) -> np.float32:
    total = np.float32(0.0)
    for v in values:
        total = np.float32(total + np.float32(v))
    return total


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_running_raw_equals_the_slot_order_sum(seed):
    """A regional window of 64 slots filled in order with non-integer
    samples: the sum updated at each insert equals the slot-order sum over
    all 64 slots, pads included, bit for bit (and the twin's
    ``slot_sum``); on integer-valued samples, as every fleet's, it also
    equals numpy's pairwise sum and JAX's."""
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    k = 64
    for fill in (1, 5, 17, 63, 64):
        window = np.zeros(k, np.float32)
        window[:fill] = rng.uniform(0.1, 9.0, fill).astype(np.float32)
        running = np.float32(0.0)
        for slot in range(fill):  # the kernel: raw[r] += sample at each insert
            running = np.float32(running + window[slot])
        assert running.view(np.int32) == _fsum(window).view(np.int32) == tfk.slot_sum(window).view(np.int32)
        ints = np.zeros(k, np.float32)
        ints[:fill] = (1 + rng.integers(0, 3, fill)).astype(np.float32)
        want = np.float32(jnp.sum(jnp.asarray(ints)))
        assert tfk.slot_sum(ints) == np.sum(ints, dtype=np.float32) == want


def _keyorder_fold(rows, w, lo, hi, prev, lr, per_term=False):
    """The kernel's fedavg fold in fp32: slots in (hi, lo) order (stable),
    the total in that order, each weight divided by it once (or, as the
    kernel before, inside each term), each coordinate's terms summed in
    that order, then the server merge as two products and a sum."""
    f = np.float32
    order = sorted(range(len(w)), key=lambda i: (int(hi[i]), int(lo[i]), i))
    total = _fsum(w[i] for i in order)
    nw = [f(w[i] / total) for i in order]
    keep, lrf = f(1.0 - lr), f(lr)
    out = np.empty_like(prev)
    for d in range(rows.shape[1]):
        acc = f(0.0)
        for n, i in enumerate(order):
            weight = f(w[i] / total) if per_term else nw[n]
            acc = f(acc + f(weight * rows[i, d]))
        out[d] = f(f(keep * prev[d]) + f(lrf * acc))
    return out


def _dyadic_window(seed):
    """A window whose every sum and product is exact in fp32: live weights
    summing to 8, rows and prev in eighths, server lr 0.5."""
    rng = np.random.default_rng(seed)
    rows = (rng.integers(-64, 64, size=(8, 6)) / 8).astype(np.float32)
    w = np.zeros(8, np.float32)
    w[:5] = [4.0, 1.0, 1.0, 0.5, 1.5]
    perm = rng.permutation(8)
    rows, w = rows[perm], w[perm]
    lo = np.where(w > 0, 1 + rng.permutation(8) % 4, tfk.PAD_KEY).astype(np.int32)
    hi = np.where(w > 0, rng.permutation(8) // 4, tfk.PAD_KEY).astype(np.int32)
    prev = (rng.integers(-64, 64, size=6) / 8).astype(np.float32)
    return rows, w, lo, hi, prev


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prenormalised_fold_equals_fold_window_and_jax(seed):
    rows, w, lo, hi, prev = _dyadic_window(seed)
    got = _keyorder_fold(rows, w, lo, hi, prev, 0.5)
    assert np.array_equal(got.view(np.int32), _keyorder_fold(rows, w, lo, hi, prev, 0.5, per_term=True).view(np.int32))
    torch_fold = tfk.fold_window(*(torch.from_numpy(x) for x in (rows, w, lo, prev)), 0.5,
                                 keys_hi=torch.from_numpy(hi)).numpy()
    jax_fold = np.asarray(jfk.fold_window(rows, w, lo, prev, 0.5, keys_hi=hi))
    assert np.array_equal(got, torch_fold) and np.array_equal(got, jax_fold)
    # a general window (base._window's): the two kernel forms bit-equal,
    # torch's and JAX's folds within REL of the largest value
    rows, w, lo, hi, prev = base._window(8, 6, 5 + seed, seed=seed)
    got = _keyorder_fold(rows, w, lo, hi, prev, 0.7)
    assert np.array_equal(got.view(np.int32), _keyorder_fold(rows, w, lo, hi, prev, 0.7, per_term=True).view(np.int32))
    want = np.asarray(jfk.fold_window(rows, w, lo, prev, 0.7, keys_hi=hi))
    np.testing.assert_allclose(got, want, rtol=0, atol=REL * np.abs(want).max())
    torch_fold = tfk.fold_window(*(torch.from_numpy(x) for x in (rows, w, lo, prev)), 0.7,
                                 keys_hi=torch.from_numpy(hi)).numpy()
    np.testing.assert_allclose(got, torch_fold, rtol=0, atol=REL * np.abs(want).max())


def test_fleet_args_match_the_struct_in_the_source():
    """``FLEET_ARGS`` names the ``FleetArgs`` fields of
    ``csrc/fleet_chunk.cu`` in order, pointers as tensors, ``long long``
    as ints and ``double`` as floats, and the engine hands the kernel a
    value for every one of them."""
    src = (_kernels.CSRC / "fleet_chunk.cu").read_text()
    body = re.search(r"struct FleetArgs \{(.*?)\n\};", src, re.S).group(1)
    fields = []
    for decl in re.sub(r"//[^\n]*", "", body).split(";"):
        m = re.fullmatch(r"\s*(?:const )?(unsigned char|long long|int|float|double)\s*(\*?)\s*(.*?)\s*", decl, re.S)
        if m:
            fields += [(name.strip(), m.group(1) + m.group(2)) for name in m.group(3).split(",")]
    assert [n for n, _ in fields] == [n for n, _ in _kernels.FLEET_ARGS]
    for (name, ctype), (_, kind) in zip(fields, _kernels.FLEET_ARGS):
        assert ctype.endswith({"int": "long long", "float": "double"}.get(kind, "*")), name
    _, tmf = base._fleets(60, "none", cluster_size=8, k=4, chunk=16)
    values = tmf.chunked_engine(device="cpu").kernel_values()
    unused = {"noise", "reg_dup", "akind", "alam", "agg_noise_idx", "agg_noise", "bkind", "blam", "bnoise", "prof"}
    assert {n for n, _ in _kernels.FLEET_ARGS if values.get(n) is None} <= unused
