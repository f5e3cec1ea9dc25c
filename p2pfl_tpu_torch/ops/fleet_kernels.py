"""The megafleet engines: the async fleet as dense per-client arrays
(counterpart of ``p2pfl_tpu/ops/fleet_kernels.py``).

:mod:`~p2pfl_tpu_torch.federation.simfleet` pops events off a heap one at a
time. This module runs the same fleet over the chronologically sorted
contribution arrivals with the whole edge population held as dense
per-client tensors: ``w [N + 1, dim + 1]`` (each client's params, its
adopted version in column ``dim``, row ``N`` a trash row for pad lanes),
the global history ``G`` and mint times ``mint``, and the regional tier as
windows addressed by regional. The math is the live buffer's:
:func:`fold_window` sorts a window by its ``(origin, seq)`` keys, folds it
with :func:`~p2pfl_tpu_torch.ops.aggregation.fedavg` (or the pad-aware rank
rules) and :func:`~p2pfl_tpu_torch.ops.aggregation.server_merge`, weighted by
``num_samples · w(τ)``.

Two engines, bit-identical on flat topologies:

- :func:`run_fleet_program`, the per-event reference: a host loop over the
  events, scalars on the host, rows on the device (the parity anchor; for
  1k-20k clients).
- :class:`ChunkedFleet`, ``cfg.chunk`` events a step. Pass A is PyTorch on
  the chunk's ``[C]`` lanes: gather the rows, adopt against the pre-chunk
  mint history (``searchsorted``), one batched local round, scatter back.
  Passes B, C and D, the sequential admission, the window folds and their
  writebacks, are one launch of the hand-written kernel
  ``csrc/fleet_chunk.cu`` on the card (:func:`fleet_chunk`), or its plain
  twin :func:`fleet_chunk_plain` (a loop on host scalars plus the torch
  fold) on the CPU. A lane whose adoption an in-chunk mint moves is
  retrained from that mint before its offer, so the result is the
  per-event engine's: in the kernel for the consensus task; for a
  gradient task the launch stops at the lane, :meth:`ChunkedFleet.retrain`
  runs the task's round in PyTorch, and a second launch resumes there.

JAX runs both as one ``lax.scan``; it has no Pallas kernel here. Times are
fp32, versions and keys int32 as in JAX (x64 off); the staleness weights
come from one fp32 table ``w(0..max_staleness+1)`` shared by every engine,
the kernel included, so all of them weight a contribution with the same
bits.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from p2pfl_tpu_torch.ops.aggregation import fedavg, server_merge

#: sort key of an empty window slot: pads sort last with weight 0
PAD_KEY = 2 ** 31 - 1
_INF = float("inf")
#: fold kinds the engines run (krum-screen needs the heap engine)
FOLD_CODES = {"fedavg": 0, "trimmed-mean": 1, "median": 2}
#: int32 scalars of the chunked carry (``si``), in this order
SCALARS = ("version", "gcount", "merges", "stale_edge", "rate_edge", "stale_agg", "rate_agg", "rmerges",
           "agg_drop", "dup_agg", "byz_agg")
_S = {name: i for i, name in enumerate(SCALARS)}


class FleetConfig(NamedTuple):
    """Shapes and knobs of one fleet program (the JAX package's static
    tuple, less its ``lax.scan`` unroll factor)."""

    hier: bool  #: two tiers (regional windows + global) vs flat
    n_clients: int
    dim: int
    n_regionals: int  #: R (1 in flat mode)
    k_global: int
    k_reg_max: int  #: widest regional window
    v_cap: int  #: global version capacity (a host bound)
    alpha: float
    server_lr: float
    local_lr: float
    max_staleness: int
    rate_gap_reg: float
    rate_gap_glob: float
    hist_bins: int  #: staleness histogram bins (the last takes the tail)
    agg_key_stride: int  #: columns of the (regional, up_seq) grids
    chunk: int = 1  #: events a step (1 = the per-event engine)
    gf_cap: int = 0  #: most global mints in one chunk (host bound)
    fold_kind: str = "fedavg"
    trim: int = 1
    task: str = "consensus"  #: "consensus" | "linear" | "mlp"
    t_din: int = 0
    t_nout: int = 0
    t_hidden: int = 0
    t_bs: int = 0
    t_steps: int = 0
    data_seed: int = 0
    byz: bool = False  #: Byzantine payload columns present
    dup: bool = False  #: aggregate duplicate verdicts present


def staleness_weight_arr(tau: torch.Tensor, alpha: float) -> torch.Tensor:
    """Elementwise FedBuff weight ``w(τ) = 1/(1+τ)^α`` in fp32 (τ clamped at
    0; α = 0 gives ones)."""
    t = torch.clamp_min(tau.to(torch.float32), 0.0)
    if float(alpha) == 0.0:
        return torch.ones_like(t)
    return 1.0 / (1.0 + t) ** float(alpha)


def weight_table(cfg: FleetConfig) -> torch.Tensor:
    """``w(τ)`` for τ in ``[0, hist_bins)`` on the CPU: every engine reads
    its weights here (an admitted τ is at most ``max_staleness``)."""
    return staleness_weight_arr(torch.arange(cfg.hist_bins), cfg.alpha)


# ---- the gradient task: threefry2x32 and the normal of jax.random ----

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 (20 rounds) on int64 tensors holding uint32 values:
    ``jax.random``'s block function, bit for bit."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & _M32) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def prng_key(seed: int) -> tuple:
    """``jax.random.PRNGKey(seed)``'s two words (x64 off)."""
    return torch.tensor(0, dtype=torch.int64), torch.tensor(int(seed) & _M32, dtype=torch.int64)


def fold_in(key: tuple, data) -> tuple:
    """``jax.random.fold_in``: the block function of ``(0, data)``."""
    d = torch.as_tensor(data, dtype=torch.int64) & _M32
    return threefry2x32(key[0], key[1], torch.zeros_like(d), d)


def random_bits(key: tuple, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,))`` (the partitionable threefry: word ``i``
    is ``y0 ^ y1`` of the block of ``(0, i)``); ``key`` words may carry
    leading lane dimensions, the result is ``[..., n]``."""
    k0, k1 = key[0][..., None], key[1][..., None]
    i = torch.arange(n, dtype=torch.int64, device=k0.device)
    y0, y1 = threefry2x32(k0, k1, torch.zeros_like(i), i)
    return y0 ^ y1


#: XLA's fp32 erfinv (Giles' polynomials), w < 5 and w >= 5
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
               -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
               -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def erfinv_xla(x: torch.Tensor) -> torch.Tensor:
    """fp32 erfinv as XLA computes it: ``w = -log1p(-x²)``, a degree-8
    polynomial in ``w - 2.5`` or ``sqrt(w) - 3``, times ``x``."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    f32 = dict(dtype=torch.float32, device=x.device)
    p = torch.where(lt, torch.tensor(_ERFINV_LT5[0], **f32), torch.tensor(_ERFINV_GE5[0], **f32))
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = torch.where(lt, torch.tensor(a, **f32), torch.tensor(b, **f32)) + p * w
    return torch.where(x.abs() == 1.0, x * torch.finfo(torch.float32).max, p * x)


def normal(key: tuple, n: int) -> torch.Tensor:
    """``jax.random.normal(key, (n,), float32)``: a uniform on
    ``(nextafter(-1, 0), 1)`` from the bits' mantissas, then
    ``sqrt(2)·erfinv``."""
    bits = random_bits(key, n)
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(np.nextafter(np.float32(-1.0), np.float32(0.0)), device=floats.device)
    hi = torch.tensor(1.0, device=floats.device)
    u = torch.maximum(lo, floats * (hi - lo) + lo)
    return torch.tensor(np.float32(np.sqrt(2.0)), device=u.device) * erfinv_xla(u)


def grad_param_dim(kind: str, din: int, nout: int, hidden: int = 0) -> int:
    """Flat parameter count of the tiny learner (``linear``: one dense
    layer; ``mlp``: dense → relu → dense)."""
    if kind == "linear":
        return din * nout + nout
    if kind == "mlp":
        return din * hidden + hidden + hidden * nout + nout
    raise ValueError(f"unknown gradient task kind {kind!r}")


def grad_logits(kind: str, din: int, nout: int, hidden: int, flat: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Forward pass from flat parameters ``[..., P]`` on ``x [..., B, din]``
    (leading lane dimensions broadcast): a flax ``Dense`` stack's math."""
    lead = flat.shape[:-1]
    if kind == "linear":
        w = flat[..., : din * nout].reshape(*lead, din, nout)
        b = flat[..., din * nout:]
        return x @ w + b[..., None, :]
    o = din * hidden
    w1 = flat[..., :o].reshape(*lead, din, hidden)
    b1 = flat[..., o:o + hidden]
    o += hidden
    w2 = flat[..., o:o + hidden * nout].reshape(*lead, hidden, nout)
    b2 = flat[..., o + hidden * nout:]
    h = torch.relu(x @ w1 + b1[..., None, :])
    return h @ w2 + b2[..., None, :]


def make_grad_fns(kind: str, din: int, nout: int, hidden: int, bs: int, steps: int, lr: float, data_seed: int):
    """The gradient task's ``(gen_batch, train_one, train_vec)``:

    - ``gen_batch(i, m, mu_row, tw, tb)`` → ``(xs [steps, bs, din], ys
      [steps, bs])``: client ``i``'s round ``m`` from the counter stream
      ``fold_in(fold_in(key(data_seed), i), m)``, a Gaussian cloud around
      ``mu_row`` labelled by the teacher; ``i``, ``m`` and ``mu_row`` may
      carry a leading lane dimension;
    - ``train_one(flat, xs, ys)``: ``steps`` SGD steps on softmax
      cross-entropy, ``p + g·(−lr)`` (optax.sgd's update), lanes batched;
    - ``train_vec(flats, his, los, mus, tw, tb)``: both, lane by lane.
    """
    root = prng_key(data_seed)

    def gen_batch(i, m, mu_row, tw, tb):
        dev = mu_row.device
        key = fold_in(fold_in((root[0].to(dev), root[1].to(dev)), torch.as_tensor(i, device=dev)),
                      torch.as_tensor(m, device=dev))
        z = normal(key, steps * bs * din)
        x = mu_row[..., None, None, :] + z.reshape(*z.shape[:-1], steps, bs, din)
        y = torch.argmax(x @ tw + tb, dim=-1)
        return x, y

    def train_one(flat, xs, ys):
        p = flat
        for t in range(steps):
            q = p.detach().requires_grad_(True)
            with torch.enable_grad():
                lg = grad_logits(kind, din, nout, hidden, q, xs[..., t, :, :])
                loss = F.cross_entropy(lg.reshape(-1, nout), ys[..., t, :].reshape(-1), reduction="none")
                (g,) = torch.autograd.grad(loss.reshape(ys.shape[:-2] + (bs,)).mean(-1).sum(), q)
            p = p + g * (-float(lr))
        return p.detach()

    def train_vec(flats, his, los, mus, tw, tb):
        xs, ys = gen_batch(his, los, mus, tw, tb)
        return train_one(flats, xs, ys)

    return gen_batch, train_one, train_vec


def fold_window(rows, weights, keys, prev, server_lr: float, kind: str = "fedavg", trim: int = 1, keys_hi=None):
    """One buffer flush on a dense window: sort by the ``(origin, seq)``
    keys (``keys_hi`` the origin word, ``keys`` the sequence word; stable,
    as ``jnp.lexsort``), fold, :func:`server_merge` into ``prev``.

    ``"fedavg"`` is :func:`fedavg` over the weights: empty slots (weight 0,
    ``PAD_KEY``) sort last and add exact ``+0.0`` terms. ``"trimmed-mean"``
    and ``"median"`` are rank rules over the ``weight > 0`` slots only
    (pads sort to +inf a coordinate; ``trim`` clamped to ``(n-1)//2``),
    weights ignored. ``rows [K, dim]``, ``weights [K]``, ``prev [dim]``."""
    if keys_hi is None:
        order = torch.sort(keys.to(torch.int64), stable=True).indices
    else:
        # one int64 key: the high word signed, the low word shifted to [0, 2^32)
        key = keys_hi.to(torch.int64) * 2 ** 32 + (keys.to(torch.int64) + 2 ** 31)
        order = torch.sort(key, stable=True).indices
    sorted_rows = rows.index_select(0, order)
    sorted_w = weights.index_select(0, order)
    if kind == "fedavg":
        avg = fedavg({"p": sorted_rows}, sorted_w, agg_dtype="float32")["p"]
    elif kind in ("trimmed-mean", "median"):
        live = sorted_w > 0.0
        n = live.sum()
        vals = torch.where(live[:, None], sorted_rows.float(), _INF)
        svals = torch.sort(vals, dim=0).values
        k = rows.shape[0]
        if kind == "median":
            lo = svals.index_select(0, torch.clamp((n - 1) // 2, 0, k - 1).reshape(1))[0]
            hi = svals.index_select(0, torch.clamp(n // 2, 0, k - 1).reshape(1))[0]
            avg = 0.5 * (lo + hi)
        else:
            t = torch.minimum(torch.tensor(int(trim), device=n.device), (n - 1) // 2)
            ranks = torch.arange(k, device=rows.device)[:, None]
            kept = torch.where((ranks >= t) & (ranks < n - t), svals, 0.0)
            avg = kept.sum(0) / torch.clamp_min(n - 2 * t, 1).to(torch.float32)
        avg = torch.where(n >= 1, avg, torch.zeros_like(avg))
    else:
        raise ValueError(f"fold kind {kind!r} has no vectorized window fold")
    return server_merge({"p": prev}, {"p": avg}, lr=server_lr, agg_dtype="float32")["p"]


def _wt(wtab: np.ndarray, tau: int) -> np.float32:
    return wtab[min(max(tau, 0), wtab.shape[0] - 1)]


def _bump(hist: np.ndarray, tau: int) -> None:
    """One count into a staleness histogram (the last bin takes the tail)."""
    hist[min(max(tau, 0), hist.shape[0] - 1)] += 1


def _result(cfg: FleetConfig, G, mint, w, ints: dict, hist_edge, hist_glob) -> Dict[str, Any]:
    out = {"G": G, "mint": mint, "w": w[: cfg.n_clients],
           "hist_edge": np.asarray(hist_edge, np.int64).copy(), "hist_glob": np.asarray(hist_glob, np.int64).copy()}
    out.update({k: int(v) for k, v in ints.items()})
    return out


def run_fleet_program(cfg: FleetConfig, events: dict, clients: dict, reg: dict, init_params, device) -> Dict[str, Any]:
    """The per-event reference engine: one event at a time in arrival
    order. ``events`` holds the sorted host columns (``client``,
    ``key_hi``, ``key_lo``, ``t_train``, ``t_arr``, ``send_ok``);
    ``clients`` ``targets [N, dim]``, ``samples``, ``adopt_delay`` and
    (hier) ``regional_of``; ``reg`` the regionals' ``k``, ``adopt_delay``,
    ``agg_delay`` and the aggregate sends' ``send_ok`` / ``jit`` grids (all
    numpy). Scalars live on the host, rows on ``device``. Consensus task,
    fedavg fold (the other configurations take the chunked engine).
    Returns the final state: ``G``, ``mint``, ``w`` and the counters."""
    dim, lr = cfg.dim, float(cfg.local_lr)
    f32 = dict(dtype=torch.float32, device=device)
    init = torch.as_tensor(np.asarray(init_params, np.float32), **f32)
    targets = torch.as_tensor(clients["targets"], **f32)
    w = init.repeat(cfg.n_clients, 1)
    prev_v = np.zeros(cfg.n_clients, np.int64)  # the adopted version, column dim of JAX's rows
    G = torch.zeros((cfg.v_cap + 1, dim), **f32)
    G[0] = init
    mint = np.full(cfg.v_cap, np.inf, np.float32)
    wtab = weight_table(cfg).numpy()
    K = cfg.k_global
    gbuf = torch.zeros((K, dim), **f32)
    gwt = np.zeros(K, np.float32)
    gkh = np.full(K, PAD_KEY, np.int32)
    gkl = np.full(K, PAD_KEY, np.int32)
    st = dict(version=0, gcount=0, merges=0, stale_edge=0, rate_edge=0, stale_agg=0, rate_agg=0,
              rmerges=0, agg_drop=0)
    lastm, laccg = np.float32(-np.inf), np.float32(-np.inf)
    hist_edge = np.zeros(cfg.hist_bins, np.int64)
    hist_glob = np.zeros(cfg.hist_bins, np.int64)
    samples = np.asarray(clients["samples"], np.float32)
    adopt_delay = np.asarray(clients["adopt_delay"], np.float32)
    gap_g, gap_r = np.float32(cfg.rate_gap_glob), np.float32(cfg.rate_gap_reg)

    def fold(rows, wts, klo, khi, prev):
        return fold_window(rows, torch.from_numpy(wts).to(device), torch.from_numpy(klo).to(device), prev,
                           cfg.server_lr, keys_hi=torch.from_numpy(khi).to(device))

    def offer_global(accept, params, wgt, key_hi, key_lo, tau, t_evt, seam):
        nonlocal lastm, laccg
        fresh = tau <= cfg.max_staleness
        rate_ok = gap_g <= 0 or (t_evt - laccg) >= gap_g
        st[f"stale_{seam}"] += int(accept and not fresh)
        st[f"rate_{seam}"] += int(accept and fresh and not rate_ok)
        if not (accept and fresh and rate_ok):
            return
        slot = st["gcount"]
        gbuf[slot] = params
        gwt[slot], gkh[slot], gkl[slot] = wgt, key_hi, key_lo
        laccg = t_evt
        _bump(hist_edge if seam == "edge" else hist_glob, tau)
        st["gcount"] += 1
        if st["gcount"] != K:
            return
        st["gcount"] = 0
        v = st["version"]
        G[v + 1] = fold(gbuf, gwt, gkl, gkh, G[v])
        # mint times clamped monotone: the searchsorted axis stays ascending
        lastm = max(t_evt, lastm)
        mint[v] = lastm
        st["version"] = v + 1
        st["merges"] += 1
        gwt[:] = 0.0
        gkh[:] = PAD_KEY
        gkl[:] = PAD_KEY

    if cfg.hier:
        R, KR = cfg.n_regionals, cfg.k_reg_max
        rbuf = torch.zeros((R, KR, dim), **f32)
        rwt = np.zeros((R, KR), np.float32)
        rsamp = np.zeros((R, KR), np.float32)
        rkh = np.full((R, KR), PAD_KEY, np.int32)
        rkl = np.full((R, KR), PAD_KEY, np.int32)
        rcount = np.zeros(R, np.int64)
        rparams = init.repeat(R, 1)
        radopt = np.zeros(R, np.int64)
        up_seq = np.zeros(R, np.int64)
        last_acc_r = np.full(R, -np.inf, np.float32)
        regional_of = np.asarray(clients["regional_of"])
        reg_adopt = np.asarray(reg["adopt_delay"], np.float32)
        agg_delay = np.asarray(reg["agg_delay"], np.float32)
        stride = reg["send_ok"].shape[1]

    for j in range(len(events["client"])):
        i = int(events["client"][j])
        # adopt + train (always: a wire drop loses the send, not the step)
        base = int(np.searchsorted(mint, np.float32(events["t_train"][j]) - adopt_delay[i]))
        if base > prev_v[i]:
            g = G[base]
            w[i] = g + lr * (targets[i] - g)
        else:
            w[i] = w[i] + lr * (targets[i] - w[i])
        prev_v[i] = max(base, prev_v[i])
        base_eff = int(prev_v[i])
        ok = bool(events["send_ok"][j])
        t_arr = np.float32(events["t_arr"][j])
        khi, klo = int(events["key_hi"][j]), int(events["key_lo"][j])
        if not cfg.hier:
            tau = max(st["version"] - base_eff, 0)
            offer_global(ok, w[i], samples[i] * _wt(wtab, tau), khi, klo, tau, t_arr, "edge")
            continue
        r = int(regional_of[i])
        rv = int(np.searchsorted(mint, t_arr - reg_adopt[r]))
        tau = max(rv - base_eff, 0)
        fresh = tau <= cfg.max_staleness
        rate_ok = gap_r <= 0 or (t_arr - last_acc_r[r]) >= gap_r
        st["stale_edge"] += int(ok and not fresh)
        st["rate_edge"] += int(ok and fresh and not rate_ok)
        if not (ok and fresh and rate_ok):
            continue
        slot = int(rcount[r])
        rbuf[r, slot] = w[i]
        rwt[r, slot], rsamp[r, slot] = samples[i] * _wt(wtab, tau), samples[i]
        rkh[r, slot], rkl[r, slot] = khi, klo
        last_acc_r[r] = t_arr
        _bump(hist_edge, tau)
        rcount[r] += 1
        if rcount[r] != int(reg["k"][r]):
            continue
        rcount[r] = 0
        # regional flush: its params are the freshest arrived global when
        # newer than its last adoption; fold; push the aggregate up
        cur = G[rv] if rv > radopt[r] else rparams[r]
        rparams[r] = fold(rbuf[r], rwt[r], rkl[r], rkh[r], cur)
        raw = np.float32(rsamp[r].sum(dtype=np.float32))
        radopt[r] = max(radopt[r], rv)
        st["rmerges"] += 1
        up_seq[r] += 1
        up = int(up_seq[r])
        rwt[r], rsamp[r], rkh[r], rkl[r] = 0.0, 0.0, PAD_KEY, PAD_KEY
        sidx = min(max(up - 1, 0), stride - 1)
        agg_ok = bool(reg["send_ok"][r, sidx])
        t_agg = t_arr + agg_delay[r] + np.float32(reg["jit"][r, sidx])
        st["agg_drop"] += int(not agg_ok)
        tau_g = max(st["version"] - rv, 0)
        offer_global(agg_ok, rparams[r], raw * _wt(wtab, tau_g), r, up, tau_g, t_agg, "agg")
    wfull = torch.cat([w, torch.as_tensor(prev_v, **f32)[:, None]], 1)
    return _result(cfg, G, torch.from_numpy(mint).to(device), wfull, st, hist_edge, hist_glob)


# ---------------------------------------------------------------------------
# the chunked engine
# ---------------------------------------------------------------------------


class ChunkedFleet:
    """The chunked engine's state and its chunk step. ``events`` are the
    host-built ``[S, C]`` grids (pads: client ``N``, ``PAD_KEY`` keys,
    ``live`` False), ``clients`` the per-client arrays (``targets``,
    ``samples``; ``mu``/``tw``/``tb`` for the gradient task, ``noise`` for
    the Byzantine noise rows), ``reg`` the per-regional grids (hier), all
    numpy. Everything moves to ``device`` once; :meth:`step` runs pass A
    and then :func:`fleet_chunk`."""

    def __init__(self, cfg: FleetConfig, events: dict, clients: dict, reg: dict, init_params, device) -> None:
        self.cfg, self.device = cfg, torch.device(device)
        dev = self.device
        n, dim, C = cfg.n_clients, cfg.dim, cfg.chunk

        def put(a, dtype=None):
            t = torch.from_numpy(np.ascontiguousarray(a))
            return t.to(device=dev, dtype=dtype or t.dtype)

        self.ev = {k: put(v) for k, v in events.items()}
        self.ev["client"] = self.ev["client"].to(torch.int64)
        # pad lanes address row N of the client tables, as of w
        self.targets = put(np.concatenate([clients["targets"], np.zeros((1, dim), np.float32)]))
        self.samples = put(np.concatenate([clients["samples"], np.ones(1, np.float32)]))
        self.noise = put(clients["noise"]) if "noise" in clients else None
        self.task = None
        if cfg.task != "consensus":
            self.task = make_grad_fns(cfg.task, cfg.t_din, cfg.t_nout, cfg.t_hidden, cfg.t_bs, cfg.t_steps,
                                      cfg.local_lr, cfg.data_seed)[2]
            self.mu = put(np.concatenate([clients["mu"], np.zeros((1, cfg.t_din), np.float32)]))
            self.tw, self.tb = put(clients["tw"]), put(clients["tb"])
        self.reg = {k: put(v) for k, v in reg.items()}
        self.wtab = weight_table(cfg).to(dev)
        init = torch.as_tensor(np.asarray(init_params, np.float32), device=dev)
        f32, i32 = dict(dtype=torch.float32, device=dev), dict(dtype=torch.int32, device=dev)
        row0 = torch.cat([init, torch.zeros(1, **f32)])
        K, B = cfg.k_global, cfg.hist_bins
        self.carry = {
            "w": row0.repeat(n + 1, 1),  # row N: the pad lanes' trash row
            "G": torch.cat([init[None], torch.zeros((cfg.v_cap, dim), **f32)]),
            "mint": torch.full((cfg.v_cap,), _INF, **f32),
            "gbuf": torch.zeros((K, dim), **f32), "gwt": torch.zeros(K, **f32),
            "gkey_hi": torch.full((K,), PAD_KEY, **i32), "gkey_lo": torch.full((K,), PAD_KEY, **i32),
            "hist_edge": torch.zeros(B, **i32), "hist_glob": torch.zeros(B, **i32),
            "si": torch.zeros(len(SCALARS), **i32),
            "sf": torch.full((2,), -_INF, **f32),  # last_mint, last_acc_g
        }
        if cfg.hier:
            R, KR = cfg.n_regionals, cfg.k_reg_max
            self.carry.update({
                "rbuf": torch.zeros((R, KR, dim), **f32), "rwt": torch.zeros((R, KR), **f32),
                "rsamp": torch.zeros((R, KR), **f32),
                "rkey_hi": torch.full((R, KR), PAD_KEY, **i32), "rkey_lo": torch.full((R, KR), PAD_KEY, **i32),
                "rcount": torch.zeros(R, **i32), "rparams": init.repeat(R, 1),
                "radopt": torch.zeros(R, **i32), "up_seq": torch.zeros(R, **i32),
                "last_acc_r": torch.full((R,), -_INF, **f32),
            })
        # pass A's outputs, one buffer each for the whole run (the kernel's
        # argument table holds their addresses)
        self.base0 = torch.zeros(C, dtype=torch.int64, device=dev)
        self.rv0 = torch.zeros(C, dtype=torch.int64, device=dev)
        self.rows0 = torch.zeros((C, dim + 1), **f32)
        self.payload = torch.zeros((C, dim), **f32)
        # the kernel's stop record: lane, adj, v0 (a gradient task's resume)
        self.stop = torch.zeros(3, **i32)
        self.resumes = 0  # launches that resumed a chunk at a retrained lane
        self.n_chunks = int(self.ev["client"].shape[0])
        self.kernel_args = None  # built at the first launch

    # ---- pass A ----

    def train(self, starts: torch.Tensor, idx: torch.Tensor, s: int, lanes=slice(None)) -> torch.Tensor:
        """One local round of each lane from ``starts``: the consensus pull
        ``x + lr·(t − x)`` or the gradient task's SGD round keyed by the
        lane's ``(key_hi, key_lo)``, which is ``(client, seq)``."""
        if self.task is None:
            t = self.targets.index_select(0, idx)
            return starts + self.cfg.local_lr * (t - starts)
        his, los = self.ev["key_hi"][s][lanes], self.ev["key_lo"][s][lanes]
        return self.task(starts, his, los, self.mu.index_select(0, idx), self.tw, self.tb)

    def apply_byz(self, p: torch.Tensor, s: int, lanes=slice(None)) -> torch.Tensor:
        """The Byzantine payload transforms of the send seam by kind code
        (1 sign flip, 2 scale, 3 noise): the sent copy only."""
        if not self.cfg.byz:
            return p
        k = self.ev["bkind"][s][lanes][:, None]
        p = torch.where(k == 1, -p, p)
        p = torch.where(k == 2, self.ev["blam"][s][lanes][:, None] * p, p)
        if self.noise is not None:
            p = torch.where(k == 3, p + self.noise.index_select(0, self.ev["bnoise"][s][lanes].to(torch.int64)), p)
        return p

    def retrain(self, s: int, j: int, version: int) -> torch.Tensor:
        """Lane ``j`` of chunk ``s`` adopted in-chunk global ``version``:
        retrain its client's row from it (the honest row, adopted version
        in column ``dim``) and return its sent (possibly corrupted)
        payload."""
        c, dim = self.carry, self.cfg.dim
        lane = slice(j, j + 1)
        idx = self.ev["client"][s][lane]
        honest = self.train(c["G"][version][None], idx, s, lane)
        c["w"][idx, :dim] = honest
        c["w"][idx, dim] = float(version)
        return self.apply_byz(honest, s, lane)[0]

    def pass_a(self, s: int) -> None:
        """Gather the chunk's rows, adopt against the pre-chunk mint
        history, train every lane once, scatter back (only the trash row
        repeats in ``idx``), stage the payloads for the admission pass."""
        c, dim = self.carry, self.cfg.dim
        idx = self.ev["client"][s]
        torch.searchsorted(c["mint"], self.ev["t_adopt"][s], out=self.base0)
        torch.index_select(c["w"], 0, idx, out=self.rows0)
        prev0 = self.rows0[:, dim]
        base0_f = self.base0.to(torch.float32)
        starts = torch.where((base0_f > prev0)[:, None], c["G"].index_select(0, self.base0), self.rows0[:, :dim])
        outs = self.train(starts, idx, s)
        c["w"].index_copy_(0, idx, torch.cat([outs, torch.maximum(base0_f, prev0)[:, None]], 1))
        self.payload.copy_(self.apply_byz(outs, s))
        if self.cfg.hier:
            torch.searchsorted(c["mint"], self.ev["t_radopt"][s], out=self.rv0)

    def step(self, s: int) -> None:
        self.pass_a(s)
        fleet_chunk(self, s)

    def run(self) -> Dict[str, Any]:
        for s in range(self.n_chunks):
            self.step(s)
        return self.result()

    def kernel_values(self) -> dict:
        """What the kernel's argument table holds (``_kernels.FLEET_ARGS``)."""
        cfg = self.cfg
        reg = {f"reg_{k}" if k in ("send_ok", "jit", "dup") else k: v for k, v in self.reg.items()}
        return {
            **self.ev, **self.carry, **reg, "base0": self.base0, "rv0": self.rv0, "rows0": self.rows0,
            "payload": self.payload, "targets": self.targets, "samples": self.samples, "noise": self.noise,
            "wtab": self.wtab, "chunk": cfg.chunk, "n_chunks": self.n_chunks, "dim": cfg.dim,
            "k_glob": cfg.k_global, "k_max": cfg.k_reg_max, "stride": cfg.agg_key_stride,
            "hist_bins": cfg.hist_bins, "max_staleness": cfg.max_staleness, "hier": int(cfg.hier),
            "fold": FOLD_CODES[cfg.fold_kind], "trim": cfg.trim, "byz": int(cfg.byz), "dup": int(cfg.dup),
            "gf_cap": max(cfg.gf_cap, 1), "stop": self.stop, "task": int(self.task is not None),
            # the twin's scalars as torch rounds them: fp32
            **{k: float(np.float32(v)) for k, v in (
                ("local_lr", cfg.local_lr), ("merge_keep", 1.0 - cfg.server_lr), ("merge_lr", cfg.server_lr),
                ("gap_reg", cfg.rate_gap_reg), ("gap_glob", cfg.rate_gap_glob))},
        }

    def result(self) -> Dict[str, Any]:
        c = self.carry
        si = c["si"].cpu().numpy()
        ints = {name: si[i] for i, name in enumerate(SCALARS)}
        return _result(self.cfg, c["G"], c["mint"], c["w"], ints, c["hist_edge"].cpu().numpy(),
                       c["hist_glob"].cpu().numpy())


def fleet_chunk(eng: ChunkedFleet, s: int) -> None:
    """Passes B-D of chunk ``s`` on ``eng``'s carry, in place: the
    ``fleet_chunk`` kernel (one launch) for a carry on a CUDA device, its
    plain twin :func:`fleet_chunk_plain` for one on the CPU."""
    if eng.device.type != "cuda":
        fleet_chunk_plain(eng, s)
        return
    from p2pfl_tpu_torch.ops import _kernels

    if eng.kernel_args is None:
        eng.kernel_args = _kernels.FleetChunkArgs(eng.kernel_values())
    _kernels.fleet_chunk(eng.kernel_args, s)
    if eng.task is None:
        return
    # a gradient task: each launch stops before a lane an in-chunk mint
    # moved; retrain it here, stage its payload, resume at it
    while True:
        j, adj, v0 = eng.stop.tolist()
        if j >= eng.cfg.chunk:
            return
        eng.payload[j] = eng.retrain(s, j, v0 + adj)
        eng.resumes += 1
        _kernels.fleet_chunk(eng.kernel_args, s, j, v0)


def fleet_chunk_plain(eng: ChunkedFleet, s: int) -> None:
    """The plain twin of the ``fleet_chunk`` kernel: the chunk's events in
    order on host scalars (numpy views of the CPU carry), the window folds
    by :func:`fold_window`. Per event: count the in-chunk mints before its
    adoption time (``adj``; a lane with ``adj > 0`` adopted an in-chunk
    mint, so its row is retrained from that global and its payload
    restaged), then the admission: the regional window (hier) or the
    global window, a flush folding the window, a regional flush offering
    its aggregate to the global window at the same position."""
    cfg, c = eng.cfg, eng.carry
    C, dim, K = cfg.chunk, cfg.dim, cfg.k_global
    h = {k: v.numpy() for k, v in c.items() if k not in ("w", "G", "gbuf", "rbuf", "rparams")}
    ev = {k: v[s].numpy() for k, v in eng.ev.items()}
    rg = {k: v.numpy() for k, v in eng.reg.items()}
    si, sf = h["si"], h["sf"]
    wtab = eng.wtab.numpy()
    base0, rv0 = eng.base0.numpy(), eng.rv0.numpy()
    prev0 = eng.rows0[:, dim].numpy()
    samples = eng.samples.numpy()
    gap_g, gap_r = np.float32(cfg.rate_gap_glob), np.float32(cfg.rate_gap_reg)
    ver = v0 = int(si[_S["version"]])
    nm: list = []  # this chunk's mint times

    def fold(rows, wts, klo, khi, prev):
        return fold_window(rows, torch.from_numpy(wts), torch.from_numpy(klo), prev, cfg.server_lr,
                           kind=cfg.fold_kind, trim=cfg.trim, keys_hi=torch.from_numpy(khi))

    def offer_global(accept, params, wgt, key_hi, key_lo, tau, t_evt, seam):
        nonlocal ver
        fresh = tau <= cfg.max_staleness
        rate_ok = gap_g <= 0 or (t_evt - sf[1]) >= gap_g
        si[_S[f"stale_{seam}"]] += int(accept and not fresh)
        si[_S[f"rate_{seam}"]] += int(accept and fresh and not rate_ok)
        if not (accept and fresh and rate_ok):
            return
        slot = int(si[_S["gcount"]])
        c["gbuf"][slot] = params
        h["gwt"][slot], h["gkey_hi"][slot], h["gkey_lo"][slot] = wgt, key_hi, key_lo
        sf[1] = t_evt
        _bump(h["hist_edge"] if seam == "edge" else h["hist_glob"], tau)
        si[_S["gcount"]] += 1
        if si[_S["gcount"]] < K:
            return
        si[_S["gcount"]] = 0
        c["G"][ver + 1] = fold(c["gbuf"], h["gwt"], h["gkey_lo"], h["gkey_hi"], c["G"][ver])
        sf[0] = max(t_evt, sf[0])
        h["mint"][ver] = sf[0]
        nm.append(sf[0])
        ver += 1
        si[_S["version"]] = ver
        si[_S["merges"]] += 1
        h["gwt"][:] = 0.0
        h["gkey_hi"][:] = PAD_KEY
        h["gkey_lo"][:] = PAD_KEY

    for j in range(C):
        if not ev["live"][j]:
            continue
        i = int(ev["client"][j])
        adj = sum(1 for t in nm if t < ev["t_adopt"][j])
        v_a = max(int(base0[j]) + adj, int(prev0[j]))
        # a lane that adopted in-chunk mint `adj` is retrained from it
        pay = eng.retrain(s, j, v0 + adj) if adj else eng.payload[j]
        ok = bool(ev["send_ok"][j])
        t_arr = ev["t_arr"][j]
        khi, klo = int(ev["key_hi"][j]), int(ev["key_lo"][j])
        if not cfg.hier:
            tau = max(ver - v_a, 0)
            offer_global(ok, pay, samples[i] * _wt(wtab, tau), khi, klo, tau, t_arr, "edge")
            continue
        r = int(ev["r"][j])
        rv = int(rv0[j]) + sum(1 for t in nm if t < ev["t_radopt"][j])
        tau = max(rv - v_a, 0)
        fresh = tau <= cfg.max_staleness
        rate_ok = gap_r <= 0 or (t_arr - h["last_acc_r"][r]) >= gap_r
        si[_S["stale_edge"]] += int(ok and not fresh)
        si[_S["rate_edge"]] += int(ok and fresh and not rate_ok)
        if not (ok and fresh and rate_ok):
            continue
        slot = int(h["rcount"][r])
        c["rbuf"][r, slot] = pay
        h["rwt"][r, slot], h["rsamp"][r, slot] = samples[i] * _wt(wtab, tau), samples[i]
        h["rkey_hi"][r, slot], h["rkey_lo"][r, slot] = khi, klo
        h["last_acc_r"][r] = t_arr
        _bump(h["hist_edge"], tau)
        h["rcount"][r] += 1
        # >=: a churn epoch can shrink k below a part-filled window
        if h["rcount"][r] < ev["k_r"][j]:
            continue
        h["rcount"][r] = 0
        cur = c["G"][rv] if rv > h["radopt"][r] else c["rparams"][r]
        merged = fold(c["rbuf"][r], h["rwt"][r], h["rkey_lo"][r], h["rkey_hi"][r], cur)
        c["rparams"][r] = merged
        raw = np.float32(h["rsamp"][r].sum(dtype=np.float32))
        h["radopt"][r] = max(int(h["radopt"][r]), rv)
        si[_S["rmerges"]] += 1
        h["up_seq"][r] += 1
        up = int(h["up_seq"][r])
        h["rwt"][r], h["rsamp"][r], h["rkey_hi"][r], h["rkey_lo"][r] = 0.0, 0.0, PAD_KEY, PAD_KEY
        sidx = min(max(up - 1, 0), cfg.agg_key_stride - 1)
        if cfg.byz:
            ak = int(rg["akind"][r])
            if ak == 1:
                merged = -merged
            elif ak == 2:
                merged = eng.reg["alam"][r] * merged
            elif ak == 3:
                merged = merged + eng.reg["agg_noise"][int(rg["agg_noise_idx"][r, sidx])]
            si[_S["byz_agg"]] += int(ak > 0)
        agg_ok = bool(rg["send_ok"][r, sidx])
        t_agg = t_arr + rg["agg_delay"][r] + rg["jit"][r, sidx]
        si[_S["agg_drop"]] += int(not agg_ok)
        if cfg.dup:
            si[_S["dup_agg"]] += int(agg_ok and rg["dup"][r, sidx])
        tau_g = max(ver - rv, 0)
        offer_global(agg_ok, merged, raw * _wt(wtab, tau_g), r, up, tau_g, t_agg, "agg")
