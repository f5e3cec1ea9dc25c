"""Aggregation kernels as torch ops (counterpart of ``p2pfl_tpu/ops/aggregation.py``).

Plain tensor code, as the JAX package left it to XLA: no hand kernel.
The async buffer's merge programs (``buffered_robust_merge``,
``krum_screen_merge``, ``screen_stats``, ``server_merge``) sit at the end.
Every function works on node-stacked trees (leaves ``[N, ...]``) and
keeps the device: nothing reads a value back to the host, so a round
that aggregates stays one queue of launches.

Where torch's defaults differ from JAX's, the code follows JAX:
``jnp.median`` averages the two middle values of an even count
(``torch.median`` returns the lower), and ``jax.lax.top_k`` breaks ties
by the lower index (a stable sort does too; ``torch.topk`` leaves the
order of ties unspecified).
"""

from __future__ import annotations

import torch

from p2pfl_tpu_torch.ops.tree import tree_items, tree_leaves, tree_map, tree_unflatten


def fedavg(stacked: dict, weights: torch.Tensor, agg_dtype: str = "float32") -> dict:
    """Sample-weighted mean over the leading axis; ``weights`` [N] are
    unnormalized sample counts. Normalize, then one weighted contraction
    per leaf in ``agg_dtype``, cast back to the leaf's dtype."""
    acc = getattr(torch, agg_dtype)
    w = weights.to(acc)
    w = w / w.sum()
    return tree_map(
        lambda x: torch.tensordot(w.to(x.device), x.to(acc), dims=([0], [0])).to(x.dtype), stacked
    )


def fedavg_fold_acc(
    psum: dict, wsum: torch.Tensor, others: tuple, weights: torch.Tensor, ref: dict,
    agg_dtype: str = "float32",
) -> dict:
    """Finish a FedAvg whose first term is a folded accumulator.

    ``(psum, wsum)`` is a node's own ``weight × params`` in ``agg_dtype``
    (folded inside the fused round, ``parallel/spmd.py::fused_node_round``);
    ``others`` the remaining contributions' trees with ``weights`` their
    ``[k]`` sample counts (k may be 0); ``ref`` gives the output dtypes.
    The peers stack into one weighted contraction a leaf, added to the
    running sum, then one divide: accumulate-then-divide, where
    :func:`fedavg` normalizes first, so the two agree to summation-order
    ulps in ``agg_dtype``, and bit for bit where every weight is the same
    power of two."""
    from p2pfl_tpu_torch.parallel.sharding import from_shard_flat, place_like, shard_flat, tree_is_placed

    if tree_is_placed(psum):
        # a placed accumulator folds shard by shard: shard k of every
        # contribution (each conformed to the accumulator's layout first)
        # makes shard k of the aggregate, and no leaf is gathered whole
        flat = fedavg_fold_acc(
            shard_flat(psum), wsum, tuple(shard_flat(place_like(o, psum)) for o in others), weights,
            shard_flat(place_like(ref, psum)), agg_dtype,
        )
        return from_shard_flat(flat, place_like(ref, psum))
    acc = getattr(torch, agg_dtype)
    if others:
        w = weights.to(device=wsum.device, dtype=acc)
        stacked = tree_map(lambda *xs: torch.stack(xs), *others)
        psum = tree_map(
            lambda s, x: s + torch.tensordot(w, x.to(acc), dims=([0], [0])), psum, stacked
        )
        wsum = wsum + w.sum()
    return tree_map(lambda s, r: (s / wsum).to(r.dtype), psum, ref)


def sum_nodes(x) -> torch.Tensor:
    """The sum over the leading node axis, node by node in order: one
    elementwise add a node, so an element's sum does not depend on the
    shape of the tensor it sits in (a reduction kernel's order may), and
    a stack of slot shards sums to the bits of the whole. ``x`` is one
    ``[N, ...]`` stack or a list of row blocks ``[n_r, ...]`` in node
    order, possibly on several devices: the order carries from block to
    block, so any split into rows sums to the one stack's bits, on the
    last block's device."""
    out = None
    for b in ([x] if isinstance(x, torch.Tensor) else x):
        for i in range(b.shape[0]):
            out = b[i] if out is None else out.to(b.device) + b[i]
    return out


def fedavg_fold_stacked(stacked_psum: dict, stacked_wsum: torch.Tensor, ref: dict) -> dict:
    """Finish a FedAvg from node-stacked accumulators: ``[N, ...]`` leaves
    of per-node ``weight × params`` and their ``[N]`` weights. Sum the
    node axis (:func:`sum_nodes`), then divide (the
    :func:`fedavg_fold_acc` algebra); ``ref`` gives the output dtypes.
    Elementwise, so shard k of the stacked accumulators folds into
    shard k of the aggregate (``parallel/submesh.py``)."""
    wtot = stacked_wsum.sum()
    return tree_map(lambda s, r: (sum_nodes(s) / wtot).to(r.dtype), stacked_psum, ref)


def robust_fold_stacked(stacked: dict, ref: dict, kind: str, *, trim: int = 1) -> dict:
    """Robust per-coordinate fold over node-stacked params, the robust
    twin of :func:`fedavg_fold_stacked`: ``stacked`` leaves are ``[N, ...]``
    stacks of per-node PARAMS (raw models: a median of ``weight × params``
    terms is not a median of models), ``kind`` ``"median"`` or
    ``"trimmed-mean"`` (``trim`` lowest and highest dropped a coordinate,
    clamped so one survives; none left to drop is the plain mean), the
    rank statistics in fp32 (the means summed node by node,
    :func:`sum_nodes`), the output in ``ref``'s dtypes. Per coordinate,
    so a stack of slot shards folds into the aggregate's shards
    (``parallel/submesh.py``)."""
    n = stacked_n(stacked)
    if kind == "median":
        return tree_map(lambda x, r: median0(x).to(r.dtype), stacked, ref)
    if kind == "trimmed-mean":
        t = min(int(trim), (n - 1) // 2)
        if t <= 0:
            return tree_map(lambda x, r: (sum_nodes(x.float()) / n).to(r.dtype), stacked, ref)

        def tm(x, r):
            xs = x.float().sort(dim=0).values
            return (sum_nodes(xs[t:n - t]) / (n - 2 * t)).to(r.dtype)

        return tree_map(tm, stacked, ref)
    raise ValueError(f"unknown robust fold kind {kind!r} (expected median | trimmed-mean)")


def median0(x: torch.Tensor) -> torch.Tensor:
    """``jnp.median(x.float(), axis=0)``: sort, ``(low + high) · 0.5`` of
    the middle pair (one value for an odd count), NaN where a column
    holds one."""
    k = x.shape[0]
    s = x.float().sort(dim=0).values
    med = (s[(k - 1) // 2] + s[k // 2]) * 0.5
    return torch.where(torch.isnan(x).any(dim=0), torch.full_like(med, float("nan")), med)


def fedmedian(stacked: dict) -> dict:
    """Coordinate-wise median across the node axis."""
    return tree_map(lambda x: median0(x).to(x.dtype), stacked)


def trimmed_mean(stacked: dict, trim: int) -> dict:
    """Coordinate-wise trimmed mean: drop ``trim`` lowest and highest per
    coordinate (``2 * trim < N``). Robust to ``trim`` Byzantine nodes."""

    def tm(x: torch.Tensor) -> torch.Tensor:
        n = x.shape[0]
        s = x.float().sort(dim=0).values
        return s[trim:n - trim].mean(dim=0).to(x.dtype)

    return tree_map(tm, stacked)


def _flatten_nodes(stacked: dict) -> torch.Tensor:
    """[N, ...] tree -> [N, P] matrix of all params per node (fp32)."""
    return torch.cat([x.float().reshape(x.shape[0], -1) for x in tree_leaves(stacked)], dim=1)


def krum_select(stacked: dict, n_byzantine: int, multi: int = 1) -> torch.Tensor:
    """Krum / Multi-Krum: indices of the ``multi`` nodes with the lowest
    score (sum of squared distances to their ``N - f - 2`` nearest
    neighbours), lowest index first among equal scores. The [N, N]
    distances are one matmul: ``|a-b|² = |a|² + |b|² - 2ab``."""
    flat = _flatten_nodes(stacked)
    n = flat.shape[0]
    sq = (flat * flat).sum(dim=1)
    d2 = (sq[:, None] + sq[None, :] - 2.0 * (flat @ flat.T)).clamp_min(0.0)
    d2.fill_diagonal_(float("inf"))
    k = max(n - n_byzantine - 2, 1)
    scores = d2.sort(dim=1).values[:, :k].sum(dim=1)
    return torch.sort(scores, stable=True).indices[:multi]


def krum(stacked: dict, n_byzantine: int, multi: int = 1) -> dict:
    """(Multi-)Krum aggregate: mean of the ``multi`` selected node models."""
    idx = krum_select(stacked, n_byzantine, multi)
    return tree_map(lambda x: x.index_select(0, idx).float().mean(dim=0).to(x.dtype), stacked)


def bulyan(stacked: dict, n_byzantine: int) -> dict:
    """Bulyan (El Mhamdi et al. 2018): θ = N − 2f models picked one at a
    time by Krum, each pick re-scored on what is left, then a β = f
    trimmed mean per coordinate. Tolerates f Byzantine among N ≥ 4f + 3.

    Every shape is fixed by N and f: a removal keeps the ``N − i − 1``
    rows around the pick by an index shift, so the picks stay on the
    device (the JAX round program's form)."""
    n = tree_leaves(stacked)[0].shape[0]
    f = n_byzantine
    if n < 4 * f + 3:
        raise ValueError(f"Bulyan needs N >= 4f + 3 (N={n}, f={f})")
    device = tree_leaves(stacked)[0].device
    cur = stacked
    orig = torch.arange(n, device=device)
    chosen = []
    for i in range(n - 2 * f):
        idx = krum_select(cur, n_byzantine=f, multi=1)[0]
        chosen.append(orig[idx])
        pos = torch.arange(n - i - 1, device=device)
        keep = torch.where(pos < idx, pos, pos + 1)  # skip the pick
        cur = tree_map(lambda x: x.index_select(0, keep), cur)
        orig = orig.index_select(0, keep)
    sel = torch.stack(chosen)
    return trimmed_mean(tree_map(lambda x: x.index_select(0, sel), stacked), trim=f)


def centered_clip(stacked: dict, center: dict, tau: float, iters: int = 3) -> dict:
    """Centered clipping (Karimireddy, He, Jaggi 2021): ``v ← v + mean_i
    clip_tau(x_i − v)`` iterated from ``v = center``, each node's
    whole-model deviation rescaled to norm ≤ τ. fp32 throughout."""
    paths = [p for p, _ in tree_items(stacked)]
    xs = [x.float() for x in tree_leaves(stacked)]
    v = [c.float() for c in tree_leaves(center)]

    def norms(v_leaves):
        sq = sum(((x - c[None]) ** 2).sum(dim=tuple(range(1, x.dim()))) for x, c in zip(xs, v_leaves))
        return torch.sqrt(torch.clamp(sq, min=1e-24))

    for _ in range(iters):
        s = torch.clamp(tau / norms(v), max=1.0)  # [N] clip factors
        v = [
            c + (s.reshape((-1,) + (1,) * (x.dim() - 1)) * (x - c[None])).mean(dim=0)
            for x, c in zip(xs, v)
        ]
    return tree_unflatten({p: c.to(x.dtype) for p, c, x in zip(paths, v, tree_leaves(stacked))})


FEDOPT = ("adam", "yogi", "adagrad")


def fedopt_update(
    prev: dict, avg: dict, m: dict, v: dict, t: torch.Tensor, opt: str = "adam",
    lr: float = 0.1, b1: float = 0.9, b2: float = 0.99, tau: float = 1e-3,
) -> tuple[dict, dict, dict]:
    """FedOpt server step (Reddi et al. 2021): ``prev - avg`` is a
    pseudo-gradient for a server-side adaptive optimizer, ``"adam"``
    (FedAdam), ``"yogi"`` (FedYogi) or ``"adagrad"`` (FedAdagrad).
    ``m``/``v`` are the server's moments; ``t`` the 1-based server step
    (a fp32 tensor) for Adam's bias correction. Returns ``(new_params,
    new_m, new_v)``."""
    if opt not in FEDOPT:
        raise ValueError(f"unknown server opt {opt!r}")

    def one(p, a, mi, vi):
        g = p.float() - a.float()  # pseudo-grad
        mn = b1 * mi + (1.0 - b1) * g
        g2 = g * g
        if opt == "adam":
            vn = b2 * vi + (1.0 - b2) * g2
            mhat, vhat = mn / (1.0 - b1 ** t), vn / (1.0 - b2 ** t)
        elif opt == "yogi":
            vn = vi - (1.0 - b2) * g2 * torch.sign(vi - g2)
            mhat, vhat = mn, vn
        else:
            vn = vi + g2
            mhat, vhat = mn, vn
        new = p.float() - lr * mhat / (torch.sqrt(vhat) + tau)
        return new.to(p.dtype), mn, vn

    paths = [p for p, _ in tree_items(prev)]
    out = [one(*leaves) for leaves in zip(*(tree_leaves(tr) for tr in (prev, avg, m, v)))]

    def tree(i):
        return tree_unflatten({p: o[i] for p, o in zip(paths, out)})

    return tree(0), tree(1), tree(2)


# ---- the async buffer's merge programs (federation/buffer.py) ----


def stacked_n(stacked: dict) -> int:
    """Node-axis length of a stacked tree."""
    return tree_leaves(stacked)[0].shape[0]


def krum_screen_merge(stacked: dict, weights: torch.Tensor, f: int) -> dict:
    """Krum screening + weighted mean: drop the ``f`` most outlying
    contributions (Multi-Krum with ``multi = N − f``), then fold the
    survivors with the caller's weights (for the async buffer the
    staleness weights ``num_samples × w(τ)``), in the selection's order."""
    idx = krum_select(stacked, n_byzantine=f, multi=stacked_n(stacked) - f)
    w = weights.to(device=idx.device, dtype=torch.float32).index_select(0, idx)
    w = w / w.sum()
    return tree_map(
        lambda x: torch.tensordot(w, x.index_select(0, idx).float(), dims=([0], [0])).to(x.dtype), stacked
    )


def buffered_robust_merge(
    stacked: dict, weights: torch.Tensor, kind: str, *, trim: int = 1, f: int = 1, agg_dtype: str = "float32",
) -> dict:
    """The async buffer's flush fold, selected by ``Settings.ASYNC_ROBUST_AGG``:
    ``"fedavg"`` (the staleness-weighted mean), ``"trimmed-mean"`` /
    ``"median"`` (per-coordinate rank rules: they ignore the weights, a
    weighted rank rule loses its breakdown point) or ``"krum-screen"``
    (Krum drops ``f`` outliers, the weighted mean folds the rest).
    ``trim`` and ``f`` are clamped so one contribution survives; below
    that the mean of what there is folds. Every branch folds the same
    ``(origin, seq)``-sorted stack."""
    n = stacked_n(stacked)
    if kind == "fedavg" or n == 1:
        return fedavg(stacked, weights, agg_dtype=agg_dtype)
    if kind == "trimmed-mean":
        t = min(int(trim), (n - 1) // 2)
        if t <= 0:
            return fedavg(stacked, weights, agg_dtype=agg_dtype)
        return trimmed_mean(stacked, t)
    if kind == "median":
        return fedmedian(stacked)
    if kind == "krum-screen":
        fc = min(int(f), n - 1)
        # Krum scores against N − f − 2 neighbours: below that the screen
        # cannot rank and the mean is all there is
        if fc <= 0 or n - fc - 2 < 1:
            return fedavg(stacked, weights, agg_dtype=agg_dtype)
        return krum_screen_merge(stacked, weights, fc)
    raise ValueError(
        f"unknown ASYNC_ROBUST_AGG {kind!r} (expected fedavg | trimmed-mean | median | krum-screen)"
    )


def screen_stats(params: dict, ref: dict) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The admission screen's statistics of one contribution against the
    current global: ``(‖params‖₂, ‖ref‖₂, cos(params, ref))``, fp32 sums
    accumulated leaf by leaf in leaf order, on the params' device."""
    dot = p2 = r2 = None
    for x, y in zip(tree_leaves(params), tree_leaves(ref)):
        xf = x.float().reshape(-1)
        yf = y.float().reshape(-1).to(xf.device)
        terms = (torch.dot(xf, yf), torch.dot(xf, xf), torch.dot(yf, yf))
        if dot is None:
            dot, p2, r2 = terms
        else:
            dot, p2, r2 = dot + terms[0], p2 + terms[1], r2 + terms[2]
    pn = torch.sqrt(torch.clamp(p2, min=1e-24))
    rn = torch.sqrt(torch.clamp(r2, min=1e-24))
    return pn, rn, dot / (pn * rn)


def server_merge(prev: dict, avg: dict, lr: float = 1.0, agg_dtype: str = "float32") -> dict:
    """FedBuff server step ``new = (1−η)·prev + η·avg`` in ``agg_dtype``;
    output dtypes and devices follow ``prev``."""
    acc = getattr(torch, agg_dtype)

    def mix(p: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
        return ((1.0 - lr) * p.to(acc) + lr * a.to(device=p.device, dtype=acc)).to(p.dtype)

    return tree_map(mix, prev, avg)
