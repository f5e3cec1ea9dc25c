"""Aggregation kernels as torch ops (counterpart of ``p2pfl_tpu/ops/aggregation.py``).

Plain tensor code, as the JAX package left it to XLA: no hand kernel.
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
