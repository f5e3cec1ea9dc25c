"""Metric curves to PNG (counterpart of ``p2pfl_tpu/management/plotting.py``).

Per-node global curves (metric by round) and local curves (metric by step,
a panel a round) from the logger's metric stores, and an SPMD federation's
``history``, rendered headless with matplotlib's Agg backend. matplotlib
is optional: it is imported when a plot is drawn, never when this module
is imported.
"""

from __future__ import annotations

from typing import Optional


def _plt():
    import matplotlib

    matplotlib.use("Agg")  # render to a file, never to a display
    import matplotlib.pyplot as plt

    return plt


def plot_global_metrics(out_path: str, experiment: Optional[str] = None) -> Optional[str]:
    """Render per-node GLOBAL metric curves (metric vs round) to ``out_path``.

    Pulls from the logger's global metric store (one point per round per
    node, reference ``mnist.py:143-157``). Returns the written path, or
    None when the store has nothing to plot.
    """
    from p2pfl_tpu_torch.management.logger import logger

    logs = logger.get_global_logs()
    if not logs:
        return None
    exp = experiment if experiment is not None else sorted(logs)[0]
    per_node = logs.get(exp, {})
    if not per_node:
        return None
    metrics = sorted({m for node_metrics in per_node.values() for m in node_metrics})
    plt = _plt()
    fig, axes = plt.subplots(1, len(metrics), figsize=(6 * len(metrics), 4), squeeze=False)
    for ax, metric in zip(axes[0], metrics):
        for node in sorted(per_node):
            series = per_node[node].get(metric)
            if not series:
                continue
            rounds, values = zip(*series)
            ax.plot(rounds, values, marker="o", markersize=3, label=node)
            ax.scatter(rounds[-1], values[-1], color="red", zorder=3)
        ax.set_title(f"{exp} — {metric}")
        ax.set_xlabel("round")
        ax.set_ylabel(metric)
        ax.legend(fontsize=7)
        ax.grid(True, alpha=0.3)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def plot_local_metrics(out_path: str, experiment: Optional[str] = None) -> Optional[str]:
    """Render LOCAL (per-step) metric curves, one panel per round.

    Mirrors the reference's local-log loop (``mnist.py:124-141``): for each
    round, every node's per-step series (e.g. ``train_loss``) on one axis.
    """
    from p2pfl_tpu_torch.management.logger import logger

    logs = logger.get_local_logs()
    if not logs:
        return None
    exp = experiment if experiment is not None else sorted(logs)[0]
    rounds = logs.get(exp, {})
    if not rounds:
        return None
    plt = _plt()
    ordered = sorted(rounds)
    fig, axes = plt.subplots(1, len(ordered), figsize=(5 * len(ordered), 4), squeeze=False)
    for ax, rnd in zip(axes[0], ordered):
        for node in sorted(rounds[rnd]):
            for metric, series in sorted(rounds[rnd][node].items()):
                if not series:
                    continue
                steps, values = zip(*series)
                ax.plot(steps, values, label=f"{node}:{metric}")
                ax.scatter(steps[-1], values[-1], color="red", zorder=3)
        ax.set_title(f"round {rnd}")
        ax.set_xlabel("step")
        ax.legend(fontsize=7)
        ax.grid(True, alpha=0.3)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def plot_history(history: list, out_path: str, title: str = "federation") -> Optional[str]:
    """Render an SPMD federation's ``history`` (list of round dicts) to PNG.

    Every numeric key in the round entries (``train_loss``, ``test_acc``,
    ...) becomes one curve; x is the round number.
    """
    if not history:
        return None

    def _scalar(v):
        # round entries may carry device scalars (run_round keeps the loss
        # on the device); anything float() takes is plottable
        try:
            return float(v)
        except (TypeError, ValueError):
            return None

    # the numeric keys of every entry: a metric that first appears mid-run
    # (test_acc logged from round 2) still gets a curve
    keys = sorted(
        {k for e in history for k in e if k != "round" and _scalar(e[k]) is not None}
    )
    if not keys:
        return None
    plt = _plt()
    fig, axes = plt.subplots(1, len(keys), figsize=(6 * len(keys), 4), squeeze=False)
    rounds = [e.get("round", i + 1) for i, e in enumerate(history)]
    for ax, k in zip(axes[0], keys):
        values = [_scalar(e.get(k)) for e in history]
        pts = [(r, v) for r, v in zip(rounds, values) if v is not None]
        if not pts:
            continue
        xs, ys = zip(*pts)
        ax.plot(xs, ys, marker="o", markersize=3)
        ax.scatter(xs[-1], ys[-1], color="red", zorder=3)
        ax.set_title(f"{title} — {k}")
        ax.set_xlabel("round")
        ax.set_ylabel(k)
        ax.grid(True, alpha=0.3)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path
