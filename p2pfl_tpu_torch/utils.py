"""Simulation helpers (counterpart of ``p2pfl_tpu/utils.py``): the
supported way to script multi-node experiments."""

from __future__ import annotations

import time
from typing import Iterable

import torch

from p2pfl_tpu_torch.node import Node
from p2pfl_tpu_torch.ops.tree import tree_leaves
from p2pfl_tpu_torch.settings import set_test_settings  # noqa: F401 — re-export, as in JAX


def wait_convergence(
    nodes: Iterable[Node], n_neis: int, only_direct: bool = False, wait: float = 5.0
) -> None:
    """Block until every node sees ``n_neis`` neighbors (or raise)."""
    deadline = time.monotonic() + wait
    nodes = list(nodes)
    while time.monotonic() < deadline:
        if all(len(n.get_neighbors(only_direct=only_direct)) == n_neis for n in nodes):
            return
        time.sleep(0.05)
    counts = {n.addr: len(n.get_neighbors(only_direct=only_direct)) for n in nodes}
    raise AssertionError(f"Convergence not reached: {counts} (wanted {n_neis})")


def full_connection(node: Node, nodes: Iterable[Node]) -> None:
    """Directly connect ``node`` to every node in ``nodes``."""
    for other in nodes:
        if other.addr != node.addr:
            node.connect(other.addr)


def connect_line(nodes: list[Node]) -> None:
    """Line topology: node[i] → node[i+1]."""
    for a, b in zip(nodes, nodes[1:]):
        a.connect(b.addr)


def wait_to_finish(nodes: Iterable[Node], timeout: float = 120.0, min_experiments: int = 1) -> None:
    """Poll until every node has run ``min_experiments`` and is idle again."""
    deadline = time.monotonic() + timeout
    nodes = list(nodes)
    while time.monotonic() < deadline:
        if all(n.state.experiment_epoch >= min_experiments and n.state.round is None for n in nodes):
            return
        time.sleep(0.1)
    status = {n.addr: (n.state.experiment_epoch, n.state.round) for n in nodes}
    raise AssertionError(f"Nodes did not finish in {timeout}s: (epoch, round)={status}")


def check_equal_models(nodes: Iterable[Node], atol: float = 1e-1) -> None:
    """Assert all nodes hold (approximately) the same parameters."""
    params = [tree_leaves(n.learner.get_parameters()) for n in nodes]
    for other in params[1:]:
        assert len(params[0]) == len(other), "different model structures"
        for a, b in zip(params[0], other):
            torch.testing.assert_close(a.float().cpu(), b.float().cpu(), atol=atol, rtol=0)
