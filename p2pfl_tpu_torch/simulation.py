"""A federation in one call, for simulations and scripts (counterpart of
``p2pfl_tpu/simulation.py``).

N in-process Nodes on a chosen topology, started, connected and ready to
learn. Gossip mode only: the one-program fast path is
:class:`p2pfl_tpu_torch.parallel.spmd.SpmdFederation`. Re-exports
:class:`SimulatedAsyncFleet`, the 1k-node simulated async fleet, as the
JAX module does.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

from p2pfl_tpu_torch.federation.simfleet import FleetResult, SimulatedAsyncFleet  # noqa: F401 — re-export
from p2pfl_tpu_torch.learning.dataset import FederatedDataset
from p2pfl_tpu_torch.management.logger import logger
from p2pfl_tpu_torch.node import Node
from p2pfl_tpu_torch.utils import connect_line, full_connection, wait_convergence, wait_to_finish


class Simulation:
    """N in-process nodes on a chosen topology, ready to learn.

    ``learner_fn(i, shard) -> learner`` builds each node's learner;
    ``topology`` is ``"line" | "ring" | "full" | "star"``.
    """

    def __init__(
        self,
        n_nodes: int,
        learner_fn: Callable[[int, FederatedDataset], Any],
        dataset: FederatedDataset,
        topology: str = "line",
        partition: str = "iid",
        alpha: float = 0.5,
        aggregator_fn: Optional[Callable[[], Any]] = None,
        protocol_fn: Optional[Callable[[], Any]] = None,
    ) -> None:
        self.nodes: list[Node] = []
        for i in range(n_nodes):
            shard = dataset.partition(i, n_nodes, partition, alpha)
            self.nodes.append(
                Node(
                    learner=learner_fn(i, shard),
                    aggregator=aggregator_fn() if aggregator_fn else None,
                    protocol=protocol_fn() if protocol_fn else _default_protocol(),
                )
            )
        self.topology = topology

    def start(self, wait: float = 10.0) -> "Simulation":
        for node in self.nodes:
            node.start()
        n = len(self.nodes)
        if self.topology == "line":
            connect_line(self.nodes)
        elif self.topology == "ring":
            connect_line(self.nodes)
            if n > 2:
                self.nodes[-1].connect(self.nodes[0].addr)
        elif self.topology == "full":
            for node in self.nodes:
                full_connection(node, self.nodes)
        elif self.topology == "star":
            for leaf in self.nodes[1:]:
                leaf.connect(self.nodes[0].addr)
        else:
            raise ValueError(f"unknown topology {self.topology!r}")
        wait_convergence(self.nodes, n - 1, only_direct=False, wait=wait)
        return self

    def learn(self, rounds: int = 1, epochs: int = 1, timeout: float = 600.0) -> "Simulation":
        """Run one experiment and wait for every node to finish it (a
        later call runs the next experiment on the same nodes). Under
        ``Settings.FEDERATION_MODE="async"`` the same call drives the async
        control plane: ``rounds`` is then each node's local update budget;
        for 1k+-node virtual fleets use :class:`SimulatedAsyncFleet`."""
        done = min(n.state.experiment_epoch for n in self.nodes)
        self.nodes[0].set_start_learning(rounds=rounds, epochs=epochs)
        wait_to_finish(self.nodes, timeout=timeout, min_experiments=done + 1)
        return self

    def evaluate(self) -> dict[str, dict[str, float]]:
        return {n.addr: n.learner.evaluate() for n in self.nodes}

    def metrics(self):
        """Global (per-round) metric store contents for this process."""
        return logger.get_global_logs()

    def stop(self) -> None:
        for node in self.nodes:
            node.stop()


def _default_protocol():
    from p2pfl_tpu_torch.communication.memory import InMemoryProtocol

    return InMemoryProtocol()
