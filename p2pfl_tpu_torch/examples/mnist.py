"""MNIST-shaped federated learning with gossip Nodes, on the PyTorch port.

``p2pfl_tpu/examples/mnist.py`` on the port: N Nodes in one process, each
with a ``TorchLearner`` on the 784-256-128-10 MLP and its own slot of
``submesh_federation_mesh(n, devices=[device] * n)``, connected (line or
full), then ``set_start_learning(rounds, epochs)``, ``wait_to_finish``
and ``evaluate()``. ``--protocol memory`` (the in-memory transport) or
``grpc`` (real loopback sockets, ``communication/grpc_transport.py``).
``--weights-plane ici`` moves model payloads slot to slot (kernel 9 on a
card, its plain version on the CPU) while control rides the transport;
``bytes`` hands the sender's tensors over by reference on the memory
transport and ships the P2TW codec over gRPC. ``--model-parallel m``
gives each node a ``(1, m)`` slice and shards its learner by
:data:`MLP_RULES` (sharded learners, ``parallel/sharding.py``): the ICI
plane then moves each leaf's per-slot shards. Data is
``FederatedDataset.synthetic_mnist``: nothing is downloaded.

    python -m p2pfl_tpu_torch.examples.mnist --weights-plane ici
    python -m p2pfl_tpu_torch.examples.mnist --device cpu --nodes 2 --rounds 1 --weights-plane ici
    python -m p2pfl_tpu_torch.examples.mnist --device cpu --protocol grpc
    python -m p2pfl_tpu_torch.examples.mnist --device cpu --model-parallel 2 --weights-plane ici
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, Optional

#: the MLP's Megatron-style rule set: the hidden dims column-, then
#: row-parallel (JAX's ``tests/test_submesh.py``)
MLP_RULES = (
    (r"Dense_0/kernel", (None, "model")),
    (r"Dense_1/kernel", ("model", None)),
    (r"Dense_2/kernel", (None, "model")),
    (r".*", ()),
)


def run(
    nodes: int = 2,
    rounds: int = 2,
    epochs: int = 1,
    samples: int = 8192,
    batch_size: int = 128,
    device: Optional[str] = "cuda",
    weights_plane: str = "bytes",
    topology: str = "line",
    timeout: float = 600.0,
    devices: Optional[list] = None,
    protocol: str = "memory",
    on_start: Optional[Callable] = None,
    n_test: Optional[int] = None,
    model_parallel: int = 1,
    partition_rules=None,
) -> dict:
    """Build, connect and run the federation; stop every node; return
    ``{"addrs", "params", "metrics", "round_s", "elapsed_s"}``: each
    node's final params (on its device) and test metrics, the seconds of
    each round as the initiator's round counter advanced (the first
    includes the initial-model sync and the vote), and the seconds from
    ``set_start_learning`` until every node finished; on ``"grpc"`` also
    ``"wire_stats"``, each node's transport counters. ``devices`` (one
    per node) places the nodes' slots on several cards instead of all on
    ``device``. ``on_start(fleet)``, when given, runs once the nodes are
    connected, before learning starts (a caller's probes and faults).
    ``n_test`` test samples (default ``max(samples // 8, 256)``).
    ``model_parallel > 1`` gives each node a ``(1, model_parallel)`` slice
    on its device and places its learner by ``partition_rules`` (None:
    :data:`MLP_RULES`)."""
    from p2pfl_tpu_torch import resolve_device
    from p2pfl_tpu_torch.learning.dataset import FederatedDataset
    from p2pfl_tpu_torch.learning.learner import TorchLearner
    from p2pfl_tpu_torch.models.vision import mlp
    from p2pfl_tpu_torch.node import Node
    from p2pfl_tpu_torch.parallel.mesh import node_slices, submesh_federation_mesh
    from p2pfl_tpu_torch.settings import Settings
    from p2pfl_tpu_torch.utils import connect_line, full_connection, wait_convergence, wait_to_finish

    devs = [resolve_device(d) for d in devices] if devices is not None else [resolve_device(device)] * nodes
    data = FederatedDataset.synthetic_mnist(n_train=samples, n_test=n_test or max(samples // 8, 256))
    slices = node_slices(submesh_federation_mesh(
        nodes, model_parallel, devices=[d for d in devs for _ in range(model_parallel)]))
    rules = None if model_parallel == 1 else (MLP_RULES if partition_rules is None else partition_rules)
    prev_plane, Settings.WEIGHTS_PLANE = Settings.WEIGHTS_PLANE, weights_plane
    fleet = []
    try:
        for i in range(nodes):
            learner = TorchLearner(
                mlp(seed=i, device=devs[i]), data.partition(i, nodes), batch_size=batch_size,
                seed=i, mesh=slices[i], partition_rules=rules,
            )
            if protocol == "grpc":
                from p2pfl_tpu_torch.communication.grpc_transport import GrpcProtocol

                fleet.append(Node(learner=learner, protocol=GrpcProtocol("127.0.0.1:0")))
            else:
                fleet.append(Node(learner=learner))
            fleet[-1].start()
        if topology == "full":
            for node in fleet:
                full_connection(node, fleet)
            wait_convergence(fleet, nodes - 1, only_direct=True, wait=30)
        else:
            connect_line(fleet)
            wait_convergence(fleet, nodes - 1, only_direct=False, wait=30)

        if on_start is not None:
            on_start(fleet)
        t0 = time.monotonic()
        fleet[0].set_start_learning(rounds=rounds, epochs=epochs)
        # round boundaries as the initiator sees them (its round counter)
        marks, seen = [t0], 0
        while fleet[0].state.experiment_epoch < 1 or fleet[0].state.round is not None:
            r = fleet[0].state.round
            if r is not None and r > seen:
                marks.append(time.monotonic())
                seen = r
            if time.monotonic() - t0 > timeout:
                break
            time.sleep(0.005)
        wait_to_finish(fleet, timeout=timeout)
        elapsed = time.monotonic() - t0
        if len(marks) <= rounds:  # a round end the polling did not see
            marks.append(t0 + elapsed)
        out = {
            "addrs": [n.addr for n in fleet],
            "params": [n.learner.get_parameters() for n in fleet],
            "metrics": [n.learner.evaluate() for n in fleet],
            "round_s": [b - a for a, b in zip(marks, marks[1:])],
            "elapsed_s": elapsed,
        }
        if protocol == "grpc":
            out["wire_stats"] = [dict(n.protocol.wire_stats) for n in fleet]
        return out
    finally:
        for node in fleet:
            node.stop()
        Settings.WEIGHTS_PLANE = prev_plane


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--nodes", type=int, default=2)
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--epochs", type=int, default=1)
    parser.add_argument("--batch-size", type=int, default=128)
    parser.add_argument("--samples", type=int, default=8192, help="total training samples")
    parser.add_argument("--topology", choices=("line", "full"), default="line")
    parser.add_argument("--protocol", choices=("memory", "grpc"), default="memory")
    parser.add_argument("--weights-plane", choices=("bytes", "ici"), default="bytes")
    parser.add_argument("--device", default="cuda", help="cuda (kernels) or cpu (plain versions)")
    parser.add_argument("--model-parallel", type=int, default=1, help="slots a node (sharded learners)")
    parser.add_argument("--measure_time", action="store_true")
    args = parser.parse_args(argv)

    out = run(
        nodes=args.nodes, rounds=args.rounds, epochs=args.epochs, samples=args.samples,
        batch_size=args.batch_size, device=args.device, weights_plane=args.weights_plane,
        topology=args.topology, protocol=args.protocol, model_parallel=args.model_parallel,
    )
    for addr, metrics in zip(out["addrs"], out["metrics"]):
        print(f"{addr}: {metrics}")
    if args.weights_plane == "ici":
        from p2pfl_tpu_torch.communication.ici import ici_stats

        print(f"ici: {ici_stats()}")
    if args.protocol == "grpc":
        print(f"wire: {out['wire_stats']}")
    if args.measure_time:
        print(f"elapsed: {out['elapsed_s']:.2f}s")


if __name__ == "__main__":
    main()
