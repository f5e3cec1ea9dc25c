"""Count the initial-model sends of a config-8-shaped federation, on the CPU.

BASELINE config 8's federation (4 MLP nodes, full mesh, 2 rounds of 1
epoch, 2048 synthetic MNIST samples, batch 64) through either package, on
the memory transport or on gRPC over loopback. Every weights message a
node builds is counted by kind: ``init`` (``init_model``: a node pushing
the initial model to a peer that has not yet announced
``model_initialized``), ``own`` (one contributor) and ``aggregate``. Each
seed's run is a process of its own and prints one JSON line; the model
seeds are ``10 · seed + node``.

    JAX_PLATFORMS=cpu python3 init_model_sends.py --package torch jax --transport memory grpc --seeds 0 1 2 3 4
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def run_one(package: str, transport: str, seed: int) -> dict:
    if package == "jax":
        from p2pfl_tpu.communication import protocol
        from p2pfl_tpu.communication.memory import MemoryRegistry
        from p2pfl_tpu.learning.dataset import FederatedDataset
        from p2pfl_tpu.learning.learner import JaxLearner
        from p2pfl_tpu.models import mlp
        from p2pfl_tpu.node import Node
        from p2pfl_tpu.settings import set_test_settings
        from p2pfl_tpu.utils import full_connection, wait_convergence, wait_to_finish

        def learner(i, part):
            return JaxLearner(mlp(seed=10 * seed + i), part, batch_size=64)
    else:
        from p2pfl_tpu_torch.communication import protocol
        from p2pfl_tpu_torch.communication.memory import MemoryRegistry
        from p2pfl_tpu_torch.learning.dataset import FederatedDataset
        from p2pfl_tpu_torch.learning.learner import TorchLearner
        from p2pfl_tpu_torch.models.vision import mlp
        from p2pfl_tpu_torch.node import Node
        from p2pfl_tpu_torch.settings import set_test_settings
        from p2pfl_tpu_torch.utils import full_connection, wait_convergence, wait_to_finish

        def learner(i, part):
            return TorchLearner(mlp(seed=10 * seed + i, device="cpu"), part, batch_size=64, seed=i)
    if transport == "grpc":
        grpc_mod = __import__(f"{protocol.__name__.rsplit('.', 1)[0]}.grpc_transport", fromlist=["GrpcProtocol"])

    set_test_settings()
    MemoryRegistry.reset()
    kinds = {"init": 0, "own": 0, "aggregate": 0}
    cls = protocol.CommunicationProtocol
    real = cls.build_weights

    def counted(self, cmd, round, update):  # noqa: A002
        kind = "init" if cmd == "init_model" else "own" if len(update.contributors or []) == 1 else "aggregate"
        kinds[kind] += 1
        return real(self, cmd, round, update)

    cls.build_weights = counted
    data = FederatedDataset.synthetic_mnist(n_train=2048, n_test=512)
    nodes = []
    try:
        for i in range(4):
            kw = {"protocol": grpc_mod.GrpcProtocol("127.0.0.1:0")} if transport == "grpc" else {}
            nodes.append(Node(learner=learner(i, data.partition(i, 4)), **kw))
            nodes[-1].start()
        for node in nodes:
            full_connection(node, nodes)
        wait_convergence(nodes, 3, only_direct=True, wait=30)
        t0 = time.monotonic()
        nodes[0].set_start_learning(rounds=2, epochs=1)
        wait_to_finish(nodes, timeout=300)
        elapsed = time.monotonic() - t0
    finally:
        for node in nodes:
            node.stop()
        cls.build_weights = real
    return {"package": package, "transport": transport, "seed": seed, "sends": kinds, "elapsed_s": elapsed}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--package", nargs="+", choices=("torch", "jax"), default=["torch", "jax"])
    parser.add_argument("--transport", nargs="+", choices=("memory", "grpc"), default=["memory", "grpc"])
    parser.add_argument("--seeds", nargs="+", type=int, default=[0, 1, 2, 3, 4])
    parser.add_argument("--one", action="store_true", help="run one (package, transport, seed) here")
    args = parser.parse_args(argv)
    if args.one:
        print(json.dumps(run_one(args.package[0], args.transport[0], args.seeds[0])), flush=True)
        return 0
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    for transport in args.transport:
        for seed in args.seeds:
            for package in args.package:  # the packages alternate
                out = subprocess.run([sys.executable, __file__, "--one", "--package", package, "--transport",
                                      transport, "--seeds", str(seed)], capture_output=True, text=True, env=env,
                                     check=False)
                lines = [ln for ln in out.stdout.splitlines() if ln.startswith("{")]
                print(lines[-1] if lines else json.dumps({"package": package, "transport": transport, "seed": seed,
                                                          "failed": out.stderr[-500:]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
