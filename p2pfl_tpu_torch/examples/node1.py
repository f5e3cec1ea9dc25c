"""Two-process gRPC demo, process 1 of 2: start a node and serve.

The port's ``p2pfl_tpu/examples/node1.py`` (the reference's
``p2pfl/examples/node1.py``): one OS process per node, meeting over real
sockets. Run this first, then ``node2`` with the same port:

    python -m p2pfl_tpu_torch.examples.node1 6666
    python -m p2pfl_tpu_torch.examples.node2 6666     # in another terminal

The node learns on the card unless ``--device cpu`` is given. It serves
until node2's experiment has run on it, then stops (exit 0); it exits 1
if none finished within ``--timeout`` seconds.
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="gRPC MNIST node (waits for node2)")
    parser.add_argument("port", type=int, help="port to listen on")
    parser.add_argument("--n_train", type=int, default=2048)
    parser.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    parser.add_argument("--timeout", type=float, default=600.0, help="seconds to wait for an experiment")
    args = parser.parse_args(argv)

    from p2pfl_tpu_torch.communication.grpc_transport import GrpcProtocol
    from p2pfl_tpu_torch.learning.dataset import FederatedDataset
    from p2pfl_tpu_torch.learning.learner import TorchLearner
    from p2pfl_tpu_torch.models.vision import mlp
    from p2pfl_tpu_torch.node import Node

    data = FederatedDataset.mnist(n_train=args.n_train, n_test=512)
    node = Node(
        learner=TorchLearner(mlp(seed=0, device=args.device), data.partition(0, 2), batch_size=64),
        protocol=GrpcProtocol(f"127.0.0.1:{args.port}"),
    )
    node.start()
    print(f"node1 listening on {node.addr} — start node2 now", flush=True)
    deadline = time.monotonic() + args.timeout
    try:
        while not (node.state.experiment_epoch >= 1 and node.state.round is None):
            if time.monotonic() > deadline:
                print("node1: no experiment finished in time", file=sys.stderr)
                return 1
            time.sleep(0.2)
        print(f"node1 done: {node.learner.evaluate()}", flush=True)
        return 0
    finally:
        node.stop()


if __name__ == "__main__":
    sys.exit(main())
