"""Two-process gRPC demo, process 2 of 2: connect to node1 and learn.

The port's ``p2pfl_tpu/examples/node2.py``. Start ``node1`` first; this
process connects over real sockets, starts federated learning on both
nodes, prints its test metrics and stops:

    python -m p2pfl_tpu_torch.examples.node2 6666 --rounds 2

The node learns on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="gRPC MNIST node (connects to node1)")
    parser.add_argument("port", type=int, help="node1's port")
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--epochs", type=int, default=1)
    parser.add_argument("--n_train", type=int, default=2048)
    parser.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = parser.parse_args(argv)

    from p2pfl_tpu_torch.communication.grpc_transport import GrpcProtocol
    from p2pfl_tpu_torch.learning.dataset import FederatedDataset
    from p2pfl_tpu_torch.learning.learner import TorchLearner
    from p2pfl_tpu_torch.models.vision import mlp
    from p2pfl_tpu_torch.node import Node

    data = FederatedDataset.mnist(n_train=args.n_train, n_test=512)
    node = Node(
        learner=TorchLearner(mlp(seed=1, device=args.device), data.partition(1, 2), batch_size=64, seed=1),
        protocol=GrpcProtocol("127.0.0.1:0"),
    )
    node.start()
    try:
        if not node.connect(f"127.0.0.1:{args.port}"):
            print("could not connect to node1 — is it running?", file=sys.stderr)
            return 1
        time.sleep(1)  # let heartbeats converge membership
        node.set_start_learning(rounds=args.rounds, epochs=args.epochs)
        while node.state.round is not None or node.learning_active():
            time.sleep(0.2)
        print(f"done: {node.learner.evaluate()}", flush=True)
        return 0
    finally:
        node.stop()


if __name__ == "__main__":
    sys.exit(main())
