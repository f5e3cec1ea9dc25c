"""Non-IID federated learning on the PyTorch port: FedAvg vs FedProx vs
SCAFFOLD vs FedOpt (BASELINE config 6).

The port of ``p2pfl_tpu/examples/heterogeneous.py``. Dirichlet(alpha)
shards give every node a skewed label distribution, the setting where
plain FedAvg drifts. The same federation runs under each algorithm and
the accuracy trajectories print side by side. The data is the MNIST IDX
files under ``P2PFL_MNIST_DIR`` when set, else the hard synthetic stand-in
(a multi-mode Gaussian mixture that takes about 10 rounds, so the
algorithms' differences show).

    python -m p2pfl_tpu_torch.examples.heterogeneous
    python -m p2pfl_tpu_torch.examples.heterogeneous --device cpu --rounds 2 --algos fedavg scaffold
"""

from __future__ import annotations

import argparse
import os
import sys

ALGOS = ("fedavg", "fedprox", "scaffold", "fedadam")


def run_one(algo: str, args) -> list[float]:
    """One federation under ``algo``; its test accuracy after each round."""
    from p2pfl_tpu_torch.learning.dataset import FederatedDataset
    from p2pfl_tpu_torch.models.vision import mlp
    from p2pfl_tpu_torch.parallel.spmd import SpmdFederation

    data = FederatedDataset.mnist(
        os.environ.get("P2PFL_MNIST_DIR"), modes=8, noise=0.7, proto_scale=0.5
    )
    kwargs: dict = {}
    if algo == "fedprox":
        kwargs["prox_mu"] = args.mu
    elif algo == "scaffold":
        kwargs.update(scaffold=True, optimizer="sgd", learning_rate=args.sgd_lr)
    elif algo == "fedadam":
        kwargs.update(server_opt="adam", server_lr=args.server_lr)
    elif algo != "fedavg":
        raise ValueError(f"unknown algorithm {algo}")

    fed = SpmdFederation.from_dataset(
        mlp(device=args.device),
        data,
        n_nodes=args.nodes,
        strategy="dirichlet",
        alpha=args.alpha,
        batch_size=args.batch_size,
        vote=False,
        seed=args.seed,
        device=args.device,
        **kwargs,
    )
    curve = []
    for _ in range(args.rounds):
        entry = fed.run_round(epochs=args.epochs, eval=True)
        curve.append(round(float(entry["test_acc"]), 4))
    return curve


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--nodes", type=int, default=8)
    parser.add_argument("--rounds", type=int, default=5)
    parser.add_argument("--epochs", type=int, default=1)
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--alpha", type=float, default=0.3, help="Dirichlet concentration")
    parser.add_argument("--mu", type=float, default=0.1, help="FedProx proximal strength")
    parser.add_argument("--server-lr", type=float, default=0.01, help="FedOpt server lr")
    parser.add_argument("--sgd-lr", type=float, default=0.05, help="SCAFFOLD local SGD lr")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--algos", nargs="+", default=list(ALGOS), choices=list(ALGOS))
    parser.add_argument("--device", default=None, help="torch device (default: cuda)")
    return parser.parse_args(argv)


def main(argv=None) -> dict:
    """Run every algorithm; returns ``{algo: accuracy curve}``."""
    args = parse_args(argv)
    print(f"Dirichlet({args.alpha}) x {args.nodes} nodes, {args.rounds} rounds", file=sys.stderr)
    results = {}
    for algo in args.algos:
        results[algo] = run_one(algo, args)
        print(f"{algo:>9}: {results[algo]}", flush=True)

    best = max(results, key=lambda a: results[a][-1])
    print(f"best final accuracy: {best} ({results[best][-1]})")
    return results


if __name__ == "__main__":
    main()
