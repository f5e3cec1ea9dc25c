"""MNIST federated learning, SPMD mode, on the PyTorch port: the whole
federation as node-stacked tensors on one device.

The port of ``p2pfl_tpu/examples/spmd_mnist.py``: N logical nodes,
FedAvg (or a robust aggregator) as a reduction over the node axis. Use
``--nodes 64`` for the BASELINE north-star configuration. Data is
``FederatedDataset.mnist()``: the synthetic stand-in, nothing is
downloaded.

    python -m p2pfl_tpu_torch.examples.spmd_mnist --nodes 64
    python -m p2pfl_tpu_torch.examples.spmd_mnist --device cpu --nodes 4 --rounds 2
"""

from __future__ import annotations

import argparse
import time


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--nodes", type=int, default=8)
    parser.add_argument("--rounds", type=int, default=3)
    parser.add_argument("--epochs", type=int, default=1)
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--aggregator", default="fedavg",
                        choices=["fedavg", "median", "trimmed_mean", "krum", "bulyan"])
    parser.add_argument("--partition", default="iid", choices=["iid", "sorted", "dirichlet"])
    parser.add_argument("--vote", action="store_true", help="elect a train set (round 0)")
    parser.add_argument("--measure_time", action="store_true")
    parser.add_argument("--dp-clip", type=float, default=0.0, help="DP-SGD clip norm (0 = off)")
    parser.add_argument("--dp-noise", type=float, default=0.0, help="DP-SGD noise multiplier")
    parser.add_argument("--plot", nargs="?", const="spmd_mnist_metrics.png", default=None, metavar="PNG",
                        help="render the per-round loss/accuracy curves to PNG (needs matplotlib)")
    parser.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = parser.parse_args(argv)

    from p2pfl_tpu_torch.learning.dataset import FederatedDataset
    from p2pfl_tpu_torch.models.vision import mlp
    from p2pfl_tpu_torch.parallel.spmd import SpmdFederation

    data = FederatedDataset.mnist()
    fed = SpmdFederation.from_dataset(
        mlp(device=args.device),
        data,
        n_nodes=args.nodes,
        strategy=args.partition,
        batch_size=args.batch_size,
        aggregator=args.aggregator,
        vote=args.vote,
        dp_clip=args.dp_clip,
        dp_noise=args.dp_noise,
        device=args.device,
    )
    t0 = time.monotonic()
    history = []
    for _ in range(args.rounds):
        entry = fed.run_round(epochs=args.epochs)
        metrics = fed.evaluate()
        print(f"round {entry['round']}: loss={float(entry['train_loss']):.4f} acc={metrics['test_acc']:.4f}")
        history.append({**entry, "test_acc": float(metrics["test_acc"])})
    if args.plot:
        from p2pfl_tpu_torch.management.plotting import plot_history

        path = plot_history(history, args.plot, title=f"spmd {args.nodes} nodes")
        print(f"metric curves: {path or 'nothing to plot'}")
    if args.measure_time:
        print(f"elapsed: {time.monotonic() - t0:.2f}s ({args.nodes} nodes)")
    if fed.accountant is not None:
        print(f"privacy spent: eps={fed.accountant.epsilon(1e-5):.2f} (delta=1e-5)")


if __name__ == "__main__":
    main()
