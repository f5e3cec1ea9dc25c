"""CIFAR-scale federated ResNet, SPMD mode, on the PyTorch port
(BASELINE configs 2 and 3).

The port of ``p2pfl_tpu/examples/spmd_cifar.py``: ResNet-18 on
CIFAR-10-shaped data (or ResNet-50 / CIFAR-100 with ``--large``),
non-IID Dirichlet shards, FedAvg or a robust aggregator, every node a
slice of node-stacked tensors on one device. The data is the synthetic
stand-in (no dataset is on disk and nothing is downloaded).

    python -m p2pfl_tpu_torch.examples.spmd_cifar --nodes 8 --rounds 2
    python -m p2pfl_tpu_torch.examples.spmd_cifar --large --measure_time
    python -m p2pfl_tpu_torch.examples.spmd_cifar --device cpu --nodes 2 --samples 256 --batch-size 16
"""

from __future__ import annotations

import argparse
import time


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--nodes", type=int, default=8)
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--epochs", type=int, default=1)
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--large", action="store_true", help="ResNet-50 / 100 classes")
    parser.add_argument("--aggregator", default="fedavg",
                        choices=["fedavg", "median", "trimmed_mean", "krum", "bulyan"])
    parser.add_argument("--alpha", type=float, default=0.5, help="Dirichlet concentration")
    parser.add_argument("--samples", type=int, default=16384)
    parser.add_argument("--measure_time", action="store_true")
    parser.add_argument("--device", default=None, help="torch device (default: cuda)")
    return parser.parse_args(argv)


def make_federation(args: argparse.Namespace):
    """The federation the flags describe: ResNet-18 (``--large``:
    ResNet-50, 100 classes) over Dirichlet shards of the synthetic
    CIFAR-shaped task."""
    from p2pfl_tpu_torch.learning.dataset import FederatedDataset
    from p2pfl_tpu_torch.models.vision import resnet18, resnet50
    from p2pfl_tpu_torch.parallel.spmd import SpmdFederation

    classes = 100 if args.large else 10
    model = (resnet50 if args.large else resnet18)(num_classes=classes, device=args.device)
    data = FederatedDataset.synthetic_mnist(  # CIFAR-shaped synthetic stand-in
        n_train=args.samples,
        n_test=max(args.samples // 8, 512),
        num_classes=classes,
        dim=(32, 32, 3),
    )
    return SpmdFederation.from_dataset(
        model,
        data,
        n_nodes=args.nodes,
        strategy="dirichlet",
        alpha=args.alpha,
        batch_size=args.batch_size,
        aggregator=args.aggregator,
        trim=max(args.nodes // 5, 1) if args.aggregator != "fedavg" else 0,
        vote=False,
        device=args.device,
    )


def main(argv=None) -> None:
    args = parse_args(argv)
    fed = make_federation(args)
    t0 = time.monotonic()
    for _ in range(args.rounds):
        entry = fed.run_round(epochs=args.epochs)
        metrics = fed.evaluate()
        print(
            f"round {entry['round']}: loss={float(entry['train_loss']):.4f} "
            f"acc={metrics['test_acc']:.4f}"
        )
    if args.measure_time:
        print(f"elapsed: {time.monotonic() - t0:.2f}s ({args.nodes} nodes, {fed.model.param_count/1e6:.1f}M params)")


if __name__ == "__main__":
    main()
