"""Privacy or bandwidth on the 4-node MNIST federation, on the PyTorch port
(``p2pfl_tpu/examples/secure_mnist.py``):

- ``--mode secagg``: pairwise-masked contributions with DH key agreement
  over the gossip overlay (``learning/secagg.py``): no node's model
  crosses the wire in the clear, and the FedAvg aggregate is unchanged;
- ``--mode topk8``: top-k int8 deltas with error feedback
  (``learning/weights.py``), about 16x smaller payloads;
- ``--mode int8``: dense int8 payloads (4x smaller).

With ``--protocol grpc`` each node's measured weight-plane egress is
printed. Data is ``FederatedDataset.synthetic_mnist``; nothing is
downloaded.

    python -m p2pfl_tpu_torch.examples.secure_mnist --mode secagg
    python -m p2pfl_tpu_torch.examples.secure_mnist --mode topk8 --protocol grpc
    python -m p2pfl_tpu_torch.examples.secure_mnist --device cpu --mode topk8
"""

from __future__ import annotations

import argparse
from typing import Callable, Optional


def run(
    mode: str = "secagg",
    nodes: int = 4,
    rounds: int = 2,
    epochs: int = 1,
    samples: int = 4096,
    batch_size: int = 64,
    device: Optional[str] = "cuda",
    protocol: str = "memory",
    weights_plane: str = "bytes",
    timeout: float = 600.0,
    on_start: Optional[Callable] = None,
) -> dict:
    """The federation of ``examples/mnist.py::run`` (full topology) under
    ``Settings.SECURE_AGGREGATION`` (``mode="secagg"``) or
    ``Settings.WIRE_COMPRESSION = mode``; both settings are restored
    after. Returns ``mnist.run``'s dict."""
    from p2pfl_tpu_torch.examples import mnist
    from p2pfl_tpu_torch.settings import Settings

    if mode not in ("secagg", "topk8", "int8"):
        raise ValueError(f"unknown mode {mode!r}")
    prev = Settings.SECURE_AGGREGATION, Settings.WIRE_COMPRESSION
    if mode == "secagg":
        Settings.SECURE_AGGREGATION = True  # needs the lossless wire
    else:
        Settings.WIRE_COMPRESSION = mode
    try:
        return mnist.run(
            nodes=nodes, rounds=rounds, epochs=epochs, samples=samples, batch_size=batch_size,
            device=device, weights_plane=weights_plane, topology="full", timeout=timeout,
            protocol=protocol, on_start=on_start,
        )
    finally:
        Settings.SECURE_AGGREGATION, Settings.WIRE_COMPRESSION = prev


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--mode", choices=["secagg", "topk8", "int8"], default="secagg")
    parser.add_argument("--nodes", type=int, default=4)
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--epochs", type=int, default=1)
    parser.add_argument("--protocol", choices=["memory", "grpc"], default="memory")
    parser.add_argument("--samples", type=int, default=4096)
    parser.add_argument("--device", default="cuda", help="cuda (kernels) or cpu (plain versions)")
    args = parser.parse_args(argv)

    out = run(
        mode=args.mode, nodes=args.nodes, rounds=args.rounds, epochs=args.epochs,
        samples=args.samples, device=args.device, protocol=args.protocol,
    )
    for i, (addr, metrics) in enumerate(zip(out["addrs"], out["metrics"])):
        line = f"{addr}: {metrics}"
        if "wire_stats" in out:
            line += f"  egress: {out['wire_stats'][i]['weights_bytes'] / 1e6:.2f} MB weights"
        print(line)


if __name__ == "__main__":
    main()
