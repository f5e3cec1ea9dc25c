"""A federation that trains through a mixture-of-experts LM, on the
PyTorch port (BASELINE config 10's MoE row).

The port of ``p2pfl_tpu/examples/moe_gpipe_federation.py``:

- ``--mode moe``: N nodes federate a switch-style MoE transformer (8
  experts, top-2; the routers' balance losses ride the federated loss)
  through ``SpmdLmFederation``, every node a slice of node-stacked
  tensors on one device. Expert parallelism over a mesh is not ported
  (ROADMAP Queue A item 5): the experts of a node stay on its device.
- ``--mode gpipe``: not ported (the GPipe stages need more than one
  device, ROADMAP Queue A item 5); it raises.

    python -m p2pfl_tpu_torch.examples.moe_gpipe_federation --mode moe
    python -m p2pfl_tpu_torch.examples.moe_gpipe_federation --mode moe --device cpu --nodes 2 --rounds 1 \\
        --layers 1 --dim 32 --seq-len 32 --samples 32
"""

from __future__ import annotations

import argparse
import time


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--mode", default="moe", choices=["moe", "gpipe"])
    parser.add_argument("--nodes", type=int, default=4)
    parser.add_argument("--rounds", type=int, default=4)
    parser.add_argument("--batch-size", type=int, default=16)
    parser.add_argument("--layers", type=int, default=4)
    parser.add_argument("--dim", type=int, default=128)
    parser.add_argument("--seq-len", type=int, default=128)
    parser.add_argument("--samples", type=int, default=256, help="training sequences a node")
    parser.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = parser.parse_args(argv)

    from p2pfl_tpu_torch.parallel.spmd import _not_ported

    if args.mode == "gpipe":
        raise _not_ported("the GPipe federation (--mode gpipe: pipeline stages over several devices)", "5")

    from p2pfl_tpu_torch.learning.dataset import FederatedDataset
    from p2pfl_tpu_torch.models.transformer import TransformerConfig, tiny_transformer
    from p2pfl_tpu_torch.parallel.spmd_lm import SpmdLmFederation

    t0 = time.monotonic()
    cfg = TransformerConfig(
        vocab_size=512, dim=args.dim, n_layers=args.layers, n_heads=8, n_kv_heads=8,
        ffn_hidden=2 * args.dim, lora_rank=0, n_experts=8, moe_top_k=2,
    )
    model = tiny_transformer(seq_len=args.seq_len, cfg=cfg, device=args.device)
    data = FederatedDataset.synthetic_lm(
        vocab_size=512, seq_len=args.seq_len, n_train=args.nodes * args.samples, n_test=256
    )
    fed = SpmdLmFederation.from_dataset(
        model, data, n_nodes=args.nodes, batch_size=args.batch_size, vote=False, device=args.device
    )
    print(f"{args.nodes} nodes on {fed.device}, {model.param_count / 1e6:.1f}M params a node")
    for _ in range(args.rounds):
        entry = fed.run_round(epochs=1)
        acc = fed.evaluate()["test_acc"]
        print(f"round {entry['round']}: loss {float(entry['train_loss']):.3f} next-token acc {acc:.3f}")
    print(f"done in {time.monotonic() - t0:.1f}s")


if __name__ == "__main__":
    main()
