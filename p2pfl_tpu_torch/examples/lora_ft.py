"""Federated LoRA fine-tuning of a causal LM (BASELINE config 5 shape), on
the PyTorch port.

The ``--spmd`` path of ``p2pfl_tpu/examples/lora_ft.py``: nodes train and
exchange only low-rank adapters, the whole federation runs as one
node-stacked program on one device. Synthetic Markov-chain text stands in
for a real corpus. The gossip path waits for the node slice of the port.

    python -m p2pfl_tpu_torch.examples.lora_ft --spmd --attn flash
    python -m p2pfl_tpu_torch.examples.lora_ft --spmd --device cpu --layers 2 --dim 128
"""

from __future__ import annotations

import argparse
import time


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--nodes", type=int, default=4)
    parser.add_argument("--rounds", type=int, default=3)
    parser.add_argument("--epochs", type=int, default=1)
    parser.add_argument("--seq-len", type=int, default=128)
    parser.add_argument("--dim", type=int, default=256)
    parser.add_argument("--layers", type=int, default=4)
    parser.add_argument("--rank", type=int, default=16)
    parser.add_argument("--batch-size", type=int, default=16)
    parser.add_argument("--lr", type=float, default=1e-2)
    parser.add_argument("--attn", choices=("dense", "flash"), default="dense")
    parser.add_argument("--spmd", action="store_true", help="one-program node-stacked mode")
    parser.add_argument("--device", default="cuda", help="cuda (kernels) or cpu (plain versions)")
    parser.add_argument("--measure_time", action="store_true")
    args = parser.parse_args(argv)
    if not args.spmd:
        parser.error("only --spmd is ported yet (the gossip Node path is ROADMAP Queue A 3)")

    from p2pfl_tpu_torch.learning.dataset import FederatedDataset
    from p2pfl_tpu_torch.models.transformer import TransformerConfig, tiny_transformer
    from p2pfl_tpu_torch.parallel.spmd_lora import SpmdLoraFederation

    cfg = TransformerConfig(
        dim=args.dim,
        n_layers=args.layers,
        n_heads=max(args.dim // 64, 2),
        n_kv_heads=max(args.dim // 128, 1),
        ffn_hidden=args.dim * 8 // 3,
        lora_rank=args.rank,
        lora_mlp=True,
    )
    data = FederatedDataset.synthetic_lm(vocab_size=cfg.vocab_size, seq_len=args.seq_len)
    t0 = time.monotonic()
    model = tiny_transformer(seq_len=args.seq_len, cfg=cfg, attn=args.attn, device=args.device)
    fed = SpmdLoraFederation.from_dataset(
        model, data, n_nodes=args.nodes, batch_size=args.batch_size,
        learning_rate=args.lr, vote=False, device=args.device,
    )
    for _ in range(args.rounds):
        entry = fed.run_round(epochs=args.epochs)
        metrics = fed.evaluate()
        print(
            f"round {entry['round']}: loss={float(entry['train_loss']):.4f} "
            f"next-token acc={metrics['test_acc']:.4f}"
        )
    if args.measure_time:
        print(f"elapsed: {time.monotonic() - t0:.2f}s")


if __name__ == "__main__":
    main()
