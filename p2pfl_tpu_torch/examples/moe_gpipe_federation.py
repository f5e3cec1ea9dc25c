"""Federations that train through intra-node parallelism, on the PyTorch
port (BASELINE config 10's MoE and GPipe rows).

The port of ``p2pfl_tpu/examples/moe_gpipe_federation.py``:

- ``--mode moe``: N nodes federate a switch-style MoE transformer (8
  experts, top-2; the routers' balance losses ride the federated loss)
  through ``SpmdLmFederation`` on a ``(nodes, model)`` mesh: the
  node-stacked state splits over ``nodes`` and the expert stacks over
  ``model`` (``--expert-parallel`` slots a node).
- ``--mode gpipe``: each node's local training runs the GPipe-pipelined
  model (``--stages`` stages; microbatches stream through the layer
  stages) and the round closes with a sample-weighted FedAvg
  (``PipelineFederation``).

The mesh's positions repeat the device (``--device``, default the card):
one card holds every slot, as JAX's virtual CPU mesh does.

    python -m p2pfl_tpu_torch.examples.moe_gpipe_federation --mode moe
    python -m p2pfl_tpu_torch.examples.moe_gpipe_federation --mode gpipe --device cpu --nodes 2 --rounds 1 \\
        --samples 32
"""

from __future__ import annotations

import argparse
import time


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--mode", default="moe", choices=["moe", "gpipe"])
    parser.add_argument("--nodes", type=int, default=4)
    parser.add_argument("--rounds", type=int, default=4)
    parser.add_argument("--expert-parallel", type=int, default=2,
                        help="model-axis width for expert sharding (moe mode)")
    parser.add_argument("--stages", type=int, default=4, help="pipeline stages (gpipe mode)")
    parser.add_argument("--batch-size", type=int, default=16)
    parser.add_argument("--layers", type=int, default=4, help="transformer layers (moe mode; gpipe: --stages)")
    parser.add_argument("--dim", type=int, default=128)
    parser.add_argument("--seq-len", type=int, default=128)
    parser.add_argument("--samples", type=int, default=256, help="training sequences a node")
    parser.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = parser.parse_args(argv)

    from p2pfl_tpu_torch import resolve_device
    from p2pfl_tpu_torch.learning.dataset import FederatedDataset
    from p2pfl_tpu_torch.models.transformer import TransformerConfig, tiny_transformer

    t0 = time.monotonic()
    device = resolve_device(args.device)
    data = FederatedDataset.synthetic_lm(
        vocab_size=512, seq_len=args.seq_len, n_train=args.nodes * args.samples, n_test=256
    )
    if args.mode == "moe":
        from p2pfl_tpu_torch.parallel.mesh import federation_mesh
        from p2pfl_tpu_torch.parallel.spmd_lm import SpmdLmFederation

        cfg = TransformerConfig(
            vocab_size=512, dim=args.dim, n_layers=args.layers, n_heads=8, n_kv_heads=8,
            ffn_hidden=2 * args.dim, lora_rank=0, n_experts=8, moe_top_k=2,
        )
        model = tiny_transformer(seq_len=args.seq_len, cfg=cfg, device=device)
        ep = args.expert_parallel
        mesh = federation_mesh(args.nodes, model_parallel=ep, devices=[device] * (args.nodes * ep))
        fed = SpmdLmFederation.from_dataset(
            model, data, n_nodes=args.nodes, batch_size=args.batch_size, vote=False, mesh=mesh,
            expert_parallel=ep, device=device,
        )
        print(f"mesh: {dict(fed.mesh.shape)}")
        for _ in range(args.rounds):
            entry = fed.run_round(epochs=1)
            acc = fed.evaluate()["test_acc"]
            print(f"round {entry['round']}: loss {float(entry['train_loss']):.3f} next-token acc {acc:.3f}")
    else:
        from p2pfl_tpu_torch.parallel.pipeline import pipeline_mesh
        from p2pfl_tpu_torch.parallel.spmd_lm import PipelineFederation

        cfg = TransformerConfig(
            vocab_size=512, dim=args.dim, n_heads=8, n_kv_heads=8,
            ffn_hidden=344, lora_rank=0, n_layers=args.stages,
        )
        model = tiny_transformer(seq_len=args.seq_len, cfg=cfg, device=device)
        shards = [data.partition(i, args.nodes) for i in range(args.nodes)]
        mesh = pipeline_mesh(args.stages, devices=[device] * args.stages)
        fed = PipelineFederation(model, shards, mesh=mesh, batch_size=args.batch_size, device=device)
        print(f"mesh: {dict(fed.mesh.shape)}")
        for _ in range(args.rounds):
            entry = fed.run_round(epochs=1)
            acc = fed.evaluate()["test_acc"]
            print(f"round {entry['round']}: loss {entry['train_loss']:.3f} next-token acc {acc:.3f}")
    print(f"done in {time.monotonic() - t0:.1f}s")


if __name__ == "__main__":
    main()
