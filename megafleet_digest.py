"""Run the 1M-client megafleet once on the card and print its final model's digest.

``bench_async.py``'s megafleet_1m row (``FleetSpec.synth(1_000_000,
seed=1905, slow_frac=0.1)``, dim 16, clusters of 1024, K 64, 4 updates a
client, local lr 0.7, 256 events a chunk) through ``MegaFleet.run`` of the
``p2pfl_tpu_torch`` package under ``--root`` (this tree by default; an
unpacked earlier commit to compare with). Prints one JSON line: the
sha256 of the final global model's fp32 bytes, the wall seconds of
``run``, the counts and the card. Two trees that print the same digest
simulate the fleet bit for bit alike.

    python3 megafleet_digest.py
    python3 megafleet_digest.py --root build/parent
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve().parent),
                        help="the tree whose p2pfl_tpu_torch package runs the fleet")
    args = parser.parse_args(argv)
    root = str(Path(args.root).resolve())
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("megafleet_digest: no CUDA device", file=sys.stderr)
        return 1
    from p2pfl_tpu_torch.federation.megafleet import FleetSpec, MegaFleet

    spec = FleetSpec.synth(1_000_000, seed=1905, slow_frac=0.10)
    start_loss = spec.loss(spec.init)
    mega = MegaFleet(spec, cluster_size=1024, k=64, updates_per_node=4, local_lr=0.7, chunk=256,
                     target_loss=0.05 * start_loss, device="cuda")
    t0 = time.perf_counter()
    res = mega.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=False).stdout.strip()
    print(json.dumps({
        "root": root, "package": str(Path(sys.modules["p2pfl_tpu_torch"].__file__).parent),
        "final_global_sha256": hashlib.sha256(res.params["w"].cpu().numpy().tobytes()).hexdigest(),
        "wall_s": wall, "events": res.n_events, "merges": res.merges, "regional_merges": res.regional_merges,
        "card": smi,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
