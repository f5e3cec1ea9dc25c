#!/usr/bin/env python3
"""Drive the PyTorch port (``p2pfl_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, one card
    python3 chip_smoke.py --only kernels

Phases, each of which makes the script exit non-zero if it fails:

1. require CUDA; print the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``p2pfl_tpu_torch/csrc`` with ``nvcc``;
3. hold every kernel against its plain PyTorch version on the card at the
   main path's attention shape (4 nodes x batch 1, T 1024, 32 heads, head
   dim 64, bf16), causal and full, and time kernel, plain version, the
   analytic bound and one PyTorch library call as a yardstick;
4. the main path at full width and depth: federated LoRA on the
   TinyLlama-architecture causal LM (22L/2048d/32h/kv4/ffn5632, vocab 4096,
   seq 1024, LoRA rank 8 with lora_mlp) through ``tiny_transformer(attn=
   "flash")`` → ``SpmdLoraFederation.from_dataset`` → ``run_round`` →
   ``run_fused(1)`` → ``evaluate``, once with the default (fused) backward
   and once with ``bwd_mode="split"``; launch counts are zeroed before and
   read after each drive, and every kernel of that drive must have run;
5. one round on the CPU (plain versions) against one round on the card
   (kernels) from the same init and data, at 2L/256d/4h/kv2 (head dim
   64), seq 256;
6. a ``{"kernels": [...]}`` line, the ``nvidia-smi`` line again, and last
   ``{"ok": true, "device": {...}}``.

Imports only torch, numpy and ``p2pfl_tpu_torch``. Weights are random,
drawn from seeded ``torch.Generator``s.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

SRC = "p2pfl_tpu_torch/csrc/flash_attention.cu"
REPLACES = {
    "flash_fwd": "p2pfl_tpu/ops/flash_attention.py:189",
    "flash_bwd_dkvq": "p2pfl_tpu/ops/flash_attention.py:327",
    "flash_bwd_dq": "p2pfl_tpu/ops/flash_attention.py:216",
    "flash_bwd_dkv": "p2pfl_tpu/ops/flash_attention.py:294",
}
# tolerances against the plain versions on the same inputs. Both sides
# round at the same points (bf16 operands, fp32 sums, P and dS cast to
# bf16); they differ in fp32 summation order, and dQ of the fused kernel
# sums through atomics in no fixed order. That moves a bf16 output by an
# ulp or two (an ulp is at most 2^-7 of the value). Each element is held
# to RTOL·|ref| + ATOL with ATOL = RTOL·rms(ref): the limit follows the
# typical value, not the few largest rows (under the causal mask the first
# query rows and the first keys' dV are many times the bulk). The fp32 lse
# is held to LSE_TOL absolute.
RTOL = 2.0 ** -6
LSE_TOL = 1e-4


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median of per-call CUDA-event times (inputs warm in L2 as on the
    main path, where each layer's q/k/v were just written)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(n_bytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / PEAK_BYTES, flops / PEAK_BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check(got, want) -> tuple[float, float, float]:
    """(max abs error, ATOL, worst share of the per-element limit used):
    the check passes when the share is at most 1."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    atol = RTOL * want.pow(2).mean().sqrt().item()
    used = (err / (RTOL * want.abs() + atol)).max().item()
    return err.max().item(), atol, used


def fmt(name: str, res: tuple[float, float, float]) -> str:
    e, atol, used = res
    return f"{name} max err {e:.3e} (limit {RTOL:g}·|ref| + {atol:.3e}, worst element at {used:.2f} of it)"


# ---- phase 3: kernels against their plain versions ----


def check_kernels(results: dict) -> bool:
    from p2pfl_tpu_torch.ops import _kernels
    from p2pfl_tpu_torch.ops import flash_attention as fa
    from p2pfl_tpu_torch.ops.autotune import default_flash_config

    b, h, t, d = 4, 32, 1024, 64  # 4 nodes x batch 1 at the slice's shape
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (
        torch.randn((b, h, t, d), generator=gen, device="cuda", dtype=torch.float32).to(torch.bfloat16)
        for _ in range(4)
    )
    cfg = default_flash_config(t, d)
    bq, bk = cfg.block_q, cfg.block_k
    ok = True
    bf16, f32 = 2, 4
    qkv_bytes = 3 * b * h * t * d * bf16
    row_bytes = b * h * t * f32
    for causal in (True, False):
        tag = "causal" if causal else "full"
        pairs = b * h * (t * (t + 1) // 2 if causal else t * t)  # (q, k) pairs computed

        o, lse = _kernels.flash_fwd(q, k, v, causal)
        o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, causal, bq, bk)
        r_o = check(o, o_ref)
        e_l = (lse - lse_ref).abs().max().item()
        good = r_o[2] <= 1 and e_l <= LSE_TOL
        ok &= good
        limits = {"flash_fwd": f"{fmt('O', r_o)}; lse max err {e_l:.3e} (limit {LSE_TOL})"}
        log(f"[kernels] flash_fwd {tag}: {limits['flash_fwd']} {'OK' if good else 'FAIL'}")
        delta = (do.float() * o.float()).sum(-1)

        dq, dk, dv = _kernels.flash_bwd_fused(q, k, v, do, lse, delta, causal)
        ref = fa.flash_bwd_fused_plain(q, k, v, do, lse, delta, causal, bq, bk)
        res = [check(x, y) for x, y in zip((dq, dk, dv), ref)]
        good = all(used <= 1 for _, _, used in res)
        ok &= good
        e_fused = max(e for e, _, _ in res)
        limits["flash_bwd_dkvq"] = "; ".join(fmt(n, r) for n, r in zip(("dQ", "dK", "dV"), res))
        log(f"[kernels] flash_bwd_dkvq {tag}: {limits['flash_bwd_dkvq']} {'OK' if good else 'FAIL'}")

        r_dq = check(_kernels.flash_bwd_dq(q, k, v, do, lse, delta, causal),
                     fa.flash_bwd_dq_plain(q, k, v, do, lse, delta, causal, bq, bk))
        dk_s, dv_s = _kernels.flash_bwd_dkv(q, k, v, do, lse, delta, causal)
        dk_ref, dv_ref = fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal, bq, bk)
        res_kv = [check(dk_s, dk_ref), check(dv_s, dv_ref)]
        good = r_dq[2] <= 1 and all(used <= 1 for _, _, used in res_kv)
        ok &= good
        e_dq = r_dq[0]
        e_kv = max(e for e, _, _ in res_kv)
        limits["flash_bwd_dq"] = fmt("dQ", r_dq)
        limits["flash_bwd_dkv"] = "; ".join(fmt(n, r) for n, r in zip(("dK", "dV"), res_kv))
        log(f"[kernels] flash_bwd_dq/dkv {tag}: {limits['flash_bwd_dq']}; "
            f"{limits['flash_bwd_dkv']} {'OK' if good else 'FAIL'}")
        torch.cuda.synchronize()

        # ---- timing: kernel, plain version, library yardstick, bound ----
        rows = {}
        ms = time_ms(lambda: _kernels.flash_fwd(q, k, v, causal))
        plain = time_ms(lambda: fa.flash_fwd_plain(q, k, v, causal, bq, bk), iters=3, warmup=1)
        lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=causal))
        bms, by = bound(qkv_bytes + b * h * t * d * bf16 + row_bytes, 4 * d * pairs)
        rows["flash_fwd"] = dict(max_abs_err=max(r_o[0], e_l), ms=ms, plain_ms=plain,
                                 bound_ms=bms, bound_by=by, library_ms=lib)

        qg, kg, vg = (x.detach().clone().requires_grad_(True) for x in (q, k, v))

        def sdpa_fwd_bwd():
            out = torch.nn.functional.scaled_dot_product_attention(qg, kg, vg, is_causal=causal)
            out.backward(do)

        lib_bwd = time_ms(sdpa_fwd_bwd)
        bwd_in = qkv_bytes + b * h * t * d * bf16 + 2 * row_bytes  # q, k, v, dO, lse, delta
        out1 = b * h * t * d * bf16
        ms = time_ms(lambda: _kernels.flash_bwd_fused(q, k, v, do, lse, delta, causal))
        plain = time_ms(lambda: fa.flash_bwd_fused_plain(q, k, v, do, lse, delta, causal, bq, bk),
                        iters=3, warmup=1)
        bms, by = bound(bwd_in + 3 * out1, 10 * d * pairs)
        rows["flash_bwd_dkvq"] = dict(max_abs_err=e_fused, ms=ms, plain_ms=plain,
                                      bound_ms=bms, bound_by=by, library_ms=lib_bwd)
        ms = time_ms(lambda: _kernels.flash_bwd_dq(q, k, v, do, lse, delta, causal))
        plain = time_ms(lambda: fa.flash_bwd_dq_plain(q, k, v, do, lse, delta, causal, bq, bk),
                        iters=3, warmup=1)
        bms, by = bound(bwd_in + out1, 6 * d * pairs)
        rows["flash_bwd_dq"] = dict(max_abs_err=e_dq, ms=ms, plain_ms=plain,
                                    bound_ms=bms, bound_by=by, library_ms=lib_bwd)
        ms = time_ms(lambda: _kernels.flash_bwd_dkv(q, k, v, do, lse, delta, causal))
        plain = time_ms(lambda: fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal, bq, bk),
                        iters=3, warmup=1)
        bms, by = bound(bwd_in + 2 * out1, 8 * d * pairs)
        rows["flash_bwd_dkv"] = dict(max_abs_err=e_kv, ms=ms, plain_ms=plain,
                                     bound_ms=bms, bound_by=by, library_ms=lib_bwd)
        for name, row in rows.items():
            log(f"[kernels] {name} {tag} [{b}x{h}, {t}, {d}] bf16: {json.dumps(row)} "
                f"limit: {limits[name]}")
        results[tag] = rows
    return ok


# ---- phase 4: the main path ----


def drive_main_path(bwd_mode: str) -> tuple[bool, dict]:
    from p2pfl_tpu_torch.learning.dataset import FederatedDataset
    from p2pfl_tpu_torch.models.transformer import TransformerConfig, tiny_transformer
    from p2pfl_tpu_torch.ops import _kernels
    from p2pfl_tpu_torch.ops.flash_attention import FlashConfig
    from p2pfl_tpu_torch.parallel.spmd_lora import SpmdLoraFederation

    n_nodes, seq, depth = 4, 1024, 22
    cfg = TransformerConfig(
        vocab_size=4096, dim=2048, n_heads=32, n_kv_heads=4, n_layers=depth,
        ffn_hidden=5632, lora_rank=8, lora_mlp=True, scan_layers=True,
        flash_config=None if bwd_mode == "auto" else FlashConfig(bwd_mode=bwd_mode),
    )
    data = FederatedDataset.synthetic_lm(
        vocab_size=4096, seq_len=seq, n_train=n_nodes * 2, n_test=n_nodes * 2, shift_frac=0.15
    )
    model = tiny_transformer(seq_len=seq, seed=0, cfg=cfg, attn="flash")
    n_params = model.param_count
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    _kernels.reset_launches()
    t0 = time.perf_counter()
    fed = SpmdLoraFederation.from_dataset(
        model, data, n_nodes=n_nodes, batch_size=1, vote=False, seed=3
    )
    first = fed.run_round()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    fused = fed.run_fused(rounds=1)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    metrics = fed.evaluate()
    torch.cuda.synchronize()
    launches = dict(_kernels.LAUNCHES)

    losses = [float(first["train_loss"])] + [float(e["train_loss"]) for e in fused]
    want = ["flash_fwd"] + (["flash_bwd_dkvq"] if bwd_mode != "split" else ["flash_bwd_dq", "flash_bwd_dkv"])
    ok = all(math.isfinite(x) for x in losses) and all(launches[k] > 0 for k in want)
    ok &= math.isfinite(metrics["test_loss"]) and 0.0 <= metrics["test_acc"] <= 1.0
    summary = {
        "bwd_mode": bwd_mode, "layers": depth, "params": n_params,
        "s_round_first": t1 - t0, "s_round_fused": t2 - t1,
        "train_losses": losses, "test_loss": metrics["test_loss"],
        "test_acc": metrics["test_acc"], "launches": launches,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "steps_per_round": fed._nb,
    }
    log(f"[main] {json.dumps(summary)} {'OK' if ok else 'FAIL'}")
    del fed, model
    torch.cuda.empty_cache()
    return ok, summary


# ---- phase 5: one round, CPU plain versions against card kernels ----


def round_parity() -> tuple[bool, dict]:
    from p2pfl_tpu_torch.learning.dataset import FederatedDataset
    from p2pfl_tpu_torch.models.base import TorchModel
    from p2pfl_tpu_torch.models.transformer import (
        CausalLM, TransformerConfig, init_params, resolve_attention,
    )
    from p2pfl_tpu_torch.ops.autotune import default_flash_config
    from p2pfl_tpu_torch.ops.tree import tree_leaves, tree_map
    from p2pfl_tpu_torch.parallel.spmd_lora import SpmdLoraFederation

    seq, lr = 256, 1e-3
    cfg = TransformerConfig(
        vocab_size=512, dim=256, n_layers=2, n_heads=4, n_kv_heads=2, ffn_hidden=688,
        lora_rank=8, lora_mlp=True,
    )
    data = FederatedDataset.synthetic_lm(vocab_size=512, seq_len=seq, n_train=8, n_test=8)
    params = init_params(cfg, seed=1, device="cpu")
    # lora_b starts at 0, which zeroes lora_a's first gradient; a nonzero
    # start exercises every adapter gradient in the comparison
    gen = torch.Generator().manual_seed(2)
    for blk in (params[f"layer_{i}"] for i in range(cfg.n_layers)):
        for sub in (blk["attn"], blk["mlp"]):
            for dense in sub.values():
                dense["lora_b"] = torch.randn(dense["lora_b"].shape, generator=gen) * 0.02
    attn = resolve_attention("flash", config=default_flash_config(seq, cfg.head_dim))
    out = {}
    for dev in ("cpu", "cuda"):
        model = TorchModel(CausalLM(cfg, attn), tree_map(lambda x: x.to(dev), params), (seq,),
                           cfg.vocab_size, {"config": cfg})
        fed = SpmdLoraFederation.from_dataset(
            model, data, n_nodes=4, batch_size=1, vote=False, seed=3, learning_rate=lr,
            device=dev,
        )
        t0 = time.perf_counter()
        entry = fed.run_round()
        loss = float(entry["train_loss"])
        out[dev] = (tree_map(lambda x: x.float().cpu(), fed.params), loss, time.perf_counter() - t0)
    (p_cpu, l_cpu, s_cpu), (p_gpu, l_gpu, _) = out["cpu"], out["cuda"]
    pairs = list(zip(tree_leaves(p_cpu), tree_leaves(p_gpu)))
    diffs = [(a - b).abs().max().item() for a, b in pairs]
    mean_diff = float(np.mean([(a - b).abs().mean().item() for a, b in pairs]))
    # Adam moves an adapter by about lr per step whatever the gradient's
    # size, so a bf16 rounding difference can flip the sign of a tiny
    # gradient: bound each element by 2·lr per step; the mean difference
    # and the loss must stay far below that
    steps = fed._nb
    ok = max(diffs) <= 2 * lr * steps and mean_diff <= 0.1 * lr and abs(l_cpu - l_gpu) <= 1e-2 * abs(l_cpu)
    summary = {"max_abs_diff": max(diffs), "mean_abs_diff": mean_diff, "tol_max": 2 * lr * steps,
               "tol_mean": 0.1 * lr, "loss_cpu": l_cpu, "loss_cuda": l_gpu, "cpu_s": s_cpu}
    log(f"[parity] {json.dumps(summary)} {'OK' if ok else 'FAIL'}")
    return ok, summary


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--only", choices=("kernels", "main", "parity"), default=None)
    args = parser.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smi = smi_line()
    log(f"[device] {smi}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from p2pfl_tpu_torch.ops import _kernels

    t0 = time.perf_counter()
    lib = _kernels.build()
    log(f"[build] {lib.name} in {time.perf_counter() - t0:.1f}s")
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "error" in line.lower():
            log(f"[build] {line.strip()}")

    ok = True
    timings: dict = {}
    launches: dict = {}
    if args.only in (None, "kernels"):
        ok &= check_kernels(timings)
    if args.only in (None, "main"):
        good, fused = drive_main_path("auto")
        ok &= good
        launches.update({k: v for k, v in fused["launches"].items() if k in ("flash_fwd", "flash_bwd_dkvq")})
        good, split = drive_main_path("split")
        ok &= good
        launches.update({k: v for k, v in split["launches"].items() if k in ("flash_bwd_dq", "flash_bwd_dkv")})
    if args.only in (None, "parity"):
        good, _ = round_parity()
        ok &= good

    if timings:
        kernels = [
            {"name": name, "route": "cuda", "source": SRC, "replaces": REPLACES[name],
             "launches": launches.get(name, 0), **timings["causal"][name]}
            for name in REPLACES
        ]
        print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    if not ok:
        log("chip_smoke: FAILED")
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:  # noqa: BLE001 — any phase's failure must exit non-zero
        traceback.print_exc()
        sys.exit(1)
