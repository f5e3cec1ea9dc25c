#!/usr/bin/env python3
"""Drive the PyTorch port (``p2pfl_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                 # every phase, one card
    python3 chip_smoke.py --only kernels offs
    python3 chip_smoke.py --only exchange gossip
    python3 chip_smoke.py --only mnist

Phases, each of which makes the script exit non-zero if it fails (the
``--only`` name in brackets):

1. require CUDA; print the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``p2pfl_tpu_torch/csrc`` with ``nvcc`` (one
   per source, in parallel) and print what ``-Xptxas -v`` says of each,
   with the registers, spills and dynamic shared memory of every
   instantiation of the forward (``flash_fwd_sm90``), the fused and
   dK/dV backward (``flash_bwd_sm90``) and the dQ pass
   (``flash_bwd_dq_sm90``);
3. [kernels] hold kernels 1-4 against their plain PyTorch versions on the
   card at the flash path's attention shape (4 nodes x batch 1, T 1024,
   32 heads, head dim 64, bf16), causal and full, on the inputs of seeds
   0-4, each element within a limit that includes the sum of the
   magnitudes of its terms (``check``); time kernel, plain version, the
   analytic bound and one PyTorch library call as a yardstick (SDPA's
   forward for the forward; for the backward SDPA's backward alone, after
   one forward with grad, against the split pair too), each kernel also
   by its device time alone and its host time a call, and the library
   call by its device time alone; then the backward at [1·32, 32768, 64]
   causal, where JAX's dispatch picks the split pass: kernels 3 + 4,
   kernel 2 and SDPA's backward, device time beside the bound (checked
   against the plain versions at T 4096);
4. [offs] the same for the offset-aware kernels 5-8 at a ring hop's shape
   (2 nodes x 32 heads, T_local 1024, bf16) in five visibility cases
   (diagonal, fully visible, fully masked, and two off-tile pairs, one
   with rows that see nothing inside a visited tile), both backward
   structures with a nonzero lse cotangent, seeds 0-4, exact zeros where
   no pair reaches; then ``ring_attention(impl="flash")`` at [2, 4096,
   32, 64] with R = 4 against unsharded flash;
5. [main] the flash path at full width and depth: federated LoRA on the
   TinyLlama-architecture causal LM (22L/2048d/32h/kv4/ffn5632, vocab 4096,
   seq 1024, LoRA rank 8 with lora_mlp) through ``tiny_transformer(attn=
   "flash")`` → ``SpmdLoraFederation.from_dataset`` → ``run_round`` →
   ``run_fused(1)`` → ``evaluate``, once with the default (fused) backward
   and once with ``bwd_mode="split"``; launch counts are zeroed before and
   read after each drive, and every kernel of that drive must have run;
6. [ring] the long-context path at the same widths and depth: seq 4096
   sharded over a ring of R = 4 (``federation_mesh(model_parallel=4,
   devices=["cuda:0"] * 4)``), 2 nodes x batch 1, through
   ``tiny_transformer(attn="ring_flash", mesh=...)`` and the same
   federation calls, fused backward and then split;
7. [parity] one round on the CPU (plain versions) against one round on the
   card (kernels) from the same init and data, at 2L/256d/4h/kv2 (head dim
   64): flash at seq 256, then ring flash at seq 512 with R = 4;
8. [exchange] kernel 9 (``csrc/ici_exchange.cu``, the ICI plane's shard
   transfer) against its plain version, bit for bit, on four trees: the
   MLP's six fp32 leaves, a bf16 tree, odd byte counts at unaligned
   offsets, and the leaf shapes of the 0.98B config-5 model's bf16
   weights (~2 GB); each timed with its bound, plain version and
   ``torch._foreach_copy_`` as the yardstick;
9. [gossip] the gossip Node path of ``p2pfl_tpu_torch/examples/mnist.py``
   at full MLP width: nodes on ``submesh_federation_mesh(n,
   devices=["cuda:0"] * n)``, full topology, 8192 synthetic MNIST
   samples, batch 128, 2 rounds of 1 epoch, once with
   ``WEIGHTS_PLANE="bytes"`` and once with ``"ici"``, at 2 nodes (the
   planes must end bit-equal; a control with a wrong delivery must not)
   and at 4: kernel 9 must have launched, the plane must have moved bytes
   with no fallback, alignment fix-up or failed transfer, every node must
   end on one model and the two planes' mean gap must stay in its limit;
10. [mnist] ``bench.py``'s drive on the port
   (``p2pfl_tpu_torch/examples/bench_mnist.py``: 64 MLP nodes at full
   width, batch 64, fused chunks of 5 rounds to 98% test accuracy on the
   synthetic-hard task), which runs no hand kernel: it must cross 98%
   within 30 rounds with finite accuracies and losses; logs its JSON line
   (s/round, time and rounds to 98%, peak memory, FLOPs a round, MFU),
   the kernels one eager round launches and their device time
   (``torch.profiler``), a fused span as the CUDA graph ``run_fused``
   replays against the same span run eagerly (bit-equal, both timed),
   and one round of a 4-node federation on the CPU
   against one on the card from the same init and data (bf16 bounds in
   ``MNIST_*``);
11. a ``{"kernels": [...]}`` line, the ``nvidia-smi`` line again, and last
   ``{"ok": true, "device": {...}}``.

``--only exchange_peer`` (never run by default: it needs two cards) times
kernel 9 storing from cuda:0 into cuda:1's memory over NVLink.

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

FWD_SRC = "p2pfl_tpu_torch/csrc/flash_fwd_sm90.cu"
BWD_SRC = "p2pfl_tpu_torch/csrc/flash_bwd_sm90.cu"
DQ_SRC = "p2pfl_tpu_torch/csrc/flash_bwd_dq_sm90.cu"
SOURCES = {"flash_fwd": FWD_SRC, "flash_fwd_offs": FWD_SRC, "flash_bwd_dkvq": BWD_SRC,
           "flash_bwd_dkvq_offs": BWD_SRC, "flash_bwd_dkv": BWD_SRC, "flash_bwd_dkv_offs": BWD_SRC,
           "flash_bwd_dq": DQ_SRC, "flash_bwd_dq_offs": DQ_SRC,
           "ici_exchange": "p2pfl_tpu_torch/csrc/ici_exchange.cu"}
REPLACES = {
    "flash_fwd": "p2pfl_tpu/ops/flash_attention.py:189",
    "flash_bwd_dkvq": "p2pfl_tpu/ops/flash_attention.py:327",
    "flash_bwd_dq": "p2pfl_tpu/ops/flash_attention.py:216",
    "flash_bwd_dkv": "p2pfl_tpu/ops/flash_attention.py:294",
    "flash_fwd_offs": "p2pfl_tpu/ops/flash_attention.py:669",
    "flash_bwd_dkvq_offs": "p2pfl_tpu/ops/flash_attention.py:815",
    "flash_bwd_dq_offs": "p2pfl_tpu/ops/flash_attention.py:688",
    "flash_bwd_dkv_offs": "p2pfl_tpu/ops/flash_attention.py:786",
    "ici_exchange": "p2pfl_tpu/parallel/ici_plane.py:162",
}
NEG_INF = -1e30
# tolerances against the plain versions on the same inputs. Both sides
# round at the same points (bf16 operands, fp32 sums, P and dS cast to
# bf16); they differ in fp32 summation order, and dQ of the fused kernel
# sums through bulk reductions in no fixed order. That moves a bf16 output
# by an ulp or two (an ulp is at most 2^-7 of the value). Each element is
# held to RTOL·|ref| + ATOL with ATOL = RTOL·rms(ref): the limit follows the
# typical value, not the few largest rows (under the causal mask the first
# query rows and the first keys' dV are many times the bulk). That limit
# does not bound a sum whose terms cancel: where the fp32 values of a P or
# dS on the two sides fall on either side of a bf16 rounding point, that
# term moves by an ulp however small the sum is. Each side rounds a term
# within half an ulp, 2^-8 of its size, so the two sides differ by at most
# 2 · 2^-8 = TERMS_TOL of the sum of the magnitudes of the terms (the plain
# versions' ``*_magnitude`` helpers), which the limit adds where the
# caller gives it. The fp32 lse is held to LSE_TOL absolute.
RTOL = 2.0 ** -6
TERMS_TOL = 2.0 * 2.0 ** -8
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


def time_device_ms(fn, iters: int = 20) -> float:
    """Median device time of ``fn``'s work alone: a sleep kernel queued
    first keeps the card busy while the host prepares and launches, so
    the events bracket the launched work only, not the wrapper's host
    time."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)  # ~10 ms of the card's clock
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(n_bytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / PEAK_BYTES, flops / PEAK_BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check(got, want, terms=None) -> tuple[float, float, float]:
    """(max abs error, ATOL, worst share of the per-element limit used):
    the check passes when the share is at most 1. ``terms`` is each
    element's sum of the magnitudes of the terms that form it; without it
    the limit has no cancellation term. An all-zero reference with no
    terms (a fully masked hop) has a zero limit: only exact zeros pass."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    atol = RTOL * want.pow(2).mean().sqrt().item()
    limit = RTOL * want.abs() + atol
    if terms is not None:
        limit = limit + TERMS_TOL * terms.float()
    share = torch.where(limit > 0, err / limit.clamp_min(1e-38),
                        torch.where(err > 0, torch.full_like(err, math.inf), torch.zeros_like(err)))
    return err.max().item(), atol, share.max().item()


def fmt(name: str, res: tuple[float, float, float], terms: bool = True) -> str:
    e, atol, used = res
    limit = f"{RTOL:g}·|ref| + {atol:.3e}" + (f" + {TERMS_TOL:g}·Σ|terms|" if terms else "")
    return f"{name} max err {e:.3e} (limit {limit}, worst element at {used:.2f} of it)"


def host_ms(fn, iters: int = 50) -> float:
    """Host time of one call (the wrapper's checks, allocations, tensor
    maps and launch), by the host clock over calls that only enqueue."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    elapsed = time.perf_counter() - t
    torch.cuda.synchronize()
    return elapsed / iters * 1e3


def device_times(kernel, library) -> dict:
    """A kernel's device time alone (without the wrapper's host work) and
    host time a call, and the device time of its library yardstick, where
    there is one."""
    return {"device_ms": time_device_ms(kernel), "host_ms": host_ms(kernel),
            "library_device_ms": time_device_ms(library) if library is not None else None}


def sdpa_backward(q, k, v, do, **kw):
    """SDPA's backward alone as a call: its forward runs once with grad
    here, the call is ``torch.autograd.grad`` through the kept graph."""
    qg, kg, vg = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(qg, kg, vg, **kw)
    return lambda: torch.autograd.grad(out, (qg, kg, vg), do, retain_graph=True)


def build_report(log_text: str) -> list:
    """Lines of the ``-Xptxas -v`` report worth printing, then one summary
    line per instantiation of the sm90 flash kernels (registers, spills)
    with its dynamic shared memory, which ptxas does not report."""
    from p2pfl_tpu_torch.ops import _kernels

    words = ("registers", "spill", "error", "Compiling", "warning", "Potential")
    lines = [line.strip() for line in log_text.splitlines() if any(w in line for w in words)]
    # kernel, its source, the shared memory of each instantiation (by the
    # mangled template arguments: OFFS, then WITH_DQ for the backward)
    kernels = (
        ("flash_fwd_sm90", "flash_fwd_sm90", {"ILb0E": _kernels.flash_fwd_smem_bytes,
                                              "ILb1E": _kernels.flash_fwd_smem_bytes}),
        ("flash_bwd_sm90", "flash_bwd_sm90", {"ILb0ELb1E": _kernels.flash_bwd_smem_bytes,
                                              "ILb1ELb1E": _kernels.flash_bwd_smem_bytes,
                                              "ILb0ELb0E": _kernels.flash_bwd_dkv_smem_bytes,
                                              "ILb1ELb0E": _kernels.flash_bwd_dkv_smem_bytes}),
        ("flash_bwd_dq_sm90", "flash_bwd_dq_sm90", {"ILb0E": _kernels.flash_bwd_dq_smem_bytes,
                                                    "ILb1E": _kernels.flash_bwd_dq_smem_bytes}),
    )
    for kernel, source, smem_of in kernels:
        section = log_text.split(f"== {source}.cu", 1)[-1].split("\n== ", 1)[0]
        for entry in section.split("Compiling entry function")[1:]:
            name = entry.split("'")[1]
            args = next(a for a in sorted(smem_of, key=len, reverse=True) if f"{kernel}{a}" in name)
            inst = ", ".join(f"{flag}={'true' if bit == '1' else 'false'}"
                             for flag, bit in zip(("OFFS", "WITH_DQ"), args[3::4]))
            regs = next((w.split("Used ")[1].split(" ")[0] for w in entry.splitlines() if "Used " in w), "?")
            spill = [w.strip() for w in entry.splitlines() if "spill" in w]
            lines.append(f"{kernel}<{inst}>: {regs} registers; {'; '.join(spill) or 'no spill line'}; "
                         f"{smem_of[args]()} bytes of dynamic shared memory a block")
    return lines


# ---- phase 3: kernels against their plain versions ----

#: seeds of the inputs every flash kernel is checked on (timings use the first)
SEEDS = (0, 1, 2, 3, 4)


def randn_inputs(shape, seed: int, n: int = 4) -> list:
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32).to(torch.bfloat16)
            for _ in range(n)]


class Worst:
    """The largest error and the largest share of the limit used, per
    kernel, over the seeds and outputs checked."""

    def __init__(self):
        self.err: dict = {}
        self.share: dict = {}

    def add(self, name: str, results) -> bool:
        for e, _, used in results:
            self.err[name] = max(self.err.get(name, 0.0), e)
            self.share[name] = max(self.share.get(name, 0.0), used)
        return all(used <= 1 for _, _, used in results)


def check_flash(q, k, v, do, causal: bool, bq: int, bk: int, worst: Worst, tag: str):
    """Kernels 1-4 against their plain versions on one input: → (ok, O,
    lse, Δ). Every element within its limit, the terms' magnitudes from
    the plain helpers."""
    from p2pfl_tpu_torch.ops import _kernels
    from p2pfl_tpu_torch.ops import flash_attention as fa

    o, lse = _kernels.flash_fwd(q, k, v, causal)
    o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, causal, bq, bk)
    r_o = check(o, o_ref, fa.flash_fwd_magnitude(q, k, v, causal, bq, bk))
    e_l = (lse - lse_ref).abs().max().item()
    ok = worst.add("flash_fwd", [r_o, (e_l, 0.0, e_l / LSE_TOL)])
    delta = (do.float() * o.float()).sum(-1)
    args = (q, k, v, do, lse, delta, causal)
    mags = fa.flash_bwd_magnitude(*args, bq, bk)
    ref = fa.flash_bwd_fused_plain(*args, bq, bk)
    res = [check(x, y, m) for x, y, m in zip(_kernels.flash_bwd_fused(*args), ref, mags)]
    ok &= worst.add("flash_bwd_dkvq", res)
    r_dq = check(_kernels.flash_bwd_dq(*args), fa.flash_bwd_dq_plain(*args, bq, bk), mags[0])
    ok &= worst.add("flash_bwd_dq", [r_dq])
    res_kv = [check(x, y, m) for x, y, m in zip(_kernels.flash_bwd_dkv(*args), fa.flash_bwd_dkv_plain(*args, bq, bk),
                                                mags[1:])]
    ok &= worst.add("flash_bwd_dkv", res_kv)
    torch.cuda.synchronize()
    log(f"[kernels] {tag}: {fmt('O', r_o)}; lse max err {e_l:.3e} (limit {LSE_TOL}); fused "
        f"{'; '.join(fmt(n, r) for n, r in zip(('dQ', 'dK', 'dV'), res))}; split {fmt('dQ', r_dq)}; "
        f"{'; '.join(fmt(n, r) for n, r in zip(('dK', 'dV'), res_kv))} {'OK' if ok else 'FAIL'}")
    return ok, o, lse, delta


def check_kernels(results: dict) -> bool:
    from p2pfl_tpu_torch.ops import _kernels
    from p2pfl_tpu_torch.ops import flash_attention as fa
    from p2pfl_tpu_torch.ops.autotune import default_flash_config

    b, h, t, d = 4, 32, 1024, 64  # 4 nodes x batch 1 at the slice's shape
    cfg = default_flash_config(t, d)
    bq, bk = cfg.block_q, cfg.block_k
    ok = True
    bf16, f32 = 2, 4
    qkv_bytes = 3 * b * h * t * d * bf16
    row_bytes = b * h * t * f32
    for causal in (True, False):
        tag = "causal" if causal else "full"
        pairs = b * h * (t * (t + 1) // 2 if causal else t * t)  # (q, k) pairs computed
        worst = Worst()
        for seed in SEEDS:
            q, k, v, do = randn_inputs((b, h, t, d), seed)
            good, o, lse, delta = check_flash(q, k, v, do, causal, bq, bk, worst, f"{tag} seed {seed}")
            ok &= good
            if seed == SEEDS[0]:
                timed_on = (q, k, v, do, o, lse, delta)
        q, k, v, do, o, lse, delta = timed_on
        limits = {name: f"worst element at {worst.share[name]:.2f} of its limit over seeds {list(SEEDS)}"
                  for name in worst.share}

        # ---- timing: kernel, plain version, library yardstick, bound ----
        rows = {}
        ms = time_ms(lambda: _kernels.flash_fwd(q, k, v, causal))
        plain = time_ms(lambda: fa.flash_fwd_plain(q, k, v, causal, bq, bk), iters=3, warmup=1)
        lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=causal))
        bms, by = bound(qkv_bytes + b * h * t * d * bf16 + row_bytes, 4 * d * pairs)
        rows["flash_fwd"] = dict(max_abs_err=worst.err["flash_fwd"], ms=ms, plain_ms=plain,
                                 bound_ms=bms, bound_by=by, library_ms=lib)
        rows["flash_fwd"].update(device_times(
            lambda: _kernels.flash_fwd(q, k, v, causal),
            lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=causal)))

        lib_bwd = sdpa_backward(q, k, v, do, is_causal=causal)
        lib_bwd_ms = time_ms(lib_bwd)
        bwd_in = qkv_bytes + b * h * t * d * bf16 + 2 * row_bytes  # q, k, v, dO, lse, delta
        out1 = b * h * t * d * bf16
        args = (q, k, v, do, lse, delta, causal)
        for name, kernel, plain_fn, n_out, flops in (
            ("flash_bwd_dkvq", _kernels.flash_bwd_fused, fa.flash_bwd_fused_plain, 3, 10),
            ("flash_bwd_dq", _kernels.flash_bwd_dq, fa.flash_bwd_dq_plain, 1, 6),
            ("flash_bwd_dkv", _kernels.flash_bwd_dkv, fa.flash_bwd_dkv_plain, 2, 8),
        ):
            bms, by = bound(bwd_in + n_out * out1, flops * d * pairs)
            rows[name] = dict(
                max_abs_err=worst.err[name], ms=time_ms(lambda: kernel(*args)),
                plain_ms=time_ms(lambda: plain_fn(*args, bq, bk), iters=3, warmup=1),
                bound_ms=bms, bound_by=by, library_ms=lib_bwd_ms)
            rows[name].update(device_times(lambda: kernel(*args), lib_bwd))
        # the split pair against SDPA's backward alone, device time
        rows["flash_bwd_dq"]["pair_device_ms"] = time_device_ms(lambda: _kernels.flash_bwd_split(*args))
        for name, row in rows.items():
            log(f"[kernels] {name} {tag} [{b}x{h}, {t}, {d}] bf16: {json.dumps(row)} "
                f"limit: {limits[name]}")
        results[tag] = rows
    ok &= long_sequence(results)
    return ok


def long_sequence(results: dict) -> bool:
    """The backward where JAX's dispatch picks the split pass (T·D·4 >
    4 MiB): kernels 3 + 4, kernel 2 (with its zeroed fp32 dQ sum and the
    cast, the wrapper's device work) and SDPA's backward alone, device
    time, causal at [1·32, 32768, 64] bf16, each beside its bound. The
    plain versions are too slow there: kernels 2, 3 and 4 are checked
    against them at T 4096 on the same heads."""
    from p2pfl_tpu_torch.ops import _kernels
    from p2pfl_tpu_torch.ops import flash_attention as fa
    from p2pfl_tpu_torch.ops.autotune import default_flash_config

    b, h, d = 1, 32, 64
    worst = Worst()
    t = 4096
    cfg = default_flash_config(t, d)
    q, k, v, do = randn_inputs((b, h, t, d), SEEDS[0])
    ok, *_ = check_flash(q, k, v, do, True, cfg.block_q, cfg.block_k, worst, f"causal [{b}x{h}, {t}, {d}]")
    t = 32768
    q, k, v, do = randn_inputs((b, h, t, d), SEEDS[0])
    o, lse = _kernels.flash_fwd(q, k, v, True)
    delta = (do.float() * o.float()).sum(-1)
    args = (q, k, v, do, lse, delta, True)
    dq, dk, dv = _kernels.flash_bwd_split(*args)
    torch.cuda.synchronize()
    ok &= all(bool(torch.isfinite(x).all()) for x in (dq, dk, dv))
    del o, dq, dk, dv
    pairs = b * h * t * (t + 1) // 2
    tensor, rows = b * h * t * d * 2, b * h * t * 4
    row = {"shape": [b * h, t, d], "causal": True, "use_fused_by_jax_dispatch": fa._bwd_use_fused(t, d, "auto")}
    for name, fn, n_out, flops in (
        ("split_3_4", lambda: _kernels.flash_bwd_split(*args), 3, 14),
        ("fused_2", lambda: _kernels.flash_bwd_fused(*args), 3, 10),
        ("sdpa_backward", sdpa_backward(q, k, v, do, is_causal=True), 3, 10),
    ):
        bms, by = bound(4 * tensor + 2 * rows + n_out * tensor, flops * d * pairs)
        row[name] = {"device_ms": time_device_ms(fn, iters=10), "bound_ms": bms, "bound_by": by}
    log(f"[kernels] long sequence, split vs fused vs SDPA's backward (worst element at T 4096 "
        f"{max(worst.share.values()):.2f} of its limit): {json.dumps(row)} {'OK' if ok else 'FAIL'}")
    results["long_sequence"] = row
    return ok


# ---- phase 4: the offset-aware kernels against their plain versions ----

# (q_off, k_off) of one ring hop with T_local 1024: the diagonal hop, a hop
# from an earlier shard (fully visible), one from a later shard (fully
# masked), and two off-tile pairs whose mask cuts through the kernels'
# 64-row tiles at an offset the non-offset kernels never mask. In
# "offtile" every row sees key 0; in "offtile_late" (q_off < k_off) rows
# 0-31 see nothing inside the one k tile their q tile visits, which runs
# the kernels' sentinel guard (O 0, lse -1e30, P 0 in the backward)
OFFSET_CASES = {
    "diagonal": (1024, 1024), "visible": (2048, 0), "masked": (0, 1024), "offtile": (1024 + 32, 1024),
    "offtile_late": (1024, 1024 + 32),
}


def visible_pairs(b: int, h: int, t: int, q_off: int, k_off: int) -> int:
    """(q, k) pairs the hop attends: row i sees k_off + j <= q_off + i."""
    return b * h * sum(min(max(q_off + i - k_off + 1, 0), t) for i in range(t))


def seen_rows(t: int, q_off: int, k_off: int) -> int:
    """Rows of the hop's inputs the function must read: the q rows that see
    some key (i >= k_off - q_off) and the keys some row sees (j <= q_off +
    t - 1 - k_off) are equally many. A fully masked hop reads nothing: the
    offsets alone fix its outputs."""
    return min(max(q_off + t - k_off, 0), t)


def offset_mask(t: int, q_off: int, k_off: int, device) -> torch.Tensor:
    rows = q_off + torch.arange(t, device=device)[:, None]
    return rows >= k_off + torch.arange(t, device=device)[None, :]


def check_offs(q, k, v, do, q_off: int, k_off: int, bq: int, bk: int, gen, worst: Worst, tag: str):
    """Kernels 5-8 against their plain versions on one hop with a nonzero
    lse cotangent: → (ok, the kernels' arguments). Rows that see nothing
    give O exactly 0 and lse the sentinel; a fully masked hop's terms are
    all 0, so only exact zeros pass there."""
    from p2pfl_tpu_torch.ops import _kernels
    from p2pfl_tpu_torch.ops import flash_attention as fa

    t = q.shape[2]
    o, lse = _kernels.flash_fwd_offs(q, k, v, q_off, k_off)
    o_ref, lse_ref = fa.flash_fwd_offs_plain(q, k, v, q_off, k_off, bq, bk)
    r_o = check(o, o_ref, fa.flash_fwd_offs_magnitude(q, k, v, q_off, k_off, bq, bk))
    e_l = (lse - lse_ref).abs().max().item()
    ok = worst.add("flash_fwd_offs", [r_o, (e_l, 0.0, e_l / LSE_TOL)])
    dead = min(max(k_off - q_off, 0), t)  # leading rows that see nothing
    if dead:  # there O is exactly 0 and lse at the sentinel
        ok &= torch.count_nonzero(o[..., :dead, :]).item() == 0 and bool((lse[..., :dead] == NEG_INF).all())
    delta = (do.float() * o.float()).sum(-1)
    glse = torch.randn(lse.shape, generator=gen, device="cuda")
    glse = torch.where(lse <= NEG_INF / 2, torch.zeros_like(glse), glse)
    args = (q, k, v, do, lse, delta, glse, q_off, k_off)
    mags = fa.flash_bwd_offs_magnitude(*args, bq, bk)
    ref = fa.flash_bwd_fused_offs_plain(*args, bq, bk)
    res = [check(x, y, m) for x, y, m in zip(_kernels.flash_bwd_fused_offs(*args), ref, mags)]
    ok &= worst.add("flash_bwd_dkvq_offs", res)
    dq, dk, dv = _kernels.flash_bwd_split_offs(*args)
    r_dq = check(dq, ref[0], mags[0])
    ok &= worst.add("flash_bwd_dq_offs", [r_dq])
    res_kv = [check(x, y, m) for x, y, m in zip((dk, dv), ref[1:], mags[1:])]
    ok &= worst.add("flash_bwd_dkv_offs", res_kv)
    # exact zeros where no pair reaches: dQ of the rows that see nothing,
    # dK and dV of the keys no row sees
    seen = seen_rows(t, q_off, k_off)
    ok &= torch.count_nonzero(dq[..., :dead, :]).item() == 0
    ok &= torch.count_nonzero(dk[..., seen:, :]).item() == 0 and torch.count_nonzero(dv[..., seen:, :]).item() == 0
    torch.cuda.synchronize()
    log(f"[offs] {tag}: {fmt('O', r_o)}; lse max err {e_l:.3e} (limit {LSE_TOL}); fused "
        f"{'; '.join(fmt(n, r) for n, r in zip(('dQ', 'dK', 'dV'), res))}; split {fmt('dQ', r_dq)}; "
        f"{'; '.join(fmt(n, r) for n, r in zip(('dK', 'dV'), res_kv))} {'OK' if ok else 'FAIL'}")
    return ok, args


def check_offs_kernels(results: dict) -> bool:
    from p2pfl_tpu_torch.ops import _kernels
    from p2pfl_tpu_torch.ops import flash_attention as fa
    from p2pfl_tpu_torch.ops.autotune import default_flash_config

    b, h, t, d = 2, 32, 1024, 64  # 2 nodes x batch 1, one shard of a 4096 ring
    cfg = default_flash_config(t, d)
    bq, bk = cfg.block_q, cfg.block_k
    bf16, f32 = 2, 4
    tensor_bytes, row_bytes = b * h * t * d * bf16, b * h * t * f32
    sdpa = torch.nn.functional.scaled_dot_product_attention
    inputs = {seed: randn_inputs((b, h, t, d), seed) for seed in SEEDS}
    ok = True
    for case, (q_off, k_off) in OFFSET_CASES.items():
        pairs = visible_pairs(b, h, t, q_off, k_off)
        # bytes: the rows that must be read (q, k, v, dO and the fp32 rows
        # lse, Δ, g_lse of seen rows only), every output written once
        n_seen = seen_rows(t, q_off, k_off) * b * h
        seen_tensor, seen_row = n_seen * d * bf16, n_seen * f32
        worst = Worst()
        for seed in SEEDS:
            gen = torch.Generator(device="cuda").manual_seed(100 + seed)
            good, case_args = check_offs(*inputs[seed], q_off, k_off, bq, bk, gen, worst,
                                         f"{case} seed {seed}")
            ok &= good
            if seed == SEEDS[0]:
                args = case_args
        q, k, v, do = args[:4]
        limits = {name: f"worst element at {worst.share[name]:.2f} of its limit over seeds {list(SEEDS)}"
                  for name in worst.share}

        # ---- timing: kernel, plain version, library yardstick, bound ----
        if case == "diagonal":
            kw = {"is_causal": True}
        elif case == "visible":
            kw = {}
        elif case.startswith("offtile"):
            # a yardstick only: SDPA gives NaN on rows that see nothing
            kw = {"attn_mask": offset_mask(t, q_off, k_off, "cuda")}
        else:
            kw = None  # no library call computes a fully masked attention
        lib_fwd = (lambda: sdpa(q, k, v, **kw)) if kw is not None else None
        lib_bwd = sdpa_backward(q, k, v, do, **kw) if kw is not None else None
        lib_b = time_ms(lib_bwd) if lib_bwd is not None else None
        rows = {}
        bms, by = bound(3 * seen_tensor + tensor_bytes + row_bytes, 4 * d * pairs)
        rows["flash_fwd_offs"] = dict(
            max_abs_err=worst.err["flash_fwd_offs"],
            ms=time_ms(lambda: _kernels.flash_fwd_offs(q, k, v, q_off, k_off)),
            plain_ms=time_ms(lambda: fa.flash_fwd_offs_plain(q, k, v, q_off, k_off, bq, bk), iters=3, warmup=1),
            bound_ms=bms, bound_by=by, library_ms=time_ms(lib_fwd) if lib_fwd is not None else None)
        rows["flash_fwd_offs"].update(device_times(
            lambda: _kernels.flash_fwd_offs(q, k, v, q_off, k_off), lib_fwd))
        bwd_in = 4 * seen_tensor + 3 * seen_row  # q, k, v, dO, lse, delta, g_lse
        for name, kernel, plain, n_out, flops in (
            ("flash_bwd_dkvq_offs", _kernels.flash_bwd_fused_offs, fa.flash_bwd_fused_offs_plain, 3, 10),
            ("flash_bwd_dq_offs", _kernels.flash_bwd_dq_offs, fa.flash_bwd_dq_offs_plain, 1, 6),
            ("flash_bwd_dkv_offs", _kernels.flash_bwd_dkv_offs, fa.flash_bwd_dkv_offs_plain, 2, 8),
        ):
            bms, by = bound(bwd_in + n_out * tensor_bytes, flops * d * pairs)
            rows[name] = dict(
                max_abs_err=worst.err[name], ms=time_ms(lambda: kernel(*args)),
                plain_ms=time_ms(lambda: plain(*args, bq, bk), iters=3, warmup=1),
                bound_ms=bms, bound_by=by, library_ms=lib_b)
            rows[name].update(device_times(lambda: kernel(*args), lib_bwd))
        rows["flash_bwd_dq_offs"]["pair_device_ms"] = time_device_ms(lambda: _kernels.flash_bwd_split_offs(*args))
        for name, row in rows.items():
            log(f"[offs] {name} {case} (q_off {q_off}, k_off {k_off}) [{b}x{h}, {t}, {d}] bf16: "
                f"{json.dumps(row)} limit: {limits[name]}")
        results[case] = rows
    return ok


def time_ring(results: dict) -> bool:
    """ring_attention(impl="flash") over R = 4 shards of one card against
    unsharded flash attention on the same [2, 4096, 32, 64] bf16 inputs:
    the forward and forward + backward of both, and one launch of the
    unsharded kernels over [64, 4096, 64]; the ring's output is held
    against the unsharded one."""
    from p2pfl_tpu_torch.ops import _kernels
    from p2pfl_tpu_torch.ops.attention import ring_attention
    from p2pfl_tpu_torch.ops.flash_attention import flash_attention
    from p2pfl_tpu_torch.parallel.mesh import federation_mesh

    b, t, h, d, ring = 2, 4096, 32, 64, 4
    mesh = federation_mesh(model_parallel=ring, devices=["cuda:0"] * ring)
    gen = torch.Generator(device="cuda").manual_seed(2)
    q, k, v, g = (
        torch.randn((b, t, h, d), generator=gen, device="cuda", dtype=torch.float32).to(torch.bfloat16)
        for _ in range(4)
    )
    ring_fn = lambda *x: ring_attention(*x, mesh, "model", impl="flash")  # noqa: E731
    with torch.no_grad():
        res = check(ring_fn(q, k, v), flash_attention(q, k, v))
    good = res[2] <= 1
    log(f"[offs] ring vs unsharded output: {fmt('O', res, terms=False)} {'OK' if good else 'FAIL'}")
    xs = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]

    def fwd_bwd(fn):
        return lambda: fn(*xs).backward(g)

    def fwd(fn):
        def run():
            with torch.no_grad():
                fn(q, k, v)
        return run

    qt, kt, vt, gt = (x.transpose(1, 2).contiguous() for x in (q, k, v, g))
    o, lse = _kernels.flash_fwd(qt, kt, vt, True)
    delta = (gt.float() * o.float()).sum(-1)
    row = {
        "shape": [b, t, h, d], "ring": ring,
        "ring_fwd_ms": time_ms(fwd(ring_fn), iters=10),
        "ring_fwd_bwd_ms": time_ms(fwd_bwd(ring_fn), iters=10),
        "flash_fwd_ms": time_ms(fwd(flash_attention), iters=10),
        "flash_fwd_bwd_ms": time_ms(fwd_bwd(flash_attention), iters=10),
        "kernel_flash_fwd_ms": time_ms(lambda: _kernels.flash_fwd(qt, kt, vt, True)),
        "kernel_flash_bwd_dkvq_ms": time_ms(lambda: _kernels.flash_bwd_fused(qt, kt, vt, gt, lse, delta, True)),
        "kernel_flash_bwd_dq_ms": time_ms(lambda: _kernels.flash_bwd_dq(qt, kt, vt, gt, lse, delta, True)),
        "kernel_flash_bwd_dkv_ms": time_ms(lambda: _kernels.flash_bwd_dkv(qt, kt, vt, gt, lse, delta, True)),
    }
    log(f"[offs] ring vs unsharded timing: {json.dumps(row)}")
    results["ring_vs_unsharded"] = row
    return good


# ---- phase 5: the flash path ----


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


# ---- phase 6: the long-context ring path ----


def drive_ring_path(bwd_mode: str, depth: int) -> tuple[bool, dict]:
    from p2pfl_tpu_torch.learning.dataset import FederatedDataset
    from p2pfl_tpu_torch.models.transformer import TransformerConfig, tiny_transformer
    from p2pfl_tpu_torch.ops import _kernels
    from p2pfl_tpu_torch.ops.flash_attention import FlashConfig
    from p2pfl_tpu_torch.parallel.mesh import federation_mesh
    from p2pfl_tpu_torch.parallel.spmd_lora import SpmdLoraFederation

    n_nodes, seq, ring = 2, 4096, 4
    cfg = TransformerConfig(
        vocab_size=4096, dim=2048, n_heads=32, n_kv_heads=4, n_layers=depth,
        ffn_hidden=5632, lora_rank=8, lora_mlp=True, scan_layers=True,
        flash_config=None if bwd_mode == "auto" else FlashConfig(bwd_mode=bwd_mode),
    )
    data = FederatedDataset.synthetic_lm(
        vocab_size=4096, seq_len=seq, n_train=n_nodes * 2, n_test=n_nodes * 2, shift_frac=0.15
    )
    mesh = federation_mesh(model_parallel=ring, devices=["cuda:0"] * ring)
    model = tiny_transformer(seq_len=seq, seed=0, cfg=cfg, attn="ring_flash", mesh=mesh)
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
    steps = 2 * fed._nb  # training steps in the two rounds
    # every hop of every layer is launched, fully masked ones included
    fwd_want = depth * ring * ring * (steps + 1)  # + the eval forward
    bwd = ["flash_bwd_dkvq_offs"] if bwd_mode != "split" else ["flash_bwd_dq_offs", "flash_bwd_dkv_offs"]
    ok = all(math.isfinite(x) for x in losses) and launches["flash_fwd_offs"] == fwd_want
    ok &= all(launches[name] == depth * ring * ring * steps for name in bwd)
    ok &= all(launches[name] == 0 for name in ("flash_fwd", "flash_bwd_dkvq", "flash_bwd_dq", "flash_bwd_dkv"))
    ok &= math.isfinite(metrics["test_loss"]) and 0.0 <= metrics["test_acc"] <= 1.0
    summary = {
        "bwd_mode": bwd_mode, "layers": depth, "params": n_params, "seq": seq, "ring": ring,
        "nodes": n_nodes, "s_round_first": t1 - t0, "s_round_fused": t2 - t1,
        "train_losses": losses, "test_loss": metrics["test_loss"],
        "test_acc": metrics["test_acc"], "launches": launches,
        "launches_fwd_offs_expected": fwd_want,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "steps_per_round": fed._nb,
    }
    log(f"[ring] {json.dumps(summary)} {'OK' if ok else 'FAIL'}")
    del fed, model
    torch.cuda.empty_cache()
    return ok, summary


# ---- phase 7: one round, CPU plain versions against card kernels ----


def round_parity(attn: str = "flash", seq: int = 256, ring: int = 1) -> tuple[bool, dict]:
    """``attn="flash"``, or ``"ring_flash"`` over ``ring`` shards (a mesh
    of the CPU on the CPU, of the card on the card)."""
    from p2pfl_tpu_torch.learning.dataset import FederatedDataset
    from p2pfl_tpu_torch.models.base import TorchModel
    from p2pfl_tpu_torch.models.transformer import (
        CausalLM, TransformerConfig, init_params, resolve_attention,
    )
    from p2pfl_tpu_torch.ops.autotune import default_flash_config
    from p2pfl_tpu_torch.ops.tree import tree_leaves, tree_map
    from p2pfl_tpu_torch.parallel.mesh import federation_mesh
    from p2pfl_tpu_torch.parallel.spmd_lora import SpmdLoraFederation

    lr = 1e-3
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
    flash_cfg = default_flash_config(seq // ring, cfg.head_dim)
    out = {}
    for dev in ("cpu", "cuda"):
        mesh = federation_mesh(model_parallel=ring, devices=[dev] * ring) if attn == "ring_flash" else None
        attn_fn = resolve_attention(attn, config=flash_cfg, mesh=mesh)
        model = TorchModel(CausalLM(cfg, attn_fn), tree_map(lambda x: x.to(dev), params), (seq,),
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
    summary = {"attn": attn, "seq": seq, "ring": ring,
               "max_abs_diff": max(diffs), "mean_abs_diff": mean_diff, "tol_max": 2 * lr * steps,
               "tol_mean": 0.1 * lr, "loss_cpu": l_cpu, "loss_cuda": l_gpu, "cpu_s": s_cpu}
    log(f"[parity] {json.dumps(summary)} {'OK' if ok else 'FAIL'}")
    return ok, summary


# ---- phase 8: kernel 9 (the ICI plane's shard transfer) ----


def exchange_trees(gen: torch.Generator) -> dict:
    """name → (sources, destinations) on the card. The unaligned tree's
    sources are views at odd offsets into one flat buffer; half its
    destinations share the sources' misalignment (the kernel's vector path
    with byte head and tail), half are whole allocations (its byte path)."""
    from p2pfl_tpu_torch.models.transformer import TransformerConfig, init_params
    from p2pfl_tpu_torch.models.vision import mlp
    from p2pfl_tpu_torch.ops.tree import tree_leaves

    def fresh(srcs):
        return [torch.empty_like(s) for s in srcs]

    mlp_leaves = tree_leaves(mlp(seed=0, device="cuda").params)
    bf16 = [
        torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
        for shape in ((4096, 2048), (2048,), (2048, 256), (8, 2048), (5632, 2048), (3, 5, 7))
    ]
    flat = torch.randint(0, 256, (1 << 20,), generator=gen, device="cuda", dtype=torch.uint8)
    spans = [(1, 1001), (3 + 4096, 17), (5 + 8192, 65537), (16 + 200000, 15), (7 + 300000, 123457)]
    odd = [flat[o:o + n] for o, n in spans]
    # dtype views need offsets that are multiples of their element size
    odd += [flat[600002:600002 + 2 * 333].view(torch.bfloat16), flat[700012:700012 + 4 * 999].view(torch.float32)]
    shadow = torch.empty_like(flat)
    odd_dst = [shadow[o:o + n] for o, n in spans] + fresh(odd[len(spans):])
    cfg = TransformerConfig(
        vocab_size=4096, dim=2048, n_heads=32, n_kv_heads=4, n_layers=22, ffn_hidden=5632,
        lora_rank=8, lora_mlp=True,
    )
    big = [x.to(torch.bfloat16) for x in tree_leaves(init_params(cfg, seed=0, device="cuda"))]
    return {
        "mlp_fp32": (mlp_leaves, fresh(mlp_leaves)),
        "bf16": (bf16, fresh(bf16)),
        "odd_unaligned": (odd, odd_dst),
        "config5_bf16": (big, fresh(big)),
    }


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


def check_exchange(results: dict) -> bool:
    """Kernel 9 against its plain version on each tree, bit for bit, and
    timed: median of 20 CUDA-event-timed wrapper calls; bound = (bytes
    read + bytes written) / 3.35 TB/s; the plain version (per-leaf
    ``copy_``) and ``torch._foreach_copy_`` over the same tree; and the
    device time of the kernel and of ``_foreach_copy_`` alone, without
    the host's share (:func:`time_device_ms`)."""
    from p2pfl_tpu_torch.ops import _kernels
    from p2pfl_tpu_torch.parallel.ici_plane import exchange_plain

    gen = torch.Generator(device="cuda").manual_seed(9)
    ok = True
    for name, (srcs, dsts) in exchange_trees(gen).items():
        refs = [torch.empty_like(d) for d in dsts]
        for d in dsts:
            d.fill_(0)
        _kernels.ici_exchange(srcs, dsts)
        exchange_plain(srcs, refs)
        torch.cuda.synchronize()
        good = all(bits_equal(d, r) and bits_equal(d, s) for d, r, s in zip(dsts, refs, srcs))
        # as values (NaN where random bytes spell one counts as equal)
        err = max((d.float() - r.float()).nan_to_num().abs().max().item() for d, r in zip(dsts, refs))
        ok &= good
        n_bytes = sum(s.numel() * s.element_size() for s in srcs)
        bms, by = bound(2 * n_bytes, 0)
        row = dict(
            max_abs_err=err, ms=time_ms(lambda: _kernels.ici_exchange(srcs, dsts)),
            plain_ms=time_ms(lambda: exchange_plain(srcs, refs)), bound_ms=bms, bound_by=by,
            library_ms=time_ms(lambda: torch._foreach_copy_(refs, srcs)),
        )
        # the kernel's device time alone and host time a call, and
        # _foreach_copy_'s device time alone
        row.update(device_times(lambda: _kernels.ici_exchange(srcs, dsts),
                                lambda: torch._foreach_copy_(refs, srcs)))
        log(f"[exchange] {name}: {len(srcs)} leaves, {n_bytes} bytes, bit-equal to the plain "
            f"version: {good}; {json.dumps(row)} "
            f"{'OK' if good else 'FAIL'}")
        results[name] = row
        del srcs, dsts, refs
    torch.cuda.empty_cache()
    return ok


def check_exchange_peer(results: dict) -> bool:
    """Kernel 9 across two cards (only with ``--only exchange_peer`` on a
    machine with two or more): the MLP and config-5 trees from cuda:0 into
    cuda:1's memory, bit-exact, timed like phase ``exchange``; the bound
    is the payload over one NVLink direction (450 GB/s)."""
    from p2pfl_tpu_torch.ops import _kernels
    from p2pfl_tpu_torch.parallel.ici_plane import exchange_plain

    if torch.cuda.device_count() < 2:
        log("[exchange_peer] needs two cards")
        return False
    src_dev, dst_dev = torch.device("cuda", 0), torch.device("cuda", 1)
    gen = torch.Generator(device="cuda").manual_seed(9)
    ok = True
    for name, (srcs, _) in exchange_trees(gen).items():
        if name not in ("mlp_fp32", "config5_bf16"):
            continue
        dsts = [torch.empty_like(s, device=dst_dev) for s in srcs]
        refs = [torch.empty_like(d) for d in dsts]
        _kernels.ici_exchange(srcs, dsts)
        exchange_plain(srcs, refs)
        torch.cuda.synchronize(src_dev)
        torch.cuda.synchronize(dst_dev)
        good = all(bits_equal(d, r) for d, r in zip(dsts, refs))
        ok &= good
        n_bytes = sum(s.numel() * s.element_size() for s in srcs)
        row = dict(
            ms=time_ms(lambda: _kernels.ici_exchange(srcs, dsts)),
            device_ms=time_device_ms(lambda: _kernels.ici_exchange(srcs, dsts)),
            plain_ms=time_ms(lambda: exchange_plain(srcs, refs)),
            library_ms=time_ms(lambda: torch._foreach_copy_(refs, srcs)),
            nvlink_bound_ms=n_bytes / 450e9 * 1e3,
        )
        log(f"[exchange_peer] {name} cuda:0 -> cuda:1: {len(srcs)} leaves, {n_bytes} bytes, "
            f"bit-equal: {good}; {json.dumps(row)} {'OK' if good else 'FAIL'}")
        results[name] = row
    return ok


# ---- phase 9: the gossip Node path over both weights planes ----


#: limits of the gossip phase's cross-plane checks, from the readings in
#: PERF.md. Two nodes with equal shards: FedAvg of two halves is
#: exact in either arrival order, so the planes end bit-equal unless a
#: delivery is wrong. Four nodes: partial aggregates fold in arrival order
#: and Adam turns those ulps into up to a step of lr on near-zero
#: gradients, so the planes are held on the mean gap over every element:
#: it read 2.4e-6 on an H100, a wrong delivery 2.5e-2.
PAIR_MAX_GAP = 0.0
FOLD_MEAN_GAP = 5e-5


def _gaps(a: list, b: list) -> tuple[float, float]:
    """(max, mean) absolute difference over every element of two fleets'
    leaves (lists of per-node lists of fp32 CPU tensors)."""
    diffs = [(x - y).abs() for la, lb in zip(a, b) for x, y in zip(la, lb)]
    return max(d.max().item() for d in diffs), sum(d.sum().item() for d in diffs) / sum(d.numel() for d in diffs)


def drive_gossip() -> tuple[bool, dict]:
    """``examples/mnist.py``'s path at full MLP width.

    First 2 nodes, bytes then ici (the bytes drive also warms CUDA, cuBLAS
    and the allocator up, so no time of the pair is reported): the planes
    must end bit-equal. A control repeats the ICI pair with a delivery
    that hands each receiver its own model instead of the sender's; it
    must read far above both limits, or the checks could not see a wrong
    delivery. Then 4 nodes, bytes then ici, each with the launch counts
    zeroed before and read after, and seconds per node in every stage and
    dispatch site from its spans; their gap is held on its mean."""
    import logging

    from p2pfl_tpu_torch.communication import ici as ici_mod
    from p2pfl_tpu_torch.examples import mnist as example
    from p2pfl_tpu_torch.management.logger import logger
    from p2pfl_tpu_torch.management.telemetry import telemetry
    from p2pfl_tpu_torch.ops import _kernels
    from p2pfl_tpu_torch.ops.tree import tree_leaves, tree_map
    from p2pfl_tpu_torch.settings import set_test_settings

    set_test_settings()
    logger.set_level("WARNING")
    failures: list = []

    class _Failed(logging.Handler):
        def emit(self, record):
            if "ICI shard transfer" in record.getMessage():
                failures.append(record.getMessage())

    kw = dict(rounds=2, epochs=1, samples=8192, batch_size=128, device="cuda", topology="full")

    def breakdown(nodes: int) -> dict:
        """Seconds per node in each stage and dispatch site of the drive,
        from the in-process spans (host clock)."""
        per: dict = {}
        for s in telemetry.spans():
            if s.kind in ("stage", "dispatch"):
                key = f"{s.kind}:{s.name}"
                per[key] = per.get(key, 0.0) + s.duration_ns / 1e9 / nodes
        return {k: round(v, 4) for k, v in sorted(per.items())}

    def drive(plane: str, nodes: int) -> dict:
        ici_mod.reset_ici_stats()
        telemetry.reset_spans()
        _kernels.reset_launches()
        out = example.run(nodes=nodes, weights_plane=plane, **kw)
        torch.cuda.synchronize()
        launches = dict(_kernels.LAUNCHES)
        leaves = [[x.float().cpu() for x in tree_leaves(p)] for p in out["params"]]
        return dict(
            s_per_round=out["round_s"], elapsed_s=out["elapsed_s"],
            test_acc=[m["test_acc"] for m in out["metrics"]],
            test_loss=[m["test_loss"] for m in out["metrics"]],
            ici_stats=ici_mod.ici_stats(), launches_ici_exchange=launches["ici_exchange"],
            within_run_max_diff=_gaps(leaves[:1] * (nodes - 1), leaves[1:])[0],
            seconds_per_node=breakdown(nodes), leaves=leaves,
        )

    handler = _Failed()
    logger._logger.addHandler(handler)
    try:
        pair = {plane: drive(plane, 2) for plane in ("bytes", "ici")}
        real = ici_mod.shard_transfer
        ici_mod.shard_transfer = lambda tree, filler, src, dst: tree_map(torch.clone, filler)
        try:
            control = drive("ici", 2)
        finally:
            ici_mod.shard_transfer = real
        runs = {plane: drive(plane, 4) for plane in ("bytes", "ici")}
    finally:
        logger._logger.removeHandler(handler)
    pair_gap = _gaps(pair["bytes"]["leaves"], pair["ici"]["leaves"])
    control_gap = _gaps(pair["bytes"]["leaves"], control["leaves"])
    fold_gap = _gaps(runs["bytes"]["leaves"], runs["ici"]["leaves"])
    ici, byt = runs["ici"], runs["bytes"]
    stats = ici["ici_stats"]
    checks = {
        "kernel 9 launched": ici["launches_ici_exchange"] > 0 and pair["ici"]["launches_ici_exchange"] > 0,
        "bytes plane launched no kernel 9": byt["launches_ici_exchange"] == 0,
        "shard_sends > 0": stats["shard_sends"] > 0,
        "bytes_moved > 0": stats["bytes_moved"] > 0,
        "no fallback": stats["fallback_bytes"] == 0 and pair["ici"]["ici_stats"]["fallback_bytes"] == 0,
        "no alignment fix-up": stats["align_violations"] == 0,
        "no failed transfer": not failures,
        "within-run spread <= 1e-5": max(r["within_run_max_diff"] for r in (*runs.values(), *pair.values())) <= 1e-5,
        f"2 nodes: bytes vs ici max gap <= {PAIR_MAX_GAP}": pair_gap[0] <= PAIR_MAX_GAP,
        f"4 nodes: bytes vs ici mean gap <= {FOLD_MEAN_GAP}": fold_gap[1] <= FOLD_MEAN_GAP,
        "control (wrong delivery) reads above both limits":
            control_gap[0] > PAIR_MAX_GAP and control_gap[1] > 100 * FOLD_MEAN_GAP,
        "accuracy finite": all(math.isfinite(x) for r in (*runs.values(), *pair.values()) for x in r["test_loss"]),
    }
    ok = all(checks.values())
    for r in (*runs.values(), *pair.values(), control):
        r.pop("leaves")
    summary = {"nodes": 4, "rounds": 2, "samples": 8192, "batch": 128, "bytes": byt, "ici": ici,
               "bytes_vs_ici_max_mean": fold_gap, "pair_bytes_vs_ici_max_mean": pair_gap,
               "pair_ici": {k: pair["ici"][k] for k in ("ici_stats", "launches_ici_exchange", "within_run_max_diff")},
               "control_vs_bytes_max_mean": control_gap, "control_within_run": control["within_run_max_diff"],
               "failed_transfer_logs": failures[:3], "checks": checks}
    log(f"[gossip] {json.dumps(summary)} {'OK' if ok else 'FAIL'}")
    return ok, summary


# ---- phase 10: bench.py's MNIST path (no hand kernel) ----


#: the mnist phase's CPU-vs-card round: 4 nodes, the bench's batch 64,
#: 4 Adam steps at lr 1e-3. Adam moves an element by about lr a step
#: whatever its gradient's size, so a bf16 rounding difference can flip a
#: near-zero gradient's sign: each element within 2·lr a step, the mean
#: difference far below one step, the loss to 1%, the accuracy within
#: two test examples a node
MNIST_LR, MNIST_NODES, MNIST_STEPS = 1e-3, 4, 4


def mnist_parity() -> tuple[bool, dict]:
    """One round of a 4-node MLP federation at full width on the CPU (the
    plain path) and on the card, from the same init and data."""
    from p2pfl_tpu_torch.examples.bench_mnist import BATCH, HARD_TASK
    from p2pfl_tpu_torch.learning.dataset import FederatedDataset
    from p2pfl_tpu_torch.models.base import TorchModel
    from p2pfl_tpu_torch.models.vision import MLP, mlp
    from p2pfl_tpu_torch.ops.tree import tree_leaves, tree_map
    from p2pfl_tpu_torch.parallel.spmd import SpmdFederation

    n = MNIST_NODES
    params = mlp(seed=1, device="cpu").params
    data = FederatedDataset.synthetic_mnist(n_train=n * MNIST_STEPS * BATCH, n_test=n * 64, **HARD_TASK)
    out = {}
    for dev in ("cpu", "cuda"):
        model = TorchModel(MLP(), tree_map(lambda x: x.to(dev), params), (28, 28, 1))
        fed = SpmdFederation.from_dataset(
            model, data, n_nodes=n, batch_size=BATCH, vote=False, seed=3, keep_opt_state=True,
            learning_rate=MNIST_LR, device=dev,
        )
        entry = fed.run_round(eval=True)
        out[dev] = (tree_map(lambda x: x.float().cpu(), fed.params), float(entry["train_loss"]),
                    float(entry["test_acc"]), fed._nb, fed.y_test.numel())
    (p_cpu, l_cpu, a_cpu, steps, n_test), (p_gpu, l_gpu, a_gpu, _, _) = out["cpu"], out["cuda"]
    diffs = [(a - b).abs() for a, b in zip(tree_leaves(p_cpu), tree_leaves(p_gpu))]
    worst = max(d.max().item() for d in diffs)
    mean = sum(d.sum().item() for d in diffs) / sum(d.numel() for d in diffs)
    checks = {
        f"max <= 2·lr·steps ({2 * MNIST_LR * steps:g})": worst <= 2 * MNIST_LR * steps,
        f"mean <= 0.1·lr ({0.1 * MNIST_LR:g})": mean <= 0.1 * MNIST_LR,
        "loss within 1%": abs(l_cpu - l_gpu) <= 1e-2 * abs(l_cpu),
        "accuracy within 2 examples a node": abs(a_cpu - a_gpu) <= 2 * n / n_test,
    }
    summary = {"nodes": n, "steps": steps, "max_abs_diff": worst, "mean_abs_diff": mean,
               "loss_cpu": l_cpu, "loss_cuda": l_gpu, "acc_cpu": a_cpu, "acc_cuda": a_gpu, "checks": checks}
    return all(checks.values()), summary


def round_kernels(fed) -> dict:
    """Kernels one ``run_round`` (no eval) launches on the card and their
    device time, from ``torch.profiler``'s CUDA activity, after a warm
    round; ``None`` where the profiler saw no device activity."""
    from torch.profiler import ProfilerActivity, profile

    fed.run_round()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fed.run_round()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels = [e for e in device if not e.name.startswith(("Memcpy", "Memset"))]
    launch_calls = sum(1 for e in prof.events() if e.name in ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC"))
    if not device:
        return {"source": "torch.profiler (no device activity seen)", "kernels": None, "device_ms": None,
                "launch_calls": launch_calls or None, "profiled_wall_ms": wall * 1e3}
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    top: dict = {}
    for e in kernels:
        top[e.name[:60]] = top.get(e.name[:60], 0.0) + e.time_range.elapsed_us() / 1e3
    return {"source": "torch.profiler", "kernels": len(kernels), "copies_and_fills": len(device) - len(kernels),
            "launch_calls": launch_calls, "device_ms": busy, "profiled_wall_ms": wall * 1e3,
            "top_kernels_ms": dict(sorted(top.items(), key=lambda kv: -kv[1])[:8])}


def graph_vs_eager(fed, rounds: int) -> tuple[bool, dict]:
    """One fused span of ``rounds`` rounds with eval from the federation's
    state, eagerly (``spmd_rounds_fused``) and as the captured CUDA graph
    that ``run_fused`` replays: the params, losses and accuracies must be
    bit-equal. Each is timed twice after a warm call (host clock to a
    synchronize); the federation's own state is not advanced."""
    from p2pfl_tpu_torch.ops.tree import tree_leaves
    from p2pfl_tpu_torch.parallel.spmd import _CapturedSpan, spmd_rounds_fused

    perms, mask, sel_idx = fed._fused_inputs(rounds, 1)

    def eager():
        return spmd_rounds_fused(
            fed.params, fed.opt_state, fed.x_all, fed.y_all, perms, mask, fed._samples, sel_idx,
            x_test=fed.x_test, y_test=fed.y_test, **fed._round_kwargs(), **fed._algo_kwargs(0),
        )

    def timed(fn) -> tuple:
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    want = eager()
    eager_s = [timed(eager)[1] for _ in range(2)]
    span = _CapturedSpan(fed, perms, mask, sel_idx, True)
    got = span.run(fed, perms, mask, sel_idx)
    graph_s = [timed(lambda: span.run(fed, perms, mask, sel_idx))[1] for _ in range(2)]
    same = all(torch.equal(a, b) for a, b in zip(tree_leaves(want[0]), tree_leaves(got[0])))
    same &= torch.equal(want[2], got[2]) and torch.equal(want[3], got[3])
    summary = {"rounds": rounds, "bit_equal": same, "eager_s_per_round": [t / rounds for t in eager_s],
               "graph_s_per_round": [t / rounds for t in graph_s]}
    del span
    return same, summary


def drive_mnist() -> tuple[bool, dict]:
    """``bench.py``'s drive through ``examples/bench_mnist.run()`` on the
    card: it must cross 98% within ``MAX_ROUNDS`` with every accuracy and
    loss finite, and run no hand kernel (the path has none). Then, on a
    federation of the same configuration, the kernels of one eager round
    (``round_kernels``) and a captured span against the eager one
    (``graph_vs_eager``); last the CPU-vs-card round (``mnist_parity``)."""
    from p2pfl_tpu_torch.examples import bench_mnist
    from p2pfl_tpu_torch.learning.dataset import FederatedDataset
    from p2pfl_tpu_torch.models.vision import mlp
    from p2pfl_tpu_torch.ops import _kernels
    from p2pfl_tpu_torch.parallel.spmd import SpmdFederation

    _kernels.reset_launches()
    line = bench_mnist.run()
    hand = sum(_kernels.LAUNCHES.values())
    log(f"[mnist] bench line: {json.dumps(line)}")
    fed = SpmdFederation.from_dataset(
        mlp(), FederatedDataset.mnist(None, **bench_mnist.HARD_TASK), n_nodes=bench_mnist.N_NODES,
        batch_size=bench_mnist.BATCH, vote=False, seed=3, keep_opt_state=True,
    )
    per_round = round_kernels(fed)
    graph_ok, graph = graph_vs_eager(fed, bench_mnist.CHUNK)
    del fed
    par_ok, parity = mnist_parity()
    busy = per_round["device_ms"]
    checks = {
        "crossed 98% within MAX_ROUNDS": line["reached_acc"] >= bench_mnist.TARGET_ACC
        and line["rounds_to_target"] <= bench_mnist.MAX_ROUNDS,
        "accuracies and losses finite": all(math.isfinite(x) for x in line["accuracy_curve"] + line["train_losses"]),
        "no hand kernel launched": hand == 0,
        "card round agrees with the CPU round": par_ok,
        "captured span bit-equal to the eager span": graph_ok,
    }
    summary = {
        "s_per_round": line["sec_per_round"], "time_to_98_s": line["value"],
        "rounds_to_98": line["rounds_to_target"], "peak_memory_bytes": line["peak_memory_bytes"],
        "flops_per_round": line["flops_per_round"], "mfu": line["mfu"], "device": line["device"],
        "round_kernels": per_round,
        "busy_share_of_steady_round": busy / (line["sec_per_round"] * 1e3) if busy is not None else None,
        "graph_vs_eager": graph, "parity": parity, "checks": checks,
    }
    ok = all(checks.values())
    log(f"[mnist] {json.dumps(summary)} {'OK' if ok else 'FAIL'}")
    return ok, summary


PHASES = ("kernels", "offs", "main", "ring", "parity", "exchange", "gossip", "mnist")
#: phases that need more than one card: run only when named in --only
MULTI_CARD_PHASES = ("exchange_peer",)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--only", nargs="+", choices=PHASES + MULTI_CARD_PHASES, default=list(PHASES))
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
    for line in build_report(lib.with_suffix(".log").read_text()):
        log(f"[build] {line}")

    ok = True
    timings: dict = {}
    offs_timings: dict = {}
    launches: dict = {}
    phase_s: dict = {}

    def timed(name, fn, *a):
        t = time.perf_counter()
        result = fn(*a)
        phase_s[name] = round(time.perf_counter() - t, 1)
        return result

    if "kernels" in args.only:
        ok &= timed("kernels", check_kernels, timings)
    if "offs" in args.only:
        ok &= timed("offs", check_offs_kernels, offs_timings)
        ok &= timed("ring_timing", time_ring, offs_timings)
    if "main" in args.only:
        good, fused = timed("main_fused", drive_main_path, "auto")
        ok &= good
        launches.update({k: v for k, v in fused["launches"].items() if k in ("flash_fwd", "flash_bwd_dkvq")})
        good, split = timed("main_split", drive_main_path, "split")
        ok &= good
        launches.update({k: v for k, v in split["launches"].items() if k in ("flash_bwd_dq", "flash_bwd_dkv")})
    if "ring" in args.only:
        good, fused = timed("ring_fused", drive_ring_path, "auto", 22)
        ok &= good
        launches.update({k: v for k, v in fused["launches"].items()
                         if k in ("flash_fwd_offs", "flash_bwd_dkvq_offs")})
        good, split = timed("ring_split", drive_ring_path, "split", 22)
        ok &= good
        launches.update({k: v for k, v in split["launches"].items()
                         if k in ("flash_bwd_dq_offs", "flash_bwd_dkv_offs")})
    if "parity" in args.only:
        good, _ = timed("parity_flash", round_parity)
        ok &= good
        good, _ = timed("parity_ring", round_parity, "ring_flash", 512, 4)
        ok &= good
    exchange_timings: dict = {}
    if "exchange" in args.only:
        ok &= timed("exchange", check_exchange, exchange_timings)
    if "gossip" in args.only:
        good, gossip = timed("gossip", drive_gossip)
        ok &= good
        launches["ici_exchange"] = gossip["ici"]["launches_ici_exchange"]
    if "mnist" in args.only:
        good, _ = timed("mnist", drive_mnist)
        ok &= good
    if "exchange_peer" in args.only:
        ok &= timed("exchange_peer", check_exchange_peer, {})
    log(f"[time] seconds per phase: {json.dumps(phase_s)}")

    # kernels 1-4 report the causal case, the offset kernels the diagonal
    # hop, kernel 9 the gossip path's tree (the MLP's six fp32 leaves)
    rows = {**timings.get("causal", {}), **offs_timings.get("diagonal", {})}
    if "mlp_fp32" in exchange_timings:
        rows["ici_exchange"] = exchange_timings["mlp_fp32"]
    if rows:
        kernels = [
            {"name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
             "launches": launches.get(name, 0), **rows[name]}
            for name in REPLACES if name in rows
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
