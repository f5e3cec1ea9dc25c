#!/usr/bin/env python3
"""Time the Hopper fused flash backward (kernels 2 and 6) against ablations
of its own source, on one NVIDIA GPU.

    python3 bwd_ablation.py

Each entry edits ``p2pfl_tpu_torch/csrc/flash_bwd_sm90.cu`` textually and
is built with ``nvcc`` into its own library under ``build/bwd_ablation/``
(the helpers of ``fwd_ablation.py``). Ablations undo one choice and must
stay right: ``head_order`` and ``k_block_order`` (work items handed out
head by head, or k block by k block across all heads, in place of 16
heads at a time), ``stages_2`` / ``stages_4`` (the Q/dO ring's depth)
and ``exp2f`` (in place of ``ex2.approx.ftz``).
Probes drop work to show what it costs, so they are not held to the plain
version: ``no_dq_reduce`` (dQ's bulk reductions), ``no_products`` (all
five ``wgmma`` products), ``no_softmax`` (the softmax gradient's
arithmetic) and ``skeleton`` (all three: what is left is the loads, the
barriers, the shared-memory traffic and the loop). Every build is timed
on device alone (behind a sleep kernel, median of 20) in four cases:
kernel 2 causal and full at [4·32, 1024, 64], kernel 6's diagonal and
fully visible ring hops at [2·32, 1024, 64] with a nonzero lse cotangent,
bf16; SDPA's backward alone on the same inputs is the yardstick, and the
shipped source is timed again at the end, to show the drift within the
run. Prints one JSON line per build and the card's name and power limit;
exits non-zero when a build fails, an ablation disagrees with the plain
version, or there is no card.
"""

from __future__ import annotations

import ctypes
import json
import sys
from pathlib import Path

import torch

import chip_smoke
import fwd_ablation
from p2pfl_tpu_torch.ops import _kernels
from p2pfl_tpu_torch.ops import flash_attention as fa

SRC = Path(chip_smoke.BWD_SRC)
OUT = Path("build/bwd_ablation")

NO_REDUCE = [("      if (tid == 0) tma_reduce_add(&tdq, base + stage_off, 32 * wg, q0, it.bh);\n", "")]
NO_PRODUCTS = [
    ("        for (int kk = 0; kk < D / 16; ++kk) wgmma_ss(sc,", "        for (int kk = 0; kk < 0; ++kk) wgmma_ss(sc,"),
    ("        for (int kk = 0; kk < D / 16; ++kk) wgmma_ss(dp,", "        for (int kk = 0; kk < 0; ++kk) wgmma_ss(dp,"),
    ("      for (int kk = 0; kk < BQ / 16; ++kk) wgmma_rs(dv_acc,", "      for (int kk = 0; kk < 0; ++kk) wgmma_rs(dv_acc,"),
    ("      for (int kk = 0; kk < BQ / 16; ++kk) wgmma_rs(dk_acc,", "      for (int kk = 0; kk < 0; ++kk) wgmma_rs(dk_acc,"),
    ("      for (int kk = 0; kk < BK / 16; ++kk)\n", "      for (int kk = 0; kk < 0; ++kk)\n"),
]
NO_SOFTMAX = [
    ("        float pv = ex2(fmaf(sc[idx], scale_log2, -m));\n", "        float pv = sc[idx];\n"),
    ("        ds[h][e] = OFFS ? pv * (dp[idx] - dl_e + gl_e) : pv * (dp[idx] - dl_e);",
     "        ds[h][e] = dp[idx];"),
]
ABLATIONS = {
    "shipped": [],
    "head_order": [("constexpr int GROUP = 16;", "constexpr int GROUP = 1;")],
    "k_block_order": [("constexpr int GROUP = 16;", "constexpr int GROUP = 1 << 20;")],
    "stages_2": [("constexpr int STAGES = 3;", "constexpr int STAGES = 2;")],
    "stages_4": [("constexpr int STAGES = 3;", "constexpr int STAGES = 4;")],
    "exp2f": [("        float pv = ex2(fmaf(", "        float pv = exp2f(fmaf(")],
    "no_dq_reduce": NO_REDUCE,
    "no_products": NO_PRODUCTS,
    "no_softmax": NO_SOFTMAX,
    "skeleton": NO_REDUCE + NO_PRODUCTS + NO_SOFTMAX,
}
#: builds that drop work on purpose: timed, not held to the plain version
PROBES = ("no_dq_reduce", "no_products", "no_softmax", "skeleton")


def bind(lib: Path):
    dll = ctypes.CDLL(str(lib.resolve()))
    for name in ("p2p_flash_bwd_dkvq", "p2p_flash_bwd_dkvq_offs"):
        fn = getattr(dll, name)
        fn.argtypes, fn.restype = _kernels.SIGNATURES[name], ctypes.c_int
    stream = _kernels._stream()

    def call(x, causal, offs):
        """One launch on a case: (q, k, v, dO, lse, delta, g_lse), causal,
        (q_off, k_off) or None → (dQ, dK, dV)."""
        q, k, v, do, lse, delta, glse = x
        b, h, t, d = q.shape
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        dq = _kernels._dq_accumulator(q)
        ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr()]
        out = [dk.data_ptr(), dv.data_ptr(), dq.data_ptr(), b * h, t, d]
        if offs is None:
            rc = dll.p2p_flash_bwd_dkvq(*ptrs, *out, int(causal), stream)
        else:
            rc = dll.p2p_flash_bwd_dkvq_offs(*ptrs, glse.data_ptr(), *out, *offs, stream)
        if rc != 0:
            raise RuntimeError(f"launch failed: {rc}")
        return dq.to(q.dtype), dk, dv

    return call


def cases() -> dict:
    """case -> (inputs, causal, (q_off, k_off) or None), chip_smoke's shapes."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn((4, 32, 1024, 64), generator=gen, device="cuda").to(torch.bfloat16)
                   for _ in range(4))
    out = {}
    for name, causal in (("causal", True), ("full", False)):
        o, lse = _kernels.flash_fwd(q, k, v, causal)
        out[name] = ((q, k, v, do, lse, (do.float() * o.float()).sum(-1), None), causal, None)
    q6, k6, v6, do6 = (x[:2].contiguous() for x in (q, k, v, do))
    for name, offs in (("diagonal", (1024, 1024)), ("visible", (2048, 0))):
        o, lse = _kernels.flash_fwd_offs(q6, k6, v6, *offs)
        glse = torch.randn(lse.shape, generator=gen, device="cuda")
        out[name] = ((q6, k6, v6, do6, lse, (do6.float() * o.float()).sum(-1), glse), True, offs)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("bwd_ablation: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    built = fwd_ablation.build_all(ABLATIONS, SRC, OUT)
    runs = cases()
    refs = {c: (fa.flash_bwd_fused_plain(*x[:6], causal, 64, 64) if offs is None
                else fa.flash_bwd_fused_offs_plain(*x, *offs, 64, 64)) for c, (x, causal, offs) in runs.items()}
    # SDPA's backward alone: a fully visible hop is the full backward
    yard = {c: chip_smoke.time_device_ms(chip_smoke.sdpa_backward(*runs[c][0][:4], is_causal=causal))
            for c, causal in (("causal", True), ("full", False), ("diagonal", True), ("visible", False))}
    print(json.dumps({"sdpa_backward_device_ms": yard}), flush=True)
    ok = True
    for name in [*ABLATIONS, "shipped"]:
        lib, report = built[name]
        row = {"name": name, **fwd_ablation.ptxas_summary(report)}
        if lib is None:
            print(json.dumps({**row, "error": report[-2000:]}), flush=True)
            ok = False
            continue
        call = bind(lib)
        worst = max(chip_smoke.check(got, want)[2]
                    for c, case in runs.items() for got, want in zip(call(*case), refs[c]))
        times = {c: chip_smoke.time_device_ms(lambda case=case: call(*case)) for c, case in runs.items()}
        row.update(worst_share=worst, device_ms=times)
        if name not in PROBES:
            ok &= worst <= 1.0
        print(json.dumps(row), flush=True)
    print(chip_smoke.smi_line(), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
