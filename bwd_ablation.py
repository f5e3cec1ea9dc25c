#!/usr/bin/env python3
"""Time the Hopper flash backward (kernels 2, 3, 4, 6, 7, 8) against
ablations of its own sources, on one NVIDIA GPU, and show that the card
tests catch a lost barrier phase.

    python3 bwd_ablation.py                  # every build and hazard
    python3 bwd_ablation.py --only shipped dq_shipped
    python3 bwd_ablation.py --hazards-only

Each entry edits a source textually and is built with ``nvcc`` into its
own library under ``build/bwd_ablation/`` (the helpers of
``fwd_ablation.py``).

``ABLATIONS`` edit ``p2pfl_tpu_torch/csrc/flash_bwd_sm90.cu``, the fused
backward (kernels 2 and 6) and, compiled from the same template without
dQ, the split dK/dV pass (kernels 4 and 8); both are timed in every
build. Ablations undo one choice and must stay right: ``head_order`` and
``k_block_order`` (work items handed out head by head, or k block by k
block across all heads, in place of 16 heads at a time), ``stages_2`` /
``stages_4`` (the fused kernel's Q/dO ring depth), ``split_stages_2`` /
``_4`` / ``_6`` (the dK/dV pass's, which the shared memory freed of dQ's
tiles lets go deeper) and ``exp2f`` (in place of ``ex2.approx.ftz``).
Probes drop work to show
what it costs, so they are not held to the plain version:
``no_dq_reduce`` (dQ's bulk reductions), ``no_products`` (every ``wgmma``
product), ``no_softmax`` (the softmax gradient's arithmetic) and
``skeleton`` (all three: what is left is the loads, the barriers, the
shared-memory traffic and the loop).

``DQ_ABLATIONS`` edit ``p2pfl_tpu_torch/csrc/flash_bwd_dq_sm90.cu``, the
split dQ pass (kernels 3 and 7): ``dq_two_wg`` (two consumer warpgroups
of 64 q rows in place of three, 168 registers a thread in place of 128),
``dq_two_blocks`` (two such blocks an SM, 96 registers), ``dq_stages_2`` /
``dq_stages_3`` (the K/V ring's depth), ``dq_exp2f``, ``dq_mask_every_tile`` and
``dq_head_order`` (q tiles longest first within each head only), and the
probes ``dq_no_products`` and ``dq_skeleton``.

The sources hold every head width (32, 64, 128); the ring-depth and
consumer-count edits change widths 32 and 64, while width 128 keeps its
own layout (``setmaxnreg``, shared memory at its limit). Every build is
timed on device alone (behind a sleep kernel, median of 20) at width 64,
in four cases: causal and full at [4·32, 1024, 64], the diagonal and
fully visible ring hops at [2·32, 1024, 64] with a nonzero lse
cotangent, bf16; SDPA's backward alone on the same inputs is the
yardstick, and the shipped sources are timed again at the end, to show
the drift within the run. Each result is held to the plain versions with
``chip_smoke.check``'s limit.

``HAZARDS`` are mutations that must be caught: ``no_item_barrier``
removes the warpgroup barrier before a consumer releases the K/V buffer
of an item no q row sees (the lost-phase hang of kernels 2 and 6), and
``no_tile_barrier`` the one before the dK/dV pass releases a Q/dO stage
(a warp that falls two phases behind its warpgroup waits forever). Each
runs the card tests ``-k back_to_back``, then, if they pass, chip_smoke's
kernel phases (their timing loops), in a copy of the tree with the
mutated source, each in its own process under a timeout: a hang is
killed and counts as caught, as does a failure; passing both means the
checks cannot see the fault. Prints one JSON line per build and hazard and the card's name
and power limit; exits non-zero when a build fails, an ablation disagrees
with the plain version, a hazard goes uncaught, or there is no card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke
import fwd_ablation
from p2pfl_tpu_torch.ops import _kernels
from p2pfl_tpu_torch.ops import flash_attention as fa

SRC = Path(chip_smoke.BWD_SRC)
DQ_SRC = Path(chip_smoke.DQ_SRC)
OUT = Path("build/bwd_ablation")
REPO = Path(__file__).resolve().parent

NO_REDUCE = [("            tma_reduce_add(&tdq, base + stage_off + a * BQ * S::RB, (D / 2) * wg + a * S::RB / 4, q0, it.bh);\n",
              "            ;\n")]
NO_PRODUCTS = [
    ("        for (int kk = 0; kk < D / 16; ++kk) wgmma_ss(sc,", "        for (int kk = 0; kk < 0; ++kk) wgmma_ss(sc,"),
    ("        for (int kk = 0; kk < D / 16; ++kk) wgmma_ss(dp,", "        for (int kk = 0; kk < 0; ++kk) wgmma_ss(dp,"),
    ("  for (int kk = 0; kk < BQ / 16; ++kk) wgmma_rs<D>(dv_acc,", "  for (int kk = 0; kk < 0; ++kk) wgmma_rs<D>(dv_acc,"),
    ("  for (int kk = 0; kk < BQ / 16; ++kk) wgmma_rs<D>(dk_acc,", "  for (int kk = 0; kk < 0; ++kk) wgmma_rs<D>(dk_acc,"),
    ("        for (int kk = 0; kk < BK / 16; ++kk)\n", "        for (int kk = 0; kk < 0; ++kk)\n"),
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
    "split_stages_2": [("constexpr int SPLIT_STAGES = 3;", "constexpr int SPLIT_STAGES = 2;")],
    "split_stages_4": [("constexpr int SPLIT_STAGES = 3;", "constexpr int SPLIT_STAGES = 4;")],
    "split_stages_6": [("constexpr int SPLIT_STAGES = 3;", "constexpr int SPLIT_STAGES = 6;")],
    "exp2f": [("        float pv = ex2(fmaf(", "        float pv = exp2f(fmaf(")],
    "no_dq_reduce": NO_REDUCE,
    "no_products": NO_PRODUCTS,
    "no_softmax": NO_SOFTMAX,
    "skeleton": NO_REDUCE + NO_PRODUCTS + NO_SOFTMAX,
}

DQ_NO_PRODUCTS = [
    ("      for (int kk = 0; kk < D / 16; ++kk) wgmma_ss(sc,", "      for (int kk = 0; kk < 0; ++kk) wgmma_ss(sc,"),
    ("      for (int kk = 0; kk < D / 16; ++kk) wgmma_ss(dp,", "      for (int kk = 0; kk < 0; ++kk) wgmma_ss(dp,"),
    ("      for (int kk = 0; kk < BK / 16; ++kk) wgmma_rs<D>(acc,", "      for (int kk = 0; kk < 0; ++kk) wgmma_rs<D>(acc,"),
]
DQ_NO_SOFTMAX = [
    ("        float pv = ex2(fmaf(sc[idx], scale_log2, -m[h]));\n", "        float pv = sc[idx];\n"),
    ("        ds[e] = OFFS ? pv * (dp[idx] - dl[h] + gl[h]) : pv * (dp[idx] - dl[h]);", "        ds[e] = dp[idx];"),
]
DQ_ABLATIONS = {
    "dq_shipped": [],
    "dq_two_wg": [("constexpr int N_CONSUMERS = 3; // consumer warpgroups",
                   "constexpr int N_CONSUMERS = 2; // consumer warpgroups")],
    "dq_two_blocks": [("constexpr int N_CONSUMERS = 3; // consumer warpgroups",
                       "constexpr int N_CONSUMERS = 2; // consumer warpgroups"),
                      ("__global__ void __launch_bounds__(Dq<D>::NTHREADS, 1)",
                       "__global__ void __launch_bounds__(Dq<D>::NTHREADS, D == 128 ? 1 : 2)")],
    "dq_stages_2": [("constexpr int STAGES = 4;", "constexpr int STAGES = 2;")],
    "dq_stages_3": [("constexpr int STAGES = 4;", "constexpr int STAGES = 3;")],
    "dq_exp2f": [("        float pv = ex2(fmaf(", "        float pv = exp2f(fmaf(")],
    "dq_mask_every_tile": [("      if (masked(j)) softmax_grad<true, OFFS>", "      if (OFFS || causal) softmax_grad<true, OFFS>")],
    "dq_head_order": [
        ("const int bh = blockIdx.x;\n  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;",
         "const int bh = blockIdx.y;\n  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;"),
        ("dim3 grid(bh, (T + L::BQ - 1) / L::BQ);", "dim3 grid((T + L::BQ - 1) / L::BQ, bh);"),
    ],
    "dq_no_products": DQ_NO_PRODUCTS,
    "dq_skeleton": DQ_NO_PRODUCTS + DQ_NO_SOFTMAX,
}
#: builds that drop work on purpose: timed, not held to the plain version
PROBES = ("no_dq_reduce", "no_products", "no_softmax", "skeleton", "dq_no_products", "dq_skeleton")

#: mutations the card tests must catch (source, edits)
HAZARDS = {
    "no_item_barrier": (SRC, [(
        "      // next one (without this a late warp can miss a phase and hang)\n      named_bar(1 + wg, 128);\n",
        "      // next one (without this a late warp can miss a phase and hang)\n")]),
    "no_tile_barrier": (SRC, [("        // while its warpgroup skips tiles\n        named_bar(1 + wg, 128);\n",
                               "        // while its warpgroup skips tiles\n")]),
}
HAZARD_TIMEOUT_S = 240


def bind(lib: Path, names):
    dll = ctypes.CDLL(str(lib.resolve()))
    for name in names:
        fn = getattr(dll, name)
        fn.argtypes, fn.restype = _kernels.SIGNATURES[name], ctypes.c_int
    return dll


def _raise(rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"launch failed: {rc}")


def bwd_calls(lib: Path) -> dict:
    """kernel -> call(inputs, causal, offs) of the library built from the
    fused backward's source: kernel 2/6 → (dQ, dK, dV), kernel 4/8 → (dK,
    dV)."""
    dll = bind(lib, ("p2p_flash_bwd_dkvq", "p2p_flash_bwd_dkvq_offs", "p2p_flash_bwd_dkv", "p2p_flash_bwd_dkv_offs"))
    stream = _kernels._stream()

    def fused(x, causal, offs):
        q, k, v, do, lse, delta, glse = x
        b, h, t, d = q.shape
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        dq = _kernels._dq_accumulator(q)
        ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr()]
        out = [dk.data_ptr(), dv.data_ptr(), dq.data_ptr(), b * h, t, d]
        if offs is None:
            _raise(dll.p2p_flash_bwd_dkvq(*ptrs, *out, int(causal), stream))
        else:
            _raise(dll.p2p_flash_bwd_dkvq_offs(*ptrs, glse.data_ptr(), *out, *offs, stream))
        return dq.to(q.dtype), dk, dv

    def dkv(x, causal, offs):
        q, k, v, do, lse, delta, glse = x
        b, h, t, d = q.shape
        dk, dv = _kernels._dkv_outputs(k)
        ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr()]
        out = [dk.data_ptr(), dv.data_ptr(), b * h, t, d]
        if offs is None:
            _raise(dll.p2p_flash_bwd_dkv(*ptrs, *out, int(causal), stream))
        else:
            _raise(dll.p2p_flash_bwd_dkv_offs(*ptrs, glse.data_ptr(), *out, *offs, stream))
        return dk, dv

    return {"fused": fused, "dkv": dkv}


def dq_calls(lib: Path) -> dict:
    """kernel 3/7 → dQ, from a library built from the dQ pass's source."""
    dll = bind(lib, ("p2p_flash_bwd_dq", "p2p_flash_bwd_dq_offs"))
    stream = _kernels._stream()

    def dq(x, causal, offs):
        q, k, v, do, lse, delta, glse = x
        b, h, t, d = q.shape
        out = torch.empty_like(q)
        ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr()]
        if offs is None:
            _raise(dll.p2p_flash_bwd_dq(*ptrs, out.data_ptr(), b * h, t, d, int(causal), stream))
        else:
            _raise(dll.p2p_flash_bwd_dq_offs(*ptrs, glse.data_ptr(), out.data_ptr(), b * h, t, d, *offs, stream))
        return (out,)

    return {"dq": dq}


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


def references(runs: dict) -> dict:
    """case -> ((dQ, dK, dV) of the plain version, their terms' magnitudes)."""
    refs = {}
    for c, (x, causal, offs) in runs.items():
        if offs is None:
            args = (*x[:6], causal, 64, 64)
            refs[c] = (fa.flash_bwd_fused_plain(*args), fa.flash_bwd_magnitude(*args))
        else:
            args = (*x, *offs, 64, 64)
            refs[c] = (fa.flash_bwd_fused_offs_plain(*args), fa.flash_bwd_offs_magnitude(*args))
    return refs


#: which outputs of (dQ, dK, dV) each kernel family gives
OUTPUTS = {"fused": (0, 1, 2), "dkv": (1, 2), "dq": (0,)}


def run_builds(ablations: dict, built: dict, calls_of, runs: dict, refs: dict) -> bool:
    ok = True
    for name in [*ablations, next(iter(ablations))]:  # the shipped build again at the end
        lib, report = built[name]
        row = {"name": name, **fwd_ablation.ptxas_summary(report)}
        if lib is None:
            print(json.dumps({**row, "error": report[-2000:]}), flush=True)
            ok = False
            continue
        for kernel, call in calls_of(lib).items():
            worst = max(
                chip_smoke.check(got, refs[c][0][i], refs[c][1][i])[2]
                for c, case in runs.items() for got, i in zip(call(*case), OUTPUTS[kernel]))
            times = {c: chip_smoke.time_device_ms(lambda case=case: call(*case)) for c, case in runs.items()}
            row[kernel] = {"worst_share": worst, "device_ms": times}
            if name not in PROBES:
                ok &= worst <= 1.0
        print(json.dumps(row), flush=True)
    return ok


def run_hazard(name: str) -> dict:
    """In a copy of the tree whose source carries the hazard's edit, the
    card tests ``-k back_to_back`` and then, if they pass, chip_smoke's
    kernel phases with their timing loops; each in a process of its own
    under a timeout (a hung kernel is killed with it). The first that
    fails or hangs has caught the hazard."""
    src, edits = HAZARDS[name]
    tree = (OUT / f"hazard_{name}").resolve()
    shutil.rmtree(tree, ignore_errors=True)
    shutil.copytree(REPO, tree, ignore=shutil.ignore_patterns("build", "chiprun_out", ".git", "__pycache__"))
    (tree / src).write_text(fwd_ablation.ablated_source(edits, src))
    checks = (
        ("back-to-back card tests", [sys.executable, "-m", "pytest", "-q", "-x", "-p", "no:cacheprovider", "-m",
                                     "cuda", "tests/test_torch_cuda_kernels.py", "-k", "back_to_back"]),
        ("chip_smoke timing loops", [sys.executable, "chip_smoke.py", "--only", "kernels", "offs"]),
    )
    row = {"hazard": name, "timeout_s": HAZARD_TIMEOUT_S, "caught": False, "runs": []}
    for check, cmd in checks:
        proc = subprocess.run(["timeout", "-s", "KILL", str(HAZARD_TIMEOUT_S), *cmd], cwd=tree,
                              capture_output=True, text=True, check=False)
        # the KILL reaches timeout's whole process group: -9 (or 137) is a hang
        outcome = "passed" if proc.returncode == 0 else (
            "hung (killed at the timeout)" if proc.returncode in (-9, 137) else "failed")
        tail = (proc.stdout + proc.stderr).strip().splitlines()[-2:]
        row["runs"].append({"check": check, "rc": proc.returncode, "outcome": outcome, "tail": tail})
        if proc.returncode != 0:
            row["caught"] = True
            break
    return row


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--only", nargs="+", choices=[*ABLATIONS, *DQ_ABLATIONS], help="builds to time")
    parser.add_argument("--hazards-only", action="store_true", help="run the hazards and nothing else")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("bwd_ablation: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    ok = True
    if not args.hazards_only:
        pick = set(args.only) if args.only else None
        bwd = {n: e for n, e in ABLATIONS.items() if pick is None or n in pick or n == "shipped"}
        dq = {n: e for n, e in DQ_ABLATIONS.items() if pick is None or n in pick or n == "dq_shipped"}
        built = fwd_ablation.build_all(bwd, SRC, OUT)
        built.update(fwd_ablation.build_all(dq, DQ_SRC, OUT))
        runs = cases()
        refs = references(runs)
        # SDPA's backward alone: a fully visible hop is the full backward
        yard = {c: chip_smoke.time_device_ms(chip_smoke.sdpa_backward(*runs[c][0][:4], is_causal=causal))
                for c, causal in (("causal", True), ("full", False), ("diagonal", True), ("visible", False))}
        print(json.dumps({"sdpa_backward_device_ms": yard}), flush=True)
        ok &= run_builds(bwd, built, bwd_calls, runs, refs)
        ok &= run_builds(dq, built, dq_calls, runs, refs)
    if args.hazards_only or not args.only:
        for name in HAZARDS:
            row = run_hazard(name)
            ok &= row["caught"]
            print(json.dumps(row), flush=True)
    print(chip_smoke.smi_line(), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
