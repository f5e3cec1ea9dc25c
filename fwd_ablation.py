#!/usr/bin/env python3
"""Time the Hopper flash forward (kernels 1 and 5) against ablations of its
own source, on one NVIDIA GPU.

    python3 fwd_ablation.py

Each ablation undoes choices of ``p2pfl_tpu_torch/csrc/flash_fwd_sm90.cu``
by a textual edit of the source: ``exp2f`` in place of ``ex2.approx.ftz``;
the mask on every tile of a causal launch; the q tiles ordered longest
first within each head only; two or four K/V stages; and ``first``, the
first three at once (close to the forward's first design).
``skip_rescale`` and ``four_chains`` try alternatives: O rescaled only
where a row's max moved, and the row maxima and sums in four partial
chains. Each build is compiled with ``nvcc`` into its own library under
``build/fwd_ablation/``, held against the plain PyTorch version (the
tolerances of ``chip_smoke.py``) and timed on device alone (behind a
sleep kernel, median of 20) at head width 64 (each edit changes every
width's instantiation) in the cases of ``chip_smoke.py``: kernel 1
causal and full at [4·32, 1024, 64], kernel 5 diagonal, fully visible and
fully masked at [2·32, 1024, 64], bf16. SDPA's forward on the same inputs
is timed as the yardstick, and the shipped source again at the end, to
show the drift within the run. Prints one JSON line per build and the
card's name and power limit; exits non-zero when a build fails or
disagrees with the plain version, or there is no card.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke
from p2pfl_tpu_torch.ops import _kernels
from p2pfl_tpu_torch.ops import flash_attention as fa

SRC = Path(chip_smoke.FWD_SRC)
OUT = Path("build/fwd_ablation")

EXP2F = [("alpha[h] = ex2(", "alpha[h] = exp2f("), ("x = ex2(fmaf(", "x = exp2f(fmaf(")]
MASK_EVERY_TILE = [("if (masked(j)) softmax_tile<true>", "if (OFFS || causal) softmax_tile<true>")]
HEAD_ORDER = [
    ("const int bh = blockIdx.x;\n  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;",
     "const int bh = blockIdx.y;\n  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;"),
    ("dim3 grid(bh, (T + BQ - 1) / BQ);", "dim3 grid((T + BQ - 1) / BQ, bh);"),
]
# not ablations: alternatives that were tried. O rescaled only where a
# row of the warp moved its max (alpha is exactly 1 elsewhere), and four
# partial chains for the row maxima and sums
SKIP_RESCALE = [("      rescale(acc, alpha);\n",
                 "      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f))\n"
                 "        rescale(acc, alpha);\n")]
FOUR_CHAINS = [
    ("float mx = -INFINITY;", "float mx4[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};"),
    ("mx = fmaxf(mx, x);", "mx4[i % 4] = fmaxf(mx4[i % 4], x);"),
    ("quad_max(mx)", "quad_max(fmaxf(fmaxf(mx4[0], mx4[1]), fmaxf(mx4[2], mx4[3])))"),
    ("float sum = 0.f;", "float sum4[4] = {0.f, 0.f, 0.f, 0.f};"),
    ("sum += x;", "sum4[i % 4] += x;"),
    ("l[h] * alpha[h] + sum;", "l[h] * alpha[h] + ((sum4[0] + sum4[1]) + (sum4[2] + sum4[3]));"),
]
ABLATIONS = {
    "shipped": [],
    "exp2f": EXP2F,
    "mask_every_tile": MASK_EVERY_TILE,
    "head_order": HEAD_ORDER,
    "stages_2": [("constexpr int STAGES = 3;", "constexpr int STAGES = 2;")],
    "stages_4": [("constexpr int STAGES = 3;", "constexpr int STAGES = 4;")],
    "first": EXP2F + MASK_EVERY_TILE + HEAD_ORDER,
    "skip_rescale": SKIP_RESCALE,
    "four_chains": FOUR_CHAINS,
}


def ablated_source(edits, src: Path = SRC) -> str:
    text = src.read_text()
    for old, new in edits:
        if old not in text:
            raise ValueError(f"ablation edit no longer matches the source: {old!r}")
        text = text.replace(old, new)
    return text


def build_all(ablations: dict = ABLATIONS, src_path: Path = SRC, out: Path = OUT) -> dict:
    """One nvcc per ablation, all at once: name -> (library or None, ptxas
    report). The edited copies include ``csrc/sm90_common.cuh`` from the
    package."""
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in ablations.items():
        src = out / f"{name}.cu"
        src.write_text(ablated_source(edits, src_path))
        lib = out / f"lib_{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-I", str(_kernels.CSRC), "-shared", "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (lib, proc) in procs.items():
        report = proc.communicate()[0]
        built[name] = (lib if proc.returncode == 0 else None, report)
    return built


def ptxas_summary(report: str) -> dict:
    return {
        "registers": [int(r) for r in re.findall(r"Used (\d+) registers", report)],
        "spills": sorted({line.strip() for line in report.splitlines()
                          if "spill" in line and "0 bytes spill stores, 0 bytes spill loads" not in line}),
        "serialised": "Potential Performance Loss" in report,
    }


def bind(lib: Path):
    dll = ctypes.CDLL(str(lib.resolve()))
    for name in ("p2p_flash_fwd", "p2p_flash_fwd_offs"):
        fn = getattr(dll, name)
        fn.argtypes, fn.restype = _kernels.SIGNATURES[name], ctypes.c_int
    stream = _kernels._stream()

    def call(x, causal, offs):
        """One launch on a case: (q, k, v), causal, (q_off, k_off) or None."""
        q, k, v = x
        b, h, t, d = q.shape
        o, lse = torch.empty_like(q), torch.empty((b, h, t), dtype=torch.float32, device=q.device)
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(), b * h, t, d)
        if offs is None:
            rc = dll.p2p_flash_fwd(*ptrs, int(causal), stream)
        else:
            rc = dll.p2p_flash_fwd_offs(*ptrs, *offs, stream)
        if rc != 0:
            raise RuntimeError(f"launch failed: {rc}")
        return o, lse

    return call


def main() -> int:
    if not torch.cuda.is_available():
        print("fwd_ablation: no CUDA device", file=sys.stderr)
        return 2
    built = build_all()
    gen = torch.Generator(device="cuda").manual_seed(0)
    q1, k1, v1 = (torch.randn((4, 32, 1024, 64), generator=gen, device="cuda").to(torch.bfloat16)
                  for _ in range(3))
    q5, k5, v5 = (x[:2].contiguous() for x in (q1, k1, v1))
    # case -> (inputs, causal, (q_off, k_off) or None)
    cases = {
        "causal": ((q1, k1, v1), True, None), "full": ((q1, k1, v1), False, None),
        "diagonal": ((q5, k5, v5), True, (1024, 1024)), "visible": ((q5, k5, v5), True, (2048, 0)),
        "masked": ((q5, k5, v5), True, (0, 1024)),
    }
    refs = {c: (fa.flash_fwd_plain(*x, causal, 128, 128) if offs is None
                else fa.flash_fwd_offs_plain(*x, *offs, 128, 128)) for c, (x, causal, offs) in cases.items()}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    # the same function as one SDPA call: a fully visible hop is the full
    # forward; a fully masked one has none
    sdpa_causal = {"causal": True, "full": False, "diagonal": True, "visible": False}
    yard = {c: chip_smoke.time_device_ms(lambda x=cases[c][0], causal=causal: sdpa(*x, is_causal=causal))
            for c, causal in sdpa_causal.items()}
    print(json.dumps({"sdpa_device_ms": yard}), flush=True)
    ok = True
    for name in [*ABLATIONS, "shipped"]:
        lib, report = built[name]
        row = {"name": name, **ptxas_summary(report)}
        if lib is None:
            print(json.dumps({**row, "error": report[-2000:]}), flush=True)
            ok = False
            continue
        call = bind(lib)
        worst, lse_err = 0.0, 0.0
        for c, case in cases.items():
            o, lse = call(*case)
            worst = max(worst, chip_smoke.check(o, refs[c][0])[2])
            lse_err = max(lse_err, (lse - refs[c][1]).abs().max().item())
        times = {c: chip_smoke.time_device_ms(lambda case=case: call(*case)) for c, case in cases.items()}
        row.update(worst_share=worst, lse_err=lse_err, device_ms=times)
        ok &= worst <= 1.0 and lse_err <= chip_smoke.LSE_TOL
        print(json.dumps(row), flush=True)
    print(chip_smoke.smi_line(), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
