"""Build, bind and launch the hand-written CUDA kernels of ``csrc/``.

``csrc/flash_attention.cu`` is compiled with ``nvcc`` for ``sm_90a`` into a
shared library under ``build/p2pfl_tpu_torch/`` (beside the package, git
ignored) at first use, and bound through ``ctypes`` with its plain C
interface. The library's name carries a hash of the source, so an edited
source is never served by a stale build. Nothing here runs at import: the
build happens inside the first launch.

Each wrapper checks device, dtype, contiguity and shapes and raises on
anything the kernels were not built for; it launches on PyTorch's current
stream, raises if the launch returned a CUDA error, and adds one to its
entry in :data:`LAUNCHES`. Outputs and scratch are allocated here with
``torch.empty`` / ``torch.zeros``; the kernels allocate nothing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import torch

from p2pfl_tpu_torch.exceptions import KernelBuildError

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = (CSRC / "flash_attention.cu",)
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "p2pfl_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
HEAD_DIM = 64  # the only head width built (the slice's)
TILE = 64  # the kernels' q/k tile: T must be a multiple

#: launches per kernel since the last :func:`reset_launches`
LAUNCHES: dict[str, int] = {
    "flash_fwd": 0, "flash_bwd_dkvq": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
    "flash_fwd_offs": 0, "flash_bwd_dkvq_offs": 0, "flash_bwd_dq_offs": 0,
    "flash_bwd_dkv_offs": 0,
}

_P, _I = ctypes.c_void_p, ctypes.c_int
#: ctypes argument types of every C entry point (pointers and the stream
#: are c_void_p, ints c_int: ctypes would otherwise cut a pointer to 32 bits)
SIGNATURES = {
    "p2p_flash_fwd": [_P] * 5 + [_I] * 4 + [_P],
    "p2p_flash_bwd_dkvq": [_P] * 9 + [_I] * 4 + [_P],
    "p2p_flash_bwd_dkv": [_P] * 8 + [_I] * 4 + [_P],
    "p2p_flash_bwd_dq": [_P] * 7 + [_I] * 4 + [_P],
    "p2p_flash_fwd_offs": [_P] * 5 + [_I] * 5 + [_P],
    "p2p_flash_bwd_dkvq_offs": [_P] * 10 + [_I] * 5 + [_P],
    "p2p_flash_bwd_dkv_offs": [_P] * 9 + [_I] * 5 + [_P],
    "p2p_flash_bwd_dq_offs": [_P] * 8 + [_I] * 5 + [_P],
}

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise KernelBuildError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


def library_path() -> Path:
    digest = hashlib.sha256()
    for src in SOURCES:
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libp2pfl_flash_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``csrc/`` into the build directory unless already built.
    The compiler's report (registers, shared memory, spills) is kept in
    ``<library>.log``."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *(str(s) for s in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise KernelBuildError(
            f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}"
        )
    os.replace(tmp, out)
    return out


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def _check(name: str, rc: int) -> None:
    if rc == -1:
        raise ValueError(f"{name}: shape not supported by the kernel")
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")
    LAUNCHES[name] += 1


def _check_inputs(**tensors: torch.Tensor) -> tuple[int, int, int, int]:
    """All [B, H, T, D] bf16 (or [B, H, T] fp32 rows) contiguous on one GPU."""
    q = tensors["q"]
    if q.dim() != 4:
        raise ValueError(f"expected [B, H, T, D], got {tuple(q.shape)}")
    b, h, t, d = q.shape
    for name, x in tensors.items():
        if not x.is_cuda or x.device != q.device:
            raise ValueError(f"{name} must lie on the CUDA device of q")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        row = name in ("lse", "delta", "glse")
        want_dtype = torch.float32 if row else torch.bfloat16
        if x.dtype != want_dtype:
            raise TypeError(f"{name}: the kernels take {want_dtype}, got {x.dtype}")
        want_shape = (b, h, t) if row else (b, h, t, d)
        if tuple(x.shape) != want_shape:
            raise ValueError(f"{name}: shape {tuple(x.shape)} != {want_shape}")
    if d != HEAD_DIM:
        raise ValueError(f"head_dim {d} not built (built: {HEAD_DIM})")
    if t % TILE:
        raise ValueError(f"T={t} must be a multiple of {TILE}")
    return b, h, t, d


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def flash_fwd(q, k, v, causal: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """[B, H, T, D] bf16 → (O [B, H, T, D] bf16, lse [B, H, T] fp32)."""
    b, h, t, d = _check_inputs(q=q, k=k, v=v)
    lib = _load()
    o = torch.empty_like(q)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    rc = lib.p2p_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        b * h, t, d, int(causal), _stream(),
    )
    _check("flash_fwd", rc)
    return o, lse


def flash_bwd_fused(q, k, v, do, lse, delta, causal: bool):
    """Single pass: (dQ, dK, dV). dQ sums in an fp32 buffer through atomics
    and is cast to the input dtype here."""
    b, h, t, d = _check_inputs(q=q, k=k, v=v, do=do, lse=lse, delta=delta)
    lib = _load()
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    dq_acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    rc = lib.p2p_flash_bwd_dkvq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), dq_acc.data_ptr(),
        b * h, t, d, int(causal), _stream(),
    )
    _check("flash_bwd_dkvq", rc)
    return dq_acc.to(q.dtype), dk, dv


def flash_bwd_dq(q, k, v, do, lse, delta, causal: bool) -> torch.Tensor:
    """Split pass 1: dQ per q tile (no cross-block state)."""
    b, h, t, d = _check_inputs(q=q, k=k, v=v, do=do, lse=lse, delta=delta)
    lib = _load()
    dq = torch.empty_like(q)
    rc = lib.p2p_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), b * h, t, d, int(causal), _stream(),
    )
    _check("flash_bwd_dq", rc)
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, causal: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """Split pass 2: dK/dV per k tile."""
    b, h, t, d = _check_inputs(q=q, k=k, v=v, do=do, lse=lse, delta=delta)
    lib = _load()
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    rc = lib.p2p_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b * h, t, d, int(causal),
        _stream(),
    )
    _check("flash_bwd_dkv", rc)
    return dk, dv


def flash_bwd_split(q, k, v, do, lse, delta, causal: bool):
    """Two passes with no cross-block state: (dQ, dK, dV)."""
    dq = flash_bwd_dq(q, k, v, do, lse, delta, causal)
    return (dq, *flash_bwd_dkv(q, k, v, do, lse, delta, causal))


# ---- offset-aware variants: one ring-attention hop, causal by global
# offsets (q row i attends k row j where q_off + i >= k_off + j) ----


def _check_offsets(q_off: int, k_off: int) -> tuple[int, int]:
    q_off, k_off = int(q_off), int(k_off)
    if not (0 <= q_off < 2 ** 31 and 0 <= k_off < 2 ** 31):
        raise ValueError(f"offsets ({q_off}, {k_off}) must fit a non-negative int32")
    return q_off, k_off


def flash_fwd_offs(q, k, v, q_off: int, k_off: int) -> tuple[torch.Tensor, torch.Tensor]:
    """[B, H, T, D] bf16 → (O, lse [B, H, T] fp32); a row that sees
    nothing gets O = 0 and lse = -1e30."""
    b, h, t, d = _check_inputs(q=q, k=k, v=v)
    q_off, k_off = _check_offsets(q_off, k_off)
    lib = _load()
    o = torch.empty_like(q)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    rc = lib.p2p_flash_fwd_offs(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        b * h, t, d, q_off, k_off, _stream(),
    )
    _check("flash_fwd_offs", rc)
    return o, lse


def flash_bwd_fused_offs(q, k, v, do, lse, delta, glse, q_off: int, k_off: int):
    """Single pass with the lse cotangent ``glse`` [B, H, T] fp32: (dQ, dK,
    dV). dQ rows no k tile reaches keep the zeroed buffer's 0."""
    b, h, t, d = _check_inputs(q=q, k=k, v=v, do=do, lse=lse, delta=delta, glse=glse)
    q_off, k_off = _check_offsets(q_off, k_off)
    lib = _load()
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    dq_acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    rc = lib.p2p_flash_bwd_dkvq_offs(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), glse.data_ptr(), dk.data_ptr(), dv.data_ptr(), dq_acc.data_ptr(),
        b * h, t, d, q_off, k_off, _stream(),
    )
    _check("flash_bwd_dkvq_offs", rc)
    return dq_acc.to(q.dtype), dk, dv


def flash_bwd_dq_offs(q, k, v, do, lse, delta, glse, q_off: int, k_off: int) -> torch.Tensor:
    """Split pass 1 of the offset backward: dQ per q tile."""
    b, h, t, d = _check_inputs(q=q, k=k, v=v, do=do, lse=lse, delta=delta, glse=glse)
    q_off, k_off = _check_offsets(q_off, k_off)
    lib = _load()
    dq = torch.empty_like(q)
    rc = lib.p2p_flash_bwd_dq_offs(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), glse.data_ptr(), dq.data_ptr(), b * h, t, d, q_off, k_off, _stream(),
    )
    _check("flash_bwd_dq_offs", rc)
    return dq


def flash_bwd_dkv_offs(q, k, v, do, lse, delta, glse, q_off: int, k_off: int):
    """Split pass 2 of the offset backward: dK/dV per k tile."""
    b, h, t, d = _check_inputs(q=q, k=k, v=v, do=do, lse=lse, delta=delta, glse=glse)
    q_off, k_off = _check_offsets(q_off, k_off)
    lib = _load()
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    rc = lib.p2p_flash_bwd_dkv_offs(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), glse.data_ptr(), dk.data_ptr(), dv.data_ptr(), b * h, t, d,
        q_off, k_off, _stream(),
    )
    _check("flash_bwd_dkv_offs", rc)
    return dk, dv


def flash_bwd_split_offs(q, k, v, do, lse, delta, glse, q_off: int, k_off: int):
    """Two offset passes with no cross-block state: (dQ, dK, dV)."""
    dq = flash_bwd_dq_offs(q, k, v, do, lse, delta, glse, q_off, k_off)
    return (dq, *flash_bwd_dkv_offs(q, k, v, do, lse, delta, glse, q_off, k_off))
