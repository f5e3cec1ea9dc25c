"""Build, bind and launch the hand-written CUDA kernels of ``csrc/``.

``csrc/flash_fwd_sm90.cu`` (kernels 1 and 5, the forward: TMA, ``wgmma``),
``csrc/flash_bwd_sm90.cu`` (kernels 2 and 6, the fused backward: TMA,
``wgmma``, dQ by bulk reductions; and kernels 4 and 8, the split
backward's dK/dV pass, the same template without dQ),
``csrc/flash_bwd_dq_sm90.cu`` (kernels 3 and 7, the split backward's dQ
pass: TMA, ``wgmma``), ``csrc/ici_exchange.cu`` (kernel 9) and
``csrc/fleet_chunk.cu`` (the megafleet chunk step, a span of chunks a
launch: a port-only kernel) are
compiled with ``nvcc`` for ``sm_90a``, one ``nvcc`` per source,
all started together, and linked
into one shared library under ``build/p2pfl_tpu_torch/`` (beside the
package, git ignored) at first use, bound through ``ctypes`` with their
plain C interface. The library's name carries a hash of the sources, so
an edited source is never served by a stale build. Nothing here runs at
import: the build happens inside the first launch.

The flash kernels are built at head widths 32, 64 and 128
(:data:`HEAD_DIMS`: one instantiation a width of each template, the
shared-memory layouts in ``csrc/sm90_common.cuh``); the C entry points
dispatch on the width they are given. :data:`LAUNCHES_BY_WIDTH` counts
the flash launches of each width beside :data:`LAUNCHES`.

Each wrapper checks device, dtype, contiguity and shapes and raises on
anything the kernels were not built for (any other head width too); it launches on PyTorch's current
stream, raises if the launch returned a CUDA error, and adds one to its
entry in :data:`LAUNCHES`. Outputs and scratch are allocated here with
``torch.empty`` / ``torch.zeros``; the kernels allocate nothing.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
import threading
from pathlib import Path
from typing import Optional

import torch

from p2pfl_tpu_torch.exceptions import KernelBuildError

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = tuple(CSRC / name for name in (
    "flash_bwd_dq_sm90.cu", "flash_bwd_sm90.cu", "flash_fwd_sm90.cu", "fleet_chunk.cu", "ici_exchange.cu"))
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "p2pfl_tpu_torch"
GENCODE = ("-gencode", "arch=compute_90a,code=sm_90a")
#: flags of each source's compile (``-c``); the link adds ``-shared``
NVCC_FLAGS = (*GENCODE, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
HEAD_DIMS = (32, 64, 128)  # the head widths built
TILE = 64  # the kernels' q/k tile: T must be a multiple

#: launches per kernel since the last :func:`reset_launches`
LAUNCHES: dict[str, int] = {
    "flash_fwd": 0, "flash_bwd_dkvq": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
    "flash_fwd_offs": 0, "flash_bwd_dkvq_offs": 0, "flash_bwd_dq_offs": 0,
    "flash_bwd_dkv_offs": 0, "ici_exchange": 0, "fleet_chunk": 0,
}

#: the flash kernels' launches by head width since the last :func:`reset_launches`
LAUNCHES_BY_WIDTH: dict[str, dict[int, int]] = {
    name: {d: 0 for d in HEAD_DIMS} for name in LAUNCHES if name.startswith("flash_")
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
    "p2p_flash_fwd_smem_bytes": [_I],
    "p2p_flash_bwd_dkvq_offs": [_P] * 10 + [_I] * 5 + [_P],
    "p2p_flash_bwd_smem_bytes": [_I],
    "p2p_flash_bwd_dkv_offs": [_P] * 9 + [_I] * 5 + [_P],
    "p2p_flash_bwd_dkv_smem_bytes": [_I],
    "p2p_flash_bwd_dq_offs": [_P] * 8 + [_I] * 5 + [_P],
    "p2p_flash_bwd_dq_smem_bytes": [_I],
    "p2p_ici_exchange": [_P, _I, _P],
    "p2p_ici_max_entries": [],
    "p2p_enable_peer_access": [_I, _I],
    "p2p_fleet_chunk": [_P, _I, _I, _I, _I, _I, _P],
    "p2p_fleet_chunk_place": [_P, _I],
    "p2p_fleet_latency_probe": [_P, _P, _I, _I, _P, _P],
}

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()
#: guards :data:`LAUNCHES`: kernel 9 launches from the gossip send workers
_launch_lock = threading.Lock()


def reset_launches() -> None:
    with _launch_lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0
        for widths in LAUNCHES_BY_WIDTH.values():
            for d in widths:
                widths[d] = 0


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
    # every source and header the build reads
    for src in sorted(CSRC.glob("*.cu*")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libp2pfl_kernels_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``csrc/`` into the build directory unless already built:
    one ``nvcc -c`` per source, all running at once, then one link. The
    compilers' reports (registers, shared memory, spills) are kept in
    ``<library>.log``."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in SOURCES]
    procs = [
        subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for src, obj in zip(SOURCES, objs)
    ]
    logs = [f"== {src.name}\n{proc.communicate()[0]}" for src, proc in zip(SOURCES, procs)]
    failed = [src.name for src, proc in zip(SOURCES, procs) if proc.returncode != 0]
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if not failed:
        link = subprocess.run(
            [nvcc, *GENCODE, "-shared", "-o", str(tmp), *(str(o) for o in objs)],
            capture_output=True, text=True, check=False,
        )
        logs.append(f"== link\n{link.stdout}{link.stderr}")
        if link.returncode != 0:
            failed.append("link")
    out.with_suffix(".log").write_text("\n".join(logs))
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        raise KernelBuildError(f"nvcc failed for {failed}:\n{chr(10).join(logs)[-4000:]}")
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


def _check(name: str, rc: int, head_dim: Optional[int] = None) -> None:
    if rc == -1:
        raise ValueError(f"{name}: shape not supported by the kernel")
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")
    with _launch_lock:
        LAUNCHES[name] += 1
        if head_dim is not None:
            LAUNCHES_BY_WIDTH[name][head_dim] += 1


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
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not built (built: {HEAD_DIMS})")
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
    _check("flash_fwd", rc, d)
    return o, lse


def flash_fwd_smem_bytes(head_dim: int) -> int:
    """Dynamic shared memory of one block of the forward (kernels 1 and 5)
    at a head width, as the built library sizes it (``-Xptxas -v``
    reports static memory only); -1 for a width not built."""
    return _load().p2p_flash_fwd_smem_bytes(head_dim)


def flash_bwd_smem_bytes(head_dim: int) -> int:
    """The same of the fused backward (kernels 2 and 6)."""
    return _load().p2p_flash_bwd_smem_bytes(head_dim)


def flash_bwd_dkv_smem_bytes(head_dim: int) -> int:
    """The same of the split dK/dV pass (kernels 4 and 8)."""
    return _load().p2p_flash_bwd_dkv_smem_bytes(head_dim)


def flash_bwd_dq_smem_bytes(head_dim: int) -> int:
    """The same of the split dQ pass (kernels 3 and 7)."""
    return _load().p2p_flash_bwd_dq_smem_bytes(head_dim)


def _dq_accumulator(q: torch.Tensor) -> torch.Tensor:
    """The fused backward's zeroed fp32 dQ sum, shaped like ``q``, with 16
    zeroed bytes after it: the kernel's work counter (one allocation, one
    fill)."""
    flat = torch.zeros(q.numel() + 4, dtype=torch.float32, device=q.device)
    return flat[: q.numel()].view(q.shape)


def flash_bwd_fused(q, k, v, do, lse, delta, causal: bool):
    """Single pass: (dQ, dK, dV). dQ sums in an fp32 buffer, zeroed here,
    through one bulk reduction a (k block, q tile) pair, and is cast to
    the input dtype here."""
    b, h, t, d = _check_inputs(q=q, k=k, v=v, do=do, lse=lse, delta=delta)
    lib = _load()
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    dq_acc = _dq_accumulator(q)
    rc = lib.p2p_flash_bwd_dkvq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), dq_acc.data_ptr(),
        b * h, t, d, int(causal), _stream(),
    )
    _check("flash_bwd_dkvq", rc, d)
    return dq_acc.to(q.dtype), dk, dv


def _dkv_outputs(k: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """dK and dV of the split pass, views of one allocation with 16 zeroed
    bytes after dV: the persistent kernel's work counter."""
    n = k.numel()
    flat = torch.empty(2 * n + 8, dtype=k.dtype, device=k.device)
    flat[2 * n:].zero_()
    return flat[:n].view(k.shape), flat[n:2 * n].view(k.shape)


def flash_bwd_dq(q, k, v, do, lse, delta, causal: bool) -> torch.Tensor:
    """Split pass 1: dQ per q tile (no cross-block state)."""
    b, h, t, d = _check_inputs(q=q, k=k, v=v, do=do, lse=lse, delta=delta)
    lib = _load()
    dq = torch.empty_like(q)
    rc = lib.p2p_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), b * h, t, d, int(causal), _stream(),
    )
    _check("flash_bwd_dq", rc, d)
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, causal: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """Split pass 2: dK/dV per k block."""
    b, h, t, d = _check_inputs(q=q, k=k, v=v, do=do, lse=lse, delta=delta)
    lib = _load()
    dk, dv = _dkv_outputs(k)
    rc = lib.p2p_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b * h, t, d, int(causal),
        _stream(),
    )
    _check("flash_bwd_dkv", rc, d)
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
    _check("flash_fwd_offs", rc, d)
    return o, lse


def flash_bwd_fused_offs(q, k, v, do, lse, delta, glse, q_off: int, k_off: int):
    """Single pass with the lse cotangent ``glse`` [B, H, T] fp32: (dQ, dK,
    dV). dQ rows no k tile reaches keep the zeroed buffer's 0."""
    b, h, t, d = _check_inputs(q=q, k=k, v=v, do=do, lse=lse, delta=delta, glse=glse)
    q_off, k_off = _check_offsets(q_off, k_off)
    lib = _load()
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    dq_acc = _dq_accumulator(q)
    rc = lib.p2p_flash_bwd_dkvq_offs(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), glse.data_ptr(), dk.data_ptr(), dv.data_ptr(), dq_acc.data_ptr(),
        b * h, t, d, q_off, k_off, _stream(),
    )
    _check("flash_bwd_dkvq_offs", rc, d)
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
    _check("flash_bwd_dq_offs", rc, d)
    return dq


def flash_bwd_dkv_offs(q, k, v, do, lse, delta, glse, q_off: int, k_off: int):
    """Split pass 2 of the offset backward: dK/dV per k block."""
    b, h, t, d = _check_inputs(q=q, k=k, v=v, do=do, lse=lse, delta=delta, glse=glse)
    q_off, k_off = _check_offsets(q_off, k_off)
    lib = _load()
    dk, dv = _dkv_outputs(k)
    rc = lib.p2p_flash_bwd_dkv_offs(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), glse.data_ptr(), dk.data_ptr(), dv.data_ptr(), b * h, t, d,
        q_off, k_off, _stream(),
    )
    _check("flash_bwd_dkv_offs", rc, d)
    return dk, dv


def flash_bwd_split_offs(q, k, v, do, lse, delta, glse, q_off: int, k_off: int):
    """Two offset passes with no cross-block state: (dQ, dK, dV)."""
    dq = flash_bwd_dq_offs(q, k, v, do, lse, delta, glse, q_off, k_off)
    return (dq, *flash_bwd_dkv_offs(q, k, v, do, lse, delta, glse, q_off, k_off))


# ---- kernel 9: the ICI weights plane's shard transfer ----

#: (device, peer) pairs whose peer access this process enabled
_peers: set = set()


def _enable_peer(device: int, peer: int) -> None:
    if (device, peer) in _peers:
        return
    if not torch.cuda.can_device_access_peer(device, peer):
        raise RuntimeError(
            f"cuda:{device} cannot store into cuda:{peer} (no peer access): the ICI "
            "plane never stages a transfer through the host"
        )
    rc = _load().p2p_enable_peer_access(device, peer)
    if rc != 0:
        raise RuntimeError(f"enabling peer access cuda:{device} -> cuda:{peer}: cudaError {rc}")
    _peers.add((device, peer))


def ici_exchange(srcs: list, dsts: list) -> None:
    """Copy every ``srcs[i]`` into ``dsts[i]`` (same shape and dtype, both
    contiguous) with kernel 9: one launch for the whole tree (several only
    past the per-launch table limit), on the current stream of the
    sources' card. All sources lie on one card, all destinations on one
    card; with two cards the destinations' card must be peer-accessible,
    and its current stream waits for the launch."""
    if len(srcs) != len(dsts):
        raise ValueError(f"{len(srcs)} sources for {len(dsts)} destinations")
    if not srcs:
        return
    src_dev, dst_dev = srcs[0].device, dsts[0].device
    if src_dev.type != "cuda" or dst_dev.type != "cuda":
        raise ValueError("ici_exchange: sources and destinations must lie on CUDA devices")
    # one pass, few attribute reads a leaf: for a 500-leaf tree this host
    # work is of the order of the copy itself
    rows: list = []
    for s, d in zip(srcs, dsts):
        if s.device != src_dev or d.device != dst_dev:
            raise ValueError("ici_exchange: sources on one CUDA device, destinations on one")
        n = s.nbytes
        if s.dtype != d.dtype or n != d.nbytes:
            raise ValueError(f"ici_exchange: {tuple(s.shape)} {s.dtype} into {tuple(d.shape)} {d.dtype}")
        if not (s.is_contiguous() and d.is_contiguous()):
            raise ValueError("ici_exchange: sources and destinations must be contiguous")
        if n:
            rows += (s.data_ptr(), d.data_ptr(), n)
    if not rows:
        return
    lib = _load()
    cross = src_dev != dst_dev
    if cross:
        _enable_peer(src_dev.index, dst_dev.index)
    # a launch goes to a stream of the current card
    here = src_dev.index is None or src_dev.index == torch.cuda.current_device()
    with contextlib.nullcontext() if here else torch.cuda.device(src_dev):
        stream = torch.cuda.current_stream(src_dev)
        if cross:
            # the destinations' memory may still be in use by work queued
            # on their own card: start only after it
            stream.wait_stream(torch.cuda.current_stream(dst_dev))
        per_launch = 3 * lib.p2p_ici_max_entries()
        for i in range(0, len(rows), per_launch):
            chunk = rows[i:i + per_launch]
            table = (ctypes.c_uint64 * len(chunk))(*chunk)
            rc = lib.p2p_ici_exchange(ctypes.cast(table, ctypes.c_void_p), len(chunk) // 3, stream.cuda_stream)
            _check("ici_exchange", rc)
    if cross:
        # the receiver's stream sees the stores complete (the TPU kernel's
        # recv semaphore)
        torch.cuda.current_stream(dst_dev).wait_stream(stream)


# ---- the megafleet chunk step (csrc/fleet_chunk.cu) ----

_i32, _i64, _f32, _u8 = torch.int32, torch.int64, torch.float32, torch.bool
#: the kernel's argument table, word for word ``FleetArgs`` in the source:
#: a tensor's address (a dtype), an int ("int") or a float ("float", sent
#: as a double)
FLEET_ARGS = (
    ("client", _i64), ("key_hi", _i32), ("key_lo", _i32), ("t_adopt", _f32), ("t_arr", _f32),
    ("send_ok", _u8), ("live", _u8), ("r", _i32), ("k_r", _i32), ("t_radopt", _f32),
    ("bkind", _i32), ("blam", _f32), ("bnoise", _i32),
    ("base0", _i64), ("rv0", _i64), ("rows0", _f32), ("payload", _f32),
    ("targets", _f32), ("samples", _f32), ("noise", _f32),
    ("w", _f32), ("G", _f32), ("mint", _f32), ("gbuf", _f32), ("gwt", _f32), ("gkey_hi", _i32),
    ("gkey_lo", _i32), ("hist_edge", _i32), ("hist_glob", _i32), ("si", _i32), ("sf", _f32),
    ("rbuf", _f32), ("rwt", _f32), ("rsamp", _f32), ("rkey_hi", _i32), ("rkey_lo", _i32), ("rcount", _i32),
    ("radopt", _i32), ("up_seq", _i32), ("last_acc_r", _f32), ("rparams", _f32), ("rraw", _f32),
    ("stop", _i32), ("prof", _i64),
    ("reg_send_ok", _u8), ("reg_jit", _f32), ("agg_delay", _f32), ("reg_dup", _u8), ("akind", _i32),
    ("alam", _f32), ("agg_noise_idx", _i32), ("agg_noise", _f32), ("wtab", _f32),
    *((name, "int") for name in ("chunk", "n_chunks", "dim", "n_reg", "k_glob", "k_max", "v_cap", "stride",
                                 "hist_bins", "max_staleness", "hier", "fold", "trim", "byz", "dup", "gf_cap",
                                 "staged", "reg_layout")),
    *((name, "float") for name in ("local_lr", "merge_keep", "merge_lr", "gap_reg", "gap_glob")),
)
#: where the regionals' counters and the folds' window rows live
#: (``reg_layout``): shared memory when they fit ("auto"), or device
#: memory ("device": the layout of a fleet too large for shared memory)
REG_LAYOUTS = {"auto": 0, "device": 1}
#: what a launch keeps in shared memory beyond its fixed part (bits of
#: :func:`fleet_chunk_place`)
FLEET_PLACE = {"payload": 1, "regionals": 2, "mint": 4, "fold_rows": 8}
#: the kernel's timed sections (``prof``: clock64 cycles of thread 0 in
#: warp 0's stretches; ``folder`` warp 1's busy cycles, beside them; then
#: counts), in the order of ``PROF_*`` in the source
FLEET_PROF = ("stage", "pass_a", "events", "regional_folds", "global_folds", "folder", "chunks", "n_regional_folds",
              "n_global_folds")


class FleetChunkArgs:
    """The argument table of one chunked engine, built once: every tensor
    checked (CUDA device, dtype, contiguity) and kept alive here; a
    tensor the configuration does not use is a null pointer (the client
    rows ``w`` of a staged launch among them: a sharded engine's rows lie
    in its shards' blocks)."""

    def __init__(self, values: dict) -> None:
        device = values["G"].device
        words = []
        self.tensors = []
        for name, kind in FLEET_ARGS:
            v = values.get(name)
            if kind == "int":
                words.append(int(v) & 0xFFFFFFFFFFFFFFFF)
            elif kind == "float":
                words.append(int.from_bytes(struct.pack("<d", float(v)), "little"))
            elif v is None:
                words.append(0)
            else:
                if v.device != device or not v.is_contiguous() or v.dtype != kind:
                    raise ValueError(f"fleet_chunk: {name} must be a contiguous {kind} tensor on {device}, "
                                     f"got {v.dtype} on {v.device}")
                self.tensors.append(v)
                words.append(v.data_ptr())
        if device.type != "cuda":
            raise ValueError("fleet_chunk: the carry must lie on a CUDA device")
        self.device = device
        self.n_words = len(words)
        self.table = (ctypes.c_uint64 * len(words))(*words)


def fleet_chunk(args: FleetChunkArgs, chunk: int, n_span: int = 1, j_start: int = 0, v0: int = -1) -> None:
    """Chunks ``chunk .. chunk + n_span - 1`` in one launch of one block,
    on the current stream: the consensus task's pass A and passes B-D of
    each; a gradient task's launch walks one chunk (pass A staged by
    PyTorch) from lane ``j_start`` (a resumed chunk passes the lane and
    ``v0`` the last launch wrote to ``stop``)."""
    rc = _load().p2p_fleet_chunk(ctypes.cast(args.table, ctypes.c_void_p), args.n_words, int(chunk), int(n_span),
                                 int(j_start), int(v0), _stream())
    _check("fleet_chunk", rc)


def fleet_chunk_place(args: FleetChunkArgs) -> dict:
    """What a launch of ``args`` keeps in shared memory (the payloads, the
    regionals' counters, the mint history), each True or False; raises if
    the kernel would refuse the table."""
    place = _load().p2p_fleet_chunk_place(ctypes.cast(args.table, ctypes.c_void_p), args.n_words)
    if place < 0:
        raise ValueError("fleet_chunk: shape not supported by the kernel")
    return {name: bool(place & bit) for name, bit in FLEET_PLACE.items()}


def fleet_latency_probe(steps: int = 4096, device=None) -> dict:
    """The card's latencies behind the chunk step's latency bound, each in
    ns a dependent step (cycles over the clock the probe itself ran at):
    ``smem`` a shared-memory pointer chase, ``fadd`` a ``__fadd_rn``
    chain, ``barrier`` a block barrier of 256 threads, ``l2`` and ``dram``
    pointer chases through a 4 MB and a 128 MB index table; ``clock_ghz``
    beside. A measuring tool, not a kernel of the port: it counts no
    launch."""
    device = torch.device(device or "cuda")
    tables = []
    for n in (1 << 20, 1 << 25):
        perm = torch.randperm(n, generator=torch.Generator().manual_seed(n), dtype=torch.int64)
        nxt = torch.empty(n, dtype=torch.int64)
        nxt[perm] = perm.roll(-1)  # one cycle through every index
        tables.append(nxt.to(device=device, dtype=torch.int32))
    out = torch.zeros(8, dtype=torch.int64, device=device)
    lib = _load()
    # the first run warms the L2 table; the second walks the large table
    # from a stretch of its cycle the first did not touch
    for start in (0, int(tables[1][12345])):
        rc = lib.p2p_fleet_latency_probe(tables[0].data_ptr(), tables[1].data_ptr(), start, int(steps),
                                         out.data_ptr(), _stream())
        if rc != 0:
            raise RuntimeError(f"fleet_latency_probe: cudaError {rc}")
    vals = out.tolist()
    ghz = vals[6] / max(vals[5], 1)
    names = ("smem", "fadd", "barrier", "l2", "dram")
    return {**{name: vals[i] / steps / ghz for i, name in enumerate(names)}, "clock_ghz": ghz}
