"""The host codec's native library (counterpart of ``p2pfl_tpu/native``).

``codec.cpp`` (CRC32C with the SSE4.2 instruction and a table fallback,
symmetric int8 quantize / dequantize) is built with ``g++`` at first use
into ``build/p2pfl_tpu_torch/`` beside the package (git ignored), never
into the package directory. The library's name carries a hash of the
source and flags, so an edited source is never served by a stale build;
the compile writes a private temporary file promoted with
:func:`os.replace` under an ``fcntl`` lock, so two processes starting at
once never load a half-written library. Nothing is built at import.

Every entry point has a plain numpy twin (``*_np``), written to round
exactly as the C code does; the tests hold the library against them bit
for bit. Without a compiler the codec falls back to the twins, loudly:
:data:`NATIVE` reads False and one warning is logged.

API: :func:`quantize`, :func:`dequantize`, :func:`crc32c`,
:func:`crc32c_combine`, :data:`NATIVE` (True when the library is in use;
reading it loads or builds the library).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent / "codec.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "p2pfl_tpu_torch"
CXX_FLAGS = ("-O3", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_loaded = False


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libp2tw_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``codec.cpp`` unless the library for this source exists.
    Raises ``OSError`` / ``subprocess.SubprocessError`` when ``g++`` is
    missing or fails."""
    out = library_path()
    if out.exists():
        return out
    import fcntl

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(f"{out}.lock", "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        try:
            if out.exists():
                return out  # another process built it while we waited
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            try:
                subprocess.run(
                    ["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                    check=True, capture_output=True, timeout=120,
                )
                os.replace(tmp, out)
            finally:
                tmp.unlink(missing_ok=True)
        finally:
            fcntl.flock(lockf, fcntl.LOCK_UN)
    return out


def _bind(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    lib.p2tw_quantize_f32_i8.restype = ctypes.c_float
    lib.p2tw_quantize_f32_i8.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.POINTER(ctypes.c_int8),
    ]
    lib.p2tw_dequantize_i8_f32.restype = None
    lib.p2tw_dequantize_i8_f32.argtypes = [
        ctypes.POINTER(ctypes.c_int8), ctypes.c_int64, ctypes.c_float, ctypes.POINTER(ctypes.c_float),
    ]
    lib.p2tw_crc32c.restype = ctypes.c_uint32
    lib.p2tw_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_uint32]
    return lib


def _load() -> Optional[ctypes.CDLL]:
    """The bound library, built on first use; None (logged once) when it
    cannot be built or loaded."""
    global _lib, _loaded
    if _loaded:
        return _lib
    with _lock:
        if not _loaded:
            try:
                _lib = _bind(build())
            except (OSError, subprocess.SubprocessError) as exc:
                from p2pfl_tpu_torch.management.logger import logger

                logger.warning(
                    "native",
                    f"codec library unavailable ({exc!r}): CRC32C and int8 quantization "
                    "fall back to numpy (NATIVE=False)",
                )
                _lib = None
            _loaded = True
    return _lib


def __getattr__(name: str):
    if name == "NATIVE":
        return _load() is not None
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


# ---- the plain twins: numpy, rounding exactly as codec.cpp ----


def quantize_np(arr: np.ndarray) -> tuple[np.ndarray, float]:
    """``p2tw_quantize_f32_i8`` in numpy: fp32 absmax, scale = absmax / 127
    and its reciprocal in fp32, ``x * inv`` clamped to ±127 and rounded
    half to even (``lrintf``)."""
    flat = np.ascontiguousarray(arr, dtype=np.float32).reshape(-1)
    absmax = np.abs(flat).max() if flat.size else np.float32(0)
    scale = absmax / np.float32(127) if absmax > 0 else np.float32(1)
    inv = np.float32(1) / scale
    q = np.rint(np.clip(flat * inv, np.float32(-127), np.float32(127)))
    return q.astype(np.int8).reshape(np.shape(arr)), float(scale)


def dequantize_np(arr: np.ndarray, scale: float) -> np.ndarray:
    flat = np.ascontiguousarray(arr, dtype=np.int8).reshape(-1)
    return (flat.astype(np.float32) * np.float32(scale)).reshape(np.shape(arr))


_TABLE = None


def _table() -> np.ndarray:
    global _TABLE
    if _TABLE is None:
        c = np.arange(256, dtype=np.uint32)
        for _ in range(8):
            c = np.where(c & 1, np.uint32(0x82F63B78) ^ (c >> 1), c >> 1).astype(np.uint32)
        _TABLE = c
    return _TABLE


def crc32c_np(data, seed: int = 0) -> int:
    """CRC32C in numpy, the table loop of ``codec.cpp`` run over many
    lanes of the input at once and the lanes' CRCs joined with
    :func:`crc32c_combine`."""
    buf = np.frombuffer(data, dtype=np.uint8) if not isinstance(data, np.ndarray) else data.view(np.uint8).ravel()
    table = _table()
    lanes = max(1, min(8192, len(buf) // 64))
    width = len(buf) // lanes
    body = buf[: lanes * width].reshape(lanes, width)
    c = np.full(lanes, 0xFFFFFFFF, dtype=np.uint32)
    c[0] = (seed ^ 0xFFFFFFFF) & 0xFFFFFFFF
    for j in range(width):
        c = table[(c ^ body[:, j]) & 0xFF] ^ (c >> 8)
    c ^= np.uint32(0xFFFFFFFF)
    crc = int(c[0])
    for lane in c[1:]:
        crc = crc32c_combine(crc, int(lane), width)
    tail = int(crc) ^ 0xFFFFFFFF
    for b in buf[lanes * width:]:
        tail = int(table[(tail ^ int(b)) & 0xFF]) ^ (tail >> 8)
    return tail ^ 0xFFFFFFFF


# ---- the codec's entry points ----


def quantize(arr: np.ndarray) -> tuple[np.ndarray, float]:
    """Symmetric per-tensor int8 quantization. Returns (int8 array, scale)."""
    lib = _load()
    if lib is None:
        return quantize_np(arr)
    flat = np.ascontiguousarray(arr, dtype=np.float32).reshape(-1)
    out = np.empty(flat.shape, dtype=np.int8)
    scale = lib.p2tw_quantize_f32_i8(
        flat.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), flat.size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
    )
    return out.reshape(np.shape(arr)), float(scale)


def dequantize(arr: np.ndarray, scale: float) -> np.ndarray:
    lib = _load()
    if lib is None:
        return dequantize_np(arr, scale)
    flat = np.ascontiguousarray(arr, dtype=np.int8).reshape(-1)
    out = np.empty(flat.shape, dtype=np.float32)
    lib.p2tw_dequantize_i8_f32(
        flat.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)), flat.size,
        ctypes.c_float(scale), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return out.reshape(np.shape(arr))


def crc32c(data, seed: int = 0) -> int:
    """CRC32C of a bytes-like (``bytes``, ``bytearray``, ``memoryview``:
    payload-frame slices are hashed in place, read-only ones included)."""
    lib = _load()
    if lib is None:
        return crc32c_np(data, seed)
    if isinstance(data, bytes):
        return int(lib.p2tw_crc32c(data, len(data), seed))
    buf = np.frombuffer(data, dtype=np.uint8)
    return int(lib.p2tw_crc32c(buf.ctypes.data_as(ctypes.c_char_p), buf.size, seed))


def _gf2_times(mat: list, vec: int) -> int:
    s = 0
    i = 0
    while vec:
        if vec & 1:
            s ^= mat[i]
        vec >>= 1
        i += 1
    return s


def _gf2_square(mat: list) -> list:
    return [_gf2_times(mat, mat[n]) for n in range(32)]


#: shift operators cached per byte count: every chunk of one stream has
#: the same body length, so a transfer builds at most two
_COMBINE_OPS: dict[int, list] = {}


def crc32c_combine(crc1: int, crc2: int, len2: int) -> int:
    """CRC32C of ``A + B`` from ``crc32c(A)``, ``crc32c(B)`` and ``len(B)``,
    touching no payload byte (zlib's ``crc32_combine`` over the Castagnoli
    polynomial): one cached 32x32 GF(2) matrix-vector product."""
    if len2 <= 0:
        return crc1
    op = _COMBINE_OPS.get(len2)
    if op is None:
        # the operator for one zero bit, squared 3x: one zero byte
        mat = [0x82F63B78] + [1 << n for n in range(31)]
        for _ in range(3):
            mat = _gf2_square(mat)
        op = [1 << n for n in range(32)]  # identity
        n = len2
        while n:
            if n & 1:
                op = [_gf2_times(mat, col) for col in op]
            n >>= 1
            if n:
                mat = _gf2_square(mat)
        if len(_COMBINE_OPS) < 256:
            _COMBINE_OPS[len2] = op
    return _gf2_times(op, crc1) ^ crc2
