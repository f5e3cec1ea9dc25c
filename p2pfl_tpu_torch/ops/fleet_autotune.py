"""Megafleet chunk-size autotune: measure once, replay from the cache
(counterpart of ``p2pfl_tpu/ops/fleet_autotune.py``).

The chunked fleet engine's speed depends on its chunk size, and the best
size depends on the device. Three layers resolve it:

1. **Pinned** (:func:`pin_fleet_chunk`): a process-only override, never
   written to disk (a pin is an experiment, not a measurement).
2. **In-process cache**: winners measured in this process, and what was
   loaded from disk.
3. **On-disk cache**: JSON at ``Settings.FLEET_TUNE_CACHE`` (else
   ``~/.cache/p2pfl_tpu_torch/fleet_tune.json``), loaded once a process.
   Entries are keyed on the **device kind**, the **shard count** and a
   caller's workload tag, so a cache written on one card never tunes
   another::

    {"<kind>|shards=P|<extra>": {"chunk": 256, "timings": {"64": 0.41, ...}}}

``timings`` keeps every candidate's seconds so a reader can see why the
winner won; only ``chunk`` is read back. :func:`autotune_fleet_chunk` is
the one function that runs anything (the caller's ``measure``).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Callable, Dict, Optional, Sequence

import torch

#: chunk sizes swept by default
DEFAULT_CANDIDATES = (64, 128, 256, 512)

# in-process winners: key -> {"chunk": int, "timings": {...}}
_MEM_CACHE: Dict[str, dict] = {}
# pins: process-only, win over everything, never written
_PINNED: Dict[str, dict] = {}
_DISK_LOADED: set = set()  # cache paths already merged into _MEM_CACHE


def device_kind(device=None) -> str:
    """The cache's platform key: the card's name for a CUDA device (the
    current card for ``None`` when one exists), else ``"cpu"``."""
    dev = torch.device(device) if device is not None else (
        torch.device("cuda") if torch.cuda.is_available() else torch.device("cpu"))
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return dev.type


def _key(kind: str, n_shards: int, extra: str) -> str:
    return f"{kind}|shards={int(n_shards)}|{extra}"


def cache_path() -> Path:
    from p2pfl_tpu_torch.settings import Settings

    if Settings.FLEET_TUNE_CACHE:
        return Path(Settings.FLEET_TUNE_CACHE).expanduser()
    return Path.home() / ".cache" / "p2pfl_tpu_torch" / "fleet_tune.json"


def _load_disk(path: Path) -> None:
    tag = str(path)
    if tag in _DISK_LOADED:
        return
    _DISK_LOADED.add(tag)
    try:
        raw = json.loads(path.read_text())
    except (OSError, ValueError):
        return
    for key, entry in raw.items():
        # an entry without an int chunk is skipped: measuring still applies
        if isinstance(entry, dict) and isinstance(entry.get("chunk"), int):
            _MEM_CACHE.setdefault(key, entry)


def _save_disk(path: Path) -> None:
    try:
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(dict(sorted(_MEM_CACHE.items())), indent=2, sort_keys=True))
    except OSError:  # a read-only home: the winner still holds in-process
        pass


def clear_memory_cache() -> None:
    """Drop the in-process state (the disk file stays)."""
    _MEM_CACHE.clear()
    _PINNED.clear()
    _DISK_LOADED.clear()


def pin_fleet_chunk(chunk: int, *, n_shards: int = 1, extra: str = "", kind: Optional[str] = None) -> None:
    """Pin a chunk size for a workload key: wins over any measurement,
    for this process only."""
    _PINNED[_key(kind or device_kind(), n_shards, extra)] = {"chunk": int(chunk)}


def _lookup(key: str) -> Optional[int]:
    got = _PINNED.get(key) or _MEM_CACHE.get(key)
    if got is None:
        _load_disk(cache_path())
        got = _MEM_CACHE.get(key)
    return None if got is None else int(got["chunk"])


def get_fleet_chunk(*, n_shards: int = 1, extra: str = "", kind: Optional[str] = None) -> Optional[int]:
    """Pinned, then tuned (memory, then disk), else ``None``."""
    return _lookup(_key(kind or device_kind(), n_shards, extra))


def autotune_fleet_chunk(
    measure: Callable[[int], float],
    candidates: Sequence[int] = DEFAULT_CANDIDATES,
    *,
    n_shards: int = 1,
    extra: str = "",
    kind: Optional[str] = None,
    cache: bool = True,
    force: bool = False,
) -> int:
    """The chunk size of one workload key. ``measure(chunk) -> seconds``
    runs only on a cache miss or with ``force=True``: a pinned or tuned key
    replays with no engine run."""
    key = _key(kind or device_kind(), n_shards, extra)
    if cache and not force:
        got = _lookup(key)
        if got is not None:
            return got
    timings = {int(c): float(measure(int(c))) for c in candidates}
    best = min(timings, key=timings.get)
    if cache:
        _MEM_CACHE[key] = {"chunk": int(best), "timings": {str(c): t for c, t in sorted(timings.items())}}
        # merge the file's other entries before writing (setdefault keeps
        # the fresh winner over a stale copy on disk)
        _load_disk(cache_path())
        _save_disk(cache_path())
    return int(best)
