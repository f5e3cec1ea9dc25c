"""The fleet-tune cache of the port (``ops/fleet_autotune.py``) on the CPU:
pins, the in-process cache and the disk cache keyed on the device kind,
and ``MegaFleet(chunk="auto")`` measuring once and replaying after."""

import json

import pytest

from p2pfl_tpu_torch.federation import megafleet as mf
from p2pfl_tpu_torch.ops import fleet_autotune as ft
from p2pfl_tpu_torch.settings import Settings, set_test_settings


@pytest.fixture(autouse=True)
def cache(tmp_path):
    set_test_settings()
    Settings.FLEET_TUNE_CACHE = str(tmp_path / "fleet_tune.json")
    ft.clear_memory_cache()
    yield tmp_path / "fleet_tune.json"
    Settings.FLEET_TUNE_CACHE = ""
    ft.clear_memory_cache()


def test_measures_once_then_replays_from_memory_and_disk(cache):
    calls = []

    def measure(c):
        calls.append(c)
        return {64: 0.3, 128: 0.1, 256: 0.2, 512: 0.4}[c]

    assert ft.autotune_fleet_chunk(measure, extra="w", kind="cardA") == 128
    assert calls == [64, 128, 256, 512]
    assert ft.autotune_fleet_chunk(measure, extra="w", kind="cardA") == 128  # memory
    ft.clear_memory_cache()
    assert ft.get_fleet_chunk(extra="w", kind="cardA") == 128  # disk
    assert ft.autotune_fleet_chunk(measure, extra="w", kind="cardA") == 128
    assert len(calls) == 4
    entry = json.loads(cache.read_text())["cardA|shards=1|w"]
    assert entry["chunk"] == 128 and entry["timings"] == {"128": 0.1, "256": 0.2, "512": 0.4, "64": 0.3}
    # another device kind, shard count or workload tag is another key
    assert ft.get_fleet_chunk(extra="w", kind="cardB") is None
    assert ft.get_fleet_chunk(extra="w", kind="cardA", n_shards=2) is None
    assert ft.get_fleet_chunk(extra="v", kind="cardA") is None
    assert ft.autotune_fleet_chunk(measure, extra="w", kind="cardA", force=True) == 128
    assert len(calls) == 8


def test_pins_win_and_are_never_written(cache):
    ft.pin_fleet_chunk(7, extra="w", kind="cardA")
    assert ft.get_fleet_chunk(extra="w", kind="cardA") == 7
    assert ft.autotune_fleet_chunk(lambda c: pytest.fail("measured"), extra="w", kind="cardA") == 7
    assert not cache.exists()
    ft.clear_memory_cache()
    assert ft.get_fleet_chunk(extra="w", kind="cardA") is None


def test_garbage_entries_are_skipped_and_entries_merge(cache):
    cache.write_text(json.dumps({"cardA|shards=1|bad": {"chunk": "x"}, "cardA|shards=1|old": {"chunk": 64}}))
    assert ft.get_fleet_chunk(extra="bad", kind="cardA") is None
    assert ft.autotune_fleet_chunk(lambda c: float(c), extra="new", kind="cardA") == 64
    on_disk = json.loads(cache.read_text())
    assert on_disk["cardA|shards=1|old"] == {"chunk": 64} and on_disk["cardA|shards=1|new"]["chunk"] == 64
    assert ft.device_kind("cpu") == "cpu"


def test_default_path_is_outside_the_repo(monkeypatch, tmp_path):
    Settings.FLEET_TUNE_CACHE = ""
    monkeypatch.setenv("HOME", str(tmp_path))
    assert ft.cache_path() == tmp_path / ".cache" / "p2pfl_tpu_torch" / "fleet_tune.json"
    Settings.FLEET_TUNE_CACHE = str(tmp_path / "x.json")
    assert ft.cache_path() == tmp_path / "x.json"


def test_megafleet_chunk_auto_measures_once_then_replays(cache, monkeypatch):
    """``chunk="auto"``: the first fleet runs each candidate twice on an
    event prefix and then itself; a second fleet (in-process cache
    cleared) reads the winner from the file and runs once, same result."""
    runs = []
    real = mf.MegaFleet._run_chunked

    def counted(self, *a):
        runs.append(a[0].chunk)
        return real(self, *a)

    monkeypatch.setattr(mf.MegaFleet, "_run_chunked", counted)
    spec = mf.FleetSpec.synth(300, seed=3, dim=4)
    first = mf.MegaFleet(spec, cluster_size=32, k=4, chunk="auto", device="cpu")
    a = first.run()
    assert len(runs) == 2 * len(ft.DEFAULT_CANDIDATES) + 1 and first.chunk in ft.DEFAULT_CANDIDATES
    runs.clear()
    ft.clear_memory_cache()
    again = mf.MegaFleet(spec, cluster_size=32, k=4, chunk=0, device="cpu")
    b = again.run()
    assert runs == [first.chunk] and again.chunk == first.chunk
    assert a.loss_curve == b.loss_curve
    key = next(iter(json.loads(cache.read_text())))
    assert key.startswith("cpu|shards=1|task=consensus|dim=4|hier=1|k=4")
