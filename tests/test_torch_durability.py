"""The node journal in the port against the JAX package's.

For a snapshot without learner state the port's frame and manifest bytes
equal JAX's, and a journal JAX wrote recovers in the port to equal flat
dicts (and the other way round). Crash consistency is the port's own: 55
random mid-write kills always recover a committed or durable snapshot,
never a torn one, and a corrupt manifest or frame falls back each way.
A learner journaled through ``learning/checkpoint.py`` comes back with
its params and opt state bit-equal.
"""

import json
import os
import random
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2pfl_tpu.federation import durability as jd
from p2pfl_tpu.settings import Settings as JSettings
from p2pfl_tpu_torch.federation import durability as td
from p2pfl_tpu_torch.learning.dataset import FederatedDataset
from p2pfl_tpu_torch.learning.learner import DummyLearner, TorchLearner
from p2pfl_tpu_torch.management.logger import logger
from p2pfl_tpu_torch.models.vision import mlp
from p2pfl_tpu_torch.node import Node
from p2pfl_tpu_torch.ops.tree import tree_items
from p2pfl_tpu_torch.settings import set_test_settings


@pytest.fixture(autouse=True)
def _env():
    set_test_settings()
    logger.set_level("INFO")
    yield


def _snap(pkg, addr: str, marker: int, leaf):
    """A snapshot whose integrity-checkable fields all encode ``marker``;
    ``leaf(value)`` builds a 16-element fp32 leaf of the package."""
    return pkg.JournalSnapshot(
        addr=addr, xid="xp-dur", members=[addr, "peer-a", "peer-b"], dead=["peer-b"],
        global_version=marker, base_version=max(marker - 1, 0), high_water=marker,
        train_seq=marker + 1, up_seq=marker, total_rounds=10, updates_done=marker,
        suspicion={"peer-a": 0.25, "peer-c": 0.1 * marker}, quarantined=["peer-q"] if marker % 2 else [],
        global_params={"w": leaf(float(marker)), "b": {"x": leaf(-1.5 * marker)}},
        buffers=[pkg.BufferJournal(
            tier="regional", version=marker, vv={"peer-a": marker, "peer-b": 2},
            pending=[("peer-a", marker, max(marker - 1, 0), ["peer-a"], 3, {"w": leaf(2.0 * marker), "b": {"x": leaf(0.5)}}),
                     ("peer-b", 2, 0, ["peer-b", "peer-c"], 5, {"w": leaf(7.0), "b": {"x": leaf(1.0)}})],
        ), pkg.BufferJournal(tier="global", version=marker + 1, vv={}, pending=[])],
    )


def _jleaf(v):
    return jnp.full(16, v, jnp.float32)


def _tleaf(v):
    return torch.full((16,), v, dtype=torch.float32)


def _np(flat: dict) -> dict:
    return {k: np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v) for k, v in flat.items()}


def test_frame_and_manifest_bytes_equal_jax(tmp_path):
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jj = jd.NodeJournal(str(jdir), node_name="n", keep_n=2)
    tj = td.NodeJournal(str(tdir), node_name="n", keep_n=2)
    for marker in (1, 2, 3):
        assert tj.commit_snapshot(_snap(td, "n", marker, _tleaf)) == jj.commit_snapshot(_snap(jd, "n", marker, _jleaf))
    assert sorted(os.listdir(jdir)) == sorted(os.listdir(tdir)) == ["MANIFEST", "snap-2.p2pj", "snap-3.p2pj"]
    for name in os.listdir(jdir):
        assert (tdir / name).read_bytes() == (jdir / name).read_bytes(), name


def test_a_jax_journal_recovers_in_the_port_and_back(tmp_path):
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jd.NodeJournal(str(jdir), node_name="n").commit_snapshot(_snap(jd, "n", 4, _jleaf))
    td.NodeJournal(str(tdir), node_name="n").commit_snapshot(_snap(td, "n", 4, _tleaf))
    for theirs, ours in ((jdir, td), (tdir, jd)):
        got = ours.NodeJournal(str(theirs)).recover()
        want = (jd if ours is td else td).NodeJournal(str(theirs)).recover()
        for f in ("addr", "snap", "xid", "members", "dead", "global_version", "base_version", "high_water",
                  "train_seq", "up_seq", "total_rounds", "updates_done", "suspicion", "quarantined", "learner_step"):
            assert getattr(got, f) == getattr(want, f), f
        a, b = _np(got.global_params), _np(want.global_params)
        assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
        for bg, bw in zip(got.buffers, want.buffers, strict=True):
            assert (bg.tier, bg.version, bg.vv) == (bw.tier, bw.version, bw.vv)
            for pg, pw in zip(bg.pending, bw.pending, strict=True):
                assert pg[:5] == pw[:5]
                a, b = _np(pg[5]), _np(pw[5])
                assert all(np.array_equal(a[k], b[k]) for k in a)
    # with a template the port rebuilds trees on the template's device
    rec = td.NodeJournal(str(jdir)).recover(template={"w": torch.zeros(16), "b": {"x": torch.zeros(16)}})
    assert torch.equal(rec.global_params["b"]["x"], torch.full((16,), -6.0))
    ups = td.rebuild_updates(rec.buffers[0], rec.xid)
    assert [u.version for u in ups] == [("peer-a", 4, 3), ("peer-b", 2, 0)] and ups[0].xp == "xp-dur"


class _Killed(Exception):
    """The injected kill: aborts a commit at a chosen byte offset."""


class _KillableJournal(td.NodeJournal):
    kill_mode = None
    rng = None
    record = None
    current_marker = 0

    def _write_atomic(self, name, payload):
        is_manifest = name == "MANIFEST"
        mode = self.kill_mode
        if mode == "frame_tmp" and not is_manifest:
            cut = self.rng.randrange(0, len(payload))
            with open(os.path.join(self.directory, f"{name}.tmp.kill"), "wb") as f:
                f.write(payload[:cut])
            raise _Killed(name)
        if mode == "frame_torn" and not is_manifest:
            # torn bytes at the FINAL name: what the trailing CRC is for
            cut = self.rng.randrange(0, len(payload))
            with open(os.path.join(self.directory, name), "wb") as f:
                f.write(payload[:cut])
            raise _Killed(name)
        if mode == "pre_manifest" and is_manifest:
            raise _Killed(name)
        if mode == "manifest_torn" and is_manifest:
            cut = self.rng.randrange(0, len(payload))
            with open(os.path.join(self.directory, name), "wb") as f:
                f.write(payload[:cut])
            raise _Killed(name)
        super()._write_atomic(name, payload)
        if is_manifest:
            self.record["floor"] = int(json.loads(payload)["snap"])
        else:
            m = re.match(r"^snap-(\d+)\.p2pj$", name)
            if m:
                self.record["durable"][int(m.group(1))] = self.current_marker


def test_journal_torture_random_midwrite_kills(tmp_path):
    rng = random.Random(20)
    record = {"durable": {}, "floor": 0}

    def fresh():
        j = _KillableJournal(str(tmp_path), node_name="tort", keep_n=0)
        j.rng, j.record = rng, record
        return j

    j, kills, marker = fresh(), 0, 0
    while kills < 55:
        marker += 1
        mode = rng.choice(["frame_tmp", "frame_torn", "pre_manifest", "manifest_torn", None, None])
        j.kill_mode, j.current_marker = mode, marker
        if mode is None:
            j.commit_snapshot(_snap(td, "tort", marker, _tleaf))
            continue
        with pytest.raises(_Killed):
            j.commit_snapshot(_snap(td, "tort", marker, _tleaf))
        kills += 1
        j = fresh()
        rec = j.recover()
        assert rec is not None and rec.snap in record["durable"] and rec.snap >= record["floor"]
        want = record["durable"][rec.snap]
        assert rec.global_version == want
        assert torch.equal(rec.global_params["w"], torch.full((16,), float(want)))
        assert rec.buffers[0].vv == {"peer-a": want, "peer-b": 2}
    assert record["floor"] > 0


def test_journal_corruption_fixture_both_ways(tmp_path):
    j = td.NodeJournal(str(tmp_path), node_name="fx", keep_n=0)
    for marker in (1, 2, 3):
        j.commit_snapshot(_snap(td, "fx", marker, _tleaf))
    manifest = tmp_path / "MANIFEST"
    committed = manifest.read_bytes()
    for bad in (b'{"snapshot": "snap-3.p2pj", "crc": 1}', b"\x00garbage\xff"):
        manifest.write_bytes(bad)
        rec = td.NodeJournal(str(tmp_path)).recover()
        assert rec.snap == 3 and rec.global_version == 3
    manifest.write_bytes(committed)
    frame = tmp_path / "snap-3.p2pj"
    payload = bytearray(frame.read_bytes())
    payload[len(payload) // 2] ^= 0xFF
    frame.write_bytes(bytes(payload))
    rec = td.NodeJournal(str(tmp_path)).recover()
    assert rec.snap == 2 and torch.equal(rec.global_params["w"], torch.full((16,), 2.0))
    frame.write_bytes(bytes(payload[: len(payload) // 3]))
    assert td.NodeJournal(str(tmp_path)).recover().snap == 2
    assert td.NodeJournal(str(tmp_path / "empty")).recover() is None
    with pytest.raises(FileNotFoundError):
        Node.resume(str(tmp_path / "empty"), learner=DummyLearner(device="cpu"), start=False)


def test_seq_counter_and_learner_state_through_the_journal(tmp_path):
    """A TorchLearner's params and Adam state ride learning/checkpoint.py:
    ``Node.resume(start=False)`` gives them back bit-equal, with the
    journaled global rebuilt onto the learner's tree."""
    c = td.SeqCounter(5)
    assert (next(c), next(c), c.next_value) == (5, 6, 7)
    data = FederatedDataset.synthetic_mnist(n_train=256, n_test=32)
    learner = TorchLearner(mlp(seed=3, device="cpu"), data.partition(0, 1), batch_size=64, seed=3)
    learner.fit()
    j = td.NodeJournal(str(tmp_path), node_name="mem://n1")
    snap = _snap(td, "mem://n1", 2, _tleaf)
    snap.global_params = learner.get_parameters()
    snap.buffers = []
    j.commit_snapshot(snap, learner=learner)
    fresh = TorchLearner(mlp(seed=9, device="cpu"), data.partition(0, 1), batch_size=64, seed=9)
    node = Node.resume(str(tmp_path), learner=fresh, start=False)
    assert node.addr == "mem://n1" and node._pending_xid == "xp-dur" and node._async_join
    want = dict(tree_items(learner.get_parameters()))
    got = dict(tree_items(node.learner.get_parameters()))
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert all(torch.equal(a, b) for a, b in zip(torch.utils._pytree.tree_leaves(node.learner.opt_state),
                                                 torch.utils._pytree.tree_leaves(learner.opt_state)))
    rebuilt = dict(tree_items(node.consume_resume_snapshot().global_params))
    assert all(torch.equal(rebuilt[k], want[k]) for k in want)
    assert JSettings.JOURNAL_SEQ_MARGIN == 16  # the margin both packages resume past
