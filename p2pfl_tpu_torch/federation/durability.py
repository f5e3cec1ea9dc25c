"""Crash-consistent node journals: a node comes back as ITSELF (counterpart
of ``p2pfl_tpu/federation/durability.py``; the frame and manifest bytes are
the JAX package's for the same snapshot).

Every robustness layer so far (FaultPlan crashes, breakers, elastic
failover, Byzantine quarantine) treats a crashed node as permanently
dead. Production FL is a continuous service where device restarts are
weather, not funerals (Bonawitz et al., MLSys 2019) — and the FedBuff
async plane already has the dedup machinery (per-origin
:class:`~p2pfl_tpu_torch.federation.staleness.VersionVector`, bounded
staleness) that makes safe re-entry *provable*. What was missing is the
state that feeds it surviving the process.

A :class:`NodeJournal` snapshots everything a node needs to resurrect:

- the adopted global model + its version, the ``base_version`` the
  learner trained from, and the version high-water mark;
- the node's own monotone ``train_seq`` / ``up_seq`` counters — resumed
  STRICTLY PAST the journaled value plus ``Settings.JOURNAL_SEQ_MARGIN``,
  so the resurrected node's first push can never be rejected as a replay
  by an upstream version vector, while its pre-crash in-flight updates
  dedup instead of double-merging (the VersionVector accepts seq gaps by
  design: a gap is a lost update, not a protocol error);
- each :class:`~p2pfl_tpu_torch.federation.buffer.BufferedAggregator` tier's
  pending contributions with their ORIGINAL version triples intact (so
  the PR-11 successor-forward idiom applies verbatim when the restart
  re-derives the node into a different role) plus the tier's version
  vector and version counter;
- the membership ``(members, dead)`` view, the Byzantine suspicion
  EWMAs + quarantine set, and the ``xp`` experiment identity;
- the learner's params/opt_state — through
  :mod:`~p2pfl_tpu_torch.learning.checkpoint` (``save_learner``, with the
  ``keep_n`` retention knob; host copies, restored onto the learner's
  device) when the learner exposes ``params``/``opt_state``, or as a
  codec blob otherwise.

Crash consistency is the native-codec idiom hardened with a manifest:
every snapshot is written to a private temp file and promoted with
``os.replace`` (atomic on POSIX), carries a whole-file CRC32, and only
THEN does the ``MANIFEST`` (itself tmp+replace) name it committed. A
kill at any byte offset therefore leaves either the previous committed
snapshot (manifest still names it) or a torn temp file nobody reads; a
corrupted manifest falls back to scanning for the newest snapshot whose
CRC verifies, and a corrupted snapshot falls back to the previous one.
The torture test (``tests/test_durability.py``) kills writes at random
offsets ≥50 times and asserts recovery always lands on a committed
snapshot, never a torn one.

Model payloads inside a snapshot ride the wire codec
(:func:`~p2pfl_tpu_torch.learning.weights.encode_params` /
``decode_params`` — self-describing binary with per-tensor CRC32C, no
pickle), so the journal format is exactly as forward-compatible as the
wire. Trees are rebuilt with ``restore_like`` against the learner's
parameter structure (the same model structure fleet-wide), on its device.

Nothing here runs under a context or buffer lock:
:func:`capture_snapshot` copies state under the locks and returns, and
``commit_snapshot`` does its disk I/O outside them — a journal fsync
held under the context lock would stall every handler thread exactly
like a send would, so no lock may be held across ``commit_snapshot``.
"""

from __future__ import annotations

import json
import os
import re
import time
import zlib
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from p2pfl_tpu_torch.learning.weights import ModelUpdate, decode_params, encode_params
from p2pfl_tpu_torch.management.logger import logger
from p2pfl_tpu_torch.management.telemetry import telemetry
from p2pfl_tpu_torch.settings import Settings

Pytree = Any

#: journal frame magic + format version (bump on layout change)
_MAGIC = b"P2PJ1"
_MANIFEST = "MANIFEST"
_SNAP_RE = re.compile(r"^snap-(\d+)\.p2pj$")


class SeqCounter:
    """A ``next()``-able monotone counter whose NEXT value is readable —
    ``itertools.count`` with a journalable position. The async context's
    ``train_seq``/``up_seq`` use this so a snapshot can record exactly
    where the stream stood (and a resurrection can resume strictly past
    it)."""

    __slots__ = ("_next",)

    def __init__(self, start: int = 1) -> None:
        self._next = int(start)

    def __iter__(self) -> "SeqCounter":
        return self

    def __next__(self) -> int:
        v = self._next
        self._next = v + 1
        return v

    @property
    def next_value(self) -> int:
        """The value the next ``next()`` will return (never issued yet)."""
        return self._next


@dataclass
class BufferJournal:
    """One aggregation tier's journaled state. ``pending`` keeps the
    ORIGINAL ``(origin, seq, base_version)`` triples so a restart that
    re-derives this node into a different role can forward them raw to
    the successor tier (the PR-11 buffer-migration idiom, verbatim)."""

    tier: str  #: "regional" | "global"
    version: int
    vv: Dict[str, int]
    #: [(origin, seq, base_version, contributors, num_samples, params)]
    pending: List[Tuple[str, int, int, List[str], int, Any]]


@dataclass
class JournalSnapshot:
    """Everything :meth:`NodeJournal.commit_snapshot` persists and
    :meth:`NodeJournal.recover` rebuilds. ``*_params`` fields hold
    trees on capture; after a template-less recover they hold flat
    ``{path: tensor}`` dicts (see :meth:`NodeJournal.recover`)."""

    addr: str
    snap: int = 0
    xid: Optional[str] = None
    members: List[str] = field(default_factory=list)
    dead: List[str] = field(default_factory=list)
    global_version: int = 0
    base_version: int = 0
    high_water: int = 0
    train_seq: int = 1  #: NEXT unissued training-update seq at capture
    up_seq: int = 1  #: NEXT unissued upward-aggregate seq at capture
    total_rounds: int = 0
    updates_done: int = 0
    suspicion: Dict[str, float] = field(default_factory=dict)
    quarantined: List[str] = field(default_factory=list)
    global_params: Optional[Any] = None
    buffers: List[BufferJournal] = field(default_factory=list)
    #: checkpoint step of the learner state riding in ``<dir>/learner``
    #: (None = the learner was journaled as a codec blob instead)
    learner_step: Optional[int] = None
    learner_params: Optional[Any] = None
    #: wall-clock milliseconds :meth:`NodeJournal.recover` spent — the
    #: death→resurrection gap's journal-read component, re-emitted as the
    #: ``journal_recovery_ms`` comm metric by the resuming node
    recovery_ms: float = 0.0


def capture_snapshot(node: Any, ctx: Any) -> JournalSnapshot:
    """Copy everything a resurrection needs, under the context/buffer
    locks — the caller commits the returned snapshot OUTSIDE them."""
    with ctx.lock:
        snap = JournalSnapshot(
            addr=node.addr,
            xid=ctx.xid,
            members=sorted(ctx.members),
            dead=sorted(ctx._dead),
            global_version=ctx.global_version,
            base_version=ctx.base_version,
            high_water=ctx.high_water.mark,
            train_seq=ctx.train_seq.next_value,
            up_seq=ctx._up_seq.next_value,
            total_rounds=node.total_rounds,
            updates_done=int(node.state.round or 0),
            global_params=ctx.last_global[0] if ctx.last_global else None,
        )
        if ctx.last_global is not None:
            # the adopted global's version, not the newest merely KNOWN
            # one: the learner's params came from (at most) this
            snap.global_version = ctx.last_global[1]
        rbuf, gbuf = ctx.rbuf, ctx.gbuf
    for tier, buf in (("regional", rbuf), ("global", gbuf)):
        if buf is not None:
            snap.buffers.append(buf.journal_state(tier))
    suspicion, quarantined = node.defense.journal_state()
    snap.suspicion = suspicion
    snap.quarantined = quarantined
    return snap


class NodeJournal:
    """Durable snapshot store for one node (one directory per node).

    Not thread-safe against concurrent commits — snapshots are taken on
    the learning thread only (the workflow's cadence hook), which also
    matches the crash model: one writer, killed at an arbitrary byte.
    """

    def __init__(
        self,
        directory: str,
        node_name: str = "",
        keep_n: Optional[int] = None,
    ) -> None:
        self.directory = os.path.abspath(os.path.expanduser(directory))
        self.node_name = node_name
        self.keep_n = int(Settings.JOURNAL_KEEP_N if keep_n is None else keep_n)
        os.makedirs(self.directory, exist_ok=True)
        self._next_snap = self._scan_highest() + 1

    # ---- write path ----

    def commit_snapshot(self, snap: JournalSnapshot, learner: Any = None) -> str:
        """Atomically persist ``snap`` (+ the learner) and commit it in
        the manifest. Returns the committed snapshot filename.

        Write order is the whole crash-consistency argument: (1) learner
        checkpoint (its own atomic finalize, or a blob inside the
        frame), (2) snapshot frame to ``.tmp`` → fsync → ``os.replace``,
        (3) manifest to ``.tmp`` → fsync → ``os.replace``. A kill before
        (3) leaves the manifest naming the PREVIOUS snapshot; a kill
        inside any write leaves only a torn temp file nobody reads.
        """
        n = self._next_snap
        snap.snap = n
        if learner is not None:
            if hasattr(learner, "params") and hasattr(learner, "opt_state"):
                from p2pfl_tpu_torch.learning.checkpoint import save_learner

                save_learner(
                    os.path.join(self.directory, "learner"),
                    learner,
                    round=n,
                    keep_n=max(self.keep_n, 1) if self.keep_n else None,
                )
                snap.learner_step = n
                snap.learner_params = None
            else:
                snap.learner_step = None
                snap.learner_params = learner.get_parameters()
        payload = self._encode(snap)
        name = f"snap-{n}.p2pj"
        self._write_atomic(name, payload)
        manifest = json.dumps(
            {"snapshot": name, "snap": n, "crc": zlib.crc32(payload) & 0xFFFFFFFF}
        ).encode("utf-8")
        self._write_atomic(_MANIFEST, manifest)
        self._next_snap = n + 1
        self._gc(keep_through=n)
        owner = self.node_name or snap.addr
        logger.log_comm_metric(owner, "journal_snapshot")
        logger.log_comm_metric(owner, "journal_bytes", float(len(payload)))
        telemetry.event(
            owner,
            "journal_snapshot",
            kind="stage",
            attrs={
                "snap": n,
                "bytes": len(payload),
                "pending": sum(len(b.pending) for b in snap.buffers),
                "version": snap.global_version,
            },
        )
        return name

    def _write_atomic(self, name: str, payload: bytes) -> None:
        """The native-codec idiom: private temp file, fsync, promote with
        ``os.replace`` — readers see the old bytes or the new bytes,
        never a prefix."""
        final = os.path.join(self.directory, name)
        tmp = f"{final}.tmp.{os.getpid()}"
        try:
            with open(tmp, "wb") as f:
                f.write(payload)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, final)
        finally:
            if os.path.exists(tmp):
                try:
                    os.remove(tmp)
                except OSError:
                    pass

    def _gc(self, keep_through: int) -> None:
        """Drop snapshots older than the newest ``keep_n`` (0 = keep
        all). The committed snapshot is always kept."""
        if self.keep_n <= 0:
            return
        snaps = sorted(self._snapshots())
        for n in snaps[: -self.keep_n]:
            if n == keep_through:
                continue
            try:
                os.remove(os.path.join(self.directory, f"snap-{n}.p2pj"))
            except OSError:
                pass

    # ---- read path ----

    def recover(
        self, template: Optional[Pytree] = None, learner: Any = None
    ) -> Optional[JournalSnapshot]:
        """Load the last COMMITTED snapshot, or None when the journal is
        empty/unrecoverable. Integrity is checked both ways: the
        manifest's CRC must match the frame it names AND the frame's own
        trailing CRC must verify; on any mismatch the scan falls back to
        the newest snapshot that self-verifies (then the next, …).

        With ``template`` (a tree with the fleet's model structure —
        the resuming learner's parameters), params are rebuilt as full
        trees; without one they stay flat ``{path: tensor}`` dicts
        (enough for the torture tests' byte-level comparisons; the tensors
        lie on the CPU). With
        ``learner``, the learner checkpoint is restored into it.
        """
        t0 = time.monotonic()
        candidates: List[str] = []
        committed = self._read_manifest()
        if committed is not None:
            candidates.append(committed)
        for n in sorted(self._snapshots(), reverse=True):
            name = f"snap-{n}.p2pj"
            if name not in candidates:
                candidates.append(name)
        for name in candidates:
            snap = self._try_load(name, template)
            if snap is None:
                continue
            if learner is not None and snap.learner_step is not None:
                from p2pfl_tpu_torch.learning.checkpoint import restore_learner

                restore_learner(
                    os.path.join(self.directory, "learner"),
                    learner,
                    step=snap.learner_step,
                )
            self._next_snap = max(self._next_snap, snap.snap + 1)
            snap.recovery_ms = (time.monotonic() - t0) * 1000.0
            owner = self.node_name or snap.addr
            logger.log_comm_metric(owner, "journal_recovered")
            logger.log_comm_metric(
                owner, "journal_recovery_ms", round(snap.recovery_ms, 3)
            )
            telemetry.event(
                owner,
                "journal_recovered",
                kind="stage",
                attrs={
                    "snap": snap.snap,
                    "from": name,
                    "recovery_ms": round(snap.recovery_ms, 3),
                    "version": snap.global_version,
                },
            )
            return snap
        return None

    def _read_manifest(self) -> Optional[str]:
        try:
            with open(os.path.join(self.directory, _MANIFEST), "rb") as f:
                doc = json.loads(f.read().decode("utf-8"))
            name = doc["snapshot"]
            with open(os.path.join(self.directory, name), "rb") as f:
                payload = f.read()
            if zlib.crc32(payload) & 0xFFFFFFFF != int(doc["crc"]):
                logger.warning(
                    self.node_name or self.directory,
                    f"journal manifest CRC mismatch for {name} — falling "
                    "back to snapshot scan",
                )
                return None
            return name
        except (OSError, ValueError, KeyError, TypeError):
            return None

    def _try_load(
        self, name: str, template: Optional[Pytree]
    ) -> Optional[JournalSnapshot]:
        try:
            with open(os.path.join(self.directory, name), "rb") as f:
                payload = f.read()
            return self._decode(payload, template)
        except Exception as exc:  # noqa: BLE001 — a torn frame is expected, not fatal
            logger.warning(
                self.node_name or self.directory,
                f"journal snapshot {name} unreadable ({exc!r}) — trying older",
            )
            return None

    def _snapshots(self) -> List[int]:
        out = []
        try:
            entries = os.listdir(self.directory)
        except OSError:
            return out
        for entry in entries:
            m = _SNAP_RE.match(entry)
            if m:
                out.append(int(m.group(1)))
        return out

    def _scan_highest(self) -> int:
        snaps = self._snapshots()
        return max(snaps) if snaps else 0

    # ---- frame codec ----

    def _encode(self, snap: JournalSnapshot) -> bytes:
        blobs: List[bytes] = []

        def blob(tree: Any) -> int:
            blobs.append(encode_params(tree))
            return len(blobs) - 1

        header: Dict[str, Any] = {
            "addr": snap.addr,
            "snap": snap.snap,
            "xid": snap.xid,
            "members": snap.members,
            "dead": snap.dead,
            "global_version": snap.global_version,
            "base_version": snap.base_version,
            "high_water": snap.high_water,
            "train_seq": snap.train_seq,
            "up_seq": snap.up_seq,
            "total_rounds": snap.total_rounds,
            "updates_done": snap.updates_done,
            "suspicion": snap.suspicion,
            "quarantined": snap.quarantined,
            "learner_step": snap.learner_step,
            "global_blob": (
                blob(snap.global_params) if snap.global_params is not None else None
            ),
            "learner_blob": (
                blob(snap.learner_params) if snap.learner_params is not None else None
            ),
            "buffers": [
                {
                    "tier": b.tier,
                    "version": b.version,
                    "vv": b.vv,
                    "pending": [
                        {
                            "origin": origin,
                            "seq": seq,
                            "base": base,
                            "contributors": contributors,
                            "num_samples": num_samples,
                            "blob": blob(params),
                        }
                        for origin, seq, base, contributors, num_samples, params in b.pending
                    ],
                }
                for b in snap.buffers
            ],
        }
        header["blob_lens"] = [len(b) for b in blobs]
        hdr = json.dumps(header, separators=(",", ":")).encode("utf-8")
        frame = bytearray(_MAGIC)
        frame += len(hdr).to_bytes(4, "little")
        frame += hdr
        for b in blobs:
            frame += b
        frame += (zlib.crc32(bytes(frame)) & 0xFFFFFFFF).to_bytes(4, "little")
        return bytes(frame)

    def _decode(self, payload: bytes, template: Optional[Pytree]) -> JournalSnapshot:
        if len(payload) < len(_MAGIC) + 8:
            raise ValueError("journal frame truncated")
        if payload[: len(_MAGIC)] != _MAGIC:
            raise ValueError("bad journal magic")
        body, crc = payload[:-4], int.from_bytes(payload[-4:], "little")
        if zlib.crc32(body) & 0xFFFFFFFF != crc:
            raise ValueError("journal frame CRC mismatch (torn write?)")
        off = len(_MAGIC)
        hdr_len = int.from_bytes(payload[off : off + 4], "little")
        off += 4
        header = json.loads(payload[off : off + hdr_len].decode("utf-8"))
        off += hdr_len
        blobs: List[Any] = []
        for blen in header["blob_lens"]:
            flat = decode_params(payload[off : off + blen])
            off += blen
            if template is not None:
                from p2pfl_tpu_torch.learning.weights import restore_like

                blobs.append(restore_like(template, flat))
            else:
                blobs.append(flat)
        snap = JournalSnapshot(
            addr=header["addr"],
            snap=int(header["snap"]),
            xid=header["xid"],
            members=list(header["members"]),
            dead=list(header["dead"]),
            global_version=int(header["global_version"]),
            base_version=int(header["base_version"]),
            high_water=int(header["high_water"]),
            train_seq=int(header["train_seq"]),
            up_seq=int(header["up_seq"]),
            total_rounds=int(header["total_rounds"]),
            updates_done=int(header["updates_done"]),
            suspicion={k: float(v) for k, v in header["suspicion"].items()},
            quarantined=list(header["quarantined"]),
            learner_step=header["learner_step"],
        )
        if header["global_blob"] is not None:
            snap.global_params = blobs[header["global_blob"]]
        if header.get("learner_blob") is not None:
            snap.learner_params = blobs[header["learner_blob"]]
        for b in header["buffers"]:
            snap.buffers.append(
                BufferJournal(
                    tier=b["tier"],
                    version=int(b["version"]),
                    vv={k: int(v) for k, v in b["vv"].items()},
                    pending=[
                        (
                            p["origin"],
                            int(p["seq"]),
                            int(p["base"]),
                            list(p["contributors"]),
                            int(p["num_samples"]),
                            blobs[p["blob"]],
                        )
                        for p in b["pending"]
                    ],
                )
            )
        return snap


def rebuild_updates(bj: BufferJournal, xid: Optional[str]) -> List[ModelUpdate]:
    """Reconstitute a journaled tier's pending entries as wire-shaped
    :class:`ModelUpdate` objects with their ORIGINAL version triples —
    ready to re-offer locally or forward raw to a successor tier."""
    out: List[ModelUpdate] = []
    for origin, seq, base, contributors, num_samples, params in bj.pending:
        upd = ModelUpdate(params, list(contributors), num_samples)
        upd.version = (origin, seq, base)
        upd.xp = xid
        out.append(upd)
    return out
