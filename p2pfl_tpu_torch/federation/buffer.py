"""FedBuff-style buffered aggregation: merge when K arrive, weight by age
(counterpart of ``p2pfl_tpu/federation/buffer.py``).

The sync :class:`~p2pfl_tpu_torch.learning.aggregators.aggregator.Aggregator`
opens a *collection window* per round and blocks until a coverage target
is met — the barrier that lets one straggler gate the fleet. The
:class:`BufferedAggregator` has no window and no target: contributions are
accepted **as they arrive** (deduped by a version vector, down-weighted by
staleness, dropped past the staleness bound), and once ``K`` are buffered
the global model advances one version:

    P̄      = Σᵢ wᵢ·paramsᵢ / Σᵢ wᵢ        wᵢ = num_samplesᵢ · w(τᵢ)
    global ← (1−η)·global + η·P̄            (``ops/aggregation.server_merge``)

Nobody ever waits: a slow node's update merges late (with a smaller
weight) into whatever version the fleet has reached meanwhile.

The P̄ fold is one of the :func:`~p2pfl_tpu_torch.ops.aggregation.
buffered_robust_merge` kernels, selected by ``Settings.ASYNC_ROBUST_AGG``
— ``fedavg`` (the formula above, the default), ``trimmed-mean`` /
``median`` (per-coordinate rank rules, Byzantine-robust, weight-free by
construction) or ``krum-screen`` (Krum drops the ``BYZ_F`` most outlying
contributions, the staleness-weighted mean folds the survivors). An
optional admission screen (``defense`` —
:class:`~p2pfl_tpu_torch.federation.defense.ByzantineDefense`) additionally
gates every :meth:`~BufferedAggregator.offer` against the tier's current
params before buffering.

Determinism contract: given the same *sequence* of ``offer``/``set_global``
calls, results are bit-identical — the flush sorts its buffer by
``(origin, seq)`` so the fold order never depends on arrival interleaving
within a buffer window, and the reduction is the same torch program every
time, on the device of the tier's params (the card for a Node whose learner
lives there). The event-driven :mod:`~p2pfl_tpu_torch.federation.simfleet` makes the
call sequence itself a pure function of the seed, which is what the
replay tests pin.

Thread-safe: command handlers deliver from whatever thread carries the
message (sender gossip workers, duplicate timers). The internal lock is
never held across anything that can send — flush results are *returned*
and the caller propagates them outside the lock (lock-ordering with peers'
handlers would otherwise deadlock the in-memory transport's synchronous
delivery chains).
"""

from __future__ import annotations

import threading
from typing import Any, List, NamedTuple, Optional, Tuple

from p2pfl_tpu_torch.federation.staleness import (
    UpdateVersion,
    VersionVector,
    as_version,
    staleness_weight,
)
from p2pfl_tpu_torch.learning.weights import ModelUpdate
from p2pfl_tpu_torch.management.logger import logger
from p2pfl_tpu_torch.management.telemetry import telemetry
from p2pfl_tpu_torch.settings import Settings

Pytree = Any


class FlushResult(NamedTuple):
    """One merge's outcome, handed to the caller for propagation."""

    params: Pytree  #: the post-merge model
    version: int  #: this tier's model version after the merge
    contributors: List[str]  #: union of the merged updates' contributors
    num_samples: int  #: summed RAW sample counts (pre-staleness-discount)
    taus: List[int]  #: per-merged-update staleness, fold order


class BufferedAggregator:
    """Bounded-staleness buffer around one model tier.

    ``bump_on_flush`` distinguishes the two tiers of the hierarchy:

    - the **global** tier owns the version counter — every flush IS a new
      global version (``bump_on_flush=True``, the default);
    - a **regional** tier merges its cluster's updates but its version is
      the *global* version it tracks via :meth:`set_global` — a regional
      flush produces an aggregate to push upward, not a new global
      (``bump_on_flush=False``), so edge staleness is still measured in
      global versions end to end.
    """

    def __init__(
        self,
        node_name: str,
        params: Pytree,
        *,
        k: Optional[int] = None,
        alpha: Optional[float] = None,
        server_lr: Optional[float] = None,
        max_staleness: Optional[int] = None,
        bump_on_flush: bool = True,
        defense: Optional[Any] = None,
    ) -> None:
        self.node_name = node_name
        #: optional admission screen (federation/defense.py
        #: ByzantineDefense): every offered contribution is checked
        #: against this tier's current params before it may buffer
        self.defense = defense
        self.k = max(1, int(Settings.FEDBUFF_K if k is None else k))
        self.alpha = float(Settings.FEDBUFF_ALPHA if alpha is None else alpha)
        self.server_lr = float(
            Settings.FEDBUFF_SERVER_LR if server_lr is None else server_lr
        )
        self.max_staleness = int(
            Settings.ASYNC_MAX_STALENESS if max_staleness is None else max_staleness
        )
        self.bump_on_flush = bump_on_flush
        self._lock = threading.Lock()
        self._params = params
        self._version = 0
        self._vv = VersionVector()
        # buffered (version triple, update, effective weight, accept-time
        # staleness) — flushed in (origin, seq) order, NOT arrival order
        # (determinism contract)
        self._pending: List[Tuple[UpdateVersion, ModelUpdate, float, int]] = []
        self.merges = 0

    # ---- views ----

    @property
    def version(self) -> int:
        with self._lock:
            return self._version

    def snapshot(self) -> Tuple[Pytree, int]:
        """The current ``(params, version)`` pair, atomically."""
        with self._lock:
            return self._params, self._version

    def pending(self) -> int:
        with self._lock:
            return len(self._pending)

    def version_vector(self) -> dict:
        return self._vv.snapshot()

    # ---- upstream adoption (regional tiers / restarts) ----

    def set_global(self, params: Pytree, version: int) -> bool:
        """Adopt a newer upstream global. Returns False for stale pushes.

        Buffered-but-unflushed contributions are kept: their staleness
        simply grows (and the bound may later drop them) — exactly the
        semantics their producers signed up for.
        """
        with self._lock:
            if version <= self._version:
                return False
            self._params = params
            self._version = version
            return True

    # ---- the hot path ----

    def offer(
        self, update: ModelUpdate, screen_origin: Optional[str] = None
    ) -> Optional[FlushResult]:
        """Accept a contribution; returns a :class:`FlushResult` when this
        acceptance completed a buffer of K, else None.

        ``screen_origin`` is who the Byzantine screen blames for a
        rejection — the DELIVERING peer when the caller knows it (the
        in-payload ``(origin, seq)`` triple is attacker-controlled and
        must not be a framing vector); None falls back to the version
        origin, which equals the sender for every direct push.

        Rejections (all counted in the comm metrics, never raising):

        - ``async_dup_drop`` — the version vector already saw an equal or
          newer ``(origin, seq)`` (duplicate / reordered delivery);
        - ``async_stale_drop`` — ``τ > max_staleness`` (bounded
          staleness: too old to merge at any weight).

        An update with no version triple (a sync-mode producer poking the
        buffer directly) is treated as fresh from its first contributor
        with an auto-assigned seq — counted ``async_unversioned`` so a
        misconfigured fleet is visible in the metrics.
        """
        ver = as_version(update.version)
        with self._lock:
            if ver is None:
                origin = update.contributors[0] if update.contributors else "?"
                ver = UpdateVersion(origin, self._vv.last(origin) + 1, self._version)
                logger.log_comm_metric(self.node_name, "async_unversioned")
            if not self._vv.observe(ver.origin, ver.seq):
                logger.log_comm_metric(self.node_name, "async_dup_drop")
                telemetry.event(
                    self.node_name,
                    "async_dup_drop",
                    kind="gossip",
                    attrs={"origin": ver.origin, "seq": ver.seq},
                )
                return None
            if self.defense is not None and not self.defense.admit(
                screen_origin if screen_origin is not None else ver.origin,
                update.params,
                self._params,
            ):
                # screened out (federation/defense.py): counted there as
                # screen_reject; the (origin, seq) mark above stays — a
                # replay of the rejected payload is a dup either way
                return None
            if (
                self.bump_on_flush
                and ver.base_version > self._version
                and ver.base_version - self._version <= self.max_staleness
            ):
                # version high-water handover (root failover): a successor
                # root that missed the corpse's last minted globals still
                # sees their versions inside the updates trained FROM them
                # — jump the counter so the next flush mints strictly
                # above anything any live node already adopted. A no-op in
                # steady state (nodes can only train from versions this
                # tier minted, so base <= version at the minting tier).
                # The jump is BOUNDED by max_staleness: an unvalidated
                # base_version from a cross-experiment straggler (pre-xp
                # sender — the identity gate cannot filter it) must not
                # inflate the counter so far that every legitimate update
                # mass-drops as over-stale; beyond the bound the frame
                # merges once at clamped τ=0 instead — the pre-elastic
                # bounded damage. A real handover gap larger than the
                # staleness bound is a partition whose updates would be
                # dropped anyway.
                self._version = ver.base_version
            tau = max(self._version - ver.base_version, 0)
            if tau > self.max_staleness:
                logger.log_comm_metric(self.node_name, "async_stale_drop")
                telemetry.event(
                    self.node_name,
                    "async_stale_drop",
                    kind="gossip",
                    attrs={"origin": ver.origin, "tau": tau},
                )
                return None
            weight = float(update.num_samples) * staleness_weight(tau, self.alpha)
            self._pending.append((ver, update, weight, tau))
            logger.log_comm_metric(self.node_name, "async_update_buffered")
            result = self._maybe_flush_locked()
        return self._finish_flush(result)

    def set_k(self, k: int) -> Optional[FlushResult]:
        """Adjust the buffer size mid-run — the eviction repair hook.

        A tier's K is clamped to its fan-in at creation, but members die:
        a cluster of 3 with K=3 and one corpse would never flush again —
        the async twin of the sync plane's mid-round train-set repair.
        The workflow's eviction listener shrinks K to the live fan-in;
        if the buffer already holds that many, the merge fires HERE and
        the result is returned for propagation.
        """
        with self._lock:
            self.k = max(1, int(k))
            result = self._maybe_flush_locked()
        return self._finish_flush(result)

    # ---- durability (federation/durability.py) ----

    def journal_state(self, tier: str):
        """Copy this tier's journalable state under the lock — version,
        version-vector marks, and every pending contribution with its
        ORIGINAL version triple (so a resurrection that lands in a
        different role can successor-forward them verbatim)."""
        from p2pfl_tpu_torch.federation.durability import BufferJournal

        with self._lock:
            pending = [
                (
                    v.origin,
                    v.seq,
                    v.base_version,
                    list(u.contributors),
                    int(u.num_samples),
                    u.params,
                )
                for v, u, _w, _t in sorted(
                    self._pending, key=lambda e: (e[0].origin, e[0].seq)
                )
            ]
            return BufferJournal(
                tier=tier,
                version=self._version,
                vv=self._vv.snapshot(),
                pending=pending,
            )

    def restore_journal(
        self, version: int, vv: dict, updates: List[ModelUpdate]
    ) -> Optional[FlushResult]:
        """Re-arm this tier from a journal: merge the version-vector
        marks (so a network re-delivery of a pre-crash in-flight update
        dedups instead of double-merging), lift the version floor, and
        re-buffer the journaled pending contributions. The entries
        bypass :meth:`offer`'s dedup — the restored marks already
        include them (they were observed at original admission) — but
        staleness is re-checked against the restored version: age that
        accrued while the node was dead may push an entry past the
        bound, which drops it exactly as it would have been dropped
        live. May complete a buffer of K — the flush result is returned
        for propagation, exactly like :meth:`set_k`."""
        with self._lock:
            for origin, seq in vv.items():
                self._vv.observe(origin, seq)
            if version > self._version:
                self._version = version
            for upd in updates:
                ver = as_version(upd.version)
                if ver is None:
                    continue
                tau = max(self._version - ver.base_version, 0)
                if tau > self.max_staleness:
                    logger.log_comm_metric(self.node_name, "async_stale_drop")
                    continue
                weight = float(upd.num_samples) * staleness_weight(tau, self.alpha)
                self._pending.append((ver, upd, weight, tau))
                logger.log_comm_metric(self.node_name, "async_update_buffered")
            result = self._maybe_flush_locked()
        return self._finish_flush(result)

    def take_pending(self) -> List[ModelUpdate]:
        """Drain buffered-but-unflushed contributions without merging —
        the buffer-migration hook for elastic membership.

        An aggregator whose role changes (demoted by a join's re-chunk,
        or leaving gracefully) must not discard a partial buffer: the
        contributions are FORWARDED raw, in ``(origin, seq)`` order, to
        the successor tier, whose own version vector re-dedups any copy
        that also reached it directly. The local version vector keeps its
        marks (this buffer may be re-promoted later and must still reject
        replays of what it already accepted).
        """
        with self._lock:
            entries = sorted(self._pending, key=lambda e: (e[0].origin, e[0].seq))
            self._pending = []
        return [u for _v, u, _w, _t in entries]

    def _maybe_flush_locked(self) -> Optional[FlushResult]:
        if len(self._pending) < self.k:
            return None
        entries = sorted(self._pending, key=lambda e: (e[0].origin, e[0].seq))
        self._pending = []
        return self._merge_locked(entries)

    def _finish_flush(self, result: Optional[FlushResult]) -> Optional[FlushResult]:
        if result is None:
            return None
        # telemetry outside the lock: the staleness histogram is fed per
        # MERGED update (drops counted separately in offer)
        for tau in result.taus:
            telemetry.observe_value(self.node_name, "staleness", tau)
        logger.log_comm_metric(self.node_name, "async_merge")
        return result

    def _merge_locked(self, entries) -> FlushResult:
        import torch

        from p2pfl_tpu_torch.ops.aggregation import buffered_robust_merge, server_merge
        from p2pfl_tpu_torch.ops.tree import tree_align_devices, tree_leaves, tree_stack

        with telemetry.span(
            self.node_name,
            "async_merge",
            kind="stage",
            attrs={
                "k": len(entries),
                "version": self._version,
                "kernel": Settings.ASYNC_ROBUST_AGG,
            },
        ):
            # the fold runs where this tier's params live: contributions
            # that arrived on another device (a zero-copy peer's) move there
            device = tree_leaves(self._params)[0].device
            weights = torch.tensor(
                [w for _v, _u, w, _t in entries], dtype=torch.float32, device=device
            )
            stacked = tree_stack(
                [tree_align_devices(u.params, self._params) for _v, u, _w, _t in entries]
            )
            # kernel selected by Settings.ASYNC_ROBUST_AGG ("fedavg" is the
            # pre-robustness staleness-weighted mean, bit-identical); all
            # kernels fold the same (origin, seq)-sorted stack, so the
            # arrival-order determinism contract is kernel-independent
            avg = buffered_robust_merge(
                stacked,
                weights,
                Settings.ASYNC_ROBUST_AGG,
                trim=Settings.ASYNC_TRIM,
                f=Settings.BYZ_F,
                agg_dtype=Settings.AGG_DTYPE,
            )
            self._params = server_merge(
                self._params, avg, lr=self.server_lr, agg_dtype=Settings.AGG_DTYPE
            )
            if self.bump_on_flush:
                self._version += 1
            self.merges += 1
            contributors = sorted({c for _v, u, _w, _t in entries for c in u.contributors})
            num_samples = int(sum(u.num_samples for _v, u, _w, _t in entries))
            taus = [t for _v, _u, _w, t in entries]
            return FlushResult(self._params, self._version, contributors, num_samples, taus)
