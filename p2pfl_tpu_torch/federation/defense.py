"""Byzantine defense-in-depth: admission screening + attacker quarantine
(counterpart of ``p2pfl_tpu/federation/defense.py``).

Robust merge kernels (``ops/aggregation.buffered_robust_merge``, the sync
Krum/Bulyan/trimmed-mean strategies) bound what one poisoned contribution
can do to ONE fold — but they re-pay that cost every flush, forever, and
say nothing about the attacker itself. This module adds the other half of
the production answer: a cheap per-contribution **admission screen** whose
rejections feed a per-origin **suspicion EWMA**, which past a threshold
drives the EXISTING quarantine path — ``Neighbors.evict`` → eviction
listeners → sync train-set repair / async ``TierRouter`` re-derivation —
so a persistent semantic attacker is removed from the federation by the
same machinery that removes a corpse.

The screen (``Settings.BYZ_SCREEN``) checks every contribution against
the receiving tier's current global with one device reduction over the
leaves (:func:`~p2pfl_tpu_torch.ops.aggregation.screen_stats`, on the
contribution's device; the three scalars are then read on the host):

- **norm gate** — reject when ``‖update‖ / ‖global‖`` leaves
  ``[1/BYZ_NORM_GATE, BYZ_NORM_GATE]`` (scale attacks, exploding updates);
- **cosine gate** — reject when ``cos(update, global) < BYZ_COS_GATE``
  (sign flips sit at −1, heavy noise near 0; honest weights-space updates
  that trained FROM the global stay near +1).

Threat model — what this does and does NOT claim (docs/design.md):
screening is a cheap statistical filter over weights-space updates, not a
proof. It catches the high-signal attacks (sign-flip, large scale, heavy
noise, most equivocation) and it rate-limits everything else through the
EWMA; a carefully-scaled attacker inside both gates still lands inside
the robust kernels' breakdown bound, which is why the kernels and the
screen ship together. The screen can false-positive on extreme non-IID
clients — it is opt-in, its gates are knobs, and a rejection never drops
a node by itself (only sustained rejection crosses the EWMA threshold).

Both aggregator seams consult one per-node instance (``node.defense``):
the sync :meth:`~p2pfl_tpu_torch.learning.aggregators.aggregator.Aggregator.
add_model` (reference = the round-start params the stage pins) and the
async :meth:`~p2pfl_tpu_torch.federation.buffer.BufferedAggregator.offer`
(reference = the buffer's current params). On BOTH seams suspicion
attributes to the DELIVERING peer, never to an identity named inside the
payload: sync gossip relays other nodes' models verbatim and the async
version triple's origin is attacker-controlled — keying suspicion on
either would let a lying sender frame (and get evicted) an honest node.
Screen-enabled receivers never store or buffer a rejected payload, so
honest nodes never relay poison and attribution converges on the
attacker. Quarantine fires ONCE per origin, on a daemon thread — the
decision lands under aggregator/buffer locks and the eviction path
broadcasts, and no lock may be held across a send (the PR-9 deadlock
contract).

Every decision is observable: ``screen_reject`` / ``byz_suspect`` /
``byz_evicted`` comm metrics plus flight-recorder events, so a Perfetto
timeline shows who flagged whom when.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, List, Optional

from p2pfl_tpu_torch.management.logger import logger
from p2pfl_tpu_torch.management.telemetry import telemetry
from p2pfl_tpu_torch.settings import Settings

Pytree = Any

#: below this reference norm the screen abstains: there is no meaningful
#: direction to compare against (a zero-initialized global, version 0)
_MIN_REF_NORM = 1e-6


class ByzantineDefense:
    """Per-node screening + suspicion state, shared by both control planes.

    ``on_quarantine(addr)`` is invoked AT MOST ONCE per origin, on a
    dedicated daemon thread (see module docs); engines that need
    deterministic synchronous handling (the simulator) pass no callback
    and poll :meth:`take_quarantined` instead.
    """

    def __init__(
        self,
        node_name: str,
        on_quarantine: Optional[Callable[[str], None]] = None,
    ) -> None:
        self.node_name = node_name
        self.on_quarantine = on_quarantine
        self._lock = threading.Lock()
        #: per-origin suspicion EWMA in [0, 1]
        self._suspicion: dict[str, float] = {}
        #: origins past the threshold — monotone within an experiment
        self._quarantined: set[str] = set()
        #: quarantined origins not yet collected by a polling engine
        self._pending_quarantine: List[str] = []
        self.screen_rejects = 0

    # ---- lifecycle ----

    def reset(self) -> None:
        """Experiment boundary: suspicion and quarantine are per-run
        state (a new experiment re-admits everyone; the overlay-level
        eviction the previous run drove has its own re-admission rules).
        """
        with self._lock:
            self._suspicion.clear()
            self._quarantined.clear()
            self._pending_quarantine.clear()
            self.screen_rejects = 0

    # ---- durability (federation/durability.py) ----

    def journal_state(self):
        """``(suspicion, quarantined)`` copies for the node journal —
        suspicion decays slowly by design, so losing it to a restart
        would hand every persistent attacker a free EWMA reset."""
        with self._lock:
            return dict(self._suspicion), sorted(self._quarantined)

    def restore(self, suspicion: dict, quarantined: List[str]) -> None:
        """Re-arm from a journal (max-merge: concurrent observations
        since the snapshot are never lowered). Quarantine is NOT
        re-fired — the pre-crash eviction already broadcast, and the
        restored set keeps :meth:`admit` dropping those origins."""
        with self._lock:
            for origin, s in suspicion.items():
                if s > self._suspicion.get(origin, 0.0):
                    self._suspicion[origin] = float(s)
            self._quarantined.update(quarantined)

    # ---- the screen ----

    @staticmethod
    def enabled() -> bool:
        return bool(Settings.BYZ_SCREEN)

    def is_quarantined(self, origin: str) -> bool:
        with self._lock:
            return origin in self._quarantined

    def admit(self, origin: str, params: Pytree, ref: Pytree) -> bool:
        """Screen one contribution from ``origin`` against ``ref`` (the
        receiving tier's current global). True = admit.

        Self-contributions are never screened (a node poisoning itself is
        out of scope — it could lie in its aggregates directly), already-
        quarantined origins are dropped without paying the device
        reduction, and the screen abstains when the reference has no
        meaningful direction (near-zero norm) or the stats cannot be
        computed (shape drift is the codec's problem, not the screen's).
        """
        if origin == self.node_name:
            return True
        if self.is_quarantined(origin):
            logger.log_comm_metric(self.node_name, "byz_quarantined_drop")
            return False
        if not self.enabled():
            return True
        try:
            ok, norm_ratio, cos = self._screen_stats(params, ref)
        except Exception as exc:  # noqa: BLE001 — screening must never take a tier down
            logger.debug(self.node_name, f"screen abstained for {origin}: {exc!r}")
            return True
        if ok is None:
            return True  # abstained (no reference direction)
        if not ok:
            self.screen_rejects += 1
            logger.log_comm_metric(self.node_name, "screen_reject")
            telemetry.event(
                self.node_name,
                "screen_reject",
                kind="gossip",
                attrs={
                    "origin": origin,
                    "norm_ratio": round(norm_ratio, 4),
                    "cos": round(cos, 4),
                },
            )
        self._observe(origin, rejected=not ok)
        return bool(ok)

    def _screen_stats(self, params: Pytree, ref: Pytree):
        """(verdict, norm_ratio, cos) — verdict None = abstain."""
        from p2pfl_tpu_torch.ops.aggregation import screen_stats
        from p2pfl_tpu_torch.ops.tree import tree_structure

        if tree_structure(params) != tree_structure(ref):
            return None, 0.0, 0.0
        pn, rn, cos = screen_stats(params, ref)
        rn = float(rn)
        if rn < _MIN_REF_NORM:
            return None, 0.0, 0.0
        ratio = float(pn) / rn
        cos = float(cos)
        gate = float(Settings.BYZ_NORM_GATE)
        ok = (1.0 / gate) <= ratio <= gate and cos >= float(Settings.BYZ_COS_GATE)
        return ok, ratio, cos

    # ---- suspicion / quarantine ----

    def suspicion(self, origin: str) -> float:
        with self._lock:
            return self._suspicion.get(origin, 0.0)

    def _observe(self, origin: str, rejected: bool) -> None:
        beta = float(Settings.BYZ_SUSPICION_BETA)
        fire = False
        with self._lock:
            s = self._suspicion.get(origin, 0.0)
            s = (1.0 - beta) * s + (beta if rejected else 0.0)
            self._suspicion[origin] = s
            if rejected:
                logger.log_comm_metric(self.node_name, "byz_suspect")
                telemetry.event(
                    self.node_name,
                    "byz_suspect",
                    kind="gossip",
                    attrs={"origin": origin, "suspicion": round(s, 4)},
                )
            if (
                s >= float(Settings.BYZ_SUSPICION_THRESHOLD)
                and origin not in self._quarantined
            ):
                self._quarantined.add(origin)
                self._pending_quarantine.append(origin)
                fire = True
        if fire:
            logger.log_comm_metric(self.node_name, "byz_evicted")
            telemetry.event(
                self.node_name,
                "byz_evicted",
                kind="gossip",
                attrs={"origin": origin},
            )
            logger.warning(
                self.node_name,
                f"Byzantine quarantine: {origin} crossed the suspicion "
                "threshold — driving the eviction path",
            )
            if self.on_quarantine is not None:
                # the decision lands under an aggregator/buffer lock and
                # the eviction path broadcasts — fire on a daemon thread
                # so no lock is ever held across a send (PR-9 contract)
                threading.Thread(
                    target=self._fire_quarantine,
                    args=(origin,),
                    name=f"byz-quarantine-{self.node_name}",
                    daemon=True,
                ).start()

    def _fire_quarantine(self, origin: str) -> None:
        try:
            self.on_quarantine(origin)
        except Exception as exc:  # noqa: BLE001 — quarantine is best-effort
            logger.error(
                self.node_name, f"Byzantine quarantine of {origin} failed: {exc!r}"
            )

    def take_quarantined(self) -> List[str]:
        """Drain origins quarantined since the last call — the polling
        seam for engines with no callback (the simulator turns these into
        deterministic evict events on its virtual clock)."""
        with self._lock:
            out, self._pending_quarantine = self._pending_quarantine, []
        return out
