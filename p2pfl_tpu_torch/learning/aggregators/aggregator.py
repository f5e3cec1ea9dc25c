"""Aggregator base: partial-aggregation bookkeeping around a pure kernel.

Counterpart of ``p2pfl_tpu/learning/aggregators/aggregator.py``:

- ``set_nodes_to_aggregate(train_set)`` opens the round's collection window.
- ``add_model(update)`` accepts a model or partial aggregation:
  * a full-coverage update replaces everything collected so far,
  * a contributor-disjoint update accumulates,
  * overlapping / foreign / duplicate contributors are rejected,
  * in *waiting* mode (non-train-set nodes) the first full update IS the
    result.
- ``wait_and_get_aggregation()`` blocks until coverage is complete or
  ``Settings.AGGREGATION_TIMEOUT``, then aggregates whatever arrived.
- ``get_partial_aggregation(except_nodes)`` pre-aggregates everything a
  peer has not seen — the payload of train-set gossip.
- ``discard_member(addr)`` — mid-round train-set repair: an evicted member
  that never contributed is dropped from the round's coverage target.
- ``defense`` (the owning Node's ``federation/defense.py::ByzantineDefense``)
  screens every contribution under ``Settings.BYZ_SCREEN`` against the
  round-start params ``TrainStage`` pins (``set_screen_reference``); a
  rejected one is not collected, and the delivering peer's suspicion rises.

Subclasses implement one pure function, :meth:`aggregate`, over a list of
:class:`ModelUpdate`; stateful ones resync in :meth:`on_result` and
drop their state in :meth:`reset_experiment`. Under secure aggregation
only a ``MASK_COMPATIBLE`` (linear) strategy may run: ``StartLearningStage``
aborts the experiment for any other, whose rule would act on masked noise.
"""

from __future__ import annotations

import threading
from typing import Optional

from p2pfl_tpu_torch.learning.weights import ModelUpdate
from p2pfl_tpu_torch.management.logger import logger
from p2pfl_tpu_torch.ops.tree import tree_align_devices, tree_stack
from p2pfl_tpu_torch.settings import Settings


def stack_models(models: list[ModelUpdate]) -> dict:
    """The contributions' params stacked on a leading node axis, each
    moved to the first one's devices where a zero-copy peer's differ."""
    return tree_stack([tree_align_devices(m.params, models[0].params) for m in models])


class Aggregator:
    """Base aggregation strategy + round collection state."""

    #: False for strategies that need the individual models
    SUPPORTS_PARTIALS: bool = True
    #: True for stateful strategies whose :meth:`aggregate` must run once
    #: per round even when a single update covers the train set
    ALWAYS_AGGREGATE: bool = False
    #: True for linear strategies, through which secure aggregation's
    #: pairwise masks cancel (``learning/secagg.py``); robust strategies
    #: inspect individual models, which masking forbids
    MASK_COMPATIBLE: bool = False

    def __init__(self, node_name: str = "unknown") -> None:
        self.node_name = node_name
        #: the Byzantine admission screen, attached by the owning Node;
        #: inert while None or with Settings.BYZ_SCREEN off
        self.defense = None
        #: what contributions are screened against: the round-start params
        self._screen_ref = None
        self._lock = threading.Lock()
        self._complete = threading.Event()
        self._complete.set()  # no aggregation in progress
        self._train_set: list[str] = []
        self._waiting: bool = False
        #: members evicted before contributing: the coverage TARGET is
        #: ``train_set - removed`` while the foreign-contributor check stays
        #: against the full train set
        self._removed: set[str] = set()
        self._models: dict[frozenset, ModelUpdate] = {}
        # one combined update per exact set of source groups (gossip ships
        # the same partial to several peers per tick); the generation
        # counter keeps an aggregate of a superseded model set out
        self._partial_memo: dict[frozenset, ModelUpdate] = {}
        self._memo_gen = 0

    # ---- round lifecycle ----

    def set_nodes_to_aggregate(self, nodes: list[str]) -> None:
        if not self._complete.is_set():
            raise Exception(f"({self.node_name}) aggregation already in progress")
        with self._lock:
            self._train_set = list(nodes)
            self._waiting = False
            self._reset_locked()
            self._complete.clear()

    def set_screen_reference(self, params) -> None:
        """Pin the round-start global the admission screen compares
        contributions against (by reference, no copy); ``TrainStage`` sets it
        before the collection window opens."""
        self._screen_ref = params

    def set_waiting_aggregated_model(self, nodes: list[str]) -> None:
        """Non-train-set path: accept the first full update as the result."""
        with self._lock:
            self._train_set = list(nodes)
            self._waiting = True
            self._reset_locked()
            self._complete.clear()

    def clear(self) -> None:
        with self._lock:
            self._train_set = []
            self._waiting = False
            self._reset_locked()
            self._complete.set()

    def _reset_locked(self) -> None:
        self._removed = set()
        self._models = {}
        self._partial_memo = {}
        self._memo_gen += 1

    def reset_experiment(self) -> None:
        """Experiment boundary: drop cross-round strategy state (FedOpt's
        moments, CenteredClip's center; none in FedAvg), which the
        per-round :meth:`clear` keeps."""

    # ---- collection ----

    def get_aggregated_models(self) -> list[str]:
        """Names of all contributors currently folded into collected models."""
        with self._lock:
            return sorted({c for key in self._models for c in key})

    def add_model(self, update: ModelUpdate, source: Optional[str] = None) -> list[str]:
        """Add a model/partial. Returns the updated contributor coverage list;
        empty when rejected (duplicate, overlapping, foreign contributor, or
        no collection window open). ``source`` is the delivering peer. A
        strategy without partials raises on an update that carries the
        fused round's ``partial_acc``."""
        contributors = frozenset(update.contributors)
        if not contributors:
            logger.debug(self.node_name, "Rejecting model with no contributors")
            return []
        if not self.SUPPORTS_PARTIALS and update.partial_acc is not None:
            # the fused round's (psum, wsum) is pre-averaged state: a
            # robust rule needs the individual model. The stages strip it
            # before this point, so reaching here is a caller's bug
            raise ValueError(
                f"({self.node_name}) {type(self).__name__} declares SUPPORTS_PARTIALS=False "
                "but was handed a partial_acc-folded contribution: strip partial_acc or use "
                "the staged path"
            )
        if (
            self.defense is not None
            and self._screen_ref is not None
            and update.params is not None
            and not Settings.SECURE_AGGREGATION  # masked updates look like noise by design
        ):
            # suspicion falls on the delivering peer, never on a name inside
            # the payload (gossip relays others' models verbatim)
            origin = source if source is not None else next(iter(contributors))
            if not self.defense.admit(origin, update.params, self._screen_ref):
                return []
        with self._lock:
            if self._waiting:
                # only a full aggregate is acceptable while waiting; after
                # mid-round repair the survivors' aggregate counts as full
                target = frozenset(self._train_set) - self._removed
                if not target:
                    target = frozenset(self._train_set)
                if not (target <= contributors <= frozenset(self._train_set)):
                    logger.debug(
                        self.node_name,
                        f"Rejecting model while waiting: coverage {sorted(contributors)} "
                        f"outside [{sorted(target)}, {sorted(self._train_set)}]",
                    )
                    return []
                if self._models:  # first full update wins
                    logger.debug(self.node_name, "Rejecting model: already received while waiting")
                    return []
                self._models = {contributors: update}
                self._partial_memo = {}
                self._memo_gen += 1
                self._complete.set()
                return list(update.contributors)

            if self._complete.is_set():
                logger.debug(self.node_name, "Rejecting model: no aggregation in progress")
                return []

            train = set(self._train_set)
            if not contributors <= train:
                logger.debug(
                    self.node_name,
                    f"Rejecting model with foreign contributors {sorted(contributors - train)}",
                )
                return []

            if not self.SUPPORTS_PARTIALS and len(contributors) > 1 and contributors != train:
                logger.debug(
                    self.node_name,
                    f"Rejecting partial aggregation {sorted(contributors)}: "
                    f"{type(self).__name__} needs individual models",
                )
                return []

            if contributors == train:
                # full-coverage update replaces everything
                self._models = {contributors: update}
                self._partial_memo = {}
                self._memo_gen += 1
                self._complete.set()
                return sorted(train)

            covered = {c for key in self._models for c in key}
            if contributors & covered:
                logger.debug(
                    self.node_name,
                    f"Rejecting overlapping model {sorted(contributors)} (covered: {sorted(covered)})",
                )
                return []

            self._models[contributors] = update
            self._partial_memo = {}
            self._memo_gen += 1
            covered |= contributors
            if covered >= train - self._removed:
                self._complete.set()
            return sorted(covered)

    def discard_member(self, addr: str) -> Optional[list[str]]:
        """Mid-round train-set repair: ``addr`` was evicted. If its
        contribution has not arrived, shrink the coverage target to the
        survivors. Returns the coverage list to re-broadcast, or None."""
        with self._lock:
            if addr not in self._train_set or addr in self._removed:
                return None
            if self._complete.is_set() and not self._waiting:
                return None  # no collection window open
            covered = {c for key in self._models for c in key}
            if addr in covered:
                logger.debug(
                    self.node_name,
                    f"Train-set member {addr} evicted but already contributed — keeping",
                )
                return None
            self._removed.add(addr)
            target = set(self._train_set) - self._removed
            logger.log_comm_metric(self.node_name, "train_set_repair")
            logger.warning(
                self.node_name,
                f"Train-set repair: {addr} evicted before contributing — "
                f"coverage target shrunk to {sorted(target)}",
            )
            if self._waiting:
                return None
            if covered and covered >= target:
                self._complete.set()
            return sorted(covered)

    # ---- results ----

    def wait_and_get_aggregation(self, timeout: Optional[float] = None) -> ModelUpdate:
        """Block until coverage completes (or timeout), then aggregate."""
        timeout = Settings.AGGREGATION_TIMEOUT if timeout is None else timeout
        finished = self._complete.wait(timeout=timeout)
        with self._lock:
            models = list(self._models.values())
            train = set(self._train_set)
            waiting = self._waiting
            # close the collection window: late updates are rejected
            self._complete.set()
        if not models:
            raise Exception(f"({self.node_name}) aggregation produced no models (timeout={not finished})")
        if not finished:
            covered = {c for m in models for c in m.contributors}
            logger.info(
                self.node_name,
                f"Aggregation timeout — proceeding with partial coverage {sorted(covered)} of {sorted(train)}",
            )
            if Settings.SECURE_AGGREGATION and covered != train:
                # pairwise masks cancel only over the full train set: the
                # stage runs the seed-disclosure recovery before applying
                # this (GossipModelStage._secagg_finalize)
                logger.warning(
                    self.node_name, "SecAgg: partial coverage — unresolved pairwise masks; attempting dropout recovery"
                )
        # one model is the result as it is when this node waits, when the
        # strategy is stateless, or when it is a peer's finished aggregate
        # (re-aggregating would step a stateful strategy twice); on_result
        # lets a stateful strategy resync to it
        if len(models) == 1 and (
            waiting or not self.ALWAYS_AGGREGATE or len(models[0].contributors) > 1
        ):
            return self.on_result(models[0])
        from p2pfl_tpu_torch.management.profiling import dispatch_span

        with dispatch_span("aggregate", self.node_name, n_models=len(models)):
            result = self.aggregate(models)
        return self._inherit_anchor(result, models)

    @staticmethod
    def _inherit_anchor(result: ModelUpdate, models: list[ModelUpdate]) -> ModelUpdate:
        """Carry the delta-coding anchor through aggregation: a round's
        updates share one anchor (the round-start global), so a fresh
        aggregate re-encodes against it when it goes back on the wire."""
        if result.anchor is None and models and models[0].anchor is not None:
            result.anchor = models[0].anchor
            result.anchor_tag = models[0].anchor_tag
        return result

    def on_result(self, update: ModelUpdate) -> ModelUpdate:
        """Hook: the round resolved to ``update`` without this node running
        :meth:`aggregate` (waiting mode, or a peer's finished aggregate
        arrived first). Stateful strategies resync their state here."""
        return update

    def get_partial_aggregation(self, except_nodes: list[str]) -> Optional[ModelUpdate]:
        """Aggregate collected models not already covered by ``except_nodes``."""
        todo = self._models_not_covered(except_nodes)
        if not todo:
            return None
        if len(todo) == 1:
            return todo[0]
        if not self.SUPPORTS_PARTIALS:
            return None
        return self._memoized_aggregate(todo)

    def get_models_to_send(self, except_nodes: list[str]) -> list[ModelUpdate]:
        """Payloads for a peer that already covers ``except_nodes``."""
        todo = self._models_not_covered(except_nodes)
        if not todo:
            return []
        if self.SUPPORTS_PARTIALS and len(todo) > 1:
            return [self._memoized_aggregate(todo)]
        return todo

    def _memoized_aggregate(self, todo: list[ModelUpdate]) -> ModelUpdate:
        memo_key = frozenset(frozenset(m.contributors) for m in todo)
        with self._lock:
            hit = self._partial_memo.get(memo_key)
            gen = self._memo_gen
        if hit is not None:
            return hit
        from p2pfl_tpu_torch.management.profiling import dispatch_span

        with dispatch_span("aggregate", self.node_name, n_models=len(todo)):
            result = self._inherit_anchor(self.aggregate(todo), todo)
        with self._lock:
            if self._memo_gen == gen:  # collected set unchanged since read
                self._partial_memo[memo_key] = result
        return result

    def _models_not_covered(self, except_nodes: list[str]) -> list[ModelUpdate]:
        skip = set(except_nodes)
        with self._lock:
            return [m for key, m in self._models.items() if not (key & skip)]

    # ---- strategy ----

    def aggregate(self, models: list[ModelUpdate]) -> ModelUpdate:
        raise NotImplementedError

    @staticmethod
    def result(params: dict, models: list[ModelUpdate]) -> ModelUpdate:
        """``params`` as the aggregate of ``models``: every contributor,
        the summed sample count."""
        contributors = sorted({c for m in models for c in m.contributors})
        return ModelUpdate(params, contributors, sum(m.num_samples for m in models))
