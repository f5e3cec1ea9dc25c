"""Seeded, deterministic fault injection for the overlay (counterpart of
``p2pfl_tpu/communication/faults.py``).

A :class:`FaultPlan` describes the chaos to inject:

- per-edge **drop** / **delay** / **duplicate** probabilities
  (:class:`EdgeFault`, directed ``src -> dst``),
- **one-way partitions** (``src`` cannot reach ``dst``),
- **slow peers** (every inbound weights delivery to that node pays a fixed
  latency),
- **crash-at-stage** hooks (:class:`CrashSpec`): a node hard-crashes, no
  goodbye messages, when its learning thread enters a named stage,
- **Byzantine attackers** (:class:`ByzantineSpec`): a node's model
  payloads are corrupted at the send seam while its control plane stays
  healthy.

Determinism: every directed edge draws from its own
``random.Random(f"{seed}:{src}->{dst}")`` stream, and Byzantine draws from
``random.Random(f"{seed}:byz:{src}->{dst}")``, the JAX package's streams:
the k-th send on an edge gets the same verdict, and the same corruption,
in both packages and on every run, however the threads interleave.
Gaussian noise is drawn on the host from numpy's generator and moved to
the leaf's device, so it is bit-equal to JAX's too.

The plan wraps a transport at the ``_do_send`` seam
(``protocol.fault_injector``): every plane (heartbeat, control gossip,
model gossip, the ICI plane inside the transport send) passes through it.
A duplicated control message comes back after ``duplicate_delay`` with a
fresh id and ``ttl=1`` (a relay the dedup ring has forgotten); a
duplicated weights envelope is re-sent as it was.

Churn rides the same plan: :class:`RestartSpec` kills a node like a
:class:`CrashSpec` and resurrects it ``resume_after_s`` later through the
harness's ``resurrect_fn`` (``Node.resume`` from its journal);
:class:`JoinSpec` and :class:`LeaveSpec` add and remove members of a
running async experiment, armed on a live fleet by :func:`schedule_churn`
and replayed on the virtual clock by ``federation/simfleet.py``.
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass
from typing import TYPE_CHECKING, Callable, Iterable, Optional

import numpy as np
import torch

from p2pfl_tpu_torch.communication.message import Message, WeightsEnvelope
from p2pfl_tpu_torch.management.logger import logger
from p2pfl_tpu_torch.management.telemetry import telemetry
from p2pfl_tpu_torch.ops.tree import tree_map

if TYPE_CHECKING:
    from p2pfl_tpu_torch.node import Node


@dataclass(frozen=True)
class EdgeFault:
    """Faults applied to one directed edge (or as the plan-wide default).

    ``scope`` limits which plane the fault touches: ``"both"`` (default),
    ``"weights"`` (model payloads only) or ``"control"``.
    """

    drop: float = 0.0            # P(send fails; transport reports False)
    delay: float = 0.0           # fixed seconds added before delivery
    jitter: float = 0.0          # + U(0, jitter) drawn from the edge RNG
    duplicate: float = 0.0       # P(a second copy is delivered later)
    duplicate_delay: float = 0.2  # how much later the copy lands
    scope: str = "both"          # "both" | "weights" | "control"

    def applies_to(self, env: object) -> bool:
        if self.scope == "both":
            return True
        is_weights = isinstance(env, WeightsEnvelope)
        return is_weights if self.scope == "weights" else not is_weights


@dataclass(frozen=True)
class CrashSpec:
    """Hard-crash a node when its learning thread enters ``stage``.

    ``round_no=None`` matches any round. ``after_s > 0`` arms a timer at
    stage entry instead of crashing at once: the node dies mid-stage.
    """

    stage: str
    round_no: Optional[int] = 0
    after_s: float = 0.0


@dataclass(frozen=True)
class ByzantineSpec:
    """A node that keeps talking and LIES: every model payload it sends is
    corrupted at the ``_do_send`` seam before it reaches the wire.

    Kinds: ``"sign_flip"`` (−params), ``"scale"`` (``lam`` x params),
    ``"noise"`` (params + N(0, ``noise_std``), fresh per send),
    ``"stale_replay"`` (its FIRST payload forever) and ``"equivocate"`` (a
    different scale to each peer, from the edge's own stream). ``cmds``
    bounds the attack to contribution payloads. The original update is
    never changed: in-process transports pass payloads by reference.
    """

    kind: str = "sign_flip"
    lam: float = 10.0
    noise_std: float = 1.0
    cmds: tuple = ("async_update", "add_model")


@dataclass(frozen=True)
class RestartSpec:
    """Kill a node like a :class:`CrashSpec`, then RESURRECT it.

    The crash half is a CrashSpec's (hard crash at ``stage``/``round_no``,
    ``after_s`` into the stage); ``resume_after_s`` later the harness brings
    the node back from its journal (``federation/durability.py``): the live
    fleet's ``resurrect_fn`` calls ``Node.resume(journal_dir)``, the
    simulator schedules a ``resurrect`` event on its virtual clock. Either
    way the node re-enters through the elastic join with its journaled
    identity.
    """

    stage: str = "AsyncTrainStage"
    round_no: Optional[int] = 0
    after_s: float = 0.0
    resume_after_s: float = 1.0


@dataclass(frozen=True)
class JoinSpec:
    """A member JOINS the running experiment at ``at_s`` seconds (the
    simulator's virtual clock, or wall clock after :func:`schedule_churn`);
    it bootstraps by pulling its aggregator's current global."""

    at_s: float


@dataclass(frozen=True)
class LeaveSpec:
    """A member LEAVES the running experiment at ``at_s``. ``graceful``
    announces it (``async_leave``; an aggregator forwards its partial buffer
    first); otherwise the exit is found like a crash, by heartbeat silence
    or the simulator's ``evict_delay``."""

    at_s: float
    graceful: bool = True


class FaultCrash(Exception):
    """Raised on the learning thread of a node crashed by a CrashSpec:
    unwinds the stage workflow the way a killed process stops executing."""


class FaultPlan:
    """A replayable description of everything that goes wrong.

    ``edges`` maps directed ``(src, dst)`` pairs to :class:`EdgeFault`
    overrides; ``default`` applies to every other edge. ``partitions`` is
    an iterable of one-way ``(src, dst)`` blocks. ``slow_nodes`` maps a
    receiver address to the latency every inbound weights delivery pays.
    ``crashes`` maps a node address to a :class:`CrashSpec`,
    ``byzantine`` an attacker's address to its :class:`ByzantineSpec`,
    ``restarts`` to a :class:`RestartSpec`, and ``joins`` / ``leaves`` to
    the churn events of an async experiment.
    """

    def __init__(
        self,
        seed: int,
        default: EdgeFault = EdgeFault(),
        edges: Optional[dict[tuple[str, str], EdgeFault]] = None,
        partitions: Iterable[tuple[str, str]] = (),
        slow_nodes: Optional[dict[str, float]] = None,
        crashes: Optional[dict[str, CrashSpec]] = None,
        byzantine: Optional[dict[str, ByzantineSpec]] = None,
        restarts: Optional[dict[str, RestartSpec]] = None,
        joins: Optional[dict[str, JoinSpec]] = None,
        leaves: Optional[dict[str, LeaveSpec]] = None,
    ) -> None:
        self.seed = seed
        self.default = default
        self.edges = dict(edges or {})
        self.partitions = set(partitions)
        self.slow_nodes = dict(slow_nodes or {})
        self.crashes = dict(crashes or {})
        self.byzantine = dict(byzantine or {})
        self.restarts = dict(restarts or {})
        self.joins = dict(joins or {})
        self.leaves = dict(leaves or {})
        self._rngs: dict[tuple[str, str], random.Random] = {}
        self._byz_rngs: dict[tuple[str, str], random.Random] = {}
        self._rng_lock = threading.Lock()
        #: crash specs already fired (addr): a spec fires exactly once
        self._crashed: set[str] = set()
        #: stale_replay capture: attacker addr -> its first payload's params
        self._byz_stale: dict[str, object] = {}

    def rng(self, src: str, dst: str) -> random.Random:
        """The directed edge's own deterministic stream."""
        key = (src, dst)
        with self._rng_lock:
            r = self._rngs.get(key)
            if r is None:
                r = self._rngs[key] = random.Random(f"{self.seed}:{src}->{dst}")
            return r

    def byz_rng(self, src: str, dst: str) -> random.Random:
        """The edge's corruption stream, apart from :meth:`rng` so arming an
        attack never shifts a drop or duplicate verdict."""
        key = (src, dst)
        with self._rng_lock:
            r = self._byz_rngs.get(key)
            if r is None:
                r = self._byz_rngs[key] = random.Random(f"{self.seed}:byz:{src}->{dst}")
            return r

    def edge_fault(self, src: str, dst: str) -> EdgeFault:
        return self.edges.get((src, dst), self.default)

    def partitioned(self, src: str, dst: str) -> bool:
        return (src, dst) in self.partitions


class FaultInjector:
    """Wraps one protocol's transport send with a plan's edge faults.

    Installed as ``protocol.fault_injector``; the protocol routes every
    send through :meth:`__call__` with the real transport send as the
    continuation.
    """

    def __init__(self, plan: FaultPlan, src: str) -> None:
        self.plan = plan
        self.src = src

    def __call__(
        self,
        nei: str,
        env: object,
        create_connection: bool,
        transport_send: Callable[..., bool],
    ) -> bool:
        plan = self.plan
        cmd = getattr(env, "cmd", "?")
        if plan.partitioned(self.src, nei):
            logger.log_comm_metric(self.src, "fault_partition_drop")
            telemetry.event(self.src, "fault_partition_drop", attrs={"peer": nei, "cmd": cmd})
            return False
        # straggler latency on inbound WEIGHTS deliveries only: a fat pipe
        # stalling while signaling flows
        slow = plan.slow_nodes.get(nei, 0.0)
        if slow and isinstance(env, WeightsEnvelope):
            telemetry.event(self.src, "fault_slow", attrs={"peer": nei, "delay_s": slow})
            time.sleep(slow)
        # corruption runs before the edge fault's scope gate: an attack and
        # a control-scoped fault are independent dimensions of one plan
        if plan.byzantine and isinstance(env, WeightsEnvelope):
            bad = byz_corrupt_update(plan, self.src, nei, env.update, env.cmd)
            if bad is not None:
                logger.log_comm_metric(self.src, "fault_byzantine")
                telemetry.event(
                    self.src, "fault_byzantine",
                    attrs={"peer": nei, "cmd": cmd, "kind": plan.byzantine[self.src].kind},
                )
                env = WeightsEnvelope(env.source, env.round, env.cmd, bad, trace_ctx=env.trace_ctx, xp=env.xp)
        fault = plan.edge_fault(self.src, nei)
        if not fault.applies_to(env):
            return transport_send(nei, env, create_connection=create_connection)
        rng = plan.rng(self.src, nei)
        # the full verdict tuple up front: the edge's stream advances the
        # same whether or not an earlier fault short-circuits
        drop_u, dup_u, jitter_u = rng.random(), rng.random(), rng.random()
        if fault.drop and drop_u < fault.drop:
            logger.log_comm_metric(self.src, "fault_drop")
            telemetry.event(self.src, "fault_drop", attrs={"peer": nei, "cmd": cmd})
            return False
        d = fault.delay + jitter_u * fault.jitter
        if d > 0:
            telemetry.event(self.src, "fault_delay", attrs={"peer": nei, "delay_s": round(d, 4)})
            time.sleep(d)
        ok = transport_send(nei, env, create_connection=create_connection)
        if ok and fault.duplicate and dup_u < fault.duplicate:
            logger.log_comm_metric(self.src, "fault_duplicate")
            telemetry.event(self.src, "fault_duplicate", attrs={"peer": nei, "cmd": cmd})
            t = threading.Timer(
                max(fault.duplicate_delay, 0.001), _deliver_copy,
                args=(transport_send, nei, _stale_copy(env), create_connection),
            )
            t.daemon = True
            t.start()
        return ok


def _stale_copy(env: object) -> object:
    """A re-delivery of ``env`` as the overlay would produce it: a control
    message with a fresh id and ttl=1, a weights envelope verbatim."""
    if isinstance(env, Message):
        return Message(env.source, env.cmd, env.args, env.round, ttl=1, trace_ctx=env.trace_ctx, xp=env.xp)
    return env


def _deliver_copy(transport_send, nei, env, create_connection) -> None:
    try:
        transport_send(nei, env, create_connection=create_connection)
    except Exception:  # noqa: BLE001 — the node may have stopped meanwhile
        pass


# ---- Byzantine corruption ----


def _tree_map_np(params, fn: Callable):
    """``fn`` on every floating leaf as a host fp32 numpy array (as in the
    JAX package, so the draws and the rounding match), cast back to the
    leaf's dtype and placed on its device; other leaves are cloned.
    Always NEW tensors: a corruption never aliases the honest tree."""

    def one(x: torch.Tensor) -> torch.Tensor:
        if not x.is_floating_point():
            return x.clone()
        out = fn(x.detach().float().cpu().numpy())
        return torch.from_numpy(np.ascontiguousarray(out)).to(dtype=x.dtype, device=x.device)

    return tree_map(one, params)


def byz_corrupt_update(plan: FaultPlan, src: str, dst: str, update, cmd: str):
    """The corrupted COPY of ``update`` an attacker ``src`` ships to
    ``dst``, or None when no corruption applies (no spec, another command,
    or a byte-only payload with no params to lie about). The draws ride
    :meth:`FaultPlan.byz_rng`'s stream, one step per corrupted payload."""
    spec = plan.byzantine.get(src)
    if spec is None or cmd not in spec.cmds:
        return None
    params = getattr(update, "params", None)
    if params is None:
        return None
    rng = plan.byz_rng(src, dst)
    kind = spec.kind
    if kind == "sign_flip":
        corrupted = _tree_map_np(params, lambda a: -a)
    elif kind == "scale":
        lam = float(spec.lam)
        corrupted = _tree_map_np(params, lambda a: lam * a)
    elif kind == "noise":
        g = np.random.default_rng(rng.getrandbits(32))
        std = float(spec.noise_std)
        corrupted = _tree_map_np(params, lambda a: a + g.normal(0.0, std, a.shape).astype(np.float32))
    elif kind == "stale_replay":
        with plan._rng_lock:
            stale = plan._byz_stale.get(src)
            if stale is None:
                stale = plan._byz_stale[src] = _tree_map_np(params, lambda a: a)
        corrupted = _tree_map_np(stale, lambda a: a)  # a fresh copy per send
    elif kind == "equivocate":
        # a different lie per edge per send, from the edge's own stream
        s = (-1.0 if rng.random() < 0.5 else 1.0) * rng.uniform(1.0, max(spec.lam, 1.0))
        corrupted = _tree_map_np(params, lambda a: np.float32(s) * a)
    else:
        raise ValueError(f"unknown ByzantineSpec kind {kind!r}")
    from p2pfl_tpu_torch.learning.weights import ModelUpdate

    return ModelUpdate(
        corrupted, list(update.contributors), update.num_samples,
        xp=update.xp, version=update.version, anchor=update.anchor, anchor_tag=update.anchor_tag,
    )


# ---- crash machinery ----


#: ByzantineSpec kinds with an elementwise payload transform: the ones the
#: megafleet engine applies as masked array transforms. ``stale_replay`` and
#: ``equivocate`` keep state per edge and need the heap engine.
BYZ_VECTOR_KINDS = ("sign_flip", "scale", "noise")
_BYZ_KIND_CODE = {"sign_flip": 1, "scale": 2, "noise": 3}


def byz_payload_grid(plan: FaultPlan, addrs: list) -> tuple:
    """Dense per-node corruption codes of a plan's Byzantine specs:
    ``(kind_code [N] int32, lam [N] f32, std [N] f32)`` over ``addrs`` in
    index order, code 0 honest, 1 ``−a``, 2 ``lam·a``, 3 ``a + N(0, std)``
    (the caller draws the noise rows from its own seeded stream). A spec
    whose ``cmds`` excludes ``"async_update"`` maps to 0; a kind outside
    :data:`BYZ_VECTOR_KINDS` raises toward the heap engine."""
    n = len(addrs)
    code = np.zeros(n, np.int32)
    lam = np.ones(n, np.float32)
    std = np.zeros(n, np.float32)
    idx = {a: j for j, a in enumerate(addrs)}
    for addr, spec in plan.byzantine.items():
        j = idx.get(addr)
        if j is None:
            continue
        if spec.kind not in BYZ_VECTOR_KINDS:
            raise ValueError(
                f"ByzantineSpec kind {spec.kind!r} is stateful per edge and needs the heap "
                f"engine; vectorized kinds: {'/'.join(BYZ_VECTOR_KINDS)}"
            )
        if "async_update" not in spec.cmds:
            continue
        code[j] = _BYZ_KIND_CODE[spec.kind]
        lam[j] = np.float32(spec.lam)
        std[j] = np.float32(spec.noise_std)
    return code, lam, std


def hard_crash(node: "Node") -> None:
    """Kill a node the way a dead process dies: no goodbyes. The server
    unregisters, heartbeats and gossip stop, the learner is interrupted,
    and no neighbor is told: peers find out through heartbeat silence and
    send failures."""
    logger.warning(node.addr, "FAULT: hard crash injected")
    logger.log_comm_metric(node.addr, "fault_crash")
    telemetry.event(
        node.addr, "fault_crash",
        attrs={"stage": getattr(node.state, "current_stage", None), "round": getattr(node.state, "round", None)},
    )
    node._interrupt.set()
    if node.learner is not None:
        try:
            node.learner.interrupt_fit()
        except Exception:  # noqa: BLE001 — learner may not be fitted yet
            pass
    proto = node.protocol
    try:
        getattr(proto, "crash", proto._server_stop)()  # unregister only
    except Exception:  # noqa: BLE001
        pass
    proto.heartbeater.stop()
    proto.gossiper.stop()
    node._running = False
    node.state.status = "Idle"


def make_stage_hook(
    plan: FaultPlan, resurrect_fn: Optional[Callable[[str], None]] = None
) -> Callable[["Node", str], None]:
    """A ``Node.stage_hooks`` entry firing the plan's crash and restart
    specs. ``resurrect_fn(addr)`` is the live half of a restart, called
    ``resume_after_s`` after the kill on a daemon timer (only the harness
    can rebuild models and data and call ``Node.resume``); without it a
    RestartSpec is its crash half alone."""

    def kill(node: "Node", spec, stage_name: str, sync: bool) -> None:
        hard_crash(node)
        delay = getattr(spec, "resume_after_s", None)
        if delay is not None and resurrect_fn is not None:
            t = threading.Timer(max(delay, 0.001), _resurrect, args=(node.addr,))
            t.daemon = True
            t.start()
        if sync:
            raise FaultCrash(f"{node.addr} crashed entering {stage_name}")

    def _resurrect(addr: str) -> None:
        try:
            resurrect_fn(addr)
        except Exception as exc:  # noqa: BLE001 — a failed resurrection is a dead node, not a harness crash
            logger.error(addr, f"FAULT: resurrection failed: {exc!r}")

    def hook(node: "Node", stage_name: str) -> None:
        spec = plan.crashes.get(node.addr) or plan.restarts.get(node.addr)
        if spec is None or node.addr in plan._crashed or spec.stage != stage_name:
            return
        if spec.round_no is not None and node.state.round != spec.round_no:
            return
        plan._crashed.add(node.addr)
        if spec.after_s > 0:
            t = threading.Timer(spec.after_s, kill, args=(node, spec, stage_name, False))
            t.daemon = True
            t.start()
            return
        kill(node, spec, stage_name, sync=True)

    return hook


def install_fault_plan(
    nodes: Iterable["Node"], plan: FaultPlan, resurrect_fn: Optional[Callable[[str], None]] = None
) -> None:
    """Wire a plan into an in-process federation (or any node set)."""
    hook = make_stage_hook(plan, resurrect_fn) if (plan.crashes or plan.restarts) else None
    for node in nodes:
        node.protocol.fault_injector = FaultInjector(plan, node.addr)
        if hook is not None:
            node.stage_hooks.append(hook)


def remove_fault_plan(nodes: Iterable["Node"]) -> None:
    for node in nodes:
        node.protocol.fault_injector = None
        node.stage_hooks.clear()


def schedule_churn(plan: FaultPlan, join_fn, leave_fn) -> list:
    """Arm a plan's churn on a LIVE fleet (wall-clock timers):
    ``join_fn(addr)`` at each join's ``at_s`` (the caller builds and
    connects the joiner), ``leave_fn(addr, graceful)`` at each leave's.
    Returns the started timers so a test can cancel them. Crash and restart
    specs stay on the stage-hook seam (:func:`install_fault_plan`)."""
    timers = []
    for addr in sorted(plan.joins):
        t = threading.Timer(plan.joins[addr].at_s, join_fn, args=(addr,))
        t.daemon = True
        t.start()
        timers.append(t)
    for addr in sorted(plan.leaves):
        spec = plan.leaves[addr]
        t = threading.Timer(spec.at_s, leave_fn, args=(addr, spec.graceful))
        t.daemon = True
        t.start()
        timers.append(t)
    return timers
