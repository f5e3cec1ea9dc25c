"""Megafleet: the async fleet simulator at a million clients (counterpart
of ``p2pfl_tpu/federation/megafleet.py``).

:class:`~p2pfl_tpu_torch.federation.simfleet.SimulatedAsyncFleet` pushes
real per-node buffers through a heap, which caps it near 10k nodes. This
module runs the same fleet as dense per-client arrays through the engines
of :mod:`~p2pfl_tpu_torch.ops.fleet_kernels`: per-client ``(params,
adopted version, train schedule, fault stream)`` state on the device, the
regional tier as windows addressed by regional, the live buffer's fold and
:class:`~p2pfl_tpu_torch.federation.routing.TierRouter`'s membership →
tier derivation (clusters, regional election and K clamps come from a real
router over the same addresses).

The default engine takes ``Settings.MEGAFLEET_CHUNK`` events a step (the
chunked engine: pass A in PyTorch, passes B-D in the ``fleet_chunk`` CUDA
kernel on the card); ``chunk=1`` is the per-event reference engine, and
the two are bit-identical on flat topologies. ``shards=P`` splits the
chunked engine's client rows over P slots (the sharded engine, which
trains each shard's lanes on its slot and keeps admission replicated:
bit-identical to the chunked engine).

**The heap engine is the parity anchor.** At 1k nodes on the consensus
task the flat engine reproduces the heap's merge count, version sequence
and staleness decisions exactly, the loss curve to float reassociation;
the hierarchical engine processes a regional flush's aggregate at the
flush (its ``link_delay`` shows in the mint time and the adoption
bookkeeping only), so aggregates that would interleave inside one
in-flight window can order otherwise than the heap's.

**Faults.** A :class:`~p2pfl_tpu_torch.communication.faults.FaultPlan` is
read through counter-based streams, dense verdict grids indexed by
``(node, send index)`` and drawn from ``(plan.seed, stream id)``: a plan
replays bit-exact from ``(seed, plan)`` (the verdicts differ from the
heap's per-edge streams, so plan parity between the engines is
statistical). Supported: ``default`` drop/delay/jitter/duplicate on both
upward hops, ``slow_nodes``, ``crashes`` at ``AsyncTrainStage``, the
stateless ``byzantine`` kinds at both send seams, and ``joins``/``leaves``
churn as time-indexed liveness with a real :class:`TierRouter` at every
membership boundary. Per-edge overrides, partitions and the stateful
combinations raise toward the heap engine.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from p2pfl_tpu_torch.federation.routing import TierRouter
from p2pfl_tpu_torch.federation.simfleet import FleetResult

#: the counter streams' ids, one a concern (arming one knob never moves
#: another's verdicts); the JAX package's numbers
_STREAM_POP = 17  #: population shape (durations, slow membership)
_STREAM_TARGET = 7  #: consensus targets (as simfleet's)
_STREAM_SELECT = 19
_STREAM_DROP = 23
_STREAM_JITTER = 29
_STREAM_PACE = 31
_STREAM_AGG_DROP = 37  #: regional → root aggregate send verdicts
_STREAM_AGG_JIT = 41
_STREAM_DUP = 43  #: edge duplicate verdicts (counted no-ops)
_STREAM_BYZ = 47  #: Byzantine "noise" rows at the edge seam
_STREAM_AGG_NOISE = 53  #: Byzantine "noise" rows at the aggregate seam
_STREAM_AGG_DUP = 59  #: aggregate duplicate verdicts (counted)

#: window folds the engines run (krum-screen scores contributions
#: against each other's distances: heap only)
_VECTOR_FOLDS = ("fedavg", "trimmed-mean", "median")


@dataclass(frozen=True)
class GradTask:
    """The real-gradient workload: every client trains a tiny model
    (``linear``: one dense layer; ``mlp``: dense → relu → dense) with SGD
    steps on softmax cross-entropy, batched over a chunk's lanes by
    :func:`~p2pfl_tpu_torch.ops.fleet_kernels.make_grad_fns`. A client's
    data is keyed by ``(client, round)``: a Gaussian cloud around its
    private ``mu`` (``hetero`` spreads them) labelled by a fixed teacher.
    The loss curve is the teacher-labelled eval set's cross-entropy."""

    kind: str = "linear"  #: "linear" | "mlp"
    d_in: int = 8
    n_out: int = 4
    hidden: int = 0  #: MLP hidden width (0 for linear)
    batch: int = 8
    steps: int = 2  #: SGD steps a local round
    data_seed: int = 0
    hetero: float = 1.0  #: client-mean spread (0 = IID)
    n_eval: int = 256

    def param_dim(self) -> int:
        from p2pfl_tpu_torch.ops.fleet_kernels import grad_param_dim

        return grad_param_dim(self.kind, self.d_in, self.n_out, self.hidden)

    def arrays(self, n: int):
        """``(mu [n, d_in], tw, tb, x_eval, y_eval)``: client means, the
        labelling teacher and the eval set, each from its own stream of
        ``data_seed``."""
        mu = (np.random.default_rng([self.data_seed, 3, n]).normal(size=(n, self.d_in)).astype(np.float32)
              * np.float32(self.hetero))
        trng = np.random.default_rng([self.data_seed, 1])
        tw = trng.normal(size=(self.d_in, self.n_out)).astype(np.float32)
        tb = trng.normal(size=(self.n_out,)).astype(np.float32)
        erng = np.random.default_rng([self.data_seed, 2])
        xe = erng.normal(size=(self.n_eval, self.d_in)).astype(np.float32)
        ye = np.argmax(xe @ tw + tb, axis=-1).astype(np.int32)
        return mu, tw, tb, xe, ye


@dataclass
class FleetSpec:
    """The edge population, one array a property: :meth:`from_sim` exports
    a heap fleet's population (the parity hook), :meth:`synth` draws one of
    any size from vectorized counter streams."""

    durations: np.ndarray  #: [N] f64: train duration of an update
    num_samples: np.ndarray  #: [N] f32: sample weights
    targets: np.ndarray  #: [N, dim] f32: consensus targets
    slow: np.ndarray  #: [N] f64: extra inbound latency as aggregator
    init: np.ndarray  #: [dim] f32: the shared initial model
    seed: int
    #: the exporting fleet's wire latency (None: the engine's default)
    link_delay: Optional[float] = None

    @property
    def n(self) -> int:
        return int(self.durations.shape[0])

    @property
    def dim(self) -> int:
        return int(self.targets.shape[1])

    def target_mean(self) -> np.ndarray:
        """The consensus fixed point: the sample-weighted target mean."""
        w = self.num_samples.astype(np.float32)
        return (w[:, None] * self.targets).sum(0) / w.sum()

    def loss(self, params: np.ndarray) -> float:
        d = np.asarray(params, np.float32) - self.target_mean()
        return float((d * d).sum())

    @classmethod
    def from_sim(cls, fleet, extra: int = 0, allow_custom: bool = False) -> "FleetSpec":
        """A :class:`SimulatedAsyncFleet`'s population through its
        ``export_spec`` (sorted address order == index order); ``extra``
        appends pending-joiner rows, ``allow_custom`` admits a heap fleet
        driven by a vectorized-twin ``train_fn``."""
        d = fleet.export_spec(extra=extra, allow_custom=allow_custom)
        return cls(durations=d["durations"], num_samples=d["num_samples"], targets=d["targets"],
                   slow=d["slow"], init=d["init"], seed=d["seed"], link_delay=d["link_delay"])

    @classmethod
    def synth(cls, n: int, *, seed: int = 0, dim: int = 16, base_duration: float = 1.0,
              slow_frac: float = 0.0, slow_factor: float = 10.0) -> "FleetSpec":
        """A population with the heap's statistics (durations U[0.8,
        1.2]·base, a ``slow_frac`` straggler share at ``slow_factor``×,
        samples ``1 + i mod 3``, targets a shared offset plus private noise)
        in three vectorized draws."""
        rng = np.random.default_rng([seed, _STREAM_POP])
        durations = base_duration * (0.8 + 0.4 * rng.random(n))
        if slow_frac > 0.0:
            durations = np.where(rng.random(n) < slow_frac, durations * slow_factor, durations)
        base = np.random.default_rng([seed, 5]).normal(size=dim).astype(np.float32) * 2.0
        noise = np.random.default_rng([seed, _STREAM_TARGET, n]).normal(size=(n, dim)).astype(np.float32)
        return cls(durations=durations.astype(np.float64), num_samples=(1 + np.arange(n) % 3).astype(np.float32),
                   targets=base[None, :] + noise, slow=np.zeros(n, np.float64), init=np.zeros(dim, np.float32),
                   seed=int(seed))


@dataclass
class MegaFleetResult(FleetResult):
    """A :class:`FleetResult` plus the array engine's fleet statistics."""

    regional_merges: int = 0
    buffered: int = 0  #: client contributions admitted into a window
    stale_dropped: int = 0  #: τ > max_staleness at either gate
    rate_limited: int = 0  #: refused by a per-tier rate limit
    unselected: int = 0  #: update slots selection skipped
    staleness_hist_edge: List[int] = field(default_factory=list)
    staleness_hist_global: List[int] = field(default_factory=list)
    n_events: int = 0  #: trained updates, dropped sends included
    wall_s: float = 0.0  #: host wall clock of the whole run
    clients_per_sec: float = 0.0  #: n_clients / wall_s


class MegaFleet:
    """One vectorized fleet on ``device`` (the card for ``None``);
    :meth:`run` drives it.

    The constructor mirrors :class:`SimulatedAsyncFleet`'s where the
    semantics coincide and adds the fleet knobs: ``pace_window`` (each
    client's schedule offset by a seeded draw in ``[0, pace_window)``),
    ``select_frac`` (each ``(client, update)`` slot runs with this
    probability), ``rate_limit_regional`` / ``rate_limit_global`` (a tier
    refuses offers inside the gap after its last accepted one), ``chunk``
    (events a step: 1 the per-event engine, 0 or ``"auto"`` measures
    :data:`~p2pfl_tpu_torch.ops.fleet_autotune.DEFAULT_CANDIDATES` once on
    the device and replays the winner from the fleet-tune cache),
    ``shards`` (split the chunked engine's client rows over a ``(clients,)``
    mesh of that many slots, :class:`~p2pfl_tpu_torch.ops.fleet_kernels.
    ShardedFleet`: P CPU slots for a CPU fleet, the first P visible cards
    for a card fleet, raising past them; ``mesh`` names the slots instead,
    e.g. ``fleet_clients_mesh(P, devices=["cuda:0"] * P)`` for P slots of
    one card, and the fleet then lies on its first slot; admission stays
    replicated, so the results are the one-slot engine's bit for bit; 0 or
    1 is one slot), ``task`` (a :class:`GradTask` for the consensus step)
    and ``fold`` / ``trim`` (the window fold family). Defaults come from
    ``Settings.MEGAFLEET_*`` (and ``ASYNC_ROBUST_AGG`` / ``ASYNC_TRIM``) at
    construction.
    """

    def __init__(
        self,
        spec: FleetSpec,
        *,
        cluster_size: int = 0,
        k: Optional[int] = None,
        alpha: Optional[float] = None,
        server_lr: Optional[float] = None,
        max_staleness: Optional[int] = None,
        updates_per_node: int = 4,
        link_delay: Optional[float] = None,
        local_lr: float = 0.5,
        target_loss: float = 0.0,
        plan=None,
        pace_window: Optional[float] = None,
        select_frac: Optional[float] = None,
        rate_limit_regional: Optional[float] = None,
        rate_limit_global: Optional[float] = None,
        chunk=None,
        shards: Optional[int] = None,
        task: Optional[GradTask] = None,
        fold: Optional[str] = None,
        trim: Optional[int] = None,
        evict_delay: float = 0.5,
        device=None,
        mesh=None,
    ) -> None:
        from p2pfl_tpu_torch.settings import Settings

        self.spec = spec
        self.n = spec.n
        self.dim = spec.dim
        self.seed = int(spec.seed)
        self.cluster_size = int(cluster_size)
        self.updates_per_node = int(updates_per_node)
        if link_delay is None:
            link_delay = spec.link_delay if spec.link_delay is not None else 0.01
        self.link_delay = float(link_delay)
        self.local_lr = float(local_lr)
        self.target_loss = float(target_loss)
        self.k = max(1, int(Settings.FEDBUFF_K if k is None else k))
        self.alpha = float(Settings.FEDBUFF_ALPHA if alpha is None else alpha)
        self.server_lr = float(Settings.FEDBUFF_SERVER_LR if server_lr is None else server_lr)
        self.max_staleness = int(Settings.ASYNC_MAX_STALENESS if max_staleness is None else max_staleness)
        self.pace_window = float(Settings.MEGAFLEET_PACE_WINDOW if pace_window is None else pace_window)
        self.select_frac = float(Settings.MEGAFLEET_SELECT_FRAC if select_frac is None else select_frac)
        self.rate_limit_regional = float(
            Settings.MEGAFLEET_REGIONAL_RATE_S if rate_limit_regional is None else rate_limit_regional)
        self.rate_limit_global = float(
            Settings.MEGAFLEET_GLOBAL_RATE_S if rate_limit_global is None else rate_limit_global)
        chunk_val = Settings.MEGAFLEET_CHUNK if chunk is None else chunk
        # "auto"/0 resolves through the fleet-tune cache at run()
        self._chunk_auto = chunk_val == "auto" or (not isinstance(chunk_val, str) and int(chunk_val) == 0)
        self.chunk = 256 if self._chunk_auto else max(1, int(chunk_val))
        self.shards = max(0, int(Settings.MEGAFLEET_SHARDS if shards is None else shards))
        self.shard_slack = max(1.0, float(Settings.MEGAFLEET_SHARD_SLACK))
        self.mesh = None
        self.device = self._seat(device, mesh, shards is not None)
        self.task = task
        self.fold = str(Settings.ASYNC_ROBUST_AGG if fold is None else fold)
        self.trim = int(Settings.ASYNC_TRIM if trim is None else trim)
        self.evict_delay = float(evict_delay)
        if self.fold not in _VECTOR_FOLDS:
            raise ValueError(
                f"megafleet folds are {'/'.join(_VECTOR_FOLDS)}; {self.fold!r} scores contributions "
                "statefully and needs the heap engine")
        if task is not None and self.dim != task.param_dim():
            raise ValueError(
                f"GradTask({task.kind!r}) flattens to {task.param_dim()} parameters; the spec carries "
                f"dim={self.dim}: build the spec with dim=task.param_dim()")
        self.plan = plan
        # membership → tiers through the real router (zero-padded sorted
        # addresses == index order: clusters are contiguous index ranges)
        width = max(4, len(str(self.n - 1)))
        self.addrs = [f"sim-{i:0{width}d}" for i in range(self.n)]
        self.router = TierRouter(self.addrs, self.cluster_size)
        self._addr_idx = {a: j for j, a in enumerate(self.addrs)}
        self.hier = not self.router.topo.is_flat()
        self._byz: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None
        self._task_cache = None
        self._check_plan(plan)
        self._churn = self._derive_churn()

    def _seat(self, device, mesh, asked: bool):
        """The fleet's device, and its ``(clients,)`` mesh when sharded: the
        given ``mesh`` (the fleet on its first slot), else ``shards`` slots
        of the CPU for a CPU fleet or the first ``shards`` visible cards
        (raising past them)."""
        from p2pfl_tpu_torch import resolve_device
        from p2pfl_tpu_torch.parallel.fleet_mesh import fleet_clients_mesh
        from p2pfl_tpu_torch.parallel.mesh import _devices
        from p2pfl_tpu_torch.settings import Settings

        if mesh is None:
            dev = resolve_device(device)
            if self.shards > 1:
                self.mesh = fleet_clients_mesh(self.shards, [dev] * self.shards if dev.type == "cpu" else None)
                dev = self.mesh.devices.flat[0]
            return dev
        if tuple(mesh.shape) != (Settings.MESH_CLIENTS_AXIS,):
            raise ValueError(f"a fleet's mesh has the one axis {Settings.MESH_CLIENTS_AXIS!r}, got {dict(mesh.shape)}")
        if asked and max(self.shards, 1) != mesh.size:
            raise ValueError(f"shards={self.shards} against a mesh of {mesh.size} slots")
        first = mesh.devices.flat[0]
        if device is not None and _devices([device])[0] != first:
            raise ValueError(f"device={device} against a mesh whose first slot is {first}")
        self.shards = mesh.size
        self.mesh = mesh if mesh.size > 1 else None
        return first

    def _check_plan(self, plan) -> None:
        if plan is None:
            return
        unsupported = [name for name, val in (("edges", plan.edges), ("partitions", plan.partitions)) if val]
        if unsupported:
            raise ValueError(
                "MegaFleet's fault algebra is counter-grid based: verdict streams are keyed by (node, send "
                f"index), so per-edge overrides and pairwise cuts ({'/'.join(unsupported)}) need the heap "
                "engine (SimulatedAsyncFleet)")
        if plan.byzantine:
            from p2pfl_tpu_torch.communication.faults import byz_payload_grid

            # raises toward the heap for the stateful kinds
            self._byz = byz_payload_grid(plan, self.addrs)
        if plan.joins or plan.leaves:
            if plan.byzantine:
                raise ValueError(
                    "churn × byzantine re-elects attackers mid-run (the aggregate corruption grid would go "
                    "stale); the combination needs the heap engine")
            if self.fold != "fedavg":
                raise ValueError(
                    "churn × robust folds shrinks windows mid-run (rank statistics over a re-clamped K); "
                    "the combination needs the heap engine")
            if plan.slow_nodes or bool(np.any(self.spec.slow != 0.0)):
                raise ValueError(
                    "churn × slow_nodes re-prices every hop per election; the combination needs the heap "
                    "engine")

    def _derive_churn(self) -> Optional[Dict[str, Any]]:
        """The time-indexed liveness table: per-client ``(start, stop)``
        windows and one real :class:`TierRouter` a membership boundary."""
        plan = self.plan
        if plan is None or not (plan.joins or plan.leaves):
            return None
        n = self.n
        join_at: Dict[int, float] = {}
        for a in sorted(plan.joins):
            j = self._addr_idx.get(a)
            if j is not None:
                join_at[j] = float(plan.joins[a].at_s)
        founders = n - len(join_at)
        if join_at and sorted(join_at) != list(range(founders, n)):
            raise ValueError(
                "megafleet joiners must occupy the top address block (sorted-address order == index order "
                "keeps founder clusters stable as they arrive); scattered join addresses need the heap "
                "engine")
        ats = [join_at[j] for j in range(founders, n)]
        if any(b < a for a, b in zip(ats, ats[1:])):
            raise ValueError(
                "megafleet join times must be nondecreasing in address order (the heap assigns population "
                "streams in join order; reordered joins need the heap engine)")
        start = np.zeros(n, np.float64)
        stop = np.full(n, np.inf, np.float64)
        joined: List[str] = []
        for j in range(founders, n):
            # a joiner's first training completes at at_s + link_delay + duration
            start[j] = join_at[j] + self.link_delay
            joined.append(self.addrs[j])
        dead_at: Dict[int, float] = {}
        left: List[str] = []
        for a in sorted(plan.leaves):
            j = self._addr_idx.get(a)
            if j is None:
                continue
            sp = plan.leaves[a]
            stop[j] = min(stop[j], float(sp.at_s))
            # graceful: the topology re-derives at at_s; abrupt: one
            # eviction window later
            dead_at[j] = float(sp.at_s) + (0.0 if sp.graceful else self.evict_delay)
            left.append(a)
        bounds = sorted({0.0} | set(join_at.values()) | set(dead_at.values()))
        routers: List[Tuple[float, TierRouter]] = []
        failovers = 0
        prev_root: Optional[str] = None
        for T in bounds:
            members = [self.addrs[j] for j in range(n) if j < founders or join_at[j] <= T]
            dead = [self.addrs[j] for j, td in dead_at.items() if td <= T]
            rt = TierRouter(members, self.cluster_size, dead=dead)
            if prev_root is not None and rt.root != prev_root:
                failovers += 1
            prev_root = rt.root
            routers.append((T, rt))
        return {"routers": routers, "start": start, "stop": stop, "joined": joined, "left": left,
                "failovers": failovers}

    # ---- array derivation (host, numpy) ----

    def _tier_arrays(self):
        """Per-client and per-regional routing arrays, one row a churn
        epoch. Cluster geometry is the full population's; an epoch varies
        the election, the hop prices and the K clamps."""
        n, L = self.n, self.link_delay
        plan_delay = float(self.plan.default.delay) if self.plan is not None else 0.0
        slow = self.spec.slow
        if self.plan is not None and self.plan.slow_nodes:
            # by max: idempotent whether or not the spec carries them
            plan_slow = np.zeros(n, np.float64)
            for addr, extra in self.plan.slow_nodes.items():
                j = self._addr_idx.get(addr)
                if j is not None:
                    plan_slow[j] = float(extra)
            slow = np.maximum(slow, plan_slow)
        clusters = self.router.topo.clusters
        R = len(clusters)
        regional_of = np.zeros(n, np.int32)
        for ci, cluster in enumerate(clusters):
            for a in cluster:
                regional_of[self._addr_idx[a]] = ci
        epoch_routers = self._churn["routers"] if self._churn is not None else [(0.0, self.router)]
        bounds = np.asarray([t for t, _ in epoch_routers], np.float64)
        n_ep = len(epoch_routers)
        reg_node = np.full((n_ep, R), -1, np.int32)
        k_reg = np.ones((n_ep, R), np.int32)
        reg_adopt = np.zeros((n_ep, R), np.float64)
        is_regional = np.zeros((n_ep, n), bool)
        arr_delay = np.zeros((n_ep, n), np.float64)
        adopt_delay = np.zeros((n_ep, n), np.float64)
        root_is = np.zeros(n_ep, np.int64)
        k_globals: List[int] = []
        idx_arange = np.arange(n)
        for e_i, (_, rt) in enumerate(epoch_routers):
            root_i = self._addr_idx[rt.root]
            root_is[e_i] = root_i
            for ci, cluster in enumerate(rt.topo.clusters):
                a = next((m for m in cluster if m not in rt.dead), None)
                if a is None:
                    continue  # a fully dead cluster: no live event routes here
                reg_node[e_i, ci] = self._addr_idx[a]
                k_reg[e_i, ci] = rt.buffer_plan(a, self.k).regional_k or 1
            k_globals.append(int(rt.buffer_plan(rt.root, self.k).global_k or 1))
            rn = reg_node[e_i]
            rsafe = np.clip(rn, 0, None)
            reg_adopt[e_i] = np.where((rn >= 0) & (rn != root_i), L + plan_delay + slow[rsafe], 0.0)
            my_reg = rn[regional_of]
            is_reg = idx_arange == my_reg
            is_regional[e_i] = is_reg
            hop_reg = L + plan_delay + slow[np.clip(my_reg, 0, None)]
            arr_delay[e_i] = np.where(is_reg, 0.0, hop_reg)
            hop_down_self = L + plan_delay + slow
            root_cluster = regional_of[root_i]
            ad = np.where(regional_of == root_cluster, hop_down_self, reg_adopt[e_i][regional_of] + hop_down_self)
            ad = np.where(is_reg, reg_adopt[e_i][regional_of], ad)
            ad[root_i] = 0.0
            adopt_delay[e_i] = ad
        k_global = k_globals[0]
        if any(kg != k_global for kg in k_globals):
            raise ValueError("churn re-clamps the global K mid-run; that repair path needs the heap engine")
        root_cluster0 = int(regional_of[root_is[0]])
        if any(int(regional_of[ri]) != root_cluster0 for ri in root_is):
            raise ValueError(
                "churn moved the global root to another cluster (a fully dead root cluster); that failover "
                "needs the heap engine")
        is_root_reg = np.arange(R) == root_cluster0
        agg_delay = np.where(is_root_reg, 0.0, L + plan_delay + slow[root_is[0]])
        return {"bounds": bounds, "n_ep": n_ep, "regional_of": regional_of, "reg_node": reg_node,
                "is_regional": is_regional, "arr_delay": arr_delay, "adopt_delay": adopt_delay,
                "reg_adopt": reg_adopt, "agg_delay": agg_delay, "is_root_reg": is_root_reg, "k_reg": k_reg,
                "k_global": int(k_global)}

    def _agg_grids(self, tiers, stride: int) -> Dict[str, np.ndarray]:
        """Per-(regional, up_seq) verdict grids of the regional → root
        aggregate sends: the plan's drop/jitter/duplicate and a regional
        attacker's corruption (the root's own cluster offers directly)."""
        R = tiers["k_reg"].shape[1]
        out: Dict[str, np.ndarray] = {"ok": np.ones((R, stride), bool), "jit": np.zeros((R, stride), np.float32),
                                      "dup": np.zeros((R, stride), bool)}
        plan = self.plan
        if plan is None or not self.hier:
            return out
        irr = tiers["is_root_reg"]
        if plan.default.drop > 0.0:
            ok = np.random.default_rng([self.seed, _STREAM_AGG_DROP]).random((R, stride)) >= plan.default.drop
            ok[irr, :] = True
            out["ok"] = ok
        if plan.default.jitter > 0.0:
            jit = (np.random.default_rng([self.seed, _STREAM_AGG_JIT]).random((R, stride)).astype(np.float32)
                   * np.float32(plan.default.jitter))
            jit[irr, :] = 0.0
            out["jit"] = jit
        if plan.default.duplicate > 0.0:
            dup = np.random.default_rng([self.seed, _STREAM_AGG_DUP]).random((R, stride)) < plan.default.duplicate
            dup[irr, :] = False
            out["dup"] = dup
        if self._byz is not None:
            # churn × byzantine raises: epoch 0's regionals are the regionals
            code, lam, std = self._byz
            rn = tiers["reg_node"][0]
            rsafe = np.clip(rn, 0, None)
            akind = np.where((rn >= 0) & ~irr, code[rsafe], 0).astype(np.int32)
            out["akind"] = akind
            out["alam"] = np.where(akind > 0, lam[rsafe], 1.0).astype(np.float32)
            att_r = np.nonzero(akind == 3)[0]
            nrow = int(att_r.shape[0]) * stride
            agg_noise = np.zeros((nrow + 1, self.dim), np.float32)
            idxg = np.zeros((R, stride), np.int64)
            if nrow:
                draws = (np.random.default_rng([self.seed, _STREAM_AGG_NOISE]).normal(size=(nrow, self.dim))
                         .astype(np.float32))
                agg_noise[1:] = draws * std[rn[att_r]].repeat(stride)[:, None]
                idxg[att_r] = 1 + np.arange(nrow).reshape(-1, stride)
            out["agg_noise_idx"] = idxg.astype(np.int32)
            out["agg_noise"] = agg_noise
        return out

    def _events(self, tiers) -> Dict[str, Any]:
        """The sorted arrival rows and verdict columns. Fold keys are two
        int32 words, ``key_hi`` the origin index and ``key_lo`` the 1-based
        update seq, sorted ``(hi, lo)`` in the fold: the heap's ``(origin
        addr, seq)`` order, with no product key to overflow."""
        n, M = self.n, self.updates_per_node
        d = self.spec.durations
        seed = self.seed
        crash_limit = np.full(n, M, np.int64)
        if self.plan is not None:
            for addr, spec in self.plan.crashes.items():
                j = self._addr_idx.get(addr)
                if j is not None and spec.stage == "AsyncTrainStage":
                    crash_limit[j] = min(M, spec.round_no or 0)
        pace = np.zeros(n, np.float64)
        if self.pace_window > 0.0:
            pace = np.random.default_rng([seed, _STREAM_PACE]).random(n) * self.pace_window
        churn = self._churn
        start = churn["start"] if churn is not None else np.zeros(n, np.float64)
        stop = churn["stop"] if churn is not None else np.full(n, np.inf)
        m = np.arange(1, M + 1)
        alive = m[None, :] <= crash_limit[:, None]
        t_train = start[:, None] + pace[:, None] + m[None, :] * d[:, None]
        alive &= t_train < stop[:, None]  # a leaver stops producing at at_s
        selected = np.ones((n, M), bool)
        if self.select_frac < 1.0:
            selected = np.random.default_rng([seed, _STREAM_SELECT]).random((n, M)) < self.select_frac
        unselected = int((alive & ~selected).sum())
        plan = self.plan
        ii, mm = np.nonzero(alive & selected)
        tt = t_train[ii, mm]
        ep = np.clip(np.searchsorted(tiers["bounds"], tt, side="right") - 1, 0, tiers["n_ep"] - 1)
        isreg = tiers["is_regional"][ep, ii]
        ta = tt + tiers["arr_delay"][ep, ii]
        if plan is not None and plan.default.jitter > 0.0:
            jit = np.random.default_rng([seed, _STREAM_JITTER]).random((n, M)) * plan.default.jitter
            # regionals offer to themselves: no wire, no jitter
            ta = ta + np.where(isreg, 0.0, jit[ii, mm])
        ok = np.ones(ii.shape[0], bool)
        if plan is not None and plan.default.drop > 0.0:
            dropped = np.random.default_rng([seed, _STREAM_DROP]).random((n, M)) < plan.default.drop
            ok = ~(dropped[ii, mm] & ~isreg)
        wire_dropped = int((~ok).sum())
        lost = 0
        if churn is not None:
            # an arrival at an aggregator that stopped before it is lost
            tgt = tiers["reg_node"][ep, tiers["regional_of"][ii]]
            dead_arrival = ~isreg & (ta >= stop[np.clip(tgt, 0, None)])
            lost = int((ok & dead_arrival).sum())
            ok = ok & ~dead_arrival
        order = np.lexsort((mm, ii, ta))
        ii, mm, tt, ta, ok, ep, isreg = (x[order] for x in (ii, mm, tt, ta, ok, ep, isreg))
        tt32 = tt.astype(np.float32)
        out: Dict[str, Any] = {
            "client": ii.astype(np.int32),
            "key_hi": ii.astype(np.int32),
            "key_lo": (mm + 1).astype(np.int32),
            "t_train": tt32,
            "t_arr": ta.astype(np.float32),
            # the fp32 subtraction the per-event engine does in its loop
            "t_adopt": tt32 - tiers["adopt_delay"][ep, ii].astype(np.float32),
            "send_ok": ok,
            "ep": ep.astype(np.int32),
            "is_reg": isreg,
            "_unselected": unselected,
            "_wire_dropped": wire_dropped,
            "_lost": lost,
        }
        if self._byz is not None:
            code, lam, std = self._byz
            bkind = np.where(isreg, 0, code[ii]).astype(np.int32)
            out["bkind"] = bkind
            out["blam"] = lam[ii].astype(np.float32)
            out["bstd"] = std[ii].astype(np.float32)
            # counted at the send seam, before the drop verdict (heap order)
            out["_byz_edge"] = int((bkind > 0).sum())
        if plan is not None and plan.default.duplicate > 0.0:
            du = np.random.default_rng([seed, _STREAM_DUP]).random((n, M))
            # the receiver's version vector drops every replay: counted only
            out["_dup_edge"] = int((ok & ~isreg & (du[ii, mm] < plan.default.duplicate)).sum())
        return out

    # ---- chunk layout (host) ----

    def _chunk_layout(self, client: np.ndarray, C: int) -> np.ndarray:
        """``[S, C]`` row indices into the sorted event columns (−1 = pad).
        A straight reshape when no client repeats inside an aligned group
        (the fleet-scale case), else greedy chunks closed at the first
        repeated client: pass A scatters each client at most once a chunk."""
        E = int(client.shape[0])
        S = -(-E // C)
        rows = np.full(S * C, -1, np.int64)
        rows[:E] = np.arange(E)
        gid = np.arange(S * C) // C
        cl = np.where(rows >= 0, client[np.clip(rows, 0, None)], -1)
        o = np.lexsort((cl, gid))
        gs, cs = gid[o], cl[o]
        if not ((gs[1:] == gs[:-1]) & (cs[1:] == cs[:-1]) & (cs[1:] >= 0)).any():
            return rows.reshape(S, C)
        out: List[int] = []
        cur: List[int] = []
        seen: set = set()
        for j in range(E):
            cj = int(client[j])
            if cj in seen or len(cur) == C:
                out.extend(cur + [-1] * (C - len(cur)))
                cur, seen = [], set()
            cur.append(j)
            seen.add(cj)
        if cur:
            out.extend(cur + [-1] * (C - len(cur)))
        return np.asarray(out, np.int64).reshape(-1, C)

    def _shard_layout(self, client: np.ndarray, C: int, P: int, cp: int,
                      ncap: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The sharded engine's chunk layout: :meth:`_chunk_layout`'s chunks,
        each also split into per-shard segments of ``cp`` lanes (shard = the
        owner ``client // ncap``, lanes in chronological order). Returns
        ``(rows [S, C], seg_ev [S, P·cp], invperm [S, C])``: ``rows`` the
        chronological grid the replicated passes read (−1 = pad), ``seg_ev``
        each segment lane's event (−1 = dead lane), ``invperm`` each
        chronological position's segment slot, which puts the gathered
        segments back in order. The aligned reshape when no client repeats
        in a group and every (group, shard) count fits ``cp`` (the slack
        sizes ``cp`` so this is the fleet-scale case), else greedy chunks
        closed at a repeat or a full segment."""
        E = int(client.shape[0])
        S = -(-E // C) if E else 0
        sh = client.astype(np.int64) // ncap
        rows = np.full(S * C, -1, np.int64)
        rows[:E] = np.arange(E)
        gid_full = np.arange(S * C) // C
        cl = np.where(rows >= 0, client[np.clip(rows, 0, None)], -1)
        o = np.lexsort((cl, gid_full))
        gs, cs = gid_full[o], cl[o]
        collide = (gs[1:] == gs[:-1]) & (cs[1:] == cs[:-1]) & (cs[1:] >= 0)
        gid = np.arange(E) // C
        key = gid * P + sh
        counts = np.bincount(key, minlength=S * P)
        if not collide.any() and (counts <= cp).all():
            order = np.lexsort((np.arange(E), sh, gid))
            sk = key[order]
            starts = np.r_[0, 1 + np.flatnonzero(np.diff(sk))]
            lens = np.diff(np.r_[starts, E])
            within = np.arange(E) - np.repeat(starts, lens)
            seg_slot = np.empty(E, np.int64)
            seg_slot[order] = sh[order] * cp + within
            seg_ev = np.full((S, P * cp), -1, np.int64)
            seg_ev[gid, seg_slot] = np.arange(E)
            invperm = np.zeros((S, C), np.int32)
            invperm[gid, np.arange(E) - gid * C] = seg_slot
            return rows.reshape(S, C), seg_ev, invperm
        row_chunks: List[List[int]] = []
        seg_chunks: List[np.ndarray] = []
        inv_chunks: List[np.ndarray] = []
        cur: List[int] = []
        slots: List[int] = []
        seen: set = set()
        cnt = np.zeros(P, np.int64)

        def close() -> None:
            row_chunks.append(cur + [-1] * (C - len(cur)))
            seg_row = np.full(P * cp, -1, np.int64)
            seg_row[np.asarray(slots, np.int64)] = np.asarray(cur, np.int64)
            inv_row = np.zeros(C, np.int32)
            inv_row[: len(slots)] = np.asarray(slots, np.int32)
            seg_chunks.append(seg_row)
            inv_chunks.append(inv_row)

        for j in range(E):
            cj, sj = int(client[j]), int(sh[j])
            if cj in seen or len(cur) == C or cnt[sj] == cp:
                close()
                cur, slots, seen = [], [], set()
                cnt[:] = 0
            cur.append(j)
            slots.append(sj * cp + int(cnt[sj]))
            seen.add(cj)
            cnt[sj] += 1
        if cur:
            close()
        return np.asarray(row_chunks, np.int64).reshape(-1, C), np.stack(seg_chunks), np.stack(inv_chunks)

    def _task_arrays(self):
        if self._task_cache is None:
            self._task_cache = self.task.arrays(self.n)
        return self._task_cache

    def _grad_losses(self, G: np.ndarray) -> np.ndarray:
        """The eval set's cross-entropy at each global version."""
        from p2pfl_tpu_torch.ops.fleet_kernels import grad_logits

        t = self.task
        _, _, _, xe, ye = self._task_arrays()
        lg = grad_logits(t.kind, t.d_in, t.n_out, t.hidden, torch.from_numpy(G),
                         torch.from_numpy(xe))
        ce = torch.nn.functional.cross_entropy(
            lg.reshape(-1, t.n_out), torch.from_numpy(ye).long().repeat(G.shape[0]), reduction="none")
        return ce.reshape(G.shape[0], -1).mean(1).double().numpy()

    def _chunk_grids(self, cfg, tiers, ev, clients, agg, rows):
        """The ``[S, C]`` chronological event grids and the per-regional
        grids of a chunk layout. Pads carry values every gate masks: client
        ``N``, ``PAD_KEY`` keys, ``live`` False."""
        from p2pfl_tpu_torch.ops.fleet_kernels import PAD_KEY

        live = rows >= 0

        def col(vals, pad, dtype):
            grid = np.full(rows.shape, pad, dtype)
            grid[live] = np.asarray(vals)[rows[live]].astype(dtype)
            return grid

        events = {
            "client": col(ev["client"], self.n, np.int64),
            "key_hi": col(ev["key_hi"], PAD_KEY, np.int32),
            "key_lo": col(ev["key_lo"], PAD_KEY, np.int32),
            "t_adopt": col(ev["t_adopt"], -np.inf, np.float32),
            "t_arr": col(ev["t_arr"], 0.0, np.float32),
            "send_ok": col(ev["send_ok"], False, bool),
            "live": live,
        }
        R = cfg.n_regionals
        if cfg.hier:
            r_e = tiers["regional_of"][ev["client"]]
            k_e = tiers["k_reg"][ev["ep"], r_e]
            t_rad = ev["t_arr"] - tiers["reg_adopt"][ev["ep"], r_e].astype(np.float32)
            events["r"] = col(r_e, R, np.int32)
            events["k_r"] = col(k_e, 1, np.int32)
            events["t_radopt"] = col(t_rad, -np.inf, np.float32)
        if cfg.byz:
            events["bkind"] = col(ev["bkind"], 0, np.int32)
            events["blam"] = col(ev["blam"], 1.0, np.float32)
            att = ev["bkind"] == 3
            if att.any():
                nz = int(att.sum())
                noise = np.zeros((nz + 1, cfg.dim), np.float32)
                noise[1:] = (np.random.default_rng([self.seed, _STREAM_BYZ]).normal(size=(nz, cfg.dim))
                             .astype(np.float32) * ev["bstd"][att][:, None])
                bn = np.zeros(ev["bkind"].shape[0], np.int64)
                bn[att] = 1 + np.arange(nz)
                events["bnoise"] = col(bn, 0, np.int32)
                clients["noise"] = noise
        reg = {}
        if cfg.hier:
            reg = {"send_ok": agg["ok"], "jit": agg["jit"], "agg_delay": tiers["agg_delay"].astype(np.float32)}
            if cfg.dup:
                reg["dup"] = agg["dup"]
            if cfg.byz:
                reg.update({k: agg[k] for k in ("akind", "alam", "agg_noise_idx", "agg_noise")})
        return events, reg

    def _run_chunked(self, cfg, tiers, ev, clients, agg, init):
        from p2pfl_tpu_torch.ops.fleet_kernels import ChunkedFleet

        rows = self._chunk_layout(ev["client"], cfg.chunk)
        events, reg = self._chunk_grids(cfg, tiers, ev, clients, agg, rows)
        return ChunkedFleet(cfg, events, clients, reg, init, self.device).run()

    def _sharded_grids(self, cfg, tiers, ev, clients, agg):
        """:meth:`_chunk_grids` of the segment layout (:meth:`_shard_layout`)
        plus the shards' grids ``[S, P·cp]``: ``seg_fwd`` (each segment
        lane's chronological position, with which a shard reads the
        replicated grids), ``seg_loc`` (its client's row in the owner's
        block; dead lanes the trash row ``ncap``), ``seg_live``, and
        ``invperm [S, C]``."""
        from p2pfl_tpu_torch.parallel.fleet_mesh import shard_capacity

        P = self.shards
        ncap = shard_capacity(self.n, P)
        cp = max(1, int(np.ceil(self.shard_slack * cfg.chunk / P)))
        rows, seg_ev, invperm = self._shard_layout(ev["client"], cfg.chunk, P, cp, ncap)
        events, reg = self._chunk_grids(cfg, tiers, ev, clients, agg, rows)
        pos = np.zeros(int(ev["client"].shape[0]), np.int64)
        sidx, cidx = np.nonzero(rows >= 0)
        pos[rows[sidx, cidx]] = cidx
        seg_live = seg_ev >= 0
        safe = np.clip(seg_ev, 0, None)
        events["seg_fwd"] = np.where(seg_live, pos[safe], 0).astype(np.int32)
        events["seg_loc"] = np.where(seg_live, ev["client"][safe] % ncap, ncap).astype(np.int32)
        events["seg_live"] = seg_live
        events["invperm"] = invperm
        return events, reg

    def _run_sharded(self, cfg, tiers, ev, clients, agg, init):
        from p2pfl_tpu_torch.ops.fleet_kernels import ShardedFleet

        events, reg = self._sharded_grids(cfg, tiers, ev, clients, agg)
        return ShardedFleet(cfg, events, clients, reg, init, self.mesh).run()

    def _autotune_chunk(self, make_cfg, tiers, ev, clients, agg, init) -> int:
        """Resolve ``chunk="auto"``: time the engine that will run (the
        sharded one for ``shards > 1``) over a bounded event prefix for each
        candidate, once a (device kind, shard count, workload) key, then
        replay from the cache."""
        from p2pfl_tpu_torch.ops import fleet_autotune as ft

        kind = ft.device_kind(self.device)
        n_sh = self.shards if self.shards > 1 else 1
        extra = (f"task={self.task.kind if self.task else 'consensus'}|dim={self.dim}|hier={int(self.hier)}"
                 f"|k={self.k}|n~1e{len(str(max(1, self.n))) - 1}")
        got = ft.get_fleet_chunk(n_shards=n_sh, extra=extra, kind=kind)
        if got is not None:
            return got
        cands = ft.DEFAULT_CANDIDATES
        budget = max(min(int(ev["client"].shape[0]), 8 * max(cands)), 1)
        ev_cut = {k: (v[:budget] if isinstance(v, np.ndarray) else v) for k, v in ev.items()}
        runner = self._run_sharded if n_sh > 1 else self._run_chunked
        devices = set(self.mesh.devices.flat) if n_sh > 1 else {self.device}

        def sync() -> None:
            for d in devices:
                if d.type == "cuda":
                    torch.cuda.synchronize(d)

        def measure(c: int) -> float:
            runner(make_cfg(c), tiers, ev_cut, dict(clients), agg, init)  # warm-up
            sync()
            t0 = time.perf_counter()
            runner(make_cfg(c), tiers, ev_cut, dict(clients), agg, init)
            sync()
            return time.perf_counter() - t0

        return ft.autotune_fleet_chunk(measure, cands, n_shards=n_sh, extra=extra, kind=kind)

    # ---- the drive ----

    def _prepare(self) -> Dict[str, Any]:
        """The host side of a run: tiers, sorted events, capacity bounds,
        the per-client and per-regional arrays and the config maker."""
        from p2pfl_tpu_torch.ops import fleet_kernels as fk

        tiers = self._tier_arrays()
        ev = self._events(tiers)
        counts = {k: ev.pop(k, 0) for k in ("_unselected", "_wire_dropped", "_lost", "_dup_edge", "_byz_edge")}
        E = int(ev["client"].shape[0])
        plan, task = self.plan, self.task
        # capacity bounds (exact: every flush takes K distinct accepted
        # events or aggregates; churn shrinks K, never grows it)
        R = int(tiers["k_reg"].shape[1])
        k_glob = tiers["k_global"]
        if self.hier:
            k_min = np.maximum(tiers["k_reg"].min(axis=0), 1)
            per_reg = np.bincount(tiers["regional_of"][ev["client"]], minlength=R) // k_min
            v_cap = (int(per_reg.sum()) + 1) // k_glob + 2
            stride = int(per_reg.max(initial=0)) + 2
        else:
            v_cap = E // k_glob + 2
            stride = 2
        use_chunked = (self.chunk > 1 or self._chunk_auto or self.shards > 1 or task is not None
                       or self.fold != "fedavg"
                       or self._byz is not None or self._churn is not None
                       or (self.hier and plan is not None and plan.default.duplicate > 0.0))

        def make_cfg(C):
            return fk.FleetConfig(
                hier=self.hier, n_clients=self.n, dim=self.dim, n_regionals=R, k_global=k_glob,
                k_reg_max=int(tiers["k_reg"].max(initial=1)) if self.hier else 1, v_cap=max(v_cap, 2),
                alpha=self.alpha, server_lr=self.server_lr, local_lr=self.local_lr,
                max_staleness=self.max_staleness, rate_gap_reg=self.rate_limit_regional,
                rate_gap_glob=self.rate_limit_global, hist_bins=self.max_staleness + 2, agg_key_stride=stride,
                chunk=C, gf_cap=(C // k_glob + 2) if use_chunked else 0,
                fold_kind=self.fold, trim=self.trim, task=(task.kind if task is not None else "consensus"),
                t_din=(task.d_in if task is not None else 0), t_nout=(task.n_out if task is not None else 0),
                t_hidden=(task.hidden if task is not None else 0), t_bs=(task.batch if task is not None else 0),
                t_steps=(task.steps if task is not None else 0),
                data_seed=(task.data_seed if task is not None else 0),
                byz=bool("bkind" in ev and use_chunked),
                dup=bool(self.hier and plan is not None and plan.default.duplicate > 0.0 and use_chunked))

        clients = {"targets": np.asarray(self.spec.targets, np.float32),
                   "samples": np.asarray(self.spec.num_samples, np.float32)}
        if task is not None:
            mu, tw, tb, _, _ = self._task_arrays()
            clients.update({"mu": mu, "tw": tw, "tb": tb})
        return {"tiers": tiers, "ev": ev, "counts": counts, "use_chunked": use_chunked, "make_cfg": make_cfg,
                "clients": clients, "agg": self._agg_grids(tiers, stride),
                "init": np.asarray(self.spec.init, np.float32)}

    def chunked_engine(self, device=None, chunk: Optional[int] = None):
        """The chunked engine of this fleet, built and not run (on
        ``device``, this fleet's by default; ``chunk`` events a step, this
        fleet's by default): :meth:`run`'s engine, for callers that step it
        or hold it against another device's."""
        from p2pfl_tpu_torch.ops.fleet_kernels import ChunkedFleet

        p = self._prepare()
        cfg = p["make_cfg"](chunk or self.chunk)
        rows = self._chunk_layout(p["ev"]["client"], cfg.chunk)
        events, reg = self._chunk_grids(cfg, p["tiers"], p["ev"], p["clients"], p["agg"], rows)
        return ChunkedFleet(cfg, events, p["clients"], reg, p["init"], self.device if device is None else device)

    def sharded_engine(self, chunk: Optional[int] = None):
        """The sharded engine of this fleet on its mesh (``shards > 1``),
        built and not run: :meth:`run`'s engine, for callers that step it or
        time its stages."""
        from p2pfl_tpu_torch.ops.fleet_kernels import ShardedFleet

        if self.mesh is None:
            raise ValueError("sharded_engine needs shards > 1 or a mesh of several slots")
        p = self._prepare()
        cfg = p["make_cfg"](chunk or self.chunk)
        events, reg = self._sharded_grids(cfg, p["tiers"], p["ev"], p["clients"], p["agg"])
        return ShardedFleet(cfg, events, p["clients"], reg, p["init"], self.mesh)

    def run(self) -> MegaFleetResult:
        from p2pfl_tpu_torch.ops import fleet_kernels as fk

        t0 = time.monotonic()
        p = self._prepare()
        tiers, ev, clients, agg, init, make_cfg = (p[k] for k in ("tiers", "ev", "clients", "agg", "init",
                                                                   "make_cfg"))
        E = int(ev["client"].shape[0])
        plan, task = self.plan, self.task
        if self._chunk_auto and p["use_chunked"]:
            self.chunk = self._autotune_chunk(make_cfg, tiers, ev, clients, agg, init)
        cfg = make_cfg(self.chunk if p["use_chunked"] else 1)
        if self.shards > 1:
            out = self._run_sharded(cfg, tiers, ev, clients, agg, init)
        elif p["use_chunked"]:
            out = self._run_chunked(cfg, tiers, ev, clients, agg, init)
        else:
            clients["adopt_delay"] = tiers["adopt_delay"][0].astype(np.float32)
            clients["regional_of"] = tiers["regional_of"]
            reg = {"k": tiers["k_reg"][0], "adopt_delay": tiers["reg_adopt"][0].astype(np.float32),
                   "agg_delay": tiers["agg_delay"].astype(np.float32), "send_ok": agg["ok"], "jit": agg["jit"]}
            out = fk.run_fleet_program(cfg, ev, clients, reg, init, self.device)
        unselected, dropped_wire, lost, dup_edge, byz_edge = p["counts"].values()

        version = int(out["version"])
        G = out["G"][: version + 1].cpu().numpy()
        mint = out["mint"][:version].cpu().numpy().astype(np.float64)
        if task is not None:
            losses = self._grad_losses(G)
        else:
            diffs = G - self.spec.target_mean()[None, :]
            losses = (diffs * diffs).sum(axis=1).astype(np.float64)
        curve = [(float(mint[v - 1]), v, float(losses[v])) for v in range(1, version + 1)]
        ttt = next((t for t, _v, loss in curve if loss <= self.target_loss), None)
        wall = time.monotonic() - t0
        res = MegaFleetResult(
            params={"w": out["G"][version].clone()},
            version=version,
            virtual_time=float(ev["t_arr"][-1]) if E else 0.0,
            time_to_target=ttt,
            loss_curve=curve,
            updates_sent=E,
            updates_delivered=E - dropped_wire - lost,
            # the heap's counter includes dropped regional → root aggregates
            updates_dropped_wire=dropped_wire + out["agg_drop"],
            duplicates_injected=dup_edge + out.get("dup_agg", 0),
            byz_corrupted=byz_edge + out.get("byz_agg", 0),
            merges=out["merges"],
            regional_merges=out["rmerges"],
            buffered=int(out["hist_edge"].sum()),
            stale_dropped=out["stale_edge"] + out["stale_agg"],
            rate_limited=out["rate_edge"] + out["rate_agg"],
            unselected=unselected,
            staleness_hist_edge=[int(x) for x in out["hist_edge"]],
            staleness_hist_global=[int(x) for x in out["hist_glob"]],
            n_events=E,
            wall_s=wall,
            clients_per_sec=self.n / wall if wall > 0 else 0.0,
        )
        if self._churn is not None:
            res.joined = list(self._churn["joined"])
            res.left = list(self._churn["left"])
            res.failovers = int(self._churn["failovers"])
        if plan is not None:
            # only crashes that fire are recorded (heap parity)
            res.crashed = [a for a, s in plan.crashes.items()
                           if a in self._addr_idx and s.stage == "AsyncTrainStage"
                           and (s.round_no or 0) < self.updates_per_node]
        return res
