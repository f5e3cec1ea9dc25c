"""Async bounded-staleness federation (counterpart of ``p2pfl_tpu/federation``).

The control plane that advances at the speed of the median peer instead
of the slowest (the sync round FSM is ``stages/learning_stages.py``):

- :mod:`~p2pfl_tpu_torch.federation.staleness` — the staleness weight
  ``w(τ) = 1/(1+τ)^α`` and per-node version vectors;
- :mod:`~p2pfl_tpu_torch.federation.buffer` — the FedBuff-style
  :class:`BufferedAggregator` (merge once K are buffered), whose fold runs
  on the device of the tier's params;
- :mod:`~p2pfl_tpu_torch.federation.topology` — :class:`HierarchicalTopology`
  (HierFAVG edge clusters → regional aggregators → a global tier);
- :mod:`~p2pfl_tpu_torch.federation.routing` — the node-free
  :class:`TierRouter` both engines consume (roles, buffer placement,
  update sinks, successor election);
- :mod:`~p2pfl_tpu_torch.federation.workflow` — the async learning workflow
  Nodes run under ``Settings.FEDERATION_MODE == "async"``;
- :mod:`~p2pfl_tpu_torch.federation.simfleet` — the deterministic
  event-driven fleet simulator (1k–10k virtual nodes, virtual clock);
- :mod:`~p2pfl_tpu_torch.federation.defense` — the Byzantine admission
  screen, suspicion EWMA and quarantine;
- :mod:`~p2pfl_tpu_torch.federation.durability` — the crash-consistent
  :class:`NodeJournal` behind ``Node.enable_journal`` / ``Node.resume``;
- :mod:`~p2pfl_tpu_torch.federation.megafleet` — the vectorized fleet
  (:class:`MegaFleet` over a :class:`FleetSpec`, up to millions of
  clients; its chunk step is the ``fleet_chunk`` CUDA kernel on the card).
"""

from p2pfl_tpu_torch.federation.buffer import BufferedAggregator
from p2pfl_tpu_torch.federation.defense import ByzantineDefense
from p2pfl_tpu_torch.federation.durability import JournalSnapshot, NodeJournal, SeqCounter
from p2pfl_tpu_torch.federation.megafleet import FleetSpec, GradTask, MegaFleet, MegaFleetResult
from p2pfl_tpu_torch.federation.routing import BufferPlan, TierRouter, VersionHighWater
from p2pfl_tpu_torch.federation.simfleet import FleetResult, SimulatedAsyncFleet
from p2pfl_tpu_torch.federation.staleness import UpdateVersion, VersionVector, staleness_weight
from p2pfl_tpu_torch.federation.topology import HierarchicalTopology
from p2pfl_tpu_torch.federation.workflow import AsyncLearningWorkflow

__all__ = [
    "AsyncLearningWorkflow",
    "BufferPlan",
    "BufferedAggregator",
    "ByzantineDefense",
    "FleetResult",
    "FleetSpec",
    "GradTask",
    "HierarchicalTopology",
    "JournalSnapshot",
    "MegaFleet",
    "MegaFleetResult",
    "NodeJournal",
    "SeqCounter",
    "SimulatedAsyncFleet",
    "TierRouter",
    "UpdateVersion",
    "VersionHighWater",
    "VersionVector",
    "staleness_weight",
]
