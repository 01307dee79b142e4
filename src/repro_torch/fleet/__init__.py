"""Fleet control plane: multi-instance serving for ReviveMoE, on the
port's engines (``repro.fleet``, copied with its imports renamed; only
``builder`` differs: it passes ``device`` and ``dtype`` to every engine).

The paper's headline claim — in-place revive beats drain-and-restart
*because a restart stalls the whole instance* — is a fleet-level claim:
it only shows up when N instances serve open-loop traffic and one of
them gets hurt.  This package is that layer:

* :class:`FleetInstance` / :class:`FleetRouter` — N ``InferenceEngine``
  instances behind a cluster router with continuous admission,
  per-instance load tracking and Poisson/trace-driven open-loop traffic.
* :class:`SparePool` — pre-warmed standbys (weights loaded, graphs
  compiled) that can substitute for a failed instance.
* cross-instance live request migration — in-flight requests on a dying
  instance re-admit elsewhere with prompt + generated-prefix re-prefill;
  position-seeded sampling keeps the replayed tokens identical.
* :class:`RecoveryArbiter` — per fault, chooses ReviveMoE in-place
  recovery vs drain-and-restart vs spare substitution from an explicit
  cost model fed by measured ``RecoveryReport`` / init timings.
"""
from repro_torch.fleet.arbiter import ArbiterDecision, CostModel, RecoveryArbiter
from repro_torch.fleet.builder import build_fleet, build_multi_model_fleet
from repro_torch.fleet.chaos import (CampaignEvent, CampaignResult,
                                     CampaignRunner, CampaignSchedule,
                                     VirtualCostProfile, fleet_topology,
                                     slo_burn)
from repro_torch.fleet.instance import FleetInstance, InstanceState
from repro_torch.fleet.router import FleetHealth, FleetRouter
from repro_torch.fleet.spares import SparePool
from repro_torch.fleet.traffic import (Arrival, DiurnalTraffic, MixedTraffic,
                                       PoissonTraffic, TraceTraffic)

__all__ = [
    "ArbiterDecision", "CostModel", "RecoveryArbiter", "build_fleet",
    "build_multi_model_fleet", "CampaignEvent", "CampaignResult",
    "CampaignRunner", "CampaignSchedule", "VirtualCostProfile",
    "fleet_topology", "slo_burn", "FleetInstance", "InstanceState",
    "FleetHealth", "FleetRouter", "SparePool", "Arrival",
    "DiurnalTraffic", "MixedTraffic", "PoissonTraffic", "TraceTraffic",
]
