"""Convenience construction of a homogeneous fleet of the port's engines.

All instances (spares included) share one workdir: the first build
writes ``weights.npz`` and every later build restores it, so the fleet
is *weight-identical* — the precondition for exact cross-instance token
replay — and they share the graph cache's directory, so a spare's and a
restart's graph lookups are ``cached``.  Every engine (spares and
rebuilds included) gets the same ``device`` and ``dtype``: the card and
bf16 unless the caller asks for the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.fleet.arbiter import CostModel, RecoveryArbiter
from repro_torch.fleet.instance import FleetInstance, InstanceState
from repro_torch.fleet.router import FleetRouter
from repro_torch.fleet.spares import SparePool
from repro_torch.serving.engine import EngineConfig, InferenceEngine


def build_fleet(cfg: ModelConfig, ecfg: EngineConfig, *,
                instances: int = 2, spares: int = 0,
                force_policy: Optional[str] = None,
                soft_patience: int = 1,
                traffic=None, replenish_spares: bool = False,
                kv_stream: bool = True,
                prefix_affinity: bool = False,
                cost_profile=None,
                max_backlog: int = 256,
                device=None,
                dtype: Optional[torch.dtype] = None) -> FleetRouter:
    """``replenish_spares`` turns on background standby repair (one
    rebuild per router tick after an activation); ``kv_stream=False``
    forces token-replay re-prefill on every migration (the verified
    fallback path); ``prefix_affinity`` biases admission so shared
    prompt prefixes land on the instance whose block cache holds them.
    A ``cost_profile`` (:class:`~repro_torch.fleet.chaos.VirtualCostProfile`)
    switches clock and cost model to pinned virtual costs — the chaos-
    campaign determinism mode.  ``device`` and ``dtype`` go to every
    engine (``InferenceEngine``'s)."""
    if instances < 1:
        raise ValueError(f"instances must be >= 1, got {instances!r}")
    if spares < 0:
        raise ValueError(f"spares must be >= 0, got {spares!r}")

    def _engine() -> InferenceEngine:
        # each engine gets its own config object (engines mutate theirs)
        return InferenceEngine(cfg, dataclasses.replace(ecfg),
                               device=device, dtype=dtype)

    members = [FleetInstance(i, _engine()) for i in range(instances)]
    pool = SparePool(
        lambda iid: FleetInstance(iid, _engine(), InstanceState.SPARE),
        size=spares, auto_replenish=replenish_spares) if spares else None
    cost = (cost_profile.cost_model() if cost_profile is not None
            else CostModel(members[0].engine.init_timings))
    arbiter = RecoveryArbiter(cost, force_policy=force_policy,
                              soft_patience=soft_patience)
    return FleetRouter(members, spares=pool, arbiter=arbiter,
                       traffic=traffic, kv_stream=kv_stream,
                       prefix_affinity=prefix_affinity,
                       cost_profile=cost_profile,
                       max_backlog=max_backlog)


def build_multi_model_fleet(
        models: Dict[str, Tuple[ModelConfig, EngineConfig]], *,
        counts: Dict[str, int],
        spares: Optional[Dict[str, int]] = None,
        force_policy: Optional[str] = None,
        soft_patience: int = 1,
        traffic=None, kv_stream: bool = True,
        cost_profile=None, max_backlog: int = 256,
        rebalance: bool = True, device=None,
        dtype: Optional[torch.dtype] = None) -> FleetRouter:
    """A fleet serving several model configs behind one router.

    ``models`` maps model_id -> (ModelConfig, EngineConfig); each model
    needs its own workdir (weights differ).  ``counts`` says how many
    serving instances each model gets; ``spares`` how many standbys per
    model (pooled — acquisition is model-matched).  With ``rebalance``,
    the router gets a rebuilder per model, so a model that loses its
    last instance can evict-and-rebalance an over-provisioned peer.
    ``device`` and ``dtype`` go to every engine."""
    if not models:
        raise ValueError("build_multi_model_fleet needs >= 1 model")

    def _engine(model_id: str) -> InferenceEngine:
        cfg, ecfg = models[model_id]
        return InferenceEngine(cfg, dataclasses.replace(ecfg),
                               device=device, dtype=dtype)

    def _make(iid: int, model_id: str,
              state: InstanceState = InstanceState.SERVING
              ) -> FleetInstance:
        return FleetInstance(iid, _engine(model_id), state,
                             model_id=model_id)

    members, iid = [], 0
    for model_id in sorted(counts):
        for _ in range(counts[model_id]):
            members.append(_make(iid, model_id))
            iid += 1
    if not members:
        raise ValueError("counts produced an empty fleet")

    pool = None
    spare_specs = [m for m in sorted(spares or {})
                   for _ in range(((spares or {})[m]))]
    if spare_specs:
        cursor = {"i": 0}

        def _spare_factory(sid: int) -> FleetInstance:
            model_id = spare_specs[cursor["i"] % len(spare_specs)]
            cursor["i"] += 1
            return _make(sid, model_id, InstanceState.SPARE)

        pool = SparePool(_spare_factory, size=len(spare_specs))

    cost = (cost_profile.cost_model() if cost_profile is not None
            else CostModel(members[0].engine.init_timings))
    arbiter = RecoveryArbiter(cost, force_policy=force_policy,
                              soft_patience=soft_patience)
    rebuilders = ({m: (lambda i, m=m: _make(i, m)) for m in models}
                  if rebalance else None)
    return FleetRouter(members, spares=pool, arbiter=arbiter,
                       traffic=traffic, kv_stream=kv_stream,
                       cost_profile=cost_profile,
                       rebuilders=rebuilders, max_backlog=max_backlog)
