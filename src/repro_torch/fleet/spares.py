"""Pre-warmed hot spares (FailSafe-style standby substitution).

A spare is a fully built ``InferenceEngine``: weights loaded from the
shared fleet checkpoint, serving graphs compiled (and failure-scenario
graphs precompiled) via the shared on-disk ``GraphCache``.  Activation
is therefore a control-plane action — flip state, re-home requests — not
an init: the multi-second build cost was paid at provisioning time.
"""
from __future__ import annotations

import time
from typing import Callable, List, Optional

from repro_torch.fleet.instance import FleetInstance, InstanceState


class SparePool:
    def __init__(self, factory: Callable[[int], FleetInstance],
                 size: int, first_iid: int = 1000,
                 auto_replenish: bool = False):
        """factory(iid) must return a built, SPARE-state FleetInstance.

        ``first_iid`` namespaces spare ids away from the serving set.
        ``auto_replenish``: after an activation, rebuild a standby in the
        background (one per router tick) instead of letting the pool
        shrink — the fleet's steady-state spare capacity self-heals.
        """
        self._factory = factory
        self._next_iid = first_iid
        self.target_size = size
        self.auto_replenish = auto_replenish
        self.warm: List[FleetInstance] = []
        self.activations = 0
        self.replenishments = 0
        self.warmup_s: List[float] = []
        for _ in range(size):
            self._provision()

    def _provision(self) -> FleetInstance:
        t0 = time.perf_counter()
        inst = self._factory(self._next_iid)
        self.warmup_s.append(time.perf_counter() - t0)
        inst.state = InstanceState.SPARE
        self._next_iid += 1
        self.warm.append(inst)
        return inst

    @property
    def available(self) -> int:
        return len(self.warm)

    def available_for(self, model_id: Optional[str] = None) -> int:
        """Warm standbys able to serve ``model_id`` (None = any)."""
        return sum(1 for inst in self.warm if inst.serves(model_id))

    def acquire(self, model_id: Optional[str] = None
                ) -> Optional[FleetInstance]:
        """Hand a warm standby to the router (None if the pool is dry).
        With ``model_id``, only a matching spare qualifies — a standby
        built for another model config is useless for this fault."""
        for i, inst in enumerate(self.warm):
            if inst.serves(model_id):
                inst = self.warm.pop(i)
                inst.state = InstanceState.SERVING
                self.activations += 1
                return inst
        return None

    @property
    def deficit(self) -> int:
        return max(0, self.target_size - self.available)

    def maybe_replenish(self) -> Optional[FleetInstance]:
        """Background capacity repair, called once per router tick:
        rebuild at most one standby when the pool is below target.  The
        build runs on a new host, off the serving path, so it costs no
        virtual fleet time."""
        if not self.auto_replenish or not self.deficit:
            return None
        inst = self._provision()
        self.replenishments += 1
        return inst

    def replenish(self) -> FleetInstance:
        """Provision a fresh standby immediately (manual capacity repair)."""
        return self._provision()
