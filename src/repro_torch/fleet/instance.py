"""One fleet member: an ``InferenceEngine`` plus control-plane lifecycle.

The wrapper owns what the engine cannot know about itself: its identity
in the fleet, whether the router may send it traffic, and the hook that
lets the :class:`~repro_torch.fleet.arbiter.RecoveryArbiter` take a fault away
from the engine's in-place revive pipeline.

On a *full-instance loss* (host gone, every device inaccessible) the
engine cannot run at all — but request state survives: the router is the
gateway, and a gateway already holds every prompt plus the tokens it
streamed back.  Re-admitting those requests elsewhere with prompt +
generated-prefix re-prefill is therefore always possible; the in-process
``Request`` objects double as that gateway record.
"""
from __future__ import annotations

import enum
import time
from typing import Callable, List, Optional

from repro_torch.serving.engine import InferenceEngine, InstanceHealth
from repro_torch.serving.request import Request


class InstanceState(enum.Enum):
    SPARE = "spare"          # pre-warmed, not taking traffic
    SERVING = "serving"
    DRAINING = "draining"    # finishing residents, no new admissions
    RESTARTING = "restarting"
    DEAD = "dead"


class FleetInstance:
    def __init__(self, iid: int, engine: InferenceEngine,
                 state: InstanceState = InstanceState.SERVING,
                 model_id: str = "default"):
        self.iid = iid
        self.engine = engine
        self.state = state
        # multi-model fleets: which model config this instance serves;
        # the router only routes/migrates matching requests here
        self.model_id = model_id
        self.restarts = 0
        self.decommission_reason: Optional[str] = None

    def __repr__(self):
        return (f"FleetInstance(iid={self.iid}, {self.state.value}, "
                f"model={self.model_id}, "
                f"load={self.load if self.state != InstanceState.DEAD else '-'})")

    def serves(self, model_id: Optional[str]) -> bool:
        """Can this instance serve a request tagged ``model_id``?
        (None = untagged request, any instance will do.)"""
        return model_id is None or self.model_id == model_id

    # -- routing surface --------------------------------------------------------

    @property
    def accepting(self) -> bool:
        return self.state is InstanceState.SERVING

    @property
    def load(self) -> int:
        return self.engine.unfinished

    def health(self) -> InstanceHealth:
        return self.engine.health()

    def submit(self, prompt_tokens, max_new_tokens: int = 16,
               eos_token=None) -> Request:
        req = self.engine.submit(list(prompt_tokens), max_new_tokens,
                                 eos_token=eos_token)
        req.instance_id = self.iid
        return req

    def admit(self, req: Request, kv=None) -> Request:
        """Cross-instance admission of a migrated request; a KVBlocks
        payload streams the live prefix in (no re-prefill on arrival)."""
        if req.instance_id is not None and req.instance_id != self.iid:
            req.cross_instance_migrations += 1
        req.instance_id = self.iid
        return self.engine.admit(req, kv=kv)

    # -- arbitration hook --------------------------------------------------------

    def set_arbitration(self, decide: Callable) -> None:
        """``decide(instance, event) -> 'revive' | 'restart' | 'spare'``.
        Anything but 'revive' defers the fault to the fleet tick."""
        self.engine.fault_interceptor = lambda ev: decide(self, ev)

    # -- lifecycle ---------------------------------------------------------------

    def step(self) -> List[Request]:
        if self.state in (InstanceState.DEAD, InstanceState.SPARE,
                          InstanceState.RESTARTING):
            return []
        return self.engine.step()

    def export_requests(self, with_kv: bool = False):
        """Drain every unfinished request; ``with_kv`` returns
        ``[(req, KVBlocks|None)]`` with live blocks extracted from every
        still-reachable executor (streamed takeover)."""
        return self.engine.export_live_requests(with_kv=with_kv)

    def restart(self) -> float:
        """Drain-and-restart baseline: the whole instance relaunches
        (engine + executors + weights + groups + cached compile).  The
        instance serves nothing while this runs — that stall is the cost
        the arbiter weighs against revive/spare."""
        self.state = InstanceState.RESTARTING
        t0 = time.perf_counter()
        self.engine.full_reinit()
        dt = time.perf_counter() - t0
        self.restarts += 1
        self.state = InstanceState.SERVING
        return dt

    def fail_instance(self, reason: str = "host loss") -> None:
        """Full-instance loss: every device goes at once (host/kernel/
        fabric failure).  The engine is unusable until restarted; the
        router must re-home its requests."""
        for ex in self.engine.dp_executors:
            ex.fail_device()
            ex.terminate_process()
        for mex in self.engine.moe_executors:
            mex.fail_device()
        self.state = InstanceState.DEAD
        self.decommission_reason = reason

    def decommission(self, reason: str) -> None:
        self.state = InstanceState.DEAD
        self.decommission_reason = reason
