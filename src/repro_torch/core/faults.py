"""Deterministic fault injection.

The injector plays the role of the physical failure: it schedules faults
at (engine step, device) granularity.  ``mid_step`` faults fire *inside*
an executor's generation step — after block-table mutations have been
logged but before the step commits — exercising the §3.3 undo path.
Fired faults surface as node annotations (the Kubernetes device-plugin
analogue) that the detection layer polls.

Campaign extensions: faults are *clearable* (a transient link flap ends
with :meth:`clear`, after which the same rank may fault again) and the
injector de-duplicates annotations — while a rank is down, further
scheduled faults on it are swallowed instead of re-annotating, so one
injector can drive recurring fault processes without double-reporting.
:meth:`reset` returns the injector to its initial state so it can be
reused across campaign episodes without leaking schedules, annotations
or down-rank state between seeds.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Set

from repro_torch.core.fault_codes import ErrorType, FaultEvent, Severity


@dataclass
class ScheduledFault:
    at_step: int
    physical_id: int
    severity: Severity = Severity.L6
    error_type: ErrorType = ErrorType.HBM_ECC
    component: str = "attn"           # what the device was doing
    mid_step: bool = False            # fire inside the generation step
    fired: bool = False
    # recurring faults re-arm after :meth:`FaultInjector.clear` —
    # the flapping-link shape (fault -> clear -> re-fault on one rank)
    recurring: bool = False


class SimulatedDeviceFailure(Exception):
    def __init__(self, event: FaultEvent):
        super().__init__(str(event))
        self.event = event


class FaultInjector:
    def __init__(self):
        self.scheduled: List[ScheduledFault] = []
        self.annotations: List[FaultEvent] = []   # "node annotations"
        self._down: Set[int] = set()              # ranks fired, not cleared
        self.deduped = 0                          # swallowed duplicates

    def schedule(self, at_step: int, physical_id: int, *,
                 severity: Severity = Severity.L6,
                 error_type: ErrorType = ErrorType.HBM_ECC,
                 component: str = "attn", mid_step: bool = False,
                 recurring: bool = False) -> ScheduledFault:
        """Schedule a fault; returns the handle (usable with cancel()).

        Scheduling is idempotent: an identical still-pending entry is
        returned instead of duplicated, so campaign episodes may replay
        overlapping schedules onto one injector.
        """
        for f in self.scheduled:
            if (not f.fired and f.at_step == at_step
                    and f.physical_id == physical_id
                    and f.mid_step == mid_step
                    and f.error_type is error_type
                    and f.severity is severity):
                self.deduped += 1
                return f
        f = ScheduledFault(at_step, physical_id, severity, error_type,
                           component, mid_step, recurring=recurring)
        self.scheduled.append(f)
        return f

    def _fire(self, f: ScheduledFault) -> Optional[FaultEvent]:
        f.fired = True
        if f.physical_id in self._down:
            # the rank is already down and un-cleared: swallow the
            # duplicate instead of re-annotating (recovery already ran)
            self.deduped += 1
            return None
        self._down.add(f.physical_id)
        ev = FaultEvent(rank=f.physical_id, severity=f.severity,
                        error_type=f.error_type, component=f.component)
        self.annotations.append(ev)
        return ev

    @staticmethod
    def _due(f: ScheduledFault, step: int) -> bool:
        # a re-armed recurring fault has an at_step in the past: it fires
        # on the first step after the clear, not never
        return (f.at_step == step
                or (f.recurring and step >= f.at_step))

    def pre_step_faults(self, step: int) -> List[FaultEvent]:
        """Faults firing at a step boundary: annotate and return them."""
        out = []
        for f in self.scheduled:
            if not f.fired and not f.mid_step and self._due(f, step):
                ev = self._fire(f)
                if ev is not None:
                    out.append(ev)
        return out

    def maybe_fail_mid_step(self, step: int, physical_id: int) -> None:
        """Called from inside an executor's step; raises on a hit."""
        for f in self.scheduled:
            if (not f.fired and f.mid_step and self._due(f, step)
                    and f.physical_id == physical_id):
                ev = self._fire(f)
                if ev is not None:
                    raise SimulatedDeviceFailure(ev)

    # -- campaign lifecycle ------------------------------------------------------

    def clear(self, physical_id: int) -> bool:
        """The transient condition ended (link restored, thermals back in
        range): the rank may fault again.  Recurring faults on this rank
        re-arm.  Returns True if the rank was down."""
        was_down = physical_id in self._down
        self._down.discard(physical_id)
        for f in self.scheduled:
            if f.fired and f.recurring and f.physical_id == physical_id:
                f.fired = False
        return was_down

    def cancel(self, fault: Optional[ScheduledFault] = None, *,
               physical_id: Optional[int] = None) -> int:
        """Remove pending (unfired) schedule entries — a specific handle,
        every entry for one rank, or (no arguments) all of them.
        Returns the number removed."""
        def keep(f: ScheduledFault) -> bool:
            if f.fired:
                return True
            if fault is not None:
                return f is not fault
            if physical_id is not None:
                return f.physical_id != physical_id
            return False
        kept = [f for f in self.scheduled if keep(f)]
        removed = len(self.scheduled) - len(kept)
        self.scheduled = kept
        return removed

    def reset(self) -> None:
        """Back to pristine: no schedules, no annotations, no down ranks.
        Lets one injector be reused across campaign episodes without
        state leaking between seeds."""
        self.scheduled = []
        self.annotations = []
        self._down = set()
        self.deduped = 0

    def drain_annotations(self) -> List[FaultEvent]:
        out, self.annotations = self.annotations, []
        return out
