"""Failure detection (§3.1): heartbeats + annotation polling.

Two complementary detectors, as in the paper:

* :class:`AnnotationPoller` — the device-plugin path: a side actor
  periodically reads node annotations written by the (here: injected)
  NPU fault reporter and converts them into recovery triggers based on
  their L1–L6 severity.
* :class:`HeartbeatMonitor` — the engine path: every executor heartbeats
  each engine step; a rank silent for ``timeout_steps`` raises a
  HEARTBEAT_TIMEOUT fault (catches hangs that never annotate).
"""
from __future__ import annotations

from typing import Dict, List, Set

from repro_torch.core.fault_codes import Action, ErrorType, FaultEvent, Severity
from repro_torch.core.faults import FaultInjector


class HeartbeatMonitor:
    def __init__(self, timeout_steps: int = 2):
        self.timeout_steps = timeout_steps
        self.last_beat: Dict[int, int] = {}
        self._reported: Set[int] = set()

    def register(self, physical_id: int, step: int = 0) -> None:
        self.last_beat[physical_id] = step

    def unregister(self, physical_id: int) -> None:
        self.last_beat.pop(physical_id, None)
        self._reported.discard(physical_id)

    def beat(self, physical_id: int, step: int) -> None:
        self.last_beat[physical_id] = step

    def check(self, step: int) -> List[FaultEvent]:
        events = []
        for pid, last in self.last_beat.items():
            if step - last >= self.timeout_steps and pid not in self._reported:
                self._reported.add(pid)
                events.append(FaultEvent(
                    rank=pid, severity=Severity.L5,
                    error_type=ErrorType.HEARTBEAT_TIMEOUT,
                    component="attn",
                    detail=f"no heartbeat for {step - last} steps"))
        return events


class AnnotationPoller:
    """Ray-actor analogue that watches node annotations for fault codes."""

    def __init__(self, injector: FaultInjector):
        self.injector = injector
        self.ignored: List[FaultEvent] = []

    def poll(self) -> List[FaultEvent]:
        """Return only events whose severity warrants action (L3+)."""
        actionable = []
        for ev in self.injector.drain_annotations():
            if ev.action is Action.IGNORE:
                self.ignored.append(ev)   # L1/L2: log only
            else:
                actionable.append(ev)
        return actionable


class StragglerDetector:
    """Slowdown detection — the paper's §6 stated future work.

    A single slow device stalls the whole MoE system (every collective
    waits for it), yet it never reports a fault code.  We keep a rolling
    window of per-device step durations; a device whose median exceeds
    ``ratio`` × the fleet median for ``patience`` consecutive checks is
    flagged with an L4 COMPUTE_FAULT — ReviveMoE then treats it exactly
    like a failed device (isolate + migrate), which is cheaper than
    letting it throttle every step.
    """

    def __init__(self, ratio: float = 3.0, window: int = 8,
                 patience: int = 2, min_samples: int = 4):
        self.ratio = ratio
        self.window = window
        self.patience = patience
        self.min_samples = min_samples
        self.samples: Dict[int, List[float]] = {}
        self.strikes: Dict[int, int] = {}
        self._reported: Set[int] = set()

    def forgive(self, physical_id: int) -> None:
        """Rejoin support: a device returning to service (cleared
        transient fault) starts with a clean slate — old samples,
        strikes and the reported flag would otherwise re-isolate it
        immediately on stale data."""
        self.samples.pop(physical_id, None)
        self.strikes.pop(physical_id, None)
        self._reported.discard(physical_id)

    def record(self, physical_id: int, duration_s: float) -> None:
        buf = self.samples.setdefault(physical_id, [])
        buf.append(duration_s)
        if len(buf) > self.window:
            buf.pop(0)

    def _median(self, xs: List[float]) -> float:
        s = sorted(xs)
        n = len(s)
        return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])

    def suspects(self) -> Dict[int, float]:
        """Soft signal: devices currently over ``ratio`` × fleet median,
        *before* patience promotes them to a hard L4 fault.  The fleet's
        RecoveryArbiter consumes this to drain an instance proactively
        (substitute a spare / shift traffic) instead of waiting for the
        straggler to throttle every collective step."""
        devs = {pid: buf for pid, buf in self.samples.items()
                if len(buf) >= self.min_samples}
        if len(devs) < 2:
            return {}
        medians = {pid: self._median(buf) for pid, buf in devs.items()}
        fleet = self._median(list(medians.values()))
        if fleet <= 0:
            return {}
        return {pid: m / fleet for pid, m in medians.items()
                if m > self.ratio * fleet and pid not in self._reported}

    def check(self) -> List[FaultEvent]:
        devs = {pid: buf for pid, buf in self.samples.items()
                if len(buf) >= self.min_samples}
        if len(devs) < 2:
            return []
        medians = {pid: self._median(buf) for pid, buf in devs.items()}
        fleet = self._median(list(medians.values()))
        events = []
        for pid, m in medians.items():
            if pid in self._reported:
                continue
            if fleet > 0 and m > self.ratio * fleet:
                self.strikes[pid] = self.strikes.get(pid, 0) + 1
                if self.strikes[pid] >= self.patience:
                    self._reported.add(pid)
                    events.append(FaultEvent(
                        rank=pid, severity=Severity.L4,
                        error_type=ErrorType.COMPUTE_FAULT,
                        component="attn",
                        detail=f"straggler: {m * 1e3:.1f}ms vs fleet "
                               f"median {fleet * 1e3:.1f}ms"))
            else:
                self.strikes[pid] = 0
        return events
