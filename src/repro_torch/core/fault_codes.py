"""Fault taxonomy (§3.1): six severity levels, L1 benign → L6 critical.

Mirrors the Huawei NPU device-plugin fault reporting consumed by
ReviveMoE: each fault carries an event id, alarm time, severity and error
type.  The severity decides the action:

  L1–L2  benign / transient         -> log only, no action
  L3–L4  recoverable device errors  -> ReviveMoE recovery, device may rejoin
  L5–L6  critical hardware faults   -> full isolation + ReviveMoE recovery
"""
from __future__ import annotations

import enum
import itertools
import time
from dataclasses import dataclass, field


class Severity(enum.IntEnum):
    L1 = 1
    L2 = 2
    L3 = 3
    L4 = 4
    L5 = 5
    L6 = 6


class Action(enum.Enum):
    IGNORE = "ignore"
    RECOVER = "recover"
    ISOLATE_AND_RECOVER = "isolate_and_recover"


def action_for(severity: Severity) -> Action:
    if severity <= Severity.L2:
        return Action.IGNORE
    if severity <= Severity.L4:
        return Action.RECOVER
    return Action.ISOLATE_AND_RECOVER


class ErrorType(enum.Enum):
    HBM_ECC = "hbm_ecc"
    LINK_DOWN = "link_down"
    OVER_TEMP = "over_temp"
    DRIVER_HANG = "driver_hang"
    COMPUTE_FAULT = "compute_fault"
    HEARTBEAT_TIMEOUT = "heartbeat_timeout"


_event_counter = itertools.count(1)


@dataclass(frozen=True)
class FaultEvent:
    rank: int                     # logical rank of the affected device
    severity: Severity
    error_type: ErrorType
    component: str                # 'attn' | 'moe'
    event_id: int = field(default_factory=lambda: next(_event_counter))
    alarm_time: float = field(default_factory=time.monotonic)
    detail: str = ""

    @property
    def action(self) -> Action:
        return action_for(self.severity)

    def __str__(self) -> str:
        return (f"FaultEvent#{self.event_id}[{self.severity.name} "
                f"{self.error_type.value} rank={self.rank} "
                f"component={self.component} -> {self.action.value}]")
