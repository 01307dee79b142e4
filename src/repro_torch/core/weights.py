"""Weight-integrity planning (§3.4, Fig. 4 flowchart).

When a failure involves MoE weights, decide between:
  1. redundant experts  — every lost expert still has a live replica;
                          drop dead slots from the map (fast, lossless).
  2. role switch        — repurpose a replicated attention DP rank as the
                          new MoE rank; expert weights re-load from disk
                          (slow, lossless).
  3. missing experts    — mask lost experts' routing logits; accuracy
                          impact is negligible for EP >= 32 (§4.2).

Also models the dense-FFN TP-group handling for the first-k dense layers
(DeepSeek V3 / Kimi K2): a compromised TP group is removed and attention
rebalances its outgoing tokens over healthy groups.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import List, Optional

from repro_torch.core.expert_map import ExpertMap


class MoERecoveryKind(enum.Enum):
    REDUNDANT_EXPERTS = "redundant_experts"
    ROLE_SWITCH = "role_switch"
    MISSING_EXPERTS = "missing_experts"


@dataclass(frozen=True)
class RecoveryPolicy:
    allow_role_switch: bool = True
    allow_missing_experts: bool = True
    # §4.2: <= 1/32 of experts lost has negligible accuracy impact
    min_ep_for_missing: int = 32
    # §4.3: run the role switch in the background while serving with the
    # (possibly incomplete) current expert set
    background_role_switch: bool = False


@dataclass
class MoERecoveryPlan:
    kind: MoERecoveryKind
    lost_logicals: List[int] = field(default_factory=list)
    donor_rank: Optional[int] = None     # DP rank switched to MoE duty
    accuracy_warning: bool = False       # missing-experts below EP threshold
    background: bool = False             # serve degraded while switching

    def describe(self) -> str:
        s = f"{self.kind.value}"
        if self.lost_logicals:
            s += f" lost={self.lost_logicals[:8]}" + (
                "..." if len(self.lost_logicals) > 8 else "")
        if self.donor_rank is not None:
            s += f" donor=dp{self.donor_rank}"
        if self.accuracy_warning:
            s += " [WARN: EP below missing-expert threshold]"
        return s


def plan_moe_recovery(expert_map: ExpertMap, policy: RecoveryPolicy,
                      donor_rank: Optional[int]) -> MoERecoveryPlan:
    """Fig. 4: choose the recovery action after ``fail_rank`` was applied.

    donor_rank: a healthy, replicated attention DP rank that could be
    switched to MoE duty (None if unavailable).
    """
    lost = expert_map.fully_lost()
    if not lost:
        # every expert on the failed rank is replicated elsewhere
        return MoERecoveryPlan(MoERecoveryKind.REDUNDANT_EXPERTS)
    ep_ok = expert_map.ep_size >= policy.min_ep_for_missing
    can_switch = policy.allow_role_switch and donor_rank is not None
    if can_switch and not (policy.background_role_switch and
                           policy.allow_missing_experts):
        return MoERecoveryPlan(MoERecoveryKind.ROLE_SWITCH,
                               lost_logicals=lost, donor_rank=donor_rank)
    if can_switch and policy.background_role_switch:
        # §4.3 combined mode: mask now, restore full integrity in background
        return MoERecoveryPlan(MoERecoveryKind.ROLE_SWITCH,
                               lost_logicals=lost, donor_rank=donor_rank,
                               background=True,
                               accuracy_warning=not ep_ok)
    if policy.allow_missing_experts:
        return MoERecoveryPlan(MoERecoveryKind.MISSING_EXPERTS,
                               lost_logicals=lost,
                               accuracy_warning=not ep_ok)
    raise RuntimeError(
        f"unrecoverable: experts {lost} lost, role switch unavailable, "
        f"missing-experts disallowed")


# ---------------------------------------------------------------------------
# dense-FFN TP groups (first-k dense layers of DeepSeek V3 / Kimi K2)
# ---------------------------------------------------------------------------

class DenseFFNGroups:
    """Replicated TP groups serving the first-k dense FFN layers.

    A lost shard compromises its whole TP group; attention then rebalances
    outgoing tokens evenly over the healthy groups (§3.4)."""

    def __init__(self, num_groups: int, tp_size: int = 4):
        assert num_groups >= 1
        self.num_groups = num_groups
        self.tp_size = tp_size
        self.alive = [True] * num_groups

    def fail_shard(self, group: int) -> None:
        assert 0 <= group < self.num_groups
        self.alive[group] = False

    def num_healthy(self) -> int:
        return sum(self.alive)

    def routing_weights(self) -> List[float]:
        """Token fractions per group: even over healthy, 0 for compromised."""
        h = self.num_healthy()
        if h == 0:
            raise RuntimeError("all dense-FFN TP groups compromised")
        return [1.0 / h if a else 0.0 for a in self.alive]
