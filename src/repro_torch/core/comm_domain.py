"""Communication-domain modelling and rank compaction (§3.5).

Tracks the logical-rank assignment of every device across the attention
and MoE groups.  On failure the failed device is treated as *inaccessible*
(it physically remains, but no operation may touch it):

* default world group stays intact — we only rebuild subgroups,
* XCCL-style domains are destroyed and recreated: the trampoline domain
  (between experts, MA-disaggregated only) first, then the
  attention↔expert domain,
* logical ranks are *compacted*: if rank ℓ_A fails, every rank ℓ > ℓ_A
  decrements by one; in a role switch, the switched device C takes ℓ_A
  directly, then remaining gaps compact.

``version`` increments on every rebuild — it is the key under which the
computation graph must be (re-)compiled (§3.6).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple


@dataclass
class DeviceRank:
    physical_id: int
    logical_rank: int
    role: str            # 'attn' | 'moe' | 'attn+moe' (collocated)
    alive: bool = True


class CommDomain:
    def __init__(self, n_attn: int, n_moe: int, collocated: bool):
        """collocated: attention and MoE share devices (n_moe ignored)."""
        self.collocated = collocated
        self.version = 0
        self.rebuild_log: List[Dict] = []
        self.ranks: List[DeviceRank] = []
        if collocated:
            for i in range(n_attn):
                self.ranks.append(DeviceRank(i, i, "attn+moe"))
        else:
            for i in range(n_attn):
                self.ranks.append(DeviceRank(i, i, "attn"))
            for j in range(n_moe):
                self.ranks.append(DeviceRank(n_attn + j, j, "moe"))

    # -- queries ---------------------------------------------------------------

    def device(self, physical_id: int) -> DeviceRank:
        for r in self.ranks:
            if r.physical_id == physical_id:
                return r
        raise KeyError(physical_id)

    def group(self, role_substr: str, alive_only=True) -> List[DeviceRank]:
        return [r for r in self.ranks
                if role_substr in r.role and (r.alive or not alive_only)]

    @property
    def world_size(self) -> int:
        return sum(r.alive for r in self.ranks)

    def logical_map(self, role_substr: str) -> Dict[int, int]:
        """physical_id -> logical rank within the role group."""
        return {r.physical_id: r.logical_rank
                for r in self.group(role_substr)}

    # -- failure + compaction (§3.5) ---------------------------------------------

    def fail(self, physical_id: int) -> DeviceRank:
        r = self.device(physical_id)
        r.alive = False
        return r

    def compact(self, role_substr: str,
                switched_physical: Optional[int] = None) -> Dict[int, Tuple[int, int]]:
        """Close logical-rank gaps left by dead devices in one role group.

        If ``switched_physical`` is given (role switch), that device takes
        the failed device's logical rank directly; remaining gaps close by
        decrementing subsequent ranks.  Returns {physical_id: (old, new)}.
        """
        changes: Dict[int, Tuple[int, int]] = {}
        members = self.group(role_substr, alive_only=False)
        dead = sorted(r.logical_rank for r in members if not r.alive)
        if switched_physical is not None and dead:
            target = dead.pop(0)
            sw = self.device(switched_physical)
            changes[sw.physical_id] = (sw.logical_rank, target)
            sw.logical_rank = target
            sw.role = role_substr
            sw.alive = True
        # decrement every alive rank above each remaining gap
        for gap in reversed(dead):
            for r in self.group(role_substr):
                if r.logical_rank > gap:
                    changes.setdefault(r.physical_id,
                                       (r.logical_rank, r.logical_rank))
                    old = changes[r.physical_id][0]
                    r.logical_rank -= 1
                    changes[r.physical_id] = (old, r.logical_rank)
        return changes

    # -- rebuild (timed; the XCCL destroy/create analogue) -------------------------

    def rebuild(self, role_switch_physical: Optional[int] = None) -> Dict:
        t0 = time.perf_counter()
        stages = []
        if not self.collocated:
            stages.append("destroy_trampoline_domain")   # inter-expert
        stages.append("destroy_attn_expert_domain")
        attn_changes = self.compact("attn") if not self.collocated else {}
        moe_role = "moe" if not self.collocated else "attn+moe"
        moe_changes = self.compact(moe_role,
                                   switched_physical=role_switch_physical)
        stages.append("create_attn_expert_domain")
        if not self.collocated:
            stages.append("create_trampoline_domain")
        self.version += 1
        rec = {
            "version": self.version,
            "stages": stages,
            "rank_changes": {**attn_changes, **moe_changes},
            "world_size": self.world_size,
            "elapsed_s": time.perf_counter() - t0,
        }
        self.rebuild_log.append(rec)
        return rec
