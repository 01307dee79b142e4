"""Logical→physical expert mapping with redundancy (§3.4).

The host-side authority over expert placement.  Physical slots live on EP
ranks; redundant slots replicate (by default the hottest = first R)
logical experts.  Recovery mutates this map — dropping dead replicas,
masking fully-lost experts, or re-installing a rank after a role switch —
and re-emits the device-side :class:`MoERuntime` tensors.  The decode
step never changes: recovery is a data update (the paper's point about
"removing the failed experts from the logical-to-physical mapping").
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set

import numpy as np
import torch

from repro_torch.configs.base import MoEConfig
from repro_torch.device import resolve_device
from repro_torch.models.moe import MAX_REPLICAS, MoERuntime, physical_experts


class ExpertMap:
    def __init__(self, moe: MoEConfig, ep_size: int,
                 hot_experts: Optional[Sequence[int]] = None, *,
                 device=None):
        """``device``: where :meth:`runtime` emits its tensors (the
        engine's device; the card unless the caller asks for the CPU)."""
        self.moe = moe
        self.device = resolve_device(device)
        self.ep_size = ep_size
        E_log, R = moe.num_experts, moe.num_redundant_experts
        self.E_phys = physical_experts(moe)
        assert self.E_phys % ep_size == 0, (self.E_phys, ep_size)
        self.slots_per_rank = self.E_phys // ep_size
        # slot -> logical expert (base slots then replicas of hot experts)
        hot = list(hot_experts) if hot_experts is not None else list(range(R))
        assert len(hot) == R
        self.slot_logical: List[int] = list(range(E_log)) + hot
        self.slot_alive: List[bool] = [True] * self.E_phys
        self.masked: Set[int] = set()

    # -- placement queries ---------------------------------------------------

    def rank_of_slot(self, slot: int) -> int:
        return slot // self.slots_per_rank

    def rank_slots(self, rank: int) -> range:
        return range(rank * self.slots_per_rank,
                     (rank + 1) * self.slots_per_rank)

    def replicas_of(self, logical: int) -> List[int]:
        return [s for s, l in enumerate(self.slot_logical)
                if l == logical and self.slot_alive[s]]

    def fully_lost(self) -> List[int]:
        """Logical experts with zero alive replicas (and not yet masked)."""
        alive_logicals = {self.slot_logical[s]
                          for s in range(self.E_phys) if self.slot_alive[s]}
        return [e for e in range(self.moe.num_experts)
                if e not in alive_logicals and e not in self.masked]

    # -- recovery mutations ------------------------------------------------------

    def fail_rank(self, rank: int) -> List[int]:
        """Mark all slots of an EP rank dead. Returns affected logicals."""
        affected = []
        for s in self.rank_slots(rank):
            if self.slot_alive[s]:
                self.slot_alive[s] = False
                affected.append(self.slot_logical[s])
        return affected

    def mask_experts(self, logicals: Sequence[int]) -> None:
        """§3.4 'missing experts': routing logits masked to -inf."""
        self.masked.update(logicals)

    def install_rank(self, rank: int) -> List[int]:
        """Role switch complete: the rank's slots are healthy again
        (weights were re-loaded from disk onto the switched device)."""
        restored = []
        for s in self.rank_slots(rank):
            if not self.slot_alive[s]:
                self.slot_alive[s] = True
                restored.append(self.slot_logical[s])
        # a restored expert no longer needs masking
        self.masked -= set(restored)
        return restored

    def rebalance_replicas(self, usage_counts) -> Dict[int, int]:
        """Re-point the *alive* redundant slots at the currently hottest
        experts (the paper: "redundant experts are typically selected
        based on usage frequency").  Slot placement is fixed (weights must
        be copied by the caller); returns {slot: new_logical} moves.

        Fault-tolerance interaction (§4.3): the hottest experts end up
        double-covered, but a cold expert's last copy can still be lost —
        which is exactly why role switching exists.
        """
        E = self.moe.num_experts
        order = sorted(range(E), key=lambda e: -usage_counts[e])
        moves: Dict[int, int] = {}
        assigned: Set[int] = set()
        for s in range(E, self.E_phys):
            if not self.slot_alive[s]:
                continue
            rank = self.rank_of_slot(s)
            # anti-affinity: a replica on the same rank as every existing
            # copy gives zero fault isolation — pick the hottest expert
            # whose alive copies all live on *other* ranks
            want = None
            for e in order:
                if e in assigned:
                    continue
                if any(self.rank_of_slot(r) == rank
                       for r in self.replicas_of(e) if r != s):
                    continue
                want = e
                break
            if want is None:
                continue
            assigned.add(want)
            if self.slot_logical[s] != want:
                moves[s] = want
                self.slot_logical[s] = want
        return moves

    # -- device-side arrays ---------------------------------------------------------

    def runtime(self) -> MoERuntime:
        E_log = self.moe.num_experts
        l2p = np.zeros((E_log, MAX_REPLICAS), np.int32)
        count = np.zeros((E_log,), np.int32)
        mask = np.ones((E_log,), bool)
        for e in range(E_log):
            reps = self.replicas_of(e)[:MAX_REPLICAS]
            count[e] = len(reps)
            for i, s in enumerate(reps):
                l2p[e, i] = s
            if e in self.masked or not reps:
                mask[e] = False
        return MoERuntime(torch.from_numpy(l2p).to(self.device),
                          torch.from_numpy(count).to(self.device),
                          torch.from_numpy(mask).to(self.device))

    # -- introspection -----------------------------------------------------------------

    def coverage(self) -> float:
        """Fraction of logical experts with >=1 alive replica (masked
        experts still count as lost — masking hides, not restores)."""
        E = self.moe.num_experts
        alive_logicals = {self.slot_logical[s]
                          for s in range(self.E_phys) if self.slot_alive[s]}
        return len([e for e in range(E) if e in alive_logicals]) / E

    def describe(self) -> str:
        dead = [s for s in range(self.E_phys) if not self.slot_alive[s]]
        return (f"ExpertMap(E_log={self.moe.num_experts}, "
                f"E_phys={self.E_phys}, ep={self.ep_size}, "
                f"dead_slots={dead}, masked={sorted(self.masked)})")
