"""Restart-vs-revive-vs-spare arbitration.

Per fault, the fleet has three ways out, each with a different
client-visible cost profile:

* **revive**  — ReviveMoE in-place recovery: the instance stalls for the
  (short, mostly precompiled) revive pipeline, then resumes with all its
  KV/scheduler state intact.
* **restart** — drain-and-restart: the instance stalls for a full
  relaunch (engine + executors + weights + groups + compile-from-cache);
  everything in flight waits out the stall, then re-prefills locally.
* **spare**   — substitution: in-flight requests migrate to a pre-warmed
  standby with prompt + generated-prefix re-prefill; the wounded
  instance leaves the serving set.  Costs a spare.

The :class:`CostModel` turns these into comparable numbers — expected
stall seconds × requests affected — and is *measurement-fed*: estimates
are seeded from the instance's own build timings, then replaced by the
running mean of what each policy actually cost when it ran (revive from
``RecoveryReport.cost_inputs()``, restart/spare from wall-clock).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from repro_torch.core.fault_codes import FaultEvent
from repro_torch.fleet.instance import FleetInstance, InstanceState

POLICIES = ("revive", "restart", "spare")


class _RunningMean:
    def __init__(self, seed_value: float):
        self.value = seed_value
        self.n = 0          # observations (seed excluded)

    def observe(self, x: float) -> None:
        self.n += 1
        if self.n == 1:
            self.value = x          # first measurement replaces the seed
        else:
            self.value += (x - self.value) / self.n


class CostModel:
    """Per-policy stall estimates (seconds), measurement-fed.

    Spare substitution is priced on its *actual* migration mechanics:
    requests whose executors are still reachable stream their KV blocks
    (O(bytes) copy, per-block rate), the rest re-prefill from token
    replay (per-token rate) — so the estimate stays flat in prefix
    length exactly when the streamed path is available.

    Revive is priced on stall *and quality*: when the failed rank's
    experts have no surviving replica, revive serves with them masked
    until a (background) role switch restores the weights — degraded
    answers are a real client cost, converted to stall-equivalent
    seconds via ``degraded_quality_weight_s`` (the stall a client would
    trade for full-quality service of one request, scaled by the masked
    fraction).
    """

    def __init__(self, init_timings: Dict[str, float], *,
                 per_token_prefill_s: float = 2e-4,
                 per_block_stream_s: float = 2e-5,
                 degraded_quality_weight_s: float = 1.0,
                 spare_opportunity_cost_s: Optional[float] = None):
        restart_seed = sum(init_timings.values()) or 1.0
        # revive skips engine/executor/weight re-init; it pays rollback +
        # comm rebuild + a (pre)cached graph lookup.  Until measured, use
        # the build's comm + cache-read share as the seed.
        revive_seed = (init_timings.get("xccl", 0.0)
                       + init_timings.get("distributed_groups", 0.0)
                       + init_timings.get("read_cache", 0.0)) or \
            0.05 * restart_seed
        self.revive = _RunningMean(revive_seed)
        self.restart = _RunningMean(restart_seed)
        # spare substitution: the swap itself is a routing-table update;
        # migrated state arrives by KV-block stream (per block) or by
        # re-prefill of the replayed tokens (per token)
        self.per_token_prefill_s = per_token_prefill_s
        self.per_block_stream_s = per_block_stream_s
        self.degraded_quality_weight_s = degraded_quality_weight_s
        self.spare_swap = _RunningMean(0.0)
        # consuming a standby is not free even if the swap is fast: the
        # fleet loses a spare until a replacement is built.  Expressed in
        # stall-seconds so it competes in the same currency; defaults to
        # half the (measured) restart cost — the replenish build happens
        # off the serving path, hence the discount.
        self._spare_opportunity_cost_s = spare_opportunity_cost_s

    # -- estimates ---------------------------------------------------------------

    @property
    def spare_opportunity_cost_s(self) -> float:
        if self._spare_opportunity_cost_s is not None:
            return self._spare_opportunity_cost_s
        return 0.5 * self.restart.value

    def est_revive_s(self) -> float:
        return self.revive.value

    def est_restart_s(self) -> float:
        return self.restart.value

    def est_spare_s(self, tokens_to_reprefill: int,
                    blocks_to_stream: int = 0) -> float:
        return (self.spare_swap.value
                + tokens_to_reprefill * self.per_token_prefill_s
                + blocks_to_stream * self.per_block_stream_s)

    def quality_cost_s(self, masked_fraction: float) -> float:
        """Stall-equivalent price of serving one request with a fraction
        of the experts masked (0.0 when redundancy covers the fault)."""
        return masked_fraction * self.degraded_quality_weight_s

    # -- measurement feedback ----------------------------------------------------

    def observe_revive(self, cost_inputs: Dict[str, float]) -> None:
        self.revive.observe(cost_inputs["total_s"])

    def observe_restart(self, elapsed_s: float) -> None:
        self.restart.observe(elapsed_s)

    def observe_spare(self, swap_s: float, tokens: int,
                      streamed_blocks: int = 0) -> None:
        self.spare_swap.observe(max(0.0, swap_s
                                    - tokens * self.per_token_prefill_s
                                    - streamed_blocks
                                    * self.per_block_stream_s))


@dataclass
class ArbiterDecision:
    policy: str                       # 'revive' | 'restart' | 'spare'
    instance_id: int
    event: Optional[FaultEvent]
    est_cost: Dict[str, float] = field(default_factory=dict)
    reason: str = ""
    proactive: bool = False           # soft-signal (straggler) triggered

    def summary(self) -> str:
        costs = ", ".join(f"{k}={v * 1e3:.0f}ms"
                          for k, v in sorted(self.est_cost.items()))
        tag = "proactive " if self.proactive else ""
        return (f"[arbiter] {tag}instance {self.instance_id}: "
                f"{self.policy.upper()} ({self.reason}) :: {costs}")


class RecoveryArbiter:
    def __init__(self, cost_model: CostModel, *,
                 force_policy: Optional[str] = None,
                 soft_patience: int = 1):
        # soft_patience counts fleet ticks of sustained suspicion; it
        # must stay below the StragglerDetector's hard patience (2 engine
        # steps) or the hard L4 fault always wins the race and the
        # proactive path never fires
        if force_policy is not None and force_policy not in POLICIES:
            raise ValueError(
                f"force_policy must be one of {POLICIES} or None, "
                f"got {force_policy!r}")
        self.cost = cost_model
        self.force_policy = force_policy
        self.soft_patience = soft_patience
        self.decisions: List[ArbiterDecision] = []
        self._soft_streak: Dict[int, int] = {}

    # -- hard faults -------------------------------------------------------------

    def decide(self, inst: FleetInstance, event: Optional[FaultEvent], *,
               spare_available: bool,
               instance_lost: bool = False) -> ArbiterDecision:
        n_inflight = max(1, inst.load)
        tokens = sum(r.num_tokens for r in inst.engine.all_requests
                     if r.state.value not in ("finished", "failed"))
        # spare substitution streams KV blocks off still-reachable
        # executors and replays only the rest; a lost instance streams
        # nothing (device memory is gone with the host)
        split = getattr(inst.engine, "streamable_split", None)
        if split is not None and not instance_lost:
            stream_tokens, replay_tokens = split()
        else:
            stream_tokens, replay_tokens = 0, tokens
        block_size = getattr(getattr(inst.engine, "ecfg", None),
                             "block_size", 16)
        stream_blocks = -(-stream_tokens // block_size)
        # revive may have to serve with the fault's experts masked —
        # price that quality loss, not just the stall
        mask_frac = 0.0
        predict = getattr(inst.engine, "predict_masked_fraction", None)
        if predict is not None and event is not None and not instance_lost:
            mask_frac = predict(event.rank)
        est = {
            "revive": (self.cost.est_revive_s()
                       + self.cost.quality_cost_s(mask_frac)) * n_inflight,
            "restart": self.cost.est_restart_s() * n_inflight,
            "spare": (self.cost.est_spare_s(replay_tokens, stream_blocks)
                      * n_inflight
                      + self.cost.spare_opportunity_cost_s),
        }
        feasible = dict(est)
        reason = None
        if instance_lost:
            # nothing on the host can run the revive pipeline
            feasible.pop("revive", None)
            reason = "instance lost: in-place revive impossible"
        if not spare_available:
            feasible.pop("spare", None)
        if self.force_policy is not None:
            if self.force_policy in feasible:
                policy = self.force_policy
                reason = f"forced policy ({self.force_policy})"
            else:
                # deterministic fallback: a forced policy that cannot run
                # (revive on a lost host, spare with a dry pool) degrades
                # to drain-and-restart — always feasible — so "X-only"
                # baseline fleets are well-defined under every fault
                policy = "restart"
                reason = (f"forced policy ({self.force_policy}) "
                          f"infeasible: fell back to restart")
        else:
            policy = min(feasible, key=lambda k: feasible[k])
            if reason is None:
                reason = (f"min expected stall over {n_inflight} "
                          f"in-flight requests")
                if mask_frac > 0.0:
                    reason += (f"; revive priced with {mask_frac:.0%} "
                               f"experts masked")
        dec = ArbiterDecision(policy=policy, instance_id=inst.iid,
                              event=event, est_cost=est, reason=reason)
        self.decisions.append(dec)
        return dec

    # -- soft signals (stragglers) -----------------------------------------------

    def consider_soft(self, inst: FleetInstance,
                      spare_available: bool) -> Optional[ArbiterDecision]:
        """A straggling device throttles every collective step without
        ever raising a fault code.  Persistent suspicion (>= patience
        consecutive ticks) triggers a proactive decision: substitute a
        spare if one is warm, otherwise drain new traffic away."""
        signals = inst.health().soft_signals
        if not signals:
            self._soft_streak[inst.iid] = 0
            if inst.state is InstanceState.DRAINING:
                inst.state = InstanceState.SERVING   # suspicion cleared
            return None
        streak = self._soft_streak.get(inst.iid, 0) + 1
        self._soft_streak[inst.iid] = streak
        if streak < self.soft_patience:
            return None
        worst = max(signals.values())
        if spare_available:
            dec = ArbiterDecision(
                policy="spare", instance_id=inst.iid, event=None,
                est_cost={"slowdown_ratio": worst}, proactive=True,
                reason=f"straggler x{worst:.1f} for {streak} ticks")
            self.decisions.append(dec)
            self._soft_streak[inst.iid] = 0
            return dec
        if inst.state is InstanceState.SERVING:
            inst.state = InstanceState.DRAINING
            dec = ArbiterDecision(
                policy="restart", instance_id=inst.iid, event=None,
                est_cost={"slowdown_ratio": worst}, proactive=True,
                reason=f"straggler x{worst:.1f}, no spare: draining")
            self.decisions.append(dec)
            return dec
        return None
