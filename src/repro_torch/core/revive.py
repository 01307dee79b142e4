"""RecoveryManager: the ReviveMoE pipeline (§3, Fig. 3).

On an actionable fault:
  ① the failed device is isolated (its executor process terminated),
  ② active sequences migrate off failed attention ranks with partial
     recomputation (§3.2),
  ③ every surviving executor rolls back its in-flight block-table log to
     the step boundary (§3.3),
  ④ MoE weight integrity is restored per the Fig. 4 flowchart —
     redundant experts / role switch / missing experts (§3.4),
  ⑤ the communication domain is destroyed and recreated with compacted
     logical ranks (§3.5),
  ⑥ the computation graph for the new domain is produced by cached
     compilation — precompiled failure-scenario executables when
     available (§3.6) — and inference resumes.

Every stage is wall-clock timed into the paper's Table-1 categories.

The host logic is ``repro.core.revive``'s.  The port serves collocated
lockstep engines, where no attention rank can be spared as a donor, so a
role switch (§3.4, disaggregated mode) is never planned here; it comes
with the disaggregated slice (ROADMAP Queue 1) and raises until then.
Sequences on a failed rank re-prefill on the survivors (token replay).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from repro_torch.core.fault_codes import Action, FaultEvent
from repro_torch.core.migration import plan_migration, prepare_for_migration
from repro_torch.core.weights import (MoERecoveryKind, MoERecoveryPlan,
                                plan_moe_recovery)
from repro_torch.serving.request import RequestState

CATEGORIES = ("engine", "executor_processes", "distributed_groups", "xccl",
              "role_switch", "generator", "read_cache", "compile", "other")


@dataclass
class RecoveryReport:
    event: FaultEvent
    scenario: str                       # e.g. 'attn', 'moe+redundant', ...
    mode: str                           # collocated | disaggregated
    timings: Dict[str, float] = field(default_factory=dict)
    actions: List[str] = field(default_factory=list)
    moe_plan: Optional[MoERecoveryPlan] = None
    migrated: int = 0
    blocks_rolled_back: int = 0
    compile_source: str = ""
    ok: bool = True

    @property
    def total_s(self) -> float:
        return sum(self.timings.values())

    def cost_inputs(self) -> Dict[str, float]:
        """Measured inputs for the fleet RecoveryArbiter's cost model:
        the downtime this revive actually cost, split into the terms the
        arbiter's estimates are built from."""
        return {
            "total_s": self.total_s,
            "weights_s": self.timings.get("generator", 0.0),
            "compile_s": (self.timings.get("compile", 0.0)
                          + self.timings.get("read_cache", 0.0)),
            "comm_s": (self.timings.get("xccl", 0.0)
                       + self.timings.get("distributed_groups", 0.0)),
            "migrated": float(self.migrated),
        }

    def summary(self) -> str:
        cats = ", ".join(f"{k}={v * 1e3:.1f}ms"
                         for k, v in sorted(self.timings.items()) if v > 0)
        return (f"[{self.scenario}/{self.mode}] total={self.total_s:.3f}s "
                f"migrated={self.migrated} undo={self.blocks_rolled_back} "
                f"compile={self.compile_source} :: {cats}")


class _T:
    def __init__(self, report: RecoveryReport, key: str):
        self.r, self.k = report, key

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        self.r.timings[self.k] = self.r.timings.get(self.k, 0.0) + (
            time.perf_counter() - self.t0)


class RecoveryManager:
    def __init__(self, engine):
        self.engine = engine
        self.policy = engine.ecfg.policy

    # -- pipeline ----------------------------------------------------------------

    def recover(self, event: FaultEvent) -> RecoveryReport:
        eng = self.engine
        report = RecoveryReport(event=event, scenario="?",
                                mode=eng.ecfg.mode)
        if event.action is Action.IGNORE:   # L1/L2
            report.scenario = "benign"
            report.actions.append("logged only (L1/L2)")
            return report

        device = eng.domain.device(event.rank)
        is_attn = "attn" in device.role
        is_moe_weights = (eng.cfg.moe is not None and
                          (("moe" in device.role) or eng.ecfg.mode ==
                           "collocated"))

        # ① isolate: pause inference, terminate only the failed process
        with _T(report, "other"):
            device.alive = False
            failed_dp = None
            failed_moe = None
            for ex in eng.dp_executors:
                if ex.physical_id == event.rank:
                    failed_dp = ex
                    ex.fail_device()
                    ex.terminate_process()
            for mex in eng.moe_executors:
                if mex.physical_id == event.rank:
                    failed_moe = mex
                    mex.fail_device()
            eng.monitor.unregister(event.rank)
            report.actions.append(f"isolated device {event.rank} "
                                  f"({device.role})")

        # ③ block-table + pool recovery on all surviving executors —
        # BEFORE any migration, so streamed KV blocks land on targets
        # whose tables and pools already agree (rollback-then-migrate)
        with _T(report, "other"):
            undone = 0
            for ex in eng.dp_executors:
                if ex.alive and ex.cache is not None:
                    undone += ex.rollback_inflight()
            report.blocks_rolled_back = undone
            report.actions.append(f"rolled back {undone} block ops")

        # ② sequence state recovery (attention ranks).  The failed rank's
        # device memory is gone, so its KV cannot stream: token-replay
        # re-prefill is the (verified) fallback here.
        if failed_dp is not None and is_attn:
            with _T(report, "other"):
                reqs = failed_dp.scheduler.drain()
                report.migrated = self._migrate(reqs, exclude=failed_dp)
                report.actions.append(
                    f"migrated {report.migrated} sequences "
                    f"(partial recomputation)")

        # ④ weight integrity
        if is_moe_weights and failed_moe is not None or (
                is_moe_weights and eng.ecfg.mode == "collocated"
                and failed_dp is not None):
            plan = self._recover_moe_weights(event, report,
                                             failed_dp, failed_moe)
            report.moe_plan = plan
            report.scenario = ("moe+" + plan.kind.value) if plan else "attn"
        else:
            report.scenario = "attn"

        # ⑤ recreate communications with compacted ranks
        with _T(report, "xccl"):
            rec = eng.domain.rebuild()
            report.actions.append(
                f"comm domain v{rec['version']} rebuilt; rank changes: "
                f"{rec['rank_changes']}")
        with _T(report, "distributed_groups"):
            # torch-group analogue: world group intact, subgroups reassigned
            eng.world_group = [ex.physical_id for ex in eng.dp_executors
                               if ex.alive] + \
                              [m.physical_id for m in eng.moe_executors
                               if m.device_alive]

        # ⑥ cached graph compilation for the new domain version
        with _T(report, "read_cache"):
            pass  # timed inside get_or_compile; split below
        key_hit_before = ("decode", eng.domain.version, None) in eng.graph_cache
        t0 = time.perf_counter()
        eng.get_compiled("decode")
        tm = eng.graph_cache.timings[-1]
        report.compile_source = tm.source
        report.timings["read_cache"] = report.timings.get(
            "read_cache", 0.0) + tm.read_cache_s
        report.timings["compile"] = report.timings.get(
            "compile", 0.0) + tm.compile_s
        leftover = (time.perf_counter() - t0) - tm.read_cache_s - tm.compile_s
        report.timings["other"] = report.timings.get("other", 0.0) + max(
            leftover, 0.0)
        report.actions.append(
            f"graph for domain v{eng.domain.version}: {tm.source} "
            f"(precompiled hit={key_hit_before})")

        # resume + integrity check
        with _T(report, "other"):
            if eng.cfg.moe is not None:
                checks, alive = eng.expert_integrity()
                report.actions.append(
                    f"expert shards alive={alive}")
        return report

    # -- helpers ----------------------------------------------------------------------

    def _migrate(self, reqs, exclude) -> int:
        """Re-home sequences onto healthy ranks: the source device is
        dead, so each re-prefills there (partial recomputation, §3.2).
        Returns the number migrated."""
        eng = self.engine
        healthy = {ex.dp_rank: ex.scheduler.num_requests
                   for ex in eng.dp_executors
                   if ex.alive and ex.cache is not None and ex is not exclude}
        live = [r for r in reqs if r.state != RequestState.FINISHED]
        if not live:
            return 0
        for req, rank in plan_migration(live, healthy):
            prepare_for_migration(req)
            req.dp_rank = rank
            target = next(ex for ex in eng.dp_executors
                          if ex.dp_rank == rank)
            target.scheduler.add_request(req)
        return len(live)

    def _recover_moe_weights(self, event, report, failed_dp, failed_moe
                             ) -> Optional[MoERecoveryPlan]:
        eng = self.engine
        emap = eng.expert_map
        failed_ep_rank = (failed_moe.ep_rank if failed_moe is not None
                          else failed_dp.ep_rank)
        if failed_ep_rank is None:
            return None
        with _T(report, "other"):
            affected = emap.fail_rank(failed_ep_rank)
            report.actions.append(
                f"EP rank {failed_ep_rank} lost (experts {affected[:8]}"
                f"{'...' if len(affected) > 8 else ''})")
            donor = self._pick_donor(exclude_pid=event.rank)
        plan = plan_moe_recovery(emap, self.policy, donor)

        if plan.kind is MoERecoveryKind.REDUNDANT_EXPERTS:
            with _T(report, "other"):
                eng.runtime = emap.runtime()
                eng.reassemble_params()
                report.actions.append(
                    "dropped dead replicas from logical-to-physical map")

        elif plan.kind is MoERecoveryKind.MISSING_EXPERTS:
            with _T(report, "other"):
                emap.mask_experts(plan.lost_logicals)
                eng.runtime = emap.runtime()
                eng.reassemble_params()
                report.actions.append(
                    f"masked {len(plan.lost_logicals)} lost experts in the "
                    f"gating function" +
                    (" [accuracy warning: EP < threshold]"
                     if plan.accuracy_warning else ""))

        elif plan.kind is MoERecoveryKind.ROLE_SWITCH:
            raise NotImplementedError(
                "role switch (disaggregated mode) is queued: ROADMAP "
                "Queue 1, disaggregated mode with MoEExecutor")

        # first-k dense FFN layers (§3.4): a shard lost and not recovered
        # compromises its TP group; attention rebalances tokens over the
        # healthy groups
        if eng.dense_groups is not None:
            with _T(report, "other"):
                group = failed_ep_rank % eng.dense_groups.num_groups
                if eng.dense_groups.alive[group]:
                    eng.dense_groups.fail_shard(group)
                w = eng.dense_groups.routing_weights()
                report.actions.append(
                    f"dense-FFN TP group {group} compromised; token "
                    f"routing rebalanced to {w}")
        return plan

    def _pick_donor(self, exclude_pid: int) -> Optional[int]:
        """A healthy DP rank that could switch to MoE duty (needs >=2
        attention ranks left so attention service continues)."""
        eng = self.engine
        if eng.ecfg.mode != "disaggregated":
            return None
        healthy = [ex for ex in eng.dp_executors
                   if ex.alive and ex.cache is not None
                   and ex.physical_id != exclude_pid]
        if len(healthy) < 2:
            return None
        # least loaded donor
        return min(healthy, key=lambda e: e.scheduler.num_requests).dp_rank
