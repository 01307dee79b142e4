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

The host logic is ``repro.core.revive``'s.  Sequences on a failed rank
re-prefill on the survivors (token replay).  A role switch (§3.4,
disaggregated mode) moves a healthy donor DP rank to the lost EP rank:
its residents' KV blocks stream to the other attention ranks, and the
lost experts reload from disk into the donor's shard, which the device
bank then copies in.  With ``background_role_switch`` the lost experts
are masked at once and the switch finishes between steps (§4.3,
``complete_background_switch``).

One difference from ``repro``: a background switch hands the reloaded
shard to a new ``MoEExecutor`` on the donor, as the synchronous switch
does.  ``repro`` sets it on the donor's DP executor, where its
disaggregated engine never looks for a shard owner, so the restored
rank's bank slice stays zero while the map routes to it again (ROADMAP
Queue 3).  A second: the reload follows the expert map.  ``repro`` reads
the rank's start-up slots whatever the map says, so after
``rebalance_experts`` its re-pointed slots serve the wrong experts'
weights.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.core.fault_codes import Action, FaultEvent
from repro_torch.core.migration import (charge_replay, plan_migration,
                                        prepare_for_migration)
from repro_torch.core.weights import (MoERecoveryKind, MoERecoveryPlan,
                                      plan_moe_recovery)
from repro_torch.serving.executor import MoEExecutor
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
                report.migrated, _ = self._migrate(reqs, exclude=failed_dp)
                report.actions.append(
                    f"migrated {report.migrated} sequences "
                    f"(partial recomputation)")

        # ④ weight integrity
        role_switch_pid = None
        if is_moe_weights and failed_moe is not None or (
                is_moe_weights and eng.ecfg.mode == "collocated"
                and failed_dp is not None):
            plan = self._recover_moe_weights(event, report,
                                             failed_dp, failed_moe)
            report.moe_plan = plan
            if plan is not None and plan.kind is MoERecoveryKind.ROLE_SWITCH:
                role_switch_pid = eng.dp_executors[
                    plan.donor_rank].physical_id
            report.scenario = ("moe+" + plan.kind.value) if plan else "attn"
        else:
            report.scenario = "attn"

        # ⑤ recreate communications with compacted ranks
        with _T(report, "xccl"):
            rec = eng.domain.rebuild(role_switch_physical=role_switch_pid)
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

    def _migrate(self, reqs, exclude) -> Tuple[int, int]:
        """Re-home sequences onto healthy ranks.  ``reqs`` items are bare
        Requests (token-replay re-prefill: the source device is dead) or
        ``(req, KVBlocks | None)`` pairs from a healthy donor
        (``drop_attention_state(collect_kv=True)``): streamed blocks
        install directly, everything else re-prefills (§3.2).

        Returns ``(migrated, streamed)`` counts."""
        eng = self.engine
        healthy = {ex.dp_rank: ex.scheduler.num_requests
                   for ex in eng.dp_executors
                   if ex.alive and ex.cache is not None and ex is not exclude}
        items = [r if isinstance(r, tuple) else (r, None) for r in reqs]
        live = [(r, kv) for r, kv in items
                if r.state != RequestState.FINISHED]
        if not live:
            return 0, 0
        payloads = {id(r): kv for r, kv in live}
        streamed = 0
        for req, rank in plan_migration([r for r, _ in live], healthy):
            kv = payloads[id(req)]
            prepare_for_migration(req, streamed=kv is not None)
            target = next(ex for ex in eng.dp_executors
                          if ex.dp_rank == rank)
            if kv is not None and target.import_kv_blocks(req, kv):
                streamed += 1
                continue
            if kv is not None:
                charge_replay(req)   # stream install failed: replay
            req.dp_rank = rank
            target.scheduler.add_request(req)
        return len(live), streamed

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

        elif plan.kind is MoERecoveryKind.ROLE_SWITCH and plan.background:
            # §4.3 combined mode: mask the lost experts now (downtime stays
            # at the missing-experts level) and restore full weight
            # integrity between steps
            with _T(report, "other"):
                emap.mask_experts(plan.lost_logicals)
                eng.runtime = emap.runtime()
                eng.reassemble_params()
                eng.pending_switches.append(plan)
                report.actions.append(
                    f"masked {len(plan.lost_logicals)} lost experts; role "
                    f"switch dp{plan.donor_rank} deferred to background")

        elif plan.kind is MoERecoveryKind.ROLE_SWITCH:
            donor_ex = eng.dp_executors[plan.donor_rank]
            with _T(report, "role_switch"):
                # the donor device is healthy: its residents' KV blocks
                # stream to the targets instead of re-prefilling; then it
                # drops its attention duty
                reqs = donor_ex.drop_attention_state(collect_kv=True)
                n, n_streamed = self._migrate(reqs, exclude=donor_ex)
                report.migrated += n
                donor_ex.ep_rank = failed_ep_rank
                report.actions.append(
                    f"role switch: dp{plan.donor_rank} -> moe ep-rank "
                    f"{failed_ep_rank}; migrated {n} of its sequences "
                    f"({n_streamed} KV-streamed)")
            with _T(report, "generator"):
                # the lost experts' only copies are gone: load from disk
                self._reload_rank(donor_ex, failed_ep_rank)
                report.actions.append(
                    f"reloaded EP rank {failed_ep_rank} weights from disk")

        # first-k dense FFN layers (§3.4): a shard lost and not recovered
        # compromises its TP group; attention rebalances tokens over the
        # healthy groups.  A synchronous role switch recovers the shard.
        if eng.dense_groups is not None:
            recovered = (plan.kind is MoERecoveryKind.ROLE_SWITCH
                         and not plan.background)
            if not recovered:
                with _T(report, "other"):
                    group = failed_ep_rank % eng.dense_groups.num_groups
                    if eng.dense_groups.alive[group]:
                        eng.dense_groups.fail_shard(group)
                    w = eng.dense_groups.routing_weights()
                    report.actions.append(
                        f"dense-FFN TP group {group} compromised; token "
                        f"routing rebalanced to {w}")
        return plan

    def _reload_rank(self, donor_ex, ep_rank: int) -> List[int]:
        """Read EP rank ``ep_rank``'s shard from disk, following the map
        (``InferenceEngine._load_rank``), into a new ``MoEExecutor`` on
        the donor's device (only a disaggregated engine has a donor to
        spare), restore the rank's slots in the map and copy the shard
        into the device bank.  Returns the restored experts."""
        eng = self.engine
        shard = eng._load_rank(ep_rank)
        eng.moe_executors.append(MoEExecutor(
            physical_id=donor_ex.physical_id, ep_rank=ep_rank, shard=shard))
        restored = eng.expert_map.install_rank(ep_rank)
        eng.runtime = eng.expert_map.runtime()
        eng.reassemble_params()
        return restored

    def complete_background_switch(self, plan: MoERecoveryPlan) -> Dict:
        """Finish a deferred role switch while service keeps running
        (§4.3): stream the donor's residents away, load the lost shard
        from disk onto the donor, unmask, and restore full weight
        integrity.  Returns stage timings (NOT downtime: inference
        continued throughout)."""
        eng = self.engine
        emap = eng.expert_map
        timings: Dict[str, float] = {}
        donor_ex = eng.dp_executors[plan.donor_rank]
        # the rank whose experts are masked is the one to restore
        failed_ep_rank = next(
            r for r in range(eng.ep_size)
            if any(not emap.slot_alive[s] for s in emap.rank_slots(r)))
        t0 = time.perf_counter()
        reqs = donor_ex.drop_attention_state(collect_kv=True)
        self._migrate(reqs, exclude=donor_ex)
        donor_ex.ep_rank = failed_ep_rank
        timings["role_switch"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        restored = self._reload_rank(donor_ex, failed_ep_rank)
        timings["generator"] = time.perf_counter() - t0
        timings["restored_experts"] = float(len(restored))
        return timings

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
