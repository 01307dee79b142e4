"""Chaos campaign driver: seeded fleet-scale fault schedules.

A *campaign* is a long randomized fault schedule — correlated rack
losses, cascading stragglers, flapping links, spot-preemption waves,
rolling upgrades — layered onto a diurnal traffic trace and replayed
against a live fleet.  The campaign is scored by **SLO-burn** (the
integral of windowed p99 TTFT/TPOT excess over target: how much SLO was
burned, for how long) and emits a *failure-forensics* document: per
recovery, the arbiter's decision, the cost actually charged, and the
counterfactual prices of the actions it did not take — so "arbiter vs
forced revive/restart/spare-only" is a first-class comparison rather
than a number to eyeball.

Determinism contract: a campaign is a pure function of
``(schedule seed, traffic seed, fleet composition, VirtualCostProfile)``.
The profile pins every duration the virtual clock, the cost model and
the forensics log ever see (wall time never enters), so the same seed
produces a byte-identical forensics JSON — the reproducibility gate CI
enforces nightly.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.fault_codes import ErrorType, Severity
from repro_torch.fleet.arbiter import CostModel
from repro_torch.fleet.instance import InstanceState
from repro_torch.fleet.router import FleetRouter

# -- deterministic virtual costs --------------------------------------------------


@dataclass(frozen=True)
class VirtualCostProfile:
    """Pinned per-action durations for campaign mode.

    With a profile installed on the router, the virtual clock charges
    these instead of wall measurements: recovery mechanics still really
    execute (revive revives, spares substitute, KV blocks stream), but
    every second on the clock — and every observation fed to the
    measurement-driven :class:`~repro_torch.fleet.arbiter.CostModel` — is a
    deterministic function of the campaign seed.  The defaults keep the
    paper's ordering: revive ≪ spare swap ≪ restart.

    ``jitter`` > 0 replaces each *recovery* charge (revive / restart /
    spare swap — not the step clock) with a seeded lognormal draw
    around its base: ``base * LogNormal(0, jitter)`` from an rng keyed
    on ``(jitter_seed, action kind, per-kind event index)``.  Costs
    stay a pure function of the profile — the same seed replays a
    byte-identical forensics document — but the arbiter now trains its
    cost model against dispersed observations instead of constants.
    ``jitter=0`` (default) reproduces the constant-cost behavior
    exactly."""
    step_s: float = 0.02               # one engine step (decode tick)
    revive_s: float = 0.03             # in-place revive stall
    restart_s: float = 2.5             # full instance relaunch
    spare_swap_s: float = 0.05         # control-plane substitution
    per_token_prefill_s: float = 2e-4  # token-replay re-prefill rate
    per_block_stream_s: float = 2e-5   # KV-block streaming rate
    jitter: float = 0.0                # lognormal sigma on recovery costs
    jitter_seed: int = 0

    # stable kind ids: part of the determinism contract (renumbering
    # would silently change every jittered campaign)
    _KIND_IDS = {"revive": 0, "restart": 1, "spare": 2}

    def event_cost(self, kind: str, index: int, base_s: float) -> float:
        """The charge for the ``index``-th recovery of ``kind``: the
        pinned base, scaled by this event's seeded lognormal draw when
        jitter is on.  Rounded so forensics stay byte-comparable."""
        if self.jitter <= 0.0:
            return base_s
        rng = np.random.default_rng(
            [self.jitter_seed, self._KIND_IDS.get(kind, 3), index])
        return round(base_s * float(rng.lognormal(0.0, self.jitter)), 6)

    def cost_model(self, **kw) -> CostModel:
        """A CostModel seeded purely from the profile (no wall-clock
        build timings), so arbiter estimates are campaign-deterministic
        before the first measurement arrives."""
        return CostModel({"restart": self.restart_s},
                         per_token_prefill_s=self.per_token_prefill_s,
                         per_block_stream_s=self.per_block_stream_s,
                         **kw)


# -- schedule ---------------------------------------------------------------------


@dataclass(frozen=True)
class CampaignEvent:
    """One scheduled chaos action, keyed on the fleet's virtual clock."""
    at_s: float
    kind: str          # see CampaignRunner._apply for the dispatch table
    iid: int
    ranks: Tuple[int, ...] = ()
    severity: int = 6
    error_type: str = "hbm_ecc"
    slowdown: float = 1.0              # straggler slowdown ratio
    note: str = ""


def fleet_topology(router: FleetRouter) -> Dict[int, Dict]:
    """Snapshot the fleet's layout for schedule generation: per serving
    instance, its model and the physical ranks of each comm-domain group
    (the 'rack' granularity for correlated loss)."""
    topo: Dict[int, Dict] = {}
    for inst in router.serving():
        groups: Dict[str, List[int]] = {}
        for dev in inst.engine.domain.ranks:
            groups.setdefault(dev.role, []).append(dev.physical_id)
        topo[inst.iid] = {
            "model_id": inst.model_id,
            "groups": {g: sorted(p) for g, p in sorted(groups.items())},
        }
    return topo


class CampaignSchedule:
    """Seeded generator of composable fault processes.

    Each ``.proc(...)`` call layers one process onto the schedule; the
    composition order is part of the seed contract (same seed + same
    composition = same events).  ``build()`` returns the merged,
    time-sorted event list."""

    def __init__(self, seed: int, horizon_s: float):
        if horizon_s <= 0:
            raise ValueError(f"horizon_s must be > 0, got {horizon_s!r}")
        self.seed = seed
        self.horizon_s = horizon_s
        self.rng = np.random.default_rng(seed)
        self.events: List[CampaignEvent] = []

    # -- internals ---------------------------------------------------------------

    def _poisson_times(self, rate_per_s: float,
                       t0: float = 0.0) -> List[float]:
        times, t = [], t0
        while True:
            t += float(self.rng.exponential(1.0 / rate_per_s))
            if t >= self.horizon_s:
                return times
            times.append(t)

    def _pick(self, seq: Sequence):
        return seq[int(self.rng.integers(len(seq)))]

    # -- fault processes ---------------------------------------------------------

    def device_faults(self, topology: Dict[int, Dict], *,
                      rate_per_s: float,
                      severity: int = 6,
                      error_type: str = "hbm_ecc") -> "CampaignSchedule":
        """Background hazard: independent single-device faults across
        the fleet at ``rate_per_s`` (the paper's base failure process)."""
        iids = sorted(topology)
        for t in self._poisson_times(rate_per_s):
            iid = self._pick(iids)
            ranks = [p for g in topology[iid]["groups"].values()
                     for p in g]
            self.events.append(CampaignEvent(
                t, "device_fault", iid, ranks=(self._pick(ranks),),
                severity=severity, error_type=error_type,
                note="background hazard"))
        return self

    def rack_loss(self, topology: Dict[int, Dict], *,
                  rate_per_s: float) -> "CampaignSchedule":
        """Correlated loss: every rank sharing one comm-domain group of
        one instance faults at the same instant (power feed / ToR switch
        takes the whole rack)."""
        iids = sorted(topology)
        for t in self._poisson_times(rate_per_s):
            iid = self._pick(iids)
            group = self._pick(sorted(topology[iid]["groups"]))
            ranks = tuple(topology[iid]["groups"][group])
            self.events.append(CampaignEvent(
                t, "rack_loss", iid, ranks=ranks,
                note=f"rack={group}"))
        return self

    def cascading_stragglers(self, topology: Dict[int, Dict], *,
                             start_s: float, spacing_s: float,
                             n: int = 3, slowdown: float = 4.0,
                             duration_s: float = 5.0
                             ) -> "CampaignSchedule":
        """A slow device every ``spacing_s`` on successive instances —
        the creeping-degradation shape that only soft signals catch.
        Each straggler clears after ``duration_s``."""
        iids = sorted(topology)
        for k in range(n):
            t = start_s + k * spacing_s
            if t >= self.horizon_s:
                break
            iid = iids[k % len(iids)]
            ranks = [p for g in topology[iid]["groups"].values()
                     for p in g]
            rank = self._pick(ranks)
            self.events.append(CampaignEvent(
                t, "straggler", iid, ranks=(rank,), slowdown=slowdown,
                note=f"cascade {k + 1}/{n}"))
            self.events.append(CampaignEvent(
                min(t + duration_s, self.horizon_s), "straggler_clear",
                iid, ranks=(rank,), note=f"cascade {k + 1}/{n} over"))
        return self

    def flapping_link(self, topology: Dict[int, Dict], *,
                      start_s: float, n_flaps: int = 3,
                      down_s: float = 2.0,
                      up_s: float = 4.0) -> "CampaignSchedule":
        """One rank's link faults, clears, re-faults ``n_flaps`` times —
        the transient shape where the device should *rejoin* after each
        clear instead of staying isolated."""
        iids = sorted(topology)
        iid = self._pick(iids)
        ranks = [p for g in topology[iid]["groups"].values() for p in g]
        rank = self._pick(ranks)
        t = start_s
        for k in range(n_flaps):
            if t >= self.horizon_s:
                break
            self.events.append(CampaignEvent(
                t, "device_fault", iid, ranks=(rank,), severity=4,
                error_type="link_down", note=f"flap {k + 1}/{n_flaps}"))
            t_clear = min(t + down_s, self.horizon_s)
            self.events.append(CampaignEvent(
                t_clear, "fault_clear", iid, ranks=(rank,),
                note=f"flap {k + 1}/{n_flaps} cleared"))
            t = t_clear + up_s
        return self

    def spot_wave(self, topology: Dict[int, Dict], *,
                  at_s: float, n_instances: int = 1,
                  notice_s: float = 5.0) -> "CampaignSchedule":
        """Spot-preemption wave: ``n_instances`` whole hosts disappear at
        ``at_s``, each with ``notice_s`` of advance notice (the cloud's
        two-minute warning) — a *planned* fault the router should drain,
        not abort."""
        iids = sorted(topology)
        victims = list(self.rng.choice(
            iids, size=min(n_instances, len(iids)), replace=False))
        for iid in victims:
            t_notice = max(0.0, at_s - notice_s)
            self.events.append(CampaignEvent(
                t_notice, "spot_notice", int(iid),
                note=f"preemption at t={at_s:g}s"))
            self.events.append(CampaignEvent(
                at_s, "spot_preempt", int(iid), note="capacity lost"))
        return self

    def rolling_upgrade(self, topology: Dict[int, Dict], *,
                        start_s: float,
                        spacing_s: float) -> "CampaignSchedule":
        """Planned maintenance: every instance restarts once, one at a
        time, ``spacing_s`` apart — drain first, relaunch, rejoin."""
        for k, iid in enumerate(sorted(topology)):
            t = start_s + k * spacing_s
            if t >= self.horizon_s:
                break
            self.events.append(CampaignEvent(
                t, "upgrade", iid, note=f"rolling upgrade {k + 1}"))
        return self

    def instance_loss(self, topology: Dict[int, Dict], *,
                      rate_per_s: float) -> "CampaignSchedule":
        """Unplanned whole-host losses (kernel panic, fabric partition):
        rebuildable in place, but every in-flight request must re-home."""
        iids = sorted(topology)
        for t in self._poisson_times(rate_per_s):
            self.events.append(CampaignEvent(
                t, "instance_loss", self._pick(iids), note="host loss"))
        return self

    def build(self) -> List[CampaignEvent]:
        return sorted(self.events, key=lambda e: (e.at_s, e.iid, e.kind))


# -- SLO-burn scoring -------------------------------------------------------------


def _quantile(xs: List[float], q: float) -> float:
    """Nearest-rank-with-interpolation quantile (numpy-free of dtype
    surprises; deterministic)."""
    if not xs:
        return 0.0
    s = sorted(xs)
    pos = q * (len(s) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)


def slo_burn(rows: List[Dict], *, ttft_target_s: float,
             tpot_target_s: Optional[float] = None,
             window_s: float = 10.0, q: float = 0.99,
             horizon_s: Optional[float] = None) -> Dict:
    """Integral of windowed p99 latency excess over target.

    ``rows`` come from :meth:`FleetRouter.slo_rows`.  Requests are
    bucketed by arrival into ``window_s`` windows; per window the p99
    TTFT (and TPOT, if targeted) is compared against target and the
    excess integrates as ``burn += max(0, p99 - target) * window_s``.
    A request that never produced a token (shed, or starved past the
    horizon) is censored at the horizon — it burns, maximally, instead
    of silently dropping out of the percentile."""
    if not rows:
        return {"ttft_burn_s": 0.0, "tpot_burn_s": 0.0,
                "total_burn_s": 0.0, "windows": [], "n_unserved": 0}
    end = horizon_s if horizon_s is not None else max(
        (r["finish_s"] or r["first_token_s"] or r["arrival_s"])
        for r in rows)
    end = max(end, max(r["arrival_s"] for r in rows) + 1e-9)
    n_win = max(1, int(np.ceil(end / window_s)))
    buckets: List[List[Dict]] = [[] for _ in range(n_win)]
    n_unserved = 0
    for r in rows:
        w = min(int(r["arrival_s"] / window_s), n_win - 1)
        buckets[w].append(r)
        if r["first_token_s"] is None:
            n_unserved += 1
    windows = []
    ttft_burn = tpot_burn = 0.0
    for w, bucket in enumerate(buckets):
        if not bucket:
            continue
        ttfts = [((r["first_token_s"] if r["first_token_s"] is not None
                   else end) - r["arrival_s"]) for r in bucket]
        p_ttft = _quantile(ttfts, q)
        w_ttft = max(0.0, p_ttft - ttft_target_s) * window_s
        ttft_burn += w_ttft
        row = {"window": w, "t0_s": round(w * window_s, 6),
               "n": len(bucket), "p99_ttft_s": round(p_ttft, 6),
               "ttft_burn_s": round(w_ttft, 6)}
        if tpot_target_s is not None:
            tpots = []
            for r in bucket:
                if (r["finish_s"] is not None
                        and r["first_token_s"] is not None
                        and r["n_out"] > 1):
                    tpots.append((r["finish_s"] - r["first_token_s"])
                                 / (r["n_out"] - 1))
            p_tpot = _quantile(tpots, q)
            w_tpot = max(0.0, p_tpot - tpot_target_s) * window_s
            tpot_burn += w_tpot
            row["p99_tpot_s"] = round(p_tpot, 6)
            row["tpot_burn_s"] = round(w_tpot, 6)
        windows.append(row)
    return {
        "ttft_burn_s": round(ttft_burn, 6),
        "tpot_burn_s": round(tpot_burn, 6),
        "total_burn_s": round(ttft_burn + tpot_burn, 6),
        "windows": windows,
        "n_unserved": n_unserved,
    }


# -- runner -----------------------------------------------------------------------


@dataclass
class CampaignResult:
    burn: Dict
    forensics: Dict
    events_applied: int = 0
    events_skipped: int = 0
    ticks: int = 0


_SEVERITIES = {s.value: s for s in Severity}
_ERROR_TYPES = {e.value: e for e in ErrorType}


class CampaignRunner:
    """Replays a built schedule against a live router on the virtual
    clock: each tick, every event whose time has come is applied, then
    the fleet steps.  When the fleet is idle but events remain, the
    clock fast-forwards to the next event (discrete-event semantics,
    same as the router's own idle fast-forward)."""

    def __init__(self, router: FleetRouter,
                 events: Sequence[CampaignEvent], *,
                 seed: Optional[int] = None,
                 profile: Optional[VirtualCostProfile] = None,
                 ttft_target_s: float = 1.0,
                 tpot_target_s: Optional[float] = None,
                 slo_window_s: float = 10.0,
                 max_ticks: int = 50000):
        self.router = router
        self.pending = sorted(events, key=lambda e: (e.at_s, e.iid,
                                                     e.kind))
        self.seed = seed
        self.profile = profile or router.cost_profile
        self.ttft_target_s = ttft_target_s
        self.tpot_target_s = tpot_target_s
        self.slo_window_s = slo_window_s
        self.max_ticks = max_ticks
        self.applied: List[Dict] = []
        self.skipped = 0

    # -- event application -------------------------------------------------------

    def _step_base_s(self) -> float:
        return self.profile.step_s if self.profile is not None else 0.05

    def _apply(self, ev: CampaignEvent) -> bool:
        r = self.router
        inst = r.instances.get(ev.iid)
        if inst is None or inst.state is InstanceState.DEAD:
            return False          # target already gone: the event is moot
        eng = inst.engine
        if ev.kind in ("device_fault", "rack_loss"):
            sev = _SEVERITIES.get(ev.severity, Severity.L6)
            err = _ERROR_TYPES.get(ev.error_type, ErrorType.HBM_ECC)
            for rank in ev.ranks:
                eng.injector.schedule(eng.step_no + 1, rank,
                                      severity=sev, error_type=err)
        elif ev.kind == "fault_clear":
            for rank in ev.ranks:
                eng.injector.clear(rank)
                eng.rejoin_device(rank)
        elif ev.kind == "straggler":
            extra = (ev.slowdown - 1.0) * self._step_base_s()
            for ex in eng.dp_executors:
                if ex.physical_id in ev.ranks and ex.alive:
                    ex.simulated_slowdown_s = extra
        elif ev.kind == "straggler_clear":
            for ex in eng.dp_executors:
                if ex.physical_id in ev.ranks:
                    ex.simulated_slowdown_s = 0.0
        elif ev.kind == "spot_notice":
            r.drain_instance(ev.iid, migrate=True,
                             reason="spot preemption notice")
        elif ev.kind == "spot_preempt":
            r.lose_instance(ev.iid, reason="spot preemption",
                            rebuild=False)
        elif ev.kind == "instance_loss":
            r.lose_instance(ev.iid, reason="host loss")
        elif ev.kind == "upgrade":
            r.planned_restart(ev.iid)
        else:
            raise ValueError(f"unknown campaign event kind {ev.kind!r}")
        return True

    # -- main loop ---------------------------------------------------------------

    def run(self) -> CampaignResult:
        r = self.router
        ticks = 0
        while ticks < self.max_ticks:
            while self.pending and self.pending[0].at_s <= r.now_s:
                ev = self.pending.pop(0)
                ok = self._apply(ev)
                if ok:
                    self.applied.append({
                        "at_s": round(ev.at_s, 6),
                        "fired_s": round(r.now_s, 6),
                        "kind": ev.kind, "iid": ev.iid,
                        "ranks": list(ev.ranks), "note": ev.note,
                    })
                else:
                    self.skipped += 1
            r.tick()
            ticks += 1
            drained = r.traffic is None or r.traffic.exhausted
            idle = drained and not r.unfinished and not r._frozen
            if idle:
                if not self.pending:
                    break
                # dead air before the next scheduled event: jump to it
                r.now_s = max(r.now_s, self.pending[0].at_s)
        burn = slo_burn(r.slo_rows(), ttft_target_s=self.ttft_target_s,
                        tpot_target_s=self.tpot_target_s,
                        window_s=self.slo_window_s)
        return CampaignResult(
            burn=burn, forensics=self.forensics(burn),
            events_applied=len(self.applied),
            events_skipped=self.skipped, ticks=ticks)

    # -- forensics ---------------------------------------------------------------

    def forensics(self, burn: Dict) -> Dict:
        """The failure-forensics document.  Every value is derived from
        the virtual clock / pinned cost profile, so with a profile the
        same campaign seed yields a byte-identical document."""
        r = self.router
        by_policy: Dict[str, int] = {}
        for e in r.forensics:
            by_policy[e["policy"]] = by_policy.get(e["policy"], 0) + 1
        health = r.fleet_health()
        return {
            "campaign": {
                "seed": self.seed,
                "profile": (dataclasses.asdict(self.profile)
                            if self.profile is not None else None),
                "ttft_target_s": self.ttft_target_s,
                "tpot_target_s": self.tpot_target_s,
                "slo_window_s": self.slo_window_s,
            },
            "events_applied": self.applied,
            "events_skipped": self.skipped,
            "recoveries": r.forensics,
            "recoveries_by_policy": dict(sorted(by_policy.items())),
            "slo": burn,
            "counters": {
                "requests": len(r.requests),
                "shed": r.shed_requests,
                "backlog_final": len(r.backlog),
                "cross_instance_migrations": sum(
                    req.cross_instance_migrations for req in r.requests),
                "spare_activations": (r.spares.activations
                                      if r.spares else 0),
            },
            "fleet_health_final": {
                "state": health.state,
                "serving": health.serving,
                "accepting": health.accepting,
                "backlog": health.backlog,
                "shed": health.shed,
                "spares_available": health.spares_available,
                "starved_models": health.starved_models,
            },
        }
