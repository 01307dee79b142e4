"""Cluster router: N engine instances, continuous admission, arbitration.

The router is the gateway: it owns the authoritative record of every
request (prompt + tokens streamed back so far), routes new arrivals to
the least-loaded serving instance, and executes the
:class:`~repro_torch.fleet.arbiter.RecoveryArbiter`'s per-fault decisions —
in-place revive, drain-and-restart, or spare substitution with live
request migration.

Virtual clock
=============
Everything runs in one process, so a naive wall clock would charge one
instance's restart stall to the whole fleet.  Instead the fleet advances
a *virtual clock*: each tick, all available instances step once
(lockstep, as a real fleet would concurrently) and the clock advances by
the longest measured step.  Recovery stalls are converted into
per-instance *freezes* — measured wall seconds during which only that
instance skips ticks — which is exactly the semantics of a real fleet
where the wounded instance is unavailable while its peers keep serving.
TTFT/goodput are therefore measured on a clock where revive, restart and
spare substitution penalize only the instance that pays them.

Virtual *costs* (chaos campaigns): with a ``cost_profile`` the clock
stops measuring wall time and instead charges pinned per-action costs
(step, revive, restart, spare swap + per-token/per-block migration
terms).  Recovery mechanics still really execute — revive revives,
spares substitute, requests migrate token-exactly — but every duration
fed to the clock, the cost model and the forensics log is a pure
function of the campaign seed, which is what makes campaign forensics
byte-reproducible.

Degradation: when a fault burst leaves a model with no serving instance
(spares dry, hosts gone), arrivals queue in a bounded router backlog
with backpressure instead of being routed to a dead instance, and
:meth:`fleet_health` surfaces a ``degraded``/``critical`` state until
capacity returns (spare joins, host rebuild, or evict-and-rebalance of
an instance serving another model).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from repro_torch.fleet.arbiter import ArbiterDecision, CostModel, RecoveryArbiter
from repro_torch.fleet.instance import FleetInstance, InstanceState
from repro_torch.fleet.spares import SparePool
from repro_torch.serving.request import Request, RequestState

_MIN_TICK_S = 1e-4


@dataclass
class FleetHealth:
    """Fleet-level health surface (the per-instance analogue is
    :class:`~repro_torch.serving.engine.InstanceHealth`)."""
    state: str                   # 'healthy' | 'degraded' | 'critical'
    serving: int                 # serving-or-draining instances
    accepting: int               # instances taking new admissions
    backlog: int                 # arrivals queued at the gateway
    shed: int                    # arrivals rejected by backpressure
    spares_available: int
    frozen: int                  # instances currently paying a stall
    starved_models: List[str] = field(default_factory=list)
    # models with zero accepting instances (requests for them backlog)


class FleetRouter:
    # prefix-affinity knobs: each arrival is keyed under a ladder of
    # leading-prefix lengths (longest match wins on lookup), so prompts
    # sharing a system prefix shorter than the longest key — but
    # diverging after it — still map to a common entry.  The matched
    # arrival sticks to the instance that served the prefix last (its
    # executors hold the shared blocks in their prefix caches), unless
    # that instance is more than AFFINITY_SLACK requests busier than the
    # least-loaded one — cache hits must not create hotspots
    AFFINITY_LENS = (32, 16, 8)
    AFFINITY_SLACK = 4
    _AFFINITY_MAP_MAX = 4096

    def __init__(self, instances: List[FleetInstance], *,
                 spares: Optional[SparePool] = None,
                 arbiter: Optional[RecoveryArbiter] = None,
                 traffic=None, kv_stream: bool = True,
                 prefix_affinity: bool = False,
                 cost_profile=None,
                 rebuilders: Optional[Dict[str, Callable[[int],
                                           FleetInstance]]] = None,
                 max_backlog: int = 256):
        """``kv_stream=False`` forces the token-replay re-prefill path on
        every migration (the verified fallback — used by the fleet_slo
        prefix sweep to measure what streaming saves).
        ``prefix_affinity=True`` routes arrivals with a recently seen
        prompt prefix back to the same instance, so shared-prefix cache
        hits land where the blocks live.
        ``cost_profile`` (a :class:`~repro_torch.fleet.chaos.VirtualCostProfile`
        or anything with its attributes) switches the clock to pinned
        virtual costs — the campaign determinism mode.
        ``rebuilders`` maps model_id -> factory(iid) for evict-and-
        rebalance: when a model loses its last instance, the router may
        repurpose an instance of another model through its factory."""
        if not instances:
            raise ValueError("FleetRouter needs at least one instance")
        from collections import OrderedDict
        self.kv_stream = kv_stream
        self.prefix_affinity = prefix_affinity
        self.cost_profile = cost_profile
        self.rebuilders = rebuilders or {}
        self.max_backlog = max_backlog
        # prefix key -> iid, LRU-bounded: one-off random prefixes age
        # out individually without evicting the hot shared entries
        self._affinity: "OrderedDict" = OrderedDict()
        self.instances: Dict[int, FleetInstance] = {
            i.iid: i for i in instances}
        if len(self.instances) != len(instances):
            raise ValueError("duplicate instance ids")
        self.spares = spares
        self.arbiter = arbiter or RecoveryArbiter(
            CostModel(instances[0].engine.init_timings))
        self.traffic = traffic
        self.now_s = 0.0
        self.ticks = 0
        self.requests: List[Request] = []        # gateway record
        self.meta: Dict[int, Dict] = {}          # req_id -> virtual times
        self.log: List[str] = []
        # failure forensics: one structured entry per executed recovery /
        # planned action, with the decision's counterfactual cost table
        self.forensics: List[Dict] = []
        self.backlog: List[Request] = []         # no-capacity queue
        self.shed_requests = 0                   # backpressure rejections
        self._frozen: Dict[int, float] = {}      # iid -> stall seconds left
        self._cost_events: Dict[str, int] = {}   # policy -> events charged
        self._pending: Dict[int, List[ArbiterDecision]] = {}
        self._report_seen: Dict[int, int] = {}
        self._last_dec: Dict[int, ArbiterDecision] = {}
        self._next_rebuilt_iid = 2000            # evict-and-rebalance ids
        for inst in instances:
            self._enroll(inst)

    # -- membership --------------------------------------------------------------

    def _enroll(self, inst: FleetInstance) -> None:
        self.instances[inst.iid] = inst
        self._report_seen.setdefault(inst.iid, len(inst.engine.reports))
        inst.set_arbitration(self._arbitrate)
        if self.cost_profile is not None:
            inst.engine.virtual_step_s = self.cost_profile.step_s

    def _spare_available(self, model_id: Optional[str] = None) -> bool:
        return (self.spares is not None
                and self.spares.available_for(model_id) > 0)

    def serving(self) -> List[FleetInstance]:
        return [i for i in self.instances.values()
                if i.state in (InstanceState.SERVING,
                               InstanceState.DRAINING)]

    def available(self, inst: FleetInstance) -> bool:
        return (inst.state in (InstanceState.SERVING,
                               InstanceState.DRAINING)
                and self._frozen.get(inst.iid, 0.0) <= 0.0)

    # -- metrics helpers ---------------------------------------------------------

    def _charge_cost(self, policy: str, wall_s: float, *,
                     tokens: int = 0, blocks: int = 0) -> float:
        """Stall seconds to put on the virtual clock for one recovery
        action: the measured wall cost, or the pinned profile cost in
        campaign (deterministic) mode — per-event lognormal-jittered
        when the profile asks for dispersion (still a pure function of
        the profile seed and this action's per-kind sequence number)."""
        p = self.cost_profile
        if p is None:
            return wall_s
        if policy == "revive":
            base = p.revive_s
        elif policy == "restart":
            base = p.restart_s
        else:
            base = (p.spare_swap_s + tokens * p.per_token_prefill_s
                    + blocks * p.per_block_stream_s)
        idx = self._cost_events.get(policy, 0)
        self._cost_events[policy] = idx + 1
        event_cost = getattr(p, "event_cost", None)
        if event_cost is None:          # bare profile (tests use stubs)
            return base
        return event_cost(policy, idx, base)

    def _record(self, inst: FleetInstance, policy: str, charged_s: float,
                *, dec: Optional[ArbiterDecision] = None,
                planned: bool = False, detail: str = "") -> None:
        ev = {
            "seq": len(self.forensics),
            "tick": self.ticks,
            "now_s": round(self.now_s, 6),
            "iid": inst.iid,
            "model_id": inst.model_id,
            "policy": policy,
            "charged_s": round(charged_s, 6),
            "planned": planned,
        }
        if dec is not None:
            ev["decision"] = {
                "policy": dec.policy,
                "reason": dec.reason,
                "proactive": dec.proactive,
                "est_cost_s": {k: round(v, 6)
                               for k, v in sorted(dec.est_cost.items())},
            }
            # counterfactuals: what the untaken actions were priced at
            ev["counterfactual_s"] = {
                k: round(v, 6) for k, v in sorted(dec.est_cost.items())
                if k != policy}
        if detail:
            ev["detail"] = detail
        self.forensics.append(ev)

    # -- admission ----------------------------------------------------------------

    def submit(self, prompt_tokens, max_new_tokens: int = 16, *,
               eos_token=None, arrival_s: Optional[float] = None,
               model_id: Optional[str] = None) -> Request:
        at = self.now_s if arrival_s is None else arrival_s
        targets = [i for i in self.instances.values()
                   if i.accepting and i.serves(model_id)
                   and self._frozen.get(i.iid, 0.0) <= 0.0]
        if not targets:
            # every matching instance stalled/draining: park on the
            # least-loaded serving-or-draining one; it will catch up
            # when unfrozen
            targets = [i for i in self.serving() if i.serves(model_id)]
        if not targets:
            # no serving instance for this model at all: queue at the
            # gateway (degraded) instead of routing to a dead instance
            return self._backlog_submit(prompt_tokens, max_new_tokens,
                                        eos_token, at, model_id)
        inst = self._route(targets, prompt_tokens)
        req = inst.submit(prompt_tokens, max_new_tokens,
                          eos_token=eos_token)
        req.model_id = model_id
        self.requests.append(req)
        self.meta[req.req_id] = {
            "arrival_s": at,
            "first_token_s": None, "finish_s": None,
            "instances": [inst.iid],
        }
        return req

    def _backlog_submit(self, prompt_tokens, max_new_tokens, eos_token,
                        arrival_s: float,
                        model_id: Optional[str]) -> Request:
        req = Request(list(prompt_tokens), max_new_tokens,
                      eos_token=eos_token)
        req.model_id = model_id
        if len(self.backlog) >= self.max_backlog:
            # backpressure: beyond the bound we shed instead of growing
            # an unbounded queue (the client sees an admission error)
            req.state = RequestState.FAILED
            self.shed_requests += 1
            self.requests.append(req)
            self.meta[req.req_id] = {
                "arrival_s": arrival_s, "first_token_s": None,
                "finish_s": None, "instances": [], "shed": True,
            }
            return req
        self.backlog.append(req)
        self.requests.append(req)
        self.meta[req.req_id] = {
            "arrival_s": arrival_s, "first_token_s": None,
            "finish_s": None, "instances": [],
        }
        self.log.append(
            f"[router] no serving instance for "
            f"model={req.model_id or 'any'}: request {req.req_id} "
            f"queued at gateway ({len(self.backlog)} waiting)")
        return req

    def _admit_backlog(self) -> None:
        if not self.backlog:
            return
        still: List[Request] = []
        for req in self.backlog:
            targets = [i for i in self.instances.values()
                       if i.accepting and i.serves(req.model_id)
                       and self._frozen.get(i.iid, 0.0) <= 0.0]
            if not targets:
                still.append(req)
                continue
            inst = self._route(targets, req.prompt_tokens)
            inst.admit(req)
            self.meta[req.req_id]["instances"].append(inst.iid)
        self.backlog = still

    def _route(self, targets: List[FleetInstance],
               prompt_tokens) -> FleetInstance:
        """Least-loaded admission, biased toward prefix affinity: a
        prompt whose leading tokens were recently served by a still-
        available instance goes back there (its BlockManagers hold the
        shared-prefix blocks), unless that instance is overloaded."""
        least = min(targets, key=lambda i: i.load)
        if not self.prefix_affinity:
            return least
        keys = []
        for n in self.AFFINITY_LENS:
            k = tuple(prompt_tokens[:n])
            if k not in keys:                    # short prompts collapse
                keys.append(k)
        hit = None
        for k in keys:                           # longest match wins
            hit = self._affinity.get(k)
            if hit is not None:
                break
        chosen = least
        if hit is not None:
            for inst in targets:
                if (inst.iid == hit
                        and inst.load <= least.load + self.AFFINITY_SLACK):
                    chosen = inst
                    break
        for k in keys:
            while len(self._affinity) >= self._AFFINITY_MAP_MAX:
                self._affinity.popitem(last=False)   # evict LRU keys only
            self._affinity[k] = chosen.iid
            self._affinity.move_to_end(k)
        return chosen

    def _pump(self) -> None:
        if self.traffic is None:
            return
        if self.unfinished == 0 and not self._frozen:
            # fleet idle: discrete-event fast-forward to the next arrival
            # (idle ticks otherwise advance the clock by ~nothing)
            nxt = self.traffic.next_at
            if nxt is not None and nxt > self.now_s:
                self.now_s = nxt
        for a in self.traffic.due(self.now_s):
            self.submit(list(a.prompt_tokens), a.max_new_tokens,
                        arrival_s=a.at_s, model_id=a.model_id)

    # -- arbitration callbacks ------------------------------------------------------

    def _arbitrate(self, inst: FleetInstance, event) -> str:
        dec = self.arbiter.decide(
            inst, event,
            spare_available=self._spare_available(inst.model_id))
        self.log.append(dec.summary())
        self._last_dec[inst.iid] = dec
        if dec.policy == "revive":
            return "revive"
        self._pending.setdefault(inst.iid, []).append(dec)
        return dec.policy

    def lose_instance(self, iid: int, reason: str = "host loss", *,
                      rebuild: bool = True) -> None:
        """Full-instance loss: every device at once.  Revive is off the
        table; the arbiter picks spare substitution or rebuild — either
        way the gateway re-homes the in-flight requests immediately.
        ``rebuild=False`` models capacity that is *gone* (spot
        preemption): no in-place host rebuild — the fleet runs short
        until a spare joins or evict-and-rebalance repurposes another
        model's instance."""
        inst = self.instances[iid]
        if inst.state is InstanceState.DEAD:
            return                        # concurrent loss: already down
        inst.fail_instance(reason)
        dec = self.arbiter.decide(
            inst, None, instance_lost=True,
            spare_available=self._spare_available(inst.model_id))
        self.log.append(dec.summary())
        self._last_dec[inst.iid] = dec
        if dec.policy == "spare":
            self._substitute(inst, reason)
            return
        reqs = inst.export_requests()
        survivors = {i.iid: i for i in self.serving()
                     if i.iid != iid and i.serves(inst.model_id)}
        if survivors:
            from repro_torch.core.migration import plan_migration
            loads = {i.iid: i.load for i in survivors.values()}
            for r, target_iid in plan_migration(reqs, loads):
                survivors[target_iid].admit(r)
                self.meta[r.req_id]["instances"].append(target_iid)
            self.log.append(
                f"[router] re-homed {len(reqs)} requests off lost "
                f"instance {iid}")
            if rebuild:
                elapsed = self._restart_and_charge(inst, dec=dec,
                                                   detail=reason)
                del elapsed
            else:
                inst.decommission(reason)
                self._record(inst, "abandon", 0.0, dec=dec,
                             detail=f"{reason}: capacity lost")
                self._rebalance(inst.model_id)
        elif rebuild:
            # last instance standing for this model: requests must wait
            # out the rebuild
            self._restart_and_charge(inst, dec=dec, detail=reason)
            for r in reqs:
                inst.admit(r)
                self.meta[r.req_id]["instances"].append(inst.iid)
        else:
            # capacity gone and nowhere to re-home: queue the refugees at
            # the gateway; health turns degraded until capacity returns
            inst.decommission(reason)
            for r in reqs:
                r.state = RequestState.WAITING
                self.backlog.append(r)
            self._record(inst, "abandon", 0.0, dec=dec,
                         detail=f"{reason}: {len(reqs)} requests queued")
            self.log.append(
                f"[router] instance {iid} gone ({reason}); "
                f"{len(reqs)} requests queued at gateway")
            self._rebalance(inst.model_id)

    def _restart_and_charge(self, inst: FleetInstance, *,
                            dec: Optional[ArbiterDecision],
                            detail: str = "",
                            planned: bool = False) -> float:
        wall = inst.restart()
        charged = self._charge_cost("restart", wall)
        self.arbiter.cost.observe_restart(charged)
        self._freeze(inst, charged)
        self._record(inst, "restart", charged, dec=dec, planned=planned,
                     detail=detail)
        return charged

    # -- planned faults (advance notice) ----------------------------------------------

    def drain_instance(self, iid: int, *, migrate: bool = True,
                       reason: str = "planned drain") -> int:
        """Advance-notice drain: stop routing new work here and (by
        default) migrate the residents to same-model peers NOW, KV
        blocks streamed — so a planned fault (spot preemption notice,
        rolling upgrade) hits an empty instance instead of aborting
        in-flight work.  Returns how many requests moved."""
        inst = self.instances[iid]
        if inst.state is InstanceState.SERVING:
            inst.state = InstanceState.DRAINING
        if not migrate:
            return 0
        peers = [i for i in self.serving()
                 if i.iid != iid and i.serves(inst.model_id)
                 and i.accepting]
        if not peers:
            self.log.append(
                f"[router] drain {iid}: no peers — residents finish "
                f"in place before the deadline")
            return 0
        exported = inst.export_requests(with_kv=self.kv_stream)
        if not self.kv_stream:
            exported = [(r, None) for r in exported]
        moved = 0
        for r, kv in exported:
            target = min(peers, key=lambda i: i.load)
            target.admit(r, kv=kv)
            self.meta[r.req_id]["instances"].append(target.iid)
            moved += 1
        self._record(inst, "drain", 0.0, planned=True,
                     detail=f"{reason}: {moved} requests migrated ahead "
                            f"of the fault")
        self.log.append(
            f"[router] drained instance {iid} ({reason}): {moved} "
            f"requests migrated with advance notice")
        return moved

    def planned_restart(self, iid: int,
                        reason: str = "rolling upgrade") -> None:
        """A rolling-upgrade step: drain with notice, relaunch, rejoin.
        The stall is paid by an (ideally empty) instance while peers
        absorb its traffic — the cheapest possible 'fault'."""
        self.drain_instance(iid, migrate=True, reason=reason)
        inst = self.instances[iid]
        self._restart_and_charge(inst, dec=None, detail=reason,
                                 planned=True)

    # -- capacity repair ---------------------------------------------------------------

    def _rebalance(self, model_id: str) -> bool:
        """Evict-and-rebalance: ``model_id`` has no serving instance
        left, so repurpose the least-loaded instance of an over-
        provisioned model (>= 2 serving) through the model's rebuilder
        factory.  The donor's residents re-home to its peers first."""
        if model_id not in self.rebuilders:
            return False
        if any(i.serves(model_id) for i in self.serving()):
            return False
        by_model: Dict[str, List[FleetInstance]] = {}
        for i in self.serving():
            if i.state is InstanceState.SERVING:
                by_model.setdefault(i.model_id, []).append(i)
        donors = [i for m, ins in by_model.items()
                  for i in ins if m != model_id and len(ins) >= 2]
        if not donors:
            return False
        donor = min(donors, key=lambda i: i.load)
        peers = [i for i in self.serving()
                 if i.iid != donor.iid and i.serves(donor.model_id)]
        exported = donor.export_requests(with_kv=self.kv_stream)
        if not self.kv_stream:
            exported = [(r, None) for r in exported]
        for r, kv in exported:
            target = min(peers, key=lambda i: i.load)
            target.admit(r, kv=kv)
            self.meta[r.req_id]["instances"].append(target.iid)
        donor.decommission(f"evicted: rebalanced to model {model_id}")
        t0 = time.perf_counter()
        fresh = self.rebuilders[model_id](self._next_rebuilt_iid)
        self._next_rebuilt_iid += 1
        wall = time.perf_counter() - t0
        fresh.state = InstanceState.SERVING
        self._enroll(fresh)
        charged = self._charge_cost("restart", wall)
        self._freeze(fresh, charged)
        self._record(fresh, "rebalance", charged, planned=True,
                     detail=f"evicted instance {donor.iid} "
                            f"(model {donor.model_id}) -> "
                            f"model {model_id}")
        self.log.append(
            f"[router] evict-and-rebalance: instance {donor.iid} "
            f"(model {donor.model_id}, {len(exported)} requests "
            f"re-homed) replaced by instance {fresh.iid} serving "
            f"model {model_id}")
        return True

    def _restore_capacity(self) -> None:
        """A model with queued work and zero accepting instances takes
        the next matching warm spare directly — capacity restoration,
        not fault substitution."""
        if self.spares is None or not self.backlog:
            return
        starved = {r.model_id for r in self.backlog
                   if not any(i.accepting and i.serves(r.model_id)
                              for i in self.instances.values())}
        for model_id in sorted(starved, key=lambda m: m or ""):
            spare = self.spares.acquire(model_id)
            if spare is None:
                continue
            self._enroll(spare)
            self._record(spare, "spare-join", 0.0,
                         detail=f"capacity restored for model "
                                f"{model_id or 'any'}")
            self.log.append(
                f"[router] spare {spare.iid} joined: restores capacity "
                f"for model {model_id or 'any'}")

    # -- policy execution -----------------------------------------------------------

    def _freeze(self, inst: FleetInstance, stall_s: float) -> None:
        self._frozen[inst.iid] = self._frozen.get(inst.iid, 0.0) + stall_s
        self.log.append(f"[router] instance {inst.iid} unavailable "
                        f"{stall_s * 1e3:.0f}ms (virtual)")

    def _substitute(self, inst: FleetInstance, reason: str) -> None:
        spare = (self.spares.acquire(inst.model_id)
                 if self.spares else None)
        if spare is None:                      # pool dry: degrade to restart
            self._restart_and_charge(inst, dec=self._last_dec.get(inst.iid),
                                     detail=f"{reason} (spare pool dry)")
            return
        t0 = time.perf_counter()
        # standby sync (FailSafe): every request whose executor is still
        # reachable streams its live KV blocks to the spare — takeover
        # cost is a block copy, flat in prefix length; the rest (on the
        # failed device, or still queued) re-prefill from token replay
        exported = inst.export_requests(with_kv=self.kv_stream)
        if not self.kv_stream:
            exported = [(r, None) for r in exported]
        streamed_tokens = replay_tokens = streamed_blocks = 0
        for r, kv in exported:
            spare.admit(r, kv=kv)
            self.meta[r.req_id]["instances"].append(spare.iid)
            # the install is all-or-nothing: a streamed request is RUNNING
            # on arrival, a fallback-to-replay one re-enters WAITING — so
            # the cost feedback reflects what actually happened
            if kv is not None and r.state is RequestState.RUNNING:
                streamed_tokens += kv.tokens_streamed
                streamed_blocks += kv.num_blocks
            else:
                replay_tokens += r.num_tokens
        wall = time.perf_counter() - t0
        charged = self._charge_cost("spare", wall, tokens=replay_tokens,
                                    blocks=streamed_blocks)
        self.arbiter.cost.observe_spare(charged, replay_tokens,
                                        streamed_blocks)
        self._freeze(spare, charged)
        inst.decommission(reason)
        self._enroll(spare)
        self._record(spare, "spare", charged,
                     dec=self._last_dec.get(inst.iid),
                     detail=f"substituted for {inst.iid}: "
                            f"{streamed_blocks} blocks streamed, "
                            f"{replay_tokens} tokens replayed")
        self.log.append(
            f"[router] spare {spare.iid} substituted for {inst.iid} "
            f"({len(exported)} requests: {streamed_tokens} tokens / "
            f"{streamed_blocks} blocks KV-streamed, {replay_tokens} "
            f"tokens to re-prefill, swap {charged * 1e3:.1f}ms)")

    def _execute(self, inst: FleetInstance, dec: ArbiterDecision) -> None:
        if dec.policy == "restart":
            self._restart_and_charge(inst, dec=dec)
        elif dec.policy == "spare":
            self._substitute(
                inst, dec.reason if dec.proactive else "fault: substituted")
        else:
            raise ValueError(f"unexpected deferred policy {dec.policy!r}")

    # -- main loop -------------------------------------------------------------------

    def tick(self) -> List[Request]:
        """One fleet step: admit due traffic, step every available
        instance in lockstep, execute deferred recovery decisions, and
        advance the virtual clock by the longest measured step."""
        self.ticks += 1
        self._pump()
        self._restore_capacity()
        self._admit_backlog()
        finished: List[Request] = []
        step_durs = [0.0]
        for inst in list(self.instances.values()):
            if not self.available(inst):
                continue
            pre = self._report_seen.get(inst.iid, 0)
            t0 = time.perf_counter()
            finished.extend(inst.step())
            dt = time.perf_counter() - t0
            # inline revive stalls charge the instance, not the fleet
            revive_s = 0.0
            reports = inst.engine.reports
            for rep in reports[pre:]:
                if rep.scenario == "benign":
                    continue
                charged = self._charge_cost("revive", rep.total_s)
                if self.cost_profile is None:
                    self.arbiter.cost.observe_revive(rep.cost_inputs())
                else:
                    self.arbiter.cost.observe_revive({"total_s": charged})
                revive_s += charged
                self._record(inst, "revive", charged,
                             dec=self._last_dec.get(inst.iid),
                             detail=rep.scenario)
            self._report_seen[inst.iid] = len(reports)
            if revive_s > 0.0:
                self._freeze(inst, revive_s)
                self.log.append(
                    f"[router] instance {inst.iid} revived in place "
                    f"({revive_s * 1e3:.0f}ms)")
            if self.cost_profile is not None:
                dt = (self.cost_profile.step_s
                      if inst.engine.unfinished else _MIN_TICK_S)
                step_durs.append(dt)
            else:
                step_durs.append(max(0.0, dt - revive_s))
            for dec in self._pending.pop(inst.iid, []):
                self._execute(inst, dec)
        for inst in self.serving():
            if not self.available(inst):
                continue
            dec = self.arbiter.consider_soft(
                inst, spare_available=self._spare_available(inst.model_id))
            if dec is not None:
                self.log.append(dec.summary())
                self._last_dec[inst.iid] = dec
                if dec.policy == "spare":
                    self._substitute(inst, "straggler: substituted")
        # background capacity repair: rebuild at most one consumed
        # standby per tick.  Provisioning happens on a fresh host, off
        # the serving path — it consumes wall time here (we are one
        # process) but no *virtual* time: serving instances are unfrozen
        # and the clock advances by their step durations only.
        if self.spares is not None:
            built = self.spares.maybe_replenish()
            if built is not None:
                self.log.append(
                    f"[router] spare pool replenished: instance "
                    f"{built.iid} warm "
                    f"({self.spares.available}/{self.spares.target_size})")
        inc = max(max(step_durs), _MIN_TICK_S)
        # discrete-event fast-forward: if every available instance is
        # idle but work is parked behind a freeze (e.g. a restarting
        # instance's queue), jump to the earliest unfreeze — wall time
        # passes while a host rebuilds, even when nothing else computes
        if self._frozen:
            idle = all(i.engine.unfinished == 0
                       for i in self.instances.values()
                       if self.available(i))
            if idle:
                jump = min(self._frozen.values())
                if self.traffic is not None \
                        and not self.traffic.exhausted:
                    jump = min(jump, max(
                        self.traffic.next_at - self.now_s, 0.0))
                inc = max(inc, jump)
        self.now_s += inc
        for iid in list(self._frozen):
            self._frozen[iid] -= inc
            if self._frozen[iid] <= 0.0:
                del self._frozen[iid]
        self._note_progress()
        return finished

    def _note_progress(self) -> None:
        for r in self.requests:
            m = self.meta[r.req_id]
            if m["first_token_s"] is None and r.output_tokens:
                m["first_token_s"] = self.now_s
            if m["finish_s"] is None and r.state is RequestState.FINISHED:
                m["finish_s"] = self.now_s

    @property
    def unfinished(self) -> int:
        return sum(1 for r in self.requests
                   if r.state not in (RequestState.FINISHED,
                                      RequestState.FAILED))

    def run(self, max_ticks: int = 2000) -> List[Request]:
        """Tick until the traffic source is exhausted and every request
        finished (or max_ticks)."""
        done: List[Request] = []
        for _ in range(max_ticks):
            done.extend(self.tick())
            drained = self.traffic is None or self.traffic.exhausted
            if drained and not self.unfinished:
                break
        return done

    # -- metrics ---------------------------------------------------------------------

    def ttfts(self) -> List[float]:
        return [m["first_token_s"] - m["arrival_s"]
                for m in self.meta.values()
                if m["first_token_s"] is not None]

    def slo_rows(self) -> List[Dict]:
        """Per-request rows for the SLO-burn scorer: arrival / first
        token / finish on the virtual clock, plus decoded-token count."""
        rows = []
        n_out = {r.req_id: len(r.output_tokens) for r in self.requests}
        for req_id, m in self.meta.items():
            rows.append({
                "arrival_s": m["arrival_s"],
                "first_token_s": m["first_token_s"],
                "finish_s": m["finish_s"],
                "n_out": n_out.get(req_id, 0),
            })
        return rows

    def fleet_health(self) -> FleetHealth:
        serving = self.serving()
        accepting = [i for i in self.instances.values() if i.accepting]
        models = {i.model_id for i in self.instances.values()}
        models |= {r.model_id for r in self.backlog
                   if r.model_id is not None}
        starved = sorted(
            m for m in models if m is not None
            and not any(i.accepting and i.serves(m)
                        for i in self.instances.values()))
        if not serving:
            state = "critical"
        elif (self.backlog or starved
              or any(self._frozen.get(i.iid, 0.0) > 0.0 for i in serving)
              # a revived instance serving with masked experts or a DP
              # rank down is degraded capacity, not healthy capacity —
              # the serving front end surfaces this distinction
              or any(i.health().degraded for i in serving)):
            state = "degraded"
        else:
            state = "healthy"
        return FleetHealth(
            state=state, serving=len(serving), accepting=len(accepting),
            backlog=len(self.backlog), shed=self.shed_requests,
            spares_available=(self.spares.available
                              if self.spares else 0),
            frozen=sum(1 for v in self._frozen.values() if v > 0.0),
            starved_models=starved)
