"""Chaos campaigns on the port's fleet against ``repro.fleet``:
tests/test_chaos.py's fleet scenarios on a torch fleet and a ``repro``
fleet side by side (advance-notice drain, backpressure with spares
exhausted, concurrent instance loss with a rebuild, the backlog draining
when a spare joins, multi-model routing and rebalance, jittered costs),
its mini campaign — whose forensics JSON must be byte-identical to the
reference's — and its pure tests (campaign schedules, the injector's
lifecycle, arbiter boundaries, SLO burn, mixed traffic) against the
port's copies.  Every fleet runs on the pinned ``VirtualCostProfile``,
as tests/test_chaos.py's do.
"""
import json
from types import SimpleNamespace

import numpy as np
import pytest

from test_torch_fleet_cases import (JAX, PROMPT, TORCH, both, fleet_cfg,
                                    fleet_ecfg, fleet_record, make_dirs,
                                    profile)

TOPO = {                                     # tests/test_chaos.py:25
    0: {"model_id": "a", "groups": {"attn": [0, 1], "moe": [2, 3]}},
    1: {"model_id": "a", "groups": {"attn": [0, 1], "moe": [2, 3]}},
    2: {"model_id": "b", "groups": {"attn": [0, 1], "moe": [2, 3]}},
}


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    return make_dirs(tmp_path_factory, "chaos")


def _build(S, wd, instances, prof=None, **kw):
    return S.fleet.build_fleet(fleet_cfg(S), fleet_ecfg(S, wd),
                               instances=instances,
                               cost_profile=prof or profile(S), **kw, **S.kw)


# -- tests/test_chaos.py:251 ------------------------------------------------------

def _drain_with_notice(S, wd):
    fleet = _build(S, wd, 2)
    req = fleet.submit(PROMPT, 12)
    for _ in range(4):
        fleet.tick()
    mid, src = len(req.output_tokens), req.instance_id
    moved = fleet.drain_instance(src, reason="spot notice")
    after = req.instance_id
    fleet.planned_restart(src)
    fleet.run(max_ticks=400)
    return fleet, dict(mid=mid, src=src, moved=moved, after=after)


def test_drain_with_notice_migrates_residents(dirs):
    (jf, jx), (pf, px) = both(dirs, _drain_with_notice)
    assert 0 < px["mid"] < 12 and px["moved"] == 1
    assert px["after"] != px["src"]
    req = pf.requests[0]
    assert req.state.value == "finished"
    assert req.cross_instance_migrations == 1
    kinds = [e["policy"] for e in pf.forensics]
    assert "drain" in kinds and "restart" in kinds
    restart = next(e for e in pf.forensics if e["policy"] == "restart")
    assert restart["planned"] is True
    assert restart["charged_s"] == pytest.approx(profile(TORCH).restart_s)
    assert px == jx
    assert fleet_record(pf) == fleet_record(jf)


# -- tests/test_chaos.py:276 ------------------------------------------------------

def _backpressure(S, wd):
    fleet = _build(S, wd, 2, spares=0, max_backlog=2)
    fleet.submit(PROMPT, 6)
    fleet.tick()
    fleet.lose_instance(0, reason="spot preemption", rebuild=False)
    fleet.lose_instance(1, reason="spot preemption", rebuild=False)
    fleet.lose_instance(1, reason="duplicate loss", rebuild=False)
    health = fleet.fleet_health()
    r2 = fleet.submit(PROMPT, 4)
    r2_state = r2.state.value
    r3 = fleet.submit(PROMPT, 4)
    fleet.tick()
    return fleet, dict(health=(health.state, health.serving,
                               health.backlog), r2=r2_state,
                       r3=r3.state.value)


def test_spare_exhausted_burst_backpressure(dirs):
    (jf, jx), (pf, px) = both(dirs, _backpressure)
    state, serving, backlog = px["health"]
    assert state == "critical" and serving == 0 and backlog >= 1
    assert px["r2"] == "waiting" and px["r3"] == "failed"
    assert pf.shed_requests == 1
    assert pf.fleet_health().state == "critical"
    assert px == jx
    assert fleet_record(pf) == fleet_record(jf)


# -- tests/test_chaos.py:303 ------------------------------------------------------

def _concurrent_loss(S, wd):
    fleet = _build(S, wd, 2)
    fleet.submit(PROMPT, 8)
    fleet.submit(PROMPT, 8)
    for _ in range(3):
        fleet.tick()
    fleet.lose_instance(0, "burst loss 1")
    fleet.lose_instance(1, "burst loss 2")
    fleet.run(max_ticks=600)
    return fleet, {}


def test_concurrent_instance_loss_with_rebuild(dirs):
    """Both instances are restarted (``full_reinit``) while their
    requests re-home: everything finishes, as in the reference."""
    (jf, _), (pf, _) = both(dirs, _concurrent_loss)
    assert all(r.state.value == "finished" for r in pf.requests)
    assert pf.shed_requests == 0
    restarts = [e for e in pf.forensics if e["policy"] == "restart"]
    assert len(restarts) == 2
    for e in restarts:
        assert e["charged_s"] == pytest.approx(profile(TORCH).restart_s)
        assert "counterfactual_s" in e
    assert fleet_record(pf) == fleet_record(jf)


# -- tests/test_chaos.py:327 ------------------------------------------------------

def _spare_joins(S, wd):
    fleet = _build(S, wd, 1, spares=1)
    fleet.submit(PROMPT, 6)
    fleet.tick()
    fleet.lose_instance(0, "host loss", rebuild=False)
    accepting = any(i.accepting for i in fleet.instances.values())
    fleet.run(max_ticks=400)
    return fleet, dict(accepting=accepting)


def test_backlog_drains_when_spare_joins(dirs):
    (jf, jx), (pf, px) = both(dirs, _spare_joins)
    assert px == jx == dict(accepting=True)
    assert pf.requests[0].state.value == "finished"
    assert pf.spares.activations == 1
    assert fleet_record(pf) == fleet_record(jf)


# -- tests/test_chaos.py:343 ------------------------------------------------------

def _multi_model(S, wd):
    cfg, ecfg = fleet_cfg(S), fleet_ecfg(S, wd)
    fleet = S.fleet.build_multi_model_fleet(
        {"alpha": (cfg, ecfg), "beta": (cfg, ecfg)},
        counts={"alpha": 2, "beta": 1}, cost_profile=profile(S),
        rebalance=True, **S.kw)
    beta_iid = next(i.iid for i in fleet.serving() if i.model_id == "beta")
    ra = fleet.submit(PROMPT, 6, model_id="alpha")
    rb = fleet.submit(PROMPT, 6, model_id="beta")
    routed = (fleet.instances[ra.instance_id].model_id, rb.instance_id)
    for _ in range(3):
        fleet.tick()
    fleet.lose_instance(beta_iid, "spot preemption", rebuild=False)
    rebalances = sum(e["policy"] == "rebalance" for e in fleet.forensics)
    beta_back = any(i.model_id == "beta" and i.state.value == "serving"
                    for i in fleet.instances.values())
    fleet.run(max_ticks=600)
    rb2 = fleet.submit(PROMPT, 4, model_id="beta")
    rb2_model = fleet.instances[rb2.instance_id].model_id
    fleet.run(max_ticks=300)
    return fleet, dict(beta_iid=beta_iid, routed=routed,
                       rebalances=rebalances, beta_back=beta_back,
                       rb2_model=rb2_model)


def test_multi_model_routing_and_rebalance(dirs):
    (jf, jx), (pf, px) = both(dirs, _multi_model)
    assert px["routed"] == ("alpha", px["beta_iid"])
    assert px["rebalances"] == 1 and px["beta_back"]
    assert px["rb2_model"] == "beta"
    assert all(r.state.value == "finished" for r in pf.requests)
    assert px == jx
    assert fleet_record(pf) == fleet_record(jf)


# -- tests/test_chaos.py:413, :463 ------------------------------------------------

def _trace_routes(S, wd):
    tr = S.fleet.TraceTraffic([
        S.fleet.Arrival(0.0, tuple(PROMPT), 4, model_id=None),
        S.fleet.Arrival(0.0, tuple(PROMPT), 4, model_id=None)])
    fleet = _build(S, wd, 2, traffic=tr)
    fleet.run(max_ticks=200)
    return fleet, {}


def test_trace_traffic_still_routes_by_model(dirs):
    (jf, _), (pf, _) = both(dirs, _trace_routes)
    assert pf.unfinished == 0 and len(pf.requests) == 2
    assert fleet_record(pf) == fleet_record(jf)


def _jitter_burn(S, wd, jitter):
    prof = S.fleet.VirtualCostProfile(jitter=jitter, jitter_seed=3)
    fleet = _build(S, wd, 2, prof=prof)
    for _ in range(2):
        fleet.submit(list(PROMPT), 4)
        fleet.tick()
    fleet.lose_instance(0, reason="jitter drill")
    fleet.run(max_ticks=60)
    return fleet, [(e["policy"], e["charged_s"]) for e in fleet.forensics]


def test_event_cost_jitter_flows_through_router_charges(dirs):
    (jf, jx), (pf, px) = both(dirs, _jitter_burn, 0.5)
    (_, jflat), (_, pflat) = both(dirs, _jitter_burn, 0.0)
    assert px and px == jx
    assert pflat == jflat
    assert [p for p, _ in pflat] == [p for p, _ in px]
    assert [c for _, c in pflat] != [c for _, c in px]
    assert fleet_record(pf) == fleet_record(jf)


# -- the headline: tests/test_chaos.py:383 ----------------------------------------

def _mini_campaign(S, wd):
    cfg, prof = fleet_cfg(S), S.fleet.VirtualCostProfile()
    traffic = S.fleet.DiurnalTraffic(1.5, cfg.vocab_size, amplitude=0.5,
                                     period_s=20.0, prompt_len=8,
                                     max_new_tokens=6, seed=11, limit=12)
    fleet = S.fleet.build_fleet(cfg, fleet_ecfg(S, wd), instances=2,
                                spares=1, traffic=traffic,
                                cost_profile=prof, **S.kw)
    topo = S.fleet.fleet_topology(fleet)
    events = (S.fleet.CampaignSchedule(seed=9, horizon_s=20.0)
              .instance_loss(topo, rate_per_s=0.03)
              .flapping_link(topo, start_s=4.0, n_flaps=2, down_s=1.5,
                             up_s=3.0)
              .rolling_upgrade(topo, start_s=14.0, spacing_s=3.0)
              .build())
    runner = S.fleet.CampaignRunner(fleet, events, seed=9, profile=prof,
                                    ttft_target_s=0.5, tpot_target_s=0.2,
                                    slo_window_s=5.0)
    return runner.run(), fleet


def test_campaign_forensics_byte_identical_to_reference(dirs):
    """The port's campaign forensics, as sorted JSON, equal the
    reference's byte for byte, and a second port run's equal its first;
    the campaign revives, restarts, substitutes and rejoins devices on
    the port's engines (``full_reinit``, ``rejoin_device``,
    ``export_live_requests``, ``admit``)."""
    (jres, jf), (pres, pf) = both(dirs, _mini_campaign)
    pres2, _ = _mini_campaign(TORCH, dirs[TORCH.name])
    got = json.dumps(pres.forensics, sort_keys=True)
    assert got == json.dumps(jres.forensics, sort_keys=True)
    assert got == json.dumps(pres2.forensics, sort_keys=True)
    assert pf.unfinished == 0 and pres.events_applied > 0
    recov = pres.forensics["recoveries"]
    decided = [e for e in recov if "decision" in e]
    assert decided and all("counterfactual_s" in e for e in decided)
    assert pres.forensics["slo"]["total_burn_s"] >= 0.0
    assert fleet_record(pf) == fleet_record(jf)


# -- pure: tests/test_chaos.py:58, :88, :128, :161 --------------------------------

def _compose(S, seed):
    return (S.fleet.CampaignSchedule(seed, horizon_s=100.0)
            .device_faults(TOPO, rate_per_s=0.05)
            .rack_loss(TOPO, rate_per_s=0.02)
            .cascading_stragglers(TOPO, start_s=10.0, spacing_s=5.0, n=3)
            .flapping_link(TOPO, start_s=30.0, n_flaps=2)
            .spot_wave(TOPO, at_s=60.0, n_instances=2, notice_s=5.0)
            .rolling_upgrade(TOPO, start_s=80.0, spacing_s=5.0)
            .instance_loss(TOPO, rate_per_s=0.01)
            .build())


@pytest.mark.parametrize("seed", [7, 8])
def test_schedule_build_matches(seed):
    """``CampaignSchedule.build()``: equal event lists for one seed."""
    from dataclasses import astuple
    got = [astuple(e) for e in _compose(TORCH, seed)]
    assert got == [astuple(e) for e in _compose(JAX, seed)]
    kinds = {e[1] for e in got}
    assert {"device_fault", "rack_loss", "straggler", "fault_clear",
            "spot_notice", "spot_preempt", "upgrade"} <= kinds


def test_injector_lifecycle_matches():
    """tests/test_chaos.py:88's dedup / cancel / clear / recurring /
    reset sequence on both packages' ``FaultInjector``."""
    from repro.core.faults import FaultInjector as JaxInjector
    from repro_torch.core.faults import FaultInjector

    def run(Inj):
        inj, out = Inj(), []
        f1 = inj.schedule(5, 0)
        out.append(inj.schedule(5, 0) is f1)
        f2 = inj.schedule(6, 1, mid_step=True)
        out.append(inj.cancel(f2))
        inj.schedule(7, 1)
        inj.schedule(8, 1)
        out.append(inj.cancel(physical_id=1))
        out.append(len(inj.pre_step_faults(5)))
        inj.schedule(9, 0)
        out += [len(inj.pre_step_faults(9)), inj.deduped,
                len(inj.annotations), inj.clear(0), inj.clear(0)]
        inj.schedule(11, 0)
        out.append(len(inj.pre_step_faults(11)))
        r = inj.schedule(20, 2, recurring=True)
        out.append(len(inj.pre_step_faults(20)))
        inj.clear(2)
        out += [r.fired, len(inj.pre_step_faults(25))]
        inj.reset()
        out.append((len(inj.scheduled), len(inj.annotations), inj.deduped))
        return out

    got = run(FaultInjector)
    assert got == run(JaxInjector)
    assert got == [True, 1, 2, 1, 0, 2, 1, True, False, 1, 1, False, 1,
                   (0, 0, 0)]


def test_arbiter_decision_boundaries_sweep_matches():
    """tests/test_chaos.py:161's 300 seeded (load, spare, loss, forced
    policy) draws: both packages' arbiters decide alike, feasibly."""
    def sweep(S):
        rng = np.random.default_rng(42)
        policies = (None, "revive", "restart", "spare")
        out = []
        for trial in range(300):
            n = int(rng.integers(1, 12))
            tokens = int(rng.integers(4, 200))
            spare, lost = bool(rng.integers(2)), bool(rng.integers(2))
            force = policies[int(rng.integers(4))]
            arb = S.fleet.RecoveryArbiter(profile(S).cost_model(),
                                          force_policy=force)
            reqs = [SimpleNamespace(num_tokens=tokens,
                                    state=SimpleNamespace(value="running"))
                    for _ in range(n)]
            inst = SimpleNamespace(
                iid=trial, load=n, model_id="default",
                engine=SimpleNamespace(all_requests=reqs, unfinished=n))
            dec = arb.decide(inst, None, spare_available=spare,
                             instance_lost=lost)
            feasible = {"revive", "restart", "spare"} - (
                {"revive"} if lost else set()) - (
                set() if spare else {"spare"})
            assert dec.policy in feasible
            out.append((dec.policy, dec.reason,
                        sorted(dec.est_cost.items())))
        return out

    assert sweep(TORCH) == sweep(JAX)


def test_slo_burn_matches():
    """tests/test_chaos.py:128's rows through both packages'
    ``slo_burn``."""
    rows = [
        {"arrival_s": 1.0, "first_token_s": 1.2, "finish_s": 5.0,
         "n_out": 11},
        {"arrival_s": 2.0, "first_token_s": 4.0, "finish_s": 6.0,
         "n_out": 11},
        {"arrival_s": 12.0, "first_token_s": 12.5, "finish_s": 14.0,
         "n_out": 11},
        {"arrival_s": 15.0, "first_token_s": None, "finish_s": None,
         "n_out": 0},
    ]
    for kw in (dict(ttft_target_s=1.0, window_s=10.0, q=1.0,
                    horizon_s=20.0),
               dict(ttft_target_s=10.0, tpot_target_s=0.1, window_s=10.0,
                    q=1.0, horizon_s=20.0)):
        got = TORCH.fleet.slo_burn(rows, **kw)
        assert got == JAX.fleet.slo_burn(rows, **kw)
    assert got["tpot_burn_s"] == pytest.approx(
        (0.38 - 0.1) * 10.0 + (0.15 - 0.1) * 10.0)
    assert TORCH.fleet.slo_burn([], ttft_target_s=1.0) == \
        JAX.fleet.slo_burn([], ttft_target_s=1.0)


def test_mixed_traffic_and_cost_jitter_match():
    """tests/test_chaos.py:433 and :481: diurnal + Poisson mixes, and the
    jittered per-event costs, equal in both packages."""
    def draw(S):
        d = S.fleet.DiurnalTraffic(4.0, 512, amplitude=0.8, period_s=30.0,
                                   seed=2, limit=50, model_id="a")
        p = S.fleet.PoissonTraffic(2.0, 512, seed=3, limit=20,
                                   model_id="b")
        mix = [(a.at_s, tuple(a.prompt_tokens), a.model_id)
               for a in S.fleet.MixedTraffic([d, p]).due(60.0)]
        prof = S.fleet.VirtualCostProfile(jitter=0.4, jitter_seed=7)
        costs = [prof.event_cost(k, i, 0.75) for k in
                 ("revive", "restart", "spare") for i in range(16)]
        return mix, costs

    got = draw(TORCH)
    assert got == draw(JAX)
    assert {m for _, _, m in got[0]} == {"a", "b"}
    assert len(set(got[1])) > 1
