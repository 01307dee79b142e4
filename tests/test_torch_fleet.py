"""The fleet control plane on the port's engines (``repro_torch.fleet``)
against ``repro.fleet``: tests/test_fleet.py's fleet scenarios, each run
on a torch fleet and a ``repro`` fleet side by side, and its pure
cost-model and arbiter tests against the port's copies.

Every fleet here runs on pinned virtual costs (``VirtualCostProfile``,
the chaos campaigns' determinism mode): with wall-clock costs the
arbiter's inputs and the clock's charges are each package's own
timings, so forensics could not be compared.  The faults, traffic and
decisions are the scenarios' own; each scenario's own checks run on the
port, and the per-request streams, the forensics (as sorted JSON), the
router's counters and the arbiter's decisions must equal the
reference's.
"""
from types import SimpleNamespace

import numpy as np
import pytest

from test_torch_fleet_cases import (JAX, PROMPT, SIDES, TORCH, both,
                                    fleet_cfg, fleet_ecfg, fleet_record,
                                    make_dirs, profile)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    return make_dirs(tmp_path_factory, "fleet")


def _build(S, wd, instances, **kw):
    ecfg_kw = kw.pop("ecfg", {})
    return S.fleet.build_fleet(fleet_cfg(S), fleet_ecfg(S, wd, **ecfg_kw),
                               instances=instances, cost_profile=profile(S),
                               **kw, **S.kw)


# -- tests/test_fleet.py:51 -------------------------------------------------------

def _exact_replay(S, wd, temperature):
    sp = S.SP(temperature=temperature, top_p=0.9, seed=5)
    ref_fleet = _build(S, wd, 1, ecfg=dict(sampling=sp))
    ref = ref_fleet.submit(PROMPT, 14)
    ref_fleet.run(max_ticks=120)
    fleet = _build(S, wd, 2, ecfg=dict(sampling=sp))
    req = fleet.submit(PROMPT, 14)
    for _ in range(5):
        fleet.tick()
    mid, src = len(req.output_tokens), req.instance_id
    fleet.lose_instance(src, "test: host loss mid-generation")
    fleet.run(max_ticks=250)
    return fleet, dict(ref=list(ref.output_tokens), mid=mid, src=src,
                       ref_record=fleet_record(ref_fleet))


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_cross_instance_migration_exact_replay(dirs, temperature):
    (jf, jx), (pf, px) = both(dirs, _exact_replay, temperature)
    req = pf.requests[0]
    assert req.state.value == "finished"
    assert 0 < px["mid"] < 14, "fault must land mid-generation"
    assert req.cross_instance_migrations == 1
    assert req.instance_id != px["src"]
    assert req.output_tokens == px["ref"]
    dec = pf.arbiter.decisions[-1]
    assert dec.policy in ("restart", "spare")
    assert "impossible" in dec.reason or "forced" in dec.reason
    assert px == jx
    assert fleet_record(pf) == fleet_record(jf)


# -- tests/test_fleet.py:83 -------------------------------------------------------

def _least_loaded(S, wd):
    fleet = _build(S, wd, 2)
    r1, r2 = fleet.submit(PROMPT, 4), fleet.submit(PROMPT, 4)
    first = {r1.instance_id, r2.instance_id}
    fleet.instances[0].state = S.fleet.InstanceState.DRAINING
    r3 = fleet.submit(PROMPT, 4)
    third = r3.instance_id
    fleet.instances[0].state = S.fleet.InstanceState.SERVING
    fleet.run(max_ticks=120)
    return fleet, dict(first=first, third=third)


def test_router_least_loaded_admission_and_drain(dirs):
    (jf, jx), (pf, px) = both(dirs, _least_loaded)
    assert px == dict(first={0, 1}, third=1) == jx
    assert all(r.state.value == "finished" for r in pf.requests)
    assert len(pf.ttfts()) == 3 and all(t >= 0 for t in pf.ttfts())
    assert fleet_record(pf) == fleet_record(jf)


# -- tests/test_fleet.py:136 ------------------------------------------------------

def _spare_substitution(S, wd):
    fleet = _build(S, wd, 2, spares=1, force_policy="spare")
    available = fleet.spares.available
    for _ in range(4):
        fleet.submit(PROMPT, 12)
    fleet.instances[0].engine.injector.schedule(
        3, 2, severity=S.codes.Severity.L6,
        error_type=S.codes.ErrorType.HBM_ECC, component="moe",
        mid_step=True)
    fleet.run(max_ticks=300)
    return fleet, dict(available=available)


def test_spare_substitution_on_device_fault(dirs):
    (jf, _), (pf, px) = both(dirs, _spare_substitution)
    assert px["available"] == 1
    assert all(r.state.value == "finished" for r in pf.requests)
    assert pf.instances[0].state is TORCH.fleet.InstanceState.DEAD
    assert pf.spares.available == 0 and pf.spares.activations == 1
    assert [iid for iid in pf.instances if iid >= 1000]
    assert [r for r in pf.requests if r.cross_instance_migrations > 0]
    assert any(d.policy == "spare" for d in pf.arbiter.decisions)
    assert fleet_record(pf) == fleet_record(jf)


# -- tests/test_fleet.py:160 ------------------------------------------------------

def _open_loop(S, wd):
    traffic = S.fleet.PoissonTraffic(200.0, 512, prompt_len=6,
                                     max_new_tokens=6, seed=1, limit=10)
    fleet = _build(S, wd, 2, traffic=traffic)
    fleet.run(max_ticks=400)
    return fleet, dict(exhausted=traffic.exhausted)


def test_open_loop_traffic_all_finish(dirs):
    (jf, jx), (pf, px) = both(dirs, _open_loop)
    assert px == jx == dict(exhausted=True)
    assert len(pf.requests) == 10 and pf.unfinished == 0
    assert fleet_record(pf) == fleet_record(jf)


# -- tests/test_fleet.py:272 ------------------------------------------------------

def _replenish(S, wd):
    sp = S.SP(temperature=0.8, top_p=0.9, seed=5)
    ref_fleet = _build(S, wd, 1, ecfg=dict(sampling=sp))
    ref = ref_fleet.submit(PROMPT, 14)
    ref_fleet.run(max_ticks=150)
    fleet = _build(S, wd, 2, ecfg=dict(sampling=sp), spares=1,
                   force_policy="spare", replenish_spares=True)
    req = fleet.submit(PROMPT, 14)
    for _ in range(5):
        fleet.tick()
    mid = len(req.output_tokens)
    eng = fleet.instances[req.instance_id].engine
    eng.injector.schedule(eng.step_no + 1, 3, severity=S.codes.Severity.L6,
                          error_type=S.codes.ErrorType.HBM_ECC,
                          component="moe", mid_step=True)
    fleet.run(max_ticks=300)
    return fleet, dict(ref=list(ref.output_tokens), mid=mid)


def test_spare_pool_background_replenish(dirs):
    """The streamed takeover: the migrated request's KV blocks stream to
    the standby (zero recompute) and the pool rebuilds a standby."""
    (jf, jx), (pf, px) = both(dirs, _replenish)
    req = pf.requests[0]
    assert 0 < px["mid"] < 14
    assert req.state.value == "finished"
    assert req.output_tokens == px["ref"]
    assert req.cross_instance_migrations == 1
    assert req.recomputed_tokens == 0
    assert pf.spares.activations == 1 and pf.spares.replenishments == 1
    assert pf.spares.available == pf.spares.target_size == 1
    assert any("replenished" in line for line in pf.log)
    assert px == jx
    assert fleet_record(pf) == fleet_record(jf)


# -- pure: tests/test_fleet.py:180, :226, :248 ------------------------------------

def test_arbiter_cost_model_decisions_match():
    """tests/test_fleet.py:180 on both packages' CostModel and
    RecoveryArbiter: the same estimates and decisions at every step."""
    def run(S):
        cm = S.fleet.CostModel({"engine": 0.1, "generator": 2.0,
                                "xccl": 0.01, "read_cache": 0.02,
                                "compile": 0.5},
                               spare_opportunity_cost_s=10.0)
        out = [cm.est_revive_s(), cm.est_restart_s()]
        arb = S.fleet.RecoveryArbiter(cm)
        inst = SimpleNamespace(iid=7, load=3,
                               engine=SimpleNamespace(all_requests=[]))
        decs = [arb.decide(inst, None, spare_available=True),
                arb.decide(inst, None, spare_available=True,
                           instance_lost=True),
                arb.decide(inst, None, spare_available=False,
                           instance_lost=True)]
        cm.observe_revive({"total_s": 50.0})
        cm.observe_restart(0.2)
        decs.append(arb.decide(inst, None, spare_available=False))
        arb2 = S.fleet.RecoveryArbiter(cm, force_policy="spare")
        decs += [arb2.decide(inst, None, spare_available=True),
                 arb2.decide(inst, None, spare_available=False)]
        with pytest.raises(ValueError):
            S.fleet.RecoveryArbiter(cm, force_policy="bogus")
        return out + [(d.policy, d.reason, sorted(d.est_cost.items()))
                      for d in decs]

    got, want = run(TORCH), run(JAX)
    assert got == want
    policies = [d[0] for d in got[2:]]
    assert got[0] < 0.1 < got[1]
    assert policies[0] == "revive" and policies[1] != "revive"
    assert policies[2:5] == ["restart", "restart", "spare"]
    assert policies[5] != "spare"


def test_cost_model_stream_and_quality_pricing_match():
    """tests/test_fleet.py:226 on both packages."""
    def run(S):
        cm = S.fleet.CostModel({"engine": 1.0}, per_token_prefill_s=1e-3,
                               per_block_stream_s=1e-5,
                               degraded_quality_weight_s=2.0,
                               spare_opportunity_cost_s=0.0)
        out = [cm.est_spare_s(t, b) for t, b in
               ((1024, 0), (0, 64), (0, 256), (4096, 0))]
        out += [cm.quality_cost_s(0.0), cm.quality_cost_s(0.5)]
        cm.observe_spare(0.5, tokens=100, streamed_blocks=100)
        return out + [cm.spare_swap.value]

    got = run(TORCH)
    assert got == run(JAX)
    assert got[1] < got[0] / 100
    assert got[5] == pytest.approx(1.0)
    assert got[6] == pytest.approx(0.5 - 0.1 - 1e-3)


def test_arbiter_prices_degraded_quality_into_revive_match():
    """tests/test_fleet.py:248 on both packages."""
    def run(S):
        cm = S.fleet.CostModel({"engine": 0.1},
                               degraded_quality_weight_s=50.0,
                               spare_opportunity_cost_s=10.0)
        cm.observe_revive({"total_s": 0.02})
        cm.observe_restart(0.5)
        arb = S.fleet.RecoveryArbiter(cm)
        ev = SimpleNamespace(rank=3)

        def inst(mask_frac):
            return SimpleNamespace(iid=1, load=2, engine=SimpleNamespace(
                all_requests=[], streamable_split=lambda: (0, 0),
                predict_masked_fraction=lambda rank: mask_frac,
                ecfg=SimpleNamespace(block_size=8)))

        return [(d.policy, d.reason, sorted(d.est_cost.items()))
                for d in (arb.decide(inst(0.0), ev, spare_available=False),
                          arb.decide(inst(0.5), ev, spare_available=False))]

    got = run(TORCH)
    assert got == run(JAX)
    assert [g[0] for g in got] == ["revive", "restart"]
    assert "masked" in got[1][1]


def test_traffic_sources_match():
    """tests/test_fleet.py:296 and :314: Poisson, trace and lognormal
    arrivals equal in both packages for one seed."""
    def arrivals(S):
        T = S.fleet
        out = []
        for src in (T.PoissonTraffic(100.0, 512, seed=9, limit=5),
                    T.PoissonTraffic(200.0, 512, seed=9, limit=400,
                                     prompt_len=8, max_new_tokens=8,
                                     length_dist="lognormal",
                                     length_sigma=0.75, max_prompt_len=64,
                                     max_output_len=48),
                    T.PoissonTraffic(200.0, 512, seed=9, limit=50,
                                     prompt_len=(4, 8), max_new_tokens=6),
                    T.DiurnalTraffic(50.0, 512, amplitude=0.5,
                                     period_s=10.0, seed=4, limit=100,
                                     length_dist="lognormal")):
            out.append([(a.at_s, tuple(a.prompt_tokens), a.max_new_tokens,
                         a.model_id) for a in src.due(1e9)])
        tr = T.TraceTraffic([T.Arrival(0.5, (1, 2), 4),
                             T.Arrival(0.1, (3,), 4)])
        out.append([a.at_s for a in tr.due(0.2)] +
                   [a.at_s for a in tr.due(9.0)])
        return out

    got = arrivals(TORCH)
    assert got == arrivals(JAX)
    assert len(got[0]) == 5 and got[-1] == [0.1, 0.5]
    plens = np.array([len(a[1]) for a in got[1]])
    assert plens.min() >= 1 and plens.max() <= 64


def test_fleet_package_is_a_copy():
    """The port's fleet modules import nothing of ``repro`` and export
    what ``repro.fleet`` exports."""
    import repro.fleet
    import repro_torch.fleet
    assert repro_torch.fleet.__all__ == repro.fleet.__all__
    for name in repro_torch.fleet.__all__:
        assert getattr(repro_torch.fleet, name).__module__.startswith(
            "repro_torch.fleet")
    assert {s.name for s in SIDES} == {"repro", "repro_torch"}
