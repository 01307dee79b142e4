"""The engine surface the fleet calls, on the port against ``repro``:
``admit`` / ``export_live_requests`` (the KV round trip),
``streamable_split`` and ``predict_masked_fraction``, the
``fault_interceptor`` hook, ``rejoin_device``, ``rebalance_experts`` and
``full_reinit``.  Each scenario runs on both packages with the same
config, seed, prompts, fault schedule and ``weights.npz``; the port runs
on the CPU in f32.

The reference's reload of an EP rank reads the rank's start-up slots
whatever the expert map says, so after ``rebalance_experts`` its
re-pointed slots serve another expert's weights (ROADMAP Queue 3).  The
port reads each re-pointed slot from its logical's column;
:func:`_repair_reference_reload` gives the reference instance the same
rule before streams are compared.  Nothing in ``repro`` changes.
"""
import dataclasses

import numpy as np
import pytest
import torch

from test_torch_fleet_cases import (JAX, PROMPT, TORCH, both, fleet_cfg,
                                    fleet_ecfg, make_dirs)
from repro_torch.serving.weights_util import (
    expert_leaves, load_expert_shard_from_checkpoint)
from repro_torch.training.checkpoint import flatten, load_axis1_slices


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    return make_dirs(tmp_path_factory, "fleet_engine")


def small_moe_cfg(S):
    """tests/test_recovery.py:18: 4 experts, 2 redundant, top-2."""
    cfg = S.smoke("qwen2-moe-a2.7b")
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, num_experts=4, num_redundant_experts=2, top_k=2))


def _engine(S, wd, cfg=None, **kw):
    return S.Engine(cfg or fleet_cfg(S), fleet_ecfg(S, wd, **kw))


def _submit(eng, vocab, n, prompt_len=8, max_new=8, seed=0):
    rng = np.random.default_rng(seed)
    return [eng.submit(list(map(int, rng.integers(0, vocab, prompt_len))),
                       max_new) for _ in range(n)]


def _streams(reqs):
    return [list(r.output_tokens) for r in reqs]


def _bank_holds_the_map(eng):
    """Every slot of the port's device bank holds the weights of the
    logical the map routes to it: column ``slot_logical[s]`` of
    ``weights.npz``."""
    emap = eng.expert_map
    for key, leaf in expert_leaves(eng.params):
        for s, logical in enumerate(emap.slot_logical):
            want = load_axis1_slices(eng.ckpt_path, [key], logical,
                                     logical + 1)[key][:, 0]
            assert torch.equal(leaf[:, s], want.to(leaf.dtype)), (key, s)


def _repair_reference_reload(monkeypatch, jeng):
    """Make the reference's reload of an EP rank follow the map, as the
    port's does: each slot re-pointed since start-up gets its logical's
    column of ``weights.npz``."""
    import repro.serving.weights_util as W
    load = W.load_expert_shard_from_checkpoint
    moe = jeng.cfg.moe
    startup = list(range(moe.num_experts)) + list(
        range(moe.num_redundant_experts))

    def following(ckpt, template, ep_rank, ep_size, *, workdir=None):
        shard = load(ckpt, template, ep_rank, ep_size, workdir=workdir)
        emap = jeng.expert_map
        per = emap.slots_per_rank
        with np.load(ckpt) as z:
            for s in emap.rank_slots(ep_rank):
                if emap.slot_logical[s] != startup[s]:
                    for k in shard:
                        shard[k][:, s - ep_rank * per] = \
                            z[k][:, emap.slot_logical[s]]
        return shard

    monkeypatch.setattr(W, "load_expert_shard_from_checkpoint", following)


# -- admit / export_live_requests: tests/test_paged_serving.py:352 ----------------

def _kv_round_trip(S, wd):
    sp = S.SP(temperature=0.8, top_p=0.9, seed=7)
    cfg = fleet_cfg(S)
    ec = dict(mode="collocated", num_dp=1, num_blocks=32, sampling=sp)
    src, tgt = _engine(S, wd, **ec), _engine(S, wd, **ec)
    prompt = list(map(int, np.random.default_rng(5).integers(
        0, cfg.vocab_size, 9)))
    outs = {}
    for mode in ("stream", "replay"):
        req = src.submit(list(prompt), 12)
        for _ in range(4):
            src.step()
        mid = len(req.output_tokens)
        if mode == "stream":
            (req2, kv), = src.export_live_requests(with_kv=True)
            assert kv is not None
        else:
            (req2,) = src.export_live_requests()
            kv = None
        assert req2 is req and req not in src.all_requests
        tgt.admit(req, kv=kv)
        tgt.run(max_steps=80)
        outs[mode] = (req.state.value, mid, list(req.output_tokens),
                      req.recomputed_tokens)
    return outs


def test_kv_round_trip_stream_equals_replay(dirs):
    """A mid-generation request exported with its KV blocks and admitted
    on another engine, and the same exported without them (token
    replay): equal streams in each package and across them; only the
    replay pays recomputed tokens, as many as the reference's."""
    ref, got = both(dirs, _kv_round_trip)
    for mode in ("stream", "replay"):
        state, mid, _, _ = got[mode]
        assert state == "finished" and 0 < mid < 12
    assert got["stream"][2] == got["replay"][2]
    assert got["stream"][3] == 0 < got["replay"][3]
    assert got == ref


# -- streamable_split / predict_masked_fraction ----------------------------------

def _cost_inputs(S, wd):
    eng = _engine(S, wd, num_dp=3)
    reqs = _submit(eng, eng.cfg.vocab_size, n=5, max_new=16)

    def state():
        return (eng.streamable_split(),
                [eng.predict_masked_fraction(pid) for pid in range(6)])

    for _ in range(3):
        eng.step()
    out = [state()]
    # an L6 moe fault on EP rank 1 (logical 3's only copy): role switch
    eng.injector.schedule(eng.step_no + 1, 4, severity=S.codes.Severity.L6,
                          component="moe", mid_step=True)
    eng.step()
    out.append(state())
    # then attention rank 0 dies: one dead executor
    eng.injector.schedule(eng.step_no + 1, 0, severity=S.codes.Severity.L5,
                          error_type=S.codes.ErrorType.DRIVER_HANG,
                          component="attn", mid_step=True)
    eng.step()
    out.append(state())
    eng.run(max_steps=200)
    return out, [r.scenario for r in eng.reports], _streams(reqs)


def test_streamable_split_and_masked_fraction_match(dirs):
    """The arbiter's cost inputs mid-run, after an L6 ``moe`` fault and
    with one dead attention executor, equal the reference's."""
    ref, got = both(dirs, _cost_inputs)
    states, scenarios, _ = got
    assert scenarios == ["moe+role_switch", "attn"]
    assert states[0][0][0] > 0          # running requests can stream
    assert states[2][0][1] > 0          # the dead rank's must replay
    assert any(f > 0 for f in states[0][1])
    assert got == ref


# -- fault_interceptor ------------------------------------------------------------

def _intercepted(S, wd):
    eng = _engine(S, wd)
    seen = []
    eng.fault_interceptor = lambda ev: seen.append(ev.rank) or "restart"
    reqs = _submit(eng, eng.cfg.vocab_size, n=3)
    eng.injector.schedule(3, 2, severity=S.codes.Severity.L6,
                          component="moe", mid_step=True)
    for _ in range(3):      # the fault fires mid-step in the third
        eng.step()
    mex = next(m for m in eng.moe_executors if m.physical_id == 2)
    return dict(seen=seen, reports=len(eng.reports),
                alive=[(r.physical_id, r.alive) for r in eng.domain.ranks],
                mex=(mex.device_alive, mex.shard is None),
                registered=2 in eng.monitor.last_beat,
                split=eng.streamable_split(),
                health=dataclasses.asdict(eng.health()),
                out=_streams(reqs))


def test_fault_interceptor_restart_isolates_only(dirs):
    """An interceptor that answers "restart" leaves the fault to the
    fleet: the device is isolated, no recovery report, the monitor no
    longer expects its heartbeat — the same state as the reference."""
    ref, got = both(dirs, _intercepted)
    assert got["seen"] == [2] and got["reports"] == 0
    assert (2, False) in got["alive"] and got["mex"] == (False, True)
    assert got["registered"] is False
    assert got == ref


# -- rejoin_device: tests/test_chaos.py:223 ---------------------------------------

def _flapping(S, wd):
    eng = _engine(S, wd)
    req = eng.submit(PROMPT, 10)
    flap = dict(severity=S.codes.Severity.L4,
                error_type=S.codes.ErrorType.LINK_DOWN, component="attn")
    eng.injector.schedule(3, 1, **flap)
    for _ in range(6):
        eng.step()
    out = dict(reports=[len(eng.reports)],
               down=not eng.domain.device(1).alive)
    ver = eng.domain.version
    out["rejoined"] = eng.rejoin_device(1)
    out["bump"] = eng.domain.version - ver
    out["alive"] = eng.domain.device(1).alive
    out["again"] = eng.rejoin_device(1)
    eng.injector.schedule(eng.step_no + 1, 1, **flap)
    for _ in range(4):
        eng.step()
    out["reports"].append(len(eng.reports))
    eng.rejoin_device(1)
    eng.run(max_steps=200)
    out.update(state=req.state.value, out=list(req.output_tokens),
               actions=[r.actions for r in eng.reports],
               ranks=[(r.physical_id, r.logical_rank, r.role, r.alive)
                      for r in eng.domain.ranks])
    return out


def test_flapping_link_clear_and_rejoin(dirs):
    ref, got = both(dirs, _flapping)
    assert got["reports"] == [1, 2], "second flap must fire after rejoin"
    assert got["down"] and got["rejoined"] and got["alive"]
    assert got["bump"] == 1 and got["again"] is False
    assert got["state"] == "finished"
    assert got == ref


def _collocated_rejoin(S, wd):
    eng = _engine(S, wd, mode="collocated", num_dp=2)
    start = [t.clone() for _, t in expert_leaves(eng.params)] \
        if S is TORCH else None
    reqs = _submit(eng, eng.cfg.vocab_size, n=4, max_new=12)
    eng.injector.schedule(3, 1, severity=S.codes.Severity.L6,
                          component="attn+moe", mid_step=True)
    for _ in range(5):
        eng.step()
    lost = eng.expert_integrity()[1]
    eng.injector.clear(1)
    rejoined = eng.rejoin_device(1)
    eng.run(max_steps=200)
    if S is TORCH:
        per = eng.expert_map.slots_per_rank
        for (_, leaf), first in zip(expert_leaves(eng.params), start):
            assert torch.equal(leaf[:, per:], first[:, per:])
    return dict(lost=lost, rejoined=rejoined, out=_streams(reqs),
                alive=eng.expert_integrity()[1],
                scenarios=[r.scenario for r in eng.reports],
                masked=sorted(eng.expert_map.masked))


def test_collocated_rejoin_restores_the_ep_rank(dirs):
    """A collocated rank lost with its experts (masked), then rejoined:
    its shard is read back from ``weights.npz`` and its bank slice equals
    the start-up slice exactly; streams equal the reference's."""
    ref, got = both(dirs, _collocated_rejoin)
    assert got["lost"] == [True, False] and got["rejoined"]
    assert got["alive"] == [True, True] and got["masked"] == []
    assert got["scenarios"] == ["moe+missing_experts"]
    assert got == ref


# -- rebalance_experts: tests/test_recovery.py:281 --------------------------------

def _rebalance(S, wd):
    cfg = small_moe_cfg(S)
    eng = _engine(S, wd, cfg=cfg, num_moe=3)
    emap = eng.expert_map
    before = (sorted(emap.replicas_of(0)), emap.replicas_of(3))
    moves = eng.rebalance_experts({0: 1, 1: 2, 2: 90, 3: 100})
    replicas = {e: emap.replicas_of(e) for e in range(4)}
    if S is TORCH:
        # each re-pointed slot of the device bank is its source slot
        for slot, logical in moves.items():
            for _, leaf in expert_leaves(eng.params):
                assert torch.equal(leaf[:, slot], leaf[:, logical])
        per = emap.slots_per_rank
        for logical in (2, 3):
            a, b = replicas[logical]
            owners = [eng._shard_owner(emap.rank_of_slot(s)) for s in (a, b)]
            for key in owners[0].shard:
                assert torch.equal(owners[0].shard[key][:, a % per],
                                   owners[1].shard[key][:, b % per])
    reqs = _submit(eng, cfg.vocab_size, n=2)
    eng.run(max_steps=80)
    emap.fail_rank(emap.rank_of_slot(3))
    return dict(before=before, moves=moves, replicas=replicas,
                covered=3 not in emap.fully_lost(), out=_streams(reqs),
                states=[r.state.value for r in reqs])


def test_rebalance_experts_copies_inside_the_bank(dirs):
    ref, got = both(dirs, _rebalance)
    assert got["before"] == ([0, 4], [3])
    assert got["moves"] == {4: 3, 5: 2}
    assert len(got["replicas"][3]) == len(got["replicas"][2]) == 2
    assert got["replicas"][0] == [0] and got["covered"]
    assert got["states"] == ["finished"] * 2
    assert got == ref


# -- rebalance, then lose and reload the rank -------------------------------------

REBALANCE_RELOAD = {
    # the probe: 3 expert ranks, slots 4 and 5 (EP rank 2) re-pointed to
    # logicals 3 and 2, rank 2 lost (its logicals have base copies:
    # redundant-experts revive), then the device rejoins
    "rejoin": dict(ec=dict(num_dp=2, num_moe=3), pid=4, moves={4: 3, 5: 2}),
    # 2 expert ranks: slot 4 (EP rank 1) re-pointed to logical 2, rank 1
    # lost with logical 3's only copy: a synchronous role switch reloads
    # it
    "role_switch": dict(ec=dict(num_dp=3, num_moe=2), pid=4, moves={4: 2}),
}


def _rebalance_reload(S, wd, case, monkeypatch):
    c = REBALANCE_RELOAD[case]
    cfg = small_moe_cfg(S)
    eng = _engine(S, wd, cfg=cfg, **c["ec"])
    if S is JAX:
        _repair_reference_reload(monkeypatch, eng)
    moves = eng.rebalance_experts({0: 1, 1: 2, 2: 90, 3: 100})
    reqs = _submit(eng, cfg.vocab_size, n=4, max_new=12)
    eng.injector.schedule(3, c["pid"], severity=S.codes.Severity.L6,
                          component="moe", mid_step=True)
    for _ in range(5):
        eng.step()
    if case == "rejoin":
        eng.injector.clear(c["pid"])
        assert eng.rejoin_device(c["pid"])
    if S is TORCH:
        _bank_holds_the_map(eng)
    eng.run(max_steps=200)
    return dict(moves=moves, out=_streams(reqs),
                map=list(eng.expert_map.slot_logical),
                alive=eng.expert_integrity()[1],
                scenarios=[r.scenario for r in eng.reports],
                actions=[r.actions for r in eng.reports])


@pytest.mark.parametrize("case", list(REBALANCE_RELOAD))
def test_rebalance_then_reload_follows_the_map(dirs, case, monkeypatch):
    """After ``rebalance_experts`` a reloaded EP rank (rejoin or role
    switch) holds, in every slot, the weights of the logical the map
    routes there; the streams equal the repaired reference's."""
    ref, got = both(dirs, _rebalance_reload, case, monkeypatch)
    assert got["moves"] == REBALANCE_RELOAD[case]["moves"]
    assert all(got["alive"])
    assert got["scenarios"] == (["moe+redundant_experts"]
                                if case == "rejoin"
                                else ["moe+role_switch"])
    assert got == ref


def test_reload_reads_moved_slots_from_their_logicals(dirs):
    """``load_expert_shard_from_checkpoint(moved=...)``: the rank's run,
    with each moved slot read from its logical's column."""
    eng = _engine(TORCH, dirs[TORCH.name], cfg=small_moe_cfg(TORCH),
                  num_moe=3)
    plain = load_expert_shard_from_checkpoint(eng.ckpt_path, eng.shards[0],
                                              2)
    moved = load_expert_shard_from_checkpoint(eng.ckpt_path, eng.shards[0],
                                              2, moved={0: 3, 1: 2})
    for key, leaf in expert_leaves(eng.params):
        assert torch.equal(plain[key], leaf[:, 4:6])     # logicals 0, 1
        assert torch.equal(moved[key][:, 0], leaf[:, 3])
        assert torch.equal(moved[key][:, 1], leaf[:, 2])


# -- full_reinit -------------------------------------------------------------------

def _reinit(S, wd):
    eng = _engine(S, wd, num_dp=3)
    reqs = _submit(eng, eng.cfg.vocab_size, n=5, max_new=14)
    # scheduled before the restart, for a step after it
    eng.injector.schedule(8, 1, severity=S.codes.Severity.L6,
                          component="attn", mid_step=True)
    for _ in range(4):
        eng.step()
    mid = [len(r.output_tokens) for r in reqs]
    n_timings = len(eng.graph_cache.timings)
    t = eng.full_reinit()
    rebuilt = [(tm.key, tm.source)
               for tm in eng.graph_cache.timings[n_timings:]]
    eng.run(max_steps=200)
    return dict(keys=sorted(t), keys_first=sorted(eng.init_timings),
                mid=mid, rebuilt=rebuilt, out=_streams(reqs),
                reports=[(r.event.rank, r.scenario, r.actions)
                         for r in eng.reports],
                version=eng.domain.version)


def test_full_reinit_mid_run(dirs):
    """A restart mid-run: the unfinished requests requeue and finish with
    the reference's streams, a fault scheduled before it fires after it,
    the rebuilt decode lookup is ``cached``, and the Table-1 timing keys
    are the reference's."""
    ref, got = both(dirs, _reinit)
    assert all(0 < m < 14 for m in got["mid"])
    assert (("decode", got["rebuilt"][0][0][1], None), "cached") \
        in got["rebuilt"]
    assert [r[:2] for r in got["reports"]] == [(1, "attn")]
    assert {"engine", "generator", "executor_processes", "xccl"} <= set(
        got["keys"])
    assert got["out"] == ref["out"]
    assert got == ref


def test_full_reinit_releases_the_old_model(dirs):
    """The old weights, pools and executors are released before
    ``weights.npz`` is read again: after the reinit no tensor of the old
    engine is referenced, and the engine serves from the new ones."""
    import gc
    import weakref
    eng = _engine(TORCH, dirs[TORCH.name])
    old = [weakref.ref(t) for _, t in flatten(eng.params)]
    old += [weakref.ref(t) for ex in eng.dp_executors
            for _, t in flatten(ex.cache)]
    reqs = _submit(eng, eng.cfg.vocab_size, n=2)
    eng.step()
    eng.full_reinit()
    gc.collect()
    assert all(r() is None for r in old)
    eng.run(max_steps=80)
    assert all(r.state.value == "finished" for r in reqs)
