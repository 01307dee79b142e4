"""Both engines in disaggregated mode (attention ranks apart from expert
ranks, §2.2), one config, prompt set, fault schedule and ``weights.npz``:
the port must serve the same token streams and revive the same way as
``repro.serving.engine.InferenceEngine``, the §3.4 role switch included.

The cases are tests/test_recovery.py's disaggregated ones, on the port,
in f32:
- ``attn_fault``: an L5 device hang mid-step on attention rank 1 (:43);
- ``role_switch``: an L6 fault on MoE rank 0 (physical 3) whose experts
  have no replica: dp1 streams its residents' KV to the other attention
  ranks and takes EP rank 0, whose experts reload from ``weights.npz``
  (:68);
- ``missing``: the same loss without a donor to spare, masked (:89);
- ``background``: the role switch of §4.3, lost experts masked first and
  restored between steps (:185);
- ``fused``: the fused MoE keeps serving after the loss (:367);
- ``megakernel``: the role switch on ``decode_impl="megakernel"``;
- ``mla_missing`` and ``mla_switch``: ``deepseek-v3`` smoke (first-k
  dense, MLA): without a role switch a dense-FFN TP group is
  compromised, with one none is;
- ``kimi_dense_tp``: :213 itself, on ``kimi-k2-1t-a32b`` smoke (GQA,
  first-k dense): the lost MoE device's dense-FFN shard compromises its
  TP group and token routing rebalances over the healthy groups;
- ``two_moe_failures``: tests/test_fuzz_recovery.py:99, two role
  switches in a row;
- six combinations of the role switch with other options:
  ``serial_switch`` (whole-prompt admission), ``mid_prefill_switch``
  (the switch at step 2 while 36-token prompts prefill in chunks of 8),
  ``shared_prefix_switch`` (six prompts sharing a 16-token prefix),
  ``serial_background`` (whole-prompt admission, background switch),
  ``switch_then_attn`` (a switch, then an L5 attention fault on device
  0) and ``snapshot_switch`` (``pool_undo="snapshot"``).

Both engines sample straggler timings from a fixed virtual step of 10 ms
(``virtual_step_s``): the wall-clock straggler detector is not under
test, and on a loaded CPU it isolates healthy attention ranks (the
reference's ``test_two_sequential_moe_failures[7]`` fails that way,
ROADMAP Queue 3).

``repro``'s background switch sets the reloaded shard on the donor's DP
executor, where its disaggregated engine never looks for a shard owner:
the restored rank's bank slice stays zero while the map routes to it.
The port hands the shard to a new ``MoEExecutor``, as both packages'
synchronous switch does; the ``background`` case applies the same repair
to the reference instance (:func:`_repair_background_switch`) before
comparing.
"""
import dataclasses
import re
import shutil

import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import fault_codes as jax_codes
from repro.core.weights import RecoveryPolicy as JaxPolicy
from repro.serving.engine import EngineConfig as JaxEngineConfig
from repro.serving.engine import InferenceEngine as JaxEngine
from repro.serving.executor import MoEExecutor as JaxMoEExecutor
from repro_torch.configs import get_smoke_config
from repro_torch.core import fault_codes
from repro_torch.core.weights import RecoveryPolicy
from repro_torch.serving.engine import EngineConfig, InferenceEngine
from repro_torch.serving.weights_util import (
    load_expert_shard_from_checkpoint, save_shard_checkpoints)
from repro_torch.training import checkpoint as ckpt

QWEN, MLA, KIMI = "qwen2-moe-a2.7b", "deepseek-v3", "kimi-k2-1t-a32b"
VIRTUAL_STEP_S = 0.01
L6_MOE = ("L6", "HBM_ECC", "moe", False)
# name: dict(arch, bank (experts, redundant), engine overrides, policy,
#            requests (n, prompt_len, max_new, seed), faults
#            [(step, physical, (severity, error type, component, mid))])
CASES = {
    "attn_fault": dict(
        bank=(4, 2), ec=dict(num_dp=3), policy={}, reqs=(5, 8, 8, 0),
        faults=[(3, 1, ("L5", "DRIVER_HANG", "attn", True))]),
    "role_switch": dict(
        bank=(4, 2), ec=dict(num_dp=3), policy={}, reqs=(4, 8, 8, 0),
        faults=[(3, 3, L6_MOE)]),
    "missing": dict(
        bank=(4, 0), ec=dict(num_dp=2), reqs=(3, 8, 8, 0),
        policy=dict(allow_role_switch=False, min_ep_for_missing=2),
        faults=[(3, 3, L6_MOE)]),
    "background": dict(
        bank=(4, 0), ec=dict(num_dp=3), reqs=(4, 8, 16, 0),
        policy=dict(background_role_switch=True, min_ep_for_missing=2),
        faults=[(3, 3, L6_MOE)]),
    "fused": dict(
        bank=(4, 0), ec=dict(num_dp=2, moe_impl="fused"), reqs=(3, 8, 8, 0),
        policy=dict(allow_role_switch=False, min_ep_for_missing=2),
        faults=[(3, 3, L6_MOE)]),
    "megakernel": dict(
        bank=(4, 2), ec=dict(num_dp=3, moe_impl="fused",
                             decode_impl="megakernel"),
        policy={}, reqs=(4, 8, 8, 0), faults=[(3, 3, L6_MOE)]),
    "mla_missing": dict(
        arch=MLA, bank=None, ec=dict(num_dp=2), reqs=(3, 8, 8, 0),
        policy=dict(allow_role_switch=False, min_ep_for_missing=2),
        faults=[(3, 2, L6_MOE)]),
    "mla_switch": dict(
        arch=MLA, bank=None, ec=dict(num_dp=3), reqs=(3, 8, 8, 0),
        policy=dict(min_ep_for_missing=2), faults=[(3, 3, L6_MOE)]),
    "kimi_dense_tp": dict(
        arch=KIMI, bank=(4, 4), moe=dict(first_k_dense=1, dense_d_ff=256),
        ec=dict(num_dp=2), reqs=(3, 8, 8, 0),
        policy=dict(allow_role_switch=False, min_ep_for_missing=2),
        faults=[(3, 2, ("L6", "HBM_ECC", "moe", False))]),
    "two_moe_failures": dict(
        bank=(4, 0), ec=dict(num_dp=4), reqs=(6, 8, 20, 7),
        policy=dict(min_ep_for_missing=2),
        faults=[(3, 4, L6_MOE), (8, 5, L6_MOE)]),
    "serial_switch": dict(
        bank=(4, 2), ec=dict(num_dp=3, admission="serial"), policy={},
        reqs=(4, 8, 8, 0), faults=[(3, 3, L6_MOE)]),
    "mid_prefill_switch": dict(
        bank=(4, 2), ec=dict(num_dp=3, prefill_chunk=8), policy={},
        reqs=(4, 36, 8, 0), faults=[(2, 3, L6_MOE)]),
    "shared_prefix_switch": dict(
        bank=(4, 2), ec=dict(num_dp=3), policy={}, reqs=(6, 24, 8, 0),
        prefix=16, faults=[(3, 3, L6_MOE)]),
    "serial_background": dict(
        bank=(4, 0), ec=dict(num_dp=3, admission="serial"),
        reqs=(4, 8, 16, 0),
        policy=dict(background_role_switch=True, min_ep_for_missing=2),
        faults=[(3, 3, L6_MOE)]),
    "switch_then_attn": dict(
        bank=(4, 2), ec=dict(num_dp=3), policy={}, reqs=(4, 8, 12, 0),
        faults=[(3, 3, L6_MOE), (6, 0, ("L5", "DRIVER_HANG", "attn",
                                        True))]),
    "snapshot_switch": dict(
        bank=(4, 2), ec=dict(num_dp=3, pool_undo="snapshot"), policy={},
        reqs=(4, 8, 8, 0), faults=[(3, 3, L6_MOE)]),
}
SWITCHES = {"role_switch": 1, "background": 1, "megakernel": 1,
            "mla_switch": 1, "two_moe_failures": 2, "serial_switch": 1,
            "mid_prefill_switch": 1, "shared_prefix_switch": 1,
            "serial_background": 1, "switch_then_attn": 1,
            "snapshot_switch": 1}
# the combinations: each reloaded rank holds its start-up weights
COMBINED = ("serial_switch", "mid_prefill_switch", "shared_prefix_switch",
            "serial_background", "switch_then_attn", "snapshot_switch")


def _cfg(get_smoke, case):
    cfg = get_smoke(case.get("arch", QWEN))
    if case["bank"] is not None:     # tests/test_recovery.py:18
        experts, redundant = case["bank"]
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, num_experts=experts, num_redundant_experts=redundant,
            top_k=2, **case.get("moe", {})))
    return cfg


def _serve(eng, vocab, case, codes):
    n, prompt_len, max_new, seed = case["reqs"]
    rng = np.random.default_rng(seed)
    prompts = [list(map(int, rng.integers(0, vocab, prompt_len)))
               for _ in range(n)]
    if "prefix" in case:        # every prompt starts with the first's
        prompts = [prompts[0][:case["prefix"]] + p[case["prefix"]:]
                   for p in prompts]
    reqs = [eng.submit(p, max_new) for p in prompts]
    for step, pid, (sev, err, component, mid) in case["faults"]:
        eng.injector.schedule(step, pid, severity=codes.Severity[sev],
                              error_type=codes.ErrorType[err],
                              component=component, mid_step=mid)
    eng.run(max_steps=300)
    return reqs


def _repair_background_switch(jeng):
    """Give the reference's deferred switch the owner its synchronous
    switch gets: a new MoEExecutor on the donor holding the reloaded
    shard, then the bank rebuilt from the owners."""
    finish = jeng.recovery.complete_background_switch

    def repaired(plan):
        out = finish(plan)
        donor = jeng.dp_executors[plan.donor_rank]
        jeng.moe_executors.append(JaxMoEExecutor(
            physical_id=donor.physical_id, ep_rank=donor.ep_rank,
            shard=donor.shard))
        donor.shard = None
        jeng.reassemble_params()
        return out

    jeng.recovery.complete_background_switch = repaired


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    return tmp_path_factory.mktemp("disagg")


@pytest.fixture(scope="module", params=list(CASES))
def pair(request, shared):
    name = request.param
    case = CASES[name]
    arch = case.get("arch", QWEN)
    weights = shared / (f"weights_{arch}_{case['bank']}"
                        f"{sorted(case.get('moe', {}).items())}.npz")
    common = dict(mode="disaggregated", num_moe=2, max_batch=2, max_seq=64,
                  block_size=8, num_blocks=96 if name == "two_moe_failures"
                  else 64, **case["ec"])

    jdir = shared / name / "jax"
    jdir.mkdir(parents=True)
    if weights.exists():
        shutil.copy(weights, jdir / "weights.npz")
    jcfg = _cfg(jax_smoke_config, case)
    jeng = JaxEngine(jcfg, JaxEngineConfig(
        **common, workdir=str(jdir),
        persist_cache_dir=str(shared / "xla_cache"),
        policy=JaxPolicy(**case["policy"])))
    if not weights.exists():
        shutil.copy(jdir / "weights.npz", weights)
    jeng.virtual_step_s = VIRTUAL_STEP_S
    if case["policy"].get("background_role_switch"):
        _repair_background_switch(jeng)
    jreqs = _serve(jeng, jcfg.vocab_size, case, jax_codes)

    pdir = shared / name / "torch"
    pdir.mkdir()
    shutil.copy(weights, pdir / "weights.npz")
    pcfg = _cfg(get_smoke_config, case)
    peng = InferenceEngine(pcfg, EngineConfig(
        **common, workdir=str(pdir), policy=RecoveryPolicy(**case["policy"])),
        device="cpu")
    start = peng.expert_integrity()[0]
    peng.virtual_step_s = VIRTUAL_STEP_S
    preqs = _serve(peng, pcfg.vocab_size, case, fault_codes)
    return name, jeng, jreqs, peng, preqs, start


def test_token_streams_identical(pair):
    _, _, jreqs, _, preqs, _ = pair
    assert all(r.state.value == "finished" for r in preqs)
    assert all(len(r.output_tokens) == r.max_new_tokens for r in preqs)
    assert [r.output_tokens for r in preqs] == \
        [r.output_tokens for r in jreqs]
    assert [r.migrations for r in preqs] == [r.migrations for r in jreqs]
    assert [r.recomputed_tokens for r in preqs] == \
        [r.recomputed_tokens for r in jreqs]


def test_recovery_reports_match(pair):
    name, jeng, _, peng, _, _ = pair
    assert len(peng.reports) == len(jeng.reports) == len(CASES[name]
                                                         ["faults"])
    for p, j in zip(peng.reports, jeng.reports):
        assert p.mode == "disaggregated"
        assert p.scenario == j.scenario
        assert p.actions == j.actions
        assert p.migrated == j.migrated
        assert p.blocks_rolled_back == j.blocks_rolled_back
        assert p.compile_source == j.compile_source
        assert (p.moe_plan is None) == (j.moe_plan is None)
        if p.moe_plan is not None:
            assert p.moe_plan.kind.value == j.moe_plan.kind.value
            assert p.moe_plan.lost_logicals == j.moe_plan.lost_logicals
            assert p.moe_plan.donor_rank == j.moe_plan.donor_rank
            assert p.moe_plan.background == j.moe_plan.background
    # §3.6 precompiles the first failure's domain; a second one is cached
    assert peng.reports[0].compile_source == "precompiled"
    switches = [r for r in peng.reports if r.scenario == "moe+role_switch"]
    assert len(switches) == SWITCHES.get(name, 0)


def test_final_runtime_matches(pair):
    _, jeng, _, peng, _, _ = pair
    for p, j in zip(peng.runtime, jeng.runtime):
        np.testing.assert_array_equal(p.numpy(), np.asarray(j))
    assert peng.shard_alive == jeng.shard_alive
    pc, palive = peng.expert_integrity()
    jc, jalive = jeng.expert_integrity()
    assert palive == jalive
    np.testing.assert_allclose(pc, jc, rtol=1e-5)
    assert [m.physical_id for m in peng.moe_executors] == \
        [m.physical_id for m in jeng.moe_executors]
    assert peng.world_group == jeng.world_group
    assert [(r.physical_id, r.logical_rank, r.role, r.alive)
            for r in peng.domain.ranks] == \
        [(r.physical_id, r.logical_rank, r.role, r.alive)
         for r in jeng.domain.ranks]


def test_health_and_counters_match(pair):
    _, jeng, _, peng, _, _ = pair
    ph, jh = dataclasses.asdict(peng.health()), dataclasses.asdict(
        jeng.health())
    assert ph == jh
    assert ph["total_moe"] >= 2
    ps, js = peng.prefill_stats(), jeng.prefill_stats()
    for key in ("prefill_tokens_computed", "prefill_tokens_cached",
                "prefill_chunks", "prefix_cache_hits"):
        assert ps[key] == js[key], key


def test_case_outcome(pair):
    """Each case's own checks (tests/test_recovery.py's)."""
    name, jeng, _, peng, _, start = pair
    rep = peng.reports[0]
    kind = rep.moe_plan.kind.value if rep.moe_plan else None
    checks, alive = peng.expert_integrity()
    if name == "attn_fault":
        assert rep.scenario == "attn" and rep.migrated >= 1
        assert not next(ex for ex in peng.dp_executors
                        if ex.physical_id == 1).alive
    if name in ("role_switch", "megakernel", "mla_switch",
                "two_moe_failures"):
        for r in peng.reports:
            assert r.moe_plan.kind.value == "role_switch"
            assert r.timings.get("generator", 0.0) > 0   # read from disk
        # every migrated resident of the first donor KV-streamed; the
        # second donor found both other ranks' slots full, so its two
        # residents replay (charge_replay)
        assert _switch_counts(rep)[0] == _switch_counts(rep)[1] >= 1
        if name == "two_moe_failures":
            assert _switch_counts(peng.reports[1]) == (2, 0)
        assert all(alive)
        # the reloaded shards hold exactly the start-up weights
        assert checks == start
    if name in ("missing", "fused", "mla_missing"):
        assert kind == "missing_experts"
        mask = peng.runtime.expert_mask.numpy()
        lost = 2 if name != "mla_missing" else len(rep.moe_plan.lost_logicals)
        assert (~mask).sum() == lost > 0
        assert peng.cfg.moe_fused == (name == "fused")
        assert rep.timings.get("compile", 0.0) < 0.01
    if name == "background":
        assert kind == "role_switch" and rep.moe_plan.background
        assert rep.timings.get("generator", 0.0) == 0.0
        assert rep.timings.get("role_switch", 0.0) == 0.0
        assert peng.background_reports[0]["restored_experts"] == 2
        assert peng.expert_map.coverage() == 1.0
        assert bool(peng.runtime.expert_mask.all())
        assert all(alive) and checks == start
    if name in COMBINED:
        assert all(alive) and checks == start
        assert peng.expert_map.coverage() == 1.0
    if name == "kimi_dense_tp":     # tests/test_recovery.py:229
        g = peng.dense_groups
        assert g.num_healthy() == g.num_groups - 1
        w = g.routing_weights()
        assert abs(sum(w) - 1.0) < 1e-9 and 0.0 in w
        assert g.alive == jeng.dense_groups.alive
        assert any("dense-FFN TP group" in a for a in rep.actions)
    if name.startswith("mla"):
        assert peng.dense_groups.alive == jeng.dense_groups.alive
        compromised = any(a.startswith("dense-FFN TP group")
                          for a in rep.actions)
        assert compromised == (name == "mla_missing")
        assert all(peng.dense_groups.alive) == (name == "mla_switch")


def _switch_counts(report):
    """(migrated, KV-streamed) from a role switch's action."""
    act = next(a for a in report.actions if a.startswith("role switch:"))
    m = re.search(r"migrated (\d+) of its sequences \((\d+) KV-streamed\)",
                  act)
    return int(m.group(1)), int(m.group(2))


@pytest.mark.parametrize("writer", ["port", "np.savez", "np.savez_compressed"])
def test_load_axis1_slices_reads_each_writer(tmp_path, writer):
    """The role switch's reader: ``leaf[:, a:b]`` of stacked leaves, read
    run by run from an uncompressed file and through ``np.load`` from a
    compressed one, bits and type kept (a bf16 leaf by its tag); a range
    outside the leaf raises."""
    rng = np.random.default_rng(5)
    flat = {"moe/gate": rng.normal(size=(3, 8, 4, 5)).astype(np.float32),
            "moe/down": rng.normal(size=(3, 8, 6)).astype(np.float32)}
    bf = torch.from_numpy(rng.normal(size=(2, 8, 3)).astype(np.float32)
                          ).to(torch.bfloat16)
    path = str(tmp_path / "w.npz")
    if writer == "port":
        ckpt.save_flat(path, [*((k, torch.from_numpy(v))
                                for k, v in flat.items()), ("moe/up", bf)])
    else:
        getattr(np, writer.split(".")[1])(path, **flat)
    got = ckpt.load_axis1_slices(path, sorted(flat), 2, 6)
    assert sorted(got) == sorted(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(got[k].numpy(), v[:, 2:6])
    if writer == "port":
        up = ckpt.load_axis1_slices(path, ["moe/up"], 2, 6)["moe/up"]
        assert up.dtype == torch.bfloat16 and torch.equal(up, bf[:, 2:6])
    with pytest.raises(ValueError, match="cannot slice"):
        ckpt.load_axis1_slices(path, ["moe/down"], 6, 9)


def test_reload_reads_the_shard_file_when_one_exists(tmp_path):
    """Without a shard file a rank's experts come out of ``weights.npz``,
    equal to its start-up host copy; a per-rank shard file, when one
    exists, is read in its place (written here with doubled weights)."""
    eng = InferenceEngine(get_smoke_config(QWEN), EngineConfig(
        mode="disaggregated", num_dp=2, num_moe=2, max_batch=2, max_seq=64,
        block_size=8, num_blocks=64, workdir=str(tmp_path)), device="cpu")
    for r, shard in enumerate(eng.shards):
        got = load_expert_shard_from_checkpoint(
            eng.ckpt_path, eng.shards[0], r, workdir=str(tmp_path))
        assert sorted(got) == sorted(shard)
        assert all(torch.equal(got[k], v) for k, v in shard.items())
    save_shard_checkpoints(str(tmp_path), [{k: v * 2 for k, v in sh.items()}
                                           for sh in eng.shards])
    for r, shard in enumerate(eng.shards):
        got = load_expert_shard_from_checkpoint(
            eng.ckpt_path, eng.shards[0], r, workdir=str(tmp_path))
        assert all(torch.equal(got[k], v * 2) for k, v in shard.items())
