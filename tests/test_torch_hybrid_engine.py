"""Both engines, the ``jamba-1.5-large-398b`` smoke config (one hybrid
period: attention at sublayer 4, Mamba on the other seven, MoE on the odd
ones), one seed, prompt set and ``weights.npz``: the port must serve the
same token streams and revive the same way as
``repro.serving.engine.InferenceEngine``.

A period's cache entry holds attention pools and seven per-slot Mamba
states, so every revive below rolls back, migrates and re-prefills both
kinds together.  The model cannot chunk its prefill: both admissions
install whole prompts, the Mamba state taken after the bucket and every
slot's state advanced by each decode step, in ``repro`` and in the port
alike (ROADMAP Queue 3).

Scenarios:

- ``collocated``: ``num_dp=2``, the fused MoE, an L6 ``attn+moe`` fault
  mid-step on physical 1 at step 3; the smoke bank (4 experts + 2
  replicas) loses logicals it cannot cover, so both revive as
  ``moe+missing_experts``.
- ``disaggregated``: tests/test_recovery.py:326-344 (capacity factor 4,
  two attention and two expert ranks, an L6 ``attn`` fault on physical 1
  at step 3), with a fixed ``virtual_step_s`` so that the wall-clock
  straggler detector stays out of it.
- ``overlap``: the collocated scenario with ``overlap=True``: a model
  that cannot chunk falls back to lockstep in both packages, so its
  streams are the lockstep streams and nothing is planned ahead.

Beside them, the spare's path (``export_live_requests`` -> ``admit``)
moves one request between two engines of each package, with its pool
blocks and states and without them.
"""
import dataclasses
import shutil

import numpy as np
import pytest

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core.fault_codes import Severity as JaxSeverity
from repro.serving.engine import EngineConfig as JaxEngineConfig
from repro.serving.engine import InferenceEngine as JaxEngine
from repro_torch.configs import get_smoke_config
from repro_torch.core.fault_codes import Severity
from repro_torch.serving.engine import EngineConfig, InferenceEngine

ARCH = "jamba-1.5-large-398b"
VIRTUAL_STEP_S = 0.01
COMMON = dict(max_batch=2, max_seq=64, block_size=8, num_blocks=64)
SCENARIOS = {
    # name: (engine options, capacity factor, fault component)
    "collocated": (dict(mode="collocated", num_dp=2, moe_impl="fused"),
                   None, "attn+moe"),
    "disaggregated": (dict(mode="disaggregated", num_dp=2, num_moe=2),
                      4.0, "attn"),
    "overlap": (dict(mode="collocated", num_dp=2, moe_impl="fused",
                     overlap=True), None, "attn+moe"),
}


def _cfg(get_smoke, capacity_factor):
    cfg = get_smoke(ARCH)
    if capacity_factor is not None:    # tests/test_recovery.py:331
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor))
    return cfg


def _serve(eng, vocab, component, severity):
    """tests/test_recovery.py:335: three 8-token prompts of 10 new
    tokens, the fault mid-step at step 3 on physical 1."""
    eng.virtual_step_s = VIRTUAL_STEP_S
    eng.injector.schedule(3, 1, severity=severity.L6, component=component,
                          mid_step=True)
    rng = np.random.default_rng(0)
    reqs = [eng.submit(list(map(int, rng.integers(0, vocab, 8))), 10)
            for _ in range(3)]
    eng.run(max_steps=150)
    return reqs


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    return tmp_path_factory.mktemp("hybrid_engines")


@pytest.fixture(scope="module", params=list(SCENARIOS))
def pair(request, shared):
    opts, factor, component = SCENARIOS[request.param]
    root = shared / request.param
    weights = shared / f"weights_{factor}.npz"
    jdir = root / "jax"
    jdir.mkdir(parents=True)
    if weights.exists():
        shutil.copy(weights, jdir / "weights.npz")
    jcfg = _cfg(jax_smoke_config, factor)
    jeng = JaxEngine(jcfg, JaxEngineConfig(
        **COMMON, **opts, workdir=str(jdir),
        persist_cache_dir=str(shared / "xla_cache")))
    if not weights.exists():
        shutil.copy(jdir / "weights.npz", weights)
    jreqs = _serve(jeng, jcfg.vocab_size, component, JaxSeverity)
    pdir = root / "torch"
    pdir.mkdir()
    shutil.copy(weights, pdir / "weights.npz")
    pcfg = _cfg(get_smoke_config, factor)
    peng = InferenceEngine(pcfg, EngineConfig(
        **COMMON, **opts, workdir=str(pdir)), device="cpu")
    preqs = _serve(peng, pcfg.vocab_size, component, Severity)
    return request.param, jeng, jreqs, peng, preqs


def test_token_streams_identical(pair):
    _, _, jreqs, _, preqs = pair
    assert all(r.state.value == "finished" for r in preqs)
    assert [r.output_tokens for r in preqs] == \
        [r.output_tokens for r in jreqs]
    assert [r.migrations for r in preqs] == [r.migrations for r in jreqs]


def test_recovery_reports_match(pair):
    name, jeng, _, peng, _ = pair
    assert len(peng.reports) == len(jeng.reports) == 1
    p, j = peng.reports[0], jeng.reports[0]
    assert p.scenario == j.scenario
    assert p.actions == j.actions
    assert (p.moe_plan is None) == (j.moe_plan is None)
    if p.moe_plan is not None:
        assert p.moe_plan.kind.value == j.moe_plan.kind.value
        assert p.moe_plan.lost_logicals == j.moe_plan.lost_logicals
    assert p.migrated == j.migrated >= 1
    assert p.blocks_rolled_back == j.blocks_rolled_back
    assert p.compile_source == j.compile_source == "precompiled"
    if name in ("collocated", "overlap"):
        assert p.scenario == "moe+missing_experts"
        assert p.moe_plan.lost_logicals
    np.testing.assert_array_equal(peng.runtime.expert_mask.numpy(),
                                  np.asarray(jeng.runtime.expert_mask))
    assert peng.shard_alive == jeng.shard_alive


def test_whole_prompt_admission_and_health(pair):
    """The period cannot chunk: every prompt is one whole-prompt install,
    in both packages; health (bar the wall-clock signals) is equal."""
    _, jeng, _, peng, _ = pair
    assert not peng.model.supports_chunked_prefill
    ps, js = peng.prefill_stats(), jeng.prefill_stats()
    for key in ("prefill_tokens_computed", "prefill_tokens_cached",
                "prefill_chunks", "prefix_cache_hits"):
        assert ps[key] == js[key], key
    assert ps["prefill_chunks"] == ps["prefix_cache_hits"] == 0
    assert ("install", 0, 16) in peng.graph_cache
    ph, jh = dataclasses.asdict(peng.health()), dataclasses.asdict(
        jeng.health())
    ph.pop("soft_signals"), jh.pop("soft_signals")
    assert ph == jh


def test_overlap_falls_back_to_lockstep(pair):
    """``overlap=True`` on a model that cannot chunk serves in lockstep
    in both packages: no step is planned ahead, and (in the ``overlap``
    scenario) the streams are the collocated lockstep scenario's."""
    name, jeng, jreqs, peng, preqs = pair
    assert peng._overlap_active is False
    assert jeng._overlap_active is False
    for eng in (peng, jeng):
        stats = eng.overlap_stats()
        assert stats["planned_ahead"] == stats["replans"] == 0
    if name == "overlap":
        opts, factor, component = SCENARIOS["collocated"]
        workdir = peng.ecfg.workdir + "_lockstep"
        shutil.copytree(peng.ecfg.workdir, workdir)
        lock = InferenceEngine(_cfg(get_smoke_config, factor), EngineConfig(
            **COMMON, **opts, workdir=workdir), device="cpu")
        reqs = _serve(lock, lock.cfg.vocab_size, component, Severity)
        assert [r.output_tokens for r in reqs] == \
            [r.output_tokens for r in preqs]


# -- the spare's path: export_live_requests -> admit ------------------------------

def _round_trip(side, workdir, **kw):
    """tests/test_torch_fleet_engine.py::_kv_round_trip on the hybrid: a
    request four steps into its generation is exported from one engine,
    with its pool blocks and seven Mamba states ("stream") or without
    them ("replay"), and admitted on another that runs it to the end."""
    cfg = side.smoke(ARCH)
    ec = side.EC(**COMMON, mode="collocated", num_dp=1, moe_impl="fused",
                 workdir=str(workdir), **kw)
    src, tgt = side.Engine(cfg, ec), side.Engine(cfg, ec)
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
        assert req2 is req
        tgt.admit(req, kv=kv)
        tgt.run(max_steps=80)
        outs[mode] = (req.state.value, mid, list(req.output_tokens),
                      req.recomputed_tokens)
    return outs


def test_export_admit_round_trip_matches_repro(shared):
    """The spare's path moves both kinds of state: each package's streamed
    and replayed request finishes, only the replay recomputes, and every
    stream and count equals the reference's."""
    from test_torch_fleet_cases import JAX, TORCH
    root = shared / "round_trip"
    weights = shared / "weights_None.npz"
    jdir, pdir = root / "jax", root / "torch"
    jdir.mkdir(parents=True)
    if weights.exists():
        shutil.copy(weights, jdir / "weights.npz")
    ref = _round_trip(JAX, jdir, persist_cache_dir=str(shared / "xla_cache"))
    pdir.mkdir()
    shutil.copy(jdir / "weights.npz", pdir / "weights.npz")
    got = _round_trip(TORCH, pdir)
    for mode in ("stream", "replay"):
        state, mid, _, _ = got[mode]
        assert state == "finished" and 0 < mid < 12
    assert got["stream"][3] == 0 < got["replay"][3]
    assert got == ref
