"""Both engines, one config, seed, prompt set and ``weights.npz``: the
port's collocated lockstep engine must serve the same token streams and
revive the same way as ``repro.serving.engine.InferenceEngine``.

The config is collocated, ``num_dp=2``, no role switch (as
tests/test_recovery.py:109).  Chunked admission with ``moe_impl="fused"``:
greedy without a fault, temperature 0.8 without a fault, and greedy with
an L6 ``attn+moe`` fault mid-step on physical 1 — once on the fully
replicated bank of test_recovery.py:109 (redundant experts cover the
loss) and once on the smoke bank (an expert is lost and masked).  Serial
admission (whole-prompt prefills) with the model's dense-scatter
``moe_impl``: greedy without a fault, and greedy with the same fault on
the smoke bank, whose migrated requests re-prefill whole.

The ``mla_*`` cases serve the ``deepseek-v3`` smoke model (multi-head
latent attention, one first-k dense layer beside one MoE layer) on the
same three paths: chunked composed and megakernel, and serial.  Its
fault also compromises a dense-FFN TP group; the recovery actions must
be ``repro``'s word for word.  Start-up writes ``weights.npz`` and no
per-rank shard file.
"""
import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core.fault_codes import Severity as JaxSeverity
from repro.core.weights import RecoveryPolicy as JaxPolicy
from repro.serving.engine import EngineConfig as JaxEngineConfig
from repro.serving.engine import InferenceEngine as JaxEngine
from repro.serving.sampling import SamplingParams as JaxSampling
from repro_torch.configs import get_smoke_config
from repro_torch.core.fault_codes import Severity
from repro_torch.core.weights import RecoveryPolicy
from repro_torch.serving.engine import EngineConfig, InferenceEngine
from repro_torch.serving.sampling import SamplingParams

MLA = "deepseek-v3"
CASES = {
    # name: (bank, temperature, fault, admission[, arch, decode_impl])
    "greedy": ("replicated", 0.0, False, "chunked"),
    "temp0.8": ("replicated", 0.8, False, "chunked"),
    "fault_redundant": ("replicated", 0.0, True, "chunked"),
    "fault_missing": ("smoke", 0.0, True, "chunked"),
    "serial_greedy": ("replicated", 0.0, False, "serial"),
    "serial_fault_missing": ("smoke", 0.0, True, "serial"),
    "mla_greedy": ("smoke", 0.0, False, "chunked", MLA),
    "mla_megakernel_greedy": ("smoke", 0.0, False, "chunked", MLA,
                              "megakernel"),
    "mla_fault_missing": ("smoke", 0.0, True, "chunked", MLA),
    "mla_megakernel_fault_missing": ("smoke", 0.0, True, "chunked", MLA,
                                     "megakernel"),
    "mla_serial_fault_missing": ("smoke", 0.0, True, "serial", MLA),
}
# chunked cases run the fused MoE; serial ones keep the model's default
# dense-scatter ``gather_psum`` (its expert FFN is the expert_ffn kernel)
MOE_IMPL = {"chunked": "fused", "serial": None}


def _case(name):
    """(bank, temperature, fault, admission, arch, decode_impl)."""
    bank, temp, fault, admission, *more = CASES[name]
    arch, decode_impl = (list(more) + ["qwen2-moe-a2.7b", None][len(more):])
    return bank, temp, fault, admission, arch, decode_impl


def _cfg(get_smoke, bank, arch="qwen2-moe-a2.7b"):
    cfg = get_smoke(arch)
    if bank == "replicated":   # tests/test_recovery.py:110
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, num_experts=4, num_redundant_experts=4, top_k=2))
    return cfg


def _prompts(vocab):
    """Four prompts, then a fifth that shares the first one's two leading
    blocks (submitted two steps later, so the prefix cache is hit)."""
    rng = np.random.default_rng(0)
    ps = [list(map(int, rng.integers(0, vocab, n))) for n in (18, 9, 13, 11)]
    ps.append(ps[0][:16] + list(map(int, rng.integers(0, vocab, 4))))
    return ps


def _serve(eng, vocab, fault, severity):
    if fault:
        eng.injector.schedule(3, 1, severity=severity.L6,
                              component="attn+moe", mid_step=True)
    prompts = _prompts(vocab)
    reqs = [eng.submit(p, 8) for p in prompts[:4]]
    eng.step()
    eng.step()
    reqs.append(eng.submit(prompts[4], 8))
    eng.run(max_steps=200)
    return reqs


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    return tmp_path_factory.mktemp("engines")


@pytest.fixture(scope="module", params=list(CASES))
def pair(request, shared):
    bank, temp, fault, admission, arch, decode_impl = _case(request.param)
    root = shared / request.param
    weights = shared / f"weights_{arch}_{bank}.npz"
    common = dict(mode="collocated", num_dp=2, max_batch=2, max_seq=64,
                  block_size=8, num_blocks=64, admission=admission,
                  moe_impl=MOE_IMPL[admission], decode_impl=decode_impl)

    jdir = root / "jax"
    jdir.mkdir(parents=True)
    if weights.exists():
        shutil.copy(weights, jdir / "weights.npz")
    jcfg = _cfg(jax_smoke_config, bank, arch)
    jeng = JaxEngine(jcfg, JaxEngineConfig(
        **common, workdir=str(jdir),
        persist_cache_dir=str(shared / "xla_cache"),
        sampling=JaxSampling(temperature=temp),
        policy=JaxPolicy(allow_role_switch=False)))
    if not weights.exists():
        shutil.copy(jdir / "weights.npz", weights)
    jreqs = _serve(jeng, jcfg.vocab_size, fault, JaxSeverity)

    pdir = root / "torch"
    pdir.mkdir()
    shutil.copy(weights, pdir / "weights.npz")
    pcfg = _cfg(get_smoke_config, bank, arch)
    peng = InferenceEngine(pcfg, EngineConfig(
        **common, workdir=str(pdir),
        sampling=SamplingParams(temperature=temp),
        policy=RecoveryPolicy(allow_role_switch=False)), device="cpu")
    preqs = _serve(peng, pcfg.vocab_size, fault, Severity)
    return request.param, jeng, jreqs, peng, preqs


def test_token_streams_identical(pair):
    _, _, jreqs, _, preqs = pair
    assert all(r.state.value == "finished" for r in preqs)
    assert [r.output_tokens for r in preqs] == \
        [r.output_tokens for r in jreqs]
    assert [r.migrations for r in preqs] == [r.migrations for r in jreqs]


def test_recovery_reports_match(pair):
    name, jeng, _, peng, _ = pair
    assert len(peng.reports) == len(jeng.reports) == int(_case(name)[2])
    assert peng.cfg.moe_impl == jeng.cfg.moe_impl
    assert peng.cfg.decode_impl == jeng.cfg.decode_impl
    for p, j in zip(peng.reports, jeng.reports):
        assert p.scenario == j.scenario
        assert p.actions == j.actions
        assert p.moe_plan.kind.value == j.moe_plan.kind.value
        assert p.migrated == j.migrated
        assert p.blocks_rolled_back == j.blocks_rolled_back
        assert p.compile_source == j.compile_source == "precompiled"
    if name.endswith("fault_missing"):
        assert peng.reports[0].scenario == "moe+missing_experts"
        assert peng.reports[0].migrated > 0
    if name.startswith("mla") and _case(name)[2]:
        # the first-k dense layer's TP group is compromised, as in repro
        assert any(a.startswith("dense-FFN TP group")
                   for a in peng.reports[0].actions)
        assert peng.dense_groups.alive == jeng.dense_groups.alive
        assert not all(peng.dense_groups.alive)
    if name == "fault_redundant":
        assert peng.reports[0].scenario == "moe+redundant_experts"


def test_final_runtime_matches(pair):
    _, jeng, _, peng, _ = pair
    for p, j in zip(peng.runtime, jeng.runtime):
        np.testing.assert_array_equal(p.numpy(), np.asarray(j))
    assert peng.shard_alive == jeng.shard_alive
    pc, palive = peng.expert_integrity()
    jc, jalive = jeng.expert_integrity()
    assert palive == jalive
    np.testing.assert_allclose(pc, jc, rtol=1e-5)


def test_admission_counters_match(pair):
    name, jeng, _, peng, _ = pair
    ps, js = peng.prefill_stats(), jeng.prefill_stats()
    for key in ("prefill_tokens_computed", "prefill_tokens_cached",
                "prefill_chunks", "prefix_cache_hits"):
        assert ps[key] == js[key], key
    if _case(name)[3] == "chunked":
        assert ps["prefix_cache_hits"] > 0
    else:        # whole prompts, one per step: no chunks, no cache
        assert ps["prefill_chunks"] == ps["prefix_cache_hits"] == 0
    ph, jh = dataclasses.asdict(peng.health()), dataclasses.asdict(
        jeng.health())
    ph.pop("soft_signals"), jh.pop("soft_signals")   # wall-clock based
    assert ph == jh


def test_start_up_writes_no_shard_files(pair):
    """Start-up writes ``weights.npz`` once and no per-rank expert shard
    file (no ported path reads one); the port still revives as repro,
    which writes them (test_recovery_reports_match)."""
    _, jeng, _, peng, _ = pair
    pfiles = os.listdir(peng.ecfg.workdir)
    assert "weights.npz" in pfiles
    assert not [f for f in pfiles if f.startswith("expert_shard_")]
    assert any(f.startswith("expert_shard_")
               for f in os.listdir(jeng.ecfg.workdir))


@pytest.mark.parametrize("option", [dict(overlap=True),
                                    dict(spec_window=2)])
def test_unported_options_raise(tmp_path, option):
    """The options that raised until their slice was ported (speculation,
    the overlap pipeline; the name is that check's) now build and serve:
    the streams equal the lockstep engine's without them."""
    cfg = get_smoke_config("qwen2-moe-a2.7b")
    out = []
    for sub, opt in (("plain", {}), ("option", option)):
        eng = InferenceEngine(cfg, EngineConfig(
            workdir=str(tmp_path / sub), **opt), device="cpu")
        reqs = [eng.submit([5, 9, 2, 7] * 5, 8), eng.submit([3, 1] * 8, 8)]
        eng.run(max_steps=100)
        out.append([list(r.output_tokens) for r in reqs])
    assert eng._overlap_active == option.get("overlap", False)
    assert eng.dp_executors[0].scheduler.spec_window == option.get(
        "spec_window", 0)
    assert out[0] == out[1]


@pytest.mark.parametrize("bad", [dict(mode="x"), dict(num_dp=0),
                                 dict(pool_undo="x"), dict(moe_impl="x")])
def test_engine_config_validation(bad):
    with pytest.raises(ValueError):
        EngineConfig(**bad)


def test_snapshot_pool_undo_matches_rows(tmp_path):
    """The legacy whole-cache copy and the row capture roll a mid-step
    fault back to the same streams."""
    cfg = get_smoke_config("qwen2-moe-a2.7b")
    out = []
    for undo in ("rows", "snapshot"):
        eng = InferenceEngine(cfg, EngineConfig(
            num_dp=2, max_batch=2, max_seq=64, block_size=8, num_blocks=64,
            moe_impl="fused", pool_undo=undo, workdir=str(tmp_path / undo),
            policy=RecoveryPolicy(allow_role_switch=False)), device="cpu")
        reqs = _serve(eng, cfg.vocab_size, True, Severity)
        assert eng.reports[0].migrated > 0
        out.append([r.output_tokens for r in reqs])
    assert out[0] == out[1]


def test_engine_without_card_needs_explicit_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceEngine(get_smoke_config("qwen2-moe-a2.7b"),
                        EngineConfig(workdir=str(tmp_path)))
    assert not os.listdir(tmp_path)


def _parity_engine(tmp_path, sub, **over):
    """tests/test_chunked_prefill.py:25's config: the qwen2-moe smoke
    model with capacity to spare (no copy is dropped at any chunk or
    bucket width), one DP rank, sampling at temperature 0.8."""
    cfg = get_smoke_config("qwen2-moe-a2.7b")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, num_experts=4, num_redundant_experts=2, top_k=2,
        capacity_factor=8.0, min_capacity=64))
    return cfg, InferenceEngine(cfg, EngineConfig(
        mode="collocated", num_dp=1, max_batch=4, max_seq=64, block_size=8,
        num_blocks=64, workdir=str(tmp_path / sub),
        sampling=SamplingParams(temperature=0.8, top_p=0.9, seed=3),
        **over), device="cpu")


def test_chunked_nocache_serial_token_parity(tmp_path):
    """The port's own three-way parity (tests/test_chunked_prefill.py:60):
    chunked admission with and without the prefix cache and serial
    whole-prompt prefills serve the same tokens on a mixed long/short
    workload."""
    cfg, chunked = _parity_engine(tmp_path, "c")
    _, nocache = _parity_engine(tmp_path, "n", prefix_cache=False)
    _, serial = _parity_engine(tmp_path, "s", admission="serial")
    rng = np.random.default_rng(1)
    sysp = list(rng.integers(0, cfg.vocab_size, 20))
    prompts = [list(rng.integers(0, cfg.vocab_size, 45)),
               sysp + list(rng.integers(0, cfg.vocab_size, 5)),
               sysp + list(rng.integers(0, cfg.vocab_size, 9)),
               list(rng.integers(0, cfg.vocab_size, 3))]
    outs = []
    for eng in (chunked, nocache, serial):
        reqs = [eng.submit([int(x) for x in p], 8) for p in prompts]
        eng.run(max_steps=400)
        assert all(r.state.value == "finished" for r in reqs)
        outs.append([list(r.output_tokens) for r in reqs])
    assert outs[0] == outs[1] == outs[2]
    stats = chunked.prefill_stats()
    assert stats["prefill_chunks"] >= 2          # the 45-token prompt chunked
    assert stats["prefill_tokens_cached"] > 0    # shared prefix hit
    assert serial.prefill_stats()["prefill_chunks"] == 0
