"""Self-speculative decode in the port against ``repro``, on the CPU.

The same smoke configs, prompts, seeds and ``weights.npz`` go through
both packages (the sizes of tests/test_spec_decode.py): the accept/reject
rule and the rejected-row undo against their JAX counterparts, the
overlap pipeline's sampling epilogue (``device_predict``) against
``repro``'s jitted one, and whole engines with ``spec_window=6`` — their
token streams, ``prefill_stats()`` and ``spec_histogram()`` equal to
``repro``'s and the streams equal to the port's plain decode, on GQA,
MLA, a sliding window and the megakernel (GQA and MLA).  Then the rejected rows'
bit-exact restore, a fault mid-window, and a masked rank's zero fresh
graph lookups, in the port.

The windowed case uses prompts under which windows are planned: under
``sliding_window=6`` the smoke model's greedy streams from
tests/test_spec_decode.py's prompts never let the n-gram proposer plan
one (that reference case fails on ``spec_windows > 0``, not on its
streams).
"""
import dataclasses
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core.fault_codes import ErrorType as JaxErrorType
from repro.core.fault_codes import Severity as JaxSeverity
from repro.serving.cache_ops import capture_pool_rows as jax_capture
from repro.serving.cache_ops import \
    restore_pool_rows_subset as jax_restore_subset
from repro.serving.engine import EngineConfig as JaxEngineConfig
from repro.serving.engine import InferenceEngine as JaxEngine
from repro.serving.sampling import SamplingParams as JaxSampling
from repro.serving.sampling import device_predict as jax_device_predict
from repro.serving.sampling import spec_verify as jax_spec_verify
from repro_torch.configs import get_smoke_config
from repro_torch.core.fault_codes import ErrorType, Severity
from repro_torch.serving.cache_ops import (capture_pool_rows,
                                           restore_pool_rows_subset)
from repro_torch.serving.engine import EngineConfig, InferenceEngine, _Ctx
from repro_torch.serving.sampling import (SamplingParams, device_predict,
                                          sample, spec_verify)
from test_torch_cases import one_torch_thread  # noqa: F401

QWEN, MLA = "qwen2-moe-a2.7b", "deepseek-v3"
PAT_A = [5, 9, 2, 7]
PAT_B = [3, 1]
# under the window, the proposer drafts from these (a period-8 and a
# constant prompt: the smoke model repeats tokens after them)
WINDOWED_PROMPTS = [[368, 304, 258, 173, 389, 200, 168, 455] * 4,
                    [435] * 25]


def _prompts(case="gqa_moe"):
    return ([list(p) for p in WINDOWED_PROMPTS] if case == "windowed"
            else [PAT_A * 5, PAT_B * 8])


def _windowed(cfg):
    return dataclasses.replace(cfg, sliding_window=6)


CASES = {
    # name: (arch, windowed, decode_impl)
    "gqa_moe": (QWEN, False, None),
    "mla_moe": (MLA, False, None),
    "windowed": (QWEN, True, None),
    "megakernel": (QWEN, False, "megakernel"),
    "mla_megakernel": (MLA, False, "megakernel"),
}
COMMON = dict(mode="collocated", max_batch=2, max_seq=96, block_size=8,
              num_blocks=64)


def _cfgs(arch, windowed):
    jcfg, pcfg = jax_smoke_config(arch), get_smoke_config(arch)
    return ((_windowed(jcfg), _windowed(pcfg)) if windowed
            else (jcfg, pcfg))


def _sampling(temperature):
    return dict(temperature=temperature, top_p=0.9, seed=3)


class Shared:
    """One weights.npz per architecture, written by ``repro``'s first
    engine, and one XLA cache for every JAX engine of the module."""

    def __init__(self, root):
        self.root = root

    def jax_engine(self, sub, arch, windowed=False, **kw):
        jcfg, _ = _cfgs(arch, windowed)
        wd = self.root / sub / "jax"
        wd.mkdir(parents=True)
        weights = self.root / f"weights_{arch}.npz"
        if weights.exists():
            shutil.copy(weights, wd / "weights.npz")
        temp = kw.pop("temperature", 0.0)
        eng = JaxEngine(jcfg, JaxEngineConfig(
            **{**COMMON, **kw}, workdir=str(wd),
            persist_cache_dir=str(self.root / "xla_cache"),
            sampling=JaxSampling(**_sampling(temp))))
        if not weights.exists():
            shutil.copy(wd / "weights.npz", weights)
        return eng

    def torch_engine(self, sub, arch, windowed=False, **kw):
        _, pcfg = _cfgs(arch, windowed)
        wd = self.root / sub / "torch"
        wd.mkdir(parents=True)
        weights = self.root / f"weights_{arch}.npz"
        if not weights.exists():      # the reference writes it
            self.jax_engine(sub + "_w", arch, windowed)
        shutil.copy(weights, wd / "weights.npz")
        temp = kw.pop("temperature", 0.0)
        return InferenceEngine(pcfg, EngineConfig(
            **{**COMMON, **kw}, workdir=str(wd),
            sampling=SamplingParams(**_sampling(temp))), device="cpu")


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    return Shared(tmp_path_factory.mktemp("spec"))


def _serve(eng, prompts, max_new=24):
    reqs = [eng.submit(list(p), max_new) for p in prompts]
    eng.run(max_steps=400)
    assert all(r.state.value == "finished" for r in reqs), \
        [r.state for r in reqs]
    return [list(r.output_tokens) for r in reqs]


# -- units: accept/reject, rejected-row undo, the sampling epilogue ---------


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_spec_verify_matches_reference(temperature):
    """Same logits and drafts: the same emitted tokens and accept count,
    for a partly accepted, a fully accepted and a rejected window."""
    rng = np.random.default_rng(0)
    g, V, base = 5, 64, 40
    logits = rng.normal(size=(g, V)) * 3.0
    params = SamplingParams(temperature=temperature, top_p=0.9, seed=7)
    jparams = JaxSampling(temperature=temperature, top_p=0.9, seed=7)
    targets = [int(sample(logits[r][None], params, step=base + r)[0])
               for r in range(g)]
    for drafts in ([targets[0], targets[1], (targets[2] + 1) % V, 0],
                   targets[:g - 1], [(targets[0] + 1) % V], []):
        toks, acc = spec_verify(logits, drafts, params, start_step=base)
        jtoks, jacc = jax_spec_verify(logits, drafts, jparams,
                                      start_step=base)
        assert acc == jacc
        np.testing.assert_array_equal(toks, jtoks)
        assert list(toks) == targets[:acc + 1]


def _pools(rng, nb=6, bs=4, L=2):
    """A GQA cache's two pool leaves and an MLA-style latent pool."""
    return {"layers": {"k": rng.normal(size=(L, nb, bs, 2, 8)),
                       "v": rng.normal(size=(L, nb, bs, 2, 8))},
            "mla": {"ckr": rng.normal(size=(L, nb, bs, 12))}}


def _leaves(cache):
    return [cache["layers"]["k"], cache["layers"]["v"], cache["mla"]["ckr"]]


def test_restore_pool_rows_subset_matches_reference():
    """Capture a write set (trash-row repeats included), overwrite it,
    restore a subset: the port's in-place pools equal the JAX result."""
    rng = np.random.default_rng(1)
    host = {g: {k: v.astype(np.float32) for k, v in d.items()}
            for g, d in _pools(rng).items()}
    axes = [None, None, None]
    bids = np.asarray([0, 1, 1, 3, 5, 5, 5], np.int32)
    offs = np.asarray([2, 0, 3, 1, 0, 0, 0], np.int32)
    idx = np.asarray([1, 2, 4, 6], np.int32)

    jcache = {g: {k: jnp.asarray(v) for k, v in d.items()}
              for g, d in host.items()}
    pcache = {g: {k: torch.from_numpy(v.copy()) for k, v in d.items()}
              for g, d in host.items()}
    jundo = jax_capture(jcache, axes, bids, offs)
    pundo = capture_pool_rows(pcache, axes, bids, offs)
    # the step's writes land on the captured rows (repeats included)
    bl, ol = torch.from_numpy(bids).long(), torch.from_numpy(offs).long()
    for c in _leaves(pcache):
        c[:, bl, ol] = -7.0
    jcache = {g: {k: jnp.asarray(pcache[g][k].numpy()) for k in d}
              for g, d in jcache.items()}
    jout = jax_restore_subset(jcache, axes, jundo, idx)
    pout = restore_pool_rows_subset(pcache, axes, pundo, idx)
    assert pout is pcache                          # in place
    for g, d in jout.items():
        for k, v in d.items():
            np.testing.assert_array_equal(pcache[g][k].numpy(),
                                          np.asarray(v))
    # the restored rows hold their captured bits; the others the writes
    k0 = pcache["layers"]["k"].numpy()
    assert np.array_equal(k0[:, 1, 3], host["layers"]["k"][:, 1, 3])
    assert not np.array_equal(k0[:, 0, 2], host["layers"]["k"][:, 0, 2])


def _predict_inputs(rng, G=4, S=5, R=23, V=96, B=6):
    logits = (rng.normal(size=(R, V)) * 2.5).astype(np.float32)
    row0 = np.asarray([0, 4, 9, 17, 0], np.int32)[:S]
    lens = np.asarray([4, 3, 1, 4, 0], np.int32)[:S]     # last: padding
    targets = logits.argmax(-1)
    drafts = np.zeros((S, G), np.int32)
    for i in range(S):
        for r in range(1, G):
            # match the row before for some drafts, miss for others
            t = targets[min(row0[i] + r - 1, R - 1)]
            drafts[i, r] = t if (i + r) % 3 else (t + 1) % V
    u = rng.random(size=(S, G)).astype(np.float32)
    dev_last = rng.integers(0, V, B).astype(np.int32)
    slots = np.asarray([3, 0, 5, 1, B], np.int32)[:S]    # B: out of range
    return logits, row0, lens, drafts, u, dev_last, slots


def _cdf_margin(logits, row0, G, u, temperature, top_p):
    """For each (window, row): the distance of its uniform to the nearest
    value of its top-p CDF (f64 from the f32 logits)."""
    idx = np.clip(row0[:, None] + np.arange(G), 0, logits.shape[0] - 1)
    z = logits[idx].astype(np.float64) / temperature
    z -= z.max(-1, keepdims=True)
    p = np.exp(z)
    p /= p.sum(-1, keepdims=True)
    sp = -np.sort(-p, axis=-1)
    csum = np.cumsum(sp, -1)
    sp = np.where(csum - sp > top_p, 0.0, sp)
    sp /= sp.sum(-1, keepdims=True)
    cdf = np.cumsum(sp, -1)
    return np.abs(cdf - u[..., None].astype(np.float64)).min(-1)


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_device_predict_matches_reference(temperature):
    """The port's epilogue against ``repro``'s jitted one on the same
    numpy inputs: exact at temperature 0; at 0.8 exact on every row whose
    uniform lies more than 1e-6 from every CDF value (the two sum the f32
    CDF in other orders), and every window whose rows all do."""
    rng = np.random.default_rng(2)
    args = _predict_inputs(rng)
    top_p = 0.9
    jt, ja, jl = (np.asarray(x) for x in jax_device_predict(
        *(jnp.asarray(a) for a in args), temperature=temperature,
        top_p=top_p))
    pt, pa, pl = (x.numpy() for x in device_predict(
        *(torch.from_numpy(a) for a in args), temperature=temperature,
        top_p=top_p))
    assert pt.dtype == pa.dtype == pl.dtype == np.int32
    if temperature == 0.0:
        clean = np.ones(jt.shape, bool)
    else:
        logits, row0, _, _, u, _, _ = args
        clean = _cdf_margin(logits, row0, jt.shape[1], u, temperature,
                            top_p) > 1e-6
        assert clean.mean() > 0.9
    np.testing.assert_array_equal(pt[clean], jt[clean])
    whole = clean.all(axis=1)
    np.testing.assert_array_equal(pa[whole], ja[whole])
    slots = args[-1]
    for i in np.flatnonzero(whole):
        if slots[i] < len(pl):
            assert pl[slots[i]] == jl[slots[i]]
    # padding rows and out-of-range slots leave the chain as it was
    untouched = [b for b in range(len(pl)) if b not in slots[:4]]
    np.testing.assert_array_equal(pl[untouched], args[5][untouched])


# -- engines: streams and statistics against repro --------------------------


@pytest.fixture(scope="module", params=list(CASES))
def spec_run(request, shared):
    """``repro``'s spec engine, the port's spec engine and the port's
    plain (composed, no speculation) engine on one case's prompts."""
    name = request.param
    arch, windowed, impl = CASES[name]
    prompts = _prompts(name)
    jeng = shared.jax_engine(name, arch, windowed, num_dp=1,
                             decode_impl=impl, spec_window=6)
    jout = _serve(jeng, prompts)
    peng = shared.torch_engine(name, arch, windowed, num_dp=1,
                               decode_impl=impl, spec_window=6)
    pout = _serve(peng, prompts)
    plain = shared.torch_engine(name + "_plain", arch, windowed, num_dp=1)
    return name, jeng, jout, peng, pout, _serve(plain, prompts)


def test_spec_streams_match_reference(spec_run):
    """The port's speculative streams equal ``repro``'s and the port's
    plain decode, and windows were planned in both packages."""
    name, jeng, jout, peng, pout, plain = spec_run
    assert pout == jout
    assert pout == plain
    assert jeng.prefill_stats()["spec_windows"] > 0
    assert peng.prefill_stats()["spec_windows"] > 0


def test_spec_stats_match_reference(spec_run):
    """``prefill_stats()`` (windows, drafts, accepted, emitted included)
    and ``spec_histogram()`` equal ``repro``'s."""
    _, jeng, _, peng, _, _ = spec_run
    assert peng.prefill_stats() == jeng.prefill_stats()
    assert peng.spec_histogram() == jeng.spec_histogram()
    stats = peng.prefill_stats()
    assert stats["spec_emitted"] >= stats["spec_windows"]
    hist = peng.spec_histogram()
    assert sum(hist.values()) == stats["spec_windows"]
    assert all(2 <= g <= 6 for g, n in hist.items() if n)


def test_spec_rejected_rows_rollback_bitexact(shared):
    """Rows written for rejected drafts are restored bit-exact, in place,
    from the plan-time capture; the window's row 0 write stands."""
    eng = shared.torch_engine("rb", QWEN, num_dp=1, spec_window=6)
    req = eng.submit(PAT_A * 5, 24)
    ex = eng.dp_executors[0]
    ctx = _Ctx(eng)
    checked = False
    for step in range(60):
        if req.state.value == "finished":
            break
        plan = ex.plan()
        win = next((w for w in plan.spec if w.req is req), None)
        if win is not None:
            bs = ex.block_size
            table = ex.scheduler.block_tables[req.req_id].blocks
            pos = range(win.start, win.start + win.length)
            bids = np.asarray([table[p // bs] for p in pos], np.int32)
            offs = np.asarray([p % bs for p in pos], np.int32)
            pre = capture_pool_rows(ex.cache, ex.paged_axes, bids, offs)
        n_before = req.num_tokens
        ex.compute(ctx, step)
        ex.commit()
        if win is None:
            continue
        emitted = req.num_tokens - n_before
        assert emitted >= 1
        post = capture_pool_rows(ex.cache, ex.paged_axes, bids, offs)
        changed_row0 = False
        for a, b, ax in zip(pre["rows"], post["rows"], ex.paged_axes):
            if ax is not None:
                continue
            assert torch.equal(b[:, emitted:], a[:, emitted:])
            if not torch.equal(b[:, 0], a[:, 0]):
                changed_row0 = True
        assert changed_row0
        if emitted < win.length:
            checked = True
    assert checked, "no speculation window was ever partially rejected"


def test_spec_fault_midwindow_replay_parity(shared):
    """A mid-step L6 fault while windows are in flight rolls back and
    replays to the stream of the plain engine under the same fault, and
    to ``repro``'s speculative engine under it."""

    def fault(eng, severity, error_type):
        eng.injector.schedule(3, 1, severity=severity.L6,
                              error_type=error_type.HBM_ECC,
                              component="attn", mid_step=True)
        out = _serve(eng, _prompts())
        surviving = [ex for ex in eng.dp_executors if ex.alive]
        assert surviving and all(
            ex.block_manager.num_allocated == 0 for ex in surviving)
        assert eng.reports
        return out

    want = fault(shared.torch_engine("fault_plain", QWEN, num_dp=2),
                 Severity, ErrorType)
    peng = shared.torch_engine("fault_spec", QWEN, num_dp=2, spec_window=6)
    got = fault(peng, Severity, ErrorType)
    jeng = shared.jax_engine("fault_spec", QWEN, num_dp=2, spec_window=6)
    jout = fault(jeng, JaxSeverity, JaxErrorType)
    assert got == want == jout
    assert peng.prefill_stats() == jeng.prefill_stats()
    assert peng.prefill_stats()["spec_windows"] > 0
    assert peng.reports[0].scenario == jeng.reports[0].scenario


def test_spec_failrank_mask_zero_recompile(shared):
    """fail_rank + mask_experts while speculating are pure MoERuntime
    data edits: the spec windows keep flowing through the chunk graph and
    no graph is looked up fresh."""
    eng = shared.torch_engine("zc", QWEN, num_dp=2, spec_window=6,
                              precompile_failure_scenarios=False)
    _serve(eng, [PAT_A * 4], max_new=8)
    n0 = len(eng.graph_cache.timings)
    emap = eng.expert_map
    emap.fail_rank(1)
    emap.mask_experts(
        [e for e in range(eng.cfg.moe.num_experts)
         if not any(s not in set(emap.rank_slots(1))
                    for s in emap.replicas_of(e))])
    eng.runtime = emap.runtime()
    windows = eng.prefill_stats()["spec_windows"]
    _serve(eng, [PAT_B * 10], max_new=12)
    assert not eng.graph_cache.fresh_since(n0)
    assert eng.prefill_stats()["spec_windows"] > windows
