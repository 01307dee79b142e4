"""The port's Mamba family against the JAX package, on the CPU: the plain
selective scan against ``ref.ssm_scan_ref`` and ``ssm_scan_pallas`` in
interpret mode, the Mamba block functions, the ``falcon-mamba-7b`` smoke
model's whole-prompt prefill, install and paged decode, the state-only
cache under the §3.3 undo, both engines serving and reviving an
attention fault, and the checkpoint carry-across.  Inputs come from
``np.random.default_rng`` and go to both packages; weights are
JAX-initialised and carried across by the checkpoint loader.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core.fault_codes import Severity as JaxSeverity
from repro.kernels import ref
from repro.kernels.ssm_scan import ssm_scan_pallas
from repro.models import mamba as jax_mamba
from repro.models.model import Model as JaxModel
from repro.serving import cache_ops as jax_cache_ops
from repro.serving.engine import EngineConfig as JaxEngineConfig
from repro.serving.engine import InferenceEngine as JaxEngine
from repro.serving.kvcache import padded_block_ids
from repro.serving.sampling import SamplingParams as JaxSampling
from repro.training.checkpoint import _flatten
from repro.training.checkpoint import save_checkpoint as jax_save
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.fault_codes import Severity
from repro_torch.kernels import ops
from repro_torch.kernels.ssm_scan import ssm_scan_cuda, ssm_scan_plain
from repro_torch.models import mamba as pt_mamba
from repro_torch.models.model import Model
from repro_torch.serving import cache_ops
from repro_torch.serving.engine import EngineConfig, InferenceEngine
from repro_torch.serving.sampling import SamplingParams
from repro_torch.training import checkpoint as ckpt
from test_torch_cases import SSM_CASES, ssm_inputs, t as _t
from test_torch_cases import one_torch_thread  # noqa: F401

ARCH = "falcon-mamba-7b"
# tests/test_kernels.py:89 in f32; bf16 inputs, f32 state and output
SCAN_TOL = {"float32": (1e-4, 1e-5), "bfloat16": (2e-2, 2e-2)}
BLOCK_TOL = 1e-4
LOGIT_TOL = 2e-4                 # tests/test_paged_serving.py:180
BS, NUM_BLOCKS, MAX_BATCH = 4, 24, 2


def _jdt(dtype):
    return jnp.bfloat16 if dtype == "bfloat16" else jnp.float32


# -- the selective scan ---------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(SSM_CASES))
def test_ssm_scan_plain_vs_jax(case, dtype):
    B, S, d, N, block_d, chunk, with_h0 = SSM_CASES[case]
    u, dt, A, Bs, Cs, h0 = ssm_inputs(B, S, d, N, with_h0)
    # u, dt, B and C in the working type; A and the state in f32
    got_y, got_h = ssm_scan_plain(
        *(_t(a).to(getattr(torch, dtype)) for a in (u, dt)), _t(A),
        *(_t(a).to(getattr(torch, dtype)) for a in (Bs, Cs)),
        None if h0 is None else _t(h0))
    assert got_y.dtype == got_h.dtype == torch.float32
    assert got_y.shape == (B, S, d) and got_h.shape == (B, d, N)
    jargs = [jnp.asarray(a).astype(_jdt(dtype)) for a in (u, dt)]
    jargs += [jnp.asarray(A)]
    jargs += [jnp.asarray(a).astype(_jdt(dtype)) for a in (Bs, Cs)]
    wants = [ref.ssm_scan_ref(*jargs, None if h0 is None
                              else jnp.asarray(h0))]
    if h0 is None:        # the TPU kernel always starts from zero
        wants.append(ssm_scan_pallas(*jargs, block_d=block_d, chunk=chunk,
                                     interpret=True))
    rtol, atol = SCAN_TOL[dtype]
    for want_y, want_h in wants:
        np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y),
                                   rtol=rtol, atol=atol)
        np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h),
                                   rtol=rtol, atol=atol)


def test_ssm_scan_dispatch_by_device():
    """On CPU tensors ``ops.ssm_scan`` is the plain version, bit for bit;
    the launcher refuses them instead of falling back."""
    u, dt, A, Bs, Cs, h0 = map(lambda a: None if a is None else _t(a),
                               ssm_inputs(2, 7, 24, 8, True))
    for init in (None, h0):
        for got, want in zip(ops.ssm_scan(u, dt, A, Bs, Cs, init),
                             ssm_scan_plain(u, dt, A, Bs, Cs, init)):
            assert torch.equal(got, want)
    with pytest.raises(ValueError, match="CUDA"):
        ssm_scan_cuda(u, dt, A, Bs, Cs)


def test_ssm_scan_plain_chains():
    """Scanning a sequence in two pieces, the second from the first's
    state, is scanning it whole: what decode does one token at a time."""
    u, dt, A, Bs, Cs = map(_t, ssm_inputs(2, 12, 40, 16, False)[:5])
    y, h = ssm_scan_plain(u, dt, A, Bs, Cs)
    y1, h1 = ssm_scan_plain(u[:, :5], dt[:, :5], A, Bs[:, :5], Cs[:, :5])
    y2, h2 = ssm_scan_plain(u[:, 5:], dt[:, 5:], A, Bs[:, 5:], Cs[:, 5:],
                            h0=h1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y, rtol=0, atol=0)
    torch.testing.assert_close(h2, h, rtol=0, atol=0)


# -- the Mamba block ------------------------------------------------------------

@pytest.fixture(scope="module")
def mixer():
    """One mixer's parameters from ``repro.models.mamba.mamba_init``, in
    both packages."""
    cfg = jax_smoke_config(ARCH)
    jp = jax_mamba.mamba_init(jax.random.PRNGKey(5), cfg)
    pp = {k: _t(np.asarray(v)) for k, v in jp.items()}
    return cfg, jp, pp


def _x(shape, seed):
    return (np.random.default_rng(seed).normal(size=shape)
            .astype(np.float32))


@pytest.mark.parametrize("S", [3, 12], ids=["S<d_conv", "S12"])
@pytest.mark.parametrize("return_state", [False, True])
def test_mamba_forward_matches_jax(mixer, S, return_state):
    cfg, jp, pp = mixer
    x = _x((2, S, cfg.d_model), S)
    want = jax_mamba.mamba_forward(jp, cfg, jnp.asarray(x),
                                   return_state=return_state)
    got = pt_mamba.mamba_forward(pp, get_smoke_config(ARCH), _t(x),
                                 return_state=return_state)
    if not return_state:
        want, got = (want,), (got,)
    else:
        want = (want[0], want[1].conv, want[1].ssm)
        got = (got[0], got[1].conv, got[1].ssm)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=BLOCK_TOL,
                                   rtol=BLOCK_TOL)


def test_mamba_decode_matches_jax(mixer):
    """Three decode steps from a non-zero state: outputs and the state,
    which the port updates in place."""
    cfg, jp, pp = mixer
    pcfg = get_smoke_config(ARCH)
    d_inner, N, d_conv, _ = pt_mamba.mamba_dims(pcfg)
    conv0 = _x((3, d_conv, d_inner), 1)
    ssm0 = _x((3, d_inner, N), 2) * 0.3
    jstate = jax_mamba.MambaState(jnp.asarray(conv0), jnp.asarray(ssm0))
    pstate = {"conv": _t(conv0), "ssm": _t(ssm0)}
    for step in range(3):
        x = _x((3, cfg.d_model), 10 + step)
        want, jstate = jax_mamba.mamba_decode(jp, cfg, jnp.asarray(x),
                                              jstate)
        got = pt_mamba.mamba_decode(pp, pcfg, _t(x), pstate)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=BLOCK_TOL, rtol=BLOCK_TOL)
        for key in ("conv", "ssm"):
            np.testing.assert_allclose(pstate[key].numpy(),
                                       np.asarray(getattr(jstate, key)),
                                       atol=BLOCK_TOL, rtol=BLOCK_TOL)


# -- the model: whole-prompt prefill, install, paged decode -----------------------

@pytest.fixture(scope="module")
def models():
    jm = JaxModel(jax_smoke_config(ARCH))
    jparams = jm.init(jax.random.PRNGKey(0))
    pparams = ckpt.params_from_flat(_flatten(jparams).items(), {},
                                    dtype=torch.float32, device="cpu")
    return jm, jparams, Model(get_smoke_config(ARCH), device="cpu"), pparams


def test_model_structure(models):
    _, jparams, pm, pparams = models
    assert pm.layer_groups() == [("layers", 2, "mamba", None, False)]
    assert not pm.supports_chunked_prefill
    assert pm.default_runtime() is None and pm._cap(8) == 0
    fresh = pm.init(0)
    assert sorted(k for k, _ in ckpt.flatten(fresh)) == \
        sorted(_flatten(jparams))
    for key, leaf in ckpt.flatten(fresh):
        assert tuple(leaf.shape) == _flatten(jparams)[key].shape, key
    cache = pm.init_paged_cache(3, NUM_BLOCKS, BS)
    assert cache_ops.infer_paged_axes(pm, NUM_BLOCKS, BS) == [1, 1]
    assert tuple(cache["layers"]["conv"].shape) == (2, 3, 4, 512)
    assert tuple(cache["layers"]["ssm"].shape) == (2, 3, 512, 16)


def test_prefill_install_decode_matches_jax(models):
    """The SSM case of tests/test_paged_serving.py::_run_parity, port
    against ``repro``: a 9-token prompt prefilled at bucket 16 (so the
    padding runs through the recurrence in both), installed into slot 1,
    then five greedy decode steps."""
    jm, jparams, pm, pparams = models
    rng = np.random.default_rng(0)
    toks = list(rng.integers(0, jm.cfg.vocab_size, 9))
    tokens = np.zeros((1, 16), np.int32)
    tokens[0, :9] = toks
    lengths = np.asarray([9], np.int32)
    jl, jraw = jm.prefill_paged(jparams, {"tokens": jnp.asarray(tokens),
                                          "lengths": jnp.asarray(lengths)})
    pl, praw = pm.prefill_paged(pparams, {"tokens": _t(tokens),
                                          "lengths": _t(lengths)})
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    bids = padded_block_ids([3, 0, 5], 4, trash_block=NUM_BLOCKS)
    jcache = jm.init_paged_cache(MAX_BATCH, NUM_BLOCKS, BS)
    _, jaxes = jax_cache_ops.infer_paged_axes(jm, NUM_BLOCKS, BS)
    jcache = jax_cache_ops.install_prefill(jcache, jraw, jaxes,
                                           jnp.asarray(bids), jnp.int32(1))
    pcache = pm.init_paged_cache(MAX_BATCH, NUM_BLOCKS, BS)
    paxes = cache_ops.infer_paged_axes(pm, NUM_BLOCKS, BS)
    cache_ops.install_prefill(pcache, praw, paxes, bids, 1)
    for jleaf, key in zip(jcache["layers"], ("conv", "ssm")):
        np.testing.assert_allclose(pcache["layers"][key].numpy(),
                                   np.asarray(jleaf), atol=BLOCK_TOL,
                                   rtol=BLOCK_TOL)
    page = dict(tables=np.zeros((MAX_BATCH, 8), np.int32),
                seq_lens=np.zeros(MAX_BATCH, np.int32),
                write_bid=np.full(MAX_BATCH, NUM_BLOCKS, np.int32),
                write_off=np.zeros(MAX_BATCH, np.int32))
    tok = int(np.argmax(np.asarray(jl)[0]))
    assert int(pl.numpy()[0].argmax()) == tok
    tokens = np.zeros(MAX_BATCH, np.int32)
    for step in range(5):
        tokens[1] = tok
        page["seq_lens"][1] = 10 + step
        jd, jcache = jm.decode_step_paged(
            jparams, jcache, jnp.asarray(tokens),
            {k: jnp.asarray(v) for k, v in page.items()})
        pd, _ = pm.decode_step_paged(pparams, pcache, _t(tokens),
                                     {k: _t(v) for k, v in page.items()})
        a, b = np.asarray(jd)[1], pd.numpy()[1]
        np.testing.assert_allclose(b, a, atol=LOGIT_TOL, rtol=LOGIT_TOL)
        tok = int(np.argmax(a))
        assert int(np.argmax(b)) == tok
    for jleaf, key in zip(jcache["layers"], ("conv", "ssm")):
        np.testing.assert_allclose(pcache["layers"][key].numpy(),
                                   np.asarray(jleaf), atol=BLOCK_TOL,
                                   rtol=BLOCK_TOL)


def test_capture_step_restore_state_only_cache(models):
    """A cache with no pool leaf: the row capture clones the state leaves
    whole, a COW copy does nothing, and capture -> decode step ->
    restore is bit-exact."""
    _, _, pm, pparams = models
    cache = pm.init_paged_cache(MAX_BATCH, NUM_BLOCKS, BS)
    axes = cache_ops.infer_paged_axes(pm, NUM_BLOCKS, BS)
    gen = torch.Generator().manual_seed(0)
    for leaf in cache_ops.cache_leaves(cache):
        leaf.normal_(generator=gen)
    before = cache_ops.clone_cache(cache)
    undo = cache_ops.capture_pool_rows(cache, axes, np.asarray([3, 3]),
                                       np.asarray([0, 1]))
    assert undo["idx"] is None
    assert cache_ops.copy_block_prefixes(cache, axes, [(1, 2, 3)]) is cache
    for key in ("conv", "ssm"):
        assert torch.equal(cache["layers"][key], before["layers"][key])
    page = {k: torch.zeros((MAX_BATCH,) + s, dtype=torch.int32)
            for k, s in (("tables", (8,)), ("seq_lens", ()),
                         ("write_bid", ()), ("write_off", ()))}
    pm.decode_step_paged(pparams, cache, torch.tensor([7, 9]), page)
    assert not torch.equal(cache["layers"]["ssm"], before["layers"]["ssm"])
    cache_ops.restore_pool_rows(cache, axes, undo)
    for key in ("conv", "ssm"):
        assert torch.equal(cache["layers"][key], before["layers"][key])


@pytest.mark.parametrize("family", ["audio", "vlm"])
def test_audio_and_vlm_families_build_and_decode(family):
    """falcon-mamba's smoke config recast as the audio or vlm family
    builds, prefills its ring cache and decodes two steps (their blocks
    are attention ones: the Mamba fields go unused)."""
    cfg = dataclasses.replace(get_smoke_config(ARCH), family=family,
                              num_heads=4, num_kv_heads=2, head_dim=64,
                              d_ff=512, attention_type="gqa",
                              encoder_layers=2 if family == "audio" else 0,
                              encoder_seq=16 if family == "audio" else 0,
                              num_patches=8 if family == "vlm" else 0)
    model = Model(cfg, device="cpu")
    params = model.init(0)
    gen = torch.Generator().manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 5),
                                     generator=gen)}
    extra = {"audio": ("frames", 16), "vlm": ("patches", 8)}[family]
    batch[extra[0]] = torch.randn((2, extra[1], cfg.d_model), generator=gen)
    last, cache = model.prefill(params, batch, max_seq=24)
    for _ in range(2):
        last, cache = model.decode_step(params, cache, last.argmax(-1))
    assert torch.isfinite(last).all()
    assert cache["pos"].tolist() == [5 + 2 + (8 if family == "vlm" else 0)] * 2


# -- the weight carry-across -------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoint_carry_across(tmp_path, dtype):
    """``weights.npz`` written by ``repro`` for falcon smoke loads into the
    port with every key, shape and value; A_log and D_skip stay in the
    parameters' type."""
    jparams = JaxModel(jax_smoke_config(ARCH), dtype=_jdt(dtype)).init(
        jax.random.PRNGKey(1))
    path = str(tmp_path / "weights.npz")
    jax_save(path, jparams)
    got = ckpt.load_params(path, dtype=getattr(torch, dtype), device="cpu")
    flat = _flatten(jparams)
    assert sorted(k for k, _ in ckpt.flatten(got)) == sorted(flat)
    for key, leaf in ckpt.flatten(got):
        want = np.asarray(flat[key]).astype(np.float32)
        assert tuple(leaf.shape) == want.shape, key
        np.testing.assert_array_equal(leaf.float().numpy(), want, key)
    assert got["layers"]["mixer"]["A_log"].dtype == getattr(torch, dtype)
    assert got["layers"]["mixer"]["D_skip"].dtype == getattr(torch, dtype)
    # and the port's own file reads back bit for bit
    ckpt.save_checkpoint(str(tmp_path / "port.npz"), got)
    again = ckpt.load_params(str(tmp_path / "port.npz"),
                             dtype=getattr(torch, dtype), device="cpu")
    for (k1, a), (k2, b) in zip(ckpt.flatten(got), ckpt.flatten(again)):
        assert k1 == k2 and torch.equal(a, b)


def test_full_config_widths():
    cfg = get_config(ARCH)
    d_inner, N, d_conv, dt_rank = pt_mamba.mamba_dims(cfg)
    assert (cfg.num_layers, cfg.d_model, d_inner, N, d_conv, dt_rank) == \
        (64, 4096, 8192, 16, 4, 256)
    assert Model(cfg, device="cpu").vpad == 65536


# -- the engine, port against repro ---------------------------------------------------

ENGINE_CASES = {
    # name: (temperature, fault, admission)
    "greedy": (0.0, False, "chunked"),
    "temp0.8": (0.8, False, "chunked"),
    "fault": (0.0, True, "chunked"),
    "fault_temp0.8": (0.8, True, "chunked"),
    "serial_greedy": (0.0, False, "serial"),
    "serial_temp0.8": (0.8, False, "serial"),
    "serial_fault": (0.0, True, "serial"),
    "serial_fault_temp0.8": (0.8, True, "serial"),
}


def _serve(eng, vocab, fault, severity):
    """tests/test_recovery.py:346: three 8-token prompts of 10 new tokens,
    an L6 attention fault mid-step at step 3 on physical 0."""
    if fault:
        eng.injector.schedule(3, 0, severity=severity.L6, component="attn",
                              mid_step=True)
    rng = np.random.default_rng(0)
    reqs = [eng.submit(list(map(int, rng.integers(0, vocab, 8))), 10)
            for _ in range(3)]
    eng.run(max_steps=150)
    return reqs


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    return tmp_path_factory.mktemp("ssm_engines")


@pytest.fixture(scope="module", params=list(ENGINE_CASES))
def pair(request, shared):
    temp, fault, admission = ENGINE_CASES[request.param]
    common = dict(mode="collocated", num_dp=2, max_batch=2, max_seq=64,
                  block_size=8, num_blocks=64, admission=admission)
    root = shared / request.param
    weights = shared / "weights.npz"
    jdir = root / "jax"
    jdir.mkdir(parents=True)
    if weights.exists():
        (jdir / "weights.npz").write_bytes(weights.read_bytes())
    jeng = JaxEngine(jax_smoke_config(ARCH), JaxEngineConfig(
        **common, workdir=str(jdir),
        persist_cache_dir=str(shared / "xla_cache"),
        sampling=JaxSampling(temperature=temp)))
    if not weights.exists():
        weights.write_bytes((jdir / "weights.npz").read_bytes())
    jreqs = _serve(jeng, jeng.cfg.vocab_size, fault, JaxSeverity)
    pdir = root / "torch"
    pdir.mkdir()
    (pdir / "weights.npz").write_bytes(weights.read_bytes())
    peng = InferenceEngine(get_smoke_config(ARCH), EngineConfig(
        **common, workdir=str(pdir),
        sampling=SamplingParams(temperature=temp)), device="cpu")
    preqs = _serve(peng, peng.cfg.vocab_size, fault, Severity)
    return request.param, jeng, jreqs, peng, preqs


def test_engine_token_streams_identical(pair):
    _, _, jreqs, peng, preqs = pair
    assert all(r.state.value == "finished" for r in preqs)
    assert [r.output_tokens for r in preqs] == \
        [r.output_tokens for r in jreqs]
    assert [r.migrations for r in preqs] == [r.migrations for r in jreqs]


def test_engine_recovery_reports_match(pair):
    name, jeng, _, peng, _ = pair
    fault = ENGINE_CASES[name][1]
    assert len(peng.reports) == len(jeng.reports) == int(fault)
    for p, j in zip(peng.reports, jeng.reports):
        assert p.scenario == j.scenario == "attn"
        assert p.actions == j.actions
        assert p.migrated == j.migrated >= 1
        assert p.blocks_rolled_back == j.blocks_rolled_back
        assert p.compile_source == j.compile_source == "precompiled"
    # no experts: no map, runtime or shards, and full coverage
    assert peng.expert_map is None and peng.runtime is None
    assert peng.shards == [] and peng.ep_size == 0
    assert all(ex.shard is None and ex.ep_rank is None
               for ex in peng.dp_executors)
    assert peng.expert_integrity() == ([], [])
    ph, jh = dataclasses.asdict(peng.health()), dataclasses.asdict(
        jeng.health())
    ph.pop("soft_signals"), jh.pop("soft_signals")   # wall-clock based
    assert ph == jh and ph["expert_coverage"] == 1.0
    # the model cannot chunk: both admissions install whole prompts
    stats = peng.prefill_stats()
    assert stats["prefill_chunks"] == stats["prefix_cache_hits"] == 0
    assert ("prefill", 1, 16) in peng.graph_cache
    assert ("install", 0, 16) in peng.graph_cache


# -- straggler samples: a step that built a graph is no sample -------------------------

# (prompt tokens, engine step it is submitted before, new tokens)
STRAGGLER_PROBE = [(20, 2, 2), (20, 1, 6), (16, 1, 6), (17, 0, 2), (19, 1, 1)]


def _serve_probe(eng, vocab, severity):
    """Five prompts submitted over the first steps across three ranks; an
    L6 attention fault scheduled for step 8 on physical 2, after every
    request has finished, so it never fires."""
    eng.injector.schedule(8, 2, severity=severity.L6, component="attn",
                          mid_step=True)
    rng = np.random.default_rng(3)
    prompts = [list(map(int, rng.integers(0, vocab, n)))
               for n, _, _ in STRAGGLER_PROBE]
    reqs = [None] * len(prompts)
    for _ in range(150):
        for i, (_, at, new) in enumerate(STRAGGLER_PROBE):
            if reqs[i] is None and eng.step_no == at:
                reqs[i] = eng.submit(prompts[i], new)
        if all(r is not None for r in reqs) and not eng.unfinished:
            break
        eng.step()
    return reqs


def test_straggler_samples_skip_fresh_graph_steps(tmp_path):
    """Three ranks, so one slow rank could exceed 3x the median: each
    device's straggler samples are exactly its steps that looked up no
    new graph key (no "cold" or "cached" timing), counted by calls to
    ``record``, not read from the rolling window or the wall clock."""
    common = dict(mode="collocated", num_dp=3, max_batch=3,
                  block_size=4, num_blocks=29)
    jdir, pdir = tmp_path / "jax", tmp_path / "torch"
    jdir.mkdir()
    jeng = JaxEngine(jax_smoke_config(ARCH), JaxEngineConfig(
        **common, workdir=str(jdir)))
    jreqs = _serve_probe(jeng, jeng.cfg.vocab_size, JaxSeverity)
    pdir.mkdir()
    (pdir / "weights.npz").write_bytes((jdir / "weights.npz").read_bytes())
    peng = InferenceEngine(get_smoke_config(ARCH), EngineConfig(
        **common, workdir=str(pdir)), device="cpu")

    recorded, steps, clean = ({ex.physical_id: 0
                               for ex in peng.dp_executors}
                              for _ in range(3))
    record = peng.straggler.record

    def counted_record(pid, seconds):
        recorded[pid] += 1
        record(pid, seconds)
    peng.straggler.record = counted_record
    for ex in peng.dp_executors:
        def counted_compute(ctx, step_no, ex=ex, compute=ex.compute):
            n = len(peng.graph_cache.timings)
            out = compute(ctx, step_no)
            steps[ex.physical_id] += 1
            fresh = [t for t in peng.graph_cache.timings[n:]
                     if t.source in ("cold", "cached")]
            clean[ex.physical_id] += not fresh
            return out
        ex.compute = counted_compute

    preqs = _serve_probe(peng, peng.cfg.vocab_size, Severity)
    assert all(r.state.value == "finished" for r in preqs)
    assert [r.output_tokens for r in preqs] == \
        [r.output_tokens for r in jreqs]
    assert [len(r.output_tokens) for r in preqs] == \
        [new for _, _, new in STRAGGLER_PROBE]
    assert recorded == clean
    # the probe does look keys up for the first time mid-serving (the
    # prefill buckets 16 and 32 of the live domain), on more than one rank
    assert sum(steps.values()) > sum(clean.values())
    assert sum(s > c for s, c in zip(steps.values(), clean.values())) >= 2
