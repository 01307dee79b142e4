"""The port's decode megakernel path against the JAX package, on the CPU
(where the port runs the plain versions of its kernels).

* ``decode_megastep_plain`` against ``ref.decode_megastep_ref`` and the
  Pallas kernel in interpret mode, on the cases of
  tests/test_decode_megakernel.py (the D=7168 deploy shape against
  ``ref`` only);
* ``router_topk_plain`` against ``router_topk_pallas`` (interpret) and
  ``ref.router_topk_ref``;
* the port's ``Model`` with ``decode_impl="megakernel"`` against the JAX
  ``Model`` with the same setting on carried-across weights, and against
  the port's own composed path;
* the collocated ``num_dp=2`` megakernel engines of both packages, with
  and without a mid-step L6 fault (tests/test_decode_megakernel.py:286).

Inputs come from numpy seeds; both packages get the same arrays.
"""
import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core.fault_codes import ErrorType as JaxErrorType
from repro.core.fault_codes import Severity as JaxSeverity
from repro.kernels import ref
from repro.kernels.decode_megakernel import decode_megastep_pallas
from repro.kernels.router_topk import router_topk_pallas
from repro.models import moe as jax_moe
from repro.models.model import Model as JaxModel
from repro.serving.engine import EngineConfig as JaxEngineConfig
from repro.serving.engine import InferenceEngine as JaxEngine
from repro.serving.sampling import SamplingParams as JaxSampling
from repro.training.checkpoint import _flatten
from repro_torch.configs import get_smoke_config
from repro_torch.core.fault_codes import ErrorType, Severity
from repro_torch.kernels import launches, ops
from repro_torch.kernels.decode_megastep import (decode_megastep_cuda,
                                                 decode_megastep_plain)
from repro_torch.kernels.paged_attention import takes_latent_kernel
from repro_torch.kernels.router_topk import (router_topk_cuda,
                                             router_topk_plain)
from repro_torch.models import moe as MoE
from repro_torch.models.model import Model
from repro_torch.serving.engine import EngineConfig, InferenceEngine
from repro_torch.serving.sampling import SamplingParams
from repro_torch.training import checkpoint as ckpt
from test_torch_cases import (DEPLOY, MEGASTEP_CASES, ROUTER_CASES,
                              megastep_inputs, router_inputs)
from test_torch_model import BS, NUM_BLOCKS, TRASH, _port_params, _steps
from test_torch_cases import one_torch_thread  # noqa: F401

TOL = 2e-4           # tests/test_decode_megakernel.py:103
ROUTER_RTOL = 2e-5


def _to_jax(args):
    return [None if a is None else jnp.asarray(a) for a in args]


def _to_torch(args):
    return [a if a is None or isinstance(a, int) else torch.from_numpy(a)
            for a in args]


def _megastep_both(case):
    args, kw = megastep_inputs(**case)
    got = decode_megastep_plain(*_to_torch(args), **kw)
    return args, kw, [t.numpy() for t in got]


@pytest.mark.parametrize("oracle", ["ref", "pallas"])
@pytest.mark.parametrize("case", list(MEGASTEP_CASES))
def test_megastep_plain_matches_jax(case, oracle):
    args, kw, (y, h2) = _megastep_both(MEGASTEP_CASES[case])
    jargs = _to_jax(args)
    jargs[16] = jnp.int32(args[16])
    if oracle == "ref":
        want = ref.decode_megastep_ref(*jargs, **kw)
    else:   # block_d < D: the blocked and padded D path, as the JAX test
        want = decode_megastep_pallas(*jargs, **kw, block_f=32, block_d=24,
                                      interpret=True)
    np.testing.assert_allclose(h2, np.asarray(want[1]), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(y, np.asarray(want[0]), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("case", [dict(), dict(lost=2, masked=3),
                                  dict(window=True)],
                         ids=["plain", "lost_masked", "windowed"])
def test_megastep_plain_deploy_d_model(case):
    args, kw, (y, h2) = _megastep_both(dict(DEPLOY, **case))
    jargs = _to_jax(args)
    jargs[16] = jnp.int32(args[16])
    want = ref.decode_megastep_ref(*jargs, **kw)
    np.testing.assert_allclose(h2, np.asarray(want[1]), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(y, np.asarray(want[0]), rtol=TOL, atol=TOL)


def test_megastep_ops_dispatch_on_cpu():
    """A CPU tensor runs the plain version (no launch is counted); the
    launcher refuses it rather than falling back."""
    args, kw = megastep_inputs(**MEGASTEP_CASES["shared"])
    targs = _to_torch(args)
    before = dict(launches)
    y, h2 = ops.decode_megastep(*targs, **kw)
    assert dict(launches) == before
    want = decode_megastep_plain(*targs, **kw)
    assert torch.equal(y, want[0]) and torch.equal(h2, want[1])
    with pytest.raises(ValueError, match="CUDA"):
        decode_megastep_cuda(*targs, **kw)


def test_megastep_plain_rounds_p_where_the_chain_does():
    """The chain's attention rounds p to bf16 before p V only on the
    tensor-core latent kernel (bf16, one pool as K and V, Dh = 576, G a
    multiple of 64); the plain megastep rounds it there too, and keeps it
    in f32 on every other layout."""
    q = torch.zeros(2, 128, 576, dtype=torch.bfloat16)
    pool = torch.zeros(3, 4, 1, 576, dtype=torch.bfloat16)
    assert takes_latent_kernel(q, pool, pool)
    assert takes_latent_kernel(q[:, :64].contiguous(), pool, pool)
    assert not takes_latent_kernel(q.float(), pool.float(), pool.float())
    assert not takes_latent_kernel(q, pool, pool.clone())        # two pools
    assert not takes_latent_kernel(q[:, :32].contiguous(), pool, pool)
    narrow = pool[..., :288].contiguous()                       # Dh 288
    assert not takes_latent_kernel(q[..., :288].contiguous(), narrow, narrow)


@pytest.mark.parametrize("oracle", ["ref", "pallas"])
@pytest.mark.parametrize("case", list(ROUTER_CASES))
def test_router_topk_plain_matches_jax(case, oracle):
    T, E, k, masked, tie = ROUTER_CASES[case]
    logits, mask = router_inputs(T, E, k, masked, tie)
    w, idx = router_topk_plain(torch.from_numpy(logits),
                               torch.from_numpy(mask), k)
    if oracle == "ref":
        jw, jidx = ref.router_topk_ref(jnp.asarray(logits),
                                       jnp.asarray(mask), k)
    else:
        jw, jidx = router_topk_pallas(jnp.asarray(logits),
                                      jnp.asarray(mask), k, interpret=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=ROUTER_RTOL,
                               atol=0)
    assert idx.dtype == torch.int32 and w.dtype == torch.float32
    if tie:   # the lowest index wins among equal probabilities
        assert idx[0].tolist() == [0, 1, 2, 3]
        assert idx[1, :3].tolist() == [4, 9, 30]


def test_router_topk_ops_dispatch_on_cpu():
    logits, mask = router_inputs(*ROUTER_CASES["masked"])
    lt, mt = torch.from_numpy(logits), torch.from_numpy(mask)
    w, idx = ops.router_topk(lt, mt, 4)
    want = router_topk_plain(lt, mt, 4)
    assert torch.equal(w, want[0]) and torch.equal(idx, want[1])
    with pytest.raises(ValueError, match="CUDA"):
        router_topk_cuda(lt, mt, 4)


# -- the model: port against JAX, megakernel against composed ---------------

def _mega(cfg):
    return dataclasses.replace(cfg, decode_impl="megakernel")


def _windowed(cfg):
    return dataclasses.replace(cfg, sliding_window=6)


def _hurt_cfg(cfg):
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, num_redundant_experts=2))


def _hurt_runtimes(jm):
    """Expert 2 lost, expert 3 masked (tests/test_decode_megakernel.py:255)."""
    rt = jm.default_runtime()
    jrt = jax_moe.MoERuntime(rt.logical_to_physical,
                             rt.replica_count.at[2].set(0),
                             rt.expert_mask.at[3].set(False))
    prt = MoE.MoERuntime(*(torch.from_numpy(np.array(a)) for a in jrt))
    return jrt, prt


MODEL_CASES = {
    # id: (config edit, runtime edit)
    "qwen": (lambda c: c, None),
    "window6": (_windowed, None),
    "masked_lost": (_hurt_cfg, _hurt_runtimes),
}


@pytest.fixture(scope="module")
def jax_params():
    """One JAX-initialised parameter set per model case."""
    out = {}
    for name, (edit, _) in MODEL_CASES.items():
        cfg = edit(jax_smoke_config("qwen2-moe-a2.7b"))
        out[name] = JaxModel(cfg).init(jax.random.PRNGKey(3))
    return out


def _run_port(pcfg, pp, runtime):
    pm = Model(pcfg, device="cpu")
    cache = pm.init_paged_cache(4, NUM_BLOCKS, BS)
    (ctoks, cpage), decodes, rows = _steps(pcfg.vocab_size)
    to_t = lambda p: {k: torch.from_numpy(v) for k, v in p.items()}  # noqa
    logits = [pm.decode_step_paged(pp, cache, torch.from_numpy(ctoks),
                                   to_t(cpage), runtime)[0].numpy()]
    nxt = np.zeros(4, np.int32)
    nxt[[0, 2]] = logits[0][[rows[0], rows[1]]].argmax(-1)
    for page in decodes:
        logits.append(pm.decode_step_paged(pp, cache, torch.from_numpy(nxt),
                                           to_t(page), runtime)[0].numpy())
        nxt[[0, 2]] = logits[-1][[0, 2]].argmax(-1)
    return logits, cache


def _run_jax(jcfg, params, runtime):
    jm = JaxModel(jcfg)
    cache = jm.init_paged_cache(4, NUM_BLOCKS, BS)
    (ctoks, cpage), decodes, rows = _steps(jcfg.vocab_size)
    to_j = lambda p: {k: jnp.asarray(v) for k, v in p.items()}  # noqa
    lg, cache = jm.decode_step_paged(params, cache, jnp.asarray(ctoks),
                                     to_j(cpage), runtime)
    logits = [np.asarray(lg)]
    nxt = np.zeros(4, np.int32)
    nxt[[0, 2]] = logits[0][[rows[0], rows[1]]].argmax(-1)
    for page in decodes:
        lg, cache = jm.decode_step_paged(params, cache, jnp.asarray(nxt),
                                         to_j(page), runtime)
        logits.append(np.asarray(lg))
        nxt[[0, 2]] = logits[-1][[0, 2]].argmax(-1)
    return logits, cache


def _live_rows(i):
    """The rows whose greedy tokens feed the next step: the last prompt
    rows of the chunk step, then the two live decode slots."""
    (_, _), _, rows = _steps(100)
    return list(rows) if i == 0 else [0, 2]


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_model_megakernel_matches_jax(jax_params, case):
    edit, hurt = MODEL_CASES[case]
    jcfg = _mega(edit(jax_smoke_config("qwen2-moe-a2.7b")))
    pcfg = _mega(edit(get_smoke_config("qwen2-moe-a2.7b")))
    params = jax_params[case]
    jrt, prt = hurt(JaxModel(jcfg)) if hurt else (None, None)
    jl, jcache = _run_jax(jcfg, params, jrt)
    pl, pcache = _run_port(pcfg, _port_params(params), prt)
    for i, (a, b) in enumerate(zip(pl, jl)):
        np.testing.assert_allclose(a, b, atol=TOL, rtol=0)
        rows = _live_rows(i)
        np.testing.assert_array_equal(a[rows].argmax(-1), b[rows].argmax(-1))
    for key in ("k", "v"):   # the pool write is outside the megastep
        np.testing.assert_allclose(
            pcache["layers"][key][:, :TRASH].numpy(),
            np.asarray(jcache["layers"][key])[:, :TRASH], atol=1e-5, rtol=0)


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_model_megakernel_matches_composed(jax_params, case):
    edit, hurt = MODEL_CASES[case]
    base = edit(get_smoke_config("qwen2-moe-a2.7b"))
    pp = _port_params(jax_params[case])
    prt = hurt(JaxModel(edit(jax_smoke_config("qwen2-moe-a2.7b"))))[1] \
        if hurt else None
    composed, _ = _run_port(dataclasses.replace(base, moe_impl="fused"), pp,
                            prt)
    mega, _ = _run_port(_mega(base), pp, prt)
    for i, (a, b) in enumerate(zip(mega, composed)):
        np.testing.assert_allclose(a, b, atol=TOL, rtol=0)
        rows = _live_rows(i)
        np.testing.assert_array_equal(a[rows].argmax(-1), b[rows].argmax(-1))


def test_megakernel_reads_no_new_weights():
    """The megastep reads the parameters of the composed path: both
    packages' megakernel models have the checkpoint keys and shapes of
    the composed model, so weights carry across unchanged."""
    jflat = _flatten(JaxModel(_mega(jax_smoke_config("qwen2-moe-a2.7b")))
                     .init(jax.random.PRNGKey(0)))
    mine = dict(ckpt.flatten(Model(_mega(get_smoke_config(
        "qwen2-moe-a2.7b")), device="cpu").init(0)))
    composed = dict(ckpt.flatten(Model(get_smoke_config("qwen2-moe-a2.7b"),
                                       device="cpu").init(0)))
    assert sorted(mine) == sorted(jflat) == sorted(composed)
    for k, v in mine.items():
        assert tuple(v.shape) == tuple(jflat[k].shape) == \
            tuple(composed[k].shape)


# -- the engine: port against JAX, both on the megakernel path --------------

ENGINE = dict(mode="collocated", num_dp=2, max_batch=2, max_seq=96,
              block_size=8, num_blocks=64, decode_impl="megakernel")


def _prompts(vocab):
    rng = np.random.default_rng(9)
    return [list(map(int, rng.integers(0, vocab, 60))),
            list(map(int, rng.integers(0, vocab, 58)))]


def _serve(eng, vocab, fault, severity, error_type):
    if fault:
        eng.injector.schedule(2, 1, severity=severity.L6,
                              error_type=error_type.HBM_ECC,
                              component="attn", mid_step=True)
    reqs = [eng.submit(p, 6) for p in _prompts(vocab)]
    eng.run(max_steps=400)
    return reqs


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """Both packages' megakernel engines on one ``weights.npz``, without
    and with the mid-step fault."""
    root = tmp_path_factory.mktemp("mega_engines")
    weights = root / "weights.npz"
    out = {}
    for fault in (False, True):
        jdir, pdir = root / f"jax{int(fault)}", root / f"torch{int(fault)}"
        jdir.mkdir()
        pdir.mkdir()
        if weights.exists():
            shutil.copy(weights, jdir / "weights.npz")
        jcfg = jax_smoke_config("qwen2-moe-a2.7b")
        jeng = JaxEngine(jcfg, JaxEngineConfig(
            **ENGINE, workdir=str(jdir),
            persist_cache_dir=str(root / "xla_cache"),
            sampling=JaxSampling(temperature=0.8, top_p=0.9, seed=3)))
        if not weights.exists():
            shutil.copy(jdir / "weights.npz", weights)
        jreqs = _serve(jeng, jcfg.vocab_size, fault, JaxSeverity,
                       JaxErrorType)
        shutil.copy(weights, pdir / "weights.npz")
        pcfg = get_smoke_config("qwen2-moe-a2.7b")
        peng = InferenceEngine(pcfg, EngineConfig(
            **ENGINE, workdir=str(pdir),
            sampling=SamplingParams(temperature=0.8, top_p=0.9, seed=3)),
            device="cpu")
        assert peng.model.cfg.decode_impl == "megakernel"
        preqs = _serve(peng, pcfg.vocab_size, fault, Severity, ErrorType)
        out[fault] = (jeng, jreqs, peng, preqs)
    return out


@pytest.mark.parametrize("fault", [False, True], ids=["clean", "l6_attn"])
def test_megakernel_engine_matches_jax(engines, fault):
    jeng, jreqs, peng, preqs = engines[fault]
    assert all(r.state.value == "finished" for r in preqs)
    assert [r.output_tokens for r in preqs] == \
        [r.output_tokens for r in jreqs]
    assert len(peng.reports) == len(jeng.reports) == int(fault)
    for p, j in zip(peng.reports, jeng.reports):
        assert p.scenario == j.scenario
        assert p.actions == j.actions
        assert p.migrated == j.migrated
        assert p.blocks_rolled_back == j.blocks_rolled_back
        assert p.compile_source == j.compile_source == "precompiled"
    for p, j in zip(peng.runtime, jeng.runtime):
        np.testing.assert_array_equal(p.numpy(), np.asarray(j))
    # the rolled-back step leaves nothing allocated on the survivors
    surviving = [ex for ex in peng.dp_executors if ex.alive]
    assert surviving and all(ex.block_manager.num_allocated == 0
                             for ex in surviving)
