"""The port's dense family against the JAX package, on the CPU.

``get_config(name, shape)`` of every registered arch and input shape
equals ``repro``'s.  ``internlm2-20b`` (GQA, here with
``sliding_window=16``) and ``minicpm3-4b`` (MLA) at smoke size, with
JAX-initialised weights carried across by the checkpoint loader: the
full forward, a chunked-prefill step and two decode steps over the paged
pools, and a whole-prompt prefill installed into the pools then decoded;
``mistral-large-123b`` and ``nemotron-4-340b`` (squared ReLU) the same
forward and paged steps.  Then both packages' engines serve internlm2-20b
with serial admission, and the scenario of
``tests/test_recovery.py::test_dense_arch_attention_recovery`` (an L6
attention fault mid-step, revived by migration on a "precompiled"
graph) on internlm2-20b and minicpm3-4b, sharing one ``weights.npz``
per arch.  f32 tolerance 1e-4 (2e-4 for the logits of a whole forward,
as tests/test_paged_serving.py); streams must be equal.
"""
import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ALL_ARCHS as JAX_ARCHS
from repro.configs import INPUT_SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core.fault_codes import Severity as JaxSeverity
from repro.models.model import Model as JaxModel
from repro.serving import cache_ops as jax_cache_ops
from repro.serving.engine import EngineConfig as JaxEngineConfig
from repro.serving.engine import InferenceEngine as JaxEngine
from repro.serving.kvcache import padded_block_ids
from repro.training.checkpoint import _flatten
from repro_torch.configs import ALL_ARCHS, get_config, get_smoke_config
from repro_torch.core.fault_codes import Severity
from repro_torch.models.model import Model
from repro_torch.serving import cache_ops
from repro_torch.serving.engine import EngineConfig, InferenceEngine
from repro_torch.serving.executor import next_bucket
from repro_torch.training import checkpoint as ckpt
from test_torch_cases import t as _t
from test_torch_mla import _run
from test_torch_model import BS, NUM_BLOCKS, TRASH
from test_torch_cases import one_torch_thread  # noqa: F401

TOL = 1e-4
LOGIT_TOL = 2e-4                 # tests/test_paged_serving.py:180
# the dense archs, each with the change the tests make to its smoke config
DENSE = {"internlm2-20b": dict(sliding_window=16), "minicpm3-4b": {},
         "mistral-large-123b": {}, "nemotron-4-340b": {}}
# the encoder-decoder arch, which paged serving refuses
AUDIO = "seamless-m4t-large-v2"


def _configs(arch):
    over = DENSE[arch]
    return (dataclasses.replace(jax_smoke_config(arch), **over),
            dataclasses.replace(get_smoke_config(arch), **over))


# -- configs ------------------------------------------------------------------

@pytest.mark.parametrize("shape", [None, *JAX_SHAPES])
@pytest.mark.parametrize("name", JAX_ARCHS)
def test_get_config_matches_repro(name, shape):
    """The registry and ``long_500k``'s window rule, field for field; the
    smoke reduction too."""
    assert name in ALL_ARCHS
    assert dataclasses.asdict(get_config(name, shape)) == \
        dataclasses.asdict(jax_get_config(name, shape))
    if shape is None:
        assert dataclasses.asdict(get_smoke_config(name)) == \
            dataclasses.asdict(jax_smoke_config(name))


def test_long_context_window_rule():
    assert get_config("internlm2-20b", "long_500k").sliding_window == 8192
    assert get_config("internlm2-20b", "decode_32k").sliding_window == 0
    assert get_config("falcon-mamba-7b", "long_500k").sliding_window == 0


def test_audio_paged_cache_raises_as_repro():
    """The audio family builds and draws its weights, but its paged
    cache raises ``repro``'s ``ValueError``: paged serving has no
    encoder-decoder (its ring serve step: tests/test_torch_multimodal.py)."""
    model = Model(get_smoke_config(AUDIO), device="cpu")
    assert "enc_norm" in model.init(0)
    with pytest.raises(ValueError, match="paged serving does not support "
                       r"encoder-decoder \(audio\) models"):
        model.init_paged_cache(2, NUM_BLOCKS, BS)


@pytest.mark.parametrize("arch", [a for a in ALL_ARCHS if a != AUDIO])
def test_served_families_build_and_decode(arch):
    """Every registered arch but the encoder-decoder builds, draws its
    weights and runs one paged decode step on the CPU (the hybrid Jamba
    and the vlm, whose decode step is the dense model's, among them)."""
    model = Model(get_smoke_config(arch), device="cpu")
    params = model.init(0)
    cache = model.init_paged_cache(2, NUM_BLOCKS, BS)
    page = {k: torch.zeros((2,) + s, dtype=torch.int32)
            for k, s in (("tables", (4,)), ("seq_lens", ()),
                         ("write_bid", ()), ("write_off", ()))}
    page["write_bid"].fill_(TRASH)
    page["seq_lens"][1] = 1
    logits, _ = model.decode_step_paged(params, cache, torch.tensor([3, 5]),
                                        page)
    assert tuple(logits.shape) == (2, model.vpad)
    assert torch.isfinite(logits).all()


def test_full_dense_widths_and_why_two_stay_on_the_cpu():
    """internlm2-20b's and minicpm3-4b's layouts the kernels meet on the
    card (G = 6 at Dh 128; a latent of 256 + 32 under 40 heads); one
    layer of mistral-large-123b and nemotron-4-340b is 2.8 and 6.9 GB in
    bf16, so their full depth (244 and 663 GB) fits no single card."""
    gi = get_config("internlm2-20b")
    assert (gi.d_model, gi.num_heads // gi.num_kv_heads, gi.head_dim,
            gi.vocab_size, gi.num_layers) == (6144, 6, 128, 92544, 48)
    mc = get_config("minicpm3-4b")
    assert (mc.attention_type, mc.num_heads,
            mc.mla.kv_lora_rank + mc.mla.qk_rope_head_dim) == ("mla", 40,
                                                               288)
    sizes = {}
    for arch in ("mistral-large-123b", "nemotron-4-340b"):
        n = get_config(arch).num_layers
        # shapes only (the port's equal these: the checkpoint keys test)
        specs = JaxModel(dataclasses.replace(jax_get_config(arch),
                                             num_layers=1)).param_specs()
        per = 2 * sum(int(np.prod(leaf.shape)) for leaf in
                      jax.tree_util.tree_leaves(specs["layers"]))
        sizes[arch] = (round(per / 1e9, 1), round(per * n / 1e9))
    assert sizes == {"mistral-large-123b": (2.8, 244),
                     "nemotron-4-340b": (6.9, 663)}
    assert get_config("nemotron-4-340b").activation == "relu2"


# -- the model ---------------------------------------------------------------

@pytest.fixture(scope="module", params=list(DENSE))
def models(request):
    arch = request.param
    jcfg, pcfg = _configs(arch)
    jm, pm = JaxModel(jcfg), Model(pcfg, device="cpu")
    jparams = jm.init(jax.random.PRNGKey(4))
    pparams = ckpt.params_from_flat(_flatten(jparams).items(), {},
                                    dtype=torch.float32, device="cpu")
    return arch, jm, jparams, pm, pparams


def test_model_structure_and_checkpoint_keys(models):
    arch, _, jparams, pm, _ = models
    cfg = pm.cfg
    assert pm.layer_groups() == [("layers", cfg.num_layers, "attn", "dense",
                                  False)]
    assert pm.supports_chunked_prefill
    assert pm.default_runtime() is None and pm._cap(8) == 0
    flat = _flatten(jparams)
    fresh = ckpt.flatten(pm.init(0))
    assert sorted(k for k, _ in fresh) == sorted(flat)
    for key, leaf in fresh:
        assert tuple(leaf.shape) == flat[key].shape, key
    pools = pm.init_paged_cache(4, NUM_BLOCKS, BS)["layers"]
    assert list(pools) == (["ckr"] if cfg.attention_type == "mla"
                           else ["k", "v"])


def test_logits_full_matches_jax(models):
    _, jm, jparams, pm, pparams = models
    tokens = np.random.default_rng(2).integers(
        0, pm.cfg.vocab_size, (2, 21)).astype(np.int32)
    want, _, _ = jm.logits_full(jparams, {"tokens": jnp.asarray(tokens)})
    got, _ = pm.logits_full(pparams, {"tokens": _t(tokens)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGIT_TOL, rtol=0)


def test_chunk_and_decode_steps_match_jax(models):
    """One chunked-prefill step (two prompts as virtual slots) and two
    decode steps through both ``decode_step_paged``s, greedy tokens fed
    back; the pools after them."""
    _, jm, jparams, pm, pparams = models
    jl, jcache, rows = _run(jm, jparams,
                            jm.init_paged_cache(4, NUM_BLOCKS, BS),
                            jnp.asarray)
    pl, pcache, _ = _run(pm, pparams, pm.init_paged_cache(4, NUM_BLOCKS, BS),
                         _t)
    for i, (a, b) in enumerate(zip(pl, jl)):
        np.testing.assert_allclose(a, b, atol=TOL, rtol=0)
        live = list(rows) if i == 0 else [0, 2]
        np.testing.assert_array_equal(a[live].argmax(-1), b[live].argmax(-1))
    for key, pool in pcache["layers"].items():
        np.testing.assert_allclose(
            pool[:, :TRASH].numpy(),
            np.asarray(jcache["layers"][key])[:, :TRASH], atol=1e-5, rtol=0)


def test_prefill_install_then_decode_matches_jax(models):
    """The serial path's model calls: a whole-prompt prefill at its
    bucket (raw K/V, or MLA's latent rows), installed into the pools,
    then three greedy decode steps."""
    _, jm, jparams, pm, pparams = models
    n = 11
    tokens = np.zeros((1, next_bucket(n, 64)), np.int32)
    tokens[0, :n] = np.random.default_rng(n).integers(0, pm.cfg.vocab_size,
                                                      n)
    lengths = np.asarray([n], np.int32)
    jl, jraw = jm.prefill_paged(jparams, {"tokens": jnp.asarray(tokens),
                                          "lengths": jnp.asarray(lengths)})
    pl, praw = pm.prefill_paged(pparams, {"tokens": _t(tokens),
                                          "lengths": _t(lengths)})
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=LOGIT_TOL,
                               rtol=0)
    for key, raw in praw["layers"].items():
        np.testing.assert_allclose(raw.numpy(),
                                   np.asarray(jraw["layers"][key]),
                                   atol=TOL, rtol=0)
    blocks = [5, 2, 7, 9]
    bids = padded_block_ids(blocks, tokens.shape[1] // BS, TRASH)
    jcache = jm.init_paged_cache(4, NUM_BLOCKS, BS)
    _, jaxes = jax_cache_ops.infer_paged_axes(jm, NUM_BLOCKS, BS)
    jcache = jax_cache_ops.install_prefill(jcache, jraw, jaxes,
                                           jnp.asarray(bids), 0)
    pcache = pm.init_paged_cache(4, NUM_BLOCKS, BS)
    cache_ops.install_prefill(pcache, praw,
                              cache_ops.infer_paged_axes(pm, NUM_BLOCKS, BS),
                              bids, 0)
    tok = np.zeros(4, np.int32)
    tok[0] = np.asarray(jl).argmax(-1)[0]
    for step in range(3):
        pos = n + step
        page = dict(tables=np.zeros((4, 4), np.int32),
                    seq_lens=np.zeros(4, np.int32),
                    write_bid=np.full(4, TRASH, np.int32),
                    write_off=np.zeros(4, np.int32))
        page["tables"][0] = blocks
        page["seq_lens"][0] = pos + 1
        page["write_bid"][0] = blocks[pos // BS]
        page["write_off"][0] = pos % BS
        jd, jcache = jm.decode_step_paged(
            jparams, jcache, jnp.asarray(tok),
            {k: jnp.asarray(v) for k, v in page.items()})
        pd, _ = pm.decode_step_paged(pparams, pcache, _t(tok),
                                     {k: _t(v) for k, v in page.items()})
        a, b = pd.numpy()[0], np.asarray(jd)[0]
        np.testing.assert_allclose(a, b, atol=TOL, rtol=0)
        assert a.argmax() == b.argmax()
        tok[0] = b.argmax()
    for key, pool in pcache["layers"].items():
        np.testing.assert_allclose(
            pool[:, :TRASH].numpy(),
            np.asarray(jcache["layers"][key])[:, :TRASH], atol=1e-5, rtol=0)


# -- the engine, port against repro ----------------------------------------------

ENGINE_CASES = {
    # name: (arch, EngineConfig fields, fault)
    # tests/test_recovery.py:305: 3 DP ranks (the mode degenerates to
    # collocated without experts), an L6 attention fault at step 3
    "internlm2_recovery": ("internlm2-20b", dict(mode="disaggregated",
                                                  num_dp=3), True),
    "internlm2_serial": ("internlm2-20b", dict(mode="collocated", num_dp=2,
                                                admission="serial"), False),
    "minicpm3_recovery": ("minicpm3-4b", dict(mode="disaggregated",
                                              num_dp=3), True),
}


def _serve(eng, vocab, fault, severity):
    """tests/test_recovery.py:310: four 8-token prompts of 10 new
    tokens, the fault on physical 1 mid-step at step 3."""
    rng = np.random.default_rng(0)
    reqs = [eng.submit(list(map(int, rng.integers(0, vocab, 8))), 10)
            for _ in range(4)]
    if fault:
        eng.injector.schedule(3, 1, severity=severity.L6, component="attn",
                              mid_step=True)
    eng.run(max_steps=150)
    return reqs


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    return tmp_path_factory.mktemp("dense_engines")


@pytest.fixture(scope="module", params=list(ENGINE_CASES))
def pair(request, shared):
    arch, over, fault = ENGINE_CASES[request.param]
    common = dict(max_batch=2, max_seq=64, block_size=8, num_blocks=64,
                  **over)
    weights = shared / f"{arch}.npz"
    jdir, pdir = (shared / request.param / side for side in ("jax", "torch"))
    jdir.mkdir(parents=True)
    pdir.mkdir()
    if weights.exists():
        shutil.copy(weights, jdir / "weights.npz")
    jeng = JaxEngine(jax_smoke_config(arch), JaxEngineConfig(
        **common, workdir=str(jdir),
        persist_cache_dir=str(shared / f"xla_{arch}")))
    if not weights.exists():
        shutil.copy(jdir / "weights.npz", weights)
    jreqs = _serve(jeng, jeng.cfg.vocab_size, fault, JaxSeverity)
    shutil.copy(weights, pdir / "weights.npz")
    peng = InferenceEngine(get_smoke_config(arch), EngineConfig(
        **common, workdir=str(pdir)), device="cpu")
    preqs = _serve(peng, peng.cfg.vocab_size, fault, Severity)
    return request.param, jeng, jreqs, peng, preqs


def test_engine_token_streams_identical(pair):
    _, _, jreqs, _, preqs = pair
    assert all(r.state.value == "finished" for r in preqs)
    assert [r.output_tokens for r in preqs] == \
        [r.output_tokens for r in jreqs]
    assert [r.migrations for r in preqs] == [r.migrations for r in jreqs]


def test_engine_recovery_and_stats_match(pair):
    """No experts: no map, runtime or MoE ranks; a fault revives as
    ``attn``, migrating on a "precompiled" graph, with the reference's
    actions; the prefill statistics and health equal the reference's."""
    name, jeng, _, peng, _ = pair
    fault = ENGINE_CASES[name][2]
    assert peng.expert_map is None and not peng.moe_executors
    assert peng.ecfg.mode == "collocated"
    assert len(peng.reports) == len(jeng.reports) == int(fault)
    for p, j in zip(peng.reports, jeng.reports):
        assert p.scenario == j.scenario == "attn"
        assert p.migrated == j.migrated >= 1
        assert p.compile_source == j.compile_source == "precompiled"
        assert p.actions == j.actions
        assert p.blocks_rolled_back == j.blocks_rolled_back
    assert peng.prefill_stats() == jeng.prefill_stats()
    ph, jh = (dataclasses.asdict(e.health()) for e in (peng, jeng))
    ph.pop("soft_signals"), jh.pop("soft_signals")   # wall-clock based
    assert ph == jh
