"""The port's vlm (internvl2-26b) and audio (seamless-m4t-large-v2)
families against the JAX package, on the CPU, at smoke size.

The vlm is the dense model with precomputed patch embeddings before the
tokens; the audio model a non-causal encoder over precomputed frame
embeddings and a decoder whose blocks cross-attend to it.  Weights are
drawn by ``repro`` and carried across through its ``save_checkpoint`` and
the port's ``load_params``; patches, frames and tokens come from
``np.random.default_rng``.  Held to ``repro``: the checkpoint keys of both
families, the structure, ``logits_full``, the audio's ``_encode`` and
``_cross_kv``, and the ring serve step (``prefill`` then greedy
``decode_step``s).  The paged serving path refuses both as ``repro``'s
does: the audio at its paged cache, the vlm at the first prefill, whose
batch carries no patches.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models.model import Model as JaxModel
from repro.serving.engine import EngineConfig as JaxEngineConfig
from repro.serving.engine import InferenceEngine as JaxEngine
from repro.training.checkpoint import _flatten
from repro.training.checkpoint import save_checkpoint as jax_save
from repro_torch.configs import get_smoke_config
from repro_torch.models.model import Model
from repro_torch.serving.engine import EngineConfig, InferenceEngine
from repro_torch.training import checkpoint as ckpt
from test_torch_ring import (TOL, assert_cache_close,
                             assert_logits_close, both, carry, make_batch,
                             serve_both)
from test_torch_cases import one_torch_thread  # noqa: F401

VLM, AUDIO = "internvl2-26b", "seamless-m4t-large-v2"


@pytest.fixture(scope="module")
def vlm(tmp_path_factory):
    return carry(tmp_path_factory.mktemp("vlm"), VLM)


@pytest.fixture(scope="module")
def audio(tmp_path_factory):
    return carry(tmp_path_factory.mktemp("audio"), AUDIO)


# -- structure and the weight carry-across ---------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_checkpoint_carry_across(tmp_path, arch, dtype):
    """``weights.npz`` written by ``repro`` loads into the port with every
    key, shape and value: the audio's ``enc_layers/*``, ``enc_norm``,
    ``layers/cross/*`` and ``layers/ln_cross`` among them; the port's own
    ``init`` draws the same keys and shapes."""
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jparams = JaxModel(jax_smoke_config(arch), dtype=jdt).init(
        jax.random.PRNGKey(1))
    path = str(tmp_path / "weights.npz")
    jax_save(path, jparams)
    got = ckpt.load_params(path, dtype=getattr(torch, dtype), device="cpu")
    flat = _flatten(jparams)
    keys = sorted(k for k, _ in ckpt.flatten(got))
    assert keys == sorted(flat)
    if arch == AUDIO:
        for key in ("enc_norm", "layers/ln_cross", "layers/cross/wq",
                    "layers/cross/wk", "layers/cross/wv", "layers/cross/wo",
                    "enc_layers/mixer/wq", "enc_layers/ffn/w_down"):
            assert key in keys, key
    for key, leaf in ckpt.flatten(got):
        want = np.asarray(flat[key]).astype(np.float32)
        assert tuple(leaf.shape) == want.shape, key
        np.testing.assert_array_equal(leaf.float().numpy(), want, key)
    fresh = Model(get_smoke_config(arch), getattr(torch, dtype),
                  device="cpu").init(0)
    assert {k: tuple(v.shape) for k, v in ckpt.flatten(fresh)} == \
        {k: v.shape for k, v in flat.items()}


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_structure_matches_repro(arch):
    jm = JaxModel(jax_smoke_config(arch))
    pm = Model(get_smoke_config(arch), device="cpu")
    assert pm.layer_groups() == jm.layer_groups()
    assert not pm.supports_chunked_prefill and not jm.supports_chunked_prefill
    if arch == AUDIO:
        assert pm.layer_groups()[0] == ("enc_layers", 2, "attn", "dense",
                                        False)
        for model in (jm, pm):
            with pytest.raises(ValueError, match="encoder-decoder"):
                model.init_paged_cache(2, 8, 4)
    else:
        assert len(jax.tree_util.tree_leaves(jm.init_paged_cache(2, 8, 4))) \
            == len(list(ckpt.flatten(pm.init_paged_cache(2, 8, 4))))


# -- the vlm ------------------------------------------------------------------------

def test_vlm_logits_full_matches_repro(vlm):
    """Seeded patches before the tokens: every position's logits, the
    patches' included."""
    jm, jparams, pm, pparams = vlm
    jb, pb = both(make_batch(pm.cfg, 11, seed=4))
    want, _, _ = jm.logits_full(jparams, jb)
    got, _ = pm.logits_full(pparams, pb)
    assert got.shape[1] == pm.cfg.num_patches + 11
    assert_logits_close(got, want, "logits_full")


def test_vlm_prefill_and_decode_match_repro(vlm):
    """Rows of 8 patches and 11 or 4 real tokens (``lengths`` counts the
    patches), rings of exactly the 19 positions, so the 4 decode steps
    overwrite the first row's patches."""
    jm, jparams, pm, pparams = vlm
    P = pm.cfg.num_patches
    batch = make_batch(pm.cfg, 11, seed=5, lengths=[P + 11, P + 4])
    _, (jcache, pcache) = serve_both(jm, jparams, pm, pparams, batch,
                                     P + 11, 4)
    assert tuple(pcache["layers"]["k"].shape[2:3]) == (P + 11,)
    assert_cache_close(pcache, jcache)


# -- the audio ----------------------------------------------------------------------

def test_audio_encoder_and_cross_kv_match_repro(audio):
    """The non-causal encoder over seeded frames (then ``enc_norm``), and
    each decoder layer's cross K/V of its output."""
    jm, jparams, pm, pparams = audio
    batch = make_batch(pm.cfg, 6, seed=6)
    frames = batch["frames"]
    want = jm._encode(jparams, jnp.asarray(frames), None)
    got = pm._encode(pparams, torch.from_numpy(frames))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    jkv = jm._cross_kv(jparams, want)
    pkv = pm._cross_kv(pparams, got)
    for key in ("k", "v"):
        assert tuple(pkv[key].shape) == (pm.cfg.num_layers, 2,
                                         pm.cfg.encoder_seq, 2, 64)
        np.testing.assert_allclose(pkv[key].numpy(), np.asarray(jkv[key]),
                                   atol=TOL, rtol=TOL, err_msg=key)


def test_audio_logits_full_matches_repro(audio):
    jm, jparams, pm, pparams = audio
    jb, pb = both(make_batch(pm.cfg, 9, seed=7))
    want, _, _ = jm.logits_full(jparams, jb)
    got, caches = pm.logits_full(pparams, pb)
    assert_logits_close(got, want, "logits_full")
    assert set(caches["layers"]) == {"self", "cross"}


def test_audio_prefill_and_decode_match_repro(audio):
    """Decoder rows of 9 and 5 tokens over 16 encoder frames, 5 greedy
    decode steps: logits, self-attention rings and cross K/V."""
    jm, jparams, pm, pparams = audio
    batch = make_batch(pm.cfg, 9, seed=8, lengths=[9, 5])
    (jc0, pc0), (jc1, pc1) = serve_both(jm, jparams, pm, pparams, batch,
                                        16, 5)
    assert_cache_close(pc0, jc0)
    assert_cache_close(pc1, jc1)
    assert torch.equal(pc0["layers"]["cross"]["k"],
                       pc1["layers"]["cross"]["k"])


# -- the paged serving path refuses both, as repro's ---------------------------------

@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_engine_fails_as_repros(tmp_path, arch):
    """The port's engine: the audio fails at build (``init_paged_cache``),
    the vlm at its first prefill, whose batch is ``tokens`` and
    ``lengths`` alone (``repro``'s prefill closure,
    src/repro/serving/engine.py:78-82).  ``repro``'s engine fails the
    same way: built here for the audio, which fails before any compile;
    for the vlm the reference model's prefill is given that batch."""
    want = {VLM: (KeyError, "'patches'"),
            AUDIO: (ValueError, "paged serving does not support "
                    "encoder-decoder (audio) models")}[arch]
    with pytest.raises(want[0]) as info:
        eng = InferenceEngine(get_smoke_config(arch),
                              EngineConfig(workdir=str(tmp_path / "pt"),
                                           mode="collocated"),
                              device="cpu")
        eng.submit(list(range(1, 9)), 4)
        eng.run(max_steps=4)
    assert str(info.value) == want[1]
    with pytest.raises(want[0]) as info:
        if arch == AUDIO:
            JaxEngine(jax_smoke_config(arch),
                      JaxEngineConfig(workdir=str(tmp_path / "jax"),
                                      mode="collocated"))
        else:
            jm = JaxModel(jax_smoke_config(arch))
            jm.prefill_paged(jm.init(jax.random.PRNGKey(0)), {
                "tokens": jnp.zeros((1, 16), jnp.int32),
                "lengths": jnp.asarray([8], jnp.int32)})
    assert str(info.value) == want[1]

