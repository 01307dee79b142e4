"""The port's ring-cache serve step against the JAX package, on the CPU.

``Model.prefill`` (with ``lengths``) builds per-row rings of ``max_seq``
slots, ``Model.init_cache`` an empty ring cache and ``Model.decode_step``
decodes against it: for every registered arch at smoke size, weights
drawn by ``repro``, written by its ``save_checkpoint`` and read by the
port's ``load_params`` (MoE capacity dropless, as
``tests/test_models.py::dropless``), the port's last logits after the
prefill and after each of 6 decode steps equal ``repro``'s within
``LOGIT_TOL``, and its rings (MLA: the latent ring's two column ranges,
``c_kv`` and ``k_rope``), Mamba states and cross K/V within ``TOL``.
Then the twin of ``tests/test_models.py::test_decode_matches_full_forward``
on the port alone, a sliding window whose decode wraps the ring, and the
ring-as-pool identity the decode's ``ops.paged_attention`` call rests on.
Inputs come from ``np.random.default_rng``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models.model import Model as JaxModel
from repro.training.checkpoint import save_checkpoint as jax_save
from repro_torch.configs import ALL_ARCHS, get_smoke_config
from repro_torch.models import attention as A
from repro_torch.models.model import Model
from repro_torch.training import checkpoint as ckpt
from test_torch_cases import one_torch_thread  # noqa: F401

TOL = 1e-4
LOGIT_TOL = 2e-4                 # tests/test_paged_serving.py:180
B, S_TOK, MAX_SEQ, STEPS = 2, 13, 32, 6


def dropless(cfg):
    """``tests/test_models.py::dropless``: MoE capacity no token exceeds."""
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=100.0))


def carry(tmp_path, arch, **over):
    """(repro model, its params, port model, the port's params): repro's
    weights through ``repro``'s ``save_checkpoint`` and the port's
    ``load_params``, both configs dropless with ``over`` applied."""
    jcfg = dataclasses.replace(dropless(jax_smoke_config(arch)), **over)
    pcfg = dataclasses.replace(dropless(get_smoke_config(arch)), **over)
    jm = JaxModel(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    path = str(tmp_path / f"{arch}.npz")
    jax_save(path, jparams)
    pparams = ckpt.load_params(path, dtype=torch.float32, device="cpu")
    return jm, jparams, Model(pcfg, device="cpu"), pparams


def make_batch(cfg, n_tok, seed=0, lengths=None):
    """numpy inputs: ``tokens`` (B, n_tok); a vlm's ``patches``, an audio
    model's ``frames``; ``lengths`` (a vlm row's counting its patches)."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, n_tok))
             .astype(np.int32)}
    if cfg.family == "vlm":
        batch["patches"] = rng.normal(
            size=(B, cfg.num_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        batch["frames"] = rng.normal(
            size=(B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if lengths is not None:
        batch["lengths"] = np.asarray(lengths, np.int32)
    return batch


def both(batch):
    """The batch as JAX arrays and as CPU tensors."""
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def jax_cache_flat(cache, prefix=""):
    """``repro``'s ring cache as {path: array} in the port's layout: a
    ``GQACache`` as ``k``/``v``, an ``MLACache`` as the fused ``ckr``
    ring (..., W, 1, R + dr), a ``MambaState`` as ``conv``/``ssm``."""
    if hasattr(cache, "_fields"):
        if "c_kv" in cache._fields:
            return {prefix + "ckr": np.concatenate(
                [np.asarray(cache.c_kv), np.asarray(cache.k_rope)],
                axis=-1)[..., None, :]}
        return {prefix + k: np.asarray(getattr(cache, k))
                for k in cache._fields}
    if isinstance(cache, dict):
        out = {}
        for k, v in cache.items():
            out.update(jax_cache_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(cache)}


def assert_cache_close(pcache, jcache, tol=TOL):
    want = jax_cache_flat(jcache)
    got = dict(ckpt.flatten(pcache))
    assert sorted(got) == sorted(want)
    for key, arr in want.items():
        assert tuple(got[key].shape) == arr.shape, key
        np.testing.assert_allclose(got[key].float().numpy(), arr,
                                   atol=tol, rtol=tol, err_msg=key)


def assert_logits_close(got, want, what):
    np.testing.assert_allclose(got.float().numpy()[..., :want.shape[-1]],
                               np.asarray(want), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL, err_msg=what)


def serve_both(jm, jparams, pm, pparams, batch, max_seq, steps):
    """``prefill`` then ``steps`` greedy ``decode_step``s in both packages,
    each step feeding ``repro``'s greedy tokens to both; every step's
    logits held within LOGIT_TOL.  Returns both caches after the prefill
    (the port's a copy) and after the last step."""
    jb, pb = both(batch)
    jlast, jcache = jax.jit(jm.prefill, static_argnames="max_seq")(
        jparams, jb, max_seq=max_seq)
    plast, pcache = pm.prefill(pparams, pb, max_seq=max_seq)
    assert_logits_close(plast, jlast, "prefill")
    after_prefill = (jcache, _clone(pcache))
    jstep = jax.jit(jm.decode_step)
    tok = np.asarray(jnp.argmax(jlast[:, :jm.cfg.vocab_size], -1), np.int32)
    for i in range(steps):
        jlog, jcache = jstep(jparams, jcache, jnp.asarray(tok))
        plog, pcache = pm.decode_step(pparams, pcache, torch.tensor(tok))
        assert_logits_close(plog, jlog, f"decode step {i}")
        tok = np.asarray(jnp.argmax(jlog[:, :jm.cfg.vocab_size], -1),
                         np.int32)
    return after_prefill, (jcache, pcache)


def _clone(cache):
    """A copy of a port cache, which decode steps update in place."""
    if isinstance(cache, dict):
        return {k: _clone(v) for k, v in cache.items()}
    return cache.clone()


@pytest.fixture(scope="module", params=ALL_ARCHS)
def arch_models(request, tmp_path_factory):
    arch = request.param
    return (arch,) + carry(tmp_path_factory.mktemp("ring"), arch)


def test_ring_serve_step_matches_repro(arch_models):
    """prefill with ``lengths`` (one row shorter by 3) and 6 decode steps:
    logits, rings and states equal ``repro``'s after the prefill and
    after the last step."""
    arch, jm, jparams, pm, pparams = arch_models
    cfg = pm.cfg
    extra = cfg.num_patches if cfg.family == "vlm" else 0
    batch = make_batch(cfg, S_TOK, seed=1,
                       lengths=[S_TOK + extra, S_TOK + extra - 3])
    (jc0, pc0), (jc1, pc1) = serve_both(jm, jparams, pm, pparams, batch,
                                        MAX_SEQ, STEPS)
    assert_cache_close(pc0, jc0)
    assert_cache_close(pc1, jc1)
    assert pc1["pos"].tolist() == [S_TOK + extra + STEPS,
                                   S_TOK + extra - 3 + STEPS]


def test_init_cache_matches_repro(arch_models):
    """``init_cache``'s structure and shapes equal ``repro``'s, all zero."""
    arch, jm, _, pm, _ = arch_models
    jcache = jm.init_cache(3, MAX_SEQ)
    pcache = pm.init_cache(3, MAX_SEQ)
    want = jax_cache_flat(jcache)
    got = dict(ckpt.flatten(pcache))
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: v.shape for k, v in want.items()}
    assert all(not v.any() for v in got.values())


def test_decode_matches_full_forward(arch_models):
    """The twin of ``tests/test_models.py::test_decode_matches_full_forward``
    on the port: prefill(S-1) + decode(1) == the full forward's logits at
    the last position."""
    arch, _, _, pm, pparams = arch_models
    cfg = pm.cfg
    S = 17
    n_tok = S - (cfg.num_patches if cfg.family == "vlm" else 0)
    _, pb = both(make_batch(cfg, n_tok, seed=2))
    full, _ = pm.logits_full(pparams, pb)
    short = dict(pb, tokens=pb["tokens"][:, :-1])
    _, cache = pm.prefill(pparams, short, max_seq=32)
    dec, _ = pm.decode_step(pparams, cache, pb["tokens"][:, -1])
    ref = full[:, -1]
    rel = float((dec - ref).abs().max()) / (float(ref.abs().max()) + 1e-9)
    assert rel < 5e-3, (arch, rel)


def test_sliding_window_decode_wraps_the_ring(tmp_path):
    """internlm2-20b smoke with ``sliding_window=8``: a 24-token prefill
    keeps the last 8 positions, and 12 decode steps wrap the ring past
    its slot 0; every step equal to ``repro``'s."""
    jm, jparams, pm, pparams = carry(tmp_path, "internlm2-20b",
                                     sliding_window=8)
    batch = make_batch(pm.cfg, 24, seed=3)
    _, (jcache, pcache) = serve_both(jm, jparams, pm, pparams, batch, 24, 12)
    assert tuple(pcache["layers"]["k"].shape[2:3]) == (8,)
    assert_cache_close(pcache, jcache)


@pytest.mark.parametrize("W", [1, 5, 8])
def test_ring_as_pool_is_the_valid_prefix(W):
    """``_ring_validity``'s valid slots are exactly ``[0, min(pos + 1,
    W))``, the ``seq_lens`` of ``ring_page``'s pool view, and a slot's
    position is ``pos`` at slot ``pos % W``."""
    pos = torch.arange(3 * W + 2, dtype=torch.int32)
    slot_pos, valid = A._ring_validity(pos, W)
    tables, seq_lens = A.ring_page(pos, W)
    assert torch.equal(tables[:, 0], torch.arange(len(pos),
                                                  dtype=torch.int32))
    assert torch.equal(valid, torch.arange(W)[None, :] < seq_lens[:, None])
    rows = torch.arange(len(pos))
    assert torch.equal(slot_pos[rows, pos.long() % W], pos.long())
