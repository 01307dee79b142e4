"""The port's multi-head latent attention (deepseek-v3) against the JAX
package, on the CPU.

One JAX-initialised ``deepseek-v3`` smoke parameter set (one dense and
one MoE layer) is carried into the port by the checkpoint loader; every
MLA function, ``Model.decode_step_paged`` on the composed and megakernel
paths, and ``Model.prefill_paged`` with ``install_prefill`` then run in
both packages on the same numpy inputs; so does whole-prompt attention
with a V width other than the QK width.  f32 tolerance 1e-4, as
tests/test_kernels.py (2e-4 for attention, as its flash kernels).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import attention as jax_attention
from repro.models.model import Model as JaxModel
from repro.serving import cache_ops as jax_cache_ops
from repro.serving.kvcache import padded_block_ids
from repro.training.checkpoint import _flatten, save_checkpoint as jax_save
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import launches
from repro_torch.kernels.flash_prefill import flash_prefill_plain
from repro_torch.models import attention as pt_attention
from repro_torch.models.layers import take_layer
from repro_torch.models.model import Model
from repro_torch.serving import cache_ops
from repro_torch.serving.executor import next_bucket
from repro_torch.training import checkpoint as ckpt
from test_torch_cases import FLASH_DV_CASES, flash_inputs, t as _t
from test_torch_model import BS, NUM_BLOCKS, TRASH, _steps
from test_torch_cases import one_torch_thread  # noqa: F401

ARCH = "deepseek-v3"
TOL = 1e-4
ATTN_TOL = 2e-4          # tests/test_kernels.py:237, the flash kernels'


def _configs(**over):
    return (dataclasses.replace(jax_smoke_config(ARCH), **over),
            dataclasses.replace(get_smoke_config(ARCH), **over))


@pytest.fixture(scope="module")
def jax_params():
    return JaxModel(jax_smoke_config(ARCH)).init(jax.random.PRNGKey(3))


def _port_params(jax_params):
    return ckpt.params_from_flat(_flatten(jax_params).items(), {},
                                 dtype=torch.float32, device="cpu")


def _mixers(jax_params, group="layers"):
    """Layer 0's MLA leaves of ``group`` in both packages."""
    jp = jax.tree_util.tree_map(lambda a: a[0], jax_params[group]["mixer"])
    pp = take_layer(_port_params(jax_params)[group]["mixer"], 0)
    return jp, pp


def _page(B=3, seed=0):
    """Decode paging arrays over the smoke pools: rows of 5, 11 and 0
    (idle, trash) valid positions."""
    rng = np.random.default_rng(seed)
    tables = np.stack([rng.permutation(NUM_BLOCKS)[:4] for _ in range(B)])
    seq = np.array([5, 11, 0][:B], np.int32)
    wb = np.where(seq > 0, tables[np.arange(B), np.maximum(seq - 1, 0) // BS],
                  TRASH).astype(np.int32)
    wo = (np.maximum(seq - 1, 0) % BS).astype(np.int32)
    return dict(tables=tables.astype(np.int32), seq_lens=seq, write_bid=wb,
                write_off=wo)


def _x(B, D, seed=1):
    return (np.random.default_rng(seed).normal(size=(B, D)) * 0.5
            ).astype(np.float32)


def test_checkpoint_keys_and_shapes_match_repro(tmp_path, jax_params):
    """The port's MLA leaves have repro's names and layouts (``wuk`` (H,
    dn, R), ``wuv`` (H, R, dv)), with the ``dense_layers`` group beside
    ``layers``, so a repro ``weights.npz`` loads unchanged."""
    path = str(tmp_path / "weights.npz")
    jax_save(path, jax_params)
    arrays, _ = ckpt.load_flat(path)
    mine = dict(ckpt.flatten(Model(get_smoke_config(ARCH),
                                   device="cpu").init(0)))
    assert sorted(mine) == sorted(arrays)
    for k, v in mine.items():
        assert tuple(v.shape) == arrays[k].shape, k
    m = get_smoke_config(ARCH).mla
    H = get_smoke_config(ARCH).num_heads
    assert mine["layers/mixer/wuk"].shape[1:] == (H, m.qk_nope_head_dim,
                                                 m.kv_lora_rank)
    assert mine["dense_layers/mixer/wuv"].shape[1:] == (H, m.kv_lora_rank,
                                                       m.v_head_dim)
    loaded = dict(ckpt.flatten(ckpt.load_params(path, dtype=torch.float32,
                                                device="cpu")))
    for k, v in _flatten(jax_params).items():
        np.testing.assert_array_equal(loaded[k].numpy(), np.asarray(v))


def test_mla_decode_q_token_matches_jax(jax_params):
    jcfg, pcfg = _configs()
    jp, pp = _mixers(jax_params)
    x, page = _x(3, pcfg.d_model), _page()
    jq, jtok = jax_attention.mla_decode_q_token(
        jp, jcfg, jnp.asarray(x), {k: jnp.asarray(v) for k, v in page.items()})
    pq, ptok = pt_attention.mla_decode_q_token(
        pp, pcfg, _t(x), {k: _t(v) for k, v in page.items()})
    m = pcfg.mla
    assert pq.shape == (3, pcfg.num_heads,
                        m.kv_lora_rank + m.qk_rope_head_dim)
    np.testing.assert_allclose(pq.numpy(), np.asarray(jq), atol=TOL, rtol=0)
    np.testing.assert_allclose(ptok.numpy(), np.asarray(jtok), atol=TOL,
                               rtol=0)


@pytest.mark.parametrize("group", ["dense_layers", "layers"])
def test_mla_post_matrix_matches_jax(jax_params, group):
    jcfg, pcfg = _configs()
    jp, pp = _mixers(jax_params, group)
    want = np.asarray(jax_attention.mla_post_matrix(jp, jcfg))
    got = pt_attention.mla_post_matrix(pp, pcfg).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    dr = pcfg.mla.qk_rope_head_dim
    rows = got.reshape(pcfg.num_heads, -1, got.shape[-1])
    assert not rows[:, -dr:].any()       # the rope columns read out nothing


def test_mla_post_cached_per_weight_version(jax_params):
    """``Model.mla_post`` builds the absorbed readout once per weight
    version: the same tensor again, a new one after an in-place edit of
    ``wo`` or a reload."""
    _, pcfg = _configs()
    pm = Model(pcfg, device="cpu")
    params = _port_params(jax_params)
    a = pm.mla_post(params, "layers")
    assert pm.mla_post(params, "layers") is a
    mixer = take_layer(params["layers"]["mixer"], 0)
    np.testing.assert_array_equal(
        a[0].numpy(), pt_attention.mla_post_matrix(mixer, pcfg).numpy())
    params["layers"]["mixer"]["wo"].mul_(2.0)
    b = pm.mla_post(params, "layers")
    assert b is not a
    np.testing.assert_allclose(b.numpy(), 2 * a.numpy(), rtol=1e-6,
                               atol=1e-7)
    c = pm.mla_post(_port_params(jax_params), "layers")
    np.testing.assert_array_equal(c.numpy(), a.numpy())


def test_mla_decode_paged_matches_jax(jax_params):
    jcfg, pcfg = _configs()
    jp, pp = _mixers(jax_params)
    x, page = _x(3, pcfg.d_model, 4), _page(seed=2)
    pools = np.random.default_rng(5).normal(
        size=(NUM_BLOCKS + 1, BS, 1, 48)).astype(np.float32)
    jy, jpools = jax_attention.mla_decode_paged(
        jp, jcfg, jnp.asarray(x), {"ckr": jnp.asarray(pools)},
        {k: jnp.asarray(v) for k, v in page.items()})
    ppools = {"ckr": _t(pools.copy())}
    py = pt_attention.mla_decode_paged(pp, pcfg, _t(x), ppools,
                                       {k: _t(v) for k, v in page.items()})
    np.testing.assert_allclose(py.numpy(), np.asarray(jy), atol=TOL, rtol=0)
    # written in place, as the JAX package's returned pool
    np.testing.assert_allclose(ppools["ckr"][:TRASH].numpy(),
                               np.asarray(jpools["ckr"])[:TRASH], atol=TOL,
                               rtol=0)


@pytest.mark.parametrize("window", [0, 6], ids=["causal", "window6"])
def test_mla_forward_with_cache_matches_jax(jax_params, window):
    jcfg, pcfg = _configs(sliding_window=window)
    jp, pp = _mixers(jax_params, "dense_layers")
    S = 24
    x = (np.random.default_rng(6).normal(size=(2, S, pcfg.d_model)) * 0.5
         ).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)
    jy, (jc, jk) = jax_attention.mla_forward_with_cache(
        jp, jcfg, jnp.asarray(x), jnp.asarray(pos))
    py, (pc, pk) = pt_attention.mla_forward_with_cache(pp, pcfg, _t(x),
                                                       _t(pos))
    for got, want in ((py, jy), (pc, jc), (pk, jk)):
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                                   rtol=0)


def _run(model, params, cache, to, runtime=None):
    """One chunk step and two decode steps (test_torch_model._steps),
    feeding each step's greedy tokens to the next."""
    (ctoks, cpage), decodes, rows = _steps(model.cfg.vocab_size)

    def step(tokens, page):
        out = model.decode_step_paged(params, cache, to(tokens),
                                      {k: to(v) for k, v in page.items()},
                                      runtime)
        return np.asarray(out[0]), out[1]

    logits = []
    lg, cache = step(ctoks, cpage)
    logits.append(lg)
    nxt = np.zeros(4, np.int32)
    nxt[[0, 2]] = lg[[rows[0], rows[1]]].argmax(-1)
    for page in decodes:
        lg, cache = step(nxt, page)
        logits.append(lg)
        nxt[[0, 2]] = lg[[0, 2]].argmax(-1)
    return logits, cache, rows


@pytest.mark.parametrize("decode_impl,moe_impl", [
    ("composed", "fused"), ("composed", "gather_psum"),
    ("megakernel", "fused")])
def test_decode_step_paged_matches_jax(jax_params, decode_impl, moe_impl):
    jcfg, pcfg = _configs(decode_impl=decode_impl, moe_impl=moe_impl)
    jm, pm = JaxModel(jcfg), Model(pcfg, device="cpu")
    jl, jcache, rows = _run(jm, jax_params,
                            jm.init_paged_cache(4, NUM_BLOCKS, BS),
                            jnp.asarray)
    pl, pcache, _ = _run(pm, _port_params(jax_params),
                         pm.init_paged_cache(4, NUM_BLOCKS, BS), _t)
    for i, (a, b) in enumerate(zip(pl, jl)):
        np.testing.assert_allclose(a, b, atol=TOL, rtol=0)
        live = list(rows) if i == 0 else [0, 2]
        np.testing.assert_array_equal(a[live].argmax(-1), b[live].argmax(-1))
    assert sorted(pcache) == ["dense_layers", "layers"]
    for group in pcache:
        assert list(pcache[group]) == ["ckr"]
        np.testing.assert_allclose(
            pcache[group]["ckr"][:, :TRASH].numpy(),
            np.asarray(jcache[group]["ckr"])[:, :TRASH], atol=1e-5, rtol=0)


def test_megakernel_matches_composed_and_reads_the_cached_post():
    """The port's two decode paths agree, and the megakernel path builds
    ``w_post`` once for all its steps."""
    base = get_smoke_config(ARCH)
    params = Model(base, device="cpu").init(7)
    out = []
    for impl in ("composed", "megakernel"):
        pm = Model(dataclasses.replace(base, decode_impl=impl,
                                       moe_impl="fused"), device="cpu")
        logits, _, _ = _run(pm, params,
                            pm.init_paged_cache(4, NUM_BLOCKS, BS), _t)
        out.append(logits)
        assert (len(pm._w_post) == 1) == (impl == "megakernel")
    for a, b in zip(*out):
        np.testing.assert_allclose(a, b, atol=TOL, rtol=0)


def test_prefill_paged_install_then_decode_matches_jax(jax_params):
    """The serial path: a whole-prompt prefill (latent rows (L, 1, S, 1,
    R + dr)) installed into both groups' pools, then a decode step."""
    jcfg, pcfg = _configs(moe_impl="gather_psum")
    jm, pm = JaxModel(jcfg), Model(pcfg, device="cpu")
    pp = _port_params(jax_params)
    n = 11
    tokens = np.zeros((1, next_bucket(n, 64)), np.int32)
    tokens[0, :n] = np.random.default_rng(n).integers(0, pcfg.vocab_size, n)
    lengths = np.asarray([n], np.int32)
    jl, jraw = jm.prefill_paged(jax_params, {"tokens": jnp.asarray(tokens),
                                             "lengths": jnp.asarray(lengths)})
    launches.clear()
    pl, praw = pm.prefill_paged(pp, {"tokens": _t(tokens),
                                     "lengths": _t(lengths)})
    assert not launches         # on the CPU: the plain versions
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=TOL, rtol=0)
    S = tokens.shape[1]
    for group in ("dense_layers", "layers"):
        got, want = praw[group]["ckr"].numpy(), np.asarray(jraw[group]["ckr"])
        assert got.shape == want.shape == (1, 1, S, 1, 48)
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    blocks = [5, 2, 7]
    bids = padded_block_ids(blocks, S // BS, TRASH)
    jcache = jm.init_paged_cache(4, NUM_BLOCKS, BS)
    _, jaxes = jax_cache_ops.infer_paged_axes(jm, NUM_BLOCKS, BS)
    jcache = jax_cache_ops.install_prefill(jcache, jraw, jaxes,
                                           jnp.asarray(bids), 0)
    pcache = pm.init_paged_cache(4, NUM_BLOCKS, BS)
    paxes = cache_ops.infer_paged_axes(pm, NUM_BLOCKS, BS)
    assert paxes == [None, None]          # both groups' latent pools
    cache_ops.install_prefill(pcache, praw, paxes, bids, 0)
    page = dict(tables=np.zeros((4, 4), np.int32),
                seq_lens=np.zeros(4, np.int32),
                write_bid=np.full(4, TRASH, np.int32),
                write_off=np.zeros(4, np.int32))
    page["tables"][0, :3] = blocks
    page["seq_lens"][0] = n + 1
    page["write_bid"][0], page["write_off"][0] = blocks[n // BS], n % BS
    tok = np.zeros(4, np.int32)
    tok[0] = np.asarray(jl).argmax(-1)[0]
    jdl, jcache = jm.decode_step_paged(
        jax_params, jcache, jnp.asarray(tok),
        {k: jnp.asarray(v) for k, v in page.items()})
    pdl, _ = pm.decode_step_paged(pp, pcache, _t(tok),
                                  {k: _t(v) for k, v in page.items()})
    np.testing.assert_allclose(pdl.numpy()[0], np.asarray(jdl)[0], atol=TOL,
                               rtol=0)
    assert pdl.numpy()[0].argmax() == np.asarray(jdl)[0].argmax()
    for group in ("dense_layers", "layers"):
        np.testing.assert_allclose(
            pcache[group]["ckr"][:, :TRASH].numpy(),
            np.asarray(jcache[group]["ckr"])[:, :TRASH], atol=1e-5, rtol=0)


@pytest.mark.parametrize("case", list(FLASH_DV_CASES))
def test_flash_attention_v_width_matches_jax(case):
    """Whole-prompt attention with a V width other than the QK width (MLA:
    dn + dr against dv): the port's chunked ``flash_attention`` and the
    plain ``flash_prefill`` against ``repro``'s ``flash_attention``."""
    B, S, H, Hkv, Dq, Dv, causal, window = FLASH_DV_CASES[case]
    q, k, v, pos, _ = flash_inputs(B, S, H, Hkv, Dq, 0, Dv=Dv)
    kw = dict(causal=causal, window=window)
    want = np.asarray(jax_attention.flash_attention(
        *map(jnp.asarray, (q, k, v, pos, pos)), q_chunk=16, kv_chunk=16,
        **kw))
    assert want.shape == (B, S, H, Dv)
    got = pt_attention.flash_attention(*map(_t, (q, k, v, pos, pos)),
                                       q_chunk=16, kv_chunk=16, **kw)
    plain = flash_prefill_plain(*map(_t, (q, k, v, pos, pos)), **kw)
    for out in (got, plain):
        np.testing.assert_allclose(out.numpy(), want, rtol=ATTN_TOL,
                                   atol=ATTN_TOL)
