"""The port's hybrid family (``jamba-1.5-large-398b``) against the JAX
package, on the CPU, at smoke size: one period of eight sublayers
(attention at sublayer 4, Mamba elsewhere, MoE on the odd ones), d_model
256, 4 experts + 2 replicas.

A period's paged-cache entry holds both kinds of serving state:
``{"attn": {"k", "v"}: (L, blocks, bs, Hkv, Dh) pools, "ssm": {"conv",
"ssm"}: (L, 7, batch, ...) per-slot states}``.  These tests hold the
checkpoint carry-across, the structure, the whole-prompt prefill, its
install and five paged decode steps to ``repro``; the scan rates'
cache per (group, sublayer); and the cache operations of recovery (the
§3.3 row undo, the KV-stream gather and scatter) over pools and states
together.  Weights are JAX-initialised and carried across by the
checkpoint loader; inputs come from ``np.random.default_rng``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models.model import Model as JaxModel
from repro.serving import cache_ops as jax_cache_ops
from repro.training.checkpoint import _flatten
from repro.training.checkpoint import save_checkpoint as jax_save
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels import ops
from repro_torch.models import mamba as pt_mamba
from repro_torch.models.model import Model
from repro_torch.serving import cache_ops
from repro_torch.serving.kvcache import build_page_context, padded_block_ids
from repro_torch.training import checkpoint as ckpt
from test_torch_cases import t as _t

ARCH = "jamba-1.5-large-398b"
PREFILL_TOL = 1e-4
LOGIT_TOL = 2e-4                 # tests/test_paged_serving.py:180
BS, NUM_BLOCKS, MAX_BATCH, MAX_BLK = 4, 24, 2, 8
SUBLAYERS = [("sub_0", "mamba", "dense"), ("sub_1", "mamba", "moe"),
             ("sub_2", "mamba", "dense"), ("sub_3", "mamba", "moe"),
             ("sub_4", "attn", "dense"), ("sub_5", "mamba", "moe"),
             ("sub_6", "mamba", "dense"), ("sub_7", "mamba", "moe")]


def _jdt(dtype):
    return jnp.bfloat16 if dtype == "bfloat16" else jnp.float32


@pytest.fixture(scope="module")
def models():
    jm = JaxModel(jax_smoke_config(ARCH))
    jparams = jm.init(jax.random.PRNGKey(0))
    pparams = ckpt.params_from_flat(_flatten(jparams).items(), {},
                                    dtype=torch.float32, device="cpu")
    return jm, jparams, Model(get_smoke_config(ARCH), device="cpu"), pparams


# -- structure and the weight carry-across --------------------------------------

def test_structure_and_paged_cache_match_jax(models):
    jm, jparams, pm, _ = models
    assert pm.layer_groups() == jm.layer_groups() == \
        [("periods", 1, "hybrid", None, False)]
    assert pm.period_sublayers() == SUBLAYERS
    assert not pm.supports_chunked_prefill
    assert pm.default_runtime() is not None
    fresh = pm.init(0)
    flat = _flatten(jparams)
    assert sorted(k for k, _ in ckpt.flatten(fresh)) == sorted(flat)
    for key, leaf in ckpt.flatten(fresh):
        assert tuple(leaf.shape) == flat[key].shape, key
    pcache = pm.init_paged_cache(3, NUM_BLOCKS, BS)
    jcache = jm.init_paged_cache(3, NUM_BLOCKS, BS)
    pleaves = cache_ops.cache_leaves(pcache)
    jleaves = jax.tree_util.tree_leaves(jcache)
    assert [tuple(p.shape) for p in pleaves] == [j.shape for j in jleaves]
    assert tuple(pcache["periods"]["attn"]["k"].shape) == \
        (1, NUM_BLOCKS + 1, BS, 2, 64)
    assert tuple(pcache["periods"]["ssm"]["conv"].shape) == (1, 7, 3, 4, 512)
    assert tuple(pcache["periods"]["ssm"]["ssm"].shape) == (1, 7, 3, 512, 16)
    axes = cache_ops.infer_paged_axes(pm, NUM_BLOCKS, BS)
    assert axes == jax_cache_ops.infer_paged_axes(jm, NUM_BLOCKS, BS)[1] \
        == [None, None, 2, 2]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoint_carry_across(tmp_path, dtype):
    """``weights.npz`` written by ``repro`` for Jamba smoke loads into the
    port with every ``periods/sub_i/...`` key, shape and value, and the
    port's own file reads back bit for bit."""
    jparams = JaxModel(jax_smoke_config(ARCH), dtype=_jdt(dtype)).init(
        jax.random.PRNGKey(1))
    path = str(tmp_path / "weights.npz")
    jax_save(path, jparams)
    got = ckpt.load_params(path, dtype=getattr(torch, dtype), device="cpu")
    flat = _flatten(jparams)
    keys = [k for k, _ in ckpt.flatten(got)]
    assert sorted(keys) == sorted(flat)
    assert {k.split("/")[1] for k in keys if k.startswith("periods/")} == \
        {sub for sub, _, _ in SUBLAYERS}
    for key, leaf in ckpt.flatten(got):
        want = np.asarray(flat[key]).astype(np.float32)
        assert tuple(leaf.shape) == want.shape, key
        np.testing.assert_array_equal(leaf.float().numpy(), want, key)
    ckpt.save_checkpoint(str(tmp_path / "port.npz"), got)
    again = ckpt.load_params(str(tmp_path / "port.npz"),
                             dtype=getattr(torch, dtype), device="cpu")
    for (k1, a), (k2, b) in zip(ckpt.flatten(got), ckpt.flatten(again)):
        assert k1 == k2 and torch.equal(a, b)


def test_full_config_widths():
    """The widths the card path serves: one period of the full config."""
    cfg = get_config(ARCH)
    d_inner, N, d_conv, dt_rank = pt_mamba.mamba_dims(cfg)
    assert (cfg.num_layers, cfg.hybrid_period, cfg.d_model, cfg.num_heads,
            cfg.num_kv_heads, cfg.head_dim, cfg.d_ff) == \
        (72, 8, 8192, 64, 8, 128, 24576)
    assert (d_inner, N, d_conv, dt_rank) == (16384, 16, 4, 512)
    assert (cfg.moe.num_experts, cfg.moe.top_k, cfg.moe.expert_d_ff) == \
        (16, 2, 24576)
    assert Model(cfg, device="cpu").vpad == 65536


# -- prefill, install, paged decode -------------------------------------------------

def _prompt(jm):
    rng = np.random.default_rng(0)
    tokens = np.zeros((1, 16), np.int32)
    tokens[0, :9] = rng.integers(0, jm.cfg.vocab_size, 9)
    return tokens, np.asarray([9], np.int32)


def _page(slot_len, blocks):
    """The paging arrays of a step that decodes only slot 1, at valid
    length ``slot_len`` over ``blocks``; slot 0 idle."""

    class _Req:
        batch_slot, req_id, num_tokens = 1, 7, slot_len

    class _Table:
        pass
    table = _Table()
    table.blocks = blocks
    return build_page_context([_Req()], {7: table}, max_batch=MAX_BATCH,
                              max_blk=MAX_BLK, block_size=BS,
                              trash_block=NUM_BLOCKS)


def test_prefill_install_decode_matches_jax(models):
    """tests/test_paged_serving.py::_run_parity's hybrid case, port
    against ``repro``: a 9-token prompt prefilled at bucket 16 (so the
    padding runs through every Mamba sublayer's recurrence in both),
    installed into slot 1 — pool rows and seven states — then five
    greedy decode steps, each of which advances idle slot 0's states too,
    in both packages."""
    jm, jparams, pm, pparams = models
    tokens, lengths = _prompt(jm)
    jl, jraw = jm.prefill_paged(jparams, {"tokens": jnp.asarray(tokens),
                                          "lengths": jnp.asarray(lengths)})
    pl, praw = pm.prefill_paged(pparams, {"tokens": _t(tokens),
                                          "lengths": _t(lengths)})
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=PREFILL_TOL,
                               rtol=PREFILL_TOL)
    jraw_leaves = jax.tree_util.tree_leaves(jraw)
    for p, j in zip(cache_ops.cache_leaves(praw), jraw_leaves):
        assert tuple(p.shape) == j.shape
        np.testing.assert_allclose(p.numpy(), np.asarray(j),
                                   atol=PREFILL_TOL, rtol=PREFILL_TOL)
    assert tuple(praw["periods"]["attn"]["k"].shape) == (1, 1, 16, 2, 64)
    assert tuple(praw["periods"]["ssm"]["ssm"].shape) == (1, 7, 1, 512, 16)

    blocks = [3, 0, 5]
    bids = padded_block_ids(blocks, 4, trash_block=NUM_BLOCKS)
    jcache = jm.init_paged_cache(MAX_BATCH, NUM_BLOCKS, BS)
    _, jaxes = jax_cache_ops.infer_paged_axes(jm, NUM_BLOCKS, BS)
    jcache = jax_cache_ops.install_prefill(jcache, jraw, jaxes,
                                           jnp.asarray(bids), jnp.int32(1))
    pcache = pm.init_paged_cache(MAX_BATCH, NUM_BLOCKS, BS)
    paxes = cache_ops.infer_paged_axes(pm, NUM_BLOCKS, BS)
    cache_ops.install_prefill(pcache, praw, paxes, bids, 1)
    for p, j in zip(cache_ops.cache_leaves(pcache),
                    jax.tree_util.tree_leaves(jcache)):
        np.testing.assert_allclose(p.numpy(), np.asarray(j),
                                   atol=PREFILL_TOL, rtol=PREFILL_TOL)

    tok = int(np.argmax(np.asarray(jl)[0]))
    assert int(pl.numpy()[0].argmax()) == tok
    step_tokens = np.zeros(MAX_BATCH, np.int32)
    for step in range(5):
        n = 10 + step
        if (n - 1) // BS >= len(blocks):
            blocks = blocks + [11]
        page = _page(n, blocks)
        step_tokens[1] = tok
        jd, jcache = jm.decode_step_paged(
            jparams, jcache, jnp.asarray(step_tokens),
            {k: jnp.asarray(v) for k, v in page.items()})
        pd, _ = pm.decode_step_paged(pparams, pcache, _t(step_tokens),
                                     {k: _t(v) for k, v in page.items()})
        a, b = np.asarray(jd)[1], pd.numpy()[1]
        np.testing.assert_allclose(b, a, atol=LOGIT_TOL, rtol=LOGIT_TOL)
        tok = int(np.argmax(a))
        assert int(np.argmax(b)) == tok
    for p, j in zip(cache_ops.cache_leaves(pcache),
                    jax.tree_util.tree_leaves(jcache)):
        np.testing.assert_allclose(p.numpy(), np.asarray(j),
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL)
    # the idle slot's states moved too: a decode step advances every slot
    assert pcache["periods"]["ssm"]["ssm"][:, :, 0].abs().sum() > 0


def test_megakernel_decode_never_runs_the_megastep(models, monkeypatch):
    """``decode_impl="megakernel"`` sends only attention+MoE blocks to the
    megastep; the period's attention sublayer carries a dense FFN, so the
    step is the composed one, bit for bit."""
    import dataclasses
    _, _, pm, pparams = models
    mega = Model(dataclasses.replace(pm.cfg, decode_impl="megakernel"),
                 device="cpu")

    def refuse(*args, **kwargs):
        raise AssertionError("the megastep ran in a hybrid period")
    monkeypatch.setattr(ops, "decode_megastep", refuse)
    page = {k: _t(v) for k, v in _page(10, [3, 0, 5]).items()}
    token = torch.tensor([4, 9])
    outs = []
    for model in (pm, mega):
        cache = model.init_paged_cache(MAX_BATCH, NUM_BLOCKS, BS)
        gen = torch.Generator().manual_seed(2)
        for leaf in cache_ops.cache_leaves(cache):
            leaf.normal_(generator=gen)
        outs.append(model.decode_step_paged(pparams, cache, token, page)[0])
    assert torch.equal(outs[0], outs[1])


# -- the scan rates, per (group, sublayer) -------------------------------------------

def test_ssm_rates_cached_per_sublayer():
    """A = -exp(A_log) is kept per (group, sublayer): computed again only
    for the sublayer whose ``A_log`` was written in place or replaced."""
    pm = Model(get_smoke_config(ARCH), device="cpu")
    params = pm.init(3)
    subs = [sub for sub, mixer, _ in SUBLAYERS if mixer == "mamba"]
    first = {sub: pm.ssm_rates(params, "periods", sub) for sub in subs}
    assert len(first) == 7
    for sub in subs:
        assert pm.ssm_rates(params, "periods", sub) is first[sub]
        torch.testing.assert_close(
            first[sub],
            pt_mamba.ssm_A(params["periods"][sub]["mixer"]["A_log"]),
            rtol=0, atol=0)
    params["periods"]["sub_3"]["mixer"]["A_log"].add_(0.25)
    again = {sub: pm.ssm_rates(params, "periods", sub) for sub in subs}
    for sub in subs:
        assert (again[sub] is first[sub]) == (sub != "sub_3")
    torch.testing.assert_close(
        again["sub_3"],
        pt_mamba.ssm_A(params["periods"]["sub_3"]["mixer"]["A_log"]),
        rtol=0, atol=0)
    assert not torch.equal(again["sub_3"], first["sub_3"])
    params["periods"]["sub_5"]["mixer"]["A_log"] = \
        params["periods"]["sub_5"]["mixer"]["A_log"].clone()
    assert pm.ssm_rates(params, "periods", "sub_5") is not first["sub_5"]
    assert pm.ssm_rates(params, "periods", "sub_6") is first["sub_6"]


# -- recovery's cache operations over pools and states ---------------------------------

def _random_cache(pm, seed):
    cache = pm.init_paged_cache(MAX_BATCH, NUM_BLOCKS, BS)
    gen = torch.Generator().manual_seed(seed)
    for leaf in cache_ops.cache_leaves(cache):
        leaf.normal_(generator=gen)
    return cache


def test_gather_scatter_request_round_trip(models):
    """One hybrid request's blocks and all seven of its slot's states
    streamed from one cache into another (another slot, other block
    ids), bitwise; nothing else of the target moves."""
    _, _, pm, _ = models
    axes = cache_ops.infer_paged_axes(pm, NUM_BLOCKS, BS)
    src = _random_cache(pm, 0)
    pool_blocks, state = cache_ops.gather_request_blocks(src, axes,
                                                         [3, 0, 5], 1)
    assert [None if b is None else tuple(b.shape) for b in pool_blocks] == \
        [(1, 3, BS, 2, 64), (1, 3, BS, 2, 64), None, None]
    assert [None if s is None else tuple(s.shape) for s in state] == \
        [None, None, (1, 7, 1, 4, 512), (1, 7, 1, 512, 16)]
    dst = _random_cache(pm, 1)
    before = cache_ops.clone_cache(dst)
    cache_ops.scatter_request_blocks(dst, axes, pool_blocks, state,
                                     [7, 8, 9], 0)
    back_blocks, back_state = cache_ops.gather_request_blocks(
        dst, axes, [7, 8, 9], 0)
    for a, b in zip(pool_blocks + state, back_blocks + back_state):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b)
    others = [b for b in range(NUM_BLOCKS + 1) if b not in (7, 8, 9)]
    for name in ("k", "v"):
        assert torch.equal(dst["periods"]["attn"][name][:, others],
                           before["periods"]["attn"][name][:, others])
    for name in ("conv", "ssm"):
        assert torch.equal(dst["periods"]["ssm"][name][:, :, 1],
                           before["periods"]["ssm"][name][:, :, 1])


def test_capture_step_restore_pools_and_states(models):
    """§3.3 undo on a hybrid cache: capture the step's pool write set
    (and the state leaves whole), run a decode step, restore: bitwise the
    cache before the step, pools and all seven states."""
    _, _, pm, pparams = models
    axes = cache_ops.infer_paged_axes(pm, NUM_BLOCKS, BS)
    cache = _random_cache(pm, 4)
    before = cache_ops.clone_cache(cache)
    page = _page(10, [3, 0, 5])
    undo = cache_ops.capture_pool_rows(cache, axes, page["write_bid"],
                                       page["write_off"])
    pm.decode_step_paged(pparams, cache, torch.tensor([4, 9]),
                         {k: _t(v) for k, v in page.items()})
    for name in ("conv", "ssm"):
        assert not torch.equal(cache["periods"]["ssm"][name],
                               before["periods"]["ssm"][name])
    assert not torch.equal(cache["periods"]["attn"]["k"],
                           before["periods"]["attn"]["k"])
    cache_ops.restore_pool_rows(cache, axes, undo)
    for a, b in zip(cache_ops.cache_leaves(cache),
                    cache_ops.cache_leaves(before)):
        assert torch.equal(a, b)
