"""The port's whole-prompt prefill path against the JAX package, on the CPU:
the plain versions of the two kernels it runs (``expert_ffn``,
``flash_prefill``) against the JAX oracles and the Pallas kernels in
interpret mode, the model's chunked ``flash_attention``,
``Model.prefill_paged`` on the ``qwen2-moe-a2.7b`` smoke config (and its
``sliding_window=6`` variant) and ``install_prefill`` with the §3.3 row
undo.  Inputs come from ``np.random.default_rng`` and go to both packages;
weights are JAX-initialised and carried across by the checkpoint loader.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.kernels import ref
from repro.kernels.expert_ffn import expert_ffn_pallas
from repro.kernels.flash_prefill import flash_prefill_pallas
from repro.models import attention as jax_attention
from repro.models.model import Model as JaxModel
from repro.serving import cache_ops as jax_cache_ops
from repro.serving.kvcache import padded_block_ids
from repro.training.checkpoint import _flatten
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import ops
from repro_torch.kernels.expert_ffn import expert_ffn_plain
from repro_torch.kernels.flash_prefill import flash_prefill_plain
from repro_torch.models import attention as pt_attention
from repro_torch.models.model import Model
from repro_torch.serving import cache_ops
from repro_torch.serving.executor import next_bucket
from repro_torch.training import checkpoint as ckpt
from test_torch_cases import t as _t
from test_torch_cases import one_torch_thread  # noqa: F401

# tests/test_kernels.py:52 and :237 — kernel vs oracle tolerances
FFN_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
ATTN_TOL = 2e-4
BS, NUM_BLOCKS = 4, 12           # pools hold one more: the trash block
TRASH = NUM_BLOCKS


def _to_jax(a, dtype):
    return jnp.asarray(a).astype(jnp.bfloat16 if dtype == "bfloat16"
                                 else jnp.float32)


def _to_torch(a, dtype):
    return _t(a).to(getattr(torch, dtype))


# -- expert_ffn ---------------------------------------------------------------

@pytest.mark.parametrize("E,C,D,F", [(2, 64, 128, 256), (3, 100, 256, 384),
                                     (8, 128, 512, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_expert_ffn_plain_vs_jax(E, C, D, F, dtype):
    rng = np.random.default_rng(E * C)
    x = (rng.normal(size=(E, C, D)) * 0.1).astype(np.float32)
    g, u = ((rng.normal(size=(E, D, F)) * 0.05).astype(np.float32)
            for _ in range(2))
    d = (rng.normal(size=(E, F, D)) * 0.05).astype(np.float32)
    jargs = [_to_jax(a, dtype) for a in (x, g, u, d)]
    got = expert_ffn_plain(*(_to_torch(a, dtype) for a in (x, g, u, d)))
    assert got.dtype == getattr(torch, dtype) and got.shape == (E, C, D)
    tol = FFN_TOL[dtype]
    for want in (ref.expert_ffn_ref(*jargs),
                 expert_ffn_pallas(*jargs, interpret=True)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), rtol=tol,
                                   atol=tol)


def test_experts_compute_goes_through_ops():
    """The dense-scatter MoE's expert FFN is ``ops.expert_ffn``: on CPU
    tensors its plain version, bit for bit."""
    from repro_torch.models.moe import experts_compute
    rng = np.random.default_rng(4)
    x = _t(rng.normal(size=(3, 5, 16)).astype(np.float32))
    g, u = (_t(rng.normal(size=(3, 16, 24)).astype(np.float32))
            for _ in range(2))
    d = _t(rng.normal(size=(3, 24, 16)).astype(np.float32))
    assert torch.equal(experts_compute(g, u, d, x),
                       expert_ffn_plain(x, g, u, d))
    assert torch.equal(ops.expert_ffn(x, g, u, d),
                       expert_ffn_plain(x, g, u, d))


# -- flash_prefill --------------------------------------------------------------

def _qkv(B, S, H, Hkv, Dh, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, S, H, Dh)).astype(np.float32),
            rng.normal(size=(B, S, Hkv, Dh)).astype(np.float32),
            rng.normal(size=(B, S, Hkv, Dh)).astype(np.float32))


@pytest.mark.parametrize("B,S,H,Hkv,Dh,bq,bk", [
    (1, 128, 4, 4, 64, 64, 64),    # MHA
    (2, 128, 8, 2, 64, 32, 64),    # GQA, bq != bk
    (1, 256, 16, 8, 128, 128, 128),
])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_prefill_plain_vs_jax(B, S, H, Hkv, Dh, bq, bk, causal):
    q, k, v = _qkv(B, S, H, Hkv, Dh, S * H + causal)
    got = flash_prefill_plain(_t(q), _t(k), _t(v), causal=causal).numpy()
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    for want in (ref.flash_prefill_ref(jq, jk, jv, causal),
                 flash_prefill_pallas(jq, jk, jv, causal=causal, block_q=bq,
                                      block_k=bk, interpret=True)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=ATTN_TOL,
                                   atol=ATTN_TOL)


@pytest.mark.parametrize("S", [16, 24, 64])
@pytest.mark.parametrize("window", [0, 6], ids=["causal", "window6"])
@pytest.mark.parametrize("chunks", [(2048, 1024), (8, 8)],
                         ids=["one_chunk", "chunked"])
def test_flash_attention_matches_jax(S, window, chunks):
    """The port's flash_attention (the chunked online softmax on the CPU)
    and the plain flash_prefill version with the same positions and
    window, against ``repro.models.attention.flash_attention``."""
    q_chunk, kv_chunk = chunks
    q, k, v = _qkv(2, S, 8, 2, 32, S + window)
    pos = np.arange(S, dtype=np.int32)
    want = np.asarray(jax_attention.flash_attention(
        *map(jnp.asarray, (q, k, v, pos, pos)), causal=True, window=window,
        q_chunk=q_chunk, kv_chunk=kv_chunk))
    got = pt_attention.flash_attention(
        *map(_t, (q, k, v, pos, pos)), causal=True, window=window,
        q_chunk=q_chunk, kv_chunk=kv_chunk)
    np.testing.assert_allclose(got.numpy(), want, rtol=ATTN_TOL,
                               atol=ATTN_TOL)
    plain = ops.flash_prefill(*map(_t, (q, k, v, pos, pos)), causal=True,
                              window=window)
    np.testing.assert_allclose(plain.numpy(), want, rtol=ATTN_TOL,
                               atol=ATTN_TOL)


def test_flash_prefill_plain_row_without_keys_is_zero():
    """Positions that leave a query no visible key (its keys all lie in
    its future) give 0, as the kernel does."""
    q, k, v = _qkv(1, 8, 4, 2, 16, 0)
    qpos = torch.arange(8, dtype=torch.int32)
    kvpos = qpos + 3
    out = flash_prefill_plain(_t(q), _t(k), _t(v), qpos, kvpos)
    assert not out[0, :3].any() and out[0, 3:].abs().sum() > 0


# -- Model.prefill_paged ----------------------------------------------------------

@pytest.fixture(scope="module")
def jax_params():
    cfg = jax_smoke_config("qwen2-moe-a2.7b")
    return JaxModel(cfg).init(jax.random.PRNGKey(3))


def _port_params(jax_params):
    return ckpt.params_from_flat(_flatten(jax_params).items(), {},
                                 dtype=torch.float32, device="cpu")


def _models(windowed: bool, moe_impl: str):
    jx = jax_smoke_config("qwen2-moe-a2.7b")
    pt = get_smoke_config("qwen2-moe-a2.7b")
    if windowed:
        jx = dataclasses.replace(jx, sliding_window=6)
        pt = dataclasses.replace(pt, sliding_window=6)
    return (JaxModel(dataclasses.replace(jx, moe_impl=moe_impl)),
            Model(dataclasses.replace(pt, moe_impl=moe_impl), device="cpu"))


def _prompt(vocab: int, n: int = 11):
    """An ``n``-token prompt padded to its bucket, as the executor pads."""
    toks = np.random.default_rng(n).integers(0, vocab, n)
    padded = np.zeros((1, next_bucket(n, 64)), np.int32)
    padded[0, :n] = toks
    return padded, np.asarray([n], np.int32)


def _prefill_both(jm, pm, jax_params, pp, n=11):
    tokens, lengths = _prompt(jm.cfg.vocab_size, n)
    jl, jraw = jm.prefill_paged(jax_params, {"tokens": jnp.asarray(tokens),
                                             "lengths": jnp.asarray(lengths)})
    pl, praw = pm.prefill_paged(pp, {"tokens": _t(tokens),
                                     "lengths": _t(lengths)})
    return (np.asarray(jl), jraw), (pl.numpy(), praw), tokens.shape[1]


@pytest.mark.parametrize("moe_impl", ["gather_psum", "fused"])
@pytest.mark.parametrize("windowed", [False, True], ids=["full", "window6"])
def test_prefill_paged_matches_jax(jax_params, windowed, moe_impl):
    jm, pm = _models(windowed, moe_impl)
    (jl, jraw), (pl, praw), S = _prefill_both(jm, pm, jax_params,
                                              _port_params(jax_params))
    assert pl.shape == jl.shape == (1, pm.vpad)
    np.testing.assert_allclose(pl, jl, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(pl.argmax(-1), jl.argmax(-1))
    assert sorted(praw) == sorted(jraw) == ["layers"]
    for key in ("k", "v"):
        want = np.asarray(jraw["layers"][key])
        got = praw["layers"][key].numpy()
        assert got.shape == want.shape == (pm.cfg.num_layers, 1, S,
                                           pm.cfg.num_kv_heads,
                                           pm.cfg.resolved_head_dim())
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def _decode_page(blocks, n):
    """Slot 0 decodes position ``n`` of the prefilled request; slots 1-3
    are idle (trash block)."""
    t = np.zeros((4, 4), np.int32)
    t[0, :len(blocks)] = blocks
    sl = np.zeros(4, np.int32)
    sl[0] = n + 1
    wb = np.full(4, TRASH, np.int32)
    wb[0] = blocks[n // BS]
    wo = np.zeros(4, np.int32)
    wo[0] = n % BS
    return dict(tables=t, seq_lens=sl, write_bid=wb, write_off=wo)


@pytest.mark.parametrize("moe_impl", ["gather_psum", "fused"])
def test_install_prefill_then_decode_matches_jax(jax_params, moe_impl):
    jm, pm = _models(False, moe_impl)
    pp = _port_params(jax_params)
    (jl, jraw), (pl, praw), S = _prefill_both(jm, pm, jax_params, pp)
    n = 11
    blocks = [5, 2, 7]                   # 11 tokens need 3 blocks of 4
    bids = padded_block_ids(blocks, S // BS, TRASH)
    assert list(bids) == [5, 2, 7, TRASH]
    jcache = jm.init_paged_cache(4, NUM_BLOCKS, BS)
    _, jaxes = jax_cache_ops.infer_paged_axes(jm, NUM_BLOCKS, BS)
    jcache = jax_cache_ops.install_prefill(jcache, jraw, jaxes,
                                           jnp.asarray(bids), 0)
    pcache = pm.init_paged_cache(4, NUM_BLOCKS, BS)
    paxes = cache_ops.infer_paged_axes(pm, NUM_BLOCKS, BS)
    cache_ops.install_prefill(pcache, praw, paxes, bids, 0)
    tok = np.zeros(4, np.int32)
    tok[0] = jl.argmax(-1)[0]
    page = _decode_page(blocks, n)
    jdl, jcache = jm.decode_step_paged(
        jax_params, jcache, jnp.asarray(tok),
        {k: jnp.asarray(v) for k, v in page.items()})
    pdl, _ = pm.decode_step_paged(pp, pcache, _t(tok),
                                  {k: _t(v) for k, v in page.items()})
    np.testing.assert_allclose(pdl.numpy()[0], np.asarray(jdl)[0],
                               atol=1e-4, rtol=0)
    assert pdl.numpy()[0].argmax() == np.asarray(jdl)[0].argmax()
    # the pools agree outside the trash block (scratch: idle decode rows
    # and the install's padded tail land there)
    for key in ("k", "v"):
        np.testing.assert_allclose(
            pcache["layers"][key][:, :TRASH].numpy(),
            np.asarray(jcache["layers"][key])[:, :TRASH], atol=1e-5, rtol=0)


def test_install_prefill_trash_writes_are_deterministic():
    """Repeated trash ids: only the last repeat is written, so the trash
    block holds the bucket's last padded block on every device."""
    rng = np.random.default_rng(2)
    raw = {"layers": {key: _t(rng.normal(size=(2, 1, 16, 3, 4))
                              .astype(np.float32)) for key in ("k", "v")}}
    cache = {"layers": {key: torch.zeros((2, 7, 4, 3, 4))
                        for key in ("k", "v")}}
    bids = padded_block_ids([4, 1], 4, 6)          # [4, 1, 6, 6]
    cache_ops.install_prefill(cache, raw, [None, None], bids, 0)
    for key in ("k", "v"):
        c, r = cache["layers"][key], raw["layers"][key][:, 0]
        assert torch.equal(c[:, 4], r[:, 0:4])
        assert torch.equal(c[:, 1], r[:, 4:8])
        assert torch.equal(c[:, 6], r[:, 12:16])
        assert not c[:, [0, 2, 3, 5]].any()


def test_capture_prefill_install_restore_is_bit_exact(jax_params):
    """The executor's manifest for an install (every row of every padded
    block, trash repeats included) rolls the install back bit for bit."""
    jm, pm = _models(False, "gather_psum")
    pp = _port_params(jax_params)
    tokens, lengths = _prompt(pm.cfg.vocab_size)
    _, raw = pm.prefill_paged(pp, {"tokens": _t(tokens),
                                   "lengths": _t(lengths)})
    cache = pm.init_paged_cache(4, NUM_BLOCKS, BS)
    axes = cache_ops.infer_paged_axes(pm, NUM_BLOCKS, BS)
    gen = torch.Generator().manual_seed(0)
    for key in ("k", "v"):             # a used pool, not zeros
        cache["layers"][key].normal_(generator=gen)
    before = cache_ops.clone_cache(cache)
    bids = padded_block_ids([5, 2, 7], tokens.shape[1] // BS, TRASH)
    undo = cache_ops.capture_pool_rows(
        cache, axes, np.repeat(bids, BS), np.tile(np.arange(BS), len(bids)))
    cache_ops.install_prefill(cache, raw, axes, bids, 0)
    assert not torch.equal(cache["layers"]["k"], before["layers"]["k"])
    cache_ops.restore_pool_rows(cache, axes, undo)
    for key in ("k", "v"):
        assert torch.equal(cache["layers"][key], before["layers"][key])
