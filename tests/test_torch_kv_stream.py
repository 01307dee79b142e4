"""KV-block streaming (§3.2; the role switch's path, §3.4) in the port.

- ``cache_ops.gather_request_blocks`` / ``scatter_request_blocks`` against
  ``repro``'s on the same cache (numpy from a seed), for every cache
  layout the port serves: GQA pools (``qwen2-moe-a2.7b``), MLA's latent
  pool (``deepseek-v3``), Mamba state leaves (``falcon-mamba-7b``) and a
  hybrid period's pools and stack of seven Mamba states in one entry
  (``jamba-1.5-large-398b``).
  The payloads and the caches after the install must be equal exactly.
- ``DPExecutor.export_kv_blocks`` → ``import_kv_blocks`` between two port
  executors: the request's next decode logits on the target equal the
  donor's, also with a sliding window whose released blocks ship as
  trash sentinels; the payload matches ``repro``'s export of the same
  served state (f32, 1e-5: two packages computed the K/V).
- ``import_kv_blocks`` refuses without a free batch slot or enough free
  blocks, as ``repro``'s does, and leaves the target as it was.
"""
import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models.model import Model as JaxModel
from repro.serving import cache_ops as jax_cache_ops
from repro.serving.engine import EngineConfig as JaxEngineConfig
from repro.serving.engine import InferenceEngine as JaxEngine
from repro_torch.configs import get_smoke_config
from repro_torch.models.model import Model
from repro_torch.serving import cache_ops
from repro_torch.serving.engine import EngineConfig, InferenceEngine
from repro_torch.serving.kvcache import build_page_context

ARCHES = ("qwen2-moe-a2.7b", "deepseek-v3", "falcon-mamba-7b",
          "jamba-1.5-large-398b")
BATCH, NUM_BLOCKS, BS = 3, 12, 4
PAYLOAD_TOL = 1e-5


def _caches(arch, seed=0):
    """The same random paged cache in both packages, and the port's
    per-leaf axes (checked against repro's)."""
    jm = JaxModel(jax_smoke_config(arch))
    pm = Model(get_smoke_config(arch), torch.float32, "cpu")
    jleaves, treedef = jax.tree_util.tree_flatten(
        jm.init_paged_cache(BATCH, NUM_BLOCKS, BS))
    pcache = pm.init_paged_cache(BATCH, NUM_BLOCKS, BS)
    pleaves = cache_ops.cache_leaves(pcache)
    assert [tuple(a.shape) for a in jleaves] == \
        [tuple(t.shape) for t in pleaves]
    rng = np.random.default_rng(seed)
    vals = [rng.normal(size=a.shape).astype(np.float32) for a in jleaves]
    for t, v in zip(pleaves, vals):
        t.copy_(torch.from_numpy(v))
    jcache = jax.tree_util.tree_unflatten(treedef,
                                          [jnp.asarray(v) for v in vals])
    axes = cache_ops.infer_paged_axes(pm, NUM_BLOCKS, BS)
    assert axes == jax_cache_ops.infer_paged_axes(jm, NUM_BLOCKS, BS)[1]
    return jcache, pcache, axes


def _equal_lists(port, ref):
    assert [p is None for p in port] == [r is None for r in ref]
    for p, r in zip(port, ref):
        if p is not None:
            np.testing.assert_array_equal(p.numpy(), np.asarray(r))


@pytest.mark.parametrize("arch", ARCHES)
def test_gather_matches_repro(arch):
    jcache, pcache, axes = _caches(arch)
    bids, slot = [7, 2, 9], 1
    jp, js = jax_cache_ops.gather_request_blocks(jcache, axes, bids, slot)
    pp, ps = cache_ops.gather_request_blocks(pcache, axes, bids, slot)
    _equal_lists(pp, jp)
    _equal_lists(ps, js)
    kinds = {ax is None for ax in axes}       # True: a pool leaf
    assert kinds == {"falcon-mamba-7b": {False},
                     "jamba-1.5-large-398b": {True, False}}.get(arch,
                                                                {True})
    # a copy: later writes to the cache leave the payload as it was
    before = [t.clone() for t in pp + ps if t is not None]
    for t in cache_ops.cache_leaves(pcache):
        t.zero_()
    assert all(torch.equal(a, b) for a, b in
               zip(before, [t for t in pp + ps if t is not None]))


@pytest.mark.parametrize("arch", ARCHES)
def test_scatter_matches_repro(arch):
    jcache, pcache, axes = _caches(arch)
    src_j, src_p, _ = _caches(arch, seed=1)
    pb, st = cache_ops.gather_request_blocks(src_p, axes, [1, 5], 0)
    jpb, jst = jax_cache_ops.gather_request_blocks(src_j, axes, [1, 5], 0)
    out = cache_ops.scatter_request_blocks(pcache, axes, pb, st, [10, 3], 2)
    assert out is pcache                       # in place
    ref = jax_cache_ops.scatter_request_blocks(jcache, axes, jpb, jst,
                                               [10, 3], 2)
    _equal_lists(cache_ops.cache_leaves(pcache),
                 jax.tree_util.tree_flatten(ref)[0])


def test_scatter_refuses_a_payload_on_another_device():
    _, pcache, axes = _caches("qwen2-moe-a2.7b")
    pb, st = cache_ops.gather_request_blocks(pcache, axes, [1], 0)
    pb = [p.to("meta") if p is not None else None for p in pb]
    with pytest.raises(ValueError, match="KV payload on meta"):
        cache_ops.scatter_request_blocks(pcache, axes, pb, st, [2], 0)


# -- executors --------------------------------------------------------------


def _cfg(get_smoke, window=0):
    """tests/test_chunked_prefill.py:25's qwen2-moe smoke with capacity to
    spare: no token is dropped, so a row's logits do not depend on the
    other rows of its step."""
    cfg = get_smoke("qwen2-moe-a2.7b")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, num_experts=4, num_redundant_experts=2, top_k=2,
        capacity_factor=8.0, min_capacity=64))
    return cfg.with_sliding_window(window) if window else cfg


def _common(max_batch=4, num_blocks=64):
    return dict(mode="collocated", num_dp=2, max_batch=max_batch,
                max_seq=64, block_size=8, num_blocks=num_blocks,
                moe_impl="fused")


def _port_engine(path, window=0, **over):
    cfg = _cfg(get_smoke_config, window)
    return cfg, InferenceEngine(cfg, EngineConfig(
        workdir=str(path), **_common(**over)), device="cpu")


def _prompts(vocab, lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(0, vocab, n))) for n in lengths]


def _serve_until_decoding(eng, prompts, outputs=2):
    """Submit the prompts (alternating ranks) and step until each has
    ``outputs`` tokens."""
    reqs = [eng.submit(p, 16) for p in prompts]
    for _ in range(40):
        if all(len(r.output_tokens) >= outputs for r in reqs):
            break
        eng.step()
    assert all(len(r.output_tokens) >= outputs for r in reqs)
    return reqs


def _next_logits(eng, ex, req):
    """``req``'s next decode logits on ``ex``, alone in the batch, on a
    copy of the executor's cache."""
    page = build_page_context([req], ex.scheduler.block_tables,
                              max_batch=ex.max_batch, max_blk=ex.max_blk,
                              block_size=ex.block_size,
                              trash_block=ex.trash_block)
    tokens = np.zeros((ex.max_batch,), np.int32)
    tokens[req.batch_slot] = ex.last_token[req.batch_slot]
    logits, _ = eng.model.decode_step_paged(
        eng.params, cache_ops.clone_cache(ex.cache),
        torch.from_numpy(tokens),
        {k: torch.from_numpy(v) for k, v in page.items()}, eng.runtime)
    return logits[req.batch_slot]


@pytest.mark.parametrize("window", [0, 8])
def test_round_trip_next_logits_equal(tmp_path, window):
    cfg, eng = _port_engine(tmp_path, window)
    reqs = _serve_until_decoding(eng, _prompts(cfg.vocab_size,
                                               (30, 12, 9, 10)))
    donor, target = eng.dp_executors
    req = reqs[0]
    assert req.dp_rank == donor.dp_rank
    want = _next_logits(eng, donor, req)
    kv = donor.export_kv_blocks(req)
    assert kv.valid_len == req.num_tokens - 1
    assert kv.num_blocks == -(-kv.valid_len // 8)
    assert kv.last_token == req.output_tokens[-1]
    if window:
        # blocks below the window shipped as trash sentinels, no rows
        assert not all(kv.live_mask) and kv.live_mask[-1]
    else:
        assert all(kv.live_mask)
    live = sum(kv.live_mask)
    assert all(p.shape[1] == live for p in kv.pool_blocks if p is not None)
    free = target.block_manager.num_allocatable
    assert target.import_kv_blocks(req, kv)
    table = target.scheduler.block_tables[req.req_id].blocks
    assert [b == target.trash_block for b in table[:kv.num_blocks]] == \
        [not m for m in kv.live_mask]
    assert target.block_manager.num_allocatable == free - (
        len(table) - (kv.num_blocks - live))
    assert req.dp_rank == target.dp_rank and req in target.scheduler.running
    assert target.last_token[req.batch_slot] == kv.last_token
    # the installed rows are the payload, bit for bit
    got, _ = cache_ops.gather_request_blocks(
        target.cache, target.paged_axes,
        [b for b in table[:kv.num_blocks] if b != target.trash_block],
        req.batch_slot)
    for g, p in zip(got, kv.pool_blocks):
        assert torch.equal(g, p)
    torch.testing.assert_close(_next_logits(eng, target, req), want,
                               rtol=0, atol=0)


def test_export_matches_repro(tmp_path):
    """The same served state in both packages exports the same payload:
    table span, live mask, valid length and last token exactly, the K/V
    rows within f32 tolerance."""
    jcfg = _cfg(jax_smoke_config)
    jeng = JaxEngine(jcfg, JaxEngineConfig(
        workdir=str(tmp_path / "jax"), **_common()))
    (tmp_path / "torch").mkdir()
    shutil.copy(tmp_path / "jax" / "weights.npz",
                tmp_path / "torch" / "weights.npz")
    _, peng = _port_engine(tmp_path / "torch")
    prompts = _prompts(jcfg.vocab_size, (30, 12, 9, 10))
    jreqs = _serve_until_decoding(jeng, prompts)
    preqs = _serve_until_decoding(peng, prompts)
    for jr, pr in zip(jreqs, preqs):
        assert jr.output_tokens == pr.output_tokens
        jkv = jeng.dp_executors[jr.dp_rank].export_kv_blocks(jr)
        pkv = peng.dp_executors[pr.dp_rank].export_kv_blocks(pr)
        for f in ("block_size", "num_blocks", "valid_len", "last_token",
                  "live_mask"):
            assert getattr(pkv, f) == getattr(jkv, f), f
        assert [p is None for p in pkv.pool_blocks] == \
            [p is None for p in jkv.pool_blocks]
        for p, j in zip(pkv.pool_blocks, jkv.pool_blocks):
            if p is not None:
                np.testing.assert_allclose(p.numpy(), j, rtol=PAYLOAD_TOL,
                                           atol=PAYLOAD_TOL)
        assert pkv.nbytes() == jkv.nbytes()


@pytest.mark.parametrize("short", ["slot", "blocks"])
def test_import_refuses_as_repro(tmp_path, short):
    """No free batch slot (both ranks full at max_batch=2), or too few
    free blocks (12 blocks a rank, the target's own request holds 7):
    both packages refuse, and the port's target is left as it was."""
    if short == "slot":
        over, lengths = dict(max_batch=2), (12, 9, 10, 11)
    else:
        over, lengths = dict(num_blocks=12), (40, 50)
    jcfg = _cfg(jax_smoke_config)
    jeng = JaxEngine(jcfg, JaxEngineConfig(
        workdir=str(tmp_path / "jax"), **_common(**over)))
    (tmp_path / "torch").mkdir()
    shutil.copy(tmp_path / "jax" / "weights.npz",
                tmp_path / "torch" / "weights.npz")
    _, peng = _port_engine(tmp_path / "torch", **over)
    prompts = _prompts(jcfg.vocab_size, lengths)
    results = []
    for eng in (jeng, peng):
        req = _serve_until_decoding(eng, prompts)[0]
        donor, target = eng.dp_executors
        kv = donor.export_kv_blocks(req)
        assert kv is not None
        tables = dict(target.scheduler.block_tables)
        free = target.block_manager.num_allocatable
        slots = list(target.scheduler._free_slots)
        results.append(target.import_kv_blocks(req, kv))
        assert target.scheduler.block_tables == tables
        assert target.block_manager.num_allocatable == free
        assert target.scheduler._free_slots == slots
        assert req.dp_rank == donor.dp_rank
    assert results == [False, False]
