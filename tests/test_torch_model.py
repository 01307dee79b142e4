"""The port's model, cache ops, checkpoint and expert map against the JAX
package, on the ``qwen2-moe-a2.7b`` smoke config and its
``sliding_window=6`` variant.

One JAX-initialised parameter set goes through the checkpoint
carry-across function into the port; one chunk step and two decode steps
then run through both ``decode_step_paged``s on the same paging arrays.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core.expert_map import ExpertMap as JaxExpertMap
from repro.models.model import Model as JaxModel
from repro.serving import cache_ops as jax_cache_ops
from repro.serving import weights_util as jax_weights_util
from repro.training.checkpoint import _flatten, save_checkpoint as jax_save
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.expert_map import ExpertMap
from repro_torch.core.graph_cache import GraphCache
from repro_torch.models.model import Model
from repro_torch.serving import cache_ops, weights_util
from repro_torch.training import checkpoint as ckpt

BS, NUM_BLOCKS = 4, 12          # pools hold one more: the trash block
MAX_BLK = 4
TRASH = NUM_BLOCKS


def _windowed(cfg):
    return dataclasses.replace(cfg, sliding_window=6)


def _configs(windowed: bool, moe_impl: str):
    jx = jax_smoke_config("qwen2-moe-a2.7b")
    pt = get_smoke_config("qwen2-moe-a2.7b")
    if windowed:
        jx, pt = _windowed(jx), _windowed(pt)
    return (dataclasses.replace(jx, moe_impl=moe_impl),
            dataclasses.replace(pt, moe_impl=moe_impl))


@pytest.fixture(scope="module")
def jax_params():
    cfg = jax_smoke_config("qwen2-moe-a2.7b")
    return JaxModel(cfg).init(jax.random.PRNGKey(3))


def _port_params(jax_params):
    flat = _flatten(jax_params)
    return ckpt.params_from_flat(flat.items(), {}, dtype=torch.float32,
                                 device="cpu")


def _steps(vocab: int):
    """Paging arrays of one chunk step (request A: prompt positions 0..8
    in blocks 0-2; request B: 0..4 in blocks 3-4; idle rows) and two
    decode steps (slots 0 and 2 live, 1 and 3 idle)."""
    rng = np.random.default_rng(7)
    a_blocks, b_blocks = [0, 1, 2], [3, 4]
    W = 16
    tokens = np.zeros(W, np.int32)
    tables = np.zeros((W, MAX_BLK), np.int32)
    seq_lens = np.zeros(W, np.int32)
    wbid = np.full(W, TRASH, np.int32)
    woff = np.zeros(W, np.int32)
    prompts = {"a": rng.integers(0, vocab, 9), "b": rng.integers(0, vocab, 5)}
    row = 0
    for name, blocks in (("a", a_blocks), ("b", b_blocks)):
        for pos, tok in enumerate(prompts[name]):
            tokens[row] = tok
            tables[row, :len(blocks)] = blocks
            seq_lens[row] = pos + 1
            wbid[row] = blocks[pos // BS]
            woff[row] = pos % BS
            row += 1
    chunk = (tokens, dict(tables=tables, seq_lens=seq_lens, write_bid=wbid,
                          write_off=woff))
    decodes = []
    for i in range(2):
        t = np.zeros((4, MAX_BLK), np.int32)
        sl = np.zeros(4, np.int32)
        wb = np.full(4, TRASH, np.int32)
        wo = np.zeros(4, np.int32)
        for slot, blocks, plen in ((0, a_blocks, 9), (2, b_blocks, 5)):
            pos = plen + i
            t[slot, :len(blocks)] = blocks
            sl[slot] = pos + 1
            wb[slot] = blocks[pos // BS]
            wo[slot] = pos % BS
        decodes.append(dict(tables=t, seq_lens=sl, write_bid=wb,
                            write_off=wo))
    return chunk, decodes, (row - 1, 8)   # last prompt rows of A and B


@pytest.mark.parametrize("moe_impl", ["gather_psum", "fused"])
@pytest.mark.parametrize("windowed", [False, True],
                         ids=["full", "window6"])
def test_decode_step_paged_matches_jax(jax_params, windowed, moe_impl):
    jcfg, pcfg = _configs(windowed, moe_impl)
    jm, pm = JaxModel(jcfg), Model(pcfg, device="cpu")
    pp = _port_params(jax_params)
    jcache = jm.init_paged_cache(4, NUM_BLOCKS, BS)
    pcache = pm.init_paged_cache(4, NUM_BLOCKS, BS)
    (ctoks, cpage), decodes, (last_a, last_b) = _steps(jcfg.vocab_size)

    def both(tokens, page):
        nonlocal jcache
        jl, jcache = jm.decode_step_paged(
            jax_params, jcache, jnp.asarray(tokens),
            {k: jnp.asarray(v) for k, v in page.items()})
        pl, _ = pm.decode_step_paged(
            pp, pcache, torch.from_numpy(tokens),
            {k: torch.from_numpy(v) for k, v in page.items()})
        jl, pl = np.asarray(jl), pl.numpy()
        np.testing.assert_allclose(pl, jl, atol=1e-4, rtol=0)
        return jl, pl

    jl, pl = both(ctoks, cpage)
    rows = [last_b, last_a]
    nxt = np.zeros(4, np.int32)
    nxt[[2, 0]] = jl[rows].argmax(-1)
    np.testing.assert_array_equal(pl[rows].argmax(-1), jl[rows].argmax(-1))
    for page in decodes:
        jl, pl = both(nxt, page)
        np.testing.assert_array_equal(pl[[0, 2]].argmax(-1),
                                      jl[[0, 2]].argmax(-1))
        nxt[[0, 2]] = jl[[0, 2]].argmax(-1)
    # updated pools agree (the trash block is scratch: rows of idle
    # slots land there in unspecified order)
    for key in ("k", "v"):
        np.testing.assert_allclose(
            pcache["layers"][key][:, :TRASH].numpy(),
            np.asarray(jcache["layers"][key])[:, :TRASH], atol=1e-5, rtol=0)


def test_capture_step_restore_is_bit_exact(jax_params):
    _, pcfg = _configs(False, "fused")
    pm = Model(pcfg, device="cpu")
    pp = _port_params(jax_params)
    cache = pm.init_paged_cache(4, NUM_BLOCKS, BS)
    axes = cache_ops.infer_paged_axes(pm, NUM_BLOCKS, BS)
    assert axes == [None, None]
    (toks, page), decodes, _ = _steps(pcfg.vocab_size)
    to_t = lambda p: {k: torch.from_numpy(v) for k, v in p.items()}
    pm.decode_step_paged(pp, cache, torch.from_numpy(toks), to_t(page))
    before = cache_ops.clone_cache(cache)
    d = decodes[0]
    undo = cache_ops.capture_pool_rows(cache, axes, d["write_bid"],
                                       d["write_off"])
    pm.decode_step_paged(pp, cache, torch.zeros(4, dtype=torch.int32),
                         to_t(d))
    assert not torch.equal(cache["layers"]["k"], before["layers"]["k"])
    cache_ops.restore_pool_rows(cache, axes, undo)
    for key in ("k", "v"):
        assert torch.equal(cache["layers"][key], before["layers"][key])


def test_copy_block_prefixes_matches_jax():
    rng = np.random.default_rng(11)
    pool = rng.normal(size=(2, 6, 4, 2, 8)).astype(np.float32)
    copies = [(0, 3, 2), (1, 4, 4), (5, 2, 1)]
    jcache = {"layers": {"k": jnp.asarray(pool), "v": jnp.asarray(pool * 2)}}
    pcache = {"layers": {"k": torch.from_numpy(pool.copy()),
                         "v": torch.from_numpy(pool * 2)}}
    want = jax_cache_ops.copy_block_prefixes(jcache, [None, None], copies)
    got = cache_ops.copy_block_prefixes(pcache, [None, None], copies)
    for key in ("k", "v"):
        np.testing.assert_array_equal(got["layers"][key].numpy(),
                                      np.asarray(want["layers"][key]))


@pytest.mark.parametrize("ep,ops", [
    (2, [("fail", 1), ("mask",)]),
    (2, [("fail", 0)]),
    (2, [("fail", 1), ("mask",), ("install", 1)]),
    (2, [("fail", 1), ("mask",), ("fail", 0), ("mask",)]),
])
@pytest.mark.parametrize("full", [False, True], ids=["smoke", "full"])
def test_expert_map_runtime_matches_jax(ep, ops, full):
    from repro.configs import get_config as jax_get_config
    if full:
        pm, jm = get_config("qwen2-moe-a2.7b").moe, \
            jax_get_config("qwen2-moe-a2.7b").moe
    else:
        pm = dataclasses.replace(get_smoke_config("qwen2-moe-a2.7b").moe,
                                 num_redundant_experts=2)
        jm = dataclasses.replace(jax_smoke_config("qwen2-moe-a2.7b").moe,
                                 num_redundant_experts=2)
    a, b = ExpertMap(pm, ep, device="cpu"), JaxExpertMap(jm, ep)
    for op in ops:
        for m in (a, b):
            if op[0] == "fail":
                m.fail_rank(op[1])
            elif op[0] == "install":
                m.install_rank(op[1])
            else:
                m.mask_experts(m.fully_lost())
        for x, y in zip(a.runtime(), b.runtime()):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    assert a.coverage() == b.coverage()


def test_checkpoint_carries_jax_weights_across(tmp_path, jax_params):
    path = str(tmp_path / "weights.npz")
    jax_save(path, jax_params)
    got = ckpt.load_params(path, dtype=torch.float32, device="cpu")
    flat = _flatten(jax_params)
    mine = dict(ckpt.flatten(got))
    assert sorted(mine) == sorted(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(mine[k].numpy(), np.asarray(v))


def test_checkpoint_bf16_round_trip(tmp_path):
    pm = Model(get_smoke_config("qwen2-moe-a2.7b"), torch.bfloat16,
               device="cpu")
    params = pm.init(5)
    path = str(tmp_path / "w.npz")
    ckpt.save_checkpoint(path, params)
    arrays, tags = ckpt.load_flat(path)
    assert set(tags.values()) == {"bfloat16"}
    assert all(a.dtype == np.uint16 for a in arrays.values())
    back = ckpt.load_params(path, dtype=torch.bfloat16, device="cpu")
    for (k1, a), (k2, b) in zip(ckpt.flatten(params), ckpt.flatten(back)):
        assert k1 == k2 and torch.equal(a, b)


def test_weights_util_matches_jax(jax_params):
    pp = _port_params(jax_params)
    shards = weights_util.split_experts(pp, 2)
    _, jshards = jax_weights_util.split_experts(jax_params, 2)
    for s, js in zip(shards, jshards):
        assert sorted(s) == sorted(js)
        for k in s:
            np.testing.assert_array_equal(s[k].numpy(), js[k])
    want = jax_weights_util.expert_checksums([jshards[0], None])
    got = weights_util.expert_checksums(pp, [True, False])
    assert np.isnan(got[1]) and np.isnan(want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    # a dead rank's slice is zeroed in place; a returning one restored
    # from its owner's shard (the host copies are copies, not views of the
    # bank); a new owner's shard is copied in over a live slice
    key = "layers/moe/gate"
    resident = weights_util.assemble(pp, [shards[0], None], list(shards))
    assert resident[0] is shards[0] and resident[1] is None
    bank = dict(ckpt.flatten(pp))[key]
    assert not bank[:, 3:].any() and torch.equal(bank[:, :3], shards[0][key])
    assert shards[1][key].any()
    resident = weights_util.assemble(pp, shards, resident)
    assert torch.equal(bank[:, 3:], shards[1][key])
    reloaded = {k: v * 2 for k, v in shards[1].items()}
    weights_util.assemble(pp, [shards[0], reloaded], resident)
    assert torch.equal(bank[:, 3:], reloaded[key])
    assert torch.equal(bank[:, :3], shards[0][key])


def test_graph_cache_tiers():
    gc = GraphCache(persist_dir=None)
    tm = gc.precompile(("decode", 2, None), len)
    assert tm.source == "precompiled" and ("decode", 2, None) in gc
    fn, hit = gc.get_or_compile(("decode", 2, None), None)
    assert fn is len and hit.source == "precompiled"
    _, miss = gc.get_or_compile(("chunk", 1, None), abs)
    assert miss.source == "cold"
    _, cached = GraphCache("/nonexistent").get_or_compile(("x",), abs)
    assert cached.source == "cached"
    assert gc.invalidate(lambda k: k[0] == "decode") == 1


@pytest.mark.parametrize("writer", ["port", "np.savez", "np.savez_compressed"])
def test_load_params_reads_each_writer(tmp_path, writer):
    """``load_params`` reads an uncompressed file at each array's offset
    and a compressed one through ``np.load``: both give every leaf, its
    shape, type and bits (a bf16 leaf from its tag, a Fortran-ordered
    array in C order)."""
    rng = np.random.default_rng(4)
    flat = {"a/b": rng.normal(size=(3, 5)).astype(np.float32),
            "a/c": np.asfortranarray(rng.normal(size=(4, 2))
                                     .astype(np.float32)),
            "d": np.arange(7, dtype=np.int32),
            "e": np.zeros((0, 3), np.float32)}
    path = str(tmp_path / "w.npz")
    bf = torch.from_numpy(rng.normal(size=(2, 6)).astype(np.float32)).to(
        torch.bfloat16)
    if writer == "port":
        ckpt.save_flat(path, [*((k, torch.from_numpy(np.ascontiguousarray(v)))
                                for k, v in flat.items()), ("g", bf)])
    else:
        getattr(np, writer.split(".")[1])(path, **flat)
    got = dict(ckpt.flatten(ckpt.load_params(path, dtype=torch.float32,
                                             device="cpu")))
    for k, v in flat.items():
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), v.astype(np.float32))
    if writer == "port":
        assert torch.equal(got["g"], bf.float())
