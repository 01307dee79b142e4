"""The port's sharding rules (``distributed/sharding.py``), mesh layouts
(``launch/mesh.py``) and capacity reckoning (``collectives.cap_for``)
against the JAX package's, for all 11 archs at their full configs on
both production meshes (16 x 16 and 2 x 16 x 16).

``repro``'s rules get a stub mesh (``SimpleNamespace(shape=...,
axis_names=...)``) and, in this module only, ``NamedSharding`` patched to
return its spec, so its data and cache rules hand back bare
``PartitionSpec``s; the port's rules get ``make_production_mesh``'s
layout.  Both see the same leaves: ``repro``'s parameter shapes from
``jax.eval_shape`` of ``Model.init`` (nothing allocated; the port's own
``Model.init`` on the meta device has the same keys and shapes), its
decode caches from ``eval_shape`` of ``init_cache``, and a batch of
tokens, loss mask and the family's patches or frames.  Nothing else of
the mesh is needed, and no process group is made.
"""
import types

import jax
import numpy as np
import pytest

import repro.distributed.collectives as jax_coll
import repro.distributed.sharding as jax_sharding
from repro.configs import get_config as jax_get_config
from repro.models.model import Model as JaxModel
from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.distributed import collectives as pt_coll
from repro_torch.distributed.sharding import ShardingRules
from repro_torch.launch.mesh import MeshLayout, dp_axes, make_production_mesh
from repro_torch.models.model import MetaFactories
from repro_torch.models.model import Model
from test_torch_cases import one_torch_thread  # noqa: F401

MESHES = {"16x16": False, "2x16x16": True}
BATCHES = (1, 16, 32, 48)
CACHE_SEQS = (4096, 1000)       # the window divides 16, and does not


def _stub(layout: MeshLayout):
    return types.SimpleNamespace(
        shape=dict(zip(layout.mesh_dim_names, layout.shape)),
        axis_names=layout.mesh_dim_names)


def _keys(path):
    return tuple(jax_sharding._keys(path))


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def _nested(pairs):
    """{key path: leaf} -> the nested dict the port's rules walk."""
    out = {}
    for keys, leaf in pairs:
        d = out
        for k in keys[:-1]:
            d = d.setdefault(k, {})
        d[keys[-1]] = leaf
    return out


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, path + (k,))
    else:
        yield path, tree


@pytest.fixture(scope="module")
def param_shapes():
    """Per arch: repro's (key path, ShapeDtypeStruct) of every parameter,
    computed once."""
    kept = {}

    def get(arch):
        if arch not in kept:
            kept[arch] = [(_keys(p), leaf) for p, leaf in _leaves(
                JaxModel(jax_get_config(arch)).param_specs())]
        return kept[arch]
    return get


@pytest.fixture
def bare_specs(monkeypatch):
    monkeypatch.setattr(jax_sharding, "NamedSharding",
                        lambda mesh, spec: spec)


def test_production_layouts():
    single, multi = (make_production_mesh(multi_pod=m) for m in (False,
                                                                 True))
    assert single == MeshLayout((16, 16), ("data", "model"))
    assert multi == MeshLayout((2, 16, 16), ("pod", "data", "model"))
    assert dp_axes(single) == ("data",)
    assert dp_axes(multi) == ("pod", "data")


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_port_params_have_repros_keys_and_shapes(arch, param_shapes):
    with MetaFactories():
        tree = Model(get_config(arch), device="cpu").init(0)
    got = {keys: tuple(t.shape) for keys, t in _flat(tree)}
    want = {keys: tuple(leaf.shape) for keys, leaf in param_shapes(arch)}
    assert got == want


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_placements_equal_repros(arch, mesh, param_shapes, bare_specs):
    layout = make_production_mesh(multi_pod=MESHES[mesh])
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    want_rules = jax_sharding.ShardingRules(_stub(layout), jcfg)
    rules = ShardingRules(layout, cfg)
    assert rules.fsdp == want_rules.fsdp
    assert (rules.attn_tp, rules.kv_tp) == (want_rules.attn_tp,
                                            want_rules.kv_tp)

    # every parameter
    pairs = param_shapes(arch)
    got = dict(_flat(rules.params_specs(_nested(pairs))))
    for keys, leaf in pairs:
        want = tuple(want_rules.param_spec(
            [types.SimpleNamespace(key=k) for k in keys], leaf))
        assert got[keys] == want, (keys, leaf.shape)
        assert rules.param_spec(keys, leaf) == want

    for B in BATCHES:
        assert rules.batch_spec(B) == tuple(want_rules.batch_spec(B)), B
        # the batch rule: every input of the family's batch
        S = 64
        batch = {"tokens": jax.ShapeDtypeStruct((B, S), np.int32),
                 "loss_mask": jax.ShapeDtypeStruct((B, S), np.int32)}
        if cfg.family == "vlm":
            batch["patches"] = jax.ShapeDtypeStruct(
                (B, cfg.num_patches, cfg.d_model), np.float32)
        if cfg.family == "audio":
            batch["frames"] = jax.ShapeDtypeStruct(
                (B, cfg.encoder_seq, cfg.d_model), np.float32)
        want = {keys: tuple(spec) for keys, spec in _flat(
            want_rules.data_shardings(batch, B))}
        assert dict(_flat(rules.data_specs(batch, B))) == want, B


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_cache_placements_equal_repros(arch, mesh, bare_specs):
    """The decode cache's rule on repro's ring caches: GQA kv-heads or the
    window over 'model', MLA's latent window, Mamba's d_inner, the batch
    over DP where it divides."""
    layout = make_production_mesh(multi_pod=MESHES[mesh])
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    want_rules = jax_sharding.ShardingRules(_stub(layout), jcfg)
    rules = ShardingRules(layout, cfg)
    jm = JaxModel(jcfg)
    for B in (1, 16, 48):
        for S in CACHE_SEQS:
            cache = jax.eval_shape(lambda: jm.init_cache(B, S))
            want = [tuple(s) for _, s in _leaves(
                want_rules.cache_shardings(cache, B))]
            pairs = [(_keys(p), leaf) for p, leaf in _leaves(cache)]
            got = dict(_flat(rules.cache_specs(_nested(pairs), B)))
            assert [got[k] for k, _ in pairs] == want, (B, S)


TOKENS = (1, 3, 255, 4096, 65535, 65536, 65537, 131072, 16 * 65536 + 7,
          33554432)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("impl", ("gather_psum", "a2a"))
def test_cap_for_equals_repros(impl, mesh):
    layout = make_production_mesh(multi_pod=MESHES[mesh])
    axes = dp_axes(layout)
    want_dist = jax_coll.make_moe_dist(_stub(layout), impl, dp_axes=axes)
    dist = pt_coll.make_moe_dist(layout, impl, dp_axes=axes)
    assert type(dist).__name__ == type(want_dist).__name__
    assert (dist.dp_size, dist.ep_size, dist.tp_size, dist.pod_size) == (
        want_dist.dp_size, want_dist.ep_size, want_dist.tp_size,
        want_dist.pod_size)
    n = 0
    for arch in ALL_ARCHS:
        jcfg, cfg = jax_get_config(arch), get_config(arch)
        if cfg.moe is None:
            continue
        for T in TOKENS:
            assert dist.group_tokens(T) == want_dist.group_tokens(T)
            assert dist.cap_for(T, cfg.moe) == want_dist.cap_for(
                T, jcfg.moe), (arch, T)
            n += 1
    assert n == 4 * len(TOKENS)     # qwen2-moe, deepseek-v3, kimi-k2, jamba
