"""The port's kernels: plain versions and slot tables against the JAX
oracles, on the CPU.  (Each CUDA kernel against its plain version is in
test_torch_cuda.py, which runs on the card.)

The JAX side runs as its own tests run it on the CPU: the jnp oracles of
``repro.kernels.ref`` and the jnp sort pass.  Inputs come from
``np.random.default_rng`` and go to both packages.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MoEConfig as JaxMoEConfig
from repro.kernels import ref
from repro.kernels.moe_fused import moe_group_tokens as jax_group_tokens
from repro.models import moe as jax_moe
from repro_torch.configs.base import MoEConfig
from repro_torch.kernels.moe_fused import (group_by_expert, moe_fused_cuda,
                                           moe_fused_plain, moe_group_tokens)
from repro_torch.kernels.paged_attention import (paged_attention_cuda,
                                                 paged_attention_plain)
from repro_torch.models import moe as pt_moe
from test_torch_cases import (MOE_FUSED_GRID, PAGED_CASES, moe_inputs,
                         paged_inputs, t as _t)
from test_torch_cases import one_torch_thread  # noqa: F401

# tests/test_kernels.py:70 and :135 — f32 parity of kernel vs oracle
RTOL, ATOL = 1e-4, 1e-5


# -- paged attention -------------------------------------------------------

@pytest.mark.parametrize("case", PAGED_CASES)
def test_paged_attention_plain_vs_jax(case):
    q, kp, vp, bt, sl, st = paged_inputs(*case)
    want = ref.paged_attention_ref(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(sl), None if st is None else jnp.asarray(st))
    got = paged_attention_plain(_t(q), _t(kp), _t(vp), _t(bt), _t(sl),
                                None if st is None else _t(st))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    if case[-1]:
        assert not got[1].any()          # idle row: exactly 0


# -- fused MoE ---------------------------------------------------------------

@pytest.mark.parametrize("T,k,e_phys,e_local,off,D,F,cap", MOE_FUSED_GRID)
def test_moe_fused_plain_vs_jax(T, k, e_phys, e_local, off, D, F, cap):
    x, g, u, d, phys, w, alive = moe_inputs(T, k, e_phys, e_local, D, F)
    want = ref.moe_fused_ref(*map(jnp.asarray, (x, g, u, d, w, phys,
                                                alive)),
                             cap=cap, expert_offset=off, e_local=e_local)
    got = moe_fused_plain(*map(_t, (x, g, u, d, w, phys, alive)), cap=cap,
                          expert_offset=off, e_local=e_local)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    # the port's dense-scatter path computes the same function
    dense = pt_moe.dispatch_compute_combine(
        *map(_t, (x, w, phys, alive, g, u, d)), cap=cap, expert_offset=off,
        e_local=e_local)
    np.testing.assert_allclose(dense.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("T,k,e_phys,e_local,off,D,F,cap", MOE_FUSED_GRID)
def test_moe_group_tokens_tables_exact(T, k, e_phys, e_local, off, D, F,
                                       cap):
    _, _, _, _, phys, w, alive = moe_inputs(T, k, e_phys, e_local, D, F)
    tj, wj = jax_group_tokens(jnp.asarray(phys), jnp.asarray(alive),
                              jnp.asarray(w), expert_offset=off,
                              e_local=e_local, cap=cap)
    tt, wt, slot_of = moe_group_tokens(_t(phys), _t(alive), _t(w),
                                       expert_offset=off, e_local=e_local,
                                       cap=cap)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))
    np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
    # the inverse map names exactly the kept copies
    flat = slot_of.numpy().reshape(-1)
    kept = flat[flat >= 0]
    assert len(set(kept.tolist())) == len(kept)
    assert (tt.numpy().reshape(-1)[kept]
            == np.nonzero(flat >= 0)[0] // k).all()
    assert (wt.numpy().reshape(-1)[kept] == w.reshape(-1)[flat >= 0]).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n_groups,cap", [(4, 2), (6, 5), (3, 100)])
def test_group_by_expert_exact(seed, n_groups, cap):
    rng = np.random.default_rng(seed)
    N = 57
    ids = rng.integers(-2, n_groups + 2, size=(N,)).astype(np.int32)
    ok = (ids >= 0) & (ids < n_groups) & (rng.random(N) < 0.8)
    oj, gj, sj = jax_moe.group_by_expert(jnp.asarray(ids), jnp.asarray(ok),
                                         n_groups, cap)
    ot, gt, st = group_by_expert(_t(ids), _t(ok), n_groups, cap)
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
    np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


def _masked_lost_routing(framework):
    """tests/test_kernels.py:144 — expert 3 masked, expert 2 fully lost."""
    rng = np.random.default_rng(5)
    T, D, F, cap, e_phys = 24, 64, 64, 10, 6
    x = (rng.normal(size=(T, D)) * 0.1).astype(np.float32)
    router = (rng.normal(size=(D, 4)) * 0.1).astype(np.float32)
    bank = [(rng.normal(size=s) * 0.05).astype(np.float32)
            for s in ((e_phys, D, F), (e_phys, D, F), (e_phys, F, D))]
    if framework == "jax":
        moe = JaxMoEConfig(num_experts=4, top_k=2, expert_d_ff=F,
                           num_redundant_experts=2)
        rt0 = jax_moe.default_runtime(moe)
        rt = jax_moe.MoERuntime(rt0.logical_to_physical,
                                rt0.replica_count.at[2].set(0),
                                rt0.expert_mask.at[3].set(False))
        w, sel, _ = jax_moe.route(jnp.asarray(router), jnp.asarray(x), rt,
                                  moe)
        phys, alive = jax_moe.select_replicas(sel, rt)
        y = ref.moe_fused_ref(jnp.asarray(x), *map(jnp.asarray, bank), w,
                              phys, alive, cap=cap, expert_offset=0,
                              e_local=e_phys)
        return tuple(np.asarray(a) for a in (w, sel, phys, alive, y))
    moe = MoEConfig(num_experts=4, top_k=2, expert_d_ff=F,
                    num_redundant_experts=2)
    rt0 = pt_moe.default_runtime(moe, "cpu")
    count = rt0.replica_count.clone()
    count[2] = 0
    mask = rt0.expert_mask.clone()
    mask[3] = False
    rt = pt_moe.MoERuntime(rt0.logical_to_physical, count, mask)
    w, sel = pt_moe.route(_t(router), _t(x), rt, moe)
    phys, alive = pt_moe.select_replicas(sel, rt)
    y = moe_fused_plain(_t(x), *map(_t, bank), w, phys, alive, cap=cap,
                        expert_offset=0, e_local=e_phys)
    return tuple(a.numpy() for a in (w, sel, phys, alive, y))


def test_moe_fused_masked_and_lost_experts():
    wj, selj, pj, aj, yj = _masked_lost_routing("jax")
    wt, selt, pt, at, yt = _masked_lost_routing("torch")
    np.testing.assert_array_equal(selt, selj)
    np.testing.assert_array_equal(pt, pj)
    np.testing.assert_array_equal(at, aj)
    assert not np.isin(selt, [3]).any() and not at.all()
    np.testing.assert_allclose(wt, wj, rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(yt, yj, rtol=RTOL, atol=ATOL)


def test_default_runtime_and_capacity_match():
    moe = MoEConfig(num_experts=60, top_k=4, expert_d_ff=8,
                    num_redundant_experts=4)
    jmoe = JaxMoEConfig(**dataclasses.asdict(moe))
    rt, jrt = pt_moe.default_runtime(moe, "cpu"), jax_moe.default_runtime(jmoe)
    for a, b in zip(rt, jrt):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for n in (8, 32, 128, 1000):
        assert pt_moe.capacity(n, 64, 1.25) == jax_moe.capacity(n, 64, 1.25)


def test_launchers_refuse_cpu_tensors():
    q, kp, vp, bt, sl, _ = (None if a is None else _t(a)
                            for a in paged_inputs(2, 4, 4, 64, 16, 3,
                                                   False, False))
    with pytest.raises(ValueError):
        paged_attention_cuda(q, kp, vp, bt, sl)
    x, g, u, d, phys, w, alive = map(_t, moe_inputs(8, 2, 4, 2, 64, 40))
    with pytest.raises(ValueError):
        moe_fused_cuda(x, g, u, d, w, phys, alive, cap=8, e_local=2)
