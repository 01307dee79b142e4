"""The port's training path against the JAX package, on the CPU: data,
the loss and its pieces, the gradients, the written-out backward of the
two kernels that have one, AdamW, three steps of ``train`` and the
launcher; and the repairs training needed (launchers without a backward
refuse inputs that require grad, ``ssm_rates`` under grad, the
load-balance loss).

Weights are drawn by the port's ``Model.init`` (a few milliseconds at the
smoke sizes, where ``repro``'s takes seconds an arch) and go across
through ``weights.npz``, written by
``repro.training.checkpoint.save_checkpoint`` and read by
``repro_torch.training.checkpoint.load_params``; JAX gets the same arrays
(both packages' parameter trees have the same keys).  Every other input
is drawn with numpy and handed to both packages.  Everything runs in f32.
"""
import dataclasses
import importlib.util
import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.kernels.ref import expert_ffn_ref
from repro.models import attention as jax_attention
from repro.models import layers as jax_layers
from repro.models import moe as jax_moe
from repro.models.model import Model as JaxModel
from repro.training import data as jax_data
from repro.training import optimizer as jax_opt
from repro.training import train_loop as jax_train_loop
from repro.training.checkpoint import _flatten
from repro.training.checkpoint import save_checkpoint as jax_save
from repro_torch.configs import ALL_ARCHS, get_smoke_config
from repro_torch.kernels import ops
from repro_torch.kernels.decode_megastep import decode_megastep_cuda
from repro_torch.kernels.expert_ffn import (ExpertFFN, expert_ffn_bwd_plain,
                                            expert_ffn_cuda)
from repro_torch.kernels.flash_prefill import (FlashPrefill,
                                               flash_prefill_bwd_plain,
                                               flash_prefill_cuda)
from repro_torch.kernels.moe_fused import moe_fused_cuda
from repro_torch.kernels.paged_attention import paged_attention_cuda
from repro_torch.kernels.router_topk import router_topk_cuda
from repro_torch.kernels.ssm_scan import ssm_scan_cuda
from repro_torch.launch import train as launch_train
from repro_torch.models import layers as pt_layers
from repro_torch.models import moe as pt_moe
from repro_torch.models.model import Model
from repro_torch.training import data as pt_data
from repro_torch.training import optimizer as pt_opt
from repro_torch.training.checkpoint import flatten, load_params
from repro_torch.training.train_loop import as_leaves, train
from test_torch_cases import one_torch_thread  # noqa: F401

# the gradients: |port - jax| <= ATOL * (the leaf's largest |g|) + RTOL *
# |g|; f32 sums in other orders through a few layers
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
TRAIN_RTOL = 1e-4            # the 3-step histories and final params


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _carry(tree, tmp_path):
    """A numpy parameter tree -> weights.npz (written by repro) -> the
    port's parameters."""
    path = tmp_path / "weights.npz"
    jax_save(str(path), tree)
    return load_params(str(path), dtype=torch.float32, device="cpu")


def _weights(cfg, seed=0):
    """The port's Model.init(seed) of ``cfg`` as a numpy tree, and the
    same arrays as JAX's parameters."""
    tree = _np_map(lambda t: t.numpy(),
                   Model(cfg, device="cpu").init(seed))
    return tree, _np_map(jnp.asarray, tree)


def _batch(cfg, seed, B=2, S=12):
    """numpy tokens (B, S), a loss mask with its last 3 positions of row 1
    off, and a vlm's patches or an audio model's frames."""
    rng = np.random.default_rng(seed)
    mask = np.ones((B, S), np.int32)
    mask[-1, -3:] = 0
    b = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
         "loss_mask": mask}
    if cfg.family == "vlm":
        b["patches"] = rng.normal(
            size=(B, cfg.num_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        b["frames"] = rng.normal(
            size=(B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return b


def _close(got, want, rtol, atol_scale, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = float(np.abs(want).max()) if want.size else 0.0
    err = np.abs(got - want)
    bad = err > atol_scale * scale + rtol * np.abs(want)
    assert not bad.any(), (f"{what}: max err {err.max():.3e} at scale "
                           f"{scale:.3e}, {int(bad.sum())} of {bad.size} "
                           f"out")


# -- data ---------------------------------------------------------------------

@pytest.mark.parametrize("split", ["train", "eval"])
def test_make_batch_bit_equal(split):
    for vocab, seq, batch, seed in ((64, 64, 16, 0), (151936, 33, 3, 5)):
        jc = jax_data.DataConfig(vocab, seq, batch, seed)
        pc = pt_data.DataConfig(vocab, seq, batch, seed)
        for step in range(4):
            want = jax_data.make_batch(jc, step, split)
            got = pt_data.make_batch(pc, step, split)
            assert want.keys() == got.keys()
            for k in want:
                assert want[k].dtype == got[k].dtype
                np.testing.assert_array_equal(got[k], want[k])


def test_lm_batches_bit_equal():
    jc, pc = (mod.DataConfig(64, 40, 4, 2) for mod in (jax_data, pt_data))
    for start in (0, 7):
        for want, got, _ in zip(jax_data.lm_batches(jc, start),
                                pt_data.lm_batches(pc, start), range(4)):
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])


# -- the loss and its pieces -----------------------------------------------------

def test_cross_entropy_loss_padded_vocab():
    rng = np.random.default_rng(0)
    B, S, V, vpad = 3, 7, 50, 64
    logits = (rng.normal(size=(B, S, vpad)) * 3).astype(np.float32)
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    mask = (rng.random((B, S)) < 0.6).astype(np.float32)
    want = jax_layers.cross_entropy_loss(jnp.asarray(logits),
                                         jnp.asarray(labels),
                                         jnp.asarray(mask), V)
    got = pt_layers.cross_entropy_loss(_t(logits), _t(labels), _t(mask), V)
    assert got.dtype == torch.float32
    assert abs(float(got) - float(want)) <= 1e-6 * abs(float(want))
    # an all-zero mask divides by 1, as repro's max(sum, 1)
    zero = np.zeros_like(mask)
    assert float(pt_layers.cross_entropy_loss(
        _t(logits), _t(labels), _t(zero), V)) == 0.0


@pytest.mark.parametrize("masked,lost", [((), ()), ((1, 5), ()),
                                         ((2,), (0, 6))])
def test_route_aux_loss(masked, lost):
    """route's GShard aux with masked experts (softmax over the live ones)
    and lost ones (replica_count 0: still routed to, as in repro)."""
    from repro_torch.configs.base import MoEConfig
    moe = MoEConfig(num_experts=8, top_k=2, expert_d_ff=16,
                    num_redundant_experts=2)
    rng = np.random.default_rng(3)
    T, D = 40, 12
    x = rng.normal(size=(T, D)).astype(np.float32)
    router = rng.normal(size=(D, moe.num_experts)).astype(np.float32)
    rt_j = jax_moe.default_runtime(moe)
    mask = np.ones(moe.num_experts, bool)
    mask[list(masked)] = False
    count = np.asarray(rt_j.replica_count).copy()
    count[list(lost)] = 0
    rt_j = rt_j._replace(expert_mask=jnp.asarray(mask),
                         replica_count=jnp.asarray(count))
    rt_p = pt_moe.default_runtime(moe, "cpu")._replace(
        expert_mask=_t(mask), replica_count=_t(count))
    w_j, sel_j, aux_j = jax_moe.route(jnp.asarray(router), jnp.asarray(x),
                                      rt_j, moe)
    w_p, sel_p, aux_p = pt_moe.route(_t(router), _t(x), rt_p, moe,
                                     with_aux=True)
    np.testing.assert_array_equal(sel_p.numpy(), np.asarray(sel_j))
    np.testing.assert_allclose(w_p.numpy(), np.asarray(w_j), rtol=1e-5,
                               atol=1e-7)
    assert aux_p.dtype == torch.float32 and aux_p.dim() == 0
    assert abs(float(aux_p) - float(aux_j)) <= 1e-6 * abs(float(aux_j))
    # without the keyword, route's callers get what they got before
    assert len(pt_moe.route(_t(router), _t(x), rt_p, moe)) == 2


@pytest.fixture(scope="module")
def jax_models():
    """Per smoke arch, built on its first use and kept for the module:
    (repro's model, the numpy weights, their JAX arrays, a dict that
    holds repro's jitted gradient once taken)."""
    cache = {}

    def get(arch):
        if arch not in cache:
            tree, jparams = _weights(get_smoke_config(arch))
            cache[arch] = (JaxModel(jax_smoke_config(arch)), tree, jparams,
                           {})
        return cache[arch]
    return get


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_model_loss_vs_jax(arch, jax_models, tmp_path):
    """Model.loss (total, ce, aux) against repro's for every registered
    arch at its smoke config: the vlm over its text positions only, the
    audio decoder over the frames' encoding, the MoE archs with their
    load-balance term."""
    jm, tree, _, _ = jax_models(arch)
    cfg = get_smoke_config(arch)
    pm = Model(cfg, device="cpu")
    pparams = _carry(tree, tmp_path)
    b = _batch(cfg, seed=12)
    want, wm, _ = _jax_loss(jax_models, arch, b)
    with torch.no_grad():
        got, gm = pm.loss(pparams, {k: _t(v) for k, v in b.items()})
    for name, g, w in (("total", got, want), ("ce", gm["ce"], wm["ce"]),
                       ("aux", gm["aux"], wm["aux"])):
        assert abs(float(g) - float(w)) <= 1e-5 * abs(float(w)), (
            name, float(g), float(w))
    assert (cfg.moe is not None) == (float(gm["aux"]) > 0)
    assert pm._num_moe_layers() == jm._num_moe_layers()
    assert pm.count_params() == sum(a.size for a in _flatten(tree).values())


# -- gradients ------------------------------------------------------------------

GRAD_ARCHS = ("qwen2-moe-a2.7b", "deepseek-v3", "falcon-mamba-7b",
              "jamba-1.5-large-398b")


def _port_grads(pm, params, batch):
    """{key: gradient} of Model.loss, a leaf the loss misses zero."""
    loss, _ = pm.loss(params, batch)
    keys, ts = zip(*flatten(params))
    grads = torch.autograd.grad(loss, ts, allow_unused=True)
    return {k: (torch.zeros_like(t) if g is None else g).numpy()
            for k, t, g in zip(keys, ts, grads)}


def _jax_loss(jax_models, arch, batch):
    """repro's (loss, metrics, flattened gradient or None) of Model.loss
    at ``batch``, jitted once an arch and kept: an arch whose gradient a
    test takes (GRAD_ARCHS) compiles value_and_grad, the others the loss
    alone."""
    jm, _, jparams, kept = jax_models(arch)
    if "loss" not in kept:
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        if arch in GRAD_ARCHS:
            (loss, metrics), g = jax.jit(jax.value_and_grad(
                jm.loss, has_aux=True))(jparams, jb)
            kept["loss"] = (loss, metrics, _flatten(g))
        else:
            kept["loss"] = (*jax.jit(jm.loss)(jparams, jb), None)
    return kept["loss"]


def _jax_grads(jax_models, arch, batch):
    return _jax_loss(jax_models, arch, batch)[2]


@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_gradients_vs_jax(arch, jax_models, tmp_path):
    """Every leaf's gradient of Model.loss against jax.value_and_grad of
    repro's; the two trees are paired by repro's flattened key names."""
    _, tree, _, _ = jax_models(arch)
    cfg = get_smoke_config(arch)
    pm = Model(cfg, device="cpu")
    pparams = as_leaves(_carry(tree, tmp_path))
    b = _batch(cfg, seed=12)
    want = _jax_grads(jax_models, arch, b)
    got = _port_grads(pm, pparams, {k: _t(v) for k, v in b.items()})
    assert list(got) == list(want)
    for key in want:
        _close(got[key], want[key], GRAD_RTOL, GRAD_ATOL, f"{arch} {key}")
    if cfg.mamba is not None:
        a_logs = [k for k in want if k.endswith("A_log")]
        assert a_logs and all(np.abs(got[k]).max() > 0 for k in a_logs)


@pytest.mark.parametrize("arch", ("falcon-mamba-7b", "jamba-1.5-large-398b"))
def test_ssm_rates_under_grad(arch, jax_models, tmp_path):
    """A no_grad prefill fills Model.ssm_rates' cache from the very A_log
    tensors a training forward then differentiates: the training forward
    computes A in the graph (A_log's gradient non-zero and repro's), and
    the cache stays as the prefill left it."""
    _, tree, _, _ = jax_models(arch)
    cfg = get_smoke_config(arch)
    pm = Model(cfg, device="cpu")
    pparams = as_leaves(_carry(tree, tmp_path))
    b = _batch(cfg, seed=12)
    pb = {k: _t(v) for k, v in b.items()}
    with torch.no_grad():
        pm.prefill(pparams, {"tokens": pb["tokens"]})
    cached = {k: v[2] for k, v in pm._ssm_A.items()}
    assert cached and not any(a.requires_grad for a in cached.values())
    got = _port_grads(pm, pparams, pb)
    want = _jax_grads(jax_models, arch, b)
    for key in (k for k in want if k.endswith("A_log")):
        assert np.abs(got[key]).max() > 0, key
        _close(got[key], want[key], GRAD_RTOL, GRAD_ATOL, key)
    assert {k: v[2] for k, v in pm._ssm_A.items()}.keys() == cached.keys()
    assert all(pm._ssm_A[k][2] is a for k, a in cached.items())


# -- the two backward kernels' plain versions ---------------------------------------

FLASH_BWD_CASES = {
    # name: (B, Sq, Skv, H, Hkv, Dq, Dv, causal, window, kv position shift)
    "g1": (2, 24, 24, 4, 4, 16, 16, True, 0, 0),
    "g2_window6_dv_ne_dq": (1, 32, 32, 4, 2, 24, 16, True, 6, 0),
    "not_causal_sq_ne_skv": (2, 8, 40, 4, 4, 16, 16, False, 0, 0),
    "no_key_rows": (1, 16, 16, 4, 2, 16, 16, True, 0, 3),
}


@pytest.mark.parametrize("case", FLASH_BWD_CASES, ids=str)
def test_flash_prefill_bwd_plain_vs_jax_vjp(case):
    """flash_prefill_bwd_plain against jax.vjp of repro's flash_attention.
    A row that sees no key: repro's jnp flash_attention outputs the mean
    of V there (its running max stays at -1e30, so p = exp(0) for every
    masked key), the port's plain version, kernel and the Pallas kernel
    output 0 and pass no gradient; the JAX cotangent of those rows is
    zeroed, so both sides differentiate the same function, and the port
    is held to ignore that row's dO."""
    B, Sq, Skv, H, Hkv, Dq, Dv, causal, window, shift = FLASH_BWD_CASES[case]
    rng = np.random.default_rng(7)
    q = rng.normal(size=(B, Sq, H, Dq)).astype(np.float32)
    k = rng.normal(size=(B, Skv, Hkv, Dq)).astype(np.float32)
    v = rng.normal(size=(B, Skv, Hkv, Dv)).astype(np.float32)
    do = rng.normal(size=(B, Sq, H, Dv)).astype(np.float32)
    q_pos = np.arange(Sq, dtype=np.int32) + (Skv - Sq)
    kv_pos = np.arange(Skv, dtype=np.int32) + shift
    sees = (((not causal) | (q_pos[:, None] >= kv_pos[None, :]))
            & ((window == 0) | (q_pos[:, None] - kv_pos[None, :] < window))
            ).any(axis=1)
    assert sees.all() == (case != "no_key_rows")

    def f(q_, k_, v_):
        return jax_attention.flash_attention(
            q_, k_, v_, jnp.asarray(q_pos), jnp.asarray(kv_pos),
            causal=causal, window=window)
    out, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do * sees[None, :, None, None]))
    o = ops.flash_prefill(_t(q), _t(k), _t(v), _t(q_pos), _t(kv_pos),
                          causal=causal, window=window)
    np.testing.assert_allclose(o.numpy()[:, sees], np.asarray(out)[:, sees],
                               rtol=1e-5, atol=1e-5)
    got = flash_prefill_bwd_plain(_t(q), _t(k), _t(v), o, _t(do),
                                  _t(q_pos), _t(kv_pos), causal=causal,
                                  window=window)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _close(g.numpy(), np.asarray(w), 1e-5, 1e-6, f"{case} {name}")
    if not sees.all():
        assert float(got[0][:, ~sees].abs().max()) == 0.0


def test_expert_ffn_bwd_plain_vs_jax_vjp():
    """expert_ffn_bwd_plain against jax.vjp of repro.kernels.ref.
    expert_ffn_ref, with empty rows (dropped copies: x = 0) that must get
    zero gradients."""
    rng = np.random.default_rng(8)
    E, C, D, Fd = 3, 10, 24, 40
    x = (rng.normal(size=(E, C, D)) * 0.5).astype(np.float32)
    x[0, 7:] = 0
    x[2, 3] = 0
    ws = [(rng.normal(size=s) * 0.2).astype(np.float32)
          for s in ((E, D, Fd), (E, D, Fd), (E, Fd, D))]
    dy = rng.normal(size=(E, C, D)).astype(np.float32)
    _, vjp = jax.vjp(expert_ffn_ref, jnp.asarray(x),
                     *(jnp.asarray(w) for w in ws))
    want = vjp(jnp.asarray(dy))
    dy_empty_zero = dy.copy()
    dy_empty_zero[0, 7:] = 0
    dy_empty_zero[2, 3] = 0
    got = expert_ffn_bwd_plain(_t(x), *(_t(w) for w in ws), _t(dy))
    for name, g, w in zip(("dx", "dgate", "dup", "ddown"), got, want):
        _close(g.numpy(), np.asarray(w), 1e-5, 1e-6, name)
    # an empty row passes nothing back, whatever its dy
    got0 = expert_ffn_bwd_plain(_t(x), *(_t(w) for w in ws),
                                _t(dy_empty_zero))
    for g, g0 in zip(got, got0):
        np.testing.assert_array_equal(g.numpy(), g0.numpy())
    assert float(got[0][0, 7:].abs().max()) == 0.0


@pytest.mark.parametrize("causal,window,shift,heads", [
    (True, 0, 0, (2, 1, 4, 4)), (True, 3, 2, (4, 2, 4, 8)),
    (False, 0, 0, (2, 2, 8, 4))], ids=["g2", "window_no_key_dv", "not_causal"])
def test_flash_prefill_function_gradcheck(causal, window, shift, heads):
    """FlashPrefill's written-out backward against finite differences in
    f64 (``fast_mode``: random directions, not every element)."""
    H, Hkv, Dq, Dv = heads
    S = 5
    rng = np.random.default_rng(9)
    q, k, v = (torch.tensor(rng.normal(size=s), dtype=torch.float64,
                            requires_grad=True)
               for s in ((1, S, H, Dq), (1, S, Hkv, Dq), (1, S, Hkv, Dv)))
    qp = torch.arange(S, dtype=torch.int32)
    assert torch.autograd.gradcheck(
        lambda a, b, c: FlashPrefill.apply(a, b, c, qp, qp + shift, causal,
                                           window), (q, k, v),
        fast_mode=True)


def test_expert_ffn_function_gradcheck():
    rng = np.random.default_rng(10)
    x, g, u, d = (torch.tensor(rng.normal(size=s) * 0.5, dtype=torch.float64)
                  for s in ((2, 4, 6), (2, 6, 5), (2, 6, 5), (2, 5, 6)))
    x[1, 2] = 0                         # an empty row
    ts = [t.requires_grad_() for t in (x, g, u, d)]
    assert torch.autograd.gradcheck(ExpertFFN.apply, ts, fast_mode=True)


def test_ops_route_through_functions_only_under_grad():
    """ops.flash_prefill / ops.expert_ffn build a graph only where grad
    mode is on and an input requires it; serving calls stay plain."""
    rng = np.random.default_rng(11)
    q, k, v = (_t(rng.normal(size=(1, 8, 2, 8)).astype(np.float32))
               for _ in range(3))
    x = _t(rng.normal(size=(2, 3, 8)).astype(np.float32))
    w1, w2 = (_t(rng.normal(size=(2, 8, 4)).astype(np.float32))
              for _ in range(2))
    w3 = _t(rng.normal(size=(2, 4, 8)).astype(np.float32))
    assert ops.flash_prefill(q, k, v).grad_fn is None
    assert ops.expert_ffn(x, w1, w2, w3).grad_fn is None
    q.requires_grad_()
    x.requires_grad_()
    with torch.no_grad():
        assert ops.flash_prefill(q, k, v).grad_fn is None
        assert ops.expert_ffn(x, w1, w2, w3).grad_fn is None
    assert "FlashPrefill" in type(ops.flash_prefill(q, k, v).grad_fn).__name__
    assert "ExpertFFN" in type(ops.expert_ffn(x, w1, w2, w3).grad_fn).__name__


# -- the launchers without a backward ----------------------------------------------

def _grad_inputs():
    t = torch.zeros((2, 4, 8), requires_grad=True)
    return t


@pytest.mark.parametrize("name,call", [
    ("paged_attention_cuda", lambda t: paged_attention_cuda(
        t, t, t, None, None)),
    ("moe_fused_cuda", lambda t: moe_fused_cuda(
        t, t, t, t, t, None, None, cap=1, e_local=1)),
    ("decode_megastep_cuda", lambda t: decode_megastep_cuda(
        t, t, t, None, None, None, t, t, t, t, None, None, None, t, t, t,
        None, top_k=1, cap=1, e_local=1)),
    ("router_topk_cuda", lambda t: router_topk_cuda(t, None, 1)),
    ("ssm_scan_cuda", lambda t: ssm_scan_cuda(t, t, t, t, t)),
    ("flash_prefill_cuda", lambda t: flash_prefill_cuda(t, t, t)),
    ("expert_ffn_cuda", lambda t: expert_ffn_cuda(t, t, t, t)),
])
def test_launchers_refuse_inputs_that_require_grad(name, call):
    """Each CUDA launcher checks grad first (before the device): an input
    that requires grad under grad mode raises, naming the kernel, instead
    of returning an output with no autograd history."""
    with pytest.raises(RuntimeError, match=name):
        call(_grad_inputs())
    if name not in ("flash_prefill_cuda", "expert_ffn_cuda"):
        with pytest.raises(RuntimeError, match="backward is not ported"):
            call(_grad_inputs())
    # under no_grad the check passes and the device check raises instead
    with torch.no_grad(), pytest.raises((ValueError, TypeError,
                                         AttributeError)):
        call(_grad_inputs())


@pytest.mark.parametrize("arch", ("qwen2-moe-a2.7b", "jamba-1.5-large-398b"))
def test_logits_full_aux_keyword(arch):
    """logits_full(with_aux=True) adds repro's third output, the MoE
    layers' load-balance losses summed (a hybrid period's MoE sublayers
    included; against repro in test_model_loss_vs_jax); its callers
    without the keyword still get (logits, caches), the same logits."""
    cfg = get_smoke_config(arch)
    pm = Model(cfg, device="cpu")
    params = pm.init(0)
    tokens = _t(np.random.default_rng(14).integers(
        0, cfg.vocab_size, (2, 10)).astype(np.int32))
    with torch.no_grad():
        plain = pm.logits_full(params, {"tokens": tokens})
        logits, _, aux = pm.logits_full(params, {"tokens": tokens},
                                        with_aux=True)
    assert len(plain) == 2
    torch.testing.assert_close(plain[0], logits, rtol=0, atol=0)
    assert aux.dtype == torch.float32 and aux.dim() == 0
    # one term a MoE layer, each E * sum(f p) >= 1 (equality at balance)
    assert float(aux) >= pm._num_moe_layers() * (1 - 1e-6)


# -- AdamW -------------------------------------------------------------------------

def _tree(rng, scale=1.0):
    return {"a": {"w": (rng.normal(size=(5, 3)) * scale).astype(np.float32),
                  "b": (rng.normal(size=(3,)) * scale).astype(np.float32)},
            "emb": (rng.normal(size=(4, 2)) * scale).astype(np.float32)}


def _np_map(fn, tree):
    return {k: _np_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def test_schedule_and_global_norm():
    cfg_kw = dict(lr=2e-3, warmup_steps=30, total_steps=300)
    jc, pc = jax_opt.OptimizerConfig(**cfg_kw), pt_opt.OptimizerConfig(**cfg_kw)
    for step in (0, 29, 30, 165, 299, 400):
        want = float(jax_opt.schedule(jc, jnp.asarray(step, jnp.int32)))
        got = float(pt_opt.schedule(pc, torch.tensor(step,
                                                     dtype=torch.int32)))
        assert abs(got - want) <= 1e-6 * want, (step, got, want)
    tree = _tree(np.random.default_rng(0))
    want = float(jax_opt.global_norm(_np_map(jnp.asarray, tree)))
    got = float(pt_opt.global_norm(_np_map(_t, tree)))
    assert abs(got - want) <= 1e-6 * want


@pytest.mark.parametrize("grad_scale", [0.1, 10.0], ids=["unclipped",
                                                          "clipped"])
def test_adamw_three_updates(grad_scale):
    """Three adamw_updates on a random tree, gradients below and above the
    clip norm: params, m and v within 1e-6 of repro's."""
    rng = np.random.default_rng(1)
    params = _tree(rng)
    cfg_kw = dict(lr=1e-2, warmup_steps=2, total_steps=10)
    jc, pc = jax_opt.OptimizerConfig(**cfg_kw), pt_opt.OptimizerConfig(**cfg_kw)
    jp, pp = _np_map(jnp.asarray, params), _np_map(_t, params)
    js, ps = jax_opt.init_adamw(jp), pt_opt.init_adamw(pp)
    for _ in range(3):
        grads = _tree(rng, grad_scale)
        jp, js, jm = jax_opt.adamw_update(jc, _np_map(jnp.asarray, grads),
                                          js, jp)
        pp, ps, pm = pt_opt.adamw_update(pc, _np_map(_t, grads), ps, pp)
        assert abs(float(pm["grad_norm"]) - float(jm["grad_norm"])) <= (
            1e-6 * float(jm["grad_norm"]))
        assert abs(float(pm["lr"]) - float(jm["lr"])) <= 1e-6 * float(jm["lr"])
    assert int(ps.step) == int(js.step) == 3
    for name, got, want in (("params", pp, jp), ("m", ps.m, js.m),
                            ("v", ps.v, js.v)):
        for (key, g), w in zip(flatten(got), jax.tree_util.tree_leaves(want)):
            assert g.dtype == torch.float32
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-6, err_msg=f"{name} {key}")


# -- train() ------------------------------------------------------------------------

def _train_moe_cfgs():
    """examples/train_moe.py's reduced config, in both packages."""
    def cut(cfg):
        return dataclasses.replace(
            cfg, vocab_size=64, moe=dataclasses.replace(
                cfg.moe, num_experts=16, top_k=2, capacity_factor=2.0))
    return (cut(jax_smoke_config("qwen2-moe-a2.7b")),
            cut(get_smoke_config("qwen2-moe-a2.7b")))


def _jax_train(jcfg, jparams, steps):
    jm = JaxModel(jcfg)
    dc = jax_data.DataConfig(vocab_size=64, seq_len=64, batch_size=16)
    opt = jax_opt.OptimizerConfig(lr=2e-3, warmup_steps=30, total_steps=300)
    return jax_train_loop.train(jm, jax_data.lm_batches(dc), steps,
                                opt_cfg=opt, log_every=1, params=jparams)


@pytest.fixture(scope="module")
def trained_3_steps():
    """repro's train() of train_moe's config for 3 steps from seed-0
    weights (a numpy tree), and those weights."""
    jcfg, pcfg = _train_moe_cfgs()
    tree, jparams0 = _weights(pcfg)
    jparams, jhist = _jax_train(jcfg, jparams0, 3)
    return tree, jparams, jhist


def test_train_three_steps_vs_jax(trained_3_steps, tmp_path):
    """train() of both packages for 3 steps from the same params on
    train_moe's config and lm_batches: the histories (loss, ce, aux, lr,
    grad_norm) within 1e-4 relative, the final params within 1e-4 of each
    leaf's scale."""
    tree, jparams, jhist = trained_3_steps
    _, pcfg = _train_moe_cfgs()
    pm = Model(pcfg, device="cpu")
    dc = pt_data.DataConfig(vocab_size=64, seq_len=64, batch_size=16)
    opt = pt_opt.OptimizerConfig(lr=2e-3, warmup_steps=30, total_steps=300)
    pparams, phist = train(pm, pt_data.lm_batches(dc), 3, opt_cfg=opt,
                           log_every=1, params=_carry(tree, tmp_path))
    assert [h["step"] for h in phist] == [h["step"] for h in jhist]
    for hp, hj in zip(phist, jhist):
        assert set(hp) == set(hj)
        for key in ("loss", "ce", "aux", "lr", "grad_norm"):
            assert abs(hp[key] - hj[key]) <= TRAIN_RTOL * abs(hj[key]), (
                hp["step"], key, hp[key], hj[key])
    want = _flatten(jparams)
    got = {k: v.detach().numpy() for k, v in flatten(pparams)}
    assert list(got) == list(want)
    for key in want:
        _close(got[key], want[key], 0.0, TRAIN_RTOL, key)


def test_train_moe_twin_first_steps(trained_3_steps, tmp_path, capsys):
    """examples/train_moe_torch.py's ``run`` for its first 3 steps (log
    every step) from the fixture's weights: its lines equal those
    examples/train_moe.py prints for repro's history once times are
    stripped, the numbers within TRAIN_RTOL.  (The warmup is 30 steps, so
    the learning rates of steps 0-2 do not depend on total_steps.)"""
    tree, _, jhist = trained_3_steps
    path = Path(__file__).resolve().parents[1] / "examples"
    spec = importlib.util.spec_from_file_location(
        "example_train_moe_torch", path / "train_moe_torch.py")
    twin = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(twin)
    _, hist = twin.run(3, "cpu", params=_carry(tree, tmp_path), log_every=1)
    got = capsys.readouterr().out.strip().splitlines()
    n_params = sum(a.size for a in _flatten(tree).values())
    want = [f"params: {n_params:,}"] + [
        f"  step {h['step']:4d}  loss {h['loss']:.4f}  aux {h['aux']:.3f}  "
        f"({h['elapsed_s']:.0f}s)" for h in jhist]
    strip = re.compile(r"\(\d+s\)$")
    assert [strip.sub("", x) for x in got] == [strip.sub("", x) for x in want]
    for hp, hj in zip(hist, jhist):
        for key in ("loss", "ce", "aux", "grad_norm"):
            assert abs(hp[key] - hj[key]) <= TRAIN_RTOL * abs(hj[key])


# -- the launcher ---------------------------------------------------------------------

def test_launch_train_cpu(capsys):
    assert launch_train.main(["--arch", "qwen2-moe-a2.7b", "--smoke",
                              "--steps", "3", "--batch", "2", "--seq", "16",
                              "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    step_line = re.compile(r"step +\d+ loss \d+\.\d{4} lr \d\.\d{2}e[-+]\d+ "
                           r"gnorm \d+\.\d{2} \(\d+\.\ds\)$")
    assert [bool(step_line.match(x)) for x in lines] == [True, True, False]
    assert re.match(r"final loss: \d+\.\d{4}$", lines[-1])
    assert math.isfinite(float(lines[-1].split(":")[1]))


def test_launch_train_needs_a_device_and_refuses_aot(monkeypatch):
    """Without a card and without --device cpu the launcher raises; --aot
    runs the dry run's train_4k trace (``launch.dryrun.run_dryrun``, no
    extrapolation, as repro's launcher) and exits 0."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            launch_train.main(["--arch", "qwen2-moe-a2.7b", "--smoke",
                               "--steps", "1"])
    from repro_torch.launch import dryrun
    calls = []
    monkeypatch.setattr(dryrun, "run_dryrun",
                        lambda *a, **kw: calls.append((a, kw)) or {})
    assert launch_train.main(["--arch", "kimi-k2-1t-a32b", "--aot"]) == 0
    assert launch_train.main(["--arch", "qwen2-moe-a2.7b", "--aot",
                              "--multi-pod"]) == 0
    assert calls == [(("kimi-k2-1t-a32b", "train_4k"),
                      dict(multi_pod=False, extrapolate=False)),
                     (("qwen2-moe-a2.7b", "train_4k"),
                      dict(multi_pod=True, extrapolate=False))]
