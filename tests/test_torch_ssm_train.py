"""The selective scan's gradient in the port against the JAX package, on
the CPU: the written-out backward (``ssm_scan_bwd_plain``, which the
CUDA kernel ``csrc/ssm_scan_bwd.cu`` computes) against ``jax.vjp`` of
``repro.kernels.ref.ssm_scan_ref``, ``SSMScan`` against finite
differences, its refusal of the in-place decode mode under grad, and
three ``train()`` steps of the smoke falcon-mamba-7b against ``repro``'s.

Inputs are drawn with numpy and handed to both packages; the model's
weights are the port's ``Model.init`` carried across through
``weights.npz``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.kernels.ref import ssm_scan_ref
from repro.models.model import Model as JaxModel
from repro.training import data as jax_data
from repro.training import optimizer as jax_opt
from repro.training import train_loop as jax_train_loop
from repro.training.checkpoint import _flatten
from repro.training.checkpoint import save_checkpoint as jax_save
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import ops
from repro_torch.kernels.ssm_scan import SSMScan, ssm_scan_bwd_plain
from repro_torch.models.model import Model
from repro_torch.training import data as pt_data
from repro_torch.training import optimizer as pt_opt
from repro_torch.training.checkpoint import flatten, load_params
from repro_torch.training.train_loop import train
from test_torch_cases import one_torch_thread, ssm_inputs  # noqa: F401
from test_torch_cases import t as _t

GRADS = ("du", "ddt", "dA", "dB", "dC")
BWD_TOL = 1e-5               # f32, of each gradient's scale and relative
TRAIN_RTOL = 1e-4            # the 3-step histories and final params


def _close(got, want, rtol, atol_scale, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = float(np.abs(want).max()) if want.size else 0.0
    err = np.abs(got - want)
    bad = err > atol_scale * scale + rtol * np.abs(want)
    assert not bad.any(), (f"{what}: max err {err.max():.3e} at scale "
                           f"{scale:.3e}, {int(bad.sum())} of {bad.size} "
                           f"out")


def _draw(B, S, d, N, seed):
    """The scan's inputs (tests/test_kernels.py's draw) and cotangents for
    y and h_final."""
    u, dt, A, Bs, Cs, _ = ssm_inputs(B, S, d, N, False, seed=seed)
    rng = np.random.default_rng(seed + 1)
    dy = rng.normal(size=(B, S, d)).astype(np.float32)
    dh = rng.normal(size=(B, d, N)).astype(np.float32)
    return (u, dt, A, Bs, Cs), dy, dh


@pytest.mark.parametrize("B,S,d,N", [(2, 70, 12, 8), (3, 65, 10, 16),
                                     (2, 1, 6, 16)],
                         ids=["n8_s70", "n16_s65", "n16_s1"])
def test_ssm_scan_bwd_plain_vs_jax_vjp(B, S, d, N):
    """ssm_scan_bwd_plain against jax.vjp of repro's scan oracle from a
    zero state, with cotangents for both y and h_final: du, ddt, dA, dB
    and dC within 1e-5 in f32.  S past one 32-step chunk of the kernel,
    and not a multiple of it."""
    ins, dy, dh = _draw(B, S, d, N, seed=21)
    _, vjp = jax.vjp(ssm_scan_ref, *(jnp.asarray(a) for a in ins))
    want = vjp((jnp.asarray(dy), jnp.asarray(dh)))
    got = ssm_scan_bwd_plain(*(_t(a) for a in ins), _t(dy), _t(dh))
    for name, g, w in zip(GRADS, got, want):
        assert g.dtype == torch.float32, name
        _close(g.numpy(), np.asarray(w), BWD_TOL, BWD_TOL, f"{N} {name}")


def test_ssm_scan_function_backward_cases():
    """SSMScan's backward on the CPU is ssm_scan_bwd_plain: bitwise, with
    both outputs used; with h_final alone (y's gradient None, taken as
    zero); with y alone (dh None equals a zero dh).  A scan of no step
    passes zero gradients."""
    ins, dy, dh = _draw(2, 9, 5, 8, seed=22)

    def grads(weights):
        ts = [_t(a).requires_grad_() for a in ins]
        y, h = SSMScan.apply(*ts)
        loss = sum((o * w).sum() for o, w in zip((y, h), weights)
                   if w is not None)
        return torch.autograd.grad(loss, ts)
    plain = [_t(a) for a in ins]
    zero_dy, zero_dh = np.zeros_like(dy), np.zeros_like(dh)
    for weights, (cy, ch) in (((_t(dy), _t(dh)), (dy, dh)),
                              ((None, _t(dh)), (zero_dy, dh)),
                              ((_t(dy), None), (dy, None))):
        want = ssm_scan_bwd_plain(*plain, _t(cy),
                                  None if ch is None else _t(ch))
        for name, g, w in zip(GRADS, grads(weights), want):
            assert torch.equal(g, w), name
    with_zero = ssm_scan_bwd_plain(*plain, _t(dy), _t(zero_dh))
    for g, w in zip(ssm_scan_bwd_plain(*plain, _t(dy)), with_zero):
        assert torch.equal(g, w)
    empty = [_t(a[:, :0]) if a.ndim == 3 else _t(a) for a in ins]
    got = ssm_scan_bwd_plain(*empty, _t(dy[:, :0]), _t(dh))
    assert [tuple(g.shape) for g in got] == [tuple(a.shape) for a in empty]
    assert not got[2].any()


@pytest.mark.parametrize("N", [8, 16])
def test_ssm_scan_function_gradcheck(N):
    """SSMScan's written-out backward against finite differences in f64
    (``fast_mode``: random directions), through y and h_final."""
    ins, _, _ = _draw(2, 5, 3, N, seed=23)
    ts = [_t(a).double().requires_grad_() for a in ins]
    assert torch.autograd.gradcheck(SSMScan.apply, ts, fast_mode=True)


def test_ssm_scan_refuses_the_in_place_mode_under_grad():
    """The decode step's in-place mode (h0, h_out, y_dtype) has no
    gradient: under grad with an input that requires it, ops.ssm_scan
    raises instead of dropping the gradient; under no_grad it runs."""
    ins, _, _ = _draw(2, 1, 4, 8, seed=24)
    u, dt, A, Bs, Cs = (_t(a) for a in ins)
    state = torch.zeros((2, 4, 8))
    u.requires_grad_()
    for kw in (dict(h0=state), dict(h0=state, h_out=state),
               dict(y_dtype=torch.bfloat16)):
        with pytest.raises(RuntimeError, match="in-place decode mode"):
            ops.ssm_scan(u, dt, A, Bs, Cs, **kw)
    with pytest.raises(RuntimeError, match="in-place decode mode"):
        SSMScan.apply(u, dt, A, Bs, Cs, state)
    with torch.no_grad():
        y, h = ops.ssm_scan(u, dt, A, Bs, Cs, h0=state, h_out=state,
                            y_dtype=torch.bfloat16)
    assert h is state and y.dtype == torch.bfloat16 and y.grad_fn is None


# -- three train() steps of the Mamba family ------------------------------------

def test_train_three_steps_vs_jax_mamba(tmp_path):
    """train() of the smoke falcon-mamba-7b in both packages for 3 steps
    from the same params (the port's Model.init(0), carried through
    weights.npz) on the same lm_batches, at train_moe's optimizer: the
    histories (loss, ce, aux, lr, grad_norm) within 1e-4 relative, the
    final params within 1e-4 of each leaf's scale.  The port's steps run
    the scan through SSMScan and its written-out backward."""
    arch = "falcon-mamba-7b"
    pcfg = get_smoke_config(arch)
    tree = _np_map(lambda t: t.numpy(), Model(pcfg, device="cpu").init(0))
    path = tmp_path / "weights.npz"
    jax_save(str(path), tree)
    jparams = _np_map(jnp.asarray, tree)
    seq, batch = 32, 4
    jdc = jax_data.DataConfig(vocab_size=pcfg.vocab_size, seq_len=seq,
                              batch_size=batch)
    jopt = jax_opt.OptimizerConfig(lr=2e-3, warmup_steps=30,
                                   total_steps=300)
    jparams, jhist = jax_train_loop.train(
        JaxModel(jax_smoke_config(arch)), jax_data.lm_batches(jdc), 3,
        opt_cfg=jopt, log_every=1, params=jparams)
    pdc = pt_data.DataConfig(vocab_size=pcfg.vocab_size, seq_len=seq,
                             batch_size=batch)
    popt = pt_opt.OptimizerConfig(lr=2e-3, warmup_steps=30, total_steps=300)
    pparams, phist = train(
        Model(pcfg, device="cpu"), pt_data.lm_batches(pdc), 3,
        opt_cfg=popt, log_every=1,
        params=load_params(str(path), dtype=torch.float32, device="cpu"))
    assert [h["step"] for h in phist] == [h["step"] for h in jhist] == [
        0, 1, 2]
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


def _np_map(fn, tree):
    return {k: _np_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}
