"""The decode step's in-place scan and the model's scan rates, on the CPU.

``ssm_scan_plain``'s in-place mode (``h_out``, ``y_dtype``) against
today's scan followed by ``copy_`` into the state and a cast of y, bit for
bit; ``mamba_decode`` keeping its state tensors where they lie while still
matching ``repro``; and ``Model.ssm_rates``, A = -exp(A_log) computed once
per weight load and again after a reload or an in-place edit.  Inputs come
from ``np.random.default_rng``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import mamba as jax_mamba
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import ops
from repro_torch.kernels.ssm_scan import ssm_scan_cuda, ssm_scan_plain
from repro_torch.models import mamba as pt_mamba
from repro_torch.models.model import Model
from repro_torch.training import checkpoint as ckpt
from test_torch_cases import ssm_inputs, t as _t
from test_torch_cases import one_torch_thread  # noqa: F401

ARCH = "falcon-mamba-7b"
BLOCK_TOL = 1e-4                 # tests/test_torch_mamba.py
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _scan_args(S, in_dtype, state_dtype):
    u, dt, A, Bs, Cs, h0 = ssm_inputs(3, S, 40, 16, True, seed=S)
    u, dt, Bs, Cs = (_t(a).to(in_dtype) for a in (u, dt, Bs, Cs))
    return u, dt, _t(A), Bs, Cs, _t(h0).to(state_dtype)


@pytest.mark.parametrize("S", [1, 6], ids=["decode", "S6"])
@pytest.mark.parametrize("state", list(DTYPES))
@pytest.mark.parametrize("inputs", list(DTYPES))
def test_ssm_scan_plain_in_place_equals_scan_copy_cast(inputs, state, S):
    """The in-place mode gives bitwise the state and y of the default scan
    followed by ``state.copy_(h)`` and ``y.to(T)``, into the state tensor
    itself (which is also h0)."""
    T = DTYPES[inputs]
    u, dt, A, Bs, Cs, h0 = _scan_args(S, T, DTYPES[state])
    want_state = h0.clone()
    y, h = ssm_scan_plain(u, dt, A, Bs, Cs, want_state)
    want_state.copy_(h)
    want_y = y.to(T)

    st = h0.clone()
    ptr = st.data_ptr()
    got_y, got_h = ssm_scan_plain(u, dt, A, Bs, Cs, st, h_out=st, y_dtype=T)
    assert got_h is st and st.data_ptr() == ptr
    assert got_y.dtype == T and st.dtype == DTYPES[state]
    assert torch.equal(st, want_state)
    assert torch.equal(got_y, want_y)


def test_ops_ssm_scan_in_place_dispatch():
    """On CPU tensors ``ops.ssm_scan`` passes the in-place mode to the plain
    version; the CUDA launcher refuses CPU tensors in either mode."""
    u, dt, A, Bs, Cs, h0 = _scan_args(1, torch.bfloat16, torch.bfloat16)
    a, b = h0.clone(), h0.clone()
    ya, _ = ops.ssm_scan(u, dt, A, Bs, Cs, a, h_out=a, y_dtype=u.dtype)
    yb, _ = ssm_scan_plain(u, dt, A, Bs, Cs, b, h_out=b, y_dtype=u.dtype)
    assert torch.equal(a, b) and torch.equal(ya, yb)
    with pytest.raises(ValueError, match="CUDA"):
        ssm_scan_cuda(u, dt, A, Bs, Cs, a, h_out=a, y_dtype=u.dtype)


def test_eager_scan_calls_the_functions_not_the_custom_op(monkeypatch):
    """Eager, ``ops.ssm_scan`` (forward, in-place mode, and under grad its
    backward through ``SSMScan``) calls the plain versions directly, so a
    decode step pays no custom op's dispatch; under a dispatch mode (the
    dry run's ``FakeTensorMode``) it takes the op."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.kernels import ssm_scan as S

    def refuse(*args, **kwargs):
        raise AssertionError("the custom op ran eagerly")

    monkeypatch.setattr(S, "ssm_scan_op", refuse)
    monkeypatch.setattr(S, "ssm_scan_bwd_op", refuse)
    u, dt, A, Bs, Cs, h0 = _scan_args(6, torch.float32, torch.float32)
    y, h = ops.ssm_scan(u, dt, A, Bs, Cs)
    want_y, want_h = ssm_scan_plain(u, dt, A, Bs, Cs)
    assert torch.equal(y, want_y) and torch.equal(h, want_h)
    st = h0.clone()
    ops.ssm_scan(u, dt, A, Bs, Cs, st, h_out=st)
    leaves = [t.clone().requires_grad_() for t in (u, dt, A, Bs, Cs)]
    y, _ = ops.ssm_scan(*leaves)
    y.sum().backward()
    assert all(t.grad is not None for t in leaves)
    with FakeTensorMode() as mode:
        fake = [mode.from_tensor(t) for t in (u, dt, A, Bs, Cs)]
        with pytest.raises(AssertionError, match="custom op"):
            ops.ssm_scan(*fake)


@pytest.fixture(scope="module")
def mixer():
    cfg = jax_smoke_config(ARCH)
    jp = jax_mamba.mamba_init(jax.random.PRNGKey(5), cfg)
    return cfg, jp, {k: _t(np.asarray(v)) for k, v in jp.items()}


@pytest.mark.parametrize("given_A", [False, True], ids=["A_log", "A"])
def test_mamba_decode_keeps_state_in_place(mixer, given_A):
    """Three decode steps from a non-zero state: the ``conv`` and ``ssm``
    leaves keep their storage, and outputs and state match ``repro``'s
    ``mamba_decode`` as before; passing A precomputed changes nothing."""
    cfg, jp, pp = mixer
    pcfg = get_smoke_config(ARCH)
    d_inner, N, d_conv, _ = pt_mamba.mamba_dims(pcfg)
    rng = np.random.default_rng(3)
    conv0 = rng.normal(size=(3, d_conv, d_inner)).astype(np.float32)
    ssm0 = (rng.normal(size=(3, d_inner, N)) * 0.3).astype(np.float32)
    jstate = jax_mamba.MambaState(jnp.asarray(conv0), jnp.asarray(ssm0))
    pstate = {"conv": _t(conv0), "ssm": _t(ssm0)}
    ptrs = {k: v.data_ptr() for k, v in pstate.items()}
    A = pt_mamba.ssm_A(pp["A_log"]) if given_A else None
    for step in range(3):
        x = rng.normal(size=(3, cfg.d_model)).astype(np.float32)
        want, jstate = jax_mamba.mamba_decode(jp, cfg, jnp.asarray(x),
                                              jstate)
        got = pt_mamba.mamba_decode(pp, pcfg, _t(x), pstate, A=A)
        assert {k: v.data_ptr() for k, v in pstate.items()} == ptrs
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=BLOCK_TOL, rtol=BLOCK_TOL)
        for key in ("conv", "ssm"):
            np.testing.assert_allclose(pstate[key].numpy(),
                                       np.asarray(getattr(jstate, key)),
                                       atol=BLOCK_TOL, rtol=BLOCK_TOL)


def _decode(model, params, seed=0):
    """One paged decode step of 2 slots from a seeded state."""
    cache = model.init_paged_cache(2, 8, 4)
    gen = torch.Generator().manual_seed(seed)
    for leaf in cache["layers"].values():
        leaf.normal_(generator=gen)
    page = {k: torch.zeros((2,) + s, dtype=torch.int32)
            for k, s in (("tables", (2,)), ("seq_lens", ()),
                         ("write_bid", ()), ("write_off", ()))}
    logits, _ = model.decode_step_paged(params, cache, torch.tensor([3, 5]),
                                        page)
    return logits, cache["layers"]["ssm"]


@pytest.mark.parametrize("reload", ["checkpoint", "in_place"])
def test_ssm_rates_once_per_load(tmp_path, reload):
    """``Model.ssm_rates`` is -exp(A_log) bit for bit, computed once and
    reused by every call on the same weights; a reload (new tensors from
    the checkpoint) or an in-place edit of A_log recomputes it, and the
    decode step then equals a fresh model's on the new weights."""
    model = Model(get_smoke_config(ARCH), device="cpu")
    params = model.init(0)
    A = model.ssm_rates(params, "layers")
    assert torch.equal(A, -torch.exp(params["layers"]["mixer"]["A_log"]
                                     .float()))
    _decode(model, params)
    model.prefill_paged(params, {"tokens": torch.tensor([[1, 2, 3]])})
    assert model.ssm_rates(params, "layers") is A   # not recomputed

    if reload == "checkpoint":
        path = str(tmp_path / "weights.npz")
        params["layers"]["mixer"]["A_log"] = \
            params["layers"]["mixer"]["A_log"] * 0.5
        ckpt.save_checkpoint(path, params)
        params = ckpt.load_params(path, dtype=torch.float32, device="cpu")
    else:
        params["layers"]["mixer"]["A_log"].mul_(0.5)
    A2 = model.ssm_rates(params, "layers")
    assert A2 is not A
    assert torch.equal(A2, -torch.exp(params["layers"]["mixer"]["A_log"]
                                      .float()))
    assert not torch.equal(A2, A)
    got = _decode(model, params)
    want = _decode(Model(get_smoke_config(ARCH), device="cpu"), params)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
