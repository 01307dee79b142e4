"""The port's model primitives against ``repro.models.layers``.

Inputs come from one numpy generator and go to both packages; the JAX
side runs on the CPU, the port's on the CPU as well.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import ffn as jax_ffn
from repro.models import layers as jax_layers
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import ffn as pt_ffn
from repro_torch.models import layers as pt_layers
from test_torch_cases import one_torch_thread  # noqa: F401

RTOL, ATOL = 1e-5, 1e-6


def _np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("name", ["qwen2-moe-a2.7b", "deepseek-v3"])
@pytest.mark.parametrize("smoke", [False, True])
def test_configs_and_padded_vocab(name, smoke):
    """The copied configs equal the JAX package's field for field."""
    from repro.configs import get_config as jax_get_config
    pt = get_smoke_config(name) if smoke else get_config(name)
    jx = jax_smoke_config(name) if smoke else jax_get_config(name)
    assert dataclasses.asdict(pt) == dataclasses.asdict(jx)
    assert pt_layers.padded_vocab_size(pt) == \
        jax_layers.padded_vocab_size(jx)


@pytest.mark.parametrize("shape", [(3, 64), (2, 5, 256)])
@pytest.mark.parametrize("eps", [1e-5, 1e-6])
def test_rms_norm(shape, eps):
    rng = np.random.default_rng(1)
    x = rng.normal(size=shape).astype(np.float32)
    w = rng.normal(size=shape[-1:]).astype(np.float32)
    want = jax_layers.rms_norm(jnp.asarray(x), jnp.asarray(w), eps)
    got = pt_layers.rms_norm(torch.from_numpy(x), torch.from_numpy(w), eps)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("dim,theta", [(64, 10000.0), (128, 1e6),
                                       (16, 500.0)])
def test_rope_sincos_and_apply(dim, theta):
    rng = np.random.default_rng(2)
    pos = rng.integers(0, 4096, size=(5,)).astype(np.int32)
    x = rng.normal(size=(5, 3, dim)).astype(np.float32)
    s_j, c_j = jax_layers.rope_sincos(jnp.asarray(pos), dim, theta)
    s_t, c_t = pt_layers.rope_sincos(torch.from_numpy(pos), dim, theta)
    # f32 angles up to ~4096 rad: a 1-ulp difference in the frequency
    # moves sin/cos by ~4e-4 * 2^-23 * 4096; 2e-4 covers it
    np.testing.assert_allclose(_np(s_t), np.asarray(s_j), atol=2e-4)
    np.testing.assert_allclose(_np(c_t), np.asarray(c_j), atol=2e-4)
    # apply_rope on shared sin/cos tables: exact arithmetic either side
    want = jax_layers.apply_rope(jnp.asarray(x), s_j[:, None, :],
                                 c_j[:, None, :])
    got = pt_layers.apply_rope(torch.from_numpy(x),
                               torch.from_numpy(np.array(s_j))[:, None, :],
                               torch.from_numpy(np.array(c_j))[:, None, :])
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("name", ["swiglu", "relu2"])
def test_activation_fn(name):
    x = np.random.default_rng(3).normal(size=(4, 33)).astype(np.float32)
    want = jax_layers.activation_fn(name)(jnp.asarray(x))
    got = pt_layers.activation_fn(name)(torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_activation_fn_unknown():
    with pytest.raises(ValueError):
        pt_layers.activation_fn("gelu")


@pytest.mark.parametrize("activation", ["swiglu", "relu2"])
def test_ffn_apply(activation):
    rng = np.random.default_rng(4)
    D, Fd = 32, 48
    x = rng.normal(size=(6, D)).astype(np.float32)
    p = {k: (rng.normal(size=shape) * 0.1).astype(np.float32)
         for k, shape in (("w_gate", (D, Fd)), ("w_up", (D, Fd)),
                          ("w_down", (Fd, D)))}
    if activation == "relu2":
        del p["w_gate"]
    want = jax_ffn.ffn_apply({k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(x), activation)
    got = pt_ffn.ffn_apply({k: torch.from_numpy(v) for k, v in p.items()},
                           torch.from_numpy(x), activation)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_init_helpers_shapes_and_scale():
    gen = torch.Generator().manual_seed(0)
    w = pt_layers.dense_init(gen, 256, 64, torch.float32, (3,))
    assert w.shape == (3, 256, 64)
    assert abs(float(w.std()) - 1 / 16) < 5e-3
    e = pt_layers.embed_init(gen, 100, 8, torch.bfloat16)
    assert e.dtype == torch.bfloat16 and e.shape == (100, 8)
    p = pt_ffn.ffn_init(gen, 16, 24, "swiglu", torch.float32, (2,))
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        "w_gate": (2, 16, 24), "w_up": (2, 16, 24), "w_down": (2, 24, 16)}
    same = pt_layers.dense_init(torch.Generator().manual_seed(0), 256, 64,
                                torch.float32, (3,))
    assert torch.equal(w, same)
