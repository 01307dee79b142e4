"""Mamba-1 selective SSM block (falcon-mamba).

Mirrors ``repro.models.mamba`` function for function.  Where the JAX
package runs the recurrence as a ``lax.scan`` over time, both the
full-sequence path and the one-token decode update run it through
``ops.ssm_scan`` (the CUDA kernel on the card, its plain version on the
CPU); decode starts the scan from the slot's state.  The causal
depthwise conv, softplus, the D skip and the ``silu(z)`` gate stay plain
PyTorch, as they are plain ``jnp`` there.

The paged serving cache holds a layer's state as a dict ``{"conv": (B,
d_conv, d_inner), "ssm": (B, d_inner, N)}``; :func:`mamba_decode` updates
it in place, the scan writing the new ``ssm`` state into it directly.
``A = -exp(A_log)`` is the caller's to keep (``Model`` computes it once per
weight load); without it both functions compute it from ``A_log``.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Sequence

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import dense_init, normal_init


class MambaState(NamedTuple):
    conv: torch.Tensor  # (B, d_conv, d_inner) rolling window of conv inputs
    ssm: torch.Tensor   # (B, d_inner, N)


def mamba_dims(cfg: ModelConfig):
    m = cfg.mamba
    d_inner = m.expand * cfg.d_model
    return d_inner, m.d_state, m.d_conv, m.resolved_dt_rank(cfg.d_model)


def mamba_init(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype,
               lead: Sequence[int] = ()) -> Dict[str, torch.Tensor]:
    """One mixer's parameters, stacked on ``lead`` (the layer axis)."""
    D = cfg.d_model
    d_inner, N, d_conv, dt_rank = mamba_dims(cfg)
    dev = gen.device

    def full(shape, value):
        return torch.full((*lead, *shape), value, dtype=dtype, device=dev)

    # S4D-real initialization for A
    A = torch.arange(1, N + 1, dtype=torch.float32, device=dev)
    A_log = torch.log(A).expand(*lead, d_inner, N).to(dtype).contiguous()
    return {
        "in_proj": dense_init(gen, D, 2 * d_inner, dtype, lead),
        "conv_w": normal_init(gen, (*lead, d_conv, d_inner), 0.1, dtype),
        "conv_b": full((d_inner,), 0.0),
        "x_proj": dense_init(gen, d_inner, dt_rank + 2 * N, dtype, lead),
        "dt_proj": dense_init(gen, dt_rank, d_inner, dtype, lead),
        "dt_bias": full((d_inner,), -4.6),   # softplus^-1(0.01)
        "A_log": A_log,
        "D_skip": full((d_inner,), 1.0),
        "out_proj": dense_init(gen, d_inner, D, dtype, lead),
    }


def mamba_init_state(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                     device, lead: Sequence[int] = ()
                     ) -> Dict[str, torch.Tensor]:
    d_inner, N, d_conv, _ = mamba_dims(cfg)
    return {"conv": torch.zeros((*lead, batch, d_conv, d_inner), dtype=dtype,
                                device=device),
            "ssm": torch.zeros((*lead, batch, d_inner, N), dtype=dtype,
                               device=device)}


def ssm_A(A_log):
    """The scan's A = -exp(A_log) in f32, (..., d_inner, N)."""
    return -torch.exp(A_log.float())


def _ssm_coeffs(p, cfg: ModelConfig, u):
    """Shared input-dependent SSM coefficients.  u: (..., d_inner)."""
    _, N, _, dt_rank = mamba_dims(cfg)
    proj = u @ p["x_proj"]
    dt_raw = proj[..., :dt_rank]
    B_ssm = proj[..., dt_rank:dt_rank + N].contiguous()
    C_ssm = proj[..., dt_rank + N:].contiguous()
    dt = F.softplus(dt_raw @ p["dt_proj"] + p["dt_bias"])   # (..., d_inner)
    return dt, B_ssm, C_ssm


def mamba_forward(p, cfg: ModelConfig, x, *, return_state: bool = False,
                  A=None):
    """Full-sequence mamba.  x: (B, S, D) -> (B, S, D) [, MambaState].
    ``A``: :func:`ssm_A` of ``p["A_log"]``, computed here when None."""
    B, S, D = x.shape
    d_inner, N, d_conv, _ = mamba_dims(cfg)

    xz = x @ p["in_proj"]
    raw, z = xz.split(d_inner, dim=-1)                      # (B, S, d_inner)

    # causal depthwise conv over time
    u_pad = F.pad(raw, (0, 0, d_conv - 1, 0))
    conv = sum(u_pad[:, i:i + S, :] * p["conv_w"][i]
               for i in range(d_conv)) + p["conv_b"]
    u = F.silu(conv)

    dt, B_ssm, C_ssm = _ssm_coeffs(p, cfg, u)
    A = ssm_A(p["A_log"]) if A is None else A
    ys, h_final = ops.ssm_scan(u, dt, A, B_ssm, C_ssm)
    y = ys.to(u.dtype) + u * p["D_skip"]
    y = y * F.silu(z)
    out = y @ p["out_proj"]
    if return_state:
        # conv state = last d_conv raw (pre-conv) inputs
        if S >= d_conv:
            conv_state = raw[:, -d_conv:, :]
        else:
            conv_state = F.pad(raw, (0, 0, d_conv - S, 0))
        return out, MambaState(conv_state.to(x.dtype).contiguous(),
                               h_final.to(x.dtype))
    return out


def mamba_decode(p, cfg: ModelConfig, x, state: Dict[str, torch.Tensor],
                 A=None):
    """Single-token decode.  x: (B, D) -> (B, D); ``state``'s ``conv`` and
    ``ssm`` leaves are updated in place (the scan writes ``ssm`` in its own
    type and returns y in x's).  ``A`` as in :func:`mamba_forward`."""
    d_inner, _, _, _ = mamba_dims(cfg)
    xz = x @ p["in_proj"]
    u_raw, z = xz.split(d_inner, dim=-1)                    # (B, d_inner)

    conv_buf = torch.cat([state["conv"][:, 1:, :],
                          u_raw[:, None, :].to(state["conv"].dtype)],
                         dim=1)                             # (B, d_conv, di)
    conv = (conv_buf.float() * p["conv_w"].float()).sum(dim=1) + p["conv_b"]
    u = F.silu(conv).to(x.dtype)

    dt, B_ssm, C_ssm = _ssm_coeffs(p, cfg, u)
    A = ssm_A(p["A_log"]) if A is None else A
    y, _ = ops.ssm_scan(u[:, None], dt[:, None], A, B_ssm[:, None],
                        C_ssm[:, None], h0=state["ssm"], h_out=state["ssm"],
                        y_dtype=x.dtype)
    y = (y[:, 0] + u * p["D_skip"]) * F.silu(z)
    state["conv"].copy_(conv_buf)
    return y @ p["out_proj"]
