"""Shared model primitives: norms, rotary embeddings, init helpers.

Mirrors ``repro.models.layers`` function for function; the init helpers
draw from an explicit ``torch.Generator`` (its numbers differ from
``jax.random``'s, so cross-package tests carry weights across through a
checkpoint instead of re-drawing them).
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig

# Vocab is padded to a multiple of this (Megatron-style vocab padding;
# padding rows are never routed to).
VOCAB_PAD_MULTIPLE = 2048


def padded_vocab_size(cfg: ModelConfig) -> int:
    m = VOCAB_PAD_MULTIPLE
    return ((cfg.vocab_size + m - 1) // m) * m


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5
             ) -> torch.Tensor:
    dtype = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dtype) * w


def rope_sincos(positions: torch.Tensor, dim: int, theta: float):
    """sin/cos tables for integer positions: (...,) -> (..., dim/2) f32."""
    assert dim % 2 == 0, dim
    exponent = torch.arange(0, dim, 2, dtype=torch.float32,
                            device=positions.device) / dim
    # the base is filled on the device: a tensor made from host data
    # would be copied there, and that copy waits on the stream
    inv_freq = 1.0 / torch.pow(torch.full((), theta, dtype=torch.float32,
                                          device=positions.device),
                               exponent)
    angles = positions.float()[..., None] * inv_freq
    return torch.sin(angles), torch.cos(angles)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor
               ) -> torch.Tensor:
    """Rotate pairs. x: (..., dim); sin/cos broadcastable to (..., dim/2)."""
    x1, x2 = torch.chunk(x, 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def activation_fn(name: str):
    if name == "swiglu":
        # the gate nonlinearity; the caller applies the two projections
        return F.silu
    if name == "relu2":
        return lambda x: torch.square(F.relu(x))
    raise ValueError(name)


def normal_init(gen: torch.Generator, shape: Sequence[int], scale: float,
                dtype: torch.dtype) -> torch.Tensor:
    """``scale * N(0, 1)`` drawn in f32 on the generator's device, then
    cast — the same recipe as the JAX initializers.  Scaled in place, so
    the f32 draw is the only temporary (one deepseek-v3 bank leaf is 15
    GB in f32)."""
    x = torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                    device=gen.device)
    return x.mul_(scale).to(dtype)


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int,
               dtype: torch.dtype, lead: Sequence[int] = ()) -> torch.Tensor:
    """(*lead, in_dim, out_dim) projection(s) scaled by 1/sqrt(in_dim)."""
    return normal_init(gen, (*lead, in_dim, out_dim),
                       1.0 / math.sqrt(in_dim), dtype)


def embed_init(gen: torch.Generator, vocab: int, dim: int,
               dtype: torch.dtype) -> torch.Tensor:
    return normal_init(gen, (vocab, dim), 0.02, dtype)


def take_layer(stacked, i: int):
    """Views of layer ``i`` of a stacked ``(L, ...)`` parameter dict."""
    if isinstance(stacked, dict):
        return {k: take_layer(v, i) for k, v in stacked.items()}
    return stacked[i]


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """Mean next-token cross entropy, in f32, over the positions where
    ``mask`` is 1.  logits: (B, S, Vpad), the padded vocab columns masked
    to -1e30; labels: (B, S) int; mask: (B, S) {0, 1}."""
    vpad = logits.shape[-1]
    logits = logits.float()
    if vpad > vocab_size:
        col = torch.arange(vpad, device=logits.device) < vocab_size
        logits = logits.masked_fill(~col, -1e30)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
