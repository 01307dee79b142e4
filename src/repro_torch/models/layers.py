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


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor, tp=None
                 ) -> torch.Tensor:
    """The embedding rows of ``tokens``; with ``tp``
    (``TensorParallel``) ``table`` is the rank's rows of the vocabulary,
    looked up and summed over 'model' (vocab-parallel)."""
    if tp is None:
        return table[tokens.long()]
    return tp.embed(table, tokens)


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


class _VocabLogSumExp(torch.autograd.Function):
    """logsumexp over a row whose columns are split over 'model' (each
    rank's ``x`` its block): the row's largest value all-reduced with MAX
    (a shift that the result does not depend on, so no gradient), the sum
    of exp all-reduced; the same operations as ``torch.logsumexp`` on one
    rank.  Every rank's result depends on every rank's block, so the
    backward sums the ranks' incoming gradients before ``g e^(x -
    logz)``, ``torch.logsumexp``'s own backward."""

    @staticmethod
    def forward(ctx, x, tp):
        m = tp.all_reduce_max(x.amax(dim=-1))
        m.masked_fill_(m.abs() == math.inf, 0)
        s = tp.all_reduce(torch.exp(x - m[..., None]).sum(dim=-1))
        logz = s.log_().add_(m)
        ctx.tp = tp
        ctx.save_for_backward(x, logz)
        return logz

    @staticmethod
    def backward(ctx, g):
        x, logz = ctx.saved_tensors
        g = ctx.tp.all_reduce(g)
        return g[..., None] * torch.exp(x - logz[..., None]), None


def vocab_parallel_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                                 mask: torch.Tensor, vocab_size: int, tp
                                 ) -> torch.Tensor:
    """:func:`cross_entropy_loss` of the global batch where ``logits``
    (B, S, Vpad / m) are this rank's columns of the padded vocabulary (a
    'model' block of ``tp``, a ``TensorParallel``) and its rows one share
    of the batch (``tp.place``).  The padded columns (>= ``vocab_size``)
    are masked to -1e30 on whichever rank holds them; the log-sum-exp is
    :class:`_VocabLogSumExp`; the gold logit comes from the rank whose
    block holds the label (a masked pick, summed over 'model'); the
    masked sum and the mask's count are summed over the batch's DP axes
    (``tp.sum_batch``), so every rank returns the loss of the whole
    batch."""
    n = logits.shape[-1]
    lo = tp.rank * n
    logits = logits.float()
    if lo + n > vocab_size:
        col = torch.arange(lo, lo + n, device=logits.device) < vocab_size
        logits = logits.masked_fill(~col, -1e30)
    logz = _VocabLogSumExp.apply(logits, tp)
    local = labels.long() - lo
    ok = (local >= 0) & (local < n)
    pick = torch.gather(logits, -1, local.clamp(0, n - 1)[..., None])[..., 0]
    gold = tp.all_reduce(torch.where(ok, pick, pick.new_zeros(())))
    nll = logz - gold
    mask = mask.float()
    total = tp.sum_batch((nll * mask).sum())
    return total / torch.clamp(tp.sum_batch(mask.sum()), min=1.0)
