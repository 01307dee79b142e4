"""GQA attention against the paged KV pools (decode and chunk steps).

The port's counterpart of the paged helpers in ``repro.models.attention``
(``gqa_init``, ``gqa_paged_pools``, ``window_starts``, ``gqa_decode_qkv``,
``gqa_write_token``, ``gqa_decode_paged``).  Where JAX returns updated
pools, the port writes the incoming token's K/V into the pools in place
(JAX donates the pool buffers into the compiled step for the same effect).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, dense_init, rope_sincos


def gqa_init(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype,
             lead: Sequence[int] = ()) -> Dict[str, torch.Tensor]:
    D = cfg.d_model
    Dh = cfg.resolved_head_dim()
    return {
        "wq": dense_init(gen, D, cfg.num_heads * Dh, dtype, lead),
        "wk": dense_init(gen, D, cfg.num_kv_heads * Dh, dtype, lead),
        "wv": dense_init(gen, D, cfg.num_kv_heads * Dh, dtype, lead),
        "wo": dense_init(gen, cfg.num_heads * Dh, D, dtype, lead),
    }


def gqa_paged_pools(cfg: ModelConfig, num_blocks: int, block_size: int,
                    dtype: torch.dtype, device, lead: Sequence[int] = ()):
    """Paged K/V pools: (*lead, num_blocks, block_size, Hkv, Dh)."""
    shape = (*lead, num_blocks, block_size, cfg.num_kv_heads,
             cfg.resolved_head_dim())
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def window_starts(cfg: ModelConfig, seq_lens) -> Optional[torch.Tensor]:
    """Sliding-window lower bound per sequence (None = full attention)."""
    if not cfg.sliding_window:
        return None
    return torch.clamp_min(seq_lens - cfg.sliding_window, 0)


def gqa_decode_qkv(p, cfg: ModelConfig, x, page):
    """q/k/v projection with rope at ``seq_lens - 1``.  x: (B, D)."""
    B, _ = x.shape
    Dh = cfg.resolved_head_dim()
    H, Hkv = cfg.num_heads, cfg.num_kv_heads
    pos = page["seq_lens"] - 1
    q = (x @ p["wq"]).reshape(B, H, Dh)
    k = (x @ p["wk"]).reshape(B, Hkv, Dh)
    v = (x @ p["wv"]).reshape(B, Hkv, Dh)
    sin, cos = rope_sincos(pos, Dh, cfg.rope_theta)
    q = apply_rope(q, sin[:, None, :], cos[:, None, :])
    k = apply_rope(k, sin[:, None, :], cos[:, None, :])
    return q, k, v


def gqa_write_token(pools, page, k, v) -> None:
    """Write each row's incoming K/V into its (block, offset) pool row, in
    place (idle rows hit the trash block)."""
    bid, off = page["write_bid"].long(), page["write_off"].long()
    pools["k"][bid, off] = k.to(pools["k"].dtype)
    pools["v"][bid, off] = v.to(pools["v"].dtype)


def gqa_decode_paged(p, cfg: ModelConfig, x, pools, page):
    """One-token decode against one layer's paged pools.

    x: (B, D); pools: {"k", "v"} (nb, bs, Hkv, Dh), updated in place;
    page: ``tables`` (B, max_blk), ``seq_lens`` (B,) valid length
    including the incoming token, ``write_bid``/``write_off`` (B,) where
    position ``seq_lens - 1`` lands.  Returns the attention output (B, D).
    """
    B, _ = x.shape
    q, k, v = gqa_decode_qkv(p, cfg, x, page)
    gqa_write_token(pools, page, k, v)
    out = ops.paged_attention(q, pools["k"], pools["v"], page["tables"],
                              page["seq_lens"],
                              window_starts(cfg, page["seq_lens"]))
    return out.reshape(B, -1).to(x.dtype) @ p["wo"]
