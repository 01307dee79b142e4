"""GQA attention: whole-prompt (prefill) and against the paged KV pools
(decode and chunk steps).

The port's counterpart of ``repro.models.attention``'s GQA functions:
the chunked flash attention of a whole-prompt prefill
(``flash_attention``, ``gqa_forward``, ``gqa_forward_with_kv``) and the
paged helpers (``gqa_init``, ``gqa_paged_pools``, ``window_starts``,
``gqa_decode_qkv``, ``gqa_write_token``, ``gqa_decode_paged``).  Where
JAX returns updated pools, the port writes the incoming token's K/V into
the pools in place (JAX donates the pool buffers into the compiled step
for the same effect).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, dense_init, rope_sincos


NEG_INF = -1e30


# -- chunked flash attention (full sequence) --------------------------------

def _flash_one_q_chunk(qc, k, v, q_pos_c, kv_pos, *, causal, window,
                       kv_chunk, kv_chunks_limit, scale):
    """Online softmax over the first ``kv_chunks_limit`` kv chunks for one
    q chunk.  qc: (B, Qc, Hkv, G, Dh); k: (B, Skv, Hkv, Dh); v: (B, Skv,
    Hkv, Dv).  Scores and the running state are f32; p is cast to v's
    type before ``p @ v``, as in JAX."""
    B, Qc, Hkv, G, _ = qc.shape
    Dv = v.shape[-1]
    acc = torch.zeros((B, Qc, Hkv, G, Dv), dtype=torch.float32,
                      device=qc.device)
    m = torch.full((B, Qc, Hkv, G), NEG_INF, dtype=torch.float32,
                   device=qc.device)
    l = torch.zeros((B, Qc, Hkv, G), dtype=torch.float32, device=qc.device)
    for j in range(kv_chunks_limit):
        sl = slice(j * kv_chunk, (j + 1) * kv_chunk)
        kc, vc, pos_kv = k[:, sl], v[:, sl], kv_pos[sl]
        s = torch.einsum("bqkgd,bskd->bqkgs", qc.float(), kc.float()) * scale
        mask = torch.ones((Qc, kv_chunk), dtype=torch.bool, device=qc.device)
        if causal:
            mask &= q_pos_c[:, None] >= pos_kv[None, :]
        if window:
            mask &= (q_pos_c[:, None] - pos_kv[None, :]) < window
        s = s.masked_fill(~mask[None, :, None, None, :], NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bqkgs,bskv->bqkgv", p.to(vc.dtype).float(), vc.float())
        m = m_new
    out = acc / torch.clamp_min(l[..., None], 1e-30)
    return out.to(qc.dtype)


def flash_attention(q, k, v, q_pos, kv_pos, *, causal=True, window=0,
                    q_chunk=2048, kv_chunk=1024):
    """q: (B, Sq, H, Dh), k: (B, Skv, Hkv, Dh), v: (B, Skv, Hkv, Dv) ->
    (B, Sq, H, Dv); q_pos (Sq,) / kv_pos (Skv,) int32 absolute positions.

    On the card one ``ops.flash_prefill`` launch computes it.  On the CPU
    this is the plain twin of the JAX chunked online softmax: a Python
    loop over q chunks whose causal bound skips the kv chunks wholly in
    their future.
    """
    if not ops.on_cpu(q):
        return ops.flash_prefill(q, k, v, q_pos, kv_pos, causal=causal,
                                 window=window)
    B, Sq, H, Dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    assert H % Hkv == 0, (H, Hkv)
    G = H // Hkv
    scale = 1.0 / math.sqrt(Dh)
    q_chunk = min(q_chunk, Sq)
    while Sq % q_chunk:
        q_chunk //= 2
    kv_chunk = min(kv_chunk, Skv)
    while Skv % kv_chunk:
        kv_chunk //= 2
    nkv_total = Skv // kv_chunk
    qg = q.reshape(B, Sq, Hkv, G, Dh)
    outs = []
    for i in range(Sq // q_chunk):
        sl = slice(i * q_chunk, (i + 1) * q_chunk)
        limit = (max(min(nkv_total, (i + 1) * q_chunk // kv_chunk), 1)
                 if causal else nkv_total)
        outs.append(_flash_one_q_chunk(
            qg[:, sl], k, v, q_pos[sl], kv_pos, causal=causal,
            window=window, kv_chunk=kv_chunk, kv_chunks_limit=limit,
            scale=scale))
    return torch.cat(outs, dim=1).reshape(B, Sq, H, v.shape[-1])


# -- GQA ----------------------------------------------------------------------

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


def gqa_forward(p, cfg: ModelConfig, x, positions, *, causal=True,
                window=0, return_kv=False):
    """Full-sequence GQA self-attention with rope.  x: (B, S, D);
    positions (S,) int32.  With ``return_kv`` also returns the (B, S,
    Hkv, Dh) K (rope applied) and V."""
    B, S, _ = x.shape
    Dh = cfg.resolved_head_dim()
    H, Hkv = cfg.num_heads, cfg.num_kv_heads
    q = (x @ p["wq"]).reshape(B, S, H, Dh)
    k = (x @ p["wk"]).reshape(B, S, Hkv, Dh)
    v = (x @ p["wv"]).reshape(B, S, Hkv, Dh)
    sin, cos = rope_sincos(positions, Dh, cfg.rope_theta)
    q = apply_rope(q, sin[None, :, None, :], cos[None, :, None, :])
    k = apply_rope(k, sin[None, :, None, :], cos[None, :, None, :])
    out = flash_attention(q, k, v, positions, positions, causal=causal,
                          window=window)
    y = out.reshape(B, S, H * Dh) @ p["wo"]
    if return_kv:
        return y, (k, v)
    return y


def gqa_forward_with_kv(p, cfg: ModelConfig, x, positions):
    """Prefill variant: returns (y, (k, v)) with rope already applied to
    k, ready to be written into pool blocks."""
    return gqa_forward(p, cfg, x, positions, causal=True,
                       window=cfg.sliding_window, return_kv=True)


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
