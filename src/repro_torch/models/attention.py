"""GQA and MLA attention: whole-prompt (prefill) and against the paged
KV pools (decode and chunk steps).

The port's counterpart of ``repro.models.attention``'s serving functions:
the chunked flash attention of a whole-prompt prefill
(``flash_attention``, ``gqa_forward``, ``gqa_forward_with_kv``), the GQA
paged helpers (``gqa_init``, ``gqa_paged_pools``, ``window_starts``,
``gqa_decode_qkv``, ``gqa_write_token``, ``gqa_decode_paged``) and
multi-head latent attention (``mla_init``, ``mla_forward``,
``mla_forward_with_cache``, ``mla_paged_pools``, ``mla_decode_q_token``,
``mla_write_token``, ``mla_post_matrix``, ``mla_decode_paged``).  Where
JAX returns updated pools, the port writes the incoming token's K/V (or
latent row) into the pools in place (JAX donates the pool buffers into
the compiled step for the same effect).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import (apply_rope, dense_init, rms_norm,
                                       rope_sincos)


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


# -- MLA (multi-head latent attention, DeepSeek style) ----------------------

def mla_init(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype,
             lead: Sequence[int] = ()) -> Dict[str, torch.Tensor]:
    """The leaves of ``repro``'s ``mla_init``, with its names and layouts:
    ``wuk`` (*lead, H, dn, R) and ``wuv`` (*lead, H, R, dv)."""
    m = cfg.mla
    D, H = cfg.d_model, cfg.num_heads
    dn, dr, dv = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
    R = m.kv_lora_rank
    n = len(lead)
    ones = dict(dtype=dtype, device=gen.device)
    wuk = dense_init(gen, R, H * dn, dtype, lead).reshape(*lead, R, H, dn)
    wuv = dense_init(gen, R, H * dv, dtype, lead).reshape(*lead, R, H, dv)
    return {
        "wdq": dense_init(gen, D, m.q_lora_rank, dtype, lead),
        "q_norm": torch.ones((*lead, m.q_lora_rank), **ones),
        "wuq": dense_init(gen, m.q_lora_rank, H * (dn + dr), dtype, lead),
        "wdkv": dense_init(gen, D, R, dtype, lead),
        "kv_norm": torch.ones((*lead, R), **ones),
        "wkr": dense_init(gen, D, dr, dtype, lead),
        "wuk": wuk.permute(*range(n), n + 1, n + 2, n).contiguous(),
        "wuv": wuv.permute(*range(n), n + 1, n, n + 2).contiguous(),
        "wo": dense_init(gen, H * dv, D, dtype, lead),
    }


def _mla_qkr(p, cfg: ModelConfig, x, positions):
    """The shared query / latent / rope-key projections.  x: (B, S, D) or
    (B, D); positions broadcast against x's leading axes."""
    m = cfg.mla
    H = cfg.num_heads
    dn, dr = m.qk_nope_head_dim, m.qk_rope_head_dim
    q_lat = rms_norm(x @ p["wdq"], p["q_norm"], cfg.norm_eps)
    q_all = (q_lat @ p["wuq"]).reshape(*x.shape[:-1], H, dn + dr)
    q_nope, q_rope = q_all[..., :dn], q_all[..., dn:]
    c_kv = rms_norm(x @ p["wdkv"], p["kv_norm"], cfg.norm_eps)
    k_rope = x @ p["wkr"]                 # (..., dr), shared by the heads
    sin, cos = rope_sincos(positions, dr, cfg.rope_theta)
    return q_nope, q_rope, c_kv, k_rope, sin, cos


def mla_forward(p, cfg: ModelConfig, x, positions, *, causal=True,
                window=0, return_cache=False):
    """Full-sequence MLA: the latent expanded to per-head K and V, then
    flash attention (on the card one ``flash_prefill`` launch with QK
    width dn + dr and V width dv).  With ``return_cache`` also returns
    the latent ``c_kv`` (B, S, R) and the roped ``k_rope`` (B, S, dr)."""
    B, S, _ = x.shape
    m = cfg.mla
    H = cfg.num_heads
    dr, dv = m.qk_rope_head_dim, m.v_head_dim
    q_nope, q_rope, c_kv, k_rope, sin, cos = _mla_qkr(p, cfg, x, positions)
    q_rope = apply_rope(q_rope, sin[None, :, None, :], cos[None, :, None, :])
    k_rope = apply_rope(k_rope, sin[None], cos[None])
    k_nope = torch.einsum("bsr,hdr->bshd", c_kv, p["wuk"])
    v = torch.einsum("bsr,hrv->bshv", c_kv, p["wuv"]).contiguous()
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, H, dr)],
                  dim=-1)
    out = flash_attention(q, k, v, positions, positions, causal=causal,
                          window=window)
    y = out.reshape(B, S, H * dv) @ p["wo"]
    if return_cache:
        return y, (c_kv, k_rope)
    return y


def mla_forward_with_cache(p, cfg: ModelConfig, x, positions):
    """Prefill variant: returns (y, (c_kv, k_rope)) for the latent pool."""
    return mla_forward(p, cfg, x, positions, causal=True,
                       window=cfg.sliding_window, return_cache=True)


def mla_paged_pools(cfg: ModelConfig, num_blocks: int, block_size: int,
                    dtype: torch.dtype, device, lead: Sequence[int] = ()):
    """One fused latent pool a layer: (*lead, nb, bs, 1, R + dr), each
    row ``concat([c_kv, k_rope])``.  Decode attends in the latent space
    with Hkv = 1, so K and V are this one pool."""
    m = cfg.mla
    shape = (*lead, num_blocks, block_size, 1,
             m.kv_lora_rank + m.qk_rope_head_dim)
    return {"ckr": torch.zeros(shape, dtype=dtype, device=device)}


def mla_decode_q_token(p, cfg: ModelConfig, x, page):
    """The absorbed latent query (B, H, R + dr) and the incoming token's
    fused pool row (B, R + dr) at position ``seq_lens - 1``.  The query
    is pre-scaled by sqrt(R + dr) / sqrt(dn + dr), so that the paged
    attention's 1 / sqrt(R + dr) gives MLA's 1 / sqrt(dn + dr)."""
    m = cfg.mla
    dn, dr = m.qk_nope_head_dim, m.qk_rope_head_dim
    R = m.kv_lora_rank
    pos = page["seq_lens"] - 1
    q_nope, q_rope, c_kv, k_rope, sin, cos = _mla_qkr(p, cfg, x, pos)
    q_rope = apply_rope(q_rope, sin[:, None, :], cos[:, None, :])
    k_rope = apply_rope(k_rope, sin, cos)
    q_lat = torch.einsum("bhd,hdr->bhr", q_nope, p["wuk"])
    token = torch.cat([c_kv, k_rope], dim=-1)
    q_eff = torch.cat([q_lat, q_rope], dim=-1) * (
        math.sqrt(R + dr) / math.sqrt(dn + dr))
    return q_eff, token


def mla_write_token(pools, page, token) -> None:
    """Write each row's fused latent row into its (block, offset) pool
    row, in place (idle rows hit the trash block)."""
    bid, off = page["write_bid"].long(), page["write_off"].long()
    pools["ckr"][bid, off, 0] = token.to(pools["ckr"].dtype)


def mla_post_matrix(p, cfg: ModelConfig):
    """The absorbed readout (H * (R + dr), D): ``wuv`` folded into ``wo``
    per head, with zero rows for the rope columns, so that one ``o @
    w_post`` equals the composed path's slice, ``wuv`` and ``wo``.  In
    the parameters' type, as the JAX package's einsum.  The model caches
    it per weight version (``Model.mla_post``)."""
    m = cfg.mla
    H = cfg.num_heads
    dr, dv = m.qk_rope_head_dim, m.v_head_dim
    D = p["wo"].shape[1]
    wov = torch.einsum("hrv,hvd->hrd", p["wuv"], p["wo"].reshape(H, dv, D))
    return torch.cat([wov, wov.new_zeros((H, dr, D))], dim=1).reshape(-1, D)


def mla_decode_paged(p, cfg: ModelConfig, x, pools, page):
    """Absorbed-matmul MLA decode over the fused latent pool, updated in
    place.  Scores are q_lat . c_kv + q_rope . k_rope, one paged-attention
    call with K = V = the pool; the readout keeps the first R columns.
    x: (B, D).  Returns (B, D)."""
    B, _ = x.shape
    m = cfg.mla
    R = m.kv_lora_rank
    q_eff, token = mla_decode_q_token(p, cfg, x, page)
    mla_write_token(pools, page, token)
    pool = pools["ckr"]
    out = ops.paged_attention(q_eff.to(pool.dtype), pool, pool,
                              page["tables"], page["seq_lens"],
                              window_starts(cfg, page["seq_lens"]))
    o = torch.einsum("bhr,hrv->bhv", out[..., :R].to(x.dtype), p["wuv"])
    return o.reshape(B, -1) @ p["wo"]
