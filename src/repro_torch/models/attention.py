"""GQA and MLA attention: whole-prompt (prefill), against the paged KV
pools (decode and chunk steps), and against per-row ring caches (the
ring serve step).

The port's counterpart of ``repro.models.attention``'s serving functions:
the chunked flash attention of a whole-prompt prefill
(``flash_attention``, ``gqa_forward`` with cross-attention's
``kv_input``, ``kv_positions`` and ``use_rope``, ``gqa_forward_with_kv``),
the GQA paged helpers (``gqa_init``, ``gqa_paged_pools``,
``window_starts``, ``gqa_decode_qkv``, ``gqa_write_token``,
``gqa_decode_paged``), the ring caches (``gqa_init_cache``,
``_ring_validity``, ``gqa_decode``, ``gqa_cross_decode``,
``mla_init_cache``, ``mla_decode``) and multi-head latent attention
(``mla_init``, ``mla_forward``, ``mla_forward_with_cache``,
``mla_paged_pools``, ``mla_decode_q_token``, ``mla_write_token``,
``mla_post_matrix``, ``mla_decode_paged``).  Where JAX returns updated
pools or rings, the port writes the incoming token's K/V (or latent row)
into them in place (JAX donates the buffers into the compiled step for
the same effect).

A ring cache is a dict like a pool's: GQA's ``{"k", "v"}`` of (B, W,
Hkv, Dh), MLA's one latent ring ``{"ckr"}`` of (B, W, 1, R + dr), each
row ``concat([c_kv, k_rope])`` as in the latent pool (``repro``'s
``GQACache`` and ``MLACache``; its ``MLACache.c_kv`` and ``.k_rope`` are
the ring's two column ranges).  W = min(window or max_seq, max_seq) and
position ``p`` lives in slot ``p % W``.  Decode attends through
``ops.paged_attention`` with the ring viewed as a pool of B blocks of W
rows (:func:`ring_page`), as cross-attention decode does over the
encoder's K/V.

With ``tp`` (``distributed.tensor_parallel.TensorParallel``) the
functions run on a rank's shards (``sharding.tp_shard``): head counts come
from the weights' shapes, the output projection is row-parallel (its
partials all-reduced over 'model' where the heads are split), and a ring
decode whose cache is split over its window (KV heads that do not divide
'model'; MLA's latent ring; the audio's cross K/V over frames) attends
every head's query over the rank's slots and merges the ranks' partials
by their log-sum-exp.  The new token's slot belongs to one rank, which
alone writes it.
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
                kv_input=None, kv_positions=None, window=0, use_rope=True,
                return_kv=False, tp=None):
    """Full-sequence GQA.  x: (B, S, D); positions (S,) int32.
    ``kv_input`` (B, F, D), with its ``kv_positions`` (F,), overrides the
    K/V source (cross-attention, which also passes ``use_rope=False``).
    With ``return_kv`` also returns the K (rope applied) and V, (B, S or
    F, Hkv, Dh).  With ``tp``: the rank's query heads (all where they do
    not divide 'model') against the KV heads they read, ``wo``
    row-parallel; the K and V returned are the rank's KV heads (all where
    they do not divide)."""
    B, S, _ = x.shape
    Dh = cfg.resolved_head_dim()
    H, Hkv = p["wq"].shape[-1] // Dh, p["wk"].shape[-1] // Dh
    src = x if kv_input is None else kv_input
    kv_pos = positions if kv_positions is None else kv_positions
    q = (x @ p["wq"]).reshape(B, S, H, Dh)
    k = (src @ p["wk"]).reshape(B, src.shape[1], Hkv, Dh)
    v = (src @ p["wv"]).reshape(B, src.shape[1], Hkv, Dh)
    if use_rope:
        sin_q, cos_q = rope_sincos(positions, Dh, cfg.rope_theta)
        sin_k, cos_k = rope_sincos(kv_pos, Dh, cfg.rope_theta)
        q = apply_rope(q, sin_q[None, :, None, :], cos_q[None, :, None, :])
        k = apply_rope(k, sin_k[None, :, None, :], cos_k[None, :, None, :])
    ka, va = k, v
    if tp is not None and tp.attn_tp and not tp.kv_tp:
        ka, va = _kv_of_heads(k, v, cfg.num_heads // cfg.num_kv_heads,
                              tp.q_heads(cfg.num_heads).start, H)
    out = flash_attention(q, ka, va, positions, kv_pos, causal=causal,
                          window=window)
    y = out.reshape(B, S, H * Dh) @ p["wo"]
    if tp is not None and tp.attn_tp:
        y = tp.all_reduce(y)
    if return_kv:
        return y, (k, v)
    return y


def _kv_of_heads(k, v, G: int, h0: int, n: int):
    """The K/V heads that query heads h0 .. h0 + n - 1 read (G query heads
    a KV head), (B, S, Hkv, Dh) -> a contiguous slice of KV heads where
    those queries group evenly over it, else one KV head a query head."""
    lo, hi = h0 // G, (h0 + n - 1) // G + 1
    per = n // (hi - lo)
    if per * (hi - lo) == n and all((h0 + i) // G - lo == i // per
                                    for i in range(n)):
        return k[:, :, lo:hi], v[:, :, lo:hi]
    idx = torch.tensor([(h0 + i) // G for i in range(n)], device=k.device)
    return k.index_select(2, idx), v.index_select(2, idx)


def gqa_forward_with_kv(p, cfg: ModelConfig, x, positions, tp=None):
    """Prefill variant: returns (y, (k, v)) with rope already applied to
    k, ready to be written into pool blocks."""
    return gqa_forward(p, cfg, x, positions, causal=True,
                       window=cfg.sliding_window, return_kv=True, tp=tp)


def gqa_init_cache(cfg: ModelConfig, batch: int, max_seq: int,
                   dtype: torch.dtype, device, lead: Sequence[int] = ()):
    """Empty ring K/V: (*lead, batch, W, Hkv, Dh), W = min(window or
    max_seq, max_seq)."""
    W = min(cfg.sliding_window or max_seq, max_seq)
    return gqa_paged_pools(cfg, batch, W, dtype, device, lead)


def _ring_validity(pos, W: int):
    """For each ring slot s, the absolute position it holds and whether
    that is a position >= 0, given each row's current position ``pos``
    (B,).  Once position ``pos`` is written, the valid slots are exactly
    ``[0, min(pos + 1, W))``: slot s holds ``pos - ((pos % W - s) % W)``,
    which is >= 0 for s <= pos while pos < W and for every s after."""
    s = torch.arange(W, device=pos.device)[None, :]
    slot_pos = pos[:, None] - (pos[:, None] % W - s) % W
    return slot_pos, slot_pos >= 0


def _row_blocks(B: int, device) -> torch.Tensor:
    """The identity block table (B, 1): row b's one block is block b."""
    return torch.arange(B, dtype=torch.int32, device=device)[:, None]


def ring_page(pos, W: int):
    """A ring of W slots a row as ``ops.paged_attention``'s pool of one
    block of W rows a row: the identity table (B, 1) and ``seq_lens =
    min(pos + 1, W)``, the valid prefix :func:`_ring_validity` gives.  A
    sliding window never masks more, since W <= window."""
    return (_row_blocks(pos.shape[0], pos.device),
            torch.clamp_max(pos + 1, W).to(torch.int32))


def _write_ring(ring, pos, row) -> None:
    """Write each row's new entry ``row`` (B, ...) into slot pos % W of
    its ring (B, W, ...), in place."""
    B, W = ring.shape[:2]
    ring[torch.arange(B, device=pos.device), (pos % W).long()] = \
        row.to(ring.dtype)


def _write_ring_slice(ring, pos, row, tp) -> None:
    """:func:`_write_ring` where ``ring`` (B, W/m, ...) is this rank's
    slice of a ring of W slots split over 'model': each row's slot pos %
    W is written by the rank that holds it; the others write back what
    their slot already held (no host sync, no branch on data)."""
    B, Wl = ring.shape[:2]
    slot = (pos % (Wl * tp.size)).long() - tp.rank * Wl
    mine = (slot >= 0) & (slot < Wl)
    rows = torch.arange(B, device=pos.device)
    slot = slot.clamp(0, Wl - 1)
    mask = mine.reshape((B,) + (1,) * (row.dim() - 1))
    ring[rows, slot] = torch.where(mask, row.to(ring.dtype),
                                   ring[rows, slot])


def _slice_lens(pos, Wl: int, tp):
    """The valid slots of each row in this rank's slice of a split ring:
    clamp(min(pos + 1, W) - r W/m, 0, W/m), as int32."""
    n = torch.clamp_max(pos + 1, Wl * tp.size) - tp.rank * Wl
    return n.clamp(0, Wl).to(torch.int32)


def _context_parallel(q, k_ring, v_ring, seq_lens, tp):
    """Every head's query (B, H, Dh) over this rank's slots, each row's
    first ``seq_lens`` of them, merged with the other ranks' by their
    log-sum-exp: the attention over the whole ring, (B, H, Dh) f32."""
    B, H = q.shape[:2]
    lse = torch.empty((B, H), dtype=torch.float32, device=q.device)
    o = ops.paged_attention(q, k_ring, v_ring, _row_blocks(B, q.device),
                            seq_lens, lse_out=lse)
    return tp.merge(o, lse)


def _all_heads(q, tp):
    """The query of every head: the ranks' heads gathered where the heads
    are split over 'model'."""
    return tp.gather(q, dim=1) if tp.attn_tp else q


def _own_heads(o, H: int, tp):
    """This rank's heads of (B, H, ...) (all where they do not divide)."""
    return o[:, tp.q_heads(H)]


def _out_proj(o, wo, x, tp):
    """(B, heads, Dv) -> (B, D) through ``wo``: row-parallel under ``tp``
    with the heads split."""
    y = o.reshape(o.shape[0], -1).to(x.dtype) @ wo
    if tp is not None and tp.attn_tp:
        y = tp.all_reduce(y)
    return y


def gqa_decode(p, cfg: ModelConfig, x, cache, pos, tp=None):
    """One-token decode against one layer's ring.  x: (B, D); pos (B,)
    int32, the position of x.  Writes the new K/V into slot pos % W of
    ``cache`` {"k", "v"} (B, W, Hkv, Dh) in place and attends over the
    valid slots through ``ops.paged_attention``.  Returns (B, D).  With
    ``tp``: head-parallel where KV heads divide 'model', else over this
    rank's W/m slots (context-parallel), merged."""
    B, _ = x.shape
    q, k, v = _gqa_qkv(p, cfg, x, pos)
    if tp is None or tp.kv_tp:
        _write_ring(cache["k"], pos, k)
        _write_ring(cache["v"], pos, v)
        tables, seq_lens = ring_page(pos, cache["k"].shape[1])
        out = ops.paged_attention(q, cache["k"], cache["v"], tables,
                                  seq_lens)
        return _out_proj(out, p["wo"], x, tp)
    _write_ring_slice(cache["k"], pos, k, tp)
    _write_ring_slice(cache["v"], pos, v, tp)
    seq_lens = _slice_lens(pos, cache["k"].shape[1], tp)
    o = _context_parallel(_all_heads(q, tp), cache["k"], cache["v"],
                          seq_lens, tp)
    return _out_proj(_own_heads(o, cfg.num_heads, tp), p["wo"], x, tp)


def gqa_cross_decode(p, cfg: ModelConfig, x, ck, cv, tp=None):
    """Cross-attention decode against the encoder's precomputed K/V, (B,
    F, Hkv, Dh), viewed as a pool of one block of F rows a row, every
    frame valid (``repro``'s model passes ``kv_valid`` all true); no
    rope.  x: (B, D) -> (B, D).  With ``tp`` as :func:`gqa_decode`, the
    frames split where the KV heads are not."""
    B, _ = x.shape
    Dh = cfg.resolved_head_dim()
    q = (x @ p["wq"]).reshape(B, -1, Dh)
    seq_lens = torch.full((B,), ck.shape[1], dtype=torch.int32,
                          device=x.device)
    if tp is None or tp.kv_tp:
        out = ops.paged_attention(q, ck, cv, _row_blocks(B, x.device),
                                  seq_lens)
        return _out_proj(out, p["wo"], x, tp)
    o = _context_parallel(_all_heads(q, tp), ck, cv, seq_lens, tp)
    return _out_proj(_own_heads(o, cfg.num_heads, tp), p["wo"], x, tp)


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
    return _gqa_qkv(p, cfg, x, page["seq_lens"] - 1)


def _gqa_qkv(p, cfg: ModelConfig, x, pos):
    """One token's q (B, H, Dh), k and v (B, Hkv, Dh), rope at ``pos``
    (the heads of the weights: a rank's under tensor parallelism)."""
    B, _ = x.shape
    Dh = cfg.resolved_head_dim()
    H, Hkv = p["wq"].shape[-1] // Dh, p["wk"].shape[-1] // Dh
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


def _mla_qkr(p, cfg: ModelConfig, x, positions, tp=None):
    """The shared query / latent / rope-key projections.  x: (B, S, D) or
    (B, D); positions broadcast against x's leading axes.  The heads are
    the weights' (a rank's with ``tp``: where ``wdq``'s columns are split,
    ``q_norm`` is whole, so the query latent is gathered before the norm;
    ``wdkv`` and ``wkr`` are whole, so every rank forms the latent)."""
    m = cfg.mla
    H = p["wuk"].shape[-3]
    dn, dr = m.qk_nope_head_dim, m.qk_rope_head_dim
    q_lat = x @ p["wdq"]
    if tp is not None and q_lat.shape[-1] != m.q_lora_rank:
        q_lat = tp.gather(q_lat, dim=-1)
    q_lat = rms_norm(q_lat, p["q_norm"], cfg.norm_eps)
    q_all = (q_lat @ p["wuq"]).reshape(*x.shape[:-1], H, dn + dr)
    q_nope, q_rope = q_all[..., :dn], q_all[..., dn:]
    c_kv = rms_norm(x @ p["wdkv"], p["kv_norm"], cfg.norm_eps)
    k_rope = x @ p["wkr"]                 # (..., dr), shared by the heads
    sin, cos = rope_sincos(positions, dr, cfg.rope_theta)
    return q_nope, q_rope, c_kv, k_rope, sin, cos


def mla_forward(p, cfg: ModelConfig, x, positions, *, causal=True,
                window=0, return_cache=False, tp=None):
    """Full-sequence MLA: the latent expanded to per-head K and V, then
    flash attention (on the card one ``flash_prefill`` launch with QK
    width dn + dr and V width dv).  With ``return_cache`` also returns
    the latent ``c_kv`` (B, S, R) and the roped ``k_rope`` (B, S, dr).
    With ``tp`` the rank's heads (``wuq``, ``wuk``, ``wuv`` head-split),
    ``wo`` row-parallel; the latent whole on every rank."""
    B, S, _ = x.shape
    m = cfg.mla
    H = p["wuk"].shape[-3]
    dr, dv = m.qk_rope_head_dim, m.v_head_dim
    q_nope, q_rope, c_kv, k_rope, sin, cos = _mla_qkr(p, cfg, x, positions,
                                                      tp)
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
    if tp is not None and tp.attn_tp:
        y = tp.all_reduce(y)
    if return_cache:
        return y, (c_kv, k_rope)
    return y


def mla_forward_with_cache(p, cfg: ModelConfig, x, positions, tp=None):
    """Prefill variant: returns (y, (c_kv, k_rope)) for the latent pool."""
    return mla_forward(p, cfg, x, positions, causal=True,
                       window=cfg.sliding_window, return_cache=True, tp=tp)


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
    return _mla_q_token(p, cfg, x, page["seq_lens"] - 1)


def _mla_q_token(p, cfg: ModelConfig, x, pos, tp=None):
    """:func:`mla_decode_q_token` at the positions ``pos`` (B,); with
    ``tp`` the rank's heads' queries."""
    m = cfg.mla
    dn, dr = m.qk_nope_head_dim, m.qk_rope_head_dim
    R = m.kv_lora_rank
    q_nope, q_rope, c_kv, k_rope, sin, cos = _mla_qkr(p, cfg, x, pos, tp)
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


def mla_init_cache(cfg: ModelConfig, batch: int, max_seq: int,
                   dtype: torch.dtype, device, lead: Sequence[int] = ()):
    """Empty latent ring: {"ckr": (*lead, batch, W, 1, R + dr)}, W as
    :func:`gqa_init_cache`'s."""
    W = min(cfg.sliding_window or max_seq, max_seq)
    return mla_paged_pools(cfg, batch, W, dtype, device, lead)


def mla_decode(p, cfg: ModelConfig, x, cache, pos, tp=None):
    """Absorbed-matmul MLA decode against one layer's latent ring,
    written in place at slot pos % W: the ring viewed as a pool, one
    ``ops.paged_attention`` launch with K = V = the ring, as
    :func:`mla_decode_paged`.  x: (B, D); pos (B,).  Returns (B, D).
    With ``tp`` the ring is split over its window: every head's absorbed
    query over this rank's slots, merged, then the rank's heads through
    ``wuv`` and row-parallel ``wo``."""
    B, _ = x.shape
    R = cfg.mla.kv_lora_rank
    q_eff, token = _mla_q_token(p, cfg, x, pos, tp)
    ring = cache["ckr"]
    if tp is None:
        _write_ring(ring[:, :, 0], pos, token)
        tables, seq_lens = ring_page(pos, ring.shape[1])
        out = ops.paged_attention(q_eff.to(ring.dtype), ring, ring, tables,
                                  seq_lens)
        o = torch.einsum("bhr,hrv->bhv", out[..., :R].to(x.dtype), p["wuv"])
        return o.reshape(B, -1) @ p["wo"]
    _write_ring_slice(ring[:, :, 0], pos, token, tp)
    o = _context_parallel(_all_heads(q_eff, tp).to(ring.dtype), ring, ring,
                          _slice_lens(pos, ring.shape[1], tp), tp)
    o = _own_heads(o, cfg.num_heads, tp)[..., :R]
    o = torch.einsum("bhr,hrv->bhv", o.to(x.dtype), p["wuv"])
    return _out_proj(o, p["wo"], x, tp)
