"""Paged GQA / MLA decode attention: the plain PyTorch version and the
launcher of the CUDA kernel (``csrc/paged_attention.cu``).

Both compute ``repro.kernels.ref.paged_attention_ref``: one query token
per row attends over a paged K/V pool through its block table, over the
valid positions ``[start_lens[b], seq_lens[b])``; a row with none
outputs 0.  Head dims up to 256 take the GQA kernel, in splits of 64
positions; wider ones, up to 768, split rows into 256 positions: MLA's
latent pool (Hkv = 1, Dh = R + dr = 576 at deepseek-v3, K and V the same
tensor) takes the tensor-core latent kernel in bf16 (64 query heads a
CTA against one staged latent tile), the wide FMA kernel in f32 or with
two pools.  ``kernels.ops.paged_attention`` picks between plain and CUDA
by the device the tensors lie on.

With ``lse_out`` (f32 (B, H)) both also give each row's natural-log
log-sum-exp of its scaled scores over its valid positions (-inf where
it has none), and return the output in f32: normalised within the call,
so that calls over disjoint position ranges of one row (a context-
parallel decode's ranks) merge exactly by their lse
(``distributed.tensor_parallel.merge_partials``).  Without it the
result is what it was, bit for bit.
"""
from __future__ import annotations

import ctypes
import math
import torch

from repro_torch.kernels import build, launches

NEG_INF = -1e30
MAX_HEAD_DIM = 768         # the wide kernel: 3 chunks of 8 a lane
LATENT_HEAD_DIM = 576      # the tensor-core latent kernel's head width
LATENT_HEADS = 64          # query heads a CTA of it holds
# the launch count of calls (standalone or the megastep's attention stage)
# whose attention ran the tensor-core latent kernel
LATENT = "paged_attention.latent_kernel"
# the launch count of calls that wrote ``lse_out`` (the context-parallel
# decode's partials), beside the op's own count
LSE = "paged_attention.lse_out"


def takes_latent_kernel(q, k_pool, v_pool) -> bool:
    """Whether a CUDA launch on these operands runs the tensor-core latent
    kernel, by the layout alone, as ``paged::launch`` in
    ``csrc/paged_attention.cuh`` decides (the card tests hold the two
    together by ``launches[LATENT]``, which counts the choice each launch
    reports): bf16, one pool as K and V,
    Dh = 576, G a multiple of 64.  Such a launch whose q, pool or output
    is not 16-byte aligned fails; it never falls back.  That kernel rounds
    the probabilities to bf16 before P V; the others keep them in f32."""
    H, Dh = q.shape[1], q.shape[2]
    Hkv = k_pool.shape[2]
    return (q.dtype == torch.bfloat16 and Dh == LATENT_HEAD_DIM
            and k_pool.data_ptr() == v_pool.data_ptr()
            and H % Hkv == 0 and (H // Hkv) % LATENT_HEADS == 0)


def paged_attention_plain(q, k_pool, v_pool, block_table, seq_lens,
                          start_lens=None, lse_out=None):
    """q: (B, H, Dh); pools: (nb, bs, Hkv, Dh); block_table (B, max_blk);
    seq_lens / start_lens (B,).  Returns (B, H, Dh) in q's type, or in f32
    with ``lse_out`` (B, H) f32, which takes each row's log-sum-exp."""
    B, H, Dh = q.shape
    _, bs, Hkv, _ = k_pool.shape
    max_blk = block_table.shape[1]
    G = H // Hkv
    tables = block_table.long()
    k = k_pool[tables].reshape(B, max_blk * bs, Hkv, Dh)
    v = v_pool[tables].reshape(B, max_blk * bs, Hkv, Dh)
    qg = q.reshape(B, Hkv, G, Dh)
    s = torch.einsum("bkgd,bskd->bkgs", qg.float(), k.float())
    s = s / math.sqrt(Dh)
    pos = torch.arange(max_blk * bs, device=q.device)[None, :]
    valid = pos < seq_lens[:, None]
    if start_lens is not None:
        valid &= pos >= start_lens[:, None]
    s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    # a row with no valid position would average garbage: zero it
    p = p.masked_fill(~valid[:, None, None, :], 0.0)
    o = torch.einsum("bkgs,bskd->bkgd", p.to(v.dtype).float(), v.float())
    if lse_out is None:
        return o.reshape(B, H, Dh).to(q.dtype)
    lse = torch.logsumexp(s, dim=-1).reshape(B, H)
    lse_out.copy_(lse.masked_fill(~valid.any(dim=-1)[:, None], -math.inf))
    return o.reshape(B, H, Dh)


_VP, _CI = ctypes.c_void_p, ctypes.c_int
_PROTOTYPES = {
    "paged_attention": ([_VP] * 8 + [_CI] * 7 + [_VP, ctypes.POINTER(_CI),
                                                 _VP], _CI),
    "paged_attention_scratch_bytes": ([_CI] * 5, ctypes.c_longlong),
}


def paged_attention_cuda(q, k_pool, v_pool, block_table, seq_lens,
                         start_lens=None, lse_out=None):
    """Launch the CUDA kernels (split, then merge where a row spans more
    than one split) on PyTorch's current stream; with ``lse_out`` (B, H)
    f32 the kernels write each row's log-sum-exp there and the output
    in f32.  Raises on any input the kernels do not take; never falls
    back."""
    build.refuse_grad("paged_attention_cuda", q, k_pool, v_pool)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention_cuda needs CUDA tensors, got "
                         f"{q.device}")
    if q.dtype not in build.DTYPE_CODES:
        raise TypeError(f"paged_attention: unsupported dtype {q.dtype}")
    B, H, Dh = q.shape
    nb, bs, Hkv, _ = k_pool.shape
    max_blk = block_table.shape[1]
    if Dh > MAX_HEAD_DIM:
        raise ValueError(f"paged_attention: head dim {Dh} > {MAX_HEAD_DIM}")
    if H % Hkv:
        raise ValueError(f"paged_attention: {H} heads over {Hkv} KV heads")
    dev = q.device
    build.check_arg("q", q, q.dtype, (B, H, Dh), dev)
    build.check_arg("k_pool", k_pool, q.dtype, (nb, bs, Hkv, Dh), dev)
    build.check_arg("v_pool", v_pool, q.dtype, (nb, bs, Hkv, Dh), dev)
    build.check_arg("block_table", block_table, torch.int32, (B, max_blk), dev)
    build.check_arg("seq_lens", seq_lens, torch.int32, (B,), dev)
    if start_lens is not None:
        build.check_arg("start_lens", start_lens, torch.int32, (B,), dev)
    if lse_out is not None:
        build.check_arg("lse_out", lse_out, torch.float32, (B, H), dev)
    lib = build.load("paged_attention", _PROTOTYPES)
    out = torch.empty_like(q, dtype=q.dtype if lse_out is None
                           else torch.float32)
    if B == 0:
        return out
    nbytes = lib.paged_attention_scratch_bytes(B, H, Dh, bs, max_blk)
    scratch = (torch.empty(nbytes, dtype=torch.uint8, device=dev)
               if nbytes else None)
    took_latent = _CI(0)
    err = lib.paged_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_table.data_ptr(), seq_lens.data_ptr(),
        None if start_lens is None else start_lens.data_ptr(),
        out.data_ptr(), None if scratch is None else scratch.data_ptr(),
        B, H, Hkv, Dh, bs, max_blk, build.DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(dev).cuda_stream, ctypes.byref(took_latent),
        None if lse_out is None else lse_out.data_ptr())
    if err != 0:
        raise RuntimeError(f"paged_attention launch failed: cudaError {err}")
    launches["paged_attention"] += 1
    count_latent(took_latent)
    if lse_out is not None:
        launches[LSE] += 1
    return out


def count_latent(took_latent) -> None:
    """Count a launch whose attention ran ``latent_kernel``, as the C call
    reported it (``launches[LATENT]``, beside the op's own count)."""
    if took_latent.value:
        launches[LATENT] += 1
