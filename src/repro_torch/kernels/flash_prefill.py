"""Whole-prompt GQA attention: the plain PyTorch version and the launcher
of the CUDA kernel (``csrc/flash_prefill.cu``: bf16 on the tensor cores,
where p is rounded to V's type before p @ V as ``repro``'s
``flash_attention`` does; f32 on FMA with p in f32).

Both compute ``repro.kernels.ref.flash_prefill_ref`` — q (B, Sq, H, Dq)
attends over k (B, Skv, Hkv, Dq) and v (B, Skv, Hkv, Dv), scores scaled
by 1/sqrt(Dq), softmax in f32 — extended by what the model's
``flash_attention`` masks with: key j is visible to query i where
``q_pos[i] >= kv_pos[j]`` (``causal``) and ``q_pos[i] - kv_pos[j] <
window`` (``window`` > 0).  A row that sees no key outputs 0.  With
positions ``arange(S)``, no window and Dv = Dq this is exactly the
reference; MLA's prefill has Dq = dn + dr = 192 and Dv = 128.

Its gradient (``csrc/flash_prefill_bwd.cu``, new in the port: ``repro``
differentiates its jnp ``flash_attention`` and has no backward kernel)
is FlashAttention-2's: with P the softmax of the masked scores and D =
rowsum(dO * O), dV = P^T dO, dS = P * (dO V^T - D), dQ = dS K / sqrt(Dq)
and dK = dS^T Q / sqrt(Dq), summed over the G query heads of a KV head.
A row that sees no key has P = 0 and gets no gradient.
:class:`FlashPrefill` is the ``torch.autograd.Function`` that pairs the
two kernels (the plain versions for CPU tensors).  The plain versions
compute in f32, or in f64 for f64 inputs (``gradcheck``).
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build, launches

NEG_INF = -1e30
MAX_HEAD_DIM = 256

_VP, _CI = ctypes.c_void_p, ctypes.c_int
_PROTOTYPES = {
    "flash_prefill": ([_VP] * 6 + [_CI] * 9 + [ctypes.c_float, _CI, _VP],
                      _CI),
    "flash_prefill_smem_bytes": ([_CI] * 8, ctypes.c_longlong),
}
_BWD_PROTOTYPES = {
    "flash_prefill_bwd": ([_VP] * 12 + [_CI] * 9 + [ctypes.c_float, _CI,
                                                    _VP], _CI),
    "flash_prefill_bwd_smem_bytes": ([_CI] * 2, ctypes.c_longlong),
}


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The plain versions' arithmetic type: f64 for f64 inputs, else f32."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _positions(pos, n: int, device) -> torch.Tensor:
    if pos is None:
        return torch.arange(n, dtype=torch.int32, device=device)
    return pos


def flash_prefill_plain(q, k, v, q_pos=None, kv_pos=None, *,
                        causal: bool = True, window: int = 0):
    """q: (B, Sq, H, Dq); k: (B, Skv, Hkv, Dq); v: (B, Skv, Hkv, Dv);
    q_pos (Sq,) / kv_pos (Skv,) int positions (None: ``arange``).  Returns
    (B, Sq, H, Dv) in q's type."""
    B, Sq, H, _ = q.shape
    p = _probs(q, k, q_pos, kv_pos, causal, window)
    o = torch.einsum("bkgst,btkd->bskgd", p, v.to(p.dtype))
    return o.reshape(B, Sq, H, v.shape[-1]).to(q.dtype)


def _probs(q, k, q_pos, kv_pos, causal, window):
    """The attention probabilities (B, Hkv, G, Sq, Skv), in the plain
    versions' arithmetic type; a row that sees no key is all zeros."""
    B, Sq, H, Dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    acc = acc_dtype(q.dtype)
    qp = _positions(q_pos, Sq, q.device).long()
    kp = _positions(kv_pos, Skv, q.device).long()
    valid = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        valid &= qp[:, None] >= kp[None, :]
    if window:
        valid &= (qp[:, None] - kp[None, :]) < window
    qg = q.reshape(B, Sq, Hkv, H // Hkv, Dh)
    s = torch.einsum("bskgd,btkd->bkgst", qg.to(acc), k.to(acc))
    s = s / math.sqrt(Dh)
    s = s.masked_fill(~valid, NEG_INF)
    p = torch.softmax(s, dim=-1)
    # a row that sees no key would average garbage: zero it
    return p.masked_fill(~valid, 0.0)


def flash_prefill_bwd_plain(q, k, v, o, do, q_pos=None, kv_pos=None, *,
                            causal: bool = True, window: int = 0):
    """The gradients (dq, dk, dv) of :func:`flash_prefill_plain` at
    ``(q, k, v)`` for the output gradient ``do`` (B, Sq, H, Dv), written
    out: P recomputed, D = rowsum(do * o) from the forward's output
    ``o``, then dV = P^T dO, dS = P * (dO V^T - D), dQ = dS K / sqrt(Dq),
    dK = dS^T Q / sqrt(Dq).  Each in its input's type."""
    B, Sq, H, Dq = q.shape
    Hkv, Dv = k.shape[2], v.shape[-1]
    G = H // Hkv
    p = _probs(q, k, q_pos, kv_pos, causal, window)
    acc = p.dtype
    dog = do.to(acc).reshape(B, Sq, Hkv, G, Dv)
    delta = (dog * o.to(acc).reshape(B, Sq, Hkv, G, Dv)).sum(-1)
    dv = torch.einsum("bkgst,bskgd->btkd", p, dog)
    dp = torch.einsum("bskgd,btkd->bkgst", dog, v.to(acc))
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    scale = 1.0 / math.sqrt(Dq)
    dq = torch.einsum("bkgst,btkd->bskgd", ds, k.to(acc)) * scale
    dk = torch.einsum("bkgst,bskgd->btkd", ds,
                      q.to(acc).reshape(B, Sq, Hkv, G, Dq)) * scale
    return (dq.reshape(B, Sq, H, Dq).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def flash_prefill_cuda(q, k, v, q_pos=None, kv_pos=None, *,
                       causal: bool = True, window: int = 0):
    """Launch the CUDA kernel on PyTorch's current stream.  Raises on any
    input the kernel does not take; never falls back."""
    build.refuse_grad("flash_prefill_cuda", q, k, v,
                      hint="its output carries no gradient: "
                           "ops.flash_prefill launches it through "
                           "FlashPrefill, with its backward kernel")
    if q.device.type != "cuda":
        raise ValueError(f"flash_prefill_cuda needs CUDA tensors, got "
                         f"{q.device}")
    if q.dtype not in build.DTYPE_CODES:
        raise TypeError(f"flash_prefill: unsupported dtype {q.dtype}")
    B, Sq, H, Dq = q.shape
    Skv, Hkv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    for name, d in (("QK", Dq), ("V", Dv)):
        if d > MAX_HEAD_DIM or d % 8:
            raise ValueError(f"flash_prefill: {name} head dim {d} is not a "
                             f"multiple of 8 up to {MAX_HEAD_DIM}")
    if H % Hkv:
        raise ValueError(f"flash_prefill: {H} heads over {Hkv} KV heads")
    dev = q.device
    q_pos = _positions(q_pos, Sq, dev)
    kv_pos = _positions(kv_pos, Skv, dev)
    build.check_arg("q", q, q.dtype, (B, Sq, H, Dq), dev)
    build.check_arg("k", k, q.dtype, (B, Skv, Hkv, Dq), dev)
    build.check_arg("v", v, q.dtype, (B, Skv, Hkv, Dv), dev)
    build.check_arg("q_pos", q_pos, torch.int32, (Sq,), dev)
    build.check_arg("kv_pos", kv_pos, torch.int32, (Skv,), dev)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"flash_prefill: {name} is not 16-byte aligned")
    lib = build.load("flash_prefill", _PROTOTYPES)
    smem = lib.flash_prefill_smem_bytes(B, Sq, Skv, H, Hkv, Dq, Dv,
                                        build.DTYPE_CODES[q.dtype])
    if smem > build.MAX_SMEM_BYTES:
        raise ValueError(f"flash_prefill: {H // Hkv} heads per KV head at "
                         f"Dq={Dq}, Dv={Dv} need {smem} B of shared memory "
                         f"(or that pair of widths is not instantiated)")
    out = q.new_empty((B, Sq, H, Dv))
    if out.numel() == 0:
        return out
    err = lib.flash_prefill(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
        kv_pos.data_ptr(), out.data_ptr(), B, Sq, Skv, H, Hkv, Dq, Dv,
        int(causal), int(window), 1.0 / math.sqrt(Dq),
        build.DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_prefill launch failed: cudaError {err}")
    launches["flash_prefill"] += 1
    return out


def flash_prefill_bwd_cuda(q, k, v, o, do, q_pos=None, kv_pos=None, *,
                           causal: bool = True, window: int = 0):
    """Launch the backward kernels on PyTorch's current stream: the
    gradients (dq, dk, dv) for the output gradient ``do``, with ``o`` the
    forward's output.  Raises on any input they do not take; never falls
    back."""
    build.refuse_grad("flash_prefill_bwd_cuda", q, k, v, o, do,
                      hint="its backward (a second derivative) is not "
                           "ported")
    if q.device.type != "cuda":
        raise ValueError(f"flash_prefill_bwd_cuda needs CUDA tensors, got "
                         f"{q.device}")
    if q.dtype not in build.DTYPE_CODES:
        raise TypeError(f"flash_prefill_bwd: unsupported dtype {q.dtype}")
    B, Sq, H, Dq = q.shape
    Skv, Hkv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    for name, d in (("QK", Dq), ("V", Dv)):
        if d > MAX_HEAD_DIM or d % 8:
            raise ValueError(f"flash_prefill_bwd: {name} head dim {d} is "
                             f"not a multiple of 8 up to {MAX_HEAD_DIM}")
    if H % Hkv:
        raise ValueError(f"flash_prefill_bwd: {H} heads over {Hkv} KV "
                         f"heads")
    dev = q.device
    q_pos = _positions(q_pos, Sq, dev)
    kv_pos = _positions(kv_pos, Skv, dev)
    build.check_arg("q", q, q.dtype, (B, Sq, H, Dq), dev)
    build.check_arg("k", k, q.dtype, (B, Skv, Hkv, Dq), dev)
    build.check_arg("v", v, q.dtype, (B, Skv, Hkv, Dv), dev)
    build.check_arg("o", o, q.dtype, (B, Sq, H, Dv), dev)
    build.check_arg("do", do, q.dtype, (B, Sq, H, Dv), dev)
    build.check_arg("q_pos", q_pos, torch.int32, (Sq,), dev)
    build.check_arg("kv_pos", kv_pos, torch.int32, (Skv,), dev)
    lib = build.load("flash_prefill_bwd", _BWD_PROTOTYPES)
    smem = lib.flash_prefill_bwd_smem_bytes(Dq, Dv)
    if smem > build.MAX_SMEM_BYTES:
        raise ValueError(f"flash_prefill_bwd: Dq={Dq}, Dv={Dv} need {smem} "
                         f"B of shared memory")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    # each query row's log-sum-exp and D = rowsum(do * o), (B, H, Sq) f32
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=dev)
    delta = torch.empty_like(lse)
    err = lib.flash_prefill_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), q_pos.data_ptr(), kv_pos.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B,
        Sq, Skv, H, Hkv, Dq, Dv, int(causal), int(window),
        1.0 / math.sqrt(Dq), build.DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_prefill_bwd launch failed: cudaError "
                           f"{err}")
    launches["flash_prefill_bwd"] += 1
    return dq, dk, dv


class FlashPrefill(torch.autograd.Function):
    """Whole-prompt attention with its gradient: the forward kernel (its
    plain version for CPU tensors), then the backward kernel (likewise).
    Saves q, k, v and the output; the backward recomputes the rows'
    softmax statistics, so the forward kernel stays the one serving
    launches."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, kv_pos, causal, window):
        fwd = (flash_prefill_plain if q.device.type == "cpu"
               else flash_prefill_cuda)
        o = fwd(q, k, v, q_pos, kv_pos, causal=causal, window=window)
        ctx.save_for_backward(q, k, v, o, q_pos, kv_pos)
        ctx.mask = (causal, window)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, q_pos, kv_pos = ctx.saved_tensors
        bwd = (flash_prefill_bwd_plain if q.device.type == "cpu"
               else flash_prefill_bwd_cuda)
        causal, window = ctx.mask
        dq, dk, dv = bwd(q, k, v, o, do.contiguous(), q_pos, kv_pos,
                         causal=causal, window=window)
        return dq, dk, dv, None, None, None, None
