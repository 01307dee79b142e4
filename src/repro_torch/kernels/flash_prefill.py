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


def _positions(pos, n: int, device) -> torch.Tensor:
    if pos is None:
        return torch.arange(n, dtype=torch.int32, device=device)
    return pos


def flash_prefill_plain(q, k, v, q_pos=None, kv_pos=None, *,
                        causal: bool = True, window: int = 0):
    """q: (B, Sq, H, Dq); k: (B, Skv, Hkv, Dq); v: (B, Skv, Hkv, Dv);
    q_pos (Sq,) / kv_pos (Skv,) int positions (None: ``arange``).  Returns
    (B, Sq, H, Dv) in q's type."""
    B, Sq, H, Dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    qp = _positions(q_pos, Sq, q.device).long()
    kp = _positions(kv_pos, Skv, q.device).long()
    qg = q.reshape(B, Sq, Hkv, G, Dh)
    s = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float())
    s = s / math.sqrt(Dh)
    valid = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        valid &= qp[:, None] >= kp[None, :]
    if window:
        valid &= (qp[:, None] - kp[None, :]) < window
    s = s.masked_fill(~valid, NEG_INF)
    p = torch.softmax(s, dim=-1)
    # a row that sees no key would average garbage: zero it
    p = p.masked_fill(~valid, 0.0)
    o = torch.einsum("bkgst,btkd->bskgd", p, v.float())
    return o.reshape(B, Sq, H, v.shape[-1]).to(q.dtype)


def flash_prefill_cuda(q, k, v, q_pos=None, kv_pos=None, *,
                       causal: bool = True, window: int = 0):
    """Launch the CUDA kernel on PyTorch's current stream.  Raises on any
    input the kernel does not take; never falls back."""
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
