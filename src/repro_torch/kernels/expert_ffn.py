"""Grouped expert SwiGLU FFN: the plain PyTorch version and the launcher of
the CUDA kernel (``csrc/expert_ffn.cu``: bf16 on the tensor cores, f32 on
FMA).

Both compute ``repro.kernels.ref.expert_ffn_ref`` over a dense capacity
buffer: per expert, ``silu(x @ gate) * (x @ up)`` accumulated in f32 and
cast to x's type, then ``@ down`` accumulated in f32 with one cast at the
end.  The dense-scatter MoE path (``models.moe.experts_compute``) runs it
in every MoE layer; the fused path's plain version reuses the plain one.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import build, launches

_VP, _CI = ctypes.c_void_p, ctypes.c_int
_PROTOTYPES = {"expert_ffn": ([_VP] * 6 + [_CI] * 5 + [_VP], _CI)}


def expert_ffn_plain(x, gate_w, up_w, down_w):
    """Grouped expert SwiGLU, f32 accumulate; the hidden activation is
    cast to x's type before ``@down``.  x: (E, C, D) -> (E, C, D)."""
    h = F.silu(torch.einsum("ecd,edf->ecf", x.float(), gate_w.float()))
    h = h * torch.einsum("ecd,edf->ecf", x.float(), up_w.float())
    y = torch.einsum("ecf,efd->ecd", h.to(x.dtype).float(), down_w.float())
    return y.to(x.dtype)


def expert_ffn_cuda(x, gate_w, up_w, down_w):
    """Launch the CUDA kernel on PyTorch's current stream.  Raises on any
    input the kernel does not take; never falls back."""
    if x.device.type != "cuda":
        raise ValueError(f"expert_ffn_cuda needs CUDA tensors, got "
                         f"{x.device}")
    if x.dtype not in build.DTYPE_CODES:
        raise TypeError(f"expert_ffn: unsupported dtype {x.dtype}")
    E, C, D = x.shape
    Fd = gate_w.shape[-1]
    dev = x.device
    build.check_arg("x", x, x.dtype, (E, C, D), dev)
    build.check_arg("gate_w", gate_w, x.dtype, (E, D, Fd), dev)
    build.check_arg("up_w", up_w, x.dtype, (E, D, Fd), dev)
    build.check_arg("down_w", down_w, x.dtype, (E, Fd, D), dev)
    for name, t in (("x", x), ("gate_w", gate_w), ("up_w", up_w),
                    ("down_w", down_w)):
        if t.data_ptr() % 16:                # the kernel's cp.async reads
            raise ValueError(f"expert_ffn: {name} is not 16-byte aligned")
    lib = build.load("expert_ffn", _PROTOTYPES)
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    h = torch.empty((E, C, Fd), dtype=x.dtype, device=dev)
    err = lib.expert_ffn(x.data_ptr(), gate_w.data_ptr(), up_w.data_ptr(),
                         down_w.data_ptr(), h.data_ptr(), y.data_ptr(), E, C,
                         D, Fd, build.DTYPE_CODES[x.dtype],
                         torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"expert_ffn launch failed: cudaError {err}")
    launches["expert_ffn"] += 1
    return y
