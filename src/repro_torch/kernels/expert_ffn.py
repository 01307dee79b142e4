"""Grouped expert SwiGLU FFN: the plain PyTorch version and the launcher of
the CUDA kernel (``csrc/expert_ffn.cu``: bf16 on the tensor cores, f32 on
FMA).

Both compute ``repro.kernels.ref.expert_ffn_ref`` over a dense capacity
buffer: per expert, ``silu(x @ gate) * (x @ up)`` accumulated in f32 and
cast to x's type, then ``@ down`` accumulated in f32 with one cast at the
end.  The dense-scatter MoE path (``models.moe.experts_compute``) runs it
in every MoE layer; the fused path's plain version reuses the plain one.

Its gradient (``csrc/expert_ffn_bwd.cu``, new in the port: ``repro``
differentiates its jnp ``experts_compute`` and has no backward kernel):
with a = x @ gate, b = x @ up (f32) and h = silu(a) * b cast to x's type,
dh = dy @ down^T, da = dh * b * silu'(a), db = dh * silu(a), then dx = da
@ gate^T + db @ up^T, dgate = x^T @ da, dup = x^T @ db and ddown = h^T @
dy; the cast of h passes the gradient straight through.
:class:`ExpertFFN` is the ``torch.autograd.Function`` that pairs the two
kernels (the plain versions for CPU tensors).  The plain versions compute
in f32, or in f64 for f64 inputs (``gradcheck``).
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import build, launches
from repro_torch.kernels.flash_prefill import acc_dtype

_VP, _CI = ctypes.c_void_p, ctypes.c_int
_PROTOTYPES = {"expert_ffn": ([_VP] * 6 + [_CI] * 5 + [_VP], _CI)}
_BWD_PROTOTYPES = {"expert_ffn_bwd": ([_VP] * 12 + [_CI] * 5 + [_VP], _CI)}


def expert_ffn_plain(x, gate_w, up_w, down_w):
    """Grouped expert SwiGLU, f32 accumulate; the hidden activation is
    cast to x's type before ``@down``.  x: (E, C, D) -> (E, C, D)."""
    acc = acc_dtype(x.dtype)
    h = F.silu(torch.einsum("ecd,edf->ecf", x.to(acc), gate_w.to(acc)))
    h = h * torch.einsum("ecd,edf->ecf", x.to(acc), up_w.to(acc))
    y = torch.einsum("ecf,efd->ecd", h.to(x.dtype).to(acc), down_w.to(acc))
    return y.to(x.dtype)


def expert_ffn_bwd_plain(x, gate_w, up_w, down_w, dy):
    """The gradients (dx, dgate, dup, ddown) of :func:`expert_ffn_plain`
    for the output gradient ``dy`` (E, C, D), written out: a and b
    recomputed, h cast to x's type as the forward casts it, each gradient
    in its input's type."""
    acc = acc_dtype(x.dtype)
    xf, gf, uf = x.to(acc), gate_w.to(acc), up_w.to(acc)
    dyf = dy.to(acc)
    a = torch.einsum("ecd,edf->ecf", xf, gf)
    b = torch.einsum("ecd,edf->ecf", xf, uf)
    sig = torch.sigmoid(a)
    sa = a * sig                                      # silu(a)
    h = (sa * b).to(x.dtype).to(acc)
    dh = torch.einsum("ecd,efd->ecf", dyf, down_w.to(acc))
    da = dh * b * sig * (1 + a * (1 - sig))           # silu'(a)
    db = dh * sa
    dx = (torch.einsum("ecf,edf->ecd", da, gf)
          + torch.einsum("ecf,edf->ecd", db, uf))
    return (dx.to(x.dtype),
            torch.einsum("ecd,ecf->edf", xf, da).to(gate_w.dtype),
            torch.einsum("ecd,ecf->edf", xf, db).to(up_w.dtype),
            torch.einsum("ecf,ecd->efd", h, dyf).to(down_w.dtype))


def expert_ffn_cuda(x, gate_w, up_w, down_w):
    """Launch the CUDA kernel on PyTorch's current stream.  Raises on any
    input the kernel does not take; never falls back."""
    build.refuse_grad("expert_ffn_cuda", x, gate_w, up_w, down_w,
                      hint="its output carries no gradient: ops.expert_ffn "
                           "launches it through ExpertFFN, with its "
                           "backward kernel")
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


def expert_ffn_bwd_cuda(x, gate_w, up_w, down_w, dy):
    """Launch the backward kernels on PyTorch's current stream: the
    gradients (dx, dgate, dup, ddown) for the output gradient ``dy``.
    Raises on any input they do not take; never falls back."""
    build.refuse_grad("expert_ffn_bwd_cuda", x, gate_w, up_w, down_w, dy,
                      hint="its backward (a second derivative) is not "
                           "ported")
    if x.device.type != "cuda":
        raise ValueError(f"expert_ffn_bwd_cuda needs CUDA tensors, got "
                         f"{x.device}")
    if x.dtype not in build.DTYPE_CODES:
        raise TypeError(f"expert_ffn_bwd: unsupported dtype {x.dtype}")
    E, C, D = x.shape
    Fd = gate_w.shape[-1]
    dev = x.device
    build.check_arg("x", x, x.dtype, (E, C, D), dev)
    build.check_arg("gate_w", gate_w, x.dtype, (E, D, Fd), dev)
    build.check_arg("up_w", up_w, x.dtype, (E, D, Fd), dev)
    build.check_arg("down_w", down_w, x.dtype, (E, Fd, D), dev)
    build.check_arg("dy", dy, x.dtype, (E, C, D), dev)
    lib = build.load("expert_ffn_bwd", _BWD_PROTOTYPES)
    grads = tuple(torch.empty_like(t) for t in (x, gate_w, up_w, down_w))
    if x.numel() == 0 or gate_w.numel() == 0:
        return tuple(g.zero_() for g in grads)
    # a, b and dh of every buffer row, (E, C, F) f32: the first two become
    # da and db in place, the third the h the forward's products used
    scratch = torch.empty((3, E, C, Fd), dtype=torch.float32, device=dev)
    err = lib.expert_ffn_bwd(
        x.data_ptr(), gate_w.data_ptr(), up_w.data_ptr(), down_w.data_ptr(),
        dy.data_ptr(), scratch[0].data_ptr(), scratch[1].data_ptr(),
        scratch[2].data_ptr(), *(g.data_ptr() for g in grads), E, C, D, Fd,
        build.DTYPE_CODES[x.dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"expert_ffn_bwd launch failed: cudaError {err}")
    launches["expert_ffn_bwd"] += 1
    return grads


class ExpertFFN(torch.autograd.Function):
    """The grouped expert SwiGLU with its gradient: the forward kernel
    (its plain version for CPU tensors), then the backward kernel
    (likewise), which recomputes a, b and h from the saved inputs."""

    @staticmethod
    def forward(ctx, x, gate_w, up_w, down_w):
        fwd = expert_ffn_plain if x.device.type == "cpu" else expert_ffn_cuda
        ctx.save_for_backward(x, gate_w, up_w, down_w)
        return fwd(x, gate_w, up_w, down_w)

    @staticmethod
    def backward(ctx, dy):
        x, gate_w, up_w, down_w = ctx.saved_tensors
        bwd = (expert_ffn_bwd_plain if x.device.type == "cpu"
               else expert_ffn_bwd_cuda)
        return bwd(x, gate_w, up_w, down_w, dy.contiguous())
