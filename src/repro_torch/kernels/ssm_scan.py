"""Mamba-1 selective scan: the plain PyTorch version and the launcher of the
CUDA kernel (``csrc/ssm_scan.cu``).

Both compute ``repro.kernels.ref.ssm_scan_ref``: per batch row, channel
and state, ``h_t = exp(dt_t A) h_{t-1} + (dt_t u_t) B_t`` and
``y_t = sum_n h_t C_t``, returning ``(y (B, S, d) f32, h_final (B, d, N)
f32)``.  With ``h0=None`` the scan starts from zero, which is exactly what
``ssm_scan_pallas`` computes; ``h0`` is the reference's own argument, so
the one-token decode update runs the same kernel at S = 1.  Both versions
cast every input to f32 before any product, as the TPU kernel does (the
reference forms ``dt_t u_t`` in the inputs' type; in f32 they agree).
The decode step's in-place mode (``h_out``, ``y_dtype``) writes h_final
into the slot's state tensor in its own type and returns y in the
activation type, rounded to nearest: what the scan, a ``copy_`` into the
state and a cast of y give, in one kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, launches

_VP, _CI = ctypes.c_void_p, ctypes.c_int
_PROTOTYPES = {"ssm_scan": ([_VP] * 8 + [_CI] * 8 + [_VP], _CI)}
STATE_SIZES = (8, 16)       # the N the kernel is built for


def ssm_scan_plain(u, dt, A, B_ssm, C_ssm, h0=None, *, h_out=None,
                   y_dtype=torch.float32):
    """u / dt (B, S, d); A (d, N); B_ssm / C_ssm (B, S, N); h0 (B, d, N)
    or None.  A loop over time in f32.  ``h_out`` (B, d, N), in its own
    type and possibly ``h0`` itself, receives the final state, which is
    then what is returned; y comes back in ``y_dtype``."""
    Bsz, S, d = u.shape
    N = A.shape[1]
    h = (torch.zeros((Bsz, d, N), dtype=torch.float32, device=u.device)
         if h0 is None else h0.float())
    A = A.float()
    ys = []
    for t in range(S):
        dt_t, u_t = dt[:, t].float(), u[:, t].float()
        dA = torch.exp(dt_t[..., None] * A[None])
        dBu = (dt_t * u_t)[..., None] * B_ssm[:, t, None, :].float()
        h = dA * h + dBu
        ys.append(torch.einsum("bdn,bn->bd", h, C_ssm[:, t].float()))
    y = (torch.stack(ys, dim=1) if ys else
         torch.zeros((Bsz, 0, d), dtype=torch.float32, device=u.device))
    if h_out is not None:
        h = h_out.copy_(h)
    return y.to(y_dtype), h


def ssm_scan_cuda(u, dt, A, B_ssm, C_ssm, h0=None, *, h_out=None,
                  y_dtype=torch.float32):
    """Launch the CUDA kernel on PyTorch's current stream.  By default y
    and h_final come back as new f32 tensors; ``h_out`` (B, d, N), f32 or
    bf16 and possibly ``h0`` itself, takes h_final in its own type instead,
    and ``y_dtype`` sets y's type (both rounded to nearest, as a cast
    rounds).  Raises on any input the kernel does not take; never falls
    back."""
    build.refuse_grad("ssm_scan_cuda", u, dt, A, B_ssm, C_ssm, h0)
    if u.device.type != "cuda":
        raise ValueError(f"ssm_scan_cuda needs CUDA tensors, got {u.device}")
    if u.dtype not in build.DTYPE_CODES:
        raise TypeError(f"ssm_scan: unsupported dtype {u.dtype}")
    if y_dtype not in build.DTYPE_CODES:
        raise TypeError(f"ssm_scan: unsupported y dtype {y_dtype}")
    Bsz, S, d = u.shape
    N = A.shape[1]
    if N not in STATE_SIZES:
        raise ValueError(f"ssm_scan: state size {N} not in {STATE_SIZES}")
    dev = u.device
    build.check_arg("u", u, u.dtype, (Bsz, S, d), dev)
    build.check_arg("dt", dt, u.dtype, (Bsz, S, d), dev)
    build.check_arg("A", A, torch.float32, (d, N), dev)
    build.check_arg("B_ssm", B_ssm, u.dtype, (Bsz, S, N), dev)
    build.check_arg("C_ssm", C_ssm, u.dtype, (Bsz, S, N), dev)
    for name, t in (("h0", h0), ("h_out", h_out)):
        if t is not None:
            if t.dtype not in build.DTYPE_CODES:
                raise TypeError(f"ssm_scan: unsupported {name} dtype "
                                f"{t.dtype}")
            build.check_arg(name, t, t.dtype, (Bsz, d, N), dev)
    lib = build.load("ssm_scan", _PROTOTYPES)
    y = torch.empty((Bsz, S, d), dtype=y_dtype, device=dev)
    h = (torch.empty((Bsz, d, N), dtype=torch.float32, device=dev)
         if h_out is None else h_out)
    if h.numel() == 0:
        return y, h
    err = lib.ssm_scan(
        u.data_ptr(), dt.data_ptr(), A.data_ptr(), B_ssm.data_ptr(),
        C_ssm.data_ptr(), None if h0 is None else h0.data_ptr(),
        y.data_ptr(), h.data_ptr(), Bsz, S, d, N, build.DTYPE_CODES[u.dtype],
        -1 if h0 is None else build.DTYPE_CODES[h0.dtype],
        build.DTYPE_CODES[y_dtype], build.DTYPE_CODES[h.dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssm_scan launch failed: cudaError {err}")
    launches["ssm_scan"] += 1
    return y, h
