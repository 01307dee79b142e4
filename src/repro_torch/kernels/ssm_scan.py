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
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, launches

_VP, _CI = ctypes.c_void_p, ctypes.c_int
_PROTOTYPES = {"ssm_scan": ([_VP] * 8 + [_CI] * 6 + [_VP], _CI)}
STATE_SIZES = (8, 16)       # the N the kernel is built for


def ssm_scan_plain(u, dt, A, B_ssm, C_ssm, h0=None):
    """u / dt (B, S, d); A (d, N); B_ssm / C_ssm (B, S, N); h0 (B, d, N)
    or None.  A loop over time in f32."""
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
    return y, h


def ssm_scan_cuda(u, dt, A, B_ssm, C_ssm, h0=None):
    """Launch the CUDA kernel on PyTorch's current stream.  Raises on any
    input the kernel does not take; never falls back."""
    if u.device.type != "cuda":
        raise ValueError(f"ssm_scan_cuda needs CUDA tensors, got {u.device}")
    if u.dtype not in build.DTYPE_CODES:
        raise TypeError(f"ssm_scan: unsupported dtype {u.dtype}")
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
    if h0 is not None:
        if h0.dtype not in build.DTYPE_CODES:
            raise TypeError(f"ssm_scan: unsupported h0 dtype {h0.dtype}")
        build.check_arg("h0", h0, h0.dtype, (Bsz, d, N), dev)
    lib = build.load("ssm_scan", _PROTOTYPES)
    y = torch.empty((Bsz, S, d), dtype=torch.float32, device=dev)
    h = torch.empty((Bsz, d, N), dtype=torch.float32, device=dev)
    if h.numel() == 0:
        return y, h
    err = lib.ssm_scan(
        u.data_ptr(), dt.data_ptr(), A.data_ptr(), B_ssm.data_ptr(),
        C_ssm.data_ptr(), None if h0 is None else h0.data_ptr(),
        y.data_ptr(), h.data_ptr(), Bsz, S, d, N, build.DTYPE_CODES[u.dtype],
        -1 if h0 is None else build.DTYPE_CODES[h0.dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssm_scan launch failed: cudaError {err}")
    launches["ssm_scan"] += 1
    return y, h
