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

Its gradient (``csrc/ssm_scan_bwd.cu``, new in the port: ``repro``
differentiates its Mamba mixer's ``lax.scan``, ``src/repro/models/
mamba.py:90``, and has no backward kernel) runs the recurrence backwards:
with g_t the gradient of h_t, ``g_t = dy_t C_t + exp(dt_{t+1} A)
g_{t+1}`` (the last adds h_final's gradient), then ``dC_t = sum_d dy_t
h_t``, ``dB_t = sum_d g_t dt_t u_t``, ``du_t = dt_t sum_n g_t B_t``,
``ddt_t = u_t sum_n g_t B_t + sum_n A exp(dt_t A) g_t h_{t-1}`` and ``dA
= sum_{b,t} dt_t exp(dt_t A) g_t h_{t-1}``.  :class:`SSMScan` is the
``torch.autograd.Function`` that pairs the two kernels (the plain
versions for CPU tensors), from a zero state: serving's in-place mode has
no gradient.  The plain versions compute in f32, or in f64 for f64
inputs (``gradcheck``).

Both directions are ``torch.library`` custom ops, ``repro_torch::ssm_scan``
and ``repro_torch::ssm_scan_bwd``, each one traced operation with a fake
implementation (shapes and types only), so that a trace under
``FakeTensorMode`` (the dry run) never runs the plain versions' loops over
time.  Their FLOPs are registered with ``torch.utils.flop_counter``: the
formulas count what the plain loops' products count (:func:`scan_flops`,
:func:`scan_bwd_flops`).  :func:`ssm_scan` and :class:`SSMScan` take the
ops only under a dispatch mode (a trace); eager, they call the plain
version (CPU tensors) or the kernel (CUDA ones) directly, so a decode
step pays no custom op's dispatch and its results are the functions'.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build, launches
from repro_torch.kernels.flash_prefill import acc_dtype

_VP, _CI = ctypes.c_void_p, ctypes.c_int
_PROTOTYPES = {"ssm_scan": ([_VP] * 8 + [_CI] * 8 + [_VP], _CI)}
_BWD_PROTOTYPES = {
    "ssm_scan_bwd": ([_VP] * 13 + [_CI] * 5 + [_VP], _CI),
    "ssm_scan_bwd_scratch_floats": ([_CI] * 4, ctypes.c_longlong),
}
STATE_SIZES = (8, 16)       # the N the kernel is built for


def ssm_scan_plain(u, dt, A, B_ssm, C_ssm, h0=None, *, h_out=None,
                   y_dtype=torch.float32):
    """u / dt (B, S, d); A (d, N); B_ssm / C_ssm (B, S, N); h0 (B, d, N)
    or None.  A loop over time in f32.  ``h_out`` (B, d, N), in its own
    type and possibly ``h0`` itself, receives the final state, which is
    then what is returned; y comes back in ``y_dtype``."""
    Bsz, S, d = u.shape
    N = A.shape[1]
    acc = acc_dtype(u.dtype)
    h = (torch.zeros((Bsz, d, N), dtype=acc, device=u.device)
         if h0 is None else h0.to(acc))
    A = A.to(acc)
    ys = []
    for t in range(S):
        dt_t, u_t = dt[:, t].to(acc), u[:, t].to(acc)
        dA = torch.exp(dt_t[..., None] * A[None])
        dBu = (dt_t * u_t)[..., None] * B_ssm[:, t, None, :].to(acc)
        h = dA * h + dBu
        ys.append(torch.einsum("bdn,bn->bd", h, C_ssm[:, t].to(acc)))
    y = (torch.stack(ys, dim=1) if ys else
         torch.zeros((Bsz, 0, d), dtype=acc, device=u.device))
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
    build.refuse_grad("ssm_scan_cuda", u, dt, A, B_ssm, C_ssm, h0,
                      hint="its output carries no gradient: ops.ssm_scan "
                           "launches it through SSMScan, with its backward "
                           "kernel")
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


def ssm_scan_bwd_plain(u, dt, A, B_ssm, C_ssm, dy, dh=None):
    """The gradients (du, ddt, dA, dB, dC) of :func:`ssm_scan_plain` from a
    zero state, for y's gradient ``dy`` (B, S, d) and h_final's ``dh`` (B,
    d, N) or None (zero), written out: the states recomputed and kept,
    then a loop backwards over time.  Each gradient in its input's
    type."""
    acc = acc_dtype(u.dtype)
    uf, dtf, Bf, Cf, dyf = (t.to(acc) for t in (u, dt, B_ssm, C_ssm, dy))
    Af = A.to(acc)
    Bsz, S, d = u.shape
    decay = torch.exp(dtf[..., None] * Af)          # exp(dt_t A), (B,S,d,N)
    dtu = dtf * uf
    hs = []
    h = torch.zeros((Bsz, d, Af.shape[1]), dtype=acc, device=u.device)
    for t in range(S):
        h = decay[:, t] * h + dtu[:, t, :, None] * Bf[:, t, None, :]
        hs.append(h)
    g = torch.zeros_like(h) if dh is None else dh.to(acc)
    du, ddt = torch.empty_like(uf), torch.empty_like(uf)
    dB, dC = torch.empty_like(Bf), torch.empty_like(Cf)
    dA = torch.zeros_like(Af)
    for t in reversed(range(S)):
        g = g + dyf[:, t, :, None] * Cf[:, t, None, :]          # g_t
        h_prev = hs[t - 1] if t else torch.zeros_like(g)
        dC[:, t] = torch.einsum("bdn,bd->bn", hs[t], dyf[:, t])
        dB[:, t] = torch.einsum("bdn,bd->bn", g, dtu[:, t])
        gb = torch.einsum("bdn,bn->bd", g, Bf[:, t])
        gdh = g * decay[:, t] * h_prev
        du[:, t] = dtf[:, t] * gb
        ddt[:, t] = uf[:, t] * gb + torch.einsum("bdn,dn->bd", gdh, Af)
        dA += torch.einsum("bdn,bd->dn", gdh, dtf[:, t])
        g = g * decay[:, t]                                  # to step t-1
    return (du.to(u.dtype), ddt.to(dt.dtype), dA.to(A.dtype),
            dB.to(B_ssm.dtype), dC.to(C_ssm.dtype))


def ssm_scan_bwd_cuda(u, dt, A, B_ssm, C_ssm, dy, dh=None):
    """Launch the backward kernels on PyTorch's current stream: the
    gradients (du, ddt, dA, dB, dC) of the scan from a zero state, for
    y's gradient ``dy`` (B, S, d) f32 and h_final's ``dh`` (B, d, N) f32
    or None.  Raises on any input they do not take; never falls back."""
    build.refuse_grad("ssm_scan_bwd_cuda", u, dt, A, B_ssm, C_ssm, dy, dh)
    if u.device.type != "cuda":
        raise ValueError(f"ssm_scan_bwd_cuda needs CUDA tensors, got "
                         f"{u.device}")
    if u.dtype not in build.DTYPE_CODES:
        raise TypeError(f"ssm_scan_bwd: unsupported dtype {u.dtype}")
    Bsz, S, d = u.shape
    N = A.shape[1]
    if N not in STATE_SIZES:
        raise ValueError(f"ssm_scan_bwd: state size {N} not in "
                         f"{STATE_SIZES}")
    dev = u.device
    build.check_arg("u", u, u.dtype, (Bsz, S, d), dev)
    build.check_arg("dt", dt, u.dtype, (Bsz, S, d), dev)
    build.check_arg("A", A, torch.float32, (d, N), dev)
    build.check_arg("B_ssm", B_ssm, u.dtype, (Bsz, S, N), dev)
    build.check_arg("C_ssm", C_ssm, u.dtype, (Bsz, S, N), dev)
    build.check_arg("dy", dy, torch.float32, (Bsz, S, d), dev)
    if dh is not None:
        build.check_arg("dh", dh, torch.float32, (Bsz, d, N), dev)
    lib = build.load("ssm_scan_bwd", _BWD_PROTOTYPES)
    du, ddt, dA = torch.empty_like(u), torch.empty_like(dt), \
        torch.empty_like(A)
    dB, dC = torch.empty_like(B_ssm), torch.empty_like(C_ssm)
    if u.numel() == 0:
        return du, ddt, dA.zero_(), dB.zero_(), dC.zero_()
    # the states at each time chunk's start, and the per-CTA and per-row
    # partial sums of dB, dC and dA that a second pass adds in order
    scratch = torch.empty(lib.ssm_scan_bwd_scratch_floats(Bsz, S, d, N),
                          dtype=torch.float32, device=dev)
    err = lib.ssm_scan_bwd(
        u.data_ptr(), dt.data_ptr(), A.data_ptr(), B_ssm.data_ptr(),
        C_ssm.data_ptr(), dy.data_ptr(),
        None if dh is None else dh.data_ptr(), scratch.data_ptr(),
        du.data_ptr(), ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(),
        dC.data_ptr(), Bsz, S, d, N, build.DTYPE_CODES[u.dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssm_scan_bwd launch failed: cudaError {err}")
    launches["ssm_scan_bwd"] += 1
    return du, ddt, dA, dB, dC


def scan_flops(u_shape, A_shape) -> int:
    """The FLOPs ``torch.utils.flop_counter`` counts in the plain scan: one
    (B, d, N) x (B, N) product a step, 2 B d N each."""
    Bsz, S, d = u_shape
    return 2 * Bsz * S * d * A_shape[1]


def scan_bwd_flops(u_shape, A_shape) -> int:
    """The same for the plain backward: five such products a step (dC, dB,
    the g . B sum, ddt's and dA's sums over the state)."""
    return 5 * scan_flops(u_shape, A_shape)


# the scan and its gradient as custom ops (the module's docstring)

@torch.library.custom_op("repro_torch::ssm_scan", mutates_args=("h_out",))
def ssm_scan_op(u: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B_ssm: torch.Tensor, C_ssm: torch.Tensor,
                h0: Optional[torch.Tensor], h_out: Optional[torch.Tensor],
                y_dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y, h_final) of the plain version (CPU) or the kernel (CUDA); with
    ``h_out`` the final state is written there and the second output is
    empty (an op's output may not alias its input)."""
    fn = ssm_scan_plain if u.device.type == "cpu" else ssm_scan_cuda
    y, h = fn(u, dt, A, B_ssm, C_ssm, h0, h_out=h_out, y_dtype=y_dtype)
    return y, (h.new_empty(0) if h_out is not None else h)


@ssm_scan_op.register_fake
def _scan_fake(u, dt, A, B_ssm, C_ssm, h0, h_out, y_dtype):
    Bsz, S, d = u.shape
    y = u.new_empty((Bsz, S, d), dtype=y_dtype)
    if h_out is not None:
        return y, u.new_empty(0, dtype=h_out.dtype)
    return y, u.new_empty((Bsz, d, A.shape[1]), dtype=acc_dtype(u.dtype))


@torch.library.custom_op("repro_torch::ssm_scan_bwd", mutates_args=())
def ssm_scan_bwd_op(u: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                    B_ssm: torch.Tensor, C_ssm: torch.Tensor,
                    dy: torch.Tensor, dh: Optional[torch.Tensor]
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                               torch.Tensor, torch.Tensor]:
    """(du, ddt, dA, dB, dC) of the plain backward (CPU) or the kernel."""
    fn = ssm_scan_bwd_plain if u.device.type == "cpu" else ssm_scan_bwd_cuda
    return tuple(fn(u, dt, A, B_ssm, C_ssm, dy, dh))


@ssm_scan_bwd_op.register_fake
def _scan_bwd_fake(u, dt, A, B_ssm, C_ssm, dy, dh):
    return tuple(torch.empty_like(t) for t in (u, dt, A, B_ssm, C_ssm))


@register_flop_formula(torch.ops.repro_torch.ssm_scan)
def _scan_flop_formula(u_shape, dt_shape, A_shape, *args, **kwargs) -> int:
    return scan_flops(u_shape, A_shape)


@register_flop_formula(torch.ops.repro_torch.ssm_scan_bwd)
def _scan_bwd_flop_formula(u_shape, dt_shape, A_shape, *args,
                           **kwargs) -> int:
    return scan_bwd_flops(u_shape, A_shape)


def _tracing() -> bool:
    """Whether a dispatch mode is on (the dry run's ``FakeTensorMode`` and
    its tally): the scan must then be one op."""
    return torch._C._len_torch_dispatch_stack() > 0


def ssm_scan(u, dt, A, B_ssm, C_ssm, h0=None, *, h_out=None,
             y_dtype=torch.float32):
    """(y, h_final), h_final ``h_out`` itself where given: one traced op
    under a trace, else the plain version or the kernel called directly."""
    if not _tracing():
        fn = ssm_scan_plain if u.device.type == "cpu" else ssm_scan_cuda
        return fn(u, dt, A, B_ssm, C_ssm, h0, h_out=h_out, y_dtype=y_dtype)
    y, h = ssm_scan_op(u, dt, A, B_ssm, C_ssm, h0, h_out, y_dtype)
    return y, (h_out if h_out is not None else h)


def ssm_scan_bwd(u, dt, A, B_ssm, C_ssm, dy, dh=None):
    """(du, ddt, dA, dB, dC): as :func:`ssm_scan`, the op under a trace."""
    if not _tracing():
        fn = (ssm_scan_bwd_plain if u.device.type == "cpu"
              else ssm_scan_bwd_cuda)
        return fn(u, dt, A, B_ssm, C_ssm, dy, dh)
    return ssm_scan_bwd_op(u, dt, A, B_ssm, C_ssm, dy, dh)


class SSMScan(torch.autograd.Function):
    """The selective scan from a zero state with its gradient: the forward
    kernel (its plain version for CPU tensors), then the backward kernel
    (likewise), which recomputes the states from the saved inputs.
    Returns (y, h_final) as the forward does; h_final's gradient is used
    where a caller uses h_final.  ``h0``, ``h_out`` and ``y_dtype``, the
    decode step's in-place mode, have no gradient and raise."""

    @staticmethod
    def forward(ctx, u, dt, A, B_ssm, C_ssm, h0=None, h_out=None,
                y_dtype=torch.float32):
        if h0 is not None or h_out is not None or y_dtype != torch.float32:
            raise RuntimeError(
                "SSMScan: the in-place decode mode (h0, h_out, y_dtype) has "
                "no gradient; call it under torch.no_grad() or on tensors "
                "that need no gradient")
        y, h = ssm_scan(u, dt, A, B_ssm, C_ssm,
                        y_dtype=acc_dtype(u.dtype))
        ctx.save_for_backward(u, dt, A, B_ssm, C_ssm)
        ctx.set_materialize_grads(False)
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        u, dt, A, B_ssm, C_ssm = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(u.shape, dtype=acc_dtype(u.dtype),
                             device=u.device)
        grads = ssm_scan_bwd(u, dt, A, B_ssm, C_ssm, dy.contiguous(),
                             None if dh is None else dh.contiguous())
        return (*grads, None, None, None)
