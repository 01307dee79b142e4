"""Fused MoE dispatch -> grouped SwiGLU FFN -> weighted combine: the sort
pass, the plain PyTorch version and the launcher of the CUDA kernel
(``csrc/moe_fused.cu``).

Both compute ``repro.kernels.ref.moe_fused_ref``.  One stable sort over
the copies' expert ids (:func:`moe_group_tokens`, plain PyTorch on
whichever device the routing lies on) yields per-expert slot tables; the
plain version gathers, runs the expert SwiGLU as einsums and scatter-adds,
the kernel does the same work without the (E, cap, D) gather and with a
deterministic combine (bf16 on the tensor cores, f32 on FMA).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, launches
from repro_torch.kernels.expert_ffn import expert_ffn_plain

_VP, _CI = ctypes.c_void_p, ctypes.c_int
_PROTOTYPES = {
    "moe_fused": ([_VP] * 10 + [_CI] * 7 + [_VP], _CI),
    "moe_fused_smem_bytes": ([_CI] * 4, ctypes.c_longlong),
}


def group_by_expert(ids: torch.Tensor, ok: torch.Tensor, n_groups: int,
                    cap: int):
    """The single sort pass shared by every dispatch implementation.

    ids: (N,) group ids; ok: (N,) bool validity.  Returns
    (order, group, slot): ``order`` sorts the flat copies by group id
    (invalid entries last), ``group``/``slot`` are each sorted element's
    coordinates, with invalid and over-capacity elements mapped out of
    bounds to (n_groups, cap).  Drop semantics live here: capacity keeps
    the *first* copies of each group in flat order, so the sort must be
    stable.
    """
    N = ids.shape[0]
    key = torch.where(ok, ids.long(), n_groups)       # dropped sort last
    sorted_k, order = torch.sort(key, stable=True)
    first = torch.searchsorted(sorted_k, sorted_k, side="left")
    pos = torch.arange(N, device=ids.device) - first
    keep = (sorted_k < n_groups) & (pos < cap)
    group = torch.where(keep, sorted_k, n_groups)
    slot = torch.where(keep, pos, cap)
    return order, group, slot


def moe_group_tokens(phys, alive, weights, *, expert_offset: int,
                     e_local: int, cap: int):
    """Routing outputs -> per-expert slot tables.

    phys/alive/weights: (T, k).  Returns ``(tok_idx (E, cap) i32, wgt
    (E, cap) f32, slot_of (T, k) i32)``: the token row filling each slot
    and its combine weight (empty slots: 0 and 0), and for each copy its
    flat slot ``e * cap + c`` or -1 when it was dropped.

    No boolean-mask indexing, so nothing waits for the device: dropped
    copies scatter into one trailing trash slot (index ``e_local * cap``,
    cut off at the end), kept copies own distinct slots.
    """
    T, k = phys.shape
    N = T * k
    E_cap = e_local * cap
    dev = phys.device
    e_id = phys.reshape(N).long() - expert_offset
    ok = (e_id >= 0) & (e_id < e_local) & alive.reshape(N)
    order, group, slot = group_by_expert(e_id, ok, e_local, cap)
    keep = group < e_local
    flat = torch.where(keep, group * cap + slot, E_cap)
    tok_idx = torch.zeros(E_cap + 1, dtype=torch.int32, device=dev)
    tok_idx.scatter_(0, flat, (order // k).to(torch.int32))
    wgt = torch.zeros(E_cap + 1, dtype=torch.float32, device=dev)
    wgt.scatter_(0, flat, weights.reshape(N).float()[order])
    slot_of = torch.empty((N,), dtype=torch.int32, device=dev)
    slot_of.scatter_(0, order, torch.where(keep, flat, -1).to(torch.int32))
    return (tok_idx[:E_cap].view(e_local, cap),
            wgt[:E_cap].view(e_local, cap), slot_of.view(T, k))


def moe_fused_plain(x, gate_w, up_w, down_w, weights, phys, alive, *,
                    cap: int, expert_offset: int = 0, e_local: int):
    """Gather -> grouped FFN -> scatter-add, in x's type.  x: (T, D)."""
    T, D = x.shape
    tok_idx, wgt, _ = moe_group_tokens(
        phys, alive, weights, expert_offset=expert_offset, e_local=e_local,
        cap=cap)
    xe = x[tok_idx.long()] * (wgt != 0.0)[..., None].to(x.dtype)
    out = expert_ffn_plain(xe, gate_w, up_w, down_w)
    contrib = (wgt[..., None] * out.float()).reshape(-1, D).to(x.dtype)
    return torch.zeros((T, D), dtype=x.dtype, device=x.device).index_add_(
        0, tok_idx.reshape(-1).long(), contrib)


def moe_fused_cuda(x, gate_w, up_w, down_w, weights, phys, alive, *,
                   cap: int, expert_offset: int = 0, e_local: int):
    """The sort pass on the device, then the CUDA kernel on PyTorch's
    current stream.  Raises on any input the kernel does not take."""
    build.refuse_grad("moe_fused_cuda", x, gate_w, up_w, down_w, weights)
    if x.device.type != "cuda":
        raise ValueError(f"moe_fused_cuda needs CUDA tensors, got {x.device}")
    if x.dtype not in build.DTYPE_CODES:
        raise TypeError(f"moe_fused: unsupported dtype {x.dtype}")
    T, D = x.shape
    E, _, Fd = gate_w.shape
    k = phys.shape[1]
    if E != e_local:
        raise ValueError(f"moe_fused: bank holds {E} experts, "
                         f"e_local={e_local}")
    dev = x.device
    build.check_arg("x", x, x.dtype, (T, D), dev)
    build.check_arg("gate_w", gate_w, x.dtype, (E, D, Fd), dev)
    build.check_arg("up_w", up_w, x.dtype, (E, D, Fd), dev)
    build.check_arg("down_w", down_w, x.dtype, (E, Fd, D), dev)
    for name, t in (("weights", weights), ("phys", phys), ("alive", alive)):
        if t.device != dev or tuple(t.shape) != (T, k):
            raise ValueError(f"moe_fused: {name} must be ({T}, {k}) on {dev}")
    lib = build.load("moe_fused", _PROTOTYPES)
    code = build.DTYPE_CODES[x.dtype]
    smem = lib.moe_fused_smem_bytes(D, Fd, cap, code)
    if smem > build.MAX_SMEM_BYTES:
        raise ValueError(f"moe_fused: D={D}, F={Fd} need {smem} B of "
                         f"shared memory")
    y = torch.empty_like(x)
    if T == 0:
        return y
    tok_idx, wgt, slot_of = moe_group_tokens(
        phys, alive, weights, expert_offset=expert_offset, e_local=e_local,
        cap=cap)
    h_buf = torch.empty((E, cap, Fd), dtype=x.dtype, device=dev)
    out_buf = torch.empty((E, cap, D), dtype=torch.float32, device=dev)
    err = lib.moe_fused(
        x.data_ptr(), gate_w.data_ptr(), up_w.data_ptr(), down_w.data_ptr(),
        tok_idx.data_ptr(), wgt.data_ptr(), slot_of.data_ptr(),
        h_buf.data_ptr(), out_buf.data_ptr(), y.data_ptr(),
        T, k, D, Fd, E, cap, code,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"moe_fused launch failed: cudaError {err}")
    launches["moe_fused"] += 1
    return y
