"""One attention+MoE block's decode step: the plain PyTorch version and
the launcher of the CUDA chain (``csrc/decode_megastep.cu``).

Both compute ``repro.kernels.ref.decode_megastep_ref``: paged attention
-> ``o @ w_post`` + x -> RMS norm -> router top-k with the §3.4 mask ->
replica selection from the MoERuntime arrays -> the routed experts'
SwiGLU over per-expert slot tables (+ the shared experts' SwiGLU) ->
combine + residual.  They return ``(y, h2)``, each (B, D) in x's type.

The plain version follows the reference op for op.  In bf16 it keeps
two intermediates in f32 where the reference rounds them and the Pallas
kernel and the CUDA chain do not: the attention probabilities before
``p @ V`` (except where the chain's attention is the tensor-core latent
kernel, which rounds them to bf16 as the reference does) and the router
logits.  Routing is a discontinuous function of the logits, so this
keeps the plain version's expert choices equal to the kernel's; in f32
nothing changes.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import build, launches
from repro_torch.kernels.moe_fused import moe_fused_plain
from repro_torch.kernels.paged_attention import (MAX_HEAD_DIM,
                                                 paged_attention_plain,
                                                 takes_latent_kernel)
from repro_torch.kernels.router_topk import router_topk_plain
from repro_torch.models.layers import rms_norm

_VP, _CI = ctypes.c_void_p, ctypes.c_int
_PROTOTYPES = {
    "decode_megastep": ([_VP] * 28 + [_CI] * 14 + [ctypes.c_float, _CI, _VP],
                        _CI),
    "decode_megastep_workspace_bytes": ([_CI] * 14, ctypes.c_longlong),
    "decode_megastep_smem_bytes": ([_CI] * 3, ctypes.c_longlong),
}


def decode_megastep_plain(q, k_pool, v_pool, block_table, seq_lens,
                          start_lens, x, w_post, ln2_w, router_w, l2p,
                          replica_count, expert_mask, gate_w, up_w, down_w,
                          expert_offset, shared_gate=None, shared_up=None,
                          shared_down=None, *, top_k: int, cap: int,
                          e_local: int, eps: float = 1e-5, route_h2=None):
    """Shapes as ``ref.decode_megastep_ref``: q (B, H, Da); pools (nb, bs,
    Hkv, Da); block_table (B, max_blk), seq_lens / start_lens (B,); x (B,
    D); w_post (H*Da, D); ln2_w (D,); router_w (D, E_log); l2p (E_log,
    R), replica_count / expert_mask (E_log,); gate_w / up_w (E, D, F),
    down_w (E, F, D); shared_* (D, Fs) / (Fs, D) or None.

    ``route_h2`` (B, D): route and run the experts over this h2 (the
    chain's own) rather than the plain version's.  Routing is a
    discontinuous function of h2, so two h2 within rounding of each other
    may pick different experts where a row's logits nearly tie; a check
    of the chain holds its route tables to the plain router over its own
    h2 and its y to this."""
    from repro_torch.models.moe import MoERuntime, select_replicas
    B = q.shape[0]
    dt = x.dtype
    # p is rounded to V's type before p @ V: bf16 where the chain rounds it
    v = v_pool if takes_latent_kernel(q, k_pool, v_pool) else v_pool.float()
    o = paged_attention_plain(q.float(), k_pool.float(), v, block_table,
                              seq_lens, start_lens)
    x2 = x + (o.reshape(B, -1).to(dt).float() @ w_post.float()).to(dt)
    h2 = rms_norm(x2, ln2_w, eps)
    hr = h2 if route_h2 is None else route_h2
    logits = hr.float() @ router_w.float()
    w, sel = router_topk_plain(logits, expert_mask, top_k)
    phys, alive = select_replicas(
        sel.long(), MoERuntime(l2p, replica_count, expert_mask))
    y = x2 + moe_fused_plain(hr, gate_w, up_w, down_w, w, phys, alive,
                             cap=cap, expert_offset=expert_offset,
                             e_local=e_local)
    if shared_gate is not None:
        # the shared experts' SwiGLU over h2 (or route_h2), as
        # ffn_apply("swiglu")
        y = y + (F.silu(hr @ shared_gate) * (hr @ shared_up)) @ shared_down
    return y, h2


def decode_megastep_cuda(q, k_pool, v_pool, block_table, seq_lens,
                         start_lens, x, w_post, ln2_w, router_w, l2p,
                         replica_count, expert_mask, gate_w, up_w, down_w,
                         expert_offset, shared_gate=None, shared_up=None,
                         shared_down=None, *, top_k: int, cap: int,
                         e_local: int, eps: float = 1e-5,
                         return_route: bool = False):
    """Enqueue the whole block step on PyTorch's current stream: one C
    call, a fixed chain of kernels, no synchronisation.  Raises on any
    input the chain does not take; never falls back.  With ``return_route`` it also
    returns the route and slot tables it built: ``{"sel", "w"}`` (B, k)
    and ``{"tok_idx", "wgt"}`` (E, cap), ``"slot_of"`` (B, k)."""
    if x.device.type != "cuda":
        raise ValueError(f"decode_megastep_cuda needs CUDA tensors, got "
                         f"{x.device}")
    dt = x.dtype
    if dt not in build.DTYPE_CODES:
        raise TypeError(f"decode_megastep: unsupported dtype {dt}")
    B, H, Da = q.shape
    nb, bs, Hkv, _ = k_pool.shape
    max_blk = block_table.shape[1]
    D = x.shape[1]
    E, _, Fd = gate_w.shape
    E_log = router_w.shape[1]
    R = l2p.shape[1]
    Fs = 0 if shared_gate is None else shared_gate.shape[1]
    if E != e_local:
        raise ValueError(f"decode_megastep: bank holds {E} experts, "
                         f"e_local={e_local}")
    if not 0 < top_k <= E_log or cap < 1:
        raise ValueError(f"decode_megastep: top_k={top_k} of {E_log}, "
                         f"cap={cap}")
    if Da > MAX_HEAD_DIM or H % Hkv:
        raise ValueError(f"decode_megastep: {H} heads over {Hkv} KV heads "
                         f"at Da={Da} (at most {MAX_HEAD_DIM})")
    dev = x.device
    for name, t, dtype, shape in (
            ("q", q, dt, (B, H, Da)),
            ("k_pool", k_pool, dt, (nb, bs, Hkv, Da)),
            ("v_pool", v_pool, dt, (nb, bs, Hkv, Da)),
            ("block_table", block_table, torch.int32, (B, max_blk)),
            ("seq_lens", seq_lens, torch.int32, (B,)),
            ("x", x, dt, (B, D)),
            ("w_post", w_post, dt, (H * Da, D)),
            ("ln2_w", ln2_w, dt, (D,)),
            ("router_w", router_w, dt, (D, E_log)),
            ("l2p", l2p, torch.int32, (E_log, R)),
            ("replica_count", replica_count, torch.int32, (E_log,)),
            ("expert_mask", expert_mask, torch.bool, (E_log,)),
            ("gate_w", gate_w, dt, (E, D, Fd)),
            ("up_w", up_w, dt, (E, D, Fd)),
            ("down_w", down_w, dt, (E, Fd, D))):
        build.check_arg(name, t, dtype, shape, dev)
    if start_lens is not None:
        build.check_arg("start_lens", start_lens, torch.int32, (B,), dev)
    if Fs:
        build.check_arg("shared_gate", shared_gate, dt, (D, Fs), dev)
        build.check_arg("shared_up", shared_up, dt, (D, Fs), dev)
        build.check_arg("shared_down", shared_down, dt, (Fs, D), dev)
    if isinstance(expert_offset, torch.Tensor):
        offset = expert_offset.reshape(1)
        build.check_arg("expert_offset", offset, torch.int32, (1,), dev)
    else:   # one fill kernel; the model passes a tensor it keeps
        offset = torch.full((1,), int(expert_offset), dtype=torch.int32,
                            device=dev)
    lib = build.load("decode_megastep", _PROTOTYPES)
    smem = lib.decode_megastep_smem_bytes(B, D, cap)
    if smem > build.MAX_SMEM_BYTES:
        raise ValueError(f"decode_megastep: B={B}, D={D}, cap={cap} exceed "
                         f"shared memory")
    code = build.DTYPE_CODES[dt]
    y = torch.empty_like(x)
    h2 = torch.empty_like(x)
    n, s = B * top_k, E * cap
    ints = torch.empty(2 * n + s, dtype=torch.int32, device=dev)
    floats = torch.empty(n + s, dtype=torch.float32, device=dev)
    route = dict(sel=ints[:n].view(B, top_k),
                 slot_of=ints[n:2 * n].view(B, top_k),
                 tok_idx=ints[2 * n:].view(E, cap),
                 w=floats[:n].view(B, top_k), wgt=floats[n:].view(E, cap))
    ws = torch.empty(lib.decode_megastep_workspace_bytes(
        B, H, Hkv, Da, bs, max_blk, D, E_log, E, Fd, Fs, cap, top_k, code),
        dtype=torch.uint8, device=dev)
    if B:
        ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        err = lib.decode_megastep(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            block_table.data_ptr(), seq_lens.data_ptr(), ptr(start_lens),
            x.data_ptr(), w_post.data_ptr(), ln2_w.data_ptr(),
            router_w.data_ptr(), l2p.data_ptr(), replica_count.data_ptr(),
            expert_mask.data_ptr(), gate_w.data_ptr(), up_w.data_ptr(),
            down_w.data_ptr(), offset.data_ptr(), ptr(shared_gate),
            ptr(shared_up), ptr(shared_down), y.data_ptr(), h2.data_ptr(),
            route["sel"].data_ptr(), route["w"].data_ptr(),
            route["tok_idx"].data_ptr(), route["wgt"].data_ptr(),
            route["slot_of"].data_ptr(), ws.data_ptr(), B, H, Hkv, Da, bs,
            max_blk, D, E_log, R, E, Fd, Fs, cap, top_k, eps, code,
            torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"decode_megastep launch failed: cudaError "
                               f"{err}")
        launches["decode_megastep"] += 1
        launches["router_topk"] += 1      # its route stage
    return (y, h2, route) if return_route else (y, h2)
