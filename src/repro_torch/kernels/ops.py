"""Public wrappers of the kernels, dispatched by the tensors' device.

A CUDA tensor launches the hand-written kernel; a CPU tensor runs its
plain PyTorch version (``repro.kernels.ops`` decides by the JAX backend
instead, through ``_on_cpu``).  There is no fallback from one to the
other: a launcher that cannot take its inputs raises.

``flash_prefill``, ``expert_ffn`` and ``ssm_scan`` have backward
kernels: under grad mode, with an input that requires grad, they go
through their ``torch.autograd.Function`` (a training forward); otherwise
they launch the forward kernel directly, as serving does.  The other
kernels have no backward, and their launchers raise on an input that
requires grad.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.decode_megastep import (decode_megastep_cuda,
                                                 decode_megastep_plain)
from repro_torch.kernels.expert_ffn import (ExpertFFN, expert_ffn_cuda,
                                            expert_ffn_plain)
from repro_torch.kernels.flash_prefill import (FlashPrefill,
                                               flash_prefill_cuda,
                                               flash_prefill_plain)
from repro_torch.kernels.moe_fused import moe_fused_cuda, moe_fused_plain
from repro_torch.kernels.paged_attention import (paged_attention_cuda,
                                                 paged_attention_plain)
from repro_torch.kernels.router_topk import (router_topk_cuda,
                                             router_topk_plain)
from repro_torch.kernels.ssm_scan import SSMScan
from repro_torch.kernels.ssm_scan import ssm_scan as _ssm_scan


def needs_grad(*tensors) -> bool:
    """Grad mode is on and some input requires grad."""
    return torch.is_grad_enabled() and any(t.requires_grad
                                           for t in tensors)


def on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"no kernel for tensors on {t.device}")


def paged_attention(q, k_pool, v_pool, block_table, seq_lens,
                    start_lens=None, lse_out=None):
    """Decode attention over a paged pool (GQA, or MLA's latent pool with
    K = V).  ``start_lens`` (optional, (B,)) is the first valid position
    per row — the sliding-window lower bound; None attends from 0.
    ``lse_out`` (optional, (B, H) f32) takes each row's log-sum-exp of
    its scaled scores (-inf for a row with no valid position), and the
    output comes back in f32."""
    fn = paged_attention_plain if on_cpu(q) else paged_attention_cuda
    return fn(q, k_pool, v_pool, block_table, seq_lens, start_lens,
              lse_out=lse_out)


def moe_dispatch_ffn_combine(x, gate_w, up_w, down_w, weights, phys, alive,
                             expert_offset: int, *, cap: int, e_local: int):
    """Fused MoE dispatch -> grouped SwiGLU FFN -> weighted combine over
    the expert slots ``[expert_offset, expert_offset + e_local)``."""
    fn = moe_fused_plain if on_cpu(x) else moe_fused_cuda
    return fn(x, gate_w, up_w, down_w, weights, phys, alive, cap=cap,
              expert_offset=expert_offset, e_local=e_local)


def expert_ffn(x, gate_w, up_w, down_w):
    """Grouped expert SwiGLU over a dense capacity buffer:
    (E, C, D) -> (E, C, D), f32 accumulate, h cast to x's type."""
    cpu = on_cpu(x)
    if needs_grad(x, gate_w, up_w, down_w):
        return ExpertFFN.apply(x, gate_w, up_w, down_w)
    fn = expert_ffn_plain if cpu else expert_ffn_cuda
    return fn(x, gate_w, up_w, down_w)


def flash_prefill(q, k, v, q_pos=None, kv_pos=None, *, causal: bool = True,
                  window: int = 0):
    """Whole-prompt attention, q (B, Sq, H, Dq) over k (B, Skv, Hkv, Dq)
    and v (B, Skv, Hkv, Dv) -> (B, Sq, H, Dv), masked by positions (None:
    ``arange``): causal, and within ``window`` where it is > 0."""
    cpu = on_cpu(q)
    if needs_grad(q, k, v):
        return FlashPrefill.apply(q, k, v, q_pos, kv_pos, causal, window)
    fn = flash_prefill_plain if cpu else flash_prefill_cuda
    return fn(q, k, v, q_pos, kv_pos, causal=causal, window=window)


def ssm_scan(u, dt, A, B_ssm, C_ssm, h0=None, *, h_out=None,
             y_dtype=torch.float32):
    """Mamba-1 selective scan over u / dt (B, S, d), A (d, N), B / C (B,
    S, N), from ``h0`` (B, d, N) or zero.  Returns (y (B, S, d) f32,
    h_final (B, d, N) f32); with ``h_out`` (which may be ``h0``) h_final
    is written there in its type, and y comes back in ``y_dtype``.  Under
    grad it starts from zero (``SSMScan`` refuses the in-place mode).  Under
    a trace, one op (``repro_torch::ssm_scan``) whatever the length."""
    on_cpu(u)
    if needs_grad(*(t for t in (u, dt, A, B_ssm, C_ssm, h0)
                    if t is not None)):
        return SSMScan.apply(u, dt, A, B_ssm, C_ssm, h0, h_out, y_dtype)
    return _ssm_scan(u, dt, A, B_ssm, C_ssm, h0, h_out=h_out,
                     y_dtype=y_dtype)


def router_topk(logits, expert_mask, k: int):
    """Masked softmax -> top-k -> renormalise over (T, E) logits.
    Returns (weights (T, k) f32, indices (T, k) int32)."""
    fn = router_topk_plain if on_cpu(logits) else router_topk_cuda
    return fn(logits, expert_mask, k)


def decode_megastep(q, k_pool, v_pool, block_table, seq_lens, start_lens,
                    x, w_post, ln2_w, router_w, l2p, replica_count,
                    expert_mask, gate_w, up_w, down_w, expert_offset,
                    shared_gate=None, shared_up=None, shared_down=None, *,
                    top_k: int, cap: int, e_local: int, eps: float = 1e-5):
    """One attention+MoE block's decode step: paged attention -> output
    projection -> residual -> norm -> router top-k -> replica select ->
    routed (+ shared) expert SwiGLU -> combine -> residual.  The paging
    arrays, ``expert_offset`` and the MoERuntime arrays are data, so
    recovery edits never change what is launched.  ``shared_*`` are the
    shared experts' SwiGLU weights or None.  Returns ``(y, h2)``."""
    fn = decode_megastep_plain if on_cpu(x) else decode_megastep_cuda
    return fn(q, k_pool, v_pool, block_table, seq_lens, start_lens, x,
              w_post, ln2_w, router_w, l2p, replica_count, expert_mask,
              gate_w, up_w, down_w, expert_offset, shared_gate, shared_up,
              shared_down, top_k=top_k, cap=cap, e_local=e_local, eps=eps)
