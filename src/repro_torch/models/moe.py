"""Mixture-of-experts layer with ReviveMoE-aware routing.

Mirrors ``repro.models.moe``:

* Experts live in **physical slots**: ``E_phys = num_experts +
  num_redundant_experts``; redundant slots hold replicas of the first R
  logical experts (the paper's load-balancing replicas that double as
  fault-tolerance spares, §3.4).
* Routing picks **logical** experts, then :class:`MoERuntime` maps
  (logical id, token) -> physical slot.  Recovery mutates only this
  table (drop a dead replica, mask a lost expert): a data change.
* The local dispatch -> FFN -> combine has two implementations with the
  same semantics: :func:`dispatch_compute_combine` (dense scatter into a
  capacity buffer, its expert FFN through the ``expert_ffn`` kernel)
  and :func:`dispatch_compute_combine_fused` (the fused CUDA kernel),
  selected by a 'fused' suffix on ``cfg.moe_impl``.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.kernels import ops
from repro_torch.kernels.moe_fused import group_by_expert
from repro_torch.models.layers import dense_init

MAX_REPLICAS = 2  # base slot + at most one redundant replica per expert


class MoERuntime(NamedTuple):
    """Host-controlled routing state; mutated by ReviveMoE recovery."""

    logical_to_physical: torch.Tensor  # (E_log, MAX_REPLICAS) int32
    replica_count: torch.Tensor        # (E_log,) int32 >= 0 (0 = lost)
    expert_mask: torch.Tensor          # (E_log,) bool; False = masked


def default_runtime(moe: MoEConfig, device) -> MoERuntime:
    E, R = moe.num_experts, moe.num_redundant_experts
    ar = torch.arange(E, device=device)
    l2p = torch.stack([ar, torch.where(ar < R, E + ar, 0)], dim=1)
    count = torch.where(ar < R, 2, 1)
    return MoERuntime(l2p.to(torch.int32), count.to(torch.int32),
                      torch.ones(E, dtype=torch.bool, device=device))


def physical_experts(moe: MoEConfig) -> int:
    return moe.num_experts + moe.num_redundant_experts


def moe_init(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype,
             n_layers: int):
    """Router + physical expert bank for ``n_layers`` stacked layers.
    Replica slots start as true copies of logical experts [0, R)."""
    moe = cfg.moe
    D, Fd = cfg.d_model, moe.expert_d_ff
    E_log, R = moe.num_experts, moe.num_redundant_experts
    E_phys = E_log + R
    bank = {}
    for name, (a, b) in (("gate", (D, Fd)), ("up", (D, Fd)),
                         ("down", (Fd, D))):
        w = torch.empty((n_layers, E_phys, a, b), dtype=dtype,
                        device=gen.device)
        for layer in range(n_layers):   # one layer at a time: bounded temp
            w[layer, :E_log] = dense_init(gen, a, b, dtype, (E_log,))
        w[:, E_log:] = w[:, :R]
        bank[name] = w
    params = {"router": dense_init(gen, D, E_log, dtype, (n_layers,)),
              **bank}
    if moe.num_shared_experts:
        from repro_torch.models.ffn import ffn_init
        params["shared"] = ffn_init(
            gen, D, moe.num_shared_experts * moe.expert_d_ff, "swiglu",
            dtype, (n_layers,))
    return params


def route(router_w, x_flat, runtime: MoERuntime, moe: MoEConfig, *,
          with_aux: bool = False):
    """Top-k routing over logical experts with the §3.4 failure mask.

    Returns (weights (T,k) f32, sel (T,k) int64 logical ids), and with
    ``with_aux`` also the GShard load-balance loss ``E * sum(frac_tokens
    * frac_prob)`` over the logical experts, ``frac_prob`` the mean of
    the masked gates (a 0-d f32 tensor, as ``repro``'s ``route``
    returns it).  Ties go to the lower expert id, as ``jax.lax.top_k``
    breaks them.
    """
    logits = (x_flat @ router_w).float()                   # (T, E_log)
    logits = logits.masked_fill(~runtime.expert_mask[None, :],
                                float("-inf"))
    gates = torch.softmax(logits, dim=-1)
    weights, sel = torch.sort(gates, dim=-1, descending=True, stable=True)
    weights, sel = weights[:, :moe.top_k], sel[:, :moe.top_k]
    weights = weights / weights.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    if not with_aux:
        return weights, sel
    E = moe.num_experts
    onehot = torch.nn.functional.one_hot(sel, E).sum(dim=1)    # (T, E)
    frac_tokens = onehot.float().mean(dim=0)
    aux = E * torch.sum(frac_tokens * gates.mean(dim=0))
    return weights, sel, aux


def select_replicas(sel, runtime: MoERuntime):
    """Map logical selections to physical slots, alternating tokens over
    the replicas of a logical expert.  Returns (phys (T,k) int32, alive
    (T,k) bool); alive is False for experts with no live replica."""
    T, k = sel.shape
    count = runtime.replica_count[sel].long()
    replica = ((torch.arange(T, device=sel.device)[:, None]
                + torch.arange(k, device=sel.device)[None, :])
               % count.clamp_min(1))
    phys = torch.gather(runtime.logical_to_physical[sel].long(), -1,
                        replica[..., None])[..., 0]
    return phys.to(torch.int32), count > 0


def capacity(tokens_times_k: int, e_phys: int, cf: float,
             floor: int = 8) -> int:
    c = int(math.ceil(cf * tokens_times_k / max(e_phys, 1)))
    return max(floor, min(tokens_times_k, c))


def experts_compute(gate_w, up_w, down_w, buf):
    """Batched expert FFN through ``ops.expert_ffn`` (the CUDA kernel on
    the card, its plain version on the CPU).  buf: (E_local, C, D) ->
    (E_local, C, D)."""
    return ops.expert_ffn(buf, gate_w, up_w, down_w)


def dispatch_compute_combine(x_flat, weights, phys, alive, gate_w, up_w,
                             down_w, *, cap: int, expert_offset: int,
                             e_local: int):
    """Capacity-based dispatch -> expert FFN -> weighted combine over the
    local expert slots ``[expert_offset, expert_offset + e_local)``;
    copies routed elsewhere, dead or over capacity contribute 0."""
    T, D = x_flat.shape
    k = phys.shape[1]
    N = T * k
    e_id = phys.reshape(N).long() - expert_offset
    ok = (e_id >= 0) & (e_id < e_local) & alive.reshape(N)
    tok = torch.arange(N, device=x_flat.device) // k
    order, group, slot = group_by_expert(e_id, ok, e_local, cap)
    keep = group < e_local
    # every shape static (no boolean-mask indexing, so nothing waits for
    # the device): each slot gathers its token row by index (an empty
    # slot a zero row) and each copy its slot's output; a copy that is not
    # kept moves only an index, into a spare entry past the slots
    n_slots = e_local * cap
    dest = torch.where(keep, group * cap + slot, n_slots)
    row = torch.full((n_slots + 1,), T, dtype=torch.long,
                     device=x_flat.device)
    row = row.scatter_(0, dest, tok[order])[:n_slots]
    zero = x_flat.new_zeros(())
    buf = torch.where((row < T)[:, None], x_flat[row.clamp_max(T - 1)],
                      zero)
    out_buf = experts_compute(gate_w, up_w, down_w,
                              buf.view(e_local, cap, D))
    slot_of = torch.empty_like(dest).scatter_(0, order, dest)
    y_flat = torch.where((slot_of < n_slots)[:, None],
                         out_buf.reshape(n_slots, D)[slot_of.clamp_max(
                             n_slots - 1)], zero)
    return (y_flat.reshape(T, k, D)
            * weights[..., None].to(x_flat.dtype)).sum(dim=1)


def dispatch_compute_combine_fused(x_flat, weights, phys, alive, gate_w,
                                   up_w, down_w, *, cap: int,
                                   expert_offset: int, e_local: int):
    """Fused twin of :func:`dispatch_compute_combine`: one sort pass, then
    gather -> grouped SwiGLU -> weighted combine in the fused kernel
    (its plain version for CPU tensors), with no (E_local, cap, D)
    capacity buffer and no (N, D) unsort."""
    return ops.moe_dispatch_ffn_combine(
        x_flat, gate_w, up_w, down_w, weights, phys, alive, expert_offset,
        cap=cap, e_local=e_local)


def dispatch_fn(cfg: ModelConfig):
    return (dispatch_compute_combine_fused if cfg.moe_fused
            else dispatch_compute_combine)


def moe_apply_local(p, cfg: ModelConfig, x_flat, runtime: MoERuntime, *,
                    cap: int, expert_offset: int = 0,
                    e_local: Optional[int] = None, with_aux: bool = False):
    """Single-rank MoE application over local expert slots (router and
    routed experts; the shared experts are applied by the caller).
    Returns y (T, D), and with ``with_aux`` ``(y, aux)``: the routing's
    load-balance loss (:func:`route`)."""
    moe = cfg.moe
    e_local = e_local if e_local is not None else physical_experts(moe)
    if with_aux:
        weights, sel, aux = route(p["router"], x_flat, runtime, moe,
                                  with_aux=True)
    else:
        weights, sel = route(p["router"], x_flat, runtime, moe)
    phys, alive = select_replicas(sel, runtime)
    y = dispatch_fn(cfg)(
        x_flat, weights, phys, alive, p["gate"], p["up"], p["down"],
        cap=cap, expert_offset=expert_offset, e_local=e_local)
    return (y, aux) if with_aux else y


def shared_expert_apply(p, cfg: ModelConfig, x, tp=None):
    """The shared experts' SwiGLU over x; ``tp``: their width split over
    'model' (``ffn.ffn_apply``)."""
    if cfg.moe and cfg.moe.num_shared_experts and "shared" in p:
        from repro_torch.models.ffn import ffn_apply
        return ffn_apply(p["shared"], x, "swiglu", tp)
    return 0.0
