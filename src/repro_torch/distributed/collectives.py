"""The distributed MoE layer on ``torch.distributed``: the XCCL dispatch
and combine of ``repro.distributed.collectives``.

``MoEDist`` (``gather_psum``): experts sharded in 2D, expert *slots* over
'model' (EP) and each expert's FFN width over 'data' (expert-TP).  Each
rank's tokens are all-gathered over 'data' in chunks of at most
``MAX_GATHERED_TOKENS`` a pod (dispatch), routed, run through the rank's
slots, summed over 'model' (the slots' partials) and reduce-scattered
over 'data' (the FFN width's partials, back to the DP layout: combine).
'pod' stays pure DP: each pod is one EP group.

``MoEDistA2A`` (``a2a``): tokens split over (DP..., 'model') travel to
the rank that owns their expert in one all-to-all over 'model' and come
back in another.  The expert bank keeps the same 2D layout, so the rows
a rank receives are all-gathered over 'data' before the expert compute
and its FFN-width partials reduce-scattered back after it: every
FFN-width shard computes its partial for the same rows.  (The JAX
package sums the partials of ranks that received different rows, which
is wrong whenever 'data' > 1; at 'data' = 1 both gathers are identities
and the two agree.)

A rank holds its share of the batch, placed as
``sharding.ShardingRules.batch_spec`` places it (:meth:`MoEDist.place`),
where the JAX package's layer sees the global array; so each layer
reckons the global token count from its share and the mesh, takes the
same branch the JAX package takes (replicated tokens when they do not
split over DP, the number of chunks, the capacity), and moves its rows
into that layout and back: a rank cuts its part of a replicated share,
and gathers what it cut afterwards, as GSPMD reshards at the
``shard_map`` boundary.

Every collective of the layer runs through a ``torch.autograd.Function``
whose backward is the transposed collective (all-gather <->
reduce-scatter, all-reduce <-> all-reduce, all-to-all back the other
way, a broadcast's gradients summed to its source): backward of each
rank's loss gives the gradient of the sum of the ranks' losses, per rank
and leaf.  The convention that follows: each rank differentiates ``loss
/ world`` (its loss the global one, or its share of it), and a leaf's
gradient is the sum of the gradients of every rank that holds the same
block of it (``TensorParallel.reduce_grads`` takes that sum).  The fused
local compute has no backward and refuses inputs that require grad.  A mesh on CUDA runs its
collectives through NCCL, and nothing falls back to another backend or
to the single-rank path.
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import (batch_axes, batch_rows,
                                              local_shard)
from repro_torch.kernels import build
from repro_torch.kernels.moe_fused import group_by_expert
from repro_torch.launch.mesh import axis_sizes
from repro_torch.models.moe import (MoERuntime, capacity,
                                    dispatch_compute_combine_fused,
                                    dispatch_fn, experts_compute,
                                    physical_experts, route, select_replicas)

# max tokens materialized per all-gathered dispatch chunk (bounds the
# transient activation: 64k x 8192 x bf16 ~ 1 GiB)
MAX_GATHERED_TOKENS = 65536

_gather = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_scatter = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


# -- collectives --------------------------------------------------------------------

# the dry run's tally (``launch.dryrun``): None, or a callable taking (op,
# per-rank bytes, group, shape) at each collective this module issues, the
# bytes and the shape
# as the JAX package's HLO parse counts them (an all-gather's and a
# reduce-scatter's result, an all-reduce's, an all-to-all's and a
# broadcast's operand)
_recorder = None


@contextlib.contextmanager
def recording(fn):
    """Calls ``fn(op, nbytes, group, shape)`` at each collective in the
    block."""
    global _recorder
    prev, _recorder = _recorder, fn
    try:
        yield
    finally:
        _recorder = prev


def _note(op, t, group):
    if _recorder is not None:
        _recorder(op, t.numel() * t.element_size(), group, tuple(t.shape))


def _all_gather(x, group):
    """(n, ...) from every rank of ``group`` -> (size * n, ...), in the
    group's rank order."""
    x = x.contiguous()
    out = x.new_empty((dist.get_world_size(group) * x.shape[0],)
                      + tuple(x.shape[1:]))
    _note("all-gather", out, group)
    _gather(out, x, group=group)
    return out


def _reduce_scatter(x, group):
    """(size * n, ...) summed over ``group`` -> this rank's (n, ...)."""
    x = x.contiguous()
    size = dist.get_world_size(group)
    if x.shape[0] % size:
        raise ValueError(f"reduce_scatter: {x.shape[0]} rows over {size} "
                         f"ranks")
    out = x.new_empty((x.shape[0] // size,) + tuple(x.shape[1:]))
    _note("reduce-scatter", out, group)
    _scatter(out, x, op=dist.ReduceOp.SUM, group=group)
    return out


def _all_reduce(x, group):
    out = x.clone(memory_format=torch.contiguous_format)
    _note("all-reduce", out, group)
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def broadcast_(x, group, src: int):
    """``x`` of ``group``'s rank ``src`` written into ``x`` on every rank
    of the group (in place; no gradient: :func:`broadcast` has one)."""
    _note("broadcast", x, group)
    dist.broadcast(x, src=dist.get_global_rank(group, src), group=group)
    return x


def _reduce_to(x, group, dst: int):
    """The sum over ``group`` of ``x`` on its rank ``dst``; zeros on the
    others (a broadcast's transpose)."""
    out = x.clone(memory_format=torch.contiguous_format)
    _note("reduce", out, group)
    dist.reduce(out, dst=dist.get_global_rank(group, dst),
                op=dist.ReduceOp.SUM, group=group)
    if dist.get_rank(group) != dst:
        out.zero_()
    return out


def all_reduce_max(x, group):
    """The elementwise largest ``x`` over ``group`` (no gradient: a
    log-sum-exp's shift)."""
    out = x.detach().clone(memory_format=torch.contiguous_format)
    _note("all-reduce", out, group)
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


def _all_to_all(x, group):
    """(size, ...) blocks: block j goes to rank j; block i of the result
    came from rank i."""
    x = x.contiguous()
    out = torch.empty_like(x)
    _note("all-to-all", x, group)
    dist.all_to_all_single(out, x, group=group)
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_gather(x, group)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.group), None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _reduce_scatter(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.group), None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


class _Broadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, src):
        ctx.group, ctx.src = group, src
        return broadcast_(x.clone(memory_format=torch.contiguous_format),
                          group, src)

    @staticmethod
    def backward(ctx, g):
        return _reduce_to(g, ctx.group, ctx.src), None, None


def broadcast(x, group, src: int):
    """``x`` of ``group``'s rank ``src`` on every rank of the group, as a
    new tensor; under grad the ranks' gradients are summed to ``src``
    (the other ranks' ``x`` get zeros)."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _Broadcast.apply(x, group, src)
    return broadcast_(x.clone(memory_format=torch.contiguous_format),
                      group, src)


_FUNCTIONS = {_all_gather: _AllGather, _reduce_scatter: _ReduceScatter,
              _all_reduce: _AllReduce, _all_to_all: _AllToAll}


def _collective(fn, x, group):
    """``fn`` on ``x``, through its autograd Function where ``x`` needs a
    gradient (so no collective drops one)."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _FUNCTIONS[fn].apply(x, group)
    return fn(x, group)


def all_gather(x, group):
    return _collective(_all_gather, x, group)


def reduce_scatter(x, group):
    return _collective(_reduce_scatter, x, group)


def all_reduce(x, group):
    return _collective(_all_reduce, x, group)


def all_to_all(x, group):
    return _collective(_all_to_all, x, group)


def _inverse(order):
    """The inverse of the permutation ``order``."""
    inv = torch.empty_like(order)
    inv.scatter_(0, order, torch.arange(order.shape[0], device=order.device))
    return inv


def _rows_into(rows, n_slots, slot, valid):
    """(n_slots, D): row ``i`` of ``rows`` where ``slot[i]`` is valid, zeros
    elsewhere; invalid entries aim at a trash slot cut off at the end (a
    gather, with no boolean-mask indexing)."""
    flat = torch.where(valid, slot, n_slots)
    src = torch.zeros(n_slots + 1, dtype=torch.long, device=rows.device)
    src.scatter_(0, flat, torch.arange(rows.shape[0], device=rows.device))
    full = torch.zeros(n_slots + 1, dtype=torch.bool, device=rows.device)
    full.scatter_(0, flat, valid)
    full, src = full[:n_slots], src[:n_slots]
    return torch.where(full[:, None], rows[src], rows.new_zeros(()))


def _rows_from(slots, slot, valid):
    """(len(slot), D): ``slots[slot[i]]`` where valid, else zeros."""
    padded = torch.cat([slots, slots.new_zeros((1,) + slots.shape[1:])])
    return padded[torch.where(valid, slot, slots.shape[0])]


# -- the layers ----------------------------------------------------------------------

class MoEDist:
    """gather_psum with 2D expert sharding (slots x FFN width)."""

    name = "gather_psum"

    def __init__(self, mesh, dp_axes: Tuple[str, ...] = ("data",),
                 ep_axis: str = "model", tp_axis: str = "data",
                 backend: Optional[str] = None):
        self.mesh = mesh
        # the groups' backend the layer requires (None: NCCL for CUDA
        # tensors, gloo for CPU ones)
        self.backend = backend
        sizes = axis_sizes(mesh)
        self.sizes = sizes
        self.dp_axes = tuple(dp_axes)
        self.ep_axis = ep_axis
        self.tp_axis = tp_axis
        self.dp_size = math.prod(sizes[a] for a in self.dp_axes)
        self.ep_size = sizes[ep_axis]
        self.tp_size = sizes[tp_axis]
        self.pod_size = sizes.get("pod", 1)
        # how the caller's batch rows are split (:meth:`place`)
        self.batch_axes = batch_axes(mesh, self.dp_size)
        self._groups = None

    # -- the batch share and the global count ---------------------------------

    def place(self, batch_size: int) -> slice:
        """This rank's rows of a global batch of ``batch_size`` rows, as
        ``ShardingRules.batch_spec`` places them; the layer reckons the
        global token count from them until the next call."""
        self.batch_axes, rows = batch_rows(self.mesh, batch_size)
        return rows

    def global_tokens(self, local_tokens: int) -> int:
        """The global token count of a share of ``local_tokens``."""
        return local_tokens * math.prod(self.sizes[a]
                                        for a in self.batch_axes)

    # tokens processed together in one EP group (= one pod)
    def group_tokens(self, global_tokens: int) -> int:
        return max(1, global_tokens // self.pod_size)

    def cap_for(self, global_tokens: int, moe) -> int:
        """Per-expert capacity for one dispatch chunk."""
        T_group = self.group_tokens(global_tokens)
        n_chunks = max(1, -(-T_group // MAX_GATHERED_TOKENS))
        chunk = max(1, T_group // n_chunks)
        return capacity(chunk * moe.top_k, physical_experts(moe),
                        moe.capacity_factor, floor=moe.min_capacity)

    # -- the expert bank ------------------------------------------------------------

    def expert_specs(self):
        """Specs of the stacked expert leaves (L, E, D, F) / (L, E, F, D)."""
        return {"gate": (None, self.ep_axis, None, self.tp_axis),
                "up": (None, self.ep_axis, None, self.tp_axis),
                "down": (None, self.ep_axis, self.tp_axis, None)}

    def shard_params(self, params):
        """``params`` with every MoE layer's expert bank cut to this rank's
        block (``expert_specs``); every other leaf as it is."""
        specs = self.expert_specs()

        def walk(tree, in_moe):
            out = {}
            for key, v in tree.items():
                if isinstance(v, dict):
                    out[key] = walk(v, in_moe or key == "moe")
                elif in_moe and key in specs:
                    out[key] = local_shard(v, specs[key][-v.dim():],
                                           self.mesh)
                else:
                    out[key] = v
            return out
        return walk(params, False)

    # -- ranks, groups and layouts -------------------------------------------------

    def _split(self, axes):
        """(number of parts, this rank's part) of a split over ``axes``,
        the first major."""
        n, index = 1, 0
        for a in axes:
            n *= self.sizes[a]
            index = index * self.sizes[a] + self.mesh.get_local_rank(a)
        return n, index

    def _check(self, x, cfg: ModelConfig, p):
        """The mesh's groups, on x's device type (NCCL for CUDA tensors);
        the fused local compute refuses inputs that require grad."""
        if not hasattr(self.mesh, "get_group"):
            raise TypeError("this mesh is a layout without ranks "
                            "(make_production_mesh); build one with "
                            "launch.mesh.make_mesh")
        if self.mesh.device_type != x.device.type:
            raise ValueError(f"{self.name}: tensors on {x.device}, a mesh "
                             f"on {self.mesh.device_type}")
        if self._groups is None:
            groups = {a: self.mesh.get_group(a)
                      for a in self.mesh.mesh_dim_names}
            want = self.backend or ("nccl" if x.device.type == "cuda"
                                    else "gloo")
            for a, g in groups.items():
                if dist.get_backend(g) != want:
                    raise RuntimeError(f"{self.name}: the {a!r} group runs "
                                       f"{dist.get_backend(g)}, {x.device} "
                                       f"tensors need {want}")
            self._groups = groups
        if cfg.moe_fused:
            build.refuse_grad(f"{self.name} ({cfg.moe_impl})", x, p["router"],
                              p["gate"], p["up"], p["down"],
                              hint="the fused MoE kernel has no backward")

    def _gather_over(self, x, axes):
        """Rows split over ``axes`` (the first major) -> every row."""
        for a in reversed(axes):
            x = all_gather(x, self._groups[a])
        return x

    def _cut(self, x, axes):
        n, index = self._split(axes)
        if x.shape[0] % n:
            raise ValueError(f"{self.name}: {x.shape[0]} rows do not split "
                             f"over {axes} ({n})")
        rows = x.shape[0] // n
        return x[index * rows:(index + 1) * rows]

    def _enter(self, x, axes):
        """This rank's rows (split over ``batch_axes``) -> its rows split
        over ``axes``; returns them and the function that takes the
        layer's output rows back to the incoming layout."""
        src = tuple(self.batch_axes)
        axes = tuple(axes)
        if src == axes:
            return x, lambda y: y
        if axes[:len(src)] == src:
            extra = axes[len(src):]
            return (self._cut(x, extra),
                    lambda y: self._gather_over(y, extra))
        return (self._cut(self._gather_over(x, src), axes),
                lambda y: self._cut(self._gather_over(y, axes), src))

    def _mean_aux(self, aux, axes, n):
        """The aux loss summed over ``axes``, over ``n``."""
        aux = aux.reshape(1)
        for a in axes:
            aux = all_reduce(aux, self._groups[a])
        return aux[0] / n

    # -- apply ----------------------------------------------------------------------

    def apply(self, p, cfg: ModelConfig, x_flat, runtime: MoERuntime,
              cap: int, *, with_aux: bool = False):
        """Routed experts over this rank's tokens x_flat (T, D) and its
        block of the bank.  Returns y (T, D), and with ``with_aux`` ``(y,
        aux)``: the load-balance loss averaged over the ranks and
        chunks, as the JAX package's."""
        moe = cfg.moe
        e_phys = physical_experts(moe)
        if e_phys % self.ep_size:
            raise ValueError(f"{e_phys} expert slots over {self.ep_size} "
                             f"EP ranks")
        e_local = e_phys // self.ep_size
        self._check(x_flat, cfg, p)
        T_global = self.global_tokens(x_flat.shape[0])
        # tiny batches (a B = 1 decode) cannot split over DP: tokens stay
        # replicated and the gather/scatter legs become all-reduces
        replicated = T_global % self.dp_size != 0
        T_group = self.group_tokens(T_global)
        n_chunks = (1 if replicated
                    else max(1, -(-T_group // MAX_GATHERED_TOKENS)))
        x, leave = self._enter(x_flat, () if replicated else self.dp_axes)
        T_loc = x.shape[0]
        if T_loc % n_chunks:
            raise ValueError(f"{self.name}: {T_loc} tokens in {n_chunks} "
                             f"chunks")
        tp, ep = self._groups[self.tp_axis], self._groups[self.ep_axis]
        offset = self.mesh.get_local_rank(self.ep_axis) * e_local
        compute = dispatch_fn(cfg)
        ys, aux = [], 0.0
        # one chunk is x itself, and over a 'data' group of one rank the
        # gather is x: no split or gather node, so that x's gradients add
        # up in the order the single-rank layer's do
        for xc in (x.split(T_loc // n_chunks) if n_chunks > 1 else (x,)):
            # dispatch: this chunk's tokens to every rank of the EP group
            xg = (xc if replicated or self.tp_size == 1
                  else all_gather(xc, tp))
            if with_aux:
                weights, sel, a = route(p["router"], xg, runtime, moe,
                                        with_aux=True)
                aux = aux + a
            else:
                weights, sel = route(p["router"], xg, runtime, moe)
            phys, alive = select_replicas(sel, runtime)
            y = compute(xg, weights, phys, alive, p["gate"], p["up"],
                        p["down"], cap=cap, expert_offset=offset,
                        e_local=e_local)
            # combine: the slots' partials over EP, the FFN width's over
            # expert-TP (and back to the DP layout)
            y = all_reduce(y, ep)
            y = all_reduce(y, tp) if replicated else reduce_scatter(y, tp)
            ys.append(y)
        y = leave(ys[0] if n_chunks == 1 else torch.cat(ys))
        if not with_aux:
            return y
        axes = self.dp_axes + (self.ep_axis,)
        n = math.prod(self.sizes[a] for a in axes) * n_chunks
        return y, self._mean_aux(aux, axes, n)


class MoEDistA2A(MoEDist):
    """Explicit all-to-all dispatch and combine (A2E / E2A).

    Tokens enter split over (DP..., EP); each rank sends its tokens' k
    copies to their experts' EP ranks and receives the outputs back.  The
    bank keeps the 2D layout, so the received rows are gathered over
    'data' for the expert compute and the FFN width's partials
    reduce-scattered back: only the routed copies travel over 'model'.
    """

    name = "a2a"

    def cap_for(self, global_tokens: int, moe) -> int:
        """Per-(source, destination) send capacity: T_loc k / ep, padded."""
        T_loc = max(1, global_tokens // (self.dp_size * self.ep_size))
        return capacity(T_loc * moe.top_k, self.ep_size,
                        moe.capacity_factor, floor=moe.min_capacity)

    def apply(self, p, cfg: ModelConfig, x_flat, runtime: MoERuntime,
              cap: int, *, with_aux: bool = False):
        moe = cfg.moe
        e_phys = physical_experts(moe)
        ep_n = self.ep_size
        if e_phys % ep_n:
            raise ValueError(f"{e_phys} expert slots over {ep_n} EP ranks")
        e_local = e_phys // ep_n
        self._check(x_flat, cfg, p)
        token_axes = self.dp_axes + (self.ep_axis,)
        n_parts = math.prod(self.sizes[a] for a in token_axes)
        T_global = self.global_tokens(x_flat.shape[0])
        if T_global % n_parts:
            raise ValueError(f"a2a: {T_global} tokens do not split over "
                             f"{token_axes} ({n_parts} ranks)")
        x, leave = self._enter(x_flat, token_axes)
        tp, ep = self._groups[self.tp_axis], self._groups[self.ep_axis]
        T, D = x.shape
        k = moe.top_k
        dev = x.device
        my_rank = self.mesh.get_local_rank(self.ep_axis)
        if with_aux:
            weights, sel, aux = route(p["router"], x, runtime, moe,
                                      with_aux=True)
        else:
            weights, sel = route(p["router"], x, runtime, moe)
        phys, alive = select_replicas(sel, runtime)          # (T, k)
        dest = phys // e_local                               # owner rank
        N = T * k
        order, s_dest, s_pos = group_by_expert(
            dest.reshape(N), alive.reshape(N), ep_n, cap)
        kept = s_dest < ep_n
        s_slot = s_dest * cap + s_pos
        tok = torch.arange(N, device=dev) // k
        send = _rows_into(x[tok[order]], ep_n * cap, s_slot, kept)
        send_e = torch.full((ep_n * cap + 1,), e_phys, dtype=torch.int32,
                            device=dev)
        send_e.scatter_(0, torch.where(kept, s_slot, ep_n * cap),
                        phys.reshape(N)[order].to(torch.int32))

        # A2E: token copies travel to their expert's owner rank, then to
        # every FFN-width shard of it
        recv = all_to_all(send.view(ep_n, cap, D), ep)
        recv_e = all_to_all(send_e[:ep_n * cap].view(ep_n, cap), ep)
        rt_tokens = all_gather(recv.reshape(ep_n * cap, D), tp)
        rt_e = (all_gather(recv_e.reshape(ep_n * cap), tp).long()
                - my_rank * e_local)
        rt_ok = (rt_e >= 0) & (rt_e < e_local)
        R = rt_tokens.shape[0]
        cap2 = min(R, max(8, int(moe.capacity_factor * R
                                 / max(e_local, 1))))
        if cfg.moe_fused:
            # the fused kernel groups the rows again in its sort pass;
            # received rows act as top-1 routed tokens of weight 1
            y_recv = dispatch_compute_combine_fused(
                rt_tokens, torch.ones((R, 1), dtype=torch.float32,
                                      device=dev),
                rt_e[:, None], rt_ok[:, None], p["gate"], p["up"], p["down"],
                cap=cap2, expert_offset=0, e_local=e_local)
        else:
            order2, d_e, d_p = group_by_expert(rt_e, rt_ok, e_local, cap2)
            kept2 = d_e < e_local
            d_slot = d_e * cap2 + d_p
            buf = _rows_into(rt_tokens[order2], e_local * cap2, d_slot,
                             kept2).view(e_local, cap2, D)
            out_buf = experts_compute(p["gate"], p["up"], p["down"], buf)
            y_sorted = _rows_from(out_buf.reshape(e_local * cap2, D),
                                  d_slot, kept2)
            y_recv = y_sorted[_inverse(order2)]
        # the FFN width's partials over expert-TP, each rank its own rows
        y_recv = reduce_scatter(y_recv, tp).to(x.dtype)

        # E2A: expert outputs travel home
        back = all_to_all(y_recv.view(ep_n, cap, D), ep)
        y_sorted = _rows_from(back.reshape(ep_n * cap, D), s_slot, kept)
        y_flat = y_sorted[_inverse(order)]
        y = (y_flat.view(T, k, D)
             * weights[..., None].to(x.dtype)).sum(dim=1)
        y = leave(y)
        if not with_aux:
            return y
        return y, self._mean_aux(aux, token_axes, n_parts)


def make_moe_dist(mesh, impl: str, dp_axes=("data",), ep_axis="model",
                  backend=None):
    """impl may be any ``ModelConfig.MOE_IMPLS`` value; the '_fused'
    suffix only changes the local compute (``cfg.moe_fused`` at apply
    time), so both names of a base map onto the same class.  ``backend``:
    the process groups' backend the layer requires (None: by the
    tensors' device)."""
    base = "a2a" if impl.startswith("a2a") else "gather_psum"
    cls = {"gather_psum": MoEDist, "a2a": MoEDistA2A}[base]
    return cls(mesh, dp_axes, ep_axis, backend=backend)
