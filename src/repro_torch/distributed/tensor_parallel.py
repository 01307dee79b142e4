"""Tensor parallelism outside the experts: the serve and train steps
computed on ``ShardingRules``' shards.

The counterpart of what XLA's partitioner (GSPMD) does to ``repro``'s
placed step (``repro.launch.dryrun`` hands it every leaf placed by
``repro.distributed.sharding.ShardingRules``): where ``repro`` lets the
compiler insert the collectives, the port's model calls them here, each
one explicit and from ``distributed.collectives`` (so the dry run's tally
sees them).  A rank holds ``sharding.tp_shard`` of each leaf and:

* column-parallel products (``wq``, ``wk``/``wv`` where KV heads divide
  'model', ``w_gate``/``w_up``, Mamba's ``in_proj``, MLA's ``wdq`` and
  ``wuq``) give its columns; the row-parallel products that follow
  (``wo``, ``w_down``, ``out_proj``, ``x_proj``) give a partial sum,
  all-reduced over 'model' (:meth:`TensorParallel.all_reduce`);
* the vocabulary is split over 'model': :meth:`TensorParallel.embed`
  looks up the rank's rows and all-reduces, the logits stay the rank's
  columns, :meth:`TensorParallel.greedy` picks the token of the whole
  padded row (the lowest index on a tie, as ``argmax``) and
  ``layers.vocab_parallel_cross_entropy`` the loss of the whole row;
* attention is head-parallel where heads divide 'model'; a decode cache
  whose KV heads do not divide is split over its window instead
  (``ShardingRules.cache_specs``): each rank attends every head's query
  over its slots and :func:`merge_partials` folds the ranks' partials by
  their log-sum-exp (``ops.paged_attention(..., lse_out=...)``);
* under FSDP (``rules.fsdp``, dense models whose non-expert weights
  exceed 12 GB a 'model' rank) a leaf is split over ('data', 'model'):
  :meth:`TensorParallel.stream_layer` regathers one layer's leaves to the TP
  layout inside the layer loop (inside the layer's checkpoint when
  ``cfg.remat`` is set, so the backward regathers them again), and
  nothing holds them after the layer.

The MoE layer is the distributed one (``collectives.MoEDist``): its
input, after the row-parallel all-reduce, is whole on every 'model' rank,
as it expects.

A train step (``training.train_loop.make_train_step`` of a TP model)
differentiates through the collectives' transposes (``collectives``'
convention: each rank differentiates ``loss / world``, its loss the
global one), sums each leaf's gradient over the ranks that hold the same
block (:meth:`TensorParallel.reduce_grads`: over the DP axes and over
'model' where the leaf is replicated there), and updates the rank's
blocks with AdamW, whose global norm counts each distinct block once
(:meth:`TensorParallel.block_squares`, the ranks' partial squares folded
in rank order).
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.distributed import collectives as C
from repro_torch.distributed.sharding import (ShardingRules, batch_rows,
                                              local_shard)
from repro_torch.launch.mesh import axis_sizes


def _axes(entry):
    return () if entry is None else (
        (entry,) if isinstance(entry, str) else tuple(entry))


def merge_partials(o, lse, group):
    """Attention partials of one set of rows over disjoint key ranges, one
    a rank of ``group`` -> the attention over all of them.  ``o`` (..., D)
    f32 is each rank's output normalised over its own keys and ``lse``
    (...) the log-sum-exp of its scaled scores there (-inf where it had
    none).  The ranks' partials are gathered and folded in f32: o = sum_r
    o_r e^(lse_r - M) / sum_r e^(lse_r - M), M the largest finite lse; a
    rank with lse = -inf weighs 0, and a row with no key anywhere gives
    0."""
    return fold_partials(_gather0(o.float(), group),
                         _gather0(lse.float(), group))


def fold_partials(os_, ls):
    """:func:`merge_partials`' fold of partials already side by side: ``os_``
    (n, ..., D) and ``ls`` (n, ...) f32, reduced over n (the same order on
    every rank)."""
    M = ls.amax(dim=0)
    M = torch.where(torch.isfinite(M), M, torch.zeros_like(M))
    w = torch.exp(ls - M)               # e^-inf = 0: an empty rank weighs 0
    L = w.sum(dim=0)[..., None]
    acc = (w[..., None] * os_).sum(dim=0)
    return torch.where(L > 0, acc / L, torch.zeros_like(acc))


def _gather0(x, group):
    """(...) from each rank of ``group`` -> (size, ...), in rank order."""
    return C.all_gather(x[None], group)


def gather_dim(x, dim: int, group):
    """``x`` all-gathered along ``dim`` over ``group`` (rank order)."""
    if dist.get_world_size(group) == 1:
        return x
    y = C.all_gather(x.movedim(dim, 0), group)
    return y.movedim(0, dim)


class TensorParallel:
    """The 'model' axis of ``mesh`` as the serve and train steps use it,
    from the placement ``rules`` (a ``ShardingRules`` of the mesh and the
    model's config).  :meth:`bind` takes the model's parameter shapes, for
    :meth:`stream_layer` and the train step's gradient sums."""

    def __init__(self, mesh, rules: ShardingRules, axis: str = "model"):
        self.mesh, self.rules, self.axis = mesh, rules, axis
        self.sizes = axis_sizes(mesh)
        self.size = self.sizes[axis]
        self.rank = mesh.get_local_rank(axis)
        self.data_size = self.sizes.get("data", 1)
        self.world = math.prod(self.sizes.values())
        self.attn_tp, self.kv_tp = rules.attn_tp, rules.kv_tp
        self.fsdp = rules.fsdp
        self._groups: Optional[Dict] = None
        self.placed = self.layout = None
        # the axes the batch rows are split over (:meth:`place`)
        self.batch_axes = tuple(rules.dp)

    # -- groups and collectives ------------------------------------------------

    def group(self, axis: Optional[str] = None):
        if self._groups is None:
            self._groups = {a: self.mesh.get_group(a)
                            for a in self.mesh.mesh_dim_names}
        return self._groups[axis or self.axis]

    def all_reduce(self, x):
        """A row-parallel product's partials summed over 'model'."""
        return C.all_reduce(x, self.group())

    def gather(self, x, dim: int = -1):
        """Each rank's block along ``dim`` -> the whole, in rank order."""
        return gather_dim(x, dim % x.dim(), self.group())

    def all_reduce_max(self, x):
        """The elementwise largest ``x`` over 'model' (no gradient)."""
        return C.all_reduce_max(x, self.group())

    def merge(self, o, lse):
        """:func:`merge_partials` over 'model'."""
        return merge_partials(o, lse, self.group())

    # -- the batch -------------------------------------------------------------

    def place(self, batch_size: int) -> slice:
        """This rank's rows of a global batch of ``batch_size`` rows, as
        ``ShardingRules.batch_spec`` places them (every DP axis where they
        divide it, else 'data', else none: the rows replicated);
        :meth:`sum_batch` sums over those axes until the next call."""
        self.batch_axes, rows = batch_rows(self.mesh, batch_size)
        return rows

    def sum_batch(self, x):
        """``x``, a sum over the rank's rows, summed over the ranks that
        hold the other rows (the axes :meth:`place` split them over)."""
        for a in self.batch_axes:
            if self.sizes[a] > 1:
                x = C.all_reduce(x, self.group(a))
        return x

    # -- the train step's sums over blocks ------------------------------------------

    def _split_axes(self, spec) -> tuple:
        """The mesh axes (in mesh order) that a leaf placed by ``spec`` is
        split over; its other axes hold replicas of its blocks."""
        used = {a for entry in spec for a in _axes(entry)}
        return tuple(a for a in self.mesh.mesh_dim_names if a in used)

    def _by_leaf(self, tree):
        """(path, leaf, placement) of each leaf of a tree shaped as the
        parameters, in key order."""
        if self.placed is None:
            raise RuntimeError("TensorParallel: bind() the model's "
                               "parameter shapes first")
        return list(_walk(tree, self.placed))

    def reduce_grads(self, grads):
        """Each leaf's gradient summed over the ranks that hold the same
        block: over every mesh axis its placement does not split (the DP
        axes, and 'model' where the leaf is replicated there; an expert
        block over 'pod' only), so every holder of a block ends with the
        gradient of the global loss (``collectives``' convention)."""
        out = {}
        for path, g, spec in self._by_leaf(grads):
            split = self._split_axes(spec)
            for a in self.mesh.mesh_dim_names:
                if a not in split and self.sizes[a] > 1:
                    g = C.all_reduce(g, self.group(a))
            _put(out, path, g)
        return out

    def block_squares(self, squares):
        """``squares``: per leaf (a tree shaped as the parameters) the
        rank's block's sum of squares, 0-d f32 -> the whole leaf's: the
        blocks' partials gathered over the axes the leaf is split over
        and folded in rank order (the first axis major), each distinct
        block counted once; a replicated leaf's as it is.  Leaves split
        over the same axes share one gather."""
        items = self._by_leaf(squares)
        out, by_axes = {}, {}
        for path, sq, spec in items:
            axes = tuple(a for a in self._split_axes(spec)
                         if self.sizes[a] > 1)
            by_axes.setdefault(axes, []).append((path, sq))
        for axes, group in by_axes.items():
            if not axes:
                for path, sq in group:
                    _put(out, path, sq)
                continue
            vec = torch.stack([sq for _, sq in group])
            for a in reversed(axes):
                vec = C.all_gather(vec[None], self.group(a))
            vec = vec.reshape(-1, len(group))
            total = vec[0]
            for r in range(1, vec.shape[0]):
                total = total + vec[r]
            for i, (path, _) in enumerate(group):
                _put(out, path, total[i])
        return out

    def block(self, n: int) -> slice:
        """This rank's block of a dimension of ``n`` split over 'model'."""
        step = n // self.size
        return slice(self.rank * step, (self.rank + 1) * step)

    # -- the vocabulary --------------------------------------------------------

    def embed(self, table, tokens):
        """Vocab-parallel lookup: ``table`` is the rank's rows (V/m, D) of
        the embedding; tokens outside them give 0 here, and the sum over
        'model' gives every token its row."""
        n = table.shape[0]
        idx = tokens.long() - self.rank * n
        ok = (idx >= 0) & (idx < n)
        rows = table[idx.clamp(0, n - 1)]
        rows = torch.where(ok[..., None], rows, rows.new_zeros(()))
        return self.all_reduce(rows)

    def greedy(self, logits):
        """The greedy token of each row whose logits (..., V/m) are the
        rank's columns of the padded vocabulary: ``argmax`` over the whole
        row, the lowest index on a tie, as int32."""
        n = logits.shape[-1]
        idx = logits.argmax(dim=-1, keepdim=True)
        val = logits.gather(-1, idx)[..., 0].float()
        idx = idx[..., 0].to(torch.int64) + self.rank * n
        vals, idxs = _gather0(val, self.group()), _gather0(idx, self.group())
        # argmax keeps the first of equal values: the lowest rank's column
        pick = idxs.gather(0, vals.argmax(dim=0, keepdim=True))[0]
        return pick.to(torch.int32)

    # -- attention heads and windows --------------------------------------------

    def q_heads(self, H: int) -> slice:
        """The query heads this rank computes in a prefill."""
        return self.block(H) if self.attn_tp else slice(0, H)

    def window_split(self, W: int) -> bool:
        """Whether a decode cache of W slots a row (a GQA ring whose KV
        heads do not divide, MLA's latent ring, the audio's cross K/V
        over F frames) is split over 'model' by slot, as
        ``ShardingRules.cache_specs`` places it."""
        return W % self.size == 0

    # -- FSDP: one layer's leaves at a time ---------------------------------------

    def bind(self, param_specs):
        """Take the model's parameter tree (meta tensors of the whole
        shapes): each leaf's placement (``rules``) and its layout in the
        TP runtime (the same rules without FSDP)."""
        self.placed = self.rules.params_specs(param_specs)
        fsdp, self.rules.fsdp = self.rules.fsdp, False
        try:
            self.layout = self.rules.params_specs(param_specs)
        finally:
            self.rules.fsdp = fsdp
        return self

    def stream_layer(self, tree, path, layer: Optional[int] = None):
        """``tree``, the rank's leaves at ``path`` (keys) of the parameter
        tree (one ``layer`` of a stacked group, already taken), regathered
        from their placement to the TP layout where FSDP split them over
        'data' as well: the caller holds the result for one layer only.
        Without FSDP the leaves as they are."""
        if not self.fsdp:
            return tree
        if self.placed is None:
            raise RuntimeError("TensorParallel.stream_layer: bind() the model's "
                               "parameter shapes first")
        placed, layout = self.placed, self.layout
        for key in path:
            placed, layout = placed[key], layout[key]
        if layer is not None:
            placed, layout = _drop_lead(placed), _drop_lead(layout)
        return _map_specs(self._reshard_leaf, tree, placed, layout)

    def _reshard_leaf(self, name, x, src, dst):
        """:meth:`reshard`, each half of Mamba's ``in_proj`` (``tp_shard``
        stores the x and z columns of the rank's channels) on its own."""
        if name == "in_proj" and _axes(src[-1]) != _axes(dst[-1]):
            half = x.shape[-1] // 2
            return torch.cat([self.reshard(x[..., :half], src, dst),
                              self.reshard(x[..., half:], src, dst)], -1)
        return self.reshard(x, src, dst)

    def reshard(self, x, src, dst):
        """``x`` placed by ``src`` -> placed by ``dst``: along each
        dimension where they differ, the whole gathered over the source's
        axes (the first major), then ``dst``'s block cut.  From
        ('data', 'model') to 'model' on a square mesh the 'model' gather
        of the rank's data row gives model block d, and a broadcast over
        'data' from data rank r hands every rank of column r its block r:
        one TP block moved twice, not the whole leaf (under grad the
        broadcast's gradients are summed back to its source)."""
        src = tuple(src) + (None,) * (x.dim() - len(src))
        dst = tuple(dst) + (None,) * (x.dim() - len(dst))
        for dim, (s, d) in enumerate(zip(src, dst)):
            if _axes(s) == _axes(d):
                continue
            if (_axes(s) == ("data", "model") and _axes(d) == ("model",)
                    and self.data_size == self.size):
                y = gather_dim(x, dim, self.group("model"))
                x = C.broadcast(y, self.group("data"), self.rank)
                continue
            for a in reversed(_axes(s)):
                x = gather_dim(x, dim, self.group(a))
            if _axes(d):
                spec = [None] * x.dim()
                spec[dim] = d
                x = local_shard(x, tuple(spec), self.mesh)
        return x


def _drop_lead(spec_tree):
    """Specs of one layer of a stacked (L, ...) group: the layer axis off."""
    if isinstance(spec_tree, dict):
        return {k: _drop_lead(v) for k, v in spec_tree.items()}
    return tuple(spec_tree)[1:] if len(spec_tree) else ()


def _walk(tree, specs, path=()):
    """(path, leaf, spec) of each leaf of ``tree``, keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], specs[k], path + (k,))
    else:
        yield path, tree, tuple(specs)


def _put(tree, path, value):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _map_specs(fn, tree, src, dst, name=None):
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v, src[k], dst[k], k)
                for k, v in tree.items()}
    return fn(name, tree, src, dst)
