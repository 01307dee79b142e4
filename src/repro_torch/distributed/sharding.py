"""Sharding rules: each leaf's placement on a mesh, per architecture.

The twin of ``repro.distributed.sharding.ShardingRules``, its table of
placements kept as plain data: a spec is a tuple with one entry per
dimension, each ``None`` (whole), an axis name, or a tuple of two or
more axis names (split over their product, the first one major), as
``PartitionSpec`` normalises its entries; the empty tuple
replicates the leaf (``PartitionSpec()``).  Paths are tuples of the
parameter tree's keys.

Baseline policy, as in the JAX package:
* batch over the DP axes (("pod",) + "data" when multi-pod),
* routed experts over 'model' (EP), each expert's FFN width over 'data'
  (expert-TP),
* dense FFN / mamba channels over 'model' (Megatron TP),
* attention replicated over 'model' for MoE families, head-sharded where
  head counts divide; FSDP-style 2D for dense models too large for
  16-way TP,
* vocab (embed / lm_head) over 'model',
* decode caches: batch over DP when divisible, plus a 'model' shard on
  the widest dimension.

Every rule replicates a dimension that does not divide its axis.
:func:`local_shard` cuts a rank's block of a leaf; the distributed MoE
path (``collectives.MoEDist``) cuts the expert bank and the batch with
it and keeps every other leaf whole on every rank.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import axis_sizes

Spec = Tuple


def batch_axes(mesh, batch_size: int) -> Tuple[str, ...]:
    """The axes a global batch of ``batch_size`` rows is split over
    (row-major, the first axis major): every DP axis when they divide
    it, else ``("data",)`` when that divides it, else none (replicated)."""
    sizes = axis_sizes(mesh)
    dp = tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))
    dp_size = 1
    for a in dp:
        dp_size *= sizes[a]
    if batch_size % dp_size == 0:
        return dp
    if "data" in dp and batch_size % sizes["data"] == 0:
        return ("data",)
    return ()


class ShardingRules:
    def __init__(self, mesh, cfg: ModelConfig):
        self.mesh = mesh
        self.cfg = cfg
        sizes = axis_sizes(mesh)
        self.model_size = sizes["model"]
        self.dp = tuple(a for a in mesh.mesh_dim_names
                        if a in ("pod", "data"))
        self.dp_size = 1
        for a in self.dp:
            self.dp_size *= sizes[a]
        # attention TP only where heads divide the model axis
        self.attn_tp = (cfg.num_heads > 0 and
                        cfg.num_heads % self.model_size == 0)
        self.kv_tp = (cfg.num_kv_heads > 0 and
                      cfg.num_kv_heads % self.model_size == 0)
        self.data_size = sizes.get("data", 1)
        # FSDP-style 2D weight sharding for dense models too large for
        # 16-way TP alone (nemotron-4-340b: 680 GB bf16 -> 42 GB a rank at
        # TP16)
        dense_bytes = self._non_expert_param_bytes()
        self.fsdp = dense_bytes / self.model_size > 12e9

    def _non_expert_param_bytes(self) -> float:
        cfg = self.cfg
        D = cfg.d_model
        per_layer = 0.0
        if cfg.num_heads:
            Dh = cfg.resolved_head_dim()
            per_layer += D * (cfg.num_heads + 2 * cfg.num_kv_heads) * Dh \
                + cfg.num_heads * Dh * D
        if cfg.moe is None and cfg.d_ff:
            per_layer += 3 * D * cfg.d_ff
        if cfg.mamba is not None:
            di = cfg.mamba.expand * D
            per_layer += 2 * D * di * 2
        n = cfg.num_layers + cfg.encoder_layers
        return (per_layer * n + 2 * cfg.vocab_size * D) * 2.0  # bf16

    # -- params ----------------------------------------------------------------

    def _div(self, dim: int) -> bool:
        return dim % self.model_size == 0

    def param_spec(self, path: Tuple[str, ...], leaf) -> Spec:
        """The placement of the parameter at ``path`` (its keys), of
        ``leaf.shape``."""
        keys = tuple(path)
        name = keys[-1]
        shape = tuple(leaf.shape)
        nd = len(shape)

        wide = ("data", "model")
        wide_size = self.data_size * self.model_size

        def col():  # shard the last dim
            if self.fsdp and shape[-1] % wide_size == 0:
                return (None,) * (nd - 1) + (wide,)
            if self._div(shape[-1]):
                return (None,) * (nd - 1) + ("model",)
            return ()

        def row(axis_from_end=2):  # shard dim -2
            sp = [None] * nd
            if self.fsdp and shape[-axis_from_end] % wide_size == 0:
                sp[nd - axis_from_end] = wide
                return tuple(sp)
            if self._div(shape[-axis_from_end]):
                sp[nd - axis_from_end] = "model"
                return tuple(sp)
            return ()

        if name == "embed":
            if self.fsdp and shape[-1] % self.data_size == 0:
                return ("model", "data")
            return ("model", None)
        if name == "lm_head":
            if self.fsdp and shape[0] % self.data_size == 0:
                return ("data", "model")
            return (None, "model")
        if "moe" in keys and name in ("gate", "up", "down"):
            # (L, E_phys, D, F): expert slots over 'model' (EP), the FFN
            # width over 'data' (expert-TP); MoEDist.expert_specs
            sp = [None] * nd
            sp[nd - 3] = "model"
            tp_dim = (nd - 1) if name in ("gate", "up") else (nd - 2)
            if shape[tp_dim] % self.data_size == 0:
                sp[tp_dim] = "data"
            return tuple(sp)
        if name == "router":
            return ()
        # attention projections
        if name == "wq":
            return col() if (self.attn_tp or self.fsdp) else ()
        if name in ("wk", "wv"):
            # under FSDP the flat projection shards 2D regardless of head
            # boundaries; otherwise kv-head TP only where heads divide
            return col() if (self.kv_tp or self.fsdp) else ()
        if name == "wo":
            return row() if (self.attn_tp or self.fsdp) else ()
        # MLA
        if name in ("wdq", "wuq"):
            return col() if self.attn_tp else ()
        if name in ("wuk", "wuv"):
            # (..., H, dn, R) / (..., H, R, dv): the head axis
            if self.attn_tp:
                sp = [None] * nd
                sp[nd - 3] = "model"
                return tuple(sp)
            return ()
        if name in ("wdkv", "wkr", "q_norm", "kv_norm"):
            return ()
        # dense FFN
        if name in ("w_gate", "w_up"):
            return col()
        if name == "w_down":
            return row()
        # mamba (channel = d_inner parallel)
        if name in ("in_proj", "dt_proj"):
            return col()
        if name in ("x_proj", "out_proj", "A_log"):
            return row()
        if name == "conv_w":
            return col()
        if name in ("conv_b", "dt_bias", "D_skip"):
            return col() if self._div(shape[-1]) else ()
        # norms and everything else: replicated
        return ()

    def params_specs(self, params) -> Dict:
        """:meth:`param_spec` of every leaf of a nested dict."""
        return _map_with_path(self.param_spec, params)

    # -- activations / batch -----------------------------------------------------

    def batch_spec(self, batch_size: int) -> Spec:
        """The batch dimension's spec; one axis stands as its name."""
        axes = batch_axes(self.mesh, batch_size)
        if not axes:
            return ()
        return (axes[0],) if len(axes) == 1 else (axes,)

    def data_specs(self, batch, batch_size: int) -> Dict:
        """Each batch leaf's spec: its leading dimension over the batch
        axes where it is the batch's."""
        bspec = self.batch_spec(batch_size)

        def one(path, leaf):
            sp = [None] * len(leaf.shape)
            if (len(leaf.shape) >= 1 and leaf.shape[0] == batch_size
                    and bspec != ()):
                sp[0] = bspec[0]
            return tuple(sp)

        return _map_with_path(one, batch)

    # -- decode cache ---------------------------------------------------------------

    def cache_specs(self, cache, batch_size: int) -> Dict:
        """Decode-cache specs: batch over DP, plus a 'model' shard on the
        widest cache dimension:

        * GQA K/V (..., B, W, Hkv, Dh): kv-heads over 'model' when they
          divide, else the window W (context-parallel decode).
        * MLA latent (..., B, W, R), or the port's fused ring (..., B, W,
          1, R + dr): the window over 'model'.
        * Mamba states (..., d_conv|d_inner, d_inner|N): d_inner over
          'model'.
        """
        cfg = self.cfg
        bspec = self.batch_spec(batch_size)
        Dh = cfg.resolved_head_dim() if cfg.num_heads else 0
        Hkv = cfg.num_kv_heads
        d_inner = (cfg.mamba.expand * cfg.d_model) if cfg.mamba else 0
        mla_dims = ((cfg.mla.kv_lora_rank, cfg.mla.qk_rope_head_dim)
                    if cfg.mla else ())

        def one(path, leaf):
            shape = tuple(leaf.shape)
            nd = len(shape)
            sp = [None] * nd
            model_axis = None
            if nd >= 4 and shape[-1] == Dh and shape[-2] == Hkv:
                if self.kv_tp:
                    model_axis = nd - 2
                elif shape[-3] % self.model_size == 0:
                    model_axis = nd - 3          # context-parallel window
            elif nd >= 3 and mla_dims and shape[-1] in mla_dims:
                if shape[-2] % self.model_size == 0:
                    model_axis = nd - 2          # latent window
            elif (nd >= 4 and mla_dims and shape[-1] == sum(mla_dims)
                  and shape[-2] == 1):
                if shape[-3] % self.model_size == 0:
                    model_axis = nd - 3          # the fused latent window
            elif d_inner and nd >= 2 and shape[-1] == d_inner:
                model_axis = nd - 1              # mamba conv state
            elif d_inner and nd >= 2 and shape[-2] == d_inner:
                model_axis = nd - 2              # mamba ssm state
            if model_axis is not None:
                sp[model_axis] = "model"
            if bspec != ():
                dims = [i for i, s in enumerate(shape)
                        if s == batch_size and i != model_axis]
                if dims:
                    sp[dims[0]] = bspec[0]
            return tuple(sp)

        return _map_with_path(one, cache)


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    return fn(path, tree)


def local_shard(leaf, spec: Spec, mesh):
    """This rank's block of ``leaf`` placed by ``spec`` on ``mesh`` (a
    ``DeviceMesh``): along each dimension split over an axis (or a tuple
    of axes, the first major) the block at the rank's coordinate, as a
    new contiguous tensor; a dimension that does not divide raises."""
    sizes = axis_sizes(mesh)
    out = leaf
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        n, index = 1, 0
        for a in axes:
            n *= sizes[a]
            index = index * sizes[a] + mesh.get_local_rank(a)
        length = leaf.shape[dim]
        if length % n:
            raise ValueError(f"dimension {dim} of {tuple(leaf.shape)} does "
                             f"not divide over {axes} ({n})")
        step = length // n
        out = out.narrow(dim, index * step, step)
    return out.clone(memory_format=torch.contiguous_format)
