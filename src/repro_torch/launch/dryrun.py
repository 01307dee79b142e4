"""Dry run: one rank's step over a fake 256- or 512-rank group, traced.

The twin of ``repro.launch.dryrun``, which lowers and compiles the step
for 512 placeholder TPU devices (2 pods x 256 chips) and reads XLA's
memory and cost analyses.  The port has no compiler to ask, so it runs
the step: this process is rank 0 of a ``torch.distributed`` group of 256
(16 x 16) or 512 (2 x 16 x 16) ranks with the ``fake`` backend
(``torch.testing._internal.distributed.fake_pg``: collectives return
outputs of the right shapes and move nothing), and the step runs once
under ``FakeTensorMode`` on tensors of rank 0's shapes, which hold no
storage.  Nothing is allocated, whatever the model's size.  It is a
trace by design, as ``repro``'s dry run is, and no device runs.

What a rank runs is a gather-at-entry model of a step, which no runtime
of the port executes.  Each argument is stored as ``ShardingRules``
places it (``local_shard`` of it), so ``argument_bytes`` is the JAX
package's per-device argument size.  The port has no tensor parallelism
outside the experts, so the model's step all-gathers every split leaf
whole at its entry, except the expert bank (the distributed MoE layer,
``MoEDist`` or ``MoEDistA2A``, takes its block) and the batch rows (the
rank's share); a decode step's cache leaves gather their 'model' split
and are cut back after it.  A train step all-reduces the whole leaves'
gradients over the DP axes and updates its own shards.  Every rank of a
'model' group repeats the same non-expert compute.  The collectives,
wire bytes and temp bytes are this model's: neither the JAX package's
GSPMD step's nor those of the port's distributed path, which cuts only
the expert bank and keeps the rest whole on every rank.

From the trace (:func:`trace`):

* FLOPs, by ``torch.utils.flop_counter``'s formulas (the registry
  ``FlopCounterMode`` counts with, applied to each aten op in the same
  dispatch mode that counts bytes: matrix products and attention, 2 a
  multiply-add, as XLA counts);
* bytes accessed: the sum of each aten op's input and output bytes (view
  ops and uninitialised allocations aside).  An upper bound with no
  fusion, where XLA's count is after fusion; and it is the plain
  versions' traffic (a CPU tensor takes a kernel's plain version), so an
  attention over S keys counts its (S x S) probabilities;
* each collective at the four wrappers of ``distributed.collectives``,
  its per-rank bytes and group, through the JAX package's ring wire
  model (:func:`wire_bytes`), over NVLink when the group lies within one
  node of ``hardware.NODE_RANKS`` ranks, else over the network;
* memory: ``argument_bytes`` (rank 0's shards of the arguments),
  ``output_bytes`` (the outputs' storages) and ``temp_bytes`` (the peak
  of live storages made during the step, outputs included).
  ``code_bytes`` is None: an eager step has no compiled executable.

The roofline divides by the H100 SXM's data sheet
(``hardware.card_sheet``), and the record names the card ``nvidia-smi``
reads.  A Python loop over layers is traced whole, so the full-depth
trace is exact; the 2- and 4-unit traces of the JAX package's cost
extrapolation are kept (``cost_extrapolation``) and equal it on a
homogeneous stack.

Usage:
  python -m repro_torch.launch.dryrun --arch kimi-k2-1t-a32b --shape train_4k
  python -m repro_torch.launch.dryrun --arch ... --shape ... --multi-pod
  python -m repro_torch.launch.dryrun --list
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import sys
import time
import weakref
from functools import partial
from typing import Dict, Optional

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import ALL_ARCHS, INPUT_SHAPES, get_config
from repro_torch.distributed import collectives as C
from repro_torch.distributed.sharding import ShardingRules, local_shard
from repro_torch.hardware import NODE_RANKS, card_sheet
from repro_torch.launch.mesh import axis_sizes, dp_axes, make_mesh
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import make_step, step_arg_specs
from repro_torch.models.model import MetaFactories, Model
from repro_torch.models.moe import MoERuntime, physical_experts
from repro_torch.training.optimizer import AdamWState

PROCESS_GROUP = "fake (torch.testing._internal.distributed.fake_pg)"
PLACEMENT = ("a gather-at-entry model of a rank's step, which no runtime "
             "of the port executes: ShardingRules' shards stored; every "
             "split leaf but the expert bank and the batch rows all-"
             "gathered whole at the step's entry; a train step's "
             "gradients all-reduced over DP and cut back.  Its "
             "collectives, wire and temp bytes are this model's, not the "
             "JAX package's GSPMD step's, nor the port's distributed "
             "path's (the expert bank cut, the rest whole on each rank)")
TRACE = ("FakeTensorMode on the CPU: the kernels' plain versions, no "
         "device; bytes an upper bound with no fusion")


# -- the wire model -------------------------------------------------------------------

def wire_bytes(op: str, size: float, n: int) -> float:
    """Bytes a rank sends for one collective (ring algorithms), the JAX
    package's model (``parse_collectives``): ``size`` is the per-rank
    operand of an all-reduce or all-to-all and the per-rank result of an
    all-gather or reduce-scatter, ``n`` the group's size (1 or less
    counts as 2, an unknown group there).

      all-reduce       2 S (n-1)/n
      all-gather       S (n-1)/n
      reduce-scatter   S (n-1)
      all-to-all       S (n-1)/n
      collective-permute  S
    """
    if n <= 1:
        n = 2
    frac = (n - 1) / n
    if op == "all-reduce":
        return 2 * size * frac
    if op in ("all-gather", "all-to-all"):
        return size * frac
    if op == "reduce-scatter":
        return size * (n - 1)
    return size


# -- configs: useful FLOPs and depth ----------------------------------------------------

def _flat(tree, path=()):
    """(key path, leaf) of every tensor of a tree of dicts, NamedTuples,
    tuples and lists (None skipped)."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, path + (str(k),))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f, v in zip(tree._fields, tree):
            yield from _flat(v, path + (f,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _flat(v, path + (str(i),))
    else:
        yield path, tree


def _map2(fn, tree, spec, path=()):
    """``fn(path, leaf, spec)`` over the tensors of ``tree``, ``spec`` a
    tree of the same containers with a placement at each tensor."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map2(fn, v, spec[k], path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map2(fn, v, s, path + (f,)) for f, v, s in
                            zip(tree._fields, tree, spec)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map2(fn, v, s, path + (str(i),))
                          for i, (v, s) in enumerate(zip(tree, spec)))
    return fn(path, tree, spec)


def model_flops_params(cfg) -> Dict[str, float]:
    """Active / total matmul params for MODEL_FLOPS (6·N·D or 2·N·D)."""
    specs = Model(cfg, torch.bfloat16, device="cpu").param_specs()
    total = expert = embed = 0
    for keys, leaf in _flat(specs):
        n = leaf.numel()
        total += n
        if "moe" in keys and keys[-1] in ("gate", "up", "down"):
            expert += n
        if keys[-1] == "embed":
            embed += n
    active = total - embed - expert
    if cfg.moe is not None and expert:
        active += expert * cfg.moe.top_k / physical_experts(cfg.moe)
    return {"total": float(total), "active": float(active),
            "expert": float(expert)}


def layer_units(cfg) -> int:
    """Number of repeated 'layer units' for cost extrapolation.

    unit = plain layer (dense/ssm/vlm), MoE layer (moe families,
    excluding the fixed first-k dense layers), Jamba period, or
    encoder+decoder layer pair (audio).
    """
    if cfg.hybrid_period:
        return cfg.num_layers // cfg.hybrid_period
    if cfg.family == "audio":
        return cfg.num_layers  # == encoder_layers
    if cfg.moe is not None:
        return cfg.num_layers - cfg.moe.first_k_dense
    return cfg.num_layers


def with_units(cfg, n_units: int):
    if cfg.hybrid_period:
        return dataclasses.replace(cfg, num_layers=n_units * cfg.hybrid_period)
    if cfg.family == "audio":
        return dataclasses.replace(cfg, num_layers=n_units,
                                   encoder_layers=n_units)
    if cfg.moe is not None:
        return dataclasses.replace(
            cfg, num_layers=n_units + cfg.moe.first_k_dense)
    return dataclasses.replace(cfg, num_layers=n_units)


def apply_cfg_patch(cfg, patch: Optional[Dict]):
    """dataclasses.replace with dotted keys for nested moe fields,
    e.g. {"moe.min_capacity": 1, "sliding_window": 4096}."""
    if not patch:
        return cfg
    top, moe_kw = {}, {}
    for k, v in patch.items():
        if k.startswith("moe."):
            moe_kw[k[4:]] = v
        else:
            top[k] = v
    if moe_kw:
        top["moe"] = dataclasses.replace(cfg.moe, **moe_kw)
    return dataclasses.replace(cfg, **top)


# -- the trace -------------------------------------------------------------------------

_NO_TRAFFIC = ("empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided")


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def _storage_key(t):
    return StorageWeakRef(t.untyped_storage())


class _Tally(TorchDispatchMode):
    """Counts each aten op's FLOPs and input and output bytes, and the
    live bytes of the storages made under it (their peak); with ``log``
    a line per op.  ``keep``: the arguments' storages, not counted."""

    def __init__(self, keep, log: bool):
        super().__init__()
        self.keep = keep
        self.bytes = self.flops = self.ops = 0
        self.live: Dict = {}
        self.refs: Dict = {}
        self.cur = self.peak = 0
        self.log = [] if log else None

    def _freed(self, key, _ref):
        self.cur -= self.live.pop(key, 0)
        self.refs.pop(key, None)

    def _track(self, t):
        st = t.untyped_storage()
        key = _storage_key(t)
        if key in self.keep or key in self.live:
            return
        self.live[key] = st.nbytes()
        self.refs[key] = weakref.ref(st, partial(self._freed, key))
        self.cur += self.live[key]
        self.peak = max(self.peak, self.cur)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func is torch.ops.prim.device.default:
            return out
        self.ops += 1
        packet = func.overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if func.namespace == "c10d":
            return out          # a collective: the wire model's
        if not func.is_view and packet.__name__ not in _NO_TRAFFIC:
            self.bytes += sum(t.numel() * t.element_size() for t in
                              _tensors((args, kwargs, out)))
        for t in _tensors(out):
            self._track(t)
        if self.log is not None:
            shapes = lambda x: [tuple(t.shape) for t in _tensors(x)]  # noqa
            self.log.append(f"{func} {shapes((args, kwargs))} -> "
                            f"{shapes(out)}")
        return out


def _link(group, sheet, cache):
    """("nvlink" | "network", bytes a second) of ``group``: NVLink when
    its ranks lie within one node of NODE_RANKS, else the network (its
    ring crosses a node's boundary)."""
    import torch.distributed as dist
    key = id(group)
    if key not in cache:
        ranks = dist.get_process_group_ranks(group)
        one_node = len({r // NODE_RANKS for r in ranks}) == 1
        cache[key] = (("nvlink", sheet["nvlink_bytes_per_s"]) if one_node
                      else ("network", sheet["network_bytes_per_s"]))
    return cache[key]


def trace(step, specs, *, sheet=None, log: bool = False) -> Dict:
    """Run ``step`` once on fake CPU tensors of ``specs``' shapes and
    dtypes (a tree of meta or real tensors; nothing of theirs is read)
    under ``FakeTensorMode``, and count.  Returns ``flops``, ``bytes``,
    ``ops``, ``argument_bytes``, ``output_bytes``, ``temp_bytes``,
    ``collectives`` ({op: {count, bytes, wire, seconds, links}}),
    ``wire`` and ``collective_s`` (over ``sheet``'s links), ``seconds``
    (the trace's own) and, with ``log``, ``log`` (a line per aten op)."""
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    sheet = sheet or card_sheet()
    mode = FakeTensorMode()

    def fake(path, t, _spec):
        return torch.empty(tuple(t.shape), dtype=t.dtype, device="cpu")

    with mode:
        args = _map2(fake, specs, specs)
    keep = {}
    for _, t in _flat(args):
        keep[_storage_key(t)] = t.untyped_storage().nbytes()
    tally = _Tally(set(keep), log)
    stats: Dict[str, Dict] = {}
    links: Dict = {}

    def note(op, size, group):
        n = dist.get_world_size(group)
        link, rate = _link(group, sheet, links)
        wire = wire_bytes(op, size, n)
        s = stats.setdefault(op, {"count": 0, "bytes": 0.0, "wire": 0.0,
                                  "seconds": 0.0, "links": {}})
        s["count"] += 1
        s["bytes"] += size
        s["wire"] += wire
        s["seconds"] += wire / rate
        s["links"][link] = s["links"].get(link, 0) + 1

    t0 = time.perf_counter()
    with mode, tally, C.recording(note):
        out = step(*args)
    seconds = time.perf_counter() - t0
    outs = {}
    for _, t in _flat(out):
        outs[_storage_key(t)] = t.untyped_storage().nbytes()
    rec = {"flops": float(tally.flops),
           "bytes": float(tally.bytes), "ops": tally.ops,
           "argument_bytes": int(sum(keep.values())),
           "output_bytes": int(sum(outs.values())),
           "temp_bytes": int(tally.peak), "collectives": stats,
           "wire": sum(s["wire"] for s in stats.values()),
           "collective_s": sum(s["seconds"] for s in stats.values()),
           "seconds": seconds}
    if log:
        rec["log"] = tally.log
    return rec


# -- one rank of the production mesh ----------------------------------------------------

@contextlib.contextmanager
def fake_group(world_size: int):
    """The default process group as ``world_size`` ranks of the ``fake``
    backend, this process rank 0; destroyed on leaving, so a process can
    hold another group afterwards."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry run makes its own process group; one "
                           "exists already")
    dist.init_process_group("fake", rank=0, world_size=world_size,
                            store=FakeStore())
    try:
        yield PROCESS_GROUP
    finally:
        dist.destroy_process_group()


def _is_expert(path) -> bool:
    return "moe" in path and path[-1] in ("gate", "up", "down")


def arg_placements(rules: ShardingRules, kind: str, args, B: int):
    """Each argument leaf's spec, as the JAX package's
    ``build_in_shardings`` places it."""
    pspec = rules.params_specs(args[0])
    if kind == "train":
        return (pspec, AdamWState((), pspec, pspec),
                rules.data_specs(args[2], B))
    runtime = args[-1]
    rt = None if runtime is None else MoERuntime((), (), ())
    if kind == "prefill":
        return (pspec, rules.data_specs(args[1], B), rt)
    return (pspec, rules.cache_specs(args[1], B), rules.batch_spec(B), rt)


class _RankStep:
    """The step of ``kind`` as rank 0 runs it on its shards (the module's
    docstring): whole leaves gathered at the entry, a decode cache's and
    a prefill cache's 'model' split cut back at the exit."""

    def __init__(self, model: Model, kind: str, mesh, placed,
                 cache_spec=None):
        self.model, self.kind, self.mesh = model, kind, mesh
        self.placed, self.cache_spec = placed, cache_spec
        self.groups = {a: mesh.get_group(a) for a in mesh.mesh_dim_names}
        self.dp = dp_axes(mesh)
        self.dp_size = math.prod(axis_sizes(mesh)[a] for a in self.dp)

    def _whole(self, x, spec, only_model=False):
        """``x`` all-gathered along each split dimension of ``spec`` (the
        first axis of a pair major); with ``only_model`` along the
        'model' splits alone."""
        for dim, entry in enumerate(spec):
            if entry is None:
                continue
            axes = (entry,) if isinstance(entry, str) else tuple(entry)
            if only_model and "model" not in axes:
                continue
            y = x.movedim(dim, 0)
            for a in reversed(axes):
                y = C.all_gather(y, self.groups[a])
            x = y.movedim(0, dim).contiguous()
        return x

    def _cut(self, x, spec, only_model=False):
        if only_model:
            spec = tuple(e if e is not None and "model" in (
                (e,) if isinstance(e, str) else e) else None for e in spec)
        return local_shard(x, spec, self.mesh)

    def gather(self, params):
        return _map2(lambda p, x, sp: x if _is_expert(p) else
                     self._whole(x, sp), params, self.placed[0])

    def reduce_grads(self, grads):
        """Whole leaves' gradients averaged over the DP axes, cut to this
        rank's shards; the expert blocks' as the layer's collectives
        left them."""
        def one(path, g, spec):
            if _is_expert(path):
                return g
            for a in self.dp:
                g = C.all_reduce(g, self.groups[a])
            return self._cut(g / self.dp_size, spec)
        return _map2(one, grads, self.placed[0])

    def step(self):
        if self.kind == "train":
            return make_step(self.model, "train", gather=self.gather,
                             reduce_grads=self.reduce_grads)
        inner = make_step(self.model, self.kind)
        cut = lambda p, x, sp: self._cut(x, sp, only_model=True)  # noqa
        if self.kind == "prefill":
            def prefill_step(params, batch, runtime):
                tok, cache = inner(self.gather(params), batch, runtime)
                return tok, _map2(cut, cache, self.cache_spec)
            return prefill_step

        def serve_step(params, cache, tokens, runtime):
            whole = _map2(lambda p, x, sp: self._whole(x, sp, True), cache,
                          self.placed[1])
            tok, whole = inner(self.gather(params), whole, tokens, runtime)
            return tok, _map2(cut, whole, self.placed[1])
        return serve_step


def rank_step(cfg, shape, mesh, moe_impl: str, *, force_attn_tp=False,
              log: bool = False, sheet=None) -> Dict:
    """Trace rank 0's step of ``cfg`` at ``shape`` on ``mesh`` (a
    ``DeviceMesh`` over the fake group): :func:`trace`'s record."""
    md = (C.make_moe_dist(mesh, moe_impl, dp_axes=dp_axes(mesh),
                          backend="fake")
          if cfg.moe is not None else None)
    model = Model(cfg, torch.bfloat16, device="cpu", moe_dist=md)
    specs = step_arg_specs(model, cfg, shape)
    rules = ShardingRules(mesh, cfg)
    if force_attn_tp:
        # attention leaves stored split where their last dimension divides
        # (gathered whole at the entry: the port has no head-parallel
        # attention)
        rules.attn_tp = rules.kv_tp = True
    B = shape.global_batch
    if md is not None:
        md.place(B)
    placed = arg_placements(rules, shape.kind, specs, B)
    if md is not None:
        want = md.expert_specs()
        for path, leaf in _flat(specs[0]):
            if _is_expert(path):
                got = rules.param_spec(path, leaf)
                if got != want[path[-1]][-leaf.dim():]:
                    raise ValueError(f"{path}: ShardingRules places it "
                                     f"{got}, the MoE layer takes "
                                     f"{want[path[-1]]}")
    cache_spec = None
    if shape.kind == "prefill":
        with MetaFactories():
            cache = model.init_cache(B, shape.seq_len, device="cpu")
        cache_spec = rules.cache_specs(cache, B)
    local = _map2(lambda p, t, sp: local_shard(t, sp, mesh), specs, placed)
    step = _RankStep(model, shape.kind, mesh, placed, cache_spec).step()
    return trace(step, local, sheet=sheet, log=log)


def extrapolated_cost(cfg, shape, mesh, moe_impl: str, **kw):
    """Linear-in-depth cost model from 2- and 4-unit traces."""
    units_full = layer_units(cfg)
    u_small, u_big = 2, 4
    cfg_u = dataclasses.replace(cfg, scan_layers=False)
    r2 = rank_step(with_units(cfg_u, u_small), shape, mesh, moe_impl, **kw)
    r4 = rank_step(with_units(cfg_u, u_big), shape, mesh, moe_impl, **kw)
    du = u_big - u_small

    def ext(small, big):
        per = (big - small) / du
        return small + (units_full - u_small) * per, per

    flops, flops_per = ext(r2["flops"], r4["flops"])
    bytes_, bytes_per = ext(r2["bytes"], r4["bytes"])
    wire, wire_per = ext(r2["wire"], r4["wire"])
    return {
        "flops": flops, "bytes": bytes_, "wire": wire,
        "per_unit": {"flops": flops_per, "bytes": bytes_per,
                     "wire": wire_per},
        "fixed": {"flops": r2["flops"] - 2 * flops_per,
                  "bytes": r2["bytes"] - 2 * bytes_per,
                  "wire": r2["wire"] - 2 * wire_per},
        "units": units_full,
        "collectives_4unit": r4["collectives"],
        "trace_s": r2["seconds"] + r4["seconds"],
    }


def card_line(sheet) -> str:
    card = (f"card {sheet['name']}, {sheet['power_limit']}" if
            sheet["name"] else "no card read (nvidia-smi)")
    return (f"{card}; data sheet {sheet['sheet']}: bf16 {sheet['bf16_flops'] / 1e12:g} "
            f"TFLOP/s, HBM {sheet['hbm_bytes_per_s'] / 1e12:g} TB/s, NVLink "
            f"{sheet['nvlink_bytes_per_s'] / 1e9:g} GB/s, network "
            f"{sheet['network_bytes_per_s'] / 1e9:g} GB/s a GPU")


def run_dryrun(arch: str, shape_name: str, *, multi_pod: bool = False,
               moe_impl: str = "gather_psum", save_hlo: Optional[str] = None,
               extrapolate: bool = True, verbose: bool = True,
               cfg_patch: Optional[Dict] = None,
               force_attn_tp: bool = False, donate_state: bool = False
               ) -> Dict:
    """Trace rank 0's step of ``arch`` at ``shape_name`` on the production
    mesh; the record has the JAX package's keys.  ``save_hlo``: the
    path the traced op log (a line per aten op) is written to; there is
    no HLO.  ``donate_state`` has no counterpart in the port (its decode
    step updates its cache in place, and a train step's update makes
    new tensors either way) and is refused.  The roofline takes the H100
    SXM data sheet (``hardware.card_sheet``)."""
    if donate_state:
        raise ValueError("donate_state: the port has no buffer donation "
                         "(its decode step updates the cache in place)")
    t_start = time.perf_counter()
    layout = make_production_mesh(multi_pod=multi_pod)
    n_chips = math.prod(layout.shape)
    cfg = get_config(arch, shape_name)
    shape = INPUT_SHAPES[shape_name]
    cfg = dataclasses.replace(cfg, remat=(shape.kind == "train"))
    if cfg.moe is not None:
        # as in the JAX package: a '_fused' choice also selects the fused
        # local compute inside the layer
        cfg = dataclasses.replace(cfg, moe_impl=moe_impl)
    cfg = apply_cfg_patch(cfg, cfg_patch)
    sheet = card_sheet()
    kw = dict(force_attn_tp=force_attn_tp, sheet=sheet)
    with fake_group(n_chips) as group_kind:
        t0 = time.perf_counter()
        mesh = make_mesh(layout.shape, layout.mesh_dim_names, device="cpu")
        t1 = time.perf_counter()
        full = rank_step(cfg, shape, mesh, moe_impl, log=bool(save_hlo),
                         **kw)
        ext = (extrapolated_cost(cfg, shape, mesh, moe_impl, **kw)
               if extrapolate else None)
    if save_hlo:
        with open(save_hlo, "w") as f:
            f.write("\n".join(full.pop("log")) + "\n")
    flops, bytes_acc, wire = full["flops"], full["bytes"], full["wire"]
    compute_s = flops / sheet["bf16_flops"]
    memory_s = bytes_acc / sheet["hbm_bytes_per_s"]
    coll_s = full["collective_s"]
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": coll_s}
    dominant = max(terms, key=terms.get)

    mp = model_flops_params(cfg)
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    model_flops = mult * mp["active"] * tokens
    hlo_flops_total = flops * n_chips
    useful = model_flops / hlo_flops_total if hlo_flops_total else 0.0
    if ext is None:
        ext = {"per_unit": {}, "fixed": {}, "units": layer_units(cfg),
               "collectives_4unit": {}}

    rec = {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "chips": int(n_chips), "kind": shape.kind, "moe_impl":
            moe_impl if cfg.moe else None,
        # no lowering and no compile: building the mesh, then the trace
        "lower_s": t1 - t0, "compile_s": full["seconds"],
        "trace_s": full["seconds"],
        "memory": {
            "argument_bytes": full["argument_bytes"],
            "output_bytes": full["output_bytes"],
            "temp_bytes": full["temp_bytes"],
            "code_bytes": None,          # an eager step: no executable
        },
        "per_device_flops": flops,
        "per_device_bytes": bytes_acc,
        "cost_extrapolation": {k: ext[k] for k in
                               ("per_unit", "fixed", "units")},
        "extrapolated": ({k: ext[k] for k in ("flops", "bytes", "wire",
                                              "trace_s")}
                         if "flops" in ext else None),
        "collectives": full["collectives"],
        "collectives_4unit": ext["collectives_4unit"],
        "collective_wire_bytes": wire,
        "roofline": {**terms, "dominant": dominant},
        "model_flops": model_flops,
        "hlo_flops_total": hlo_flops_total,
        "useful_flops_ratio": useful,
        "params": mp,
        "ops": full["ops"],
        "card": {k: sheet[k] for k in ("name", "power_limit", "sheet", "bf16_flops",
                                       "hbm_bytes_per_s",
                                       "nvlink_bytes_per_s",
                                       "network_bytes_per_s")},
        "node_ranks": NODE_RANKS,
        "process_group": group_kind,
        "trace": TRACE,
        "placement": PLACEMENT,
        "remat": ("the config's flag set as the JAX package sets it; the "
                  "port keeps every activation for the backward"),
        "force_attn_tp": force_attn_tp,
        "save_hlo": save_hlo and "the traced op log (no HLO)",
        "elapsed_s": time.perf_counter() - t_start,
    }
    if verbose:
        gb = 1 << 30
        mem = rec["memory"]
        print(f"== {arch} × {shape_name} × {rec['mesh']} "
              f"({shape.kind}, moe_impl={rec['moe_impl']}) ==")
        print(f"  {card_line(sheet)}")
        print(f"  a trace of rank 0's step ({group_kind} group of "
              f"{n_chips}; {TRACE}), not a timing: mesh "
              f"{rec['lower_s']:.1f}s  trace {rec['trace_s']:.1f}s "
              f"({rec['ops']} ops)")
        print("  placement: a gather-at-entry model, not a runtime of the "
              "port; collectives, wire and temp are this model's")
        print(f"  memory/device: args "
              f"{mem['argument_bytes'] / gb:.2f} GiB"
              f"  temp {mem['temp_bytes'] / gb:.2f} GiB"
              f"  out {mem['output_bytes'] / gb:.2f} GiB")
        print(f"  per-device: {flops / 1e12:.2f} TFLOP, "
              f"{bytes_acc / 1e9:.1f} GB accessed, "
              f"wire {wire / 1e9:.3f} GB")
        print(f"  roofline: compute {compute_s * 1e3:.2f} ms | memory "
              f"{memory_s * 1e3:.2f} ms | collective {coll_s * 1e3:.2f} ms "
              f"-> {dominant}")
        print(f"  MODEL_FLOPS/HLO_FLOPS = {useful:.3f}")
        for op, s in sorted(full["collectives"].items()):
            print(f"    {op:20s} n={s['count']:4d} bytes="
                  f"{s['bytes']/1e9:.3f}GB wire={s['wire']/1e9:.3f}GB "
                  f"{s['links']}")
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ALL_ARCHS)
    ap.add_argument("--shape", choices=list(INPUT_SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--moe-impl", default="gather_psum",
                    choices=["gather_psum", "a2a", "gather_psum_fused",
                             "a2a_fused"])
    ap.add_argument("--out", default=None, help="write JSON record here")
    ap.add_argument("--save-hlo", default=None,
                    help="write the traced op log here (there is no HLO)")
    ap.add_argument("--no-extrapolate", action="store_true",
                    help="skip the 2- and 4-unit traces")
    ap.add_argument("--list", action="store_true")
    # perf-experiment knobs
    ap.add_argument("--min-capacity", type=int, default=None)
    ap.add_argument("--capacity-factor", type=float, default=None)
    ap.add_argument("--force-attn-tp", action="store_true")
    ap.add_argument("--donate", action="store_true",
                    help="refused: the port has no buffer donation")
    ap.add_argument("--cache-carry", action="store_true",
                    help="refused: the port has no decode cache carry")
    ap.add_argument("--num-heads", type=int, default=None,
                    help="pad/override head count (perf experiment)")
    args = ap.parse_args(argv)
    if args.list:
        for a in ALL_ARCHS:
            print(a)
        return 0
    if not (args.arch and args.shape):
        ap.error("--arch and --shape required")
    if args.donate or args.cache_carry:
        ap.error("--donate and --cache-carry have no counterpart in the "
                 "port: its decode step updates the cache in place, and "
                 "nothing reads decode_cache_carry")
    patch = {}
    if args.min_capacity is not None:
        patch["moe.min_capacity"] = args.min_capacity
    if args.capacity_factor is not None:
        patch["moe.capacity_factor"] = args.capacity_factor
    if args.num_heads is not None:
        patch["num_heads"] = args.num_heads
        patch["num_kv_heads"] = args.num_heads
    rec = run_dryrun(args.arch, args.shape, multi_pod=args.multi_pod,
                     moe_impl=args.moe_impl, save_hlo=args.save_hlo,
                     extrapolate=not args.no_extrapolate,
                     cfg_patch=patch or None,
                     force_attn_tp=args.force_attn_tp)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
