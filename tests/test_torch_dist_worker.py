"""One rank of the gloo groups that ``tests/test_torch_distributed.py``
drives (no tests of its own; it imports torch and the port, never JAX).

    python tests/test_torch_dist_worker.py RANK WORLD STORE_FILE

joins a gloo group through a ``FileStore`` at STORE_FILE, then reads jobs
(pickled dicts) from its standard input and writes each job's result
(a pickled dict, or ``{"error": traceback}``) to its standard output,
until it reads ``None``; then it destroys its group.  Every rank reads
the same jobs in the same order, so their collectives pair up.

A job runs the smoke ``qwen2-moe-a2.7b`` in f32 from ``Model.init(seed)``
with ``moe_dist`` on a mesh of the job's shape, on this rank's share of
the job's batch (``MoEDist.place``) and its block of the expert bank
(``MoEDist.shard_params``):

* ``forward``: ``logits_full`` with its aux loss;
* ``ring``: ``Model.prefill`` and greedy ``decode_step``s;
* ``grad``: the gradient of ``Model.loss / world`` of every leaf (the
  ranks' losses then sum to the global loss), or what it raised.

A ``tp`` job (``tests/test_torch_tp.py``) runs the job's smoke ``arch``
with ``Model(tp=TensorParallel(mesh, rules))`` on this rank's
``tp_shard`` of the weights in the job's checkpoint (``rules.fsdp`` set
as the job says), the MoE layers through ``gather_psum``: the ring
prefill of its rows of the job's batch, then a decode step for each of
the job's ``feed`` tokens; it returns each step's logits (the rank's
vocabulary columns) and greedy tokens (``TensorParallel.greedy``).  A
``merge`` job folds the ranks' attention partials of a ring's quarters
(``merge_partials``); a ``greedy`` job picks the token of logits whose
columns are split over the ranks (``TensorParallel.greedy``).  A
``train`` job (``tests/test_torch_tp_train.py``) takes the TP train step
on the same model for each of the job's batches; a ``saved`` job records
what ``Model.loss``'s forward saves for its backward.
"""
import dataclasses
import datetime
import os
import pickle
import sys
import traceback

import torch
import torch.distributed as dist


def job_model(job, meshes):
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.collectives import make_moe_dist
    from repro_torch.launch.mesh import dp_axes, make_mesh
    from repro_torch.models.model import Model
    cfg = get_smoke_config("qwen2-moe-a2.7b")
    moe = cfg.moe
    if job.get("capacity_factor") is not None:
        moe = dataclasses.replace(moe, capacity_factor=job["capacity_factor"])
    if job.get("aux_loss_coef") is not None:
        moe = dataclasses.replace(moe, aux_loss_coef=job["aux_loss_coef"])
    cfg = dataclasses.replace(cfg, moe=moe, moe_impl=job["impl"])
    key = (tuple(job["mesh"]), tuple(job["axes"]))
    if key not in meshes:
        meshes[key] = make_mesh(*key, device="cpu")
    mesh = meshes[key]
    md = make_moe_dist(mesh, job["impl"], dp_axes=dp_axes(mesh))
    params = md.shard_params(Model(cfg, device="cpu").init(job["seed"]))
    return Model(cfg, device="cpu", moe_dist=md), md, params, mesh


def tp_model(job, meshes):
    """The job's smoke ``arch`` with ``Model(tp=...)`` on this rank's
    ``tp_shard`` of the job's checkpoint (the module's docstring): returns
    (model, the rank's params, its rows of the job's batch (a slice),
    mesh)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.collectives import make_moe_dist
    from repro_torch.distributed.sharding import ShardingRules, tp_shard
    from repro_torch.distributed.tensor_parallel import TensorParallel
    from repro_torch.launch.mesh import dp_axes, make_mesh
    from repro_torch.models.model import Model
    from repro_torch.training import checkpoint as ckpt
    cfg = get_smoke_config(job["arch"])
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe_impl="gather_psum",
                                  moe=dataclasses.replace(cfg.moe,
                                                          **job["moe"]))
    if job.get("mla"):
        cfg = dataclasses.replace(cfg, mla=dataclasses.replace(
            cfg.mla, **job["mla"]))
    cfg = dataclasses.replace(cfg, remat=bool(job.get("remat")))
    key = (tuple(job["mesh"]), tuple(job["axes"]))
    if key not in meshes:
        meshes[key] = make_mesh(*key, device="cpu")
    mesh = meshes[key]
    rules = ShardingRules(mesh, cfg)
    rules.fsdp = job["fsdp"]
    whole = ckpt.load_params(job["ckpt"], dtype=torch.float32, device="cpu")

    def shard(tree, specs, path=()):
        if isinstance(tree, dict):
            return {k: shard(v, specs[k], path + (k,))
                    for k, v in tree.items()}
        return tp_shard(path, tree, specs, mesh)
    params = shard(whole, rules.params_specs(whole))
    md = None
    B = job["batch"]["tokens"].shape[0]
    if cfg.moe is not None:
        md = make_moe_dist(mesh, "gather_psum", dp_axes=dp_axes(mesh))
        md.place(B)
    tp = TensorParallel(mesh, rules)
    rows = tp.place(B)
    return Model(cfg, device="cpu", moe_dist=md, tp=tp), params, rows, mesh


def _coords(mesh):
    return {a: mesh.get_local_rank(a) for a in mesh.mesh_dim_names}


def tp_run(job, meshes):
    """The ``tp`` job (the module's docstring)."""
    from repro_torch.training import checkpoint as ckpt
    model, params, rows, mesh = tp_model(job, meshes)
    tp = model.tp
    batch = {k: torch.from_numpy(v)[rows] for k, v in job["batch"].items()}
    last, cache = model.prefill(params, batch, max_seq=job["max_seq"])
    logits, tokens = [last.numpy()], [tp.greedy(last).numpy()]
    for fed in job["feed"]:
        last, cache = model.decode_step(params, cache,
                                        torch.from_numpy(fed)[rows])
        logits.append(last.numpy())
        tokens.append(tp.greedy(last).numpy())
    return {"rows": (rows.start, rows.stop), "logits": logits,
            "tokens": tokens, "coords": _coords(mesh),
            "cache": {k: tuple(t.shape) for k, t in ckpt.flatten(cache)}}


def _numpy(tree):
    from repro_torch.training.checkpoint import flatten
    return {k: t.detach().numpy().copy() for k, t in flatten(tree)}


def train_run(job, meshes):
    """The ``train`` job: the TP train step (``make_train_step`` of
    ``Model(tp=...)``, ``cfg.remat`` as the job says) for each of the
    job's batches, AdamW from ``init_adamw`` of the rank's blocks.  Returns
    each step's metrics, step 0's gradients before and after
    ``TensorParallel.reduce_grads`` (``grads_of`` at the first step's
    params: the rank's blocks of the gradient of ``loss / world``), the
    params after the last step, and each leaf's placement."""
    from repro_torch.training.checkpoint import flatten
    from repro_torch.training.optimizer import OptimizerConfig, init_adamw
    from repro_torch.training.train_loop import grads_of, make_train_step
    model, params, rows, mesh = tp_model(job, meshes)
    tp = model.tp
    batches = [{k: torch.from_numpy(v)[rows] for k, v in b.items()}
               for b in job["batches"]]
    _, _, _, raw = grads_of(model, params, batches[0])
    step = make_train_step(model, OptimizerConfig(**job["opt"]))
    opt = init_adamw(params)
    metrics = []
    for b in batches:
        params, opt, m = step(params, opt, b)
        metrics.append({k: float(v) for k, v in m.items()})
    return {"rows": (rows.start, rows.stop), "coords": _coords(mesh),
            "metrics": metrics, "raw": _numpy(raw),
            "reduced": _numpy(tp.reduce_grads(raw)),
            "params": _numpy(params), "moments": {
                k: tuple(t.shape) for k, t in flatten(opt.m)},
            "specs": dict(flatten(tp.placed))}


def saved_run(job, meshes):
    """The ``saved`` job: the shapes of the tensors that ``Model.loss``'s
    forward saves for its backward outside any checkpoint (a
    ``saved_tensors_hooks`` around it; a checkpointed layer's own saves
    are the checkpoint's, and dropped), and the shape of each layer leaf
    that the FSDP regather makes (the TP layout) where it differs from
    the rank's stored block, and that leaf's whole shape (one layer)."""
    from repro_torch.models.layers import take_layer
    from repro_torch.training.checkpoint import flatten
    from repro_torch.training.train_loop import as_leaves
    model, params, rows, mesh = tp_model(job, meshes)
    tp = model.tp
    batch = {k: torch.from_numpy(v)[rows] for k, v in job["batch"].items()}
    saved = []

    def pack(t):
        saved.append(tuple(t.shape))
        return t
    leaves = as_leaves(params)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        with torch.enable_grad():
            loss, _ = model.loss(leaves, batch)
    loss.backward()
    regathered, whole = set(), set()
    specs = model.param_specs()
    with torch.no_grad():
        for name, n, *_ in model.layer_groups():
            for i in range(n):
                raw = take_layer(params[name], i)
                full = tp.stream_layer(raw, (name,), i)
                for (_, a), (_, b), (_, w) in zip(
                        flatten(raw), flatten(full), flatten(specs[name])):
                    if a.shape != b.shape:
                        regathered.add(tuple(b.shape))
                        whole.add(tuple(w.shape[1:]))
    return {"saved": saved, "regathered": sorted(regathered),
            "whole": sorted(whole)}


def _mesh_1x4(meshes):
    from repro_torch.launch.mesh import make_mesh
    key = ((1, 4), ("data", "model"))
    if key not in meshes:
        meshes[key] = make_mesh(*key, device="cpu")
    return meshes[key]


def greedy_run(job, meshes):
    """The ``greedy`` job: this rank's quarter of the columns of the job's
    logits through ``TensorParallel.greedy`` over 'model' of a 1 x 4
    mesh."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.sharding import ShardingRules
    from repro_torch.distributed.tensor_parallel import TensorParallel
    mesh = _mesh_1x4(meshes)
    tp = TensorParallel(mesh, ShardingRules(
        mesh, get_smoke_config("qwen2-moe-a2.7b")))
    logits = torch.from_numpy(job["logits"])
    n = logits.shape[-1] // tp.size
    return {"tokens": tp.greedy(
        logits[:, tp.rank * n:(tp.rank + 1) * n]).numpy()}


def merge_run(job, meshes):
    """The ``merge`` job: this rank's quarter of the job's ring through the
    plain ``paged_attention`` with ``lse_out``, then ``merge_partials``
    over 'model' of a 1 x 4 mesh."""
    from repro_torch.distributed.tensor_parallel import merge_partials
    from repro_torch.kernels.paged_attention import paged_attention_plain
    mesh = _mesh_1x4(meshes)
    r = mesh.get_local_rank("model")
    q, k, v, lens = (torch.from_numpy(job[n]) for n in ("q", "k", "v",
                                                        "lens"))
    step = k.shape[1] // 4
    sl = slice(r * step, (r + 1) * step)
    lse = torch.empty(q.shape[:2], dtype=torch.float32)
    o = paged_attention_plain(
        q, k[:, sl].contiguous(), v[:, sl].contiguous(),
        torch.arange(q.shape[0], dtype=torch.int32)[:, None],
        (lens - r * step).clamp(0, step).to(torch.int32), lse_out=lse)
    return {"o": merge_partials(o, lse, mesh.get_group("model")).numpy()}


def run(job, meshes):
    from repro_torch.training.checkpoint import flatten
    from repro_torch.training.train_loop import as_leaves
    if job["kind"] == "tp":
        return tp_run(job, meshes)
    if job["kind"] == "train":
        return train_run(job, meshes)
    if job["kind"] == "saved":
        return saved_run(job, meshes)
    if job["kind"] == "merge":
        return merge_run(job, meshes)
    if job["kind"] == "greedy":
        return greedy_run(job, meshes)
    model, md, params, mesh = job_model(job, meshes)
    tokens = torch.from_numpy(job["tokens"])
    rows = md.place(tokens.shape[0])
    share = {"tokens": tokens[rows]}
    out = {"rows": (rows.start, rows.stop),
           "coords": {a: mesh.get_local_rank(a)
                      for a in mesh.mesh_dim_names}}
    if job["kind"] == "forward":
        with torch.no_grad():
            logits, _, aux = model.logits_full(params, share, with_aux=True)
        out.update(logits=logits.numpy(), aux=float(aux))
    elif job["kind"] == "ring":
        last, cache = model.prefill(params, share,
                                    max_seq=tokens.shape[1] + job["steps"])
        fed, steps = [], [last.numpy()]
        for _ in range(job["steps"]):
            fed.append(last[:, :model.cfg.vocab_size].argmax(-1))
            last, cache = model.decode_step(params, cache, fed[-1])
            steps.append(last.numpy())
        out.update(tokens=torch.stack(fed, 1).numpy(), logits=steps)
    elif job["kind"] == "grad":
        leaves = as_leaves(params)
        share["loss_mask"] = torch.ones_like(share["tokens"])
        try:
            loss, metrics = model.loss(leaves, share)
        except RuntimeError as e:
            out.update(raised=str(e))
            return out
        keys, ts = zip(*flatten(leaves))
        grads = torch.autograd.grad(loss / dist.get_world_size(), ts,
                                    allow_unused=True)
        out.update(loss=float(loss), grads={
            k: (torch.zeros_like(t) if g is None else g).numpy()
            for k, t, g in zip(keys, ts, grads)})
    else:
        raise ValueError(job["kind"])
    return out


def main():
    rank, world, store = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    torch.set_num_threads(1)
    # results go through the original standard output; prints to stderr
    results = os.fdopen(os.dup(1), "wb")
    os.dup2(2, 1)
    jobs = sys.stdin.buffer
    dist.init_process_group(
        "gloo", rank=rank, world_size=world,
        store=dist.FileStore(store, world),
        timeout=datetime.timedelta(seconds=120))
    meshes = {}
    try:
        while True:
            job = pickle.load(jobs)
            if job is None:
                break
            try:
                out = run(job, meshes)
            except Exception:
                out = {"error": traceback.format_exc()}
            pickle.dump(out, results)
            results.flush()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
