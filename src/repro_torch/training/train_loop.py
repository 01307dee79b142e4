"""Training loop: a train-step factory and a simple driver.

Mirrors ``repro.training.train_loop``.  Where JAX takes
``jax.value_and_grad`` of the loss, the port runs the forward under grad
with every parameter a leaf that requires grad, and ``torch.autograd.grad``
collects the gradients: on the card the attention and expert FFN of that
forward go through the ``flash_prefill`` and ``expert_ffn`` kernels and
their backward kernels (``ops``' autograd Functions).  The update runs
under ``no_grad`` (:func:`~repro_torch.training.optimizer.adamw_update`).
PyTorch runs eagerly: there is no ``jit``.  A tensor-parallel model's
step runs on the rank's shards (:func:`make_train_step`).
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import torch

from repro_torch.models.model import Model
from repro_torch.training.checkpoint import flatten, unflatten
from repro_torch.training.optimizer import (OptimizerConfig, adamw_update,
                                            init_adamw, tree_map)


def as_leaves(params):
    """The parameters as leaves that require grad (views of the same
    storage: nothing is copied)."""
    return tree_map(lambda p: p.detach().requires_grad_(True), params)


def grads_of(model: Model, params, batch, runtime=None):
    """The forward and backward of ``model.loss`` at ``params``: returns
    ``(leaves, loss, metrics, grads)``, the leaves the gradients are of
    (``as_leaves(params)``), the loss and its metrics (detached) and the
    gradients in the parameters' tree (a leaf the loss does not reach
    gets zeros, as under JAX).  Under
    ``model.tp`` the loss is the global batch's on every rank and each
    rank differentiates ``loss / world`` (``distributed.collectives``'
    convention): its gradients are the rank's blocks' before
    ``TensorParallel.reduce_grads`` sums them over their holders."""
    leaves_in = as_leaves(params)
    with torch.enable_grad():
        loss, metrics = model.loss(leaves_in, batch, runtime)
    keys, leaves = zip(*flatten(leaves_in))
    scaled = loss if model.tp is None else loss / model.tp.world
    grads = torch.autograd.grad(scaled, leaves, allow_unused=True)
    grads = unflatten((k, torch.zeros_like(p) if g is None else g)
                      for k, p, g in zip(keys, leaves, grads))
    return (leaves_in, loss.detach(),
            {k: v.detach() for k, v in metrics.items()}, grads)


def make_train_step(model: Model, opt_cfg: OptimizerConfig,
                    runtime=None) -> Callable:
    """Returns ``train_step(params, opt_state, batch) -> (params,
    opt_state, metrics)``; ``batch`` holds tensors on the model's device.

    The MoE runtime is threaded through so a degraded system (masked
    experts after a recovery) can keep serving-consistent fine-tuning, as
    in ``repro``.  For a tensor-parallel model (``Model(tp=...)``,
    ``distributed.tensor_parallel``) ``params`` and the AdamW state are
    the rank's blocks (``sharding.tp_shard``) and ``batch`` its rows
    (``tp.place``): the step is the counterpart of what GSPMD makes of
    ``repro``'s jitted step on ``ShardingRules``' placement, each
    collective explicit: the loss of the global batch, the gradients
    summed over each block's holders (``TensorParallel.reduce_grads``),
    AdamW on the blocks with the global norm (``adamw_update(...,
    tp=...)``)."""
    tp = model.tp

    def train_step(params, opt_state, batch):
        params, loss, metrics, grads = grads_of(model, params, batch,
                                                runtime)
        if tp is not None:
            grads = tp.reduce_grads(grads)
        params, opt_state, opt_metrics = adamw_update(
            opt_cfg, grads, opt_state, params, tp)
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def train(model: Model, batches, steps: int,
          opt_cfg: Optional[OptimizerConfig] = None, seed: int = 0,
          log_every: int = 50, params=None):
    """Simple single-device training driver: ``steps`` steps over
    ``batches`` (dicts of numpy arrays, moved to the model's device).
    Returns ``(params, history)``; ``history`` holds a dict of floats
    (``loss``, ``ce``, ``aux``, ``lr``, ``grad_norm``, ``step``,
    ``elapsed_s``) every ``log_every`` steps and at the last."""
    opt_cfg = opt_cfg or OptimizerConfig(total_steps=steps)
    if params is None:
        params = model.init(seed)
    opt_state = init_adamw(params)
    step_fn = make_train_step(model, opt_cfg)
    history = []
    t0 = time.perf_counter()
    for i, batch in zip(range(steps), batches):
        batch = {k: torch.as_tensor(v).to(model.device)
                 for k, v in batch.items()}
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if i % log_every == 0 or i == steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = i
            m["elapsed_s"] = time.perf_counter() - t0
            history.append(m)
    return params, history
