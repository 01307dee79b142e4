"""Training loop: a train-step factory and a simple driver.

Mirrors ``repro.training.train_loop``.  Where JAX takes
``jax.value_and_grad`` of the loss, the port runs the forward under grad
with every parameter a leaf that requires grad, and ``torch.autograd.grad``
collects the gradients: on the card the attention and expert FFN of that
forward go through the ``flash_prefill`` and ``expert_ffn`` kernels and
their backward kernels (``ops``' autograd Functions).  The update runs
under ``no_grad`` (:func:`~repro_torch.training.optimizer.adamw_update`).
PyTorch runs eagerly: there is no ``jit``.
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


def make_train_step(model: Model, opt_cfg: OptimizerConfig,
                    runtime=None, *, gather: Optional[Callable] = None,
                    reduce_grads: Optional[Callable] = None) -> Callable:
    """Returns ``train_step(params, opt_state, batch) -> (params,
    opt_state, metrics)``; ``batch`` holds tensors on the model's device.

    The MoE runtime is threaded through so a degraded system (masked
    experts after a recovery) can keep serving-consistent fine-tuning, as
    in ``repro``.  ``gather`` / ``reduce_grads`` (both None on one rank)
    serve a rank that stores its leaves split (``launch.dryrun``):
    ``gather`` makes the leaves the forward takes from the rank's, and
    ``reduce_grads`` takes their gradients back to the rank's leaves,
    which AdamW then updates."""

    def train_step(params, opt_state, batch):
        leaves_in = as_leaves(params if gather is None else gather(params))
        with torch.enable_grad():
            loss, metrics = model.loss(leaves_in, batch, runtime)
        keys, leaves = zip(*flatten(leaves_in))
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        # a leaf the loss does not reach gets zeros, as under JAX
        grads = unflatten((k, torch.zeros_like(p) if g is None else g)
                          for k, p, g in zip(keys, leaves, grads))
        if reduce_grads is not None:
            grads = reduce_grads(grads)
        else:
            params = leaves_in
        params, opt_state, opt_metrics = adamw_update(
            opt_cfg, grads, opt_state, params)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(opt_metrics)
        metrics["loss"] = loss.detach()
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
