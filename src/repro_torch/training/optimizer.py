"""AdamW with a cosine schedule and linear warmup, over the parameter dict.

Mirrors ``repro.training.optimizer``: functional (each update returns new
parameter, moment and step tensors and changes none of its inputs), in
the same order of operations, so f32 runs agree with the JAX package:
clip the gradients by their global norm, then the bias-corrected
moments, then decoupled weight decay on every leaf.  ``m`` and ``v``
take each parameter's type, as ``zeros_like`` gives them there.  Leaves
pair up by their sorted key paths (``checkpoint.flatten``), the order
``jax.tree_util`` flattens a dict in.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, NamedTuple

import torch

from repro_torch.training.checkpoint import flatten, unflatten


@dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    betas: tuple = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 1000
    min_lr_ratio: float = 0.1
    grad_clip: float = 1.0


class AdamWState(NamedTuple):
    step: torch.Tensor      # () int32: updates taken so far
    m: Any
    v: Any


def tree_map(fn, *trees):
    """``fn`` over the leaves of equally nested dicts, keys in order."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def leaves(tree):
    """The leaves of a nested dict, in ``jax.tree_util``'s order."""
    return [leaf for _, leaf in flatten(tree)]


def init_adamw(params) -> AdamWState:
    zeros = lambda p: torch.zeros_like(p, requires_grad=False)  # noqa: E731
    step = torch.zeros((), dtype=torch.int32,
                       device=leaves(params)[0].device)
    return AdamWState(step, tree_map(zeros, params), tree_map(zeros, params))


def schedule(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a tensor), in f32."""
    step = step.float()
    warm = torch.clamp((step + 1) / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in f32, summed leaf by
    leaf in key order."""
    total = None
    for x in leaves(tree):
        sq = torch.sum(torch.square(x.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(cfg: OptimizerConfig, grads, state: AdamWState, params):
    """Returns ``(new_params, new_state, metrics)``; ``metrics`` holds the
    step's ``lr`` and the gradients' ``grad_norm`` before clipping, as
    0-d f32 tensors."""
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    b1, b2 = cfg.betas
    lr = schedule(cfg, state.step)
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()

    def upd(g, m, v, p):
        g = g * clip.to(g.dtype)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * torch.square(g)
        mh = m / bc1.to(m.dtype)
        vh = v / bc2.to(v.dtype)
        step_ = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p
        return (p - lr.to(p.dtype) * step_).to(p.dtype), m, v

    keys, out = [], []
    for (key, p), g, m, v in zip(flatten(params), leaves(grads),
                                 leaves(state.m), leaves(state.v)):
        keys.append(key)
        out.append(upd(g, m, v, p))
    new_p, new_m, new_v = (unflatten(zip(keys, col)) for col in zip(*out))
    return new_p, AdamWState(step, new_m, new_v), {"lr": lr,
                                                    "grad_norm": gnorm}
