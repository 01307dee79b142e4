"""Shape-and-dtype stand-ins for every step input (no allocation).

The twin of ``repro.launch.specs``: :func:`sds` is a ``meta`` tensor, a
shape and a dtype without storage, where the JAX package has
``jax.ShapeDtypeStruct``.  ``step_arg_specs(model, cfg, shape)`` returns
the arguments of the step that ``make_step(model, kind)`` returns, for
the input shape's kind.  Modality frontends are stubs, as there: the
audio family takes precomputed frame embeddings, the vlm family
precomputed patch embeddings.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.models.model import MetaFactories, Model
from repro_torch.models.moe import MoERuntime
from repro_torch.training.optimizer import OptimizerConfig, init_adamw


def sds(shape, dtype) -> torch.Tensor:
    """A tensor of ``shape`` and ``dtype`` with no storage (``meta``)."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, shape: InputShape, *, with_loss_mask: bool,
                dtype=torch.bfloat16) -> Dict[str, Any]:
    B, S = shape.global_batch, shape.seq_len
    if cfg.family == "vlm":
        P = cfg.num_patches
        out = {"tokens": sds((B, S - P), torch.int32),
               "patches": sds((B, P, cfg.d_model), dtype)}
        if with_loss_mask:
            out["loss_mask"] = sds((B, S - P), torch.int32)
        return out
    out = {"tokens": sds((B, S), torch.int32)}
    if cfg.family == "audio":
        out["frames"] = sds((B, cfg.encoder_seq, cfg.d_model), dtype)
    if with_loss_mask:
        out["loss_mask"] = sds((B, S), torch.int32)
    return out


def decode_specs(model: Model, shape: InputShape) -> Tuple:
    """(cache_specs, token_specs) for a decode step over a seq_len-deep
    ring cache, the cache's shapes from :meth:`Model.init_cache` under
    the meta factories (nothing allocated)."""
    B, S = shape.global_batch, shape.seq_len
    with MetaFactories():
        cache = model.init_cache(B, S, device="cpu")
    tokens = sds((B,), torch.int32)
    return cache, tokens


def runtime_specs(model: Model) -> Optional[MoERuntime]:
    if model.cfg.moe is None:
        return None
    with MetaFactories():
        rt = model.default_runtime()
    return MoERuntime(*(sds(t.shape, t.dtype) for t in rt))


def make_step(model: Model, kind: str,
              opt_cfg: Optional[OptimizerConfig] = None) -> Callable:
    """The step of ``kind``: ``train`` is ``training.train_loop``'s step
    (``(params, opt_state, batch) -> (params, opt_state, metrics)``, the
    port's AdamW state; a tensor-parallel model's on the rank's shards),
    ``prefill`` the ring prefill and ``decode`` one ring decode step, each
    followed by the greedy next token (:func:`greedy`)."""
    if kind == "train":
        from repro_torch.training.train_loop import make_train_step
        return make_train_step(model, opt_cfg or OptimizerConfig())
    if kind == "prefill":
        def prefill_step(params, batch, runtime):
            last, cache = model.prefill(params, batch, runtime)
            return greedy(model, last), cache
        return prefill_step
    if kind == "decode":
        def serve_step(params, cache, tokens, runtime):
            logits, cache = model.decode_step(params, cache, tokens, runtime)
            return greedy(model, logits), cache
        return serve_step
    raise ValueError(kind)


def greedy(model: Model, logits) -> torch.Tensor:
    """The greedy token of each row, ``argmax`` over the padded vocabulary
    (the JAX package's ``jnp.argmax(last, -1)``), int32; under tensor
    parallelism the logits are the rank's columns and
    ``TensorParallel.greedy`` picks the same token."""
    if model.tp is not None:
        return model.tp.greedy(logits)
    return logits.argmax(dim=-1).to(torch.int32)


def step_arg_specs(model: Model, cfg: ModelConfig, shape: InputShape,
                   dtype=torch.bfloat16) -> Tuple:
    """Argument specs (meta tensors) matching ``make_step``'s signature."""
    params = model.param_specs()
    if shape.kind == "train":
        opt = init_adamw(params)
        batch = batch_specs(cfg, shape, with_loss_mask=True, dtype=dtype)
        return (params, opt, batch)
    if shape.kind == "prefill":
        batch = batch_specs(cfg, shape, with_loss_mask=False, dtype=dtype)
        return (params, batch, runtime_specs(model))
    cache, tokens = decode_specs(model, shape)
    return (params, cache, tokens, runtime_specs(model))
