"""Architecture registry of the port.

The port serves the attention+MoE family, with three configs of that
family the JAX package serves (``qwen2-moe-a2.7b``, the paper's
``deepseek-v3`` and ``kimi-k2-1t-a32b``: GQA, first-k dense, 384 + 32
experts; one of its MoE layers is ~34 GB in bf16, so it serves on the
CPU, at smoke size, only), the attention-free Mamba family
(``falcon-mamba-7b``) and the dense family (``internlm2-20b``: GQA;
``minicpm3-4b``: MLA; ``mistral-large-123b`` and ``nemotron-4-340b``,
whose full depth does not fit one card).  The registry holds every
config of the JAX package's: the hybrid (``jamba-1.5-large-398b``), VLM
(``internvl2-26b``) and audio (``seamless-m4t-large-v2``) configs resolve,
and ``Model`` raises for them, naming their ROADMAP item.
``get_config(name, shape)`` returns the full-size config, adapted to an
input shape as the JAX package's is; ``get_smoke_config`` the reduced
same-family variant the CPU tests use.
"""
from __future__ import annotations

from repro_torch.configs.base import (
    INPUT_SHAPES,
    LONG_CONTEXT_WINDOW,
    InputShape,
    MambaConfig,
    MLAConfig,
    MoEConfig,
    ModelConfig,
    reduced,
)
from repro_torch.configs.deepseek_v3 import CONFIG as _deepseek
from repro_torch.configs.falcon_mamba_7b import CONFIG as _falcon_mamba
from repro_torch.configs.internlm2_20b import CONFIG as _internlm
from repro_torch.configs.internvl2_26b import CONFIG as _internvl
from repro_torch.configs.jamba_1_5_large_398b import CONFIG as _jamba
from repro_torch.configs.kimi_k2_1t_a32b import CONFIG as _kimi
from repro_torch.configs.minicpm3_4b import CONFIG as _minicpm3
from repro_torch.configs.mistral_large_123b import CONFIG as _mistral
from repro_torch.configs.nemotron_4_340b import CONFIG as _nemotron
from repro_torch.configs.qwen2_moe_a2_7b import CONFIG as _qwen_moe
from repro_torch.configs.seamless_m4t_large_v2 import CONFIG as _seamless

_REGISTRY = {c.name: c for c in (_qwen_moe, _deepseek, _kimi,
                                        _falcon_mamba, _internlm, _minicpm3,
                                        _mistral, _nemotron, _jamba,
                                        _internvl, _seamless)}

ALL_ARCHS = tuple(_REGISTRY)


def get_config(name: str, shape: str | None = None) -> ModelConfig:
    """The registered config, adapted to an input shape if given: for
    ``long_500k`` a full-attention architecture gets a sliding window of
    ``LONG_CONTEXT_WINDOW`` (as ``repro.configs.get_config``); the
    sub-quadratic families are returned unchanged."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    cfg = _REGISTRY[name]
    cfg.validate()
    if shape == "long_500k" and not cfg.supports_long_context_natively:
        cfg = cfg.with_sliding_window(LONG_CONTEXT_WINDOW)
    if shape == "long_500k" and cfg.hybrid_period:
        cfg = cfg.with_sliding_window(LONG_CONTEXT_WINDOW)
    return cfg


def get_smoke_config(name: str) -> ModelConfig:
    return reduced(get_config(name))


__all__ = [
    "ALL_ARCHS",
    "INPUT_SHAPES",
    "LONG_CONTEXT_WINDOW",
    "InputShape",
    "MambaConfig",
    "MLAConfig",
    "MoEConfig",
    "ModelConfig",
    "get_config",
    "get_smoke_config",
    "reduced",
]
