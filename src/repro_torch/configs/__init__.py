"""Architecture registry of the port.

The port serves the attention+MoE family, with three configs of that
family the JAX package serves (``qwen2-moe-a2.7b``, the paper's
``deepseek-v3`` and ``kimi-k2-1t-a32b``: GQA, first-k dense, 384 + 32
experts; one of its MoE layers is ~34 GB in bf16, so it serves on the
CPU, at smoke size, only), and the attention-free Mamba family
(``falcon-mamba-7b``).  ``get_config(name)`` returns the full-size config,
``get_smoke_config`` the reduced same-family variant the CPU tests use.
"""
from __future__ import annotations

from repro_torch.configs.base import (
    MambaConfig,
    MLAConfig,
    MoEConfig,
    ModelConfig,
    reduced,
)
from repro_torch.configs.deepseek_v3 import CONFIG as _deepseek
from repro_torch.configs.falcon_mamba_7b import CONFIG as _falcon_mamba
from repro_torch.configs.kimi_k2_1t_a32b import CONFIG as _kimi
from repro_torch.configs.qwen2_moe_a2_7b import CONFIG as _qwen_moe

_REGISTRY = {c.name: c for c in (_qwen_moe, _deepseek, _kimi,
                                        _falcon_mamba)}

ALL_ARCHS = tuple(_REGISTRY)


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    cfg = _REGISTRY[name]
    cfg.validate()
    return cfg


def get_smoke_config(name: str) -> ModelConfig:
    return reduced(get_config(name))


__all__ = [
    "ALL_ARCHS",
    "MambaConfig",
    "MLAConfig",
    "MoEConfig",
    "ModelConfig",
    "get_config",
    "get_smoke_config",
    "reduced",
]
