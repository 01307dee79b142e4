"""Dense feed-forward: the SwiGLU the shared experts run (and squared
ReLU, for parity with ``repro.models.ffn``)."""
from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init


def ffn_init(gen: torch.Generator, d_model: int, d_ff: int, activation: str,
             dtype: torch.dtype, lead: Sequence[int] = ()
             ) -> Dict[str, torch.Tensor]:
    if activation == "swiglu":
        return {
            "w_gate": dense_init(gen, d_model, d_ff, dtype, lead),
            "w_up": dense_init(gen, d_model, d_ff, dtype, lead),
            "w_down": dense_init(gen, d_ff, d_model, dtype, lead),
        }
    if activation == "relu2":
        return {
            "w_up": dense_init(gen, d_model, d_ff, dtype, lead),
            "w_down": dense_init(gen, d_ff, d_model, dtype, lead),
        }
    raise ValueError(activation)


def ffn_apply(p, x: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "swiglu":
        return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
    if activation == "relu2":
        return torch.square(F.relu(x @ p["w_up"])) @ p["w_down"]
    raise ValueError(activation)
