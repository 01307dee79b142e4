"""Device selection for the port's entry points.

Entry points (``Model``, ``InferenceEngine``, ``ExpertMap``) run on the
card unless the caller asks for the CPU.  Without a card and without an
explicit ``"cpu"`` they raise: nothing falls back silently.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain PyTorch path")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"no CUDA device is available for {dev}; pass device='cpu' to "
            f"run the plain PyTorch path")
    return dev
