"""Data-sheet figures of the H100 SXM the port runs on, and the card in use.

One copy of the peaks that ``chip_smoke.py`` holds a kernel's time
against and the dry run's roofline divides by
(``launch.dryrun``).  Figures are NVIDIA's data-sheet numbers for dense
math (no sparsity), per GPU, as ``card_sheet()``'s keys (the module's
constants in capitals):

* ``bf16_flops`` / ``f32_flops``: peak tensor-core bf16 and plain FP32
  operations a second;
* ``hbm_bytes_per_s``: device memory bandwidth;
* ``nvlink_bytes_per_s``: NVLink bandwidth one way (half the data
  sheet's bidirectional figure), between the GPUs of one node;
* ``network_bytes_per_s``: one 400 Gb/s NDR InfiniBand port per GPU one
  way (the DGX/HGX H100 layout: 8 ConnectX-7 ports a node of 8), between
  nodes.
"""
from __future__ import annotations

import shutil
import subprocess
from typing import Dict, Optional, Tuple

NODE_RANKS = 8          # GPUs a node: an NVLink domain (DGX/HGX H100)

SHEET = "H100 SXM5"
BF16_FLOPS, F32_FLOPS = 989e12, 67e12
HBM_BYTES_PER_S = 3.35e12
NVLINK_BYTES_PER_S = 900e9 / 2
NETWORK_BYTES_PER_S = 400e9 / 8

# the peaks by the dtype of a kernel's arithmetic
PEAK_FLOPS = {"float32": F32_FLOPS, "bfloat16": BF16_FLOPS}


def query_card() -> Optional[Tuple[str, str]]:
    """(name, power limit) of GPU 0 as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` gives them; None without
    ``nvidia-smi`` or a card."""
    if shutil.which("nvidia-smi") is None:
        return None
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    if out.returncode != 0 or not lines:
        return None
    name, _, limit = lines[0].partition(",")
    return name.strip(), limit.strip()


def card_sheet() -> Dict:
    """The H100 SXM figures under the module docstring's names, with the
    ``name`` and ``power_limit`` of the card ``nvidia-smi`` reads (both
    None without one)."""
    name, limit = query_card() or (None, None)
    return dict(sheet=SHEET, bf16_flops=BF16_FLOPS, f32_flops=F32_FLOPS,
                hbm_bytes_per_s=HBM_BYTES_PER_S,
                nvlink_bytes_per_s=NVLINK_BYTES_PER_S,
                network_bytes_per_s=NETWORK_BYTES_PER_S, name=name,
                power_limit=limit)
