"""Router top-k: the plain PyTorch version and the launcher of the CUDA
kernel (``csrc/router_topk.cu``; the row function in
``csrc/router_topk.cuh`` is also the megastep's route stage).

Both compute ``repro.kernels.ref.router_topk_ref``: mask the (T, E)
logits with the §3.4 expert mask, softmax, take the k largest
probabilities (the lowest index first among equal ones) and renormalise
them.  The plain version masks with -inf, as the reference does; the
kernel masks with -1e30, as ``router_topk_pallas`` does, so a row with
every expert masked gives weights 0 instead of NaN.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, launches

_VP, _CI = ctypes.c_void_p, ctypes.c_int
_PROTOTYPES = {
    "router_topk": ([_VP] * 4 + [_CI] * 3 + [_VP], _CI),
    "router_topk_smem_bytes": ([_CI], ctypes.c_longlong),
}


def router_topk_plain(logits, expert_mask, k: int):
    """logits (T, E); expert_mask (E,) bool.  Returns (weights (T, k) f32
    renormalised, indices (T, k) int32)."""
    masked = logits.float().masked_fill(~expert_mask[None, :], float("-inf"))
    gates = torch.softmax(masked, dim=-1)
    w, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    w, idx = w[:, :k], idx[:, :k]
    w = w / w.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    return w, idx.to(torch.int32)


def router_topk_cuda(logits, expert_mask, k: int):
    """Launch the CUDA kernel on PyTorch's current stream.  Raises on any
    input the kernel does not take; never falls back."""
    build.refuse_grad("router_topk_cuda", logits)
    if logits.device.type != "cuda":
        raise ValueError(f"router_topk_cuda needs CUDA tensors, got "
                         f"{logits.device}")
    T, E = logits.shape
    if not 0 < k <= E:
        raise ValueError(f"router_topk: k={k} of {E} experts")
    dev = logits.device
    build.check_arg("logits", logits, torch.float32, (T, E), dev)
    build.check_arg("expert_mask", expert_mask, torch.bool, (E,), dev)
    lib = build.load("router_topk", _PROTOTYPES)
    if lib.router_topk_smem_bytes(E) > build.MAX_SMEM_BYTES:
        raise ValueError(f"router_topk: {E} experts exceed shared memory")
    w = torch.empty((T, k), dtype=torch.float32, device=dev)
    idx = torch.empty((T, k), dtype=torch.int32, device=dev)
    if T == 0:
        return w, idx
    err = lib.router_topk(logits.data_ptr(), expert_mask.data_ptr(),
                          w.data_ptr(), idx.data_ptr(), T, E, k,
                          torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"router_topk launch failed: cudaError {err}")
    launches["router_topk"] += 1
    return w, idx
