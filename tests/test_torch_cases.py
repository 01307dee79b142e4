"""Shared cases and numpy input generators of the kernel tests (CPU
parity against JAX in test_torch_kernels.py, kernel against plain version
on the card in test_torch_cuda.py).  Imports neither JAX nor a card."""
import numpy as np
import torch


def t(a):
    return torch.from_numpy(np.array(a))


PAGED_CASES = [
    # B, H, Hkv, Dh, bs, mb, window, idle_row  (tests/test_kernels.py:55)
    (2, 4, 4, 64, 16, 3, False, False),      # MHA
    (3, 8, 2, 64, 16, 4, False, False),      # GQA
    (1, 16, 8, 128, 32, 2, False, False),
    (4, 8, 2, 64, 16, 4, True, False),       # sliding window
    (3, 8, 2, 64, 16, 4, False, True),       # an idle (seq_len 0) row
    (3, 6, 3, 96, 8, 5, True, True),         # Dh not a power of two
]


def paged_inputs(B, H, Hkv, Dh, bs, mb, window, idle_row, seed=0):
    rng = np.random.default_rng(seed)
    nb = mb * B + 2
    q = rng.normal(size=(B, H, Dh)).astype(np.float32)
    kp = rng.normal(size=(nb, bs, Hkv, Dh)).astype(np.float32)
    vp = rng.normal(size=(nb, bs, Hkv, Dh)).astype(np.float32)
    bt = rng.integers(0, nb, size=(B, mb)).astype(np.int32)
    sl = rng.integers(1, mb * bs + 1, size=(B,)).astype(np.int32)
    if idle_row:
        sl[1] = 0
    st = np.maximum(sl - 7, 0).astype(np.int32) if window else None
    return q, kp, vp, bt, sl, st


MOE_FUSED_GRID = [
    # T, k, e_phys, e_local, off, D, F, cap   (tests/test_kernels.py:97)
    (32, 2, 4, 4, 0, 128, 256, 12),     # aligned, all experts local
    (19, 3, 6, 3, 3, 96, 144, 4),       # odd shapes, offset slice, overflow
    (8, 2, 4, 2, 2, 64, 40, 8),         # tiny F
    (100, 2, 8, 8, 0, 128, 128, 16),    # capacity overflow on hot experts
]


def moe_inputs(T, k, e_phys, e_local, D, F, seed=0, alive_p=0.85):
    rng = np.random.default_rng(seed + T * e_phys + k * D)
    x = (rng.normal(size=(T, D)) * 0.1).astype(np.float32)
    g = (rng.normal(size=(e_local, D, F)) * 0.05).astype(np.float32)
    u = (rng.normal(size=(e_local, D, F)) * 0.05).astype(np.float32)
    d = (rng.normal(size=(e_local, F, D)) * 0.05).astype(np.float32)
    phys = rng.integers(0, e_phys, size=(T, k)).astype(np.int32)
    z = rng.normal(size=(T, k))
    w = (np.exp(z) / np.exp(z).sum(-1, keepdims=True)).astype(np.float32)
    alive = rng.random(size=(T, k)) < alive_p
    return x, g, u, d, phys, w, alive
