"""Shared cases and numpy input generators of the kernel tests (CPU
parity against JAX in test_torch_kernels.py, kernel against plain version
on the card in test_torch_cuda.py).  Imports neither JAX nor a card."""
import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one thread for a module's tests (a module imports this
    fixture to use it): the suite runs 6 workers on a few cores, and an
    8-thread pool under that load made a smoke ``index_add_`` thousands
    of times slower than one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
    # MLA's latent layout (one KV head, many query heads, Dh > 256: the
    # wide kernel at 2 and 3 chunks a lane)
    (3, 16, 1, 288, 8, 4, False, True),
    (2, 12, 1, 576, 16, 3, True, False),
    # rows over several of the latent layout's 256-position splits
    (2, 64, 1, 576, 16, 40, True, False),
    # internlm2-20b's GQA: 6 query heads a KV head at Dh 128 (two head
    # groups a split on the card), windowed, an idle row
    (4, 48, 8, 128, 16, 4, True, True),
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


MEGASTEP_CASES = {
    # id: overrides of megastep_inputs (tests/test_decode_megakernel.py:69)
    "plain": dict(),
    "shared": dict(Fs=40),
    "lost": dict(lost=3),
    "masked": dict(masked=4),
    "windowed": dict(window=True),
    "ep_offset": dict(E=3, offset=2, E_log=6),
    "mla_shaped": dict(Hkv=1, Dh=24, H=6),
    # the latent layout: one pool serves as K and V, Dh past 256
    "mla_latent": dict(Hkv=1, Dh=288, H=8, same_pool=True, Fs=40),
    # deepseek-v3's latent width under 64 heads: in bf16 on the card the
    # attention stage is the tensor-core latent kernel
    "mla_latent_tc": dict(Hkv=1, Dh=576, H=64, same_pool=True, Fs=40),
    # the route stage over many warps: 64 logical experts (two a lane),
    # top-8 over 16 rows, cap 2 (copies drop), one lost, one masked
    "route_wide": dict(B=16, E_log=64, E=66, K=8, cap=2, lost=3, masked=4),
}
# the D=7168 deploy shape (tests/test_decode_megakernel.py:116)
DEPLOY = dict(B=2, H=2, Hkv=1, Dh=16, bs=4, nb=6, max_blk=2, D=7168,
              E_log=4, E=4, K=2, F=64, Fs=64, cap=4)


def megastep_inputs(*, B=3, H=4, Hkv=2, Dh=16, bs=4, nb=10, max_blk=3,
                    D=32, E_log=5, E=7, K=2, F=48, Fs=0, cap=5, seed=0,
                    lost=None, masked=None, window=False, offset=0,
                    same_pool=False):
    """The operands of ``decode_megastep`` in the reference's order, as
    numpy arrays (None for absent shared experts, an int offset), and its
    keyword arguments.  Two replicas for the first two logical experts;
    ``lost`` drops every replica of one expert, ``masked`` masks one;
    seq_lens include 0 (an idle row); ``same_pool``: V is K's array, as
    MLA's latent pool."""
    rng = np.random.default_rng(seed)

    def normal(shape, scale):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    q = normal((B, H, Dh), 0.3)
    k_pool = normal((nb, bs, Hkv, Dh), 0.3)
    v_pool = k_pool if same_pool else normal((nb, bs, Hkv, Dh), 0.3)
    bt = rng.integers(0, nb, size=(B, max_blk)).astype(np.int32)
    sl = rng.integers(0, max_blk * bs + 1, size=B).astype(np.int32)
    sl[min(1, B - 1)] = 0
    st = (np.maximum(sl - 6, 0) if window else np.zeros(B)).astype(np.int32)
    x = normal((B, D), 0.2)
    w_post = normal((H * Dh, D), 0.1)
    ln2 = np.full(D, 1.1, np.float32)
    router = normal((D, E_log), 0.2)
    ar = np.arange(E_log)
    l2p = np.stack([ar, np.where(ar < 2, E_log + ar, 0)], 1).astype(np.int32)
    rcnt = np.where(ar < 2, 2, 1).astype(np.int32)
    mask = np.ones(E_log, bool)
    if lost is not None:
        rcnt[lost] = 0
    if masked is not None:
        mask[masked] = False
    g, u, d = normal((E, D, F), 0.05), normal((E, D, F), 0.05), \
        normal((E, F, D), 0.05)
    if Fs:
        sg, su, sd = normal((D, Fs), 0.05), normal((D, Fs), 0.05), \
            normal((Fs, D), 0.05)
    else:
        sg = su = sd = None
    args = [q, k_pool, v_pool, bt, sl, st, x, w_post, ln2, router, l2p,
            rcnt, mask, g, u, d, offset, sg, su, sd]
    return args, dict(top_k=K, cap=cap, e_local=E)


ROUTER_CASES = {
    # id: (T, E, k, masked columns, tied rows)
    "e60": (40, 60, 4, (), False),
    "ragged_t": (300, 60, 4, (), False),   # T not a multiple of block_t
    "masked": (37, 60, 4, (3, 17, 59), False),
    "tie": (12, 60, 4, (5,), True),
}


def router_inputs(T, E, k, masked, tie, seed=0):
    """Well-separated logits (each row a permutation of 0.25-spaced
    values); with ``tie``, row 0 is all equal and row 1 has three equal
    maxima, so the lowest index must win."""
    rng = np.random.default_rng(seed)
    logits = np.stack([rng.permutation(E) for _ in range(T)]) * 0.25 - 5.0
    logits = logits.astype(np.float32)
    if tie:
        logits[0] = 1.0
        logits[1, [9, 4, 30]] = logits[1].max() + 1.0
    mask = np.ones(E, bool)
    mask[list(masked)] = False
    return logits, mask


EXPERT_FFN_GRID = [
    # E, C, D, F  (tests/test_kernels.py:38, plus ragged C and F tiles)
    (2, 64, 128, 256),
    (3, 100, 256, 384),
    (8, 128, 512, 128),
    (5, 3, 96, 200),
]


def expert_ffn_inputs(E, C, D, F, seed=0):
    rng = np.random.default_rng(seed)
    return ((rng.normal(size=(E, C, D)) * 0.1).astype(np.float32),
            (rng.normal(size=(E, D, F)) * 0.05).astype(np.float32),
            (rng.normal(size=(E, D, F)) * 0.05).astype(np.float32),
            (rng.normal(size=(E, F, D)) * 0.05).astype(np.float32))


FLASH_CASES = {
    # name: (B, S, H, Hkv, Dh, causal, window, kv position shift)
    "mha": (1, 128, 4, 4, 64, True, 0, 0),        # tests/test_kernels.py:222
    "gqa": (2, 128, 8, 2, 64, True, 0, 0),
    "wide": (1, 256, 16, 8, 128, True, 0, 0),
    "not_causal": (2, 128, 8, 2, 64, False, 0, 0),
    "bucket_200": (1, 200, 16, 16, 128, True, 0, 0),   # S not a tile multiple
    "window6": (1, 64, 16, 16, 128, True, 6, 0),
    "dh96_g16": (1, 40, 32, 2, 96, True, 9, 0),
    "dh256": (1, 48, 4, 1, 256, True, 0, 0),
    "no_key_rows": (1, 24, 4, 2, 32, True, 0, 5),  # first rows see nothing
}


def flash_inputs(B, S, H, Hkv, Dh, shift, seed=0, Dv=None):
    """q, k (QK width Dh), v (width ``Dv``, default Dh) and positions."""
    rng = np.random.default_rng(seed)
    pos = np.arange(S, dtype=np.int32)
    return (rng.normal(size=(B, S, H, Dh)).astype(np.float32),
            rng.normal(size=(B, S, Hkv, Dh)).astype(np.float32),
            rng.normal(size=(B, S, Hkv, Dv or Dh)).astype(np.float32),
            pos, pos + np.int32(shift))


# MLA's whole-prompt attention: QK width dn + dr, V width dv, G = 1
FLASH_DV_CASES = {
    # name: (B, S, H, Hkv, Dq, Dv, causal, window)
    "smoke": (1, 24, 4, 4, 48, 32, True, 0),           # deepseek-v3 smoke
    "deepseek": (1, 80, 8, 8, 192, 128, True, 0),      # its full widths
    "deepseek_window": (2, 72, 4, 4, 192, 128, True, 9),
    "not_causal": (1, 40, 6, 2, 192, 128, False, 0),
}


SSM_CASES = {
    # id: (B, S, d, N, block_d, chunk, with h0)   (tests/test_kernels.py:74)
    "s64_d256": (1, 64, 256, 16, 256, 32, False),
    "s128_d512": (2, 128, 512, 16, 128, 64, False),
    "s96_n8": (2, 96, 256, 8, 256, 32, False),
    "h0": (3, 40, 328, 16, 8, 8, True),    # d not a multiple of a CTA's 16
}


def ssm_inputs(B, S, d, N, with_h0, seed=0):
    """u, dt, A, B, C (and h0 or None) as tests/test_kernels.py draws them:
    dt = softplus(z - 2), A = -exp(0.3 z)."""
    rng = np.random.default_rng(seed + S * d)
    u = (rng.normal(size=(B, S, d)) * 0.1).astype(np.float32)
    dt = np.logaddexp(rng.normal(size=(B, S, d)) - 2, 0).astype(np.float32)
    A = -np.exp(rng.normal(size=(d, N)) * 0.3).astype(np.float32)
    Bs = (rng.normal(size=(B, S, N)) * 0.2).astype(np.float32)
    Cs = (rng.normal(size=(B, S, N)) * 0.2).astype(np.float32)
    h0 = ((rng.normal(size=(B, d, N)) * 0.5).astype(np.float32)
          if with_h0 else None)
    return u, dt, A, Bs, Cs, h0
