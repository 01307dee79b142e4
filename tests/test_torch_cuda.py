"""Each CUDA kernel against its plain PyTorch version, on the card.

Marked ``cuda``: without a GPU every test skips.  On the card (no JAX
there) run ``python -m pytest -m cuda tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import launches
from repro_torch.kernels.decode_megastep import (decode_megastep_cuda,
                                                 decode_megastep_plain)
from repro_torch.kernels.expert_ffn import expert_ffn_cuda, expert_ffn_plain
from repro_torch.kernels.flash_prefill import (flash_prefill_cuda,
                                               flash_prefill_plain)
from repro_torch.kernels.moe_fused import (moe_fused_cuda, moe_fused_plain,
                                           moe_group_tokens)
from repro_torch.kernels.paged_attention import (paged_attention_cuda,
                                                 paged_attention_plain)
from repro_torch.kernels.router_topk import (router_topk_cuda,
                                             router_topk_plain)
from repro_torch.kernels.ssm_scan import ssm_scan_cuda, ssm_scan_plain
from repro_torch.models.moe import MoERuntime, select_replicas
from test_torch_cases import (DEPLOY, EXPERT_FFN_GRID, FLASH_CASES,
                              MEGASTEP_CASES, MOE_FUSED_GRID, PAGED_CASES,
                              ROUTER_CASES, SSM_CASES, expert_ffn_inputs,
                              flash_inputs, megastep_inputs, moe_inputs,
                              paged_inputs, router_inputs, ssm_inputs,
                              t as _t)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", PAGED_CASES)
def test_paged_attention_cuda_vs_plain(card, case, dtype):
    args = [None if a is None else _t(a).to(card)
            for a in paged_inputs(*case)]
    for i in range(3):
        args[i] = args[i].to(dtype)
    n0 = launches["paged_attention"]
    got = paged_attention_cuda(*args)
    again = paged_attention_cuda(*args)
    torch.cuda.synchronize()
    assert launches["paged_attention"] == n0 + 2
    want = paged_attention_plain(*args)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=tol,
                               atol=tol)
    assert torch.equal(got, again)       # bitwise run to run


# the split layout's edges (splits of 64 positions): the engine's full
# context (512 positions) at B = 8 and 40, one long row over 64 splits, a
# window that starts mid-split (200 = 3 * 64 + 8), one that leaves the
# first splits empty, and GQA over long windowed rows with an idle one
PAGED_SPLIT_CASES = {
    # id: (B, H, Hkv, Dh, bs, max_blk, seq_lens or None, window)
    "full_context_b8": (8, 16, 16, 128, 16, 32, None, 0),
    "full_context_b40": (40, 16, 16, 128, 16, 32, None, 0),
    "long_row": (1, 16, 16, 128, 16, 256, [4090], 0),
    "window_mid_split": (2, 16, 16, 128, 16, 32, [300, 290], 100),
    "window_empty_splits": (2, 16, 16, 128, 16, 32, [500, 451], 70),
    "gqa_long_window": (3, 8, 2, 64, 16, 64, [1024, 700, 0], 300),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(PAGED_SPLIT_CASES))
def test_paged_attention_cuda_split_edges(card, case, dtype):
    B, H, Hkv, Dh, bs, max_blk, lens, window = PAGED_SPLIT_CASES[case]
    rng = np.random.default_rng(7)
    nb = max_blk + 2
    tables = np.stack([rng.permutation(nb - 1)[:max_blk] for _ in range(B)])
    seq = (rng.integers(1, max_blk * bs + 1, size=B) if lens is None
           else np.asarray(lens))
    start = np.maximum(seq - window, 0) if window else None
    args = [_t(rng.normal(size=(B, H, Dh)).astype(np.float32)),
            _t(rng.normal(size=(nb, bs, Hkv, Dh)).astype(np.float32)),
            _t(rng.normal(size=(nb, bs, Hkv, Dh)).astype(np.float32)),
            _t(tables.astype(np.int32)), _t(seq.astype(np.int32)),
            None if start is None else _t(start.astype(np.int32))]
    args = [None if a is None else a.to(card) for a in args]
    for i in range(3):
        args[i] = args[i].to(dtype)
    got = paged_attention_cuda(*args)
    again = paged_attention_cuda(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, again)       # bitwise run to run
    want = paged_attention_plain(*args)
    # the tolerances of test_paged_attention_cuda_vs_plain
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=tol,
                               atol=tol)
    assert not got[torch.from_numpy(seq == 0)].any()   # idle rows give 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,k,e_phys,e_local,off,D,F,cap", MOE_FUSED_GRID)
def test_moe_fused_cuda_vs_plain(card, T, k, e_phys, e_local, off, D, F,
                                 cap, dtype):
    x, g, u, d, phys, w, alive = (
        _t(a).to(card) for a in moe_inputs(T, k, e_phys, e_local, D, F))
    x, g, u, d = (a.to(dtype) for a in (x, g, u, d))
    kw = dict(cap=cap, expert_offset=off, e_local=e_local)
    n0 = launches["moe_fused"]
    got = moe_fused_cuda(x, g, u, d, w, phys, alive, **kw)
    again = moe_fused_cuda(x, g, u, d, w, phys, alive, **kw)
    torch.cuda.synchronize()
    assert launches["moe_fused"] == n0 + 2
    want = moe_fused_plain(x, g, u, d, w, phys, alive, **kw)
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=tol,
                               atol=tol)
    assert torch.equal(got, again)       # bitwise run to run


MEGASTEP_CARD_CASES = dict(MEGASTEP_CASES, deploy=DEPLOY,
                           deploy_lost_masked=dict(DEPLOY, lost=2, masked=3))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(MEGASTEP_CARD_CASES))
def test_decode_megastep_cuda_vs_plain(card, case, dtype):
    args, kw = megastep_inputs(**MEGASTEP_CARD_CASES[case])
    floats = {0, 1, 2, 6, 7, 8, 9, 13, 14, 15, 17, 18, 19}
    args = [a if a is None or isinstance(a, int) else
            _t(a).to(card, dtype) if i in floats else _t(a).to(card)
            for i, a in enumerate(args)]
    n0 = (launches["decode_megastep"], launches["router_topk"])
    y, h2, route = decode_megastep_cuda(*args, **kw, return_route=True)
    y2, h22 = decode_megastep_cuda(*args, **kw)
    torch.cuda.synchronize()
    assert (launches["decode_megastep"], launches["router_topk"]) == \
        (n0[0] + 2, n0[1] + 2)
    assert torch.equal(y, y2) and torch.equal(h2, h22)   # bitwise
    want_y, want_h2 = decode_megastep_plain(*args, **kw)
    # f32 as tests/test_decode_megakernel.py.  bf16 keeps 8 significant
    # bits and y sums terms as large as its largest entries (~10 at the
    # deploy shape, where an entry near 0 is a difference of such terms),
    # so y's absolute tolerance scales with that magnitude
    tol = 2e-4 if dtype == torch.float32 else 3e-2
    y_scale = 1.0 if dtype == torch.float32 else \
        max(1.0, float(want_y.float().abs().max()))
    for got, want, atol in ((h2, want_h2, tol), (y, want_y, tol * y_scale)):
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   want.float().cpu().numpy(), rtol=tol,
                                   atol=atol)
    # the route stage: the kernel's own routing through the reference
    # replica select and sort pass gives its slot tables exactly
    rt = MoERuntime(args[10], args[11], args[12])
    phys, alive = select_replicas(route["sel"].long(), rt)
    tok_idx, wgt, slot_of = moe_group_tokens(
        phys, alive, route["w"], expert_offset=args[16],
        e_local=kw["e_local"], cap=kw["cap"])
    assert torch.equal(route["tok_idx"], tok_idx)
    assert torch.equal(route["wgt"], wgt)
    assert torch.equal(route["slot_of"], slot_of)


# the main path's widths (qwen2-moe-a2.7b: D=2048, F=1408, 64 experts,
# top-4, cap 8) at a decode step (T=8) and a chunk step (T=40), where the
# bf16 kernel runs on the tensor cores: a hot expert over capacity, a
# foreign half bank (e_local 32 at offset 32), and D and F that are no
# multiple of 8, so the gather stages rows element by element
MOE_MAIN_CASES = {
    # id: (T, e_local, offset, hot tokens, D, F)
    "decode": (8, 64, 0, 0, 2048, 1408),
    "chunk": (40, 64, 0, 0, 2048, 1408),
    "chunk_hot": (40, 64, 0, 12, 2048, 1408),
    "chunk_half_bank": (40, 32, 32, 10, 2048, 1408),
    "chunk_ragged": (40, 64, 0, 6, 2044, 1406),
}


def moe_main_inputs(card, dtype, T, e_local, off, hot, D, F, k=4, E=64,
                    seed=0):
    """Full-width operands on the card; routing from numpy: distinct
    experts per token, ``hot`` tokens pick expert 5 first, ~15% of the
    copies dead."""
    rng = np.random.default_rng(seed + T + hot)
    gen = torch.Generator(device=card).manual_seed(seed + D)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=card)
                * scale).to(dtype)
    phys = np.stack([rng.permutation(E)[:k] for _ in range(T)])
    for t in range(min(hot, T)):
        phys[t][phys[t] == 5] = phys[t, 0]
        phys[t, 0] = 5
    z = rng.normal(size=(T, k))
    w = (np.exp(z) / np.exp(z).sum(-1, keepdims=True)).astype(np.float32)
    alive = rng.random(size=(T, k)) >= 0.15
    return (randn(T, D), randn(e_local, D, F, scale=D ** -0.5),
            randn(e_local, D, F, scale=D ** -0.5),
            randn(e_local, F, D, scale=F ** -0.5), _t(w).to(card),
            _t(phys.astype(np.int32)).to(card), _t(alive).to(card))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(MOE_MAIN_CASES))
def test_moe_fused_cuda_vs_plain_main_shapes(card, case, dtype):
    T, e_local, off, hot, D, F = MOE_MAIN_CASES[case]
    args = moe_main_inputs(card, dtype, T, e_local, off, hot, D, F)
    kw = dict(cap=8, expert_offset=off, e_local=e_local)
    n0 = launches["moe_fused"]
    got = moe_fused_cuda(*args, **kw)
    again = moe_fused_cuda(*args, **kw)
    torch.cuda.synchronize()
    assert launches["moe_fused"] == n0 + 2
    assert torch.equal(got, again)       # bitwise run to run
    _, wgt, slot_of = moe_group_tokens(args[5], args[6], args[4], **kw)
    if case == "chunk_hot":     # every copy local: drops past the dead
        assert int((slot_of < 0).sum()) > int((~args[6]).sum())  # overflow
    assert int((wgt != 0).any(dim=1).sum()) > 0
    want = moe_fused_plain(*args, **kw)
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=tol,
                               atol=tol)


def megastep_main_inputs(card, dtype, B, seed=0, max_len=288):
    """A full-width qwen2-moe-a2.7b block (D=2048, 16 x 128 heads, 60
    routed experts + 4 redundant of F=1408 in a 64-expert bank, Fs=5632
    shared, top-4) on the card, with an idle row, rows of up to
    ``max_len`` positions and two replicas of the first four experts;
    operands in the reference's order."""
    D, H, Hkv, Dh, E_log, E, F, Fs, K = (2048, 16, 16, 128, 60, 64, 1408,
                                         5632, 4)
    bs, nb, max_blk = 16, 257, 32
    rng = np.random.default_rng(seed + B)
    gen = torch.Generator(device=card).manual_seed(seed + B)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=card)
                * scale).to(dtype)
    tables = np.stack([rng.permutation(nb - 1)[:max_blk] for _ in range(B)])
    seq = rng.integers(1, max_len + 1, size=B)
    seq[1] = 0
    ar = np.arange(E_log)
    l2p = np.stack([ar, np.where(ar < 4, E_log + ar, 0)], 1)
    rcnt = np.where(ar < 4, 2, 1)
    args = [randn(B, H, Dh), randn(nb, bs, Hkv, Dh), randn(nb, bs, Hkv, Dh),
            _t(tables.astype(np.int32)).to(card),
            _t(seq.astype(np.int32)).to(card),
            torch.zeros(B, dtype=torch.int32, device=card), randn(B, D),
            randn(H * Dh, D, scale=(H * Dh) ** -0.5),
            (1.0 + 0.1 * randn(D).float()).to(dtype),
            randn(D, E_log, scale=D ** -0.5),
            _t(l2p.astype(np.int32)).to(card),
            _t(rcnt.astype(np.int32)).to(card),
            torch.ones(E_log, dtype=torch.bool, device=card),
            randn(E, D, F, scale=D ** -0.5), randn(E, D, F, scale=D ** -0.5),
            randn(E, F, D, scale=F ** -0.5), 0,
            randn(D, Fs, scale=D ** -0.5), randn(D, Fs, scale=D ** -0.5),
            randn(Fs, D, scale=Fs ** -0.5)]
    return args, dict(top_k=K, cap=8, e_local=E)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B", [8, 40])
def test_decode_megastep_cuda_vs_plain_main_shapes(card, B, dtype):
    check_megastep_main(card, dtype, B)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_megastep_cuda_vs_plain_full_context(card, dtype):
    """B=8 with rows of up to the engine's 512 positions (8 splits)."""
    check_megastep_main(card, dtype, 8, max_len=512)


def check_megastep_main(card, dtype, B, max_len=288):
    args, kw = megastep_main_inputs(card, dtype, B, max_len=max_len)
    y, h2, route = decode_megastep_cuda(*args, **kw, return_route=True)
    y2, h22 = decode_megastep_cuda(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(y, y2) and torch.equal(h2, h22)   # bitwise
    want_y, want_h2 = decode_megastep_plain(*args, **kw)
    # the tolerances of test_decode_megastep_cuda_vs_plain
    tol = 2e-4 if dtype == torch.float32 else 3e-2
    y_scale = 1.0 if dtype == torch.float32 else \
        max(1.0, float(want_y.float().abs().max()))
    for got, want, atol in ((h2, want_h2, tol), (y, want_y, tol * y_scale)):
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   want.float().cpu().numpy(), rtol=tol,
                                   atol=atol)
    rt = MoERuntime(args[10], args[11], args[12])
    phys, alive = select_replicas(route["sel"].long(), rt)
    tables = moe_group_tokens(phys, alive, route["w"], expert_offset=0,
                              e_local=kw["e_local"], cap=kw["cap"])
    for key, want in zip(("tok_idx", "wgt", "slot_of"), tables):
        assert torch.equal(route[key], want)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(ROUTER_CASES))
def test_router_topk_cuda_vs_plain(card, case):
    T, E, k, masked, tie = ROUTER_CASES[case]
    logits, mask = (_t(a).to(card) for a in router_inputs(T, E, k, masked,
                                                          tie))
    n0 = launches["router_topk"]
    w, idx = router_topk_cuda(logits, mask, k)
    w2, idx2 = router_topk_cuda(logits, mask, k)
    torch.cuda.synchronize()
    assert launches["router_topk"] == n0 + 2
    assert torch.equal(w, w2) and torch.equal(idx, idx2)
    want_w, want_idx = router_topk_plain(logits, mask, k)
    assert torch.equal(idx, want_idx)
    np.testing.assert_allclose(w.cpu().numpy(), want_w.cpu().numpy(),
                               rtol=2e-5, atol=0)


@pytest.mark.cuda
def test_router_topk_cuda_fully_masked_row_is_finite(card):
    logits = torch.zeros((2, 60), device=card)
    w, idx = router_topk_cuda(logits, torch.zeros(60, dtype=torch.bool,
                                                  device=card), 4)
    assert idx.tolist() == [[0, 1, 2, 3]] * 2
    assert (w == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
# plus D and F that are no multiple of 8: rows not 16-byte aligned, which
# the bf16 kernel copies element by element
@pytest.mark.parametrize("E,C,D,F", EXPERT_FFN_GRID + [(3, 13, 36, 44)])
def test_expert_ffn_cuda_vs_plain(card, E, C, D, F, dtype):
    x, g, u, d = (_t(a).to(card, dtype)
                  for a in expert_ffn_inputs(E, C, D, F))
    n0 = launches["expert_ffn"]
    got = expert_ffn_cuda(x, g, u, d)
    again = expert_ffn_cuda(x, g, u, d)
    torch.cuda.synchronize()
    assert launches["expert_ffn"] == n0 + 2
    assert torch.equal(got, again)       # bitwise run to run
    want = expert_ffn_plain(x, g, u, d)
    # tests/test_kernels.py:52's tolerances
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=tol,
                               atol=tol)


# the serial path's shapes: qwen2-moe-a2.7b's 64 experts (D=2048, F=1408)
# at the capacity of decode (8) and of the 256- and 512-token buckets (20,
# 40), and at capacities that are no multiple of 8: 37 (five row blocks in
# one warp), 67 (two warp columns) and 150 (two gate/up passes)
FFN_MAIN_C = [8, 20, 40, 37, 67, 150]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", FFN_MAIN_C)
def test_expert_ffn_cuda_vs_plain_main_shapes(card, C, dtype):
    E, D, F = 64, 2048, 1408
    gen = torch.Generator(device=card).manual_seed(C)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=card)
                * scale).to(dtype)
    x = randn(E, C, D)
    g = randn(E, D, F, scale=D ** -0.5)
    u = randn(E, D, F, scale=D ** -0.5)
    d = randn(E, F, D, scale=F ** -0.5)
    n0 = launches["expert_ffn"]
    got = expert_ffn_cuda(x, g, u, d)
    again = expert_ffn_cuda(x, g, u, d)
    torch.cuda.synchronize()
    assert launches["expert_ffn"] == n0 + 2
    assert torch.equal(got, again)       # bitwise run to run
    want = expert_ffn_plain(x, g, u, d)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=tol,
                               atol=tol)


# plus a head dim that is no multiple of 16 (zero-padded to 64 in the bf16
# kernel) with three query heads per KV head and a window, and the serial
# path's prefill buckets at qwen2-moe-a2.7b's widths
FLASH_CARD_CASES = dict(
    FLASH_CASES, dh40_g3=(1, 70, 6, 2, 40, True, 5, 0),
    s256=(1, 256, 16, 16, 128, True, 0, 0),
    s256_window6=(1, 256, 16, 16, 128, True, 6, 0),
    s512=(1, 512, 16, 16, 128, True, 0, 0),
    s512_window6=(1, 512, 16, 16, 128, True, 6, 0))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(FLASH_CARD_CASES))
def test_flash_prefill_cuda_vs_plain(card, case, dtype):
    B, S, H, Hkv, Dh, causal, window, shift = FLASH_CARD_CASES[case]
    q, k, v, qpos, kvpos = flash_inputs(B, S, H, Hkv, Dh, shift)
    q, k, v = (_t(a).to(card, dtype) for a in (q, k, v))
    qpos, kvpos = _t(qpos).to(card), _t(kvpos).to(card)
    kw = dict(causal=causal, window=window)
    n0 = launches["flash_prefill"]
    got = flash_prefill_cuda(q, k, v, qpos, kvpos, **kw)
    again = flash_prefill_cuda(q, k, v, qpos, kvpos, **kw)
    torch.cuda.synchronize()
    assert launches["flash_prefill"] == n0 + 2
    assert torch.equal(got, again)       # bitwise run to run
    want = flash_prefill_plain(q, k, v, qpos, kvpos, **kw)
    # f32: tests/test_kernels.py:237; bf16: q, k, v and out are rounded
    tol = 2e-4 if dtype == torch.float32 else 2e-2
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=tol,
                               atol=tol)
    if shift:
        assert not got[:, :shift].any()  # rows that see no key give 0


# falcon-mamba-7b at full width (d_inner 8192, N 16): a 256-token prefill
# bucket from zero, and the decode step of 8 slots from their state
SSM_CARD_CASES = dict(SSM_CASES, prefill_d8192=(1, 256, 8192, 16, 0, 0, False),
                      decode_d8192=(8, 1, 8192, 16, 0, 0, True),
                      prefill_d8192_s512=(1, 512, 8192, 16, 0, 0, False),
                      prefill_d8192_s2048=(1, 2048, 8192, 16, 0, 0, False))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(SSM_CARD_CASES))
def test_ssm_scan_cuda_vs_plain(card, case, dtype):
    B, S, d, N, _, _, with_h0 = SSM_CARD_CASES[case]
    u, dt, A, Bs, Cs, h0 = ssm_inputs(B, S, d, N, with_h0)
    u, dt, Bs, Cs = (_t(a).to(card, dtype) for a in (u, dt, Bs, Cs))
    A = _t(A).to(card)
    h0 = None if h0 is None else _t(h0).to(card, dtype)   # the slot state
    n0 = launches["ssm_scan"]
    got = ssm_scan_cuda(u, dt, A, Bs, Cs, h0)
    again = ssm_scan_cuda(u, dt, A, Bs, Cs, h0)
    torch.cuda.synchronize()
    assert launches["ssm_scan"] == n0 + 2
    want = ssm_scan_plain(u, dt, A, Bs, Cs, h0)
    # tests/test_kernels.py:89 for both types: both versions cast the bf16
    # inputs to f32 before any product and then compute the same sums
    rtol, atol = 1e-4, 1e-5
    for g, a, w in zip(got, again, want):
        assert g.dtype == torch.float32
        assert torch.equal(g, a)         # bitwise run to run
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                   rtol=rtol, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [c for c, v in SSM_CARD_CASES.items()
                                  if v[-1]])
def test_ssm_scan_cuda_in_place_vs_plain(card, case, dtype):
    """The decode step's in-place mode, the state aliased as h0 and
    h_out: the state bitwise the plain in-place mode's and the default
    mode's h_final cast, in its storage; y the default mode's y cast."""
    B, S, d, N, _, _, _ = SSM_CARD_CASES[case]
    u, dt, A, Bs, Cs, h0 = ssm_inputs(B, S, d, N, True)
    u, dt, Bs, Cs = (_t(a).to(card, dtype) for a in (u, dt, Bs, Cs))
    A = _t(A).to(card)
    h0 = _t(h0).to(card, dtype)
    y_def, h_def = ssm_scan_cuda(u, dt, A, Bs, Cs, h0)
    states, ys = [], []
    for _ in range(2):
        st = h0.clone()
        ptr = st.data_ptr()
        n0 = launches["ssm_scan"]
        y, h = ssm_scan_cuda(u, dt, A, Bs, Cs, st, h_out=st, y_dtype=dtype)
        assert launches["ssm_scan"] == n0 + 1
        assert h.data_ptr() == ptr and st.data_ptr() == ptr
        states.append(st)
        ys.append(y)
    torch.cuda.synchronize()
    assert torch.equal(*states) and torch.equal(*ys)   # bitwise run to run
    want = h0.clone()
    ssm_scan_plain(u, dt, A, Bs, Cs, want, h_out=want, y_dtype=dtype)
    assert torch.equal(states[0], want)
    assert torch.equal(states[0], h_def.to(dtype))
    assert ys[0].dtype == dtype and torch.equal(ys[0], y_def.to(dtype))
