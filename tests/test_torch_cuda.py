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
                                                 paged_attention_plain,
                                                 takes_latent_kernel)
from repro_torch.kernels.router_topk import (router_topk_cuda,
                                             router_topk_plain)
from repro_torch.kernels.ssm_scan import ssm_scan_cuda, ssm_scan_plain
from repro_torch.models.moe import MoERuntime, select_replicas
from test_torch_cases import (DEPLOY, EXPERT_FFN_GRID, FLASH_CASES,
                              FLASH_DV_CASES, MEGASTEP_CASES,
                              MOE_FUSED_GRID, PAGED_CASES,
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


def ran_latent_kernel(fn) -> bool:
    """Whether one call of ``fn`` launched the tensor-core latent kernel
    (the names of the kernels it ran, by torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return any("latent_kernel" in e.name for e in prof.events()
               if str(e.device_type).endswith("CUDA"))


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


# deepseek-v3's latent layout: one pool of R + dr = 576 serving as K and V,
# 128 query heads over it, at the engine's context (512 positions over 2
# splits of 256) for a decode step (B=8) and a chunk step (B=40), one row
# over 16 splits, a windowed batch with an idle row; the split's edges (a
# row of exactly one split, one of a split and one position, a window
# that starts inside the second split), B=40 at 1024 positions a row, and
# 64 heads (one CTA a split).  In bf16 these take the tensor-core kernel;
# K and V as two tensors and Da = 320 take the wide kernel
LATENT_CASES = {
    # id: (B, H, Da, max_blk, seq_lens or None, window, K = V)
    "decode_b8": (8, 128, 576, 32, None, 0, True),
    "chunk_b40": (40, 128, 576, 32, None, 0, True),
    "long_row": (1, 128, 576, 256, [4090], 0, True),
    "window_idle": (3, 128, 576, 32, [500, 0, 131], 70, True),
    "two_pools": (4, 32, 576, 32, None, 0, False),
    "nc2": (3, 20, 320, 32, [300, 17, 0], 0, True),
    "one_split": (2, 128, 576, 32, [256, 255], 0, True),
    "one_split_plus_one": (2, 128, 576, 32, [257, 0], 0, True),
    "window_in_second_split": (2, 128, 576, 64, [900, 600], 300, True),
    "b40_1024": (40, 128, 576, 64, [1024] * 40, 0, True),
    "g64": (8, 64, 576, 32, None, 0, True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(LATENT_CASES))
def test_paged_attention_cuda_latent_pool(card, case, dtype):
    B, H, Da, max_blk, lens, window, same = LATENT_CASES[case]
    rng = np.random.default_rng(11)
    bs, nb = 16, max_blk + 2
    tables = np.stack([rng.permutation(nb - 1)[:max_blk] for _ in range(B)])
    seq = (rng.integers(1, max_blk * bs + 1, size=B) if lens is None
           else np.asarray(lens))
    start = np.maximum(seq - window, 0) if window else None
    q = _t(rng.normal(size=(B, H, Da)).astype(np.float32)).to(card, dtype)
    kp = _t(rng.normal(size=(nb, bs, 1, Da)).astype(np.float32)).to(card,
                                                                     dtype)
    vp = kp if same else torch.randn_like(kp)
    rest = [_t(tables.astype(np.int32)).to(card),
            _t(seq.astype(np.int32)).to(card),
            None if start is None else _t(start.astype(np.int32)).to(card)]
    n0 = launches["paged_attention"]
    got = paged_attention_cuda(q, kp, vp, *rest)
    again = paged_attention_cuda(q, kp, vp, *rest)
    torch.cuda.synchronize()
    assert launches["paged_attention"] == n0 + 2
    assert torch.equal(got, again)       # bitwise run to run
    # the kernel the launch ran is the one the plain megastep assumes
    assert ran_latent_kernel(lambda: paged_attention_cuda(q, kp, vp, *rest)) \
        == takes_latent_kernel(q, kp, vp) == (same and Da == 576
                                              and dtype == torch.bfloat16)
    want = paged_attention_plain(q, kp, vp, *rest)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=tol,
                               atol=tol)
    assert not got[torch.from_numpy(seq == 0)].any()   # idle rows give 0


@pytest.mark.cuda
def test_paged_attention_cuda_latent_misaligned_raises(card):
    """The latent layout takes the tensor-core kernel whatever the
    pointers: a q that is not 16-byte aligned fails the launch rather than
    falling back to the wide kernel (and so to another rounding of p)."""
    B, H, Da, bs = 2, 64, 576, 16
    buf = torch.randn(B * H * Da + 1, device=card).to(torch.bfloat16)
    q = buf[1:].view(B, H, Da)                  # 2 bytes past alignment
    pool = torch.randn(4, bs, 1, Da, device=card).to(torch.bfloat16)
    tables = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32, device=card)
    seq = torch.tensor([20, 5], dtype=torch.int32, device=card)
    assert takes_latent_kernel(q, pool, pool)
    n0 = launches["paged_attention"]
    with pytest.raises(RuntimeError, match="launch failed"):
        paged_attention_cuda(q, pool, pool, tables, seq)
    assert launches["paged_attention"] == n0


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
    if MEGASTEP_CARD_CASES[case].get("same_pool"):
        args[2] = args[1]                # MLA: one latent pool as K and V
    n0 = (launches["decode_megastep"], launches["router_topk"])
    y, h2, route = decode_megastep_cuda(*args, **kw, return_route=True)
    y2, h22 = decode_megastep_cuda(*args, **kw)
    torch.cuda.synchronize()
    assert (launches["decode_megastep"], launches["router_topk"]) == \
        (n0[0] + 2, n0[1] + 2)
    assert torch.equal(y, y2) and torch.equal(h2, h22)   # bitwise
    # its attention stage ran the kernel whose rounding the plain assumes
    assert ran_latent_kernel(lambda: decode_megastep_cuda(*args, **kw)) == \
        takes_latent_kernel(*args[:3])
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_route_stage_cuda_vs_plain(card, dtype):
    """The megastep's route stage at deepseek-v3's routing widths (256
    logical experts, top-8) over B=40 rows, cap 2 so that copies drop,
    with a lost and a masked expert: its route and slot tables against
    the plain router, replica select and sort pass over the logits of its
    own h2, and bitwise equal between two calls."""
    args, kw = megastep_inputs(B=40, E_log=256, E=258, K=8, cap=2, lost=3,
                               masked=4)
    floats = {0, 1, 2, 6, 7, 8, 9, 13, 14, 15}
    args = [a if a is None or isinstance(a, int) else
            _t(a).to(card, dtype) if i in floats else _t(a).to(card)
            for i, a in enumerate(args)]
    _, h2, route = decode_megastep_cuda(*args, **kw, return_route=True)
    _, _, again = decode_megastep_cuda(*args, **kw, return_route=True)
    torch.cuda.synchronize()
    for key in route:
        assert torch.equal(route[key], again[key]), key   # bitwise
    w, sel = router_topk_plain(h2.float() @ args[9].float(), args[12],
                               kw["top_k"])
    rt = MoERuntime(args[10], args[11], args[12])
    phys, alive = select_replicas(sel.long(), rt)
    tok_idx, wgt, slot_of = moe_group_tokens(
        phys, alive, w, expert_offset=0, e_local=kw["e_local"],
        cap=kw["cap"])
    assert int((slot_of < 0).sum()) > int((~alive).sum())   # drops
    assert torch.equal(route["sel"], sel)
    assert torch.equal(route["tok_idx"], tok_idx)
    assert torch.equal(route["slot_of"], slot_of)
    # the weights: tests/test_torch_megastep.py's router tolerance
    for got, want in ((route["w"], w), (route["wgt"], wgt)):
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=2e-5, atol=0)


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


# MLA's whole-prompt attention (QK width 192, V width 128, 128 heads, G =
# 1 at full width) at the serial path's buckets, with and without a window
FLASH_DV_CARD_CASES = dict(
    FLASH_DV_CASES, s256=(1, 256, 128, 128, 192, 128, True, 0),
    s512_window6=(1, 512, 128, 128, 192, 128, True, 6))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(FLASH_DV_CARD_CASES))
def test_flash_prefill_cuda_v_width(card, case, dtype):
    B, S, H, Hkv, Dq, Dv, causal, window = FLASH_DV_CARD_CASES[case]
    q, k, v, qpos, kvpos = flash_inputs(B, S, H, Hkv, Dq, 0, Dv=Dv)
    q, k, v = (_t(a).to(card, dtype) for a in (q, k, v))
    qpos, kvpos = _t(qpos).to(card), _t(kvpos).to(card)
    kw = dict(causal=causal, window=window)
    got = flash_prefill_cuda(q, k, v, qpos, kvpos, **kw)
    again = flash_prefill_cuda(q, k, v, qpos, kvpos, **kw)
    torch.cuda.synchronize()
    assert got.shape == (B, S, H, Dv)
    assert torch.equal(got, again)       # bitwise run to run
    want = flash_prefill_plain(q, k, v, qpos, kvpos, **kw)
    # the tolerances of test_flash_prefill_cuda_vs_plain
    tol = 2e-4 if dtype == torch.float32 else 2e-2
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=tol,
                               atol=tol)


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


def _smoke_engine(tmp_path, card, dtype, **over):
    """The qwen2-moe smoke model with capacity to spare, on the card."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.serving.engine import EngineConfig, InferenceEngine
    cfg = get_smoke_config("qwen2-moe-a2.7b")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, num_experts=4, num_redundant_experts=2, top_k=2,
        capacity_factor=8.0, min_capacity=64))
    ec = dict(mode="collocated", num_dp=2, max_batch=4, max_seq=64,
              block_size=8, num_blocks=64, moe_impl="fused")
    ec.update(over)
    return cfg, InferenceEngine(cfg, EngineConfig(workdir=str(tmp_path),
                                                  **ec),
                                dtype=dtype, device=card)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kv_stream_round_trip_on_card(card, tmp_path, dtype):
    """export → import between a card engine's two executors: the payload
    stays on the card, the installed rows are bitwise the payload, and
    the request's next decode logits on the target (alone in slot 0, as
    on the donor) are bitwise the donor's."""
    from repro_torch.serving import cache_ops
    from repro_torch.serving.kvcache import build_page_context
    cfg, eng = _smoke_engine(tmp_path, card, dtype)
    rng = np.random.default_rng(0)
    req = eng.submit(list(map(int, rng.integers(0, cfg.vocab_size, 30))),
                     16)
    while len(req.output_tokens) < 3:
        eng.step()
    donor, target = eng.dp_executors

    def next_logits(ex):
        page = build_page_context([req], ex.scheduler.block_tables,
                                  max_batch=ex.max_batch,
                                  max_blk=ex.max_blk,
                                  block_size=ex.block_size,
                                  trash_block=ex.trash_block)
        tokens = torch.zeros(ex.max_batch, dtype=torch.int32, device=card)
        tokens[req.batch_slot] = int(ex.last_token[req.batch_slot])
        logits, _ = eng.model.decode_step_paged(
            eng.params, cache_ops.clone_cache(ex.cache), tokens,
            {k: torch.from_numpy(v).to(card) for k, v in page.items()},
            eng.runtime)
        return logits[req.batch_slot]

    want = next_logits(donor)
    kv = donor.export_kv_blocks(req)
    assert all(p.device.type == "cuda" for p in kv.pool_blocks)
    assert target.import_kv_blocks(req, kv)
    assert req.batch_slot == 0
    blocks = target.scheduler.block_tables[req.req_id].blocks
    got, _ = cache_ops.gather_request_blocks(
        target.cache, target.paged_axes, blocks[:kv.num_blocks], 0)
    for g, p in zip(got, kv.pool_blocks):
        assert torch.equal(g, p)
    assert torch.equal(next_logits(target), want)


@pytest.mark.cuda
def test_reloaded_shard_equals_start_up_bank(card, tmp_path):
    """A rank's experts read back from ``weights.npz`` (bf16) equal its
    slice of the card's bank at start-up, bit for bit."""
    from repro_torch.serving.weights_util import (
        EXPERT_AXIS, expert_leaves, load_expert_shard_from_checkpoint)
    _, eng = _smoke_engine(tmp_path, card, torch.bfloat16,
                           mode="disaggregated", num_moe=2)
    for rank in range(eng.ep_size):
        shard = load_expert_shard_from_checkpoint(
            eng.ckpt_path, eng.shards[rank], rank, workdir=eng.ecfg.workdir)
        for key, leaf in expert_leaves(eng.params):
            per = leaf.shape[EXPERT_AXIS] // eng.ep_size
            assert shard[key].dtype == torch.bfloat16
            assert torch.equal(shard[key].to(card),
                               leaf[:, rank * per:(rank + 1) * per])
