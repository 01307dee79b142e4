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
from repro_torch.kernels.paged_attention import (LATENT,
                                                 paged_attention_cuda,
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
    """Whether one call of ``fn`` launched the tensor-core latent kernel,
    as the C launcher reported its choice (``launches[LATENT]``)."""
    n0 = launches[LATENT]
    fn()
    torch.cuda.synchronize()
    return launches[LATENT] == n0 + 1


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
    # jamba-1.5-large-398b's attention sublayer: G = 8 at Dh 128, a
    # decode step over the engine's context
    "jamba_g8_b8": (8, 64, 8, 128, 16, 32, None, 0),
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
    # minicpm3-4b's dense MLA: Da = 256 + 32, G = 40 (the wide kernel)
    "minicpm3_decode_b8": (8, 40, 288, 32, None, 0, True),
    "minicpm3_chunk_b40": (40, 40, 288, 32, None, 0, True),
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


# jamba-1.5-large-398b's MoE sublayers (D 8192, F 24576) over the hybrid
# path's bank of 4 experts, top-2: a decode step (T=8, cap 8) and one
# prompt's whole prefill (T=256, cap 160: two passes of the gate/up rows)
MOE_JAMBA_CASES = {"decode": (8, 8), "prefill": (256, 160)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(MOE_JAMBA_CASES))
def test_moe_fused_cuda_vs_plain_jamba(card, case, dtype):
    T, cap = MOE_JAMBA_CASES[case]
    args = moe_main_inputs(card, dtype, T, 4, 0, 0, 8192, 24576, k=2, E=4)
    kw = dict(cap=cap, expert_offset=0, e_local=4)
    n0 = launches["moe_fused"]
    got = moe_fused_cuda(*args, **kw)
    again = moe_fused_cuda(*args, **kw)
    torch.cuda.synchronize()
    assert launches["moe_fused"] == n0 + 2
    assert torch.equal(got, again)       # bitwise run to run
    want = moe_fused_plain(*args, **kw)
    # the tolerances of test_moe_fused_cuda_vs_plain_main_shapes
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
    s512_window6=(1, 512, 16, 16, 128, True, 6, 0),
    # internlm2-20b's widths: 6 query heads a KV head at Dh 128
    internlm2_s256=(1, 256, 48, 8, 128, True, 0, 0),
    internlm2_s200_window6=(1, 200, 48, 8, 128, True, 6, 0),
    # jamba-1.5-large-398b's: 8 query heads a KV head at Dh 128
    jamba_s256=(1, 256, 64, 8, 128, True, 0, 0),
    jamba_s200=(1, 200, 64, 8, 128, True, 0, 0),
    # internvl2-26b's vlm prefill: 256 patches + 64 tokens, G = 6
    internvl2_s320=(4, 320, 48, 8, 128, True, 0, 0))


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


# queries over keys of another length, not causal: the audio encoder
# (seamless-m4t-large-v2: S 1536, H = Hkv = 16, Dh 64) and its decoder's
# cross-attention prefill (16 text positions over the 1536 frames), and a
# ragged pair of lengths
FLASH_CROSS_CARD_CASES = {
    # id: (B, Sq, Skv, H, Hkv, Dh)
    "seamless_encoder": (4, 1536, 1536, 16, 16, 64),
    "seamless_cross": (4, 16, 1536, 16, 16, 64),
    "ragged_g2": (2, 7, 300, 4, 2, 64),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(FLASH_CROSS_CARD_CASES))
def test_flash_prefill_cuda_cross_not_causal(card, case, dtype):
    B, Sq, Skv, H, Hkv, Dh = FLASH_CROSS_CARD_CASES[case]
    rng = np.random.default_rng(Sq + Skv)
    q, k, v = (torch.from_numpy(rng.normal(size=(B, n, h, Dh))
                                .astype(np.float32)).to(card, dtype)
               for n, h in ((Sq, H), (Skv, Hkv), (Skv, Hkv)))
    qpos = torch.arange(Sq, dtype=torch.int32, device=card)
    kvpos = torch.arange(Skv, dtype=torch.int32, device=card)
    got = flash_prefill_cuda(q, k, v, qpos, kvpos, causal=False)
    again = flash_prefill_cuda(q, k, v, qpos, kvpos, causal=False)
    torch.cuda.synchronize()
    assert torch.equal(got, again)       # bitwise run to run
    want = flash_prefill_plain(q, k, v, qpos, kvpos, causal=False)
    # the tolerances of test_flash_prefill_cuda_vs_plain
    tol = 2e-4 if dtype == torch.float32 else 2e-2
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=tol,
                               atol=tol)


# a ring cache viewed as a pool (``attention.ring_page``): B blocks of W
# rows, the identity table, seq_lens = min(pos + 1, W), rows before and
# after the ring wrapped; internvl2-26b's G = 6 at Dh 128 over W 384,
# seamless-m4t-large-v2's G = 1 at Dh 64 over W 128 and its cross decode
# over all 1536 frames
RING_CARD_CASES = {
    # id: (H, Hkv, Dh, W, positions)
    "internvl2_w384": (48, 8, 128, 384, [271, 300, 383, 400]),
    "seamless_w128": (16, 16, 64, 128, [8, 127, 128, 200]),
    "seamless_cross": (16, 16, 64, 1536, [1535] * 4),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(RING_CARD_CASES))
def test_paged_attention_cuda_ring_view(card, case, dtype):
    from repro_torch.models.attention import ring_page
    H, Hkv, Dh, W, positions = RING_CARD_CASES[case]
    rng = np.random.default_rng(W)
    B = len(positions)
    q = torch.from_numpy(rng.normal(size=(B, H, Dh)).astype(np.float32))
    k, v = (torch.from_numpy(rng.normal(size=(B, W, Hkv, Dh))
                             .astype(np.float32)).to(card, dtype)
            for _ in range(2))
    tables, seq_lens = ring_page(
        torch.tensor(positions, dtype=torch.int32, device=card), W)
    args = (q.to(card, dtype), k, v, tables, seq_lens)
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


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["internvl2-26b", "seamless-m4t-large-v2"])
def test_ring_decode_step_card_vs_cpu(card, arch):
    """The ring serve step of the vlm and audio smoke models in f32:
    ``prefill`` and 3 greedy ``decode_step``s on the card, through
    ``flash_prefill`` and ``paged_attention``, against the same weights
    and inputs on the CPU (the plain versions)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import Model
    cfg = get_smoke_config(arch)
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32))}
    if cfg.family == "vlm":
        batch["patches"] = torch.from_numpy(rng.normal(
            size=(2, cfg.num_patches, cfg.d_model)).astype(np.float32))
    else:
        batch["frames"] = torch.from_numpy(rng.normal(
            size=(2, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
    extra = cfg.num_patches if cfg.family == "vlm" else 0
    batch["lengths"] = torch.tensor([12 + extra, 7 + extra],
                                    dtype=torch.int32)
    p_cpu = Model(cfg, device="cpu").init(0)
    # per device: the prefill's and each step's logits; the card's steps
    # take the CPU's greedy tokens
    logits, tokens = {}, []
    for dev in ("cpu", "cuda"):
        m = Model(cfg, device=dev)
        p = _to(p_cpu, dev)
        n0 = {k: launches[k] for k in ("flash_prefill", "paged_attention")}
        last, cache = m.prefill(p, _to(batch, dev), max_seq=32)
        out = [last.cpu()]
        for i in range(3):
            if dev == "cpu":
                tokens.append(last.argmax(-1))
            last, cache = m.decode_step(p, cache, tokens[i].to(dev))
            out.append(last.cpu())
        logits[dev] = out
    n = {k: launches[k] - n0[k] for k in n0}
    # the prefill: a launch per attention layer (encoder and decoder),
    # the audio's decoder layers one more for cross-attention; the decode
    # steps: one per decoder layer, the audio's two (ring and cross)
    cross = cfg.num_layers if cfg.family == "audio" else 0
    assert n == {"flash_prefill": cfg.num_layers + cfg.encoder_layers + cross,
                 "paged_attention": 3 * (cfg.num_layers + cross)}
    for a, b in zip(logits["cuda"], logits["cpu"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4,
                                   rtol=1e-4)


def _to(tree, dev):
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


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
                      prefill_d8192_s2048=(1, 2048, 8192, 16, 0, 0, False),
                      # jamba-1.5-large-398b's Mamba sublayers: d_inner
                      # 16384, a prompt's bucket and the decode step
                      prefill_d16384=(1, 256, 16384, 16, 0, 0, False),
                      decode_d16384=(8, 1, 16384, 16, 0, 0, True))


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


def _smoke_cfg():
    """The qwen2-moe smoke model with capacity to spare."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    cfg = get_smoke_config("qwen2-moe-a2.7b")
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, num_experts=4, num_redundant_experts=2, top_k=2,
        capacity_factor=8.0, min_capacity=64))


def _smoke_engine(tmp_path, card, dtype, **over):
    """The qwen2-moe smoke model with capacity to spare, on the card."""
    from repro_torch.serving.engine import EngineConfig, InferenceEngine
    cfg = _smoke_cfg()
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


# -- the overlap pipeline on the card -----------------------------------------

PAT_A, PAT_B = [5, 9, 2, 7], [3, 1]


def _serve_smoke(eng, new=16):
    reqs = [eng.submit(p, new) for p in (PAT_A * 5, PAT_B * 8, PAT_A * 3)]
    eng.run(max_steps=300)
    assert all(r.state.value == "finished" for r in reqs)
    return [list(r.output_tokens) for r in reqs]


@pytest.mark.cuda
@pytest.mark.parametrize("decode_impl", ["composed", "megakernel"])
@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("spec_window", [0, 6])
def test_overlap_equals_lockstep_on_card(card, tmp_path, decode_impl,
                                         temperature, spec_window):
    """bf16 on the card: the overlap pipeline's streams equal lockstep's
    bit for bit (same kernels; the smoke bank has capacity to spare, so a
    window planned from a guessed token drops no row, and at these sizes
    no token turns on the last bits of a row's logits)."""
    from repro_torch.serving.sampling import SamplingParams
    out = []
    for overlap in (False, True):
        _, eng = _smoke_engine(
            tmp_path, card, torch.bfloat16,
            decode_impl=decode_impl, overlap=overlap,
            spec_window=spec_window,
            sampling=SamplingParams(temperature=temperature, top_p=0.9,
                                    seed=3))
        out.append(_serve_smoke(eng))
    assert out[0] == out[1]
    assert eng.overlap_stats()["planned_ahead"] > 0


@pytest.mark.cuda
def test_uploads_in_flight_keep_their_bytes(card):
    """Uploads queued behind a slow device: each drops its pinned buffer
    at once, and the caching host allocator hands that buffer out again
    only after its copy landed, so every upload arrives as it was made;
    and the host never waited (the device is still busy after them)."""
    from repro_torch.serving.staging import readback, upload
    torch.cuda._sleep(200_000_000)          # ~0.1 s of device time queued
    arrays = [np.full((33,), i, np.int32) for i in range(64)]
    got = [upload(card, a, a.astype(np.int64)) for a in arrays]
    back = readback([g[0] for g in got[:4]])
    assert not torch.cuda.current_stream().query()
    for a, (g32, g64) in zip(arrays, got):
        assert torch.equal(g32.cpu(), torch.from_numpy(a))
        assert torch.equal(g64.cpu(), torch.from_numpy(a.astype(np.int64)))
    for a, h in zip(arrays, back.wait()):
        np.testing.assert_array_equal(h, a)


@pytest.mark.cuda
@pytest.mark.parametrize("decode_impl", ["composed", "megakernel"])
def test_plan_and_launch_makes_no_sync(card, tmp_path, decode_impl):
    """The launch half of an overlap step (plan, capture, uploads, the
    model's launches, the sampling epilogue, the readback) makes no
    synchronizing CUDA call: ``set_sync_debug_mode("error")`` raises on
    one.  The first run builds the kernels and graphs; the second is
    checked."""
    _, eng = _smoke_engine(tmp_path, card, torch.bfloat16,
                           decode_impl=decode_impl, overlap=True,
                           spec_window=6)
    _serve_smoke(eng)
    checked = []
    for ex in eng.dp_executors:
        launch = ex._plan_and_launch

        def strict(*a, _launch=launch, **k):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return _launch(*a, **k)
            finally:
                torch.cuda.set_sync_debug_mode(0)
                checked.append(1)
        ex._plan_and_launch = strict
    _serve_smoke(eng)
    assert len(checked) > 10


@pytest.mark.cuda
def test_frontend_driver_thread_serves_the_main_threads_stream(card,
                                                               tmp_path):
    """A completion through ``ServingFrontend`` on a 1-instance fleet on
    the card: the driver thread ticks the engine on the stream, device and
    grad mode of the thread that built the front end, and its tokens equal
    bit for bit those of the same prompt stepped through the same engine
    on the main thread (no prefix cache, so both runs make the same
    launches)."""
    import asyncio
    import json
    from repro_torch.fleet import VirtualCostProfile, build_fleet
    from repro_torch.serving.engine import EngineConfig
    from repro_torch.serving.frontend import ServingFrontend
    fleet = build_fleet(_smoke_cfg(), EngineConfig(
        mode="collocated", num_dp=2, max_batch=4, max_seq=64, block_size=8,
        num_blocks=64, moe_impl="fused", prefix_cache=False,
        workdir=str(tmp_path)), instances=1,
        cost_profile=VirtualCostProfile(), device=card)
    prompt, n = PAT_A * 5, 16
    lockstep = fleet.submit(prompt, n, eos_token=None)
    fleet.run(max_ticks=300)
    want = list(lockstep.committed_output)
    assert len(want) == n
    main_state = (torch.cuda.current_stream().cuda_stream,
                  torch.cuda.current_device(), torch.is_grad_enabled())

    async def serve():
        fe = ServingFrontend(fleet, port=0)
        await fe.start()
        try:
            state = await fe._call(lambda: (
                torch.cuda.current_stream().cuda_stream,
                torch.cuda.current_device(), torch.is_grad_enabled()))
            reader, writer = await asyncio.open_connection("127.0.0.1",
                                                           fe.port)
            body = json.dumps({"prompt": prompt, "max_tokens": n,
                               "eos_token": None}).encode()
            writer.write(b"POST /v1/completions HTTP/1.1\r\n"
                         b"Content-Length: %d\r\n\r\n" % len(body) + body)
            await writer.drain()
            data = await asyncio.wait_for(reader.read(), 120)
            writer.close()
            return state, json.loads(data.split(b"\r\n\r\n", 1)[1])
        finally:
            await fe.stop()

    state, reply = asyncio.run(serve())
    assert state == main_state
    assert reply["choices"][0]["tokens"] == want
    assert reply["choices"][0]["finish_reason"] == "length"


# the backward kernels (training): shapes of the CPU tests' plain cases,
# G = 6 at internlm2-20b's width, MLA's Dq 192 / Dv 128, a sliding
# window, queries over keys of another length, rows that see no key
FLASH_BWD_CARD_CASES = {
    # id: (B, Sq, Skv, H, Hkv, Dq, Dv, causal, window, kv position shift)
    "g1": (2, 64, 64, 4, 4, 64, 64, True, 0, 0),
    "g6": (1, 80, 80, 12, 2, 128, 128, True, 0, 0),
    "window6": (1, 96, 96, 4, 2, 128, 128, True, 6, 0),
    "mla": (1, 72, 72, 8, 8, 192, 128, True, 0, 0),
    "dh256": (1, 40, 40, 4, 1, 256, 256, True, 0, 0),
    "not_causal_ragged": (2, 7, 70, 4, 2, 64, 64, False, 0, 0),
    "no_key_rows": (1, 48, 48, 4, 2, 32, 32, True, 0, 5),
}
# |kernel - plain| <= tol * (the gradient's largest |value|)
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _scaled_close(got, want, tol, what):
    g, w = got.float().cpu(), want.float().cpu()
    scale = float(w.abs().max())
    err = float((g - w).abs().max())
    assert torch.isfinite(g).all() and err <= tol * scale, (
        f"{what}: max err {err:.3e} at scale {scale:.3e}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(FLASH_BWD_CARD_CASES))
def test_flash_prefill_bwd_cuda_vs_plain(card, case, dtype):
    from repro_torch.kernels.flash_prefill import (flash_prefill_bwd_cuda,
                                                   flash_prefill_bwd_plain)
    B, Sq, Skv, H, Hkv, Dq, Dv, causal, window, shift = \
        FLASH_BWD_CARD_CASES[case]
    rng = np.random.default_rng(5)
    q, k, v, do = (_t(rng.normal(size=s).astype(np.float32)).to(card, dtype)
                   for s in ((B, Sq, H, Dq), (B, Skv, Hkv, Dq),
                             (B, Skv, Hkv, Dv), (B, Sq, H, Dv)))
    qpos = (torch.arange(Sq, dtype=torch.int32) + (Skv - Sq)).to(card)
    kvpos = (torch.arange(Skv, dtype=torch.int32) + shift).to(card)
    kw = dict(causal=causal, window=window)
    o = flash_prefill_cuda(q, k, v, qpos, kvpos, **kw)
    n0 = launches["flash_prefill_bwd"]
    got = flash_prefill_bwd_cuda(q, k, v, o, do, qpos, kvpos, **kw)
    again = flash_prefill_bwd_cuda(q, k, v, o, do, qpos, kvpos, **kw)
    torch.cuda.synchronize()
    assert launches["flash_prefill_bwd"] == n0 + 2
    want = flash_prefill_bwd_plain(q, k, v, o, do, qpos, kvpos, **kw)
    for name, g, a, w in zip(("dq", "dk", "dv"), got, again, want):
        assert g.dtype == dtype and torch.equal(g, a), name  # bitwise
        _scaled_close(g, w, BWD_TOL[dtype], f"{case} {name}")
    if shift:
        assert not got[0][:, :shift].any()   # rows that see no key


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("E,C,D,F", EXPERT_FFN_GRID + [(3, 13, 36, 44)])
def test_expert_ffn_bwd_cuda_vs_plain(card, E, C, D, F, dtype):
    from repro_torch.kernels.expert_ffn import (expert_ffn_bwd_cuda,
                                                expert_ffn_bwd_plain)
    x, g, u, d = (_t(a).to(card, dtype)
                  for a in expert_ffn_inputs(E, C, D, F))
    x[0, C // 2:] = 0                         # empty rows (dropped copies)
    dy = _t(np.random.default_rng(6).normal(size=(E, C, D)).astype(
        np.float32)).to(card, dtype)
    n0 = launches["expert_ffn_bwd"]
    got = expert_ffn_bwd_cuda(x, g, u, d, dy)
    again = expert_ffn_bwd_cuda(x, g, u, d, dy)
    torch.cuda.synchronize()
    assert launches["expert_ffn_bwd"] == n0 + 2
    want = expert_ffn_bwd_plain(x, g, u, d, dy)
    for name, a, b, w in zip(("dx", "dgate", "dup", "ddown"), got, again,
                             want):
        assert a.dtype == dtype and torch.equal(a, b), name     # bitwise
        _scaled_close(a, w, BWD_TOL[dtype], f"E={E} C={C} {name}")
    assert not got[0][0, C // 2:].any()       # empty rows: zero gradient


@pytest.mark.cuda
def test_train_steps_card_vs_cpu(card):
    """Two train() steps of the smoke qwen2-moe-a2.7b in f32 on the card,
    through flash_prefill, expert_ffn and their backward kernels, against
    the same weights and batches on the CPU (the plain versions), at lr
    1e-3 after a one-step warmup (updates of a real run's size, so step
    1 follows the gradients): step 0's gradient of every leaf within
    1e-3 of the leaf's scale, every logged number within 1e-3 relative,
    the final params finite.  The final params are not held elementwise:
    AdamW divides each update by |g|, so f32 noise on a gradient near
    zero moves an element by up to the lr either way (the embedding's
    rows differ by 1.6e-4 at a scale of 0.093 on the H100)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import Model
    from repro_torch.training.checkpoint import flatten
    from repro_torch.training.data import DataConfig, lm_batches
    from repro_torch.training.optimizer import OptimizerConfig
    from repro_torch.training.train_loop import as_leaves, train
    cfg = get_smoke_config("qwen2-moe-a2.7b")
    p_cpu = Model(cfg, device="cpu").init(0)
    dc = DataConfig(cfg.vocab_size, 32, 4)
    out, grads = {}, {}
    n0 = {k: launches[k] for k in ("flash_prefill_bwd", "expert_ffn_bwd")}
    for dev in ("cpu", "cuda"):
        m = Model(cfg, device=dev)
        leaves = as_leaves(_to(p_cpu, dev))
        batch = {k: torch.as_tensor(v).to(dev)
                 for k, v in next(lm_batches(dc)).items()}
        keys, ts = zip(*flatten(leaves))
        grads[dev] = dict(zip(keys, torch.autograd.grad(
            m.loss(leaves, batch)[0], ts)))
        out[dev] = train(m, lm_batches(dc), 2,
                         OptimizerConfig(lr=1e-3, warmup_steps=1),
                         log_every=1, params=_to(p_cpu, dev))
    n = {k: launches[k] - n0[k] for k in n0}
    n_moe = cfg.num_layers - cfg.moe.first_k_dense
    assert n == {"flash_prefill_bwd": 3 * cfg.num_layers,
                 "expert_ffn_bwd": 3 * n_moe}
    for key, w in grads["cpu"].items():
        _scaled_close(grads["cuda"][key], w, 1e-3, f"step 0 grad {key}")
    for hg, hw in zip(out["cuda"][1], out["cpu"][1]):
        for key in ("loss", "ce", "aux", "lr", "grad_norm"):
            assert abs(hg[key] - hw[key]) <= 1e-3 * abs(hw[key]), key
    for key, g in flatten(out["cuda"][0]):
        assert torch.isfinite(g).all(), key
