"""Each CUDA kernel against its plain PyTorch version, on the card.

Marked ``cuda``: without a GPU every test skips.  On the card (no JAX
there) run ``python -m pytest -m cuda tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import launches
from repro_torch.kernels.moe_fused import moe_fused_cuda, moe_fused_plain
from repro_torch.kernels.paged_attention import (paged_attention_cuda,
                                                 paged_attention_plain)
from test_torch_cases import (MOE_FUSED_GRID, PAGED_CASES, moe_inputs,
                         paged_inputs, t as _t)


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
