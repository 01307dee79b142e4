#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                 # every phase
    python3 chip_smoke.py --phases device,build,kernels   # a subset
    python3 chip_smoke.py --layers 24     # the collocated qwen paths' depth
    python3 chip_smoke.py --paths ssm     # serve one engine path
    python3 chip_smoke.py --paths disagg  # the role switch, 24 layers
    python3 chip_smoke.py --paths mla_composed,mla_megakernel,mla_serial
    python3 chip_smoke.py --profile       # + where the device time goes

Phases, in order; any failure raises and the script exits non-zero:

1. device  — require CUDA, print the card's name and power limit, turn
             TF32 off for matmuls and cuDNN.
2. build   — compile the seven CUDA kernels from
             ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per source, in
             parallel) into ``build/kernels``.
3. kernels — each kernel against its plain PyTorch version on the card, at
             the slice's shapes, in f32 and bf16: paged attention (a
             windowed case, an idle row, the engine's full context of 512
             positions at B = 8 and 40, one 4090-position row over 64
             splits, windows that start mid-split or leave whole splits
             empty) and the fused MoE (masked / lost /
             over-capacity / foreign / empty experts); router top-k
             (well-separated logits, ties, masked columns); the decode
             megastep at full width, decode (B=8) and chunk (B=40) rows,
             with a window, an idle row, masked and lost experts, a dead
             replica, an over-capacity expert and a foreign half bank,
             its slot tables exactly those of the plain sort pass; the
             grouped expert FFN over the dense capacity buffer at decode
             (C=8) and prefill (C=20, 40) capacity; whole-prompt attention
             at S = 16, 200, 256 and 512, with and without window 6; the
             selective scan at falcon-mamba-7b's width (d_inner 8192, N
             16), a prefill row at S = 200, 256, 512 and 2048 and the
             decode step of 8 slots from their state, also in the
             engine's in-place mode (the bf16 state written where it
             lies, its storage unchanged).  Then the same at
             deepseek-v3's shapes: paged attention at the latent layout
             (Hkv = 1, G = 128, Da = 576, one pool as K and V) at decode
             B = 8 and chunk B = 40 over the engine's context, over one
             4090-position row and windowed with an idle row; the
             megastep at that layout (w_post (73728, 7168), 256 + 32
             experts, top-8) at B = 8 and 40 with masked and lost
             experts and a dead replica, its route stage timed beside
             softmax + topk over the same logits; whole-prompt attention with
             Dq = 192, Dv = 128, H = 128 at S = 256 and 512 with and
             without window 6; the fused MoE at T = 8 and 40 and the
             expert FFN at C = 8, 9, 18 over 288 experts of D = 7168, F
             = 2048 (f32 over a third of the bank).  Every
             kernel runs twice and must be bitwise equal; kernel and plain
             version are timed at the main path's shapes (the fused MoE at
             T = 8 and 40 with its device time split between its kernels
             and its sort pass, the megastep at B = 8 and 40 also beside
             the composed chain of the same block), and beside a library
             call where one computes the same function.
4. model   — qwen2-moe-a2.7b at full width, 2 layers, f32: one chunk step
             and one decode step on the card against the same weights on
             the CPU (plain versions), once per decode implementation
             (composed, megakernel), and one whole-prompt prefill
             (dense-scatter MoE) installed into the pools, then a decode
             step; logits and installed K/V rows within tolerance, greedy
             tokens equal, and the two implementations agree on the card.
             The same for deepseek-v3 at full width (MLA, 1 dense + 1 MoE
             layer, its bank cut to 16 + 4 experts with top-8 kept: a
             288-expert f32 layer is 50.7 GB), its prefill installed into
             the latent pools.  Then falcon-mamba-7b at full width, 2
             layers, f32: a
             whole-prompt prefill at bucket 256, its state installed, two
             decode steps; logits and state within tolerance, greedy
             tokens equal.
5. engine  — behind the ``InferenceEngine`` (2 DP ranks, collocated but
             on ``disagg``), in bf16.  Each group of paths below shares
             one workdir: its first build writes ``weights.npz`` (no
             per-rank shard file), the others load it, and it is removed
             before the next group writes its own (a run may write at
             most 45 GiB to its disk).  Three qwen paths, qwen2-moe-a2.7b
             at full width cut to 8 of its 24 layers (``--layers``; ~1.2
             GB of checkpoint a layer plus 1.3 GB, read whole by each of
             their six builds): chunked admission with the fused MoE and
             each decode implementation (composed, megakernel), and serial
             admission (whole-prompt prefills) with the model's
             dense-scatter MoE.  Then the same three paths for deepseek-v3
             (``mla_composed``, ``mla_megakernel``, ``mla_serial``) at full
             width, depth cut from 61 to its 3 dense + 1 MoE layers (a ~33
             GB ``weights.npz``).  Then the ``ssm`` path: falcon-mamba-7b
             at full width and full depth (64 layers; a 14.55 GB
             ``weights.npz``, no shards), whose chunked admission falls
             back to whole-prompt installs.  Each of these serves 8
             requests without a fault, then the same workload with an L6
             fault on physical 1 mid-step at step 6 (``attn+moe`` on the
             MoE paths, ``attn`` on the ssm path), revived in place.
             Last the ``disagg`` path: qwen2-moe-a2.7b at full width and
             all 24 layers (a 30.31 GB ``weights.npz``) in disaggregated
             mode, 2 attention ranks (physicals 0-1) and 2 expert ranks
             (physicals 2-3), the same 8 requests three times: without a
             fault; with an L6 ``moe`` fault mid-step on physical 2 (EP
             rank 0) one step after the first run had every request past
             its prefill, revived by the §3.4 role switch (the donor's
             residents KV-streamed, each install held ``torch.equal`` to
             its payload on the card; EP rank 0's experts read back from
             ``weights.npz``, its checksum equal to start-up's; no more
             prefill tokens than the first run); and with the same fault
             under ``background_role_switch`` (logicals 4-31 masked until
             the switch finishes at the next step, 32 experts restored,
             the mask cleared).  Each path's kernels' launch counts are
             read from its faulted run (``disagg``: the synchronous
             switch's), counted from 0 just before it.  Each engine build
             prints its start-up files, its memory on the card and the
             host's MemTotal and MemAvailable.
6. a ``{"kernels": [...]}`` line (each kernel's row at the qwen or
   falcon shapes, with its deepseek-v3 rows under ``mla``), then the
   ``{"ok": true, ...}`` line.

Imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
PHASES = ("device", "build", "kernels", "model", "engine")
HBM_BYTES_PER_S = 3.35e12                     # H100 SXM data sheet
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
KERNEL_META = {
    "paged_attention": ("src/repro_torch/kernels/csrc/paged_attention.cu",
                        "src/repro/kernels/paged_attention.py:82"),
    "moe_fused": ("src/repro_torch/kernels/csrc/moe_fused.cu",
                  "src/repro/kernels/moe_fused.py:122"),
    "decode_megastep": ("src/repro_torch/kernels/csrc/decode_megastep.cu",
                        "src/repro/kernels/decode_megakernel.py:349"),
    "router_topk": ("src/repro_torch/kernels/csrc/router_topk.cu",
                    "src/repro/kernels/router_topk.py:53"),
    "expert_ffn": ("src/repro_torch/kernels/csrc/expert_ffn.cu",
                   "src/repro/kernels/expert_ffn.py:41"),
    "flash_prefill": ("src/repro_torch/kernels/csrc/flash_prefill.cu",
                      "src/repro/kernels/flash_prefill.py:83"),
    "ssm_scan": ("src/repro_torch/kernels/csrc/ssm_scan.cu",
                 "src/repro/kernels/ssm_scan.py:52"),
}
# the engine paths each kernel runs on; its launches are counted there
# (the megakernel paths run paged_attention too: MLA's first-k dense
# layers keep the composed chain)
KERNEL_PATH = {"paged_attention": ("composed", "serial", "mla_composed",
                                   "mla_megakernel", "mla_serial", "disagg"),
               "moe_fused": ("composed", "mla_composed", "disagg"),
               "decode_megastep": ("megakernel", "mla_megakernel"),
               "router_topk": ("megakernel", "mla_megakernel"),
               "expert_ffn": ("serial", "mla_serial"),
               "flash_prefill": ("serial", "mla_serial"),
               "ssm_scan": ("ssm",)}
IMPLS = ("composed", "megakernel")
# the engine paths: EngineConfig options of each.  ``ssm`` serves
# falcon-mamba-7b, whose chunked admission falls back to whole-prompt
# installs (a Mamba mixer cannot chunk); the ``mla_*`` paths deepseek-v3
# (multi-head latent attention); the others qwen2-moe-a2.7b, ``disagg`` in
# disaggregated mode (2 attention ranks, 2 expert ranks).
PATHS = {"composed": dict(moe_impl="fused", decode_impl="composed"),
         "megakernel": dict(moe_impl="fused", decode_impl="megakernel"),
         "serial": dict(admission="serial", decode_impl="composed"),
         "mla_composed": dict(moe_impl="fused", decode_impl="composed"),
         "mla_megakernel": dict(moe_impl="fused", decode_impl="megakernel"),
         "mla_serial": dict(admission="serial", decode_impl="composed"),
         "ssm": dict(),
         "disagg": dict(mode="disaggregated", num_moe=2, moe_impl="fused",
                        decode_impl="composed")}
QWEN_ARCH = "qwen2-moe-a2.7b"
PATH_ARCH = {"ssm": "falcon-mamba-7b", "mla_composed": "deepseek-v3",
             "mla_megakernel": "deepseek-v3", "mla_serial": "deepseek-v3"}
# card-vs-plain tolerances (allclose: |got - want| <= atol + rtol |want|).
# f32: both accumulate in f32 in different orders.  bf16: the plain
# versions round intermediates to bf16 where the kernels keep f32 (the
# attention probabilities before p @ V; the expert outputs and each of
# the k weighted adds), a few bf16 ulps at |y| ~ 1.
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (3e-2, 3e-2)}
# the megastep chains attention and eight products; f32 as
# tests/test_decode_megakernel.py, bf16 as above
MEGA_TOL = {"float32": (2e-4, 2e-4), "bfloat16": (3e-2, 3e-2)}
ROUTER_RTOL = 2e-5            # weights; indices must be equal
# tests/test_kernels.py's tolerances for the two kernels of the serial path
FFN_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (2e-2, 2e-2)}
FLASH_TOL = {"float32": (2e-4, 2e-4), "bfloat16": (2e-2, 2e-2)}
# the selective scan (atol, rtol): tests/test_kernels.py:89's f32
# tolerance for both types, since both versions cast the bf16 inputs to
# f32 before any product and then compute the same sums in f32
SSM_TOL = {"float32": (1e-5, 1e-4), "bfloat16": (1e-5, 1e-4)}
MODEL_LOGIT_ATOL = 1e-3       # f32, 2 layers at full width, card vs CPU
# the f32 Mamba state after a whole prompt, card vs CPU (atol, rtol): the
# products before the scan sum in other orders
STATE_TOL = (1e-4, 1e-3)
ENGINE_LAYERS = 24            # qwen2-moe-a2.7b's full depth
# the depth of the collocated qwen paths (``--layers``): every engine build
# reads its whole weights.npz (~1.2 GB a layer) and these paths build six
# (~250 s at 24 layers on the H100's host), so they run cut to keep the
# script well inside its 1200 s limit; the paths named here keep their
# own depth (and workdir)
COLLOCATED_LAYERS = 8
PATH_LAYERS = {"disagg": ENGINE_LAYERS}
# the kernels phase's shapes: the engine phase's batch, chunk and paging,
# qwen2-moe-a2.7b's widths
SHAPES = dict(max_batch=8, chunk=32, block_size=16, num_blocks=256,
              max_blk=512 // 16, d_model=2048, d_ff=1408, top_k=4, cap=8)


def log(msg: str) -> None:
    print(msg, flush=True)


# -- helpers ------------------------------------------------------------------

def time_ms(torch, fn, reps: int = 25) -> float:
    """Median device time of one call, each call after a 128 MB write that
    evicts the 50 MB L2 (the serving path finds its operands cold).  A
    ~2 ms device sleep ahead of each call keeps the stream busy while the
    host enqueues it, so the events time the device work, not the host's
    launch overhead (``fn`` must not synchronise)."""
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(4_000_000)
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        times.append((a, b))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in times]))


def kernel_breakdown(torch, fn, reps: int = 20):
    """Mean device time of each kernel ``fn`` launches, in µs, largest
    first (``fn`` must not synchronise)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sorted(((e.self_device_time_total / reps, e.key)
                   for e in prof.key_averages()
                   if e.self_device_time_total > 0), reverse=True)


def kernel_sequence(torch, fn):
    """The kernels of one call of ``fn``, in launch order, each with its
    device time in µs (after a warm-up call; ``fn`` must not
    synchronise): where a chain's stages that share a kernel name go."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = sorted((e for e in prof.events()
                  if str(e.device_type).endswith("CUDA")),
                 key=lambda e: e.time_range.start)
    return [(e.time_range.elapsed_us(), e.name) for e in evs]


def compare(name, got, want, dtype_name, tol=TOL):
    atol, rtol = tol[dtype_name]
    g, w = got.float().cpu().numpy(), want.float().cpu().numpy()
    err = float(np.abs(g - w).max()) if g.size else 0.0
    bad = np.abs(g - w) > atol + rtol * np.abs(w)
    log(f"  {name:<44} max_abs_err {err:.3e}  (atol {atol:g}, rtol {rtol:g})"
        f"  {'ok' if not bad.any() else 'FAIL'}")
    if bad.any() or not np.isfinite(g).all():
        raise AssertionError(f"{name}: {int(bad.sum())} elements outside "
                             f"tolerance, max_abs_err {err}")
    return err


# -- phase 1-2 ----------------------------------------------------------------

def phase_device(torch):
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    log(smi[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"device: {torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} visible; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; TF32 off for matmul and cuDNN "
        f"(f32 products run in full f32)")


def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    logs = build.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s for {list(logs)} into "
        f"{build.build_dir()}")
    for name, text in logs.items():
        fn = "?"
        for line in text.splitlines():
            m = re.search(r"entry function '\w*?\d+([A-Za-z_]+_kernel)",
                          line)
            if m:   # the kernel whose properties follow
                fn = m.group(1)
            elif "registers" in line or "spill" in line:
                log(f"  {name} {fn}: {line.strip()}")


# -- phase 3: kernels ---------------------------------------------------------

def paged_case(torch, *, B, H, Hkv, Dh, bs, nb, max_blk, max_len, window,
               idle, dtype, seed, lens=None, same=False):
    """Random q and pools, a random block table per row, and seq_lens
    drawn from [1, max_len] (or ``lens``); ``window`` > 0 starts each row
    ``window`` positions before its end; ``same``: one pool serves as K
    and V (MLA's latent pool).  Returns (args, valid rows)."""
    rng = np.random.default_rng(seed)
    dev = "cuda"
    q = torch.from_numpy(rng.normal(size=(B, H, Dh)).astype(np.float32))
    kp = torch.from_numpy(
        rng.normal(size=(nb, bs, Hkv, Dh)).astype(np.float32))
    vp = torch.from_numpy(
        rng.normal(size=(nb, bs, Hkv, Dh)).astype(np.float32))
    tables = np.stack([rng.permutation(nb - 1)[:max_blk] for _ in range(B)])
    seq = (rng.integers(1, max_len + 1, size=B) if lens is None
           else np.asarray(lens))
    if idle:
        seq[1] = 0
    start = np.maximum(seq - window, 0) if window else None
    kp = kp.to(dev, dtype)
    args = [q.to(dev, dtype), kp, kp if same else vp.to(dev, dtype),
            torch.from_numpy(tables.astype(np.int32)).to(dev),
            torch.from_numpy(seq.astype(np.int32)).to(dev),
            None if start is None else
            torch.from_numpy(start.astype(np.int32)).to(dev)]
    valid = (seq - (start if start is not None else 0)).clip(min=0)
    return args, int(valid.sum())


def paged_bound_ms(args, n_valid, dtype_name):
    q, kp = args[0], args[1]
    B, H, Dh = q.shape
    Hkv = kp.shape[2]
    el = q.element_size()
    pools = 1 if args[1] is args[2] else 2      # MLA reads one pool
    nbytes = (pools * n_valid * Hkv * Dh * el + 2 * q.numel() * el
              + args[3].numel() * 4 + 2 * B * 4)
    flops = 4 * n_valid * H * Dh
    t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype_name]
    return 1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def moe_case(torch, *, T, E, e_local, off, D, Fd, k, cap, dtype, seed,
             hot=0, dead_p=0.15, direct=False):
    """``direct``: draw the bank in ``dtype`` (a deepseek-v3 bank of 288
    experts is 50.7 GB in f32)."""
    rng = np.random.default_rng(seed)
    dev = "cuda"
    x = rng.normal(size=(T, D)).astype(np.float32)
    gen = torch.Generator(device=dev).manual_seed(seed)
    bank = dict(generator=gen, device=dev,
                dtype=dtype if direct else torch.float32)
    g = torch.randn((e_local, D, Fd), **bank).mul_(D ** -0.5)
    u = torch.randn((e_local, D, Fd), **bank).mul_(D ** -0.5)
    d = torch.randn((e_local, Fd, D), **bank).mul_(Fd ** -0.5)
    # routing: distinct experts per token; ``hot`` tokens all pick expert
    # 5 first (overflows cap); ~dead_p of the copies are on dead replicas
    phys = np.stack([rng.permutation(E)[:k] for _ in range(T)])
    for t in range(min(hot, T)):
        phys[t][phys[t] == 5] = phys[t, 0]
        phys[t, 0] = 5
    z = rng.normal(size=(T, k))
    w = np.exp(z) / np.exp(z).sum(-1, keepdims=True)
    alive = rng.random(size=(T, k)) >= dead_p
    xt = torch.from_numpy(x).to(dev, dtype)
    args = (xt, g.to(dtype).contiguous(), u.to(dtype).contiguous(),
            d.to(dtype).contiguous(),
            torch.from_numpy(w.astype(np.float32)).to(dev),
            torch.from_numpy(phys.astype(np.int32)).to(dev),
            torch.from_numpy(alive).to(dev))
    return args, dict(cap=cap, expert_offset=off, e_local=e_local)


def moe_bound_ms(args, kw, dtype_name):
    from repro_torch.kernels.moe_fused import moe_group_tokens
    x, gate = args[0], args[1]
    T, D = x.shape
    Fd = gate.shape[2]
    k = args[5].shape[1]
    _, wgt, _ = moe_group_tokens(args[5], args[6], args[4], **kw)
    live_slots = int((wgt != 0).sum())
    live_experts = int((wgt != 0).any(dim=1).sum())
    el = x.element_size()
    nbytes = (live_experts * 3 * D * Fd * el + 2 * T * D * el
              + T * k * (4 + 4 + 1))
    flops = live_slots * 6 * D * Fd
    t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype_name]
    return (1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations",
            live_experts, live_slots)


# moe_fused's cases on the card (name, T, e_local, offset, hot tokens);
# the decode step (T=8) and the chunk step (T = chunk + max_batch = 40)
# are timed
MOE_TIMED = ("decode", "chunk step")


def moe_cases(S):
    return [("decode", S["max_batch"], 64, 0, 0),
            ("chunk, overflow on expert 5", S["chunk"], 64, 0, 12),
            ("chunk, foreign half (offset 32)", S["chunk"], 32, 32, 10),
            ("chunk step", S["chunk"] + S["max_batch"], 64, 0, 0)]


def moe_breakdown(torch, fn, T):
    """moe_fused's device time split between the kernels of moe_fused.cu
    and the sort pass (moe_group_tokens and the launcher's allocations:
    plain PyTorch operations on the device)."""
    rows = kernel_breakdown(torch, fn)
    ours = [(us, k) for us, k in rows
            if "ffn_mma" in k or "combine" in k]
    sort = [(us, k) for us, k in rows if (us, k) not in ours]
    total = sum(us for us, _ in rows)
    log(f"  moe_fused's device time at T={T} (torch.profiler, mean of 20 "
        f"calls, L2 warm): {total:.2f} us; kernels "
        f"{sum(us for us, _ in ours):.2f} us, sort pass "
        f"{sum(us for us, _ in sort):.2f} us "
        f"({100 * sum(us for us, _ in sort) / max(total, 1e-9):.1f}%)")
    for us, key in rows:
        log(f"    {us:9.2f} us  {'kernel' if (us, key) in ours else 'sort':6}"
            f"  {key[:84]}")


def phase_kernels(torch, shapes):
    from repro_torch.kernels.moe_fused import moe_fused_cuda, moe_fused_plain
    from repro_torch.kernels.paged_attention import (paged_attention_cuda,
                                                     paged_attention_plain)
    S = shapes
    out = {}
    f32, bf16 = torch.float32, torch.bfloat16
    log("kernels: paged_attention vs paged_attention_plain on the card "
        "(splits of 64 positions, merged in split order)")
    errs = []
    timed = {}
    mb, nblk = S["max_blk"], S["num_blocks"] + 1
    paged_cases = [
        # name, B, H, Hkv, Dh, window, idle, max_len, and optionally
        # max_blk (default the engine's 32) and fixed lens
        ("decode", S["max_batch"], 16, 16, 128, 0, True, 288),
        ("chunk+window", S["chunk"], 16, 16, 128, 64, True, 288),
        ("gqa Dh=96", 6, 16, 4, 96, 0, True, 200),
        ("gqa Dh=256 window", 5, 8, 2, 256, 40, False, 300),
        # the engine's full context (max_seq 512) at both batch sizes
        ("full context", S["max_batch"], 16, 16, 128, 0, True, 512),
        ("full context", S["chunk"] + S["max_batch"], 16, 16, 128, 0, True,
         512),
        # one long row: 64 splits and their merge
        ("long row", 1, 16, 16, 128, 0, False, 4096, 256, [4090]),
        # a window that starts mid-split (200 = 3 * 64 + 8), and one that
        # leaves the first six splits empty (430 > 6 * 64)
        ("window mid-split", 2, 16, 16, 128, 100, False, 0, mb, [300, 290]),
        ("window, empty splits", 2, 16, 16, 128, 70, False, 0, mb,
         [500, 451]),
    ]
    for dtype in (f32, bf16):
        dn = str(dtype).split(".")[1]
        for i, (name, B, H, Hkv, Dh, window, idle, max_len, *more) in \
                enumerate(paged_cases):
            max_blk, lens = more if more else (mb, None)
            args, n_valid = paged_case(
                torch, B=B, H=H, Hkv=Hkv, Dh=Dh, bs=S["block_size"],
                nb=nblk, max_blk=max_blk, max_len=max_len, window=window,
                idle=idle, dtype=dtype, seed=i, lens=lens)
            got = paged_attention_cuda(*args)
            again = paged_attention_cuda(*args)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError(f"paged_attention {name}: not bitwise "
                                     f"equal run to run")
            if idle and got[1].abs().max().item() != 0.0:
                raise AssertionError("paged_attention: idle row not 0")
            want = paged_attention_plain(*args)
            errs.append(compare(f"{name} B={B} H={H}/{Hkv} Dh={Dh} "
                                f"({n_valid} rows) {dn}", got, want, dn))
            if dtype is bf16 and name in ("decode", "full context",
                                          "long row"):
                timed[f"{name} B={B}"] = (args, n_valid, dn)
            del args, got, again, want
    for key, (args, n_valid, dn) in timed.items():
        bound, by = paged_bound_ms(args, n_valid, dn)
        r = dict(
            max_abs_err=max(errs),
            ms=time_ms(torch, lambda: paged_attention_cuda(*args)),
            plain_ms=time_ms(torch, lambda: paged_attention_plain(*args)),
            bound_ms=bound, bound_by=by, library_ms=None,
            shape=f"{key} H=16 Dh=128 bf16, {n_valid} valid K/V rows")
        log(f"  paged_attention at {r['shape']}: kernel {r['ms']:.4f} ms, "
            f"plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']})")
        if key == f"decode B={S['max_batch']}":
            out["paged_attention"] = r
            log(f"  paged_attention's kernels at {key} (torch.profiler, mean "
                f"of 20 calls, L2 warm):")
            for us, k in kernel_breakdown(
                    torch, lambda: paged_attention_cuda(*args)):
                log(f"    {us:9.2f} us  {k[:90]}")
    del timed

    log("kernels: moe_fused vs moe_fused_plain on the card")
    errs = []
    timed = {}
    for dtype in (f32, bf16):
        dn = str(dtype).split(".")[1]
        for i, (name, T, e_local, off, hot) in enumerate(moe_cases(S)):
            args, kw = moe_case(torch, T=T, E=64, e_local=e_local, off=off,
                                D=S["d_model"], Fd=S["d_ff"], k=S["top_k"],
                                cap=S["cap"], dtype=dtype, seed=10 + i,
                                hot=hot)
            got = moe_fused_cuda(*args, **kw)
            again = moe_fused_cuda(*args, **kw)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError(f"moe_fused {name}: not bitwise equal "
                                     f"run to run")
            want = moe_fused_plain(*args, **kw)
            _, _, live_e, live_s = moe_bound_ms(args, kw, dn)
            errs.append(compare(
                f"{name} T={T} ({live_e} experts, {live_s} slots) {dn}",
                got, want, dn))
            if name in MOE_TIMED and dtype is bf16:
                timed[T] = (args, kw, dn)
        del args, got, again, want
    rows = {}
    for T, (args, kw, dn) in timed.items():
        bound, by, live_e, live_s = moe_bound_ms(args, kw, dn)
        rows[T] = r = dict(
            max_abs_err=max(errs),
            ms=time_ms(torch, lambda: moe_fused_cuda(*args, **kw)),
            plain_ms=time_ms(torch, lambda: moe_fused_plain(*args, **kw)),
            bound_ms=bound, bound_by=by, library_ms=None,
            shape=f"T={T} D=2048 F=1408 E=64 k=4 cap=8 bf16, {live_e} "
                  f"experts / {live_s} slots live")
        log(f"  moe_fused at {r['shape']}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']})")
        moe_breakdown(torch, lambda: moe_fused_cuda(*args, **kw), T)
    out["moe_fused"] = rows[S["max_batch"]]
    del timed, args
    gc.collect()
    torch.cuda.empty_cache()
    out["router_topk"] = kernels_router(torch)
    out["decode_megastep"] = kernels_megastep(torch, shapes)
    out["expert_ffn"] = kernels_expert_ffn(torch)
    out["flash_prefill"] = kernels_flash_prefill(torch)
    out["ssm_scan"] = kernels_ssm_scan(torch)
    for name, rows in kernels_mla(torch, shapes).items():
        out[name]["mla"] = rows
    for name, r in out.items():
        _log_row(name, r)
    return out


def router_case(torch, T, E, masked, seed):
    """Well-separated logits (each row a permutation of 0.25-spaced
    values); row 0 all equal and row 1 with three equal maxima, so the
    lowest index must win."""
    rng = np.random.default_rng(seed)
    logits = (np.stack([rng.permutation(E) for _ in range(T)]) * 0.25
              - 5.0).astype(np.float32)
    logits[0] = 1.0
    logits[1, [9, 4, 30]] = logits[1].max() + 1.0
    mask = np.ones(E, bool)
    mask[list(masked)] = False
    return (torch.from_numpy(logits).cuda(), torch.from_numpy(mask).cuda())


def kernels_router(torch):
    from repro_torch.kernels.router_topk import (router_topk_cuda,
                                                 router_topk_plain)
    log("kernels: router_topk vs router_topk_plain on the card")
    E, k = 60, 4
    errs, timed = [], None
    for T, masked in ((40, ()), (40, (5, 33)), (4096, ()), (4096, (7,))):
        logits, mask = router_case(torch, T, E, masked, seed=T)
        w, idx = router_topk_cuda(logits, mask, k)
        w2, idx2 = router_topk_cuda(logits, mask, k)
        torch.cuda.synchronize()
        if not (torch.equal(w, w2) and torch.equal(idx, idx2)):
            raise AssertionError("router_topk: not bitwise equal run to run")
        want_w, want_idx = router_topk_plain(logits, mask, k)
        if not torch.equal(idx, want_idx):
            raise AssertionError(f"router_topk T={T}: indices differ")
        if idx[0].tolist() != [e for e in range(E) if e not in masked][:k] \
                or idx[1, :3].tolist() != [4, 9, 30]:
            raise AssertionError("router_topk: ties not broken to the "
                                 "lowest index")
        rel = ((w - want_w).abs() / want_w.abs().clamp_min(1e-30)).max()
        errs.append(float((w - want_w).abs().max()))
        log(f"  T={T} E={E} k={k} masked {list(masked)}: indices equal, "
            f"weights max_rel_err {float(rel):.3e} (rtol {ROUTER_RTOL:g})"
            f"  {'ok' if rel <= ROUTER_RTOL else 'FAIL'}")
        if rel > ROUTER_RTOL:
            raise AssertionError("router_topk: weights outside tolerance")
        if T == 40 and not masked:
            timed = (logits, mask)
    logits, mask = timed
    T = logits.shape[0]

    def library():   # the closest PyTorch pair: softmax, then topk
        g = torch.softmax(logits.masked_fill(~mask, float("-inf")), -1)
        return torch.topk(g, k, dim=-1)

    nbytes = T * E * 4 + E + T * k * 8
    flops = T * E * (5 + 2 * k)     # masked softmax, then k argmax passes
    t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS["float32"]
    return dict(
        max_abs_err=max(errs),
        ms=time_ms(torch, lambda: router_topk_cuda(logits, mask, k)),
        plain_ms=time_ms(torch, lambda: router_topk_plain(logits, mask, k)),
        bound_ms=1e3 * max(t_b, t_o),
        bound_by="bytes" if t_b >= t_o else "operations",
        library_ms=time_ms(torch, library),
        shape=f"chunk T={T} E={E} k={k} f32 (library: softmax + topk)")


QWEN = dict(D=2048, H=16, Hkv=16, Dh=128, E_log=60, R=4, F=1408, Fs=5632,
            k=4)
# deepseek-v3's block at the megastep's latent layout: one pool of R + dr
# = 576 serving as K and V under 128 query heads, 256 + 32 experts, top-8
DEEPSEEK = dict(D=7168, H=128, Hkv=1, Dh=576, E_log=256, R=32, F=2048,
                Fs=2048, k=8)


def megastep_case(torch, S, *, B, dtype, seed, window=0, masked=(),
                  lost=(), dead=(), hot=None, e_local=64, off=0, W=QWEN):
    """Full-width block operands on the card, at the widths ``W`` (qwen2-
    moe-a2.7b, or deepseek-v3's latent layout, whose K and V are one pool
    and whose weights are drawn in ``dtype`` directly).  Row 1 is idle;
    ``dead`` experts lost their first replica (count 1, the redundant slot
    survives); ``hot`` adds ~3 to one expert's logit on every row (over
    capacity at B=40); ``e_local``/``off`` pick the bank slice.  Returns
    (args, kw, valid K/V rows)."""
    D, H, Hkv, Dh, E_log, R = (W[n] for n in ("D", "H", "Hkv", "Dh",
                                               "E_log", "R"))
    mla = W is DEEPSEEK
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape, scale=1.0):
        if mla:
            return torch.randn(shape, generator=gen, device="cuda",
                               dtype=dtype).mul_(scale)
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(dtype)

    def dev(a):
        return torch.from_numpy(a).cuda()

    nb, bs, max_blk = S["num_blocks"] + 1, S["block_size"], S["max_blk"]
    tables = np.stack([rng.permutation(nb - 1)[:max_blk] for _ in range(B)])
    seq = rng.integers(1, 289, size=B)
    seq[1] = 0
    start = np.maximum(seq - window, 0) if window else np.zeros(B, int)
    u = np.where(rng.random(D) < 0.5, -1.0, 1.0)
    x = rng.normal(size=(B, D)) * (0.3 if hot is not None else 1.0)
    if hot is not None:
        x = x + u
    router = torch.randn((D, E_log), generator=gen, device="cuda") / D ** 0.5
    if hot is not None:
        router[:, hot] += torch.from_numpy(3.0 * u / D).float().cuda()
    ar = np.arange(E_log)
    l2p = np.stack([ar, np.where(ar < R, E_log + ar, 0)], 1)
    rcnt = np.where(ar < R, 2, 1)
    for e in dead:
        l2p[e, 0], rcnt[e] = l2p[e, 1], 1
    rcnt[list(lost)] = 0
    mask = np.ones(E_log, bool)
    mask[list(masked)] = False
    F, Fs = W["F"], W["Fs"]
    pool = randn(nb, bs, Hkv, Dh)
    args = [randn(B, H, Dh), pool, pool if mla else randn(nb, bs, Hkv, Dh),
            dev(tables.astype(np.int32)), dev(seq.astype(np.int32)),
            dev(start.astype(np.int32)), dev(x.astype(np.float32)).to(dtype),
            randn(H * Dh, D, scale=(H * Dh) ** -0.5),
            (1.0 + 0.1 * randn(D).float()).to(dtype), router.to(dtype),
            dev(l2p.astype(np.int32)), dev(rcnt.astype(np.int32)),
            dev(mask), randn(e_local, D, F, scale=D ** -0.5),
            randn(e_local, D, F, scale=D ** -0.5),
            randn(e_local, F, D, scale=F ** -0.5), off,
            randn(D, Fs, scale=D ** -0.5), randn(D, Fs, scale=D ** -0.5),
            randn(Fs, D, scale=Fs ** -0.5)]
    from repro_torch.models.moe import capacity
    kw = dict(top_k=W["k"], cap=capacity(B * W["k"], E_log + R, 1.25,
                                         floor=8),
              e_local=e_local)
    return args, kw, int((seq - start).clip(min=0).sum())


# the megastep's cases on the card (name, kwargs of megastep_case); the
# decode step (B=8) and the chunk step (B=40) are timed
MEGA_TIMED = ("decode", "chunk step")


def megastep_cases(S):
    return [
        # name, kwargs of megastep_case
        ("decode", dict(B=S["max_batch"])),
        ("decode, window 64, masked 10/20, lost 5, dead replica of 1",
         dict(B=S["max_batch"], window=64, masked=(10, 20), lost=(5,),
              dead=(1,))),
        ("chunk, expert 40 over capacity, half bank at offset 32",
         dict(B=S["chunk"] + S["max_batch"], hot=40, e_local=32, off=32)),
        ("chunk, window 64, experts 32-59 masked",
         dict(B=S["chunk"] + S["max_batch"], window=64,
              masked=tuple(range(32, 60)))),
        ("chunk step", dict(B=S["chunk"] + S["max_batch"])),
    ]


def megastep_bound_ms(args, kw, route, n_valid, dtype_name):
    """Bytes: w_post, router, shared experts, the experts with a live
    slot, the valid K/V rows, q, x, y, h2; operations: the products."""
    q, x = args[0], args[6]
    B, H, Dh = q.shape
    D = x.shape[1]
    Hkv = args[1].shape[2]
    E_log = args[9].shape[1]
    F, Fs = args[13].shape[2], args[17].shape[1]
    el = x.element_size()
    live_slots = int((route["wgt"] != 0).sum())
    live_experts = int((route["wgt"] != 0).any(dim=1).sum())
    pools = 1 if args[1] is args[2] else 2      # MLA reads one pool
    nbytes = el * (H * Dh * D + D * E_log + 3 * D * Fs
                   + live_experts * 3 * D * F + pools * n_valid * Hkv * Dh
                   + B * H * Dh + 3 * B * D + D)
    flops = (4 * n_valid * H * Dh + 2 * B * H * Dh * D + 2 * B * D * E_log
             + 6 * B * D * Fs + 6 * live_slots * D * F)
    t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype_name]
    return (1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations",
            live_experts, live_slots)


def check_megastep(name, args, kw, y, h2, route, dn):
    """A megastep's outputs against its plain version.  Its route tables
    equal the plain router's (router_topk_plain, select_replicas,
    moe_group_tokens) over the logits of its own h2; its h2 and, on every
    row, its y are held at the tolerance against the plain version routed
    from that same h2 (``route_h2``), since routing is a discontinuous
    function of h2.  Returns the max abs errors."""
    from repro_torch.kernels.decode_megastep import decode_megastep_plain
    from repro_torch.kernels.moe_fused import moe_group_tokens
    from repro_torch.kernels.router_topk import router_topk_plain
    from repro_torch.models.moe import MoERuntime, select_replicas
    _, psel = router_topk_plain(h2.float() @ args[9].float(), args[12],
                                kw["top_k"])
    if not route["sel"].equal(psel):
        raise AssertionError(f"decode_megastep {name}: routing differs "
                             f"from router_topk_plain")
    rt = MoERuntime(args[10], args[11], args[12])
    phys, alive = select_replicas(route["sel"].long(), rt)
    tables = moe_group_tokens(phys, alive, route["w"],
                              expert_offset=args[16],
                              e_local=kw["e_local"], cap=kw["cap"])
    for key, want in zip(("tok_idx", "wgt", "slot_of"), tables):
        if not route[key].equal(want):
            raise AssertionError(f"decode_megastep {name}: {key} differs "
                                 f"from moe_group_tokens")
    want_y, want_h2 = decode_megastep_plain(*args, **kw, route_h2=h2)
    dropped = int((route["slot_of"] < 0).sum())
    return [compare(f"{name} h2 {dn}", h2, want_h2, dn, MEGA_TOL),
            compare(f"{name} y {dn} ({dropped} copies dropped)", y, want_y,
                    dn, MEGA_TOL)]


def router_splits(B, D, E_log):
    """How many f32 partials of the router logits the megastep's route
    stage sums: ``split_k`` of ``csrc/decode_megastep.cu`` for the router
    product (K = D over 128-column, 8-row tiles)."""
    def cdiv(a, b):
        return -(-a // b)
    s = cdiv(264, cdiv(E_log, 128) * cdiv(B, 8))
    s = max(min(s, max(1, D // 64)), cdiv(D, 512), 1)
    return cdiv(D, cdiv(D, s))


def route_stage_us(torch, fn, reps: int = 20) -> float:
    """Mean device span of the megastep's route stage over ``reps`` calls
    of ``fn`` (torch.profiler, L2 warm): from route_rows' start to
    route_slots' end, since route_slots is route_rows' programmatic
    dependent and the two overlap."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    evs = sorted((e for e in prof.events()
                  if str(e.device_type).endswith("CUDA")
                  and "route_" in e.name), key=lambda e: e.time_range.start)
    rows = [e for e in evs if "route_rows" in e.name]
    slots = [e for e in evs if "route_slots" in e.name]
    if not rows or len(rows) != len(slots):
        raise AssertionError(f"route stage: {len(rows)} route_rows and "
                             f"{len(slots)} route_slots launches traced")
    return float(np.mean([s.time_range.end - r.time_range.start
                          for r, s in zip(rows, slots)]))


def kernels_ms(torch, fn) -> float:
    """The device time of the kernels one call of ``fn`` launches, summed,
    in ms (``kernel_breakdown``: torch.profiler, mean of 20 calls, L2
    warm)."""
    return sum(us for us, _ in kernel_breakdown(torch, fn)) / 1e3


def route_stage_row(torch, mega, args, kw, route, h2):
    """The megastep's route stage at its call's inputs: its profiler time
    (``route_stage_us``), its plain version
    (router_topk_plain, select_replicas and moe_group_tokens over the
    logits of the same h2) and the closest library pair (softmax, then
    topk over those logits), beside the bytes of the logit partials it
    reads and the tables it writes.  All three are timed by torch.profiler
    with L2 warm (the stage inside the megastep cannot be timed alone by
    events): the stage as its span, the plain version and the library
    pair as their kernels' summed device time, which leaves out the gaps
    between their launches."""
    from repro_torch.kernels.moe_fused import moe_group_tokens
    from repro_torch.kernels.router_topk import router_topk_plain
    from repro_torch.models.moe import MoERuntime, select_replicas
    B, D = args[6].shape
    E_log, k, cap, e_local = (args[9].shape[1], kw["top_k"], kw["cap"],
                              kw["e_local"])
    logits = h2.float() @ args[9].float()
    mask, rt = args[12], MoERuntime(args[10], args[11], args[12])

    def plain():
        w, sel = router_topk_plain(logits, mask, k)
        phys, alive = select_replicas(sel.long(), rt)
        return moe_group_tokens(phys, alive, w, expert_offset=args[16],
                                e_local=e_local, cap=cap)

    def library():
        g = torch.softmax(logits.masked_fill(~mask, float("-inf")), -1)
        return torch.topk(g, k, dim=-1)

    pw, psel = router_topk_plain(logits, mask, k)
    if not torch.equal(route["sel"], psel):
        raise AssertionError("route stage: routing differs from "
                             "router_topk_plain")
    splits = router_splits(B, D, E_log)
    nbytes = (4 * splits * B * E_log + E_log * (1 + 4 + 4 * args[10].shape[1])
              + 12 * B * k + 8 * e_local * cap)
    flops = B * E_log * (5 + 2 * k)
    t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS["float32"]
    us = route_stage_us(torch, mega)
    return dict(
        max_abs_err=float((route["w"] - pw).abs().max()), ms=us / 1e3,
        plain_ms=kernels_ms(torch, plain), bound_ms=1e3 * max(t_b, t_o),
        bound_by="bytes" if t_b >= t_o else "operations",
        library_ms=kernels_ms(torch, library),
        shape=f"route stage B={B} E_log={E_log} k={k} cap={cap} over "
              f"{e_local} experts, {splits} logit partials (torch.profiler,"
              f" mean of 20 calls, L2 warm; ms: the stage's span; plain, "
              f"library (softmax + topk): their kernels' summed time)")


def composed_block(torch):
    """The port's composed chain for the same block (the CUDA attention
    and fused MoE kernels, cuBLAS for the other products): the yardstick
    the megastep replaces.  Its ``moe_fused`` runs on the tensor cores in
    bf16, as the megastep's expert products do."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.moe_fused import moe_fused_cuda
    from repro_torch.kernels.paged_attention import paged_attention_cuda
    from repro_torch.models.ffn import ffn_apply
    from repro_torch.models.layers import rms_norm
    from repro_torch.models.moe import MoERuntime, route, select_replicas
    moe_cfg = get_config("qwen2-moe-a2.7b").moe

    def block(args, kw):
        (q, kp, vp, bt, sl, st, x, w_post, ln2, router, l2p, rc, mask, g, u,
         d, off, sg, su, sd) = args
        o = paged_attention_cuda(q, kp, vp, bt, sl, st)
        x2 = x + o.reshape(x.shape[0], -1) @ w_post
        h2 = rms_norm(x2, ln2)
        rt = MoERuntime(l2p, rc, mask)
        w, sel = route(router, h2, rt, moe_cfg)
        phys, alive = select_replicas(sel, rt)
        y = moe_fused_cuda(h2, g, u, d, w, phys, alive, cap=kw["cap"],
                           expert_offset=off, e_local=kw["e_local"])
        return x2 + y + ffn_apply({"w_gate": sg, "w_up": su, "w_down": sd},
                                  h2, "swiglu")
    return block


def kernels_megastep(torch, S):
    from repro_torch.kernels.decode_megastep import (decode_megastep_cuda,
                                                     decode_megastep_plain)
    log("kernels: decode_megastep vs decode_megastep_plain on the card "
        "(qwen2-moe-a2.7b block at full width)")
    errs, timed = [], {}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        for i, (name, case) in enumerate(megastep_cases(S)):
            args, kw, n_valid = megastep_case(torch, S, dtype=dtype,
                                              seed=20 + i, **case)
            y, h2, route = decode_megastep_cuda(*args, **kw,
                                                return_route=True)
            y2, h22 = decode_megastep_cuda(*args, **kw)
            torch.cuda.synchronize()
            if not (torch.equal(y, y2) and torch.equal(h2, h22)):
                raise AssertionError(f"decode_megastep {name}: not bitwise "
                                     f"equal run to run")
            errs += check_megastep(f"{name} B={args[0].shape[0]}", args,
                                   kw, y, h2, route, dn)
            if name in MEGA_TIMED and dtype is torch.bfloat16:
                timed[args[0].shape[0]] = (args, kw, route, n_valid, dn)
            del args, y, y2, h2, h22, route
            gc.collect()
            torch.cuda.empty_cache()
    block = composed_block(torch)
    rows = {}
    for B, (args, kw, route, n_valid, dn) in timed.items():
        bound, by, live_e, live_s = megastep_bound_ms(args, kw, route,
                                                      n_valid, dn)
        mega = lambda: decode_megastep_cuda(*args, **kw)  # noqa: E731
        # in turns: composed, megastep, megastep, composed
        turns = [time_ms(torch, fn) for fn in (lambda: block(args, kw), mega,
                                               mega, lambda: block(args, kw))]
        rows[B] = r = dict(
            max_abs_err=max(errs), ms=(turns[1] + turns[2]) / 2,
            plain_ms=time_ms(torch,
                             lambda: decode_megastep_plain(*args, **kw)),
            bound_ms=bound, bound_by=by, library_ms=None,
            shape=f"B={B} D=2048 H=16 Dh=128 E=64 F=1408 Fs=5632 k=4 "
                  f"cap={kw['cap']} bf16, {n_valid} valid K/V rows, "
                  f"{live_e} experts / {live_s} slots live")
        log(f"  decode_megastep at {r['shape']}: kernel {r['ms']:.4f} ms, "
            f"plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']})")
        log(f"  decode_megastep at B={B} in turns with the composed chain of "
            f"the same block (CUDA attention + moe_fused, now on the tensor "
            f"cores in bf16, + cuBLAS products): composed {turns[0]:.4f}, "
            f"megastep {turns[1]:.4f}, megastep {turns[2]:.4f}, composed "
            f"{turns[3]:.4f} ms")
        log(f"  decode_megastep's kernels at B={B} (torch.profiler, mean of "
            f"20 calls, L2 warm):")
        for us, key in kernel_breakdown(torch, mega):
            log(f"    {us:9.2f} us  {key[:90]}")
        log(f"  decode_megastep's route stage at B={B} E_log=60 k=4: "
            f"{route_stage_us(torch, mega):.2f} us (torch.profiler, route_rows"
            f"' start to route_slots' end, mean of 20 calls, L2 warm)")
        log(f"  decode_megastep's launches at B={B}, one call in order "
            f"(torch.profiler):")
        for us, key in kernel_sequence(torch, mega):
            log(f"    {us:9.2f} us  {key[:90]}")
    del timed, args
    gc.collect()
    torch.cuda.empty_cache()
    return rows[S["max_batch"]]


def expert_ffn_args(torch, C, dtype, E=64, W=QWEN):
    """A layer's E experts over a C-row capacity buffer: qwen2-moe-a2.7b's
    64, or deepseek-v3's (drawn in ``dtype`` directly)."""
    D, Fd = W["D"], W["F"]
    gen = torch.Generator(device="cuda").manual_seed(30 + C)

    def randn(*shape, scale=1.0):
        if W is DEEPSEEK:
            return torch.randn(shape, generator=gen, device="cuda",
                               dtype=dtype).mul_(scale)
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(dtype)
    return (randn(E, C, D), randn(E, D, Fd, scale=D ** -0.5),
            randn(E, D, Fd, scale=D ** -0.5),
            randn(E, Fd, D, scale=Fd ** -0.5))


def kernels_expert_ffn(torch):
    """The dense-scatter MoE's expert FFN at the serial path's shapes: all
    64 experts of a qwen2-moe-a2.7b layer over a capacity buffer of C=8
    rows (decode), C=20 (a 256-token prefill bucket) and C=40 (512)."""
    import torch.nn.functional as F
    from repro_torch.kernels.expert_ffn import (expert_ffn_cuda,
                                                expert_ffn_plain)
    log("kernels: expert_ffn vs expert_ffn_plain on the card (64 experts, "
        "D=2048, F=1408)")
    E, D, Fd = 64, QWEN["D"], QWEN["F"]
    errs, timed = [], {}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        for C in (8, 20, 40):
            args = expert_ffn_args(torch, C, dtype)
            got = expert_ffn_cuda(*args)
            again = expert_ffn_cuda(*args)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError(f"expert_ffn C={C}: not bitwise equal "
                                     f"run to run")
            errs.append(compare(f"E={E} C={C} D={D} F={Fd} {dn}", got,
                                expert_ffn_plain(*args), dn, FFN_TOL))
            if dtype is torch.bfloat16:
                timed[C] = args
            del got, again, args

    def library(x, g, u, d):    # the closest torch.bmm chain
        return torch.bmm(F.silu(torch.bmm(x, g)) * torch.bmm(x, u), d)

    rows = {}
    for C, args in timed.items():
        el = args[0].element_size()
        nbytes = el * (3 * E * D * Fd + 2 * E * C * D)
        flops = 6 * E * C * D * Fd
        t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS["bfloat16"]
        rows[C] = r = dict(
            max_abs_err=max(errs),
            ms=time_ms(torch, lambda: expert_ffn_cuda(*args)),
            plain_ms=time_ms(torch, lambda: expert_ffn_plain(*args)),
            bound_ms=1e3 * max(t_b, t_o),
            bound_by="bytes" if t_b >= t_o else "operations",
            library_ms=time_ms(torch, lambda: library(*args)),
            shape=f"E={E} C={C} D={D} F={Fd} bf16 (library: silu(bmm) * "
                  f"bmm, then bmm)")
        log(f"  expert_ffn at C={C}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}, {nbytes / r['ms'] / 1e6:.0f} GB/s of the "
            f"bound's bytes), "
            f"library {r['library_ms']:.4f} ms")
        log(f"  expert_ffn's kernels at C={C} (torch.profiler, mean of 20 "
            f"calls, L2 warm):")
        for us, key in kernel_breakdown(torch, lambda: expert_ffn_cuda(*args)):
            log(f"    {us:9.2f} us  {key[:90]}")
    del timed
    gc.collect()
    torch.cuda.empty_cache()
    return rows[8]


def flash_bound_ms(S, H, Hkv, Dh, window, el, dtype_name, Dv=None):
    """Bytes: q, k, v and out once; operations: QK^T and PV over the
    (query, key) pairs this mask leaves visible.  ``Dv``: V's width where
    it is not the QK width Dh."""
    Dv = Dv or Dh
    i = np.arange(S)
    visible = int(np.minimum(i + 1, window).sum() if window
                  else (i + 1).sum())
    nbytes = el * (S * H * (Dh + Dv) + S * Hkv * (Dh + Dv))
    flops = 2 * visible * H * (Dh + Dv)
    t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype_name]
    return 1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def kernels_flash_prefill(torch):
    """Whole-prompt attention at the serial path's buckets (B=1, H=Hkv=16,
    Dh=128), causal, with and without the sliding window 6."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_prefill import (flash_prefill_cuda,
                                                   flash_prefill_plain)
    log("kernels: flash_prefill vs flash_prefill_plain on the card (B=1, "
        "H=Hkv=16, Dh=128)")
    H = Hkv = QWEN["H"]
    Dh = QWEN["Dh"]
    errs, timed = [], {}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        for S in (16, 200, 256, 512):
            for window in (0, 6):
                gen = torch.Generator(device="cuda").manual_seed(S + window)
                q, k, v = (torch.randn((1, S, h, Dh), generator=gen,
                                       device="cuda").to(dtype)
                           for h in (H, Hkv, Hkv))
                pos = torch.arange(S, dtype=torch.int32, device="cuda")
                kw = dict(causal=True, window=window)
                got = flash_prefill_cuda(q, k, v, pos, pos, **kw)
                again = flash_prefill_cuda(q, k, v, pos, pos, **kw)
                torch.cuda.synchronize()
                if not torch.equal(got, again):
                    raise AssertionError(f"flash_prefill S={S}: not bitwise "
                                         f"equal run to run")
                want = flash_prefill_plain(q, k, v, pos, pos, **kw)
                errs.append(compare(f"S={S} window {window} {dn}", got,
                                    want, dn, FLASH_TOL))
                if S >= 256 and not window and dtype is torch.bfloat16:
                    timed[S] = (q, k, v, pos)
    rows = {}
    for S, (q, k, v, pos) in timed.items():
        def library():
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=True, enable_gqa=True)

        def kernel():
            return flash_prefill_cuda(q, k, v, pos, pos)

        bound, by = flash_bound_ms(S, H, Hkv, Dh, 0, q.element_size(),
                                   "bfloat16")
        rows[S] = r = dict(
            max_abs_err=max(errs), ms=time_ms(torch, kernel),
            plain_ms=time_ms(torch, lambda: flash_prefill_plain(q, k, v, pos,
                                                                pos)),
            bound_ms=bound, bound_by=by, library_ms=time_ms(torch, library),
            shape=f"B=1 S={S} H=Hkv={H} Dh={Dh} causal bf16 (library: "
                  f"scaled_dot_product_attention)")
        log(f"  flash_prefill at S={S}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}), library {r['library_ms']:.4f} ms")
        log(f"  flash_prefill's kernels at S={S} (torch.profiler, mean of 20 "
            f"calls, L2 warm):")
        for us, key in kernel_breakdown(torch, kernel):
            log(f"    {us:9.2f} us  {key[:90]}")
    return rows[256]


FALCON = dict(d_inner=8192, N=16)


def ssm_case(torch, B, S, *, with_h0, dtype, seed):
    """falcon-mamba-7b's scan operands at full width, drawn as
    tests/test_kernels.py draws them: dt = softplus(z - 2), A = -exp(0.3
    z); h0 (the slot state) in the working type."""
    d, N = FALCON["d_inner"], FALCON["N"]
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    args = [(randn(B, S, d) * 0.1).to(dtype),
            torch.nn.functional.softplus(randn(B, S, d) - 2).to(dtype),
            -torch.exp(randn(d, N) * 0.3),
            (randn(B, S, N) * 0.2).to(dtype), (randn(B, S, N) * 0.2).to(dtype),
            (randn(B, d, N) * 0.5).to(dtype) if with_h0 else None]
    return args


def ssm_bound_ms(args, h_dtype=None, y_dtype=None):
    """Bytes: u, dt, A, B, C and h0 once, y and h_final once (f32, or the
    in-place mode's types); operations: ~7 f32 operations per (row, step,
    channel, state)."""
    u, _, A, Bm, _, h0 = args
    B, S, d = u.shape
    N = A.shape[1]
    el = u.element_size()
    h_el = 4 if h_dtype is None else h_dtype.itemsize
    y_el = 4 if y_dtype is None else y_dtype.itemsize
    nbytes = (2 * B * S * d * el + d * N * 4 + 2 * B * S * N * el
              + (0 if h0 is None else h0.numel() * h0.element_size())
              + B * S * d * y_el + B * d * N * h_el)
    flops = 7 * B * S * d * N
    t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS["float32"]
    return 1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def kernels_ssm_scan(torch):
    """The selective scan at the ssm path's shapes: a whole-prompt prefill
    of one row (d_inner 8192, N 16) at buckets 200, 256, 512 and 2048 from
    a zero state, and the decode step of 8 slots from their state, in the
    default mode (f32 y and h_final) and in the engine's in-place mode (the
    bf16 state written where it lies, y in bf16)."""
    from repro_torch.kernels.ssm_scan import ssm_scan_cuda, ssm_scan_plain
    log("kernels: ssm_scan vs ssm_scan_plain on the card (falcon-mamba-7b: "
        "d_inner 8192, N 16)")
    cases = [("prefill", 1, S, False) for S in (200, 256, 512, 2048)]
    cases.append(("decode", 8, 1, True))
    errs, timed = [], {}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        for i, (name, B, S, with_h0) in enumerate(cases):
            args = ssm_case(torch, B, S, with_h0=with_h0, dtype=dtype,
                            seed=40 + i)
            y, h = ssm_scan_cuda(*args)
            y2, h2 = ssm_scan_cuda(*args)
            torch.cuda.synchronize()
            if not (torch.equal(y, y2) and torch.equal(h, h2)):
                raise AssertionError(f"ssm_scan {name} S={S}: not bitwise "
                                     f"equal run to run")
            want_y, want_h = ssm_scan_plain(*args)
            for part, got, want in (("y", y, want_y), ("h_final", h, want_h)):
                errs.append(compare(f"{name} B={B} S={S} {part} {dn}", got,
                                    want, dn, SSM_TOL))
            if with_h0:
                errs += ssm_in_place(torch, args, dn)
            if dtype is torch.bfloat16:
                timed[(name, S)] = args
            del y, y2, h, h2, want_y, want_h
    rows = {}
    for (name, S), args in timed.items():
        bound, by = ssm_bound_ms(args)
        rows[(name, S)] = r = dict(
            max_abs_err=max(errs),
            ms=time_ms(torch, lambda: ssm_scan_cuda(*args)),
            # the plain loop at S = 2048 takes ~0.5 s a call
            plain_ms=(time_ms(torch, lambda: ssm_scan_plain(*args))
                      if S <= 512 else float("nan")),
            bound_ms=bound, bound_by=by, library_ms=None,
            shape=f"{name} B={args[0].shape[0]} S={S} d=8192 N=16 bf16 "
                  f"(library: none, no PyTorch call computes a selective "
                  f"scan)")
        log(f"  ssm_scan at {name} B={args[0].shape[0]} S={S}: kernel "
            f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
    # the decode step as the engine runs it: in place, y in bf16
    args = timed[("decode", 1)]
    state = args[5].clone()
    bf16 = torch.bfloat16
    bound, by = ssm_bound_ms(args, bf16, bf16)
    ms = time_ms(torch, lambda: ssm_scan_cuda(*args[:5], state, h_out=state,
                                              y_dtype=bf16))
    plain = time_ms(torch, lambda: ssm_scan_plain(
        *args[:5], state, h_out=state, y_dtype=bf16))
    log(f"  ssm_scan at decode B=8 S=1 in place (bf16 state, y in bf16): "
        f"kernel {ms:.4f} ms, plain {plain:.4f} ms, bound {bound:.4f} ms "
        f"({by}), library: none")
    prefill = timed[("prefill", 256)]
    for what, fn in (
            ("prefill B=1 S=256", lambda: ssm_scan_cuda(*prefill)),
            ("decode B=8 in place", lambda: ssm_scan_cuda(
                *args[:5], state, h_out=state, y_dtype=bf16))):
        log(f"  ssm_scan's kernels at {what} (torch.profiler, mean of 20 "
            f"calls, L2 warm):")
        for us, k in kernel_breakdown(torch, fn):
            log(f"    {us:9.2f} us  {k[:90]}")
    del timed, args, state, prefill
    gc.collect()
    torch.cuda.empty_cache()
    return rows[("prefill", 256)]


def ssm_in_place(torch, args, dn):
    """The decode step's in-place mode against the plain version's: the
    state written in its own type where it lies (its storage pointer
    unchanged), y in the inputs' type; bitwise equal run to run."""
    from repro_torch.kernels.ssm_scan import ssm_scan_cuda, ssm_scan_plain
    u, dt, A, Bm, Cm, h0 = args
    ys, states = [], []
    for _ in range(2):
        state = h0.clone()
        ptr = state.data_ptr()
        y, h = ssm_scan_cuda(u, dt, A, Bm, Cm, state, h_out=state,
                             y_dtype=u.dtype)
        if h.data_ptr() != ptr or state.data_ptr() != ptr:
            raise AssertionError("ssm_scan in place: the state moved")
        ys.append(y)
        states.append(state)
    torch.cuda.synchronize()
    if not (torch.equal(ys[0], ys[1]) and torch.equal(*states)):
        raise AssertionError("ssm_scan in place: not bitwise equal run to "
                             "run")
    want_state = h0.clone()
    want_y, _ = ssm_scan_plain(u, dt, A, Bm, Cm, want_state,
                               h_out=want_state, y_dtype=u.dtype)
    B = u.shape[0]
    # the state is the h_final of the default mode, cast: bitwise the plain
    # version's; y is the plain version's within the scan's tolerance, and
    # then one rounding to the state's type
    if not torch.equal(states[0], want_state):
        raise AssertionError("ssm_scan in place: state differs from the "
                             "plain version's")
    log(f"  decode B={B} in place: state bitwise the plain version's "
        f"({states[0].dtype}), storage unchanged")
    tol = SSM_TOL if u.dtype == torch.float32 else TOL
    return [compare(f"decode B={B} in place y {dn}", ys[0], want_y, dn,
                    tol)]


# -- phase 3, deepseek-v3's shapes ----------------------------------------------

def _row(errs, ms, plain_ms, bound, shape, library_ms=None):
    return dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                bound_ms=bound[0], bound_by=bound[1], library_ms=library_ms,
                shape=shape)


def _log_row(name, r):
    log(f"  {name} at {r['shape']}: kernel {r['ms']:.4f} ms, plain "
        f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
        f"({r['bound_by']})" + ("" if r["library_ms"] is None else
                                f", library {r['library_ms']:.4f} ms"))


def _free(torch):
    gc.collect()
    torch.cuda.empty_cache()


def kernels_mla(torch, S):
    """The kernels of the mla_* paths at deepseek-v3's shapes, each against
    its plain version in f32 and bf16, twice and bitwise equal; the bf16
    cases at the main path's shapes timed beside their bounds.  Returns
    {kernel: [rows]}."""
    mega_rows, route_rows = mla_megastep(torch, S)
    out = {"paged_attention": mla_paged(torch, S),
           "decode_megastep": mega_rows,
           "router_topk": route_rows,
           "flash_prefill": mla_flash(torch),
           "moe_fused": mla_moe_fused(torch, S),
           "expert_ffn": mla_expert_ffn(torch)}
    for name, rows in out.items():
        for r in rows:
            _log_row(name, r)
    return out


def mla_paged(torch, S):
    """Paged attention at the latent layout: Hkv = 1, G = 128, Da = 576,
    one pool as K and V, at the engine's context (512 positions) for a
    decode step (B=8) and a chunk step (B=40), over one 4090-position row
    (16 splits of 256), and windowed with an idle row.  In bf16 these run
    the tensor-core latent kernel."""
    from repro_torch.kernels.paged_attention import (paged_attention_cuda,
                                                     paged_attention_plain)
    W = DEEPSEEK
    log("kernels: paged_attention at deepseek-v3's latent layout (Hkv=1, "
        "G=128, Da=576, K = V one pool) vs its plain version")
    mb, nblk = S["max_blk"], S["num_blocks"] + 1
    cases = [
        # name, B, window, idle, max_len, max_blk, lens
        ("decode", S["max_batch"], 0, True, 512, mb, None),
        ("chunk step", S["chunk"] + S["max_batch"], 0, True, 512, mb, None),
        ("long row", 1, 0, False, 0, 256, [4090]),
        ("window 70", 3, 70, True, 0, mb, [500, 0, 131]),
    ]
    errs, timed = [], {}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        for i, (name, B, window, idle, max_len, max_blk, lens) in \
                enumerate(cases):
            args, n_valid = paged_case(
                torch, B=B, H=W["H"], Hkv=1, Dh=W["Dh"], bs=S["block_size"],
                nb=max(nblk, max_blk + 2), max_blk=max_blk, max_len=max_len,
                window=window, idle=idle, dtype=dtype, seed=60 + i,
                lens=lens, same=True)
            got = paged_attention_cuda(*args)
            again = paged_attention_cuda(*args)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError(f"paged_attention latent {name}: not "
                                     f"bitwise equal run to run")
            if idle and got[1].abs().max().item() != 0.0:
                raise AssertionError("paged_attention latent: idle row not 0")
            errs.append(compare(f"latent {name} B={B} ({n_valid} rows) {dn}",
                                got, paged_attention_plain(*args), dn))
            if dtype is torch.bfloat16 and name != "window 70":
                timed[name] = (args, n_valid, dn)
            del args, got, again
    rows = []
    for name, (args, n_valid, dn) in timed.items():
        B = args[0].shape[0]
        rows.append(_row(
            errs, time_ms(torch, lambda: paged_attention_cuda(*args)),
            time_ms(torch, lambda: paged_attention_plain(*args)),
            paged_bound_ms(args, n_valid, dn),
            f"{name} B={B} H=128 Hkv=1 Da=576 bf16, {n_valid} valid latent "
            f"rows (K = V)"))
        if name in ("decode", "chunk step"):
            log(f"  paged_attention's kernels at latent {name} B={B} "
                f"(torch.profiler, mean of 20 calls, L2 warm):")
            for us, k in kernel_breakdown(
                    torch, lambda: paged_attention_cuda(*args)):
                log(f"    {us:9.2f} us  {k[:90]}")
    del timed
    _free(torch)
    return rows


def mla_megastep(torch, S):
    """The megastep at deepseek-v3's latent layout (w_post (73728, 7168),
    E_log 256 + 32 redundant, top-8): a decode step (B=8), one with a
    window, masked and lost experts and a dead replica, and a chunk step
    (B=40).  bf16 holds the whole bank of 288 experts (25.4 GB); f32 a
    third of it (96 experts at offset 96, the rest foreign).  Returns its
    timed rows and its route stage's (``route_stage_row``)."""
    from repro_torch.kernels.decode_megastep import (decode_megastep_cuda,
                                                     decode_megastep_plain)
    W = DEEPSEEK
    log("kernels: decode_megastep at deepseek-v3's latent layout vs its "
        "plain version")
    cases = [
        ("decode", dict(B=S["max_batch"])),
        ("decode, window 64, masked 10/200, lost 5, dead replica of 1",
         dict(B=S["max_batch"], window=64, masked=(10, 200), lost=(5,),
              dead=(1,))),
        ("chunk step", dict(B=S["chunk"] + S["max_batch"])),
    ]
    errs, rows, route_rows = [], [], []
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        bank = (dict(e_local=W["E_log"] + W["R"], off=0)
                if dtype is torch.bfloat16 else dict(e_local=96, off=96))
        for i, (name, case) in enumerate(cases):
            args, kw, n_valid = megastep_case(torch, S, dtype=dtype,
                                              seed=70 + i, W=W, **bank,
                                              **case)
            y, h2, route = decode_megastep_cuda(*args, **kw,
                                                return_route=True)
            y2, h22 = decode_megastep_cuda(*args, **kw)
            torch.cuda.synchronize()
            if not (torch.equal(y, y2) and torch.equal(h2, h22)):
                raise AssertionError(f"decode_megastep latent {name}: not "
                                     f"bitwise equal run to run")
            B = args[0].shape[0]
            errs += check_megastep(f"latent {name} B={B} (bank "
                                   f"{kw['e_local']} at {args[16]})", args,
                                   kw, y, h2, route, dn)
            timed = dtype is torch.bfloat16 and name in MEGA_TIMED
            if timed:
                route_rows.append(route_stage_row(
                    torch, lambda: decode_megastep_cuda(*args, **kw), args,
                    kw, route, h2))
            del y, y2, h2, h22
            if timed:
                mega = lambda: decode_megastep_cuda(*args, **kw)  # noqa
                bound = megastep_bound_ms(args, kw, route, n_valid, dn)
                rows.append(_row(
                    errs, time_ms(torch, mega),
                    time_ms(torch, lambda: decode_megastep_plain(*args,
                                                                 **kw)),
                    bound[:2],
                    f"B={B} D=7168 H=128 Hkv=1 Da=576 E=256+32 F=2048 "
                    f"Fs=2048 k=8 cap={kw['cap']} bf16, {n_valid} valid "
                    f"latent rows, {bound[2]} experts / {bound[3]} slots "
                    f"live"))
                log(f"  decode_megastep's launches at latent B={B}, one call "
                    f"in order (torch.profiler; route_slots is the route "
                    f"stage):")
                for us, key in kernel_sequence(torch, mega):
                    log(f"    {us:9.2f} us  {key[:90]}")
            del args, route
            _free(torch)
    return rows, route_rows


def mla_flash(torch):
    """Whole-prompt attention at MLA's widths (QK 192, V 128, H = Hkv =
    128) at the serial path's buckets, with and without window 6."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_prefill import (flash_prefill_cuda,
                                                   flash_prefill_plain)
    H, Dq, Dv = DEEPSEEK["H"], 192, 128
    log("kernels: flash_prefill at deepseek-v3's MLA widths (B=1, H=Hkv="
        "128, Dq=192, Dv=128) vs its plain version")
    errs, timed = [], {}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        for Sq in (256, 512):
            for window in (0, 6):
                gen = torch.Generator(device="cuda").manual_seed(Sq + window)
                q, k, v = (torch.randn((1, Sq, H, d), generator=gen,
                                       device="cuda").to(dtype)
                           for d in (Dq, Dq, Dv))
                pos = torch.arange(Sq, dtype=torch.int32, device="cuda")
                kw = dict(causal=True, window=window)
                got = flash_prefill_cuda(q, k, v, pos, pos, **kw)
                again = flash_prefill_cuda(q, k, v, pos, pos, **kw)
                torch.cuda.synchronize()
                if not torch.equal(got, again):
                    raise AssertionError(f"flash_prefill MLA S={Sq}: not "
                                         f"bitwise equal run to run")
                errs.append(compare(
                    f"MLA S={Sq} window {window} {dn}", got,
                    flash_prefill_plain(q, k, v, pos, pos, **kw), dn,
                    FLASH_TOL))
                if not window and dtype is torch.bfloat16:
                    timed[Sq] = (q, k, v, pos)
    rows = []
    for Sq, (q, k, v, pos) in timed.items():
        def library():
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=True)

        def kernel():
            return flash_prefill_cuda(q, k, v, pos, pos)

        rows.append(_row(
            errs, time_ms(torch, kernel),
            time_ms(torch, lambda: flash_prefill_plain(q, k, v, pos, pos)),
            flash_bound_ms(Sq, H, H, Dq, 0, q.element_size(), "bfloat16",
                           Dv=Dv),
            f"B=1 S={Sq} H=Hkv=128 Dq=192 Dv=128 causal bf16 (library: "
            f"scaled_dot_product_attention)", time_ms(torch, library)))
        log(f"  flash_prefill's kernels at MLA S={Sq} (torch.profiler, mean "
            f"of 20 calls, L2 warm):")
        for us, key in kernel_breakdown(torch, kernel):
            log(f"    {us:9.2f} us  {key[:90]}")
    del timed
    _free(torch)
    return rows


def mla_moe_fused(torch, S):
    """The fused MoE at deepseek-v3's widths: T = 8 and 40 tokens routed
    over 288 physical experts, top-8, D=7168, F=2048; bf16 with the whole
    bank, f32 with the 96 experts at offset 96 (the rest foreign)."""
    from repro_torch.kernels.moe_fused import moe_fused_cuda, moe_fused_plain
    from repro_torch.models.moe import capacity
    W = DEEPSEEK
    E = W["E_log"] + W["R"]
    log("kernels: moe_fused at deepseek-v3's widths vs its plain version")
    errs, rows = [], []
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        e_local, off = (E, 0) if dtype is torch.bfloat16 else (96, 96)
        for T in (S["max_batch"], S["chunk"] + S["max_batch"]):
            args, kw = moe_case(
                torch, T=T, E=E, e_local=e_local, off=off, D=W["D"],
                Fd=W["F"], k=W["k"], cap=capacity(T * W["k"], E, 1.25),
                dtype=dtype, seed=80 + T, direct=True)
            got = moe_fused_cuda(*args, **kw)
            again = moe_fused_cuda(*args, **kw)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError(f"moe_fused deepseek T={T}: not bitwise "
                                     f"equal run to run")
            _, _, live_e, live_s = moe_bound_ms(args, kw, dn)
            errs.append(compare(
                f"deepseek T={T} bank {e_local} at {off} ({live_e} experts, "
                f"{live_s} slots) {dn}", got, moe_fused_plain(*args, **kw),
                dn))
            del got, again
            if dtype is torch.bfloat16:
                bound, by, live_e, live_s = moe_bound_ms(args, kw, dn)
                rows.append(_row(
                    errs, time_ms(torch, lambda: moe_fused_cuda(*args, **kw)),
                    time_ms(torch, lambda: moe_fused_plain(*args, **kw)),
                    (bound, by),
                    f"T={T} D=7168 F=2048 E=288 k=8 cap={kw['cap']} bf16, "
                    f"{live_e} experts / {live_s} slots live"))
                moe_breakdown(torch, lambda: moe_fused_cuda(*args, **kw), T)
            del args
            _free(torch)
    return rows


def mla_expert_ffn(torch):
    """The serial path's expert FFN at deepseek-v3's widths: 288 experts
    (bf16; 96 in f32) of D=7168, F=2048 over capacity buffers of C=8 (a
    decode step), 9 and 18 (prefill buckets 256 and 512)."""
    import torch.nn.functional as F
    from repro_torch.kernels.expert_ffn import (expert_ffn_cuda,
                                                expert_ffn_plain)
    W = DEEPSEEK
    D, Fd = W["D"], W["F"]
    log("kernels: expert_ffn at deepseek-v3's widths vs its plain version")

    def library(x, g, u, d):    # the closest torch.bmm chain
        return torch.bmm(F.silu(torch.bmm(x, g)) * torch.bmm(x, u), d)

    errs, rows = [], []
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        E = W["E_log"] + W["R"] if dtype is torch.bfloat16 else 96
        for C in ((8,) if dtype is torch.float32 else (8, 9, 18)):
            args = expert_ffn_args(torch, C, dtype, E=E, W=W)
            got = expert_ffn_cuda(*args)
            again = expert_ffn_cuda(*args)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError(f"expert_ffn deepseek C={C}: not "
                                     f"bitwise equal run to run")
            errs.append(compare(f"deepseek E={E} C={C} D={D} F={Fd} {dn}",
                                got, expert_ffn_plain(*args), dn, FFN_TOL))
            del got, again
            if dtype is torch.bfloat16:
                el = args[0].element_size()
                nbytes = el * (3 * E * D * Fd + 2 * E * C * D)
                flops = 6 * E * C * D * Fd
                t_b, t_o = (nbytes / HBM_BYTES_PER_S,
                            flops / PEAK_FLOPS["bfloat16"])
                rows.append(_row(
                    errs, time_ms(torch, lambda: expert_ffn_cuda(*args)),
                    time_ms(torch, lambda: expert_ffn_plain(*args)),
                    (1e3 * max(t_b, t_o),
                     "bytes" if t_b >= t_o else "operations"),
                    f"E={E} C={C} D={D} F={Fd} bf16 (library: silu(bmm) * "
                    f"bmm, then bmm)", time_ms(torch, lambda: library(*args))))
            del args
            _free(torch)
    return rows


# -- phase 4: model, card against CPU -------------------------------------------

def _map(tree, fn):
    return {k: _map(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def phase_model(torch, seed):
    """qwen2-moe-a2.7b and deepseek-v3 (MLA) at full width, 2 layers,
    f32, card against CPU; then falcon-mamba-7b."""
    import dataclasses
    from repro_torch.configs import get_config
    model_moe(torch, dataclasses.replace(
        get_config(QWEN_ARCH), num_layers=2, moe_impl="fused"), seed,
        "qwen2-moe-a2.7b full width, 2 layers")
    ds = get_config("deepseek-v3")
    # a 288-expert f32 layer is 50.7 GB: this phase alone cuts the bank
    # (its routing keeps top-8); every width stays
    cut = dataclasses.replace(ds, num_layers=2, moe_impl="fused",
                              moe=dataclasses.replace(
                                  ds.moe, first_k_dense=1, num_experts=16,
                                  num_redundant_experts=4))
    model_moe(torch, cut, seed,
              f"deepseek-v3 full width (d_model {ds.d_model}, "
              f"{ds.num_heads} MLA heads, latent "
              f"{ds.mla.kv_lora_rank} + {ds.mla.qk_rope_head_dim}, dense "
              f"d_ff {ds.moe.dense_d_ff}, expert d_ff "
              f"{ds.moe.expert_d_ff}, vocab {ds.vocab_size}), 2 layers (1 "
              f"dense + 1 MoE), bank cut from {ds.moe.num_experts} + "
              f"{ds.moe.num_redundant_experts} to 16 + 4 experts, top-"
              f"{ds.moe.top_k} kept")
    model_ssm(torch, seed)


def model_moe(torch, base, seed, what):
    """One attention+MoE config, card against CPU: a chunk step and a
    decode step per decode implementation, then the serial prefill."""
    import dataclasses
    from repro_torch.kernels import launches
    from repro_torch.models.model import Model
    bs, nblk, max_blk, width, batch = 16, 16, 4, 32, 8
    trash = nblk
    t0 = time.perf_counter()
    p_cpu = Model(base, torch.float32, device="cpu").init(seed)
    p_card = _map(p_cpu, lambda t: t.to("cuda"))
    log(f"model: {what}, f32; weights from seed {seed} in "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(seed)
    # chunk: request A = 20 prompt tokens (blocks 0-1), B = 9 (block 2),
    # rows 29-31 idle; decode: A in slot 0, B in slot 3, others idle
    lens, blocks = {"a": 20, "b": 9}, {"a": [0, 1], "b": [2]}
    prompts = {n: rng.integers(0, base.vocab_size, L)
               for n, L in lens.items()}
    tok = np.zeros(width, np.int32)
    tables = np.zeros((width, max_blk), np.int32)
    seq = np.zeros(width, np.int32)
    wb = np.full(width, trash, np.int32)
    wo = np.zeros(width, np.int32)
    row, last = 0, {}
    for n in ("a", "b"):
        for pos in range(lens[n]):
            tok[row] = prompts[n][pos]
            tables[row, :len(blocks[n])] = blocks[n]
            seq[row], wb[row], wo[row] = pos + 1, blocks[n][pos // bs], \
                pos % bs
            last[n] = row
            row += 1
    chunk_page = dict(tables=tables, seq_lens=seq, write_bid=wb,
                      write_off=wo)
    rows = [last["a"], last["b"]]
    slots = {"a": 0, "b": 3}
    live = [slots["a"], slots["b"]]
    card_logits = {}
    for impl in IMPLS:
        cfg = dataclasses.replace(base, decode_impl=impl)
        cpu = Model(cfg, torch.float32, device="cpu")
        card = Model(cfg, torch.float32, device="cuda")
        caches = {"cpu": cpu.init_paged_cache(width, nblk, bs),
                  "cuda": card.init_paged_cache(width, nblk, bs)}
        models = {"cpu": (cpu, p_cpu), "cuda": (card, p_card)}

        def both(tokens, page):
            res = {}
            for dev, (m, p) in models.items():
                tt = torch.from_numpy(tokens).to(dev)
                pg = {k: torch.from_numpy(v).to(dev) for k, v in page.items()}
                logits, _ = m.decode_step_paged(p, caches[dev], tt, pg)
                res[dev] = logits.float().cpu().numpy()
            err = float(np.abs(res["cuda"] - res["cpu"]).max())
            if not np.isfinite(res["cuda"]).all() or err > MODEL_LOGIT_ATOL:
                raise AssertionError(f"model {impl} logits: card vs CPU "
                                     f"max_abs_err {err} > "
                                     f"{MODEL_LOGIT_ATOL}")
            return res, err

        launches.clear()
        res_c, err_c = both(tok, chunk_page)
        greedy = res_c["cpu"][rows].argmax(-1)
        if not (res_c["cuda"][rows].argmax(-1) == greedy).all():
            raise AssertionError(f"model {impl}: chunk-step greedy tokens "
                                 f"differ")
        dtok = np.zeros(batch, np.int32)
        dt = np.zeros((batch, max_blk), np.int32)
        ds = np.zeros(batch, np.int32)
        dwb = np.full(batch, trash, np.int32)
        dwo = np.zeros(batch, np.int32)
        for n, g in zip(("a", "b"), greedy):
            s, pos = slots[n], lens[n]
            dtok[s] = g
            dt[s, :len(blocks[n])] = blocks[n]
            ds[s], dwb[s], dwo[s] = pos + 1, blocks[n][pos // bs], pos % bs
        res_d, err_d = both(dtok, dict(tables=dt, seq_lens=ds, write_bid=dwb,
                                       write_off=dwo))
        if not (res_d["cuda"][live].argmax(-1)
                == res_d["cpu"][live].argmax(-1)).all():
            raise AssertionError(f"model {impl}: decode-step greedy tokens "
                                 f"differ")
        used = [k for k, paths in KERNEL_PATH.items() if impl in paths]
        if min(launches.get(k, 0) for k in used) <= 0:
            raise AssertionError(f"model {impl}: kernel launches "
                                 f"{dict(launches)}")
        log(f"  {impl}: logits card vs CPU: chunk max_abs_err {err_c:.3e}, "
            f"decode {err_d:.3e} (atol {MODEL_LOGIT_ATOL:g}); greedy tokens "
            f"equal ({greedy.tolist()} -> "
            f"{res_d['cpu'][live].argmax(-1).tolist()}); launches "
            f"{dict(launches)}")
        card_logits[impl] = (res_c["cuda"], res_d["cuda"])
        del models, cpu, card, caches
        gc.collect()
        torch.cuda.empty_cache()
    (mc, md), (cc, cd) = card_logits["megakernel"], card_logits["composed"]
    err = max(float(np.abs(mc - cc).max()), float(np.abs(md - cd).max()))
    same = ((mc[rows].argmax(-1) == cc[rows].argmax(-1)).all()
            and (md[live].argmax(-1) == cd[live].argmax(-1)).all())
    log(f"  megakernel vs composed on the card: max_abs_err {err:.3e} (atol "
        f"{MODEL_LOGIT_ATOL:g}); greedy tokens {'equal' if same else 'DIFFER'}")
    if err > MODEL_LOGIT_ATOL or not same:
        raise AssertionError("model: megakernel and composed disagree")
    model_prefill(torch, base, p_cpu, p_card, seed)
    del p_card, p_cpu
    gc.collect()
    torch.cuda.empty_cache()


def model_prefill(torch, base, p_cpu, p_card, seed):
    """The serial path's model calls, card against CPU: one whole-prompt
    prefill of 200 tokens (bucket 256) with the dense-scatter MoE, its
    K/V (MLA: latent) rows installed into the pools, then one decode step
    on top."""
    import dataclasses
    from repro_torch.kernels import launches
    from repro_torch.models.model import Model
    from repro_torch.serving import cache_ops
    from repro_torch.serving.executor import next_bucket
    from repro_torch.serving.kvcache import padded_block_ids
    cfg = dataclasses.replace(base, moe_impl="gather_psum",
                              decode_impl="composed")
    bs, nblk, max_blk, batch, n = 16, 20, 16, 8, 200
    bucket = next_bucket(n, 512)
    blocks = list(range(nblk - 1, nblk - 1 - (n + bs) // bs, -1))
    bids = padded_block_ids(blocks, bucket // bs, nblk)
    rng = np.random.default_rng(seed + 1)
    tokens = np.zeros((1, bucket), np.int32)
    tokens[0, :n] = rng.integers(0, cfg.vocab_size, n)
    page = dict(tables=np.zeros((batch, max_blk), np.int32),
                seq_lens=np.zeros(batch, np.int32),
                write_bid=np.full(batch, nblk, np.int32),
                write_off=np.zeros(batch, np.int32))
    page["tables"][0, :len(blocks)] = blocks
    page["seq_lens"][0] = n + 1
    page["write_bid"][0], page["write_off"][0] = blocks[n // bs], n % bs
    launches.clear()
    res = {}
    for dev, p in (("cpu", p_cpu), ("cuda", p_card)):
        m = Model(cfg, torch.float32, device=dev)
        cache = m.init_paged_cache(batch, nblk, bs)
        axes = cache_ops.infer_paged_axes(m, nblk, bs)
        last, raw = m.prefill_paged(p, {
            "tokens": torch.from_numpy(tokens).to(dev),
            "lengths": torch.tensor([n], dtype=torch.int32, device=dev)})
        cache_ops.install_prefill(cache, raw, axes, bids, 0)
        last = last.float().cpu().numpy()
        if dev == "cpu":
            first = int(last[0].argmax())
        tok = torch.zeros(batch, dtype=torch.int32, device=dev)
        tok[0] = first
        logits, _ = m.decode_step_paged(
            p, cache, tok, {k: torch.from_numpy(v).to(dev)
                            for k, v in page.items()})
        rows = {f"{g}/{key}": pool[:, blocks].float().cpu().numpy()
                for g in cache for key, pool in cache[g].items()}
        res[dev] = (last, rows, logits.float().cpu().numpy()[:1])
        del m, cache, raw
    (lc, rc, dc), (lg, rg, dg) = res["cpu"], res["cuda"]
    errs = {"last logits": float(np.abs(lg - lc).max()),
            "installed " + "/".join(sorted({k.split("/")[1] for k in rc})):
                max(float(np.abs(rg[k] - rc[k]).max()) for k in rc),
            "decode logits": float(np.abs(dg - dc).max())}
    greedy = (int(lg[0].argmax()) == first
              and int(dg[0].argmax()) == int(dc[0].argmax()))
    counts = {k: launches.get(k, 0) for k in ("flash_prefill", "expert_ffn",
                                              "paged_attention")}
    log(f"  serial prefill ({n} tokens, bucket {bucket}, dense-scatter "
        f"MoE), card vs CPU: " + ", ".join(f"{k} max_abs_err {v:.3e}"
                                          for k, v in errs.items())
        + f" (atol {MODEL_LOGIT_ATOL:g}); greedy tokens "
        f"{'equal' if greedy else 'DIFFER'} ({first} -> "
        f"{int(dc[0].argmax())}); launches {counts}")
    if max(errs.values()) > MODEL_LOGIT_ATOL or not greedy \
            or not all(np.isfinite(lg).ravel()):
        raise AssertionError("model: the serial prefill disagrees")
    if min(counts.values()) <= 0:
        raise AssertionError(f"model: serial prefill launches {counts}")


def model_ssm(torch, seed):
    """The ssm path's model calls, card against CPU: falcon-mamba-7b at
    full width, 2 layers, f32; one whole-prompt prefill of 200 tokens at
    bucket 256, its final state installed into slot 2 of 8, then two
    greedy decode steps."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels import launches
    from repro_torch.models.model import Model
    from repro_torch.serving import cache_ops
    from repro_torch.serving.executor import next_bucket
    cfg = dataclasses.replace(get_config("falcon-mamba-7b"), num_layers=2)
    batch, nblk, bs, slot, n = 8, 4, 16, 2, 200
    bucket = next_bucket(n, 512)
    t0 = time.perf_counter()
    p_cpu = Model(cfg, torch.float32, device="cpu").init(seed)
    p_card = _map(p_cpu, lambda t: t.to("cuda"))
    log(f"model: falcon-mamba-7b full width, 2 layers, f32; weights from "
        f"seed {seed} in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(seed + 2)
    tokens = np.zeros((1, bucket), np.int32)
    tokens[0, :n] = rng.integers(0, cfg.vocab_size, n)
    page = dict(tables=np.zeros((batch, 1), np.int32),
                seq_lens=np.zeros(batch, np.int32),
                write_bid=np.full(batch, nblk, np.int32),
                write_off=np.zeros(batch, np.int32))
    launches.clear()
    res = {}
    for dev, p in (("cpu", p_cpu), ("cuda", p_card)):
        m = Model(cfg, torch.float32, device=dev)
        cache = m.init_paged_cache(batch, nblk, bs)
        axes = cache_ops.infer_paged_axes(m, nblk, bs)
        last, raw = m.prefill_paged(p, {
            "tokens": torch.from_numpy(tokens).to(dev),
            "lengths": torch.tensor([n], dtype=torch.int32, device=dev)})
        # a state-only cache: no pool rows, so every block id is trash
        cache_ops.install_prefill(cache, raw, axes,
                                  np.full(bucket // bs, nblk), slot)
        # a copy: on the CPU .float().cpu() is the cache itself, which
        # the decode steps below update in place
        state = {k: v[:, slot].float().cpu().clone().numpy()
                 for k, v in cache["layers"].items()}
        logits = [last.float().cpu().numpy()[0]]
        if dev == "cpu":
            greedy = [int(logits[0].argmax())]
        for step in range(2):
            tok = torch.zeros(batch, dtype=torch.int32, device=dev)
            tok[slot] = greedy[step]
            page["seq_lens"][slot] = n + 1 + step
            out, _ = m.decode_step_paged(
                p, cache, tok, {k: torch.from_numpy(v).to(dev)
                                for k, v in page.items()})
            logits.append(out.float().cpu().numpy()[slot])
            if dev == "cpu":
                greedy.append(int(logits[-1].argmax()))
        res[dev] = (logits, state)
        del m, cache, raw
    (lc, sc), (lg, sg) = res["cpu"], res["cuda"]
    err = max(float(np.abs(a - b).max()) for a, b in zip(lg, lc))
    atol, rtol = STATE_TOL
    state_err = {k: float(np.abs(sg[k] - sc[k]).max()) for k in sc}
    state_ok = all(np.allclose(sg[k], sc[k], atol=atol, rtol=rtol)
                   for k in sc)
    same = [int(a.argmax()) for a in lg] == greedy
    count = launches.get("ssm_scan", 0)
    log(f"  ssm prefill ({n} tokens, bucket {bucket}) + 2 decode steps, "
        f"card vs CPU: logits max_abs_err {err:.3e} (atol "
        f"{MODEL_LOGIT_ATOL:g}); installed state max_abs_err " + ", ".join(
            f"{k} {v:.3e}" for k, v in state_err.items())
        + f" (atol {atol:g}, rtol {rtol:g}); greedy tokens "
        f"{'equal' if same else 'DIFFER'} ({greedy}); launches "
        f"{{'ssm_scan': {count}}}")
    if err > MODEL_LOGIT_ATOL or not state_ok or not same \
            or not all(np.isfinite(a).all() for a in lg):
        raise AssertionError("model: the ssm prefill and decode disagree")
    if count != 3 * cfg.num_layers:   # one a layer, on the card's calls
        raise AssertionError(f"model: ssm_scan launches {count}")
    del p_card, p_cpu
    gc.collect()
    torch.cuda.empty_cache()


# -- phase 5: engine --------------------------------------------------------------

def _prompts(vocab, seed):
    """Four prompts of 128-256 tokens, then four more that each share the
    leading 64 tokens (4 blocks) of one of the first four."""
    rng = np.random.default_rng(seed)
    first = [list(map(int, rng.integers(0, vocab, int(n))))
             for n in rng.integers(128, 257, 4)]
    later = [p[:64] + list(map(int, rng.integers(0, vocab, int(n) - 64)))
             for p, n in zip(first, rng.integers(128, 257, 4))]
    return first, later


def _serve(torch, eng, vocab, seed, new_tokens, on_step=None):
    """Serve the 8 prompts (the later 4 after two steps) to the end;
    ``on_step(eng)`` runs after every step."""
    first, later = _prompts(vocab, seed)
    reqs = [eng.submit(p, new_tokens) for p in first]
    steps = []      # (seconds, new tokens, prefill tokens, recovered)
    computed = lambda: eng.prefill_stats()[  # noqa: E731
        "prefill_tokens_computed"]

    def recoveries():   # a background role switch's step is one too
        return len(eng.reports) + len(eng.background_reports)

    def one():
        n0 = sum(len(r.output_tokens) for r in eng.all_requests)
        c0 = computed()
        r0 = recoveries()
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        if on_step is not None:
            on_step(eng)
        steps.append((time.perf_counter() - t0,
                      sum(len(r.output_tokens) for r in eng.all_requests)
                      - n0, computed() - c0, recoveries() > r0))

    t_all = time.perf_counter()
    one()
    one()
    reqs += [eng.submit(p, new_tokens) for p in later]
    for _ in range(2000):
        if not eng.unfinished:
            break
        one()
    wall = time.perf_counter() - t_all
    dec = [(s, n) for s, n, c, rec in steps if c == 0 and not rec and n]
    tok_s = sum(n for _, n in dec) / max(sum(s for s, _ in dec), 1e-9)
    total = sum(len(r.output_tokens) for r in reqs)
    return reqs, dict(steps=len(steps), wall_s=wall, out_tokens=total,
                      e2e_tok_s=total / wall, decode_tok_s=tok_s,
                      decode_steps=len(dec))


def _trace(torch, fn):
    """Run ``fn`` under ``torch.profiler`` (device activity only, so the
    host pays little for it); print the kernels that took the most
    device time and the device's busy share of the wall time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if e.self_device_time_total > 0), reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    log(f"  trace: device busy {busy:.3f} s of {wall:.3f} s wall "
        f"({100 * busy / wall:.1f}%); {sum(r[1] for r in rows)} device "
        f"ops; top by device time:")
    for us, n, key in rows[:15]:
        log(f"    {us / 1e3:10.2f} ms {n:7d}x  {key[:100]}")
    # the rows PERF.md's attention, scan and copy figures read
    log("  of which attention, the scan and copies:")
    for us, n, key in rows:
        if any(k in key for k in ("paged::", "scan_kernel", "step_kernel",
                                  "copy", "Memcpy")):
            log(f"    {us / 1e3:10.2f} ms {n:7d}x  {key[:100]}")
    return out


def phase_engine(torch, seed, layers, paths, profile=False):
    """Serve each path twice, without and with a fault (``disagg``: three
    times).  The paths of one architecture and depth share one workdir
    (the first writes ``weights.npz``, the others load it), removed before
    the next group writes its own.  Returns the kernels' launch counts,
    each summed over the paths it runs on."""
    log(f"engine: before the first build, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated on the "
        f"card")
    counts, rates, streams = {}, {}, {}
    groups, group_of = {}, {}
    for p in paths:
        group_of[p] = (PATH_ARCH.get(p, QWEN_ARCH), PATH_LAYERS.get(p, layers))
        groups.setdefault(group_of[p], []).append(p)
    for (arch, depth), group in groups.items():
        workdir = ROOT / "build" / f"smoke_engine_{arch}_{depth}"
        shutil.rmtree(workdir, ignore_errors=True)
        try:
            cfg = engine_config(arch, depth)
            for path in group:
                serve = serve_disagg if path == "disagg" else serve_path
                path_counts, rates[path], streams[path] = serve(
                    torch, cfg, path, workdir, seed, profile)
                for k, v in path_counts.items():
                    counts[k] = counts.get(k, 0) + v
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
    for path, (clean, fault) in rates.items():
        log(f"engine {path}: decode tokens/s "
            f"{clean['decode_tok_s']:.3f} without the fault, "
            f"{fault['decode_tok_s']:.3f} with it; end-to-end tokens/s "
            f"{clean['e2e_tok_s']:.3f} and {fault['e2e_tok_s']:.3f}")
    # bf16 rounds in another order on each path, so greedy streams may
    # part; the f32 model phase is where tokens must match
    for other in streams:
        base = "mla_composed" if other.startswith("mla") else "composed"
        if (other in (base, "ssm") or base not in streams
                or group_of[other] != group_of[base]):
            continue
        pairs = list(zip(streams[other], streams[base]))
        same = sum(a == b for m, c in pairs for a, b in zip(m, c))
        prefix = sum(next((i for i, (a, b) in enumerate(zip(m, c))
                           if a != b), min(len(m), len(c)))
                     for m, c in pairs)
        log(f"engine: the {other} run shares {same} of "
            f"{sum(len(c) for c in streams[base])} greedy output "
            f"tokens with the {base} run, position by position "
            f"({prefix} in the requests' common prefixes; not checked)")
    return counts


def engine_config(arch, layers):
    """qwen2-moe-a2.7b at full width and depth ``layers`` (all 24 by
    default); deepseek-v3 at full width with its depth cut from 61 to its
    3 dense layers and 1 MoE layer; falcon-mamba-7b whole (width and all
    64 layers)."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if cfg.attention_type == "mla":
        depth = cfg.moe.first_k_dense + 1
        log(f"engine: depth cut from {cfg.num_layers} to {depth} layers "
            f"({cfg.moe.first_k_dense} dense + 1 MoE), width kept: at full "
            f"width one MoE layer holds 25.4 GB of experts, and the "
            f"start-up file is ~33 GB of the 45 GiB a run may write")
        layers = depth
    if cfg.moe is None:
        mb = cfg.mamba
        log(f"engine: {cfg.name}: {cfg.num_layers} Mamba layers, d_model "
            f"{cfg.d_model}, d_inner {mb.expand * cfg.d_model}, d_state "
            f"{mb.d_state}, d_conv {mb.d_conv}, dt_rank "
            f"{mb.resolved_dt_rank(cfg.d_model)}, vocab {cfg.vocab_size}; "
            f"full width and depth")
        return cfg
    if layers != cfg.num_layers and cfg.attention_type != "mla":
        log(f"engine: depth cut from {cfg.num_layers} to {layers} layers, "
            f"width kept (start-up writes ~1.2 GB of checkpoint a layer)")
    cfg = dataclasses.replace(cfg, num_layers=layers)
    m = cfg.moe
    heads = (f"{cfg.num_heads} MLA heads (q rank {cfg.mla.q_lora_rank}, "
             f"latent {cfg.mla.kv_lora_rank} + rope "
             f"{cfg.mla.qk_rope_head_dim}, v {cfg.mla.v_head_dim})"
             if cfg.attention_type == "mla"
             else f"{cfg.num_heads}x{cfg.head_dim} heads")
    log(f"engine: {cfg.name}: {cfg.num_layers} layers "
        f"({m.first_k_dense} dense of d_ff {m.dense_d_ff}), d_model "
        f"{cfg.d_model}, {heads}, "
        f"{m.num_experts}+{m.num_redundant_experts} experts of d_ff "
        f"{m.expert_d_ff}, {m.num_shared_experts} shared, top-{m.top_k}, "
        f"vocab {cfg.vocab_size}")
    return cfg


def host_memory() -> str:
    """The host's MemTotal and MemAvailable, from /proc/meminfo."""
    try:
        info = dict(line.split(":", 1) for line in
                    Path("/proc/meminfo").read_text().splitlines())
    except OSError:
        return "host memory: /proc/meminfo unreadable"
    gib = {k: int(info[k].split()[0]) / 2**20
           for k in ("MemTotal", "MemAvailable") if k in info}
    return "host " + ", ".join(f"{k} {v:.1f} GiB" for k, v in gib.items())


def make_engine(torch, cfg, path, workdir, seed, policy):
    """One engine of ``path`` (2 attention ranks, bf16) in ``workdir``;
    prints its start-up, which must write no per-rank shard file."""
    from repro_torch.serving.engine import EngineConfig, InferenceEngine
    t0 = time.perf_counter()
    ec = dict(mode="collocated", num_dp=2, max_batch=8, max_seq=512,
              block_size=16, num_blocks=256, seed=seed, workdir=str(workdir),
              policy=policy)
    ec.update(PATHS[path])
    eng = InferenceEngine(cfg, EngineConfig(**ec))
    files = {str(f.relative_to(workdir)): f.stat().st_size
             for f in workdir.rglob("*") if f.is_file()}
    disk = sum(files.values())
    shards = [f for f in files if Path(f).name.startswith("expert_shard_")]
    if shards:
        raise AssertionError(f"engine {path}: start-up wrote shard files "
                             f"{shards}")
    log(f"  engine up in {time.perf_counter() - t0:.1f} s; {eng.dtype} "
        f"weights "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card "
        f"(peak {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB); "
        f"start-up files {disk / 1e9:.2f} GB on disk ("
        + ", ".join(f"{k} {v / 1e9:.2f} GB" for k, v in files.items()
                    if v > 1e6)
        + f", no expert_shard_*.npz); {host_memory()}; "
        f"moe_impl {eng.cfg.moe_impl!r}; init_timings " + json.dumps(
            {k: round(v, 4) for k, v in eng.init_timings.items()}))
    return eng


def serve_path(torch, cfg, path, workdir, seed, profile):
    """One engine path: 8 requests without a fault, then with an L6 fault
    on physical 1 mid-step at step 6 (``attn+moe`` on an MoE model, where
    the lost experts are masked; ``attn`` on the ssm path), revived in
    place.  Returns (launch counts of the faulted run, (clean, fault)
    rates, the clean run's output streams)."""
    from repro_torch.core.fault_codes import Severity
    from repro_torch.core.weights import RecoveryPolicy
    from repro_torch.kernels import launches
    new_tokens = 32

    def make():
        return make_engine(torch, cfg, path, workdir, seed,
                           RecoveryPolicy(allow_role_switch=False))

    log(f"engine: path {path!r}: " + json.dumps(PATHS[path]))
    eng = make()
    serve = lambda: _serve(torch, eng, cfg.vocab_size,  # noqa: E731
                           seed, new_tokens)
    reqs, clean = _trace(torch, serve) if profile else serve()
    if any(r.state.value != "finished" for r in reqs) or eng.reports:
        raise AssertionError(f"engine {path} (no fault): not every request "
                             f"finished")
    streams = [list(r.output_tokens) for r in reqs]
    log("  no fault: " + json.dumps(
        {k: round(v, 3) for k, v in clean.items()}))
    del eng, reqs
    gc.collect()
    torch.cuda.empty_cache()

    eng = make()
    moe = cfg.moe is not None
    eng.injector.schedule(6, 1, severity=Severity.L6,
                          component="attn+moe" if moe else "attn",
                          mid_step=True)
    launches.clear()
    reqs, fault = _serve(torch, eng, cfg.vocab_size, seed, new_tokens)
    path_counts = dict(launches)
    log("  with fault: " + json.dumps(
        {k: round(v, 3) for k, v in fault.items()}))
    states = [r.state.value for r in reqs]
    if any(s != "finished" for s in states):
        raise AssertionError(f"engine {path} (fault): requests {states}")
    if not eng.reports:
        raise AssertionError(f"engine {path}: the fault was not handled")
    rep = eng.reports[0]
    log(f"  recovery: {rep.summary()}")
    log("  recovery timings " + json.dumps(
        {k: round(v, 6) for k, v in rep.timings.items()}))
    if moe:
        # rank 1 held the upper half of the physical slots; the redundant
        # slots replicate the first logicals, so the logicals from half
        # the physical count on lost every copy
        mask = eng.runtime.expert_mask.cpu().numpy()
        masked = [int(e) for e in np.flatnonzero(~mask)]
        lost = list(range(
            (cfg.moe.num_experts + cfg.moe.num_redundant_experts) // 2,
            cfg.moe.num_experts))
        if rep.scenario != "moe+missing_experts" or masked != lost:
            raise AssertionError(f"engine {path}: scenario {rep.scenario}, "
                                 f"masked {masked}")
        what = f"logical experts {masked[0]}-{masked[-1]} masked"
        if cfg.moe.first_k_dense and not any(
                a.startswith("dense-FFN TP group") for a in rep.actions):
            raise AssertionError(f"engine {path}: no dense-FFN TP group "
                                 f"action in {rep.actions}")
    else:
        if rep.scenario != "attn" or rep.migrated < 1:
            raise AssertionError(f"engine {path}: scenario {rep.scenario}, "
                                 f"migrated {rep.migrated}")
        what = "no experts"
    if rep.compile_source != "precompiled":
        raise AssertionError(f"engine {path}: compile_source "
                             f"{rep.compile_source}")
    stats = eng.prefill_stats()
    hits = stats["prefix_cache_hits"]
    # whole-prompt installs (serial, or a model that cannot chunk) bypass
    # the prefix cache
    if (eng.ecfg.admission == "chunked"
            and eng.model.supports_chunked_prefill and hits <= 0):
        raise AssertionError(f"engine {path}: the prefix cache was never "
                             f"hit")
    used = [k for k, ps in KERNEL_PATH.items() if path in ps]
    if min(path_counts.get(k, 0) for k in used) <= 0:
        raise AssertionError(f"engine {path}: kernel launches {path_counts}")
    log(f"  scenario {rep.scenario}, {what}, compile_source "
        f"{rep.compile_source}, migrated {rep.migrated}, prefix_cache_hits "
        f"{hits}, prefill tokens {stats['prefill_tokens_computed']}, "
        f"launches {path_counts}; actions {rep.actions}")
    del eng, reqs
    gc.collect()
    torch.cuda.empty_cache()
    return {k: path_counts[k] for k in used}, (clean, fault), streams


SWITCH_ACTION = re.compile(r"role switch: dp(\d+) -> moe ep-rank (\d+); "
                           r"migrated (\d+) of its sequences "
                           r"\((\d+) KV-streamed\)")


def _watch_imports(torch, eng, streamed):
    """Wrap each attention rank's ``import_kv_blocks``: after an install,
    the target's pool rows at the request's new blocks must be
    ``torch.equal`` to the payload, on the card.  Appends (request id,
    payload bytes) to ``streamed``."""
    from repro_torch.serving.cache_ops import gather_request_blocks

    def watch(ex):
        install = ex.import_kv_blocks

        def checked(req, kv):
            if not install(req, kv):
                return False
            live = [b for b in ex.scheduler.block_tables[req.req_id]
                    .blocks[:kv.num_blocks] if b != ex.trash_block]
            rows, _ = gather_request_blocks(ex.cache, ex.paged_axes, live,
                                            req.batch_slot)
            for got, sent in zip(rows, kv.pool_blocks):
                if got is None:
                    continue
                if sent.device.type != "cuda" or not torch.equal(got, sent):
                    raise AssertionError(
                        f"engine disagg: request {req.req_id}'s installed "
                        f"rows differ from its payload on {sent.device}")
            streamed.append((req.req_id, kv.nbytes()))
            return True

        ex.import_kv_blocks = checked

    for ex in eng.dp_executors:
        watch(ex)


def serve_disagg(torch, cfg, path, workdir, seed, profile):
    """The disaggregated path (physicals 0-1 attention, 2-3 experts, EP
    rank j on physical 2 + j), three runs of the 8 requests: (1) without a
    fault; (2) an L6 ``moe`` fault mid-step on physical 2 one step after
    run 1 had every request past its prefill: a synchronous role switch,
    the donor's residents KV-streamed to the other attention rank and EP
    rank 0's 32 physical experts read back from ``weights.npz``; (3) the
    same fault with ``background_role_switch``: logicals 4-31 masked at
    once, the switch finished at the top of the next step.  Returns
    (launch counts of run 2, (run 1, run 2) rates, run 1's streams)."""
    from repro_torch.core.fault_codes import Severity
    from repro_torch.core.weights import RecoveryPolicy
    from repro_torch.kernels import launches
    new_tokens = 32
    m = cfg.moe
    per = (m.num_experts + m.num_redundant_experts) // 2
    lost = list(range(m.num_redundant_experts, per))  # no replica on rank 1

    def make(policy):
        eng = make_engine(torch, cfg, path, workdir, seed, policy)
        pids = [x.physical_id for x in eng.moe_executors]
        if pids != [2, 3]:
            raise AssertionError(f"engine disagg: expert ranks {pids}")
        return eng, eng.expert_integrity()[0]

    def release():   # after the caller dropped its engine
        gc.collect()
        torch.cuda.empty_cache()

    def finished(reqs, what):
        states = [r.state.value for r in reqs]
        if any(s != "finished" for s in states):
            raise AssertionError(f"engine disagg ({what}): requests {states}")

    log(f"engine: path {path!r}: " + json.dumps(PATHS[path]))
    eng, _ = make(RecoveryPolicy())
    ready = []      # steps after which all 8 requests are past prefill

    def note_ready(e):
        if len(e.all_requests) == 8 and all(r.output_tokens
                                            for r in e.all_requests):
            ready.append(e.step_no)

    serve = lambda: _serve(torch, eng, cfg.vocab_size,  # noqa: E731
                           seed, new_tokens, note_ready)
    reqs, clean = _trace(torch, serve) if profile else serve()
    finished(reqs, "no fault")
    if eng.reports:
        raise AssertionError(f"engine disagg: {len(eng.reports)} reports "
                             f"without a fault")
    streams = [list(r.output_tokens) for r in reqs]
    computed = eng.prefill_stats()["prefill_tokens_computed"]
    fault_step = ready[0] + 1
    log(f"  no fault: " + json.dumps({k: round(v, 3)
                                      for k, v in clean.items()})
        + f"; every request past prefill after step {ready[0]}, so the "
        f"fault goes mid-step at step {fault_step}")
    del eng, reqs
    release()

    for kind, policy in (("sync", RecoveryPolicy()), (
            "background", RecoveryPolicy(background_role_switch=True))):
        eng, start = make(policy)
        eng.injector.schedule(fault_step, 2, severity=Severity.L6,
                              component="moe", mid_step=True)
        streamed, masked = [], []

        def note_mask(e):
            if e.reports and not e.background_reports and not masked:
                masked.extend(int(i) for i in np.flatnonzero(
                    ~e.runtime.expert_mask.cpu().numpy()))

        _watch_imports(torch, eng, streamed)
        launches.clear()
        reqs, rates = _serve(torch, eng, cfg.vocab_size, seed, new_tokens,
                             note_mask)
        counts = dict(launches)
        finished(reqs, kind)
        if len(eng.reports) != 1:
            raise AssertionError(f"engine disagg ({kind}): "
                                 f"{len(eng.reports)} reports")
        rep = eng.reports[0]
        plan = rep.moe_plan
        checks, alive = eng.expert_integrity()
        log(f"  {kind} role switch: " + json.dumps(
            {k: round(v, 3) for k, v in rates.items()}))
        log(f"  recovery: {rep.summary()}")
        log(f"  recovery timings " + json.dumps(
            {k: round(v, 6) for k, v in rep.timings.items()})
            + f"; KV streamed {sum(b for _, b in streamed)} bytes in "
            f"{len(streamed)} payloads; actions {rep.actions}")
        bad = []
        if rep.scenario != "moe+role_switch" or plan.lost_logicals != lost:
            bad.append(f"scenario {rep.scenario}, lost "
                       f"{plan.lost_logicals if plan else None}")
        if rep.compile_source != "precompiled":
            bad.append(f"compile_source {rep.compile_source}")
        if not all(alive) or checks != start:
            bad.append(f"integrity {checks} {alive}, start-up {start}")
        owner = eng._shard_owner(0)
        if (owner is None or owner.shard is eng.shards[0]
                or eng._resident[0] is not owner.shard):
            bad.append("EP rank 0's bank slice is not the shard read "
                       "from disk")
        if kind == "sync":
            sw = next((SWITCH_ACTION.match(a) for a in rep.actions
                       if SWITCH_ACTION.match(a)), None)
            n, n_streamed = ((int(sw.group(3)), int(sw.group(4)))
                             if sw else (0, -1))
            if n < 1 or n_streamed != n or len(streamed) != n:
                bad.append(f"migrated {n}, KV-streamed {n_streamed}, "
                           f"installs checked {len(streamed)}")
            now = eng.prefill_stats()["prefill_tokens_computed"]
            if now > computed:
                bad.append(f"prefill tokens {now} > {computed} without "
                           f"the fault")
            if rep.timings.get("generator", 0.0) <= 0:
                bad.append("no reload timed")
            path_counts, fault = counts, rates
            log(f"  sync: donor dp{sw.group(1) if sw else '?'} migrated {n} "
                f"({n_streamed} KV-streamed), prefill tokens {now} (no "
                f"fault: {computed}), EP rank 0 checksum {checks[0]!r} = "
                f"start-up {start[0]!r}, launches {counts}")
        else:
            bg = eng.background_reports
            if (rep.timings.get("generator", 0.0) != 0.0
                    or rep.timings.get("role_switch", 0.0) != 0.0):
                bad.append(f"downtime timings {rep.timings}")
            if masked != lost:
                bad.append(f"masked during the switch {masked}")
            if not bg or bg[0]["restored_experts"] != float(per):
                bad.append(f"background reports {bg}")
            if (eng.expert_map.coverage() != 1.0
                    or not bool(eng.runtime.expert_mask.all())):
                bad.append("mask not cleared")
            log(f"  background: logicals {masked[0]}-{masked[-1]} masked "
                f"until the switch; its own timings "
                + json.dumps({k: round(v, 6) for k, v in bg[0].items()})
                + f"; KV streamed {sum(b for _, b in streamed)} bytes; "
                f"coverage {eng.expert_map.coverage()}, checksums equal "
                f"start-up {checks == start}")
        if bad:
            raise AssertionError(f"engine disagg ({kind}): " + "; ".join(bad))
        del eng, reqs, owner, note_mask
        release()
    used = [k for k, ps in KERNEL_PATH.items() if path in ps]
    if min(path_counts.get(k, 0) for k in used) <= 0:
        raise AssertionError(f"engine disagg: kernel launches {path_counts}")
    return {k: path_counts[k] for k in used}, (clean, fault), streams


# -- main ---------------------------------------------------------------------------

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES))
    ap.add_argument("--layers", type=int, default=COLLOCATED_LAYERS,
                    help="depth of the collocated qwen paths (disagg "
                         f"serves all {ENGINE_LAYERS})")
    ap.add_argument("--paths", default=",".join(PATHS),
                    help="engine paths to serve, of " + ", ".join(PATHS))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="trace each engine run without a fault")
    args = ap.parse_args()
    phases = args.phases.split(",")
    for p in phases:
        if p not in PHASES:
            raise SystemExit(f"unknown phase {p!r}; phases: {PHASES}")
    for p in args.paths.split(","):
        if p not in PATHS:
            raise SystemExit(f"unknown path {p!r}; paths: {tuple(PATHS)}")

    # the engine phase builds and frees ~30 GB models one after another:
    # growable segments keep the freed memory from fragmenting
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    import torch
    phase_device(torch)
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout)
    t_start = time.perf_counter()
    took = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        took[name] = round(time.perf_counter() - t0, 1)
        log(f"phase {name} passed in {took[name]} s")
        return out

    if "build" in phases:
        timed("build", phase_build)
    results = {}
    if "kernels" in phases:
        results = timed("kernels", lambda: phase_kernels(torch, SHAPES))
    if "model" in phases:
        timed("model", lambda: phase_model(torch, args.seed))
    counts = {}
    if "engine" in phases:
        counts = timed("engine", lambda: phase_engine(
            torch, args.seed, args.layers, args.paths.split(","),
            args.profile))
    log(f"phases {phases} passed in {time.perf_counter() - t_start:.1f} s "
        f"({json.dumps(took)})")
    kernels = []
    for name, (src, replaces) in KERNEL_META.items():
        r = results.get(name, {})
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=counts.get(name, 0), max_abs_err=r.get("max_abs_err"),
            ms=r.get("ms"), plain_ms=r.get("plain_ms"),
            bound_ms=r.get("bound_ms"), bound_by=r.get("bound_by"),
            library_ms=r.get("library_ms"), shape=r.get("shape"),
            mla=r.get("mla")))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
