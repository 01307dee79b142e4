#!/usr/bin/env python3
"""Time the bf16 kernels of two checkouts in turns on one GPU.

    git archive <parent> | tar -x -C build/parent     # any ignored path
    python3 scripts/kernel_turns.py --parent build/parent

Runs four child processes one after the other -- the parent checkout,
this tree, this tree, the parent -- each importing ``repro_torch`` from
its tree's ``src``, building that tree's kernels into its own
``build/kernels``, and timing in bf16 at the main path's shapes:
``paged_attention`` (decode B = 8, and B = 40 at the engine's full
context), the same at deepseek-v3's latent layout (Hkv = 1, G = 128, Da
= 576, one pool as K and V; B = 8 and 40 at the engine's context),
``moe_fused`` (T = 8, 40), ``decode_megastep`` (B = 8, 40, and at
deepseek-v3's latent layout with its 288-expert bank, B = 8 and 40),
``expert_ffn`` (C = 8, 20, 40),
``flash_prefill`` (B = 1, H = Hkv = 16, Dh = 128, causal, S = 256 and
512), ``ssm_scan`` (prefill B = 1 S = 256 and decode B = 8 from a bf16 state,
both through the default call), the decode step's scan as that tree's
``mamba_decode`` runs it (in place where its launcher takes ``h_out``,
else the scan, a copy into the bf16 state and a cast of y), and that
tree's ``mamba_decode`` itself over one falcon-mamba-7b layer at full
width (B = 8; A precomputed where its ``mamba_decode`` takes it, as its
``Model`` then does).  The operands and the timer (median of 25 calls,
each after a write that evicts the L2) are ``chip_smoke.py``'s of this
tree, so both trees see the same inputs.  Prints the card's name and
power limit, each turn's times, and a JSON line of them all.
"""
from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def decode_scan(ssm, args):
    """The decode step's scan, copy and cast as the tree's mamba_decode
    runs them."""
    u, dt, A, Bm, Cm, state = args
    if "h_out" in inspect.signature(ssm.ssm_scan_cuda).parameters:
        return lambda: ssm.ssm_scan_cuda(u, dt, A, Bm, Cm, state,
                                         h_out=state, y_dtype=u.dtype)

    def seq():
        y, h = ssm.ssm_scan_cuda(u, dt, A, Bm, Cm, state)
        state.copy_(h)
        return y[:, 0].to(u.dtype)
    return seq


def mamba_layer(torch, B):
    """The tree's mamba_decode over one full-width falcon-mamba-7b layer."""
    from repro_torch.configs import get_config
    from repro_torch.models import mamba
    cfg = get_config("falcon-mamba-7b")
    gen = torch.Generator(device="cuda").manual_seed(50)
    p = mamba.mamba_init(gen, cfg, torch.bfloat16)
    state = mamba.mamba_init_state(cfg, B, torch.bfloat16, "cuda")
    x = torch.randn((B, cfg.d_model), generator=gen, device="cuda").to(
        torch.bfloat16)
    kw = {}
    if "A" in inspect.signature(mamba.mamba_decode).parameters:
        kw["A"] = mamba.ssm_A(p["A_log"])
    return lambda: mamba.mamba_decode(p, cfg, x, state, **kw)


def child(tree: Path) -> dict:
    """One turn: this process imports the kernels of ``tree``."""
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(tree / "build" / "kernels")
    sys.path.insert(0, str(tree / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import ssm_scan as ssm
    from repro_torch.kernels.decode_megastep import decode_megastep_cuda
    from repro_torch.kernels.expert_ffn import expert_ffn_cuda
    from repro_torch.kernels.flash_prefill import flash_prefill_cuda
    from repro_torch.kernels.moe_fused import moe_fused_cuda
    from repro_torch.kernels.paged_attention import paged_attention_cuda
    if not torch.cuda.is_available():
        raise SystemExit("kernel_turns: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all(["paged_attention", "moe_fused", "decode_megastep",
                     "expert_ffn", "flash_prefill", "ssm_scan"])
    S, bf16 = cs.SHAPES, torch.bfloat16
    out = {"paged_attention": {}, "paged_attention latent": {},
           "moe_fused": {}, "decode_megastep": {},
           "decode_megastep latent": {}, "expert_ffn": {},
           "flash_prefill": {}, "ssm_scan": {},
           "decode scan as served": {}, "mamba_decode": {}}
    # chip_smoke.py's timed decode case (B=8, rows of 1-288 positions) and
    # its full-context case at B=40 (rows of 1-512)
    for i, (B, max_len) in ((0, (S["max_batch"], 288)),
                            (5, (S["chunk"] + S["max_batch"], 512))):
        args, _ = cs.paged_case(
            torch, B=B, H=16, Hkv=16, Dh=128, bs=S["block_size"],
            nb=S["num_blocks"] + 1, max_blk=S["max_blk"], max_len=max_len,
            window=0, idle=True, dtype=bf16, seed=i)
        out["paged_attention"][B] = cs.time_ms(
            torch, lambda: paged_attention_cuda(*args))
    # chip_smoke.py's timed latent cases (mla_paged): decode and chunk step
    W = cs.DEEPSEEK
    for i, B in enumerate((S["max_batch"], S["chunk"] + S["max_batch"])):
        args, _ = cs.paged_case(
            torch, B=B, H=W["H"], Hkv=1, Dh=W["Dh"], bs=S["block_size"],
            nb=S["num_blocks"] + 1, max_blk=S["max_blk"], max_len=512,
            window=0, idle=True, dtype=bf16, seed=60 + i, same=True)
        out["paged_attention latent"][B] = cs.time_ms(
            torch, lambda: paged_attention_cuda(*args))
    del args
    for i, (name, T, e_local, off, hot) in enumerate(cs.moe_cases(S)):
        if name not in cs.MOE_TIMED:
            continue
        args, kw = cs.moe_case(torch, T=T, E=64, e_local=e_local, off=off,
                               D=S["d_model"], Fd=S["d_ff"], k=S["top_k"],
                               cap=S["cap"], dtype=bf16, seed=10 + i,
                               hot=hot)
        out["moe_fused"][T] = cs.time_ms(
            torch, lambda: moe_fused_cuda(*args, **kw))
    for i, (name, case) in enumerate(cs.megastep_cases(S)):
        if name not in cs.MEGA_TIMED:
            continue
        args, kw, _ = cs.megastep_case(torch, S, dtype=bf16, seed=20 + i,
                                       **case)
        out["decode_megastep"][case["B"]] = cs.time_ms(
            torch, lambda: decode_megastep_cuda(*args, **kw))
    # chip_smoke.py's timed latent megastep cases (mla_megastep): seeds 70
    # (decode) and 72 (chunk step), the whole bf16 bank of 288 experts
    for seed, B in ((70, S["max_batch"]), (72, S["chunk"] + S["max_batch"])):
        args, kw, _ = cs.megastep_case(torch, S, B=B, dtype=bf16, seed=seed,
                                       W=W, e_local=W["E_log"] + W["R"],
                                       off=0)
        out["decode_megastep latent"][B] = cs.time_ms(
            torch, lambda: decode_megastep_cuda(*args, **kw))
        del args, kw
        torch.cuda.empty_cache()
    for C in (8, 20, 40):
        args = cs.expert_ffn_args(torch, C, bf16)
        out["expert_ffn"][C] = cs.time_ms(torch,
                                          lambda: expert_ffn_cuda(*args))
        del args
    for Sq in (256, 512):     # chip_smoke.py's timed cases: seed S + window
        gen = torch.Generator(device="cuda").manual_seed(Sq)
        q, k, v = (torch.randn((1, Sq, 16, 128), generator=gen,
                               device="cuda").to(bf16) for _ in range(3))
        pos = torch.arange(Sq, dtype=torch.int32, device="cuda")
        out["flash_prefill"][Sq] = cs.time_ms(
            torch, lambda: flash_prefill_cuda(q, k, v, pos, pos))
    args = cs.ssm_case(torch, 1, 256, with_h0=False, dtype=bf16, seed=41)
    out["ssm_scan"]["prefill S=256"] = cs.time_ms(
        torch, lambda: ssm.ssm_scan_cuda(*args))
    args = cs.ssm_case(torch, 8, 1, with_h0=True, dtype=bf16, seed=44)
    out["ssm_scan"]["decode B=8"] = cs.time_ms(
        torch, lambda: ssm.ssm_scan_cuda(*args))
    out["decode scan as served"][8] = cs.time_ms(torch,
                                                 decode_scan(ssm, args))
    out["mamba_decode"][8] = cs.time_ms(torch, mamba_layer(torch, 8))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path,
                    help="a checkout of the commit to compare against")
    ap.add_argument("--tree", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.tree is not None:
        print(json.dumps(child(args.tree.resolve())), flush=True)
        return 0
    if args.parent is None:
        ap.error("--parent is required")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    turns = []
    for name, tree in (("parent", args.parent), ("change", ROOT),
                       ("change", ROOT), ("parent", args.parent)):
        res = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--tree",
             str(tree.resolve())], capture_output=True, text=True,
            timeout=1200)
        if res.returncode != 0:
            print(res.stdout[-4000:], res.stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"kernel_turns: the {name} turn failed")
        times = json.loads(res.stdout.strip().splitlines()[-1])
        turns.append((name, times))
        print(f"{name}: " + "; ".join(
            f"{k} " + ", ".join(f"{n}: {ms:.4f}" for n, ms in v.items())
            for k, v in times.items()) + " ms", flush=True)
    print(json.dumps({"card": smi, "turns": turns}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
