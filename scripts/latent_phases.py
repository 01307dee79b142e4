#!/usr/bin/env python3
"""Where a bf16 ``paged_attention`` launch at MLA's latent layout spends its
time, CTA by CTA.

    python3 scripts/latent_phases.py          # on a machine with the card
    python3 scripts/latent_phases.py 256 128  # at other split lengths

Builds a copy of ``src/repro_torch/kernels/csrc/paged_attention.cu`` with
``%globaltimer`` stamps in ``latent_kernel`` (``phase_stamps.py``),
launches it at ``chip_smoke.py``'s timed latent cases (Hkv = 1, G = 128,
Da = 576, one pool as K and V, the engine's 512 positions: decode B = 8
and chunk step B = 40) and prints, beside the call's time
(``chip_smoke.time_ms``: median of 25 L2-cold calls), the mean over the
CTAs with work and over those with the most tiles of:

* prologue — the split's block-table offsets, the query copies issued;
* wait — each tile's wait for its copies, the barrier after it and the
  copies of a later tile issued;
* S = QK^T — the tile's score products and their barrier;
* softmax — the online softmax and its barrier;
* P V — the rescale and the value products;
* epilogue — the partial (or the row's output) written;

and the SM clock during the launch.  Arguments other than 256 rebuild the
copy with that split length (the port's is 256), to weigh the partials'
bytes against the CTAs in flight.  The stamps are taken by thread 0 of
each CTA, so another warp's work that overlaps a boundary is counted where
thread 0 sees it.
"""
from __future__ import annotations

import ctypes
import sys

import numpy as np

import phase_stamps

MAX_CTAS = 8192
N_STAMPS = 10
KERNEL_STAMPS = [
    ("  const int t_first = (lo - s0) / kLatTile;\n",
     "  const unsigned long long t0 = now_ns();\n"
     "  const long long c0 = clock64();\n"
     "  unsigned long long tw = 0, tq = 0, ts = 0, tp = 0, ta, tb, td = 0;\n"
     "  const int t_first = (lo - s0) / kLatTile;\n"),
    ("  __syncthreads();   // off_s\n",
     "  __syncthreads();   // off_s\n"
     "  const unsigned long long t1 = now_ns();\n"),
    ("    cp_async_wait<kLatStages - 2>();   // tile it (and q) has landed\n",
     "    ta = now_ns();\n"
     "    if (it > 0) tp += ta - td;\n"
     "    cp_async_wait<kLatStages - 2>();   // tile it (and q) has landed\n"),
    ("    scores(it);\n    __syncthreads();\n    softmax(it);\n"
     "    __syncthreads();\n    values(it);\n",
     "    tb = now_ns();\n"
     "    tw += tb - ta;\n"
     "    scores(it);\n    __syncthreads();\n"
     "    ta = now_ns();\n"
     "    tq += ta - tb;\n"
     "    softmax(it);\n    __syncthreads();\n"
     "    td = now_ns();\n"
     "    ts += td - ta;\n"
     "    values(it);\n"),
    ("  cp_async_wait<0>();\n\n  // the heads' (m, l)",
     "  tp += now_ns() - td;\n"
     "  const unsigned long long t3 = now_ns();\n"
     "  cp_async_wait<0>();\n\n  // the heads' (m, l)"),
    ("          *reinterpret_cast<const float4*>(o_s + row * kORow + c4 * 4);"
     "\n    }\n  }\n}\n",
     "          *reinterpret_cast<const float4*>(o_s + row * kORow + c4 * 4);"
     "\n    }\n  }\n"
     "  const long long cta = (long long)blockIdx.y * gridDim.x + blockIdx.x;\n"
     "  if (threadIdx.x == 0 && cta < %d) {\n"
     "    unsigned long long* s = g_stamp[cta];\n"
     "    s[0] = t1 - t0; s[1] = tw; s[2] = tq; s[3] = ts; s[4] = tp;\n"
     "    s[5] = now_ns() - t3; s[6] = now_ns() - t0; s[7] = nt;\n"
     "    s[8] = clock64() - c0; s[9] = 1;\n  }\n}\n" % MAX_CTAS),
]
PHASES = ("prologue", "wait", "S = QK^T", "softmax", "P V", "epilogue",
          "whole CTA")
SPLIT_LEN = "constexpr int kWideSplitLen = 256;"


def build_stamped(split_len: int):
    """The stamped library, with the latent layout's split length set to
    ``split_len`` (256 in the port)."""
    patches = {"paged_attention.cuh": [
        (SPLIT_LEN, SPLIT_LEN.replace("256", str(split_len))),
        *KERNEL_STAMPS]}
    lib = phase_stamps.build("paged_attention.cu", patches,
                             namespace="paged", n_ctas=MAX_CTAS,
                             n_stamps=N_STAMPS,
                             subdir=f"latent_split{split_len}")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.paged_attention.argtypes = [vp] * 8 + [ci] * 7 + [vp]
    lib.paged_attention_scratch_bytes.argtypes = [ci] * 5
    lib.paged_attention_scratch_bytes.restype = ctypes.c_longlong
    return lib


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("latent_phases: no CUDA device")
    sys.path.insert(0, str(phase_stamps.ROOT))
    import chip_smoke as cs
    print(phase_stamps.card())
    libs = {n: build_stamped(n) for n in
            [int(a) for a in sys.argv[1:]] or [256]}
    S, W = cs.SHAPES, cs.DEEPSEEK
    for split_len, i, B in ((n, i, B) for n in libs for i, B in
                            enumerate((S["max_batch"],
                                       S["chunk"] + S["max_batch"]))):
        lib = libs[split_len]
        args, n_valid = cs.paged_case(
            torch, B=B, H=W["H"], Hkv=1, Dh=W["Dh"], bs=S["block_size"],
            nb=S["num_blocks"] + 1, max_blk=S["max_blk"], max_len=512,
            window=0, idle=True, dtype=torch.bfloat16, seed=60 + i,
            same=True)
        q, kp, vp, tables, seq, start = args
        bs, max_blk = kp.shape[1], tables.shape[1]
        out = torch.empty_like(q)
        nbytes = lib.paged_attention_scratch_bytes(B, W["H"], W["Dh"], bs,
                                                   max_blk)
        scratch = torch.empty(max(nbytes, 1), dtype=torch.uint8,
                              device="cuda")

        def launch():
            err = lib.paged_attention(
                q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                tables.data_ptr(), seq.data_ptr(), None, out.data_ptr(),
                scratch.data_ptr(), B, W["H"], 1, W["Dh"], bs, max_blk, 1,
                torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"launch failed: cudaError {err}")
        ms = cs.time_ms(torch, launch)
        phase_stamps.clear(lib)
        launch()                              # L2 warm, as a traced run
        torch.cuda.synchronize()
        stamps = phase_stamps.read(lib)
        t = stamps[stamps[:, 9] == 1].astype(np.int64)   # CTAs with work
        mhz = float((t[:, 8] / t[:, 6]).mean() * 1e3)
        heavy = t[:, 7] == t[:, 7].max()
        print(f"split {split_len}, B={B} ({n_valid} valid latent rows): "
              f"{ms:.4f} ms a call (L2 "
              f"cold); traced launch: {len(t)} CTAs with work, at most "
              f"{int(t[:, 7].max())} tiles, SM clock {mhz:.0f} MHz")
        for j, name in enumerate(PHASES):
            d = t[:, j]
            print(f"  {name:10s} mean {d.mean():8.0f} ns; CTAs with "
                  f"{int(t[heavy, 7][0])} tiles {d[heavy].mean():8.0f} ns")
    return 0


if __name__ == "__main__":
    sys.exit(main())
