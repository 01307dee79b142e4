#!/usr/bin/env python3
"""Where a bf16 ``flash_prefill`` launch spends its time, CTA by CTA.

    python3 scripts/flash_prefill_phases.py      # on a machine with the card

Builds a copy of ``src/repro_torch/kernels/csrc/flash_prefill.cu`` with
``%globaltimer`` stamps at the bf16 kernel's phase boundaries
(``phase_stamps.py``), launches it at the serial path's shapes (B=1,
H=Hkv=16, Dh=128, causal, S = 256 and 512) and prints, beside the call's
time (``chip_smoke.time_ms``: median of 25 L2-cold calls), each phase's
mean over the CTAs and over the CTAs with the most visible key tiles, and
the SM clock during the launch:

* positions — issue the q copies, read the positions, list the visible
  key tiles;
* first tile — wait for the first tile to land;
* tiles — the loop over the visible tiles;
* merge — merge the key slices and write the rows.

The stamps are taken by thread 0 of each CTA, so work of other warps that
overlaps a boundary is counted where thread 0 sees it.
"""
from __future__ import annotations

import ctypes
import math
import sys

import numpy as np

import phase_stamps

MAX_CTAS = 4096
N_STAMPS = 8
PATCHES = {"flash_prefill.cu": [
    ("  const int WQ = (blockDim.x >> 5) / WK;\n",
     "  const unsigned long long t0 = now_ns();\n"
     "  const long long c0 = clock64();\n"
     "  const int WQ = (blockDim.x >> 5) / WK;\n"),
    ("  const int nvis = list_s[0];\n",
     "  const int nvis = list_s[0];\n"
     "  const unsigned long long t1 = now_ns();\n"
     "  unsigned long long t2 = t1;\n"),
    ("    const int buf = it % kStages;\n",
     "    if (it == 0) t2 = now_ns();\n"
     "    const int buf = it % kStages;\n"),
    ("  cp_async_wait<0>();\n  __syncthreads();                 // every warp",
     "  const unsigned long long t3 = now_ns();\n"
     "  cp_async_wait<0>();\n  __syncthreads();                 // every warp"),
    ("            acc[dd][2 * hr] * inv[hr], acc[dd][2 * hr + 1] * inv[hr]);\n"
     "      }\n    }\n  }\n}\n",
     "            acc[dd][2 * hr] * inv[hr], acc[dd][2 * hr + 1] * inv[hr]);\n"
     "      }\n    }\n  }\n"
     "  if (threadIdx.x == 0 && blockIdx.x < %d) {\n"
     "    unsigned long long* s = g_stamp[blockIdx.x];\n"
     "    s[0] = t0; s[1] = t1; s[2] = t2; s[3] = t3; s[4] = now_ns();\n"
     "    s[5] = nvis; s[6] = clock64() - c0; s[7] = gridDim.x;\n  }\n}\n"
     % MAX_CTAS),
]}
PHASES = (("positions", 0, 1), ("first tile", 1, 2), ("tiles", 2, 3),
          ("merge", 3, 4))


def build_stamped():
    lib = phase_stamps.build("flash_prefill.cu", PATCHES, namespace="tc",
                             n_ctas=MAX_CTAS, n_stamps=N_STAMPS,
                             subdir="flash_prefill")
    lib.flash_prefill.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 9
                                  + [ctypes.c_float, ctypes.c_int,
                                     ctypes.c_void_p])
    return lib


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("flash_prefill_phases: no CUDA device")
    sys.path.insert(0, str(phase_stamps.ROOT))
    from chip_smoke import time_ms
    print(phase_stamps.card())
    lib = build_stamped()
    H = Hkv = 16
    Dh = 128
    for S in (256, 512):
        gen = torch.Generator(device="cuda").manual_seed(S)
        q, k, v = (torch.randn((1, S, h, Dh), generator=gen, device="cuda")
                   .to(torch.bfloat16) for h in (H, Hkv, Hkv))
        pos = torch.arange(S, dtype=torch.int32, device="cuda")
        out = torch.empty_like(q)

        def launch():
            err = lib.flash_prefill(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
                pos.data_ptr(), out.data_ptr(), 1, S, S, H, Hkv, Dh, Dh, 1, 0,
                1.0 / math.sqrt(Dh), 1,
                torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"launch failed: cudaError {err}")
        ms = time_ms(torch, launch)
        launch()                              # L2 warm, as a traced run
        torch.cuda.synchronize()
        stamps = phase_stamps.read(lib)
        t = stamps[:int(stamps[0, 7])].astype(np.int64)   # this launch's
        span = int((t[:, 4] - t[:, 0].min()).max())
        mhz = float((t[:, 6] / (t[:, 4] - t[:, 0])).mean() * 1e3)
        heavy = t[:, 5] == t[:, 5].max()
        print(f"S={S}: {ms:.4f} ms a call (L2 cold); traced launch: "
              f"{len(t)} CTAs, {span} ns from the first CTA's start to the "
              f"last CTA's end, SM clock {mhz:.0f} MHz")
        for name, a, b in PHASES:
            d = t[:, b] - t[:, a]
            print(f"  {name:11s} mean {d.mean():8.0f} ns; CTAs with "
                  f"{int(t[heavy, 5][0])} tiles {d[heavy].mean():8.0f} ns")
    return 0


if __name__ == "__main__":
    sys.exit(main())
