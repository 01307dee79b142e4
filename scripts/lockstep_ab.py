"""Time the lockstep engine paths of one source tree, several serves each.

Compares two versions of ``repro_torch`` on one card: run this script
once per tree, alternating (A, B, B, A), in one session.  Each run
builds the tree's kernels, then for each path builds one engine (the
8-layer qwen2-moe-a2.7b of ``chip_smoke.py``'s engine phase, bf16, 2
attention ranks) and serves ``chip_smoke._prompts`` once to warm it
up and ``--repeats`` more times, each on prompts of another seed, with
the per-step ``torch.cuda.synchronize()`` of ``chip_smoke._serve`` (as
the engine table in PERF.md is measured).  The measuring code is this
checkout's ``chip_smoke.py`` whatever tree is timed, so both trees are
measured alike.

    python3 scripts/lockstep_ab.py --src <tree>/src [--tag A]
        [--paths composed,megakernel] [--repeats 3] [--layers 8]
        [--workdir build/ab_weights]

Prints a line per serve and, last, one JSON object with every serve's
decode and end-to-end tokens/s per path.  Needs one card.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the tree's src directory (holds repro_torch)")
    ap.add_argument("--paths", default="composed,megakernel")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--workdir", default=str(ROOT / "build" / "ab_weights"),
                    help="weights.npz is written here once and shared")
    ap.add_argument("--tag", default="", help="a label for the output")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("lockstep_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    import repro_torch
    from repro_torch.core.weights import RecoveryPolicy
    from repro_torch.kernels import build
    cs.log(f"[{args.tag}] repro_torch from "
           f"{Path(repro_torch.__file__).parent}")
    t0 = time.perf_counter()
    build.build_all()
    cs.log(f"[{args.tag}] kernels built in {time.perf_counter() - t0:.1f} s")
    cfg = cs.engine_config(cs.QWEN_ARCH, args.layers)
    workdir = Path(args.workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    out = {"tag": args.tag, "src": args.src, "paths": {}}
    for path in args.paths.split(","):
        eng = cs.make_engine(torch, cfg, path, workdir, args.seed,
                             RecoveryPolicy(allow_role_switch=False))
        serves = []
        for r in range(args.repeats + 1):
            prompts = cs._prompts(cfg.vocab_size, args.seed + 1000 * r)
            reqs, rates = cs._serve(torch, eng, cfg.vocab_size, args.seed,
                                    32, prompts=prompts)
            if any(q.state.value != "finished" for q in reqs):
                raise AssertionError(f"{path}: not every request finished")
            what = "warm-up" if r == 0 else f"serve {r}"
            cs.log(f"[{args.tag}] {path} {what}: " + json.dumps(
                {k: round(v, 3) for k, v in rates.items()}))
            if r:
                serves.append({k: rates[k] for k in
                               ("decode_tok_s", "e2e_tok_s", "wall_s")})
        out["paths"][path] = serves
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
