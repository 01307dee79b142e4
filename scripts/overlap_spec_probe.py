"""Where speculation parts a stream from lockstep on the card, and why.

Serves ``chip_smoke._spec_prompts`` (8 requests, each a 16-token pattern
repeated) on the 8-layer qwen2-moe-a2.7b engine of ``chip_smoke.py``'s
engine phase, composed, with a drop-free MoE capacity
(``chip_smoke.drop_free``), and counts the tokens two engines share,
position by position:

1. lockstep ``spec_window=6`` against lockstep plain decode, greedy: a
   row verified in a window runs in the chunk launch, the same row
   decoded runs in the decode launch;
2. overlap against lockstep, both ``spec_window=6``, greedy: an overlap
   step plans the next windows from the tokens it guessed;
3. the same at temperature 0.8 (top-p 0.9) with the host sampler's sort
   made stable (as ``sampling.device_predict``'s), so that the windows
   planned from guesses are not replanned away.

Each for every ``--dtypes`` entry.  Prints one line per engine (windows,
drafts, accepted, histogram, ``overlap_stats()``, tokens/s) and one per
comparison.  Needs one card.

    python3 scripts/overlap_spec_probe.py [--dtypes bf16,f32] [--layers 8]
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import types
from pathlib import Path

import numpy

ROOT = Path(__file__).resolve().parents[1]


def stable_numpy() -> types.ModuleType:
    """numpy whose ``argsort`` is stable (ties by index)."""
    class _Numpy(types.ModuleType):
        def __getattr__(self, k):
            return getattr(numpy, k)
    mod = _Numpy("numpy")
    mod.argsort = lambda a, axis=-1: numpy.argsort(a, axis=axis,
                                                   kind="stable")
    return mod


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dtypes", default="bf16,f32")
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("overlap_spec_probe: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.core.weights import RecoveryPolicy
    from repro_torch.kernels import build
    from repro_torch.serving import sampling
    from repro_torch.serving.sampling import SamplingParams
    build.build_all()
    cfg = cs.drop_free(cs.engine_config(cs.QWEN_ARCH, args.layers))
    workdir = ROOT / "build" / "overlap_spec_probe"
    workdir.mkdir(parents=True, exist_ok=True)
    prompts = cs._spec_prompts(cfg.vocab_size, args.seed)
    host_numpy, stable = sampling.np, stable_numpy()
    dtypes = {"bf16": torch.bfloat16, "f32": torch.float32}

    def serve(name, dtype, overlap, spec, temperature, stable_sort=False):
        eng = cs.make_engine(
            torch, cfg, "composed", workdir, args.seed,
            RecoveryPolicy(allow_role_switch=False), dtype=dtype,
            overlap=overlap, spec_window=spec,
            sampling=SamplingParams(temperature=temperature, top_p=0.9,
                                    seed=args.seed))
        sampling.np = stable if stable_sort else host_numpy
        try:
            reqs, rates = cs._serve(torch, eng, cfg.vocab_size, args.seed,
                                    32, prompts=prompts, sync=False)
        finally:
            sampling.np = host_numpy
        st = eng.prefill_stats()
        cs.log(f"probe {name}: " + json.dumps(dict(
            windows=st["spec_windows"], drafts=st["spec_drafts"],
            accepted=st["spec_accepted"], histogram=eng.spec_histogram(),
            overlap_stats=eng.overlap_stats() if overlap else None,
            decode_tok_s=round(rates["decode_tok_s"], 3),
            e2e_tok_s=round(rates["e2e_tok_s"], 3))))
        out = [list(r.output_tokens) for r in reqs]
        del eng, reqs
        gc.collect()
        torch.cuda.empty_cache()
        return out

    def compare(what, got, want):
        same, total = cs.shared_tokens(got, want)
        first = [next((i for i, (a, b) in enumerate(zip(m, c)) if a != b),
                      None) for m, c in zip(got, want)]
        cs.log(f"probe {what}: streams equal {got == want}, {same} of "
               f"{total} tokens shared; first differing position per "
               f"request {first}")

    for name in args.dtypes.split(","):
        dt = dtypes[name]
        lock = serve(f"{name} lockstep spec 6, T 0", dt, False, 6, 0.0)
        plain = serve(f"{name} lockstep plain, T 0", dt, False, 0, 0.0)
        compare(f"{name} (1) lockstep spec 6 against plain, T 0", lock,
                plain)
        ovl = serve(f"{name} overlap spec 6, T 0", dt, True, 6, 0.0)
        compare(f"{name} (2) overlap against lockstep, spec 6, T 0", ovl,
                lock)
        lock = serve(f"{name} lockstep spec 6, T 0.8, stable sort", dt,
                     False, 6, 0.8, stable_sort=True)
        ovl = serve(f"{name} overlap spec 6, T 0.8, stable sort", dt, True,
                    6, 0.8, stable_sort=True)
        compare(f"{name} (3) overlap against lockstep, spec 6, T 0.8, "
                f"stable host sort", ovl, lock)
    return 0


if __name__ == "__main__":
    sys.exit(main())
