"""How often the overlap pipeline's on-device sample agrees with the host
sampler at temperature > 0, on random logits at a real vocabulary.

    PYTHONPATH=src python scripts/predict_agreement.py [--vocab 151936]
        [--rows 64] [--temperature 0.8] [--top-p 0.9] [--device cpu]

``sampling.device_predict`` sorts the probabilities with a stable sort
(ties by index); the host's ``sampling.sample`` uses numpy's default
argsort, whose order among equal values is unspecified.  Logits rounded
to bf16 (as the card's engine produces them) tie by the thousands at a
real vocabulary, so the two pick different tokens inside a tied run;
each disagreement costs the overlap pipeline a replan.  The script
prints the share of rows on which the two agree, for bf16-rounded and
f32 logits, and with the host's argsort made stable.  The counts are of
samples, not of time: they hold on any device.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.serving import sampling


def agreement(logits: np.ndarray, params, device: str,
              stable_host: bool) -> float:
    n = logits.shape[0]
    steps = np.arange(n)
    u = sampling.seeded_uniforms(params.seed, steps).astype(np.float32)
    i32 = dict(dtype=torch.int32, device=device)
    targets, _, _ = sampling.device_predict(
        torch.from_numpy(logits).to(device), torch.arange(n, **i32),
        torch.ones(n, **i32), torch.zeros((n, 1), **i32),
        torch.from_numpy(u[:, None]).to(device), torch.zeros(n, **i32),
        torch.full((n,), n, **i32), temperature=params.temperature,
        top_p=params.top_p)
    argsort = np.argsort
    if stable_host:
        sampling.np.argsort = lambda a, axis=-1, kind=None: argsort(
            a, axis=axis, kind="stable")
    try:
        host = sampling.sample(logits, params, step=steps)
    finally:
        sampling.np.argsort = argsort
    return float((targets[:, 0].cpu().numpy() == host).mean())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--vocab", type=int, default=151936)
    ap.add_argument("--rows", type=int, default=64)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--top-p", type=float, default=0.9)
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args()
    params = sampling.SamplingParams(temperature=args.temperature,
                                     top_p=args.top_p, seed=0)
    rng = np.random.default_rng(0)
    raw = rng.normal(size=(args.rows, args.vocab)).astype(np.float32)
    bf16 = torch.from_numpy(raw).bfloat16().float().numpy()
    for name, logits in (("bf16-rounded", bf16), ("f32", raw)):
        ties = args.vocab - np.mean([len(np.unique(r)) for r in logits])
        for stable in (False, True):
            share = agreement(logits, params, args.device, stable)
            print(f"{name} logits (mean {ties:.0f} tied values a row), "
                  f"host argsort {'stable' if stable else 'default'}: "
                  f"device sample equals host sample on {share:.4f} of "
                  f"{args.rows} rows")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
