"""Quickstart on the port: build a model, serve a few requests, inspect
the engine (``examples/quickstart.py`` over ``repro_torch``).

  PYTHONPATH=src python examples/quickstart_torch.py              # the card
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse
import os
import tempfile

import numpy as np

from repro_torch.configs import get_smoke_config
from repro_torch.serving.engine import EngineConfig, InferenceEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the card (its CUDA kernels), or the CPU (their "
                    "plain versions) only when asked")
    ap.add_argument("--workdir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_quickstart"))
    args = ap.parse_args(argv)

    cfg = get_smoke_config("qwen2-moe-a2.7b")
    print(f"model: {cfg.name} ({cfg.family}), "
          f"{cfg.moe.num_experts} experts top-{cfg.moe.top_k}")

    eng = InferenceEngine(cfg, EngineConfig(
        mode="collocated", num_dp=2, max_batch=2, max_seq=64,
        block_size=8, num_blocks=64, workdir=args.workdir),
        device=args.device)
    print("engine up:", {k: f"{v:.2f}s" for k, v in
                         eng.init_timings.items() if v > 0.01})

    rng = np.random.default_rng(0)
    reqs = [eng.submit(list(rng.integers(0, cfg.vocab_size, 8)),
                       max_new_tokens=12) for _ in range(4)]
    eng.run(max_steps=100)
    for r in reqs:
        print(f"req {r.req_id}: {r.state.value}, prompt={r.prompt_tokens}, "
              f"output={r.output_tokens}")
    assert all(r.state.value == "finished" for r in reqs)
    print("OK")


if __name__ == "__main__":
    main()
