"""Training launcher: real steps on the card (or the CPU when asked).

``repro.launch.train`` with its imports renamed, plus the options that
running on the card needs (``--device``, ``--dtype``, ``--layers``):

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-moe-a2.7b \\
      --smoke --steps 50 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-moe-a2.7b \\
      --layers 2 --steps 3 --batch 4 --seq 256     # full width, on the card

Without ``--smoke`` the arch's full config is trained, its depth cut to
``--layers`` (whole periods for the hybrid) as ``launch.serve`` cuts it.
``--aot`` traces rank 0's ``train_4k`` step on the production mesh
(``launch.dryrun.run_dryrun``, no extrapolation; ``--multi-pod`` for 2 x
16 x 16), as ``repro``'s lowers and compiles it:

  PYTHONPATH=src python -m repro_torch.launch.train --arch kimi-k2-1t-a32b \\
      --aot
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config, real training")
    ap.add_argument("--aot", action="store_true",
                    help="trace rank 0's train_4k step on the production "
                    "mesh (the dry run)")
    ap.add_argument("--multi-pod", action="store_true",
                    help="with --aot: the 2 x 16 x 16 mesh")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where to train: the card (its CUDA kernels), or "
                    "the CPU (their plain versions) only when asked")
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"],
                    help="the parameters' type (and AdamW's moments')")
    ap.add_argument("--layers", type=int, default=None, metavar="N",
                    help="cut the full config's depth to N layers (width "
                    "kept)")
    args = ap.parse_args(argv)

    if args.aot:
        from repro_torch.launch.dryrun import run_dryrun
        run_dryrun(args.arch, "train_4k", multi_pod=args.multi_pod,
                   extrapolate=False)
        return 0
    if args.smoke and args.layers is not None:
        ap.error("--layers cuts the depth of the full config (no --smoke)")

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serve import _config
    from repro_torch.models.model import Model
    from repro_torch.training.data import DataConfig, make_batch
    from repro_torch.training.train_loop import train

    cfg = (get_smoke_config(args.arch) if args.smoke else _config(
        argparse.Namespace(arch=args.arch, config="full",
                           layers=args.layers)))
    model = Model(cfg, getattr(torch, args.dtype), device=args.device)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                    batch_size=args.batch)

    def batches():
        step = 0
        while True:
            b = make_batch(dc, step)
            if cfg.family == "vlm":
                P = cfg.num_patches
                b = {"tokens": b["tokens"],
                     "patches": np.random.default_rng(step).normal(
                         size=(args.batch, P, cfg.d_model)).astype("float32"),
                     "loss_mask": b["loss_mask"]}
            if cfg.family == "audio":
                b["frames"] = np.random.default_rng(step).normal(
                    size=(args.batch, cfg.encoder_seq, cfg.d_model)
                ).astype("float32")
            yield b
            step += 1

    params, history = train(model, batches(), args.steps, log_every=10)
    for h in history:
        print(f"step {h['step']:5d} loss {h['loss']:.4f} "
              f"lr {h['lr']:.2e} gnorm {h['grad_norm']:.2f} "
              f"({h['elapsed_s']:.1f}s)")
    print(f"final loss: {history[-1]['loss']:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
