"""Train a small MoE LM for a few hundred steps on the synthetic pattern
task, checkpoint it, and restore the checkpoint
(``examples/train_moe.py`` over ``repro_torch``).

  PYTHONPATH=src python examples/train_moe_torch.py [--steps 300]
  PYTHONPATH=src python examples/train_moe_torch.py --device cpu
"""
import argparse
import dataclasses
import os
import tempfile

from repro_torch.configs import get_smoke_config
from repro_torch.models.model import Model
from repro_torch.training.checkpoint import restore_like, save_checkpoint
from repro_torch.training.data import DataConfig, lm_batches
from repro_torch.training.optimizer import OptimizerConfig
from repro_torch.training.train_loop import train


def config():
    """The qwen2-moe-a2.7b smoke config cut to a 64-token vocabulary and
    16 experts, top-2, capacity factor 2.0."""
    cfg = get_smoke_config("qwen2-moe-a2.7b")
    return dataclasses.replace(
        cfg, vocab_size=64,
        moe=dataclasses.replace(cfg.moe, num_experts=16, top_k=2,
                                capacity_factor=2.0))


def run(steps: int, device: str, params=None, log_every: int = 50):
    """Train ``steps`` steps (from ``params``, or from ``Model.init(0)``),
    printing the logged steps.  Returns (params, history)."""
    model = Model(config(), device=device)
    print(f"params: {model.count_params():,}")
    dc = DataConfig(vocab_size=model.cfg.vocab_size, seq_len=64,
                    batch_size=16)
    opt = OptimizerConfig(lr=2e-3, warmup_steps=30, total_steps=steps)
    params, hist = train(model, lm_batches(dc), steps, opt_cfg=opt,
                         log_every=log_every, params=params)
    for h in hist:
        print(f"  step {h['step']:4d}  loss {h['loss']:.4f}  "
              f"aux {h['aux']:.3f}  ({h['elapsed_s']:.0f}s)")
    return params, hist


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the card (its CUDA kernels), or the CPU (their "
                    "plain versions) only when asked")
    ap.add_argument("--workdir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_moe"))
    args = ap.parse_args(argv)

    params, hist = run(args.steps, args.device)
    assert hist[-1]["loss"] < hist[0]["loss"] * 0.8, "did not learn"

    path = os.path.join(args.workdir, "weights.npz")
    dt = save_checkpoint(path, params)
    print(f"checkpoint saved in {dt:.2f}s -> {path}")
    restore_like(path, params)
    print("checkpoint restores OK")


if __name__ == "__main__":
    main()
