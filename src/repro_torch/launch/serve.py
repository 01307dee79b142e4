"""Serving launcher: FlowServe instance(s) with ReviveMoE recovery, on the
port's engines (``repro.launch.serve`` with its imports renamed, plus the
options that running on the card needs: ``--device``, ``--dtype``,
``--config`` and ``--layers``).

Single instance:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-moe-a2.7b \
      --mode disaggregated --requests 8 --inject-fault moe

Fleet mode — N instances + K hot spares behind the cluster router, with
restart-vs-revive-vs-spare arbitration and optional full-instance loss:
  PYTHONPATH=src python -m repro_torch.launch.serve --fleet 3 --spares 1 \
      --requests 24 --inject-fault moe --lose-instance 1

Streaming HTTP front end over a 2-instance fleet, on the card at full
width cut to 8 layers (``--device cpu`` runs the plain versions on the
CPU; nothing falls back to it):
  PYTHONPATH=src python -m repro_torch.launch.serve --fleet 2 \
      --mode collocated --http 8077 --config full --layers 8
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import tempfile

import numpy as np
import torch


def _run_fleet(args, cfg, dtype) -> int:
    from repro_torch.core.fault_codes import ErrorType, Severity
    from repro_torch.fleet import PoissonTraffic, build_fleet
    from repro_torch.serving.engine import EngineConfig

    ec = EngineConfig(mode=args.mode, num_dp=args.num_dp,
                      num_moe=args.num_moe, max_batch=4, max_seq=128,
                      block_size=16, num_blocks=256,
                      decode_impl=args.decode_impl,
                      overlap=args.overlap,
                      workdir=args.workdir)
    if args.http is not None:
        # HTTP mode: arrivals come from clients, not a synthetic trace
        fleet = build_fleet(cfg, ec, instances=args.fleet,
                            spares=args.spares,
                            force_policy=args.force_policy,
                            replenish_spares=args.replenish_spares,
                            kv_stream=not args.no_kv_stream,
                            device=args.device, dtype=dtype)
        from repro_torch.serving.frontend import serve_http
        # a fleet driver that failed ended every open stream with
        # finish_reason "error": the launcher fails with it
        return 0 if serve_http(fleet, host=args.http_host,
                               port=args.http) is None else 1
    traffic = PoissonTraffic(args.rate, cfg.vocab_size, prompt_len=12,
                             max_new_tokens=args.max_new, seed=0,
                             limit=args.requests)
    print(f"building fleet: {args.fleet} x [{args.arch} {args.mode} "
          f"{args.num_dp}DP+{args.num_moe if cfg.moe else 0}MoE] + "
          f"{args.spares} spare(s)")
    fleet = build_fleet(cfg, ec, instances=args.fleet,
                        spares=args.spares,
                        force_policy=args.force_policy, traffic=traffic,
                        replenish_spares=args.replenish_spares,
                        kv_stream=not args.no_kv_stream,
                        device=args.device, dtype=dtype)
    if args.inject_fault:
        pid = (args.num_dp if args.inject_fault == "moe"
               and args.mode == "disaggregated" else 1)
        fleet.instances[0].engine.injector.schedule(
            args.fault_step, pid, severity=Severity.L6,
            error_type=ErrorType.HBM_ECC, component=args.inject_fault,
            mid_step=True)
        print(f"scheduled {args.inject_fault} device fault on instance 0 "
              f"pid {pid} at engine step {args.fault_step}")
    lost = False
    for _ in range(4000):
        fleet.tick()
        if (args.lose_instance is not None and not lost
                and fleet.ticks == 2 * args.fault_step):
            print(f"injecting full loss of instance {args.lose_instance}")
            fleet.lose_instance(args.lose_instance)
            lost = True
        if traffic.exhausted and fleet.requests and not fleet.unfinished:
            break
    done = sum(r.state.value == "finished" for r in fleet.requests)
    ttfts = sorted(fleet.ttfts())
    print(f"\nfinished {done}/{len(fleet.requests)} requests in "
          f"{fleet.ticks} ticks ({fleet.now_s:.2f}s virtual)")
    if ttfts:
        print(f"TTFT p50={ttfts[len(ttfts) // 2] * 1e3:.0f}ms "
              f"max={ttfts[-1] * 1e3:.0f}ms")
    for line in fleet.log:
        print(" ", line)
    return 0 if done == len(fleet.requests) else 1


def _config(args):
    """The smoke config of ``--arch``, or its full config with the depth
    cut to ``--layers`` (the width kept)."""
    from repro_torch.configs import get_config, get_smoke_config
    if args.config == "smoke":
        return get_smoke_config(args.arch)
    cfg = get_config(args.arch)
    if args.layers is not None and args.layers != cfg.num_layers:
        least = cfg.moe.first_k_dense + 1 if cfg.moe is not None else 1
        period = cfg.hybrid_period or 1     # a hybrid cuts whole periods
        if not least <= args.layers <= cfg.num_layers or args.layers % period:
            raise SystemExit(f"--layers {args.layers}: {cfg.name} takes "
                             f"{max(least, period)} to {cfg.num_layers} "
                             f"layers" + (f", a multiple of {period}"
                                          if period > 1 else ""))
        print(f"config: {cfg.name} at full width (d_model {cfg.d_model}, "
              f"vocab {cfg.vocab_size}), depth cut from {cfg.num_layers} "
              f"to {args.layers} layers")
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    return cfg


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-moe-a2.7b")
    ap.add_argument("--mode", default="disaggregated",
                    choices=["collocated", "disaggregated"])
    ap.add_argument("--num-dp", type=int, default=2)
    ap.add_argument("--num-moe", type=int, default=2)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--inject-fault", default=None,
                    choices=[None, "attn", "moe"])
    ap.add_argument("--fault-step", type=int, default=5)
    ap.add_argument("--workdir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_serve"))
    ap.add_argument("--fleet", type=int, default=0, metavar="N",
                    help="run N instances behind the fleet router")
    ap.add_argument("--spares", type=int, default=0, metavar="K",
                    help="pre-warm K hot-spare instances (fleet mode)")
    ap.add_argument("--rate", type=float, default=50.0,
                    help="open-loop Poisson arrival rate (fleet mode)")
    ap.add_argument("--force-policy", default=None,
                    choices=[None, "revive", "restart", "spare"],
                    help="pin the recovery arbiter (fleet mode)")
    ap.add_argument("--lose-instance", type=int, default=None,
                    metavar="IID", help="inject a full-instance loss "
                    "(fleet mode)")
    ap.add_argument("--replenish-spares", action="store_true",
                    help="rebuild consumed standbys in the background "
                    "(fleet mode)")
    ap.add_argument("--decode-impl", default=None,
                    choices=[None, "composed", "megakernel"],
                    help="decode/chunk step implementation (megakernel "
                    "= fused attention+MoE step; default: model config)")
    ap.add_argument("--no-kv-stream", action="store_true",
                    help="force token-replay re-prefill on migration "
                    "(disable KV-block streaming)")
    ap.add_argument("--overlap", action="store_true",
                    help="async pipelined engine: plan step N+1 while "
                    "step N runs on device (token streams stay "
                    "bit-identical to lockstep)")
    ap.add_argument("--http", type=int, default=None, metavar="PORT",
                    help="serve an OpenAI-style HTTP front end "
                    "(/v1/completions with SSE streaming, /health, "
                    "/instances, /control) instead of a synthetic "
                    "request batch; 0 picks a free port")
    ap.add_argument("--http-host", default="127.0.0.1")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where every engine runs: the card (its CUDA "
                    "kernels), or the CPU (their plain versions) only "
                    "when asked")
    ap.add_argument("--dtype", default=None,
                    choices=[None, "bfloat16", "float32"],
                    help="weights' and pools' type (default: bfloat16 on "
                    "the card, float32 on the CPU)")
    ap.add_argument("--config", default="smoke", choices=["smoke", "full"],
                    help="the arch's reduced smoke config or its full one")
    ap.add_argument("--layers", type=int, default=None, metavar="N",
                    help="cut a full config's depth to N layers (width "
                    "kept)")
    args = ap.parse_args(argv)
    if args.layers is not None and args.config != "full":
        ap.error("--layers cuts the depth of --config full")
    if args.http is not None and args.fleet == 0:
        args.fleet = 1              # the front end drives a FleetRouter

    from repro_torch.core.fault_codes import ErrorType, Severity
    from repro_torch.serving.engine import EngineConfig, InferenceEngine

    cfg = _config(args)
    dtype = None if args.dtype is None else getattr(torch, args.dtype)
    if args.fleet > 0:
        return _run_fleet(args, cfg, dtype)
    ec = EngineConfig(mode=args.mode, num_dp=args.num_dp,
                      num_moe=args.num_moe, max_batch=4, max_seq=128,
                      block_size=16, num_blocks=256, workdir=args.workdir,
                      decode_impl=args.decode_impl, overlap=args.overlap)
    print(f"building engine: {args.arch} ({args.mode}, "
          f"{args.num_dp} DP + {args.num_moe if cfg.moe else 0} MoE ranks)")
    eng = InferenceEngine(cfg, ec, device=args.device, dtype=dtype)
    print("init timings:",
          {k: f"{v:.2f}s" for k, v in eng.init_timings.items()})

    rng = np.random.default_rng(0)
    reqs = [eng.submit(list(rng.integers(0, cfg.vocab_size, 12)),
                       args.max_new) for _ in range(args.requests)]

    if args.inject_fault:
        pid = (args.num_dp if args.inject_fault == "moe"
               and args.mode == "disaggregated" else 1)
        eng.injector.schedule(args.fault_step, pid, severity=Severity.L6,
                              error_type=ErrorType.HBM_ECC,
                              component=args.inject_fault, mid_step=True)
        print(f"scheduled {args.inject_fault} fault on device {pid} "
              f"at step {args.fault_step}")

    eng.run(max_steps=500)
    done = sum(r.state.value == "finished" for r in reqs)
    print(f"finished {done}/{len(reqs)} requests in {eng.step_no} steps")
    ttfts = sorted(r.ttft_s for r in reqs if r.ttft_s is not None)
    if ttfts:
        # single-engine mode has no virtual clock: wall TTFT is the metric
        print(f"TTFT p50={ttfts[len(ttfts) // 2] * 1e3:.0f}ms "
              f"max={ttfts[-1] * 1e3:.0f}ms")
    for rep in eng.reports:
        print("RECOVERY:", rep.summary())
        for a in rep.actions:
            print("   -", a)
    return 0 if done == len(reqs) else 1


if __name__ == "__main__":
    sys.exit(main())
