"""End-to-end fleet failover demo on the port — the paper's scenario at fleet
scale:

A 3-instance fleet (each an MA-disaggregated FlowServe engine) plus one
pre-warmed hot spare serves an open-loop request stream.  Two failures
hit it live:

  ① an MoE NPU dies mid-step on instance 0 — the RecoveryArbiter weighs
     revive vs restart vs spare from its measured cost model and (with
     revive being orders cheaper) recovers in place, ReviveMoE-style;
  ② instance 1 is lost whole (host failure) — in-place revive is
     impossible, so the arbiter substitutes the hot spare and the
     router live-migrates every in-flight request onto it with
     prompt + generated-prefix re-prefill.

Every request still completes, and the per-request outcome table shows
who got hit, where each request ended up, and what it cost.

``examples/failover_serving.py`` over ``repro_torch``.  The fleet runs
on pinned virtual costs (``VirtualCostProfile``, the chaos campaigns'
determinism mode): a smoke engine builds in tens of milliseconds on the
card or the CPU, so a cost model fed wall-clock measurements prices a
restart below a revive with a quarter of the experts masked, and the
arbiter would restart where the demo means to revive.

  PYTHONPATH=src python examples/failover_serving_torch.py [--device cpu]
"""
import argparse
import dataclasses
import os
import tempfile

from repro_torch.configs import get_smoke_config
from repro_torch.core.fault_codes import ErrorType, Severity
from repro_torch.fleet import (PoissonTraffic, VirtualCostProfile,
                               build_fleet)
from repro_torch.serving.engine import EngineConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the card (its CUDA kernels), or the CPU (their "
                    "plain versions) only when asked")
    ap.add_argument("--workdir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_failover"))
    args = ap.parse_args(argv)

    cfg = get_smoke_config("qwen2-moe-a2.7b")
    cfg = dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, num_redundant_experts=2))
    ec = EngineConfig(mode="disaggregated", num_dp=2, num_moe=2,
                      max_batch=2, max_seq=96, block_size=8,
                      num_blocks=128, workdir=args.workdir)
    traffic = PoissonTraffic(40.0, cfg.vocab_size, prompt_len=10,
                             max_new_tokens=16, seed=7, limit=18)
    fleet = build_fleet(cfg, ec, instances=3, spares=1, traffic=traffic,
                        cost_profile=VirtualCostProfile(),
                        device=args.device)
    print(f"fleet: 3 instances x (2 DP + 2 MoE ranks, EP"
          f"{fleet.instances[0].engine.ep_size}) + 1 hot spare "
          f"(weights loaded, graphs precompiled)")

    # ① MoE NPU on instance 0 dies mid-step at its engine step 5
    fleet.instances[0].engine.injector.schedule(
        5, 2, severity=Severity.L6, error_type=ErrorType.HBM_ECC,
        component="moe", mid_step=True)

    lost = False
    for _ in range(3000):
        fleet.tick()
        # ② once instance 1 is mid-generation, its host goes away whole
        inst1 = fleet.instances[1]
        if (not lost and inst1.engine.unfinished > 0
                and any(r.output_tokens and r.state.value == "running"
                        for r in inst1.engine.all_requests)):
            fleet.lose_instance(1, "demo: host failure")
            lost = True
        if traffic.exhausted and fleet.requests and not fleet.unfinished:
            break

    print("\narbiter decisions + router actions:")
    for line in fleet.log:
        print("  ", line)

    print("\nper-request outcome:")
    for r in fleet.requests:
        m = fleet.meta[r.req_id]
        path = "->".join(str(i) for i in m["instances"])
        ttft = (f"{(m['first_token_s'] - m['arrival_s']) * 1e3:6.0f}ms"
                if m["first_token_s"] is not None else "   n/a")
        print(f"   req {r.req_id:3d}: {r.state.value:8s} "
              f"instances {path:9s} ttft {ttft} "
              f"tokens {len(r.output_tokens):2d} "
              f"xmigr {r.cross_instance_migrations} "
              f"re-prefilled {r.recomputed_tokens}")

    done = sum(r.state.value == "finished" for r in fleet.requests)
    migrated = sum(r.cross_instance_migrations for r in fleet.requests)
    states = {i.iid: i.state.value for i in fleet.instances.values()}
    print(f"\nfinished {done}/{len(fleet.requests)} requests; "
          f"{migrated} cross-instance migrations; instances: {states}")
    assert done == len(fleet.requests)
    revives = sum(len(i.engine.reports) for i in fleet.instances.values())
    assert revives >= 1, "expected at least one in-place revive"
    assert any(i.iid >= 1000 for i in fleet.instances.values()), \
        "expected the hot spare to have joined the serving set"
    print("OK — fleet survived a device fault (revived in place) and a "
          "full instance loss (spare substituted) without losing a "
          "single request")


if __name__ == "__main__":
    main()
