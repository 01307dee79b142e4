"""§4.2 + §4.3 live on the port: serve with missing experts, restore in
background (``examples/degraded_serving.py`` over ``repro_torch``).

Loses an unreplicated MoE rank with role-switching disabled: ReviveMoE
masks the lost experts (accuracy-degraded but alive), then we flip the
policy and show a later role switch restores full weight integrity —
the paper's 'techniques are not mutually exclusive' point.

  PYTHONPATH=src python examples/degraded_serving_torch.py [--device cpu]
"""
import argparse
import dataclasses
import os
import tempfile

import numpy as np

from repro_torch.configs import get_smoke_config
from repro_torch.core.fault_codes import Severity
from repro_torch.core.weights import RecoveryPolicy
from repro_torch.serving.engine import EngineConfig, InferenceEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the card (its CUDA kernels), or the CPU (their "
                    "plain versions) only when asked")
    ap.add_argument("--workdir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_degraded"))
    args = ap.parse_args(argv)

    cfg = get_smoke_config("qwen2-moe-a2.7b")
    cfg = dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, num_redundant_experts=0))
    ec = EngineConfig(
        mode="disaggregated", num_dp=3, num_moe=2, max_batch=2,
        max_seq=64, block_size=8, num_blocks=64, workdir=args.workdir,
        policy=RecoveryPolicy(allow_role_switch=False,
                              min_ep_for_missing=2))
    eng = InferenceEngine(cfg, ec, device=args.device)
    rng = np.random.default_rng(3)
    reqs = [eng.submit(list(rng.integers(0, cfg.vocab_size, 8)), 12)
            for _ in range(6)]
    eng.injector.schedule(4, ec.num_dp, severity=Severity.L6,
                          component="moe", mid_step=True)
    eng.run(max_steps=200)

    rep = eng.reports[0]
    print("recovery:", rep.summary())
    mask = eng.runtime.expert_mask.cpu().numpy()
    print(f"serving DEGRADED: {(~mask).sum()}/{mask.size} experts masked "
          f"(coverage {eng.expert_map.coverage():.0%})")
    assert all(r.state.value == "finished" for r in reqs)

    # ... later: capacity is available again -> restore full integrity
    # (the role switch the policy deferred), as §4.3 describes
    from repro_torch.serving.weights_util import (
        load_expert_shard_from_checkpoint)
    failed_rank = 0
    shard = load_expert_shard_from_checkpoint(
        eng.ckpt_path, eng.shards[failed_rank], failed_rank)
    donor = eng.dp_executors[2]
    donor.drop_attention_state()
    donor.ep_rank = failed_rank
    donor.shard = shard
    eng.expert_map.install_rank(failed_rank)
    eng.runtime = eng.expert_map.runtime()
    eng.reassemble_params()
    print(f"background role switch complete: coverage "
          f"{eng.expert_map.coverage():.0%}, masks cleared = "
          f"{bool(eng.runtime.expert_mask.all())}")

    reqs2 = [eng.submit(list(rng.integers(0, cfg.vocab_size, 8)), 8)
             for _ in range(3)]
    eng.run(max_steps=100)
    assert all(r.state.value == "finished" for r in reqs2)
    print("OK — degraded service + eventual full restoration")


if __name__ == "__main__":
    main()
