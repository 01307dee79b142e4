"""Shared setup of the fleet tests (test_torch_fleet_engine.py,
test_torch_fleet.py, test_torch_chaos.py): each scenario runs once per
package, on the same config, seed, prompts, fault schedule and
``weights.npz``, and the tests compare what the two runs leave behind.

A side (``JAX`` or ``TORCH``) bundles one package's entry points; the
port's engines run on the CPU in f32, so its kernels run as their plain
versions.  ``make_dirs`` gives each side a module workdir: the reference
side's first engine writes ``weights.npz`` there (and the XLA cache the
later reference builds read), and the port side's workdir gets a copy.
Holds no test of its own.
"""
import dataclasses
import functools
import json
import shutil
from types import SimpleNamespace

import numpy as np

import repro.fleet as jax_fleet
import repro_torch.fleet as torch_fleet
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import fault_codes as jax_codes
from repro.core.weights import RecoveryPolicy as JaxPolicy
from repro.serving.engine import EngineConfig as JaxEngineConfig
from repro.serving.engine import InferenceEngine as JaxEngine
from repro.serving.sampling import SamplingParams as JaxSampling
from repro_torch.configs import get_smoke_config
from repro_torch.core import fault_codes
from repro_torch.core.weights import RecoveryPolicy
from repro_torch.serving.engine import EngineConfig, InferenceEngine
from repro_torch.serving.sampling import SamplingParams

JAX = SimpleNamespace(
    name="repro", smoke=jax_smoke_config, EC=JaxEngineConfig,
    Engine=JaxEngine, fleet=jax_fleet, codes=jax_codes, SP=JaxSampling,
    Policy=JaxPolicy, kw={})
TORCH = SimpleNamespace(
    name="repro_torch", smoke=get_smoke_config, EC=EngineConfig,
    Engine=functools.partial(InferenceEngine, device="cpu"),
    fleet=torch_fleet, codes=fault_codes, SP=SamplingParams,
    Policy=RecoveryPolicy, kw=dict(device="cpu"))
SIDES = (JAX, TORCH)

# tests/test_fleet.py:48
PROMPT = list(np.random.default_rng(3).integers(0, 512, 9))


def fleet_cfg(side):
    """tests/test_fleet.py:28: the drop-free smoke MoE (the precondition
    for exact cross-instance replay)."""
    cfg = side.smoke("qwen2-moe-a2.7b")
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, num_experts=4,
                                     num_redundant_experts=2, top_k=2,
                                     capacity_factor=8.0,
                                     min_capacity=64))


def fleet_ecfg(side, workdir, **kw):
    """tests/test_fleet.py:38."""
    base = dict(mode="disaggregated", num_dp=2, num_moe=2, max_batch=2,
                max_seq=64, block_size=8, num_blocks=64,
                workdir=str(workdir))
    base.update(kw)
    return side.EC(**base)


def make_dirs(tmp_path_factory, name):
    """{side name: workdir}: the reference's first engine writes
    ``weights.npz``, which the port's workdir gets a copy of."""
    jdir = tmp_path_factory.mktemp(f"{name}_jax")
    pdir = tmp_path_factory.mktemp(f"{name}_torch")
    JAX.Engine(fleet_cfg(JAX), fleet_ecfg(JAX, jdir))
    shutil.copy(jdir / "weights.npz", pdir / "weights.npz")
    return {JAX.name: jdir, TORCH.name: pdir}


def both(dirs, scenario, *args, **kw):
    """``scenario(side, workdir, ...)`` run for each package; returns
    (reference result, port result)."""
    return tuple(scenario(s, dirs[s.name], *args, **kw) for s in SIDES)


def request_record(r):
    return dict(state=r.state.value, out=list(r.output_tokens),
                migrations=r.cross_instance_migrations,
                recomputed=r.recomputed_tokens, instance=r.instance_id)


def fleet_record(fleet):
    """What a fleet run leaves behind, comparable across packages: the
    gateway's requests in arrival order (their streams, migrations,
    instances), the forensics as sorted JSON, the router's counters, the
    arbiter's decisions, the virtual clock's TTFTs and the fleet's
    health."""
    spares = fleet.spares
    return dict(
        requests=[request_record(r) for r in fleet.requests],
        forensics=json.dumps(fleet.forensics, sort_keys=True),
        decisions=[(d.instance_id, d.policy, d.reason, d.proactive,
                    sorted(d.est_cost.items()))
                   for d in fleet.arbiter.decisions],
        counters=dict(
            ticks=fleet.ticks, now_s=fleet.now_s,
            shed=fleet.shed_requests, unfinished=fleet.unfinished,
            spares=None if spares is None else (
                spares.available, spares.activations,
                spares.replenishments)),
        instances=sorted((i.iid, i.state.value, i.model_id, i.restarts)
                         for i in fleet.instances.values()),
        ttfts=fleet.ttfts(),
        health=dataclasses.asdict(fleet.fleet_health()))


def profile(side):
    """The pinned virtual costs (campaign determinism mode): wall-clock
    charges differ between the packages, so the scenarios run on these
    in both."""
    return side.fleet.VirtualCostProfile()
