"""FlowServe-style inference engine with ReviveMoE recovery wired in.

One process simulates the whole deployment: executors are logical ranks
owning physically separate state (expert shards, KV caches, block
tables), so injected hardware failures destroy real state and recovery
manipulates real data structures and real weight files.

This is ``repro.serving.engine.InferenceEngine`` in collocated lockstep
mode (§2.2: every device hosts attention plus an EP expert shard), with
chunked admission or serial whole-prompt prefills.  A model without
experts (the Mamba family) has no expert map, runtime or shards: the
engine forces collocated mode, as the JAX package does, and a fault
revives its attention side alone.  ``EngineConfig``
keeps every field and every check of the JAX package's; options of later
slices raise ``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

import dataclasses
import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.comm_domain import CommDomain
from repro_torch.core.detection import (AnnotationPoller, HeartbeatMonitor,
                                        StragglerDetector)
from repro_torch.core.expert_map import ExpertMap
from repro_torch.core.faults import FaultInjector, SimulatedDeviceFailure
from repro_torch.core.graph_cache import GraphCache
from repro_torch.core.weights import DenseFFNGroups, RecoveryPolicy
from repro_torch.device import resolve_device
from repro_torch.models.model import Model
from repro_torch.serving.cache_ops import infer_paged_axes, install_prefill
from repro_torch.serving.executor import DPExecutor, next_bucket
from repro_torch.serving.request import Request, RequestState
from repro_torch.serving.sampling import SamplingParams
from repro_torch.serving.weights_util import (assemble, expert_checksums,
                                              save_shard_checkpoints,
                                              split_experts)
from repro_torch.training.checkpoint import load_params, save_checkpoint


class _Timer:
    def __init__(self, sink: Dict[str, float], key: str):
        self.sink, self.key = sink, key

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.sink[self.key] = self.sink.get(self.key, 0.0) + (
            time.perf_counter() - self.t0)


def _step_closure(model: Model, phase: str, version: int):
    # a chunked-prefill step IS a decode step over chunk-width virtual
    # slots (per-token page context); decode and chunk share the function
    def fn(params, cache, tokens, page, runtime):
        return model.decode_step_paged(params, cache, tokens, page, runtime)
    fn.__name__ = f"{phase}_v{version}"
    fn.__qualname__ = fn.__name__
    return fn


def _prefill_closure(model: Model, version: int):
    def fn(params, tokens, lengths, runtime):
        batch = {"tokens": tokens, "lengths": lengths}
        return model.prefill_paged(params, batch, runtime)
    fn.__name__ = f"prefill_v{version}"
    fn.__qualname__ = fn.__name__
    return fn


def _install_closure(axes_leaves, bucket: int):
    def fn(cache, raw, block_ids, slot):
        return install_prefill(cache, raw, axes_leaves, block_ids, slot)
    fn.__name__ = f"install_b{bucket}"
    fn.__qualname__ = fn.__name__
    return fn


class _Ctx:
    """What an executor sees during compute: weights + step functions."""

    def __init__(self, engine: "InferenceEngine"):
        self.engine = engine
        self.params = engine.params
        self.runtime = engine.runtime

    def decode_fn(self):
        return self.engine.get_compiled("decode")

    def chunk_fn(self):
        return self.engine.get_compiled("chunk")

    def prefill_fn(self, bucket: int):
        return self.engine.get_compiled("prefill", bucket)

    def install_fn(self, bucket: int):
        return self.engine.get_compiled("install", bucket)


@dataclass
class EngineConfig:
    mode: str = "collocated"            # 'collocated' | 'disaggregated'
    num_dp: int = 2
    num_moe: int = 2                    # disaggregated only
    max_batch: int = 4
    max_seq: int = 128
    block_size: int = 16
    num_blocks: int = 128
    sampling: SamplingParams = field(default_factory=SamplingParams)
    seed: int = 0
    workdir: str = "/tmp/repro_engine"
    policy: RecoveryPolicy = field(default_factory=RecoveryPolicy)
    precompile_failure_scenarios: bool = True
    persist_cache_dir: Optional[str] = None
    heartbeat_timeout_steps: int = 2
    # override ModelConfig.moe_impl ('fused' routes the MoE layer through
    # the fused dispatch->FFN->combine kernel); None keeps the model's
    moe_impl: Optional[str] = None
    # override ModelConfig.decode_impl; None keeps the model's
    decode_impl: Optional[str] = None
    # -- admission pipeline ---------------------------------------------------
    # 'chunked': token-budget continuous batching with chunked prefill;
    # 'serial': the legacy one-whole-prefill-per-step baseline
    admission: str = "chunked"
    prefill_chunk: int = 32             # batched chunk width (tokens)
    # per-step decode+prefill token target; None -> max_batch + chunk
    token_budget: Optional[int] = None
    # content-hash shared-prefix block reuse (COW at the divergence block)
    prefix_cache: bool = True
    # §3.3 device-pool rollback: 'rows' restores only the step's captured
    # write set; 'snapshot' keeps a copy of the whole cache per step
    pool_undo: str = "rows"
    # multi-token self-speculative decode window; 0/1 disables
    spec_window: int = 0
    # async pipelined engine (plan step N+1 while step N runs)
    overlap: bool = False

    def __post_init__(self):
        # ValueError (not assert) so misconfiguration still fails loudly
        # under `python -O`
        if self.mode not in ("collocated", "disaggregated"):
            raise ValueError(
                f"EngineConfig.mode must be 'collocated' or "
                f"'disaggregated', got {self.mode!r}")
        for name in ("num_dp", "max_batch", "max_seq", "block_size",
                     "num_blocks"):
            v = getattr(self, name)
            if not isinstance(v, int) or v < 1:
                raise ValueError(
                    f"EngineConfig.{name} must be a positive int, "
                    f"got {v!r}")
        if not isinstance(self.num_moe, int) or self.num_moe < 0:
            raise ValueError(
                f"EngineConfig.num_moe must be a non-negative int, "
                f"got {self.num_moe!r}")
        if self.heartbeat_timeout_steps < 1:
            raise ValueError(
                f"EngineConfig.heartbeat_timeout_steps must be >= 1, "
                f"got {self.heartbeat_timeout_steps!r}")
        if (self.moe_impl is not None
                and self.moe_impl not in ModelConfig.MOE_IMPLS):
            raise ValueError(
                f"EngineConfig.moe_impl must be one of "
                f"{ModelConfig.MOE_IMPLS} or None, got {self.moe_impl!r}")
        if (self.decode_impl is not None
                and self.decode_impl not in ModelConfig.DECODE_IMPLS):
            raise ValueError(
                f"EngineConfig.decode_impl must be one of "
                f"{ModelConfig.DECODE_IMPLS} or None, "
                f"got {self.decode_impl!r}")
        if self.admission not in ("chunked", "serial"):
            raise ValueError(
                f"EngineConfig.admission must be 'chunked' or 'serial', "
                f"got {self.admission!r}")
        if not isinstance(self.prefill_chunk, int) or self.prefill_chunk < 1:
            raise ValueError(
                f"EngineConfig.prefill_chunk must be a positive int, "
                f"got {self.prefill_chunk!r}")
        if self.token_budget is not None and (
                not isinstance(self.token_budget, int)
                or self.token_budget < 1):
            raise ValueError(
                f"EngineConfig.token_budget must be a positive int or "
                f"None, got {self.token_budget!r}")
        if self.pool_undo not in ("rows", "snapshot"):
            raise ValueError(
                f"EngineConfig.pool_undo must be 'rows' or 'snapshot', "
                f"got {self.pool_undo!r}")
        if not isinstance(self.spec_window, int) or self.spec_window < 0:
            raise ValueError(
                f"EngineConfig.spec_window must be a non-negative int, "
                f"got {self.spec_window!r}")
        if self.spec_window > self.prefill_chunk:
            raise ValueError(
                f"EngineConfig.spec_window ({self.spec_window}) cannot "
                f"exceed prefill_chunk ({self.prefill_chunk}) — verify "
                f"windows ride the chunk graph")
        if self.overlap and self.pool_undo != "rows":
            raise ValueError(
                "EngineConfig.overlap requires pool_undo='rows' — "
                "stacked plan-ahead frames restore per-frame write "
                "sets; the whole-pool snapshot cannot unwind one frame "
                "at a time")
        if self.overlap and self.admission != "chunked":
            raise ValueError(
                "EngineConfig.overlap requires admission='chunked' — "
                "whole-prefill installs synchronize with the device "
                "and cannot be planned ahead")


def check_ported(ec: EngineConfig) -> None:
    """Raise on the options whose slice of the port has not landed."""
    unported = [
        (ec.mode == "disaggregated", "mode='disaggregated'",
         "Queue 1: disaggregated mode with MoEExecutor and role switch"),
        (ec.overlap, "overlap=True",
         "Queue 1 item 7: the overlap pipeline"),
        (ec.spec_window > 1, f"spec_window={ec.spec_window}",
         "Queue 1 item 7: speculation"),
    ]
    for bad, what, item in unported:
        if bad:
            raise NotImplementedError(
                f"EngineConfig {what} is not ported yet (ROADMAP {item})")


@dataclass
class InstanceHealth:
    """Engine health surface consumed by the fleet control plane."""
    serving: bool                # >=1 healthy attention rank
    healthy_dp: int
    total_dp: int
    healthy_moe: int
    total_moe: int
    expert_coverage: float       # 1.0 = every logical expert has a live slot
    queue_depth: int             # waiting + running on healthy ranks
    unfinished: int
    soft_signals: Dict[int, float] = field(default_factory=dict)

    @property
    def degraded(self) -> bool:
        return (self.healthy_dp < self.total_dp
                or self.healthy_moe < self.total_moe
                or self.expert_coverage < 1.0
                or bool(self.soft_signals))


class InferenceEngine:
    def __init__(self, cfg: ModelConfig, engine_cfg: EngineConfig = None, *,
                 dtype: Optional[torch.dtype] = None, device=None):
        """``device``: the card unless the caller passes ``"cpu"``;
        ``dtype``: the weights' and pools' type (bf16 on the card, f32 on
        the CPU unless given)."""
        self.ecfg = engine_cfg or EngineConfig()
        if cfg.moe is None:
            # no expert ranks: disaggregated degenerates to collocated
            self.ecfg.mode = "collocated"
        check_ported(self.ecfg)
        if self.ecfg.moe_impl is not None and cfg.moe is not None:
            cfg = dataclasses.replace(cfg, moe_impl=self.ecfg.moe_impl)
        if self.ecfg.decode_impl is not None:
            cfg = dataclasses.replace(cfg, decode_impl=self.ecfg.decode_impl)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = dtype or (torch.bfloat16 if self.device.type == "cuda"
                               else torch.float32)
        self.init_timings: Dict[str, float] = {}
        self.step_no = 0
        self.reports: List[Any] = []
        self.all_requests: List[Request] = []
        self._handled_faults: set = set()
        # the collocated engine has no expert-only ranks
        self.moe_executors: List[Any] = []
        # latest straggler suspicion {physical_id: slowdown ratio}
        self.soft_signals: Dict[int, float] = {}
        # campaign determinism hook: a fixed virtual step duration for
        # straggler detection instead of the wall clock
        self.virtual_step_s: Optional[float] = None
        self._build()

    # -- construction -------------------------------------------------------------

    def _build(self) -> Dict[str, float]:
        ec = self.ecfg
        t: Dict[str, float] = {}
        with _Timer(t, "engine"):
            if ec.persist_cache_dir is None:
                ec.persist_cache_dir = os.path.join(ec.workdir, "graph_cache")
            self.graph_cache = GraphCache(ec.persist_cache_dir)
            self.injector = FaultInjector()
            self.poller = AnnotationPoller(self.injector)
            self.monitor = HeartbeatMonitor(ec.heartbeat_timeout_steps)
            self.straggler = StragglerDetector()
            self.model = Model(self.cfg, self.dtype, self.device)
            self.paged_axes = infer_paged_axes(self.model, ec.num_blocks,
                                               ec.block_size)
            os.makedirs(ec.workdir, exist_ok=True)
            self.ckpt_path = os.path.join(ec.workdir, "weights.npz")

        with _Timer(t, "generator"):
            # model instantiation + weight loading
            if os.path.exists(self.ckpt_path):
                self.params = load_params(self.ckpt_path, dtype=self.dtype,
                                          device=self.device)
            else:
                self.params = self.model.init(ec.seed)
                save_checkpoint(self.ckpt_path, self.params)
            moe = self.cfg.moe
            self.ep_size = ec.num_dp if moe is not None else 0
            self.shards = split_experts(self.params, self.ep_size)
            save_shard_checkpoints(ec.workdir, self.shards)
            self.expert_map = (ExpertMap(moe, self.ep_size,
                                         device=self.device)
                               if moe is not None else None)
            self.runtime = (self.expert_map.runtime()
                            if moe is not None else None)
            self.shard_alive = [True] * self.ep_size
            self._resident = [True] * self.ep_size
            self.dense_groups = (DenseFFNGroups(max(2, self.ep_size // 2))
                                 if moe is not None and moe.first_k_dense
                                 else None)

        with _Timer(t, "executor_processes"):
            self.dp_executors: List[DPExecutor] = [
                self._make_dp_executor(i) for i in range(ec.num_dp)]
            for ex in self.dp_executors:
                self.monitor.register(ex.physical_id, self.step_no)

        with _Timer(t, "distributed_groups"):
            self.world_group = [ex.physical_id for ex in self.dp_executors]

        with _Timer(t, "xccl"):
            self.domain = CommDomain(ec.num_dp, 0, collocated=True)
            self.domain.rebuild()

        # initial graph registration (Fig. 1 "Read Cache"/"Compile")
        v = self.domain.version
        phases = ("decode", "chunk") if self._chunking else ("decode",)
        for phase in phases:
            _, tm = self.graph_cache.get_or_compile(
                (phase, v, None), _step_closure(self.model, phase, v))
            t["read_cache"] = t.get("read_cache", 0.0) + tm.read_cache_s
            t["compile"] = t.get("compile", 0.0) + tm.compile_s

        if ec.precompile_failure_scenarios:
            with _Timer(t, "precompile_failure_scenarios"):
                self._precompile_failure_graphs()

        with _Timer(t, "other"):
            from repro_torch.core.revive import RecoveryManager
            self.recovery = RecoveryManager(self)
        self.init_timings = t
        return t

    def _make_dp_executor(self, i: int) -> DPExecutor:
        """Rank ``i``; collocated, it also hosts EP rank ``i``'s shard
        (a model without experts has none)."""
        ec = self.ecfg
        moe = self.cfg.moe is not None
        return DPExecutor(
            physical_id=i, dp_rank=i, model=self.model,
            max_batch=ec.max_batch, max_seq=ec.max_seq,
            num_blocks=ec.num_blocks, block_size=ec.block_size,
            sampling=ec.sampling, ep_rank=i if moe else None,
            shard=self.shards[i] if moe else None,
            paged_axes=self.paged_axes,
            admission=ec.admission,
            prefill_chunk=ec.prefill_chunk,
            token_budget=(ec.token_budget if ec.token_budget is not None
                          else ec.max_batch + ec.prefill_chunk),
            prefix_cache=ec.prefix_cache,
            pool_undo=ec.pool_undo)

    def _precompile_failure_graphs(self) -> None:
        """§3.6: the post-failure domain version's steps, ready before any
        fault.  Chunked admission re-prefills migrated requests through
        the chunk step; serial admission through the whole-prompt prefill
        of the most common bucket and its install."""
        v = self.domain.version + 1
        self.graph_cache.precompile(
            ("decode", v, None), _step_closure(self.model, "decode", v))
        if self._chunking:
            self.graph_cache.precompile(
                ("chunk", v, None), _step_closure(self.model, "chunk", v))
            return
        b = next_bucket(16, self.ecfg.max_seq)
        self.graph_cache.precompile(("prefill", v, b),
                                    _prefill_closure(self.model, v))
        if ("install", 0, b) not in self.graph_cache:
            self.graph_cache.precompile(
                ("install", 0, b), _install_closure(self.paged_axes, b))

    @property
    def _chunking(self) -> bool:
        return (self.ecfg.admission == "chunked"
                and self.model.supports_chunked_prefill)

    def get_compiled(self, phase: str, bucket: Optional[int] = None):
        # the install scatter has no collectives: it is domain-version
        # independent and survives every comm rebuild
        v = 0 if phase == "install" else self.domain.version
        key = (phase, v, bucket if phase in ("prefill", "install") else None)
        if phase == "install":
            fn = _install_closure(self.paged_axes, bucket)
        elif phase == "prefill":
            fn = _prefill_closure(self.model, v)
        else:
            fn = _step_closure(self.model, phase, v)
        fn, _ = self.graph_cache.get_or_compile(key, fn)
        return fn

    # -- request API ----------------------------------------------------------------

    def submit(self, prompt_tokens: List[int], max_new_tokens: int = 16,
               eos_token: Optional[int] = None) -> Request:
        req = Request(list(prompt_tokens), max_new_tokens,
                      eos_token=eos_token)
        self._assign(req)
        self.all_requests.append(req)
        return req

    # a prefix-affine executor may be at most this many requests busier
    # than the least-loaded one (cache hits must not create hotspots)
    ASSIGN_AFFINITY_SLACK = 4

    def _assign(self, req: Request) -> None:
        """Pick an attention rank for a request: least-loaded, biased
        toward in-instance prefix affinity — the DP executor whose
        BlockManager already holds the prompt's leading full-block
        digests serves the shared prefix from its cache, unless it is
        more than ``ASSIGN_AFFINITY_SLACK`` requests busier than the
        least-loaded executor."""
        healthy = [ex for ex in self.dp_executors
                   if ex.alive and ex.cache is not None]
        if not healthy:
            raise RuntimeError(
                "no healthy attention ranks left on this instance")
        least = min(healthy, key=lambda e: e.scheduler.num_requests)
        ex = least
        digests = None
        if (len(healthy) > 1 and self._chunking and self.ecfg.prefix_cache
                and len(req.tokens_so_far) > self.ecfg.block_size):
            from repro_torch.core.block_log import prompt_digests
            digests = prompt_digests(tuple(req.tokens_so_far),
                                     self.ecfg.block_size)
            best, best_hits = None, 0
            for cand in healthy:
                hits = cand.prefix_hit_blocks(digests,
                                              len(req.tokens_so_far))
                if hits > best_hits:
                    best, best_hits = cand, hits
            if (best is not None
                    and best.scheduler.num_requests
                    <= least.scheduler.num_requests
                    + self.ASSIGN_AFFINITY_SLACK):
                ex = best
        req.dp_rank = ex.dp_rank
        ex.scheduler.add_request(req)
        if digests is not None:
            ex.scheduler.memo_digests(req.req_id, digests)

    def health(self) -> InstanceHealth:
        healthy_dp = [ex for ex in self.dp_executors
                      if ex.alive and ex.cache is not None]
        return InstanceHealth(
            serving=bool(healthy_dp),
            healthy_dp=len(healthy_dp), total_dp=len(self.dp_executors),
            healthy_moe=0, total_moe=0,
            expert_coverage=(self.expert_map.coverage()
                             if self.expert_map is not None else 1.0),
            queue_depth=sum(ex.scheduler.num_requests
                            for ex in healthy_dp),
            unfinished=self.unfinished,
            soft_signals=dict(self.soft_signals))

    @property
    def unfinished(self) -> int:
        return sum(1 for r in self.all_requests
                   if r.state not in (RequestState.FINISHED,
                                      RequestState.FAILED))

    def prefill_stats(self) -> Dict[str, int]:
        """Admission counters across attention ranks: prefill tokens
        computed vs served from the shared-prefix cache, chunk count, and
        the BlockManagers' cache acquire/eviction counters."""
        out: Dict[str, int] = {}
        for ex in self.dp_executors:
            for k, val in ex.scheduler.stats.items():
                out[k] = out.get(k, 0) + val
            out["prefix_cache_hits"] = (out.get("prefix_cache_hits", 0)
                                        + ex.block_manager.cache_hits)
            out["prefix_cache_evictions"] = (
                out.get("prefix_cache_evictions", 0)
                + ex.block_manager.cache_evictions)
        return out

    # -- main loop --------------------------------------------------------------------

    def step(self) -> List[Request]:
        self.step_no += 1
        self.injector.pre_step_faults(self.step_no)
        for ev in self.poller.poll():
            self._handle(ev)
        for ev in self.monitor.check(self.step_no):
            self._handle(ev)

        active = [ex for ex in self.dp_executors
                  if ex.alive and ex.cache is not None
                  and ex.scheduler.num_requests]
        for ex in active:
            ex.plan()

        # mid-step faults fire while the collective step is in flight
        hit = False
        for ex in active:
            try:
                self.injector.maybe_fail_mid_step(self.step_no,
                                                  ex.physical_id)
            except SimulatedDeviceFailure:
                ex.fail_device()
                hit = True
        if hit:
            # global stop: the step aborts with uncommitted logs everywhere;
            # detection fires on the annotation just recorded
            for ev in self.poller.poll():
                self._handle(ev)
            return []

        finished: List[Request] = []
        ctx = _Ctx(self)
        for ex in active:
            t0 = time.perf_counter()
            n_timings = len(self.graph_cache.timings)
            finished.extend(ex.compute(ctx, self.step_no))
            ex.commit()
            # a step that built a graph (its first lookup of a key) is no
            # sample of the device's pace, as repro drops compile steps
            if self.graph_cache.fresh_since(n_timings):
                continue
            base = (self.virtual_step_s if self.virtual_step_s is not None
                    else time.perf_counter() - t0)
            self.straggler.record(ex.physical_id,
                                  base + ex.simulated_slowdown_s)
        self.soft_signals = self.straggler.suspects()
        for ev in self.straggler.check():
            self._handle(ev)
        for ex in self.dp_executors:
            if ex.alive:
                self.monitor.beat(ex.physical_id, self.step_no)
        return finished

    def run(self, max_steps: int = 1000) -> List[Request]:
        done: List[Request] = []
        for _ in range(max_steps):
            if not self.unfinished:
                break
            done.extend(self.step())
        return done

    # -- failure handling ------------------------------------------------------------

    def _handle(self, ev) -> None:
        if ev.rank in self._handled_faults:
            return
        self._handled_faults.add(ev.rank)
        self.reports.append(self.recovery.recover(ev))
        # inference was paused during recovery: reset the heartbeat clock
        # of every surviving executor so the pause is not taken for a hang
        for ex in self.dp_executors:
            if ex.alive:
                self.monitor.beat(ex.physical_id, self.step_no)

    # -- weight assembly -----------------------------------------------------------------

    def reassemble_params(self) -> None:
        """Zero the device bank's slices of ranks whose shard owner died
        (in place; see ``weights_util``)."""
        self.shard_alive = [self._shard_owner(r) is not None
                            for r in range(self.ep_size)]
        self._resident = assemble(self.params, self.shards,
                                  self.shard_alive, self._resident)

    def _shard_owner(self, ep_rank: int):
        """The executor currently hosting this EP rank's shard (or None)."""
        for ex in self.dp_executors:
            if ex.ep_rank == ep_rank and ex.device_alive \
                    and ex.shard is not None:
                return ex
        return None

    def expert_integrity(self) -> Tuple[List[float], List[bool]]:
        return expert_checksums(self.params, self.shard_alive), \
            self.shard_alive
