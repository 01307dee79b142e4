"""The attention rank's executor (DPExecutor), lockstep path.

A DPExecutor owns a local scheduler and the paged serving cache: block
pools (one trailing trash block for idle rows) addressed through the
``BlockManager``/``BlockTable`` accounting, with the §3.3 undo log
covering both the host-side block ops and the device-side pool writes
(row-level write-set capture by default; a whole-cache copy as the
legacy fallback).  Prefill runs as batched multi-request *chunks* —
prompt tokens become virtual decode slots against the pools — and decode
attends through per-step paging arrays (``kvcache.build_page_context``),
so continuous batching and recovery are pure data to the step.

Steps are two-phase to model collective lockstep: ``plan`` (host work —
admission, block allocation, prefix-cache sharing, all logged) then
``compute`` (the device step).  A fault between the phases leaves an
uncommitted log, which recovery rolls back (§3.3) — block tables from
the op log, pools by scattering the captured write-set rows back.

Under serial admission each admitted prompt is instead one whole-prompt
prefill (``Model.prefill_paged`` at a power-of-two bucket of its length)
installed into its blocks (``cache_ops.install_prefill``).

A role switch (§3.4) drops a healthy DP rank's attention duty: its
running requests' blocks stream to the other attention ranks
(``export_kv_blocks`` → ``import_kv_blocks``) instead of re-prefilling.
A ``MoEExecutor`` is an expert-only rank of the disaggregated mode.

This is ``repro.serving.executor`` on the lockstep path.  The overlap
pipeline and speculation windows are later slices of the port.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.block_log import BlockLog, BlockManager, BlockTable
from repro_torch.core.migration import KVBlocks
from repro_torch.serving.cache_ops import (capture_pool_rows, clone_cache,
                                           copy_block_prefixes,
                                           gather_request_blocks,
                                           restore_pool_rows,
                                           scatter_request_blocks)
from repro_torch.serving.kvcache import (build_chunk_context,
                                         build_page_context,
                                         max_blocks_per_seq,
                                         padded_block_ids)
from repro_torch.serving.request import Request, RequestState
from repro_torch.serving.sampling import SamplingParams, sample
from repro_torch.serving.scheduler import LocalScheduler, StepPlan


def next_bucket(n: int, max_seq: int, min_bucket: int = 16) -> int:
    """The whole-prompt prefill width of an ``n``-token prompt: the next
    power of two from ``min_bucket``, capped at ``max_seq``."""
    b = min_bucket
    while b < n:
        b *= 2
    return min(b, max_seq)


class _Pending:
    """One launched step: its plan, the device logits of its chunk and
    decode launches, forced by ``finish_compute``, and the requests its
    whole-prompt prefills finished."""
    __slots__ = ("plan", "step_no", "chunk_logits", "decode_logits",
                 "prefill_finished", "t_launch")

    def __init__(self, plan: StepPlan, step_no: int):
        self.plan = plan
        self.step_no = step_no
        self.chunk_logits = None
        self.decode_logits = None
        self.prefill_finished: List[Request] = []
        self.t_launch = 0.0


def _host(logits: torch.Tensor) -> np.ndarray:
    return logits.float().cpu().numpy()


class MoEExecutor:
    """Stateless expert host: one EP rank's slice of the physical slots
    (disaggregated mode)."""

    def __init__(self, physical_id: int, ep_rank: int,
                 shard: Dict[str, torch.Tensor]):
        self.physical_id = physical_id
        self.ep_rank = ep_rank
        self.shard: Optional[Dict[str, torch.Tensor]] = shard
        self.device_alive = True

    def fail_device(self) -> None:
        """Hardware gone: the only copies of these weights are lost."""
        self.device_alive = False
        self.shard = None

    def install_shard(self, shard: Dict[str, torch.Tensor]) -> None:
        """The device rejoined: it hosts ``shard`` (read from disk)."""
        self.shard = shard
        self.device_alive = True


class DPExecutor:
    def __init__(self, physical_id: int, dp_rank: int, model, *,
                 max_batch: int, max_seq: int, num_blocks: int,
                 block_size: int, sampling: SamplingParams,
                 paged_axes: List[Optional[int]],
                 ep_rank: Optional[int] = None,
                 shard: Optional[Dict[str, torch.Tensor]] = None,
                 admission: str = "chunked",
                 prefill_chunk: int = 32,
                 token_budget: Optional[int] = None,
                 prefix_cache: bool = True,
                 pool_undo: str = "rows"):
        self.physical_id = physical_id
        self.dp_rank = dp_rank
        self.model = model
        self.device = model.device
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.sampling = sampling
        self.device_alive = True
        self.process_alive = True
        # collocated mode: this device also hosts an expert shard
        self.ep_rank = ep_rank
        self.shard = shard

        self.block_size = block_size
        self.num_blocks = num_blocks
        self.max_blk = max_blocks_per_seq(max_seq, block_size)
        self.trash_block = num_blocks      # the extra pool row (see model)
        self.block_manager = BlockManager(num_blocks, block_size)
        self.block_log = BlockLog()
        self.pool_undo = pool_undo
        # serial admission installs whole prompts instead of chunking them
        chunk = (prefill_chunk if admission == "chunked"
                 and model.supports_chunked_prefill else 0)
        self.chunk_tokens = chunk
        self.scheduler = LocalScheduler(
            max_batch, max_seq, self.block_manager,
            token_budget=(token_budget if admission == "chunked" else None),
            chunk_tokens=chunk,
            prefix_cache=prefix_cache and chunk > 0,
            window=model.cfg.sliding_window or None,
            max_prefills=1 if admission == "serial" else None)
        self.cache = model.init_paged_cache(max_batch, num_blocks,
                                            block_size)
        self.paged_axes = paged_axes
        self.last_token = np.zeros((max_batch,), np.int32)
        self.steps_done = 0
        self._plan: Optional[StepPlan] = None
        # injected extra per-step latency (straggler simulation)
        self.simulated_slowdown_s = 0.0
        self.perf = {"device_busy_s": 0.0}

    # -- lifecycle --------------------------------------------------------------

    @property
    def alive(self) -> bool:
        return self.device_alive and self.process_alive

    def fail_device(self) -> None:
        self.device_alive = False
        if self.shard is not None:
            self.shard = None  # collocated: expert weights die too

    def terminate_process(self) -> None:
        """Engine-side isolation of the failed/hanging process."""
        self.process_alive = False
        self._plan = None

    def drop_attention_state(self, collect_kv: bool = False):
        """Role switch (§3.4): shed the KV cache, scheduler and attention
        duty.  Returns the requests that must migrate elsewhere; with
        ``collect_kv`` their live blocks are extracted *first* (the donor
        device is healthy, so its residents' KV can stream instead of
        re-prefilling) and the result is ``[(req, KVBlocks | None)]``."""
        payloads = {}
        if collect_kv:
            for req in list(self.scheduler.running):
                kv = self.export_kv_blocks(req)
                if kv is not None:
                    payloads[req.req_id] = kv
        reqs = self.scheduler.drain()
        self.cache = None
        self.block_log = BlockLog()
        if collect_kv:
            return [(r, payloads.get(r.req_id)) for r in reqs]
        return reqs

    def prefix_hit_blocks(self, digests, prompt_len: int) -> int:
        """How many *leading* full prompt blocks this executor's
        BlockManager can serve from its shared-prefix cache — the
        engine's in-instance affinity signal (``_assign``).  The prompt's
        final token is never cacheable, so the last block is skipped."""
        bs = self.block_size
        hits = 0
        for b, d in enumerate(digests):
            if (b + 1) * bs >= prompt_len:
                break
            if self.block_manager.lookup(d) is None:
                break
            hits += 1
        return hits

    # -- two-phase step -----------------------------------------------------------

    def plan(self) -> StepPlan:
        self.block_log.begin_step()
        plan = self.scheduler.plan_step(self.block_log)
        if self.cache is not None:
            # §3.3 device half: capture exactly the rows this step will
            # write (known at plan time), or the legacy whole-cache copy
            if self.pool_undo == "snapshot":
                self.block_log.snapshot_pools(clone_cache(self.cache))
            else:
                bids, offs = self._write_manifest(plan)
                self.block_log.record_pool_undo(capture_pool_rows(
                    self.cache, self.paged_axes, bids, offs))
            # prefix-cache COW: seed private divergence blocks from the
            # shared sources *after* the capture (the copies are part of
            # the step's write set and roll back with it)
            self.cache = copy_block_prefixes(self.cache, self.paged_axes,
                                             plan.cow_copies)
        self._plan = plan
        return plan

    def _write_manifest(self, plan: StepPlan
                        ) -> Tuple[np.ndarray, np.ndarray]:
        """Every (block, offset) pool row the planned step writes: decode
        destinations for all batch slots (idle slots hit the trash row),
        each chunk token's slot (idle chunk rows hit the trash row), every
        row of every padded block a whole-prompt install scatters (trash
        repeats included), and COW destination rows."""
        bs = self.block_size
        tables = self.scheduler.block_tables
        bids: List[int] = []
        offs: List[int] = []
        if plan.decode:
            row_bid = [self.trash_block] * self.max_batch
            row_off = [0] * self.max_batch
            for req in plan.decode:
                wp = req.num_tokens - 1
                blocks = tables[req.req_id].blocks
                row_bid[req.batch_slot] = blocks[wp // bs]
                row_off[req.batch_slot] = wp % bs
            bids += row_bid
            offs += row_off
        if plan.chunks:
            n = 0
            for piece in plan.chunks:
                blocks = tables[piece.req.req_id].blocks
                for j in range(piece.length):
                    pos = piece.start + j
                    bids.append(blocks[pos // bs])
                    offs.append(pos % bs)
                n += piece.length
            for _ in range(self.chunk_tokens - n):   # idle chunk rows
                bids.append(self.trash_block)
                offs.append(0)
        for req in plan.prefills:
            nblk = max_blocks_per_seq(
                next_bucket(len(req.tokens_so_far), self.max_seq), bs)
            pb = padded_block_ids(tables[req.req_id].blocks, nblk,
                                  self.trash_block)
            bids.extend(np.repeat(pb, bs).tolist())
            offs.extend(list(range(bs)) * nblk)
        for _, dst, n in plan.cow_copies:
            bids.extend([dst] * n)
            offs.extend(range(n))
        return np.asarray(bids, np.int32), np.asarray(offs, np.int32)

    def compute(self, ctx, step_no: int) -> List[Request]:
        """Run the planned step on the device; returns finished requests.
        Lockstep: dispatch then commit back to back (the overlap pipeline
        of a later slice calls the two halves a step apart)."""
        return self.finish_compute(self.begin_compute(ctx, step_no))

    def _to_device(self, page: Dict[str, np.ndarray]):
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in page.items()}

    def begin_compute(self, ctx, step_no: int) -> _Pending:
        """Dispatch the planned step's device work without forcing any
        result."""
        plan, self._plan = self._plan, None
        assert plan is not None, "compute without plan"
        pend = _Pending(plan, step_no)
        params, runtime = ctx.params, ctx.runtime

        if plan.chunks:
            tokens, page = build_chunk_context(
                plan.chunks, self.scheduler.block_tables,
                width=self.chunk_tokens, max_blk=self.max_blk,
                block_size=self.block_size, trash_block=self.trash_block)
            pend.chunk_logits, self.cache = ctx.chunk_fn()(
                params, self.cache, torch.from_numpy(tokens).to(self.device),
                self._to_device(page), runtime)

        for req in plan.prefills:
            self._prefill_install(ctx, req, pend)

        if plan.decode:
            page = build_page_context(
                plan.decode, self.scheduler.block_tables,
                max_batch=self.max_batch, max_blk=self.max_blk,
                block_size=self.block_size, trash_block=self.trash_block)
            pend.decode_logits, self.cache = ctx.decode_fn()(
                params, self.cache,
                torch.from_numpy(self.last_token).to(self.device),
                self._to_device(page), runtime)

        pend.t_launch = time.perf_counter()
        return pend

    def _prefill_install(self, ctx, req: Request, pend: _Pending) -> None:
        """One whole-prompt prefill at its bucket, its K/V installed into
        the request's blocks, its first token sampled (the prefill's
        logits are forced here, as in the JAX package)."""
        toks = req.tokens_so_far
        bucket = next_bucket(len(toks), self.max_seq)
        padded = np.zeros((1, bucket), np.int32)
        padded[0, :len(toks)] = toks
        lengths = np.asarray([len(toks)], np.int32)
        last_logits, raw = ctx.prefill_fn(bucket)(
            ctx.params, torch.from_numpy(padded).to(self.device),
            torch.from_numpy(lengths).to(self.device), ctx.runtime)
        bids = padded_block_ids(
            self.scheduler.block_tables[req.req_id].blocks,
            max_blocks_per_seq(bucket, self.block_size), self.trash_block)
        self.cache = ctx.install_fn(bucket)(self.cache, raw, bids,
                                            req.batch_slot)
        req.prefill_pos = len(toks)
        self.scheduler.note_prefill_done(len(toks))
        tok = int(sample(_host(last_logits), self.sampling,
                         step=req.num_tokens)[0])
        req.output_tokens.append(tok)
        req.note_token()
        req.state = RequestState.RUNNING
        self.last_token[req.batch_slot] = tok
        if req.done:
            self.scheduler.finish(req, self.block_log)
            req.finish_time = time.monotonic()
            pend.prefill_finished.append(req)

    def finish_compute(self, pend: _Pending) -> List[Request]:
        """Force the step's logits and commit its outcome on the host
        (the authoritative sampler)."""
        plan = pend.plan
        finished: List[Request] = []
        t_done = None

        if pend.chunk_logits is not None:
            logits = _host(pend.chunk_logits)
            t_done = time.perf_counter()
            row = 0
            for piece in plan.chunks:
                req = piece.req
                req.prefill_pos = piece.start + piece.length
                self.scheduler.note_chunk_done(piece, self.block_log)
                if piece.last:
                    # seed by sequence position, not engine step: the
                    # token is a pure function of (seed, prefix,
                    # position) and survives replay on any executor
                    tok = int(sample(logits[row + piece.length - 1][None],
                                     self.sampling,
                                     step=req.num_tokens)[0])
                    req.output_tokens.append(tok)
                    req.note_token()
                    req.state = RequestState.RUNNING
                    self.last_token[req.batch_slot] = tok
                    if req.done or req.num_tokens >= self.max_seq:
                        self.scheduler.finish(req, self.block_log)
                        req.finish_time = time.monotonic()
                        finished.append(req)
                row += piece.length

        finished.extend(pend.prefill_finished)

        if pend.decode_logits is not None:
            logits = _host(pend.decode_logits)
            t_done = time.perf_counter()
            # one batched sample over the whole decode batch
            slots = np.fromiter((r.batch_slot for r in plan.decode),
                                np.intp, count=len(plan.decode))
            positions = np.fromiter((r.num_tokens for r in plan.decode),
                                    np.int64, count=len(plan.decode))
            toks = sample(logits[slots], self.sampling, step=positions)
            for req, tok in zip(plan.decode, toks):
                tok = int(tok)
                req.output_tokens.append(tok)
                req.note_token()
                self.last_token[req.batch_slot] = tok
                # decode-grown blocks publish in the prefix cache as they
                # fill — register before a possible finish
                self.scheduler.note_decode_progress(req, self.block_log)
                if req.done or req.num_tokens >= self.max_seq:
                    self.scheduler.finish(req, self.block_log)
                    req.finish_time = time.monotonic()
                    finished.append(req)
        if t_done is not None:
            self.perf["device_busy_s"] += t_done - pend.t_launch
        self.steps_done += 1
        return finished

    def commit(self) -> None:
        """Step boundary reached: the undo log is no longer needed."""
        self.block_log.begin_step()  # clears; committed counter advances

    def rollback_inflight(self) -> int:
        """§3.3: undo the uncommitted step — host block tables from the op
        log, device pools by restoring the captured write-set rows (or
        the legacy whole-cache copy), so table and pool agree exactly on
        which rows are live.  Replay then regenerates the lost step's
        tokens bit-identically (they are pure functions of
        seed/prefix/position)."""
        n = 0
        for _ in range(self.block_log.num_frames):
            undo = self.block_log.take_pool_undo()
            snap = self.block_log.take_pool_snapshot()
            if self.cache is not None:
                if undo is not None:
                    self.cache = restore_pool_rows(
                        self.cache, self.paged_axes, undo)
                elif snap is not None:
                    self.cache = snap
            n += self.block_log.undo_newest(self.block_manager,
                                            self.scheduler.block_tables)
        # admissions from the aborted step return to the waiting queue
        self.scheduler.rollback_aborted()
        self._plan = None
        return n

    def has_uncommitted(self) -> bool:
        """Anything between this executor and its last step boundary."""
        return (len(self.block_log) > 0
                or self.block_log.num_frames > 1
                or self.block_log.has_pool_state())

    # -- KV-block migration (§3.2, streaming path) --------------------------------

    def export_kv_blocks(self, req: Request) -> Optional[KVBlocks]:
        """Extract a RUNNING request's live blocks and recurrent state, on
        this executor's device.

        None when this device's state is unreachable or the request has
        no installed KV yet (still WAITING, mid-chunked-prefill, or
        mid-migration) — callers fall back to token-replay re-prefill.
        Prefix-shared blocks are read in place, and window-released
        table entries (trash sentinels) ship no rows: the target's
        attention window masks them identically."""
        if self.cache is None or not self.alive:
            return None
        if req.state is not RequestState.RUNNING or req.batch_slot is None:
            return None
        if self.scheduler.prefilling(req):
            return None
        table = self.scheduler.block_tables.get(req.req_id)
        if table is None or not req.output_tokens:
            return None
        valid_len = req.num_tokens - 1   # last sampled token's KV is not
        if valid_len <= 0:               # written until its decode step
            return None
        nblk = (valid_len + self.block_size - 1) // self.block_size
        bids = table.blocks[:nblk]
        live_mask = [b < self.num_blocks for b in bids]
        live_bids = [b for b in bids if b < self.num_blocks]
        pools, state = gather_request_blocks(self.cache, self.paged_axes,
                                             live_bids, req.batch_slot)
        return KVBlocks(
            block_size=self.block_size, num_blocks=nblk,
            valid_len=valid_len, pool_blocks=pools, state=state,
            last_token=int(req.output_tokens[-1]), live_mask=live_mask)

    def import_kv_blocks(self, req: Request, kv: KVBlocks) -> bool:
        """Install streamed blocks: allocate fresh physical blocks here,
        scatter the payload in place, and adopt the request as RUNNING —
        it skips re-prefill and decodes on the next step.  False when
        this executor lacks a batch slot or enough free blocks.  (The
        lockstep executor feeds decode from ``last_token`` on the host:
        there is no device token chain to re-sync.)"""
        if self.cache is None or not self.alive:
            return False
        if kv.block_size != self.block_size:
            return False
        if not self.scheduler._free_slots:
            return False
        span = max(kv.num_blocks, self.scheduler._blocks_needed(
            min(req.num_tokens + 1, self.max_seq)))
        live = (kv.live_mask if kv.live_mask is not None
                else [True] * kv.num_blocks)
        # dead (window-released) entries install as trash sentinels; only
        # live payload blocks and the growth past the payload allocate
        need = sum(live) + (span - kv.num_blocks)
        if self.block_manager.num_allocatable < need:
            return False
        # import runs at a step boundary, so the block ops commit at once
        table = BlockTable(req.req_id)
        for j in range(span):
            if j < kv.num_blocks and not live[j]:
                table.append_block(self.trash_block)
            else:
                table.append_block(self.block_manager.allocate())
        self.scheduler.block_tables[req.req_id] = table
        req.batch_slot = self.scheduler._free_slots.pop()
        req.dp_rank = self.dp_rank
        req.state = RequestState.RUNNING
        self.scheduler.running.append(req)
        self.scheduler.register_imported(req)
        live_ids = [table.blocks[j] for j in range(kv.num_blocks) if live[j]]
        self.cache = scatter_request_blocks(
            self.cache, self.paged_axes, kv.pool_blocks, kv.state,
            live_ids, req.batch_slot)
        self.last_token[req.batch_slot] = kv.last_token
        return True
