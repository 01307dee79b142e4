"""Executors: DPExecutor (attention rank) and MoEExecutor (expert rank).

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

Self-speculative decode (``spec_window > 1``) rides the chunk launch: each
window re-forwards a request's last token plus its n-gram drafts, the
host verifies them with the seeded sampler (``spec_verify``), and the
pool rows of rejected drafts are restored from the step's capture.

The overlap pipeline (``overlap_step``) plans and launches step N+1
against the predicted post-N state before it drains step N: a sampling
epilogue on the device (``sampling.device_predict``) chains each step's
tokens into the next launch, and the logits and predicted tokens come
back through pinned buffers (``staging.readback``), one step late.  On
the card the launch half never waits on the device: every upload goes
through pinned memory (``staging.upload``), and the drain waits on its
launch's event alone.

This is ``repro.serving.executor``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.block_log import BlockLog, BlockManager, BlockTable
from repro_torch.core.migration import KVBlocks
from repro_torch.serving.cache_ops import (capture_pool_rows, clone_cache,
                                           copy_block_prefixes,
                                           gather_request_blocks,
                                           restore_pool_rows,
                                           restore_pool_rows_subset,
                                           scatter_request_blocks)
from repro_torch.serving.kvcache import (build_chunk_context,
                                         build_page_context,
                                         max_blocks_per_seq,
                                         padded_block_ids)
from repro_torch.serving.request import Request, RequestState
from repro_torch.serving.sampling import (SamplingParams, device_predict,
                                         sample, seeded_uniforms,
                                         spec_verify)
from repro_torch.serving.scheduler import (ChunkPiece, LocalScheduler,
                                           StepPlan)
from repro_torch.serving.staging import Readback, readback, upload


def next_bucket(n: int, max_seq: int, min_bucket: int = 16) -> int:
    """The whole-prompt prefill width of an ``n``-token prompt: the next
    power of two from ``min_bucket``, capped at ``max_seq``."""
    b = min_bucket
    while b < n:
        b *= 2
    return min(b, max_seq)


@dataclass
class _Point:
    """One sampling event of an in-flight step (overlap pipeline)."""
    req: Request
    kind: str                   # 'chunk_last' | 'spec' | 'decode'
    section: str                # which launch holds its logits
    row: int                    # logits row (chunk row0 / decode slot)
    win: Optional[ChunkPiece] = None
    guesses: List[int] = field(default_factory=list)
    positions: List[int] = field(default_factory=list)
    predicted_done: bool = False
    sidx: int = -1              # row in the device-predict arrays


@dataclass
class _Det:
    """Deterministic chunk bookkeeping applied at launch (plan-ahead):
    correct whatever the step's sampled outcome, undone only when the
    whole plan is rolled back (reconcile / fault abort)."""
    req: Request
    piece: ChunkPiece
    prev_prefill_pos: int
    prev_next_register: Optional[int]
    counted_was: bool


@dataclass
class _Actual:
    """Authoritative outcome of one sampling event, host-derived from
    the drained logits (pure — nothing mutated until the pipeline
    decides between confirm and reconcile)."""
    tokens: List[int]
    accepted: int
    finished: bool


class _Pending:
    """One launched-but-uncommitted step: its plan, the device logits of
    its chunk and decode launches (forced by ``finish_compute``, or, in
    the overlap pipeline, copied into pinned host buffers at launch and
    read one step late), the predicted tokens of each section, the requests
    its whole-prompt prefills finished, and the speculative host
    bookkeeping needed to confirm or unwind it."""
    __slots__ = ("plan", "step_no", "chunk_logits", "decode_logits",
                 "pred_chunk", "pred_decode", "points", "det",
                 "prefill_finished", "t_launch", "readback")

    def __init__(self, plan: StepPlan, step_no: int):
        self.plan = plan
        self.step_no = step_no
        self.chunk_logits = None
        self.decode_logits = None
        self.pred_chunk = None      # (targets, accepted): device, then host
        self.pred_decode = None
        self.points: List[_Point] = []
        self.det: List[_Det] = []
        self.prefill_finished: List[Request] = []
        self.t_launch = 0.0
        self.readback: Optional[Readback] = None

    def release(self) -> None:
        """The host is done with this step's device tensors and readback."""
        self.readback = None
        self.chunk_logits = self.decode_logits = None
        self.pred_chunk = self.pred_decode = None


def _host(logits) -> np.ndarray:
    """Logits as f32 numpy: a drained readback already is; a device
    tensor is forced (lockstep)."""
    if isinstance(logits, np.ndarray):
        return logits
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
                 pool_undo: str = "rows",
                 spec_window: int = 0):
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
            max_prefills=1 if admission == "serial" else None,
            spec_window=spec_window)
        self.cache = model.init_paged_cache(max_batch, num_blocks,
                                            block_size)
        self.paged_axes = paged_axes
        self.last_token = np.zeros((max_batch,), np.int32)
        self.steps_done = 0
        self._plan: Optional[StepPlan] = None
        # injected extra per-step latency (straggler simulation)
        self.simulated_slowdown_s = 0.0
        # overlap pipeline state: the launched-but-undrained step, plus a
        # device-resident next-token vector so step N+1's inputs chain
        # from step N without a host round trip
        self._inflight: Optional[_Pending] = None
        self._dev_last: Optional[torch.Tensor] = None
        self._dev_stale = True
        self.overlap_stats = {"steps": 0, "planned_ahead": 0,
                              "replans": 0, "drains": 0}
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

    def _upload(self, *arrays) -> List[torch.Tensor]:
        """Host arrays on this executor's device, in one staged copy
        that does not wait on the device (``staging.upload``)."""
        return upload(self.device, *arrays)

    def plan(self) -> StepPlan:
        self.block_log.begin_step()
        plan = self.scheduler.plan_step(self.block_log)
        if self.cache is not None:
            # §3.3 device half: capture exactly the rows this step will
            # write (known at plan time), or the legacy whole-cache copy
            if self.pool_undo == "snapshot":
                self.block_log.snapshot_pools(clone_cache(self.cache))
            else:
                self._capture(plan)
            # prefix-cache COW: seed private divergence blocks from the
            # shared sources *after* the capture (the copies are part of
            # the step's write set and roll back with it)
            self.cache = copy_block_prefixes(self.cache, self.paged_axes,
                                             plan.cow_copies,
                                             upload=self._upload)
        self._plan = plan
        return plan

    def _capture(self, plan: StepPlan) -> None:
        """§3.3 device half: gather the rows ``plan`` will write."""
        bids, offs = self._write_manifest(plan)
        self.block_log.record_pool_undo(capture_pool_rows(
            self.cache, self.paged_axes, bids, offs,
            upload=self._upload))

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
        if plan.chunks or plan.spec:
            # speculation windows ride the same launch right after the
            # prefill pieces; their manifest rows are what the verify
            # phase partially restores for rejected drafts
            n = 0
            for piece in plan.chunks + plan.spec:
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
        Lockstep: dispatch then commit back to back.  The overlap
        pipeline calls the same two halves a step apart."""
        return self.finish_compute(self.begin_compute(ctx, step_no))

    def begin_compute(self, ctx, step_no: int,
                      predict: bool = False) -> _Pending:
        """Dispatch the planned step's device work without forcing any
        result.  With ``predict`` (overlap pipeline) the launch's token
        inputs come from the device-resident chain instead of the host
        vector, and an epilogue samples the step's tokens on the device
        so the next step can launch before this one drains."""
        plan, self._plan = self._plan, None
        assert plan is not None, "compute without plan"
        pend = _Pending(plan, step_no)
        params, runtime = ctx.params, ctx.runtime

        if plan.chunks or plan.spec:
            tokens, page = build_chunk_context(
                plan.chunks + plan.spec, self.scheduler.block_tables,
                width=self.chunk_tokens, max_blk=self.max_blk,
                block_size=self.block_size, trash_block=self.trash_block)
            chain = self._chain_rows(plan) if predict and plan.spec else ()
            dev = self._upload(tokens, *page.values(), *chain)
            tok, pg = dev[0], dict(zip(page, dev[1:1 + len(page)]))
            if chain:
                tok = self._chain_chunk_tokens(tok, *dev[-2:])
            pend.chunk_logits, self.cache = ctx.chunk_fn()(
                params, self.cache, tok, pg, runtime)

        assert not (predict and plan.prefills), \
            "overlap requires chunked admission (no whole-prompt installs)"
        for req in plan.prefills:
            self._prefill_install(ctx, req, pend)

        if plan.decode:
            page = build_page_context(
                plan.decode, self.scheduler.block_tables,
                max_batch=self.max_batch, max_blk=self.max_blk,
                block_size=self.block_size, trash_block=self.trash_block)
            if predict:
                tok = self._dev_chain()
                pg = dict(zip(page, self._upload(*page.values())))
            else:
                tok, *dev = self._upload(self.last_token,
                                             *page.values())
                pg = dict(zip(page, dev))
            pend.decode_logits, self.cache = ctx.decode_fn()(
                params, self.cache, tok, pg, runtime)

        pend.t_launch = time.perf_counter()
        if predict:
            self._launch_predict(pend)
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
            ctx.params, *self._upload(padded, lengths), ctx.runtime)
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

    def finish_compute(self, pend: _Pending,
                       chunk_book: bool = True) -> List[Request]:
        """Force the step's logits and commit its outcome on the host
        (the authoritative sampler).  ``chunk_book=False`` skips the
        chunk-piece bookkeeping the overlap launch already applied."""
        plan = pend.plan
        finished: List[Request] = []
        t_done = None

        if pend.chunk_logits is not None:
            logits = _host(pend.chunk_logits)
            t_done = time.perf_counter()
            row = 0
            for piece in plan.chunks:
                req = piece.req
                if chunk_book:
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
            if plan.spec:
                finished.extend(self._verify_spec(plan, logits, row))

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
        self._dev_stale = True
        self.steps_done += 1
        return finished

    def _verify_spec(self, plan: StepPlan, logits: np.ndarray,
                     row0: int) -> List[Request]:
        """Commit each speculation window against the verifier logits.

        Window rows sit after the prefill-chunk rows in both the launch
        (logits rows) and the plan-time write manifest, in the same
        order — so a window's manifest indices are its logits rows
        shifted by the decode section.  Every emitted token is the
        seeded sampler's output at its own sequence position
        (``spec_verify``), keeping the stream token-identical to plain
        decode; pool rows written by rejected drafts are restored
        bit-exact, in place, from the §3.3 write-set capture (under the
        legacy snapshot strategy they are left stale, which is safe: a
        stale row's position is only ever attended after its true
        token's decode step rewrites it)."""
        finished: List[Request] = []
        undo = self.block_log.peek_pool_undo()
        base_manifest = self.max_batch if plan.decode else 0
        row = row0
        for win in plan.spec:
            req = win.req
            g = win.length
            base = req.num_tokens          # next position to commit
            drafts = win.tokens[base:]     # the g - 1 proposals
            toks, accepted = spec_verify(
                logits[row:row + g], drafts, self.sampling,
                start_step=base)
            emitted = 0
            for tok in toks:
                req.output_tokens.append(int(tok))
                req.note_token()
                self.last_token[req.batch_slot] = int(tok)
                emitted += 1
                if req.done or req.num_tokens >= self.max_seq:
                    break
            # window row r wrote the KV row of position base - 1 + r;
            # rows [emitted, g) hold drafts that were rejected (or never
            # reached) — scatter their pre-step rows back
            if emitted < g and undo is not None:
                idx = np.arange(base_manifest + row + emitted,
                                base_manifest + row + g, dtype=np.int64)
                self.cache = restore_pool_rows_subset(
                    self.cache, self.paged_axes, undo, idx,
                    upload=self._upload)
            self.scheduler.note_spec_done(win, emitted, accepted)
            self.scheduler.note_decode_progress(req, self.block_log)
            if req.done or req.num_tokens >= self.max_seq:
                self.scheduler.finish(req, self.block_log)
                req.finish_time = time.monotonic()
                finished.append(req)
            row += g
        return finished

    def commit(self) -> None:
        """Step boundary reached: the undo log is no longer needed."""
        self.block_log.begin_step()  # clears; committed counter advances

    def rollback_inflight(self) -> int:
        """§3.3: undo every uncommitted step — host block tables from the
        op log, device pools by restoring each frame's captured write-set
        rows (or the legacy whole-cache copy), newest frame first, so
        table and pool agree exactly on which rows are live.  Under the
        overlap pipeline this is *total*: the in-flight step's
        speculative token guesses and launch-time chunk bookkeeping
        unwind first, then both stacked frames — recovery then sees
        exactly the last committed state, and replay regenerates the lost
        step's tokens bit-identically (they are pure functions of
        seed/prefix/position)."""
        if self._inflight is not None:
            pend, self._inflight = self._inflight, None
            self._unwind_overlay(pend)
            self._unwind_det(pend)
            self.scheduler.unwind_plan_stats(pend.plan)
            pend.release()
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
        # admissions from the aborted step(s) return to the waiting queue
        self.scheduler.rollback_aborted()
        self._plan = None
        self._dev_stale = True
        return n

    def has_uncommitted(self) -> bool:
        """Anything between this executor and its last step boundary —
        logged block ops, an armed pool capture, a stacked plan-ahead
        frame, or an undrained launch.  (The overlap pipeline can hold
        speculative state with *zero* block ops — a pure-decode frame —
        so ``len(block_log) > 0`` alone is not a safe export guard.)"""
        return (self._inflight is not None
                or len(self.block_log) > 0
                or self.block_log.num_frames > 1
                or self.block_log.has_pool_state())

    # -- overlap pipeline (host/device overlap, async readback) -------------------
    #
    # Lifecycle per engine step k (one call to ``overlap_step``):
    #   1. plan step k against the *predicted* post-(k-1) state (the
    #      k-1 launch applied its guessed tokens as a speculative
    #      overlay, so the scheduler simply plans at the right
    #      positions), in a fresh undo frame stacked on k-1's;
    #   2. launch step k: token inputs chain from the device-resident
    #      next-token vector (never the host guesses), an epilogue
    #      samples k's tokens on the device, and the logits and token ids
    #      are copied into pinned host buffers behind an event;
    #   3. drain step k-1: wait on its event (one step late), re-derive
    #      the authoritative outcome with the host sampler, and either
    #      confirm (replace guessed values, commit the oldest frame) or
    #      reconcile (roll back k's frame + overlay, commit k-1's true
    #      outcome via the lockstep commit code, replan k).
    # A plan stays valid whenever the *shape* of the outcome matched —
    # per-event token counts, finishes, and the device-chain inputs the
    # next step consumed — so guessed token values never force replans
    # on their own.

    def overlap_step(self, ctx, step_no: int) -> List[Request]:
        prev = self._inflight
        nxt = None
        if self.scheduler.num_requests:
            nxt = self._plan_and_launch(ctx, step_no,
                                        stacked=prev is not None)
            if nxt is not None and prev is not None:
                self.overlap_stats["planned_ahead"] += 1
        finished: List[Request] = []
        if prev is not None:
            finished, diverged = self._drain(prev, nxt)
            if diverged:
                self.overlap_stats["replans"] += 1
                nxt = (self._plan_and_launch(ctx, step_no, stacked=False)
                       if self.scheduler.num_requests else None)
        self._inflight = nxt
        self.overlap_stats["steps"] += 1
        return finished

    def flush(self, ctx) -> List[Request]:
        """Drain the in-flight step without launching another (pipeline
        tail / engine quiesce)."""
        prev, self._inflight = self._inflight, None
        if prev is None:
            return []
        finished, _ = self._drain(prev, None)
        return finished

    def _plan_and_launch(self, ctx, step_no: int, *,
                         stacked: bool) -> Optional[_Pending]:
        """Plan-ahead half: plan in a (possibly stacked) undo frame,
        capture the write set, and dispatch.  Returns None when the
        scheduler has nothing plannable (pool/budget pressure)."""
        if stacked:
            self.block_log.push_frame()
        plan = self.scheduler.plan_step(self.block_log)
        if plan.empty:
            if stacked:
                self.block_log.undo_newest(self.block_manager,
                                           self.scheduler.block_tables)
            return None
        # the capture gathers post-(k-1) row values: it is enqueued after
        # k-1's compute on the stream, which is exactly what a rollback of
        # step k alone must restore
        self._capture(plan)
        self.cache = copy_block_prefixes(self.cache, self.paged_axes,
                                         plan.cow_copies,
                                         upload=self._upload)
        self._plan = plan
        return self.begin_compute(ctx, step_no, predict=True)

    def _dev_chain(self) -> torch.Tensor:
        """Device-resident last-token vector (refreshed from the host
        copy whenever the pipeline broke the chain)."""
        if self._dev_last is None or self._dev_stale:
            (self._dev_last,) = self._upload(self.last_token)
            self._dev_stale = False
        return self._dev_last

    def _chain_rows(self, plan: StepPlan) -> Tuple[np.ndarray, np.ndarray]:
        """The chunk-launch row of every speculation window's row 0, and
        its request's batch slot."""
        row = sum(p.length for p in plan.chunks)
        idx, slots = [], []
        for win in plan.spec:
            idx.append(row)
            slots.append(win.req.batch_slot)
            row += win.length
        return np.asarray(idx, np.int64), np.asarray(slots, np.int64)

    def _chain_chunk_tokens(self, tokens: torch.Tensor, idx: torch.Tensor,
                            slots: torch.Tensor) -> torch.Tensor:
        """Chunk-launch inputs with every speculative-window row 0 (the
        re-forwarded last committed token — a host-side *guess* under
        plan-ahead) overridden from the device chain, by an index on the
        device."""
        return tokens.index_put((idx,), self._dev_chain()[slots])

    def _launch_predict(self, pend: _Pending) -> None:
        """Device-side sampling epilogue: enumerate the step's sampling
        events, guess their outcomes for the overlay, sample their tokens
        on the device (position-seeded uniforms computed on the host),
        scatter the emitted last tokens into the device chain, and
        enqueue the readback of logits and token ids."""
        plan = pend.plan
        sched = self.scheduler
        points: List[_Point] = []
        row = 0
        for piece in plan.chunks:
            if piece.last:
                points.append(_Point(piece.req, "chunk_last", "chunk",
                                     row + piece.length - 1))
            row += piece.length
        for win in plan.spec:
            points.append(_Point(win.req, "spec", "chunk", row, win=win))
            row += win.length
        for req in plan.decode:
            points.append(_Point(req, "decode", "decode", req.batch_slot))

        # guesses + sample positions (pre-overlay state = the state the
        # in-flight inputs were built from)
        for pt in points:
            req = pt.req
            base = req.num_tokens
            if pt.kind == "spec":
                drafts = [int(t) for t in pt.win.tokens[base:]]
                bonus = sched.predict_next_token(req,
                                                 context=pt.win.tokens)
                pt.guesses = drafts + [bonus]
            else:
                pt.guesses = [sched.predict_next_token(req)]
            pt.positions = list(range(base, base + len(pt.guesses)))
        pend.points = points

        G = max(sched.spec_window, 1)
        S = self.max_batch

        def run_section(section: str, logits):
            sec = [pt for pt in points if pt.section == section]
            if not sec or logits is None:
                return None
            row0 = np.zeros(S, np.int32)
            lens = np.zeros(S, np.int32)
            drafts = np.zeros((S, G), np.int32)
            u = np.zeros((S, G), np.float32)
            slots = np.full(S, S, np.int32)   # out of range -> dropped
            for i, pt in enumerate(sec):
                pt.sidx = i
                row0[i] = pt.row
                lens[i] = len(pt.positions)
                slots[i] = pt.req.batch_slot
                if pt.kind == "spec":
                    dr = pt.guesses[:-1]      # the forwarded drafts
                    drafts[i, 1:1 + len(dr)] = dr
                if self.sampling.temperature > 0.0:
                    u[i, :len(pt.positions)] = seeded_uniforms(
                        self.sampling.seed,
                        np.asarray(pt.positions, np.int64))
            row0, lens, drafts, u, slots = self._upload(
                row0, lens, drafts, u, slots)
            targets, accepted, new_last = device_predict(
                logits, row0, lens, drafts, u, self._dev_chain(), slots,
                temperature=self.sampling.temperature,
                top_p=self.sampling.top_p)
            self._dev_last = new_last
            self._dev_stale = False
            return targets, accepted

        pend.pred_chunk = run_section("chunk", pend.chunk_logits)
        pend.pred_decode = run_section("decode", pend.decode_logits)
        self._launch_readback(pend)

        # deterministic chunk bookkeeping applies at launch (correct for
        # any sampled outcome; undone only with the whole frame)
        for piece in plan.chunks:
            req = piece.req
            info = sched._seq.get(req.req_id)
            pend.det.append(_Det(
                req, piece, req.prefill_pos,
                None if info is None else info.next_register,
                True if info is None else info.counted))
            req.prefill_pos = piece.start + piece.length
            sched.note_chunk_done(piece, self.block_log)

        # the speculative overlay: guessed tokens advance each request's
        # host-visible position so the next plan sees post-step state
        for pt in points:
            pt.req.apply_speculative(pt.guesses)
            pt.predicted_done = (pt.req.done
                                 or pt.req.num_tokens >= self.max_seq)

    def _launch_readback(self, pend: _Pending) -> None:
        """Enqueue the copies of the step's f32 logits and predicted
        tokens into pinned host buffers (the drain reads them)."""
        out = [x.float() for x in (pend.chunk_logits, pend.decode_logits)
               if x is not None]
        for pred in (pend.pred_chunk, pend.pred_decode):
            if pred is not None:
                out.extend(pred)
        pend.readback = readback(out)

    def _land_readback(self, pend: _Pending) -> None:
        """Wait for ``pend``'s readback (its event alone) and swap the
        host copies in for the device tensors."""
        it = iter(pend.readback.wait())
        if pend.chunk_logits is not None:
            pend.chunk_logits = next(it)
        if pend.decode_logits is not None:
            pend.decode_logits = next(it)
        if pend.pred_chunk is not None:
            pend.pred_chunk = (next(it), next(it))
        if pend.pred_decode is not None:
            pend.pred_decode = (next(it), next(it))

    def _unwind_overlay(self, pend: _Pending) -> None:
        for pt in reversed(pend.points):
            pt.req.unwind_speculative(len(pt.guesses))

    def _unwind_det(self, pend: _Pending) -> None:
        sched = self.scheduler
        for d in reversed(pend.det):
            d.req.prefill_pos = d.prev_prefill_pos
            info = sched._seq.get(d.req.req_id)
            if info is None:
                continue
            if d.prev_next_register is not None:
                info.next_register = d.prev_next_register
            if info.counted and not d.counted_was:
                info.counted = False
                sched.stats["prefill_tokens_cached"] -= info.cached_tokens

    def _unwind_pending(self, pend: _Pending) -> None:
        """Roll back a launched plan-ahead step completely: speculative
        overlay, launch-time bookkeeping, pool rows (restoring the
        post-(k-1) values its capture gathered), block ops, and any
        admissions of its frame."""
        self._unwind_overlay(pend)
        self._unwind_det(pend)
        self.scheduler.unwind_plan_stats(pend.plan)
        pend.release()
        undo = self.block_log.take_pool_undo()
        snap = self.block_log.take_pool_snapshot()
        if self.cache is not None:
            if undo is not None:
                self.cache = restore_pool_rows(self.cache,
                                               self.paged_axes, undo)
            elif snap is not None:
                self.cache = snap
        self.block_log.undo_newest(self.block_manager,
                                   self.scheduler.block_tables)
        self.scheduler.rollback_aborted()

    def _actual_outcome(self, pend: _Pending) -> List[_Actual]:
        """The authoritative outcome of each sampling event, re-derived
        from the drained logits with the host sampler — pure (no state
        mutated), replicating the lockstep commit's emit/finish logic
        against the *committed* (pre-overlay) positions."""
        out: List[_Actual] = []
        for pt in pend.points:
            req = pt.req
            committed = req.num_tokens - req.speculative_tokens
            committed_out = len(req.output_tokens) - req.speculative_tokens
            logits = (pend.chunk_logits if pt.section == "chunk"
                      else pend.decode_logits)
            if pt.kind == "spec":
                g = pt.win.length
                toks, accepted = spec_verify(
                    logits[pt.row:pt.row + g], pt.win.tokens[committed:],
                    self.sampling, start_step=committed)
            else:
                toks = sample(logits[pt.row][None], self.sampling,
                              step=committed)
                accepted = 0
            tokens: List[int] = []
            fin = False
            n_out = committed_out
            for t in toks:
                t = int(t)
                tokens.append(t)
                n_out += 1
                done = (n_out >= req.max_new_tokens
                        or (req.eos_token is not None
                            and t == req.eos_token))
                fin = done or committed + len(tokens) >= self.max_seq
                if fin:
                    break
            out.append(_Actual(tokens, accepted, fin))
        return out

    def _diverged(self, pend: _Pending, actual: List[_Actual]) -> bool:
        """Did the in-flight step's real outcome invalidate the stacked
        plan-ahead step?  Token *values* never do on their own — only
        the outcome's shape: emitted counts (spec accepts), finishes,
        and the device-chain tokens the next launch actually consumed
        as inputs (greedy prediction is exact; temperature>0 can
        diverge in the last ULP, costing a replan, never a token)."""
        pred = {"chunk": pend.pred_chunk, "decode": pend.pred_decode}
        for pt, act in zip(pend.points, actual):
            if len(act.tokens) != len(pt.guesses):
                return True
            if act.finished != pt.predicted_done:
                return True
            if not act.finished:
                targets, accepted = pred[pt.section]
                dev_tok = int(targets[pt.sidx, int(accepted[pt.sidx])])
                if dev_tok != act.tokens[-1]:
                    return True
        return False

    def _confirm(self, pend: _Pending,
                 actual: List[_Actual]) -> List[Request]:
        """Matched outcome: swap the authoritative token values in for
        the guesses and run the commit-side bookkeeping, targeting the
        *oldest* frame (this step's own — a stacked plan-ahead frame
        may sit on top)."""
        finished: List[Request] = []
        oldest = self.block_log.oldest()
        for pt, act in zip(pend.points, actual):
            req = pt.req
            req.confirm_speculative(act.tokens)
            req.note_token()
            self.last_token[req.batch_slot] = act.tokens[-1]
            if pt.kind == "spec":
                self.scheduler.note_spec_done(pt.win, len(act.tokens),
                                              act.accepted)
            if pt.kind in ("spec", "decode"):
                self.scheduler.note_decode_progress(req, oldest)
            if act.finished:
                self.scheduler.finish(req, oldest)
                req.finish_time = time.monotonic()
                finished.append(req)
        return finished

    def _drain(self, prev: _Pending,
               nxt: Optional[_Pending]) -> Tuple[List[Request], bool]:
        """Retire the in-flight step one launch late.  Returns
        ``(finished, diverged)``; on divergence the stacked plan-ahead
        step ``nxt`` has been fully unwound (newest-first, so pool rows
        restore in exact reverse temporal order) and the true outcome
        committed via the lockstep commit path."""
        self.overlap_stats["drains"] += 1
        self._land_readback(prev)
        self.perf["device_busy_s"] += time.perf_counter() - prev.t_launch
        actual = self._actual_outcome(prev)
        if not self._diverged(prev, actual):
            finished = self._confirm(prev, actual)
            prev.release()
            self.block_log.commit_oldest()
            self.steps_done += 1
            return finished, False
        # reconcile: unwind the mispredicted plan-ahead step first (its
        # pool capture holds post-prev values, so it must restore before
        # prev's own spec-reject restores), then pop prev's guesses and
        # replay its true outcome through the lockstep commit code
        if nxt is not None:
            self._unwind_pending(nxt)
        self._unwind_overlay(prev)
        prev.t_launch = time.perf_counter()   # busy already accounted
        finished = self.finish_compute(prev, chunk_book=False)
        prev.release()
        self.block_log.commit_oldest()
        self._dev_stale = True
        return finished, True

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
        this executor lacks a batch slot or enough free blocks."""
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
        self._dev_stale = True   # device token chain must re-sync
        return True
