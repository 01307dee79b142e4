"""Continuous-batching local scheduler (one per DPExecutor).

Plans a **token budget per step** (vLLM-style): every ongoing decode
costs one token, and the remaining budget admits prefill work — many
requests per step, each *chunked* so a long prompt interleaves with
ongoing decodes instead of stalling them.  Models whose prefill cannot
be chunked (recurrent state: SSM / hybrid) fall back to whole-prompt
prefills, still admitted under the same budget.

The scheduler also drives the content-hash **shared-prefix cache**:
admission matches the prompt's full blocks against the BlockManager's
digest index (ref-counted reuse, those tokens skip prefill compute
entirely) and plans a copy-on-write of the divergence block when a
cached block shares only the first few tokens.

All block accounting flows through the (logged) BlockManager so that a
mid-step failure can be rolled back exactly (§3.3).
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.core.block_log import (ROOT_DIGEST, BlockLog, BlockManager,
                                  BlockTable, block_digest, prompt_digests)
from repro_torch.serving.request import Request, RequestState


def ngram_propose(tokens, max_draft: int, n: int = 2) -> Tuple[int, ...]:
    """Self-draft proposer (prompt-lookup decoding): find the most recent
    *earlier* occurrence of the sequence's final ``n``-gram and propose
    the tokens that followed it.  Free (no model call, no extra state)
    and strong exactly where speculation pays — repetitive continuations
    (code, templated text, multi-turn echoes).  Returns () when the
    sequence is too short or the n-gram never recurred; the request then
    decodes one token as usual."""
    t = list(tokens)
    if max_draft < 1 or len(t) < n + 1:
        return ()
    key = t[-n:]
    for i in range(len(t) - n - 1, -1, -1):
        if t[i:i + n] == key:
            return tuple(t[i + n:i + n + max_draft])
    return ()


@dataclass
class ChunkPiece:
    """One request's slice of this step's batched prefill chunk.

    Speculation windows (``StepPlan.spec``) reuse this shape: ``start``
    is the last committed token's position (its KV row is unwritten —
    row 0 of the window re-forwards it), ``tokens`` is the committed
    sequence plus the proposed drafts, and ``length`` is the full
    verify width (1 + drafts)."""
    req: Request
    start: int                 # first position computed this step
    length: int                # tokens computed this step
    tokens: Tuple[int, ...]    # the full sequence being prefilled
    last: bool                 # completes the prefill -> sample a token


@dataclass
class StepPlan:
    chunks: List[ChunkPiece] = field(default_factory=list)
    prefills: List[Request] = field(default_factory=list)  # whole-prompt
    decode: List[Request] = field(default_factory=list)
    # self-speculative verify windows: decode-ready requests whose next
    # few tokens ride the chunk graph as virtual decode slots
    spec: List[ChunkPiece] = field(default_factory=list)
    # (src_bid, dst_bid, n_tokens) device copies for prefix-cache COW
    cow_copies: List[Tuple[int, int, int]] = field(default_factory=list)

    @property
    def prefill(self) -> Optional[Request]:
        """Legacy convenience: the first whole-prompt admission."""
        return self.prefills[0] if self.prefills else None

    @property
    def empty(self) -> bool:
        return not (self.chunks or self.prefills or self.decode
                    or self.spec)


@dataclass
class _SeqInfo:
    """Host-side prefill bookkeeping for one admitted request."""
    tokens: Tuple[int, ...]
    target: int                # tokens [0, target) must be installed
    digests: List[bytes] = field(default_factory=list)
    next_register: int = 0     # first block index not yet hash-published
    cached_tokens: int = 0     # prefix-cache hit length (skipped compute)
    counted: bool = False      # cached_tokens folded into stats yet?
    released_upto: int = 0     # blocks [0, released_upto) window-freed


class LocalScheduler:
    def __init__(self, max_batch: int, max_seq: int,
                 block_manager: BlockManager, *,
                 token_budget: Optional[int] = None,
                 chunk_tokens: int = 0,
                 prefix_cache: bool = False,
                 window: Optional[int] = None,
                 max_prefills: Optional[int] = None,
                 spec_window: int = 0):
        """``token_budget``: per-step decode+prefill token target (None =
        unbounded).  ``chunk_tokens`` > 0 enables chunked prefill with
        that batched-chunk width; 0 selects whole-prompt prefills.
        ``prefix_cache`` turns on content-hash block reuse (chunked path
        only).  ``window`` frees blocks the sliding attention window has
        passed.  ``max_prefills`` caps whole-prompt admissions per step
        (1 = the legacy one-prefill-per-step engine).  ``spec_window``
        > 1 plans self-speculative verify windows of up to that many
        tokens for decode-ready requests (needs the chunked path — the
        windows ride the compiled chunk graph)."""
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.block_manager = block_manager
        self.token_budget = token_budget
        self.chunk_tokens = chunk_tokens
        self.prefix_cache = prefix_cache and chunk_tokens > 0
        self.window = window
        self.max_prefills = max_prefills
        self.spec_window = spec_window if chunk_tokens > 0 else 0
        # speculation-window width histogram {planned rows: count}
        self.spec_hist: Dict[int, int] = {}
        self.waiting: deque[Request] = deque()
        self.running: List[Request] = []
        self.block_tables: Dict[int, BlockTable] = {}
        self._free_slots = list(range(max_batch - 1, -1, -1))
        self._seq: Dict[int, _SeqInfo] = {}
        self._digest_cache: Dict[int, List[bytes]] = {}
        self.stats = {"prefill_tokens_computed": 0,
                      "prefill_tokens_cached": 0,
                      "prefill_chunks": 0,
                      "blocks_window_freed": 0,
                      "spec_windows": 0,
                      "spec_drafts": 0,
                      "spec_accepted": 0,
                      "spec_emitted": 0}

    # -- queue management -----------------------------------------------------

    def add_request(self, req: Request) -> None:
        req.state = RequestState.WAITING
        req.prefill_pos = 0
        self._seq.pop(req.req_id, None)
        self._digest_cache.pop(req.req_id, None)
        self.waiting.append(req)

    def memo_digests(self, req_id: int, digests: List[bytes]) -> None:
        """Seed the per-request chain-digest memo (a caller — e.g. the
        engine's prefix-affine ``_assign`` — already hashed the prompt;
        admission must not rehash it).  Only valid after
        ``add_request``, which clears any stale entry first."""
        self._digest_cache[req_id] = digests

    def drain(self) -> List[Request]:
        """Remove and return every request (used for migration §3.2)."""
        reqs = list(self.waiting) + list(self.running)
        self.waiting.clear()
        for r in list(self.running):
            self._release(r, log=None)
        self.running.clear()
        self._digest_cache.clear()   # waiting heads memoized here too
        return reqs

    def requeue_front(self, req: Request) -> None:
        """Requeue-after-export: a request whose step was rolled back (or
        that came back from a failed export) re-enters at the queue front
        so its completed decode prefix is re-prefilled before new work.
        Re-admission runs through the normal budgeted path, so the
        requeued prefill is charged against the step token budget like
        any other arrival."""
        req.state = RequestState.WAITING
        req.prefill_pos = 0
        self._seq.pop(req.req_id, None)
        self._digest_cache.pop(req.req_id, None)
        self.waiting.appendleft(req)

    def rollback_aborted(self) -> List[Request]:
        """After ``BlockLog.undo_all``: admissions from the aborted step
        (their allocs were all undone, leaving an empty block table)
        return to the waiting queue front.  Requeued in *reverse*
        admission order — each ``requeue_front`` prepends, so walking
        the aborted list backwards restores the original FIFO order
        when one step admitted several requests."""
        aborted = [r for r in self.running
                   if self.block_tables[r.req_id].num_blocks() == 0]
        for r in reversed(aborted):
            self.running.remove(r)
            del self.block_tables[r.req_id]
            if r.batch_slot is not None:
                self._free_slots.append(r.batch_slot)
                r.batch_slot = None
            self.requeue_front(r)
        return aborted

    def register_imported(self, req: Request) -> None:
        """Adopt a KV-block-streamed request (import path): its prefix is
        fully installed, so it decodes on the next step.  Its installed
        blocks register in the prefix cache immediately (carry-over (f))
        — a migrated conversation's prefix is shareable on the target
        from the moment it lands.  Import runs at a step boundary, so
        the registrations commit unlogged."""
        toks = tuple(req.tokens_so_far)
        req.prefill_pos = len(toks)
        info = _SeqInfo(tokens=toks, target=len(toks))
        self._seq[req.req_id] = info
        if self.prefix_cache:
            info.digests = prompt_digests(
                toks, self.block_manager.block_size)
            # KV rows exist for positions [0, num_tokens - 1): exactly
            # the full blocks below that bound are publishable
            self._register_upto(req, info, req.num_tokens - 1, None)

    def check_consistent(self) -> None:
        """Invariant check used by tests and cross-instance migration:
        slots + block tables exactly mirror the running set."""
        slots = [r.batch_slot for r in self.running]
        if None in slots or len(set(slots)) != len(slots):
            raise AssertionError(f"running slots corrupt: {slots}")
        if set(self._free_slots) & set(slots):
            raise AssertionError(
                f"slot both free and in use: {self._free_slots} vs {slots}")
        if len(self._free_slots) + len(slots) != self.max_batch:
            raise AssertionError(
                f"slot accounting leak: {len(self._free_slots)} free + "
                f"{len(slots)} running != {self.max_batch}")
        table_ids = set(self.block_tables)
        running_ids = {r.req_id for r in self.running}
        if table_ids != running_ids:
            raise AssertionError(
                f"block tables {table_ids} != running {running_ids}")

    @property
    def num_requests(self) -> int:
        return len(self.waiting) + len(self.running)

    def prefilling(self, req: Request) -> bool:
        info = self._seq.get(req.req_id)
        return info is not None and req.prefill_pos < info.target

    def prefill_target(self, req: Request) -> int:
        return self._seq[req.req_id].target

    # -- step planning ----------------------------------------------------------

    def _blocks_needed(self, n_tokens: int) -> int:
        bs = self.block_manager.block_size
        return (n_tokens + bs - 1) // bs

    @property
    def _trash(self) -> int:
        """Released table entries point at the pool's trash row (always
        masked by the window lower bound — readers never see it)."""
        return self.block_manager.num_blocks

    def plan_step(self, log: BlockLog) -> StepPlan:
        """Plan one generation step under the token budget.

        All block allocations / releases / cache acquisitions are
        recorded in ``log`` so a mid-step fault rolls back exactly.
        """
        plan = StepPlan()
        budget = (self.token_budget if self.token_budget is not None
                  else float("inf"))
        # 1. ongoing decodes first: a growing sequence may need a new
        #    block; sequences the window moved past release old ones.
        #    With speculation on, a decode-ready request whose n-gram
        #    proposer has drafts becomes a verify window on the chunk
        #    graph instead (it shares the chunk width with prefills)
        spec_room = self.chunk_tokens
        for req in self.running:
            if req.done or self.prefilling(req):
                continue
            pos = req.num_tokens  # position the next token will occupy
            # this step writes position pos - 1 and attends seq_len = pos
            # (build_page_context): release strictly below pos - window
            # BEFORE growing — at pool exhaustion the request's own dead
            # blocks must be able to feed its next allocation
            self._release_out_of_window(req, pos, log)
            g = self._plan_spec(plan, req, pos, spec_room, log)
            if g:
                spec_room -= g
                budget -= g
                continue
            table = self.block_tables[req.req_id]
            if self._blocks_needed(pos + 1) > table.num_blocks():
                bid = self.block_manager.allocate(log)
                table.append_block(bid, log)
            plan.decode.append(req)
        budget -= len(plan.decode)

        # 2. continue in-flight chunked prefills (admission order)
        room = spec_room
        for req in self.running:
            if room <= 0 or budget <= 0:
                break
            info = self._seq.get(req.req_id)
            if info is None or req.prefill_pos >= info.target:
                continue
            take = int(min(info.target - req.prefill_pos, room, budget))
            # windowed prompts: blocks every remaining chunk token has
            # already slid past are dead — free them BEFORE growing the
            # table, so an exhausted pool refills from the request's own
            # dead blocks instead of livelocking with take clamped to 0
            self._release_out_of_window(req, req.prefill_pos + 1, log)
            take = self._ensure_coverage(req, take, log)
            if take < 1:
                continue
            self._plan_piece(plan, req, info, take, log)
            room -= take
            budget -= take

        # 3. admissions
        while self.waiting and self._free_slots:
            if self.chunk_tokens > 0:
                if room <= 0 or budget <= 0:
                    break
                cap = room if budget == float("inf") else min(
                    room, int(budget))
                take = self._admit_chunked(plan, self.waiting[0], cap, log)
                if take is None:
                    break       # FIFO: blocked head defers the rest
                room -= take
                budget -= take
            else:
                if (self.max_prefills is not None
                        and len(plan.prefills) >= self.max_prefills):
                    break
                # the first whole-prompt prefill may overflow the budget
                # (a prompt longer than the budget must still admit);
                # later ones need headroom
                req = self.waiting[0]
                cost = len(req.tokens_so_far)
                if plan.prefills and budget < cost:
                    break
                if not self._admit_whole(req, log):
                    break
                plan.prefills.append(req)
                budget -= cost
        return plan

    def _plan_spec(self, plan: StepPlan, req: Request, pos: int,
                   room: int, log: BlockLog) -> int:
        """Plan a self-speculative verify window for a decode-ready
        request.  The window is a chunk piece over ``g`` virtual decode
        slots — row 0 re-forwards the last committed token (position
        ``pos - 1``, whose KV row this step writes anyway), rows 1..g-1
        forward the n-gram drafts — so it reuses the compiled chunk
        graph verbatim.  The block table grows to cover every window
        write position; pool pressure shrinks the window (a width-1
        window is just a decode and falls back to the decode batch).
        Returns the verify rows planned (0 = plain decode)."""
        if self.spec_window <= 1 or room <= 1:
            return 0
        limit = min(self.spec_window, room,
                    req.max_new_tokens - len(req.output_tokens),
                    self.max_seq - pos + 1)
        if limit <= 1:
            return 0
        drafts = ngram_propose(req.tokens_so_far, limit - 1)
        if not drafts:
            return 0
        g = 1 + len(drafts)
        # cover write positions pos - 1 .. pos + g - 2
        table = self.block_tables[req.req_id]
        bs = self.block_manager.block_size
        grow = self._blocks_needed(pos + g - 1) - table.num_blocks()
        if grow > 0:
            grow = min(grow, self.block_manager.num_allocatable)
            for _ in range(grow):
                table.append_block(self.block_manager.allocate(log), log)
            g = min(g, table.num_blocks() * bs - pos + 1)
        if g <= 1:
            return 0
        toks = tuple(req.tokens_so_far) + drafts[:g - 1]
        plan.spec.append(ChunkPiece(req, pos - 1, g, toks, last=False))
        self.stats["spec_windows"] += 1
        self.stats["spec_drafts"] += g - 1
        self.spec_hist[g] = self.spec_hist.get(g, 0) + 1
        return g

    # -- plan-ahead (overlap pipeline) --------------------------------------------

    def predict_next_token(self, req: Request, context=None) -> int:
        """Value guess for the token an in-flight device step will emit
        for ``req``, so the *next* step can be planned before this one
        drains.  Uses the n-gram proposer (free, and right exactly where
        drafts are right); falls back to repeating the last token.  The
        guess only shapes plan quality — drafts proposed from it, the
        planner's done-check — never the emitted stream: the host
        sampler re-derives every token from the drained logits and is
        authoritative.  It is sanitized away from EOS so plan-ahead
        never skips a request on a guessed finish."""
        toks = list(context) if context is not None else req.tokens_so_far
        prop = ngram_propose(toks, 1)
        guess = int(prop[0]) if prop else (int(toks[-1]) if toks else 0)
        if req.eos_token is not None and guess == int(req.eos_token):
            guess = 0 if guess != 0 else 1
        return guess

    def unwind_plan_stats(self, plan: "StepPlan") -> None:
        """Reconcile path: a plan-ahead step was rolled back before it
        committed — back out the advisory counters its plan/launch
        bumped so the relaunched step doesn't double-count."""
        for piece in plan.chunks:
            self.stats["prefill_tokens_computed"] -= piece.length
            self.stats["prefill_chunks"] -= 1
        for win in plan.spec:
            self.stats["spec_windows"] -= 1
            self.stats["spec_drafts"] -= win.length - 1
            self.spec_hist[win.length] -= 1

    # -- admission internals -----------------------------------------------------

    def _ensure_coverage(self, req: Request, take: int,
                         log: BlockLog) -> int:
        """Grow the block table to cover the next chunk piece.

        Windowed prompts allocate lazily (admission only covered the
        first piece), so a long prompt never holds O(prompt) blocks —
        paired with the in-prefill window release, occupancy stays
        O(window + chunk).  When the pool cannot cover the whole piece,
        the piece shrinks to what fits (the request resumes next step)."""
        table = self.block_tables[req.req_id]
        bs = self.block_manager.block_size
        need = self._blocks_needed(req.prefill_pos + take)
        grow = need - table.num_blocks()
        if grow > 0:
            grow = min(grow, self.block_manager.num_allocatable)
            for _ in range(grow):
                table.append_block(self.block_manager.allocate(log), log)
            take = min(take, table.num_blocks() * bs - req.prefill_pos)
        return take

    def _plan_piece(self, plan: StepPlan, req: Request, info: _SeqInfo,
                    take: int, log: BlockLog) -> None:
        start = req.prefill_pos
        last = start + take >= info.target
        plan.chunks.append(ChunkPiece(req, start, take, info.tokens, last))

    def _register_upto(self, req: Request, info: _SeqInfo, upto: int,
                       log: Optional[BlockLog]) -> None:
        """Publish prompt blocks whose content is now installed under
        their chain digests.  Called from the *compute* phase, after the
        chunk scatter ran — a digest must never be matchable before its
        rows exist, or a same-step admission would share garbage."""
        bs = self.block_manager.block_size
        table = self.block_tables[req.req_id]
        while (info.next_register < len(info.digests)
               and (info.next_register + 1) * bs <= upto):
            b = info.next_register
            bid = table.blocks[b]
            if bid < self.block_manager.num_blocks:  # not released
                parent = info.digests[b - 1] if b else ROOT_DIGEST
                self.block_manager.register(
                    bid, info.digests[b], parent,
                    info.tokens[b * bs:(b + 1) * bs], log)
            info.next_register += 1

    def _admit_chunked(self, plan: StepPlan, req: Request, take_cap: int,
                       log: BlockLog) -> Optional[int]:
        """Admit the queue head onto the chunked path; returns the token
        cost of its first piece (None = cannot admit this step)."""
        bm = self.block_manager
        bs = bm.block_size
        toks = tuple(req.tokens_so_far)
        target = len(toks)
        # memoized per request: a head-of-line prompt that cannot admit
        # for many steps (pool pressure) must not rehash every plan
        digests: List[bytes] = []
        if self.prefix_cache:
            digests = self._digest_cache.get(req.req_id)
            if digests is None:
                digests = prompt_digests(toks, bs)
                self._digest_cache[req.req_id] = digests

        # full-block prefix hits — never the entire prompt: the final
        # token must be computed to produce the first-sample logits
        matched: List[bytes] = []
        parked = 0
        for b, d in enumerate(digests):
            if (b + 1) * bs >= target:
                break
            bid = bm.lookup(d)
            if bid is None:
                break
            matched.append(d)
            if bm.ref_count(bid) == 0:
                parked += 1
        # copy-on-write at the divergence block: a cached block sharing
        # the first q tokens after the matched prefix seeds the
        # request's private block via a device row copy
        cow_src, cow_q = None, 0
        if self.prefix_cache:
            parent = matched[-1] if matched else ROOT_DIGEST
            rem = toks[len(matched) * bs: target - 1][:bs]
            if rem:
                for bid, cand in bm.children_of(parent):
                    q = 0
                    for a, c in zip(rem, cand):
                        if a != c:
                            break
                        q += 1
                    if q > cow_q:
                        cow_src, cow_q = bid, q

        cached_tokens = len(matched) * bs + cow_q
        take = int(min(target - cached_tokens, take_cap))
        if take < 1:
            return None
        if self.window:
            # lazy allocation: cover only the first piece; continuations
            # grow (and window-release) the table chunk by chunk, so a
            # long prompt never pins O(prompt) blocks
            cover = cached_tokens + take
        else:
            cover = min(target + 1, self.max_seq)
        fresh = self._blocks_needed(cover) - len(matched)
        if bm.num_allocatable - parked < fresh:
            if self.window and bm.num_allocatable - parked > 0:
                fresh = bm.num_allocatable - parked
                take = min(take,
                           (len(matched) + fresh) * bs - cached_tokens)
                if take < 1:
                    return None
            else:
                return None

        self.waiting.popleft()
        table = BlockTable(req.req_id)
        for d in matched:
            table.append_block(bm.acquire_cached(d, log), log)
        for _ in range(fresh):
            table.append_block(bm.allocate(log), log)
        self.block_tables[req.req_id] = table
        req.state = RequestState.RUNNING
        req.batch_slot = self._free_slots.pop()
        req.prefill_pos = cached_tokens
        self.running.append(req)
        if cow_src is not None:
            plan.cow_copies.append(
                (cow_src, table.blocks[len(matched)], cow_q))
        self._digest_cache.pop(req.req_id, None)
        info = _SeqInfo(tokens=toks, target=target, digests=digests,
                        next_register=len(matched),
                        cached_tokens=cached_tokens)
        self._seq[req.req_id] = info
        self._plan_piece(plan, req, info, take, log)
        return take

    def _admit_whole(self, req: Request, log: BlockLog) -> bool:
        """Legacy whole-prompt admission (models with recurrent prefill
        state; also the one-prefill-per-step baseline)."""
        bm = self.block_manager
        toks = tuple(req.tokens_so_far)
        need = self._blocks_needed(min(len(toks) + 1, self.max_seq))
        if bm.num_allocatable < need:
            return False
        self.waiting.popleft()
        table = BlockTable(req.req_id)
        for _ in range(need):
            table.append_block(bm.allocate(log), log)
        self.block_tables[req.req_id] = table
        req.state = RequestState.RUNNING
        req.batch_slot = self._free_slots.pop()
        req.prefill_pos = 0
        self.running.append(req)
        self._seq[req.req_id] = _SeqInfo(tokens=toks, target=len(toks))
        return True

    # -- sliding-window block release ---------------------------------------------

    def _release_out_of_window(self, req: Request, seq_len: int,
                               log: Optional[BlockLog]) -> None:
        """Free blocks entirely below the attention window's lower bound
        (ROADMAP paged-KV follow-up (b)): the smallest attention this
        step runs covers ``[seq_len - window, seq_len)``, so everything
        strictly below that bound is never attended again.  The table
        entry keeps its index but points at the trash row; pool
        occupancy stays O(window) per sequence."""
        if not self.window:
            return
        info = self._seq.get(req.req_id)
        if info is None:
            return
        start = max(seq_len - self.window, 0)
        bs = self.block_manager.block_size
        table = self.block_tables[req.req_id]
        # self-heal after a §3.3 rollback: undone releases restored real
        # block ids below the watermark — walk it back so they free again
        while (info.released_upto > 0
               and table.blocks[info.released_upto - 1]
               < self.block_manager.num_blocks):
            info.released_upto -= 1
        while (info.released_upto + 1) * bs <= start:
            idx = info.released_upto
            bid = table.blocks[idx]
            if bid < self.block_manager.num_blocks:
                table.set_block(idx, self._trash, log)
                self.block_manager.free(bid, log)
                self.stats["blocks_window_freed"] += 1
            info.released_upto += 1

    # -- stats (advisory; committed-step granularity) --------------------------------

    def note_chunk_done(self, piece: ChunkPiece,
                        log: Optional[BlockLog] = None) -> None:
        """Compute-phase bookkeeping for one executed chunk piece: stats,
        plus hash-publishing the prompt blocks the piece completed (their
        rows are in the pool now)."""
        self.stats["prefill_tokens_computed"] += piece.length
        self.stats["prefill_chunks"] += 1
        info = self._seq.get(piece.req.req_id)
        if info is None:
            return
        if not info.counted:
            self.stats["prefill_tokens_cached"] += info.cached_tokens
            info.counted = True
        if self.prefix_cache and info.digests:
            self._register_upto(piece.req, info,
                                piece.start + piece.length, log)

    def note_prefill_done(self, n_tokens: int) -> None:
        self.stats["prefill_tokens_computed"] += n_tokens

    def note_decode_progress(self, req: Request,
                             log: Optional[BlockLog] = None) -> None:
        """Carry-over (f): publish *decode-grown* blocks in the prefix
        cache.  Called after decode/speculation tokens commit: KV rows
        exist for positions [0, num_tokens - 1) (the newest token's row
        is written by its next forward), so every full block below that
        bound is registrable — a multi-turn follow-up whose prompt
        embeds this conversation then hits the cache past the original
        prompt, not just up to it."""
        if not self.prefix_cache:
            return
        info = self._seq.get(req.req_id)
        if info is None:
            return
        bs = self.block_manager.block_size
        # overlap pipeline: only *committed* tokens are registrable —
        # the speculative tail holds plan-ahead guesses whose values
        # (and KV rows) are still in flight
        committed = req.num_tokens - req.speculative_tokens
        kv_complete = committed - 1
        full = kv_complete // bs
        if len(info.digests) < full:
            toks = tuple((req.prompt_tokens + req.committed_output)
                         if req.speculative_tokens else req.tokens_so_far)
            info.tokens = toks   # registration reads block token slices
            while len(info.digests) < full:
                b = len(info.digests)
                parent = info.digests[b - 1] if b else ROOT_DIGEST
                info.digests.append(
                    block_digest(parent, toks[b * bs:(b + 1) * bs]))
        self._register_upto(req, info, kv_complete, log)

    def note_spec_done(self, piece: ChunkPiece, emitted: int,
                       accepted: int) -> None:
        """Compute-phase bookkeeping for one verified speculation
        window: ``emitted`` tokens committed (>= 1), ``accepted`` of the
        window's drafts matched the verifier."""
        self.stats["spec_accepted"] += accepted
        self.stats["spec_emitted"] += emitted

    # -- completion -------------------------------------------------------------------

    def finish(self, req: Request, log: Optional[BlockLog]) -> None:
        req.state = RequestState.FINISHED
        self._release(req, log)
        self.running.remove(req)

    def _release(self, req: Request, log: Optional[BlockLog]) -> None:
        table = self.block_tables.pop(req.req_id, None)
        if table is not None:
            for bid in reversed(table.blocks):
                if bid < self.block_manager.num_blocks:  # skip released
                    self.block_manager.free(bid, log)
        self._seq.pop(req.req_id, None)
        self._digest_cache.pop(req.req_id, None)
        if req.batch_slot is not None:
            self._free_slots.append(req.batch_slot)
            req.batch_slot = None
