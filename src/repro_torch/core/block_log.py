"""Log-based block-table recovery (§3.3) + content-hash prefix cache.

During a generation step every block operation (allocate / append /
ref / free / cache-acquire / register / table-set) is appended to a
per-step undo log, ARIES-style.  On a mid-step failure the log is rolled
back in reverse, returning the block manager + block tables to the exact
state at the step boundary.  At the start of each step the previous log
is discarded (the step committed).

The log records *inverse information* (prev ref counts, table positions,
hash mappings) so undo is exact even for idempotence-breaking sequences.

Device-pool consistency has two strategies (the executor picks one):

* **row-level undo** (default): at plan time the step's complete write
  set is known (decode write destinations, prefill chunk rows, COW
  copies), so the executor captures just those pool rows and rollback
  scatters them back — O(write set), not O(pool), and the step updates
  the pools in place.
* **snapshot** (legacy): a copy of the whole cache at the step boundary.
  Exact, but O(pool) memory and time per step.

Prefix cache
============
``BlockManager`` doubles as a vLLM-style content-hash block cache: a
*full* block whose tokens (and whole prefix before it) are known is
registered under a chain digest ``H(parent_digest || tokens)``.  A later
request whose prompt starts with the same token blocks acquires the
physical blocks by digest (ref-count shared, zero prefill work); when
the last owner frees a registered block it parks on a cached-free LRU —
still addressable by digest, evicted only when the allocator runs dry.
Partial-prefix reuse is copy-on-write at the divergence block: the
scheduler finds a cached child block sharing the first ``q`` tokens and
plans a device copy of those rows into the request's private block.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

ROOT_DIGEST = b""


def block_digest(parent: bytes, tokens: Sequence[int]) -> bytes:
    """Chain digest of one full block: H(parent || token ids)."""
    h = hashlib.sha256(parent)
    h.update(b"|")
    h.update(b",".join(str(int(t)).encode() for t in tokens))
    return h.digest()


def prompt_digests(tokens: Sequence[int], block_size: int) -> List[bytes]:
    """Chain digests of every *full* block of a token sequence."""
    out: List[bytes] = []
    parent = ROOT_DIGEST
    for i in range(len(tokens) // block_size):
        parent = block_digest(parent,
                              tokens[i * block_size:(i + 1) * block_size])
        out.append(parent)
    return out


@dataclass(frozen=True)
class BlockOp:
    kind: str     # 'alloc' | 'free' | 'append' | 'ref' | 'unref'
    #               | 'cache_acquire' | 'hash_set' | 'table_set'
    block_id: int
    seq_id: Optional[int] = None
    prev_ref: int = 0         # ref count before the op (for free/ref/...)
    meta: Any = None          # op-specific inverse info (digest, index...)


class _Frame:
    """One uncommitted step's undo payload: block ops + pool rollback."""
    __slots__ = ("ops", "pool_undo", "pool_snapshot")

    def __init__(self):
        self.ops: List[BlockOp] = []
        self.pool_undo = None
        self.pool_snapshot = None


def _undo_op(op: BlockOp, manager: "BlockManager",
             tables: Dict[int, "BlockTable"]) -> None:
    if op.kind == "alloc":
        # undoing an allocation decrements the ref count / deletes
        manager._undo_alloc(op.block_id)
    elif op.kind == "free":
        manager._undo_free(op.block_id, op.prev_ref)
    elif op.kind == "append":
        tables[op.seq_id]._undo_append(op.block_id)
    elif op.kind == "ref":
        manager._set_ref(op.block_id, op.prev_ref)
    elif op.kind == "unref":
        manager._set_ref(op.block_id, op.prev_ref)
    elif op.kind == "cache_acquire":
        manager._undo_cache_acquire(op.block_id, op.prev_ref)
    elif op.kind == "hash_set":
        manager._undo_register(op.block_id)
    elif op.kind == "table_set":
        idx, prev_bid = op.meta
        tables[op.seq_id].blocks[idx] = prev_bid
    else:  # pragma: no cover
        raise ValueError(op.kind)


class _OldestRecorder:
    """Record-only view of a log's *oldest* frame.

    The overlap pipeline drains step N-1 after step N has already been
    planned (its frame pushed on top): bookkeeping ops that belong to
    the draining step — decode-grown prefix registrations, finish
    frees — must land in N-1's frame, not N's, so a later rollback of
    N never undoes N-1's committed outcome."""

    def __init__(self, log: "BlockLog"):
        self._log = log

    def record(self, op: BlockOp) -> None:
        self._log._frames[0].ops.append(op)


class BlockLog:
    """Per-executor undo log of uncommitted step *frames*.

    The lockstep engine keeps exactly one frame (cleared at each step
    boundary — the historical behaviour).  The overlap pipeline keeps up
    to two: the in-flight step plus the plan-ahead step stacked on top.
    Frames commit oldest-first and roll back newest-first, so the §3.3
    undo stays exact whichever way the pipeline resolves."""

    def __init__(self):
        self._frames: List[_Frame] = [_Frame()]
        self.steps_committed = 0

    def begin_step(self) -> None:
        """Previous step fully completed -> its log is no longer needed."""
        self._frames = [_Frame()]
        self.steps_committed += 1

    def record(self, op: BlockOp) -> None:
        self._frames[-1].ops.append(op)

    # -- multi-frame surface (overlap pipeline) -------------------------------

    @property
    def num_frames(self) -> int:
        return len(self._frames)

    def push_frame(self) -> None:
        """Open a new uncommitted frame on top (plan-ahead step)."""
        self._frames.append(_Frame())

    def commit_oldest(self) -> None:
        """The oldest uncommitted frame's step reached its boundary."""
        self._frames.pop(0)
        if not self._frames:
            self._frames.append(_Frame())
        self.steps_committed += 1

    def oldest(self):
        """A record-only view targeting the oldest frame (drain-phase
        bookkeeping of the step about to commit)."""
        return self if len(self._frames) == 1 else _OldestRecorder(self)

    def undo_newest(self, manager: "BlockManager",
                    tables: Dict[int, "BlockTable"]) -> int:
        """Roll back and drop the newest frame's ops (reverse order).
        Callers restore its pool rows first via ``take_pool_undo``."""
        frame = self._frames.pop()
        if not self._frames:
            self._frames.append(_Frame())
        for op in reversed(frame.ops):
            _undo_op(op, manager, tables)
        return len(frame.ops)

    # -- pool consistency (the device-side half of §3.3) ----------------------

    def snapshot_pools(self, cache) -> None:
        """Legacy strategy: remember a copy of the paged cache taken at
        the step boundary (the caller clones it: the step updates the
        pools in place).  Restoring it discards every in-flight pool
        write exactly; row-level undo (below) is the O(write set)
        replacement."""
        self._frames[-1].pool_snapshot = cache

    def take_pool_snapshot(self):
        """The cache value to restore on rollback (None once committed)."""
        frame = self._frames[-1]
        snap = frame.pool_snapshot
        frame.pool_snapshot = None
        return snap

    def record_pool_undo(self, undo) -> None:
        """Row-level strategy: stash the captured write-set rows
        (``cache_ops.capture_pool_rows``) for the in-flight step."""
        self._frames[-1].pool_undo = undo

    def take_pool_undo(self):
        frame = self._frames[-1]
        undo = frame.pool_undo
        frame.pool_undo = None
        return undo

    def peek_pool_undo(self):
        """Non-destructive read of the newest frame's captured write
        set — the speculative-decode verify phase restores the *rejected*
        rows from it mid-compute while the full payload stays armed."""
        return self._frames[-1].pool_undo

    def has_pool_state(self) -> bool:
        return any(f.pool_undo is not None or f.pool_snapshot is not None
                   for f in self._frames)

    def __len__(self) -> int:
        return sum(len(f.ops) for f in self._frames)

    def undo_all(self, manager: "BlockManager",
                 tables: Dict[int, "BlockTable"]) -> int:
        """Roll back every op of every uncommitted frame, newest frame
        first, each frame in reverse order.  Returns the ops undone."""
        n = 0
        for frame in reversed(self._frames):
            for op in reversed(frame.ops):
                _undo_op(op, manager, tables)
            n += len(frame.ops)
        self._frames = [_Frame()]
        return n


class BlockTable:
    """Per-sequence ordered list of physical block ids (host metadata).

    Entries may be *released* in place (sliding-window configs free
    blocks the attention window has moved past): the slot keeps its
    index — position ``p`` still maps to ``blocks[p // bs]`` — but
    points at the pool's trash block, whose rows every reader masks."""

    def __init__(self, seq_id: int):
        self.seq_id = seq_id
        self.blocks: List[int] = []

    def append_block(self, block_id: int, log: Optional[BlockLog] = None):
        self.blocks.append(block_id)
        if log is not None:
            log.record(BlockOp("append", block_id, self.seq_id))

    def _undo_append(self, block_id: int):
        assert self.blocks and self.blocks[-1] == block_id, \
            f"undo mismatch: table tail {self.blocks[-1:]} vs {block_id}"
        self.blocks.pop()

    def set_block(self, index: int, block_id: int,
                  log: Optional[BlockLog] = None) -> None:
        """Replace entry ``index`` (window release / undo thereof)."""
        prev = self.blocks[index]
        self.blocks[index] = block_id
        if log is not None:
            log.record(BlockOp("table_set", block_id, self.seq_id,
                               meta=(index, prev)))

    def num_blocks(self) -> int:
        return len(self.blocks)


class BlockManager:
    """Free-list block allocator with ref counts + content-hash reuse."""

    def __init__(self, num_blocks: int, block_size: int):
        self.num_blocks = num_blocks
        self.block_size = block_size
        self._free: List[int] = list(range(num_blocks - 1, -1, -1))
        self._ref: Dict[int, int] = {}
        # content-hash prefix cache
        self._hash: Dict[bytes, int] = {}        # digest -> bid
        self._bid_hash: Dict[int, bytes] = {}
        self._bid_tokens: Dict[int, Tuple[int, ...]] = {}
        self._bid_parent: Dict[int, bytes] = {}
        self._children: Dict[bytes, set] = {}    # parent digest -> {bid}
        # ref==0 blocks whose content is still cache-addressable (LRU)
        self._cached_free: "OrderedDict[int, None]" = OrderedDict()
        self.cache_hits = 0
        self.cache_evictions = 0

    # -- public ops (logged) -------------------------------------------------

    def allocate(self, log: Optional[BlockLog] = None) -> int:
        if self._free:
            bid = self._free.pop()
        elif self._cached_free:
            # evict the least-recently-parked cached block; its content
            # is overwritten by the new owner (the row-level undo
            # captures those rows, so rollback stays exact) — only the
            # digest mapping is lost, which costs future hits, never
            # correctness
            bid, _ = self._cached_free.popitem(last=False)
            self._drop_hash(bid)
            self.cache_evictions += 1
        else:
            raise RuntimeError("out of KV blocks")
        self._ref[bid] = 1
        if log is not None:
            log.record(BlockOp("alloc", bid))
        return bid

    def free(self, block_id: int, log: Optional[BlockLog] = None) -> None:
        prev = self._ref.get(block_id, 0)
        assert prev > 0, f"double free of block {block_id}"
        if log is not None:
            log.record(BlockOp("free", block_id, prev_ref=prev))
        if prev == 1:
            del self._ref[block_id]
            if block_id in self._bid_hash:
                self._cached_free[block_id] = None    # park, keep content
            else:
                self._free.append(block_id)
        else:
            self._ref[block_id] = prev - 1

    def add_ref(self, block_id: int, log: Optional[BlockLog] = None) -> None:
        prev = self._ref.get(block_id, 0)
        assert prev > 0
        if log is not None:
            log.record(BlockOp("ref", block_id, prev_ref=prev))
        self._ref[block_id] = prev + 1

    # -- prefix cache ---------------------------------------------------------

    def lookup(self, digest: bytes) -> Optional[int]:
        """The block holding this digest's content (None on miss).  Read
        only — the block may be live (ref > 0) or parked cached-free."""
        return self._hash.get(digest)

    def acquire_cached(self, digest: bytes,
                       log: Optional[BlockLog] = None) -> Optional[int]:
        """Take a ref-counted share of the cached block for ``digest``.

        A parked (ref==0) block is revived off the cached-free list; a
        live one just gains a reference.  Returns None on miss."""
        bid = self._hash.get(digest)
        if bid is None:
            return None
        prev = self._ref.get(bid, 0)
        if prev == 0:
            del self._cached_free[bid]
        self._ref[bid] = prev + 1
        self.cache_hits += 1
        if log is not None:
            log.record(BlockOp("cache_acquire", bid, prev_ref=prev,
                               meta=digest))
        return bid

    def register(self, bid: int, digest: bytes, parent: bytes,
                 tokens: Sequence[int],
                 log: Optional[BlockLog] = None) -> None:
        """Publish a freshly written *full* block under its chain digest
        (first writer wins; re-registration of a live digest is a no-op)."""
        if digest in self._hash or bid in self._bid_hash:
            return
        assert self._ref.get(bid, 0) > 0, \
            f"registering unallocated block {bid}"
        self._hash[digest] = bid
        self._bid_hash[bid] = digest
        self._bid_tokens[bid] = tuple(int(t) for t in tokens)
        self._bid_parent[bid] = parent
        self._children.setdefault(parent, set()).add(bid)
        if log is not None:
            log.record(BlockOp("hash_set", bid, meta=digest))

    def drop_cached(self) -> None:
        """Forget the content of every parked (ref==0) cached block and
        put it back on the free list: a later prompt hits only blocks
        that live requests hold (none, once the engine has drained, as
        in a fresh manager)."""
        for bid in self._cached_free:
            self._drop_hash(bid)
            self._free.append(bid)
        self._cached_free.clear()

    def children_of(self, parent: bytes
                    ) -> Iterable[Tuple[int, Tuple[int, ...]]]:
        """(bid, tokens) of cached blocks whose prefix chain ends at
        ``parent`` — the COW divergence candidates."""
        for bid in self._children.get(parent, ()):
            yield bid, self._bid_tokens[bid]

    def _drop_hash(self, bid: int) -> None:
        digest = self._bid_hash.pop(bid, None)
        if digest is None:
            return
        if self._hash.get(digest) == bid:
            del self._hash[digest]
        parent = self._bid_parent.pop(bid)
        kids = self._children.get(parent)
        if kids is not None:
            kids.discard(bid)
            if not kids:
                del self._children[parent]
        self._bid_tokens.pop(bid, None)

    # -- undo internals (called by BlockLog only) ------------------------------

    def _undo_alloc(self, block_id: int) -> None:
        ref = self._ref.get(block_id, 0)
        assert ref >= 1, f"undo alloc of unallocated block {block_id}"
        if ref == 1:
            del self._ref[block_id]
            # an eviction that fed this alloc is not replayed: the digest
            # mapping is already gone (perf loss only, content restored
            # by the row-level pool undo)
            self._free.append(block_id)
        else:
            self._ref[block_id] = ref - 1

    def _undo_free(self, block_id: int, prev_ref: int) -> None:
        if block_id in self._ref:
            self._ref[block_id] = prev_ref
        else:
            if block_id in self._cached_free:
                del self._cached_free[block_id]
            else:
                self._free.remove(block_id)
            self._ref[block_id] = prev_ref

    def _undo_cache_acquire(self, block_id: int, prev_ref: int) -> None:
        if prev_ref == 0:
            del self._ref[block_id]
            self._cached_free[block_id] = None
        else:
            self._ref[block_id] = prev_ref

    def _undo_register(self, block_id: int) -> None:
        self._drop_hash(block_id)

    def _set_ref(self, block_id: int, ref: int) -> None:
        self._ref[block_id] = ref

    # -- introspection ---------------------------------------------------------

    def ref_count(self, block_id: int) -> int:
        return self._ref.get(block_id, 0)

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_allocatable(self) -> int:
        """Blocks an allocation can claim: plain free + evictable cached."""
        return len(self._free) + len(self._cached_free)

    @property
    def num_allocated(self) -> int:
        return len(self._ref)

    @property
    def num_cached(self) -> int:
        """Registered (content-addressable) blocks, live or parked."""
        return len(self._bid_hash)

    def snapshot(self):
        """Hashable state snapshot (for property tests)."""
        return (tuple(sorted(self._free)),
                tuple(sorted(self._ref.items())),
                tuple(sorted(self._cached_free)),
                tuple(sorted((d, b) for d, b in self._hash.items())))
