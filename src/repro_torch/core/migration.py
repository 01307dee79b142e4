"""Sequence state recovery (§3.2): migration, KV-block streaming, and
partial recomputation.

Two ways to move a live sequence to another executor or instance:

* **KV-block streaming** (FailSafe-style standby sync): while the source
  device is still reachable, the request's *live pool blocks* plus its
  per-slot recurrent state are extracted (:class:`KVBlocks`) and
  installed into freshly allocated blocks on the target.  Cost is
  O(prefix bytes) of copy — no recompute — so takeover latency stays
  flat in prompt length.
* **Token replay re-prefill** (the verified fallback): the KV cache of a
  *failed* device is gone, but every sequence's prompt and decoded token
  ids still live in host memory.  Migration requeues each sequence on a
  healthy rank; its next prefill consumes ``prompt + decoded``, so
  completed decode steps are never redone — only the KV prefill is
  recomputed.

Both paths are token-exact: sampling is position-seeded, so the target
continues the same token stream either way (parity is asserted in
tests/test_paged_serving.py).

Recovery is step-level: the in-flight generation step on *every* executor
is rolled back (block log §3.3) and its sampled tokens discarded, because
layer-level checkpoints could leave inconsistent KV across layers.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional, Sequence

from repro_torch.serving.request import Request


@dataclass
class KVBlocks:
    """One request's device state, extracted for KV-block streaming.

    ``pool_blocks``/``state`` are flat leaf lists aligned with the paged
    cache's flatten order (``cache_ops.gather_request_blocks``): pool
    leaves carry (L, nblk, bs, *rest) gathered blocks, state leaves the
    (L, 1, ...) per-slot recurrent state; the other kind is ``None``.
    """
    block_size: int
    num_blocks: int              # nblk — table span of the valid prefix
    valid_len: int               # cache positions 0..valid_len-1 are live
    pool_blocks: List[Any]
    state: List[Any]
    last_token: int              # feeds the target's next decode step
    # per table index: False marks a window-released (dead) block — no
    # payload rows ship for it and the target installs its trash
    # sentinel instead of allocating a real block.  None = all live.
    live_mask: Optional[List[bool]] = None

    @property
    def tokens_streamed(self) -> int:
        return self.valid_len

    def nbytes(self) -> int:
        return sum(int(x.nbytes) for x in self.pool_blocks + self.state
                   if x is not None)


def plan_migration(reqs: Sequence[Request], target_loads: dict
                   ) -> List[tuple]:
    """Assign each request to the least-loaded healthy executor.

    target_loads: {dp_rank: current_num_requests} for healthy ranks.
    Returns [(req, dp_rank)] and updates loads greedily.
    """
    assert target_loads, "no healthy attention ranks to migrate to"
    loads = dict(target_loads)
    out = []
    # longest sequences first: balances the re-prefill work
    for req in sorted(reqs, key=lambda r: -r.num_tokens):
        rank = min(loads, key=lambda k: loads[k])
        loads[rank] += 1
        out.append((req, rank))
    return out


def prepare_for_migration(req: Request, streamed: bool = False) -> Request:
    """Migration accounting; the request keeps its identity.

    ``streamed=True`` marks a KV-block-streamed move: no prefill is
    recomputed, so ``recomputed_tokens`` stays put (if the stream install
    later fails, the fallback requeue charges it via
    :func:`charge_replay`)."""
    req.rebuild_prompt_for_migration()
    if not streamed:
        charge_replay(req)
    return req


def charge_replay(req: Request) -> Request:
    """Partial-recomputation accounting: the whole live prefix is about
    to be re-prefilled on the target."""
    req.recomputed_tokens += req.num_tokens
    return req
