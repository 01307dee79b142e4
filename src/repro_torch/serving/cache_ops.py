"""Structural operations on the paged serving cache (lockstep path).

The cache is a nested dict whose attention leaves are block pools with
*no* batch axis (requests own physical blocks through block tables);
per-slot recurrent state, where a model has it, carries a batch axis.
:func:`infer_paged_axes` tells the two apart once, structurally: a leaf
whose shape changes with the batch size is per-slot state (its batch
axis is recorded), one that does not is a pool (axis ``None``).

Where ``repro.serving.cache_ops`` returns updated arrays (JAX donates the
pool buffers), these helpers update the pools **in place** and return the
same cache.  So the §3.3 row capture clones the rows it gathers: capture,
then step, then restore is bit-exact.

KV-block streaming (§3.2, §3.4's role switch) gathers one request's
blocks and slot state with :func:`gather_request_blocks` and installs
them on the target with :func:`scatter_request_blocks`.  The payload
stays on the cache's device: the simulated ranks share one card.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch


def cache_leaves(cache) -> List[torch.Tensor]:
    """Leaves of a nested cache dict in sorted-key order."""
    out: List[torch.Tensor] = []
    for k in sorted(cache):
        v = cache[k]
        out.extend(cache_leaves(v) if isinstance(v, dict) else [v])
    return out


def infer_paged_axes(model, num_blocks: int,
                     block_size: int) -> List[Optional[int]]:
    """Per-leaf batch axis of the paged cache (``cache_leaves`` order);
    ``None`` marks pool leaves.  Shapes come from meta tensors: nothing
    is allocated."""
    s1 = cache_leaves(model.init_paged_cache(1, num_blocks, block_size,
                                             device="meta"))
    s2 = cache_leaves(model.init_paged_cache(2, num_blocks, block_size,
                                             device="meta"))
    axes: List[Optional[int]] = []
    for a, b in zip(s1, s2):
        diffs = [i for i, (x, y) in enumerate(zip(a.shape, b.shape))
                 if x != y]
        assert len(diffs) <= 1, (a.shape, b.shape)
        axes.append(diffs[0] if diffs else None)
    return axes


def clone_cache(cache):
    """A deep copy (the legacy whole-cache snapshot of §3.3)."""
    return {k: clone_cache(v) if isinstance(v, dict) else v.clone()
            for k, v in cache.items()}


def _index(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.int64), device=device)


def copy_block_prefixes(cache, axes_leaves: List[Optional[int]], copies):
    """Copy the first ``n`` rows of source pool blocks into destination
    blocks, in place — the device half of prefix-cache copy-on-write.
    ``copies``: [(src_bid, dst_bid, n_tokens)]; all copies of a step go
    in one gather/scatter per pool leaf.  Per-slot state is untouched."""
    if not copies:
        return cache
    src = np.concatenate([np.full((n,), s) for s, _, n in copies])
    dst = np.concatenate([np.full((n,), d) for _, d, n in copies])
    off = np.concatenate([np.arange(n) for _, _, n in copies])
    for c, ax in zip(cache_leaves(cache), axes_leaves):
        if ax is None:
            s, d, o = (_index(a, c.device) for a in (src, dst, off))
            c[:, d, o] = c[:, s, o]
    return cache


def install_prefill(cache, raw, axes_leaves: List[Optional[int]],
                    block_ids, slot: int):
    """Write one prefilled request into the paged cache, in place.

    ``raw`` is ``Model.prefill_paged``'s output for a batch of 1: pool
    leaves carry (L, 1, S, *rest) raw K/V rows, written block-wise at
    ``block_ids`` (nblk,) — ids past the request's table point at the
    trash block; per-slot state leaves carry (L, 1, ...) state for batch
    slot ``slot``.  Where ``block_ids`` repeat (the trash block), only the
    last of the repeats is written, so the scatter has no duplicate
    index and the trash rows are the same on every device and every run
    (a CUDA scatter with duplicates keeps an arbitrary one)."""
    ids = np.asarray(block_ids, np.int64)
    nblk = ids.shape[0]
    last = {int(b): j for j, b in enumerate(ids)}     # the last repeat wins
    keep = np.asarray(sorted(last.values()), np.int64)
    for c, r, ax in zip(cache_leaves(cache), cache_leaves(raw), axes_leaves):
        if ax is None:
            L, bs = c.shape[0], c.shape[2]
            S = r.shape[2]
            assert nblk * bs >= S, (nblk, bs, S)
            rb = torch.zeros((L, nblk * bs) + tuple(r.shape[3:]),
                             dtype=c.dtype, device=c.device)
            rb[:, :S] = r[:, 0]
            rb = rb.view((L, nblk, bs) + tuple(r.shape[3:]))
            k = _index(keep, c.device)
            c[:, _index(ids[keep], c.device)] = rb[:, k]
        else:
            c.narrow(ax, slot, 1).copy_(r)
    return cache


def capture_pool_rows(cache, axes_leaves: List[Optional[int]], bids,
                      offs) -> Dict[str, Any]:
    """Gather (a copy of) the step's pool write set before the step
    overwrites it in place.  ``bids``/``offs`` (NR,) address every
    (block, offset) row the planned step writes; per-slot state leaves
    are cloned whole.  Returns the undo payload of
    :func:`restore_pool_rows`."""
    rows: List[Any] = []
    state: List[Any] = []
    idx = None
    for c, ax in zip(cache_leaves(cache), axes_leaves):
        if ax is None:
            if idx is None:
                idx = (_index(bids, c.device), _index(offs, c.device))
            rows.append(c[:, idx[0], idx[1]])    # advanced index: a copy
            state.append(None)
        else:
            rows.append(None)
            state.append(c.clone())
    return {"idx": idx, "rows": rows, "state": state}


def restore_pool_rows(cache, axes_leaves: List[Optional[int]], undo):
    """Inverse of :func:`capture_pool_rows`, in place: scatter the
    captured rows back and restore the state leaves — the §3.3
    device-side rollback, touching only the step's write set."""
    for c, ax, row, st in zip(cache_leaves(cache), axes_leaves,
                              undo["rows"], undo["state"]):
        if ax is None:
            c[:, undo["idx"][0], undo["idx"][1]] = row
        else:
            c.copy_(st)
    return cache


def gather_request_blocks(cache, axes_leaves: List[Optional[int]],
                          block_ids, slot: int):
    """Extract (a copy of) one request's device state for KV-block
    streaming.  Returns ``(pool_blocks, state)`` as flat leaf lists in
    ``cache_leaves`` order: pool leaves gathered block-wise to
    (L, nblk, bs, *rest), state leaves sliced at ``slot`` to
    (L, 1, ...); the other kind is ``None`` in each list.  Both stay on
    the cache's device."""
    pool_blocks: List[Any] = []
    state: List[Any] = []
    for c, ax in zip(cache_leaves(cache), axes_leaves):
        if ax is None:
            pool_blocks.append(c.index_select(1, _index(block_ids,
                                                        c.device)))
            state.append(None)
        else:
            pool_blocks.append(None)
            state.append(c.narrow(ax, slot, 1).clone())
    return pool_blocks, state


def scatter_request_blocks(cache, axes_leaves: List[Optional[int]],
                           pool_blocks, state, block_ids, slot: int):
    """Inverse of :func:`gather_request_blocks` on the *target* cache, in
    place: the pool blocks land at freshly allocated ``block_ids``, the
    recurrent state at batch slot ``slot``.  The payload must already lie
    on the cache's device: it is never moved here."""
    for c, ax, pb, st in zip(cache_leaves(cache), axes_leaves, pool_blocks,
                             state):
        src = pb if ax is None else st
        if src.device != c.device:
            raise ValueError(f"KV payload on {src.device}, cache on "
                             f"{c.device}")
        if ax is None:
            c.index_copy_(1, _index(block_ids, c.device), src.to(c.dtype))
        else:
            c.narrow(ax, slot, 1).copy_(src)
    return cache
