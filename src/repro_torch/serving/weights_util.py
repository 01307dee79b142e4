"""Expert-weight sharding for the simulated multi-executor runtime.

Each EP rank's slice of the routed-expert bank is kept on the host
(``split_experts``), physically separate, so a rank failure genuinely
destroys its copy.  A role switch (§3.4) reloads the lost rank's slice
from disk (``load_expert_shard_from_checkpoint``): from its per-rank
shard file when one exists, else straight out of ``weights.npz``, each
slot that ``rebalance_experts`` re-pointed read from the column of the
logical it now serves.
Start-up writes no shard file (``save_shard_checkpoints`` stays for
``rejoin_device``).

``repro.serving.weights_util`` keeps a zero-filled base copy of every
expert leaf and rebuilds the whole bank on the host on every revive.  At
full width that is ~28 GB of zeros and a ~28 GB host-to-device copy, so
the port keeps **one** device bank: ``assemble`` zeroes a dead rank's
slice in place and copies a rank's slice in from its owner's shard when
the owner changed (a reloaded shard is copied, never the start-up one) —
the same "dead slices = 0" function — and ``expert_checksums`` sums each
live rank's slice on the card, so the recovery's timed phase measures
revive, not a host scan.
"""
from __future__ import annotations

import os
from typing import Dict, Iterator, List, Optional, Tuple

import torch

from repro_torch.training.checkpoint import (flatten, load_axis1_slices,
                                             save_flat)

EXPERT_LEAF_NAMES = ("gate", "up", "down")
EXPERT_AXIS = 1  # stacked layer params: (L, E_phys, ...)


def expert_leaves(params) -> Iterator[Tuple[str, torch.Tensor]]:
    """(key, leaf) of every routed-expert leaf of the parameter dict."""
    for key, leaf in flatten(params):
        parts = key.split("/")
        if "moe" in parts and parts[-1] in EXPERT_LEAF_NAMES:
            yield key, leaf


def _rank_slice(leaf: torch.Tensor, rank: int, ep_size: int):
    E = leaf.shape[EXPERT_AXIS]
    assert E % ep_size == 0, (E, ep_size)
    per = E // ep_size
    return leaf[:, rank * per:(rank + 1) * per]


def split_experts(params, ep_size: int) -> List[Dict[str, torch.Tensor]]:
    """Host copies of each EP rank's physical slots: ``shards[r]`` maps
    the leaf key to rank r's ``(L, E_phys / ep_size, ...)`` slice.  The
    device bank in ``params`` stays as it is."""
    shards: List[Dict[str, torch.Tensor]] = [dict() for _ in range(ep_size)]
    for key, leaf in expert_leaves(params):
        for r in range(ep_size):
            # a copy on the CPU too, never a view of the bank
            shards[r][key] = _rank_slice(leaf, r, ep_size).to(
                "cpu", copy=True)
    return shards


def assemble(params, shards: List[Optional[Dict[str, torch.Tensor]]],
             resident: List[Optional[Dict[str, torch.Tensor]]]
             ) -> List[Optional[Dict[str, torch.Tensor]]]:
    """Bring the device bank in line with the ranks' owners, in place.
    ``shards[r]`` is the shard of rank r's live owner (None: no live
    owner) and ``resident[r]`` the shard whose weights rank r's slice
    holds now (None: zeroed).  A slice whose owner lost it is zeroed; a
    slice whose owner's shard is another than the resident one is copied
    in from that shard.  Returns the new ``resident``."""
    ep_size = len(shards)
    for key, leaf in expert_leaves(params):
        for r in range(ep_size):
            if shards[r] is resident[r]:
                continue
            if shards[r] is None:
                _rank_slice(leaf, r, ep_size).zero_()
            else:
                _rank_slice(leaf, r, ep_size).copy_(shards[r][key])
    return list(shards)


def expert_checksums(params, alive: List[bool]) -> List[float]:
    """Per-rank weight checksums (sum of |w| over the rank's expert
    slices), computed on the bank's device; NaN for a dead rank."""
    ep_size = len(alive)
    sums: List = [0.0] * ep_size
    for _, leaf in expert_leaves(params):
        for r in range(ep_size):
            if alive[r]:
                # layer by layer: the |w| temporary stays one layer's slice
                for sl in _rank_slice(leaf, r, ep_size):
                    sums[r] = sums[r] + sl.abs().sum(dtype=torch.float64)
    return [float(s) if a else float("nan") for s, a in zip(sums, alive)]


def shard_ckpt_path(workdir: str, ep_rank: int) -> str:
    return os.path.join(workdir, f"expert_shard_{ep_rank}.npz")


def save_shard_checkpoints(workdir: str,
                           shards: List[Dict[str, torch.Tensor]]) -> None:
    """Per-EP-rank shard files, so a role switch reads exactly one rank's
    slice (§3.4), not the whole model.  Keys use ``|`` for ``/``."""
    for r, sh in enumerate(shards):
        path = shard_ckpt_path(workdir, r)
        if not os.path.exists(path):
            save_flat(path, ((k.replace("/", "|"), v)
                             for k, v in sorted(sh.items())))


def load_expert_shard_from_checkpoint(ckpt_path: str, template_shard: Dict,
                                      ep_rank: int, *,
                                      moved: Optional[Dict[int, int]] = None,
                                      workdir: Optional[str] = None
                                      ) -> Dict[str, torch.Tensor]:
    """Role-switch weight load (§3.4): read EP rank ``ep_rank``'s expert
    slices from disk — the per-rank shard file when one exists, else the
    rank's slice of every routed-expert leaf of the full checkpoint, one
    layer's contiguous run at a time.  ``template_shard`` (any rank's
    shard) gives the keys, the slice width and the types; returns host
    tensors.

    Both sources hold the start-up bank, where each slot serves its
    start-up logical.  ``moved`` maps each of the rank's local slots that
    ``rebalance_experts`` re-pointed since start-up to the logical it
    serves now (``ExpertMap.moved_slots``); such a slot is read from that
    logical's base column of ``weights.npz`` (column ``l`` holds logical
    ``l``), so the reloaded shard follows the map."""
    wanted = sorted(template_shard)
    per = next(iter(template_shard.values())).shape[EXPERT_AXIS]
    spath = (shard_ckpt_path(workdir, ep_rank) if workdir is not None
             else None)
    if spath is not None and os.path.exists(spath):
        raw = load_axis1_slices(spath, [k.replace("/", "|") for k in wanted],
                                0, per)
        loaded = {k.replace("|", "/"): t for k, t in raw.items()}
    else:
        loaded = load_axis1_slices(ckpt_path, wanted, ep_rank * per,
                                   (ep_rank + 1) * per)
    for slot, logical in sorted((moved or {}).items()):
        column = load_axis1_slices(ckpt_path, wanted, logical, logical + 1)
        for k in wanted:
            loaded[k][:, slot] = column[k][:, 0]
    return {k: t.to(template_shard[k].dtype) for k, t in loaded.items()}
