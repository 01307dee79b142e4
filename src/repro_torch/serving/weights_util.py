"""Expert-weight sharding for the simulated multi-executor runtime.

Each EP rank's slice of the routed-expert bank is kept on the host
(``split_experts``), physically separate, so a rank failure genuinely
destroys its copy.  The per-rank shard files on disk are what a role
switch reloads (§3.4); the engine no longer writes them at start-up,
since no ported path reads them, and ``save_shard_checkpoints`` /
``shard_ckpt_path`` wait for the role switch and ``rejoin_device``.

``repro.serving.weights_util`` keeps a zero-filled base copy of every
expert leaf and rebuilds the whole bank on the host on every revive.  At
full width that is ~28 GB of zeros and a ~28 GB host-to-device copy, so
the port keeps **one** device bank: ``assemble`` zeroes a dead rank's
slice in place (and copies a restored rank's slice back from its host
shard) — the same "dead slices = 0" function — and
``expert_checksums`` sums each live rank's slice on the card, so the
recovery's timed phase measures revive, not a host scan.
"""
from __future__ import annotations

import os
from typing import Dict, Iterator, List, Optional, Tuple

import torch

from repro_torch.training.checkpoint import flatten, save_flat

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
            shards[r][key] = _rank_slice(leaf, r, ep_size).cpu()
    return shards


def assemble(params, shards: List[Optional[Dict[str, torch.Tensor]]],
             alive: List[bool], resident: List[bool]) -> List[bool]:
    """Bring the device bank in line with ``alive``, in place: zero the
    slices of ranks that died, copy back from their host shards the ranks
    that returned.  ``resident`` says which slices hold weights now;
    returns the new ``resident``."""
    ep_size = len(alive)
    for key, leaf in expert_leaves(params):
        for r in range(ep_size):
            if resident[r] and not alive[r]:
                _rank_slice(leaf, r, ep_size).zero_()
            elif alive[r] and not resident[r]:
                _rank_slice(leaf, r, ep_size).copy_(shards[r][key])
    return list(alive)


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
