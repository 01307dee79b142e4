"""Flat-key ``.npz`` checkpoints, and carrying weights across from the JAX
package.

Keys are the ``/``-joined paths of the nested parameter dict, exactly as
``repro.training.checkpoint._flatten`` writes them, so one ``weights.npz``
serves both packages: :func:`params_from_flat` turns the numpy dict of
either package into the port's parameters.

numpy has no bfloat16.  A bf16 leaf is stored as its ``uint16`` bit
pattern with the tag ``__extra__/dtype/<key> = "bfloat16"``; f32 files
carry no tags and stay readable by both packages.  (A bf16 array written
by the JAX package through ``ml_dtypes`` loads as 2-byte void and is read
as the same bit pattern.)
"""
from __future__ import annotations

import os
import time
import zipfile
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

DTYPE_TAG = "__extra__/dtype/"


def flatten(params, prefix: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    """(key, leaf) pairs of a nested parameter dict, keys sorted as
    ``jax.tree_util`` orders dict keys."""
    for k in sorted(params):
        v = params[k]
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            yield from flatten(v, key + "/")
        else:
            yield key, v


def _to_numpy(t: torch.Tensor) -> Tuple[np.ndarray, Optional[str]]:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    return t.numpy(), None


def save_flat(path: str, items) -> float:
    """Stream ``(key, tensor)`` pairs into an uncompressed ``.npz``, one
    leaf at a time (host memory stays at one leaf).  Returns seconds."""
    t0 = time.perf_counter()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    tags = {}
    with zipfile.ZipFile(tmp, "w", zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, t in items:
            arr, tag = _to_numpy(t)
            if tag is not None:
                tags[key] = tag
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, np.ascontiguousarray(arr),
                                          allow_pickle=False)
        for key, tag in tags.items():
            with zf.open(DTYPE_TAG + key + ".npy", "w") as f:
                np.lib.format.write_array(f, np.asarray(tag))
    os.replace(tmp, path)
    return time.perf_counter() - t0


def save_checkpoint(path: str, params) -> float:
    return save_flat(path, flatten(params))


def load_flat(path: str, predicate: Callable[[str], bool] = lambda k: True
              ) -> Tuple[Dict[str, np.ndarray], Dict[str, str]]:
    """(arrays, dtype tags) of the keys matching ``predicate``."""
    arrays, tags = {}, {}
    with np.load(path, allow_pickle=False) as z:
        for k in z.files:
            if k.startswith(DTYPE_TAG):
                tags[k[len(DTYPE_TAG):]] = str(z[k])
            elif not k.startswith("__extra__/") and predicate(k):
                arrays[k] = z[k]
    return arrays, tags


def tensor_from_numpy(arr: np.ndarray, tag: Optional[str]) -> torch.Tensor:
    arr = np.require(arr, requirements=["C", "W"])   # copies if read-only
    if tag == "bfloat16" or (arr.dtype.kind == "V" and arr.itemsize == 2):
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def params_from_flat(items, tags: Dict[str, str], *, dtype: torch.dtype,
                     device) -> Dict[str, Any]:
    """Carry weights across: ``("a/b/c", array)`` pairs (either package's
    flat checkpoint dict, as items) -> the port's nested parameter dict,
    every leaf cast to ``dtype`` on ``device``."""
    params: Dict[str, Any] = {}
    for key, arr in items:
        node = params
        *parents, leaf = key.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        t = tensor_from_numpy(arr, tags.get(key))
        node[leaf] = t.to(device=device, dtype=dtype)
    return params


def load_params(path: str, *, dtype: torch.dtype, device) -> Dict[str, Any]:
    """Restore a checkpoint leaf by leaf (host memory stays at one leaf)."""
    with np.load(path, allow_pickle=False) as z:
        tags = {k[len(DTYPE_TAG):]: str(z[k]) for k in z.files
                if k.startswith(DTYPE_TAG)}
        items = ((k, z[k]) for k in z.files if not k.startswith("__extra__/"))
        return params_from_flat(items, tags, dtype=dtype, device=device)
