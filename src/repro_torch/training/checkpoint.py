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
import struct
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


def unflatten(items) -> Dict[str, Any]:
    """The nested dict of ``(key, leaf)`` pairs, keys ``/``-joined paths
    (the inverse of :func:`flatten`)."""
    tree: Dict[str, Any] = {}
    for key, leaf in items:
        node = tree
        *parents, name = key.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[name] = leaf
    return tree


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


def restore_like(path: str, template) -> Dict[str, Any]:
    """A nested parameter dict shaped like ``template`` (a nested dict of
    tensors), each leaf read from the checkpoint at ``path`` and cast to
    its template leaf's type and device; a missing key or another shape
    raises."""
    arrays, tags = load_flat(path)
    items = []
    for key, leaf in flatten(template):
        arr = arrays[key]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"{path}: {key} has shape {arr.shape}, "
                             f"expected {tuple(leaf.shape)}")
        items.append((key, tensor_from_numpy(arr, tags.get(key)).to(
            device=leaf.device, dtype=leaf.dtype)))
    return unflatten(items)


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


def _stored_leaves(path: str):
    """Where each array of an uncompressed ``.npz`` lies in the file:
    ``{key: (offset, dtype, shape, fortran_order)}``, from the zip's local
    headers and each member's ``.npy`` header; None if any member is
    compressed.  Reading at those offsets skips ``np.load``'s chunked
    read and CRC pass (~0.8 GB/s), which dominates loading a model of
    tens of GB."""
    out = {}
    with zipfile.ZipFile(path) as zf, open(path, "rb") as f:
        for info in zf.infolist():
            if info.compress_type != zipfile.ZIP_STORED:
                return None
            f.seek(info.header_offset)
            local = f.read(30)
            if local[:4] != b"PK\x03\x04":
                return None
            name_len, extra_len = struct.unpack("<HH", local[26:30])
            f.seek(info.header_offset + 30 + name_len + extra_len)
            version = np.lib.format.read_magic(f)
            read_header = (np.lib.format.read_array_header_1_0
                           if version == (1, 0)
                           else np.lib.format.read_array_header_2_0)
            shape, fortran, dt = read_header(f)
            if dt.hasobject:
                return None
            key = info.filename[:-len(".npy")]
            out[key] = (f.tell(), dt, shape, fortran)
    return out


def _read_stored(path: str, where) -> np.ndarray:
    offset, dt, shape, fortran = where
    count = int(np.prod(shape, dtype=np.int64))
    arr = np.fromfile(path, dtype=dt, count=count, offset=offset)
    return arr.reshape(shape, order="F" if fortran else "C")


def load_params(path: str, *, dtype: torch.dtype, device) -> Dict[str, Any]:
    """Restore a checkpoint leaf by leaf (host memory stays at one leaf).
    An uncompressed file (both packages write one) is read at each
    array's offset; a compressed one through ``np.load``."""
    stored = _stored_leaves(path)
    if stored is None:
        with np.load(path, allow_pickle=False) as z:
            tags = {k[len(DTYPE_TAG):]: str(z[k]) for k in z.files
                    if k.startswith(DTYPE_TAG)}
            items = ((k, z[k]) for k in z.files
                     if not k.startswith("__extra__/"))
            return params_from_flat(items, tags, dtype=dtype, device=device)
    tags = {k[len(DTYPE_TAG):]: str(_read_stored(path, w))
            for k, w in stored.items() if k.startswith(DTYPE_TAG)}
    items = ((k, _read_stored(path, w)) for k, w in stored.items()
             if not k.startswith("__extra__/"))
    return params_from_flat(items, tags, dtype=dtype, device=device)


def load_axis1_slices(path: str, keys, start: int, stop: int
                      ) -> Dict[str, torch.Tensor]:
    """``leaf[:, start:stop]`` of each leaf in ``keys``, as host tensors in
    the stored type.  In an uncompressed file that slice is one
    contiguous run per leading index (a layer of a stacked leaf), read
    straight into the result one run at a time: the whole leaf is never
    loaded.  A compressed file is sliced after ``np.load``.  A range
    outside the leaf or a short read raises."""

    def check(k, shape):
        if len(shape) < 2 or not 0 <= start < stop <= shape[1]:
            raise ValueError(f"{path}: cannot slice {k} {tuple(shape)} "
                             f"[:, {start}:{stop}]")

    stored = _stored_leaves(path)
    out: Dict[str, torch.Tensor] = {}
    if stored is None:
        with np.load(path, allow_pickle=False) as z:
            tags = {k[len(DTYPE_TAG):]: str(z[k]) for k in z.files
                    if k.startswith(DTYPE_TAG)}
            for k in keys:
                arr = z[k]
                check(k, arr.shape)
                out[k] = tensor_from_numpy(
                    np.ascontiguousarray(arr[:, start:stop]), tags.get(k))
        return out
    tags = {k[len(DTYPE_TAG):]: str(_read_stored(path, w))
            for k, w in stored.items() if k.startswith(DTYPE_TAG)}
    with open(path, "rb") as f:
        for k in keys:
            offset, dt, shape, fortran = stored[k]
            check(k, shape)
            if fortran:
                raise ValueError(f"{path}: {k} is stored in Fortran order")
            run = int(np.prod(shape[2:], dtype=np.int64)) * dt.itemsize
            arr = np.empty((shape[0], stop - start) + tuple(shape[2:]), dt)
            flat = arr.reshape(shape[0], -1).view(np.uint8)
            for layer in range(shape[0]):
                f.seek(offset + (layer * shape[1] + start) * run)
                got = f.readinto(flat[layer])
                if got != flat.shape[1]:
                    raise OSError(f"{path}: short read of {k} layer "
                                  f"{layer}: {got} of {flat.shape[1]} "
                                  f"bytes")
            out[k] = tensor_from_numpy(arr, tags.get(k))
    return out
