"""Pinned host staging for a step's uploads and readbacks.

The port runs eagerly, so every host↔device copy is a call the host
makes.  ``torch.from_numpy(x).to(cuda)`` copies from pageable memory and
then waits for the stream; ``.cpu()`` waits for every kernel queued
before it.  Either one on the launch half of a step drains the device,
and the overlap pipeline (plan step N+1 while step N runs) serializes.
So:

* :func:`upload` packs a launch's host arrays (paging arrays, chunk
  tokens, the write manifest's indices, the sampling epilogue's inputs)
  into one pinned buffer and enqueues one ``non_blocking`` copy.
* :func:`readback` enqueues ``non_blocking`` copies of a step's logits
  and predicted tokens into pinned buffers and records an event; the
  drain waits on that event alone, never on the whole device.

Both take their pinned buffers from PyTorch's caching host allocator,
which records an event for every ``non_blocking`` copy that touches a
pinned block and hands the block out again only once that event has
completed.  So a buffer the host drops while its copy is still queued
is never written again under the DMA.

On the CPU the same code runs with ordinary tensors: copies complete at
once and no event is recorded.  On the card a failure to pin raises; no
copy falls back to a blocking one.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

_ALIGN = 16          # bytes: every packed array starts on this boundary
_NUMPY_TO_TORCH = {np.dtype(np.int32): torch.int32,
                   np.dtype(np.int64): torch.int64,
                   np.dtype(np.float32): torch.float32}


def _padded(nbytes: int) -> int:
    return -(-nbytes // _ALIGN) * _ALIGN


def upload(device, *arrays) -> List[torch.Tensor]:
    """Upload host arrays in one copy; returns one tensor on ``device``
    per array, with its dtype and shape, in order.  Nothing here waits
    on the device."""
    device = torch.device(device)
    arrays = [np.asarray(a) for a in arrays]
    offs, n = [], 0
    for a in arrays:
        offs.append(n)
        n += _padded(a.nbytes)
    host = torch.empty(max(n, _ALIGN), dtype=torch.uint8,
                       pin_memory=device.type == "cuda")
    packed = host.numpy()
    for a, o in zip(arrays, offs):
        packed[o:o + a.nbytes] = np.ascontiguousarray(a).reshape(
            -1).view(np.uint8)
    dev = host.to(device, non_blocking=True)
    return [dev[o:o + a.nbytes].view(_NUMPY_TO_TORCH[a.dtype]).view(
                a.shape) for a, o in zip(arrays, offs)]


class Readback:
    """One launch's readback: the host copies (numpy, in launch order)
    and the event recorded after the copies."""
    __slots__ = ("_arrays", "_event")

    def __init__(self, arrays, event):
        self._arrays, self._event = arrays, event

    def wait(self) -> List[np.ndarray]:
        """The host copies, once the copies have landed (a wait on this
        launch's event only)."""
        if self._event is not None:
            self._event.synchronize()
        return self._arrays


def readback(tensors: Sequence[torch.Tensor]) -> Readback:
    """Enqueue copies of ``tensors`` (device tensors of any dtype numpy
    has) into pinned host tensors and record the event the drain waits
    on."""
    on_card = any(t.is_cuda for t in tensors)
    arrays = []
    for t in tensors:
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=on_card)
        host.copy_(t.detach(), non_blocking=True)
        arrays.append(host.numpy())     # the array keeps ``host`` alive
    event: Optional[torch.cuda.Event] = None
    if on_card:
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(tensors[0].device))
    return Readback(arrays, event)
