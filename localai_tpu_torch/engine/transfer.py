"""Host <-> device copies that do not stall the engine thread.

The pipelined loop (engine/engine.py) keeps decode bursts and packs in
flight on one CUDA stream while the host prepares the next dispatch. A
plain ``tensor.copy_`` between pageable host memory and the card waits
for the whole stream, every dispatch before it included, so the loop
never copies that way:

  * ``to_device`` stages host data in a FRESH pinned buffer and copies it
    with ``non_blocking=True``. The copy runs in stream order, when the
    card reaches it, and reads the staged buffer then, not the host array
    it came from, so the caller may rewrite that array at once (the page
    table, the override rows, a pack). PyTorch's caching host allocator
    records an event on the staged buffer and does not hand it out again
    before the copy has run.
  * ``Fetch`` copies a device tensor into a pinned buffer of its own,
    also in stream order, and records a CUDA event after the copy;
    ``done`` asks whether the event fired, ``wait`` blocks on it alone
    (the counterpart of the JAX engine's sync worker reading one
    dispatch's results in order) and returns the host array.

On CPU tensors both are plain copies: the work they follow has already
run, and a Fetch holds its own copy, since the source buffer is static
and the next dispatch rewrites it before the host reads this one.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def to_device(dst: torch.Tensor, src: np.ndarray):
    """Copy host ``src`` into ``dst`` (same shape) in stream order,
    without waiting for the stream: through a fresh pinned buffer on
    CUDA, a plain copy on the CPU."""
    t = torch.from_numpy(np.ascontiguousarray(src))
    if dst.is_cuda:
        dst.copy_(t.pin_memory(), non_blocking=True)
    else:
        dst.copy_(t)


class Fetch:
    """One device -> host copy in flight: a pinned host tensor and the
    CUDA event recorded after the copy (module doc)."""

    __slots__ = ("host", "event")

    def __init__(self, src: torch.Tensor):
        self.event: Optional[torch.cuda.Event] = None
        if src.is_cuda:
            self.host = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
            self.host.copy_(src, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = src.clone()

    @classmethod
    def of(cls, array: np.ndarray) -> "Fetch":
        """A Fetch that is already done, holding ``array``."""
        f = cls.__new__(cls)
        f.host, f.event = torch.from_numpy(np.asarray(array)), None
        return f

    def done(self) -> bool:
        """Whether the copy has landed (without blocking)."""
        return self.event is None or self.event.query()

    def wait(self) -> np.ndarray:
        """Block until the copy has landed; the host array."""
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()
