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
    ``done`` asks whether the event fired, ``wait`` waits for it alone
    (the counterpart of the JAX engine's sync worker reading one
    dispatch's results in order), polling with a bound (the engine's
    dispatch-stall watchdog: ``Stalled``), and returns the host array. bfloat16,
    which numpy lacks, comes back as its uint16 bit patterns
    (``numpy_of``), the form the host tier (engine/kv_offload.py) keeps.
  * The host tier (engine/kv_offload.py) moves whole KV pages:
    ``pages_to_host`` copies each page of a gathered [L, n, ...] tensor
    into a pinned host tensor of its own, in stream order, which the tier
    then keeps as the page's content (one page is one caching-allocator
    block, freed alone when the page leaves the tier);
    ``pages_to_device`` copies n host pages back into one [L, n, ...]
    tensor on the card with ``non_blocking=True``, straight from those
    pinned tensors (a page without one, loaded from a file, is pinned
    first). The caching host allocator records an event on each source
    block, so a page evicted from the tier while its copy is queued is
    not handed out again before the copy ran.

On CPU tensors both are plain copies: the work they follow has already
run, and a Fetch holds its own copy, since the source buffer is static
and the next dispatch rewrites it before the host reads this one.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch


def numpy_of(t: torch.Tensor) -> np.ndarray:
    """The numpy view of a CPU tensor; bfloat16 as its uint16 bit
    patterns."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def tensor_of(a: np.ndarray) -> torch.Tensor:
    """A CPU tensor over host array ``a`` (no copy; uint16 as bfloat16)."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def pages_to_host(rows: torch.Tensor) -> list:
    """The n pages [L, ...] of ``rows`` [L, n, ...] as n host tensors: on
    CUDA each copied into a pinned tensor of its own without waiting for
    the stream (record an event after them to know when they landed); on
    the CPU contiguous copies."""
    out = []
    for i in range(rows.shape[1]):
        page = rows[:, i]
        if rows.is_cuda:
            h = torch.empty(page.shape, dtype=page.dtype, pin_memory=True)
            h.copy_(page, non_blocking=True)
            out.append(h)
        else:
            out.append(page.clone())
    return out


def pages_to_device(pages: list, device: torch.device) -> torch.Tensor:
    """n host pages [L, ...] (tensors) as ONE new tensor [L, n, ...] on
    ``device``: on CUDA each page copied in without waiting for the
    stream, from its pinned memory (a pageable page is pinned first); on
    the CPU the stacked pages."""
    if device.type != "cuda":
        return torch.stack(pages, dim=1)
    first = pages[0]
    out = torch.empty((first.shape[0], len(pages)) + tuple(first.shape[1:]),
                      dtype=first.dtype, device=device)
    for i, page in enumerate(pages):
        src = page if page.is_pinned() else page.pin_memory()
        out[:, i].copy_(src, non_blocking=True)
    return out


def to_device(dst: torch.Tensor, src: np.ndarray):
    """Copy host ``src`` into ``dst`` (same shape) in stream order,
    without waiting for the stream: through a fresh pinned buffer on
    CUDA, a plain copy on the CPU."""
    t = torch.from_numpy(np.ascontiguousarray(src))
    if dst.is_cuda:
        dst.copy_(t.pin_memory(), non_blocking=True)
    else:
        dst.copy_(t)


class Stalled(TimeoutError):
    """A Fetch did not land within the stall bound of ``Fetch.wait``."""


class Fetch:
    """One device -> host copy in flight: a pinned host tensor and the
    CUDA event recorded after the copy (module doc). ``t_due`` (monotonic
    seconds) and ``err`` model a late or a failed copy for fault
    injection (services/faults.py): the copy counts as landed no earlier
    than ``t_due``, and ``wait`` raises ``err``. ``t_ready`` (monotonic) is
    when a ``done`` or ``wait`` call first saw it landed (0.0 until then):
    the end of the engine's device spans (services/tracing.py)."""

    __slots__ = ("host", "event", "t_due", "err", "t_ready")

    def __init__(self, src: torch.Tensor):
        self.event: Optional[torch.cuda.Event] = None
        self.t_due = 0.0
        self.err: Optional[BaseException] = None
        self.t_ready = 0.0
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
        f.t_due, f.err, f.t_ready = 0.0, None, 0.0
        return f

    def done(self) -> bool:
        """Whether the copy has landed (without blocking)."""
        if self.err is None:
            if self.t_due and time.monotonic() < self.t_due:
                return False
            if self.event is not None and not self.event.query():
                return False
        if not self.t_ready:
            self.t_ready = time.monotonic()
        return True

    def wait(self, since: float = 0.0, stall_s: float = 0.0) -> np.ndarray:
        """Wait until the copy has landed; the host array (bfloat16 as
        uint16, ``numpy_of``). With ``stall_s`` > 0 the wait never blocks
        for ever: it polls ``done`` in short sleeps (20 us, doubling up to
        0.5 ms, so a landing is seen within 0.5 ms and the wait leaves the
        GIL to the other threads) and raises ``Stalled`` once ``stall_s``
        seconds have passed since ``since`` (monotonic: the engine passes
        the later of the dispatch and the last landing it saw). With
        ``stall_s`` <= 0 it waits for the event alone, however long."""
        if stall_s > 0:
            step = 20e-6
            while not self.done():
                if time.monotonic() - since > stall_s:
                    raise Stalled(f"no landing within {stall_s * 1e3:.0f} ms")
                time.sleep(step)
                step = min(2 * step, 5e-4)
        else:
            if self.t_due:
                time.sleep(max(0.0, self.t_due - time.monotonic()))
            if self.event is not None:
                self.event.synchronize()
            if not self.t_ready:
                self.t_ready = time.monotonic()
        if self.err is not None:
            raise self.err
        return numpy_of(self.host)
