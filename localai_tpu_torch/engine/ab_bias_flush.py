"""The grammar's bias flush (``SlotSampler.write_bias_rows``) timed against
three other ways of writing the same rows, in one process on one card:

    python -m localai_tpu_torch.engine.ab_bias_flush [--rounds 4] [--flushes 20]

Variants, each writing k rows of (base + penalty) f32 [V] host arrays into
the sampler's [S, V] bias on the card, in stream order, never waiting:

  engine   the sampler's own: the sums go into pinned memory from PyTorch's
           caching host allocator, one copy of the [k, V] block and one
           ``index_copy_``
  stacked  ``transfer.to_device`` of ``np.stack`` of the sums (a fresh
           pinned buffer per call) and one ``index_copy_``
  ring     a ring of [S, V] pinned buffers of its own, each guarded by the
           event recorded behind its copies (a pending buffer is never
           refilled: a new one joins the ring), one copy per row
  ring_indexed  that ring, with one copy of the [k, V] block and one
           ``index_copy_`` (``engine`` with the ring in place of the
           caching host allocator)

Each flush runs while the stream is busy (a GPU sleep enqueued before the
round), as on a serving card whose bursts are in flight. Per flush: the
host ms (what the engine thread pays) and the device ms (CUDA events
around its copies). Each round runs every variant at k = 1 and k = S, in
the order A, B, C, D, D, C, B, A after a warm-up round; the rows written are
checked against the host sums. Prints medians as one JSON line with the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import numpy as np
import torch

from localai_tpu_torch.engine.sampling import SlotSampler
from localai_tpu_torch.engine.transfer import to_device


class _Ring:
    """The ring of pinned staging buffers (the variants ``ring`` and, with
    ``indexed``, ``ring_indexed``)."""

    def __init__(self, bias: torch.Tensor, indexed: bool = False):
        self.bias, self.bufs, self.next = bias, [], 0
        self.indexed = indexed

    def write(self, slots, rows):
        k = self.next
        if k < len(self.bufs) and not self.bufs[k][1].query():
            k = len(self.bufs)
        if k == len(self.bufs):
            self.bufs.append([torch.empty(self.bias.shape, dtype=torch.float32,
                                          pin_memory=True), None])
        buf = self.bufs[k][0]
        host = buf.numpy()
        for j, (slot, (base, pen)) in enumerate(zip(slots, rows)):
            np.add(base, pen, out=host[j])
            if not self.indexed:
                self.bias[slot].copy_(buf[j], non_blocking=True)
        if self.indexed:
            dev = self.bias.device
            idx = torch.tensor(list(slots), dtype=torch.int64).pin_memory()
            self.bias.index_copy_(0, idx.to(dev, non_blocking=True),
                                  buf[:len(slots)].to(dev, non_blocking=True))
        event = torch.cuda.Event()
        event.record()
        self.bufs[k][1] = event
        self.next = (k + 1) % len(self.bufs)


def _stacked(bias: torch.Tensor):
    def write(slots, rows):
        src = torch.empty((len(slots), bias.shape[1]), dtype=torch.float32,
                          device=bias.device)
        to_device(src, np.stack([base + pen for base, pen in rows]))
        idx = torch.empty(len(slots), dtype=torch.int64, device=bias.device)
        to_device(idx, np.asarray(slots, np.int64))
        bias.index_copy_(0, idx, src)
    return write


def _round(write, bias, slots, rows, flushes: int, sleep_cycles: int):
    """(host ms, device ms) per flush, medians over ``flushes`` flushes
    made while the stream is busy."""
    torch.cuda.synchronize()
    torch.cuda._sleep(sleep_cycles)
    host, events = [], []
    for _ in range(flushes):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t = time.perf_counter()
        a.record()
        write(slots, rows)
        b.record()
        host.append((time.perf_counter() - t) * 1e3)
        events.append((a, b))
    torch.cuda.synchronize()
    want = torch.from_numpy(np.stack([base + pen for base, pen in rows]))
    got = bias[torch.tensor(slots, device=bias.device)].cpu()
    if not torch.equal(got, want):
        raise AssertionError("the rows on the card differ from the host sums")
    return (statistics.median(host),
            statistics.median(a.elapsed_time(b) for a, b in events))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--vocab", type=int, default=128256)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--flushes", type=int, default=20)
    ap.add_argument("--sleep-cycles", type=int, default=400_000_000)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ab_bias_flush needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    S, V = args.slots, args.vocab
    rng = np.random.default_rng(0)
    sampler = SlotSampler(S, V, "cuda")
    writers = {"engine": sampler.write_bias_rows,
               "stacked": _stacked(sampler.bias),
               "ring": _Ring(sampler.bias).write,
               "ring_indexed": _Ring(sampler.bias, indexed=True).write}
    order = list(writers) + list(writers)[::-1]
    res = {}
    for k in (1, S):
        slots = sorted(rng.choice(S, size=k, replace=False).tolist())
        rows = [(rng.standard_normal(V).astype(np.float32),
                 np.where(rng.random(V) < 0.9, -np.inf, 0.0).astype(np.float32))
                for _ in slots]
        for name in writers:                                 # warm-up
            _round(writers[name], sampler.bias, slots, rows, args.flushes,
                   args.sleep_cycles)
        got = {name: ([], []) for name in writers}
        for _ in range(args.rounds):
            for name in order:
                h, d = _round(writers[name], sampler.bias, slots, rows,
                              args.flushes, args.sleep_cycles)
                got[name][0].append(h)
                got[name][1].append(d)
        for name, (h, d) in got.items():
            res[f"{name}_k{k}"] = {"host_ms": statistics.median(h),
                                   "device_ms": statistics.median(d),
                                   "host_ms_runs": h, "device_ms_runs": d}
    print(json.dumps({"ab_bias_flush": res, "slots": S, "vocab": V,
                      "flushes": args.flushes, "rounds": args.rounds,
                      "card": card}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
