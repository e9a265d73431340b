"""Request-lifecycle tracing: a ring-buffer span tracer (a copy of
localai_tpu/services/tracing.py).

The engine records timestamped spans (queue_wait, admission, prefill
dispatches, decode bursts, emission, stream flush) keyed by the request's
correlation id into a fixed-size ring: bounded memory, one tuple per
span, one lock. The totals per span name survive ring wraparound, so the
host-vs-device decomposition (``summary()["decomp_ms"]``) covers the
engine's whole lifetime even when single spans were overwritten.

``chrome_trace()`` renders the ring as Chrome trace-event JSON
(https://ui.perfetto.dev loads it as it is): one track per slot plus one
for the engine's tick loop ("sched") and one for its dispatches
("engine").

What "device" means here. The JAX engine's device spans run from a
dispatch to the moment its sync worker saw the results ready. The port
has no sync worker: each pack or burst copies its results into pinned
host memory and records a CUDA event after the copy
(engine/transfer.py::Fetch). Its ``t_ready`` is the moment the engine
loop first sees that event complete (``Fetch.done`` or ``Fetch.wait``).
So ``prefill_device`` and ``decode_burst_device`` end late when the loop
looks late (busy emitting or dispatching the next item), and
``finish_detect`` (t_ready to processing) is then short; their sum is
what the engine waited in all. The tracer itself never reads a CUDA
tensor: every span argument comes from host state the loop already has.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time

# Span names counted as HOST loop work in the decomposition: the time the
# engine thread spends dispatching, emitting and flushing (walltime on
# the engine thread).
HOST_SPANS = frozenset({
    "admission",
    "prefill_chunk",
    "prefill_dispatch",
    "decode_dispatch",
    "emit",
    "stream_flush",
    "offload_dispatch",
    "restore_dispatch",
})

# Span names counted as DEVICE time: dispatch -> the loop seeing the
# results' CUDA event complete (module doc).
DEVICE_SPANS = frozenset({
    "prefill_device",
    "decode_burst_device",
})

# Span names recorded by the EMITTER worker thread: detokenization, the
# stop scan and the stream puts. Their own bucket: this walltime overlaps
# both the device's and the engine loop's.
EMITTER_SPANS = frozenset({
    "emit_bg",
    "stream_flush_bg",
})

# results seen ready -> the engine loop processing them
FINISH_DETECT_SPAN = "finish_detect"


class RingTracer:
    """Fixed-size span ring with per-name totals that are always kept.

    ``record()`` is the only hot-path entry point; with ``enabled`` False
    it returns at once without taking the lock (trace=False costs one
    check). Spans are (name, track, t0, t1, rid, args) tuples with t0 / t1
    from time.monotonic().
    """

    def __init__(self, size: int = 4096, enabled: bool = True):
        self.size = max(1, int(size))
        self.enabled = bool(enabled) and int(size) > 0
        self._buf: list = [None] * self.size
        self._n = 0  # spans ever recorded
        self._agg: dict = {}  # name -> [total_s, count]
        self._lock = threading.Lock()
        # the trace epoch: chrome_trace timestamps are relative to it
        self.t0 = time.monotonic()
        self.t0_epoch = time.time()

    def record(self, name, track, t0, t1, rid="", args=None):
        if not self.enabled:
            return
        with self._lock:
            self._buf[self._n % self.size] = (name, track, t0, t1, rid, args)
            self._n += 1
            a = self._agg.get(name)
            if a is None:
                a = self._agg[name] = [0.0, 0]
            a[0] += t1 - t0
            a[1] += 1

    def spans(self) -> list:
        """The retained spans, oldest first, as dicts."""
        with self._lock:
            n = self._n
            if n <= self.size:
                raw = self._buf[:n]
            else:
                cut = n % self.size
                raw = self._buf[cut:] + self._buf[:cut]
        return [
            {"name": s[0], "track": s[1], "t0": s[2], "t1": s[3],
             "rid": s[4], "args": s[5]}
            for s in raw if s is not None
        ]

    def reset(self):
        with self._lock:
            self._buf = [None] * self.size
            self._n = 0
            self._agg = {}
            self.t0 = time.monotonic()
            self.t0_epoch = time.time()

    def summary(self) -> dict:
        """The totals per span name and the host-vs-device decomposition."""
        if not self.enabled:
            return {"enabled": False}
        with self._lock:
            n = self._n
            agg = {k: (v[0], v[1]) for k, v in self._agg.items()}
        by_span = {
            name: {"total_ms": round(tot * 1e3, 3), "count": cnt,
                   "avg_ms": round(tot * 1e3 / cnt, 4) if cnt else 0.0}
            for name, (tot, cnt) in sorted(agg.items())
        }
        host = sum(t for name, (t, _) in agg.items() if name in HOST_SPANS)
        device = sum(t for name, (t, _) in agg.items() if name in DEVICE_SPANS)
        emitter = sum(t for name, (t, _) in agg.items()
                      if name in EMITTER_SPANS)
        fin = agg.get(FINISH_DETECT_SPAN, (0.0, 0))[0]
        return {
            "enabled": True,
            "ring_size": self.size,
            "spans_recorded": n,
            "spans_dropped": max(0, n - self.size),
            "by_span_ms": by_span,
            "decomp_ms": {
                "host_loop": round(host * 1e3, 3),
                "device": round(device * 1e3, 3),
                "emitter": round(emitter * 1e3, 3),
                "finish_detect": round(fin * 1e3, 3),
            },
        }


def _track_order_key(track: str):
    # the tick loop first, engine dispatches second, slots in number order
    if track == "sched":
        return (0, 0)
    if track == "engine":
        return (1, 0)
    if track.startswith("slot"):
        try:
            return (2, int(track[4:]))
        except ValueError:
            pass
    return (3, track)


def chrome_trace(tracer: RingTracer, pid: int = 1,
                 process_name: str = "localai-engine") -> dict:
    """The ring as a Chrome trace-event JSON object.

    One thread (track) per slot plus "sched" (the engine's tick loop) and
    "engine" (dispatch and device spans). Load the serialized dict at
    https://ui.perfetto.dev or chrome://tracing. The top-level
    ``localai`` block carries the trace epoch (the wall-clock time of the
    timeline's zero) and the process id.
    """
    spans = tracer.spans()
    tracks = sorted({s["track"] for s in spans}, key=_track_order_key)
    tid = {t: i for i, t in enumerate(tracks)}
    events: list = [{
        "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
        "args": {"name": process_name},
    }]
    for t in tracks:
        events.append({
            "name": "thread_name", "ph": "M", "pid": pid, "tid": tid[t],
            "args": {"name": t},
        })
        events.append({
            "name": "thread_sort_index", "ph": "M", "pid": pid,
            "tid": tid[t], "args": {"sort_index": tid[t]},
        })
    base = tracer.t0
    for s in spans:
        args = dict(s["args"]) if s["args"] else {}
        if s["rid"]:
            args["request_id"] = s["rid"]
        events.append({
            "name": s["name"],
            "cat": "engine",
            "ph": "X",
            "pid": pid,
            "tid": tid[s["track"]],
            "ts": round((s["t0"] - base) * 1e6, 1),
            "dur": round(max(0.0, s["t1"] - s["t0"]) * 1e6, 1),
            "args": args,
        })
    return {"displayTimeUnit": "ms", "traceEvents": events,
            "localai": {"t0_epoch": tracer.t0_epoch,
                        "pid": os.getpid()}}


# --- the HTTP layer's tracer ----------------------------------------------
# The server records its own spans (one "http" span per request, under the
# request's correlation id) into a ring of its own; /debug/trace merges it
# with every engine's. LOCALAI_TRACE=0 turns it off (record() is then the
# same one-check no-op the engine's trace=False gives).

_frontend_tracer = None
_frontend_lock = threading.Lock()


def frontend_tracer() -> RingTracer:
    """The process's tracer for the HTTP layer (one per process)."""
    global _frontend_tracer
    with _frontend_lock:
        if _frontend_tracer is None:
            enabled = os.environ.get("LOCALAI_TRACE", "1").strip().lower() \
                not in ("0", "false", "off", "no")
            size = int(os.environ.get("LOCALAI_TRACE_RING_SIZE", "2048")
                       or 2048)
            _frontend_tracer = RingTracer(size, enabled=enabled)
        return _frontend_tracer


def dump_ring(tracer: RingTracer, out_dir: str = "", tag: str = "stall") -> str:
    """Write the span ring to disk as perfetto-loadable JSON; return the
    path. The stall watchdog calls it when it aborts a stalled dispatch,
    so the trace of the run-up to the stall outlives the process."""
    out_dir = out_dir or tempfile.gettempdir()
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(
        out_dir,
        f"localai-{tag}-{os.getpid()}-{int(time.time() * 1e3)}.trace.json")
    with open(path, "w") as f:
        json.dump(chrome_trace(tracer), f)
    return path
