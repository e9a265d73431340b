"""Structured event log: JSON-lines lifecycle events (a copy of
localai_tpu/services/eventlog.py).

Beside the span tracer (services/tracing.py): spans answer "where did
this request's time go", events answer "what did the system go through":
admissions, sheds, timeouts, completions, preemptions, stall dumps,
graph captures after warm-up, pool pressure, audit violations. Each event
is one JSON object with a wall-clock timestamp, a sequence number rising
per process and, where there is one, the request's correlation id
(``rid``), which also keys its spans.

The sink (``event_log`` = path | stderr | off, or the
``LOCALAI_EVENT_LOG`` environment variable):

* ``off`` (default) — the ring only, nothing written through
* ``stderr``        — written through to stderr
* any other value   — appended to that file (line-buffered)

Whatever the sink, the last ``ring_size`` events are kept in a bounded
ring that ``/debug/events`` serves. One EventLog per process (``EVENTS``).
"""

from __future__ import annotations

import json
import logging
import os
import sys
import threading
import time
from collections import deque

log = logging.getLogger(__name__)

RING_SIZE_DEFAULT = 512


class EventLog:
    def __init__(self, sink: str = "", ring_size: int = RING_SIZE_DEFAULT):
        self._ring: deque = deque(maxlen=max(1, int(ring_size)))
        self._lock = threading.Lock()
        self._fh = None
        self._seq = 0
        self._max_bytes = 0
        self.rotations = 0
        self.sink = "off"
        self.configure(sink or os.environ.get("LOCALAI_EVENT_LOG", ""))

    def configure(self, sink: str, max_mb: int = 64):
        """(Re)arm the write-through sink: path | stderr | off / empty.

        ``max_mb`` bounds a FILE sink: at that size the file rotates to
        ``<path>.1`` (one generation kept), so the log never fills the
        disk. 0 turns rotation off; stderr and the ring are unaffected."""
        sink = (sink or "").strip()
        with self._lock:
            if self._fh is not None and self._fh is not sys.stderr:
                try:
                    self._fh.close()
                except Exception:
                    pass
            self._fh = None
            self._max_bytes = max(0, int(max_mb)) * 1024 * 1024
            if not sink or sink == "off":
                self.sink = "off"
            elif sink == "stderr":
                self.sink = "stderr"
                self._fh = sys.stderr
            else:
                self.sink = sink
                try:
                    self._fh = open(sink, "a", buffering=1)
                except OSError as e:
                    log.warning("event_log sink %s unwritable (%s); "
                                "ring-only", sink, e)
                    self.sink = "off"

    def _maybe_rotate(self, fh):
        """Rotate the file sink once it reached the bound. Called outside
        the lock with the handle the writer used; checks again under the
        lock, so racing writers rotate once."""
        with self._lock:
            if fh is not self._fh or self._fh is sys.stderr:
                return   # rotated or reconfigured meanwhile
            try:
                if self._fh.tell() < self._max_bytes:
                    return
                self._fh.close()
                os.replace(self.sink, self.sink + ".1")
                self._fh = open(self.sink, "a", buffering=1)
                self.rotations += 1
            except Exception as e:
                log.warning("event_log rotation of %s failed (%s); "
                            "ring-only", self.sink, e)
                self._fh = None

    def emit(self, event: str, rid: str = "", model: str = "", **fields):
        """Record one event. Never raises: telemetry must not take the
        serving path down with it."""
        rec = {"ts": round(time.time(), 6), "event": event}
        if rid:
            rec["rid"] = rid
        if model:
            rec["model"] = model
        for k, v in fields.items():
            if v is not None:
                rec[k] = v
        with self._lock:
            self._seq += 1
            rec["seq"] = self._seq
            self._ring.append(rec)
            fh = self._fh
        if fh is not None:
            try:
                fh.write(json.dumps(rec, default=str) + "\n")
                if self._max_bytes and fh is not sys.stderr \
                        and fh.tell() >= self._max_bytes:
                    self._maybe_rotate(fh)
            except Exception:
                pass

    def events(self, last: int = 0) -> list:
        """The ring, oldest first; ``last`` > 0 keeps the newest N."""
        with self._lock:
            evs = list(self._ring)
        if last > 0:
            evs = evs[-last:]
        return evs

    def clear(self):
        with self._lock:
            self._ring.clear()

    def snapshot(self) -> dict:
        with self._lock:
            return {"sink": self.sink, "seq": self._seq,
                    "ring": len(self._ring),
                    "ring_size": self._ring.maxlen,
                    "rotations": self.rotations}


# One per process; the engine's ``event_log`` knob configures it.
EVENTS = EventLog()
