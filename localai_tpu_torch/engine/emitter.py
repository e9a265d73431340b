"""The stream-emission worker (counterpart of localai_tpu/engine/emitter.py):
detokenization, stop-sequence scanning, holdback, event assembly and
every ``req.out`` put, on a thread of their own, off the engine loop.

The engine thread keeps all id-level control (EOS, length limits, the
cache edge and context shift, KV bookkeeping and the release of the
finishes it detects) and hands this worker one immutable token batch per
processed pack, burst or spec tick (``push_batch``). The worker owns the
text-level state of a request: the slot snapshot's detokenizer and
``held_text`` have one writer (this thread) while the emitter is on, and
the worker is the only writer of ``req.out`` for a slotted request, so
per-slot FIFO order is the queue's FIFO order.

Stop sequences are text, so they are DETECTED here, possibly after the
engine has dispatched further decode steps for the slot. The worker cuts
the text as the inline path does, closes the stream and reports the
finish through ``note_finish``; the engine applies the note on its next
tick (it releases the slot and pulls a racing context shift's re-prefill
back out of its queue). Tokens decoded past the stop are dropped as
tokens past any other in-flight invalidation are.

Failure paths (cancel, deadline, stall, engine error, shutdown) route
their final events through ``push_final`` on the same queue, so they land
after the tokens still queued for the stream. A worker stuck on one item
longer than the dispatch stall budget is found by the engine's watchdog
through the ``t_item_start`` heartbeat and replaced (``takeover``).
The ``emitter_wedge_ms`` fault (services/faults.py) holds the worker that
long on one item, so the watchdog's path can be driven.

With a tracer (services/tracing.py), each batch records an ``emit_bg``
span (the text work) and a ``stream_flush_bg`` span (the queue puts) on
the "emitter" track: the decomposition keeps this thread's walltime apart
from the engine loop's, which it overlaps.

A stream's closed flag lives on its snapshot (``em_done``). A request
resumed after a preemption gets a new snapshot whose ``resumed_from`` is
the paused one: on first sight the worker grafts that one's held text and
closed flag onto it (the detokenizer is the same object), which is exact
because every batch of the paused snapshot was queued, and so processed,
before the resumed one's.
"""

from __future__ import annotations

import logging
import queue
import threading
import time

from localai_tpu_torch.services.faults import FAULTS

log = logging.getLogger(__name__)


def check_stops(snap, delta):
    """If a stop sequence completes in the emitted text + ``delta`` (the
    detokenizer's text already holds it), return ``delta`` cut before the
    stop; else None. The inline ``Engine._check_stops``, byte for byte."""
    total = snap.detok.text
    for stop in snap.req.stop_sequences:
        idx = total.find(stop, max(0, len(total) - len(delta) - len(stop)))
        if idx != -1:
            emitted_before = len(total) - len(delta)
            return delta[: max(0, idx - emitted_before)]
    return None


def holdback(snap, delta):
    """Withhold a suffix of ``delta`` that is a prefix of a stop sequence
    (the inline ``Engine._holdback``): (text to send, text held)."""
    total = snap.detok.text
    hold = 0
    for stop in snap.req.stop_sequences:
        for k in range(min(len(stop) - 1, len(total)), 0, -1):
            if total.endswith(stop[:k]):
                hold = max(hold, min(k, len(delta)))
                break
    if hold:
        return delta[:-hold], delta[-hold:]
    return delta, ""


def _done(snap) -> bool:
    return getattr(snap, "em_done", False)


class EmitterWorker:
    """One background thread draining immutable token batches.

    The engine's collaborators come in as arguments (the engine imports
    this module): ``stream_event`` the StreamEvent class, ``merge_events``
    the per-batch coalescer, ``note_finish(slot, snap, ndec)`` the engine
    callback for the stop-sequence finishes found here, and
    ``note_abort(slot, snap)`` the callback for streams this worker had to
    fail (an item raised): the stream is closed with an error here, the
    engine only releases the slot. ``tracer``: the engine's RingTracer
    (None: no spans)."""

    def __init__(self, stream_event, merge_events, note_finish,
                 note_abort=None, name: str = "engine-emitter", tracer=None):
        self._StreamEvent = stream_event
        self._tracer = tracer
        self._merge = merge_events
        self._note_finish = note_finish
        self._note_abort = note_abort
        self._q: "queue.Queue" = queue.Queue()
        self._dead = False
        # the watchdog's heartbeat: the monotonic start of the item being
        # processed now, 0.0 when idle
        self.t_item_start = 0.0
        self.emitted = 0          # tokens turned into events
        self._unfinished = 0
        self._lock = threading.Lock()
        # started by the first item: an engine that never emits (built to
        # measure its memory, say) leaves no thread behind
        self._name = name
        self._thread: "threading.Thread | None" = None

    # ---- the engine side (one producer: the engine thread, or the
    # ---- shutdown caller once that thread has stopped) ----

    @property
    def alive(self) -> bool:
        """The thread runs, or has not been needed yet."""
        return self._thread is None or self._thread.is_alive()

    def _put(self, item) -> None:
        with self._lock:
            self._unfinished += 1
            if self._thread is None:
                self._thread = threading.Thread(target=self._loop,
                                                name=self._name, daemon=True)
                self._thread.start()
        self._q.put(item)

    def qsize(self) -> int:
        return self._q.qsize()

    def idle(self) -> bool:
        with self._lock:
            return self._unfinished == 0

    def push_batch(self, entries) -> None:
        """Hand over one token batch (one processed pack, burst or spec
        tick). Each entry: ``{slot, snap, tokens: [(id, logprob,
        n_decoded)], finish: None | "stop" | "length", timings: dict |
        None}``; ``finish`` is set only for a finish the engine detected
        (EOS, length), and then ``timings`` holds its final timings."""
        self._put(("batch", entries))

    def push_final(self, slot, snap, evs) -> None:
        """Route a failure or shutdown final through the stream's FIFO, so
        it lands after the stream's queued tokens. ``evs`` ending in None
        closes the stream (later items for the snapshot are dropped)."""
        self._put(("final", slot, snap, evs))

    def abandon(self) -> None:
        """Kill without seizing the queue: the thread, possibly wedged,
        drops whatever remains when it wakes. Never joins."""
        self._dead = True
        self._q.put(None)

    def takeover(self) -> list:
        """The watchdog's kill: mark the worker dead and hand back every
        item still queued, so the engine fails those streams itself. Never
        joins: the thread may stay stuck on its item for a while, and what
        it puts after the engine's error + None lands past the sentinel,
        which consumers ignore."""
        self._dead = True
        items = []
        while True:
            try:
                it = self._q.get_nowait()
            except queue.Empty:
                break
            if it is not None:
                items.append(it)
        self._q.put(None)   # unstick the thread so that it can exit
        return items

    def drain(self, timeout: float = 5.0) -> bool:
        """Wait until everything queued so far has been processed."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.idle():
                return True
            if not self.alive:
                return self.idle()
            time.sleep(0.002)
        return False

    def stop(self, timeout: float = 5.0) -> bool:
        """Drain, then end the thread (engine shutdown)."""
        ok = self.drain(timeout)
        self._dead = True
        self._q.put(None)
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        return ok

    # ---- the worker thread ----

    def _loop(self):
        while True:
            item = self._q.get()
            if item is None or self._dead:
                break
            self.t_item_start = time.monotonic()
            try:
                if FAULTS.active:
                    ms = FAULTS.take("emitter_wedge_ms")
                    if ms is not None:
                        time.sleep(float(ms) / 1e3)
                if item[0] == "batch":
                    self._process_batch(item[1])
                else:
                    _kind, slot, snap, evs = item
                    self._final(slot, snap, evs)
            except Exception as e:
                log.exception("emitter item failed")
                self._fail_item(item, e)
            finally:
                self.t_item_start = 0.0
                with self._lock:
                    self._unfinished -= 1

    def _adopt(self, snap):
        """First sight of a resumed snapshot: graft the paused one's text
        state on (module doc)."""
        prev = getattr(snap, "resumed_from", None)
        if prev is not None:
            snap.resumed_from = None
            snap.held_text = prev.held_text
            snap.em_done = _done(prev)

    def _final(self, slot, snap, evs):
        self._adopt(snap)
        if _done(snap):
            return   # the stream is closed already (a stop found here)
        out = snap.req.out
        for ev in evs:
            out.put(ev)
        if evs and evs[-1] is None:
            snap.em_done = True

    def _fail_item(self, item, exc):
        """An item raised midway: fail every stream it carried with an
        error event, so no consumer waits on tokens that died with the
        exception, and tell the engine to release the slots. Never raises
        (it runs in the worker's exception handler)."""
        try:
            if item[0] == "batch":
                affected = [(e["slot"], e["snap"]) for e in item[1]]
            else:
                affected = [(item[1], item[2])]
            for slot, snap in affected:
                if _done(snap):
                    continue
                snap.em_done = True
                snap.req.out.put(self._StreamEvent(
                    token_id=-1, text="", logprob=0.0, finish_reason="stop",
                    error=f"{type(exc).__name__}: {exc}"))
                snap.req.out.put(None)
                if self._note_abort is not None:
                    self._note_abort(slot, snap)
        except Exception:
            log.exception("emitter failure cleanup failed")

    def _process_batch(self, entries):
        # the text work first (finished flags flip here, so a later entry
        # of a snapshot closed earlier in the batch is dropped), then one
        # pass of queue puts, then the engine notes, after the streams
        # are closed
        t0 = time.monotonic()
        writes, notes = [], []
        for e in entries:
            out, evs, note = self._build_entry(e)
            if evs:
                writes.append((out, evs))
            if note is not None:
                notes.append(note)
        tput = time.monotonic()
        for out, evs in writes:
            for ev in evs:
                out.put(ev)
        for slot, snap, ndec in notes:
            self._note_finish(slot, snap, ndec)
        tr = self._tracer
        if tr is not None and tr.enabled:
            tr.record("emit_bg", "emitter", t0, tput,
                      args={"entries": len(entries)})
            tr.record("stream_flush_bg", "emitter", tput, time.monotonic())

    def _timings(self, snap, ndec):
        """The final event's timings for a stop found here (the engine
        computes them for the finishes it detects)."""
        req = snap.req
        dt = time.monotonic() - snap.t_first_token
        return {
            "prefill_ms": snap.t_prefill_ms,
            "queue_wait_ms": max(0.0, (snap.t_start - req.t_submit) * 1e3)
            if req.t_submit else 0.0,
            "admit_to_first_ms": max(0.0, (snap.t_first_token - snap.t_start) * 1e3)
            if snap.t_first_token else 0.0,
            "decode_tokens_per_s": (ndec - 1) / dt if dt > 0 and ndec > 1 else 0.0,
            "reused_prompt_tokens": snap.reused,
        }

    def _build_entry(self, e):
        """Detokenize, scan for stops and build the events of one entry,
        with no queue traffic: (out queue, events, note). The events may
        end in the None sentinel; ``note`` is (slot, snap, n_decoded) for a
        stop found here, which the engine does not know of yet."""
        snap, slot = e["snap"], e["slot"]
        self._adopt(snap)
        if _done(snap):
            return None, (), None
        toks, finish = e["tokens"], e["finish"]
        evs = []
        last_j = len(toks) - 1
        for j, (tok, lp, ndec) in enumerate(toks):
            fin = finish if j == last_j else None
            timings = None   # set only for a stop found here
            if fin == "stop":
                # an EOS the engine found: the token itself is never
                # detokenized (as inline)
                delta = snap.held_text + snap.detok.flush()
                snap.held_text = ""
            elif fin == "length":
                delta = snap.held_text + snap.detok.push(tok) + snap.detok.flush()
                snap.held_text = ""
            else:
                delta = snap.held_text + snap.detok.push(tok)
                snap.held_text = ""
                if snap.req.stop_sequences:
                    cut = check_stops(snap, delta)
                    if cut is not None:
                        delta, fin = cut, "stop"
                        timings = self._timings(snap, ndec)
                    elif delta:
                        delta, snap.held_text = holdback(snap, delta)
            ev = self._StreamEvent(
                token_id=tok, text=delta, logprob=lp, finish_reason=fin,
                prompt_tokens=snap.prompt_len, completion_tokens=ndec)
            self.emitted += 1
            if fin is not None:
                snap.em_done = True
                ev.timings = e["timings"] if timings is None else timings
                final = []
                if evs:
                    final.append(evs[0] if len(evs) == 1 else self._merge(evs))
                final += [ev, None]
                note = (slot, snap, ndec) if timings is not None else None
                return snap.req.out, final, note
            evs.append(ev)
        if evs:
            return snap.req.out, [evs[0] if len(evs) == 1 else self._merge(evs)], None
        return None, (), None
