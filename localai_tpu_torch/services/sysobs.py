"""System observability (the on-by-default parts of
localai_tpu/services/sysobs.py): compile tracking, memory watermarks,
goodput / MFU and the flight recorder.

Beside services/tracing.py (per-request spans), this module watches the
system under the request stream.

**Compile tracking.** The JAX package counts XLA compilations. The port
compiles nothing per shape: its counterpart of a compile is a CUDA graph
captured (engine/decode_graph.py, engine/prefill_graph.py) or a kernel
library built (ops/kernels/build.py) at run time. The engine thread
registers its ``CompileTracker`` (``register_thread``); the engine notes
each capture and ``build.py`` each library it builds (``note_compile``),
and the note goes to the tracker of the thread it happens on. The warm
boundary is marked at the end of ``Engine.start()`` (after the captures):
a capture or build after it is a "compile storm", a WARNING and a
``compile_storm`` event, since the captured graphs were meant to cover
every shape.

**Watermarks.** High-water marks over sampled gauges (peak active /
retained pages, host bytes, ...), folded on the engine's 0.5 s cadence so
peaks between /metrics scrapes are not lost.

**Goodput / MFU.** Analytic FLOPs per token from the model config (2 per
matmul weight plus the attention term) and the completed-request tokens
per second over a rolling window give the model FLOPs utilization against
the card's peak: ``peak_tflops``, else ``LOCALAI_PEAK_TFLOPS``, else the
table below keyed by ``torch.cuda.get_device_name()``; an unknown card (or
the CPU) reports MFU 0. Goodput counts only completed requests' tokens:
sheds, timeouts, stalls and errors produce none.

**The flight recorder** writes one JSON file of trace + state + events at
a bad moment (a stall, an audit violation), rate-limited and bounded on
disk.

Left for a later slice: the SLO engine (``parse_slo_classes``,
``SLOEngine``; off by default in JAX) and the autoscaler's signals.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from collections import deque

log = logging.getLogger(__name__)

_LAST_COMPILES = 32     # ring of recent compiles kept per tracker

_tl = threading.local()


def register_thread(tracker: "CompileTracker"):
    """Bind ``tracker`` to THIS thread (the engine thread, at its start)."""
    _tl.tracker = tracker


def note_compile(program: str, secs: float):
    """A capture or a kernel build on this thread: counted by the
    thread's tracker, if it has one (a build outside any engine thread,
    say a test calling a kernel, is nobody's)."""
    tracker = getattr(_tl, "tracker", None)
    if tracker is not None:
        tracker.note_program(program)
        tracker.on_compile(secs)


class CompileTracker:
    """Per-engine capture / build counters and compile-storm detection."""

    def __init__(self, model: str = "", on_storm=None):
        self.model = model
        self.on_storm = on_storm    # callable(rec): the event log
        self.compiles = 0
        self.compile_seconds = 0.0
        self.compiles_after_warmup = 0
        self.warm = False
        self._last: deque = deque(maxlen=_LAST_COMPILES)
        self._lock = threading.Lock()

    def note_program(self, kind: str, key=None):
        """Name the program about to be counted on THIS thread."""
        _tl.program = f"{kind}:{key}" if key is not None else kind

    def mark_warm(self):
        """Engine.start() finished: every capture or build from now on is
        a storm."""
        with self._lock:
            self.warm = True

    def on_compile(self, secs: float):
        program = getattr(_tl, "program", None) or "?"
        _tl.program = None   # one note names one compile
        with self._lock:
            self.compiles += 1
            self.compile_seconds += secs
            storm = self.warm
            rec = {"t": round(time.time(), 3), "seconds": round(secs, 4),
                   "program": program, "after_warmup": storm}
            self._last.append(rec)
            if storm:
                self.compiles_after_warmup += 1
        if storm:
            log.warning(json.dumps({
                "event": "compile_after_warmup", "model": self.model,
                "program": program, "seconds": round(secs, 4),
                "compiles_after_warmup": self.compiles_after_warmup}))
            if self.on_storm is not None:
                try:
                    self.on_storm(rec)
                except Exception:
                    pass

    def last_compiles(self) -> list:
        with self._lock:
            return list(self._last)

    def snapshot(self) -> dict:
        with self._lock:
            return {"compiles_total": self.compiles,
                    "compile_seconds_total": round(self.compile_seconds, 4),
                    "compiles_after_warmup": self.compiles_after_warmup,
                    "warm": self.warm}


class Watermarks:
    """High-water marks over sampled gauges."""

    def __init__(self):
        self._peak: dict = {}
        self._lock = threading.Lock()

    def sample(self, **gauges):
        with self._lock:
            for name, val in gauges.items():
                if val is None:
                    continue
                cur = self._peak.get(name)
                if cur is None or val > cur:
                    self._peak[name] = val

    def peak(self, name: str, default=0):
        with self._lock:
            return self._peak.get(name, default)

    def snapshot(self) -> dict:
        with self._lock:
            return {f"peak_{k}": v for k, v in sorted(self._peak.items())}


def flops_per_token(cfg, ctx: int = 0) -> float:
    """Analytic forward FLOPs per generated token of a llama-family
    config: 2 per matmul weight, plus the attention scores and values
    (~4 * h per layer per context row) at context depth ``ctx``. The
    embedding lookup is free; the LM head counts, tied or not."""
    h = cfg.hidden_size
    kv = cfg.num_kv_heads * cfg.head_dim_
    q = cfg.num_heads * cfg.head_dim_
    per_layer = (h * q          # q proj
                 + 2 * h * kv   # k, v proj
                 + q * h        # o proj
                 + 3 * h * cfg.intermediate_size)  # gate / up / down
    matmul_params = cfg.num_layers * per_layer + h * cfg.vocab_size
    attn = 4.0 * cfg.num_layers * ctx * h if ctx > 0 else 0.0
    return 2.0 * matmul_params + attn


# Peak dense bfloat16 FLOP/s of one card, by a substring of
# torch.cuda.get_device_name(). H100: NVIDIA's data sheet, SXM part, dense
# (no sparsity), at the full 700 W power limit; the card this was checked
# on reads "NVIDIA H100 80GB HBM3, 700.00 W" from `nvidia-smi
# --query-gpu=name,power.limit --format=csv,noheader`. Anything else
# (the CPU included) is unknown: MFU 0.
_PEAK_FLOPS_TABLE = (
    ("H100", 989e12),
)


def peak_device_flops() -> float:
    """Peak FLOP/s of the card: LOCALAI_PEAK_TFLOPS wins, else the table
    by the CUDA device's name, else 0.0 (unknown, or no card)."""
    env = os.environ.get("LOCALAI_PEAK_TFLOPS", "")
    if env:
        try:
            return float(env) * 1e12
        except ValueError:
            log.warning("bad LOCALAI_PEAK_TFLOPS=%r; ignoring", env)
    try:
        import torch

        if not torch.cuda.is_available():
            return 0.0
        name = torch.cuda.get_device_name(0)
    except Exception:
        return 0.0
    for sub, flops in _PEAK_FLOPS_TABLE:
        if sub in name:
            return flops
    return 0.0


class GoodputMeter:
    """Completed-request tokens -> goodput tok/s and MFU.

    ``add(n)`` is called only where a request finishes cleanly, so
    ``tokens_total`` is useful work by construction."""

    def __init__(self, flops_per_tok: float = 0.0, peak_flops: float = 0.0,
                 window_s: float = 60.0):
        self.flops_per_tok = float(flops_per_tok)
        self.peak_flops = float(peak_flops)
        self.window_s = float(window_s)
        self.tokens_total = 0
        self.requests_total = 0
        self._window: deque = deque()   # (t_monotonic, n_tokens)
        self._lock = threading.Lock()

    def add(self, n_tokens: int):
        now = time.monotonic()
        with self._lock:
            self.tokens_total += int(n_tokens)
            self.requests_total += 1
            self._window.append((now, int(n_tokens)))
            self._trim(now)

    def _trim(self, now: float):
        horizon = now - self.window_s
        w = self._window
        while w and w[0][0] < horizon:
            w.popleft()

    def tok_s(self) -> float:
        now = time.monotonic()
        with self._lock:
            self._trim(now)
            if not self._window:
                return 0.0
            toks = sum(n for _, n in self._window)
            span = max(now - self._window[0][0], 1e-3)
        return toks / span

    def mfu(self, tok_s: float = None) -> float:
        if self.peak_flops <= 0 or self.flops_per_tok <= 0:
            return 0.0
        rate = self.tok_s() if tok_s is None else tok_s
        return rate * self.flops_per_tok / self.peak_flops

    def snapshot(self) -> dict:
        rate = self.tok_s()
        return {"goodput_tokens_total": self.tokens_total,
                "goodput_requests_total": self.requests_total,
                "goodput_tok_s": round(rate, 3),
                "mfu": round(self.mfu(rate), 6),
                "flops_per_token": self.flops_per_tok,
                "peak_flops": self.peak_flops}


class FlightRecorder:
    """Atomic dumps at a bad moment: trace + state snapshot + the last
    events as ONE JSON file in ``out_dir`` (a tmp file, then os.replace,
    so a reader never sees half a dump).

    Rate-limited (``min_interval_s`` between dumps) and bounded on disk
    (the newest ``max_dumps`` kept). ``clock`` is injectable for tests.
    dump() never raises: the recorder is telemetry."""

    PREFIX = "localai-flight-"

    def __init__(self, out_dir: str = "", min_interval_s: float = 30.0,
                 max_dumps: int = 8, clock=time.monotonic):
        import tempfile

        self.out_dir = out_dir or tempfile.gettempdir()
        self.min_interval_s = float(min_interval_s)
        self.max_dumps = max(1, int(max_dumps))
        self.clock = clock
        self.dumps = 0          # written
        self.suppressed = 0     # rate-limited away
        self._last_t = None
        self._lock = threading.Lock()

    def dump(self, reason: str, payload: dict, tag: str = "slo") -> str:
        """Write one flight dump; its path, or "" when rate-limited or on
        a write failure."""
        now = self.clock()
        with self._lock:
            if self._last_t is not None \
                    and now - self._last_t < self.min_interval_s:
                self.suppressed += 1
                return ""
            self._last_t = now
            self.dumps += 1
            seq = self.dumps
        rec = {"reason": reason, "tag": tag, "ts": round(time.time(), 6)}
        rec.update(payload or {})
        name = (f"{self.PREFIX}{tag}-{os.getpid()}-"
                f"{int(time.time() * 1000)}-{seq}.json")
        path = os.path.join(self.out_dir, name)
        tmp = path + ".tmp"
        try:
            os.makedirs(self.out_dir, exist_ok=True)
            with open(tmp, "w") as f:
                json.dump(rec, f, default=str)
            os.replace(tmp, path)
        except Exception as e:
            log.warning("flight-recorder dump failed: %s", e)
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return ""
        self._prune()
        return path

    def _prune(self):
        """Keep only the newest ``max_dumps`` flight dumps in out_dir."""
        try:
            mine = sorted(
                f for f in os.listdir(self.out_dir)
                if f.startswith(self.PREFIX) and f.endswith(".json"))
            for f in mine[:-self.max_dumps]:
                try:
                    os.unlink(os.path.join(self.out_dir, f))
                except OSError:
                    pass
        except OSError:
            pass

    def snapshot(self) -> dict:
        with self._lock:
            return {"dumps": self.dumps, "suppressed": self.suppressed,
                    "dir": self.out_dir, "max_dumps": self.max_dumps,
                    "min_interval_s": self.min_interval_s}


# the SLO classes and their spec parser (a copy of the JAX module's; the
# model config validates the slo_* options with it, the SLO engine comes
# with a later slice)
SLO_CLASSES = ("high", "normal", "low")


def parse_slo_classes(spec: str) -> dict:
    """Parse a colon-separated per-class threshold spec into
    {class: threshold_ms}. Accepted shapes (option values ride a
    comma-joined wire, so colon is the list separator, as in
    priority_weights):

    * ``""``            -> {} (no objective declared)
    * ``"500"``         -> the one threshold applies to every class
    * ``"250:1000:5000"`` -> high:normal:low
    * ``"high=250:low=5000"`` -> named subset; unnamed classes have no
      objective

    Raises ValueError on anything else so config validation can reject
    typos at scan time instead of silently serving without SLOs."""
    spec = (spec or "").strip()
    if not spec:
        return {}
    parts = [p.strip() for p in spec.split(":") if p.strip()]
    if not parts:
        return {}

    def _ms(v: str) -> float:
        ms = float(v)
        if not ms > 0:
            raise ValueError(f"SLO threshold must be > 0 ms, got {v!r}")
        return ms

    if any("=" in p for p in parts):
        out = {}
        for p in parts:
            if "=" not in p:
                raise ValueError(
                    f"mixed named and positional SLO classes in {spec!r}")
            k, v = (x.strip() for x in p.split("=", 1))
            if k not in SLO_CLASSES:
                raise ValueError(
                    f"unknown SLO class {k!r} (want one of {SLO_CLASSES})")
            out[k] = _ms(v)
        return out
    if len(parts) == 1:
        ms = _ms(parts[0])
        return {c: ms for c in SLO_CLASSES}
    if len(parts) == len(SLO_CLASSES):
        return {c: _ms(p) for c, p in zip(SLO_CLASSES, parts)}
    raise ValueError(
        f"SLO spec {spec!r} must have 1 or {len(SLO_CLASSES)} "
        f"(high:normal:low) colon-separated values, got {len(parts)}")


def device_memory_stats(device=None) -> dict:
    """The card's allocator counters from ``torch.cuda.memory_stats``:
    bytes_in_use (allocated now), peak_bytes_in_use (its high-water
    mark) and bytes_limit (the card's total memory), with device_kind
    (the card's name). {} on the CPU."""
    try:
        import torch

        if device is not None and torch.device(device).type != "cuda":
            return {}
        if not torch.cuda.is_available():
            return {}
        idx = (torch.device(device).index if device is not None else None)
        idx = torch.cuda.current_device() if idx is None else idx
        st = torch.cuda.memory_stats(idx)
        out = {"bytes_in_use": int(st.get("allocated_bytes.all.current", 0)),
               "peak_bytes_in_use": int(st.get("allocated_bytes.all.peak", 0)),
               "bytes_limit": int(torch.cuda.get_device_properties(idx)
                                  .total_memory)}
        out["device_kind"] = torch.cuda.get_device_name(idx)
        return out
    except Exception:
        return {}
