"""Prometheus metrics (a copy of localai_tpu/services/metrics.py): the
api_call duration histogram, gauges and counters refreshed from the
engines right before each render, named histograms with exemplars, and
the text exposition.

The /metrics route (api/localai_routes.py) reads each served model's
``Engine.metrics()`` into this registry, labeled model="<name>", then
renders it. Hand-rolled exposition: no dependency.
"""

from __future__ import annotations

import threading
from collections import defaultdict

_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
            30.0, 60.0, 120.0, 300.0)

# Prometheus text exposition content type (version is part of the
# contract: scrapers negotiate the parser off it)
CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def escape_label_value(v) -> str:
    """Prometheus exposition label-value escaping: backslash, newline,
    double-quote (in that order — escaping the escape char first)."""
    return (str(v).replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def label_str(**kv) -> str:
    """Build a label string with properly escaped values, sorted for a
    stable exposition ordering."""
    return ",".join(f'{k}="{escape_label_value(v)}"'
                    for k, v in sorted(kv.items()))


class Metrics:
    def __init__(self):
        self._lock = threading.Lock()
        # (method, path) -> [bucket counts..., +inf], sum, count
        self._hist = defaultdict(lambda: [[0] * (len(_BUCKETS) + 1), 0.0, 0])
        self._counters = defaultdict(int)
        # pull-updated instruments: the /metrics route refreshes these
        # from each served engine's metrics() before rendering. Gauges are
        # point-in-time; "absolute counters" are totals the engine owns
        # (it counts, the registry re-exposes; a new engine starts them at
        # 0 again, which Prometheus rate() reads as a counter reset).
        self._gauges: dict = {}
        self._abs_counters: dict = {}
        # named histograms: observed here (observe_histogram) or
        # pull-updated from engine snapshots (set_histogram). Keyed
        # (name, labels) -> [buckets(tuple), counts(+Inf last), sum, n]
        self._named_hists: dict = {}
        # per-histogram exemplars: the worst recent
        # observation's correlation id, attached to the bucket line the
        # observation falls in (OpenMetrics `# {trace_id="..."}` syntax).
        # Keyed (name, labels) -> (value, trace_id, unix_ts)
        self._exemplars: dict = {}

    def observe_api_call(self, method: str, path: str, seconds: float):
        with self._lock:
            h = self._hist[(method, path)]
            for i, b in enumerate(_BUCKETS):
                if seconds <= b:
                    h[0][i] += 1
                    break
            else:
                h[0][-1] += 1
            h[1] += seconds
            h[2] += 1

    def inc(self, name: str, labels: str = ""):
        with self._lock:
            self._counters[(name, labels)] += 1

    def set_gauge(self, name: str, value, labels: str = ""):
        with self._lock:
            self._gauges[(name, labels)] = float(value)

    def set_counter(self, name: str, value, labels: str = ""):
        """Expose an engine-owned monotonic total at its current value."""
        with self._lock:
            self._abs_counters[(name, labels)] = int(value)

    def observe_histogram(self, name: str, seconds: float,
                          labels: str = "", buckets=None):
        """Observe one sample into a named histogram (cumulative
        exposition with _bucket/_sum/_count happens in render())."""
        buckets = tuple(buckets) if buckets else _BUCKETS
        with self._lock:
            h = self._named_hists.get((name, labels))
            if h is None or h[0] != buckets:
                h = self._named_hists[(name, labels)] = [
                    buckets, [0] * (len(buckets) + 1), 0.0, 0]
            for i, b in enumerate(buckets):
                if seconds <= b:
                    h[1][i] += 1
                    break
            else:
                h[1][-1] += 1
            h[2] += seconds
            h[3] += 1

    def set_histogram(self, name: str, labels: str, buckets, counts,
                      hsum: float, count: int):
        """Expose an engine-owned histogram snapshot (non-cumulative
        per-bucket counts, +Inf last) at its current state — same
        pull-updated contract as set_counter."""
        with self._lock:
            self._named_hists[(name, labels)] = [
                tuple(buckets), [int(c) for c in counts],
                float(hsum), int(count)]

    def set_exemplar(self, name: str, labels: str, value: float,
                     trace_id: str, ts: float = 0.0):
        """Attach an exemplar (worst recent observation + its trace id)
        to a named histogram — rendered on the matching bucket line."""
        with self._lock:
            self._exemplars[(name, labels)] = (float(value),
                                               str(trace_id), float(ts))

    def clear_instrument(self, name: str):
        """Drop every series of a pull-updated instrument (a model was
        unloaded; stale per-model series must not linger)."""
        with self._lock:
            for d in (self._gauges, self._abs_counters, self._named_hists,
                      self._exemplars):
                for k in [k for k in d if k[0] == name]:
                    del d[k]

    def render(self) -> str:
        lines = [
            "# HELP localai_api_call Duration of API calls",
            "# TYPE localai_api_call histogram",
        ]
        with self._lock:
            for (method, path), (buckets, total, count) in sorted(self._hist.items()):
                labels = (f'method="{escape_label_value(method)}",'
                          f'path="{escape_label_value(path)}"')
                cum = 0
                for i, b in enumerate(_BUCKETS):
                    cum += buckets[i]
                    lines.append(
                        f'localai_api_call_bucket{{{labels},le="{b}"}} {cum}')
                cum += buckets[-1]
                lines.append(f'localai_api_call_bucket{{{labels},le="+Inf"}} {cum}')
                lines.append(f'localai_api_call_sum{{{labels}}} {total:.6f}')
                lines.append(f'localai_api_call_count{{{labels}}} {count}')
            hseen = set()
            for (name, labels), (buckets, counts, hsum, count) in sorted(
                    self._named_hists.items()):
                if name not in hseen:
                    hseen.add(name)
                    lines.append(f"# TYPE localai_{name} histogram")
                sep = "," if labels else ""
                # exemplar: rendered on the bucket line whose range the
                # worst recent observation falls in
                ex = self._exemplars.get((name, labels))
                ex_i = None
                if ex is not None:
                    ex_i = len(buckets)   # +Inf by default
                    for i, b in enumerate(buckets):
                        if ex[0] <= b:
                            ex_i = i
                            break
                cum = 0
                for i, b in enumerate(buckets):
                    cum += counts[i]
                    line = (f'localai_{name}_bucket{{{labels}{sep}le="{b}"}} '
                            f'{cum}')
                    if ex_i == i:
                        line += (f' # {{trace_id="{ex[1]}"}} {ex[0]:g}'
                                 + (f' {ex[2]:.3f}' if ex[2] else ""))
                    lines.append(line)
                cum += counts[-1]
                line = f'localai_{name}_bucket{{{labels}{sep}le="+Inf"}} {cum}'
                if ex_i == len(buckets):
                    line += (f' # {{trace_id="{ex[1]}"}} {ex[0]:g}'
                             + (f' {ex[2]:.3f}' if ex[2] else ""))
                lines.append(line)
                label_part = f"{{{labels}}}" if labels else ""
                lines.append(f'localai_{name}_sum{label_part} {hsum:.6f}')
                lines.append(f'localai_{name}_count{label_part} {count}')
            for (name, labels), v in sorted(self._counters.items()):
                label_part = f"{{{labels}}}" if labels else ""
                lines.append(f"localai_{name}{label_part} {v}")
            seen = set()
            for (name, labels), v in sorted(self._gauges.items()):
                if name not in seen:
                    seen.add(name)
                    lines.append(f"# TYPE localai_{name} gauge")
                label_part = f"{{{labels}}}" if labels else ""
                lines.append(f"localai_{name}{label_part} {v:g}")
            for (name, labels), v in sorted(self._abs_counters.items()):
                if name not in seen:
                    seen.add(name)
                    lines.append(f"# TYPE localai_{name} counter")
                label_part = f"{{{labels}}}" if labels else ""
                lines.append(f"localai_{name}{label_part} {v}")
        return "\n".join(lines) + "\n"


METRICS = Metrics()
