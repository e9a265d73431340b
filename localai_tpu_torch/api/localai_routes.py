"""The observability routes (counterpart of the /metrics and /debug/*
routes of localai_tpu/api/localai_routes.py):

  GET /metrics                Prometheus text (``CONTENT_TYPE``)
  GET /debug/trace            the HTTP layer's span ring and every engine's,
                              merged into one Chrome trace (Perfetto loads it)
  GET /debug/state            every engine's state_snapshot(), the event log's
  GET /debug/events[?last=N]  the event ring, oldest first (400 on a bad N)
  GET /debug/kv               every engine's kv_debug()

The port serves its models in one process, so the routes read the engines
directly (the JAX server pulls them from backend processes over gRPC),
and every engine shares the process's clock and event ring: the merged
trace shifts each engine's ring by its tracer's start on the one
monotonic clock (no clock handshake), and the events need no merge.

``export_engine_metrics`` is the JAX ``_refresh_engine_metrics`` for one
model, family by family, for every family whose source the port's engine
has. The families of modules the port has not taken yet are absent, not
zero: the loader's respawns and circuit state, the replica pool, the
autoscaler, the SLO engine, the cluster, the KV stream and weight
prefetch. The "xla_compiles" families keep their JAX names; in the port
they count graph captures and kernel builds (services/sysobs.py).
"""

from __future__ import annotations

import time

from localai_tpu_torch.api.app import ApiError, App, Response
from localai_tpu_torch.services.eventlog import EVENTS
from localai_tpu_torch.services.metrics import CONTENT_TYPE, METRICS, label_str
from localai_tpu_torch.services.tracing import chrome_trace, frontend_tracer

VERSION = "0.1.0"

_POOL_GAUGES = ("kv_pages_total", "kv_pages_free", "kv_pages_retained",
                "kv_pages_active", "kv_pages_offloaded")
_PCACHE_COUNTERS = ("hits", "misses", "evicted_pages", "inserted_pages",
                    "hit_rows")
# host-tier totals: engine stats key -> localai_kv_offload_<metric>_total
_OFFLOAD_COUNTERS = (("offloaded_pages", "pages"),
                     ("offloaded_bytes", "bytes"),
                     ("restores", "restores"),
                     ("hits", "hits"),
                     ("misses", "misses"),
                     ("evicted_pages", "evicted_pages"),
                     ("restored_pages", "restored_pages"))
# prefetch-ahead totals -> localai_kv_prefetch_<metric>_total
_PREFETCH_COUNTERS = (("prefetch_issued", "issued"),
                      ("prefetch_hits", "hits"),
                      ("prefetch_late", "late"),
                      ("prefetch_wasted", "wasted"))
# metrics()["ttft_decomp_p50_ms"] key -> localai_ttft_<metric>_p50_ms
_TTFT_GAUGES = (("queue_wait", "queue_wait"),
                ("admit_to_first", "admit_to_first"),
                ("prefill_dispatch", "prefill_dispatch"))
_PACKED_COUNTERS = ("dispatches", "tokens", "segments", "pad_tokens",
                    "kernel_fallback")
_LATENCY_HISTOGRAMS = ("ttft_seconds", "itl_seconds",
                       "decode_burst_seconds", "prefill_dispatch_seconds")
_LIFECYCLE_COUNTERS = (("requests_shed", "requests_shed_total"),
                       ("requests_timed_out", "requests_timed_out_total"),
                       ("stalls", "engine_stalls_total"),
                       ("stall_dumps", "stall_dumps_total"))
_SCHED_COUNTERS = (("preemptions", "preemptions_total"),
                   ("resumes", "resume_restore_total"),
                   ("resume_reprefills", "resume_restore_reprefills_total"),
                   ("resume_restore_rows", "resume_restore_rows_total"),
                   ("aged_promotions", "priority_aged_promotions_total"))
_DEVICE_MEM_GAUGES = (("bytes_in_use", "bytes_in_use"),
                      ("peak_bytes_in_use", "peak_bytes_in_use"),
                      ("bytes_limit", "bytes_limit"))
_SPEC_COUNTERS = (("rounds", "spec_rounds_total"),
                  ("proposed", "spec_proposed_total"),
                  ("accepted", "spec_accepted_total"))
_KV_AUDIT_COUNTERS = ("checks", "violations", "leaked_pages",
                      "ledger_events")
# the watermarks' keys, exported as mem_<key>
_SYSOBS_WATERMARKS = ("peak_queued", "peak_slots_active",
                      "peak_tokens_total", "peak_pool_active_pages",
                      "peak_pool_retained_pages", "peak_pool_pages_in_use",
                      "peak_host_offloaded_pages", "peak_host_bytes",
                      "peak_device_bytes_in_use")
# every family export_engine_metrics writes, cleared before each refresh
# so a model that is gone leaves no stale series
_FAMILIES = (
    "kv_pool_pages", "kv_pool_oversubscription", "prefix_cache_entries",
    "kv_offload_host_bytes", "ttft_samples", "queue_depth", "slots_in_flight",
    *_LATENCY_HISTOGRAMS,
    *(f"ttft_{m}_p50_ms" for _k, m in _TTFT_GAUGES),
    *(f"prefill_packed_{k}_total" for k in _PACKED_COUNTERS),
    "prefill_kernel_fallback_total",
    *(f"prefix_cache_{k}_total" for k in _PCACHE_COUNTERS),
    *(f"kv_offload_{m}_total" for _k, m in _OFFLOAD_COUNTERS),
    *(f"kv_prefetch_{m}_total" for _k, m in _PREFETCH_COUNTERS),
    "kv_prefetch_inflight",
    *(m for _k, m in _LIFECYCLE_COUNTERS),
    *(m for _k, m in _SCHED_COUNTERS),
    "queue_depth_class", "resume_queue_depth", "resume_reserve_pages",
    "xla_compiles_total", "xla_compiles_after_warmup_total",
    "goodput_tokens_total", "xla_compile_seconds", "mfu", "goodput_tok_s",
    "mem_weight_bytes", "mem_pool_frag_holes", "mem_pool_frag_ratio",
    *(f"mem_device_{m}" for _k, m in _DEVICE_MEM_GAUGES),
    *(f"mem_{k}" for k in _SYSOBS_WATERMARKS),
    "flight_dumps_total", "flight_dumps_suppressed_total",
    *(m for _k, m in _SPEC_COUNTERS), "spec_acceptance_rate",
    *(f"kv_audit_{k}_total" for k in _KV_AUDIT_COUNTERS),
    "engine_queue_limit")


def export_engine_metrics(reg, name: str, stats: dict):
    """One model's ``Engine.metrics()`` into the registry ``reg``, labeled
    model=``name`` (the JAX ``_refresh_engine_metrics`` loop body, less
    the families of modules the port has not taken: module doc)."""
    lab = label_str(model=name)
    td = stats.get("ttft_decomp_p50_ms")
    if td:
        for skey, mkey in _TTFT_GAUGES:
            reg.set_gauge(f"ttft_{mkey}_p50_ms", td.get(skey, 0.0), lab)
        reg.set_gauge("ttft_samples", td.get("n", 0), lab)
    reg.set_gauge("queue_depth", stats.get("queued", 0), lab)
    reg.set_gauge("slots_in_flight", stats.get("slots_active", 0), lab)
    for hname, h in (stats.get("histograms") or {}).items():
        if hname in _LATENCY_HISTOGRAMS:
            reg.set_histogram(hname, lab, h.get("le", ()), h.get("counts", ()),
                              h.get("sum", 0.0), h.get("count", 0))
    pp = stats.get("packed_prefill")
    if pp and stats.get("prefill_packed"):
        for key in _PACKED_COUNTERS:
            reg.set_counter(f"prefill_packed_{key}_total", pp.get(key, 0), lab)
        # a pack off the kernel path, under its own name for alerting
        reg.set_counter("prefill_kernel_fallback_total",
                        pp.get("kernel_fallback", 0), lab)
    lc = stats.get("lifecycle")
    if lc:
        for skey, mkey in _LIFECYCLE_COUNTERS:
            reg.set_counter(mkey, lc.get(skey, 0), lab)
    sch = stats.get("scheduler")
    if sch and sch.get("preempt"):
        for skey, mkey in _SCHED_COUNTERS:
            reg.set_counter(mkey, sch.get(skey, 0), lab)
        reg.set_gauge("resume_queue_depth", sch.get("resume_depth", 0), lab)
        for cls, n in (sch.get("queued_by_class") or {}).items():
            reg.set_gauge("queue_depth_class", n,
                          label_str(model=name, priority=cls))
        reg.set_gauge("resume_reserve_pages",
                      sch.get("resume_reserve_pages", 0), lab)
    spec = stats.get("spec")
    if spec and spec.get("mode") not in (None, "off"):
        for skey, mkey in _SPEC_COUNTERS:
            reg.set_counter(mkey, spec.get(skey, 0), lab)
        reg.set_gauge("spec_acceptance_rate",
                      spec.get("acceptance_rate", 0.0), lab)
        for mode, c in (spec.get("by_mode") or {}).items():
            ml = label_str(model=name, mode=mode)
            for skey, mkey in _SPEC_COUNTERS:
                reg.set_counter(mkey, c.get(skey, 0), ml)
            reg.set_gauge("spec_acceptance_rate",
                          c.get("acceptance_rate", 0.0), ml)
    so = stats.get("sysobs")
    if so:
        comp = so.get("compiles") or {}
        reg.set_counter("xla_compiles_total", comp.get("compiles_total", 0),
                        lab)
        reg.set_counter("xla_compiles_after_warmup_total",
                        comp.get("compiles_after_warmup", 0), lab)
        # float seconds: a gauge (set_counter truncates)
        reg.set_gauge("xla_compile_seconds",
                      comp.get("compile_seconds_total", 0.0), lab)
        gp = so.get("goodput") or {}
        reg.set_counter("goodput_tokens_total",
                        gp.get("goodput_tokens_total", 0), lab)
        reg.set_gauge("goodput_tok_s", gp.get("goodput_tok_s", 0.0), lab)
        reg.set_gauge("mfu", gp.get("mfu", 0.0), lab)
        for k, v in (so.get("watermarks") or {}).items():
            reg.set_gauge(f"mem_{k}", v, lab)
        reg.set_gauge("mem_weight_bytes", so.get("weight_bytes", 0), lab)
        frag = so.get("fragmentation")
        if frag:
            reg.set_gauge("mem_pool_frag_holes", frag.get("hole_pages", 0), lab)
            reg.set_gauge("mem_pool_frag_ratio", frag.get("ratio", 0.0), lab)
        dm = so.get("device_mem")
        if dm:
            for skey, mkey in _DEVICE_MEM_GAUGES:
                if skey in dm:
                    reg.set_gauge(f"mem_device_{mkey}", dm[skey], lab)
    fr = stats.get("flight_recorder")
    if fr:
        reg.set_counter("flight_dumps_total", fr.get("dumps", 0), lab)
        reg.set_counter("flight_dumps_suppressed_total",
                        fr.get("suppressed", 0), lab)
    for hname, ex in (stats.get("hist_exemplars") or {}).items():
        if hname in _LATENCY_HISTOGRAMS:
            reg.set_exemplar(hname, lab, ex.get("value", 0.0),
                             ex.get("trace_id", ""), ex.get("ts", 0.0))
    if stats.get("kv_layout") != "paged":
        return
    for key in _POOL_GAUGES:
        if key in stats:
            reg.set_gauge("kv_pool_pages", stats[key],
                          label_str(model=name, state=key[len("kv_pages_"):]))
    if "kv_pool_oversubscription" in stats:
        reg.set_gauge("kv_pool_oversubscription",
                      stats["kv_pool_oversubscription"], lab)
    pc = stats.get("prefix_cache")
    if pc:
        reg.set_gauge("prefix_cache_entries", pc.get("entries", 0), lab)
        for key in _PCACHE_COUNTERS:
            reg.set_counter(f"prefix_cache_{key}_total", pc.get(key, 0), lab)
    off = stats.get("kv_offload")
    if off:
        reg.set_gauge("kv_offload_host_bytes", off.get("bytes", 0), lab)
        for skey, mkey in _OFFLOAD_COUNTERS:
            reg.set_counter(f"kv_offload_{mkey}_total", off.get(skey, 0), lab)
        for skey, mkey in _PREFETCH_COUNTERS:
            reg.set_counter(f"kv_prefetch_{mkey}_total", off.get(skey, 0), lab)
        reg.set_gauge("kv_prefetch_inflight",
                      off.get("prefetch_inflight", 0), lab)
    ka = stats.get("kv_audit")
    if ka:
        for key in _KV_AUDIT_COUNTERS:
            reg.set_counter(f"kv_audit_{key}_total", ka.get(key, 0), lab)
    # the effective admission limit, beside queue_depth (paged engines,
    # as in JAX)
    if "queue_limit" in stats:
        reg.set_gauge("engine_queue_limit", stats.get("queue_limit", 0), lab)


def refresh_engine_metrics(app: App, reg=METRICS):
    """Every served model's metrics() into ``reg``, right before a render
    (Prometheus pull style)."""
    for g in _FAMILIES:
        reg.clear_instrument(g)
    for name, lm in list(app.models.items()):
        export_engine_metrics(reg, name, lm.engine.metrics())


def metrics(app: App, query: dict) -> Response:
    refresh_engine_metrics(app)
    return Response(METRICS.render(), content_type=CONTENT_TYPE)


def collect_traces(app: App) -> dict:
    """The HTTP layer's ring (pid 0, "localai-http") and each engine's
    (pid 1, 2, ...) as ONE Chrome trace: each engine's timestamps shift
    by its tracer's start minus the HTTP tracer's, on the process's one
    monotonic clock."""
    ft = frontend_tracer()
    front = chrome_trace(ft, pid=0, process_name="localai-http")
    events: list = list(front["traceEvents"])
    clocks: dict = {}
    for pid, (name, lm) in enumerate(list(app.models.items()), start=1):
        tr = lm.engine.tracer
        trace = chrome_trace(tr)
        shift_us = (tr.t0 - ft.t0) * 1e6
        clocks[name] = {"offset_s": 0.0, "rtt_s": 0.0,
                        "t0_epoch": trace["localai"]["t0_epoch"],
                        "shift_us": round(shift_us, 1)}
        for ev in trace["traceEvents"]:
            ev["pid"] = pid
            if ev.get("ph") == "M" and ev.get("name") == "process_name":
                ev["args"] = {"name": f"localai-engine:{name}"}
            elif "ts" in ev:
                ev["ts"] = round(ev["ts"] + shift_us, 1)
            events.append(ev)
    return {"displayTimeUnit": "ms", "traceEvents": events,
            "localai": {"t0_epoch": front["localai"]["t0_epoch"],
                        "clocks": clocks}}


def debug_trace(app: App, query: dict) -> Response:
    return Response(collect_traces(app))


def debug_state(app: App, query: dict) -> Response:
    return Response({
        "uptime_s": round(time.time() - app.started_at, 1),
        "version": VERSION,
        "models": {name: lm.engine.state_snapshot()
                   for name, lm in list(app.models.items())},
        "eventlog": EVENTS.snapshot()})


def debug_events(app: App, query: dict) -> Response:
    """The event ring, oldest first, each tagged proc "core" (one
    process); ``last`` > 0 keeps the newest N."""
    try:
        last = int(query.get("last", 0) or 0)
    except ValueError:
        raise ApiError("last must be an integer", 400) from None
    events = [dict(ev, proc="core") for ev in EVENTS.events()]
    events.sort(key=lambda ev: ev.get("ts", 0.0))
    if last > 0:
        events = events[-last:]
    return Response({"events": events, "count": len(events)})


def debug_kv(app: App, query: dict) -> Response:
    return Response({"models": {name: lm.engine.kv_debug()
                                for name, lm in list(app.models.items())}})


GETS = {"/metrics": metrics, "/debug/trace": debug_trace,
        "/debug/state": debug_state, "/debug/events": debug_events,
        "/debug/kv": debug_kv}
