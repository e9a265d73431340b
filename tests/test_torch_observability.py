"""The port's observability at the JAX engine's defaults against the JAX
Engine, on the CPU, over the tiny f32 checkpoint (tests/tinymodel.py):
the span tracer, the event ring, the latency histograms, the KV lifecycle
ledger with its online auditor, the stall's span-ring dump, the wedged
emitter's replacement, and the server's /metrics and /debug/* routes.

Pins: the same request script through both engines with kv_audit
"strict": the same tokens; 0 violations while serving and after a
drained shutdown; one request, queue_wait and admission span per request
under the same request ids; the same set of span names; per request the
same sequence of event names; ttft_seconds counts every request.
trace=False records nothing; kv_audit="off" builds no auditor and leaves
the tokens as they were; a sync_delay_ms stall writes a span-ring dump
(stall_dumps 1) on both; emitter_wedge_ms gets the worker replaced on
both. /metrics: the JAX ``_refresh_engine_metrics``, fed the port
engine's metrics() JSON, renders every family the port renders with the
same labels and values. The routes: Prometheus content type, ?last=N, a
400 on a bad last, /debug/kv's {"mode": "off"} shape.
"""

from __future__ import annotations

import tests.torch_cpu  # noqa: F401  (one torch CPU thread)

import glob
import json
import os
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

from localai_tpu.services import metrics as jmet
from localai_tpu.services.eventlog import EVENTS as JEVENTS
from localai_tpu.services.faults import FAULTS as JFAULTS
from localai_tpu_torch.api import localai_routes as troutes
from localai_tpu_torch.services import metrics as tmet
from localai_tpu_torch.services.eventlog import EVENTS as TEVENTS
from localai_tpu_torch.services.faults import FAULTS
from tests.test_torch_spec_engine import (drain, jax_engine, port_engine,
                                          submit, tiny)  # noqa: F401

OBS = dict(kv_audit="strict")


@pytest.fixture(autouse=True)
def _clean_faults():
    FAULTS.reset()
    JFAULTS.reset()
    yield
    FAULTS.reset()
    JFAULTS.reset()


def _script():
    rng = np.random.default_rng(11)
    base = rng.integers(2, 258, size=40).tolist()
    return [("obs-a", base, 12), ("obs-b", rng.integers(2, 258, size=9).tolist(), 20),
            ("obs-c", [7, 8, 9, 10] * 10, 16),
            ("obs-d", base + [3, 4, 5], 10)]        # reuses obs-a's pages


def _serve(e, tag: str) -> dict:
    out = {}
    for rid, prompt, n in _script():
        out[rid] = drain(submit(e, prompt, n, rid=f"{tag}-{rid}"))
    return out


def _events_by_rid(events, tag):
    by = {}
    for ev in events:
        rid = ev.get("rid", "")
        if rid.startswith(tag + "-"):
            by.setdefault(rid[len(tag) + 1:], []).append(ev["event"])
    return by


def _spans(e):
    return [s for s in e.tracer.spans()]


@pytest.fixture(scope="module")
def served(tiny):  # noqa: F811
    """Both engines after the script, with kv_audit strict: (port, jax,
    port results, jax results)."""
    tag = f"served{os.getpid()}"
    e = port_engine(tiny, **OBS)
    je = jax_engine(tiny, **OBS)
    got = _serve(e, tag)
    want = _serve(je, tag)
    time.sleep(0.6)                        # one housekeeping pass at least
    yield e, je, got, want, tag
    e.shutdown()
    je.shutdown()


def test_tokens_equal_and_audit_clean(served):
    e, je, got, want, _tag = served
    for rid in got:
        assert got[rid]["ids"] == want[rid]["ids"], rid
        assert not got[rid]["errors"]
    assert got["obs-d"]["reused"] == want["obs-d"]["reused"] > 0
    for eng in (e, je):
        ka = eng.metrics()["kv_audit"]
        assert ka["mode"] == "strict" and ka["violations"] == 0
        assert ka["checks"] >= 1 and ka["ledger_events"] > 0
    sweep = e.kv_audit_sweep()
    assert sweep["violations"] == 0 and sweep["leaked_pages"] == 0


def test_request_spans_and_span_names(served):
    e, je, _got, _want, tag = served
    per = {}
    for name, eng in (("port", e), ("jax", je)):
        spans = _spans(eng)
        counts = {}
        for s in spans:
            if s["name"] in ("request", "queue_wait", "admission"):
                counts[(s["name"], s["rid"])] = counts.get(
                    (s["name"], s["rid"]), 0) + 1
        for rid, _p, _n in _script():
            for sname in ("request", "queue_wait", "admission"):
                assert counts.get((sname, f"{tag}-{rid}")) == 1, (name, sname, rid)
        per[name] = {s["name"] for s in spans}
    assert per["port"] == per["jax"]
    assert {"prefill_dispatch", "prefill_device", "finish_detect", "prefill",
            "decode_dispatch", "decode_burst_device", "decode", "emit",
            "stream_flush", "emit_bg", "stream_flush_bg", "tick",
            "spec_round", "spec_draft", "spec_verify"} <= per["port"]
    tr = e.metrics()["trace"]
    assert tr["enabled"] and tr["spans_recorded"] > 0
    assert set(tr["decomp_ms"]) == {"host_loop", "device", "emitter",
                                    "finish_detect"}
    assert tr["decomp_ms"]["device"] > 0 and tr["decomp_ms"]["emitter"] > 0
    chrome = e.trace_events()
    xs = [ev for ev in chrome["traceEvents"] if ev["ph"] == "X"]
    assert xs and all(ev["dur"] >= 0 for ev in xs)
    assert json.loads(json.dumps(chrome)) == chrome


def test_events_per_request_match_jax(served):
    _e, _je, _got, _want, tag = served
    got = _events_by_rid(TEVENTS.events(), tag)
    want = _events_by_rid(JEVENTS.events(), tag)
    assert got == want
    assert got == {rid: ["admit", "complete"] for rid, _p, _n in _script()}
    done = [ev for ev in TEVENTS.events() if ev["event"] == "complete"
            and ev.get("rid") == f"{tag}-obs-b"]
    assert done[0]["completion_tokens"] == 20 and done[0]["finish"] == "length"


def test_histograms_goodput_and_metrics_keys(served):
    e, je, _got, _want, _tag = served
    m, jm = e.metrics(), je.metrics()
    n = len(_script())
    h = m["histograms"]
    assert set(h) == set(jm["histograms"])
    assert h["ttft_seconds"]["count"] == jm["histograms"]["ttft_seconds"]["count"] == n
    assert h["ttft_seconds"]["le"] == jm["histograms"]["ttft_seconds"]["le"]
    assert sum(h["ttft_seconds"]["counts"]) == n
    assert h["itl_seconds"]["count"] > 0 and h["decode_burst_seconds"]["count"] > 0
    assert h["prefill_dispatch_seconds"]["count"] > 0
    assert m["ttft_decomp_p50_ms"]["n"] == n
    gp = m["sysobs"]["goodput"]
    assert gp["goodput_tokens_total"] == jm["sysobs"]["goodput"]["goodput_tokens_total"]
    assert gp["goodput_requests_total"] == n
    assert gp["mfu"] == 0.0                       # the CPU: an unknown peak
    assert m["sysobs"]["compiles"]["warm"] and not m["sysobs"].get("device_mem")
    assert m["slots_active"] == 0 and m["slots_total"] == 4
    assert set(m["flight_recorder"]) == set(jm["flight_recorder"])
    for key in ("trace", "histograms", "sysobs", "flight_recorder", "kv_audit",
                "slots_active", "kv_pool_oversubscription", "kv_pages_in_use"):
        assert key in m and key in jm, key
    st = e.state_snapshot()
    assert st["warm"] and len(st["slots"]) == 4
    assert set(st) >= {"slots", "queued", "compiles", "watermarks", "goodput",
                       "lifecycle", "pool"}
    kd = e.kv_debug()
    assert kd["mode"] == "strict" and kd["audit"]["violations"] == 0
    assert kd["ledger_tail"] and kd["pool"]["pages_total"] == e._pool.num_pages


def test_drained_shutdown_audits_clean(tiny):  # noqa: F811
    for name, eng in (("port", port_engine(tiny, **OBS)),
                      ("jax", jax_engine(tiny, **OBS))):
        tag = f"drain{name}"
        _serve(eng, tag)
        eng.shutdown()                     # strict: a leak would raise here
        snap = eng.kv_audit_sweep(drained=True)
        assert snap["violations"] == 0 and snap["leaked_pages"] == 0, name
        assert snap["ledger"]["live_pages"] == 0
        assert snap["ledger"]["live_holds"] == 0


def test_trace_off_records_nothing(tiny):  # noqa: F811
    e = port_engine(tiny, trace=False)
    try:
        got = _serve(e, "notrace")
        assert e.tracer.spans() == []
        m = e.metrics()
        assert m["trace"] == {"enabled": False}
        assert m["histograms"]["ttft_seconds"]["count"] == len(_script())
        assert e.trace_events()["traceEvents"] == [
            {"name": "process_name", "ph": "M", "pid": 1, "tid": 0,
             "args": {"name": "localai-engine"}}]
    finally:
        e.shutdown()
    on = port_engine(tiny)
    try:
        assert _serve(on, "trace") == got
    finally:
        on.shutdown()


def test_kv_audit_off_builds_nothing(tiny, served):  # noqa: F811
    _e, _je, want, _w, _tag = served
    e = port_engine(tiny, kv_audit="off")
    try:
        assert e._kv_audit is None and e._pool.audit is None
        assert e._pcache.audit is None and e._hstore.audit is None
        got = _serve(e, "auditoff")
        assert {k: v["ids"] for k, v in got.items()} == \
            {k: v["ids"] for k, v in want.items()}
        assert "kv_audit" not in e.metrics()
        assert e.kv_debug() == {"mode": "off", "replica": 0}
        assert e.kv_audit_sweep()["mode"] == "off"
    finally:
        e.shutdown()
    c = port_engine(tiny, config="contig")        # no pages: no auditor
    try:
        assert c._kv_audit is None and c.kv_debug()["mode"] == "off"
    finally:
        c.shutdown()


def _idle(e):
    t_end = time.monotonic() + 60
    while e._fifo:
        assert time.monotonic() < t_end
        time.sleep(0.005)


def test_stall_writes_a_ring_dump_on_both(tiny, tmp_path):  # noqa: F811
    for name, eng in (("port", port_engine(tiny)), ("jax", jax_engine(tiny))):
        faults = FAULTS if name == "port" else JFAULTS
        d = str(tmp_path / name)
        try:
            drain(submit(eng, [9] * 5, 8))
            eng.ecfg.dispatch_stall_ms = 200
            eng.ecfg.stall_dump_dir = d
            if name == "port":
                eng._flight.out_dir = d
            _idle(eng)
            faults.arm("sync_delay_ms", "1500", count=1)
            res = drain(submit(eng, [9] * 5, 8, rid=f"stall-{name}"))
            assert res["errors"] == ["stall"]
            lc = eng.metrics()["lifecycle"]
            assert lc["stalls"] == 1 and lc["stall_dumps"] == 1, name
            dumps = glob.glob(os.path.join(d, "localai-stall-*.trace.json"))
            assert len(dumps) == 1, name
            with open(dumps[0]) as f:
                trace = json.load(f)
            assert any(ev["ph"] == "X" for ev in trace["traceEvents"])
            if name == "jax":
                time.sleep(1.6)              # its sync worker is still asleep
        finally:
            eng.shutdown()
    flights = glob.glob(os.path.join(tmp_path / "port", "localai-flight-stall-*"))
    assert len(flights) == 1
    with open(flights[0]) as f:
        bundle = json.load(f)
    assert set(bundle) >= {"reason", "trace", "state", "events", "requests"}
    assert bundle["requests"] == ["stall-port"]
    evs = [ev["event"] for ev in TEVENTS.events()]
    assert "stall_dump" in evs and "flight_dump" in evs


def test_emitter_wedge_replaced_on_both(tiny):  # noqa: F811
    """tests/test_emitter.py's case on both engines: the worker sleeps
    2.5 s on one item (200 ms budget); the watchdog fails the stream with
    "stall" and builds a fresh worker, which serves the next request."""
    for name, eng in (("port", port_engine(tiny)), ("jax", jax_engine(tiny))):
        faults = FAULTS if name == "port" else JFAULTS
        try:
            base = drain(submit(eng, [4] * 6, 24))["ids"]   # shapes warm
            em0 = eng._emitter
            eng.ecfg.dispatch_stall_ms = 200
            faults.arm("emitter_wedge_ms", "2500", count=1)
            t0 = time.monotonic()
            res = drain(submit(eng, [4] * 6, 24, rid=f"wedge-{name}"))
            assert res["errors"] == ["stall"], (name, res)
            deadline = time.monotonic() + 10
            while eng._emitter is em0 and time.monotonic() < deadline:
                time.sleep(0.01)
            assert eng._emitter is not em0, name
            assert eng.metrics()["lifecycle"]["stalls"] >= 1
            assert faults.fired.get("emitter_wedge_ms") == 1
            eng.ecfg.dispatch_stall_ms = 30000
            time.sleep(max(0.0, 2.7 - (time.monotonic() - t0)))
            assert drain(submit(eng, [4] * 6, 24))["ids"] == base
        finally:
            eng.shutdown()
    assert "emitter_wedge" in [ev["event"] for ev in TEVENTS.events()]
    assert "emitter_wedge" in [ev["event"] for ev in JEVENTS.events()]


def _families(text: str) -> dict:
    """{sample line's name + labels: value} of a Prometheus text, the
    exemplar suffix kept with its line."""
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        key, _, value = line.partition(" ") if "}" not in line else (
            line[:line.index("}") + 1], None, line[line.index("}") + 2:])
        out[key] = value
    return out


def test_metrics_parity_with_the_jax_route(served, monkeypatch):
    """The JAX /metrics code on a stub state whose one loaded model answers
    with the port engine's metrics() JSON renders every family the port
    renders from the same JSON, with the same labels and values."""
    import localai_tpu.api.localai_routes as jroutes

    e, _je, _g, _w, _t = served
    drain(submit(e, [3, 4, 5, 6], 6))     # a fresh exemplar for the pull
    stats = e.metrics()
    assert stats.get("hist_exemplars")
    blob = json.dumps(stats)

    jreg = jmet.Metrics()
    monkeypatch.setattr(jroutes, "METRICS", jreg)
    client = types.SimpleNamespace(get_metrics=lambda timeout=0: types.SimpleNamespace(
        prompt_json_for_slot=blob))
    loader = types.SimpleNamespace(
        stats=lambda: {}, list_loaded=lambda: ["tiny"],
        get=lambda name: types.SimpleNamespace(client=client))
    state = types.SimpleNamespace(caps=types.SimpleNamespace(loader=loader))
    jroutes._refresh_engine_metrics(state)
    want = _families(jreg.render())

    treg = tmet.Metrics()
    troutes.export_engine_metrics(treg, "tiny", json.loads(blob))
    got_text = treg.render()
    got = _families(got_text)
    assert len(got) > 80
    missing = {k: v for k, v in got.items() if want.get(k) != v}
    assert not missing, missing
    # the JAX-only families are the unported modules' (module doc of
    # api/localai_routes.py)
    extra = {k.split("{")[0] for k in want} - {k.split("{")[0] for k in got}
    assert extra <= {"localai_engine_replicas"}, extra
    for fam in ("localai_kv_audit_checks_total", "localai_ttft_seconds_bucket",
                "localai_spec_rounds_total", "localai_prefill_packed_dispatches_total",
                "localai_mem_peak_pool_pages_in_use", "localai_stall_dumps_total",
                "localai_kv_pool_pages", "localai_xla_compiles_total"):
        assert any(k.startswith(fam) for k in got), fam
    assert "# {trace_id=" in got_text


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return r.status, r.headers.get("Content-Type"), r.read().decode()


def test_routes_over_http(tiny):  # noqa: F811
    from localai_tpu_torch.api.app import App, make_server

    on = types.SimpleNamespace(engine=port_engine(tiny))
    off = types.SimpleNamespace(engine=port_engine(tiny, kv_audit="off"))
    app = App({"on": on, "off": off})
    server = make_server(app, "127.0.0.1", 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        drain(submit(on.engine, [5] * 20, 6, rid="route-1"))
        st, ct, text = _get(base + "/metrics")
        assert st == 200 and ct == tmet.CONTENT_TYPE
        assert ct.startswith("text/plain; version=0.0.4")
        assert 'localai_slots_in_flight{model="on"} 0' in text
        assert 'localai_kv_audit_checks_total{model="on"}' in text
        assert 'localai_kv_audit_checks_total{model="off"}' not in text
        st, _ct, body = _get(base + "/debug/events?last=2")
        evs = json.loads(body)
        assert evs["count"] == len(evs["events"]) <= 2
        assert all(ev["proc"] == "core" for ev in evs["events"])
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(base + "/debug/events?last=many")
        assert ei.value.code == 400
        kv = json.loads(_get(base + "/debug/kv")[2])["models"]
        assert kv["off"] == {"mode": "off", "replica": 0}
        assert kv["on"]["mode"] == "on" and "ledger_tail" in kv["on"]
        state = json.loads(_get(base + "/debug/state")[2])
        assert set(state["models"]) == {"on", "off"} and "eventlog" in state
        trace = json.loads(_get(base + "/debug/trace")[2])
        procs = {ev["pid"]: ev["args"]["name"] for ev in trace["traceEvents"]
                 if ev["name"] == "process_name"}
        assert procs[0] == "localai-http"
        assert set(procs.values()) >= {"localai-engine:on", "localai-engine:off"}
        assert any(ev.get("args", {}).get("request_id") == "route-1"
                   for ev in trace["traceEvents"] if ev["name"] == "request")
        assert set(trace["localai"]["clocks"]) == {"on", "off"}
        # the middleware observed the earlier requests under their routes
        text = _get(base + "/metrics")[2]
        assert 'localai_api_call_count{method="GET",path="/debug/kv"}' in text
    finally:
        server.shutdown()
        server.server_close()
        app.shutdown()


@pytest.mark.parametrize("knobs,match", [
    ({"kv_audit": "loud"}, "kv_audit"),
    ({"peak_tflops": -1}, "peak_tflops"),
    ({"peak_tflops": "fast"}, "peak_tflops"),
    ({"trace_ring_size": -4}, "trace_ring_size"),
    ({"slow_request_ms": "1.5"}, "slow_request_ms"),
    ({"event_log_max_mb": -1}, "event_log_max_mb"),
    ({"trace": "maybe"}, "trace"),
])
def test_runner_refuses_bad_knobs_before_loading(tmp_path, knobs, match):
    from localai_tpu_torch.backend.runner import load_model

    # no config.json: a knob check that came after the load would fail on
    # the missing file instead
    with pytest.raises(ValueError, match=match):
        load_model(str(tmp_path), "t", device="cpu", **knobs)


def test_runner_and_cli_take_the_knobs(tmp_path):
    from localai_tpu_torch import cli
    from localai_tpu_torch.backend.runner import load_model

    (tmp_path / "config.json").write_text(json.dumps({
        "vocab_size": 300, "hidden_size": 32, "intermediate_size": 64,
        "num_hidden_layers": 1, "num_attention_heads": 2,
        "num_key_value_heads": 1}))
    lm = load_model(str(tmp_path), "t", num_slots=2, context_size=64,
                    dtype="float32", random_weights=0, device="cpu",
                    trace="0", trace_ring_size="64", slow_request_ms="5",
                    stall_dump_dir=str(tmp_path), event_log="",
                    event_log_max_mb="0", peak_tflops="12.5", kv_audit="strict")
    try:
        c = lm.engine.ecfg
        assert (c.trace, c.trace_ring_size, c.slow_request_ms, c.event_log_max_mb,
                c.peak_tflops, c.kv_audit) == (False, 64, 5, 0, 12.5, "strict")
        assert not lm.engine.tracer.enabled
        assert lm.engine._goodput.peak_flops == 12.5e12
        assert lm.engine._kv_audit.mode == "strict"
    finally:
        lm.engine.shutdown()
    args = cli.build_parser().parse_args(
        ["run", "--model", "m", "--trace", "0", "--trace-ring-size", "8",
         "--slow-request-ms", "3", "--stall-dump-dir", "/x", "--event-log",
         "stderr", "--event-log-max-mb", "2", "--peak-tflops", "989",
         "--kv-audit", "off"])
    assert (args.trace, args.trace_ring_size, args.slow_request_ms,
            args.stall_dump_dir, args.event_log, args.event_log_max_mb,
            args.peak_tflops, args.kv_audit) == ("0", 8, 3, "/x", "stderr", 2,
                                                 989.0, "off")
    d = cli.build_parser().parse_args(["run", "--model", "m"])
    assert (d.trace, d.trace_ring_size, d.kv_audit, d.event_log_max_mb) == \
        ("1", 4096, "on", 64)


def test_load_model_keeps_the_served_name(tmp_path):
    """The served name is the one asked for (an option loop once reused
    the parameter's name as its variable and served "emitter")."""
    from localai_tpu_torch.backend.runner import load_model

    (tmp_path / "config.json").write_text(json.dumps({
        "vocab_size": 300, "hidden_size": 32, "intermediate_size": 64,
        "num_hidden_layers": 1, "num_attention_heads": 2,
        "num_key_value_heads": 1}))
    lm = load_model(str(tmp_path), "my-model", num_slots=2, context_size=64,
                    dtype="float32", random_weights=0, device="cpu",
                    emitter="1", preempt="1", trace="1")
    try:
        assert lm.name == "my-model"
    finally:
        lm.engine.shutdown()
