"""The port's span tracer, event log and Prometheus registry against the
JAX package's (localai_tpu/services/tracing.py, eventlog.py, metrics.py):
the same calls, the same output.

Pins: RingTracer summaries (totals that survive wraparound, the
decomposition) and Chrome traces equal to the JAX ones for the same span
records, at a ring of 8 with wraparound and disabled; dump_ring's file
loads as the same trace; EventLog's ring, file sink, rotation at a tiny
max_mb and snapshot; Metrics.render text byte for byte, escaping and
exemplars included.
"""

from __future__ import annotations

import tests.torch_cpu  # noqa: F401  (one torch CPU thread)

import json
import os
import random

import pytest

from localai_tpu.services import eventlog as jev
from localai_tpu.services import metrics as jmet
from localai_tpu.services import tracing as jtr
from localai_tpu_torch.services import eventlog as tev
from localai_tpu_torch.services import metrics as tmet
from localai_tpu_torch.services import tracing as ttr

NAMES = ("queue_wait", "admission", "prefill_dispatch", "prefill_device",
         "finish_detect", "decode_burst_device", "emit", "stream_flush",
         "emit_bg", "stream_flush_bg", "request", "tick")
TRACKS = ("sched", "engine", "slot0", "slot1", "slot10", "emitter", "http")


def _span_script(n: int, seed: int = 0) -> list:
    rng = random.Random(seed)
    t = 1000.0
    out = []
    for i in range(n):
        t0 = t + rng.random() * 0.01
        t1 = t0 + rng.random() * 0.02
        args = ({"steps": rng.randint(1, 16)} if rng.random() < 0.5 else None)
        out.append((rng.choice(NAMES), rng.choice(TRACKS), t0, t1,
                    rng.choice(("", "r1", "r2")), args))
        t = t1
    return out


def _pair(size: int, enabled: bool = True):
    j = jtr.RingTracer(size, enabled=enabled)
    t = ttr.RingTracer(size, enabled=enabled)
    t.t0, t.t0_epoch = j.t0, j.t0_epoch      # the same epoch on both sides
    return j, t


@pytest.mark.parametrize("size,n", [(8, 5), (8, 8), (8, 29), (4096, 300)])
def test_ring_tracer_matches_jax(size, n):
    j, t = _pair(size)
    for rec in _span_script(n, seed=size + n):
        j.record(*rec)
        t.record(*rec)
    assert t.spans() == j.spans()
    assert t.summary() == j.summary()
    s = t.summary()
    assert s["spans_recorded"] == n and s["spans_dropped"] == max(0, n - size)
    jt, tt = jtr.chrome_trace(j), ttr.chrome_trace(t)
    assert tt == jt
    # the HTTP layer's pid / name, as /debug/trace renders it
    assert (ttr.chrome_trace(t, pid=0, process_name="localai-http")
            == jtr.chrome_trace(j, pid=0, process_name="localai-http"))


def test_disabled_tracer_records_nothing():
    j, t = _pair(8, enabled=False)
    for rec in _span_script(20):
        j.record(*rec)
        t.record(*rec)
    assert t.summary() == j.summary() == {"enabled": False}
    assert t.spans() == j.spans() == []
    z = ttr.RingTracer(0)                    # a ring of 0 is off too
    assert not z.enabled and z.summary() == {"enabled": False}


def test_reset_and_track_order():
    j, t = _pair(16)
    for rec in _span_script(10, seed=3):
        j.record(*rec)
        t.record(*rec)
    ev = ttr.chrome_trace(t)["traceEvents"]
    names = [e["args"]["name"] for e in ev if e["name"] == "thread_name"]
    assert names == sorted(names, key=ttr._track_order_key)
    assert ttr._track_order_key("sched") < ttr._track_order_key("engine") \
        < ttr._track_order_key("slot0") < ttr._track_order_key("slot1") \
        < ttr._track_order_key("slot10")
    t.reset()
    assert t.spans() == [] and t.summary()["spans_recorded"] == 0


def test_dump_ring_writes_the_same_trace(tmp_path):
    j, t = _pair(8)
    for rec in _span_script(12, seed=7):
        j.record(*rec)
        t.record(*rec)
    tp = ttr.dump_ring(t, str(tmp_path / "port"), tag="stall")
    jp = jtr.dump_ring(j, str(tmp_path / "jax"), tag="stall")
    assert os.path.basename(tp).startswith(f"localai-stall-{os.getpid()}-")
    assert tp.endswith(".trace.json")
    with open(tp) as f:
        got = json.load(f)
    with open(jp) as f:
        want = json.load(f)
    assert got == want == json.loads(json.dumps(jtr.chrome_trace(j)))


def test_frontend_tracer_env(monkeypatch):
    monkeypatch.setattr(ttr, "_frontend_tracer", None)
    monkeypatch.setenv("LOCALAI_TRACE", "off")
    assert not ttr.frontend_tracer().enabled
    monkeypatch.setattr(ttr, "_frontend_tracer", None)
    monkeypatch.setenv("LOCALAI_TRACE", "1")
    monkeypatch.setenv("LOCALAI_TRACE_RING_SIZE", "64")
    ft = ttr.frontend_tracer()
    assert ft.enabled and ft.size == 64 and ttr.frontend_tracer() is ft
    monkeypatch.setattr(ttr, "_frontend_tracer", None)


def _strip_ts(evs):
    return [{k: v for k, v in e.items() if k != "ts"} for e in evs]


def _event_script(log):
    log.emit("admit", rid="a", prompt_tokens=5, queued=0)
    log.emit("shed", rid="b", reason="full", queued=3, extra=None)
    log.emit("complete", rid="a", model="m", finish="stop",
             completion_tokens=4, e2e_ms=1.5)
    for i in range(6):
        log.emit("tick", n=i)


def test_event_log_ring_matches_jax(monkeypatch):
    monkeypatch.delenv("LOCALAI_EVENT_LOG", raising=False)
    j, t = jev.EventLog(ring_size=4), tev.EventLog(ring_size=4)
    _event_script(j)
    _event_script(t)
    assert _strip_ts(t.events()) == _strip_ts(j.events())
    assert _strip_ts(t.events(last=2)) == _strip_ts(j.events(last=2))
    assert t.snapshot() == j.snapshot() == {
        "sink": "off", "seq": 9, "ring": 4, "ring_size": 4, "rotations": 0}
    assert [e["seq"] for e in t.events()] == [6, 7, 8, 9]
    t.clear()
    assert t.events() == [] and t.snapshot()["seq"] == 9


def test_event_log_file_sink_and_rotation(tmp_path, monkeypatch):
    monkeypatch.delenv("LOCALAI_EVENT_LOG", raising=False)
    out = {}
    for side, mod in (("jax", jev), ("port", tev)):
        path = str(tmp_path / f"{side}.jsonl")
        log = mod.EventLog()
        log.configure(path, max_mb=0)
        _event_script(log)
        with open(path) as f:
            lines = [json.loads(x) for x in f]
        assert _strip_ts(lines) == _strip_ts(log.events(last=0)[-9:])
        # a tiny bound: 1 MiB, reached by ~1.1 MiB of events, one rotation
        rpath = str(tmp_path / f"{side}-rot.jsonl")
        log.configure(rpath, max_mb=1)
        for i in range(2200):
            log.emit("pad", blob="x" * 500, i=i)
        snap = log.snapshot()
        assert os.path.exists(rpath + ".1")
        assert os.path.getsize(rpath + ".1") >= 1 << 20
        assert os.path.getsize(rpath) < 1 << 20
        snap.pop("sink")
        out[side] = (snap, os.path.getsize(rpath + ".1") > 0)
        log.configure("off")
        assert log.sink == "off"
    assert out["port"] == out["jax"]
    assert out["port"][0]["rotations"] == 1


def test_event_log_stderr_and_unwritable(capsys, tmp_path, monkeypatch):
    monkeypatch.delenv("LOCALAI_EVENT_LOG", raising=False)
    log = tev.EventLog()
    log.configure("stderr")
    log.emit("admit", rid="z")
    assert '"event": "admit"' in capsys.readouterr().err
    log.configure(str(tmp_path / "no" / "such" / "dir" / "f.jsonl"))
    assert log.sink == "off"
    log.emit("admit", rid="y")               # never raises
    assert log.events()[-1]["rid"] == "y"


def _metric_script(m, mod):
    m.observe_api_call("POST", "/v1/chat/completions", 0.02)
    m.observe_api_call("POST", "/v1/chat/completions", 7.0)
    m.observe_api_call("GET", "/metrics", 500.0)
    m.inc("http_requests_shed_total")
    m.inc("http_requests_shed_total", mod.label_str(model='a"b\\c\nd'))
    lab = mod.label_str(model="tiny", state="free")
    m.set_gauge("kv_pool_pages", 12, lab)
    m.set_gauge("mfu", 0.123456789, mod.label_str(model="tiny"))
    m.set_counter("kv_audit_checks_total", 41.9, mod.label_str(model="tiny"))
    m.set_histogram("ttft_seconds", mod.label_str(model="tiny"),
                    (0.01, 0.1, 1.0), [1, 2, 3, 4], 5.5, 10)
    m.set_exemplar("ttft_seconds", mod.label_str(model="tiny"), 0.05,
                   "rid-1", 1700000000.25)
    m.observe_histogram("itl_seconds", 0.003, buckets=(0.001, 0.01))
    m.observe_histogram("itl_seconds", 5.0, buckets=(0.001, 0.01))
    m.set_exemplar("itl_seconds", "", 9.0, "rid-2")
    m.set_histogram("decode_burst_seconds", mod.label_str(model="x"),
                    (0.5,), [0, 1], 1.0, 1)
    m.set_exemplar("decode_burst_seconds", mod.label_str(model="x"), 0.25,
                   "rid-3", 0.0)


def test_metrics_render_matches_jax():
    assert tmet.CONTENT_TYPE == jmet.CONTENT_TYPE
    assert tmet.CONTENT_TYPE.startswith("text/plain; version=0.0.4")
    for v in ('a"b', "a\\b", "a\nb", "plain", 3):
        assert tmet.escape_label_value(v) == jmet.escape_label_value(v)
    assert (tmet.label_str(z="1", a='"') == jmet.label_str(z="1", a='"')
            == 'a="\\"",z="1"')
    j, t = jmet.Metrics(), tmet.Metrics()
    _metric_script(j, jmet)
    _metric_script(t, tmet)
    got = t.render()
    assert got == j.render()
    assert '# {trace_id="rid-1"} 0.05 1700000000.250' in got
    assert 'localai_itl_seconds_bucket{le="+Inf"} 2 # {trace_id="rid-2"} 9' in got
    assert 'model="a\\"b\\\\c\\nd"' in got
    t.clear_instrument("ttft_seconds")
    j.clear_instrument("ttft_seconds")
    assert t.render() == j.render()
    assert "ttft_seconds" not in t.render()
