"""Admission control, deadlines and the dispatch-stall watchdog in the
PyTorch port (engine/engine.py, engine/transfer.py::Fetch.wait,
services/faults.py, services/errors.py, backend/runner.py, api/app.py)
against the JAX Engine, on the CPU, over the tiny f32 checkpoint: the
cases of tests/test_chaos.py.

  * a full queue sheds at the door with a structured "shed" event and a
    retry-after hint, in well under 50 ms, without the loop running; the
    same event as the JAX Engine's; the bound holds for 64 racing
    submits;
  * a queued request past request_timeout_ms gets a "timeout" event while
    the running one keeps the JAX tokens;
  * a request queued longer than max_queue_wait_ms is shed while the
    running one keeps its tokens (the running request is admitted before
    the knob is set, so the case holds on a loaded host too);
  * a running request past its deadline gets a "timeout" event and its
    slot and pages are released;
  * the stall watchdog, through sync_delay_ms: the stalled pack's request
    alone gets a "stall" event (its delay is far past the bound, so no
    load lets it land first), a request prefilling beside it keeps the
    JAX tokens, and the engine serves on; the JAX Engine's own case beside
    it; the wait is bounded by dispatch_stall_ms;
  * page_alloc_fail gives an "injected" error, then the engine recovers
    with the same tokens, on both engines;
  * the lifecycle knobs armed but not tripped do not change the tokens;
  * through the port's HTTP server: shed -> 429 with Retry-After, deadline
    -> 504, stall -> 503 with Retry-After, streamed and not, in the JAX
    server's error envelope.
"""

from __future__ import annotations

import tests.torch_cpu  # noqa: F401  (one torch CPU thread)

import json
import threading
import time
import urllib.error
import urllib.request

import pytest

from localai_tpu.services.faults import FAULTS as JFAULTS
from localai_tpu_torch.engine.transfer import Fetch, Stalled
from localai_tpu_torch.services.faults import FAULTS
from tests.test_torch_prefix_cache import tiny  # noqa: F401  (fixture)
from tests.test_torch_scheduler import (_drain, _ids, _req, _started,
                                        jax_engine, port_engine)


@pytest.fixture(autouse=True)
def _clean_faults():
    FAULTS.reset()
    JFAULTS.reset()
    yield
    FAULTS.reset()
    JFAULTS.reset()


def _both(tiny, **kw):  # noqa: F811
    return (("port", port_engine(tiny, **kw)), ("jax", jax_engine(tiny, **kw)))


def _idle(e):
    """Wait until nothing is in flight: a burst dispatched behind a
    finished request must not be the item a fault armed next hits."""
    t_end = time.monotonic() + 60
    while e._fifo:
        assert time.monotonic() < t_end, "the engine did not go idle"
        time.sleep(0.005)


# ---------- admission control ----------

def test_admission_shed_fast_and_structured(tiny):  # noqa: F811
    got = {}
    for name, e in _both(tiny, max_queued_requests=1):
        e.submit(_req(e, [5, 6, 7], 8))                 # parks in the queue
        t0 = time.monotonic()
        out = e.submit(_req(e, [8, 9], 8))
        ev = out.get(timeout=1.0)
        dt_ms = (time.monotonic() - t0) * 1e3
        assert out.get(timeout=1.0) is None             # the stream closes
        assert dt_ms < 50.0
        got[name] = (ev.error_kind, ev.error, ev.retry_after_s, ev.finish_reason,
                     e.metrics()["lifecycle"]["requests_shed"])
        e.shutdown()
    assert got["port"] == got["jax"]
    assert got["port"][0] == "shed" and "overloaded" in got["port"][1]
    assert got["port"][2] >= 1.0 and got["port"][4] == 1


def test_queue_bound_holds_for_racing_submits(tiny):  # noqa: F811
    """64 threads submit at once to an unstarted engine with a queue of
    8, each descheduled between reading the queue's depth and acting on
    it (a 1 ms sleep after qsize) and the interpreter switching threads
    every 10 us: exactly 8 queue and 56 are shed (the bound's check and
    put are one step)."""
    import sys

    e = port_engine(tiny, max_queued_requests=8)
    qsize = e._queue.qsize

    def slow_qsize():
        n = qsize()
        time.sleep(1e-3)
        return n

    e._queue.qsize = slow_qsize
    outs, start = [], threading.Barrier(64)

    def go(i):
        start.wait(timeout=30)
        outs.append(e.submit(_req(e, [5, i % 200 + 2], 4)))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=go, args=(i,)) for i in range(64)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and len(outs) == 64
    shed = [o for o in outs if not o.empty()]
    assert len(shed) == 56 and e._queue.qsize() == 8
    assert all(o.get_nowait().error_kind == "shed" for o in shed)
    assert e.metrics()["lifecycle"]["requests_shed"] == 56
    e.shutdown()


def _run_beside(e, a_prompt, a_n, set_knob, b_prompt):
    """A decodes alone (admitted, its first token read); then ``set_knob``
    arms a bound and B is submitted behind it. Returns (A's ids, B's
    events)."""
    out_a = e.submit(_req(e, a_prompt, a_n))
    first = out_a.get(timeout=300)
    set_knob(e)
    b, bevs = _drain(e.submit(_req(e, b_prompt, 24)), timeout=60)
    a, aevs = _drain(out_a, first)
    assert not any(ev.error for ev in aevs)
    return a, bevs


def test_request_timeout_reaps_queued_survivor_unaffected(tiny):  # noqa: F811
    got = {}
    for name, e in _both(tiny):
        _started(e)
        try:
            base = _ids(e, [3] * 12, 120)
            a, bevs = _run_beside(
                e, [3] * 12, 120,
                lambda e: setattr(e.ecfg, "request_timeout_ms", 1), [4] * 9)
            e.ecfg.request_timeout_ms = 0
            assert [ev.error_kind for ev in bevs] == ["timeout"]
            assert "deadline exceeded" in bevs[0].error
            assert a == base
            assert e.metrics()["lifecycle"]["requests_timed_out"] == 1
        finally:
            e.shutdown()
        got[name] = a
    assert got["port"] == got["jax"]


def test_queue_wait_shed_survivor_unaffected(tiny):  # noqa: F811
    """B waits behind A past the 1 ms bound and is shed at the next
    admission tick, while A (~119 tokens to go) runs; A, admitted before
    the knob was set, keeps its tokens. (The JAX test sets the knob before
    A is admitted, so A can be shed too on a loaded host.)"""
    got = {}
    for name, e in _both(tiny):
        _started(e)
        try:
            base = _ids(e, [3] * 12, 120)
            a, bevs = _run_beside(
                e, [3] * 12, 120,
                lambda e: setattr(e.ecfg, "max_queue_wait_ms", 1), [4] * 9)
            e.ecfg.max_queue_wait_ms = 0
            assert [ev.error_kind for ev in bevs] == ["shed"]
            assert "max_queue_wait_ms" in bevs[0].error
            assert a == base
        finally:
            e.shutdown()
        got[name] = a
    assert got["port"] == got["jax"]


def test_running_request_deadline_releases_its_slot(tiny):  # noqa: F811
    """A running request whose deadline passes (moved to now once its
    first token is out) gets a "timeout" event at the next tick and the
    cancel path frees its slot and pages."""
    e = _started(port_engine(tiny, request_timeout_ms=60000))
    try:
        req = _req(e, [3] * 12, 80)
        out = e.submit(req)
        first = out.get(timeout=300)
        req.deadline = time.monotonic()
        ids, evs = _drain(out, first)
        assert evs[-1].error_kind == "timeout" and 0 < len(ids) < 80
        m = e.metrics()
        assert m["lifecycle"]["requests_timed_out"] == 1
        assert m["active_slots"] == 0 and m["pages_in_use"] == 0
        assert not e._cancelled
        assert len(_ids(e, [3] * 12, 8)) == 8            # the slot serves on
    finally:
        e.shutdown()


# ---------- the stall watchdog ----------

def test_fetch_wait_is_bounded():
    import torch

    f = Fetch(torch.zeros(3))
    f.t_due = time.monotonic() + 5.0                     # lands 5 s late
    t0 = time.monotonic()
    with pytest.raises(Stalled):
        f.wait(since=t0, stall_s=0.1)
    assert time.monotonic() - t0 < 1.0
    f.t_due = time.monotonic() + 0.05
    assert f.wait(since=time.monotonic(), stall_s=1.0).tolist() == [0, 0, 0]
    f.err = RuntimeError("injected fault: sync_fail")
    with pytest.raises(RuntimeError, match="sync_fail"):
        f.wait()


def test_stall_aborts_only_the_stalled_request(tiny):  # noqa: F811
    """The first pack after the fault is armed lands 600 s late, so the
    watchdog (200 ms bound) aborts it first, however long the loaded host's
    eager packs take: its final request V alone gets a "stall" event
    within the bound (the loop holds the pack to it while it packs S's
    later chunks); S, whose long prompt was prefilling in that pack, keeps
    the JAX Engine's tokens; afterwards a new request gets the same tokens
    as before the stall."""
    survivor = list(range(30, 80))                       # 4 chunks
    je = _started(jax_engine(tiny, num_slots=2))
    try:
        want_s = _ids(je, survivor, 12)
    finally:
        je.shutdown()
    e = _started(port_engine(tiny, num_slots=2, decode_burst=16))
    try:
        base = _ids(e, [7] * 9, 8)
        e.ecfg.dispatch_stall_ms = 200
        _idle(e)
        FAULTS.arm("sync_delay_ms", "600000", count=1)
        e._admit = lambda: False                         # V and S together
        out_v = e.submit(_req(e, [7] * 9, 8))
        out_s = e.submit(_req(e, survivor, 12))
        del e._admit
        e._wake.set()
        t0 = time.monotonic()
        v, vevs = _drain(out_v)
        abort_s = time.monotonic() - t0
        s, sevs = _drain(out_s)
        assert [ev.error_kind for ev in vevs] == ["stall"] and v == []
        assert "stalled" in vevs[0].error
        assert 0.15 <= abort_s < 1.4                     # the bound, not the load
        assert not any(ev.error for ev in sevs) and s == want_s
        assert e.metrics()["lifecycle"]["stalls"] == 1
        assert _ids(e, [7] * 9, 8) == base
        assert e.metrics()["active_slots"] == 0 and e.metrics()["pages_in_use"] == 0
    finally:
        e.shutdown()


def test_stall_watchdog_jax_and_port_single_request(tiny, tmp_path):  # noqa: F811
    """tests/test_chaos.py's case on both engines: the lone request stalls,
    the engine serves on with the same tokens."""
    for name, e in _both(tiny):
        _started(e)
        faults = FAULTS if name == "port" else JFAULTS
        try:
            base = _ids(e, [9] * 5, 8)
            e.ecfg.dispatch_stall_ms = 200
            if name == "jax":
                e.ecfg.stall_dump_dir = str(tmp_path)
            _idle(e)
            faults.arm("sync_delay_ms", "1500", count=1)
            _ids_, evs = _drain(e.submit(_req(e, [9] * 5, 8)))
            assert evs[-1].error_kind == "stall" and "stalled" in evs[-1].error
            assert e.metrics()["lifecycle"]["stalls"] >= 1
            if name == "jax":
                time.sleep(1.6)   # its sync worker is still asleep
            assert _ids(e, [9] * 5, 8) == base
        finally:
            e.shutdown()


def test_page_alloc_fault_structured_then_recovers(tiny):  # noqa: F811
    got = {}
    for name, e in _both(tiny):
        _started(e)
        faults = FAULTS if name == "port" else JFAULTS
        try:
            base = _ids(e, [11] * 6, 8)
            _idle(e)
            faults.arm("page_alloc_fail", count=1)
            _i, evs = _drain(e.submit(_req(e, [11] * 6, 8)))
            assert evs[-1].error and "injected" in evs[-1].error
            assert _ids(e, [11] * 6, 8) == base
        finally:
            e.shutdown()
        got[name] = base
    assert got["port"] == got["jax"]


def test_lifecycle_knobs_do_not_perturb_generation(tiny):  # noqa: F811
    knobs = dict(max_queued_requests=64, max_queue_wait_ms=60000,
                 request_timeout_ms=60000, dispatch_stall_ms=60000)
    got = []
    for e in (port_engine(tiny), port_engine(tiny, **knobs),
              jax_engine(tiny, **knobs)):
        _started(e)
        try:
            got.append(_ids(e, [13] * 7, 8))
        finally:
            e.shutdown()
    assert got[0] == got[1] == got[2]


# ---------- the HTTP shapes ----------

@pytest.fixture
def served(tmp_path):
    from tests.tinymodel import write_tiny_checkpoint

    from localai_tpu_torch.api.app import App, make_server
    from localai_tpu_torch.backend.runner import load_model

    d = str(tmp_path / "tiny")
    write_tiny_checkpoint(d)
    lm = load_model(d, "tiny", num_slots=1, context_size=256, dtype="float32",
                    device="cpu", kv_offload=False, max_queued_requests=1)
    app = App({"tiny": lm})
    server = make_server(app, "127.0.0.1", 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{server.server_address[1]}", lm
    server.shutdown()
    server.server_close()
    app.shutdown()


def _post(url, body):
    """(status, headers, parsed body or SSE text)."""
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, dict(r.headers), r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())


def test_http_429_504_503_shapes(served):
    from localai_tpu_torch.engine.engine import GenRequest
    from localai_tpu_torch.engine.sampling import SamplingParamsHost

    base, lm = served
    e = lm.engine
    chat = base + "/v1/chat/completions"
    body = {"model": "tiny", "messages": [{"role": "user", "content": "hi"}],
            "max_tokens": 4, "temperature": 0}
    hold = GenRequest(prompt_ids=lm.tokenizer.encode("hold the slot"),
                      max_new_tokens=200, ignore_eos=True,
                      params=SamplingParamsHost(temperature=0.0))
    out_hold = e.submit(hold)
    out_hold.get(timeout=120)                            # decoding
    qreq = GenRequest(prompt_ids=[5, 6], max_new_tokens=2)
    queued = e.submit(qreq)
    for stream in (False, True):
        status, headers, err = _post(chat, {**body, "stream": stream})
        assert status == 429, (status, err)
        assert int(headers["Retry-After"]) >= 1
        assert err["error"]["type"] == "overloaded" and err["error"]["code"] == 429
        assert err["error"]["retryable"] is True and "retry_after" in err["error"]
    e.cancel(qreq.request_id)
    assert queued.get(timeout=60) is None                # dropped, queue empty
    # a deadline that expires while queued behind the held slot -> 504
    e.ecfg.request_timeout_ms = 1
    for stream in (False, True):
        status, _h, err = _post(chat, {**body, "stream": stream})
        assert status == 504, (status, err)
        assert err["error"]["type"] == "deadline_exceeded"
    e.ecfg.request_timeout_ms = 0
    e.cancel(hold.request_id)
    _drain(out_hold)
    # a stalled pack -> 503 with the JAX server's Retry-After of 1 s
    e.ecfg.dispatch_stall_ms = 200
    for stream in (False, True):
        _idle(e)
        FAULTS.arm("sync_delay_ms", "1500", count=1)
        status, headers, err = _post(chat, {**body, "stream": stream})
        assert status == 503, (status, err)
        assert err["error"]["type"] == "backend_unavailable"
        assert headers["Retry-After"] == "1"
    status, _h, ok = _post(chat, body)
    assert status == 200 and json.loads(ok)["usage"]["completion_tokens"] == 4
    lc = e.metrics()["lifecycle"]
    assert (lc["requests_shed"], lc["requests_timed_out"], lc["stalls"]) == (2, 2, 2)
