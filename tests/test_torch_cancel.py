"""Cancellation in the PyTorch port's engine and HTTP server, on the CPU,
over the tiny f32 checkpoint (tests/tinymodel.py).

  * ``Engine.cancel`` on a running request frees its slot at the next
    burst boundary, long before max_tokens; its output queue ends with the
    None sentinel and the next request is admitted into that slot;
  * ``cancel`` on a queued request drops it unadmitted;
  * a streamed request whose client closes its socket after the first
    event is cancelled by the server: the slot frees long before
    max_tokens and the server logs no exception;
  * the JAX package's engine case (tests/test_engine.py,
    test_concurrent_admission_does_not_corrupt_chunked_prefill): a
    request's greedy tokens are the same whether the engine was idle or
    another request was decoding (and is then cancelled);
  * cancels from many threads while the engine reaps end every request
    and leave no slot, page or cancelled id behind.
"""

from __future__ import annotations

import tests.torch_cpu  # noqa: F401  (one torch CPU thread)

import json
import logging
import socket
import struct
import sys
import threading
import time

import pytest

from localai_tpu_torch.engine import engine as teng
from localai_tpu_torch.engine.sampling import SamplingParamsHost

GREEDY = SamplingParamsHost(temperature=0.0)


def _load(tmp_path, **knobs):
    from tests.tinymodel import write_tiny_checkpoint

    from localai_tpu_torch.backend.runner import load_model

    d = str(tmp_path / "tiny")
    write_tiny_checkpoint(d)
    return load_model(d, "tiny", dtype="float32", device="cpu", **knobs)


def _req(lm, text, n):
    return teng.GenRequest(prompt_ids=lm.tokenizer.encode(text), params=GREEDY,
                           max_new_tokens=n, ignore_eos=True)


def _drain(out, timeout=120):
    """Every event of an output queue up to (not including) its sentinel."""
    evs = []
    while True:
        ev = out.get(timeout=timeout)
        if ev is None:
            return evs
        evs.append(ev)


def _wait_idle(engine, timeout=60):
    t_end = time.monotonic() + timeout
    while engine.num_active and time.monotonic() < t_end:
        time.sleep(0.01)
    return engine.num_active == 0


def test_cancel_running_request_frees_its_slot(tmp_path):
    lm = _load(tmp_path, num_slots=1, context_size=512, decode_burst=4)
    e = lm.engine
    try:
        a = _req(lm, "a long generation", 400)
        out_a = e.submit(a)
        first = out_a.get(timeout=120)          # prefilled: A holds the slot
        assert first is not None and e.slots[0] is not None
        e.cancel(a.request_id)
        evs = [first] + _drain(out_a)           # ends with the sentinel
        n = evs[-1].completion_tokens
        assert n < 400 and all(ev.finish_reason is None for ev in evs)
        assert _wait_idle(e) and e.slots == [None]
        assert e.metrics()["pages_in_use"] == 0
        b = _req(lm, "next", 5)
        _text, bevs = e.generate_text(b)        # admitted into the freed slot
        assert bevs[-1].completion_tokens == 5 and bevs[-1].finish_reason == "length"
        assert not e._cancelled                 # nothing left over
    finally:
        e.shutdown()


def test_cancel_queued_request_drops_it_unadmitted(tmp_path):
    lm = _load(tmp_path, num_slots=1, context_size=512, decode_burst=4)
    e = lm.engine
    try:
        a = _req(lm, "holds the only slot", 400)
        out_a = e.submit(a)
        assert out_a.get(timeout=120) is not None   # A is decoding
        b = _req(lm, "queued behind it", 50)
        out_b = e.submit(b)
        e.cancel(b.request_id)
        # the scheduler's admission pass drops it while A still holds the
        # slot (the JAX engine's _admit_sched): only the sentinel, no event
        assert out_b.get(timeout=60) is None         # dropped, never admitted
        assert e.slots[0] is not None and e.slots[0].req is a
        e.cancel(a.request_id)
        _drain(out_a)
        assert _wait_idle(e)
        c = _req(lm, "after both", 3)
        _text, cevs = e.generate_text(c)
        assert cevs[-1].completion_tokens == 3
        assert not e._cancelled
    finally:
        e.shutdown()


def _stream_then_drop(port, path, body):
    """POST a streamed request over a raw socket, read up to the first SSE
    event, then reset the connection (SO_LINGER 0)."""
    data = json.dumps(body).encode()
    s = socket.create_connection(("127.0.0.1", port), timeout=120)
    s.sendall(f"POST {path} HTTP/1.1\r\nHost: 127.0.0.1\r\n"
              f"Content-Type: application/json\r\nContent-Length: {len(data)}"
              f"\r\n\r\n".encode() + data)
    got = b""
    while b"\r\n\r\ndata: " not in got or not got.endswith(b"\n\n"):
        chunk = s.recv(65536)
        assert chunk, got
        got += chunk
    s.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER, struct.pack("ii", 1, 0))
    s.close()
    return got


@pytest.mark.parametrize("path,body", [
    ("/v1/chat/completions",
     {"messages": [{"role": "user", "content": "talk for a long time"}]}),
    ("/v1/completions", {"prompt": "talk for a long time"}),
])
def test_disconnected_stream_is_cancelled(tmp_path, caplog, capsys, path, body):
    from localai_tpu_torch.api.app import App, make_server

    lm = _load(tmp_path, num_slots=2, context_size=1024, decode_burst=4)
    app = App({"tiny": lm})
    server = make_server(app, "127.0.0.1", 0)
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    max_tokens = 900
    try:
        with caplog.at_level(logging.INFO):
            head = _stream_then_drop(server.server_address[1], path, dict(
                body, model="tiny", stream=True, max_tokens=max_tokens,
                temperature=0, ignore_eos=True))
            assert b" 200 " in head.split(b"\r\n", 1)[0]
            assert _wait_idle(lm.engine, timeout=120)
            tokens = lm.engine.metrics()["decode"]["tokens"]
            assert tokens < max_tokens // 2, tokens
            deadline = time.monotonic() + 10
            while not any("disconnected" in r.getMessage() for r in caplog.records) \
                    and time.monotonic() < deadline:
                time.sleep(0.01)
        assert any("disconnected" in r.getMessage() for r in caplog.records)
        assert not [r for r in caplog.records if r.levelno >= logging.WARNING]
        assert "Traceback" not in capsys.readouterr().err
        assert not lm.engine._cancelled
    finally:
        server.shutdown()
        server.server_close()
        app.shutdown()


def test_cancel_leaves_another_requests_greedy_tokens_unchanged(tmp_path):
    """Port of the JAX package's concurrent-admission engine case: greedy
    tokens of a chunked-prefill request with the engine idle, and with
    another request decoding during its admission (then cancelled)."""
    prompt_b = "b" * 49
    lm = _load(tmp_path, num_slots=2, context_size=256, prefill_chunk=16,
               kv_page_size=16)
    e = lm.engine
    try:
        _t, ev_idle = e.generate_text(_req(lm, prompt_b, 6))
        a = _req(lm, "aaa", 300)
        out_a = e.submit(a)
        assert out_a.get(timeout=120) is not None    # A is decoding
        _t, ev_busy = e.generate_text(_req(lm, prompt_b, 6))
        e.cancel(a.request_id)
        _drain(out_a)
        assert _wait_idle(e)
    finally:
        e.shutdown()
    ids = lambda evs: [t for ev in evs for t in (ev.token_ids or [ev.token_id])]  # noqa: E731
    assert ids(ev_idle) == ids(ev_busy) and len(ids(ev_idle)) == 6


def test_concurrent_cancels_end_every_request(tmp_path):
    """Handler threads cancel while the engine thread reaps: more
    cancelling threads than slots, a short switch interval. Every request
    ends with its sentinel (cancelled or finished), no slot or page is
    left held and no cancelled id is left behind."""
    lm = _load(tmp_path, num_slots=2, context_size=256, decode_burst=2)
    e = lm.engine
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        reqs = [_req(lm, f"request {i}", 40 + i) for i in range(12)]
        outs = [e.submit(r) for r in reqs]

        def cancel(i):
            time.sleep(0.002 * (i % 5))
            e.cancel(reqs[i].request_id)

        threads = [threading.Thread(target=cancel, args=(i,)) for i in range(12) if i % 3]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        for i, out in enumerate(outs):
            evs = _drain(out, timeout=120)
            if i % 3 == 0:          # never cancelled: runs to max_tokens
                assert evs[-1].finish_reason == "length"
                assert evs[-1].completion_tokens == 40 + i
        assert _wait_idle(e)
        assert e.metrics()["pages_in_use"] == 0
        deadline = time.monotonic() + 10
        while e._cancelled and time.monotonic() < deadline:
            time.sleep(0.01)        # ids of requests that ended first go at the next reap
        assert not e._cancelled
    finally:
        sys.setswitchinterval(old)
        e.shutdown()
