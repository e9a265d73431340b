"""The port's emitter thread (engine/emitter.py, ``EngineConfig.emitter``,
on by default as in the JAX engine) on the CPU, the counterparts of the
JAX package's tests/test_emitter.py over the f32 model of its spec tests:

  * greedy streams with the emitter on equal those with it off (the inline
    path) and the JAX Engine's: ids, text, finish, completion_tokens;
  * concurrent streams through the one worker: each equals its solo run,
    with completion counts in order (per-slot FIFO);
  * a stop sequence found by the worker after the engine dispatched more
    work, in plain bursts and inside a spec round: the inline path's text
    and counts, the slot released by the note, and the rows the slot
    keeps the inline path's (``committed`` never passes the stop; the loop
    driven tick by tick, the worker drained between ticks, so the note
    lands while the slot is held);
  * cancel mid-stream: the sentinel arrives after the queued tokens;
  * a dispatch-stall abort closes the stream through the worker's queue;
  * a wedged worker (its batch processing blocked from the test) is found
    by the watchdog and replaced; its streams get a "stall" error;
  * the worker's own failure closes its stream with an error and the note
    releases the slot;
  * ``metrics()["emitter"]``, the runner option and the CLI flag.
"""

from __future__ import annotations

import tests.torch_cpu  # noqa: F401  (one torch CPU thread)

import threading
import time

import pytest

from localai_tpu.engine import engine as jeng
from localai_tpu.engine import sampling as jsamp
from localai_tpu_torch.engine import engine as teng
from localai_tpu_torch.engine import sampling as tsamp
from localai_tpu_torch.services.faults import FAULTS
from tests.conftest import ByteTokenizer
from tests.test_torch_spec_sampled import _cfg_models

EC = dict(num_slots=4, max_context=96, prefill_buckets=(16, 64), prefill_chunk=64)


@pytest.fixture(scope="module")
def models():
    return _cfg_models()


class _Letters:
    """One letter per token id, so a text offset is a token index."""
    eos_token_id = 1

    def decode(self, ids, **kw):
        return "".join(chr(97 + (i % 26)) for i in ids)


def _port(models, start=True, tok=None, **kw):
    _jc, _jp, tcfg, tparams = models
    e = teng.Engine(tcfg, tparams, tok or ByteTokenizer(),
                    teng.EngineConfig(**{**EC, **kw}), device="cpu")
    return e.start() if start else e


@pytest.fixture(scope="module")
def on(models):
    e = _port(models)
    assert e._emitter is not None
    yield e
    e.shutdown()


def _req(e, prompt, n, **kw):
    mod, samp = (teng, tsamp) if isinstance(e, teng.Engine) else (jeng, jsamp)
    return mod.GenRequest(prompt_ids=ByteTokenizer().encode(prompt),
                          params=samp.SamplingParamsHost(temperature=0.0),
                          max_new_tokens=n, ignore_eos=True, **kw)


def _ids(evs):
    return [t for ev in evs for t in (ev.token_ids or [ev.token_id]) if t >= 0]


def _summary(e, prompt, n, **kw):
    text, evs = e.generate_text(_req(e, prompt, n, **kw))
    return text, _ids(evs), evs[-1].finish_reason, evs[-1].completion_tokens


CASES = (("hello", 8, {}), ("parity", 12, {}), ("abab abab ab", 30, {}),
         ("the cat sat on the mat", 40, {"stop_sequences": ["mat"]}))


def test_greedy_bytes_equal_inline_and_jax(on, models):
    jcfg, jparams, _tc, _tp = models
    import jax.numpy as jnp
    off = _port(models, emitter=False)
    je = jeng.Engine(jcfg, jparams, ByteTokenizer(),
                     jeng.EngineConfig(**EC, cache_dtype=jnp.float32))
    je.start()
    try:
        assert off._emitter is None
        for prompt, n, kw in CASES:
            got = _summary(on, prompt, n, **kw)
            assert got == _summary(off, prompt, n, **kw), prompt
            assert got == _summary(je, prompt, n, **kw), prompt
        assert on.metrics()["spec"]["rounds"] > 0
    finally:
        off.shutdown()
        je.shutdown()


def test_per_slot_fifo_ordering_interleaved(on):
    jobs = (("aaaa", 6), ("bbbb", 9), ("cccc", 4), ("dddd", 7))
    solo = {p: _ids(list(on.generate(_req(on, p, n)))) for p, n in jobs}
    results = {}

    def worker(prompt, n):
        results[prompt] = list(on.generate(_req(on, prompt, n)))

    threads = [threading.Thread(target=worker, args=j) for j in jobs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for p, evs in results.items():
        assert _ids(evs) == solo[p]
        counts = [ev.completion_tokens for ev in evs]
        assert counts == sorted(counts)
        assert evs[-1].finish_reason == "length"


def _tick_driven(e, req):
    """Serve ``req`` on an unstarted engine, the loop driven tick by tick
    from here, the worker drained between ticks (a stop note is then
    applied at the next tick, while the slot is still held)."""
    out = e.submit(req)
    for _ in range(10_000):
        busy = e._tick()
        if e._emitter is not None:
            e._emitter.drain()
        if not busy and not e._fifo and e.num_active == 0:
            break
    evs = []
    while (ev := out.get_nowait()) is not None:
        evs.append(ev)
    return evs


@pytest.mark.parametrize("draft", ("0", "auto"))
def test_stop_found_by_the_worker_keeps_the_inline_rows(models, draft):
    """A stop several bursts deep (draft "0": plain bursts of 4) or inside
    a spec round (draft "auto", a repetitive prompt), completing on token
    15 (one letter per token): the worker cuts the text as the inline
    path does, the note releases the slot, the rest of that burst or
    round and the later ones in flight are dropped, and the slot keeps
    the inline path's rows."""
    prompt = "abcabcabcabc abcabc" if draft == "auto" else "hello"
    e = _port(models, tok=_Letters(), emitter=False, draft=draft, decode_burst=4)
    try:
        free = _summary(e, prompt, 40)
    finally:
        e.shutdown()
    n = 2
    while free[0][15 - n:15] in free[0][:14]:
        n += 1                   # a stop that completes only on token 15
    stop = free[0][15 - n:15]
    res = {}
    for emitter in (False, True):
        e = _port(models, tok=_Letters(), start=False, emitter=emitter,
                  draft=draft, decode_burst=4)
        evs = _tick_driven(e, _req(e, prompt, 80, stop_sequences=[stop]))
        res[emitter] = ("".join(ev.text for ev in evs), evs[-1].finish_reason,
                        evs[-1].completion_tokens, list(e._cache_tokens),
                        e.metrics())
        e.shutdown()
    (t_off, f_off, c_off, rows_off, _m), (t_on, f_on, c_on, rows_on, m) = \
        res[False], res[True]
    assert t_on == t_off == free[0][:15 - n]
    assert f_on == f_off == "stop" and c_on == c_off == 15
    assert rows_on == rows_off
    assert m["active_slots"] == 0 and m["pages_in_use"] == 0
    assert m["pipeline"]["dropped_steps"] > 0
    if draft == "auto":
        assert m["spec"]["rounds"] > 0 and m["spec"]["accepted"] > 0


def test_stop_across_burst_boundaries_releases_the_slot(on):
    full, *_ = _summary(on, "hello", 16)
    stop = full[3:5]
    text2, _ids2, fin, _n = _summary(on, "hello", 16, stop_sequences=[stop])
    assert fin == "stop" and text2 == full[:full.find(stop)]
    deadline = time.monotonic() + 10
    while on.num_active and time.monotonic() < deadline:
        time.sleep(0.01)
    assert on.num_active == 0


def test_cancellation_mid_drain(on):
    req = _req(on, "cancelme", 4096)
    out = on.submit(req)
    got = [out.get(timeout=30) for _ in range(2)]
    assert None not in got
    on.cancel(req.request_id)
    while (ev := out.get(timeout=30)) is not None:
        got.append(ev)
    counts = [ev.completion_tokens for ev in got]
    assert counts == sorted(counts)
    assert _summary(on, "after", 4)[2] == "length"


def test_stall_abort_reaches_queued_tokens(on):
    on.ecfg.dispatch_stall_ms = 200
    FAULTS.arm("sync_delay_ms", "1500", count=1)
    try:
        evs = list(on.generate(_req(on, "st", 8)))
        assert evs[-1].error_kind == "stall" and "stalled" in evs[-1].error
        counts = [ev.completion_tokens for ev in evs if ev.error_kind is None]
        assert counts == sorted(counts)
        time.sleep(1.6)          # the delayed item lands
        assert _summary(on, "st", 8)[2] == "length"
    finally:
        on.ecfg.dispatch_stall_ms = 30000
        FAULTS.reset()


def test_wedged_worker_is_replaced(on):
    """The worker blocks inside its batch processing (patched here, the
    port has no fault hook for it): past dispatch_stall_ms the watchdog
    takes its queue over, fails the streams with a "stall" error and
    starts a fresh worker, which serves the next request."""
    old = on._emitter
    release = threading.Event()
    process = old._process_batch

    def stuck(entries):
        release.wait(timeout=30)
        process(entries)

    old._process_batch = stuck
    stalls = on.metrics()["lifecycle"]["stalls"]
    on.ecfg.dispatch_stall_ms = 200
    try:
        out = on.submit(_req(on, "wedge", 64))
        last = None
        while (ev := out.get(timeout=30)) is not None:
            last = ev
        assert last.error_kind == "stall" and "emitter wedged" in last.error
        deadline = time.monotonic() + 10
        while on._emitter is old and time.monotonic() < deadline:
            time.sleep(0.01)
        assert on._emitter is not old
        assert on.metrics()["lifecycle"]["stalls"] > stalls
        assert on.metrics()["emitter"]["alive"] is True
    finally:
        on.ecfg.dispatch_stall_ms = 30000
        release.set()
    text, ids, fin, n = _summary(on, "fresh", 6)
    assert fin == "length" and n == 6 and ids


def test_a_failed_item_closes_its_stream_and_frees_the_slot(models):
    """The worker's own failure (its detokenizer raising): the stream ends
    with an error event, the abort note releases the slot, the engine
    keeps serving."""
    e = _port(models)
    try:
        e.tokenizer = _Raising(e.tokenizer)
        evs = list(e.generate(_req(e, "boom", 12)))
        assert evs[-1].error and "detok" in evs[-1].error
        deadline = time.monotonic() + 10
        while e.num_active and time.monotonic() < deadline:
            time.sleep(0.01)
        assert e.num_active == 0
        e.tokenizer = e.tokenizer.inner
        assert _summary(e, "fine", 5)[2] == "length"
    finally:
        e.shutdown()


class _Raising:
    def __init__(self, inner):
        self.inner = inner
        self.eos_token_id = inner.eos_token_id

    def decode(self, ids, **kw):
        raise RuntimeError("detok failed")


def test_emitter_metrics_runner_and_cli(on, tmp_path):
    _summary(on, "m", 4)
    m = on.metrics()["emitter"]
    assert m["enabled"] is True and m["alive"] is True and m["emitted"] > 0
    assert m["queued"] == 0
    import json

    from localai_tpu_torch import cli
    from localai_tpu_torch.backend.runner import load_model

    (tmp_path / "config.json").write_text(json.dumps({
        "vocab_size": 300, "hidden_size": 32, "intermediate_size": 64,
        "num_hidden_layers": 1, "num_attention_heads": 2,
        "num_key_value_heads": 1}))
    for value, want in (("0", False), ("off", False), ("1", True), (True, True)):
        lm = load_model(str(tmp_path), "t", num_slots=2, context_size=64,
                        dtype="float32", random_weights=0, device="cpu",
                        emitter=value)
        try:
            assert lm.engine.metrics()["emitter"]["enabled"] is want
        finally:
            lm.engine.shutdown()
    with pytest.raises(ValueError, match="emitter"):
        load_model(str(tmp_path), "t", device="cpu", random_weights=0,
                   emitter="maybe")
    args = cli.build_parser().parse_args(
        ["run", "--model", "m", "--name", "n", "--emitter", "0"])
    assert args.emitter == "0"
