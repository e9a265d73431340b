"""The preemptive priority scheduler in the PyTorch port
(localai_tpu_torch/engine/scheduler.py and its use in engine/engine.py)
against the JAX package's, on the CPU, over the tiny f32 checkpoint.

  * the pure functions (normalize_priority, parse_priority_weights, the
    DRR shares, burst_share, aged queue order, shed and preemption victims,
    the resume queue, stats) give the JAX module's results on the same
    seeded inputs, on a shared fake clock;
  * the JAX engine cases (tests/test_scheduler.py), on both engines: a
    high arrival preempts a low one and both streams complete with the
    unpreempted greedy tokens, the JAX Engine's; a resume after a
    re-prefill (prefix cache off) continues byte for byte as a fresh
    engine given the prompt + the tokens emitted before the pause; a
    resume splices the retained pages back, with resume_restore_rows and
    resume_reprefills equal to the JAX Engine's when both are driven tick
    by tick to the same preemption point; preempt=False restores FIFO; a
    full queue displaces the longest-queued lower-class request;
  * both engines pick the same victim for the same slots;
  * pool-pressure preemption in a small pool: a high request that finds
    the pool full pauses a low decode slot and every request completes
    with the large pool's tokens, where preempt=False (the port before the
    scheduler) fails them all. The JAX Engine resumes the paused request
    into the free slot at once and then fails every request (its
    PoolExhausted), so the port's resume waits until the pool can hold
    it (engine.py::_resume_fits; the module doc's departures);
  * a request cancelled while parked ends its stream and leaves nothing;
  * the packed-prefill DRR shares and the shrunken burst with two classes
    (the pure rule is held against JAX's above).
"""

from __future__ import annotations

import tests.torch_cpu  # noqa: F401  (one torch CPU thread)

import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest

from localai_tpu.engine import engine as jeng
from localai_tpu.engine import sampling as jsamp
from localai_tpu.engine import scheduler as jsch
from localai_tpu_torch.engine import engine as teng
from localai_tpu_torch.engine import sampling as tsamp
from localai_tpu_torch.engine import scheduler as tsch
from tests.test_torch_engine import _Tok
from tests.test_torch_prefix_cache import tiny  # noqa: F401  (fixture)

# the JAX scheduler tests' engine: one slot, context 96, bursts of 4
BASE = dict(num_slots=1, max_context=96, prefill_chunk=16, decode_burst=4,
            kv_page_size=16)


def port_engine(tiny, **kw):  # noqa: F811
    _jc, _jp, tcfg, tparams = tiny
    return teng.Engine(tcfg, tparams, _Tok(),
                       teng.EngineConfig(**{**BASE, "draft": "0", **kw}),
                       device="cpu")


def jax_engine(tiny, **kw):  # noqa: F811
    jcfg, jparams, _tc, _tp = tiny
    return jeng.Engine(jcfg, jparams, _Tok(), jeng.EngineConfig(
        **{**BASE, **kw}, prefill_buckets=(16,), cache_dtype=jnp.float32,
        draft="0"))


def _started(e):
    e.start()          # the JAX Engine's start returns None
    return e


def _req(e, prompt, n, priority=""):
    mod, samp = (teng, tsamp) if isinstance(e, teng.Engine) else (jeng, jsamp)
    return mod.GenRequest(prompt_ids=list(prompt), max_new_tokens=n,
                          ignore_eos=True, priority=priority,
                          params=samp.SamplingParamsHost(temperature=0.0))


def _drain(out, first=None, timeout=300):
    """(token ids, the events) of a stream, errors included."""
    evs = [first] if first is not None else []
    while (ev := out.get(timeout=timeout)) is not None:
        evs.append(ev)
    ids = []
    for ev in evs:
        ids.extend(ev.token_ids or ([ev.token_id] if ev.token_id >= 0 else []))
    return ids, evs


def _ids(e, prompt, n, priority=""):
    ids, evs = _drain(e.submit(_req(e, prompt, n, priority)))
    assert not any(ev.error for ev in evs), [ev.error for ev in evs]
    return ids


LOW = list(range(2, 52))          # 50 prompt tokens: chunks 16, 16, 16, 2
HIGH = list(range(100, 110))


# ---------- the pure functions ----------

@pytest.fixture
def clock(monkeypatch):
    """One fake monotonic clock for both modules (they share ``time``)."""
    now = [1000.0]
    monkeypatch.setattr(time, "monotonic", lambda: now[0])
    return now


def _same(fj, ft):
    """The JAX and the port call give the same value or the same error."""
    try:
        want = ("ok", fj())
    except Exception as e:       # compared below, type and message
        want = ("raise", type(e).__name__, str(e))
    try:
        got = ("ok", ft())
    except Exception as e:
        got = ("raise", type(e).__name__, str(e))
    assert got == want


@pytest.mark.parametrize("value", ["high", " LOW ", "Normal", "", None, 3,
                                   "urgent", "normal\n"])
@pytest.mark.parametrize("default", ["normal", "low"])
def test_normalize_priority_matches_jax(value, default):
    _same(lambda: jsch.normalize_priority(value, default),
          lambda: tsch.normalize_priority(value, default))


@pytest.mark.parametrize("spec", ["4:2:1", "1:1:1", " 8 : 3 : 1 ", "4:2",
                                  "a:b:c", "0:1:1", "-1:2:3", "4,2,1",
                                  "1:2:3:4"])
def test_parse_priority_weights_matches_jax(spec):
    _same(lambda: jsch.parse_priority_weights(spec),
          lambda: tsch.parse_priority_weights(spec))


@pytest.mark.parametrize("seed", range(6))
def test_drr_and_burst_share_match_jax(seed):
    """Seeded walks of begin_tick / take / deficit / burst_share."""
    rng = np.random.default_rng(seed)
    w = tuple(int(x) for x in rng.integers(1, 9, 3))
    sj, st = jsch.Scheduler(w), tsch.Scheduler(w)
    for _ in range(200):
        budget = int(rng.integers(1, 2049))
        pend = [int(x) * int(rng.integers(0, 2)) for x in rng.integers(0, 600, 3)]
        sj.begin_tick(budget, pend)
        st.begin_tick(budget, pend)
        for _ in range(int(rng.integers(1, 5))):
            r, want = int(rng.integers(0, 3)), int(rng.integers(-5, 700))
            slack = int(rng.integers(-10, 300))
            assert st.take(r, want, slack) == sj.take(r, want, slack)
        assert [st.deficit(r) for r in range(3)] == [sj.deficit(r) for r in range(3)]
        dec = None if rng.integers(0, 4) == 0 else int(rng.integers(0, 3))
        cap = int(rng.integers(0, 33))
        counts = [int(x) for x in rng.integers(0, 3, 3)]
        assert st.burst_share(dec, counts, cap) == sj.burst_share(dec, counts, cap)


@pytest.mark.parametrize("seed", range(6))
def test_queue_order_shed_and_victims_match_jax(seed, clock):
    """Aged order (a fake clock around the aging threshold), the shed
    victim and the preemption victim, item by item."""
    rng = np.random.default_rng(100 + seed)
    classes = list(jsch.PRIORITY_CLASSES) + ["bogus"]
    aging = float(rng.choice([0.0, 4000.0, 250.0]))
    sj = jsch.Scheduler(max_preemptions=int(rng.integers(0, 4)), aging_ms=aging)
    st = tsch.Scheduler(max_preemptions=sj.max_preemptions, aging_ms=aging)
    for _ in range(60):
        n = int(rng.integers(0, 9))
        entries = [(classes[int(rng.integers(0, 4))],
                    clock[0] - float(rng.choice([0.0, 0.1, 0.249, 0.25, 3.9,
                                                 4.0, 5.0, 60.0])) - i * 1e-3,
                    i) for i in range(n)]
        assert st.order_queued(entries) == sj.order_queued(entries)
        assert st.aged_promotions == sj.aged_promotions
        rank = int(rng.integers(0, 3))
        assert (st.pick_shed_victim(rank, entries)
                == sj.pick_shed_victim(rank, entries))
        active = [(i, classes[int(rng.integers(0, 4))], float(rng.integers(0, 50)),
                   int(rng.integers(0, 4))) for i in range(int(rng.integers(0, 9)))]
        assert st.pick_victim(rank, active) == sj.pick_victim(rank, active)
        for p in classes:
            waited = float(rng.choice([0.0, 0.25, 3.99, 4.0, 9.0]))
            assert st.effective_rank(p, waited) == sj.effective_rank(p, waited)
        clock[0] += float(rng.integers(0, 3))


@pytest.mark.parametrize("seed", range(4))
def test_resume_queue_matches_jax(seed, clock):
    """park / peek / pop / requeue_front / remove_parked / drain and
    stats over a seeded sequence."""
    rng = np.random.default_rng(200 + seed)
    sj, st = jsch.Scheduler(), tsch.Scheduler()
    classes = list(jsch.PRIORITY_CLASSES)

    class R:
        def __init__(self, rid):
            self.request_id = rid

    def rid_of(e):
        return None if e is None else e.req.request_id

    for step in range(150):
        op = int(rng.integers(0, 6))
        if op <= 1:
            pr = classes[int(rng.integers(0, 3))]
            sj.park(jsch.ResumeEntry(req=R(step), ids=[step], priority=pr))
            st.park(tsch.ResumeEntry(req=R(step), ids=[step], priority=pr))
        elif op == 2:
            assert rid_of(st.peek_resume()) == rid_of(sj.peek_resume())
        elif op == 3:
            ej, et = sj.pop_resume(), st.pop_resume()
            assert rid_of(et) == rid_of(ej)
            if ej is not None and rng.integers(0, 2):
                sj.requeue_front(ej)
                st.requeue_front(et)
        elif op == 4:
            rid = int(rng.integers(0, step + 1))
            assert rid_of(st.remove_parked(rid)) == rid_of(sj.remove_parked(rid))
        else:
            clock[0] += float(rng.choice([0.5, 5.0]))
        assert st.resume_priorities() == sj.resume_priorities()
        assert st.stats() == sj.stats()
    assert ([rid_of(e) for e in st.drain_parked()]
            == [rid_of(e) for e in sj.drain_parked()])


# ---------- the engine cases, on both engines ----------

def _jtick(e):
    """One JAX Engine loop iteration driven by hand (tests/test_chaos.py)."""
    e._apply_emitter_notes()
    e._admit()
    e._prefill_step()
    e._dispatch_decode()
    e._drain_fifo()


def _preempt_in_prefill(e, low_n: int):
    """Drive an unstarted engine by hand: admit the low request, run two
    prefill chunks (32 committed rows, the same point on both engines),
    then a high arrival preempts it at the admission pass. Starts the
    engine and returns (low ids, high ids, scheduler stats)."""
    out_low = e.submit(_req(e, LOW, low_n, "low"))
    e._admit()
    e._prefill_step()
    e._prefill_step()
    assert e.slots[0].committed == 32 and e.slots[0].phase == "prefill"
    out_high = e.submit(_req(e, HIGH, 8, "high"))
    e._admit()
    assert e._sched.preemptions == 1 and e._sched.resume_depth == 1
    e.start()
    high, hevs = _drain(out_high)
    low, levs = _drain(out_low)
    assert not any(ev.error for ev in hevs + levs)
    return low, high, e.metrics()["scheduler"]


@pytest.mark.parametrize("reuse", [True, False], ids=["restore", "reprefill"])
def test_resume_counters_match_jax_at_the_same_point(tiny, reuse):  # noqa: F811
    """Both engines preempt the low request with 32 committed prompt rows.
    With reuse the resume splices 32 retained rows back (pages of 4, no
    re-prefill); with kv_prefix_cache off it re-prefills. The counters
    equal the JAX Engine's, the tokens the unpreempted run's."""
    kw = dict(kv_page_size=4, kv_prefix_cache_min_rows=4,
              kv_prefix_cache=reuse, kv_offload=False)
    runs = {}
    for name, make in (("port", port_engine), ("jax", jax_engine)):
        ref = _started(make(tiny, **kw))
        try:
            base = _ids(ref, LOW, 24, "low")
            base_high = _ids(ref, HIGH, 8, "high")
        finally:
            ref.shutdown()
        e = make(tiny, **kw)
        try:
            low, high, st = _preempt_in_prefill(e, 24)
        finally:
            e.shutdown()
        assert low == base and high == base_high
        runs[name] = (low, high, {k: st[k] for k in (
            "preemptions", "resumes", "resume_restore_rows", "resume_reprefills")})
    assert runs["port"] == runs["jax"]
    assert runs["port"][2]["resume_restore_rows"] == (32 if reuse else 0)
    assert runs["port"][2]["resume_reprefills"] == (0 if reuse else 1)


def _preempt_resume_round(e, prompt, n_low):
    """The JAX test's round, its preemption point made independent of the
    host's timing: on an unstarted engine, driven tick by tick, a low
    request decodes at least 5 tokens, then a high one arrives and the
    admission pass preempts the low one; the engine is started and both
    complete. Returns (low ids, high ids, the low one's decoded tokens at
    the pause, scheduler stats)."""
    out_low = e.submit(_req(e, prompt, n_low, "low"))
    tick = e._tick if isinstance(e, teng.Engine) else lambda: _jtick(e)
    for _ in range(400):
        tick()
        if e.slots[0] is not None and e.slots[0].n_decoded >= 5:
            break
        time.sleep(0.002)          # the JAX emitter keeps pace
    k = e.slots[0].n_decoded
    out_high = e.submit(_req(e, HIGH, 8, "high"))
    e._admit()
    assert e._sched.preemptions == 1 and e._sched.resume_depth == 1
    e.start()
    high, hevs = _drain(out_high)
    low, levs = _drain(out_low)
    assert not any(ev.error for ev in hevs + levs)
    st = e.metrics()["scheduler"]
    assert st["preemptions"] >= 1 and st["resumes"] >= 1
    return low, high, k, st


def test_high_preempts_low_both_streams_complete(tiny):  # noqa: F811
    """The JAX test's round on both engines: every token is the
    unpreempted run's (greedy f32 resumes exactly), nothing lost or
    repeated, and the JAX Engine's tokens."""
    got = {}
    for name, make in (("port", port_engine), ("jax", jax_engine)):
        ref = _started(make(tiny))
        try:
            base = _ids(ref, LOW[:15], 48, "low")
            base_high = _ids(ref, HIGH, 8, "high")
        finally:
            ref.shutdown()
        e = make(tiny)
        try:
            low, high, _k, _st = _preempt_resume_round(e, LOW[:15], 48)
            assert high == base_high and low == base and len(low) == 48
            assert e.metrics()["lifecycle"]["preemptions"] >= 1
            if name == "port":
                assert e.metrics()["pages_in_use"] == 0
        finally:
            e.shutdown()
        got[name] = (low, high)
    assert got["port"] == got["jax"]


def test_resume_reprefill_matches_fresh_readmission(tiny):  # noqa: F811
    """Prefix cache off: the paused slot retains nothing, resume re-prefills
    the history, and the continuation is byte for byte what a fresh engine
    computes for the prompt + the tokens emitted before the pause; the
    whole stream is the JAX Engine's."""
    kw = dict(kv_prefix_cache=False, kv_offload=False)
    e = port_engine(tiny, **kw)
    try:
        low, _h, k, st = _preempt_resume_round(e, LOW[:11], 64)
        assert st["resume_reprefills"] >= 1 and st["resume_restore_rows"] == 0
        assert len(low) == 64 and 0 < k < 64
    finally:
        e.shutdown()
    fresh = _started(port_engine(tiny, **kw))
    try:
        assert _ids(fresh, LOW[:11] + low[:k], 64 - k, "low") == low[k:]
    finally:
        fresh.shutdown()
    je = _started(jax_engine(tiny, **kw))
    try:
        assert _ids(je, LOW[:11], 64, "low") == low
    finally:
        je.shutdown()


def test_preempt_off_restores_fifo(tiny):  # noqa: F811
    """preempt=False: no scheduler, and a high arrival waits for the low
    request's slot on both engines (its first token after the low one's
    last)."""
    for make in (port_engine, jax_engine):
        # the port's inline emission: the low stream's end and the high
        # one's first token, which its emitter thread would put back to
        # back, are then told apart by the readers' clocks
        e = make(tiny, preempt=False,
                 **({"emitter": False} if make is port_engine else {}))
        assert e._sched is None
        assert e.metrics()["scheduler"] == {"preempt": False}
        e.start()
        try:
            out_low = e.submit(_req(e, LOW[:15], 24, "low"))
            out_low.get(timeout=300)
            out_high = e.submit(_req(e, HIGH, 4, "high"))
            t_low = []

            def read():
                _drain(out_low)
                t_low.append(time.monotonic())

            th = threading.Thread(target=read)
            th.start()
            first_high = out_high.get(timeout=300)
            t_high = time.monotonic()
            th.join(timeout=300)
            _drain(out_high, first_high)
            assert t_low and t_low[0] <= t_high
        finally:
            e.shutdown()


def test_queue_full_displaces_longest_queued_lower_class(tiny):  # noqa: F811
    """The JAX test on both (engines not started): a normal arrival
    displaces the oldest low; a low arrival finds nobody strictly below
    it and is refused; the same events, counters and queue."""
    got = {}
    for name, make in (("port", port_engine), ("jax", jax_engine)):
        e = make(tiny, max_queued_requests=2)
        out_l1 = e.submit(_req(e, [5, 6], 8, "low"))
        e.submit(_req(e, [7, 8], 8, "low"))
        e.submit(_req(e, [9, 10], 8, "normal"))
        ev1 = out_l1.get(timeout=1.0)
        assert out_l1.get(timeout=1.0) is None
        out_l3 = e.submit(_req(e, [11, 12], 8, "low"))
        ev3 = out_l3.get(timeout=1.0)
        assert out_l3.get(timeout=1.0) is None
        m = e.metrics()
        got[name] = ([(ev.error_kind, ev.error, ev.retry_after_s, ev.finish_reason)
                      for ev in (ev1, ev3)],
                     m["lifecycle"]["requests_shed"],
                     m["scheduler"]["queued_by_class"])
        e.shutdown()
    assert got["port"] == got["jax"]
    assert "displaced" in got["port"][0][0][1] and "overloaded" in got["port"][0][1][1]
    assert got["port"][1] == 2
    assert got["port"][2] == {"high": 0, "normal": 1, "low": 1}


def test_same_victim_for_the_same_slots(tiny):  # noqa: F811
    """Three slots admitted in one pass (low, normal, low): a high arrival
    picks the newest low on both engines; a normal one too; a low one
    none; decode-only finds none while all prefill."""
    got = {}
    for name, make in (("port", port_engine), ("jax", jax_engine)):
        e = make(tiny, num_slots=3)
        for p, pr in (([5] * 20, "low"), ([6] * 20, "normal"), ([7] * 20, "low")):
            e.submit(_req(e, p, 8, pr))
        e._admit()
        assert all(s is not None for s in e.slots)
        got[name] = ([e._pick_victim(r) for r in range(3)],
                     e._pick_victim(0, decode_only=True))
        e.shutdown()
    assert got["port"] == got["jax"] == ([2, 2, None], None)


def test_resume_reserve_autosize_and_rescale_match_jax(tiny, clock):  # noqa: F811
    """resume_reserve_pages 0: the reserve is EWMA(preemptions per
    minute) x EWMA(pages per preemption), a quarter of the pool at most,
    sampled every 0.5 s; note_pool_resize rescales the rate by old / new.
    The same inputs on both engines give the same reserve."""
    got = []
    for make in (port_engine, jax_engine):
        e = make(tiny, kv_page_size=4)
        e._t_reserve_sample = clock[0]
        for k, pages in enumerate((3, 5, 8)):
            e._preempt_marks.append(clock[0] - 10.0 * k)
            e._preempt_pages_ewma = (float(pages) if k == 0 else
                                     0.7 * e._preempt_pages_ewma + 0.3 * pages)
        trace = []
        for dt in (0.2, 0.6, 3.0, 20.0):
            clock[0] += dt
            e._autosize_reserve()
            trace.append((round(e._preempt_rate_ewma, 9), e._reserve_auto,
                          e.resume_reserve_effective))
        e.note_pool_resize(1, 3)
        trace.append((round(e._preempt_rate_ewma, 9), e._reserve_auto))
        e.ecfg.resume_reserve_pages = 2
        trace.append(e.resume_reserve_effective)
        got.append(trace)
        e.shutdown()
    assert got[0] == got[1]
    assert got[0][3][1] > 0 and got[0][4][1] <= got[0][3][1]


# ---------- pool pressure ----------

# pages of 32 rows: a low request holds its last page from its first
# burst on (90 + 30 tokens in 4 pages), so only the high ones ask for
# pages once the pool (10 pages) is full; the high ones need 2 each
PRESSURE = dict(num_slots=4, max_context=128, kv_page_size=32, kv_offload=False)
P_LOW, N_LOW, P_HIGH, N_HIGH = 90, 30, 40, 8


def _pressure_prompts():
    rng = np.random.default_rng(3)
    return ([rng.integers(2, 258, P_LOW).tolist() for _ in range(2)],
            [rng.integers(2, 258, P_HIGH).tolist() for _ in range(2)])


def _pressure_run(e, lows, highs):
    """Tick an unstarted port engine: two low requests decode until they
    hold their last pages, then two high ones arrive in a pool that cannot
    hold all four. Returns each stream's (ids, error) and the metrics; a
    step failure goes through the loop's own handler."""
    outs = [e.submit(_req(e, p, N_LOW, "low")) for p in lows]
    for _ in range(400):
        e._tick()
        if all(s is not None and s.n_decoded >= 2 for s in e.slots[:2]):
            break
    outs += [e.submit(_req(e, p, N_HIGH, "high")) for p in highs]
    for _ in range(2000):
        try:
            if not e._tick() and not any(e.slots) and e._queue.empty() and (
                    e._sched is None or not e._sched.resume_depth):
                break
        except Exception as ex:          # what the loop thread does
            e._fail_active(ex)
    res = []
    for o in outs:
        ids, evs = _drain(o, timeout=5)
        res.append((ids, next((ev.error for ev in evs if ev.error), None)))
    return res, e.metrics()


def test_pool_pressure_preempts_a_low_decode_slot(tiny):  # noqa: F811
    lows, highs = _pressure_prompts()
    want = []
    big = _started(port_engine(tiny, **PRESSURE))
    try:
        want = [_ids(big, p, n, pr) for p, n, pr in
                [(p, N_LOW, "low") for p in lows] + [(p, N_HIGH, "high") for p in highs]]
    finally:
        big.shutdown()
    je = _started(jax_engine(tiny, **PRESSURE))
    try:
        assert [_ids(je, p, N_LOW) for p in lows] == want[:2]
        assert [_ids(je, p, N_HIGH) for p in highs] == want[2:]
    finally:
        je.shutdown()
    # the port before the scheduler (preempt=False): PoolExhausted fails
    # every running request
    res, _m = _pressure_run(port_engine(tiny, kv_pool_pages=10,
                                        preempt=False, **PRESSURE), lows, highs)
    assert all(err and "PoolExhausted" in err for _ids_, err in res)
    # the defaults: a low decode slot pauses, resumes once the highs are
    # done, and every request completes with the large pool's tokens
    e = port_engine(tiny, kv_pool_pages=10, **PRESSURE)
    res, m = _pressure_run(e, lows, highs)
    assert [err for _i, err in res] == [None] * 4
    assert [ids for ids, _e in res] == want
    assert m["scheduler"]["preemptions"] >= 1 and m["scheduler"]["resumes"] >= 1
    assert m["lifecycle"]["preemptions"] == m["scheduler"]["preemptions"]
    assert m["pages_in_use"] == 0
    e.shutdown()


def test_cancel_while_parked_ends_the_stream(tiny):  # noqa: F811
    """A low request paused by a high one and cancelled while it waits to
    resume: its stream ends (the sentinel after the tokens it had), it
    never resumes, and no slot or page stays taken."""
    e = port_engine(tiny)
    out_low = e.submit(_req(e, LOW, 24, "low"))
    low = e._queue.queue[0]
    e._admit()
    e._prefill_step()
    out_high = e.submit(_req(e, HIGH, 8, "high"))
    e._admit()
    assert e._sched.resume_depth == 1
    e.cancel(low.request_id)
    e.start()
    try:
        high, hevs = _drain(out_high)
        assert len(high) == 8 and not any(ev.error for ev in hevs)
        ids, evs = _drain(out_low)
        assert ids == [] and not any(ev.error for ev in evs)
        m = e.metrics()
        assert m["scheduler"]["resume_depth"] == 0
        assert m["scheduler"]["resumes"] == 0
        assert m["active_slots"] == 0 and m["pages_in_use"] == 0
        assert not e._cancelled
    finally:
        e.shutdown()


def _packs(e):
    """Record each pack's (slot, tokens) segments on a port engine."""
    from localai_tpu_torch.engine.prefill_graph import split_pack

    packed, pack = [], e._prefill_pack

    def spy(bucket, continued, host):
        v = split_pack(host, bucket, e.ecfg.num_slots)
        packed.append({int(sl): int(n) for sl, n in
                       zip(v["seg_slots"], v["seg_len"]) if n})
        return pack(bucket, continued, host)

    e._prefill_pack = spy
    return packed


@pytest.mark.parametrize("late", ["high", "low"])
def test_two_classes_share_the_pack(tiny, late):  # noqa: F811
    """Two low prompts are prefilling when a third prompt arrives. A high
    one takes its DRR share of the 32-token pack at once (weights 4:2:1:
    the first low its 16, then the second low finds the low deficit spent
    and the high one packs): {low 1: 16, high: 16}. A third low one
    (single-class traffic) packs in queue order: {low 1: 16, low 2: 16}."""
    e = port_engine(tiny, num_slots=3)
    packed = _packs(e)
    for p in (LOW, list(range(60, 110))):
        e.submit(_req(e, p, 8, "low"))
    e._admit()
    e.submit(_req(e, list(range(120, 170)), 8, late))
    e._admit()
    e._dispatch_prefill(fuse=False)
    e._drain_all()
    assert packed[0] == ({0: 16, 2: 16} if late == "high" else {0: 16, 1: 16})
    e.shutdown()


def test_burst_shrinks_while_a_higher_class_waits(tiny):  # noqa: F811
    """A low slot decoding while a high prompt waits to prefill: the burst
    is the low class's weighted share of decode_burst (4 * 1 // 5 -> 1
    step, Scheduler.burst_share); a low prompt waiting leaves it whole."""
    for late, steps in (("high", 1), ("low", 4)):
        e = port_engine(tiny, num_slots=2)
        e.submit(_req(e, HIGH, 24, "low"))
        e._admit()
        e._prefill_step()
        assert e.slots[0].phase == "decode"
        e.submit(_req(e, LOW, 8, late))
        e._admit()
        assert e.slots[1].pending
        assert e._pick_burst(e._inflight_vec()) == steps
        e.shutdown()
