"""Device-tier prefix reuse in the PyTorch port's engine against the JAX
Engine, on the CPU, over the tiny f32 checkpoint (tests/tinymodel.py),
paged KV with page 16 and prefill_chunk 16.

One request script (``run_script``) exercises every tier:

  1. a conversation's first turn (40 tokens, 5 new) next to a longer
     request, so the turn stops mid-burst while the burst writes rows past
     its end;
  2. its second turn (turn 1 + its output + 12 tokens): tier 1, the slot's
     own retained rows, exactly the committed ones;
  3. four unrelated requests admitted together, which take every slot;
  4. the third turn: tier 3, the retained chain found by hash after the
     conversation's slot was overwritten;
  5. a request sharing 40 prompt tokens with a running one: tier 2,
     copy-on-write sharing of its committed prompt rows (two full pages
     and a clone of the page the prefix ends in);
  6. the third turn with token 20 changed: tier 1 up to the divergence,
     cloning a page the prefix cache holds;
  7. the third turn's first 64 tokens: a chain covering the whole prompt,
     cut to leave one token to prefill (a clone of the last page).

What is pinned:
  * greedy tokens byte-identical across the port with reuse, the port
    with ``kv_prefix_cache=False`` and the JAX Engine cold (its slot pick
    and admission patched to reuse nothing, ``kv_offload=False``);
  * ``reused_prompt_tokens`` per request equal to the JAX Engine's with
    ``kv_prefix_cache=True``, ``kv_offload=False``;
  * a free slot's retained pages (and the prefix cache's) keep their bytes
    across bursts of other slots;
  * an oversubscribed pool finishes without PoolExhausted, evicting
    retained chains, with the cold engine's tokens;
  * a cancelled stream retains exactly its committed rows (prompt + the
    emitted tokens but the last), and a later request reusing them gives
    the cold tokens;
  * ``kv_prefix_cache=False`` reuses nothing and retains nothing;
  * ``kv_prefix_cache_min_rows`` guards tiers 2 and 3 as in the JAX Engine;
  * ``pages_in_use`` is 0 at idle and counts a leaked page;
  * an admission that cannot get a page for its clone fails that request
    alone, and its slot keeps no rows.

tests/test_torch_prefix_layouts.py runs the same script with int8 KV and
the contiguous layout.
"""

from __future__ import annotations

import tests.torch_cpu  # noqa: F401  (one torch CPU thread)

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localai_tpu.engine import engine as jeng
from localai_tpu.engine import sampling as jsamp
from localai_tpu.engine import weights as jweights
from localai_tpu.models import llama as jllama
from localai_tpu_torch.engine import engine as teng
from localai_tpu_torch.engine import sampling as tsamp
from localai_tpu_torch.engine import weights as tweights
from localai_tpu_torch.models import llama as tllama
from tests.test_torch_engine import _Tok

S, C, PG = 4, 128, 16


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """(JAX config, JAX params, port config, port params) of the tiny f32
    checkpoint."""
    from tests.tinymodel import write_tiny_checkpoint

    d = str(tmp_path_factory.mktemp("tiny_prefix"))
    write_tiny_checkpoint(d)
    with open(os.path.join(d, "config.json")) as f:
        hf = json.load(f)
    jcfg = jllama.LlamaConfig.from_hf_config(hf, dtype=jnp.float32)
    jparams = jweights.load_llama_params(d, jcfg, dtype=jnp.float32)
    tcfg = tllama.LlamaConfig.from_hf_config(hf, dtype=torch.float32)
    tparams = tweights.from_jax_params(jax.tree.map(np.asarray, jparams),
                                       tcfg, device="cpu")
    return jcfg, jparams, tcfg, tparams


def jax_engine(tiny, reuse: bool, cache_dtype=jnp.float32, layout="paged",
               min_rows: int = 16):
    """A started JAX Engine. ``reuse=False`` makes it cold: its slot pick
    reports no common prefix and its paged admission releases the slot's
    rows and reuses none (the JAX engine keeps tiers 1-2 even with
    kv_prefix_cache off)."""
    jcfg, jparams, _tcfg, _tp = tiny
    je = jeng.Engine(jcfg, jparams, _Tok(), jeng.EngineConfig(
        num_slots=S, max_context=C, prefill_buckets=(16,), prefill_chunk=16,
        cache_dtype=cache_dtype, kv_layout=layout, kv_page_size=PG,
        kv_prefix_cache=reuse, kv_offload=False,
        draft="0", kv_prefix_cache_min_rows=min_rows))
    if not reuse:
        pick = je._pick_slot
        je._pick_slot = lambda ids: (pick(ids)[0], 0)

        def cold_admission(slot, ids, common, rid=""):
            je._pool.release(slot, 0)
            return 0

        je._paged_admission = cold_admission
    return je.start() or je


def port_engine(tiny, reuse: bool, **knobs):
    _jcfg, _jp, tcfg, tparams = tiny
    kw = dict(num_slots=S, max_context=C, prefill_chunk=16, kv_page_size=PG,
              decode_burst=16, kv_prefix_cache=reuse, kv_offload=False,
              draft="0")
    kw.update(knobs)
    return teng.Engine(tcfg, tparams, _Tok(), teng.EngineConfig(**kw),
                       device="cpu").start()


def _submit(e, prompt, n):
    mod, samp = (teng, tsamp) if isinstance(e, teng.Engine) else (jeng, jsamp)
    return e.submit(mod.GenRequest(
        prompt_ids=list(prompt), max_new_tokens=n, ignore_eos=True,
        params=samp.SamplingParamsHost(temperature=0.0)))


def _drain(out, first=None):
    """(token ids, reused_prompt_tokens) of one request's stream."""
    ids, reused = [], None
    evs = [first] if first is not None else []
    while True:
        ev = evs.pop() if evs else out.get(timeout=600)
        if ev is None:
            return ids, reused
        assert not ev.error, ev.error
        ids.extend(ev.token_ids or ([ev.token_id] if ev.token_id >= 0 else []))
        if ev.timings:
            reused = ev.timings["reused_prompt_tokens"]


def _submit_together(e, prompts, n):
    """Submit ``prompts`` so the engine admits them in one pass: its
    admission is held until all are queued. Without the hold a request
    of the wave could finish and free its slot before the last one is
    submitted (the submitting thread descheduled on a loaded host); that
    request's slot pick then keeps the conversation's slot, and turn 3's
    reuse changes with the host's timing."""
    e._admit = lambda: False
    try:
        outs = [_submit(e, p, n) for p in prompts]
    finally:
        del e._admit                     # the class's method again
    e._wake.set()
    return outs


def run_script(e, seed: int = 21, b_first: bool = False) -> list:
    """The module doc's script on one engine: (ids, reused) per request,
    in script order. Prompts that continue a conversation are built from
    this engine's own outputs. With ``b_first`` the shared-prefix request
    is submitted once b has finished (its stream closed, so its slot is
    free on every engine), not while b decodes; the case of a request
    sharing the prefix of one that still decodes then comes last, on new
    prompts admitted in one pass (two more results)."""
    rng = np.random.default_rng(seed)

    def draw(n):
        return rng.integers(2, 258, size=n).tolist()

    res = []
    a, filler = draw(40), draw(30)                       # 1
    outs = [_submit(e, a, 5), _submit(e, filler, 40)]
    res += [_drain(o) for o in outs]
    t2 = a + res[0][0] + draw(12)                        # 2
    res.append(_drain(_submit(e, t2, 6)))
    wave = [draw(n) for n in (34, 45, 38, 50)]           # 3
    outs = _submit_together(e, wave, 6)
    res += [_drain(o) for o in outs]
    t3 = t2 + res[2][0] + draw(10)                       # 4
    res.append(_drain(_submit(e, t3, 5)))
    b = draw(50)                                         # 5
    ob = _submit(e, b, 20)
    first = ob.get(timeout=600)                          # b is prefilled
    if b_first:
        res.append(_drain(ob, first))
    o2 = _submit(e, b[:40] + draw(15), 6)
    if not b_first:
        res.append(_drain(ob, first))
    res.append(_drain(o2))
    div = list(t3)                                       # 6
    div[20] = div[20] % 250 + 3
    res.append(_drain(_submit(e, div, 5)))
    res.append(_drain(_submit(e, t3[:64], 5)))           # 7
    if b_first:
        c = draw(50)
        outs = _submit_together(e, [c, c[:40] + draw(15)], 6)
        res += [_drain(o) for o in outs]
    return res


@pytest.fixture(scope="module")
def scripted(tiny):
    """The script on the port with and without reuse, and on the JAX
    Engine cold and with reuse."""
    out = {}
    for name, make in (("port", lambda: port_engine(tiny, True)),
                       ("port_cold", lambda: port_engine(tiny, False)),
                       ("jax_cold", lambda: jax_engine(tiny, False)),
                       ("jax", lambda: jax_engine(tiny, True))):
        e = make()
        try:
            out[name] = run_script(e)
            out[name + "_metrics"] = e.metrics()
        finally:
            e.shutdown()
    return out


def test_greedy_tokens_identical_with_and_without_reuse_and_jax_cold(scripted):
    port = [ids for ids, _r in scripted["port"]]
    assert port == [ids for ids, _r in scripted["port_cold"]]
    assert port == [ids for ids, _r in scripted["jax_cold"]]
    assert [len(i) for i in port] == [5, 40, 6, 6, 6, 6, 6, 5, 20, 6, 5, 5]


def test_reused_prompt_tokens_match_jax_request_by_request(scripted):
    got = [r for _ids, r in scripted["port"]]
    assert got == [r for _ids, r in scripted["jax"]]
    # tier 1 reuses turn 1's committed rows: its 40 prompt tokens and 4 of
    # its 5 emitted ones (the last has no row), not the burst's overrun
    assert got[2] == 44
    assert got[7] == 48          # tier 3: the three full pages of turn 2's 62 rows
    assert got[9] == 40          # tier 2: two shared pages + one clone
    assert got[10] == 20         # tier 1 up to the divergence
    assert got[11] == 63         # tier 3, cut to leave one token
    assert all(r == 0 for r in got[3:7]) and got[:2] == [0, 0]
    assert [r for _i, r in scripted["port_cold"]] == [0] * 12


def test_reuse_counters(scripted):
    m = scripted["port_metrics"]
    pc = m["prefix_cache"]
    assert pc["hits"] == 2 and pc["hit_rows"] == 48 + 63
    assert pc["cow_clones"] >= 3         # tier 2's boundary, 6's and 7's
    assert pc["inserted_pages"] > 0 and pc["evicted_pages"] == 0
    assert m["prompt_tokens_reused"] == sum(r for _i, r in scripted["port"])
    assert m["kv_pages_retained"] > 0
    assert m["pages_in_use"] == 0 and m["active_slots"] == 0
    assert (m["kv_pages_free"] + m["kv_pages_retained"] + m["kv_pages_active"]
            == m["pages_total"])
    jm = scripted["jax_metrics"]
    assert jm["prefix_cache"]["hits"] == pc["hits"]
    assert jm["prefix_cache"]["hit_rows"] == pc["hit_rows"]
    cold = scripted["port_cold_metrics"]
    assert "prefix_cache" not in cold and cold["prompt_tokens_reused"] == 0
    # nothing retained: every page is back on the free list
    assert cold["kv_pages_free"] == cold["pages_total"]


def test_min_rows_guards_tiers_2_and_3_as_in_jax(tiny, scripted):
    """kv_prefix_cache_min_rows = 64: the script's tier-2 share (40 rows)
    and tier-3 hits (48, 63 rows) fall below it; tier 1 has only the
    16-token guard, so step 6 reuses 20 rows and step 7, its 63-row chain
    refused, the 20 that step 6's slot shares with it. Reused rows equal
    the JAX Engine's with the same knob, tokens the cold run's."""
    got, ref = [], []
    for e, out in ((port_engine(tiny, True, kv_prefix_cache_min_rows=64), got),
                   (jax_engine(tiny, True, min_rows=64), ref)):
        try:
            out += run_script(e)
        finally:
            e.shutdown()
    assert [r for _i, r in got] == [r for _i, r in ref]
    assert [r for _i, r in got] == [0, 0, 44, 0, 0, 0, 0, 0, 0, 0, 20, 20]
    assert [i for i, _r in got] == [i for i, _r in scripted["port_cold"]]


@pytest.mark.parametrize("reuse", [True, False])
def test_pages_in_use_is_zero_at_idle_and_reports_a_leak(tiny, reuse):
    """At idle ``pages_in_use`` counts only references nothing accounts
    for (the tables of free slots and the prefix cache's holds do), so a
    detached page never adopted and a count never dropped both show."""
    e = port_engine(tiny, reuse)
    try:
        rng = np.random.default_rng(14)
        outs = [_submit(e, rng.integers(2, 258, size=n).tolist(), 6)
                for n in (45, 20)]
        for o in outs:
            _drain(o)
        m = e.metrics()
        assert m["active_slots"] == 0 and m["pages_in_use"] == 0
        pool = e._pool
        retained = int(pool.owned.sum()) + pool.retained_pages
        assert (retained > 0) == reuse
        leak = pool.alloc_detached()                 # never adopted
        assert e.metrics()["pages_in_use"] == 1
        if reuse:                                    # a count never dropped
            pool.refs[int(pool.ptab[0, 0])] += 1
            assert e.metrics()["pages_in_use"] == 2
            pool.refs[int(pool.ptab[0, 0])] -= 1
        pool.unref_detached(leak)
        assert e.metrics()["pages_in_use"] == 0
    finally:
        e.shutdown()


def test_admission_without_a_clone_page_fails_only_that_request(tiny):
    """A tier-2 share whose boundary page cannot be cloned (a 5-page pool
    the running request fills) raises PoolExhausted at admission: that
    request gets an error event and its sentinel, its slot forgets the
    shared pages, the running request decodes on unharmed, and the same
    request later (tier 1 over the finished request's rows) gives the
    cold tokens."""
    _jcfg, _jp, tcfg, tparams = tiny
    e = teng.Engine(tcfg, tparams, _Tok(), teng.EngineConfig(
        num_slots=2, max_context=C, prefill_chunk=16, kv_page_size=PG,
        decode_burst=4, kv_pool_pages=5, draft="0"), device="cpu")
    cold = port_engine(tiny, False, num_slots=2, decode_burst=4)
    try:
        rng = np.random.default_rng(15)
        b = rng.integers(2, 258, size=60).tolist()
        late = b[:40] + rng.integers(2, 258, size=15).tolist()
        greedy = tsamp.SamplingParamsHost(temperature=0.0)
        out = e.submit(teng.GenRequest(prompt_ids=b, max_new_tokens=10,
                                       ignore_eos=True, params=greedy))
        assert e._admit()
        while e._prefill_step():
            pass
        assert e._decode_burst()              # 64 rows + the burst's 2
        pool = e._pool
        assert pool.free_pages == 0 and int(pool.owned[0]) == 5
        out2 = e.submit(teng.GenRequest(prompt_ids=late, max_new_tokens=5,
                                        ignore_eos=True, params=greedy))
        assert not e._admit()
        ev = out2.get_nowait()
        assert ev.error and ev.error.startswith("PoolExhausted"), ev.error
        assert out2.get_nowait() is None
        assert e.slots[1] is None and e._cache_tokens[1] == []
        assert int(pool.owned[1]) == 0 and pool.free_pages == 0
        assert all(int(pool.refs[p]) == 1 for p in pool.ptab[0, :5])
        assert e.metrics()["pages_in_use"] == 5
        e.start()
        assert _drain(out)[0] == _drain(_submit(cold, b, 10))[0]
        got, reused = _drain(_submit(e, late, 5))
        assert reused == 40
        assert got == _drain(_submit(cold, late, 5))[0]
        assert e.metrics()["pages_in_use"] == 0
    finally:
        e.shutdown()
        cold.shutdown()


def _pages_of(e, pages):
    idx = torch.tensor(sorted(pages), dtype=torch.int64)
    return [e.ck["pages"][:, idx].clone(), e.cv["pages"][:, idx].clone()] + (
        [e.ck["scales"][:, idx].clone(), e.cv["scales"][:, idx].clone()]
        if "scales" in e.ck else [])


@pytest.mark.parametrize("cache_dtype", [None, torch.int8])
def test_free_slot_retained_pages_unchanged_across_bursts(tiny, cache_dtype):
    e = port_engine(tiny, True, cache_dtype=cache_dtype)
    try:
        rng = np.random.default_rng(5)
        prompt = rng.integers(2, 258, size=45).tolist()
        _drain(_submit(e, prompt, 8))
        pool = e._pool
        kept = {int(p) for p in pool.ptab[0, :int(pool.owned[0])]}
        kept |= set(e._pcache.pages())
        assert len(kept) == 4 and e._cache_tokens[0] == prompt + \
            e._cache_tokens[0][45:] and len(e._cache_tokens[0]) == 52
        before = _pages_of(e, kept)
        steps0 = e.metrics()["decode"]["steps"]
        # three other requests decode for many bursts in the other slots
        outs = [_submit(e, rng.integers(2, 258, size=n).tolist(), 40)
                for n in (20, 33, 17)]
        for o in outs:
            _drain(o)
        assert e.metrics()["decode"]["steps"] - steps0 >= 39
        assert e._cache_tokens[0][:45] == prompt      # slot 0 stayed free
        for x, y in zip(before, _pages_of(e, kept)):
            assert torch.equal(x, y)
        # the device table is the host mirror
        assert np.array_equal(e.ck["ptab"].numpy(), pool.ptab)
    finally:
        e.shutdown()


def test_contiguous_free_slot_rows_unchanged_across_bursts(tiny):
    e = port_engine(tiny, True, kv_layout="contiguous")
    try:
        rng = np.random.default_rng(6)
        _drain(_submit(e, rng.integers(2, 258, size=45).tolist(), 8))
        n = len(e._cache_tokens[0])
        assert n == 52
        before = [e.ck["rows"][:, 0, :n].clone(), e.cv["rows"][:, 0, :n].clone()]
        outs = [_submit(e, rng.integers(2, 258, size=k).tolist(), 40)
                for k in (20, 33, 17)]
        for o in outs:
            _drain(o)
        assert torch.equal(before[0], e.ck["rows"][:, 0, :n])
        assert torch.equal(before[1], e.cv["rows"][:, 0, :n])
    finally:
        e.shutdown()


def test_pool_pressure_evicts_and_finishes(tiny):
    """8 pages = one slot's context for two slots: back-to-back 48-token
    prompts and a concurrent pair force table reclaim and chain eviction;
    no PoolExhausted, the cold engine's tokens."""
    rng = np.random.default_rng(12)
    prompts = [rng.integers(2, 258, size=48).tolist() for _ in range(4)]
    prompts.append(prompts[0][:40] + rng.integers(2, 258, size=9).tolist())

    def run(e):
        res = [_drain(_submit(e, p, 8)) for p in prompts]
        outs = [_submit(e, p, 8) for p in prompts[1:3]]
        return res + [_drain(o) for o in outs]

    e = port_engine(tiny, True, num_slots=2, kv_pool_pages=8)
    try:
        got = run(e)
        m = e.metrics()
    finally:
        e.shutdown()
    cold = port_engine(tiny, False, num_slots=2)
    try:
        ref = run(cold)
    finally:
        cold.shutdown()
    assert [i for i, _r in got] == [i for i, _r in ref]
    assert m["prefix_cache"]["evicted_pages"] > 0
    assert m["pages_total"] == 8 and m["active_slots"] == 0
    assert (m["kv_pages_free"] + m["kv_pages_retained"] + m["kv_pages_active"]
            == 8)


def test_cancelled_stream_retains_only_committed_rows(tiny):
    """A stream cancelled while decoding, and one cancelled mid-prefill,
    keep exactly the rows whose KV write ran; requests reusing them give
    the cold tokens. The engine's ticks are driven from the test (the
    engine is started only for the follow-ups), so the cancel points are
    exact."""
    _jcfg, _jp, tcfg, tparams = tiny
    e = teng.Engine(tcfg, tparams, _Tok(), teng.EngineConfig(
        num_slots=2, max_context=C, prefill_chunk=16, kv_page_size=PG,
        decode_burst=4, draft="0", emitter=False), device="cpu")
    cold = port_engine(tiny, False, num_slots=2, decode_burst=4)
    try:
        rng = np.random.default_rng(8)
        prompt = rng.integers(2, 258, size=37).tolist()
        req = teng.GenRequest(prompt_ids=prompt, max_new_tokens=90,
                              ignore_eos=True,
                              params=tsamp.SamplingParamsHost(temperature=0.0))
        out = e.submit(req)
        assert e._admit()
        while e._prefill_step():          # three chunks, the first token
            pass
        assert e._decode_burst() and e._decode_burst()    # 2 x 4 steps
        e.cancel(req.request_id)
        e._reap_cancelled()
        ids, reused = _drain(out)
        assert len(ids) == 9 and reused is None           # no final event
        # the JAX engine's committed rule: every emitted token but the
        # last has its row
        kept = list(e._cache_tokens[0])
        assert kept == prompt + ids[:-1]
        assert int(e._pool.owned[0]) == e._pool.pages_for(len(kept))
        # cancelled after two of its seven prefill chunks
        long = rng.integers(2, 258, size=100).tolist()
        req2 = teng.GenRequest(prompt_ids=long, max_new_tokens=5,
                               params=tsamp.SamplingParamsHost(temperature=0.0))
        out2 = e.submit(req2)
        assert e._admit() and e.slots[1] is not None
        assert e._prefill_step() and e._prefill_step()
        e.cancel(req2.request_id)
        e._reap_cancelled()
        assert out2.get_nowait() is None
        assert e._cache_tokens[1] == long[:32]
        assert e._pcache.pages_held == 2 + 2      # full pages of both
        e.start()
        follow = kept + rng.integers(2, 258, size=6).tolist()
        for p, want in ((follow, len(kept)), (long, 32)):
            got, reused = _drain(_submit(e, p, 7))
            assert reused == want
            assert got == _drain(_submit(cold, p, 7))[0]
    finally:
        e.shutdown()
        cold.shutdown()
