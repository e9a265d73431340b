"""The host tier of prefix reuse (``kv_offload``, on by default) in the
PyTorch port's engine against the JAX Engine, on the CPU, over the tiny
f32 checkpoint (tests/tinymodel.py), paged KV (float32 and int8), page 16,
prefill_chunk 16, 4 slots.

One request script (``run_script``), both engines at their host-tier
defaults (kv_host_pool_mb 256, kv_prefetch_ahead 2) and a 20-page pool:

  1. turn 1 (70 tokens, 6 new): its four full pages are retained;
  2. a wave of 4 requests admitted together that takes every slot and
     needs the whole pool: turn 1's chain is evicted, and so offloaded;
  3. turn 2 = turn 1 + its output + 5 tokens: the chain walk finds no
     device page and restores turn 1's four pages from the host tier;
  4. a second wave, which evicts the chain again (its first four links
     are in the host tier already, only the fifth is offloaded);
  5. turn 3 = turn 2 + its output + 7 tokens: restored again, five pages.

Per request, greedy tokens, finish reasons, completion_tokens and
reused_prompt_tokens equal the JAX Engine's; after the offload workers
have drained (the port's offload worker, the JAX sync worker, each in
dispatch order), so do the host tier's counters: restored, restores,
hits, misses and evicted after every step, offloaded at the end (see
``test_host_counters_match_jax_step_by_step``).

Also: prefetch-ahead (a turn held in the queue, its chain in the host
tier, gives the JAX prefetch_issued / prefetch_hits), the
default pool cut (4 x 256 / 16 = 64 pages -> 48 as in the JAX Engine,
64 with kv_offload off), persistence (engine A saves at shutdown, engine
B loads and restores turn 2 with A's tokens), ``pages_in_use`` at idle
with the prefetch pipeline holding pages (a planted leak still counts),
``kv_offload=False`` (the device tier alone, the JAX Engine's tokens and
reuse, one request at a time and in pairs), a cancelled request's
offloaded chain restored later, and the refusals of a host budget below
1 MiB and a negative prefetch depth.
"""

from __future__ import annotations

import tests.torch_cpu  # noqa: F401  (one torch CPU thread)

import json
import os
import threading
import time

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

S, C, PG, POOL = 4, 128, 16, 20
# the host tier's counters held against the JAX Engine's
COUNTERS = ("offloaded_pages", "restored_pages", "restores", "hits", "misses",
            "evicted_pages")
DTYPES = {"float32": (None, jnp.float32), "int8": (torch.int8, jnp.int8)}


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """(JAX config, JAX params, port config, port params, checkpoint dir)
    of the tiny f32 checkpoint."""
    from tests.tinymodel import write_tiny_checkpoint

    d = str(tmp_path_factory.mktemp("tiny_host_tier"))
    write_tiny_checkpoint(d)
    with open(os.path.join(d, "config.json")) as f:
        hf = json.load(f)
    jcfg = jllama.LlamaConfig.from_hf_config(hf, dtype=jnp.float32)
    jparams = jweights.load_llama_params(d, jcfg, dtype=jnp.float32)
    tcfg = tllama.LlamaConfig.from_hf_config(hf, dtype=torch.float32)
    tparams = tweights.from_jax_params(jax.tree.map(np.asarray, jparams),
                                       tcfg, device="cpu")
    return jcfg, jparams, tcfg, tparams, d


def jax_engine(tiny, dtype="float32", start=True, **knobs):
    jcfg, jparams, *_ = tiny
    kw = dict(num_slots=S, max_context=C, prefill_buckets=(16,),
              prefill_chunk=16, cache_dtype=DTYPES[dtype][1], kv_layout="paged",
              kv_page_size=PG, kv_pool_pages=POOL, draft="0")
    kw.update(knobs)
    je = jeng.Engine(jcfg, jparams, _Tok(), jeng.EngineConfig(**kw))
    return je.start() or je if start else je


def port_engine(tiny, dtype="float32", start=True, **knobs):
    _jc, _jp, tcfg, tparams, _d = tiny
    kw = dict(num_slots=S, max_context=C, prefill_chunk=16, kv_page_size=PG,
              decode_burst=16, kv_pool_pages=POOL, cache_dtype=DTYPES[dtype][0],
              draft="0")
    kw.update(knobs)
    e = teng.Engine(tcfg, tparams, _Tok(), teng.EngineConfig(**kw), device="cpu")
    return e.start() if start else e


def _submit(e, prompt, n, rid=""):
    mod, samp = (teng, tsamp) if isinstance(e, teng.Engine) else (jeng, jsamp)
    return e.submit(mod.GenRequest(
        prompt_ids=list(prompt), max_new_tokens=n, ignore_eos=True,
        request_id=rid, params=samp.SamplingParamsHost(temperature=0.0)))


def _drain(out):
    """(token ids, finish reason, completion_tokens, reused_prompt_tokens)
    of one request's stream."""
    ids, last = [], None
    while (ev := out.get(timeout=600)) is not None:
        assert not ev.error, ev.error
        ids.extend(ev.token_ids or ([ev.token_id] if ev.token_id >= 0 else []))
        last = ev
    return (ids, last.finish_reason, last.completion_tokens,
            last.timings["reused_prompt_tokens"])


class _Barrier(jeng._PendingOffload):
    """An item for the JAX sync worker that only marks that every item
    queued before it has run."""

    def __init__(self):
        super().__init__([], None, None, None)
        self.done = threading.Event()

    def run(self):
        self.done.set()


def _settle(e):
    """Let every offload dispatched so far land: the port's offload worker
    and the JAX sync worker each run their items in order."""
    if isinstance(e, teng.Engine):
        e._offloader.join()
    else:
        b = _Barrier()
        e._sync_q.put(b)
        assert b.done.wait(timeout=120)


def _host_stats(e) -> dict:
    _settle(e)
    st = e.metrics().get("kv_offload")
    return None if st is None else {k: st[k] for k in COUNTERS}


def run_script(e, seed: int = 31, group: int = 4) -> tuple:
    """The module doc's script: (per-request results, host counters after
    each step). A wave goes in groups of ``group`` requests, each group
    queued with admission held (below) and submitted after the group
    before it has finished, so no admission races a release (1: one
    request at a time)."""
    rng = np.random.default_rng(seed)

    def draw(n):
        return rng.integers(2, 258, size=n).tolist()

    def wave(lens, n):
        # a group queued with admission held, so all of it is admitted in
        # one pass: otherwise a loaded host can let the loop admit the
        # first before the last is submitted, and the pages each pass asks
        # for (so the counters after the step) differ between the two loops
        res = []
        for i in range(0, len(lens), group):
            e._admit = lambda: False
            try:
                outs = [_submit(e, draw(k), n) for k in lens[i:i + group]]
            finally:
                del e._admit             # the class's method again
            e._wake.set()
            res += [_drain(o) for o in outs]
        return res

    res, counters = [], []
    a = draw(70)
    res.append(_drain(_submit(e, a, 6)))                       # 1
    counters.append(_host_stats(e))
    res += wave((60, 62, 58, 61), 10)                          # 2
    counters.append(_host_stats(e))
    t2 = a + res[0][0] + draw(5)
    res.append(_drain(_submit(e, t2, 6)))                      # 3
    counters.append(_host_stats(e))
    res += wave((63, 57, 60, 59), 10)                          # 4
    counters.append(_host_stats(e))
    t3 = t2 + res[5][0] + draw(7)
    res.append(_drain(_submit(e, t3, 6)))                      # 5
    counters.append(_host_stats(e))
    return res, counters


@pytest.fixture(scope="module")
def scripted(tiny):
    out = {}
    for dtype in DTYPES:
        for name, make in (("port", port_engine), ("jax", jax_engine)):
            e = make(tiny, dtype)
            try:
                out[(name, dtype)] = run_script(e)
                out[(name, dtype, "metrics")] = e.metrics()
            finally:
                e.shutdown()
    return out


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_requests_match_jax_with_the_host_tier(scripted, dtype):
    got, _c = scripted[("port", dtype)]
    ref, _c = scripted[("jax", dtype)]
    assert got == ref
    reused = [r[3] for r in got]
    # turn 2 restores turn 1's four pages, turn 3 five (its chain's
    # first four offloaded once, the fifth at the second wave)
    assert reused[5] == 64 and reused[10] == 80, reused
    assert all(r[1] == "length" and r[2] == len(r[0]) for r in got)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_host_counters_match_jax_step_by_step(scripted, dtype):
    """The admission's counters (restores, hits, restored pages, misses)
    and host evictions after every step; offloaded pages at the end. A
    page is offloaded when a reclaim evicts it, and the two loops ask for
    pages in another order within a wave (their packing differs), so a
    page may be offloaded one step earlier on one side than the other."""
    got = scripted[("port", dtype)][1]
    ref = scripted[("jax", dtype)][1]
    per_step = [k for k in COUNTERS if k != "offloaded_pages"]
    assert [{k: c[k] for k in per_step} for c in got] == \
        [{k: c[k] for k in per_step} for c in ref]
    assert got[-1] == ref[-1]
    assert got[1]["offloaded_pages"] >= 4 and got[1]["restores"] == 0
    assert got[2]["restores"] == 1 and got[2]["restored_pages"] == 4
    assert got[4]["restores"] == 2 and got[4]["restored_pages"] == 9
    m = scripted[("port", dtype, "metrics")]
    assert m["kv_pages_offloaded"] == m["kv_offload"]["pages"] > 0
    assert m["pages_in_use"] == 0 and m["active_slots"] == 0
    assert (m["kv_pages_free"] + m["kv_pages_retained"] + m["kv_pages_active"]
            == m["pages_total"] == POOL)
    w = m["kv_offload_worker"]
    assert w["pages"] >= m["kv_offload"]["offloaded_pages"] and w["batches"] > 0


def test_restored_pages_hold_the_offloaded_bytes(tiny):
    """The pages turn 2 restores equal, byte for byte, the pages turn 1
    wrote (copied before the wave evicted them)."""
    e = port_engine(tiny)
    try:
        rng = np.random.default_rng(31)
        a = rng.integers(2, 258, size=70).tolist()
        out = _drain(_submit(e, a, 6))
        keys = list(e._pcache.chain_keys(a))[:4]
        pages = [e._pcache._entries[k].page for k in keys]
        before = [e.ck["pages"][:, pages].clone(), e.cv["pages"][:, pages].clone()]
        for o in [_submit(e, rng.integers(2, 258, size=n).tolist(), 10)
                  for n in (60, 62, 58, 61)]:
            _drain(o)
        _settle(e)
        assert not any(e._pcache.contains(k) for k in keys)
        assert all(e._hstore.contains(k) for k in keys)
        got = _drain(_submit(e, a + out[0] + [5, 6, 7], 4))
        assert got[3] == 64
        pages = [e._pcache._entries[k].page for k in keys]
        assert torch.equal(e.ck["pages"][:, pages], before[0])
        assert torch.equal(e.cv["pages"][:, pages], before[1])
    finally:
        e.shutdown()


def _device_tier_alone(tiny, group: int) -> dict:
    """run_script on both engines with kv_offload=False and waves fed in
    groups of ``group`` (all four of a wave at once, this 20-page pool
    without the host tier can run out in the JAX Engine, whose
    PoolExhausted fails every running request): name -> its results."""
    res = {}
    for name, make in (("port", port_engine), ("jax", jax_engine)):
        e = make(tiny, kv_offload=False)
        try:
            res[name] = run_script(e, group=group)
            m = e.metrics()
            assert "kv_offload" not in m and "kv_pages_offloaded" not in m
            if name == "port":
                assert e._hstore is None and e._offloader._thread is None
                assert m["prefix_cache"]["evicted_pages"] > 0
        finally:
            e.shutdown()
    return res


def test_kv_offload_off_is_the_device_tier_alone(tiny):
    """kv_offload=False on both sides: no host store, no offload thread,
    the evicted part of the chain prefilled again; tokens and reused rows
    request by request as the JAX Engine's.

    Each request of a wave is submitted after the one before it has
    finished. Submitted after its first token only, a request's admission
    races the release of the one before: the JAX Engine picks up a burst
    that landed before it admits (its top-of-tick drain,
    localai_tpu/engine/engine.py:3902-3905), so its reuse there varies
    from run to run (16 / 32 or 16 / 48 rows at turns 2 / 3), while the
    port's loop admits before it drains and on the CPU processes a burst
    only when it waits for it (a busy card), so it always admits first
    (0 / 0): the loop order differs (ROADMAP Queue 3). Both prefix caches
    evict and reuse alike: one request at a time, both give 16 / 48
    (scripts/host_tier_race.py runs both ways)."""
    res = _device_tier_alone(tiny, group=1)
    assert res["port"] == res["jax"]
    # turn 1's first page survives the first wave, turn 2's first three
    # the second (LRU, the deepest link first)
    assert res["port"][0][5][3] == 16 and res["port"][0][10][3] == 48


def test_kv_offload_off_evicts_with_two_requests_live(tiny):
    """The same with each wave fed in pairs admitted together: the device
    tier evicts while two requests run, and tokens and reused rows
    request by request equal the JAX Engine's."""
    res = _device_tier_alone(tiny, group=2)
    assert res["port"] == res["jax"]
    # two live requests need more pages than one: turn 2 finds two of
    # turn 1's pages, turn 3 none of turn 2's
    assert res["port"][0][5][3] == 32 and res["port"][0][10][3] == 0


def _turn1_saved(tiny, make, path, dtype="float32"):
    """Engine A: turn 1, then a wave that offloads its chain; A saves the
    host tier at shutdown. Returns (turn 1's prompt, its tokens)."""
    rng = np.random.default_rng(31)
    a = rng.integers(2, 258, size=70).tolist()
    e = make(tiny, dtype, kv_host_store_path=path)
    try:
        ids = _drain(_submit(e, a, 6))[0]
        for o in [_submit(e, rng.integers(2, 258, size=n).tolist(), 10)
                  for n in (60, 62, 58, 61)]:
            _drain(o)
    finally:
        e.shutdown()
    return a, ids


def test_persistence_engine_b_restores_engine_a_chain(tiny, tmp_path):
    """Engine A saves the host tier at shutdown; engine B, a new engine
    with the same kv_host_store_path, loads it and turn 2 restores turn
    1's chain with A's tokens (A's own turn 2 as the reference)."""
    path = str(tmp_path / "store.npz")
    a, ids = _turn1_saved(tiny, port_engine, path)
    assert os.path.exists(path)
    ref = port_engine(tiny)
    try:
        # A's turn 2 on an engine of A's history: turn 1, the wave, turn 2
        rng = np.random.default_rng(31)
        rng.integers(2, 258, size=70)
        _drain(_submit(ref, a, 6))
        for o in [_submit(ref, rng.integers(2, 258, size=n).tolist(), 10)
                  for n in (60, 62, 58, 61)]:
            _drain(o)
        _settle(ref)
        t2 = a + ids + [9, 8, 7, 6, 5]
        want = _drain(_submit(ref, t2, 6))
    finally:
        ref.shutdown()
    b = port_engine(tiny, kv_host_store_path=path)
    try:
        st = b.metrics()["kv_offload"]
        assert st["pages"] >= 4 and st["offloaded_pages"] == 0
        got = _drain(_submit(b, t2, 6))
        assert got == want and got[3] == 64
        assert b.metrics()["kv_offload"]["restores"] == 1
    finally:
        b.shutdown()


def _held_back(e):
    """Hold ``e``'s admissions back (as if every slot were busy) until the
    returned Event is set; the loop goes on ticking."""
    gate, admit = threading.Event(), e._admit
    e._admit = lambda *a, **k: gate.is_set() and admit(*a, **k)
    return gate


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_prefetch_counts_match_jax(tiny, tmp_path, dtype):
    """A new engine loads a saved host tier (turn 1's chain) into a pool
    with room; turn 2 waits in the queue (admission held back), so the
    prefetch tick uploads its four links ahead of its admission, which
    claims them once let through. prefetch_issued / prefetch_hits /
    prefetch_late, the restores and the tokens equal the JAX Engine's, run
    the same way from a file its own engine A saved."""
    res = {}
    for name, make in (("port", port_engine), ("jax", jax_engine)):
        path = str(tmp_path / f"{name}.npz")
        a, ids = _turn1_saved(tiny, make, path, dtype)
        e = make(tiny, dtype, kv_host_store_path=path)
        try:
            gate = _held_back(e)
            out = _submit(e, a + ids + [9, 8, 7, 6, 5], 6)
            t_end = time.monotonic() + 120
            while (e.metrics()["kv_offload"]["prefetch_issued"] == 0
                   and time.monotonic() < t_end):
                e._wake.set()
                time.sleep(0.01)
            gate.set()
            e._wake.set()
            t2 = _drain(out)
            _settle(e)
            st = e.metrics()["kv_offload"]
            res[name] = (t2, {k: st[k] for k in (
                "prefetch_issued", "prefetch_hits", "prefetch_late",
                "prefetch_wasted", "restores", "restored_pages")})
        finally:
            e.shutdown()
    assert res["port"] == res["jax"]
    t2, st = res["port"]
    assert t2[3] == 64 and st["prefetch_issued"] == 4 and st["prefetch_hits"] == 4
    assert st["restores"] == 0 and st["prefetch_late"] == 0


def test_pages_in_use_ignores_prefetched_pages_and_counts_a_leak(tiny, tmp_path):
    """Driven tick by tick: turn 2 queued behind busy slots gets its links
    prefetched, then is cancelled. At idle the pipeline still holds them
    and ``pages_in_use`` is 0; a detached page never adopted counts 1."""
    path = str(tmp_path / "store.npz")
    a, ids = _turn1_saved(tiny, port_engine, path)
    e = port_engine(tiny, start=False, kv_host_store_path=path,
                    kv_pool_pages=32)
    try:
        rng = np.random.default_rng(5)
        outs = [_submit(e, rng.integers(2, 258, size=20).tolist(), 40)
                for _ in range(S)]
        assert e._tick() and all(s is not None for s in e.slots)
        _submit(e, a + ids + [9, 8, 7, 6, 5], 6, rid="turn2")
        e._tick()
        assert len(e._prefetch) == 4
        e.cancel("turn2")
        while e._tick():
            pass
        for o in outs:
            assert _drain(o)[2] == 40
        m = e.metrics()
        assert m["active_slots"] == 0 and m["queued"] == 0
        assert len(e._prefetch) == 4 and m["pages_in_use"] == 0
        assert m["kv_offload"]["prefetch_issued"] == 4
        leak = e._pool.alloc_detached()
        assert e.metrics()["pages_in_use"] == 1
        e._pool.unref_detached(leak)
        assert e.metrics()["pages_in_use"] == 0
    finally:
        e.shutdown()


def test_cancelled_request_chain_offloaded_then_restored(tiny):
    """A stream cancelled while decoding keeps its committed rows; the
    wave offloads them; a later request over them restores the chain and
    gives the cold engine's tokens."""
    e = port_engine(tiny, start=False)
    cold = port_engine(tiny, kv_prefix_cache=False)
    try:
        rng = np.random.default_rng(8)
        prompt = rng.integers(2, 258, size=60).tolist()
        req = teng.GenRequest(prompt_ids=prompt, max_new_tokens=90,
                              ignore_eos=True,
                              params=tsamp.SamplingParamsHost(temperature=0.0))
        out = e.submit(req)
        assert e._admit()
        while e._prefill_step():
            pass
        assert e._decode_burst()
        e.cancel(req.request_id)
        e._reap_cancelled()
        kept = list(e._cache_tokens[0])
        assert len(kept) > 64 and e._pcache.pages_held == 4
        while out.get(timeout=60) is not None:
            pass
        e.start()
        for o in [_submit(e, rng.integers(2, 258, size=n).tolist(), 10)
                  for n in (60, 62, 58, 61)]:
            _drain(o)
        _settle(e)
        assert e._hstore.pages >= 4
        follow = kept + rng.integers(2, 258, size=6).tolist()
        got = _drain(_submit(e, follow, 7))
        assert got[3] == 64 and e.metrics()["kv_offload"]["restores"] == 1
        assert got[0] == _drain(_submit(cold, follow, 7))[0]
    finally:
        e.shutdown()
        cold.shutdown()


@pytest.mark.parametrize("offload,pages", [(True, 48), (False, 64)])
def test_default_pool_cut_matches_jax(tiny, offload, pages):
    """4 slots x 256 / 16 = 64 pages: three quarters with the host tier,
    the full reservation without, as the JAX Engine sizes it; pools under
    64 pages keep the full reservation."""
    kw = dict(max_context=256, kv_pool_pages=0, kv_offload=offload)
    je = jax_engine(tiny, start=False, **kw)
    te = port_engine(tiny, start=False, **kw)
    try:
        assert te.metrics()["pages_total"] == je._pool.num_pages == pages
        assert te.ck["pages"].shape[1] == pages + 1     # + the scratch page
    finally:
        je.shutdown()
        te.shutdown()
    small = port_engine(tiny, start=False, kv_pool_pages=0, kv_offload=offload)
    assert small.metrics()["pages_total"] == S * C // PG
    small.shutdown()


def test_config_refuses_host_budget_and_prefetch_depth():
    for bad in (dict(kv_host_pool_mb=0), dict(kv_host_pool_mb=-5),
                dict(kv_prefetch_ahead=-1), dict(kv_host_pool_mb=True),
                dict(kv_prefetch_ahead=1.5)):
        with pytest.raises(ValueError):
            teng.EngineConfig(**bad).check()
    teng.EngineConfig(kv_host_pool_mb=1, kv_prefetch_ahead=0).check()


@pytest.mark.parametrize("bad", [dict(kv_host_pool_mb=0),
                                 dict(kv_prefetch_ahead=-1),
                                 dict(kv_offload="maybe")])
def test_load_model_refuses_before_weights_load(tmp_path, bad):
    """A config-only dir without random_weights raises FileNotFoundError
    when the weights load; these values are refused before that."""
    from localai_tpu_torch.backend.runner import load_model

    (tmp_path / "config.json").write_text(json.dumps({
        "vocab_size": 64, "hidden_size": 32, "intermediate_size": 64,
        "num_hidden_layers": 1, "num_attention_heads": 2,
        "num_key_value_heads": 1}))
    with pytest.raises(ValueError):
        load_model(str(tmp_path), device="cpu", **bad)
    with pytest.raises(FileNotFoundError):
        load_model(str(tmp_path), device="cpu")


def test_runner_options_parse_as_in_jax(tmp_path):
    from localai_tpu_torch.backend.runner import host_store_path, kv_offload_of

    for off in ("0", "false", "OFF", " no ", False):
        assert kv_offload_of(off) is False
    for on in ("1", "true", "on", "yes", "", True):
        assert kv_offload_of(on) is True
    assert host_store_path(str(tmp_path), "") == ""
    p = host_store_path(str(tmp_path), "kv.npz")
    assert p == os.path.join(str(tmp_path), "prompt_cache", "kv.npz")
    assert os.path.isdir(os.path.dirname(p))
    assert host_store_path(str(tmp_path), "/abs/kv.npz") == "/abs/kv.npz"


def test_cli_passes_the_host_tier_options():
    from localai_tpu_torch.cli import build_parser

    a = build_parser().parse_args(["run", "--model", "m", "--kv-offload", "0",
                                   "--kv-host-pool-mb", "64",
                                   "--kv-host-store", "s.npz"])
    assert (a.kv_offload, a.kv_host_pool_mb, a.kv_host_store) == ("0", 64, "s.npz")
    d = build_parser().parse_args(["run", "--model", "m"])
    assert (d.kv_offload, d.kv_host_pool_mb, d.kv_host_store) == ("1", 256, "")
