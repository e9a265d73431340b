"""Draft-model speculation in the port (``draft`` "auto" -> "model" when a
draft model is loaded) against the JAX package, on the CPU, over the f32
models of the JAX package's spec tests (``_cfg()``: vocab 258, hidden 64,
2 layers; the smaller draft of tests/test_speculative.py: hidden 32, 1
layer; and the target as its own draft):

  * ``speculative.draft_propose`` against the JAX ``draft_propose`` on
    paged float, paged int8 and contiguous caches: the same proposals on
    the speculating rows, the draft rows written within the ``_close``
    tolerances of tests/test_torch_parity.py (int8: one quantization
    level), nothing written for the other rows; ``spec_body`` with a draft
    against ``eager_rounds`` (the reference the card holds the captured
    round against);
  * the engine, paged / int8 KV / contiguous, with the same and the
    smaller draft, requests one at a time (the last a second turn that
    reuses the first's rows): greedy tokens equal the port's with
    speculation off and the JAX Engine's with the same draft, and the
    spec counters each request adds (rounds, proposed, accepted, tokens)
    equal the JAX Engine's. The reusing turn speculates paged and not on
    the contiguous layout (the JAX gate). With the unfused loop the
    target as its own draft accepts every proposal;
  * mixed traffic (a greedy and a sampled slot speculating together), a
    penalized request that writes no draft row, fork siblings (paged:
    sharing the draft planes; contiguous: forking the leader's draft
    rows), against the JAX Engine's tokens;
  * the host store's draft planes (a corrupt plane decays the entry to
    target-only, a later put re-attaches them), and the paged draft
    cache through offload and restore against the JAX Engine: the
    restored draft rows equal the offloaded ones, the slot keeps
    speculating, a corrupt draft plane still restores its target rows;
    the draft cache on the main page table, a page clone carrying its
    planes, and a prefetch uploading them ahead of an admission;
  * sampled rows with the draft: the JAX seed ladder against speculation
    off and against the JAX Engine, chi-square p > 0.01;
  * ``load_model(..., draft_model=...)`` with draft dirs the test writes
    (tests/tinymodel.py), and a completion through the HTTP server.
"""

from __future__ import annotations

import tests.torch_cpu  # noqa: F401  (one torch CPU thread)

import json
import os
import threading
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localai_tpu.engine import engine as jeng
from localai_tpu.engine import sampling as jsamp
from localai_tpu.engine import speculative as jspec
from localai_tpu.models import llama as jllama
from localai_tpu.ops import kvcache as jkv
from localai_tpu_torch.engine import engine as teng
from localai_tpu_torch.engine import sampling as tsamp
from localai_tpu_torch.engine import speculative as tspec
from localai_tpu_torch.engine import weights as tweights
from localai_tpu_torch.engine.decode_graph import DecodeGraph
from localai_tpu_torch.engine.kv_offload import HostPageStore
from localai_tpu_torch.models import llama as tllama
from localai_tpu_torch.ops import kvcache as tkv
from tests import test_torch_speculative as tsp
from tests.conftest import ByteTokenizer

ATOL, RTOL = tsp.ATOL, tsp.RTOL
TARGET = dict(vocab_size=258, hidden_size=64, intermediate_size=128,
              num_layers=2, num_heads=4, num_kv_heads=2,
              max_position_embeddings=256)
SMALL = dict(vocab_size=258, hidden_size=32, intermediate_size=64,
             num_layers=1, num_heads=2, num_kv_heads=1,
             max_position_embeddings=256)
SPEC_KEYS = ("rounds", "proposed", "accepted", "tokens")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _pair(cfg_kw: dict, seed: int) -> tuple:
    """(JAX config, JAX params, port config, port params) of one model."""
    jcfg = jllama.LlamaConfig(**cfg_kw, dtype=jnp.float32)
    jp = jllama.init_params(jcfg, jax.random.PRNGKey(seed), dtype=jnp.float32)
    tcfg = tllama.LlamaConfig(**cfg_kw, dtype=torch.float32)
    tp = tweights.from_jax_params(jax.tree.map(np.asarray, jp), tcfg,
                                  device="cpu")
    return jcfg, jp, tcfg, tp


@pytest.fixture(scope="module")
def models():
    target = _pair(TARGET, 0)
    # "same": the target as its own draft; "small": another shape
    return {"target": target, "same": target, "small": _pair(SMALL, 1)}


# ---------- draft_propose and the round ----------

D = 4


@pytest.mark.parametrize("draft", ("same", "small"))
@pytest.mark.parametrize("layout", tsp.LAYOUTS)
def test_draft_propose_matches_jax(models, layout, draft):
    """D + 1 greedy steps of the draft over its cache, speculating rows 0,
    2, 3: the same proposals as the JAX function, the same draft rows
    (the current token and every proposal written), none for row 1."""
    pair = models[draft]
    jcfg, jp, tcfg, tp = pair
    rng = np.random.default_rng(3)
    caches = tsp._caches(pair, layout, rng)
    prompts = [rng.integers(2, 258, size=n).astype(np.int32)
               for n in (9, 17, 4, 23)]
    jck, jcv, tck, tcv = tsp._prefill_both(pair, caches, prompts)
    lengths = np.asarray([len(p) for p in prompts], np.int32)
    tokens = rng.integers(2, 258, size=tsp.S)
    active = np.asarray([True, False, True, True])
    jd, jck, jcv = jspec.draft_propose(
        jp, jcfg, jnp.asarray(tokens, jnp.int32), jnp.asarray(lengths), jck, jcv,
        jnp.asarray(active), D)
    td = tspec.draft_propose(tp, tcfg, _t(tokens.astype(np.int64)), _t(lengths),
                             tck, tcv, _t(active), D)
    assert tuple(td.shape) == (tsp.S, D) and td.dtype == torch.int64
    np.testing.assert_array_equal(td.numpy()[active], np.asarray(jd)[active])
    for li in range(tcfg.num_layers):
        for jc, tc in ((jck, tck), (jcv, tcv)):
            jr = jkv.gather_all_rows(jkv.layer(jc, li))
            tr = tkv.gather_all_rows(tkv.layer(tc, li))
            if layout == "int8":
                assert np.abs(tr["q"].numpy().astype(np.int32)
                              - np.asarray(jr["q"]).astype(np.int32)).max() <= 1
            else:
                np.testing.assert_allclose(tr.numpy(), np.asarray(jr),
                                           atol=ATOL, rtol=RTOL)
    rows = tkv.gather_all_rows(tkv.layer(tck, 0))
    rows = rows["q"] if isinstance(rows, dict) else rows
    for s in range(tsp.S):
        n = int(lengths[s]) + (D + 1 if active[s] else 0)
        assert rows[s, n - 1].any() and not rows[s, n:].any(), s


def test_draft_round_equals_eager_rounds(models):
    """spec_body with the small draft (what the card captures) and
    eager_rounds (its reference) from the same state: ids and n_out bit
    for bit, logprobs within the float32 tolerance, the same chained
    state and draft rows; a seeded sampled spec row and a plain row
    beside a greedy spec row."""
    target, small = models["target"], models["small"]
    out = {}
    prompts = [np.asarray([3, 4, 5, 6] * 5, np.int32),
               np.asarray(np.random.default_rng(2).integers(2, 258, 13), np.int32),
               np.asarray(np.random.default_rng(4).integers(2, 258, 9), np.int32),
               np.asarray(np.random.default_rng(3).integers(2, 258, 6), np.int32)]
    for way in ("graph", "eager"):
        caches = tsp._caches(target, "paged", np.random.default_rng(1))
        _jk, _jv, tck, tcv = tsp._prefill_both(target, caches, prompts)
        dcaches = tsp._caches(small, "paged", np.random.default_rng(1))
        _jk, _jv, dck, dcv = tsp._prefill_both(small, dcaches, prompts)
        samp = tsamp.SlotSampler(tsp.S, 258, "cpu")
        g = DecodeGraph(target[3], target[2], tck, tcv, samp, tsp.S, 16, "cpu",
                        spec_width=D + 1, draft=(small[3], small[2], dck, dcv))
        for s in range(tsp.S):
            samp.set_slot(s, tsamp.SamplingParamsHost(
                temperature=0.9 if s == 2 else 0.0, seed=4), 0)
            samp.set_ring(s, prompts[s].tolist())
        tokens = np.asarray([6, 17, 9, 40])
        lengths = np.asarray([19, 12, 8, 5])
        active = np.asarray([True, True, True, False])
        spec = np.asarray([True, False, True, False])
        g.load(np.stack([active, np.ones(tsp.S), tokens, lengths, spec]
                        ).astype(np.int64))
        res = g.spec_replay(3).wait() if way == "graph" else g.spec_eager(3)
        out[way] = (res, g.tokens.numpy().copy(), g.lengths.numpy().copy(),
                    samp.counter.numpy().copy(),
                    tkv.gather_all_rows(tkv.layer(dck, 0)).numpy())
    (a, ta, la, ca, da), (b, tb, lb, cb, db) = out["graph"], out["eager"]
    W = D + 1
    np.testing.assert_array_equal(a[:, :W], b[:, :W])
    np.testing.assert_array_equal(a[:, 2 * W], b[:, 2 * W])
    np.testing.assert_allclose(a[:, W:2 * W], b[:, W:2 * W], atol=ATOL, rtol=RTOL)
    for x, y in ((ta, tb), (la, lb), (ca, cb)):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_allclose(da, db, atol=ATOL, rtol=RTOL)
    # the speculating rows wrote their draft rows past their prompt; the
    # plain and the idle rows wrote none
    assert da[0, 20:].any() and da[2, 9:].any()
    assert not da[1, 13:].any() and not da[3, 6:].any()


# ---------- the engine against the JAX Engine ----------

EC = dict(num_slots=2, max_context=128, prefill_buckets=(16, 32), prefill_chunk=32)
# (port knobs, JAX cache dtype, JAX layout)
LAYOUT = {"paged": ({}, jnp.float32, "paged"),
          "int8": ({"cache_dtype": torch.int8}, jnp.int8, "paged"),
          "contig": ({"kv_layout": "contiguous"}, jnp.float32, "contiguous")}
N_DRAFT = {"same": 4, "small": 3}     # the JAX tests' n_draft per draft


def jax_engine(models, layout="paged", draft="same", **knobs):
    jcfg, jp = models["target"][:2]
    _k, dt, lay = LAYOUT[layout]
    dj = models[draft][:2] if draft else None
    je = jeng.Engine(jcfg, jp, ByteTokenizer(), jeng.EngineConfig(
        **{**EC, "n_draft": N_DRAFT.get(draft, 4), **knobs}, cache_dtype=dt,
        kv_layout=lay), draft=dj)
    je.start()
    return je


def port_engine(models, layout="paged", draft="same", start=True, **knobs):
    """The port's engine with the ``draft`` model ("same" / "small"), or
    with speculation off (None)."""
    tcfg, tp = models["target"][2:]
    if draft is None:
        knobs.setdefault("draft", "0")
    k, _dt, _lay = LAYOUT[layout]
    dp = (models[draft][2], models[draft][3]) if draft else None
    e = teng.Engine(tcfg, tp, ByteTokenizer(), teng.EngineConfig(
        **{**EC, "n_draft": N_DRAFT.get(draft, 4), **knobs}, **k), device="cpu",
        draft=dp)
    return e.start() if start else e


def submit(e, prompt, n, **params):
    mod, samp = (teng, tsamp) if isinstance(e, teng.Engine) else (jeng, jsamp)
    return e.submit(mod.GenRequest(
        prompt_ids=list(prompt), max_new_tokens=n, ignore_eos=True,
        params=samp.SamplingParamsHost(**{"temperature": 0.0, **params})))


def submit_together(e, prompts, n, params=None) -> list:
    """Submit ``prompts`` with admission held, so the engine admits them in
    one pass (identical ones fork)."""
    params = params or [{}] * len(prompts)
    e._admit = lambda: False
    try:
        outs = [submit(e, p, n, **kw) for p, kw in zip(prompts, params)]
    finally:
        del e._admit                     # the class's method again
    e._wake.set()
    return outs


def drain(out) -> tuple:
    """(token ids, reused_prompt_tokens) of one stream."""
    ids, reused = [], None
    while (ev := out.get(timeout=600)) is not None:
        assert not ev.error, ev.error
        ids.extend(ev.token_ids or ([ev.token_id] if ev.token_id >= 0 else []))
        if ev.timings:
            reused = ev.timings["reused_prompt_tokens"]
    return ids, reused


def spec_counts(e) -> dict:
    st = e.metrics()["spec"]
    return {k: st[k] for k in SPEC_KEYS}


PROMPTS = ("speculate on this prompt", "abab abab abab ab",
           "a third request, a little longer than the first two")


def run_script(e) -> list:
    """Requests one at a time: per request its tokens, reused rows and the
    spec counters it added; the last a second turn of the first that
    reuses its rows."""
    tok = ByteTokenizer()
    res = []
    for prompt in [tok.encode(p) for p in PROMPTS] + [None]:
        if prompt is None:
            prompt = tok.encode(PROMPTS[0]) + res[0][0] + tok.encode(" and on")
        before = spec_counts(e)
        ids, reused = drain(submit(e, prompt, 24))
        after = spec_counts(e)
        res.append((ids, reused, {k: after[k] - before[k] for k in SPEC_KEYS}))
    return res


@pytest.fixture(scope="module", params=[(lay, d) for lay in LAYOUT
                                        for d in ("same", "small")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def scripted(request, models):
    layout, draft = request.param
    out = {"layout": layout, "draft": draft}
    for name, make, kw in (("jax", jax_engine, {"draft": draft}),
                           ("port", port_engine, {"draft": draft}),
                           ("off", port_engine, {"draft": None})):
        e = make(models, layout, **kw)
        try:
            out[name] = run_script(e)
            out[name + "_metrics"] = e.metrics()
            if name == "port":
                out["draft_rows"] = int(torch.count_nonzero(
                    (e.dck.get("pages") if "pages" in e.dck else e.dck["rows"])))
        finally:
            e.shutdown()
    return out


def test_greedy_tokens_equal_spec_off_and_the_jax_engine(scripted):
    port, jax_, off = scripted["port"], scripted["jax"], scripted["off"]
    for i, (got, want, plain) in enumerate(zip(port, jax_, off)):
        assert got[0] == want[0] == plain[0], (scripted["layout"], i)
        assert got[1] == want[1] and len(got[0]) == 24, (scripted["layout"], i)
    m = scripted["port_metrics"]
    assert m["spec"]["mode"] == "model" and m["spec"]["rounds"] > 0
    assert scripted["off_metrics"]["spec"]["mode"] == "off"
    assert scripted["draft_rows"] > 0
    assert m["active_slots"] == 0
    if scripted["layout"] != "contig":
        assert m["pages_in_use"] == 0


def test_spec_counters_equal_the_jax_engine_per_request(scripted):
    port, jax_ = scripted["port"], scripted["jax"]
    for i, (got, want) in enumerate(zip(port, jax_)):
        assert got[2] == want[2], (scripted["layout"], scripted["draft"], i)
    assert port[0][2]["rounds"] > 0
    # the second turn reuses the first's rows: the paged draft cache
    # shares them, so it speculates; the contiguous one has no draft
    # rows for them, so it does not (the JAX gate)
    assert port[3][1] > 0
    if scripted["layout"] == "contig":
        assert port[3][2]["rounds"] == 0
    else:
        assert port[3][2]["rounds"] > 0


@pytest.mark.parametrize("layout", ("paged", "contig"))
def test_own_draft_accepts_every_proposal_unfused(models, layout):
    """The target as its own draft, with the unfused loop (no plain burst
    leaves a hole in the draft rows): every proposal is accepted, on both
    engines, and the tokens are speculation off's."""
    got = {}
    for name, make in (("jax", jax_engine), ("port", port_engine)):
        e = make(models, layout, prefill_packed_fuse="0")
        try:
            ids = drain(submit(e, ByteTokenizer().encode(PROMPTS[0]), 24))[0]
            got[name] = (ids, spec_counts(e))
        finally:
            e.shutdown()
    assert got["port"] == got["jax"]
    st = got["port"][1]
    assert st["rounds"] > 0 and st["accepted"] == st["proposed"]


def test_mixed_traffic_speculates_per_slot(models):
    """A greedy and a sampled request decode together on the draft
    engine: the greedy stream equals speculation off's (and the JAX
    Engine's), the sampled one is whole, and both took model rounds."""
    tok = ByteTokenizer()
    got = {}
    for name, make, draft in (("jax", jax_engine, "same"),
                              ("port", port_engine, "same"),
                              ("off", port_engine, None)):
        e = make(models, draft=draft)
        try:
            outs = [submit(e, tok.encode("mixed traffic prompt"), 24),
                    submit(e, tok.encode("something else entirely"), 24,
                           temperature=1.0, seed=7)]
            got[name] = ([drain(o)[0] for o in outs], e.metrics()["spec"])
        finally:
            e.shutdown()
    (ids, st), (jids, _j), (plain, _p) = got["port"], got["jax"], got["off"]
    assert ids[0] == plain[0] == jids[0]
    assert len(ids[1]) == 24
    assert st["by_mode"]["greedy"]["rounds"] > 0
    assert st["by_mode"]["sampled"]["rounds"] > 0


def test_ineligible_only_traffic_writes_no_draft_row(models):
    """A penalized request never speculates: no pack is mirrored and no
    round runs, so the draft cache keeps every row zero (the JAX Engine
    never allocates its draft cache for such traffic)."""
    e = port_engine(models)
    try:
        ids, _r = drain(submit(e, ByteTokenizer().encode("penalized"), 8,
                               temperature=0.9, seed=3, repeat_penalty=1.1))
        assert len(ids) == 8
        assert e._spec_mode == "model" and e.metrics()["spec"]["rounds"] == 0
        assert not e.dck["pages"].any() and not e.dcv["pages"].any()
    finally:
        e.shutdown()


@pytest.mark.parametrize("layout", ("paged", "contig"))
def test_fork_siblings_with_the_draft(models, layout):
    """Two identical prompts admitted together (one prefill, the sibling
    forks): tokens equal the JAX Engine's; paged, the sibling shares the
    leader's pages (their draft planes included) and both speculate;
    contiguous, it copies the leader's draft rows and speculates since
    the leader does."""
    prompt = ByteTokenizer().encode("fork this prompt, fork this prompt")
    got, seen = {}, []
    for name, make in (("jax", jax_engine), ("port", port_engine)):
        e = make(models, layout)
        if name == "port":
            proc = e._process_fork_waiters

            def spy(leader, lsnap, proc=proc, e=e):
                sibs = list(e._fork_waiters.get(lsnap, ()))
                proc(leader, lsnap)
                for sib, s, _ids in sibs:
                    same = True
                    if layout == "contig":      # the leader's draft rows copied
                        n = s.reused
                        same = torch.equal(e.dck["rows"][:, sib, :n],
                                           e.dck["rows"][:, leader, :n])
                    seen.append((lsnap.spec_ok, s.spec_ok, s.reused, same))

            e._process_fork_waiters = spy
        try:
            got[name] = [drain(o)[0] for o in submit_together(e, [prompt] * 2, 20)]
            if name == "port":
                m = e.metrics()
                got["fork"], got["spec"] = m["fork"], m["spec"]
        finally:
            e.shutdown()
    assert [x[:2] for x in seen] == [(True, True)]
    assert seen[0][2] == len(prompt) - 1 and seen[0][3]
    assert got["port"] == got["jax"]
    assert got["port"][0] == got["port"][1]
    assert got["fork"]["forked"] == 1 and got["fork"]["rows_shared"] > 0
    assert got["spec"]["rounds"] > 0


def test_contiguous_sibling_of_an_ineligible_leader_does_not_speculate(models):
    """Contiguous layout: a sibling speculates only on draft rows forked
    from a leader that had them (the JAX rule)."""
    e = port_engine(models, "contig", start=False)
    prompt = ByteTokenizer().encode("fork this prompt once more")
    outs = [submit(e, prompt, 8, repeat_penalty=1.1), submit(e, prompt, 8)]
    seen = {}
    # both queued before the loop starts: admitted in one pass
    proc = e._process_fork_waiters

    def spy(leader, lsnap, proc=proc):
        sibs = list(e._fork_waiters.get(lsnap, ()))
        proc(leader, lsnap)
        for sib, s, _ids in sibs:
            seen[sib] = (lsnap.spec_ok, s.spec_ok)

    e._process_fork_waiters = spy
    e.start()
    try:
        for o in outs:
            assert len(drain(o)[0]) == 8
    finally:
        e.shutdown()
    assert list(seen.values()) == [(False, False)]


# ---------- the host tier's draft planes ----------

def _page(v):
    return np.full((2, 4, 2, 8), v, np.float32)


def test_host_store_draft_planes_decay_losslessly():
    """The JAX test: a corrupt draft plane decays the entry to target-only
    (the bytes follow), its target rows are untouched, and a later put of
    the same key re-attaches planes; the audit scan checks the draft CRC."""
    s = HostPageStore(tkv.page_scope(4, "unit"), 4, budget_mb=64)
    key = tkv.page_chain_hash(tkv.PAGE_HASH_ROOT, [1] * 4, s.scope)
    s.put(key, tkv.PAGE_HASH_ROOT, 0, _page(1), _page(2), dk=_page(3),
          dv=_page(4))
    e = s.get(key)
    assert e is not None and np.array_equal(e.dk, _page(3))
    assert s.audit_scan() == []
    b0 = s.bytes_used
    e.dk[...] = 77.0                       # flip bits in the draft plane
    assert [v["check"] for v in s.audit_scan()] == ["host_crc"]
    e2 = s.get(key)
    assert e2 is not None                  # the entry survives
    assert e2.dk is None and e2.dv is None
    assert np.array_equal(e2.k, _page(1))
    assert s.bytes_used == b0 - 2 * _page(0).nbytes
    assert s.audit_scan() == []
    s.put(key, tkv.PAGE_HASH_ROOT, 0, _page(1), _page(2), dk=_page(5),
          dv=_page(6))
    e3 = s.get(key)
    assert e3 is not None and np.array_equal(e3.dk, _page(5))
    assert s.pages == 1 and s.bytes_used == b0
    assert s.stats()["corrupt_dropped"] == 0


OFFLOAD = dict(num_slots=2, max_context=128, prefill_buckets=(16, 64),
               prefill_chunk=64, kv_page_size=16, kv_pool_pages=8,
               kv_offload=True, kv_host_pool_mb=64)


def _offload_script(e, corrupt: bool = False) -> dict:
    """The JAX test's sequence: conversation a, a churn of three requests
    (one slot's worth of pool: every admission evicts), then a again,
    restored from the host tier. Returns the tokens, the counters and
    (port) the draft planes offloaded and restored."""
    rng = np.random.default_rng(10)
    a = [int(x) for x in rng.integers(1, 120, size=48)]
    ref = drain(submit(e, a, 8))[0]
    churn = [drain(submit(e, [int(x) for x in rng.integers(1, 120, size=48)], 8))[0]
             for _ in range(3)]
    out = {"ref": ref, "churn": churn}
    port = isinstance(e, teng.Engine)
    if port:
        e._offloader.join()
        keys = list(e._pcache.chain_keys(a))[:3]
        ents = [e._hstore._entries[k] for k in keys]
        assert all(en.dk is not None for en in ents)
        out["planes"] = [(en.dk.copy(), en.dv.copy()) for en in ents]
        if corrupt:
            ents[0].dk.reshape(-1)[0] += 1.0
    else:
        t0 = time.monotonic()
        while e._hstore.pages < 3 and time.monotonic() - t0 < 60:
            time.sleep(0.02)
    st0 = e._hstore.stats()
    rounds0 = e.metrics()["spec"]["rounds"]
    got, reused = drain(submit(e, a, 8))
    st = e._hstore.stats()
    out.update(got=got, reused=reused, restores=st["restores"] - st0["restores"],
               restored=st["restored_pages"] - st0["restored_pages"],
               rounds=e.metrics()["spec"]["rounds"] - rounds0)
    if port:
        pages = [e._pcache._entries[k].page for k in keys]
        out["restored_planes"] = [
            (e.dck["pages"][:, p].numpy(), e.dcv["pages"][:, p].numpy())
            for p in pages]
        out["entries_with_planes"] = sum(
            e._hstore._entries[k].dk is not None for k in keys)
    return out


@pytest.mark.parametrize("corrupt", (False, True), ids=("clean", "corrupt"))
def test_paged_draft_cache_offload_restore_parity(models, corrupt):
    """The paged draft cache rides the host tier: the offloaded entries
    carry the draft planes, the restore puts them back byte for byte, the
    conversation's tokens equal the cold run's and the JAX Engine's, and
    the restored slot keeps speculating. With the first entry's draft
    plane corrupted, that entry decays to target-only and its target
    rows still restore (tokens unchanged; its draft rows stay cold)."""
    got = {}
    for name, make in (("jax", jax_engine), ("port", port_engine)):
        e = make(models, **OFFLOAD)
        try:
            assert e._spec_mode == "model"
            got[name] = _offload_script(e, corrupt and name == "port")
        finally:
            e.shutdown()
    port, ref = got["port"], got["jax"]
    assert port["ref"] == ref["ref"] and port["churn"] == ref["churn"]
    assert port["got"] == port["ref"] == ref["got"]
    assert port["reused"] == ref["reused"] >= 16
    assert port["restores"] == ref["restores"] == 1
    assert port["restored"] == ref["restored"] >= 1
    assert port["rounds"] > 0 and ref["rounds"] > 0
    first = 1 if corrupt else 0
    for (dk, dv), (rk, rv) in list(zip(port["planes"], port["restored_planes"]))[first:]:
        assert np.array_equal(dk, rk) and np.array_equal(dv, rv)
    assert port["entries_with_planes"] == 3 - first


@pytest.mark.parametrize("layout", ("paged", "int8"))
def test_draft_cache_rides_the_page_table_and_clones(models, layout):
    """The paged draft cache holds the main page table itself (so
    ``_commit_ptab``'s in-place rewrite reaches it), and a page clone
    (copy-on-write, a fork's boundary page) copies its draft planes with
    the target's, int8 scales included."""
    e = port_engine(models, layout, start=False)
    try:
        assert e.dck["ptab"] is e.ck["ptab"] and e.dcv["ptab"] is e.ck["ptab"]
        gen = torch.Generator().manual_seed(0)
        caches = (e.ck, e.cv, e.dck, e.dcv)
        for c in caches:
            for k in ("pages", "scales"):
                if k in c:
                    c[k].copy_(torch.randint(-100, 100, c[k].shape, generator=gen)
                               .to(c[k].dtype))
        e._clone_page(1, 3)
        for c in caches:
            for k in ("pages", "scales"):
                if k in c:
                    assert torch.equal(c[k][:, 3], c[k][:, 1]), k
        e._pool.ptab[0, 0] = 2
        e._pool.dirty = True
        e._commit_ptab()
        assert int(e.dck["ptab"][0, 0]) == 2
    finally:
        e.shutdown()


def test_prefetch_uploads_the_draft_planes(models):
    """A queued turn whose chain is in the host tier: the prefetch tick
    uploads its links into detached pages with their draft planes (the
    draft pages equal the host entries'), its admission claims them, its
    tokens are speculation off's, and it speculates. The loop is driven
    tick by tick on the test's thread."""
    prompt = [int(x) for x in np.random.default_rng(12).integers(1, 250, size=48)]
    got = {}
    for draft in ("same", None):
        e = port_engine(models, draft=draft, start=False, emitter=False,
                        **{**OFFLOAD, "kv_pool_pages": 12})
        try:
            def run(ids, n, e=e):
                out = submit(e, ids, n)
                while e._tick():
                    pass
                return drain(out)[0]

            first = run(prompt, 8)
            turn2 = prompt + first + [5, 6, 7]
            # every retained page leaves the card: offloaded with its planes
            e._reclaim_pages((), e._pool.num_pages)
            e._offloader.join()
            e._admit = lambda: False
            out = submit(e, turn2, 8)
            e._tick()
            pf = e._prefetch.pages
            assert len(pf) == 3
            if draft:
                for key, rec in pf.items():
                    ent = e._hstore._entries[key]
                    assert ent.dk is not None
                    assert np.array_equal(e.dck["pages"][:, rec[0]].numpy(), ent.dk)
                    assert np.array_equal(e.dcv["pages"][:, rec[0]].numpy(), ent.dv)
            del e._admit
            r0 = e.metrics()["spec"]["rounds"]
            while e._tick():
                pass
            e._offloader.join()
            st = e.metrics()["kv_offload"]
            got[draft] = (drain(out)[0], st["prefetch_hits"], st["restores"],
                          e.metrics()["spec"]["rounds"] - r0)
        finally:
            e.shutdown()
    ids, hits, restores, rounds = got["same"]
    assert ids == got[None][0] and hits == got[None][1] == 3
    assert restores == 0 and rounds > 0


# ---------- sampled rows ----------

PROMPT = "the cat sat on the mat. the cat sat on the mat. the cat sat"


def _ladder(e) -> tuple:
    """The JAX test's seed ladder: 10 seeds x 40 tokens (top_k 16), token
    counts and the sampled spec counters."""
    V = 258
    counts = np.zeros((V,), np.int64)
    try:
        for s in range(10):
            ids = drain(submit(e, ByteTokenizer().encode(PROMPT), 40,
                               temperature=0.8, seed=s, top_k=16))[0]
            assert len(ids) == 40
            counts += np.bincount(ids, minlength=V)[:V]
        return counts, dict(e.metrics()["spec"]["by_mode"]["sampled"])
    finally:
        e.shutdown()


def test_sampled_seed_ladder_chi_square_against_spec_off_and_jax(models):
    on, bm = _ladder(port_engine(models, draft="small", decode_burst=8))
    off, bm_off = _ladder(port_engine(models, draft=None, decode_burst=8))
    jon, jbm = _ladder(jax_engine(models, draft="small", decode_burst=8))
    assert bm["rounds"] > 0 and jbm["rounds"] > 0 and bm_off["rounds"] == 0
    assert int(on.sum()) == int(off.sum()) == int(jon.sum()) == 400
    for other in (off, jon):
        stat, dof, p = tspec.two_sample_chi2(on, other)
        assert dof >= 1 and p > 0.01, (stat, dof, p)


# ---------- the runner and the server ----------

def _write_draft(dst: str, weights_too: bool):
    """A smaller llama of the tiny checkpoint's vocabulary (config.json,
    and with ``weights_too`` its safetensors)."""
    from localai_tpu.engine import weights as jweights
    from tests.tinymodel import TINY_HF_CONFIG

    hf = dict(TINY_HF_CONFIG, hidden_size=32, intermediate_size=64,
              num_hidden_layers=1, num_attention_heads=2, num_key_value_heads=1)
    os.makedirs(dst, exist_ok=True)
    with open(os.path.join(dst, "config.json"), "w") as f:
        json.dump(hf, f)
    if weights_too:
        cfg = jllama.LlamaConfig.from_hf_config(hf, dtype=jnp.float32)
        jweights.save_llama_params(jllama.init_params(cfg, jax.random.PRNGKey(5)),
                                   cfg, dst)


def test_load_model_with_a_draft_model_serves_over_http(tmp_path):
    """load_model(dir, draft_model=...) with a safetensors draft dir
    (relative to the model dir): draft "auto" resolves to "model", the
    draft's weights are the file's, greedy tokens equal speculation off's,
    and a completion through the HTTP server speculates. A config-only
    draft dir with random_weights loads too; a vocabulary other than the
    target's is refused."""
    from localai_tpu_torch.api.app import App, make_server
    from localai_tpu_torch.backend import runner
    from tests.tinymodel import write_tiny_checkpoint

    d = str(tmp_path / "model")
    write_tiny_checkpoint(d)
    _write_draft(os.path.join(d, "draft"), weights_too=True)
    kw = dict(device="cpu", dtype="float32", num_slots=2, context_size=128,
              kv_page_size=16, prefill_chunk=32, prefill_packed_fuse="0")
    lm = runner.load_model(d, "tiny", draft_model="draft", **kw)
    off = runner.load_model(d, "tiny", draft="0", **kw)
    try:
        e = lm.engine
        assert e._spec_mode == "model" and e.metrics()["spec"]["mode"] == "model"
        assert e.draft_cfg.num_layers == 1 and e.draft_cfg.hidden_size == 32
        prompt = lm.tokenizer.encode("draft me a sentence")
        assert drain(submit(e, prompt, 16))[0] == drain(submit(off.engine, prompt, 16))[0]
        app = App({lm.name: lm})
        server = make_server(app, "127.0.0.1", 0)
        th = threading.Thread(target=server.serve_forever, daemon=True)
        th.start()
        try:
            r0 = e.metrics()["spec"]["rounds"]
            req = urllib.request.Request(
                f"http://127.0.0.1:{server.server_address[1]}/v1/completions",
                data=json.dumps({"model": "tiny", "prompt": "hello there",
                                 "max_tokens": 12, "temperature": 0,
                                 "ignore_eos": True}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as resp:
                body = json.loads(resp.read())
            assert body["usage"]["completion_tokens"] == 12
            assert e.metrics()["spec"]["rounds"] > r0
        finally:
            server.shutdown()
            server.server_close()
    finally:
        lm.engine.shutdown()
        off.engine.shutdown()
    _write_draft(str(tmp_path / "cfg_only"), weights_too=False)
    lm = runner.load_model(d, "tiny", draft_model=str(tmp_path / "cfg_only"),
                           random_weights=0, **kw)
    try:
        assert lm.engine._spec_mode == "model"
    finally:
        lm.engine.shutdown()
    with open(tmp_path / "cfg_only" / "config.json") as f:
        hf = json.load(f)
    with open(tmp_path / "cfg_only" / "config.json", "w") as f:
        json.dump(dict(hf, vocab_size=300), f)
    with pytest.raises(ValueError, match="vocabulary"):
        runner.load_model(d, "tiny", draft_model=str(tmp_path / "cfg_only"),
                          random_weights=0, **kw)
