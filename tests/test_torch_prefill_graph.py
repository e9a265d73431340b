"""The packed prefill padded to a total-token bucket and captured as one
CUDA graph per (bucket, continued) (engine/prefill_graph.py), with the
first tokens sampled on the device (``SlotSampler.sample_rows``).

On the CPU (tolerances: ``_close`` of tests/test_torch_parity.py, atol
2e-4 and rtol 2e-3, where float32 sums may be reordered; everything else
exact):
  * ``Engine._pack_buckets`` equals the JAX Engine's for several
    (prefill_buckets, chunk, budget, context), and ``EngineConfig``
    carries the JAX default (32, 128, 512, 2048);
  * a pack padded to its bucket gives the exact-size pack's logits and
    KV rows (within ``_close``), fresh, continued and over int8 pages;
  * an all-pad pack (the capture's warm-up) leaves every cache byte, the
    page table and the sampler counters as they were, in every layout;
  * ``sample_rows`` over a padded pack equals ``sample`` over the finals
    (ids, logprobs, counters), seeded sampled rows, non-final rows and
    pads included;
  * on the tiny f32 checkpoint, request by request, the greedy tokens,
    the ``packed_prefill`` dispatches / tokens / ``pad_tokens`` and
    ``reused_prompt_tokens`` equal the JAX Engine's (prefix reuse on,
    ``prefill_packed_fuse="0"`` on both), paged, int8 KV and contiguous.

On the card (``cuda`` marker; skips here), small hd-128 models: every
(bucket, continued) replay equals the eager pack at the same bucket bit
for bit (ids, logprobs, logits, cache rows, counters), paged and int8, f32
and bf16; a pack with no graph raises; LAUNCHES counts K2 / K2-int8 /
W8 through the replays; an Engine captures every pair at start and
serves every pack as a replay. On the card's machine (no JAX, which
only the CPU tests import):

    python -m pytest --noconftest tests/test_torch_prefill_graph.py -q -m cuda
"""

from __future__ import annotations

import tests.torch_cpu  # noqa: F401  (one torch CPU thread)

import json
import os

import numpy as np
import pytest
import torch

from localai_tpu_torch.engine import engine as teng
from localai_tpu_torch.engine import prefill_graph as pg
from localai_tpu_torch.engine import sampling as tsamp
from localai_tpu_torch.engine import weights as tweights
from localai_tpu_torch.engine.weights import random_params
from localai_tpu_torch.models import llama
from localai_tpu_torch.ops.kernels import LAUNCHES

S, C, PG = 4, 64, 16


def _close(ours, ref, what=""):
    np.testing.assert_allclose(np.asarray(ours, np.float32),
                               np.asarray(ref, np.float32),
                               atol=2e-4, rtol=2e-3, err_msg=what)


class _Tok:
    eos_token_id = 1

    def decode(self, ids, **kw):
        return "".join(chr(97 + (i % 26)) for i in ids)


# ---------- the bucket rule ----------

@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """(JAX config, JAX params, port config, port params) of the tiny f32
    checkpoint."""
    import jax
    import jax.numpy as jnp

    from localai_tpu.engine import weights as jweights
    from localai_tpu.models import llama as jllama
    from tests.tinymodel import write_tiny_checkpoint

    d = str(tmp_path_factory.mktemp("tiny_prefill_graph"))
    write_tiny_checkpoint(d)
    with open(os.path.join(d, "config.json")) as f:
        hf = json.load(f)
    jcfg = jllama.LlamaConfig.from_hf_config(hf, dtype=jnp.float32)
    jparams = jweights.load_llama_params(d, jcfg, dtype=jnp.float32)
    tcfg = llama.LlamaConfig.from_hf_config(hf, dtype=torch.float32)
    tparams = tweights.from_jax_params(jax.tree.map(np.asarray, jparams),
                                       tcfg, device="cpu")
    return jcfg, jparams, tcfg, tparams


def test_engine_config_carries_the_jax_default():
    from localai_tpu.engine import engine as jeng

    assert teng.EngineConfig().prefill_buckets == jeng.EngineConfig().prefill_buckets
    assert teng.EngineConfig().prefill_buckets == (32, 128, 512, 2048)


@pytest.mark.parametrize("buckets,chunk,budget,context", [
    ((32, 128, 512, 2048), 512, 0, 4096),     # chip_smoke: (32, 128, 512, 1024)
    ((32, 128, 512, 2048), 16, 0, 128),
    ((8, 16, 32), 32, 0, 128),
    ((8, 16, 32, 100), 32, 48, 128),
    ((16, 64), 512, 0, 256),                  # chunk and budget capped by C
    ((4, 12), 12, 40, 64),
])
def test_pack_buckets_equal_the_jax_engine(tiny, buckets, chunk, budget, context):
    import jax.numpy as jnp

    from localai_tpu.engine import engine as jeng

    jcfg, jparams, tcfg, tparams = tiny
    je = jeng.Engine(jcfg, jparams, _Tok(), jeng.EngineConfig(
        num_slots=2, max_context=context, prefill_buckets=buckets,
        prefill_chunk=chunk, prefill_token_budget=budget,
        cache_dtype=jnp.float32, kv_page_size=16, kv_offload=False,
        draft="0"))
    try:
        want = je._pack_buckets
    finally:
        je.shutdown()
    te = teng.Engine(tcfg, tparams, _Tok(), teng.EngineConfig(
        num_slots=2, max_context=context, prefill_buckets=buckets,
        prefill_chunk=chunk, prefill_token_budget=budget, kv_page_size=16,
        kv_offload=False, draft="0"), device="cpu")
    assert te._pack_buckets == tuple(want)
    assert te.metrics()["prefill_graph"]["buckets"] == list(want)
    assert sorted(te._pgraph.buf) == list(want)


# ---------- a small model, packs at the bucket and at the exact size ----------

def _model(kind: str, device, head_dim: int = 8, dtype=torch.float32, seed=0):
    hd = head_dim
    cfg = llama.LlamaConfig(vocab_size=96, hidden_size=4 * hd,
                            intermediate_size=8 * hd, num_layers=2,
                            num_heads=4, num_kv_heads=2, head_dim=hd,
                            rope_theta=500000.0, dtype=dtype)
    quant = {"w8kv8": "int8", "w4": "int4"}.get(kind, "")
    return cfg, random_params(cfg, seed, device=device, quantize=quant)


def _caches(cfg, kind: str, device):
    if kind == "contig":
        return llama.init_cache(cfg, S, C, 0, device=device)
    ck, cv = llama.init_cache(
        cfg, S, C, PG, dtype=torch.int8 if kind in ("int8", "w8kv8") else None,
        device=device)
    # a scrambled table, ONE tensor for K and V (as the engine keeps it)
    ptab = torch.arange(S * C // PG, dtype=torch.int32).flip(0).reshape(S, -1)
    ck["ptab"] = cv["ptab"] = ptab.to(device)
    return ck, cv


def _sampler(device, sampled=(1,)):
    sm = tsamp.SlotSampler(S, 96, device)
    for s in range(S):
        sm.set_slot(s, tsamp.SamplingParamsHost(
            temperature=1.0 if s in sampled else 0.0, top_k=0, top_p=1.0,
            seed=77 + s), fallback_seed=0)
    return sm


def _pack(bucket: int, segs, seed: int, vocab: int = 96) -> np.ndarray:
    """A host pack of ``segs`` = [(slot, start, n, final)] in that order
    (finals first), seeded tokens, padded to ``bucket``."""
    rng = np.random.default_rng(seed)
    host = pg.new_pack(bucket, S, C)
    v = pg.split_pack(host, bucket, S)
    off = 0
    for b, (slot, start, n, final) in enumerate(segs):
        v["tokens"][off:off + n] = rng.integers(2, vocab, n)
        v["positions"][off:off + n] = np.arange(start, start + n)
        v["seg_of"][off:off + n] = b
        v["seg_slots"][b], v["seg_start"][b] = slot, start
        v["seg_off"][b], v["seg_len"][b] = off, n
        v["final_mask"][b] = final
        off += n
    assert off <= bucket
    return host


# (bucket, segments, continued): a fresh pack with a non-final segment,
# then a continued one over its rows and a fresh slot
PACKS = [(64, [(0, 0, 11, True), (2, 0, 5, True), (1, 0, 20, False)], False),
         (32, [(1, 20, 9, True), (3, 0, 7, True)], True)]


def _store(cache: dict) -> dict:
    return {k: v[:, :-1].clone() for k, v in cache.items() if k not in ("ptab", "itab")}


@pytest.mark.parametrize("kind", ("paged", "int8", "contig"))
def test_padded_pack_equals_the_exact_size_pack(kind):
    cfg, params = _model(kind, "cpu")
    runs = {}
    for exact in (True, False):
        ck, cv = _caches(cfg, kind, "cpu")
        sm = _sampler("cpu", sampled=())
        res = []
        for i, (bucket, segs, continued) in enumerate(PACKS):
            host = _pack(bucket, segs, seed=i)
            out, logits = pg.eager_pack(params, cfg, ck, cv, sm, host, bucket,
                                        S, continued, exact=exact)
            assert logits.shape[0] == S
            res.append((out, logits[:len(segs)]))
        runs[exact] = (res, _store(ck), _store(cv))
    (ra, ka, va), (rb, kb, vb) = runs[True], runs[False]
    for (oa, la), (ob, lb) in zip(ra, rb):
        np.testing.assert_array_equal(oa[0], ob[0])         # greedy ids
        _close(la.numpy(), lb.numpy(), "logits")
        _close(oa[1], ob[1], "logprobs")
    for x, y in ((ka, kb), (va, vb)):
        for k in x:
            if kind in ("int8",) and k == "pages":
                # int8 rows: a value may round one level apart where the
                # float32 projections differ in the last bits
                assert (x[k].to(torch.int32) - y[k].to(torch.int32)).abs().max() <= 1
            else:
                _close(x[k].numpy(), y[k].numpy(), k)


@pytest.mark.parametrize("kind", ("paged", "int8", "contig", "w8kv8", "w4"))
def test_all_pad_pack_changes_nothing(kind):
    """The capture's warm-up pack: every (bucket, continued) body on an
    all-pad pack leaves the cache (scratch page / slot aside), the page
    table and the counters as they were."""
    cfg, params = _model(kind, "cpu")
    ck, cv = _caches(cfg, kind, "cpu")
    sm = _sampler("cpu")
    out, _logits = pg.eager_pack(params, cfg, ck, cv, sm, _pack(*PACKS[0][:2], seed=0),
                                 PACKS[0][0], S, False)
    sm.counter.copy_(torch.tensor([3, 5, 0, 2]))
    before = (_store(ck), _store(cv), ck.get("ptab", ck.get("itab")).clone(),
              sm.counter.clone())
    graph = pg.PrefillGraph(params, cfg, ck, cv, sm, S, C, (8, 32), "cpu")
    for bucket in (8, 32):
        v = pg.split_pack(graph.buf[bucket], bucket, S)
        assert (v["positions"] == C).all() and (v["seg_slots"] == S).all()
        assert (v["seg_of"] == S).all() and not v["final_mask"].any()
        for continued in (False, True):
            graph.body(bucket, continued)
    after = (_store(ck), _store(cv), ck.get("ptab", ck.get("itab")), sm.counter)
    for a, b in zip(before[:2], after[:2]):
        for k in a:
            assert torch.equal(a[k], b[k]), k
    assert torch.equal(before[2], after[2]) and torch.equal(before[3], after[3])


def test_sample_rows_equals_the_list_sampler():
    """Rows 0-2 final (greedy, seeded-sampled, sampled with top-k / top-p),
    row 3 a real non-final segment, rows 4-5 pads (the sentinel slot):
    ``sample_rows`` gives the finals the ids and logprobs ``sample`` gives
    them, and the same counters."""
    rng = np.random.default_rng(8)
    R, SL = 6, 5
    logits = torch.from_numpy(rng.normal(size=(R, 300)).astype(np.float32) * 3)
    a, b = tsamp.SlotSampler(SL, 300, "cpu"), tsamp.SlotSampler(SL, 300, "cpu")
    for sm in (a, b):
        for s, (t, k, p) in enumerate([(0.0, 40, 0.95), (0.7, 0, 1.0),
                                       (1.3, 20, 0.8), (1.0, 0, 1.0),
                                       (0.9, 300, 0.99)]):
            sm.set_slot(s, tsamp.SamplingParamsHost(temperature=t, top_k=k,
                                                    top_p=p, seed=11 * s + 1),
                        fallback_seed=0)
        sm.counter.copy_(torch.tensor([4, 0, 7, 2, 9]))
    seg_slots = torch.tensor([0, 1, 4, 2, SL, SL], dtype=torch.int32)
    final = torch.tensor([True, True, True, False, False, False])
    for _ in range(3):
        ia, la = a.sample_rows(logits, seg_slots, final)
        ib, lb = b.sample(logits[:3], [0, 1, 4])
        np.testing.assert_array_equal(ia[:3].numpy(), ib.numpy())
        np.testing.assert_array_equal(la[:3].numpy(), lb.numpy())
        np.testing.assert_array_equal(a.counter.numpy(), b.counter.numpy())
    # slot 3 greedy: no draws; slots 1 and 4 drew three times; the
    # non-final slot 2 and the pads' clamped slot 4 gained nothing more
    assert a.counter.tolist() == [4, 3, 7, 2, 12]


# ---------- the engine against the JAX Engine, request by request ----------

EC = dict(num_slots=S, max_context=128, prefill_buckets=(8, 16, 32),
          prefill_chunk=32, kv_page_size=PG)
# (port knobs, JAX knobs: its cache dtype by name, its layout)
LAYOUTS = {"paged": ({}, ("float32", "paged")),
           "int8": ({"cache_dtype": torch.int8}, ("int8", "paged")),
           "contig": ({"kv_layout": "contiguous"}, ("float32", "contiguous"))}


def _requests(engine, mod, samp, seed: int = 5) -> list:
    """Sequential greedy requests: a short prompt, one split into a fresh
    and a continued pack, its next turn (prefix reuse), a three-pack
    prompt, and a prompt sharing another's first rows. Per request:
    (tokens, reused_prompt_tokens, packed_prefill deltas)."""
    rng = np.random.default_rng(seed)

    def draw(n):
        return rng.integers(2, 258, size=n).tolist()

    def run(ids, n):
        m0 = engine.metrics()["packed_prefill"]
        out = engine.submit(mod.GenRequest(
            prompt_ids=list(ids), max_new_tokens=n, ignore_eos=True,
            params=samp.SamplingParamsHost(temperature=0.0)))
        toks, reused = [], None
        while (ev := out.get(timeout=600)) is not None:
            assert not ev.error, ev.error
            toks.extend(ev.token_ids or ([ev.token_id] if ev.token_id >= 0 else []))
            if ev.timings:
                reused = ev.timings["reused_prompt_tokens"]
        m1 = engine.metrics()["packed_prefill"]
        return toks, reused, {k: m1[k] - m0[k] for k in ("dispatches", "tokens",
                                                        "pad_tokens")}

    res = [run(draw(5), 4)]
    b = draw(40)
    res.append(run(b, 6))
    res.append(run(b + res[-1][0] + draw(13), 5))
    c = draw(70)
    res.append(run(c, 3))
    res.append(run(c[:48] + draw(9), 4))
    return res


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_engine_matches_the_jax_engine_request_by_request(tiny, layout):
    import jax.numpy as jnp

    from localai_tpu.engine import engine as jeng
    from localai_tpu.engine import sampling as jsamp

    jcfg, jparams, tcfg, tparams = tiny
    tk, (jdtype, jlayout) = LAYOUTS[layout]
    je = jeng.Engine(jcfg, jparams, _Tok(), jeng.EngineConfig(
        **EC, kv_layout=jlayout, cache_dtype=getattr(jnp, jdtype),
        kv_prefix_cache=True, kv_offload=False, prefill_packed_fuse="0",
        draft="0"))
    te = teng.Engine(tcfg, tparams, _Tok(), teng.EngineConfig(
        **EC, decode_burst=16, kv_prefix_cache=True, prefill_packed_fuse="0",
        kv_offload=False, draft="0", **tk), device="cpu")
    je.start()
    te.start()
    try:
        want = _requests(je, jeng, jsamp)
        got = _requests(te, teng, tsamp)
    finally:
        je.shutdown()
        te.shutdown()
    assert te._pack_buckets == (8, 16, 32, 64)
    assert got == want
    # the script really padded, continued and reused
    assert sum(r[2]["pad_tokens"] for r in got) > 0
    assert got[1][2]["dispatches"] == 2 and got[3][2]["dispatches"] == 3
    assert got[2][1] > 0


# ---------- on the card ----------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the prefill graphs are captured on the card")


K2 = {"paged": "ragged_prefill_attention", "int8": "ragged_prefill_attention_int8",
      "w8kv8": "ragged_prefill_attention_int8"}


@pytest.mark.cuda
@pytest.mark.parametrize("kind,dtype", [("paged", "float32"), ("int8", "float32"),
                                        ("paged", "bfloat16"), ("w8kv8", "bfloat16")])
def test_replay_equals_the_eager_pack_at_the_same_bucket(card, kind, dtype):
    """Every (bucket, continued) pair: the pack replayed through its graph
    and the eager pack at the same bucket, from twin states, give the same
    ids, logprobs, logits, cache rows and counters, bit for bit; the
    prefill kernel's launches, counted through the replays, are layers x
    packs."""
    from localai_tpu_torch.ops.kernels import reset_launches

    cfg, params = _model(kind, "cuda", head_dim=128, dtype=getattr(torch, dtype))
    buckets = (8, 32, 64)
    states = {}
    for side in ("graph", "eager"):
        ck, cv = _caches(cfg, kind, "cuda")
        states[side] = (ck, cv, _sampler("cuda"))
    ck, cv, sm = states["graph"]
    graph = pg.PrefillGraph(params, cfg, ck, cv, sm, S, C, buckets, "cuda")
    graph.capture()
    assert sorted(graph.graphs) == [(b, c) for b in buckets for c in (False, True)]
    assert all(graph.launches.values())
    # fresh packs at each bucket on slots 0-2, then continued ones over them
    packs = [(8, [(0, 0, 3, False), (2, 0, 4, False)], False),
             (32, [(1, 0, 20, True), (3, 0, 9, True)], False),
             (64, [(0, 3, 40, True), (2, 4, 14, False)], True),
             (8, [(2, 18, 5, True)], True),
             (32, [(1, 20, 12, True)], True),
             (64, [(0, 0, 33, True)], False)]
    name = K2.get(kind, "ragged_prefill_attention")
    for side in ("graph", "eager"):
        k_c, v_c, s_c = states[side]
        reset_launches()
        outs = []
        for i, (bucket, segs, continued) in enumerate(packs):
            host = _pack(bucket, segs, seed=i)
            if side == "graph":
                out = graph.run(bucket, continued, host)
                logits = graph.logits.clone()
            else:
                out, logits = pg.eager_pack(params, cfg, k_c, v_c, s_c, host,
                                            bucket, S, continued)
            outs.append((out, logits[:len(segs)].cpu()))
        torch.cuda.synchronize()
        fresh = sum(1 for _b, _s, c in packs if not c)
        want = cfg.num_layers * (len(packs) if kind == "paged" else len(packs) - fresh)
        assert LAUNCHES[name] == want, (side, dict(LAUNCHES))
        states[side] = (k_c, v_c, s_c, outs)
    (gk, gv, gs, go), (ek, ev, es, eo) = states["graph"], states["eager"]
    for (oa, la), (ob, lb) in zip(go, eo):
        np.testing.assert_array_equal(oa, ob)
        assert torch.equal(la, lb)
    for a, b in ((gk, ek), (gv, ev)):
        for k in a:
            if k != "ptab":
                assert torch.equal(a[k][:, :-1], b[k][:, :-1]), k
    assert torch.equal(gs.counter, es.counter)
    assert gs.counter.tolist()[1] == 2       # slot 1 sampled, final twice


@pytest.mark.cuda
def test_a_pack_without_its_graph_raises(card):
    cfg, params = _model("paged", "cuda", head_dim=128)
    ck, cv = _caches(cfg, "paged", "cuda")
    graph = pg.PrefillGraph(params, cfg, ck, cv, _sampler("cuda"), S, C, (8,), "cuda")
    with pytest.raises(RuntimeError, match="no prefill graph"):
        graph.run(8, False, _pack(8, [(0, 0, 4, True)], seed=0))
    graph.capture()
    with pytest.raises(RuntimeError, match="no prefill graph"):
        graph.run(16, False, _pack(16, [(0, 0, 4, True)], seed=0))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ("paged", "int8", "contig"))
def test_engine_captures_every_pair_and_serves_packs_as_replays(card, kind):
    from localai_tpu_torch.ops.kernels import reset_launches

    cfg, params = _model(kind, "cuda", head_dim=128)
    e = teng.Engine(cfg, params, _Tok(), teng.EngineConfig(
        num_slots=S, max_context=128, prefill_chunk=16, kv_page_size=16,
        prefill_buckets=(8, 16), cache_dtype=torch.int8 if kind == "int8" else None,
        kv_layout="contiguous" if kind == "contig" else "auto", draft="0"),
        device="cuda").start()
    try:
        m = e.metrics()["prefill_graph"]
        assert e._pack_buckets == (8, 16, 32)
        assert m["captured"] == [(b, c) for b in (8, 16, 32) for c in (False, True)]
        assert m["capture_seconds"] > 0 and m["pool_bytes"] > 0
        replays = []
        run = e._pgraph.dispatch

        def counted(bucket, continued, host):
            replays.append((bucket, continued))
            return run(bucket, continued, host)

        e._pgraph.dispatch = counted
        reset_launches()
        _text, events = e.generate_text(teng.GenRequest(
            prompt_ids=list(range(2, 42)), max_new_tokens=4, ignore_eos=True,
            params=tsamp.SamplingParamsHost(temperature=0.0)))
        torch.cuda.synchronize()
        assert events[-1].completion_tokens == 4
        pk = e.metrics()["packed_prefill"]
        assert replays == [(16, False), (16, True), (8, True)]
        assert pk["dispatches"] == 3 and pk["pad_tokens"] == 0
        # the fresh pack launches K2 whatever the cache; the continued
        # ones K2, or K2-int8 over int8 pages
        k2 = K2.get(kind, "ragged_prefill_attention")
        assert LAUNCHES[k2] == cfg.num_layers * (2 if kind == "int8" else 3)
    finally:
        e.shutdown()
    assert not e._pgraph.graphs and not e._graph.graphs
