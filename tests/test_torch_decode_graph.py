"""The decode burst as one captured step (engine/decode_graph.py), the
device-side counter RNG of the sampler (engine/sampling.py), the cached
rope table (ops/rope.py) and the in-place page-table commit.

On the CPU (small f32 models, seeded inputs):
  * ``counter_uniform`` equals a numpy reimplementation (uint32
    arithmetic) bit for bit, over seeds, counters and slots; its draws are
    uniform (Kolmogorov-Smirnov over 2 x 10^5 draws, p > 1e-3); an inactive
    or greedy row leaves its slot's counter unchanged;
  * the step body builds nothing from the host: after one warm-up step it
    runs with torch.tensor / as_tensor / from_numpy and Tensor.item / cpu
    / tolist patched to raise, in all five configurations;
  * bursts of 1, 2, 4, 8 and 16 steps through the static buffers give the
    same ids, logprobs, caches and counters as the per-step loop the
    engine ran before (``eager_burst``), greedy and seeded-sampled slots
    mixed with idle ones;
  * ``Engine._commit_ptab`` rewrites the one device table in place (same
    ``data_ptr``, K and V share it) and equals ``PagePool.ptab``;
  * the cached rope table is bit-identical in float32 to the per-call
    table the port built before, and matches the JAX package's;
  * after prefix reuse rewrites the table (a tier-3 splice, a tier-1
    copy-on-write replace), every engine burst equals the eager loop on a
    twin state (also on the card, where the bursts are graph replays).

On the card (``cuda`` marker; skips here), small f32 models with head_dim
128 in the five configurations (paged, int8 KV, contiguous, int8 weights
+ int8 KV, int4 weights): the graph's greedy and seeded-sampled tokens
equal the eager loop's byte for byte, its kernel launch counts are the
layers x steps the replays ran, capture runs under
``torch.cuda.set_sync_debug_mode("error")``, an Engine captures at start
and serves through replays, and its pipelined loop serves a fork group
and a logit bias under that mode, as do a preempt / resume round and a
real device stall aborted by the bounded wait (those engines pin
``draft="0"``: they hold plain bursts); ``clone_page`` on the card equals
the plain copy, scales included. The spec round (n-gram speculation):
its captured graph equals its eager form (``eager_rounds``) in the five
configurations, and an engine at its defaults serves spec ticks, a
preempt / resume of a speculating slot and a stalled spec tick under the
sync guard. On the card's machine (no JAX):

    python -m pytest --noconftest tests/test_torch_decode_graph.py -q -m cuda
"""

from __future__ import annotations

import tests.torch_cpu  # noqa: F401  (one torch CPU thread)

import threading

import numpy as np
import pytest
import torch

from localai_tpu_torch.engine import decode_graph as dg
from localai_tpu_torch.engine import sampling
from localai_tpu_torch.engine.weights import random_params
from localai_tpu_torch.models import llama
from localai_tpu_torch.ops import kvcache
from localai_tpu_torch.ops import rope as trope
from localai_tpu_torch.ops.kernels import LAUNCHES

CONFIGS = ("paged", "int8", "contig", "w8kv8", "w4")


# ---------- the counter RNG ----------

def _np_fmix32(h):
    h = h ^ (h >> np.uint32(16))
    h = h * np.uint32(0x85EBCA6B)
    h = h ^ (h >> np.uint32(13))
    h = h * np.uint32(0xC2B2AE35)
    return h ^ (h >> np.uint32(16))


def _np_uniform(seed, counter):
    """numpy uint32 reimplementation of sampling.counter_uniform."""
    with np.errstate(over="ignore"):
        key = _np_fmix32((np.asarray(seed, np.int64) & 0xFFFFFFFF).astype(np.uint32))
        ctr = (np.asarray(counter, np.int64) & 0xFFFFFFFF).astype(np.uint32)
        h = _np_fmix32(key ^ (ctr * np.uint32(0x9E3779B1)))
    return (h >> np.uint32(8)).astype(np.float32) * np.float32(1.0 / (1 << 24))


@pytest.mark.parametrize("case", ["random", "edges", "slots"])
def test_counter_rng_matches_numpy_bit_for_bit(case):
    rng = np.random.default_rng(5)
    if case == "random":
        seed = rng.integers(0, 2 ** 32, size=4096, dtype=np.int64)
        counter = rng.integers(0, 2 ** 40, size=4096, dtype=np.int64)
    elif case == "edges":
        vals = np.array([0, 1, 2, 255, 256, 65535, 65536, 2 ** 31 - 1,
                         2 ** 31, 2 ** 32 - 1], np.int64)
        seed, counter = (a.ravel() for a in np.meshgrid(vals, vals))
    else:       # through the sampler's per-slot state, after set_slot
        sm = sampling.SlotSampler(6, 40, "cpu")
        for s in range(6):
            sm.set_slot(s, sampling.SamplingParamsHost(seed=[7, 7, 0, 2 ** 40 + 3,
                                                             -1, 123][s]),
                        fallback_seed=99)
        sm.counter.copy_(torch.tensor([0, 5, 1, 2, 3, 1000]))
        seed, counter = sm.seed.numpy().copy(), sm.counter.numpy().copy()
        assert seed.tolist() == [7, 7, 0, 3, 99, 123]
    got = sampling.counter_uniform(torch.from_numpy(seed), torch.from_numpy(counter))
    want = _np_uniform(seed, counter)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want.view(np.uint32))
    assert float(got.min()) >= 0.0 and float(got.max()) < 1.0


@pytest.mark.parametrize("axis", ["counters", "seeds"])
def test_counter_rng_draws_are_uniform(axis):
    """KS test over 2 x 10^5 draws: along the counter of four seeds, and
    across 2 x 10^5 seeds at counter 0."""
    from scipy import stats

    if axis == "counters":
        ctr = torch.arange(50_000, dtype=torch.int64)
        u = torch.cat([sampling.counter_uniform(torch.full_like(ctr, s), ctr)
                       for s in (0, 1, 12345, 2 ** 32 - 1)])
    else:
        seed = torch.arange(200_000, dtype=torch.int64)
        u = sampling.counter_uniform(seed, torch.zeros_like(seed))
    assert u.numel() >= 100_000
    p = stats.kstest(u.numpy().astype(np.float64), "uniform").pvalue
    assert p > 1e-3, p


def test_inactive_or_greedy_row_keeps_its_counter():
    rng = np.random.default_rng(2)
    logits = torch.from_numpy(rng.normal(size=(4, 40)).astype(np.float32))
    sm = sampling.SlotSampler(4, 40, "cpu")
    for s in range(4):
        sm.set_slot(s, sampling.SamplingParamsHost(
            temperature=0.0 if s == 3 else 1.0, top_k=0, top_p=1.0, seed=s),
            fallback_seed=0)
    active = torch.tensor([True, False, True, True])
    sm.sample_all(logits, active)
    sm.sample_all(logits, active)
    assert sm.counter.tolist() == [2, 0, 2, 0]
    # the list path (prefill's first tokens) keeps the same rule
    sm.sample(logits[:3], [1, 3, 0], draw=[True, True, False])
    assert sm.counter.tolist() == [2, 1, 2, 0]
    # set_slot resets the counter
    sm.set_slot(0, sampling.SamplingParamsHost(seed=4), fallback_seed=0)
    assert sm.counter.tolist() == [0, 1, 2, 0]


def test_sample_all_equals_the_list_path():
    """sample_all over all S rows == sample(logits, range(S), draw=...)
    on a copy of the same state: ids, logprobs and counters."""
    rng = np.random.default_rng(4)
    logits = torch.from_numpy(rng.normal(size=(5, 300)).astype(np.float32) * 3)
    a, b = sampling.SlotSampler(5, 300, "cpu"), sampling.SlotSampler(5, 300, "cpu")
    for sm in (a, b):
        for s, (t, k, p, mp) in enumerate([(0.0, 40, 0.95, 0.0), (0.7, 40, 0.9, 0.0),
                                           (1.3, 0, 1.0, 0.05), (1.0, 5, 0.5, 0.0),
                                           (0.9, 300, 0.99, 0.0)]):
            sm.set_slot(s, sampling.SamplingParamsHost(
                temperature=t, top_k=k, top_p=p, min_p=mp, seed=11 * s),
                fallback_seed=0)
    active = [True, True, False, True, True]
    for _ in range(4):
        ia, la = a.sample_all(logits, torch.tensor(active))
        ib, lb = b.sample(logits, list(range(5)), draw=active)
        np.testing.assert_array_equal(ia.numpy(), ib.numpy())
        np.testing.assert_array_equal(la.numpy(), lb.numpy())
    np.testing.assert_array_equal(a.counter.numpy(), b.counter.numpy())
    assert a.counter.tolist() == [0, 4, 0, 4, 4]


# ---------- a small model and its caches ----------

S, C, PG = 4, 64, 16


def _small(kind: str, device, head_dim: int = 8, seed: int = 0,
           dtype=torch.float32):
    """(cfg, params, ck, cv, sampler, lengths) of a small llama (float32
    unless ``dtype``) with three slots prefilled with seeded prompts (slot
    3 idle): greedy slots 0 and 2, slot 1 sampled with a seed."""
    hd = head_dim
    cfg = llama.LlamaConfig(vocab_size=96, hidden_size=4 * hd,
                            intermediate_size=8 * hd, num_layers=2,
                            num_heads=4, num_kv_heads=2, head_dim=hd,
                            rope_theta=500000.0, dtype=dtype)
    quant = {"w8kv8": "int8", "w4": "int4"}.get(kind, "")
    params = random_params(cfg, seed, device=device, quantize=quant)
    if kind == "contig":
        ck, cv = llama.init_cache(cfg, S, C, 0, device=device)
    else:
        ck, cv = llama.init_cache(
            cfg, S, C, PG, dtype=torch.int8 if kind in ("int8", "w8kv8") else None,
            device=device)
        # a scrambled table, ONE tensor for K and V (as the engine keeps it)
        ptab = torch.arange(S * C // PG, dtype=torch.int32).flip(0).reshape(S, -1)
        ck["ptab"] = cv["ptab"] = ptab.to(device)
    rng = np.random.default_rng(seed + 1)
    segs = [(0, 11), (1, 20), (2, 5)]
    N = sum(n for _s, n in segs) + 2
    tokens = np.zeros(N, np.int32)
    positions = np.full(N, C, np.int32)
    seg_of = np.full(N, S, np.int32)
    tab = np.zeros((4, S), np.int32)
    tab[0] = S
    off = 0
    for b, (slot, n) in enumerate(segs):
        tokens[off:off + n] = rng.integers(0, cfg.vocab_size, n)
        positions[off:off + n] = np.arange(n)
        seg_of[off:off + n] = b
        tab[:, b] = (slot, 0, off, n)
        off += n

    def t(a):
        return torch.from_numpy(a).to(device)

    llama.ragged_prefill(params, cfg, t(tokens), t(positions), *(t(r) for r in tab),
                         t(seg_of), ck, cv, continued=False)
    sampler = sampling.SlotSampler(S, cfg.vocab_size, device)
    for s in range(S):
        sampler.set_slot(s, sampling.SamplingParamsHost(
            temperature=1.0 if s == 1 else 0.0, top_k=0, top_p=1.0, seed=77),
            fallback_seed=0)
    lengths = np.array([11, 20, 5, 0], np.int32)
    return cfg, params, ck, cv, sampler, lengths


def _clone(x):
    if isinstance(x, dict):
        out = {k: _clone(v) for k, v in x.items()}
        if "ptab" in x:
            out["ptab"] = x["ptab"]     # shared and never written here
        return out
    return x.clone()


def _twin(cfg, params, ck, cv, sampler, device):
    """An independent copy of the caches and the sampler state."""
    sm = sampling.SlotSampler(S, cfg.vocab_size, device)
    for name in sampling.PARAMS:
        sm.p[name].copy_(sampler.p[name])
    sm.host = {k: v.copy() for k, v in sampler.host.items()}
    for name in ("ring", "ring_pos", "bias", "mu", "seed", "counter"):
        getattr(sm, name).copy_(getattr(sampler, name))
    return _clone(ck), _clone(cv), sm


def _burst_pair(kind, device, n_bursts_steps, capture=False, head_dim=8):
    """Run the same bursts through DecodeGraph (captured when ``capture``)
    and through eager_burst on twin states; returns both results, the
    final caches / counters, and the graph."""
    cfg, params, ck, cv, sampler, lengths = _small(kind, device, head_dim)
    ck2, cv2, sm2 = _twin(cfg, params, ck, cv, sampler, device)
    graph = dg.DecodeGraph(params, cfg, ck, cv, sampler, S, 16, device)
    if capture:
        graph.capture()
    active = np.array([True, True, True, False])
    tokens = np.array([3, 4, 5, 0], np.int32)
    outs = {"graph": [], "eager": []}
    for side in ("graph", "eager"):
        tok, lens = tokens.copy(), lengths.copy()
        for n in n_bursts_steps:
            if side == "graph":
                host = graph.run(tok, lens, active, n)
            else:
                host = dg.eager_burst(params, cfg, ck2, cv2, sm2, tok, lens,
                                      active, n)
            outs[side].append(host)
            lens = lens + n * active
            tok = np.where(active, host[-1, 0].astype(np.int64), tok)
    return outs, (ck, cv, sampler), (ck2, cv2, sm2), graph, cfg


def _assert_same(outs, state_a, state_b, active_only=True):
    for a, b in zip(outs["graph"], outs["eager"]):
        cols = slice(0, 3) if active_only else slice(None)
        np.testing.assert_array_equal(a[:, 0, cols], b[:, 0, cols])   # ids
        np.testing.assert_array_equal(a[:, 1, cols], b[:, 1, cols])   # logprobs
    (ck, cv, sa), (ck2, cv2, sb) = state_a, state_b
    for x, y in ((ck, ck2), (cv, cv2)):
        for k in x:
            if k not in ("ptab", "itab"):
                # the scratch page / slot past the pool takes dropped writes
                # (warm-up steps included) and is never read
                torch.testing.assert_close(x[k][:, :-1], y[k][:, :-1], rtol=0, atol=0)
    np.testing.assert_array_equal(sa.counter.cpu().numpy(), sb.counter.cpu().numpy())


@pytest.mark.parametrize("kind", ("paged", "int8", "contig"))
@pytest.mark.parametrize("n_steps", (1, 2, 4, 8, 16))
def test_static_buffer_bursts_equal_the_per_step_loop(kind, n_steps):
    outs, a, b, graph, _cfg = _burst_pair(kind, "cpu", (n_steps, n_steps))
    _assert_same(outs, a, b)
    assert not graph.graphs               # the CPU runs the body eagerly
    assert a[2].counter.tolist()[1] == 2 * n_steps    # the sampled slot drew
    assert a[2].counter.tolist()[0] == 0              # greedy: no draws


def _raise(*_a, **_k):
    raise AssertionError("the decode step built a tensor from host data "
                         "or read one back")


@pytest.mark.parametrize("kind", CONFIGS)
def test_step_body_builds_nothing_from_the_host(kind, monkeypatch):
    cfg, params, ck, cv, sampler, lengths = _small(kind, "cpu")
    graph = dg.DecodeGraph(params, cfg, ck, cv, sampler, S, 4, "cpu")
    graph.lengths.copy_(torch.from_numpy(lengths))
    graph.active.copy_(torch.tensor([True, True, True, False]))
    graph.step_body()                     # the warm-up step capture runs first
    for name in ("tensor", "as_tensor", "from_numpy"):
        monkeypatch.setattr(torch, name, _raise)
    for name in ("item", "cpu", "tolist", "numpy"):
        monkeypatch.setattr(torch.Tensor, name, _raise)
    graph.step_body()
    graph.step_body()
    monkeypatch.undo()
    assert graph.step.tolist() == [3]
    assert graph.lengths.tolist() == (lengths + 3 * np.array([1, 1, 1, 0])).tolist()


def test_commit_ptab_rewrites_the_one_table_in_place():
    from localai_tpu_torch.engine.engine import Engine, EngineConfig

    class _Tok:
        eos_token_id = 1

    cfg = llama.LlamaConfig(vocab_size=64, hidden_size=32, intermediate_size=64,
                            num_layers=1, num_heads=4, num_kv_heads=2,
                            dtype=torch.float32)
    e = Engine(cfg, random_params(cfg, 0, device="cpu"), _Tok(),
               EngineConfig(num_slots=3, max_context=64, kv_page_size=16),
               device="cpu")
    tab = e.ck["ptab"]
    assert e.cv["ptab"] is tab
    ptr = tab.data_ptr()
    for slot, rows in ((1, 20), (0, 64), (2, 1), (1, 40)):
        e._pool.ensure(slot, rows)
        e._commit_ptab()
        assert not e._pool.dirty
        assert e.ck["ptab"] is tab and e.cv["ptab"] is tab
        assert tab.data_ptr() == ptr
        np.testing.assert_array_equal(tab.numpy(), e._pool.ptab)
    e._pool.release(0, 0)
    e._commit_ptab()
    np.testing.assert_array_equal(tab.numpy(), e._pool.ptab)
    assert tab.data_ptr() == ptr


@pytest.mark.parametrize("kind,factor", [("none", 1.0), ("linear", 4.0),
                                         ("llama3", 8.0)])
def test_cached_rope_table_is_bit_identical_and_matches_jax(kind, factor):
    from localai_tpu.ops import rope as jrope

    cfg = llama.LlamaConfig(head_dim=16, num_heads=2, hidden_size=32,
                            rope_theta=500000.0, rope_scaling_type=kind,
                            rope_scaling_factor=factor)
    before = torch.tensor(trope._scaled_inv_freq(cfg), dtype=torch.float32)
    cached = trope.inv_freq(cfg, "cpu")
    assert trope.inv_freq(cfg, torch.device("cpu")) is cached    # built once
    np.testing.assert_array_equal(cached.numpy().view(np.uint32),
                                  before.numpy().view(np.uint32))
    pos = torch.from_numpy(np.random.default_rng(0).integers(
        0, 9000, size=(3, 5)).astype(np.int32))
    freqs = pos.to(torch.float32)[..., None] * before     # the per-call form
    emb = torch.cat([freqs, freqs], dim=-1)
    sin, cos = trope.rope_frequencies(cfg, pos)
    np.testing.assert_array_equal(sin.numpy(), torch.sin(emb).numpy())
    np.testing.assert_array_equal(cos.numpy(), torch.cos(emb).numpy())
    np.testing.assert_allclose(cached.numpy(), jrope._scaled_inv_freq(cfg),
                               rtol=1e-7)
    js, jc = jrope.rope_frequencies(cfg, pos.numpy())
    # sin/cos of large angles: float32 argument rounding dominates
    np.testing.assert_allclose(sin.numpy(), np.asarray(js), atol=2e-5)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jc), atol=2e-5)


# ---------- on the card ----------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the decode graph is captured on the card")


DECODE_KERNEL = {"paged": "paged_decode_attention", "int8": "paged_decode_attention_quant",
                 "contig": "decode_attention_append_contig",
                 "w8kv8": "paged_decode_attention_quant", "w4": "paged_decode_attention"}


@pytest.mark.cuda
@pytest.mark.parametrize("kind,dtype", [(k, "float32") for k in CONFIGS]
                         + [(k, "bfloat16") for k in ("paged", "w8kv8", "w4")])
def test_graph_replays_equal_the_eager_loop_on_the_card(card, kind, dtype):
    """Greedy slots 0 and 2 and seeded-sampled slot 1: byte-identical ids
    and logprobs, caches and counters, graph against eager, over bursts of
    16, 8, 1 and 4 steps; decode kernel launches = layers x replayed steps.
    bfloat16 adds W8 / W4's tensor-core kernel, whose split-K combine is a
    programmatic dependent launch inside the graph."""
    from localai_tpu_torch.ops.kernels import reset_launches

    steps = (16, 8, 1, 4)
    cfg, params, ck, cv, sampler, lengths = _small(
        kind, "cuda", head_dim=128, dtype=getattr(torch, dtype))
    ck2, cv2, sm2 = _twin(cfg, params, ck, cv, sampler, "cuda")
    graph = dg.DecodeGraph(params, cfg, ck, cv, sampler, S, 16, "cuda")
    graph.capture()
    assert sorted(graph.graphs) == [False, True] and all(graph.launches.values())
    active = np.array([True, True, True, False])
    outs = {"graph": [], "eager": []}
    for side in ("graph", "eager"):
        tok, lens = np.array([3, 4, 5, 0], np.int32), lengths.copy()
        reset_launches()
        for n in steps:
            host = (graph.run(tok, lens, active, n) if side == "graph" else
                    dg.eager_burst(params, cfg, ck2, cv2, sm2, tok, lens, active, n))
            outs[side].append(host)
            lens = lens + n * active
            tok = np.where(active, host[-1, 0].astype(np.int64), tok)
        torch.cuda.synchronize()
        assert LAUNCHES[DECODE_KERNEL[kind]] == cfg.num_layers * sum(steps), (side, dict(LAUNCHES))
    _assert_same(outs, (ck, cv, sampler), (ck2, cv2, sm2))
    assert sampler.counter.tolist()[1] == sum(steps)


@pytest.mark.cuda
def test_capture_runs_under_sync_debug_error(card):
    cfg, params, ck, cv, sampler, _lengths = _small("w8kv8", "cuda", head_dim=128)
    graph = dg.DecodeGraph(params, cfg, ck, cv, sampler, S, 16, "cuda")
    torch.cuda.set_sync_debug_mode("error")
    try:
        graph.capture()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert sorted(graph.graphs) == [False, True] and graph.pool_bytes > 0


@pytest.mark.cuda
def test_engine_loop_never_waits_for_the_stream(card):
    """The pipelined loop (depth 2, the split fused tick) with a fork
    group (a shared prefix and its boundary-page clone) and a logit bias
    (a bias row copied in), then the host tier (a wave that needs more
    than the whole pool offloads the fork group's retained chain, and the
    prompt sent again restores it) serves under torch.cuda.set_sync_debug_mode
    "error": no op on the engine thread waits for the whole stream (a
    pageable copy, .item(), a boolean mask); it waits only on one
    dispatch's event."""
    from localai_tpu_torch.engine.engine import Engine, EngineConfig, GenRequest

    class _Tok:
        eos_token_id = 1

        def decode(self, ids, **kw):
            return "".join(chr(97 + (i % 26)) for i in ids)

    cfg, params, *_ = _small("paged", "cuda", head_dim=128)
    e = Engine(cfg, params, _Tok(), EngineConfig(
        num_slots=4, max_context=128, prefill_chunk=16, kv_page_size=16,
        decode_burst=16, draft="0"), device="cuda").start()
    prompt = list(range(2, 42))
    reqs = [GenRequest(prompt_ids=list(prompt), max_new_tokens=21, ignore_eos=True,
                       params=sampling.SamplingParamsHost(temperature=0.0))
            for _ in range(3)]
    reqs.append(GenRequest(prompt_ids=list(range(50, 70)), max_new_tokens=9,
                           ignore_eos=True, params=sampling.SamplingParamsHost(
                               temperature=0.0, logit_bias={7: 5.0})))
    # all four are admitted together (one fork group), under the mode
    gate, admit = threading.Event(), e._admit
    e._admit = lambda: gate.is_set() and admit()
    outs = [e.submit(r) for r in reqs]
    rng = np.random.default_rng(3)

    def finals_of(outs):
        finals = []
        for o in outs:
            evs = []
            while (ev := o.get(timeout=300)) is not None:
                evs.append(ev)
            finals.append(evs[-1])
        return finals

    torch.cuda.set_sync_debug_mode("error")
    try:
        gate.set()
        e._wake.set()
        finals = finals_of(outs)
        # 4 x (100 + 20) rows take all 32 pages, and a fifth request keeps
        # 7 more full pages: the wave's 35 full pages and the first
        # group's ~4 exceed the pool whatever the timing (with four, the
        # partial pages of a request that finishes early can be reused
        # and the fork group's chain may survive on the device), so every
        # older retained chain is evicted first (LRU), the prompt's two
        # full pages offloaded
        wave = [e.submit(GenRequest(
            prompt_ids=rng.integers(2, 96, size=100).tolist(), max_new_tokens=20,
            ignore_eos=True, params=sampling.SamplingParamsHost(temperature=0.0)))
            for _ in range(5)]
        finals += finals_of(wave[:4])
        finals_of(wave[4:])
        e._offloader.join()
        offloaded = e.metrics()["kv_offload"]["offloaded_pages"]
        finals += finals_of([e.submit(GenRequest(
            prompt_ids=prompt + [3, 4, 5], max_new_tokens=5, ignore_eos=True,
            params=sampling.SamplingParamsHost(temperature=0.0)))])
    finally:
        torch.cuda.set_sync_debug_mode(0)
        e.shutdown()
    assert all(f.error is None for f in finals), [f.error for f in finals]
    assert [f.completion_tokens for f in finals] == [21, 21, 21, 9] + [20] * 4 + [5]
    m = e.metrics()
    assert m["fork"]["forked"] == 2 and m["pipeline"]["max_inflight"] == 2
    assert m["pages_in_use"] == 0
    assert offloaded >= 2 and m["kv_offload"]["restores"] == 1
    assert finals[-1].timings["reused_prompt_tokens"] == 32


@pytest.mark.cuda
def test_preempt_resume_and_stall_never_wait_for_the_stream(card):
    """Under torch.cuda.set_sync_debug_mode("error"), on one slot: a high
    request preempts a low one mid-decode and both complete (the pause
    copies the mirostat state on the card, the resume splices the retained
    pages back); then a real device stall: a GPU sleep of about 1 s
    enqueued on the engine's stream ahead of one burst makes that burst's
    event late, the bounded wait (dispatch_stall_ms 300) aborts its
    request with a "stall" event, and a request sent once the sleep has
    run is served. No op on the engine thread waits for the whole
    stream."""
    import time

    from localai_tpu_torch.engine.engine import Engine, EngineConfig, GenRequest

    class _Tok:
        eos_token_id = 1

        def decode(self, ids, **kw):
            return "".join(chr(97 + (i % 26)) for i in ids)

    cfg, params, *_ = _small("paged", "cuda", head_dim=128)
    e = Engine(cfg, params, _Tok(), EngineConfig(
        num_slots=1, max_context=128, prefill_chunk=16, kv_page_size=16,
        decode_burst=16, draft="0"), device="cuda").start()

    def req(prompt, n, priority=""):
        return GenRequest(prompt_ids=list(prompt), max_new_tokens=n,
                          ignore_eos=True, priority=priority,
                          params=sampling.SamplingParamsHost(temperature=0.0))

    def drain(out, first=None):
        evs = [first] if first is not None else []
        while (ev := out.get(timeout=300)) is not None:
            evs.append(ev)
        return evs

    rate = torch.cuda.get_device_properties(0).clock_rate * 1e3   # kHz -> Hz
    burst, armed = e._burst, []

    def late_burst(n_steps, active):
        if armed and armed.pop():
            torch.cuda._sleep(int(rate))          # ~1 s of device time
        return burst(n_steps, active)

    torch.cuda.set_sync_debug_mode("error")
    try:
        out_low = e.submit(req(range(2, 42), 60, "low"))
        first = out_low.get(timeout=300)
        high = drain(e.submit(req(range(60, 70), 8, "high")))
        low = drain(out_low, first)
        e.ecfg.dispatch_stall_ms = 300
        e._burst = late_burst
        armed.append(True)
        stalled = drain(e.submit(req(range(80, 90), 40)))
        time.sleep(1.5)                           # the sleep has run
        after = drain(e.submit(req(range(80, 90), 8)))
    finally:
        torch.cuda.set_sync_debug_mode(0)
        e.shutdown()
    assert not any(ev.error for ev in high + low + after)
    assert high[-1].completion_tokens == 8 and low[-1].completion_tokens == 60
    assert after[-1].completion_tokens == 8
    assert stalled[-1].error_kind == "stall"
    m = e.metrics()
    assert m["scheduler"]["preemptions"] == 1 and m["scheduler"]["resumes"] == 1
    assert m["scheduler"]["resume_restore_rows"] > 0
    assert m["lifecycle"]["stalls"] >= 1 and m["pages_in_use"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ("paged", "contig"))
def test_engine_captures_at_start_and_serves_through_replays(card, kind):
    from localai_tpu_torch.engine.engine import Engine, EngineConfig, GenRequest
    from localai_tpu_torch.ops.kernels import reset_launches

    class _Tok:
        eos_token_id = 1

        def decode(self, ids, **kw):
            return "".join(chr(97 + (i % 26)) for i in ids)

    cfg, params, *_ = _small(kind, "cuda", head_dim=128)
    e = Engine(cfg, params, _Tok(), EngineConfig(
        num_slots=4, max_context=128, prefill_chunk=16, kv_page_size=16,
        decode_burst=16, kv_layout="contiguous" if kind == "contig" else "auto",
        draft="0"), device="cuda").start()
    try:
        m = e.metrics()["decode_graph"]
        assert m["captured"] and m["capture_seconds"] > 0
        reset_launches()
        _text, events = e.generate_text(GenRequest(
            prompt_ids=[5, 6, 7], max_new_tokens=20, ignore_eos=True,
            params=sampling.SamplingParamsHost(temperature=0.0)))
        torch.cuda.synchronize()
        assert events[-1].completion_tokens == 20
        steps = e.metrics()["decode"]["steps"]
        assert steps == 16 + 2 + 1     # 19 tokens after the first: bursts 16, 2, 1
        assert LAUNCHES[DECODE_KERNEL[kind]] == cfg.num_layers * steps
    finally:
        e.shutdown()


@pytest.mark.cuda
def test_dequant_scratch_is_grown_before_capture_and_kept(card):
    """A tied int8 table (the transposed route, dequantize + matmul into
    the shared scratch) inside the graph: the warm-up steps size the
    scratch, the graph equals the eager loop, and a capture that would
    grow the scratch raises instead of allocating from the graph's pool."""
    from localai_tpu_torch.ops import quant

    cfg = llama.LlamaConfig(vocab_size=96, hidden_size=512, intermediate_size=1024,
                            num_layers=2, num_heads=4, num_kv_heads=2, head_dim=128,
                            tie_word_embeddings=True, dtype=torch.float32)
    params = random_params(cfg, 0, device="cuda", quantize="int8")
    assert "lm_head" not in params
    quant._SCRATCH.clear()
    outs = []
    for eager in (False, True):
        ck, cv = llama.init_cache(cfg, S, C, PG, device="cuda")
        sm = sampling.SlotSampler(S, cfg.vocab_size, "cuda")
        lens, tok = np.array([0, 0, 0, 0], np.int32), np.array([3, 4, 5, 6], np.int32)
        act = np.array([True, True, True, True])
        if eager:
            outs.append(dg.eager_burst(params, cfg, ck, cv, sm, tok, lens, act, 8))
        else:
            graph = dg.DecodeGraph(params, cfg, ck, cv, sm, S, 16, "cuda")
            graph.capture()
            outs.append(graph.run(tok, lens, act, 8))
    np.testing.assert_array_equal(outs[0], outs[1])
    buf = quant._SCRATCH[(0, torch.float32)]
    assert any(b is buf for b in quant._CAPTURED)
    g = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="under CUDA graph capture"):
        with torch.cuda.graph(g):
            quant.dequant_scratch(buf.numel() + 1, torch.float32, buf.device)


# ---------- the page table under the graph after prefix reuse ----------

class _EngineTok:
    eos_token_id = 1

    def decode(self, ids, **kw):
        return "".join(chr(97 + (i % 26)) for i in ids)


def _drive(e):
    """Run an engine's ticks on this thread until it is idle."""
    while True:
        e._reap_cancelled()
        if not (e._admit() | e._prefill_step() | e._decode_burst()):
            return


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
@pytest.mark.parametrize("kind", ("paged", "int8"))
def test_replays_after_splice_and_replace_read_the_new_table(device, kind):
    """Prefix reuse rewrites the table the captured step reads: a tier-3
    splice (a retained chain into an overwritten slot) and a tier-1
    copy-on-write replace (a held page cloned and swapped in). Every burst
    of the engine runs through the graph (captured on the card) and, from
    the same state, through the eager loop on a twin of the caches and the
    sampler: ids, logprobs and cache rows are identical, bursts after the
    splice and after the replace included."""
    from localai_tpu_torch.engine.engine import Engine, EngineConfig, GenRequest

    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the decode graph is captured on the card")
    cfg, params, *_ = _small(kind, device, head_dim=128 if device == "cuda" else 8)
    e = Engine(cfg, params, _EngineTok(), EngineConfig(
        num_slots=S, max_context=C, prefill_chunk=16, kv_page_size=PG,
        decode_burst=8, cache_dtype=torch.int8 if kind == "int8" else None,
        draft="0", emitter=False), device=device)
    if device == "cuda":
        e._capture()          # the decode step and the prefill graphs
    graph_burst = e._burst
    seen = []

    def both(n, active):
        tok, lens = e.cur_tokens.copy(), e.lengths.copy()
        ck2, cv2, sm2 = _twin(cfg, params, e.ck, e.cv, e.sampler, device)
        ref = dg.eager_burst(params, cfg, ck2, cv2, sm2, tok, lens, active, n)
        fetch = graph_burst(n, active)
        got = fetch.wait()
        cols = np.flatnonzero(active)
        np.testing.assert_array_equal(got[:, :, cols], ref[:, :, cols])
        for x, y in ((e.ck, ck2), (e.cv, cv2)):
            for k in x:
                if k != "ptab":
                    assert torch.equal(x[k][:, :-1], y[k][:, :-1]), k
        m = e.metrics()["prefix_cache"]
        seen.append((m["hits"], m["cow_clones"]))
        return fetch

    e._burst = both
    rng = np.random.default_rng(3)

    def request(ids, n):
        return e.submit(GenRequest(prompt_ids=list(ids), max_new_tokens=n,
                                   ignore_eos=True,
                                   params=sampling.SamplingParamsHost(temperature=0.0)))

    def run(ids, n):
        out = request(ids, n)
        _drive(e)
        evs = []
        while (ev := out.get_nowait()) is not None:
            evs.append(ev)
        return [t for ev in evs for t in (ev.token_ids or [ev.token_id])], evs[-1]

    a = rng.integers(2, 96, size=20).tolist()
    out_a, _ev = run(a, 6)
    outs = [request(rng.integers(2, 96, size=10).tolist(), 3) for _ in range(S)]
    _drive(e)                                # every slot, a's too, overwritten
    assert all(o.qsize() > 1 for o in outs)
    a2 = a + out_a[:5] + rng.integers(2, 96, size=4).tolist()
    _ids, ev = run(a2, 6)
    assert ev.timings["reused_prompt_tokens"] == 16      # tier 3: a spliced page
    hits_at_splice = seen[-1][0]
    _ids, ev = run(a2[:20] + rng.integers(2, 96, size=3).tolist(), 4)
    assert ev.timings["reused_prompt_tokens"] == 20      # tier 1, page 1 cloned
    assert hits_at_splice == 1 and seen[-1][1] == 1
    assert np.array_equal(e.ck["ptab"].cpu().numpy(), e._pool.ptab)


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True])
def test_clone_page_on_the_card_equals_the_plain_copy(card, quant):
    """ops/kvcache.py::clone_page on CUDA tensors: the page (and its
    scales) copied over every layer in place, every other page and the
    scratch page untouched; the plain copy is the same indexing on the
    CPU."""
    from localai_tpu_torch.ops import kvcache

    gen = torch.Generator().manual_seed(5)
    shape = (3, 2, 64, 8, 128)         # L, S, C, KV, hd: 8 pages of 16
    cache = kvcache.init_paged(shape, torch.int8 if quant else torch.bfloat16,
                               16, device="cuda")
    if quant:
        cache["pages"].copy_(torch.randint(-127, 128, cache["pages"].shape,
                                           generator=gen, dtype=torch.int8))
        cache["scales"].copy_(torch.rand(cache["scales"].shape, generator=gen))
    else:
        cache["pages"].copy_(torch.randn(cache["pages"].shape, generator=gen))
    plain = {k: v.cpu().clone() for k, v in cache.items()}
    for k in ("pages", "scales") if quant else ("pages",):
        plain[k][:, 6] = plain[k][:, 2]
    ptr = cache["pages"].data_ptr()
    kvcache.clone_page(cache, 2, 6)
    torch.cuda.synchronize()
    assert cache["pages"].data_ptr() == ptr
    for k, v in plain.items():
        assert torch.equal(cache[k].cpu(), v), k


# ---------- the spec round (n-gram self-speculation) on the card ----------

@pytest.mark.cuda
@pytest.mark.parametrize("kind", CONFIGS)
def test_spec_round_graph_equals_its_eager_form_on_the_card(card, kind):
    """The captured spec round (DecodeGraph.spec_body) against eager_rounds
    (fresh tensors, the verify pack built on the host) on twin states:
    speculating greedy slots 0 and 2 (slot 0's history repeats), the
    seeded sampled slot 1 as a plain row, idle slot 3; ticks of 3, 1 and 2
    rounds. Tokens and n_out identical, logprobs within 1e-4, the chained
    tokens / lengths, rings and counters identical, the committed rows
    within 1e-4 (the two verify packs differ in size; int8 KV: 5e-3 and
    one quantization level); the decode kernel
    and K2 / K2-int8 launched once per layer per replayed round."""
    from localai_tpu_torch.ops.kernels import reset_launches

    W = 5
    cfg, params, ck, cv, sampler, lengths = _small(kind, "cuda", head_dim=128)
    ck2, cv2, sm2 = _twin(cfg, params, ck, cv, sampler, "cuda")
    hist = [7, 8, 9, 10] * 4
    for sm in (sampler, sm2):
        sm.set_ring(0, hist)
    graph = dg.DecodeGraph(params, cfg, ck, cv, sampler, S, 16, "cuda", spec_width=W)
    twin = dg.DecodeGraph(params, cfg, ck2, cv2, sm2, S, 16, "cuda", spec_width=W)
    graph.capture()
    assert sorted(graph.spec_graphs) == [False, True]
    rows = np.stack([[1, 1, 1, 0], np.ones(S), [10, 4, 5, 0], lengths,
                     [1, 0, 1, 0]]).astype(np.int64)
    graph.load(rows)
    twin.load(rows)
    k2 = "ragged_prefill_attention_int8" if kind in ("int8", "w8kv8") else \
        "ragged_prefill_attention"
    for n in (3, 1, 2):
        reset_launches()
        got = graph.spec_replay(n).wait()
        torch.cuda.synchronize()
        assert LAUNCHES[DECODE_KERNEL[kind]] == cfg.num_layers * n
        assert LAUNCHES[k2] == cfg.num_layers * n
        ref = twin.spec_eager(n)
        np.testing.assert_array_equal(got[:, :W], ref[:, :W])
        np.testing.assert_array_equal(got[:, 2 * W], ref[:, 2 * W])
        # int8 KV: a row the two packs' projections round to one level
        # apart moves a logprob by up to ~1e-3 (the int8 tolerance of the
        # card checks)
        np.testing.assert_allclose(got[:, W:2 * W], ref[:, W:2 * W],
                                   atol=5e-3 if kind in ("int8", "w8kv8") else 1e-4)
        for a, b in ((graph.tokens, twin.tokens), (graph.lengths, twin.lengths),
                     (sampler.ring, sm2.ring), (sampler.counter, sm2.counter)):
            assert torch.equal(a, b)
    lens = graph.lengths.cpu().numpy()
    for x, y in ((ck, ck2), (cv, cv2)):
        a, b = kvcache.gather_all_rows(kvcache.layer(x, 1)), \
            kvcache.gather_all_rows(kvcache.layer(y, 1))
        a, b = (a["q"], b["q"]) if isinstance(a, dict) else (a, b)
        for s in range(3):
            torch.testing.assert_close(a[s, :lens[s]].float(), b[s, :lens[s]].float(),
                                       atol=1e-4 if kind not in ("int8", "w8kv8") else 1.0,
                                       rtol=0)
    assert sampler.counter.tolist()[1] == 6 and sampler.counter.tolist()[0] == 0


@pytest.mark.cuda
def test_spec_ticks_never_wait_for_the_stream(card):
    """The engine at its defaults (speculation on, the emitter thread) under
    torch.cuda.set_sync_debug_mode("error"): greedy requests take spec
    ticks beside a penalized sampled one riding them as a plain row, and
    a sampled one takes rejection-sampled rounds; a high request pauses a
    speculating low one, which resumes; then a GPU sleep of about 1 s
    enqueued ahead of one spec
    tick makes it late and dispatch_stall_ms 300 aborts its request alone;
    a request sent after the sleep is served. No op on the engine thread
    waits for the whole stream."""
    import time

    from localai_tpu_torch.engine.engine import Engine, EngineConfig, GenRequest

    class _Tok:
        eos_token_id = 1

        def decode(self, ids, **kw):
            return "".join(chr(97 + (i % 26)) for i in ids)

    cfg, params, *_ = _small("paged", "cuda", head_dim=128)
    e = Engine(cfg, params, _Tok(), EngineConfig(
        num_slots=2, max_context=128, prefill_chunk=16, kv_page_size=16,
        decode_burst=16), device="cuda").start()

    def req(prompt, n, priority="", temperature=0.0, **params):
        return GenRequest(prompt_ids=list(prompt), max_new_tokens=n,
                          ignore_eos=True, priority=priority,
                          params=sampling.SamplingParamsHost(
                              temperature=temperature, seed=5, **params))

    def drain(out, first=None):
        evs = [first] if first is not None else []
        while (ev := out.get(timeout=300)) is not None:
            evs.append(ev)
        return evs

    rate = torch.cuda.get_device_properties(0).clock_rate * 1e3   # kHz -> Hz
    tick, armed = e._spec_tick, []

    def late_tick(n_rounds, active):
        if armed and armed.pop():
            torch.cuda._sleep(int(rate))          # ~1 s of device time
        return tick(n_rounds, active)

    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = [e.submit(req([9, 10, 11, 12] * 8, 40)),
                e.submit(req(range(40, 60), 40, temperature=0.8,
                             repeat_penalty=1.1))]
        mixed = [drain(o) for o in outs]
        out_low = e.submit(req(range(2, 42), 60, "low"))
        first = out_low.get(timeout=300)
        out_low2 = e.submit(req(range(3, 30), 60, "low", temperature=0.8))
        first2 = out_low2.get(timeout=300)       # both slots decode now
        high = drain(e.submit(req(range(60, 70), 8, "high")))
        low = drain(out_low, first) + drain(out_low2, first2)
        e.ecfg.dispatch_stall_ms = 300
        e._spec_tick = late_tick
        armed.append(True)
        stalled = drain(e.submit(req(range(80, 90), 40)))
        time.sleep(1.5)                           # the sleep has run
        after = drain(e.submit(req(range(80, 90), 8)))
        captured = e.metrics()["decode_graph"]["spec_captured"]
    finally:
        torch.cuda.set_sync_debug_mode(0)
        e.shutdown()
    assert captured == [False, True]
    assert not any(ev.error for ev in sum(mixed, []) + high + low + after)
    assert [m[-1].completion_tokens for m in mixed] == [40, 40]
    assert high[-1].completion_tokens == 8 and after[-1].completion_tokens == 8
    assert stalled[-1].error_kind == "stall"
    m = e.metrics()
    assert m["spec"]["rounds"] > 0 and m["spec"]["mixed_dispatches"] > 0
    assert m["spec"]["by_mode"]["sampled"]["rounds"] > 0
    assert m["scheduler"]["preemptions"] >= 1 and m["scheduler"]["resumes"] >= 1
    assert m["lifecycle"]["stalls"] >= 1 and m["pages_in_use"] == 0
