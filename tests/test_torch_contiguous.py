"""The PyTorch port's contiguous KV layout against the JAX package, on the
CPU, at tiny sizes (``kv_layout: contiguous``).

Inputs are made from a seed with numpy and fed to both packages. What is
pinned:
  * the contiguous scatter with JAX's drop sentinels (an inactive slot's
    position C, pad tokens) landing in the port's scratch slot, and the
    dense rows;
  * K4's plain version against localai_tpu/ops/pallas/decode_attention.py::
    decode_attention_append_pallas in interpret mode AND the JAX module's
    stated reference ops/attention.py::decode_attention_append, with a
    slot at length == C;
  * K5's plain version (stacked cache, layer index as a tensor) against
    decode_attention_append_pallas_full in interpret mode and the same
    reference, on a cache whose slot axis carries the scratch slot;
  * prefill on the contiguous layout: K2's wrapper over the cache viewed
    as S pages of C rows with the identity table equals the JAX jnp op on
    the contiguous layer, for fresh, continued and pad packs;
  * the tiny f32 llama's logits (ragged_prefill, then decode_step) with
    ``init_cache(..., page_size=0)``, and greedy tokens byte-identical to
    the JAX Engine with kv_layout contiguous; the engine holds no page
    allocator and reports its layout.

Tolerances: attention in float32, summed in another order than XLA,
2e-5 absolute against the jnp ops and 2e-4 against the Pallas kernels in
interpret mode (tests/test_torch_ops.py); logits atol 2e-4 / rtol 2e-3.
The JAX decode step on the contiguous layout attends AFTER its scatter
(``decode_attention``, its default), the port's kernel BEFORE it with the
token appended (``decode_attention_append``): the same function, summed
in another order.
"""

from __future__ import annotations

import tests.torch_cpu  # noqa: F401  (one torch CPU thread)

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localai_tpu.engine import engine as jeng
from localai_tpu.engine import sampling as jsamp
from localai_tpu.models import llama as jllama
from localai_tpu.ops import kvcache as jkv
from localai_tpu_torch.engine import engine as teng
from localai_tpu_torch.engine import sampling as tsamp
from localai_tpu_torch.models import llama as tllama
from localai_tpu_torch.ops import kvcache as tkv
from localai_tpu_torch.ops.kernels import LAUNCHES
from tests.test_torch_engine import _Tok, _wave
from tests.test_torch_kv_int8 import _t, tiny  # noqa: F401 (fixture)

ATOL, RTOL = 2e-4, 2e-3


# ---------- the layout ----------

def test_contiguous_scatter_drops_sentinels_like_jax():
    """Decode rows of an inactive slot (position C) and pad tokens of a
    pack (position C, clamped sentinel slot) are dropped in both packages
    (the port writes them to its scratch slot, which no reader sees)."""
    rng = np.random.default_rng(1)
    S, C, KV, hd = 3, 16, 2, 8
    base = rng.normal(size=(1, S, C, KV, hd)).astype(np.float32)
    jc = jnp.asarray(base)
    tc = tkv.from_jax(base, device="cpu")
    assert not tkv.is_paged(tc) and tkv.shape(tc) == (1, S, C, KV, hd)
    assert tc["rows"].shape[1] == S + 1                      # scratch slot
    jl, tl = jkv.layer(jc, 0), tkv.layer(tc, 0)
    lengths = np.array([5, C, 0], np.int32)
    new = rng.normal(size=(S, KV, hd)).astype(np.float32)
    jl = jkv.scatter_decode(jl, jnp.arange(S), jnp.asarray(lengths),
                            jnp.asarray(new))
    tkv.scatter_decode(tl, torch.arange(S), _t(lengths), _t(new))
    slot_of = np.array([2, 2, 0, S - 1, S - 1], np.int32)
    cols = np.array([1, 2, 6, C, C], np.int32)
    newp = rng.normal(size=(5, KV, hd)).astype(np.float32)
    jfull = jkv.scatter_ragged(jl[None], 0, jnp.asarray(slot_of),
                               jnp.asarray(cols), jnp.asarray(newp))
    tkv.scatter_ragged(tl, _t(slot_of), _t(cols), _t(newp))
    np.testing.assert_array_equal(tkv.pool(tl).numpy(), np.asarray(jfull[0]))
    np.testing.assert_array_equal(tkv.gather_all_rows(tl).numpy(),
                                  np.asarray(jfull[0]))
    assert not np.array_equal(tkv.pool(tl).numpy(), base[0])     # not vacuous


# ---------- K4 / K5: contiguous decode ----------

def _decode_case(seed=4, S=4, C=32, KV=2, G=3, hd=16, L=3):
    rng = np.random.default_rng(seed)
    return dict(
        q=rng.normal(size=(S, KV * G, hd)).astype(np.float32),
        nk=rng.normal(size=(S, KV, hd)).astype(np.float32),
        nv=rng.normal(size=(S, KV, hd)).astype(np.float32),
        ck=rng.normal(size=(L, S, C, KV, hd)).astype(np.float32),
        cv=rng.normal(size=(L, S, C, KV, hd)).astype(np.float32),
        lengths=np.array([20, 5, C, 0], np.int32),      # length == C; empty
        G=G)


@pytest.mark.parametrize("reference", ["jnp", "pallas_interpret"])
def test_k4_plain_matches_jax(reference):
    from localai_tpu.ops.attention import decode_attention_append
    from localai_tpu.ops.pallas.decode_attention import (
        decode_attention_append_pallas)
    from localai_tpu_torch.ops.decode_attention import (
        decode_attention_append_contig)

    c = _decode_case()
    li = 1
    before = dict(LAUNCHES)
    out = decode_attention_append_contig(
        _t(c["q"]), _t(c["nk"]), _t(c["nv"]), _t(c["ck"][li]), _t(c["cv"][li]),
        _t(c["lengths"]), c["G"])
    assert LAUNCHES == before            # CPU tensors: plain version, no launch
    j = [jnp.asarray(a) for a in (c["q"], c["nk"], c["nv"], c["ck"][li],
                                  c["cv"][li], c["lengths"])]
    if reference == "jnp":
        ref, atol = decode_attention_append(*j, c["G"]), 2e-5
    else:
        ref = decode_attention_append_pallas(*j, c["G"], interpret=True)
        atol = 2e-4
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=atol)


@pytest.mark.parametrize("reference", ["jnp", "pallas_interpret"])
def test_k5_plain_matches_jax(reference):
    """K5 reads layer ``layer_idx`` of the stacked cache; the port's stacked
    cache carries the scratch slot past S, which is never read."""
    from localai_tpu.ops.attention import decode_attention_append
    from localai_tpu.ops.pallas.decode_attention import (
        decode_attention_append_pallas_full)
    from localai_tpu_torch.ops.decode_attention import (
        decode_attention_append_full)

    c = _decode_case(seed=6)
    li = 2
    tck = tkv.from_jax(c["ck"], device="cpu")["rows"]  # [L, S + 1, C, KV, hd]
    tcv = tkv.from_jax(c["cv"], device="cpu")["rows"]
    tck[:, -1] = 1e4                                 # a poisoned scratch slot
    tcv[:, -1] = -1e4
    before = dict(LAUNCHES)
    out = decode_attention_append_full(
        _t(c["q"]), _t(c["nk"]), _t(c["nv"]), tck, tcv, _t(c["lengths"]),
        torch.tensor([li], dtype=torch.int32), c["G"])
    assert LAUNCHES == before
    if reference == "jnp":
        ref = decode_attention_append(
            jnp.asarray(c["q"]), jnp.asarray(c["nk"]), jnp.asarray(c["nv"]),
            jnp.asarray(c["ck"][li]), jnp.asarray(c["cv"][li]),
            jnp.asarray(c["lengths"]), c["G"])
        atol = 2e-5
    else:
        ref = decode_attention_append_pallas_full(
            jnp.asarray(c["q"]), jnp.asarray(c["nk"]), jnp.asarray(c["nv"]),
            jnp.asarray(c["ck"]), jnp.asarray(c["cv"]),
            jnp.asarray(c["lengths"]), jnp.int32(li), c["G"], interpret=True)
        atol = 2e-4
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=atol)


@pytest.mark.parametrize("kind", ["fresh", "continued", "pad"])
def test_contiguous_prefill_through_identity_table_matches_jax(kind):
    """K2's wrapper over the contiguous layer viewed as S pages of C rows
    (identity table) == the JAX jnp op on the contiguous layer."""
    from localai_tpu.ops.ragged_prefill import ragged_prefill_attention
    from localai_tpu_torch.ops.ragged_prefill import (
        ragged_prefill_attention_paged)

    rng = np.random.default_rng(5)
    S, C, KV, G, hd, N = 4, 32, 2, 3, 16, 24
    ck = rng.normal(size=(1, S, C, KV, hd)).astype(np.float32)
    cv = rng.normal(size=(1, S, C, KV, hd)).astype(np.float32)
    segs = {"fresh": [(0, 1, 0, 0, 6), (1, 3, 0, 6, 10), (2, 0, 0, 16, 8)],
            "continued": [(0, 1, 20, 0, 6), (1, 3, 0, 6, 10), (2, 0, 7, 16, 8)],
            "pad": [(0, 1, 20, 0, 6), (2, 0, 7, 9, 4)]}[kind]
    seg_of = np.full((N,), S, np.int32)
    tabs = np.zeros((4, S), np.int32)
    tabs[0] = S
    for b, slot, start, off, ln in segs:
        seg_of[off:off + ln] = b
        tabs[:, b] = [slot, start, off, ln]
    q = rng.normal(size=(N, KV * G, hd)).astype(np.float32)
    nk = rng.normal(size=(N, KV, hd)).astype(np.float32)
    nv = rng.normal(size=(N, KV, hd)).astype(np.float32)
    lk = tkv.layer(tkv.from_jax(ck, device="cpu"), 0)
    lv = tkv.layer(tkv.from_jax(cv, device="cpu"), 0)
    assert tuple(tkv.table(lk).flatten().tolist()) == tuple(range(S))
    out = ragged_prefill_attention_paged(
        _t(q), _t(nk), _t(nv), tkv.pool(lk), tkv.pool(lv), tkv.table(lk),
        *(_t(t) for t in tabs), G, continued=kind != "fresh").numpy()
    ref = ragged_prefill_attention(
        jnp.asarray(q), jnp.asarray(nk), jnp.asarray(nv), jnp.asarray(seg_of),
        jnp.asarray(tabs[0]), jnp.asarray(tabs[1]), jnp.asarray(ck[0]),
        jnp.asarray(cv[0]), G, continued=kind != "fresh")
    real = seg_of < S
    np.testing.assert_allclose(out[real], np.asarray(ref)[real], atol=2e-5)


# ---------- the slice: tiny llama logits, engine tokens ----------

def test_contiguous_llama_logits_match_jax(tiny):
    """ragged_prefill (a fresh pack, then a continued pack with pads and a
    pad segment) and three decode steps on the contiguous layout (one
    slot inactive in the last step): logits and rows match."""
    _d, jcfg, jparams, tcfg, tparams = tiny
    S, C = 4, 64
    rng = np.random.default_rng(0)
    jck, jcv = jllama.init_cache(jcfg, S, C, jnp.float32, page_size=0)
    tck, tcv = tllama.init_cache(tcfg, S, C, 0, device="cpu")
    assert not tkv.is_paged(tck)
    prompts = rng.integers(2, 258, size=(S, 30)).astype(np.int32)
    lengths = np.zeros((S,), np.int32)
    for segs, N, continued in (([(0, 0, 10), (2, 0, 7)], 24, False),
                               ([(0, 10, 6), (1, 0, 5), (2, 7, 4)], 20, True)):
        tokens = np.zeros((N,), np.int32)
        positions = np.full((N,), C, np.int32)
        seg_of = np.full((N,), S, np.int32)
        tabs = np.zeros((4, S), np.int32)
        tabs[0] = S
        off = 0
        for b, (slot, start, ln) in enumerate(segs):
            tokens[off:off + ln] = prompts[slot, start:start + ln]
            positions[off:off + ln] = np.arange(start, start + ln)
            seg_of[off:off + ln] = b
            tabs[:, b] = [slot, start, off, ln]
            lengths[slot] = start + ln
            off += ln
        jl, jck, jcv = jllama.ragged_prefill(
            jparams, jcfg, jnp.asarray(tokens), jnp.asarray(positions),
            jnp.asarray(seg_of), *map(jnp.asarray, tabs), jck, jcv,
            continued=continued)
        tl = tllama.ragged_prefill(tparams, tcfg, _t(tokens), _t(positions),
                                   *(_t(t) for t in tabs), _t(seg_of), tck,
                                   tcv, continued=continued)
        real = [b for b in range(S) if tabs[3, b] > 0]
        np.testing.assert_allclose(tl.numpy()[real], np.asarray(jl)[real],
                                   atol=ATOL, rtol=RTOL)
    toks = rng.integers(2, 258, size=(3, S)).astype(np.int32)
    active = np.ones((S,), bool)
    for step in range(3):
        if step == 2:
            active[1] = False
        jl, jck, jcv = jllama.engine_decode(
            jparams, jcfg, jnp.asarray(toks[step]), jnp.asarray(lengths),
            jnp.asarray(active), jck, jcv)
        tl = tllama.decode_step(tparams, tcfg, _t(toks[step]), _t(lengths),
                                tck, tcv, active=_t(active))
        np.testing.assert_allclose(tl.numpy()[active], np.asarray(jl)[active],
                                   atol=ATOL, rtol=RTOL)
        lengths += active
    for li in range(jcfg.num_layers):
        for jc, tc in ((jck, tck), (jcv, tcv)):
            np.testing.assert_allclose(tkv.pool(tkv.layer(tc, li)).numpy(),
                                       np.asarray(jc[li]), atol=ATOL, rtol=RTOL)


def test_contiguous_engine_greedy_tokens_byte_identical_to_jax(tiny):
    """The port's Engine with kv_layout contiguous gives the JAX Engine's
    greedy tokens, byte for byte, on a concurrent mix with more requests
    than slots, continued packs and a head-truncated prompt; it keeps no
    page allocator."""
    _d, jcfg, jparams, tcfg, tparams = tiny
    je = jeng.Engine(jcfg, jparams, _Tok(), jeng.EngineConfig(
        num_slots=4, max_context=128, prefill_buckets=(16,),
        prefill_chunk=16, cache_dtype=jnp.float32, kv_layout="contiguous",
        kv_prefix_cache=False, kv_offload=False,
        draft="0"))
    te = teng.Engine(tcfg, tparams, _Tok(), teng.EngineConfig(
        num_slots=4, max_context=128, prefill_chunk=16, decode_burst=16,
        kv_layout="contiguous", kv_offload=False, draft="0"), device="cpu")
    je.start()
    te.start()
    try:
        rng = np.random.default_rng(3)
        specs = [(rng.integers(2, 258, size=n).tolist(), m, ign)
                 for n, m, ign in ((40, 8, True), (12, 10, True), (70, 8, True),
                                   (9, 12, False), (25, 6, True),
                                   (150, 8, True), (5, 1, True))]
        ref = _wave(je, jeng, jsamp, specs)
        got = _wave(te, teng, tsamp, specs)
    finally:
        je.shutdown()
        te.shutdown()
    assert got == ref
    m = te.metrics()
    assert m["kv_layout"] == "contiguous" and m["cache_dtype"] == "float32"
    assert "pages_in_use" not in m and te._pool is None
    assert m["packed_prefill"]["continued"] > 0
    assert m["active_slots"] == 0


def test_load_model_contiguous_on_cpu(tmp_path):
    """load_model(kv_layout="contiguous") and the CLI knobs build a
    contiguous engine that answers a request (CPU: the plain versions)."""
    from localai_tpu_torch.backend.runner import load_model
    from localai_tpu_torch.cli import build_parser

    args = build_parser().parse_args(
        ["run", "--model", str(tmp_path), "--kv-layout", "contiguous",
         "--kv-cache-dtype", "float32", "--kv-page-size", "16",
         "--prefill-chunk", "8", "--decode-burst", "4", "--device", "cpu"])
    (tmp_path / "config.json").write_text(json.dumps({
        "vocab_size": 300, "hidden_size": 32, "intermediate_size": 64,
        "num_hidden_layers": 2, "num_attention_heads": 2,
        "num_key_value_heads": 1}))
    lm = load_model(args.model, "t", num_slots=2, context_size=64,
                    dtype="float32", random_weights=0, device=args.device,
                    kv_cache_dtype=args.kv_cache_dtype, kv_layout=args.kv_layout,
                    kv_page_size=args.kv_page_size,
                    prefill_chunk=args.prefill_chunk,
                    decode_burst=args.decode_burst)
    try:
        assert lm.engine.kv_layout == "contiguous"
        assert lm.engine.ecfg.prefill_chunk == 8 and lm.engine.ecfg.decode_burst == 4
        _text, evs = lm.engine.generate_text(teng.GenRequest(
            prompt_ids=list(range(2, 30)), max_new_tokens=5, ignore_eos=True,
            params=tsamp.SamplingParamsHost(temperature=0.0)))
        assert evs[-1].completion_tokens == 5 and not evs[-1].error
        assert lm.engine.metrics()["packed_prefill"]["continued"] > 0
    finally:
        lm.engine.shutdown()
