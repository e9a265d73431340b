"""The PyTorch port's int8 paged KV cache against the JAX package, on the
CPU, at tiny sizes (``kv_cache_dtype: int8``).

Inputs are made from a seed with numpy and fed to both packages. What is
pinned:
  * ``quantize``: byte-identical int8 rows, scales within 1e-7 relative
    (the same float32 max / 127 and division; torch.round and jnp.round
    both round half to even);
  * the int8 paged scatter (quantize on scatter into pages AND scales)
    with JAX's drop sentinels, and the {"q","s"} dense gather;
  * K3's plain version (int8 paged decode, scales folded into scores and
    probabilities) against ops/attention.py::decode_attention_append over
    gather_all_rows AND the Pallas kernel in interpret mode, with a slot
    at length == C;
  * K2-int8's plain version (ragged prefill over int8 committed pages)
    against ops/ragged_prefill.py::ragged_prefill_attention for fresh,
    continued and pad packs; the wrappers route CPU tensors to the plain
    versions and count no launch;
  * the tiny f32 llama's logits (ragged_prefill, then decode_step) on an
    int8 paged cache with page 16, and greedy tokens byte-identical to
    the JAX Engine with cache_dtype int8;
  * refusals: int8 with the contiguous layout raises NotImplementedError,
    an unknown kv_cache_dtype ValueError, fp16 NotImplementedError.

Tolerances: attention in float32, summed in another order than XLA,
2e-5 absolute against the jnp ops for unit-scale inputs and 3e-4 against
the Pallas kernel in interpret mode (the JAX package's own int8 kernel
test); logits atol 2e-4 / rtol 2e-3 (tests/test_torch_llama.py).
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
from localai_tpu.ops import kvcache as jkv
from localai_tpu_torch.engine import engine as teng
from localai_tpu_torch.engine import sampling as tsamp
from localai_tpu_torch.engine import weights as tweights
from localai_tpu_torch.models import llama as tllama
from localai_tpu_torch.ops import kvcache as tkv
from localai_tpu_torch.ops.kernels import LAUNCHES
from tests.test_torch_engine import _Tok, _wave

ATOL, RTOL = 2e-4, 2e-3


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


# ---------- quantize and the int8 paged scatter ----------

def test_quantize_matches_jax():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(5, 3, 32)) * rng.uniform(0.01, 20, size=(5, 3, 1))
         ).astype(np.float32)
    x[0, 0] = 0.0                         # all-zero row: the eps scale
    x[1, 1, :4] = [127.0, -127.0, 63.5, 0.5]   # exact halves: half-to-even
    jq, js = jkv.quantize(jnp.asarray(x))
    tq, ts = tkv.quantize(_t(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-7, atol=0)


S, C, KV, HD, PG = 3, 32, 2, 16, 8        # 4 pages per slot, 12 in the pool


def _ptab():
    """Scrambled tables with unallocated (sentinel) tail entries."""
    n = S * C // PG
    ptab = np.full((S, C // PG), n, np.int32)
    ptab[0, :3] = [7, 2, 9]
    ptab[1, :4] = [0, 11, 5, 3]
    ptab[2, :1] = [4]
    return ptab


def test_int8_paged_scatter_drops_sentinels_like_jax():
    """Decode rows of an inactive slot (position C), pad tokens of a pack
    and rows landing on unallocated pages are DROPPED from pages and
    scales in both packages; the rest quantize identically."""
    rng = np.random.default_rng(2)
    jc = jkv.init_paged((1, S, C, KV, HD), jnp.int8, PG)
    jc = jkv.with_page_table(jc, jnp.asarray(_ptab()))
    tc = tkv.from_jax(jax.tree.map(np.asarray, jc), device="cpu")
    assert tc["pages"].shape[1] == jc["pages"].shape[1] + 1    # scratch page
    assert tc["scales"].shape[1] == jc["scales"].shape[1] + 1
    jl, tl = jkv.layer(jc, 0), tkv.layer(tc, 0)

    lengths = np.array([13, C, 12], np.int32)
    new = rng.normal(size=(S, KV, HD)).astype(np.float32)
    jl = jkv.scatter_decode(jl, jnp.arange(S), jnp.asarray(lengths),
                            jnp.asarray(new))
    tkv.scatter_decode(tl, torch.arange(S), _t(lengths), _t(new))

    slot_of = np.array([1, 1, 1, 0, 0, S - 1, S - 1], np.int32)
    cols = np.array([20, 21, 22, 3, 4, C, C], np.int32)
    newp = (rng.normal(size=(7, KV, HD)) * 5).astype(np.float32)
    jfull = jkv.scatter_ragged(
        {"pages": jl["pages"][None], "scales": jl["scales"][None],
         "ptab": jl["ptab"]}, 0, jnp.asarray(slot_of), jnp.asarray(cols),
        jnp.asarray(newp))

    tkv.scatter_ragged(tl, _t(slot_of), _t(cols), _t(newp))
    np.testing.assert_array_equal(tkv.pool(tl).numpy(),
                                  np.asarray(jfull["pages"][0]))
    np.testing.assert_allclose(tkv.scales_pool(tl).numpy(),
                               np.asarray(jfull["scales"][0]), rtol=1e-7)
    jrows = jkv.gather_all_rows(jkv.layer(jfull, 0))
    trows = tkv.gather_all_rows(tl)
    np.testing.assert_array_equal(trows["q"].numpy(), np.asarray(jrows["q"]))
    np.testing.assert_allclose(trows["s"].numpy(), np.asarray(jrows["s"]),
                               rtol=1e-7)
    assert int((tkv.pool(tl) != 0).sum()) > 0           # not vacuous


# ---------- K3: int8 paged decode ----------

def _int8_pools(rng, S_, C_, KV_, hd, pg):
    """Single-layer JAX int8 paged K and V caches sharing one table, every
    slot fully allocated in a scrambled order, rows quantized from unit
    normals."""
    mp = C_ // pg
    ptab = rng.permutation(S_ * mp).astype(np.int32).reshape(S_, mp)
    slot_of = np.repeat(np.arange(S_), C_).astype(np.int32)
    cols = np.tile(np.arange(C_), S_).astype(np.int32)
    out = []
    for _ in range(2):
        full = jkv.with_page_table(
            jkv.init_paged((1, S_, C_, KV_, hd), jnp.int8, pg), jnp.asarray(ptab))
        rows = rng.normal(size=(S_ * C_, KV_, hd)).astype(np.float32)
        full = jkv.scatter_ragged(full, 0, jnp.asarray(slot_of),
                                  jnp.asarray(cols), jnp.asarray(rows))
        out.append(jkv.layer(full, 0))
    return out


@pytest.mark.parametrize("reference", ["jnp", "pallas_interpret"])
def test_k3_plain_matches_jax(reference):
    from localai_tpu.ops.attention import decode_attention_append
    from localai_tpu.ops.pallas.paged_attention import (
        paged_decode_attention_append_quant)
    from localai_tpu_torch.ops.paged_attention import (
        paged_decode_attention_quant)

    rng = np.random.default_rng(4)
    S_, C_, KV_, G, hd, pg = 4, 32, 2, 3, 16, 8
    lk, lv = _int8_pools(rng, S_, C_, KV_, hd, pg)
    q = rng.normal(size=(S_, KV_ * G, hd)).astype(np.float32)
    nk = rng.normal(size=(S_, KV_, hd)).astype(np.float32)
    nv = rng.normal(size=(S_, KV_, hd)).astype(np.float32)
    lengths = np.array([20, 5, C_, 0], np.int32)     # length == C; empty
    before = dict(LAUNCHES)
    out = paged_decode_attention_quant(
        _t(q), _t(nk), _t(nv), _t(lk["pages"]), _t(lk["scales"]),
        _t(lv["pages"]), _t(lv["scales"]), _t(lk["ptab"]), _t(lengths), G)
    assert LAUNCHES == before            # CPU tensors: plain version, no launch
    if reference == "jnp":
        ref = decode_attention_append(
            jnp.asarray(q), jnp.asarray(nk), jnp.asarray(nv),
            jkv.gather_all_rows(lk), jkv.gather_all_rows(lv),
            jnp.asarray(lengths), G)
        atol = 2e-5
    else:
        ref = paged_decode_attention_append_quant(
            jnp.asarray(q), jnp.asarray(nk), jnp.asarray(nv), lk["pages"],
            lk["scales"], lv["pages"], lv["scales"], lk["ptab"],
            jnp.asarray(lengths), G, interpret=True)
        atol = 3e-4
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=atol,
                               rtol=atol)


# ---------- K2-int8: ragged prefill over int8 pages ----------

@pytest.mark.parametrize("kind", ["fresh", "continued", "pad"])
def test_k2_int8_plain_matches_jax(kind):
    from localai_tpu.ops.ragged_prefill import ragged_prefill_attention
    from localai_tpu_torch.ops.ragged_prefill import (
        ragged_prefill_attention_paged)

    rng = np.random.default_rng(5)
    S_, C_, KV_, G, hd, pg, N = 4, 32, 2, 3, 16, 8, 24
    lk, lv = _int8_pools(rng, S_, C_, KV_, hd, pg)
    segs = {"fresh": [(0, 1, 0, 0, 6), (1, 3, 0, 6, 10), (2, 0, 0, 16, 8)],
            "continued": [(0, 1, 20, 0, 6), (1, 3, 0, 6, 10), (2, 0, 7, 16, 8)],
            "pad": [(0, 1, 20, 0, 6), (2, 0, 7, 9, 4)]}[kind]
    seg_of = np.full((N,), S_, np.int32)
    tabs = np.zeros((4, S_), np.int32)
    tabs[0] = S_
    for b, slot, start, off, ln in segs:
        seg_of[off:off + ln] = b
        tabs[:, b] = [slot, start, off, ln]
    q = rng.normal(size=(N, KV_ * G, hd)).astype(np.float32)
    ck = rng.normal(size=(N, KV_, hd)).astype(np.float32)
    cv = rng.normal(size=(N, KV_, hd)).astype(np.float32)
    before = dict(LAUNCHES)
    out = ragged_prefill_attention_paged(
        _t(q), _t(ck), _t(cv), _t(lk["pages"]), _t(lv["pages"]),
        _t(lk["ptab"]), *(_t(t) for t in tabs), G,
        scales_k=_t(lk["scales"]), scales_v=_t(lv["scales"]),
        continued=kind != "fresh").numpy()
    assert LAUNCHES == before
    ref = ragged_prefill_attention(
        jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(seg_of),
        jnp.asarray(tabs[0]), jnp.asarray(tabs[1]), lk, lv, G,
        continued=kind != "fresh")
    real = seg_of < S_
    np.testing.assert_allclose(out[real], np.asarray(ref)[real], atol=2e-5)


# ---------- the slice: tiny llama logits, engine tokens ----------

@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    from tests.tinymodel import write_tiny_checkpoint

    d = str(tmp_path_factory.mktemp("tiny_int8"))
    write_tiny_checkpoint(d)
    with open(os.path.join(d, "config.json")) as f:
        hf = json.load(f)
    jcfg = jllama.LlamaConfig.from_hf_config(hf, dtype=jnp.float32)
    jparams = jweights.load_llama_params(d, jcfg, dtype=jnp.float32)
    tcfg = tllama.LlamaConfig.from_hf_config(hf, dtype=torch.float32)
    tparams = tweights.from_jax_params(jax.tree.map(np.asarray, jparams),
                                       tcfg, device="cpu")
    return d, jcfg, jparams, tcfg, tparams


def test_int8_llama_logits_match_jax(tiny):
    """ragged_prefill (a fresh pack, then a continued pack with pads) and
    three decode steps on an int8 paged cache (page 16, scrambled table):
    logits match, and the caches hold byte-identical int8 rows."""
    _d, jcfg, jparams, tcfg, tparams = tiny
    S_, C_, pg = 4, 64, 16
    rng = np.random.default_rng(0)
    ptab = rng.permutation(S_ * C_ // pg).astype(np.int32).reshape(S_, -1)
    jck, jcv = jllama.init_cache(jcfg, S_, C_, jnp.int8, page_size=pg)
    jck = jkv.with_page_table(jck, jnp.asarray(ptab))
    jcv = jkv.with_page_table(jcv, jnp.asarray(ptab))
    tck, tcv = tllama.init_cache(tcfg, S_, C_, pg, dtype=torch.int8,
                                 device="cpu")
    tck["ptab"] = tcv["ptab"] = _t(ptab)
    assert tkv.is_quant(tck) and tkv.is_paged(tck)
    prompts = rng.integers(2, 258, size=(S_, 30)).astype(np.int32)
    lengths = np.zeros((S_,), np.int32)
    for segs, N, continued in (([(0, 0, 10), (2, 0, 7)], 24, False),
                               ([(0, 10, 6), (1, 0, 5), (2, 7, 4)], 20, True)):
        tokens = np.zeros((N,), np.int32)
        positions = np.full((N,), C_, np.int32)
        seg_of = np.full((N,), S_, np.int32)
        tabs = np.zeros((4, S_), np.int32)
        tabs[0] = S_
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
        real = [b for b in range(S_) if tabs[3, b] > 0]
        np.testing.assert_allclose(tl.numpy()[real], np.asarray(jl)[real],
                                   atol=ATOL, rtol=RTOL)
    toks = rng.integers(2, 258, size=(3, S_)).astype(np.int32)
    for step in range(3):
        jl, jck, jcv = jllama.decode_step(jparams, jcfg, jnp.asarray(toks[step]),
                                          jnp.asarray(lengths), jck, jcv)
        tl = tllama.decode_step(tparams, tcfg, _t(toks[step]), _t(lengths),
                                tck, tcv)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=RTOL)
        lengths += 1
    for li in range(jcfg.num_layers):
        for jc, tc in ((jck, tck), (jcv, tcv)):
            jr = jkv.gather_all_rows(jkv.layer(jc, li))
            tr = tkv.gather_all_rows(tkv.layer(tc, li))
            # rows equal up to one quantization level where the float32
            # projections differ in the last bits
            assert np.abs(tr["q"].numpy().astype(np.int32)
                          - np.asarray(jr["q"]).astype(np.int32)).max() <= 1
            np.testing.assert_allclose(tr["s"].numpy(), np.asarray(jr["s"]),
                                       atol=1e-6, rtol=1e-5)


def test_int8_engine_greedy_tokens_byte_identical_to_jax(tiny):
    """The port's Engine with cache_dtype int8 (paged, page 16, prompts
    split into continued packs by prefill_chunk 16) gives the JAX Engine's
    greedy tokens, byte for byte, on a concurrent mix."""
    _d, jcfg, jparams, tcfg, tparams = tiny
    je = jeng.Engine(jcfg, jparams, _Tok(), jeng.EngineConfig(
        num_slots=4, max_context=128, prefill_buckets=(16,),
        prefill_chunk=16, cache_dtype=jnp.int8, kv_layout="paged",
        kv_page_size=16, kv_prefix_cache=False, kv_offload=False,
        draft="0"))
    te = teng.Engine(tcfg, tparams, _Tok(), teng.EngineConfig(
        num_slots=4, max_context=128, prefill_chunk=16, kv_page_size=16,
        decode_burst=16, cache_dtype=torch.int8, kv_layout="paged",
        kv_offload=False, draft="0"), device="cpu")
    je.start()
    te.start()
    try:
        rng = np.random.default_rng(3)
        specs = [(rng.integers(2, 258, size=n).tolist(), m, ign)
                 for n, m, ign in ((40, 8, True), (12, 10, True), (70, 8, True),
                                   (9, 12, False), (25, 6, True), (5, 1, True))]
        ref = _wave(je, jeng, jsamp, specs)
        got = _wave(te, teng, tsamp, specs)
    finally:
        je.shutdown()
        te.shutdown()
    assert got == ref
    m = te.metrics()
    assert m["kv_layout"] == "paged" and m["cache_dtype"] == "int8"
    assert m["packed_prefill"]["continued"] > 0
    assert m["active_slots"] == 0 and m["pages_in_use"] == 0


# ---------- refusals ----------

def test_unsupported_kv_configurations_raise(tmp_path):
    from localai_tpu_torch.backend.runner import kv_cache_dtype_of, load_model

    cfg = tllama.LlamaConfig(vocab_size=64, hidden_size=32, intermediate_size=64,
                             num_layers=1, num_heads=2, num_kv_heads=1,
                             dtype=torch.float32)
    with pytest.raises(NotImplementedError, match="contiguous"):
        tllama.init_cache(cfg, 2, 32, 0, dtype=torch.int8, device="cpu")
    with pytest.raises(NotImplementedError, match="contiguous"):
        teng.Engine(cfg, tweights.random_params(cfg, 0, device="cpu"), _Tok(),
                    teng.EngineConfig(num_slots=2, max_context=32,
                                      cache_dtype=torch.int8,
                                      kv_layout="contiguous"), device="cpu")
    (tmp_path / "config.json").write_text(json.dumps({
        "vocab_size": 64, "hidden_size": 32, "intermediate_size": 64,
        "num_hidden_layers": 1, "num_attention_heads": 2,
        "num_key_value_heads": 1}))
    for kw, err in (({"kv_cache_dtype": "int8", "kv_layout": "contiguous"},
                     NotImplementedError),
                    ({"kv_cache_dtype": "q8_0", "kv_layout": "contiguous"},
                     NotImplementedError),
                    ({"kv_cache_dtype": "int4"}, ValueError),
                    ({"kv_cache_dtype": "float16"}, NotImplementedError),
                    ({"kv_layout": "ring"}, ValueError)):
        with pytest.raises(err):
            load_model(str(tmp_path), random_weights=0, device="cpu",
                       dtype="float32", **kw)
    assert kv_cache_dtype_of("Q8_0", torch.bfloat16) == torch.int8
    assert kv_cache_dtype_of("", torch.float32) == torch.float32
    with pytest.raises(NotImplementedError, match="model's dtype"):
        kv_cache_dtype_of("bf16", torch.float32)
    # the JAX package's accepted names, copied not imported: same set
    from localai_tpu.config.model_config import KV_CACHE_DTYPES
    from localai_tpu_torch.backend import runner

    assert set(runner.KV_CACHE_DTYPES) == set(KV_CACHE_DTYPES)


def test_load_model_serves_int8_cache_on_cpu(tmp_path):
    """load_model(kv_cache_dtype="int8") builds an int8 paged engine that
    answers a request (CPU: the plain versions)."""
    from localai_tpu_torch.backend.runner import load_model

    (tmp_path / "config.json").write_text(json.dumps({
        "vocab_size": 300, "hidden_size": 32, "intermediate_size": 64,
        "num_hidden_layers": 2, "num_attention_heads": 2,
        "num_key_value_heads": 1}))
    lm = load_model(str(tmp_path), "t", num_slots=2, context_size=64,
                    dtype="float32", random_weights=0, device="cpu",
                    kv_cache_dtype="q8_0", kv_page_size=16)
    try:
        assert lm.engine.ck["pages"].dtype == torch.int8
        _text, evs = lm.engine.generate_text(teng.GenRequest(
            prompt_ids=list(range(2, 30)), max_new_tokens=4, ignore_eos=True,
            params=tsamp.SamplingParamsHost(temperature=0.0)))
        assert evs[-1].completion_tokens == 4 and not evs[-1].error
        assert lm.engine.metrics()["cache_dtype"] == "int8"
    finally:
        lm.engine.shutdown()
