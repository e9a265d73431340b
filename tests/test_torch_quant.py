"""The PyTorch port's weight-only int8 / int4 weights against the JAX
package, on the CPU, at tiny sizes (``quantization: int8|int4``).

Inputs are made from a seed with numpy and fed to both packages. What is
pinned:
  * ``quantize_weight`` / ``quantize_weight_int4``: bit-identical q and s
    (the same float32 max, division by 127 or 7, 1e-12 clamp and
    round-half-to-even), 2-D and stacked, ``pick_int4_group`` (11008 at
    tp 1 and 8) and the int4 -> int8 fall-back when no group >= 16
    divides the contraction axis;
  * the int4 nibble packing round-trips; ``mat`` and ``quant_matmul``'s
    plain version (the CPU path; no launch counted) against the JAX
    ``mat`` / einsum;
  * the tiny f32 llama's prefill and decode logits under
    ``quantize_params`` (bits 8 and 4, a tied-embedding variant) against
    the JAX llama fed the same quantized params (``from_jax_params``);
  * greedy tokens byte-identical to the JAX Engine with int8 weights +
    int8 KV, and with int4 weights + paged float KV;
  * quantize at load (slice by slice) and ``random_params(quantize=)``
    equal quantizing the dense leaves whole; ``load_model``'s knob:
    unknown values raise ValueError before any weight is read,
    ``dtype="int8"`` means int8 weights.

Tolerances: ``mat`` 2e-4 absolute / 2e-3 relative; logits atol 2e-4 /
rtol 2e-3 (tests/test_torch_llama.py: float32 matmuls summed in another
order).
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
from localai_tpu.ops import quant as jquant
from localai_tpu_torch.engine import engine as teng
from localai_tpu_torch.engine import sampling as tsamp
from localai_tpu_torch.engine import weights as tweights
from localai_tpu_torch.models import llama as tllama
from localai_tpu_torch.ops import quant as tquant
from localai_tpu_torch.ops.kernels import LAUNCHES
from tests.test_torch_engine import _Tok, _wave
from tests.test_torch_llama import _pack

ATOL, RTOL = 2e-4, 2e-3


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _np(leaf) -> dict:
    """A JAX {q, s} leaf as numpy, int4 q as int8 values."""
    return {"q": np.asarray(leaf["q"]).astype(np.int8),
            "s": np.asarray(leaf["s"])}


def _weight(rng, shape):
    """Normal weights with per-column magnitudes over three decades, a
    zero column (the 1e-12 scale clamp) and exact halves (half to even)."""
    w = (rng.normal(size=shape) * rng.uniform(0.01, 10, size=shape[:-2] + (1, shape[-1]))
         ).astype(np.float32)
    w[..., 0] = 0.0
    w[..., 0, 1] = 127.0
    w[..., 1, 1] = 0.5          # 0.5 / (127 / 127) rounds to 0
    w[..., 2, 1] = 1.5
    return w


# ---------- (a) quantization, bit for bit ----------

@pytest.mark.parametrize("shape", [(64, 48), (3, 96, 32)])
def test_quantize_weight_int8_bit_identical_to_jax(shape):
    w = _weight(np.random.default_rng(0), shape)
    j = _np(jquant.quantize_weight(w))
    t = tquant.quantize_weight(_t(w))
    assert t["q"].dtype == torch.int8 and t["s"].dtype == torch.float32
    assert tuple(t["s"].shape) == j["s"].shape == shape[:-2] + (1, shape[-1])
    np.testing.assert_array_equal(t["q"].numpy(), j["q"])
    np.testing.assert_array_equal(t["s"].numpy(), j["s"])


@pytest.mark.parametrize("shape,group", [((128, 48), 128), ((96, 32), 128),
                                         ((2, 256, 64), 64), ((2, 80, 16), 32)])
def test_quantize_weight_int4_bit_identical_to_jax(shape, group):
    w = _weight(np.random.default_rng(1), shape)
    j = _np(jquant.quantize_weight_int4(w, group=group))
    t = tquant.quantize_weight_int4(_t(w), group=group)
    assert tquant.is_grouped(t)
    assert t["q"].dtype == torch.uint8
    assert tuple(t["q"].shape) == shape[:-1] + (shape[-1] // 2,)
    np.testing.assert_array_equal(tquant.unpack_int4(t["q"]).numpy(), j["q"])
    np.testing.assert_array_equal(t["s"].numpy(), j["s"])


@pytest.mark.parametrize("cin,group,tp", [(11008, 128, 1), (11008, 128, 8),
                                          (4096, 128, 1), (14336, 128, 8),
                                          (64, 128, 1), (48, 32, 1), (15, 128, 1),
                                          (17, 128, 1)])
def test_pick_int4_group_matches_jax(cin, group, tp):
    assert tquant.pick_int4_group(cin, group, tp) == \
        jquant.pick_int4_group(cin, group, tp)


def test_pick_int4_group_values():
    assert tquant.pick_int4_group(11008, 128, 1) == 128
    assert tquant.pick_int4_group(11008, 128, 8) == 86
    assert tquant.pick_int4_group(15) is None


def test_int4_falls_back_to_int8_without_a_group():
    """No group >= 16 divides 15 rows: both packages give int8."""
    w = _weight(np.random.default_rng(2), (15, 32))
    j = jquant.quantize_weight_int4(w)
    t = tquant.quantize_weight_int4(_t(w))
    assert not tquant.is_grouped(t) and t["q"].dtype == torch.int8
    assert not jquant.is_grouped(j)
    np.testing.assert_array_equal(t["q"].numpy(), np.asarray(j["q"]))
    np.testing.assert_array_equal(t["s"].numpy(), np.asarray(j["s"]))


def test_int4_odd_out_raises():
    with pytest.raises(ValueError, match="odd"):
        tquant.quantize_weight_int4(torch.ones(32, 7))


# ---------- (b) packing, mat, the plain product ----------

def test_pack_unpack_int4_round_trip_and_nibble_order():
    v = torch.arange(-8, 8, dtype=torch.int8).repeat(3, 2)      # [3, 32]
    p = tquant.pack_int4(v)
    assert p.dtype == torch.uint8 and tuple(p.shape) == (3, 16)
    torch.testing.assert_close(tquant.unpack_int4(p), v, rtol=0, atol=0)
    # column 2j in the low nibble of byte j, 2j + 1 in the high one
    assert int(p[0, 0]) == ((-8) & 0xF) | (((-7) & 0xF) << 4)
    rng = np.random.default_rng(3)
    r = torch.from_numpy(rng.integers(-8, 8, size=(2, 5, 64)).astype(np.int8))
    torch.testing.assert_close(tquant.unpack_int4(tquant.pack_int4(r)), r,
                               rtol=0, atol=0)


@pytest.mark.parametrize("bits", [8, 4])
def test_mat_and_plain_product_match_jax(bits):
    rng = np.random.default_rng(4)
    w = _weight(rng, (2, 128, 64))
    x = rng.normal(size=(5, 128)).astype(np.float32)
    jleaf = (jquant.quantize_weight_int4(w, group=32) if bits == 4
             else jquant.quantize_weight(w))
    tleaf = (tquant.quantize_weight_int4(_t(w), group=32) if bits == 4
             else tquant.quantize_weight(_t(w)))
    np.testing.assert_allclose(tquant.mat(tleaf, torch.float32).numpy(),
                               np.asarray(jquant.mat(jleaf, jnp.float32)),
                               atol=ATOL, rtol=RTOL)
    before = dict(LAUNCHES)
    layer = {"q": tleaf["q"][1], "s": tleaf["s"][1]}
    got = tquant.quant_matmul(_t(x), layer)
    assert LAUNCHES == before          # CPU tensors: the plain version
    ref = jnp.einsum("td,dh->th", jnp.asarray(x), jquant.mat(
        jax.tree.map(lambda a: a[1], jleaf), jnp.float32))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)
    # a dense weight is a plain product; a tied table is used transposed
    np.testing.assert_allclose(tquant.quant_matmul(_t(x), _t(w[0])).numpy(),
                               x @ w[0], atol=ATOL, rtol=RTOL)
    table = tquant.quantize_weight(_t(w[0].T.copy()))       # [out, in]
    np.testing.assert_allclose(
        tquant.quant_matmul(_t(x), table, transposed=True).numpy(),
        x @ tquant.mat(table, torch.float32).numpy().T, atol=ATOL, rtol=RTOL)


def test_mat_bf16_rounds_once_like_jax():
    w = _weight(np.random.default_rng(5), (64, 32))
    j = jquant.mat(jquant.quantize_weight(w), jnp.bfloat16)
    t = tquant.mat(tquant.quantize_weight(_t(w)), torch.bfloat16)
    np.testing.assert_array_equal(t.float().numpy(), np.asarray(j, np.float32))


@pytest.mark.parametrize("K,N,sms,want", [
    (4096, 4096, 132, 128), (4096, 1024, 132, 64), (4096, 14336, 132, 464),
    (14336, 4096, 132, 448), (4096, 128256, 132, 1024), (64, 32, 132, 64)])
def test_skinny_k_chunk(K, N, sms, want):
    """The skinny kernel's split of K: 64 to 1024 rows, a multiple of 16,
    and the 512-column tiles x splits within one wave of two blocks per
    SM wherever the 1024-row cap allows (lm_head's 251 tiles do not)."""
    c = tquant.skinny_k_chunk(K, N, sms)
    assert c == want and c % 16 == 0 and 64 <= c <= tquant.MAX_K_CHUNK
    blocks = -(-N // tquant.TILE_N) * -(-K // c)
    assert blocks <= 2 * sms or c == tquant.MAX_K_CHUNK


# ---------- (c) the tiny llama's logits ----------

@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    from tests.tinymodel import write_tiny_checkpoint

    d = str(tmp_path_factory.mktemp("tiny_quant"))
    write_tiny_checkpoint(d)
    with open(os.path.join(d, "config.json")) as f:
        hf = json.load(f)
    jcfg = jllama.LlamaConfig.from_hf_config(hf, dtype=jnp.float32)
    jparams = jweights.load_llama_params(d, jcfg, dtype=jnp.float32)
    tcfg = tllama.LlamaConfig.from_hf_config(hf, dtype=torch.float32)
    return d, hf, jcfg, jparams, tcfg


def _quantized(jparams, tcfg, bits):
    """(JAX quantized params, the port's copy through from_jax_params)."""
    jq = jllama.quantize_params(jparams, bits=bits)
    np_params = jax.tree.map(np.asarray, jq)
    return jq, tweights.from_jax_params(np_params, tcfg, device="cpu")


def _logits_match(jcfg, jparams, tcfg, tparams, seed=0):
    """A fresh pack, a continued pack with pads, three decode steps on a
    paged float cache (page 16, scrambled table): logits match."""
    S, C, PG = 4, 64, 16
    rng = np.random.default_rng(seed)
    ptab = rng.permutation(S * C // PG).astype(np.int32).reshape(S, -1)
    jck, jcv = jllama.init_cache(jcfg, S, C, jnp.float32, page_size=PG)
    jck = jkv.with_page_table(jck, jnp.asarray(ptab))
    jcv = jkv.with_page_table(jcv, jnp.asarray(ptab))
    tck, tcv = tllama.init_cache(tcfg, S, C, PG, device="cpu")
    tck["ptab"] = tcv["ptab"] = _t(ptab)
    prompts = {s: rng.integers(2, jcfg.vocab_size, size=30).astype(np.int32)
               for s in range(S)}
    lengths = np.zeros((S,), np.int32)
    for segs, N, continued in (([(0, 0, 10), (2, 0, 7)], 24, False),
                               ([(0, 10, 6), (1, 0, 5), (2, 7, 4)], 20, True)):
        arrs = _pack(segs, N, prompts)
        jl, jck, jcv = jllama.ragged_prefill(
            jparams, jcfg, *map(jnp.asarray, arrs), jck, jcv, continued=continued)
        tok, pos, seg_of, sl, st, so, sn = (_t(a) for a in arrs)
        tl = tllama.ragged_prefill(tparams, tcfg, tok, pos, sl, st, so, sn,
                                   seg_of, tck, tcv, continued=continued)
        real = [b for b in range(S) if arrs[6][b] > 0]
        np.testing.assert_allclose(tl.numpy()[real], np.asarray(jl)[real],
                                   atol=ATOL, rtol=RTOL)
        for slot, start, ln in segs:
            lengths[slot] = start + ln
    toks = rng.integers(2, jcfg.vocab_size, size=(3, S)).astype(np.int32)
    for step in range(3):
        jl, jck, jcv = jllama.decode_step(jparams, jcfg, jnp.asarray(toks[step]),
                                          jnp.asarray(lengths), jck, jcv)
        tl = tllama.decode_step(tparams, tcfg, _t(toks[step]), _t(lengths),
                                tck, tcv)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=RTOL)
        lengths += 1


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_llama_logits_match_jax(tiny, bits):
    _d, _hf, jcfg, jparams, tcfg = tiny
    jq, tq = _quantized(jparams, tcfg, bits)
    assert tquant.is_grouped(tq["layers"]["w_down"]) == (bits == 4)
    assert tq["embed"]["q"].dtype == torch.int8          # embed stays int8
    assert not isinstance(tq["layers"]["attn_norm"], dict)
    # the port's own quantize_params gives the same leaves
    own = tllama.quantize_params(
        tweights.from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                                 device="cpu"), bits=bits)
    for k in ("wq", "w_down"):
        for part in ("q", "s"):
            torch.testing.assert_close(own["layers"][k][part],
                                       tq["layers"][k][part], rtol=0, atol=0)
    _logits_match(jcfg, jq, tcfg, tq)


@pytest.mark.parametrize("bits", [8, 4])
def test_tied_quantized_llama_logits_match_jax(tiny, bits):
    """Tied embeddings: the int8 table's scale lies along D, the unembed's
    contraction axis; both packages use the table transposed."""
    _d, hf, _jcfg, _jparams, _tcfg = tiny
    hf = dict(hf, tie_word_embeddings=True)
    jcfg = jllama.LlamaConfig.from_hf_config(hf, dtype=jnp.float32)
    tcfg = tllama.LlamaConfig.from_hf_config(hf, dtype=torch.float32)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(7))
    assert "lm_head" not in jparams
    jq, tq = _quantized(jparams, tcfg, bits)
    _logits_match(jcfg, jq, tcfg, tq, seed=1)


def test_dequantize_params_matches_jax(tiny):
    _d, _hf, _jcfg, jparams, tcfg = tiny
    jq, tq = _quantized(jparams, tcfg, 4)
    jd = jllama.dequantize_params(jq, jnp.float32)
    td = tllama.dequantize_params(tq, torch.float32)
    for k in ("wq", "w_gate", "attn_norm"):
        np.testing.assert_allclose(td["layers"][k].numpy(),
                                   np.asarray(jd["layers"][k]), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(td["embed"].numpy(), np.asarray(jd["embed"]),
                               atol=ATOL, rtol=RTOL)


# ---------- (d) greedy tokens against the JAX Engine ----------

@pytest.mark.parametrize("bits,kv", [(8, "int8"), (4, "float")])
def test_quantized_engine_greedy_tokens_byte_identical_to_jax(tiny, bits, kv):
    """int8 weights + int8 KV (the README's YAML), and int4 weights + paged
    float KV: the port's Engine gives the JAX Engine's greedy tokens byte
    for byte on a concurrent mix with continued packs."""
    _d, _hf, jcfg, jparams, tcfg = tiny
    jq, tq = _quantized(jparams, tcfg, bits)
    jdt, tdt = (jnp.int8, torch.int8) if kv == "int8" else (jnp.float32, torch.float32)
    je = jeng.Engine(jcfg, jq, _Tok(), jeng.EngineConfig(
        num_slots=4, max_context=128, prefill_buckets=(16,),
        prefill_chunk=16, cache_dtype=jdt, kv_layout="paged",
        kv_page_size=16, kv_prefix_cache=False, kv_offload=False,
        draft="0"))
    te = teng.Engine(tcfg, tq, _Tok(), teng.EngineConfig(
        num_slots=4, max_context=128, prefill_chunk=16, kv_page_size=16,
        decode_burst=16, cache_dtype=tdt, kv_layout="paged", kv_offload=False,
        draft="0"), device="cpu")
    je.start()
    te.start()
    try:
        rng = np.random.default_rng(3)
        specs = [(rng.integers(2, 258, size=n).tolist(), m, ign)
                 for n, m, ign in ((40, 8, True), (12, 10, True), (70, 8, True),
                                   (9, 12, False), (25, 6, True))]
        ref = _wave(je, jeng, jsamp, specs)
        got = _wave(te, teng, tsamp, specs)
    finally:
        je.shutdown()
        te.shutdown()
    assert got == ref
    assert te.metrics()["packed_prefill"]["continued"] > 0


# ---------- quantize at load, random weights, the load_model knob ----------

@pytest.mark.parametrize("quantize", ["int8", "int4"])
def test_load_llama_params_quantizes_slice_by_slice_like_jax(tiny, quantize):
    """Quantizing each layer slice on load gives the bytes of the JAX
    loader's whole-leaf quantization (int4 on layer matmuls only)."""
    d, _hf, jcfg, _jparams, tcfg = tiny
    jp = jweights.load_llama_params(d, jcfg, dtype=jnp.float32, quantize=quantize)
    tp = tweights.load_llama_params(d, tcfg, device="cpu", quantize=quantize)
    for path in (("embed",), ("lm_head",), ("layers", "wq"), ("layers", "wk"),
                 ("layers", "w_down")):
        j, t = jp, tp
        for k in path:
            j, t = j[k], t[k]
        assert tquant.is_grouped(t) == (quantize == "int4" and path[0] == "layers")
        jn = _np(j)
        q = tquant.unpack_int4(t["q"]) if tquant.is_grouped(t) else t["q"]
        np.testing.assert_array_equal(q.numpy(), jn["q"], err_msg=str(path))
        np.testing.assert_array_equal(t["s"].numpy(), jn["s"], err_msg=str(path))
    np.testing.assert_array_equal(tp["layers"]["attn_norm"].numpy(),
                                  np.asarray(jp["layers"]["attn_norm"]))


@pytest.mark.parametrize("quantize", ["int8", "int4"])
def test_random_params_quantize_as_drawn(quantize):
    """random_params(quantize=) quantizes the same float32 draws the dense
    model is made of, slice by slice: equal to quantizing them whole."""
    cfg = tllama.LlamaConfig(vocab_size=96, hidden_size=64, intermediate_size=128,
                             num_layers=3, num_heads=4, num_kv_heads=2,
                             dtype=torch.float32)
    dense = tweights.random_params(cfg, 11, device="cpu")
    quant = tweights.random_params(cfg, 11, device="cpu", quantize=quantize)
    want = tllama.quantize_params(dense, bits=4 if quantize == "int4" else 8)
    for k in ("wq", "wk", "w_gate", "w_down"):
        for part in ("q", "s"):
            torch.testing.assert_close(quant["layers"][k][part],
                                       want["layers"][k][part], rtol=0, atol=0)
    for k in ("embed", "lm_head"):
        assert quant[k]["q"].dtype == torch.int8
        torch.testing.assert_close(quant[k]["q"], want[k]["q"], rtol=0, atol=0)
    torch.testing.assert_close(quant["final_norm"], dense["final_norm"])


def _config_dir(tmp_path):
    (tmp_path / "config.json").write_text(json.dumps({
        "vocab_size": 300, "hidden_size": 64, "intermediate_size": 128,
        "num_hidden_layers": 2, "num_attention_heads": 4,
        "num_key_value_heads": 2}))
    return str(tmp_path)


def test_load_model_refuses_unknown_quantization_before_loading(tmp_path, monkeypatch):
    from localai_tpu_torch.backend import runner

    d = _config_dir(tmp_path)

    def no_load(*a, **k):
        raise AssertionError("weights read before the knob was checked")

    monkeypatch.setattr(runner.weights, "random_params", no_load)
    monkeypatch.setattr(runner.weights, "load_llama_params", no_load)
    for bad in ("int3", "q4_0"):
        with pytest.raises(ValueError, match="quantization"):
            runner.load_model(d, random_weights=0, device="cpu",
                              dtype="float32", quantization=bad)
    # the CLI exposes the knob
    from localai_tpu_torch.cli import build_parser

    args = build_parser().parse_args(["run", "--model", d, "--quantization", "int4"])
    assert args.quantization == "int4"


@pytest.mark.parametrize("kw,want", [({"dtype": "int8"}, "int8"),
                                     ({"quantization": "int4"}, "int4")])
def test_load_model_serves_quantized_weights_on_cpu(tmp_path, kw, want):
    """dtype="int8" is the legacy alias of int8 weights (bfloat16 compute);
    quantization="int4" packs the layer matmuls. Both answer a request."""
    from localai_tpu_torch.backend.runner import load_model

    kw = {"dtype": "float32", **kw}
    lm = load_model(_config_dir(tmp_path), "t", num_slots=2, context_size=64,
                    random_weights=0, device="cpu", kv_page_size=16, **kw)
    try:
        p = lm.engine.params
        assert lm.quantization == want
        assert tquant.is_grouped(p["layers"]["w_up"]) == (want == "int4")
        assert p["embed"]["q"].dtype == torch.int8
        if kw["dtype"] == "int8":
            assert lm.cfg.dtype == torch.bfloat16
        _text, evs = lm.engine.generate_text(teng.GenRequest(
            prompt_ids=list(range(2, 30)), max_new_tokens=4, ignore_eos=True,
            params=tsamp.SamplingParamsHost(temperature=0.0)))
        assert evs[-1].completion_tokens == 4 and not evs[-1].error
    finally:
        lm.engine.shutdown()
