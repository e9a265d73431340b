"""The port's GGUF loader (localai_tpu_torch/engine/gguf.py, the GGUF
branch of engine/weights.py, engine/gguf_tokenizer.py::from_gguf and the
runner's GGUF paths) against the JAX package's, on the CPU, on inputs made
with numpy from a seed at tiny f32 widths:

  * ``_dequantize`` bit for bit on random blocks of each of the eleven
    tensor types (one case per type), and ``GGUFFile.tensor`` on a file,
    its threaded split of a big tensor included;
  * ``write_gguf``: the same bytes from the same inputs;
  * ``config_from_gguf``: equal fields for none / linear / yarn rope
    scaling, tied and untied;
  * ``iter_llama_tensors``: equal leaves (the wq / wk ``_unpermute``
    included), per tensor type the writer encodes;
  * ``from_gguf``: equal ids on 200 texts, SentencePiece and byte-level
    BPE metadata;
  * a GGUF main model (F32 and Q8_0) through ``load_model`` (the file, and
    a dir holding it) and ``run --model FILE.gguf``: greedy tokens equal
    the JAX Engine's on the same file, request by request;
  * a GGUF draft dir (``draft_model``): greedy tokens with draft-model
    speculation equal the JAX Engine's with the same draft, and so do the
    spec counters each request adds.
"""

from __future__ import annotations

import tests.torch_cpu  # noqa: F401  (one torch CPU thread)

import dataclasses
import json
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localai_tpu.engine import engine as jeng
from localai_tpu.engine import gguf as jgguf
from localai_tpu.engine import gguf_tokenizer as jgtok
from localai_tpu.engine import sampling as jsamp
from localai_tpu.engine import weights as jweights
from localai_tpu.models import llama as jllama
from localai_tpu_torch.backend import runner
from localai_tpu_torch.engine import engine as teng
from localai_tpu_torch.engine import gguf as tgguf
from localai_tpu_torch.engine import gguf_tokenizer as tgtok
from localai_tpu_torch.engine import sampling as tsamp
from localai_tpu_torch.engine import weights as tweights
from tests.test_gguf import _spm_meta
from tests.test_torch_tokenizer_bpe import _gpt2_meta, texts

# the tiny widths (tests/test_gguf.py's tiny llama, vocab of the tiny
# checkpoint so a GGUF draft pairs with it)
TINY = dict(vocab_size=258, hidden_size=64, intermediate_size=128,
            num_layers=2, num_heads=4, num_kv_heads=2,
            max_position_embeddings=256)
SMALL = dict(TINY, hidden_size=32, intermediate_size=64, num_layers=1,
             num_heads=2, num_kv_heads=1)
# (name, ggml type, offsets of its f16 fields in a block)
TYPES = [("F32", jgguf.GGML_F32, ()), ("F16", jgguf.GGML_F16, ()),
         ("BF16", jgguf.GGML_BF16, ()), ("Q8_0", jgguf.GGML_Q8_0, (0,)),
         ("Q4_0", jgguf.GGML_Q4_0, (0,)), ("Q4_1", jgguf.GGML_Q4_1, (0, 2)),
         ("Q5_0", jgguf.GGML_Q5_0, (0,)), ("Q5_1", jgguf.GGML_Q5_1, (0, 2)),
         ("Q4_K", jgguf.GGML_Q4_K, (0, 2)), ("Q5_K", jgguf.GGML_Q5_K, (0, 2)),
         ("Q6_K", jgguf.GGML_Q6_K, (208,))]
ENGINE = dict(num_slots=2, max_context=128, prefill_buckets=(16, 32),
              prefill_chunk=32, kv_page_size=16, kv_offload=False)


def _bits(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a).view(np.uint8)


def random_raw(ttype: int, fields: tuple, n_blocks: int, rng) -> tuple:
    """(raw uint8 buffer, element count) of ``n_blocks`` random blocks:
    random bytes, with finite float16 scale fields; float types from
    normal draws."""
    be, bb = tgguf._BLOCK[ttype]
    n = n_blocks * be
    if ttype == jgguf.GGML_F32:
        return rng.standard_normal(n, dtype=np.float32).view(np.uint8), n
    if ttype == jgguf.GGML_F16:
        return rng.standard_normal(n).astype(np.float16).view(np.uint8), n
    if ttype == jgguf.GGML_BF16:
        f = rng.standard_normal(n, dtype=np.float32)
        return (f.view(np.uint32) >> 16).astype(np.uint16).view(np.uint8), n
    raw = rng.integers(0, 256, size=(n_blocks, bb), dtype=np.uint8)
    for off in fields:
        d = (rng.standard_normal(n_blocks) * 0.05).astype(np.float16)
        raw[:, off:off + 2] = d.view(np.uint8).reshape(n_blocks, 2)
    return raw.reshape(-1), n


@pytest.mark.parametrize("name,ttype,fields", TYPES, ids=[t[0] for t in TYPES])
def test_dequantize_equals_jax_bit_for_bit(name, ttype, fields):
    rng = np.random.default_rng(ttype + 11)
    raw, n = random_raw(ttype, fields, 48, rng)
    want = jgguf._dequantize(raw.copy(), ttype, n)
    got = tgguf._dequantize(raw.copy(), ttype, n)
    assert got.dtype == want.dtype == np.float32 and got.shape == (n,)
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_gguf_file_tensor_equals_jax_threaded_split_included(tmp_path, monkeypatch):
    """GGUFFile.tensor on a file of K-quant blocks (written raw), in both
    dtypes, and with the big-tensor split forced onto this small tensor."""
    rng = np.random.default_rng(4)
    path = str(tmp_path / "k.gguf")
    tgguf.write_gguf(path, {"general.architecture": "llama"},
                     {"w": rng.standard_normal((8, 256), dtype=np.float32)})
    # rewrite the tensor's type and bytes as Q6_K blocks of the same count
    raw, n = random_raw(jgguf.GGML_Q6_K, (208,), 8, rng)
    g = tgguf.GGUFFile(path)
    data = bytearray(open(path, "rb").read())
    start = g.data_start + g.tensors["w"]["offset"]
    data[start:] = raw.tobytes()
    head = data[:start]
    i = head.rfind(b"w") + 1 + 4 + 16          # name, n_dims, dims
    head[i:i + 4] = int(jgguf.GGML_Q6_K).to_bytes(4, "little")
    data[:start] = head
    open(path, "wb").write(bytes(data))
    jg, tg = jgguf.GGUFFile(path), tgguf.GGUFFile(path)
    for dtype in (np.float32, np.float16):
        want = jg.tensor("w", dtype)
        np.testing.assert_array_equal(_bits(tg.tensor("w", dtype)), _bits(want))
        monkeypatch.setattr(tgguf, "_SPLIT_ELEMS", 1)
        monkeypatch.setattr(tgguf, "_THREADS", 3)
        np.testing.assert_array_equal(_bits(tg.tensor("w", dtype)), _bits(want))
        monkeypatch.undo()


def test_unsupported_type_raises_naming_it(tmp_path):
    path = str(tmp_path / "q2.gguf")
    tgguf.write_gguf(path, {}, {"w": np.zeros((1, 32), np.float32)})
    g = tgguf.GGUFFile(path)
    g.tensors["w"]["type"] = jgguf.GGML_Q2_K
    with pytest.raises(ValueError, match="Q2_K"):
        g.tensor("w")


def test_write_gguf_writes_the_jax_bytes(tmp_path):
    rng = np.random.default_rng(7)
    meta = {"general.architecture": "llama", "general.name": "tiny",
            "llama.block_count": 2, "llama.rope.freq_base": 10000.0,
            "neg": -3, "flag": True, "tokens": ["<s>", "a", "ü", ""],
            "scores": [0.0, -1.5, 2.25], "types": [1, 3, 6, -2]}
    tensors = {"f32": rng.standard_normal((3, 5), dtype=np.float32),
               "f16": rng.standard_normal((4, 64), dtype=np.float32),
               "q8": rng.standard_normal((6, 96), dtype=np.float32),
               "q4": rng.standard_normal((5, 64), dtype=np.float32),
               "zero": np.zeros((2, 32), np.float32)}
    types = {"f16": jgguf.GGML_F16, "q8": jgguf.GGML_Q8_0,
             "q4": jgguf.GGML_Q4_0, "zero": jgguf.GGML_Q4_0}
    a, b = str(tmp_path / "port.gguf"), str(tmp_path / "jax.gguf")
    tgguf.write_gguf(a, meta, tensors, types)
    jgguf.write_gguf(b, meta, tensors, types)
    assert open(a, "rb").read() == open(b, "rb").read()
    g = tgguf.GGUFFile(a)
    assert g.metadata == jgguf.GGUFFile(b).metadata


def gguf_tensors(params: dict, cfg) -> dict:
    """The GGUF tensors of a JAX parameter pytree: HF-oriented matrices,
    wq / wk rows in the interleaved layout (the inverse of _unpermute)."""
    def permute(w_oi, n_heads):
        out, inn = w_oi.shape
        return (w_oi.reshape(n_heads, 2, out // n_heads // 2, inn)
                .swapaxes(1, 2).reshape(out, inn))

    np32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    out = {"token_embd.weight": np32(params["embed"])}
    ly = params["layers"]
    for i in range(cfg.num_layers):
        p = f"blk.{i}."
        out[p + "attn_norm.weight"] = np32(ly["attn_norm"][i])
        out[p + "attn_q.weight"] = permute(np32(ly["wq"][i]).T, cfg.num_heads)
        out[p + "attn_k.weight"] = permute(np32(ly["wk"][i]).T, cfg.num_kv_heads)
        out[p + "attn_v.weight"] = np32(ly["wv"][i]).T
        out[p + "attn_output.weight"] = np32(ly["wo"][i]).T
        out[p + "ffn_norm.weight"] = np32(ly["mlp_norm"][i])
        out[p + "ffn_gate.weight"] = np32(ly["w_gate"][i]).T
        out[p + "ffn_up.weight"] = np32(ly["w_up"][i]).T
        out[p + "ffn_down.weight"] = np32(ly["w_down"][i]).T
    out["output_norm.weight"] = np32(params["final_norm"])
    if not cfg.tie_word_embeddings:
        out["output.weight"] = np32(params["lm_head"]).T
    return out


def gguf_meta(cfg, scaling: str = "none", factor: float = 4.0,
              orig: int = 64, tokenizer: dict = None) -> dict:
    md = {"general.architecture": "llama",
          "llama.block_count": cfg.num_layers,
          "llama.embedding_length": cfg.hidden_size,
          "llama.feed_forward_length": cfg.intermediate_size,
          "llama.attention.head_count": cfg.num_heads,
          "llama.attention.head_count_kv": cfg.num_kv_heads,
          "llama.rope.dimension_count": cfg.head_dim_,
          "llama.rope.freq_base": float(cfg.rope_theta),
          "llama.attention.layer_norm_rms_epsilon": float(cfg.rms_norm_eps),
          "llama.context_length": cfg.max_position_embeddings}
    if scaling != "none":
        md.update({"llama.rope.scaling.type": scaling,
                   "llama.rope.scaling.factor": float(factor),
                   "llama.rope.scaling.original_context_length": orig})
    tok = tokenizer if tokenizer is not None else byte_spm_meta(cfg.vocab_size)
    md.update({k: v for k, v in tok.items() if v is not None})
    return md


def byte_spm_meta(vocab: int) -> dict:
    """A SentencePiece vocabulary of ``vocab`` pieces: <unk>, <s>, </s>,
    then byte pieces (every ASCII text encodes byte by byte)."""
    toks = ["<unk>", "<s>", "</s>"] + [f"<0x{b:02X}>" for b in range(vocab - 3)]
    return {"tokenizer.ggml.model": "llama", "tokenizer.ggml.tokens": toks,
            "tokenizer.ggml.scores": [0.0] * vocab,
            "tokenizer.ggml.token_type": [2, 3, 3] + [6] * (vocab - 3),
            "tokenizer.ggml.bos_token_id": 1, "tokenizer.ggml.eos_token_id": 2,
            "tokenizer.ggml.unknown_token_id": 0}


def write_model_gguf(path: str, cfg_kw: dict, seed: int, ttype=jgguf.GGML_F32,
                     tie: bool = False, **meta) -> tuple:
    """A llama GGUF file from JAX init weights; (JAX config, params)."""
    cfg = jllama.LlamaConfig(**cfg_kw, tie_word_embeddings=tie, dtype=jnp.float32)
    params = jllama.init_params(cfg, jax.random.PRNGKey(seed), dtype=jnp.float32)
    tensors = gguf_tensors(params, cfg)
    types = {n: ttype for n, a in tensors.items() if np.asarray(a).ndim == 2} \
        if ttype != jgguf.GGML_F32 else {}
    jgguf.write_gguf(path, gguf_meta(cfg, **meta), tensors, types)
    return cfg, params


def _fields(cfg) -> dict:
    """A LlamaConfig's fields but the dtype (and the JAX-only
    attention_bias, which no GGUF key sets)."""
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if f.name not in ("dtype", "attention_bias")}


@pytest.mark.parametrize("tie", (False, True), ids=("untied", "tied"))
@pytest.mark.parametrize("scaling", ("none", "linear", "yarn"))
def test_config_from_gguf_equals_jax(tmp_path, scaling, tie):
    path = str(tmp_path / "m.gguf")
    write_model_gguf(path, TINY, 1, tie=tie, scaling=scaling, factor=4.0,
                     orig=64)
    want = jgguf.config_from_gguf(path)
    got = tgguf.config_from_gguf(path)
    assert _fields(got) == _fields(want)
    assert got.rope_scaling_type == scaling and got.tie_word_embeddings == tie
    assert got.vocab_size == TINY["vocab_size"]


@pytest.mark.parametrize("ttype", (jgguf.GGML_F32, jgguf.GGML_F16,
                                   jgguf.GGML_Q8_0, jgguf.GGML_Q4_0),
                         ids=("F32", "F16", "Q8_0", "Q4_0"))
def test_iter_llama_tensors_equals_jax(tmp_path, ttype):
    path = str(tmp_path / "m.gguf")
    write_model_gguf(path, TINY, 2, ttype=ttype)
    jg, tg = jgguf.GGUFFile(path), tgguf.GGUFFile(path)
    cfg = tgguf.config_from_gguf(tg)
    want = list(jgguf.iter_llama_tensors(jg, jgguf.config_from_gguf(jg)))
    got = list(tgguf.iter_llama_tensors(tg, cfg))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (p, a), (_p, b) in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype == np.float16, p
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=str(p))
    # the leaves the port places are those arrays, cast
    params = tweights.load_llama_params(path, dataclasses.replace(
        cfg, dtype=torch.float32), device="cpu")
    np.testing.assert_array_equal(
        params["layers"]["wq"].numpy(),
        dict(want)[("layers", "wq")].astype(np.float32))


@pytest.mark.parametrize("meta", [_spm_meta, _gpt2_meta], ids=["spm", "gpt2"])
def test_from_gguf_equals_jax_on_200_texts(tmp_path, meta):
    path = str(tmp_path / f"{meta.__name__}.gguf")
    md = {k: v for k, v in meta().items() if v is not None}
    tgguf.write_gguf(path, md, {"x": np.zeros((1, 32), np.float32)})
    j, t = jgtok.from_gguf(path), tgtok.from_gguf(path)
    assert t.get_vocab_size() == j.get_vocab_size()
    assert (t.bos_token_id, t.eos_token_id) == (j.bos_token_id, j.eos_token_id)
    for text in texts(23, 200):
        ids = j.encode(text)
        assert t.encode(text) == ids, repr(text)
        assert t.decode(ids) == j.decode(ids)


def _submit(e, prompt, n):
    mod, samp = (teng, tsamp) if isinstance(e, teng.Engine) else (jeng, jsamp)
    return e.submit(mod.GenRequest(
        prompt_ids=list(prompt), max_new_tokens=n, ignore_eos=True,
        params=samp.SamplingParamsHost(temperature=0.0)))


def _drain(out) -> list:
    ids = []
    while (ev := out.get(timeout=600)) is not None:
        assert not ev.error, ev.error
        ids.extend(ev.token_ids or ([ev.token_id] if ev.token_id >= 0 else []))
    return ids


def jax_gguf_engine(path: str, draft_path: str = "", **knobs):
    """The JAX Engine over a GGUF file as the JAX runner loads one
    (config, weights and tokenizer from the file), optionally with a GGUF
    draft."""
    cfg = dataclasses.replace(jgguf.config_from_gguf(path), dtype=jnp.float32)
    params = jweights.load_llama_params(path, cfg, dtype=jnp.float32)
    draft = None
    if draft_path:
        dcfg = dataclasses.replace(jgguf.config_from_gguf(draft_path),
                                   dtype=jnp.float32)
        draft = (dcfg, jweights.load_llama_params(draft_path, dcfg,
                                                  dtype=jnp.float32))
    je = jeng.Engine(cfg, params, jgtok.from_gguf(path),
                     jeng.EngineConfig(**{**ENGINE, **knobs}), draft=draft)
    je.start()
    return je


def port_knobs(**knobs) -> dict:
    kw = {**ENGINE, **knobs}
    return dict(device="cpu", dtype="float32", num_slots=kw.pop("num_slots"),
                context_size=kw.pop("max_context"), **kw)


PROMPTS = ["the card pages hello", "a page of the card", "hello hello hello",
           "rows and pages"]


@pytest.mark.parametrize("ttype", (jgguf.GGML_F32, jgguf.GGML_Q8_0),
                         ids=("F32", "Q8_0"))
def test_gguf_main_model_tokens_equal_the_jax_engine(tmp_path, ttype):
    """load_model on the .gguf path and on its dir, and (F32) ``run --model
    FILE.gguf`` over HTTP: config and tokenizer from the file, greedy
    tokens equal the JAX Engine's request by request."""
    d = tmp_path / "m"
    d.mkdir()
    path = str(d / "tiny.gguf")
    # seed 5: the weights of seeds 3, 4, 8 and 9 put a greedy step of
    # these prompts on a near-tie in F32 or Q8_0 (seed 3's Q8_0: a top-2
    # logit gap of 1.6e-4, where the JAX Engine's decode step picks the
    # runner-up and JAX's own unpacked prefill, like the port, agreeing
    # with it to 1.8e-6, picks the top)
    write_model_gguf(path, TINY, 5, ttype=ttype)
    je = jax_gguf_engine(path, draft="0")
    try:
        ids = [jgtok.from_gguf(path).encode(p) for p in PROMPTS]
        want = [_drain(_submit(je, p, 12)) for p in ids]
    finally:
        je.shutdown()
    for where in (path, str(d)):
        lm = runner.load_model(where, "tiny", **port_knobs(draft="0"))
        try:
            assert isinstance(lm.tokenizer, tgtok.GGUFTokenizer)
            assert [lm.tokenizer.encode(p) for p in PROMPTS] == ids
            assert _fields(lm.cfg) == _fields(jgguf.config_from_gguf(path))
            got = [_drain(_submit(lm.engine, p, 12)) for p in ids]
        finally:
            lm.engine.shutdown()
        assert got == want, where
    if ttype != jgguf.GGML_F32:
        return
    from localai_tpu_torch.api.app import make_server
    from localai_tpu_torch.cli import build_app, build_parser

    args = build_parser().parse_args(
        ["run", "--model", path, "--name", "tiny", "--device", "cpu",
         "--dtype", "float32", "--num-slots", "2", "--context-size", "128",
         "--kv-page-size", "16", "--prefill-chunk", "32", "--kv-offload", "0",
         "--draft", "0"])
    app = build_app(args)
    server = make_server(app, "127.0.0.1", 0)
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    try:
        lm = app.models["tiny"]
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.server_address[1]}/v1/completions",
            data=json.dumps({"model": "tiny", "prompt": PROMPTS[0],
                             "max_tokens": 12, "temperature": 0,
                             "ignore_eos": True}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            body = json.loads(resp.read())
        assert body["usage"]["completion_tokens"] == 12
        assert body["choices"][0]["text"] == lm.tokenizer.decode(want[0])
    finally:
        server.shutdown()
        server.server_close()
        app.shutdown()


def test_gguf_draft_tokens_equal_the_jax_engine(tmp_path):
    """A GGUF draft dir (Q8_0, one layer) beside a GGUF target:
    ``draft_model`` relative to the target's dir; greedy tokens with
    draft-model speculation, and the spec counters each request adds,
    equal the JAX Engine's with the same draft; the draft's leaves are
    the file's."""
    d = tmp_path / "m"
    (d / "draft").mkdir(parents=True)
    path, dpath = str(d / "tiny.gguf"), str(d / "draft" / "small.gguf")
    write_model_gguf(path, TINY, 3)
    write_model_gguf(dpath, SMALL, 5, ttype=jgguf.GGML_Q8_0, tie=True)
    keys = ("rounds", "proposed", "accepted", "tokens")
    je = jax_gguf_engine(path, dpath)
    try:
        assert je._spec_mode == "model"
        ids = [jgtok.from_gguf(path).encode(p) for p in PROMPTS]
        want = []
        for p in ids:
            m0 = dict(je.metrics()["spec"])
            toks = _drain(_submit(je, p, 20))
            m1 = je.metrics()["spec"]
            want.append((toks, {k: m1[k] - m0[k] for k in keys}))
    finally:
        je.shutdown()
    lm = runner.load_model(path, "tiny", **port_knobs(), draft_model="draft")
    try:
        e = lm.engine
        assert e._spec_mode == "model" and e.draft_cfg.num_layers == 1
        assert e.draft_cfg.tie_word_embeddings
        got = []
        for p in ids:
            m0 = dict(e.metrics()["spec"])
            toks = _drain(_submit(e, p, 20))
            m1 = e.metrics()["spec"]
            got.append((toks, {k: m1[k] - m0[k] for k in keys}))
        dcfg = tgguf.config_from_gguf(dpath)
        leaves = dict(tgguf.iter_llama_tensors(tgguf.GGUFFile(dpath), dcfg))
        np.testing.assert_array_equal(
            e.draft_params["layers"]["w_up"].numpy(),
            leaves[("layers", "w_up")].astype(np.float32))
    finally:
        lm.engine.shutdown()
    assert got == want
    assert sum(c["rounds"] for _t, c in got) > 0
