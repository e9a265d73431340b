"""LoRA adapters merged at load in the port (localai_tpu_torch/engine/
lora.py, engine/weights.py, the runner's and the front door's
``lora_adapter`` / ``lora_scale``) against the JAX package, on the CPU,
at tiny f32 widths (tests/test_lora.py's checkpoint and PEFT adapter):

  * merged leaves equal the JAX loader's with the same adapter within the
    ``_close`` tolerances of tests/test_torch_parity.py, from safetensors
    and from a GGUF file, at lora_scale 1 and 0.5; untargeted leaves
    unchanged; random weights take the same delta;
  * lora_scale and int8 compose as in JAX's
    ``test_lora_scale_and_int8_compose`` (the int8 leaves quantized from
    the merged weights: the JAX ``quantize_weight``'s bytes);
  * greedy tokens of the tiny f32 model with an adapter equal the JAX
    Engine's over the JAX merge, and differ from the base model's;
  * a models dir served by ``run --models-path``: one YAML whose
    ``model:`` names a ``.gguf`` file, one that adds ``lora_adapter``
    (relative to the models path, as the JAX runner resolves it) and
    ``lora_scale``; each serves a completion, and its loaded engine's
    greedy tokens equal the JAX Engine's over the same (merged) weights;
    ``model_options`` carries the three LoRA fields;
  * a missing adapter raises the JAX error, before any weight is read.
"""

from __future__ import annotations

import tests.torch_cpu  # noqa: F401  (one torch CPU thread)

import dataclasses
import json
import os
import threading
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localai_tpu.engine import engine as jeng
from localai_tpu.engine import gguf as jgguf
from localai_tpu.engine import gguf_tokenizer as jgtok
from localai_tpu.engine import lora as jlora
from localai_tpu.engine import weights as jweights
from localai_tpu.models import llama as jllama
from localai_tpu.ops.quant import quantize_weight as jquantize
from localai_tpu_torch.backend import runner
from localai_tpu_torch.engine import gguf_tokenizer as tgtok
from localai_tpu_torch.engine import lora as tlora
from localai_tpu_torch.engine import weights as tweights
from localai_tpu_torch.models import llama as tllama
from tests.test_lora import _tiny_adapter, _tiny_ckpt
from tests.test_torch_gguf import (ENGINE, PROMPTS, TINY, _drain, _submit,
                                   gguf_tensors, port_knobs, write_model_gguf)
from tests.test_torch_parity import _close


def _tcfg(jcfg) -> tllama.LlamaConfig:
    return tllama.LlamaConfig(**{f.name: getattr(jcfg, f.name)
                                 for f in dataclasses.fields(tllama.LlamaConfig)
                                 if f.name != "dtype"}, dtype=torch.float32)


def _np(leaf):
    if isinstance(leaf, dict):
        return {k: _np(v) for k, v in leaf.items()}
    return leaf.numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)


def _leaves(params: dict) -> dict:
    out = {}
    for k, v in params.items():
        if k == "layers":
            out.update({("layers", lk): _np(lv) for lk, lv in v.items()})
        else:
            out[(k,)] = _np(v)
    return out


@pytest.fixture()
def ckpt(tmp_path):
    """(JAX config, base dir, GGUF path, adapter dir, adapter tensors)."""
    cfg, params, base = _tiny_ckpt(tmp_path)
    adir, tensors = _tiny_adapter(tmp_path, cfg)
    gpath = str(tmp_path / "base.gguf")
    jgguf.write_gguf(gpath, {"general.architecture": "llama"},
                     gguf_tensors(params, cfg))
    return cfg, base, gpath, adir, tensors


@pytest.mark.parametrize("scale", (1.0, 0.5))
@pytest.mark.parametrize("source", ("safetensors", "gguf"))
def test_merged_leaves_equal_jax(ckpt, source, scale):
    cfg, base, gpath, adir, tensors = ckpt
    where = base if source == "safetensors" else gpath
    want = _leaves(jweights.load_llama_params(where, cfg, dtype=np.float32,
                                              lora_adapter=adir, lora_scale=scale))
    plain = _leaves(jweights.load_llama_params(where, cfg, dtype=np.float32))
    got = _leaves(tweights.load_llama_params(where, _tcfg(cfg), device="cpu",
                                             lora_adapter=adir, lora_scale=scale))
    assert got.keys() == want.keys()
    for k in want:
        _close(got[k], want[k], what=str(k))
        if k[-1] not in ("wq", "w_down"):
            np.testing.assert_array_equal(got[k], plain[k], err_msg=str(k))
    # the delta is scale * alpha / r * (B @ A).T per layer (alpha 4, r 2)
    for i in range(cfg.num_layers):
        A = tensors[f"base_model.model.model.layers.{i}.self_attn.q_proj.lora_A.weight"]
        B = tensors[f"base_model.model.model.layers.{i}.self_attn.q_proj.lora_B.weight"]
        _close(got[("layers", "wq")][i] - plain[("layers", "wq")][i],
               scale * 2.0 * (B @ A).T, what=f"delta {i}")
    assert tlora.LoraAdapter(adir, scale).scale == jlora.LoraAdapter(adir, scale).scale


def test_random_weights_take_the_same_delta(ckpt):
    cfg, _b, _g, adir, _t = ckpt
    tcfg = _tcfg(cfg)
    base = tweights.random_params(tcfg, 9, device="cpu")
    merged = tweights.random_params(tcfg, 9, device="cpu", lora_adapter=adir)
    ad = tlora.LoraAdapter(adir)
    for name in ("wq", "w_down"):
        for i in range(cfg.num_layers):
            np.testing.assert_array_equal(
                merged["layers"][name][i].numpy(),
                base["layers"][name][i].numpy() + ad.layer_delta(name, i))
    for name in ("wk", "wv", "wo", "w_gate", "w_up"):
        np.testing.assert_array_equal(merged["layers"][name].numpy(),
                                      base["layers"][name].numpy())
    np.testing.assert_array_equal(merged["embed"].numpy(), base["embed"].numpy())


def test_lora_scale_and_int8_compose(ckpt):
    cfg, base, _g, adir, _t = ckpt
    tcfg = _tcfg(cfg)

    def load(**kw):
        return tweights.load_llama_params(base, tcfg, device="cpu", **kw)

    m1 = load(lora_adapter=adir, lora_scale=1.0)
    mh = load(lora_adapter=adir, lora_scale=0.5)
    p0 = load()
    d1 = (m1["layers"]["wq"] - p0["layers"]["wq"]).numpy()
    dh = (mh["layers"]["wq"] - p0["layers"]["wq"]).numpy()
    np.testing.assert_allclose(dh, d1 * 0.5, rtol=1e-5, atol=1e-6)
    # int8 quantization applies ON TOP of the merged weights: the JAX
    # quantize_weight of the JAX merge, byte for byte in q
    q = load(quantize="int8", lora_adapter=adir)
    assert set(q["layers"]["wq"].keys()) == {"q", "s"}
    jm = jweights.load_llama_params(base, cfg, dtype=np.float32, lora_adapter=adir)
    for i in range(cfg.num_layers):
        want = jquantize(np.asarray(jm["layers"]["wq"][i]))
        np.testing.assert_array_equal(q["layers"]["wq"]["q"][i].numpy(),
                                      np.asarray(want["q"]))
        _close(q["layers"]["wq"]["s"][i].numpy(), np.asarray(want["s"]))


def test_tokens_with_an_adapter_equal_the_jax_engine(tmp_path):
    """load_model(dir, lora_adapter=...) on the tiny checkpoint: greedy
    tokens equal the JAX Engine's over the JAX merge, request by request,
    and differ from the base model's."""
    from tests.test_torch_engine import _Tok
    from tests.tinymodel import TINY_HF_CONFIG, write_tiny_checkpoint

    d = str(tmp_path / "tiny")
    write_tiny_checkpoint(d)
    jcfg = jllama.LlamaConfig.from_hf_config(TINY_HF_CONFIG, dtype=jnp.float32)
    adir, _t = _tiny_adapter(tmp_path, jcfg, r=4, alpha=8.0,
                             targets=("self_attn.q_proj", "mlp.down_proj"))
    rng = np.random.default_rng(2)
    prompts = [rng.integers(2, 258, size=n).tolist() for n in (9, 23, 40)]
    jp = jweights.load_llama_params(d, jcfg, dtype=jnp.float32,
                                    lora_adapter=adir, lora_scale=0.5)
    je = jeng.Engine(jcfg, jp, _Tok(), jeng.EngineConfig(
        **ENGINE, draft="0", cache_dtype=jnp.float32))
    je.start()
    try:
        want = [_drain(_submit(je, p, 16)) for p in prompts]
    finally:
        je.shutdown()
    for adapter, scale in ((adir, 0.5), ("", 0.0)):
        lm = runner.load_model(d, "tiny", **port_knobs(draft="0"),
                               lora_adapter=adapter, lora_scale=scale)
        try:
            got = [_drain(_submit(lm.engine, p, 16)) for p in prompts]
        finally:
            lm.engine.shutdown()
        if adapter:
            assert got == want
        else:
            assert got != want


YAMLS = {"g": """\
name: g
parameters: {model: tiny.gguf, temperature: 0, max_tokens: 12}
dtype: float32
kv_cache_dtype: float32
context_size: 128
num_slots: 2
options: [draft=0, kv_offload=0, kv_page_size=16, prefill_chunk=32]
""", "gl": """\
name: gl
parameters: {model: tiny.gguf, temperature: 0, max_tokens: 12}
dtype: float32
kv_cache_dtype: float32
context_size: 128
num_slots: 2
lora_adapter: adapter
lora_base: unused-base
lora_scale: 0.5
options: [draft=0, kv_offload=0, kv_page_size=16, prefill_chunk=32]
"""}


def test_models_path_serves_a_gguf_yaml_and_its_lora_adapter(tmp_path):
    from localai_tpu_torch import cli
    from localai_tpu_torch.api.app import make_server
    from localai_tpu_torch.capabilities import model_options
    from localai_tpu_torch.config.model_config import ModelConfig

    root = tmp_path / "models"
    root.mkdir()
    path = str(root / "tiny.gguf")
    jcfg, _p = write_model_gguf(path, TINY, 5)
    adir, _t = _tiny_adapter(root, jcfg)          # models/adapter
    for name, text in YAMLS.items():
        (root / f"{name}.yaml").write_text(text)
    tok = jgtok.from_gguf(path)
    gcfg = dataclasses.replace(jgguf.config_from_gguf(path), dtype=jnp.float32)
    want = {}
    for name, kw in (("g", {}), ("gl", {"lora_adapter": adir, "lora_scale": 0.5})):
        jp = jweights.load_llama_params(path, gcfg, dtype=jnp.float32, **kw)
        je = jeng.Engine(gcfg, jp, tok, jeng.EngineConfig(**ENGINE, draft="0"))
        je.start()
        try:
            want[name] = [_drain(_submit(je, tok.encode(p), 12))
                          for p in PROMPTS[:2]]
        finally:
            je.shutdown()
    assert want["g"] != want["gl"]
    app = cli.build_app(cli.build_parser().parse_args(
        ["run", "--models-path", str(root), "--device", "cpu"]))
    server = make_server(app, "127.0.0.1", 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        for name in YAMLS:
            req = urllib.request.Request(
                f"http://127.0.0.1:{server.server_address[1]}/v1/completions",
                data=json.dumps({"model": name, "prompt": PROMPTS[0],
                                 "ignore_eos": True}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as resp:
                body = json.loads(resp.read())
            assert body["usage"]["completion_tokens"] == 12
            lm = app.caps.loaded[name]
            assert isinstance(lm.tokenizer, type(tgtok.from_gguf(path)))
            got = [_drain(_submit(lm.engine, lm.tokenizer.encode(p), 12))
                   for p in PROMPTS[:2]]
            assert got == want[name], name
            # the served text is those tokens' (the first prompt's)
            assert body["choices"][0]["text"] == lm.tokenizer.decode(got[0])[
                :len(body["choices"][0]["text"])]
    finally:
        server.shutdown()
        server.server_close()
        app.shutdown()
    kw = model_options(ModelConfig(name="m", lora_adapter="ad", lora_base="b",
                                   lora_scale=0.7), "/tmp")
    assert kw["lora_adapter"] == os.path.join("/tmp", "ad")
    assert kw["lora_base"] == "b" and abs(kw["lora_scale"] - 0.7) < 1e-6


def test_a_missing_adapter_raises_the_jax_error(tmp_path, monkeypatch):
    from tests.tinymodel import write_tiny_checkpoint

    missing = str(tmp_path / "no_adapter")
    with pytest.raises(FileNotFoundError) as je:
        jlora.LoraAdapter(missing)
    with pytest.raises(FileNotFoundError) as te:
        tlora.LoraAdapter(missing)
    assert str(te.value) == str(je.value)
    d = str(tmp_path / "tiny")
    write_tiny_checkpoint(d)

    def no_read(*a, **k):
        raise AssertionError("a weight was read before the adapter")

    monkeypatch.setattr(tweights, "_host_leaves", no_read)
    with pytest.raises(FileNotFoundError, match="no adapter_model.safetensors"):
        runner.load_model(d, "tiny", **port_knobs(draft="0"), lora_adapter=missing)
