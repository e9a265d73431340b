"""HTTP end to end against the PyTorch port's server (stdlib
ThreadingHTTPServer), on the CPU, with the tests/tinymodel.py checkpoint
(float32, tokenizer.json read by the port's own byte-level tokenizer).

Pins: /readyz and /v1/models; /v1/completions and /v1/chat/completions,
streamed and not, with usage counts; greedy text equal to the JAX
Engine's on the same rendered prompt (the chat prompt rendered as the
JAX package's default chat template renders it; the prompt tokenized by
the port exactly as the JAX backend's HF tokenizer does); the JAX
sampler's knobs (penalties, logit_bias, typical_p, mirostat) are served,
greedy penalized / biased text equal to the JAX Engine's; a grammar
that does not parse is a 500 carrying the GrammarError, as the JAX
server answers it, and a bad request a 400 / 404; tools / functions that
survive tool_choice are answered with tool calls (the grammar the route
builds from them forces the call), streamed and not, while tool_choice
"none" is served as a plain chat, as the JAX route serves it.

The JAX server's front door (``run --models-path``, ``served_dir``): a
models dir with three YAML files over one checkpoint of the tiny widths
with a 320-entry Llama-3-form vocabulary with merges, served by the
port and read by the JAX config module beside a JAX Engine over the same
weights and HF's tokenizer: the guessed llama3 prompt and its ids (BOS
twice, as the JAX server sends it), greedy chat / completion / edit text
equal to the JAX server's, post-processed (cutstrings, trimspace,
trimsuffix) when not streamed and raw when streamed, echo, tokenize,
/v1/models over the configs, the config's stopwords and the tokenizer's
eos stopping streams as the JAX Engine stops them, settings of
unported modules refused by name, a config skipped at scan (a template
outside the port's renderer's subset) answered with its error, and the
``--model`` form's flags refused beside ``--models-path``.
"""

from __future__ import annotations

import tests.torch_cpu  # noqa: F401  (one torch CPU thread)

import dataclasses
import json
import threading
import urllib.error
import urllib.request

import jax.numpy as jnp
import pytest

from localai_tpu.engine import engine as jeng
from localai_tpu.engine import sampling as jsamp
from localai_tpu.engine import weights as jweights
from localai_tpu.models import llama as jllama

PROMPT = "Hello there, how are you today?"
MESSAGES = [{"role": "system", "content": "Be brief."},
            {"role": "user", "content": "Name a colour."}]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    from tests.tinymodel import write_tiny_checkpoint
    from transformers import AutoTokenizer

    from localai_tpu_torch.api.app import App, make_server
    from localai_tpu_torch.backend.runner import load_model

    d = str(tmp_path_factory.mktemp("tiny_server"))
    hf = write_tiny_checkpoint(d)
    lm = load_model(d, "tiny", num_slots=4, context_size=256, dtype="float32",
                    device="cpu", prefill_chunk=16, kv_page_size=16,
                    kv_offload=False, draft="0")
    app = App({"tiny": lm})
    server = make_server(app, "127.0.0.1", 0)
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    jcfg = jllama.LlamaConfig.from_hf_config(hf, dtype=jnp.float32)
    jparams = jweights.load_llama_params(d, jcfg, dtype=jnp.float32)
    hf_tok = AutoTokenizer.from_pretrained(d)
    je = jeng.Engine(jcfg, jparams, hf_tok, jeng.EngineConfig(
        num_slots=4, max_context=256, prefill_buckets=(16,), prefill_chunk=16,
        cache_dtype=jnp.float32, kv_layout="paged", kv_page_size=16,
        kv_prefix_cache=False, kv_offload=False,
        draft="0"))
    je.start()
    yield f"http://127.0.0.1:{server.server_address[1]}", lm, je, hf_tok
    server.shutdown()
    server.server_close()
    app.shutdown()
    je.shutdown()


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.status, r.read().decode()


def _sse(text: str) -> list:
    lines = [ln[6:] for ln in text.splitlines() if ln.startswith("data: ")]
    assert lines[-1] == "[DONE]"
    return [json.loads(x) for x in lines[:-1]]


def _jax_text(je, hf_tok, prompt: str, n: int) -> str:
    ids = hf_tok.encode(prompt)
    text, _evs = je.generate_text(jeng.GenRequest(
        prompt_ids=ids, max_new_tokens=n, ignore_eos=True,
        params=jsamp.SamplingParamsHost(temperature=0.0)))
    return text


def test_readyz_and_models(served):
    base, *_ = served
    with urllib.request.urlopen(base + "/readyz", timeout=30) as r:
        assert json.loads(r.read())["status"] == "ok"
    with urllib.request.urlopen(base + "/v1/models", timeout=30) as r:
        assert [m["id"] for m in json.loads(r.read())["data"]] == ["tiny"]


def test_tokenizer_matches_hf(served):
    _base, lm, _je, hf_tok = served
    for text in (PROMPT, "ünïcødé ✓ and\nnewlines", ""):
        ids = lm.tokenizer.encode(text)
        assert ids == hf_tok.encode(text)
        assert lm.tokenizer.decode(ids) == hf_tok.decode(ids, skip_special_tokens=True)


@pytest.mark.parametrize("stream", [False, True])
def test_completions_greedy_text_matches_jax(served, stream):
    base, lm, je, hf_tok = served
    body = {"model": "tiny", "prompt": PROMPT, "max_tokens": 12,
            "temperature": 0, "ignore_eos": True, "stream": stream}
    status, raw = _post(base + "/v1/completions", body)
    assert status == 200
    if stream:
        chunks = _sse(raw)
        text = "".join(c["choices"][0]["text"] for c in chunks)
        usage = chunks[-1]["usage"]
        assert chunks[-1]["choices"][0]["finish_reason"] == "length"
    else:
        out = json.loads(raw)
        assert out["object"] == "text_completion"
        text = out["choices"][0]["text"]
        usage = out["usage"]
        assert out["choices"][0]["finish_reason"] == "length"
    n_prompt = len(lm.tokenizer.encode(PROMPT))
    assert usage == {"prompt_tokens": n_prompt, "completion_tokens": 12,
                     "total_tokens": n_prompt + 12}
    assert text == _jax_text(je, hf_tok, PROMPT, 12)


@pytest.mark.parametrize("stream", [False, True])
def test_chat_greedy_text_matches_jax(served, stream):
    from localai_tpu.templates import prompts as T
    from localai_tpu_torch.api.chatflow import build_chat_prompt
    from localai_tpu_torch.config.model_config import ModelConfig

    base, lm, je, hf_tok = served
    rendered = "\n".join(
        T.render_chat_message(T.DEFAULT_CHAT_MESSAGE, T.ChatMessageData(
            role=m["role"], role_name=m["role"], content=m["content"]))
        for m in MESSAGES)
    assert build_chat_prompt(ModelConfig(), MESSAGES)[0] == rendered
    body = {"model": "tiny", "messages": MESSAGES, "max_tokens": 10,
            "temperature": 0, "ignore_eos": True, "stream": stream}
    status, raw = _post(base + "/v1/chat/completions", body)
    assert status == 200
    if stream:
        chunks = _sse(raw)
        assert chunks[0]["choices"][0]["delta"] == {"role": "assistant",
                                                    "content": ""}
        assert all(c["object"] == "chat.completion.chunk" for c in chunks)
        text = "".join(c["choices"][0]["delta"].get("content", "")
                       for c in chunks[1:])
        usage = chunks[-1]["usage"]
    else:
        out = json.loads(raw)
        assert out["object"] == "chat.completion"
        assert out["choices"][0]["message"]["role"] == "assistant"
        text = out["choices"][0]["message"]["content"]
        usage = out["usage"]
    assert usage["completion_tokens"] == 10
    assert usage["prompt_tokens"] == len(lm.tokenizer.encode(rendered))
    assert text == _jax_text(je, hf_tok, rendered, 10)


@pytest.mark.parametrize("route", ["completions", "chat"])
@pytest.mark.parametrize("stream", [False, True])
def test_echo_prepends_the_prompt_as_the_jax_runner(served, route, stream):
    """``"echo": true``: the JAX backend's non-streamed Predict returns the
    prompt followed by the text (its fake backend shows the rule), and
    its PredictStream the text alone. The port's non-streamed text is
    the rendered prompt + the JAX Engine's greedy text; streamed, the
    text without the prompt."""
    from localai_tpu.backend import contract_pb2 as pb
    from localai_tpu.backend.fake import FakeServicer
    from localai_tpu_torch.api.chatflow import build_chat_prompt
    from localai_tpu_torch.config.model_config import ModelConfig

    base, _lm, je, hf_tok = served
    fake = FakeServicer()
    plain = fake.Predict(pb.PredictOptions(prompt=PROMPT, max_tokens=3), None)
    echoed = fake.Predict(pb.PredictOptions(prompt=PROMPT, max_tokens=3,
                                            echo=True), None)
    assert echoed.message.decode() == PROMPT + plain.message.decode()
    body = {"model": "tiny", "max_tokens": 8, "temperature": 0,
            "ignore_eos": True, "stream": stream, "echo": True}
    if route == "chat":
        prompt = build_chat_prompt(ModelConfig(), MESSAGES)[0]
        status, raw = _post(base + "/v1/chat/completions",
                            {**body, "messages": MESSAGES})
    else:
        prompt = PROMPT
        status, raw = _post(base + "/v1/completions", {**body, "prompt": PROMPT})
    assert status == 200
    if stream:
        chunks = _sse(raw)
        text = "".join(c["choices"][0]["text"] if route == "completions"
                       else c["choices"][0]["delta"].get("content", "")
                       for c in chunks)
    else:
        out = json.loads(raw)["choices"][0]
        text = out["text"] if route == "completions" else out["message"]["content"]
    gen = _jax_text(je, hf_tok, prompt, 8)
    assert text == (gen if stream else prompt + gen)


@pytest.mark.parametrize("stream", [False, True])
def test_penalized_biased_greedy_text_matches_jax(served, stream):
    """Repeat / presence / frequency penalties and a logit_bias (string
    keys, as JSON carries them) through the server: the JAX Engine's
    greedy text under the same parameters, and never the banned token."""
    base, _lm, je, hf_tok = served
    plain_ids = [ev.token_id for ev in je.generate(jeng.GenRequest(
        prompt_ids=hf_tok.encode(PROMPT), max_new_tokens=16, ignore_eos=True,
        params=jsamp.SamplingParamsHost(temperature=0.0)))]
    banned = max(set(plain_ids), key=plain_ids.count)
    knobs = {"repeat_penalty": 1.3, "presence_penalty": 0.6,
             "frequency_penalty": 0.4}
    body = {"model": "tiny", "prompt": PROMPT, "max_tokens": 16,
            "temperature": 0, "ignore_eos": True, "stream": stream,
            "logit_bias": {str(banned): -100, "70": 2.5}, **knobs}
    status, raw = _post(base + "/v1/completions", body)
    assert status == 200
    text = ("".join(c["choices"][0]["text"] for c in _sse(raw)) if stream
            else json.loads(raw)["choices"][0]["text"])
    params = jsamp.SamplingParamsHost(
        temperature=0.0, logit_bias={banned: -100.0, 70: 2.5}, **knobs)
    evs = list(je.generate(jeng.GenRequest(
        prompt_ids=hf_tok.encode(PROMPT), max_new_tokens=16, ignore_eos=True,
        params=params)))
    assert text == "".join(ev.text for ev in evs)
    ids = [ev.token_id for ev in evs]
    assert banned not in ids and ids != plain_ids


@pytest.mark.parametrize("knob", [{"repeat_penalty": 1.1}, {"presence_penalty": 0.5},
                                  {"frequency_penalty": 0.5}, {"typical_p": 0.5},
                                  {"mirostat": 2}, {"logit_bias": {"65": -100}}])
def test_sampler_knobs_are_served(served, knob):
    base, *_ = served
    status, raw = _post(base + "/v1/chat/completions", {
        "model": "tiny", "messages": MESSAGES, "max_tokens": 6, "seed": 3,
        "ignore_eos": True, **knob})
    assert status == 200
    assert json.loads(raw)["usage"]["completion_tokens"] == 6


def test_build_request_maps_every_sampling_field_as_the_jax_runner():
    """The JAX defaults and runner rules: typical_p / repeat_penalty <= 0
    -> 1, repeat_last_n 0 -> 64 (-1 kept), zero mirostat tau / eta ->
    5 / 0.1, logit_bias keys -> int."""
    from localai_tpu_torch.backend.runner import LoadedModel, build_request

    class Tok:
        def encode(self, text):
            return [5, 6]

    lm = LoadedModel("t", "", None, Tok(), None)
    p = build_request(lm, "x", {}).params
    assert dataclasses.asdict(p) == dataclasses.asdict(jsamp.SamplingParamsHost())
    p = build_request(lm, "x", {
        "typical_p": 0, "repeat_penalty": -1, "repeat_last_n": 0,
        "mirostat": 2, "mirostat_tau": 0, "mirostat_eta": 0,
        "presence_penalty": 0.5, "frequency_penalty": 0.25,
        "logit_bias": {"12": -100, 13: 2}}).params
    assert (p.typical_p, p.repeat_penalty, p.repeat_last_n) == (1.0, 1.0, 64)
    assert (p.mirostat, p.mirostat_tau, p.mirostat_eta) == (2, 5.0, 0.1)
    assert (p.presence_penalty, p.frequency_penalty) == (0.5, 0.25)
    assert p.logit_bias == {12: -100.0, 13: 2.0}
    assert build_request(lm, "x", {"repeat_last_n": -1}).params.repeat_last_n == -1


def test_unsupported_knob_and_bad_request_are_400(served):
    """A bad request is a 400 / 404; a grammar that does not parse fails
    its request at admission, a 500 with the GrammarError (the JAX
    server's answer: its backend aborts the call INTERNAL)."""
    base, *_ = served
    for body, codes in (
            ({"model": "tiny", "prompt": "x", "grammar": "root ::= undefined-rule"},
             (500,)),
            ({"model": "tiny", "messages": []}, (400, 404)),
            ({"model": "nope", "prompt": "x"}, (400, 404))):
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(base + ("/v1/chat/completions" if "messages" in body
                          else "/v1/completions"), body)
        assert ei.value.code in codes
        err = json.loads(ei.value.read())["error"]
        if codes == (500,):
            assert "GrammarError" in err["message"]


TOOL = {"name": "get_weather", "description": "the weather in a city",
        "parameters": {"type": "object",
                       "properties": {"city": {"enum": ["sf", "nyc"]}},
                       "required": ["city"]}}


@pytest.mark.parametrize("extra", [
    {"tools": [{"type": "function", "function": TOOL}]},
    {"tools": [{"type": "function", "function": TOOL}], "tool_choice": "auto"},
    {"functions": [TOOL]},
    {"functions": [TOOL], "function_call": {"name": "get_weather"}},
], ids=["tools", "tool_choice_auto", "functions", "function_call"])
@pytest.mark.parametrize("stream", [False, True])
def test_tool_calls_are_refused_with_400(served, extra, stream):
    """The requests the port refused with a 400 before it served tool
    calls (the test keeps the name it had then): tools / functions that
    survive tool_choice are now answered as
    the JAX route answers them, the output forced by the grammar built
    from them: finish "tool_calls" and a call of get_weather whose
    arguments parse (non-streamed: message.tool_calls, content null;
    streamed: one tool_calls delta)."""
    base, lm, *_ = served
    before = lm.engine.metrics()["grammar"]["tokens"]
    _st, text = _post(base + "/v1/chat/completions",
                      {"model": "tiny", "messages": MESSAGES, "max_tokens": 96,
                       "temperature": 1.0, "seed": 11, "stream": stream,
                       **extra})
    if stream:
        events = _sse(text)
        calls = [c for e in events
                 for c in e["choices"][0]["delta"].get("tool_calls") or ()]
        finish = events[-1]["choices"][0]["finish_reason"]
    else:
        msg = json.loads(text)["choices"][0]
        assert msg["message"]["content"] is None
        calls, finish = msg["message"]["tool_calls"], msg["finish_reason"]
    assert finish == "tool_calls" and len(calls) == 1
    assert calls[0]["type"] == "function" and calls[0]["id"].startswith("call_")
    assert calls[0]["function"]["name"] == "get_weather"
    assert json.loads(calls[0]["function"]["arguments"])["city"] in ("sf", "nyc")
    assert lm.engine.metrics()["grammar"]["tokens"] > before


@pytest.mark.parametrize("choice", [{"tool_choice": "none"},
                                    {"function_call": "none"}])
def test_tool_choice_none_is_served_as_the_jax_route(served, choice):
    """tool_choice / function_call "none": the tools are declared but must
    not be called, so the JAX route drops them and answers as a plain
    chat; the port gives the JAX Engine's greedy text."""
    from localai_tpu_torch.api.chatflow import build_chat_prompt
    from localai_tpu_torch.config.model_config import ModelConfig

    base, lm, je, hf_tok = served
    key = "tools" if "tool_choice" in choice else "functions"
    decl = ([{"type": "function", "function": TOOL}] if key == "tools"
            else [TOOL])
    status, raw = _post(base + "/v1/chat/completions",
                        {"model": "tiny", "messages": MESSAGES, "max_tokens": 6,
                         "temperature": 0, "ignore_eos": True, key: decl,
                         **choice})
    assert status == 200
    out = json.loads(raw)
    assert out["choices"][0]["finish_reason"] == "length"
    assert out["choices"][0]["message"]["content"] == _jax_text(
        je, hf_tok, build_chat_prompt(ModelConfig(), MESSAGES)[0], 6)


def test_app_shutdown_frees_the_model_without_the_cycle_collector(tmp_path):
    """The per-server handler class keeps the App in a reference cycle;
    App.shutdown drops the models, so a server that is shut down releases
    its weights at once (a process serving one configuration after another
    must not hold two models' weights on the card)."""
    import gc
    import weakref

    from localai_tpu_torch.api.app import App, make_server
    from localai_tpu_torch.backend.runner import load_model

    (tmp_path / "config.json").write_text(json.dumps({
        "vocab_size": 300, "hidden_size": 32, "intermediate_size": 64,
        "num_hidden_layers": 1, "num_attention_heads": 2,
        "num_key_value_heads": 1}))
    gc.disable()
    try:
        lm = load_model(str(tmp_path), "t", num_slots=2, context_size=64,
                        dtype="float32", random_weights=0, device="cpu")
        weights = weakref.ref(lm.engine.params["embed"])
        app = App({"t": lm})
        server = make_server(app, "127.0.0.1", 0)
        th = threading.Thread(target=server.serve_forever, daemon=True)
        th.start()
        status, _body = _post(f"http://127.0.0.1:{server.server_address[1]}"
                              "/v1/completions",
                              {"model": "t", "prompt": "hi", "max_tokens": 2})
        assert status == 200
        server.shutdown()
        server.server_close()
        app.shutdown()
        del lm, app, server, th
        assert weights() is None
    finally:
        gc.enable()


# ---- the JAX server's front door: run --models-path ----

# the tiny checkpoint's widths with room for a Llama-3-form vocabulary
# with merges: the 256 byte characters, its 5 specials, 59 merges
TINY3_VOCAB = 320
TINY3_YAML = """\
name: tiny3
parameters:
  model: tiny3
  temperature: 0
  max_tokens: 12
dtype: float32
kv_cache_dtype: float32
context_size: 256
num_slots: 4
cutstrings: ["[aeiou]"]
trimspace: [" "]
trimsuffix: ["."]
options:
  - draft=0
  - kv_offload=0
  - kv_prefix_cache=0
  - prefill_chunk=16
  - kv_page_size=16
"""
STOP_YAML = """\
name: tiny3stop
parameters: {model: tiny3, temperature: 0, max_tokens: 24}
dtype: float32
kv_cache_dtype: float32
context_size: 256
stopwords: ["ZZ"]
options: [draft=0, kv_offload=0, kv_prefix_cache=0]
"""
# a template outside the port's renderer's subset ({% set %}; the JAX
# server's jinja2 compiles it), over a model dir of the config's name
SET_YAML = """\
name: tiny3set
dtype: float32
kv_cache_dtype: float32
context_size: 256
template:
  chat: "{% set sys = 'x' %}{{ sys }}{{ Input }}"
options: [draft=0, kv_offload=0, kv_prefix_cache=0]
"""


@pytest.fixture(scope="module")
def served_dir(tmp_path_factory):
    """A models dir (two YAML files over one Llama-3-form checkpoint)
    served by the port's ``run --models-path`` on the CPU, beside the JAX
    package's configs of the same dir and a JAX Engine over the same
    weights and HF's tokenizer."""
    import os

    import jax
    from transformers import AutoTokenizer

    from localai_tpu.config import model_config as jmc
    from localai_tpu_torch import cli
    from localai_tpu_torch.api.app import make_server
    from tests.test_torch_tokenizer_bpe import write_byte_level
    from tests.tinymodel import TINY_HF_CONFIG

    root = str(tmp_path_factory.mktemp("models_path"))
    d = os.path.join(root, "tiny3")
    os.makedirs(d)
    hf = dict(TINY_HF_CONFIG, vocab_size=TINY3_VOCAB, bos_token_id=0,
              eos_token_id=4)
    jcfg = jllama.LlamaConfig.from_hf_config(hf, dtype=jnp.float32)
    jweights.save_llama_params(jllama.init_params(jcfg, jax.random.PRNGKey(3)),
                               jcfg, d)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(hf, f)
    write_byte_level(d, vocab=TINY3_VOCAB)
    with open(os.path.join(root, "tiny3.yaml"), "w") as f:
        f.write(TINY3_YAML)
    with open(os.path.join(root, "tiny3stop.yaml"), "w") as f:
        f.write(STOP_YAML)
    with open(os.path.join(root, "tiny3set.yaml"), "w") as f:
        f.write(SET_YAML)
    os.symlink(d, os.path.join(root, "tiny3set"))
    args = cli.build_parser().parse_args(
        ["run", "--models-path", root, "--device", "cpu"])
    app = cli.build_app(args)
    server = make_server(app, "127.0.0.1", 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    hf_tok = AutoTokenizer.from_pretrained(d)
    jparams = jweights.load_llama_params(d, jcfg, dtype=jnp.float32)
    je = jeng.Engine(jcfg, jparams, hf_tok, jeng.EngineConfig(
        num_slots=4, max_context=256, prefill_buckets=(16,), prefill_chunk=16,
        cache_dtype=jnp.float32, kv_layout="paged", kv_page_size=16,
        kv_prefix_cache=False, kv_offload=False, draft="0"))
    je.start()
    yield (f"http://127.0.0.1:{server.server_address[1]}", app,
           jmc.scan_models_dir(root), je, hf_tok)
    server.shutdown()
    server.server_close()
    app.shutdown()
    je.shutdown()


def _jax_served(je, hf_tok, mc, prompt: str, overrides: dict) -> tuple:
    """What the JAX server answers: (raw text, finish) of its engine over
    HF's ids of the prompt, the config's parameters under the overrides
    and its stopwords (capabilities.build_predict_options)."""
    ids = hf_tok.encode(prompt)
    text, evs = je.generate_text(jeng.GenRequest(
        prompt_ids=ids, params=mc.sampling_host(overrides),
        max_new_tokens=int(overrides.get("max_tokens")
                           or mc.parameters.max_tokens or 256),
        stop_sequences=list(overrides.get("stop") or mc.stopwords),
        ignore_eos=bool(overrides.get("ignore_eos", False))))
    return text, evs[-1].finish_reason


@pytest.mark.parametrize("stream", [False, True])
def test_models_path_chat_equals_the_jax_server(served_dir, stream):
    """The guessed llama3 templates render the JAX prompt byte for byte;
    the port's ids hold the header specials and equal HF's; the greedy
    text equals the JAX Engine's, post-processed (cutstrings, trimspace,
    trimsuffix) when not streamed, raw when streamed, as the JAX server
    answers."""
    from localai_tpu.api.chatflow import build_chat_prompt as jbuild
    from localai_tpu.capabilities import finetune_response as jfinetune

    base, app, jconfigs, je, hf_tok = served_dir
    mc = jconfigs["tiny3"]
    prompt = jbuild(mc, MESSAGES)[0]
    assert prompt.startswith("<|begin_of_text|><|start_header_id|>system"
                             "<|end_header_id|>\n\nBe brief.<|eot_id|>")
    status, raw = _post(base + "/v1/chat/completions",
                        {"model": "tiny3", "messages": MESSAGES,
                         "ignore_eos": True, "stream": stream})
    assert status == 200
    text, _finish = _jax_served(je, hf_tok, mc, prompt, {"ignore_eos": True})
    if stream:
        chunks = _sse(raw)
        got = "".join(c["choices"][0]["delta"].get("content") or ""
                      for c in chunks)
        assert got == text
        usage = chunks[-1]["usage"]
    else:
        body = json.loads(raw)
        assert body["choices"][0]["message"]["content"] == jfinetune(mc, text)
        usage = body["usage"]
    ids = hf_tok.encode(prompt)
    assert usage["prompt_tokens"] == len(ids)
    lm = app.models["tiny3"]
    assert lm.tokenizer.encode(prompt) == ids
    header = hf_tok.convert_tokens_to_ids("<|start_header_id|>")
    # HF's encode adds a BOS to the template's own: the JAX server sends both
    assert ids[:3] == [0, 0, header] and ids.count(header) == 3


def test_models_path_echo_tokenize_and_models(served_dir):
    from localai_tpu.api.chatflow import build_chat_prompt as jbuild
    from localai_tpu.capabilities import finetune_response as jfinetune

    base, app, jconfigs, je, hf_tok = served_dir
    mc = jconfigs["tiny3"]
    prompt = jbuild(mc, MESSAGES)[0]
    _s, raw = _post(base + "/v1/chat/completions",
                    {"model": "tiny3", "messages": MESSAGES, "echo": True,
                     "max_tokens": 6, "ignore_eos": True})
    text, _f = _jax_served(je, hf_tok, mc, prompt,
                           {"max_tokens": 6, "ignore_eos": True})
    assert (json.loads(raw)["choices"][0]["message"]["content"]
            == jfinetune(mc, prompt + text))
    _s, raw = _post(base + "/v1/tokenize", {"model": "tiny3", "content": prompt})
    assert json.loads(raw) == {"tokens": hf_tok.encode(prompt)}
    with urllib.request.urlopen(base + "/v1/models", timeout=60) as r:
        models = {m["id"]: m["ready"] for m in json.loads(r.read())["data"]}
    assert set(models) == {"tiny3", "tiny3stop"} and models["tiny3"]


def test_models_path_completion_and_edit_equal_the_jax_server(served_dir):
    from localai_tpu.capabilities import finetune_response as jfinetune

    base, app, jconfigs, je, hf_tok = served_dir
    mc = jconfigs["tiny3"]
    _s, raw = _post(base + "/v1/completions",
                    {"model": "tiny3", "prompt": PROMPT, "ignore_eos": True})
    text, _f = _jax_served(je, hf_tok, mc, PROMPT, {"ignore_eos": True})
    assert json.loads(raw)["choices"][0]["text"] == jfinetune(mc, text)
    body = {"model": "tiny3", "instruction": "Fix the spelling",
            "input": "teh cat", "max_tokens": 8, "ignore_eos": True}
    _s, raw = _post(base + "/v1/edits", body)
    got = json.loads(raw)
    text, _f = _jax_served(je, hf_tok, mc, "Fix the spelling\n\nteh cat",
                           {"max_tokens": 8, "ignore_eos": True})
    assert got["object"] == "edit"
    assert got["choices"][0]["text"] == jfinetune(mc, text)
    assert got["usage"]["completion_tokens"] == 8


@pytest.mark.parametrize("stream", [False, True])
def test_models_path_stopwords_and_eos_stop_as_the_jax_server(served_dir, stream):
    """A logit_bias that pushes "Z" stops at the config's stopword "ZZ";
    one that pushes <|eot_id|> (the tokenizer's eos) ends the stream
    there with finish "stop"."""
    base, app, jconfigs, je, hf_tok = served_dir
    z = hf_tok.convert_tokens_to_ids("Z")
    eot = hf_tok.convert_tokens_to_ids("<|eot_id|>")
    for name, bias in (("tiny3stop", {str(z): 100.0}),
                       ("tiny3", {str(eot): 100.0})):
        mc = jconfigs[name]
        body = {"model": name, "prompt": PROMPT, "logit_bias": bias,
                "stream": stream}
        _s, raw = _post(base + "/v1/completions", body)
        if stream:
            chunks = _sse(raw)
            got = "".join(c["choices"][0]["text"] for c in chunks)
            finish = chunks[-1]["choices"][0]["finish_reason"]
        else:
            choice = json.loads(raw)["choices"][0]
            got, finish = choice["text"], choice["finish_reason"]
        text, jfinish = _jax_served(je, hf_tok, mc, PROMPT,
                                    {"logit_bias": {int(k): v
                                                    for k, v in bias.items()}})
        assert finish == jfinish == "stop"
        if name == "tiny3stop":
            assert got == text and "ZZ" not in got
        else:
            assert text == "" and got == ""


def test_models_path_refuses_unported_settings_and_unknown_models(served_dir):
    from localai_tpu_torch.capabilities import unported_settings
    from localai_tpu_torch.config.model_config import ModelConfig

    base, app, *_ = served_dir
    mc = ModelConfig(name="v", mmproj="proj.gguf", lora_adapter="a",
                     options=["slo_ttft_ms=500", "engines=2"])
    problems = " ".join(unported_settings(mc))
    for later in ("item 10", "item 9", "item 11"):
        assert later in problems
    # the LoRA fields are served since item 8 (the merge at load)
    assert "lora" not in problems and "item 8" not in problems
    app.caps.configs["v"] = mc
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(base + "/v1/completions", {"model": "v", "prompt": "x"})
        assert ei.value.code == 500
        assert "item 10" in json.loads(ei.value.read())["error"]["message"]
    finally:
        del app.caps.configs["v"]
    assert "v" not in app.models
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(base + "/v1/completions", {"model": "nope", "prompt": "x"})
    assert ei.value.code == 404


def test_models_path_answers_a_skipped_config_with_its_error(served_dir):
    """A config whose template is outside the port's renderer's subset is
    skipped at scan (the JAX server, whose jinja2 compiles it, serves
    it); a request for its name answers with the template error, never
    with an on-the-fly default config over the model dir of that name."""
    base, app, jconfigs, *_ = served_dir
    assert "tiny3set" in jconfigs and "tiny3set" not in app.caps.configs
    for path, body in (("/v1/chat/completions", {"messages": MESSAGES}),
                       ("/v1/completions", {"prompt": PROMPT})):
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(base + path, {"model": "tiny3set", "max_tokens": 2, **body})
        assert ei.value.code == 500
        msg = json.loads(ei.value.read())["error"]["message"]
        assert "tiny3set.yaml" in msg and "{% set %}" in msg
    assert "tiny3set" not in app.models


@pytest.mark.parametrize("flags", [
    ["--random-weights", "1"], ["--num-slots", "4", "--dtype", "float32"],
    ["--name", "x"], ["--kv-offload", "0"], ["--draft", "0"]])
def test_models_path_refuses_flags_of_the_model_form(tmp_path, flags):
    """``run --models-path`` reads a model's settings from its YAML: a flag
    of the ``--model`` form beside it is refused, never dropped."""
    from localai_tpu_torch import cli

    p = cli.build_parser()
    args = p.parse_args(["run", "--models-path", str(tmp_path), *flags])
    with pytest.raises(ValueError, match=flags[0]):
        cli.build_app(args)
    with pytest.raises(SystemExit) as ei:
        cli.main(["run", "--models-path", str(tmp_path), *flags])
    assert ei.value.code == 2
    ok = p.parse_args(["run", "--models-path", str(tmp_path), "--device",
                       "cpu", "--context-size", "512", "--address", ":0"])
    assert cli.model_form_error(ok) == ""
