"""Tool calls through the PyTorch port's HTTP server (api/openai_routes.py
over the engine's grammar-constrained decoding), on the CPU, over the tiny
f32 checkpoint, against the JAX route and the JAX Engine.

  * the grammar the route builds from a request's tools / functions (a
    forced name, parallel calls, the request's own grammar, "none") is
    the one the JAX route builds (localai_tpu/api/openai_routes.py);
  * the answer shape of tests/test_e2e_http.py's tool-call tests:
    random weights, sampled, forced by the grammar into a valid call,
    non-streamed (``message.tool_calls``, finish "tool_calls") and
    streamed (one ``tool_calls`` delta, the final chunk's finish
    "tool_calls");
  * greedy, the call the port answers is the one the JAX Engine decodes
    under the JAX route's grammar from the same prompt, parsed by the
    JAX parser, streamed and not;
  * parallel_tool_calls answers an array of calls; a request's own
    grammar wins over its tools (no tool grammar, no buffering).
"""

from __future__ import annotations

import tests.torch_cpu  # noqa: F401  (one torch CPU thread)

import json
import threading
import urllib.request

import pytest

from localai_tpu.config.model_config import FunctionsConfig as JFunctionsConfig
from localai_tpu.engine import engine as jeng
from localai_tpu.engine import sampling as jsamp
from localai_tpu.functions import parse as jparse
from localai_tpu.functions.grammars import json_schema as jjs
from localai_tpu_torch.api.chatflow import build_chat_prompt
from localai_tpu_torch.api.openai_routes import _functions_from, _tool_grammar
from localai_tpu_torch.config.model_config import ModelConfig
from localai_tpu_torch.functions.parse import FunctionsConfig
from tests.test_torch_grammar import jax_engine, tiny  # noqa: F401  (fixture)

CITY = {"type": "object", "properties": {"city": {"enum": ["sf", "nyc"]}},
        "required": ["city"]}
TOOLS = [{"type": "function",
          "function": {"name": "get_weather", "parameters": CITY}}]
SEARCH = {"type": "function", "function": {
    "name": "search", "parameters": {"type": "object", "properties": {
        "q": {"enum": ["tpu", "gpu"]}}, "required": ["q"]}}}
MESSAGES = [{"role": "user", "content": "weather in sf?"}]

ROUTE_CASES = {
    "tools": {"tools": TOOLS},
    "auto": {"tools": TOOLS, "tool_choice": "auto"},
    "required": {"tools": TOOLS, "tool_choice": "required"},
    "functions": {"functions": [TOOLS[0]["function"]]},
    "function_call": {"functions": [TOOLS[0]["function"]],
                      "function_call": {"name": "get_weather"}},
    "forced_of_two": {"tools": TOOLS + [SEARCH], "tool_choice": {
        "type": "function", "function": {"name": "search"}}},
    "parallel": {"tools": TOOLS + [SEARCH], "parallel_tool_calls": True},
    "own_grammar": {"tools": TOOLS, "grammar": 'root ::= "yes" | "no"'},
    "none": {"tools": TOOLS, "tool_choice": "none"},
}


def jax_route_grammar(body: dict) -> str:
    """The JAX chat route's tool grammar (openai_routes.py:97-125), with
    the JAX default model config's function keys."""
    tools = body.get("tools") or []
    functions = body.get("functions") or [
        t["function"] for t in tools if t.get("type") == "function"]
    tool_choice = body.get("tool_choice") or body.get("function_call")
    if tool_choice == "none":
        functions = []
    if not functions or body.get("grammar"):
        return ""
    force_name = None
    if isinstance(tool_choice, dict):
        force_name = ((tool_choice.get("function") or {}).get("name")
                      or tool_choice.get("name"))
    fc = JFunctionsConfig()
    return jjs.grammar_for_functions(
        functions, force_name=force_name,
        parallel_calls=bool(body.get("parallel_tool_calls", False)),
        name_key=fc.function_name_key, arguments_key=fc.function_arguments_key)


@pytest.mark.parametrize("case", sorted(ROUTE_CASES))
def test_route_grammar_equals_the_jax_route(case):
    body = {"messages": MESSAGES, **ROUTE_CASES[case]}
    got = _tool_grammar(body, _functions_from(body), FunctionsConfig())
    assert got == jax_route_grammar(body)
    assert bool(got) == (case not in ("own_grammar", "none"))


@pytest.fixture(scope="module")
def served(tiny, tmp_path_factory):  # noqa: F811
    from tests.tinymodel import write_tiny_checkpoint

    from localai_tpu_torch.api.app import App, make_server
    from localai_tpu_torch.backend.runner import load_model

    d = str(tmp_path_factory.mktemp("tiny_tools"))
    write_tiny_checkpoint(d)
    lm = load_model(d, "tiny", num_slots=2, context_size=256, dtype="float32",
                    device="cpu", prefill_chunk=64)
    app = App({"tiny": lm})
    server = make_server(app, "127.0.0.1", 0)
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    yield f"http://127.0.0.1:{server.server_address[1]}", lm
    server.shutdown()
    server.server_close()
    app.shutdown()


def _post(url, body) -> str:
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        assert r.status == 200
        return r.read().decode()


def chat(base, body) -> tuple:
    """(calls, finish, content) of a chat answer, streamed or not."""
    text = _post(base + "/v1/chat/completions",
                 {"model": "tiny", "messages": MESSAGES, **body})
    if not body.get("stream"):
        ch = json.loads(text)["choices"][0]
        return (ch["message"].get("tool_calls") or [], ch["finish_reason"],
                ch["message"]["content"])
    lines = [ln[6:] for ln in text.splitlines() if ln.startswith("data: ")]
    assert lines[-1] == "[DONE]"
    events = [json.loads(x) for x in lines[:-1]]
    deltas = [e["choices"][0]["delta"] for e in events]
    calls = [c for d in deltas for c in d.get("tool_calls") or ()]
    assert sum(1 for d in deltas if d.get("tool_calls")) <= 1
    content = "".join(d.get("content") or "" for d in deltas)
    return calls, events[-1]["choices"][0]["finish_reason"], content


def test_tool_call_forced_by_grammar(served):
    """tests/test_e2e_http.py::test_tool_call_forced_by_grammar's request
    and checks on the port."""
    base, _lm = served
    calls, finish, content = chat(base, {
        "max_tokens": 96, "temperature": 1.0, "seed": 11, "tools": TOOLS,
        "tool_choice": "required"})
    assert finish == "tool_calls" and content is None
    assert calls[0]["function"]["name"] == "get_weather"
    assert calls[0]["type"] == "function" and calls[0]["id"].startswith("call_")
    assert json.loads(calls[0]["function"]["arguments"])["city"] in ("sf", "nyc")


def test_tool_call_streaming(served):
    """tests/test_e2e_http.py::test_tool_call_streaming's request and
    checks on the port: one tool_calls delta (with its index), no content
    deltas, the final chunk's finish "tool_calls"."""
    base, _lm = served
    calls, finish, content = chat(base, {
        "stream": True, "max_tokens": 96, "temperature": 1.0, "seed": 13,
        "tools": TOOLS, "tool_choice": "required"})
    assert calls and calls[0]["index"] == 0
    assert calls[0]["function"]["name"] == "get_weather"
    assert json.loads(calls[0]["function"]["arguments"])["city"] in ("sf", "nyc")
    assert finish == "tool_calls" and content == ""


@pytest.mark.parametrize("stream", [False, True])
def test_greedy_tool_call_equals_the_jax_engine(served, tiny, stream):  # noqa: F811
    """Greedy: the port's answer is the call the JAX Engine (the port
    engine's knobs) decodes under the JAX route's grammar from the same
    rendered prompt, as the JAX parser reads it."""
    base, lm = served
    body = {"tools": TOOLS + [SEARCH], "temperature": 0.0, "max_tokens": 96,
            "stream": stream}
    calls, finish, _c = chat(base, body)
    ec = lm.engine.ecfg
    je = jax_engine(tiny, "paged", num_slots=ec.num_slots,
                    max_context=ec.max_context,
                    prefill_buckets=tuple(ec.prefill_buckets),
                    prefill_chunk=ec.prefill_chunk, decode_burst=ec.decode_burst,
                    kv_page_size=ec.kv_page_size)
    try:
        text, _evs = je.generate_text(jeng.GenRequest(
            prompt_ids=tiny["hf_tok"].encode(
                build_chat_prompt(ModelConfig(), MESSAGES)[0]),
            max_new_tokens=96, grammar=jax_route_grammar(body),
            params=jsamp.SamplingParamsHost(temperature=0.0)))
    finally:
        je.shutdown()
    want = jparse.parse_function_calls(text, JFunctionsConfig())
    assert want and finish == "tool_calls"
    assert [(c["function"]["name"], c["function"]["arguments"]) for c in calls] \
        == [(c.name, c.arguments) for c in want]


def test_parallel_tool_calls_answer_an_array(served):
    """parallel_tool_calls: the grammar is a JSON array of calls (the JAX
    one has no minItems rule, so "[]" is an answer too: no call, its
    text as the content, as the JAX route answers it)."""
    base, _lm = served
    answers = [chat(base, {"max_tokens": 200, "temperature": 1.0, "seed": seed,
                           "tools": TOOLS + [SEARCH],
                           "parallel_tool_calls": True})
               for seed in (7, 8, 9, 10)]
    for calls, finish, content in answers:
        if not calls:
            assert json.loads(content) == [] and finish == "stop"
    calls = [c for a in answers for c in a[0]]
    assert calls and all(a[1] == "tool_calls" for a in answers if a[0])
    for c in calls:
        args = json.loads(c["function"]["arguments"])
        assert (c["function"]["name"], sorted(args)) in (
            ("get_weather", ["city"]), ("search", ["q"]))


@pytest.mark.parametrize("stream", [False, True])
def test_own_grammar_wins_over_tools(served, stream):
    """A request's own grammar: the route builds no tool grammar and does
    not buffer; the text is the grammar's, not a call (the JAX route)."""
    base, _lm = served
    calls, finish, content = chat(base, {
        "tools": TOOLS, "grammar": 'root ::= "yes" | "no"', "stream": stream,
        "temperature": 0.0, "max_tokens": 8})
    assert calls == [] and finish == "stop" and content in ("yes", "no")
