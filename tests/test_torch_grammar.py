"""Grammar-constrained decoding in the PyTorch port (functions/grammars/,
engine/engine.py's grammar control flow, engine/sampling.py's bias rows)
against the JAX package, on the CPU, over the tiny f32 checkpoint
(tests/tinymodel.py) and seeded inputs.

  * the GBNF parser, the automaton, the JSON-schema converter,
    ``grammar_for_functions`` and ``parse_function_calls`` give the JAX
    functions' results on the cases of tests/test_grammar.py,
    tests/test_functions.py and tests/test_native_grammar.py (one test
    per function, parametrised over the cases); ``token_strings`` gives
    the JAX list on every tokenizer the tests use, specials as None;
  * the native runtime (csrc/grammar.cc, built with g++) equals the Python
    automaton state by state: acceptance, and the penalty rows over a
    byte vocabulary and over a vocabulary of multi-character pieces
    drawn here, along seeded walks;
  * ENGINE BYTE GATES with the JAX EngineConfig of tests/test_grammar.py
    (2 slots, context 128, decode_burst 8, the pipelined loop at its
    default depth, speculation at its default), paged, int8 KV and
    contiguous: greedy grammar streams equal the JAX Engine's request by
    request, with the same rollbacks per request; free streams beside
    them equal their solo runs; every constrained output is accepted by
    its grammar; the KV audit stays clean (strict);
  * sampled grammar requests give JSON of the schema, emitter on and off;
  * a grammar slot never joins a spec round (n-gram or the draft model),
    is never a fork sibling, is never a preemption victim, and stays
    valid across a context shift.
"""

from __future__ import annotations

import tests.torch_cpu  # noqa: F401  (one torch CPU thread)

import json
import os
import re
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localai_tpu.config.model_config import FunctionsConfig as JFunctionsConfig
from localai_tpu.engine import engine as jeng
from localai_tpu.engine import sampling as jsamp
from localai_tpu.engine import weights as jweights
from localai_tpu.functions import parse as jparse
from localai_tpu.functions.grammars import automaton as jauto
from localai_tpu.functions.grammars import gbnf as jgbnf
from localai_tpu.functions.grammars import json_schema as jjs
from localai_tpu.models import llama as jllama
from localai_tpu_torch.engine import engine as teng
from localai_tpu_torch.engine import sampling as tsamp
from localai_tpu_torch.engine import weights as tweights
from localai_tpu_torch.engine.tokenizer import ByteTokenizer as PortByteTokenizer
from localai_tpu_torch.engine.tokenizer import load_tokenizer
from localai_tpu_torch.functions import parse as tparse
from localai_tpu_torch.functions.grammars import automaton as tauto
from localai_tpu_torch.functions.grammars import gbnf as tgbnf
from localai_tpu_torch.functions.grammars import json_schema as tjs
from localai_tpu_torch.functions.grammars import native
from localai_tpu_torch.models import llama as tllama
from tests.conftest import ByteTokenizer

# ---------- the JAX tests' cases ----------

GBNF_CASES = {
    "alternation": ('root ::= "ab" | "cd"', ["ab", "cd", "ac", "abx", "a"]),
    "class_repeat": ("root ::= [a-z]+ [0-9]*", ["abc", "abc123", "123", ""]),
    "optional": ('root ::= ("+" | "-")? [0-9]+', ["42", "-7", "+1", "--1"]),
    "recursion": ('root ::= value\nvalue ::= "[" (value ("," value)*)? "]" | [0-9]',
                  ["[]", "[1,2,[3]]", "[1,]"]),
    "braces": ("root ::= [a]{2,4}", ["a", "aa", "aaaa", "aaaaa"]),
    "negated": (r'root ::= "\"" [^"]* "\""', ['"hello"', '"he"llo"']),
    "digits_list": ('root ::= "[" [0-9] ("," [0-9]){0,8} "]"',
                    ["[1]", "[1,2,3]", "[1,2,3,4,5,6,7,8,9,0]", "[1,]"]),
}
BAD_GRAMMARS = ['root ::= undefined-rule', 'notroot ::= "a"',
                'root ::= "unterminated']
CITY = {"type": "object", "properties": {"city": {"enum": ["sf", "nyc"]}},
        "required": ["city"]}
# the JAX e2e tool schema with an enum, plus an integer and a free string
TOOL_ARGS = {"type": "object", "properties": {
    "city": {"enum": ["sf", "nyc"]}, "days": {"type": "integer"},
    "note": {"type": "string"}}, "required": ["city", "days", "note"]}
SCHEMAS = {
    "basic": {"type": "object", "properties": {
        "name": {"type": "string"}, "age": {"type": "integer"}},
        "required": ["name", "age"]},
    "city": CITY,
    "tool_args": TOOL_ARGS,
    "call": {"type": "object", "properties": {
        "name": {"const": "get_weather"},
        "arguments": {"type": "object",
                      "properties": {"city": {"type": "string"}},
                      "required": ["city"]}},
        "required": ["name", "arguments"]},
    "native_json": {"type": "object", "properties": {
        "name": {"type": "string"}, "count": {"type": "integer"}},
        "required": ["name"]},
    "optional_chain": {"type": "object", "properties": {
        "a": {"type": "boolean"}, "b": {"type": "number"},
        "c": {"type": "null"}}, "required": []},
    "array_anyof": {"type": "array", "items": {"anyOf": [
        {"type": "integer"}, {"type": "string"}]}},
    "untyped": {"type": "object", "properties": {"x": {}}},
}
FUNCS = [{"name": "get_weather", "parameters": CITY},
         {"name": "search", "parameters": {"type": "object", "properties": {
             "q": {"type": "string"}}, "required": ["q"]}}]
FUNCTION_CASES = {
    "single": ([FUNCS[0]], {}),
    "two": (FUNCS, {}),
    "forced": (FUNCS, {"force_name": "search"}),
    "parallel": (FUNCS, {"parallel_calls": True}),
    "keys": ([FUNCS[0]], {"name_key": "function", "arguments_key": "args"}),
    "no_params": ([{"name": "a"}, {"name": "b"}], {}),
    "none_left": ([FUNCS[0]], {"force_name": "nope"}),
}
PARSE_CASES = {
    "plain": ('{"name": "get_weather", "arguments": {"city": "Paris"}}', {}),
    "embedded": ('Sure! Here is the call: {"name": "f", "arguments": {"x": 1}} '
                 'hope that helps', {}),
    "array": ('[{"name": "a", "arguments": {}}, {"name": "b", "arguments": '
              '{"k": 2}}]', {}),
    "llama31": ('<function=search>{"q": "tpu"}</function>', {}),
    "fenced": ('```json\n{"name": "f", "arguments": {}}\n```', {}),
    "response_regex": ('CALL foo WITH {"a": 1}', {"response_regex": [
        r"CALL (?P<name>\w+) WITH (?P<arguments>\{.*\})"]}),
    "custom_keys": ('{"function": "f", "args": {"z": 3}}', {
        "function_name_key": "function", "function_arguments_key": "args"}),
    "no_action": ('{"name": "answer", "arguments": {}}', {
        "disable_no_action": True, "no_action_function_name": "answer"}),
    "plain_text": ("just a normal reply, no tools here", {}),
    "string_args": ('{"name": "f", "arguments": "{\\"a\\": 1}"}', {}),
    "replace": ('{"name": "f", "arguments": {"a": "X"}}', {
        "replace_function_results": [{"key": "X", "value": "Y"}],
        "replace_llm_results": [["Sure", ""]]}),
    "json_regex": ('<tool>{"name": "g", "arguments": {}}</tool>', {
        "json_regex_match": [r"<tool>(.*)</tool>"]}),
}


@pytest.mark.parametrize("case", sorted(GBNF_CASES))
def test_gbnf_and_automaton_match_jax(case):
    text, strings = GBNF_CASES[case]
    assert tgbnf.parse_gbnf(text) == jgbnf.parse_gbnf(text)
    tg, jg = tauto.Grammar.from_text(text), jauto.Grammar.from_text(text)
    ng = native.NativeGrammar.from_text(text)
    for s in strings:
        assert tg.accepts(s) == jg.accepts(s) == ng.accepts(s), (case, s)
    m = tauto.GrammarMatcher(tg)
    assert m.accept(next(s for s in strings if jg.accepts(s))) and m.accepting


@pytest.mark.parametrize("text", BAD_GRAMMARS)
def test_bad_grammar_raises_like_jax(text):
    with pytest.raises(jgbnf.GrammarError) as jerr:
        jgbnf.parse_gbnf(text)
    with pytest.raises(tgbnf.GrammarError) as terr:
        native.NativeGrammar.from_text(text)
    assert str(terr.value) == str(jerr.value)
    assert isinstance(terr.value, ValueError)


@pytest.mark.parametrize("case", sorted(SCHEMAS))
def test_schema_to_grammar_matches_jax(case):
    g = tjs.schema_to_grammar(SCHEMAS[case])
    assert g == jjs.schema_to_grammar(SCHEMAS[case])
    assert "root ::=" in g
    tauto.Grammar.from_text(g)


@pytest.mark.parametrize("case", sorted(FUNCTION_CASES))
def test_grammar_for_functions_matches_jax(case):
    fns, kw = FUNCTION_CASES[case]
    g = tjs.grammar_for_functions(fns, **kw)
    assert g == jjs.grammar_for_functions(fns, **kw)
    if case == "none_left":
        assert g == ""
    elif case == "forced":
        gr = tauto.Grammar.from_text(g)
        assert gr.accepts('{"name": "search", "arguments": {"q": "x"}}')
        assert not gr.accepts('{"name": "get_weather", "arguments": {"city": "sf"}}')


@pytest.mark.parametrize("case", sorted(PARSE_CASES))
def test_parse_function_calls_matches_jax(case):
    text, kw = PARSE_CASES[case]
    got = tparse.parse_function_calls(text, tparse.FunctionsConfig(**kw))
    want = jparse.parse_function_calls(text, JFunctionsConfig(**kw))
    assert [(c.name, c.arguments) for c in got] == \
        [(c.name, c.arguments) for c in want]
    assert tparse.text_content(text) == jparse.text_content(text)
    if case == "plain":
        assert json.loads(got[0].arguments) == {"city": "Paris"}


def test_functions_config_defaults_match_jax():
    import dataclasses

    assert dataclasses.asdict(tparse.FunctionsConfig()) == \
        dataclasses.asdict(JFunctionsConfig())


# ---------- the tiny checkpoint ----------

@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    from transformers import AutoTokenizer

    from tests.tinymodel import write_tiny_checkpoint

    d = str(tmp_path_factory.mktemp("tiny_grammar"))
    write_tiny_checkpoint(d)
    with open(os.path.join(d, "config.json")) as f:
        hf = json.load(f)
    jcfg = jllama.LlamaConfig.from_hf_config(hf, dtype=jnp.float32)
    jparams = jweights.load_llama_params(d, jcfg, dtype=jnp.float32)
    tcfg = tllama.LlamaConfig.from_hf_config(hf, dtype=torch.float32)
    tparams = tweights.from_jax_params(jax.tree.map(np.asarray, jparams),
                                       tcfg, device="cpu")
    return {"jcfg": jcfg, "jparams": jparams, "tcfg": tcfg, "tparams": tparams,
            "hf_tok": AutoTokenizer.from_pretrained(d), "tok": load_tokenizer(d)}


@pytest.mark.parametrize("which", ["tiny_byte_level", "conftest_bytes",
                                   "port_bytes"])
def test_token_strings_match_jax(tiny, which):
    """The port's tokenizers give the JAX list: the tiny checkpoint's
    byte-level vocabulary against the JAX backend's HF tokenizer of the
    same dir (specials None), the tests' byte tokenizer, and the port's
    plain byte map (which the JAX function reads through the same
    minimal surface)."""
    if which == "tiny_byte_level":
        got = tauto.token_strings(tiny["tok"])
        want = jauto.token_strings(tiny["hf_tok"])
        assert got[0] is None and got[1] is None         # <s>, </s>
    elif which == "conftest_bytes":
        got = tauto.token_strings(ByteTokenizer())
        want = jauto.token_strings(ByteTokenizer())
    else:
        got = tauto.token_strings(PortByteTokenizer(eos_token_id=0))
        want = jauto.token_strings(PortByteTokenizer(eos_token_id=0))
        assert len(got) == 256
    assert got == want


# ---------- the native runtime against the automaton ----------

def _pieces_vocab(seed: int = 3, n: int = 3000) -> list:
    """A vocabulary of multi-character pieces: the 128 ASCII characters
    (one token each, EOS at id 0 with no string), then seeded pieces of
    2-8 characters from letters, digits, a leading space and the JSON
    punctuation, alone and joined to letters."""
    rng = np.random.default_rng(seed)
    alpha = list("abcdefghijklmnopqrstuvwxyz0123456789") + ['"', ":", ",", "{",
                                                           "}", "[", "]", " "]
    out = [None] + [chr(i) for i in range(1, 128)]
    for _ in range(n):
        k = int(rng.integers(2, 9))
        s = "".join(rng.choice(alpha, size=k))
        if rng.random() < 0.3:
            s = " " + s[1:]
        out.append(s)
    return out


def _walk(strs, eos, text, seed, steps=40):
    """Both automata along one seeded walk of allowed tokens: the rows,
    the acceptance and the memo identity agree at every state."""
    V = len(strs)
    pb, nb = tauto.TokenMaskBuilder(strs, [eos], V), native.NativeMaskBuilder(strs, [eos], V)
    pg, ng = tauto.Grammar.from_text(text), native.NativeGrammar.from_text(text)
    ps, ns = pg.initial_state(), ng.initial_state()
    rng = np.random.default_rng(seed)
    visited = 0
    for _ in range(steps):
        pr, nr = pb.penalty_row(pg, ps), nb.penalty_row(ng, ns)
        assert np.array_equal(pr, nr)
        assert nb.penalty_row(ng, ns) is nr             # memoized per state
        assert pg.is_accepting(ps) == ng.is_accepting(ns)
        visited += 1
        allowed = [t for t in np.nonzero(pr == 0.0)[0] if t != eos]
        if not allowed:
            break
        piece = strs[int(rng.choice(allowed))]
        ps, ns = pg.advance_string(ps, piece), ng.advance_string(ns, piece)
        assert ps is not None and ns is not None
    return visited


@pytest.mark.parametrize("vocab", ["bytes", "pieces"])
@pytest.mark.parametrize("case", ["native_json", "tool_args", "digits_list",
                                  "untyped"])
def test_native_rows_equal_python_state_by_state(vocab, case):
    text = (GBNF_CASES[case][0] if case in GBNF_CASES
            else tjs.schema_to_grammar(SCHEMAS[case]))
    if vocab == "bytes":
        strs, eos = tauto.token_strings(ByteTokenizer()), 0
    else:
        strs, eos = _pieces_vocab(), 0
    n = sum(_walk(strs, eos, text, seed) for seed in range(3))
    assert n >= 6
    # a rejected piece is rejected by both
    pg, ng = tauto.Grammar.from_text(text), native.NativeGrammar.from_text(text)
    assert pg.advance_string(pg.initial_state(), "x@") is None
    assert ng.advance_string(ng.initial_state(), "x@") is None


# ---------- engine byte gates against the JAX Engine ----------

# the JAX EngineConfig of tests/test_grammar.py's burst test
EC = dict(num_slots=2, max_context=128, prefill_buckets=(16, 64),
          prefill_chunk=64, decode_burst=8)
LAYOUTS = {"paged": ({}, {"cache_dtype": jnp.float32, "kv_layout": "paged"}),
           "int8": ({"cache_dtype": torch.int8},
                    {"cache_dtype": jnp.int8, "kv_layout": "paged"}),
           "contig": ({"kv_layout": "contiguous"},
                      {"cache_dtype": jnp.float32, "kv_layout": "contiguous"})}
G_JSON = tjs.schema_to_grammar(TOOL_ARGS)
G_CITY = tjs.schema_to_grammar(CITY)
G_LIST = GBNF_CASES["digits_list"][0]
G_CALL = tjs.grammar_for_functions(FUNCS)


class _BusyCard(threading.Event):
    """A burst's ready event as the loop sees it on a busy card: never set
    when the loop only looks (``is_set``), set when it waits (``wait``)."""

    def is_set(self) -> bool:
        return False


def jax_engine(tiny, layout, **kw):
    """The JAX Engine, its bursts held to the busy card's order. Its loop
    reads a burst early when the sync worker has already marked it ready,
    which on the CPU depends on the host's timing; with the ready events
    seen only by a wait, a burst is read when the loop must wait for it,
    the order the port's CPU loop keeps (its engine module doc). The burst
    structure, and so which tokens a grammar slot sampled under a stale
    mask, is then the same on both."""
    e = jeng.Engine(tiny["jcfg"], tiny["jparams"], tiny["hf_tok"],
                    jeng.EngineConfig(**{**EC, **kw}, **LAYOUTS[layout][1]))
    put = e._sync_q.put

    def busy_put(item, *a, **k):
        if isinstance(item, jeng._Burst):
            item.ready = _BusyCard()
        return put(item, *a, **k)

    e._sync_q.put = busy_put
    e.start()
    return e


def port_engine(tiny, layout="paged", start=True, **kw):
    e = teng.Engine(tiny["tcfg"], tiny["tparams"], tiny["tok"],
                    teng.EngineConfig(**{**EC, **kw}, **LAYOUTS[layout][0]),
                    device="cpu")
    return e.start() if start else e


def req(e, prompt: str, n: int, grammar: str = "", temperature: float = 0.0,
        seed: int = -1, rid: str = "", **kw):
    mod, samp = (teng, tsamp) if isinstance(e, teng.Engine) else (jeng, jsamp)
    # the port's byte-level tokenizer and the JAX backend's HF one give
    # the same ids (tests/test_torch_server.py)
    return mod.GenRequest(
        prompt_ids=e.tokenizer.encode(prompt), max_new_tokens=n, grammar=grammar,
        request_id=rid, ignore_eos=not grammar,
        params=samp.SamplingParamsHost(temperature=temperature, seed=seed), **kw)


def drain(out) -> dict:
    ids, text, fin, errs = [], "", None, []
    while (ev := out.get(timeout=600)) is not None:
        if ev.error:
            errs.append(ev.error)
        ids.extend(ev.token_ids or ([ev.token_id] if ev.token_id >= 0 else []))
        text += ev.text
        fin = ev.finish_reason or fin
    assert not errs, errs
    return {"ids": ids, "text": text, "finish": fin}


def together(e, reqs: list) -> list:
    """Submit ``reqs`` so the engine admits them in one pass (admission
    held until all are queued), then drain each."""
    e._admit = lambda: False
    try:
        outs = [e.submit(r) for r in reqs]
    finally:
        del e._admit
    e._wake.set()
    return [drain(o) for o in outs]


def count_rollbacks(e) -> dict:
    """Rollbacks per request id (a wrapper on the engine instance)."""
    counts: dict = {}
    orig = e._rollback_grammar

    def spy(slot, s):
        counts[s.req.request_id] = counts.get(s.req.request_id, 0) + 1
        return orig(slot, s)

    e._rollback_grammar = spy
    return counts


# (prompt, max_new_tokens, grammar) per request, in waves admitted together
WAVES = [
    [("call: weather?", 48, G_JSON), ("free text", 24, "")],
    [("json:", 24, G_LIST), ("weather in sf", 40, G_CALL)],
    [("again please", 32, G_CITY)],
    [("tool args:", 64, G_JSON), ("json list", 24, G_LIST)],
]


def run_waves(e) -> list:
    counts = count_rollbacks(e)
    out = []
    for w, wave in enumerate(WAVES):
        rids = [f"w{w}r{i}" for i in range(len(wave))]
        res = together(e, [req(e, p, n, g, rid=rid)
                           for (p, n, g), rid in zip(wave, rids)])
        for r, rid in zip(res, rids):
            r["rollbacks"] = counts.get(rid, 0)
        out.append(res)
    return out


@pytest.fixture(scope="module", params=sorted(LAYOUTS))
def gated(request, tiny):
    layout = request.param
    out = {"layout": layout}
    je = jax_engine(tiny, layout)
    try:
        out["jax"] = run_waves(je)
    finally:
        je.shutdown()
    e = port_engine(tiny, layout, kv_audit="strict")
    try:
        out["port"] = run_waves(e)
        out["solo"] = drain(e.submit(req(e, "free text", 24)))
        out["metrics"] = e.metrics()
    finally:
        e.shutdown()
    return out


def test_grammar_streams_equal_the_jax_engine(gated):
    for w, (got, want) in enumerate(zip(gated["port"], gated["jax"])):
        for i, (g, j) in enumerate(zip(got, want)):
            assert g["ids"] == j["ids"], (gated["layout"], w, i)
            assert (g["finish"], g["rollbacks"]) == (j["finish"], j["rollbacks"]), \
                (gated["layout"], w, i)
    assert sum(r["rollbacks"] for wave in gated["port"] for r in wave) > 0
    m = gated["metrics"]
    assert m["grammar"]["rollbacks"] == sum(
        r["rollbacks"] for wave in gated["port"] for r in wave)
    assert m["grammar"]["flushes"] > 0 and m["grammar"]["memo_hits"] > 0


def test_free_streams_beside_grammar_equal_solo(gated):
    free = gated["port"][0][1]
    assert free["ids"] == gated["solo"]["ids"] == gated["jax"][0][1]["ids"]
    assert len(free["ids"]) == 24


def test_grammar_outputs_are_valid(gated):
    for wave_spec, wave in zip(WAVES, gated["port"]):
        for (_p, _n, g), r in zip(wave_spec, wave):
            if not g:
                continue
            if r["finish"] == "stop":
                assert tauto.Grammar.from_text(g).accepts(r["text"]), r["text"]
            else:                       # cut by max_tokens: a valid prefix
                st = tauto.Grammar.from_text(g).advance_string(
                    tauto.Grammar.from_text(g).initial_state(), r["text"])
                assert st is not None, r["text"]
    stopped = [r for wave in gated["port"] for r in wave if r["finish"] == "stop"]
    assert stopped


def test_kv_audit_clean_after_grammar_run(gated):
    m = gated["metrics"]
    assert m["active_slots"] == 0
    if gated["layout"] != "contig":
        assert m["kv_audit"]["violations"] == 0 and m["kv_audit"]["checks"] > 0
        assert m["pages_in_use"] == 0


# ---------- sampled grammar requests ----------

@pytest.mark.parametrize("emitter", [True, False])
def test_sampled_grammar_output_parses(tiny, emitter):
    """JAX ``test_engine_forces_valid_json_from_random_weights``: sampled
    (temperature 1) requests under the city schema give JSON of it, with
    the emitter on and off; the same model unconstrained gives no JSON."""
    e = port_engine(tiny, emitter=emitter)
    try:
        for seed in (5, 9, 13):
            r = drain(e.submit(req(e, "call:", 64, G_CITY, temperature=1.0,
                                   seed=seed)))
            assert json.loads(r["text"])["city"] in ("sf", "nyc")
            assert r["finish"] == "stop"
        r = drain(e.submit(req(e, "call:", 64, G_JSON, temperature=1.0, seed=3)))
        if r["finish"] == "stop":
            args = json.loads(r["text"])
            assert args["city"] in ("sf", "nyc") and isinstance(args["days"], int)
        free = drain(e.submit(req(e, "call:", 32, temperature=1.0, seed=5)))
        with pytest.raises(ValueError):
            json.loads(free["text"])
        assert e.metrics()["emitter"]["enabled"] == emitter
    finally:
        e.shutdown()


# ---------- the gates ----------

@pytest.mark.parametrize("drafter", ["ngram", "model"])
def test_grammar_slot_never_enters_spec_rounds(tiny, drafter):
    """JAX tests/test_spec_sampled.py's case, with the n-gram drafter and
    with a draft model (the target as its own draft): a grammar slot as
    the only traffic runs no spec tick; a free request after it does."""
    draft = (tiny["tcfg"], tiny["tparams"]) if drafter == "model" else None
    e = teng.Engine(tiny["tcfg"], tiny["tparams"], tiny["tok"],
                    teng.EngineConfig(**EC), device="cpu", draft=draft).start()
    try:
        assert e._spec_mode == drafter
        r = drain(e.submit(req(e, "call: call: call:", 32, G_CITY,
                               temperature=0.8, seed=5)))
        assert r["ids"]
        st = e.metrics()["spec"]
        assert st["dispatches"] == 0 and st["rounds"] == 0
        drain(e.submit(req(e, "call: call: call:", 32)))
        assert e.metrics()["spec"]["rounds"] > 0
    finally:
        e.shutdown()


def test_grammar_requests_never_fork(tiny):
    """Two identical grammar requests admitted together prefill apart (no
    fork sibling), and give the same valid output; two identical free
    requests fork, as before."""
    e = port_engine(tiny)
    try:
        a, b = together(e, [req(e, "same prompt here", 32, G_CITY, rid=f"g{i}")
                            for i in range(2)])
        assert a["ids"] == b["ids"] and json.loads(a["text"])
        assert e.metrics()["fork"]["siblings"] == 0
        together(e, [req(e, "same prompt here", 8) for _ in range(2)])
        assert e.metrics()["fork"]["siblings"] == 1
    finally:
        e.shutdown()


def test_grammar_slot_is_never_a_preemption_victim(tiny):
    """One slot, held by a low-priority grammar request that cannot end
    early; a high-priority arrival waits for it instead of pausing it (a
    free low request in its place is paused). The loop is driven tick by
    tick, so the arrival always finds the low request decoding."""
    g = "root ::= [a-z]{60}"
    got = {}
    for kind in ("grammar", "free"):
        e = port_engine(tiny, num_slots=1, start=False, emitter=False)
        try:
            low = e.submit(req(e, "low priority", 60, g if kind == "grammar"
                               else "", priority="low"))
            while e.slots[0] is None or e.slots[0].n_decoded == 0:
                e._tick()
            high = e.submit(req(e, "high", 8, priority="high"))
            while e._tick():
                pass
            lo, hi = drain(low), drain(high)
            got[kind] = e.metrics()["lifecycle"]["preemptions"]
        finally:
            e.shutdown()
        assert len(hi["ids"]) == 8 and len(lo["ids"]) == 60
        if kind == "grammar":
            assert re.fullmatch("[a-z]{60}", lo["text"])
    assert got == {"grammar": 0, "free": 1}


def test_grammar_slot_across_a_context_shift(tiny):
    """A grammar that needs 70 letters at context 64: the slot shifts its
    context and its automaton state carries on; the output is the
    grammar's, ended by EOS."""
    g = 'root ::= [a-z]{70} "!"'
    e = port_engine(tiny, max_context=64, prefill_buckets=(16, 32),
                    prefill_chunk=32)
    try:
        before = e.metrics()["packed_prefill"]["dispatches"]
        r = drain(e.submit(req(e, "letters:", 100, g)))
        assert r["finish"] == "stop" and re.fullmatch(r"[a-z]{70}!", r["text"])
        assert e.metrics()["packed_prefill"]["dispatches"] >= before + 2
    finally:
        e.shutdown()
