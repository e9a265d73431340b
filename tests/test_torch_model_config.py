"""The port's model configs (config/yaml_lite.py, config/model_config.py,
config/guesser.py) against ``yaml.safe_load`` and the JAX package's
modules, on the CPU:

  * ``yaml_lite.safe_load`` equals ``yaml.safe_load`` on every YAML form
    the JAX tests write (tests/test_templates_config.py,
    tests/test_e2e_http.py, tests/test_distributed.py), on the YAML 1.1
    scalar forms (``yes``, ``on``, ``0o17``, ``1e3``, ``.5``, ``017``,
    ``1:30``, ...), block scalars, flow collections and documents, and on
    documents hypothesis builds inside the subset; a document PyYAML
    refuses is refused too;
  * forms outside the subset (anchors, aliases, tags, complex keys,
    directives, timestamps, merge keys, multi-line plain and quoted
    scalars, tabs outside quoted and block scalars, indentation
    indicators) raise ``YAMLError`` with their line number;
  * ``load_model_config``, ``load_multi_config``, ``scan_models_dir``
    (with ``guess_defaults``), ``validate``, ``usecases`` and
    ``sampling_host`` give the JAX results on the same files and
    dataclasses, field by field;
  * a config template outside the renderer's subset skips its config at
    scan, with the JAX scan's warning, and the scan hands back its name
    and error.
"""

from __future__ import annotations

import tests.torch_cpu  # noqa: F401  (one torch CPU thread)

import dataclasses
import json
import math
import textwrap

import pytest
import yaml
from hypothesis import given, settings
from hypothesis import strategies as st

from localai_tpu.config import guesser as jguess
from localai_tpu.config import model_config as jmc
from localai_tpu_torch.config import guesser as tguess
from localai_tpu_torch.config import model_config as tmc
from localai_tpu_torch.config import yaml_lite
from tests.test_distributed import _DIST_YAML
from tests.test_e2e_http import TINY_YAML

JAX_TEST_YAML = [
    TINY_YAML, _DIST_YAML, "name: good\n", "backend: fake\n",
    textwrap.dedent("""
        name: mymodel
        backend: tpu-llm
        context_size: 1024
        parameters:
          model: weights-dir
          temperature: 0.2
          top_p: 0.9
        stopwords: ["</s>"]
        template:
          chat: "{{ Input }}"
        system_prompt: "be nice"
    """),
    textwrap.dedent("""
        - name: a
          parameters: {model: ma}
        - name: b
          parameters: {model: mb}
    """),
]

FORMS = [
    # YAML 1.1 scalars as PyYAML types them
    "a: 1\nb: yes\nc: on\nd: 0o17\ne: 1e3\nf: .5\ng: 017\nh: 1_000\n"
    "i: 1:30\nj: ~\nk:\nl: -.5\nm: +.inf\nn: 0x1F\no: 0b101\np: 1.0e+3\n"
    "q: 1.0e3\nr: 09\ns: -0\nt: 'it''s'\nu: \"a\\tb\\u00e9\\x41\"\nv: No\n"
    "w: OFF\nx: Null\ny: 1_000.5\nz: 190:20:30.15\naa: .NaN\nab: -.inf\n"
    "ac: 0.\nad: +12\nae: 0_7\naf: '01'\nag: \"\"\nah: ''\n",
    # block scalars (templates)
    "template:\n  chat: |\n    {{ Input }}\n    more\n  completion: >\n"
    "    folded\n    text\n\n    para\n      kept\n    end\n  edit: |-\n    x\n"
    "  function: |+\n    keep\n\n\nafter: 1\n",
    "a: |\n\n  lead blank\n  x\n\n\nb: >-\n  one\n  two\n\n  three\nc: |\n"
    "  trailing\n",
    "s:\n- |\n  in a sequence\n- >\n  folded\n  entry\n- plain\n",
    # collections
    "- a\n- b: 1\n  c: 2\n- - x\n  - y\n- [1, 2, {a: b}]\n- {a: [1, 2], 'b c': \"d\"}\n",
    "# comment\nkey: value # trailing\nurl: http://x:8080/a#b\nempty_list: []\n"
    "empty_map: {}\nlist:\n  - 1\n  -\n    a: 1\n  - - deep\n",
    "flow: [a,\n  b, c]\nm: {x: 1,\n  y: [2, 3]}\nk: 'a # not a comment'\n"
    "j: \"q: x\"\n",
    "a:\n- x\n- y\nb:\n  c:\n    d: [true, no, 3.0]\n",
    "1: int key\nyes: bool key\n~: null key\n'quoted': k\n\"dq\": v\n",
    "stopwords:\n  - \"<|eot_id|>\"\n  - '<|end_of_text|>'\noptions:\n"
    "  - kv_offload=0\n  - draft=0\n",
    # documents
    "---\na: 1\n---\nb: 2\n", "---\n", "", "# only a comment\n",
    "--- \nname: x\n...\n", "plain scalar doc\n", "[1, 2]\n",
    "a: 1\r\nb: 2\r\n", "a: b\nc: d",
    # a quote or a "#" escaped inside a quoted scalar, tabs where allowed
    'a: "x\\" # y"\n', "a: 'it''s # x'\n", "a: 'x'' # y' # z\n",
    "- '''\t'\n", 'a: "x\\"\ty"\n', "a: |\n  x\ty\n# c\td\n",
]

OUTSIDE = [
    ("a: &x 1\n", 1), ("a: 1\nb: *x\n", 2), ("a: !!str 1\n", 1),
    ("? a\n: b\n", 1), ("a: 2001-12-14\n", 1), ("a: b\n  c\n", 2),
    ("<<: {a: 1}\n", 1), ("x: 1\na: 'multi\n  line'\n", 2),
    ("\ta: 1\n", 1), ("a: |2\n  x\n", 1), ("%YAML 1.1\n---\na: 1\n", 1),
    ("a:\n  b: 1\n c: 2\n", 3), ("a: [1, 2\nb: 3\n", 1),
    ("a: b: c\n", 1), ("a: - x\n", 1),
    # PyYAML refuses a tab outside a quoted or block scalar or a comment
    ("0\t0\n", 1), ("a: 1\nb: x\ty\n", 2), ("a: [1,\t2]\n", 1),
    ("a: 1 \t# c\n", 1), ("a:\tx\n", 1), ("a: 1\n\t\nb: 2\n", 2),
]


def same(a, b) -> bool:
    """Equality with NaN equal to NaN."""
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a):
        return math.isnan(b)
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return (list(a) == list(b)
                and all(same(a[k], b[k]) for k in a))
    if isinstance(a, list):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    return a == b


def load_both(text: str):
    try:
        want = list(yaml.safe_load_all(text))
    except yaml.YAMLError:
        want = None
    try:
        got = yaml_lite.safe_load_all(text)
    except yaml_lite.YAMLError:
        got = None
    return want, got


@pytest.mark.parametrize("text", JAX_TEST_YAML + FORMS)
def test_yaml_lite_equals_safe_load(text):
    want, got = load_both(text)
    assert want is not None
    assert same(got, want), (got, want)
    if len(want) <= 1:
        assert same(yaml_lite.safe_load(text), yaml.safe_load(text))


@pytest.mark.parametrize("text,line", OUTSIDE)
def test_outside_the_subset_raises_with_its_line(text, line):
    with pytest.raises(yaml_lite.YAMLError) as ei:
        yaml_lite.safe_load(text)
    assert ei.value.line == line, str(ei.value)


def test_malformed_is_refused_as_pyyaml_refuses():
    for text in ("{ not yaml ::", "a: [1, 2", "a: 'x\n", "- a\nb: 1\n"):
        want, got = load_both(text)
        assert want is None and got is None, text


# ---- hypothesis: documents inside the subset ----

_PLAIN = st.text(alphabet="abcXYZ019_-.,/()+ ", min_size=1, max_size=12)
_ANY = st.text(alphabet="abcé日 019_-:#'\"\\/,.[]{}!&*?|>%@`\t", max_size=12)


def _scalar_text(draw, value) -> str:
    """``value`` written in one of the subset's scalar forms."""
    if value is None:
        return draw(st.sampled_from(["~", "null", "", "Null"]))
    if isinstance(value, bool):
        return draw(st.sampled_from(
            ["yes", "Yes", "on", "true", "True"] if value
            else ["no", "off", "OFF", "false", "False"]))
    if isinstance(value, (int, float)):
        return repr(value)
    style = draw(st.sampled_from(["plain", "single", "double"]))
    if style == "plain":
        s = value.strip()
        if s and s[0] not in "-?:,[]{}#&*!|>'\"%@`" and ": " not in s \
                and " #" not in s and not s.endswith(":") and "\t" not in s:
            return s
        style = "double"
    if style == "single":
        return "'" + value.replace("'", "''") + "'"
    return json.dumps(value)


@st.composite
def _tree(draw, depth=0):
    leaf = st.one_of(st.none(), st.booleans(),
                     st.integers(-10**6, 10**6),
                     st.floats(allow_nan=False, allow_infinity=False,
                               width=32), _PLAIN, _ANY)
    if depth >= 3:
        return draw(leaf)
    kind = draw(st.sampled_from(["leaf", "list", "dict", "block"]))
    if kind == "leaf":
        return draw(leaf)
    if kind == "block":
        lines = draw(st.lists(st.text(alphabet="ab c{}%:#-", max_size=8)
                              .map(lambda s: s.lstrip(" ")), min_size=1,
                              max_size=4))
        return ("block", "\n".join(lines))
    items = draw(st.lists(_tree(depth + 1), max_size=4))
    if kind == "list":
        return items
    keys = draw(st.lists(st.text(alphabet="abkz_", min_size=1, max_size=6),
                         min_size=len(items), max_size=len(items),
                         unique=True))
    return dict(zip(keys, items))


def _emit(draw, node, indent: int) -> list:
    """Lines of ``node`` as a block collection at ``indent`` (or a value
    written after a key / entry: a one-line value is returned as [text])."""
    pad = " " * indent
    if isinstance(node, tuple):
        header = draw(st.sampled_from(["|", "|-", "|+", ">", ">-"]))
        body = [pad + "  " + ln if ln else "" for ln in node[1].split("\n")]
        return [header] + body
    if isinstance(node, list):
        if not node:
            return ["[]"]
        if draw(st.booleans()) and all(
                not isinstance(x, (list, dict, tuple)) for x in node):
            return ["[" + ", ".join(
                json.dumps(x) if isinstance(x, str) else
                "null" if x is None else _scalar_text(draw, x)
                for x in node) + "]"]
        out = [None]
        for x in node:
            sub = _emit(draw, x, indent + 2)
            if len(sub) == 1:
                out.append(f"{pad}- {sub[0]}".rstrip())
            elif sub[0] is None:
                out.append(f"{pad}-")
                out += sub[1:]
            else:
                out.append(f"{pad}- {sub[0]}")
                out += sub[1:]
        return out
    if isinstance(node, dict):
        if not node:
            return ["{}"]
        out = [None]
        for k, v in node.items():
            sub = _emit(draw, v, indent + 2)
            if len(sub) == 1:
                out.append(f"{pad}{k}: {sub[0]}".rstrip())
            elif sub[0] is None:
                out.append(f"{pad}{k}:")
                out += sub[1:]
            else:
                out.append(f"{pad}{k}: {sub[0]}")
                out += sub[1:]
        return out
    return [_scalar_text(draw, node)]


@st.composite
def documents(draw) -> str:
    node = draw(_tree())
    lines = _emit(draw, node, 0)
    if lines[0] is None:
        lines = lines[1:]
    elif isinstance(node, tuple):
        lines = ["x: " + lines[0]] + lines[1:]
    comment = draw(st.booleans())
    text = "\n".join(lines) + "\n"
    return ("# a comment\n" if comment else "") + text


@settings(max_examples=300, deadline=None)
@given(documents())
def test_hypothesis_documents_equal_safe_load(text):
    want, got = load_both(text)
    assert want is not None, text
    assert same(got, want), (text, got, want)


# ---- model configs against the JAX module ----

def _asdict(mc) -> dict:
    return dataclasses.asdict(mc)


CONFIG_FILES = {
    "tiny.yaml": TINY_YAML,
    "dist.yaml": _DIST_YAML,
    "full.yaml": textwrap.dedent("""
        name: full
        parameters:
          model: l3
          temperature: 0.3
          top_k: 20
          max_tokens: 64
          logit_bias: {128009: -5}
        stopwords: [STOP]
        cutstrings: ["<\\\\|.*?\\\\|>"]
        trimspace: [" "]
        trimsuffix: ["\\n"]
        extract_regex: []
        function:
          function_name_key: tool
          function_arguments_key: args
          disable_no_action: yes
        template:
          chat_message: |
            {% if Role == 'user' %}U: {{ Content }}{% else %}A: {{ Content }}{% endif %}
          completion: >-
            Q: {{ Input }}
            A:
        options:
          - kv_offload=0
          - draft=0
          - priority=high
        known_usecases: [chat, completion]
        mesh: {tp: 1}
    """),
    "guessed.yaml": "name: guessed\nparameters:\n  model: l3\n",
    "qwen.yaml": "name: qwen\nparameters: {model: qw}\nstopwords: [X]\n",
    "broken.yaml": "{ not yaml ::",
    "bad_opts.yaml": "name: bad\noptions: [kv_layout=weird, trace=maybe]\n",
    "implicit.yaml": "backend: fake\n",
}


@pytest.fixture(scope="module")
def models_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("models")
    for fn, text in CONFIG_FILES.items():
        (d / fn).write_text(text)
    for name, tpl, mt in (("l3", "{{ '<|start_header_id|>' }}", "llama"),
                          ("qw", None, "qwen2")):
        (d / name).mkdir()
        (d / name / "config.json").write_text(json.dumps(
            {"model_type": mt, "vocab_size": 32000}))
        if tpl:
            (d / name / "tokenizer_config.json").write_text(
                json.dumps({"chat_template": tpl}))
    (d / "multi.yaml.txt").write_text(JAX_TEST_YAML[5])
    return str(d)


@pytest.mark.parametrize("fn", [f for f in CONFIG_FILES if f != "broken.yaml"])
def test_load_model_config_equals_jax(models_dir, fn):
    import os

    path = os.path.join(models_dir, fn)
    got, want = tmc.load_model_config(path), jmc.load_model_config(path)
    assert _asdict(got) == _asdict(want)
    assert got.validate() == want.validate()
    assert got.usecases().value == want.usecases().value
    for overrides in (None, {"temperature": 0.9, "seed": 5, "nope": 1},
                      {"logit_bias": {"3": 1.0}}):
        assert (dataclasses.asdict(got.sampling_host(overrides))
                == dataclasses.asdict(want.sampling_host(overrides)))


def test_load_multi_config_equals_jax(models_dir):
    import os

    path = os.path.join(models_dir, "multi.yaml.txt")
    assert ([_asdict(c) for c in tmc.load_multi_config(path)]
            == [_asdict(c) for c in jmc.load_multi_config(path)])


def test_scan_models_dir_and_guess_equal_jax(models_dir):
    got, want = tmc.scan_models_dir(models_dir), jmc.scan_models_dir(models_dir)
    assert sorted(got) == sorted(want)
    assert "broken" not in got and "bad" not in got
    for name in want:
        assert _asdict(got[name]) == _asdict(want[name]), name
    # the llama3 family was guessed from the tokenizer config's template
    assert got["guessed"].template.chat == tguess.FAMILIES["llama3"][1]
    assert got["guessed"].stopwords == ["<|eot_id|>", "<|end_of_text|>"]
    assert got["qwen"].stopwords == ["X"]            # the YAML's stand
    assert tguess.FAMILIES == jguess.FAMILIES


@pytest.mark.parametrize("options", [
    ["kv_layout=paged", "kv_page_size=64", "trace=0"],
    ["kv_page_size=x", "trace=maybe", "priority=urgent"],
    ["priority_weights=4:2", "draft=maybe", "spec_ngram=0"],
    ["slo_ttft_ms=250:1000:5000", "slo_itl_ms=high=0", "slo_error_budget=2"],
    ["engines=2", "preempt=0", "autoscale=1"],
    ["disagg=prefill", "kv_offload=0", "cluster_suspect_ms=9",
     "cluster_dead_ms=5", "kv_peers=a:1|b"],
    ["prefill_packed_fuse=maybe", "kv_audit=loud", "peak_tflops=-1",
     "kv_window_policy=keep", "comm_overlap=2"],
])
def test_validate_equals_jax(options):
    for extra in ({}, {"group_attn_n": 4, "group_attn_w": 510},
                  {"decode_burst": -1, "num_slots": 0, "scheduler": "x"}):
        got = tmc.ModelConfig(name="m", options=list(options), **extra)
        want = jmc.ModelConfig(name="m", options=list(options), **extra)
        assert got.validate() == want.validate()


def test_template_outside_the_subset_skips_its_config(tmp_path, caplog):
    (tmp_path / "ok.yaml").write_text("name: ok\ntemplate:\n  chat: '{{ Input }}'\n")
    (tmp_path / "macro.yaml").write_text(
        "name: macro\ntemplate:\n  chat: '{% set x = 1 %}{{ x }}'\n")
    skipped = {}
    got = tmc.scan_models_dir(str(tmp_path), skipped)
    assert sorted(got) == ["ok"]
    assert any("macro.yaml" in r.getMessage() and "set" in r.getMessage()
               for r in caplog.records)
    assert skipped == {"macro": "macro.yaml: {% set %} is outside the subset"}


# ---- the config -> request / loader mapping (capabilities.py) ----

@pytest.mark.parametrize("overrides", [
    {}, {"temperature": 0.0, "max_tokens": 7, "stop": ["X"]},
    {"top_k": 5, "seed": 9, "logit_bias": {"3": 2.0}, "ignore_eos": True},
])
def test_predict_overrides_equal_the_jax_predict_options(overrides):
    """The request knobs the port's build_request gets from a config and
    a request equal the JAX build_predict_options' PredictOptions."""
    from localai_tpu.capabilities import build_predict_options
    from localai_tpu_torch.capabilities import predict_overrides

    data = yaml.safe_load(CONFIG_FILES["full.yaml"])
    jc, tc = jmc._build(data), tmc._build(data)
    want = build_predict_options(jc, "p", overrides)
    got = predict_overrides(tc, overrides)
    for k in ("temperature", "top_k", "top_p", "min_p", "typical_p",
              "repeat_penalty", "repeat_last_n", "presence_penalty",
              "frequency_penalty", "mirostat", "mirostat_tau",
              "mirostat_eta", "seed", "max_tokens"):
        assert got[k] == pytest.approx(getattr(want, k)), k
    assert got["stop"] == list(want.stop_sequences)
    assert {int(k): v for k, v in got["logit_bias"].items()} == dict(want.logit_bias)
    assert bool(got.get("ignore_eos", False)) == want.ignore_eos


def test_model_options_type_the_engine_knobs():
    from localai_tpu_torch.capabilities import (model_options,
                                                unported_settings)

    mc = tmc._build({"name": "m", "parameters": {"model": "dir"},
                     "decode_burst": 8, "prefill_buckets": [16, 64],
                     "options": ["kv_prefix_cache=0", "kv_page_size=16",
                                 "trace=off", "peak_tflops=1.5",
                                 "prefill_packed=1", "random_weights=3",
                                 "kv_audit=strict", "no-equals-sign"]})
    kw = model_options(mc, "/models")
    assert kw["model_dir"] == "/models/dir" and kw["context_size"] == 2048
    assert kw["kv_prefix_cache"] is False and kw["trace"] is False
    assert kw["kv_page_size"] == 16 and kw["peak_tflops"] == 1.5
    assert kw["random_weights"] == 3 and kw["kv_audit"] == "strict"
    assert kw["decode_burst"] == 8 and kw["prefill_buckets"] == (16, 64)
    assert "prefill_packed" not in kw and unported_settings(mc) == []
    mc.options = ["no_such_knob=1"]
    with pytest.raises(ValueError, match="no_such_knob"):
        model_options(mc, "/models")
    mc.options = ["prefill_packed=0", "kv_window_pages=4"]
    problems = unported_settings(mc)
    assert len(problems) == 2 and "item 6" in problems[1]
