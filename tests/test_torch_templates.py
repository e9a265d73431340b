"""The port's prompt templating (templates/jinja_lite.py,
templates/prompts.py, api/chatflow.py) against jinja2 with the JAX
package's environment and the JAX modules, on the CPU:

  * every family template of ``guesser.FAMILIES``, the default chat
    message and the multimodal default render byte for byte as jinja2's
    ``Environment(trim_blocks, lstrip_blocks, keep_trailing_newline,
    ChainableUndefined)`` renders them, over seeded message values;
  * templates exercising the subset (whitespace control, lstrip / trim
    around tags inside and alone on a line, loops with ``loop.*``,
    comparisons, ``in``, filters, tests, undefined chains) render as
    jinja2 does;
  * templates outside the subset raise TemplateError when compiled;
  * the JAX template tests' cases (tests/test_templates_config.py) give
    the same strings through the port's prompts module;
  * ``build_chat_prompt`` equals the JAX function on seeded message lists
    under each family's config and the default config.
"""

from __future__ import annotations

import tests.torch_cpu  # noqa: F401  (one torch CPU thread)

import jinja2
import numpy as np
import pytest

from localai_tpu.api import chatflow as jflow
from localai_tpu.config import guesser as jguess
from localai_tpu.config import model_config as jmc
from localai_tpu.templates import prompts as JT
from localai_tpu_torch.api import chatflow as tflow
from localai_tpu_torch.config import model_config as tmc
from localai_tpu_torch.templates import prompts as TT
from localai_tpu_torch.templates.jinja_lite import Template, TemplateError

ENV = jinja2.Environment(loader=jinja2.BaseLoader(),
                         undefined=jinja2.ChainableUndefined,
                         trim_blocks=True, lstrip_blocks=True,
                         keep_trailing_newline=True)

FAMILY_TEMPLATES = [t for fam in jguess.FAMILIES.values() for t in fam[:2]]

SUBSET_TEMPLATES = [
    JT.DEFAULT_CHAT_MESSAGE,
    "A\n  {% if x %}\n  yes\n  {% endif %}\nB\n",
    "{% for m in msgs %}{{ loop.index }}:{{ m.role }}={{ m['content'] | trim }}"
    "{% if not loop.last %}, {% endif %}{% endfor %}\n",
    "{%- if a -%}  X  {%- else -%} Y {%- endif %}\n\n",
    "  {# c #}\nline {{ a | default('d') }} {{ c.d.e }}|{{ none }}|"
    "{{ a is defined }}|{{ q is not defined }}|{{ q | d('z') }}\n",
    "{% for m in msgs %}\n{% if m.role == 'user' and 'x' in m.content %}\nU "
    "{{ m.content }}\n{% elif m.role != 'user' or false %}\nA\n{% endif %}\n"
    "{% endfor %}",
    "x {%+ if a %}y{% endif %}  \n   {{- a }}",
    "{{ Functions | tojson }} {{ Functions | tojson(indent=2) }} {{ 1 < 2 }} "
    "{{ 'a' 'b' }} {{ a or 'z' }} {{ (a and b) }} {{ x not in msgs }}",
    "{% for m in msgs %}{{ loop.index0 }}{{ loop.first }}{{ loop.length }}"
    "{{ loop.revindex }}{% endfor %}{{ loop.index }}",
    "{% if Role %}{{ Role }}: {% endif %}{{ Content }}{# tail -#}   \n\n",
    "  {% if a %}\n\t{% endif %}\n{% if b is none %}N{% endif %}\r\nend\r\n",
    "{{ msgs[0]['role'] }}{{ msgs[1].content }}{{ msgs[5].x.y }}{{ b.k[1] }}",
    "{% if a %}{% if b %}ab{% else %}a{% endif %}{% elif x %}x{% endif %}",
]

OUTSIDE = ["{% set x = 1 %}", "{{ f() }}", "{{ a|upper }}",
           "{% macro m() %}{% endmacro %}", "{{ a + 1 }}", "{% if a %}",
           "{{ a is odd }}", "{% raw %}x{% endraw %}",
           "{% for k, v in d %}{% endfor %}", "{% for x in xs if x %}{% endfor %}",
           "{% for x in xs %}{% else %}{% endfor %}", "{{ [1, 2] }}",
           "{% include 'x' %}", "{{ a", "{# open"]


def _values(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    words = ["hi", " there ", "<tag> & 'q'", "", "x", "multi\nline", "é日"]

    def w():
        return words[int(rng.integers(len(words)))]
    roles = ["user", "assistant", "system", "tool", ""]
    msgs = [{"role": roles[int(rng.integers(len(roles)))], "content": w()}
            for _ in range(int(rng.integers(1, 5)))]
    return dict(Role=roles[int(rng.integers(len(roles)))], Content=w(),
                Input=w(), SystemPrompt=w(), a=w(), b={"k": [1, "<x>"]},
                x=w(), msgs=msgs, Functions=[{"name": "f", "parameters":
                                              {"b": 1, "a": "'"}}])


def _render_both(src: str, values: dict):
    try:
        want = ENV.from_string(src).render(**values)
    except Exception as e:      # noqa: BLE001 - the error's type is compared
        want = type(e)
    try:
        got = Template(src).render(**values)
    except Exception as e:      # noqa: BLE001
        got = type(e)
    return got, want


@pytest.mark.parametrize("src", FAMILY_TEMPLATES + SUBSET_TEMPLATES)
def test_jinja_lite_equals_jinja2(src):
    for seed in range(12):
        got, want = _render_both(src, _values(seed))
        assert got == want, (src, seed)
    got, want = _render_both(src, {})
    assert got == want


@pytest.mark.parametrize("src", OUTSIDE)
def test_outside_the_subset_raises_when_compiled(src):
    with pytest.raises(TemplateError):
        Template(src)


def test_the_jax_template_tests_cases():
    assert (TT.render_chat_message(TT.DEFAULT_CHAT_MESSAGE,
                                   TT.ChatMessageData(role="user", content="hi"))
            == "user: hi")
    assert (TT.render_chat_prompt("PROMPT:\n{{ Input }}\nASSISTANT:", "user: hi")
            == "PROMPT:\nuser: hi\nASSISTANT:")
    assert TT.render_completion("Q: {{ Input }}\nA:", "what?") == "Q: what?\nA:"
    assert (TT.render_chat_message("{{ Role }}|{{ FunctionName }}|{{ Content }}",
                                   TT.ChatMessageData(content="x")) == "||x")
    assert (TT.multimodal_placeholders("", "describe this", n_images=2)
            == "[img-0][img-1]\ndescribe this")
    assert (TT.multimodal_placeholders("{{ Images }} TEXT: {{ Text }}", "hello",
                                       n_images=1) == "[img-0] TEXT: hello")
    for t in (TT, JT):
        assert t.render_edit("E: {{ Instruction }} / {{ input }}", "fix", "tpyo") \
            == "E: fix / tpyo"


def _configs():
    out = [("default", {})]
    for fam, (msg, chat, stop) in jguess.FAMILIES.items():
        out.append((fam, {"template": {"chat_message": msg, "chat": chat},
                          "stopwords": stop}))
    out.append(("joined", {"template": {"join_chat_messages_by_character": "",
                                        "chat": "{{ SystemPrompt }}|{{ Input }}"},
                           "system_prompt": "sys"}))
    return out


@pytest.mark.parametrize("name,data", _configs(), ids=[c[0] for c in _configs()])
def test_build_chat_prompt_equals_jax(name, data):
    rng = np.random.default_rng(len(name))
    roles = ["user", "assistant", "system", "tool"]
    for _ in range(20):
        msgs = []
        for _ in range(int(rng.integers(1, 6))):
            content = ["hello", "", "line\nbreak", "  sp ", "x" * 5][
                int(rng.integers(5))]
            if rng.random() < 0.2:
                content = [{"type": "text", "text": content},
                           {"type": "text", "text": "more"}]
            if rng.random() < 0.1:
                content = None
            msgs.append({"role": roles[int(rng.integers(4))],
                         "content": content})
        got = tflow.build_chat_prompt(tmc._build(data), msgs)
        want = jflow.build_chat_prompt(jmc._build(data), msgs)
        assert got == want


def test_media_parts_number_placeholders_without_fetching():
    msgs = [{"role": "user", "content": [
        {"type": "text", "text": "look"},
        {"type": "image_url", "image_url": {"url": "data:image/png;base64,Q0ND"}},
        {"type": "image_url", "image_url": {"url": "https://example.invalid/a.png"}}]}]
    prompt, images, audios, videos = tflow.build_chat_prompt(tmc.ModelConfig(), msgs)
    assert prompt == "user: [img-0][img-1]\nlook"
    assert images == ["Q0ND", "https://example.invalid/a.png"]
    assert audios == videos == []


def test_check_compiles_a_config_templates():
    mc = tmc.ModelConfig(name="m")
    mc.template.chat = "{{ Input }}"
    TT.check(mc)
    mc.template.edit = "{% set x = 1 %}"
    with pytest.raises(TemplateError):
        TT.check(mc)
