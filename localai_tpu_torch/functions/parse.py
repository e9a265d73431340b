"""Parse function/tool calls out of model output (a copy of
localai_tpu/functions/parse.py, with its own ``FunctionsConfig``: the
port has no model configs yet, so every request takes the defaults).

Parity with the reference's response parsing (reference: pkg/functions/
parse.go ParseFunctionCall :150+ — JSON regex match, response regex with
named groups, replace rules, multiple-call arrays, llama3.1 <function=...>
style via grammars/llama31_schema.go).
"""

from __future__ import annotations

import dataclasses
import json
import re
from typing import Optional


@dataclasses.dataclass
class FunctionsConfig:
    """Tool-calling behavior (a copy of the JAX package's
    config/model_config.py::FunctionsConfig, its fields and defaults)."""
    disable_no_action: bool = False
    no_action_function_name: str = "answer"
    no_action_description_name: str = ""
    function_name_key: str = "name"
    function_arguments_key: str = "arguments"
    response_regex: list = dataclasses.field(default_factory=list)
    json_regex_match: list = dataclasses.field(default_factory=list)
    replace_function_results: list = dataclasses.field(default_factory=list)
    replace_llm_results: list = dataclasses.field(default_factory=list)
    capture_llm_results: list = dataclasses.field(default_factory=list)
    grammar: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class FuncCall:
    name: str
    arguments: str  # JSON string (OpenAI wire format)


_LLAMA31 = re.compile(r"<function=(\w+)>(.*?)</function>", re.DOTALL)


def _try_json(text: str) -> Optional[object]:
    text = text.strip()
    # strip common markdown fences
    if text.startswith("```"):
        text = re.sub(r"^```[a-zA-Z]*\n?", "", text)
        text = re.sub(r"\n?```$", "", text)
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        return None


def _find_json_objects(text: str) -> list:
    """Scan for balanced top-level {...} or [...] spans."""
    out = []
    depth = 0
    start = None
    in_str = False
    esc = False
    for i, ch in enumerate(text):
        if esc:
            esc = False
            continue
        if ch == "\\" and in_str:
            esc = True
            continue
        if ch == '"':
            in_str = not in_str
            continue
        if in_str:
            continue
        if ch in "{[":
            if depth == 0:
                start = i
            depth += 1
        elif ch in "}]":
            depth -= 1
            if depth == 0 and start is not None:
                obj = _try_json(text[start : i + 1])
                if obj is not None:
                    out.append(obj)
                start = None
            depth = max(depth, 0)
    return out


def _to_calls(obj, cfg: FunctionsConfig) -> list:
    name_key = cfg.function_name_key or "name"
    args_key = cfg.function_arguments_key or "arguments"
    items = obj if isinstance(obj, list) else [obj]
    calls = []
    for it in items:
        if not isinstance(it, dict) or name_key not in it:
            continue
        args = it.get(args_key, {})
        if not isinstance(args, str):
            args = json.dumps(args)
        calls.append(FuncCall(name=str(it[name_key]), arguments=args))
    return calls


def parse_function_calls(text: str, cfg: Optional[FunctionsConfig] = None) -> list:
    cfg = cfg or FunctionsConfig()

    for pattern, repl in _pairs(cfg.replace_llm_results):
        text = re.sub(pattern, repl, text)

    # llama3.1-style <function=name>{args}</function>
    m31 = _LLAMA31.findall(text)
    if m31:
        return [FuncCall(name=n, arguments=a.strip() or "{}") for n, a in m31]

    # response_regex with named groups (reference: parse.go responseRegex)
    for pattern in cfg.response_regex:
        m = re.search(pattern, text, re.DOTALL)
        if m:
            groups = m.groupdict()
            if "name" in groups:
                args = groups.get("arguments", "{}")
                return [FuncCall(name=groups["name"], arguments=args)]

    # json_regex_match: extract the JSON payload first
    candidates = []
    for pattern in cfg.json_regex_match:
        m = re.search(pattern, text, re.DOTALL)
        if m:
            candidates.append(m.group(1) if m.groups() else m.group(0))
    if not candidates:
        candidates = [text]

    for cand in candidates:
        obj = _try_json(cand)
        if obj is None:
            objs = _find_json_objects(cand)
        else:
            objs = [obj]
        for o in objs:
            calls = _to_calls(o, cfg)
            if calls:
                for c in calls:
                    for pattern, repl in _pairs(cfg.replace_function_results):
                        c.arguments = re.sub(pattern, repl, c.arguments)
                if cfg.disable_no_action:
                    calls = [c for c in calls if c.name != cfg.no_action_function_name]
                return calls
    return []


def _pairs(rules: list) -> list:
    out = []
    for r in rules:
        if isinstance(r, dict):
            out.append((r.get("key", r.get("pattern", "")), r.get("value", r.get("replace", ""))))
        elif isinstance(r, (list, tuple)) and len(r) == 2:
            out.append((r[0], r[1]))
    return out


def text_content(text: str, cfg: Optional[FunctionsConfig] = None) -> str:
    """Non-call text when using mixed text+JSON mode (reference:
    ParseTextFromResults + capture_llm_results)."""
    cfg = cfg or FunctionsConfig()
    for pattern in cfg.capture_llm_results:
        m = re.search(pattern, text, re.DOTALL)
        if m:
            return m.group(1) if m.groups() else m.group(0)
    return text
