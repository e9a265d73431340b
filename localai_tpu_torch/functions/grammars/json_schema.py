"""JSON-schema -> GBNF grammar for constrained decoding (a copy of
localai_tpu/functions/grammars/json_schema.py).

Parity with the reference's grammar compiler (reference: pkg/functions/
grammars/json_schema.go JSONSchemaConverter + bnf.go primitives), written
fresh: a recursive schema walker emitting llama.cpp-style GBNF. The engine
consumes this via the grammar automaton (functions/grammars/automaton.py)
to mask logits during sampling.
"""

from __future__ import annotations

import json
import re
from typing import Optional

SPACE_RULE = '" "?'

PRIMITIVES = {
    "boolean": '("true" | "false") space',
    "number": '("-"? ([0-9] | [1-9] [0-9]*)) ("." [0-9]+)? ([eE] [-+]? [0-9]+)? space',
    "integer": '("-"? ([0-9] | [1-9] [0-9]*)) space',
    "string": r'"\"" ( [^"\\] | "\\" (["\\/bfnrt] | "u" [0-9a-fA-F] [0-9a-fA-F] [0-9a-fA-F] [0-9a-fA-F]) )* "\"" space',
    "null": '"null" space',
}

_INVALID_RULE_CHARS = re.compile(r"[^a-zA-Z0-9-]+")


class JSONSchemaConverter:
    def __init__(self):
        self.rules: dict[str, str] = {"space": SPACE_RULE}

    def _add_rule(self, name: str, rule: str) -> str:
        esc = _INVALID_RULE_CHARS.sub("-", name) or "rule"
        key = esc
        i = 0
        while key in self.rules and self.rules[key] != rule:
            i += 1
            key = f"{esc}{i}"
        self.rules[key] = rule
        return key

    def _format_literal(self, literal) -> str:
        s = json.dumps(literal)
        escaped = s.replace("\\", "\\\\").replace('"', '\\"')
        return f'"{escaped}"'

    def visit(self, schema: dict, name: str = "root") -> str:
        stype = schema.get("type")
        if "oneOf" in schema or "anyOf" in schema:
            alts = schema.get("oneOf") or schema.get("anyOf")
            rule = " | ".join(self.visit(a, f"{name}-{i}") for i, a in enumerate(alts))
            return self._add_rule(name, rule)
        if "const" in schema:
            return self._add_rule(name, self._format_literal(schema["const"]) + " space")
        if "enum" in schema:
            rule = " | ".join(self._format_literal(v) for v in schema["enum"])
            return self._add_rule(name, f"({rule}) space")
        if stype == "object" or "properties" in schema:
            props = schema.get("properties", {})
            required = schema.get("required", list(props.keys()))
            req_pieces, opt_pieces = [], []
            for key, sub in props.items():
                sub_name = self.visit(sub, f"{name}-{key}")
                piece = f'{self._format_literal(key)} space ":" space {sub_name}'
                (req_pieces if key in required else opt_pieces).append(piece)
            body = ' "," space '.join(req_pieces)
            if opt_pieces:
                # any subset of optionals, in order, comma-separated: chain
                # of rest-rules so separators are always correct
                rest = None
                for i in range(len(opt_pieces) - 1, -1, -1):
                    rule = opt_pieces[i]
                    if rest is not None:
                        rule = f'{opt_pieces[i]} ("," space {rest})? | {rest}'
                    rest = self._add_rule(f"{name}-opt{i}", rule)
                if body:
                    body += f' ("," space {rest})?'
                else:
                    body = f"({rest})?"
            return self._add_rule(name, f'"{{" space {body} "}}" space'
                                  if body else '"{" space "}" space')
        if stype == "array" or "items" in schema:
            item = self.visit(schema.get("items", {}), f"{name}-item")
            rule = f'"[" space ({item} ("," space {item})*)? "]" space'
            return self._add_rule(name, rule)
        if stype in PRIMITIVES:
            return self._add_rule(stype, PRIMITIVES[stype])
        # untyped: any JSON value
        self._ensure_value_rule()
        return "value"

    def _ensure_value_rule(self):
        if "value" in self.rules:
            return
        self.rules["string"] = PRIMITIVES["string"]
        self.rules["number"] = PRIMITIVES["number"]
        self.rules["boolean"] = PRIMITIVES["boolean"]
        self.rules["null"] = PRIMITIVES["null"]
        self.rules["value"] = ("object | array | string | number | boolean | null")
        self.rules["object"] = (
            '"{" space (string ":" space value ("," space string ":" space value)*)? "}" space'
        )
        self.rules["array"] = '"[" space (value ("," space value)*)? "]" space'

    def format_grammar(self, root_rule: str = "root") -> str:
        lines = []
        if root_rule != "root":
            lines.append(f"root ::= {root_rule}")
        for name, rule in self.rules.items():
            lines.append(f"{name} ::= {rule}")
        return "\n".join(lines)


def schema_to_grammar(schema: dict) -> str:
    conv = JSONSchemaConverter()
    root = conv.visit(schema, "root")
    return conv.format_grammar(root)


def grammar_for_functions(functions: list,
                          force_name: Optional[str] = None,
                          parallel_calls: bool = False,
                          name_key: str = "name",
                          arguments_key: str = "arguments") -> str:
    """OpenAI tools -> grammar constraining output to function-call JSON
    (reference: functionsToJSONSchema + grammar options, parse.go:92-150).

    ``force_name`` narrows the grammar to one named tool (OpenAI
    tool_choice={"type":"function","function":{"name":...}} semantics).
    """
    if force_name:
        functions = [f for f in functions if f.get("name") == force_name]
    alts = []
    for fn in functions:
        alts.append({
            "type": "object",
            "properties": {
                name_key: {"const": fn["name"]},
                arguments_key: fn.get("parameters", {"type": "object"}),
            },
            "required": [name_key, arguments_key],
        })
    if not alts:
        return ""
    one_call: dict = {"oneOf": alts} if len(alts) > 1 else alts[0]
    schema = {
        "type": "array", "items": one_call, "minItems": 1,
    } if parallel_calls else one_call
    return schema_to_grammar(schema)
