"""GBNF grammar text -> compiled rule table (a copy of
localai_tpu/functions/grammars/gbnf.py).

Parses the llama.cpp GBNF dialect that our JSON-schema compiler emits
(and that users hand-write in model configs): rule definitions
``name ::= body`` with literals, char classes, groups, alternation and
postfix repetition operators.

Semantics parity target: llama.cpp's grammar-parser (driven by the
reference at backend/cpp/llama/grpc-server.cpp:688 where the grammar
string enters slot sampling params). The implementation is original:
postfix operators are expanded into auxiliary recursive rules, and the
compiled form is a tuple-of-tuples rule table consumed by
functions/grammars/automaton.py.

Compiled form:
  rules: list indexed by rule id; rules[r] = tuple of alternates;
  alternate = tuple of elements; element =
    ("c", ranges, negated)  -- char set; ranges = ((lo, hi), ...) codepoints
    ("r", rule_id)          -- rule reference
"""

from __future__ import annotations

import re
from typing import Optional

_RULE_DEF = re.compile(r"^([a-zA-Z][a-zA-Z0-9_-]*)\s*::=\s*(.*)$")

_ESCAPES = {"n": "\n", "t": "\t", "r": "\r", '"': '"', "\\": "\\",
            "[": "[", "]": "]", "/": "/", "b": "\b", "f": "\f",
            "'": "'", "-": "-", "^": "^"}


class GrammarError(ValueError):
    pass


def _strip_comments(text: str) -> str:
    out = []
    for line in text.splitlines():
        # '#' starts a comment unless inside a literal/class — a cheap scan
        res, in_str, in_cls, esc = [], False, False, False
        for ch in line:
            if esc:
                res.append(ch)
                esc = False
                continue
            if ch == "\\":
                res.append(ch)
                esc = True
                continue
            if ch == '"' and not in_cls:
                in_str = not in_str
            elif ch == "[" and not in_str:
                in_cls = True
            elif ch == "]" and not in_str:
                in_cls = False
            elif ch == "#" and not in_str and not in_cls:
                break
            res.append(ch)
        out.append("".join(res))
    return "\n".join(out)


def _join_rule_lines(text: str) -> list:
    """Group physical lines into one logical line per rule definition."""
    logical: list[str] = []
    for line in text.splitlines():
        if not line.strip():
            continue
        if _RULE_DEF.match(line.strip()):
            logical.append(line.strip())
        elif logical:
            logical[-1] += " " + line.strip()
        else:
            raise GrammarError(f"grammar text before first rule: {line!r}")
    return logical


class _Parser:
    """Recursive-descent parser for one rule body."""

    def __init__(self, body: str, rule_name: str, aux_rules: dict):
        self.s = body
        self.i = 0
        self.rule_name = rule_name
        self.aux_rules = aux_rules  # name -> list of alternates (shared)
        self.n_aux = 0

    # -- low-level --

    def _ws(self):
        while self.i < len(self.s) and self.s[self.i] in " \t\n":
            self.i += 1

    def _peek(self) -> str:
        return self.s[self.i] if self.i < len(self.s) else ""

    def _take(self) -> str:
        ch = self._peek()
        self.i += 1
        return ch

    def _escape(self) -> str:
        ch = self._take()
        if ch == "x":
            code = self.s[self.i:self.i + 2]
            self.i += 2
            return chr(int(code, 16))
        if ch == "u":
            code = self.s[self.i:self.i + 4]
            self.i += 4
            return chr(int(code, 16))
        if ch == "U":
            code = self.s[self.i:self.i + 8]
            self.i += 8
            return chr(int(code, 16))
        if ch in _ESCAPES:
            return _ESCAPES[ch]
        raise GrammarError(f"bad escape \\{ch} in rule {self.rule_name}")

    # -- aux rule helpers --

    def _new_aux(self, alternates: list) -> str:
        name = f"{self.rule_name}${self.n_aux}"
        self.n_aux += 1
        self.aux_rules[name] = alternates
        return name

    # -- grammar pieces --

    def parse_alternates(self, in_group: bool = False) -> list:
        alts = [self.parse_sequence(in_group)]
        self._ws()
        while self._peek() == "|":
            self._take()
            alts.append(self.parse_sequence(in_group))
            self._ws()
        return alts

    def parse_sequence(self, in_group: bool) -> list:
        elems: list = []
        sym_start = 0  # start index in elems of the last parsed symbol
        while True:
            self._ws()
            ch = self._peek()
            if not ch or ch == "|" or (in_group and ch == ")"):
                return elems
            sym_start = len(elems)
            if ch == '"':
                self._take()
                while self._peek() != '"':
                    if not self._peek():
                        raise GrammarError(f"unterminated literal in {self.rule_name}")
                    c = self._take()
                    if c == "\\":
                        c = self._escape()
                    elems.append(("c", ((ord(c), ord(c)),), False))
                self._take()
            elif ch == "[":
                elems.append(self._parse_class())
            elif ch == "(":
                self._take()
                inner = self.parse_alternates(in_group=True)
                self._ws()
                if self._take() != ")":
                    raise GrammarError(f"missing ')' in {self.rule_name}")
                name = self._new_aux(inner)
                elems.append(("ref", name))
            elif ch.isalnum() or ch == "_":
                name = self._parse_name()
                elems.append(("ref", name))
            else:
                raise GrammarError(
                    f"unexpected {ch!r} at {self.i} in rule {self.rule_name}")
            # postfix operators apply to the whole preceding symbol
            self._ws()
            op = self._peek()
            if op and op in "*+?":
                self._take()
                elems = self._apply_repeat(elems, sym_start, op)
            elif op == "{":
                self._take()
                spec = ""
                while self._peek() != "}":
                    if not self._peek():
                        raise GrammarError(f"unterminated {{...}} in {self.rule_name}")
                    spec += self._take()
                self._take()
                elems = self._apply_braces(elems, sym_start, spec)

    def _parse_name(self) -> str:
        start = self.i
        while True:
            ch = self._peek()
            if not ch or not (ch.isalnum() or ch in "_-$"):
                break
            self.i += 1
        return self.s[start:self.i]

    def _parse_class(self):
        self._take()  # '['
        negated = self._peek() == "^"
        if negated:
            self._take()
        ranges = []
        while self._peek() != "]":
            if not self._peek():
                raise GrammarError(f"unterminated char class in {self.rule_name}")
            c = self._take()
            if c == "\\":
                c = self._escape()
            lo = ord(c)
            hi = lo
            if self._peek() == "-" and self.s[self.i + 1:self.i + 2] != "]":
                self._take()
                c2 = self._take()
                if c2 == "\\":
                    c2 = self._escape()
                hi = ord(c2)
            ranges.append((lo, hi))
        self._take()
        return ("c", tuple(ranges), negated)

    def _apply_repeat(self, elems: list, sym_start: int, op: str) -> list:
        symbol = elems[sym_start:]
        name = f"{self.rule_name}${self.n_aux}"
        self.n_aux += 1
        ref = ("ref", name)
        if op == "*":
            self.aux_rules[name] = [symbol + [ref], []]
        elif op == "+":
            self.aux_rules[name] = [symbol + [ref], list(symbol)]
        else:  # '?'
            self.aux_rules[name] = [list(symbol), []]
        return elems[:sym_start] + [ref]

    def _apply_braces(self, elems: list, sym_start: int, spec: str) -> list:
        symbol = elems[sym_start:]
        parts = spec.split(",")
        try:
            m = int(parts[0]) if parts[0].strip() else 0
            if len(parts) == 1:
                n: Optional[int] = m
            else:
                n = int(parts[1]) if parts[1].strip() else None
        except ValueError:
            raise GrammarError(f"bad repetition {{{spec}}} in {self.rule_name}")
        out = elems[:sym_start]
        for _ in range(m):
            out += symbol
        if n is None:  # {m,} -> star tail
            out = self._apply_repeat(out + symbol, len(out), "*")
        else:
            for _ in range(n - m):
                out = self._apply_repeat(out + symbol, len(out), "?")
        return out


def parse_gbnf(text: str) -> tuple:
    """Parse GBNF text. Returns (rules, root_id); see module docstring."""
    named: dict[str, list] = {}
    aux: dict[str, list] = {}
    for logical in _join_rule_lines(_strip_comments(text)):
        m = _RULE_DEF.match(logical)
        if not m:
            raise GrammarError(f"not a rule definition: {logical!r}")
        name, body = m.group(1), m.group(2)
        p = _Parser(body, name, aux)
        alts = p.parse_alternates()
        p._ws()
        if p.i != len(p.s):
            raise GrammarError(f"trailing junk in rule {name}: {p.s[p.i:]!r}")
        if name in named:
            raise GrammarError(f"duplicate rule {name}")
        named[name] = alts
    named.update(aux)
    if "root" not in named:
        raise GrammarError("grammar has no 'root' rule")

    ids = {name: i for i, name in enumerate(named)}
    rules = []
    for name, alts in named.items():
        compiled_alts = []
        for alt in alts:
            compiled = []
            for elem in alt:
                if elem[0] == "ref":
                    target = elem[1]
                    if target not in ids:
                        raise GrammarError(f"undefined rule {target!r} (used in {name})")
                    compiled.append(("r", ids[target]))
                else:
                    compiled.append(elem)
            compiled_alts.append(tuple(compiled))
        rules.append(tuple(compiled_alts))
    return rules, ids["root"]
