"""A Jinja subset renderer, because the card's machine has no ``jinja2``.

``Template(source).render(**values)`` gives what the JAX package's
environment gives (localai_tpu/templates/prompts.py:19-26:
``jinja2.Environment(trim_blocks=True, lstrip_blocks=True,
keep_trailing_newline=True, undefined=ChainableUndefined)``) on the
subset model configs' prompt templates are written in:

  * ``{{ expr }}``, ``{% if %} / {% elif %} / {% else %} / {% endif %}``,
    ``{% for x in xs %} ... {% endfor %}`` with ``loop.index`` /
    ``index0`` / ``revindex`` / ``revindex0`` / ``first`` / ``last`` /
    ``length``, ``{# comments #}``;
  * whitespace as that environment handles it: a block tag or comment
    alone on its line takes the line's indentation (lstrip_blocks) and
    the newline after it (trim_blocks), ``{%-`` / ``-%}`` / ``{{-`` /
    ``-}}`` strip all whitespace on their side, ``{%+`` keeps the
    indentation, and the template's last newline is kept;
  * expressions: names, ``a.b`` and ``a[k]`` (Jinja's getattr-then-item
    rule), string, number, ``true`` / ``false`` / ``none`` literals,
    parentheses, ``==``, ``!=``, ``<``, ``<=``, ``>``, ``>=``, ``in``,
    ``not in``, ``and`` / ``or`` / ``not`` (Python's operand results),
    the tests ``is defined`` / ``undefined`` / ``none`` / ``string``
    (and ``is not``), and the filters ``trim``, ``default`` (``d``) and
    ``tojson``;
  * undefined names render empty and chain (``ChainableUndefined``).

Anything else (``set``, macros, calls, arithmetic, other filters and
tests, ``raw``) raises ``TemplateError`` when the template is compiled,
which the model config's loading does, never at render time with other
text.
"""

from __future__ import annotations

import json
import re
from typing import Any, Optional


class TemplateError(ValueError):
    """A template outside the subset, or malformed."""


class Undefined:
    """Jinja's ChainableUndefined: renders empty, is false, iterates as
    empty, and gives itself for any attribute or item."""

    __slots__ = ()

    def __str__(self) -> str:
        return ""

    def __bool__(self) -> bool:
        return False

    def __iter__(self):
        return iter(())

    def __len__(self) -> int:
        return 0

    def __eq__(self, other) -> bool:
        return type(self) is type(other)

    def __ne__(self, other) -> bool:
        return not self.__eq__(other)

    def __hash__(self) -> int:
        return id(type(self))

    def __getattr__(self, name: str) -> "Undefined":
        if name.startswith("__"):
            raise AttributeError(name)
        return self

    def __getitem__(self, key) -> "Undefined":
        return self


UNDEFINED = Undefined()

# ---- lexer ----

_TOKEN = re.compile(r"""
    (?P<ws>\s+)
  | (?P<float>\d+\.\d+)
  | (?P<int>\d+)
  | (?P<name>[a-zA-Z_][a-zA-Z0-9_]*)
  | (?P<string>'(?:[^'\\]|\\.)*'|"(?:[^"\\]|\\.)*")
  | (?P<op>==|!=|<=|>=|[<>()\[\].,|:~+\-*/%=!{}])
""", re.X | re.S)
_STRING_ESCAPES = {"n": "\n", "t": "\t", "r": "\r", "\\": "\\", "'": "'",
                   '"': '"', "0": "\0"}


def _unquote(s: str) -> str:
    body, out, k = s[1:-1], [], 0
    while k < len(body):
        c = body[k]
        if c == "\\" and k + 1 < len(body):
            e = body[k + 1]
            if e not in _STRING_ESCAPES:
                raise TemplateError(f"string escape \\{e} is outside the subset")
            out.append(_STRING_ESCAPES[e])
            k += 2
        else:
            out.append(c)
            k += 1
    return "".join(out)


def _tag_tokens(src: str, pos: int, end: str) -> tuple:
    """The tokens of a tag body from ``pos`` to its end marker ``end``
    (``%}`` or ``}}``): (tokens, strip_after, keep_newline_rule, pos)."""
    toks, depth = [], 0
    while True:
        if pos >= len(src):
            raise TemplateError(f"missing {end!r}")
        if depth == 0:
            if src.startswith("-" + end, pos):
                return toks, "strip", pos + 1 + len(end)
            if src.startswith("+" + end, pos) and end == "%}":
                return toks, "keep", pos + 1 + len(end)
            if src.startswith(end, pos):
                return toks, "trim" if end == "%}" else "none", pos + len(end)
        m = _TOKEN.match(src, pos)
        if m is None:
            raise TemplateError(f"unexpected {src[pos]!r} in a tag")
        kind = m.lastgroup
        text = m.group()
        pos = m.end()
        if kind == "ws":
            continue
        if kind == "op":
            if text in "([{":
                depth += 1
            elif text in ")]}":
                depth -= 1
        toks.append((kind, text))


def _lex(source: str) -> list:
    """Data, variable and block pieces with the environment's whitespace
    handling applied: [("data", text) | ("var", tokens) | ("block",
    tokens)]."""
    src = re.sub(r"\r\n|\r", "\n", source)
    out, pos, line_starting = [], 0, True
    opener = re.compile(r"\{\{|\{%|\{#")
    while True:
        m = opener.search(src, pos)
        if m is None:
            if pos < len(src):
                out.append(["data", src[pos:]])
            return out
        text = src[pos:m.start()]
        kind = m.group()
        p = m.end()
        sign = src[p:p + 1] if src[p:p + 1] in ("-", "+") else ""
        p += len(sign)
        if sign == "-":
            text = text.rstrip()
        elif sign != "+" and kind != "{{":
            # lstrip_blocks: the line's indentation before a block tag or
            # a comment that starts its line
            l_pos = text.rfind("\n") + 1
            if (l_pos > 0 or line_starting) and re.fullmatch(
                    r"\s+", text[l_pos:]):
                text = text[:l_pos]
        if text:
            out.append(["data", text])
        if kind == "{#":
            e = re.compile(r"\+#\}|-#\}\s*|#\}\n?").search(src, p)
            if e is None:
                raise TemplateError("missing end of comment tag")
            # the minus of "-#}" belongs to the marker, not the comment
            pos = e.end()
            line_starting = src[pos - 1:pos] == "\n" if pos else True
            continue
        end = "}}" if kind == "{{" else "%}"
        toks, after, pos = _tag_tokens(src, p, end)
        if after == "strip":
            while pos < len(src) and src[pos].isspace():
                pos += 1
        elif after == "trim" and src[pos:pos + 1] == "\n":
            pos += 1
        line_starting = src[pos - 1:pos] == "\n"
        out.append(["var" if kind == "{{" else "block", toks])


# ---- parser: expressions ----

class _Expr:
    """A recursive-descent parser over one tag's tokens, building closures
    ``f(ctx) -> value``."""

    def __init__(self, toks: list):
        self.toks, self.k = toks, 0

    def peek(self, off: int = 0) -> tuple:
        k = self.k + off
        return self.toks[k] if k < len(self.toks) else ("end", "")

    def take(self, kind: str = None, text: str = None) -> tuple:
        t = self.peek()
        if (kind and t[0] != kind) or (text is not None and t[1] != text):
            raise TemplateError(f"expected {text or kind}, got {t[1]!r}")
        self.k += 1
        return t

    def at(self, kind: str, text: str = None) -> bool:
        t = self.peek()
        return t[0] == kind and (text is None or t[1] == text)

    def done(self):
        if self.k != len(self.toks):
            raise TemplateError(
                f"{self.peek()[1]!r} is outside the subset")

    def expr(self):
        left = self.and_()
        while self.at("name", "or"):
            self.k += 1
            right = self.and_()
            left = (lambda a, b: lambda c: a(c) or b(c))(left, right)
        return left

    def and_(self):
        left = self.not_()
        while self.at("name", "and"):
            self.k += 1
            right = self.not_()
            left = (lambda a, b: lambda c: a(c) and b(c))(left, right)
        return left

    def not_(self):
        if self.at("name", "not"):
            self.k += 1
            inner = self.not_()
            return lambda c: not inner(c)
        return self.compare()

    _CMP = {"==": lambda a, b: a == b, "!=": lambda a, b: a != b,
            "<": lambda a, b: a < b, "<=": lambda a, b: a <= b,
            ">": lambda a, b: a > b, ">=": lambda a, b: a >= b}

    def compare(self):
        left = self.unary()
        while True:
            t = self.peek()
            if t[0] == "op" and t[1] in self._CMP:
                self.k += 1
                op, right = self._CMP[t[1]], self.unary()
            elif t == ("name", "in"):
                self.k += 1
                right = self.unary()
                op = lambda a, b: a in b  # noqa: E731
            elif t == ("name", "not") and self.peek(1) == ("name", "in"):
                self.k += 2
                right = self.unary()
                op = lambda a, b: a not in b  # noqa: E731
            else:
                return left
            left = (lambda f, a, b: lambda c: f(a(c), b(c)))(op, left, right)

    def unary(self):
        node = self.postfix(self.primary())
        while True:
            if self.at("op", "|"):
                self.k += 1
                node = self.filter_(node)
            elif self.at("name", "is"):
                self.k += 1
                node = self.test(node)
            else:
                return node

    def primary(self):
        kind, text = self.take()
        if kind == "string":
            v = _unquote(text)
            while self.at("string"):       # adjacent literals concatenate
                v += _unquote(self.take()[1])
            return lambda c: v
        if kind == "int":
            v = int(text)
            return lambda c: v
        if kind == "float":
            v = float(text)
            return lambda c: v
        if kind == "name":
            if text in ("true", "True", "false", "False"):
                v = text in ("true", "True")
                return lambda c: v
            if text in ("none", "None"):
                return lambda c: None
            if text in ("and", "or", "not", "in", "is", "if", "else"):
                raise TemplateError(f"unexpected {text!r}")
            return lambda c: c.get(text, UNDEFINED)
        if (kind, text) == ("op", "("):
            inner = self.expr()
            self.take("op", ")")
            return inner
        raise TemplateError(f"{text!r} is outside the subset")

    def postfix(self, node):
        while True:
            if self.at("op", "."):
                self.k += 1
                name = self.take("name")[1]
                node = (lambda n, a: lambda c: getattr_(n(c), a))(node, name)
            elif self.at("op", "["):
                self.k += 1
                key = self.expr()
                self.take("op", "]")
                node = (lambda n, k: lambda c: getitem_(n(c), k(c)))(node, key)
            elif self.at("op", "("):
                raise TemplateError("calls are outside the subset")
            else:
                return node

    def args(self) -> tuple:
        """A filter's (positional, keyword) argument closures."""
        pos, kw = [], {}
        if not self.at("op", "("):
            return pos, kw
        self.k += 1
        while not self.at("op", ")"):
            if self.at("name") and self.peek(1) == ("op", "="):
                name = self.take()[1]
                self.k += 1
                kw[name] = self.expr()
            else:
                pos.append(self.expr())
            if not self.at("op", ")"):
                self.take("op", ",")
        self.k += 1
        return pos, kw

    def filter_(self, node):
        name = self.take("name")[1]
        pos, kw = self.args()
        if name == "trim":
            if kw or len(pos) > 1:
                raise TemplateError("trim takes one optional argument")
            return lambda c: _str(node(c)).strip(*(p(c) for p in pos))
        if name in ("default", "d"):
            if len(pos) > 2 or set(kw) - {"default_value", "boolean"}:
                raise TemplateError("default(value, boolean)")
            dflt = pos[0] if pos else kw.get("default_value",
                                             lambda c: "")
            boolean = (pos[1] if len(pos) > 1 else
                       kw.get("boolean", lambda c: False))

            def default(c):
                v = node(c)
                if isinstance(v, Undefined) or (boolean(c) and not v):
                    return dflt(c)
                return v
            return default
        if name == "tojson":
            if len(pos) > 1 or set(kw) - {"indent"}:
                raise TemplateError("tojson(indent)")
            indent = pos[0] if pos else kw.get("indent", lambda c: None)
            return lambda c: tojson(node(c), indent(c))
        raise TemplateError(f"filter {name!r} is outside the subset")

    _TESTS = {"defined": lambda v: not isinstance(v, Undefined),
              "undefined": lambda v: isinstance(v, Undefined),
              "none": lambda v: v is None,
              "string": lambda v: isinstance(v, str)}

    def test(self, node):
        negate = False
        if self.at("name", "not"):
            self.k += 1
            negate = True
        name = self.take("name")[1]
        fn = self._TESTS.get(name)
        if fn is None:
            raise TemplateError(f"test {name!r} is outside the subset")
        return lambda c: fn(node(c)) != negate


def getattr_(obj, name: str):
    """Jinja's ``obj.name``: the attribute, else the item, else undefined."""
    if isinstance(obj, Undefined):
        return obj
    try:
        return getattr(obj, name)
    except AttributeError:
        pass
    try:
        return obj[name]
    except (TypeError, LookupError, AttributeError):
        return UNDEFINED


def getitem_(obj, key):
    """Jinja's ``obj[key]``: the item, else (a str key) the attribute."""
    if isinstance(obj, Undefined):
        return obj
    try:
        return obj[key]
    except (AttributeError, TypeError, LookupError):
        if isinstance(key, str):
            try:
                return getattr(obj, key)
            except AttributeError:
                pass
        return UNDEFINED


def tojson(value, indent: Optional[int] = None) -> str:
    """Jinja's ``tojson``: sorted keys, HTML-sensitive characters escaped."""
    if isinstance(value, Undefined):
        raise TypeError("Object of type Undefined is not JSON serializable")
    return (json.dumps(value, indent=indent, sort_keys=True)
            .replace("<", "\\u003c").replace(">", "\\u003e")
            .replace("&", "\\u0026").replace("'", "\\u0027"))


def _str(v) -> str:
    return "" if isinstance(v, Undefined) else str(v)


# ---- parser: statements ----

def _parse(pieces: list, k: int, stop: tuple) -> tuple:
    """Nodes from pieces[k:] up to a block whose first word is in
    ``stop``; returns (nodes, k of that block, its word)."""
    nodes = []
    while k < len(pieces):
        kind, body = pieces[k]
        if kind == "data":
            nodes.append(("data", body))
            k += 1
            continue
        if kind == "var":
            e = _Expr(body)
            f = e.expr()
            e.done()
            nodes.append(("var", f))
            k += 1
            continue
        if not body or body[0][0] != "name":
            raise TemplateError("empty or malformed block tag")
        word = body[0][1]
        if word in stop:
            return nodes, k, word
        if word == "if":
            branches, k = [], k
            e = _Expr(body[1:])
            cond = e.expr()
            e.done()
            while True:
                inner, k, end = _parse(pieces, k + 1, ("elif", "else", "endif"))
                branches.append((cond, inner))
                tag = pieces[k][1]
                if end == "endif":
                    if len(tag) != 1:
                        raise TemplateError("endif takes nothing")
                    break
                if end == "else":
                    if len(tag) != 1:
                        raise TemplateError("else takes nothing")
                    cond = lambda c: True  # noqa: E731
                else:
                    e = _Expr(tag[1:])
                    cond = e.expr()
                    e.done()
            nodes.append(("if", branches))
            k += 1
            continue
        if word == "for":
            if (len(body) < 4 or body[1][0] != "name"
                    or body[2] != ("name", "in")):
                raise TemplateError("for NAME in EXPR is the subset's loop")
            e = _Expr(body[3:])
            seq = e.expr()
            e.done()
            inner, k, end = _parse(pieces, k + 1, ("endfor", "else"))
            if end != "endfor" or len(pieces[k][1]) != 1:
                raise TemplateError("for ... else is outside the subset")
            nodes.append(("for", body[1][1], seq, inner))
            k += 1
            continue
        raise TemplateError(f"{{% {word} %}} is outside the subset")
    if stop:
        raise TemplateError(f"missing {{% {stop[-1]} %}}")
    return nodes, k, None


class _Loop:
    def __init__(self, i: int, n: int):
        self.index0, self.index, self.length = i, i + 1, n
        self.revindex, self.revindex0 = n - i, n - i - 1
        self.first, self.last = i == 0, i == n - 1


def _run(nodes: list, ctx: dict, out: list):
    for node in nodes:
        kind = node[0]
        if kind == "data":
            out.append(node[1])
        elif kind == "var":
            out.append(_str(node[1](ctx)))
        elif kind == "if":
            for cond, inner in node[1]:
                if cond(ctx):
                    _run(inner, ctx, out)
                    break
        else:
            _, name, seq, inner = node
            items = list(seq(ctx))
            for i, item in enumerate(items):
                _run(inner, {**ctx, name: item, "loop": _Loop(i, len(items))},
                     out)


class Template:
    """A compiled template; compiling raises TemplateError outside the
    subset."""

    def __init__(self, source: str):
        self.nodes, _, _ = _parse(_lex(source), 0, ())

    def render(self, **values: Any) -> str:
        out: list = []
        _run(self.nodes, values, out)
        return "".join(out)
