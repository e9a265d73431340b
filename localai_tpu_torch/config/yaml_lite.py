"""A YAML subset reader, because the card's machine has no ``yaml``.

``safe_load(text)`` gives what ``yaml.safe_load`` gives on the subset that
model config files are written in:

  * block mappings and sequences (a sequence may sit at its key's
    indentation; ``- key: value`` opens a mapping inside an entry);
  * flow ``[...]`` and ``{...}``, nested, over several lines;
  * plain, single-quoted and double-quoted scalars on one line;
  * literal ``|`` and folded ``>`` block scalars with the ``-`` / ``+``
    chomping indicators (templates are written that way);
  * comments, and ``---`` / ``...`` document markers
    (``safe_load_all`` reads every document);
  * plain scalars typed by PyYAML's YAML 1.1 resolvers: ``yes`` / ``on``
    are True, ``0o17`` and ``1e3`` stay strings, ``017`` is octal, ``.5``
    and ``1_000.0`` are floats, ``1:30`` is 90, ``~`` and empty are null.

Anything outside the subset raises ``YAMLError`` with its line number:
anchors, aliases, tags, complex keys, directives, multi-line plain or
quoted scalars, timestamps, merge keys, and tabs anywhere but in a
quoted scalar, a block scalar's text or a comment. It never reads such
a document some other way.
"""

from __future__ import annotations

import re
from typing import Any, Optional

_BOOL = re.compile(r"""^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE
                    |on|On|ON|off|Off|OFF)$""", re.X)
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                    |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
                     (?:[Tt]|[ \t]+)[0-9][0-9]?
                     :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
                     (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""", re.X)
_TRUE = ("yes", "true", "on")

_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t",
            "n": "\n", "v": "\v", "f": "\f", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
            "_": "\xa0", "L": " ", "P": " "}
_HEX = {"x": 2, "u": 4, "U": 8}


class YAMLError(ValueError):
    """A document outside the subset, or malformed; ``line`` is 1-based."""

    def __init__(self, message: str, line: int):
        super().__init__(f"line {line}: {message}")
        self.line = line


def _sexagesimal(value: str, cast):
    out = 0
    for part in value.split(":"):
        out = out * 60 + cast(part)
    return out


def resolve(text: str, line: int = 0) -> Any:
    """A plain scalar typed as PyYAML's SafeLoader types it."""
    if _NULL.match(text):
        return None
    if _BOOL.match(text):
        return text.lower() in _TRUE
    if _FLOAT.match(text):
        v = text.replace("_", "").lower()
        sign = -1 if v[0] == "-" else 1
        v = v[1:] if v[0] in "+-" else v
        if v == ".inf":
            return sign * float("inf")
        if v == ".nan":
            return float("nan")
        return sign * (_sexagesimal(v, float) if ":" in v else float(v))
    if _INT.match(text):
        v = text.replace("_", "")
        sign = -1 if v[0] == "-" else 1
        v = v[1:] if v[0] in "+-" else v
        if v == "0":
            return 0
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if v[0] == "0":
            return sign * int(v, 8)
        return sign * (_sexagesimal(v, int) if ":" in v else int(v))
    if _TIMESTAMP.match(text):
        raise YAMLError(f"timestamp {text!r} is outside the subset", line)
    if text in ("<<", "="):
        raise YAMLError(f"{text!r} (merge / value key) is outside the subset",
                        line)
    return text


class _Parser:
    def __init__(self, text: str):
        text = text.replace("\r\n", "\n").replace("\r", "\n")
        if text.startswith("\ufeff"):
            text = text[1:]
        self.lines = text.split("\n")
        # whether line i ended with a line break (the last may not)
        self.broken = [True] * (len(self.lines) - 1) + [False]
        if self.lines and self.lines[-1] == "":
            self.lines.pop()
            self.broken.pop()
        self.i = 0

    # ---- lines ----

    def err(self, message: str, i: Optional[int] = None) -> YAMLError:
        return YAMLError(message, (self.i if i is None else i) + 1)

    def strip_comment(self, s: str, i: Optional[int] = None) -> str:
        """``s`` (line ``i``, default the current one) without its comment
        (a ``#`` at the start or after a space, outside quotes). A tab
        before the comment outside quotes raises: PyYAML takes a tab
        neither as a separator nor inside a plain scalar."""
        q, k = None, -1
        while k + 1 < len(s):
            k += 1
            c = s[k]
            if q:
                if c == q:
                    if q == "'" and s[k + 1:k + 2] == "'":
                        k += 1           # '' is a quote inside the scalar
                    else:
                        q = None
                elif c == "\\" and q == '"':
                    k += 1               # the escaped character
            elif c in "'\"" and (k == 0 or s[k - 1] in " \t[{,:"):
                q = c
            elif c == "#" and (k == 0 or s[k - 1] in " \t"):
                return s[:k].rstrip()
            elif c == "\t":
                raise self.err("a tab outside a quoted or block scalar is "
                               "outside the subset", i)
        return s.rstrip()

    def blank(self, i: int) -> bool:
        return self.strip_comment(self.lines[i], i).strip() == ""

    def skip_blank(self):
        while self.i < len(self.lines) and self.blank(self.i):
            self.i += 1

    def indent_of(self, i: int) -> int:
        s = self.lines[i]
        n = len(s) - len(s.lstrip(" "))
        if s[n:n + 1] == "\t":
            raise self.err("a tab in indentation is outside the subset", i)
        return n

    def marker(self, i: int) -> Optional[str]:
        s = self.lines[i]
        for m in ("---", "..."):
            if s == m or s.startswith(m + " ") or s.startswith(m + "\t"):
                return m
        return None

    # ---- documents ----

    def documents(self) -> list:
        docs, started = [], False
        while True:
            self.skip_blank()
            if self.i >= len(self.lines):
                if not started and not docs:
                    return []
                if started:
                    docs.append(None)
                return docs
            line = self.lines[self.i]
            if line.startswith("%"):
                raise self.err("directives are outside the subset")
            m = self.marker(self.i)
            if m == "---":
                if started:
                    docs.append(None)
                rest = self.strip_comment(line[3:]).strip()
                if rest:
                    raise self.err("content on the '---' line is outside "
                                   "the subset")
                started = True
                self.i += 1
                continue
            if m == "...":
                if started:
                    docs.append(None)
                started = False
                self.i += 1
                continue
            docs.append(self.node(0, -1))
            started = False
            self.skip_blank()
            if self.i < len(self.lines):
                m = self.marker(self.i)
                if m is None:
                    raise self.err("unexpected content after the document")
                if m == "...":
                    self.i += 1

    # ---- block nodes ----

    def node(self, min_indent: int, parent: int) -> Any:
        """The block node at the next non-blank line if it is indented at
        least ``min_indent``, else null; ``parent`` is the enclosing
        collection's indentation (block scalars' floor)."""
        self.skip_blank()
        if self.i >= len(self.lines) or self.marker(self.i):
            return None
        ind = self.indent_of(self.i)
        if ind < min_indent:
            return None
        body = self.strip_comment(self.lines[self.i])[ind:]
        if body == "-" or body.startswith("- "):
            return self.sequence(ind)
        if self.key_split(body) is not None:
            return self.mapping(ind)
        value = self.inline_value(body, ind, parent)
        self.after_scalar(ind)
        return value

    def after_scalar(self, ind: int):
        """A scalar line may not be followed by a more indented line
        (a multi-line plain scalar)."""
        self.skip_blank()
        if (self.i < len(self.lines) and not self.marker(self.i)
                and self.indent_of(self.i) > ind):
            raise self.err("a multi-line plain scalar or unexpected "
                           "indentation is outside the subset")

    def key_split(self, body: str) -> Optional[tuple]:
        """(key text, value text) when ``body`` is a ``key: value`` line."""
        if body[:1] in "[{":
            return None
        k, q = 0, None
        if body[:1] in "'\"":
            end = self.quoted_end(body, 0)
            if end is None:
                return None
            k = end
        while k < len(body):
            c = body[k]
            if c == ":" and (k + 1 == len(body) or body[k + 1] in " \t"):
                return body[:k].rstrip(), body[k + 1:].strip()
            k += 1
        return None

    @staticmethod
    def quoted_end(s: str, start: int) -> Optional[int]:
        q, k = s[start], start + 1
        while k < len(s):
            if s[k] == "\\" and q == '"':
                k += 2
                continue
            if s[k] == q:
                if q == "'" and s[k + 1:k + 2] == "'":
                    k += 2
                    continue
                return k + 1
            k += 1
        return None

    def mapping(self, ind: int) -> dict:
        out = {}
        while True:
            self.skip_blank()
            if self.i >= len(self.lines) or self.marker(self.i):
                return out
            cur = self.indent_of(self.i)
            if cur < ind:
                return out
            if cur > ind:
                raise self.err("unexpected indentation")
            body = self.strip_comment(self.lines[self.i])[ind:]
            if body.startswith("? ") or body == "?":
                raise self.err("complex keys are outside the subset")
            split = self.key_split(body)
            if split is None:
                raise self.err("expected 'key: value' in a mapping")
            ktext, vtext = split
            key = self.scalar(ktext, self.i)
            if isinstance(key, (dict, list)):
                raise self.err("a collection as a key is outside the subset")
            if ktext == "<<":
                raise self.err("merge keys are outside the subset")
            if vtext == "":
                self.i += 1
                self.skip_blank()
                if (self.i < len(self.lines) and not self.marker(self.i)
                        and self.indent_of(self.i) == ind):
                    b = self.strip_comment(self.lines[self.i])[ind:]
                    value = (self.sequence(ind)
                             if b == "-" or b.startswith("- ") else None)
                else:
                    value = self.node(ind + 1, ind)
            else:
                value = self.inline_value(vtext, ind, ind)
                self.after_scalar(ind)
            out[key] = value

    def sequence(self, ind: int) -> list:
        out = []
        while True:
            self.skip_blank()
            if self.i >= len(self.lines) or self.marker(self.i):
                return out
            cur = self.indent_of(self.i)
            if cur < ind:
                return out
            if cur > ind:
                raise self.err("unexpected indentation")
            line = self.lines[self.i]
            body = self.strip_comment(line)[ind:]
            if not (body == "-" or body.startswith("- ")):
                return out
            if body == "-":
                self.i += 1
                out.append(self.node(ind + 1, ind))
                continue
            rest = body[1:].lstrip(" ")
            col = ind + len(body) - len(rest)
            if rest[:1] in "|>":
                out.append(self.inline_value(rest, col, ind))
                self.after_scalar(ind)
                continue
            # the entry's content, as if it stood on its own line at col
            self.lines[self.i] = " " * col + line[col:]
            out.append(self.node(col, ind))

    # ---- values ----

    def inline_value(self, text: str, ind: int, parent: int) -> Any:
        """The value that starts on line ``self.i`` as ``text`` (comment
        stripped); moves past every line it takes."""
        c = text[:1]
        if c in "&*!":
            raise self.err(f"anchors, aliases and tags ({c}) are outside "
                           f"the subset")
        if c in "@`%" or (c in "?:" and text[1:2] in ("", " ", "\t")):
            raise self.err(f"a plain scalar may not start with {c!r}")
        if c in "|>":
            return self.block_scalar(text, parent)
        if c in "[{":
            return self.flow(text)
        if c == "-" and (text == "-" or text[1:2] == " "):
            raise self.err("a sequence entry is not allowed here")
        if c in "'\"":
            end = self.quoted_end(text, 0)
            if end is None:
                raise self.err("a multi-line quoted scalar is outside the "
                               "subset")
            if text[end:].strip():
                raise self.err("unexpected text after a quoted scalar")
            self.i += 1
            return self.quoted(text[:end], self.i - 1)
        if self.key_split(text) is not None:
            raise self.err("a mapping value is not allowed here")
        self.i += 1
        return self.scalar(text, self.i - 1)

    def scalar(self, text: str, i: int) -> Any:
        if text[:1] in "'\"":
            end = self.quoted_end(text, 0)
            if end is None or text[end:].strip():
                raise self.err("malformed quoted scalar", i)
            return self.quoted(text[:end], i)
        if text[:1] in "&*!":
            raise self.err("anchors, aliases and tags are outside the subset",
                           i)
        return resolve(text, i + 1)

    def quoted(self, text: str, i: int) -> str:
        body = text[1:-1]
        if text[0] == "'":
            return body.replace("''", "'")
        out, k = [], 0
        while k < len(body):
            c = body[k]
            if c != "\\":
                out.append(c)
                k += 1
                continue
            e = body[k + 1:k + 2]
            if e in _ESCAPES:
                out.append(_ESCAPES[e])
                k += 2
            elif e in _HEX:
                n = _HEX[e]
                digits = body[k + 2:k + 2 + n]
                if len(digits) != n or not all(
                        d in "0123456789abcdefABCDEF" for d in digits):
                    raise self.err(f"bad escape \\{e}{digits}", i)
                out.append(chr(int(digits, 16)))
                k += 2 + n
            else:
                raise self.err(f"unknown escape \\{e}", i)
        return "".join(out)

    def block_scalar(self, header: str, parent: int) -> str:
        m = re.fullmatch(r"([|>])([-+]?)", header.strip())
        if m is None:
            raise self.err(f"block scalar header {header!r} is outside the "
                           f"subset (| or > with - or +)")
        folded, chomp = m.group(1) == ">", m.group(2)
        self.i += 1
        lines, n = self.lines, len(self.lines)
        # leading blank lines and the first content line set the indent
        # (PyYAML's scan_block_scalar_indentation)
        j, breaks, max_indent = self.i, [], 0
        while j < n and lines[j].strip(" ") == "":
            max_indent = max(max_indent, len(lines[j]))
            if self.broken[j]:
                breaks.append("\n")
            j += 1
        if j < n:
            max_indent = max(max_indent,
                             len(lines[j]) - len(lines[j].lstrip(" ")))
        indent = max(parent + 1, 1, max_indent)
        chunks, line_break = [], ""

        def is_content(k):
            # at least ``indent`` spaces, then more (PyYAML: a line of
            # spaces longer than the indent is content too)
            return (k < n and len(lines[k]) > indent
                    and lines[k][:indent] == " " * indent)

        while is_content(j):
            chunks.extend(breaks)
            s = lines[j][indent:]
            leading_non_space = s[:1] not in (" ", "\t")
            chunks.append(s)
            line_break = "\n" if self.broken[j] else ""
            j += 1
            breaks = []
            while j < n and lines[j].strip(" ") == "" and len(lines[j]) <= indent:
                if self.broken[j]:
                    breaks.append("\n")
                j += 1
            if is_content(j):
                nxt = lines[j][indent:indent + 1]
                if (folded and line_break == "\n" and leading_non_space
                        and nxt not in (" ", "\t")):
                    if not breaks:
                        chunks.append(" ")
                else:
                    chunks.append(line_break)
            else:
                break
        if chomp != "-":
            chunks.append(line_break)
        if chomp == "+":
            chunks.extend(breaks)
        self.i = j
        return "".join(chunks)

    def flow(self, text: str) -> Any:
        """A flow collection starting on line ``self.i``; may run over the
        following lines until its brackets close."""
        start = self.i
        buf = text
        while True:
            try:
                value, end = _Flow(buf, start + 1).parse()
            except _Incomplete:
                self.i += 1
                if self.i >= len(self.lines):
                    raise self.err("unclosed flow collection", start)
                buf += " " + self.strip_comment(self.lines[self.i]).strip()
                continue
            if buf[end:].strip():
                raise self.err("unexpected text after a flow collection")
            self.i += 1
            return value


class _Incomplete(Exception):
    pass


class _Flow:
    """A flow collection in one string (lines joined)."""

    def __init__(self, s: str, line: int):
        self.s, self.k, self.line = s, 0, line

    def err(self, message: str) -> YAMLError:
        return YAMLError(message, self.line)

    def ws(self):
        while self.k < len(self.s) and self.s[self.k] in " \t":
            self.k += 1

    def parse(self) -> tuple:
        v = self.value()
        return v, self.k

    def value(self) -> Any:
        self.ws()
        if self.k >= len(self.s):
            raise _Incomplete
        c = self.s[self.k]
        if c == "[":
            return self.seq()
        if c == "{":
            return self.map()
        if c in "'\"":
            end = _Parser.quoted_end(self.s, self.k)
            if end is None:
                raise _Incomplete
            text = self.s[self.k:end]
            self.k = end
            p = _Parser("")
            return p.quoted(text, self.line - 1)
        if c in "&*!|>@`%":
            raise self.err(f"{c!r} in a flow collection is outside the subset")
        k = self.k
        while k < len(self.s):
            ch = self.s[k]
            if ch in ",[]{}":
                break
            if ch == ":" and (k + 1 == len(self.s) or self.s[k + 1] in " \t,[]{}"):
                break
            if ch == "#" and k > 0 and self.s[k - 1] in " \t":
                raise self.err("a comment inside a flow collection line")
            k += 1
        text = self.s[self.k:k].strip()
        self.k = k
        return resolve(text, self.line)

    def seq(self) -> list:
        self.k += 1
        out = []
        while True:
            self.ws()
            if self.k >= len(self.s):
                raise _Incomplete
            if self.s[self.k] == "]":
                self.k += 1
                return out
            item = self.value()
            self.ws()
            if self.k < len(self.s) and self.s[self.k] == ":":
                raise self.err("a mapping inside a flow sequence is outside "
                               "the subset")
            out.append(item)
            self.ws()
            if self.k >= len(self.s):
                raise _Incomplete
            if self.s[self.k] == ",":
                self.k += 1
            elif self.s[self.k] != "]":
                raise self.err("expected ',' or ']' in a flow sequence")

    def map(self) -> dict:
        self.k += 1
        out = {}
        while True:
            self.ws()
            if self.k >= len(self.s):
                raise _Incomplete
            if self.s[self.k] == "}":
                self.k += 1
                return out
            if self.s[self.k] in "[{":
                raise self.err("a collection as a key is outside the subset")
            key = self.value()
            self.ws()
            if self.k >= len(self.s):
                raise _Incomplete
            value = None
            if self.s[self.k] == ":":
                self.k += 1
                self.ws()
                if self.k >= len(self.s):
                    raise _Incomplete
                if self.s[self.k] not in ",}":
                    value = self.value()
            out[key] = value
            self.ws()
            if self.k >= len(self.s):
                raise _Incomplete
            if self.s[self.k] == ",":
                self.k += 1
            elif self.s[self.k] != "}":
                raise self.err("expected ',' or '}' in a flow mapping")


def safe_load_all(text: str) -> list:
    """Every document of ``text``."""
    if hasattr(text, "read"):
        text = text.read()
    return _Parser(text).documents()


def safe_load(text: str) -> Any:
    """The one document of ``text`` (None when empty), as
    ``yaml.safe_load``; more than one document raises."""
    docs = safe_load_all(text)
    if len(docs) > 1:
        raise YAMLError("expected a single document, found more", 1)
    return docs[0] if docs else None
