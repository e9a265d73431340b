"""Pure-Python tokenizers (the card's machine has neither ``tokenizers``
nor ``transformers``).

``BPETokenizer`` reads a HuggingFace ``tokenizer.json`` whose BPE model
has merges, in the two families llama-style checkpoints ship, and gives
the ids and text of ``transformers.AutoTokenizer`` (the JAX runner's
tokenizer, localai_tpu/backend/runner.py:297-305) on them:

  * byte-level BPE (Llama-3, Qwen2, GPT-2): a ``ByteLevel`` pre-tokenizer,
    alone or after a ``Split`` regex (``Sequence``), and the ByteLevel
    decoder;
  * SentencePiece-style BPE (Llama-2, Mistral): ``byte_fallback``
    ``<0xNN>`` pieces, a ``Prepend("▁")`` / ``Replace(" ", "▁")``
    normalizer or a ``Metaspace`` pre-tokenizer, and the ``Replace`` /
    ``ByteFallback`` / ``Fuse`` / ``Strip`` (or ``Metaspace``) decoder.

Added tokens are split out of the text before anything else (so
``<|start_header_id|>`` in a rendered template is its one id), the
post-processor's ``TemplateProcessing`` adds what HF's ``encode`` adds by
default (Llama-3's BOS), and ``decode(ids, skip_special_tokens)`` skips
the added tokens marked special, then applies tokenizer_config.json's
``clean_up_tokenization_spaces``. The split regexes' ``\\p{L}`` /
``\\p{N}`` classes (Python's ``re`` has neither) are built from
``unicodedata`` and ``\\s`` is Unicode White_Space, as the Rust regex
engine reads them. Any part of a tokenizer.json outside these families
raises NotImplementedError naming it, when the file is loaded.

``ByteLevelTokenizer`` reads a byte-level BPE model WITHOUT merges (every
byte its own token, the form tests/tinymodel.py writes);
``ByteTokenizer`` is the plain byte map used for a model dir without a
tokenizer.json (random-weight benchmark dirs): token id = byte value.

All expose encode / decode(ids, skip_special_tokens) / eos_token_id,
the surface the engine and the detokenizer use, and get_vocab_size /
all_special_ids, which the grammar's token strings read
(functions/grammars/automaton.py::token_strings); ``BPETokenizer`` also
``get_vocab`` / ``convert_tokens_to_string``, the HF calls that
function makes on the JAX side.
"""

from __future__ import annotations

import functools
import json
import os
import re
import sys
import unicodedata
from typing import Optional

from localai_tpu_torch.engine.bpe import BPE


def bytes_to_unicode() -> dict:
    """GPT-2's reversible byte -> printable unicode char map."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


def _config_eos(model_dir: str) -> Optional[int]:
    path = os.path.join(model_dir, "config.json")
    if not os.path.isfile(path):
        return None
    with open(path) as f:
        eos = json.load(f).get("eos_token_id")
    if isinstance(eos, list):
        eos = eos[0] if eos else None
    return eos


class ByteLevelTokenizer:
    def __init__(self, path: str, eos_token: Optional[str] = None,
                 eos_token_id: Optional[int] = None, special_tokens=()):
        with open(path) as f:
            spec = json.load(f)
        model = spec.get("model") or {}
        if model.get("type") != "BPE":
            raise NotImplementedError(
                f"tokenizer model {model.get('type')!r}: only byte-level BPE")
        if model.get("merges"):
            raise NotImplementedError(
                "a vocabulary with merges is read by BPETokenizer")
        self.vocab = dict(model["vocab"])
        special = {}
        for t in spec.get("added_tokens") or []:
            self.vocab.setdefault(t["content"], t["id"])
            if t.get("special"):
                special[t["content"]] = t["id"]
        self.inv = {i: t for t, i in self.vocab.items()}
        pre = spec.get("pre_tokenizer") or {}
        self.add_prefix_space = bool(pre.get("add_prefix_space", False))
        self.b2u = bytes_to_unicode()
        self.u2b = {u: b for b, u in self.b2u.items()}
        self.eos_token_id = eos_token_id
        if eos_token is not None and eos_token in self.vocab:
            self.eos_token_id = self.vocab[eos_token]
            special.setdefault(eos_token, self.eos_token_id)
        for t in special_tokens:
            if t in self.vocab:
                special.setdefault(t, self.vocab[t])
        self.special_ids = set(special.values())

    def get_vocab_size(self) -> int:
        return max(self.inv) + 1

    @property
    def all_special_ids(self) -> list:
        return sorted(self.special_ids)

    def encode(self, text: str) -> list:
        if self.add_prefix_space and text and not text.startswith(" "):
            text = " " + text
        out = []
        for b in text.encode("utf-8"):
            tid = self.vocab.get(self.b2u[b])
            if tid is None:
                raise ValueError(f"byte {b} has no token in this vocabulary")
            out.append(tid)
        return out

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        data = bytearray()
        for i in ids:
            i = int(i)
            if skip_special_tokens and i in self.special_ids:
                continue
            tok = self.inv.get(i)
            if tok is None:
                continue
            if i in self.special_ids:
                data += tok.encode("utf-8")
                continue
            for ch in tok:
                b = self.u2b.get(ch)
                data += bytes([b]) if b is not None else ch.encode("utf-8")
        return data.decode("utf-8", errors="replace")


class ByteTokenizer:
    """Token id = byte value; ids >= 256 decode to nothing."""

    all_special_ids: tuple = ()

    def __init__(self, eos_token_id: Optional[int] = None):
        self.eos_token_id = eos_token_id

    def get_vocab_size(self) -> int:
        return 256

    def encode(self, text: str) -> list:
        return list(text.encode("utf-8"))

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        return bytes(int(i) for i in ids if 0 <= int(i) < 256).decode(
            "utf-8", errors="replace")


# ---- HF tokenizer.json with merges ----

# transformers' special-token attributes, in its order
SPECIAL_TOKEN_KEYS = ("bos_token", "eos_token", "unk_token", "sep_token",
                      "pad_token", "cls_token", "mask_token")

# Unicode White_Space, as the Rust regex engine's \s reads it (Python's \s
# also takes \x1c-\x1f)
_WS = r"\t\n\x0b\x0c\r \x85\xa0\u1680\u2000-\u200a\u2028\u2029\u202f\u205f\u3000"

# GPT-2's split, the ByteLevel pre-tokenizer's own regex
GPT2_SPLIT = (r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+"
              r"| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+")


def _cp(c: int) -> str:
    return f"\\U{c:08x}" if c > 0xFFFF else f"\\u{c:04x}"


@functools.lru_cache(maxsize=None)
def _category_ranges() -> dict:
    """General category (two letters) -> [(first, last)] code point runs."""
    runs: dict = {}
    cur, start = None, 0
    for c in range(sys.maxunicode + 2):
        cat = unicodedata.category(chr(c)) if c <= sys.maxunicode else None
        if cat != cur:
            if cur is not None:
                runs.setdefault(cur, []).append((start, c - 1))
            cur, start = cat, c
    return runs


@functools.lru_cache(maxsize=None)
def unicode_class(name: str) -> str:
    """The body of a regex class for ``\\p{name}`` (a major class such as
    L or N, or a two-letter category such as Nd)."""
    runs = _category_ranges()
    cats = [k for k in runs if k == name or (len(name) == 1 and k[0] == name)]
    if not cats:
        raise NotImplementedError(f"regex class \\p{{{name}}}")
    merged = sorted(r for k in cats for r in runs[k])
    out = []
    for a, b in merged:
        if out and out[-1][1] + 1 == a:
            out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return "".join(_cp(a) if a == b else f"{_cp(a)}-{_cp(b)}" for a, b in out)


def translate_regex(pattern: str) -> str:
    """A tokenizer.json regex (Oniguruma syntax) as a Python ``re`` pattern:
    ``\\p{X}`` / ``\\P{X}`` from unicodedata, ``\\s`` / ``\\S`` as Unicode
    White_Space. ``\\w``, ``\\b`` and a negated class inside a class have
    other meanings in the two engines and raise NotImplementedError."""
    out, i, in_class, n = [], 0, False, len(pattern)
    while i < n:
        c = pattern[i]
        if c == "\\" and i + 1 < n:
            e = pattern[i + 1]
            if e in "pP":
                if pattern[i + 2:i + 3] == "{":
                    j = pattern.index("}", i)
                    name, i = pattern[i + 3:j], j + 1
                else:
                    name, i = pattern[i + 2], i + 3
                body = unicode_class(name)
                if in_class and e == "P":
                    raise NotImplementedError(f"regex \\P{{{name}}} in a class")
                out.append(body if in_class else
                           f"[{'^' if e == 'P' else ''}{body}]")
                continue
            if e == "s":
                out.append(_WS if in_class else f"[{_WS}]")
            elif e == "S":
                if in_class:
                    raise NotImplementedError("regex \\S in a class")
                out.append(f"[^{_WS}]")
            elif e in "wWbB":
                raise NotImplementedError(f"regex \\{e}")
            else:
                out.append(pattern[i:i + 2])
            i += 2
            continue
        if c == "[":
            if in_class:
                raise NotImplementedError("regex: a class inside a class")
            in_class = True
            out.append(c)
            i += 1
            if pattern[i:i + 1] == "^":
                out.append("^")
                i += 1
            if pattern[i:i + 1] == "]":
                out.append("\\]")
                i += 1
            continue
        if c == "]" and in_class:
            in_class = False
        out.append(c)
        i += 1
    return "".join(out)


def _clean_up_tokenization(text: str) -> str:
    """transformers' ``clean_up_tokenization`` (tokenizer_config.json's
    ``clean_up_tokenization_spaces``)."""
    return (text.replace(" .", ".").replace(" ?", "?").replace(" !", "!")
            .replace(" ,", ",").replace(" ' ", "'").replace(" n't", "n't")
            .replace(" 'm", "'m").replace(" 's", "'s").replace(" 've", "'ve")
            .replace(" 're", "'re"))


def _unsupported(part: str, spec) -> NotImplementedError:
    kind = spec.get("type") if isinstance(spec, dict) else spec
    return NotImplementedError(
        f"tokenizer.json {part} {kind!r} is not supported (byte-level BPE or "
        f"SentencePiece-style BPE only): {json.dumps(spec)[:200]}")


def _pattern(spec: dict, part: str) -> re.Pattern:
    """A Replace / Split pattern: {"String": s} or {"Regex": r}."""
    if "String" in spec:
        return re.compile(re.escape(spec["String"]))
    if "Regex" in spec:
        return re.compile(translate_regex(spec["Regex"]))
    raise _unsupported(part, spec)


def _split_isolated(rx: re.Pattern, s: str) -> list:
    """HF's Split with behaviour Isolated: every match and every gap."""
    out, pos = [], 0
    for m in rx.finditer(s):
        if m.start() == m.end():
            continue
        if m.start() > pos:
            out.append(s[pos:m.start()])
        out.append(m.group())
        pos = m.end()
    if pos < len(s):
        out.append(s[pos:])
    return out


def _normalizer(spec):
    """tokenizer.json ``normalizer`` -> str -> str (None = identity)."""
    if spec is None:
        return None
    t = spec.get("type")
    if t == "Sequence":
        steps = [_normalizer(n) for n in spec["normalizers"]]
        steps = [f for f in steps if f is not None]

        def seq(s):
            for f in steps:
                s = f(s)
            return s
        return seq
    if t == "Prepend":
        pre = spec["prepend"]
        return lambda s: pre + s if s else s
    if t == "Replace":
        rx, content = _pattern(spec["pattern"], "normalizer"), spec["content"]
        return lambda s: rx.sub(lambda m: content, s)
    if t in ("NFC", "NFD", "NFKC", "NFKD"):
        return lambda s: unicodedata.normalize(t, s)
    raise _unsupported("normalizer", spec)


def _pre_tokenizer(spec, b2u: dict):
    """tokenizer.json ``pre_tokenizer`` -> (pieces, first) -> pieces, where
    ``first`` says the segment starts the text (Metaspace's "first")."""
    if spec is None:
        return lambda pieces, first: pieces
    t = spec.get("type")
    if t == "Sequence":
        steps = [_pre_tokenizer(p, b2u) for p in spec["pretokenizers"]]

        def seq(pieces, first):
            for f in steps:
                pieces = f(pieces, first)
            return pieces
        return seq
    if t == "ByteLevel":
        prefix = bool(spec.get("add_prefix_space", False))
        rx = (re.compile(translate_regex(GPT2_SPLIT))
              if spec.get("use_regex", True) else None)

        def byte_level(pieces, first):
            out = []
            for p in pieces:
                if prefix and not p.startswith(" "):
                    p = " " + p
                for w in (_split_isolated(rx, p) if rx is not None else [p]):
                    out.append("".join(b2u[b] for b in w.encode("utf-8")))
            return out
        return byte_level
    if t == "Split":
        if spec.get("behavior") != "Isolated" or spec.get("invert"):
            raise _unsupported("pre_tokenizer", spec)
        rx = _pattern(spec["pattern"], "pre_tokenizer")
        return lambda pieces, first: [w for p in pieces
                                      for w in _split_isolated(rx, p)]
    if t == "Metaspace":
        rep = spec.get("replacement", "▁")
        scheme = spec.get("prepend_scheme")
        if scheme is None:
            scheme = "always" if spec.get("add_prefix_space", True) else "never"
        split = bool(spec.get("split", True))
        if scheme not in ("always", "first", "never"):
            raise _unsupported("pre_tokenizer", spec)

        def metaspace(pieces, first):
            out = []
            for k, p in enumerate(pieces):
                p = p.replace(" ", rep)
                if not p.startswith(rep) and (
                        scheme == "always" or (scheme == "first" and first
                                               and k == 0)):
                    p = rep + p
                if split:
                    # HF's MergedWithNext: each replacement starts a piece
                    parts = [w for w in re.split(f"(?={re.escape(rep)})", p) if w]
                    out.extend(parts)
                else:
                    out.append(p)
            return out
        return metaspace
    raise _unsupported("pre_tokenizer", spec)


def _decoder(spec, u2b: dict):
    """tokenizer.json ``decoder`` -> list of token strings -> list of
    strings (HF's ``decode_chain``; the caller joins them)."""
    if spec is None:
        return lambda toks: [" ".join(toks)]
    t = spec.get("type")
    if t == "Sequence":
        steps = [_decoder(d, u2b) for d in spec["decoders"]]

        def seq(toks):
            for f in steps:
                toks = f(toks)
            return toks
        return seq
    if t == "ByteLevel":
        def byte_level(toks):
            data = bytearray()
            for tok in toks:
                bs = [u2b.get(ch) for ch in tok]
                # a token with a character outside the byte table is its
                # own UTF-8 (HF: per token, not per character)
                data += (tok.encode("utf-8") if None in bs else bytes(bs))
            return [data.decode("utf-8", errors="replace")]
        return byte_level
    if t == "Replace":
        rx, content = _pattern(spec["pattern"], "decoder"), spec["content"]
        return lambda toks: [rx.sub(lambda m: content, x) for x in toks]
    if t == "ByteFallback":
        def byte_fallback(toks):
            out, run = [], bytearray()

            def flush():
                if run:
                    try:
                        out.append(bytes(run).decode("utf-8"))
                    except UnicodeDecodeError:
                        out.extend("�" for _ in run)
                    run.clear()
            for x in toks:
                if len(x) == 6 and x.startswith("<0x") and x.endswith(">"):
                    try:
                        run.append(int(x[3:5], 16))
                        continue
                    except ValueError:
                        pass
                flush()
                out.append(x)
            flush()
            return out
        return byte_fallback
    if t == "Fuse":
        return lambda toks: ["".join(toks)]
    if t == "Strip":
        ch, start, stop = spec["content"], int(spec["start"]), int(spec["stop"])

        def strip(toks):
            out = []
            for x in toks:
                a = 0
                while a < start and a < len(x) and x[a] == ch:
                    a += 1
                b = 0
                while b < stop and b < len(x) - a and x[len(x) - 1 - b] == ch:
                    b += 1
                out.append(x[a:len(x) - b])
            return out
        return strip
    if t == "Metaspace":
        rep = spec.get("replacement", "▁")
        scheme = spec.get("prepend_scheme")
        if scheme is None:
            scheme = "always" if spec.get("add_prefix_space", True) else "never"

        def metaspace(toks):
            # HF drops every replacement of the FIRST token unless "never"
            return [x.replace(rep, "" if i == 0 and scheme != "never" else " ")
                    for i, x in enumerate(toks)]
        return metaspace
    raise _unsupported("decoder", spec)


def _post_processor(spec):
    """tokenizer.json ``post_processor`` -> ids -> ids (one sequence, the
    special tokens HF's ``encode`` adds by default)."""
    if spec is None:
        return lambda ids: ids
    t = spec.get("type")
    if t == "Sequence":
        steps = [_post_processor(p) for p in spec["processors"]]

        def seq(ids):
            for f in steps:
                ids = f(ids)
            return ids
        return seq
    if t == "ByteLevel":
        return lambda ids: ids          # offsets only
    if t == "TemplateProcessing":
        specials = spec.get("special_tokens") or {}
        parts = []
        for piece in spec["single"]:
            if "SpecialToken" in piece:
                parts.append(list(specials[piece["SpecialToken"]["id"]]["ids"]))
            elif "Sequence" in piece and piece["Sequence"]["id"] == "A":
                parts.append(None)
            else:
                raise _unsupported("post_processor", spec)
        return lambda ids: [i for p in parts
                            for i in (ids if p is None else p)]
    raise _unsupported("post_processor", spec)


class BPETokenizer:
    """A tokenizer.json whose BPE model has merges (module doc).
    ``named``: tokenizer_config.json's bos / eos / unk / pad tokens and
    ``additional_special_tokens`` (transformers' ``all_special_ids``);
    ``eos_token_id`` is used when it names no eos token."""

    def __init__(self, spec: dict, named: Optional[dict] = None,
                 additional_special: tuple = (),
                 eos_token_id: Optional[int] = None,
                 clean_up_tokenization_spaces: bool = False):
        model = spec.get("model") or {}
        if model.get("type") != "BPE":
            raise _unsupported("model", model.get("type"))
        for key in ("dropout", "continuing_subword_prefix", "end_of_word_suffix"):
            if model.get(key):
                raise NotImplementedError(
                    f"tokenizer.json model.{key} {model[key]!r} is not supported")
        self.vocab = dict(model["vocab"])
        merges = [tuple(m.split(" ", 1)) if isinstance(m, str) else tuple(m)
                  for m in model.get("merges") or []]
        for a, b in merges:
            if a not in self.vocab or b not in self.vocab or a + b not in self.vocab:
                raise ValueError(f"tokenizer.json merge {a!r} {b!r}: a token "
                                 f"is missing from the vocabulary")
        self.unk_token = model.get("unk_token")
        self.byte_fallback = bool(model.get("byte_fallback", False))
        self.fuse_unk = bool(model.get("fuse_unk", False))
        self.ignore_merges = bool(model.get("ignore_merges", False))
        self.bpe = BPE(merges, initial=self._initial)
        self.b2u = bytes_to_unicode()
        self.u2b = {u: b for b, u in self.b2u.items()}
        self._normalize = _normalizer(spec.get("normalizer"))
        self._pre = _pre_tokenizer(spec.get("pre_tokenizer"), self.b2u)
        self._decode_chain = _decoder(spec.get("decoder"), self.u2b)
        self._post = _post_processor(spec.get("post_processor"))
        if spec.get("truncation") or spec.get("padding"):
            raise NotImplementedError("tokenizer.json truncation / padding")
        self.added: dict = {}
        self.special_added: set = set()
        plain, normed = [], []
        for t in spec.get("added_tokens") or []:
            for opt in ("lstrip", "rstrip", "single_word"):
                if t.get(opt):
                    raise NotImplementedError(
                        f"tokenizer.json added token {t['content']!r}: "
                        f"{opt} is not supported")
            self.added[t["content"]] = t["id"]
            if t.get("special"):
                self.special_added.add(t["id"])
            (normed if t.get("normalized") and self._normalize else
             plain).append(t["content"])
        self._split_plain = self._splitter(plain)
        self._split_normed = self._splitter(normed)
        self.inv = {i: t for t, i in self.vocab.items()}
        self.inv.update({i: t for t, i in self.added.items()})
        named = dict(named or {})
        specials = [named[k] for k in SPECIAL_TOKEN_KEYS if named.get(k)]
        specials += list(additional_special)
        # transformers' all_special_ids: the named tokens in its attribute
        # order, then the additional ones, each once
        self.special_ids = list(dict.fromkeys(
            i for i in map(self.token_to_id, specials) if i is not None))
        self.clean_up = bool(clean_up_tokenization_spaces)
        self.eos_token_id = eos_token_id
        if named.get("eos_token") and self.token_to_id(named["eos_token"]) is not None:
            self.eos_token_id = self.token_to_id(named["eos_token"])
        self.bos_token_id = (self.token_to_id(named["bos_token"])
                             if named.get("bos_token") else None)

    @staticmethod
    def _splitter(tokens: list):
        if not tokens:
            return None
        # longest first: alternation is leftmost-first, so this is
        # leftmost-longest, as HF's Aho-Corasick matcher
        return re.compile("|".join(re.escape(t) for t in
                                   sorted(tokens, key=len, reverse=True)))

    def _initial(self, word: str) -> list:
        """A word's starting symbols: its characters, a character outside
        the vocabulary as its ``<0xNN>`` bytes (byte_fallback) or as the
        unknown token (fused when ``fuse_unk``), else dropped (HF)."""
        out, vocab, unk_last = [], self.vocab, False
        for ch in word:
            if ch in vocab:
                out.append(ch)
                unk_last = False
                continue
            if self.byte_fallback:
                pieces = [f"<0x{b:02X}>" for b in ch.encode("utf-8")]
                if all(p in vocab for p in pieces):
                    out.extend(pieces)
                    continue
            if self.unk_token is not None:
                if not (self.fuse_unk and unk_last):
                    out.append(self.unk_token)
                unk_last = True
        return out

    def token_to_id(self, token: str) -> Optional[int]:
        tid = self.added.get(token)
        return tid if tid is not None else self.vocab.get(token)

    def _model(self, word: str) -> list:
        if not word:
            return []
        if self.ignore_merges and word in self.vocab:
            return [self.vocab[word]]
        vocab = self.vocab
        return [vocab[s] for s in self.bpe.word(word)]

    def _segments(self, text: str) -> list:
        """(text, added id or None, starts the text) pieces: the added
        tokens that match the raw text, then, in each other piece once
        normalized, those that match normalized text (HF's order)."""
        out = []
        for seg, tid, first in self._split(self._split_plain, text, 0):
            if tid is not None:
                out.append((seg, tid, first))
                continue
            if self._normalize is not None:
                seg = self._normalize(seg)
            out.extend(self._split(self._split_normed, seg, 0 if first else 1))
        return out

    def _split(self, rx, text: str, base: int) -> list:
        if rx is None:
            return [(text, None, base == 0)] if text else []
        out, pos = [], 0
        for m in rx.finditer(text):
            if m.start() > pos:
                out.append((text[pos:m.start()], None, base + pos == 0))
            out.append((m.group(), self.added[m.group()], base + m.start() == 0))
            pos = m.end()
        if pos < len(text):
            out.append((text[pos:], None, base + pos == 0))
        return out

    def encode(self, text: str, add_special_tokens: bool = True) -> list:
        ids = []
        for seg, tid, first in self._segments(text):
            if tid is not None:
                ids.append(tid)
                continue
            for word in self._pre([seg], first):
                ids.extend(self._model(word))
        return self._post(ids) if add_special_tokens else ids

    def decode(self, ids, skip_special_tokens: bool = False) -> str:
        toks = []
        for i in ids:
            i = int(i)
            tok = self.inv.get(i)
            if tok is None or (skip_special_tokens and i in self.special_added):
                continue
            toks.append(tok)
        text = "".join(self._decode_chain(toks))
        return _clean_up_tokenization(text) if self.clean_up else text

    def convert_tokens_to_string(self, tokens: list) -> str:
        """The decoder alone over ``tokens`` (transformers' fast call)."""
        return "".join(self._decode_chain(list(tokens)))

    def get_vocab(self) -> dict:
        return {**self.vocab, **self.added}

    def get_vocab_size(self) -> int:
        return max(self.inv) + 1

    @property
    def all_special_ids(self) -> list:
        return list(self.special_ids)


def load_tokenizer(model_dir: str):
    """The tokenizer of a model dir: its tokenizer.json (with merges:
    ``BPETokenizer``; without: ``ByteLevelTokenizer``), or the byte map.
    tokenizer_config.json (and special_tokens_map.json, as transformers
    reads it) name the special tokens; config.json's eos_token_id stands
    when they name no eos."""
    eos_id = _config_eos(model_dir)
    tj = os.path.join(model_dir, "tokenizer.json")
    if not os.path.isfile(tj):
        return ByteTokenizer(eos_token_id=eos_id)
    named, conf = {}, {}
    for fn in ("tokenizer_config.json", "special_tokens_map.json"):
        path = os.path.join(model_dir, fn)
        # transformers reads the special tokens map only for a config
        # without added_tokens_decoder, and then it overrides the config
        if os.path.isfile(path) and "added_tokens_decoder" not in conf:
            with open(path) as f:
                conf.update(json.load(f))
    for key in SPECIAL_TOKEN_KEYS:
        tok = conf.get(key)
        if isinstance(tok, dict):
            tok = tok.get("content")
        if tok:
            named[key] = tok
    with open(tj) as f:
        spec = json.load(f)
    if (spec.get("model") or {}).get("merges"):
        extra = [t.get("content") if isinstance(t, dict) else t
                 for t in conf.get("additional_special_tokens") or []]
        return BPETokenizer(spec, named, tuple(extra), eos_token_id=eos_id,
                            clean_up_tokenization_spaces=bool(
                                conf.get("clean_up_tokenization_spaces", False)))
    return ByteLevelTokenizer(tj, eos_token=named.get("eos_token"),
                              eos_token_id=eos_id,
                              special_tokens=tuple(
                                  named[k] for k in ("bos_token", "eos_token",
                                                     "unk_token", "pad_token")
                                  if k in named))
