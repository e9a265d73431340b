"""Pure-Python tokenizers for this slice.

``ByteLevelTokenizer`` reads a HuggingFace ``tokenizer.json`` holding a
byte-level BPE model WITHOUT merges — every byte is its own token, mapped
through GPT-2's bytes-to-unicode table (the form tests/tinymodel.py
writes). A model with merges raises NotImplementedError: real BPE
vocabularies come with a later slice. ``ByteTokenizer`` is the plain byte
map used for a model dir without a tokenizer.json (random-weight
benchmark dirs): token id = byte value.

Both expose encode / decode(ids, skip_special_tokens) / eos_token_id,
the surface the engine and the detokenizer use, and get_vocab_size /
all_special_ids, which the grammar's token strings read
(functions/grammars/automaton.py::token_strings).
"""

from __future__ import annotations

import json
import os
from typing import Optional


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
                "BPE merges are not supported yet (byte-level vocabularies "
                "without merges only)")
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


def load_tokenizer(model_dir: str):
    """The tokenizer of a model dir: its tokenizer.json, or the byte map."""
    eos_id = _config_eos(model_dir)
    tj = os.path.join(model_dir, "tokenizer.json")
    if not os.path.isfile(tj):
        return ByteTokenizer(eos_token_id=eos_id)
    named = {}
    tc = os.path.join(model_dir, "tokenizer_config.json")
    if os.path.isfile(tc):
        with open(tc) as f:
            conf = json.load(f)
        for key in ("bos_token", "eos_token", "unk_token", "pad_token"):
            tok = conf.get(key)
            if isinstance(tok, dict):
                tok = tok.get("content")
            if tok:
                named[key] = tok
    return ByteLevelTokenizer(tj, eos_token=named.get("eos_token"),
                              eos_token_id=eos_id,
                              special_tokens=tuple(named.values()))
