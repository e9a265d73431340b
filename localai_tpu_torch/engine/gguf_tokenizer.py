"""Tokenizer rebuilt from GGUF-embedded vocab metadata (a copy of
localai_tpu/engine/gguf_tokenizer.py; its BPE loop runs on
engine/bpe.py, the merge engine the tokenizer.json reader shares).

``GGUFTokenizer`` is built from a GGUF file's metadata dict (the
``tokenizer.ggml.*`` keys llama.cpp reads):

  * ``llama`` model: SentencePiece unigram — Viterbi segmentation over
    piece scores with byte-fallback (<0xXX>) for uncovered bytes.
  * ``gpt2`` model: byte-level BPE — UTF-8 bytes mapped through the GPT-2
    printable-byte table, then lowest-rank merges (engine/bpe.py: the
    lowest-ranked adjacent pair, leftmost among equals, as the JAX loop
    over all pairs picks it).

The surface mirrors the small subset of the HF tokenizer API the serving
stack uses (encode / decode / convert_ids_to_tokens / eos_token_id).
``from_gguf(path)`` builds it from a GGUF file's metadata, read by the
port's GGUF loader (engine/gguf.py), as the JAX runner does for a GGUF
model with no ``tokenizer`` dir.
"""

from __future__ import annotations

import functools
import re
from typing import Optional

from localai_tpu_torch.engine.bpe import BPE

# GPT-2's pre-tokenization split (contractions / words / numbers /
# punctuation runs / whitespace) — BPE merges never cross these
# boundaries, which also keeps the merge loop O(word), not O(text)
_BPE_SPLIT = re.compile(
    r"'s|'t|'re|'ve|'m|'ll|'d| ?[^\W\d_]+| ?\d+| ?[^\s\w]+|\s+(?!\S)|\s+")


def _gpt2_byte_table() -> dict[int, str]:
    """GPT-2's bijective byte -> printable-unicode map."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(0xA1, 0xAD)) + list(range(0xAE, 0x100)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


_BYTE_TO_CHAR = _gpt2_byte_table()
_CHAR_TO_BYTE = {c: b for b, c in _BYTE_TO_CHAR.items()}


class GGUFTokenizer:
    """Built from GGUFFile.metadata (tokenizer.ggml.*)."""

    # token type enum (llama.cpp llama_token_type)
    NORMAL, UNKNOWN, CONTROL, USER_DEFINED, UNUSED, BYTE = 1, 2, 3, 4, 5, 6

    def __init__(self, metadata: dict):
        md = metadata
        self.model = md.get("tokenizer.ggml.model", "llama")
        self.tokens: list[str] = md["tokenizer.ggml.tokens"]
        self.scores: list[float] = md.get("tokenizer.ggml.scores") or []
        self.token_types: list[int] = md.get("tokenizer.ggml.token_type") or []
        self.merges: list[str] = md.get("tokenizer.ggml.merges") or []
        self.bos_token_id: Optional[int] = md.get("tokenizer.ggml.bos_token_id")
        self.eos_token_id: Optional[int] = md.get("tokenizer.ggml.eos_token_id")
        self.unk_token_id: Optional[int] = md.get("tokenizer.ggml.unknown_token_id")
        self.add_bos = bool(md.get("tokenizer.ggml.add_bos_token",
                                   self.model == "llama"))
        self.vocab: dict[str, int] = {t: i for i, t in enumerate(self.tokens)}
        self.vocab_size = len(self.tokens)
        if self.model == "gpt2":
            self.bpe = BPE(tuple(m.split(" ", 1)) for m in self.merges)
        # byte-fallback ids for the llama model: "<0xNN>" pieces
        self.byte_ids: dict[int, int] = {}
        for i, t in enumerate(self.tokens):
            if len(t) == 6 and t.startswith("<0x") and t.endswith(">"):
                try:
                    self.byte_ids[int(t[3:5], 16)] = i
                except ValueError:
                    pass
        self._byte_id_set = set(self.byte_ids.values())
        self._specials = {
            i for i, tt in enumerate(self.token_types)
            if tt in (self.CONTROL, self.UNKNOWN)
        }

    # ---- encode ----

    def encode(self, text: str, add_special_tokens: bool = True) -> list[int]:
        if self.model == "gpt2":
            ids = self._encode_bpe(text)
        else:
            ids = self._encode_spm(text)
        if add_special_tokens and self.add_bos and self.bos_token_id is not None:
            ids = [self.bos_token_id] + ids
        return ids

    def _encode_spm(self, text: str) -> list[int]:
        """Unigram Viterbi over piece scores (SentencePiece semantics:
        spaces become ▁; leading space prepended)."""
        s = "▁" + text.replace(" ", "▁")
        n = len(s)
        NEG = -1e30
        best = [NEG] * (n + 1)
        back: list[Optional[tuple]] = [None] * (n + 1)
        best[0] = 0.0
        max_piece = 32
        for i in range(n):
            if best[i] <= NEG:
                continue
            for j in range(i + 1, min(i + max_piece, n) + 1):
                piece = s[i:j]
                tid = self.vocab.get(piece)
                if tid is not None and tid not in self._specials:
                    sc = self.scores[tid] if tid < len(self.scores) else 0.0
                    cand = best[i] + sc
                    if cand > best[j]:
                        best[j] = cand
                        back[j] = (i, tid)
            # byte fallback: always available, heavily penalized
            b = s[i].encode("utf-8")
            j = i + 1
            cand = best[i] + len(b) * -100.0
            if cand > best[j]:
                best[j] = cand
                back[j] = (i, ("bytes", b))
        ids: list[int] = []
        j = n
        segs = []
        while j > 0:
            i, tok = back[j]
            segs.append(tok)
            j = i
        for tok in reversed(segs):
            if isinstance(tok, tuple):
                for byte in tok[1]:
                    ids.append(self.byte_ids.get(byte, self.unk_token_id or 0))
            else:
                ids.append(tok)
        return ids

    def _encode_bpe(self, text: str) -> list[int]:
        out: list[int] = []
        for word in _BPE_SPLIT.findall(text):
            mapped = "".join(_BYTE_TO_CHAR[b] for b in word.encode("utf-8"))
            for p in self.bpe.word(mapped):
                tid = self.vocab.get(p)
                if tid is None:
                    out.extend(self.vocab.get(ch, self.unk_token_id or 0)
                               for ch in p)
                else:
                    out.append(tid)
        return out

    # ---- decode ----

    def _piece_bytes(self, tid: int) -> bytes:
        t = self.tokens[tid]
        if tid in self._byte_id_set and t.startswith("<0x"):
            return bytes([int(t[3:5], 16)])
        if self.model == "gpt2":
            return bytes(_CHAR_TO_BYTE.get(c, ord("?")) for c in t)
        return t.replace("▁", " ").encode("utf-8")

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        out = bytearray()
        for tid in ids:
            tid = int(tid)
            if tid < 0 or tid >= self.vocab_size:
                continue
            if skip_special_tokens and (tid in self._specials
                                        or tid in (self.bos_token_id,
                                                   self.eos_token_id)):
                continue
            out += self._piece_bytes(tid)
        text = out.decode("utf-8", errors="replace")
        # SentencePiece: the leading ▁-space is an artifact of encoding
        if self.model != "gpt2" and text.startswith(" "):
            text = text[1:]
        return text

    def convert_ids_to_tokens(self, ids) -> list[str]:
        return [self.tokens[int(i)] if 0 <= int(i) < self.vocab_size else ""
                for i in ids]

    def get_vocab_size(self) -> int:
        return self.vocab_size

    def __len__(self) -> int:
        return self.vocab_size


@functools.lru_cache(maxsize=8)
def from_gguf(path: str) -> GGUFTokenizer:
    """A GGUF file's tokenizer, from its ``tokenizer.ggml.*`` metadata."""
    from localai_tpu_torch.engine.gguf import open_gguf

    return GGUFTokenizer(open_gguf(path).metadata)
