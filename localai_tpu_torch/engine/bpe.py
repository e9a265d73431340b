"""Ranked pair merges within one pre-tokenized word: the BPE step that
the HF ``tokenizer.json`` reader (engine/tokenizer.py) and the GGUF
metadata tokenizer (engine/gguf_tokenizer.py) share.

A word starts as a list of symbols (its characters, or what the caller's
``initial`` makes of them: byte-fallback pieces, an unknown token) and
the lowest-ranked adjacent pair is merged, the leftmost one among equal
ranks, until no adjacent pair has a rank. That is the order of HF
tokenizers' ``Word::merge_all`` (a heap of (rank, position)) and of the
JAX GGUF tokenizer's loop over all pairs. The heap keeps a long word (a
SentencePiece-style vocabulary has no pre-tokenizer: the whole text is
one word) at O(n log n) instead of the loop's O(n^2).

Results are cached per word, as HF's BPE caches them: a chat's words
repeat (spaces, punctuation, the template's markers), so a warm encode
does little more than the pre-tokenizer's split.
"""

from __future__ import annotations

import heapq
from typing import Callable, Iterable, Optional

# words longer than this are merged but not cached (HF's MAX_LENGTH rule)
CACHE_WORD_CHARS = 256


class BPE:
    """``merges``: (left, right) string pairs, best first; a pair's rank
    is its index (a repeated pair keeps its last rank, as HF's map
    does). ``initial`` splits a word into its starting symbols (default:
    its characters). ``cache_size`` bounds the per-word cache (0 = off)."""

    def __init__(self, merges: Iterable[tuple], *,
                 initial: Optional[Callable[[str], list]] = None,
                 cache_size: int = 100_000):
        self.ranks: dict = {}
        for r, (a, b) in enumerate(merges):
            self.ranks[(a, b)] = r
        self.initial = initial or list
        self.cache_size = cache_size
        self._cache: dict = {}

    def merge(self, symbols: list) -> list:
        """The symbols after every merge (no cache)."""
        n = len(symbols)
        if n < 2:
            return list(symbols)
        ranks = self.ranks
        sym = list(symbols)
        if n == 2:
            return [sym[0] + sym[1]] if (sym[0], sym[1]) in ranks else sym
        prev = list(range(-1, n - 1))
        nxt = list(range(1, n + 1))
        nxt[-1] = -1
        heap = []
        for i in range(n - 1):
            r = ranks.get((sym[i], sym[i + 1]))
            if r is not None:
                heap.append((r, i))
        heapq.heapify(heap)
        while heap:
            r, i = heapq.heappop(heap)
            j = nxt[i]
            # a stale entry: its left symbol was merged away, or the pair
            # at i is no longer the one this rank names
            if sym[i] is None or j < 0 or ranks.get((sym[i], sym[j])) != r:
                continue
            sym[i] = sym[i] + sym[j]
            sym[j] = None
            k = nxt[j]
            nxt[i] = k
            if k >= 0:
                prev[k] = i
                rk = ranks.get((sym[i], sym[k]))
                if rk is not None:
                    heapq.heappush(heap, (rk, i))
            p = prev[i]
            if p >= 0:
                rp = ranks.get((sym[p], sym[i]))
                if rp is not None:
                    heapq.heappush(heap, (rp, p))
        return [s for s in sym if s is not None]

    def word(self, word: str) -> list:
        """The merged symbols of ``word``, from the cache when it is there."""
        hit = self._cache.get(word)
        if hit is not None:
            return hit
        out = self.merge(self.initial(word))
        if len(word) <= CACHE_WORD_CHARS and len(self._cache) < self.cache_size:
            self._cache[word] = out
        return out
