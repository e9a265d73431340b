"""Pushdown grammar matcher + token-level logit-mask builder (a copy of
localai_tpu/functions/grammars/automaton.py; the port's tokenizers,
engine/tokenizer.py, give ``token_strings`` the minimal surface it reads:
``get_vocab_size``, ``all_special_ids`` and ``decode``).

This is the piece the reference gets from llama.cpp's grammar sampling
(reference: backend/cpp/llama/grpc-server.cpp:688 grammar into slot
sampling params, common_sampler_sample at :1977): during decode, only
tokens whose text the grammar can accept from its current state are
allowed; everything else is masked to -inf before sampling.

TPU re-design: the grammar runs as a host-side pushdown automaton
(characters), while enforcement happens on-device via a per-slot additive
penalty row folded into the existing [S, V] bias matrix of the compiled
sampling step — so constrained decoding costs one masked-row upload per
token, not a host round-trip inside sampling.

Key structures:
  * state = frozenset of stacks; stack = tuple of frames (rule, alt, idx)
    with the TOP at the end. Stacks are expanded so every top frame points
    at a char element; an EMPTY stack in the set means the grammar can
    terminate here (EOS allowed).
  * TokenMaskBuilder walks a trie over the tokenizer's vocabulary strings
    while advancing the automaton, memoizing state -> vocab mask; typical
    JSON grammars revisit a handful of states so steady-state masking is a
    dict hit.
"""

from __future__ import annotations

from typing import Iterable, Optional

import numpy as np

from localai_tpu_torch.functions.grammars.gbnf import parse_gbnf


class Grammar:
    """Compiled grammar with memoized state transitions."""

    def __init__(self, rules, root_id: int):
        self.rules = rules
        self.root_id = root_id
        self._expand_memo: dict = {}

    @staticmethod
    def from_text(text: str) -> "Grammar":
        rules, root = parse_gbnf(text)
        return Grammar(rules, root)

    # -- state machinery --

    def initial_state(self) -> frozenset:
        out: set = set()
        for alt_id in range(len(self.rules[self.root_id])):
            out |= self._expand(((self.root_id, alt_id, 0),))
        return frozenset(out)

    def _expand(self, stack: tuple) -> set:
        """Expand until the top frame is a char element (or stack empty)."""
        memo = self._expand_memo.get(stack)
        if memo is not None:
            return memo
        self._expand_memo[stack] = set()  # cycle guard (left recursion)
        result: set = set()
        if not stack:
            result.add(stack)
        else:
            r, a, i = stack[-1]
            alt = self.rules[r][a]
            if i >= len(alt):
                result |= self._expand(stack[:-1])
            else:
                elem = alt[i]
                if elem[0] == "c":
                    result.add(stack)
                else:  # rule ref
                    rid = elem[1]
                    cont = stack[:-1] + ((r, a, i + 1),)
                    for alt_id in range(len(self.rules[rid])):
                        result |= self._expand(cont + ((rid, alt_id, 0),))
        self._expand_memo[stack] = result
        return result

    @staticmethod
    def _char_matches(elem, cp: int) -> bool:
        _, ranges, negated = elem
        hit = any(lo <= cp <= hi for lo, hi in ranges)
        return hit != negated

    def advance_char(self, state: frozenset, ch: str) -> Optional[frozenset]:
        """One character; None if the grammar rejects it."""
        cp = ord(ch)
        out: set = set()
        for stack in state:
            if not stack:
                continue  # completed grammar accepts no more chars
            r, a, i = stack[-1]
            elem = self.rules[r][a][i]
            if self._char_matches(elem, cp):
                out |= self._expand(stack[:-1] + ((r, a, i + 1),))
        return frozenset(out) if out else None

    def advance_string(self, state: frozenset, s: str) -> Optional[frozenset]:
        for ch in s:
            state = self.advance_char(state, ch)
            if state is None:
                return None
        return state

    @staticmethod
    def is_accepting(state: frozenset) -> bool:
        return () in state

    def accepts(self, text: str) -> bool:
        """Whole-string acceptance (test/debug helper)."""
        st = self.advance_string(self.initial_state(), text)
        return st is not None and self.is_accepting(st)


class GrammarMatcher:
    """Per-request wrapper: grammar + current state."""

    def __init__(self, grammar: Grammar):
        self.grammar = grammar
        self.state = grammar.initial_state()

    def accept(self, s: str) -> bool:
        nxt = self.grammar.advance_string(self.state, s)
        if nxt is None:
            return False
        self.state = nxt
        return True

    @property
    def accepting(self) -> bool:
        return Grammar.is_accepting(self.state)


class _TrieNode:
    __slots__ = ("children", "token_ids")

    def __init__(self):
        self.children: dict = {}
        self.token_ids: list = []


def token_strings(tokenizer) -> list:
    """Per-token surface strings; None for tokens that must never be emitted
    under a grammar (specials). Index = token id."""
    specials = set(getattr(tokenizer, "all_special_ids", None) or [])
    if hasattr(tokenizer, "get_vocab"):
        vocab = tokenizer.get_vocab()
        size = max(vocab.values()) + 1
        out: list = [None] * size
        for tok, tid in vocab.items():
            if tid in specials:
                continue
            try:
                s = tokenizer.convert_tokens_to_string([tok])
            except Exception:
                s = None
            out[tid] = s if s else None
        return out
    # minimal tokenizers (tests): decode each id individually
    size = tokenizer.get_vocab_size()
    out = []
    for tid in range(size):
        if tid in specials:
            out.append(None)
            continue
        try:
            s = tokenizer.decode([tid])
        except Exception:
            s = None
        out.append(s if s else None)
    return out


class TokenMaskBuilder:
    """vocab trie + (grammar state -> allowed-token mask) memo."""

    def __init__(self, token_strs: list, eos_ids: Iterable[int], vocab_size: int):
        self.vocab_size = vocab_size
        self.eos_ids = [e for e in eos_ids if 0 <= e < vocab_size]
        self.root = _TrieNode()
        for tid, s in enumerate(token_strs[:vocab_size]):
            if not s:
                continue
            node = self.root
            for ch in s:
                nxt = node.children.get(ch)
                if nxt is None:
                    nxt = node.children[ch] = _TrieNode()
                node = nxt
            node.token_ids.append(tid)
        self._memo: dict = {}
        self._penalty_memo: dict = {}

    MAX_MEMO = 8192

    def allowed(self, grammar: Grammar, state: frozenset) -> np.ndarray:
        """Bool [V]: True where the token may be sampled from this state.

        Memoized per (grammar, state); the grammar object itself is the key
        (a strong ref — id() reuse after GC must not alias masks), with a
        size cap so a server seeing many distinct tool schemas cannot grow
        the memo unboundedly."""
        key = (grammar, state)
        cached = self._memo.get(key)
        if cached is not None:
            return cached
        if len(self._memo) >= self.MAX_MEMO:
            self._memo.clear()
            self._penalty_memo.clear()
        mask = np.zeros((self.vocab_size,), np.bool_)

        def visit(node: _TrieNode, st: frozenset):
            for tid in node.token_ids:
                mask[tid] = True
            for ch, child in node.children.items():
                nxt = grammar.advance_char(st, ch)
                if nxt is not None:
                    visit(child, nxt)

        visit(self.root, state)
        if Grammar.is_accepting(state) or not mask.any():
            # EOS when the grammar can terminate — or as a pressure valve
            # when the grammar is stuck (mirrors llama.cpp resetting to EOS
            # rather than sampling garbage)
            for e in self.eos_ids:
                mask[e] = True
        self._memo[key] = mask
        return mask

    def penalty_row(self, grammar: Grammar, state: frozenset) -> np.ndarray:
        """f32 [V] additive row: 0 where allowed, -1e9 where masked. Memoized
        alongside the mask so the decode hot path is a dict hit."""
        key = (grammar, state)
        row = self._penalty_memo.get(key)
        if row is None:
            allowed = self.allowed(grammar, state)
            row = np.where(allowed, 0.0, -1e9).astype(np.float32)
            self._penalty_memo[key] = row
        return row
