"""ctypes bindings for the native grammar runtime (csrc/grammar.cc, a copy
of the JAX package's runtime/grammar.cc; counterpart of
localai_tpu/functions/grammars/native.py).

The C++ automaton is the engine's path for constrained decoding: a cold
mask walk over a 128k vocabulary costs seconds in the Python automaton
and milliseconds here. The shared library is built with ``g++`` at first
use into the git-ignored ``ops/kernels/build/`` beside the CUDA kernels,
named by a hash of the source, and loaded with ctypes. Unlike the JAX
package there is no fallback: a failed build raises, as a kernel build
does. automaton.py stays the semantic reference the tests hold this
against.

Interface parity with automaton.py: NativeGrammar states are opaque ints
(instead of frozensets) and NativeMaskBuilder.penalty_row memoizes rows
per state, so the engine's identity compare of rows keeps working.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import struct
import subprocess
import threading
from typing import Iterable, Optional

import numpy as np

from localai_tpu_torch.functions.grammars.gbnf import parse_gbnf
from localai_tpu_torch.ops.kernels.build import BUILD_DIR

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                   "grammar.cc")
CXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]
_lib = None
_lib_lock = threading.Lock()


def lib_path() -> str:
    """Where the library built from the current source lands."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libgrammar-{h.hexdigest()[:12]}.so")


def _build_and_load():
    so = lib_path()
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        r = subprocess.run(["g++", *CXX_FLAGS, SRC, "-o", tmp],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"native grammar runtime build failed (g++ exit "
                               f"{r.returncode}):\n{r.stdout}{r.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(so)
    lib.ga_grammar_new.restype = ctypes.c_void_p
    lib.ga_grammar_new.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
    lib.ga_grammar_free.argtypes = [ctypes.c_void_p]
    lib.ga_initial.restype = ctypes.c_int
    lib.ga_initial.argtypes = [ctypes.c_void_p]
    lib.ga_advance.restype = ctypes.c_int
    lib.ga_advance.argtypes = [ctypes.c_void_p, ctypes.c_int,
                               ctypes.c_char_p, ctypes.c_size_t]
    lib.ga_accepting.restype = ctypes.c_int
    lib.ga_accepting.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.ga_mask_builder_new.restype = ctypes.c_void_p
    lib.ga_mask_builder_new.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_size_t, ctypes.c_int32]
    lib.ga_mask_builder_free.argtypes = [ctypes.c_void_p]
    lib.ga_penalty_row.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_int,
                                   ctypes.POINTER(ctypes.c_float)]
    return lib


def get_lib():
    """The loaded native library, built on first use (raises if the build
    fails)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib = _build_and_load()
        return _lib


def serialize_rules(rules, root_id: int) -> bytes:
    """Pack parse_gbnf output into the grammar.cc binary layout."""
    out = [struct.pack("<II", len(rules), root_id)]
    for rule in rules:
        out.append(struct.pack("<I", len(rule)))
        for alt in rule:
            out.append(struct.pack("<I", len(alt)))
            for elem in alt:
                if elem[0] == "c":
                    _, ranges, negated = elem
                    out.append(struct.pack("<BBI", 0, 1 if negated else 0,
                                           len(ranges)))
                    for lo, hi in ranges:
                        out.append(struct.pack("<II", lo, hi))
                else:
                    out.append(struct.pack("<BI", 1, elem[1]))
    return b"".join(out)


class NativeGrammar:
    """Opaque-state counterpart of automaton.Grammar."""

    def __init__(self, rules, root_id: int, lib):
        self._lib = lib
        blob = serialize_rules(rules, root_id)
        self._handle = lib.ga_grammar_new(blob, len(blob))

    @staticmethod
    def from_text(text: str) -> "NativeGrammar":
        """Parse (GrammarError on a bad grammar) and compile ``text``."""
        rules, root = parse_gbnf(text)
        return NativeGrammar(rules, root, get_lib())

    def __del__(self):
        lib, handle = getattr(self, "_lib", None), getattr(self, "_handle", None)
        if lib is not None and handle:
            lib.ga_grammar_free(handle)

    def initial_state(self) -> int:
        return self._lib.ga_initial(self._handle)

    def advance_string(self, state: int, s: str) -> Optional[int]:
        b = s.encode("utf-8")
        nxt = self._lib.ga_advance(self._handle, state, b, len(b))
        return None if nxt < 0 else nxt

    def is_accepting(self, state: int) -> bool:
        return bool(self._lib.ga_accepting(self._handle, state))

    def accepts(self, text: str) -> bool:
        st = self.advance_string(self.initial_state(), text)
        return st is not None and self.is_accepting(st)


class NativeMaskBuilder:
    """Counterpart of automaton.TokenMaskBuilder over the native trie.
    ``hits`` / ``misses`` count penalty_row's memo lookups."""

    def __init__(self, token_strs: list, eos_ids: Iterable[int], vocab_size: int):
        lib = get_lib()
        self._lib = lib
        self.vocab_size = vocab_size
        parts = []
        for tid, s in enumerate(token_strs[:vocab_size]):
            if not s:
                continue
            b = s.encode("utf-8")
            parts.append(struct.pack("<ii", tid, len(b)) + b)
        blob = b"".join(parts)
        eos = [e for e in eos_ids if 0 <= e < vocab_size]
        arr = (ctypes.c_int32 * len(eos))(*eos)
        self._handle = lib.ga_mask_builder_new(blob, len(blob), arr, len(eos),
                                               vocab_size)
        self._penalty_memo: dict = {}
        self.hits = self.misses = 0

    def __del__(self):
        lib, handle = getattr(self, "_lib", None), getattr(self, "_handle", None)
        if lib is not None and handle:
            lib.ga_mask_builder_free(handle)

    MAX_MEMO = 8192

    def penalty_row(self, grammar: NativeGrammar, state: int) -> np.ndarray:
        key = (grammar, state)
        row = self._penalty_memo.get(key)
        if row is None:
            self.misses += 1
            if len(self._penalty_memo) >= self.MAX_MEMO:
                self._penalty_memo.clear()
            row = np.empty((self.vocab_size,), np.float32)
            self._lib.ga_penalty_row(
                self._handle, grammar._handle, state,
                row.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
            self._penalty_memo[key] = row
        else:
            self.hits += 1
        return row
