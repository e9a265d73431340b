#!/usr/bin/env python3
"""Why tests/test_prefix_cache.py::test_no_false_reuse_on_hash_chain_divergence
fails: a bfloat16 near-tie, not a reuse fault.

The test's fixture builds its tiny llama in bfloat16 (LlamaConfig's default
dtype). This script replays the test's prompts on the JAX package, on the
CPU, and prints the last-position logits of the sixth greedy step two ways:
the whole sequence in one fresh prefill (what the cold engine computes) and
the same sequence as a continued prefill over the first page's 16 rows
(what the engine computes when it reuses page 0). Then it runs the test's
engine sequence with float32 parameters and reports whether the reuse run
matches the cold run there.

    JAX_PLATFORMS=cpu python scripts/prefix_reuse_neartie.py
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import tests.test_prefix_cache as T  # noqa: E402
from localai_tpu.models import llama  # noqa: E402


def top(logits, k=3):
    lg = np.asarray(logits, np.float32)
    idx = np.argsort(-lg)[:k]
    return [(int(i), float(lg[i])) for i in idx]


def prompts():
    rng = np.random.default_rng(11)       # the test's seed and draws
    a = T._prompt(rng, 48)
    div = list(a)
    div[20] = (div[20] % 119) + 1 if div[20] != 119 else 1
    return a, div, rng


def last_logits(cfg, params, seq, reuse_rows: int):
    ck, cv = llama.init_cache(cfg, 1, 128)
    if reuse_rows:
        head = jnp.asarray([seq[:reuse_rows]], jnp.int32)
        _, ck, cv = llama.prefill(params, cfg, head, jnp.asarray([reuse_rows]),
                                  ck, cv, jnp.asarray([0]), jnp.asarray([0]))
    rest = seq[reuse_rows:]
    tok = jnp.zeros((1, 64), jnp.int32).at[0, :len(rest)].set(jnp.asarray(rest))
    lg, _, _ = llama.prefill(params, cfg, tok, jnp.asarray([len(rest)]), ck, cv,
                             jnp.asarray([0]), jnp.asarray([reuse_rows]),
                             continued=bool(reuse_rows))
    return lg[0]


def main():
    cfg = llama.LlamaConfig(vocab_size=128, hidden_size=64, intermediate_size=128,
                            num_layers=2, num_heads=4, num_kv_heads=2,
                            max_position_embeddings=64)
    params = llama.init_params(cfg, jax.random.PRNGKey(0))
    _a, div, _rng = prompts()
    e = T._engine(cfg, params, page_size=16, slots=2)
    try:
        cold, _ = T._greedy(e, div)
    finally:
        e.shutdown()
    print(f"bfloat16 params ({cfg.dtype}): cold greedy tokens {cold}")
    seq = div + cold[:5]
    fresh = last_logits(cfg, params, seq, 0)
    cont = last_logits(cfg, params, seq, 16)
    print(f"6th step, fresh prefill:         top 3 {top(fresh)}")
    print(f"6th step, continued over page 0: top 3 {top(cont)}")
    print(f"max |fresh - continued| over the vocabulary: "
          f"{float(jnp.max(jnp.abs(fresh - cont))):.6f}")

    # the test's engine sequence with float32 parameters
    cfg32 = llama.LlamaConfig(vocab_size=128, hidden_size=64, intermediate_size=128,
                              num_layers=2, num_heads=4, num_kv_heads=2,
                              max_position_embeddings=64, dtype=jnp.float32)
    p32 = llama.init_params(cfg32, jax.random.PRNGKey(0))
    a, div, rng = prompts()
    e = T._engine(cfg32, p32, page_size=16, slots=2)
    try:
        ref, _ = T._greedy(e, div)
    finally:
        e.shutdown()
    e = T._engine(cfg32, p32, page_size=16, slots=2)
    try:
        T._greedy(e, a)
        for _ in range(3):
            T._greedy(e, T._prompt(rng, 48))
        got, evs = T._greedy(e, div)
    finally:
        e.shutdown()
    print(f"float32 params: cold {ref}, with reuse {got} "
          f"(reused {evs[-1].timings['reused_prompt_tokens']} rows): "
          f"{'identical' if got == ref else 'DIFFERENT'}")


if __name__ == "__main__":
    main()
