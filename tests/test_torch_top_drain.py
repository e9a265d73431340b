"""The top-of-tick drain of the port's loop against the JAX Engine's
(localai_tpu/engine/engine.py:3894-3905: with the emitter on, the loop
applies the emitter's notes, then processes every pack or burst that has
already landed, and only then admits), on the CPU, over the tiny f32
checkpoint, paged KV (float32 and int8), kv_offload off, both engines
started with the emitter on (the default).

A three-turn chat (70 prompt tokens, 9 new each, the next turn the last
one's history plus a few tokens) where each turn arrives at the top of
the tick after the last burst of the turn before was dispatched, once
that burst has landed. A hook on each engine's ``_apply_emitter_notes``
(the first step of a tick, on the loop thread, right before the
top-of-tick drain) submits the next turn then, so the arrival does not
depend on timing:

  * JAX Engine: the turn's one burst is held back from the sync worker
    until the next tick's hook (so its loop cannot find it landed in the
    tick that dispatched it, which it does or not by timing on the CPU);
    the hook hands it over, waits for its ready flag and submits;
  * port: on the CPU a burst counts as landed only once the loop waits
    for it (a busy card; engine/engine.py module doc), so the hook marks
    the FIFO's bursts ``landed_early``, standing in for the card's event,
    and submits.

Both engines then finish the turn before in that tick and admit the next
one over its released slot: per turn the greedy tokens and the reused
prompt rows are the JAX Engine's, and turns 2 and 3 reuse the whole
history the turn before left (its prompt and every token but the last).
A loop that admits before it drains seats each turn beside the
still-active turn before it, which reuses less (the port before the top-
of-tick drain: this test failed there).
"""

from __future__ import annotations

import tests.torch_cpu  # noqa: F401  (one torch CPU thread)

import threading

import numpy as np
import pytest

from localai_tpu.engine import engine as jeng
from localai_tpu_torch.engine import engine as teng
from tests.test_torch_host_tier import (  # noqa: F401  (tiny: the fixture)
    _drain, _submit, jax_engine, port_engine, tiny)

# tokens of each turn: the pack's first token, then ONE burst of 8 (the
# JAX Engine's bursts are powers of two <= decode_burst)
NEW = 9


def _script(tiny, dtype: str, seed: int = 31) -> list:
    """The three prompts: turn 1, then each turn the one before's prompt,
    its greedy output (from a plain JAX Engine run) and a few tokens."""
    rng = np.random.default_rng(seed)
    a = rng.integers(2, 258, size=70).tolist()
    extra = [rng.integers(2, 258, size=k).tolist() for k in (5, 7)]
    je = jax_engine(tiny, dtype, kv_offload=False)
    try:
        prompts = [a]
        for k in range(2):
            ids = _drain(_submit(je, prompts[-1], NEW))[0]
            prompts.append(prompts[-1] + ids + extra[k])
    finally:
        je.shutdown()
    return prompts


def _last_burst_in_flight(e) -> bool:
    """A burst is in the FIFO and no decoding slot has budget beyond the
    steps in flight (the turn's last burst)."""
    burst = teng._Burst if isinstance(e, teng.Engine) else jeng._Burst
    if not any(isinstance(x, burst) for x in list(e._fifo)):
        return False
    infl = e._inflight_vec()
    return all(s is None or s.phase != "decode"
               or s.req.max_new_tokens - s.n_decoded - infl[i] <= 0
               for i, s in enumerate(e.slots))


def _run(e, prompts) -> list:
    """Submit turn 1, let the hook submit the others; (ids, finish,
    completion_tokens, reused) per turn."""
    outs, held, lock = [], [], threading.Lock()
    if not isinstance(e, teng.Engine):
        put = e._sync_q.put

        def hold(item, *a, **k):
            if isinstance(item, jeng._Burst):
                held.append(item)
            else:
                put(item, *a, **k)

        e._sync_q.put = hold
    notes = e._apply_emitter_notes

    def hook():
        with lock:
            while held:
                b = held.pop(0)
                put(b)
                assert b.ready.wait(timeout=60)
            if 0 < len(outs) < len(prompts) and _last_burst_in_flight(e):
                for x in list(e._fifo):
                    if isinstance(x, teng._Burst):
                        x.landed_early = True
                outs.append(_submit(e, prompts[len(outs)], NEW))
        return notes()

    e._apply_emitter_notes = hook
    with lock:
        outs.append(_submit(e, prompts[0], NEW))
    got = [_drain(outs[0])]
    for k in range(1, len(prompts)):
        for _ in range(600):
            with lock:
                if len(outs) > k:
                    break
            threading.Event().wait(0.05)
        assert len(outs) > k, f"turn {k + 1} was never submitted"
        got.append(_drain(outs[k]))
    return got


@pytest.mark.parametrize("dtype", ("float32", "int8"))
def test_landed_last_burst_is_processed_before_admission(tiny, dtype):
    prompts = _script(tiny, dtype)
    je = jax_engine(tiny, dtype, kv_offload=False)
    try:
        want = _run(je, prompts)
    finally:
        je.shutdown()
    e = port_engine(tiny, dtype, kv_offload=False)
    try:
        got = _run(e, prompts)
    finally:
        e.shutdown()
    assert got == want
    assert [r[2] for r in got] == [NEW] * 3
    # turns 2 and 3 reuse the whole history the turn before left in its
    # released slot (its prompt and every token but the last)
    history = [len(prompts[k]) + NEW - 1 for k in range(2)]
    assert [r[3] for r in got[1:]] == history, (got, history)
