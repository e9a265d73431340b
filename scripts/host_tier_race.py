#!/usr/bin/env python3
"""Why the kv_offload-off tests of tests/test_torch_host_tier.py feed a
wave one request at a time, or in pairs admitted together, and never
each request after the first token of the one before.

The test's script (turn 1, a wave of four, turn 2, a second wave, turn
3) runs on the JAX Engine and on the port's, both with kv_offload off
and a 20-page pool, RUNS times in each of three ways of feeding a wave:

  first-token  each request submitted once the one before has its first
               token: its admission races the release of the one before,
               which the top-of-tick drain of landed bursts settles by
               timing (the JAX Engine's, localai_tpu/engine/engine.py:
               3902-3905; the port's loop has it too, Engine._tick's
               _drain_fifo(block=False), but on the CPU a port burst
               counts as landed only when the
               loop waits for it, a busy card, so here the port admits
               first; tests/test_torch_top_drain.py holds the drained order
               with the landing made deterministic, and chip_smoke.py
               phases 3f / 3g print the card's counts);
  serial       each request submitted once the one before has finished
               (run_script with group=1);
  pairs        two at a time, admitted in one pass, each pair once the
               one before has finished (group=2).

It prints the rows turns 2 and 3 reused (requests 5 and 10) per run.

    JAX_PLATFORMS=cpu python scripts/host_tier_race.py [RUNS]
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import tests.torch_cpu  # noqa: E402,F401  (one torch CPU thread)
from tests import test_torch_host_tier as H  # noqa: E402


class _Dirs:
    """tmp_path_factory for the fixture, outside pytest."""

    def mktemp(self, name):
        import tempfile

        return tempfile.mkdtemp(prefix=name)


def _event_ids(ev) -> list:
    return list(ev.token_ids or ([ev.token_id] if ev.token_id >= 0 else []))


def script(e, way: str, seed: int = 31) -> list:
    """The test's script fed ``way``; the rows each request reused."""
    if way != "first-token":
        res, _counters = H.run_script(e, seed, group=GROUPS[way])
        return [r[3] for r in res]
    rng = np.random.default_rng(seed)

    def draw(n):
        return rng.integers(2, 258, size=n).tolist()

    def wave(lens, n):
        outs = []
        for k in lens:
            out = H._submit(e, draw(k), n)
            outs.append((out, out.get(timeout=600)))    # its first token
        res = []
        for out, first in outs:
            ids, last = _event_ids(first), first
            while (ev := out.get(timeout=600)) is not None:
                ids += _event_ids(ev)
                last = ev
            res.append((ids, last.finish_reason, last.completion_tokens,
                        last.timings["reused_prompt_tokens"]))
        return res

    res = []
    a = draw(70)
    res.append(H._drain(H._submit(e, a, 6)))
    res += wave((60, 62, 58, 61), 10)
    t2 = a + res[0][0] + draw(5)
    res.append(H._drain(H._submit(e, t2, 6)))
    res += wave((63, 57, 60, 59), 10)
    res.append(H._drain(H._submit(e, t2 + res[5][0] + draw(7), 6)))
    return [r[3] for r in res]


GROUPS = {"serial": 1, "pairs": 2}


def main():
    runs = int(sys.argv[1]) if len(sys.argv) > 1 else 3
    tiny = H.tiny.__wrapped__(_Dirs())
    for way in ("first-token", *GROUPS):
        for name, make in (("jax", H.jax_engine), ("port", H.port_engine)):
            got = []
            for _ in range(runs):
                e = make(tiny, kv_offload=False)
                try:
                    reused = script(e, way)
                finally:
                    e.shutdown()
                got.append(f"{reused[5]}/{reused[10]}")
            print(f"{way:11s} {name:4s} turn 2 / turn 3 reused rows: "
                  f"{', '.join(got)}", flush=True)


if __name__ == "__main__":
    main()
