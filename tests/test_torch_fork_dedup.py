"""In-flight prefill dedup (fork siblings) of the port's engine against the
JAX Engine, on the CPU, over the tiny f32 checkpoint (tests/tinymodel.py).
Both engines run at their defaults (pipelined, split fused tick; the JAX
one with kv_offload off and no draft).

  * four identical requests admitted together prefill once: the leader
    prefills its prompt, each sibling takes its first len(prompt) - 1 rows
    and prefills one token, so the pack tokens equal the JAX Engine's
    (len(prompt) + 3); greedy siblings give the leader's tokens, finish
    reasons, completion_tokens and reused_prompt_tokens, request by
    request as the JAX Engine; sampled siblings (their own seeds) differ
    from one another in both engines (the port's counterparts of
    tests/test_engine.py's test_identical_prompts_fork_prefill and
    test_identical_sampled_prompts_differ_per_request). Paged, the
    leader's full prompt pages are referenced by all four tables while
    the group runs; contiguous, the sibling's rows equal the leader's
    (copied); int8 KV shares pages as bf16 does. pages_in_use is 0 at
    idle;
  * a leader cancelled before its final pack downgrades its siblings to
    full prefills with the JAX Engine's tokens for that prompt; a sibling
    cancelled while it waits is dropped and the others fork as before.
"""

from __future__ import annotations

import tests.torch_cpu  # noqa: F401  (one torch CPU thread)

import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localai_tpu.engine import engine as jeng
from localai_tpu.engine import sampling as jsamp
from localai_tpu.engine import weights as jweights
from localai_tpu.models import llama as jllama
from localai_tpu_torch.engine import engine as teng
from localai_tpu_torch.engine import sampling as tsamp
from localai_tpu_torch.engine import weights as tweights
from localai_tpu_torch.models import llama as tllama

S, C, PG = 4, 128, 16
PROMPT = 40          # > prefill_chunk: the leader's prompt takes two packs
EC = dict(num_slots=S, max_context=C, prefill_buckets=(8, 16, 32),
          prefill_chunk=32, kv_page_size=PG)
# (port knobs, JAX cache dtype, JAX layout)
LAYOUTS = {"paged": ({}, jnp.float32, "paged"),
           "int8": ({"cache_dtype": torch.int8}, jnp.int8, "paged"),
           "contig": ({"kv_layout": "contiguous"}, jnp.float32, "contiguous")}
PARAMS = {"greedy": dict(temperature=0.0),
          "sampled": dict(temperature=1.0, top_k=50)}


class _Tok:
    eos_token_id = 1

    def decode(self, ids, **kw):
        return "".join(chr(97 + (i % 26)) for i in ids)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    from tests.tinymodel import write_tiny_checkpoint

    d = str(tmp_path_factory.mktemp("tiny_fork"))
    write_tiny_checkpoint(d)
    with open(os.path.join(d, "config.json")) as f:
        hf = json.load(f)
    jcfg = jllama.LlamaConfig.from_hf_config(hf, dtype=jnp.float32)
    jparams = jweights.load_llama_params(d, jcfg, dtype=jnp.float32)
    tcfg = tllama.LlamaConfig.from_hf_config(hf, dtype=torch.float32)
    tparams = tweights.from_jax_params(jax.tree.map(np.asarray, jparams),
                                       tcfg, device="cpu")
    return jcfg, jparams, tcfg, tparams


def jax_engine(tiny, layout):
    jcfg, jparams, _tc, _tp = tiny
    _tk, dtype, lay = LAYOUTS[layout]
    return jeng.Engine(jcfg, jparams, _Tok(), jeng.EngineConfig(
        **EC, cache_dtype=dtype, kv_layout=lay, kv_offload=False, draft="0"))


def port_engine(tiny, layout):
    _jc, _jp, tcfg, tparams = tiny
    return teng.Engine(tcfg, tparams, _Tok(), teng.EngineConfig(
        **EC, decode_burst=16, kv_offload=False, draft="0",
        **LAYOUTS[layout][0]), device="cpu")


def submit(e, prompt, n, rid, **params):
    mod, samp = (teng, tsamp) if isinstance(e, teng.Engine) else (jeng, jsamp)
    return e.submit(mod.GenRequest(
        prompt_ids=list(prompt), max_new_tokens=n, ignore_eos=True,
        request_id=rid, params=samp.SamplingParamsHost(**params)))


def drain(out) -> dict:
    ids, fin, ct, reused = [], None, 0, None
    while (ev := out.get(timeout=600)) is not None:
        assert not ev.error, ev.error
        ids.extend(ev.token_ids or ([ev.token_id] if ev.token_id >= 0 else []))
        fin, ct = ev.finish_reason or fin, ev.completion_tokens
        if ev.timings:
            reused = ev.timings["reused_prompt_tokens"]
    return {"ids": ids, "finish": fin, "completion_tokens": ct, "reused": reused}


def prompt_of(seed: int = 7) -> list:
    return np.random.default_rng(seed).integers(2, 258, size=PROMPT).tolist()


def run_jax(e, reqs) -> tuple:
    """Submit every (prompt, n, rid, params) before the loop starts (one
    admission batch), then drain: (results, metrics)."""
    outs = [submit(e, p, n, rid, **kw) for p, n, rid, kw in reqs]
    e.start()
    try:
        return [drain(o) for o in outs], e.metrics()
    finally:
        e.shutdown()


def run_port(e, reqs, cancel=None, watch=None) -> tuple:
    """The port engine's loop driven tick by tick on this thread: every
    request queued before the first tick; ``cancel`` (a request id) is
    cancelled after the first tick; ``watch(e)`` runs after every tick.
    Returns (results, metrics) once idle."""
    outs = [submit(e, p, n, rid, **kw) for p, n, rid, kw in reqs]
    ticks = 0
    while e._tick():
        ticks += 1
        if ticks == 1 and cancel:
            e.cancel(cancel)
        if watch:
            watch(e)
    return [drain(o) for o in outs], e.metrics()


@pytest.mark.parametrize("mode", sorted(PARAMS))
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_identical_prompts_fork_prefill(tiny, layout, mode):
    prompt = prompt_of()
    reqs = [(prompt, 12, f"r{i}", PARAMS[mode]) for i in range(4)]
    n = PROMPT - 1
    seen = {}

    def watch(e):
        # the moment the siblings forked: their rows are the leader's
        if "forked" in seen or e.metrics()["fork"]["forked"] < 3:
            return
        lead = next(i for i, s in enumerate(e.slots)
                    if s is not None and s.req.request_id == "r0")
        sibs = [i for i, s in enumerate(e.slots)
                if s is not None and s.req.request_id != "r0"]
        if e._pool is not None:
            full = e._pool.ptab[lead, :n // PG]
            seen["refs"] = [int(e._pool.refs[p]) for p in full]
            seen["tables"] = all(
                list(e._pool.ptab[j, :n // PG]) == list(full) for j in sibs)
        else:
            rows = e.ck["rows"]
            seen["rows"] = all(torch.equal(rows[:, j, :n], rows[:, lead, :n])
                               for j in sibs)
        seen["forked"] = True

    want, jm = run_jax(jax_engine(tiny, layout), reqs)
    got, m = run_port(port_engine(tiny, layout), reqs, watch=watch)
    assert m["fork"] == {"siblings": 3, "forked": 3, "downgraded": 0,
                         "rows_shared": 3 * n}
    assert m["packed_prefill"]["tokens"] == jm["packed_prefill"]["tokens"] == PROMPT + 3
    assert [r["reused"] for r in got] == [0, n, n, n]
    for key in ("finish", "completion_tokens", "reused"):
        assert [r[key] for r in got] == [r[key] for r in want], key
    if mode == "greedy":
        assert [r["ids"] for r in got] == [r["ids"] for r in want]
        assert all(r["ids"] == got[0]["ids"] for r in got)
    else:
        for res in (got, want):
            assert len({tuple(r["ids"]) for r in res}) >= 2, res
    if layout == "contig":
        assert seen["rows"]
    else:
        # the full prompt pages: the leader's table and three siblings'
        assert seen["tables"] and seen["refs"] == [4] * (n // PG)
        assert m["pages_in_use"] == 0
    assert m["active_slots"] == 0


@pytest.mark.parametrize("layout", ("paged", "contig"))
@pytest.mark.parametrize("cancel", ("leader", "sibling"))
def test_cancel_while_siblings_wait(tiny, layout, cancel):
    """Cancelled after the first tick (the leader's first, non-final pack
    is in flight, the siblings wait): a cancelled leader downgrades both
    siblings to full prefills; a cancelled sibling is dropped and the
    other forks. The survivors give the JAX Engine's tokens for the
    prompt."""
    prompt = prompt_of(11)
    want, _jm = run_jax(jax_engine(tiny, layout),
                        [(prompt, 10, "solo", PARAMS["greedy"])])
    reqs = [(prompt, 10, f"r{i}", PARAMS["greedy"]) for i in range(3)]
    victim = "r0" if cancel == "leader" else "r1"
    got, m = run_port(port_engine(tiny, layout), reqs, cancel=victim)
    gone = int(victim[1])
    assert got[gone] == {"ids": [], "finish": None, "completion_tokens": 0,
                         "reused": None}
    alive = [r for i, r in enumerate(got) if i != gone]
    assert all(r["ids"] == want[0]["ids"] and r["finish"] == "length"
               for r in alive)
    first = min(PROMPT, EC["prefill_chunk"])        # the leader's first pack
    if cancel == "leader":
        assert m["fork"] == {"siblings": 2, "forked": 0, "downgraded": 2,
                             "rows_shared": 0}
        assert [r["reused"] for r in alive] == [0, 0]
        assert m["packed_prefill"]["tokens"] == first + 2 * PROMPT
    else:
        assert m["fork"] == {"siblings": 2, "forked": 1, "downgraded": 0,
                             "rows_shared": PROMPT - 1}
        assert [r["reused"] for r in alive] == [0, PROMPT - 1]
        assert m["packed_prefill"]["tokens"] == PROMPT + 1
    assert m["active_slots"] == 0
    if layout == "paged":
        assert m["pages_in_use"] == 0


def test_a_leader_paused_in_its_admission_pass_leads_no_sibling(tiny):
    """Two slots decode; two identical requests queued behind them age
    past priority_aging_ms, so each pass of one admission preempts the
    newest running slot for the next. The first of the pair is admitted
    as a leader and is the newest slot when the second comes up: it is
    paused, and the second must not become its fork sibling (a sibling of
    a parked leader waits for ever; the JAX admission has that gap). Every
    request completes with the tokens of a cold run of its prompt."""
    _jc, _jp, tcfg, tparams = tiny
    e = teng.Engine(tcfg, tparams, _Tok(), teng.EngineConfig(
        **{**EC, "num_slots": 2}, priority_aging_ms=1, kv_offload=False,
        draft="0", emitter=False), device="cpu")
    rng = np.random.default_rng(11)
    first = [submit(e, rng.integers(2, 258, 20).tolist(), 30, f"run{i}",
                    temperature=0.0) for i in range(2)]
    assert e._tick()                            # both running
    same = prompt_of(5)[:20]
    pair = [submit(e, same, 12, f"same{i}", temperature=0.0) for i in range(2)]
    time.sleep(0.01)                            # the pair ages to "high"
    for _ in range(400):
        if not e._tick() and not e._fifo and e.num_active == 0:
            break
    assert e.metrics()["scheduler"]["preemptions"] >= 2
    assert not e._fork_waiters
    got = [drain(o) for o in first + pair]
    assert all(g["completion_tokens"] == n for g, n in zip(got, (30, 30, 12, 12)))
    cold = port_engine(tiny, "paged").start()
    try:
        want = drain(submit(cold, same, 12, "cold", temperature=0.0))["ids"]
    finally:
        cold.shutdown()
    assert got[2]["ids"] == got[3]["ids"] == want
