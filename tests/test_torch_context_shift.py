"""Context shift at the cache edge (the port's ``Engine._context_shift``)
against the JAX Engine's, on the CPU, over the tiny f32 checkpoint:
max_context 64, prefill buckets (16, 32), chunk 32, page 16, greedy
requests with ignore_eos.

One script per (layout, kv_prefix_cache) case, paged / int8 KV /
contiguous, reuse on and off, run on the port and on the JAX Engine (its
admission made cold when reuse is off: the JAX engine keeps tiers 1-2
even then):

  1. a 100-token request (three shifts) beside a 60-token neighbour
     that decodes through the first one and shifts once itself;
  2. a 100-token request with repeat / presence / frequency penalties
     and a logit bias across its shifts (the penalty ring restarts from
     the kept window);
  3. request 1's prompt again, 10 tokens: with reuse on, paged, the
     pages request 1's first shift put in the prefix cache are spliced.

Per request the tokens, finish reason, completion_tokens and
reused_prompt_tokens equal the JAX Engine's. Then, on the paged case:
with ``context_shift`` off both stop with "length" at the same token; a
stop sequence completing on the trigger token finishes with "stop" on
both, with the same reused_prompt_tokens (both emitter threads shift
before the stop scan); and a request cancelled during its shift's re-prefill keeps only
the rows whose KV write ran.
"""

from __future__ import annotations

import tests.torch_cpu  # noqa: F401  (one torch CPU thread)

import json
import os

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
from tests.test_torch_engine import _Tok

C, PG = 64, 16
# a pool of 32 pages (not the 8 two slots need): retained chains survive
# the script's traffic
EC = dict(num_slots=2, max_context=C, prefill_buckets=(16, 32),
          prefill_chunk=32, kv_page_size=PG, kv_pool_pages=32)
# (port knobs, JAX knobs)
LAYOUTS = {"paged": ({}, {"cache_dtype": jnp.float32}),
           "int8": ({"cache_dtype": torch.int8}, {"cache_dtype": jnp.int8}),
           "contig": ({"kv_layout": "contiguous"},
                      {"cache_dtype": jnp.float32, "kv_layout": "contiguous"})}
PENALIZED = {"repeat_penalty": 1.3, "presence_penalty": 0.4,
             "frequency_penalty": 0.3, "logit_bias": {7: -100.0, 30: 2.0}}


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    from tests.tinymodel import write_tiny_checkpoint

    d = str(tmp_path_factory.mktemp("tiny_shift"))
    write_tiny_checkpoint(d)
    with open(os.path.join(d, "config.json")) as f:
        hf = json.load(f)
    jcfg = jllama.LlamaConfig.from_hf_config(hf, dtype=jnp.float32)
    jparams = jweights.load_llama_params(d, jcfg, dtype=jnp.float32)
    tcfg = tllama.LlamaConfig.from_hf_config(hf, dtype=torch.float32)
    tparams = tweights.from_jax_params(jax.tree.map(np.asarray, jparams),
                                       tcfg, device="cpu")
    return jcfg, jparams, tcfg, tparams


def jax_engine(tiny, reuse: bool, **knobs):
    jcfg, jparams, _tc, _tp = tiny
    je = jeng.Engine(jcfg, jparams, _Tok(), jeng.EngineConfig(
        **EC, kv_prefix_cache=reuse, kv_offload=False,
        draft="0", **knobs))
    if not reuse:
        pick = je._pick_slot
        je._pick_slot = lambda ids: (pick(ids)[0], 0)

        def cold_admission(slot, ids, common, rid=""):
            je._pool.release(slot, 0)
            return 0

        je._paged_admission = cold_admission
    return je.start() or je


def port_engine(tiny, reuse: bool, **knobs):
    _jc, _jp, tcfg, tparams = tiny
    return teng.Engine(tcfg, tparams, _Tok(), teng.EngineConfig(
        **EC, decode_burst=16, kv_prefix_cache=reuse, kv_offload=False,
        draft="0", **knobs), device="cpu").start()


def submit(e, prompt, n, stop=(), **params):
    mod, samp = (teng, tsamp) if isinstance(e, teng.Engine) else (jeng, jsamp)
    return e.submit(mod.GenRequest(
        prompt_ids=list(prompt), max_new_tokens=n, ignore_eos=True,
        stop_sequences=list(stop),
        params=samp.SamplingParamsHost(temperature=0.0, **params)))


def drain(out) -> dict:
    ids, fin, ct, reused, text = [], None, 0, None, ""
    while (ev := out.get(timeout=600)) is not None:
        assert not ev.error, ev.error
        ids.extend(ev.token_ids or ([ev.token_id] if ev.token_id >= 0 else []))
        text += ev.text
        fin, ct = ev.finish_reason or fin, ev.completion_tokens
        if ev.timings:
            reused = ev.timings["reused_prompt_tokens"]
    return {"ids": ids, "finish": fin, "completion_tokens": ct,
            "reused": reused, "text": text}


def script(e) -> list:
    rng = np.random.default_rng(17)
    p1, p2, p3 = (rng.integers(2, 258, size=n).tolist() for n in (40, 12, 25))
    a, b = submit(e, p1, 100), submit(e, p2, 60)
    res = [drain(a), drain(b)]
    res.append(drain(submit(e, p3, 100, **PENALIZED)))
    res.append(drain(submit(e, p1, 10)))
    return res


@pytest.fixture(scope="module", params=[(lay, reuse) for lay in sorted(LAYOUTS)
                                        for reuse in (True, False)],
                ids=lambda p: f"{p[0]}-{'reuse' if p[1] else 'cold'}")
def scripted(request, tiny):
    layout, reuse = request.param
    tk, jk = LAYOUTS[layout]
    out = {"case": request.param}
    for name, make in (("port", lambda: port_engine(tiny, reuse, **tk)),
                       ("jax", lambda: jax_engine(tiny, reuse, **jk))):
        e = make()
        try:
            m0 = e.metrics()["packed_prefill"]["dispatches"] if name == "port" else 0
            out[name] = script(e)
            if name == "port":
                m = e.metrics()
                out["packs"] = m["packed_prefill"]["dispatches"] - m0
                out["port_metrics"] = m
        finally:
            e.shutdown()
    return out


def test_shift_requests_equal_the_jax_engine(scripted):
    port, ref = scripted["port"], scripted["jax"]
    for got, want in zip(port, ref):
        for key in ("ids", "finish", "completion_tokens", "reused"):
            assert got[key] == want[key], (scripted["case"], key)
    assert [r["completion_tokens"] for r in port] == [100, 60, 100, 10]
    assert all(r["finish"] == "length" for r in port)
    # requests 1, 2 and 3 shifted 3, 1 and 2 times (a pack each)
    assert scripted["packs"] >= 4 + 6
    m = scripted["port_metrics"]
    assert m["active_slots"] == 0
    if m["kv_layout"] == "paged":
        assert m["pages_in_use"] == 0


def test_penalties_hold_across_the_shift(scripted):
    """The banned token never appears after the shifts either."""
    assert 7 not in scripted["port"][2]["ids"]


def test_reuse_after_a_shift(scripted):
    """Request 1's first shift put its 40-token prompt's two full pages
    in the prefix cache (paged, reuse on): request 4 splices them."""
    layout, reuse = scripted["case"]
    want = 32 if reuse and layout != "contig" else 0
    assert scripted["port"][3]["reused"] == want


# ---------- context_shift off, stops and cancels (paged) ----------

@pytest.fixture(scope="module")
def pair(tiny):
    je, te = jax_engine(tiny, True), port_engine(tiny, True)
    yield je, te
    je.shutdown()
    te.shutdown()


def test_context_shift_off_stops_with_length_at_the_jax_token(pair):
    je, te = pair
    prompt = np.random.default_rng(19).integers(2, 258, size=20).tolist()
    res = []
    for e in (je, te):
        e.ecfg.context_shift = False
        try:
            res.append(drain(submit(e, prompt, 100)))
        finally:
            e.ecfg.context_shift = True
    assert res[1] == res[0]
    # the cache edge: the first token at row 20, the last at row C - 2
    assert res[1]["finish"] == "length"
    assert res[1]["completion_tokens"] == C - 2 - 20 + 1


def test_stop_sequence_on_the_trigger_token_finishes_with_stop(pair):
    je, te = pair
    prompt = np.random.default_rng(23).integers(2, 258, size=20).tolist()
    k = C - 2 - 20                   # index of the first shift's trigger
    # the text up to the trigger (three tokens past the shift this prompt
    # meets a near-tie: a top-2 logit gap of 9.4e-4 on the port)
    free = [drain(submit(e, prompt, k + 1)) for e in (je, te)]
    assert free[1] == free[0]
    text = free[1]["text"]
    n = 3
    while text[k + 1 - n:k + 1] in text[:k]:
        n += 1                       # a stop that completes only there
    stop = text[k + 1 - n:k + 1]
    res = [drain(submit(e, prompt, 60, stop=[stop])) for e in (je, te)]
    # both engines' emitter threads: the engine thread shifts first, and
    # the stop scan that completes on the trigger token ends the shifted
    # slot (the wasted re-prefill's admission is what both report as
    # reused)
    for key in ("ids", "finish", "completion_tokens", "text", "reused"):
        assert res[1][key] == res[0][key], key
    assert res[1]["finish"] == "stop"
    assert res[1]["completion_tokens"] == k + 1
    assert res[1]["text"] == text[:k + 1 - n]


def test_cancel_during_the_shifts_reprefill_keeps_only_committed_rows(tiny):
    """Ticks driven from the test, prefill_chunk 16: the shift's 32-row
    re-prefill takes two packs; cancelled after the first, the slot keeps
    exactly those 16 rows (one page) and the prefix cache holds the
    pre-shift history's full pages."""
    _jc, _jp, tcfg, tparams = tiny
    e = teng.Engine(tcfg, tparams, _Tok(), teng.EngineConfig(
        **{**EC, "prefill_chunk": 16, "prefill_buckets": (16,)},
        decode_burst=16, draft="0"), device="cpu")
    prompt = np.random.default_rng(29).integers(2, 258, size=20).tolist()
    out = submit(e, prompt, 100)
    assert e._admit()
    s = e.slots[0]
    while s.phase == "prefill":
        e._prefill_step()
    while s.phase == "decode":
        assert e._decode_burst()
    # the shift: history = prompt + 42 emitted tokens' rows; 32 kept
    assert s.n_decoded == C - 2 - 20 + 1 and s.committed == 0
    window = list(e._cache_tokens[0])
    assert len(window) == C // 2 and e._pool.owned[0] == 0
    held = e._pcache.pages_held
    assert held == (C - 2) // PG
    assert e._prefill_step() and s.committed == 16
    e.cancel(s.req.request_id)
    e._reap_cancelled()
    assert e.slots[0] is None
    assert e._cache_tokens[0] == window[:16]
    assert int(e._pool.owned[0]) == 1
    assert e._pcache.pages_held == held + 1
    assert e.metrics()["pages_in_use"] == 0
    ids = drain(out)["ids"]
    assert len(ids) == C - 2 - 20 + 1
    e.shutdown()
