"""The port's engine with n-gram self-speculation at the JAX defaults
(draft "auto" -> "ngram", n_draft 4, spec_ngram 3) against the JAX Engine
at ITS defaults, on the CPU, over f32 models (the tests/tinymodel.py
checkpoint, and the ``_cfg()`` model of the JAX package's spec tests):

  * a staggered script (max_tokens 37 and 23, an EOS and a stop string
    inside a spec tick, a next turn reusing a finished request's rows, a
    request that shifts its context twice at max_context 128), request
    by request, on paged, int8 KV, contiguous, int8 weights + int8 KV and
    int4 weights: greedy tokens, finish reasons, completion_tokens and
    reused rows equal; every slot's ``_cache_tokens`` equals the JAX
    Engine's (no rejected row is ever kept), no page in use at the end;
  * one request alone, the spec counters after each processed tick equal
    the JAX Engine's;
  * "abab abab ab" speculates (rounds > 0) with the JAX tokens; the spec
    metrics have the JAX keys;
  * a mixed tick (a greedy slot, a repeat-penalty slot, a sampled slot):
    mixed_dispatches > 0, the greedy stream equals the JAX Engine's, the
    repeat-penalty slot's (a plain row) the port's own ``draft="0"``
    stream, and the sampled slot takes rejection-sampled rounds;
  * the host tier on: the host-tier script of tests/test_torch_host_tier.py
    with speculation on both sides: requests and host counters equal;
  * a high arrival pausing a speculating low slot: the tokens before the
    pause equal the unpaused run's, those after a fresh engine's on the
    prompt + the tokens before the pause (the JAX test's gate, on f32);
  * cancel with a spec tick in flight; a stalled spec tick aborting only
    its request; fork siblings speculating;
  * the runner and CLI options (``draft``, ``n_draft``, ``spec_ngram``)
    and the refusals before any weight is loaded (a draft model dir that
    is missing, config-only without a seed, or a GGUF file that does not
    parse; an unknown draft word, a negative n_draft).
"""

from __future__ import annotations

import tests.torch_cpu  # noqa: F401  (one torch CPU thread)

import json
import os
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localai_tpu.engine import engine as jeng
from localai_tpu.engine import sampling as jsamp
from localai_tpu.engine import weights as jweights
from localai_tpu.models import llama as jllama
from localai_tpu.services.faults import FAULTS as JFAULTS
from localai_tpu_torch.engine import engine as teng
from localai_tpu_torch.engine import sampling as tsamp
from localai_tpu_torch.engine import weights as tweights
from localai_tpu_torch.models import llama as tllama
from localai_tpu_torch.services.faults import FAULTS
from tests import test_torch_host_tier as ht
from tests import test_torch_scheduler as sch
from tests.conftest import ByteTokenizer

S, C, PG = 4, 128, 16
EC = dict(num_slots=S, max_context=C, prefill_buckets=(8, 16, 32),
          prefill_chunk=32, kv_page_size=PG)
# (port knobs, JAX cache dtype, JAX layout, weight bits)
CONFIGS = {"paged": ({}, jnp.float32, "paged", 0),
           "int8": ({"cache_dtype": torch.int8}, jnp.int8, "paged", 0),
           "contig": ({"kv_layout": "contiguous"}, jnp.float32, "contiguous", 0),
           "w8kv8": ({"cache_dtype": torch.int8}, jnp.int8, "paged", 8),
           "w4": ({}, jnp.float32, "paged", 4)}
SPEC_KEYS = ("dispatches", "mixed_dispatches", "rounds", "proposed",
             "accepted", "tokens")


class _Tok:
    def __init__(self, eos: int = 1):
        self.eos_token_id = eos

    def decode(self, ids, **kw):
        return "".join(chr(97 + (i % 26)) for i in ids)


@pytest.fixture(autouse=True)
def _clean_faults():
    FAULTS.reset()
    JFAULTS.reset()
    yield
    FAULTS.reset()
    JFAULTS.reset()


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """(JAX config, JAX params, port config, port params, checkpoint dir)."""
    from tests.tinymodel import write_tiny_checkpoint

    d = str(tmp_path_factory.mktemp("tiny_spec_engine"))
    write_tiny_checkpoint(d)
    with open(os.path.join(d, "config.json")) as f:
        hf = json.load(f)
    jcfg = jllama.LlamaConfig.from_hf_config(hf, dtype=jnp.float32)
    jparams = jweights.load_llama_params(d, jcfg, dtype=jnp.float32)
    tcfg = tllama.LlamaConfig.from_hf_config(hf, dtype=torch.float32)
    tparams = tweights.from_jax_params(jax.tree.map(np.asarray, jparams),
                                       tcfg, device="cpu")
    return jcfg, jparams, tcfg, tparams, d


def _params(tiny, bits):
    jcfg, jparams, tcfg, tparams, _d = tiny
    if not bits:
        return jparams, tparams
    jq = jllama.quantize_params(jparams, bits=bits)
    return jq, tweights.from_jax_params(jax.tree.map(np.asarray, jq), tcfg,
                                        device="cpu")


def jax_engine(tiny, config="paged", eos=1, start=True, **knobs):
    jcfg, *_ = tiny
    _k, dtype, lay, bits = CONFIGS[config]
    je = jeng.Engine(jcfg, _params(tiny, bits)[0], _Tok(eos), jeng.EngineConfig(
        **{**EC, **knobs}, cache_dtype=dtype, kv_layout=lay))
    if start:
        je.start()
    return je


def port_engine(tiny, config="paged", eos=1, start=True, **knobs):
    tcfg = tiny[2]
    k, _dt, _lay, bits = CONFIGS[config]
    e = teng.Engine(tcfg, _params(tiny, bits)[1], _Tok(eos), teng.EngineConfig(
        **{**EC, **knobs}, **k), device="cpu")
    return e.start() if start else e


def submit(e, prompt, n, stop=(), ignore_eos=True, rid="", **params):
    mod, samp = (teng, tsamp) if isinstance(e, teng.Engine) else (jeng, jsamp)
    return e.submit(mod.GenRequest(
        prompt_ids=list(prompt), max_new_tokens=n, ignore_eos=ignore_eos,
        stop_sequences=list(stop), request_id=rid,
        params=samp.SamplingParamsHost(**{"temperature": 0.0, **params})))


def drain(out, first=None) -> dict:
    ids, fin, ct, reused, errs = [], None, 0, None, []
    while (ev := first or out.get(timeout=600)) is not None:
        first = None
        if ev.error:
            errs.append(ev.error_kind or ev.error)
        ids.extend(ev.token_ids or ([ev.token_id] if ev.token_id >= 0 else []))
        fin, ct = ev.finish_reason or fin, ev.completion_tokens
        if ev.timings:
            reused = ev.timings["reused_prompt_tokens"]
    return {"ids": ids, "finish": fin, "completion_tokens": ct,
            "reused": reused, "errors": errs}


def draw(rng, n) -> list:
    return rng.integers(2, 258, size=n).tolist()


def spec_counts(e) -> dict:
    st = e.metrics()["spec"]
    return {k: st[k] for k in SPEC_KEYS}


@pytest.fixture(scope="module")
def plan(tiny):
    """The script's prompts (two repetitive, so proposals get accepted),
    and an EOS id / stop string that land inside a spec tick: from free
    greedy runs on the port at its defaults (the comparison below holds
    it to the JAX Engine)."""
    rng = np.random.default_rng(5)
    p = {"a": [11, 12, 13, 14, 15] * 8, "b": draw(rng, 70), "c": draw(rng, 9),
         "turn": draw(rng, 13), "shift": [20, 21, 22] * 10}
    e = port_engine(tiny)
    try:
        stream = drain(submit(e, p["c"], 45))
        text = _Tok().decode(stream["ids"])
        p["stop"] = text[22:26]
        for seed in range(100):
            prompt = draw(np.random.default_rng(100 + seed), 20)
            ids = drain(submit(e, prompt, 40))["ids"]
            k = next((k for k in range(17, 31) if ids[k] not in ids[:k]), None)
            if k is not None:
                p["eos_prompt"], p["eos"], p["eos_at"] = prompt, ids[k], k + 1
                break
    finally:
        e.shutdown()
    assert "eos" in p, "no prompt puts a new token at 16 < k < 32"
    return p


def script(e, p) -> list:
    firsts, outs = [], []
    for prompt, n, stop, ign in ((p["a"], 37, (), True), (p["b"], 23, (), True),
                                 (p["eos_prompt"], 40, (), False),
                                 (p["c"], 45, (p["stop"],), True)):
        outs.append(submit(e, prompt, n, stop=stop, ignore_eos=ign))
        firsts.append(outs[-1].get(timeout=600))
    res = [drain(o, first=f) for o, f in zip(outs, firsts)]
    res.append(drain(submit(e, p["a"] + res[0]["ids"] + p["turn"], 19)))
    res.append(drain(submit(e, p["shift"], 200)))
    return res


def script_prompts(p, res) -> list:
    """The prompts ``script`` sent, in its order."""
    return [p["a"], p["b"], p["eos_prompt"], p["c"],
            p["a"] + res[0]["ids"] + p["turn"], p["shift"]]


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def scripted(request, tiny, plan):
    config = request.param
    out = {"config": config}
    for name, make in (("jax", jax_engine), ("port", port_engine)):
        e = make(tiny, config, plan["eos"])
        try:
            out[name] = script(e, plan)
            out["prompts"] = script_prompts(plan, out[name])
            if name == "port":
                e._offloader.join()
            out[name + "_metrics"] = e.metrics()
            out[name + "_cache_tokens"] = [list(t) for t in e._cache_tokens]
        finally:
            e.shutdown()
    return out


KEYS = ("ids", "finish", "completion_tokens", "reused")


def test_script_equals_the_jax_engine_request_by_request(scripted, plan):
    port, ref = scripted["port"], scripted["jax"]
    for i, (got, want) in enumerate(zip(port, ref)):
        for key in KEYS:
            assert got[key] == want[key], (scripted["config"], i, key)
        assert not got["errors"]
    # what the script meant to exercise really happened (the EOS and the
    # stop string come from the float weights' streams)
    assert [r["completion_tokens"] for r in port[:2]] == [37, 23]
    if not CONFIGS[scripted["config"]][3]:
        assert port[2]["finish"] == "stop"
        assert port[2]["completion_tokens"] == plan["eos_at"]
        assert port[3]["finish"] == "stop" and port[3]["completion_tokens"] < 45
    assert port[4]["reused"] > len(plan["a"])
    assert port[5]["completion_tokens"] == 200
    m = scripted["port_metrics"]
    assert m["spec"]["mode"] == "ngram" and m["spec"]["rounds"] > 0
    assert m["spec"]["accepted"] > 0 and m["decode"]["spec_ticks"] > 0
    assert m["spec"]["by_mode"]["sampled"]["rounds"] == 0
    assert m["active_slots"] == 0 and m["pipeline"]["inflight"] == 0
    if scripted["config"] != "contig":
        assert m["pages_in_use"] == 0


def test_cache_tokens_equal_the_jax_engine(scripted):
    """Each slot keeps exactly the JAX Engine's token history: the rows a
    rejected proposal wrote are never among the rows a slot keeps (turn
    2's reuse above then reads only committed rows), slot for slot up to
    which free slot keeps which history. Each kept history is also held
    to the streams: a run of one request's prompt + tokens that stops
    before its last token (whose row no step wrote). On the contiguous
    layout the two engines may seat a request in another free slot of
    equal reuse (a slot's rows are overwritten in place), so there only
    the second holds."""
    port, ref = scripted["port_cache_tokens"], scripted["jax_cache_tokens"]
    if scripted["config"] != "contig":
        # which free slot keeps which history may differ (a reclaim
        # forgets free slots' tokens, and ties pick the first)
        assert sorted(map(tuple, port)) == sorted(map(tuple, ref))
    streams = [tuple(p + r["ids"][:-1]) for p, r in zip(
        scripted["prompts"], scripted["port"])]
    for hist in port:
        n = len(hist)
        assert n == 0 or any(tuple(hist) == s[i:i + n] for s in streams
                             for i in range(len(s) - n + 1)), hist


def test_spec_counters_equal_jax_tick_by_tick(tiny):
    """One greedy request alone: after every processed tick, the spec
    counters the tick folds (rounds, proposed, accepted, tokens) equal the
    JAX Engine's; at the end the dispatch counts too (those count at
    dispatch, which each loop reaches at its own pace)."""
    prompt = [30, 31, 32, 33] * 6
    seen = {}
    for name, make in (("jax", jax_engine), ("port", port_engine)):
        e = make(tiny, start=False)
        snaps = []
        proc = e._process_burst

        def spy(b, proc=proc, e=e, snaps=snaps):
            out = proc(b)
            st = spec_counts(e)
            snaps.append({k: st[k] for k in SPEC_KEYS[2:]})
            return out

        e._process_burst = spy
        e.start()
        try:
            seen[name] = (drain(submit(e, prompt, 60))["ids"], snaps,
                          spec_counts(e))
        finally:
            e.shutdown()
    assert seen["port"][0] == seen["jax"][0]
    assert seen["port"][1] == seen["jax"][1]
    assert seen["port"][2] == seen["jax"][2]           # dispatches too, at the end
    assert seen["port"][1][-1]["rounds"] > 0 and seen["port"][1][-1]["accepted"] > 0


def _cfg_models():
    """The JAX spec tests' _cfg() f32 model (vocab 258, hidden 64)."""
    jcfg = jllama.LlamaConfig(
        vocab_size=258, hidden_size=64, intermediate_size=128, num_layers=2,
        num_heads=4, num_kv_heads=2, max_position_embeddings=256,
        dtype=jnp.float32)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    tcfg = tllama.LlamaConfig(
        vocab_size=258, hidden_size=64, intermediate_size=128, num_layers=2,
        num_heads=4, num_kv_heads=2, max_position_embeddings=256,
        dtype=torch.float32)
    tparams = tweights.from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                                       device="cpu")
    return jcfg, jparams, tcfg, tparams


CFG_EC = dict(max_context=128, prefill_buckets=(16, 32), prefill_chunk=32)


def _cfg_engine(models, port: bool, slots=2, **kw):
    jcfg, jparams, tcfg, tparams = models
    if port:
        return teng.Engine(tcfg, tparams, ByteTokenizer(), teng.EngineConfig(
            num_slots=slots, **CFG_EC, **kw), device="cpu").start()
    je = jeng.Engine(jcfg, jparams, ByteTokenizer(), jeng.EngineConfig(
        num_slots=slots, **CFG_EC, cache_dtype=jnp.float32, **kw))
    je.start()
    return je


def test_repetitive_prompt_speculates_with_the_jax_tokens():
    models = _cfg_models()
    prompt = ByteTokenizer().encode("abab abab ab")
    got = {}
    for port in (False, True):
        e = _cfg_engine(models, port)
        try:
            got[port] = (drain(submit(e, prompt, 24))["ids"], e.metrics()["spec"])
        finally:
            e.shutdown()
    assert got[True][0] == got[False][0]
    assert got[True][1]["rounds"] > 0
    # the JAX metrics' keys, nested ones included
    for a, b in ((got[True][1], got[False][1]),
                 (got[True][1]["by_mode"]["greedy"], got[False][1]["by_mode"]["greedy"])):
        assert set(a) == set(b)
    assert {k: got[True][1][k] for k in SPEC_KEYS} == \
        {k: got[False][1][k] for k in SPEC_KEYS}


def test_mixed_tick_greedy_equals_jax_sampled_equals_plain():
    """A greedy slot and a pure sampled slot speculate while a
    repeat-penalty slot rides the same ticks as a plain row (decode_burst
    4, so the streams interleave tick by tick): mixed_dispatches > 0; the
    greedy stream is the JAX Engine's; the repeat-penalty stream is byte
    for byte what the port gives with speculation off, for the same seed;
    the pure sampled slot takes rejection-sampled rounds."""
    models = _cfg_models()
    tok = ByteTokenizer()
    prompt = "the rain in spain falls mainly on the plain on the plain"
    reqs = [(tok.encode(prompt), {}),
            (tok.encode("something else entirely"),
             {"temperature": 1.0, "seed": 7, "repeat_penalty": 1.1}),
            (tok.encode("a sampled stream"), {"temperature": 0.9, "seed": 11})]

    def run(e):
        outs = [submit(e, p, 32, **kw) for p, kw in reqs]
        return [drain(o)["ids"] for o in outs]

    runs = {}
    for name, port, kw in (("jax", False, {}), ("port", True, {}),
                           ("plain", True, {"draft": "0"})):
        e = _cfg_engine(models, port, slots=4, decode_burst=4, **kw)
        try:
            runs[name] = (run(e), e.metrics()["spec"])
        finally:
            e.shutdown()
    (port, st), (plain, pst), (jax_ids, _j) = runs["port"], runs["plain"], runs["jax"]
    assert port[0] == jax_ids[0]
    assert port[1] == plain[1] and all(len(x) == 32 for x in port)
    assert st["mixed_dispatches"] > 0 and st["rounds"] > 0
    assert st["by_mode"]["greedy"]["rounds"] > 0
    assert st["by_mode"]["sampled"]["rounds"] > 0
    assert (st["by_mode"]["greedy"]["rounds"] + st["by_mode"]["sampled"]["rounds"]
            == st["rounds"])
    assert 1.0 <= st["accept_per_dispatch"] and 0.0 <= st["acceptance_rate"] <= 1.0
    assert pst["mode"] == "off" and pst["dispatches"] == 0


def test_host_tier_with_speculation_equals_jax(tiny):
    """tests/test_torch_host_tier.py's script (a turn, a wave that evicts
    it to the host tier, the next turn restoring it, twice) with
    speculation on both sides: requests, reused rows and the host tier's
    counters after each step equal the JAX Engine's."""
    got = {}
    for name, make in (("port", ht.port_engine), ("jax", ht.jax_engine)):
        # a spec slot asks for R * W rows ahead: the JAX Engine needs one
        # more page than the plain script's 20 to run its wave. With 21
        # each wave needs the whole pool whatever the JAX loop has in
        # flight on the CPU, so both turns restore their whole chain; at
        # 22 to 28 the pages a wave evicts hang on that timing
        e = make(tiny, "float32", draft="auto", kv_pool_pages=21)
        try:
            got[name] = ht.run_script(e)
            got[name + "_m"] = e.metrics()
        finally:
            e.shutdown()
    (res, cnt), (jres, jcnt) = got["port"], got["jax"]
    assert res == jres
    assert cnt == jcnt
    assert cnt[-1]["offloaded_pages"] > 0 and cnt[-1]["restores"] == 2
    assert got["port_m"]["spec"]["rounds"] > 0 and got["port_m"]["pages_in_use"] == 0


def test_paused_speculating_slot_resumes_exactly(tiny):
    """The JAX test's gate on f32: a low greedy request speculates, a high
    arrival pauses it after k >= 5 tokens; its first k tokens equal the
    unpaused run's and the rest equal a fresh engine's continuation of the
    prompt + those k tokens; both streams complete."""
    t4 = tiny[:4]
    prompt = [40, 41, 42, 43, 44] * 6
    ref = sch._started(sch.port_engine(t4, draft="auto"))
    try:
        base = sch._ids(ref, prompt, 48, "low")
        assert ref.metrics()["spec"]["rounds"] > 0
    finally:
        ref.shutdown()
    e = sch.port_engine(t4, draft="auto")
    try:
        low, _high, k, _st = sch._preempt_resume_round(e, prompt, 48)
        assert e.metrics()["spec"]["rounds"] > 0
        assert e.metrics()["pages_in_use"] == 0
    finally:
        e.shutdown()
    assert 5 <= k < 48 and len(low) == 48
    assert low[:k] == base[:k]
    fresh = sch._started(sch.port_engine(t4, draft="auto"))
    try:
        cont = sch._ids(fresh, prompt + low[:k], 48 - k, "low")
    finally:
        fresh.shutdown()
    assert low[k:] == cont


def test_cancel_with_a_spec_tick_in_flight(tiny):
    """A request cancelled with two spec ticks in flight: its stream is a
    prefix of the JAX Engine's, its slot keeps only the rows whose write
    ran (never a rejected proposal's), the in-flight rounds are dropped,
    and a next turn over the kept rows gives the JAX Engine's tokens."""
    prompt, extra = [50, 51, 52] * 12, draw(np.random.default_rng(9), 6)
    je = jax_engine(tiny)
    try:
        full = drain(submit(je, prompt, 90))["ids"]
    finally:
        je.shutdown()
    e = port_engine(tiny, start=False)
    out = submit(e, prompt, 90)
    for _ in range(3):
        assert e._tick()
    assert e._dispatch_decode()
    ticks = [b for b in e._fifo if isinstance(b, teng._Burst)]
    assert len(ticks) == 2 and all(b.spec_width for b in ticks)
    slot = next(i for i, s in enumerate(e.slots) if s is not None)
    e.cancel(e.slots[slot].req.request_id)
    e._reap_cancelled()
    assert e.slots[slot] is None
    while e._tick():
        pass
    got = drain(out)
    assert got["finish"] is None and 0 < len(got["ids"]) < 90
    assert got["ids"] == full[:len(got["ids"])]
    assert e._cache_tokens[slot] == prompt + got["ids"][:-1]
    m = e.metrics()
    assert m["pipeline"]["dropped_steps"] > 0 and m["pages_in_use"] == 0
    follow = prompt + got["ids"][:-1] + extra
    e.start()
    try:
        turn = drain(submit(e, follow, 7))
    finally:
        e.shutdown()
    je = jax_engine(tiny)
    try:
        want = drain(submit(je, follow, 7))
    finally:
        je.shutdown()
    assert turn["reused"] == len(prompt) + len(got["ids"]) - 1
    assert turn["ids"] == want["ids"]


def test_stalled_spec_tick_aborts_only_its_request(tiny):
    """A spec tick whose results land 1.5 s late (bound 200 ms): the
    speculating request in it alone gets a "stall" event; a request whose
    prompt was prefilling meanwhile keeps the JAX Engine's tokens; a later
    request gets the same tokens as before the stall."""
    survivor = draw(np.random.default_rng(3), 50)
    je = jax_engine(tiny)
    try:
        want_s = drain(submit(je, survivor, 12))["ids"]
    finally:
        je.shutdown()
    e = port_engine(tiny, start=False, dispatch_stall_ms=200)
    out_v = submit(e, [60, 61, 62] * 8, 40)
    for _ in range(50):
        e._tick()
        if any(isinstance(b, teng._Burst) and b.spec_width for b in e._fifo):
            break
    e._drain_all()
    assert e.slots[0] is not None and e.slots[0].phase == "decode"
    assert e.slots[0].spec_ok
    FAULTS.arm("sync_delay_ms", "1500", count=1)
    out_s = submit(e, survivor, 12)
    e.start()
    try:
        v, s = drain(out_v), drain(out_s)
        assert v["errors"] == ["stall"]
        assert not s["errors"] and s["ids"] == want_s
        m = e.metrics()
        assert m["lifecycle"]["stalls"] == 1 and m["spec"]["rounds"] > 0
        again = drain(submit(e, survivor, 12))
        assert again["ids"] == want_s
        assert e.metrics()["pages_in_use"] == 0
    finally:
        e.shutdown()


def test_fork_siblings_speculate_with_the_jax_tokens(tiny):
    """Two identical greedy requests admitted together prefill once (the
    second forks the first's rows) and both speculate: tokens equal the
    JAX Engine's for both."""
    prompt = [70, 71, 72, 73] * 7
    got = {}
    for name, make in (("jax", jax_engine), ("port", port_engine)):
        e = make(tiny, start=False)
        outs = [submit(e, prompt, 30, rid=f"r{i}") for i in range(2)]
        e.start()
        try:
            got[name] = [drain(o)["ids"] for o in outs]
            got[name + "_m"] = e.metrics()
        finally:
            e.shutdown()
    assert got["port"] == got["jax"] and got["port"][0] == got["port"][1]
    m = got["port_m"]
    assert m["fork"]["forked"] == 1 and m["spec"]["rounds"] > 0


def test_spec_knobs_runner_cli_and_refusals(tmp_path, monkeypatch):
    from localai_tpu_torch.backend import runner
    from localai_tpu_torch.cli import build_parser

    with open(tmp_path / "config.json", "w") as f:
        json.dump({"architectures": ["LlamaForCausalLM"], "model_type": "llama",
                   "vocab_size": 64, "hidden_size": 32, "intermediate_size": 64,
                   "num_hidden_layers": 1, "num_attention_heads": 4,
                   "num_key_value_heads": 2}, f)
    kw = dict(random_weights=0, device="cpu", dtype="float32", num_slots=2,
              context_size=64, kv_page_size=16, prefill_chunk=16)
    for opts, mode, width in (({}, "ngram", 5),
                              ({"draft": " NGRAM ", "n_draft": "2",
                                "spec_ngram": 2}, "ngram", 3),
                              ({"draft": "model"}, "off", 0),
                              ({"draft": "0"}, "off", 0),
                              ({"n_draft": 0}, "off", 0)):
        lm = runner.load_model(str(tmp_path), **kw, **opts)
        try:
            e = lm.engine
            assert e._spec_mode == mode and e._spec_width == width
            assert e.metrics()["spec"]["mode"] == mode
        finally:
            lm.engine.shutdown()

    def no_load(*a, **k):
        raise AssertionError("weights read before the knob was checked")

    monkeypatch.setattr(runner.weights, "random_params", no_load)
    monkeypatch.setattr(runner.weights, "load_llama_params", no_load)
    # a draft model dir that is missing, config-only without a seed, or
    # GGUF is refused before any weight is read
    with pytest.raises(FileNotFoundError, match="draft_model"):
        runner.load_model(str(tmp_path), draft_model="/some/draft", **kw)
    (tmp_path / "d").mkdir()
    with open(tmp_path / "d" / "config.json", "w") as f:
        json.dump({"vocab_size": 64, "hidden_size": 16, "intermediate_size": 32,
                   "num_hidden_layers": 1, "num_attention_heads": 2}, f)
    with pytest.raises(FileNotFoundError, match="random_weights"):
        runner.load_model(str(tmp_path), draft_model="d",
                          **{**kw, "random_weights": None})
    # a GGUF draft dir's config comes from the file: one that does not
    # parse raises (the JAX reader's struct.error) before any weight is read
    (tmp_path / "d" / "draft.gguf").write_bytes(b"GGUF")
    with pytest.raises(struct.error):
        runner.load_model(str(tmp_path), draft_model="d", **kw)
    for bad, word in (({"draft": "medusa"}, "draft"), ({"n_draft": -1}, "n_draft"),
                      ({"spec_ngram": 0}, "spec_ngram"),
                      ({"n_draft": "four"}, "n_draft")):
        with pytest.raises(ValueError, match=word):
            runner.load_model(str(tmp_path), **kw, **bad)
    with pytest.raises(ValueError, match="draft"):
        teng.EngineConfig(draft="medusa").check()
    for ok in ("auto", "model", "ngram", "0", "off", "none", "false"):
        teng.EngineConfig(draft=ok).check()
    args = build_parser().parse_args(["run", "--model", str(tmp_path),
                                      "--draft", "0", "--n-draft", "2",
                                      "--spec-ngram", "4"])
    assert (args.draft, args.n_draft, args.spec_ngram) == ("0", 2, 4)
    d = build_parser().parse_args(["run", "--model", str(tmp_path)])
    assert (d.draft, d.n_draft, d.spec_ngram) == ("auto", 4, 3)
