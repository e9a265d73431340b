"""The port's pipelined engine loop (pipeline_depth 2, the split fused tick)
against the JAX Engine at ITS defaults (pipeline_depth 2,
prefill_packed_fuse "auto"; kv_offload off, no draft), on the CPU, over
the tiny f32 checkpoint (tests/tinymodel.py), paged, int8 KV and
contiguous. On the CPU a dispatch has finished when it returns, but the
loop processes it by the same FIFO rule as on the card, so a slot that
finishes in burst N has already ridden burst N+1 here too.

  * a scripted mix, request by request (greedy tokens, finish reasons,
    completion_tokens, reused_prompt_tokens): staggered arrivals (each
    request submitted once the one before streams), max_tokens that are
    not multiples of 16, a request that ends on EOS inside its second
    burst, one that ends on a stop sequence inside a burst, a next turn
    that reuses a finished request's rows and one that shifts its context
    twice at max_context 128 with the next burst in flight; the same
    script on the port at pipeline_depth 1 with prefill_packed_fuse "0"
    (the synchronous loop), and at "1", gives the same results; no page
    stays in use at idle;
  * a request cancelled with two bursts in flight: its stream is a prefix
    of the JAX Engine's, its slot keeps only the rows whose write ran, the
    in-flight steps are dropped, and a next turn over the kept rows gives
    the JAX Engine's tokens;
  * a prefill_packed_fuse outside the JAX set, or a pipeline_depth below
    1, is refused where the port takes its engine knobs, before any
    weight is loaded (as the JAX model config refuses the first).
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

S, C, PG = 4, 128, 16
EC = dict(num_slots=S, max_context=C, prefill_buckets=(8, 16, 32),
          prefill_chunk=32, kv_page_size=PG)
# (port knobs, JAX cache dtype, JAX layout)
LAYOUTS = {"paged": ({}, jnp.float32, "paged"),
           "int8": ({"cache_dtype": torch.int8}, jnp.int8, "paged"),
           "contig": ({"kv_layout": "contiguous"}, jnp.float32, "contiguous")}
SYNC = dict(pipeline_depth=1, prefill_packed_fuse="0")


class _Tok:
    def __init__(self, eos: int = 1):
        self.eos_token_id = eos

    def decode(self, ids, **kw):
        return "".join(chr(97 + (i % 26)) for i in ids)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    from tests.tinymodel import write_tiny_checkpoint

    d = str(tmp_path_factory.mktemp("tiny_pipeline"))
    write_tiny_checkpoint(d)
    with open(os.path.join(d, "config.json")) as f:
        hf = json.load(f)
    jcfg = jllama.LlamaConfig.from_hf_config(hf, dtype=jnp.float32)
    jparams = jweights.load_llama_params(d, jcfg, dtype=jnp.float32)
    tcfg = tllama.LlamaConfig.from_hf_config(hf, dtype=torch.float32)
    tparams = tweights.from_jax_params(jax.tree.map(np.asarray, jparams),
                                       tcfg, device="cpu")
    return jcfg, jparams, tcfg, tparams


def jax_engine(tiny, layout, eos=1):
    jcfg, jparams, _tc, _tp = tiny
    _tk, dtype, lay = LAYOUTS[layout]
    je = jeng.Engine(jcfg, jparams, _Tok(eos), jeng.EngineConfig(
        **EC, cache_dtype=dtype, kv_layout=lay, kv_offload=False, draft="0"))
    je.start()
    return je


def port_engine(tiny, layout, eos=1, start=True, **knobs):
    _jc, _jp, tcfg, tparams = tiny
    e = teng.Engine(tcfg, tparams, _Tok(eos), teng.EngineConfig(
        **EC, decode_burst=16, kv_offload=False, draft="0",
        **LAYOUTS[layout][0], **knobs), device="cpu")
    return e.start() if start else e


def submit(e, prompt, n, stop=(), ignore_eos=True):
    mod, samp = (teng, tsamp) if isinstance(e, teng.Engine) else (jeng, jsamp)
    return e.submit(mod.GenRequest(
        prompt_ids=list(prompt), max_new_tokens=n, ignore_eos=ignore_eos,
        stop_sequences=list(stop),
        params=samp.SamplingParamsHost(temperature=0.0)))


def drain(out, first=None) -> dict:
    ids, fin, ct, reused, text = [], None, 0, None, ""
    while (ev := first or out.get(timeout=600)) is not None:
        first = None
        assert not ev.error, ev.error
        ids.extend(ev.token_ids or ([ev.token_id] if ev.token_id >= 0 else []))
        text += ev.text
        fin, ct = ev.finish_reason or fin, ev.completion_tokens
        if ev.timings:
            reused = ev.timings["reused_prompt_tokens"]
    return {"ids": ids, "finish": fin, "completion_tokens": ct,
            "reused": reused, "text": text}


def draw(rng, n) -> list:
    return rng.integers(2, 258, size=n).tolist()


@pytest.fixture(scope="module")
def plan(tiny):
    """The script's prompts, and what makes its EOS and stop land inside a
    burst: from free greedy runs on the port (the comparison below holds
    it to the JAX Engine), an EOS id whose first appearance in some
    prompt's stream is token k, 16 < k < 32, and a stop string from the
    middle of another stream."""
    rng = np.random.default_rng(5)
    p = {"a": draw(rng, 40), "b": draw(rng, 70), "c": draw(rng, 9),
         "turn": draw(rng, 13), "shift": draw(rng, 30)}
    e = port_engine(tiny, "paged")
    try:
        stream = drain(submit(e, p["c"], 45))
        p["stop"] = stream["text"][22:26]
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
    """Staggered arrivals: each request is submitted once the one before
    has streamed its first event; then a next turn of the first, then a
    request that shifts its context twice."""
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


@pytest.fixture(scope="module", params=sorted(LAYOUTS))
def scripted(request, tiny, plan):
    layout = request.param
    out = {"layout": layout}
    je = jax_engine(tiny, layout, plan["eos"])
    try:
        out["jax"] = script(je, plan)
    finally:
        je.shutdown()
    for name, knobs in (("port", {}), ("sync", SYNC),
                        ("mono", {"prefill_packed_fuse": "1"})):
        e = port_engine(tiny, layout, plan["eos"], **knobs)
        shifts = []
        shift = e._context_shift

        def spy(slot, s, token_id, shift=shift, e=e, shifts=shifts):
            shifts.append(e._n_inflight())   # bursts still in flight
            return shift(slot, s, token_id)

        e._context_shift = spy
        try:
            out[name] = script(e, plan)
            out[name + "_metrics"] = e.metrics()
            out[name + "_shifts"] = shifts
        finally:
            e.shutdown()
    return out


KEYS = ("ids", "finish", "completion_tokens", "reused")


def test_script_equals_the_jax_engine_request_by_request(scripted, plan):
    port, ref = scripted["port"], scripted["jax"]
    for i, (got, want) in enumerate(zip(port, ref)):
        for key in KEYS:
            assert got[key] == want[key], (scripted["layout"], i, key)
    # what the script meant to exercise really happened
    assert [r["completion_tokens"] for r in port[:2]] == [37, 23]
    assert port[2]["finish"] == "stop" and port[2]["completion_tokens"] == plan["eos_at"]
    assert port[3]["finish"] == "stop" and port[3]["completion_tokens"] < 45
    assert port[3]["completion_tokens"] % 16 != 0
    assert port[4]["reused"] > len(plan["a"])
    assert port[5]["completion_tokens"] == 200
    m = scripted["port_metrics"]
    assert m["pipeline"]["depth"] == 2 and m["pipeline"]["fuse"] == "split"
    assert m["pipeline"]["max_inflight"] == 2
    assert m["pipeline"]["head_emits"] > 0 and m["pipeline"]["dropped_steps"] > 0


@pytest.mark.parametrize("way", ("sync", "mono"))
def test_sync_loop_equals_the_pipelined_one(scripted, way):
    """pipeline_depth 1 with prefill_packed_fuse "0" (each pack and burst
    waited for in its own tick), and the defaults' depth with "1" (a fused
    tick's first tokens emitted with its burst): the same results."""
    for got, want in zip(scripted[way], scripted["port"]):
        for key in KEYS:
            assert got[key] == want[key], (scripted["layout"], way, key)
    m = scripted[way + "_metrics"]["pipeline"]
    assert m["head_emits"] == 0
    assert m["max_inflight"] == (1 if way == "sync" else 2)


def test_shift_with_the_next_burst_in_flight(scripted):
    """The shifting request shifted twice, each time while processing a
    burst with the next one in flight (the pipelined loop), and once a
    burst at a time in the synchronous loop."""
    assert len(scripted["port_shifts"]) == 2
    assert all(n >= 1 for n in scripted["port_shifts"])
    assert scripted["sync_shifts"] == [0, 0]


def test_no_page_in_use_at_idle(scripted):
    for name in ("port", "sync", "mono"):
        m = scripted[name + "_metrics"]
        assert m["active_slots"] == 0 and m["pipeline"]["inflight"] == 0
        if scripted["layout"] != "contig":
            assert m["pages_in_use"] == 0


@pytest.mark.parametrize("layout", ("paged", "contig"))
def test_cancel_with_two_bursts_in_flight(tiny, layout):
    rng = np.random.default_rng(9)
    prompt, extra = draw(rng, 37), draw(rng, 6)
    je = jax_engine(tiny, layout)
    try:
        full = drain(submit(je, prompt, 90))["ids"]
    finally:
        je.shutdown()
    e = port_engine(tiny, layout, start=False)
    out = submit(e, prompt, 90)
    for _ in range(3):
        assert e._tick()
    assert e._dispatch_decode()              # now two bursts are in flight
    assert e._n_inflight() == 2
    slot = next(i for i, s in enumerate(e.slots) if s is not None)
    e.cancel(e.slots[slot].req.request_id)
    e._reap_cancelled()
    assert e.slots[slot] is None
    while e._tick():
        pass
    got = drain(out)
    assert got["finish"] is None and 0 < len(got["ids"]) < 90
    assert got["ids"] == full[:len(got["ids"])]
    # every emitted token but the last has its row; the in-flight steps
    # (2 x 16) were computed and dropped
    assert e._cache_tokens[slot] == prompt + got["ids"][:-1]
    m = e.metrics()
    assert m["pipeline"]["dropped_steps"] >= 32 and m["active_slots"] == 0
    if layout == "paged":
        assert m["pages_in_use"] == 0
    follow = prompt + got["ids"][:-1] + extra
    e.start()
    try:
        turn = drain(submit(e, follow, 7))
    finally:
        e.shutdown()
    je = jax_engine(tiny, layout)
    try:
        want = drain(submit(je, follow, 7))
    finally:
        je.shutdown()
    assert turn["reused"] == len(prompt) + len(got["ids"]) - 1
    assert turn["ids"] == want["ids"]


def test_loop_knobs_are_refused_before_loading(tmp_path, monkeypatch):
    from localai_tpu_torch.backend import runner
    from localai_tpu_torch.cli import build_parser

    with open(tmp_path / "config.json", "w") as f:
        json.dump({"architectures": ["LlamaForCausalLM"], "model_type": "llama",
                   "vocab_size": 64, "hidden_size": 32, "intermediate_size": 64,
                   "num_hidden_layers": 1, "num_attention_heads": 4,
                   "num_key_value_heads": 2}, f)

    def no_load(*a, **k):
        raise AssertionError("weights read before the knob was checked")

    monkeypatch.setattr(runner.weights, "random_params", no_load)
    monkeypatch.setattr(runner.weights, "load_llama_params", no_load)
    for knobs, word in (({"prefill_packed_fuse": "both"}, "prefill_packed_fuse"),
                        ({"prefill_packed_fuse": "mono"}, "prefill_packed_fuse"),
                        ({"pipeline_depth": 0}, "pipeline_depth"),
                        ({"pipeline_depth": "2"}, "pipeline_depth")):
        with pytest.raises(ValueError, match=word):
            runner.load_model(str(tmp_path), random_weights=0, device="cpu",
                              dtype="float32", **knobs)
        with pytest.raises(ValueError, match=word):
            teng.EngineConfig(**knobs).check()
    for ok in ("auto", "0", "1", "split"):
        teng.EngineConfig(prefill_packed_fuse=ok).check()
    args = build_parser().parse_args(["run", "--model", str(tmp_path),
                                      "--pipeline-depth", "1",
                                      "--prefill-packed-fuse", "0"])
    assert args.pipeline_depth == 1 and args.prefill_packed_fuse == "0"
