"""The PyTorch port's serving engine against the JAX Engine, on the CPU,
plus the port's packaging rules.

  * greedy tokens are byte-identical to the JAX Engine (paged KV, page
    16, packed prefill with prefill_chunk 16 so the long prompts are
    split into continued packs, both engines at their pipelined
    defaults, no prefix cache / host tier / speculation, float32) for a
    concurrent mix with more
    requests than slots, EOS-terminated and length-terminated requests, a
    prompt longer than the context (head truncation) and max_tokens 1;
  * the page allocator copy keeps its invariants;
  * importing every localai_tpu_torch module pulls in neither jax nor
    any localai_tpu module (fresh interpreter);
  * entry points called without ``device=`` default to CUDA and raise on
    a machine without it; chip_smoke.py fails there and prints no result.
"""

from __future__ import annotations

import tests.torch_cpu  # noqa: F401  (one torch CPU thread)

import json
import os
import subprocess
import sys
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
from localai_tpu_torch.engine.paging import KVLifecycleError, PagePool, PoolExhausted
from localai_tpu_torch.models import llama as tllama

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Tok:
    eos_token_id = 1

    def decode(self, ids, **kw):
        return "".join(chr(97 + (i % 26)) for i in ids)


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """ONE (JAX, port) engine pair over the tiny f32 checkpoint — JAX
    compiles dominate this file's runtime."""
    from tests.tinymodel import write_tiny_checkpoint

    d = str(tmp_path_factory.mktemp("tiny_engine"))
    write_tiny_checkpoint(d)
    with open(os.path.join(d, "config.json")) as f:
        hf = json.load(f)
    jcfg = jllama.LlamaConfig.from_hf_config(hf, dtype=jnp.float32)
    jparams = jweights.load_llama_params(d, jcfg, dtype=jnp.float32)
    tcfg = tllama.LlamaConfig.from_hf_config(hf, dtype=torch.float32)
    tparams = tweights.from_jax_params(jax.tree.map(np.asarray, jparams),
                                       tcfg, device="cpu")
    je = jeng.Engine(jcfg, jparams, _Tok(), jeng.EngineConfig(
        num_slots=4, max_context=128, prefill_buckets=(16,),
        prefill_chunk=16, cache_dtype=jnp.float32, kv_layout="paged",
        kv_page_size=16, kv_prefix_cache=False, kv_offload=False,
        draft="0"))
    te = teng.Engine(tcfg, tparams, _Tok(), teng.EngineConfig(
        num_slots=4, max_context=128, prefill_chunk=16, kv_page_size=16,
        decode_burst=16, kv_offload=False, draft="0"), device="cpu")
    je.start()
    te.start()
    yield je, te
    je.shutdown()
    te.shutdown()


def _wave(e, mod, samp, specs):
    """Submit concurrently, drain in submit order -> (ids, finish) each."""
    outs = [e.submit(mod.GenRequest(
        prompt_ids=list(p), max_new_tokens=n, ignore_eos=ign,
        params=samp.SamplingParamsHost(temperature=0.0)))
        for p, n, ign in specs]
    res = []
    for o in outs:
        ids, finish = [], None
        while True:
            ev = o.get(timeout=600)
            if ev is None:
                break
            assert not ev.error, ev.error
            ids.extend(ev.token_ids or ([ev.token_id] if ev.token_id >= 0 else []))
            finish = ev.finish_reason or finish
        res.append((ids, finish))
    return res


def test_greedy_tokens_byte_identical_to_jax_engine(engines):
    je, te = engines
    rng = np.random.default_rng(3)
    specs = [(rng.integers(2, 258, size=n).tolist(), m, ign)
             for n, m, ign in ((40, 8, True), (12, 10, True), (70, 8, True),
                               (9, 12, False), (25, 6, True), (33, 12, False),
                               # head-truncated to C - 1 - 8 tokens; one token
                               (150, 8, True), (5, 1, True))]
    ref = _wave(je, jeng, jsamp, specs)
    got = _wave(te, teng, tsamp, specs)
    assert got == ref
    m = te.metrics()
    # a prompt longer than prefill_chunk really went through continued packs
    assert m["packed_prefill"]["continued"] > 0
    assert m["packed_prefill"]["dispatches"] > 1
    assert all(f in ("stop", "length") for _ids, f in got)
    assert m["active_slots"] == 0 and m["pages_in_use"] == 0


def test_stop_sequence_truncates_and_releases(engines):
    """A stop sequence ends the stream with finish "stop" and the text cut
    before it; the slot and its pages are released."""
    _je, te = engines
    rng = np.random.default_rng(4)
    prompt = rng.integers(2, 258, size=20).tolist()
    free = te.generate(teng.GenRequest(
        prompt_ids=prompt, max_new_tokens=12, ignore_eos=True,
        params=tsamp.SamplingParamsHost(temperature=0.0)))
    full = "".join(e.text for e in free)
    stop = full[5:7]
    text, evs = te.generate_text(teng.GenRequest(
        prompt_ids=prompt, max_new_tokens=12, ignore_eos=True,
        stop_sequences=[stop], params=tsamp.SamplingParamsHost(temperature=0.0)))
    assert evs[-1].finish_reason == "stop"
    assert text == full[:full.index(stop)]
    # the emitter thread found the stop and closed the stream; the engine
    # releases the slot when it applies that note, at its next tick (as
    # the JAX engine's emitter test waits for)
    deadline = time.monotonic() + 10
    while te.num_active and time.monotonic() < deadline:
        time.sleep(0.01)
    assert te.metrics()["pages_in_use"] == 0


def test_concurrent_submitters_stress(engines):
    """More submitting threads than cores, a tiny switch interval: every
    request completes with exactly max_tokens tokens, each stream in
    order, and no page or slot leaks."""
    import threading

    _je, te = engines
    rng = np.random.default_rng(5)
    prompts = [rng.integers(2, 258, size=int(n)).tolist()
               for n in rng.integers(3, 60, size=24)]
    results, errors = {}, []

    def worker(k):
        try:
            for i in range(k, len(prompts), 12):
                _text, evs = te.generate_text(teng.GenRequest(
                    prompt_ids=prompts[i], max_new_tokens=5, ignore_eos=True,
                    params=tsamp.SamplingParamsHost(temperature=0.0)))
                results[i] = evs
        except Exception as e:      # re-raised below on the test thread
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(k,)) for k in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors
    assert sorted(results) == list(range(len(prompts)))
    for evs in results.values():
        assert not any(e.error for e in evs)
        assert [e.completion_tokens for e in evs][-1] == 5
        assert evs[-1].finish_reason == "length"
    m = te.metrics()
    assert m["active_slots"] == 0 and m["pages_in_use"] == 0


def test_page_pool_invariants():
    pool = PagePool(num_slots=3, max_context=64, page_size=16)   # 12 pages
    assert pool.num_pages == 12 and pool.free_pages == 12
    assert pool.ensure(0, 40) and int(pool.owned[0]) == 3
    assert not pool.ensure(0, 40)                                # idempotent
    assert pool.free_pages == 9 and pool.page_refs(0, 0) == 1
    pool.release(0, 17)                                          # keep 2 pages
    assert int(pool.owned[0]) == 2 and pool.free_pages == 10
    assert pool.ptab[0, 2] == pool.num_pages                     # sentinel back
    pool.release(0, 0)
    assert pool.free_pages == 12 and (pool.refs == 0).all()
    for s in range(3):
        pool.ensure(s, 64)
    with pytest.raises(PoolExhausted):
        pool._alloc()
    page = int(pool.ptab[0, 0])
    pool.release(0, 0)
    with pytest.raises(KVLifecycleError):
        pool.unref_detached(page)          # already free


def test_port_imports_no_jax_and_nothing_of_localai_tpu():
    code = r"""
import importlib, pkgutil, sys
import localai_tpu_torch
names = ["localai_tpu_torch"]
for m in pkgutil.walk_packages(localai_tpu_torch.__path__, "localai_tpu_torch."):
    names.append(m.name)
for n in names:
    importlib.import_module(n)
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith(("jax.", "jaxlib"))
             or k == "localai_tpu" or k.startswith("localai_tpu."))
print(len(names), bad)
assert not bad, bad
assert {"localai_tpu_torch.services.errors", "localai_tpu_torch.services.faults",
        "localai_tpu_torch.engine.scheduler",
        "localai_tpu_torch.engine.speculative",
        "localai_tpu_torch.engine.emitter",
        "localai_tpu_torch.services.tracing",
        "localai_tpu_torch.services.eventlog",
        "localai_tpu_torch.services.metrics",
        "localai_tpu_torch.services.kv_audit",
        "localai_tpu_torch.services.sysobs",
        "localai_tpu_torch.api.localai_routes",
        "localai_tpu_torch.functions.parse",
        "localai_tpu_torch.functions.grammars.gbnf",
        "localai_tpu_torch.functions.grammars.automaton",
        "localai_tpu_torch.functions.grammars.native",
        "localai_tpu_torch.functions.grammars.json_schema",
        "localai_tpu_torch.engine.bpe", "localai_tpu_torch.engine.gguf_tokenizer",
        "localai_tpu_torch.engine.gguf", "localai_tpu_torch.engine.lora",
        "localai_tpu_torch.config.yaml_lite",
        "localai_tpu_torch.config.model_config",
        "localai_tpu_torch.config.guesser",
        "localai_tpu_torch.templates.jinja_lite",
        "localai_tpu_torch.templates.prompts",
        "localai_tpu_torch.api.chatflow",
        "localai_tpu_torch.capabilities"} <= set(names), names
# the card's machine has none of these: the front door reads its
# tokenizers, YAML configs and templates without them
absent = sorted(k for k in sys.modules if k.split(".")[0] in (
    "yaml", "jinja2", "tokenizers", "transformers"))
assert not absent, absent
assert "localai_tpu_torch.engine.speculative" in sys.modules
assert "localai_tpu_torch.engine.emitter" in sys.modules
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert int(r.stdout.split()[0]) >= 15


def test_entry_points_default_to_cuda_and_raise_without_it(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is usable")
    from localai_tpu_torch.backend.runner import load_model

    cfg = tllama.LlamaConfig(vocab_size=64, hidden_size=32, intermediate_size=64,
                             num_layers=1, num_heads=2, num_kv_heads=1,
                             dtype=torch.float32)
    params = tweights.random_params(cfg, 0, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        teng.Engine(cfg, params, _Tok())
    with pytest.raises(RuntimeError, match="CUDA"):
        tweights.random_params(cfg, 0)
    (tmp_path / "config.json").write_text(json.dumps({
        "vocab_size": 64, "hidden_size": 32, "intermediate_size": 64,
        "num_hidden_layers": 1, "num_attention_heads": 2,
        "num_key_value_heads": 1}))
    with pytest.raises(RuntimeError, match="CUDA"):
        load_model(str(tmp_path), random_weights=0)


def test_chip_smoke_refuses_to_run_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    for cwd in (REPO, str(tmp_path)):
        if cwd != REPO:        # the script alone, without the program
            (tmp_path / "chip_smoke.py").write_bytes(
                open(os.path.join(REPO, "chip_smoke.py"), "rb").read())
        r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                           capture_output=True, text=True, timeout=300)
        assert r.returncode != 0
        assert '"ok": true' not in r.stdout
