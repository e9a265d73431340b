"""The port's sampler (localai_tpu_torch/engine/sampling.py) against the
JAX sampler's whole surface, on the CPU.

Function by function, over seeded numpy logits [8, 300] and penalty
rings built by the same writes on both sides (empty, partly filled, and
wrapped past RING_N = 256), with repeat_last_n 64, -1 and 8, the repeat,
presence and frequency penalties, a bias row of -100 and +5 entries,
typical-p 0.5 and mirostat 2 at a given mu:

  * ``set_slot``'s clamps, ``set_slot_ring``, ``update_ring`` and
    ``feature_flags`` equal the JAX ones exactly;
  * ``filter_window`` (full and plain variants): candidate ids and window
    values equal, masked log-probs within 1e-5 absolute (float32
    softmaxes summed in another order), the same keep sets, greedy ids
    equal;
  * the mirostat mu update for the same chosen rank within 1e-5;
  * with neutral parameters the full sampler gives the plain one's ids,
    logprobs and state bit for bit.

Engine level, on the tiny f32 checkpoint against the JAX Engine (one
pair of engines for the file): a batch of plain and penalized / biased
greedy requests gives the JAX Engine's tokens and never the banned
token; seeded typical-p and mirostat requests run to full length, repeat
under the same seed and carry mu across bursts.
"""

from __future__ import annotations

import tests.torch_cpu  # noqa: F401  (one torch CPU thread)

import json
import math
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

R, V = 8, 300
H = tsamp.SamplingParamsHost

# one request per row: plain greedy; repeat penalty over 64; presence and
# frequency over the whole ring (-1); repeat penalty over the last 8; a
# bias row; typical-p; mirostat 2; everything at once
ROWS = [H(temperature=0.0),
        H(temperature=0.0, repeat_penalty=1.3, repeat_last_n=64),
        H(temperature=0.8, top_k=0, top_p=1.0, presence_penalty=0.8,
          frequency_penalty=0.5, repeat_last_n=-1),
        H(temperature=1.0, top_k=40, top_p=0.9, repeat_penalty=1.1,
          repeat_last_n=8),
        H(temperature=0.7, top_k=40, logit_bias={}),       # bias set below
        H(temperature=1.0, top_k=0, top_p=1.0, typical_p=0.5),
        H(temperature=0.9, top_k=0, top_p=1.0, mirostat=2, mirostat_tau=4.0,
          mirostat_eta=0.2),
        H(temperature=1.2, top_k=60, top_p=0.95, min_p=0.02, typical_p=0.5,
          repeat_penalty=1.2, presence_penalty=0.3, frequency_penalty=0.2,
          repeat_last_n=-1)]
MU = np.array([10.0, 10.0, 10.0, 10.0, 10.0, 10.0, 3.0, 10.0], np.float32)


def _logits(seed=11):
    return (np.random.default_rng(seed).normal(size=(R, V)) * 3).astype(np.float32)


def _rows(logits):
    """ROWS with row 4's bias: -100 on its top token, +5 on three others,
    and an out-of-range token the install drops; row 7 bans its top."""
    rows = list(ROWS)
    order4, order7 = np.argsort(-logits[4]), np.argsort(-logits[7])
    rows[4] = H(temperature=0.7, top_k=40, logit_bias={
        int(order4[0]): -100.0, int(order4[20]): 5.0, int(order4[50]): 5.0,
        str(int(order4[99])): 5.0, V + 3: 9.0})
    rows[7] = H(**{**rows[7].__dict__, "logit_bias": {int(order7[0]): -100.0}})
    return rows


def _ring_writes(logits):
    """Per row: the prompt its ring is seeded with and the tokens decoded
    after (so rows 2, 3 and 7 wrap past RING_N, row 0 stays empty). Tokens
    come from each row's top 40, so the penalties bite."""
    rng = np.random.default_rng(3)
    lens = [(0, 0), (30, 40), (200, 420), (260, 3), (10, 5), (50, 0),
            (20, 20), (300, 300)]
    out = []
    for r, (n_prompt, n_dec) in enumerate(lens):
        top = np.argsort(-logits[r])[:40]
        out.append((rng.choice(top, n_prompt).tolist(),
                    rng.choice(top, n_dec).tolist()))
    return out


def _jax_state(logits):
    rows = _rows(logits)
    sp = jsamp.make_slot_params(R)
    for r, p in enumerate(rows):
        jsamp.set_slot(sp, r, p)
    ring, pos = jsamp.make_ring(R)
    writes = _ring_writes(logits)
    for r, (prompt, _dec) in enumerate(writes):
        jsamp.set_slot_ring(ring, pos, r, prompt)
    n = max(len(d) for _p, d in writes)
    ring, pos = jnp.asarray(ring), jnp.asarray(pos)
    for j in range(n):
        ids = jnp.asarray([d[j] if j < len(d) else 0 for _p, d in writes], jnp.int32)
        act = jnp.asarray([j < len(d) for _p, d in writes])
        ring, pos = jsamp.update_ring(ring, pos, ids, act)
    bias = jnp.zeros((R, V), jnp.float32)
    for r, p in enumerate(rows):
        if p.logit_bias:
            bias = jsamp.set_slot_logit_bias(bias, r, p)
    return sp, np.asarray(ring), np.asarray(pos), bias


def _port_state(logits):
    rows = _rows(logits)
    sm = tsamp.SlotSampler(R, V, "cpu")
    for r, p in enumerate(rows):
        sm.set_slot(r, p, fallback_seed=r)
    writes = _ring_writes(logits)
    for r, (prompt, _dec) in enumerate(writes):
        sm.set_ring(r, prompt)
    n = max(len(d) for _p, d in writes)
    for j in range(n):
        ids = torch.tensor([d[j] if j < len(d) else 0 for _p, d in writes])
        act = torch.tensor([j < len(d) for _p, d in writes])
        tsamp.update_ring(sm.ring, sm.ring_pos, ids, act)
    sm.mu.copy_(torch.from_numpy(MU))
    return sm


@pytest.fixture(scope="module")
def states():
    logits = _logits()
    return logits, _jax_state(logits), _port_state(logits)


def test_set_slot_clamps_equal_jax(states):
    _logits_, (sp, _ring, _pos, _bias), sm = states
    extra = [H(temperature=-1.0, top_k=300, top_p=0.0, min_p=2.0, typical_p=1.5,
               repeat_penalty=0.0, repeat_last_n=1000, mirostat_tau=0.0,
               mirostat_eta=-1.0),
             H(top_k=-3, top_p=1.5, min_p=-0.5, typical_p=-0.2,
               repeat_last_n=-5, mirostat=1)]
    jsp = jsamp.make_slot_params(len(extra))
    port = tsamp.SlotSampler(len(extra), V, "cpu")
    for r, p in enumerate(extra):
        jsamp.set_slot(jsp, r, p)
        port.set_slot(r, p, fallback_seed=0)
    for want_sp, got in ((sp, sm), (jsp, port)):
        for name in jsamp.SLOT_PARAM_FIELDS:
            want = np.asarray(want_sp[name])
            np.testing.assert_array_equal(got.host[name], want, err_msg=name)
            np.testing.assert_array_equal(got.p[name].numpy(), want, err_msg=name)
    # mu starts at 2 * tau (the JAX engine's admission); repeat_last_n -1
    # and 1000 both cap at the ring
    assert port.mu.tolist() == [10.0, 10.0]
    assert port.host["repeat_last_n"].tolist() == [tsamp.RING_N, tsamp.RING_N]


def test_rings_equal_jax(states):
    _l, (_sp, ring, pos, _bias), sm = states
    np.testing.assert_array_equal(sm.ring.numpy(), ring)
    np.testing.assert_array_equal(sm.ring_pos.numpy(), pos)
    # empty, partly filled and wrapped rings are all there
    assert pos[0] == 0 and (ring[0] == -1).all()
    assert 0 < pos[1] < tsamp.RING_N and (ring[1, pos[1]:] == -1).all()
    assert pos[2] > 2 * tsamp.RING_N and (ring[2] >= 0).all()


def test_bias_rows_equal_jax(states):
    _l, (_sp, _ring, _pos, bias), sm = states
    np.testing.assert_array_equal(sm.bias.numpy(), np.asarray(bias))
    assert sm.bias[4].min() == -100.0 and (sm.bias[4] == 5.0).sum() == 3
    # a later request without a bias clears the row; one never biased
    # keeps it zero
    sm2 = tsamp.SlotSampler(2, V, "cpu")
    sm2.set_slot(0, H(logit_bias={3: 2.0}), 0)
    sm2.set_slot(0, H(), 0)
    sm2.set_slot(1, H(), 0)
    assert not sm2.bias.any()


@pytest.mark.parametrize("active", [None, "some", "plain"])
def test_feature_flags_equal_jax(states, active):
    _l, (sp, *_), sm = states
    mask = {None: None, "some": np.array([1, 0, 0, 0, 1, 1, 0, 0], bool),
            "plain": np.array([1, 0, 0, 0, 1, 0, 0, 0], bool)}[active]
    want = jsamp.feature_flags(sp, mask)
    assert tsamp.feature_flags(sm.host, mask) == want
    assert sm.full_needed(mask if mask is not None else np.ones(R, bool)) \
        == any(want.values())
    if active == "plain":
        assert not any(want.values())     # bias alone runs the plain variant


def _jax_window(logits, sp, ring, pos, bias, full):
    return jsamp.filter_window(
        jnp.asarray(logits), {k: jnp.asarray(v) for k, v in sp.items()},
        jnp.asarray(ring), jnp.asarray(pos), bias, mu=jnp.asarray(MU),
        use_penalties=full, use_typical=full, use_mirostat=full)


@pytest.mark.parametrize("full", [True, False])
def test_filter_window_equals_jax(states, full):
    logits, (sp, ring, pos, bias), sm = states
    j_idx, j_masked, j_vals = _jax_window(logits, sp, ring, pos, bias, full)
    t_idx, t_masked, t_vals = tsamp.filter_window(
        torch.from_numpy(logits), sm.p, sm.ring, sm.ring_pos, sm.bias,
        mu=sm.mu, full=full)
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(t_vals.numpy(), np.asarray(j_vals))
    jm, tm = np.asarray(j_masked), t_masked.numpy()
    np.testing.assert_array_equal(np.isfinite(tm), np.isfinite(jm))
    np.testing.assert_allclose(tm[np.isfinite(tm)], jm[np.isfinite(jm)], atol=1e-5)
    if full:
        # the features really cut the window: the penalties reorder it,
        # typical-p and mirostat keep fewer than the plain chain would
        plain = tsamp.filter_window(torch.from_numpy(logits), sm.p, sm.ring,
                                    sm.ring_pos, sm.bias, full=False)
        assert not torch.equal(plain[0][1], t_idx[1])
        for r in (5, 6):
            assert np.isfinite(tm[r]).sum() < np.isfinite(plain[1][r].numpy()).sum()
    # bias: row 4's banned top token (at -100) is not a candidate
    assert int(np.argsort(-logits[4])[0]) not in t_idx[4].tolist()


def test_greedy_ids_and_logprobs_equal_jax(states):
    """Greedy rows through the whole sampler (penalties and bias change
    them): JAX ``sample``'s ids and logprobs."""
    logits, (sp, ring, pos, bias), sm = states
    g = {k: np.array(v) for k, v in sp.items()}
    g["greedy"][:] = True
    keys = jnp.zeros((R, 2), jnp.uint32)
    j_ids, j_lps, _k, _mu = jsamp.sample(
        jnp.asarray(logits), {k: jnp.asarray(v) for k, v in g.items()},
        jnp.asarray(ring), jnp.asarray(pos), bias, keys, jnp.asarray(MU))
    sm2 = _port_state(logits)
    sm2.p["greedy"].fill_(True)
    ids, lps = sm2.sample_rows(torch.from_numpy(logits), torch.arange(R),
                               torch.ones(R, dtype=torch.bool), full=True)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(j_ids))
    np.testing.assert_allclose(lps.numpy(), np.asarray(j_lps), atol=1e-5)
    top = np.argmax(logits, axis=-1)
    assert ids[4] != top[4] and ids[7] != top[7]     # the banned tops
    # greedy rows moved no mu and no counter; every row's token entered
    # its ring
    np.testing.assert_array_equal(sm2.mu.numpy(), MU)
    assert sm2.counter.tolist() == [0] * R
    np.testing.assert_array_equal(sm2.ring_pos.numpy(), pos + 1)


def test_mirostat_mu_update_equals_jax(states):
    """mu after a draw (the port's sampler) == the JAX ``sample``'s update
    formula over the JAX window at the rank the port drew."""
    logits, (sp, ring, pos, bias), _sm = states
    sm = _port_state(logits)
    _j_idx, j_masked, _v = _jax_window(logits, sp, ring, pos, bias, True)
    t_idx, t_masked, _tv = tsamp.filter_window(
        torch.from_numpy(logits), sm.p, sm.ring, sm.ring_pos, sm.bias,
        mu=sm.mu, full=True)
    ids, _lps = sm.sample_rows(torch.from_numpy(logits), torch.arange(R),
                               torch.ones(R, dtype=torch.bool), full=True)
    r = 6
    rank = int((t_idx[r] == ids[r]).nonzero()[0, 0])
    row = np.asarray(j_masked[r])
    lse = np.asarray(jax.nn.logsumexp(j_masked[r]))
    want = MU[r] - sp["mirostat_eta"][r] * (-(row[rank] - lse) / math.log(2.0)
                                          - sp["mirostat_tau"][r])
    assert abs(float(sm.mu[r]) - float(want)) < 1e-5
    assert float(sm.mu[r]) != MU[r]
    # only the mirostat row moved
    others = [i for i in range(R) if i != r]
    np.testing.assert_array_equal(sm.mu.numpy()[others], MU[others])


def test_neutral_full_sampler_equals_the_plain_one_bit_for_bit():
    """Neutral penalties, typical-p and mirostat, a zero bias and a filled
    ring: the full variant's ids, logprobs, counters, rings and mu are the
    plain variant's, seeded sampled rows included."""
    rng = np.random.default_rng(9)
    logits = torch.from_numpy((rng.normal(size=(6, V)) * 3).astype(np.float32))
    samplers = []
    for _ in range(2):
        sm = tsamp.SlotSampler(6, V, "cpu")
        for s, (t, k, p, mp) in enumerate([(0.0, 40, 0.95, 0.0), (0.7, 40, 0.9, 0.0),
                                           (1.3, 0, 1.0, 0.05), (1.0, 5, 0.5, 0.0),
                                           (0.9, 300, 0.99, 0.0), (1.0, 0, 1.0, 0.0)]):
            sm.set_slot(s, H(temperature=t, top_k=k, top_p=p, min_p=mp, seed=s), 0)
            sm.set_ring(s, np.random.default_rng(s).integers(0, V, 100 + 40 * s).tolist())
        samplers.append(sm)
    assert not samplers[0].full_needed(np.ones(6, bool))
    active = torch.tensor([True, True, False, True, True, True])
    for _ in range(5):
        a = samplers[0].sample_all(logits, active, full=True)
        b = samplers[1].sample_all(logits, active, full=False)
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    for name in ("counter", "ring", "ring_pos", "mu"):
        assert torch.equal(getattr(samplers[0], name), getattr(samplers[1], name))
    assert samplers[0].counter.tolist() == [0, 5, 0, 5, 5, 5]


# ---------- the engines ----------

C = 128


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """ONE (JAX, port) engine pair over the tiny f32 checkpoint."""
    from tests.tinymodel import write_tiny_checkpoint

    d = str(tmp_path_factory.mktemp("tiny_sampling"))
    write_tiny_checkpoint(d)
    with open(os.path.join(d, "config.json")) as f:
        hf = json.load(f)
    jcfg = jllama.LlamaConfig.from_hf_config(hf, dtype=jnp.float32)
    jparams = jweights.load_llama_params(d, jcfg, dtype=jnp.float32)
    tcfg = tllama.LlamaConfig.from_hf_config(hf, dtype=torch.float32)
    tparams = tweights.from_jax_params(jax.tree.map(np.asarray, jparams),
                                       tcfg, device="cpu")
    je = jeng.Engine(jcfg, jparams, _Tok(), jeng.EngineConfig(
        num_slots=4, max_context=C, prefill_buckets=(16, 32), prefill_chunk=32,
        cache_dtype=jnp.float32, kv_layout="paged", kv_page_size=16,
        kv_prefix_cache=False, kv_offload=False,
        draft="0"))
    te = teng.Engine(tcfg, tparams, _Tok(), teng.EngineConfig(
        num_slots=4, max_context=C, prefill_buckets=(16, 32), prefill_chunk=32,
        kv_page_size=16, decode_burst=8, kv_prefix_cache=False,
        kv_offload=False, draft="0"), device="cpu")
    je.start()
    te.start()
    yield je, te
    je.shutdown()
    te.shutdown()


def _wave(e, mod, samp, specs):
    """Submit concurrently, drain in submit order -> ids per request."""
    outs = [e.submit(mod.GenRequest(prompt_ids=list(p), max_new_tokens=n,
                                    ignore_eos=True, params=samp.SamplingParamsHost(**kw)))
            for p, n, kw in specs]
    res = []
    for o in outs:
        ids = []
        while (ev := o.get(timeout=600)) is not None:
            assert not ev.error, ev.error
            ids.extend(ev.token_ids or ([ev.token_id] if ev.token_id >= 0 else []))
        res.append(ids)
    return res


def test_penalized_and_biased_greedy_batch_equals_jax(engines):
    """Plain greedy requests beside ones with repeat / presence / frequency
    penalties and a logit bias, in one batch (the full decode variant for
    the whole batch while a penalized slot runs, the plain one after):
    the JAX Engine's tokens, and the banned token never appears."""
    je, te = engines
    rng = np.random.default_rng(12)
    prompts = [rng.integers(2, 258, size=n).tolist() for n in (20, 35, 9, 50, 28)]
    # the plain run's favourite token of request 2 is the one it bans
    plain = _wave(te, teng, tsamp, [(prompts[2], 24, {"temperature": 0.0})])[0]
    banned = max(set(plain), key=plain.count)
    specs = [(prompts[0], 24, {"temperature": 0.0}),
             (prompts[1], 30, {"temperature": 0.0, "repeat_penalty": 1.3,
                               "presence_penalty": 0.5, "frequency_penalty": 0.4}),
             (prompts[2], 24, {"temperature": 0.0, "logit_bias": {banned: -100.0,
                                                                 7: 3.0}}),
             (prompts[3], 12, {"temperature": 0.0}),
             (prompts[4], 20, {"temperature": 0.0, "repeat_penalty": 1.5,
                               "repeat_last_n": 8, "logit_bias": {banned: -100.0}})]
    m0 = te.metrics()["decode"]
    want = _wave(je, jeng, jsamp, specs)
    got = _wave(te, teng, tsamp, specs)
    m1 = te.metrics()["decode"]
    assert got == want
    assert banned not in got[2] and banned not in got[4]
    assert banned in plain
    assert got[1] != _wave(te, teng, tsamp, [(prompts[1], 30, {"temperature": 0.0})])[0]
    assert m1["full_steps"] > m0["full_steps"]


def test_seeded_typical_and_mirostat_requests(engines):
    """Seeded typical-p and mirostat requests run to full length, give the
    same tokens under the same seed (alone or beside another request),
    and mirostat's mu moves across bursts."""
    _je, te = engines
    rng = np.random.default_rng(13)
    prompt = rng.integers(2, 258, size=25).tolist()
    typ = {"temperature": 1.0, "top_k": 0, "top_p": 1.0, "typical_p": 0.5, "seed": 5}
    miro = {"temperature": 1.0, "mirostat": 2, "mirostat_tau": 3.0,
            "mirostat_eta": 0.3, "seed": 6}
    mus = []

    def spy(real):
        def sample(*a, **kw):
            out = real(*a, **kw)
            mus.append(float(te.sampler.mu[0]))
            return out
        return sample

    # the prefill's first token and every decode step
    te.sampler.sample_rows = spy(te.sampler.sample_rows)
    te.sampler.sample_all = spy(te.sampler.sample_all)
    try:
        alone = _wave(te, teng, tsamp, [(prompt, 40, miro)])[0]
    finally:
        del te.sampler.sample_rows, te.sampler.sample_all
    a = _wave(te, teng, tsamp, [(prompt, 40, typ), (prompt, 40, miro)])
    b = _wave(te, teng, tsamp, [(prompt, 40, miro), (prompt, 40, typ)])
    assert [len(x) for x in a] == [40, 40]
    assert a[0] == b[1] and a[1] == b[0] == alone
    # mu: 2 * tau at admission, then one update per token, across the
    # prefill's first token and every burst of 8
    assert len(mus) == 40 and len(set(mus)) > 5 and mus[0] != 6.0
    c = _wave(te, teng, tsamp, [(prompt, 40, {**typ, "seed": 99})])[0]
    assert c != a[0]
