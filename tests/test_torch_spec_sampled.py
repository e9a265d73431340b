"""Sampled speculation in the port (rejection-sampled acceptance inside the
spec round) against the JAX package, on the CPU:

  * ``sampling.verify_dist`` against the JAX ``verify_dist``, plain and
    full (typical-p) variants, with top-k / top-p / min-p / typical-p: the
    same candidate ids, probs within 1e-5;
  * ``speculative.accept_sampled`` on the JAX tests' deterministic cases
    (full accept, all reject, an inactive row) with explicit uniforms;
    driven with the uniforms the JAX function draws from its keys, the
    same accepted counts, against the JAX one-hot draft law too (the
    one-hot degeneration); a chi-square of (k, final token) over N
    counters against the JAX function's over N keys on the same target
    probs; ``two_sample_chi2`` equal to the JAX helper;
  * the spec round: ``spec_body`` with sampled spec rows against
    ``eager_rounds`` from the same state and counters (tokens and n_out
    equal), plain and full variants; every sampled spec row's counter
    advances D + 1 per round;
  * the engine at the JAX defaults: a sampled request takes spec rounds,
    counted under ``by_mode["sampled"]``; the JAX seed ladder (10 seeds x
    40 tokens, top_k 16) spec-on against spec-off and against the JAX
    Engine spec-on, chi-square p > 0.01 (fixed seeds: deterministic); a
    typical-p request served through the full variant, against spec-off
    in distribution; a mixed tick (greedy, sampled, penalized rows) whose
    greedy tokens are the JAX Engine's.
"""

from __future__ import annotations

import tests.torch_cpu  # noqa: F401  (one torch CPU thread)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localai_tpu.engine import engine as jeng
from localai_tpu.engine import sampling as jsamp
from localai_tpu.engine import speculative as jspec
from localai_tpu.models import llama as jllama
from localai_tpu_torch.engine import engine as teng
from localai_tpu_torch.engine import sampling as tsamp
from localai_tpu_torch.engine import speculative as tspec
from localai_tpu_torch.engine import weights as tweights
from localai_tpu_torch.models import llama as tllama
from localai_tpu_torch.ops import kvcache as tkv
from tests import test_torch_speculative as tsp
from tests.conftest import ByteTokenizer

ATOL, RTOL = tsp.ATOL, tsp.RTOL


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


# ---------- verify_dist ----------

PARAMS = {
    "top_k_top_p": dict(temperature=[0.7, 1.3], top_k=[8, 0], top_p=[0.9, 0.95],
                        min_p=[0.0, 0.0], typical_p=[1.0, 1.0]),
    "min_p": dict(temperature=[1.0, 0.5], top_k=[0, 40], top_p=[1.0, 0.8],
                  min_p=[0.05, 0.2], typical_p=[1.0, 1.0]),
    "typical": dict(temperature=[0.9, 1.1], top_k=[0, 16], top_p=[1.0, 0.97],
                    min_p=[0.0, 0.01], typical_p=[0.8, 0.95]),
}


@pytest.mark.parametrize("typical", (False, True))
@pytest.mark.parametrize("case", sorted(PARAMS))
def test_verify_dist_matches_jax(case, typical):
    S, W, V = 2, 5, 300
    rng = np.random.default_rng(7)
    logits = rng.normal(size=(S, W, V)).astype(np.float32) * 3
    jsp = jsamp.make_slot_params(S)
    tp = tsamp.SlotSampler(S, V, "cpu")
    for name, vals in PARAMS[case].items():
        jsp[name][:] = vals
        tp.p[name].copy_(_t(np.asarray(vals, tp.p[name].numpy().dtype)))
    jsp["greedy"][:] = False
    tp.p["greedy"].zero_()
    jidx, jprobs = jsamp.verify_dist(jnp.asarray(logits),
                                     {k: jnp.asarray(v) for k, v in jsp.items()},
                                     use_typical=typical)
    idx, probs = tsamp.verify_dist(_t(logits.reshape(S * W, V)), tp.p, W,
                                   typical=typical)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), atol=1e-5)
    # rank 0 is the greedy pick, whatever the filter
    np.testing.assert_array_equal(idx[:, :, 0].numpy(), logits.argmax(-1))
    if case == "typical" and typical:
        # typical-p really cuts something here, or the variant is untested
        plain = tsamp.verify_dist(_t(logits.reshape(S * W, V)), tp.p, W,
                                  typical=False)[1]
        assert (probs > 0).sum() < (plain > 0).sum()


# ---------- accept_sampled ----------

def _dist(rows, V):
    out = np.zeros((len(rows), V), np.float32)
    for j, row in enumerate(rows):
        for tok, p in row.items():
            out[j, tok] = p
    return out


def _vocab(tp):
    """Vocabulary-space target probs [S, W, V] as accept_sampled's window."""
    S, W, V = tp.shape
    return _t(np.broadcast_to(np.arange(V), (S, W, V)).copy()), _t(tp)


def _port(drafts, tp, active, uniforms):
    idx, probs = _vocab(np.asarray(tp, np.float32))
    out, n_out, k, _c = tspec.accept_sampled(
        _t(np.asarray(drafts, np.int64)), idx, probs, _t(np.asarray(active)),
        uniforms=_t(np.asarray(uniforms, np.float32)))
    return out.numpy(), n_out.numpy(), k.numpy()


def _jax_keys(S, base=0):
    return jnp.stack([jax.random.key_data(jax.random.PRNGKey(base + i))
                      for i in range(S)])


def _jax_uniforms(keys, D):
    """The acceptance uniforms the JAX accept_sampled draws from its keys."""
    def one(kd):
        _key, sub_u, _sub_c = jax.random.split(jax.random.wrap_key_data(kd), 3)
        return jax.random.uniform(sub_u, (D,))
    return np.asarray(jax.vmap(one)(keys))


def test_accept_sampled_full_accept_emits_drafts_plus_bonus():
    V = 8
    tp = _dist([{3: 1.0}, {5: 1.0}, {2: 1.0}, {7: 1.0}], V)[None]
    out, n_out, k = _port([[3, 5, 2]], tp, [True], [[0.99, 0.5, 0.0, 0.3]])
    assert k.tolist() == [3] and n_out.tolist() == [4]
    assert out[0].tolist() == [3, 5, 2, 7]
    jout, jn, jk, _ = jspec.accept_sampled(jnp.asarray([[3, 5, 2]], jnp.int32),
                                           jnp.asarray(tp), None, _jax_keys(1),
                                           jnp.asarray([True]))
    assert np.asarray(jout).tolist() == out.tolist() and int(jk[0]) == 3


def test_accept_sampled_all_reject_exactly_one_fresh_sample():
    V = 8
    tp = _dist([{6: 1.0}, {1: 1.0}, {1: 1.0}, {1: 1.0}], V)[None]
    for u in ([0.0, 0.0, 0.0, 0.0], [0.5, 0.1, 0.9, 0.999]):
        out, n_out, k = _port([[3, 3, 3]], tp, [True], [u])
        assert k.tolist() == [0] and n_out.tolist() == [1]
        assert out[0].tolist() == [6, 0, 0, 0]


def test_accept_sampled_residual_drops_the_draft_token():
    # p0 = {a: .5, b: .3, c: .2}, draft a, rejected (u0 >= .5): the final
    # token comes from {b: .6, c: .4}, by inverse CDF over the window
    V, a, b, c = 8, 3, 4, 5
    tp = _dist([{a: 0.5, b: 0.3, c: 0.2}, {1: 1.0}], V)[None]
    assert _port([[a]], tp, [True], [[0.4, 0.9]])[0][0].tolist() == [a, 1]
    assert _port([[a]], tp, [True], [[0.6, 0.0]])[0][0].tolist() == [b, 0]
    assert _port([[a]], tp, [True], [[0.6, 0.59]])[0][0].tolist() == [b, 0]
    assert _port([[a]], tp, [True], [[0.6, 0.61]])[0][0].tolist() == [c, 0]


def test_accept_sampled_inactive_row_untouched():
    V = 8
    tp = np.broadcast_to(_dist([{3: 1.0}, {5: 1.0}], V)[None], (2, 2, V)).copy()
    idx, probs = _vocab(tp)
    counter = _t(np.asarray([10, 20], np.int64))
    out, n_out, _k, new = tspec.accept_sampled(
        _t(np.asarray([[3], [3]], np.int64)), idx, probs,
        _t(np.asarray([True, False])), seed=_t(np.asarray([1, 2], np.int64)),
        counter=counter)
    assert n_out.tolist() == [2, 0] and new.tolist() == [12, 20]
    assert counter.tolist() == [10, 20]


@pytest.mark.parametrize("one_hot", (False, True))
def test_accept_sampled_accepts_as_jax_with_jax_uniforms(one_hot):
    """Given the acceptance uniforms the JAX function draws from its keys,
    the port accepts exactly the JAX function's prefix, row by row, on
    random target probs; the JAX side with ``draft_probs=None`` or with an
    explicit one-hot draft law (the degeneration the port's deterministic
    drafters rely on). Where the final law has one token, the final token
    is the same too."""
    V, S, D = 16, 256, 3
    rng = np.random.default_rng(0)
    drafts = rng.integers(0, V, size=(S, D))
    raw = rng.random((S, D + 1, V)).astype(np.float32) ** 4
    # half the rows put all their mass on the draft at every position
    raw[: S // 2, np.arange(D)[:, None], :] = 0.0
    for s in range(S // 2):
        raw[s, np.arange(D), drafts[s]] = 1.0
    tp = raw / raw.sum(-1, keepdims=True)
    keys = _jax_keys(S, base=100)
    qp = (jnp.asarray(np.eye(V, dtype=np.float32)[drafts]) if one_hot else None)
    jout, jn, jk, _ = jspec.accept_sampled(jnp.asarray(drafts, jnp.int32),
                                           jnp.asarray(tp), qp, keys,
                                           jnp.ones((S,), bool))
    u = np.concatenate([_jax_uniforms(keys, D), rng.random((S, 1))], axis=1)
    out, n_out, k = _port(drafts, tp, np.ones(S, bool), u)
    np.testing.assert_array_equal(k, np.asarray(jk))
    np.testing.assert_array_equal(n_out, np.asarray(jn))
    assert (k[: S // 2] == D).all() and (k[S // 2:] < D).any()
    jout = np.asarray(jout)
    for s in range(S):
        np.testing.assert_array_equal(out[s, :k[s]], jout[s, :k[s]])
        law = tp[s, k[s]].copy()
        if k[s] < D:
            law[drafts[s, k[s]]] = 0.0
        if (law > 0).sum() == 1:
            assert out[s, k[s]] == jout[s, k[s]]


def test_accept_sampled_law_matches_jax_chi_square():
    """(k, final token) over 4000 counters against the JAX function's over
    4000 keys, on one target law: one distribution (fixed seeds)."""
    V, N, D = 6, 4000, 3
    rng = np.random.default_rng(1)
    raw = rng.random((D + 1, V)).astype(np.float32) + 0.05
    tp1 = raw / raw.sum(-1, keepdims=True)
    drafts1 = np.asarray([int(tp1[j].argmax()) for j in range(D)])
    tp = np.broadcast_to(tp1, (N, D + 1, V)).copy()
    drafts = np.broadcast_to(drafts1, (N, D)).copy()
    jout, _jn, jk, _ = jspec.accept_sampled(jnp.asarray(drafts, jnp.int32),
                                            jnp.asarray(tp), None,
                                            _jax_keys(N, base=7),
                                            jnp.ones((N,), bool))
    idx, probs = _vocab(tp)
    out, _n, k, _c = tspec.accept_sampled(
        _t(drafts.astype(np.int64)), idx, probs, torch.ones(N, dtype=torch.bool),
        seed=torch.full((N,), 1234, dtype=torch.int64),
        counter=torch.arange(N, dtype=torch.int64) * (D + 1))
    k, jk = k.numpy(), np.asarray(jk)
    fin = out.numpy()[np.arange(N), k]
    jfin = np.asarray(jout)[np.arange(N), jk]
    a = np.bincount(k * V + fin, minlength=(D + 1) * V)
    b = np.bincount(jk * V + jfin, minlength=(D + 1) * V)
    stat, dof, p = tspec.two_sample_chi2(a, b)
    assert dof >= 4 and p > 0.01, (stat, dof, p)


@pytest.mark.parametrize("seed", (3, 4, 5))
def test_two_sample_chi2_equals_jax(seed):
    rng = np.random.default_rng(seed)
    p = np.asarray([0.5, 0.3, 0.15, 0.04, 0.01])
    a = np.bincount(rng.choice(5, size=900, p=p), minlength=5)
    b = np.bincount(rng.choice(5, size=1300, p=p[::-1] if seed == 5 else p),
                    minlength=5)
    got = tspec.two_sample_chi2(a, b)
    want = jspec.two_sample_chi2(a, b)
    assert got[1] == want[1]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-12)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-9, atol=1e-300)
    assert tspec.two_sample_chi2([3, 0], [0, 0]) == jspec.two_sample_chi2([3, 0], [0, 0])


# ---------- the spec round ----------

@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """(JAX config, JAX params, port config, port params) of the tiny f32
    checkpoint, as tests/test_torch_speculative.py loads it."""
    import json
    import os

    from localai_tpu.engine import weights as jweights
    from tests.tinymodel import write_tiny_checkpoint

    d = str(tmp_path_factory.mktemp("tiny_spec_sampled"))
    write_tiny_checkpoint(d)
    with open(os.path.join(d, "config.json")) as f:
        hf = json.load(f)
    jcfg = jllama.LlamaConfig.from_hf_config(hf, dtype=jnp.float32)
    jparams = jweights.load_llama_params(d, jcfg, dtype=jnp.float32)
    tcfg = tllama.LlamaConfig.from_hf_config(hf, dtype=torch.float32)
    tparams = tweights.from_jax_params(jax.tree.map(np.asarray, jparams),
                                       tcfg, device="cpu")
    return jcfg, jparams, tcfg, tparams


def _round_state(tiny, temps, typical=1.0):
    S = tsp.S
    caches = tsp._caches(tiny, "paged", np.random.default_rng(1))
    jck, jcv, tck, tcv = tsp._prefill_both(tiny, caches, [
        np.asarray([3, 4, 5, 6] * 5, np.int32),
        np.asarray(np.random.default_rng(2).integers(2, 258, 13), np.int32),
        np.asarray([9, 9, 9, 9, 9, 9, 9], np.int32),
        np.asarray(np.random.default_rng(3).integers(2, 258, 6), np.int32)])
    g, samp = tsp._graph(tiny, tck, tcv)
    tokens = np.asarray([6, 17, 9, 40])
    lengths = np.asarray([19, 12, 6, 5])
    # slot 2's history holds its trailing 3-gram followed by the model's
    # own greedy continuation, so at a low temperature it accepts
    cont = tsp._greedy_continuation(tiny, jck, jcv, tokens, lengths, 2, tsp.W - 1)
    prompts = [[3, 4, 5, 6] * 5, None, [9] * 7 + cont + [2, 3, 9, 9, 9], None]
    for s in range(S):
        samp.set_slot(s, tsamp.SamplingParamsHost(
            temperature=temps[s], seed=4 + s, top_k=0, top_p=1.0,
            typical_p=typical), 0)
        if prompts[s]:
            samp.set_ring(s, prompts[s])
    samp.counter.copy_(_t(np.asarray([5, 9, 13, 2], np.int64)))
    active = np.asarray([True, True, True, False])
    spec = np.asarray([True, False, True, False])
    g.load(np.stack([active, np.ones(S), tokens, lengths, spec]).astype(np.int64))
    return g, samp, tck


@pytest.mark.parametrize("full", (False, True))
def test_sampled_spec_round_equals_eager_rounds(tiny, full):
    """spec_body with two sampled spec rows (slot 2 at a low temperature,
    so its proposals get accepted), a sampled plain row and an idle slot,
    against eager_rounds from the same state and counters: ids and n_out
    bit for bit, logprobs, chained state, rings and counters equal; the
    full variant filters the verify with typical-p."""
    temps = [0.9, 0.8, 0.05, 0.0]
    out = {}
    for way in ("graph", "eager"):
        g, samp, tck = _round_state(tiny, temps, typical=0.9 if full else 1.0)
        res = (g.spec_replay(3, full=full).wait() if way == "graph"
               else g.spec_eager(3, full=full))
        out[way] = (res, g.tokens.numpy().copy(), g.lengths.numpy().copy(),
                    samp.ring.numpy().copy(), samp.counter.numpy().copy(),
                    tkv.gather_all_rows(tkv.layer(tck, 1)).numpy())
    W = tsp.W
    (a, ta, la, ra, ca, rows_a), (b, tb, lb, rb, cb, rows_b) = out["graph"], out["eager"]
    np.testing.assert_array_equal(a[:, :W], b[:, :W])
    np.testing.assert_array_equal(a[:, 2 * W], b[:, 2 * W])
    np.testing.assert_allclose(a[:, W:2 * W], b[:, W:2 * W], atol=ATOL, rtol=RTOL)
    for x, y in ((ta, tb), (la, lb), (ra, rb), (ca, cb)):
        np.testing.assert_array_equal(x, y)
    for s in range(tsp.S):
        np.testing.assert_allclose(rows_a[s, :la[s]], rows_b[s, :lb[s]],
                                   atol=ATOL, rtol=RTOL)
    # the low-temperature row accepted proposals; every active row emitted
    assert a[:, 2 * W, 2].sum() > 3 and (a[:, 2 * W, :3] >= 1).all()
    # a sampled spec row's logprob is log p of the filtered window (<= 0)
    assert (a[:, W:2 * W, 0][a[:, :W, 0] > 0] <= 0).all()


def test_counter_advances_d_plus_one_per_round(tiny):
    """Every active sampled spec row draws D + 1 uniforms a round whatever
    it accepts; a sampled plain row one; a greedy spec row and an idle
    slot none."""
    g, samp, _tck = _round_state(tiny, [0.9, 0.8, 0.0, 0.7])
    before = samp.counter.numpy().copy()
    res = g.spec_replay(3).wait()
    W = tsp.W
    assert (res[:, 2 * W, 0] >= 1).all()
    assert (samp.counter.numpy() - before).tolist() == [3 * W, 3, 0, 0]


# ---------- the engine ----------

PROMPT = "the cat sat on the mat. the cat sat on the mat. the cat sat"


def _cfg_models():
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


@pytest.fixture(scope="module")
def models():
    return _cfg_models()


EC = dict(max_context=128, prefill_buckets=(16, 32, 64), prefill_chunk=64,
          decode_burst=8)


def _engine(models, port=True, slots=2, **kw):
    jcfg, jparams, tcfg, tparams = models
    if port:
        return teng.Engine(tcfg, tparams, ByteTokenizer(), teng.EngineConfig(
            num_slots=slots, **{**EC, **kw}), device="cpu").start()
    je = jeng.Engine(jcfg, jparams, ByteTokenizer(), jeng.EngineConfig(
        num_slots=slots, **{**EC, **kw}, cache_dtype=jnp.float32))
    je.start()
    return je


def _req(e, prompt, n=40, **pkw):
    mod, samp = (teng, tsamp) if isinstance(e, teng.Engine) else (jeng, jsamp)
    return mod.GenRequest(prompt_ids=ByteTokenizer().encode(prompt),
                          params=samp.SamplingParamsHost(**pkw),
                          max_new_tokens=n, ignore_eos=True)


def _ids(evs):
    return [t for ev in evs for t in (ev.token_ids or [ev.token_id])]


def test_sampled_request_speculates_at_the_defaults(models):
    e = _engine(models)
    try:
        assert e._spec_mode == "ngram"
        _, evs = e.generate_text(_req(e, PROMPT, temperature=0.8, seed=5))
        assert len(_ids(evs)) == 40
        sp = e.metrics()["spec"]
        bm = sp["by_mode"]["sampled"]
        assert sp["dispatches"] > 0 and bm["rounds"] > 0
        assert bm["tokens"] >= bm["rounds"] and bm["rounds"] == sp["rounds"]
        assert sp["by_mode"]["greedy"]["rounds"] == 0
        assert bm["accept_per_dispatch"] >= 1.0
        assert 0.0 <= bm["acceptance_rate"] <= 1.0
    finally:
        e.shutdown()


def _ladder(e, V=258, **pkw):
    """The JAX test's seed ladder: 10 seeds x 40 tokens, token counts."""
    counts = np.zeros((V,), np.int64)
    try:
        for s in range(10):
            _, evs = e.generate_text(_req(e, PROMPT, temperature=0.8, seed=s, **pkw))
            ids = _ids(evs)
            assert len(ids) == 40
            counts += np.bincount(ids, minlength=V)[:V]
        return counts, dict(e.metrics()["spec"]["by_mode"]["sampled"])
    finally:
        e.shutdown()


def test_seed_ladder_chi_square_against_spec_off_and_jax(models):
    on, bm = _ladder(_engine(models), top_k=16)
    off, bm_off = _ladder(_engine(models, draft="0"), top_k=16)
    jon, jbm = _ladder(_engine(models, port=False, draft="ngram"), top_k=16)
    assert bm["rounds"] > 0 and jbm["rounds"] > 0 and bm_off["rounds"] == 0
    assert int(on.sum()) == int(off.sum()) == int(jon.sum()) == 400
    for other in (off, jon):
        stat, dof, p = tspec.two_sample_chi2(on, other)
        assert dof >= 1 and p > 0.01, (stat, dof, p)


def test_typical_p_request_speculates_through_the_full_variant(models):
    on, bm = _ladder(_engine(models), top_k=16, typical_p=0.9)
    off, _ = _ladder(_engine(models, draft="0"), top_k=16, typical_p=0.9)
    assert bm["rounds"] > 0
    stat, dof, p = tspec.two_sample_chi2(on, off)
    assert dof >= 1 and p > 0.01, (stat, dof, p)
    e = _engine(models)
    try:
        e.generate_text(_req(e, PROMPT, temperature=0.8, seed=1, typical_p=0.9))
        m = e.metrics()
        assert m["decode"]["full_steps"] > 0 and m["spec"]["by_mode"]["sampled"]["rounds"] > 0
    finally:
        e.shutdown()


def test_mixed_tick_greedy_equals_jax(models):
    """A greedy slot, a sampled slot and a penalized (ineligible) sampled
    slot share ticks (decode_burst 4): the greedy stream is the JAX
    Engine's, the penalized stream the port's own spec-off stream, the
    sampled slot takes sampled rounds."""
    reqs = [(PROMPT, dict(temperature=0.0)),
            ("a sampled stream a sampled stream", dict(temperature=0.9, seed=11)),
            ("something else entirely", dict(temperature=1.0, seed=7,
                                             repeat_penalty=1.1))]
    got = {}
    for name, port, kw in (("jax", False, {}), ("port", True, {}),
                           ("plain", True, {"draft": "0"})):
        e = _engine(models, port, slots=4, **{**kw, "decode_burst": 4})
        try:
            outs = [e.submit(_req(e, p, 32, **pk)) for p, pk in reqs]
            got[name] = ([_ids(list(iter(o.get, None))) for o in outs],
                         e.metrics()["spec"])
        finally:
            e.shutdown()
    (port, st), (plain, _), (jids, _j) = got["port"], got["plain"], got["jax"]
    assert port[0] == jids[0] and port[2] == plain[2]
    assert all(len(x) == 32 for x in port)
    assert st["mixed_dispatches"] > 0
    assert st["by_mode"]["greedy"]["rounds"] > 0 and st["by_mode"]["sampled"]["rounds"] > 0
