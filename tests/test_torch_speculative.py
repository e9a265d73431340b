"""The port's n-gram self-speculation pieces against the JAX package, on
the CPU (engine/speculative.py, models/llama.py::ragged_prefill's
all_logits, engine/decode_graph.py::spec_body):

  * ``ngram_propose`` on the seven cases of the JAX package's own tests
    and on seeded random rings (-1 seed entries, wrap-around, n-gram
    lengths 1-4), equal to the JAX function;
  * ``accept_greedy`` on seeded drafts, equal to the JAX function;
  * the verify pass: ``ragged_prefill(..., all_logits=True)`` over S
    segments of W tokens (non-speculating slots as pad segments) against
    the JAX ``llama.prefill(continued=True, return_all_logits=True)`` (its
    non-speculating rows parked at the out-of-range start), on paged
    float, paged int8 and contiguous caches: logits and the rows written
    within the ``_close`` tolerances of tests/test_torch_parity.py (int8:
    rows within one quantization level);
  * one spec round of ``DecodeGraph.spec_body`` (a speculating slot, a
    plain greedy slot, an idle slot) against the round composed from the
    JAX functions (``ngram_propose``, ``decode_step``, the continued
    ``prefill``, argmax, ``accept_greedy``, the ring pushes); and the same
    rounds against ``eager_rounds`` (the reference the card holds the
    captured round against), ids bit for bit.
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

from localai_tpu.engine import speculative as jspec
from localai_tpu.engine import weights as jweights
from localai_tpu.models import llama as jllama
from localai_tpu.ops import kvcache as jkv
from localai_tpu_torch.engine import sampling as tsamp
from localai_tpu_torch.engine import speculative as tspec
from localai_tpu_torch.engine import weights as tweights
from localai_tpu_torch.engine.decode_graph import DecodeGraph
from localai_tpu_torch.models import llama as tllama
from localai_tpu_torch.ops import kvcache as tkv

ATOL, RTOL = 2e-4, 2e-3


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _both(rows, tokens, ring_pos=None, n_draft=4, ngram=3):
    ring = np.asarray(rows, np.int64)
    rp = (np.zeros((ring.shape[0],), np.int64) if ring_pos is None
          else np.asarray(ring_pos, np.int64))
    tok = np.asarray(tokens, np.int64)
    j = np.asarray(jspec.ngram_propose(jnp.asarray(tok, jnp.int32),
                                       jnp.asarray(ring, jnp.int32),
                                       jnp.asarray(rp, jnp.int32), n_draft, ngram))
    t = tspec.ngram_propose(_t(tok), _t(ring), _t(rp), n_draft, ngram).numpy()
    return t, j


# the JAX package's own cases (tests/test_spec_fused.py)
CASES = {
    "match": ([[5, 6, 7, 8] * 4], [8], None, [[5, 6, 7, 8]]),
    "most_recent": ([[1, 2, 3, 9, 0, 0, 0, 0, 1, 2, 3, 7, 0, 1, 2, 3]], [3],
                    None, [[7, 0, 1, 2]]),
    "no_match": ([list(range(16))], [15], None, [[15] * 4]),
    "short_history": ([[-1] * 14 + [7, 9]], [9], None, [[9] * 4]),
    "clip": ([[0] * 10 + [1, 2, 3, 1, 2, 3]], [3], None, [[1, 2, 3, 3]]),
    "rotation": ([np.roll(np.asarray([5, 6, 7, 8] * 4), 7).tolist()], [8], [7],
                 [[5, 6, 7, 8]]),
    "batch": ([[5, 6, 7, 8] * 4, list(range(16)), [-1] * 14 + [7, 9]],
              [8, 15, 9], None, [[5, 6, 7, 8], [15] * 4, [9] * 4]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_ngram_propose_cases_match_jax(case):
    rows, tokens, pos, want = CASES[case]
    t, j = _both(rows, tokens, pos)
    np.testing.assert_array_equal(t, j)
    assert t.tolist() == want


@pytest.mark.parametrize("ngram", (1, 2, 3, 4))
def test_ngram_propose_random_rings_match_jax(ngram):
    """Seeded rings of the sampler's size over a small alphabet (so grams
    recur), some with -1 seed entries left (short prompts), cursors past
    the ring size (wrap-around), every D from 1 to 6."""
    rng = np.random.default_rng(ngram)
    N = tsamp.RING_N
    for trial in range(6):
        S = 5
        ring = rng.integers(2, 2 + 3 + trial, size=(S, N))
        pos = rng.integers(0, 3 * N, size=(S,))
        for s in range(S):
            if pos[s] < N:          # never wrapped: the tail is unwritten
                ring[s, pos[s]:] = -1
        tok = ring[np.arange(S), (pos - 1) % N]
        for D in range(1, 7):
            t, j = _both(ring, tok, pos, n_draft=D, ngram=ngram)
            np.testing.assert_array_equal(t, j, err_msg=f"trial {trial} D {D}")


def test_accept_greedy_matches_jax():
    rng = np.random.default_rng(3)
    for D in (1, 2, 4, 6):
        S = 16
        greedy = rng.integers(0, 3, size=(S, D + 1))
        drafts = np.where(rng.random((S, D)) < 0.7, greedy[:, :D],
                          rng.integers(0, 3, size=(S, D)))
        active = rng.random(S) < 0.8
        jo = jspec.accept_greedy(jnp.asarray(drafts, jnp.int32),
                                 jnp.asarray(greedy, jnp.int32), jnp.asarray(active))
        to = tspec.accept_greedy(_t(drafts), _t(greedy), _t(active))
        for a, b in zip(to, jo):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    from tests.tinymodel import write_tiny_checkpoint

    d = str(tmp_path_factory.mktemp("tiny_spec"))
    write_tiny_checkpoint(d)
    with open(os.path.join(d, "config.json")) as f:
        hf = json.load(f)
    jcfg = jllama.LlamaConfig.from_hf_config(hf, dtype=jnp.float32)
    jparams = jweights.load_llama_params(d, jcfg, dtype=jnp.float32)
    tcfg = tllama.LlamaConfig.from_hf_config(hf, dtype=torch.float32)
    tparams = tweights.from_jax_params(jax.tree.map(np.asarray, jparams),
                                       tcfg, device="cpu")
    return jcfg, jparams, tcfg, tparams


S, C, PG, W = 4, 64, 16, 5
LAYOUTS = ("paged", "int8", "contig")


def _caches(tiny, layout, rng):
    """Both packages' caches of one layout: paged with a scrambled table."""
    jcfg, _jp, tcfg, _tp = tiny
    if layout == "contig":
        jck, jcv = jllama.init_cache(jcfg, S, C, jnp.float32)
        tck, tcv = tllama.init_cache(tcfg, S, C, 0, dtype=torch.float32,
                                     device="cpu")
        return jck, jcv, tck, tcv
    dt = (jnp.int8, torch.int8) if layout == "int8" else (jnp.float32, torch.float32)
    ptab = rng.permutation(S * C // PG).astype(np.int32).reshape(S, -1)
    jck, jcv = jllama.init_cache(jcfg, S, C, dt[0], page_size=PG)
    jck = jkv.with_page_table(jck, jnp.asarray(ptab))
    jcv = jkv.with_page_table(jcv, jnp.asarray(ptab))
    tck, tcv = tllama.init_cache(tcfg, S, C, PG, dtype=dt[1], device="cpu")
    tck["ptab"] = tcv["ptab"] = _t(ptab)
    return jck, jcv, tck, tcv


def _prefill_both(tiny, caches, prompts):
    """A fresh pack of each slot's prompt into both caches."""
    jcfg, jparams, tcfg, tparams = tiny
    jck, jcv, tck, tcv = caches
    lens = [len(p) for p in prompts]
    N = sum(lens)
    tokens = np.concatenate(prompts).astype(np.int32)
    positions = np.concatenate([np.arange(n) for n in lens]).astype(np.int32)
    seg_of = np.concatenate([np.full(n, b) for b, n in enumerate(lens)]).astype(np.int32)
    tabs = np.stack([np.arange(S), np.zeros(S), np.cumsum([0] + lens[:-1]),
                     lens]).astype(np.int32)
    _l, jck, jcv = jllama.ragged_prefill(
        jparams, jcfg, jnp.asarray(tokens), jnp.asarray(positions),
        jnp.asarray(seg_of), *map(jnp.asarray, tabs), jck, jcv, continued=False)
    tllama.ragged_prefill(tparams, tcfg, _t(tokens), _t(positions),
                          *(_t(t) for t in tabs), _t(seg_of), tck, tcv,
                          continued=False)
    assert N == tokens.shape[0]
    return jck, jcv, tck, tcv


def _verify_pack(spec, lengths, tin):
    """The port's verify pack (spec_body's layout): segment b = slot b at
    offset b * W, a non-speculating slot a pad segment."""
    pos = np.where(spec[:, None], lengths[:, None] + np.arange(W)[None, :], C)
    seg_of = np.where(spec[:, None], np.arange(S)[:, None], S) * np.ones((1, W), int)
    tabs = np.stack([np.where(spec, np.arange(S), S), np.where(spec, lengths, 0),
                     np.arange(S) * W, spec * W]).astype(np.int32)
    return (tin.reshape(-1).astype(np.int32), pos.reshape(-1).astype(np.int32),
            tabs, seg_of.reshape(-1).astype(np.int32))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_verify_all_logits_match_jax_prefill(tiny, layout):
    jcfg, jparams, tcfg, tparams = tiny
    rng = np.random.default_rng(11)
    caches = _caches(tiny, layout, rng)
    prompts = [rng.integers(2, 258, size=n).astype(np.int32)
               for n in (9, 17, 4, 23)]
    jck, jcv, tck, tcv = _prefill_both(tiny, caches, prompts)
    lengths = np.asarray([len(p) for p in prompts], np.int32)
    spec = np.asarray([True, False, True, True])
    tin = rng.integers(2, 258, size=(S, W)).astype(np.int32)
    start = np.where(spec, lengths, C).astype(np.int32)
    jl, jck, jcv = jllama.prefill(
        jparams, jcfg, jnp.asarray(tin), jnp.full((S,), W, jnp.int32), jck, jcv,
        jnp.arange(S, dtype=jnp.int32), jnp.asarray(start), continued=True,
        return_all_logits=True)
    tokens, pos, tabs, seg_of = _verify_pack(spec, lengths, tin)
    tl = tllama.ragged_prefill(tparams, tcfg, _t(tokens), _t(pos),
                               *(_t(t) for t in tabs), _t(seg_of), tck, tcv,
                               continued=True, all_logits=True)
    assert tuple(tl.shape) == (S * W, tcfg.vocab_size)
    tl = tl.numpy().reshape(S, W, -1)
    np.testing.assert_allclose(tl[spec], np.asarray(jl)[spec], atol=ATOL, rtol=RTOL)
    # the rows written: every speculating slot's W rows, nothing else
    for li in range(jcfg.num_layers):
        for jc, tc in ((jck, tck), (jcv, tcv)):
            jr = jkv.gather_all_rows(jkv.layer(jc, li))
            tr = tkv.gather_all_rows(tkv.layer(tc, li))
            if layout == "int8":
                assert np.abs(tr["q"].numpy().astype(np.int32)
                              - np.asarray(jr["q"]).astype(np.int32)).max() <= 1
                np.testing.assert_allclose(tr["s"].numpy(), np.asarray(jr["s"]),
                                           atol=1e-6, rtol=1e-5)
            else:
                np.testing.assert_allclose(tr.numpy(), np.asarray(jr),
                                           atol=ATOL, rtol=RTOL)
    # the non-speculating slot kept its rows and got none past them
    r0 = tkv.gather_all_rows(tkv.layer(tck, 0))
    r0 = r0["q"] if isinstance(r0, dict) else r0
    assert not r0[1, lengths[1]:].any()


def _jax_round(tiny, jck, jcv, tokens, lengths, active, spec, ring, ring_pos,
               D=W - 1, G=3):
    """One n-gram round composed from the JAX functions (greedy rows): the
    proposals, the plain decode step of the non-speculating active rows
    (argmax), the continued verify prefill, argmax at every position,
    accept_greedy, the ring pushes. Returns (out [S, W], n_out [S], the new
    tokens, lengths, ring, ring_pos, caches)."""
    jcfg, jparams, _tc, _tp = tiny
    spec_a, plain_a = active & spec, active & ~spec
    drafts = jspec.ngram_propose(jnp.asarray(tokens, jnp.int32),
                                 jnp.asarray(ring, jnp.int32),
                                 jnp.asarray(ring_pos, jnp.int32), D, G)
    wl = np.where(plain_a, lengths, C).astype(np.int32)
    logits, jck, jcv = jllama.decode_step(jparams, jcfg,
                                          jnp.asarray(tokens, jnp.int32),
                                          jnp.asarray(wl), jck, jcv)
    ids0 = np.asarray(jnp.argmax(logits, axis=-1))
    tin = jnp.concatenate([jnp.asarray(tokens, jnp.int32)[:, None], drafts], 1)
    start = np.where(spec_a, lengths, C).astype(np.int32)
    al, jck, jcv = jllama.prefill(jparams, jcfg, tin, jnp.full((S,), W, jnp.int32),
                                  jck, jcv, jnp.arange(S, dtype=jnp.int32),
                                  jnp.asarray(start), continued=True,
                                  return_all_logits=True)
    greedy = jnp.argmax(al, axis=-1).astype(jnp.int32)
    out_s, n_s, _k = jspec.accept_greedy(drafts, greedy, jnp.asarray(spec_a))
    out_s, n_s = np.asarray(out_s), np.asarray(n_s)
    out = np.where(spec[:, None], out_s,
                   np.concatenate([ids0[:, None], np.zeros((S, D), int)], 1))
    n_out = np.where(spec_a, n_s, plain_a.astype(int))
    ring, ring_pos = ring.copy(), ring_pos.copy()
    for j in range(W):
        for s in range(S):
            if active[s] and j < n_out[s]:
                ring[s, ring_pos[s] % ring.shape[1]] = out[s, j]
                ring_pos[s] += 1
    last = out[np.arange(S), np.maximum(n_out - 1, 0)]
    return (np.where(np.arange(W)[None, :] < n_out[:, None], out, 0), n_out,
            np.where(active, last, tokens), lengths + n_out, ring, ring_pos,
            jck, jcv)


def _greedy_continuation(tiny, jck, jcv, tokens, lengths, slot, n) -> list:
    """The JAX model's next ``n`` greedy tokens of ``slot`` from this
    state (the caches are values: the steps leave them as they were)."""
    jcfg, jparams, _tc, _tp = tiny
    tok, lens, out = tokens.astype(np.int32), lengths.astype(np.int32), []
    for _ in range(n):
        logits, jck, jcv = jllama.decode_step(jparams, jcfg, jnp.asarray(tok),
                                              jnp.asarray(lens), jck, jcv)
        tok = np.asarray(jnp.argmax(logits, axis=-1)).astype(np.int32)
        lens = lens + 1
        out.append(int(tok[slot]))
    return out


def _graph(tiny, tck, tcv):
    _jc, _jp, tcfg, tparams = tiny
    samp = tsamp.SlotSampler(S, tcfg.vocab_size, "cpu")
    g = DecodeGraph(tparams, tcfg, tck, tcv, samp, S, 16, "cpu", spec_width=W)
    return g, samp


@pytest.mark.parametrize("layout", LAYOUTS)
def test_spec_round_matches_the_jax_round(tiny, layout):
    """Three rounds of spec_body on the static buffers: a speculating slot
    with a repetitive history (so proposals get accepted), a plain greedy
    slot, an idle slot, a speculating slot with no match: ids, n_out, the
    chained tokens / lengths, the rings and the written rows equal the
    JAX round's."""
    rng = np.random.default_rng(5)
    caches = _caches(tiny, layout, rng)
    rep = np.asarray([7, 8, 9, 10, 11, 12] * 3, np.int32)
    prompts = [rep, rng.integers(2, 258, size=11).astype(np.int32),
               rng.integers(2, 258, size=5).astype(np.int32),
               rng.integers(2, 258, size=14).astype(np.int32)]
    jck, jcv, tck, tcv = _prefill_both(tiny, caches, prompts)
    active = np.asarray([True, True, False, True])
    spec = np.asarray([True, False, False, True])
    g, samp = _graph(tiny, tck, tcv)
    # the current token: each prompt's last, not yet written; rows hold
    # the rest (the prefill wrote the whole prompt, so lengths = len - 1
    # and the round rewrites the last row with the same token)
    tokens = np.asarray([p[-1] for p in prompts], np.int64)
    lengths = np.asarray([len(p) - 1 for p in prompts], np.int64)
    # slot 0's history holds its trailing 3-gram once before, followed by
    # the model's own greedy continuation (computed on the JAX side), so
    # its first round accepts every proposal
    cont = _greedy_continuation(tiny, jck, jcv, tokens, lengths, 0, W - 1)
    hists = [p.tolist() for p in prompts]
    hists[0] = hists[0][:-3] + hists[0][-3:] + cont + [2, 3] + hists[0][-3:]
    for s, h in enumerate(hists):
        samp.set_slot(s, tsamp.SamplingParamsHost(temperature=0.0), 0)
        samp.set_ring(s, h)
    ring = samp.ring.numpy().copy()
    ring_pos = samp.ring_pos.numpy().copy()
    g.load(np.stack([active, np.ones(S), tokens, lengths, spec]).astype(np.int64))
    fetch = g.spec_replay(3)
    got = fetch.wait()
    accepted = 0
    for r in range(3):
        out, n_out, tokens, lengths, ring, ring_pos, jck, jcv = _jax_round(
            tiny, jck, jcv, tokens, lengths, active, spec, ring, ring_pos)
        np.testing.assert_array_equal(got[r, :W].T.astype(np.int64), out)
        np.testing.assert_array_equal(got[r, 2 * W].astype(np.int64), n_out)
        accepted += int(n_out[0]) - 1
    assert accepted > 0, "the repetitive slot accepted no proposal"
    np.testing.assert_array_equal(g.tokens.numpy(), tokens)
    np.testing.assert_array_equal(g.lengths.numpy(), lengths)
    np.testing.assert_array_equal(samp.ring.numpy(), ring)
    np.testing.assert_array_equal(samp.ring_pos.numpy(), ring_pos)
    for li in range(tiny[0].num_layers):
        for jc, tc in ((jck, tck), (jcv, tcv)):
            jr = jkv.gather_all_rows(jkv.layer(jc, li))
            tr = tkv.gather_all_rows(tkv.layer(tc, li))
            for s in range(S):
                n = int(lengths[s])      # rows above a length are not compared
                if layout == "int8":
                    assert np.abs(tr["q"][s, :n].numpy().astype(np.int32)
                                  - np.asarray(jr["q"])[s, :n].astype(np.int32)
                                  ).max() <= 1
                else:
                    np.testing.assert_allclose(tr[s, :n].numpy(),
                                               np.asarray(jr)[s, :n],
                                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("full", (False, True))
def test_spec_round_equals_eager_rounds(tiny, full):
    """spec_body (what the card captures) and eager_rounds (the reference
    it is held against) from the same state: ids and n_out bit for bit,
    logprobs within the float32 tolerance, the same chained state, rings
    and rows; with a seeded sampled slot on the plain rows."""
    out = {}
    for way in ("graph", "eager"):
        caches = _caches(tiny, "paged", np.random.default_rng(1))
        _jk, _jv, tck, tcv = _prefill_both(tiny, caches, [
            np.asarray([3, 4, 5, 6] * 5, np.int32),
            np.asarray(np.random.default_rng(2).integers(2, 258, 13), np.int32),
            np.asarray([9, 9, 9, 9, 9, 9, 9], np.int32),
            np.asarray(np.random.default_rng(3).integers(2, 258, 6), np.int32)])
        g, samp = _graph(tiny, tck, tcv)
        prompts = [[3, 4, 5, 6] * 5, None, [9] * 7, None]
        for s in range(S):
            temp = 0.9 if s == 1 else 0.0
            samp.set_slot(s, tsamp.SamplingParamsHost(temperature=temp, seed=4), 0)
            if prompts[s]:
                samp.set_ring(s, prompts[s])
        tokens = np.asarray([6, 17, 9, 40])
        lengths = np.asarray([19, 12, 6, 5])
        active = np.asarray([True, True, True, False])
        spec = np.asarray([True, False, True, False])
        g.load(np.stack([active, np.ones(S), tokens, lengths, spec]).astype(np.int64))
        res = (g.spec_replay(3, full=full).wait() if way == "graph"
               else g.spec_eager(3, full=full))
        out[way] = (res, g.tokens.numpy().copy(), g.lengths.numpy().copy(),
                    samp.ring.numpy().copy(), samp.counter.numpy().copy(),
                    tkv.gather_all_rows(tkv.layer(tck, 1)).numpy())
    (a, ta, la, ra, ca, rows_a), (b, tb, lb, rb, cb, rows_b) = out["graph"], out["eager"]
    np.testing.assert_array_equal(a[:, :W], b[:, :W])
    np.testing.assert_array_equal(a[:, 2 * W], b[:, 2 * W])
    np.testing.assert_allclose(a[:, W:2 * W], b[:, W:2 * W], atol=ATOL, rtol=RTOL)
    for x, y in ((ta, tb), (la, lb), (ra, rb), (ca, cb)):
        np.testing.assert_array_equal(x, y)
    for s in range(S):
        np.testing.assert_allclose(rows_a[s, :la[s]], rows_b[s, :lb[s]],
                                   atol=ATOL, rtol=RTOL)
    assert (a[:, 2 * W, :3] >= 1).all()  # every active slot emitted
    assert (a[:, 2 * W, 3] == 0).all()   # the idle slot emitted nothing
