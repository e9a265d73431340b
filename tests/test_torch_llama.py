"""Parity of the PyTorch port's llama model and weight loading with the
JAX package, on the CPU, on the tests/tinymodel.py checkpoint (hidden
64, 2 layers, 4 / 2 heads; float32).

  * the numpy-only safetensors reader and from_jax_params give the same
    leaves as the JAX package's weights.load_llama_params (exact: both
    are float32 copies of the same bytes);
  * ragged_prefill (a fresh pack, then a continued pack with pad tokens
    and a pad segment) and decode_step logits match the JAX llama on a
    paged cache with a scrambled page table, within the JAX package's
    torch-parity tolerance (atol 2e-4 / rtol 2e-3: float32 matmuls summed
    in another order), and the caches hold the same rows afterwards.
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

from localai_tpu.engine import weights as jweights
from localai_tpu.models import llama as jllama
from localai_tpu.ops import kvcache as jkv
from localai_tpu_torch.engine import weights as tweights
from localai_tpu_torch.models import llama as tllama
from localai_tpu_torch.ops import kvcache as tkv

ATOL, RTOL = 2e-4, 2e-3
S, C, PG = 4, 64, 16


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    from tests.tinymodel import write_tiny_checkpoint

    d = str(tmp_path_factory.mktemp("tiny_llama"))
    write_tiny_checkpoint(d)
    with open(os.path.join(d, "config.json")) as f:
        hf = json.load(f)
    jcfg = jllama.LlamaConfig.from_hf_config(hf, dtype=jnp.float32)
    jparams = jweights.load_llama_params(d, jcfg, dtype=jnp.float32)
    tcfg = tllama.LlamaConfig.from_hf_config(hf, dtype=torch.float32)
    tparams = tweights.load_llama_params(d, tcfg, device="cpu")
    return d, jcfg, jparams, tcfg, tparams


def _leaves(params, prefix=()):
    for k, v in sorted(params.items()):
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def test_safetensors_reader_matches_jax_loader(tiny):
    _d, _jcfg, jparams, _tcfg, tparams = tiny
    j = dict(_leaves(jparams))
    t = dict(_leaves(tparams))
    assert sorted(j) == sorted(t)
    for k in j:
        np.testing.assert_array_equal(t[k], j[k], err_msg=str(k))


def test_from_jax_params_matches_loader(tiny):
    _d, _jcfg, jparams, tcfg, tparams = tiny
    np_params = jax.tree.map(np.asarray, jparams)
    conv = tweights.from_jax_params(np_params, tcfg, device="cpu")
    for (k, a), (k2, b) in zip(_leaves(conv), _leaves(tparams)):
        assert k == k2
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _ptab(rng):
    mp = C // PG
    return rng.permutation(S * mp).astype(np.int32).reshape(S, mp)


def _pack(segs, N, tokens_of):
    """segs: [(slot, start, length)] -> the engine packer's arrays, with
    trailing pad tokens (position C, segment sentinel S) up to N."""
    tokens = np.zeros((N,), np.int32)
    positions = np.full((N,), C, np.int32)
    seg_of = np.full((N,), S, np.int32)
    seg_slots = np.full((S,), S, np.int32)
    seg_start = np.zeros((S,), np.int32)
    seg_off = np.zeros((S,), np.int32)
    seg_len = np.zeros((S,), np.int32)
    off = 0
    for b, (slot, start, ln) in enumerate(segs):
        tokens[off:off + ln] = tokens_of[slot][start:start + ln]
        positions[off:off + ln] = np.arange(start, start + ln)
        seg_of[off:off + ln] = b
        seg_slots[b], seg_start[b], seg_off[b], seg_len[b] = slot, start, off, ln
        off += ln
    return tokens, positions, seg_of, seg_slots, seg_start, seg_off, seg_len


def test_prefill_and_decode_logits_match_jax(tiny):
    _d, jcfg, jparams, tcfg, tparams = tiny
    rng = np.random.default_rng(0)
    ptab = _ptab(rng)
    jck, jcv = jllama.init_cache(jcfg, S, C, jnp.float32, page_size=PG)
    jck = jkv.with_page_table(jck, jnp.asarray(ptab))
    jcv = jkv.with_page_table(jcv, jnp.asarray(ptab))
    tck, tcv = tllama.init_cache(tcfg, S, C, PG, device="cpu")
    tck["ptab"] = tcv["ptab"] = torch.from_numpy(ptab)
    prompts = {s: rng.integers(2, 258, size=30).astype(np.int32)
               for s in range(S)}
    lengths = np.zeros((S,), np.int32)

    # fresh pack (slots 0, 2), then a continued pack (slot 0 continues,
    # slot 1 fresh, slot 2 continues mid-page) with a pad tail
    for segs, N, continued in (([(0, 0, 10), (2, 0, 7)], 24, False),
                               ([(0, 10, 6), (1, 0, 5), (2, 7, 4)], 20, True)):
        arrs = _pack(segs, N, prompts)
        jl, jck, jcv = jllama.ragged_prefill(
            jparams, jcfg, *map(jnp.asarray, arrs), jck, jcv,
            continued=continued)
        tok, pos, seg_of, sl, st, so, sn = (torch.from_numpy(a) for a in arrs)
        tlog = tllama.ragged_prefill(tparams, tcfg, tok, pos, sl, st, so, sn,
                                     seg_of, tck, tcv)
        real = [b for b in range(S) if arrs[6][b] > 0]
        np.testing.assert_allclose(tlog.numpy()[real], np.asarray(jl)[real],
                                   atol=ATOL, rtol=RTOL)
        for slot, start, ln in segs:
            lengths[slot] = start + ln

    # three decode steps for every slot (slot 3 starts empty)
    toks = rng.integers(2, 258, size=(3, S)).astype(np.int32)
    for step in range(3):
        jl, jck, jcv = jllama.decode_step(jparams, jcfg,
                                          jnp.asarray(toks[step]),
                                          jnp.asarray(lengths), jck, jcv)
        tlog = tllama.decode_step(tparams, tcfg, torch.from_numpy(toks[step]),
                                  torch.from_numpy(lengths), tck, tcv)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jl),
                                   atol=ATOL, rtol=RTOL)
        lengths += 1
    for li in range(jcfg.num_layers):
        for jc, tc in ((jck, tck), (jcv, tcv)):
            np.testing.assert_allclose(
                tkv.gather_all_rows(tkv.layer(tc, li)).numpy(),
                np.asarray(jkv.gather_all_rows(jkv.layer(jc, li))),
                atol=ATOL, rtol=RTOL)


def test_decode_step_inactive_slots_write_nothing(tiny):
    """engine_decode's contract: an inactive slot's KV write is dropped
    (position sentinel C), active slots still match JAX engine_decode."""
    _d, jcfg, jparams, tcfg, tparams = tiny
    rng = np.random.default_rng(1)
    ptab = _ptab(rng)
    jck, jcv = jllama.init_cache(jcfg, S, C, jnp.float32, page_size=PG)
    jck = jkv.with_page_table(jck, jnp.asarray(ptab))
    jcv = jkv.with_page_table(jcv, jnp.asarray(ptab))
    tck, tcv = tllama.init_cache(tcfg, S, C, PG, device="cpu")
    tck["ptab"] = tcv["ptab"] = torch.from_numpy(ptab)
    toks = rng.integers(2, 258, size=(S,)).astype(np.int32)
    lengths = np.array([3, 0, 9, 5], np.int32)
    active = np.array([True, False, True, False])
    jl, jck, jcv = jllama.engine_decode(
        jparams, jcfg, jnp.asarray(toks), jnp.asarray(lengths),
        jnp.asarray(active), jck, jcv)
    tl = tllama.decode_step(tparams, tcfg, torch.from_numpy(toks),
                            torch.from_numpy(lengths), tck, tcv,
                            active=torch.from_numpy(active))
    np.testing.assert_allclose(tl.numpy()[active], np.asarray(jl)[active],
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(
        tkv.pool(tkv.layer(tck, 0)).numpy(),
        np.asarray(jck["pages"][0]), atol=ATOL, rtol=RTOL)
