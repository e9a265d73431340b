"""Parity of the PyTorch port's ops (localai_tpu_torch/ops) with the JAX
package's, on the CPU, at tiny sizes.

Inputs are made from a seed with numpy and fed to both packages. What is
pinned:
  * rope (none / linear / llama3) and rms_norm;
  * the paged scatter with JAX's drop sentinels (inactive-slot position
    C, pad tokens, unallocated page-table entries) and gather_all_rows;
  * K1's plain version (paged decode attention with the token appended)
    against ops/attention.py::decode_attention_append AND the Pallas
    kernel in interpret mode;
  * K2's plain version (ragged packed prefill) against
    ops/ragged_prefill.py::ragged_prefill_attention AND the Pallas kernel
    in interpret mode, for fresh, continued and pad segments;
  * the kernel wrappers route CPU tensors to the plain versions and count
    no launch (the kernels themselves: tests/test_torch_kernels.py).

Tolerances: everything runs in float32. Elementwise ops (rope, norm) and
row moves (scatter, gather) agree to float32 rounding (1e-6 / exact);
attention sums in a different order than XLA (softmax over a
concatenation vs the jnp einsums), 2e-5 absolute for unit-scale inputs,
and 2e-4 against the Pallas kernels — the tolerance the JAX package's own
interpret-mode tests use.
"""

from __future__ import annotations

import tests.torch_cpu  # noqa: F401  (one torch CPU thread)

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localai_tpu.ops import kvcache as jkv
from localai_tpu.ops import norms as jnorms
from localai_tpu.ops import rope as jrope
from localai_tpu_torch.ops import kvcache as tkv
from localai_tpu_torch.ops import norms as tnorms
from localai_tpu_torch.ops import rope as trope
from localai_tpu_torch.ops.kernels import LAUNCHES


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


@dataclasses.dataclass
class _RopeCfg:
    head_dim_: int = 16
    rope_theta: float = 500000.0
    rope_scaling_type: str = "none"
    rope_scaling_factor: float = 1.0
    rope_low_freq_factor: float = 1.0
    rope_high_freq_factor: float = 4.0
    rope_original_max_position: int = 8192


@pytest.mark.parametrize("kind,factor", [("none", 1.0), ("linear", 4.0),
                                         ("llama3", 8.0)])
def test_rope_matches_jax(kind, factor):
    cfg = _RopeCfg(rope_scaling_type=kind, rope_scaling_factor=factor)
    np.testing.assert_allclose(trope._scaled_inv_freq(cfg),
                               jrope._scaled_inv_freq(cfg), rtol=1e-12)
    rng = np.random.default_rng(0)
    pos = rng.integers(0, 9000, size=(2, 5)).astype(np.int32)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    js, jc = jrope.rope_frequencies(cfg, jnp.asarray(pos))
    ts, tc = trope.rope_frequencies(cfg, _t(pos))
    # sin/cos of large angles: float32 argument rounding dominates
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=2e-5)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=2e-5)
    out_j = jrope.apply_rope(jnp.asarray(x), js, jc)
    out_t = trope.apply_rope(_t(x), _t(js), _t(jc))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=1e-6)


def test_rms_norm_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 7, 64)).astype(np.float32)
    w = rng.normal(size=(64,)).astype(np.float32)
    np.testing.assert_allclose(
        tnorms.rms_norm(_t(x), _t(w), 1e-5).numpy(),
        np.asarray(jnorms.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)),
        rtol=1e-6, atol=1e-6)


# ---------- paged cache ----------

S, C, KV, HD, PG = 3, 32, 2, 16, 8        # 4 pages per slot, 12 in the pool


def _ptab():
    """Scrambled tables with unallocated (sentinel) tail entries."""
    n = S * C // PG
    ptab = np.full((S, C // PG), n, np.int32)
    ptab[0, :3] = [7, 2, 9]
    ptab[1, :4] = [0, 11, 5, 3]
    ptab[2, :1] = [4]
    return ptab


def _caches(pool_np, ptab):
    jc = {"pages": jnp.asarray(pool_np)[None], "ptab": jnp.asarray(ptab)}
    tc = {"pages": torch.cat([_t(pool_np), torch.zeros(1, PG, KV, HD)])[None],
          "ptab": _t(ptab)}
    return jc, tc


def test_paged_scatter_drops_sentinels_like_jax():
    """Decode rows of an inactive slot (position C), pad tokens of a pack
    (position C, sentinel slot) and rows landing on unallocated pages are
    DROPPED in both packages; every other row lands on the same page."""
    rng = np.random.default_rng(2)
    n = S * C // PG
    ptab = _ptab()
    pool = rng.normal(size=(n, PG, KV, HD)).astype(np.float32)
    jc, tc = _caches(pool, ptab)
    jl, tl = jkv.layer(jc, 0), tkv.layer(tc, 0)

    # decode: slot 0 mid-page, slot 1 inactive (C), slot 2 on an
    # unallocated page (row 12 -> table entry 1 is the sentinel)
    lengths = np.array([13, C, 12], np.int32)
    new = rng.normal(size=(S, KV, HD)).astype(np.float32)
    jl = jkv.scatter_decode(jl, jnp.arange(S), jnp.asarray(lengths),
                            jnp.asarray(new))
    tkv.scatter_decode(tl, torch.arange(S), _t(lengths), _t(new))

    # ragged pack: two real segments and pad tokens (position C, the
    # clamped sentinel slot)
    slot_of = np.array([1, 1, 1, 0, 0, S - 1, S - 1], np.int32)
    cols = np.array([20, 21, 22, 3, 4, C, C], np.int32)
    newp = rng.normal(size=(7, KV, HD)).astype(np.float32)
    jfull = jkv.scatter_ragged({"pages": jl["pages"][None], "ptab": jl["ptab"]},
                               0, jnp.asarray(slot_of), jnp.asarray(cols),
                               jnp.asarray(newp))
    tkv.scatter_ragged(tl, _t(slot_of), _t(cols), _t(newp))

    np.testing.assert_array_equal(tkv.pool(tl).numpy(),
                                  np.asarray(jfull["pages"][0]))
    # the rows moved exactly as JAX's dropped/landed writes say
    np.testing.assert_array_equal(
        tkv.gather_all_rows(tl).numpy(),
        np.asarray(jkv.gather_all_rows(jkv.layer(jfull, 0))))
    # and something did land (the test is not vacuous)
    assert not np.array_equal(tkv.pool(tl).numpy(), pool)


def test_gather_all_rows_zero_fills_unallocated():
    rng = np.random.default_rng(3)
    n = S * C // PG
    pool = rng.normal(size=(n, PG, KV, HD)).astype(np.float32)
    jc, tc = _caches(pool, _ptab())
    rows = tkv.gather_all_rows(tkv.layer(tc, 0)).numpy()
    np.testing.assert_array_equal(
        rows, np.asarray(jkv.gather_all_rows(jkv.layer(jc, 0))))
    assert (rows[2, PG:] == 0).all()


# ---------- K1: paged decode attention ----------

def _k1_inputs(seed=4, G=3, hd=16):
    rng = np.random.default_rng(seed)
    S_, KV_, pg, mp, n_pages = 4, 2, 8, 4, 10
    q = rng.normal(size=(S_, KV_ * G, hd)).astype(np.float32)
    nk = rng.normal(size=(S_, KV_, hd)).astype(np.float32)
    nv = rng.normal(size=(S_, KV_, hd)).astype(np.float32)
    pk = rng.normal(size=(n_pages, pg, KV_, hd)).astype(np.float32)
    pv = rng.normal(size=(n_pages, pg, KV_, hd)).astype(np.float32)
    ptab = np.full((S_, mp), n_pages, np.int32)
    ptab[0, :3] = [5, 1, 7]            # out-of-order pages
    ptab[1, :1] = [2]                  # partial page
    ptab[2] = [0, 3, 4, 6]             # full table
    lengths = np.array([20, 5, 32, 0], np.int32)   # slot 3: empty
    return q, nk, nv, pk, pv, ptab, lengths, G


@pytest.mark.parametrize("reference", ["jnp", "pallas_interpret"])
def test_k1_plain_matches_jax(reference):
    from localai_tpu.ops.attention import decode_attention_append
    from localai_tpu.ops.pallas.paged_attention import (
        paged_decode_attention_append)
    from localai_tpu_torch.ops.paged_attention import paged_decode_attention

    q, nk, nv, pk, pv, ptab, lengths, G = _k1_inputs()
    before = dict(LAUNCHES)
    out = paged_decode_attention(_t(q), _t(nk), _t(nv), _t(pk), _t(pv),
                                 _t(ptab), _t(lengths), G)
    assert LAUNCHES == before            # CPU tensors: plain version, no launch
    if reference == "jnp":
        lk = {"pages": jnp.asarray(pk), "ptab": jnp.asarray(ptab)}
        lv = {"pages": jnp.asarray(pv), "ptab": jnp.asarray(ptab)}
        ref = decode_attention_append(
            jnp.asarray(q), jnp.asarray(nk), jnp.asarray(nv),
            jkv.gather_all_rows(lk), jkv.gather_all_rows(lv),
            jnp.asarray(lengths), G)
        atol = 2e-5
    else:
        ref = paged_decode_attention_append(
            jnp.asarray(q), jnp.asarray(nk), jnp.asarray(nv), jnp.asarray(pk),
            jnp.asarray(pv), jnp.asarray(ptab), jnp.asarray(lengths), G,
            interpret=True)
        atol = 2e-4
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=atol)


# ---------- K2: ragged packed prefill ----------

def _k2_case(kind: str, seed=5, G=3, hd=16):
    """A paged pool + pack. kind: fresh (all seg_start 0), continued
    (committed prefixes, mid-page), pad (continued + empty pad segments
    and pad tokens between real ones)."""
    rng = np.random.default_rng(seed)
    S_, C_, KV_, pg, N = 4, 32, 2, 8, 24
    mp = C_ // pg
    n_pages = S_ * mp
    perm = rng.permutation(n_pages).astype(np.int32)
    ptab = perm.reshape(S_, mp)
    pk = rng.normal(size=(n_pages, pg, KV_, hd)).astype(np.float32)
    pv = rng.normal(size=(n_pages, pg, KV_, hd)).astype(np.float32)
    if kind == "fresh":
        segs = [(0, 1, 0, 0, 6), (1, 3, 0, 6, 10), (2, 0, 0, 16, 8)]
    elif kind == "continued":
        segs = [(0, 1, 20, 0, 6), (1, 3, 0, 6, 10), (2, 0, 7, 16, 8)]
    else:
        segs = [(0, 1, 20, 0, 6), (2, 0, 7, 9, 4)]   # tokens 6..8, 13.. are pads
    seg_of = np.full((N,), S_, np.int32)
    seg_slots = np.full((S_,), S_, np.int32)
    seg_start = np.zeros((S_,), np.int32)
    seg_off = np.zeros((S_,), np.int32)
    seg_len = np.zeros((S_,), np.int32)
    for b, slot, start, off, ln in segs:
        seg_of[off:off + ln] = b
        seg_slots[b], seg_start[b], seg_off[b], seg_len[b] = slot, start, off, ln
    q = rng.normal(size=(N, KV_ * G, hd)).astype(np.float32)
    ck = rng.normal(size=(N, KV_, hd)).astype(np.float32)
    cv = rng.normal(size=(N, KV_, hd)).astype(np.float32)
    return dict(q=q, ck=ck, cv=cv, pk=pk, pv=pv, ptab=ptab, seg_of=seg_of,
                seg_slots=seg_slots, seg_start=seg_start, seg_off=seg_off,
                seg_len=seg_len, G=G, real=seg_of < S_)


@pytest.mark.parametrize("kind", ["fresh", "continued", "pad"])
@pytest.mark.parametrize("reference", ["jnp", "pallas_interpret"])
def test_k2_plain_matches_jax(kind, reference):
    from localai_tpu.ops.pallas.ragged_prefill import (
        ragged_prefill_attention_pallas)
    from localai_tpu.ops.ragged_prefill import ragged_prefill_attention
    from localai_tpu_torch.ops.ragged_prefill import (
        ragged_prefill_attention_paged)

    c = _k2_case(kind)
    j = {k: jnp.asarray(v) for k, v in c.items() if isinstance(v, np.ndarray)}
    before = dict(LAUNCHES)
    out = ragged_prefill_attention_paged(
        _t(c["q"]), _t(c["ck"]), _t(c["cv"]), _t(c["pk"]), _t(c["pv"]),
        _t(c["ptab"]), _t(c["seg_slots"]), _t(c["seg_start"]),
        _t(c["seg_off"]), _t(c["seg_len"]), c["G"]).numpy()
    assert LAUNCHES == before
    if reference == "jnp":
        lk = {"pages": j["pk"], "ptab": j["ptab"]}
        lv = {"pages": j["pv"], "ptab": j["ptab"]}
        ref = ragged_prefill_attention(
            j["q"], j["ck"], j["cv"], j["seg_of"], j["seg_slots"],
            j["seg_start"], lk, lv, c["G"], continued=kind != "fresh")
        atol = 2e-5
    else:
        ref = ragged_prefill_attention_pallas(
            j["q"], j["ck"], j["cv"], j["pk"], j["pv"], j["ptab"],
            j["seg_slots"], j["seg_start"], j["seg_off"], j["seg_len"],
            c["G"], pkb=8, interpret=True)
        atol = 2e-4
    real = c["real"]
    np.testing.assert_allclose(out[real], np.asarray(ref)[real], atol=atol)


# ---------- sampling ----------

def test_filter_window_matches_jax():
    """Top-k / top-p / min-p keep masks and filtered log-probs of the
    port's sampler == the JAX sampler's filter_window (penalties, typical
    and mirostat traced out) — 1e-5 absolute on the log-probs, float32
    softmax in both."""
    from localai_tpu.engine import sampling as jsamp
    from localai_tpu_torch.engine import sampling as tsamp

    rng = np.random.default_rng(6)
    R, V = 5, 300
    logits = (rng.normal(size=(R, V)) * 3).astype(np.float32)
    temperature = np.array([0.7, 1.0, 1.3, 0.5, 1.0], np.float32)
    top_k = np.array([0, 40, 5, 256, 1], np.int32)
    top_p = np.array([0.9, 1.0, 0.5, 0.95, 1.0], np.float32)
    min_p = np.array([0.0, 0.05, 0.0, 0.2, 0.0], np.float32)
    sp = jsamp.make_slot_params(R)
    sp.update(temperature=temperature, top_k=top_k, top_p=top_p, min_p=min_p)
    sp = {k: jnp.asarray(v) for k, v in sp.items()}
    j_idx, j_masked, j_vals = jsamp.filter_window(
        jnp.asarray(logits), sp, None, None, jnp.zeros((R, V), jnp.float32),
        use_penalties=False, use_typical=False, use_mirostat=False)
    sm = tsamp.SlotSampler(R, V, "cpu")
    sm.p.update(temperature=_t(temperature), top_k=_t(top_k).long(),
                top_p=_t(top_p), min_p=_t(min_p))
    t_idx, t_masked, t_vals = tsamp.filter_window(
        _t(logits), sm.p, sm.ring, sm.ring_pos, sm.bias, full=False)
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    jm = np.asarray(j_masked)
    tm = t_masked.numpy()
    np.testing.assert_array_equal(np.isfinite(tm), np.isfinite(jm))
    np.testing.assert_allclose(tm[np.isfinite(tm)], jm[np.isfinite(jm)],
                               atol=1e-5)


def test_sampler_greedy_and_seeded_draws():
    """Greedy rows take the argmax; equal seeds give equal draws; a row
    marked draw=False does not advance its slot's generator."""
    from localai_tpu_torch.engine.sampling import SamplingParamsHost, SlotSampler

    rng = np.random.default_rng(7)
    row = rng.normal(size=(1, 50)).astype(np.float32)
    logits = _t(np.concatenate([rng.normal(size=(1, 50)).astype(np.float32),
                                row, row]))
    sm = SlotSampler(3, 50, "cpu")
    sm.set_slot(0, SamplingParamsHost(temperature=0.0), 1)
    for s in (1, 2):
        sm.set_slot(s, SamplingParamsHost(temperature=1.0, top_k=0,
                                          top_p=1.0, seed=11), 1)
    ids, lps = sm.sample(logits, [0, 1, 2])
    assert int(ids[0]) == int(torch.argmax(logits[0]))
    assert int(ids[1]) == int(ids[2])
    assert torch.isfinite(lps).all()
    seq2 = [int(sm.sample(logits, [0, 1, 2], draw=[True, False, True])[0][2])
            for _ in range(6)]
    seq1 = [int(sm.sample(logits, [0, 1, 2], draw=[True, True, False])[0][1])
            for _ in range(6)]
    assert seq1 == seq2            # slot 1 replays slot 2's draws, in order
