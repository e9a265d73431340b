"""The rounding of K2's tensor-core body (bfloat16), modelled on the CPU.

The kernel (localai_tpu_torch/ops/kernels/csrc/ragged_prefill.cu) runs
only on the card, where chip_smoke.py and tests/test_torch_kernels.py hold
it against ``ragged_prefill_plain`` at atol 2e-2, rtol 2e-2. ``tc_model``
below is a plain-torch model of that body that rounds where it rounds:
bf16 inputs; f32 scores (exact bf16 products summed in f32) scaled by
1/sqrt(hd) after the product, in the log2 domain; int8 pages widened to
bf16 (exact); the key scale on the score column, the value scale on the P
column after the denominator took P; P rounded to bf16 before P.V; f32
accumulation; an online softmax over the kernel's key tiles (64 rows, 32 at
hd 256; committed rows first, then the pack's keys). The tests show that
(1) without its bf16 roundings the model IS the plain version (1e-5 in
float32), so it walks the same keys with the same masks and scale folds,
and (2) with them it stays inside the card check's bf16 tolerance of the
plain version, on fresh, continued, pad and int8 packs, G 1 / 4 / 7, hd 64
/ 128, committed lengths 1, 63, 64, 65 and packs whose length is no
multiple of any tile.
"""

from __future__ import annotations

import tests.torch_cpu  # noqa: F401  (one torch CPU thread)

import math

import numpy as np
import pytest
import torch

from localai_tpu_torch.ops import kvcache
from localai_tpu_torch.ops.ragged_prefill import ragged_prefill_plain

KV, S, PG, MP = 2, 8, 16, 16
N_PAGES = S * MP
N = 141
BF16_TOL = dict(atol=2e-2, rtol=2e-2)      # chip_smoke.py's bf16 tolerance
SEGS = {
    "fresh": [(0, 0, 37), (1, 0, 20), (2, 0, 1), (3, 0, 70), (4, 0, 9)],
    "continued": [(0, 1, 37), (1, 63, 20), (2, 64, 1), (3, 65, 70), (4, 0, 9)],
    "pad": [(5, 65, 30), (6, 0, 41)],       # 70 pad tokens, 6 pad segments
}


def tc_model(q, ck, cv, pages_k, pages_v, ptab, seg_slots, seg_start,
             seg_off, seg_len, G, scales_k=None, scales_v=None,
             continued=True, round_bf16=True):
    """The tensor-core body's arithmetic in plain torch. ``round_bf16``
    False keeps P in float32 (and the output): the model's algorithm
    without its roundings."""
    n_tok, _H, hd = q.shape
    kv = ck.shape[1]
    kt = 32 if hd > 128 else 64
    c2 = torch.tensor(hd, dtype=torch.float32).rsqrt() * np.float32(math.log2(math.e))
    quant = scales_k is not None
    n_pages, pg = pages_k.shape[0], pages_k.shape[1]
    mp = ptab.shape[1]
    out = torch.zeros((n_tok, kv, G, hd), dtype=torch.float32)
    qf = q.float().reshape(n_tok, kv, G, hd)
    for b in range(seg_slots.shape[0]):
        ln, off = int(seg_len[b]), int(seg_off[b])
        if ln <= 0:
            continue
        slot = int(seg_slots[b])
        start = min(max(int(seg_start[b]), 0), mp * pg) if continued else 0
        if not 0 <= slot < ptab.shape[0]:
            start = 0
        # the committed rows through the table (unallocated: zeros, scale 0)
        pages = ptab[slot if start else 0].long()
        rows = torch.arange(start)
        page = pages[rows // pg]
        ok = (page >= 0) & (page < n_pages)
        phys = page.clamp(0, n_pages - 1) * pg + rows % pg
        kc = pages_k.reshape(n_pages * pg, kv, hd)[phys].float() * ok[:, None, None]
        vc = pages_v.reshape(n_pages * pg, kv, hd)[phys].float() * ok[:, None, None]
        ones = torch.ones((start, kv))
        skc = scales_k.reshape(-1, kv)[phys] * ok[:, None] if quant else ones
        svc = scales_v.reshape(-1, kv)[phys] * ok[:, None] if quant else ones
        tok = torch.arange(off, off + ln)
        tiles = [(kc[j:j + kt], vc[j:j + kt], skc[j:j + kt], svc[j:j + kt],
                  torch.ones((ln, min(kt, start - j)), dtype=torch.bool))
                 for j in range(0, start, kt)]
        for j in range(0, ln, kt):
            m = torch.arange(off + j, min(off + j + kt, off + ln))
            tiles.append((ck[m].float(), cv[m].float(), torch.ones((len(m), kv)),
                          torch.ones((len(m), kv)), m[None, :] <= tok[:, None]))
        mx = torch.full((kv, G, ln), -1e30)
        den = torch.zeros((kv, G, ln))
        acc = torch.zeros((kv, G, ln, hd))
        qs = qf[off:off + ln]
        for k_t, v_t, ks, vs, mask in tiles:
            s = torch.einsum("nkgd,mkd->kgnm", qs, k_t) * c2 * ks.T[:, None, None, :]
            s = torch.where(mask, s, torch.full_like(s, -1e30))
            m_new = torch.maximum(mx, s.amax(dim=-1))
            alpha = torch.exp2(mx - m_new)
            p = torch.where(mask, torch.exp2(s - m_new[..., None]), torch.zeros_like(s))
            den = den * alpha + p.sum(dim=-1)
            p = p * vs.T[:, None, None, :]
            if round_bf16:
                p = p.to(torch.bfloat16).float()
            acc = acc * alpha[..., None] + torch.einsum("kgnm,mkd->kgnd", p, v_t)
            mx = m_new
        o = torch.where(den[..., None] > 0, acc / den.clamp_min(1e-30)[..., None],
                        torch.zeros_like(acc))
        out[off:off + ln] = o.permute(2, 0, 1, 3)
    out = out.reshape(n_tok, kv * G, hd)
    return out.to(torch.bfloat16) if round_bf16 else out


def _case(kind, G, hd, dtype, seed):
    """(args, kwargs, continued, real) for ragged_prefill_plain / tc_model,
    made with numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    segs = SEGS["continued" if kind == "int8" else kind]
    rows = [0] * S
    for slot, start, n in segs:
        rows[slot] = start + n
    perm = rng.permutation(N_PAGES).astype(np.int32)
    ptab = np.full((S, MP), N_PAGES, dtype=np.int32)
    nxt = 0
    for s, r in enumerate(rows):
        k = -(-r // PG)
        ptab[s, :k] = perm[nxt:nxt + k]
        nxt += k
    tabs = np.zeros((4, S), dtype=np.int32)
    tabs[0] = S                                        # pad segments: sentinel slot
    real = np.zeros(N, dtype=bool)
    off = 0
    for b, (slot, start, n) in enumerate(segs):
        tabs[:, b] = (slot, start, off, n)
        real[off:off + n] = True
        off += n

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    pk, pv = randn(N_PAGES, PG, KV, hd), randn(N_PAGES, PG, KV, hd)
    kw = {}
    if kind == "int8":
        (pk, sk), (pv, sv) = kvcache.quantize(pk), kvcache.quantize(pv)
        kw = {"scales_k": sk, "scales_v": sv}
    else:
        pk, pv = pk.to(dtype), pv.to(dtype)
    q = randn(N, KV * G, hd).to(dtype)
    ck, cv = randn(N, KV, hd).to(dtype), randn(N, KV, hd).to(dtype)
    args = (q, ck, cv, pk, pv, torch.from_numpy(ptab),
            *(torch.from_numpy(t) for t in tabs))
    return args, kw, kind != "fresh", torch.from_numpy(real)


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("G", [1, 4, 7])
@pytest.mark.parametrize("kind", ["fresh", "continued", "pad", "int8"])
def test_model_without_rounding_is_the_plain_version(kind, G, hd):
    args, kw, continued, real = _case(kind, G, hd, torch.float32, 100 + G + hd)
    got = tc_model(*args, G, **kw, continued=continued, round_bf16=False)
    ref = ragged_prefill_plain(*args, G, **kw, continued=continued)
    torch.testing.assert_close(got[real], ref[real], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("G", [1, 4, 7])
@pytest.mark.parametrize("kind", ["fresh", "continued", "pad", "int8"])
def test_kernel_rounding_within_card_tolerance(kind, G, hd):
    args, kw, continued, real = _case(kind, G, hd, torch.bfloat16, 200 + G + hd)
    got = tc_model(*args, G, **kw, continued=continued)
    ref = ragged_prefill_plain(*args, G, **kw, continued=continued)
    assert got.dtype == ref.dtype == torch.bfloat16
    assert (got[~real] == 0).all()                    # pad rows: zeros, as on the card
    torch.testing.assert_close(got[real].float(), ref[real].float(), **BF16_TOL)


def test_model_tiles_hd256_in_32_key_tiles():
    """hd 256 takes 32-key tiles; the model walks them like the kernel and
    stays inside the tolerance there too."""
    args, kw, continued, real = _case("continued", 4, 256, torch.bfloat16, 7)
    got = tc_model(*args, 4, **kw, continued=continued)
    ref = ragged_prefill_plain(*args, 4, **kw, continued=continued)
    torch.testing.assert_close(got[real].float(), ref[real].float(), **BF16_TOL)
