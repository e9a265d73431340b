"""Ragged packed-prefill attention (counterpart of
localai_tpu/ops/ragged_prefill.py and ops/pallas/ragged_prefill.py).

One pack of N tokens holds the prompt tails of up to B slots: segment b
occupies pack indices [seg_off[b], seg_off[b] + seg_len[b]) and its token
at pack index n sits at cache position seg_start[b] + (n - seg_off[b]) of
slot seg_slots[b]. Each query attends its slot's committed rows
[0, seg_start[b]) plus the pack's own keys m <= n of the same segment.

``ragged_prefill_attention`` is the plain version (K2's reference, the
JAX jnp op ported line for line, int8 committed rows included: their key
scale folds into the scores, their value scale into the probabilities);
``ragged_prefill_attention_paged`` is the wrapper the model calls: on
CUDA tensors it launches a hand-written kernel of
ops/kernels/csrc/ragged_prefill.cu, or raises; on CPU tensors it runs the
plain version. Which kernel:

  * a fresh pack (``continued=False``: no committed rows) -> K2 without
    reading the cache, whatever the cache's dtype or layout;
  * a continued pack over float pages -> K2;
  * a continued pack over int8 pages (``scales_k``/``scales_v`` given) ->
    K2-int8. (The JAX package sends int8 packs to its jnp op; here that
    op's counterpart is the plain version, which serves no card path.)

The contiguous layout is K2 over pages of C rows with the identity table
(ops/kvcache.py).

Pad conventions (the engine packer's): pad tokens carry seg_of == B (the
sentinel), pad segments seg_len == 0 and a sentinel slot id.
"""

from __future__ import annotations

import math

import torch

from localai_tpu_torch.ops import kvcache
from localai_tpu_torch.ops.kernels import LAUNCHES, build
from localai_tpu_torch.ops.paged_attention import check_kernel_args, cuda_stream

_NEG_INF = -1e30


def kernel_supports(kv_heads: int, q_per_kv: int, head_dim: int) -> bool:
    """Can the K2 kernel take these head shapes? (The counterpart of the
    JAX package's ragged_kernel_plan: the engine counts packs that could
    not, a counter that must stay 0.)"""
    return (kv_heads > 0 and 1 <= q_per_kv <= 64 and head_dim in (32, 64, 128, 256))


def seg_of_from_tables(N: int, seg_off: torch.Tensor, seg_len: torch.Tensor
                       ) -> torch.Tensor:
    """[N] segment id per pack token (pads: the sentinel B)."""
    B = seg_off.shape[0]
    idx = torch.arange(N, device=seg_off.device)
    seg_of = torch.full((N,), B, dtype=torch.int32, device=seg_off.device)
    for b in range(B):
        inside = (idx >= seg_off[b]) & (idx < seg_off[b] + seg_len[b])
        seg_of = torch.where(inside & (seg_len[b] > 0),
                             torch.full_like(seg_of, b), seg_of)
    return seg_of


def ragged_prefill_attention(q, chunk_k, chunk_v, seg_of, seg_slots,
                             seg_start, pages_k, pages_v, ptab,
                             q_per_kv: int, continued: bool = False,
                             scales_k=None, scales_v=None):
    """The plain version. q: [N, H, hd]; chunk_k/chunk_v: [N, KV, hd] (this
    pack's keys, not yet scattered); seg_of: [N] int; seg_slots/seg_start:
    [B] int; pages_k/v: [n_pages, pg, KV, hd]; ptab: [S, MP] int32;
    scales_k/v: [n_pages, pg, KV] float32 when the pages are int8.
    ``continued`` False skips the committed-row term (fresh packs).
    Returns [N, H, hd] in q.dtype."""
    dtype = q.dtype
    N, H, hd = q.shape
    KV = chunk_k.shape[1]
    G = q_per_kv
    qg = q.reshape(N, KV, G, hd)
    scale = 1.0 / math.sqrt(hd)
    sc_pack = torch.einsum("nkgd,mkd->kgnm", qg,
                           chunk_k).to(torch.float32) * scale
    idx = torch.arange(N, device=q.device)
    seg_of = seg_of.to(torch.int64)
    mask_pack = (seg_of[:, None] == seg_of[None, :]) & (idx[None, :] <= idx[:, None])
    sc_pack = torch.where(mask_pack[None, None], sc_pack,
                          torch.full_like(sc_pack, _NEG_INF))
    if not continued:
        probs = torch.softmax(sc_pack, dim=-1).to(dtype)
        out = torch.einsum("kgnm,mkd->nkgd", probs, chunk_v)
        return out.reshape(N, H, hd)

    B = seg_slots.shape[0]
    m_c = torch.full((KV, G, N), _NEG_INF, dtype=torch.float32, device=q.device)
    l_c = torch.zeros((KV, G, N), dtype=torch.float32, device=q.device)
    a_c = torch.zeros((KV, G, N, hd), dtype=torch.float32, device=q.device)
    k_all = kvcache.gather_pool_rows(pages_k, ptab, seg_slots)     # [B, C, KV, hd]
    v_all = kvcache.gather_pool_rows(pages_v, ptab, seg_slots)
    quant = scales_k is not None
    if quant:
        sk_all = kvcache.gather_pool_rows(scales_k, ptab, seg_slots)  # [B, C, KV]
        sv_all = kvcache.gather_pool_rows(scales_v, ptab, seg_slots)
    C = k_all.shape[1]
    cols = torch.arange(C, device=q.device)
    for b in range(B):
        sc = torch.einsum("nkgd,ckd->kgnc", qg,
                          k_all[b].to(dtype)).to(torch.float32) * scale
        if quant:
            sc = sc * sk_all[b].T[:, None, None, :]                       # [KV,1,1,C]
        mask = (seg_of == b)[:, None] & (cols[None, :] < seg_start[b])   # [N, C]
        sc = torch.where(mask[None, None], sc, torch.full_like(sc, _NEG_INF))
        m_b = sc.max(dim=-1).values                                       # [KV, G, N]
        # explicit zero for masked columns: an all-masked row has
        # m_b == _NEG_INF and exp(sc - m_b) would be exp(0) == 1 there
        p = torch.where(mask[None, None], torch.exp(sc - m_b[..., None]),
                        torch.zeros_like(sc))
        l_b = p.sum(dim=-1)
        if quant:
            p = p * sv_all[b].T[:, None, None, :]
        a_b = torch.einsum("kgnc,ckd->kgnd", p, v_all[b].to(torch.float32))
        sel = (seg_of == b)[None, None, :]
        m_c = torch.where(sel, m_b, m_c)
        l_c = torch.where(sel, l_b, l_c)
        a_c = torch.where(sel[..., None], a_b, a_c)
    # joint softmax over [cache cols, pack cols] via the accumulated stats
    m_pack = sc_pack.max(dim=-1).values
    m_tot = torch.maximum(m_c, m_pack)
    p_pack = torch.where(mask_pack[None, None],
                         torch.exp(sc_pack - m_tot[..., None]),
                         torch.zeros_like(sc_pack))
    alpha = torch.exp(m_c - m_tot)
    denom = l_c * alpha + p_pack.sum(dim=-1)
    out = (a_c * alpha[..., None]
           + torch.einsum("kgnm,mkd->kgnd", p_pack,
                          chunk_v.to(torch.float32))) / denom[..., None]
    return out.permute(2, 0, 1, 3).reshape(N, H, hd).to(dtype)


def ragged_prefill_plain(q, chunk_k, chunk_v, pages_k, pages_v, ptab,
                         seg_slots, seg_start, seg_off, seg_len, q_per_kv: int,
                         scales_k=None, scales_v=None, continued=None):
    """The plain version behind the kernels' interface (any device);
    ``continued`` None reads it off seg_start."""
    seg_of = seg_of_from_tables(q.shape[0], seg_off, seg_len)
    if continued is None:
        continued = bool((seg_start > 0).any())
    return ragged_prefill_attention(q, chunk_k, chunk_v, seg_of, seg_slots,
                                    seg_start, pages_k, pages_v, ptab,
                                    q_per_kv, continued=continued,
                                    scales_k=scales_k, scales_v=scales_v)


def ragged_prefill_attention_paged(q, chunk_k, chunk_v, pages_k, pages_v,
                                   ptab, seg_slots, seg_start, seg_off,
                                   seg_len, q_per_kv: int, scales_k=None,
                                   scales_v=None, continued=None):
    """K2 / K2-int8 wrapper. q: [N, H, hd]; chunk_k/v: [N, KV, hd];
    pages_k/v: [n_pages, pg, KV, hd] (float like q, or int8 with scales_k/v
    [n_pages, pg, KV] float32); ptab: [S, MP] int32; seg_*: [B] int32.
    ``continued`` False promises every seg_start is 0 (a fresh pack: the
    cache is not read, K2 runs whatever its dtype); None or True reads the
    committed rows seg_start says. Returns [N, H, hd] in q.dtype (rows of
    pad tokens: zeros on the card, unspecified on the CPU — callers ignore
    them)."""
    if q.device.type == "cpu":
        return ragged_prefill_plain(q, chunk_k, chunk_v, pages_k, pages_v,
                                    ptab, seg_slots, seg_start, seg_off,
                                    seg_len, q_per_kv, scales_k=scales_k,
                                    scales_v=scales_v, continued=continued)
    quant = scales_k is not None and continued is not False
    name = "ragged_prefill_attention_int8" if quant else "ragged_prefill_attention"
    stream = cuda_stream(name, q)
    N, H, hd = q.shape
    KV = chunk_k.shape[1]
    B = seg_slots.shape[0]
    S = ptab.shape[0]
    floats = {"q": q, "chunk_k": chunk_k, "chunk_v": chunk_v}
    ints = {"seg_slots": seg_slots, "seg_start": seg_start,
            "seg_off": seg_off, "seg_len": seg_len}
    if continued is not False:
        ints["ptab"] = ptab
        if quant:
            code = check_kernel_args(
                name, floats, ints, pages={"pages_k": pages_k, "pages_v": pages_v},
                scales={"scales_k": scales_k, "scales_v": scales_v})
        else:
            code = check_kernel_args(
                name, {**floats, "pages_k": pages_k, "pages_v": pages_v}, ints)
        n_pages, pg, _kv, _hd = pages_k.shape
        mp = ptab.shape[1]
        if (tuple(pages_v.shape) != tuple(pages_k.shape) or pages_k.shape[2] != KV
                or pages_k.shape[3] != hd or (quant and (
                    tuple(scales_k.shape) != (n_pages, pg, KV)
                    or tuple(scales_v.shape) != (n_pages, pg, KV)))):
            raise ValueError(f"{name}: pages {tuple(pages_k.shape)} do not "
                             f"match q{tuple(q.shape)} k{tuple(chunk_k.shape)}")
    else:   # fresh: K2 never reads the cache (mp = 0)
        code = check_kernel_args(name, floats, ints)
        n_pages = pg = mp = 0
    if (H != KV * q_per_kv or tuple(chunk_k.shape) != (N, KV, hd)
            or tuple(chunk_v.shape) != (N, KV, hd)
            or any(tuple(t.shape) != (B,) for t in (seg_start, seg_off, seg_len))):
        raise ValueError(f"{name}: inconsistent shapes q{tuple(q.shape)} "
                         f"k{tuple(chunk_k.shape)} B={B}")
    if not kernel_supports(KV, q_per_kv, hd):
        raise ValueError(f"{name}: head shapes KV={KV} G={q_per_kv} hd={hd} "
                         f"not supported by the kernel")
    out = torch.empty_like(q)
    if quant:
        err = build.launcher("ragged_prefill", "ragged_prefill_attention_quant_launch")(
            q.data_ptr(), chunk_k.data_ptr(), chunk_v.data_ptr(),
            pages_k.data_ptr(), scales_k.data_ptr(), pages_v.data_ptr(),
            scales_v.data_ptr(), ptab.data_ptr(), seg_slots.data_ptr(),
            seg_start.data_ptr(), seg_off.data_ptr(), seg_len.data_ptr(),
            out.data_ptr(), N, KV, q_per_kv, hd, n_pages, pg, mp, S, B, code,
            stream)
    else:
        fresh = continued is False
        err = build.launcher("ragged_prefill", "ragged_prefill_attention_launch")(
            q.data_ptr(), chunk_k.data_ptr(), chunk_v.data_ptr(),
            None if fresh else pages_k.data_ptr(),
            None if fresh else pages_v.data_ptr(),
            None if fresh else ptab.data_ptr(), seg_slots.data_ptr(),
            seg_start.data_ptr(), seg_off.data_ptr(), seg_len.data_ptr(),
            out.data_ptr(), N, KV, q_per_kv, hd, n_pages, pg, mp, S, B, code,
            stream)
    build.check(err, name)
    LAUNCHES[name] += 1
    return out
