"""Decode attention, plain PyTorch (counterpart of
localai_tpu/ops/attention.py::decode_attention_append).

This is the plain version of the decode kernels: K1 and K3 over dense
gathered pages (ops/paged_attention.py), K4 and K5 over the contiguous
cache (ops/decode_attention.py). The tests hold it against the JAX
function, and chip_smoke.py holds the kernels against it on the card.
The serving path on a card never calls it.

Same rules as the JAX op: attention reads the cache rows written BEFORE
this step plus the current token's own key/value, and GQA contracts
queries grouped as [.., KV, G, hd] against un-repeated keys. Int8 rows
come as {"q": int8 rows, "s": float32 scales [S, C, KV]}; the scales are
folded outside the contraction (the key scale into the scores, the value
scale into the probabilities, in the working dtype as the JAX op does),
so no dequantized cache is formed.
"""

from __future__ import annotations

import math

import torch

_NEG_INF = -1e30


def _split_cache(rows):
    """(rows, scales or None) of a plain or {"q","s"} row set."""
    if isinstance(rows, dict):
        return rows["q"], rows["s"]
    return rows, None


def decode_attention_append(q, new_k, new_v, cache_k, cache_v, lengths,
                            q_per_kv: int):
    """q, new_k, new_v: [S, {H|KV|KV}, hd]; cache_k/v: [S, C, KV, hd] dense
    rows (plain float or int8 {"q","s"}) holding [0, lengths[s]); row
    lengths[s] is this step's token, read from new_k/new_v instead.
    Returns [S, H, hd] in q.dtype."""
    dtype = q.dtype
    S, H, hd = q.shape
    cache_k, sk = _split_cache(cache_k)
    cache_v, sv = _split_cache(cache_v)
    C, KV = cache_k.shape[1], cache_k.shape[2]
    qg = q.reshape(S, KV, q_per_kv, hd)
    scale = 1.0 / math.sqrt(hd)
    scores = torch.einsum("skgd,sckd->skgc", qg,
                          cache_k.to(dtype)).to(torch.float32) * scale
    if sk is not None:
        scores = scores * sk.permute(0, 2, 1)[:, :, None, :]        # [S,KV,1,C]
    mask = (torch.arange(C, device=q.device)[None, :]
            < lengths.to(torch.int64)[:, None])                     # [S, C]
    scores = torch.where(mask[:, None, None, :], scores,
                         torch.full_like(scores, _NEG_INF))
    sc_self = torch.einsum("skgd,skd->skg", qg, new_k).to(torch.float32) * scale
    scores = torch.cat([scores, sc_self[..., None]], dim=-1)        # [S,KV,G,C+1]
    probs = torch.softmax(scores, dim=-1).to(dtype)
    p_cache = probs[..., :C]
    if sv is not None:
        p_cache = p_cache * sv.permute(0, 2, 1)[:, :, None, :].to(dtype)
    out = (torch.einsum("skgc,sckd->skgd", p_cache, cache_v.to(dtype))
           + probs[..., C][..., None] * new_v[:, :, None, :])
    return out.reshape(S, H, hd)
