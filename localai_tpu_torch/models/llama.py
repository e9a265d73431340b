"""Llama-family decoder in PyTorch (counterpart of
localai_tpu/models/llama.py, paged-cache serving path).

Parameters are a plain dict in the JAX package's layout: layers STACKED
on a leading axis ({"layers": {"wq": [L, D, H*hd], ...}}) and every
projection stored [in, out], so ``x @ w`` is the JAX einsum and the
JAX parameter pytree maps over leaf for leaf (engine/weights.py::
from_jax_params). The Python loop over layers replaces ``lax.scan``.
Large projections are ``torch.matmul``, as XLA did them; logits are
float32. Attention goes through the kernel wrappers, by cache layout and
dtype (the routing of the JAX package's ``_decode_attend_write``):

  * ragged_prefill -> ops/ragged_prefill.py::ragged_prefill_attention_paged:
    K2 for fresh packs (any cache) and continued packs over float pages;
    K2-int8 for continued packs over int8 pages; the contiguous layout is
    K2 over pages of C rows with the identity table.
  * decode_step    -> paged float: ops/paged_attention.py::
    paged_decode_attention (K1); paged int8: ::paged_decode_attention_quant
    (K3); contiguous: ops/decode_attention.py::
    decode_attention_append_contig (K4) on the layer's rows.

All read the committed cache rows BEFORE this step's KV scatter, the
same no-read-after-write rule as the JAX package; int8 caches quantize
the new rows as they are scattered (ops/kvcache.py).

Weights may be weight-only int8 / int4 {q, s} leaves (ops/quant.py,
``quantize_params``): every projection goes through
ops/quant.py::quant_matmul (W8 / W4 on the card), an int8 embedding
table is gathered first and scaled after (``_embed_rows``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from localai_tpu_torch.ops import kvcache
from localai_tpu_torch.ops.decode_attention import decode_attention_append_contig
from localai_tpu_torch.ops.norms import rms_norm
from localai_tpu_torch.ops.paged_attention import (
    paged_decode_attention, paged_decode_attention_quant)
from localai_tpu_torch.ops.quant import (
    mat, quant_matmul, quantize_weight, quantize_weight_int4)
from localai_tpu_torch.ops.ragged_prefill import ragged_prefill_attention_paged
from localai_tpu_torch.ops.rope import apply_rope, rope_frequencies


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    head_dim: Optional[int] = None   # defaults to hidden_size // num_heads
    rope_theta: float = 10000.0
    rope_scaling_type: str = "none"  # none | linear | yarn | llama3
    rope_scaling_factor: float = 1.0
    rope_low_freq_factor: float = 1.0
    rope_high_freq_factor: float = 4.0
    rope_original_max_position: int = 8192
    rms_norm_eps: float = 1e-5
    max_position_embeddings: int = 4096
    tie_word_embeddings: bool = False
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads

    @staticmethod
    def from_hf_config(cfg: dict, dtype=torch.bfloat16) -> "LlamaConfig":
        """Build from a HuggingFace ``config.json`` dict (llama/mistral)."""
        if cfg.get("attention_bias"):
            raise NotImplementedError(
                "attention_bias (qwen2-style) is not ported yet")
        rope_scaling = cfg.get("rope_scaling") or {}
        rs_type = rope_scaling.get("rope_type", rope_scaling.get("type", "none")) or "none"
        return LlamaConfig(
            vocab_size=cfg["vocab_size"],
            hidden_size=cfg["hidden_size"],
            intermediate_size=cfg["intermediate_size"],
            num_layers=cfg["num_hidden_layers"],
            num_heads=cfg["num_attention_heads"],
            num_kv_heads=cfg.get("num_key_value_heads", cfg["num_attention_heads"]),
            head_dim=cfg.get("head_dim"),
            rope_theta=cfg.get("rope_theta", 10000.0),
            rope_scaling_type=rs_type,
            rope_scaling_factor=rope_scaling.get("factor", 1.0),
            rope_low_freq_factor=rope_scaling.get("low_freq_factor", 1.0),
            rope_high_freq_factor=rope_scaling.get("high_freq_factor", 4.0),
            rope_original_max_position=rope_scaling.get(
                "original_max_position_embeddings",
                cfg.get("max_position_embeddings", 8192)),
            rms_norm_eps=cfg.get("rms_norm_eps", 1e-5),
            max_position_embeddings=cfg.get("max_position_embeddings", 4096),
            tie_word_embeddings=cfg.get("tie_word_embeddings", False),
            dtype=dtype,
        )


# the matmul weights quantize_params quantizes (norms stay as they are)
QUANT_NAMES = frozenset({"embed", "lm_head", "wq", "wk", "wv", "wo",
                         "w_gate", "w_up", "w_down"})


def _embed_rows(embed, tokens, dtype):
    """Token-embedding lookup; an int8 table is gathered first and scaled
    after (its scale [1, D] lies along D)."""
    idx = tokens.to(torch.int64)
    if isinstance(embed, dict):
        return (embed["q"][idx].to(torch.float32) * embed["s"]).to(dtype)
    return embed[idx].to(dtype)


def quantize_params(params: dict, bits: int = 8, group: int = 128) -> dict:
    """Weight-only quantization of every matmul weight (norms stay as they
    are), as the JAX package's quantize_params: bits=8 per-out-channel
    int8 everywhere; bits=4 group-``group`` int4 for the LAYER matmuls
    while embed / lm_head stay int8 (the embedding gather dequantizes
    row-wise, and the unembed is the quality-critical product)."""
    def q(leaf, layer: bool):
        if bits == 4 and layer:
            return quantize_weight_int4(leaf, group=group)
        return quantize_weight(leaf)

    out = {}
    for name, leaf in params.items():
        if name == "layers":
            out[name] = {k: (q(v, True) if k in QUANT_NAMES else v)
                         for k, v in leaf.items()}
        else:
            out[name] = q(leaf, False) if name in QUANT_NAMES else leaf
    return out


def dequantize_params(params: dict, dtype=torch.bfloat16) -> dict:
    """Inverse of quantize_params: {q, s} leaves back to dense ``dtype``."""
    def dq(leaf):
        if isinstance(leaf, dict) and set(leaf) == {"q", "s"}:
            return mat(leaf, dtype)
        return leaf

    out = {}
    for name, leaf in params.items():
        if name == "layers":
            out[name] = {k: dq(v) for k, v in leaf.items()}
        else:
            out[name] = dq(leaf)
    return out


def _project_qkv(x, lw, cfg: LlamaConfig):
    """x: [T, D] -> q [T, H, hd], k/v [T, KV, hd]."""
    T = x.shape[0]
    hd = cfg.head_dim_
    q = quant_matmul(x, lw["wq"]).reshape(T, cfg.num_heads, hd)
    k = quant_matmul(x, lw["wk"]).reshape(T, cfg.num_kv_heads, hd)
    v = quant_matmul(x, lw["wv"]).reshape(T, cfg.num_kv_heads, hd)
    return q, k, v


def _mlp(x, lw):
    gate = quant_matmul(x, lw["w_gate"])
    up = quant_matmul(x, lw["w_up"])
    return quant_matmul(torch.nn.functional.silu(gate) * up, lw["w_down"])


def _unembed(x, params, cfg: LlamaConfig):
    """Logits in float32. A tied table [V, D] is used transposed: its int8
    scale lies along D, the contraction axis, so it is never applied
    along V."""
    if cfg.tie_word_embeddings:
        return quant_matmul(x, params["embed"], transposed=True).to(torch.float32)
    return quant_matmul(x, params["lm_head"]).to(torch.float32)


def _layer(params, li: int) -> dict:
    """Layer li's weights (views into the stacked leaves, {q, s} ones
    included)."""
    return {k: ({"q": v["q"][li], "s": v["s"][li]} if isinstance(v, dict)
                else v[li]) for k, v in params["layers"].items()}


def _block(x, attn_fn, lw, cfg: LlamaConfig, sin, cos):
    """One transformer block on tokens x [T, D]; ``attn_fn(q, k, v)``
    attends and writes this step's K/V rows."""
    h = rms_norm(x, lw["attn_norm"], cfg.rms_norm_eps)
    q, k, v = _project_qkv(h, lw, cfg)
    q = apply_rope(q[None], sin, cos)[0]
    k = apply_rope(k[None], sin, cos)[0]
    attn = attn_fn(q, k, v)
    x = x + quant_matmul(attn.reshape(x.shape[0], -1), lw["wo"])
    h = rms_norm(x, lw["mlp_norm"], cfg.rms_norm_eps)
    return x + _mlp(h, lw)


def ragged_prefill(params: dict, cfg: LlamaConfig,
                   tokens: torch.Tensor,      # [N] int packed prompt tokens
                   positions: torch.Tensor,   # [N] int cache position (pads: C)
                   seg_slots: torch.Tensor,   # [B] int32 slot per segment
                   seg_start: torch.Tensor,   # [B] int32 committed rows
                   seg_off: torch.Tensor,     # [B] int32 pack offset
                   seg_len: torch.Tensor,     # [B] int32 tokens (pads: 0)
                   seg_of: torch.Tensor,      # [N] int segment per token (pads: B)
                   cache_k: dict, cache_v: dict,
                   continued: Optional[bool] = None,
                   all_logits: bool = False, unembed: bool = True):
    """RAGGED PACKED PREFILL: the prompt tails of up to B slots as one
    [N]-token batch. Writes every token's K/V row through its own slot's
    page table (in place) and returns logits [B, V] (float32) at each
    segment's last packed token; pad segments give rows to ignore.
    ``continued`` False promises no segment has committed rows (the JAX
    package's static flag; the kernels then skip the cache), None reads
    it off seg_start. ``all_logits`` (the JAX ``return_all_logits``, for
    the speculative verify pass) returns logits [N, V] at every packed
    token instead; pad tokens' rows are to be ignored. ``unembed`` False
    writes the KV rows and returns None (a draft model's mirror of a
    pack, whose logits nobody reads: XLA drops them from the JAX
    package's jitted mirror)."""
    B = seg_slots.shape[0]
    sin, cos = rope_frequencies(cfg, positions[None])
    x = _embed_rows(params["embed"], tokens, cfg.dtype)              # [N, D]
    # per-token slot for the scatter (pads ride a clamped lookup; their
    # position sentinel drops the write)
    slot_of = seg_slots.to(torch.int64)[seg_of.to(torch.int64).clamp(0, B - 1)]
    target = kvcache.scatter_index(kvcache.layer(cache_k, 0), slot_of, positions)
    for li in range(cfg.num_layers):
        lck, lcv = kvcache.layer(cache_k, li), kvcache.layer(cache_v, li)

        def attend(q, k, v, lck=lck, lcv=lcv):
            quant = kvcache.is_quant(lck)
            out = ragged_prefill_attention_paged(
                q, k, v, kvcache.pool(lck), kvcache.pool(lcv),
                kvcache.table(lck), seg_slots, seg_start, seg_off, seg_len,
                cfg.q_per_kv,
                scales_k=kvcache.scales_pool(lck) if quant else None,
                scales_v=kvcache.scales_pool(lcv) if quant else None,
                continued=continued)
            kvcache.write_rows(lck, target, k)
            kvcache.write_rows(lcv, target, v)
            return out

        x = _block(x, attend, _layer(params, li), cfg, sin, cos)
    if not unembed:
        return None
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    if all_logits:
        return _unembed(x, params, cfg)
    last = (seg_off.to(torch.int64) + seg_len.to(torch.int64) - 1).clamp(min=0)
    return _unembed(x[last], params, cfg)


def decode_step(params: dict, cfg: LlamaConfig,
                tokens: torch.Tensor,     # [S] int one token per slot
                lengths: torch.Tensor,    # [S] int32 rows committed per slot
                cache_k: dict, cache_v: dict,
                active: Optional[torch.Tensor] = None):  # [S] bool
    """One decode step for all slots: the token of slot s is written at
    row lengths[s] and attends rows [0, lengths[s]]. Inactive slots write
    nothing (their write position is the sentinel C) and attend nothing
    but themselves. Returns logits [S, V] float32."""
    S = tokens.shape[0]
    C = kvcache.shape(cache_k)[2]
    lengths = lengths.to(torch.int32)
    if active is None:
        write_pos, attn_len = lengths, lengths
    else:
        write_pos = torch.where(active, lengths, torch.full_like(lengths, C))
        attn_len = torch.where(active, lengths, torch.zeros_like(lengths))
    sin, cos = rope_frequencies(cfg, lengths[:, None])     # [S, 1, hd]
    # rope expects [B, T, ...]: decode tokens are S sequences of length 1;
    # _block works on [T, D] rows, so fold the [S, 1] grid to [1, S]
    sin, cos = sin.reshape(1, S, -1), cos.reshape(1, S, -1)
    x = _embed_rows(params["embed"], tokens, cfg.dtype)              # [S, D]
    target = kvcache.scatter_index(kvcache.layer(cache_k, 0),
                                   torch.arange(S, device=tokens.device), write_pos)
    for li in range(cfg.num_layers):
        lck, lcv = kvcache.layer(cache_k, li), kvcache.layer(cache_v, li)

        def attend(q, k, v, lck=lck, lcv=lcv):
            out = _decode_attend(q, k, v, lck, lcv, attn_len, cfg)
            kvcache.write_rows(lck, target, k)
            kvcache.write_rows(lcv, target, v)
            return out

        x = _block(x, attend, _layer(params, li), cfg, sin, cos)
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    return _unembed(x, params, cfg)


def _decode_attend(q, k, v, lck: dict, lcv: dict, lengths, cfg: LlamaConfig):
    """Decode attention of one layer, routed by layout and dtype: K1 (paged
    float), K3 (paged int8), K4 (contiguous)."""
    if not kvcache.is_paged(lck):
        return decode_attention_append_contig(
            q, k, v, kvcache.pool(lck), kvcache.pool(lcv), lengths, cfg.q_per_kv)
    if kvcache.is_quant(lck):
        return paged_decode_attention_quant(
            q, k, v, kvcache.pool(lck), kvcache.scales_pool(lck),
            kvcache.pool(lcv), kvcache.scales_pool(lcv), lck["ptab"], lengths,
            cfg.q_per_kv)
    return paged_decode_attention(
        q, k, v, kvcache.pool(lck), kvcache.pool(lcv), lck["ptab"], lengths,
        cfg.q_per_kv)


def init_cache(cfg: LlamaConfig, num_slots: int, max_len: int, page_size: int,
               num_pages: int = 0, dtype=None, device="cuda"):
    """KV caches (K, V) for the logical shape [L, S, C, KV, hd]:
    ``page_size > 0`` the paged layout (num_pages physical pages, default
    S * C / page_size), ``page_size == 0`` the contiguous one (as the JAX
    package's init_cache). ``dtype=torch.int8`` selects int8 rows with
    scales (paged only: contiguous int8 raises NotImplementedError)."""
    shape = (cfg.num_layers, num_slots, max_len, cfg.num_kv_heads, cfg.head_dim_)
    dtype = dtype or cfg.dtype
    if page_size:
        return (kvcache.init_paged(shape, dtype, page_size, num_pages, device),
                kvcache.init_paged(shape, dtype, page_size, num_pages, device))
    return kvcache.init(shape, dtype, device), kvcache.init(shape, dtype, device)
