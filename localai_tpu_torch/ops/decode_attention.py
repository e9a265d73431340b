"""Decode attention over the CONTIGUOUS KV cache: the K4 and K5 wrappers
(counterparts of localai_tpu/ops/pallas/decode_attention.py::
decode_attention_append_pallas and ::decode_attention_append_pallas_full).

  * ``decode_attention_append_contig`` (K4): a single-layer [S, C, KV, hd]
    cache — what the model passes on the contiguous layout (``pool`` of
    the layer view: a free leading-dimension slice).
  * ``decode_attention_append_full`` (K5): the stacked [L, S', C, KV, hd]
    cache and the layer index as an int32 tensor ON THE DEVICE, read by
    the kernel (the TPU kernel's scalar-prefetch argument), so choosing
    the layer costs no host sync. S' >= S: the slots past S (the port's
    scratch slot) are never read. Nothing on the serving path calls it,
    as nothing in the JAX package calls its TPU counterpart.

On CUDA tensors they launch ops/kernels/csrc/contig_decode.cu (K1's
split-K walk and combine, ops/paged_attention.py::SPLIT_ROWS), or raise;
on CPU tensors they run the plain version, ops/attention.py::
decode_attention_append over the layer's rows.
"""

from __future__ import annotations

import torch

from localai_tpu_torch.ops.attention import decode_attention_append
from localai_tpu_torch.ops.kernels import LAUNCHES, build
from localai_tpu_torch.ops.paged_attention import (
    SPLIT_ROWS, check_decode_shapes, check_kernel_args, cuda_stream,
    decode_workspace)


def contig_decode_plain(q, new_k, new_v, cache_k, cache_v, lengths,
                        q_per_kv: int):
    """The plain PyTorch version of K4 (any device)."""
    return decode_attention_append(q, new_k, new_v, cache_k, cache_v,
                                   lengths, q_per_kv)


def full_decode_plain(q, new_k, new_v, cache_k, cache_v, lengths, layer_idx,
                      q_per_kv: int):
    """The plain PyTorch version of K5 (any device): K4's at layer
    ``layer_idx`` (read back to the host)."""
    li = int(torch.as_tensor(layer_idx).reshape(-1)[0])
    S = q.shape[0]
    return decode_attention_append(q, new_k, new_v, cache_k[li, :S],
                                   cache_v[li, :S], lengths, q_per_kv)


def _check_cache(name, cache_k, cache_v, lengths, S, KV, hd, s_min):
    if (tuple(cache_v.shape) != tuple(cache_k.shape) or cache_k.shape[-2] != KV
            or cache_k.shape[-1] != hd or cache_k.shape[-4] < s_min
            or tuple(lengths.shape) != (S,)):
        raise ValueError(f"{name}: inconsistent shapes cache"
                         f"{tuple(cache_k.shape)} lengths{tuple(lengths.shape)}"
                         f" for S={S} KV={KV} hd={hd}")


def decode_attention_append_contig(q, new_k, new_v, cache_k, cache_v, lengths,
                                   q_per_kv: int):
    """K4. q: [S, H, hd]; new_k/new_v: [S, KV, hd]; cache_k/v: [S, C, KV, hd]
    holding rows [0, lengths[s]); lengths: [S] int32. Returns [S, H, hd] in
    q.dtype."""
    if q.device.type == "cpu":
        return contig_decode_plain(q, new_k, new_v, cache_k, cache_v, lengths,
                                   q_per_kv)
    name = "decode_attention_append_contig"
    stream = cuda_stream(name, q)
    S, _H, hd = q.shape
    code = check_kernel_args(
        name, {"q": q, "new_k": new_k, "new_v": new_v, "cache_k": cache_k,
               "cache_v": cache_v}, {"lengths": lengths})
    check_decode_shapes(name, q, new_k, new_v, cache_k.shape[-1], q_per_kv)
    KV = new_k.shape[1]
    if cache_k.dim() != 4 or cache_k.shape[0] != S:
        raise ValueError(f"{name}: cache {tuple(cache_k.shape)} is not "
                         f"[S={S}, C, KV, hd]")
    _check_cache(name, cache_k, cache_v, lengths, S, KV, hd, S)
    C = cache_k.shape[1]
    out = torch.empty_like(q)
    ws = decode_workspace(q, KV, q_per_kv, C)
    err = build.launcher("contig_decode", "contig_decode_attention_launch")(
        q.data_ptr(), new_k.data_ptr(), new_v.data_ptr(), cache_k.data_ptr(),
        cache_v.data_ptr(), lengths.data_ptr(), out.data_ptr(), ws.data_ptr(),
        S, KV, q_per_kv, hd, C, SPLIT_ROWS, code, stream)
    build.check(err, name)
    LAUNCHES[name] += 1
    return out


def decode_attention_append_full(q, new_k, new_v, cache_k, cache_v, lengths,
                                 layer_idx, q_per_kv: int):
    """K5. cache_k/v: [L, S', C, KV, hd] with S' >= S; layer_idx: int32
    tensor of one element on the cache's device (clamped to [0, L) by the
    kernel); the rest as K4. Returns [S, H, hd] in q.dtype."""
    if q.device.type == "cpu":
        return full_decode_plain(q, new_k, new_v, cache_k, cache_v, lengths,
                                 layer_idx, q_per_kv)
    name = "decode_attention_append_full"
    stream = cuda_stream(name, q)
    S, _H, hd = q.shape
    code = check_kernel_args(
        name, {"q": q, "new_k": new_k, "new_v": new_v, "cache_k": cache_k,
               "cache_v": cache_v}, {"lengths": lengths, "layer_idx": layer_idx})
    check_decode_shapes(name, q, new_k, new_v, cache_k.shape[-1], q_per_kv)
    KV = new_k.shape[1]
    if cache_k.dim() != 5 or layer_idx.numel() != 1:
        raise ValueError(f"{name}: cache {tuple(cache_k.shape)} is not "
                         f"[L, S', C, KV, hd] or layer_idx has "
                         f"{layer_idx.numel()} elements")
    _check_cache(name, cache_k, cache_v, lengths, S, KV, hd, S)
    L, s_alloc, C = cache_k.shape[:3]
    out = torch.empty_like(q)
    ws = decode_workspace(q, KV, q_per_kv, C)
    err = build.launcher("contig_decode", "contig_decode_attention_full_launch")(
        q.data_ptr(), new_k.data_ptr(), new_v.data_ptr(), cache_k.data_ptr(),
        cache_v.data_ptr(), lengths.data_ptr(), layer_idx.data_ptr(),
        out.data_ptr(), ws.data_ptr(), S, KV, q_per_kv, hd, C, s_alloc, L,
        SPLIT_ROWS, code, stream)
    build.check(err, name)
    LAUNCHES[name] += 1
    return out
