"""Paged decode attention: the K1 and K3 wrappers (counterparts of
localai_tpu/ops/pallas/paged_attention.py::paged_decode_attention_append
and ::paged_decode_attention_append_quant).

On CUDA tensors they launch the hand-written kernels in
ops/kernels/csrc/paged_decode.cu, or raise: one launcher call enqueues
the split-K kernel over SPLIT_ROWS-row splits and its combine, into a
workspace from ``decode_workspace``. On CPU tensors they run the
plain version (ops/attention.py::decode_attention_append over the
dense-gathered pages, and for K3 their scales) — the only reason they
ever do is that they were handed CPU tensors.
"""

from __future__ import annotations

import torch

from localai_tpu_torch.ops import kvcache
from localai_tpu_torch.ops.attention import decode_attention_append
from localai_tpu_torch.ops.kernels import LAUNCHES, build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# Committed rows per split-K block of the decode kernels K1, K3, K4 and K5
# (csrc/decode_attention.cuh): a multiple of their 32-row tile and of the
# 64-row serving page. The launchers take it as an argument and cut a
# slot's row capacity into n_splits() pieces.
SPLIT_ROWS = 64


def n_splits(rows_cap: int, split_rows: int = SPLIT_ROWS) -> int:
    """Splits per (slot, kv head) of a decode call over ``rows_cap`` rows
    (max_pages * page_size, or C): the launchers cut their grid the same
    way, from these shapes alone."""
    return -(-rows_cap // split_rows)


def decode_workspace(q, kv_heads: int, q_per_kv: int, rows_cap: int,
                     split_rows: int = SPLIT_ROWS):
    """The f32 workspace a decode launch's split kernel fills and its
    combine kernel reads: S * KV * n_split * G * (hd + 2) floats from the
    caching allocator (no sync, safe under graph capture). The combine
    reads only what the same call wrote, so it needs no clearing."""
    S, _H, hd = q.shape
    n = S * kv_heads * n_splits(rows_cap, split_rows) * q_per_kv * (hd + 2)
    return torch.empty(n, dtype=torch.float32, device=q.device)


def check_kernel_args(name: str, floats: dict, ints: dict,
                      pages: dict = None, scales: dict = None):
    """Device / dtype / contiguity / alignment checks shared by the kernel
    wrappers: every tensor on one CUDA device, contiguous; ``floats`` share
    one supported dtype; ``ints`` are int32; ``pages`` (int8 caches) are
    int8 and ``scales`` float32. The kernels load floats and pages 16 bytes
    at a time, so those must be 16-byte aligned. Returns the float dtype's
    code."""
    pages, scales = pages or {}, scales or {}
    dev = next(iter(floats.values())).device
    dtype = next(iter(floats.values())).dtype
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: dtype {dtype} not supported "
                        f"(float32 or bfloat16)")
    for k, t in {**floats, **ints, **pages, **scales}.items():
        if t.device != dev:
            raise ValueError(f"{name}: {k} on {t.device}, expected {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {k} must be contiguous")
    for group, want in ((floats, dtype), (ints, torch.int32),
                        (pages, torch.int8), (scales, torch.float32)):
        for k, t in group.items():
            if t.dtype != want:
                raise TypeError(f"{name}: {k} is {t.dtype}, expected {want}")
    for k, t in {**floats, **pages}.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {k} must be 16-byte aligned "
                             f"(the kernel loads 16 bytes at a time)")
    return _DTYPE_CODE[dtype]


def check_decode_shapes(name: str, q, new_k, new_v, hd_cache: int,
                        q_per_kv: int):
    """Shape rules the decode kernels (K1, K3, K4, K5) share."""
    S, H, hd = q.shape
    KV = new_k.shape[1] if new_k.dim() == 3 else -1
    if (H != KV * q_per_kv or tuple(new_k.shape) != (S, KV, hd)
            or tuple(new_v.shape) != (S, KV, hd) or hd_cache != hd):
        raise ValueError(f"{name}: inconsistent shapes q{tuple(q.shape)} "
                         f"k{tuple(new_k.shape)} v{tuple(new_v.shape)} "
                         f"cache hd {hd_cache}")
    if hd % 32 or hd > 256 or q_per_kv > 8:
        raise ValueError(f"{name}: head_dim {hd} / group {q_per_kv} not "
                         f"supported (hd % 32 == 0, hd <= 256, G <= 8)")


def _check_pool(name, pages_k, pages_v, ptab, lengths, S, KV):
    n_pages, pg = pages_k.shape[0], pages_k.shape[1]
    if (pages_k.dim() != 4 or tuple(pages_v.shape) != tuple(pages_k.shape)
            or pages_k.shape[2] != KV or ptab.dim() != 2 or ptab.shape[0] != S
            or tuple(lengths.shape) != (S,)):
        raise ValueError(f"{name}: inconsistent shapes pages"
                         f"{tuple(pages_k.shape)} ptab{tuple(ptab.shape)} "
                         f"lengths{tuple(lengths.shape)}")
    return n_pages, pg, ptab.shape[1]


def cuda_stream(name, q):
    """The current CUDA stream of q's device (raises for any other
    non-CPU device)."""
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    return torch.cuda.current_stream(q.device).cuda_stream


def paged_decode_plain(q, new_k, new_v, pages_k, pages_v, ptab, lengths,
                       q_per_kv: int):
    """The plain PyTorch version of K1 (any device)."""
    slots = torch.arange(ptab.shape[0], device=ptab.device)
    return decode_attention_append(
        q, new_k, new_v, kvcache.gather_pool_rows(pages_k, ptab, slots),
        kvcache.gather_pool_rows(pages_v, ptab, slots), lengths, q_per_kv)


def paged_decode_attention(q, new_k, new_v, pages_k, pages_v, ptab, lengths,
                           q_per_kv: int):
    """K1. q: [S, H, hd]; new_k/new_v: [S, KV, hd]; pages_k/v: [n_pages,
    page_size, KV, hd] single-layer pool; ptab: [S, max_pages] int32
    (sentinel n_pages = unallocated); lengths: [S] int32.
    Returns [S, H, hd] in q.dtype."""
    if q.device.type == "cpu":
        return paged_decode_plain(q, new_k, new_v, pages_k, pages_v, ptab,
                                  lengths, q_per_kv)
    name = "paged_decode_attention"
    stream = cuda_stream(name, q)
    S = q.shape[0]
    code = check_kernel_args(
        name, {"q": q, "new_k": new_k, "new_v": new_v, "pages_k": pages_k,
               "pages_v": pages_v},
        {"ptab": ptab, "lengths": lengths})
    check_decode_shapes(name, q, new_k, new_v, pages_k.shape[-1], q_per_kv)
    KV = new_k.shape[1]
    n_pages, pg, mp = _check_pool(name, pages_k, pages_v, ptab, lengths, S, KV)
    out = torch.empty_like(q)
    ws = decode_workspace(q, KV, q_per_kv, mp * pg)
    err = build.launcher("paged_decode", "paged_decode_attention_launch")(
        q.data_ptr(), new_k.data_ptr(), new_v.data_ptr(), pages_k.data_ptr(),
        pages_v.data_ptr(), ptab.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), ws.data_ptr(), S, KV, q_per_kv, q.shape[2], n_pages,
        pg, mp, SPLIT_ROWS, code, stream)
    build.check(err, name)
    LAUNCHES[name] += 1
    return out


def paged_decode_quant_plain(q, new_k, new_v, pages_k, scales_k, pages_v,
                             scales_v, ptab, lengths, q_per_kv: int):
    """The plain PyTorch version of K3 (any device): decode_attention_append
    over the gathered int8 rows and their scales."""
    slots = torch.arange(ptab.shape[0], device=ptab.device)

    def rows(pages, scales):
        return {"q": kvcache.gather_pool_rows(pages, ptab, slots),
                "s": kvcache.gather_pool_rows(scales, ptab, slots)}

    return decode_attention_append(q, new_k, new_v, rows(pages_k, scales_k),
                                   rows(pages_v, scales_v), lengths, q_per_kv)


def paged_decode_attention_quant(q, new_k, new_v, pages_k, scales_k, pages_v,
                                 scales_v, ptab, lengths, q_per_kv: int):
    """K3: K1 over int8 pages. pages_k/v: int8 [n_pages, page_size, KV, hd];
    scales_k/v: float32 [n_pages, page_size, KV]; q / new_k / new_v stay
    float (float32 or bfloat16); the rest as K1. Returns [S, H, hd] in
    q.dtype."""
    if q.device.type == "cpu":
        return paged_decode_quant_plain(q, new_k, new_v, pages_k, scales_k,
                                        pages_v, scales_v, ptab, lengths,
                                        q_per_kv)
    name = "paged_decode_attention_quant"
    stream = cuda_stream(name, q)
    S = q.shape[0]
    code = check_kernel_args(
        name, {"q": q, "new_k": new_k, "new_v": new_v},
        {"ptab": ptab, "lengths": lengths},
        pages={"pages_k": pages_k, "pages_v": pages_v},
        scales={"scales_k": scales_k, "scales_v": scales_v})
    check_decode_shapes(name, q, new_k, new_v, pages_k.shape[-1], q_per_kv)
    KV = new_k.shape[1]
    n_pages, pg, mp = _check_pool(name, pages_k, pages_v, ptab, lengths, S, KV)
    if (tuple(scales_k.shape) != tuple(pages_k.shape[:3])
            or tuple(scales_v.shape) != tuple(pages_k.shape[:3])):
        raise ValueError(f"{name}: scales {tuple(scales_k.shape)} do not "
                         f"match pages {tuple(pages_k.shape)}")
    out = torch.empty_like(q)
    ws = decode_workspace(q, KV, q_per_kv, mp * pg)
    err = build.launcher("paged_decode", "paged_decode_attention_quant_launch")(
        q.data_ptr(), new_k.data_ptr(), new_v.data_ptr(), pages_k.data_ptr(),
        scales_k.data_ptr(), pages_v.data_ptr(), scales_v.data_ptr(),
        ptab.data_ptr(), lengths.data_ptr(), out.data_ptr(), ws.data_ptr(), S,
        KV, q_per_kv, q.shape[2], n_pages, pg, mp, SPLIT_ROWS, code, stream)
    build.check(err, name)
    LAUNCHES[name] += 1
    return out
