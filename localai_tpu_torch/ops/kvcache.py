"""KV cache layouts (counterpart of localai_tpu/ops/kvcache.py): the
paged page pool in float or int8, and the contiguous layout.

PAGED, per K and per V:

    {"pages":  [L, n_pages + 1, page_size, KV, hd]   float or int8,
     "scales": [L, n_pages + 1, page_size, KV]       float32, int8 only,
     "ptab":   int32 [S, max_pages]}

Logical row c of slot s lives at page ``ptab[s, c // page_size]``, row
``c % page_size``. Unallocated table entries hold the sentinel
``n_pages``, exactly as in the JAX package.

INT8 (``kv_cache_dtype: int8``): symmetric int8 with one float32 scale
per (row, kv head), quantized over head_dim (``quantize``, the JAX
package's rounding: ``torch.round`` is half-to-even like ``jnp.round``).
Rows are quantized as they are scattered; readers never form a
dequantized row: attention folds the key scale into the scores and the
value scale into the probabilities (ops/attention.py).

CONTIGUOUS (``kv_layout: contiguous``), per K and per V:

    {"rows": [L, S + 1, C, KV, hd], "itab": int32 [S, 1] = arange(S)}

Slot s's logical rows are ``rows[:, s]``. This is the paged layout with
one page of C rows per slot and the identity table ``itab``, so the
scatter targets, the dense gathers and the prefill kernel (K2 over pages
of C rows) are the paged ones; the decode kernels K4/K5 read ``rows``
directly. Int8 with the contiguous layout is not ported
(``NotImplementedError``).

Dropped writes. The JAX package writes with ``.at[...].set(mode="drop")``:
rows addressed through a sentinel (position C for inactive slots and pad
tokens, page ``n_pages`` for unallocated table entries) vanish.
``torch.index_put_`` has no drop mode: an out-of-range index raises on
the CPU and corrupts or faults on CUDA. So each store carries ONE scratch
page past its end (physical index ``n_pages``, which is also the
sentinel; for the contiguous layout the scratch SLOT ``S``), and the
scales leaf its scratch page too: every write whose slot, position or
table entry is a sentinel is redirected there before the scatter. The
scratch is never read — readers see only ``pages[:n_pages]`` (``pool``)
and gathers zero-fill sentinel rows — so the redirect is the drop,
without a host sync to filter the rows.

Unlike JAX's functional updates, the scatters here write into the store
in place; the pool is the largest buffer on the card and is never copied.
``clone_page`` (the copy-on-write primitive of prefix reuse) copies one
physical page over every layer in place in the same way, and
``scatter_pages`` (the host tier's restore) writes whole pages in place;
``gather_pages`` (its offload) reads them into a fresh tensor. Both keep
the cache's representation (int8 pages with their scales) and take real
page ids only, never the scratch page.

PAGE IDENTITY (the cross-release prefix cache, engine/prefix_cache.py):
a full page is named by a chained block hash over token ids,
``page_chain_hash(parent, tokens, scope)``, never by its float content.
The digests are byte-identical to the JAX package's for the same inputs.
"""

from __future__ import annotations

import hashlib
from typing import Tuple

import numpy as np
import torch

_EPS = 1e-8

PAGE_HASH_BYTES = 16
PAGE_HASH_ROOT = b"\x00" * PAGE_HASH_BYTES


def page_scope(page_size: int, *parts) -> bytes:
    """Scope token for a page-hash chain: the page size plus any
    model-identity parts. Two engines whose scopes differ never alias
    each other's chains: the scope is folded into every link."""
    text = "|".join([f"pg={int(page_size)}"] + [str(p) for p in parts])
    return hashlib.blake2b(text.encode("utf-8"),
                           digest_size=PAGE_HASH_BYTES).digest()


def page_chain_hash(parent: bytes, token_ids, scope: bytes) -> bytes:
    """hash(scope, parent, page token ids): one link of the chained block
    hash; ``parent`` is PAGE_HASH_ROOT for the first page. Token ids are
    hashed as int64, so the digest does not depend on the container."""
    h = hashlib.blake2b(digest_size=PAGE_HASH_BYTES)
    h.update(scope)
    h.update(parent)
    h.update(np.asarray(token_ids, np.int64).tobytes())
    return h.digest()


def init_paged(shape: Tuple[int, ...], dtype, page_size: int,
               num_pages: int = 0, device="cuda") -> dict:
    """Zeroed page pool for the logical shape [L, S, C, KV, hd]. C must be
    a multiple of page_size; num_pages defaults to S * C / page_size.
    ``dtype=torch.int8`` selects the int8 pages with their scales."""
    L, S, C, KV, hd = shape
    if C % page_size:
        raise ValueError(f"max_context {C} not a multiple of page_size "
                         f"{page_size}")
    mp = C // page_size
    n = num_pages or S * mp
    out = {"pages": torch.zeros((L, n + 1, page_size, KV, hd), dtype=dtype,
                                device=device),
           "ptab": torch.full((S, mp), n, dtype=torch.int32, device=device)}
    if dtype == torch.int8:
        out["scales"] = torch.zeros((L, n + 1, page_size, KV),
                                    dtype=torch.float32, device=device)
    return out


def init(shape: Tuple[int, ...], dtype, device="cuda") -> dict:
    """Zeroed contiguous cache for the logical shape [L, S, C, KV, hd]
    (plus the scratch slot S)."""
    L, S, C, KV, hd = shape
    if dtype == torch.int8:
        raise NotImplementedError(
            "int8 KV with the contiguous layout is not ported; use "
            "kv_layout=paged with kv_cache_dtype=int8")
    return {"rows": torch.zeros((L, S + 1, C, KV, hd), dtype=dtype,
                                device=device),
            "itab": torch.arange(S, dtype=torch.int32,
                                 device=device).reshape(S, 1)}


def is_paged(cache: dict) -> bool:
    """True for the page-pool layout (full cache or single-layer view)."""
    return "ptab" in cache


def is_quant(cache: dict) -> bool:
    """True when rows are stored int8 with scales."""
    return "scales" in cache


def _store(cache: dict) -> torch.Tensor:
    return cache["pages"] if is_paged(cache) else cache["rows"]


def table(cache: dict) -> torch.Tensor:
    """The page table: ``ptab``, or the contiguous layout's identity."""
    return cache["ptab"] if is_paged(cache) else cache["itab"]


def shape(cache: dict) -> Tuple[int, ...]:
    """Logical shape [L, S, C, KV, hd]."""
    st = _store(cache)
    s, mp = table(cache).shape
    return (st.shape[0], s, mp * st.shape[-3]) + tuple(st.shape[-2:])


def layer(cache: dict, li: int) -> dict:
    """Single-layer view (the stores indexed at li, sharing storage)."""
    return {k: (v if k in ("ptab", "itab") else v[li]) for k, v in cache.items()}


def pool(lcache: dict) -> torch.Tensor:
    """The readable store of a single-layer view, without its scratch page:
    [n_pages, pg, KV, hd] pages, or [S, C, KV, hd] contiguous rows
    (contiguous: a leading-dimension slice)."""
    return _store(lcache)[:-1]


def scales_pool(lcache: dict) -> torch.Tensor:
    """The readable scales [n_pages, pg, KV] of an int8 single-layer view."""
    return lcache["scales"][:-1]


def _page_of(ptab_rows: torch.Tensor, cols: torch.Tensor, pg: int,
             n_pages: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(physical page, in-page row) for logical columns. Columns past the
    table (>= MP * pg, e.g. the position sentinel C) and unallocated
    entries map to the scratch page ``n_pages``."""
    mp = ptab_rows.shape[-1]
    cols = cols.to(torch.int64)
    pidx = cols // pg
    page = torch.gather(ptab_rows.to(torch.int64), -1,
                        pidx.clamp(0, mp - 1)[..., None])[..., 0]
    ok = (pidx >= 0) & (pidx < mp) & (page >= 0) & (page < n_pages)
    return torch.where(ok, page, torch.full_like(page, n_pages)), cols % pg


def gather_pool_rows(pages: torch.Tensor, ptab: torch.Tensor,
                     slot_ids: torch.Tensor) -> torch.Tensor:
    """Dense logical rows [B, C, ...] of the given slots from a pool
    [n_pages, pg, ...] (pages [.., KV, hd] or scales [.., KV]); rows on
    unallocated pages read as zeros (JAX's mode="fill"), out-of-range slot
    ids clamp (JAX's gather clamp)."""
    n, pg = pages.shape[0], pages.shape[1]
    S = ptab.shape[0]
    slot_ids = slot_ids.to(torch.int64).clamp(0, S - 1)
    tab = ptab[slot_ids].to(torch.int64)                         # [B, MP]
    valid = (tab >= 0) & (tab < n)
    rows = pages[tab.clamp(0, n - 1)]                            # [B, MP, pg, ...]
    rows = rows * valid.reshape(valid.shape + (1,) * (pages.dim() - 1)).to(rows.dtype)
    B, mp = tab.shape
    return rows.reshape(B, mp * pg, *pages.shape[2:])


def gather_layer_rows(lcache: dict, slot_ids: torch.Tensor):
    """Dense [B, C, KV, hd] rows of the given slots of a single-layer view;
    int8 caches give {"q": int8 rows, "s": [B, C, KV] scales}, the form
    ops/attention.py folds."""
    rows = gather_pool_rows(pool(lcache), table(lcache), slot_ids)
    if is_quant(lcache):
        return {"q": rows, "s": gather_pool_rows(scales_pool(lcache),
                                                 table(lcache), slot_ids)}
    return rows


def gather_all_rows(lcache: dict):
    """Dense [S, C, KV, hd] rows (int8: {"q","s"}) of every slot of a
    single-layer view."""
    tab = table(lcache)
    return gather_layer_rows(lcache, torch.arange(tab.shape[0], device=tab.device))


def quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 over the trailing (head_dim) axis, the JAX package's
    rounding: x [..., hd] -> (q int8 [..., hd], s float32 [...])."""
    x32 = x.to(torch.float32)
    s = torch.clamp_min(x32.abs().amax(dim=-1) / 127.0, _EPS)
    q = torch.clamp(torch.round(x32 / s[..., None]), -127, 127).to(torch.int8)
    return q, s


def scatter_index(lcache: dict, slot_idx: torch.Tensor, cols: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(physical page, in-page row) targets of rows ``cols`` of slots
    ``slot_idx``; rows at a sentinel position or on an unallocated page
    are redirected to the scratch page (dropped). The table and positions
    are the same for every layer, so callers compute this once per step."""
    st = _store(lcache)
    n, pg = st.shape[0] - 1, st.shape[1]
    tab = table(lcache)
    slot_idx = slot_idx.to(torch.int64).clamp(0, tab.shape[0] - 1)
    return _page_of(tab[slot_idx], cols, pg, n)


def write_rows(lcache: dict, target: Tuple[torch.Tensor, torch.Tensor],
               new_kv: torch.Tensor) -> dict:
    """Write rows [R, KV, hd] at the ``scatter_index`` targets, in place;
    int8 caches quantize them on the way (pages and scales)."""
    st = _store(lcache)
    if is_quant(lcache):
        q, s = quantize(new_kv)
        st.index_put_(target, q)
        lcache["scales"].index_put_(target, s)
    else:
        st.index_put_(target, new_kv.to(st.dtype))
    return lcache


def scatter_decode(lcache: dict, slot_idx: torch.Tensor, lengths: torch.Tensor,
                   new_kv: torch.Tensor) -> dict:
    """Write one row per slot at [slot, lengths[slot]], in place; rows at a
    sentinel position or on an unallocated page are dropped (scratch).

    new_kv: [S, KV, hd] float."""
    return write_rows(lcache, scatter_index(lcache, slot_idx, lengths), new_kv)


def scatter_ragged(lcache: dict, slot_of: torch.Tensor, cols: torch.Tensor,
                   new_kv: torch.Tensor) -> dict:
    """Packed-prefill scatter, in place: row ``cols[n]`` of slot
    ``slot_of[n]`` gets ``new_kv[n]``. Pad tokens carry the column
    sentinel C and are dropped; out-of-range slot ids (pad segments)
    clamp, their column sentinel still drops the write."""
    return write_rows(lcache, scatter_index(lcache, slot_of, cols), new_kv)


def clone_page(cache: dict, src: int, dst: int) -> dict:
    """Copy physical page ``src`` over page ``dst`` in every layer, in
    place, scales included for int8 (the copy-on-write primitive: the
    first page a request writes is cloned when others still read it).
    Both must be real pages (< n_pages): the scratch page is never a
    source or a target."""
    st = cache["pages"]
    n = st.shape[1] - 1
    if not (0 <= src < n and 0 <= dst < n):
        raise ValueError(f"clone_page({src}, {dst}) outside the {n} pages")
    st[:, dst].copy_(st[:, src])
    if is_quant(cache):
        cache["scales"][:, dst].copy_(cache["scales"][:, src])
    return cache


def _page_index(cache: dict, page_ids) -> torch.Tensor:
    """Host page ids as an int64 index on the store's device, each checked
    to be a real page (< n_pages: never the scratch page, never padding).
    On CUDA the ids go through a pinned buffer without waiting for the
    stream (engine/transfer.py's rule)."""
    ids = np.asarray(page_ids, np.int64).reshape(-1)
    n = cache["pages"].shape[1] - 1
    if ids.size == 0 or ids.min() < 0 or ids.max() >= n:
        raise ValueError(f"page ids {ids.tolist()} outside the {n} pages")
    t = torch.from_numpy(ids)
    dev = cache["pages"].device
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t


def gather_pages(cache: dict, page_ids):
    """Whole physical pages [L, n, page_size, KV, hd] of a paged cache, a
    fresh tensor (int8: {"q": rows, "s": scales [L, n, page_size, KV]}):
    the offload's read, dtype-preserving, so the host tier keeps the
    device representation. ``page_ids``: host ints, real pages only."""
    idx = _page_index(cache, page_ids)
    rows = cache["pages"].index_select(1, idx)
    if is_quant(cache):
        return {"q": rows, "s": cache["scales"].index_select(1, idx)}
    return rows


def scatter_pages(cache: dict, page_ids, rows) -> dict:
    """Write whole pages back, IN PLACE (the captured decode and prefill
    graphs read ``pages`` and ``scales`` where they lie): the restore,
    gather_pages' inverse. ``rows`` in gather_pages' form, on the cache's
    device; int8 scales are copied, never requantized. ``page_ids``: host
    ints, real pages only."""
    idx = _page_index(cache, page_ids)
    if is_quant(cache):
        cache["pages"].index_copy_(1, idx, rows["q"])
        cache["scales"].index_copy_(1, idx, rows["s"])
    else:
        cache["pages"].index_copy_(1, idx, rows.to(cache["pages"].dtype))
    return cache


def copy_rows(cache: dict, src: int, dst: int, n: int) -> dict:
    """Contiguous layout: copy rows [0, n) of slot ``src`` over slot
    ``dst``'s in every layer, in place (a fork sibling takes its leader's
    prompt rows: the JAX engine's ``_get_fork_fn``)."""
    rows = cache["rows"]
    rows[:, dst, :n].copy_(rows[:, src, :n])
    return cache


def from_jax(jcache, device="cuda") -> dict:
    """A JAX package cache as numpy leaves (paged {"pages", "ptab"[,
    "scales"]} or a contiguous [L, S, C, KV, hd] array) -> this layout,
    with the zeroed scratch page / slot appended. For tests that hand the
    same cache to both packages."""
    def t(a, **kw):
        return torch.from_numpy(np.array(a, **kw)).to(device)

    if isinstance(jcache, dict) and "ptab" in jcache:
        out = {"ptab": t(jcache["ptab"], dtype=np.int32)}
        for k in ("pages", "scales"):
            if k in jcache:
                a = np.asarray(jcache[k])
                pad = np.zeros((a.shape[0], 1) + a.shape[2:], a.dtype)
                out[k] = t(np.concatenate([a, pad], axis=1))
        return out
    if isinstance(jcache, dict):
        raise NotImplementedError("int8 contiguous caches are not ported")
    a = np.asarray(jcache)
    pad = np.zeros((a.shape[0], 1) + a.shape[2:], a.dtype)
    S = a.shape[1]
    return {"rows": t(np.concatenate([a, pad], axis=1)),
            "itab": t(np.arange(S).reshape(S, 1), dtype=np.int32)}
