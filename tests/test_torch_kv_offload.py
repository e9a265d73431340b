"""The port's host tier store (localai_tpu_torch/engine/kv_offload.py)
against the JAX package's (localai_tpu/engine/kv_offload.py), on the CPU:
the same put / get sequences give the same entries, LRU order, CRCs and
``stats()`` (budget eviction with its cascade, a duplicate put, a
corrupted entry dropped with its subtree); ``PrefetchPipeline`` register
/ claim / expire / drain; store files written by either package load in
the other byte for byte (bf16 and int8 pages, the same scope bytes);
defective files are ignored; and ``gather_pages`` / ``scatter_pages``
(ops/kvcache.py) against the JAX ops on the same numpy pool.

bf16 pages: the JAX store holds ml_dtypes bfloat16 arrays, the port their
uint16 bit patterns (numpy has no bfloat16).
"""

from __future__ import annotations

import tests.torch_cpu  # noqa: F401  (one torch CPU thread)

import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from localai_tpu.engine import kv_offload as jkv
from localai_tpu.ops import kvcache as jkvc
from localai_tpu_torch.engine import kv_offload as tkv
from localai_tpu_torch.ops import kvcache as tkvc

PG = 4
SHAPE = (2, PG, 2, 8)            # one page: [L, pg, KV, hd]


def _scope(pg=PG, name="unit"):
    return tkvc.page_scope(pg, name)


def _pages(rng, kind: str):
    """(JAX k, JAX v, port k, port v) of one random page of ``kind``
    (float32 | bfloat16 | int8), the same bytes on both sides."""
    def one():
        if kind == "int8":
            q = rng.integers(-127, 128, size=SHAPE).astype(np.int8)
            s = rng.random(SHAPE[:-1], dtype=np.float32)
            return {"q": q, "s": s}, {"q": q.copy(), "s": s.copy()}
        x = rng.standard_normal(SHAPE).astype(np.float32)
        if kind == "bfloat16":
            b = x.astype(ml_dtypes.bfloat16)
            return b, b.view(np.uint16).copy()
        return x, x.copy()
    jk, tk = one()
    jv, tv = one()
    return jk, jv, tk, tv


def _bytes(rows) -> bytes:
    if isinstance(rows, dict):
        return b"".join(np.ascontiguousarray(rows[k]).tobytes() for k in ("q", "s"))
    return np.ascontiguousarray(rows).tobytes()


def _state(store):
    """Keys in LRU order (oldest first) with depth, parent, CRC and bytes,
    and the counters the port keeps."""
    with store._lock:
        es = sorted(store._entries.values(), key=lambda e: e.tick)
        entries = [(e.key, e.parent, e.depth, e.crc, e.nbytes,
                    _bytes(e.k), _bytes(e.v)) for e in es]
        kids = {p: sorted(c) for p, c in store._children.items()}
    st = store.stats()
    return entries, kids, {k: st[k] for k in tkv.HostPageStore(b"", 1, 1).stats()
                           if k not in ("budget_bytes",)}


class _Pair:
    """One JAX store and one port store driven with the same calls."""

    def __init__(self, budget_mb: int, kind: str, seed: int = 0):
        self.j = jkv.HostPageStore(_scope(), PG, budget_mb)
        self.t = tkv.HostPageStore(_scope(), PG, budget_mb)
        self.rng = np.random.default_rng(seed)
        self.kind = kind

    def chain(self, n: int, start: int, parent=None) -> list:
        parent = parent or tkvc.PAGE_HASH_ROOT
        keys = []
        for i in range(n):
            key = tkvc.page_chain_hash(parent, [start + i] * PG, self.j.scope)
            jk, jv, tk, tv = _pages(self.rng, self.kind)
            assert self.j.put(key, parent, i, jk, jv) == \
                self.t.put(key, parent, i, tk, tv)
            keys.append(key)
            parent = key
        return keys

    def get(self, key):
        a, b = self.j.get(key), self.t.get(key)
        assert (a is None) == (b is None)
        if a is not None:
            assert a.crc == b.crc and _bytes(a.k) == _bytes(b.k)
        return b

    def same(self):
        assert _state(self.j) == _state(self.t)


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
def test_put_get_dedup_and_lru_order_match_jax(kind):
    p = _Pair(64, kind)
    a = p.chain(3, 0)
    p.same()
    p.get(a[1])
    p.same()
    # a duplicate key is touched, never replaced
    jk, jv, tk, tv = _pages(p.rng, kind)
    assert p.j.put(a[0], tkvc.PAGE_HASH_ROOT, 0, jk, jv) is False
    assert p.t.put(a[0], tkvc.PAGE_HASH_ROOT, 0, tk, tv) is False
    p.same()
    assert p.get(b"\x01" * 16) is None
    b = p.chain(2, 50, parent=a[2])
    p.get(a[0])
    p.same()
    assert p.t.pages == 5 and p.t.stats()["offloaded_pages"] == 5
    assert p.t.contains(b[1]) and p.t.contains_any(b[1])
    assert not p.t.contains(b"\x02" * 16)


@pytest.mark.parametrize("kind", ["float32", "int8"])
def test_budget_eviction_cascades_as_in_jax(kind):
    """The host -> gone edge: LRU-first past the byte budget (ties: the
    deepest link), descendants go with their ancestor; a page over the
    whole budget is refused."""
    page_bytes = len(_bytes(_pages(np.random.default_rng(0), kind)[2])) * 2
    p = _Pair(1, kind, seed=3)
    cap = (1 << 20) // page_bytes
    a = p.chain(3, 0)
    b = p.chain(3, 100)
    for k in a:                           # a is now the most recent
        p.get(k)
    # fill past the budget: b's chain goes first (LRU), then deeper links
    p.chain(cap - 4, 1000, parent=a[2])
    p.same()
    assert p.t.bytes_used <= p.t.budget_bytes
    assert p.t.stats()["evicted_pages"] >= 3
    assert not any(p.t.contains(k) for k in b)
    # evicting a root cascades its subtree
    with p.j._lock:
        p.j._remove_tree_locked(a[0])
    with p.t._lock:
        p.t._remove_tree_locked(a[0])
    p.same()
    assert p.t.pages == 0 and p.t.bytes_used == 0


def test_oversized_page_is_refused_as_in_jax():
    big = np.zeros((64, 64, 64, 8), np.float32)     # 8 MiB a leaf
    j, t = jkv.HostPageStore(_scope(), PG, 1), tkv.HostPageStore(_scope(), PG, 1)
    key = tkvc.page_chain_hash(tkvc.PAGE_HASH_ROOT, [1] * PG, _scope())
    assert j.put(key, tkvc.PAGE_HASH_ROOT, 0, big, big) is False
    assert t.put(key, tkvc.PAGE_HASH_ROOT, 0, big, big) is False
    assert _state(j) == _state(t) and t.pages == 0


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
def test_corrupt_entry_drops_its_subtree(kind):
    """A flipped byte in a held page: the next read misses, the entry and
    every descendant go, ``corrupt_dropped`` counts it; the same on both
    sides."""
    p = _Pair(64, kind, seed=7)
    a = p.chain(4, 0)
    other = p.chain(2, 300)
    for s in (p.j, p.t):
        e = s._entries[a[1]]
        leaf = e.k["q"] if isinstance(e.k, dict) else e.k
        leaf.view(np.uint8).reshape(-1)[5] ^= 0x40
    assert p.get(a[1]) is None
    p.same()
    st = p.t.stats()
    assert st["corrupt_dropped"] == 1 and st["evicted_pages"] == 3
    assert p.t.contains(a[0]) and not any(p.t.contains(k) for k in a[1:])
    assert all(p.get(k) is not None for k in other)


def test_counters_match_jax():
    p = _Pair(64, "float32")
    for s in (p.j, p.t):
        s.note_restore(3)
        s.note_miss()
        s.note_prefetch_issued(2)
        s.note_prefetch_hit(1)
        s.note_prefetch_late(1)
        s.note_prefetch_wasted(1)
        s.note_prefetch_done()
        s.note_prefetch_done()
    p.same()
    st = p.t.stats()
    assert (st["restores"], st["hits"], st["restored_pages"], st["misses"]) == (1, 1, 3, 1)
    assert st["prefetch_inflight"] == 0
    for s in (p.j, p.t):
        s.clear()
    p.same()


def test_prefetch_pipeline_matches_jax():
    j, t = jkv.PrefetchPipeline(max_age=3), tkv.PrefetchPipeline(max_age=3)
    keys = [bytes([i]) * 16 for i in range(5)]
    for pf in (j, t):
        for i, k in enumerate(keys[:3]):
            pf.register(k, tkvc.PAGE_HASH_ROOT, 10 + i, i)
            pf.tick += 1
        pf.seen_rids.add("r1")
    assert j.pages == t.pages and len(t) == 3
    assert j.claim(keys[1]) == t.claim(keys[1]) == [11, tkvc.PAGE_HASH_ROOT, 1, 1]
    assert j.claim(keys[1]) is None and t.claim(keys[1]) is None
    for pf in (j, t):
        pf.tick = 4                      # keys[0] registered at tick 0
        pf.register(keys[3], keys[2], 20, 3)
    assert j.expire() == t.expire() == [(keys[0], [10, tkvc.PAGE_HASH_ROOT, 0, 0])]
    assert j.drain() == t.drain()
    assert len(t) == 0 and not t.seen_rids and t.pages == j.pages == {}


def _fill(pair, kind, n=5, seed=11):
    pair.rng = np.random.default_rng(seed)
    keys = pair.chain(n, 0)
    pair.get(keys[2])                    # an LRU order that is not insertion's
    return keys


@pytest.mark.parametrize("kind", ["bfloat16", "int8"])
def test_jax_file_loads_in_the_port(tmp_path, kind):
    p = _Pair(64, kind)
    _fill(p, kind)
    path = str(tmp_path / "jax.npz")
    assert p.j.save(path)
    t2 = tkv.HostPageStore(_scope(), PG, 64)
    assert t2.load(path) == 5
    assert _state(t2)[0] == _state(p.j)[0]       # entries, LRU order, bytes
    assert t2.stats()["offloaded_pages"] == 0     # not this process's offloads
    e = t2.get(next(iter(p.j._entries)))
    leaf = e.k["q"] if kind == "int8" else e.k
    assert leaf.dtype == (np.int8 if kind == "int8" else np.uint16)


@pytest.mark.parametrize("kind", ["bfloat16", "int8"])
def test_port_file_loads_in_jax(tmp_path, kind):
    p = _Pair(64, kind)
    _fill(p, kind)
    path = str(tmp_path / "port.npz")
    assert p.t.save(path)
    j2 = jkv.HostPageStore(_scope(), PG, 64)
    assert j2.load(path) == 5
    assert _state(j2)[0] == _state(p.t)[0]
    e = j2.get(next(iter(p.t._entries)))
    leaf = e.k["q"] if kind == "int8" else e.k
    assert str(leaf.dtype) == ("int8" if kind == "int8" else "bfloat16")
    # the two packages write the same arrays
    jpath = str(tmp_path / "jax.npz")
    assert p.j.save(jpath)
    with np.load(path) as a, np.load(jpath) as b:
        assert sorted(a.files) == sorted(b.files)
        for f in a.files:
            assert a[f].dtype == b[f].dtype and np.array_equal(a[f], b[f]), f


def test_port_save_and_load_roundtrip_and_empty_store(tmp_path):
    p = _Pair(64, "float32")
    keys = _fill(p, "float32")
    path = str(tmp_path / "s.npz")
    assert p.t.save(path)
    t2 = tkv.HostPageStore(_scope(), PG, 64)
    assert t2.load(path) == 5 and _state(t2)[0] == _state(p.t)[0]
    assert t2.get(keys[4]).depth == 4
    # an empty store leaves no stale file behind
    assert tkv.HostPageStore(_scope(), PG, 64).save(path) is False
    assert not os.path.exists(path)


@pytest.mark.parametrize("defect", ["version", "scope", "page_size",
                                    "truncated", "garbage", "missing"])
def test_defective_files_are_ignored(tmp_path, defect):
    p = _Pair(64, "float32")
    _fill(p, "float32")
    path = str(tmp_path / "s.npz")
    assert p.t.save(path)
    store = tkv.HostPageStore(_scope(), PG, 64)
    if defect == "version":
        with np.load(path) as d:
            arrs = {k: d[k] for k in d.files}
        arrs["version"] = np.int32(tkv.STORE_VERSION + 1)
        with open(path, "wb") as f:
            np.savez(f, **arrs)
    elif defect == "scope":
        store = tkv.HostPageStore(_scope(name="other-model"), PG, 64)
    elif defect == "page_size":
        store = tkv.HostPageStore(_scope(), PG * 2, 64)
    elif defect == "truncated":
        raw = open(path, "rb").read()
        with open(path, "wb") as f:
            f.write(raw[:len(raw) // 3])
    elif defect == "garbage":
        with open(path, "wb") as f:
            f.write(b"not an npz" * 7)
    else:
        path = str(tmp_path / "absent.npz")
    assert store.load(path) == 0 and store.pages == 0
    # the JAX store ignores the same file
    if defect not in ("scope", "page_size"):
        assert jkv.HostPageStore(_scope(), PG, 64).load(path) == 0


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_gather_scatter_pages_match_jax(dtype):
    """ops/kvcache.py's offload read and restore write against the JAX
    ops on the same numpy pool: gather gives the same [L, n, pg, KV, hd]
    rows (int8: the same q and scales), scatter writes the same pages in
    place and nothing else (the scratch page untouched); ids outside the
    pool raise."""
    rng = np.random.default_rng(4)
    L, n, KV, hd = 2, 6, 2, 8
    shape = (L, 3, 2 * PG, KV, hd)                  # [L, S, C, KV, hd]
    jdt = jnp.int8 if dtype == "int8" else jnp.float32
    jcache = jkvc.init_paged(shape, jdt, page_size=PG, num_pages=n)
    if dtype == "int8":
        jcache["pages"] = jnp.asarray(rng.integers(-127, 128, size=(L, n, PG, KV, hd)),
                                      jnp.int8)
        jcache["scales"] = jnp.asarray(rng.random((L, n, PG, KV), dtype=np.float32))
    else:
        jcache["pages"] = jnp.asarray(rng.standard_normal((L, n, PG, KV, hd)),
                                      jnp.float32)
    tcache = tkvc.from_jax(jax.tree.map(np.asarray, jcache), device="cpu")
    ids = [4, 1]
    jrows = jax.tree.map(np.asarray, jkvc.gather_pages(jcache, jnp.asarray(ids)))
    trows = tkvc.gather_pages(tcache, ids)
    if dtype == "int8":
        for leaf in ("q", "s"):
            assert np.array_equal(trows[leaf].numpy(), jrows[leaf])
    else:
        assert np.array_equal(trows.numpy(), jrows)
    # restore those rows into pages 0 and 5 of a blank pool
    jblank = jkvc.init_paged(shape, jdt, page_size=PG, num_pages=n)
    tblank = tkvc.from_jax(jax.tree.map(np.asarray, jblank), device="cpu")
    jout = jkvc.scatter_pages(jblank, jnp.asarray([0, 5]), jkvc.gather_pages(
        jcache, jnp.asarray(ids)))
    store = tblank["pages"]
    assert tkvc.scatter_pages(tblank, [0, 5], trows) is tblank
    assert tblank["pages"] is store                 # written in place
    assert np.array_equal(tblank["pages"][:, :n].numpy(), np.asarray(jout["pages"]))
    assert not tblank["pages"][:, n].any()          # the scratch page
    if dtype == "int8":
        assert np.array_equal(tblank["scales"][:, :n].numpy(),
                              np.asarray(jout["scales"]))
        assert not tblank["scales"][:, n].any()
    for bad in ([n], [-1], []):
        with pytest.raises(ValueError):
            tkvc.gather_pages(tcache, bad)
        with pytest.raises(ValueError):
            tkvc.scatter_pages(tblank, bad, trows)


def test_gather_scatter_bf16_roundtrip_through_the_host_form():
    """bf16 pages leave as host tensors whose numpy view is their uint16
    bit patterns (transfer.pages_to_host, numpy_of) and come back byte for
    byte, from those tensors or from the arrays (transfer.pages_to_device,
    tensor_of)."""
    from localai_tpu_torch.engine.transfer import (
        numpy_of, pages_to_device, pages_to_host, tensor_of)

    g = torch.Generator().manual_seed(0)
    cache = tkvc.init_paged((2, 2, 8, 2, 4), torch.bfloat16, PG, device="cpu")
    cache["pages"].copy_(torch.randn(cache["pages"].shape, generator=g))
    host = pages_to_host(tkvc.gather_pages(cache, [3, 0]))
    arrays = [numpy_of(h) for h in host]
    assert [a.dtype for a in arrays] == [np.uint16] * 2
    assert arrays[0].shape == (2, PG, 2, 4)
    for pages in (host, [tensor_of(a) for a in arrays]):
        back = pages_to_device(pages, torch.device("cpu"))
        assert back.dtype == torch.bfloat16 and back.shape == (2, 2, PG, 2, 4)
        blank = tkvc.init_paged((2, 2, 8, 2, 4), torch.bfloat16, PG, device="cpu")
        tkvc.scatter_pages(blank, [3, 0], back)
        assert torch.equal(blank["pages"][:, [3, 0]], cache["pages"][:, [3, 0]])
