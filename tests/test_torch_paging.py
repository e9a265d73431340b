"""The PyTorch port's page allocator, page hashing and prefix cache against
the JAX package's, on the CPU (host-side code: no tolerance, everything
compared exactly).

  * ``page_scope`` / ``page_chain_hash`` digests are byte-identical to
    the JAX functions' over random token pages, parents and scopes, and
    so are ``build_scope`` and the cache's ``chain_keys``;
  * seeded random sequences of ensure / release / share / hold / drop /
    splice / alloc_detached / adopt / cow_page / replace / alloc_many /
    unref_detached on the port's ``PagePool`` and the JAX ``PagePool``
    leave equal tables, counts, holds and free lists, and raise the same
    errors (KVLifecycleError, PoolExhausted) at the same steps;
  * ``PrefixPageCache`` insert / match / evict / attach over paired pools
    gives the same pages, counts and pool states as the JAX class;
  * ``clone_page`` copies one page over every layer in place (scales too
    for int8), leaves every other page and the scratch page alone, and
    equals the JAX ``clone_page``.
"""

from __future__ import annotations

import tests.torch_cpu  # noqa: F401  (one torch CPU thread)

import numpy as np
import pytest
import torch

from localai_tpu.engine import paging as jpaging
from localai_tpu.engine import prefix_cache as jprefix
from localai_tpu.ops import kvcache as jkv
from localai_tpu_torch.engine import paging as tpaging
from localai_tpu_torch.engine import prefix_cache as tprefix
from localai_tpu_torch.ops import kvcache as tkv


def test_hash_constants_match():
    assert tkv.PAGE_HASH_BYTES == jkv.PAGE_HASH_BYTES
    assert tkv.PAGE_HASH_ROOT == jkv.PAGE_HASH_ROOT


@pytest.mark.parametrize("seed", range(4))
def test_page_hash_digests_byte_identical(seed):
    rng = np.random.default_rng(seed)
    for _ in range(25):
        pg = int(rng.choice([4, 16, 64]))
        parts = [str(x) for x in rng.integers(0, 1000, size=int(rng.integers(0, 5)))]
        parts += ["llama", float(rng.random()), "bfloat16"][: int(rng.integers(0, 4))]
        scope = tkv.page_scope(pg, *parts)
        assert scope == jkv.page_scope(pg, *parts)
        parent = (tkv.PAGE_HASH_ROOT if rng.random() < 0.3
                  else rng.bytes(tkv.PAGE_HASH_BYTES))
        toks = rng.integers(0, 128256, size=pg)
        for container in (toks.tolist(), toks.astype(np.int32), toks):
            got = tkv.page_chain_hash(parent, container, scope)
            assert got == jkv.page_chain_hash(parent, container, scope)
            assert len(got) == tkv.PAGE_HASH_BYTES


def test_build_scope_and_chain_keys_match():
    class Cfg:
        num_layers, num_kv_heads, head_dim_, vocab_size = 2, 2, 16, 258
        rope_theta = 10000.0

    for pg in (4, 16):
        st = tprefix.build_scope("llama", Cfg(), pg, "float32")
        assert st == jprefix.build_scope("llama", Cfg(), pg, "float32")
        tc = tprefix.PrefixPageCache(st, pg)
        jc = jprefix.PrefixPageCache(st, pg)
        ids = np.random.default_rng(pg).integers(0, 258, size=5 * pg + 3).tolist()
        assert list(tc.chain_keys(ids)) == list(jc.chain_keys(ids))
        assert len(list(tc.chain_keys(ids))) == 5


# ---------- PagePool against the JAX PagePool ----------

def _pool_state(p) -> dict:
    return {"ptab": p.ptab.copy(), "refs": p.refs.copy(), "held": p.held.copy(),
            "owned": p.owned.copy(), "free": list(p._free),
            "retained": p.retained_pages, "active": p.active_pages,
            "in_use": p.pages_in_use}


def _assert_same(tp, jp):
    a, b = _pool_state(tp), _pool_state(jp)
    for k in a:
        assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k


def _both(tp, jp, name, *args):
    """Run one op on both pools: the same result, or the same error."""
    out = []
    for p in (tp, jp):
        try:
            out.append(("ok", getattr(p, name)(*args)))
        except Exception as e:          # compared by type name below
            out.append(("err", type(e).__name__))
    assert out[0] == out[1], (name, args, out)
    return out[0]


@pytest.mark.parametrize("seed", range(6))
def test_page_pool_random_ops_match_jax(seed):
    rng = np.random.default_rng(100 + seed)
    S, C, pg = 4, 64, 8
    n_pages = int(rng.choice([0, 12, 20]))      # 0 = the full reservation
    tp = tpaging.PagePool(S, C, pg, n_pages)
    jp = jpaging.PagePool(S, C, pg, n_pages)
    _assert_same(tp, jp)
    detached: list = []
    for _ in range(400):
        op = rng.choice(["ensure", "release", "share", "hold", "drop", "splice",
                         "detach", "adopt", "cow", "alloc_many", "unref"],
                        p=[.2, .1, .12, .1, .08, .1, .05, .06, .08, .03, .08])
        slot = int(rng.integers(0, S))
        if op in ("share", "splice") and rng.random() < 0.7:
            _both(tp, jp, "release", slot, 0)     # mostly into an empty table
        if op == "ensure":
            _both(tp, jp, "ensure", slot, int(rng.integers(0, C + 1)))
        elif op == "release":
            _both(tp, jp, "release", slot, int(rng.integers(0, C + 1)))
        elif op == "share":
            _both(tp, jp, "share", int(rng.integers(0, S)), slot,
                  int(rng.integers(0, C + 1)))
        elif op in ("hold", "drop"):
            _both(tp, jp, op, int(rng.integers(0, tp.num_pages)))
        elif op == "splice":
            src = int(rng.integers(0, S))
            pages = [int(x) for x in tp.ptab[src, :int(tp.owned[src])]]
            if rng.random() < 0.2:
                pages.append(int(rng.integers(0, tp.num_pages)))
            _both(tp, jp, "splice", slot, pages)
        elif op == "detach":
            r = _both(tp, jp, "alloc_detached")
            if r[0] == "ok":
                detached.append(r[1])
        elif op == "adopt" and detached:
            _both(tp, jp, "adopt", slot, detached.pop())
        elif op == "cow":
            row = int(rng.integers(0, C))
            r = _both(tp, jp, "cow_page", slot, row)
            if r[1] >= 0:
                d = _both(tp, jp, "alloc_detached")
                if d[0] == "ok":
                    _both(tp, jp, "replace", slot, r[1], d[1])
        elif op == "alloc_many":
            r = _both(tp, jp, "alloc_many", int(rng.integers(0, 4)))
            detached.extend(r[1])
        elif op == "unref" and detached:
            _both(tp, jp, "unref_detached", detached.pop())
        _assert_same(tp, jp)
        assert tp.dirty == jp.dirty
        tp.dirty = jp.dirty = False
    # the error paths were reached, not only the happy ones
    with pytest.raises(tpaging.KVLifecycleError):
        tp.drop(int(np.flatnonzero(tp.held == 0)[0]))


def test_page_pool_lifecycle_errors():
    p = tpaging.PagePool(2, 32, 8)
    p.ensure(0, 20)
    with pytest.raises(tpaging.KVLifecycleError):
        p.share(1, 0, 16)                 # into a non-empty table
    with pytest.raises(tpaging.KVLifecycleError):
        p.splice(0, [0])                  # into a non-empty table
    free = p._free[0]
    with pytest.raises(tpaging.KVLifecycleError):
        p.hold(free)                      # a free page
    with pytest.raises(tpaging.KVLifecycleError):
        p.splice(1, [free])               # a freed page
    with pytest.raises(tpaging.KVLifecycleError):
        p.drop(int(p.ptab[0, 0]))         # no hold
    assert p.cow_page(0, 3) == -1         # not shared
    assert p.share(0, 1, 20) == 16        # full pages only
    assert p.cow_page(0, 3) == 0 and p.cow_page(1, 9) == 1
    assert p.cow_page(0, 17) == -1        # page 2 is not shared


# ---------- PrefixPageCache against the JAX class ----------

@pytest.mark.parametrize("seed", range(4))
def test_prefix_cache_random_ops_match_jax(seed):
    rng = np.random.default_rng(200 + seed)
    S, C, pg = 3, 64, 4
    n_pages = int(rng.choice([16, 30, 48]))
    scope = tkv.page_scope(pg, "unit", seed)
    tp, jp = tpaging.PagePool(S, C, pg, n_pages), jpaging.PagePool(S, C, pg, n_pages)
    tc, jc = tprefix.PrefixPageCache(scope, pg), jprefix.PrefixPageCache(scope, pg)
    # prompts share prefixes so chains overlap, diverge and dedup
    roots = [rng.integers(0, 50, size=C).tolist() for _ in range(3)]
    fills: dict = {}        # slot -> the prompt it took

    def prompt():
        base = list(roots[int(rng.integers(0, 3))])
        n = int(rng.integers(1, C))
        ids = base[:n]
        if rng.random() < 0.4 and n > 2:
            ids[int(rng.integers(0, n))] = int(rng.integers(50, 60))
        return ids

    for _ in range(150):
        op = rng.choice(["fill", "insert", "release", "match", "evict"],
                        p=[.3, .25, .15, .2, .1])
        slot = int(rng.integers(0, S))
        if op == "fill":
            # a slot takes a prompt: splice the cache's chain, then allocate
            ids = prompt()
            _both(tp, jp, "release", slot, 0)
            got = tc.match(ids, tp.max_pages)
            assert got == jc.match(ids, jp.max_pages)
            _both(tp, jp, "splice", slot, got)
            try:
                tp.ensure(slot, len(ids))
                terr = None
            except tpaging.PoolExhausted:
                terr = "PoolExhausted"
            try:
                jp.ensure(slot, len(ids))
                jerr = None
            except jpaging.PoolExhausted:
                jerr = "PoolExhausted"
            assert terr == jerr
            if terr:        # the engine's reclaim: evict, then retry
                assert tc.evict(tp, tp.pages_for(len(ids))) == \
                    jc.evict(jp, jp.pages_for(len(ids)))
            fills[slot] = ids
        elif op == "insert":
            ids = fills.get(slot) or prompt()
            assert tc.insert(tp, slot, ids) == jc.insert(jp, slot, ids)
        elif op == "release":
            _both(tp, jp, "release", slot, int(rng.integers(0, C)))
        elif op == "match":
            ids = prompt()
            mp = int(rng.integers(1, 17))
            assert tc.match(ids, mp) == jc.match(ids, mp)
        else:
            need = int(rng.integers(0, n_pages + 2))
            assert tc.evict(tp, need) == jc.evict(jp, need)
        _assert_same(tp, jp)
        assert tc.stats() == jc.stats()
        assert sorted(tc.pages()) == sorted(jc.pages())
    assert tc.inserted_pages > 0


def test_prefix_cache_retain_evict_attach():
    pg = 4
    toks = list(range(14))                       # 3 full pages + a partial
    p = tpaging.PagePool(2, 16, pg)
    p.ensure(0, len(toks))
    c = tprefix.PrefixPageCache(tkv.page_scope(pg, "unit"), pg)
    assert c.insert(p, 0, toks) == 3 and c.pages_held == 3
    assert c.insert(p, 0, toks) == 0             # dedup: touched, not added
    assert p.retained_pages == 0 and p.active_pages == 4
    p.release(0, 0)
    assert p.retained_pages == 3 and p.active_pages == 0
    assert p.free_pages == p.num_pages - 3
    assert c.match(toks + [99], 8) == c.pages()[:3]
    # eviction cascades from the LRU link to its descendants
    assert c.evict(p, p.num_pages) == 3 and len(c) == 0
    assert p.free_pages == p.num_pages and (p.refs == 0).all()
    assert c.evicted_pages == 3
    # attach indexes a page already in a table under a known key
    p.ensure(1, 4)
    key = next(iter(c.chain_keys(toks)))
    assert c.attach(p, key, tkv.PAGE_HASH_ROOT, int(p.ptab[1, 0]), 0)
    assert not c.attach(p, key, tkv.PAGE_HASH_ROOT, int(p.ptab[1, 0]), 0)
    assert c.match(toks, 8) == [int(p.ptab[1, 0])]
    c.clear()
    assert len(c) == 0 and c.evicted_pages == 3


# ---------- clone_page ----------

@pytest.mark.parametrize("quant", [False, True])
def test_clone_page_in_place_matches_jax(quant):
    import jax.numpy as jnp

    rng = np.random.default_rng(7)
    L, n, pg, KV, hd = 2, 5, 4, 2, 8
    if quant:
        pages = rng.integers(-127, 128, size=(L, n, pg, KV, hd)).astype(np.int8)
        scales = rng.random((L, n, pg, KV)).astype(np.float32)
        jc = {"pages": jnp.asarray(pages), "scales": jnp.asarray(scales),
              "ptab": jnp.zeros((2, 3), jnp.int32)}
    else:
        pages = rng.standard_normal((L, n, pg, KV, hd)).astype(np.float32)
        jc = {"pages": jnp.asarray(pages), "ptab": jnp.zeros((2, 3), jnp.int32)}
    tc = tkv.from_jax({k: np.asarray(v) for k, v in jc.items()}, device="cpu")
    tc["pages"][:, n].fill_(3)                   # the scratch page
    before = tc["pages"].clone()
    store = tc["pages"].data_ptr()
    out = tkv.clone_page(tc, 1, 3)
    assert out is tc and tc["pages"].data_ptr() == store     # in place
    ref = jkv.clone_page(jc, 1, 3)
    assert np.array_equal(tc["pages"][:, :n].numpy(), np.asarray(ref["pages"]))
    keep = [i for i in range(n + 1) if i != 3]
    assert torch.equal(tc["pages"][:, keep], before[:, keep])
    if quant:
        assert np.array_equal(tc["scales"][:, :n].numpy(), np.asarray(ref["scales"]))
    for bad in ((1, n), (n, 1), (-1, 2)):
        with pytest.raises(ValueError):
            tkv.clone_page(tc, *bad)
