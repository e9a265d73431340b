"""The cross-release prefix cache: a token-hash-keyed index of retained
pages (a copy of localai_tpu/engine/prefix_cache.py's PrefixPageCache and
build_scope, without the replica-pool callbacks).

  * Identity is a CHAINED BLOCK HASH over token ids, never page content:
    key_i = hash(scope, key_{i-1}, tokens[i*pg:(i+1)*pg])
    (ops/kvcache.py::page_chain_hash). The scope folds the model's
    geometry, the cache dtype and the page size into every link; the
    parent chain makes "same page tokens, other history" a different
    key, so a divergence at page j hides every page past j (a page's
    rows encode their absolute positions through rope).
  * At slot release the engine calls ``insert``: each committed FULL
    page gets a ``PagePool.hold`` reference and an entry, so it outlives
    the slot's table (RETAINED).
  * At admission the engine calls ``match``: the chain is walked from
    the root, and the pages of the contiguous present links are spliced
    into the new slot's table (``PagePool.splice``; zero row copies). A
    retained page back in a table has refs >= 2, so the engine's
    copy-on-write guard clones it before the first write.
  * Under pool pressure the engine calls ``evict``: entries go
    LRU-first (ties: the deepest link first), removal cascades to the
    descendants (an orphan is unreachable), and each ``drop`` frees its
    page once nothing else references it. Eviction never touches a live
    slot, so reclaim cannot deadlock. With the host tier on, ``evict``'s
    ``on_evict`` hook hands each removed entry to the engine, which
    offloads its page (engine/kv_offload.py); a restored page re-enters
    this index through ``attach``.

Entries are one page each, so the index is bounded by the pool: pool
pressure is the only capacity limit. Single-threaded: the engine thread
alone calls it. With ``kv_audit`` on, ``audit`` is the engine's KVAuditor:
insert and attach record "retain", eviction records "evict"; and the
``kv_leak`` fault (services/faults.py) skips one ``drop`` at the eviction
seam, the refcount leak the auditor must find.
"""

from __future__ import annotations

from typing import Iterable

from localai_tpu_torch.ops import kvcache
from localai_tpu_torch.services.faults import FAULTS


class _Entry:
    __slots__ = ("key", "parent", "page", "depth", "tick")

    def __init__(self, key: bytes, parent: bytes, page: int, depth: int,
                 tick: int):
        self.key = key
        self.parent = parent
        self.page = page
        self.depth = depth      # chain position (0 = first page)
        self.tick = tick        # LRU clock at the last touch


class PrefixPageCache:
    """Host-side index of retained pages; the PagePool owns the pages."""

    def __init__(self, scope: bytes, page_size: int):
        self.scope = scope
        self.page_size = page_size
        self._entries: dict = {}
        self._children: dict = {}
        self._tick = 0
        # counters (monotonic)
        self.hits = 0            # admissions served from the index
        self.misses = 0          # index consulted, no usable chain
        self.hit_rows = 0        # prompt rows reused through the index
        self.inserted_pages = 0
        self.evicted_pages = 0
        # the KVAuditor, attached by the engine when kv_audit is not off
        self.audit = None

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def pages_held(self) -> int:
        return len(self._entries)

    def stats(self) -> dict:
        return {"entries": len(self._entries), "hits": self.hits,
                "misses": self.misses, "hit_rows": self.hit_rows,
                "inserted_pages": self.inserted_pages,
                "evicted_pages": self.evicted_pages}

    def pages(self) -> list:
        """The physical pages held, one per entry."""
        return [e.page for e in self._entries.values()]

    def contains(self, key: bytes) -> bool:
        """Membership without an LRU touch (the prefetch planner skips
        links already on the device without promoting them)."""
        return key in self._entries

    def genealogy(self, limit: int = 64) -> list:
        """The chains for /debug/kv: the newest ``limit`` entries as {key,
        parent, page, depth, tick}, keys cut to 8 bytes of hex."""
        items = sorted(self._entries.values(),
                       key=lambda e: (e.tick, e.depth))[-int(limit):]
        return [{"key": e.key[:8].hex(), "parent": e.parent[:8].hex(),
                 "page": e.page, "depth": e.depth, "tick": e.tick}
                for e in items]

    # ---------- the hash chain ----------

    def chain_keys(self, ids) -> Iterable[bytes]:
        """Chain keys of every FULL page of ids, root first."""
        pg = self.page_size
        parent = kvcache.PAGE_HASH_ROOT
        for i in range(len(ids) // pg):
            parent = kvcache.page_chain_hash(parent, ids[i * pg:(i + 1) * pg],
                                             self.scope)
            yield parent

    # ---------- index operations ----------

    def insert(self, pool, slot: int, toks) -> int:
        """Index the slot's committed full pages under their chain keys;
        called BEFORE the pool release drops the slot's references. A key
        already present is touched, not replaced: two slots that prefilled
        the same prefix keep one retained copy. Returns the pages newly
        retained."""
        self._tick += 1
        added = 0
        n_full = min(len(toks) // self.page_size, int(pool.owned[slot]))
        parent = kvcache.PAGE_HASH_ROOT
        for i, key in enumerate(self.chain_keys(toks)):
            if i >= n_full:
                break
            e = self._entries.get(key)
            if e is not None:
                e.tick = self._tick
                parent = key
                continue
            page = int(pool.ptab[slot, i])
            if page >= pool.num_pages or pool.refs[page] <= 0:
                break   # unallocated tail: nothing past it is committed
            pool.hold(page)
            self._entries[key] = _Entry(key, parent, page, i, self._tick)
            self._children.setdefault(parent, set()).add(key)
            if self.audit is not None:
                self.audit.ledger.record("retain", page=page, slot=slot,
                                         key=key)
            added += 1
            parent = key
        self.inserted_pages += added
        return added

    def match(self, ids, max_pages: int) -> list:
        """The longest contiguous chain match over ids' full pages: the
        physical pages root first (maybe none). Every matched entry, and
        so its whole ancestor path, is LRU-touched."""
        self._tick += 1
        pages: list = []
        for key in self.chain_keys(ids):
            if len(pages) >= max_pages:
                break
            e = self._entries.get(key)
            if e is None:
                break
            e.tick = self._tick
            pages.append(e.page)
        return pages

    def evict(self, pool, need_free: int, on_evict=None) -> int:
        """Drop entries LRU-first until the pool has ``need_free`` free
        pages or the index is empty. Ties drop the deepest link first, and
        removal cascades to descendants. Returns the entries dropped.

        ``on_evict(entry)`` is the host tier's handoff: called for every
        removed entry BEFORE its pool reference drops, while the page id
        still names its rows (the engine gathers the victims' pages for
        the offload before anything can reuse them)."""
        if not self._entries or pool.free_pages >= need_free:
            return 0
        victims = sorted(self._entries.values(),
                         key=lambda e: (e.tick, -e.depth))
        dropped = 0
        for e in victims:
            if pool.free_pages >= need_free:
                break
            if e.key not in self._entries:
                continue    # already cascaded away
            dropped += self._remove_tree(pool, e.key, on_evict)
        self.evicted_pages += dropped
        return dropped

    def _remove_tree(self, pool, key: bytes, on_evict=None) -> int:
        n = 0
        stack = [key]
        while stack:
            k = stack.pop()
            e = self._entries.pop(k, None)
            if e is None:
                continue
            stack.extend(self._children.pop(k, ()))
            kids = self._children.get(e.parent)
            if kids is not None:
                kids.discard(k)
                if not kids:
                    del self._children[e.parent]
            if on_evict is not None:
                on_evict(e)
            if self.audit is not None:
                self.audit.ledger.record("evict", page=e.page, key=k)
            # the kv_leak fault: one retention drop skipped at the eviction
            # seam (the page stays referenced, reachable from nothing)
            if not (FAULTS.active and FAULTS.take("kv_leak")):
                pool.drop(e.page)
            n += 1
        return n

    def attach(self, pool, key: bytes, parent: bytes, page: int,
               depth: int) -> bool:
        """Index a page that is already in a table under a known key (a
        link that continues a chain). No-op if the key is present."""
        if key in self._entries:
            return False
        pool.hold(page)
        self._entries[key] = _Entry(key, parent, page, depth, self._tick)
        self._children.setdefault(parent, set()).add(key)
        if self.audit is not None:
            self.audit.ledger.record("retain", page=page, key=key)
        return True

    def clear(self):
        """Forget every entry without touching a pool (for a pool that is
        rebuilt, whose holds die with it). Counters survive."""
        self._entries.clear()
        self._children.clear()

    # ---------- engine-side accounting ----------

    def note_hit(self, rows: int):
        self.hits += 1
        self.hit_rows += int(rows)

    def note_miss(self):
        self.misses += 1


def build_scope(family: str, cfg, page_size: int, cache_dtype) -> bytes:
    """The engine's scope recipe: family, attention geometry, vocabulary,
    rope base, cache dtype and page size — everything that changes what a
    page's rows mean."""
    return kvcache.page_scope(
        page_size, family,
        getattr(cfg, "num_layers", 0), getattr(cfg, "num_kv_heads", 0),
        getattr(cfg, "head_dim_", getattr(cfg, "head_dim", 0)),
        getattr(cfg, "vocab_size", 0),
        getattr(cfg, "rope_theta", 0), str(cache_dtype))
