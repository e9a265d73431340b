"""Host-RAM tier of the paged KV store: offloaded pages and their disk
persistence (counterpart of localai_tpu/engine/kv_offload.py).

The device tier (engine/prefix_cache.py) retains a released chain only
while its pages stay in the device pool; under pool pressure the engine's
``_reclaim_pages`` evicts retained chains LRU-first. With the host tier on
(``EngineConfig.kv_offload``, the JAX default) an evicted page is copied
to host RAM first, and a later request whose prompt continues the chain
past the device pages restores it instead of prefilling it again:

  * ENTRIES are keyed by the same chained block hash as the device tier
    (ops/kvcache.py::page_chain_hash, scoped by model, geometry, cache
    dtype and page size), so one key sequence spans both tiers: device
    pages cover links [0, d), host entries continue [d, h). Removal
    cascades to descendants in both tiers, so they never interleave.
  * CONTENT is the page's device representation as numpy: [L, pg, KV,
    hd] rows, or {"q": int8 rows, "s": float32 scales [L, pg, KV]} for
    int8 pages (never requantized), so a restore is a byte-exact upload.
    numpy has no bfloat16: bf16 pages live here as their uint16 bit
    patterns (a uint16 page IS a bf16 page; the port stores no other
    16-bit pages). An offloaded page's arrays are views of the pinned
    host tensors its copy from the card landed in (``src``), so neither
    the offload nor the restore copies it on the host.
  * INTEGRITY: a CRC32 over the page's bytes is taken at insert and
    checked at EVERY read (``get_local``). A mismatch drops the entry and
    its subtree and reads as a miss, so the request prefills again.
  * DRAFT PLANES (``dk`` / ``dv``, with a draft model whose paged cache
    rides the main page table): the draft's rows of the same page id, in
    the same representation, with a CRC of their own (``dcrc``). They
    are an acceleration, not correctness: a corrupt draft plane decays
    the entry to target-only (a warning, its bytes taken off the budget)
    and its target rows still restore; a later put of the same key
    re-attaches missing planes. An entry without them restores its
    target rows and leaves the draft rows cold.
  * The LRU cascades device -> host -> gone: this store evicts its own
    entries LRU-first (ties: the deepest link) past ``budget_mb << 20``
    bytes.
  * PERSISTENCE: ``save`` writes one .npz in the JAX store's format
    (version, scope, page_size, keys, parents, depths, quant, kq / ks /
    vq / vs or kd / vd, dtype; bf16 as a uint16 view named "bfloat16"),
    so either package loads the other's file. Like the JAX ``save`` it
    writes no draft planes: a reloaded entry restores target rows only. ``load`` ignores, never
    crashes on, a wrong version, scope or page size, or an unreadable or
    truncated file.

``PrefetchPipeline`` is the JAX one as it is: the engine's prefetch tick
restores the host links a QUEUED request will need into detached device
pages ahead of its admission, which claims them.

Restore staging. The JAX store's ``RestoreStager`` double-buffers the
upload's host arrays. Here there is no staging: a restore copies each
page from its own pinned tensor (``src``), a block of PyTorch's caching
host allocator (engine/transfer.py::pages_to_device; a page loaded from
a file is pinned first, as engine/transfer.py::to_device pins): the
allocator records an event on the block when the non-blocking copy is
queued and hands it out again only after that copy ran, even if the
page left this store meanwhile. That holds for any number of restores in
flight in one tick, where two alternating buffers without events do
not.

Left out of this port, with the ROADMAP Queue 1 item that brings them:
the shared mode's owners (``map_key`` / ``unmap_key`` /
``evict_blocked``) and the federated peer tier (item 11, scale-out).
``contains_any`` is ``contains`` (no peer tier).

The lifecycle ledger (services/kv_audit.py): with ``kv_audit`` on,
``audit`` is the engine's KVAuditor, and the store records "offload",
"restore", "prefetch" and "host_evict"; ``audit_scan`` is its invariant
scan of this tier. The ``host_store_corrupt`` fault (services/faults.py)
flips one byte of the entry ``get`` reads, which the CRC check must
catch.

Thread safety: the engine thread reads entries while the offload worker
inserts them; every public method of HostPageStore locks.
``PrefetchPipeline`` is the engine thread's alone.
"""

from __future__ import annotations

import logging
import os
import threading
import zlib

import numpy as np

from localai_tpu_torch.services.faults import FAULTS

log = logging.getLogger(__name__)

STORE_VERSION = 1


def _to_savable(a: np.ndarray):
    """(.npy-safe array, dtype name): bf16 pages are already uint16."""
    if a.dtype == np.uint16:
        return a, "bfloat16"
    return a, str(a.dtype)


def _from_savable(a: np.ndarray, name: str) -> np.ndarray:
    if name == "bfloat16":
        return a.view(np.uint16)
    return a.astype(name, copy=False) if str(a.dtype) != name else a


def _leaf_bytes(rows) -> int:
    if isinstance(rows, dict):
        return sum(int(v.nbytes) for v in rows.values())
    return int(rows.nbytes)


def _page_crc(k, v) -> int:
    """CRC32 over both pages' leaf bytes, in a stable leaf order: a
    restore is byte-exact or does not happen (a prefill is always
    right)."""
    crc = 0
    for rows in (k, v):
        leaves = rows.values() if isinstance(rows, dict) else (rows,)
        for a in leaves:
            crc = zlib.crc32(np.ascontiguousarray(a).data, crc)
    return crc


class _HostEntry:
    __slots__ = ("key", "parent", "depth", "tick", "k", "v", "nbytes", "crc",
                 "src", "dk", "dv", "dcrc", "dsrc")

    def __init__(self, key: bytes, parent: bytes, depth: int, tick: int, k, v,
                 src=None, dk=None, dv=None, dsrc=None):
        self.key = key
        self.parent = parent
        self.depth = depth
        self.tick = tick
        # one page of K / V rows in the device representation:
        # [L, page_size, KV, hd] arrays, or {"q", "s"} dicts when int8
        self.k = k
        self.v = v
        self.nbytes = _leaf_bytes(k) + _leaf_bytes(v)
        self.crc = _page_crc(k, v)
        # the (k, v) host tensors k and v are views of (pinned on the
        # card), kept so a restore copies from them; None for pages put
        # as plain arrays (a loaded file)
        self.src = src
        self.dk = self.dv = self.dsrc = None
        self.dcrc = 0
        if dk is not None:
            self.attach_draft(dk, dv, dsrc)

    def attach_draft(self, dk, dv, dsrc=None) -> int:
        """Attach the draft planes (module doc) with their CRC; returns the
        bytes they add. ``dk`` is set last: a reader that sees it sees the
        rest (the engine thread reads entries without the lock)."""
        self.dcrc = _page_crc(dk, dv)
        self.dsrc, self.dv = dsrc, dv
        self.dk = dk
        extra = _leaf_bytes(dk) + _leaf_bytes(dv)
        self.nbytes += extra
        return extra

    def drop_draft(self) -> int:
        """Detach the draft planes; returns the bytes they held."""
        extra = _leaf_bytes(self.dk) + _leaf_bytes(self.dv)
        self.dk = None
        self.dv = self.dsrc = None
        self.dcrc = 0
        self.nbytes -= extra
        return extra


class PrefetchPipeline:
    """Prefetch-ahead bookkeeping (the JAX engine's): the engine's
    prefetch tick uploads the host-tier links a queued request's
    admission will restore into DETACHED device pages (refs == 1, owned
    here) ahead of the admission, which claims the contiguous prefix of
    its continuation from here; what the prediction got wrong ages out
    and is counted WASTED.

    Engine thread only, no locking. The pool owns the pages (each
    registered page carries one detached reference that transfers on
    ``claim`` or is unref'd by the caller on expiry), the HostPageStore
    the counters."""

    __slots__ = ("pages", "seen_rids", "tick", "max_age")

    def __init__(self, max_age: int = 64):
        # chain key -> [page, parent, depth, tick_registered]
        self.pages: dict = {}
        # request ids a prefetch pass has scanned: a synchronous restore
        # for one of these is a late prefetch
        self.seen_rids: set = set()
        self.tick = 0
        self.max_age = int(max_age)

    def __len__(self) -> int:
        return len(self.pages)

    def register(self, key: bytes, parent: bytes, page: int, depth: int):
        """Track one restored detached page under its chain key."""
        self.pages[key] = [int(page), parent, int(depth), self.tick]

    def claim(self, key: bytes):
        """Take a prefetched page for admission (its detached reference
        goes to the caller); None if it was never prefetched or is gone."""
        return self.pages.pop(key, None)

    def expire(self) -> list:
        """Pop entries older than max_age ticks: [(key, [page, parent,
        depth, tick]), ...]; the caller unrefs each page and counts it
        wasted."""
        cutoff = self.tick - self.max_age
        old = [k for k, rec in self.pages.items() if rec[3] < cutoff]
        return [(k, self.pages.pop(k)) for k in old]

    def drain(self) -> list:
        """Pop everything (pool-pressure raid, failure)."""
        out = list(self.pages.items())
        self.pages.clear()
        self.seen_rids.clear()
        return out


class HostPageStore:
    """Byte-budgeted host-RAM index of offloaded pages."""

    def __init__(self, scope: bytes, page_size: int, budget_mb: int):
        self.scope = scope
        self.page_size = page_size
        self.budget_bytes = max(1, int(budget_mb)) << 20
        self._lock = threading.Lock()
        self._entries: dict = {}
        self._children: dict = {}
        self._tick = 0
        self._bytes = 0
        # monotonic totals
        self.offloaded_pages = 0
        self.offloaded_bytes = 0
        self.restored_pages = 0
        self.restores = 0        # admissions that restored from this tier
        self.hits = 0            # = restores
        self.misses = 0          # tier consulted, chain not present
        self.evicted_pages = 0   # host -> gone (budget, CRC, cascade)
        self.corrupt_dropped = 0  # CRC mismatch at a read: tree dropped
        self.prefetch_issued = 0   # pages restored ahead of need
        self.prefetch_hits = 0     # prefetched pages claimed by admission
        self.prefetch_late = 0     # sync restores the pipeline predicted
        self.prefetch_wasted = 0   # prefetched pages reclaimed unclaimed
        self.prefetch_inflight = 0  # prefetch uploads not yet landed
        # the KVAuditor, attached by the engine when kv_audit is not off
        self.audit = None

    # ---------- introspection ----------

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    @property
    def pages(self) -> int:
        with self._lock:
            return len(self._entries)

    @property
    def bytes_used(self) -> int:
        with self._lock:
            return self._bytes

    def stats(self) -> dict:
        """The JAX store's keys, less the shared mode's."""
        with self._lock:
            return {
                "pages": len(self._entries),
                "bytes": self._bytes,
                "budget_bytes": self.budget_bytes,
                "offloaded_pages": self.offloaded_pages,
                "offloaded_bytes": self.offloaded_bytes,
                "restored_pages": self.restored_pages,
                "restores": self.restores,
                "hits": self.hits,
                "misses": self.misses,
                "evicted_pages": self.evicted_pages,
                "corrupt_dropped": self.corrupt_dropped,
                "prefetch_issued": self.prefetch_issued,
                "prefetch_hits": self.prefetch_hits,
                "prefetch_late": self.prefetch_late,
                "prefetch_wasted": self.prefetch_wasted,
                "prefetch_inflight": self.prefetch_inflight,
            }

    # ---------- store operations ----------

    def put(self, key: bytes, parent: bytes, depth: int, k, v,
            src=None, dk=None, dv=None, dsrc=None) -> bool:
        """Insert one offloaded page (``src``: the host tensors k and v are
        views of, kept with the entry; ``dk`` / ``dv`` / ``dsrc``: the
        draft planes and their tensors, or None). A present key is
        touched, not replaced (same key, same content), but draft planes
        it lacks are attached; a page over the whole budget is refused.
        Evicts LRU-first past the budget. True if inserted."""
        with self._lock:
            self._tick += 1
            e = self._entries.get(key)
            if e is not None:
                e.tick = self._tick
                if dk is not None and e.dk is None:
                    self._bytes += e.attach_draft(dk, dv, dsrc)
                    self._evict_to_budget_locked()
                return False
            e = _HostEntry(key, parent, depth, self._tick, k, v, src, dk, dv,
                           dsrc)
            if e.nbytes > self.budget_bytes:
                return False
            self._entries[key] = e
            self._children.setdefault(parent, set()).add(key)
            self._bytes += e.nbytes
            self.offloaded_pages += 1
            self.offloaded_bytes += e.nbytes
            if self.audit is not None:
                self.audit.ledger.record("offload", key=key)
            self._evict_to_budget_locked()
            return True

    def get(self, key: bytes):
        """The entry for a chain key (LRU-touched, CRC-checked), or None:
        the host half of the two-tier chain walk (no peer tier here)."""
        return self.get_local(key)

    def get_local(self, key: bytes):
        """LRU-touched read whose page CRC is verified on every call: a
        corrupted entry and its subtree are dropped and it reads as a
        miss."""
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                return None
            if FAULTS.active and FAULTS.take("host_store_corrupt") is not None:
                leaf = next(iter(e.k.values())) if isinstance(e.k, dict) \
                    else e.k
                flat = np.ascontiguousarray(leaf).view(np.uint8).reshape(-1)
                flat[0] ^= 0xFF
                if isinstance(e.k, dict):
                    e.k[next(iter(e.k))] = flat.view(leaf.dtype).reshape(
                        leaf.shape)
                else:
                    e.k = flat.view(leaf.dtype).reshape(leaf.shape)
            if _page_crc(e.k, e.v) != e.crc:
                log.warning("kv host store: CRC mismatch on page depth=%d — "
                            "dropping subtree, forcing re-prefill", e.depth)
                self._remove_tree_locked(key)
                self.corrupt_dropped += 1
                return None
            if e.dk is not None and _page_crc(e.dk, e.dv) != e.dcrc:
                # the draft planes only speed speculation up: the entry
                # decays to target-only and its target rows still restore
                log.warning("kv host store: draft CRC mismatch on page "
                            "depth=%d — dropping the draft planes only",
                            e.depth)
                self._bytes -= e.drop_draft()
            self._tick += 1
            e.tick = self._tick
            return e

    def contains(self, key: bytes) -> bool:
        """Membership without an LRU touch or a CRC."""
        with self._lock:
            return key in self._entries

    def contains_any(self, key: bytes) -> bool:
        """``contains``: the JAX name of the probe that also asks the peer
        tier, which this port does not have."""
        return self.contains(key)

    def note_restore(self, n_pages: int):
        with self._lock:
            self.restores += 1
            self.hits += 1
            self.restored_pages += int(n_pages)
            if self.audit is not None:
                self.audit.ledger.record("restore")

    def note_miss(self):
        with self._lock:
            self.misses += 1

    def note_prefetch_issued(self, n_pages: int):
        with self._lock:
            self.prefetch_issued += int(n_pages)
            self.prefetch_inflight += 1
            if self.audit is not None:
                self.audit.ledger.record("prefetch")

    def note_prefetch_done(self):
        """One prefetch upload landed."""
        with self._lock:
            self.prefetch_inflight = max(0, self.prefetch_inflight - 1)

    def note_prefetch_hit(self, n_pages: int):
        with self._lock:
            self.prefetch_hits += int(n_pages)

    def note_prefetch_late(self, n: int = 1):
        with self._lock:
            self.prefetch_late += int(n)

    def note_prefetch_wasted(self, n_pages: int):
        with self._lock:
            self.prefetch_wasted += int(n_pages)

    def _evict_to_budget_locked(self):
        if self._bytes <= self.budget_bytes:
            return
        victims = sorted(self._entries.values(),
                         key=lambda e: (e.tick, -e.depth))
        for e in victims:
            if self._bytes <= self.budget_bytes:
                return
            if e.key in self._entries:
                self._remove_tree_locked(e.key)

    def _remove_tree_locked(self, key: bytes) -> int:
        """Remove an entry and every descendant (an orphan is unreachable:
        the chain walk is root-down). host -> gone."""
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
            self._bytes -= e.nbytes
            self.evicted_pages += 1
            if self.audit is not None:
                self.audit.ledger.record("host_evict", key=k)
            n += 1
        return n

    def audit_scan(self, sample_crc: int = 4, rng=None) -> list:
        """The KV auditor's scan of this tier (the JAX store's, without
        the shared mode's mapped keys), under the lock:

        * host_bytes: the running byte total matches the summed entry
          sizes, and each entry's nbytes matches its leaves (draft planes
          included);
        * host_children: the parent -> children map and the entries'
          parent links agree both ways (an absent parent is legal: an
          offload can land a child whose parent was evicted);
        * host_crc: the CRC of up to ``sample_crc`` randomly sampled
          entries is recomputed, the draft planes' too (bit rot in
          retained host pages).

        Violations are ``{"check", "detail"}`` dicts; [] = clean."""
        out = []
        with self._lock:
            total = 0
            for key, e in self._entries.items():
                nb = _leaf_bytes(e.k) + _leaf_bytes(e.v)
                if e.dk is not None:
                    nb += _leaf_bytes(e.dk) + _leaf_bytes(e.dv)
                if nb != e.nbytes:
                    out.append({"check": "host_bytes",
                                "detail": f"entry {key[:8].hex()} nbytes "
                                          f"{e.nbytes} != plane sum {nb}"})
                total += e.nbytes
                kids = self._children.get(e.parent)
                if kids is None or key not in kids:
                    out.append({"check": "host_children",
                                "detail": f"entry {key[:8].hex()} missing "
                                          f"from parent "
                                          f"{e.parent[:8].hex()} kid set"})
            if total != self._bytes:
                out.append({"check": "host_bytes",
                            "detail": f"byte accounting drift: running "
                                      f"{self._bytes} != summed {total} "
                                      f"over {len(self._entries)} entries"})
            for parent, kids in self._children.items():
                for c in kids:
                    e = self._entries.get(c)
                    if e is None:
                        out.append({"check": "host_children",
                                    "detail": f"kid set of "
                                              f"{parent[:8].hex()} names "
                                              f"absent entry "
                                              f"{c[:8].hex()}"})
                    elif e.parent != parent:
                        out.append({"check": "host_children",
                                    "detail": f"entry {c[:8].hex()} parent "
                                              f"link disagrees with kid "
                                              f"set of {parent[:8].hex()}"})
            ns = min(int(sample_crc), len(self._entries))
            if ns > 0:
                rest = list(self._entries)
                if rng is not None and len(rest) > ns:
                    idx = rng.choice(len(rest), size=ns, replace=False)
                    rest = [rest[int(i)] for i in idx]
                for key in rest[:ns]:
                    e = self._entries[key]
                    if _page_crc(e.k, e.v) != e.crc:
                        out.append({"check": "host_crc",
                                    "detail": f"retained entry "
                                              f"{key[:8].hex()} failed CRC "
                                              f"spot-check"})
                    elif e.dk is not None and _page_crc(e.dk, e.dv) != e.dcrc:
                        out.append({"check": "host_crc",
                                    "detail": f"draft planes of "
                                              f"{key[:8].hex()} failed CRC "
                                              f"spot-check"})
        return out

    def clear(self):
        with self._lock:
            self._entries.clear()
            self._children.clear()
            self._bytes = 0

    # ---------- disk persistence ----------

    def save(self, path: str) -> bool:
        """Write the store atomically for the next engine's ``load``,
        entries in LRU order (load replays the recency ranking). An empty
        store removes a stale file and writes none."""
        with self._lock:
            entries = sorted(self._entries.values(), key=lambda e: e.tick)
        if not entries:
            try:
                if os.path.exists(path):
                    os.remove(path)
            except OSError:
                pass
            return False
        quant = isinstance(entries[0].k, dict)
        payload = {
            "version": np.int32(STORE_VERSION),
            "scope": np.frombuffer(self.scope, np.uint8),
            "page_size": np.int32(self.page_size),
            "keys": np.stack([np.frombuffer(e.key, np.uint8) for e in entries]),
            "parents": np.stack([np.frombuffer(e.parent, np.uint8)
                                 for e in entries]),
            "depths": np.asarray([e.depth for e in entries], np.int32),
            "quant": np.int32(1 if quant else 0),
        }
        if quant:
            payload["kq"] = np.stack([e.k["q"] for e in entries])
            payload["ks"] = np.stack([e.k["s"] for e in entries])
            payload["vq"] = np.stack([e.v["q"] for e in entries])
            payload["vs"] = np.stack([e.v["s"] for e in entries])
            payload["dtype"] = np.asarray("int8")
        else:
            karr, kname = _to_savable(np.stack([e.k for e in entries]))
            varr, _ = _to_savable(np.stack([e.v for e in entries]))
            payload["kd"] = karr
            payload["vd"] = varr
            payload["dtype"] = np.asarray(kname)
        tmp = path + ".tmp"
        try:
            with open(tmp, "wb") as f:
                np.savez(f, **payload)
            os.replace(tmp, path)
            return True
        except OSError:
            log.exception("kv host store save failed: %s", path)
            return False

    def load(self, path: str) -> int:
        """Reload a saved store; any defect (unreadable, truncated, wrong
        version, scope or page size) ignores the file. Returns the entries
        loaded, which do not count as this process's offloads."""
        if not path or not os.path.exists(path):
            return 0
        try:
            with np.load(path, allow_pickle=False) as data:
                if int(data["version"]) != STORE_VERSION:
                    log.warning("kv host store %s: version %s != %s, ignoring",
                                path, int(data["version"]), STORE_VERSION)
                    return 0
                if (bytes(data["scope"].tobytes()) != self.scope
                        or int(data["page_size"]) != self.page_size):
                    log.warning("kv host store %s: scope/page-size mismatch "
                                "(another model or layout), ignoring", path)
                    return 0
                keys, parents = data["keys"], data["parents"]
                depths = data["depths"]
                quant = bool(int(data["quant"]))
                if quant:
                    kq, ks, vq, vs = (data["kq"], data["ks"], data["vq"],
                                      data["vs"])
                else:
                    name = str(data["dtype"])
                    kd = _from_savable(data["kd"], name)
                    vd = _from_savable(data["vd"], name)
        except Exception:     # any unreadable file is ignored, never fatal
            log.exception("kv host store %s unreadable, ignoring", path)
            return 0
        n = loaded_bytes = 0
        for i in range(keys.shape[0]):
            if quant:
                k = {"q": kq[i], "s": ks[i]}
                v = {"q": vq[i], "s": vs[i]}
            else:
                k, v = kd[i], vd[i]
            if self.put(bytes(keys[i].tobytes()), bytes(parents[i].tobytes()),
                        int(depths[i]), k, v):
                n += 1
                loaded_bytes += _leaf_bytes(k) + _leaf_bytes(v)
        with self._lock:
            self.offloaded_pages = max(0, self.offloaded_pages - n)
            self.offloaded_bytes = max(0, self.offloaded_bytes - loaded_bytes)
        return n
