"""Host-side page allocator for the paged KV cache (a copy of
localai_tpu/engine/paging.py without the window's ``demote``).

The device holds the page pool and the page table; this module owns the
table's numpy mirror, the FIFO free list, per-page reference counts,
lazy allocation and the copy-on-write sharing decisions:

  * ``share(src, dst, rows)`` points dst's leading entries at src's FULL
    pages covering rows[0:rows] and bumps their counts; no row moves.
    ``splice(dst, pages)`` does the same from an explicit page list (a
    prefix-cache chain whose slot is gone).
  * The first page a request writes is cloned when its count is > 1
    (``cow_page`` finds it, ``alloc_detached`` + ``ops/kvcache.py::
    clone_page`` + ``replace`` or ``adopt`` commit it).
  * ``hold`` / ``drop`` are the prefix cache's retention references: a
    page whose only references are holds is RETAINED — its rows outlive
    every slot table and wait to be spliced into a later request.
  * ``release(slot, keep_rows)`` drops a slot's pages past keep_rows; a
    page returns to the free list when its last reference goes.

Every change to the table sets ``dirty``; the engine copies the mirror
into the one device table before the next pack or burst.

The lifecycle ledger (services/kv_audit.py): with ``kv_audit`` on, the
engine attaches its KVAuditor as ``audit`` and every transition records
into its ledger, each hook behind one ``audit is not None`` check. A
broken rule raises KVLifecycleError (defined in services/kv_audit.py,
re-exported here) after reporting it to the auditor.
"""

from __future__ import annotations

from collections import deque

import numpy as np

from localai_tpu_torch.services.kv_audit import KVLifecycleError


class PoolExhausted(RuntimeError):
    """No free page; the engine reclaims retained prefixes and retries."""


class PagePool:
    def __init__(self, num_slots: int, max_context: int, page_size: int,
                 num_pages: int = 0):
        if max_context % page_size:
            raise ValueError(
                f"max_context {max_context} not a multiple of page_size "
                f"{page_size}")
        self.page_size = page_size
        self.max_pages = max_context // page_size
        self.num_pages = num_pages or num_slots * self.max_pages
        self.num_slots = num_slots
        # sentinel num_pages = unallocated
        self.ptab = np.full((num_slots, self.max_pages), self.num_pages,
                            np.int32)
        self.refs = np.zeros((self.num_pages,), np.int32)
        # references held by the prefix cache (a subset of refs): a page
        # with refs == held > 0 is RETAINED, alive only for reuse
        self.held = np.zeros((self.num_pages,), np.int32)
        self.owned = np.zeros((num_slots,), np.int32)  # table entries in use
        self._free = deque(range(self.num_pages))
        self.dirty = True      # device table snapshot is stale
        # the KVAuditor, attached by the engine when kv_audit is not off
        self.audit = None

    def _fail(self, op: str, detail: str, page: int = -1, slot=None):
        """Report a broken lifecycle rule to the auditor, then raise it."""
        err = KVLifecycleError(op, detail, page=page, slot=slot)
        if self.audit is not None:
            self.audit.lifecycle_violation(err)
        raise err

    # ---------- accounting ----------

    def pages_for(self, rows: int) -> int:
        return -(-int(rows) // self.page_size)

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return self.num_pages - len(self._free)

    @property
    def retained_pages(self) -> int:
        """Pages alive only through prefix-cache holds (reclaimable by
        eviction without touching any slot)."""
        return int(((self.refs > 0) & (self.refs == self.held)).sum())

    @property
    def active_pages(self) -> int:
        """Pages some slot table (or a detached clone) references."""
        return int(((self.refs > 0) & (self.refs > self.held)).sum())

    @property
    def oversubscription(self) -> float:
        """Worst-case logical demand over physical pages: > 1.0 when the
        pool holds fewer than num_slots * max_context rows."""
        return self.num_slots * self.max_pages / float(self.num_pages)

    def fragmentation(self) -> dict:
        """The free list's shape (the memory watermarks' telemetry): free
        pages in HOLES below the highest allocated page id against those
        in the free TAIL of the id space. Pages are interchangeable, so
        holes cost nothing; a hole-heavy free list says the pool has
        churned through its ids, retained-page eviction serving
        admissions."""
        free = len(self._free)
        if free == 0:
            return {"free_pages": 0, "tail_pages": 0, "hole_pages": 0,
                    "ratio": 0.0}
        free_ids = set(self._free)
        tail = 0
        for p in range(self.num_pages - 1, -1, -1):
            if p not in free_ids:
                break
            tail += 1
        holes = free - tail
        return {"free_pages": free, "tail_pages": tail, "hole_pages": holes,
                "ratio": round(holes / float(free), 4)}

    def pages_beyond(self, idle_slots, extra=()) -> int:
        """Pages referenced beyond the prefix cache's holds, the tables of
        ``idle_slots`` and one reference per page in ``extra`` (detached
        pages a caller owns: the host tier's prefetched pages): the
        running requests' pages, plus any reference nothing accounts for
        (a detached page never adopted, a count never dropped). 0 when
        every slot is idle and nothing leaked."""
        known = self.held.copy()
        for s in idle_slots:
            np.add.at(known, self.ptab[s, :int(self.owned[s])], 1)
        np.add.at(known, np.asarray(list(extra), np.int64), 1)
        return int((self.refs > known).sum())

    def slot_rows_capacity(self, slot: int) -> int:
        return int(self.owned[slot]) * self.page_size

    def page_refs(self, slot: int, page_idx: int) -> int:
        p = int(self.ptab[slot, page_idx])
        return int(self.refs[p]) if p < self.num_pages else 0

    # ---------- allocation ----------

    def _alloc(self) -> int:
        if not self._free:
            raise PoolExhausted(
                f"page pool exhausted ({self.num_pages} pages of "
                f"{self.page_size} rows)")
        p = self._free.popleft()
        self.refs[p] = 1
        if self.audit is not None:
            self.audit.ledger.record("alloc", page=p)
        return p

    def alloc_detached(self) -> int:
        """One page owned by no table yet (a copy-on-write clone target);
        hand it to ``replace`` / ``adopt`` or free it with
        ``unref_detached``."""
        return self._alloc()

    def alloc_many(self, n: int) -> list:
        """Up to ``n`` detached pages: as many as the free list gives,
        without raising."""
        out = []
        while len(out) < n and self._free:
            out.append(self._alloc())
        return out

    def unref_detached(self, page: int):
        if self.refs[page] <= 0:
            self._fail("free", "unref of an already-free page", page=page)
        self.refs[page] -= 1
        if self.refs[page] == 0:
            self._free.append(page)
            if self.audit is not None:
                self.audit.ledger.record("free", page=page)

    def ensure(self, slot: int, rows: int) -> bool:
        """Allocate pages so the slot can hold ``rows`` logical rows
        (lazy, page granularity). Returns True if the table changed."""
        need = min(self.pages_for(rows), self.max_pages)
        changed = False
        while self.owned[slot] < need:
            self.ptab[slot, self.owned[slot]] = self._alloc()
            self.owned[slot] += 1
            changed = True
        if changed:
            self.dirty = True
        return changed

    def release(self, slot: int, keep_rows: int = 0):
        """Drop the slot's pages beyond those covering keep_rows."""
        keep = min(self.pages_for(keep_rows), self.max_pages)
        if self.audit is not None and self.owned[slot] > keep:
            self.audit.ledger.record("release", slot=slot)
        while self.owned[slot] > keep:
            self.owned[slot] -= 1
            i = int(self.owned[slot])
            self.unref_detached(int(self.ptab[slot, i]))
            self.ptab[slot, i] = self.num_pages
            self.dirty = True

    # ---------- sharing / copy-on-write ----------

    def share(self, src: int, dst: int, rows: int) -> int:
        """Point dst's leading entries at src's full pages covering
        rows[0:rows]; counts bump, nothing is copied. dst must own no
        pages. Returns the rows shared (a page multiple)."""
        n = min(int(rows) // self.page_size, int(self.owned[src]))
        if self.owned[dst] != 0:
            self._fail("share", "share() into a non-empty slot",
                       slot=(src, dst))
        for i in range(n):
            p = int(self.ptab[src, i])
            self.ptab[dst, i] = p
            self.refs[p] += 1
        self.owned[dst] = n
        if n:
            self.dirty = True
            if self.audit is not None:
                self.audit.ledger.record(
                    "share", page=int(self.ptab[src, 0]), slot=(src, dst))
        return n * self.page_size

    def hold(self, page: int):
        """A prefix-cache retention reference: keeps the page and its rows
        alive after every slot table lets go. Only a referenced page can
        be held (a free page holds nothing worth keeping)."""
        if self.refs[page] <= 0:
            self._fail("hold", "hold() on an unreferenced page", page=page)
        self.refs[page] += 1
        self.held[page] += 1
        if self.audit is not None:
            self.audit.ledger.record("hold", page=page)

    def drop(self, page: int):
        """Release a ``hold`` reference (eviction)."""
        if self.held[page] <= 0:
            self._fail("drop", "drop() without a matching hold()", page=page)
        self.held[page] -= 1
        if self.audit is not None:
            self.audit.ledger.record("drop", page=page)
        self.unref_detached(page)

    def splice(self, dst: int, pages) -> int:
        """Point dst's leading entries at an explicit page list (a prefix
        cache chain) and bump the counts. dst must own no pages. Returns
        the rows spliced (a page multiple)."""
        if self.owned[dst] != 0:
            self._fail("splice", "splice() into a non-empty slot", slot=dst)
        n = min(len(pages), self.max_pages)
        for i in range(n):
            p = int(pages[i])
            if self.refs[p] <= 0:
                self._fail("splice", "splice() of a freed page",
                           page=p, slot=dst)
            self.ptab[dst, i] = p
            self.refs[p] += 1
        self.owned[dst] = n
        if n:
            self.dirty = True
            if self.audit is not None:
                self.audit.ledger.record("splice", page=int(pages[0]),
                                         slot=dst)
        return n * self.page_size

    def adopt(self, slot: int, page: int):
        """Append a detached (just cloned) page to the slot's table."""
        i = int(self.owned[slot])
        if i >= self.max_pages:
            self._fail("adopt", "adopt() into a full table",
                       page=page, slot=slot)
        if self.refs[page] <= 0:
            self._fail("adopt", "adopt() of a freed page",
                       page=page, slot=slot)
        self.ptab[slot, i] = page
        self.owned[slot] = i + 1
        self.dirty = True
        if self.audit is not None:
            self.audit.ledger.record("adopt", page=page, slot=slot)

    def cow_page(self, slot: int, row: int) -> int:
        """Table index of the page holding ``row`` if the slot owns it and
        it is shared (count > 1), so writing the row needs a clone first;
        -1 otherwise."""
        i = int(row) // self.page_size
        if i < self.owned[slot] and self.page_refs(slot, i) > 1:
            return i
        return -1

    def replace(self, slot: int, page_idx: int, new_page: int):
        """Swap a (cloned) page into the slot's table: the copy-on-write
        commit. The old page loses this table's reference."""
        old = int(self.ptab[slot, page_idx])
        self.ptab[slot, page_idx] = new_page
        if self.audit is not None:
            self.audit.ledger.record("clone", page=new_page, slot=slot)
        self.unref_detached(old)
        self.dirty = True
