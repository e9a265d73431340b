"""The KV lifecycle ledger and the online invariant auditor (a copy of
localai_tpu/services/kv_audit.py).

The paged KV cache (engine/paging.py's page pool, engine/prefix_cache.py's
cross-release prefix cache, engine/kv_offload.py's host tier) keeps its
lifecycle rules as reference counts. This module makes them observable
and checked:

* ``KVLedger``: a bounded ring of compact per-page transition records
  (alloc / free / share / clone / hold / drop / splice / release / retain
  / evict / offload / restore / host_evict / adopt / prefetch), with
  counters per transition and running live-page / live-hold balances.
  Fed by hooks in the KV modules, each behind one ``audit is not None``
  check, so ``kv_audit="off"`` builds nothing and costs one check per
  hook (as ``trace=False`` does).

* ``KVAuditor``: O(num_pages) numpy scans, run by the engine on its
  0.5 s housekeeping cadence, on the engine thread between ticks. The
  families: CONSERVATION (free + in use == num_pages, refs >= held, every
  page a table names has refs > 0, owned counts match the table), LEAK
  FREEDOM (no referenced page outside every slot table, the prefix cache
  and the caller's declared extras), LEDGER BALANCE (the running balances
  match the pool), the HOST TIER (byte accounting matches the entries,
  parent and child links agree, sampled CRC spot-checks; scanned inside
  HostPageStore.audit_scan under its lock), and a POST-DRAIN check
  (everything free, every hold dropped, the ledger balanced to zero).

Modes: ``off`` (no auditor, no hook fires), ``on`` (report only:
counters, ``kv_audit_violation`` events and a flight dump; the default),
``strict`` (raises ``KVAuditError``; for tests).

The host tier's offload worker thread records its ``offload`` entries
from its own thread; those change no balance the scan checks (only the
engine thread allocates, frees, holds and drops pages), and the scan of
the host store takes the store's lock.

Violations are dicts ``{"check", "detail", ...}``, so they go as they
are into events, ``/debug/kv`` and flight dumps.
"""

from __future__ import annotations

import threading
from collections import deque

import numpy as np

#: every transition the ledger understands (the JAX package's set; the
#: port's hooks record those of its modules: alloc, free, share, clone,
#: hold, drop, splice, release, retain, evict, offload, restore,
#: host_evict, adopt, prefetch)
TRANSITIONS = ("alloc", "free", "share", "clone", "hold", "drop",
               "splice", "release", "retain", "evict", "offload",
               "restore", "host_evict", "adopt", "migrate", "reset",
               "demote", "compress", "prefetch",
               "stream_in", "stream_out", "disagg")


class KVLifecycleError(RuntimeError):
    """A page lifecycle rule was broken (hold on a free page, splice of
    a freed page, share into a non-empty slot, ...).

    Raised unconditionally by engine/paging.py, so it survives
    ``python -O``; it carries the op / page / slot, so the auditor can
    record the violation before the raise propagates."""

    def __init__(self, op: str, detail: str, page: int = -1, slot=None):
        super().__init__(
            f"kv lifecycle: {op}: {detail} (page={page}, slot={slot})")
        self.op = op
        self.detail = detail
        self.page = int(page)
        self.slot = slot


class KVAuditError(RuntimeError):
    """Strict mode: an invariant scan found violations."""


class KVLedger:
    """Bounded per-page lifecycle ledger: a ring of compact tuples
    ``(seq, op, page, slot, key8, rid)`` plus per-transition counters
    and running balances. record() is the hot-path hook target — one
    counter bump and one deque append, no allocation beyond the tuple;
    callers gate on ``audit is not None`` so off-mode pays nothing."""

    __slots__ = ("ring", "counts", "seq", "replica",
                 "live_pages", "live_holds")

    def __init__(self, size: int = 2048, replica: int = -1):
        self.ring = deque(maxlen=max(64, int(size)))
        self.counts: dict = {}
        self.seq = 0
        self.replica = replica
        self.live_pages = 0     # alloc minus free (== pages_in_use)
        self.live_holds = 0     # hold minus drop (== held.sum())

    def record(self, op: str, page: int = -1, slot=-1,
               key: bytes = b"", rid: str = ""):
        self.seq += 1
        self.counts[op] = self.counts.get(op, 0) + 1
        if op == "alloc":
            self.live_pages += 1
        elif op == "free":
            self.live_pages -= 1
        elif op == "hold":
            self.live_holds += 1
        elif op == "drop":
            self.live_holds -= 1
        self.ring.append((self.seq, op, int(page), slot,
                          key[:8].hex() if key else "", rid))

    def rebase(self):
        """Zero the running balances (device-state reset rebuilt the
        pool: every page is free again, every hold is gone). Totals and
        the ring survive — the reset itself is a ledger event."""
        self.live_pages = 0
        self.live_holds = 0
        self.record("reset")

    def tail(self, n: int = 64) -> list:
        items = list(self.ring)
        return [{"seq": s, "op": op, "page": p, "slot": str(sl),
                 "key": k, "rid": r}
                for (s, op, p, sl, k, r) in items[-int(n):]]

    def snapshot(self) -> dict:
        return {"events_total": self.seq, "live_pages": self.live_pages,
                "live_holds": self.live_holds, "counts": dict(self.counts)}


class KVAuditor:
    """Online invariant auditor over one replica's KV tiers. Constructed
    only when ``kv_audit != off``; the engine wires ``on_violation`` to
    emit the ``kv_audit_violation`` event and trigger the flight
    recorder with the ledger tail attached."""

    def __init__(self, mode: str = "on", replica: int = -1,
                 ledger_size: int = 2048, sample_crc: int = 4,
                 seed: int = 0):
        if mode not in ("on", "strict"):
            raise ValueError(f"kv_audit mode must be on|strict, got {mode!r}"
                             " (off never constructs an auditor)")
        self.mode = mode
        self.replica = replica
        self.ledger = KVLedger(size=ledger_size, replica=replica)
        self.checks = 0
        self.violations = 0
        self.leaked_pages = 0           # orphan count from the last scan
        self.sample_crc = int(sample_crc)
        self.on_violation = None
        self.last_violations: deque = deque(maxlen=16)
        self._rng = np.random.default_rng(seed)
        self._lock = threading.Lock()

    # ---------------- reporting ----------------

    def _report(self, violations: list):
        if not violations:
            return
        with self._lock:
            self.violations += len(violations)
            self.last_violations.extend(violations)
        cb = self.on_violation
        if cb is not None:
            for v in violations:
                try:
                    cb(v)
                except Exception:
                    pass        # telemetry, never a serving dependency
        if self.mode == "strict":
            raise KVAuditError("; ".join(
                f"[{v.get('check')}] {v.get('detail')}" for v in violations))

    def lifecycle_violation(self, err: KVLifecycleError):
        """paging.py reports a broken lifecycle rule here right before
        raising it — the raise (not strict mode) is the enforcement, the
        report is the observability."""
        self.ledger.record("violation", page=err.page, slot=err.slot)
        v = {"check": "lifecycle", "detail": str(err), "op": err.op,
             "page": err.page, "replica": self.replica}
        with self._lock:
            self.violations += 1
            self.last_violations.append(v)
        cb = self.on_violation
        if cb is not None:
            try:
                cb(v)
            except Exception:
                pass

    # ---------------- invariant families ----------------

    def check_pool(self, pool, pcache=None, extra_pages=None,
                   drained: bool = False) -> list:
        """Conservation + table consistency + leak freedom + ledger
        balance, O(num_pages) numpy over the pool's host mirrors. Run
        from the engine-loop thread (or with the engine quiesced) so the
        mirrors are not mid-mutation."""
        out = []
        refs, held = pool.refs, pool.held
        n = int(pool.num_pages)
        n_free = len(pool._free)
        in_use = int(np.count_nonzero(refs > 0))
        if n_free + in_use != n:
            out.append({"check": "conservation",
                        "detail": f"free({n_free}) + in_use({in_use}) "
                                  f"!= num_pages({n})"})
        if n_free:
            free = np.fromiter(pool._free, dtype=np.int64, count=n_free)
            bad = free[refs[free] != 0]
            if bad.size:
                out.append({"check": "conservation",
                            "detail": f"{bad.size} free-list pages still "
                                      f"referenced: {bad[:8].tolist()}"})
        over = np.flatnonzero(held > refs)
        if over.size:
            out.append({"check": "conservation",
                        "detail": f"held > refs on {over.size} pages: "
                                  f"{over[:8].tolist()}"})
        mask = pool.ptab != n
        pages = pool.ptab[mask]
        if pages.size:
            freed = pages[refs[pages] <= 0]
            if freed.size:
                out.append({"check": "table",
                            "detail": f"slot tables reference {freed.size} "
                                      f"freed pages: "
                                      f"{freed[:8].tolist()}"})
        owned_counts = mask.sum(axis=1)
        if np.any(owned_counts != pool.owned):
            bad_slots = np.flatnonzero(
                owned_counts != pool.owned)[:8].tolist()
            out.append({"check": "table",
                        "detail": f"owned[] disagrees with the table on "
                                  f"slots {bad_slots}"})
        # leak freedom: every referenced page must be reachable from a
        # slot table, a prefix-cache hold, or a caller-declared extra
        live = np.flatnonzero(refs > 0)
        accounted = set(pages.tolist())
        if pcache is not None:
            accounted.update(pcache.pages())
        if extra_pages:
            accounted.update(int(p) for p in extra_pages)
        orphans = [int(p) for p in live if int(p) not in accounted]
        self.leaked_pages = len(orphans)
        if orphans:
            out.append({"check": "leak",
                        "detail": f"{len(orphans)} referenced pages "
                                  f"reachable from no table/cache: "
                                  f"{orphans[:8]}",
                        "leaked_pages": len(orphans)})
        led = self.ledger
        if led.live_pages != in_use:
            out.append({"check": "ledger",
                        "detail": f"ledger live_pages({led.live_pages}) "
                                  f"!= pool in_use({in_use})"})
        held_sum = int(held.sum())
        if led.live_holds != held_sum:
            out.append({"check": "ledger",
                        "detail": f"ledger live_holds({led.live_holds}) "
                                  f"!= pool held({held_sum})"})
        if drained:
            if in_use or held_sum:
                out.append({"check": "drain",
                            "detail": f"post-drain leak: in_use={in_use} "
                                      f"held={held_sum}",
                            "leaked_pages": in_use})
                self.leaked_pages = max(self.leaked_pages, in_use)
            if pcache is not None and len(pcache) != 0:
                out.append({"check": "drain",
                            "detail": f"post-drain: prefix cache still "
                                      f"holds {len(pcache)} entries"})
        for v in out:
            v.setdefault("replica", self.replica)
        return out

    def check_host(self, store) -> list:
        """The host tier's families + sampled CRC, delegated
        to HostPageStore.audit_scan (the scan needs the store lock)."""
        try:
            out = store.audit_scan(sample_crc=self.sample_crc,
                                   rng=self._rng)
        except Exception as e:   # never let telemetry kill the loop
            out = [{"check": "host",
                    "detail": f"audit_scan failed: "
                              f"{type(e).__name__}: {e}"}]
        for v in out:
            v.setdefault("replica", self.replica)
        return out

    def run(self, pool, pcache=None, hstore=None, extra_pages=None,
            drained: bool = False) -> list:
        """One full audit pass; returns (and reports) the violations."""
        with self._lock:
            self.checks += 1
        out = self.check_pool(pool, pcache=pcache, extra_pages=extra_pages,
                              drained=drained)
        if hstore is not None:
            out.extend(self.check_host(hstore))
        self._report(out)
        return out

    def snapshot(self) -> dict:
        with self._lock:
            return {"mode": self.mode, "checks": self.checks,
                    "violations": self.violations,
                    "leaked_pages": self.leaked_pages,
                    "ledger_events": self.ledger.seq,
                    "ledger": self.ledger.snapshot(),
                    "last_violations": list(self.last_violations)}
