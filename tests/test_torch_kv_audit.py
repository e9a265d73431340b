"""The port's KV lifecycle ledger and online auditor against the JAX
package's (localai_tpu/services/kv_audit.py and the hooks in paging,
prefix_cache and kv_offload).

Pins: a seeded lifecycle fuzz (as in tests/test_kv_audit.py) drives the
JAX and the port PagePool / PrefixPageCache / HostPageStore, each with a
strict auditor, through the same operations, with a strict audit after
every step: the ledger tails (op, page, slot, key) and the auditors'
snapshots are equal at every step, and both drain to zero. The kv_leak
fault is caught in one pass by both, under the same check name, and
host_store_corrupt by the CRC on both; the structured lifecycle errors
are reported to the auditor before they raise; the host-tier scan finds
tampered byte accounting, children maps and bit rot as the JAX one does.
"""

from __future__ import annotations

import tests.torch_cpu  # noqa: F401  (one torch CPU thread)

import random

import numpy as np
import pytest

from localai_tpu.engine import kv_offload as jko
from localai_tpu.engine import paging as jpg
from localai_tpu.engine import prefix_cache as jpc
from localai_tpu.ops import kvcache as jkv
from localai_tpu.services import faults as jfaults
from localai_tpu.services import kv_audit as jaud
from localai_tpu_torch.engine import kv_offload as tko
from localai_tpu_torch.engine import paging as tpg
from localai_tpu_torch.engine import prefix_cache as tpc
from localai_tpu_torch.ops import kvcache as tkv
from localai_tpu_torch.services import faults as tfaults
from localai_tpu_torch.services import kv_audit as taud

JAX = dict(pg=jpg, pc=jpc, ko=jko, kv=jkv, aud=jaud, faults=jfaults.FAULTS)
PORT = dict(pg=tpg, pc=tpc, ko=tko, kv=tkv, aud=taud, faults=tfaults.FAULTS)


@pytest.fixture(autouse=True)
def _clean_faults():
    for side in (JAX, PORT):
        side["faults"].reset()
    yield
    for side in (JAX, PORT):
        side["faults"].reset()


def _world(m, n_slots=3, ctx=96, pg=16, pages=12, budget_mb=1, mode="strict"):
    scope = m["kv"].page_scope(pg, "kv-audit-unit")
    pool = m["pg"].PagePool(n_slots, ctx, pg, pages)
    pc = m["pc"].PrefixPageCache(scope, pg)
    store = m["ko"].HostPageStore(scope, pg, budget_mb=budget_mb)
    aud = m["aud"].KVAuditor(mode=mode, replica=0)
    pool.audit = pc.audit = store.audit = aud
    return pool, pc, store, aud


def _page(v: float, shape) -> np.ndarray:
    return np.full(shape, v, np.float32)


def _fuzz(m, seed: int, steps: int = 250) -> list:
    """The JAX test's lifecycle fuzz over one package's modules; returns
    per step (ledger tail, auditor snapshot)."""
    rng = random.Random(seed)
    pg = 16
    pool, pc, store, aud = _world(m)
    PoolExhausted = m["pg"].PoolExhausted
    slot_toks: dict = {s: [] for s in range(3)}
    corpus: list = []
    host_keys: list = []
    big = (2, pg, 2, 128)                     # 128 KiB / entry: budget evicts

    def fill_toks(slot):
        t = slot_toks[slot]
        need = int(pool.owned[slot]) * pg
        while len(t) < need:
            t.append(rng.randrange(256))
        del t[need:]

    def op_grow():
        slot = rng.randrange(3)
        if int(pool.owned[slot]) >= pool.max_pages:
            return
        want = rng.randint(int(pool.owned[slot]) + 1, pool.max_pages)
        try:
            pool.ensure(slot, want * pg)
        except PoolExhausted:
            pc.evict(pool, 2)
        fill_toks(slot)

    def op_insert():
        slots = [s for s in range(3) if pool.owned[s] > 0]
        if slots:
            slot = rng.choice(slots)
            pc.insert(pool, slot, slot_toks[slot])
            corpus.append(tuple(slot_toks[slot]))

    def op_release():
        slot = rng.randrange(3)
        keep = rng.randint(0, int(pool.owned[slot]))
        pool.release(slot, keep * pg)
        fill_toks(slot)

    def op_share():
        srcs = [s for s in range(3) if pool.owned[s] > 0]
        dsts = [s for s in range(3) if pool.owned[s] == 0]
        if srcs and dsts:
            src, dst = rng.choice(srcs), rng.choice(dsts)
            rows = pool.share(src, dst, int(pool.owned[src]) * pg)
            slot_toks[dst] = slot_toks[src][:rows]

    def op_match_splice():
        dsts = [s for s in range(3) if pool.owned[s] == 0]
        if corpus and dsts:
            toks = list(rng.choice(corpus))
            pages = pc.match(toks, pool.max_pages)
            if pages:
                dst = rng.choice(dsts)
                rows = pool.splice(dst, pages)
                slot_toks[dst] = toks[:rows]

    def op_cow_clone():
        for slot in rng.sample(range(3), 3):
            n = int(pool.owned[slot])
            shared = [i for i in range(n) if pool.page_refs(slot, i) > 1]
            if shared:
                try:
                    p = pool.alloc_detached()
                except PoolExhausted:
                    pc.evict(pool, 2)
                    return
                pool.replace(slot, rng.choice(shared), p)
                return

    def op_adopt():
        slots = [s for s in range(3) if 0 < pool.owned[s] < pool.max_pages]
        if slots:
            slot = rng.choice(slots)
            try:
                p = pool.alloc_detached()
            except PoolExhausted:
                pc.evict(pool, 2)
                return
            pool.adopt(slot, p)
            fill_toks(slot)

    def op_evict():
        pc.evict(pool, rng.randint(1, 4))

    def op_offload():
        start = rng.randrange(1000)
        p = m["kv"].PAGE_HASH_ROOT
        for i in range(rng.randint(1, 3)):
            key = m["kv"].page_chain_hash(p, [start + i] * 4, store.scope)
            store.put(key, p, i, _page(float(i), big), _page(1.0, big))
            host_keys.append(key)
            p = key

    def op_restore():
        if host_keys:
            if store.get(rng.choice(host_keys)) is not None:
                store.note_restore(1)
            else:
                store.note_miss()

    def op_prefetch():
        store.note_prefetch_issued(rng.randint(1, 3))
        store.note_prefetch_done()

    ops = [op_grow, op_grow, op_insert, op_insert, op_release, op_share,
           op_match_splice, op_cow_clone, op_adopt, op_evict,
           op_offload, op_restore, op_prefetch]
    log = []
    for _ in range(steps):
        rng.choice(ops)()
        aud.run(pool, pcache=pc, hstore=store)   # strict: raises on drift
        log.append((aud.ledger.tail(8), aud.snapshot()))
    for slot in range(3):
        pool.release(slot)
    pc.evict(pool, pool.num_pages)
    assert aud.run(pool, pcache=pc, hstore=store, drained=True) == []
    log.append((aud.ledger.tail(64), aud.snapshot()))
    return log


@pytest.mark.parametrize("seed", [0xC0FFEE, 7, 1234])
def test_lifecycle_fuzz_matches_jax_strict(seed):
    want = _fuzz(JAX, seed)
    got = _fuzz(PORT, seed)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"step {i}"
    snap = got[-1][1]
    assert snap["violations"] == 0 and snap["leaked_pages"] == 0
    assert snap["ledger"]["live_pages"] == 0
    assert snap["ledger"]["live_holds"] == 0
    assert snap["checks"] == 251
    ops = set(snap["ledger"]["counts"])
    assert {"alloc", "free", "hold", "drop", "retain", "evict", "release",
            "share", "clone", "adopt", "offload", "restore", "prefetch",
            "host_evict"} <= ops
    if seed == 0xC0FFEE:
        assert "splice" in ops


def _leak_run(m):
    pool, pc, store, aud = _world(m, n_slots=1, ctx=64, pages=8)
    pool.ensure(0, 32)
    pc.insert(pool, 0, list(range(32)))
    pool.release(0)
    assert aud.run(pool, pcache=pc) == []
    m["faults"].arm("kv_leak", "1", 1)         # one skipped drop
    pc.evict(pool, pool.num_pages)
    with pytest.raises(m["aud"].KVAuditError, match="leak"):
        aud.run(pool, pcache=pc)               # caught in ONE pass
    return aud


def test_kv_leak_caught_in_one_pass_like_jax():
    j, t = _leak_run(JAX), _leak_run(PORT)
    jv = [v["check"] for v in j.last_violations]
    tv = [v["check"] for v in t.last_violations]
    assert tv == jv and "leak" in tv
    assert t.leaked_pages == j.leaked_pages == 1
    assert t.snapshot() == j.snapshot()
    assert t.ledger.tail(64) == j.ledger.tail(64)
    assert tfaults.FAULTS.fired.get("kv_leak") == 1


def test_report_only_counts_and_calls_back():
    out = {}
    for side, m in (("jax", JAX), ("port", PORT)):
        pool, pc, store, aud = _world(m, n_slots=1, ctx=64, pages=8, mode="on")
        seen = []
        aud.on_violation = seen.append
        pool.ensure(0, 16)
        pc.insert(pool, 0, list(range(16)))
        pool.release(0)
        m["faults"].arm("kv_leak", "1", 1)
        pc.evict(pool, pool.num_pages)
        res = aud.run(pool, pcache=pc)            # no raise: report only
        assert seen == res
        out[side] = (res, aud.snapshot())
    assert out["port"] == out["jax"]
    assert [v["check"] for v in out["port"][0]] == ["leak"]


def _corrupt_run(m):
    pool, pc, store, aud = _world(m, n_slots=1, ctx=64, pages=8)
    p = m["kv"].PAGE_HASH_ROOT
    keys = []
    for i in range(3):
        key = m["kv"].page_chain_hash(p, [i] * 4, store.scope)
        store.put(key, p, i, _page(i, (2, 4, 2, 8)), _page(i + 9, (2, 4, 2, 8)))
        keys.append(key)
        p = key
    assert store.get(keys[0]) is not None
    m["faults"].arm("host_store_corrupt", "1", 1)
    assert store.get(keys[1]) is None           # the CRC caught the flip
    st = store.stats()
    assert st["corrupt_dropped"] == 1
    assert st["pages"] == 1                     # keys[1] and its child gone
    assert aud.run(pool, pcache=pc, hstore=store) == []
    return st, aud


def test_host_store_corrupt_caught_by_crc_like_jax():
    (jst, ja), (tst, ta) = _corrupt_run(JAX), _corrupt_run(PORT)
    for k in ("corrupt_dropped", "pages", "evicted_pages", "offloaded_pages"):
        assert tst[k] == jst[k], k
    assert ta.ledger.tail(64) == ja.ledger.tail(64)
    assert tfaults.FAULTS.fired.get("host_store_corrupt") == 1


def test_host_store_corrupt_on_int8_page():
    pool, pc, store, aud = _world(PORT, n_slots=1, ctx=64, pages=8)
    key = tkv.page_chain_hash(tkv.PAGE_HASH_ROOT, [1] * 4, store.scope)
    page = {"q": np.ones((2, 4, 2, 8), np.int8),
            "s": np.ones((2, 4, 2), np.float32)}
    store.put(key, tkv.PAGE_HASH_ROOT, 0, page,
              {k: v.copy() for k, v in page.items()})
    tfaults.FAULTS.arm("host_store_corrupt", "1", 1)
    assert store.get(key) is None and store.stats()["corrupt_dropped"] == 1


@pytest.mark.parametrize("tamper", ["bytes", "children", "crc"])
def test_host_scan_finds_tampering_like_jax(tamper):
    out = {}
    for side, m in (("jax", JAX), ("port", PORT)):
        pool, pc, store, aud = _world(m, n_slots=1, ctx=64, pages=8,
                                      mode="on")
        p = m["kv"].PAGE_HASH_ROOT
        for i in range(3):
            key = m["kv"].page_chain_hash(p, [i] * 4, store.scope)
            store.put(key, p, i, _page(i, (2, 4, 2, 8)),
                      _page(i + 1, (2, 4, 2, 8)))
            p = key
        assert aud.run(pool, pcache=pc, hstore=store) == []
        if tamper == "bytes":
            store._bytes += 7
        elif tamper == "children":
            store._children.clear()
        else:
            e = next(iter(store._entries.values()))
            e.k = e.k.copy()
            e.k.reshape(-1)[0] += 1.0
        res = aud.run(pool, pcache=pc, hstore=store)
        out[side] = sorted(v["check"] for v in res)
    assert out["port"] == out["jax"]
    assert out["port"] and all(c.startswith("host_") for c in out["port"])


@pytest.mark.parametrize("op", ["hold", "drop", "free", "share", "splice",
                                "adopt"])
def test_lifecycle_errors_reported_then_raised(op):
    got = {}
    for side, m in (("jax", JAX), ("port", PORT)):
        pool, pc, store, aud = _world(m, n_slots=2, ctx=64, pages=8, mode="on")
        pool.ensure(0, 16)
        pool.ensure(1, 16)
        with pytest.raises(m["aud"].KVLifecycleError) as ei:
            if op == "hold":
                pool.hold(7)
            elif op == "drop":
                pool.drop(0)
            elif op == "free":
                pool.unref_detached(7)
            elif op == "share":
                pool.share(0, 1, 16)
            elif op == "splice":
                pool.splice(1, [0])
            else:
                pool.release(1)
                pool.adopt(1, 7)
        got[side] = (str(ei.value), [v["check"] for v in aud.last_violations],
                     aud.violations, aud.ledger.tail(4))
    assert got["port"] == got["jax"]
    assert got["port"][1] == ["lifecycle"]
    # the port's paging module still exports the error (its old home)
    assert tpg.KVLifecycleError is taud.KVLifecycleError


def test_off_mode_never_builds_an_auditor():
    with pytest.raises(ValueError, match="off never constructs"):
        taud.KVAuditor(mode="off")
    pool = tpg.PagePool(1, 64, 16, 8)
    assert pool.audit is None
    pool.ensure(0, 32)
    pool.release(0)                           # hooks dissolve into one check
    assert pool.fragmentation() == jpg.PagePool(1, 64, 16, 8).fragmentation()


def test_fragmentation_and_oversubscription_match_jax():
    rng = random.Random(5)
    j, t = jpg.PagePool(4, 128, 16, 20), tpg.PagePool(4, 128, 16, 20)
    for _ in range(60):
        slot, rows = rng.randrange(4), rng.randrange(0, 129)
        grow = rng.random() < 0.5
        for pool in (j, t):
            try:
                if grow:
                    pool.ensure(slot, rows)
                else:
                    pool.release(slot, rows)
            except (jpg.PoolExhausted, tpg.PoolExhausted):
                pass
        assert t.fragmentation() == j.fragmentation()
    assert t.oversubscription == j.oversubscription == 4 * 8 / 20
