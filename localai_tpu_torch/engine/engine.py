"""The serving engine: continuous batching over the KV cache (counterpart
of localai_tpu/engine/engine.py, the llama path).

What this slice keeps of the JAX engine, with the same knob names:

  * slots and a host engine thread that owns every CUDA tensor (HTTP
    handler threads only put requests on a queue and read their output
    queues);
  * the KV layout (``kv_layout``): paged (the default, "auto"), with pages
    allocated lazily per prefill chunk from a host page allocator
    (engine/paging.py) and returned on release; or contiguous, one
    [C]-row block per slot and no allocator. ``cache_dtype`` float (the
    model dtype) or ``torch.int8`` (paged only: rows quantized as they are
    written, kernel K3 for decode);
  * RAGGED PACKED PREFILL: each tick walks the prefill queue in order,
    takes each slot's pending prompt tail (at most ``prefill_chunk`` per
    slot) until ``prefill_token_budget`` fills, and runs ONE ragged
    forward (models/llama.py::ragged_prefill, kernel K2 or K2-int8). A
    prompt longer than the chunk is split across ticks, so its later
    chunks are continued segments over committed rows. Final segments
    sample their first token in the same tick, on the device. The pack
    is padded to a total-token bucket (``prefill_buckets``, the JAX
    engine's ``_pack_buckets`` rule); on the card each (bucket,
    continued) pair is ONE CUDA graph (engine/prefill_graph.py, the JAX
    engine's compiled program per pair), captured at ``start`` and
    replayed once per pack; on the CPU the same padded body runs eagerly;
  * DECODE BURSTS of up to ``decode_burst`` steps: tokens, lengths and
    sampling stay on the device for the whole burst (kernel K1, K3 or K4
    in every layer of every step) and the host syncs once, at its end.
    On the card a step is ONE captured CUDA graph (engine/decode_graph.py,
    the JAX engine's compiled scan body), captured at ``start`` and
    replayed once per step; on the CPU the same step body runs eagerly;
  * EOS / stop-sequence / max-tokens handling and slot release;
  * ``cancel(request_id)`` (the JAX engine's): a running request is
    released at the next step or burst boundary, a queued one is dropped
    unadmitted; the HTTP layer cancels a stream whose client went away;
  * DEVICE-TIER PREFIX REUSE (``kv_prefix_cache``, on by default as in
    the JAX engine). A released slot keeps its committed rows
    (``_cache_tokens``, trimmed to the rows whose KV write ran) and, on
    the paged layout, indexes their full pages in the cross-release
    prefix cache (engine/prefix_cache.py). Admission picks the free slot
    with the longest common prefix (``_pick_slot``) and then, paged, the
    best of three tiers (``_paged_admission``): 1. the slot's own
    retained rows; 2. another slot's committed prompt rows, shared
    copy-on-write (``_share_prefix``); 3. a retained chain found by hash
    and spliced into the table. The reused rows are never copied; only
    the first page the request writes is cloned when others still read
    it (``_cow_guard``), and the rest of the prompt is prefilled as a
    continued segment. Under pool pressure free slots' tables are
    reclaimed first, then retained chains evicted LRU-first
    (``_reclaim_pages``). The contiguous layout has tier 1 only: the rows
    stay in the slot's block. ``kv_prefix_cache=False`` reuses nothing
    (every prompt is prefilled whole, as before this existed).

  * the JAX sampler's whole surface (engine/sampling.py): temperature,
    top-k / top-p / min-p, typical-p, the repeat / presence / frequency
    penalties over a per-slot penalty ring, logit bias and mirostat v2,
    installed at admission (the ring seeded with the prompt tail, the
    bias row written or cleared, mu = 2 * tau). A burst runs the decode
    graph's plain variant unless an active slot uses penalties,
    typical-p or mirostat, then the full one; packs always sample with
    the full sampler (the JAX engine's two burst variants and its packed
    prefill);
  * CONTEXT SHIFT (``context_shift``, on by default as in the JAX
    engine): a slot whose next token would reach the cache edge keeps
    the last ``max_context // 2`` tokens of its history, re-prefills
    them from row 0 (paged: its committed pages enter the prefix cache
    first, the table is released, and the kept window goes through the
    admission tiers) and keeps generating; its penalty ring restarts
    from the kept window, its RNG counter and mirostat mu carry on. With
    ``context_shift=False`` such a slot finishes with "length".

Prefill and decode run as separate ticks (the JAX engine's
``prefill_packed_fuse="0"``); greedy output does not depend on that.
Left for later slices: the host tier of prefix reuse (kv_offload), the
snap-back window, speculation, grammar, preemption, self-extend and the
replica pool.
"""

from __future__ import annotations

import dataclasses
import logging
import queue
import threading
import time
import uuid
import zlib
from typing import Any, Iterator, Optional

import numpy as np
import torch

from localai_tpu_torch import resolve_device
from localai_tpu_torch.engine import sampling
from localai_tpu_torch.engine.decode_graph import DecodeGraph, eager_burst
from localai_tpu_torch.engine.detok import IncrementalDetokenizer
from localai_tpu_torch.engine.paging import PagePool, PoolExhausted
from localai_tpu_torch.engine.prefill_graph import (
    PrefillGraph, eager_pack, new_pack, split_pack)
from localai_tpu_torch.engine.prefix_cache import PrefixPageCache, build_scope
from localai_tpu_torch.models import llama
from localai_tpu_torch.ops import kvcache
from localai_tpu_torch.ops.ragged_prefill import kernel_supports

log = logging.getLogger(__name__)

KV_LAYOUTS = ("auto", "paged", "contiguous")   # auto = paged


@dataclasses.dataclass
class EngineConfig:
    num_slots: int = 8
    max_context: int = 2048
    # total-token pad buckets of a pack: those within prefill_chunk, plus
    # the chunk, each capped at the pack budget, plus the budget (the JAX
    # engine's rule); one captured graph per (bucket, continued)
    prefill_buckets: tuple = (32, 128, 512, 2048)
    prefill_chunk: int = 512          # max prompt tokens per slot per tick
    # max packed prompt tokens per tick (the decode-ITL bound of packed
    # prefill); 0 = auto: 2 * prefill_chunk, clamped to max_context
    prefill_token_budget: int = 0
    kv_page_size: int = 64
    # physical pages in the pool; 0 = num_slots * max_context / page_size
    kv_pool_pages: int = 0
    decode_burst: int = 16            # decode steps per host sync
    cache_dtype: Any = None           # None = the model dtype; torch.int8
    # KV_LAYOUTS; "auto" is paged, as in the JAX engine without self-extend
    kv_layout: str = "auto"
    # device-tier prefix reuse (module doc): released slots keep their
    # committed rows, paged ones index their full pages by hash; False
    # reuses nothing
    kv_prefix_cache: bool = True
    # the fewest reusable rows for a tier-2 share or a tier-3 hit to beat
    # a clean prefill
    kv_prefix_cache_min_rows: int = 16
    # at the cache edge re-prefill the last max_context // 2 tokens and
    # keep generating; False finishes the request with "length"
    context_shift: bool = True


@dataclasses.dataclass
class GenRequest:
    prompt_ids: list
    params: sampling.SamplingParamsHost = dataclasses.field(
        default_factory=sampling.SamplingParamsHost)
    max_new_tokens: int = 256
    stop_sequences: list = dataclasses.field(default_factory=list)
    ignore_eos: bool = False
    request_id: str = ""
    out: "queue.Queue" = None  # receives StreamEvent, then a None sentinel
    t_submit: float = 0.0

    def __post_init__(self):
        if not self.request_id:
            self.request_id = uuid.uuid4().hex[:16]
        if self.out is None:
            self.out = queue.Queue()


@dataclasses.dataclass
class StreamEvent:
    token_id: int
    text: str                 # finalized text delta (may be "")
    logprob: float
    finish_reason: Optional[str] = None   # "stop" | "length" | None
    prompt_tokens: int = 0
    completion_tokens: int = 0
    timings: Optional[dict] = None
    error: Optional[str] = None
    # events coalesced per slot per burst carry every member token;
    # token_id/logprob above are the last member's
    token_ids: Optional[list] = None
    logprobs: Optional[list] = None


def _prefix_len(a: list, b: list) -> int:
    """Length of the common prefix of two token lists."""
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n


def _merge_events(evs: list) -> StreamEvent:
    last = evs[-1]
    return dataclasses.replace(
        last, text="".join(e.text for e in evs),
        token_ids=[e.token_id for e in evs], logprobs=[e.logprob for e in evs])


class _Slot:
    __slots__ = ("req", "detok", "held_text", "prompt_len",
                 "t_start", "t_first_token", "n_decoded", "t_prefill_ms",
                 "phase", "pending", "written", "cache_len", "committed",
                 "reused")

    def __init__(self, req: GenRequest, detok, prompt_len: int):
        self.req = req
        self.detok = detok
        self.held_text = ""      # text withheld on a partial stop-sequence match
        self.prompt_len = prompt_len
        self.t_start = time.monotonic()
        self.t_first_token = 0.0
        self.n_decoded = 0
        self.t_prefill_ms = 0.0
        self.phase = "prefill"   # "prefill" -> "decode"
        self.pending: list = []  # prompt tokens not yet prefilled
        self.written = 0         # cache rows holding this request's tokens
        self.cache_len = 0       # rows the next decode step writes at
        self.committed = 0       # rows whose KV write has run
        self.reused = 0          # prompt rows reused from earlier requests


class Engine:
    """Owns the model state on one device and a background loop thread."""

    def __init__(self, model_cfg: llama.LlamaConfig, params: dict, tokenizer,
                 engine_cfg: Optional[EngineConfig] = None, device="cuda"):
        self.device = resolve_device(device)
        self.cfg = model_cfg
        self.ecfg = engine_cfg or EngineConfig()
        self.params = params
        self.tokenizer = tokenizer
        S, C = self.ecfg.num_slots, self.ecfg.max_context
        if self.ecfg.kv_layout not in KV_LAYOUTS:
            raise ValueError(f"kv_layout must be {'|'.join(KV_LAYOUTS)}, got "
                             f"{self.ecfg.kv_layout!r}")
        self.kv_layout = ("contiguous" if self.ecfg.kv_layout == "contiguous"
                          else "paged")
        self.cache_dtype = self.ecfg.cache_dtype or model_cfg.dtype
        self._pool: Optional[PagePool] = None    # None: contiguous layout
        pg = 0                                   # 0: contiguous (init_cache)
        if self.kv_layout == "paged":
            pg = max(1, min(self.ecfg.kv_page_size, C))
            while C % pg:         # the page size must divide the context
                pg -= 1
            self._pool = PagePool(S, C, pg, self.ecfg.kv_pool_pages)
        self._reuse = bool(self.ecfg.kv_prefix_cache)
        self._pcache: Optional[PrefixPageCache] = None
        if self._reuse and self._pool is not None:
            self._pcache = PrefixPageCache(
                build_scope("llama", model_cfg, pg, self.cache_dtype), pg)
        # per slot, the tokens whose KV rows the slot holds: a running
        # request's prompt + emitted tokens (a context shift's history);
        # with reuse, trimmed to the committed rows at release
        self._cache_tokens: list = [[] for _ in range(S)]
        self._reuse_stats = {"reused_rows": 0, "cow_clones": 0}
        self.ck, self.cv = llama.init_cache(
            model_cfg, S, C, pg, self._pool.num_pages if self._pool else 0,
            dtype=self.cache_dtype, device=self.device)
        if self._pool is not None:
            # ONE device page table, rewritten in place (_commit_ptab): the
            # captured decode step reads it where it lies
            self.cv["ptab"] = self.ck["ptab"]
        self.sampler = sampling.SlotSampler(S, model_cfg.vocab_size, self.device)
        self._graph = DecodeGraph(params, model_cfg, self.ck, self.cv,
                                  self.sampler, S, self.ecfg.decode_burst,
                                  self.device)
        eid = getattr(tokenizer, "eos_token_id", None)
        self.eos_ids = {int(eid)} if eid is not None else set()
        # host mirrors of the per-slot decode state
        self.lengths = np.zeros((S,), np.int32)
        self.cur_tokens = np.zeros((S,), np.int32)
        self.slots: list = [None] * S
        self._prefill_queue: list = []
        self._queue: "queue.Queue[GenRequest]" = queue.Queue()
        self._wake = threading.Event()
        self._stop = False
        # request ids cancel() noted, reaped by the engine thread
        self._cancelled: set = set()
        self._cancel_lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._chunk = min(self.ecfg.prefill_chunk, C)
        budget = self.ecfg.prefill_token_budget or 2 * self._chunk
        self._pack_budget = max(1, min(budget, C))
        # the JAX engine's pad buckets (engine.py:1006-1008, :1050-1053):
        # the ladder within the chunk plus the chunk, capped at the pack
        # budget, plus the budget (the loaded steady state)
        ladder = {b for b in self.ecfg.prefill_buckets if b <= self._chunk}
        self._pack_buckets = tuple(sorted(
            {min(b, self._pack_budget) for b in ladder | {self._chunk}}
            | {self._pack_budget}))
        self._pgraph = PrefillGraph(params, model_cfg, self.ck, self.cv,
                                    self.sampler, S, C, self._pack_buckets,
                                    self.device)
        self._sink: Optional[dict] = None   # per-slot event coalescing
        # counters exposed by metrics(); pad_tokens counts the bucket's pad
        # rows; kernel_fallback counts packs whose head shapes the K2
        # kernel cannot take — it must stay 0 ("seconds": host wall time
        # of the ticks, device sync included)
        self._pack_stats = {"dispatches": 0, "tokens": 0, "segments": 0,
                            "pad_tokens": 0, "continued": 0,
                            "kernel_fallback": 0, "seconds": 0.0}
        # full_steps: steps of the full sampler variant
        self._decode_stats = {"bursts": 0, "steps": 0, "full_steps": 0,
                              "tokens": 0, "seconds": 0.0}

    # ---------- lifecycle ----------

    def start(self):
        """Start the engine thread. On the card it first captures the
        decode step's graph and the prefill graphs (as the JAX engine
        precompiles its bursts and packs); start returns once that is
        done and raises if it failed."""
        if self._thread is None:
            ready, failed = threading.Event(), []
            self._thread = threading.Thread(target=self._run, name="engine",
                                            args=(ready, failed), daemon=True)
            self._thread.start()
            ready.wait()
            if failed:
                self._thread.join()
                self._thread = None
                raise RuntimeError("CUDA graph capture failed") from failed[0]
        return self

    def shutdown(self):
        self._stop = True
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=60)
            if not self._thread.is_alive():
                # free the graphs and their pools (an engine thread still
                # running may replay them)
                self._graph.free()
                self._pgraph.free()
            self._thread = None
        err = StreamEvent(token_id=-1, text="", logprob=0.0,
                          finish_reason="stop", error="engine shut down")
        for i, s in enumerate(self.slots):
            if s is not None:
                s.req.out.put(err)
                s.req.out.put(None)
                self._release_slot(i)
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            req.out.put(err)
            req.out.put(None)

    def cancel(self, request_id: str):
        """Cancel a queued or running request (the JAX engine's
        ``cancel``). Thread-safe: it notes the id and wakes the loop. At the
        next step or burst boundary a running slot with that id is released
        and its output queue gets the None sentinel; a queued request with
        that id is dropped unadmitted (its queue gets only the sentinel). A
        burst already on the device finishes first."""
        with self._cancel_lock:
            self._cancelled.add(request_id)
        self._wake.set()

    def submit(self, req: GenRequest) -> "queue.Queue":
        req.t_submit = time.monotonic()
        self._queue.put(req)
        self._wake.set()
        return req.out

    def generate(self, req: GenRequest) -> Iterator[StreamEvent]:
        out = self.submit(req)
        while True:
            ev = out.get()
            if ev is None:
                return
            yield ev

    def generate_text(self, req: GenRequest) -> tuple:
        events = list(self.generate(req))
        return "".join(e.text for e in events), events

    @property
    def num_active(self) -> int:
        return sum(1 for s in self.slots if s is not None)

    def metrics(self) -> dict:
        out = {"num_slots": self.ecfg.num_slots,
               "active_slots": self.num_active,
               "queued": self._queue.qsize(),
               "kv_layout": self.kv_layout,
               "cache_dtype": str(self.cache_dtype).replace("torch.", ""),
               "packed_prefill": dict(self._pack_stats),
               "decode": dict(self._decode_stats),
               "decode_graph": {"captured": sorted(self._graph.graphs),
                                "capture_seconds": self._graph.capture_seconds,
                                "pool_bytes": self._graph.pool_bytes},
               "prefill_graph": {"captured": sorted(self._pgraph.graphs),
                                 "buckets": list(self._pack_buckets),
                                 "capture_seconds": self._pgraph.capture_seconds,
                                 "pool_bytes": self._pgraph.pool_bytes}}
        out["prompt_tokens_reused"] = self._reuse_stats["reused_rows"]
        if self._pool is not None:
            pool = self._pool
            # the running requests' pages and any leaked reference: a free
            # slot's retained rows and the prefix cache's are not in use,
            # so this is 0 at idle unless a page leaked
            out["pages_in_use"] = pool.pages_beyond(
                [i for i, s in enumerate(self.slots) if s is None])
            out["pages_total"] = pool.num_pages
            out["kv_pages_free"] = pool.free_pages
            out["kv_pages_retained"] = pool.retained_pages
            out["kv_pages_active"] = pool.active_pages
            if self._pcache is not None:
                out["prefix_cache"] = {**self._pcache.stats(),
                                       "cow_clones": self._reuse_stats["cow_clones"]}
        return out

    # ---------- engine loop ----------

    def _capture(self):
        """Capture the decode step's two variants and every (bucket,
        continued) prefill graph (CUDA only; engine thread)."""
        self._graph.capture()
        self._pgraph.capture()

    def _run(self, ready: threading.Event, failed: list):
        try:
            if self.device.type == "cuda":
                self._capture()
        except Exception as e:     # start() re-raises it
            failed.append(e)
            return
        finally:
            ready.set()
        while not self._stop:
            try:
                self._reap_cancelled()
                admitted = self._admit()
                prefilled = self._prefill_step()
                decoded = self._decode_burst()
                if not (admitted or prefilled or decoded):
                    self._wake.wait(timeout=0.5)
                    self._wake.clear()
            except Exception as e:   # the loop must survive: fail the requests
                self._fail_active(e)

    def _fail_active(self, e: Exception):
        log.exception("engine step failed")
        for i, s in enumerate(self.slots):
            if s is not None:
                s.req.out.put(StreamEvent(
                    token_id=-1, text="", logprob=0.0, finish_reason="stop",
                    error=f"{type(e).__name__}: {e}"))
                s.req.out.put(None)
                self._release_slot(i)

    def _reap_cancelled(self):
        """Release the running slots cancel() named. An id that names no
        slot and no queued request belongs to a request that already ended,
        and is forgotten."""
        with self._cancel_lock:
            if not self._cancelled:
                return
            ids = set(self._cancelled)
        for i, s in enumerate(self.slots):
            if s is not None and s.req.request_id in ids:
                self._release_slot(i)
                s.req.out.put(None)
        with self._queue.mutex:
            queued = {r.request_id for r in self._queue.queue}
        with self._cancel_lock:
            self._cancelled -= ids - queued

    def _admit(self) -> bool:
        admitted = False
        while None in self.slots:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            with self._cancel_lock:
                cancelled = req.request_id in self._cancelled
                self._cancelled.discard(req.request_id)
            if cancelled:                   # cancelled while queued
                req.out.put(None)
                continue
            try:
                self._start_request(req)
            except Exception as e:          # the JAX engine's admission handler
                log.exception("admission failed")
                req.out.put(StreamEvent(
                    token_id=-1, text="", logprob=0.0, finish_reason="stop",
                    error=f"{type(e).__name__}: {e}"))
                req.out.put(None)
                continue
            admitted = True
        return admitted

    def _start_request(self, req: GenRequest):
        """Install a request in a free slot and queue its prompt for packed
        prefill. No model compute happens here."""
        C = self.ecfg.max_context
        ids = [int(t) for t in req.prompt_ids]
        # keep the prompt tail (the JAX engine's truncation rule)
        max_prompt = C - 1 - min(req.max_new_tokens, C // 4)
        if len(ids) > max_prompt:
            ids = ids[-max_prompt:]
        if not ids:
            ids = [getattr(self.tokenizer, "eos_token_id", 0) or 0]
        slot, common = self._pick_slot(ids)
        # a short accidental match (a shared BOS or first word) is not
        # worth the continued prefill it forces (the JAX engine's guard)
        if common < 16 or not self._reuse:
            common = 0
        if self._pool is not None and self._reuse:
            try:
                common = self._paged_admission(slot, ids, common)
            except Exception:
                # the table may hold another prompt's shared or spliced
                # pages now (PoolExhausted for a clone): the slot forgets
                # every row, so no later pick reuses rows it does not hold
                self._pool.release(slot, 0)
                self._cache_tokens[slot] = []
                raise
        self.sampler.set_slot(slot, req.params,
                              fallback_seed=zlib.crc32(req.request_id.encode()))
        # the penalty window covers the prompt tail (reused rows included)
        self.sampler.set_ring(slot, ids)
        s = _Slot(req, IncrementalDetokenizer(self.tokenizer), len(ids))
        s.pending = ids[common:]
        s.written = s.committed = s.reused = common
        self._reuse_stats["reused_rows"] += common
        self._cache_tokens[slot] = list(ids)
        self.slots[slot] = s
        self._prefill_queue.append(slot)

    def _pick_slot(self, ids: list) -> tuple:
        """The free slot with the longest cached common prefix; on ties the
        one with the least cached content, so unrelated requests do not
        evict another conversation's rows. Returns (slot, reusable rows),
        leaving at least one token to prefill for the last position's
        logits."""
        best, best_key = None, None
        for i, s in enumerate(self.slots):
            if s is not None:
                continue
            key = (_prefix_len(self._cache_tokens[i], ids),
                   -len(self._cache_tokens[i]))
            if best_key is None or key > best_key:
                best, best_key = i, key
        return best, min(best_key[0], len(ids) - 1)

    # ---------- prefix reuse (paged) ----------

    def _paged_admission(self, slot: int, ids: list, common: int) -> int:
        """Paged prefix reuse at admission: the rows reusable from the
        best of three tiers (module doc). Tier 1, ``common``, is the
        slot's own retained rows. Tier 2 shares another slot's rows that
        are read-only for it (the committed prompt rows of a running slot,
        the retained rows of a free one). Tier 3 splices a retained chain
        of the prefix cache. Tiers 2 and 3 need kv_prefix_cache_min_rows
        rows. The first page this request writes is cloned if shared."""
        pool = self._pool
        min_rows = max(1, self.ecfg.kv_prefix_cache_min_rows)
        cap = len(ids) - 1              # leave >= 1 token to prefill
        best_src, best_rows = -1, 0
        for j, sj in enumerate(self.slots):
            if j == slot:
                continue
            toks = self._cache_tokens[j]
            limit = len(toks) if sj is None else min(sj.committed, sj.prompt_len)
            limit = min(limit, cap, pool.slot_rows_capacity(j))
            n = _prefix_len(toks[:limit], ids)
            if n > best_rows:
                best_src, best_rows = j, n
        cached_pages = self._pcache.match(ids, pool.max_pages)
        cached_rows = min(len(cached_pages) * pool.page_size, cap)
        if cached_rows >= min_rows and cached_rows > max(common, best_rows):
            pool.release(slot, 0)
            pool.splice(slot, cached_pages)
            # a retained page back in a table has refs >= 2 (table + hold),
            # so the guard clones the page the prefill writes first
            self._cow_guard(slot, cached_rows)
            self._pcache.note_hit(cached_rows)
            return cached_rows
        self._pcache.note_miss()
        if best_rows > common and best_rows >= min_rows:
            pool.release(slot, 0)
            return self._share_prefix(best_src, slot, best_rows)
        pool.release(slot, common)
        if common:
            self._cow_guard(slot, common)
        return common

    def _share_prefix(self, src: int, dst: int, rows: int) -> int:
        """Tier 2: src's full pages covering rows[0:rows] are shared into
        dst's table; where the prefix ends mid-page that page is cloned
        (one page copy), so dst reuses exactly ``rows`` rows."""
        shared = self._pool.share(src, dst, rows)
        if shared < rows:
            pi = shared // self._pool.page_size
            new = self._alloc_detached((src, dst))
            self._clone_page(int(self._pool.ptab[src, pi]), new)
            self._pool.adopt(dst, new)
            shared = rows
        return shared

    def _cow_guard(self, slot: int, row: int):
        """Copy-on-write: if the page holding ``row`` (the slot's first
        write) is shared, clone it into a fresh page and swap that into the
        table before any scatter can touch it."""
        pi = self._pool.cow_page(slot, row)
        if pi < 0:
            return
        new = self._alloc_detached(slot)
        old = int(self._pool.ptab[slot, pi])
        self._clone_page(old, new)
        self._pool.replace(slot, pi, new)

    def _clone_page(self, src: int, dst: int):
        kvcache.clone_page(self.ck, src, dst)
        kvcache.clone_page(self.cv, src, dst)
        self._reuse_stats["cow_clones"] += 1

    def _alloc_detached(self, protect) -> int:
        """A clone target, reclaiming under pressure (``protect`` as in
        _reclaim_pages)."""
        try:
            return self._pool.alloc_detached()
        except PoolExhausted:
            self._reclaim_pages(protect, 1)
            return self._pool.alloc_detached()

    def _reclaim_pages(self, protect, need_free: int):
        """Free pages under pool pressure, cheapest first: release the
        retained tables of free slots (forgetting their tokens), then
        evict retained chains LRU-first. ``protect`` (a slot or a tuple of
        slots) names tables to keep: mid-admission the destination slot is
        still free, and a share source may be a free slot."""
        protect = protect if isinstance(protect, tuple) else (protect,)
        for i, s in enumerate(self.slots):
            if self._pool.free_pages >= need_free:
                return
            if s is None and i not in protect and self._pool.owned[i]:
                self._pool.release(i, 0)
                self._cache_tokens[i] = []
        if self._pcache is not None:
            self._pcache.evict(self._pool, need_free)

    def _ensure_pages(self, slot: int, rows: int):
        """Lazy page allocation; under pool pressure reclaim and retry once
        (PoolExhausted if the running requests alone fill the pool)."""
        try:
            self._pool.ensure(slot, rows)
            return
        except PoolExhausted:
            pass
        self._reclaim_pages(slot, self._pool.pages_for(rows))
        self._pool.ensure(slot, rows)

    def _commit_ptab(self):
        """Copy the host page table into the one device table, in place
        (K and V share it). A plain copy: every pack and burst syncs the
        host at its end, so no pending read sees the table change."""
        if self._pool is not None and self._pool.dirty:
            self.ck["ptab"].copy_(torch.from_numpy(self._pool.ptab))
            self._pool.dirty = False

    def _prefill_step(self) -> bool:
        """ONE ragged packed-prefill dispatch for this tick (see module doc).
        Final segments go first so output row b is segment b."""
        S, C = self.ecfg.num_slots, self.ecfg.max_context
        budget = self._pack_budget
        segs = []                     # (slot, snapshot, take, final)
        total = 0
        for slot in self._prefill_queue:
            if len(segs) >= S or total >= budget:
                break
            s = self.slots[slot]
            if s is None or s.phase != "prefill" or not s.pending:
                continue
            take = min(len(s.pending), self._chunk, budget - total)
            if take <= 0:
                continue
            segs.append((slot, s, take, take == len(s.pending)))
            total += take
        if not segs:
            return False
        segs.sort(key=lambda t: not t[3])
        t0 = time.monotonic()
        if self._pool is not None:
            for slot, s, take, _f in segs:
                self._ensure_pages(slot, s.written + take)
        self._commit_ptab()

        bucket = next(b for b in self._pack_buckets if total <= b)
        host = new_pack(bucket, S, C)
        v = split_pack(host, bucket, S)
        off = 0
        for b, (slot, s, take, final) in enumerate(segs):
            v["tokens"][off:off + take] = s.pending[:take]
            v["positions"][off:off + take] = np.arange(s.written, s.written + take)
            v["seg_of"][off:off + take] = b
            v["seg_slots"][b], v["seg_start"][b] = slot, s.written
            v["seg_off"][b], v["seg_len"][b] = off, take
            v["final_mask"][b] = final
            off += take
        cfg = self.cfg
        st = self._pack_stats
        st["dispatches"] += 1
        st["tokens"] += total
        st["segments"] += len(segs)
        st["pad_tokens"] += bucket - total
        continued = any(s.written > 0 for _sl, s, _t, _f in segs)
        st["continued"] += int(continued)
        st["kernel_fallback"] += int(not kernel_supports(
            cfg.num_kv_heads, cfg.q_per_kv, cfg.head_dim_))
        firsts = self._prefill_pack(bucket, continued, host)    # [2, finals]
        finals = [(slot, s) for slot, s, _t, f in segs if f]
        ids_np, lps_np = firsts[0].astype(np.int64), firsts[1]
        t1 = time.monotonic()
        st["seconds"] += t1 - t0
        for slot, s, take, final in segs:
            s.pending = s.pending[take:]
            s.written += take
            s.committed = s.written
            s.t_prefill_ms += (t1 - t0) * 1e3
        self._sink = {}
        try:
            for b, (slot, s) in enumerate(finals):
                self._prefill_queue.remove(slot)
                s.phase = "decode"
                s.cache_len = s.written
                if not s.t_first_token:   # a shift's re-prefill keeps it
                    s.t_first_token = t1
                self.lengths[slot] = s.written
                self.cur_tokens[slot] = int(ids_np[b])
                self._emit(slot, int(ids_np[b]), float(lps_np[b]))
        finally:
            self._flush_sink()
        return True

    def _prefill_pack(self, bucket: int, continued: bool,
                      host: np.ndarray) -> np.ndarray:
        """The pack's device work: a graph replay on the card, the same
        padded body eagerly on the CPU (prefill_graph.PrefillGraph.run).
        Returns the finals' [2, n] first-token ids and logprobs."""
        return self._pgraph.run(bucket, continued, host)

    def _prefill_eager(self, bucket: int, continued: bool, host: np.ndarray,
                       exact: bool = False):
        """The eager pack (prefill_graph.eager_pack: at the bucket, or at
        the pack's exact size), the reference chip_smoke.py and the card
        tests hold the graphs against; serving never calls it. Returns
        ([2, n] ids and logprobs, logits)."""
        return eager_pack(self.params, self.cfg, self.ck, self.cv,
                          self.sampler, host, bucket, self.ecfg.num_slots,
                          continued, exact=exact)

    def _pick_burst(self, decoding: list) -> int:
        """Steps in the next burst: a power of two <= decode_burst, clamped
        so no slot reaches the cache edge mid-burst and no burst outlasts
        every slot's remaining token budget."""
        cap = self.ecfg.decode_burst
        budget = 1
        for i in decoding:
            s = self.slots[i]
            cap = min(cap, max(1, self.ecfg.max_context - 2 - s.cache_len))
            budget = max(budget, s.req.max_new_tokens - s.n_decoded)
        cap = min(cap, budget)
        k = 1
        while k * 2 <= cap:
            k *= 2
        return k

    def _decode_burst(self) -> bool:
        """Dispatch one decode burst, sync its tokens once, emit them."""
        S, C = self.ecfg.num_slots, self.ecfg.max_context
        decoding = [i for i, s in enumerate(self.slots)
                    if s is not None and s.phase == "decode"]
        if not decoding:
            return False
        t0 = time.monotonic()
        n_steps = self._pick_burst(decoding)
        if self._pool is not None:
            for i in decoding:
                self._ensure_pages(i, min(C, int(self.lengths[i]) + n_steps + 2))
        self._commit_ptab()
        active_np = np.zeros((S,), np.bool_)
        active_np[decoding] = True
        host = self._burst(n_steps, active_np)          # [K, 2, S]: ONE sync
        ids_np = host[:, 0].astype(np.int64)
        lps_np = host[:, 1]
        snaps = [(i, self.slots[i]) for i in decoding]
        st = self._decode_stats
        st["bursts"] += 1
        st["steps"] += n_steps
        st["full_steps"] += n_steps * self.sampler.full_needed(active_np)
        st["seconds"] += time.monotonic() - t0
        self._sink = {}
        try:
            for j in range(n_steps):
                for i, snap in snaps:
                    # finished, or context-shifted, earlier in this burst
                    if self.slots[i] is not snap or snap.phase != "decode":
                        continue
                    # step j wrote the row of the slot's previous token
                    snap.committed = min(snap.committed + 1, snap.cache_len)
                    self._emit(i, int(ids_np[j, i]), float(lps_np[j, i]))
        finally:
            self._flush_sink()
        for i, snap in snaps:
            if self.slots[i] is snap and snap.phase == "decode":
                self.lengths[i] += n_steps
                self.cur_tokens[i] = int(ids_np[-1, i])
        return True

    def _burst(self, n_steps: int, active: np.ndarray) -> np.ndarray:
        """The burst's device work: graph replays on the card, the same
        step body eagerly on the CPU (decode_graph.DecodeGraph.run), in
        the full sampler variant when an active slot needs it."""
        return self._graph.run(self.cur_tokens, self.lengths, active, n_steps,
                               full=self.sampler.full_needed(active))

    def _burst_eager(self, n_steps: int, active: np.ndarray) -> np.ndarray:
        """The eager per-step loop (decode_graph.eager_burst), the
        reference chip_smoke.py and the card tests hold the graph against;
        serving never calls it."""
        return eager_burst(self.params, self.cfg, self.ck, self.cv,
                           self.sampler, self.cur_tokens, self.lengths,
                           active, n_steps,
                           full=self.sampler.full_needed(active))

    # ---------- emission ----------

    def _flush_sink(self):
        sink, self._sink = self._sink, None
        for out, evs in (sink or {}).values():
            out.put(evs[0] if len(evs) == 1 else _merge_events(evs))

    def _emit(self, slot: int, token_id: int, logprob: float):
        """Emit one token of a slot: EOS / max-tokens / stop sequences
        finish the request and release the slot; at the cache edge the
        slot shifts its context (or, without context_shift, finishes)."""
        s = self.slots[slot]
        s.n_decoded += 1
        self._decode_stats["tokens"] += 1
        finish = None
        edge = s.cache_len + 1 >= self.ecfg.max_context - 1
        if token_id in self.eos_ids and not s.req.ignore_eos:
            finish = "stop"
            delta = s.held_text + s.detok.flush()
        elif (s.n_decoded >= s.req.max_new_tokens
              or (edge and not self.ecfg.context_shift)):
            finish = "length"
            delta = s.held_text + s.detok.push(token_id) + s.detok.flush()
        else:
            delta = s.held_text + s.detok.push(token_id)
            s.held_text = ""
            # stop sequences apply at a shift's trigger token too
            if s.req.stop_sequences:
                cut = self._check_stops(s, delta)
                if cut is not None:
                    delta, finish = cut, "stop"
                elif delta:
                    delta, s.held_text = self._holdback(s, delta)
        if finish is None and edge:
            self._context_shift(slot, s, token_id)
        elif finish is None:
            s.cache_len += 1      # this token's KV is written by the next step
            self._cache_tokens[slot].append(token_id)
        ev = StreamEvent(token_id=token_id, text=delta, logprob=logprob,
                         finish_reason=finish, prompt_tokens=s.prompt_len,
                         completion_tokens=s.n_decoded)
        key = id(s)
        if finish:
            dt = time.monotonic() - s.t_first_token
            ev.timings = {
                "prefill_ms": s.t_prefill_ms,
                "queue_wait_ms": max(0.0, (s.t_start - s.req.t_submit) * 1e3)
                if s.req.t_submit else 0.0,
                "admit_to_first_ms": max(0.0, (s.t_first_token - s.t_start) * 1e3),
                "decode_tokens_per_s": (s.n_decoded - 1) / dt
                if dt > 0 and s.n_decoded > 1 else 0.0,
                "reused_prompt_tokens": s.reused,
            }
            self._release_slot(slot)
            if self._sink is not None and key in self._sink:
                _out, evs = self._sink.pop(key)
                s.req.out.put(evs[0] if len(evs) == 1 else _merge_events(evs))
            s.req.out.put(ev)
            s.req.out.put(None)
        elif self._sink is not None:
            self._sink.setdefault(key, (s.req.out, []))[1].append(ev)
        else:
            s.req.out.put(ev)

    def _context_shift(self, slot: int, s: _Slot, token_id: int):
        """The cache is full mid-generation: keep the last max_context // 2
        tokens of the history (the trigger token included), re-prefill
        them into the slot from row 0 and keep generating (the JAX
        engine's ``_context_shift``, without its window and self-extend
        branches). Paged, the committed pages enter the prefix cache (when
        on) and the table is released: the re-prefill allocates anew and
        never rewrites a page another slot or the cache reads; with reuse
        the kept window goes through the admission tiers. The penalty ring
        restarts from the kept window; the RNG counter and mu carry on."""
        history = self._cache_tokens[slot] + [token_id]
        new_ids = history[-max(self.ecfg.max_context // 2, 1):]
        if self._pool is not None:
            if self._pcache is not None:
                self._pcache.insert(self._pool, slot,
                                    self._cache_tokens[slot][:s.committed])
            self._pool.release(slot, 0)
        s.phase = "prefill"
        s.pending = list(new_ids)
        s.written = s.cache_len = s.committed = 0
        self._cache_tokens[slot] = list(new_ids)
        if self._pcache is not None:
            reused = self._paged_admission(slot, new_ids, 0)
            s.pending = new_ids[reused:]
            s.written = s.committed = s.reused = reused
            self._reuse_stats["reused_rows"] += reused
        self.lengths[slot] = 0
        self.sampler.set_ring(slot, new_ids)
        self._prefill_queue.append(slot)

    def _check_stops(self, s: _Slot, delta: str) -> Optional[str]:
        """If a stop sequence completes in emitted+delta text, return the
        delta truncated before the stop; else None."""
        total = s.detok.text
        for stop in s.req.stop_sequences:
            idx = total.find(stop, max(0, len(total) - len(delta) - len(stop)))
            if idx != -1:
                emitted_before = len(total) - len(delta)
                return delta[: max(0, idx - emitted_before)]
        return None

    def _holdback(self, s: _Slot, delta: str) -> tuple:
        """Withhold a suffix of delta that is a prefix of a stop sequence."""
        total = s.detok.text
        hold = 0
        for stop in s.req.stop_sequences:
            for k in range(min(len(stop) - 1, len(total)), 0, -1):
                if total.endswith(stop[:k]):
                    hold = max(hold, min(k, len(delta)))
                    break
        if hold:
            return delta[:-hold], delta[-hold:]
        return delta, ""

    def _release_slot(self, slot: int):
        """Free a slot. With reuse it keeps the rows whose KV write ran
        (``_cache_tokens`` trimmed to ``committed``; rows a burst wrote
        past a stop are not among them): paged, their full pages enter the
        prefix cache while the table still pins them, and the table keeps
        the pages covering them for the slot's own next request."""
        toks = (self._cache_tokens[slot][:self.slots[slot].committed]
                if self._reuse else [])
        self._cache_tokens[slot] = toks
        if self._pool is not None:
            if self._pcache is not None:
                self._pcache.insert(self._pool, slot, toks)
            self._pool.release(slot, len(toks))
        self.slots[slot] = None
        self.lengths[slot] = 0
        if slot in self._prefill_queue:
            self._prefill_queue.remove(slot)
