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

  * THE PIPELINED LOOP (the JAX engine's default loop, with its knobs
    and defaults): a pack or a burst is DISPATCHED (device work and the
    copy of its results to pinned host memory queued on the engine
    thread's one CUDA stream, nothing waited for; engine/transfer.py)
    into a FIFO and PROCESSED later, in dispatch order (its tokens read
    and emitted). Up to ``pipeline_depth`` bursts (default 2) are in
    flight: the loop processes the oldest only when the pipeline is full
    or it can dispatch nothing more, so the host emits burst N while
    burst N+1 runs. Burst N+1 starts from burst N's final tokens and
    lengths on the device (decode_graph.py's chained state); the host
    overrides only the rows it changed since (``_override``: slots a
    processed pack activated). A slot's steps in flight count against its
    budget and the cache edge (``_inflight_vec``); a slot that finished,
    shifted or was cancelled in burst N has already ridden N+1, whose
    tokens for it are dropped (the snapshot test and ``_Burst.skip``),
    and its rows past ``committed`` are never reused. On the CPU a
    dispatch has finished when it returns, but it is processed by the
    same FIFO rule, so the tests see the same hazards as the card.
    ``prefill_packed_fuse`` (the JAX values; "auto" = "split"): a pack
    with final segments, while the pipeline has room and a full burst
    is runnable, is followed on the device, with no host sync between,
    by the fold of its first tokens into the decode state and a burst
    of ``decode_burst`` steps (the split fused tick); the first tokens
    are emitted when their own copy lands, while the burst still runs
    ("split"), or with the burst ("1"); "0" keeps packs and bursts
    apart. ``pipeline_depth=1`` with ``"0"`` is the loop before this
    slice: each pack and each burst is waited for in its own tick;
  * IN-FLIGHT PREFILL DEDUP (the JAX engine's fork): requests admitted
    together with the same prompt and ``min(max_new_tokens,
    max_context // 4)`` prefill once. The first is the leader; each other
    one (a sibling) installs its sampling state and waits ("fork_wait")
    until the leader's final pack is processed, then takes the leader's
    first ``len(prompt) - 1`` rows (paged: its pages shared, the boundary
    page cloned; contiguous: the rows copied) and prefills only the last
    prompt token to sample its own first token. A leader cancelled,
    failed or gone before that downgrades its siblings to full prefills.
    A departure from the JAX engine: a leader paused again within its own
    admission pass (the newest slot, when aged arrivals preempt) leads no
    sibling, and the next identical request becomes a leader (JAX seats
    it as the sibling of the parked leader, and it waits for ever).

  * THE HOST TIER of prefix reuse (``kv_offload``, on by default as in
    the JAX engine; engine/kv_offload.py), paged with the prefix cache
    only. When ``_reclaim_pages`` evicts a retained chain, each page the
    host store does not hold yet is gathered on the card into a fresh
    tensor in stream order, before any later pack or burst can reuse the
    page (``_dispatch_offload``); an offload worker thread, in dispatch
    order, copies that snapshot page by page to pinned host memory,
    waits for the copy and inserts the pages into the store (CRC at
    insert), the pinned copies kept as their content: pinning memory,
    waiting and the CRC stay off the engine thread. At admission the
    chain walk goes on past the device pages into the host store
    (``_paged_admission``): the hits (CRC checked on the engine thread)
    are copied straight from that pinned memory into newly allocated
    pages, spliced into the table and re-indexed in the prefix cache
    (``_restore_offloaded``). A queued request's host links are uploaded
    ahead of its admission into detached pages (``_prefetch_tick``,
    ``kv_prefetch_ahead`` requests deep), which its admission claims.
    The store is byte-budgeted (``kv_host_pool_mb``), saved at
    ``shutdown`` and loaded at start when ``kv_host_store_path`` is set.
    With the tier on, a default pool of at least 64 pages is cut to
    three quarters (the JAX rule). An offload still in the worker when a
    request arrives is not found (a shorter reuse, never a wrong one),
    as with the JAX sync worker. The port has no device reset:
    ``_fail_active`` keeps the pool (and the draft cache) and drops the
    prefetched pages.

  * THE REQUEST LIFECYCLE (the JAX engine's, with its knobs and
    defaults). Admission control: ``submit`` sheds at a full queue
    (``max_queued_requests``, 256): the newcomer, or with the scheduler
    the longest-queued request of a class strictly below the newcomer's,
    gets a "shed" event with a retry-after hint at once, from the
    submitting thread. Deadlines: at each admission tick queued requests
    past ``request_timeout_ms`` get a "timeout" event and those queued
    longer than ``max_queue_wait_ms`` are shed (both off by default); a
    running request past its deadline gets a "timeout" event and goes
    through the cancel path, its slot and pages released as on a client
    disconnect. The runner maps the kinds to 429 / 504 / 503.
  * THE DISPATCH-STALL WATCHDOG (``dispatch_stall_ms``, 30000): no wait
    for a pack's or a burst's results blocks for ever. The loop waits in
    bounded steps (transfer.Fetch.wait) against the later of the item's
    dispatch and the last landing it saw, and checks the FIFO head the
    same way when idle and when it leaves the head unlanded to dispatch
    more. An item past the bound aborts its own requests
    alone with a "stall" event (``_handle_stall``), leaves the FIFO, and
    its slots and their fork waiters are released; every other slot keeps
    serving. This is sound on the card because the loop runs every
    dispatch on one CUDA stream: a late pack or burst still runs to its
    end before anything dispatched after it, so the rows it writes into
    the pages it held land before any later pack or burst can write or
    read those pages for their next owner, and later bursts drop the
    aborted slots' steps (their snapshots no longer match). If the card
    is truly wedged, every later item stalls and is aborted the same way.
  * THE PREEMPTIVE PRIORITY SCHEDULER (``preempt``, on by default;
    engine/scheduler.py). Requests carry a class (high / normal / low,
    ``priority`` the default); admission pops queued work in aged-rank
    order (FIFO within a class, so single-class traffic admits as the
    FIFO path does) and merges the resume queue in; traffic of more than
    one class shares a pack's budget by deficit round-robin, and a burst
    shrinks while a strictly higher class waits to prefill. Paged only:
    a higher class that finds no free slot, or no page, PAUSES the
    lowest-class slot (``_preempt_slot``): its committed rows enter the
    prefix cache, its table is released, its steps in flight are
    dropped, and the request parks with its streaming state. Resume is
    plain re-admission of the whole history through ``_start_request``
    (tiers 1-3 and the host tier splice or restore the retained rows; if
    they are gone, a re-prefill of the identical history), with the
    detokenizer, held text, counts, timings and mirostat mu grafted on.
    On the contiguous layout nothing pauses. A request cancelled while
    parked ends its stream and leaves the resume queue. Two departures
    from the JAX engine, both where its PoolExhausted would fail every
    running request: a parked request resumes only once the pool can hold
    its history and next burst (``_resume_fits``; the JAX engine resumes
    into any free slot, so after a pool-pressure pause the victim
    re-admits at once into the pages its pause freed); and a decode slot
    that needs a page that no reclaim and no lower class's pause can give
    pauses itself while another request runs (``_ensure_pages``).

  * SPECULATION (``draft``, "auto" by default as in the JAX engine: the
    draft model when one is loaded, else n-gram self-speculation; "model"
    without a draft model is off; ``n_draft`` 4, ``spec_ngram`` 3;
    engine/speculative.py). A
    slot is eligible (``_Slot.spec_ok``, at admission, at a resume and
    for a fork sibling) under the JAX purity gates (no grammar, no logit
    bias, no penalties, no mirostat; the port has no multimodal input),
    greedy or sampled. While an eligible slot
    decodes with W = n_draft + 1 rows of headroom past its steps in
    flight, ``_dispatch_decode`` sends a SPEC TICK (``_plan_spec``, the
    JAX rule: decode_burst // W rounds at most, cut to the budget, the
    scheduler's ``burst_share`` and a power of two) in place of a plain
    burst: per round the spec rows propose D tokens from their ring,
    verify them in one continued ragged prefill (K2 / K2-int8) and
    accept greedily, while every other active slot takes the plain
    decode step in the same round (engine/decode_graph.py::spec_body; on
    the card one captured graph per sampler variant, a tick is R
    replays). With a draft model (``draft=(config, params)``, the
    runner's ``draft_model``) the proposals are its D + 1 greedy decode
    steps over the draft cache inside the same captured round (K1 / K3 /
    K4 at the draft's head shapes), and every pack with a speculating
    segment is mirrored into the draft cache right after the target's
    (the draft's ragged prefill over the same pack, a graph of its own
    per (bucket, continued); the split fused tick's pack too). The draft
    cache is allocated at construction, before ``start`` captures the
    graphs that read it (the JAX engine allocates it at the first
    eligible admission). Paged, it is a pool of the same page ids on the
    main page table, ONE ptab tensor shared with ``ck`` / ``cv``, so every
    page operation carries its planes: clone and copy-on-write
    (``_clone_page``), offload (``_dispatch_offload``: the draft pages
    gathered beside the target's, kept in the host entry as planes with
    a CRC of their own), restore and prefetch (``_upload_pages``; a hit
    without draft planes leaves its draft rows cold, which costs
    acceptance, never correctness). Contiguous, it is a block per slot: a
    request with a reused prefix or a resume does not speculate, and a
    fork sibling copies its leader's draft rows and speculates only if
    the leader did (the JAX gates). A sampled slot (temperature > 0)
    accepts by rejection sampling against the filtered window at each
    verify position (``sampling.verify_dist``, typical-p in the full
    variant; ``speculative.accept_sampled``), which keeps plain sampling's
    law; its counter RNG draws D + 1 uniforms a round whatever it
    accepts. Plain bursts and spec ticks chain on the same device state;
    the split fused tick's burst stays plain, as in JAX. A slot emits
    each round's accepted tokens plus the bonus, round by round; rows a
    rejected proposal wrote lie above its length: never committed, never
    in ``_cache_tokens`` or the prefix cache, never offloaded, and
    overwritten by the next round. ``metrics()["spec"]`` has the JAX
    counters, split ``by_mode`` into greedy and sampled by each slot's
    greedy flag when the tick was dispatched (``_Burst.spec_greedy``).

  * THE EMITTER THREAD (``emitter``, on by default as in the JAX engine;
    engine/emitter.py). The engine thread keeps the id-level control of
    emission (``_emit_ev``: EOS, max_tokens, the cache edge and context
    shift, ``cache_len`` / ``_cache_tokens`` / ``committed``, the release
    of the finishes it finds) and hands each processed pack, burst or
    spec tick's tokens to the worker as ONE batch (``_close_sink``); the
    worker detokenizes, scans for stop sequences, holds back partial
    stops and puts every event, in FIFO order per stream. A stop the
    worker finds comes back as a note, applied at the top of the next
    tick (``_apply_emitter_notes``): the slot is released, its later
    tokens in flight are dropped (the bursts' skip sets), a context
    shift's re-prefill queued after the stop goes with it, and
    ``committed`` is cut back to the rows before the stop token (a
    finish the engine found itself first keeps its rows: they hold the
    tokens' true KV). At the cache edge the engine shifts first and the
    worker scans the trigger token after, as in JAX, so a stop completing
    there reports the shift's reused rows. Failure and shutdown finals go
    through the worker's queue behind the stream's tokens (``_final``);
    a resumed request's stream continues on its paused snapshot's text
    state. A worker stuck longer than dispatch_stall_ms is replaced
    (``_check_emitter_wedge``, in the idle branch with the stall
    watchdog). ``emitter=False`` is the inline path (``_emit``), byte
    for byte what the port did before.
    THE TOP-OF-TICK DRAIN (the JAX loop's ``_drain_fifo(block=False)``
    before ``_admit``): with the emitter on, a tick applies the notes,
    then processes, in dispatch order and without waiting, every FIFO
    item whose results have already landed, and only then admits, so a
    request whose last burst landed while the loop was busy frees its
    slot, and leaves its rows to the prefix cache, before the next
    queued request is admitted. With the emitter off the order
    stays admit first, as in JAX. On the card "landed" is the item's CUDA
    event. On the CPU every dispatch has finished when it returns, and
    the loop models a busy card: a burst counts as landed only when the
    loop waits for it, so it is never processed early and the pipelined
    loop's hazards show on the CPU too (a pack is landed at once, as
    before). The one exception is a burst marked ``_Burst.landed_early``:
    a test stands in for the card's event with it, as the JAX tests' sync
    worker sets a ready flag, and the drains process it as landed.

  * OBSERVABILITY (the JAX engine's defaults; services/tracing.py,
    eventlog.py, metrics.py, kv_audit.py, sysobs.py). ``trace`` (on,
    ``trace_ring_size`` 4096): spans at the JAX record sites into a ring
    (queue_wait, admission, prefill_dispatch, prefill_device,
    finish_detect, prefill, decode_dispatch, decode_burst_device, the
    spec tick's spec_round / spec_draft / spec_verify (the split is
    analytic, as in JAX), per-slot decode, emit, stream_flush, request,
    offload / restore_dispatch, preempt, resume, tick, and the emitter's
    emit_bg / stream_flush_bg), read by ``metrics()["trace"]`` (with the
    host / device / emitter decomposition ``decomp_ms``) and
    ``trace_events()`` (Chrome trace JSON). A device span ends when the
    loop first sees the item's CUDA event complete (``Fetch.t_ready``);
    every span argument is host state the loop already has, so the tracer
    never reads a CUDA tensor. The latency histograms (ttft, itl,
    decode_burst, prefill_dispatch) with their worst-since-last-pull
    exemplars, and ``ttft_decomp_p50_ms``. The event ring ``EVENTS``
    (admit, complete, shed, timeout, preempt, resume, pool_pressure,
    emitter_wedge, kv_audit_violation, stall_dump, flight_dump,
    compile_storm; ``event_log`` adds a file or stderr sink). The KV
    lifecycle ledger and online auditor (``kv_audit`` "on"; "strict"
    raises, "off" builds nothing): the page pool, the prefix cache and
    the host store record their transitions, and the loop scans the
    invariants every 0.5 s between ticks (the prefetch pipeline's
    detached pages declared as extras), and once more, drained, at a
    shutdown with nothing running. The watermarks (also 0.5 s), goodput
    and MFU (``peak_tflops``), the compile tracker (a graph captured or a
    kernel library built after ``start``: a "compile storm"), the card's
    allocator counters and the flight recorder. A stalled dispatch writes
    the span ring to ``stall_dump_dir`` (``lifecycle.stall_dumps``) and a
    flight dump. ``state_snapshot()``, ``kv_debug()`` and
    ``kv_audit_sweep()`` serve /debug/state and /debug/kv
    (api/localai_routes.py).

  * GRAMMAR-CONSTRAINED DECODING (``GenRequest.grammar``, GBNF; the
    JAX engine's design; functions/grammars/). The grammar is compiled
    by the native runtime (native.py over csrc/grammar.cc, built with
    g++ at first use; no Python fallback) and its mask rides the
    sampler's bias: at admission the slot's row is the request's logit
    bias plus the initial state's penalty (0 where a token may follow,
    -1e9 elsewhere), so every token the pack or a decode step samples is
    masked on the device. Each emitted token advances the automaton on
    the engine thread (``_advance_grammar``, in ``_emit`` and
    ``_emit_ev`` alike: the emitter worker sees only tokens that stood);
    rows are memoized per state, and the slots whose row changed are
    written once per processed pack, burst or spec tick
    (``_flush_grammar_bias``), in stream order, before the next
    dispatch reads them. A grammar slot rides full bursts, so its steps
    after the first sample under a mask that is one state (in the
    pipelined loop, one burst) stale: a token the grammar rejects, or an
    EOS its mask forbids, ROLLS BACK (``_rollback_grammar``: lengths to
    the last valid row, the ring re-seeded, the slot overridden in the
    next dispatch and skipped whole in every burst in flight), and the
    step is recomputed under the fresh mask. A split fused tick whose
    group holds a grammar slot emits the head's first tokens before its
    burst goes out (the JAX order). A grammar slot never speculates,
    never forks and is never preempted (the JAX gates); across a context
    shift its automaton state carries on. ``metrics()["grammar"]``: the
    rollbacks, tokens, advance seconds, flushes and rows, and the mask
    memo's hits.

Left for later slices: the snap-back window, self-extend, the replica
pool (live migration) and the SLO engine.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import logging
import queue
import threading
import time
import uuid
import weakref
import zlib
from typing import Any, Iterator, Optional

import numpy as np
import torch

from localai_tpu_torch import resolve_device
from localai_tpu_torch.engine import sampling
from localai_tpu_torch.engine.decode_graph import DecodeGraph
from localai_tpu_torch.engine.detok import IncrementalDetokenizer
from localai_tpu_torch.engine.emitter import EmitterWorker
from localai_tpu_torch.engine.kv_offload import HostPageStore, PrefetchPipeline
from localai_tpu_torch.engine.paging import PagePool, PoolExhausted
from localai_tpu_torch.engine.prefill_graph import (
    PrefillGraph, eager_pack, new_pack, split_pack)
from localai_tpu_torch.engine.prefix_cache import PrefixPageCache, build_scope
from localai_tpu_torch.engine.scheduler import (
    PRIORITY_CLASSES, PRIORITY_RANK, ResumeEntry, Scheduler, normalize_priority,
    parse_priority_weights)
from localai_tpu_torch.engine.transfer import (
    Fetch, Stalled, numpy_of, pages_to_device, pages_to_host, tensor_of,
    to_device)
from localai_tpu_torch.functions.grammars.automaton import token_strings
from localai_tpu_torch.functions.grammars.native import (
    NativeGrammar, NativeMaskBuilder)
from localai_tpu_torch.models import llama
from localai_tpu_torch.ops import kvcache
from localai_tpu_torch.ops.ragged_prefill import kernel_supports
from localai_tpu_torch.services import sysobs
from localai_tpu_torch.services.eventlog import EVENTS
from localai_tpu_torch.services.faults import FAULTS
from localai_tpu_torch.services.kv_audit import KVAuditError, KVAuditor
from localai_tpu_torch.services.tracing import RingTracer, chrome_trace, dump_ring

log = logging.getLogger(__name__)

KV_LAYOUTS = ("auto", "paged", "contiguous")   # auto = paged
# draft values (the JAX engine's): auto = model with a draft model, else
# ngram; "model" without a draft model and the off words are off
DRAFT_MODES = ("auto", "model", "ngram", "0", "off", "none", "false")
# prefill_packed_fuse values (the JAX engine's): auto = split
PACKED_FUSE = ("auto", "0", "1", "split")
KV_AUDIT_MODES = ("off", "on", "strict")

# The engine's latency histograms (the JAX engine's buckets, in seconds),
# exposed by /metrics as Prometheus histograms
_HIST_BUCKETS = {
    "ttft_seconds": (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
                     2.5, 5.0, 10.0, 30.0),
    "itl_seconds": (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                    0.25, 0.5, 1.0),
    "decode_burst_seconds": (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                             0.1, 0.25, 0.5, 1.0, 2.5),
    "prefill_dispatch_seconds": (0.0005, 0.001, 0.0025, 0.005, 0.01,
                                 0.025, 0.05, 0.1, 0.25, 0.5, 1.0),
}


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
    # decode bursts in flight (module doc): 2 processes burst N while N+1
    # runs on the card; 1 waits for every burst
    pipeline_depth: int = 2
    # PACKED_FUSE (module doc): "split" (= "auto") chains a burst behind a
    # pack with final segments and emits their first tokens while it
    # runs; "1" emits them with the burst; "0" dispatches apart
    prefill_packed_fuse: str = "auto"
    # the host tier (module doc; needs the paged layout and
    # kv_prefix_cache): evicted chains are offloaded to host RAM and
    # restored at admission; False = the device tier alone
    kv_offload: bool = True
    # the host tier's byte budget in MiB (past it: LRU, host -> gone)
    kv_host_pool_mb: int = 256
    # save the host tier here at shutdown and load it at start ("" = no)
    kv_host_store_path: str = ""
    # queued requests whose host links the prefetch tick uploads ahead of
    # their admission; 0 = restore at admission only
    kv_prefetch_ahead: int = 2
    # --- the request lifecycle (module doc), the JAX names and defaults ---
    # admission control: submit() sheds (a structured "shed" event, 429 at
    # the HTTP layer) once this many requests wait for a slot; 0 = unbounded
    max_queued_requests: int = 256
    # queued requests that waited longer than this are shed at the next
    # admission tick; 0 = off
    max_queue_wait_ms: int = 0
    # per-request deadline from submit(): an expired request gets a
    # "timeout" event and is cancelled (slot and pages released); 0 = off
    request_timeout_ms: int = 0
    # the dispatch-stall watchdog: a pack or burst whose results have not
    # landed this long after max(its dispatch, the last landing) aborts
    # its own requests ("stall") and the engine keeps serving; 0 = wait
    # for ever
    dispatch_stall_ms: int = 30000
    # --- the preemptive priority scheduler (engine/scheduler.py) ---
    # priority-ordered admission, DRR prefill shares, shed fairness and
    # (paged) preemption: a higher class that cannot be admitted, or
    # cannot get pages, pauses the lowest-class slot, which resumes by
    # re-admission; False = strict FIFO admission
    preempt: bool = True
    # DRR weights of the high:normal:low classes' prefill shares
    priority_weights: str = "4:2:1"
    # one request is never preempted more than this many times
    max_preemptions: int = 2
    # free pages held back from fresh admissions while preempted requests
    # wait to resume; 0 = autosized from the preemption rate
    resume_reserve_pages: int = 0
    # the class of a request that names none (high | normal | low)
    priority: str = "normal"
    # queued / parked work older than this ranks one class higher; 0 = off
    priority_aging_ms: int = 4000
    # --- speculation (module doc), the JAX names and defaults ---
    # DRAFT_MODES: "auto" = the draft model when one is loaded, else
    # n-gram self-speculation; "0" / "off" = plain bursts only
    draft: str = "auto"
    # proposals per round (0 = off): a round verifies n_draft + 1 tokens
    n_draft: int = 4
    # the n-gram length prompt lookup matches against the slot's history
    spec_ngram: int = 3
    # the emitter thread (module doc): detokenization, stop sequences and
    # the stream puts off the engine thread; False = inline emission
    emitter: bool = True
    # --- observability (module doc), the JAX names and defaults ---
    # the span tracer; False makes every record a one-check no-op
    trace: bool = True
    trace_ring_size: int = 4096
    # log one WARNING with the timings of a request whose TTFT or
    # end-to-end time exceeds this many ms; 0 = off
    slow_request_ms: int = 0
    # where stall ring dumps and flight dumps land; "" = the temp dir
    stall_dump_dir: str = ""
    # the event log's write-through sink: a path, "stderr", or "" / "off"
    # (the ring only; the ring is always kept)
    event_log: str = ""
    # the file sink rotates at this size; 0 = never
    event_log_max_mb: int = 64
    # the card's peak TFLOP/s for MFU; 0 = LOCALAI_PEAK_TFLOPS or the
    # table by card name (services/sysobs.py); unknown reports MFU 0
    peak_tflops: float = 0.0
    # KV_AUDIT_MODES: the lifecycle ledger and online auditor ("on":
    # report only; "strict": a violation raises KVAuditError; "off":
    # nothing is built)
    kv_audit: str = "on"

    def check(self):
        """Refuse values the engine does not take (ValueError), before
        anything is loaded: the loop knobs, as the JAX model config
        refuses a prefill_packed_fuse outside its set, the layout, the
        host tier's budget and prefetch depth, and the lifecycle and
        scheduler knobs as the JAX model config checks them (non-negative
        ints, a known default class, three positive weights), and the
        speculation knobs (a known draft mode, n_draft >= 0, spec_ngram >=
        1), and the observability knobs (non-negative ints, kv_audit
        off | on | strict, peak_tflops a number >= 0)."""
        if str(self.prefill_packed_fuse) not in PACKED_FUSE:
            raise ValueError(f"prefill_packed_fuse must be "
                             f"{'|'.join(PACKED_FUSE)}, got "
                             f"{self.prefill_packed_fuse!r}")
        if (not isinstance(self.pipeline_depth, int)
                or isinstance(self.pipeline_depth, bool)
                or self.pipeline_depth < 1):
            raise ValueError(f"pipeline_depth must be an int >= 1, got "
                             f"{self.pipeline_depth!r}")
        if self.kv_layout not in KV_LAYOUTS:
            raise ValueError(f"kv_layout must be {'|'.join(KV_LAYOUTS)}, got "
                             f"{self.kv_layout!r}")
        for name, low in (("kv_host_pool_mb", 1), ("kv_prefetch_ahead", 0),
                          ("max_queued_requests", 0), ("max_queue_wait_ms", 0),
                          ("request_timeout_ms", 0), ("dispatch_stall_ms", 0),
                          ("max_preemptions", 0), ("resume_reserve_pages", 0),
                          ("priority_aging_ms", 0)):
            v = getattr(self, name)
            if not isinstance(v, int) or isinstance(v, bool) or v < low:
                raise ValueError(f"{name} must be an int >= {low}, got {v!r}")
        if str(self.priority).strip().lower() not in PRIORITY_RANK:
            raise ValueError(f"priority must be {'|'.join(PRIORITY_CLASSES)}, "
                             f"got {self.priority!r}")
        parse_priority_weights(self.priority_weights)
        if str(self.draft).strip().lower() not in DRAFT_MODES:
            raise ValueError(f"draft must be {'|'.join(DRAFT_MODES)}, got "
                             f"{self.draft!r}")
        for name, low in (("n_draft", 0), ("spec_ngram", 1),
                          ("trace_ring_size", 0), ("slow_request_ms", 0),
                          ("event_log_max_mb", 0)):
            v = getattr(self, name)
            if not isinstance(v, int) or isinstance(v, bool) or v < low:
                raise ValueError(f"{name} must be an int >= {low}, got {v!r}")
        if self.kv_audit not in KV_AUDIT_MODES:
            raise ValueError(f"kv_audit must be {'|'.join(KV_AUDIT_MODES)}, "
                             f"got {self.kv_audit!r}")
        if (isinstance(self.peak_tflops, bool)
                or not isinstance(self.peak_tflops, (int, float))
                or self.peak_tflops < 0):
            raise ValueError(f"peak_tflops must be a number >= 0, got "
                             f"{self.peak_tflops!r}")


@dataclasses.dataclass
class GenRequest:
    prompt_ids: list
    params: sampling.SamplingParamsHost = dataclasses.field(
        default_factory=sampling.SamplingParamsHost)
    max_new_tokens: int = 256
    stop_sequences: list = dataclasses.field(default_factory=list)
    ignore_eos: bool = False
    request_id: str = ""
    grammar: str = ""          # GBNF constrained decoding ("" = none)
    # priority class (high | normal | low); "" = the engine's default
    # (EngineConfig.priority); submit() normalizes it, an unknown value
    # degrades to the default
    priority: str = ""
    out: "queue.Queue" = None  # receives StreamEvent, then a None sentinel
    t_submit: float = 0.0      # stamped by submit()
    deadline: float = 0.0      # monotonic; stamped by submit() from request_timeout_ms

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
    # the lifecycle's failure kind, set with ``error``: "shed" | "timeout"
    # | "stall" (the runner maps it to 429 / 504 / 503)
    error_kind: Optional[str] = None
    # a crude client back-off hint (Retry-After at the HTTP layer)
    retry_after_s: float = 0.0


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
                 "reused", "prio", "preempts", "spec_ok", "shift_at",
                 "em_done", "resumed_from", "grammar", "gstate", "bias_base",
                 "cur_penalty")

    def __init__(self, req: GenRequest, detok, prompt_len: int):
        self.req = req
        self.detok = detok
        self.held_text = ""      # text withheld on a partial stop-sequence match
        self.prompt_len = prompt_len
        self.t_start = time.monotonic()
        self.t_first_token = 0.0
        self.n_decoded = 0
        self.t_prefill_ms = 0.0
        # "prefill" -> "decode"; a fork sibling starts in "fork_wait"
        self.phase = "prefill"
        self.pending: list = []  # prompt tokens not yet prefilled
        self.written = 0         # cache rows holding this request's tokens
        self.cache_len = 0       # rows the next decode step writes at
        self.committed = 0       # rows whose KV write has run
        self.reused = 0          # prompt rows reused from earlier requests
        self.prio = PRIORITY_RANK.get(req.priority, PRIORITY_RANK["normal"])
        self.preempts = 0        # times this request was paused
        self.spec_ok = False     # may take spec rounds (Engine._spec_eligible)
        self.shift_at = -1       # n_decoded at the last context shift
        # the emitter's (engine/emitter.py): the stream is closed; the
        # paused snapshot this resumed request continues
        self.em_done = False
        self.resumed_from = None
        # grammar-constrained decoding (Engine._grammar_for): the compiled
        # grammar, its current state, the request's logit-bias row under
        # the mask, and the mask row last flushed (identity-compared)
        self.grammar = None
        self.gstate = None
        self.bias_base = None
        self.cur_penalty = None


class _DispatchStall(Exception):
    """A dispatched pack or burst whose results did not land within
    dispatch_stall_ms (``Engine._wait_ready``, ``_check_parked_stall``):
    carries the item, so ``_handle_stall`` aborts exactly its requests."""

    def __init__(self, item):
        super().__init__("device dispatch stalled")
        self.item = item


class _Pack:
    """A dispatched pack with final segments, awaiting its first tokens
    (the JAX engine's _PendingPrefill). ``group``: the finals' (slot,
    _Slot) in pack row order. A ``split`` pack is the head of a fused
    tick: its slots were switched to decode at dispatch and ``burst`` is
    the burst chained behind it."""
    __slots__ = ("group", "fetch", "t0", "split", "burst", "processed",
                 "faults_seen")

    def __init__(self, group, fetch: Fetch, t0: float, split: bool = False):
        self.group = group
        self.fetch = fetch
        self.t0 = t0
        self.split = split
        self.burst = None
        self.processed = False
        self.faults_seen = False   # the sync fault hooks ran (_sync_faults)


class _Burst:
    """A dispatched decode burst awaiting processing (the JAX engine's
    _Burst). ``slots``: the (slot, _Slot) it decodes, snapshotted at
    dispatch; ``group`` / ``head``: a fused tick's finals and its pack;
    ``skip``: slots whose tokens in it must be dropped (context-shifted
    after the dispatch). A spec tick has ``spec_width`` W > 0 (its
    ``n_steps`` are rounds), ``spec_mask`` [S], the slots that took spec
    rounds, and ``spec_greedy`` [S], the slots' greedy flags at dispatch
    (which acceptance each spec row ran). ``landed_early``: on the CPU,
    that the burst counts as landed before the loop waits for it (module
    doc, the top-of-tick drain)."""
    __slots__ = ("n_steps", "slots", "fetch", "group", "head", "skip", "t0",
                 "faults_seen", "spec_mask", "spec_width", "spec_greedy",
                 "landed_early")

    def __init__(self, n_steps: int, slots: list, fetch: Fetch, t0: float,
                 group=(), head: Optional[_Pack] = None):
        self.n_steps = n_steps
        self.slots = slots
        self.fetch = fetch
        self.t0 = t0
        self.group = list(group)
        self.head = head
        self.skip: set = set()
        self.faults_seen = False
        self.spec_mask: Optional[np.ndarray] = None
        self.spec_width = 0
        self.spec_greedy: Optional[np.ndarray] = None
        self.landed_early = False


def _tensors(tree):
    """Every tensor of a nested dict / list / tuple (the weights)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _host_pages(rows) -> list:
    """Per page, the pinned host copy of gathered pages (transfer.
    pages_to_host; int8: a {"q", "s"} dict per page)."""
    if isinstance(rows, dict):
        leaves = {k: pages_to_host(t) for k, t in rows.items()}
        return [{k: leaves[k][i] for k in leaves}
                for i in range(len(next(iter(leaves.values()))))]
    return pages_to_host(rows)


def _numpy_page(page):
    """A host page's numpy view (int8: per leaf; bf16 as uint16)."""
    if isinstance(page, dict):
        return {k: numpy_of(t) for k, t in page.items()}
    return numpy_of(page)


def _tensor_page(arrays):
    """A host page as CPU tensors over its arrays (no copy)."""
    if isinstance(arrays, dict):
        return {k: tensor_of(a) for k, a in arrays.items()}
    return tensor_of(arrays)


class _PendingOffload:
    """Evicted pages gathered on the card, awaiting their copy to the host
    (the JAX engine's): the offload worker copies each page into a pinned
    host tensor of its own, on the engine's stream, waits for the copies,
    then puts each page into the host store, its arrays views of those
    tensors. The gathered rows are a snapshot no later dispatch writes,
    so the copies may queue behind anything. ``metas``: (key, parent,
    depth) per page; ``k`` / ``v``: the gathered [L, n, ...] rows
    (gather_pages); ``dk`` / ``dv``: the draft cache's rows of the same
    pages, or None; ``stream``: the engine's CUDA stream (None on the
    CPU)."""

    __slots__ = ("metas", "k", "v", "dk", "dv", "stream", "store")

    def __init__(self, metas, k, v, stream, store: HostPageStore, dk=None,
                 dv=None):
        self.metas = metas
        self.k = k
        self.v = v
        self.dk = dk
        self.dv = dv
        self.stream = stream
        self.store = store

    def _copy(self) -> list:
        planes = [self.k, self.v] + ([self.dk, self.dv] if self.dk is not None
                                     else [])
        return [_host_pages(p) for p in planes]

    def run(self, stats: dict):
        if self.stream is not None:
            with torch.cuda.stream(self.stream):
                planes = self._copy()
                event = torch.cuda.Event()
                event.record()
            event.synchronize()
        else:
            planes = self._copy()
        self.k = self.v = self.dk = self.dv = None   # the snapshot on the card goes
        t0 = time.perf_counter()
        for i, (key, parent, depth) in enumerate(self.metas):
            kp, vp = planes[0][i], planes[1][i]
            draft = {}
            if len(planes) == 4:
                dkp, dvp = planes[2][i], planes[3][i]
                draft = {"dk": _numpy_page(dkp), "dv": _numpy_page(dvp),
                         "dsrc": (dkp, dvp)}
            self.store.put(key, parent, depth, _numpy_page(kp), _numpy_page(vp),
                           src=(kp, vp), **draft)
        stats["batches"] += 1
        stats["pages"] += len(self.metas)
        stats["seconds"] += time.perf_counter() - t0


class _PendingPrefetch:
    """A prefetch upload in flight (the JAX engine's): the worker waits
    for the event recorded after it, then retires the store's inflight
    count."""

    __slots__ = ("event", "store")

    def __init__(self, event, store: HostPageStore):
        self.event = event
        self.store = store

    def run(self, stats: dict):
        if self.event is not None:
            self.event.synchronize()
        self.store.note_prefetch_done()


class _OffloadWorker:
    """The host tier's worker thread (the JAX sync worker's offload
    branch): runs _PendingOffload / _PendingPrefetch items one at a time,
    in dispatch order, so the engine thread never waits for a device ->
    host copy or spends a CRC on an insert. A failed item is logged and
    only loses its copy. ``stats``: batches, pages and the host seconds
    spent after the copies landed (the CRC and the insert)."""

    def __init__(self):
        self._q: "queue.Queue" = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self.stats = {"batches": 0, "pages": 0, "seconds": 0.0}

    def put(self, item):
        if self._thread is None:
            self._thread = threading.Thread(target=self._run, name="kv-offload",
                                            daemon=True)
            self._thread.start()
        self._q.put(item)

    def join(self):
        """Wait until every item queued so far has run."""
        self._q.join()

    def close(self):
        """Run what is queued, then stop the thread."""
        if self._thread is not None:
            self._q.put(None)
            self._thread.join(timeout=120)
            self._thread = None

    def _run(self):
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                item.run(self.stats)
            except Exception:   # a lost copy: the chain re-prefills later
                log.exception("kv page offload failed")
            finally:
                self._q.task_done()


class Engine:
    """Owns the model state on one device and a background loop thread."""

    def __init__(self, model_cfg: llama.LlamaConfig, params: dict, tokenizer,
                 engine_cfg: Optional[EngineConfig] = None, device="cuda",
                 draft: Optional[tuple] = None):
        self.device = resolve_device(device)
        self.cfg = model_cfg
        self.ecfg = engine_cfg or EngineConfig()
        self.params = params
        # the draft model (the JAX engine's ``draft``): (LlamaConfig,
        # params), or None
        self.draft_cfg, self.draft_params = draft if draft else (None, None)
        self.tokenizer = tokenizer
        S, C = self.ecfg.num_slots, self.ecfg.max_context
        self.ecfg.check()
        self.kv_layout = ("contiguous" if self.ecfg.kv_layout == "contiguous"
                          else "paged")
        self.cache_dtype = self.ecfg.cache_dtype or model_cfg.dtype
        self._pool: Optional[PagePool] = None    # None: contiguous layout
        pg = 0                                   # 0: contiguous (init_cache)
        if self.kv_layout == "paged":
            pg = max(1, min(self.ecfg.kv_page_size, C))
            while C % pg:         # the page size must divide the context
                pg -= 1
            pool_pages = self.ecfg.kv_pool_pages
            full = S * (C // pg)
            if (pool_pages == 0 and self.ecfg.kv_prefix_cache
                    and self.ecfg.kv_offload and full >= 64):
                # the JAX rule: with the host tier absorbing evictions a
                # serving-sized default pool shrinks by a quarter; pools
                # under 64 pages keep the full reservation
                pool_pages = max(full * 3 // 4, S + C // pg)
            self._pool = PagePool(S, C, pg, pool_pages)
        self._reuse = bool(self.ecfg.kv_prefix_cache)
        self._pcache: Optional[PrefixPageCache] = None
        self._hstore: Optional[HostPageStore] = None
        self._prefetch: Optional[PrefetchPipeline] = None
        self._offloader = _OffloadWorker()
        if self._reuse and self._pool is not None:
            scope = build_scope("llama", model_cfg, pg, self.cache_dtype)
            self._pcache = PrefixPageCache(scope, pg)
            if self.ecfg.kv_offload:
                # the scope doubles as the saved file's model check
                self._hstore = HostPageStore(scope, pg,
                                             self.ecfg.kv_host_pool_mb)
                path = self.ecfg.kv_host_store_path
                if path:
                    n = self._hstore.load(path)
                    if n:
                        log.info("kv host store: reloaded %d offloaded pages "
                                 "from %s", n, path)
                if self.ecfg.kv_prefetch_ahead > 0:
                    self._prefetch = PrefetchPipeline()
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
        # speculation's mode (the JAX resolution): auto is the draft model
        # when one is loaded, else n-gram self-speculation; "model" without
        # a draft model is off; n_draft 0 is off
        d = str(self.ecfg.draft).strip().lower()
        has_draft = self.draft_params is not None
        mode = {"auto": "model" if has_draft else "ngram", "ngram": "ngram",
                "model": "model" if has_draft else "off"}.get(d, "off")
        self._spec_mode = mode if self.ecfg.n_draft > 0 else "off"
        self._spec_width = (self.ecfg.n_draft + 1
                            if self._spec_mode != "off" else 0)
        # the draft cache (module doc): allocated here, before start()
        # captures the graphs that read it, where the JAX engine allocates
        # it at the first eligible admission. Paged, its pool rides the
        # main page table: the SAME ptab tensor, which _commit_ptab
        # rewrites in place
        self.dck = self.dcv = None
        draft_state = None
        if self._spec_mode == "model":
            self.dck, self.dcv = llama.init_cache(
                self.draft_cfg, S, C, pg,
                self._pool.num_pages if self._pool else 0,
                dtype=self.cache_dtype, device=self.device)
            if self._pool is not None:
                self.dck["ptab"] = self.dcv["ptab"] = self.ck["ptab"]
            draft_state = (self.draft_params, self.draft_cfg, self.dck, self.dcv)
        self._graph = DecodeGraph(params, model_cfg, self.ck, self.cv,
                                  self.sampler, S, self.ecfg.decode_burst,
                                  self.device, spec_width=self._spec_width,
                                  ngram=self.ecfg.spec_ngram, draft=draft_state)
        # dispatches: spec ticks; mixed_dispatches: those that also carried
        # plain rows; rounds / proposed / accepted / tokens: per-slot round
        # totals (tokens = emitted, accepted + bonus); by_mode the same per
        # acceptance mode (the JAX engine's: greedy / rejection-sampled)
        self._spec_stats = {"dispatches": 0, "mixed_dispatches": 0,
                            "rounds": 0, "proposed": 0, "accepted": 0,
                            "tokens": 0,
                            "by_mode": {m: {"rounds": 0, "proposed": 0,
                                            "accepted": 0, "tokens": 0}
                                        for m in ("greedy", "sampled")}}
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
                                    self.device, draft=draft_state)
        self._sink: Optional[dict] = None   # per-slot event coalescing
        # the span tracer (module doc): always built; trace=False makes
        # record() a no-op (the emitter's spans go into it too)
        self.tracer = RingTracer(self.ecfg.trace_ring_size,
                                 enabled=bool(self.ecfg.trace))
        # the emitter thread (module doc): the tick's token batch, the
        # notes of the stops it found, the worker (None: inline emission)
        self._em_batch: dict = {}
        self._em_notes: list = []
        self._em_lock = threading.Lock()
        self._emitter = self._make_emitter() if self.ecfg.emitter else None
        # the pipelined loop (module doc): dispatched _Pack / _Burst items
        # in dispatch order; slots whose decode state the next burst takes
        # from the host mirrors; fork siblings by their leader's _Slot
        self._fifo: collections.deque = collections.deque()
        self._override: set = set()
        # grammar-constrained decoding (module doc): compiled grammars by
        # text, the native mask builder over the vocabulary (built at the
        # first grammar request), the grammar slots whose mask row changed
        # since the last flush, the rollbacks (the JAX engine's
        # ``_rollbacks``) and the counters of metrics()["grammar"] (tokens
        # that stood, host seconds advancing the automata, flushes and
        # the rows they wrote)
        self._grammar_cache: dict = {}
        self._mask_builder: Optional[NativeMaskBuilder] = None
        self._token_strs: list = []
        self._gbias_flush: set = set()
        self._rollbacks = 0
        self._grammar_stats = {"tokens": 0, "advance_s": 0.0, "flushes": 0,
                               "rows_flushed": 0}
        self._fork_waiters: dict = {}
        self._fuse = {"0": "off", "1": "mono"}.get(
            str(self.ecfg.prefill_packed_fuse), "split")
        self._t_last_burst = 0.0
        # max_inflight: the most bursts in flight at once; head_emits:
        # first tokens a split head emitted before its burst was read
        # (head_emits_running: while the card still ran it); dropped_steps:
        # slot-steps computed for a slot that had finished, shifted or
        # been cancelled
        self._pipe_stats = {"max_inflight": 0, "head_emits": 0,
                            "head_emits_running": 0, "dropped_steps": 0}
        # siblings: requests that waited on a leader; forked: those that
        # took its rows (rows_shared in all); downgraded: full prefills
        self._fork_stats = {"siblings": 0, "forked": 0, "downgraded": 0,
                            "rows_shared": 0}
        # counters exposed by metrics(); pad_tokens counts the bucket's pad
        # rows; kernel_fallback counts packs whose head shapes the K2
        # kernel cannot take — it must stay 0 ("seconds", host wall: a
        # pack's dispatch, and for one with finals until its first tokens
        # were read; a burst's dispatch until it was read, less the
        # overlap with the burst read before it)
        self._pack_stats = {"dispatches": 0, "tokens": 0, "segments": 0,
                            "pad_tokens": 0, "continued": 0,
                            "kernel_fallback": 0, "seconds": 0.0}
        # full_steps: steps of the full sampler variant; a spec tick counts
        # its rounds as steps (each runs one decode step), and spec_ticks /
        # spec_rounds count the spec ticks' alone
        self._decode_stats = {"bursts": 0, "steps": 0, "full_steps": 0,
                              "tokens": 0, "seconds": 0.0, "spec_ticks": 0,
                              "spec_rounds": 0}
        # the request lifecycle (module doc): its counters (submit() runs
        # on other threads, hence the lock); the last landing the loop saw
        # (the stall watchdog measures from max(dispatch, this)); the idle
        # wait, short enough for the watchdog's cadence
        self._lc = {"requests_shed": 0, "requests_timed_out": 0, "stalls": 0,
                    "preemptions": 0}
        self._lc_lock = threading.Lock()
        self._submit_lock = threading.Lock()
        self._t_last_ready = 0.0
        stall_s = self.ecfg.dispatch_stall_ms / 1e3
        self._idle_wait_s = min(1.0, stall_s / 4) if stall_s > 0 else 1.0
        # the scheduler (engine/scheduler.py); None = strict FIFO
        self._default_prio = normalize_priority(self.ecfg.priority)
        self._sched: Optional[Scheduler] = None
        if self.ecfg.preempt:
            self._sched = Scheduler(
                parse_priority_weights(self.ecfg.priority_weights),
                max_preemptions=self.ecfg.max_preemptions,
                aging_ms=float(self.ecfg.priority_aging_ms))
        # resume_reserve_pages autosize: EWMA of preemptions per minute x
        # pages retained per preemption, the reserve when the knob is 0
        self._preempt_marks: collections.deque = collections.deque(maxlen=256)
        self._preempt_rate_ewma = 0.0
        self._preempt_pages_ewma = 0.0
        self._reserve_auto = 0
        self._t_reserve_sample = time.monotonic()
        self._init_observability()

    def _init_observability(self):
        """The observability state (module doc), the JAX engine's."""
        self.replica_id = 0
        self._load_time = time.monotonic()
        self._slow_ms = float(self.ecfg.slow_request_ms)
        # the latency histograms: name -> [bucket counts + +Inf, sum, n];
        # one writer (the engine thread), metrics() reads snapshots
        self._hists = {name: [[0] * (len(b) + 1), 0.0, 0]
                       for name, b in _HIST_BUCKETS.items()}
        # the worst observation per histogram since the last metrics() pull,
        # with its request id (the /metrics exemplar)
        self._hist_worst: dict = {}
        # per finished request (queue_wait, admit_to_first, prefill) ms,
        # the last 512: metrics()["ttft_decomp_p50_ms"]
        self._ttft_decomp: collections.deque = collections.deque(maxlen=512)
        self._decomp_lock = threading.Lock()
        self._lc["stall_dumps"] = 0
        if self.ecfg.event_log:
            EVENTS.configure(self.ecfg.event_log,
                             max_mb=self.ecfg.event_log_max_mb)
        # a graph captured or a kernel library built after start() is a
        # compile storm (services/sysobs.py)
        self._cobs = sysobs.CompileTracker(
            model="llama", on_storm=lambda rec: EVENTS.emit("compile_storm",
                                                            **rec))
        self._wm = sysobs.Watermarks()
        self._weight_bytes = int(sum(
            t.numel() * t.element_size() for t in _tensors(self.params)))
        peak = (self.ecfg.peak_tflops * 1e12 if self.ecfg.peak_tflops > 0
                else (sysobs.peak_device_flops()
                      if self.device.type == "cuda" else 0.0))
        self._goodput = sysobs.GoodputMeter(
            flops_per_tok=sysobs.flops_per_token(
                self.cfg, ctx=self.ecfg.max_context // 2),
            peak_flops=peak)
        self._flight = sysobs.FlightRecorder(self.ecfg.stall_dump_dir)
        # the card's allocator counters at the last sample ({} on the CPU)
        self._device_mem: dict = {}
        self._pool_pressure = False     # hysteresis of pool_pressure events
        self._t_wm = 0.0                # the last housekeeping pass
        # the lifecycle ledger and auditor: kv_audit "off" (or the
        # contiguous layout) builds nothing, and every hook in the pool,
        # the prefix cache and the host store stays one `is not None`
        self._kv_audit: Optional[KVAuditor] = None
        if self._pool is not None and self.ecfg.kv_audit != "off":
            aud = KVAuditor(mode=self.ecfg.kv_audit, replica=self.replica_id,
                            seed=self.replica_id)
            # through a weak reference: the pool holds the auditor, and a
            # cycle back to the engine would keep a shut-down engine's
            # weights until the cycle collector ran
            ref = weakref.ref(self)

            def on_violation(v, ref=ref):
                eng = ref()
                if eng is not None:
                    eng._on_kv_violation(v)

            aud.on_violation = on_violation
            self._pool.audit = aud
            if self._pcache is not None:
                self._pcache.audit = aud
            if self._hstore is not None:
                self._hstore.audit = aud
            self._kv_audit = aud

    # ---------- lifecycle ----------

    def start(self):
        """Start the engine thread. On the card it first captures the
        decode step's graph and the prefill graphs (as the JAX engine
        precompiles its bursts and packs); start returns once that is
        done and raises if it failed. From then on a capture or a kernel
        build is a compile storm (services/sysobs.py)."""
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
            self._cobs.mark_warm()
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
        # nothing running, queued or parked: the pool must balance to zero
        drained = (self.num_active == 0 and self._queue.qsize() == 0
                   and not (self._sched and self._sched.resume_depth))
        self._fifo.clear()
        self._fork_waiters.clear()
        err = StreamEvent(token_id=-1, text="", logprob=0.0,
                          finish_reason="stop", error="engine shut down")
        for i, s in enumerate(self.slots):
            if s is not None:
                self._final(i, s, [err, None])
                self._release_slot(i)
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            req.out.put(err)
            req.out.put(None)
        for entry in self._sched.drain_parked() if self._sched else ():
            self._final_parked(entry, [err, None])
        if self._emitter is not None:
            self._emitter.stop(timeout=5.0)
        # the offloads in flight land in the store before it is saved
        self._offloader.close()
        if self._hstore is not None and self.ecfg.kv_host_store_path:
            self._hstore.save(self.ecfg.kv_host_store_path)
        if self._kv_audit is not None and drained:
            self._drained_audit()

    def _drained_audit(self):
        """The post-drain audit (the JAX engine's, at shutdown when nothing
        was cut off): free slots' retained tables are released, the
        prefix cache evicted, and the pool must balance to zero (every
        page free, every hold dropped, the ledger agreeing). The prefetch
        pipeline's pages are given back first (JAX declares them extras,
        but a drained pool must hold none). Strict mode raises out of
        shutdown by design."""
        try:
            self._drop_prefetched()
            for i, s in enumerate(self.slots):
                if s is None and self._pool.owned[i]:
                    self._pool.release(i, 0)
                    self._cache_tokens[i] = []
            if self._pcache is not None:
                self._pcache.evict(self._pool, self._pool.num_pages)
            self._kv_audit_tick(drained=True)
        except KVAuditError:
            raise
        except Exception:
            log.exception("post-drain kv audit failed")

    def cancel(self, request_id: str):
        """Cancel a queued or running request (the JAX engine's
        ``cancel``). Thread-safe: it notes the id and wakes the loop. At the
        next step or burst boundary a running slot with that id is released
        and its output queue gets the None sentinel; a queued or parked
        (preempted) request with that id is dropped (its queue gets only the
        sentinel). A burst already on the device finishes first."""
        with self._cancel_lock:
            self._cancelled.add(request_id)
        self._wake.set()

    def submit(self, req: GenRequest) -> "queue.Queue":
        """Queue a request (the JAX engine's ``submit``): its priority
        normalized, its deadline stamped; at a full queue
        (max_queued_requests) a structured "shed" event instead, to the
        longest-queued request of a class strictly below the newcomer's
        if the scheduler finds one, else to the newcomer."""
        req.t_submit = time.monotonic()
        req.priority = normalize_priority(req.priority, self._default_prio)
        with self._submit_lock:         # the bound holds for racing submits
            return self._submit_locked(req)

    def _submit_locked(self, req: GenRequest) -> "queue.Queue":
        maxq = self.ecfg.max_queued_requests
        if maxq > 0 and self._queue.qsize() >= maxq:
            victim = None
            if self._sched is not None:
                with self._queue.mutex:
                    queued = [(r.priority, r.t_submit, r)
                              for r in self._queue.queue]
                victim = self._sched.pick_shed_victim(
                    PRIORITY_RANK[req.priority], queued)
                if victim is not None and not self._pop_queued(victim):
                    victim = None           # admitted meanwhile
            if victim is None:
                self._shed(req, f"server overloaded: {maxq} requests "
                                f"already queued (max_queued_requests)")
                return req.out
            self._shed(victim,
                       f"displaced by a {req.priority}-priority arrival "
                       f"(queue full at {maxq}; longest-queued "
                       f"{victim.priority} request shed)")
        if self.ecfg.request_timeout_ms > 0:
            req.deadline = req.t_submit + self.ecfg.request_timeout_ms / 1e3
        self._queue.put(req)
        self._wake.set()
        return req.out

    def _retry_after_hint(self) -> float:
        """A crude client back-off from the queue depth: about one
        request per slot per second, at least 1 s (a monotone signal,
        not a forecast)."""
        return max(1.0, round(self._queue.qsize()
                              / max(1, self.ecfg.num_slots), 1))

    def _shed(self, req: GenRequest, reason: str):
        with self._lc_lock:
            self._lc["requests_shed"] += 1
        EVENTS.emit("shed", rid=req.request_id, reason=reason,
                    queued=self._queue.qsize())
        req.out.put(StreamEvent(
            token_id=-1, text="", logprob=0.0, finish_reason="stop",
            error=reason, error_kind="shed",
            retry_after_s=self._retry_after_hint()))
        req.out.put(None)

    def _timeout_event(self, req: GenRequest) -> StreamEvent:
        with self._lc_lock:
            self._lc["requests_timed_out"] += 1
        EVENTS.emit("timeout", rid=req.request_id,
                    timeout_ms=self.ecfg.request_timeout_ms)
        return StreamEvent(
            token_id=-1, text="", logprob=0.0, finish_reason="stop",
            error=(f"request deadline exceeded "
                   f"({self.ecfg.request_timeout_ms} ms)"),
            error_kind="timeout")

    def _pop_queued(self, req: GenRequest) -> bool:
        """Take ``req`` out of the queue; False when it is gone already
        (admitted, reaped or displaced meanwhile)."""
        with self._queue.mutex:
            try:
                self._queue.queue.remove(req)
                return True
            except ValueError:
                return False

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
        """The engine's counters and gauges: the port's own keys, and the
        JAX engine's keys that /metrics (api/localai_routes.py) reads,
        under the JAX names (slots_total / slots_active, prefill_packed,
        kv_pages_*, histograms, trace, sysobs, flight_recorder, kv_audit,
        hist_exemplars: the worst observations since the last pull)."""
        n_active = self.num_active
        out = {"num_slots": self.ecfg.num_slots,
               "active_slots": n_active,
               "slots_total": self.ecfg.num_slots,
               "slots_active": n_active,
               "replica_id": self.replica_id,
               "uptime_s": time.monotonic() - self._load_time,
               "queued": self._queue.qsize(),
               # the port always packs its prompts (the JAX default)
               "prefill_packed": True,
               "prefill_packed_fuse": str(self.ecfg.prefill_packed_fuse),
               "prefill_token_budget": self._pack_budget,
               "kv_layout": self.kv_layout,
               "cache_dtype": str(self.cache_dtype).replace("torch.", ""),
               "packed_prefill": dict(self._pack_stats),
               "decode": dict(self._decode_stats),
               "decode_graph": {"captured": sorted(self._graph.graphs),
                                "spec_captured": sorted(self._graph.spec_graphs),
                                "capture_seconds": self._graph.capture_seconds,
                                "pool_bytes": self._graph.pool_bytes},
               "prefill_graph": {"captured": sorted(self._pgraph.graphs),
                                 "buckets": list(self._pack_buckets),
                                 "capture_seconds": self._pgraph.capture_seconds,
                                 "pool_bytes": self._pgraph.pool_bytes,
                                 "draft_captured": sorted(self._pgraph.dgraphs),
                                 "draft_capture_seconds":
                                     self._pgraph.draft_capture_seconds,
                                 "draft_pool_bytes": self._pgraph.draft_pool_bytes}}
        out["pipeline"] = {"depth": self.ecfg.pipeline_depth,
                           "fuse": self._fuse, "inflight": self._n_inflight(),
                           **self._pipe_stats}
        out["fork"] = dict(self._fork_stats)
        mb = self._mask_builder
        out["grammar"] = {**self._grammar_stats, "rollbacks": self._rollbacks,
                          "grammars_cached": len(self._grammar_cache),
                          "memo_hits": mb.hits if mb is not None else 0,
                          "memo_misses": mb.misses if mb is not None else 0}
        em = self._emitter
        out["emitter"] = ({"enabled": True, "alive": em.alive,
                           "queued": em.qsize(), "emitted": em.emitted}
                          if em is not None else {"enabled": False})
        # speculation (the JAX engine's keys): the counters and two rates,
        # acceptance (accepted / proposed) and emitted tokens per slot-round
        # (1.0: speculation buys nothing)
        st = self._spec_stats
        out["spec"] = {
            "mode": self._spec_mode, "n_draft": self.ecfg.n_draft,
            **{k: v for k, v in st.items() if k != "by_mode"},
            "acceptance_rate": (st["accepted"] / st["proposed"]
                                if st["proposed"] else 0.0),
            "accept_per_dispatch": (st["tokens"] / st["rounds"]
                                    if st["rounds"] else 0.0),
            "by_mode": {m: {**c,
                            "acceptance_rate": (c["accepted"] / c["proposed"]
                                                if c["proposed"] else 0.0),
                            "accept_per_dispatch": (c["tokens"] / c["rounds"]
                                                    if c["rounds"] else 0.0)}
                        for m, c in st["by_mode"].items()}}
        out["prompt_tokens_reused"] = self._reuse_stats["reused_rows"]
        # the lifecycle's counters and limits (the JAX engine's keys)
        with self._lc_lock:
            lc = dict(self._lc)
        for k in ("max_queued_requests", "max_queue_wait_ms",
                  "request_timeout_ms", "dispatch_stall_ms"):
            lc[k] = getattr(self.ecfg, k)
        lc["queue_limit_effective"] = self.ecfg.max_queued_requests
        out["lifecycle"] = lc
        out["queue_limit"] = self.ecfg.max_queued_requests
        out["scheduler"] = self._scheduler_metrics()
        if self._pool is not None:
            pool = self._pool
            # the running requests' pages and any leaked reference: a free
            # slot's retained rows and the prefix cache's are not in use,
            # so this is 0 at idle unless a page leaked
            out["pages_in_use"] = pool.pages_beyond(
                [i for i, s in enumerate(self.slots) if s is None],
                extra=self._prefetched_pages())
            out["pages_total"] = pool.num_pages
            out["kv_page_size"] = pool.page_size
            out["kv_pages_total"] = pool.num_pages
            out["kv_pages_in_use"] = pool.pages_in_use
            out["kv_pages_shared"] = int((pool.refs > 1).sum())
            out["kv_pages_free"] = pool.free_pages
            out["kv_pages_retained"] = pool.retained_pages
            out["kv_pages_active"] = pool.active_pages
            out["kv_pool_oversubscription"] = round(pool.oversubscription, 4)
            if self._kv_audit is not None:
                out["kv_audit"] = self._kv_audit.snapshot()
            if self._pcache is not None:
                out["prefix_cache"] = {**self._pcache.stats(),
                                       "cow_clones": self._reuse_stats["cow_clones"]}
            if self._hstore is not None:
                out["kv_pages_offloaded"] = self._hstore.pages
                out["kv_offload"] = self._hstore.stats()
                out["kv_offload_worker"] = dict(self._offloader.stats)
        with self._decomp_lock:
            d = list(self._ttft_decomp)
        if d:
            qw, af, pf = (sorted(x[i] for x in d) for i in range(3))
            mid = len(d) // 2
            out["ttft_decomp_p50_ms"] = {
                "queue_wait": round(qw[mid], 1),
                "admit_to_first": round(af[mid], 1),
                "prefill_dispatch": round(pf[mid], 1),
                "n": len(d)}
        out["histograms"] = {
            name: {"le": list(_HIST_BUCKETS[name]), "counts": list(h[0]),
                   "sum": round(h[1], 6), "count": h[2]}
            for name, h in self._hists.items()}
        out["trace"] = self.tracer.summary()
        self._sample_watermarks()
        sys_obs = {"compiles": self._cobs.snapshot(),
                   "watermarks": self._wm.snapshot(),
                   "goodput": self._goodput.snapshot(),
                   "weight_bytes": self._weight_bytes}
        if self._pool is not None:
            sys_obs["fragmentation"] = self._pool.fragmentation()
        if self._device_mem:
            sys_obs["device_mem"] = dict(self._device_mem)
        out["sysobs"] = sys_obs
        out["flight_recorder"] = self._flight.snapshot()
        # consumed: each pull sees its interval's worst observation
        worst, self._hist_worst = self._hist_worst, {}
        if worst:
            out["hist_exemplars"] = {
                name: {"value": round(v, 6), "trace_id": rid, "ts": ts}
                for name, (v, rid, ts) in worst.items()}
        return out

    # ---------- observability (module doc) ----------

    def _hobserve(self, name: str, seconds: float, rid: str = ""):
        """One latency observation into histogram ``name``; with ``rid``,
        the worst since the last metrics() pull is kept as its exemplar."""
        h = self._hists[name]
        for i, b in enumerate(_HIST_BUCKETS[name]):
            if seconds <= b:
                h[0][i] += 1
                break
        else:
            h[0][-1] += 1
        h[1] += seconds
        h[2] += 1
        if rid:
            worst = self._hist_worst.get(name)
            if worst is None or seconds > worst[0]:
                self._hist_worst[name] = (seconds, rid, time.time())

    def _sample_watermarks(self):
        """Fold the gauges into the high-water marks (housekeeping, every
        admission and every metrics() pull), read the card's allocator
        counters, and emit pool_pressure when the free share falls under
        5% (once per excursion: cleared above 10%)."""
        wm = {"queued": self._queue.qsize(), "slots_active": self.num_active,
              "tokens_total": self._decode_stats["tokens"]}
        dm = sysobs.device_memory_stats(self.device)
        if dm:
            self._device_mem = dm
            wm["device_bytes_in_use"] = dm.get("bytes_in_use", 0)
        pool = self._pool
        if pool is not None:
            wm["pool_active_pages"] = pool.active_pages
            wm["pool_retained_pages"] = pool.retained_pages
            wm["pool_pages_in_use"] = pool.pages_in_use
            if self._hstore is not None:
                wm["host_offloaded_pages"] = self._hstore.pages
                wm["host_bytes"] = self._hstore.bytes_used
            free_frac = pool.free_pages / max(1, pool.num_pages)
            if not self._pool_pressure and free_frac < 0.05:
                self._pool_pressure = True
                EVENTS.emit("pool_pressure", free_pages=pool.free_pages,
                            total_pages=pool.num_pages,
                            retained=pool.retained_pages,
                            active=pool.active_pages)
            elif self._pool_pressure and free_frac > 0.10:
                self._pool_pressure = False
        self._wm.sample(**wm)

    def _flight_dump(self, reason: str, tag: str = "slo", **extra) -> str:
        """Write the flight recorder's bundle for one bad moment: the trace,
        the state snapshot and the last 256 events, plus ``extra``. Never
        raises into the engine loop."""
        try:
            payload = {"trace": self.trace_events(),
                       "state": self.state_snapshot(),
                       "events": EVENTS.events(last=256)}
            payload.update(extra)
            path = self._flight.dump(reason, payload, tag=tag)
            if path:
                EVENTS.emit("flight_dump", reason=reason, tag=tag, path=path)
            return path
        except Exception:
            log.exception("flight dump failed")
            return ""

    def _on_kv_violation(self, v: dict):
        """The auditor's callback: one kv_audit_violation event per
        violation and a flight dump with the ledger's tail."""
        try:
            EVENTS.emit("kv_audit_violation",
                        **{k: (x if isinstance(x, (str, int, float))
                               else str(x)) for k, x in v.items()})
            self._flight_dump("kv_audit:" + str(v.get("check", "?")),
                              tag="kv_audit", kv_violation=v,
                              kv_ledger_tail=(self._kv_audit.ledger.tail(64)
                                              if self._kv_audit is not None
                                              else []))
        except Exception:
            pass

    def _kv_audit_tick(self, drained: bool = False) -> list:
        """One audit pass (engine thread, between ticks). The detached
        pages that outlive a tick are the prefetch pipeline's, declared as
        extras; every other detached page is adopted or freed within the
        call that made it. Strict mode lets KVAuditError propagate (in the
        loop: the step-failure path)."""
        aud = self._kv_audit
        if aud is None:
            return []
        return aud.run(self._pool, pcache=self._pcache, hstore=self._hstore,
                       extra_pages=self._prefetched_pages() or None,
                       drained=drained)

    def kv_audit_sweep(self, drained: bool = False) -> dict:
        """A full audit pass on demand, and the auditor's snapshot. The
        caller must be quiesced (nothing in flight, the loop idle or
        stopped): the scan reads the pool's host mirrors."""
        if self._kv_audit is None:
            return {"mode": "off", "checks": 0, "violations": 0,
                    "leaked_pages": 0, "ledger_events": 0}
        self._kv_audit_tick(drained=drained)
        return self._kv_audit.snapshot()

    def _pool_map(self) -> dict:
        pool = self._pool
        return {"pages_total": pool.num_pages, "page_size": pool.page_size,
                "free": pool.free_pages, "active": pool.active_pages,
                "retained": pool.retained_pages,
                "shared": int((pool.refs > 1).sum()),
                "oversubscription": round(pool.oversubscription, 4),
                "fragmentation": pool.fragmentation(),
                "pages_per_slot": [int(n) for n in pool.owned]}

    def kv_debug(self) -> dict:
        """The /debug/kv payload: the pool map, the prefix cache's chains,
        the audit counters and last violations, the ledger's tail, the
        host tier and the prefetch pipeline. {"mode": "off", ...} when
        auditing is off or the layout has no pages."""
        if self._kv_audit is None:
            return {"mode": "off", "replica": self.replica_id}
        out = {"mode": self._kv_audit.mode, "replica": self.replica_id,
               "pool": self._pool_map(),
               "chains": (self._pcache.genealogy(64)
                          if self._pcache is not None else []),
               "audit": self._kv_audit.snapshot(),
               "ledger_tail": self._kv_audit.ledger.tail(64)}
        if self._hstore is not None:
            out["host"] = self._hstore.stats()
        if self._prefetch is not None:
            out["prefetch"] = {"staged_pages": len(self._prefetch),
                               "seen_rids": len(self._prefetch.seen_rids)}
        return out

    def state_snapshot(self) -> dict:
        """The /debug/state payload: slots, queue, pool map, warmth and
        the last captures / builds, watermarks, goodput, speculation and
        lifecycle counters."""
        now = time.monotonic()
        slots = []
        for s in list(self.slots):
            slots.append(None if s is None else {
                "rid": s.req.request_id,
                "prompt_tokens": len(s.req.prompt_ids),
                "committed": int(s.committed),
                "n_decoded": int(s.n_decoded),
                "age_s": round(now - s.t_start, 3)})
        comp = self._cobs.snapshot()
        out = {"slots": slots, "slots_active": self.num_active,
               "queued": self._queue.qsize(), "warm": comp["warm"],
               "compiles": comp, "last_compiles": self._cobs.last_compiles(),
               "watermarks": self._wm.snapshot(),
               "goodput": self._goodput.snapshot(),
               "weight_bytes": self._weight_bytes}
        if self._device_mem:
            out["device_mem"] = dict(self._device_mem)
        st = self._spec_stats
        out["spec"] = {"mode": self._spec_mode,
                       **{k: v for k, v in st.items() if k != "by_mode"},
                       "by_mode": {m: dict(c)
                                   for m, c in st["by_mode"].items()}}
        out["flight_recorder"] = self._flight.snapshot()
        with self._lc_lock:
            out["lifecycle"] = dict(self._lc)
        if self._pool is not None:
            out["pool"] = self._pool_map()
            if self._hstore is not None:
                out["host_store"] = self._hstore.stats()
        return out

    def trace_events(self) -> dict:
        """The span ring as Chrome trace-event JSON (perfetto loads it)."""
        return chrome_trace(self.tracer)

    def _scheduler_metrics(self) -> dict:
        """``Scheduler.stats()`` plus the knobs, the reserve applied, and
        the queued, active and parked requests per class (the JAX engine's
        "scheduler" metrics); {"preempt": False} without the scheduler."""
        if self._sched is None:
            return {"preempt": False}
        sch = self._sched.stats()
        sch["preempt"] = True
        sch["max_preemptions"] = self.ecfg.max_preemptions
        sch["resume_reserve_pages"] = self.resume_reserve_effective
        sch["resume_reserve_auto"] = self._reserve_auto
        sch["preempt_rate_per_min"] = round(self._preempt_rate_ewma, 3)
        queued_by = dict.fromkeys(PRIORITY_CLASSES, 0)
        with self._queue.mutex:
            for req in self._queue.queue:
                queued_by[normalize_priority(req.priority,
                                             self._default_prio)] += 1
        active_by = dict.fromkeys(PRIORITY_CLASSES, 0)
        for s in list(self.slots):
            if s is not None:
                active_by[PRIORITY_CLASSES[s.prio]] += 1
        resume_by = dict.fromkeys(PRIORITY_CLASSES, 0)
        for c in self._sched.resume_priorities():
            resume_by[c] += 1
        sch["queued_by_class"] = queued_by
        sch["active_by_class"] = active_by
        sch["resume_by_class"] = resume_by
        return sch

    def _prefetched_pages(self) -> list:
        """The detached pages the prefetch pipeline holds (a snapshot, so
        metrics() may call it from another thread)."""
        if self._prefetch is None:
            return []
        return [rec[0] for rec in list(self._prefetch.pages.values())]

    # ---------- engine loop ----------

    def _capture(self):
        """Capture the decode step's two variants and every (bucket,
        continued) prefill graph (CUDA only; engine thread; each counted
        by the compile tracker), then pin the host tier's memory."""
        for name, graph in (("decode_graph", self._graph),
                            ("prefill_graph", self._pgraph)):
            t0 = time.monotonic()
            graph.capture()
            sysobs.note_compile(name, time.monotonic() - t0)
        if self._hstore is not None:
            self._reserve_pinned()

    def _reserve_pinned(self):
        """Pin host memory for offloaded pages once, at start: blocks the
        size of one page's leaves, for twice the host tier's budget (the
        store's pages plus as many again copied out before the inserts
        evict the store back under its budget), allocated and freed at
        once into PyTorch's caching host allocator, which hands them out
        again to the offload worker's page copies (transfer.pages_to_host).
        Pinning new memory is slow (it is page-locked, PERF.md §6), and
        every graph capture empties that cache, so this runs after the
        captures. With a draft cache a page's draft planes are pinned
        beside it (its entry holds both)."""
        leaves = [(c[k].shape[:1] + c[k].shape[2:], c[k].dtype)
                  for c in (self.ck, self.cv, self.dck, self.dcv)
                  if c is not None for k in ("pages", "scales") if k in c]
        page_bytes = sum(torch.Size(sh).numel() * torch.empty(0, dtype=dt).element_size()
                         for sh, dt in leaves)
        n = 2 * self._hstore.budget_bytes // page_bytes
        blocks = [torch.empty(sh, dtype=dt, pin_memory=True)
                  for _ in range(n) for sh, dt in leaves]
        del blocks

    def _run(self, ready: threading.Event, failed: list):
        # captures and kernel builds on this thread count as compiles
        sysobs.register_thread(self._cobs)
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
                if not self._tick():
                    # a dispatched item the loop is not waiting on may sit
                    # in the FIFO while it idles, and the emitter may be
                    # stuck: the watchdog covers both
                    self._check_parked_stall()
                    self._check_emitter_wedge()
                    self._wake.wait(timeout=self._idle_wait_s)
                    self._wake.clear()
            except _DispatchStall as st:
                # abort only the stalled item's requests; the rest serve on
                self._handle_stall(st.item)
            except Exception as e:   # the loop must survive: fail the requests
                self._fail_active(e)

    def _tick(self) -> bool:
        """One iteration of the loop (the JAX engine's tick): reap, admit,
        dispatch a pack and a burst (neither waits), then process what the
        FIFO rule allows. False when nothing happened (idle)."""
        t_tick = time.monotonic()
        if t_tick - self._t_wm > 0.5:
            # housekeeping on the JAX cadence, between ticks on this
            # thread, so the pool's host mirrors are never mid-change:
            # the watermark fold and the online KV audit
            self._t_wm = t_tick
            self._sample_watermarks()
            if self._kv_audit is not None:
                self._kv_audit_tick()
        self._autosize_reserve()
        # the stops the emitter found: their slots free before admission
        noted = self._apply_emitter_notes()
        # with the emitter on, whatever landed meanwhile is processed
        # before admission (the JAX top-of-tick drain): finished slots
        # free this very tick
        drained0 = (self._emitter is not None
                    and self._drain_fifo(can_feed=False, block=False))
        admitted = self._admit()
        if self._prefetch is not None:
            # the host links of requests still queued upload now, ahead
            # of their admission, overlapping the work dispatched below
            self._prefetch_tick()
        prefilled = self._dispatch_prefill()
        dispatched = self._dispatch_decode()
        drained = self._drain_fifo(can_feed=prefilled or dispatched) or drained0
        tr = self.tracer
        if tr.enabled and (admitted or prefilled or dispatched or drained):
            tr.record("tick", "sched", t_tick, time.monotonic(),
                      args={"admitted": int(admitted),
                            "prefilled": int(prefilled),
                            "dispatched": int(dispatched),
                            "drained": int(drained)})
        return noted or admitted or prefilled or dispatched or drained

    def _fail_active(self, e: Exception):
        log.exception("engine step failed")
        self._fifo.clear()
        self._override.clear()
        self._fork_waiters.clear()
        self._gbias_flush.clear()
        self._drop_prefetched()
        for i, s in enumerate(self.slots):
            if s is not None:
                self._final(i, s, [StreamEvent(
                    token_id=-1, text="", logprob=0.0, finish_reason="stop",
                    error=f"{type(e).__name__}: {e}"), None])
                self._release_slot(i)

    def _reap_cancelled(self):
        """Release the running slots cancel() named, and end the streams
        of the parked (preempted) requests it named, which leave the
        resume queue (their retained rows stay in the prefix cache, like
        any released slot's). An id that names no slot and no queued
        request belongs to a request that already ended, and is
        forgotten."""
        with self._cancel_lock:
            if not self._cancelled:
                return
            ids = set(self._cancelled)
        for i, s in enumerate(self.slots):
            if s is not None and s.req.request_id in ids:
                self._release_slot(i)
                self._final(i, s, [None])
                # a cancelled leader must not strand its fork siblings
                self._process_fork_waiters(i, s)
        if self._sched is not None and self._sched.resume_depth:
            for rid in ids:
                entry = self._sched.remove_parked(rid)
                if entry is not None:
                    self._final_parked(entry, [None])
        with self._queue.mutex:
            queued = {r.request_id for r in self._queue.queue}
        with self._cancel_lock:
            self._cancelled -= ids - queued

    def _reap_expired(self):
        """Deadlines and queue-wait shedding at the admission tick (the
        JAX engine's ``_reap_expired``): queued casualties are failed at
        once ("timeout" past request_timeout_ms, "shed" past
        max_queue_wait_ms); a running request past its deadline gets its
        "timeout" event and goes through cancel(), so its slot, pages and
        fork waiters are released exactly as on a client disconnect."""
        timeout_on = self.ecfg.request_timeout_ms > 0
        qwait_s = self.ecfg.max_queue_wait_ms / 1e3
        if not timeout_on and qwait_s <= 0:
            return
        now = time.monotonic()
        with self._queue.mutex:
            victims = [r for r in self._queue.queue
                       if (timeout_on and r.deadline and now > r.deadline)
                       or (qwait_s > 0 and now - r.t_submit > qwait_s)]
            for r in victims:
                self._queue.queue.remove(r)
        for r in victims:
            if timeout_on and r.deadline and now > r.deadline:
                r.out.put(self._timeout_event(r))
                r.out.put(None)
            else:
                self._shed(r, f"queued longer than max_queue_wait_ms "
                              f"({self.ecfg.max_queue_wait_ms} ms)")
        if not timeout_on:
            return
        with self._cancel_lock:
            cancelled = set(self._cancelled)
        for i, s in enumerate(self.slots):
            if (s is not None and s.req.deadline and now > s.req.deadline
                    and s.req.request_id not in cancelled):
                # decoding for a dead client: the error now, then the
                # cancel path releases the slot and closes the stream
                self._final(i, s, [self._timeout_event(s.req)])
                self.cancel(s.req.request_id)

    def _admit(self) -> bool:
        """Reap deadlines and cancellations, then admit queued requests
        into the free slots: with the scheduler by ``_admit_sched``, else
        in FIFO order. Requests admitted together with the same prompt
        and min(max_new_tokens, max_context // 4) prefill once (the JAX
        engine's key): the first is their leader, the others fork its
        rows (module doc)."""
        self._reap_expired()
        self._reap_cancelled()
        if self._sched is not None:
            return self._admit_sched()
        batch = []
        free = sum(1 for s in self.slots if s is None)
        while len(batch) < free:
            try:
                batch.append(self._queue.get_nowait())
            except queue.Empty:
                break
        leaders: dict = {}
        admitted = False
        for req in batch:
            admitted |= self._admit_one(req, leaders)
        return admitted

    def _admit_one(self, req: GenRequest, leaders: dict) -> bool:
        """Admit one popped request as a leader or a fork sibling; an
        admission that raises errors that request alone (the JAX engine's
        admission handler). True when a slot was taken."""
        with self._cancel_lock:
            cancelled = req.request_id in self._cancelled
            self._cancelled.discard(req.request_id)
        if cancelled:                   # cancelled while queued
            req.out.put(None)
            return False
        # a grammar request neither leads nor joins a fork: its automaton
        # state is its own (the JAX engine's key)
        key = None if req.grammar else (
            tuple(int(t) for t in req.prompt_ids),
            min(req.max_new_tokens, self.ecfg.max_context // 4))
        try:
            # a leader this pass paused again (an aged arrival's
            # preemption) cannot lead: its waiters would wait for ever
            if (key is not None and key in leaders
                    and self.slots[leaders[key][0]] is leaders[key][1]):
                self._start_fork_sibling(req, *leaders[key])
            else:
                slot, ids, s = self._start_request(req)
                if key is not None:
                    leaders[key] = (slot, s, ids)
        except Exception as e:
            log.exception("admission failed")
            req.out.put(StreamEvent(
                token_id=-1, text="", logprob=0.0, finish_reason="stop",
                error=f"{type(e).__name__}: {e}"))
            req.out.put(None)
            return False
        return True

    # ---------- the scheduler ----------

    def _free_count(self) -> int:
        return sum(1 for s in self.slots if s is None)

    def _admit_sched(self) -> bool:
        """Priority admission (the JAX engine's ``_admit_sched``): pop
        queued work in aged-rank order (stable FIFO within a class, so
        single-class traffic admits exactly as the FIFO path), merge the
        resume queue in by effective class (parked work wins rank ties),
        hold the resume reserve back from fresh admissions while preempted
        work waits, and, when the best waiting request strictly outranks
        an active slot and no slot is free, preempt that slot and admit
        into it."""
        sched = self._sched
        if self._queue.empty() and sched.resume_depth == 0:
            return False
        admitted = False
        leaders: dict = {}
        reserve = self.resume_reserve_effective
        # every pass admits, preempts (at most num_slots times) or breaks
        guard = 2 * self.ecfg.num_slots + 8
        while guard > 0:
            guard -= 1
            now = time.monotonic()
            with self._queue.mutex:
                entries = [(r.priority, r.t_submit, r) for r in self._queue.queue]
            cand = sched.order_queued(entries) if entries else []
            with self._cancel_lock:
                cancelled = set(self._cancelled)
            head = None
            for r in cand:
                if r.request_id not in cancelled:
                    head = r
                    break
                # cancelled while queued: close the stream and move on
                if self._pop_queued(r):
                    with self._cancel_lock:
                        self._cancelled.discard(r.request_id)
                    r.out.put(None)
            res = sched.peek_resume()
            if head is None and res is None:
                break
            none = len(PRIORITY_CLASSES)
            head_rank = (sched.effective_rank(head.priority, now - head.t_submit)
                         if head is not None else none)
            res_rank = (sched.effective_rank(res.priority, now - res.t_parked)
                        if res is not None else none)
            use_resume = res is not None and res_rank <= head_rank
            if self._free_count() == 0:
                victim = self._pick_victim(res_rank if use_resume else head_rank)
                if victim is None:
                    break
                self._preempt_slot(victim, why="priority")
                continue                # the freed slot admits next pass
            if use_resume:
                if not self._resume_fits(res):
                    break               # parked until the pool can hold it
                entry = sched.pop_resume()
                try:
                    self._start_resume(entry)
                    admitted = True
                except Exception:
                    log.exception("resume admission failed; request re-parked")
                    sched.requeue_front(entry)
                    break
            else:
                if (reserve > 0 and self._pool is not None
                        and sched.resume_depth > 0
                        and self._pool.free_pages <= reserve):
                    break               # the pages a parked resume needs
                if not self._pop_queued(head):
                    continue            # reaped or displaced meanwhile
                admitted |= self._admit_one(head, leaders)
        return admitted

    def _resume_fits(self, entry: ResumeEntry) -> bool:
        """Whether the pool can hold a parked request's history and its
        next burst now: every page but those the running requests pin is
        free or reclaimable (its own retained chain included). The JAX
        engine resumes into any free slot; after a pool-pressure pause
        that re-admission finds the pages its own pause freed taken, and
        its PoolExhausted fails every running request. Here it waits in
        the resume queue until capacity returns."""
        pool = self._pool
        if pool is None or all(s is None for s in self.slots):
            return True     # nothing running would free pages: try now
        need = pool.pages_for(min(self.ecfg.max_context,
                                  len(entry.ids) + self.ecfg.decode_burst + 2))
        idle = [i for i, s in enumerate(self.slots) if s is None]
        pinned = pool.pages_beyond(idle, extra=self._prefetched_pages())
        return pool.num_pages - pinned >= need

    def _preempt_eligible(self, s: _Slot) -> bool:
        """A slot that may pause: its state is rebuilt from tokens alone at
        resume, so a grammar slot (its automaton state is not), a fork
        sibling still waiting, a leader with waiters attached and a
        cancelled request are not (the JAX engine's rule; the port has no
        multimodal or prompt-cache slots)."""
        with self._cancel_lock:
            cancelled = s.req.request_id in self._cancelled
        return (s.grammar is None and s.phase in ("prefill", "decode")
                and s not in self._fork_waiters and not cancelled)

    def _pick_victim(self, incoming_rank: int, decode_only: bool = False,
                     keep=()) -> Optional[int]:
        """The slot to pause for a request of ``incoming_rank``
        (Scheduler.pick_victim over the eligible slots), or None. Paged
        layouts only: a contiguous slot has no pages to retain. With
        ``decode_only`` (mid-dispatch pool pressure) only decode slots,
        and never those in ``keep`` (the dispatch being built)."""
        if self._pool is None or self._sched is None:
            return None
        cands = [(i, PRIORITY_CLASSES[s.prio], s.t_start, s.preempts)
                 for i, s in enumerate(self.slots)
                 if s is not None and i not in keep
                 and (not decode_only or s.phase == "decode")
                 and self._preempt_eligible(s)]
        return self._sched.pick_victim(incoming_rank, cands)

    def _preempt_slot(self, slot: int, why: str = "priority"):
        """Pause a running slot and park its request (the JAX engine's
        ``_preempt_slot``). Its committed rows enter the prefix cache while
        the table still pins them (under pressure they offload to the host
        tier through the normal reclaim), then the whole table returns to
        the pool. Tokens already emitted stay emitted; its steps in flight
        are dropped (``_Burst.skip``, as for a context shift) and resume
        re-computes from the last token kept. The mirostat mu is copied on
        the card, in stream order (no wait)."""
        t0 = time.monotonic()
        s = self.slots[slot]
        hist = list(self._cache_tokens[slot])        # prompt + emitted tokens
        committed = min(s.committed, len(hist))
        if self._pool is not None:
            if self._pcache is not None:
                self._pcache.insert(self._pool, slot, hist[:committed])
            self._pool.release(slot, 0)
        self._sched.park(ResumeEntry(
            req=s.req, ids=hist, priority=s.req.priority,
            n_decoded=s.n_decoded, prompt_len=s.prompt_len, detok=s.detok,
            held_text=s.held_text, t_start=s.t_start,
            t_first_token=s.t_first_token or None, t_prefill_ms=s.t_prefill_ms,
            mu=self.sampler.mu[slot].clone(), preempt_count=s.preempts + 1,
            snap=s))
        # the reserve autosize's input: the preemption's time and pages
        pages = committed // (self._pool.page_size if self._pool else 1)
        self._preempt_marks.append(time.monotonic())
        self._preempt_pages_ewma = (
            float(pages) if len(self._preempt_marks) == 1
            else 0.7 * self._preempt_pages_ewma + 0.3 * pages)
        self.slots[slot] = None
        self.lengths[slot] = 0
        # the table is empty: its old prefix must not attract _pick_slot
        self._cache_tokens[slot] = []
        if slot in self._prefill_queue:
            self._prefill_queue.remove(slot)
        for b in self._fifo:
            if isinstance(b, _Burst):
                b.skip.add(slot)
        with self._lc_lock:
            self._lc["preemptions"] += 1
        EVENTS.emit("preempt", rid=s.req.request_id, slot=slot, why=why,
                    priority=s.req.priority, n_decoded=s.n_decoded,
                    retained_rows=committed)
        if self.tracer.enabled:
            self.tracer.record("preempt", f"slot{slot}", t0, time.monotonic(),
                               rid=s.req.request_id,
                               args={"why": why, "retained_rows": committed})

    def _start_resume(self, entry: ResumeEntry) -> int:
        """Re-admit a preempted request (the JAX engine's
        ``_start_resume``): its whole history (prompt + emitted tokens)
        goes back through ``_start_request``, whose tiers splice the
        retained device chain or restore offloaded pages, or, when those
        are gone, re-prefill it; the continuation is what a fresh
        submission of that history computes. The streaming state carries
        over, so the client sees one stream. Returns the slot."""
        sched = self._sched
        req = entry.req
        req.prompt_ids = list(entry.ids)
        t0 = time.monotonic()
        slot, ids, s = self._start_request(req, resume=entry)
        sched.resumes += 1
        sched.resume_restore_rows += s.reused
        if s.reused == 0:
            sched.resume_reprefills += 1
        EVENTS.emit("resume", rid=req.request_id, slot=slot,
                    priority=req.priority, reused_rows=s.reused,
                    reprefill_rows=len(ids) - s.reused,
                    parked_ms=round((t0 - entry.t_parked) * 1e3, 1))
        if self.tracer.enabled:
            self.tracer.record("resume", f"slot{slot}", t0, time.monotonic(),
                               rid=req.request_id,
                               args={"reused_rows": s.reused,
                                     "reprefill_rows": len(ids) - s.reused})
        return slot

    def _autosize_reserve(self):
        """resume_reserve_pages autosize (the JAX engine's): with the knob
        at 0, the reserve is EWMA(preemptions per minute) x EWMA(pages
        retained per preemption), at most a quarter of the pool. Runs at
        most every 0.5 s; an engine that never preempts stays at 0."""
        if self._pool is None or self._sched is None:
            return
        now = time.monotonic()
        dt = now - self._t_reserve_sample
        if dt < 0.5:
            return
        self._t_reserve_sample = now
        # marks inside a sliding 60 s window = preemptions per minute
        inst = float(sum(1 for t in self._preempt_marks if t >= now - 60.0))
        a = min(1.0, dt / 15.0)                 # a ~15 s time constant
        self._preempt_rate_ewma = (1 - a) * self._preempt_rate_ewma + a * inst
        if self.ecfg.resume_reserve_pages <= 0:
            self._reserve_auto = self._auto_reserve()

    def _auto_reserve(self) -> int:
        cap = max(1, self._pool.num_pages // 4)
        want = self._preempt_rate_ewma * max(1.0, self._preempt_pages_ewma)
        return min(cap, int(round(want)))

    @property
    def resume_reserve_effective(self) -> int:
        """The reserve _admit_sched applies: the knob when set, else the
        autosized value."""
        return self.ecfg.resume_reserve_pages or self._reserve_auto

    def note_pool_resize(self, n_old: int, n_new: int):
        """Rescale the preemption-rate EWMA when the number of engines
        sharing the traffic changes from ``n_old`` to ``n_new`` (the JAX
        engine's hook for its replica pool): the same load over more
        engines preempts less on each, so the rate scales by old / new and
        the auto reserve is recomputed now instead of drifting there."""
        if n_old <= 0 or n_new <= 0 or n_old == n_new:
            return
        self._preempt_rate_ewma *= float(n_old) / float(n_new)
        if (self._pool is not None and self._sched is not None
                and self.ecfg.resume_reserve_pages <= 0):
            self._reserve_auto = self._auto_reserve()

    def _start_request(self, req: GenRequest,
                       resume: Optional[ResumeEntry] = None) -> tuple:
        """Install a request in a free slot and queue its prompt for packed
        prefill. No model compute happens here. Returns (slot, the prompt
        ids as kept, its _Slot). With ``resume`` this is the preemption's
        restore path: ``req.prompt_ids`` holds the whole history, which is
        not truncated (only clamped below the cache edge), and the parked
        streaming state is grafted onto the new _Slot."""
        t_adm = time.monotonic()
        # a grammar compiles (GrammarError on one that does not parse)
        # before anything changes, so a refused request leaves no state
        grammar = self._grammar_for(req.grammar) if req.grammar else None
        if resume is None:
            EVENTS.emit("admit", rid=req.request_id,
                        prompt_tokens=len(req.prompt_ids),
                        queued=self._queue.qsize())
        C = self.ecfg.max_context
        ids = [int(t) for t in req.prompt_ids]
        if resume is not None:
            if len(ids) > C - 1:
                ids = ids[-(C - 1):]
        else:
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
                common = self._paged_admission(slot, ids, common,
                                               rid=req.request_id)
            except Exception:
                # the table may hold another prompt's shared or spliced
                # pages now (PoolExhausted for a clone): the slot forgets
                # every row, so no later pick reuses rows it does not hold
                self._pool.release(slot, 0)
                self._cache_tokens[slot] = []
                raise
        s = self._install(slot, req, ids, grammar)
        if (self._spec_mode == "model" and self._pool is None
                and (common or resume is not None)):
            # the contiguous draft cache holds only rows a pack mirrored
            # into this slot: a reused prefix or a resume has none (the
            # paged draft cache shares, clones and restores them)
            s.spec_ok = False
        s.pending = ids[common:]
        s.written = s.committed = s.reused = common
        self._reuse_stats["reused_rows"] += common
        self._cache_tokens[slot] = list(ids)
        if resume is not None:
            s.detok, s.held_text = resume.detok, resume.held_text
            s.n_decoded, s.prompt_len = resume.n_decoded, resume.prompt_len
            s.t_start = resume.t_start
            s.t_first_token = resume.t_first_token or 0.0
            s.t_prefill_ms = resume.t_prefill_ms
            s.preempts = resume.preempt_count
            if self._emitter is not None:
                # the emitter grafts the paused stream's text state on
                s.resumed_from = resume.snap
            if resume.mu is not None:
                self.sampler.mu[slot].copy_(resume.mu)
        self._prefill_queue.append(slot)
        # a request shorter than the housekeeping cadence still leaves its
        # high-water mark
        self._sample_watermarks()
        tr = self.tracer
        if tr.enabled and resume is None:
            if req.t_submit:
                tr.record("queue_wait", f"slot{slot}", req.t_submit,
                          s.t_start, rid=req.request_id)
            # admission: the prefix tiers' splice and the host restore
            tr.record("admission", f"slot{slot}", t_adm, time.monotonic(),
                      rid=req.request_id,
                      args={"prompt_tokens": len(ids), "reused_rows": common})
        return slot, ids, s

    def _install(self, slot: int, req: GenRequest, ids: list,
                 grammar: Optional[NativeGrammar] = None) -> _Slot:
        """Seat a request in ``slot``: its sampling state, its penalty ring
        (seeded with the prompt tail, reused rows included) and its
        _Slot. With ``grammar`` the bias row is the request's logit bias
        plus the initial state's mask (the JAX admission), so the pack
        samples the first token under the grammar."""
        row = None
        if grammar is not None:
            base = np.zeros((self.cfg.vocab_size,), np.float32)
            for tok, b in (req.params.logit_bias or {}).items():
                if 0 <= int(tok) < base.shape[0]:
                    base[int(tok)] = float(b)
            gstate = grammar.initial_state()
            row = (base, self._mask_builder.penalty_row(grammar, gstate))
        self.sampler.set_slot(slot, req.params,
                              fallback_seed=zlib.crc32(req.request_id.encode()),
                              grammar_row=row)
        self.sampler.set_ring(slot, ids)
        s = _Slot(req, IncrementalDetokenizer(self.tokenizer), len(ids))
        if grammar is not None:
            s.grammar, s.gstate = grammar, gstate
            s.bias_base, s.cur_penalty = row
        s.spec_ok = self._spec_eligible(req)
        self.slots[slot] = s
        return s

    def _spec_eligible(self, req: GenRequest) -> bool:
        """Whether a request may take spec rounds: the JAX admission
        gates (no grammar, logit bias, penalties or mirostat, whose
        per-token state one frozen verify cannot follow; the port has no
        multimodal input). Greedy requests accept greedily, sampled ones
        by rejection sampling. The n-gram drafter keeps no state, and the
        paged draft cache shares and restores the draft rows of the same
        pages, so a resume and a fork sibling qualify as a fresh admission
        does; the model drafter on the contiguous layout adds the JAX
        gates of ``_start_request`` and ``_process_fork_waiters``."""
        sp = req.params
        return (self._spec_mode != "off" and not req.grammar
                and not sp.logit_bias and sp.repeat_penalty in (0.0, 1.0)
                and sp.presence_penalty == 0.0 and sp.frequency_penalty == 0.0
                and (sp.mirostat or 0) == 0)

    def _start_fork_sibling(self, req: GenRequest, leader: int, lsnap: _Slot,
                            ids: list):
        """Admit a request whose prompt is the in-flight ``leader``'s: its
        sampling state is installed, its slot's retained rows dropped
        (the fork shares into an empty table, or the downgrade prefills
        from row 0, and those pages may be shared: never overwritten), and
        it prefills nothing until the leader's final pack is processed
        (``_process_fork_waiters``; the JAX engine's
        ``_start_fork_sibling``)."""
        slot, _common = self._pick_slot(ids)
        s = self._install(slot, req, ids)
        s.phase = "fork_wait"
        if self._pool is not None:
            self._pool.release(slot, 0)
        self._cache_tokens[slot] = []
        self._fork_waiters.setdefault(lsnap, []).append((slot, s, ids))
        self._fork_stats["siblings"] += 1

    def _process_fork_waiters(self, leader: int, lsnap: _Slot):
        """The leader ``lsnap`` (in ``leader``) had its final pack
        processed, or was cancelled or failed: each sibling still waiting
        takes the leader's first len(ids) - 1 rows (paged: shared, the
        boundary page cloned; contiguous: copied) and queues its last
        prompt token, whose pack samples its own first token. A leader
        that is not decoding its prompt any more downgrades its siblings
        to full prefills (the JAX engine's ``_process_fork_waiters``)."""
        for sib, s, ids in self._fork_waiters.pop(lsnap, ()):
            if self.slots[sib] is not s:
                continue                # cancelled while it waited
            ok = (self.slots[leader] is lsnap and lsnap.phase == "decode"
                  and len(ids) > 1
                  and self._cache_tokens[leader][:len(ids)] == ids)
            n = 0
            if ok:
                n = len(ids) - 1
                if self._pool is not None:
                    self._pool.release(sib, 0)
                    n = self._share_prefix(leader, sib, n)
                else:
                    kvcache.copy_rows(self.ck, leader, sib, n)
                    kvcache.copy_rows(self.cv, leader, sib, n)
                    if self._spec_mode == "model":
                        # the sibling speculates only on draft rows forked
                        # from a leader that had them (the JAX rule)
                        s.spec_ok = s.spec_ok and lsnap.spec_ok
                        if lsnap.spec_ok:
                            kvcache.copy_rows(self.dck, leader, sib, n)
                            kvcache.copy_rows(self.dcv, leader, sib, n)
                self._fork_stats["forked"] += 1
                self._fork_stats["rows_shared"] += n
                self._reuse_stats["reused_rows"] += n
            else:
                self._fork_stats["downgraded"] += 1
            s.pending = ids[n:]
            s.written = s.committed = s.reused = n
            s.phase = "prefill"
            self._cache_tokens[sib] = list(ids)
            self._prefill_queue.append(sib)

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

    def _paged_admission(self, slot: int, ids: list, common: int,
                         rid: str = "") -> int:
        """Paged prefix reuse at admission: the rows reusable from the
        best of three tiers (module doc). Tier 1, ``common``, is the
        slot's own retained rows. Tier 2 shares another slot's rows that
        are read-only for it (the committed prompt rows of a running slot,
        the retained rows of a free one). Tier 3 splices a retained chain
        of the prefix cache; with the host tier on, the chain walk goes on
        past the device pages (the JAX engine's two-tier walk): first the
        prefetched links while they continue the chain, then host-store
        hits, restored into new pages (``_restore_offloaded``). Tiers 2
        and 3 need kv_prefix_cache_min_rows rows. The first page this
        request writes is cloned if shared. ``rid``: the request's id, for
        the late-prefetch count."""
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
        host_hits: list = []
        pre_keys: list = []
        pf = self._prefetch
        if self._hstore is not None:
            # the device tier is prefix-closed (eviction cascades), so the
            # host tier can only continue the chain past its pages
            want = min(pool.max_pages, cap // pool.page_size + 1)
            for i, key in enumerate(self._pcache.chain_keys(ids)):
                if i < len(cached_pages):
                    continue
                if len(cached_pages) + len(pre_keys) + len(host_hits) >= want:
                    break
                if pf is not None and not host_hits and key in pf.pages:
                    pre_keys.append(key)
                    continue
                e = self._hstore.get(key)
                if e is None:
                    break
                host_hits.append(e)
        cached_rows = min((len(cached_pages) + len(pre_keys) + len(host_hits))
                          * pool.page_size, cap)
        if cached_rows >= min_rows and cached_rows > max(common, best_rows):
            pool.release(slot, 0)
            pool.splice(slot, cached_pages)
            n_pre = 0
            for key in pre_keys:
                rec = pf.claim(key)
                if rec is None:
                    break
                # the pipeline's detached reference goes to the table; the
                # attach re-enters the link in the device tier
                pool.adopt(slot, rec[0])
                self._pcache.attach(pool, key, rec[1], rec[0], rec[2])
                n_pre += 1
            if n_pre:
                self._hstore.note_prefetch_hit(n_pre)
            if n_pre < len(pre_keys):
                host_hits = []          # the chain has a hole past the claim
            restored = 0
            if host_hits:
                restored = self._restore_offloaded(slot, host_hits)
                if pf is not None and rid in pf.seen_rids:
                    # scanned by the prefetch tick, restored here anyway
                    self._hstore.note_prefetch_late(restored)
            cached_rows = min((len(cached_pages) + n_pre + restored)
                              * pool.page_size, cap)
            if cached_rows == 0:
                self._pcache.note_miss()
                return 0
            # a retained page back in a table has refs >= 2 (table + hold),
            # so the guard clones the page the prefill writes first
            self._cow_guard(slot, cached_rows)
            self._pcache.note_hit(cached_rows)
            return cached_rows
        if (self._hstore is not None and not host_hits and not pre_keys
                and len(ids) // pool.page_size > len(cached_pages)):
            # the host tier was consulted past the device chain and had
            # nothing usable
            self._hstore.note_miss()
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
        """Copy page ``src`` over ``dst``, the draft planes of the same page
        id too: the draft's rows diverge exactly when the target's do."""
        for cache in (self.ck, self.cv, self.dck, self.dcv):
            if cache is not None:
                kvcache.clone_page(cache, src, dst)
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
        if (self._prefetch is not None and len(self._prefetch)
                and self._pool.free_pages < need_free):
            # pressure outranks speculation: prefetched pages (their rows
            # are still in the host tier) go before retained chains
            self._drop_prefetched()
        if self._pcache is not None:
            victims: list = []
            on_evict = None
            if self._hstore is not None:
                # each evicted page the store lacks is collected while its
                # id still names its rows; the gather is dispatched below,
                # before anything can reuse the freed pages
                def on_evict(e, victims=victims):
                    if not self._hstore.contains(e.key):
                        victims.append((e.key, e.parent, e.depth, e.page))
            self._pcache.evict(self._pool, need_free, on_evict)
            if victims:
                self._dispatch_offload(victims)

    def _drop_prefetched(self):
        """Give back every page the prefetch pipeline holds, counted as
        wasted (the pool-pressure raid, a failure)."""
        if self._prefetch is None:
            return
        drained = self._prefetch.drain()
        for _key, rec in drained:
            self._pool.unref_detached(rec[0])
        if drained:
            self._hstore.note_prefetch_wasted(len(drained))

    # ---------- the host tier ----------

    def _dispatch_offload(self, victims: list):
        """Offload evicted pages ((key, parent, depth, page) each): ONE
        gather of their rows into a fresh device tensor, queued on the
        stream now, so it reads the pages before any later pack or burst
        rewrites them. The offload worker copies that snapshot to pinned
        host memory and puts the pages into the host store: pinning host
        memory is slow, and stays off the engine thread."""
        t0 = time.monotonic()
        pages = [v[3] for v in victims]
        stream = (torch.cuda.current_stream(self.device)
                  if self.device.type == "cuda" else None)
        draft = {}
        if self.dck is not None:
            # the draft planes of the same pages go with them, so a
            # restored spec slot drafts on warm rows
            draft = {"dk": kvcache.gather_pages(self.dck, pages),
                     "dv": kvcache.gather_pages(self.dcv, pages)}
        self._offloader.put(_PendingOffload(
            [(key, parent, depth) for key, parent, depth, _p in victims],
            kvcache.gather_pages(self.ck, pages),
            kvcache.gather_pages(self.cv, pages), stream, self._hstore,
            **draft))
        if self.tracer.enabled:
            self.tracer.record("offload_dispatch", "engine", t0,
                               time.monotonic(), args={"pages": len(pages)})

    def _upload_pages(self, pages: list, host_hits: list):
        """Copy host-tier entries into device pages (same order): each
        page copied from its pinned host tensors without waiting for the
        stream (transfer.pages_to_device), then scattered in place; in
        stream order the rows are there before any later pack or burst
        reads them. With a draft cache, the entries that carry draft
        planes restore those into the draft pages of the same ids; the
        others leave their draft rows cold (acceptance, never
        correctness)."""
        n = len(host_hits)
        planes = [(self.ck, host_hits, pages[:n], "src", 0, "k"),
                  (self.cv, host_hits, pages[:n], "src", 1, "v")]
        if self.dck is not None:
            dhits = [(p, e) for p, e in zip(pages, host_hits) if e.dk is not None]
            if dhits:
                dp, de = [p for p, _e in dhits], [e for _p, e in dhits]
                planes += [(self.dck, de, dp, "dsrc", 0, "dk"),
                           (self.dcv, de, dp, "dsrc", 1, "dv")]
        for cache, ents, ids, src, j, leaf in planes:
            host = [getattr(e, src)[j] if getattr(e, src) is not None
                    else _tensor_page(getattr(e, leaf)) for e in ents]
            if isinstance(host[0], dict):
                dev = {x: pages_to_device([h[x] for h in host], self.device)
                       for x in host[0]}
            else:
                dev = pages_to_device(host, self.device)
            kvcache.scatter_pages(cache, ids, dev)

    def _restore_offloaded(self, slot: int, host_hits: list) -> int:
        """Restore host-tier hits into new pages appended to the slot's
        table (dispatch, then splice: the upload is queued, the table
        edit is host work). Each page re-enters the prefix cache (refs >=
        2, so the first prefill write clones). Under pool pressure a
        partial allocation restores a shorter chain from the root; it
        never fails the admission. Returns the pages restored."""
        t0 = time.monotonic()
        pool = self._pool
        pages = pool.alloc_many(len(host_hits))
        if len(pages) < len(host_hits):
            self._reclaim_pages(slot, len(host_hits) - len(pages))
            pages.extend(pool.alloc_many(len(host_hits) - len(pages)))
        host_hits = host_hits[:len(pages)]
        if not host_hits:
            return 0
        n = len(host_hits)
        self._upload_pages(pages, host_hits)
        for e, p in zip(host_hits, pages):
            pool.adopt(slot, p)
            self._pcache.attach(pool, e.key, e.parent, p, e.depth)
        self._hstore.note_restore(n)
        if self.tracer.enabled:
            self.tracer.record("restore_dispatch", "engine", t0,
                               time.monotonic(), args={"pages": n})
        return n

    def _prefetch_tick(self):
        """Prefetch-ahead (the JAX engine's, without the window): for the
        first ``kv_prefetch_ahead`` queued requests not scanned yet,
        upload the host-tier links their admission will restore into
        detached pages now. Speculation never evicts: it stops at the
        pool's free headroom."""
        pf = self._prefetch
        pf.tick += 1
        expired = pf.expire()
        if expired:
            for _key, rec in expired:
                self._pool.unref_detached(rec[0])
            self._hstore.note_prefetch_wasted(len(expired))
        ahead = max(1, int(self.ecfg.kv_prefetch_ahead))
        with self._queue.mutex:
            reqs = list(self._queue.queue)[:ahead]
        if not reqs:
            return
        pool = self._pool
        pg = pool.page_size
        C = self.ecfg.max_context
        budget = 4 * ahead * 8                   # pages per tick
        for req in reqs:
            if budget <= 0:
                break
            rid = req.request_id
            if rid in pf.seen_rids:
                continue
            pf.seen_rids.add(rid)
            ids = [int(t) for t in req.prompt_ids]
            # _start_request's truncation: keys past it would never admit
            max_prompt = C - 1 - min(req.max_new_tokens, C // 4)
            if len(ids) > max_prompt:
                ids = ids[-max_prompt:]
            n_links = (len(ids) - 1) // pg
            if n_links <= 0:
                continue
            keys = []
            for i, key in enumerate(self._pcache.chain_keys(ids)):
                if i >= n_links:
                    break
                keys.append(key)
            d = 0                                # device-resident depth
            while d < len(keys) and self._pcache.contains(keys[d]):
                d += 1
            n_avail = d
            while n_avail < len(keys) and (
                    keys[n_avail] in pf.pages
                    or self._hstore.contains_any(keys[n_avail])):
                n_avail += 1
            if n_avail <= d:
                continue
            fetch = [i for i in range(d, n_avail)
                     if keys[i] not in pf.pages][:budget]
            if not fetch:
                continue
            if pool.free_pages < len(fetch) + 4:
                break                            # headroom: truth first
            ents = []
            for i in fetch:
                e = self._hstore.get(keys[i])
                if e is None:
                    break                        # a hole since the probe
                ents.append(e)
            if not ents:
                continue
            pages = pool.alloc_many(len(ents))
            if len(pages) < len(ents):
                for p in pages:
                    pool.unref_detached(p)
                break
            self._upload_pages(pages, ents)
            for e, p in zip(ents, pages):
                pf.register(e.key, e.parent, p, e.depth)
            self._hstore.note_prefetch_issued(len(ents))
            budget -= len(ents)
            event = None
            if self.device.type == "cuda":
                event = torch.cuda.Event()
                event.record()
            self._offloader.put(_PendingPrefetch(event, self._hstore))

    def _ensure_pages(self, slot: int, rows: int, keep=()):
        """Lazy page allocation; under pool pressure reclaim and retry. With
        the scheduler, if that is not enough, pause a decode slot of a
        strictly lower class than this slot's (never one in ``keep``: the
        dispatch being built) and reclaim again, its retained pages now
        evictable (the JAX engine's pool-pressure preemption). Raises
        PoolExhausted when even that leaves the pool short."""
        if FAULTS.active and FAULTS.take("page_alloc_fail") is not None:
            raise PoolExhausted("injected fault: page_alloc_fail")
        try:
            self._pool.ensure(slot, rows)
            return
        except PoolExhausted:
            pass
        self._reclaim_pages(slot, self._pool.pages_for(rows))
        if self._sched is not None:
            try:
                self._pool.ensure(slot, rows)
                return
            except PoolExhausted:
                pass
            me = self.slots[slot]
            victim = self._pick_victim(
                me.prio if me is not None else PRIORITY_RANK["high"],
                decode_only=True, keep=keep)
            if victim is not None and victim != slot:
                self._preempt_slot(victim, why="pool_pressure")
                self._reclaim_pages(slot, self._pool.pages_for(rows))
            elif (victim is None and me is not None and slot not in keep
                  and me.phase == "decode" and self._preempt_eligible(me)
                  and any(s is not None for i, s in enumerate(self.slots)
                          if i != slot)):
                # no lower class to pause: this decode slot pauses itself
                # and resumes once the pool can hold it, where the JAX
                # engine's PoolExhausted fails every running request; the
                # caller drops it from the burst it builds
                self._preempt_slot(slot, why="pool_pressure")
                return
        self._pool.ensure(slot, rows)

    def _commit_ptab(self):
        """Copy the host page table into the one device table, in place
        (K and V share it), in stream order and without waiting: packs and
        bursts still in flight read the table as it was when they were
        dispatched, later ones read this (engine/transfer.py)."""
        if self._pool is not None and self._pool.dirty:
            to_device(self.ck["ptab"], self._pool.ptab)
            self._pool.dirty = False

    # ---------- packed prefill ----------

    def _dispatch_prefill(self, fuse: bool = True) -> bool:
        """Dispatch ONE ragged packed prefill for this tick (module doc).
        Final segments go first, so output row b is segment b. Non-final
        segments count as committed at once (their rows are written in
        stream order before anything that reads them); the finals go into
        the FIFO as a _Pack, processed when their first tokens land. With
        ``fuse`` and the JAX rule (a fuse mode, a free pipeline place and
        a full burst runnable), the pack is a fused tick's head
        (``_dispatch_fused``)."""
        S, C = self.ecfg.num_slots, self.ecfg.max_context
        budget = self._pack_budget
        # weighted-fair packing: when slots of more than one class have
        # prompt tokens pending, the scheduler's deficit round-robin caps
        # each class's share of the budget; single-class packs are
        # untouched
        drr = None
        sched = self._sched
        if sched is not None:
            pend = self._pending_by_class()
            if sum(1 for n in pend if n > 0) > 1:
                sched.begin_tick(budget, pend)
                drr = pend
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
            if drr is not None:
                # slack: budget no other class can use this tick, granted
                # beyond the deficit so the walk stays work-conserving
                r = s.prio
                others = sum(min(sched.deficit(j), drr[j])
                             for j in range(len(drr)) if j != r)
                take = sched.take(r, take, max(0, (budget - total) - others))
                if take <= 0:
                    continue
                drr[r] = max(0, drr[r] - take)
            segs.append((slot, s, take, take == len(s.pending)))
            total += take
        if not segs:
            return False
        segs.sort(key=lambda t: not t[3])
        t0 = time.monotonic()
        if self._pool is not None:
            for slot, s, take, _f in segs:
                self._ensure_pages(slot, s.written + take)

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
        infl = self._inflight_vec()
        finals = [(s.written + take, s.req.max_new_tokens)
                  for _sl, s, take, f in segs if f]
        if (fuse and finals and self._fuse != "off"
                and self._n_inflight() < self.ecfg.pipeline_depth
                and self._pick_burst(infl, finals) == self.ecfg.decode_burst):
            self._dispatch_fused(segs, bucket, continued, host, infl, t0)
            return True
        self._commit_ptab()
        fetch = self._prefill_pack(bucket, continued, host)
        group = self._advance(segs, t0)
        t1 = time.monotonic()
        self._hobserve("prefill_dispatch_seconds", t1 - t0)
        if self.tracer.enabled:
            self.tracer.record("prefill_dispatch", "engine", t0, t1,
                               args={"tokens": total, "segments": len(segs),
                                     "bucket": bucket, "packed": True})
        if not group:
            st["seconds"] += time.monotonic() - t0
            return True
        self._fifo.append(_Pack(group, fetch, t0))
        if self.ecfg.pipeline_depth == 1:
            self._drain_all()         # the synchronous loop: finals now
        return True

    def _pending_by_class(self) -> list:
        """Per class, the prompt tokens its prefilling slots could pack
        this tick (chunk-capped, like the walk's own take)."""
        pend = [0] * len(PRIORITY_CLASSES)
        for s in self.slots:
            if s is not None and s.phase == "prefill" and s.pending:
                pend[s.prio] += min(len(s.pending), self._chunk)
        return pend

    def _advance(self, segs: list, t0: float) -> list:
        """A dispatched pack's bookkeeping: each segment's rows move from
        pending to written; a non-final one counts them committed; the
        finals leave the prefill queue. Returns the finals' (slot,
        _Slot)."""
        t1 = time.monotonic()
        group = []
        for slot, s, take, final in segs:
            s.pending = s.pending[take:]
            s.written += take
            if final:
                self._prefill_queue.remove(slot)
                group.append((slot, s))
            else:
                s.committed = s.written
                s.t_prefill_ms += (t1 - t0) * 1e3
        return group

    def _prefill_step(self) -> bool:
        """One pack, never fused, processed (with whatever else is in
        flight) before it returns: a tick of the synchronous loop, for
        callers that drive the engine tick by tick."""
        ran = self._dispatch_prefill(fuse=False)
        self._drain_all()
        return ran

    def _mirror(self, host: np.ndarray, bucket: int) -> bool:
        """Whether the draft mirrors a staged pack (the JAX rule): with the
        model drafter, when a segment of it may speculate."""
        if self._spec_mode != "model":
            return False
        v = split_pack(host, bucket, self.ecfg.num_slots)
        return any(self.slots[int(i)] is not None and self.slots[int(i)].spec_ok
                   for i, n in zip(v["seg_slots"], v["seg_len"]) if n > 0)

    def _prefill_pack(self, bucket: int, continued: bool,
                      host: np.ndarray) -> Fetch:
        """The pack's device work: a graph replay on the card, the same
        padded body eagerly on the CPU (prefill_graph.PrefillGraph.
        dispatch), and the draft's mirror of it right after when
        ``_mirror`` asks for one. Returns the Fetch of the [2, S]
        first-token ids and logprobs (rows [0, n_finals) are the
        finals')."""
        return self._pgraph.dispatch(bucket, continued, host,
                                     self._mirror(host, bucket))

    def _prefill_eager(self, bucket: int, continued: bool, host: np.ndarray,
                       exact: bool = False):
        """The eager pack (prefill_graph.eager_pack: at the bucket, or at
        the pack's exact size), the reference chip_smoke.py and the card
        tests hold the graphs against; serving never calls it. Returns
        ([2, n] ids and logprobs, logits)."""
        return eager_pack(self.params, self.cfg, self.ck, self.cv,
                          self.sampler, host, bucket, self.ecfg.num_slots,
                          continued, exact=exact)

    def _process_pack(self, item: _Pack, blame=None):
        """A pack's first tokens have landed: emit them. Plain packs switch
        their finals to decode here (the next burst takes their state from
        the host: ``_override``); a split head's finals switched at
        dispatch, and the burst chained behind it carries their state.
        Then the finals' fork siblings resolve. ``blame``: the FIFO item a
        stall of this pack aborts (a "1" fused tick's burst), else the
        pack."""
        firsts = self._wait_ready(item, blame)
        ids, lps = firsts[0].astype(np.int64), firsts[1]
        if item.split:
            item.processed = True
        running = item.burst is not None and not item.burst.fetch.done()
        t1 = time.monotonic()
        if not item.split:
            self._pack_stats["seconds"] += t1 - item.t0
        tr = self.tracer
        if tr.enabled:
            # dispatch -> the results seen landed: device time (and the
            # queue behind earlier dispatches); landed -> now: pickup lag
            t_rdy = item.fetch.t_ready or t1
            args = {"slots": len(item.group)}
            if item.split:
                args["split"] = True
            tr.record("prefill_device", "engine", item.t0, t_rdy, args=args)
            tr.record("finish_detect", "engine", t_rdy, t1)
        self._open_sink()
        try:
            for b, (slot, s) in enumerate(item.group):
                if self.slots[slot] is not s:
                    continue              # cancelled while in flight
                s.committed = s.written
                if not item.split:
                    s.phase = "decode"
                    s.cache_len = s.written
                    self.lengths[slot] = s.written
                    self.cur_tokens[slot] = int(ids[b])
                    self._override.add(slot)
                elif item.burst in self._fifo:
                    self._pipe_stats["head_emits"] += 1
                    self._pipe_stats["head_emits_running"] += int(running)
                s.t_prefill_ms += (t1 - item.t0) * 1e3
                if not s.t_first_token:   # a shift's re-prefill keeps it
                    s.t_first_token = t1
                    if s.req.t_submit:
                        self._hobserve("ttft_seconds", t1 - s.req.t_submit,
                                       rid=s.req.request_id)
                    if tr.enabled:
                        args = {"prompt_tokens": s.prompt_len}
                        if item.split:
                            args["fused"] = ("split" if self._fuse == "split"
                                             else True)
                        tr.record("prefill", f"slot{slot}", item.t0, t1,
                                  rid=s.req.request_id, args=args)
                self._emit(slot, int(ids[b]), float(lps[b]))
        finally:
            self._close_sink()
        for slot, s in item.group:
            self._process_fork_waiters(slot, s)
        self._flush_grammar_bias()

    # ---------- decode ----------

    def _n_inflight(self) -> int:
        """Bursts dispatched and not processed (a snapshot of the FIFO,
        so metrics() may call it from another thread)."""
        return sum(isinstance(x, _Burst) for x in list(self._fifo))

    def _inflight_vec(self) -> list:
        """Per slot, the tokens already dispatched and not processed: the
        steps of the bursts it rides (W per round of a spec tick for a spec
        row: the most a round can emit), plus a fused tick's first token
        until its head is processed (the JAX engine's ``_inflight_vec``)."""
        n = [0] * self.ecfg.num_slots
        for b in self._fifo:
            if not isinstance(b, _Burst):
                continue
            head = int(b.head is not None and not b.head.processed)
            gset = {i for i, _s in b.group}
            for i, _s in b.slots:
                if i not in b.skip:
                    w = b.spec_width if b.spec_width and b.spec_mask[i] else 1
                    n[i] += b.n_steps * w + (head if i in gset else 0)
        return n

    def _pick_burst(self, infl: list, extra=()) -> int:
        """Steps in the next burst: a power of two <= decode_burst, clamped
        so no slot reaches the cache edge inside it, and no burst outlasts
        every slot's remaining token budget, counting the steps already in
        flight. ``extra``: (rows, max_new_tokens) of a fused tick's finals
        (their first token comes from the pack)."""
        cap = self.ecfg.decode_burst
        budget = 1
        for i, s in enumerate(self.slots):
            if s is None or s.phase != "decode":
                continue
            cap = min(cap, max(1, self.ecfg.max_context - 2 - s.cache_len - infl[i]))
            budget = max(budget, s.req.max_new_tokens - s.n_decoded - infl[i])
        for rows, max_new in extra:
            cap = min(cap, max(1, self.ecfg.max_context - 2 - rows))
            budget = max(budget, max_new - 1)
        cap = min(cap, budget)
        if self._sched is not None:
            # while prompt work of a strictly higher class than every
            # decoding slot waits, the burst shrinks to the decoding
            # class's weighted share, so admission comes around sooner
            pend = [0] * len(PRIORITY_CLASSES)
            dec_rank = None
            for s in self.slots:
                if s is None:
                    continue
                if s.phase == "prefill" and s.pending:
                    pend[s.prio] += 1
                elif s.phase == "decode":
                    dec_rank = s.prio if dec_rank is None else min(dec_rank, s.prio)
            cap = self._sched.burst_share(dec_rank, pend, cap)
        k = 1
        while k * 2 <= cap:
            k *= 2
        return k

    def _plan_spec(self, included: list, infl: list):
        """The spec plan of this tick (the JAX engine's ``_plan_spec``):
        (rounds, spec_mask [S]), or None for a plain burst. A slot takes
        spec rounds when it is ``spec_ok`` and has W = n_draft + 1 rows of
        headroom past its steps in flight (a slot near the cache edge
        rides as a plain row, so context shift works as before); every
        other slot in ``included`` takes the plain decode step in the same
        rounds. Rounds: at most decode_burst // W, each spec slot charged
        W rows of cache and W tokens of budget per round, cut to the
        longest remaining budget, to the scheduler's ``burst_share``, and
        to a power of two."""
        if self._spec_mode == "off":
            return None
        W = self._spec_width
        C = self.ecfg.max_context
        mask = np.zeros((self.ecfg.num_slots,), np.bool_)
        for i in included:
            s = self.slots[i]
            if s.spec_ok and C - 2 - (s.cache_len + infl[i]) >= W:
                mask[i] = True
        if not mask.any():
            return None
        cap = max(1, self.ecfg.decode_burst // W)
        budget = 1
        for i in included:
            s = self.slots[i]
            used = s.cache_len + infl[i]
            rem = s.req.max_new_tokens - s.n_decoded - infl[i]
            if mask[i]:
                cap = min(cap, max(1, (C - 2 - used) // W))
                budget = max(budget, (rem + W - 1) // W)
            else:
                cap = min(cap, max(1, C - 2 - used))
                budget = max(budget, rem)
        cap = min(cap, budget)
        if self._sched is not None:
            # the priority-weighted sizing of _pick_burst
            pend = [0] * len(PRIORITY_CLASSES)
            dec_rank = None
            for s in self.slots:
                if s is None:
                    continue
                if s.phase == "prefill" and s.pending:
                    pend[s.prio] += 1
                elif s.phase == "decode":
                    dec_rank = s.prio if dec_rank is None else min(dec_rank, s.prio)
            cap = self._sched.burst_share(dec_rank, pend, cap)
        k = 1
        while k * 2 <= cap:
            k *= 2
        return k, mask

    def _dispatch_decode(self) -> bool:
        """Dispatch the next decode burst, or a spec tick when a decoding
        slot may speculate (``_plan_spec``), if the pipeline has room and a
        decoding slot has budget beyond its steps in flight (a slot whose
        steps in flight cover its max_new_tokens sits this burst out)."""
        if self._n_inflight() >= self.ecfg.pipeline_depth:
            return False
        infl = self._inflight_vec()
        included = [i for i, s in enumerate(self.slots)
                    if s is not None and s.phase == "decode"
                    and s.req.max_new_tokens - s.n_decoded - infl[i] > 0]
        if not included:
            return False
        t0 = time.monotonic()
        plan = self._plan_spec(included, infl)
        spec_mask = None
        if plan is not None:
            n_steps, spec_mask = plan
        else:
            n_steps = self._pick_burst(infl)
        if self._pool is not None:
            C = self.ecfg.max_context
            for i in included:
                # a spec row writes up to W rows a round (the rejected
                # tail is overwritten by the next round)
                need = (n_steps * self._spec_width
                        if spec_mask is not None and spec_mask[i] else n_steps)
                if self.slots[i] is not None:   # not paused for pages here
                    self._ensure_pages(i, min(C, int(self.lengths[i]) + infl[i]
                                              + need + 2))
            included = [i for i in included if self.slots[i] is not None]
            if not included:
                return True
        self._commit_ptab()
        t_d = time.monotonic()
        self._fifo.append(self._dispatch_burst(n_steps, included, t0,
                                               spec_mask=spec_mask))
        if self.tracer.enabled:
            args = {"steps": n_steps, "slots": len(included)}
            if spec_mask is not None:
                args.update(spec_slots=int(spec_mask[included].sum()),
                            spec_width=self._spec_width)
            self.tracer.record("decode_dispatch", "engine", t_d,
                               time.monotonic(), args=args)
        return True

    def _dispatch_fused(self, segs: list, bucket: int, continued: bool,
                        host: np.ndarray, infl: list, t0: float):
        """The split fused tick (the JAX engine's
        ``_dispatch_packed_split``): the pack, then on the device with no
        host sync between, its finals' first tokens and lengths folded
        into the decode state and a burst of decode_burst steps over the
        finals and every decoding slot with budget left. The finals switch
        to decode now. "split" queues the pack as the burst's head, so its
        first tokens are emitted when their copy lands, while the burst
        runs; "1" emits them with the burst. A "split" group holding a
        grammar slot takes the JAX order instead: the head's first tokens
        are waited for and emitted before the burst is dispatched, so the
        burst samples under the masks those tokens lead to; a group slot
        that rolled back in the head rides the burst skipped and is
        overridden in the next one, and one that finished rides it not at
        all."""
        K, C = self.ecfg.decode_burst, self.ecfg.max_context
        group = self._advance(segs, t0)
        for slot, s in group:
            s.phase = "decode"
            s.cache_len = s.written
            self.lengths[slot] = s.written
        gset = {slot for slot, _s in group}
        others = [i for i, s in enumerate(self.slots)
                  if s is not None and s.phase == "decode" and i not in gset
                  and s.req.max_new_tokens - s.n_decoded - infl[i] > 0]
        if self._pool is not None:
            # the pack is built: its finals may not pause for pages here
            for slot, s in group:
                self._ensure_pages(slot, min(C, s.written + K + 2), keep=gset)
            for i in others:
                if self.slots[i] is not None:
                    self._ensure_pages(i, min(C, int(self.lengths[i]) + infl[i]
                                              + K + 2), keep=gset)
            others = [i for i in others if self.slots[i] is not None]
        self._commit_ptab()
        head = _Pack(group, self._prefill_pack(bucket, continued, host), t0,
                     split=True)
        included = sorted(gset) + others
        poisoned: set = set()
        if self._fuse == "split" and any(s.grammar is not None
                                         for _sl, s in group):
            self._fifo.append(head)     # where a stall of it is found
            try:
                self._process_pack(head)
            finally:
                if head in self._fifo:
                    self._fifo.remove(head)
            poisoned = gset & self._override
            included = [i for i in included if self.slots[i] is not None
                        and self.slots[i].phase == "decode"]
        if self._fuse == "split" and not head.processed:
            self._fifo.append(head)
        if included:
            b = self._dispatch_burst(K, included, t0, head=head, fold=bucket)
            if poisoned:
                b.skip |= poisoned
                self._override |= poisoned
            head.burst = b
            self._fifo.append(b)
        t1 = time.monotonic()
        self._pack_stats["seconds"] += t1 - t0
        self._hobserve("prefill_dispatch_seconds", t1 - t0)
        if self.tracer.enabled:
            self.tracer.record("prefill_dispatch", "engine", t0, t1,
                               args={"segments": len(segs), "bucket": bucket,
                                     "packed": True,
                                     "fused": ("split" if self._fuse == "split"
                                               else True)})

    def _dispatch_burst(self, n_steps: int, included: list, t0: float,
                        head: Optional[_Pack] = None,
                        fold: Optional[int] = None,
                        spec_mask: Optional[np.ndarray] = None) -> _Burst:
        """Chain one burst onto the device state: the active mask, the
        overridden rows and the spec mask loaded, a fused tick's finals
        folded in from the ``fold`` bucket's pack, the steps dispatched
        (with ``spec_mask``: a spec tick of ``n_steps`` rounds). Returns its
        _Burst."""
        S = self.ecfg.num_slots
        active = np.zeros((S,), np.bool_)
        active[included] = True
        rows = np.zeros((5, S), np.int64)
        rows[0] = active
        rows[1, sorted(self._override)] = 1
        rows[2], rows[3] = self.cur_tokens, self.lengths
        if spec_mask is not None:
            rows[4] = spec_mask & active
        self._override.clear()
        self._graph.load(rows)
        if fold is not None:
            self._graph.fold(split_pack(self._pgraph.buf[fold], fold, S),
                             self._pgraph.out[fold][0])
        if spec_mask is None:
            fetch = self._burst(n_steps, active)
        else:
            fetch = self._spec_tick(n_steps, active)
        st = self._decode_stats
        st["bursts"] += 1
        st["steps"] += n_steps
        st["full_steps"] += n_steps * self.sampler.full_needed(active)
        b = _Burst(n_steps, [(i, self.slots[i]) for i in included], fetch, t0,
                   group=head.group if head is not None else (), head=head)
        if spec_mask is not None:
            b.spec_mask = spec_mask & active
            b.spec_width = self._spec_width
            b.spec_greedy = self.sampler.host["greedy"].copy()
            st["spec_ticks"] += 1
            st["spec_rounds"] += n_steps
            self._spec_stats["dispatches"] += 1
            if not b.spec_mask[included].all():
                self._spec_stats["mixed_dispatches"] += 1
        ps = self._pipe_stats
        ps["max_inflight"] = max(ps["max_inflight"], self._n_inflight() + 1)
        return b

    def _decode_burst(self) -> bool:
        """One burst, processed (with whatever else is in flight) before
        it returns: a tick of the synchronous loop, for callers that
        drive the engine tick by tick."""
        ran = self._dispatch_decode()
        self._drain_all()
        return ran

    def _burst(self, n_steps: int, active: np.ndarray) -> Fetch:
        """The burst's device work from the loaded state: graph replays on
        the card, the same step body eagerly on the CPU
        (decode_graph.DecodeGraph.replay), in the full sampler variant
        when an active slot needs it. Returns the Fetch of its [K, 2, S]
        ids and logprobs."""
        return self._graph.replay(n_steps, full=self.sampler.full_needed(active))

    def _burst_eager(self, n_steps: int, active: np.ndarray) -> Fetch:
        """The eager per-step loop from the loaded state
        (decode_graph.DecodeGraph.eager), the reference chip_smoke.py and
        the card tests hold the graph against; serving never calls it."""
        return Fetch.of(self._graph.eager(
            n_steps, full=self.sampler.full_needed(active)))

    def _spec_tick(self, n_rounds: int, active: np.ndarray) -> Fetch:
        """A spec tick's device work from the loaded state: graph replays
        of the round on the card, the same round body eagerly on the CPU
        (decode_graph.DecodeGraph.spec_replay), in the full sampler variant
        when an active slot needs it. Returns the Fetch of its
        [R, 2 W + 1, S] rows."""
        return self._graph.spec_replay(
            n_rounds, full=self.sampler.full_needed(active))

    # ---------- the FIFO ----------

    def _drain_fifo(self, can_feed: bool, block: bool = True) -> bool:
        """Process dispatched work in dispatch order. An item whose results
        have landed is processed (on the CPU a pack at once; a burst never
        early, so a burst is processed only as on a busy card, unless it
        is marked ``landed_early``); otherwise the oldest is waited for
        only when the pipeline is full or nothing more could be dispatched
        (``can_feed`` False), and at most one burst is waited for per
        call, so the loop dispatches again between waits (the JAX engine's
        ``_drain_fifo``). ``block`` False waits for nothing: the
        top-of-tick drain (module doc). A head the loop asked about and
        leaves unlanded is held to the stall bound all the same
        (``_check_overdue``), so a busy loop finds a stall as soon as an
        idle or waiting one would."""
        progressed = waited = False
        cuda = self.device.type == "cuda"
        while self._fifo:
            item = self._fifo[0]
            burst = isinstance(item, _Burst)
            if not ((cuda or not burst or item.landed_early)
                    and self._landed(item)):
                if not block or waited or (can_feed and self._n_inflight()
                                           < self.ecfg.pipeline_depth):
                    if cuda or not burst:
                        self._check_overdue(item)
                    break
                waited = burst
            self._fifo.popleft()
            if burst:
                self._process_burst(item)
            else:
                self._process_pack(item)
            progressed = True
        return progressed

    def _drain_all(self):
        """Process everything in flight."""
        while self._fifo:
            self._drain_fifo(can_feed=False)

    # ---------- the dispatch-stall watchdog ----------

    def _sync_faults(self, item):
        """The JAX sync worker's fault hooks (services/faults.py), once per
        pack or burst, when the loop first asks whether its results
        landed: ``sync_delay_ms`` makes them land that much later (a late
        CUDA event), ``sync_fail`` fails them."""
        if item.faults_seen:
            return
        item.faults_seen = True
        d = FAULTS.take("sync_delay_ms")
        if d is not None:
            item.fetch.t_due = time.monotonic() + int(d) / 1e3
            item.fetch.t_ready = 0.0
        if FAULTS.take("sync_fail") is not None:
            item.fetch.err = RuntimeError("injected fault: sync_fail")

    def _landed(self, item) -> bool:
        """Whether a dispatched item's results have landed (no wait)."""
        if FAULTS.active:
            self._sync_faults(item)
        return item.fetch.done()

    def _wait_ready(self, item, blame=None) -> np.ndarray:
        """Wait for a dispatched item's results, never for ever (the JAX
        engine's ``_wait_ready``): past dispatch_stall_ms from the later
        of its dispatch and the last landing seen (a deep pipeline whose
        head is slow but landing is load, not a stall) it raises
        _DispatchStall for ``blame`` (default: the item)."""
        if FAULTS.active:
            self._sync_faults(item)
        try:
            out = item.fetch.wait(max(item.t0, self._t_last_ready),
                                  self.ecfg.dispatch_stall_ms / 1e3)
        except Stalled:
            raise _DispatchStall(blame or item) from None
        self._t_last_ready = time.monotonic()
        return out

    def _check_overdue(self, item):
        """Raise _DispatchStall for ``item``, found not landed, when the
        stall bound has passed since the later of its dispatch and the
        last landing seen (the rule of ``_wait_ready``)."""
        stall_s = self.ecfg.dispatch_stall_ms / 1e3
        if stall_s > 0 and time.monotonic() - max(item.t0,
                                                  self._t_last_ready) > stall_s:
            raise _DispatchStall(item)

    def _check_parked_stall(self):
        """The watchdog for the idle branch of the loop (the JAX engine's
        ``_check_parked_stall``): the FIFO head is what the card should be
        finishing now; if it has not landed within the bound, it stalled."""
        stall_s = self.ecfg.dispatch_stall_ms / 1e3
        if stall_s <= 0 or not self._fifo:
            return
        head = self._fifo[0]
        if not self._landed(head):
            self._check_overdue(head)

    def _handle_stall(self, item):
        """Abort only the stalled item's requests (the JAX engine's
        ``_handle_stall``): the span ring is dumped to stall_dump_dir
        (``lifecycle.stall_dumps``), a "stall_dump" event and a flight dump
        are written, each request gets a "stall" event, its slot is
        released and its fork waiters resolved; the item leaves the FIFO.
        The device state is kept: the other slots serve on (module doc)."""
        pairs = item.slots if isinstance(item, _Burst) else item.group
        stalled = [(i, snap) for i, snap in pairs if self.slots[i] is snap]
        rids = [snap.req.request_id for _, snap in stalled]
        with self._lc_lock:
            self._lc["stalls"] += 1
        dump_path = ""
        try:
            dump_path = dump_ring(self.tracer, self.ecfg.stall_dump_dir)
            with self._lc_lock:
                self._lc["stall_dumps"] += 1
        except Exception:
            log.exception("stall ring dump failed")
        log.warning(json.dumps({
            "event": "dispatch_stall",
            "dispatch_stall_ms": self.ecfg.dispatch_stall_ms,
            "item": type(item).__name__,
            "requests": rids,
            "slots": [i for i, _ in stalled],
            "ring_dump": dump_path}))
        EVENTS.emit("stall_dump", dispatch_stall_ms=self.ecfg.dispatch_stall_ms,
                    requests=rids, ring_dump=dump_path)
        # the ring dump is spans only; the bundle adds state and events
        self._flight_dump("stall", tag="stall", requests=rids)
        try:
            self._fifo.remove(item)
        except ValueError:
            pass
        if isinstance(item, _Pack):
            item.processed = True     # its chained burst must not wait on it
        for i, snap in stalled:
            # with the emitter, behind the tokens it still holds
            self._final(i, snap, [StreamEvent(
                token_id=-1, text="", logprob=0.0, finish_reason="stop",
                error=(f"device dispatch stalled > "
                       f"{self.ecfg.dispatch_stall_ms} ms; request aborted"),
                error_kind="stall"), None])
            self._release_slot(i)
            self._process_fork_waiters(i, snap)

    def _process_burst(self, b: _Burst):
        """Read a burst's tokens and emit them step by step. A slot
        released, context-shifted or re-admitted since the dispatch gets
        nothing (its steps are dropped), nor does a grammar slot past a
        rollback in this burst (``rolled``: the rollback set its mirrors);
        the others advance their host mirrors. The grammar rows that
        changed are flushed before the next dispatch. A "1" fused tick's
        head is processed first."""
        if b.head is not None and not b.head.processed:
            self._process_pack(b.head, blame=b)
        host = self._wait_ready(b)                       # [K, 2, S]
        t1 = time.monotonic()
        prev = self._t_last_burst
        self._decode_stats["seconds"] += t1 - max(b.t0, prev)
        self._t_last_burst = t1
        self._burst_observe(b, host, prev, t1)
        if b.spec_width:
            self._process_spec(b, host, t1)
            return
        ids_np = host[:, 0].astype(np.int64)
        lps_np = host[:, 1]
        dropped = 0
        rolled: set = set()
        self._open_sink()
        try:
            for j in range(b.n_steps):
                for i, snap in b.slots:
                    if (i in b.skip or i in rolled or self.slots[i] is not snap
                            or snap.phase != "decode"):
                        dropped += 1   # finished / shifted / replaced / rolled
                        continue
                    # step j wrote the row of the slot's previous token
                    snap.committed = min(snap.committed + 1, snap.cache_len)
                    if not self._emit(i, int(ids_np[j, i]), float(lps_np[j, i])):
                        rolled.add(i)
        finally:
            self._flush_grammar_bias()
            self._close_sink(t1, b.n_steps)
        self._pipe_stats["dropped_steps"] += dropped
        for i, snap in b.slots:
            if (i not in b.skip and i not in rolled and self.slots[i] is snap
                    and snap.phase == "decode"):
                self.lengths[i] += b.n_steps
                self.cur_tokens[i] = int(ids_np[-1, i])

    def _burst_observe(self, b: _Burst, host: np.ndarray, prev: float,
                       t1: float):
        """A processed burst's histograms and spans (the JAX engine's):
        decode_burst_seconds (dispatch -> landed), itl_seconds (burst to
        burst over the steps, or for a spec tick over the mean tokens a
        live slot emitted), and the decode_burst_device, spec_round /
        spec_draft / spec_verify (an analytic split, the JAX one: the
        model drafter runs D of the round's D + 1 sequential forwards, the
        n-gram match is a tenth of the round), finish_detect and per-slot
        decode spans.
        Everything comes from the host copy ``host`` and host state."""
        t_rdy = b.fetch.t_ready or t1
        self._hobserve("decode_burst_seconds", max(0.0, t_rdy - b.t0))
        n_out = None
        if b.spec_width:
            n_out = host[:, 2 * b.spec_width].astype(np.int64)   # [R, S]
        if prev:
            steps = b.n_steps
            if n_out is not None:
                per_slot = n_out.sum(axis=0)
                live = per_slot[per_slot > 0]
                if live.size:
                    steps = float(live.mean())
            self._hobserve("itl_seconds",
                           max(0.0, t1 - prev) / max(1.0, steps))
        tr = self.tracer
        if not tr.enabled:
            return
        tr.record("decode_burst_device", "engine", b.t0, t_rdy,
                  args={"steps": b.n_steps, "slots": len(b.slots),
                        "fused": bool(b.group), "spec": bool(b.spec_width)})
        if n_out is not None:
            W = b.spec_width
            spec_idx = [i for i, _s in b.slots if b.spec_mask[i]]
            tot = int(sum(int(n_out[:, i].sum()) for i in spec_idx))
            share = (W - 1) / W if self._spec_mode == "model" else 0.1
            mid = b.t0 + (t_rdy - b.t0) * share
            tr.record("spec_round", "engine", b.t0, t_rdy,
                      args={"mode": self._spec_mode, "rounds": b.n_steps,
                            "spec_slots": len(spec_idx),
                            "proposed": b.n_steps * (W - 1) * len(spec_idx),
                            "accepted": max(0, tot - b.n_steps
                                            * len(spec_idx))})
            tr.record("spec_draft", "engine", b.t0, mid,
                      args={"analytic": True})
            tr.record("spec_verify", "engine", mid, t_rdy,
                      args={"analytic": True})
        tr.record("finish_detect", "engine", t_rdy, t1)
        for i, snap in b.slots:
            if (i not in b.skip and self.slots[i] is snap
                    and snap.phase == "decode"):
                tr.record("decode", f"slot{i}", b.t0, t_rdy,
                          rid=snap.req.request_id, args={"steps": b.n_steps})

    def _process_spec(self, b: _Burst, host: np.ndarray, t1: float = 0.0):
        """Emit a spec tick's tokens (the JAX engine's ``_fold_burst`` and
        spec emission): round by round, each slot its round's n_out tokens
        (a spec row: the accepted proposals and the bonus; a plain row:
        one). ``committed`` moves per emitted token, so the rows a rejected
        proposal wrote stay above it. A slot that ends (EOS, stop,
        max_tokens), shifts or is released mid-round gets nothing more;
        the slots still decoding advance their mirrors by the tokens
        emitted. The spec counters fold first, for every slot live at the
        tick's processing. A grammar slot rides as a plain row: a rollback
        ends its emission from the tick (``rolled``), as in a burst."""
        W, R = b.spec_width, b.n_steps
        ids = host[:, :W].astype(np.int64)              # [R, W, S]
        lps = host[:, W:2 * W]
        n_out = host[:, 2 * W].astype(np.int64)         # [R, S]
        rolled: set = set()

        def live(i, snap):
            return (i not in b.skip and i not in rolled
                    and self.slots[i] is snap and snap.phase == "decode")

        st = self._spec_stats
        for i, snap in b.slots:
            tot = int(n_out[:, i].sum())
            if live(i, snap) and tot > 0 and b.spec_mask[i]:
                mode = "greedy" if b.spec_greedy[i] else "sampled"
                for c in (st, st["by_mode"][mode]):
                    c["rounds"] += R
                    c["proposed"] += R * (W - 1)
                    c["accepted"] += tot - R
                    c["tokens"] += tot
        dropped = 0
        self._open_sink()
        try:
            for r in range(R):
                for i, snap in b.slots:
                    if not live(i, snap):
                        dropped += 1      # finished / shifted / replaced
                        continue
                    for j in range(int(n_out[r, i])):
                        if not live(i, snap):
                            break
                        # the round wrote the row of the token before this one
                        snap.committed = min(snap.committed + 1, snap.cache_len)
                        if not self._emit(i, int(ids[r, j, i]),
                                          float(lps[r, j, i])):
                            rolled.add(i)
        finally:
            self._flush_grammar_bias()
            self._close_sink(t1, R)
        self._pipe_stats["dropped_steps"] += dropped
        for i, snap in b.slots:
            if live(i, snap):
                self.lengths[i] += int(n_out[:, i].sum())
                self.cur_tokens[i] = int(ids[R - 1, n_out[R - 1, i] - 1, i])

    # ---------- grammar-constrained decoding ----------

    def _grammar_for(self, text: str) -> NativeGrammar:
        """Compile (cached, 64 grammars at most) and, at the first grammar
        request, build the native mask builder over the vocabulary (the
        JAX engine's ``_grammar_for`` without its fallback: a native
        build that fails raises, and the Python automaton stays the
        reference). GrammarError on a grammar that does not parse."""
        if self._mask_builder is None:
            self._token_strs = token_strings(self.tokenizer)
            self._mask_builder = NativeMaskBuilder(
                self._token_strs, self.eos_ids, self.cfg.vocab_size)
        g = self._grammar_cache.get(text)
        if g is None:
            if len(self._grammar_cache) > 64:
                self._grammar_cache.clear()
            g = NativeGrammar.from_text(text)
            self._grammar_cache[text] = g
        return g

    def _advance_grammar(self, slot: int, s: _Slot, token_id: int) -> bool:
        """Advance the slot's grammar by an emitted token (the JAX engine's
        ``_advance_grammar``); False when the grammar rejects it (the
        caller rolls the slot back). The device row is not written here:
        only the last state's mask matters to the next dispatch, so the
        slot is marked and its row flushed once per processed item
        (``_flush_grammar_bias``). Rows are memoized per state, so an
        identity compare says whether the mask changed."""
        t0 = time.perf_counter()
        piece = (self._token_strs[token_id]
                 if 0 <= token_id < len(self._token_strs) else None)
        nxt = None if piece is None else s.grammar.advance_string(s.gstate, piece)
        if nxt is not None:
            s.gstate = nxt
            penalty = self._mask_builder.penalty_row(s.grammar, nxt)
            if penalty is not s.cur_penalty:
                s.cur_penalty = penalty
                self._gbias_flush.add(slot)
            self._grammar_stats["tokens"] += 1
        self._grammar_stats["advance_s"] += time.perf_counter() - t0
        return nxt is not None

    def _flush_grammar_bias(self):
        """Write the changed grammar slots' rows (logit bias + mask) to the
        sampler's bias in ONE batched write per processed pack, burst or
        spec tick, in stream order and without waiting (the JAX engine's
        ``_flush_grammar_bias``; no power-of-two padding: that existed for
        XLA's executables). The next dispatch reads them."""
        if not self._gbias_flush:
            return
        slots = sorted(i for i in self._gbias_flush
                       if self.slots[i] is not None
                       and self.slots[i].grammar is not None)
        self._gbias_flush.clear()
        if not slots:
            return
        self.sampler.write_bias_rows(
            slots, [(self.slots[i].bias_base, self.slots[i].cur_penalty)
                    for i in slots])
        self._grammar_stats["flushes"] += 1
        self._grammar_stats["rows_flushed"] += len(slots)

    def _rollback_grammar(self, slot: int, s: _Slot) -> bool:
        """Discard a token the grammar rejects (the JAX engine's
        ``_rollback_grammar``): a grammar slot rides full bursts under the
        mask of its last flushed state (one burst stale in the pipelined
        loop), so a token mid-burst can fall outside the grammar.
        Recompute semantics make this free: the slot's length goes back
        to its last valid row, ``lengths = cache_len - 1`` with the
        pending token ``_cache_tokens[-1]`` as ``cur_tokens`` (its row is
        rewritten by the next step), the penalty ring is re-seeded from
        the kept tokens, and the slot is marked for a flush and an
        override, so the next dispatch carries its mask and its host
        state. Every burst in flight sampled on the discarded token: the
        slot is dropped from them whole. Returns False (the caller emits
        nothing more of the slot from this item)."""
        s.n_decoded -= 1
        self._decode_stats["tokens"] -= 1
        self._rollbacks += 1
        s.committed = min(s.committed, max(s.cache_len - 1, 0))
        self.lengths[slot] = max(s.cache_len - 1, 0)
        toks = self._cache_tokens[slot]
        self.cur_tokens[slot] = toks[-1] if toks else 0
        self.sampler.set_ring(slot, toks)
        self._gbias_flush.add(slot)
        self._override.add(slot)
        for b in self._fifo:
            if isinstance(b, _Burst):
                b.skip.add(slot)
        return False

    # ---------- emission ----------

    def _open_sink(self):
        """Start a processed item's emission: inline, its events coalesce
        per slot (``_sink``); with the emitter, its tokens gather in the
        batch handed over at ``_close_sink``."""
        if self._emitter is None:
            self._sink = {}

    def _close_sink(self, t_emit: float = 0.0, steps: int = 0):
        """End a processed item's emission: the batch to the worker, or the
        coalesced events to the streams. For a burst (``t_emit``: the
        moment it was read) the emit span (t_emit -> now: the id-level
        work, with the detokenization when inline) and the stream_flush
        span (the handover or the puts) are recorded."""
        tr = self.tracer if t_emit else None
        t0 = time.monotonic()
        if tr is not None and tr.enabled:
            tr.record("emit", "engine", t_emit, t0, args={"steps": steps})
        sink, self._sink = self._sink, None
        if self._emitter is not None:
            self._flush_em_batch()
        else:
            for out, evs in (sink or {}).values():
                out.put(evs[0] if len(evs) == 1 else _merge_events(evs))
        if tr is not None and tr.enabled:
            tr.record("stream_flush", "engine", t0, time.monotonic(),
                      args={"streams": len(sink) if sink else 0})

    def _final(self, slot: int, s: _Slot, evs: list):
        """A failure's or shutdown's final events for a slotted stream:
        with the emitter, through its queue, behind the tokens it still
        holds for the stream (the JAX engine's ``push_final``); inline,
        straight to the stream."""
        if self._emitter is not None:
            self._emitter.push_final(slot, s, evs)
        else:
            for ev in evs:
                s.req.out.put(ev)

    def _final_parked(self, entry: ResumeEntry, evs: list):
        """``_final`` for a parked (preempted) request, whose paused
        snapshot the emitter may still hold tokens of."""
        if self._emitter is not None and entry.snap is not None:
            self._emitter.push_final(-1, entry.snap, evs)
        else:
            for ev in evs:
                entry.req.out.put(ev)

    def _emit(self, slot: int, token_id: int, logprob: float) -> bool:
        """Emit one token of a slot: EOS / max-tokens / stop sequences
        finish the request and release the slot; at the cache edge the
        slot shifts its context (or, without context_shift, finishes).
        A grammar slot advances its automaton first; a token the grammar
        rejects, or an EOS its current mask forbids (``ignore_eos`` does
        not apply under a grammar), rolls the slot back instead. Returns
        whether the token stood (the JAX ``_emit_token``): after a
        rollback the caller emits nothing more of the slot from the item.
        With the emitter, ``_emit_ev`` does the id-level part and the
        worker the text."""
        if self._emitter is not None:
            return self._emit_ev(slot, token_id, logprob)
        s = self.slots[slot]
        s.n_decoded += 1
        self._decode_stats["tokens"] += 1
        finish = None
        edge = s.cache_len + 1 >= self.ecfg.max_context - 1
        if token_id in self.eos_ids and not (s.req.ignore_eos
                                             and s.grammar is None):
            if s.grammar is not None and s.cur_penalty[token_id] != 0.0:
                return self._rollback_grammar(slot, s)
            finish = "stop"
            delta = s.held_text + s.detok.flush()
        elif s.grammar is not None and not self._advance_grammar(slot, s,
                                                                  token_id):
            return self._rollback_grammar(slot, s)
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
            ev.timings = self._finish_timings(s)
            self._finish_accounting(slot, s, finish, s.n_decoded, ev.timings)
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
        return True

    def _finish_timings(self, s: _Slot) -> dict:
        """A finished request's timings (its final event's)."""
        dt = time.monotonic() - s.t_first_token
        return {
            "prefill_ms": s.t_prefill_ms,
            "queue_wait_ms": max(0.0, (s.t_start - s.req.t_submit) * 1e3)
            if s.req.t_submit else 0.0,
            "admit_to_first_ms": max(0.0, (s.t_first_token - s.t_start) * 1e3),
            "decode_tokens_per_s": (s.n_decoded - 1) / dt
            if dt > 0 and s.n_decoded > 1 else 0.0,
            "reused_prompt_tokens": s.reused,
        }

    def _finish_accounting(self, slot: int, s: _Slot, finish: str, ndec: int,
                           timings: dict):
        """What a clean finish records besides its stream events (the JAX
        engine's ``_finish_accounting_ev``): the TTFT decomposition, the
        request span, the slow-request log, goodput and the "complete"
        event. Sheds, timeouts, stalls and failures never come here."""
        with self._decomp_lock:
            self._ttft_decomp.append((timings["queue_wait_ms"],
                                      timings["admit_to_first_ms"],
                                      s.t_prefill_ms))
        t_done = time.monotonic()
        req = s.req
        if self.tracer.enabled and req.t_submit:
            self.tracer.record("request", f"slot{slot}", req.t_submit, t_done,
                               rid=req.request_id,
                               args={"completion_tokens": ndec,
                                     "finish": finish})
        e2e_ms = (t_done - req.t_submit) * 1e3 if req.t_submit else 0.0
        if self._slow_ms > 0:
            ttft_ms = timings["queue_wait_ms"] + timings["admit_to_first_ms"]
            if ttft_ms > self._slow_ms or e2e_ms > self._slow_ms:
                log.warning("slow request %s: %s", req.request_id, json.dumps({
                    "threshold_ms": self._slow_ms, "e2e_ms": round(e2e_ms, 1),
                    "ttft_ms": round(ttft_ms, 1), "completion_tokens": ndec,
                    "spans": {k: (round(v, 1) if isinstance(v, float) else v)
                              for k, v in timings.items()}}, sort_keys=True))
        self._goodput.add(ndec)
        EVENTS.emit("complete", rid=req.request_id, finish=finish,
                    completion_tokens=ndec,
                    e2e_ms=round(e2e_ms, 1) if req.t_submit else None)

    # ---------- the emitter thread ----------

    def _make_emitter(self) -> EmitterWorker:
        # the callbacks hold the note list, its lock and the wake event,
        # not the engine: no cycle keeps a shut-down engine's weights
        notes, lock, wake = self._em_notes, self._em_lock, self._wake

        def note(slot, snap, ndec):
            with lock:
                notes.append(("stop", slot, snap, ndec))
            wake.set()

        def note_abort(slot, snap):
            with lock:
                notes.append(("abort", slot, snap, 0))
            wake.set()

        return EmitterWorker(stream_event=StreamEvent, merge_events=_merge_events,
                             note_finish=note, note_abort=note_abort,
                             tracer=self.tracer)

    def _emit_ev(self, slot: int, token_id: int, logprob: float) -> bool:
        """The emitter's half of ``_emit`` (the JAX engine's
        ``_emit_token_ev``): the id-level control flow (EOS, the grammar's
        advance and rollback, max_tokens, the cache edge and context
        shift, ``cache_len`` and ``_cache_tokens``, the release of the
        finishes found here), and the token joins the batch the worker
        gets at ``_close_sink``; the worker only sees tokens that stood.
        It detokenizes, scans for stops and puts the events; a stop it
        finds comes back as a note (``_apply_emitter_notes``). Returns
        whether the token stood."""
        s = self.slots[slot]
        s.n_decoded += 1
        self._decode_stats["tokens"] += 1
        finish = None
        shifted = False
        edge = s.cache_len + 1 >= self.ecfg.max_context - 1
        if token_id in self.eos_ids and not (s.req.ignore_eos
                                             and s.grammar is None):
            if s.grammar is not None and s.cur_penalty[token_id] != 0.0:
                return self._rollback_grammar(slot, s)
            finish = "stop"
        elif s.grammar is not None and not self._advance_grammar(slot, s,
                                                                  token_id):
            return self._rollback_grammar(slot, s)
        elif (s.n_decoded >= s.req.max_new_tokens
              or (edge and not self.ecfg.context_shift)):
            finish = "length"
        elif edge:
            # the worker still scans this token; a stop it completes ends
            # the shifted slot through a note (the re-prefill is wasted
            # work, the stream is the inline one's)
            self._context_shift(slot, s, token_id)
            shifted = True
        if finish is None and not shifted:
            s.cache_len += 1      # this token's KV is written by the next step
            self._cache_tokens[slot].append(token_id)
        key = (slot, id(s))
        e = self._em_batch.get(key)
        if e is None:
            e = self._em_batch[key] = {"slot": slot, "snap": s, "tokens": [],
                                       "finish": None, "timings": None}
        # n_decoded per token: the snapshot moves on while the batch queues
        e["tokens"].append((token_id, logprob, s.n_decoded))
        if finish:
            e["finish"], e["timings"] = finish, self._finish_timings(s)
            self._finish_accounting(slot, s, finish, s.n_decoded, e["timings"])
            self._release_slot(slot)
        return True

    def _flush_em_batch(self):
        """Hand the processed item's tokens to the worker as ONE queue
        item: per-slot FIFO order is the queue's order."""
        if self._em_batch:
            batch, self._em_batch = self._em_batch, {}
            self._emitter.push_batch(list(batch.values()))

    def _slot_of(self, snap: _Slot) -> Optional[int]:
        """The slot that runs ``snap``'s request now (a resume may have
        moved it), or None."""
        for i, s in enumerate(self.slots):
            if s is snap or (s is not None and s.req is snap.req):
                return i
        return None

    def _apply_emitter_notes(self) -> bool:
        """The finishes the worker found (the JAX engine's
        ``_apply_emitter_notes``), on the engine thread at the top of a
        tick. "stop": a stop sequence completed, the stream is closed;
        "abort": the worker failed the stream. The slot is released (a
        context shift's re-prefill queued after the stop leaves the queue
        with it), added to every burst's and spec tick's skip set in
        flight, and its fork waiters resolve; a request parked meanwhile
        leaves the resume queue. For a stop, ``committed`` is cut back to
        the rows before the stop token, so the rows kept for reuse are the
        inline path's. Host work only: nothing is written to the card."""
        if self._emitter is None or not self._em_notes:
            return False
        with self._em_lock:
            notes = list(self._em_notes)
            self._em_notes.clear()
        for kind, _slot, snap, ndec in notes:
            slot = self._slot_of(snap)
            if slot is None:
                # finished by the engine meanwhile, or parked
                if self._sched is not None:
                    self._sched.remove_parked(snap.req.request_id)
                continue
            s = self.slots[slot]
            if kind == "stop":
                self._finish_accounting(slot, s, "stop", ndec,
                                        self._finish_timings(s))
                if s.shift_at > ndec:
                    s.committed = 0   # a shift past the stop rebuilt the history
                else:
                    # tokens past the stop joined _cache_tokens, the stop
                    # token included; their rows are not kept
                    extra = s.n_decoded - ndec
                    s.committed = max(0, min(
                        s.committed, len(self._cache_tokens[slot]) - 1 - extra))
            for b in self._fifo:
                if isinstance(b, _Burst):
                    b.skip.add(slot)
            self._release_slot(slot)
            self._process_fork_waiters(slot, s)
        return True

    def _check_emitter_wedge(self):
        """The watchdog for the worker (the JAX engine's
        ``_check_emitter_wedge``): stuck on one item longer than
        dispatch_stall_ms, or dead with work queued, it is replaced. The
        streams of the items it still held and every running request get
        a "stall" event and close; their slots are released."""
        em = self._emitter
        stall_s = self.ecfg.dispatch_stall_ms / 1e3
        if em is None or stall_s <= 0:
            return
        t = em.t_item_start
        if not ((t > 0 and time.monotonic() - t > stall_s)
                or (not em.alive and em.qsize() > 0)):
            return
        log.error("emitter wedged (> %d ms on one item); replacing the worker",
                  self.ecfg.dispatch_stall_ms)
        with self._lc_lock:
            self._lc["stalls"] += 1
        EVENTS.emit("emitter_wedge", dispatch_stall_ms=self.ecfg.dispatch_stall_ms,
                    queued=em.qsize())
        victims: dict = {}
        for it in em.takeover():
            snaps = [e["snap"] for e in it[1]] if it[0] == "batch" else [it[2]]
            for snap in snaps:
                victims[id(snap)] = snap
        for i, s in enumerate(self.slots):
            if s is not None:
                victims[id(s)] = s
                self._release_slot(i)
                self._process_fork_waiters(i, s)
        for s in victims.values():
            if s.em_done:
                continue
            s.em_done = True
            s.req.out.put(StreamEvent(
                token_id=-1, text="", logprob=0.0, finish_reason="stop",
                error=(f"emitter wedged > {self.ecfg.dispatch_stall_ms} ms; "
                       f"request aborted"), error_kind="stall"))
            s.req.out.put(None)
        self._emitter = self._make_emitter()

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
        s.shift_at = s.n_decoded
        s.pending = list(new_ids)
        s.written = s.cache_len = s.committed = 0
        self._cache_tokens[slot] = list(new_ids)
        if self._pcache is not None:
            reused = self._paged_admission(slot, new_ids, 0,
                                           rid=s.req.request_id)
            s.pending = new_ids[reused:]
            s.written = s.committed = s.reused = reused
            self._reuse_stats["reused_rows"] += reused
        self.lengths[slot] = 0
        self.sampler.set_ring(slot, new_ids)
        self._prefill_queue.append(slot)
        # the bursts in flight sampled this slot's next tokens from the
        # discarded context: drop them
        for b in self._fifo:
            if isinstance(b, _Burst):
                b.skip.add(slot)

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
