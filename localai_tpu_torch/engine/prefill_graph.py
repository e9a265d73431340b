"""The packed prefill as one captured CUDA graph per (pack bucket,
continued) (counterpart of localai_tpu/engine/engine.py::
_packed_prefill_body / _get_packed_fn and the packed precompile, the JAX
engine's one compiled program per pair).

A pack is padded to a total-token BUCKET (the engine's ``_pack_buckets``)
with the JAX engine's pad values (``_pack_arrays``): tokens 0, positions
C (the scatter drops the row), seg_of S, seg_slots S (the sentinel slot),
seg_start / seg_off / seg_len 0 and final_mask False. Its host form is ONE
flat int32 array (``new_pack``, fields by ``split_pack``): tokens,
positions and seg_of [bucket], then seg_slots, seg_start, seg_off, seg_len
and final_mask [S].

``PrefillGraph`` holds, per bucket, the same flat buffer on the device
(static: allocated outside any capture) and an output buffer ``out`` [2, S]
float64 (ids, logprobs), and ONE body per (bucket, continued)
(``body``): ``llama.ragged_prefill`` over the buffer's views (kernel K2,
or K2-int8 for a continued pack over int8 pages; W8 / W4 at M = bucket),
then ``SlotSampler.sample_rows``, which samples every segment's first
token on the device with the full sampler (the JAX ``_packed_prefill_body``
always does: no flags dimension), gathering each segment's parameters,
penalty ring, bias row and mirostat mu at its slot, and writes back only
the final rows' state (the first token into the ring, mu, the counters of
the non-greedy rows), then the ids and logprobs into ``out``. Nothing in it builds a
tensor from host data, syncs or branches on a device value (``continued``
is a Python bool of the graph, never read off seg_start), so on CUDA
``capture`` (at ``Engine.start``, on the engine's thread, after the
decode graph) warms every pair up on an all-pad pack, which writes only
the cache's scratch page and advances no counter, and then captures it.
A pack is then one copy in (the staged host array into the bucket's
buffer), one replay and one copy out (``dispatch``; none of them waits
for the card, engine/transfer.py; ``run`` waits).

Memory: every pair's graph allocates from ONE shared pool
(``torch.cuda.graph_pool_handle``). A shared pool is safe only if no
graph's output outlives the next replay of any of them: the outputs the
host reads (``out``) and the inputs are static buffers allocated before
capture, outside the pool, and the copy of ``out`` to the host runs in
stream order before the next pack's replay. ``logits`` (the last pack's [S, V] rows, kept for probes)
lies in the pool and is valid only until the next replay.

On CPU tensors ``dispatch`` calls the same padded body eagerly: that is the
plain version the tests hold against the JAX Engine, not a fallback. On
CUDA there is no path back to an eager pack: a pack whose (bucket,
continued) has no graph raises, and ``Engine.start`` re-raises a failed
capture. ``eager_pack`` (the pack the engine ran before the graphs: fresh
device tensors, the sampler over host slot lists, at the bucket or at the
pack's exact size) stays as the reference that chip_smoke.py and the
card tests hold the graphs against; serving never selects it.

THE DRAFT MIRROR (the JAX ``_get_draft_packed_fn``): with a draft model
(``draft``: its params, config and K / V caches) each (bucket, continued)
has a second body, ``draft_body``: the draft's ``ragged_prefill`` over
the same buffer (tokens, positions, segments and, paged, the main page
table, which the draft cache shares) into the draft cache, with no logits
and no sampling. It is captured beside the target's, in the same pool,
and ``dispatch(..., mirror=True)`` replays it right after the target's
pack; the engine asks for it when a segment of the pack may speculate,
as the JAX engine dispatches its mirror. Pad and non-speculating
segments write draft rows nobody reads.

Kernel launch counts (ops/kernels::LAUNCHES) are taken in Python by the
wrappers, which a replay does not run: ``capture`` takes back what the
wrappers counted while capturing each graph (nothing ran), and ``run``
adds that graph's counts once per replay.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from localai_tpu_torch.engine.transfer import Fetch, to_device
from localai_tpu_torch.models import llama
from localai_tpu_torch.ops.kernels import LAUNCHES

FIELDS = ("tokens", "positions", "seg_of", "seg_slots", "seg_start",
          "seg_off", "seg_len", "final_mask")


def split_pack(buf, bucket: int, num_slots: int) -> dict:
    """The fields of one flat pack buffer (a host numpy array or a device
    tensor) as views: tokens, positions and seg_of [bucket], then
    seg_slots, seg_start, seg_off, seg_len and final_mask [num_slots]."""
    out, o = {}, 0
    for i, name in enumerate(FIELDS):
        n = bucket if i < 3 else num_slots
        out[name] = buf[o:o + n]
        o += n
    return out


def new_pack(bucket: int, num_slots: int, max_context: int) -> np.ndarray:
    """A host pack of ``bucket`` tokens, every entry at its pad value."""
    host = np.zeros((3 * bucket + 5 * num_slots,), np.int32)
    v = split_pack(host, bucket, num_slots)
    v["positions"][:] = max_context
    v["seg_of"][:] = num_slots
    v["seg_slots"][:] = num_slots
    return host


def n_finals(host: np.ndarray, bucket: int, num_slots: int) -> int:
    """Final segments of a host pack (they lead it: rows [0, n))."""
    return int(np.count_nonzero(split_pack(host, bucket, num_slots)["final_mask"]))


def _forward(params, cfg, ck, cv, v: dict, continued: bool,
             unembed: bool = True):
    return llama.ragged_prefill(
        params, cfg, v["tokens"], v["positions"], v["seg_slots"],
        v["seg_start"], v["seg_off"], v["seg_len"], v["seg_of"], ck, cv,
        continued=continued, unembed=unembed)


class PrefillGraph:
    """Static pack buffers per bucket and their captured bodies (module
    doc)."""

    def __init__(self, params: dict, cfg: llama.LlamaConfig, cache_k: dict,
                 cache_v: dict, sampler, num_slots: int, max_context: int,
                 buckets, device, draft: Optional[tuple] = None):
        self.params, self.cfg = params, cfg
        # the draft model (params, config, K and V caches) or None
        self.draft = draft
        self.ck, self.cv = cache_k, cache_v
        self.sampler = sampler
        self.S, self.C = num_slots, max_context
        self.buckets = tuple(buckets)
        self.device = torch.device(device)
        self.buf = {b: torch.from_numpy(new_pack(b, self.S, self.C)).to(self.device)
                    for b in self.buckets}
        self.out = {b: torch.zeros((2, self.S), dtype=torch.float64,
                                   device=self.device) for b in self.buckets}
        self.graphs: dict = {}        # (bucket, continued) -> CUDAGraph
        self.launches: dict = {}      # (bucket, continued) -> LAUNCHES per replay
        self._logits: dict = {}       # (bucket, continued) -> its logits (pool)
        self.logits: Optional[torch.Tensor] = None   # the last pack's [S, V]
        self.capture_seconds = 0.0    # warm-ups + captures, host wall
        self.pool_bytes = 0           # memory_reserved growth of the captures
        # the draft mirror's graphs and launches per (bucket, continued),
        # and its share of the capture seconds and of the pool (module doc)
        self.dgraphs: dict = {}
        self.dlaunches: dict = {}
        self.draft_capture_seconds = 0.0
        self.draft_pool_bytes = 0

    def body(self, bucket: int, continued: bool) -> torch.Tensor:
        """One pack on the bucket's static buffers: the forward (KV rows
        written in place), the first tokens sampled on the device into
        ``out[bucket]``. Returns the logits [S, V]."""
        v = split_pack(self.buf[bucket], bucket, self.S)
        logits = _forward(self.params, self.cfg, self.ck, self.cv, v, continued)
        ids, lps = self.sampler.sample_rows(logits, v["seg_slots"],
                                            v["final_mask"] != 0)
        self.out[bucket].copy_(torch.stack([ids.to(torch.float64),
                                            lps.to(torch.float64)]))
        return logits

    def draft_body(self, bucket: int, continued: bool):
        """The draft's mirror of the pack on the bucket's buffer: its KV rows
        written in place, no logits, no sampling."""
        dparams, dcfg, dck, dcv = self.draft
        v = split_pack(self.buf[bucket], bucket, self.S)
        _forward(dparams, dcfg, dck, dcv, v, continued, unembed=False)

    def capture(self):
        """Warm up and capture ``body`` for every (bucket, continued)
        (CUDA only), all in one memory pool. Every warm-up pack is all
        pads: its rows go to the scratch page, no sampler state moves, and
        it runs every kernel variant and plan the capture records (K2
        fresh and continued, K2-int8 on an int8 cache, W8 / W4 at M =
        bucket, the dequantize scratch of a tied table). With a draft
        model its mirror is warmed up and captured per pair too, in the
        same pool. Raises on any capture error."""
        if self.device.type != "cuda":
            raise ValueError(f"capture needs a CUDA device, not {self.device}")
        t0 = time.monotonic()
        pairs = [(b, c) for b in self.buckets for c in (False, True)]
        with torch.cuda.device(self.device):
            for b in self.buckets:
                self.buf[b].copy_(torch.from_numpy(new_pack(b, self.S, self.C)))
            stream = torch.cuda.Stream(self.device)
            stream.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(stream):
                for b, c in pairs:
                    self.body(b, c)
                    if self.draft is not None:
                        self.draft_body(b, c)
            torch.cuda.current_stream(self.device).wait_stream(stream)
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(self.device)
            pool = torch.cuda.graph_pool_handle()
            bodies = [(self.body, self.graphs, self.launches, self._logits)]
            if self.draft is not None:
                bodies.append((self.draft_body, self.dgraphs, self.dlaunches, {}))
            for body, graphs, launches, outs in bodies:
                t_b = time.monotonic()
                r_b = torch.cuda.memory_reserved(self.device)
                for b, c in pairs:
                    graph = torch.cuda.CUDAGraph()
                    before = dict(LAUNCHES)
                    try:
                        with torch.cuda.graph(graph, pool=pool, stream=stream):
                            logits = body(b, c)
                    finally:
                        # the wrappers counted their launches while
                        # capturing; nothing ran: take the counts back,
                        # replays add them
                        delta = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
                        for k, n in delta.items():
                            LAUNCHES[k] -= n
                    graphs[(b, c)] = graph
                    launches[(b, c)] = {k: n for k, n in delta.items() if n}
                    outs[(b, c)] = logits
                if body is not self.body:
                    self.draft_capture_seconds = time.monotonic() - t_b
                    self.draft_pool_bytes = (torch.cuda.memory_reserved(self.device)
                                             - r_b)
            torch.cuda.synchronize(self.device)
            self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        self.capture_seconds = time.monotonic() - t0

    def free(self):
        """Drop the graphs and the pool's tensors (a shut-down engine)."""
        for d in (self.graphs, self.launches, self._logits, self.dgraphs,
                  self.dlaunches):
            d.clear()
        self.logits = None

    def dispatch(self, bucket: int, continued: bool, host: np.ndarray,
                 mirror: bool = False) -> Fetch:
        """One pack from its staged host array (``new_pack`` layout): the
        copy in (in stream order, from a pinned copy of ``host``), the
        body (a graph replay on CUDA, eagerly on the CPU), with ``mirror``
        the draft's mirror of it right after, and the copy of
        ``out[bucket]`` (the first token ids and logprobs [2, S]; rows [0,
        n_finals) are the finals') to the host, started and not waited
        for."""
        key = (bucket, continued)
        graph = self.graphs.get(key)
        if self.device.type == "cuda" and graph is None:
            raise RuntimeError(f"no prefill graph for bucket {bucket}, "
                               f"continued={continued} (Engine.start captures "
                               f"{len(self.buckets) * 2} on the card)")
        to_device(self.buf[bucket], host)
        if graph is None:
            self.logits = self.body(bucket, continued)
        else:
            graph.replay()
            for k, n in self.launches[key].items():
                LAUNCHES[k] += n
            self.logits = self._logits[key]
        if mirror and self.draft is not None:
            dgraph = self.dgraphs.get(key)
            if dgraph is None:
                if self.device.type == "cuda":
                    raise RuntimeError(f"no draft mirror graph for bucket "
                                       f"{bucket}, continued={continued}")
                self.draft_body(bucket, continued)
            else:
                dgraph.replay()
                for k, n in self.dlaunches[key].items():
                    LAUNCHES[k] += n
        return Fetch(self.out[bucket])

    def run(self, bucket: int, continued: bool, host: np.ndarray,
            mirror: bool = False) -> np.ndarray:
        """``dispatch``, waited for: [2, n_finals] float64, the final
        segments' first token ids and logprobs."""
        n = n_finals(host, bucket, self.S)
        return self.dispatch(bucket, continued, host, mirror).wait()[:, :n]


def eager_pack(params: dict, cfg: llama.LlamaConfig, cache_k: dict,
               cache_v: dict, sampler, host: np.ndarray, bucket: int,
               num_slots: int, continued: bool, exact: bool = False):
    """The pack as the engine ran it before the graphs (the reference
    ``PrefillGraph`` is held against): fresh device tensors from the host
    pack, the forward, and the finals sampled over a host list of their
    slots. ``exact`` cuts the pack to its real tokens (the pre-bucket
    shape). Returns ([2, n_finals] float64 ids and logprobs, logits)."""
    dev = sampler.device
    v = split_pack(host, bucket, num_slots)
    if exact:
        n = int(v["seg_len"].sum())
        v = {k: (a[:n] if i < 3 else a) for i, (k, a) in enumerate(v.items())}
    t = {k: torch.from_numpy(a.copy()).to(dev) for k, a in v.items()}
    logits = _forward(params, cfg, cache_k, cache_v, t, continued)
    nf = int(np.count_nonzero(v["final_mask"]))
    if not nf:
        return np.zeros((2, 0)), logits
    ids, lps = sampler.sample(logits[:nf], v["seg_slots"][:nf].tolist())
    out = torch.stack([ids.to(torch.float64), lps.to(torch.float64)])
    return out.cpu().numpy(), logits
