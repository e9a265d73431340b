"""The decode burst's step as captured CUDA graphs (counterpart of
localai_tpu/engine/engine.py::_decode_burst_body / _make_scan_step, the
JAX engine's compiled ``lax.scan`` over a burst).

``DecodeGraph`` holds the burst's static state on the device:

    tokens  [S] int64     the token each slot feeds to the next step
    lengths [S] int32     rows committed per slot
    active  [S] bool      slots that decode in this burst
    out     [B, 2, S] f64 per step: sampled ids, their logprobs (B =
                          decode_burst)
    step    [1] int64     the row of ``out`` the next step writes

and ONE step that updates it in place (``step_body``): ``decode_step`` ->
``SlotSampler.sample_all`` (which also moves the active slots' penalty
rings, mirostat mu and RNG counters) -> ``tokens = where(active, ids,
tokens)``, ``lengths += active`` -> row ``step`` of ``out`` -> ``step +=
1``, the arithmetic of the eager per-step loop (``eager_burst``). The
step comes in the JAX engine's two sampler variants (its precompiled
flags (False, False, False) and (True, True, True)): plain and ``full``
(penalties, typical-p, mirostat; sampling.py). The engine picks the full
one when any active slot uses one of those (``SlotSampler.full_needed``;
a mixed set runs the full one, as in JAX). Nothing in a step builds a
tensor from host data, syncs or branches on a device value, so on CUDA
each variant is captured once (``capture``, at ``Engine.start``, on the
engine's thread, as the JAX engine precompiles its bursts), both in ONE
memory pool over the same static buffers, and a burst of n steps is n
replays of one graph followed by one host read of ``out``. One step
replayed n times needs one capture where a graph per burst length would
need one each; a replay costs the host tens of microseconds against a
step of milliseconds. A shared pool is safe: the two graphs never run
at once (one stream), and what the host reads (``out``) is a static
buffer.

CHAINED BURSTS (the JAX engine's chain and override set, ``_override``
/ ``_compose_overrides``): a burst starts from the previous burst's final
``tokens`` and ``lengths``, which are already in the static buffers, so
the engine can dispatch burst N+1 before it has read burst N. ``load``
overwrites only the rows the host changed since (one [4, S] host array
copied in stream order: the active mask, an override mask, and the
overriding tokens and lengths; ``torch.where`` applies them on the
device), and ``fold`` writes a pack's sampled first tokens and lengths
into the finals' rows on the device (the split fused tick, the JAX
``_split_head_body``'s fold), with no host data at all. ``replay`` then
runs the steps and starts the copy of ``out`` to the host (a
transfer.Fetch), without waiting. ``step`` and ``out`` are reused by the
next burst: that burst's replays come after this one's copy in stream
order. ``run`` is the synchronous form (every row loaded from the host,
the steps, the wait) that the graph / eager parity checks use.

On CPU tensors ``replay`` calls the same step body eagerly: that is the
plain version the tests check, not a fallback. On CUDA there is no path
back to an eager loop: a burst before capture, or a failed capture or
replay of either variant, raises. ``eager_burst`` (the loop the engine
ran before the graph) stays as the reference that chip_smoke.py and the
card tests hold the graphs against (``eager`` runs it from the chained
buffers); serving never selects it.

Kernel launch counts (ops/kernels::LAUNCHES) are taken in Python by the
wrappers, which a replay does not run: ``capture`` takes back what the
wrappers counted while capturing (nothing ran) and ``run`` adds the same
delta once per replay, so the counts stay what the card ran.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from localai_tpu_torch.engine.transfer import Fetch, to_device
from localai_tpu_torch.models import llama
from localai_tpu_torch.ops.kernels import LAUNCHES

# eager steps before capture: the first allocates what the step caches
# (the rope table, the dequantize scratch, cuBLAS workspaces on the
# capture stream), the rest settle the allocator's blocks
WARMUP_STEPS = 3


class DecodeGraph:
    """Static decode-burst state and its captured step (module doc)."""

    def __init__(self, params: dict, cfg: llama.LlamaConfig, cache_k: dict,
                 cache_v: dict, sampler, num_slots: int, max_steps: int,
                 device):
        self.params, self.cfg = params, cfg
        self.ck, self.cv = cache_k, cache_v
        self.sampler = sampler
        self.device = torch.device(device)
        S = num_slots
        dev = self.device
        self.tokens = torch.zeros(S, dtype=torch.int64, device=dev)
        self.lengths = torch.zeros(S, dtype=torch.int32, device=dev)
        self.active = torch.zeros(S, dtype=torch.bool, device=dev)
        self.out = torch.zeros((max_steps, 2, S), dtype=torch.float64,
                               device=dev)
        self.step = torch.zeros(1, dtype=torch.int64, device=dev)
        # load's staged host rows: active, override mask, tokens, lengths
        self.stage = torch.zeros((4, S), dtype=torch.int64, device=dev)
        self._slots = torch.arange(S, device=dev)
        self.logits: Optional[torch.Tensor] = None   # the last step's [S, V]
        self.graphs: dict = {}        # full (bool) -> CUDAGraph
        self.launches: dict = {}      # full -> LAUNCHES added per replay
        self._logits: dict = {}       # full -> its logits (in the pool)
        self.capture_seconds = 0.0    # warm-ups + captures, host wall
        self.pool_bytes = 0           # memory_reserved growth of the captures

    def step_body(self, full: bool = False) -> torch.Tensor:
        """One decode step on the static buffers, in place, with the plain
        or the ``full`` sampler. Returns the logits [S, V]."""
        active = self.active
        logits = llama.decode_step(self.params, self.cfg, self.tokens,
                                   self.lengths, self.ck, self.cv,
                                   active=active)
        ids, lps = self.sampler.sample_all(logits, active, full=full)
        self.tokens.copy_(torch.where(active, ids, self.tokens))
        self.lengths.add_(active.to(torch.int32))
        row = torch.stack([ids.to(torch.float64), lps.to(torch.float64)])
        self.out.index_copy_(0, self.step, row[None])
        self.step.add_(1)
        return logits

    def _reset(self):
        for t in (self.tokens, self.lengths, self.active, self.step, self.stage):
            t.zero_()

    def capture(self):
        """Warm up and capture ``step_body`` in both variants (CUDA only),
        in one memory pool. Every slot is inactive throughout, so the
        warm-up steps write their KV rows to the cache's scratch page /
        slot and move no sampler state (counter, ring, mu): the committed
        cache and the sampler are left as they were. Raises on any
        capture error."""
        if self.device.type != "cuda":
            raise ValueError(f"capture needs a CUDA device, not {self.device}")
        t0 = time.monotonic()
        with torch.cuda.device(self.device):
            self._reset()
            stream = torch.cuda.Stream(self.device)
            stream.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(stream):
                for full in (False, True):
                    for _ in range(WARMUP_STEPS):
                        self.step.zero_()
                        self.step_body(full)
            torch.cuda.current_stream(self.device).wait_stream(stream)
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(self.device)
            pool = torch.cuda.graph_pool_handle()
            for full in (False, True):
                graph = torch.cuda.CUDAGraph()
                before = dict(LAUNCHES)
                self.step.zero_()
                try:
                    with torch.cuda.graph(graph, pool=pool, stream=stream):
                        logits = self.step_body(full)
                finally:
                    # the wrappers counted their launches while capturing;
                    # nothing ran: take the counts back, replays add them
                    delta = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
                    for k, n in delta.items():
                        LAUNCHES[k] -= n
                self.graphs[full] = graph
                self.launches[full] = {k: n for k, n in delta.items() if n}
                self._logits[full] = logits
            self._reset()
            torch.cuda.synchronize(self.device)
            self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        self.capture_seconds = time.monotonic() - t0

    def free(self):
        """Drop the graphs and the pool's tensors (a shut-down engine)."""
        self.graphs.clear()
        self.launches.clear()
        self._logits.clear()
        self.logits = None

    def load(self, host: np.ndarray):
        """Chain the next burst onto the device state: ``host`` [4, S]
        int64 holds the active mask, the override mask, and the tokens and
        lengths of the overridden rows (the other rows keep the previous
        burst's). One copy in, in stream order; nothing waits."""
        to_device(self.stage, host)
        self.active.copy_(self.stage[0] != 0)
        ov = self.stage[1] != 0
        self.tokens.copy_(torch.where(ov, self.stage[2], self.tokens))
        self.lengths.copy_(torch.where(ov, self.stage[3].to(torch.int32),
                                       self.lengths))

    def fold(self, pack: dict, ids: torch.Tensor):
        """The split fused tick's hand-over, on the device: each final
        segment of ``pack`` (prefill_graph.split_pack views of a device
        pack buffer) gives its slot's token (its sampled first token, from
        ``ids`` [R]) and length (seg_start + seg_len); pad and non-final
        rows change nothing."""
        hit = ((pack["seg_slots"].to(torch.int64)[:, None] == self._slots[None, :])
               & (pack["final_mask"] != 0)[:, None])                  # [R, S]
        fin = hit.any(dim=0)
        tok = (hit * ids.to(torch.int64)[:, None]).sum(dim=0)
        end = (pack["seg_start"] + pack["seg_len"]).to(torch.int64)
        self.tokens.copy_(torch.where(fin, tok, self.tokens))
        self.lengths.copy_(torch.where(fin, (hit * end[:, None]).sum(dim=0).to(
            torch.int32), self.lengths))

    def replay(self, n_steps: int, full: bool = False) -> Fetch:
        """``n_steps`` steps from the chained state, with the plain or the
        ``full`` sampler (graph replays on CUDA, the step body on the
        CPU), then the copy of their [n_steps, 2, S] float64 ids and
        logprobs to the host, started and not waited for."""
        if not 1 <= n_steps <= self.out.shape[0]:
            raise ValueError(f"burst of {n_steps} steps; the buffer holds "
                             f"{self.out.shape[0]}")
        graph = self.graphs.get(full)
        if self.device.type == "cuda" and graph is None:
            raise RuntimeError(f"decode graph (full={full}) not captured "
                               f"(Engine.start captures both on the card)")
        self.step.zero_()
        for _ in range(n_steps):
            if graph is None:
                self.logits = self.step_body(full)
            else:
                graph.replay()
                for k, n in self.launches[full].items():
                    LAUNCHES[k] += n
                self.logits = self._logits[full]
        return Fetch(self.out[:n_steps])

    def eager(self, n_steps: int, full: bool = False) -> np.ndarray:
        """The eager per-step loop (``eager_burst``) from the chained state,
        its final tokens and lengths written back as a replay leaves them:
        the reference serving never selects. Syncs."""
        tok = self.tokens.cpu().numpy()
        lens = self.lengths.cpu().numpy()
        act = self.active.cpu().numpy()
        out = eager_burst(self.params, self.cfg, self.ck, self.cv, self.sampler,
                          tok, lens, act, n_steps, full=full)
        to_device(self.tokens, np.where(act, out[-1, 0].astype(np.int64), tok))
        to_device(self.lengths, (lens + act * n_steps).astype(np.int32))
        return out

    def run(self, tokens: np.ndarray, lengths: np.ndarray, active: np.ndarray,
            n_steps: int, full: bool = False) -> np.ndarray:
        """A burst from the host's per-slot tokens, lengths and active mask
        (every row loaded), with the plain or the ``full`` sampler, waited
        for. Returns [n_steps, 2, S] float64 (ids, logprobs)."""
        S = self.tokens.shape[0]
        self.load(np.stack([np.asarray(active, np.int64), np.ones(S, np.int64),
                            np.asarray(tokens, np.int64),
                            np.asarray(lengths, np.int64)]))
        return self.replay(n_steps, full).wait()


def eager_burst(params: dict, cfg: llama.LlamaConfig, cache_k: dict,
                cache_v: dict, sampler, tokens: np.ndarray,
                lengths: np.ndarray, active: np.ndarray,
                n_steps: int, full: bool = False) -> np.ndarray:
    """The eager per-step loop the engine ran before the graph (the
    reference ``DecodeGraph`` is held against, variant by variant): fresh
    device tensors per step, the sampler over host row lists. Same result
    layout as ``DecodeGraph.run``."""
    dev = sampler.device
    tok = torch.from_numpy(np.asarray(tokens, np.int64).copy()).to(dev)
    lens = torch.from_numpy(np.asarray(lengths, np.int32).copy()).to(dev)
    act_np = np.asarray(active, np.bool_)
    act = torch.from_numpy(act_np.copy()).to(dev)
    rows = list(range(len(act_np)))
    draw = act_np.tolist()
    out = []
    for _ in range(n_steps):
        logits = llama.decode_step(params, cfg, tok, lens, cache_k, cache_v,
                                   active=act)
        ids, lps = sampler.sample(logits, rows, draw=draw, full=full)
        tok = torch.where(act, ids, tok)
        lens = lens + act.to(lens.dtype)
        out.append(torch.stack([ids.to(torch.float64), lps.to(torch.float64)]))
    return torch.stack(out).cpu().numpy()
