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
overwrites only the rows the host changed since (one [5, S] host array
copied in stream order: the active mask, an override mask, the
overriding tokens and lengths, and the spec mask; ``torch.where`` applies
them on the device), and ``fold`` writes a pack's sampled first tokens and lengths
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

THE SPEC ROUND (n-gram self-speculation, engine/speculative.py; the JAX
engine's ``_spec_tick_body`` round and ``_get_spec_tick_fn``): with
``spec_width`` W = n_draft + 1 > 0 the same state holder also runs
``spec_body``, one round on the same ``tokens`` / ``lengths`` buffers,
so a plain burst and a spec tick chain onto each other in any order.
``spec`` [S] bool, loaded with the tick's rows like ``active``, marks the
speculating slots. A round: the proposals (``spec_propose``: the n-gram
ones from the sampler's ring, or with a draft model, ``draft``, its D + 1
greedy decode steps over its own cache, spec rows only; the JAX
``round_step``'s two branches); the plain decode step (``step_body``'s ops) for the other active rows,
the spec rows masked out of its KV write and sampler state; a verify
pack of S segments x W tokens (the current token and the D proposals at
rows lengths .. lengths + D; a non-speculating slot is a pad segment:
seg_len 0, the sentinel slot, its tokens at seg_of S and position C)
through ``llama.ragged_prefill(..., all_logits=True)`` (K2 / K2-int8);
the filtered window at every position (``sampling.verify_dist``); a
greedy spec row accepts greedily against its rank 0 (the plain greedy
rule), a sampled one by rejection sampling (``accept_sampled``, D + 1
counter draws a round); the W masked ring pushes;
``lengths += n_out`` and the last emitted token becomes the current one;
the round's ids [W], logprobs [W] and n_out into row ``step`` of
``spec_out``. No host data and no branch on a value: it is captured once
per sampler variant beside the decode step, in the same pool, and a tick
of R rounds is R replays and one copy (``spec_replay``). The CPU runs
the body eagerly; on CUDA a tick before capture raises.
``eager_rounds`` (fresh tensors, the verify pack built on the host from
the synced lengths; ``spec_eager`` runs it from the chained buffers) is
the reference the captured round is held against; serving never calls
it.

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

from localai_tpu_torch.engine import sampling, speculative
from localai_tpu_torch.engine.transfer import Fetch, to_device
from localai_tpu_torch.models import llama
from localai_tpu_torch.ops import kvcache
from localai_tpu_torch.ops.kernels import LAUNCHES

# eager steps before capture: the first allocates what the step caches
# (the rope table, the dequantize scratch, cuBLAS workspaces on the
# capture stream), the rest settle the allocator's blocks
WARMUP_STEPS = 3


class DecodeGraph:
    """Static decode-burst state and its captured step (module doc)."""

    def __init__(self, params: dict, cfg: llama.LlamaConfig, cache_k: dict,
                 cache_v: dict, sampler, num_slots: int, max_steps: int,
                 device, spec_width: int = 0, ngram: int = 3,
                 draft: Optional[tuple] = None):
        self.params, self.cfg = params, cfg
        # the draft model (params, config, its K and V caches), or None:
        # the n-gram drafter
        self.draft = draft
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
        # load's staged host rows: active, override mask, tokens, lengths,
        # the spec mask
        self.stage = torch.zeros((5, S), dtype=torch.int64, device=dev)
        self._slots = torch.arange(S, device=dev)
        self.logits: Optional[torch.Tensor] = None   # the last step's [S, V]
        self.graphs: dict = {}        # full (bool) -> CUDAGraph
        self.launches: dict = {}      # full -> LAUNCHES added per replay
        self._logits: dict = {}       # full -> its logits (in the pool)
        self.capture_seconds = 0.0    # warm-ups + captures, host wall
        self.pool_bytes = 0           # memory_reserved growth of the captures
        # the spec round (module doc); spec_width 0: none
        self.spec_width = W = spec_width
        self.ngram = ngram
        self.spec = torch.zeros(S, dtype=torch.bool, device=dev)
        self.max_rounds = max(1, max_steps // W) if W else 0
        self.spec_out = torch.zeros((self.max_rounds, 2 * W + 1, S),
                                    dtype=torch.float64, device=dev)
        self.spec_graphs: dict = {}   # full -> CUDAGraph
        self.spec_launches: dict = {}  # full -> LAUNCHES added per replay
        if W:
            # the verify pack's fixed layout: segment b = slot b at pack
            # offset b * W
            self._seg_off = (self._slots * W).to(torch.int32)
            self._col = torch.arange(W, device=dev)
            self._seg_tok = self._slots.repeat_interleave(W)    # [S * W]

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

    def spec_body(self, full: bool = False) -> torch.Tensor:
        """One speculative round on the static buffers, in place (the JAX
        engine's ``_spec_tick_body`` round), with the plain or the ``full``
        sampler for its plain rows: ``spec_propose``, ``spec_decode``,
        ``spec_verify``, ``spec_accept`` in that order. Spec rows (active
        and ``spec``): the proposals (``spec_propose``), a
        verify of the current token + D proposals at rows lengths ..
        lengths + D through ONE continued ragged prefill with logits at
        every position (K2 / K2-int8), the sampler's own window at every
        position (``verify_dist``), greedy acceptance against its rank 0
        (the plain greedy rule) or rejection sampling for a sampled row,
        the emitted tokens pushed into the ring in order.
        Plain rows (active, not spec): the decode step and sampler of
        ``step_body``, with the spec rows masked out of its KV write and
        sampler state. Then ``lengths += n_out``, the last emitted token
        becomes the current one, and row ``step`` of ``spec_out`` gets the
        round's ids [W], logprobs [W] and n_out. Returns the verify's
        logits [S * W, V]."""
        drafts = self.spec_propose()
        ids0, lps0 = self.spec_decode(full)
        vlogits = self.spec_verify(drafts)
        self.spec_accept(drafts, vlogits, ids0, lps0, full)
        return vlogits

    def spec_propose(self) -> torch.Tensor:
        """The round's proposals [S, D]: the n-gram ones from the sampler's
        ring, or with a draft model its D + 1 greedy steps over its cache
        for the speculating rows (``speculative.draft_propose``)."""
        return propose(self.draft, self.tokens, self.lengths,
                       self.active & self.spec, self.sampler,
                       self.spec_width - 1, self.ngram)

    def spec_decode(self, full: bool = False):
        """The round's plain decode step (``step_body``'s ops) for the
        active rows that do not speculate: (ids [S], logprobs [S]); the
        speculating rows write no KV row and move no sampler state."""
        plain = self.active & ~self.spec
        logits = llama.decode_step(self.params, self.cfg, self.tokens,
                                   self.lengths, self.ck, self.cv, active=plain)
        return self.sampler.sample_all(logits, plain, full=full)

    def spec_verify(self, drafts: torch.Tensor) -> torch.Tensor:
        """The verify forward: the current token + ``drafts`` of each
        speculating slot at rows lengths .. lengths + D, one continued
        ragged prefill with logits at every position [S * W, V]. A slot
        that does not speculate is a pad segment (seg_len 0, the sentinel
        slot, its tokens at seg_of S and position C): it writes no row and
        reads no page."""
        S, W = self.tokens.shape[0], self.spec_width
        C = kvcache.shape(self.ck)[2]
        spec = self.active & self.spec
        lengths = self.lengths
        tin = torch.cat([self.tokens[:, None], drafts], dim=1)       # [S, W]
        pos = torch.where(spec[:, None], lengths.to(torch.int64)[:, None]
                          + self._col[None, :], torch.full_like(tin, C))
        seg_of = torch.where(spec[:, None], self._slots[:, None],
                             torch.full_like(tin, S))
        return llama.ragged_prefill(
            self.params, self.cfg, tin.reshape(-1).to(torch.int32),
            pos.reshape(-1).to(torch.int32),
            torch.where(spec, self._slots, torch.full_like(self._slots, S)
                        ).to(torch.int32),
            torch.where(spec, lengths, torch.zeros_like(lengths)),
            self._seg_off, spec.to(torch.int32) * W,
            seg_of.reshape(-1).to(torch.int32), self.ck, self.cv,
            continued=True, all_logits=True)

    def spec_accept(self, drafts, vlogits, ids0, lps0, full: bool = False):
        """Acceptance and the round's bookkeeping: the target's filtered
        window at every verify position (``sampling.verify_dist``, typical-p
        with the ``full`` variant, as the JAX ``use_typical`` flag); a
        greedy spec row accepts greedily against the window's rank 0, a
        sampled one by rejection sampling (``accept_sampled``, its D + 1
        counter draws); then the emitted tokens of each row (a spec row's
        accepted proposals and final token, a plain row's sampled token),
        the spec rows' ring pushes, the chained tokens / lengths, the
        output row. Logprobs follow the JAX definitions: a greedy spec row
        reports the verify's log-softmax, a sampled one log p of the
        filtered window (post-temperature), a plain row the sampler's."""
        S, W = self.tokens.shape[0], self.spec_width
        samp = self.sampler
        active = self.active
        spec = active & self.spec
        plain = active & ~self.spec
        samp_rows = spec & ~samp.p["greedy"]
        idx, probs = sampling.verify_dist(vlogits, samp.p, W, typical=full)
        greedy = idx[:, :, 0].to(drafts.dtype)
        out_g, n_g, _k = speculative.accept_greedy(drafts, greedy, spec)
        logp = torch.log_softmax(vlogits, dim=-1).reshape(S, W, -1)
        lp_g = torch.gather(logp, 2, out_g[:, :, None])[:, :, 0]
        out_r, n_r, _kr, counter = speculative.accept_sampled(
            drafts, idx, probs, samp_rows, seed=samp.seed, counter=samp.counter)
        samp.counter.copy_(counter)
        p_out = (probs * (idx == out_r[:, :, None].to(idx.dtype))).sum(dim=-1)
        lp_r = torch.log(torch.clamp(p_out, min=1e-20))
        out_s = torch.where(samp_rows[:, None], out_r, out_g)
        n_s = torch.where(samp_rows, n_r, n_g)
        lp_s = torch.where(samp_rows[:, None], lp_r, lp_g)
        pad = torch.zeros_like(drafts)
        out = torch.where(spec[:, None], out_s,
                          torch.cat([ids0[:, None].to(pad.dtype), pad], dim=1))
        lps = torch.where(spec[:, None], lp_s,
                          torch.cat([lps0[:, None], pad.to(lps0.dtype)], dim=1))
        n_out = torch.where(spec, n_s, plain.to(torch.int64))
        emitted = self._col[None, :] < n_out[:, None]                 # [S, W]
        out = torch.where(emitted, out, torch.zeros_like(out))
        lps = torch.where(emitted, lps, torch.zeros_like(lps))
        # the plain rows' tokens entered the ring in sample_all; the spec
        # rows' emitted tokens enter it here, in order
        for j in range(W):
            sampling.update_ring(samp.ring, samp.ring_pos, out[:, j],
                                 spec & (j < n_out))
        last = torch.gather(out, 1, (n_out - 1).clamp(min=0)[:, None])[:, 0]
        self.tokens.copy_(torch.where(active, last, self.tokens))
        self.lengths.add_(n_out.to(torch.int32))
        row = torch.cat([out.T.to(torch.float64), lps.T.to(torch.float64),
                         n_out[None].to(torch.float64)])              # [2W+1, S]
        self.spec_out.index_copy_(0, self.step, row[None])
        self.step.add_(1)

    def _reset(self):
        for t in (self.tokens, self.lengths, self.active, self.step, self.stage,
                  self.spec):
            t.zero_()

    def capture(self):
        """Warm up and capture ``step_body`` in both variants (CUDA only),
        and ``spec_body`` in both when the state has a spec width, in one
        memory pool. Every slot is inactive throughout, so the
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
            bodies = [(self.step_body, self.graphs, self.launches, self._logits)]
            if self.spec_width:
                bodies.append((self.spec_body, self.spec_graphs,
                               self.spec_launches, {}))
            with torch.cuda.stream(stream):
                for body, *_ in bodies:
                    for full in (False, True):
                        for _ in range(WARMUP_STEPS):
                            self.step.zero_()
                            body(full)
            torch.cuda.current_stream(self.device).wait_stream(stream)
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(self.device)
            pool = torch.cuda.graph_pool_handle()
            for body, graphs, launches, outs in bodies:
                for full in (False, True):
                    graph = torch.cuda.CUDAGraph()
                    before = dict(LAUNCHES)
                    self.step.zero_()
                    try:
                        with torch.cuda.graph(graph, pool=pool, stream=stream):
                            logits = body(full)
                    finally:
                        # the wrappers counted their launches while
                        # capturing; nothing ran: take the counts back,
                        # replays add them
                        delta = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
                        for k, n in delta.items():
                            LAUNCHES[k] -= n
                    graphs[full] = graph
                    launches[full] = {k: n for k, n in delta.items() if n}
                    outs[full] = logits
            self._reset()
            torch.cuda.synchronize(self.device)
            self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        self.capture_seconds = time.monotonic() - t0

    def free(self):
        """Drop the graphs and the pool's tensors (a shut-down engine)."""
        for d in (self.graphs, self.launches, self._logits, self.spec_graphs,
                  self.spec_launches):
            d.clear()
        self.logits = None

    def load(self, host: np.ndarray):
        """Chain the next burst or spec tick onto the device state:
        ``host`` [5, S] int64 holds the active mask, the override mask, the
        tokens and lengths of the overridden rows (the other rows keep the
        previous burst's) and the spec mask (zero for a plain burst). One
        copy in, in stream order; nothing waits."""
        to_device(self.stage, host)
        self.active.copy_(self.stage[0] != 0)
        self.spec.copy_(self.stage[4] != 0)
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

    def spec_replay(self, n_rounds: int, full: bool = False) -> Fetch:
        """A spec tick: ``n_rounds`` rounds from the chained state (graph
        replays on CUDA, ``spec_body`` on the CPU), then the copy of their
        [n_rounds, 2 W + 1, S] float64 rows (ids [W], logprobs [W], n_out)
        to the host, started and not waited for."""
        if not 1 <= n_rounds <= self.max_rounds:
            raise ValueError(f"spec tick of {n_rounds} rounds; the buffer "
                             f"holds {self.max_rounds}")
        graph = self.spec_graphs.get(full)
        if self.device.type == "cuda" and graph is None:
            raise RuntimeError(f"spec round graph (full={full}) not captured "
                               f"(Engine.start captures both on the card)")
        self.step.zero_()
        for _ in range(n_rounds):
            if graph is None:
                self.spec_body(full)
            else:
                graph.replay()
                for k, n in self.spec_launches[full].items():
                    LAUNCHES[k] += n
        return Fetch(self.spec_out[:n_rounds])

    def spec_eager(self, n_rounds: int, full: bool = False) -> np.ndarray:
        """``eager_rounds`` from the chained state, its final tokens and
        lengths written back as a replay leaves them: the reference the
        spec graphs are held against, which serving never selects. Syncs."""
        tok = self.tokens.cpu().numpy()
        lens = self.lengths.cpu().numpy()
        act = self.active.cpu().numpy()
        spec = self.spec.cpu().numpy()
        out = eager_rounds(self.params, self.cfg, self.ck, self.cv, self.sampler,
                           tok, lens, act, spec, n_rounds, self.spec_width,
                           self.ngram, full=full, draft=self.draft)
        W = self.spec_width
        n_out = out[:, 2 * W].astype(np.int64)                      # [R, S]
        for i in np.nonzero(act)[0]:
            tok[i] = int(out[-1, int(n_out[-1, i]) - 1, i])
        to_device(self.tokens, tok.astype(np.int64))
        to_device(self.lengths, (lens + n_out.sum(axis=0)).astype(np.int32))
        return out

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
                            np.asarray(lengths, np.int64),
                            np.zeros(S, np.int64)]))
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


def propose(draft: Optional[tuple], tokens: torch.Tensor, lengths: torch.Tensor,
            spec: torch.Tensor, sampler, n_draft: int, ngram: int
            ) -> torch.Tensor:
    """A round's proposals [S, D]: with ``draft`` (params, config, K and V
    caches) the draft model's over the ``spec`` rows (their draft rows
    written), else the n-gram ones from the sampler's ring."""
    if draft is not None:
        dparams, dcfg, dck, dcv = draft
        return speculative.draft_propose(dparams, dcfg, tokens, lengths, dck,
                                         dcv, spec, n_draft)
    return speculative.ngram_propose(tokens, sampler.ring, sampler.ring_pos,
                                     n_draft, ngram)


def eager_rounds(params: dict, cfg: llama.LlamaConfig, cache_k: dict,
                 cache_v: dict, sampler, tokens: np.ndarray, lengths: np.ndarray,
                 active: np.ndarray, spec: np.ndarray, n_rounds: int,
                 width: int, ngram: int, full: bool = False,
                 draft: Optional[tuple] = None) -> np.ndarray:
    """The spec round built the eager way (the reference
    ``DecodeGraph.spec_body`` is held against): fresh tensors per round,
    the proposals as ``propose`` makes them (a draft model's over the spec
    rows, from the host's lengths),
    the plain rows through the sampler over host row lists, the verify
    pack built on the host from the synced lengths (only the spec rows'
    segments, as the engine's packer builds a pack), the acceptance
    walked position by position on the host from the synced window: a
    greedy row against rank 0, a sampled row against its counter's
    uniforms (the final draw by ``sampling.draw_index``). Same result
    layout as ``DecodeGraph.spec_replay`` ([n_rounds, 2 W + 1, S]
    float64)."""
    dev = sampler.device
    W, D = width, width - 1
    act = np.asarray(active, np.bool_)
    spec_rows = act & np.asarray(spec, np.bool_)
    plain_rows = act & ~spec_rows
    S = act.shape[0]
    tok = np.asarray(tokens, np.int64).copy()
    lens = np.asarray(lengths, np.int64).copy()
    rows = list(range(S))
    out = np.zeros((n_rounds, 2 * W + 1, S))
    for r in range(n_rounds):
        tok_t = torch.from_numpy(tok.copy()).to(dev)
        drafts = propose(draft, tok_t, torch.from_numpy(lens.astype(np.int32)).to(dev),
                         torch.from_numpy(spec_rows.copy()).to(dev), sampler, D,
                         ngram).cpu().numpy()
        logits = llama.decode_step(
            params, cfg, tok_t, torch.from_numpy(lens.astype(np.int32)).to(dev),
            cache_k, cache_v, active=torch.from_numpy(plain_rows.copy()).to(dev))
        ids0, lps0 = sampler.sample(logits, rows, draw=plain_rows.tolist(),
                                    full=full)
        ids0, lps0 = ids0.cpu().numpy(), lps0.cpu().numpy()
        segs = [int(i) for i in np.nonzero(spec_rows)[0]]
        n_out = plain_rows.astype(np.int64)
        emitted = np.zeros((W, S), np.int64)
        emitted[0] = np.where(plain_rows, ids0, 0)
        lp = np.zeros((W, S))
        lp[0] = np.where(plain_rows, lps0, 0.0)
        if segs:
            B = len(segs)
            tin = np.concatenate([[tok[i]] + drafts[i].tolist() for i in segs])
            pos = np.concatenate([np.arange(lens[i], lens[i] + W) for i in segs])
            i32 = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=dev)
            vl = llama.ragged_prefill(
                params, cfg, i32(tin), i32(pos), i32(segs), i32(lens[segs]),
                i32(np.arange(B) * W), i32(np.full(B, W)),
                i32(np.repeat(np.arange(B), W)), cache_k, cache_v,
                continued=True, all_logits=True)
            sel = np.repeat(segs, W)
            sp = {name: t[i32(sel).long()] for name, t in sampler.p.items()}
            zero = torch.zeros((1, 1), dtype=vl.dtype, device=dev)
            idx, masked, _v = sampling.filter_window(
                vl, sp, None, None, zero, full=False, typical=full)
            idx = idx.reshape(B, W, -1).cpu().numpy()
            probs = torch.softmax(masked, dim=-1).reshape(B, W, -1).cpu().numpy()
            logp = torch.log_softmax(vl, dim=-1).reshape(B, W, -1).cpu().numpy()
            greedy_row = sampler.p["greedy"].cpu().numpy()
            seed = sampler.seed.cpu().numpy()
            counter = sampler.counter.cpu().numpy()
            for b, i in enumerate(segs):
                if greedy_row[i]:
                    k = 0
                    while k < D and drafts[i, k] == idx[b, k, 0]:
                        k += 1
                    seq = drafts[i, :k].tolist() + [int(idx[b, k, 0])]
                    lp[:k + 1, i] = logp[b, np.arange(k + 1), seq]
                else:
                    # rejection sampling, one position at a time: D
                    # acceptance uniforms, then one categorical draw
                    u = sampling.counter_uniform(
                        torch.full((W,), int(seed[i])),
                        int(counter[i]) + torch.arange(W)).numpy()
                    pr = {t: [float(probs[b, j][idx[b, j] == t].sum())
                              for j in range(W)] for t in drafts[i]}
                    k = 0
                    while k < D and u[k] < pr[drafts[i, k]][k]:
                        k += 1
                    w = probs[b, k].copy()
                    if k < D:
                        w[idx[b, k] == drafts[i, k]] = 0.0
                        if not (w > 0).any():
                            w = probs[b, k].copy()
                    c = int(sampling.draw_index(
                        torch.from_numpy(w[None]).to(dev),
                        torch.full((1,), float(u[D]), device=dev))[0])
                    seq = drafts[i, :k].tolist() + [int(idx[b, k, c])]
                    lp[:k + 1, i] = [np.log(max(float(probs[b, j][idx[b, j] == t].sum()),
                                                1e-20)) for j, t in enumerate(seq)]
                    sampler.counter[i] += W
                n_out[i] = k + 1
                emitted[:k + 1, i] = seq
                # the ring: the emitted tokens in order (the plain rows'
                # entered it in sampler.sample)
                for t in seq:
                    sampling.update_ring(
                        sampler.ring, sampler.ring_pos,
                        torch.full((S,), t, dtype=torch.int64, device=dev),
                        torch.from_numpy(np.arange(S) == i).to(dev))
        for i in np.nonzero(act)[0]:
            tok[i] = emitted[n_out[i] - 1, i]
        lens += n_out
        out[r, :W] = emitted
        out[r, W:2 * W] = lp
        out[r, 2 * W] = n_out
    return out
