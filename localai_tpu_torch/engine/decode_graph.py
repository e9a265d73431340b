"""The decode burst's step as one captured CUDA graph (counterpart of
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
``SlotSampler.sample_all`` -> ``tokens = where(active, ids, tokens)``,
``lengths += active`` -> row ``step`` of ``out`` -> ``step += 1``, the
arithmetic of the eager per-step loop (``eager_burst``). Nothing in it
builds a tensor from host data, syncs or branches on a device value, so
on CUDA it is captured once (``capture``, at ``Engine.start``, on the
engine's thread, as the JAX engine precompiles its bursts) and a burst of
n steps is n replays of that graph followed by one host read of ``out``.
One step replayed n times needs one capture and one memory pool where a
graph per burst length would need one each; a replay costs the host tens
of microseconds against a step of milliseconds.

On CPU tensors ``run`` calls the same step body eagerly: that is the
plain version the tests check, not a fallback. On CUDA there is no path
back to an eager loop: a burst before capture, or a failed capture or
replay, raises. ``eager_burst`` (the loop the engine ran before the
graph) stays as the reference that chip_smoke.py and the card tests hold
the graph against; serving never selects it.

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
        self.logits: Optional[torch.Tensor] = None   # the last step's [S, V]
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.launches: dict = {}      # LAUNCHES added per replay
        self.capture_seconds = 0.0    # warm-up + capture, host wall
        self.pool_bytes = 0           # memory_reserved growth of the capture

    def step_body(self):
        """One decode step on the static buffers, in place."""
        active = self.active
        logits = llama.decode_step(self.params, self.cfg, self.tokens,
                                   self.lengths, self.ck, self.cv,
                                   active=active)
        ids, lps = self.sampler.sample_all(logits, active)
        self.tokens.copy_(torch.where(active, ids, self.tokens))
        self.lengths.add_(active.to(torch.int32))
        row = torch.stack([ids.to(torch.float64), lps.to(torch.float64)])
        self.out.index_copy_(0, self.step, row[None])
        self.step.add_(1)
        self.logits = logits

    def _reset(self):
        for t in (self.tokens, self.lengths, self.active, self.step):
            t.zero_()

    def capture(self):
        """Warm up and capture ``step_body`` (CUDA only). Every slot is
        inactive throughout, so the warm-up steps write their KV rows to
        the cache's scratch page / slot and advance no sampler counter:
        the committed cache and the sampler state are left as they were.
        Raises on any capture error."""
        if self.device.type != "cuda":
            raise ValueError(f"capture needs a CUDA device, not {self.device}")
        t0 = time.monotonic()
        with torch.cuda.device(self.device):
            self._reset()
            stream = torch.cuda.Stream(self.device)
            stream.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(stream):
                for _ in range(WARMUP_STEPS):
                    self.step.zero_()
                    self.step_body()
            torch.cuda.current_stream(self.device).wait_stream(stream)
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(self.device)
            graph = torch.cuda.CUDAGraph()
            before = dict(LAUNCHES)
            self.step.zero_()
            try:
                with torch.cuda.graph(graph, stream=stream):
                    self.step_body()
            finally:
                # the wrappers counted their launches while capturing;
                # nothing ran: take the counts back, replays add them
                delta = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
                for k, n in delta.items():
                    LAUNCHES[k] -= n
            self._reset()
            torch.cuda.synchronize(self.device)
            self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        self.launches = {k: n for k, n in delta.items() if n}
        self.graph = graph
        self.capture_seconds = time.monotonic() - t0

    def run(self, tokens: np.ndarray, lengths: np.ndarray, active: np.ndarray,
            n_steps: int) -> np.ndarray:
        """A burst of ``n_steps`` from the host's per-slot tokens, lengths
        and active mask: one copy in, the steps (graph replays on CUDA,
        the step body on the CPU), one copy out. Returns [n_steps, 2, S]
        float64 (ids, logprobs)."""
        if not 1 <= n_steps <= self.out.shape[0]:
            raise ValueError(f"burst of {n_steps} steps; the buffer holds "
                             f"{self.out.shape[0]}")
        if self.device.type == "cuda" and self.graph is None:
            raise RuntimeError("decode graph not captured (Engine.start "
                               "captures it on the card)")
        host = np.stack([np.asarray(tokens, np.int64),
                         np.asarray(lengths, np.int64),
                         np.asarray(active, np.int64)])
        staged = torch.from_numpy(host).to(self.device)    # one copy in
        self.tokens.copy_(staged[0])
        self.lengths.copy_(staged[1])
        self.active.copy_(staged[2] != 0)
        self.step.zero_()
        for _ in range(n_steps):
            if self.graph is None:
                self.step_body()
            else:
                self.graph.replay()
                for k, n in self.launches.items():
                    LAUNCHES[k] += n
        return self.out[:n_steps].to("cpu", copy=True).numpy()   # ONE sync


def eager_burst(params: dict, cfg: llama.LlamaConfig, cache_k: dict,
                cache_v: dict, sampler, tokens: np.ndarray,
                lengths: np.ndarray, active: np.ndarray,
                n_steps: int) -> np.ndarray:
    """The eager per-step loop the engine ran before the graph (the
    reference ``DecodeGraph`` is held against): fresh device tensors per
    step, the sampler over host row lists. Same result layout as
    ``DecodeGraph.run``."""
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
        ids, lps = sampler.sample(logits, rows, draw=draw)
        tok = torch.where(act, ids, tok)
        lens = lens + act.to(lens.dtype)
        out.append(torch.stack([ids.to(torch.float64), lps.to(torch.float64)]))
    return torch.stack(out).cpu().numpy()
