"""Batched token sampling over float32 logits (counterpart of
localai_tpu/engine/sampling.py, the subset this slice serves).

Same design as the JAX sampler: the full vocabulary is touched once, by
a top-``SORT_K`` reduction to a candidate window, and temperature,
top-k, top-p and min-p act on the window. Greedy picks the window's rank
0 (the exact argmax). Penalties, the repeat ring, logit bias, typical-p
and mirostat come with a later slice; requests that ask for them are
refused at the serving layer rather than sampled differently.

Randomness: a counter-based generator per slot, on the device (the JAX
sampler's per-slot ``rng_keys``). Each slot holds a ``seed`` (the request
seed, or a per-request fallback) and a ``counter`` of the draws it has
made; a draw is ``counter_uniform(seed, counter)``, a hash of the two in
integer torch ops only, so the CPU and the card give the same bits. The
counter advances only on a row that really drew (an active, non-greedy
row: the JAX engine's ``keys = where(active, new_keys, keys)``), so a
seeded stream does not depend on which path (prefill's first token or a
decode step, eager or a graph replay) drew each token, nor on the other
slots. A draw is one uniform per row, turned into a token by inverse CDF
over the filtered window on the device, so a decode burst never syncs
the host. The draws cannot replay JAX's threefry bits; sampled streams
match the reference in distribution only, greedy streams byte for byte.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

SORT_K = 256  # candidate window (cap for top_k)


@dataclasses.dataclass
class SamplingParamsHost:
    """Per-request sampling config."""
    temperature: float = 0.8
    top_k: int = 40          # 0 => disabled (the whole window)
    top_p: float = 0.95      # 1.0 => disabled
    min_p: float = 0.0
    seed: int = -1           # < 0 => per-request fallback seed


def filter_window(logits: torch.Tensor, temperature: torch.Tensor,
                  top_k: torch.Tensor, top_p: torch.Tensor,
                  min_p: torch.Tensor):
    """logits [R, V] f32 and per-row parameter vectors [R] -> (idx [R, K]
    candidate ids, masked [R, K] filtered log-probs (-inf outside the
    keep set, rank 0 always kept), vals [R, K] window logits)."""
    k = min(SORT_K, logits.shape[-1])
    vals, idx = torch.topk(logits, k, dim=-1)       # sorted descending
    scaled = vals / temperature[:, None]
    rank = torch.arange(k, device=logits.device)[None, :]
    k_s = torch.where(top_k > 0, top_k, torch.full_like(top_k, k))[:, None]
    keep = rank < k_s
    probs = torch.softmax(torch.where(keep, scaled,
                                      torch.full_like(scaled, float("-inf"))),
                          dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = keep & ((cum - probs) < top_p[:, None])
    keep = keep & (probs >= min_p[:, None] * probs[:, :1])
    logp = torch.log(torch.clamp(probs, min=1e-20))
    keep = keep | (rank == 0)
    masked = torch.where(keep, logp, torch.full_like(logp, float("-inf")))
    return idx, masked, vals


_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B1          # odd: counter -> counter * _GOLDEN is a bijection


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2**32 for int64 h in [0, 2**32) and a 32-bit constant c,
    in two 16-bit halves of c so that no product reaches 2**63 (int64
    overflow is not relied on)."""
    lo = h * (c & 0xFFFF)                                 # < 2**48
    hi = ((h * (c >> 16)) & 0xFFFF) << 16                 # < 2**32
    return (lo + hi) & _M32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """MurmurHash3's 32-bit finalizer (a bijection of [0, 2**32))."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def counter_uniform(seed: torch.Tensor, counter: torch.Tensor) -> torch.Tensor:
    """The counter RNG's draw: int64 ``seed`` and ``counter`` (any shape,
    each taken mod 2**32) -> float32 uniforms in [0, 1) with 24 random
    bits, ``fmix32(fmix32(seed) ^ (counter * GOLDEN mod 2**32)) >> 8``
    over 2**24. Integer ops only: the same bits on every device."""
    key = _fmix32(seed & _M32)
    h = _fmix32(key ^ _mul32(counter & _M32, _GOLDEN))
    return (h >> 8).to(torch.float32) * (1.0 / (1 << 24))


class SlotSampler:
    """Per-slot sampling state on one device: parameter vectors, the
    greedy mask and the counter RNG's ``seed`` / ``counter``, all [S]
    tensors that ``set_slot`` writes in place (a captured decode step
    reads them where they lie)."""

    def __init__(self, num_slots: int, device):
        self.device = torch.device(device)
        S = num_slots

        def vec(value, dtype):
            return torch.full((S,), value, dtype=dtype, device=self.device)

        self.temperature = vec(1.0, torch.float32)
        self.top_k = vec(0, torch.int64)
        self.top_p = vec(1.0, torch.float32)
        self.min_p = vec(0.0, torch.float32)
        self.greedy = vec(True, torch.bool)
        self.seed = vec(0, torch.int64)
        self.counter = vec(0, torch.int64)

    def set_slot(self, slot: int, p: SamplingParamsHost, fallback_seed: int):
        """Install one request's parameters, seed its generator and reset
        its counter."""
        self.temperature[slot] = max(p.temperature, 1e-6)
        self.top_k[slot] = p.top_k if 0 < p.top_k <= SORT_K else 0
        self.top_p[slot] = p.top_p if 0 < p.top_p <= 1.0 else 1.0
        self.min_p[slot] = min(max(p.min_p, 0.0), 1.0)
        self.greedy[slot] = p.temperature <= 0
        seed = p.seed if p.seed is not None and p.seed >= 0 else fallback_seed
        self.seed[slot] = int(seed) & _M32
        self.counter[slot] = 0

    def _draw(self, logits, temperature, top_k, top_p, min_p, greedy, seed,
              counter, drawing):
        """One token per row, branch-free: (ids [R] int64, logprobs [R]
        f32, advance [R] bool = the rows that drew)."""
        idx, masked, vals = filter_window(logits, temperature, top_k, top_p,
                                          min_p)
        win_logp = torch.log_softmax(vals, dim=-1)
        u = counter_uniform(seed, counter)
        probs = torch.softmax(masked, dim=-1)
        cdf = torch.cumsum(probs, dim=-1)
        choice = (cdf < u[:, None] * cdf[:, -1:]).sum(dim=-1)
        choice = choice.clamp(max=idx.shape[-1] - 1)
        choice = torch.where(greedy, torch.zeros_like(choice), choice)
        ids = torch.gather(idx, 1, choice[:, None])[:, 0]
        lps = torch.gather(win_logp, 1, choice[:, None])[:, 0]
        return ids, lps, drawing & ~greedy

    def sample_all(self, logits: torch.Tensor, active: torch.Tensor):
        """The decode step's sampler: row s of ``logits`` [S, V] is slot s,
        ``active`` [S] bool (on the device) marks the rows that draw.
        Builds nothing from the host and never branches on a value, so a
        CUDA graph can hold it. Returns (ids [S] int64, logprobs [S] f32)."""
        ids, lps, adv = self._draw(
            logits, self.temperature, self.top_k, self.top_p, self.min_p,
            self.greedy, self.seed, self.counter, active)
        self.counter.add_(adv.to(torch.int64))
        return ids, lps

    def sample_rows(self, logits: torch.Tensor, seg_slots: torch.Tensor,
                    final_mask: torch.Tensor):
        """The packed prefill's first-token sampler: row r of ``logits``
        [R, V] is segment r of a pack, ``seg_slots`` [R] int (on the
        device) its slot, the sentinel S for a pad segment, and
        ``final_mask`` [R] bool the rows whose token is used. Every row
        draws with its slot's parameters and counter (a pad row reads a
        clamped slot); the counter advances only for final, non-greedy
        rows, and a pad row writes nothing (the JAX engine's
        ``keys.at[seg_slots].set(where(final_mask, new, old),
        mode="drop")``; slots are unique within a pack). Builds nothing
        from the host and never branches on a value, so a CUDA graph can
        hold it. Returns (ids [R] int64, logprobs [R] f32)."""
        sel = seg_slots.to(torch.int64).clamp(0, self.counter.shape[0] - 1)
        ids, lps, adv = self._draw(
            logits, self.temperature[sel], self.top_k[sel], self.top_p[sel],
            self.min_p[sel], self.greedy[sel], self.seed[sel],
            self.counter[sel], final_mask)
        self.counter.index_add_(0, sel, adv.to(torch.int64))
        return ids, lps

    def sample(self, logits: torch.Tensor, slots: Sequence[int],
               draw: Optional[Sequence[bool]] = None):
        """Sample one token per row; row r uses slot ``slots[r]``'s
        parameters and generator (index tensors built from the host
        lists, outside any graph: the eager reference loops of
        engine/decode_graph.py and engine/prefill_graph.py). ``draw[r]`` False
        marks rows whose result will be discarded (inactive slots): their
        counter does not advance. Returns (ids [R] int64, logprobs [R]
        f32), on the device, without a host sync."""
        sel = torch.as_tensor(list(slots), dtype=torch.int64, device=self.device)
        drawing = torch.as_tensor(
            [True] * len(sel) if draw is None else list(draw),
            dtype=torch.bool, device=self.device)
        return self.sample_rows(logits, sel, drawing)
